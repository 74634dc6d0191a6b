"""``mxtpu_torch.contrib.quantization`` against
``mxtpu.contrib.quantization`` on the CPU (the reference's
``tests/test_quantization.py`` cases): the int8 ops bit for bit
(``quantize_v2``, ``dequantize``, the weight quantizer),
``quantize_model`` with no, naive and entropy calibration giving the
same graph, thresholds and int8 parameters (bytes equal) and outputs
within 1e-6 relative of the reference's, layers left out by name, a
weight shared with a float layer, and ``quantize_net`` on a Gluon MLP.
"""
import numpy as onp
import pytest
import torch

import mxtpu as jmx
from mxtpu import io as jio
from mxtpu.contrib import quantization as jq
import mxtpu_torch as tmx
from mxtpu_torch.contrib import quantization as tq

torch.set_num_threads(2)   # a CPU share for each xdist worker

RNG = onp.random.default_rng(0)
W1 = (RNG.standard_normal((32, 16)) * 0.3).astype(onp.float32)
W2 = (RNG.standard_normal((4, 32)) * 0.3).astype(onp.float32)
B1 = (RNG.standard_normal((32,)) * 0.1).astype(onp.float32)
CALIB = RNG.standard_normal((64, 16)).astype(onp.float32)
XQ = RNG.standard_normal((8, 16)).astype(onp.float32)


def _same(got, want):
    got = got.asnumpy() if hasattr(got, "asnumpy") else got
    want = want.asnumpy() if hasattr(want, "asnumpy") else want
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_quantize_dequantize_bit_for_bit():
    x = onp.linspace(-3, 3, 101).astype(onp.float32)
    for kw in ({}, {"min_calib_range": -2.0, "max_calib_range": 1.0}):
        t = tq.quantize(tmx.nd.array(x, ctx="cpu"), **kw)
        r = jq.quantize(jmx.nd.array(x), **kw)
        for a, b in zip(t, r):
            _same(a, b)
        assert t[0].dtype == torch.int8
        _same(tq.dequantize(*t), jq.dequantize(*r))
    back = tq.dequantize(*tq.quantize(tmx.nd.array(x, ctx="cpu")))
    onp.testing.assert_allclose(back.asnumpy(), x, atol=3.0 / 127 + 1e-6)
    q, thr = tq._quantize_weight(W1)
    rq, rthr = jq._quantize_weight(W1)
    assert thr == rthr and q.tobytes() == rq.tobytes()


def test_int8_matmul_is_exact():
    a = RNG.integers(-127, 128, (40, 21)).astype(onp.int8)
    b = RNG.integers(-127, 128, (21, 9)).astype(onp.int8)
    a[:3] = 127
    b[:, 0] = 127
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    onp.testing.assert_array_equal(got.numpy(),
                                   a.astype(onp.int64) @ b.astype(onp.int64))


def _mlp(mx):
    sym = mx.sym
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    return sym.FullyConnected(net, num_hidden=4, name="fc2")


def _args(mx, ctx):
    return {"fc1_weight": mx.nd.array(W1, ctx=ctx),
            "fc1_bias": mx.nd.array(B1, ctx=ctx),
            "fc2_weight": mx.nd.array(W2, ctx=ctx),
            "fc2_bias": mx.nd.zeros((4,), ctx=ctx)}


def _quantize_both(calib_mode, **kw):
    def calib(io, ctx):
        if calib_mode == "none":
            return None
        extra = {"ctx": ctx} if ctx else {}
        return io.NDArrayIter(CALIB, None, batch_size=16, **extra)
    tout = tq.quantize_model(_mlp(tmx), _args(tmx, "cpu"), {},
                             calib_mode=calib_mode,
                             calib_data=calib(tmx.io, "cpu"),
                             ctx=tmx.cpu(), **kw)
    jout = jq.quantize_model(_mlp(jmx), _args(jmx, None), {},
                             calib_mode=calib_mode,
                             calib_data=calib(jio, None), ctx=jmx.cpu(),
                             **kw)
    return tout, jout


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_model_matches_mxtpu(calib_mode):
    (tsym, targs, _), (jsym, jargs, _) = _quantize_both(calib_mode)
    assert sorted(targs) == sorted(jargs)
    assert "fc1_weight" not in targs          # float copy pruned
    for k in targs:
        _same(targs[k], jargs[k])
    tnodes = {n.name: n for n in tsym._topo()}
    jnodes = {n.name: n for n in jsym._topo()}
    assert sorted(tnodes) == sorted(jnodes)
    for name, n in tnodes.items():
        assert n.op == jnodes[name].op
        for a in ("w_thr", "calib_min", "calib_max"):
            assert n.attrs.get(a) == jnodes[name].attrs.get(a), (name, a)
    if calib_mode != "none":
        assert "calib_max" in tnodes["fc2_quantized"].attrs
    x = tmx.nd.array(XQ, ctx="cpu")
    out = tsym.bind(tmx.cpu(), {**targs, "data": x},
                    grad_req="null").forward()[0].asnumpy()
    ref = jsym.bind(jmx.cpu(), {**jargs, "data": jmx.nd.array(XQ)},
                    grad_req="null").forward()[0].asnumpy()
    onp.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    fl = _mlp(tmx).bind(tmx.cpu(), {**_args(tmx, "cpu"), "data": x},
                        grad_req="null").forward()[0].asnumpy()
    rel = onp.abs(out - fl).mean() / (onp.abs(fl).mean() + 1e-6)
    assert rel < 0.1, (calib_mode, rel)


def test_quantize_model_excluded():
    (tsym, targs, _), (jsym, jargs, _) = _quantize_both(
        "none", excluded_sym_names=("fc2",))
    ops = {n.op for n in tsym._topo()}
    assert {"_contrib_quantized_fully_connected", "FullyConnected"} <= ops
    assert targs["fc2_weight"].dtype == torch.float32
    assert targs["fc1_weight_quantized"].dtype == torch.int8
    assert sorted(targs) == sorted(jargs)


def test_quantize_model_shared_weight_stays_float_for_excluded():
    def build(mx, ctx):
        sym = mx.sym
        data, w = sym.var("data"), sym.var("shared_weight")
        a = sym.FullyConnected(data, w, num_hidden=8, no_bias=True,
                               name="fcq")
        b = sym.FullyConnected(data, w, num_hidden=8, no_bias=True,
                               name="fcx")
        args = {"shared_weight": mx.nd.array(W1[:8, :4], ctx=ctx)}
        return a + b, args
    tsym, targs = build(tmx, "cpu")
    jsym, jargs = build(jmx, None)
    tq_, tqa, _ = tq.quantize_model(tsym, targs, {},
                                    excluded_sym_names=("fcx",))
    jq_, jqa, _ = jq.quantize_model(jsym, jargs, {},
                                    excluded_sym_names=("fcx",))
    assert tqa["shared_weight"].dtype == torch.float32
    _same(tqa["shared_weight_quantized"], jqa["shared_weight_quantized"])
    x = XQ[:2, :4]
    out = tq_.bind(tmx.cpu(), {**tqa, "data": tmx.nd.array(x, ctx="cpu")},
                   grad_req="null").forward()[0].asnumpy()
    ref = jq_.bind(jmx.cpu(), {**jqa, "data": jmx.nd.array(x)},
                   grad_req="null").forward()[0].asnumpy()
    onp.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_quantized_conv_model():
    """A conv net: the rewritten graph's int8 conv, its weights and its
    output match the reference's."""
    def build(mx, ctx):
        sym = mx.sym
        data = sym.var("data")
        net = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                              name="conv1")
        net = sym.Activation(net, act_type="relu", name="relu1")
        net = sym.Convolution(net, kernel=(3, 3), stride=(2, 2),
                              num_filter=2, name="conv2")
        rng = onp.random.default_rng(5)
        args = {"conv1_weight": mx.nd.array(
                    rng.standard_normal((4, 3, 3, 3)) * 0.3, ctx=ctx),
                "conv1_bias": mx.nd.array(rng.standard_normal(4), ctx=ctx),
                "conv2_weight": mx.nd.array(
                    rng.standard_normal((2, 4, 3, 3)) * 0.3, ctx=ctx),
                "conv2_bias": mx.nd.zeros((2,), ctx=ctx)}
        return net, args
    img = onp.random.default_rng(6).standard_normal((2, 3, 8, 8)).astype(
        onp.float32)
    tsym, targs = build(tmx, "cpu")
    jsym, jargs = build(jmx, None)
    tcal = tmx.io.NDArrayIter(img, None, batch_size=1, ctx="cpu")
    jcal = jio.NDArrayIter(img, None, batch_size=1)
    tqs, tqa, _ = tq.quantize_model(tsym, targs, {}, calib_mode="naive",
                                    calib_data=tcal, ctx=tmx.cpu())
    jqs, jqa, _ = jq.quantize_model(jsym, jargs, {}, calib_mode="naive",
                                    calib_data=jcal, ctx=jmx.cpu())
    for k in tqa:
        _same(tqa[k], jqa[k])
    t2 = {n.name: n for n in tqs._topo()}["conv2_quantized"]
    j2 = {n.name: n for n in jqs._topo()}["conv2_quantized"]
    assert t2.attrs["calib_max"] == j2.attrs["calib_max"]
    out = tqs.bind(tmx.cpu(), {**tqa, "data": tmx.nd.array(img, ctx="cpu")},
                   grad_req="null").forward()[0].asnumpy()
    ref = jqs.bind(jmx.cpu(), {**jqa, "data": jmx.nd.array(img)},
                   grad_req="null").forward()[0].asnumpy()
    onp.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_quantize_net_gluon():
    def build(mx, ctx):
        from_np = {"dense0_weight": W1[:, :8], "dense0_bias": B1,
                   "dense1_weight": W2[:3], "dense1_bias": B1[:3]}
        net = mx.gluon.nn.HybridSequential(prefix="qnet_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(32, activation="relu", in_units=8),
                    mx.gluon.nn.Dense(3, in_units=32))
        net.initialize(ctx=ctx) if ctx else net.initialize()
        for name, p in net.collect_params().items():
            p.set_data(mx.nd.array(from_np[name[len("qnet_"):]], ctx=ctx))
        return net
    x = RNG.standard_normal((4, 8)).astype(onp.float32)
    cal = RNG.standard_normal((32, 8)).astype(onp.float32)
    tnet, jnet = build(tmx, "cpu"), build(jmx, None)
    tq_net = tq.quantize_net(tnet, calib_data=tmx.io.NDArrayIter(
        cal, None, batch_size=8, ctx="cpu"))
    jq_net = jq.quantize_net(jnet, calib_data=jio.NDArrayIter(
        cal, None, batch_size=8))
    out = tq_net(tmx.nd.array(x, ctx="cpu")).asnumpy()
    ref = jq_net(jmx.nd.array(x)).asnumpy()
    onp.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    fl = tnet(tmx.nd.array(x, ctx="cpu")).asnumpy()
    rel = onp.abs(out - fl).mean() / (onp.abs(fl).mean() + 1e-6)
    assert rel < 0.1, rel
    with pytest.raises(tmx.MXNetError, match="int8"):
        tq.quantize_model(_mlp(tmx), _args(tmx, "cpu"), {},
                          quantized_dtype="uint8")
