"""``mxtpu_torch.symbol`` (mx.sym, the Executor), ``HybridBlock.export``,
``SymbolBlock`` and ``mx.model``'s checkpoint pair on the CPU against
``mxtpu``.

The reference's own cases (every test of ``tests/test_symbol.py`` but
the two visualization ones, which ``test_torch_metric.py`` holds) run
through the port. Parity, each on the same seeded numpy values:

- the JSON of the same graph is byte-equal in the two packages, and
  each package loads the other's into the same JSON and shapes (auto
  names too, from the same counters);
- a Gluon net exported by each package gives byte-equal
  ``-symbol.json`` and ``.params`` files; the port's ``SymbolBlock``
  on the reference's files gives the port net's logits bit for bit,
  the reference's on the port's files the reference net's, and the two
  within 1e-5 (relative, of max |logit|: f32 products and convolutions
  summed in another order);
- the Executor's outputs, gradients (``grad_req`` write and add, a
  second backward), Dropout's masks after ``mx.random.seed`` and
  BatchNorm's moving statistics: each array within 1e-6 of its largest
  |value| (float32 rounding of the same sums taken in another order;
  2.5e-7 measured);
- ``save_checkpoint`` writes the reference's bytes, and each package's
  ``load_checkpoint`` reads the other's.
"""
import os
import weakref

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.symbol import symbol as jsymbol
from mxtpu_torch.symbol import symbol as tsymbol

torch.set_num_threads(2)   # a CPU share for each xdist worker

sym = tmx.sym
EXEC_REL = 1e-6           # of each array's largest |value|


def _close(a, b, rel=EXEC_REL):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), \
        (np.abs(a - b).max(), np.abs(b).max())


def _nd(mx, x):
    kw = {"ctx": "cpu"} if mx is tmx else {}
    return mx.nd.array(np.asarray(x, np.float32), **kw)


@pytest.fixture
def fresh_names():
    """Both packages' auto-name counters from zero (restored after), so
    the same graph built in each gets the same names."""
    saved = dict(jsymbol._NAME_COUNTER), dict(tsymbol._NAME_COUNTER)
    jsymbol._NAME_COUNTER.clear()
    tsymbol._NAME_COUNTER.clear()
    yield
    for counter, old in zip((jsymbol._NAME_COUNTER,
                             tsymbol._NAME_COUNTER), saved):
        counter.clear()
        counter.update(old)


def _init_executor(ex, scale=0.1, seed=0):
    rng = np.random.default_rng(seed)
    for name, arr in ex.arg_dict.items():
        if name != "data":
            arr[:] = rng.standard_normal(arr.shape).astype(np.float32) * scale


# ---------------------------------------------------------------------------
# the reference's cases, through the port
# ---------------------------------------------------------------------------
def test_compose_and_list():
    data = sym.var("data")
    fc1 = sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    out = sym.FullyConnected(act, num_hidden=4, name="fc2")
    assert out.list_arguments() == \
        ["data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]
    assert out.list_outputs() == ["fc2_output"]
    assert out.name == "fc2"


def test_infer_shape():
    out = sym.FullyConnected(sym.var("data"), num_hidden=16, name="fc1")
    arg_shapes, out_shapes, aux_shapes = out.infer_shape(data=(8, 32))
    assert arg_shapes == [(8, 32), (16, 32), (16,)]
    assert out_shapes == [(8, 16)] and aux_shapes == []


def test_infer_shape_conv_bn():
    c = sym.Convolution(sym.var("data"), num_filter=8, kernel=(3, 3),
                        pad=(1, 1), name="c")
    b = sym.BatchNorm(c, name="bn")
    arg_shapes, out_shapes, aux_shapes = b.infer_shape(data=(2, 3, 8, 8))
    assert out_shapes == [(2, 8, 8, 8)]
    assert (8, 3, 3, 3) in arg_shapes
    assert aux_shapes == [(8,), (8,)]
    assert b.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]


def test_infer_type_and_failure_names_the_op():
    x = sym.var("x")
    y = sym.cast(x, dtype="float16") + 1.0
    args, outs, aux = y.infer_type(x="float32")
    assert args == [torch.float32] and outs == [torch.float16] and aux == []
    bad = sym.dot(sym.var("a"), sym.var("b"), name="mm")
    with pytest.raises(tmx.MXNetError, match=r"dot\(mm\)"):
        bad.infer_shape(a=(2, 3), b=(4, 5))
    assert sym.FullyConnected(sym.var("d"), num_hidden=2).infer_shape() == \
        (None, None, None)


def test_simple_bind_forward_backward_matches_autograd():
    data = sym.var("data")
    fc1 = sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="tanh", name="t")
    out = sym.FullyConnected(act, num_hidden=4, name="fc2")
    ex = out.simple_bind(tmx.cpu(), data=(8, 32))
    _init_executor(ex)
    x = _nd(tmx, np.random.default_rng(1).standard_normal((8, 32)))
    ex.forward(is_train=True, data=x)
    og = tmx.nd.ones((8, 4), ctx="cpu")
    ex.backward(out_grads=og)
    w1, b1, w2, b2 = (ex.arg_dict[n].copy() for n in
                      ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"))
    for a in (w1, b1, w2, b2):
        a.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.FullyConnected(
            tmx.nd.Activation(tmx.nd.FullyConnected(x, w1, b1, num_hidden=16),
                              act_type="tanh"), w2, b2, num_hidden=4)
    y.backward(og)
    np.testing.assert_allclose(ex.outputs[0].asnumpy(), y.asnumpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ex.grad_dict["fc1_weight"].asnumpy(),
                               w1.grad.asnumpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ex.grad_dict["fc2_bias"].asnumpy(),
                               b2.grad.asnumpy(), rtol=1e-4, atol=1e-5)


def test_grad_req_add_and_null():
    out = sym.FullyConnected(sym.var("data"), num_hidden=4, name="fc")
    ex = out.simple_bind(tmx.cpu(), grad_req="add", data=(2, 8))
    _init_executor(ex)
    x = tmx.nd.ones((2, 8), ctx="cpu")
    ex.forward(is_train=True, data=x)
    ex.backward(out_grads=tmx.nd.ones((2, 4), ctx="cpu"))
    g1 = ex.grad_dict["fc_weight"].asnumpy().copy()
    ex.forward(is_train=True, data=x)
    ex.backward(out_grads=tmx.nd.ones((2, 4), ctx="cpu"))
    np.testing.assert_allclose(ex.grad_dict["fc_weight"].asnumpy(), 2 * g1,
                               rtol=1e-6)
    ex2 = out.simple_bind(tmx.cpu(), grad_req="null", data=(2, 8))
    ex2.forward(is_train=True, data=x)
    ex2.backward()
    assert ex2.grad_dict == {}


def test_json_round_trip():
    c = sym.Convolution(sym.var("data"), num_filter=4, kernel=(3, 3),
                        name="c")
    out = sym.FullyConnected(sym.Flatten(c, name="fl"), num_hidden=2,
                             name="fc")
    out2 = sym.load_json(out.tojson())
    assert out2.list_arguments() == out.list_arguments()
    assert out.infer_shape(data=(1, 3, 8, 8))[1] == \
        out2.infer_shape(data=(1, 3, 8, 8))[1]


def test_scalar_arithmetic_and_eval():
    x = sym.var("x")
    y = (2.0 * x + 1.0) ** 2 - x / 2.0
    val = np.array([1.0, 2.0], np.float32)
    r = y.eval(x=_nd(tmx, val))[0].asnumpy()
    np.testing.assert_allclose(r, (2 * val + 1) ** 2 - val / 2, rtol=1e-6)


def test_group_and_internals():
    x = sym.var("x")
    a = sym.sqrt(x, name="a")
    b = sym.square(x, name="b")
    g = sym.Group([a, b])
    assert g.list_outputs() == ["a_output", "b_output"]
    outs = g.eval(x=_nd(tmx, [4.0]))
    assert float(outs[0].asscalar()) == 2.0
    assert float(outs[1].asscalar()) == 16.0
    assert b.get_internals()["x"].name == "x"
    assert b.get_internals()["b_output"].name == "b"


def test_multi_output_split():
    parts = sym.split(sym.var("x"), num_outputs=2, axis=1)
    assert len(parts.list_outputs()) == 2
    r = parts[0].eval(x=_nd(tmx, np.arange(8).reshape(2, 4)))[0]
    np.testing.assert_allclose(r.asnumpy(), [[0, 1], [4, 5]])


def test_batchnorm_aux_update_in_executor():
    b = sym.BatchNorm(sym.var("data"), name="bn")
    ex = b.simple_bind(tmx.cpu(), data=(4, 3, 2, 2))
    ex.arg_dict["bn_gamma"][:] = 1.0
    ex.aux_dict["bn_moving_var"][:] = 1.0
    x = _nd(tmx, np.random.default_rng(0).standard_normal((4, 3, 2, 2)) + 2)
    ex.forward(is_train=True, data=x)
    mm = ex.aux_dict["bn_moving_mean"].asnumpy()
    assert np.all(np.abs(mm) > 0)
    ex.forward(is_train=False, data=x)       # inference leaves aux alone
    np.testing.assert_allclose(ex.aux_dict["bn_moving_mean"].asnumpy(), mm)


def _export_net(mx, prefix="net_"):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, activation="relu"),
                nn.BatchNorm(), nn.MaxPool2D(2), nn.Flatten(), nn.Dense(10))
    return net


def test_export_symbolblock_round_trip(tmp_path):
    net = _export_net(tmx)
    net.initialize(ctx=tmx.cpu())
    x = _nd(tmx, np.random.default_rng(0).standard_normal((2, 3, 8, 8)))
    y0 = net(x)
    prefix = str(tmp_path / "model")
    net.export(prefix, epoch=3)
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0003.params")
    sb = tmx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0003.params", ctx="cpu")
    np.testing.assert_array_equal(y0.asnumpy(), sb(x).asnumpy())
    sb.hybridize()
    sb(x)
    np.testing.assert_array_equal(y0.asnumpy(), sb(x).asnumpy())


def test_symbolblock_autograd(tmp_path):
    net = tmx.gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=tmx.cpu())
    prefix = str(tmp_path / "d")
    net.export(prefix)
    sb = tmx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0000.params", ctx="cpu")
    x = _nd(tmx, np.random.default_rng(0).standard_normal((2, 8)))
    x.attach_grad()
    with tmx.autograd.record():
        z = (sb(x) ** 2).sum()
    z.backward()
    assert float(x.grad.abs().sum().asscalar()) > 0


def test_save_load_checkpoint(tmp_path):
    out = sym.FullyConnected(sym.var("data"), num_hidden=4, name="fc")
    arg_params = {"fc_weight": tmx.nd.ones((4, 8), ctx="cpu"),
                  "fc_bias": tmx.nd.zeros((4,), ctx="cpu")}
    prefix = str(tmp_path / "ckpt")
    tmx.model.save_checkpoint(prefix, 7, out, arg_params, {})
    s2, args2, aux2 = tmx.model.load_checkpoint(prefix, 7, ctx="cpu")
    assert s2.list_arguments() == out.list_arguments()
    np.testing.assert_allclose(args2["fc_weight"].asnumpy(), np.ones((4, 8)))
    assert aux2 == {}


def test_dropout_symbol_train_vs_test():
    d = sym.Dropout(sym.var("x"), p=0.5, name="drop")
    ex = d.simple_bind(tmx.cpu(), x=(100,))
    v = tmx.nd.ones((100,), ctx="cpu")
    np.testing.assert_allclose(ex.forward(is_train=False, x=v)[0].asnumpy(),
                               np.ones(100))
    out_train = ex.forward(is_train=True, x=v)[0].asnumpy()
    assert (out_train == 0).sum() > 10
    assert np.allclose(out_train[out_train > 0], 2.0)


def test_parameter_var_and_later_sub_items():
    p = tmx.gluon.Parameter("w", shape=(2, 3))
    v = p.var()
    assert v.name == "w" and v.attr("__shape__") == "(2, 3)"
    assert v.tojson() == jmx.gluon.Parameter("w", shape=(2, 3)).var().tojson()
    with pytest.raises(NotImplementedError, match="item 10.4"):
        tmx.gluon.nn.Dense(2, in_units=2).export_stablehlo("x")
    with pytest.raises(NotImplementedError, match="item 10.4"):
        v.validate()


# ---------------------------------------------------------------------------
# parity with mxtpu
# ---------------------------------------------------------------------------
def _graph(mx):
    s = mx.sym
    data = s.var("data")
    lab = s.var("softmax_label")
    c = s.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1))
    b = s.BatchNorm(c, fix_gamma=False, momentum=0.8)
    a = s.Activation(b, act_type="relu")
    p = s.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max")
    f = s.FullyConnected(s.Flatten(p), num_hidden=6, no_bias=True)
    parts = s.split(f, num_outputs=2, axis=1)
    g = (parts[0] * 2.0 + parts[1]) / 3.0 - 1.0
    g = s.LeakyReLU(g, act_type="leaky", slope=0.1)
    h = s.reshape(s.var("w", shape=(3,), dtype="float32", lr_mult=2.0), (1, 3))
    g = s.broadcast_add(g, h)
    return s.Group([s.SoftmaxOutput(g, lab, name="softmax"),
                    s.sum(g, axis=1, keepdims=True)])


def test_json_byte_equal_both_ways(fresh_names):
    port, ref = _graph(tmx), _graph(jmx)
    assert port.tojson() == ref.tojson()
    from_ref = tmx.sym.load_json(ref.tojson())
    from_port = jmx.sym.load_json(port.tojson())
    assert from_ref.tojson() == ref.tojson() == from_port.tojson()
    shapes = dict(data=(2, 3, 8, 8), softmax_label=(2,))
    assert from_ref.infer_shape(**shapes) == ref.infer_shape(**shapes) == \
        port.infer_shape(**shapes)
    assert port.list_arguments() == ref.list_arguments()
    assert port.list_auxiliary_states() == ref.list_auxiliary_states()
    assert port.list_outputs() == ref.list_outputs()


def _same_params(jnet, tnet, path):
    jnet.save_parameters(path)
    tnet.load_parameters(path, ctx="cpu")


def test_export_crosses_packages(tmp_path, fresh_names):
    """Each package exports the same net: byte-equal files; each
    package's SymbolBlock runs the other's export."""
    jmx.random.seed(3)
    jnet, tnet = _export_net(jmx), _export_net(tmx)
    jnet.initialize()
    tnet.initialize(ctx=tmx.cpu())
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 8))
    jy = jnet(_nd(jmx, x)).asnumpy()             # resolves deferred shapes
    tnet(_nd(tmx, x))
    _same_params(jnet, tnet, str(tmp_path / "w.params"))
    ty = tnet(_nd(tmx, x)).asnumpy()
    jpre, tpre = str(tmp_path / "ref"), str(tmp_path / "port")
    jsymbol._NAME_COUNTER.clear()
    tsymbol._NAME_COUNTER.clear()
    jnet.export(jpre, epoch=1)
    tnet.export(tpre, epoch=1)
    for suffix in ("-symbol.json", "-0001.params"):
        with open(jpre + suffix, "rb") as a, open(tpre + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    tsb = tmx.gluon.SymbolBlock.imports(jpre + "-symbol.json", ["data"],
                                        jpre + "-0001.params", ctx="cpu")
    jsb = jmx.gluon.SymbolBlock.imports(tpre + "-symbol.json", ["data"],
                                        tpre + "-0001.params")
    np.testing.assert_array_equal(tsb(_nd(tmx, x)).asnumpy(), ty)
    np.testing.assert_array_equal(jsb(_nd(jmx, x)).asnumpy(), jy)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5 * abs(jy).max())


def _exec_graph(mx):
    s = mx.sym
    x = s.var("data")
    # no bias before BatchNorm: its gradient is 0 in exact arithmetic,
    # rounding noise in both packages, and noise has no parity
    h = s.FullyConnected(x, num_hidden=16, no_bias=True, name="fc1")
    h = s.BatchNorm(h, name="bn", momentum=0.7)
    h = s.Activation(h, act_type="tanh", name="act")
    h = s.Dropout(h, p=0.3, name="drop")
    return s.FullyConnected(h, num_hidden=4, name="fc2")


def _exec_run(mx, grad_req):
    """Forward + backward twice in training mode after mx.random.seed,
    then a predict forward: every output, grad and aux state."""
    mx.random.seed(11)
    ex = _exec_graph(mx).simple_bind(mx.cpu(), grad_req=grad_req,
                                     data=(8, 12))
    rng = np.random.default_rng(5)
    for name in sorted(ex.arg_dict):
        ex.arg_dict[name][:] = rng.standard_normal(
            ex.arg_dict[name].shape).astype(np.float32) * 0.3
    ex.aux_dict["bn_moving_var"][:] = 1.0
    x = _nd(mx, rng.standard_normal((8, 12)))
    og = _nd(mx, rng.standard_normal((8, 4)))
    got = []
    for _ in range(2):
        got.append(ex.forward(is_train=True, data=x)[0].asnumpy())
        ex.backward(out_grads=og)
        got += [ex.grad_dict[n].asnumpy() for n in sorted(ex.grad_dict)]
        got += [ex.aux_dict[n].asnumpy() for n in sorted(ex.aux_dict)]
    ex.backward(out_grads=og)                       # a second backward
    got += [ex.grad_dict[n].asnumpy() for n in sorted(ex.grad_dict)]
    got.append(ex.forward(is_train=False, data=x)[0].asnumpy())
    return got


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_executor_matches_mxtpu(grad_req):
    port, ref = _exec_run(tmx, grad_req), _exec_run(jmx, grad_req)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        _close(a, b)
    # Dropout dropped the same units in both (p = 0.3 of 8 x 16)
    assert np.array_equal(port[0] == 0, ref[0] == 0)


def test_executor_backward_after_predict_forward_matches_mxtpu():
    got = []
    for mx in (tmx, jmx):
        mx.random.seed(2)
        ex = _exec_graph(mx).simple_bind(mx.cpu(), data=(4, 12))
        _init_executor(ex, 0.3, 8)
        ex.aux_dict["bn_moving_var"][:] = 1.0
        ex.forward(is_train=False, data=_nd(mx, np.ones((4, 12))))
        ex.backward(out_grads=_nd(mx, np.ones((4, 4))))
        got.append([ex.grad_dict[n].asnumpy() for n in sorted(ex.grad_dict)])
    for a, b in zip(*got):
        _close(a, b)


class _StandInGraph:
    """What a replay computes: the captured function run again on the
    buffers it was captured over."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def test_executor_predict_graph_tracks_its_arguments(monkeypatch):
    """The card's predict branch on the CPU, with a stand-in graph: a
    signature's first call runs eagerly and captures nothing, the second
    captures, later calls replay; an argument written in place or
    replaced since is copied in, so the replay reads its new values, and
    the capture keeps no replaced tensor alive."""
    builds = []

    def stand_in(build, fn, warm, device):
        builds.append(build)
        warm()
        fn()
        return _StandInGraph(fn)
    monkeypatch.setattr(tsymbol, "graphs_on", lambda device: True)
    monkeypatch.setattr(tsymbol, "capture_graph", stand_in)
    ex = sym.FullyConnected(sym.var("data"), num_hidden=4, name="fc") \
        .simple_bind(tmx.cpu(), grad_req="null", data=(2, 8))
    _init_executor(ex)
    rng = np.random.default_rng(4)

    def check():
        x, w, b = (ex.arg_dict[n].asnumpy()
                   for n in ("data", "fc_weight", "fc_bias"))
        _close(ex.outputs[0].asnumpy(), x @ w.T + b)

    ex.forward(data=_nd(tmx, rng.standard_normal((2, 8))))
    assert (ex.captures, builds) == (0, [])
    check()
    first = ex.outputs[0].asnumpy()
    ex.forward()
    assert ex.captures == 1 and len(builds) == 1
    np.testing.assert_array_equal(ex.outputs[0].asnumpy(), first)
    ex.arg_dict["fc_weight"]._data.mul_(2.0)          # written in place
    ex.forward()
    check()
    old = weakref.ref(ex.arg_dict["fc_weight"]._data)
    ex.arg_dict["fc_weight"][:] = rng.standard_normal((4, 8))  # replaced
    ex.forward(data=_nd(tmx, rng.standard_normal((2, 8))))
    check()
    assert old() is None
    assert ex.captures == 1 and len(builds) == 1


def test_checkpoint_files_byte_equal_both_ways(tmp_path, fresh_names):
    rng = np.random.default_rng(9)
    shapes = {"fc1_weight": (16, 12), "bn_gamma": (16,),
              "bn_beta": (16,), "fc2_weight": (4, 16), "fc2_bias": (4,)}
    vals = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    aux = {"bn_moving_mean": np.zeros(16, np.float32),
           "bn_moving_var": np.ones(16, np.float32)}
    files = {}
    for name, mx in (("port", tmx), ("ref", jmx)):
        prefix = str(tmp_path / name)
        mx.model.save_checkpoint(prefix, 2, _exec_graph(mx),
                                 {k: _nd(mx, v) for k, v in vals.items()},
                                 {k: _nd(mx, v) for k, v in aux.items()})
        files[name] = prefix
    for suffix in ("-symbol.json", "-0002.params"):
        with open(files["port"] + suffix, "rb") as a, \
                open(files["ref"] + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    s, args, auxs = tmx.model.load_checkpoint(files["ref"], 2, ctx="cpu")
    js, jargs, jauxs = jmx.model.load_checkpoint(files["port"], 2)
    assert s.tojson() == js.tojson()
    for k in vals:
        np.testing.assert_array_equal(args[k].asnumpy(), jargs[k].asnumpy())
    for k in aux:
        np.testing.assert_array_equal(auxs[k].asnumpy(), jauxs[k].asnumpy())
