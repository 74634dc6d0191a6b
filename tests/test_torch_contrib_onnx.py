"""mx.contrib.onnx in the port against ``mxtpu.contrib.onnx``, case by
case of the reference's ``tests/test_onnx.py``.

- Every exported Symbol case (a graph with its params) is built
  in both packages from the same numpy inputs and weights (seeded),
  after both name counters restart: the port writes the reference's
  file byte for byte.
- Each package imports the other's file; the imported graphs' outputs
  agree with the source graph's within the reference test's own
  tolerances, in both directions.
- Hand-built external-producer protos import in both packages to the
  same outputs, or raise the same exception type and message.

The HybridBlock cases and the zoo's families are in
``test_torch_contrib_onnx_zoo.py``.

The reference runs in its default 32-bit mode (``jax.enable_x64(False)``
around each of its calls): the suite's conftest turns 64-bit mode on,
where a Python float scalar promotes an int32 tensor to float64, while
the port's (and the reference's own default) promotion gives float32.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.symbol as jsym
import mxtpu_torch as tmx
import mxtpu_torch.symbol as tsym
from mxtpu.contrib import onnx as jonnx
from mxtpu_torch.contrib import onnx as tonnx

torch.set_num_threads(2)

PKGS = {"ref": (jmx, jsym, jonnx), "port": (tmx, tsym, tonnx)}


@pytest.fixture(autouse=True)
def fresh_names():
    saved = dict(jsym.symbol._NAME_COUNTER), dict(tsym.symbol._NAME_COUNTER)
    yield
    for counter, old in zip((jsym.symbol._NAME_COUNTER,
                             tsym.symbol._NAME_COUNTER), saved):
        counter.clear()
        counter.update(old)


def _mode(pkg):
    return jax.enable_x64(False) if pkg == "ref" else \
        contextlib.nullcontext()


def _restart_names():
    jsym.symbol._NAME_COUNTER.clear()
    tsym.symbol._NAME_COUNTER.clear()


def _nd(pkg, v):
    mx = PKGS[pkg][0]
    if pkg == "port":
        return mx.nd.array(v, ctx="cpu")
    return mx.nd.array(v)


def _eval(pkg, s, values):
    mx = PKGS[pkg][0]
    args = {k: _nd(pkg, v) for k, v in values.items()
            if k in s.list_arguments()}
    auxs = {k: _nd(pkg, v) for k, v in values.items()
            if k in s.list_auxiliary_states()}
    with _mode(pkg):
        outs = s.bind(mx.cpu(), args,
                      aux_states=auxs).forward(is_train=False)
        return [o.asnumpy() for o in outs]


def _imported(pkg, path):
    """(sym, {name: numpy}) of an ONNX file through ``pkg``'s importer."""
    mx, _, onnx = PKGS[pkg]
    with (mx.cpu() if pkg == "port" else _mode(pkg)):
        sym, arg, aux = onnx.import_model(path)
        vals = {k: v.asnumpy() for k, v in {**arg, **aux}.items()}
    return sym, vals


# ---------------------------------------------------------------------------
# the Symbol cases of test_onnx.py: builder(sym) → (out, params, inputs)
# ---------------------------------------------------------------------------
def mlp(s):
    rng = np.random.RandomState(0)
    data = s.var("data")
    w1, b1, w2, b2 = (s.var(n) for n in ("w1", "b1", "w2", "b2"))
    h = s.Activation(s.FullyConnected(data, w1, b1, num_hidden=16),
                     act_type="relu")
    out = s.softmax(s.FullyConnected(h, w2, b2, num_hidden=4), axis=-1)
    params = {"w1": rng.randn(16, 8).astype(np.float32),
              "b1": rng.randn(16).astype(np.float32),
              "w2": rng.randn(4, 16).astype(np.float32),
              "b2": rng.randn(4).astype(np.float32)}
    return out, params, {"data": rng.randn(2, 8).astype(np.float32)}


def convnet(s):
    rng = np.random.RandomState(1)
    data, w, cb = s.var("data"), s.var("cw"), s.var("cb")
    gamma, beta = s.var("gamma"), s.var("beta")
    mmean, mvar = s.var("mmean"), s.var("mvar")
    c = s.Convolution(data, w, cb, num_filter=6, kernel=(3, 3),
                      stride=(1, 1), pad=(1, 1))
    bn = s.BatchNorm(c, gamma, beta, mmean, mvar, eps=1e-5,
                     use_global_stats=True)
    a = s.Activation(bn, act_type="relu")
    p = s.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max")
    out = s.Flatten(s.Pooling(p, global_pool=True, pool_type="avg"))
    params = {"cw": rng.randn(6, 3, 3, 3).astype(np.float32) * 0.1,
              "cb": rng.randn(6).astype(np.float32),
              "gamma": rng.rand(6).astype(np.float32) + 0.5,
              "beta": rng.randn(6).astype(np.float32),
              "mmean": rng.randn(6).astype(np.float32) * 0.1,
              "mvar": rng.rand(6).astype(np.float32) + 0.5}
    return out, params, {"data": rng.randn(2, 3, 8, 8).astype(np.float32)}


def shape_and_scalar_ops(s):
    rng = np.random.RandomState(2)
    data = s.var("data")
    y = (data * 2.0 + 1.5) / 0.5
    y = s.transpose(y, axes=(0, 2, 1))
    y = s.reshape(y, shape=(0, -1))
    y = s.clip(y, a_min=-2.0, a_max=2.0)
    y = s.expand_dims(y, axis=1)
    y = s.squeeze(y, axis=1)
    y = s.concat(y, y, dim=1)
    y = s.slice_axis(y, axis=1, begin=0, end=6)
    y = s.mean(y, axis=1, keepdims=True)
    out = s.cast(y, dtype="float32")
    return out, {}, {"data": rng.randn(2, 3, 4).astype(np.float32)}


def binary_reduce_matmul(s):
    rng = np.random.RandomState(3)
    a, b, w = s.var("a"), s.var("b"), s.var("w")
    y = s.broadcast_add(a, b) * s.broadcast_maximum(a, b)
    y = s.sum(s.dot(y, w), axis=-1, keepdims=False)
    out = s.exp(s.negative(s.sqrt(s.abs(y))))
    params = {"w": rng.randn(4, 5).astype(np.float32)}
    return out, params, {"a": rng.randn(2, 4).astype(np.float32),
                         "b": rng.rand(1, 4).astype(np.float32)}


def embedding_gather(s):
    rng = np.random.RandomState(4)
    out = s.Embedding(s.var("idx"), s.var("table"), input_dim=10,
                      output_dim=6)
    params = {"table": rng.randn(10, 6).astype(np.float32)}
    return out, params, {"idx": np.array([[0, 3], [9, 5]], np.float32)}


def get_model_metadata(s):
    out = s.FullyConnected(s.var("data"), s.var("w"), no_bias=True,
                           num_hidden=3, flatten=False)
    return out, {"w": np.zeros((3, 7), np.float32)}, {
        "data": np.ones((2, 7), np.float32)}


def wire_format(s):
    out = s.Activation(s.FullyConnected(
        s.var("data"), s.var("w"), no_bias=True, num_hidden=3,
        flatten=False), act_type="relu")
    params = {"w": np.arange(21, dtype=np.float32).reshape(3, 7)}
    return out, params, {"data": np.ones((2, 7), np.float32)}


def scalar_op_on_int_input(s):
    out = s.cast(s.var("data"), dtype="int32") / 2.0 + 0.25
    return out, {}, {"data": np.array([[5.0, 7.0, 9.0]], np.float32)}


def clip_min_none_on_int(s):
    out = s.clip(s.cast(s.var("data"), dtype="int32"), a_min=None,
                 a_max=5.0)
    return out, {}, {"data": np.array([[1.0, 9.0, -3.0]], np.float32)}


def deconvolution_dilated(s):
    rng = np.random.RandomState(7)
    out = s.Deconvolution(s.var("data"), s.var("dw"), kernel=(3, 3),
                          stride=(2, 2), pad=(1, 1), adj=(1, 1),
                          dilate=(2, 2), num_filter=4, no_bias=True)
    params = {"dw": rng.randn(3, 4, 3, 3).astype(np.float32) * 0.2}
    return out, params, {"data": rng.randn(1, 3, 5, 5).astype(np.float32)}


def float_mod_negative_values(s):
    return s.var("data") % 2.5, {}, {
        "data": np.array([[-7.0, -1.0, 1.0, 7.0]], np.float32)}


def reduce_exclude(s):
    data = s.var("data")
    out = s.Group([s.sum(data, axis=1, exclude=True, keepdims=True),
                   s.mean(data, axis=(0, 2), exclude=True)])
    x = np.random.RandomState(11).randn(2, 3, 4).astype(np.float32)
    return out, {}, {"data": x}


def fc_no_flatten_3d(s):
    rng = np.random.RandomState(12)
    out = s.FullyConnected(s.var("data"), s.var("w"), s.var("b"),
                           num_hidden=5, flatten=False)
    params = {"w": rng.randn(5, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    return out, params, {"data": rng.randn(2, 3, 4).astype(np.float32)}


def slice_none_begin(s):
    out = s.slice(s.var("data"), begin=(None, 1), end=(None, 3))
    return out, {}, {"data": np.arange(8, dtype=np.float32).reshape(2, 4)}


def batchnorm_fix_gamma(s):
    rng = np.random.RandomState(21)
    data = s.var("data")
    g, b_, mm, mv = (s.var(n) for n in ("g", "b", "mm", "mv"))
    bn = s.BatchNorm(data, g, b_, mm, mv, fix_gamma=True,
                     use_global_stats=True)
    out = s.Group([bn, s.identity(g)])
    params = {"g": np.full(3, 7.0, np.float32),
              "b": rng.randn(3).astype(np.float32),
              "mm": rng.randn(3).astype(np.float32) * 0.1,
              "mv": rng.rand(3).astype(np.float32) + 0.5}
    return out, params, {"data": rng.randn(2, 3, 4, 4).astype(np.float32)}


SYMBOL_CASES = {f.__name__: (f, atol) for f, atol in (
    (mlp, 1e-5), (convnet, 1e-5), (shape_and_scalar_ops, 1e-5),
    (binary_reduce_matmul, 1e-5), (embedding_gather, 1e-5),
    (get_model_metadata, 1e-5), (wire_format, 1e-5),
    (scalar_op_on_int_input, 1e-5), (clip_min_none_on_int, 1e-5),
    (deconvolution_dilated, 1e-4), (float_mod_negative_values, 1e-5),
    (reduce_exclude, 1e-5), (fc_no_flatten_3d, 1e-5),
    (slice_none_begin, 1e-5), (batchnorm_fix_gamma, 1e-5))}


def _export_both(builder, tmp_path):
    """The case built and exported in each package: {pkg: (path, out,
    params, inputs)}."""
    done = {}
    for pkg, (mx, s, onnx) in PKGS.items():
        _restart_names()
        out, params, inputs = builder(s)
        path = str(tmp_path / f"{pkg}.onnx")
        with _mode(pkg):
            onnx.export_model(out, {k: _nd(pkg, v)
                                    for k, v in params.items()},
                              input_shapes={k: v.shape for k, v in
                                            inputs.items()},
                              onnx_file=path)
        done[pkg] = (path, out, params, inputs)
    return done


@pytest.mark.parametrize("name", sorted(SYMBOL_CASES))
def test_symbol_case_bytes_and_cross_import(name, tmp_path):
    builder, atol = SYMBOL_CASES[name]
    done = _export_both(builder, tmp_path)
    files = {pkg: open(d[0], "rb").read() for pkg, d in done.items()}
    assert files["port"] == files["ref"]
    for src, dst in (("ref", "port"), ("port", "ref")):
        path, out, params, inputs = done[src]
        want = _eval(src, out, {**params, **inputs})
        sym2, vals = _imported(dst, path)
        got = _eval(dst, sym2, {**vals, **inputs})
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=atol, rtol=1e-5)
    meta = {pkg: PKGS[pkg][2].get_model_metadata(done[pkg][0])
            for pkg in PKGS}
    assert meta["port"] == meta["ref"]


def test_schema_is_the_references_bytes():
    """The wire format rides the reference's generated module and
    schema, copied byte for byte (protobuf is on the card's host too)."""
    import os
    for name in ("onnx_pb2.py", "onnx.proto"):
        mine = os.path.join(os.path.dirname(tonnx.__file__), name)
        ref = os.path.join(os.path.dirname(jonnx.__file__), name)
        assert open(mine, "rb").read() == open(ref, "rb").read(), name


def test_convnet_running_stats_land_in_aux(tmp_path):
    done = _export_both(convnet, tmp_path)
    with tmx.cpu():
        _, _, aux = tonnx.import_model(done["ref"][0])
    assert set(aux) == {"mmean", "mvar"}


# ---------------------------------------------------------------------------
# export refusals: the same exception type and message
# ---------------------------------------------------------------------------
def _raises_alike(tmp_path, build, shapes, params=None):
    msgs = []
    for pkg, (mx, s, onnx) in PKGS.items():
        _restart_names()
        with pytest.raises(ValueError) as err:
            onnx.export_model(build(s),
                              {k: _nd(pkg, v)
                               for k, v in (params or {}).items()},
                              input_shapes=shapes,
                              onnx_file=str(tmp_path / f"{pkg}.onnx"))
        msgs.append(str(err.value))
    return msgs


def test_unsupported_op_raises_alike(tmp_path):
    j, t = _raises_alike(tmp_path, lambda s: s.topk(s.var("data"), k=2),
                         {"data": (2, 5)})
    assert "topk" in t and t.split(";")[0] == j.split(";")[0]


def test_batchnorm_axis_and_negative_slice_raise_alike(tmp_path):
    def bn(s):
        return s.BatchNorm(s.var("data"), *(s.var(n) for n in
                                            ("g", "b", "mm", "mv")),
                           axis=-1)
    j, t = _raises_alike(tmp_path, bn, {"data": (2, 3, 4)},
                         {n: np.ones(4, np.float32)
                          for n in ("g", "b", "mm", "mv")})
    assert t == j and "axis" in t
    j, t = _raises_alike(
        tmp_path, lambda s: s.slice(s.var("data"), begin=(None,),
                                    end=(None,), step=(-1,)),
        {"data": (2, 4)})
    assert t == j and "negative step" in t


# ---------------------------------------------------------------------------
# external producers: hand-built protos through both importers
# ---------------------------------------------------------------------------
def _base_model():
    pb = tonnx.onnx_pb2
    m = pb.ModelProto(ir_version=8, producer_name="external")
    m.opset_import.add(domain="", version=13)
    return pb, m


def _add_input(m, name, shape, elem_type=1):
    vi = m.graph.input.add()
    vi.name = name
    tt = vi.type.tensor_type
    tt.elem_type = elem_type
    for d in shape:
        tt.shape.dim.add().dim_value = d


def _imports_alike(m, tmp_path, inputs):
    """Both importers on one file: the same outputs, or the same
    exception (type and message)."""
    path = str(tmp_path / "ext.onnx")
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    res = {}
    for pkg in PKGS:
        try:
            sym2, vals = _imported(pkg, path)
            res[pkg] = _eval(pkg, sym2, {**vals, **inputs})
        except (ValueError, AssertionError) as e:
            res[pkg] = (type(e).__name__, str(e))
    if isinstance(res["ref"], tuple):
        assert res["port"] == res["ref"]
    else:
        assert len(res["port"]) == len(res["ref"])
        for g, w in zip(res["port"], res["ref"]):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    return res["port"]


def ext_fp16_typed_int32_data(pb, m):
    _add_input(m, "x", (2, 3), elem_type=pb.TensorProto.FLOAT16)
    w = m.graph.initializer.add(name="w", data_type=pb.TensorProto.FLOAT16,
                                dims=[2, 3])
    vals = np.array([1.0, -2.5, 0.0, 65504.0, 0.5, -1.0], np.float16)
    w.int32_data.extend(int(v) for v in vals.view(np.uint16))
    m.graph.node.add(op_type="Add", input=["x", "w"], output=["y"],
                     name="add0")
    m.graph.output.add().name = "y"
    return {"x": np.ones((2, 3), np.float16)}


def ext_split_sizes(pb, m, sizes=(4, 4)):
    _add_input(m, "x", (2, 8))
    sz = m.graph.initializer.add(name="sz", data_type=pb.TensorProto.INT64,
                                 dims=[2])
    sz.int64_data.extend(sizes)
    n = m.graph.node.add(op_type="Split", input=["x", "sz"],
                         output=["a", "b"], name="split0")
    ax = n.attribute.add()
    ax.name, ax.type, ax.i = "axis", pb.AttributeProto.INT, 1
    for o in ("a", "b"):
        m.graph.output.add().name = o
    return {"x": np.arange(16, dtype=np.float32).reshape(2, 8)}


def ext_split_unequal(pb, m):
    return ext_split_sizes(pb, m, (3, 5))


def ext_reduce_empty_axes(pb, m):
    _add_input(m, "x", (2, 3))
    m.graph.initializer.add(name="ax", data_type=pb.TensorProto.INT64,
                            dims=[0])
    m.graph.node.add(op_type="ReduceSum", input=["x", "ax"], output=["y"],
                     name="rs0")
    m.graph.output.add().name = "y"
    return {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}


def ext_clip_runtime_bound(pb, m):
    _add_input(m, "x", (2, 3))
    _add_input(m, "lo", (1,))
    m.graph.node.add(op_type="Clip", input=["x", "lo"], output=["y"],
                     name="clip0")
    m.graph.output.add().name = "y"
    return {"x": np.ones((2, 3), np.float32),
            "lo": np.zeros(1, np.float32)}


def ext_auto_pad(pb, m):
    _add_input(m, "x", (1, 1, 4, 4))
    w = m.graph.initializer.add(name="w", data_type=pb.TensorProto.FLOAT,
                                dims=[1, 1, 3, 3])
    w.raw_data = np.ones((1, 1, 3, 3), np.float32).tobytes()
    n = m.graph.node.add(op_type="Conv", input=["x", "w"], output=["y"],
                         name="conv0")
    ap = n.attribute.add()
    ap.name, ap.type, ap.s = "auto_pad", pb.AttributeProto.STRING, \
        b"SAME_UPPER"
    m.graph.output.add().name = "y"
    return {"x": np.ones((1, 1, 4, 4), np.float32)}


def ext_fmod_c_semantics(pb, m):
    _add_input(m, "x", (1, 3))
    w = m.graph.initializer.add(name="w", data_type=pb.TensorProto.FLOAT,
                                dims=[1, 3])
    w.raw_data = np.array([[3.0, 3.0, 3.0]], np.float32).tobytes()
    n = m.graph.node.add(op_type="Mod", input=["x", "w"], output=["y"],
                         name="mod0")
    a = n.attribute.add()
    a.name, a.type, a.i = "fmod", pb.AttributeProto.INT, 1
    m.graph.output.add().name = "y"
    return {"x": np.array([[-7.0, -1.0, 7.0]], np.float32)}


def ext_unsqueeze_negative_axes(pb, m):
    _add_input(m, "x", (2, 3))
    ax = m.graph.initializer.add(name="ax", data_type=pb.TensorProto.INT64,
                                 dims=[2])
    ax.int64_data.extend([-2, -1])
    m.graph.node.add(op_type="Unsqueeze", input=["x", "ax"], output=["y"],
                     name="u0")
    m.graph.output.add().name = "y"
    return {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}


def ext_gather_negative_indices(pb, m):
    _add_input(m, "x", (5,))
    idx = m.graph.initializer.add(name="idx",
                                  data_type=pb.TensorProto.INT64, dims=[2])
    idx.int64_data.extend([-1, 0])
    m.graph.node.add(op_type="Gather", input=["x", "idx"], output=["y"],
                     name="g0")
    m.graph.output.add().name = "y"
    return {"x": np.array([10., 20., 30., 40., 50.], np.float32)}


def ext_dropout_unused_mask(pb, m):
    _add_input(m, "x", (2, 3))
    m.graph.node.add(op_type="Dropout", input=["x"], output=["y", "mask"],
                     name="d0")
    m.graph.node.add(op_type="Relu", input=["y"], output=["z"], name="r0")
    m.graph.output.add().name = "z"
    return {"x": np.array([[-1.0, 2.0, -3.0]], np.float32)}


def ext_dropout_ratio_input(pb, m):
    _add_input(m, "x", (2, 3))
    r = m.graph.initializer.add(name="r", data_type=pb.TensorProto.FLOAT,
                                dims=[])
    r.raw_data = np.asarray(0.25, np.float32).tobytes()
    m.graph.node.add(op_type="Dropout", input=["x", "r"], output=["y"],
                     name="d0")
    m.graph.output.add().name = "y"
    return {"x": np.ones((2, 3), np.float32)}


def ext_dropout_runtime_ratio(pb, m):
    _add_input(m, "x", (2, 3))
    _add_input(m, "r", ())
    m.graph.node.add(op_type="Dropout", input=["x", "r"], output=["y"],
                     name="d0")
    m.graph.output.add().name = "y"
    return {"x": np.ones((2, 3), np.float32),
            "r": np.asarray(0.5, np.float32)}


def ext_empty_optional_bias(pb, m):
    _add_input(m, "x", (1, 1, 4, 4))
    w = m.graph.initializer.add(name="w", data_type=pb.TensorProto.FLOAT,
                                dims=[2, 1, 3, 3])
    w.raw_data = np.ones((2, 1, 3, 3), np.float32).tobytes()
    m.graph.node.add(op_type="Conv", input=["x", "w", ""], output=["y"],
                     name="conv0")
    m.graph.output.add().name = "y"
    return {"x": np.ones((1, 1, 4, 4), np.float32)}


def ext_pad_axes_input(pb, m):
    _add_input(m, "x", (1, 1, 4, 4))
    pads = m.graph.initializer.add(name="p", data_type=pb.TensorProto.INT64,
                                   dims=[4])
    pads.int64_data.extend([1, 1, 1, 1])
    axes = m.graph.initializer.add(name="ax", data_type=pb.TensorProto.INT64,
                                   dims=[2])
    axes.int64_data.extend([2, 3])
    m.graph.node.add(op_type="Pad", input=["x", "p", "", "ax"],
                     output=["y"], name="pad0")
    m.graph.output.add().name = "y"
    return {"x": np.ones((1, 1, 4, 4), np.float32)}


EXTERNAL = {f.__name__: f for f in (
    ext_fp16_typed_int32_data, ext_split_sizes, ext_split_unequal,
    ext_reduce_empty_axes, ext_clip_runtime_bound, ext_auto_pad,
    ext_fmod_c_semantics, ext_unsqueeze_negative_axes,
    ext_gather_negative_indices, ext_dropout_unused_mask,
    ext_dropout_ratio_input, ext_dropout_runtime_ratio,
    ext_empty_optional_bias, ext_pad_axes_input)}
RAISES = {"ext_split_unequal": "unequal Split",
          "ext_clip_runtime_bound": "Clip bound",
          "ext_auto_pad": "auto_pad",
          "ext_dropout_runtime_ratio": "Dropout ratio",
          "ext_pad_axes_input": "axes"}


@pytest.mark.parametrize("name", sorted(EXTERNAL))
def test_external_producer_imports_alike(name, tmp_path):
    pb, m = _base_model()
    inputs = EXTERNAL[name](pb, m)
    got = _imports_alike(m, tmp_path, inputs)
    if name in RAISES:
        assert got[0] == "ValueError" and RAISES[name] in got[1]
    else:
        assert isinstance(got, list)
