"""mx.contrib.onnx in the port against ``mxtpu.contrib.onnx``: the
HybridBlock cases of the reference's ``tests/test_onnx.py`` (the zoo's
MobileNetV2, a two-input block, a two-layer LSTM whose packed weights
fold) and one net of each zoo family. Each is built in both packages,
the same seeded weights are loaded into both by name, and both export:
the port writes the reference's file byte for byte; each package's
importer reads the other's file to the same graph; the port's imported
MobileNetV2 runs the source net's logits within the reference's 1e-4.
The Symbol cases are in ``test_torch_contrib_onnx.py``.
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
    """The reference in its default 32-bit mode (the suite's conftest
    turns 64-bit mode on)."""
    return jax.enable_x64(False) if pkg == "ref" else \
        contextlib.nullcontext()


def _restart_names():
    jsym.symbol._NAME_COUNTER.clear()
    tsym.symbol._NAME_COUNTER.clear()


def _weights(shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes:
        if name.endswith(("gamma", "running_var")):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith(("beta", "bias", "running_mean")):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) / np.sqrt(
                max(1, int(np.prod(shape[1:]))))
        out[name] = v.astype(np.float32)
    return out


def _load_same_weights(jnet, tnet, data_shapes):
    """Seeded weights by name into both nets, their shapes resolved by
    one forward of the port's net on zeros (``init.Zero`` overrides
    each parameter's own initializer)."""
    for p in tnet.collect_params().values():
        p.initialize(tmx.init.Zero(), ctx="cpu")
    tnet(*[tmx.nd.zeros(s, ctx="cpu") for s in data_shapes])
    w = _weights([(k, p.shape) for k, p in tnet.collect_params().items()])
    for k, p in tnet.collect_params().items():
        p._load_init(tmx.nd.array(w[k], ctx="cpu"), "cpu")
    for k, p in jnet.collect_params().items():
        p._load_init(jmx.nd.array(w[k], ctx=jmx.cpu()), jmx.cpu())
    return w


def _block_bytes(tmp_path, make, data_shapes, tag="m"):
    _restart_names()
    jnet = make(jmx)
    _restart_names()
    tnet = make(tmx)
    _load_same_weights(jnet, tnet, data_shapes)
    files = {}
    for pkg, net in (("ref", jnet), ("port", tnet)):
        _restart_names()
        path = str(tmp_path / f"{tag}_{pkg}.onnx")
        with _mode(pkg):
            PKGS[pkg][2].export_model(net, input_shapes=list(data_shapes),
                                      onnx_file=path)
        files[pkg] = path
    return jnet, tnet, files


def _imported_json(pkg, path):
    _restart_names()
    with (tmx.cpu() if pkg == "port" else _mode(pkg)):
        sym, arg, aux = PKGS[pkg][2].import_model(path)
    return sym.tojson(), sorted(arg), sorted(aux)


def test_gluon_model_zoo_roundtrip(tmp_path):
    """The reference's import of the port's file is the graph the port's
    import of the reference's file makes (the same JSON, params and
    aux); the port's imported net runs the source net's logits within
    the reference test's 1e-4."""
    def make(mx):
        return mx.gluon.model_zoo.vision.mobilenet_v2_0_25(prefix="mbv2_")
    shape = (1, 3, 64, 64)
    _, tnet, files = _block_bytes(tmp_path, make, [shape])
    assert open(files["port"], "rb").read() == \
        open(files["ref"], "rb").read()
    assert _imported_json("port", files["ref"]) == \
        _imported_json("ref", files["port"])
    x = np.random.RandomState(5).rand(*shape).astype(np.float32)
    want = tnet(tmx.nd.array(x, ctx="cpu")).asnumpy()
    block = tonnx.import_to_gluon(files["ref"], ctx="cpu")
    got = block(tmx.nd.array(x, ctx="cpu")).asnumpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_export_model_multi_input_needs_shapes(tmp_path):
    def make(mx):
        class TwoInput(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, a, b):
                return a + b
        net = TwoInput(prefix="two_")
        return net
    msgs = []
    for pkg in PKGS:
        net = make(PKGS[pkg][0])
        with pytest.raises(ValueError, match="input_shapes") as err:
            PKGS[pkg][2].export_model(net, onnx_file=str(tmp_path / "x"))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    _, _, files = _block_bytes(tmp_path, make, [(2, 3), (2, 3)])
    assert open(files["port"], "rb").read() == \
        open(files["ref"], "rb").read()
    block = tonnx.import_to_gluon(files["ref"], ctx="cpu")
    x = np.random.RandomState(3).rand(2, 3).astype(np.float32)
    np.testing.assert_allclose(block(tmx.nd.array(x, ctx="cpu"),
                                     tmx.nd.array(x, ctx="cpu")).asnumpy(),
                               x + x, atol=1e-6)


def test_lstm_export_folds_param_packing(tmp_path):
    def make(mx):
        return mx.gluon.rnn.LSTM(hidden_size=8, num_layers=2, layout="NTC",
                                 prefix="lstm_")
    _, tnet, files = _block_bytes(tmp_path, make, [(2, 5, 4)])
    data = open(files["port"], "rb").read()
    assert data == open(files["ref"], "rb").read()
    model = tonnx.onnx_pb2.ModelProto()
    model.ParseFromString(data)
    ops = [n.op_type for n in model.graph.node]
    assert ops.count("LSTM") == 2 and "Concat" not in ops


_ZOO = ["resnet18_v1", "resnet18_v2", "vgg11_bn", "alexnet",
        "densenet121", "squeezenet1.0", "inceptionv3", "mobilenet0.25",
        "mobilenetv2_0.25"]


@pytest.mark.parametrize("name", _ZOO)
def test_model_zoo_family_exports_the_same_bytes(name, tmp_path):
    size = {"inceptionv3": 299, "densenet121": 224}.get(name, 64)

    def make(mx):
        return mx.gluon.model_zoo.vision.get_model(name, prefix="zoo_")
    _, _, files = _block_bytes(tmp_path, make, [(1, 3, size, size)])
    data = open(files["port"], "rb").read()
    assert data == open(files["ref"], "rb").read()
    assert tonnx.get_model_metadata(files["ref"]) == \
        jonnx.get_model_metadata(files["port"])
