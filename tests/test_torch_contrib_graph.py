"""``Symbol.validate`` (mxlint's MXL100 graph pass) in the port against
``mxtpu``'s: on the reference's ``test_graph_validity_*`` graphs and on
the zoo's families (clean, and with one weight's shape seeded wrong),
both packages report the same issues — the same op, node name and
inferred input shapes — and an ONNX export of a malformed graph aborts
with that diagnostic.
"""
import numpy as np
import pytest
import torch

import mxtpu.symbol as jsym
import mxtpu_torch.symbol as tsym
from mxtpu.contrib.analysis import validate_graph as j_validate
from mxtpu.gluon.model_zoo import vision as jvision
from mxtpu_torch.contrib import onnx as tonnx
from mxtpu_torch.contrib.analysis import GraphIssue
from mxtpu_torch.contrib.analysis import validate_graph as t_validate
from mxtpu_torch.gluon.model_zoo import vision as tvision

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def fresh_names():
    """Both packages' auto-name counters from zero (restored after), so
    the same graph built in each gets the same names."""
    saved = dict(jsym.symbol._NAME_COUNTER), dict(tsym.symbol._NAME_COUNTER)
    jsym.symbol._NAME_COUNTER.clear()
    tsym.symbol._NAME_COUNTER.clear()
    yield
    for counter, old in zip((jsym.symbol._NAME_COUNTER,
                             tsym.symbol._NAME_COUNTER), saved):
        counter.clear()
        counter.update(old)


def _key(issues):
    return [(i.rule, i.op, i.name, [None if s is None else tuple(s)
                                    for s in i.input_shapes])
            for i in issues]


def test_graph_validity_names_op_and_shapes():
    got = []
    for sym in (jsym, tsym):
        a, b = sym.var("a"), sym.var("b")
        got.append(sym.dot(a, b).validate(a=(2, 3), b=(4, 5)))
    j, t = got
    assert _key(t) == _key(j) and len(t) == 1
    assert isinstance(t[0], GraphIssue)
    s = str(t[0])
    assert "MXL100" in s and "dot" in s and "(2, 3)" in s and "(4, 5)" in s


def test_graph_validity_clean_graph_is_empty():
    for sym in (jsym, tsym):
        a, b = sym.var("a"), sym.var("b")
        assert sym.dot(a, b).validate(a=(2, 3), b=(3, 5)) == []


def test_graph_validity_missing_input_shape():
    j = j_validate(jsym.relu(jsym.var("x")))
    t = t_validate(tsym.relu(tsym.var("x")))
    assert _key(t) == _key(j)
    assert t[0].message == j[0].message
    assert "x" in t[0].message and "input_shapes" in t[0].message


def test_graph_validity_params_give_shapes_and_dtypes():
    """Params (NDArrays, tensors or numpy) stand for their vars; a
    wrong one is reported at the op that consumes it."""
    import mxtpu_torch as tmx
    got = []
    for sym in (jsym, tsym):
        x, w = sym.var("x"), sym.var("w")
        y = sym.FullyConnected(x, w, no_bias=True, num_hidden=4)
        got.append((y.validate({"w": np.zeros((4, 6), np.float32)},
                               x=(2, 6)),
                    y.validate({"w": np.zeros((4, 5), np.float32)},
                               x=(2, 6))))
    (j_ok, j_bad), (t_ok, t_bad) = got
    assert j_ok == [] and t_ok == []
    assert _key(t_bad) == _key(j_bad) and len(t_bad) == 1
    with tmx.cpu():
        w = tmx.nd.zeros((4, 6))
    x = tsym.var("x")
    y = tsym.FullyConnected(x, tsym.var("w"), no_bias=True, num_hidden=4)
    assert y.validate({"w": w}, x=(2, 6)) == []
    assert y.validate({"w": torch.zeros(4, 6)}, x=(2, 6)) == []


def test_onnx_export_uses_graph_diagnostic(tmp_path):
    a, b = tsym.var("a"), tsym.var("b")
    with pytest.raises(ValueError) as err:
        tonnx.export_model(tsym.dot(a, b), {},
                           input_shapes={"a": (2, 3), "b": (4, 5)},
                           onnx_file=str(tmp_path / "bad.onnx"))
    msg = str(err.value)
    assert "MXL100" in msg and "dot" in msg and "(2, 3)" in msg


_ZOO = ["resnet18_v1", "resnet18_v2", "vgg11_bn", "alexnet",
        "densenet121", "squeezenet1.0", "inceptionv3", "mobilenet0.25",
        "mobilenetv2_0.25"]


def _zoo_issues(sym, vision, name, seeded):
    size = {"inceptionv3": 299, "densenet121": 224}.get(name, 64)
    out = vision.get_model(name, prefix="zoo_")._trace_symbol(
        sym.var("data"))
    if isinstance(out, (list, tuple)):
        out = sym.Group(list(out))
    params = {}
    if seeded:
        # the first weight, with one input channel too many
        w = next(a for a in out.list_arguments() if a.endswith("weight"))
        shp = tuple(out._infer_structs(data=(1, 3, size, size))[1][w].shape)
        params = {w: np.zeros((shp[0], shp[1] + 1) + shp[2:], np.float32)}
    return out.validate(params, data=(1, 3, size, size))


@pytest.mark.parametrize("name", _ZOO)
def test_zoo_family_validates_like_the_reference(name):
    for seeded in (False, True):
        j = _zoo_issues(jsym, jvision, name, seeded)
        jsym.symbol._NAME_COUNTER.clear()
        tsym.symbol._NAME_COUNTER.clear()
        t = _zoo_issues(tsym, tvision, name, seeded)
        assert _key(t) == _key(j)
        assert len(t) == int(seeded)
        if seeded:
            assert t[0].op == "Convolution"
