"""``mxtpu_torch.operator`` (``mx.operator``'s custom ops) against
``mxtpu.operator`` on the CPU: the reference's ``ScaledSquare`` from
``tests/test_control_flow.py`` (forward and gradient), an op with two
outputs, one that asks for no top gradient, a hybridized block calling
``F.Custom``, ``mx.sym.Custom`` through the Executor, the unregistered
name's error, and the refusal inside a CUDA-graph capture (driven here
through stand-ins for the capture, as ``test_torch_fused.py`` does).
Values and gradients are compared within 1e-6 relative.
"""
import numpy as onp
import pytest
import torch

import mxtpu as jmx
import mxtpu.operator  # noqa: F401
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError

torch.set_num_threads(2)   # a CPU share for each xdist worker

X = onp.array([[1.0, 2.0], [3.0, -4.0]], onp.float32)
RNG = onp.random.default_rng(0)
XB = RNG.standard_normal((3, 5)).astype(onp.float32)


def _register(mx):
    """The same custom ops in either package."""
    class ScaledSquare(mx.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], self.scale * x * x)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0].asnumpy()
            g = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], 2.0 * self.scale * x * g)

    @mx.operator.register("scaled_square")
    class ScaledSquareProp(mx.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return ScaledSquare(self.scale)

    class SumDiff(mx.operator.CustomOp):
        """(a + b, a · b) of two inputs; gradients of both outputs."""

        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data[0].asnumpy(), in_data[1].asnumpy()
            self.assign(out_data[0], req[0], a + b)
            self.assign(out_data[1], req[1], a * b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = in_data[0].asnumpy(), in_data[1].asnumpy()
            g0, g1 = out_grad[0].asnumpy(), out_grad[1].asnumpy()
            self.assign(in_grad[0], req[0], g0 + g1 * b)
            self.assign(in_grad[1], req[1], g0 + g1 * a)

    @mx.operator.register("sum_prod")
    class SumProdProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "prod"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return SumDiff()

    class SoftmaxLoss(mx.operator.CustomOp):
        """numpy softmax forward; backward y - onehot(label), ignoring
        the top gradient (MXNet's example/numpy-ops/custom_softmax.py)."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = onp.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(onp.int64)
            y = out_data[0].asnumpy().copy()
            y[onp.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], y)

    @mx.operator.register("np_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return SoftmaxLoss()


_register(jmx)
_register(tmx)


def _close(got, want):
    onp.testing.assert_allclose(onp.asarray(got), onp.asarray(want),
                                rtol=1e-6, atol=1e-7)


def _run(mx, ctx, fn, *arrays, record=True):
    xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        outs = fn(mx, *xs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    mx.autograd.backward(outs)
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def _both(fn, *arrays):
    got = _run(tmx, "cpu", fn, *arrays)
    want = _run(jmx, jmx.cpu(), fn, *arrays)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _close(g, w)
    return got


def test_scaled_square_forward_backward():
    y = tmx.nd.Custom(tmx.nd.array(X, ctx="cpu"), op_type="scaled_square",
                      scale=3.0)
    _close(y.asnumpy(), 3 * X ** 2)
    (outs, grads) = _both(
        lambda mx, x: mx.nd.Custom(x, op_type="scaled_square",
                                   scale=3.0).sum(), X)
    _close(grads[0], 6 * X)


def test_multi_output():
    outs, grads = _both(
        lambda mx, a, b: mx.nd.Custom(a, b, op_type="sum_prod"), XB, 2 * XB)
    assert len(outs) == 2
    _close(outs[1], 2 * XB * XB)


def test_need_top_grad_false():
    lab = onp.array([0, 4, 2], onp.float32)

    def fn(mx, x):
        return mx.nd.Custom(x, mx.nd.array(lab, ctx=x.context),
                            op_type="np_softmax")
    outs, grads = _both(fn, XB)
    ref = jmx.nd.SoftmaxOutput(jmx.nd.array(XB), jmx.nd.array(lab))
    _close(outs[0], ref.asnumpy())


def test_unregistered_name_raises():
    with pytest.raises(MXNetError, match="not registered"):
        tmx.nd.Custom(tmx.nd.array(X, ctx="cpu"), op_type="no_such_op")
    assert {"scaled_square", "sum_prod", "np_softmax"} <= \
        set(tmx.operator.get_all_registered())
    assert tmx.nd.Custom is tmx.operator.Custom is \
        tmx.nd.OP_REGISTRY["Custom"]


def _block(mx):
    class Net(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Custom(x * 2.0, op_type="scaled_square", scale=0.5) + x
    return Net()


def test_hybridized_block_matches_mxtpu():
    def fn(mx, x):
        net = _block(mx)
        net.initialize()
        net.hybridize()
        return net(x)
    outs, grads = _both(fn, XB)
    _close(outs[0], 2 * XB * XB + XB)
    # a predict-mode call of the hybridized block
    net = _block(tmx)
    net.initialize(ctx="cpu")
    net.hybridize()
    _close(net(tmx.nd.array(XB, ctx="cpu")).asnumpy(), outs[0])


def test_sym_custom_through_the_executor():
    def run(mx, ctx):
        data = mx.sym.var("data")
        out = mx.sym.Custom(data, op_type="scaled_square", scale=2.0,
                            name="sq") * 3.0
        shapes = out.infer_shape(data=XB.shape)
        ex = out.bind(ctx, {"data": mx.nd.array(XB, ctx=ctx)},
                      args_grad={"data": mx.nd.zeros(XB.shape, ctx=ctx)})
        y = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(mx.nd.ones(XB.shape, ctx=ctx))
        return shapes, y, ex.grad_dict["data"].asnumpy()
    (tsh, ty, tg), (jsh, jy, jg) = run(tmx, "cpu"), run(jmx, jmx.cpu())
    assert [list(map(tuple, s)) for s in tsh] == \
        [list(map(tuple, s)) for s in jsh]
    _close(ty, jy)
    _close(tg, jg)
    _close(tg, 12 * XB)


def test_custom_under_a_capture_raises(monkeypatch):
    """Inside a CUDA-graph capture (a hybridized predict call, the
    Executor's predict graph) ``Custom`` raises naming the op; the
    capture is a stand-in here: the warm-up runs plainly, then the
    captured function runs with the capture flag up."""
    from mxtpu_torch import operator as top
    from mxtpu_torch.gluon import block as tblock
    from mxtpu_torch.symbol import symbol as tsymbol

    capturing = []
    monkeypatch.setattr(top, "_capturing", lambda device: bool(capturing))

    def stand_in(build, fn, warm, device):
        warm()
        capturing.append(build)
        try:
            fn()
        finally:
            capturing.pop()
        return None

    monkeypatch.setattr(tblock, "graphs_on", lambda device: True)
    monkeypatch.setattr(tblock, "capture_graph", stand_in)
    net = _block(tmx)
    net.initialize(ctx="cpu")
    net.hybridize()
    x = tmx.nd.array(XB, ctx="cpu")
    with pytest.raises(MXNetError, match="scaled_square.*un-hybridized"):
        net(x)
    # under record the block runs plainly, with the op's backward
    x.attach_grad()
    with tmx.autograd.record():
        y = net(x)
    y.backward()
    _close(x.grad.asnumpy(), 4 * XB + 1)

    monkeypatch.setattr(tsymbol, "graphs_on", lambda device: True)
    monkeypatch.setattr(tsymbol, "capture_graph", stand_in)
    data = tmx.sym.var("data")
    ex = tmx.sym.Custom(data, op_type="scaled_square").bind(
        "cpu", {"data": x})
    ex.forward()                  # a signature's first call runs eagerly
    with pytest.raises(MXNetError, match="scaled_square"):
        ex.forward()
