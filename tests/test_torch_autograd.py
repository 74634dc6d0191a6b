"""Parity of mxtpu_torch.autograd (the tape over NDArray ops) with
mxtpu.autograd on the CPU.

The same numpy inputs (``np.random.default_rng``) and the same
expressions, built from NDArray methods, go through both packages under
``autograd.record()``; the leaf grads must agree within 1e-5 relative
(float32: the grads are short chains of elementwise ops and small
reductions). The reference's tape never frees its pullbacks, so a second
``backward`` on the same head works in both: ``grad_req='write'`` writes
the same grads again and ``'add'`` doubles them.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)

rng = np.random.default_rng(1)
X = rng.standard_normal((3, 4)).astype(np.float32)
Y = rng.standard_normal((3, 4)).astype(np.float32)
P = rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
W = rng.standard_normal((4, 5)).astype(np.float32)
G = rng.standard_normal((3, 5)).astype(np.float32)


class Pkg:
    def __init__(self, mx, ctx):
        self.mx, self.nd, self.ag, self.ctx = mx, mx.nd, mx.autograd, ctx

    def arr(self, a, **kw):
        return self.nd.array(a, ctx=self.ctx, **kw)

    def leaf(self, a, grad_req="write"):
        v = self.arr(a)
        v.attach_grad(grad_req=grad_req)
        return v


REF, PORT = Pkg(jmx, None), Pkg(tmx, "cpu")


def both(fn):
    """fn(pkg) on both packages, results as numpy."""
    def host(v):
        if isinstance(v, (list, tuple)):
            return [host(a) for a in v]
        return v.asnumpy() if hasattr(v, "asnumpy") else v
    return host(fn(REF)), host(fn(PORT))


def assert_same(ref, got):
    if isinstance(ref, list):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            assert_same(r, g)
        return
    if isinstance(ref, np.ndarray):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        assert got == ref


# expressions of two variables, from NDArray methods and dunders
EXPRS = {
    "poly": lambda x, y: (x * x * y + 3.0 * x - y / 2.0).sum(),
    "exp_log": lambda x, y: (x.exp() * (y * y + 1.0).log()).mean(),
    "div_pow": lambda x, y: (x / (y * y + 1.0) + (x * x + 1.0) ** 1.5).sum(),
    "rdiv_rsub": lambda x, y: ((2.0 / (x * x + 1.0)) - (1.0 - y)).sum(),
    "sqrt_abs": lambda x, y: ((x * x + 0.5).sqrt() + abs(y)).sum(),
    "tanh_sigmoid_relu": lambda x, y: (x.tanh() * y.sigmoid()
                                       + (x - y).relu()).sum(),
    "softmax": lambda x, y: (x.softmax(axis=1) * y).sum(),
    "norm": lambda x, y: x.norm() + (x * y).norm(axis=1).sum(),
    "max_min": lambda x, y: x.max(axis=1).sum() - (x * y).min(),
    "prod": lambda x, y: (x * 0.5 + 1.5).prod(axis=0).sum() + y.sum(),
    "reshape_T": lambda x, y: (x.reshape(4, 3).T * y).sum(),
    "transpose_swap": lambda x, y: (x.transpose() * y.swapaxes(0, 1)).sum(),
    "expand_squeeze": lambda x, y: (x.expand_dims(0).squeeze(0)
                                    * y.flatten()).sum(),
    "broadcast": lambda x, y: (x.sum(axis=0, keepdims=True)
                               .broadcast_to((3, 4)) * y).sum(),
    "getitem": lambda x, y: (x[1:, ::2] * y[[0, 2], 1:3]).sum() + x[0, 3],
    "slice_take": lambda x, y: (x.slice_axis(1, 1, 3)
                                * y.take(np.array([2, 0, 1]))[:, :2]).sum(),
    "tile_repeat": lambda x, y: (x.tile((1, 2)) * y.repeat(2, axis=1)).sum(),
    "clip": lambda x, y: (x.clip(-0.5, 0.5) * y).sum(),
    "astype": lambda x, y: (x.astype("float64") * 2.0).astype("float32")
    .sum() + y.mean(),
    "argmax_constant": lambda x, y: (x * y.argmax(axis=1).expand_dims(1))
    .sum(),
    "compare_constant": lambda x, y: (x * (y > 0)).sum(),
    "mod": lambda x, y: ((x * 3.0) % (y * y + 1.0)).sum(),
    "leaf_used_twice": lambda x, y: (x * x + x).sum() + (y * 0.0).sum(),
}


def concat_stack(m, x, y):
    return (m.nd.concat(x, y, dim=0) * m.nd.stack(y, x).reshape(6, 4)).sum()


@pytest.mark.parametrize("name", sorted(EXPRS) + ["concat_stack"])
def test_grads_match(name):
    def run(m):
        x, y = m.leaf(X), m.leaf(Y)
        with m.ag.record():
            out = concat_stack(m, x, y) if name == "concat_stack" \
                else EXPRS[name](x, y)
        out.backward()
        return [out, x.grad, y.grad]
    ref, got = both(run)
    assert_same(ref, got)


@pytest.mark.parametrize("req", ["write", "add", "null"])
@pytest.mark.parametrize("retain_graph", [False, True])
def test_grad_req_and_second_backward(req, retain_graph):
    """Two backward calls on one head: 'write' twice gives the same
    grads, 'add' doubles them, 'null' leaves the zeros."""
    def run(m):
        x = m.leaf(X, grad_req=req)
        with m.ag.record():
            y = (x * x * 3.0).sum()
        y.backward(retain_graph=retain_graph)
        first = x.grad.asnumpy()
        y.backward(retain_graph=retain_graph)
        return [first, x.grad]
    ref, got = both(run)
    assert_same(ref, got)
    expect = {"write": 6 * X, "add": 12 * X, "null": 0 * X}[req]
    np.testing.assert_allclose(got[1], expect, **TOL)


def test_add_accumulates_across_recordings():
    def run(m):
        x = m.leaf(X, grad_req="add")
        for scale in (1.0, 2.0, 3.0):
            with m.ag.record():
                y = (x * scale).sum()
            y.backward()
        return x.grad
    ref, got = both(run)
    assert_same(ref, got)


def test_head_grads_and_several_heads():
    def run(m):
        x, w = m.leaf(X), m.leaf(W)
        with m.ag.record():
            h = x @ w
            a = h.tanh()
            b = (h * h).sum(axis=1)
        m.ag.backward([a, b], [m.arr(G), None])
        gx, gw = x.grad.asnumpy(), w.grad.asnumpy()
        with m.ag.record():
            z = (x @ w).sigmoid()
        z.backward(m.arr(G))
        gz = x.grad.asnumpy()
        with m.ag.record():
            s = (x * x).sum()
        s.backward(np.float32(3.0))            # a numpy head grad
        return [gx, gw, gz, w.grad, x.grad]
    ref, got = both(run)
    assert_same(ref, got)


def test_pause_and_detach_block_the_gradient():
    def run(m):
        x = m.leaf(X)
        with m.ag.record():
            y = x * 2.0
            with m.ag.pause():
                c = x * 3.0
            z = (y * c + x.detach() * x).sum()
        z.backward()
        return x.grad
    ref, got = both(run)
    assert_same(ref, got)


def test_scopes_set_recording_and_training():
    def run(m):
        ag, seen = m.ag, []
        seen.append((ag.is_recording(), ag.is_training()))
        with ag.record():
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                seen.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                seen.append((ag.is_recording(), ag.is_training()))
                with ag.train_mode():
                    seen.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            seen.append((ag.is_recording(), ag.is_training()))
        seen.append((ag.is_recording(), ag.is_training()))
        return seen
    ref, got = both(run)
    assert got == ref


def test_backward_on_an_untracked_array_raises():
    for m in (REF, PORT):
        x = m.arr(X)
        with pytest.raises(ValueError, match="not computed under"):
            x.backward()
        v = m.leaf(X)
        with pytest.raises(ValueError):
            (v * 2.0).backward()           # not recorded


def test_autograd_grad_leaves_dot_grad_alone():
    def run(m):
        x, y = m.leaf(X), m.leaf(Y)
        with m.ag.record():
            z = (x * x * y).sum()
        z.backward()
        before = [x.grad.asnumpy(), y.grad.asnumpy()]
        with m.ag.record():
            z2 = (x.exp() * y).sum()
        gx, gy = m.ag.grad(z2, [x, y])
        single = m.ag.grad(z2, x)
        return before + [gx, gy, single, x.grad, y.grad]
    ref, got = both(run)
    assert_same(ref, got)
    np.testing.assert_allclose(got[5], got[0])


def test_mark_variables():
    def run(m):
        x, y = m.arr(X), m.arr(Y)
        m.ag.mark_variables([x, y], [m.arr(np.ones_like(X)), None],
                            grad_reqs=["add", "write"])
        with m.ag.record():
            z = (x * y).sum()
        z.backward()
        return [x.grad, y.grad]
    ref, got = both(run)
    assert_same(ref, got)


def test_function_with_custom_backward():
    def run(m):
        class ScaledSquare(m.ag.Function):
            """x², with a backward that also scales by 3 (so the test sees
            the custom rule, not autograd's)."""

            def forward(self, x):
                self.saved = x
                return x * x

            def backward(self, dy):
                return 3.0 * 2.0 * self.saved * dy

        class SplitSum(m.ag.Function):
            def forward(self, a, b):
                return a + b, a - b

            def backward(self, d1, d2):
                return d1 + d2, d1 - d2

        x, y = m.leaf(X), m.leaf(Y)
        with m.ag.record():
            s = ScaledSquare()(x)
            p, q = SplitSum()(s, y)
            z = (p * 2.0 + q * q).sum()
        z.backward()
        return [z, x.grad, y.grad]
    ref, got = both(run)
    assert_same(ref, got)


def test_multi_output_apply_op():
    """apply_op's n_out > 1: each output gets its own tape slot."""
    def run(m, split):
        from importlib import import_module
        apply_op = import_module(m.nd.__name__ + ".ndarray").apply_op
        x = m.leaf(X)
        with m.ag.record():
            a, b = apply_op(split, [x], "split2", n_out=2)
            z = (a * 2.0).sum() + (b * b).sum()
        z.backward()
        return [a, b, x.grad]
    ref = [v.asnumpy() for v in run(REF, lambda t: (t[:, :2], t[:, 2:]))]
    got = [v.asnumpy() for v in run(PORT, lambda t: (t[:, :2], t[:, 2:]))]
    assert_same(ref, got)


def test_gluon_cached_op_path_raises():
    """A CachedOp-marked function (the reference's ``_mx_cache_vjp``)
    raises no more: the tape records it as one node like any op, whose
    pullback gives the function's gradient."""
    from mxtpu_torch import autograd as tag

    def fn(t):
        return t * 2.0
    fn._mx_cache_vjp = True
    x = PORT.leaf(X)
    with tag.record():
        out, node = tag.invoke(fn, [x._data], [x._ag_leaf])
    assert node is not None
    np.testing.assert_array_equal(out.numpy(), X * 2.0)
    (g,) = node.vjp_fn(torch.ones_like(out))
    np.testing.assert_array_equal(g.numpy(), np.full_like(X, 2.0))


def test_tape_keeps_saved_tensors_through_writes():
    """A write to a leaf after recording rebinds its buffer; the tape
    still differentiates at the values it saw, as the reference does."""
    def run(m):
        x = m.leaf(X)
        with m.ag.record():
            z = (x * x).sum()
        x[:] = 0.0
        x += 5.0
        z.backward()
        return [x, x.grad]
    ref, got = both(run)
    assert_same(ref, got)
