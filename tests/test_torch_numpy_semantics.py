"""``mx.np``'s semantics on the CPU against the reference's: the case
lists of ``tests/test_numpy_semantics.py`` through both packages, the
promotion matrix over every dtype pair both hold (``jnp.promote_types``,
and Python scalars weakly), tape and grads through ``mx.np``, the class
kept through registry ops, boolean masks and fancy writes, ``from_nd``
and ``as_nd_ndarray`` sharing the tape link and grad, and ``mx.npx``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import dtype_name

import test_numpy_semantics as ref_cases

torch.set_num_threads(2)
rng = np.random.default_rng(11)
DTYPES = ["bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16",
          "int32", "int64", "float16", "bfloat16", "float32", "float64",
          "complex64", "complex128"]
_X64 = {"float64": "float32", "complex128": "complex64"}


def both(fn):
    """``fn(mx)`` through the reference and the port (on the CPU)."""
    ref = fn(jmx)
    with tmx.cpu():
        got = fn(tmx)
    return ref, got


def close(ref, got, rtol=1e-12, x64=False):
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            close(r, g, rtol, x64)
        return
    r, g = ref.asnumpy(), got.asnumpy()
    assert g.shape == r.shape
    want = r.dtype.name
    assert dtype_name(got.dtype) == (_X64.get(want, want) if x64 else want)
    np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * (
        np.abs(r).max() if r.size else 0), equal_nan=True)


@pytest.mark.parametrize("name", ref_cases.UNARY)
def test_unary(name):
    x = (rng.random((3, 4)) * 0.8 + 0.1)
    close(*both(lambda mx: getattr(mx.np, name)(
        mx.np.array(x, dtype="float64"))))


@pytest.mark.parametrize("name", ref_cases.BINARY)
def test_binary(name):
    a, b = rng.random((2, 1, 4)) + 0.5, rng.random((3, 1)) + 0.5
    close(*both(lambda mx: getattr(mx.np, name)(
        mx.np.array(a, dtype="float64"), mx.np.array(b, dtype="float64"))))


@pytest.mark.parametrize("name", ref_cases.REDUCE)
def test_reductions(name):
    x = rng.random((3, 4, 5))
    for kw in ({}, {"axis": 1}):
        close(*both(lambda mx: getattr(mx.np, name)(
            mx.np.array(x, dtype="float64"), **kw)), rtol=1e-12)


@pytest.mark.parametrize("name,kw", ref_cases.SHAPE + ref_cases.EXTRA_UNARY_KW)
def test_shape_and_more(name, kw):
    x = rng.random((4, 4))
    close(*both(lambda mx: getattr(mx.np, name)(
        mx.np.array(x, dtype="float64"), **kw)))


@pytest.mark.parametrize("da", DTYPES)
def test_promotion_matrix(da):
    """``a + b`` for every pair of the dtypes both hold, as
    ``jnp.promote_types``; Python scalars weakly (jax's default float
    is float64 in the reference's 64-bit mode, float32 here)."""
    with tmx.cpu():
        a = tmx.np.ones((2,), dtype=da)
        for db in DTYPES:
            b = tmx.np.ones((2,), dtype=db)
            want = np.dtype(jnp.promote_types(da, db)).name
            assert dtype_name((a + b).dtype) == want, (da, db)
            assert dtype_name(tmx.np.result_type(a, b)) == want
        for s in (True, 1, 2.5, 1j):
            want = np.dtype(jnp.result_type(jnp.ones(2, da), s)).name
            if da not in ("float64", "complex128"):
                want = _X64.get(want, want)
            if da == "float64" and isinstance(s, complex):
                want = "complex128"
            assert dtype_name((a + s).dtype) == want, (da, s)


def test_scalar_promotion_and_zero_dim():
    with tmx.cpu():
        a = tmx.np.array([1.0, 2.0], dtype="float32")
        assert (a + 1).dtype == torch.float32
        assert (a * 2.5).dtype == torch.float32
        assert (tmx.np.array([1, 2], dtype="int32") + 1).dtype == torch.int32
        s = tmx.np.array(3.5, dtype="float64")
        assert s.shape == () and s.ndim == 0 and s.item() == 3.5
        r = tmx.np.sum(tmx.np.array([[1.0, 2.0]], dtype="float64"))
        assert r.shape == () and isinstance(r, tmx.np.ndarray)


def test_comparisons_masks_and_fancy_writes():
    x = rng.standard_normal((4, 5))

    def run(mx):
        a = mx.np.array(x, dtype="float64")
        m = a > 0
        out = [m, a[m], a[x[:, 0] > 0], mx.np.where(m, a, 0),
               a == None, a != None]   # noqa: E711
        b = mx.np.array(x, dtype="float64")
        b[mx.np.array(x > 0.3)] = -7.0
        b[mx.np.array([0, 3], dtype="int32")] = 1.5
        b[1:3, ::2] = -2.0
        b[-1] = 0.0
        c = mx.np.array(x, dtype="float64")
        rmask = np.array([True, False, True, False])
        c[mx.np.array(rmask)] = mx.np.array(np.arange(5.0),
                                            dtype="float64")
        out += [b, c, a[1:4, ::2], a[::-1], a[[0, 2], [1, 3]],
                a[1, :, None], a[..., 0]]
        return out
    ref, got = both(run)
    assert got[0].dtype == torch.bool
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.asnumpy(), r.asnumpy())


def test_tape_through_np_and_from_nd():
    def run(mx):
        x = mx.np.array([1.0, 2.0, 3.0], dtype="float64")
        x.attach_grad()
        with mx.autograd.record():
            y = mx.np.sum(mx.np.exp(x) * mx.np.sin(x) + x @ x)
        y.backward()
        # from_nd shares the tape link and the grad buffer
        n = mx.nd.array(np.arange(4.0), dtype="float64")
        n.attach_grad()
        with mx.autograd.record():
            v = mx.np.from_nd(n) if mx is tmx else mx.np.from_nd(n)
            s = mx.np.take(v, mx.np.array([1, 2], dtype="int32"), axis=0,
                           mode="clip").as_nd_ndarray().sum()
        s.backward()
        return [x.grad, n.grad, mx.np.from_nd(n).grad]
    ref, got = both(run)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=1e-12)
    assert isinstance(got[0], tmx.nd.NDArray)


def test_class_kept_through_registry_ops():
    with tmx.cpu():
        a = tmx.np.array(rng.standard_normal((3, 4)), dtype="float32")
        for out in (tmx.nd.relu(a), a * 2, a.T, a[0], tmx.nd.dot(a, a.T),
                    tmx.npx.softmax(a, axis=-1), a.astype("float64")):
            assert isinstance(out, tmx.np.ndarray), type(out)
        assert type(a.as_nd_ndarray()) is tmx.nd.NDArray
        with pytest.raises(tmx.MXNetError):
            b = tmx.np.array([1.0, 2.0], dtype="float64")
            b.attach_grad()
            with tmx.autograd.record():
                y = b * 2
                y[0] = 5.0
        s = tmx.np.array([3.0, 1.0, 2.0])
        assert s.sort() is None
        np.testing.assert_array_equal(s.asnumpy(), [1.0, 2.0, 3.0])
        with pytest.raises(NotImplementedError, match="mode='clip'"):
            s.take(tmx.np.array([0], dtype="int32"))
        with pytest.raises(NotImplementedError, match="C order"):
            s.ravel("F")
        assert s.reshape(3, 1).shape == (3, 1)
        with pytest.raises(RuntimeError):
            s.reshape(0, 3)            # NumPy's 0 is a size, not "copy"


def test_npx_ops():
    x = rng.standard_normal((3, 4)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    idx = np.array([0, 2, 1])

    def run(mx):
        a = mx.np.array(x)
        return [mx.npx.relu(a), mx.npx.sigmoid(a),
                mx.npx.softmax(a, axis=-1),
                mx.npx.log_softmax(a, axis=-1),
                mx.npx.one_hot(mx.np.array(idx, dtype="int32"), depth=4),
                mx.npx.pick(a, mx.np.array(idx, dtype="int32"), axis=1),
                mx.npx.topk(a, k=2, axis=-1, ret_typ="value"),
                mx.npx.fully_connected(a, mx.np.array(w), no_bias=True,
                                       num_hidden=6)]
    ref, got = both(run)
    for r, g in zip(ref, got):
        assert isinstance(g, tmx.np.ndarray)
        np.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=1e-5,
                                   atol=1e-6)
    assert "relu" in dir(tmx.npx) and "set_np" in dir(tmx.npx)
    with pytest.raises(AttributeError):
        tmx.npx.not_an_op
    with tmx.npx.np_array():
        assert tmx.npx.is_np_array()
    assert not tmx.npx.is_np_array()


def test_creation_defaults():
    with tmx.cpu():
        assert tmx.np.array(np.ones(2)).dtype == torch.float32
        assert tmx.np.array(np.ones(2, np.int32)).dtype == torch.int32
        assert tmx.np.array([1.5, 2]).dtype == torch.float32
        assert tmx.np.arange(5).dtype == torch.int64
        assert tmx.np.zeros(3).dtype == torch.float32
        b = tmx.np.array(np.ones(2), dtype="bfloat16")
        assert b.dtype == torch.bfloat16 and \
            tmx.np.array(b).dtype == torch.bfloat16
        assert tmx.np.float32 == torch.float32
        assert tmx.np.zeros(2, dtype=tmx.np.bfloat16).dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmx.np.zeros(2)
