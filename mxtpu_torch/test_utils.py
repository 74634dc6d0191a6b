"""Testing utilities — the port of ``mxtpu/test_utils.py``.

NumPy ground truth (``assert_almost_equal``), finite differences against
the tape (``check_numeric_gradient``, in float64), the CPU against the
card (``check_consistency``: ``[mx.cpu()]`` and, where a card is
visible, ``mx.gpu()``; integer and bool outputs must be equal, floats
within the tolerance), and the seeding decorator (``with_seed``: numpy,
``random`` and ``mx.random``, the seed logged on a failure).
"""
from __future__ import annotations

import functools
import logging
import random as _pyrandom
from typing import Callable, List, Optional, Sequence

import numpy as _np

from . import context as _ctx
from .base import env_int, env_str
from .ndarray.ndarray import NDArray, array

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "same", "rand_ndarray", "random_arrays",
           "check_numeric_gradient", "check_consistency", "with_seed",
           "default_rtol_atol"]

_default_ctx: Optional[_ctx.Context] = None


def default_context() -> _ctx.Context:
    """``MXNET_TEST_DEVICE`` ('cpu', 'gpu') when set, else the current
    context (the card outside a ``with`` scope)."""
    if _default_ctx is not None:
        return _default_ctx
    dev = env_str("MXNET_TEST_DEVICE", "")
    if dev:
        return _ctx.Context(dev, 0)
    return _ctx.current_context()


def set_default_context(ctx: _ctx.Context) -> None:
    global _default_ctx
    _default_ctx = ctx


def default_rtol_atol(dtype) -> tuple:
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    return {"float16": (1e-2, 1e-2), "bfloat16": (3e-2, 3e-2),
            "float32": (1e-4, 1e-5), "float64": (1e-6, 1e-8)}.get(
        name, (1e-4, 1e-5))


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def same(a, b) -> bool:
    return _np.array_equal(_to_np(a), _to_np(b))


def almost_equal(a, b, rtol=None, atol=None) -> bool:
    a, b = _to_np(a), _to_np(b)
    rtol = rtol if rtol is not None else 1e-4
    atol = atol if atol is not None else 1e-5
    return _np.allclose(a.astype(_np.float64), b.astype(_np.float64),
                        rtol=rtol, atol=atol, equal_nan=True)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")) -> None:
    an, bn = _to_np(a), _to_np(b)
    if rtol is None or atol is None:
        drt, dat = default_rtol_atol(an.dtype)
        rtol = rtol if rtol is not None else drt
        atol = atol if atol is not None else dat
    _np.testing.assert_allclose(
        an.astype(_np.float64), bn.astype(_np.float64),
        rtol=rtol, atol=atol, equal_nan=True,
        err_msg=f"{names[0]} vs {names[1]}")


def random_arrays(*shapes, dtype=_np.float32) -> List[_np.ndarray]:
    return [_np.random.randn(*s).astype(dtype) if s else
            _np.asarray(_np.random.randn(), dtype) for s in shapes]


def rand_ndarray(shape, ctx=None, dtype="float32") -> NDArray:
    return array(_np.random.randn(*shape), ctx=ctx, dtype=dtype)


def check_numeric_gradient(f: Callable, inputs: Sequence,
                           eps: float = 1e-3, rtol: float = 1e-2,
                           atol: float = 1e-3, ctx=None) -> None:
    """Central differences against the tape's gradient of the scalar
    ``f(*inputs)``, every floating input in float64 (``ctx`` None: the
    current context)."""
    from . import autograd
    inputs = [x if isinstance(x, NDArray) else array(x, ctx=ctx)
              for x in inputs]
    inputs = [x.astype("float64") if x._data.is_floating_point() else x
              for x in inputs]
    for x in inputs:
        x.attach_grad()
    with autograd.record():
        loss = f(*inputs)
    loss.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]

    def _eval(xi, host):
        args = [array(host.copy(), ctx=inputs[xi].context, dtype="float64")
                if j == xi else inputs[j] for j in range(len(inputs))]
        return float(f(*args).asnumpy())

    for xi, x in enumerate(inputs):
        if not x._data.is_floating_point():
            continue
        host = _np.array(x.asnumpy(), dtype=_np.float64, order="C")
        numeric = _np.zeros_like(host)
        flat, num_flat = host.reshape(-1), numeric.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            fp = _eval(xi, host)
            flat[i] = orig - eps
            fm = _eval(xi, host)
            flat[i] = orig
            num_flat[i] = (fp - fm) / (2 * eps)
        _np.testing.assert_allclose(analytic[xi], numeric, rtol=rtol,
                                    atol=atol,
                                    err_msg=f"gradient of input {xi}")


def check_consistency(f: Callable, inputs_np=None,
                      ctx_list: Optional[Sequence] = None,
                      rtol=None, atol=None, inputs=None,
                      array_fn=None) -> list:
    """Run ``f`` on each context of ``ctx_list`` (default: the CPU, and
    the card when one is visible) and hold every output to the first
    context's: integer and bool outputs equal, floating ones within
    ``rtol``/``atol`` (default: ten times ``default_rtol_atol``).
    ``array_fn(x, ctx)`` makes the inputs (default ``mx.nd.array``);
    returns the host outputs of each context."""
    if inputs_np is None:
        inputs_np = inputs
    if inputs_np is None:
        raise ValueError("check_consistency needs input numpy arrays")
    if ctx_list is None:
        ctx_list = [_ctx.cpu(0)]
        if _ctx.num_gpus() > 0:
            ctx_list.append(_ctx.gpu(0))
    make = array_fn or (lambda x, ctx: array(x, ctx=ctx, dtype=x.dtype
                                             if isinstance(x, _np.ndarray)
                                             else None))
    results = []
    for ctx in ctx_list:
        ins = [make(x, ctx) for x in inputs_np]
        out = f(*ins)
        outs = out if isinstance(out, (list, tuple)) else [out]
        results.append([o.asnumpy() if isinstance(o, NDArray)
                        else _np.asarray(o) for o in outs])
    ref = results[0]
    for ctx, res in zip(ctx_list[1:], results[1:]):
        for i, (r, o) in enumerate(zip(ref, res)):
            where = f"output {i} on {ctx} vs {ctx_list[0]}"
            assert o.shape == r.shape and o.dtype == r.dtype, \
                (where, o.shape, o.dtype, r.shape, r.dtype)
            if r.dtype.kind in "biu":
                _np.testing.assert_array_equal(o, r, err_msg=where)
                continue
            rt, at = default_rtol_atol(r.dtype)
            _np.testing.assert_allclose(
                o, r, rtol=rt * 10 if rtol is None else rtol,
                atol=at * 10 if atol is None else atol, equal_nan=True,
                err_msg=where)
    return results


def with_seed(seed: Optional[int] = None):
    """Per-test seeding decorator that logs the seed on a failure
    (``MXNET_TEST_SEED`` reproduces it)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from .ndarray import random as mxrandom
            env_seed = env_int("MXNET_TEST_SEED", -1)
            this_seed = seed if seed is not None else (
                env_seed if env_seed != -1 else
                _np.random.randint(0, 2 ** 31))
            _np.random.seed(this_seed)
            _pyrandom.seed(this_seed)
            mxrandom.seed(this_seed)
            try:
                return fn(*args, **kwargs)
            except Exception:
                logging.error("test failed with MXNET_TEST_SEED=%d "
                              "(set it to reproduce)", this_seed)
                raise
        return wrapper
    return deco
