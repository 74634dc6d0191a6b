"""``mx.np.random`` — the port of ``mxtpu/numpy/random.py``: NumPy-style
draws over the port's Threefry key chain (``mxtpu_torch.prng``), key for
key as the reference draws them: ``uniform``, ``normal``, ``randint``,
``gamma`` and ``exponential`` are ``mx.nd.random``'s draws; ``beta``
(one ``split``, two gammas), ``multinomial`` (``categorical`` on
``log p``, then a count), ``choice`` and ``shuffle`` (``permutation``
along axis 0, rebinding) each take one key, as the reference's do.
``ctx=None`` is the current context (the card outside a scope).
"""
from __future__ import annotations

import torch

from .. import prng, xla_math
from ..base import dtype_torch
from ..context import resolve_device
from ..ndarray import random as _rnd
from ..ndarray.ndarray import NDArray
from . import ndarray as np_ndarray

__all__ = ["uniform", "normal", "randint", "rand", "randn", "choice",
           "shuffle", "seed", "beta", "gamma", "exponential", "multinomial"]


def seed(s):
    _rnd.seed(s)


def _np(x):
    return np_ndarray(x._data if isinstance(x, NDArray) else x)


def _size(size):
    return (size,) if isinstance(size, int) else tuple(size or ())


def _tensor(x, dev):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    import numpy as np
    return torch.as_tensor(np.asarray(x), device=dev)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None):
    return _np(_rnd.uniform(low, high, shape=size, dtype=dtype, ctx=ctx))


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    return _np(_rnd.normal(loc, scale, shape=size, dtype=dtype, ctx=ctx))


def randint(low, high=None, size=None, dtype="int64", ctx=None):
    return _np(_rnd.randint(low, high, shape=size, dtype=dtype, ctx=ctx))


def rand(*size):
    return uniform(size=size or None)


def randn(*size):
    return normal(size=size or None)


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None):
    return _np(_rnd.gamma(shape, scale, shape=size, dtype=dtype, ctx=ctx))


def exponential(scale=1.0, size=None, dtype=None, ctx=None):
    return _np(_rnd.exponential(scale, shape=size, dtype=dtype, ctx=ctx))


def beta(a, b, size=None, dtype=None, ctx=None):
    """``ga / (ga + gb)`` of two float64 gammas from one split key, as
    float32 (``dtype`` casts it)."""
    dev = resolve_device(ctx)
    k1, k2 = prng.split(_rnd._next_key(dev))
    size = _size(size)
    ga = prng.gamma(k1, a, shape=size)
    gb = prng.gamma(k2, b, shape=size)
    out = (ga / (ga + gb)).to(torch.float32)
    return np_ndarray(out if dtype is None else out.to(dtype_torch(dtype)))


def multinomial(n, pvals, size=None, ctx=None):
    """Counts of ``n`` categorical draws from ``pvals`` (int64), one row
    for each of ``size``."""
    dev = resolve_device(ctx) if not isinstance(pvals, NDArray) \
        else pvals._data.device
    key = _rnd._next_key(dev)
    size = _size(size)
    pv = _tensor(pvals, dev)
    draws = prng.categorical(key, xla_math.log(pv), shape=size + (n,))
    k = pv.shape[-1]
    rows = draws.reshape(-1, n)
    counts = torch.zeros((rows.shape[0], k), dtype=torch.int64,
                         device=pv.device).scatter_add_(
        1, rows, torch.ones_like(rows))
    return np_ndarray(counts.reshape(size + (k,)) if size
                      else counts[0])


def choice(a, size=None, replace=True, p=None, ctx=None):
    """``size`` draws from ``a`` (an int n for ``arange(n)``) with or
    without replacement, uniform or by ``p`` (``prng.choice``)."""
    dev = next((x._data.device for x in (a, p) if isinstance(x, NDArray)),
               None) or resolve_device(ctx)
    key = _rnd._next_key(dev)
    arr = a if isinstance(a, int) else _tensor(a, dev)
    pv = None if p is None else _tensor(p, dev)
    return np_ndarray(prng.choice(key, arr, _size(size), replace, pv))


def shuffle(x):
    """Shuffle ``x`` along its first axis, in place (rebinding)."""
    if not isinstance(x, NDArray):
        raise TypeError("shuffle expects an mx.np ndarray")
    key = _rnd._next_key(x._data.device)
    x._set_data(prng.permutation(key, x._data, axis=0))
