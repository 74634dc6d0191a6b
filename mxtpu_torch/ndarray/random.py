"""``mx.random`` / ``mx.nd.random`` — the port of ``mxtpu/ndarray/random.py``.

MXNet's stateful-seed API over the Threefry key chain of
:mod:`mxtpu_torch.prng`: ``seed(n)`` makes the key ``PRNGKey(n)`` and
every draw splits it (``key, sub = split(key)``) and draws from ``sub``,
as the reference does with ``jax.random``, so the same seed gives the
same numbers in both packages (``tests/test_torch_random.py`` holds the
tolerances).

The key is one per thread and lives on the host: splitting it costs
the card nothing and waits for nothing, and the chain is the same
whichever device a draw lands on. Each draw copies its 16-byte subkey
to ``ctx`` and draws there; ``ctx=None`` is the card (it raises without
one), as everywhere in the port.

The reference runs with jax's 64-bit mode on, where a draw with no
dtype is float64 inside: ``gamma`` and ``exponential`` draw float64,
``bernoulli`` compares a float64 uniform with its Python ``p``,
``poisson`` draws float32 uniforms (jax casts ``lam``) into int64
counts, and ``uniform`` and ``normal`` draw float32. The port draws in
the same dtypes and casts to ``dtype`` at the end.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import prng, xla_math
from ..base import dtype_torch
from ..context import DeviceLike, resolve_device
from .ndarray import NDArray

__all__ = ["seed", "uniform", "normal", "randn", "randint", "gamma",
           "exponential", "poisson", "multinomial", "bernoulli", "shuffle",
           "current_key"]

_state = threading.local()


def _key_state():
    if not hasattr(_state, "key"):
        _state.key = prng.PRNGKey(time.time_ns() % (2 ** 31), device="cpu")
    return _state


def seed(seed_state: int, ctx="all") -> None:
    """Seed this thread's generator (reference ``mx.random.seed``); one
    chain serves every device, so ``ctx`` changes nothing."""
    _key_state().key = prng.PRNGKey(int(seed_state), device="cpu")


def _next_key(device: torch.device) -> torch.Tensor:
    st = _key_state()
    trace = getattr(st, "trace_keys", None)
    if trace:
        # inside a traced step: split functionally from the step's key
        trace[-1], sub = prng.split(trace[-1])
        return sub.to(device)
    st.key, sub = prng.split(st.key)
    return sub.to(device)


def push_trace_key(key: torch.Tensor) -> None:
    """Enter traced-RNG mode: draws split from ``key`` (a step's key)
    instead of the thread's stateful one."""
    st = _key_state()
    if not hasattr(st, "trace_keys"):
        st.trace_keys = []
    st.trace_keys.append(key)


def pop_trace_key() -> torch.Tensor:
    return _key_state().trace_keys.pop()


def current_key() -> torch.Tensor:
    """The thread's key (a host tensor), for steps that thread keys
    functionally."""
    return _key_state().key


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _data(x):
    return x._data if isinstance(x, NDArray) else x


def _draw_device(ctx: DeviceLike, out: Optional[NDArray] = None):
    if out is not None:
        return out._data.device
    return resolve_device(ctx)


def _finish(val: torch.Tensor, out: Optional[NDArray]) -> NDArray:
    if out is not None:
        out._set_data(val)
        return out
    return NDArray(val)


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kw) -> NDArray:
    dev = _draw_device(ctx, out)
    val = prng.uniform(_next_key(dev), _shape(shape), torch.float32,
                       low, high)
    return _finish(val.to(dtype_torch(dtype)), out)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kw) -> NDArray:
    dev = _draw_device(ctx, out)
    val = prng.normal(_next_key(dev), _shape(shape), torch.float32)
    return _finish((val * scale + loc).to(dtype_torch(dtype)), out)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, **kw) -> NDArray:
    return normal(loc, scale, shape, dtype, ctx)


def randint(low, high=None, shape=None, dtype="int32", ctx=None,
            **kw) -> NDArray:
    if high is None:
        low, high = 0, low
    dev = _draw_device(ctx)
    return NDArray(prng.randint(_next_key(dev), _shape(shape), low, high,
                                dtype_torch(dtype)))


def _param(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A parameter (a number, an NDArray or a tensor) on ``dev`` in
    ``dtype``; a Python number is rounded once, to ``dtype``."""
    x = _data(x)
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return torch.as_tensor(x, dtype=dtype, device=dev)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None,
          **kw) -> NDArray:
    dev = _draw_device(ctx)
    a = _param(alpha, dev, torch.float64)
    val = prng.gamma(_next_key(dev), a, _shape(shape) or tuple(a.shape),
                     torch.float64)
    val = val * _param(beta, dev, torch.float64)
    return NDArray(val.to(dtype_torch(dtype)))


def exponential(scale=1.0, shape=None, dtype=None, ctx=None,
                **kw) -> NDArray:
    dev = _draw_device(ctx)
    val = prng.exponential(_next_key(dev), _shape(shape), torch.float64)
    return NDArray((val * scale).to(dtype_torch(dtype)))


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, **kw) -> NDArray:
    dev = _draw_device(ctx)
    lam = _param(lam, dev, torch.float64)
    val = prng.poisson(_next_key(dev), lam, _shape(shape) or None)
    return NDArray(val.to(dtype_torch(dtype)))


def bernoulli(p=0.5, shape=None, dtype=None, ctx=None, **kw) -> NDArray:
    dev = _draw_device(ctx)
    p = _data(p)
    p = p.to(dev) if isinstance(p, torch.Tensor) else \
        torch.tensor(float(p), dtype=torch.float64, device=dev)
    shape = _shape(shape) if shape is not None else None
    val = prng.bernoulli(_next_key(dev), p, shape)
    return NDArray(val.to(dtype_torch(dtype)))


def multinomial(data, shape=None, get_prob=False, dtype="int32",
                **kw):
    """Sample from categorical distribution(s) over the last axis of
    ``data`` (probabilities); MXNet's (batch..., n) layout for batched
    inputs. With ``get_prob``, also the log-probability of each draw."""
    probs = _data(data)
    if not isinstance(probs, torch.Tensor):    # numpy's dtype, as jnp's
        probs = torch.as_tensor(np.asarray(probs),
                                device=resolve_device(None))
    logp = xla_math.log(torch.clamp_min(probs, 1e-30))
    n, batch = _shape(shape), tuple(probs.shape[:-1])
    key = _next_key(probs.device)
    if not batch:
        samp = prng.categorical(key, logp, shape=n)
    else:
        # jax puts the sample dims first; MXNet wants them last
        samp = prng.categorical(key, logp, axis=-1,
                                shape=n + batch if n else None)
        if n:
            samp = samp.permute(tuple(range(len(n), len(n) + len(batch)))
                                + tuple(range(len(n))))
    out = NDArray(samp.to(dtype_torch(dtype)))
    if not get_prob:
        return out
    idx = samp.to(torch.int64)
    if not batch:
        lp = logp[idx]
    else:
        src = logp.reshape(batch + (1,) * (idx.ndim - len(batch))
                           + (probs.shape[-1],))
        lp = torch.gather(src.expand(idx.shape + (probs.shape[-1],)), -1,
                          idx[..., None])[..., 0]
    return out, NDArray(lp)


def shuffle(data, **kw) -> NDArray:
    """``data`` shuffled along its first axis."""
    x = _data(data)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(None))
    return NDArray(prng.permutation(_next_key(x.device), x, axis=0))
