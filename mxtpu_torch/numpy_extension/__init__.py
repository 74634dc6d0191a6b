"""``mx.npx`` — the port of ``mxtpu/numpy_extension``: the np-mode
switches and the ``np_array`` scope, and every op of the registry
(``mx.nd``'s ``OP_REGISTRY``: relu, softmax, batch_norm, convolution,
...) with ``mx.np`` array results. As in the reference, ``set_np``
changes no Gluon behaviour.
"""
from __future__ import annotations

from ..ndarray import ops as _ops
from ..ndarray.ndarray import NDArray
from ..numpy import ndarray as np_ndarray, from_nd

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape",
           "use_np_array", "np_array"]

_NP_ARRAY = False


def set_np(shape=True, array=True, dtype=False):
    """Turn on NumPy semantics (reference ``mx.npx.set_np``). NumPy's
    shapes are torch's own, so only the array flag is kept."""
    global _NP_ARRAY
    _NP_ARRAY = bool(array)


def reset_np():
    set_np(array=False)


def is_np_array() -> bool:
    return _NP_ARRAY


def is_np_shape() -> bool:
    return True


class np_array:
    """Scope (or decorator) with np-array mode on."""

    def __init__(self, active=True):
        self._active = active
        self._prev = None

    def __enter__(self):
        global _NP_ARRAY
        self._prev = _NP_ARRAY
        _NP_ARRAY = self._active
        return self

    def __exit__(self, *exc):
        global _NP_ARRAY
        _NP_ARRAY = self._prev


use_np_array = np_array


def _to_np(out):
    if isinstance(out, tuple):
        return tuple(_to_np(o) for o in out)
    if isinstance(out, list):
        return [_to_np(o) for o in out]
    if isinstance(out, NDArray) and not isinstance(out, np_ndarray):
        return from_nd(out)
    return out


def __getattr__(name):
    fn = _ops.OP_REGISTRY.get(name)
    if fn is None:
        raise AttributeError(f"module 'mxtpu_torch.numpy_extension' has no "
                             f"attribute {name!r}")

    def npx_fn(*args, **kwargs):
        return _to_np(fn(*args, **kwargs))

    npx_fn.__name__ = name
    globals()[name] = npx_fn
    return npx_fn


def __dir__():
    return sorted(set(list(globals()) + list(_ops.OP_REGISTRY)))
