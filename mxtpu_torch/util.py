"""``mx.util``: the np-mode switches and decorators and small helpers —
the port of ``mxtpu/util.py``.

``get_gpu_memory(i)`` returns upstream MXNet's ``(free, total)`` bytes
of card ``i`` from ``torch.cuda.mem_get_info``; the reference raises
there because a TPU has no such query.
"""
from __future__ import annotations

import contextlib
import functools
import os

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape",
           "use_np", "use_np_array", "use_np_shape", "np_array", "np_shape",
           "makedirs", "get_gpu_count", "get_gpu_memory"]


def set_np(shape=True, array=True, dtype=False):
    from . import numpy_extension as npx
    npx.set_np(shape=shape, array=array, dtype=dtype)


def reset_np():
    from . import numpy_extension as npx
    npx.reset_np()


def is_np_array() -> bool:
    from . import numpy_extension as npx
    return npx.is_np_array()


def is_np_shape() -> bool:
    return True


def use_np_array(func):
    """Decorator running ``func`` in np-array mode (reference
    ``mx.util.use_np_array``)."""
    from . import numpy_extension as npx

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with npx.np_array(True):
            return func(*args, **kwargs)
    return wrapper


def use_np_shape(func):
    # NumPy's shape semantics are torch's own: nothing to switch
    return func


def use_np(func):
    return use_np_array(use_np_shape(func))


def np_shape(active=True):
    return contextlib.nullcontext()


def np_array(active=True):
    from . import numpy_extension as npx
    return npx.np_array(active)


def makedirs(d):
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def get_gpu_count() -> int:
    from .context import num_gpus
    return num_gpus()


def get_gpu_memory(gpu_dev_id: int = 0):
    """``(free, total)`` bytes of card ``gpu_dev_id`` (upstream MXNet's
    ``mx.context.gpu_memory_info``)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible: no card memory to "
                           "query")
    return tuple(torch.cuda.mem_get_info(gpu_dev_id))
