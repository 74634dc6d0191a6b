"""mx.sym — the symbolic graph API, the port of ``mxtpu/symbol/``
(reference ``python/mxnet/symbol/``).

Every op of the port's ``OP_REGISTRY`` (``mxtpu_torch/ndarray/ops.py``)
is available here as a graph-composing function, as the reference's
code-generated ``mx.sym.*`` wrappers are; ``Custom`` and the int8 ops
of ``contrib.quantization`` among them (their modules register them,
and are imported here so a graph can name them).
"""
from .. import operator as _operator  # noqa: F401  (registers Custom)
from ..contrib import quantization as _quantization  # noqa: F401
from ..ndarray import ops as _ops
from .symbol import (Symbol, var, Variable, Group, load, load_json,
                     Executor, make_symbol_function)

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "Executor", "zeros", "ones"]


def __getattr__(name):
    if name in _ops.OP_REGISTRY:
        fn = make_symbol_function(name)
        globals()[name] = fn
        return fn
    raise AttributeError(
        f"module 'mxtpu_torch.symbol' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_ops.OP_REGISTRY)))


def _full(shape, val, dtype, **kwargs):
    if isinstance(shape, int):
        shape = (shape,)
    return __getattr__("full")(shape=tuple(shape), val=val, dtype=dtype,
                               **kwargs)


def zeros(shape, dtype="float32", **kwargs):
    """Constant-zero symbol (reference ``mx.sym.zeros``)."""
    return _full(shape, 0.0, dtype, **kwargs)


def ones(shape, dtype="float32", **kwargs):
    return _full(shape, 1.0, dtype, **kwargs)
