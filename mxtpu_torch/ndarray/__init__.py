"""``mx.nd`` — the imperative NDArray API: the port of ``mxtpu/ndarray``.

The NDArray class, its constructors, the tape funnel and
``save``/``load`` (``ndarray.py``), the registered op namespace
(``ops.py``: ``mx.nd.relu``, ``mx.nd.dot``, ``mx.nd.Convolution``, ...,
with the contrib ops of ``contrib_ops.py``: ``mx.nd.box_nms``,
``mx.nd._contrib_MultiBoxPrior``, ...), ``mx.nd.random``
(``random.py``) and ``mx.nd.contrib`` (``contrib.py``: ``foreach``,
``while_loop``, ``cond`` and the contrib ops), ``mx.nd.sparse``
(``sparse.py``: CSR and row-sparse arrays) and ``mx.nd.Custom`` (the
``mx.operator`` registry).
"""
from .ndarray import (NDArray, array, empty, zeros, ones, full, arange,
                      concat, stack, waitall, save, load)
from . import contrib_ops  # noqa: F401  (registers the contrib ops)
from .ops import *  # noqa: F401,F403  — registered op namespace
from .ops import OP_REGISTRY, register_op
from .ops import __all__ as _ops_all
from . import random

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concat", "stack", "waitall", "save", "load", "random"] + \
    [n for n in _ops_all if n not in ("full", "concat", "stack")]

_LAZY = {"contrib": "mxtpu_torch.ndarray.contrib",
         "sparse": "mxtpu_torch.ndarray.sparse"}


def __getattr__(name):
    # Custom (the mx.operator registry) and the submodules load on first
    # use, as the reference's do
    if name == "Custom":
        from ..operator import Custom
        return Custom
    if name in _LAZY:
        import importlib
        m = importlib.import_module(_LAZY[name])
        globals()[name] = m
        return m
    if name not in OP_REGISTRY:
        # the int8 ops register when their module is imported
        from ..contrib import quantization  # noqa: F401
        from .. import operator  # noqa: F401
    if name in OP_REGISTRY:
        return OP_REGISTRY[name]
    raise AttributeError(
        f"module 'mxtpu_torch.ndarray' has no attribute {name!r}")
