"""``mx.nd`` — the imperative NDArray API: the port of ``mxtpu/ndarray``.

The NDArray class, its constructors, the tape funnel and
``save``/``load`` (``ndarray.py``), the registered op namespace
(``ops.py``: ``mx.nd.relu``, ``mx.nd.dot``, ``mx.nd.Convolution``, ...,
with the contrib ops of ``contrib_ops.py``: ``mx.nd.box_nms``,
``mx.nd._contrib_MultiBoxPrior``, ...), ``mx.nd.random``
(``random.py``) and ``mx.nd.contrib`` (``contrib.py``: ``foreach``,
``while_loop``, ``cond`` and the contrib ops). The reference's other op
names and submodules raise ``AttributeError`` saying which ROADMAP item
brings them.
"""
from .ndarray import (NDArray, array, empty, zeros, ones, full, arange,
                      concat, stack, waitall, save, load)
from . import contrib_ops  # noqa: F401  (registers the contrib ops)
from .ops import *  # noqa: F401,F403  — registered op namespace
from .ops import OP_REGISTRY, register_op
from .ops import __all__ as _ops_all
from .ops_extended import LATER, LATER_SLICE
from . import random

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concat", "stack", "waitall", "save", "load", "random"] + \
    [n for n in _ops_all if n not in ("full", "concat", "stack")]

_OTHER_SLICES = {
    "sparse": "mx.nd.sparse comes with the sparse slice, ROADMAP Queue A "
              "item 10.4",
    "Custom": "mx.nd.Custom (the mx.operator registry) comes with ROADMAP "
              "Queue A item 10.4",
}


def __getattr__(name):
    if name == "contrib":
        import importlib
        m = importlib.import_module("mxtpu_torch.ndarray.contrib")
        globals()["contrib"] = m
        return m
    if name in _OTHER_SLICES:
        raise AttributeError(_OTHER_SLICES[name])
    if name in LATER:
        raise AttributeError(f"mx.nd.{name} {LATER_SLICE}")
    raise AttributeError(
        f"module 'mxtpu_torch.ndarray' has no attribute {name!r}")
