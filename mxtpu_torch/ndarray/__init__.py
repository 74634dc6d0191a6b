"""``mx.nd`` — the imperative NDArray API: the port of ``mxtpu/ndarray``.

This slice holds the NDArray class, its constructors, the tape funnel
and ``save``/``load`` (``ndarray.py``), and ``mx.nd.random``
(``random.py``). The op namespace (``mx.nd.relu``, ``mx.nd.dot``, ...)
comes with the op registry; until then every other name raises
``AttributeError`` saying which slice brings it.
"""
from .ndarray import (NDArray, array, empty, zeros, ones, full, arange,
                      concat, stack, waitall, save, load, OPS_SLICE)
from . import random

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concat", "stack", "waitall", "save", "load", "random"]

_OTHER_SLICES = {
    "sparse": "mx.nd.sparse comes with the sparse slice, ROADMAP Queue A "
              "item 10.4",
    "contrib": "mx.nd.contrib comes with ROADMAP Queue A item 10.4",
    "Custom": "mx.nd.Custom (the mx.operator registry) comes with ROADMAP "
              "Queue A item 10.4",
}


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise AttributeError(
        f"module 'mxtpu_torch.ndarray' has no attribute {name!r}: "
        f"{_OTHER_SLICES.get(name, OPS_SLICE)}")
