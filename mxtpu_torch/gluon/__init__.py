"""Gluon — the imperative/hybrid neural-network API, the port of
``mxtpu/gluon`` (reference ``python/mxnet/gluon/``): Block and
HybridBlock (``hybridize`` as a tape node under ``record()`` and a CUDA
graph in predict mode; ``shard`` on a one-device mesh), Parameter,
``nn``, ``rnn``, ``loss``, ``Trainer`` (with AMP and
``make_fused_step``, the one-program train step of ``fused``),
``data``, ``contrib``, ``utils`` and ``model_zoo`` (``GluonLlama`` and
the vision nets).
"""
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from . import nn
from . import rnn
from . import loss
from . import utils
from .utils import split_and_load

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Trainer", "nn", "rnn", "loss",
           "utils", "split_and_load", "data", "contrib", "model_zoo"]

# the heavier subpackages load on first use
_LAZY = ("data", "contrib", "model_zoo")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"mxtpu_torch.gluon.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'mxtpu_torch.gluon' has no attribute {name!r}")
