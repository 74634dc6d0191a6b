"""Gluon — the imperative/hybrid neural-network API, the port of
``mxtpu/gluon`` (reference ``python/mxnet/gluon/``): Block and
HybridBlock (``hybridize`` as a tape node under ``record()`` and a CUDA
graph in predict mode), Parameter, ``nn``, ``loss``, ``Trainer``,
``utils`` and ``model_zoo`` (``GluonLlama`` and the ResNets).

``data``, ``rnn`` and ``contrib`` come with ROADMAP Queue A item 10.3b
and raise here.
"""
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from . import nn
from . import loss
from . import utils
from .utils import split_and_load

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Trainer", "nn", "loss", "utils",
           "split_and_load", "model_zoo"]

LATER_SLICE = "comes with ROADMAP Queue A item 10.3b"


def __getattr__(name):
    if name == "model_zoo":
        import importlib
        mod = importlib.import_module("mxtpu_torch.gluon.model_zoo")
        globals()[name] = mod
        return mod
    if name in ("data", "rnn", "contrib"):
        raise AttributeError(f"gluon.{name} {LATER_SLICE}")
    raise AttributeError(
        f"module 'mxtpu_torch.gluon' has no attribute {name!r}")
