"""Checkpoint helpers — the port of ``mxtpu/model.py`` (reference
``python/mxnet/model.py``).

The Module-era checkpoint layout: ``prefix-symbol.json`` (the graph's
JSON) and ``prefix-%04d.params`` (the NDArray container, names prefixed
``arg:``/``aux:``). Both files are the reference's bytes for the same
graph and values, so checkpoints cross between the packages.
"""
from __future__ import annotations

from typing import Dict, Tuple

from . import ndarray as nd

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "split_arg_aux"]


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params: Dict,
                    aux_params: Dict) -> None:
    """Save symbol + params (reference ``mx.model.save_checkpoint``)."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    data = {f"arg:{k}": v for k, v in arg_params.items()}
    data.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(f"{prefix}-{epoch:04d}.params", data)


def split_arg_aux(loaded: Dict) -> Tuple[Dict, Dict]:
    """Split an ``arg:``/``aux:``-prefixed name→array dict; names without
    a prefix count as args (the one parser of the container's naming:
    ``SymbolBlock.imports`` and ``Block.load_parameters`` use it too)."""
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_params(prefix: str, epoch: int, ctx=None) -> Tuple[Dict, Dict]:
    """The (arg_params, aux_params) of ``prefix-%04d.params`` on ``ctx``
    (None: the card)."""
    return split_arg_aux(nd.load(f"{prefix}-{epoch:04d}.params", ctx))


def load_checkpoint(prefix: str, epoch: int, ctx=None):
    """Returns (symbol, arg_params, aux_params), the params on ``ctx``
    (None: the card) — reference ``mx.model.load_checkpoint``."""
    from . import symbol as sym
    symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch, ctx)
    return symbol, arg_params, aux_params
