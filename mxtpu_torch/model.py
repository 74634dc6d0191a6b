"""The checkpoint-name parser of ``mxtpu/model.py``: ``split_arg_aux``,
which ``gluon.Block.load_parameters`` uses to read ``.params`` files
whose names carry the reference's ``arg:``/``aux:`` prefixes.

The rest of that module (``save_checkpoint``/``load_checkpoint`` with
their symbol JSON) belongs to the Symbol frontend, ROADMAP Queue A item
10.4, and raises until then.
"""
from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["split_arg_aux", "save_checkpoint", "load_checkpoint",
           "load_params"]

_SYMBOL_SLICE = ("the Module-era checkpoint (prefix-symbol.json) comes with "
                 "the Symbol frontend, ROADMAP Queue A item 10.4")


def split_arg_aux(loaded: Dict) -> Tuple[Dict, Dict]:
    """Split an ``arg:``/``aux:``-prefixed name→array dict; names without
    a prefix count as args."""
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def save_checkpoint(*args, **kwargs):
    raise NotImplementedError(_SYMBOL_SLICE)


def load_checkpoint(*args, **kwargs):
    raise NotImplementedError(_SYMBOL_SLICE)


def load_params(*args, **kwargs):
    raise NotImplementedError(_SYMBOL_SLICE)
