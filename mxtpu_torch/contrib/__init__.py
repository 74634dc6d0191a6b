"""mxtpu_torch.contrib — the port of ``mxtpu.contrib``: the control-flow
ops (``foreach``, ``while_loop``, ``cond``) and the contrib op set of
``mx.nd.contrib``, ``chaos`` (the serving tier's fault injection),
``amp`` and ``quantization`` (int8). The reference's other contrib
modules (``onnx``, ``text``, ``summary``/``tensorboard``, ``deploy``,
``analysis``) come with ROADMAP Queue A item 10.4(d).
"""
from ..ndarray.contrib import foreach, while_loop, cond
from ..ndarray.contrib_ops import *   # noqa: F401,F403
from . import chaos

__all__ = ["foreach", "while_loop", "cond", "amp", "chaos", "quantization"]

_LAZY = {"amp": "mxtpu_torch.amp",
         "quantization": "mxtpu_torch.contrib.quantization"}
_LATER = ("onnx", "text", "summary", "tensorboard",
          "deploy", "analysis")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(_LAZY[name])
    if name in _LATER:
        raise AttributeError(f"mxtpu_torch.contrib.{name} comes with "
                             "ROADMAP Queue A item 10.4(d)")
    raise AttributeError(
        f"module 'mxtpu_torch.contrib' has no attribute {name!r}")
