"""mxtpu_torch.contrib — the port of ``mxtpu.contrib``: the control-flow
ops (``foreach``, ``while_loop``, ``cond``) and the contrib op set of
``mx.nd.contrib``, ``chaos`` (the serving tier's fault injection), and
``amp``. The reference's other contrib modules (``quantization``,
``onnx``, ``text``, ``summary``/``tensorboard``, ``deploy``,
``analysis``) come with ROADMAP Queue A item 10.4(d).
"""
from ..ndarray.contrib import foreach, while_loop, cond
from ..ndarray.contrib_ops import *   # noqa: F401,F403
from . import chaos

__all__ = ["foreach", "while_loop", "cond", "amp", "chaos"]

_LATER = ("quantization", "onnx", "text", "summary", "tensorboard",
          "deploy", "analysis")


def __getattr__(name):
    if name == "amp":
        import importlib
        return importlib.import_module("mxtpu_torch.amp")
    if name in _LATER:
        raise AttributeError(f"mxtpu_torch.contrib.{name} comes with "
                             "ROADMAP Queue A item 10.4(d)")
    raise AttributeError(
        f"module 'mxtpu_torch.contrib' has no attribute {name!r}")
