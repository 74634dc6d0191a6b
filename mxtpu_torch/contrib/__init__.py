"""mxtpu_torch.contrib — the port of ``mxtpu.contrib``: the control-flow
ops (``foreach``, ``while_loop``, ``cond``) and the contrib op set of
``mx.nd.contrib``, ``chaos`` (the serving tier's fault injection),
``amp``, ``quantization`` (int8), ``onnx``, ``text``, ``summary`` (and
``tensorboard``, its alias), ``deploy`` and ``analysis`` (mxlint),
each loaded on first use as the reference's are.
"""
from ..ndarray.contrib import foreach, while_loop, cond
from ..ndarray.contrib_ops import *   # noqa: F401,F403
from . import chaos

__all__ = ["foreach", "while_loop", "cond", "amp", "chaos", "quantization"]

_LAZY = {"amp": "mxtpu_torch.amp",
         "quantization": "mxtpu_torch.contrib.quantization",
         "text": "mxtpu_torch.contrib.text",
         "summary": "mxtpu_torch.contrib.summary",
         "tensorboard": "mxtpu_torch.contrib.summary",
         "deploy": "mxtpu_torch.contrib.deploy",
         "onnx": "mxtpu_torch.contrib.onnx",
         "analysis": "mxtpu_torch.contrib.analysis"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(_LAZY[name])
    raise AttributeError(
        f"module 'mxtpu_torch.contrib' has no attribute {name!r}")
