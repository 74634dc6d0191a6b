"""mxtpu_torch — the PyTorch/CUDA port of ``mxtpu`` for NVIDIA Hopper.

The JAX package ``mxtpu`` is the reference; this package mirrors its
module names (``context``, ``ndarray``, ``autograd``, ``rtc``,
``ops.attention``, ``models.llama``, ``models.resnet``,
``parallel.step``, ``serve``, ``serve.gateway``, ``contrib.chaos``,
``telemetry``, ``gluon``, ``optimizer``, ``initializer``,
``lr_scheduler``, ``model``, ``amp``, ``parallel.mesh``, ``symbol``,
``module``, ``io``, ``metric``, ``callback``, ``monitor``,
``visualization``) so a reader finds each
counterpart; ``prng`` is the key chain of ``jax.random`` (its float32
roundings of XLA's CPU math in ``xla_math``), ``random`` is
``mx.random``, ``serde`` the ``.params`` container; ``ops.conv``
ports the ResNet shape experiment's conv; ``parallel.optim`` holds the
optax transforms the train step takes, and ``tools`` the scripts that
measure the port. Plain tensor code is PyTorch; every kernel ``mxtpu``
wrote in Pallas becomes a hand-written CUDA C++ kernel for ``sm_90a``
under ``ops/csrc/``, built at first use, and ``mx.rtc`` compiles the
user's own CUDA C at run time.

This package imports ``torch`` and numpy only — never ``jax`` and
nothing of ``mxtpu`` (whose ``__init__`` imports jax). Entry points run
on the card unless the caller passes ``device="cpu"`` (``ctx="cpu"``
in ``mx.nd``).
"""
from . import autograd, context, ndarray, rtc
from .base import MXNetError
from .context import cpu, gpu, default_device
from .ndarray import random

nd = ndarray

__all__ = ["autograd", "context", "ndarray", "nd", "random", "rtc",
           "MXNetError", "cpu", "gpu", "default_device"]

# heavier subsystems load on first use, as the reference's do
_LAZY = {"gluon": "mxtpu_torch.gluon", "optimizer": "mxtpu_torch.optimizer",
         "initializer": "mxtpu_torch.initializer",
         "init": "mxtpu_torch.initializer",
         "lr_scheduler": "mxtpu_torch.lr_scheduler",
         "model": "mxtpu_torch.model", "amp": "mxtpu_torch.amp",
         "sym": "mxtpu_torch.symbol", "symbol": "mxtpu_torch.symbol",
         "mod": "mxtpu_torch.module", "module": "mxtpu_torch.module",
         "io": "mxtpu_torch.io", "metric": "mxtpu_torch.metric",
         "callback": "mxtpu_torch.callback",
         "monitor": "mxtpu_torch.monitor",
         "viz": "mxtpu_torch.visualization",
         "visualization": "mxtpu_torch.visualization"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'mxtpu_torch' has no attribute {name!r}")
