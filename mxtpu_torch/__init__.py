"""mxtpu_torch — the PyTorch/CUDA port of ``mxtpu`` for NVIDIA Hopper.

The JAX package ``mxtpu`` is the reference; this package mirrors its
module names (``context``, ``ndarray``, ``autograd``, ``rtc``,
``ops.attention``, ``models.llama``, ``models.resnet``,
``parallel.step``, ``serve``, ``serve.gateway``, ``contrib.chaos``,
``telemetry``, ``gluon``, ``optimizer``, ``initializer``,
``lr_scheduler``, ``model``, ``amp``, ``parallel.mesh``, ``symbol``,
``module``, ``io``, ``metric``, ``callback``, ``monitor``,
``visualization``, ``recordio``, ``native``, ``image``, ``operator``,
``ndarray.sparse``, ``contrib.quantization``, ``numpy`` (``mx.np``),
``numpy_extension`` (``mx.npx``), ``profiler``, ``engine``,
``runtime``, ``util``, ``test_utils``) so a reader
finds each counterpart, and serves them under the reference's names
(``mxtpu_torch.serve``, ``mxtpu_torch.rnn``, ...); ``prng`` is the
key chain of ``jax.random`` (its float32
roundings of XLA's CPU math in ``xla_math``), ``random`` is
``mx.random``, ``serde`` the ``.params`` container; ``ops.conv``
ports the ResNet shape experiment's conv; ``parallel.optim`` holds the
optax transforms the train step takes, and ``tools`` the scripts that
measure the port. Plain tensor code is PyTorch; every kernel ``mxtpu``
wrote in Pallas becomes a hand-written CUDA C++ kernel for ``sm_90a``
under ``ops/csrc/``, built at first use, and ``mx.rtc`` compiles the
user's own CUDA C at run time; ``csrc/`` holds the native IO library,
host C++ built with g++ at first use (``native``).

This package imports ``torch`` and numpy only — never ``jax`` and
nothing of ``mxtpu`` (whose ``__init__`` imports jax). Entry points run
on the card unless the caller passes ``device="cpu"`` (``ctx="cpu"``
in ``mx.nd``).
"""
from . import base

# Lockset sanitizer (rule MXL203): patch the threading lock factories
# before any class of the port builds a lock, so every lock records its
# real acquisition orders for the check against the static lock graph.
# Loaded by file path: the package route (contrib.analysis) imports back
# through contrib and would be circular this early; registering the
# canonical name makes a later ``from mxtpu_torch.contrib.analysis
# import lockcheck`` resolve to this same instance.
if base.env_bool("MXTPU_ANALYSIS_LOCKCHECK", False,
                 "Record runtime lock-acquisition orders and check them "
                 "against the static lock graph (diagnostic)."):
    import importlib.util as _ilu
    import os as _os
    import sys as _sys
    _lc_spec = _ilu.spec_from_file_location(
        "mxtpu_torch.contrib.analysis.lockcheck",
        _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                      "contrib", "analysis", "lockcheck.py"))
    _lockcheck = _ilu.module_from_spec(_lc_spec)
    _sys.modules[_lc_spec.name] = _lockcheck
    _lc_spec.loader.exec_module(_lockcheck)
    _lockcheck.install()

from . import autograd, context, engine, ndarray, rtc  # noqa: E402
from .base import MXNetError
from .context import (Context, cpu, gpu, tpu, current_context, num_gpus,
                      num_tpus, default_device)
from .ndarray import NDArray, random

nd = ndarray

__all__ = ["autograd", "context", "engine", "ndarray", "nd", "NDArray",
           "random", "rtc", "MXNetError", "Context", "cpu", "gpu", "tpu",
           "current_context", "num_gpus", "num_tpus", "default_device"]

# the NaN sanitizer, on at import as the reference's is
if engine.env_debug_nans():
    engine.set_debug_nans(True)

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
         "visualization": "mxtpu_torch.visualization",
         "serve": "mxtpu_torch.serve", "parallel": "mxtpu_torch.parallel",
         "models": "mxtpu_torch.models", "ops": "mxtpu_torch.ops",
         "contrib": "mxtpu_torch.contrib",
         "checkpoint": "mxtpu_torch.checkpoint",
         "serde": "mxtpu_torch.serde", "rnn": "mxtpu_torch.gluon.rnn",
         "telemetry": "mxtpu_torch.telemetry",
         "image": "mxtpu_torch.image", "recordio": "mxtpu_torch.recordio",
         "native": "mxtpu_torch.native",
         "operator": "mxtpu_torch.operator",
         "np": "mxtpu_torch.numpy", "numpy": "mxtpu_torch.numpy",
         "npx": "mxtpu_torch.numpy_extension",
         "numpy_extension": "mxtpu_torch.numpy_extension",
         "profiler": "mxtpu_torch.profiler", "util": "mxtpu_torch.util",
         "test_utils": "mxtpu_torch.test_utils",
         "runtime": "mxtpu_torch.runtime"}

# the reference's other lazy names, each with the ROADMAP item that
# brings it
_LATER = {"kvstore": "item 11", "kv": "item 11"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        globals()[name] = mod
        return mod
    if name in _LATER:
        raise AttributeError(
            f"mxtpu_torch.{name} comes with ROADMAP Queue A {_LATER[name]}")
    raise AttributeError(f"module 'mxtpu_torch' has no attribute {name!r}")
