"""mxtpu_torch — the PyTorch/CUDA port of ``mxtpu`` for NVIDIA Hopper.

The JAX package ``mxtpu`` is the reference; this package mirrors its
module names (``context``, ``ops.attention``, ``models.llama``) so a
reader finds each counterpart. Plain tensor code is PyTorch; every
kernel ``mxtpu`` wrote in Pallas becomes a hand-written CUDA C++ kernel
for ``sm_90a`` under ``ops/csrc/``, built at first use.

This package imports ``torch`` and numpy only — never ``jax`` and
nothing of ``mxtpu`` (whose ``__init__`` imports jax). Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
from . import context
from .context import cpu, gpu, default_device

__all__ = ["context", "cpu", "gpu", "default_device"]
