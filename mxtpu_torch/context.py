"""Device contexts — the device half of ``mxtpu/context.py``.

``mxtpu`` wraps jax devices in a ``Context``; here a context is a plain
``torch.device``. Unlike ``mxtpu``'s default, which falls back to the
CPU when no accelerator is visible, :func:`default_device` raises: a
run that meant to use the card never lands on the CPU quietly.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["cpu", "gpu", "default_device", "resolve_device"]

DeviceLike = Union[str, torch.device, None]


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", device_id)


def default_device() -> torch.device:
    """``cuda:0``; raises when no CUDA card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible; pass device='cpu' to run on the CPU")
    return gpu(0)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → :func:`default_device`; anything else → ``torch.device``."""
    return default_device() if device is None else torch.device(device)
