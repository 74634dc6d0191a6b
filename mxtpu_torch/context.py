"""Device contexts: ``mx.cpu()``, ``mx.gpu()``, ``mx.tpu()`` and the
``with ctx:`` scope — the port of ``mxtpu/context.py``.

A :class:`Context` names a device as MXNet does (``device_type``,
``device_id``; ``cpu_pinned`` and ``cpu_shared`` are the CPU, ``gpu``
and ``tpu`` are the card). ``torch.device`` cannot be subclassed, so a
Context is a ``str`` holding its torch device string (``"cpu"``,
``"cuda:0"``): every torch call that takes a device takes a Context as
it is, and ``==``/``hash`` are those of the ``torch.device`` it
resolves to, so ``ctx == torch.device("cuda", 0)`` holds both ways.
``NDArray.context`` stays a ``torch.device``.

``None`` resolves to the innermost ``with ctx:`` scope of this thread
and, outside any scope, to :func:`default_device`. Unlike ``mxtpu``'s
default, which falls back to the CPU when no accelerator is visible,
:func:`default_device` raises: a run that meant to use the card never
lands on the CPU quietly.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_gpus",
           "num_tpus", "default_device", "resolve_device"]

_TYPES = ("cpu", "gpu", "tpu", "cpu_pinned", "cpu_shared")


class Context(str):
    """A device as MXNet names it; the string is its torch device."""

    _scope = threading.local()

    def __new__(cls, device_type: Union[str, "Context"] = "cpu",
                device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in _TYPES:
            raise ValueError(f"unknown device type {device_type!r}")
        if device_type in ("cpu_pinned", "cpu_shared"):
            device_type = "cpu"
        dev = "cpu" if device_type == "cpu" else f"cuda:{int(device_id)}"
        self = super().__new__(cls, dev)
        self.device_type = device_type
        self.device_id = int(device_id)
        return self

    @property
    def device(self) -> torch.device:
        return torch.device(str.__str__(self))

    @property
    def type(self) -> str:                # torch.device's reading
        return "cpu" if self.device_type == "cpu" else "cuda"

    @property
    def index(self) -> Optional[int]:
        return None if self.device_type == "cpu" else self.device_id

    def __eq__(self, other):
        dev = _as_device(other)
        return dev is not None and dev == self.device

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self.device)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __reduce__(self):
        return (Context, (self.device_type, self.device_id))

    def __enter__(self):
        stack = getattr(Context._scope, "stack", None)
        if stack is None:
            stack = Context._scope.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._scope.stack.pop()

    @classmethod
    def default(cls) -> "Context":
        """The innermost ``with`` scope's context, else the card (raises
        when none is visible)."""
        stack = getattr(cls._scope, "stack", None)
        if stack:
            return stack[-1]
        default_device()
        return cls("gpu", 0)


def _as_device(x) -> Optional[torch.device]:
    if isinstance(x, Context):
        return x.device
    if isinstance(x, torch.device):
        return x
    if isinstance(x, str):
        try:
            return torch.device(x)
        except RuntimeError:
            return None
    return None


DeviceLike = Union[str, torch.device, Context, None]


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The reference's accelerator context; here the card."""
    return Context("tpu", device_id)


def current_context() -> Context:
    return Context.default()


def num_gpus() -> int:
    return torch.cuda.device_count()


num_tpus = num_gpus


def default_device() -> torch.device:
    """``cuda:0``; raises when no CUDA card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible; pass device='cpu' (ctx=mx.cpu()) or "
            "enter `with mx.cpu():` to run on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the innermost ``with`` scope's device, else
    :func:`default_device`; anything else → ``torch.device``."""
    if device is None:
        stack = getattr(Context._scope, "stack", None)
        return stack[-1].device if stack else default_device()
    if isinstance(device, Context):
        return device.device
    return torch.device(device)
