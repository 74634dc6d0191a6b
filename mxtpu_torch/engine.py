"""``mx.engine``: the execution engine's knobs and the NaN sanitizer —
the port of ``mxtpu/engine.py``.

The reference's ThreadedEngine bulking (``set_bulk_size``, ``bulk``)
is recorded for API parity; CUDA's stream already queues the ops.
``MXNET_ENGINE_TYPE=NaiveEngine`` (a stream sync after every op) is
read by ``mxtpu_torch.ndarray.ndarray``.

The NaN sanitizer (``set_debug_nans(True)``, ``debug_nans()``, or
``MXTPU_DEBUG_NANS=1`` at import) checks the output of every op that
goes through ``apply_op`` and raises ``FloatingPointError`` naming the
op. A captured program (a hybridized block's CUDA graph, the
Executor's predict graph, ``Trainer.make_fused_step``) cannot be
checked op by op while it is captured: its outputs are checked when it
returns, and on a NaN it is run again eagerly, op by op, so the check
names the op, as the reference re-runs a jitted program. A program
whose re-run would change state (the fused step's update) is named
instead, and the message says why it was not re-run. With the
sanitizer off nothing is checked and the dispatch path is unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Optional

import torch

from .base import env_bool

__all__ = ["bulk", "set_bulk_size", "set_debug_nans", "debug_nans",
           "is_debug_nans"]

_DEBUG_NANS = False
_BULK_SIZE = 15


def env_debug_nans() -> bool:
    return env_bool("MXTPU_DEBUG_NANS", False,
                    "Check every op's output for NaN and name the op "
                    "(FloatingPointError); captured programs are checked "
                    "on return and re-run op by op.")


def is_debug_nans() -> bool:
    return _DEBUG_NANS


def set_debug_nans(enabled: bool) -> bool:
    """Turn the NaN sanitizer on or off; returns the previous setting."""
    global _DEBUG_NANS
    from .ndarray import ndarray as _nd
    prev, _DEBUG_NANS = _DEBUG_NANS, bool(enabled)
    _nd._nan_check = check_op if _DEBUG_NANS else None
    return prev


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Scope with the NaN sanitizer on (or off)."""
    prev = set_debug_nans(enabled)
    try:
        yield
    finally:
        set_debug_nans(prev)


def _tensors(out) -> Iterable[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def has_nan(out) -> bool:
    """Whether any floating tensor in ``out`` (a tensor or nested
    tuples of them) holds a NaN; one host read for all of them."""
    flags = [torch.isnan(t).any() for t in _tensors(out)
             if t.is_floating_point() or t.is_complex()]
    if not flags:
        return False
    return bool(torch.stack([f.to(flags[0].device) for f in flags])
                .any().item())


def check_op(name: str, out) -> None:
    """``apply_op``'s check of one op's outputs (skipped while a CUDA
    graph is being captured: its program is checked on return)."""
    ts = list(_tensors(out))
    if not ts or _capturing(ts[0]):
        return
    if has_nan(ts):
        raise FloatingPointError(
            f"invalid value (nan) encountered in op {name or '<unnamed>'!r}")


def check_program(label: str, outs, rerun: Optional[Callable[[], object]],
                  why_not: str = "") -> None:
    """Check a captured program's outputs; on a NaN, call ``rerun`` (the
    program run eagerly with every op checked), which raises naming the
    op. Without ``rerun``, the program is named and ``why_not`` says why
    it was not re-run."""
    if not has_nan(outs):
        return
    if rerun is None:
        raise FloatingPointError(
            f"invalid value (nan) encountered in program {label!r}; "
            f"not re-run op by op: {why_not}")
    prev = set_debug_nans(True)
    try:
        rerun()
    finally:
        set_debug_nans(prev)
    raise FloatingPointError(
        f"invalid value (nan) encountered in program {label!r}; its eager "
        "re-run, op by op, made no NaN")


def set_bulk_size(size: int) -> int:
    """Set the engine bulk size; returns the previous value (reference
    ``mx.engine.set_bulk_size``)."""
    global _BULK_SIZE
    prev, _BULK_SIZE = _BULK_SIZE, int(size)
    return prev


@contextlib.contextmanager
def bulk(size: int):
    """Scope with a given bulk size (reference ``mx.engine.bulk``)."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
