"""Lightweight span tracing: chrome://tracing-compatible events from
host-side code, alongside (never replacing) ``torch.profiler``'s device
trace. The in-memory half of ``mxtpu/telemetry/tracing.py``, copied
(host code only); streaming to files and ``dump_trace`` come with the
serving tier (ROADMAP Queue A item 9).

A span measures HOST wall time between ``__enter__`` and ``__exit__``
— for dispatch-style code (the serve decode loop, a captured graph's
replay) that is host dispatch time, which is exactly the quantity the
overlapped-sync design cares about. Device time stays the profiler's
job; the two are complementary, not redundant.

Events accumulate in a bounded in-memory buffer (``trace_events()``).
Nesting is tracked per thread: a span opened inside another span
carries ``args.depth`` and chrome's flame view nests them by
timestamp containment (same tid).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..base import env_int

__all__ = ["instant", "trace_events", "Span", "set_context_provider"]

_MAX_EVENTS = env_int(
    "MXTPU_TELEMETRY_TRACE_EVENTS", 100_000,
    "In-memory trace-event ring size; oldest events drop first.")

_lock = threading.Lock()
_events: Deque[Dict[str, Any]] = deque(maxlen=max(1, _MAX_EVENTS))
_tls = threading.local()

# the distributed-tracing hook (telemetry.distributed installs it):
# called per recorded event; a non-empty return (trace_id, span id,
# request baggage) is merged under the event's args, so every span a
# request's context is active for carries the request's trace identity
# without tracing depending on the context layer
_ctx_provider = None


def set_context_provider(fn) -> None:
    """Install the callable that supplies the CURRENT request-scoped
    trace fields (``None``/falsy = no active context). One provider
    per process; ``telemetry.distributed`` owns it."""
    global _ctx_provider
    _ctx_provider = fn


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


def _record(event: Dict[str, Any]) -> None:
    if _ctx_provider is not None:
        ctx_fields = _ctx_provider()
        if ctx_fields:
            # explicit per-event args win over context baggage
            args = event.get("args")
            event["args"] = ({**ctx_fields, **args} if args
                             else dict(ctx_fields))
    with _lock:
        _events.append(event)


class Span:
    """One traced duration (context manager). ``duration_ms`` is
    populated on exit; ``args`` ride into the trace event verbatim."""

    def __init__(self, name: str, histogram=None, flight=None,
                 record: bool = True, **args: Any):
        self.name = name
        self.args = args
        self.duration_ms: Optional[float] = None
        self._histogram = histogram
        self._flight = flight
        self._record_event = record
        self._t0 = 0

    def __enter__(self) -> "Span":
        depth = getattr(_tls, "depth", 0)
        _tls.depth = depth + 1
        self.depth = depth
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _now_us()
        _tls.depth = max(0, getattr(_tls, "depth", 1) - 1)
        self.duration_ms = (t1 - self._t0) / 1000.0
        args = dict(self.args)
        if self.depth:
            args["depth"] = self.depth
        if self._record_event:
            _record({"name": self.name, "ph": "X", "ts": self._t0,
                     "dur": t1 - self._t0, "pid": os.getpid(),
                     "tid": threading.get_ident(), "args": args})
        if self._histogram is not None:
            self._histogram.observe(self.duration_ms)
        if self._flight is not None:
            self._flight.record("span", self.name,
                                dur_ms=round(self.duration_ms, 3),
                                **self.args)
        return False


def instant(name: str, **args: Any) -> None:
    """An instant event (chrome ph='i')."""
    _record({"name": name, "ph": "i", "ts": _now_us(), "s": "t",
             "pid": os.getpid(), "tid": threading.get_ident(),
             "args": args})


def trace_events() -> List[Dict[str, Any]]:
    with _lock:
        return list(_events)
