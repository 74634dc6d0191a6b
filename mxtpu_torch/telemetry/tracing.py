"""Lightweight span tracing: chrome://tracing-compatible events from
host-side code, alongside (never replacing) ``torch.profiler``'s device
trace. A copy of ``mxtpu/telemetry/tracing.py`` (host code).

A span measures HOST wall time between ``__enter__`` and ``__exit__``
— for dispatch-style code (the serve decode loop, a captured graph's
replay, the eager train step's launches) that is host dispatch time,
which is exactly the quantity the overlapped-sync design cares about.
Device time stays the profiler's job; the two are complementary, not
redundant.

Events accumulate in a bounded in-memory buffer (``trace_events()``,
dumped by :func:`dump_trace` as a Trace Event Format JSON array) and,
when ``MXTPU_TELEMETRY_TRACE_PATH`` is set, stream to that file as
JSONL — one ``{"name": ..., "ph": "X", ...}`` object per line, which
chrome://tracing and Perfetto both accept (their JSON importer
tolerates a missing enclosing array).

Nesting is tracked per thread: a span opened inside another span
carries ``args.depth`` and chrome's flame view nests them by
timestamp containment (same tid).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..base import env_int, env_str
from .flight import current_pid, process_role

__all__ = ["span", "instant", "trace_events", "dump_trace",
           "clear_trace", "Span", "set_context_provider",
           "stream_path"]

_MAX_EVENTS = env_int(
    "MXTPU_TELEMETRY_TRACE_EVENTS", 100_000,
    "In-memory trace-event ring size; oldest events drop first.")

_lock = threading.Lock()
_events: Deque[Dict[str, Any]] = deque(maxlen=max(1, _MAX_EVENTS))
_tls = threading.local()
_stream_file = None
_stream_failed = False

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


# register the knobs once; the per-event check below is a bare dict
# lookup (this runs on every recorded event, under the trace lock)
env_str("MXTPU_TELEMETRY_TRACE_PATH", "",
        "Stream span trace events to this file as JSONL "
        "(chrome://tracing-compatible); empty disables streaming.")
env_str("MXTPU_TELEMETRY_TRACE_DIR", "",
        "Stream span trace events to a PER-PROCESS JSONL file "
        "mxtpu_trace_<role>_<pid>.jsonl under this directory — the "
        "multi-process serving topology's form of "
        "MXTPU_TELEMETRY_TRACE_PATH (one file per process, so a "
        "forked worker never clobbers its parent's stream; "
        "tools/diagnose.py timeline stitches them).")


# derived-path cache: (dir, role, pid) -> joined path. The env/role
# inputs are still read per call (tests and operators flip them
# live), but the join+format — the actual cost on the per-event path
# under the trace lock — reruns only when an input changes (fork,
# set_process_role, a new dir).
_derived_path: tuple = ("", "", 0, "")


def stream_path() -> str:
    """Where this process streams trace events right now (empty =
    streaming off). Inputs are read at WRITE time, so a process
    forked after import gets its own file instead of inheriting the
    parent's."""
    path = os.environ.get("MXTPU_TELEMETRY_TRACE_PATH", "")
    if path:
        return path
    d = os.environ.get("MXTPU_TELEMETRY_TRACE_DIR", "")
    if not d:
        return ""
    global _derived_path
    role, pid = process_role(), current_pid()
    if _derived_path[:3] != (d, role, pid):
        _derived_path = (d, role, pid, os.path.join(
            d, f"mxtpu_trace_{role}_{pid}.jsonl"))
    return _derived_path[3]


def _stream(event: Dict[str, Any]) -> None:
    """Append one event to the stream target (lock held). A failing
    stream path degrades to in-memory-only, once, loudly."""
    global _stream_file, _stream_failed
    if _stream_failed:
        return
    path = stream_path()
    if not path:
        return
    try:
        if _stream_file is None or _stream_file.name != path:
            if _stream_file is not None:
                _stream_file.close()
            _stream_file = open(path, "a", buffering=1)
        # default=repr: span args are caller-supplied (numpy scalars,
        # arbitrary objects) — a telemetry write must never raise into
        # the instrumented code
        _stream_file.write(json.dumps(event, default=repr) + "\n")
    except Exception as e:
        _stream_failed = True
        import warnings
        warnings.warn(f"telemetry trace stream to {path!r} failed "
                      f"({e!r}); events stay in memory only",
                      RuntimeWarning)


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
        _stream(event)


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
                     "dur": t1 - self._t0, "pid": current_pid(),
                     "tid": threading.get_ident(), "args": args})
        if self._histogram is not None:
            self._histogram.observe(self.duration_ms)
        if self._flight is not None:
            self._flight.record("span", self.name,
                                dur_ms=round(self.duration_ms, 3),
                                **self.args)
        return False


def span(name: str, histogram=None, flight=None, **args: Any) -> Span:
    """``with telemetry.span("prefill", bucket=256): ...``"""
    return Span(name, histogram=histogram, flight=flight, **args)


def instant(name: str, **args: Any) -> None:
    """An instant event (chrome ph='i')."""
    _record({"name": name, "ph": "i", "ts": _now_us(), "s": "t",
             "pid": current_pid(), "tid": threading.get_ident(),
             "args": args})


def trace_events() -> List[Dict[str, Any]]:
    with _lock:
        return list(_events)


def current_depth() -> int:
    """This thread's open-span nesting depth."""
    return getattr(_tls, "depth", 0)


def dump_trace(path: str) -> str:
    """Write the buffered events as a complete Trace Event Format JSON
    array (one event per line — both valid JSON and diffable)."""
    with _lock:
        events = list(_events)
    with open(path, "w") as f:
        f.write("[\n")
        f.write(",\n".join(json.dumps(e, default=repr)
                           for e in events))
        f.write("\n]\n")
    return path


def clear_trace() -> None:
    global _stream_failed
    with _lock:
        _events.clear()
        _stream_failed = False
