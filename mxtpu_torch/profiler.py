"""``mx.profiler`` — the port of ``mxtpu/profiler.py``.

Two layers, as in the reference:

1. **The trace.** ``start()``/``stop()`` drive ``torch.profiler`` with
   the CPU and, where a card is visible, CUDA activities, and write a
   chrome trace (``chrome://tracing``, Perfetto; upstream MXNet wrote
   the same format) as ``<filename stem>_trace/profile_<n>.json``.
   ``last_trace()`` names the newest file. A trace that cannot start
   because another ``torch.profiler`` trace is active is reported with a
   warning and the aggregate goes on alone, as the reference does for a
   foreign trace; any other failure raises. On a card the trace must
   hold kernel events: ``start`` launches one probe kernel, and ``stop``
   raises when the trace has no kernel event at all (CUPTI activity
   tracing refused by the host).
2. **The per-op aggregate.** While profiling, every ``apply_op``
   dispatch is timed on the host (``perf_counter`` around the dispatch,
   no device sync) and counted by op name; ``dumps()`` gives the
   reference's ``aggregate_stats`` table. ``pause()`` stops only the
   aggregate (the trace stays alive) and ``resume()`` picks it up again,
   also after a ``stop()``, when it starts a new trace and keeps the
   aggregate.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["set_config", "start", "stop", "pause", "resume", "dump",
           "dumps", "set_state", "last_trace", "Marker", "Counter", "Task",
           "Frame"]

_config = {"filename": "profile.json", "profile_all": False,
           "profile_symbolic": True, "profile_imperative": True,
           "aggregate_stats": False}
_state = {"running": False, "paused": False, "trace_dir": None,
          "prof": None, "cuda": False, "runs": 0, "trace_file": None}
_agg: Dict[str, list] = defaultdict(lambda: [0, 0.0])   # name → [count, s]


def set_config(**kwargs):
    """Configure (reference ``mx.profiler.set_config``). Accepts the
    reference's kwargs; ``filename`` names the trace directory's stem."""
    _config.update(kwargs)


def set_state(state: str = "stop", profile_process: str = "worker"):
    if state == "run":
        start()
    else:
        stop()


def _hook(name: str, dt: float):
    _agg[name][0] += 1
    _agg[name][1] += dt


def _install_hook():
    from .ndarray import ndarray as nd_mod
    nd_mod._profile_hook = _hook


def _uninstall_hook():
    from .ndarray import ndarray as nd_mod
    nd_mod._profile_hook = None


def _start_trace(trace_dir: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if torch.autograd.profiler._is_profiler_enabled:
        warnings.warn("another torch.profiler trace is active: this "
                      "profile aggregates ops only and writes no trace")
        _state["prof"] = None
        return
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    prof = profile(activities=acts)
    prof.start()
    if cuda:
        # one kernel the trace must hold (stop() checks it)
        torch.zeros(1, device="cuda").add_(1)
    _state.update(prof=prof, cuda=cuda, trace_dir=trace_dir)


def _start(clear_agg: bool):
    trace_dir = os.path.splitext(_config["filename"])[0] + "_trace"
    os.makedirs(trace_dir, exist_ok=True)
    _start_trace(trace_dir)
    if clear_agg:
        _agg.clear()
    _install_hook()
    _state["running"] = True
    _state["paused"] = False


def start():
    """Start profiling (reference ``mx.profiler.start``); a start while
    paused resumes the aggregate, a start while running does nothing."""
    if _state["running"]:
        if _state["paused"]:
            _install_hook()
            _state["paused"] = False
        return
    _start(clear_agg=True)


def pause(profile_process: str = "worker"):
    """Suspend the aggregate only (exclude a region from ``dumps``); the
    trace stays alive."""
    if _state["running"] and not _state["paused"]:
        _uninstall_hook()
        _state["paused"] = True


def resume(profile_process: str = "worker"):
    """Continue after ``pause()``; after a ``stop()``, start a new trace
    and keep the aggregate."""
    if _state["running"]:
        if _state["paused"]:
            _install_hook()
            _state["paused"] = False
        return
    _start(clear_agg=False)


def _kernel_events(path: str) -> int:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return sum(1 for e in events if e.get("cat") == "kernel")


def stop():
    """Stop profiling and write the trace."""
    if not _state["running"]:
        return
    _uninstall_hook()
    _state["running"] = False
    _state["paused"] = False
    prof = _state["prof"]
    if prof is None:
        return
    _state["prof"] = None
    prof.stop()
    _state["runs"] += 1
    path = os.path.join(_state["trace_dir"],
                        f"profile_{os.getpid()}_{_state['runs']}.json")
    prof.export_chrome_trace(path)
    _state["trace_file"] = path
    if _state["cuda"] and _kernel_events(path) == 0:
        raise RuntimeError(
            f"the trace {path} holds no kernel event, not even start()'s "
            "probe kernel: this host refuses CUPTI activity tracing, so "
            "torch.profiler cannot see the card")


def last_trace() -> Optional[str]:
    """The chrome trace the last ``stop()`` wrote (None before one)."""
    return _state["trace_file"]


def dump(finished: bool = True, profile_process: str = "worker"):
    """Finish and write the trace (reference ``mx.profiler.dump``)."""
    if _state["running"]:
        stop()


def dumps(reset: bool = False, format: str = "table") -> str:
    """The per-op aggregate (reference ``aggregate_stats`` table);
    ``format="json"`` gives ``{name: {"count": n, "time_ms": t}}``."""
    rows = sorted(_agg.items(), key=lambda kv: -kv[1][1])
    if format == "json":
        out = json.dumps({name: {"count": count,
                                 "time_ms": round(t * 1e3, 6)}
                          for name, (count, t) in rows})
    elif format == "table":
        lines = [f"{'Name':<40}{'Total Count':>12}{'Time (ms)':>14}"]
        for name, (count, t) in rows:
            lines.append(f"{name:<40}{count:>12}{t * 1e3:>14.3f}")
        out = "\n".join(lines)
    else:
        raise ValueError(
            f"unknown dumps format {format!r} (want 'table' or 'json')")
    if reset:
        _agg.clear()
    return out


class Marker:
    """Instant event (reference ``mx.profiler.Marker``)."""

    def __init__(self, name: str, domain=None):
        self.name = name

    def mark(self, scope: str = "process"):
        _hook(f"marker:{self.name}", 0.0)


class Counter:
    """Named counter (reference ``mx.profiler.Counter``)."""

    def __init__(self, name: str, domain=None, value: Optional[int] = None):
        self.name = name
        self.value = value or 0

    def set_value(self, value: int):
        self.value = value

    def increment(self, delta: int = 1):
        self.value += delta

    def decrement(self, delta: int = 1):
        self.value -= delta

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


class Task:
    """Named duration (reference ``mx.profiler.Task``); also a context
    manager."""

    def __init__(self, name: str, domain=None):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            _hook(f"task:{self.name}", time.perf_counter() - self._t0)
            self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


Frame = Task
