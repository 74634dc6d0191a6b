"""Crash flight recorder: a bounded ring buffer of recent runtime
events (spans, compiles, faults, explicit notes) that crash paths dump
to disk — the "what were the last N things this job did" answer that
a post-mortem needs when the metrics endpoint died with the process.

A copy of ``mxtpu/telemetry/flight.py`` (host code). Anything can call
``telemetry.flight().dump()``; ``tools/diagnose.py`` prints the live
tail, and ``mxtpu_torch.checkpoint.PreemptionGuard`` dumps it on
SIGTERM/SIGINT.
The buffer is size-bounded
(``MXTPU_TELEMETRY_FLIGHT_SIZE``) so an always-on recorder costs a
fixed few hundred KB, never an OOM.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..base import atomic_write, env_int, env_str

__all__ = ["FlightRecorder", "default_flight_path", "process_role",
           "set_process_role"]

# the pid that imported this module — the parent of any later fork.
# A forked worker (prefill pool, DataLoader) inherits module state but
# has a NEW pid; path derivation compares against this so the child
# never dumps over the parent's file.
_IMPORT_PID = os.getpid()

# this process's pid, set again in a forked child: every record and
# trace event carries it, and ``os.getpid()`` is a system call, which
# costs tens of microseconds a call on some hosts (a decode
# dispatch records a few). The reference calls it per record; the value
# is the same.
_PID = _IMPORT_PID


def _refresh_pid() -> None:
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_pid)


def current_pid() -> int:
    """``os.getpid()`` without the system call (kept current across
    forks)."""
    return _PID


_role_override: Optional[str] = None

env_str("MXTPU_TELEMETRY_PROCESS", "",
        "Role label of THIS process in the distributed telemetry "
        "surfaces (flight records, per-process trace files, the "
        "federated /metrics `process` label). Default: pid<pid>.")


def set_process_role(role: str) -> None:
    """Programmatic override of ``MXTPU_TELEMETRY_PROCESS`` (a serve
    worker naming itself after its pool role)."""
    global _role_override
    _role_override = str(role) if role else None


def process_role() -> str:
    """This process's role label — env/override read PER CALL, pid
    fallback from :func:`current_pid`, so a fork can never freeze the
    parent's identity into the child."""
    if _role_override:
        return _role_override
    return (os.environ.get("MXTPU_TELEMETRY_PROCESS", "")
            or f"pid{_PID}")


def default_flight_path() -> str:
    """Where a crash dump lands: ``MXTPU_TELEMETRY_FLIGHT_PATH`` or a
    per-pid file under the system temp dir (predictable enough to find
    after a preemption, collision-free across ranks on one host).
    Derived at DUMP time: a process forked after import gets the env
    path suffixed with its own pid — without that, every worker in a
    forked pool would atomic-replace the same file and the last
    (least interesting) dump would win."""
    path = env_str(
        "MXTPU_TELEMETRY_FLIGHT_PATH", "",
        "Flight-recorder crash-dump file; default "
        "<tmpdir>/mxtpu_flight_<pid>.jsonl. A process forked after "
        "import dumps to <path>.<pid> so parallel dumps never "
        "clobber.")
    if not path:
        return os.path.join(
            tempfile.gettempdir(), f"mxtpu_flight_{os.getpid()}.jsonl")
    if os.getpid() != _IMPORT_PID:
        return f"{path}.{os.getpid()}"
    return path


class FlightRecorder:
    def __init__(self, maxlen: Optional[int] = None):
        if maxlen is None:
            maxlen = env_int(
                "MXTPU_TELEMETRY_FLIGHT_SIZE", 512,
                "Flight-recorder ring size (recent events kept for "
                "crash dumps).")
        # RLock, deliberately: PreemptionGuard records+dumps from a
        # SIGNAL HANDLER, which CPython runs on the main thread between
        # bytecodes — if the interrupted frame already holds this lock
        # (every span exit records), a non-reentrant lock would
        # deadlock the process on the exact path built to save it. A
        # non-main-thread holder only delays the handler (that thread
        # keeps running); the deque ops under the lock are single C
        # calls, so a re-entrant handler never sees torn state.
        self._lock = threading.RLock()
        self._events: Deque[Dict[str, Any]] = deque(
            maxlen=max(1, maxlen))

    def record(self, kind: str, name: str, **fields: Any) -> None:
        # tagged with the process role so stitched/collected dumps
        # from a multi-process serve tier stay attributable
        evt = {"t": round(time.time(), 6), "kind": kind, "name": name,
               "process": process_role()}
        evt.update(fields)
        with self._lock:
            self._events.append(evt)

    def tail(self, n: int = 20) -> List[Dict[str, Any]]:
        with self._lock:
            events = list(self._events)
        return events[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def dump(self, path: Optional[str] = None) -> str:
        """Write the ring as JSONL (atomic tmp+rename — a dump torn by
        the very crash it documents would be worse than none). Safe to
        call from a signal handler: any failure is swallowed after a
        best-effort stderr note, because the dump must never turn a
        clean preemption save into a crash."""
        path = path or default_flight_path()
        with self._lock:
            events = list(self._events)
        try:
            # default=repr: a numpy scalar in an event field must not
            # cost the crash dump its moment
            blob = "".join(json.dumps(e, default=repr) + "\n"
                           for e in events)
            atomic_write(path, blob.encode())
        except Exception as e:
            try:
                import sys
                sys.stderr.write(
                    f"mxtpu_torch telemetry: flight dump to {path!r} failed: "
                    f"{e!r}\n")
            except Exception:
                pass
        return path

    def format_tail(self, n: int = 20) -> str:
        """Human-readable tail for diagnose.py."""
        events = self.tail(n)
        if not events:
            return "(flight recorder empty)"
        lines = []
        for e in events:
            extra = {k: v for k, v in e.items()
                     if k not in ("t", "kind", "name", "process")}
            ts = time.strftime("%H:%M:%S", time.localtime(e["t"]))
            lines.append(f"{ts}  {e['kind']:<9} {e['name']}"
                         + (f"  {extra}" if extra else ""))
        return "\n".join(lines)
