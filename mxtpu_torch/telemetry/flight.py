"""Flight recorder: a bounded ring buffer of recent runtime events
(spans, notes such as a cancelled request) — the "what were the last N
things this job did" answer a post-mortem needs. The in-memory half of
``mxtpu/telemetry/flight.py``, copied (host code only); crash dumps to
disk and process roles come with the serving tier (ROADMAP Queue A
item 9).

The buffer is size-bounded (``MXTPU_TELEMETRY_FLIGHT_SIZE``) so an
always-on recorder costs a fixed few hundred KB, never an OOM.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..base import env_int

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(self, maxlen: Optional[int] = None):
        if maxlen is None:
            maxlen = env_int(
                "MXTPU_TELEMETRY_FLIGHT_SIZE", 512,
                "Flight-recorder ring size (recent events kept).")
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, Any]] = deque(
            maxlen=max(1, maxlen))

    def record(self, kind: str, name: str, **fields: Any) -> None:
        evt = {"t": round(time.time(), 6), "kind": kind, "name": name}
        evt.update(fields)
        with self._lock:
            self._events.append(evt)

    def tail(self, n: int = 20) -> List[Dict[str, Any]]:
        with self._lock:
            events = list(self._events)
        return events[-n:]
