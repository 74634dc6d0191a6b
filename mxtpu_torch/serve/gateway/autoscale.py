"""Telemetry-driven autoscaling: the loop that turns the serving gauges
into replica counts — the port of ``mxtpu/serve/gateway/autoscale.py``.

Signals (all already exported by the serving stack — the scaler adds
no instrumentation of its own):

- **pressure**: the backend's un-seated request count per replica
  (``load_total()["queued"] / size`` — the same number the
  ``serve_queue_depth`` gauges carry, read at the source so a fake
  backend makes tests deterministic);
- **latency**: interval p99 of ``serve_token_latency_ms`` — each tick
  diffs the process-wide histogram's cumulative buckets against the
  previous tick and interpolates the percentile inside the window, so
  the target tracks CURRENT latency, not the run's history;
- **slack**: slot occupancy (``active / slots``).

Policy (deliberately boring — hysteresis over cleverness):

- scale UP one replica when per-replica queue pressure exceeds
  ``queue_high`` or interval p99 exceeds ``target_p99_ms``;
- scale DOWN one replica when the queue is empty AND occupancy is
  under ``occupancy_low`` AND latency is in budget, sustained for
  ``cooldown_s``;
- never within ``cooldown_s`` of the last decision, never outside
  [``min_replicas``, ``max_replicas``].

Every decision increments ``gateway_scale_events_total{direction}``
and lands in the flight recorder with the signal values that drove it
— an unexplained replica count is a grep, not an archaeology session.
The loop is a pure function of (clock, signals): tests drive
:meth:`Autoscaler.tick` with a fake clock and injected loads.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ... import telemetry
from ...telemetry.registry import interval_percentile
from .replica import GatewayClosed

__all__ = ["AutoscalePolicy", "Autoscaler", "interval_p99"]


@dataclass
class AutoscalePolicy:
    min_replicas: int = 1
    max_replicas: int = 4
    target_p99_ms: float = 0.0       # 0 = ignore the latency signal
    queue_high: float = 2.0          # un-seated requests per replica
    occupancy_low: float = 0.25      # scale-down ceiling
    cooldown_s: float = 10.0         # min gap between decisions AND
    #                                  sustained-idle requirement
    interval_s: float = 1.0          # loop period

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"bad replica bounds [{self.min_replicas}, "
                f"{self.max_replicas}]")


def interval_p99(bounds, prev_counts: Optional[List[int]],
                 counts: List[int], q: float = 99.0) -> Optional[float]:
    """Windowed p99 between two cumulative-bucket snapshots: the
    autoscaler's name for ``telemetry.registry.interval_percentile``,
    the one copy of the bucket-diff math the SLO gauges share."""
    return interval_percentile(bounds, prev_counts, counts, q)


class Autoscaler:
    """Drives ``pool.scale_to`` from the serving telemetry.

    ``pool``: ``size``, ``load_total() -> {queued, active, slots}``,
    ``scale_to(n)`` — a ``ReplicaSet``, a ``DisaggBackend`` (scales
    its decode pool), or a test fake. ``latency_p99``: optional
    override returning the current-window p99 ms (None = read the
    process-wide ``serve_token_latency_ms`` histogram)."""

    def __init__(self, pool, policy: AutoscalePolicy, *,
                 clock: Optional[Callable[[], float]] = None,
                 latency_p99: Optional[Callable[[], Optional[float]]]
                 = None):
        self.pool = pool
        self.policy = policy
        self._clock = clock or time.monotonic
        self._latency_override = latency_p99
        self._last_counts: Optional[List[int]] = None
        self._last_scale: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_p99: Optional[float] = None
        self._m_events: Dict[str, object] = {}
        self.decisions: List[Dict] = []       # bounded: see tick()

    def _count_event(self, direction: str) -> None:
        m = self._m_events.get(direction)
        if m is None:
            m = self._m_events[direction] = telemetry.counter(
                "gateway_scale_events_total",
                "Autoscaler decisions, by direction",
                direction=direction)
        m.inc()

    def _window_p99(self) -> Optional[float]:
        if self._latency_override is not None:
            return self._latency_override()
        h = telemetry.registry().get("serve_token_latency_ms")
        if h is None:
            return None
        counts, _, _ = h.snapshot()
        prev, self._last_counts = self._last_counts, counts
        return interval_p99(h.bounds, prev, counts)

    def tick(self) -> Optional[str]:
        """One decision pass; returns "up"/"down"/None."""
        pol = self.policy
        now = self._clock()
        n = self.pool.size
        load = self.pool.load_total()
        pressure = load["queued"] / max(1, n)
        occupancy = load["active"] / max(1, load["slots"])
        p99 = self._window_p99()
        self._last_p99 = p99
        in_cooldown = (self._last_scale is not None
                       and now - self._last_scale < pol.cooldown_s)

        hot = (pressure > pol.queue_high
               or (pol.target_p99_ms > 0 and p99 is not None
                   and p99 > pol.target_p99_ms))
        idle = (load["queued"] == 0 and occupancy < pol.occupancy_low
                and not hot)
        if idle:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None

        direction = None
        if hot and n < pol.max_replicas and not in_cooldown:
            direction = "up"
        elif (idle and n > pol.min_replicas and not in_cooldown
              and self._idle_since is not None
              and now - self._idle_since >= pol.cooldown_s):
            direction = "down"
        if direction is None:
            return None

        new_n = n + (1 if direction == "up" else -1)
        try:
            self.pool.scale_to(new_n)
        except GatewayClosed:
            # a late tick racing close(): the pool refused loudly
            # (uniform close semantics) — stand down, count nothing
            return None
        self._last_scale = now
        self._idle_since = None
        self._count_event(direction)
        record = {"t": now, "direction": direction, "from": n,
                  "to": new_n, "pressure": round(pressure, 3),
                  "occupancy": round(occupancy, 3),
                  "p99_ms": None if p99 is None else round(p99, 2)}
        telemetry.flight().record("gateway", "scale", **record)
        self.decisions.append(record)
        del self.decisions[:-64]       # bounded decision log
        return direction

    def describe(self) -> Dict:
        """Live policy + last-signal snapshot (GET /state)."""
        return {"replicas": self.pool.size,
                "min": self.policy.min_replicas,
                "max": self.policy.max_replicas,
                "target_p99_ms": self.policy.target_p99_ms,
                "last_p99_ms": self._last_p99,
                "decisions": self.decisions[-5:]}

    def run_forever(self, stop: threading.Event) -> None:
        while not stop.wait(self.policy.interval_s):
            try:
                self.tick()
            except Exception:
                # a scaling hiccup must never kill the loop — the
                # flight ring has the signals, the next tick retries
                telemetry.flight().record("gateway", "scale_error")
