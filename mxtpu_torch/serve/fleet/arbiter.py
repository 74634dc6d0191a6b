"""SLO-driven chip arbitration across per-model pools: ONE allocator
for the whole fleet, replacing per-model autoscaling — the port of
``mxtpu/serve/fleet/arbiter.py`` (host code: it moves replicas, it
launches nothing).

A per-model autoscaler sees only its own queue and p99 — two
autoscalers on one chip budget either both hold their maximum
(stranding chips on the cold model) or fight over the free pool. The
arbiter reads every pool's signals TOGETHER each tick and moves whole
replicas' worth of chips between them (the AlpaServe observation:
cross-model placement on a shared budget is where utilization is won):

- a pool is HOT when its queue pressure exceeds ``pressure_high`` or
  its SLO burn rate exceeds ``burn_high`` (the ``SLOTracker``
  burn, read per model — the tracker itself does the windowing);
- a pool is a DONOR when it has been sustained-idle (empty queue, low
  occupancy) for ``idle_s`` and sits above its ``min_replicas``;
- each tick grants at most ONE replica to the hottest pool — from the
  free budget if any, else by shrinking the coldest donor first (the
  chip MOVE the fleet bench asserts); with no claimant, one
  sustained-idle pool shrinks to return chips to the free budget.

Hysteresis is the autoscaler's (deliberately boring) discipline
reused fleet-wide: per-model cooldowns between decisions, sustained
idle before donating, one replica per tick. Every decision increments
``fleet_scale_events_total{model,direction}`` and lands in the flight
recorder with the signals that drove it; ``fleet_chips_in_use{model}``
/ ``fleet_chips_free`` are the live ledger. The loop is a pure
function of (clock, signals): tests inject both and single-step
:meth:`FleetArbiter.tick`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ... import telemetry
from ..gateway.replica import GatewayClosed

__all__ = ["ArbiterPolicy", "FleetArbiter", "TrainingTenant"]


@dataclass
class ArbiterPolicy:
    chip_budget: int = 0          # 0 = derived: the fleet's initial
    #                               allocation (sum of replicas*chips)
    interval_s: float = 1.0       # loop period
    cooldown_s: float = 10.0      # per-model gap between decisions
    pressure_high: float = 2.0    # un-seated requests per replica
    burn_high: float = 1.0        # SLO burn rate over = hot
    occupancy_low: float = 0.25   # idle ceiling (donor eligibility)
    idle_s: Optional[float] = None   # sustained idle before donating;
    #                                  None = cooldown_s

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, "
                             f"got {self.interval_s}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, "
                             f"got {self.cooldown_s}")


class FleetArbiter:
    """Arbitrates ``policy.chip_budget`` chips between the fleet's
    pools. ``entries`` is the fleet's LIVE ``{name: entry}`` mapping
    (each entry carries ``.pool`` — size, bounds, chips_per_replica,
    scale_to — and ``.gateway`` — whose ``slo`` tracker supplies the
    burn rate); reading it live means models registered after
    construction are arbitrated too.

    ``signals``: optional ``fn(name, entry) -> {"pressure",
    "occupancy", "burn", "queued", "size"}`` override — the
    deterministic-test hook (synthetic burn without real latency)."""

    def __init__(self, entries: Dict[str, Any], policy: ArbiterPolicy,
                 *, clock: Optional[Callable[[], float]] = None,
                 signals: Optional[Callable[[str, Any],
                                            Dict[str, float]]] = None):
        self.entries = entries
        self.policy = policy
        self._clock = clock or time.monotonic
        self._signals_override = signals
        # non-serving tenants (a trainer's TrainingTenant)
        # registered after construction live here, NOT in the fleet's
        # model mapping — fleet iteration (health/state/metrics) never
        # sees them, arbitration always does
        self._tenants: Dict[str, Any] = {}
        self.budget = int(policy.chip_budget) if policy.chip_budget \
            else sum(e.pool.size * self._cpr(n, e)
                     for n, e in entries.items())
        self._idle_since: Dict[str, float] = {}
        self._last_scale: Dict[str, float] = {}
        self._m_events: Dict[tuple, Any] = {}
        self._m_chips: Dict[str, Any] = {}
        self._m_free = telemetry.gauge(
            "fleet_chips_free",
            "Chips of the fleet budget not allocated to any pool")
        self.decisions: List[Dict[str, Any]] = []   # bounded: tick()

    def _get(self, name: str):
        entry = self.entries.get(name)
        return entry if entry is not None else self._tenants.get(name)

    def _items(self):
        """Live arbitration view: the fleet's model entries plus
        registered tenants."""
        out = list(self.entries.items())
        out.extend(self._tenants.items())
        return out

    def register(self, name: str, tenant: Any, *,
                 chips: Optional[int] = None) -> None:
        """Register a non-serving tenant (e.g. :class:`TrainingTenant`
        wrapping a trainer) as a claimant/donor. Its current
        allocation joins the budget — chips it later yields become
        free budget the pools can claim, and vice versa. Pass
        ``chips`` to add a different amount (0 = the budget already
        counted them)."""
        if name in self.entries or name in self._tenants:
            raise ValueError(f"arbiter already has a tenant {name!r}")
        self._tenants[name] = tenant
        add = int(chips) if chips is not None \
            else tenant.pool.size * self._cpr(name, tenant)
        self.budget += add
        telemetry.flight().record(
            "fleet", "tenant_register", tenant=name, chips=add,
            budget=self.budget)

    def _cpr(self, name: str, entry: Any = None) -> int:
        entry = entry if entry is not None else self._get(name)
        return int(getattr(entry.pool, "chips_per_replica", 1)
                   if entry is not None else 1)

    def _bounds(self, name: str) -> tuple:
        pool = self._get(name).pool
        return (int(getattr(pool, "min_replicas", 1)),
                int(getattr(pool, "max_replicas", 1 << 30)))

    def _signals(self, name: str, entry) -> Dict[str, float]:
        """Default signal read: pool load at the source (the same
        numbers the autoscaler used) + the model's SLO burn rate.
        ``slo.tick()`` is rate-limited to its own window, so arbiter
        cadence cannot chop the burn computation into noise. An entry
        that carries its own ``signals()`` (a tenant) speaks for
        itself."""
        custom = getattr(entry, "signals", None)
        if custom is not None:
            return custom()
        pool = entry.pool
        load = pool.load_total()
        n = pool.size
        burn = 0.0
        slo = getattr(entry.gateway, "slo", None)
        if slo is not None:
            snap = slo.tick()
            burns = [v.get("burn") for v in snap.values()
                     if v.get("burn") is not None]
            if burns:
                burn = max(burns)
        return {"pressure": load["queued"] / max(1, n),
                "occupancy": load["active"] / max(1, load["slots"]),
                "queued": float(load["queued"]),
                "size": float(n), "burn": float(burn)}

    def _count_event(self, model: str, direction: str) -> None:
        key = (model, direction)
        m = self._m_events.get(key)
        if m is None:
            m = self._m_events[key] = telemetry.counter(
                "fleet_scale_events_total",
                "Fleet arbiter decisions, by model and direction",
                model=model, direction=direction)
        m.inc()

    def _scale(self, name: str, delta: int, now: float, *,
               reason: str,
               sigs: Dict[str, Dict[str, float]]
               ) -> Optional[Dict[str, Any]]:
        entry = self._get(name)
        if entry is None:
            return None
        n = entry.pool.size
        try:
            entry.pool.scale_to(n + delta)
        except GatewayClosed:
            # a tick racing fleet shutdown: the pool refused loudly —
            # stand down, record nothing
            return None
        direction = "up" if delta > 0 else "down"
        self._last_scale[name] = now
        self._idle_since.pop(name, None)
        self._count_event(name, direction)
        s = sigs.get(name, {})
        record = {"t": now, "model": name, "direction": direction,
                  "from": n, "to": n + delta, "reason": reason,
                  "pressure": round(s.get("pressure", 0.0), 3),
                  "occupancy": round(s.get("occupancy", 0.0), 3),
                  "burn": round(s.get("burn", 0.0), 3)}
        telemetry.flight().record("fleet", "scale", **record)
        self.decisions.append(record)
        del self.decisions[:-64]
        return record

    def tick(self) -> List[Dict[str, Any]]:
        """One arbitration pass; returns the decisions made (possibly
        a down on a donor AND an up on the claimant — the chip
        move)."""
        pol = self.policy
        now = self._clock()
        sigs: Dict[str, Dict[str, float]] = {}
        for name, entry in self._items():
            try:
                sigs[name] = (
                    self._signals_override(name, entry)
                    if self._signals_override is not None
                    else self._signals(name, entry))
            except GatewayClosed:
                continue
        # idle bookkeeping (donor eligibility needs SUSTAINED idle —
        # one quiet tick between bursts must not donate a replica)
        for name, s in sigs.items():
            hot_sig = (s["pressure"] > pol.pressure_high
                       or s["burn"] > pol.burn_high)
            if (not hot_sig and s["queued"] == 0
                    and s["occupancy"] < pol.occupancy_low):
                self._idle_since.setdefault(name, now)
            else:
                self._idle_since.pop(name, None)
        idle_need = (pol.idle_s if pol.idle_s is not None
                     else pol.cooldown_s)

        def in_cooldown(name: str) -> bool:
            t = self._last_scale.get(name)
            return t is not None and now - t < pol.cooldown_s

        hot = sorted(
            (n for n, s in sigs.items()
             if (s["pressure"] > pol.pressure_high
                 or s["burn"] > pol.burn_high)
             and s["size"] < self._bounds(n)[1]
             and not in_cooldown(n)),
            key=lambda n: (sigs[n]["burn"], sigs[n]["pressure"]),
            reverse=True)
        donors = sorted(
            (n for n, s in sigs.items()
             if s["size"] > self._bounds(n)[0]
             and not in_cooldown(n)
             and n in self._idle_since
             and now - self._idle_since[n] >= idle_need),
            key=lambda n: (sigs[n]["pressure"], sigs[n]["occupancy"]))

        used = sum(int(s["size"]) * self._cpr(n)
                   for n, s in sigs.items())
        free = self.budget - used
        decisions: List[Dict[str, Any]] = []
        if hot:
            name = hot[0]
            need = self._cpr(name)
            for donor in (d for d in donors if d != name):
                if free >= need:
                    break
                d = self._scale(donor, -1, now,
                                reason=f"yield->{name}", sigs=sigs)
                if d is not None:
                    decisions.append(d)
                    free += self._cpr(donor)
            if free < need:
                # still short: PREEMPTIBLE tenants (the training mesh)
                # yield under serve load without waiting for sustained
                # idle — training time is the fleet's reserve capacity
                for donor in (
                        d for d, s in sigs.items()
                        if d != name and d not in donors
                        and getattr(self._get(d), "preemptible", False)
                        and s["size"] > self._bounds(d)[0]
                        and not in_cooldown(d)):
                    if free >= need:
                        break
                    d = self._scale(donor, -1, now,
                                    reason=f"preempt->{name}",
                                    sigs=sigs)
                    if d is not None:
                        decisions.append(d)
                        free += self._cpr(donor)
            if free >= need:
                d = self._scale(name, +1, now, reason="hot",
                                sigs=sigs)
                if d is not None:
                    decisions.append(d)
        elif donors:
            # nothing is burning: return ONE sustained-idle replica's
            # chips to the free budget (the next hot tick grants them
            # without waiting on a donor's cooldown)
            d = self._scale(donors[0], -1, now, reason="idle",
                            sigs=sigs)
            if d is not None:
                decisions.append(d)

        # live chip ledger (post-decision sizes)
        used = 0
        for name, entry in self._items():
            chips = entry.pool.size * self._cpr(name)
            used += chips
            g = self._m_chips.get(name)
            if g is None:
                g = self._m_chips[name] = telemetry.gauge(
                    "fleet_chips_in_use",
                    "Chips currently allocated to the model's pool",
                    model=name)
            g.set(chips)
        self._m_free.set(max(0, self.budget - used))
        return decisions

    def last_decision(self, model: str) -> Optional[Dict[str, Any]]:
        """Most recent decision touching ``model`` (diagnose's 'last
        arbiter decision' column; None before the first)."""
        for d in reversed(self.decisions):
            if d["model"] == model:
                return dict(d)
        return None

    def describe(self) -> Dict[str, Any]:
        """Live budget + per-pool chips + recent decisions
        (GET /state)."""
        chips = {}
        for name, entry in self._items():
            try:
                chips[name] = entry.pool.size * self._cpr(name, entry)
            except Exception:
                continue
        return {"budget": self.budget, "chips": chips,
                "free": max(0, self.budget - sum(chips.values())),
                "cooldown_s": self.policy.cooldown_s,
                "decisions": self.decisions[-8:]}

    def run_forever(self, stop: threading.Event) -> None:
        while not stop.wait(self.policy.interval_s):
            try:
                self.tick()
            except Exception:
                # arbitration must never die quietly; the flight ring
                # has the event, the next tick retries
                telemetry.flight().record("fleet", "arbiter_error")


class TrainingTenant:
    """The TRAINING side as an arbiter tenant: register one of these
    (``FleetArbiter.register`` / ``FleetGateway.register_tenant``) and
    the trainer joins fleet chip arbitration as claimant AND
    donor — serving reclaims chips under load, training borrows idle
    chips back.

    ``resize(chips, reason)`` is the callback into the training side —
    typically a trainer's resize request — invoked from the
    arbiter tick thread, so it must only REQUEST the change (the
    trainer applies it at its next step boundary via the
    generation-bump rebuild). One tenant "replica" is one chip.

    Semantics, in arbiter terms: below ``want`` chips the tenant
    reports hot (pressure ``hunger_pressure``) and claims from the
    free budget; at or above ``want`` it reports idle, so chips over
    ``want`` drain back. Its burn is always 0, so any pool with real
    SLO burn outranks it. It is ``preemptible``: when a pool is hot
    and no idle donor covers the need, the arbiter shrinks the tenant
    immediately — training never blocks serving on "sustained idle"
    it will never exhibit."""

    preemptible = True
    gateway = None                    # no SLO: burn reads as 0
    chips_per_replica = 1

    def __init__(self, resize: Callable[[int, str], None], *,
                 chips: int, want: Optional[int] = None,
                 min_chips: int = 1, max_chips: Optional[int] = None,
                 name: str = "train", hunger_pressure: float = 2.5):
        self.name = name
        self._resize = resize
        self.size = int(chips)
        self.want = int(want if want is not None else chips)
        self.min_replicas = int(min_chips)
        self.max_replicas = int(max_chips if max_chips is not None
                                else max(self.size, self.want))
        self.hunger_pressure = float(hunger_pressure)
        self.pool = self              # entry.pool protocol: itself
        self._m_lends: Dict[str, Any] = {}

    def signals(self) -> Dict[str, float]:
        hungry = self.size < self.want
        return {
            "pressure": self.hunger_pressure if hungry else 0.0,
            # never "sustained idle" at/below want: the idle-donation
            # path would strip a chip the tenant immediately re-claims
            # (an arbiter-powered oscillation); only surplus over
            # `want` reads as idle and drains back
            "occupancy": 0.0 if self.size > self.want else 1.0,
            "queued": float(max(0, self.want - self.size)),
            "size": float(self.size), "burn": 0.0}

    def load_total(self) -> Dict[str, int]:
        # only reached when a signals override bypasses signals()
        return {"queued": max(0, self.want - self.size),
                "active": min(self.size, self.want),
                "slots": max(1, self.size)}

    def scale_to(self, n: int) -> None:
        n = max(self.min_replicas, min(int(n), self.max_replicas))
        if n == self.size:
            return
        direction = "borrow" if n > self.size else "lend"
        m = self._m_lends.get(direction)
        if m is None:
            m = self._m_lends[direction] = telemetry.counter(
                "fleet_chip_lends_total",
                "Chips moved between the training tenant and the "
                "serving budget by the arbiter (lend = training "
                "yields to serving, borrow = training reclaims).",
                tenant=self.name, direction=direction)
        m.inc(abs(n - self.size))
        telemetry.flight().record(
            "fleet", "tenant_resize", tenant=self.name,
            chips_from=self.size, chips_to=n, direction=direction)
        # optimistic: the ledger reads the granted size now; the
        # trainer applies it at its next step boundary
        self.size = n
        self._resize(n, f"arbiter-{direction}")
