"""Flywheel: the continuous train→serve deployment loop — the port of
``mxtpu/serve/fleet/flywheel.py``, over the port's checkpoint store.

The trainer publishes manifest-committed checkpoints on a
cadence (``CheckpointManager.publish`` → the ``latest-published``
pointer); a :class:`FlywheelController` on the serve side subscribes
to that pointer and closes the loop:

    publish → eval gate → canary (bounded fraction of one pool,
    per-version SLO burn split) → hold window → promote fleet-wide
                                 ↘ burn breach / anomaly spike →
                                   auto-rollback to last-good

Every stage is built from seams that already survive chaos: the
pointer validates like the data-position journal (a torn publish reads
as "nothing new"), the canary uses the fleet's surge-then-drain swap
(zero accepted requests dropped, ``route(version=)`` keeps in-flight
requests bit-identical to the build that seated them), and rollback
is the serve-side twin of the trainer's loss-spike rollback — bounded
budget, ``fleet_rollback_total{model,reason}``, flight records. A
spent budget HALTS deployment (no new canaries) while the last-good
build keeps serving: persistent bad candidates are a bug upstream,
not weather.

The controller is a pure function of (clock, pointer, burn signals):
tests inject the clock and single-step :meth:`FlywheelController
.tick`; production calls :meth:`start` for the background thread.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ... import telemetry
from ...base import ManifestError, env_float, env_int
from ...telemetry import distributed as dtrace

__all__ = ["FlywheelController"]


class FlywheelController:
    """Watches a checkpoint directory's ``latest-published`` pointer
    and deploys candidates into ``fleet``'s ``model`` pool through
    canary → promote/rollback.

    ``load_candidate(pointer) -> params`` turns a pointer record
    (``step``/``seq``/publisher metadata) into a weight pytree for
    the pool's engine factory — typically a
    ``CheckpointManager.restore(step, ...)`` plus whatever export the
    serving weights need. It MUST raise on a torn/partial candidate
    (the checkpoint's manifest and leaf hashes do this for free): the
    candidate is then rejected and counted, and live traffic is never
    touched.

    ``eval_gate(pointer, params) -> bool`` (optional) vetoes a
    candidate before any replica changes — the configurable offline
    eval. A gate that raises counts as a veto, loudly.

    Burn gating reads the per-version TTFT split
    (``Gateway.version_ttft``): one
    :class:`~mxtpu_torch.telemetry.distributed.SLOTracker` per live build,
    compared against ``burn_high``; a Perfscope step-anomaly delta
    above ``anomaly_budget`` during the canary window is the second
    tripwire. ``slo`` defaults to the model's :class:`~.fleet
    .ModelSpec` targets; without targets, burn gating is off and only
    anomalies/hold-ticks govern."""

    def __init__(self, fleet, model: str, directory: str, *,
                 load_candidate: Callable[[Dict[str, Any]], Any],
                 eval_gate: Optional[Callable[..., bool]] = None,
                 canary_fraction: Optional[float] = None,
                 hold_ticks: Optional[int] = None,
                 burn_high: Optional[float] = None,
                 max_rollbacks: Optional[int] = None,
                 anomaly_budget: Optional[int] = None,
                 poll_s: Optional[float] = None,
                 slo: Optional[Dict[str, float]] = None,
                 drain_timeout_s: float = 120.0,
                 clock: Optional[Callable[[], float]] = None):
        self.fleet = fleet
        self.model = model
        self.directory = directory
        self.load_candidate = load_candidate
        self.eval_gate = eval_gate
        self._clock = clock or time.monotonic
        self.fraction = canary_fraction if canary_fraction is not None \
            else env_float(
                "MXTPU_FLYWHEEL_CANARY_FRACTION", 0.25,
                "Flywheel: fraction of a model's pool (>= 1 replica) "
                "a candidate build canaries into before promotion.")
        self.hold_ticks = hold_ticks if hold_ticks is not None \
            else env_int(
                "MXTPU_FLYWHEEL_HOLD_TICKS", 3,
                "Flywheel: consecutive clean controller ticks a "
                "canary must hold before fleet-wide promotion.")
        self.burn_high = burn_high if burn_high is not None \
            else env_float(
                "MXTPU_FLYWHEEL_BURN_HIGH", 1.0,
                "Flywheel: canary-version SLO burn rate above this "
                "triggers auto-rollback to the last-good build.")
        self.max_rollbacks = max_rollbacks if max_rollbacks is not None \
            else env_int(
                "MXTPU_FLYWHEEL_MAX_ROLLBACKS", 2,
                "Flywheel: auto-rollback budget per controller; once "
                "spent the flywheel HALTS (no new canaries) while "
                "the last-good build keeps serving.")
        self.anomaly_budget = anomaly_budget \
            if anomaly_budget is not None else env_int(
                "MXTPU_FLYWHEEL_ANOMALY_BUDGET", 2,
                "Flywheel: Perfscope step anomalies tolerated during "
                "one canary window before auto-rollback.")
        self.poll_s = poll_s if poll_s is not None else env_float(
            "MXTPU_FLYWHEEL_POLL_S", 2.0,
            "Flywheel: background controller tick period (pointer "
            "poll + canary burn assessment).")
        self.drain_timeout_s = float(drain_timeout_s)
        entry = fleet._entry(model)
        self._slo_spec = slo if slo is not None else entry.spec.slo
        self.phase = "idle"            # idle | canary
        self.halted = False
        self.rolling_back = False
        self.seen_seq = -1             # highest pointer seq processed
        self.rollbacks = 0
        self.canary: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, Any]] = []   # bounded: _note()
        self._trackers: Dict[str, Any] = {}
        self._anom0 = 0.0
        self._m_cand: Dict[str, Any] = {}
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        fleet.attach_flywheel(model, self)

    # -- bookkeeping ---------------------------------------------------------
    def _count(self, result: str) -> None:
        m = self._m_cand.get(result)
        if m is None:
            m = self._m_cand[result] = telemetry.counter(
                "fleet_candidates_total",
                "Published candidates by flywheel outcome (canaried/"
                "promoted/rolled_back/rejected_torn/rejected_gate/"
                "torn_pointer).", model=self.model, result=result)
        m.inc()

    def _note(self, action: str, **kw) -> Dict[str, Any]:
        rec = dict(kw, t=self._clock(), action=action,
                   model=self.model)
        telemetry.flight().record("flywheel", action, **{
            k: v for k, v in rec.items() if k != "action"})
        self.history.append(rec)
        del self.history[:-32]
        return rec

    def _anomaly_total(self) -> float:
        """Fleet-wide Perfscope step-anomaly count (summed over
        programs) — the canary window compares deltas against
        ``anomaly_budget``."""
        samples = dtrace.parse_prometheus(
            telemetry.prometheus())["samples"]
        return sum(v for (name, _), v in samples.items()
                   if name == "mxtpu_step_anomalies_total")

    def _poll_pointer(self) -> Optional[Dict[str, Any]]:
        from ... import checkpoint
        try:
            return checkpoint.read_published(self.directory)
        except ManifestError as e:
            # torn mid-publish (a kill beat the manifest commit):
            # skipped exactly like a torn journal — the incumbent
            # keeps serving, the next publish supersedes
            self._count("torn_pointer")
            self._note("torn_pointer", error=str(e))
            return None

    # -- the control loop ----------------------------------------------------
    def tick(self) -> List[Dict[str, Any]]:
        """One controller pass; returns the decisions made. Idle:
        poll the pointer, gate + canary a new candidate. Canary:
        assess per-version burn + anomaly delta, then promote on a
        clean hold window or roll back on a breach."""
        out: List[Dict[str, Any]] = []
        if self.phase == "idle":
            if self.halted:
                return out
            ptr = self._poll_pointer()
            if ptr is not None and int(ptr.get("seq", 0)) \
                    > self.seen_seq:
                self.seen_seq = int(ptr["seq"])
                out.extend(self._consider(ptr))
        elif self.phase == "canary":
            out.extend(self._assess())
        return out

    def _consider(self, ptr: Dict[str, Any]) -> List[Dict[str, Any]]:
        step, seq = int(ptr["step"]), int(ptr["seq"])
        try:
            params = self.load_candidate(ptr)
        except Exception as e:
            # torn/partial candidate: the pointer committed but the
            # checkpoint it names did not survive — reject WITHOUT
            # touching live traffic
            self._count("rejected_torn")
            return [self._note("candidate_rejected", step=step,
                               seq=seq, reason="torn",
                               error=f"{type(e).__name__}: {e}")]
        if self.eval_gate is not None:
            try:
                ok = bool(self.eval_gate(ptr, params))
            except Exception as e:
                ok = False
                self._note("gate_error", step=step, seq=seq,
                           error=f"{type(e).__name__}: {e}")
            if not ok:
                self._count("rejected_gate")
                return [self._note("candidate_rejected", step=step,
                                   seq=seq, reason="gate")]
        res = self.fleet.canary_swap(
            self.model, params=params, fraction=self.fraction,
            drain_timeout_s=self.drain_timeout_s)
        self.phase = "canary"
        self.canary = {"version": res["version"],
                       "from_version": res["from_version"],
                       "step": step, "seq": seq,
                       "canaries": res["canaries"], "of": res["of"],
                       "clean_ticks": 0}
        self._arm_burn_split(res["version"], res["from_version"])
        self._anom0 = self._anomaly_total()
        self._count("canaried")
        return [self._note("canary", step=step, seq=seq,
                           version=res["version"],
                           from_version=res["from_version"],
                           canaries=res["canaries"], of=res["of"])]

    def _arm_burn_split(self, new: str, old: str) -> None:
        """One SLOTracker per live build over the per-version TTFT
        histograms — the split that lets a canary burn without the
        incumbent muddying the signal."""
        self._trackers = {}
        if not self._slo_spec:
            return
        gw = self.fleet.gateway(self.model)
        for ver in (new, old):
            tr = dtrace.SLOTracker.from_spec(
                dict(self._slo_spec), clock=self._clock,
                instruments={"ttft": gw.version_ttft(ver)},
                labels={"model": self.model, "version": ver})
            if tr is not None:
                tr.tick(force=True)    # baseline the interval window
                self._trackers[ver] = tr

    def burn(self) -> Dict[str, Optional[float]]:
        """Last-computed burn per live build (diagnose's per-version
        burn column; empty outside a canary or without SLO targets)."""
        out: Dict[str, Optional[float]] = {}
        for ver, tr in self._trackers.items():
            burns = [v.get("burn") for v in
                     tr.describe()["slos"].values()
                     if v.get("burn") is not None]
            out[ver] = max(burns) if burns else None
        return out

    def _assess(self) -> List[Dict[str, Any]]:
        can = self.canary
        burn = None
        tr = self._trackers.get(can["version"])
        if tr is not None:
            snap = tr.tick(force=True)
            burns = [v.get("burn") for v in snap.values()
                     if v.get("burn") is not None]
            burn = max(burns) if burns else None
        base = self._trackers.get(can["from_version"])
        if base is not None:
            base.tick(force=True)      # keep the incumbent split live
        anomalies = self._anomaly_total() - self._anom0
        if burn is not None and burn > self.burn_high:
            return [self._rollback("slo_burn", burn=round(burn, 3))]
        if anomalies > self.anomaly_budget:
            return [self._rollback("anomaly",
                                   anomalies=int(anomalies))]
        can["clean_ticks"] += 1
        if can["clean_ticks"] < self.hold_ticks:
            return []
        res = self.fleet.promote(self.model,
                                 drain_timeout_s=self.drain_timeout_s)
        self.phase = "idle"
        self.canary = None
        self._trackers = {}
        self._count("promoted")
        return [self._note("promote", step=can["step"],
                           seq=can["seq"], version=res["version"],
                           swapped=res["swapped"])]

    def _rollback(self, reason: str, **kw) -> Dict[str, Any]:
        can = self.canary
        self.rollbacks += 1
        self.rolling_back = True
        try:
            res = self.fleet.rollback(
                self.model, reason=reason,
                drain_timeout_s=self.drain_timeout_s)
        finally:
            self.rolling_back = False
        self.phase = "idle"
        self.canary = None
        self._trackers = {}
        self._count("rolled_back")
        rec = self._note("rollback", step=can["step"], seq=can["seq"],
                         version=can["version"],
                         to_version=res["version"], reason=reason,
                         budget_left=self.max_rollbacks
                         - self.rollbacks, **kw)
        if self.rollbacks >= self.max_rollbacks:
            # budget spent: stop DEPLOYING (the last-good build keeps
            # serving) — repeated bad candidates mean the trainer or
            # the gate is broken, and a halted flywheel is a /healthz
            # cause an operator will actually see
            self.halted = True
            self._note("halt", rollbacks=self.rollbacks,
                       budget=self.max_rollbacks)
        return rec

    # -- surfaces ------------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        """GET /state block + ``diagnose flywheel``: phase, pending
        candidate, per-version burn, decision history with reasons."""
        return {"model": self.model, "directory": self.directory,
                "phase": self.phase, "halted": self.halted,
                "seen_seq": self.seen_seq,
                "fraction": self.fraction,
                "hold_ticks": self.hold_ticks,
                "burn_high": self.burn_high,
                "rollbacks": self.rollbacks,
                "max_rollbacks": self.max_rollbacks,
                "canary": dict(self.canary) if self.canary else None,
                "burn": self.burn(),
                "history": [dict(h) for h in self.history[-8:]]}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FlywheelController":
        """Run the controller on a background thread at ``poll_s``
        cadence (tests call :meth:`tick` directly instead)."""
        if self._thread is not None:
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"mxtpu-flywheel-{self.model}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.tick()
            except Exception:
                # deployment must never die quietly; the flight ring
                # has the event, the next tick retries
                telemetry.flight().record("flywheel", "tick_error",
                                          model=self.model)

    def close(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
