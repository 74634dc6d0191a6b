"""The fleet control plane: multi-model, multi-tenant serving over
the gateway — the port of ``mxtpu/serve/fleet/fleet.py`` (host code
over the port's engines; the serving path launches none of the port's
hand kernels).

One :class:`FleetGateway` fronts N named models. Each model gets its
OWN full gateway stack — journal, supervisor, SLO tracker, shed tiers
— over a :class:`FleetPool` (a versioned :class:`ReplicaSet`); the
fleet layer adds what no single-model gateway can do:

- **named-model routing**: ``model=`` in the request body picks the
  pool; per-model series (``gateway_requests_total{model}``,
  ``gateway_ttft_ms{model}``, per-model SLO gauges) coexist in one
  registry, single-model series names grandfathered unchanged;
- **chip arbitration**: one :class:`~.arbiter.FleetArbiter` moves
  replicas' worth of chips between pools by SLO burn + queue
  pressure, replacing per-model autoscaling;
- **priority classes**: ``priority=interactive|batch|offline`` rides
  the gateway's shed tiers — low classes see a fraction of the queue
  bound and yield outright under SLO burn;
- **live checkpoint hot-swap** (:meth:`FleetGateway.hot_swap`): new
  weights in, zero accepted requests dropped — surge a fresh replica
  per old one, drain the old (it finishes everything it accepted, on
  the old build: bit-identity holds), version label on every
  response;
- **session affinity**: a returning ``session_id`` lands on the
  replica already KV-warm for it (bounded LRU map, hit/miss
  counters).

The front door is the EXISTING ``frontdoor.serve_http`` — the fleet
gateway implements the same four-method surface (``submit_dict`` /
``health`` / ``state`` / ``metrics_text``), so clients, the chaos
harness and ``tools/diagnose.py`` all work unchanged.
"""
from __future__ import annotations

import inspect
import itertools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from ... import telemetry
from ...base import env_int, env_str
from ...telemetry import distributed as dtrace
from ...telemetry.perfscope import goodput_gauge
from ..engine import ServeEngine
from ..gateway.gateway import Gateway
from ..gateway.replica import GatewayClosed, ReplicaSet
from .arbiter import ArbiterPolicy, FleetArbiter

__all__ = ["ModelSpec", "FleetPool", "FleetGateway"]


@dataclass
class ModelSpec:
    """One named model of the fleet: how to build its engines, its
    initial/bounded pool size, its chip cost, and its SLO targets.

    ``engine_factory`` must be zero-arg callable; to hot-swap by
    ``params=``/``path=`` it must ALSO accept a ``params=`` keyword
    (write it ``lambda params=params0: ServeEngine(cfg, params,
    ...)`` — the swap calls it with the reloaded weights)."""

    name: str
    engine_factory: Callable[..., ServeEngine]
    replicas: int = 1
    min_replicas: int = 1
    max_replicas: int = 4
    chips_per_replica: int = 1
    version: str = "v0"
    queue_max: Optional[int] = None
    # per-model SLO targets (SLOTracker.from_spec keys: ttft_ms,
    # token_ms, burn, window_s); None falls back to the env knobs
    slo: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if not self.name or any(c in self.name for c in '"\n '):
            raise ValueError(f"bad model name {self.name!r} (label "
                             f"value: no quotes/whitespace)")
        if self.replicas < 1:
            raise ValueError(f"{self.name}: need >= 1 replica")
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"{self.name}: bad replica bounds "
                f"[{self.min_replicas}, {self.max_replicas}]")
        if not (self.min_replicas <= self.replicas
                <= self.max_replicas):
            raise ValueError(
                f"{self.name}: initial replicas {self.replicas} "
                f"outside [{self.min_replicas}, "
                f"{self.max_replicas}]")
        if self.chips_per_replica < 1:
            raise ValueError(f"{self.name}: chips_per_replica >= 1")


class FleetPool(ReplicaSet):
    """A model's replica pool: a :class:`ReplicaSet` whose replicas
    carry the pool's current BUILD VERSION (stamped at spawn — the
    hot-swap seam every response labels) and whose scaling bounds /
    chip cost the fleet arbiter reads."""

    def __init__(self, spec: ModelSpec, *, started: bool = True):
        self.spec = spec
        self.model = spec.name
        self.version = spec.version
        self.chips_per_replica = spec.chips_per_replica
        self.min_replicas = spec.min_replicas
        self.max_replicas = spec.max_replicas
        super().__init__(spec.engine_factory, spec.replicas,
                         started=started,
                         name_prefix=f"{spec.name}:r",
                         labels={"model": spec.name})

    def _new_replica(self):
        r = super()._new_replica()
        # version rides the replica AND its engine: route() filters
        # on the former for same-build resume, trace events carry the
        # latter so timelines show which build served each segment
        r.version = self.version
        r.engine.build = self.version
        return r


class _ModelEntry:
    __slots__ = ("spec", "pool", "gateway", "swap_seq", "last_good",
                 "canary")

    def __init__(self, spec: ModelSpec, pool: FleetPool,
                 gateway: Gateway):
        self.spec = spec
        self.pool = pool
        self.gateway = gateway
        self.swap_seq = itertools.count(1)
        # rollback anchor: (engine_factory, version) of the build that
        # last served cleanly — captured before any swap touches the
        # pool, restored verbatim by rollback()
        self.last_good: Optional[tuple] = None
        # live canary descriptor (None outside a canary window)
        self.canary: Optional[Dict[str, Any]] = None


class FleetGateway:
    """N named models behind ONE front door on one chip budget.

    ``models``: the :class:`ModelSpec` list. ``arbiter``: an
    :class:`~.arbiter.ArbiterPolicy` (or dict of its fields) enabling
    the background arbitration loop; None disables (tests drive
    :attr:`arbiter` ticks directly after constructing their own).
    ``chip_budget`` overrides the policy's (0 = derived from the
    initial allocation). Remaining kwargs forward to each per-model
    :class:`Gateway` (supervision, queue bound default, clock)."""

    def __init__(self, models: Sequence[ModelSpec], *,
                 arbiter=None, chip_budget: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 supervise: bool = True,
                 supervisor_opts: Optional[Dict[str, Any]] = None,
                 federate=None, started: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        if not models:
            raise ValueError("need at least one ModelSpec")
        self._clock = clock or time.monotonic
        self._closed = False
        self._models: "OrderedDict[str, _ModelEntry]" = OrderedDict()
        for spec in models:
            if spec.name in self._models:
                raise ValueError(f"duplicate model {spec.name!r}")
            pool = FleetPool(spec, started=started)
            gw = Gateway(backend=pool, model=spec.name,
                         queue_max=(spec.queue_max
                                    if spec.queue_max is not None
                                    else queue_max),
                         slo=spec.slo, supervise=supervise,
                         supervisor_opts=supervisor_opts,
                         federate=[],   # the FLEET federates, once
                         clock=clock)
            self._models[spec.name] = _ModelEntry(spec, pool, gw)
        # session affinity: bounded LRU of (model, session) -> the
        # replica name that served it last (KV-warm for the session's
        # running context)
        self._aff_lock = threading.Lock()
        self._affinity: "OrderedDict[tuple, str]" = OrderedDict()
        self._aff_max = env_int(
            "MXTPU_FLEET_SESSIONS_MAX", 4096,
            "Bound on the fleet session-affinity map (LRU evicted): "
            "returning session_ids route to the replica that served "
            "them last.")
        self._m_aff: Dict[str, Any] = {}
        self._m_swap: Dict[str, Any] = {}
        self._m_canary: Dict[str, Any] = {}
        self._m_rollback: Dict[tuple, Any] = {}
        # attached FlywheelControllers by model (continuous-deployment
        # state surfaced in /healthz + /state; see flywheel.py)
        self._flywheels: Dict[str, Any] = {}
        # the fleet federates ONCE (per-model gateways get no peers):
        # same env knob + secret discipline as the single-model door
        if federate is None:
            federate = env_str(
                "MXTPU_TELEMETRY_FEDERATE", "",
                "Comma-separated host:port list of peer "
                "RegistryServer endpoints the gateway /metrics "
                "federates (per-process series labelled "
                "process=<role>, plus exact aggregate series).")
        self._federate = Gateway._parse_peers(federate)
        self._fed_secret = env_str("MXTPU_GATEWAY_SECRET",
                                   "").encode()
        self._g_goodput = goodput_gauge("fleet")
        self._prev_req: Optional[tuple] = None
        self._http = None
        self.arbiter: Optional[FleetArbiter] = None
        self._arbiter_stop: Optional[threading.Event] = None
        if arbiter is not None:
            policy = (arbiter if isinstance(arbiter, ArbiterPolicy)
                      else ArbiterPolicy(**dict(arbiter)))
            if chip_budget is not None:
                policy.chip_budget = int(chip_budget)
            self.arbiter = FleetArbiter(self._models, policy,
                                        clock=clock)
            self._arbiter_stop = threading.Event()
            threading.Thread(target=self.arbiter.run_forever,
                             args=(self._arbiter_stop,), daemon=True,
                             name="mxtpu-fleet-arbiter").start()

    # -- registry ------------------------------------------------------------
    def models(self) -> List[str]:
        return list(self._models)

    def gateway(self, model: str) -> Gateway:
        """The per-model gateway (tests/tools; raises on unknown)."""
        return self._entry(model).gateway

    def pool(self, model: str) -> FleetPool:
        return self._entry(model).pool

    def _entry(self, model: Optional[str]) -> _ModelEntry:
        if model is None:
            if len(self._models) == 1:
                return next(iter(self._models.values()))
            raise ValueError(
                f"missing 'model'; this fleet serves "
                f"{list(self._models)}")
        entry = self._models.get(model)
        if entry is None:
            raise ValueError(f"unknown model {model!r}; serving "
                             f"{list(self._models)}")
        return entry

    # -- session affinity ----------------------------------------------------
    def _count_aff(self, result: str) -> None:
        m = self._m_aff.get(result)
        if m is None:
            m = self._m_aff[result] = telemetry.counter(
                "fleet_session_affinity_total",
                "Session-affinity lookups at the fleet router: hit = "
                "routed to the remembered warm replica, miss = first "
                "sight or the replica is gone, prefix = the session "
                "map missed but prefix-page affinity found a replica "
                "already holding the prompt's pages", result=result)
        m.inc()

    def _affinity_get(self, model: str,
                      session: Optional[str]) -> Optional[str]:
        if session is None:
            return None
        with self._aff_lock:
            return self._affinity.get((model, session))

    def _affinity_record(self, model: str, session: Optional[str],
                         prefer: Optional[str], handle) -> None:
        if session is None:
            return
        rep = getattr(handle.ticket, "replica", None)
        name = getattr(rep, "name", None)
        if name is None:
            return
        self._count_aff("hit" if prefer is not None
                        and name == prefer else "miss")
        key = (model, session)
        with self._aff_lock:
            self._affinity[key] = name
            self._affinity.move_to_end(key)
            while len(self._affinity) > self._aff_max:
                self._affinity.popitem(last=False)

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               model: Optional[str] = None,
               session_id: Optional[str] = None, **kw):
        """Direct-API submission (the HTTP path is
        :meth:`submit_dict`): resolves the model, applies session
        affinity, delegates to that model's gateway — every per-model
        admission rule (priority classes, shed tiers, SLO burn)
        applies there."""
        entry = self._entry(model)
        session = None if session_id is None else str(session_id)
        sess_prefer = self._affinity_get(entry.spec.name, session)
        prefer = sess_prefer
        if prefer is None:
            # session map missed (stale entry, evicted, or no
            # session_id at all): fall back to prefix-page affinity —
            # the per-model gateway knows which replica's paged cache
            # already holds this prompt's head, so a returning
            # conversation still lands on its warm pages
            prefer = entry.gateway.prefix_prefer(prompt)
            if prefer is not None:
                self._count_aff("prefix")
        handle = entry.gateway.submit(
            prompt, max_new_tokens, prefer_replica=prefer, **kw)
        self._affinity_record(entry.spec.name, session, sess_prefer,
                              handle)
        return handle

    def submit_dict(self, body: Dict[str, Any],
                    trace_id: Optional[str] = None):
        """The front door's JSON surface: ``model`` picks the pool
        (optional only for a one-model fleet), ``session_id`` routes
        a returning session to its warm replica, everything else is
        the per-model gateway's contract unchanged."""
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        model = body.get("model")
        entry = self._entry(None if model is None else str(model))
        session = body.get("session_id")
        session = None if session is None else str(session)
        sess_prefer = self._affinity_get(entry.spec.name, session)
        prefer = sess_prefer
        if prefer is None and body.get("prompt") is not None:
            # same prefix-page fallback as submit(): a session-map
            # miss still routes to the replica holding warm pages
            prefer = entry.gateway.prefix_prefer(body["prompt"])
            if prefer is not None:
                self._count_aff("prefix")
        handle = entry.gateway.submit_dict(body, trace_id=trace_id,
                                           prefer_replica=prefer)
        self._affinity_record(entry.spec.name, session, sess_prefer,
                              handle)
        return handle

    # -- hot swap ------------------------------------------------------------
    def hot_swap(self, model: str, *, params: Any = None,
                 path: Optional[str] = None,
                 engine_factory: Optional[Callable[[],
                                                   ServeEngine]] = None,
                 version: Optional[str] = None,
                 drain_timeout_s: float = 120.0) -> Dict[str, Any]:
        """Replace a pool's weights LIVE, dropping nothing: for each
        old replica, a fresh one is spawned from the new build FIRST
        (capacity never dips below the allocation), then the old one
        is drained — it finishes every request it accepted, on the
        old build, so completed streams stay bit-identical to a
        fault-free old-build run. New requests route to the
        least-loaded (fresh) replicas; every response's ``version``
        field names the build that produced it.

        New weights come from exactly one of: ``params`` (a pytree),
        ``path`` (a ``checkpoint.save_state`` snapshot — loaded here
        once, onto the pool's device, and shared by every replica the
        swap spawns), or ``engine_factory`` (full control).
        ``version`` defaults to ``v<n>`` counting per model."""
        entry = self._entry(model)
        pool = entry.pool
        engine_factory = self._resolve_factory(
            entry, params=params, path=path,
            engine_factory=engine_factory)
        version = version or f"v{next(entry.swap_seq)}"
        old = pool.replicas()
        old_version = pool.version
        entry.last_good = (pool._factory, old_version)
        entry.canary = None            # a full swap ends any canary
        pool.set_factory(engine_factory, version)
        telemetry.flight().record(
            "fleet", "swap_begin", model=model,
            from_version=old_version, to_version=version,
            replicas=len(old))
        swapped, still = self._swap_out(entry, old, drain_timeout_s)
        m = self._m_swap.get(model)
        if m is None:
            m = self._m_swap[model] = telemetry.counter(
                "fleet_swap_total",
                "Completed live checkpoint hot-swaps, by model",
                model=model)
        m.inc()
        telemetry.flight().record(
            "fleet", "swap_done", model=model, to_version=version,
            swapped=swapped, still_draining=len(still))
        return {"model": model, "version": version,
                "from_version": old_version, "swapped": swapped,
                "still_draining": still}

    def _resolve_factory(self, entry: _ModelEntry, *,
                         params: Any = None,
                         path: Optional[str] = None,
                         engine_factory=None):
        """Turn (params | path | engine_factory) into a zero-arg
        engine factory — the validation hot_swap always did, shared
        with the canary path."""
        if engine_factory is not None:
            return engine_factory
        if path is not None:
            from ... import checkpoint
            params = checkpoint.load_state(
                path, device=self._pool_device(entry))
        if params is None:
            raise ValueError(
                "hot_swap needs params=, path= or engine_factory=")
        base = entry.spec.engine_factory
        try:
            inspect.signature(base).bind_partial(params=params)
        except TypeError:
            raise ValueError(
                f"model {entry.spec.name!r}'s engine_factory does "
                f"not accept a params= keyword; hot-swap by "
                f"params/path requires a factory like "
                f"`lambda params=params0: ServeEngine(cfg, "
                f"params, ...)`") from None
        p = params
        return lambda p=p: base(params=p)

    @staticmethod
    def _pool_device(entry: _ModelEntry):
        """The device the pool's engines serve from: a checkpoint loaded
        for a swap lands there once, since an engine uses its params in
        place and refuses params anywhere else."""
        reps = entry.pool.replicas()
        if not reps:
            raise GatewayClosed(
                f"fleet pool {entry.spec.name!r} has no replica")
        return reps[0].engine.device

    def _swap_out(self, entry: _ModelEntry, targets,
                  drain_timeout_s: float):
        """Surge-then-drain ``targets`` out of the pool (one fresh
        replica spawned from the CURRENT factory per target, then the
        target drains — it finishes everything it accepted on the
        build that seated it). Returns ``(swapped, still_draining)``.
        Capacity never dips below the allocation; the transient +1
        replica shows in the arbiter's next ledger tick."""
        pool = entry.pool
        swapped = 0
        for r in targets:
            fresh = pool.spawn_replica()
            if fresh is None:
                raise GatewayClosed(
                    f"fleet pool {entry.spec.name!r} closed mid-swap")
            if pool.drain_replica(r):
                swapped += 1
        deadline = self._clock() + float(drain_timeout_s)
        still = []
        for r in targets:
            t = r._thread
            if t is not None:
                t.join(max(0.0, deadline - self._clock()))
                if t.is_alive():
                    still.append(r.name)
        return swapped, still

    # -- canary / promote / rollback (the flywheel's verbs) ------------------
    def canary_swap(self, model: str, *, params: Any = None,
                    path: Optional[str] = None,
                    engine_factory=None,
                    version: Optional[str] = None,
                    fraction: float = 0.25,
                    drain_timeout_s: float = 120.0) -> Dict[str, Any]:
        """Swap a candidate build into a bounded FRACTION of the pool
        (at least one replica) instead of all of it: the pool's
        factory/version move to the candidate, but only
        ``max(1, round(fraction * size))`` replicas are surged+drained
        — the rest keep serving the incumbent build, and ``route
        (version=)`` keeps in-flight requests on the build that seated
        them. The incumbent (factory, version) is recorded as the
        rollback anchor. NOTE: a supervisor respawn during the canary
        window comes up on the CANDIDATE build (the pool factory), so
        the canary fraction can only grow until promote/rollback
        settles it."""
        entry = self._entry(model)
        pool = entry.pool
        engine_factory = self._resolve_factory(
            entry, params=params, path=path,
            engine_factory=engine_factory)
        version = version or f"v{next(entry.swap_seq)}"
        old = pool.replicas()
        old_version = pool.version
        n = min(len(old), max(1, int(round(float(fraction)
                                           * len(old)))))
        entry.last_good = (pool._factory, old_version)
        pool.set_factory(engine_factory, version)
        entry.canary = {"version": version,
                        "from_version": old_version,
                        "replicas": n, "of": len(old)}
        telemetry.flight().record(
            "fleet", "canary_begin", model=model,
            from_version=old_version, to_version=version,
            canaries=n, pool=len(old))
        swapped, still = self._swap_out(entry, old[:n],
                                        drain_timeout_s)
        m = self._m_canary.get(model)
        if m is None:
            m = self._m_canary[model] = telemetry.counter(
                "fleet_canary_total",
                "Candidate builds canaried into a bounded fraction "
                "of a pool, by model", model=model)
        m.inc()
        return {"model": model, "version": version,
                "from_version": old_version, "canaries": n,
                "of": len(old), "swapped": swapped,
                "still_draining": still}

    def promote(self, model: str, *,
                drain_timeout_s: float = 120.0) -> Dict[str, Any]:
        """Finish a clean canary: surge+drain the REMAINING incumbent
        replicas onto the pool's current (candidate) build. The
        promoted build becomes the next rollback anchor."""
        entry = self._entry(model)
        pool = entry.pool
        version = pool.version
        targets = [r for r in pool.replicas()
                   if getattr(r, "version", None) != version]
        telemetry.flight().record(
            "fleet", "promote", model=model, to_version=version,
            remaining=len(targets))
        swapped, still = self._swap_out(entry, targets,
                                        drain_timeout_s)
        entry.canary = None
        entry.last_good = (pool._factory, version)
        m = self._m_swap.get(model)
        if m is None:
            m = self._m_swap[model] = telemetry.counter(
                "fleet_swap_total",
                "Completed live checkpoint hot-swaps, by model",
                model=model)
        m.inc()
        return {"model": model, "version": version,
                "swapped": swapped, "still_draining": still}

    def rollback(self, model: str, *, reason: str = "breach",
                 drain_timeout_s: float = 120.0) -> Dict[str, Any]:
        """The serve-side twin of a trainer's loss-spike rollback:
        re-seat the pool on the LAST-GOOD build — every replica not
        already on it is surged+drained away, in-flight
        requests finish bit-identically on whichever build seated
        them. Counted in ``fleet_rollback_total{model,reason}`` and
        flight-recorded with the reason (the operator's first grep
        after a bad deploy)."""
        entry = self._entry(model)
        pool = entry.pool
        if entry.last_good is None:
            raise ValueError(
                f"model {model!r} has no last-good build recorded "
                f"(nothing was ever swapped); rollback is undefined")
        factory, version = entry.last_good
        bad_version = pool.version
        pool.set_factory(factory, version)
        targets = [r for r in pool.replicas()
                   if getattr(r, "version", None) != version]
        telemetry.flight().record(
            "fleet", "rollback_begin", model=model, reason=reason,
            from_version=bad_version, to_version=version,
            replicas=len(targets))
        swapped, still = self._swap_out(entry, targets,
                                        drain_timeout_s)
        entry.canary = None
        key = (model, reason)
        m = self._m_rollback.get(key)
        if m is None:
            m = self._m_rollback[key] = telemetry.counter(
                "fleet_rollback_total",
                "Serve-side rollbacks to the last-good build, by "
                "model and reason (slo_burn/anomaly/manual...)",
                model=model, reason=reason)
        m.inc()
        telemetry.flight().record(
            "fleet", "rollback_done", model=model, reason=reason,
            to_version=version, swapped=swapped,
            still_draining=len(still))
        return {"model": model, "version": version,
                "from_version": bad_version, "reason": reason,
                "swapped": swapped, "still_draining": still}

    # -- flywheel / training tenant ------------------------------------------
    def register_tenant(self, tenant, *,
                        chips: Optional[int] = None) -> None:
        """Register a non-serving arbiter tenant (a trainer's
        :class:`~.arbiter.TrainingTenant`): its chips join
        the fleet budget and the arbiter lends/borrows between it and
        the pools. Requires the fleet to have been built with an
        arbiter policy."""
        if self.arbiter is None:
            raise ValueError(
                "this fleet has no arbiter (pass arbiter= to "
                "FleetGateway) — nothing would lend chips")
        self.arbiter.register(tenant.name, tenant, chips=chips)

    def attach_flywheel(self, model: str, controller) -> None:
        """Hang a :class:`~.flywheel.FlywheelController` off the fleet
        so ``/healthz``/``/state`` (and ``diagnose flywheel``) surface
        its phase, canary and decision history. Called by the
        controller's constructor."""
        self._entry(model)             # validate the name
        self._flywheels[model] = controller

    # -- observability -------------------------------------------------------
    def _update_goodput(self) -> None:
        """``mxtpu_goodput_ratio{loop="fleet"}``: the fraction of
        front-door traffic ADMITTED over the interval since the last
        scrape — the serving-tier analog of the train loops'
        useful-fraction (a shed request is wall time the fleet could
        not turn into tokens). Only written when the window saw
        traffic."""
        reg = telemetry.registry()
        acc = shed = 0.0
        for name in list(self._models):
            acc += reg.value("gateway_requests_total",
                             code="accepted", model=name)
            for code in ("429", "503"):
                shed += reg.value("gateway_requests_total",
                                  code=code, model=name)
        prev, self._prev_req = self._prev_req, (acc, shed)
        if prev is None:
            return
        da, ds = acc - prev[0], shed - prev[1]
        if da + ds > 0:
            self._g_goodput.set(da / (da + ds))

    def metrics_text(self) -> str:
        """GET /metrics: every model's series in one scrape (the
        per-model labels keep them apart), federated across peer
        processes when configured."""
        for entry in self._models.values():
            entry.gateway.refresh_gauges()
            if entry.gateway.slo is not None:
                entry.gateway.slo.tick()
        self._update_goodput()
        if self._federate:
            return dtrace.federate_text(
                telemetry.registry(), self._federate,
                process=telemetry.process_role(),
                secret=self._fed_secret)
        return telemetry.prometheus()

    def _health_causes(self, name: str,
                       h: Dict[str, Any]) -> List[str]:
        """Name WHY a model reads degraded (the aggregation a single
        /healthz probe needs to see a sick tenant): each cause is a
        stable token an alert can match on."""
        causes = []
        if h.get("tier", 0) > 0:
            causes.append(f"shed_tier_{h['tier']}")
        if h.get("healthy_replicas") == 0:
            causes.append("no_healthy_replicas")
        br = h.get("breaker")
        if br is not None and br.get("state") != "closed":
            causes.append("breaker_open")
        sup = h.get("supervisor")
        if sup:
            if sup.get("pending_spawns"):
                causes.append("replica_respawn_pending")
            if sup.get("restarts", 0) >= sup.get("max_restarts",
                                                 1 << 30):
                causes.append("supervisor_exhausted")
        slo = h.get("slo")
        if slo and slo.get("breached"):
            causes.append("slo_burn")
        fly = self._flywheels.get(name)
        if fly is not None:
            if getattr(fly, "rolling_back", False):
                causes.append("rollback_active")
            if getattr(fly, "halted", False):
                causes.append("flywheel_halted")
        return causes

    def health(self) -> Dict[str, Any]:
        """GET /healthz: per-model health blocks — each annotated with
        its degraded CAUSES (breaker open, supervisor exhausted, SLO
        burn, active rollback...) — plus the fleet verdict and the
        list of degraded models, so one probe sees a sick tenant
        without walking N per-model doors."""
        per = {}
        degraded = []
        for name, entry in self._models.items():
            h = entry.gateway.health()
            causes = self._health_causes(name, h)
            h["causes"] = causes
            if causes or h["status"] != "ok":
                h["status"] = "degraded"
                degraded.append(name)
            per[name] = h
        return {"ok": True,
                "status": "degraded" if degraded else "ok",
                "degraded": degraded,
                "models": per}

    def state(self) -> Dict[str, Any]:
        """GET /state: per-model topology (each model's full gateway
        state + version/chips/bounds + the last arbiter decision that
        touched it) and the arbiter ledger — what ``diagnose fleet``
        renders."""
        models = {}
        for name, entry in self._models.items():
            st = entry.gateway.state()
            st["version"] = entry.pool.version
            st["chips_per_replica"] = entry.pool.chips_per_replica
            st["min_replicas"] = entry.pool.min_replicas
            st["max_replicas"] = entry.pool.max_replicas
            st["arbiter_last"] = (self.arbiter.last_decision(name)
                                  if self.arbiter else None)
            st["canary"] = (dict(entry.canary)
                            if entry.canary else None)
            models[name] = st
        with self._aff_lock:
            sessions = len(self._affinity)
        return {"models": models,
                "arbiter": (self.arbiter.describe()
                            if self.arbiter else None),
                "flywheel": {name: fly.describe()
                             for name, fly
                             in self._flywheels.items()},
                "affinity_sessions": sessions}

    # -- lifecycle -----------------------------------------------------------
    def start_http(self, host: str = "127.0.0.1",
                   port: Optional[int] = None) -> int:
        """Bind + serve the EXISTING HTTP front door (frontdoor.py
        works against the four-method surface this class implements);
        returns the bound port."""
        from ..gateway.frontdoor import serve_http
        if port is None:
            port = env_int(
                "MXTPU_GATEWAY_PORT", 9300,
                "Default TCP port of the gateway HTTP front door.")
        self._http, bound = serve_http(self, host, port)
        return bound

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fly in list(self._flywheels.values()):
            try:
                fly.close()
            except Exception:
                pass
        if self._arbiter_stop is not None:
            self._arbiter_stop.set()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        for entry in self._models.values():
            entry.gateway.close()
