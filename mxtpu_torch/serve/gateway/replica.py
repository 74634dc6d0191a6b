"""Engine replicas: N ``ServeEngine`` workers behind one router, plus
the supervision layer that keeps the set serving through replica
failure — the port of ``mxtpu/serve/gateway/replica.py`` (host code
over the port's engine).

A replica is a ``ServeEngine`` plus the thread running its
``run_forever`` loop. The set routes each request to the least-loaded
HEALTHY replica (queued + active, normalized by slot count — occupancy
routing, not round-robin: a replica stuck behind a long decode keeps
its queue short instead of stacking latecomers). ``scale_to`` is the
autoscaler's lever: scaling up starts fresh replicas from the factory;
scaling down REMOVES a replica from routing and signals its stop event
— the drained engine finishes every accepted request before its thread
exits, so a scale-down never drops work.

Failure model:

- a replica thread that DIES (an exception escaping the engine loop —
  a device error mid-decode, a chaos-injected raise) records its
  exception on the replica and flips :attr:`EngineReplica.failed`;
- a replica that STALLS (thread alive, work pending, but the engine's
  step counter stops advancing) is detected by the
  :class:`ReplicaSupervisor`'s step-progress heartbeat;
- either way the supervisor pulls the replica out of routing, spins up
  a replacement (bounded restarts + exponential backoff, every event
  in ``gateway_replica_restarts_total{reason}`` and the flight
  recorder), and hands the dead replica's in-flight requests back to
  the gateway for deterministic re-dispatch (``gateway.py``).

``route`` with zero healthy replicas raises
:class:`NoHealthyReplicas` — a DISTINCT error the front door turns
into 503 + ``Retry-After`` (shed loudly, never hang a client on a
backend nothing will serve).

Tokens are a per-request property of the engine (each slot replays its
own rng chain), so replication/routing/restart cannot change output —
the chaos tests pin bit-identity through an injected replica kill
under a Poisson client stream.

On the card each engine owns its decode CUDA graph: a restart builds
a fresh engine from the factory, which captures its own graph at its
first step; nothing of a dead engine is ever replayed.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ... import telemetry
from ...base import env_float, env_int
from ..engine import KVHandoff, Request, ServeEngine

__all__ = ["EngineReplica", "ReplicaSet", "ReplicaSupervisor",
           "Ticket", "NoHealthyReplicas", "GatewayClosed"]


class NoHealthyReplicas(RuntimeError):
    """``route`` found no live replica to carry the request (all dead
    or removed, restart budget exhausted, or the set is empty). The
    front door maps this to 503 + ``Retry-After`` — distinct from
    queue overload (429) and from a closed set
    (:class:`GatewayClosed`): the client should retry later, not
    slower."""


class GatewayClosed(RuntimeError):
    """The pool has been ``close()``d: every mutating surface
    (``route``, ``scale_to``, ``drain_replica``) raises this — one
    consistent refusal instead of the old mix of a plain RuntimeError
    on route and a silent no-op on scale_to. Subclasses RuntimeError
    so callers that already caught the closed-set RuntimeError (the
    gateway's submit path, supervisor races) keep working unchanged;
    loops that tick on a timer (autoscaler, fleet arbiter) catch it
    by name and stand down."""


class Ticket:
    """A routed request: where it landed and how to cancel it — the
    opaque handle Gateway keeps per in-flight request."""

    def __init__(self, replica: "EngineReplica", rid: int):
        self.replica = replica
        self.rid = rid

    def cancel(self, reason: str = "cancel") -> bool:
        return self.replica.cancel(self.rid, reason)

    def on_replica(self, replica: "EngineReplica") -> bool:
        """True when this request's fate is tied to ``replica`` — the
        supervisor's re-dispatch filter."""
        return self.replica is replica

    def dead(self) -> bool:
        """The carrying replica FAILED (crash/stall takedown — never a
        drain, which finishes its work): the gateway's periodic sweep
        re-dispatches journal entries this returns True for, catching
        a death that raced ticket registration."""
        return self.replica.failed


class EngineReplica:
    """One serving engine on its own daemon thread."""

    def __init__(self, engine: ServeEngine, name: str = "r0"):
        self.engine = engine
        # a replica serves indefinitely: results flow through the
        # on_token/on_done callbacks, so the engine must prune its
        # per-request bookkeeping instead of retaining it forever
        engine.retain_results = False
        # per-request trace events name the REPLICA, not "engine":
        # a crash-resumed request's timeline must show both banks
        engine.role = name
        self.name = name
        self.failed = False
        # model-build tag (fleet pools stamp this at spawn; the
        # response's `version` field and version-aware re-dispatch
        # read it). None for plain single-build sets.
        self.version: Optional[str] = None
        self.failure: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"mxtpu-gw-{self.name}")
        self._thread.start()

    def _run(self) -> None:
        """Thread body: an exception escaping the engine loop is a
        replica DEATH, not a silent thread exit — record it so the
        supervisor (and /state) can tell a crash from a drain."""
        try:
            self.engine.run_forever(self._stop)
        except BaseException as e:   # noqa: BLE001 — reported via state
            self.failure = e
            self.failed = True
            telemetry.flight().record(
                "gateway", "replica_died", replica=self.name,
                error=repr(e)[:200])

    def submit(self, req: Request) -> int:
        return self.engine.submit(req)

    def submit_prefilled(self, handoff: KVHandoff, req: Request) -> int:
        return self.engine.submit_prefilled(handoff, req)

    def cancel(self, rid: int, reason: str) -> bool:
        return self.engine.cancel(rid, reason)

    def load(self) -> Dict[str, int]:
        return self.engine.load()

    def stop(self, join: bool = False, timeout: float = 60.0) -> None:
        """Signal the loop to drain and exit; ``join=True`` waits."""
        self._stop.set()
        self.engine.wake()
        if join and self._thread is not None:
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def healthy(self) -> bool:
        """Routable: not failed, and its thread either hasn't started
        yet (``started=False`` sets — work queues until ``start()``)
        or is still running and not draining."""
        if self.failed:
            return False
        if self._thread is None:
            return not self._stop.is_set()
        return self._thread.is_alive() and not self._stop.is_set()

    def heartbeat(self) -> Dict[str, Any]:
        """The supervisor's step-progress probe (one snapshot, no
        lock-ordering risk: every field is read through the engine's
        own lock or is a plain attribute)."""
        ld = self.load()
        return {"name": self.name, "alive": self.alive,
                "healthy": self.healthy, "failed": self.failed,
                "steps": self.engine.steps_run,
                "work": ld["queued"] + ld["active"]}


class ReplicaSet:
    """The colocated-serving backend: replicas + least-loaded routing
    + the ``scale_to`` surface the autoscaler drives + the
    remove/spawn surface the supervisor drives."""

    def __init__(self, engine_factory: Callable[[], ServeEngine],
                 n_replicas: int = 1, *, started: bool = True,
                 name_prefix: str = "r",
                 labels: Optional[Dict[str, str]] = None):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        self._factory = engine_factory
        self._lock = threading.Lock()
        self._closed = False
        self._replicas: List[EngineReplica] = []
        self._draining: List[EngineReplica] = []
        self._seq = itertools.count()
        self._started = started
        # fleet pools prefix with the model name so federated scrapes
        # and /state rows are attributable without a join; `labels`
        # (e.g. model=<name>) keeps two pools' replica gauges from
        # last-write-clobbering each other in one registry
        self._name_prefix = name_prefix
        self._m_replicas = telemetry.gauge(
            "gateway_replicas", "Live engine replicas behind the "
            "gateway router", **dict(labels or {}))
        self.scale_to(n_replicas)

    def _new_replica(self) -> EngineReplica:
        """Build (never start/register) one replica from the factory —
        the ONE construction point ``scale_to`` and ``spawn_replica``
        share, so a subclass stamping per-build metadata (fleet pools
        set ``.version``) covers every spawn path. Called under
        ``_lock``."""
        return EngineReplica(
            self._factory(),
            name=f"{self._name_prefix}{next(self._seq)}")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start every replica loop (a set built with
        ``started=False`` — tests that need a stalled backend — starts
        here)."""
        with self._lock:
            self._started = True
            for r in self._replicas:
                r.start()

    def close(self, timeout: float = 60.0) -> None:
        with self._lock:
            self._closed = True
            reps = self._replicas + self._draining
            self._replicas, self._draining = [], []
        for r in reps:
            r.stop()
        for r in reps:
            if r._thread is not None:
                r._thread.join(timeout)
        self._m_replicas.set(0)

    # -- routing -----------------------------------------------------------
    def route(self, req: Request,
              handoff: Optional[KVHandoff] = None, *,
              prefer: Optional[str] = None,
              version: Optional[str] = None) -> Ticket:
        """Submit to the least-loaded healthy replica. Raises
        :class:`GatewayClosed` after ``close()`` and
        :class:`NoHealthyReplicas` when every replica is
        dead/removed. Pick + submit are ONE critical section:
        concurrent routes must see each other's submissions (two
        racing requests both reading queued=0 would pile onto the
        same replica), and a route racing close() must never hand a
        request to a replica nothing will serve.

        ``prefer``: a replica NAME — session affinity. When that
        replica is still healthy the request lands on it regardless
        of load (the session's KV-warm replica beats a cold
        least-loaded one); gone or draining, routing falls back to
        least-loaded silently.

        ``version``: restrict to replicas of one model build —
        crash re-dispatch during a hot-swap uses it so a request
        accepted on the old build resumes on the old build
        (bit-identity). Best-effort: when NO healthy replica of that
        version survives, all healthy replicas are eligible (the
        response's version label shows the seam)."""
        with self._lock:
            if self._closed:
                raise GatewayClosed("replica set is closed")
            live = [r for r in self._replicas if r.healthy]
            if not live:
                raise NoHealthyReplicas(
                    f"no healthy replica to route to "
                    f"({len(self._replicas)} registered)")
            if version is not None:
                same = [r for r in live if r.version == version]
                if not same:
                    # old-build resume mid-swap with every same-build
                    # replica already DRAINING: a draining replica
                    # still serves work submitted before it goes idle
                    # (the engine loop exits only at stop+empty), so
                    # extend one drain rather than resume on the new
                    # build and break bit-identity
                    same = [r for r in self._draining
                            if r.version == version and r.alive
                            and not r.failed]
                if same:
                    live = same
            replica = None
            if prefer is not None:
                replica = next((r for r in live if r.name == prefer),
                               None)
            if replica is None:
                loads = [(r, r.load()) for r in live]
                replica, _ = min(
                    loads, key=lambda rl: (rl[1]["queued"]
                                           + rl[1]["active"])
                    / max(1, rl[1]["slots"]))
            rid = (replica.submit(req) if handoff is None
                   else replica.submit_prefilled(handoff, req))
        return Ticket(replica, rid)

    # -- supervisor surface -------------------------------------------------
    def replicas(self) -> List[EngineReplica]:
        """Routing-set snapshot (supervision + introspection)."""
        with self._lock:
            return list(self._replicas)

    def remove_replica(self, replica: EngineReplica) -> bool:
        """Pull a dead/stalled replica out of routing WITHOUT
        replacing it (the supervisor decides whether/when to respawn).
        Returns False if it was not in the routing set (already
        removed — supervision races are benign)."""
        with self._lock:
            if replica not in self._replicas:
                return False
            self._replicas.remove(replica)
            live = len(self._replicas)
        # a stalled replica may still be running: signal its loop so
        # that even if it unwedges it drains instead of serving a
        # request the gateway has already re-dispatched elsewhere
        replica.stop()
        self._m_replicas.set(live)
        return True

    def spawn_replica(self) -> Optional[EngineReplica]:
        """Start one fresh replica from the factory and add it to
        routing (the supervisor's restart lever). None after close —
        a supervisor heartbeat racing shutdown is benign, so this one
        surface stays a quiet refusal rather than raising."""
        with self._lock:
            if self._closed:
                return None
            r = self._new_replica()
            if self._started:
                r.start()
            self._replicas.append(r)
            live = len(self._replicas)
        self._m_replicas.set(live)
        return r

    def drain_replica(self, replica: EngineReplica) -> bool:
        """Pull a HEALTHY replica out of routing and let it finish
        every accepted request before its thread exits — the hot-swap
        retirement path. Unlike the supervisor's ``remove_replica``
        (crash path: marks the replica failed so its tickets read
        dead and re-dispatch), a drained replica stays healthy to the
        requests it already holds; it just takes no new ones. The
        drained replica joins ``_draining`` so ``close()`` still
        joins its thread. Raises :class:`GatewayClosed` after
        close(); returns False when the replica was not in the
        routing set (already drained/removed)."""
        with self._lock:
            if self._closed:
                raise GatewayClosed("replica set is closed")
            if replica not in self._replicas:
                return False
            self._replicas.remove(replica)
            self._draining.append(replica)
            live = len(self._replicas)
        replica.stop()
        self._m_replicas.set(live)
        return True

    # -- autoscaler surface ------------------------------------------------
    @property
    def size(self) -> int:
        with self._lock:
            return len(self._replicas)

    def set_factory(self, engine_factory: Callable[[], ServeEngine],
                    version: Optional[str] = None) -> None:
        """Swap the engine factory every FUTURE spawn uses (hot-swap:
        the new build's factory goes in first, then old replicas are
        drained one by one). Existing replicas are untouched."""
        with self._lock:
            if self._closed:
                raise GatewayClosed("replica set is closed")
            self._factory = engine_factory
            if version is not None:
                self.version = version

    def scale_to(self, n: int) -> int:
        """Grow/shrink to ``n`` live replicas (floor 1). Shrinking
        moves replicas to the draining list — out of routing
        immediately, threads exit once their accepted work is done.
        Raises :class:`GatewayClosed` after ``close()`` — scaling a
        closed pool used to return 0 silently, leaving a late
        autoscaler/arbiter believing it had capacity it did not."""
        n = max(1, int(n))
        with self._lock:
            if self._closed:
                raise GatewayClosed("replica set is closed")
            while len(self._replicas) < n:
                r = self._new_replica()
                if self._started:
                    r.start()
                self._replicas.append(r)
            drained = []
            while len(self._replicas) > n:
                drained.append(self._replicas.pop())
            self._draining.extend(drained)
            self._draining = [d for d in self._draining if d.alive]
            live = len(self._replicas)
        for d in drained:
            d.stop()
        self._m_replicas.set(live)
        return live

    # -- introspection ------------------------------------------------------
    def load_total(self) -> Dict[str, int]:
        out = {"queued": 0, "active": 0, "slots": 0}
        for r in self.replicas():
            ld = r.load()
            for k in out:
                out[k] += ld[k]
        return out

    def state(self) -> List[Dict[str, Any]]:
        return [dict(name=r.name, alive=r.alive, healthy=r.healthy,
                     failed=r.failed, version=r.version,
                     error=(repr(r.failure)[:120] if r.failure
                            else None), steps=r.engine.steps_run,
                     kv_cache=r.engine.kv_cache_stats(),
                     **r.load())
                for r in self.replicas()]


class ReplicaSupervisor:
    """Health-checks every replica via step-progress heartbeats and
    keeps the set serving: a DEAD replica (thread exited with its stop
    event clear — an escaped exception) or a STALLED one (work
    pending, step counter frozen past ``stall_s``) is pulled out of
    routing, counted in ``gateway_replica_restarts_total{reason}``,
    replaced from the factory under a bounded-restart + exponential
    backoff budget, and reported to ``on_down(replica, reason)`` — the
    gateway's deterministic re-dispatch hook.

    The loop itself is clock-injectable and single-steppable
    (:meth:`check`), so chaos tests drive it deterministically; the
    background thread (:meth:`run_forever`) is the production mode.
    """

    def __init__(self, backend, *,
                 on_down: Optional[Callable[[EngineReplica, str],
                                            None]] = None,
                 heartbeat_s: Optional[float] = None,
                 stall_s: Optional[float] = None,
                 warmup_s: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 backoff_base_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.backend = backend
        self.on_down = on_down
        self.heartbeat_s = (heartbeat_s if heartbeat_s is not None
                            else env_float(
                                "MXTPU_GATEWAY_HEARTBEAT_S", 0.25,
                                "Replica supervisor health-check "
                                "period (seconds)."))
        self.stall_s = (stall_s if stall_s is not None
                        else env_float(
                            "MXTPU_GATEWAY_STALL_S", 30.0,
                            "A replica with pending work whose engine "
                            "step counter does not advance for this "
                            "many seconds is declared stalled and "
                            "replaced."))
        self.warmup_s = (warmup_s if warmup_s is not None
                         else env_float(
                             "MXTPU_GATEWAY_WARMUP_STALL_S", 120.0,
                             "Stall threshold applied while a replica "
                             "has completed ZERO steps: first "
                             "admission legitimately blocks on "
                             "prefill+decode builds, so declaring a "
                             "building replica stalled would kill "
                             "every replacement mid-warmup forever."))
        self.max_restarts = (max_restarts if max_restarts is not None
                             else env_int(
                                 "MXTPU_GATEWAY_MAX_RESTARTS", 5,
                                 "Replica restarts the supervisor "
                                 "will perform over the gateway's "
                                 "life before refusing further "
                                 "replacements (a crash loop must "
                                 "become a loud 503, not an infinite "
                                 "respawn)."))
        self.backoff_base_s = (
            backoff_base_s if backoff_base_s is not None
            else env_float(
                "MXTPU_GATEWAY_RESTART_BACKOFF_S", 0.05,
                "Initial delay before a replica replacement, doubled "
                "per consecutive restart (decays back after a quiet "
                "period)."))
        self.backoff_max_s = (
            backoff_max_s if backoff_max_s is not None
            else env_float(
                "MXTPU_GATEWAY_RESTART_BACKOFF_MAX", 5.0,
                "Replica-replacement backoff ceiling (seconds)."))
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        # keyed by replica NAME (unique per set, never reused — id()
        # can be recycled by the allocator after a scale-down, which
        # would hand a fresh replica a stale stall window)
        self._progress: Dict[str, tuple] = {}   # name -> (steps, t)
        self._m_restarts: Dict[str, Any] = {}
        self.restarts = 0
        self.history: List[Dict[str, Any]] = []   # bounded, /state
        self._pending_spawns = 0
        self._next_spawn_at = 0.0
        self._consecutive = 0
        self._last_down_t = 0.0

    def _count(self, reason: str) -> None:
        m = self._m_restarts.get(reason)
        if m is None:
            m = self._m_restarts[reason] = telemetry.counter(
                "gateway_replica_restarts_total",
                "Replica replacements by the gateway supervisor, "
                "by failure reason", reason=reason)
        m.inc()

    # -- detection -----------------------------------------------------------
    def _diagnose(self, replica: EngineReplica,
                  now: float) -> Optional[str]:
        hb = replica.heartbeat()
        if replica._stop.is_set():
            return None                     # draining — expected exit
        if replica._thread is not None and not hb["alive"]:
            return "died"
        key = replica.name
        last = self._progress.get(key)
        if last is None or last[0] != hb["steps"]:
            self._progress[key] = (hb["steps"], now)
            return None
        # a replica mid-warmup (zero completed steps) is most likely
        # BUILDING its admission/decode programs, not wedged — hold
        # it to the (much larger) warmup threshold instead
        limit = (self.stall_s if hb["steps"] > 0
                 else max(self.stall_s, self.warmup_s))
        if hb["work"] > 0 and hb["alive"] \
                and now - last[1] >= limit:
            return "stalled"
        if hb["work"] == 0:
            # idle is not a stall: restart the progress window
            self._progress[key] = (hb["steps"], now)
        return None

    def check(self) -> List[str]:
        """One supervision pass; returns the reasons of any replicas
        taken down this pass. Thread-safe, callable from tests."""
        now = self._clock()
        downs: List[tuple] = []
        with self._lock:
            reps = self.backend.replicas()
            seen = {r.name for r in reps}
            for stale in [k for k in self._progress
                          if k not in seen]:
                # drained via scale_to (never passed through
                # _take_down): drop its window or the dict grows
                # forever under autoscaler churn
                del self._progress[stale]
            for r in reps:
                reason = self._diagnose(r, now)
                if reason is not None:
                    downs.append((r, reason))
        for replica, reason in downs:
            self._take_down(replica, reason, now)
        self._maybe_spawn(now)
        if not downs:
            with self._lock:
                # decay the consecutive-failure count only after a
                # QUIET period (no takedown for a full backoff
                # ceiling): a serial crash loop — each replacement
                # dying right after its spawn — must keep doubling,
                # while one crash a day must not creep toward the max
                if (self._consecutive and self._pending_spawns == 0
                        and now - self._last_down_t
                        >= self.backoff_max_s):
                    self._consecutive = 0
        return [reason for _, reason in downs]

    def _take_down(self, replica: EngineReplica, reason: str,
                   now: float) -> None:
        if not self.backend.remove_replica(replica):
            return                          # raced another pass
        replica.failed = True               # never routable again
        self._count(reason)
        telemetry.flight().record(
            "gateway", "replica_down", replica=replica.name,
            reason=reason,
            error=(repr(replica.failure)[:200] if replica.failure
                   else None))
        with self._lock:
            # the window pop shares _lock with _diagnose's iteration —
            # an unlocked pop here raced the next check() pass
            self._progress.pop(replica.name, None)
            self.history.append(
                {"t": now, "replica": replica.name, "reason": reason,
                 "error": (repr(replica.failure)[:120]
                           if replica.failure else None)})
            del self.history[:-32]
            self._last_down_t = now
            if self.restarts < self.max_restarts:
                self.restarts += 1
                self._pending_spawns += 1
                delay = min(
                    self.backoff_base_s * (2 ** self._consecutive),
                    self.backoff_max_s)
                self._consecutive += 1
                self._next_spawn_at = max(self._next_spawn_at,
                                          now + delay)
            else:
                telemetry.flight().record(
                    "gateway", "restart_budget_exhausted",
                    replica=replica.name, max=self.max_restarts)
        if self.on_down is not None:
            self.on_down(replica, reason)

    def _maybe_spawn(self, now: float) -> None:
        """Replace taken-down replicas once their backoff expires (the
        backoff delays the SPAWN, never the re-dispatch — stranded
        requests move to surviving replicas immediately)."""
        while True:
            with self._lock:
                if self._pending_spawns <= 0 \
                        or now < self._next_spawn_at:
                    return
                self._pending_spawns -= 1
            fresh = self.backend.spawn_replica()
            if fresh is not None:
                telemetry.flight().record("gateway", "replica_spawned",
                                          replica=fresh.name)

    @property
    def exhausted(self) -> bool:
        """No replacement is coming: the restart budget is spent and
        nothing is pending — parked re-dispatches should fail loudly
        instead of waiting for a replica that will never exist."""
        with self._lock:
            return (self.restarts >= self.max_restarts
                    and self._pending_spawns == 0)

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            return {"restarts": self.restarts,
                    "max_restarts": self.max_restarts,
                    "pending_spawns": self._pending_spawns,
                    "history": list(self.history[-8:])}

    def run_forever(self, stop: threading.Event) -> None:
        while not stop.wait(self.heartbeat_s):
            try:
                self.check()
            except Exception:
                # supervision must never die quietly; the flight ring
                # has the event, the next heartbeat retries
                telemetry.flight().record("gateway", "supervise_error")
