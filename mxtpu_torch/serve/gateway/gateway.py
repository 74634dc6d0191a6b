"""The gateway: admission control + routing + streaming handles over a
replica backend (colocated ``ReplicaSet`` or disaggregated
``DisaggBackend``), with the HTTP front door layered on top
(``frontdoor.py``) and the autoscaler driving ``backend.scale_to``
(``autoscale.py``) — the port of ``mxtpu/serve/gateway/gateway.py``:
host code over the port's engine, with the same admission, shedding,
journal and re-dispatch rules.

Admission control is a bounded queue over the BACKEND's un-seated
request count: once ``queued >= queue_max`` a new submission raises
:class:`GatewayOverloaded` (the front door turns it into HTTP 429 +
``Retry-After``) instead of growing an unbounded backlog whose every
entry would miss its latency target anyway — load shedding at the
door, the DistServe/Orca serving-tier discipline. Past the SOFT bound
(``MXTPU_GATEWAY_SHED_SOFT`` of the queue) admission turns
deadline-aware: a request whose own budget is smaller than the
estimated drain time is shed early (tier 1), because admitting it
only burns a slot on an answer its client will never wait for. Every
``Retry-After`` the door sends carries seeded JITTER — a synchronized
herd shed by one burst must not re-arrive as one burst.

Fault tolerance: the gateway JOURNALS every accepted request
(prompt, sampling params, seed, and — via the handle — the tokens
already streamed). A :class:`~.replica.ReplicaSupervisor` health-checks
the replicas; when one dies or stalls, its in-flight requests are
re-dispatched to a healthy replica by re-prefilling ``prompt +
streamed-prefix`` with the rng chain fast-forwarded
(``serve.resume_key``), so the client's ndjson stream continues
seamlessly and the full token list is BIT-IDENTICAL to a fault-free
run. Zero healthy replicas raise :class:`GatewayUnavailable` → 503 +
Retry-After at the door.

Streaming: the engine's ``on_token`` callback feeds a per-request
:class:`RequestHandle` queue and NEVER blocks — a slow HTTP consumer
stalls its own socket writer thread, not the decode loop. The
slow-client defense is the deadline: every request carries one
(explicit, or ``MXTPU_GATEWAY_DEADLINE_S``), and an expired request
frees its slot at the next step boundary.
"""
from __future__ import annotations

import queue
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ... import telemetry
from ...base import env_float, env_int, env_str
from ...telemetry import distributed as dtrace
from ..engine import Request, ServeEngine, cancel_counter, resume_key
from .replica import (GatewayClosed, NoHealthyReplicas, ReplicaSet,
                      ReplicaSupervisor, Ticket)

__all__ = ["Gateway", "GatewayOverloaded", "GatewayUnavailable",
           "GatewayClosed", "RequestHandle", "PRIORITIES"]

_DONE = object()     # stream sentinel

# admission priority classes, strongest first: `interactive` gets the
# full queue bound; `batch` and `offline` get shrinking fractions of
# it AND are shed outright while the SLO burn rate is over threshold
# (low-priority work yields first — the fleet arbiter then has burn
# headroom to move chips instead of every class degrading together)
PRIORITIES = ("interactive", "batch", "offline")


class GatewayOverloaded(RuntimeError):
    """Admission refused: the gateway queue is at its bound (or the
    request's own deadline cannot survive the current backlog — the
    tier-1 deadline-aware shed, or the request's priority class is
    yielding under SLO burn — tier 3). Carries the ``retry_after``
    hint (seconds, jittered) the front door sends back."""

    def __init__(self, depth: int, bound: int, retry_after: int,
                 tier: int = 2, priority: str = "interactive"):
        if tier == 3:
            msg = (f"gateway shedding {priority} traffic under SLO "
                   f"burn; retry in ~{retry_after}s")
        elif tier == 2:
            msg = (f"gateway queue full ({depth} >= {bound}"
                   + (f", {priority} bound" if priority
                      != "interactive" else "")
                   + f"); retry in ~{retry_after}s")
        else:
            msg = (f"gateway backlog ({depth}/{bound}) outlives the "
                   f"request's deadline budget (tier-1 shed); "
                   f"retry in ~{retry_after}s")
        super().__init__(msg)
        self.depth = depth
        self.bound = bound
        self.retry_after = retry_after
        self.tier = tier
        self.priority = priority


class GatewayUnavailable(RuntimeError):
    """No healthy replica exists to carry the request (crash loop
    past the restart budget, or the whole pool is down). The front
    door maps this to 503 + ``Retry-After`` — distinct from overload:
    the client should retry LATER, not slower."""

    def __init__(self, msg: str, retry_after: int):
        super().__init__(msg)
        self.retry_after = retry_after


class _JournalEntry:
    """Everything needed to re-dispatch one accepted request after a
    replica failure: the immutable submission (prompt, sampling
    params, seed, absolute deadline) plus live state (the handle —
    whose ``tokens`` list IS the streamed-so-far record — the current
    ticket, and an epoch guard that silences callbacks from a replica
    the request has been moved off of)."""

    __slots__ = ("gid", "prompt", "max_new_tokens", "temperature",
                 "top_k", "top_p", "seed", "deadline_abs", "handle",
                 "ticket", "epoch", "done", "cancel_reason", "ctx")

    def __init__(self, gid: int, prompt: np.ndarray,
                 max_new_tokens: int, temperature: float,
                 top_k: Optional[int], top_p: Optional[float],
                 seed: int, deadline_abs: Optional[float],
                 handle: "RequestHandle"):
        self.gid = gid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.deadline_abs = deadline_abs
        self.handle = handle
        self.ticket: Optional[Ticket] = None
        self.epoch = 0
        self.done = False
        self.cancel_reason: Optional[str] = None
        self.ctx: Optional[dtrace.TraceContext] = None


class RequestHandle:
    """One submitted request as the client sees it: a thread-safe
    token stream plus the final reason (``complete`` / ``cancel`` /
    ``deadline`` / ``disconnect`` / ``error``). Survives replica
    failure transparently — re-dispatch feeds the same queue."""

    def __init__(self, gateway: "Gateway", submitted_at: float):
        self._gw = gateway
        self._submitted_at = submitted_at
        self._first_at: Optional[float] = None
        self._q: "queue.Queue[Any]" = queue.Queue()
        self._done = threading.Event()
        self.tokens: list = []
        self.reason: Optional[str] = None
        self.ticket: Optional[Ticket] = None
        self.trace_id: Optional[str] = None
        self.model: Optional[str] = None
        self._entry: Optional[_JournalEntry] = None

    @property
    def version(self) -> Optional[str]:
        """Model-build tag of the replica CURRENTLY carrying the
        request (None outside a fleet pool). Read at response time it
        names the build that produced the final tokens — across a hot
        swap, requests that completed on the old build report the old
        version, the seam an operator greps for."""
        ticket = self.ticket
        rep = getattr(ticket, "replica", None)
        if rep is None:
            rep = getattr(getattr(ticket, "seated", None),
                          "replica", None)
        return getattr(rep, "version", None)

    # engine-side callbacks (never block: queue puts + list appends)
    def _on_token(self, rid: int, token: int) -> None:
        if self._first_at is None:
            self._first_at = time.perf_counter()
            ttft_ms = 1e3 * (self._first_at - self._submitted_at)
            self._gw._m_ttft.observe(ttft_ms)
            # per-version split (the flywheel's canary burn signal):
            # attribute TTFT to the model build that SEATED us
            ver = self.version
            if ver is not None:
                self._gw.version_ttft(ver).observe(ttft_ms)
            entry = self._entry
            if entry is not None and entry.ctx is not None:
                with dtrace.use(entry.ctx):
                    telemetry.instant("gateway.first_token",
                                      ttft_ms=round(ttft_ms, 3))
        self.tokens.append(int(token))
        self._q.put(int(token))

    def _on_done(self, rid: int, reason: str) -> None:
        self.reason = reason
        self._done.set()
        self._q.put(_DONE)

    # client side
    def stream(self, timeout: Optional[float] = 300.0):
        """Yield tokens as they are produced; returns when the request
        ends (``.reason`` is set by then)."""
        while True:
            item = self._q.get(timeout=timeout)
            if item is _DONE:
                return
            yield item

    def result(self, timeout: Optional[float] = 300.0) -> np.ndarray:
        """Block until the request ends; returns the generated tokens
        (partial if cancelled — check ``.reason``)."""
        if not self._done.wait(timeout):
            raise TimeoutError("request did not finish in time")
        return np.asarray(self.tokens, np.int32)

    def cancel(self, reason: str = "cancel") -> bool:
        if self._entry is not None:
            return self._gw._cancel_entry(self._entry, reason)
        if self.ticket is None:
            return False
        return self.ticket.cancel(reason)


class Gateway:
    """The serving front door over engine replicas.

    ``backend`` is anything with ``route(req, handoff=None) -> Ticket``,
    ``load_total()``, ``state()``, ``size``, ``scale_to(n)``,
    ``replicas()``, ``remove_replica``/``spawn_replica``, ``start()``
    and ``close()`` — ``ReplicaSet`` (colocated) or ``DisaggBackend``
    (split prefill/decode pools). Convenience: pass ``engine_factory``
    (+ ``n_replicas``) and the gateway builds the colocated backend
    itself.

    ``autoscale``: an :class:`~.autoscale.AutoscalePolicy` (or dict of
    its fields) — enables the scaling loop against this backend.
    ``supervise`` (default True): run the replica supervisor +
    re-dispatch maintenance loop; ``supervisor_opts`` forwards kwargs
    (heartbeat_s, stall_s, max_restarts, backoff) to
    :class:`~.replica.ReplicaSupervisor`.
    """

    def __init__(self, engine_factory:
                 Optional[Callable[[], ServeEngine]] = None, *,
                 backend=None, n_replicas: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 autoscale=None, started: bool = True,
                 supervise: bool = True,
                 supervisor_opts: Optional[Dict[str, Any]] = None,
                 retry_jitter: Optional[float] = None,
                 federate=None,
                 model: Optional[str] = None,
                 slo: Optional[Dict[str, float]] = None,
                 clock: Optional[Callable[[], float]] = None):
        if (backend is None) == (engine_factory is None):
            raise ValueError(
                "pass exactly one of engine_factory / backend")
        # `model`: this gateway serves ONE named model of a fleet —
        # its request counters, TTFT histogram and SLO gauges carry a
        # model=<name> label so two models' series coexist in one
        # registry. None (the single-model deployment) keeps every
        # series name AND label set exactly as before: existing
        # scrapes are grandfathered.
        self.model = model
        self._mlabels = {"model": model} if model else {}
        if backend is None:
            backend = ReplicaSet(
                engine_factory,
                n_replicas if n_replicas is not None else env_int(
                    "MXTPU_GATEWAY_REPLICAS", 1,
                    "Engine replicas the gateway starts by default "
                    "(scale_to / the autoscaler move it at runtime)."),
                started=started)
        self.backend = backend
        self.queue_max = (queue_max if queue_max is not None
                          else env_int(
                              "MXTPU_GATEWAY_QUEUE_MAX", 64,
                              "Gateway admission bound: requests "
                              "queued (not yet seated in a slot) "
                              "beyond this are refused with 429 + "
                              "Retry-After."))
        dflt = (default_deadline_s if default_deadline_s is not None
                else env_float(
                    "MXTPU_GATEWAY_DEADLINE_S", 0.0,
                    "Default per-request deadline (seconds) the "
                    "gateway applies when a request does not set one; "
                    "0 disables."))
        self.default_deadline_s = dflt if dflt and dflt > 0 else None
        self.shed_soft = env_float(
            "MXTPU_GATEWAY_SHED_SOFT", 0.5,
            "Soft-shed threshold as a fraction of the queue bound: "
            "past it, requests whose own deadline is smaller than the "
            "estimated drain time are refused early (tier-1 "
            "deadline-aware shedding); 1.0 disables the tier.")
        self.retry_jitter = (retry_jitter if retry_jitter is not None
                             else env_float(
                                 "MXTPU_GATEWAY_RETRY_JITTER", 0.5,
                                 "Jitter fraction added to every "
                                 "Retry-After the front door sends "
                                 "(uniform in [0, max(1, f*base)]), "
                                 "so a synchronized herd shed by one "
                                 "429/503 burst does not re-arrive "
                                 "as one burst. 0 disables."))
        # seeded: jitter sequences are reproducible in tests while
        # still de-synchronizing concurrent clients
        self._retry_rng = random.Random(0xA5)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()       # admission critical section
        self._jlock = threading.Lock()      # journal (leaf lock: never
        #                                     held while calling engines)
        self._journal: Dict[int, _JournalEntry] = {}
        self._gid = 0
        self._repending: List[_JournalEntry] = []
        self._closed = False
        self._m_requests: Dict[str, Any] = {}
        self._m_depth = telemetry.gauge(
            "gateway_queue_depth",
            "Requests accepted by the gateway, not yet seated",
            **self._mlabels)
        self._m_ttft = telemetry.histogram(
            "gateway_ttft_ms",
            "Time to first token, submission to first on_token",
            **self._mlabels)
        self._m_redispatch = telemetry.counter(
            "gateway_redispatch_total",
            "In-flight requests moved off a failed replica and "
            "resumed on a healthy one", **self._mlabels)
        self._m_shed: Dict[tuple, Any] = {}
        self._m_ttft_ver: Dict[str, Any] = {}
        # accepted-by-priority tally (plain ints under _lock): the
        # /state "priority mix" a fleet diagnose renders per model
        self.priority_tally: Dict[str, int] = {p: 0
                                               for p in PRIORITIES}
        # priority-class admission: batch/offline get a FRACTION of
        # the queue bound and are shed outright under SLO burn
        self._batch_frac = env_float(
            "MXTPU_FLEET_BATCH_QUEUE_FRAC", 0.5,
            "Fraction of the gateway queue bound available to "
            "priority=batch requests (interactive always gets the "
            "full bound, so batch is shed first as backlog builds).")
        self._offline_frac = env_float(
            "MXTPU_FLEET_OFFLINE_QUEUE_FRAC", 0.25,
            "Fraction of the gateway queue bound available to "
            "priority=offline requests (shed before batch).")
        self._burn_shed = bool(env_int(
            "MXTPU_FLEET_BURN_SHED", 1,
            "Shed batch/offline submissions outright while any SLO "
            "burn rate is over threshold (tier-3 shed: low-priority "
            "work yields chips to interactive under burn); 0 "
            "disables."))
        # prefix-page affinity: a prompt whose head extends a prefix
        # some replica's paged cache already holds routes to THAT
        # replica (a CoW fork of warm pages beats a cold prefill on a
        # least-loaded one). Consulted only when nothing upstream set
        # prefer_replica — the fleet session map wins when it hits.
        self._prefix_affinity = env_int(
            "MXTPU_GATEWAY_PREFIX_AFFINITY", 4,
            "Minimum tokens of a prompt's head that must match a "
            "replica's cached prefix (the top_prefixes head in its "
            "kv_cache stats) before the gateway steers the request to "
            "that replica instead of the least-loaded one; 0 disables "
            "prefix-page affinity.")
        self._aff_lock = threading.Lock()   # scrape cache + tally only
        self._aff_scrape: tuple = (None, [])  # (monotonic ts, rows)
        self._aff_ttl = 0.25
        self._aff_tally: Dict[str, int] = {"hit": 0, "miss": 0}
        self._m_aff: Dict[str, Any] = {}
        # metrics federation: peer processes (prefill workers on
        # other hosts, a kvstore server, sibling replicas) exposing
        # their registry via telemetry.RegistryServer; this gateway's
        # /metrics merges them under a `process` label
        if federate is None:
            federate = env_str(
                "MXTPU_TELEMETRY_FEDERATE", "",
                "Comma-separated host:port list of peer "
                "RegistryServer endpoints the gateway /metrics "
                "federates (per-process series labelled "
                "process=<role>, plus exact aggregate series).")
        self._federate = self._parse_peers(federate)
        self._fed_secret = env_str("MXTPU_GATEWAY_SECRET", "").encode()
        # derived SLO gauges + burn rate (None unless a target is
        # set). `slo=` (dict: ttft_ms/token_ms/burn/window_s) sets
        # explicit per-gateway targets — the fleet's per-model path,
        # where one process holds many trackers and the env singleton
        # cannot express them; absent, the env knobs apply as before.
        # Either way the tracker reads THIS gateway's (possibly
        # model-labeled) TTFT histogram and labels its gauges to
        # match, so per-model burn rates never collide.
        if slo is not None:
            self.slo = dtrace.SLOTracker.from_spec(
                slo, clock=self._clock,
                instruments={"ttft": self._m_ttft},
                labels=self._mlabels)
        else:
            self.slo = dtrace.SLOTracker.from_env(
                clock=self._clock,
                instruments={"ttft": self._m_ttft},
                labels=self._mlabels)
        self._http = None
        self._scaler = None
        self._scaler_stop: Optional[threading.Event] = None
        self.supervisor: Optional[ReplicaSupervisor] = None
        self._maint_stop: Optional[threading.Event] = None
        if supervise and hasattr(self.backend, "replicas"):
            self.supervisor = ReplicaSupervisor(
                self.backend, on_down=self._on_replica_down,
                **dict(supervisor_opts or {}))
            self._maint_stop = threading.Event()
            threading.Thread(target=self._maintain, daemon=True,
                             name="mxtpu-gw-supervise").start()
        if autoscale is not None:
            from .autoscale import Autoscaler, AutoscalePolicy
            policy = (autoscale if isinstance(autoscale, AutoscalePolicy)
                      else AutoscalePolicy(**dict(autoscale)))
            self._scaler = Autoscaler(self.backend, policy,
                                      clock=self._clock)
            self._scaler_stop = threading.Event()
            threading.Thread(target=self._scaler.run_forever,
                             args=(self._scaler_stop,), daemon=True,
                             name="mxtpu-gw-autoscale").start()

    @staticmethod
    def _parse_peers(spec) -> List[tuple]:
        """Accepts "host:port,host:port" (env form) or a list of
        strings / (host, port) pairs (constructor form)."""
        if not spec:
            return []
        items = ([s for s in spec.split(",") if s.strip()]
                 if isinstance(spec, str) else list(spec))
        peers = []
        for item in items:
            if isinstance(item, str):
                host, _, port = item.strip().rpartition(":")
                peers.append((host or "127.0.0.1", int(port)))
            else:
                peers.append((item[0], int(item[1])))
        return peers

    @staticmethod
    def _ticket_replica(ticket):
        """Best-effort replica object behind a ticket (colocated
        Ticket or a seated disagg ticket)."""
        rep = getattr(ticket, "replica", None)
        if rep is None:
            rep = getattr(getattr(ticket, "seated", None),
                          "replica", None)
        return rep

    @classmethod
    def _ticket_replica_name(cls, ticket) -> Optional[str]:
        """Best-effort replica name behind a ticket — the redispatch
        span's old/new endpoints."""
        return getattr(cls._ticket_replica(ticket), "name", None)

    def _count(self, code: str) -> None:
        m = self._m_requests.get(code)
        if m is None:
            m = self._m_requests[code] = telemetry.counter(
                "gateway_requests_total",
                "Requests at the gateway front door, by outcome code",
                code=code, **self._mlabels)
        m.inc()

    def version_ttft(self, version: str):
        """The per-model-build TTFT histogram
        (``gateway_ttft_ms{model,version}``), created on first use.
        During a canary this is what splits SLO burn by build: the
        flywheel hangs one :class:`~mxtpu_torch.telemetry.distributed
        .SLOTracker` off each version's histogram and compares burn
        rates."""
        m = self._m_ttft_ver.get(version)
        if m is None:
            m = self._m_ttft_ver[version] = telemetry.histogram(
                "gateway_ttft_ms",
                "Time to first token, submission to first on_token",
                version=version, **self._mlabels)
        return m

    def _count_shed(self, priority: str, tier: int) -> None:
        key = (priority, tier)
        m = self._m_shed.get(key)
        if m is None:
            m = self._m_shed[key] = telemetry.counter(
                "gateway_shed_total",
                "Admission refusals, by priority class and shed tier "
                "(1 = deadline-aware, 2 = queue bound, 3 = priority "
                "yield under SLO burn)",
                priority=priority, tier=str(tier), **self._mlabels)
        m.inc()

    def _count_aff(self, result: str) -> None:
        m = self._m_aff.get(result)
        if m is None:
            m = self._m_aff[result] = telemetry.counter(
                "gateway_prefix_affinity_total",
                "Prefix-page affinity consults at the gateway, by "
                "result (hit: some replica's paged cache holds a "
                "prefix this prompt extends, and the request was "
                "steered to that replica)",
                result=result, **self._mlabels)
        m.inc()
        with self._aff_lock:
            self._aff_tally[result] = (
                self._aff_tally.get(result, 0) + 1)

    def prefix_prefer(self, prompt) -> Optional[str]:
        """The prefix-page affinity probe: the name of the healthy
        replica whose paged cache holds the longest cached prefix
        this prompt extends (at least ``MXTPU_GATEWAY_PREFIX_AFFINITY``
        shared tokens), or None. Matching is against each replica's
        ``top_prefixes`` heads from ``backend.state()`` — scraped at
        most once per ``_aff_ttl`` seconds, so the per-route cost is a
        cached list scan. Best-effort by construction: heads carry
        only the first 8 prefix tokens, and routing falls back to
        least-loaded silently when the preferred replica is gone
        (:meth:`ReplicaSet.route`). ``submit`` consults this whenever
        no explicit ``prefer_replica`` arrives; the fleet router
        consults it when its session map misses."""
        if (not self._prefix_affinity
                or not isinstance(self.backend, ReplicaSet)):
            return None
        p = [int(t) for t in
             np.asarray(prompt, np.int32).reshape(-1)[:64]]
        if len(p) < self._prefix_affinity:
            return None
        now = self._clock()
        with self._aff_lock:
            ts, rows = self._aff_scrape
        if ts is None or now - ts >= self._aff_ttl:
            try:
                rows = self.backend.state()
            except RuntimeError:       # racing close(): no affinity
                rows = []
            with self._aff_lock:
                self._aff_scrape = (now, rows)
        best = None                    # ((score, hits), name)
        for row in rows:
            if not row.get("healthy"):
                continue
            kc = row.get("kv_cache") or {}
            for e in kc.get("top_prefixes") or []:
                h = [int(t) for t in (e.get("head") or [])]
                if not h or len(p) < len(h) or p[:len(h)] != h:
                    continue
                # the true shared run is at least len(h); up to
                # n_tokens of it can be reused, capped by the prompt
                score = min(int(e.get("n_tokens", len(h))), len(p))
                if score < self._prefix_affinity:
                    continue
                key = (score, int(e.get("hits", 0)))
                if best is None or key > best[0]:
                    best = (key, row["name"])
        return best[1] if best else None

    def _retry_after(self, base: int) -> int:
        """Jittered Retry-After: base plus a seeded uniform draw in
        [0, max(1, jitter*base)] — neighbors shed together spread out
        instead of re-arriving together."""
        base = max(1, int(base))
        if self.retry_jitter <= 0:
            return base
        span = max(1.0, self.retry_jitter * base)
        return max(1, int(round(base + self._retry_rng.uniform(0,
                                                               span))))

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None, seed: int = 0,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               priority: str = "interactive",
               prefer_replica: Optional[str] = None) -> RequestHandle:
        """Admission-check + journal + route; returns the streaming
        handle. Raises :class:`GatewayOverloaded` past the queue bound
        (or the tier-1 deadline shed, or a tier-3 priority yield),
        :class:`GatewayUnavailable` when no healthy replica exists,
        and ``ValueError`` on invalid parameters (the front door maps
        these to 429 / 503 / 400).
        ``trace_id`` (plausible hex, e.g. an upstream proxy's) is
        honored; otherwise a fresh trace is minted — either way the
        request carries ONE :class:`~mxtpu_torch.telemetry.TraceContext`
        across every hop of its life, crash re-dispatch included
        (``handle.trace_id`` is the key ``tools/diagnose.py
        timeline`` stitches on).

        ``priority`` (one of :data:`PRIORITIES`): batch/offline see a
        fraction of the queue bound and are shed outright under SLO
        burn — tokens, once admitted, are served identically; the
        class only changes who is REFUSED first. ``prefer_replica``:
        session affinity — land on this replica if it is still
        healthy (fleet router sets it from the session map)."""
        if priority not in PRIORITIES:
            self._count("400")
            raise ValueError(f"unknown priority {priority!r}; "
                             f"known: {PRIORITIES}")
        handle = RequestHandle(self, time.perf_counter())
        handle.model = self.model
        deadline = (deadline_s if deadline_s is not None
                    else self.default_deadline_s)
        # ONE critical section from depth check to enqueue: every
        # front-door thread races submit under overload, and an
        # unsynchronized check-then-route would admit a whole
        # thundering herd past the bound before any of them enqueued
        with self._lock:
            load = self.backend.load_total()
            depth = load["queued"]
            self._m_depth.set(depth)
            drain = max(1, round(depth / max(1, load["slots"])))
            bound = self.queue_max
            if priority != "interactive":
                if (self._burn_shed and self.slo is not None
                        and self.slo.breached):
                    # tier 3: the SLO is burning — low-priority work
                    # yields NOW so interactive latency recovers (and
                    # the fleet arbiter sees honest interactive
                    # pressure, not a backlog batch inflated)
                    retry = self._retry_after(max(drain, 2))
                    self._count("429")
                    self._count_shed(priority, 3)
                    telemetry.flight().record(
                        "gateway", "shed", depth=depth, tier=3,
                        priority=priority, model=self.model)
                    raise GatewayOverloaded(depth, bound, retry,
                                            tier=3, priority=priority)
                frac = (self._batch_frac if priority == "batch"
                        else self._offline_frac)
                bound = max(1, int(round(self.queue_max * frac)))
            if depth >= bound:
                retry = self._retry_after(drain)
                self._count("429")
                self._count_shed(priority, 2)
                telemetry.flight().record("gateway", "shed",
                                          depth=depth, tier=2,
                                          bound=bound,
                                          priority=priority,
                                          model=self.model)
                raise GatewayOverloaded(depth, bound, retry,
                                        tier=2, priority=priority)
            if (self.shed_soft < 1.0
                    and depth >= self.shed_soft * self.queue_max
                    and deadline is not None and deadline < drain):
                # tier 1: the backlog alone outlives this request's
                # budget — admitting it burns a slot on an answer its
                # client will never wait for
                retry = self._retry_after(drain)
                self._count("429")
                self._count_shed(priority, 1)
                telemetry.flight().record("gateway", "shed",
                                          depth=depth, tier=1,
                                          deadline_s=deadline,
                                          priority=priority,
                                          model=self.model)
                raise GatewayOverloaded(depth, self.queue_max, retry,
                                        tier=1, priority=priority)
            with self._jlock:
                self._gid += 1
                entry = _JournalEntry(
                    self._gid, np.asarray(prompt, np.int32).reshape(-1),
                    int(max_new_tokens), float(temperature),
                    None if top_k is None else int(top_k),
                    None if top_p is None else float(top_p),
                    int(seed),
                    (None if deadline is None
                     else self._clock() + float(deadline)),
                    handle)
                # the trace is minted HERE, at the front door: every
                # hop after this point (engine seat, prefill worker,
                # KV frame, crash re-dispatch) inherits this identity
                entry.ctx = dtrace.mint(
                    rid=entry.gid, seed=int(seed),
                    deadline_abs=entry.deadline_abs or 0.0,
                    trace_id=trace_id)
                handle.trace_id = entry.ctx.trace_id
                handle._entry = entry
                self._journal[entry.gid] = entry
            req = self._build_request(entry, deadline_s=deadline)
            if (prefer_replica is None and self._prefix_affinity
                    and isinstance(self.backend, ReplicaSet)):
                # no upstream affinity decision: prefer the replica
                # whose paged cache already holds this prompt's head
                prefer_replica = self.prefix_prefer(entry.prompt)
                self._count_aff("hit" if prefer_replica is not None
                                else "miss")
            # affinity only applies to ReplicaSet-style backends (a
            # disagg backend's route has no prefer surface); passed
            # conditionally so other backends need no signature change
            route_kw = ({"prefer": prefer_replica}
                        if prefer_replica is not None
                        and isinstance(self.backend, ReplicaSet)
                        else {})
            try:
                with dtrace.use(entry.ctx), telemetry.span(
                        "gateway.submit",
                        prompt_len=int(entry.prompt.size),
                        max_new_tokens=int(max_new_tokens)):
                    ticket = self.backend.route(req, **route_kw)
            except NoHealthyReplicas as e:
                with self._jlock:
                    self._journal.pop(entry.gid, None)
                self._count("503")
                telemetry.flight().record("gateway", "unavailable")
                raise GatewayUnavailable(
                    str(e), self._retry_after(1)) from e
            except ValueError:
                with self._jlock:
                    self._journal.pop(entry.gid, None)
                self._count("400")
                raise
            except RuntimeError:
                # e.g. "replica set is closed" racing shutdown — the
                # journal entry must not outlive the refusal
                with self._jlock:
                    self._journal.pop(entry.gid, None)
                self._count("error")
                raise
            with self._jlock:
                entry.ticket = ticket
            handle.ticket = ticket
            self.priority_tally[priority] += 1
        self._count("accepted")
        return handle

    def _build_request(self, entry: _JournalEntry, *,
                       deadline_s: Optional[float],
                       emitted: Optional[List[int]] = None) -> Request:
        """The dispatch (or RE-dispatch) of a journaled request.
        ``emitted`` (re-dispatch only): tokens already streamed — the
        prompt becomes ``prompt + emitted`` and the rng chain is
        fast-forwarded past them (``resume_key``), so the resumed
        stream is bit-identical to a fault-free run. Callbacks are
        epoch-guarded: once the entry moves to a new replica, anything
        a stale (stalled-then-unwedged) replica emits is dropped."""
        epoch = entry.epoch
        gw = self

        def on_token(rid: int, token: int) -> None:
            with gw._jlock:
                if entry.epoch != epoch or entry.done:
                    return
                entry.handle._on_token(rid, token)

        def on_done(rid: int, reason: str) -> None:
            with gw._jlock:
                if entry.epoch != epoch or entry.done:
                    return
                entry.done = True
                gw._journal.pop(entry.gid, None)
            entry.handle._on_done(rid, reason)

        if emitted:
            prompt = np.concatenate(
                [entry.prompt, np.asarray(emitted, np.int32)])
            rng = resume_key(entry.seed, len(emitted))
            mnew = entry.max_new_tokens - len(emitted)
        else:
            prompt = entry.prompt
            rng = None
            mnew = entry.max_new_tokens
        return Request(
            prompt=prompt, max_new_tokens=mnew,
            temperature=entry.temperature, top_k=entry.top_k,
            top_p=entry.top_p, seed=entry.seed, rng=rng,
            on_token=on_token, on_done=on_done,
            deadline_s=deadline_s, ctx=entry.ctx)

    def submit_dict(self, body: Dict[str, Any],
                    trace_id: Optional[str] = None,
                    prefer_replica: Optional[str] = None
                    ) -> RequestHandle:
        """The front door's JSON surface: validates types, forwards
        known fields. ``trace_id`` joins an upstream trace (the
        ``X-Mxtpu-Trace`` header or the body's ``trace_id`` field).
        ``model``/``session_id`` in the body are the FLEET router's
        fields — a per-model gateway reached directly ignores them
        (the fleet resolves them into this call's target and
        ``prefer_replica`` before delegating here)."""
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        if "prompt" not in body:
            raise ValueError("missing 'prompt'")
        prompt = body["prompt"]
        if not isinstance(prompt, (list, tuple)) or not all(
                isinstance(t, int) for t in prompt):
            raise ValueError("'prompt' must be a list of ints")
        return self.submit(
            np.asarray(prompt, np.int32),
            int(body.get("max_new_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)),
            top_k=body.get("top_k"), top_p=body.get("top_p"),
            seed=int(body.get("seed", 0)),
            deadline_s=body.get("deadline_s"),
            trace_id=trace_id or body.get("trace_id"),
            priority=str(body.get("priority", "interactive")),
            prefer_replica=prefer_replica)

    # -- fault recovery ------------------------------------------------------
    def _cancel_entry(self, entry: _JournalEntry,
                      reason: str) -> bool:
        with self._jlock:
            if entry.done:
                return False
            # recorded FIRST so a cancel racing a re-dispatch (old
            # ticket already dead, new one not yet installed) is
            # honored by _redispatch after it seats the request
            entry.cancel_reason = reason
            if entry in self._repending:
                # between replicas: finalize directly, nothing holds
                # a slot for it
                self._repending.remove(entry)
                entry.done = True
                entry.epoch += 1
                self._journal.pop(entry.gid, None)
                ticket = None
            else:
                ticket = entry.ticket
        if ticket is None:
            cancel_counter(reason).inc()
            entry.handle._on_done(-1, reason)
            return True
        return ticket.cancel(reason)

    def _on_replica_down(self, replica, reason: str) -> None:
        """Supervisor callback: collect the dead replica's journaled
        in-flight requests and move them to a healthy replica."""
        with self._jlock:
            stranded = [e for e in self._journal.values()
                        if not e.done and e.ticket is not None
                        and e.ticket.on_replica(replica)]
        if stranded:
            telemetry.flight().record(
                "gateway", "redispatch", replica=replica.name,
                reason=reason, requests=len(stranded))
        self._redispatch(stranded)

    def _redispatch(self, entries: List[_JournalEntry]) -> None:
        for entry in entries:
            with self._jlock:
                if entry.done:
                    continue
                cancelled = entry.cancel_reason
                if cancelled is not None:
                    # cancelled while its replica was dying: honor
                    # the cancel instead of resuming dead work
                    entry.done = True
                    self._journal.pop(entry.gid, None)
                else:
                    # bump FIRST: from here, nothing a stale replica
                    # emits can reach the handle, so the
                    # streamed-prefix snapshot below is final
                    entry.epoch += 1
                    emitted = list(entry.handle.tokens)
                    deadline_abs = entry.deadline_abs
                    old_rep = self._ticket_replica(entry.ticket)
                    old_replica = getattr(old_rep, "name", None)
                    # a request accepted on one model BUILD must
                    # resume on the same build or its tokens diverge
                    # from the fault-free run: mid-hot-swap, route is
                    # constrained to same-version replicas (fleet
                    # pools; None — every plain set — is unrestricted)
                    old_version = getattr(old_rep, "version", None)
                    if entry.ctx is not None:
                        # SAME trace, new segment: the resumed hops
                        # parent to the redispatch, not the original
                        # submit — the timeline shows the seam
                        entry.ctx = entry.ctx.child()
            if cancelled is not None:
                cancel_counter(cancelled).inc()
                entry.handle._on_done(-1, cancelled)
                continue
            remaining = entry.max_new_tokens - len(emitted)
            if remaining <= 0:
                # the client already has every token; only the final
                # on_done was lost with the replica
                with self._jlock:
                    if entry.done:
                        continue
                    entry.done = True
                    self._journal.pop(entry.gid, None)
                entry.handle._on_done(-1, "complete")
                continue
            deadline_s = None
            if deadline_abs is not None:
                deadline_s = deadline_abs - self._clock()
                if deadline_s <= 0:
                    with self._jlock:
                        if entry.done:
                            continue
                        entry.done = True
                        self._journal.pop(entry.gid, None)
                    cancel_counter("deadline").inc()
                    entry.handle._on_done(-1, "deadline")
                    continue
            req = self._build_request(entry, deadline_s=deadline_s,
                                      emitted=emitted)
            try:
                # the explicit crash seam in the request's ONE trace:
                # a `gateway.redispatch` span naming the replica the
                # request died on and the one it resumes on
                route_kw = ({"version": old_version}
                            if old_version is not None
                            and isinstance(self.backend, ReplicaSet)
                            else {})
                with dtrace.use(entry.ctx), telemetry.span(
                        "gateway.redispatch",
                        old_replica=old_replica,
                        emitted=len(emitted)) as rd_span:
                    ticket = self.backend.route(req, **route_kw)
                    rd_span.args["new_replica"] = \
                        self._ticket_replica_name(ticket)
            except NoHealthyReplicas:
                sup = self.supervisor
                if sup is None or sup.exhausted:
                    # no replacement is ever coming: fail loudly
                    # instead of parking the client forever
                    with self._jlock:
                        if entry.done:
                            continue
                        entry.done = True
                        self._journal.pop(entry.gid, None)
                    cancel_counter("error").inc()
                    entry.handle._on_done(-1, "error")
                    continue
                # replacement still in backoff: park it; the
                # maintenance loop retries after every spawn
                with self._jlock:
                    if not entry.done \
                            and entry not in self._repending:
                        self._repending.append(entry)
                continue
            except (ValueError, RuntimeError):
                with self._jlock:
                    if entry.done:
                        continue
                    entry.done = True
                    self._journal.pop(entry.gid, None)
                entry.handle._on_done(-1, "error")
                continue
            with self._jlock:
                entry.ticket = ticket
                cancelled = entry.cancel_reason
            entry.handle.ticket = ticket
            self._m_redispatch.inc()
            if cancelled is not None:
                # a cancel landed while we were routing: it targeted
                # the dead ticket, so deliver it to the live one
                ticket.cancel(cancelled)

    def _maintain(self) -> None:
        """The supervision heartbeat: health-check replicas, respawn
        per policy, flush parked re-dispatches, and let a disagg
        backend check its prefill pool/channel."""
        stop = self._maint_stop
        sup = self.supervisor
        while not stop.wait(sup.heartbeat_s):
            try:
                sup.check()
                if self.slo is not None:
                    # rate-limited internally to the SLO window — the
                    # heartbeat just guarantees the window advances
                    # even when nothing scrapes /metrics
                    self.slo.tick()
                check_pools = getattr(self.backend, "check_pools",
                                      None)
                if check_pools is not None:
                    check_pools()
                with self._jlock:
                    parked = [e for e in self._repending
                              if not e.done]
                    self._repending = []
                    # sweep for deaths that raced ticket
                    # registration: any journaled entry still
                    # pointing at a FAILED replica gets moved too
                    parked += [e for e in self._journal.values()
                               if not e.done and e not in parked
                               and e.ticket is not None
                               and e.ticket.dead()]
                if parked:
                    self._redispatch(parked)
            except Exception:
                telemetry.flight().record("gateway", "maintain_error")

    # -- front door / lifecycle ---------------------------------------------
    def start_http(self, host: str = "127.0.0.1",
                   port: Optional[int] = None) -> int:
        """Bind + serve the HTTP front door on a daemon thread;
        returns the bound port (pass 0 for an ephemeral one)."""
        from .frontdoor import serve_http
        if port is None:
            port = env_int(
                "MXTPU_GATEWAY_PORT", 9300,
                "Default TCP port of the gateway HTTP front door.")
        self._http, bound = serve_http(self, host, port)
        return bound

    def refresh_gauges(self) -> None:
        """Point-in-time gauges are written on the submit path, which
        goes quiet exactly when a drained backlog should read 0 — the
        scrape endpoints re-read the source before exporting."""
        self._m_depth.set(self.backend.load_total()["queued"])

    def metrics_text(self) -> str:
        """GET /metrics body. With federation peers configured
        (``federate=`` / ``MXTPU_TELEMETRY_FEDERATE``) the scrape is
        the MERGED fleet view: every process's series under a
        ``process`` label plus exact aggregate series (counters
        summed, histogram buckets merged, gauges last-write);
        without peers it is the plain process-local dump, unchanged.
        The SLO window also advances here — scrape cadence IS the
        natural window clock."""
        self.refresh_gauges()
        if self.slo is not None:
            self.slo.tick()
        if self._federate:
            return dtrace.federate_text(
                telemetry.registry(), self._federate,
                process=telemetry.process_role(),
                secret=self._fed_secret)
        return telemetry.prometheus()

    def _breaker_snapshot(self) -> Optional[Dict[str, Any]]:
        breaker_state = getattr(self.backend, "breaker_state", None)
        return breaker_state() if breaker_state is not None else None

    def health(self) -> Dict[str, Any]:
        """GET /healthz body: liveness plus the DEGRADATION story — the
        current shed tier, breaker state (disagg), restart budget, SLO
        burn — so a load balancer (or an operator) sees 'alive but
        degraded' instead of a binary."""
        return self._health(self.backend.load_total(),
                            self._breaker_snapshot(),
                            self.supervisor.describe()
                            if self.supervisor else None)

    def _health(self, load: Dict[str, int],
                breaker: Optional[Dict[str, Any]],
                sup: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        depth = load["queued"]
        tier = 0
        if depth >= self.queue_max:
            tier = 2
        elif self.shed_soft < 1.0 \
                and depth >= self.shed_soft * self.queue_max:
            tier = 1
        has_replicas = hasattr(self.backend, "replicas")
        replicas = self.backend.replicas() if has_replicas else []
        healthy = sum(1 for r in replicas if r.healthy)
        slo = None
        if self.slo is not None:
            # a deployment may poll ONLY /healthz (no scraper, no
            # supervisor): the window must advance here too — tick()
            # is rate-limited to window_s, so probe traffic cannot
            # chop it into noise
            self.slo.tick()
            slo = self.slo.describe()
        degraded = (tier > 0
                    or (has_replicas and healthy == 0)
                    or (breaker is not None
                        and breaker.get("state") != "closed")
                    or bool(sup and sup["pending_spawns"])
                    or bool(slo and slo["breached"]))
        return {"ok": True,
                "status": "degraded" if degraded else "ok",
                "tier": tier, "queued": depth,
                "queue_max": self.queue_max,
                "healthy_replicas": healthy,
                "breaker": breaker, "supervisor": sup,
                "slo": slo}

    def state(self) -> Dict[str, Any]:
        """Live topology snapshot (GET /state; tools/diagnose.py).
        Load/breaker/supervisor are snapshotted ONCE and shared with
        the embedded health block — a scrape must not double the lock
        traffic on the serving hot structures."""
        load = self.backend.load_total()
        self._m_depth.set(load["queued"])
        breaker = self._breaker_snapshot()
        sup = (self.supervisor.describe()
               if self.supervisor else None)
        replicas = self.backend.state()
        # fleet KV occupancy: the dense-bank waste number, summed over
        # every decode replica that reports one (perfscope's ledger
        # carries the same bytes as gauges; this is the /state view)
        kv_rows = [r["kv_cache"] for r in replicas
                   if isinstance(r, dict) and r.get("kv_cache")]
        reserved = sum(r["reserved_bytes"] for r in kv_rows)
        live = sum(r["live_bytes"] for r in kv_rows)
        kv_cache = {"slots": sum(r["slots"] for r in kv_rows),
                    "active": sum(r["active"] for r in kv_rows),
                    "reserved_bytes": reserved, "live_bytes": live,
                    "occupancy": (live / reserved) if reserved else 0.0}
        paged_rows = [r for r in kv_rows if r.get("paged")]
        if paged_rows:
            # paged-pool fleet view (.get() guards: a mixed fleet may
            # carry dense replicas whose rows lack these fields)
            hits = sum(r.get("prefix_hits", 0) for r in paged_rows)
            misses = sum(r.get("prefix_misses", 0)
                         for r in paged_rows)
            tops = [p for r in paged_rows
                    for p in r.get("top_prefixes", [])]
            tops.sort(key=lambda p: -p.get("hits", 0))
            # speculative-decode acceptance, fleet-wide (per-replica
            # rates stay in each replica row's kv_cache — diagnose kv
            # renders both from this one scrape)
            prop = sum(r.get("spec_proposed", 0) for r in paged_rows)
            acc = sum(r.get("spec_accepted", 0) for r in paged_rows)
            kv_cache.update({
                "spec_proposed": prop, "spec_accepted": acc,
                "spec_accept_rate": (acc / prop) if prop else 0.0,
                "paged": True,
                "pages_total": sum(r.get("pages_total", 0)
                                   for r in paged_rows),
                "pages_free": sum(r.get("pages_free", 0)
                                  for r in paged_rows),
                "pages_used": sum(r.get("pages_used", 0)
                                  for r in paged_rows),
                "pages_shared": sum(r.get("pages_shared", 0)
                                    for r in paged_rows),
                "cow_forks": sum(r.get("cow_forks", 0)
                                 for r in paged_rows),
                "prefix_hits": hits, "prefix_misses": misses,
                "prefix_hit_rate": (hits / (hits + misses)
                                    if hits + misses else 0.0),
                "top_prefixes": tops[:5]})
        with self._aff_lock:
            aff = dict(self._aff_tally)
        return {"replicas": replicas,
                "kv_cache": kv_cache,
                "n_replicas": self.backend.size,
                "model": self.model,
                "prefix_affinity": aff,
                "priority_mix": dict(self.priority_tally),
                "queued": load["queued"], "active": load["active"],
                "slots": load["slots"], "queue_max": self.queue_max,
                "health": self._health(load, breaker, sup),
                "supervisor": sup,
                "breaker": breaker,
                "autoscaler": self._scaler.describe()
                if self._scaler else None}

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._maint_stop is not None:
            self._maint_stop.set()
        if self._scaler_stop is not None:
            self._scaler_stop.set()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        self.backend.close()
