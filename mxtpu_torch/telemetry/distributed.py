"""Distributed request tracing + metrics federation: a copy of
``mxtpu/telemetry/distributed.py`` (host code), so a port process and a
reference process read each other's scrapes and trace contexts.

A process-local telemetry layer leaves a request that crosses a front
door, a prefill worker, a KV handoff and a second decode replica with N
disconnected span logs and N separate ``/metrics`` registries. This
module is the glue that makes them one system:

- :class:`TraceContext` — a Dapper-style request-scoped context
  (``trace_id``, the current hop's ``span_id``, and baggage: the
  gateway request id, seed, absolute deadline) minted at the front
  door and carried on every hop. The context is ACTIVATED per thread
  (:func:`use`); every span/instant the tracing layer records while a
  context is active carries its fields, so per-process trace JSONL
  files stitch into one chrome://tracing view of the request's whole
  life (``tools/diagnose.py timeline <rid>``).
- **wire propagation** — ``mxtpu_torch.rpc.attach_context`` /
  ``split_context`` put the context (:meth:`TraceContext.to_wire`) in
  a VERSIONED header around any framed-RPC message; old frames
  without the header still decode, old fields never move.
- :class:`RegistryServer` + :func:`federate_text` — Prometheus-style
  federation over the framed RPC: worker/replica processes expose
  their registry as a structural snapshot
  (``MetricsRegistry.snapshot_state`` — values, not text, so the
  merge is exact), and a federating ``/metrics`` merges them with a
  ``process`` label per series plus aggregate series (counters
  summed, histogram buckets merged, gauges last-write in scrape
  order).
- :class:`SLOTracker` — derived SLO gauges over the same plumbing:
  interval p99 of TTFT and inter-token latency vs. their targets
  (``MXTPU_GATEWAY_SLO_TTFT_MS`` / ``_TOKEN_MS``) and a burn rate
  (violating fraction / error budget). The bucket-diff math is
  ``registry.interval_percentile``, not a second copy.
"""
from __future__ import annotations

import os
import re
import socket
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, replace as _dc_replace
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

from ..base import env_float, env_str
from . import tracing as _tracing
from .flight import process_role
from .registry import (MetricsRegistry, _escape_help,
                       interval_over_fraction, interval_percentile)

__all__ = ["TraceContext", "mint", "current", "use",
           "RegistryServer", "scrape_peer", "federate_text",
           "parse_prometheus", "SLOTracker"]

_HEX = re.compile(r"^[0-9a-f]{8,32}$")


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def _global_registry() -> MetricsRegistry:
    from .. import telemetry as _tm
    return _tm.registry()


def _default_secret() -> bytes:
    """The federation wire secret: MXTPU_GATEWAY_SECRET, the SAME
    knob both sides of the disagg KV channel already read — a
    secret-enabled deployment must not need a second secret (or
    silently lose federation because only one side signed)."""
    return env_str(
        "MXTPU_GATEWAY_SECRET", "",
        "Shared secret for the gateway KV-handoff channel and the "
        "metrics-federation scrape RPC (HMAC-SHA256 when set)."
    ).encode()


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TraceContext:
    """One request's trace identity + baggage, carried on every hop.

    ``trace_id`` names the whole request across processes;
    ``span_id`` names the current hop segment (each hop that wants
    its own identity calls :meth:`child`, which also records the
    parent segment); baggage is the small set of request facts every
    hop needs without a lookup: the gateway request id (``rid``), the
    sampling ``seed``, and the ABSOLUTE deadline (0 = none) — enough
    for any process on the path to log, shed, or resume coherently.
    Immutable: hops derive children instead of mutating."""

    trace_id: str
    span_id: str
    rid: int = -1
    seed: int = 0
    deadline_abs: float = 0.0
    parent_id: str = ""

    def child(self) -> "TraceContext":
        """A new segment of the same trace (fresh span_id, this
        segment recorded as its parent) — one per hop: prefill job,
        re-dispatch, a peer process continuing the request."""
        return _dc_replace(self, span_id=_new_id(4),
                           parent_id=self.span_id)

    def fields(self) -> Dict[str, Any]:
        """What every recorded event carries while this context is
        active (merged under the event's args by the tracing layer)."""
        out = {"trace_id": self.trace_id, "span": self.span_id,
               "rid": self.rid}
        if self.parent_id:
            out["parent_span"] = self.parent_id
        return out

    # -- wire form (rpc.attach_context header payload) ---------------------
    def to_wire(self) -> tuple:
        return (self.trace_id, self.span_id, int(self.rid),
                int(self.seed), float(self.deadline_abs))

    @classmethod
    def from_wire(cls, t: Sequence[Any]) -> "TraceContext":
        """Tolerant decode: extra trailing fields from a NEWER sender
        are ignored, missing ones default — the versioned-header
        forward/backward story."""
        t = tuple(t)
        if len(t) < 2 or not isinstance(t[0], str) \
                or not isinstance(t[1], str):
            raise ValueError(f"not a trace-context tuple: {t!r}")
        return cls(trace_id=t[0], span_id=t[1],
                   rid=int(t[2]) if len(t) > 2 else -1,
                   seed=int(t[3]) if len(t) > 3 else 0,
                   deadline_abs=float(t[4]) if len(t) > 4 else 0.0)


def mint(rid: int = -1, seed: int = 0, deadline_abs: float = 0.0,
         trace_id: Optional[str] = None) -> TraceContext:
    """Mint a fresh trace at the front door. A caller-supplied
    ``trace_id`` (an upstream proxy's) is honored when it is plausible
    hex; anything else is replaced rather than letting arbitrary
    client bytes into every log line."""
    tid = (trace_id if trace_id and _HEX.match(str(trace_id).lower())
           else None)
    return TraceContext(
        trace_id=(str(tid).lower() if tid else _new_id(8)),
        span_id=_new_id(4), rid=int(rid), seed=int(seed),
        deadline_abs=float(deadline_abs or 0.0))


_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The thread's active context (None outside any request)."""
    return getattr(_tls, "ctx", None)


@contextmanager
def use(ctx: Optional[TraceContext]):
    """Activate ``ctx`` for this thread (None = no-op): every span or
    instant recorded inside carries the trace fields. Restores the
    previous context on exit, so engine threads that interleave many
    requests never leak one request's identity into another's
    events."""
    if ctx is None:
        yield
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def _provider() -> Optional[Dict[str, Any]]:
    ctx = getattr(_tls, "ctx", None)
    return ctx.fields() if ctx is not None else None


_tracing.set_context_provider(_provider)


# ---------------------------------------------------------------------------
# metrics federation
# ---------------------------------------------------------------------------
_SCRAPE_REQ = ("mxmetrics", 1)


class RegistryServer:
    """Expose a process's metrics registry over the framed RPC — the
    one-liner a worker/kvstore/replica process runs so the gateway's
    ``/metrics`` can federate it:

    ``srv = RegistryServer(port=0, process="prefill0")``

    Protocol: one frame ``("mxmetrics", 1)`` in, one frame
    ``("mxmetrics", 1, process, snapshot)`` out, connection reusable;
    the snapshot is ``MetricsRegistry.snapshot_state()`` (wire-safe
    values — the merge is exact, no text re-parsing). Same HMAC/frame
    discipline as every other socket of the port when ``secret`` is set."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 registry: Optional[MetricsRegistry] = None,
                 process: Optional[str] = None,
                 secret: Optional[bytes] = None):
        from .. import rpc
        self._rpc = rpc
        self.registry = registry
        self.process = process or process_role()
        # None -> the deployment's MXTPU_GATEWAY_SECRET, matching
        # what a federating gateway signs its scrapes with; b"" opts
        # out explicitly
        self._secret = (_default_secret() if secret is None
                        else secret)
        self._closing = False
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"mxtpu-metrics-{self.process}").start()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        rpc = self._rpc
        try:
            conn.settimeout(30.0)
            while not self._closing:
                msg, _ = rpc.recv_msg(conn, self._secret)
                if not (isinstance(msg, tuple) and len(msg) >= 2
                        and msg[0] == _SCRAPE_REQ[0]):
                    rpc.send_msg(conn, ("mxerr", "not a metrics "
                                        "scrape"), self._secret)
                    return
                reg = self.registry or _global_registry()
                rpc.send_msg(
                    conn, ("mxmetrics", 1, self.process,
                           reg.snapshot_state()), self._secret)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass


def scrape_peer(host: str, port: int, *,
                secret: Optional[bytes] = None,
                timeout: float = 5.0) -> Tuple[str, list]:
    """One scrape of a peer :class:`RegistryServer`; returns
    ``(process_name, snapshot)``. Connection per scrape — federation
    must survive peer restarts without connection bookkeeping.
    ``secret=None`` uses the deployment's MXTPU_GATEWAY_SECRET, like
    the server side."""
    from .. import rpc
    if secret is None:
        secret = _default_secret()
    sock = socket.create_connection((host, int(port)),
                                    timeout=timeout)
    try:
        sock.settimeout(timeout)
        rpc.send_msg(sock, _SCRAPE_REQ, secret)
        reply, _ = rpc.recv_msg(sock, secret)
    finally:
        sock.close()
    if not (isinstance(reply, tuple) and len(reply) == 4
            and reply[0] == "mxmetrics"):
        raise rpc.RPCProtocolError(
            f"peer is not an mxtpu metrics endpoint: "
            f"{str(reply)[:80]}")
    return str(reply[2]), list(reply[3])


def _label_key(labels, process: Optional[str] = None
               ) -> Tuple[Tuple[str, str], ...]:
    items = [(str(k), str(v)) for k, v in labels]
    if process is not None:
        items.append(("process", str(process)))
    return tuple(sorted(items))


# exposition formatting is registry.py's, shared — an escaping fix
# there must cover the federated rendering path too
_fmt_labels = MetricsRegistry._fmt_labels


def _emit_scalar(lines: List[str], full: str, key, value) -> None:
    lines.append(f"{full}{_fmt_labels(key)} "
                 f"{MetricsRegistry._fmt_num(value)}")


def _emit_hist(lines: List[str], full: str, key, payload) -> None:
    bounds, counts, total_sum = payload
    cum = 0
    for bound, c in zip(bounds, counts):
        cum += c
        extra = 'le="%s"' % bound
        lines.append(f"{full}_bucket{_fmt_labels(key, extra)} {cum}")
    total = sum(counts)
    inf_extra = 'le="+Inf"'
    lines.append(f"{full}_bucket{_fmt_labels(key, inf_extra)} "
                 f"{total}")
    lines.append(f"{full}_sum{_fmt_labels(key)} "
                 f"{MetricsRegistry._fmt_num(total_sum)}")
    lines.append(f"{full}_count{_fmt_labels(key)} {total}")


def federate_text(registry: Optional[MetricsRegistry],
                  peers: Sequence[Tuple[str, int]], *,
                  process: Optional[str] = None,
                  secret: Optional[bytes] = None,
                  timeout: float = 5.0,
                  prefix: str = "mxtpu") -> str:
    """The federated Prometheus exposition: the local registry plus
    every reachable peer, each series labelled with its ``process``,
    plus one AGGREGATE series per label set (no ``process`` label):
    counters summed, histogram buckets merged element-wise (identical
    bounds — mismatched bounds keep per-process series only), gauges
    last-write in scrape order (local first, then ``peers`` in listed
    order — peers are scraped CONCURRENTLY, one thread each, so the
    whole scrape is bounded by ONE ``timeout``, not timeout×dead
    peers). An unreachable peer is skipped and counted in
    ``federation_errors_total{peer}`` — a scrape must degrade, not
    fail, when one worker is mid-restart."""
    from .. import telemetry as _tm
    reg = registry or _global_registry()
    results: List[Optional[Tuple[str, list]]] = [None] * len(peers)

    def _scrape(i: int, host: str, port: int) -> None:
        try:
            results[i] = scrape_peer(host, port, secret=secret,
                                     timeout=timeout)
        except Exception as e:
            _tm.counter("federation_errors_total",
                        "Peer scrapes that failed during /metrics "
                        "federation", peer=f"{host}:{port}").inc()
            _tm.flight().record("telemetry",
                                "federation_scrape_failed",
                                peer=f"{host}:{port}",
                                error=repr(e)[:120])

    threads = [threading.Thread(target=_scrape, args=(i, h, p),
                                daemon=True)
               for i, (h, p) in enumerate(peers)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout + 1.0
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    # positional collection keeps the documented last-write order
    # deterministic regardless of which peer answered first; a
    # thread still running past the deadline leaves None (skipped —
    # its own error path does the counting when it resolves)
    snaps: List[Tuple[str, list]] = [
        (process or process_role(), reg.snapshot_state())]
    snaps += [r for r in results if r is not None]
    # two peers launched with the same role (or colliding pid-derived
    # defaults) must not emit duplicate series — a real Prometheus
    # server rejects the WHOLE scrape on a duplicate timeseries, so
    # one mislabeled worker would silently kill fleet metrics.
    # Dedup deterministically: first keeps the bare role, repeats get
    # a positional suffix.
    seen_roles: Dict[str, int] = {}
    deduped: List[Tuple[str, list]] = []
    for proc, snap in snaps:
        n = seen_roles.get(proc, 0)
        seen_roles[proc] = n + 1
        deduped.append((proc if n == 0 else f"{proc}~{n}", snap))
    snaps = deduped

    fams: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for proc, snap in snaps:
        for name, kind, help_, kids in snap:
            fam = fams.get(name)
            if fam is None:
                fam = fams[name] = {"kind": kind, "help": help_,
                                    "procs": []}
                order.append(name)
            if fam["kind"] != kind:
                continue            # kind conflict: first writer wins
            if help_ and not fam["help"]:
                fam["help"] = help_
            fam["procs"].append((proc, kids))

    lines: List[str] = []
    for name in sorted(order):
        fam = fams[name]
        full = f"{prefix}_{name}"
        if fam["help"]:
            lines.append(f"# HELP {full} "
                         f"{_escape_help(fam['help'])}")
        lines.append(f"# TYPE {full} {fam['kind']}")
        # aggregate per bare label set, in scrape order
        agg: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        agg_order: List[Tuple[Tuple[str, str], ...]] = []
        for proc, kids in fam["procs"]:
            for labels, payload in kids:
                key = _label_key(labels)
                if key not in agg:
                    agg_order.append(key)
                if fam["kind"] == "counter":
                    prev = agg.get(key, 0.0)
                    agg[key] = (None if prev is None
                                else prev + float(payload))
                elif fam["kind"] == "gauge":
                    agg[key] = float(payload)      # last write wins
                else:
                    prev = agg.get(key)
                    if prev is None and key in agg:
                        continue                   # poisoned: bounds
                    #                                mismatch earlier
                    if prev is None:
                        bounds, counts, s = payload
                        agg[key] = (list(bounds), list(counts),
                                    float(s))
                    elif list(prev[0]) == list(payload[0]):
                        prev_counts = [a + b for a, b in
                                       zip(prev[1], payload[1])]
                        agg[key] = (prev[0], prev_counts,
                                    prev[2] + float(payload[2]))
                    else:
                        agg[key] = None            # bounds mismatch:
                        #                            no exact merge
        for key in sorted(agg_order):
            payload = agg[key]
            if payload is None:
                continue
            if fam["kind"] == "histogram":
                _emit_hist(lines, full, key, payload)
            else:
                _emit_scalar(lines, full, key, payload)
        # per-process series, process label added
        for proc, kids in fam["procs"]:
            for labels, payload in sorted(
                    kids, key=lambda lp: _label_key(lp[0])):
                key = _label_key(labels, process=proc)
                if fam["kind"] == "histogram":
                    _emit_hist(lines, full, key, payload)
                else:
                    _emit_scalar(lines, full, key, payload)
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# exposition parser (grammar tests; diagnose)
# ---------------------------------------------------------------------------
_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE_RE = re.compile(
    rf"^({_NAME_RE})(?:\{{(.*)\}})? "
    r"(-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)|[+-]Inf|NaN)$")


def _parse_labels(body: str) -> Tuple[Tuple[str, str], ...]:
    out: List[Tuple[str, str]] = []
    i, n = 0, len(body)
    while i < n:
        m = re.match(rf"({_NAME_RE})=\"", body[i:])
        if not m:
            raise ValueError(f"bad label at ...{body[i:i+40]!r}")
        name = m.group(1)
        i += m.end()
        val: List[str] = []
        while True:
            if i >= n:
                raise ValueError("unterminated label value")
            c = body[i]
            if c == "\\":
                if i + 1 >= n:
                    raise ValueError("dangling escape")
                esc = body[i + 1]
                val.append({"\\": "\\", '"': '"', "n": "\n"}.get(
                    esc, "\\" + esc))
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                val.append(c)
                i += 1
        out.append((name, "".join(val)))
        if i < n:
            if body[i] != ",":
                raise ValueError(
                    f"expected ',' between labels at "
                    f"...{body[i:i+40]!r}")
            i += 1
    return tuple(sorted(out))


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Strict text-format 0.0.4 parser — the federation grammar
    test's oracle (and a programmatic reader for diagnose). Raises
    ``ValueError`` on any malformed line. Returns ``{"types":
    {name: kind}, "help": {name: text}, "samples": {(name,
    sorted-label-tuple): value}}``."""
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary",
                    "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 4:
                raise ValueError(f"line {lineno}: bad HELP: {line!r}")
            helps[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue                       # comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: bad sample: {line!r}")
        name, body, value = m.groups()
        labels = _parse_labels(body) if body else ()
        if (name, labels) in samples:
            # a duplicate timeseries makes a real Prometheus server
            # reject the whole scrape — the oracle must be as strict
            raise ValueError(
                f"line {lineno}: duplicate series {name}"
                f"{dict(labels)}")
        samples[(name, labels)] = float(value)
    return {"types": types, "help": helps, "samples": samples}


# ---------------------------------------------------------------------------
# SLO gauges + burn rate
# ---------------------------------------------------------------------------
class SLOTracker:
    """Derived serving SLO gauges over the registry histograms the
    serve tier already populates — no new instrumentation, just the
    windowed read:

    - ``gateway_slo_p99_ms{slo}``: interval p99 of the underlying
      histogram since the last tick (the shared
      ``registry.interval_percentile`` bucket-diff);
    - ``gateway_slo_target_ms{slo}``: the configured target;
    - ``gateway_slo_burn_rate{slo}``: fraction of the window's
      observations over target, divided by the error budget
      (``1 - q/100``) — the classic burn rate: ``1.0`` = consuming
      budget exactly as fast as allowed, above = on course to violate.

    SLOs: ``ttft`` over ``gateway_ttft_ms`` and ``token`` over
    ``serve_token_latency_ms``, enabled by their targets
    (``MXTPU_GATEWAY_SLO_TTFT_MS`` / ``MXTPU_GATEWAY_SLO_TOKEN_MS``;
    0 = off). Ticks are rate-limited to ``window_s`` so scrapes and
    the gateway maintenance loop share one stable window; ``/healthz``
    reports ``degraded`` while any burn rate exceeds the threshold
    (``MXTPU_GATEWAY_SLO_BURN``)."""

    METRICS = {"ttft": "gateway_ttft_ms",
               "token": "serve_token_latency_ms"}

    def __init__(self, targets: Dict[str, float], *, q: float = 99.0,
                 burn_threshold: float = 1.0, window_s: float = 10.0,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 instruments: Optional[Dict[str, Any]] = None,
                 labels: Optional[Dict[str, str]] = None):
        unknown = set(targets) - set(self.METRICS)
        if unknown:
            raise ValueError(f"unknown SLOs {sorted(unknown)}; "
                             f"known: {sorted(self.METRICS)}")
        self.targets = {k: float(v) for k, v in targets.items()
                        if v and v > 0}
        self.q = float(q)
        self.burn_threshold = float(burn_threshold)
        self.window_s = float(window_s)
        self._registry = registry
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._prev: Dict[str, List[int]] = {}
        self._last_tick: Optional[float] = None
        self._last: Dict[str, Dict[str, Optional[float]]] = {}
        # per-model gateways hand their OWN histogram children here
        # (e.g. gateway_ttft_ms{model=...}) instead of the registry's
        # unlabeled default, and label the derived gauges to match —
        # two models' trackers then coexist in one registry without
        # clobbering each other's gateway_slo_* series
        self._instruments = dict(instruments or {})
        labels = dict(labels or {})
        from .. import telemetry as _tm
        self._g_p99 = {s: _tm.gauge(
            "gateway_slo_p99_ms",
            "Interval p99 of the SLO's latency histogram since the "
            "last SLO window tick", slo=s, **labels)
            for s in self.targets}
        self._g_target = {s: _tm.gauge(
            "gateway_slo_target_ms", "Configured SLO latency target",
            slo=s, **labels) for s in self.targets}
        self._g_burn = {s: _tm.gauge(
            "gateway_slo_burn_rate",
            "Fraction of the window's observations over target, "
            "divided by the error budget (1 - q/100); > 1 burns "
            "budget faster than allowed", slo=s, **labels)
            for s in self.targets}
        for s, t in self.targets.items():
            self._g_target[s].set(t)

    @classmethod
    def from_spec(cls, spec: Dict[str, float], *,
                  clock: Optional[Callable[[], float]] = None,
                  instruments: Optional[Dict[str, Any]] = None,
                  labels: Optional[Dict[str, str]] = None
                  ) -> Optional["SLOTracker"]:
        """Explicit-targets constructor (per-model SLOs in a fleet —
        one process, many trackers, so the env singleton does not
        fit): ``{"ttft_ms": 200, "token_ms": 50, "burn": 1.0,
        "window_s": 10}``, zero/absent targets disabled. None when no
        target survives, mirroring :meth:`from_env`."""
        spec = dict(spec or {})
        targets = {k: v for k, v in
                   (("ttft", float(spec.pop("ttft_ms", 0.0))),
                    ("token", float(spec.pop("token_ms", 0.0))))
                   if v > 0}
        burn = float(spec.pop("burn", 1.0))
        window = float(spec.pop("window_s", 10.0))
        if spec:
            raise ValueError(f"unknown SLO spec keys {sorted(spec)}")
        if not targets:
            return None
        return cls(targets, burn_threshold=burn, window_s=window,
                   clock=clock, instruments=instruments,
                   labels=labels)

    @classmethod
    def from_env(cls, clock: Optional[Callable[[], float]] = None, *,
                 instruments: Optional[Dict[str, Any]] = None,
                 labels: Optional[Dict[str, str]] = None
                 ) -> Optional["SLOTracker"]:
        """The gateway's constructor path: None when no SLO target is
        configured (the tracker, its gauges and its /healthz input
        all stay absent)."""
        ttft = env_float(
            "MXTPU_GATEWAY_SLO_TTFT_MS", 0.0,
            "Target p99 time-to-first-token (ms) for the gateway SLO "
            "gauges + burn rate; 0 disables the ttft SLO.")
        token = env_float(
            "MXTPU_GATEWAY_SLO_TOKEN_MS", 0.0,
            "Target p99 inter-token latency (ms) for the gateway SLO "
            "gauges + burn rate; 0 disables the token SLO.")
        burn = env_float(
            "MXTPU_GATEWAY_SLO_BURN", 1.0,
            "Burn-rate threshold above which /healthz reports "
            "status=degraded (1.0 = consuming error budget exactly "
            "as fast as allowed).")
        window = env_float(
            "MXTPU_GATEWAY_SLO_WINDOW_S", 10.0,
            "Minimum SLO tick window (seconds): scrapes/maintenance "
            "passes inside the window reuse the last computed "
            "p99/burn instead of chopping it into noise.")
        targets = {k: v for k, v in
                   (("ttft", ttft), ("token", token)) if v > 0}
        if not targets:
            return None
        return cls(targets, burn_threshold=burn, window_s=window,
                   clock=clock, instruments=instruments,
                   labels=labels)

    def tick(self, force: bool = False) -> Dict[str, Dict[str, Any]]:
        """Advance the window if it is due (or ``force``) and return
        the per-SLO ``{"p99_ms", "burn", "target_ms"}`` snapshot."""
        reg = self._registry or _global_registry()
        with self._lock:
            now = self._clock()
            if (not force and self._last_tick is not None
                    and now - self._last_tick < self.window_s):
                return {s: dict(v) for s, v in self._last.items()}
            self._last_tick = now
            out: Dict[str, Dict[str, Any]] = {}
            for slo, target in self.targets.items():
                h = (self._instruments.get(slo)
                     or reg.get(self.METRICS[slo]))
                p99 = burn = None
                if h is not None:
                    counts, _, _ = h.snapshot()
                    prev = self._prev.get(slo)
                    self._prev[slo] = counts
                    p99 = interval_percentile(h.bounds, prev, counts,
                                              self.q)
                    frac = interval_over_fraction(h.bounds, prev,
                                                  counts, target)
                    if frac is not None:
                        budget = max(1e-9, 1.0 - self.q / 100.0)
                        burn = frac / budget
                self._g_p99[slo].set(p99 if p99 is not None else 0.0)
                self._g_burn[slo].set(burn if burn is not None
                                      else 0.0)
                out[slo] = {"p99_ms": p99, "burn": burn,
                            "target_ms": target}
            self._last = out
            return {s: dict(v) for s, v in out.items()}

    @staticmethod
    def _breached(last: Dict[str, Dict[str, Any]],
                  threshold: float) -> bool:
        return any(v.get("burn") is not None
                   and v["burn"] > threshold for v in last.values())

    @property
    def breached(self) -> bool:
        """True while any SLO's last-computed burn rate exceeds the
        threshold — the /healthz degraded input."""
        with self._lock:
            return self._breached(self._last, self.burn_threshold)

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            slos = {s: dict(v) for s, v in self._last.items()}
            breached = self._breached(self._last,
                                      self.burn_threshold)
        for s, t in self.targets.items():
            slos.setdefault(s, {"p99_ms": None, "burn": None,
                                "target_ms": t})
        return {"slos": slos, "burn_threshold": self.burn_threshold,
                "breached": breached}
