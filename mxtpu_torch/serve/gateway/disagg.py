"""Disaggregated prefill/decode (DistServe, OSDI '24), the port of
``mxtpu/serve/gateway/disagg.py``: prefill is compute-bound (one big
batched matmul pass over the prompt), decode is memory-bound
(weight+KV streaming per token) — colocating them makes each steal the
other's resource. This module splits them into independent pools
joined by a KV handoff:

- :class:`PrefillWorker` — runs the port's ``llama.prefill_detached``
  (one watched program per prompt bucket) on its device, copies the
  per-request KV block to the host once the program is done, and ships
  it over the channel.
- :class:`KVChannel` — the handoff wire: ``mxtpu_torch.rpc`` framed
  messages (the reference's codec byte for byte, HMAC, frame-size
  ceiling)
  over a socketpair (same host) or TCP (``listen``/``connect`` — the
  cross-host deployment, prefill pool on compute-heavy hosts, decode
  pool on HBM-heavy ones).
- :class:`DisaggBackend` — the Gateway-facing composition: routes
  prompts to the least-queued prefill worker, a feeder thread receives
  handoffs and seats them in the least-loaded decode replica via
  ``ServeEngine.submit_prefilled`` (→ ``llama.inject_slot_kv``).

Self-healing: TCP channels carry an HMAC hello handshake on
every (re)connect and an ACK per handoff frame. A severed connection
reconnects with exponential backoff (``rpc.connect_with_backoff`` —
the kvstore client discipline, shared) and RESENDS the un-acked frame;
the receive side re-accepts and the pending-table pop dedups a frame
whose ack (not delivery) was lost. A wrong secret fails the handshake
FAST (``RPCAuthError`` — never retried); a corrupted frame from an
already-authenticated peer poisons only that connection (drop +
re-accept + resend). A prefill worker that dies is respawned and its
in-flight job resubmitted ONCE (the DataLoader dead-worker pattern);
sustained prefill-path failure trips a circuit breaker that falls
back to COLOCATED prefill on the decode replicas — ``prefill_slot``
is the same graph/sampler/rng chain as detached+inject, so the
fallback stays bit-identical while ``/healthz`` reports ``degraded``.

Bit-identity: ``prefill_detached`` is the same forward graph, sampler
and rng chain as ``prefill_slot``; the block crosses the wire as raw
bytes; ``inject_slot_kv`` is the scatter ``prefill_slot`` would have
done. So a disaggregated request's tokens are bit-identical to the
colocated engine — with or without injected faults.

Blocks cross the wire as numpy arrays, bfloat16 as ml_dtypes'
bfloat16 over the same bytes (what the reference ships, so either
package decodes the other's frames); the receive side hands a bfloat16
block to the engine as a CPU tensor, since numpy has no bfloat16 of
its own. Workers and decode engines run on ``device``: the card unless
the caller names another.
"""
from __future__ import annotations

import itertools
import queue
import socket
import threading
import time
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import prng, rpc, telemetry
from ...base import env_float, env_int, env_str
from ...context import DeviceLike, resolve_device
from ...cuda_graphs import capture_graph
from ...models import llama
from ...telemetry import distributed as dtrace, watcher
from ..engine import (KVHandoff, Request, ServeEngine, _tensor_leaves,
                      bucket_for, cancel_counter)
from .replica import (EngineReplica, NoHealthyReplicas, ReplicaSet,
                      Ticket)

__all__ = ["KVChannel", "PrefillWorker", "DisaggBackend",
           "CircuitBreaker"]

_HELLO = ("kvhello", "mxtpu-kv")
_HELLO_ACK = ("kvhello-ack", "mxtpu-kv")


def _channel_secret() -> bytes:
    return env_str(
        "MXTPU_GATEWAY_SECRET", "",
        "Shared secret for the gateway KV-handoff channel: every "
        "handoff frame is HMAC-SHA256-authenticated when set (the "
        "kvstore wire discipline). REQUIRED when prefill and decode "
        "pools ride TCP across hosts.").encode()


class KVChannel:
    """One framed-RPC handoff pipe. Thread-safe on both sides (many
    prefill workers share the send side; one feeder drains the
    receive side).

    TCP channels self-heal: pass ``redial`` (send side) or build the
    receive side with ``accept(..., reaccept=True)`` and a severed
    connection is re-dialed/re-accepted with backoff, re-authenticated
    via the HMAC hello handshake, and the interrupted handoff resent
    (:meth:`send_handoff` / :meth:`recv_handoff` — the ACKed, reliable
    surface the disagg pools use; raw :meth:`send`/:meth:`recv` stay
    as the unacknowledged primitive). Socketpair channels have no
    redial path and keep the fail-fast behavior."""

    def __init__(self, sock: socket.socket,
                 secret: Optional[bytes] = None, *,
                 redial: Optional[Callable[[], socket.socket]] = None,
                 listener: Optional[socket.socket] = None):
        self._sock: Optional[socket.socket] = sock
        self._secret = (_channel_secret() if secret is None
                        else secret)
        self._redial = redial
        self._listener = listener
        self._closing = False
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._retry_deadline_s = env_float(
            "MXTPU_GATEWAY_KV_RETRY_DEADLINE_S", 30.0,
            "Total reconnect+resend budget per KV-handoff frame "
            "before the prefill worker gives the request up (size it "
            "to cover a decode-host restart).")
        self._m_bytes = telemetry.histogram(
            "gateway_kv_handoff_bytes",
            "KV-handoff frame sizes on the prefill→decode channel",
            buckets=telemetry.BYTES_BUCKETS)
        self._m_count = telemetry.counter(
            "gateway_kv_handoffs_total",
            "KV blocks shipped prefill→decode")
        self._m_reconnects = telemetry.counter(
            "gateway_kv_reconnects_total",
            "KV-handoff channel reconnections (severed + re-dialed "
            "or re-accepted, HMAC re-authenticated)")
        self._m_resends = telemetry.counter(
            "gateway_kv_resends_total",
            "Handoff frames resent after a connection fault")
        self._m_frame_errors = telemetry.counter(
            "gateway_kv_frame_errors_total",
            "Torn/corrupt/unauthenticated frames dropped by the "
            "receive side (connection poisoned + re-accepted)")

    # -- construction ---------------------------------------------------------
    @classmethod
    def pair(cls, secret: Optional[bytes] = None
             ) -> Tuple["KVChannel", "KVChannel"]:
        """Same-process pair (the in-tree topology: pools as thread
        groups, handoff still through the real wire codec). No
        reconnect path — a severed socketpair is a process bug, not a
        network fault."""
        a, b = socket.socketpair()
        return cls(a, secret=secret), cls(b, secret=secret)

    @classmethod
    def listen(cls, host: str = "127.0.0.1", port: int = 0,
               secret: Optional[bytes] = None
               ) -> Tuple[socket.socket, int]:
        """Decode-side accept socket for cross-host pools; returns
        (listener, bound_port) — call :meth:`accept` next."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(8)
        return srv, srv.getsockname()[1]

    @classmethod
    def accept(cls, listener: socket.socket,
               secret: Optional[bytes] = None, *,
               reaccept: bool = False) -> "KVChannel":
        """Accept + HMAC-handshake one peer. ``reaccept=True`` keeps
        the listener on the channel: a later severed/corrupted
        connection is replaced by accepting (and re-authenticating)
        the peer's redial instead of killing the feeder."""
        sec = _channel_secret() if secret is None else secret
        conn, _ = listener.accept()
        cls._handshake_server(conn, sec)
        return cls(conn, secret=sec,
                   listener=listener if reaccept else None)

    @classmethod
    def connect(cls, host: str, port: int,
                secret: Optional[bytes] = None,
                timeout: float = 30.0) -> "KVChannel":
        """Dial + HMAC-handshake the decode side; the dialer is kept
        as the channel's ``redial`` so ``send_handoff`` can reconnect
        through a severed wire."""
        sec = _channel_secret() if secret is None else secret

        def dial() -> socket.socket:
            s = socket.create_connection((host, port), timeout=timeout)
            s.settimeout(timeout)
            return s

        sock = dial()
        cls._handshake_client(sock, sec)
        return cls(sock, secret=sec, redial=dial)

    # -- the HMAC hello handshake --------------------------------------------
    # Re-auth on every (re)connect, the PS client's heartbeat
    # discipline: a wrong-secret or foreign peer fails HERE — as
    # RPCAuthError/RPCProtocolError, which connect_with_backoff NEVER
    # retries — instead of poisoning the first real handoff.
    @staticmethod
    def _handshake_client(sock: socket.socket, secret: bytes) -> None:
        rpc.send_msg(sock, _HELLO, secret)
        reply, _ = rpc.recv_msg(sock, secret)
        if tuple(reply) != _HELLO_ACK:
            raise rpc.RPCProtocolError(
                f"peer is not an mxtpu KV-handoff endpoint: "
                f"{str(reply)[:80]}")

    @staticmethod
    def _handshake_server(sock: socket.socket, secret: bytes) -> None:
        try:
            msg, _ = rpc.recv_msg(sock, secret)
        except rpc.RPCAuthError:
            # tell the dialer its auth was REJECTED before closing: the
            # unauthenticated error frame fails the dialer's own MAC
            # check, so IT raises RPCAuthError too — both sides fail
            # fast instead of one retrying a misconfiguration forever
            try:
                rpc.send_msg(sock, ("kvhello-err", "auth"))
            except OSError:
                pass
            raise
        if tuple(msg) != _HELLO:
            raise rpc.RPCProtocolError(
                f"peer is not an mxtpu KV-handoff endpoint: "
                f"{str(msg)[:80]}")
        rpc.send_msg(sock, _HELLO_ACK, secret)

    # -- raw (unacknowledged) primitives -------------------------------------
    def send(self, msg: Any) -> None:
        with self._send_lock:
            n = rpc.send_msg(self._sock, msg, self._secret)
        self._m_bytes.observe(n)
        self._m_count.inc()

    def recv(self) -> Any:
        with self._recv_lock:
            msg, _ = rpc.recv_msg(self._sock, self._secret)
        return msg

    # -- reliable handoff surface --------------------------------------------
    def _reconnect_locked(self,
                          deadline: Optional[float] = None) -> None:
        """Send-side: re-dial + re-auth under the send lock, bounded
        by the CALLER's frame deadline when given — a fresh budget per
        reconnect attempt would let one frame's give-up time reach a
        multiple of the documented MXTPU_GATEWAY_KV_RETRY_DEADLINE_S."""
        if self._redial is None:
            raise ConnectionError(
                "kv channel severed and not re-dialable")
        if deadline is None:
            deadline = time.monotonic() + self._retry_deadline_s
        sock = rpc.connect_with_backoff(
            self._redial, deadline,
            verify=lambda s: self._handshake_client(s, self._secret))
        self._sock = sock
        self._m_reconnects.inc()
        telemetry.flight().record("gateway", "kv_reconnect")

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def send_handoff(self, msg: Any) -> None:
        """Reliable send: frame + await the receiver's ack; on a
        connection fault reconnect (backoff + HMAC re-auth) and
        RESEND. The receiver's pending-table pop dedups the
        delivered-but-unacked case. RPCAuthError propagates
        immediately — an auth failure can only repeat.

        The ack round-trip runs under the send lock, so concurrent
        prefill workers serialize at one frame per seat round-trip.
        That is deliberate: it keeps frame/ack pairing trivial under
        reconnect, and prefill COMPUTE dominates the RTT at today's
        scales. If the channel ever becomes the bottleneck, the acks
        already carry the rid — correlate them through a dispatcher
        to pipeline sends without changing the wire format."""
        deadline = time.monotonic() + self._retry_deadline_s
        sent_once = False
        while True:
            try:
                with self._send_lock:
                    if self._sock is None:
                        self._reconnect_locked(deadline)
                    n = rpc.send_msg(self._sock, msg, self._secret)
                    if sent_once:
                        self._m_resends.inc()
                    reply, _ = rpc.recv_msg(self._sock, self._secret)
                if not (isinstance(reply, tuple) and len(reply) == 2
                        and reply[0] == "kvack"):
                    raise rpc.RPCProtocolError(
                        f"expected handoff ack, got {str(reply)[:80]}")
                self._m_bytes.observe(n)
                self._m_count.inc()
                return
            except rpc.RPCAuthError:
                with self._send_lock:
                    self._drop_locked()
                raise               # secret mismatch: never retried
            except (ConnectionError, OSError) as e:
                with self._send_lock:
                    self._drop_locked()
                sent_once = True
                if self._closing or self._redial is None \
                        or time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"kv handoff not deliverable: {e}") from e
                telemetry.flight().record("gateway", "kv_send_retry",
                                          error=repr(e)[:120])

    def recv_handoff(self) -> Any:
        """Reliable receive: one verified frame, acked back to the
        sender. A torn/corrupt/misauthenticated frame on a
        re-acceptable channel poisons only the CONNECTION (drop +
        re-accept + re-auth); the sender resends. On a channel without
        a listener the error propagates (socketpair topology keeps
        the old fail-fast contract). A wrong-secret peer fails the
        re-accept handshake loudly — no retry loop."""
        while True:
            try:
                with self._recv_lock:
                    msg, _ = rpc.recv_msg(self._sock, self._secret)
                # ack on the PAYLOAD: a frame wrapped in the
                # trace-context header acks exactly like a bare one
                inner, _ctx = rpc.split_context(msg)
                if (isinstance(inner, tuple) and len(inner) >= 2
                        and inner[0] in ("kv", "kverr",
                                         "kvpage", "kvdone")):
                    with self._send_lock:
                        rpc.send_msg(self._sock, ("kvack", inner[1]),
                                     self._secret)
                return msg
            except (rpc.RPCAuthError, rpc.RPCProtocolError) as e:
                # the peer AUTHENTICATED at accept time, so this is
                # wire damage or desync, not misconfiguration:
                # quarantine the connection, take the redial
                if self._closing or self._listener is None:
                    raise
                self._m_frame_errors.inc()
                telemetry.flight().record(
                    "gateway", "kv_frame_error", error=repr(e)[:120])
                self._reaccept()
            except (ConnectionError, OSError):
                if self._closing or self._listener is None:
                    raise
                self._reaccept()

    def _reaccept(self) -> None:
        with self._recv_lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            conn, _ = self._listener.accept()
            # re-auth: a wrong-secret redial fails HERE, fast
            self._handshake_server(conn, self._secret)
            self._sock = conn
        self._m_reconnects.inc()
        telemetry.flight().record("gateway", "kv_reaccept")

    def close(self) -> None:
        self._closing = True
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()


def _host_array(x) -> np.ndarray:
    """A K/V block as the wire carries it: a numpy array as is; a
    tensor copied to the host, bfloat16 viewed as ml_dtypes' bfloat16
    over the same bytes (the reference's wire dtype)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _host_block(a):
    """A received block as the engine seats it: numpy where numpy has
    the dtype, a CPU tensor over the same bytes for bfloat16. A frame's
    arrays view its read-only buffer, and torch refuses to share those:
    such a block is copied once."""
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return a


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def handoff_to_wire(rid: int, h: KVHandoff) -> tuple:
    return ("kv", int(rid), int(h.true_len), int(h.token),
            _host_array(h.k), _host_array(h.v),
            np.asarray(h.rng, np.uint32))


def wire_to_handoff(msg: tuple) -> Tuple[int, KVHandoff]:
    if not (isinstance(msg, tuple) and len(msg) == 7
            and msg[0] == "kv"):
        raise rpc.RPCProtocolError(
            f"not a KV-handoff frame: {str(msg)[:80]}")
    _, rid, true_len, token, k, v, rng = msg
    return int(rid), KVHandoff(k=_host_block(k), v=_host_block(v),
                               true_len=int(true_len),
                               token=int(token), rng=rng)


def handoff_to_page_frames(rid: int, h: KVHandoff,
                           page_size: int) -> List[tuple]:
    """Page-granular wire encoding (the paged-KV handoff): the block
    is TRIMMED to the page multiple covering ``true_len`` — prompt-
    bucket padding never crosses the wire — and split into one
    ``kvpage`` frame per page, closed by a ``kvdone`` frame carrying
    the scalars. Each frame rides :meth:`KVChannel.send_handoff`
    (acked, resend-safe: the receiver keys chunks by index, so a
    resent page overwrites itself)."""
    k, v = _host_array(h.k), _host_array(h.v)
    n = min(k.shape[2], -(-int(h.true_len) // page_size) * page_size)
    frames: List[tuple] = [
        ("kvpage", int(rid), i // page_size,
         k[:, :, i:i + page_size], v[:, :, i:i + page_size])
        for i in range(0, n, page_size)]
    frames.append(("kvdone", int(rid), int(h.true_len), int(h.token),
                   np.asarray(h.rng, np.uint32), len(frames)))
    return frames


def pages_to_handoff(done: tuple,
                     parts: Dict[int, Tuple[np.ndarray, np.ndarray]]
                     ) -> Tuple[int, KVHandoff]:
    """Reassemble a page-granular handoff from its ``kvdone`` frame +
    the ``kvpage`` chunks received for that rid. A missing chunk is a
    protocol error (the acked channel should make it impossible)."""
    if not (isinstance(done, tuple) and len(done) == 6
            and done[0] == "kvdone"):
        raise rpc.RPCProtocolError(
            f"not a kvdone frame: {str(done)[:80]}")
    _, rid, true_len, token, rng, n_chunks = done
    missing = [i for i in range(int(n_chunks)) if i not in parts]
    if missing:
        raise rpc.RPCProtocolError(
            f"kv handoff rid={rid} missing page chunks {missing[:8]}")
    k = np.concatenate([parts[i][0] for i in range(int(n_chunks))],
                       axis=2)
    v = np.concatenate([parts[i][1] for i in range(int(n_chunks))],
                       axis=2)
    return int(rid), KVHandoff(k=_host_block(k), v=_host_block(v),
                               true_len=int(true_len), token=int(token),
                               rng=np.asarray(rng, np.uint32))


class _PageBuffer:
    """Feeder-side INCREMENTAL reassembly of a page-granular handoff:
    each kvpage frame is copied into a growing host block on arrival
    (idempotent by page index — a resent frame overwrites itself in
    place), so by the time the closing kvdone lands the block is
    already assembled and the kvdone → seat path does no
    concatenation work. With a streaming worker those copies overlap
    prefill compute; with the one-shot worker the behavior is
    unchanged except the assembly moving off the seat path. Frames
    ride an ordered acked channel, so the first frame's width IS the
    page size (only the last page may be short)."""

    __slots__ = ("k", "v", "have", "ps")

    def __init__(self):
        self.k: Optional[np.ndarray] = None
        self.v: Optional[np.ndarray] = None
        self.have: Dict[int, int] = {}      # page idx -> width
        self.ps = 0

    def add(self, idx: int, kc, vc) -> None:
        kc, vc = np.asarray(kc), np.asarray(vc)
        idx, w = int(idx), int(kc.shape[2])
        if self.ps == 0:
            self.ps = w
        elif w > self.ps:
            raise rpc.RPCProtocolError(
                f"kvpage width {w} exceeds page size {self.ps}")
        need = idx * self.ps + w
        if self.k is None or self.k.shape[2] < need:
            cap = max(need, 2 * (self.k.shape[2]
                                 if self.k is not None else 0))
            nk = np.zeros(kc.shape[:2] + (cap,) + kc.shape[3:],
                          kc.dtype)
            nv = np.zeros_like(nk)
            if self.k is not None:
                nk[:, :, :self.k.shape[2]] = self.k
                nv[:, :, :self.v.shape[2]] = self.v
            self.k, self.v = nk, nv
        off = idx * self.ps
        self.k[:, :, off:off + w] = kc
        self.v[:, :, off:off + w] = vc
        self.have[idx] = w

    def finish(self, done: tuple) -> Tuple[int, KVHandoff]:
        """Close out on the kvdone frame — same contract as
        :func:`pages_to_handoff`, minus the concatenation."""
        if not (isinstance(done, tuple) and len(done) == 6
                and done[0] == "kvdone"):
            raise rpc.RPCProtocolError(
                f"not a kvdone frame: {str(done)[:80]}")
        _, rid, true_len, token, rng, n_chunks = done
        n_chunks = int(n_chunks)
        missing = [i for i in range(n_chunks) if i not in self.have]
        if missing or n_chunks < 1:
            raise rpc.RPCProtocolError(
                f"kv handoff rid={rid} missing page chunks "
                f"{missing[:8]}")
        n = (n_chunks - 1) * self.ps + self.have[n_chunks - 1]
        return int(rid), KVHandoff(
            k=_host_block(self.k[:, :, :n]),
            v=_host_block(self.v[:, :, :n]),
            true_len=int(true_len), token=int(token),
            rng=np.asarray(rng, np.uint32))


class CircuitBreaker:
    """Consecutive-failure breaker over the prefill path. closed →
    normal routing; ``threshold`` consecutive failures → OPEN
    (colocated-prefill fallback, ``/healthz`` degrades); after
    ``cooldown_s`` one probe request is let through (HALF-OPEN) —
    its success closes the breaker, its failure re-opens the clock.
    Thread-safe; every transition hits
    ``gateway_breaker_transitions_total{to}`` and the flight ring."""

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.threshold = (threshold if threshold is not None
                          else env_int(
                              "MXTPU_GATEWAY_BREAKER_THRESHOLD", 3,
                              "Consecutive prefill-path failures "
                              "(worker deaths, failed jobs, channel "
                              "give-ups) that trip the disagg "
                              "circuit breaker into colocated-"
                              "prefill fallback."))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else env_float(
                               "MXTPU_GATEWAY_BREAKER_COOLDOWN_S",
                               30.0,
                               "Seconds an OPEN disagg breaker waits "
                               "before letting one half-open probe "
                               "request test the prefill pool."))
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self.trips = 0
        self._opened_at = 0.0
        self._half_open_at = 0.0
        self._m: Dict[str, Any] = {}

    def _transition(self, to: str) -> None:
        self._state = to
        m = self._m.get(to)
        if m is None:
            m = self._m[to] = telemetry.counter(
                "gateway_breaker_transitions_total",
                "Disagg circuit-breaker state transitions", to=to)
        m.inc()
        telemetry.flight().record("gateway", "breaker", state=to,
                                  failures=self._failures)

    def allow(self) -> bool:
        """True → use the prefill pool; False → colocated fallback.
        An OPEN breaker past its cooldown grants exactly ONE half-open
        probe per cooldown window."""
        with self._lock:
            if self._state == "closed":
                return True
            now = self._clock()
            if self._state == "open" \
                    and now - self._opened_at >= self.cooldown_s:
                self._half_open_at = now
                self._transition("half_open")
                return True          # the one probe
            if self._state == "half_open" \
                    and now - self._half_open_at >= self.cooldown_s:
                # the last probe never resolved (cancelled mid-
                # prefill, client gone): re-grant rather than strand
                # the breaker in half_open forever
                self._half_open_at = now
                return True
            return False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open" \
                    or (self._state == "closed"
                        and self._failures >= self.threshold):
                self._opened_at = self._clock()
                self.trips += 1
                self._transition("open")

    def record_success(self) -> None:
        with self._lock:
            if self._state == "open":
                # a straggler handoff submitted BEFORE the trip: its
                # success says nothing about the pool now — hold open
                # for the cooldown and let the half-open probe decide,
                # else the breaker flaps on every in-flight leftover
                return
            self._failures = 0
            if self._state != "closed":
                self._transition("closed")

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    "trips": self.trips,
                    "threshold": self.threshold}


class _ChunkProgram:
    """The streamed-prefill chunk program of one bucket:
    :func:`llama.prefill_detached_chunk` over a bucket-sized K/V cache
    that this object owns and every request of the bucket reuses.

    On the CPU it is the eager function, its position a host int. On a
    CUDA device it is one CUDA graph, captured at the first call (after
    a warm-up run on a side stream) and replayed for every chunk after
    that: the chunk's tokens, its start position (a 0-d device tensor),
    ``true_len``, the request key and the sampling knobs ((1,) tensors:
    the sampler's traced mode, which gives the static mode's tokens)
    are static device buffers, staged by device copies and fills, never
    read back to the host; the RoPE tables are the graph's own. A call
    returns (tok, k_chunk, v_chunk, the carried key), each cloned out
    of the graph's outputs on the current stream before the next replay
    can write them. A capture that fails raises: there is no eager
    fallback on the card.

    The reused cache is left dirty by the previous request: a position
    past the causal prefix is masked to -inf before the softmax, so its
    weight is exactly 0 and its stale (finite) K/V add nothing; a fresh
    cache gives the same bits. It is a watchable program
    (``telemetry.watch``): ``_cache_size()`` is its captures on the
    card and, on the CPU, 1 once it has run; the build (the capture, or
    the CPU's first chunk) runs inside ``watcher.build(name)``."""

    def __init__(self, cfg, params, bucket: int, cw: int,
                 device: torch.device, name: str):
        self.cfg, self.params, self.cw, self.name = cfg, params, cw, name
        self.device = device
        cache = llama.init_cache(cfg, 1, bucket, device=device)
        self.k, self.v = cache["k"], cache["v"]
        self.calls = 0
        self.captures = 0
        self._graph = None

    def _cache_size(self) -> int:
        if self.device.type == "cuda":
            return self.captures
        return int(self.calls > 0)

    def __call__(self, padded, pos: int, true_len: int, key, temperature,
                 top_k, top_p):
        self.calls += 1
        if self.device.type != "cuda":
            cache = {"k": self.k, "v": self.v, "pos": pos}
            run = partial(llama.prefill_detached_chunk, self.cfg,
                          self.params, padded[:, pos:pos + self.cw], cache,
                          true_len, key, temperature, top_k, top_p)
            if self.calls > 1:
                return run()[:4]
            with watcher.build(self.name), watcher.counted():
                return run()[:4]
        if self._graph is None:
            self._capture(padded, key)
        self._stage(padded, pos, true_len, key, temperature, top_k, top_p)
        self._graph.replay()
        return tuple(o.clone() for o in self._out)

    def _stage(self, padded, pos, true_len, key, temperature, top_k,
               top_p) -> None:
        """Write one chunk's inputs into the static buffers: device
        copies and scalar fills, no host-to-device transfer."""
        self._tokens.copy_(padded[:, pos:pos + self.cw])
        self._pos.fill_(pos)
        self._true_len.fill_(true_len)
        self._key.copy_(key)
        self._temperature.fill_(float(temperature))
        self._top_k.fill_(self.cfg.vocab_size if top_k is None else top_k)
        self._top_p.fill_(1.0 if top_p is None else top_p)

    def _step(self):
        cache = {"k": self.k, "v": self.v, "pos": self._pos}
        with torch.no_grad():
            return llama.prefill_detached_chunk(
                self.cfg, self.params, self._tokens, cache, self._true_len,
                self._key, self._temperature, self._top_k, self._top_p,
                rope=self._rope)[:4]

    def _capture(self, padded, key) -> None:
        dev = self.device
        with torch.inference_mode(False):   # written from any thread
            self._tokens = torch.zeros((1, self.cw), dtype=padded.dtype,
                                       device=dev)
            self._pos = torch.zeros((), dtype=torch.int64, device=dev)
            self._true_len = torch.ones((), dtype=torch.int64, device=dev)
            self._key = torch.zeros_like(key)
            self._temperature = torch.zeros((1,), dtype=torch.float32,
                                            device=dev)
            self._top_k = torch.ones((1,), dtype=torch.int64, device=dev)
            self._top_p = torch.ones((1,), dtype=torch.float32, device=dev)
            self._rope = llama.rope_tables(self.cfg, self.k.shape[3],
                                           device=dev)

        def warm():
            with watcher.counted(dev):
                self._step()

        def fn():
            self._out = self._step()
        self._graph = capture_graph(self.name, fn, warm, dev)
        self.captures += 1


class PrefillWorker:
    """One prefill compute thread: pops (rid, Request) jobs, runs the
    bucketed ``prefill_detached`` program on ``device`` (the card by
    default; ``params`` must already be there), copies the block to the
    host (the sync IS this pool's job — decode never blocks on it) and
    ships it over the channel. ``current()`` + ``drain()`` expose the
    in-flight and queued jobs so the pool can respawn a dead worker and
    resubmit its work (DataLoader's dead-worker pattern). ``mesh``
    raises until the multi-device slice."""

    def __init__(self, cfg, params, channel: KVChannel, *,
                 min_bucket: int, max_len: int, mesh=None,
                 name: str = "p0",
                 on_fail: Optional[Callable[[int, str],
                                            None]] = None,
                 wire_page_size: Optional[int] = None,
                 stream_chunk: Optional[int] = None,
                 device: DeviceLike = None):
        llama._no_mesh(mesh)
        self.device = torch.empty(0, device=resolve_device(device)).device
        off = sorted({str(t.device) for t in _tensor_leaves(params)
                      if t.device != self.device})
        if off:
            raise ValueError(f"params on {off}, the prefill worker on "
                             f"{self.device}: move them first")
        self.cfg = cfg
        self.params = params
        self.channel = channel
        self.min_bucket = min_bucket
        self.max_len = max_len
        # page-granular handoff (paged decode pool): ship the block as
        # one acked frame per KV page, trimmed to the pages true_len
        # covers — bucket padding never crosses the wire
        self.wire_page_size = wire_page_size
        # streamed prefill pages: compute the prompt in fixed-width
        # chunks and ship each page's frame AS IT FILLS, so wire
        # transfer + feeder staging overlap prefill compute instead of
        # trailing it (TTFT). Rounded up to a power of two so every
        # chunk divides every bucket (one chunk program per bucket);
        # requires a power-of-two wire page so page frames
        # align with chunk boundaries — anything else falls back to
        # the one-shot path silently.
        sc = (stream_chunk if stream_chunk is not None else env_int(
            "MXTPU_DISAGG_STREAM_CHUNK", 0,
            "Chunk width (tokens) for streamed detached prefill: the "
            "prefill worker runs the prompt in chunks of this many "
            "tokens and ships each KV page's wire frame as its page "
            "fills, overlapping handoff transfer with compute "
            "(rounded up to a power of two >= the wire page size); "
            "0 keeps the one-shot prefill, where every page ships at "
            "completion."))
        self.stream_chunk = 0
        if sc and wire_page_size and not (int(wire_page_size)
                                          & (int(wire_page_size) - 1)):
            cw = 1
            while cw < max(int(sc), int(wire_page_size)):
                cw *= 2
            self.stream_chunk = cw
        self.mesh = mesh
        self.name = name
        self.on_fail = on_fail
        self.stopping = False
        self.failure: Optional[BaseException] = None
        self._fns: Dict[int, Any] = {}
        self._cfns: Dict[int, Any] = {}
        self._jobs: "queue.Queue[Any]" = queue.Queue()
        self._cur_lock = threading.Lock()
        self._current: Optional[Tuple[int, Request]] = None
        self._span = telemetry.span_factory("gateway.prefill",
                                            "gateway_prefill")
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"mxtpu-gw-prefill-{name}")
        self._thread.start()

    def submit(self, rid: int, req: Request) -> None:
        self._jobs.put((rid, req))

    def pending(self) -> int:
        return self._jobs.qsize()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def current(self) -> Optional[Tuple[int, Request]]:
        with self._cur_lock:
            return self._current

    def drain(self) -> List[Tuple[int, Request]]:
        """Pull every queued job off a (dead) worker for
        resubmission."""
        out: List[Tuple[int, Request]] = []
        while True:
            try:
                job = self._jobs.get_nowait()
            except queue.Empty:
                return out
            if job is not None:
                out.append(job)

    def stop(self, join: bool = True, timeout: float = 60.0) -> None:
        self.stopping = True
        self._jobs.put(None)
        if join:
            self._thread.join(timeout)

    @property
    def compile_count(self) -> int:
        return int(sum(f._cache_size() for f in self._fns.values())
                   + sum(f._cache_size()
                         for f in self._cfns.values()))

    def _fn(self, bucket: int):
        """The one-shot prefill program for one bucket: built (and its
        cost counted) at its first call, as the engine's prefill
        buckets are."""
        fn = self._fns.get(bucket)
        if fn is None:
            name = f"gateway_prefill_b{bucket}"
            fn = telemetry.watch(
                watcher.Program(partial(llama.prefill_detached, self.cfg),
                                name), name, expected=1)
            self._fns[bucket] = fn
        return fn

    def _chunk_fn(self, bucket: int):
        """The streamed-prefill chunk program for one bucket (chunk
        width is fixed per worker, so this is one program per bucket
        — the same growth rate as the one-shot prefill): a
        :class:`_ChunkProgram`, whose bucket-sized cache every request
        of the bucket reuses, chunk c+1 writing after chunk c."""
        fn = self._cfns.get(bucket)
        if fn is None:
            name = f"gateway_prefill_stream_b{bucket}"
            fn = telemetry.watch(
                _ChunkProgram(self.cfg, self.params, bucket,
                              min(self.stream_chunk, bucket), self.device,
                              name), name, expected=1)
            self._cfns[bucket] = fn
        return fn

    def _run(self) -> None:
        """Thread body: an exception escaping the job loop (a chaos
        kill, an unexpected device fault) is a worker DEATH — recorded
        so ``check_pools`` can tell a crash from a drain and respawn."""
        try:
            self._loop()
        except BaseException as e:   # noqa: BLE001 — reported to pool
            self.failure = e
            telemetry.flight().record(
                "gateway", "prefill_worker_died", worker=self.name,
                error=repr(e)[:200])

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            with self._cur_lock:
                self._current = job
            # cleared only on normal return: an exception escaping
            # _one kills the worker, and the job it died holding IS
            # what check_pools must hand to the replacement
            self._one(*job)
            with self._cur_lock:
                self._current = None

    def _one(self, rid: int, req: Request) -> None:
        # this hop gets its own trace segment; the handoff frame
        # carries it across the wire (versioned rpc context header),
        # so a decode host in ANOTHER process continues the trace
        ctx = getattr(req, "ctx", None)
        if ctx is not None:
            ctx = ctx.child()
        try:
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            bucket = bucket_for(prompt.size, self.min_bucket,
                                self.max_len)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :prompt.size] = prompt
            padded = torch.from_numpy(padded).to(self.device)
            # the request's key chain as the engine seats it: position
            # 0 is PRNGKey(seed), a resume key continues mid-chain
            key = (prng.PRNGKey(req.seed, device=self.device)  # noqa: MXL301 — chain position 0 is PRNGKey(seed); the rng branch is a mid-chain resume key
                   if req.rng is None else prng.key_from_numpy(
                       np.asarray(req.rng, np.uint32), self.device))
            if self.stream_chunk and self.wire_page_size:
                with dtrace.use(ctx), self._span(bucket=bucket,
                                                 worker=self.name), \
                        torch.no_grad():
                    self._one_streamed(rid, req, padded,
                                       int(prompt.size), bucket,
                                       key, ctx)
                return
            # the sampling knobs exactly as the engine's prefill takes
            # them, so both admissions run the same sampler
            with dtrace.use(ctx), self._span(bucket=bucket,
                                             worker=self.name), \
                    torch.no_grad():
                tok, kb, vb, rng = self._fn(bucket)(
                    self.params, padded, int(prompt.size), key,
                    float(req.temperature), req.top_k, req.top_p)
            # one host copy of each block, after the program is done
            h = KVHandoff(k=_host_array(kb), v=_host_array(vb),
                          true_len=int(prompt.size),
                          token=int(tok.reshape(-1)[0]),
                          rng=prng.key_to_numpy(rng))
            if self.wire_page_size:
                # the trace context rides the CLOSING frame — that is
                # the one the feeder seats from
                for frame in handoff_to_page_frames(
                        rid, h, int(self.wire_page_size)):
                    if ctx is not None and frame[0] == "kvdone":
                        frame = rpc.attach_context(frame,
                                                   ctx.to_wire())
                    self.channel.send_handoff(frame)
            else:
                frame = handoff_to_wire(rid, h)
                if ctx is not None:
                    frame = rpc.attach_context(frame, ctx.to_wire())
                self.channel.send_handoff(frame)
        except rpc.RPCAuthError:
            raise                   # misconfiguration: die loudly
        except (ConnectionError, OSError) as e:
            if self.stopping:
                raise               # pool shutdown: exit via _run
            # the channel gave up on THIS frame (reconnect budget
            # burned): fail the request, keep serving — the breaker
            # decides whether the pool as a whole is still viable
            telemetry.counter(
                "gateway_prefill_errors_total",
                "Prefill jobs that failed on a worker").inc()
            telemetry.flight().record("gateway", "handoff_failed",
                                      rid=rid, worker=self.name,
                                      error=repr(e)[:200])
            if self.on_fail is not None:
                self.on_fail(rid, "error")
        except Exception as e:
            # a failed prefill (device error, bad state) must not
            # kill the worker and strand every later request: the
            # error frame lets the feeder finalize THIS rid and
            # the loop keeps serving
            telemetry.counter(
                "gateway_prefill_errors_total",
                "Prefill jobs that failed on a worker").inc()
            telemetry.flight().record("gateway", "prefill_error",
                                      rid=rid, worker=self.name,
                                      error=repr(e)[:200])
            try:
                self.channel.send_handoff(("kverr", int(rid),
                                           repr(e)[:200]))
            except (ConnectionError, OSError):
                # the error report itself is undeliverable: finalize
                # locally so the request still ends exactly once —
                # letting this escape would kill the worker with the
                # POISONED job still marked in-flight, and check_pools
                # would re-run the very prefill that just failed
                if self.on_fail is not None:
                    self.on_fail(rid, "error")

    def _one_streamed(self, rid: int, req: Request, padded, true_len,
                      bucket: int, key, ctx) -> None:
        """Streamed prefill: run the prompt in ``stream_chunk``-wide
        slices of :func:`llama.prefill_detached_chunk` and ship each
        chunk's kvpage frames from a dedicated SHIPPER thread while
        the compute loop moves on to the next chunk. The thread is
        what makes the overlap real: host gather, wire serialize and
        NIC occupancy all release the GIL, and the compute loop never
        waits on the wire even where the backend's dispatch is
        synchronous (CPU). Bit-identical to the one-shot path: same
        causal math per position, same single rng split (the chunk
        program's contract), same wire frames in the same order —
        only their timing changes. The closing kvdone is sent after
        the shipper drains, and carries the final chunk's token/rng
        and the trace context, exactly like the one-shot sender."""
        ps = int(self.wire_page_size)
        cw = min(self.stream_chunk, bucket)
        # every page that carries prompt tokens, capped at the bucket
        # (same trim rule as handoff_to_page_frames)
        n_send = min(bucket, -(-true_len // ps) * ps)
        program = self._chunk_fn(bucket)
        cuda = self.device.type == "cuda"
        temp, tk, tp = float(req.temperature), req.top_k, req.top_p
        tok = rng_out = None
        # unbounded on purpose: worst case it holds the full block on
        # host, exactly what the one-shot gather does anyway — and an
        # unbounded put can never deadlock against a dead shipper
        todo: "queue.Queue" = queue.Queue()
        shipped = []
        fault: list = []

        # on the card the shipper copies on its own stream, after the
        # event that follows each chunk's clones: a copy waits for its
        # own chunk, never for the replays queued after it
        copies = torch.cuda.Stream(self.device) if cuda else None

        def _shipper():
            while True:
                item = todo.get()
                if item is None:
                    return
                try:
                    pos, kc, vc, done = item
                    if done is not None:
                        done.synchronize()
                        with torch.cuda.stream(copies):
                            kc, vc = _host_array(kc), _host_array(vc)
                    shipped.append(
                        self._ship_pages(rid, pos, kc, vc, n_send))
                except BaseException as e:      # noqa: BLE001 — must
                    fault.append(e)             # cross the thread seam
                    return

        shipper = threading.Thread(target=_shipper, daemon=True,
                                   name="mxtpu-kv-shipper")
        shipper.start()
        for pos in range(0, n_send, cw):
            t, kc, vc, r = program(padded, pos, true_len, key, temp, tk,
                                   tp)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            if pos <= true_len - 1 < pos + cw:
                tok, rng_out = t, r
            todo.put((pos, kc, vc, done))
        # the compute loop's end: what the span spends after it is the
        # shipper's tail (host copies and the wire; on the card the
        # loop only queues the replays, so the chunks' device time
        # falls in the tail too, where the shipper waits on each event)
        telemetry.instant("gateway.prefill_computed")
        todo.put(None)
        shipper.join()
        if fault:
            raise fault[0]
        n_frames = sum(shipped)
        telemetry.counter(
            "gateway_prefill_stream_jobs_total",
            "Prefill jobs served by the streamed (chunked) path").inc()
        done = ("kvdone", int(rid), int(true_len),
                int(tok.reshape(-1)[0]),
                prng.key_to_numpy(rng_out), n_frames)
        if ctx is not None:
            done = rpc.attach_context(done, ctx.to_wire())
        self.channel.send_handoff(done)

    def _ship_pages(self, rid: int, pos: int, kc, vc,
                    n_send: int) -> int:
        """Copy one computed chunk to the host and send a kvpage frame
        per page it fills (short final page when the bucket is smaller
        than a page, same as the one-shot encoder). Returns the frame
        count."""
        k, v = _host_array(kc), _host_array(vc)
        ps = int(self.wire_page_size)
        sent = 0
        for off in range(0, k.shape[2], ps):
            if pos + off >= n_send:
                break
            end = min(off + ps, n_send - pos)
            self.channel.send_handoff(
                ("kvpage", int(rid), (pos + off) // ps,
                 k[:, :, off:end], v[:, :, off:end]))
            sent += 1
        return sent


class DisaggBackend:
    """Prefill pool + decode replicas + the feeder joining them — the
    same routing surface ``ReplicaSet`` gives the Gateway (including
    the supervisor's ``replicas``/``remove_replica``/``spawn_replica``,
    which operate on the DECODE pool). The autoscaler's ``scale_to``
    also moves the decode pool; the prefill pool is sized at
    construction and kept at size by ``check_pools`` respawn. Every
    worker and engine runs on ``device`` (the card by default), where
    ``params`` must already be; ``mesh`` raises until the multi-device
    slice."""

    def __init__(self, cfg, params, *, n_prefill: int = 1,
                 n_decode: int = 1, max_slots: int = 4,
                 max_len: Optional[int] = None,
                 min_bucket: Optional[int] = None, mesh=None,
                 channel: Optional[Tuple[KVChannel, KVChannel]] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 clock=None, started: bool = True,
                 paged: bool = False,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 int8_pages: Optional[bool] = None,
                 kv_journal: Optional[int] = None,
                 stream_chunk: Optional[int] = None,
                 device: DeviceLike = None):
        llama._no_mesh(mesh)
        max_len = int(max_len or cfg.max_seq_len)
        min_bucket = int(min_bucket or 16)
        self._cfg = cfg
        self._params = params
        self._mesh = mesh
        self._device = device
        self._min_bucket = min_bucket
        self._mlen = max_len
        # paged decode pool: page-granular wire + journaled handoffs
        self.paged = bool(paged)
        self._wire_ps = (int(page_size
                             or env_int("MXTPU_KV_PAGE_SIZE", 16))
                         if self.paged else None)
        tx, rx = channel if channel is not None else KVChannel.pair()
        self._tx, self._rx = tx, rx
        self.decode = ReplicaSet(
            lambda: ServeEngine(cfg, params, max_slots=max_slots,
                                max_len=max_len, min_bucket=min_bucket,
                                mesh=mesh, clock=clock,
                                paged=paged, page_size=page_size,
                                n_pages=n_pages,
                                prefix_cache=prefix_cache,
                                int8_pages=int8_pages, device=device),
            n_decode, started=started)
        # feeder-thread-only reassembly buffers: rid -> _PageBuffer
        # (each kvpage frame is copied into the buffer on arrival, so
        # seating at kvdone does no assembly work)
        self._parts: Dict[int, _PageBuffer] = {}
        self._stream_chunk = stream_chunk
        # KV journal (paged re-dispatch seam): the last N seated
        # handoffs, keyed by their prompt tokens — a crash re-dispatch
        # whose prompt EXTENDS a journaled one re-seats the pages and
        # warm-prefills only the emitted suffix, instead of burning a
        # prefill-worker pass on the whole prompt.
        # COST: each entry pins a FULL host K/V block (layers x
        # kv_heads x bucket x head_dim, k + v) — hundreds of MB on
        # production-sized models — so the real bound is BYTES, not
        # entries: oldest entries fall off once the total crosses
        # MXTPU_GATEWAY_KV_JOURNAL_MB (kv_journal still caps the
        # entry count; 0 for either disables the journal).
        cap = (kv_journal if kv_journal is not None
               else (32 if self.paged else 0))
        self._journal_cap = max(0, int(cap))
        self._journal_max_bytes = max(0, env_int(
            "MXTPU_GATEWAY_KV_JOURNAL_MB", 256,
            "Total host-RAM byte budget (in MB) for the gateway's "
            "seated-handoff KV journal; a single block larger than "
            "the budget is not journaled at all.")) * (1 << 20)
        self._journal_bytes = 0
        self._journal: "Dict[Tuple[int, ...], KVHandoff]" = {}
        self._m_journal_hits = telemetry.counter(
            "gateway_kv_journal_hits_total",
            "Crash re-dispatches seated from the KV journal (paged "
            "inject + suffix warm prefill, no full re-prefill)")
        self._m_page_frames = telemetry.counter(
            "gateway_kv_page_frames_total",
            "kvpage frames received on the page-granular handoff wire")
        self._wseq = itertools.count()
        self.prefill: List[PrefillWorker] = [
            self._new_worker() for _ in range(max(1, n_prefill))]
        self.breaker = breaker if breaker is not None \
            else CircuitBreaker(clock=clock)
        self._m_wrestarts = telemetry.counter(
            "gateway_prefill_restarts_total",
            "Prefill workers respawned after dying")
        self._m_fallback = telemetry.counter(
            "gateway_breaker_fallback_total",
            "Requests served via colocated prefill while the disagg "
            "breaker was open")
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._seq = itertools.count()
        # rid -> (request, ticket, submit time on self._clock)
        self._pending: Dict[int, Tuple[Request, "_DisaggTicket",
                                       float]] = {}
        # rids whose job was already resubmitted once after a worker
        # death — a second death on the same rid fails the request
        # (the DataLoader discipline: respawn + resubmit ONCE)
        self._resubmitted: set = set()
        self._feeder = threading.Thread(target=self._feed, daemon=True,
                                        name="mxtpu-gw-kv-feeder")
        self._feeder.start()

    def _new_worker(self) -> PrefillWorker:
        return PrefillWorker(
            self._cfg, self._params, self._tx,
            min_bucket=self._min_bucket, max_len=self._mlen,
            mesh=self._mesh, name=f"p{next(self._wseq)}",
            on_fail=self._fail_pending,
            wire_page_size=self._wire_ps,
            stream_chunk=self._stream_chunk, device=self._device)

    def _fail_pending(self, rid: int, reason: str = "error") -> None:
        """Finalize a pending request whose prefill/handoff failed
        terminally (pops the pending table so load_total and the
        admission bound stop charging for it)."""
        self.breaker.record_failure()
        with self._lock:
            entry = self._pending.pop(rid, None)
            self._resubmitted.discard(rid)
        if entry is not None:
            self._count_cancel(reason)
            if entry[0].on_done is not None:
                entry[0].on_done(rid, reason)

    # -- KV journal (paged re-dispatch) --------------------------------------
    @staticmethod
    def _handoff_nbytes(h: KVHandoff) -> int:
        return _nbytes(h.k) + _nbytes(h.v)

    def _journal_put(self, prompt: np.ndarray,
                     handoff: KVHandoff) -> None:
        if self._journal_cap <= 0 or self._journal_max_bytes <= 0:
            return
        nb = self._handoff_nbytes(handoff)
        if nb > self._journal_max_bytes:
            return      # one block alone busts the budget: skip it
        key = tuple(int(t) for t in prompt)
        with self._lock:
            old = self._journal.pop(key, None)  # refresh insert order
            if old is not None:
                self._journal_bytes -= self._handoff_nbytes(old)
            self._journal[key] = handoff
            self._journal_bytes += nb
            while self._journal and (
                    len(self._journal) > self._journal_cap
                    or self._journal_bytes > self._journal_max_bytes):
                ev = self._journal.pop(next(iter(self._journal)))
                self._journal_bytes -= self._handoff_nbytes(ev)

    def _journal_lookup(self, prompt: np.ndarray
                        ) -> Optional[KVHandoff]:
        """Longest journaled prompt that is a STRICT prefix of
        ``prompt`` — the re-dispatch prompt is ``original + emitted``,
        so the original's handoff matches here."""
        pt = tuple(int(t) for t in prompt)
        with self._lock:
            best = None
            for key, h in self._journal.items():
                if (len(key) < len(pt) and pt[:len(key)] == key
                        and (best is None
                             or len(key) > best[0])):
                    best = (len(key), h)
            return best[1] if best is not None else None

    # -- Gateway surface -----------------------------------------------------
    def route(self, req: Request, handoff=None) -> "Ticket":
        if handoff is not None:
            return self.decode.route(req, handoff=handoff)
        if self.paged and req.rng is not None \
                and self._journal_cap > 0:
            # a resume chain (crash re-dispatch): if the journal holds
            # the original prompt's pages, seat them directly — the
            # engine injects the pages and warm-prefills only the
            # emitted suffix; bit-identical (same rng chain) but no
            # prefill-pool round trip
            rp = np.asarray(req.prompt, np.int32).reshape(-1)
            jh = self._journal_lookup(rp)
            if jh is not None and int(rp.size) + int(
                    req.max_new_tokens) <= self._mlen:
                self._m_journal_hits.inc()
                telemetry.flight().record(
                    "gateway", "kv_journal_hit",
                    prefix=int(jh.true_len), prompt=int(rp.size))
                return self.decode.route(req, handoff=jh)
        # validate NOW (the prefill thread can only log, not raise to
        # the caller) — same checks ServeEngine.submit applies
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}")
        if prompt.size + req.max_new_tokens > self._max_len():
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_len")
        if req.top_k is not None and req.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {req.top_k}")
        if req.top_p is not None and not 0.0 < req.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got "
                             f"{req.top_p}")
        if not self.breaker.allow():
            # OPEN breaker: colocated fallback — the decode engine
            # runs prefill_slot itself (same graph/sampler/rng chain,
            # so tokens stay bit-identical); latency degrades, the
            # request does not
            self._m_fallback.inc()
            return self.decode.route(req)
        ticket = _DisaggTicket(self)
        # pick + submit under the SAME lock check_pools swaps workers
        # under: an unsynchronized pick could land the job on a dead
        # worker's queue just after its replacement drained it
        with self._lock:
            worker = min((w for w in self.prefill if w.alive),
                         key=lambda w: w.pending(), default=None)
            if worker is not None:
                rid = next(self._seq)
                ticket.rid = rid
                self._pending[rid] = (req, ticket, self._clock())
                worker.submit(rid, req)
        if worker is None:
            # whole pool down between check_pools passes: fall back
            # rather than queue onto a corpse
            self.breaker.record_failure()
            self._m_fallback.inc()
            return self.decode.route(req)
        return ticket

    def load_total(self) -> Dict[str, int]:
        out = self.decode.load_total()
        with self._lock:
            out["queued"] += len(self._pending)
        return out

    def state(self) -> List[Dict[str, Any]]:
        with self._lock:
            n_pending = len(self._pending)
        return ([dict(name=w.name, role="prefill", alive=w.alive,
                      healthy=w.alive and not w.stopping,
                      failed=w.failure is not None,
                      error=(repr(w.failure)[:120] if w.failure
                             else None),
                      queued=w.pending(), active=0, slots=0)
                 for w in self.prefill]
                + [dict(r, role="decode")
                   for r in self.decode.state()]
                + [dict(name="handoff", role="channel", alive=True,
                        queued=n_pending, active=0, slots=0,
                        paged=self.paged,
                        kv_journal=len(self._journal),
                        kv_journal_bytes=int(self._journal_bytes),
                        breaker=self.breaker.describe())])

    # -- supervisor surface (decode pool) ------------------------------------
    def replicas(self) -> List[EngineReplica]:
        return self.decode.replicas()

    def remove_replica(self, replica: EngineReplica) -> bool:
        return self.decode.remove_replica(replica)

    def spawn_replica(self) -> Optional[EngineReplica]:
        return self.decode.spawn_replica()

    def breaker_state(self) -> Dict[str, Any]:
        return self.breaker.describe()

    def check_pools(self) -> int:
        """The prefill half of supervision (called from the gateway's
        maintenance loop): respawn dead workers and resubmit their
        jobs ONCE — the in-flight job plus everything queued behind
        it. A job whose SECOND worker also died is failed with reason
        ``error`` (it is probably what killed them). Returns the
        number of workers respawned."""
        respawned = 0
        for i in range(len(self.prefill)):
            # capture + swap under the routing lock so a concurrent
            # route() can never submit onto the corpse after we
            # drained it
            with self._lock:
                w = self.prefill[i]
                if w.alive or w.stopping:
                    continue
                jobs = ([w.current()]
                        if w.current() is not None else []) \
                    + w.drain()
                fresh = self._new_worker()
                self.prefill[i] = fresh
            respawned += 1
            self._m_wrestarts.inc()
            self.breaker.record_failure()
            telemetry.flight().record(
                "gateway", "prefill_respawn", worker=w.name,
                replacement=fresh.name, jobs=len(jobs),
                error=(repr(w.failure)[:120] if w.failure else None))
            for rid, req in jobs:
                with self._lock:
                    second = rid in self._resubmitted
                    if not second:
                        self._resubmitted.add(rid)
                if second:
                    self._fail_pending(rid, "error")
                else:
                    fresh.submit(rid, req)
        return respawned

    @property
    def size(self) -> int:
        return self.decode.size

    def scale_to(self, n: int) -> int:
        return self.decode.scale_to(n)

    def start(self) -> None:
        self.decode.start()

    def close(self) -> None:
        for w in self.prefill:
            w.stop(join=True)
        self._tx.close()
        self._rx.close()
        self._feeder.join(10.0)
        self.decode.close()

    # -- internals -----------------------------------------------------------
    def _max_len(self) -> int:
        return self._mlen

    @staticmethod
    def _count_cancel(reason: str) -> None:
        cancel_counter(reason).inc()

    def _feed(self) -> None:
        while True:
            try:
                msg = self._rx.recv_handoff()
            except (ConnectionError, OSError):
                return                      # channel closed: shutdown
            # frames carry the trace context in the versioned header;
            # frames without one split to (msg, None) and everything
            # below behaves exactly the same
            msg, wire_ctx = rpc.split_context(msg)
            if (isinstance(msg, tuple) and len(msg) == 3
                    and msg[0] == "kverr"):
                rid, err = int(msg[1]), msg[2]
                self._parts.pop(rid, None)   # orphaned page chunks
                self.breaker.record_failure()
                with self._lock:
                    entry = self._pending.pop(rid, None)
                    self._resubmitted.discard(rid)
                if entry is not None and entry[0].on_done is not None:
                    entry[0].on_done(rid, "error")
                if entry is not None:
                    self._count_cancel("error")
                continue
            if (isinstance(msg, tuple) and len(msg) == 5
                    and msg[0] == "kvpage"):
                # one page of an in-flight handoff: copied into the
                # rid's assembly buffer NOW (idempotent — a resent
                # chunk overwrites itself in place), so seating at
                # kvdone starts from a finished block
                try:
                    self._parts.setdefault(
                        int(msg[1]), _PageBuffer()).add(
                            int(msg[2]), msg[3], msg[4])
                except rpc.RPCProtocolError as e:
                    telemetry.flight().record(
                        "gateway", "kv_channel_error",
                        error=repr(e)[:200])
                    return
                self._m_page_frames.inc()
                continue
            try:
                if (isinstance(msg, tuple) and msg
                        and msg[0] == "kvdone"):
                    buf = self._parts.pop(int(msg[1]), None)
                    rid, handoff = (buf if buf is not None
                                    else _PageBuffer()).finish(msg)
                else:
                    rid, handoff = wire_to_handoff(msg)
            except rpc.RPCProtocolError as e:
                # a foreign frame means the stream is desynced — stop
                # feeding loudly rather than seat corrupt state
                telemetry.flight().record("gateway", "kv_channel_error",
                                          error=repr(e)[:200])
                return
            with self._lock:
                entry = self._pending.pop(rid, None)
                self._resubmitted.discard(rid)
                reason = (entry[1].cancelled_reason
                          if entry is not None else None)
            if entry is None:
                continue    # cancelled while prefilling, or a resent
                #             duplicate whose first copy already seated
            req, ticket, t_submit = entry
            if getattr(req, "ctx", None) is None and wire_ctx:
                # cross-process decode host: the request object was
                # rebuilt here, so the trace identity arrives on the
                # WIRE — adopt it and the engine's seat/done events
                # join the same trace
                try:
                    req.ctx = dtrace.TraceContext.from_wire(wire_ctx)
                except ValueError:
                    pass
            with dtrace.use(getattr(req, "ctx", None)):
                telemetry.instant("gateway.handoff_recv",
                                  true_len=int(handoff.true_len))
            self.breaker.record_success()
            if reason is None and req.deadline_s is not None:
                # the budget started at SUBMIT, not at seating: a
                # request that burned it queued behind prefill expires
                # here, and a survivor decodes on the REMAINDER
                elapsed = self._clock() - t_submit
                if elapsed >= req.deadline_s:
                    reason = "deadline"
                else:
                    req.deadline_s = req.deadline_s - elapsed
            if reason is not None:
                self._count_cancel(reason)
                if req.on_done is not None:
                    req.on_done(rid, reason)
                continue
            seated = self._seat_with_retry(req, handoff)
            if seated is None:
                self._count_cancel("error")
                if req.on_done is not None:
                    req.on_done(rid, "error")
                continue
            # the journal keeps the seated handoff's host bytes: a
            # decode-replica crash re-seats THESE pages instead of
            # re-running the whole prompt through the prefill pool
            self._journal_put(
                np.asarray(req.prompt, np.int32).reshape(-1), handoff)
            with self._lock:
                ticket.seated = seated
                reason = ticket.cancelled_reason
            if reason is not None:          # cancel raced the seating
                seated.cancel(reason)

    def _seat_with_retry(self, req: Request, handoff: KVHandoff,
                         budget_s: Optional[float] = None):
        """Seat a handoff in the decode pool, riding out a transient
        zero-healthy window (a decode replica down, its replacement
        still in spawn backoff). The feeder thread must NEVER die on
        this — a dead feeder acks nothing and wedges the whole
        prefill pool. Returns None when seating is truly impossible
        (budget burned, invalid state): the caller fails that one
        request and keeps feeding. The budget runs on the backend's
        injected clock (deterministic under a fake-clock test) and
        defaults to the same per-frame retry knob as the channel."""
        if budget_s is None:
            budget_s = self._tx._retry_deadline_s
        deadline = self._clock() + budget_s
        while True:
            try:
                return self.decode.route(req, handoff=handoff)
            except NoHealthyReplicas:
                if self._clock() >= deadline:
                    telemetry.flight().record(
                        "gateway", "seat_failed", reason="no_replica")
                    return None
                time.sleep(0.05)
            except (ValueError, RuntimeError) as e:
                telemetry.flight().record(
                    "gateway", "seat_failed", error=repr(e)[:120])
                return None


class _DisaggTicket:
    """Cancellation handle across the two phases: before the handoff
    lands the request only exists in ``_pending`` (cancel = drop +
    fire on_done); after seating it is a decode-engine rid."""

    def __init__(self, backend: DisaggBackend):
        self._backend = backend
        self.rid: Optional[int] = None
        self.seated: Optional[Ticket] = None
        self.cancelled_reason: Optional[str] = None

    def on_replica(self, replica: EngineReplica) -> bool:
        """Supervision filter: this request rides ``replica`` once its
        handoff has seated there (pre-seating it belongs to the
        prefill pool, whose failures are handled by check_pools)."""
        return self.seated is not None \
            and self.seated.on_replica(replica)

    def dead(self) -> bool:
        return self.seated is not None and self.seated.dead()

    def cancel(self, reason: str = "cancel") -> bool:
        with self._backend._lock:
            if self.seated is not None:
                seated = self.seated
            else:
                # pending (or mid-handoff): the feeder checks the
                # reason under this same lock before/after seating
                self.cancelled_reason = reason
                entry = self._backend._pending.pop(self.rid, None)
                seated = None
        if seated is not None:
            return seated.cancel(reason)
        if entry is None:
            return True          # feeder will honor cancelled_reason
        req = entry[0]
        self._backend._count_cancel(reason)
        if req.on_done is not None:
            req.on_done(self.rid, reason)
        return True
