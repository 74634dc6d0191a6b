"""Framed-RPC wire layer — the ONE codec every socket protocol of the
port speaks: a copy of ``mxtpu/rpc.py`` (host code, numpy only), with
the same framing, HMAC, dtype codes and frame ceiling, so the two
packages' peers read each other's frames and ``encode`` gives the same
bytes in both. Its first consumer in the port is the metrics
federation (``telemetry.distributed``: ``RegistryServer``,
``scrape_peer``). A tensor is converted to numpy before it is sent.

Design, unchanged from the kvstore original:

- **Length-prefixed frames** carrying a SAFE tag-based binary encoding
  (struct headers + raw numpy bytes) — NOT pickle, so a foreign peer
  can never achieve code execution by connecting to a port that speaks
  this protocol. Opaque ``bytes`` payloads may ride inside a frame;
  whether to unpickle one is the CALLER's trust decision (the kvstore
  only does it for authenticated or loopback peers).
- **HMAC-SHA256 authentication** when a ``secret`` is supplied: the
  digest prefixes the body inside the length frame, verified on
  receive with a constant-time compare. Integrity + peer
  authentication only — no nonce, so an on-path attacker can replay
  captured frames; run an encrypted transport underneath on untrusted
  networks.
- **Frame-size ceiling**: a length header beyond
  ``MXTPU_RPC_MAX_FRAME`` (default 8 GB) is rejected as a foreign
  protocol before any allocation — the knob exists because the right
  bound is deployment-specific: a KV-handoff channel moving multi-GB
  cache blocks wants the ceiling high, a control plane on an exposed
  port wants it tight.

Errors: :class:`RPCAuthError` (secret mismatch — never retry) and
:class:`RPCProtocolError` (foreign/torn bytes — never retry), both
``ConnectionError`` subclasses so transport-level retry loops that
catch ``ConnectionError`` broadly must list them FIRST to fail fast.
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import socket
import struct
import time
from typing import Any, Callable, Optional, Tuple

import numpy as onp

from .base import env_int

__all__ = ["RPCAuthError", "RPCProtocolError", "encode", "decode",
           "send_msg", "recv_msg", "max_frame_bytes", "MAC_SIZE",
           "connect_with_backoff", "attach_context", "split_context",
           "CTX_TAG", "CTX_VERSION", "FramedServer", "call"]

_LEN = struct.Struct("<Q")
_I = struct.Struct("<q")
_F = struct.Struct("<d")
_U32 = struct.Struct("<I")

MAC_SIZE = hashlib.sha256().digest_size


class RPCAuthError(ConnectionError):
    """A frame failed HMAC verification — secret mismatch, not a
    transient network fault. Never retried: retrying an auth failure
    can only fail the same way until the deadline."""


class RPCProtocolError(ConnectionError):
    """The peer sent bytes that are not this protocol (foreign service
    on the port, torn frame). Never retried."""


def max_frame_bytes() -> int:
    """The inbound frame-size ceiling. Read per call so a test (or an
    operator mid-incident) can tighten it without rebuilding sockets."""
    return env_int(
        "MXTPU_RPC_MAX_FRAME", 1 << 33,
        "Maximum inbound framed-RPC message size in bytes (kvstore "
        "wire + gateway KV handoff); larger length headers are "
        "rejected as a foreign protocol before allocation.")


# ---- safe codec: tags + struct headers + raw buffers (no pickle) ----
_T_NONE, _T_TRUE, _T_FALSE, _T_INT, _T_FLOAT, _T_STR, _T_BYTES, \
    _T_TUPLE, _T_LIST, _T_ARR = range(10)


def _decode_dtype(s: str) -> onp.dtype:
    """Resolve a wire dtype string: struct codes ('<f4') directly,
    named extension dtypes ('bfloat16') after making sure ml_dtypes
    has registered them with numpy (a frame may arrive before the
    receiver ever imported ml_dtypes)."""
    try:
        return onp.dtype(s)
    except TypeError:
        try:
            import ml_dtypes  # noqa: F401  (registers named dtypes)
            return onp.dtype(s)
        except (ImportError, TypeError):
            raise RPCProtocolError(f"unknown wire dtype {s!r}")


def _enc(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(_T_NONE)
    elif obj is True:
        out.append(_T_TRUE)
    elif obj is False:
        out.append(_T_FALSE)
    elif isinstance(obj, (int, onp.integer)):
        out.append(_T_INT)
        out += _I.pack(int(obj))
    elif isinstance(obj, (float, onp.floating)):
        out.append(_T_FLOAT)
        out += _F.pack(float(obj))
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(_T_STR)
        out += _U32.pack(len(b)) + b
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_T_BYTES)
        out += _U32.pack(len(obj)) + obj
    elif isinstance(obj, tuple):
        out.append(_T_TUPLE)
        out += _U32.pack(len(obj))
        for x in obj:
            _enc(x, out)
    elif isinstance(obj, list):
        out.append(_T_LIST)
        out += _U32.pack(len(obj))
        for x in obj:
            _enc(x, out)
    elif isinstance(obj, onp.ndarray):
        a = onp.asarray(obj)    # tobytes() C-orders; NOT
        # ascontiguousarray, which promotes 0-d to 1-d
        if a.dtype.hasobject:
            raise TypeError("object arrays are not wire-safe")
        if a.dtype.kind == "V":
            # ml_dtypes extension dtypes (bfloat16, float8_*) map to
            # raw void in dtype.str — ship the NAME instead, which
            # onp.dtype() resolves back once ml_dtypes is registered
            # (bf16 KV blocks are the gateway handoff's default).
            # Structured/void arrays stay refused.
            if a.dtype.names is not None or a.dtype.name.startswith(
                    "void"):
                raise TypeError("structured arrays are not wire-safe")
            dt = a.dtype.name.encode()   # e.g. b'bfloat16'
        else:
            dt = a.dtype.str.encode()    # e.g. b'<f4'
        out.append(_T_ARR)
        out += _U32.pack(len(dt)) + dt
        out += _U32.pack(a.ndim)
        for d in a.shape:
            out += _I.pack(d)
        raw = a.tobytes()
        out += _LEN.pack(len(raw)) + raw
    else:
        raise TypeError(f"type {type(obj).__name__} is not wire-safe")


def _dec(buf: memoryview, pos: int):
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_INT:
        return _I.unpack_from(buf, pos)[0], pos + 8
    if tag == _T_FLOAT:
        return _F.unpack_from(buf, pos)[0], pos + 8
    if tag in (_T_STR, _T_BYTES):
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        raw = bytes(buf[pos:pos + n])
        return (raw.decode() if tag == _T_STR else raw), pos + n
    if tag in (_T_TUPLE, _T_LIST):
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            x, pos = _dec(buf, pos)
            items.append(x)
        return (tuple(items) if tag == _T_TUPLE else items), pos
    if tag == _T_ARR:
        (nd,) = _U32.unpack_from(buf, pos)
        pos += 4
        dt = _decode_dtype(bytes(buf[pos:pos + nd]).decode())
        if dt.hasobject:
            raise RPCProtocolError("object dtype on the wire")
        pos += nd
        (ndim,) = _U32.unpack_from(buf, pos)
        pos += 4
        shape = []
        for _ in range(ndim):
            shape.append(_I.unpack_from(buf, pos)[0])
            pos += 8
        (nraw,) = _LEN.unpack_from(buf, pos)
        pos += 8
        a = onp.frombuffer(bytes(buf[pos:pos + nraw]),
                           dtype=dt).reshape(shape)
        return a, pos + nraw
    raise RPCProtocolError(f"bad wire tag {tag} — foreign protocol")


def encode(obj: Any) -> bytearray:
    """Encode one message body (no length prefix, no MAC)."""
    out = bytearray()
    _enc(obj, out)
    return out


def decode(buf: bytes) -> Any:
    """Decode one full message body; trailing bytes are a protocol
    error (a truncated or concatenated frame must never half-parse)."""
    try:
        msg, pos = _dec(memoryview(buf), 0)
    except ConnectionError:
        raise
    except Exception as e:    # struct.error / TypeError / ValueError
        # from malformed bytes: reject as a protocol error, never let
        # a foreign frame crash the serving thread
        raise RPCProtocolError(f"malformed rpc frame ({e})") from e
    if pos != len(buf):
        raise RPCProtocolError("trailing bytes in rpc frame")
    return msg


# ---- trace-context header (distributed request tracing) ----
# A VERSIONED wrapper any framed message can ride inside:
#     (CTX_TAG, CTX_VERSION, ctx_tuple, payload)
# carrying the request's TraceContext wire tuple across process
# boundaries (the disagg KV handoff is the first consumer). The
# version discipline: old frames (no wrapper) decode unchanged
# through split_context; a frame from a NEWER sender (unknown
# version) keeps its payload usable and only drops the context —
# fields are only ever APPENDED to the ctx tuple, never moved.
CTX_TAG = "mxctx"
CTX_VERSION = 1


def attach_context(msg: Any, ctx: Tuple) -> tuple:
    """Wrap one message body with the trace-context header (``ctx``
    is a wire-safe tuple — ``TraceContext.to_wire()``)."""
    return (CTX_TAG, CTX_VERSION, tuple(ctx), msg)


def split_context(msg: Any) -> Tuple[Any, Optional[tuple]]:
    """``(payload, ctx_tuple_or_None)``. A message without the header
    — every frame of a sender that predates it — passes through
    untouched, so every receiver can split unconditionally."""
    if (isinstance(msg, tuple) and len(msg) == 4
            and msg[0] == CTX_TAG and isinstance(msg[1], int)):
        ctx = msg[2] if msg[1] == CTX_VERSION else None
        return msg[3], (tuple(ctx) if isinstance(ctx, (tuple, list))
                        else None)
    return msg, None


def connect_with_backoff(dial: Callable[[], socket.socket],
                         deadline: float, *,
                         backoff_base: float = 0.05,
                         backoff_max: float = 2.0,
                         verify: Optional[Callable[[socket.socket],
                                                   None]] = None,
                         sleep: Callable[[float], None] = time.sleep
                         ) -> socket.socket:
    """THE reconnect discipline every mxtpu socket client shares
    (grown in the reference kvstore's ``ServerClient``, lifted
    here so the serving gateway's KV channel recovers the same way):
    call ``dial()`` until it succeeds or ``deadline`` (a
    ``time.monotonic()`` instant) passes, sleeping an exponentially
    doubled backoff between attempts.

    ``verify``, when given, runs a hello/heartbeat roundtrip on the
    fresh socket — a hung, foreign, or wrong-secret peer must fail
    HERE, before the caller replays any real traffic into it. Failures
    split exactly like the PS client's:

    - :class:`RPCAuthError` / :class:`RPCProtocolError` (from ``dial``
      or ``verify``) propagate IMMEDIATELY — a secret mismatch or a
      foreign service can only fail the same way forever, so retrying
      it would turn a loud misconfiguration into a silent retry loop;
    - ``OSError``/``ConnectionError`` are transient (peer restarting,
      port not up yet) and are retried under the deadline.
    """
    delay = backoff_base
    while True:
        sock = None
        try:
            sock = dial()
            if verify is not None:
                verify(sock)
            return sock
        except (RPCAuthError, RPCProtocolError):
            if sock is not None:
                sock.close()
            raise               # not transient — never retried
        except OSError as e:
            if sock is not None:
                sock.close()
            now = time.monotonic()
            if now >= deadline:
                raise ConnectionError(
                    f"rpc peer unreachable before deadline: {e}") from e
            sleep(min(delay, max(0.01, deadline - now)))
            delay = min(delay * 2, backoff_max)


def send_msg(sock: socket.socket, obj: Any, secret: bytes = b"") -> int:
    """Frame + (optionally) authenticate + send one message. Returns
    the frame payload size in bytes (callers feed size histograms)."""
    out = encode(obj)
    mac = (_hmac.new(secret, bytes(out), hashlib.sha256).digest()
           if secret else b"")
    n = len(out) + len(mac)
    sock.sendall(_LEN.pack(n) + mac + out)
    return n


def call(sock: socket.socket, obj: Any, secret: bytes = b"") -> Any:
    """One request/reply roundtrip on an established framed channel —
    the client half of :class:`FramedServer`."""
    send_msg(sock, obj, secret)
    msg, _ = recv_msg(sock, secret)
    return msg


class FramedServer:
    """Minimal threaded request/reply server for the framed protocol:
    one daemon thread accepts, one daemon thread per connection runs
    ``handler(msg, authed, addr) -> reply`` per frame. Grown for the
    elastic-training rendezvous/heartbeat control plane (small
    messages, long-lived connections) — the kvstore server keeps its
    own loop because its handlers touch per-connection state this
    deliberately does not have.

    A handler exception becomes an ``("err", "<Type>: <msg>")`` reply
    instead of killing the connection; an auth/protocol failure closes
    only the offending connection. ``port=0`` binds an ephemeral port,
    read back from ``.port`` (the test/chaos-harness idiom)."""

    def __init__(self, handler: Callable[[Any, bool, Tuple], Any],
                 host: str = "127.0.0.1", port: int = 0,
                 secret: bytes = b""):
        import threading
        self._handler = handler
        self._secret = secret
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name=f"framed-accept:{self.port}")
        self._accept.start()

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def _accept_loop(self) -> None:
        import threading
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return                      # socket closed — shutdown
            threading.Thread(target=self._serve_conn, args=(conn, addr),
                             daemon=True,
                             name=f"framed-conn:{addr[1]}").start()

    def _serve_conn(self, conn: socket.socket, addr) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    msg, authed = recv_msg(conn, self._secret)
                except (ConnectionError, OSError):
                    return                  # peer gone / auth / foreign
                try:
                    reply = self._handler(msg, authed, addr)
                except Exception as e:      # handler bug ≠ dead server
                    reply = ("err", f"{type(e).__name__}: {e}")
                try:
                    send_msg(conn, reply, self._secret)
                except (ConnectionError, OSError):
                    return

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "FramedServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def recv_msg(sock: socket.socket, secret: bytes = b"",
             observe: Optional[Callable[[int], None]] = None
             ) -> Tuple[Any, bool]:
    """Receive one frame. Returns (message, authenticated). ``observe``,
    when set, is called with the frame's byte length (servers feed
    request-size histograms through it; decode errors still count — an
    oversized foreign frame is exactly what the histogram should
    show)."""
    hdr = b""
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            raise ConnectionError("rpc peer connection closed")
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    if observe is not None:
        observe(n)
    if n > max_frame_bytes():
        raise RPCProtocolError(
            f"implausible frame length {n} > MXTPU_RPC_MAX_FRAME "
            f"{max_frame_bytes()} — peer is not an mxtpu rpc endpoint")
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("rpc peer connection closed")
        buf += chunk
    authed = False
    if secret:
        if n < MAC_SIZE or not _hmac.compare_digest(
                _hmac.new(secret, bytes(buf[MAC_SIZE:]),
                          hashlib.sha256).digest(),
                bytes(buf[:MAC_SIZE])):
            raise RPCAuthError("rpc frame failed HMAC check")
        buf = buf[MAC_SIZE:]
        authed = True
    return decode(bytes(buf)), authed
