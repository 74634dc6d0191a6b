"""HTTP front door — stdlib ``http.server`` only, no framework: the
port of ``mxtpu/serve/gateway/frontdoor.py`` (no device code).

Endpoints:

- ``POST /v1/generate`` — body ``{"prompt": [ints],
  "max_new_tokens": n, "temperature": t, "top_k": k, "top_p": p,
  "seed": s, "deadline_s": d, "stream": true}``. Streamed responses
  are newline-delimited JSON (``{"token": t}`` per token, then one
  ``{"done": true, "reason": ..., "tokens": [...]}`` trailer — the
  trailer repeats the full list so a client that missed flushes can
  still verify). ``stream: false`` returns one JSON object.
  Overload → ``429`` with ``Retry-After``; bad request → ``400``.
- ``GET /metrics`` — the process-wide Prometheus dump
  (``telemetry.prometheus()``), gateway gauges included.
- ``GET /state`` — live replica/queue topology (tools/diagnose.py
  renders it).
- ``GET /healthz`` — liveness.

HTTP/1.0, one connection per request: the stream ends when the socket
closes, so clients need no chunked-decoding. A client that disconnects
mid-stream cancels its request (reason ``disconnect``) — the slot
frees at the next step boundary instead of decoding to a dead socket.
"""
from __future__ import annotations

import json
import queue as _queue
import socket
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from .gateway import Gateway, GatewayOverloaded, GatewayUnavailable

__all__ = ["serve_http", "GatewayClient"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"
    server_version = "mxtpu-gateway"

    def log_message(self, *args):      # no per-request stderr spam —
        pass                           # telemetry carries the counters

    @property
    def gw(self) -> Gateway:
        return self.server.gateway     # type: ignore[attr-defined]

    @staticmethod
    def _build_fields(handle) -> Dict[str, Any]:
        """Fleet provenance on every response: which model served it,
        and which BUILD — across a hot-swap, the version label is how
        a client (or the bench's bit-identity check) knows whether
        old or new weights produced these tokens. Absent for
        single-model deployments (responses unchanged)."""
        out: Dict[str, Any] = {}
        if getattr(handle, "model", None) is not None:
            out["model"] = handle.model
            out["version"] = handle.version
        return out

    def _json(self, code: int, obj: Dict[str, Any],
              headers: Dict[str, str] = ()) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in dict(headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            # liveness plus the degradation story: load balancers key
            # on "status" ("ok" / "degraded"), humans read the rest
            self._json(200, self.gw.health())
        elif self.path == "/metrics":
            # federated when peers are configured: the fleet view
            # with per-process labels, the plain local dump otherwise
            body = self.gw.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/state":
            self._json(200, self.gw.state())
        else:
            self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/v1/generate":
            self._json(404, {"error": f"no route {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, TypeError) as e:
            self._json(400, {"error": f"bad json: {e}"})
            return
        try:
            # an upstream proxy's trace id joins this request to a
            # larger trace; absent, the gateway mints one — either
            # way the response carries it back for correlation
            handle = self.gw.submit_dict(
                body, trace_id=self.headers.get("X-Mxtpu-Trace"))
        except GatewayOverloaded as e:
            self._json(429, {"error": str(e),
                             "retry_after_s": e.retry_after},
                       {"Retry-After": str(e.retry_after)})
            return
        except GatewayUnavailable as e:
            # zero healthy replicas: a DIFFERENT failure from
            # overload — 503 says "the backend is down, retry later",
            # with the same jittered Retry-After discipline
            self._json(503, {"error": str(e),
                             "retry_after_s": e.retry_after},
                       {"Retry-After": str(e.retry_after)})
            return
        except (ValueError, KeyError, TypeError) as e:
            self._json(400, {"error": str(e)})
            return
        if not body.get("stream", True):
            try:
                toks = handle.result()
            except TimeoutError:
                # a request that never finishes (no deadline set, a
                # stalled pool) must not leak its slot: cancel, 504
                handle.cancel("timeout")
                self._json(504, {"error": "request timed out at the "
                                          "gateway"})
                return
            self._json(200, {"tokens": [int(t) for t in toks],
                             "reason": handle.reason,
                             "trace_id": handle.trace_id,
                             **self._build_fields(handle)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        try:
            for tok in handle.stream():
                self.wfile.write(
                    json.dumps({"token": tok}).encode() + b"\n")
                self.wfile.flush()
            self.wfile.write(json.dumps(
                {"done": True, "reason": handle.reason,
                 "tokens": handle.tokens,
                 "trace_id": handle.trace_id,
                 **self._build_fields(handle)}).encode() + b"\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the slow-client story: a dead consumer must not hold a
            # decode slot — cancel and let the step boundary reclaim
            handle.cancel("disconnect")
        except _queue.Empty:
            # no token for the whole stream timeout: reclaim the slot
            # and end the stream with an honest trailer
            handle.cancel("timeout")
            try:
                self.wfile.write(json.dumps(
                    {"done": True, "reason": "timeout",
                     "tokens": handle.tokens}).encode() + b"\n")
                self.wfile.flush()
            except OSError:
                pass


def serve_http(gateway: Gateway, host: str,
               port: int) -> Tuple[ThreadingHTTPServer, int]:
    """Bind + serve on a daemon thread; returns (server, bound_port)."""
    import threading
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.daemon_threads = True
    srv.gateway = gateway            # type: ignore[attr-defined]
    threading.Thread(target=srv.serve_forever, kwargs={
        "poll_interval": 0.05}, daemon=True,
        name="mxtpu-gw-http").start()
    return srv, srv.server_address[1]


class GatewayClient:
    """Minimal test/bench client (stdlib sockets — the front door is
    HTTP/1.0, so responses end at close; no chunked decoding needed).

    ``generate`` returns a record with the tokens AND client-side
    timestamps per token — what the gateway bench turns into TTFT and
    inter-token percentiles."""

    def __init__(self, host: str, port: int, timeout: float = 300.0):
        self.addr = (host, port)
        self.timeout = timeout

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None) -> Tuple[int,
                                                        Dict[str, str],
                                                        Any]:
        sock = socket.create_connection(self.addr,
                                        timeout=self.timeout)
        try:
            head = (f"{method} {path} HTTP/1.0\r\n"
                    f"Host: {self.addr[0]}\r\n")
            if body is not None:
                head += (f"Content-Length: {len(body)}\r\n"
                         "Content-Type: application/json\r\n")
            sock.sendall(head.encode() + b"\r\n" + (body or b""))
            f = sock.makefile("rb")
            status = int(f.readline().split()[1])
            headers: Dict[str, str] = {}
            while True:
                line = f.readline().strip()
                if not line:
                    break
                k, _, v = line.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            return status, headers, f
        except Exception:
            sock.close()
            raise

    def get_json(self, path: str) -> Tuple[int, Any]:
        status, _, f = self._request("GET", path)
        with f:
            return status, json.loads(f.read() or b"{}")

    def get_text(self, path: str) -> Tuple[int, str]:
        status, _, f = self._request("GET", path)
        with f:
            return status, f.read().decode()

    def generate(self, prompt, max_new_tokens: int,
                 **kw) -> Dict[str, Any]:
        """One streamed request. Returns ``{"status", "tokens",
        "reason", "times"|"retry_after_s"|"error"}`` — times are
        client-receipt perf_counter stamps, one per token."""
        body = json.dumps(dict(prompt=[int(t) for t in prompt],
                               max_new_tokens=int(max_new_tokens),
                               stream=True, **kw)).encode()
        t0 = time.perf_counter()
        status, headers, f = self._request("POST", "/v1/generate",
                                           body)
        tokens: List[int] = []
        times: List[float] = []
        reason = None
        with f:
            if status != 200:
                err = json.loads(f.read() or b"{}")
                rec = {"status": status, "t0": t0, "tokens": tokens,
                       "times": times, "reason": None,
                       "error": err.get("error")}
                if "retry-after" in headers:
                    rec["retry_after_s"] = int(headers["retry-after"])
                return rec
            trace_id = None
            model = version = None
            for line in f:
                evt = json.loads(line)
                if evt.get("done"):
                    reason = evt.get("reason")
                    tokens = [int(t) for t in evt["tokens"]]
                    trace_id = evt.get("trace_id")
                    model = evt.get("model")
                    version = evt.get("version")
                    break
                times.append(time.perf_counter())
                tokens.append(int(evt["token"]))
        rec = {"status": status, "t0": t0, "tokens": tokens,
               "times": times[:len(tokens)], "reason": reason,
               "trace_id": trace_id}
        if model is not None:
            rec["model"] = model
            rec["version"] = version
        return rec
