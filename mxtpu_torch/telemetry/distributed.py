"""Request-scoped trace context: the part of
``mxtpu/telemetry/distributed.py`` the serving engine uses, copied.

:class:`TraceContext` is a Dapper-style request-scoped context
(``trace_id``, the current hop's ``span_id``, and baggage: the gateway
request id, seed, absolute deadline) minted at the front door and
carried on every hop. The context is activated per thread (:func:`use`);
every span or instant the tracing layer records while a context is
active carries its fields, so per-process trace files stitch into one
view of a request's life. The federation half (``RegistryServer``,
``federate_text``, ``SLOTracker``) comes with the serving tier (ROADMAP
Queue A item 9).
"""
from __future__ import annotations

import os
import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional

from . import tracing as _tracing

__all__ = ["TraceContext", "mint", "use"]

_HEX = re.compile(r"^[0-9a-f]{8,32}$")


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TraceContext:
    """One request's trace identity + baggage, carried on every hop.

    ``trace_id`` names the whole request across processes;
    ``span_id`` names the current hop segment (``parent_id`` the one
    before it, where a hop took its own); baggage is the small set of
    request facts every hop needs without a lookup: the gateway request
    id (``rid``), the sampling ``seed``, and the ABSOLUTE deadline
    (0 = none). Immutable. Deriving a hop's segment (``child``) and the
    wire form come with the serving tier (ROADMAP Queue A item 9)."""

    trace_id: str
    span_id: str
    rid: int = -1
    seed: int = 0
    deadline_abs: float = 0.0
    parent_id: str = ""

    def fields(self) -> Dict[str, Any]:
        """What every recorded event carries while this context is
        active (merged under the event's args by the tracing layer)."""
        out = {"trace_id": self.trace_id, "span": self.span_id,
               "rid": self.rid}
        if self.parent_id:
            out["parent_span"] = self.parent_id
        return out


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
