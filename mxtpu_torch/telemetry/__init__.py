"""mxtpu_torch.telemetry — runtime observability, the part of
``mxtpu.telemetry`` the serving engine uses (host code, copied: the
reference's package imports jax through ``mxtpu.base``).

One process-wide, thread-safe layer with three pieces:

- **metrics registry** (labelled ``Counter``/``Gauge``/``Histogram``
  with fixed-bucket percentiles) — ``telemetry.counter("name").inc()``,
  read back by ``registry().value``/``get``;
- **span tracing** — ``telemetry.span_factory("serve.prefill",
  "serve_prefill")(bucket=256)`` gives a span whose host duration feeds
  ``span_serve_prefill_ms``, beside the device trace of
  ``torch.profiler`` (host dispatch time here, device time there);
  ``instant`` events; a request's :class:`TraceContext` tags what is
  recorded while it is active (``distributed.use``);
- **flight recorder** — a bounded ring of recent events (:func:`flight`).

Enabled by default; ``MXTPU_TELEMETRY=0`` turns every recording call
into a no-op (handles created while disabled never record — the knob
is read when a handle is created, keeping the hot path branch-free).
The instrument classes themselves (``telemetry.Histogram()`` etc.)
always work when constructed directly — subsystems use them for
private resettable stats regardless of the global knob.

Instrumented: ``mxtpu_torch.serve.ServeEngine`` (queue, slots,
admission, latency, spans, KV occupancy). Not ported yet: the build
watcher and ``perfscope`` (ROADMAP Queue A item 8; the port's engine
builds its programs once by construction, see
``ServeEngine.compile_count``), and the exporters, trace files, crash
dumps and metrics federation (item 9).
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..base import env_bool
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       interval_percentile, LATENCY_MS_BUCKETS)
from .flight import FlightRecorder
from . import tracing as _tracing
from .tracing import Span, trace_events

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "FlightRecorder", "Span", "TraceContext",
    "counter", "gauge", "histogram", "span_factory", "instant",
    "registry", "flight", "trace_events", "interval_percentile",
    "distributed", "LATENCY_MS_BUCKETS",
]


class _GuardedFlight(FlightRecorder):
    """The process singleton: honors the MXTPU_TELEMETRY kill switch
    (checked at record time: flight callers hold the singleton
    long-term). A directly-constructed FlightRecorder is never gated."""

    def record(self, kind, name, **fields):
        if _enabled:
            super().record(kind, name, **fields)


_REGISTRY = MetricsRegistry()
_FLIGHT = _GuardedFlight()
_enabled = env_bool(
    "MXTPU_TELEMETRY", True,
    "Master switch for the runtime telemetry layer (metrics, spans, "
    "flight recorder). 0 disables all recording.")


def registry() -> MetricsRegistry:
    """The process-wide registry (always real — readers use it even
    when recording is disabled)."""
    return _REGISTRY


def flight() -> FlightRecorder:
    return _FLIGHT


# -- no-op handles (returned while disabled) -------------------------------
class _Noop:
    def inc(self, amount: float = 1.0) -> None: pass
    def dec(self, amount: float = 1.0) -> None: pass
    def set(self, value: float) -> None: pass
    def observe(self, value: float) -> None: pass
    value = 0.0
    count = 0


_NOOP = _Noop()


class _NoopRegistry:
    def counter(self, *a, **k): return _NOOP
    def gauge(self, *a, **k): return _NOOP
    def histogram(self, *a, **k): return _NOOP


_NOOP_REGISTRY = _NoopRegistry()


def _metrics():
    """Registry for WRITERS: the real one when enabled, no-ops when
    not (instrumentation sites call this once at handle creation)."""
    return _REGISTRY if _enabled else _NOOP_REGISTRY


def counter(name: str, help: str = "", **labels):
    return _metrics().counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels):
    return _metrics().gauge(name, help, **labels)


def histogram(name: str, help: str = "",
              buckets: Optional[Sequence[float]] = None, **labels):
    return _metrics().histogram(name, help, buckets=buckets, **labels)


def span_factory(name: str, histogram_name: Optional[str] = None):
    """Pre-bind a span's registry histogram
    (``span_<histogram_name or name>_ms``) once and return a callable
    producing spans — the hot-path form (per decode step: interning per
    call would take the registry lock every iteration). Every span lands
    in the flight recorder; while telemetry is disabled the spans still
    time but record nothing."""
    if not _enabled:
        return lambda **args: Span(name, record=False, **args)
    h = histogram(f"span_{histogram_name or name}_ms".replace(".", "_"),
                  f"Span durations: {name}")

    def make(**args):
        return Span(name, histogram=h, flight=_FLIGHT, **args)
    return make


def instant(name: str, **args) -> None:
    """An instant trace event (no-op while disabled)."""
    if _enabled:
        _tracing.instant(name, **args)


# the distributed layer registers the tracing context provider at import
from . import distributed                                  # noqa: E402
from .distributed import TraceContext                      # noqa: E402
