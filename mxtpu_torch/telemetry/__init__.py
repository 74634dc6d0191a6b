"""mxtpu_torch.telemetry — runtime observability: the port of
``mxtpu.telemetry`` (host code, copied: the reference's package imports
jax through ``mxtpu.base``).

One process-wide, thread-safe layer with five pieces:

- **metrics registry** (labelled ``Counter``/``Gauge``/``Histogram``
  with fixed-bucket percentiles) — ``telemetry.counter("name").inc()``,
  exported as a Prometheus text dump (:func:`prometheus`, byte for byte
  the reference's for the same calls) or a human table
  (:func:`summary`), and federated over the framed RPC
  (:class:`RegistryServer`, :func:`federate_text`);
- **span tracing** — ``with telemetry.span("prefill", bucket=256):``
  emits chrome://tracing-compatible events beside the device trace of
  ``torch.profiler`` (host dispatch time here, device time there),
  streamed to JSONL with ``MXTPU_TELEMETRY_TRACE_PATH``/``_DIR``;
- **flight recorder** — a bounded ring of recent events that crash
  paths dump to disk (:func:`flight`, ``flight().dump()``);
- **build watcher** — every program variant the port builds (bucket
  programs, CUDA graph captures, new train-step signatures) is counted
  process-wide (``program_build_total``), and :func:`watch`-wrapped
  programs attribute each build to its argument signature, so an
  anomalous ``recompile_total`` points at the offending signature;
- **perfscope** — per-program FLOPs and bytes counted on the call that
  builds each variant, live MFU/MBU and goodput, the HBM ledger and the
  step-anomaly detector (:mod:`.perfscope`).

Enabled by default; ``MXTPU_TELEMETRY=0`` turns every recording call
into a no-op (handles created while disabled never record — the knob
is read when a handle is created, keeping the hot path branch-free).
The instrument classes themselves (``telemetry.Histogram()`` etc.)
always work when constructed directly — subsystems use them for
private resettable stats regardless of the global knob.

Instrumented: ``mxtpu_torch.serve.ServeEngine`` (queue, slots,
admission, latency, spans, KV occupancy; the decode, verify and
page-copy programs watched; params and the KV bank in the ledger) and
the train step of ``mxtpu_torch.parallel.step`` (watched, its dispatch
span, params and optimizer state in the ledger).
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..base import env_bool
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       escape_label_value, interval_percentile,
                       BYTES_BUCKETS, LATENCY_MS_BUCKETS,
                       SECONDS_BUCKETS)
from .flight import (FlightRecorder, default_flight_path,
                     process_role, set_process_role)
from . import tracing as _tracing
from .tracing import (Span, clear_trace, current_depth, dump_trace,
                      trace_events)
from . import perfscope
from .perfscope import goodput_gauge, profile_program
from .watcher import WatchedFunction, describe_args, watch
from .watcher import install as install_compile_listener

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "FlightRecorder", "Span", "WatchedFunction", "TraceContext",
    "RegistryServer", "SLOTracker",
    "counter", "gauge", "histogram", "span", "span_factory", "instant",
    "registry", "flight", "enabled", "enable", "reset",
    "prometheus", "summary", "dump_trace", "trace_events",
    "clear_trace", "current_depth", "describe_args", "watch",
    "install_compile_listener", "default_flight_path",
    "process_role", "set_process_role", "escape_label_value",
    "interval_percentile", "federate_text", "parse_prometheus",
    "distributed", "perfscope", "profile_program", "goodput_gauge",
    "LATENCY_MS_BUCKETS", "BYTES_BUCKETS", "SECONDS_BUCKETS",
]

class _GuardedFlight(FlightRecorder):
    """The process singleton: honors the MXTPU_TELEMETRY kill switch
    dynamically (unlike metric handles, flight callers hold the
    singleton long-term, so the check belongs at record time). A
    directly-constructed FlightRecorder is never gated."""

    def record(self, kind, name, **fields):
        if _enabled:
            super().record(kind, name, **fields)


_REGISTRY = MetricsRegistry()
_FLIGHT = _GuardedFlight()
_enabled = env_bool(
    "MXTPU_TELEMETRY", True,
    "Master switch for the runtime telemetry layer (metrics, spans, "
    "flight recorder). 0 disables all recording.")


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    """Runtime override of MXTPU_TELEMETRY (tests; emergency off
    switch). Affects handles created AFTER the call."""
    global _enabled
    _enabled = bool(on)


def registry() -> MetricsRegistry:
    """The process-wide registry (always real — exporters read it even
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


def span(name: str, histogram_name: Optional[str] = None, **args):
    """A traced span. When telemetry is disabled this still returns a
    working ``Span`` timer but records nothing. ``histogram_name``
    additionally feeds the duration (ms) into that registry histogram;
    every span lands in the flight recorder."""
    return span_factory(name, histogram_name)(**args)


def span_factory(name: str, histogram_name: Optional[str] = None):
    """Pre-bind a span's registry histogram once and return a callable
    producing spans — the hot-path form (per decode step / train step,
    ``span()``'s per-call interning would take the registry lock every
    iteration)."""
    if not _enabled:
        return lambda **args: Span(name, record=False, **args)
    h = histogram(f"span_{histogram_name or name}_ms".replace(".", "_"),
                  f"Span durations: {name}") \
        if histogram_name is not False else None

    def make(**args):
        return Span(name, histogram=h, flight=_FLIGHT, **args)
    return make


def instant(name: str, **args) -> None:
    """An instant trace event (no-op while disabled)."""
    if _enabled:
        _tracing.instant(name, **args)


def prometheus() -> str:
    return _REGISTRY.prometheus()


def summary() -> str:
    return _REGISTRY.summary()


def reset() -> None:
    """Zero metrics, clear trace events and the flight ring (test
    isolation). Handles held by instrumentation stay valid."""
    _REGISTRY.reset()
    clear_trace()
    _FLIGHT.clear()
    # perfscope's rolling windows + ledger entries are test-visible
    # state too (the cost catalog survives — program costs don't rot)
    perfscope.reset()


# the distributed layer registers the tracing context provider at
# import; imported LAST — it reads this module's registry lazily
from . import distributed                                  # noqa: E402
from .distributed import (TraceContext, RegistryServer,    # noqa: E402
                          SLOTracker, federate_text,
                          parse_prometheus)
