"""Process-wide metrics registry: labelled Counter / Gauge / Histogram
with a Prometheus text exposition and a human summary table. A copy of
``mxtpu/telemetry/registry.py`` (host code): the same calls give the
same exposition text, byte for byte.

Design (the always-on half of docs/observability.md):

- **Instruments are plain classes** — a :class:`Counter` constructed
  directly always works, with no global state, so a subsystem that
  needs private resettable stats (``ServeEngine.latency_stats``) can
  hold its own instance.
- **The registry is the process-wide namespace**: ``counter(name,
  **labels)`` interns one child per (name, label set) and every call
  site sharing the name shares the child — the property that makes a
  counter a cross-subsystem fact instead of a local variable.
- **Thread safety**: every mutation takes the instrument's own lock
  (serve callback thread, kvstore server threads, prefetcher thread
  and the training loop all write concurrently). Reads for export take
  the same locks, so a dump is a consistent snapshot per instrument.
- **Histograms are fixed-bucket**: O(len(buckets)) memory forever, no
  unbounded sample lists (what ``ServeEngine``'s private p50/p99 lists
  were before this module). Percentiles come from linear interpolation
  inside the crossing bucket — an estimate, bounded by bucket width,
  monotone in q by construction.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "interval_percentile", "interval_over_fraction",
           "escape_label_value",
           "LATENCY_MS_BUCKETS", "BYTES_BUCKETS", "SECONDS_BUCKETS"]

# log-spaced defaults: ~1.6x per step keeps the interpolation error of
# a percentile estimate under ~30% across 6 decades at 32 buckets
LATENCY_MS_BUCKETS = tuple(
    round(b, 4) for b in (
        0.05, 0.1, 0.2, 0.4, 0.8, 1.5, 2.5, 4, 6, 10, 16, 25, 40, 65,
        100, 160, 250, 400, 650, 1000, 1600, 2500, 4000, 6500, 10000,
        16000, 25000))
BYTES_BUCKETS = tuple(4 ** i for i in range(2, 16))        # 16B .. 1GB
SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 180.0)


def interval_percentile(bounds, prev_counts: Optional[List[int]],
                        counts: List[int],
                        q: float = 99.0) -> Optional[float]:
    """Percentile of the observations that landed BETWEEN two
    cumulative-bucket snapshots (the same interpolation as
    :meth:`Histogram.percentile`, applied to the diff) — THE
    bucket-diff math every windowed consumer shares (the autoscaler's
    latency signal, the gateway's SLO gauges). ``None`` when there is
    no previous snapshot or the window is empty."""
    if prev_counts is None:
        return None
    d = [c - p for c, p in zip(counts, prev_counts)]
    total = sum(d)
    if total <= 0:
        return None
    target = q / 100.0 * total
    cum = 0.0
    upper = bounds[-1]
    for i, c in enumerate(d):
        if c == 0:
            continue
        lower = bounds[i - 1] if i > 0 else 0.0
        upper = bounds[i] if i < len(bounds) else bounds[-1]
        if cum + c >= target:
            frac = (target - cum) / c
            return lower + frac * (upper - lower)
        cum += c
    return upper


def interval_over_fraction(bounds, prev_counts: Optional[List[int]],
                           counts: List[int],
                           threshold: float) -> Optional[float]:
    """Fraction of the window's observations above ``threshold``
    (linear interpolation inside the crossing bucket; the +Inf tail
    counts fully once its lower edge is reached) — the violation rate
    an SLO burn-rate gauge divides by its error budget. ``None`` when
    the window is empty."""
    if prev_counts is None:
        return None
    d = [c - p for c, p in zip(counts, prev_counts)]
    total = sum(d)
    if total <= 0:
        return None
    over = 0.0
    for i, c in enumerate(d):
        if c == 0:
            continue
        lower = bounds[i - 1] if i > 0 else 0.0
        upper = bounds[i] if i < len(bounds) else None   # +Inf
        if lower >= threshold:
            over += c
        elif upper is None:
            over += c          # tail straddles: no width to interpolate
        elif upper > threshold:
            over += c * (upper - threshold) / (upper - lower)
    return over / total


def escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline) — exposition-grammar safety for caller-supplied labels
    (error strings, peer addresses)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Set/inc/dec instantaneous value."""

    kind = "gauge"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Fixed-bucket histogram with percentile estimates.

    ``buckets`` are inclusive upper bounds; an implicit +Inf bucket
    catches the overflow tail (its percentile estimate clamps to the
    last finite bound — an honest floor, never an invented value).
    """

    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = LATENCY_MS_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b <= a for a, b in zip(bounds, bounds[1:])):
            raise ValueError("buckets must be non-empty and increasing")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)      # +Inf tail
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        lo, hi = 0, len(self.bounds)
        while lo < hi:                               # first bound >= value
            mid = (lo + hi) // 2
            if value <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._sum += value
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            n = sum(self._counts)
            return self._sum / n if n else 0.0

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(bucket counts incl. +Inf, sum, total) under one lock —
        the consistent view exporters read."""
        with self._lock:
            counts = list(self._counts)
            return counts, self._sum, sum(counts)

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]) by linear
        interpolation inside the bucket where the cumulative count
        crosses q; exact observed min/max clamp the ends."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        counts, _, total = self.snapshot()
        if total == 0:
            return 0.0
        target = q / 100.0 * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lower = self.bounds[i - 1] if i > 0 else \
                min(self._min or 0.0, self.bounds[0])
            upper = self.bounds[i] if i < len(self.bounds) else \
                max(self._max or self.bounds[-1], self.bounds[-1])
            if cum + c >= target:
                frac = (target - cum) / c
                return lower + frac * (upper - lower)
            cum += c
        return upper                                  # numeric slack

    def interval_percentile(self, prev_counts: Optional[List[int]],
                            counts: Optional[List[int]] = None,
                            q: float = 99.0) -> Optional[float]:
        """Windowed percentile between two cumulative snapshots of
        THIS histogram (``counts=None`` snapshots now — callers that
        keep the window state pass the counts they stored). Delegates
        to the module-level :func:`interval_percentile` so the
        bucket-diff math exists exactly once."""
        if counts is None:
            counts, _, _ = self.snapshot()
        return interval_percentile(self.bounds, prev_counts, counts, q)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._sum = 0.0
            self._min = self._max = None


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Family:
    """One metric name: its kind, help text, and per-label children."""

    def __init__(self, name: str, kind: str, help: str,
                 buckets: Optional[Sequence[float]]):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.children: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def child(self, labels: Dict[str, Any]):
        key = _label_key(labels)
        c = self.children.get(key)
        if c is None:
            c = {"counter": Counter, "gauge": Gauge}[self.kind]() \
                if self.kind != "histogram" else \
                Histogram(self.buckets or LATENCY_MS_BUCKETS)
            self.children[key] = c
        return c


class MetricsRegistry:
    """The process-wide metric namespace (one instance per process via
    ``mxtpu_torch.telemetry.registry()``; constructible directly in tests)."""

    def __init__(self, prefix: str = "mxtpu"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str,
                buckets: Optional[Sequence[float]] = None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}")
            if help and not fam.help:
                fam.help = help
            return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        fam = self._family(name, "counter", help)
        with self._lock:
            return fam.child(labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        fam = self._family(name, "gauge", help)
        with self._lock:
            return fam.child(labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        fam = self._family(name, "histogram", help, buckets)
        with self._lock:
            return fam.child(labels)

    # -- introspection ----------------------------------------------------
    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge child (0.0 if absent) —
        the read side tests and ``bench.py`` metadata use."""
        with self._lock:
            fam = self._families.get(name)
            child = fam.children.get(_label_key(labels)) if fam else None
        if child is None:
            return 0.0
        return child.value

    def get(self, name: str, **labels):
        """The child instrument itself, or None."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam.children.get(_label_key(labels))

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def reset(self) -> None:
        """Zero every child in place. Handles held by call sites stay
        valid — reset is test isolation, not teardown."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for child in list(fam.children.values()):
                child.reset()

    def snapshot_state(self) -> list:
        """A wire-safe structural dump — what a worker/replica process
        ships to the federating gateway over the framed RPC (values,
        not text: the merge stays exact instead of re-parsing floats).
        ``[(name, kind, help, [(labels, payload), ...]), ...]`` where
        ``labels`` is ``[(k, v), ...]`` and ``payload`` is a float
        (counter/gauge) or ``(bounds, counts, sum)`` (histogram)."""
        out = []
        for fam in self.families():
            with self._lock:
                children = list(fam.children.items())
            kids = []
            for key, child in sorted(children):
                labels = [(k, v) for k, v in key]
                if fam.kind == "histogram":
                    counts, total_sum, _ = child.snapshot()
                    kids.append((labels, (list(child.bounds),
                                          list(counts),
                                          float(total_sum))))
                else:
                    kids.append((labels, float(child.value)))
            out.append((fam.name, fam.kind, fam.help, kids))
        return out

    # -- exporters --------------------------------------------------------
    @staticmethod
    def _fmt_labels(key: Tuple[Tuple[str, str], ...],
                    extra: str = "") -> str:
        parts = [f'{k}="{escape_label_value(v)}"' for k, v in key]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    @staticmethod
    def _fmt_num(v: float) -> str:
        return repr(int(v)) if float(v).is_integer() else repr(float(v))

    def prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for fam in self.families():
            full = f"{self.prefix}_{fam.name}"
            if fam.help:
                lines.append(f"# HELP {full} "
                             f"{_escape_help(fam.help)}")
            lines.append(f"# TYPE {full} {fam.kind}")
            with self._lock:
                children = list(fam.children.items())
            for key, child in sorted(children):
                if fam.kind == "histogram":
                    counts, total_sum, total = child.snapshot()
                    cum = 0
                    for bound, c in zip(child.bounds, counts):
                        cum += c
                        lab = self._fmt_labels(key, f'le="{bound}"')
                        lines.append(f"{full}_bucket{lab} {cum}")
                    lab = self._fmt_labels(key, 'le="+Inf"')
                    lines.append(f"{full}_bucket{lab} {total}")
                    lab = self._fmt_labels(key)
                    lines.append(f"{full}_sum{lab} "
                                 f"{self._fmt_num(total_sum)}")
                    lines.append(f"{full}_count{lab} {total}")
                else:
                    lab = self._fmt_labels(key)
                    lines.append(
                        f"{full}{lab} {self._fmt_num(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def summary(self) -> str:
        """Human table: one row per child; histograms show
        count/mean/p50/p99."""
        rows: List[Tuple[str, str, str]] = []
        for fam in self.families():
            with self._lock:
                children = list(fam.children.items())
            for key, child in sorted(children):
                label = fam.name + self._fmt_labels(key)
                if fam.kind == "histogram":
                    n = child.count
                    stat = (f"n={n}  mean={child.mean:.3f}  "
                            f"p50={child.percentile(50):.3f}  "
                            f"p99={child.percentile(99):.3f}") if n \
                        else "n=0"
                else:
                    stat = self._fmt_num(child.value)
                rows.append((label, fam.kind, stat))
        if not rows:
            return "(no metrics recorded)"
        w = max(len(r[0]) for r in rows)
        out = [f"{'Metric':<{w}}  {'Type':<9}  Value",
               "-" * (w + 2 + 9 + 2 + 40)]
        for label, kind, stat in rows:
            out.append(f"{label:<{w}}  {kind:<9}  {stat}")
        return "\n".join(out)
