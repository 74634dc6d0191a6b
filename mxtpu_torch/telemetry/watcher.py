"""Build watcher: turn the building of a program variant into a counted,
attributed runtime event — the port of ``mxtpu/telemetry/watcher.py``.

The reference watches XLA compiles. The port runs eagerly, so what it
builds is a program *variant*: a bucket's prefill or inject program at
its first admission, a CUDA graph capture of the decode, paged or
verify step, the page-copy program, and a new argument signature of the
train step (where the reference would retrace). Two hooks, as in the
reference:

1. **Process-wide build counting** (:func:`install`) — there is no jax
   listener to register: every build point of the port runs inside
   :func:`build`, which, once ``install()`` has run, increments
   ``program_build_total`` and observes ``program_build_seconds`` (the
   port's counterparts of ``jax_compile_total`` and
   ``jax_compile_seconds``) and leaves a flight record naming the
   program.
2. **Per-program watcher** (:func:`watch`) — wraps one program and
   checks its ``_cache_size()`` (the variants built so far) around each
   call. When it grows, the call's signature — shapes, dtypes and
   devices of every tensor leaf — is recorded as the key that caused
   the build, and the cost counted during that same call (the program
   runs its building call under :func:`counted`) enters perfscope's
   catalog. Growth beyond ``expected`` increments
   ``recompile_total{fn=...}`` with the offending key in the flight
   recorder. Every other call feeds perfscope's live MFU/MBU/goodput
   window (a building call ran under the count, so the gap after it
   would time the host's dispatch alone).

``watch`` deliberately refuses a callable without ``_cache_size`` — a
silent no-op watcher would make the no-rebuild contract vacuously true
exactly when a rebuild bug could hide. :class:`Program` gives an eager
function that interface: its variants are keyed by a function of its
arguments.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import threading
import time
from typing import Any, Callable, Iterator, List, Optional

import torch
from torch.utils._pytree import tree_leaves

from . import perfscope as _perfscope

__all__ = ["install", "watch", "WatchedFunction", "describe_args",
           "build", "counted", "Program"]

_install_lock = threading.Lock()
_installed = False
_MAX_KEY_CHARS = 512
_tls = threading.local()        # .watched: the watched call on this thread


def install() -> bool:
    """Turn on process-wide build counting (idempotent): from now on
    every :func:`build` observes ``program_build_total`` and
    ``program_build_seconds``. Returns True."""
    global _installed
    with _install_lock:
        _installed = True
    return True


def _observe_build(program: str, seconds: float) -> None:
    if not _installed:
        return
    try:
        # resolved per build (builds are rare): capturing the registry
        # at install time would freeze the no-op one if telemetry was
        # disabled then
        from . import _metrics, flight as _fl
        from .registry import SECONDS_BUCKETS
        m = _metrics()
        m.counter("program_build_total",
                  "Program variants built process-wide (bucket programs, "
                  "CUDA graph captures, new train-step signatures)").inc()
        m.histogram("program_build_seconds", "Program build durations",
                    buckets=SECONDS_BUCKETS).observe(seconds)
        _fl().record("compile", "program_build", program=program,
                     dur_s=round(seconds, 4))
    except Exception:           # counting must never break a build
        pass


@contextlib.contextmanager
def build(program: str) -> Iterator[None]:
    """The block builds a variant of ``program`` (its first run, or a
    graph capture): timed into ``program_build_*`` when it completes."""
    t0 = time.perf_counter()
    yield
    _observe_build(program, time.perf_counter() - t0)


@contextlib.contextmanager
def counted(device: Optional[torch.device] = None) -> Iterator[None]:
    """The block is the run that builds the variant of the watched call
    on this thread: it runs under a perfscope count (``device`` names
    the card whose peak memory to read), and the cost goes to that
    call's :class:`WatchedFunction`. Outside a watched call, or with
    perfscope off, it does nothing."""
    w = getattr(_tls, "watched", None)
    sc = _perfscope.scope()
    if w is None or not sc._on():
        yield
        return
    with _perfscope.counting(device) as c:
        yield
    w._cost = c.cost(w.name, sc.spec())


def _leaf_desc(leaf: Any) -> str:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        r = repr(leaf)
        return r if len(r) <= 32 else r[:29] + "..."
    desc = f"{str(dtype).replace('torch.', '')}{list(shape)}"
    device = getattr(leaf, "device", None)
    if isinstance(device, torch.device):
        desc += f"@{device}"
    return desc


def describe_args(args: tuple, kwargs: dict) -> str:
    """A stable human-readable key for a call: every leaf's shape and
    dtype (+ device for a tensor) in tree order. Two calls that need
    different variants describe differently."""
    leaves = tree_leaves((args, kwargs))
    key = "(" + ", ".join(_leaf_desc(l) for l in leaves) + ")"
    if len(key) > _MAX_KEY_CHARS:
        h = hashlib.sha1(key.encode()).hexdigest()[:12]
        key = key[:_MAX_KEY_CHARS] + f"...#{h}"
    return key


class Program:
    """An eager function as a watchable program: its variants are keyed
    by ``key(*args, **kwargs)`` (one variant when ``key`` is None), and
    the first call of a key builds that variant — it runs inside
    :func:`build` (``program_build_*``) and :func:`counted` (the watched
    call's cost). ``_cache_size()`` is the number of variants built."""

    def __init__(self, fn: Callable, name: str,
                 key: Optional[Callable[..., Any]] = None):
        self._fn = fn
        self.name = name
        self._key = key
        self._keys: set = set()

    def _cache_size(self) -> int:
        return len(self._keys)

    def __call__(self, *args, **kwargs):
        k = self._key(*args, **kwargs) if self._key is not None else None
        if k in self._keys:
            return self._fn(*args, **kwargs)
        device = _perfscope._device_of((args, kwargs))
        with build(self.name), counted(device):
            out = self._fn(*args, **kwargs)
        self._keys.add(k)
        return out


class WatchedFunction:
    """A program with build attribution. Transparent: attributes
    (``_cache_size``, ``captures``, ...) delegate to the wrapped
    program, so existing build gates keep working."""

    def __init__(self, fn: Callable, name: str,
                 expected: Optional[int] = 1,
                 loop: Optional[str] = None):
        if not hasattr(fn, "_cache_size"):
            raise TypeError(
                f"watch() needs a program with _cache_size (got "
                f"{type(fn).__name__}) — a watcher that cannot see the "
                "variants built cannot attribute rebuilds")
        self._fn = fn
        self.name = name
        self.expected = expected
        self.compiles: List[str] = []       # key per build
        self._cost = None                   # counted during this call
        if loop is not None:
            _perfscope.scope().set_loop(name, loop)

    def __call__(self, *args, **kwargs):
        fn = self._fn
        before = fn._cache_size()
        prev = getattr(_tls, "watched", None)
        _tls.watched = self
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
        finally:
            _tls.watched = prev
        t1 = time.perf_counter()
        after = fn._cache_size()
        if after > before:
            self._on_compile(args, kwargs, after)
            # the building call ran under a count, host-slow enough for
            # the device to catch up: its end is no pacing boundary, so
            # the program's window resumes at the next call
            _perfscope.scope().restart(self.name)
        else:
            # perfscope step accounting: inter-dispatch gaps drive the
            # live MFU/MBU/goodput gauges + the step-anomaly detector
            _perfscope.scope().on_call(self.name, t0, t1)
        return out

    def _on_compile(self, args, kwargs, cache_size: int) -> None:
        from . import _metrics, flight as _fl
        # the variant's cost, counted while the call that built it ran
        cost, self._cost = self._cost, None
        if cost is not None:
            _perfscope.scope().register_cost(cost)
        key = describe_args(args, kwargs)
        self.compiles.append(key)
        m = _metrics()
        m.counter("compile_events_total",
                  "Compilations per watched program", fn=self.name).inc()
        if self.expected is not None and cache_size > self.expected:
            m.counter(
                "recompile_total",
                "Watched-program compilations beyond the expected "
                "count — an anomaly (shape churn, spec mismatch)",
                fn=self.name).inc()
            _fl().record("recompile", self.name, key=key,
                         cache_size=cache_size, expected=self.expected)
            logging.getLogger(__name__).warning(
                "telemetry: unexpected rebuild of %s (%d variants > "
                "expected %d) for signature %s", self.name,
                cache_size, self.expected, key)
        else:
            _fl().record("compile", self.name, key=key,
                         cache_size=cache_size)

    def __getattr__(self, name: str):
        return getattr(self.__dict__["_fn"], name)


def watch(fn: Callable, name: str,
          expected: Optional[int] = 1,
          loop: Optional[str] = None) -> WatchedFunction:
    """Wrap a program with build attribution. ``expected`` is the
    variant budget this program should ever need — 1 for a fixed-shape
    program; None disables the anomaly counter (builds are still
    attributed). ``loop`` tags the program for perfscope's
    ``goodput_ratio{loop=...}`` gauge (``"train"`` / ``"serve"``)."""
    return WatchedFunction(fn, name, expected=expected, loop=loop)
