"""Lockset sanitizer — the runtime half of mxlint's MXL203: the port of
``mxtpu/contrib/analysis/lockcheck.py``.

Static analysis (:mod:`.deep`) derives the repo's lock-order graph
from the AST; this module validates it with dynamic evidence.
``install()`` (or ``MXTPU_ANALYSIS_LOCKCHECK=1`` at ``import
mxtpu_torch``)
patches the ``threading.Lock``/``threading.RLock`` factories so every
lock constructed afterwards is an :class:`InstrumentedLock` that
records, per thread, the order real acquisitions nest in. A violation
is reported when

- the same two locks are observed nesting in BOTH orders (a live
  deadlock window — two threads on those paths can each hold one and
  wait on the other), or
- an observed order contradicts the static lock graph: the graph has
  ``B -> A`` (some code path holds B while acquiring A) and never
  ``A -> B``, yet ``A -> B`` happened at runtime — either the static
  model is missing an edge (fix the model) or the code broke the
  global order the rest of the repo follows (fix the code).

The chaos tests exercise it: the port's tests replay the gateway
replica-kill chaos test with the sanitizer on in a fresh process and
fail on any violation (zero expected — the serve stack's global order
is ``gateway -> replica-set -> engine``, journal lock leaf), and
``chip_smoke.py``'s ``contrib`` phase runs two engines on threads on
the card under it.

Names are inferred at construction by walking the stack to the
``__init__`` frame assigning the lock, so instrumented locks carry the
same ``Class.attr`` identity the static graph uses. Condition
aliasing is free at runtime: ``threading.Condition(self._lock)``
wraps the SAME instrumented object, so ``_cv`` waits/notifies record
against ``._lock``'s name.

Diagnostic-only: never enable in production serving (every
acquisition takes one extra dict hit under an internal mutex).
"""
from __future__ import annotations

import linecache
import os
import re
import sys
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

__all__ = ["InstrumentedLock", "install", "uninstall", "installed",
           "reset", "observed_pairs", "violations", "assert_clean"]

_ENV = "MXTPU_ANALYSIS_LOCKCHECK"

# originals captured at install; the internal mutex is built from the
# ORIGINAL factory so the sanitizer never instruments itself
_orig: Dict[str, Any] = {}
_state_lock: Optional[Any] = None
_tls = threading.local()

# (held_name, acquired_name) -> first-seen "file:line in thread"
_pairs: Dict[Tuple[str, str], str] = {}


def _caller_site(depth: int = 2) -> str:
    f = sys._getframe(depth)
    # skip frames inside this module and threading.py (Condition
    # plumbing) so the site names USER code
    this = os.path.abspath(__file__)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) != this and \
                not fn.endswith("threading.py"):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _infer_name() -> str:
    """``Class.attr`` for ``self._lock = threading.Lock()`` inside an
    ``__init__`` — the exact node id the static lock graph uses."""
    f = sys._getframe(2)
    first = f
    while f is not None:
        if f.f_code.co_name == "__init__" and "self" in f.f_locals:
            cls = type(f.f_locals["self"]).__name__
            line = linecache.getline(f.f_code.co_filename, f.f_lineno)
            m = re.search(r"self\.(\w+)\s*(?::[^=]+)?=", line)
            if m:
                return f"{cls}.{m.group(1)}"
            return f"{cls}.<lock@{f.f_lineno}>"
        f = f.f_back
    base = os.path.basename(first.f_code.co_filename)
    return f"{base}:{first.f_lineno}"


def _stack() -> List[str]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _note_acquired(name: str) -> None:
    s = _stack()
    if s and s[-1] != name:
        pair = (s[-1], name)
        with _state_lock:
            if pair not in _pairs:
                _pairs[pair] = (f"{_caller_site(3)} in "
                                f"{threading.current_thread().name}")
    s.append(name)


def _note_released(name: str) -> None:
    s = _stack()
    # locks release LIFO under ``with``, but tolerate hand-rolled
    # out-of-order release: drop the innermost matching entry
    for i in range(len(s) - 1, -1, -1):
        if s[i] == name:
            del s[i]
            return


class InstrumentedLock:
    """Drop-in wrapper over a real Lock/RLock that records per-thread
    acquisition order. Forwards the private ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` protocol (with held-stack
    bookkeeping) so ``threading.Condition(instrumented_lock)`` works —
    a Condition ``wait`` releases every recursion level and the stack
    must mirror that."""

    def __init__(self, inner: Any, name: str):
        self._inner = inner
        self.name = name

    # -- core lock protocol ----------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        _note_released(self.name)

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # stdlib modules (concurrent.futures.thread, threading's fork
        # handlers) re-init module-level locks in the child process;
        # the wrapper must forward or a post-install import of those
        # modules fails at attribute lookup
        self._inner._at_fork_reinit()

    # -- Condition plumbing ----------------------------------------------
    def _release_save(self):
        if hasattr(self._inner, "_release_save"):
            inner_state = self._inner._release_save()   # all levels
        else:
            self._inner.release()
            inner_state = None
        s = _stack()
        n = sum(1 for x in s if x == self.name)
        for i in range(len(s) - 1, -1, -1):
            if s[i] == self.name:
                del s[i]
        return (inner_state, n)

    def _acquire_restore(self, state) -> None:
        inner_state, n = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        # re-entering after a wait is a real ordering event when other
        # locks are held; record once, then restore the levels
        _note_acquired(self.name)
        _stack().extend([self.name] * (n - 1))

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self.name} of {self._inner!r}>"


# ---------------------------------------------------------------------------
# install / report
# ---------------------------------------------------------------------------
def installed() -> bool:
    return bool(_orig)


def install() -> None:
    """Patch the ``threading.Lock``/``RLock`` factories. Idempotent.
    Locks constructed BEFORE install are not instrumented — install
    early (the ``MXTPU_ANALYSIS_LOCKCHECK=1`` import hook runs before
    any mxtpu_torch class can construct one)."""
    global _state_lock
    if _orig:
        return
    _orig["Lock"] = threading.Lock
    _orig["RLock"] = threading.RLock
    _state_lock = _orig["Lock"]()

    def _mk_lock():
        return InstrumentedLock(_orig["Lock"](), _infer_name())

    def _mk_rlock():
        return InstrumentedLock(_orig["RLock"](), _infer_name())

    threading.Lock = _mk_lock
    threading.RLock = _mk_rlock


def uninstall() -> None:
    if not _orig:
        return
    threading.Lock = _orig.pop("Lock")
    threading.RLock = _orig.pop("RLock")


def reset() -> None:
    _pairs.clear()


def observed_pairs() -> Dict[Tuple[str, str], str]:
    """(held, acquired) -> first-seen site, across all threads."""
    if _state_lock is None:
        return dict(_pairs)
    with _state_lock:
        return dict(_pairs)


def _static_edges(repo_root: Optional[str] = None
                  ) -> Optional[Set[Tuple[str, str]]]:
    """The static lock graph's edge set over ``mxtpu_torch/`` — loaded
    by path (stdlib-only module) so this works under a patched
    ``threading`` without re-importing anything heavy."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(here)))
    pkg = os.path.join(root, "mxtpu_torch")
    if not os.path.isdir(pkg):
        return None
    deep = sys.modules.get("_mxlint_torch_deep")
    if deep is None:
        spec = importlib.util.spec_from_file_location(
            "_mxlint_torch_deep", os.path.join(here, "deep.py"))
        deep = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = deep
        spec.loader.exec_module(deep)
    return set(deep.lock_graph_for([pkg]).edges)


def violations(static: bool = True,
               repo_root: Optional[str] = None) -> List[str]:
    """Order contradictions in what ran so far. ``static=True`` also
    cross-checks observed orders against the mxlint lock graph."""
    pairs = observed_pairs()
    out: List[str] = []
    for (a, b), site in sorted(pairs.items()):
        rev = pairs.get((b, a))
        if rev is not None and (b, a) > (a, b):
            continue                     # report each cycle pair once
        if rev is not None:
            out.append(
                f"lock-order inversion observed at runtime: "
                f"{a} -> {b} at {site} BUT {b} -> {a} at {rev} — "
                f"two threads on these paths can deadlock (MXL203)")
    if static:
        edges = _static_edges(repo_root)
        if edges:
            for (a, b), site in sorted(pairs.items()):
                if (b, a) in edges and (a, b) not in edges and \
                        (b, a) not in pairs:
                    out.append(
                        f"observed order {a} -> {b} (at {site}) "
                        f"contradicts the static lock graph, which "
                        f"only has {b} -> {a} — either the static "
                        f"model is missing an edge or this path "
                        f"broke the repo's global lock order "
                        f"(MXL203)")
    return out


def assert_clean(static: bool = True) -> None:
    """Raise AssertionError listing every violation (the CI smoke
    stage's teardown check)."""
    v = violations(static=static)
    assert not v, "lockcheck: %d violation(s):\n%s" % (
        len(v), "\n".join(v))
