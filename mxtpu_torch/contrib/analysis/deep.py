"""mxlint deep pass — concurrency, determinism and runtime-contract
analysis over the serve/fleet/elastic stack: the port of
``mxtpu/contrib/analysis/deep.py``. Every rule ID is the reference's;
each rule also knows the port's form of its bug class: a captured CUDA
graph (``cuda_graphs.capture_graph``, its ``.replay()``) is a program
dispatch like a jitted one, and the key chain's primitives are
``mxtpu_torch.prng``'s as well as ``jax.random``'s.

Review hardening kept finding the same bug families by hand:
dispatch-outside-lock, blocking-under-lock ("compile stalls
submitters"), stale-lock-window, metric label-set drift. Every instance
is statically visible in the AST, so this module turns that manual
review into a repeatable gate, three rule families deep:

- ``MXL2xx`` concurrency, from a per-class lock model (attributes
  assigned ``threading.Lock/RLock/Condition``, ``with self._lock:``
  scopes, thread-target methods):

  - ``MXL201`` — Eraser-style lockset: a shared attribute WRITTEN with
    no lock held in one method while the same attribute has
    lock-guarded accesses in another. Write-side only (unlocked reads
    of a published int are a different, far noisier conversation), and
    ``__init__`` is happens-before by construction so it never flags.
  - ``MXL202`` — blocking call under lock: ``time.sleep``, socket
    send/recv/accept/connect, framed-RPC round trips, ``queue.Queue``
    get/put, thread joins, foreign ``Event.wait`` and jitted-program
    dispatch (or a CUDA graph's replay) inside a ``with``-lock body
    (the "compile stalls submitters" class). ``Condition.wait`` on the lock it wraps
    RELEASES that lock and is exempt; a lock whose every with-body
    blocks is a dedicated I/O-serialization lock (the KV channel's
    send/recv locks) and is exempt as a whole.
  - ``MXL203`` — lock-order cycle over the inter-method acquisition
    graph: method A holds L1 and (directly, via a self-call, or via an
    unambiguous collaborator method) acquires L2, elsewhere reversed.
    Conditions alias the lock they wrap (``Condition(self._lock)``),
    so ``_cv``/``_lock`` are one graph node.

- ``MXL3xx`` determinism: ``MXL301`` raw ``jax.random.PRNGKey/split``
  (or ``prng.PRNGKey/split``) on serve paths that must ride the ``serve.resume_key`` chain (the
  bit-identity oracle); ``MXL302`` raw ``time.time()/monotonic()``
  calls inside a class that HAS the injectable-clock idiom
  (``self._clock = clock or time.monotonic``) but bypasses it;
  ``MXL303`` unseeded ``np.random``/``mx.random`` module draws in
  tests and bench entrypoints.

- ``MXL4xx`` runtime contracts: ``MXL401`` one metric name used with
  differing label-key sets across call sites (the
  ``model``-label grandfathering class, enforced instead of
  hand-tested); ``MXL402`` every ``MXTPU_*`` env knob read in code
  must be registered in ``docs/env_var.md``.

The model's assumptions and limits are documented in docs/lint.md
(§"The lockset model"); the runtime half (:mod:`.lockcheck`)
cross-checks the static graph against real acquisition orders.

Suppression: the classic ``# mxlint: disable=MXL201`` comment works,
and so does ``# noqa: MXL201 — reason`` (IDs required; a bare
``# noqa`` does NOT suppress mxlint rules).

Stdlib-only, like :mod:`.rules`: :mod:`.lockcheck` loads this file by
path under a patched ``threading`` without importing torch.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

# rules.py is the base engine; when this file is exec'd by file path
# (tools/mxlint) the relative import has no package, so fall back to
# the copy the CLI already loaded (or load it ourselves).
try:
    from .rules import (Finding, _collect_aliases, _dotted_chain,
                        _suppressions, iter_python_files)
except ImportError:                                   # path-loaded
    import importlib.util
    import sys
    _rules = sys.modules.get("_mxlint_torch_rules")
    if _rules is None:
        _spec = importlib.util.spec_from_file_location(
            "_mxlint_torch_rules",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "rules.py"))
        _rules = importlib.util.module_from_spec(_spec)
        sys.modules[_spec.name] = _rules
        _spec.loader.exec_module(_rules)
    Finding = _rules.Finding
    _collect_aliases = _rules._collect_aliases
    _dotted_chain = _rules._dotted_chain
    _suppressions = _rules._suppressions
    iter_python_files = _rules.iter_python_files

__all__ = ["DEEP_RULES", "deep_lint_paths", "deep_lint_file",
           "deep_lint_source", "build_lock_graph", "LockGraph"]

DEEP_RULES: Dict[str, str] = {
    "MXL201": "lockset: shared attribute written without the lock "
              "that guards its other accesses (Eraser-style "
              "write-side check)",
    "MXL202": "blocking call (sleep/socket/rpc/queue/join/jit "
              "dispatch) inside a with-lock body — stalls every "
              "thread contending for the lock",
    "MXL203": "lock-order cycle in the inter-method acquisition "
              "graph (deadlock risk)",
    "MXL301": "determinism: raw jax.random.PRNGKey/split on a serve "
              "path — route through the serve.resume_key chain",
    "MXL302": "determinism: raw time.time()/monotonic() in a class "
              "with an injectable clock (self._clock) — call the "
              "injected clock",
    "MXL303": "determinism: unseeded np.random/mx.random draw in a "
              "test or bench entrypoint",
    "MXL401": "runtime-contract: metric name used with differing "
              "label sets across call sites",
    "MXL402": "runtime-contract: MXTPU_* env knob read in code but "
              "not registered in docs/env_var.md",
}

# ``# noqa: MXL201 — reason`` / ``# noqa: MXL201, MXL302``: IDs are
# REQUIRED — a bare ``# noqa`` never suppresses mxlint rules (flake8's
# blanket form would hide findings silently).
_NOQA_RE = re.compile(r"#\s*noqa:\s*((?:MXL\d+[,\s]*)+)")


def _deep_suppressions(source: str) -> Dict[int, Set[str]]:
    out = _suppressions(source)
    for i, line in enumerate(source.splitlines(), start=1):
        m = _NOQA_RE.search(line)
        if m:
            out.setdefault(i, set()).update(
                re.findall(r"MXL\d+", m.group(1)))
    return out


# ---------------------------------------------------------------------------
# the per-class lock model
# ---------------------------------------------------------------------------
_SYNC_CTORS = {"Lock": "lock", "RLock": "rlock",
               "Condition": "condition", "Semaphore": "semaphore",
               "BoundedSemaphore": "semaphore"}
_MUTATING_METHODS = {"append", "appendleft", "extend", "add", "insert",
                     "remove", "discard", "pop", "popleft", "clear",
                     "update", "setdefault", "reset", "sort",
                     "reverse", "fill"}
_SOCKET_BLOCKING = {"sendall", "sendto", "recv", "recv_into",
                    "recvfrom", "accept", "connect", "connect_ex",
                    "create_connection"}
_CLOCK_FNS = {"time", "monotonic"}       # perf_counter is exempt:
#                                          latency instrumentation
# what builds a program whose call is a device dispatch: jax's jit, the
# telemetry watcher, and the port's captured CUDA graphs
_PROGRAM_CTORS = ("jit", "watch", "pjit", "capture_graph")
_RNG_DRAWS = {"rand", "randn", "randint", "random", "uniform",
              "normal", "choice", "shuffle", "permutation", "sample",
              "standard_normal", "randrange", "random_sample"}


def _self_attr(expr: ast.AST) -> Optional[str]:
    """``self.X`` -> "X" (one level only)."""
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and \
            expr.value.id == "self":
        return expr.attr
    return None


def _is_threading_ctor(node: ast.AST) -> Optional[Tuple[str, ast.Call]]:
    """``threading.Lock()`` / ``threading.Condition(x)`` -> (kind,
    call node)."""
    if not isinstance(node, ast.Call):
        return None
    chain = _dotted_chain(node.func)
    if chain is None:
        return None
    if chain[-1] in _SYNC_CTORS and (
            len(chain) == 1 or chain[-2] == "threading"):
        return _SYNC_CTORS[chain[-1]], node
    return None


@dataclass
class _Access:
    attr: str
    line: int
    col: int
    write: bool
    held: Tuple[str, ...]          # canonical lock names held
    method: str


@dataclass
class _Acquire:
    lock: str                      # canonical attr name
    line: int
    col: int
    held: Tuple[str, ...]          # held BEFORE this acquisition
    method: str


@dataclass
class _CallOut:
    recv_is_self: bool
    method_name: str               # callee method name
    line: int
    col: int
    held: Tuple[str, ...]
    method: str                    # calling method


@dataclass
class _Blocking:
    desc: str
    line: int
    col: int
    held: Tuple[str, ...]
    method: str
    lock_region: str               # innermost held lock
    io: bool = False               # socket/RPC round trip (vs
    #                                sleep/jit/queue/join)


@dataclass
class _Region:
    """One ``with self._lock:`` body."""
    blocked: bool                  # contains any blocking call
    io: bool                       # contains a socket/RPC call
    attrs: Set[str] = field(default_factory=set)


@dataclass
class _ClassModel:
    name: str
    path: str
    line: int
    sync_attrs: Dict[str, str] = field(default_factory=dict)
    cond_alias: Dict[str, str] = field(default_factory=dict)
    queue_attrs: Set[str] = field(default_factory=set)
    event_attrs: Set[str] = field(default_factory=set)
    thread_attrs: Set[str] = field(default_factory=set)
    jit_attrs: Set[str] = field(default_factory=set)
    clock_attr: Optional[str] = None
    accesses: List[_Access] = field(default_factory=list)
    acquires: List[_Acquire] = field(default_factory=list)
    calls_out: List[_CallOut] = field(default_factory=list)
    blocking: List[_Blocking] = field(default_factory=list)
    with_regions: Dict[str, List[_Region]] = field(default_factory=dict)
    methods: Set[str] = field(default_factory=set)

    def canon(self, attr: str) -> str:
        """Condition attrs alias the lock they wrap."""
        return self.cond_alias.get(attr, attr)


class _MethodScanner:
    """One pass over a method body tracking the held-lock stack."""

    def __init__(self, model: _ClassModel, method: str,
                 aliases: Dict[str, str]):
        self.m = model
        self.method = method
        self.aliases = aliases
        self.held: List[str] = []
        self.local_locks: Dict[str, str] = {}    # var -> lock attr
        self.local_jit: Set[str] = set()         # vars holding a
        #                                          jitted program

    # -- helpers ------------------------------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and attr in self.m.sync_attrs:
            return self.m.canon(attr)
        if isinstance(expr, ast.Name) and expr.id in self.local_locks:
            return self.local_locks[expr.id]
        return None

    def _record_access(self, attr: str, node: ast.AST,
                       write: bool) -> None:
        self.m.accesses.append(_Access(
            attr, node.lineno, node.col_offset, write,
            tuple(self.held), self.method))

    def _blocking_desc(
            self, call: ast.Call) -> Optional[Tuple[str, bool]]:
        """(why this call blocks, is-socket/RPC-I/O), or None.
        Mirrors docs/lint.md."""
        chain = _dotted_chain(call.func)
        fn = call.func
        if chain is not None:
            # time.sleep
            if chain[-1] == "sleep" and len(chain) >= 2 and \
                    chain[-2] == "time":
                return "time.sleep(...)", False
            # framed-RPC round trip / reconnect helper
            if chain[-1] in ("call", "connect_with_backoff") and \
                    len(chain) >= 2 and chain[-2] == "rpc":
                return ".".join(chain) + "(...)", True
        if isinstance(fn, ast.Attribute):
            last = fn.attr
            recv_attr = _self_attr(fn.value)
            if last in _SOCKET_BLOCKING:
                return f".{last}()", True
            if last in ("get", "put") and recv_attr in \
                    self.m.queue_attrs:
                return f"queue .{last}()", False
            if last == "join" and recv_attr in self.m.thread_attrs:
                return "Thread.join()", False
            if last == "wait":
                if recv_attr is not None and \
                        recv_attr in self.m.sync_attrs and \
                        self.m.sync_attrs[recv_attr] == "condition" \
                        and self.m.canon(recv_attr) in self.held:
                    return None          # releases the lock it wraps
                if recv_attr in self.m.event_attrs:
                    return "Event.wait()", False
        # jitted dispatch: self._decode(...), fn(...) where fn came
        # off a jit-program attr, self._prefills[b](...)
        if isinstance(fn, ast.Attribute):
            a = _self_attr(fn)
            if a in self.m.jit_attrs:
                return f"jitted dispatch self.{a}(...)", False
        if isinstance(fn, ast.Subscript):
            a = _self_attr(fn.value)
            if a in self.m.jit_attrs:
                return f"jitted dispatch self.{a}[...](...)", False
        if isinstance(fn, ast.Name) and fn.id in self.local_jit:
            return f"jitted dispatch {fn.id}(...)", False
        # a captured CUDA graph: self._graph.replay()
        if isinstance(fn, ast.Attribute) and fn.attr == "replay":
            a = _self_attr(fn.value)
            if a in self.m.jit_attrs:
                return f"CUDA graph replay self.{a}.replay()", False
        return None

    def _scan_call(self, node: ast.Call) -> None:
        desc = self._blocking_desc(node)
        if self.held:
            region = self.held[-1]
            self.m.with_regions.setdefault(region, [])
            if desc is not None:
                self.m.blocking.append(_Blocking(
                    desc[0], node.lineno, node.col_offset,
                    tuple(self.held), self.method, region,
                    io=desc[1]))
        # call-out edges for the lock graph
        fn = node.func
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            if isinstance(recv, ast.Name) and recv.id == "self":
                self.m.calls_out.append(_CallOut(
                    True, fn.attr, node.lineno, node.col_offset,
                    tuple(self.held), self.method))
            elif not isinstance(recv, ast.Attribute) or \
                    _self_attr(recv) is not None or True:
                self.m.calls_out.append(_CallOut(
                    False, fn.attr, node.lineno, node.col_offset,
                    tuple(self.held), self.method))

    # -- statement walk -----------------------------------------------------
    def _scan_expr(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._scan_call(sub)
            attr = None
            if isinstance(sub, ast.Attribute):
                attr = _self_attr(sub)
            if attr is not None and isinstance(sub.ctx, ast.Load):
                # mutating method call on self.attr counts as a write
                self._record_access(attr, sub, False)

    def _target_writes(self, target: ast.AST) -> None:
        if isinstance(target, ast.Attribute):
            attr = _self_attr(target)
            if attr is not None:
                self._record_access(attr, target, True)
            else:
                self._scan_expr(target.value)
        elif isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
            if attr is not None:
                self._record_access(attr, target, True)
            else:
                self._scan_expr(target)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._target_writes(e)
        elif isinstance(target, ast.Starred):
            self._target_writes(target.value)

    def _note_mutating_calls(self, node: ast.AST) -> None:
        """``self.X.append(...)`` and friends are writes to X."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _MUTATING_METHODS:
                attr = _self_attr(sub.func.value)
                if attr is not None:
                    self._record_access(attr, sub, True)

    def _note_local_binds(self, stmt: ast.Assign) -> None:
        """Track locals bound to locks or jitted programs."""
        v = stmt.value
        lock = self._lock_of(v)
        names = [t.id for t in stmt.targets
                 if isinstance(t, ast.Name)]
        if lock is not None:
            for n in names:
                self.local_locks[n] = lock
            return
        is_jit = False
        if isinstance(v, ast.Call) and \
                isinstance(v.func, ast.Attribute) and \
                v.func.attr == "get":
            if _self_attr(v.func.value) in self.m.jit_attrs:
                is_jit = True
        if isinstance(v, ast.Subscript) and \
                _self_attr(v.value) in self.m.jit_attrs:
            is_jit = True
        if is_jit:
            self.local_jit.update(names)

    def run(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, ast.With):
                pushed = 0
                for item in stmt.items:
                    lock = self._lock_of(item.context_expr)
                    self._scan_expr(item.context_expr)
                    if lock is not None:
                        self.m.acquires.append(_Acquire(
                            lock, stmt.lineno, stmt.col_offset,
                            tuple(self.held), self.method))
                        self.held.append(lock)
                        pushed += 1
                n_block = len(self.m.blocking)
                n_acc = len(self.m.accesses)
                self.run(stmt.body)
                if pushed:
                    region = self.held[-1]
                    mine = [b for b in self.m.blocking[n_block:]
                            if b.lock_region == region]
                    self.m.with_regions.setdefault(
                        region, []).append(_Region(
                            bool(mine), any(b.io for b in mine),
                            {a.attr
                             for a in self.m.accesses[n_acc:]}))
                for _ in range(pushed):
                    self.held.pop()
            elif isinstance(stmt, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                # a nested def runs LATER (thread body, callback):
                # scan it with an empty held stack
                inner = _MethodScanner(
                    self.m, f"{self.method}.<locals>.{stmt.name}",
                    self.aliases)
                inner.run(stmt.body)
            elif isinstance(stmt, ast.ClassDef):
                continue
            elif isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                   ast.AugAssign)):
                targets = (stmt.targets
                           if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                if stmt.value is not None:
                    self._scan_expr(stmt.value)
                    self._note_mutating_calls(stmt.value)
                for t in targets:
                    self._target_writes(t)
                if isinstance(stmt, ast.Assign):
                    self._note_local_binds(stmt)
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan_expr(stmt.test)
                self._note_mutating_calls(stmt.test)
                self.run(stmt.body)
                self.run(stmt.orelse)
            elif isinstance(stmt, ast.For):
                self._scan_expr(stmt.iter)
                self._target_writes(stmt.target)
                self.run(stmt.body)
                self.run(stmt.orelse)
            elif isinstance(stmt, ast.Try):
                self.run(stmt.body)
                for h in stmt.handlers:
                    self.run(h.body)
                self.run(stmt.orelse)
                self.run(stmt.finalbody)
            elif isinstance(stmt, (ast.Expr, ast.Return, ast.Raise,
                                   ast.Assert, ast.Delete)):
                for v in ast.iter_child_nodes(stmt):
                    self._scan_expr(v)
                    self._note_mutating_calls(v)
                if isinstance(stmt, ast.Delete):
                    for t in stmt.targets:
                        self._target_writes(t)
            else:
                for v in ast.iter_child_nodes(stmt):
                    if isinstance(v, ast.expr):
                        self._scan_expr(v)


def _clock_idiom(value: ast.AST) -> bool:
    """``clock or time.monotonic`` / ``... if ... else time.time`` —
    the injectable-clock construction."""
    cands = []
    if isinstance(value, ast.BoolOp) and isinstance(value.op, ast.Or):
        cands = value.values
    elif isinstance(value, ast.IfExp):
        cands = [value.body, value.orelse]
    for c in cands:
        chain = _dotted_chain(c)
        if chain is not None and len(chain) == 2 and \
                chain[0] == "time" and chain[1] in _CLOCK_FNS:
            return True
    return False


def _scan_class(cls: ast.ClassDef, path: str,
                aliases: Dict[str, str]) -> _ClassModel:
    model = _ClassModel(cls.name, path, cls.lineno)
    # pass 1: attribute typing from every method (sync attrs are
    # normally in __init__ but replacement locks happen elsewhere)
    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        model.methods.add(fn.name)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                kind = _is_threading_ctor(node.value)
                if kind is not None:
                    model.sync_attrs[attr] = kind[0]
                    if kind[0] == "condition" and kind[1].args:
                        wrapped = _self_attr(kind[1].args[0])
                        if wrapped is not None:
                            model.cond_alias[attr] = wrapped
                    continue
                chain = _dotted_chain(node.value.func) \
                    if isinstance(node.value, ast.Call) else None
                if chain is not None:
                    if chain[-1] == "Queue":
                        model.queue_attrs.add(attr)
                    elif chain[-1] == "Event" and (
                            len(chain) == 1 or
                            chain[-2] == "threading"):
                        model.event_attrs.add(attr)
                    elif chain[-1] == "Thread":
                        model.thread_attrs.add(attr)
                    elif chain[-1] in _PROGRAM_CTORS:
                        model.jit_attrs.add(attr)
                if fn.name == "__init__" and _clock_idiom(node.value):
                    model.clock_attr = attr
        # dict caches of jitted programs:
        # ``self._prefills[bucket] = telemetry.watch(jax.jit(...))``
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                        chain = (_dotted_chain(node.value.func)
                                 if isinstance(node.value, ast.Call)
                                 else None)
                        if attr is not None and chain is not None \
                                and chain[-1] in _PROGRAM_CTORS:
                            model.jit_attrs.add(attr)
    # pass 2: method scan with the held-lock stack
    for fn in cls.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _MethodScanner(model, fn.name, aliases).run(fn.body)
    return model


# ---------------------------------------------------------------------------
# MXL201 — lockset (write side)
# ---------------------------------------------------------------------------
def _locked_helper_methods(model: _ClassModel) -> Set[str]:
    """Private methods whose every intra-class call site either holds
    a lock (directly or from another guarded helper) or sits in
    ``__init__`` (construction is single-threaded: happens-before
    thread start). Their bodies execute guarded, so their
    unlocked-looking accesses are too. ``_maybe_seal`` ("call with
    self._cond held") and ``_load_snapshot`` (called from ``__init__``
    before the accept loop spawns) are the two shapes."""
    sites: Dict[str, List[_CallOut]] = {}
    for c in model.calls_out:
        if c.recv_is_self and c.method_name in model.methods:
            sites.setdefault(c.method_name, []).append(c)

    def base(method: str) -> str:
        return method.split(".<locals>.")[0]

    locked: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, calls in sites.items():
            if name in locked or not name.startswith("_") or \
                    name.startswith("__"):
                continue
            if all(c.held or base(c.method) == "__init__" or
                   base(c.method) in locked for c in calls):
                locked.add(name)
                changed = True
    return locked


def _rule_lockset(model: _ClassModel) -> List[Finding]:
    if not model.sync_attrs:
        return []
    locked_helpers = _locked_helper_methods(model)

    def effective_held(a: _Access) -> bool:
        if a.held:
            return True
        base = a.method.split(".<locals>.")[0]
        return a.method in locked_helpers or base in locked_helpers

    by_attr: Dict[str, List[_Access]] = {}
    for a in model.accesses:
        if a.attr in model.sync_attrs or a.attr in model.queue_attrs \
                or a.attr in model.event_attrs \
                or a.attr in model.thread_attrs:
            continue                    # sync objects are self-safe
        by_attr.setdefault(a.attr, []).append(a)
    findings: List[Finding] = []
    for attr, accesses in sorted(by_attr.items()):
        guarded = [a for a in accesses if effective_held(a)]
        if not guarded:
            continue                    # never lock-protected: not ours
        guarded_methods = {a.method for a in guarded}
        seen_lines: Set[int] = set()
        for a in accesses:
            if not a.write or effective_held(a):
                continue
            if a.method == "__init__" or \
                    a.method.startswith("__init__.<locals>"):
                continue                # happens-before construction
            others = guarded_methods - {a.method}
            if not others or a.line in seen_lines:
                continue
            seen_lines.add(a.line)
            where = sorted(others)[0]
            findings.append(Finding(
                "MXL201", model.path, a.line, a.col,
                f"{model.name}.{attr} written in {a.method}() with no "
                f"lock held, but guarded by "
                f"{'/'.join(sorted(set(model.sync_attrs)))} in "
                f"{where}() — take the owning lock (or document with "
                f"# noqa: MXL201 — reason)"))
    return findings


# ---------------------------------------------------------------------------
# MXL202 — blocking call under lock
# ---------------------------------------------------------------------------
def _rule_blocking(model: _ClassModel) -> List[Finding]:
    if not model.blocking:
        return []
    # Dedicated I/O-serialization locks are the sanctioned exception
    # (KVChannel._send_lock, ElasticMember._lock): serializing the
    # channel is the lock's PURPOSE, so blocking on it is the design,
    # not a bug. Two shapes qualify:
    #   - every with-region of the lock blocks (pure framing lock):
    #     fully exempt;
    #   - every region touches one common channel attribute and at
    #     least one region does socket/RPC I/O on it: exempt for
    #     socket/RPC findings ONLY — a time.sleep or jit dispatch
    #     smuggled under the same lock still flags.
    full_exempt: Set[str] = set()
    io_exempt: Set[str] = set()
    for lock, regions in model.with_regions.items():
        if not regions:
            continue
        if all(r.blocked for r in regions):
            full_exempt.add(lock)
        common = set.intersection(*[r.attrs for r in regions])
        if common and any(r.io for r in regions):
            io_exempt.add(lock)
    findings: List[Finding] = []
    for b in model.blocking:
        if b.lock_region in full_exempt:
            continue
        if b.io and b.lock_region in io_exempt:
            continue
        findings.append(Finding(
            "MXL202", model.path, b.line, b.col,
            f"blocking {b.desc} while holding "
            f"{model.name}.{b.lock_region} in {b.method}() — every "
            f"thread contending for the lock stalls behind it; move "
            f"the blocking work outside the critical section (the "
            f"two-phase admission pattern)"))
    return findings


# ---------------------------------------------------------------------------
# MXL203 — lock-order cycles over the global acquisition graph
# ---------------------------------------------------------------------------
@dataclass
class LockGraph:
    """The cross-class lock model: canonical nodes ``Class.attr``
    (Condition attrs aliased onto the lock they wrap), directed edges
    "held -> acquired" with their source sites. ``multi_lock_classes``
    = classes defining >= 2 sync attributes or holding one lock while
    (transitively) acquiring another."""
    nodes: Set[str] = field(default_factory=set)
    edges: Dict[Tuple[str, str], Tuple[str, int]] = \
        field(default_factory=dict)
    aliases: Dict[str, str] = field(default_factory=dict)
    multi_lock_classes: Set[str] = field(default_factory=set)

    def add_edge(self, src: str, dst: str, path: str,
                 line: int) -> None:
        if src == dst:
            return
        self.nodes.update((src, dst))
        self.edges.setdefault((src, dst), (path, line))

    def cycle_edges(self) -> List[Tuple[str, str, str, int]]:
        """Edges participating in a cycle (both members of one
        strongly-connected component), with their sites."""
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        comp: Dict[str, int] = {}
        stack: List[str] = []
        counter = [0]
        ncomp = [0]
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)

        def strongconnect(v: str) -> None:
            work = [(v, iter(adj.get(v, ())))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on.add(w)
                        work.append((w, iter(adj.get(w, ()))))
                        advanced = True
                        break
                    if w in on:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        comp[w] = ncomp[0]
                        if w == node:
                            break
                    ncomp[0] += 1

        for v in sorted(self.nodes):
            if v not in index:
                strongconnect(v)
        sizes: Dict[int, int] = {}
        for v, c in comp.items():
            sizes[c] = sizes.get(c, 0) + 1
        out = []
        for (a, b), (path, line) in sorted(self.edges.items()):
            if comp.get(a) is not None and comp.get(a) == comp.get(b) \
                    and sizes.get(comp[a], 0) > 1:
                out.append((a, b, path, line))
        return out


def build_lock_graph(models: Sequence[_ClassModel]) -> LockGraph:
    graph = LockGraph()
    by_class = {m.name: m for m in models}
    for m in models:
        for attr, kind in m.sync_attrs.items():
            canon = m.canon(attr)
            graph.nodes.add(f"{m.name}.{canon}")
            if attr != canon:
                graph.aliases[f"{m.name}.{attr}"] = \
                    f"{m.name}.{canon}"
        if len(m.sync_attrs) >= 2:
            graph.multi_lock_classes.add(m.name)

    # (class, method) -> transitive lock-acquisition closure via
    # direct acquisitions and self-calls
    closure: Dict[Tuple[str, str], Set[str]] = {}

    def method_closure(cname: str, mname: str,
                       seen: Set[Tuple[str, str]]) -> Set[str]:
        key = (cname, mname)
        if key in closure:
            return closure[key]
        if key in seen:
            return set()
        seen.add(key)
        m = by_class.get(cname)
        out: Set[str] = set()
        if m is None:
            return out
        for acq in m.acquires:
            if acq.method.split(".<locals>.")[0] == mname:
                out.add(f"{cname}.{acq.lock}")
        for c in m.calls_out:
            if c.recv_is_self and \
                    c.method.split(".<locals>.")[0] == mname and \
                    c.method_name in m.methods:
                out |= method_closure(cname, c.method_name, seen)
        closure[key] = out
        return out

    for m in models:
        for mm in m.methods:
            method_closure(m.name, mm, set())

    # duck resolution, frozen on the round-1 closures: a non-self call
    # ``x.m()`` resolves iff exactly ONE scanned class's ``m`` has a
    # non-empty acquisition closure (ambiguous names — submit, route —
    # are skipped: a wrong candidate would fabricate cycles)
    duck: Dict[str, Optional[Tuple[str, Set[str]]]] = {}
    all_names: Dict[str, List[str]] = {}
    for m in models:
        for mm in m.methods:
            all_names.setdefault(mm, []).append(m.name)
    for name, classes in all_names.items():
        acquirers = [(c, closure[(c, name)]) for c in classes
                     if closure.get((c, name))]
        duck[name] = acquirers[0] if len(acquirers) == 1 else None

    # second closure pass: self-calls + resolved duck calls
    full: Dict[Tuple[str, str], Set[str]] = {}

    def full_closure(cname: str, mname: str,
                     seen: Set[Tuple[str, str]]) -> Set[str]:
        key = (cname, mname)
        if key in full:
            return full[key]
        if key in seen:
            return set()
        seen.add(key)
        m = by_class.get(cname)
        out: Set[str] = set(closure.get(key, set()))
        if m is None:
            return out
        for c in m.calls_out:
            if c.method.split(".<locals>.")[0] != mname:
                continue
            if c.recv_is_self and c.method_name in m.methods:
                out |= full_closure(cname, c.method_name, seen)
            elif not c.recv_is_self:
                r = duck.get(c.method_name)
                if r is not None and r[0] != cname:
                    out |= full_closure(r[0], c.method_name, seen)
        full[key] = out
        return out

    # edges: direct nested acquisition + held-across-call acquisition
    for m in models:
        for acq in m.acquires:
            if acq.held:
                graph.add_edge(f"{m.name}.{acq.held[-1]}",
                               f"{m.name}.{acq.lock}",
                               m.path, acq.line)
                graph.multi_lock_classes.add(m.name)
        for c in m.calls_out:
            if not c.held:
                continue
            targets: Set[str] = set()
            if c.recv_is_self and c.method_name in m.methods:
                targets = full_closure(m.name, c.method_name, set())
            elif not c.recv_is_self:
                r = duck.get(c.method_name)
                if r is not None and r[0] != m.name:
                    targets = full_closure(r[0], c.method_name, set())
            held_node = f"{m.name}.{c.held[-1]}"
            for t in sorted(targets):
                if t != held_node:
                    graph.add_edge(held_node, t, m.path, c.line)
                    graph.multi_lock_classes.add(m.name)
    return graph


def _rule_lock_order(models: Sequence[_ClassModel]) -> List[Finding]:
    graph = build_lock_graph(models)
    findings = []
    for a, b, path, line in graph.cycle_edges():
        findings.append(Finding(
            "MXL203", path, line, 0,
            f"lock-order cycle: {a} is held while acquiring {b}, and "
            f"elsewhere the order is reversed — a thread on each path "
            f"deadlocks; pick ONE global order (docs/lint.md "
            f"§MXL203)"))
    return findings


# ---------------------------------------------------------------------------
# MXL3xx — determinism
# ---------------------------------------------------------------------------
_PACKAGES = ("mxtpu", "mxtpu_torch")
_SERVE_MODS = ("mxtpu.serve", "mxtpu_torch.serve")


def _is_serve_path(path: str, tree: ast.AST) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    if "serve" in parts:
        return True
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.startswith(_SERVE_MODS) or mod in _PACKAGES and \
                    any(a.name == "serve" for a in node.names):
                return True
        elif isinstance(node, ast.Import):
            if any(a.name.startswith(_SERVE_MODS)
                   for a in node.names):
                return True
    return False


def _rule_serve_rng(tree: ast.AST, aliases: Dict[str, str],
                    path: str) -> List[Finding]:
    if not _is_serve_path(path, tree):
        return []
    if os.path.basename(path).startswith("bench"):
        return []          # bench harnesses derive keys from --seed:
        #                    deterministic by construction, and MXL303
        #                    owns entrypoint seeding discipline
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _dotted_chain(node.func)
        if chain is None or len(chain) < 2:
            continue
        if chain[-1] in ("PRNGKey", "split") and (
                chain[-2] == "random" and
                aliases.get(chain[0], chain[0]).split(".")[0] == "jax"
                or chain[-2] == "prng"):
            findings.append(Finding(
                "MXL301", path, node.lineno, node.col_offset,
                f"raw {'jax.random' if chain[-2] == 'random' else 'prng'}"
                f".{chain[-1]} on a serve path breaks "
                f"the bit-identity oracle across crash re-dispatch — "
                f"derive keys from the serve.resume_key chain (or "
                f"mark the chain root with # noqa: MXL301 — reason)"))
    return findings


def _rule_raw_clock(tree: ast.AST, path: str) -> List[Finding]:
    findings = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        clock_attr = None
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None and _clock_idiom(node.value):
                        clock_attr = attr
        if clock_attr is None:
            continue
        for node in ast.walk(cls):
            if not isinstance(node, ast.Call):
                continue
            chain = _dotted_chain(node.func)
            if chain is not None and len(chain) == 2 and \
                    chain[0] == "time" and chain[1] in _CLOCK_FNS:
                findings.append(Finding(
                    "MXL302", path, node.lineno, node.col_offset,
                    f"raw time.{chain[1]}() inside {cls.name}, which "
                    f"has the injectable clock self.{clock_attr} — "
                    f"call self.{clock_attr}() so tests can "
                    f"single-step time"))
    return findings


def _is_test_or_bench(path: str) -> bool:
    base = os.path.basename(path)
    parts = os.path.normpath(path).split(os.sep)
    return (base.startswith("test_") or base.startswith("bench")
            or base.endswith("_test.py") or "tests" in parts)


def _rule_unseeded_rng(tree: ast.AST, aliases: Dict[str, str],
                       path: str) -> List[Finding]:
    if not _is_test_or_bench(path):
        return []
    seeded = False
    draws: List[Tuple[ast.Call, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _dotted_chain(node.func)
        if chain is None:
            continue
        root = aliases.get(chain[0], chain[0]).split(".")[0]
        if chain[-1] == "seed" and root in ("numpy", "np", "mxtpu",
                                            "mxtpu_torch", "mx",
                                            "random"):
            seeded = True
        elif chain[-1] == "default_rng" and node.args:
            seeded = True                # explicit generator seed
        elif chain[-1] == "default_rng" and not node.args:
            draws.append((node, "default_rng()"))
        elif chain[-1] in _RNG_DRAWS and len(chain) >= 2 and \
                chain[-2] == "random" and root in ("numpy", "np",
                                                   "mxtpu", "mxtpu_torch",
                                                   "mx"):
            draws.append((node, ".".join(chain)))
        elif chain[-1] in _RNG_DRAWS and len(chain) == 2 and \
                chain[0] == "random" and root == "random":
            draws.append((node, ".".join(chain)))
    if seeded:
        return []
    return [Finding(
        "MXL303", path, n.lineno, n.col_offset,
        f"unseeded {desc} in a test/bench entrypoint — seed the "
        f"module (np.random.seed / default_rng(seed)) so reruns "
        f"reproduce (the neural-style flake class)")
        for n, desc in draws]


# ---------------------------------------------------------------------------
# MXL4xx — runtime contracts (cross-file)
# ---------------------------------------------------------------------------
@dataclass
class _MetricSite:
    name: str
    keys: Tuple[str, ...]
    has_star: bool
    path: str
    line: int
    col: int


def _metric_sites(tree: ast.AST, path: str) -> List[_MetricSite]:
    sites = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _dotted_chain(node.func)
        if chain is None or chain[-1] not in ("counter", "gauge",
                                              "histogram"):
            continue
        if len(chain) >= 2 and "telemetry" not in chain[0] and \
                chain[-2] != "telemetry":
            continue
        if len(chain) == 1:
            continue
        if not node.args or not isinstance(node.args[0], ast.Constant) \
                or not isinstance(node.args[0].value, str):
            continue
        keys = tuple(sorted(kw.arg for kw in node.keywords
                            if kw.arg is not None))
        star = any(kw.arg is None for kw in node.keywords)
        sites.append(_MetricSite(node.args[0].value, keys, star,
                                 path, node.lineno, node.col_offset))
    return sites


def _rule_metric_labels(sites: Sequence[_MetricSite]) -> List[Finding]:
    by_name: Dict[str, List[_MetricSite]] = {}
    for s in sites:
        by_name.setdefault(s.name, []).append(s)
    findings = []
    for name, group in sorted(by_name.items()):
        static = [s for s in group if not s.has_star]
        if len(static) < 2:
            continue          # **labels sites are dynamic: unverifiable
        counts: Dict[Tuple[str, ...], int] = {}
        for s in static:
            counts[s.keys] = counts.get(s.keys, 0) + 1
        if len(counts) == 1:
            continue
        ordered = sorted(static, key=lambda s: (s.path, s.line))
        consensus = max(
            counts.items(),
            key=lambda kv: (kv[1], kv[0] == ordered[0].keys))[0]
        for s in ordered:
            if s.keys != consensus:
                findings.append(Finding(
                    "MXL401", s.path, s.line, s.col,
                    f"metric {name!r} created here with label set "
                    f"{list(s.keys)} but {list(consensus)} at its "
                    f"other call sites — one series, one label "
                    f"schema (define a shared helper like "
                    f"serve.cancel_counter)"))
    return findings


_ENV_READERS = {"env_float", "env_int", "env_str", "env_bool",
                "getenv"}


@dataclass
class _EnvRead:
    name: str
    path: str
    line: int
    col: int


def _env_reads(tree: ast.AST, path: str) -> List[_EnvRead]:
    reads = []

    def const_name(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and \
                node.value.startswith("MXTPU_"):
            return node.value
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            chain = _dotted_chain(node.func)
            if chain is None:
                continue
            if chain[-1] in _ENV_READERS and node.args:
                name = const_name(node.args[0])
                if name:
                    reads.append(_EnvRead(name, path, node.lineno,
                                          node.col_offset))
            elif chain[-1] == "get" and len(chain) >= 3 and \
                    chain[-2] == "environ" and node.args:
                name = const_name(node.args[0])
                if name:
                    reads.append(_EnvRead(name, path, node.lineno,
                                          node.col_offset))
        elif isinstance(node, ast.Subscript):
            chain = _dotted_chain(node.value)
            if chain is not None and chain[-1] == "environ":
                name = const_name(node.slice)
                if name:
                    reads.append(_EnvRead(name, path, node.lineno,
                                          node.col_offset))
    return reads


_REGISTRY_CACHE: Dict[str, Optional[Tuple[Set[str],
                                          Tuple[str, ...]]]] = {}


def _env_registry(start: str):
    """(exact names, wildcard prefixes) from the nearest
    docs/env_var.md above ``start``; None when no registry exists
    (linting outside a repo — the rule stands down)."""
    d = os.path.abspath(start if os.path.isdir(start)
                        else os.path.dirname(start))
    walked = []
    while True:
        if d in _REGISTRY_CACHE:
            reg = _REGISTRY_CACHE[d]
            break
        walked.append(d)
        cand = os.path.join(d, "docs", "env_var.md")
        if os.path.isfile(cand):
            with open(cand, encoding="utf-8", errors="replace") as f:
                text = f.read()
            exact = set(re.findall(r"MXTPU_[A-Z0-9_]+", text))
            wild = tuple(p for p in
                         re.findall(r"(MXTPU_[A-Z0-9_]+_)\*", text))
            reg = (exact, wild)
            break
        parent = os.path.dirname(d)
        if parent == d:
            reg = None
            break
        d = parent
    for w in walked:
        _REGISTRY_CACHE[w] = reg
    return reg


def _rule_env_drift(reads: Sequence[_EnvRead]) -> List[Finding]:
    findings = []
    for r in reads:
        reg = _env_registry(r.path)
        if reg is None:
            continue
        exact, wild = reg
        if r.name in exact or any(r.name.startswith(p) for p in wild):
            continue
        findings.append(Finding(
            "MXL402", r.path, r.line, r.col,
            f"env knob {r.name} is read here but not registered in "
            f"docs/env_var.md — every MXTPU_* knob must be in the "
            f"config reference (add a table row)"))
    return findings


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
class _DeepRun:
    def __init__(self) -> None:
        self.findings: List[Finding] = []
        self.models: List[_ClassModel] = []
        self.metric_sites: List[_MetricSite] = []
        self.env_reads: List[_EnvRead] = []
        self.suppress: Dict[str, Dict[int, Set[str]]] = {}

    def add_source(self, source: str, path: str) -> None:
        try:
            tree = ast.parse(source)
        except SyntaxError:
            return                       # the base pass reports MXL000
        self.suppress[path] = _deep_suppressions(source)
        aliases = _collect_aliases(tree)
        models = [_scan_class(c, path, aliases)
                  for c in ast.walk(tree)
                  if isinstance(c, ast.ClassDef)]
        self.models.extend(models)
        for m in models:
            self.findings += _rule_lockset(m)
            self.findings += _rule_blocking(m)
        self.findings += _rule_serve_rng(tree, aliases, path)
        self.findings += _rule_raw_clock(tree, path)
        self.findings += _rule_unseeded_rng(tree, aliases, path)
        self.metric_sites += _metric_sites(tree, path)
        self.env_reads += _env_reads(tree, path)

    def add_file(self, path: str) -> None:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            self.add_source(f.read(), path)

    def finalize(self,
                 rules: Optional[Sequence[str]] = None
                 ) -> List[Finding]:
        findings = list(self.findings)
        findings += _rule_lock_order(self.models)
        findings += _rule_metric_labels(self.metric_sites)
        findings += _rule_env_drift(self.env_reads)
        if rules is not None:
            wanted = {r.upper() for r in rules}
            findings = [f for f in findings if f.rule in wanted]
        out = []
        for f in findings:
            sup = self.suppress.get(f.path, {})
            if {f.rule, "ALL"} & sup.get(f.line, set()):
                continue
            out.append(f)
        out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return out


def deep_lint_paths(paths: Sequence[str],
                    rules: Optional[Sequence[str]] = None
                    ) -> List[Finding]:
    """Run the deep pass (MXL2xx/3xx/4xx) over every ``.py`` under
    ``paths``. Cross-file rules (MXL203 duck resolution, MXL401
    consensus, MXL402 registry) see the whole run at once."""
    run = _DeepRun()
    for f in iter_python_files(paths):
        run.add_file(f)
    return run.finalize(rules)


def deep_lint_file(path: str,
                   rules: Optional[Sequence[str]] = None
                   ) -> List[Finding]:
    run = _DeepRun()
    run.add_file(path)
    return run.finalize(rules)


def deep_lint_source(source: str, path: str = "<string>",
                     rules: Optional[Sequence[str]] = None
                     ) -> List[Finding]:
    run = _DeepRun()
    run.add_source(source, path)
    return run.finalize(rules)


def lock_graph_for(paths: Sequence[str]) -> LockGraph:
    """The cross-class lock model for ``paths`` — the static half the
    runtime sanitizer (:mod:`.lockcheck`) checks observed acquisition
    orders against, and what tests assert coverage on."""
    run = _DeepRun()
    for f in iter_python_files(paths):
        run.add_file(f)
    return build_lock_graph(run.models)
