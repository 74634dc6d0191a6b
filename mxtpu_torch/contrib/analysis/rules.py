"""mxlint AST rules — trace-safety static analysis over mxtpu_torch and
its users' code (the port of ``mxtpu/contrib/analysis/rules.py``: every
rule ID and message is the reference's; each rule also knows the
port's own form of its bug class).

The round-5 regression that motivated this pass: ``HybridConcatenate.
hybrid_forward`` hardcoded ``nd.concat`` instead of routing through the
``F`` parameter, so every ``hybridize()``/export trace died at runtime.
That is a *class* of bug — backend calls that bypass ``F``, Python
control flow on tracer values, per-parameter dispatch loops on the hot
path — and every instance is statically visible in the AST. These rules
catch the whole class at lint time, before a device or a trace is ever
involved.

Rules (stable IDs, see docs/lint.md):

- ``MXL001`` trace-safety: a hardcoded ``nd.*``/``np.*``/``jnp.*`` call
  (any alias of an ndarray/numpy backend module), or a ``torch.*`` /
  ``torch.nn.functional.*`` call, inside a ``hybrid_forward`` body. Under a symbolic or jit trace the inputs are
  Symbols/tracers, so the eager backend call either crashes or silently
  constant-folds; route through ``F`` instead.
- ``MXL002`` tracer-control-flow: ``if``/``while``/``assert`` whose
  condition derives from a tensor argument of ``hybrid_forward``.
  Truthiness of a traced tensor breaks ``hybridize()``/jit. Static
  facts (``x.shape``, ``x.ndim``, ``x.dtype``, ``x is None``,
  ``isinstance(x, ...)``) are fine and not flagged.
- ``MXL003`` dispatch-count: a per-parameter Python loop dispatching
  optimizer/ndarray ops inside a ``step``/``update`` path — the
  ~150-dispatches-per-step pattern ``Trainer.make_fused_step`` exists
  to kill.
- ``MXL004`` serving-latency: a host synchronization (``.item()``,
  ``float()``/``int()`` on a tensor, ``np.asarray``,
  ``.block_until_ready()``, ``jax.device_get``, ``.asnumpy()``, and
  torch's ``.tolist()``, ``.cpu()`` and ``torch.cuda.synchronize()``)
  inside a decode/generate loop body — the classic serving-latency
  bug: the host blocks on every token and the accelerator pipeline
  drains. Flagged when the loop's enclosing function is decode/
  generate/serve-named OR the loop body itself dispatches a
  decode/generate call. Fix: read tokens back one step late so the
  sync overlaps the next step's compute (the ``mxtpu.serve`` engine's
  pattern — docs/serving.md), or batch the readback after the loop.

Suppression: append ``# mxlint: disable=MXL001`` (comma-separate for
several IDs, or ``disable=all``) to the flagged line, or put the comment
alone on the line directly above it.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["RULES", "Finding", "lint_source", "lint_file", "lint_paths",
           "iter_python_files"]

RULES: Dict[str, str] = {
    "MXL000": "parse-error: file does not parse as Python",
    "MXL001": "trace-safety: hardcoded backend call inside hybrid_forward "
              "(route through the F parameter)",
    "MXL002": "tracer-control-flow: Python control flow on a tensor value "
              "inside hybrid_forward (breaks hybridize()/jit)",
    "MXL003": "dispatch-count: per-parameter Python op loop in a "
              "step/update path (use Trainer.make_fused_step)",
    "MXL004": "serving-latency: host sync inside a decode/generate "
              "loop body (overlap or batch the readback — "
              "docs/serving.md)",
    "MXL100": "graph-validity: Symbol graph fails static shape/dtype "
              "inference (see mxtpu.contrib.analysis.validate_graph)",
}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


# ---------------------------------------------------------------------------
# suppression comments
# ---------------------------------------------------------------------------
_DISABLE_RE = re.compile(r"#\s*mxlint:\s*disable=([A-Za-z0-9_,\s]+)")


def _suppressions(source: str) -> Dict[int, Set[str]]:
    """line number → set of disabled rule IDs (or {'all'}). A disable
    comment covers its own line; a standalone disable comment also
    covers the next line."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(line)
        if not m:
            continue
        ids = {s.strip().upper() for s in m.group(1).split(",") if s.strip()}
        out.setdefault(i, set()).update(ids)
        if line.split("#", 1)[0].strip() == "":  # comment-only line
            out.setdefault(i + 1, set()).update(ids)
    return out


# ---------------------------------------------------------------------------
# import alias resolution
# ---------------------------------------------------------------------------
# module paths whose calls produce/consume concrete arrays (not F-routed).
# Matching is on the dotted path: the last segment, or any segment for
# 'ndarray' (so relative imports like ``from .. import ndarray as nd``
# and deep ones like ``mxtpu.ndarray.random`` both match), and any path
# rooted at ``torch`` (``torch.cat``, ``torch.nn.functional.relu``: the
# port's eager backend, which the Symbol trace cannot see through).
_TENSOR_LAST_SEGMENTS = {"ndarray", "numpy", "nd", "jnp", "numpy_extension"}


def _is_tensor_module(dotted: str) -> bool:
    parts = [p for p in dotted.split(".") if p]
    if not parts:
        return False
    return parts[-1] in _TENSOR_LAST_SEGMENTS or "ndarray" in parts \
        or "numpy" in parts or parts[0] == "torch"


def _collect_aliases(tree: ast.AST) -> Dict[str, str]:
    """name bound by an import → the dotted module/object path it names.
    Relative imports keep their leading dots stripped (segment matching
    only cares about the trailing path)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                bound = a.asname or a.name.split(".")[0]
                aliases[bound] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                bound = a.asname or a.name
                aliases[bound] = f"{mod}.{a.name}" if mod else a.name
    return aliases


def _dotted_chain(expr: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` → ["a", "b", "c"]; None when the root is not a Name."""
    parts: List[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(cur.id)
    return parts[::-1]


def _expand_callee_module(chain: List[str],
                          aliases: Dict[str, str]) -> Optional[str]:
    """Dotted path of the MODULE a call resolves into, with the root
    alias expanded — ``nd.concat`` → ``mxtpu.ndarray``, ``mx.nd.concat``
    → ``mxtpu.nd``, ``concat`` (imported from mxtpu.ndarray) →
    ``mxtpu.ndarray``. None when the root is not an import alias."""
    root = chain[0]
    if root not in aliases:
        return None
    expanded = aliases[root].split(".") + chain[1:]
    return ".".join(expanded[:-1]) if len(expanded) > 1 else expanded[0]


# ---------------------------------------------------------------------------
# hybrid_forward discovery
# ---------------------------------------------------------------------------
def _hybrid_forwards(tree: ast.AST) -> List[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name == "hybrid_forward"]


def _tensor_params(fn: ast.FunctionDef) -> Set[str]:
    """The tensor arguments of hybrid_forward(self, F, x, *args,
    **params): everything after (self, F), including defaults, kw-only
    args, *args and **kwargs (parameters arrive through **kwargs)."""
    names = [a.arg for a in fn.args.args[2:]]
    names += [a.arg for a in fn.args.kwonlyargs]
    if fn.args.vararg is not None:
        names.append(fn.args.vararg.arg)
    if fn.args.kwarg is not None:
        names.append(fn.args.kwarg.arg)
    return set(names)


# ---------------------------------------------------------------------------
# MXL001 — trace-safety
# ---------------------------------------------------------------------------
def _rule_trace_safety(tree: ast.AST, aliases: Dict[str, str],
                       path: str) -> List[Finding]:
    findings: List[Finding] = []
    for fn in _hybrid_forwards(tree):
        # the function's own arguments (F above all) shadow any import
        # of the same name: ``F.relu`` is the routed call even in a file
        # that imports ``torch.nn.functional as F``
        own = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            chain = _dotted_chain(node.func)
            if chain is None or chain[0] in own:
                continue
            module = _expand_callee_module(chain, aliases)
            if module is None or not _is_tensor_module(module):
                continue
            callee = ".".join(chain)
            findings.append(Finding(
                "MXL001", path, node.lineno, node.col_offset,
                f"hardcoded backend call {callee}() inside hybrid_forward "
                f"resolves to module {module!r}; use the F parameter so "
                f"the op traces (F.{chain[-1]}(...))"))
    return findings


# ---------------------------------------------------------------------------
# MXL002 — tracer control flow
# ---------------------------------------------------------------------------
# attribute reads that are static under a trace (shape metadata, not data)
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "context", "ctx",
                 "stype", "name", "grad_req"}
# calls whose result is trace-static regardless of argument taint
_STATIC_CALLS = {"len", "isinstance", "issubclass", "hasattr", "getattr",
                 "type", "id", "repr", "str"}


class _TaintChecker:
    """Conservative forward taint pass over one hybrid_forward body."""

    def __init__(self, tainted: Set[str]):
        self.tainted = set(tainted)

    # -- expression taint ---------------------------------------------------
    def expr_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.expr_tainted(node.value)
        if isinstance(node, ast.Call):
            chain = _dotted_chain(node.func)
            if chain is not None and chain[0] in _STATIC_CALLS \
                    and len(chain) == 1:
                return False
            # a call taints if its function or any argument taints
            # (F.relu(x), x.sum(), tainted_fn(...))
            parts = [node.func] + list(node.args) + \
                [kw.value for kw in node.keywords]
            return any(self.expr_tainted(p) for p in parts)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops):
                return False  # identity checks are static under trace
            return self.expr_tainted(node.left) or \
                any(self.expr_tainted(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.expr_tainted(v) for v in node.values)
        if isinstance(node, ast.BinOp):
            return self.expr_tainted(node.left) or \
                self.expr_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr_tainted(node.operand)
        if isinstance(node, ast.Subscript):
            return self.expr_tainted(node.value)
        if isinstance(node, ast.IfExp):
            return self.expr_tainted(node.body) or \
                self.expr_tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr_tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.expr_tainted(node.value)
        return False

    # -- statement walk -----------------------------------------------------
    def _bind(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)
        # attribute/subscript targets don't (un)taint names

    def run(self, body: Sequence[ast.stmt], path: str,
            findings: List[Finding]) -> None:
        for stmt in body:
            if isinstance(stmt, ast.Assign):
                t = self.expr_tainted(stmt.value)
                for target in stmt.targets:
                    self._bind(target, t)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._bind(stmt.target, self.expr_tainted(stmt.value))
            elif isinstance(stmt, ast.AugAssign):
                if self.expr_tainted(stmt.value):
                    self._bind(stmt.target, True)
            elif isinstance(stmt, (ast.If, ast.While)):
                if self.expr_tainted(stmt.test):
                    kw = "while" if isinstance(stmt, ast.While) else "if"
                    findings.append(Finding(
                        "MXL002", path, stmt.lineno, stmt.col_offset,
                        f"`{kw}` condition derives from a hybrid_forward "
                        f"tensor argument — truthiness of a traced tensor "
                        f"breaks hybridize()/jit (use F.where or restructure"
                        f" on static facts like .shape)"))
                self.run(stmt.body, path, findings)
                self.run(stmt.orelse, path, findings)
            elif isinstance(stmt, ast.Assert):
                if self.expr_tainted(stmt.test):
                    findings.append(Finding(
                        "MXL002", path, stmt.lineno, stmt.col_offset,
                        "`assert` on a hybrid_forward tensor argument — "
                        "the check evaluates a traced tensor and breaks "
                        "hybridize()/jit"))
            elif isinstance(stmt, ast.For):
                self._bind(stmt.target, self.expr_tainted(stmt.iter))
                self.run(stmt.body, path, findings)
                self.run(stmt.orelse, path, findings)
            elif isinstance(stmt, (ast.With,)):
                self.run(stmt.body, path, findings)
            elif isinstance(stmt, ast.Try):
                self.run(stmt.body, path, findings)
                for h in stmt.handlers:
                    self.run(h.body, path, findings)
                self.run(stmt.orelse, path, findings)
                self.run(stmt.finalbody, path, findings)
            elif isinstance(stmt, ast.Return) and stmt.value is not None:
                pass
            # nested defs/classes start a new scope — skip


def _rule_tracer_flow(tree: ast.AST, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for fn in _hybrid_forwards(tree):
        checker = _TaintChecker(_tensor_params(fn))
        checker.run(fn.body, path, findings)
    return findings


# ---------------------------------------------------------------------------
# MXL003 — per-parameter dispatch loops
# ---------------------------------------------------------------------------
_STEP_FN_RE = re.compile(r"^_?(step|update)(_multi_precision)?$")
# optimizer-op callees: sgd_update, sgd_mom_update, adam_update,
# mp_lamb_update, ... plus anything called through an updater/optimizer
_OPT_OP_RE = re.compile(
    r"^(mp_)?(sgd|adam|adamw|rmsprop|adagrad|adadelta|lamb|ftrl|nag|"
    r"signsgd|signum|dcasgd|lars)\w*_update\w*$")


def _callee_last(call: ast.Call) -> Tuple[Optional[str], List[str]]:
    chain = _dotted_chain(call.func)
    if chain is None:
        return None, []
    return chain[-1], chain


def _loop_dispatches_updates(loop: ast.AST) -> Optional[str]:
    """Does this loop body dispatch a per-parameter optimizer update?
    Returns a short description of the offending call, or None."""
    for node in ast.walk(loop):
        if not isinstance(node, ast.Call):
            continue
        last, chain = _callee_last(node)
        if last is None:
            continue
        receiver = chain[:-1]
        if "updater" in last or _OPT_OP_RE.match(last):
            return ".".join(chain)
        if last in ("update", "update_multi_precision") and any(
                "optimizer" in seg or seg in ("_opt", "opt")
                for seg in receiver):
            return ".".join(chain)
    return None


def _loop_is_param_update(loop: ast.For) -> bool:
    """The user-code shape of the pattern: iterate parameters, body does
    ``p.set_data(... p.grad() ...)`` — one eager dispatch chain per
    parameter per step."""
    it = ast.unparse(loop.iter)
    if "param" not in it.lower():
        return False
    body_src = "".join(ast.unparse(s) for s in loop.body)
    return ".set_data(" in body_src and ".grad(" in body_src


def _rule_dispatch_count(tree: ast.AST, path: str) -> List[Finding]:
    findings: List[Finding] = []
    flagged: Set[int] = set()

    def emit(node: ast.AST, offender: str) -> None:
        if id(node) in flagged:
            return
        flagged.add(id(node))
        findings.append(Finding(
            "MXL003", path, node.lineno, node.col_offset,
            f"per-parameter Python loop dispatches {offender} on the "
            f"step/update hot path (~one device dispatch per parameter "
            f"per step); fuse with Trainer.make_fused_step(net)"))

    # (a) updater/optimizer-op calls looped inside a step/update function
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or not _STEP_FN_RE.match(fn.name):
            continue
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.While)):
                offender = _loop_dispatches_updates(node)
                if offender is not None:
                    emit(node, offender)
    # (b) the user-script shape, anywhere (module level included):
    # iterate parameters, set_data(grad...) each
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and _loop_is_param_update(node):
            emit(node, "set_data(.. .grad() ..) per parameter")
    return findings


# ---------------------------------------------------------------------------
# MXL004 — host syncs inside decode/generate loops
# ---------------------------------------------------------------------------
# function names that mark a serving/decoding context on their own
# (anchored at a word/underscore start: "imdecode" — the image codec —
# must not qualify)
_SERVE_FN_RE = re.compile(r"(?:^|_)(decode|generate|serve)",
                          re.IGNORECASE)
# callee last-segments that mark a loop body as a decode loop; the
# caller additionally requires >= 2 call arguments so ``bytes
# .decode()`` / ``s.decode("utf-8")`` never qualify
_DECODE_CALL_RE = re.compile(r"(?:^|_)(decode|generate)",
                             re.IGNORECASE)
# method calls that force a device->host sync on their receiver
_SYNC_ATTRS = {"item", "block_until_ready", "asnumpy", "tolist", "cpu"}
# host-numpy entry points that force a sync on a device-array argument
_HOST_NP_FUNCS = {"asarray", "array"}


def _sync_call_desc(node: ast.Call, aliases: Dict[str, str],
                    weak: bool) -> Optional[str]:
    """A short description of why this call is a host sync, or None.
    ``weak`` additionally counts ``float()``/``int()`` on a
    non-constant — only safe to assume tensor-ish when the loop
    provably dispatches decode/generate (the colocation context); in
    the name-only context they are far more often host-value parses."""
    chain = _dotted_chain(node.func)
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _SYNC_ATTRS and not (
                node.func.attr == "cpu" and chain is not None
                and chain[0] in aliases):    # mx.cpu() is a context
        return f".{node.func.attr}()"
    if weak and chain is not None and len(chain) == 1 and \
            chain[0] in ("float", "int") and len(node.args) == 1 and \
            not isinstance(node.args[0], ast.Constant):
        return f"{chain[0]}(...)"
    if chain is None:
        return None
    if chain[-1] == "device_get":
        return ".".join(chain) + "(...)"
    if chain[-1] == "synchronize" and "cuda" in chain[:-1]:
        return ".".join(chain) + "()"
    module = _expand_callee_module(chain, aliases)
    if module is not None and chain[-1] in _HOST_NP_FUNCS and \
            "numpy" in module.split(".") and \
            module.split(".")[0] != "jax":
        return ".".join(chain) + "(...)"
    return None


def _loop_calls_decode(loop: ast.AST) -> bool:
    for node in ast.walk(loop):
        if isinstance(node, ast.Call):
            chain = _dotted_chain(node.func)
            if chain is not None and \
                    _DECODE_CALL_RE.search(chain[-1]) and \
                    len(node.args) + len(node.keywords) >= 2:
                return True
    return False


def _rule_serving_sync(tree: ast.AST, aliases: Dict[str, str],
                       path: str) -> List[Finding]:
    findings: List[Finding] = []
    flagged: Set[int] = set()

    def scan_loops(scope: ast.AST, fn_name: str) -> None:
        for loop in ast.walk(scope):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            colocated = _loop_calls_decode(loop)
            in_context = colocated or \
                bool(_SERVE_FN_RE.search(fn_name))
            if not in_context:
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call) or \
                        id(node) in flagged:
                    continue
                desc = _sync_call_desc(node, aliases, weak=colocated)
                if desc is None:
                    continue
                flagged.add(id(node))
                findings.append(Finding(
                    "MXL004", path, node.lineno, node.col_offset,
                    f"host sync {desc} inside a decode/generate loop "
                    f"body blocks the accelerator every iteration; "
                    f"read results back one step late (overlap) or "
                    f"batch the readback after the loop "
                    f"(docs/serving.md)"))

    # loops inside functions carry the function's name as context;
    # module-level loops qualify only via the decode-call heuristic
    covered: Set[int] = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_loops(fn, fn.name)
            for n in ast.walk(fn):
                covered.add(id(n))
    for node in ast.iter_child_nodes(tree):
        if id(node) not in covered:
            scan_loops(node, "")
    return findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def lint_source(source: str, path: str = "<string>",
                rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the AST rules over one source blob. ``rules`` filters to a
    subset of rule IDs (default: all)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("MXL000", path, e.lineno or 1, e.offset or 0,
                        f"file does not parse: {e.msg}")]
    aliases = _collect_aliases(tree)
    findings: List[Finding] = []
    findings += _rule_trace_safety(tree, aliases, path)
    findings += _rule_tracer_flow(tree, path)
    findings += _rule_dispatch_count(tree, path)
    findings += _rule_serving_sync(tree, aliases, path)
    if rules is not None:
        wanted = {r.upper() for r in rules}
        findings = [f for f in findings if f.rule in wanted]
    sup = _suppressions(source)
    findings = [f for f in findings
                if not ({f.rule, "ALL"} & sup.get(f.line, set()))]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_file(path: str,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return lint_source(f.read(), path=path, rules=rules)


_SKIP_DIRS = {"__pycache__", ".git", ".tox", ".venv", "node_modules",
              "build", "dist"}


def iter_python_files(paths: Sequence[str]):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in _SKIP_DIRS and
                             not d.startswith("."))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def lint_paths(paths: Sequence[str],
               rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint every ``.py`` under the given files/directories."""
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        findings += lint_file(f, rules=rules)
    return findings
