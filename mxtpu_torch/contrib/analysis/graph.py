"""mxlint graph-validity pass (rule ``MXL100``) — static shape/dtype
checking over a traced ``Symbol`` program: the port of
``mxtpu/contrib/analysis/graph.py``, inferring on the ``meta`` device
as the port's Symbol does (the reference asks ``jax.eval_shape``).

A thin reporting layer over ``Symbol._infer_structs_impl`` — the SAME
walker the real inference/bind/export paths run (one implementation,
so the diagnostic cannot drift from actual inference). The first
inconsistent node is reported with its op name, node name, and the
inferred input shapes — a real diagnostic instead of a deep error
three frames into a converter. No kernels run; abstract evaluation
only.

Used three ways:
- ``Symbol.validate(**shapes)`` — user-facing pre-flight check;
- the ONNX exporter (``mxtpu_torch.contrib.onnx``) — a graph that
  fails validation aborts export with the formatted diagnostic;
- the tests, which seed a malformed graph and assert the diagnostic
  names the op and shapes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["GraphIssue", "validate_graph", "format_issues"]


@dataclass
class GraphIssue:
    """One graph-validity violation (rule MXL100)."""
    op: str
    name: str
    message: str
    input_shapes: List[Optional[Tuple[int, ...]]] = field(
        default_factory=list)
    rule: str = "MXL100"

    def __str__(self) -> str:
        shapes = ", ".join("?" if s is None else str(tuple(s))
                           for s in self.input_shapes)
        loc = f"node {self.name!r} (op {self.op!r}"
        loc += f", input shapes [{shapes}])" if self.input_shapes else ")"
        return f"{self.rule} {loc}: {self.message}"


def format_issues(issues: List[GraphIssue]) -> str:
    return "\n".join(str(i) for i in issues)


def _as_struct(v):
    """NDArray / tensor / numpy array / shape tuple → a meta tensor of
    that shape and dtype (float32 for a bare shape)."""
    from ...symbol.symbol import _meta
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is not None and dtype is not None:
        return _meta(tuple(shape), dtype)
    return _meta(tuple(v), "float32")


def validate_graph(sym, params: Optional[Dict[str, Any]] = None,
                   input_shapes: Optional[Dict[str, Any]] = None
                   ) -> List[GraphIssue]:
    """Statically check a Symbol graph; [] means valid.

    ``params`` maps var name → NDArray/numpy array (shape+dtype source);
    ``input_shapes`` maps var name → shape tuple, or anything with a
    shape and a dtype.
    Stops at the first inconsistent node (everything downstream of a bad
    node would fail for derived reasons)."""
    var_structs: Dict[str, Any] = {}
    for k, v in (params or {}).items():
        var_structs[k] = _as_struct(v)
    for k, v in (input_shapes or {}).items():
        var_structs.setdefault(k, _as_struct(v))

    issues: List[GraphIssue] = []

    def on_error(node, in_structs, exc, missing):
        if missing is not None:
            what = "graph output var" if node.is_var() else "input"
            issues.append(GraphIssue(
                node.op, node.name,
                f"{what} {missing!r} has no shape — declare it via "
                f"input_shapes={{'{missing}': (...)}} or var(shape=...)"))
            return
        # _abstract_eval_node wraps the root cause in MXNetError; the
        # cause's first line is the actual shape/dtype complaint
        root = exc.__cause__ or exc
        msg = str(root).strip().splitlines()
        issues.append(GraphIssue(
            node.op, node.name, msg[0] if msg else repr(root),
            [tuple(s.shape) for s in in_structs]))

    sym._infer_structs_impl(var_structs, on_error=on_error)
    return issues
