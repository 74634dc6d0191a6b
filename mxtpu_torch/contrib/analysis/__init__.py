"""mxtpu_torch.contrib.analysis — the mxlint static-analysis suite, the
port of ``mxtpu.contrib.analysis``.

- AST rules over Python source (:mod:`.rules`): trace-safety
  (``MXL001``), tracer-control-flow (``MXL002``), dispatch-count
  (``MXL003``), serving-latency (``MXL004``). Run them with
  :func:`lint_paths` or the CLI, ``python -m mxtpu_torch.tools.mxlint
  mxtpu_torch/``.
- Graph validity over traced ``Symbol`` programs (:mod:`.graph`,
  ``MXL100``): shape/dtype inference on the ``meta`` device that
  reports the first inconsistent node with op name and inferred
  shapes; reused by the ONNX exporter and exposed as
  ``Symbol.validate()``.
- The deep pass (:mod:`.deep`): whole-tree lockset/lock-order
  analysis (``MXL201``-``MXL203``), determinism (``MXL301``-``MXL303``)
  and runtime-contract drift (``MXL401``/``MXL402``; the port's knobs
  are registered in ``mxtpu_torch/docs/env_var.md``). Run with
  ``python -m mxtpu_torch.tools.mxlint --deep``. Its dynamic
  counterpart is :mod:`.lockcheck` — ``MXTPU_ANALYSIS_LOCKCHECK=1``
  instruments every lock and cross-checks real acquisition orders
  against the static lock graph of ``mxtpu_torch/``.

Each rule also knows the port's form of its bug class: ``torch.*``
calls inside ``hybrid_forward`` (MXL001), torch's host syncs
(MXL004), captured CUDA graphs as programs (MXL202) and
``mxtpu_torch.prng``'s raw key draws (MXL301).
"""
from .rules import (RULES, Finding, iter_python_files, lint_file,
                    lint_paths, lint_source)
from .graph import GraphIssue, format_issues, validate_graph
from .deep import (DEEP_RULES, LockGraph, deep_lint_file,
                   deep_lint_paths, deep_lint_source, lock_graph_for)

__all__ = ["RULES", "Finding", "lint_source", "lint_file", "lint_paths",
           "iter_python_files", "GraphIssue", "validate_graph",
           "format_issues", "DEEP_RULES", "deep_lint_source",
           "deep_lint_file", "deep_lint_paths", "lock_graph_for",
           "LockGraph"]
