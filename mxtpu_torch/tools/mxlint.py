"""mxlint for the port: ``python -m mxtpu_torch.tools.mxlint [--deep]
[--sarif FILE] [paths ...]`` — the counterpart of ``python -m
tools.mxlint`` over :mod:`mxtpu_torch.contrib.analysis`.

The rule engines (``rules.py``, ``deep.py``) are stdlib-only, so they
are loaded by file path: the lint itself imports nothing of torch
beyond what starting ``mxtpu_torch`` costs. With no paths it lints
``mxtpu_torch/``. Exit code 0 when clean, 1 on findings, 2 on a path
that does not exist.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_ANALYSIS = os.path.join(_ROOT, "mxtpu_torch", "contrib", "analysis")


def _load_by_path(name, fname):
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ANALYSIS, fname))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod


rules = _load_by_path("_mxlint_torch_rules", "rules.py")
deep = _load_by_path("_mxlint_torch_deep", "deep.py")
RULES = rules.RULES
DEEP_RULES = deep.DEEP_RULES

__all__ = ["RULES", "DEEP_RULES", "to_sarif", "main"]


def to_sarif(findings, all_rules):
    """Findings as a minimal SARIF 2.1.0 log (one run), the reference
    CLI's format."""
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "mxlint",
                "informationUri": "docs/lint.md",
                "rules": [{"id": rid,
                           "shortDescription": {"text": desc}}
                          for rid, desc in sorted(all_rules.items())],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line,
                               "startColumn": f.col + 1},
                }}],
            } for f in findings],
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxtpu_torch.tools.mxlint",
        description="mxlint: trace-safety static analysis (rules "
                    "MXL001-MXL004), plus the --deep concurrency/"
                    "determinism/contract pass (MXL2xx/3xx/4xx)")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: "
                         "mxtpu_torch/ under the repo root)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON array")
    ap.add_argument("--sarif", metavar="FILE",
                    help="also write a SARIF 2.1.0 report to FILE "
                         "('-' for stdout)")
    ap.add_argument("--rules", metavar="ID[,ID...]",
                    help="only run these rule IDs")
    ap.add_argument("--deep", action="store_true",
                    help="also run the deep pass: lockset/lock-order "
                         "(MXL2xx), determinism (MXL3xx), runtime "
                         "contracts (MXL4xx)")
    args = ap.parse_args(argv)

    all_rules = dict(RULES)
    if args.deep or args.list_rules:
        all_rules.update(DEEP_RULES)
    if args.list_rules:
        for rid in sorted(all_rules):
            print(f"{rid}  {all_rules[rid]}")
        return 0

    paths = args.paths or [os.path.join(_ROOT, "mxtpu_torch")]
    for p in paths:
        if not os.path.exists(p):
            print(f"mxlint: no such path: {p}")
            return 2
    only = args.rules.split(",") if args.rules else None
    findings = rules.lint_paths(paths, rules=only)
    if args.deep:
        findings = sorted(
            findings + deep.deep_lint_paths(paths, rules=only),
            key=lambda f: (f.path, f.line, f.col, f.rule))
    if args.sarif:
        sarif = json.dumps(to_sarif(findings, all_rules), indent=2)
        if args.sarif == "-":
            print(sarif)
        else:
            d = os.path.dirname(args.sarif)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(args.sarif, "w") as fh:
                fh.write(sarif + "\n")
    if args.json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    elif args.sarif != "-":
        for f in findings:
            print(f)
        n_files = sum(1 for _ in rules.iter_python_files(paths))
        status = "clean" if not findings else \
            f"{len(findings)} finding(s)"
        deep_tag = " [deep]" if args.deep else ""
        print(f"mxlint: {n_files} file(s){deep_tag}, {status}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
