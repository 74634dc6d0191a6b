"""mx.contrib.analysis in the port (mxlint's rules, the deep pass,
lockcheck) against ``mxtpu.contrib.analysis``.

- Every fixture of ``tests/artifacts/mxlint_fixtures`` (and ``deep/``)
  gives the same (rule, line) findings from both packages.
- The port-idiom fixtures of ``tests/data/mxlint_torch`` (torch calls
  in ``hybrid_forward``, torch's host syncs, CUDA graph replays under a
  lock, raw ``prng`` draws on a serve path) are flagged exactly at
  their ``# seeded:`` markers.
- The suppression forms, the CLI (exit codes, ``--deep``, ``--sarif``),
  the port's knob registry, and the two repo gates: ``mxtpu_torch/``
  lints clean, and the deep pass over it and ``chip_smoke.py`` finds
  nothing. The lock graph and lockcheck are in
  ``test_torch_contrib_lockcheck.py``.
"""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from mxtpu.contrib import analysis as ja
from mxtpu_torch.contrib import analysis as ta

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "artifacts", "mxlint_fixtures")
DEEP_FIXTURES = os.path.join(FIXTURES, "deep")
PORT_FIXTURES = os.path.join(REPO, "tests", "data", "mxlint_torch")
_SEED_RE = re.compile(r"#\s*seeded:\s*(MXL\d+)")


def _py(root):
    return sorted(f for f in os.listdir(root) if f.endswith(".py"))


def _seeded(path):
    with open(path) as f:
        return {(i, m.group(1)) for i, line in enumerate(f, start=1)
                for m in _SEED_RE.finditer(line)}


def _findings(pkg, path, deep):
    got = {(f.line, f.rule) for f in pkg.lint_file(path)}
    if deep:
        got |= {(f.line, f.rule) for f in pkg.deep_lint_file(path)}
    return got


# ---------------------------------------------------------------------------
# the reference's fixtures: the same findings from both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", [os.path.join(FIXTURES, f)
                                  for f in _py(FIXTURES)]
                         + [os.path.join(DEEP_FIXTURES, f)
                            for f in _py(DEEP_FIXTURES)],
                         ids=lambda p: os.path.relpath(p, FIXTURES))
def test_reference_fixture_findings_match(path):
    deep = os.path.dirname(path) == DEEP_FIXTURES
    want = _findings(ja, path, deep)
    assert want == _seeded(path)
    assert _findings(ta, path, deep) == want


def test_rule_tables_match():
    assert set(ta.RULES) == set(ja.RULES)
    assert set(ta.DEEP_RULES) == set(ja.DEEP_RULES)


# ---------------------------------------------------------------------------
# the port's idioms: recall 100 %, no false positive
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", [os.path.join(PORT_FIXTURES, f)
                                  for f in _py(PORT_FIXTURES)]
                         + [os.path.join(PORT_FIXTURES, "deep", f)
                            for f in _py(os.path.join(PORT_FIXTURES,
                                                      "deep"))],
                         ids=lambda p: os.path.relpath(p, PORT_FIXTURES))
def test_port_idiom_fixture_flagged_exactly(path):
    want = _seeded(path)
    got = _findings(ta, path, deep=True)
    assert not want - got, f"seeded, not flagged: {sorted(want - got)}"
    assert not got - want, f"false positives: {sorted(got - want)}"


def test_port_idioms_are_port_only():
    """The reference's rules do not know the port's idioms: each port
    fixture finding is the port rules' addition, not a shared one."""
    path = os.path.join(PORT_FIXTURES, "trace_safety_torch.py")
    assert _findings(ja, path, deep=False) == set()
    assert _findings(ta, path, deep=False) == _seeded(path)


def test_suppression_comment_forms():
    src = ("import torch\n"
           "class B:\n"
           "    def hybrid_forward(self, F, x):\n"
           "        a = torch.relu(x)\n"
           "        b = torch.relu(x)  # mxlint: disable=MXL001\n"
           "        # mxlint: disable=MXL001\n"
           "        c = torch.relu(x)\n"
           "        return a + b + c\n")
    assert [f.line for f in ta.lint_source(src)] == [4]


def test_deep_noqa_suppression_requires_ids():
    src = ("import threading\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "        self._n = 0\n"
           "    def bump(self):\n"
           "        with self._lock:\n"
           "            self._n += 1\n"
           "    def reset(self):\n"
           "        self._n = 0{noqa}\n")
    for pkg in (ja, ta):
        assert [f.rule for f in pkg.deep_lint_source(
            src.format(noqa=""))] == ["MXL201"]
        assert pkg.deep_lint_source(
            src.format(noqa="  # noqa: MXL201 — reset")) == []
        assert [f.rule for f in pkg.deep_lint_source(
            src.format(noqa="  # noqa"))] == ["MXL201"]


# ---------------------------------------------------------------------------
# the repo gates and the CLI
# ---------------------------------------------------------------------------
def test_port_lints_clean():
    findings = ta.lint_paths([os.path.join(REPO, "mxtpu_torch")])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_port_deep_gate_clean():
    findings = ta.deep_lint_paths([os.path.join(REPO, "mxtpu_torch"),
                                   os.path.join(REPO, "chip_smoke.py")])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_port_knob_registry_lists_every_read_knob():
    """MXL402 reads ``mxtpu_torch/docs/env_var.md`` for the port's files:
    a knob missing from it is flagged, one listed is not."""
    src = ("import os\n"
           "a = os.environ.get('MXTPU_GATEWAY_PORT')\n"
           "b = os.environ.get('MXTPU_NOT_A_KNOB')\n")
    path = os.path.join(REPO, "mxtpu_torch", "serve", "_probe.py")
    found = ta.deep_lint_source(src, path=path)
    assert [(f.rule, f.line) for f in found] == [("MXL402", 3)]


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "mxtpu_torch.tools.mxlint",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=120)


def test_cli_exit_codes_and_sarif(tmp_path):
    ok = _cli("--deep", "--sarif", str(tmp_path / "deep.sarif"),
              "mxtpu_torch/serve/gateway/", "mxtpu_torch/contrib/")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "[deep]" in ok.stdout and "clean" in ok.stdout
    log = json.loads((tmp_path / "deep.sarif").read_text())
    run = log["runs"][0]
    assert log["version"] == "2.1.0" and run["results"] == []
    assert set(ta.DEEP_RULES) <= {r["id"] for r in
                                  run["tool"]["driver"]["rules"]}
    bad = _cli("--sarif", "-", PORT_FIXTURES)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    results = json.loads(bad.stdout)["runs"][0]["results"]
    got = {(os.path.basename(r["locations"][0]["physicalLocation"]
                             ["artifactLocation"]["uri"]),
            r["locations"][0]["physicalLocation"]["region"]["startLine"],
            r["ruleId"]) for r in results}
    want = {(f, line, rule) for f in _py(PORT_FIXTURES)
            for line, rule in _seeded(os.path.join(PORT_FIXTURES, f))}
    assert got == want
    assert _cli("no/such/path").returncode == 2
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    assert all(r in listed.stdout for r in {**ta.RULES, **ta.DEEP_RULES})
