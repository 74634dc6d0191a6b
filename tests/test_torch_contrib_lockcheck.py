"""The port's lock graph and lockcheck (the runtime half of MXL203)
against the reference's: the serve stack's global order gateway →
replica set → engine in both static graphs, the reference's three
lockcheck tests on the port's sanitizer, its static edges read from
``mxtpu_torch/``, and the port's replica-kill chaos test in a fresh
process under ``MXTPU_ANALYSIS_LOCKCHECK=1`` with no violation.
"""
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from mxtpu.contrib import analysis as ja
from mxtpu_torch.contrib import analysis as ta
from mxtpu_torch.contrib.analysis import lockcheck as tlc

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_lock_graph_covers_port_serve_stack():
    g = ta.lock_graph_for([os.path.join(REPO, "mxtpu_torch", "serve")])
    assert {"ServeEngine", "Gateway", "ReplicaSet",
            "ReplicaSupervisor"} <= g.multi_lock_classes
    assert g.aliases.get("ServeEngine._cv") == "ServeEngine._lock"
    edges = set(g.edges)
    assert ("ReplicaSupervisor._lock", "ReplicaSet._lock") in edges
    assert ("ReplicaSet._lock", "ServeEngine._lock") in edges
    assert g.cycle_edges() == []
    ref = ja.lock_graph_for([os.path.join(REPO, "mxtpu", "serve")])
    for e in (("ReplicaSupervisor._lock", "ReplicaSet._lock"),
              ("ReplicaSet._lock", "ServeEngine._lock")):
        assert e in ref.edges


# ---------------------------------------------------------------------------
# lockcheck: the reference's three tests on the port's sanitizer
# ---------------------------------------------------------------------------
@pytest.fixture
def lc():
    tlc.install()
    tlc.reset()
    try:
        yield tlc
    finally:
        tlc.uninstall()
        tlc.reset()
    assert not tlc.installed()


def test_lockcheck_detects_inverted_order(lc):
    class Box:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

    box = Box()
    assert isinstance(box._a, lc.InstrumentedLock)
    assert box._a.name == "Box._a" and box._b.name == "Box._b"

    def fwd():
        with box._a:
            with box._b:
                pass

    def rev():
        with box._b:
            with box._a:
                pass

    for fn in (fwd, rev):
        t = threading.Thread(target=fn)
        t.start()
        t.join(10)
        assert not t.is_alive()
    v = lc.violations(static=False)
    assert len(v) == 1 and "inversion" in v[0], v
    assert "Box._a" in v[0] and "Box._b" in v[0]
    with pytest.raises(AssertionError):
        lc.assert_clean(static=False)


def test_lockcheck_consistent_order_is_clean(lc):
    class Pipe:
        def __init__(self):
            self._outer = threading.Lock()
            self._inner = threading.Lock()

    pipe = Pipe()

    def step():
        with pipe._outer:
            with pipe._inner:
                pass

    for _ in range(2):
        t = threading.Thread(target=step)
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert lc.violations(static=False) == []
    assert ("Pipe._outer", "Pipe._inner") in lc.observed_pairs()
    lc.assert_clean(static=False)


def test_lockcheck_condition_wait_releases_all_levels(lc):
    class Q:
        def __init__(self):
            self._lock = threading.RLock()
            self._cv = threading.Condition(self._lock)

    q = Q()
    assert q._cv._lock is q._lock

    def waiter():
        with q._cv:
            q._cv.wait(timeout=5)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with q._cv:
        q._cv.notify_all()
    t.join(5)
    assert not t.is_alive()
    assert lc.violations(static=False) == []


def test_lockcheck_static_edges_read_the_port_tree():
    edges = tlc._static_edges()
    assert ("ReplicaSet._lock", "ServeEngine._lock") in edges
    assert tlc._static_edges(os.path.join(REPO, "tests")) is None


_PLUGIN = """
import json, os


def pytest_sessionfinish(session, exitstatus):
    from mxtpu_torch.contrib.analysis import lockcheck
    with open(os.environ["LOCKCHECK_REPORT"], "w") as f:
        json.dump({"installed": lockcheck.installed(),
                   "violations": lockcheck.violations(),
                   "pairs": sorted("%s -> %s" % p
                                   for p in lockcheck.observed_pairs())},
                  f)
"""


def test_replica_kill_under_lockcheck_is_clean(tmp_path):
    """The port's replica-kill chaos test in a fresh process with every
    lock instrumented from ``import mxtpu_torch`` on: it passes, and no
    observed order contradicts itself or the port's static graph."""
    (tmp_path / "torch_lockcheck_report.py").write_text(_PLUGIN)
    report = tmp_path / "report.json"
    env = dict(os.environ, MXTPU_ANALYSIS_LOCKCHECK="1",
               LOCKCHECK_REPORT=str(report),
               PYTHONPATH=os.pathsep.join(
                   [str(tmp_path), REPO, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-x", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly",
         "-p", "torch_lockcheck_report",
         "tests/test_torch_serve_chaos.py::"
         "test_replica_kill_poisson_stream_matches_reference"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(report.read_text())
    assert out["installed"]
    assert out["violations"] == []
    assert "ReplicaSet._lock -> ServeEngine._lock" in out["pairs"] or \
        any(p.startswith("ServeEngine._lock") for p in out["pairs"])
