"""The port's train→serve flywheel (``mxtpu_torch.serve.fleet.flywheel``)
on the CPU.

- The controller's state machine (``tests/test_flywheel.py``'s full
  cycle: torn pointer, gate veto, torn candidate, canary → clean hold →
  promote, burn breach → rollback, anomaly spike → rollback, a spent
  budget halts) runs in both packages on their fake fleets, one
  scripted clock and one pointer sequence: the same decisions and the
  same ``fleet_candidates_total{result}`` deltas.
- The training tenant: serving preempts it under load, it borrows the
  chip back once serving idles (``tests/test_flywheel.py``'s lending).
- End to end on real tiny pools: the port's train step trains the
  served model, its ``CheckpointManager`` saves and publishes each
  candidate, and the controller canaries, promotes, rolls back on a
  burn breach, rejects a non-finite candidate at the gate and a torn one
  at load; every stream equals ``llama_refs.reference`` on the weights
  its version names.
- Fleet ``/healthz`` causes and ``tools/diagnose.py fleet|flywheel``
  render the port's fleet.

Every engine keeps ``llama_refs``' shape (2 slots, ``max_len`` 32,
buckets from 4) on the CPU, and every wait has a bound.
"""
import gc
import os
import sys
import threading
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu import checkpoint as j_checkpoint
from mxtpu import telemetry as j_telemetry
from mxtpu.serve.fleet import FlywheelController as JFlywheelController
from mxtpu_torch import checkpoint, telemetry
from mxtpu_torch.checkpoint import CheckpointManager
from mxtpu_torch.models import llama as tl
from mxtpu_torch.parallel import optim, step as pstep
from mxtpu_torch.serve import ServeEngine
from mxtpu_torch.serve.fleet import (ArbiterPolicy, FleetArbiter,
                                     FleetGateway, FlywheelController,
                                     ModelSpec, TrainingTenant)

torch.set_num_threads(2)   # a CPU share for each xdist worker

SHAPE = dict(max_slots=2, max_len=32, min_bucket=4, device="cpu")
WAIT = 60.0                # every result wait


def _port_cfg(cfg):
    vals = {f.name: getattr(cfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    return tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)


def _join(fn):
    """Run ``fn`` on a thread and join it with a bound."""
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(WAIT)
    assert not t.is_alive(), f"{fn} did not finish in {WAIT} s"


@pytest.fixture(autouse=True)
def _release_engines():
    yield
    gc.collect()


# ---------------------------------------------------------------------------
# the state machine, in both packages, on one script
# ---------------------------------------------------------------------------
class _FakeGw:
    """version_ttft over the package's REAL histograms, so the burn
    split is its SLOTracker's math, not a stub."""

    def __init__(self, tel, model):
        self.tel, self.model = tel, model

    def version_ttft(self, version):
        return self.tel.histogram(
            "gateway_ttft_ms",
            "Time to first token, submission to first on_token",
            model=self.model, version=version)


class _FakeFleet:
    def __init__(self, tel, model, replicas=2):
        self.calls = []
        self.version = "v0"
        self._pending = None
        self._n = 0
        self._replicas = replicas
        self._gw = _FakeGw(tel, model)

    def _entry(self, model):
        class _E:
            class spec:
                slo = None
        return _E()

    def attach_flywheel(self, model, controller):
        self.fly = controller

    def gateway(self, model):
        return self._gw

    def canary_swap(self, model, *, params, fraction, drain_timeout_s):
        self._n += 1
        self._pending = f"v{self._n}"
        self.calls.append(("canary", self._pending, params))
        n = max(1, int(round(fraction * self._replicas)))
        return {"model": model, "version": self._pending,
                "from_version": self.version, "canaries": n,
                "of": self._replicas, "swapped": n, "still_draining": []}

    def promote(self, model, *, drain_timeout_s):
        self.calls.append(("promote", self._pending))
        self.version = self._pending
        return {"model": model, "version": self.version, "swapped": 1,
                "still_draining": []}

    def rollback(self, model, *, reason, drain_timeout_s):
        self.calls.append(("rollback", reason))
        return {"model": model, "version": self.version,
                "from_version": self._pending, "reason": reason,
                "swapped": 1, "still_draining": []}


_RESULTS = ("canaried", "promoted", "rolled_back", "rejected_torn",
            "rejected_gate", "torn_pointer")


def _full_cycle(ckpt, tel, controller_cls, d, model):
    """``tests/test_flywheel.py``'s full cycle through one package:
    (every tick's decisions without times and error texts, the fleet's
    calls, the counter deltas, the controller's final description)."""
    reg = tel.registry()
    c0 = {r: reg.value("fleet_candidates_total", model=model, result=r)
          for r in _RESULTS}
    now = [0.0]

    def loader(ptr):
        if ptr["step"] == 4:
            raise IOError("chaos: torn candidate")
        return {"weights": ptr["step"]}

    fleet = _FakeFleet(tel, model)
    fly = controller_cls(
        fleet, model, d, load_candidate=loader,
        eval_gate=lambda ptr, cand: ptr["step"] != 2,
        canary_fraction=0.5, hold_ticks=2, burn_high=1.0,
        max_rollbacks=2, anomaly_budget=1, poll_s=0.01,
        slo={"ttft_ms": 10.0}, clock=lambda: now[0])
    assert fleet.fly is fly
    ticks = []

    def tick(dt=0.0):
        now[0] += dt
        ticks.append([{k: v for k, v in rec.items()
                       if k not in ("t", "error")} for rec in fly.tick()])

    tick()                                     # nothing published
    with open(ckpt.published_path(d), "wb") as f:
        f.write(b"torn by chaos")
    tick()                                     # torn pointer
    ckpt.publish_pointer(d, 2, seq=1)
    tick()                                     # gate veto
    tick()                                     # same seq: nothing
    ckpt.publish_pointer(d, 4, seq=2)
    tick()                                     # torn candidate
    ckpt.publish_pointer(d, 6, seq=3)
    tick()                                     # canary
    tick(1.0)                                  # clean 1 of 2
    tick(1.0)                                  # promote
    ckpt.publish_pointer(d, 8, seq=4)
    tick()                                     # canary
    for _ in range(5):
        fleet._gw.version_ttft("v2").observe(5000.0)
    tick(1.0)                                  # burn: rollback
    ckpt.publish_pointer(d, 10, seq=5)
    tick()                                     # canary
    tel.counter("step_anomalies_total",
                "Steps beyond median + k*MAD of the program's rolling "
                "window", program=model).inc(2)
    tick(1.0)                                  # anomaly: rollback, halt
    ckpt.publish_pointer(d, 12, seq=6)
    tick()                                     # halted: ignored
    deltas = {r: reg.value("fleet_candidates_total", model=model,
                           result=r) - c0[r] for r in _RESULTS}
    desc = fly.describe()
    desc = {k: v for k, v in desc.items()
            if k not in ("directory", "history")}
    return ticks, fleet.calls, deltas, desc


def test_flywheel_state_machine_matches_reference(tmp_path):
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "ref")
    port = _full_cycle(checkpoint, telemetry, FlywheelController,
                       str(tmp_path / "port"), "fwsm_pt")
    ref = _full_cycle(j_checkpoint, j_telemetry, JFlywheelController,
                      str(tmp_path / "ref"), "fwsm_pt")
    assert port == ref
    ticks, calls, deltas, desc = port
    assert [a["action"] for t in ticks for a in t] == [
        "candidate_rejected", "candidate_rejected", "canary", "promote",
        "canary", "rollback", "canary", "rollback"]
    assert [c[:2] for c in calls] == [
        ("canary", "v1"), ("promote", "v1"), ("canary", "v2"),
        ("rollback", "slo_burn"), ("canary", "v3"), ("rollback", "anomaly")]
    assert deltas == {"canaried": 3, "promoted": 1, "rolled_back": 2,
                      "rejected_torn": 1, "rejected_gate": 1,
                      "torn_pointer": 1}
    assert desc["halted"] and desc["rollbacks"] == 2
    assert desc["seen_seq"] == 5


# ---------------------------------------------------------------------------
# chip lending: the TrainingTenant under fake-clock arbitration
# ---------------------------------------------------------------------------
class _FakePool:
    def __init__(self, size, lo=1, hi=4):
        self.size = size
        self.min_replicas = lo
        self.max_replicas = hi
        self.chips_per_replica = 1

    def scale_to(self, n):
        self.size = n
        return n


class _FakeEntry:
    def __init__(self, pool):
        self.pool = pool
        self.gateway = None


def test_training_tenant_preempt_and_borrow():
    reg = telemetry.registry()
    lend0 = reg.value("fleet_chip_lends_total", tenant="tt",
                      direction="lend")
    bor0 = reg.value("fleet_chip_lends_total", tenant="tt",
                     direction="borrow")
    entries = {"srv": _FakeEntry(_FakePool(1, lo=1, hi=2))}
    leases = []
    tenant = TrainingTenant(lambda chips, reason: leases.append(
        (chips, reason)), chips=2, want=2, min_chips=1, name="tt")
    sig = {"srv": dict(pressure=5.0, occupancy=1.0, burn=2.0,
                       queued=10.0)}
    now = [0.0]
    arb = FleetArbiter(
        entries,
        ArbiterPolicy(interval_s=0.1, cooldown_s=1.0, pressure_high=2.0,
                      burn_high=1.0, idle_s=1.0),
        clock=lambda: now[0],
        signals=lambda n, e: (dict(sig[n],
                                   size=float(entries[n].pool.size))
                              if n in sig else e.signals()))
    assert arb.budget == 1
    arb.register("tt", tenant)
    assert arb.budget == 3
    with pytest.raises(ValueError, match="already has a tenant"):
        arb.register("tt", tenant)
    assert [(d["model"], d["direction"], d["reason"])
            for d in arb.tick()] == [("tt", "down", "preempt->srv"),
                                     ("srv", "up", "hot")]
    assert leases == [(1, "arbiter-lend")]
    assert entries["srv"].pool.size == 2 and tenant.size == 1
    assert reg.value("fleet_chip_lends_total", tenant="tt",
                     direction="lend") - lend0 == 1
    assert reg.value("fleet_chips_in_use", model="srv") == 2
    assert reg.value("fleet_chips_in_use", model="tt") == 1
    assert reg.value("fleet_chips_free") == 0
    sig["srv"].update(pressure=0.0, occupancy=0.0, burn=0.0, queued=0.0)
    now[0] = 5.0
    assert arb.tick() == []
    now[0] = 6.5
    assert [(d["model"], d["direction"], d["reason"])
            for d in arb.tick()] == [("srv", "down", "yield->tt"),
                                     ("tt", "up", "hot")]
    assert leases[-1] == (2, "arbiter-borrow") and tenant.size == 2
    assert reg.value("fleet_chip_lends_total", tenant="tt",
                     direction="borrow") - bor0 == 1
    now[0] = 20.0
    assert arb.tick() == []
    now[0] = 30.0
    assert arb.tick() == []
    assert (entries["srv"].pool.size, tenant.size) == (1, 2)


# ---------------------------------------------------------------------------
# end to end on real tiny pools, candidates from the port's trainer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    jcfg = llama_refs.serve_config()
    jparams = llama_refs.serve_weights(0)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, _port_cfg(jcfg), jparams, tparams


def _as_reference(tree):
    """A port tree as the reference's jax tree (for its ``generate``)."""
    return jax.tree.map(jnp.asarray, tl.params_to_numpy(tree))


def test_flywheel_train_publish_canary_promote_rollback(model, tmp_path):
    jcfg, tcfg, jparams, tparams = model
    reg = telemetry.registry()
    c0 = {r: reg.value("fleet_candidates_total", model="fw", result=r)
          for r in _RESULTS}
    rb0 = reg.value("fleet_rollback_total", model="fw", reason="slo_burn")
    d = str(tmp_path / "ckpt")
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int64))}
    held = {"tokens": torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int64))}
    loss = tl.loss_fn(tcfg)
    evaluate = pstep.make_eval_step(loss)

    # the trainer: 3 adamw steps, each saved (async) and 2, 3 published
    mgr = CheckpointManager(d, max_to_keep=2, async_save=True)
    tx = optim.adamw(1e-2)
    state = pstep.init_state(tparams, tx)
    train = pstep.make_train_step(loss, tx)
    mgr.save(0, state.params)
    for i in range(1, 4):
        state, _ = train(state, batch)
        mgr.save(i, state.params)
    _join(mgr.wait_until_finished)
    assert mgr.all_steps() == [2, 3]

    def gate(ptr, cand):
        return bool(torch.isfinite(evaluate(cand, held)))

    now = [0.0]
    fleet = FleetGateway(
        [ModelSpec("fw", lambda params=tparams: ServeEngine(
            tcfg, params, **SHAPE), replicas=2, max_replicas=2,
            slo={"ttft_ms": 30000.0})], supervise=False)
    builds = {"v0": jparams}
    try:
        fly = FlywheelController(
            fleet, "fw", d,
            load_candidate=lambda ptr: mgr.restore(int(ptr["step"]),
                                                   device="cpu"),
            eval_gate=gate, canary_fraction=0.5, hold_ticks=2,
            burn_high=1.0, max_rollbacks=2, anomaly_budget=10_000,
            clock=lambda: now[0])
        prompt = [2, 4, 6, 8]
        handles = []

        def traffic(seed):
            handles.append((seed, fleet.submit_dict(
                {"prompt": prompt, "max_new_tokens": 4,
                 "temperature": 0.9, "seed": seed})))

        traffic(0)
        mgr.publish(2, loss=0.0)
        assert [r["action"] for r in fly.tick()] == ["canary"]
        builds["v1"] = _as_reference(mgr.restore(2, device="cpu"))
        assert sorted(r.version for r in fleet.pool("fw").replicas()) \
            == ["v0", "v1"]
        traffic(10)
        now[0] += 1.0
        assert fly.tick() == []
        now[0] += 1.0
        assert [r["action"] for r in fly.tick()] == ["promote"]
        assert fleet.pool("fw").version == "v1"
        assert all(r.version == "v1" for r in fleet.pool("fw").replicas())

        # a candidate that passes the gate but burns: rolled back to v1
        mgr.publish(3)
        assert [r["action"] for r in fly.tick()] == ["canary"]
        builds["v2"] = _as_reference(mgr.restore(3, device="cpu"))
        for _ in range(5):
            fleet.gateway("fw").version_ttft("v2").observe(60000.0)
        now[0] += 1.0
        rec = fly.tick()
        assert [(r["action"], r["reason"]) for r in rec] == \
            [("rollback", "slo_burn")]
        assert fleet.pool("fw").version == "v1"
        assert reg.value("fleet_rollback_total", model="fw",
                         reason="slo_burn") - rb0 == 1
        traffic(20)

        # a planted non-finite candidate: rejected at the gate, and a
        # torn one at load; the pool is not touched
        bad = {k: v for k, v in state.params.items()}
        bad["final_norm"] = torch.full_like(bad["final_norm"],
                                            float("nan"))
        mgr.save(4, bad)
        mgr.publish(4)
        assert [r["reason"] for r in fly.tick()] == ["gate"]
        mgr.save(5, state.params)
        _join(mgr.wait_until_finished)
        leaf = os.path.join(mgr.step_path(5), "leaf_0.bin")
        with open(leaf, "r+b") as f:
            f.truncate(8)
        mgr.publish(5)
        assert [r["reason"] for r in fly.tick()] == ["torn"]
        assert fleet.pool("fw").version == "v1"
        assert all(r.version == "v1" for r in fleet.pool("fw").replicas())
        traffic(30)

        for seed, h in handles:
            toks = list(h.result(timeout=WAIT))
            assert h.reason == "complete", (seed, h.reason)
            assert toks == llama_refs.reference(
                jcfg, builds[h.version], prompt, 4, seed=seed,
                temperature=0.9), (seed, h.version)
        assert {h.version for _, h in handles} >= {"v0", "v1"}
        deltas = {r: reg.value("fleet_candidates_total", model="fw",
                               result=r) - c0[r] for r in _RESULTS}
        assert deltas == {"canaried": 2, "promoted": 1, "rolled_back": 1,
                          "rejected_torn": 1, "rejected_gate": 1,
                          "torn_pointer": 0}
        assert not fly.halted
    finally:
        fleet.close()
        _join(mgr.close)


# ---------------------------------------------------------------------------
# surfaces: /healthz causes + diagnose fleet|flywheel
# ---------------------------------------------------------------------------
def test_health_causes_and_diagnose_surfaces(model, tmp_path, capsys):
    _, tcfg, _, tparams = model
    fleet = FleetGateway(
        [ModelSpec("m", lambda params=tparams: ServeEngine(
            tcfg, params, **SHAPE), slo={"ttft_ms": 10.0})],
        supervise=False)
    try:
        fly = FlywheelController(
            fleet, "m", str(tmp_path), load_candidate=lambda ptr: tparams,
            canary_fraction=0.5, hold_ticks=2, poll_s=0.5,
            slo={"ttft_ms": 10.0})
        h = fleet.health()
        assert h["status"] == "ok" and h["degraded"] == []
        assert h["models"]["m"]["causes"] == []
        gw = fleet.gateway("m")
        gw.slo.tick(force=True)
        for _ in range(5):
            gw._m_ttft.observe(5000.0)
        gw.slo.tick(force=True)
        h = fleet.health()
        assert h["status"] == "degraded" and h["degraded"] == ["m"]
        assert "slo_burn" in h["models"]["m"]["causes"]
        fly.halted = True
        fly._note("halt", rollbacks=2, budget=2)
        assert "flywheel_halted" in fleet.health()["models"]["m"]["causes"]
        st = fleet.state()
        assert st["flywheel"]["m"]["halted"]
        assert st["models"]["m"]["canary"] is None
        port = fleet.start_http(port=0)
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools"))
        import diagnose
        assert diagnose.fleet_state(f"127.0.0.1:{port}")
        out = capsys.readouterr().out
        assert "degraded: m" in out
        assert "slo_burn" in out and "flywheel_halted" in out
        assert diagnose.flywheel_state(f"127.0.0.1:{port}")
        out = capsys.readouterr().out
        assert "phase=idle HALTED" in out and "halt:" in out
    finally:
        fleet.close()
