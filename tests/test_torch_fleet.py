"""The port's fleet control plane (``mxtpu_torch.serve.fleet``) on the
CPU: ``tests/test_fleet.py``'s contracts held on the port, with every
stream held to ``llama_refs.reference`` (mxtpu's memoized ``generate``)
for the weights its model and version name.

- named-model routing: two models behind one front door, each response
  the reference stream of the model it named, labelled with model and
  build version, over the direct API and HTTP;
- closed-pool semantics: every mutating surface of a closed
  ``ReplicaSet`` raises ``GatewayClosed``, and the autoscaler absorbs it;
- chip arbitration on a fake clock with injected signals, bounds and
  the min floor respected; the reference's and the port's arbiters and
  training tenants, fed one clock and one signal script, make the same
  decisions and set the same ``fleet_chips_*`` gauges;
- priority classes: the shed order under queue pressure and SLO burn;
- live hot swap by params and by checkpoint path (the port's
  ``save_state``), zero accepted requests dropped, each stream on the
  build its version names;
- session affinity; real pools granted a replica under pressure.

Every engine keeps ``llama_refs``' shape (2 slots, ``max_len`` 32,
buckets from 4) on the CPU, and every wait has a bound.
"""
import gc
import time
from dataclasses import fields

import jax
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu import telemetry as j_telemetry
from mxtpu.serve.fleet import arbiter as j_arbiter
from mxtpu_torch import checkpoint, telemetry
from mxtpu_torch.models import llama as tl
from mxtpu_torch.serve import ServeEngine
from mxtpu_torch.serve.fleet import (ArbiterPolicy, FleetArbiter,
                                     FleetGateway, ModelSpec)
from mxtpu_torch.serve.fleet import arbiter as t_arbiter
from mxtpu_torch.serve.gateway import (Gateway, GatewayClient,
                                       GatewayClosed, GatewayOverloaded,
                                       ReplicaSet)
from mxtpu_torch.serve.gateway.autoscale import (AutoscalePolicy,
                                                 Autoscaler)

torch.set_num_threads(2)   # a CPU share for each xdist worker

SHAPE = dict(max_slots=2, max_len=32, min_bucket=4, device="cpu")
WAIT = 60.0                # every result and polling wait


def _port_cfg(cfg):
    vals = {f.name: getattr(cfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    return tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)


def _to_port(jparams):
    return tl.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, {name: (reference tree, port tree)}):
    "a" is weights seed 0, "b" seed 1."""
    jcfg = llama_refs.serve_config()
    trees = {k: (llama_refs.serve_weights(s),
                 _to_port(llama_refs.serve_weights(s)))
             for k, s in (("a", 0), ("b", 1))}
    return jcfg, _port_cfg(jcfg), trees


# the reference's generate costs about a second a request on the CPU, so
# every test of the file draws on one request shape: PROMPT, NEW tokens
# at TEMP, seeds 0-5 on weights "a" and 100-101 on "b"
PROMPT, NEW, TEMP = [2, 4, 6, 8], 8, 0.9


def _ref(model, which, prompt, mnew, seed=0, temperature=0.0):
    return llama_refs.reference(model[0], model[2][which][0], prompt, mnew,
                                seed=seed, temperature=temperature)


def _fac(model, which):
    """``llama_refs.engine_factory``'s shape over the port's engine; takes
    ``params=`` so a hot swap can hand it new weights."""
    tcfg, tparams = model[1], model[2][which][1]
    return lambda params=tparams: ServeEngine(tcfg, params, **SHAPE)


@pytest.fixture(autouse=True)
def _release_engines():
    yield
    gc.collect()


# ---------------------------------------------------------------------------
# named-model routing
# ---------------------------------------------------------------------------
def test_two_model_routing_matches_reference(model):
    reg = telemetry.registry()
    a0 = reg.value("gateway_requests_total", code="accepted",
                   model="alpha")
    fleet = FleetGateway([ModelSpec("alpha", _fac(model, "a")),
                          ModelSpec("beta", _fac(model, "b"))],
                         supervise=False)
    try:
        prompt = PROMPT
        ha = fleet.submit_dict({"model": "alpha", "prompt": prompt,
                                "max_new_tokens": NEW,
                                "temperature": TEMP, "seed": 0})
        hb = fleet.submit_dict({"model": "beta", "prompt": prompt,
                                "max_new_tokens": NEW,
                                "temperature": TEMP, "seed": 100})
        ta = list(ha.result(timeout=WAIT))
        tb = list(hb.result(timeout=WAIT))
        assert ta == _ref(model, "a", prompt, NEW, seed=0, temperature=TEMP)
        assert tb == _ref(model, "b", prompt, NEW, seed=100,
                          temperature=TEMP)
        assert ta != tb
        assert (ha.model, ha.version) == ("alpha", "v0")
        assert hb.model == "beta"
        port = fleet.start_http(port=0)
        rec = GatewayClient("127.0.0.1", port, timeout=WAIT).generate(
            prompt, NEW, seed=101, temperature=TEMP, model="beta")
        assert rec["status"] == 200, rec
        assert (rec["model"], rec["version"]) == ("beta", "v0")
        assert rec["tokens"] == _ref(model, "b", prompt, NEW, seed=101,
                                     temperature=TEMP)
        with pytest.raises(ValueError, match="missing 'model'"):
            fleet.submit_dict({"prompt": prompt, "max_new_tokens": 2})
        with pytest.raises(ValueError, match="unknown model"):
            fleet.submit_dict({"model": "gamma", "prompt": prompt,
                               "max_new_tokens": 2})
        assert reg.value("gateway_requests_total", code="accepted",
                         model="alpha") - a0 == 1
    finally:
        fleet.close()


def test_closed_pool_raises_gateway_closed_uniformly(model):
    pool = ReplicaSet(_fac(model, "a"), 1, started=False)
    pool.close()
    with pytest.raises(GatewayClosed):
        pool.scale_to(2)
    with pytest.raises(GatewayClosed):
        pool.route(object())
    with pytest.raises(GatewayClosed):
        pool.set_factory(_fac(model, "a"))
    with pytest.raises(GatewayClosed):
        pool.drain_replica(object())
    assert issubclass(GatewayClosed, RuntimeError)
    scaler = Autoscaler(
        pool, AutoscalePolicy(min_replicas=1, max_replicas=4,
                              cooldown_s=0.0, target_p99_ms=10.0),
        latency_p99=lambda: 100.0)
    assert scaler.tick() is None


# ---------------------------------------------------------------------------
# chip arbitration on a fake clock
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


def test_arbiter_moves_chip_from_idle_to_burning():
    reg = telemetry.registry()
    up0 = reg.value("fleet_scale_events_total", model="hotm",
                    direction="up")
    dn0 = reg.value("fleet_scale_events_total", model="coldm",
                    direction="down")
    entries = {"hotm": _FakeEntry(_FakePool(1, lo=1, hi=3)),
               "coldm": _FakeEntry(_FakePool(2, lo=1, hi=3))}
    sig = {"hotm": dict(pressure=4.0, occupancy=1.0, burn=2.5,
                        queued=8.0),
           "coldm": dict(pressure=0.0, occupancy=0.0, burn=0.0,
                         queued=0.0)}
    now = [0.0]
    arb = FleetArbiter(
        entries,
        ArbiterPolicy(interval_s=0.1, cooldown_s=5.0,
                      pressure_high=2.0, burn_high=1.0, idle_s=2.0),
        clock=lambda: now[0],
        signals=lambda n, e: dict(sig[n],
                                  size=float(entries[n].pool.size)))
    assert arb.budget == 3
    assert arb.tick() == []                 # idle, not SUSTAINED idle
    now[0] = 3.0
    assert [(d["model"], d["direction"], d["reason"])
            for d in arb.tick()] == [("coldm", "down", "yield->hotm"),
                                     ("hotm", "up", "hot")]
    assert (entries["coldm"].pool.size, entries["hotm"].pool.size) == \
        (1, 2)
    assert reg.value("fleet_scale_events_total", model="hotm",
                     direction="up") - up0 == 1
    assert reg.value("fleet_scale_events_total", model="coldm",
                     direction="down") - dn0 == 1
    assert reg.value("fleet_chips_in_use", model="hotm") == 2
    assert reg.value("fleet_chips_free") == 0
    now[0] = 4.0
    assert arb.tick() == []                 # cooldown holds
    sig["hotm"].update(pressure=0.0, occupancy=0.0, burn=0.0,
                       queued=0.0)
    now[0] = 9.0
    assert arb.tick() == []
    now[0] = 12.0
    decisions = arb.tick()
    assert len(decisions) == 1 and decisions[0]["reason"] == "idle"
    assert reg.value("fleet_chips_free") == 1
    assert arb.last_decision("hotm")["direction"] in ("up", "down")
    assert arb.describe()["budget"] == 3


def test_arbiter_respects_bounds_and_min_floor():
    entries = {"a": _FakeEntry(_FakePool(1, lo=1, hi=1)),
               "b": _FakeEntry(_FakePool(1, lo=1, hi=3))}
    sig = {"a": dict(pressure=9.0, occupancy=1.0, burn=9.0, queued=9.0),
           "b": dict(pressure=0.0, occupancy=0.0, burn=0.0, queued=0.0)}
    arb = FleetArbiter(
        entries, ArbiterPolicy(cooldown_s=0.0, idle_s=0.0),
        clock=lambda: 100.0,
        signals=lambda n, e: dict(sig[n],
                                  size=float(entries[n].pool.size)))
    assert arb.tick() == []
    assert (entries["a"].pool.size, entries["b"].pool.size) == (1, 1)


# one scripted run: (time, {model: signals}) per tick; "srv" burns,
# then idles; "cold" donates; the tenant is preempted and borrows back
_SCRIPT = [
    (0.0, {"srv": (5.0, 1.0, 2.0, 10.0), "cold": (0.0, 0.0, 0.0, 0.0)}),
    (2.5, {"srv": (5.0, 1.0, 2.0, 10.0), "cold": (0.0, 0.0, 0.0, 0.0)}),
    (3.0, {"srv": (5.0, 1.0, 2.0, 10.0), "cold": (0.0, 0.0, 0.0, 0.0)}),
    (6.0, {"srv": (0.0, 0.0, 0.0, 0.0), "cold": (0.0, 0.0, 0.0, 0.0)}),
    (7.5, {"srv": (0.0, 0.0, 0.0, 0.0), "cold": (0.0, 0.0, 0.0, 0.0)}),
    (9.0, {"srv": (0.0, 0.0, 0.0, 0.0), "cold": (3.0, 0.9, 0.0, 6.0)}),
    (12.0, {"srv": (0.0, 0.0, 0.0, 0.0), "cold": (3.0, 0.9, 0.0, 6.0)}),
    (20.0, {"srv": (0.0, 0.0, 0.0, 0.0), "cold": (0.0, 0.0, 0.0, 0.0)}),
    (30.0, {"srv": (0.0, 0.0, 0.0, 0.0), "cold": (0.0, 0.0, 0.0, 0.0)}),
]


def _run_script(mod, registry, tag):
    """The script through one package's FleetArbiter + TrainingTenant:
    the decision list, the tenant's resize calls and the chip gauges
    after every tick."""
    entries = {f"srv{tag}": _FakeEntry(_FakePool(1, lo=1, hi=3)),
               f"cold{tag}": _FakeEntry(_FakePool(2, lo=1, hi=3))}
    leases = []
    tenant = mod.TrainingTenant(lambda c, r: leases.append((c, r)),
                                chips=2, want=2, min_chips=1,
                                name=f"tt{tag}")
    now = [0.0]
    sig = {}

    def signals(n, e):
        if n not in entries:
            return e.signals()
        p, o, b, q = sig[n[:-len(tag)]]
        return dict(pressure=p, occupancy=o, burn=b, queued=q,
                    size=float(e.pool.size))

    arb = mod.FleetArbiter(
        entries, mod.ArbiterPolicy(interval_s=0.1, cooldown_s=1.0,
                                   pressure_high=2.0, burn_high=1.0,
                                   idle_s=1.0),
        clock=lambda: now[0], signals=signals)
    arb.register(f"tt{tag}", tenant)
    out = []
    for t, s in _SCRIPT:
        now[0] = t
        sig.clear()
        sig.update(s)
        made = [{**d, "model": d["model"][:-len(tag)],
                 "reason": d["reason"].replace(tag, "")}
                for d in arb.tick()]
        gauges = {n[:-len(tag)]: registry.value("fleet_chips_in_use",
                                                model=n)
                  for n in (*entries, f"tt{tag}")}
        out.append((made, gauges, registry.value("fleet_chips_free")))
    return out, leases, arb.describe()["budget"]


def test_arbiter_and_tenant_match_reference():
    port = _run_script(t_arbiter, telemetry.registry(), "_pt")
    ref = _run_script(j_arbiter, j_telemetry.registry(), "_pt")
    assert port == ref
    decisions = [d for made, _, _ in port[0] for d in made]
    assert {d["reason"] for d in decisions} == {
        "preempt->srv", "yield->srv", "yield->tt", "preempt->cold",
        "yield->cold", "hot"}
    assert port[1] == [(1, "arbiter-lend"), (2, "arbiter-borrow")] * 2


# ---------------------------------------------------------------------------
# priority classes: shed ORDER under pressure and burn
# ---------------------------------------------------------------------------
def test_priority_shed_ordering(model):
    reg = telemetry.registry()
    shed0 = {(p, t): reg.value("gateway_shed_total", priority=p, tier=t,
                               model="m")
             for p in ("batch", "offline") for t in ("2", "3")}
    pool = ReplicaSet(_fac(model, "a"), 1, started=False)
    gw = Gateway(backend=pool, model="m", queue_max=8,
                 slo={"ttft_ms": 10.0}, supervise=False)
    try:
        for _ in range(3):
            gw.submit([1, 2, 3], 4)
        with pytest.raises(GatewayOverloaded) as ei:
            gw.submit([1, 2, 3], 4, priority="offline")
        assert (ei.value.tier, ei.value.priority) == (2, "offline")
        gw.submit([1, 2, 3], 4, priority="batch")
        with pytest.raises(GatewayOverloaded) as ei:
            gw.submit([1, 2, 3], 4, priority="batch")
        assert (ei.value.tier, ei.value.priority) == (2, "batch")
        gw.submit([1, 2, 3], 4)
        gw.slo.tick(force=True)
        for _ in range(5):
            gw._m_ttft.observe(5000.0)
        gw.slo.tick(force=True)
        assert gw.slo.breached
        with pytest.raises(GatewayOverloaded, match="shedding batch") \
                as ei:
            gw.submit([1, 2, 3], 4, priority="batch")
        assert ei.value.tier == 3
        gw.submit([1, 2, 3], 4)
        with pytest.raises(ValueError, match="unknown priority"):
            gw.submit([1, 2, 3], 4, priority="p0")
        for (p, t), n in ((("offline", "2"), 1), (("batch", "2"), 1),
                          (("batch", "3"), 1)):
            assert reg.value("gateway_shed_total", priority=p, tier=t,
                             model="m") - shed0[(p, t)] == n
        mix = gw.state()["priority_mix"]
        assert mix["interactive"] == 5 and mix["batch"] == 1
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# live hot swap: zero dropped, each stream on its build
# ---------------------------------------------------------------------------
def test_hot_swap_zero_dropped_matches_reference(model):
    fleet = FleetGateway([ModelSpec("m", _fac(model, "a"), replicas=2,
                                    max_replicas=2)], supervise=False)
    try:
        prompt = PROMPT
        pre = [fleet.submit_dict(
            {"model": "m", "prompt": prompt, "max_new_tokens": NEW,
             "temperature": TEMP, "seed": i}) for i in range(4)]
        out = fleet.hot_swap("m", params=model[2]["b"][1])
        assert out == {"model": "m", "version": "v1",
                       "from_version": "v0", "swapped": 2,
                       "still_draining": []}
        post = [fleet.submit_dict(
            {"model": "m", "prompt": prompt, "max_new_tokens": NEW,
             "temperature": TEMP, "seed": 100 + i}) for i in range(2)]
        for i, h in enumerate(pre):
            toks = list(h.result(timeout=WAIT))
            assert h.version == "v0", (i, h.version)
            assert toks == _ref(model, "a", prompt, NEW, seed=i,
                                temperature=TEMP), i
        for i, h in enumerate(post):
            toks = list(h.result(timeout=WAIT))
            assert h.version == "v1", (i, h.version)
            assert toks == _ref(model, "b", prompt, NEW, seed=100 + i,
                                temperature=TEMP), i
        assert fleet.pool("m").version == "v1"
        assert all(r.version == "v1" for r in fleet.pool("m").replicas())
        assert all(r.engine.build == "v1"
                   for r in fleet.pool("m").replicas())
        assert telemetry.registry().value("fleet_swap_total",
                                          model="m") >= 1
    finally:
        fleet.close()


def test_hot_swap_from_checkpoint_path(model, tmp_path):
    ckpt = str(tmp_path / "swap_ckpt")
    checkpoint.save_state(ckpt, model[2]["b"][1])
    fleet = FleetGateway([ModelSpec("m", _fac(model, "a"))],
                         supervise=False)
    try:
        out = fleet.hot_swap("m", path=ckpt)
        assert out["version"] == "v1"
        h = fleet.submit_dict({"prompt": PROMPT, "max_new_tokens": NEW,
                               "temperature": TEMP, "seed": 100})
        assert list(h.result(timeout=WAIT)) == _ref(
            model, "b", PROMPT, NEW, seed=100, temperature=TEMP)
        # the tree was loaded once, on the pool's device, and every
        # replica of the swap serves that one tree
        eng = fleet.pool("m").replicas()[0].engine
        assert eng.device.type == "cpu"
        fleet._models["m"].spec.engine_factory = \
            lambda: ServeEngine(model[1], model[2]["a"][1], **SHAPE)
        with pytest.raises(ValueError, match="params= keyword"):
            fleet.hot_swap("m", params=model[2]["a"][1])
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# session affinity
# ---------------------------------------------------------------------------
def test_session_affinity_routes_to_warm_replica(model):
    reg = telemetry.registry()
    h0 = reg.value("fleet_session_affinity_total", result="hit")
    m0 = reg.value("fleet_session_affinity_total", result="miss")
    fleet = FleetGateway([ModelSpec("m", _fac(model, "a"), replicas=2,
                                    max_replicas=2)], supervise=False)
    try:
        names = []
        for i in range(3):
            h = fleet.submit_dict({"prompt": PROMPT, "max_new_tokens": NEW,
                                   "temperature": TEMP, "seed": i,
                                   "session_id": "sess-A"})
            assert list(h.result(timeout=WAIT)) == _ref(
                model, "a", PROMPT, NEW, seed=i, temperature=TEMP)
            names.append(h.ticket.replica.name)
        assert len(set(names)) == 1, names
        assert reg.value("fleet_session_affinity_total",
                         result="hit") - h0 == 2
        assert reg.value("fleet_session_affinity_total",
                         result="miss") - m0 == 1
        assert fleet.state()["affinity_sessions"] == 1
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# the arbiter over real pools: a burning pool is granted the idle one's
# chip and the backlog drains on the grown pool
# ---------------------------------------------------------------------------
def test_arbiter_real_pools_grant_under_pressure(model):
    """The pools are built unstarted, so the hot pool's backlog stands
    until the arbiter has granted it the idle pool's chip (no race with
    the backlog draining); then both start and the backlog completes on
    the grown pool."""
    reg = telemetry.registry()
    up0 = reg.value("fleet_scale_events_total", model="hot",
                    direction="up")
    fleet = FleetGateway(
        [ModelSpec("hot", _fac(model, "a"), replicas=1, max_replicas=2),
         ModelSpec("cold", _fac(model, "b"), replicas=2, min_replicas=1,
                   max_replicas=2)],
        arbiter=ArbiterPolicy(chip_budget=3, interval_s=0.05,
                              cooldown_s=0.2, pressure_high=1.5,
                              occupancy_low=0.5, idle_s=0.1),
        supervise=False, started=False)
    try:
        prompt = PROMPT
        hs = [fleet.submit_dict(
            {"model": "hot", "prompt": prompt, "max_new_tokens": NEW,
             "temperature": TEMP, "seed": i}) for i in range(6)]
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            if reg.value("fleet_scale_events_total", model="hot",
                         direction="up") > up0:
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"no grant: {fleet.arbiter.describe()}")
        assert fleet.pool("hot").size == 2
        assert fleet.pool("cold").size == 1
        for name in ("hot", "cold"):
            fleet.pool(name).start()
        for i, h in enumerate(hs):
            assert list(h.result(timeout=WAIT)) == _ref(
                model, "a", prompt, NEW, seed=i, temperature=TEMP), i
        last = fleet.arbiter.last_decision("cold")
        assert last and last["direction"] == "down"
    finally:
        fleet.close()
