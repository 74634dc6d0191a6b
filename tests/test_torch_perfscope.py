"""mxtpu_torch.telemetry.perfscope and the build watcher against
mxtpu.telemetry's, and wired into the port's train step and serve engine.

Contracts:
- the live gauges are host arithmetic copied from the reference: the
  same ``register_cost`` and ``on_call`` gaps (steady, a planted slow
  step, an idle gap) into both ``PerfScope``s, the cpu spec pinned,
  give the same MFU, MBU, goodput and anomaly series (exact, but for
  the reference's mesh-size factor in the MFU/MBU denominators: the
  port runs a program on one device); the HBM ledger keeps the same
  breakdown, last write wins, and the headroom knob leaves one record;
- a program's cost is counted on the call that builds its variant:
  FLOPs by ``torch.utils.flop_counter``'s formulas (a 512³ product is
  exactly 2·512³), bytes as operand plus result bytes (``a + b`` at
  256² is exactly 3·256²·4), and a hand-written kernel's plain version
  counts as the kernel does, so the tiny Llama train step's count
  equals ``llama.train_step_flops`` (exact);
- the watcher attributes each build to its signature, counts builds
  beyond ``expected`` in ``recompile_total`` and refuses a program it
  cannot see;
- watching changes no result: the train step's params and the serve
  engines' streams and banks are bit-equal with telemetry off, and the
  engines keep ``compile_count`` within the reference's bounds;
- ``tools/diagnose.py perf`` renders a port scrape.
"""
import threading
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from mxtpu import telemetry as rt
from mxtpu.telemetry import perfscope as rps

from mxtpu_torch import telemetry as pt
from mxtpu_torch.models import llama as tl
from mxtpu_torch.ops import attention as A, conv
from mxtpu_torch.parallel import optim, step as pstep
from mxtpu_torch.serve import Request, ServeEngine
from mxtpu_torch.serve.engine import _release_ledger
from mxtpu_torch.telemetry import perfscope as ps, watcher

torch.set_num_threads(2)

SHAPE = dict(max_slots=2, max_len=32, min_bucket=4, device="cpu")


@pytest.fixture(autouse=True)
def _telemetry_on():
    rt.enable(True)
    pt.enable(True)
    yield
    rt.enable(True)
    pt.enable(True)


def _tiny(**kw):
    """The tiny Llama of ``tests/llama_refs.py`` in f32, with flash
    attention on its plain CPU path."""
    return replace(tl.CONFIGS["tiny"], dtype=torch.float32,
                   param_dtype=torch.float32, attn_impl="flash", **kw)


# ---------------------------------------------------------------------------
# the live gauges: host arithmetic, against the reference
# ---------------------------------------------------------------------------
def _gap_sequence(seed):
    """(t_start, t_end) dispatches: 12 steady steps near 10 ms, a 0.5 s
    stall, 6 steady steps, a 5 s idle gap, 4 steady steps; from seed 2,
    60 log-normal gaps around 10 ms (heavy tails trip the detector
    often; the window of 16 turns over)."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    gaps = (list(rng.uniform(0.009, 0.011, 12)) + [0.5] + list(
        rng.uniform(0.009, 0.011, 6)) + [5.0] + list(
        rng.uniform(0.009, 0.011, 4)) if seed < 2
        else list(rng.lognormal(np.log(0.01), 0.8, 60)))
    for gap in gaps:
        t += float(gap)
        out.append((t - 0.001, t))
    return out


def _series(tm, mod, name, loop, seed):
    sc = mod.PerfScope(window=16, anomaly_k=4.0, min_samples=4, idle_s=2.0,
                       spec=mod.spec_for("cpu"))
    sc.set_loop(name, loop)
    sc.register_cost(mod.ProgramCost(name=name, flops=3e9,
                                     bytes_accessed=2e8,
                                     spec=mod.spec_for("cpu")))
    reg, out = tm.registry(), []
    for t0, t1 in _gap_sequence(seed):
        sc.on_call(name, t0, t1)
        out.append((reg.value("mfu", program=name),
                    reg.value("hbm_bw_util", program=name),
                    reg.value("goodput_ratio", loop=loop),
                    reg.value("step_anomalies_total", program=name),
                    len(sc._windows[name].gaps)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_live_gauges_equal_reference(seed):
    """Same costs, same gaps, cpu spec pinned: the port's MFU/MBU equal
    the reference's times its mesh size (``jax.device_count()`` in the
    reference's denominator, 1 in the port's), goodput, anomaly counts
    and the idle reset are equal (rel 1e-12 on the ratios, exact on the
    counts)."""
    name, loop = f"tp_gauges_{seed}", f"tp_loop_{seed}"
    port = _series(pt, ps, name, loop, seed)
    ref = _series(rt, rps, name, loop, seed)
    n_dev = jax.device_count()
    assert len(port) == len(ref)
    for (pm, pb, pg, pa, pn), (rm, rb, rg, ra, rn) in zip(port, ref):
        assert pm == pytest.approx(rm * n_dev, rel=1e-12, abs=0)
        assert pb == pytest.approx(rb * n_dev, rel=1e-12, abs=0)
        assert pg == pytest.approx(rg, rel=1e-12, abs=0)
        assert (pa, pn) == (ra, rn)
    if seed >= 2:
        assert port[-1][3] > 0       # the tails tripped the detector
        return
    assert port[-1][3] == 1          # the stall, once; the idle gap, never
    assert port[-1][4] == 4          # the window restarted after idling
    sp = ps.spec_for("cpu")
    gaps = [b - a for (_, a), (_, b) in zip(_gap_sequence(seed)[:12],
                                            _gap_sequence(seed)[1:12])]
    assert port[11][0] == pytest.approx(
        ps.mfu(3e9, sum(gaps) / len(gaps), peak_flops=sp.peak_flops),
        rel=1e-9)


def test_helpers_and_device_table():
    """The ratio helpers are exact; the table holds the card and the
    cpu row, no TPU; an unknown device raises unless both peak
    overrides name its numbers."""
    assert ps.mfu(1e12, 0.01, peak_flops=1e15) == pytest.approx(0.1)
    assert ps.hbm_bw_util(8e9, 0.01, peak_bw=8e12) == pytest.approx(0.1)
    assert ps.mfu(1e12, 0.0, peak_flops=1e15) == 0.0
    h100 = ps.spec_for("NVIDIA H100 80GB HBM3")
    assert (h100.peak_flops, h100.peak_bw, h100.hbm_bytes) == \
        (989e12, 3.35e12, 80e9)
    cpu = ps.spec_for("cpu")
    assert (cpu.peak_flops, cpu.peak_bw) == (rps.spec_for("cpu").peak_flops,
                                             rps.spec_for("cpu").peak_bw)
    assert ps.device_spec() == cpu        # no card visible here
    for kind in ("TPU v5e", "TPU v5p", "v6e", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError, match="PEAK_FLOPS"):
            ps.spec_for(kind)
    assert ps.bound_ms(989e9, 1.0, h100) == (pytest.approx(1.0),
                                            "operations")
    assert ps.bound_ms(1.0, 3.35e9, h100) == (pytest.approx(1.0), "bytes")


def test_unknown_card_takes_both_overrides(monkeypatch):
    monkeypatch.setattr(ps, "_PEAK_FLOPS", 123e12)
    with pytest.raises(ValueError):
        ps.spec_for("martian silicon")
    monkeypatch.setattr(ps, "_PEAK_BW", 2e12)
    sp = ps.spec_for("martian silicon")
    assert (sp.peak_flops, sp.peak_bw) == (123e12, 2e12)
    assert ps.spec_for("cpu").peak_flops == 123e12   # overrides win


def test_hbm_ledger_breakdown_headroom_equal_reference():
    """Same accounting into both ledgers: same breakdown, last write
    wins, release; the headroom knob leaves exactly one flight record
    with the per-category bytes."""
    out = []
    for tm, mod in ((pt, ps), (rt, rps)):
        led = mod.HBMLedger()
        led.account("params", 1000, name="train")
        led.account("optimizer", 2000, name="train")
        led.account("params", 500, name="train")
        led.account("params", 300, name="engine0")
        first = (led.breakdown(), led.total())
        led.release("optimizer", name="train")
        out.append((first, led.breakdown(), led.total()))
        assert led.headroom() == led.capacity() - 800
    assert out[0] == out[1] == (({"params": 800, "optimizer": 2000}, 2800),
                                {"params": 800}, 800)
    cap = ps.HBMLedger().capacity()
    led = ps.HBMLedger(headroom_bytes=cap - 100)
    n0 = len([r for r in pt.flight().tail(200)
              if r.get("name") == "hbm_headroom_low"])
    led.account("workspace", 200, name="tp_headroom")
    led.account("workspace", 300, name="tp_headroom")   # still low
    recs = [r for r in pt.flight().tail(200)
            if r.get("name") == "hbm_headroom_low"]
    assert len(recs) == n0 + 1
    assert recs[-1]["bytes_workspace"] == 200
    assert recs[-1]["threshold_bytes"] == int(cap - 100)


def test_kv_byte_helpers_equal_reference():
    assert ps.kv_slot_bank_bytes(4, 2, 8, 16, 32, 2) == \
        rps.kv_slot_bank_bytes(4, 2, 8, 16, 32, 2)
    assert ps.kv_live_bytes(4, 2, 8, [5, 0, 7], 2) == \
        rps.kv_live_bytes(4, 2, 8, [5, 0, 7], 2)
    tree = {"a": torch.zeros(3, 4), "b": (torch.zeros(5, dtype=torch.int8),
                                          {"c": torch.zeros(2, 2, 2)})}
    assert ps.tree_bytes(tree) == 48 + 5 + 32


# ---------------------------------------------------------------------------
# counting a call
# ---------------------------------------------------------------------------
def test_watched_matmul_and_add_costs():
    """A watched 512³ f32 product has exactly 2·512³ FLOPs and is
    compute bound at the cpu knee; ``a + b`` at 256² is memory bound
    with exactly 3·256²·4 bytes; ``program_costs`` of a 128³ product
    counts 2·128³."""
    rng = np.random.default_rng(0)
    n = 512
    f = pt.watch(watcher.Program(lambda a, b: a @ b, "tp_matmul"),
                 "tp_matmul")
    x = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    f(x, x)
    cost = ps.catalog()["tp_matmul"]
    assert cost.flops == 2 * n ** 3
    assert cost.bytes_accessed == 3 * n * n * 4
    assert cost.klass == "compute_bound"
    reg = pt.registry()
    assert reg.value("program_flops", program="tp_matmul") == 2 * n ** 3
    assert reg.value("program_roofline", program="tp_matmul",
                     **{"class": "compute_bound"}) == 1.0
    g = pt.watch(watcher.Program(lambda a, b: a + b, "tp_add"), "tp_add")
    y = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32))
    g(y, y)
    add = ps.catalog()["tp_add"]
    assert (add.flops, add.bytes_accessed) == (0, 3 * 256 * 256 * 4)
    assert add.klass == "memory_bound"
    z = torch.ones(128, 128)
    costs = ps.program_costs(lambda a, b: a @ b, (z, z), name="tp_aot",
                             spec=ps.spec_for("cpu"))
    assert costs["flops"] == 2 * 128 ** 3
    assert costs["argument_bytes"] == 2 * 128 * 128 * 4
    assert "peak_hbm_bytes" not in costs          # no card: not read
    assert "tp_aot" in ps.catalog()
    assert ps.profile_program(lambda a: a @ a, "tp_prof", (z,)).flops == \
        2 * 128 ** 3


@pytest.mark.parametrize("causal", [False, True])
def test_kernels_report_their_own_cost_on_the_plain_path(causal):
    """Under a count, ``flash_attention``, ``conv3x3`` and the backward
    on their CPU tensors count what the kernels report, not the plain
    versions' own ops: the forward (with the lse it writes for
    training), and under grad the dQ and dK/dV pair."""
    rng = np.random.default_rng(1)
    b, hq, hkv, sq, d = 1, 4, 2, 24, 16
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, sq, d))
                                .astype(np.float32)) for h in (hq, hkv, hkv))
    dims = (b, hq, hkv, sq, sq, d, causal)
    with ps.CostCount() as c:
        A.flash_attention(q, k, v, causal=causal)
    assert (c.flops, c.bytes) == A.attention_cost(*dims)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    do = torch.from_numpy(rng.normal(size=(b, hq, sq, d)).astype(np.float32))
    with ps.CostCount() as c:
        o = A.flash_attention(qg, kg, vg, causal=causal, kv_block=8)
    assert (c.flops, c.bytes) == A.attention_cost(*dims, lse=True)
    with ps.CostCount() as c:
        grads = torch.autograd.grad(o, (qg, kg, vg), do)
    pair = [A.bwd_cost(*dims, *A.BWD_WORK[w]) for w in ("dq", "dkv")]
    assert (c.flops, c.bytes) == (pair[0][0] + pair[1][0],
                                  pair[0][1] + pair[1][1])
    # the counted path's grads are autograd's through the plain version
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(
        A.blockwise_attention(qp, kp, vp, causal=causal, kv_block=8),
        (qp, kp, vp), do)
    for a, w in zip(grads, want):
        assert torch.equal(a, w)
    x = torch.from_numpy(rng.normal(size=(2, 5, 7, 8))).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(3, 3, 8, 16))).to(torch.bfloat16)
    with ps.CostCount() as c:
        conv.conv3x3(x, w)
    assert (c.flops, c.bytes) == conv.conv_cost(2, 5, 7, 8, 16)


# ---------------------------------------------------------------------------
# the build watcher
# ---------------------------------------------------------------------------
def test_watcher_attributes_builds_and_counts_rebuilds():
    """A second shape is a second build with its key in the flight
    recorder; beyond ``expected`` it raises ``recompile_total``; every
    build observes ``program_build_total``; a program without
    ``_cache_size`` is refused."""
    pt.install_compile_listener()
    reg = pt.registry()
    builds = reg.value("program_build_total")
    f = pt.watch(watcher.Program(
        lambda x: x * 2, "tp_bust",
        key=lambda *a, **k: watcher.describe_args(a, k)), "tp_bust",
        expected=1)
    f(torch.ones(4))
    f(torch.ones(4))                        # the same variant
    assert reg.value("compile_events_total", fn="tp_bust") == 1
    assert reg.value("recompile_total", fn="tp_bust") == 0
    f(torch.ones(5))
    assert reg.value("compile_events_total", fn="tp_bust") == 2
    assert reg.value("recompile_total", fn="tp_bust") == 1
    assert f.compiles == ["(float32[4]@cpu)", "(float32[5]@cpu)"]
    rec = [r for r in pt.flight().tail(50) if r.get("kind") == "recompile"
           and r.get("name") == "tp_bust"]
    assert rec and rec[-1]["key"] == "(float32[5]@cpu)"
    assert reg.value("program_build_total") - builds == 2
    assert f._cache_size() == 2            # delegated to the program
    with pytest.raises(TypeError, match="_cache_size"):
        pt.watch(lambda x: x, "tp_refused")
    assert watcher.describe_args((np.zeros((2, 3), np.int32),), {}) == \
        "(int32[2, 3])"


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _train(cfg, steps, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = tl.init_params(cfg, gen, device="cpu")
    tx = optim.adamw(1e-2)
    state = pstep.init_state(params, tx)
    step = pstep.make_train_step(tl.loss_fn(cfg), tx)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    for _ in range(steps):
        state, loss = step(state, {"tokens": tokens})
    return state, params, tx


@pytest.mark.parametrize("kw", [{"remat": False},
                                {"remat": True},
                                {"remat": True,
                                 "remat_policy": "dots_no_batch"},
                                {"remat": True, "ce_chunk": 64}],
                         ids=["plain", "remat", "dots_no_batch", "chunked"])
def test_train_step_counted_equals_analytic_and_changes_nothing(kw):
    """The tiny Llama's watched train step: ``program_flops`` equals
    ``llama.train_step_flops`` exactly (products by flop_counter, the
    attention kernels' own counts on the plain path); one dispatch
    span a step; one build over the steps; params and optimizer state
    in the ledger at their exact bytes; and the trajectory is bit-equal
    to the same steps with telemetry off."""
    cfg = _tiny(**kw)
    reg = pt.registry()
    spans = reg.get("span_train_dispatch_ms")
    n_spans = spans.count if spans is not None else 0
    builds = reg.value("compile_events_total", fn="train_step")
    state, params, tx = _train(cfg, 3)
    assert reg.get("span_train_dispatch_ms").count - n_spans == 3
    assert reg.value("compile_events_total", fn="train_step") - builds == 1
    assert reg.value("program_flops", program="train_step") == \
        tl.train_step_flops(cfg, 2, 16)
    assert ps.catalog()["train_step"].bytes_accessed > ps.tree_bytes(params)
    entries = ps.ledger()._entries
    assert entries[("params", "train")] == ps.tree_bytes(state.params)
    assert entries[("optimizer", "train")] == ps.tree_bytes(state.opt_state)
    assert entries[("params", "train")] == sum(
        p.numel() * 4 for p in [*params["layers"].values(),
                                *(v for k, v in params.items()
                                  if k != "layers")])
    pt.enable(False)
    try:
        quiet, _, _ = _train(cfg, 3)
    finally:
        pt.enable(True)
    for a, b in zip(torch.utils._pytree.tree_leaves(state.params),
                    torch.utils._pytree.tree_leaves(quiet.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------
def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.choice([3, 5, 9, 12]))),
                    max_new_tokens=int(rng.choice([2, 4, 6])), seed=i,
                    temperature=0.8 if i % 2 else 0.0) for i in range(6)]


def _serve(cfg, params, **kw):
    eng = ServeEngine(cfg, params, **SHAPE, **kw)
    for r in _requests(cfg):
        eng.submit(r)
    return eng, eng.run()


@pytest.fixture(scope="module")
def served():
    cfg = _tiny(remat=False)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


@pytest.mark.parametrize("kw, extra", [
    ({}, 1), ({"paged": True, "page_size": 8}, 2),
    ({"paged": True, "page_size": 8, "speculate_k": 3}, 3)],
    ids=["dense", "paged", "speculative"])
def test_watched_engines_bounds_ledger_and_bit_equal(served, kw, extra):
    """A watched dense, paged and speculative engine: ``compile_count``
    within the reference's bounds (buckets + 1, + 2, + 3) and equal to
    the builds it observed, ``recompile_total`` unchanged, the decode
    program cataloged, the ledger holding its params and bank at the
    reference's byte counts; streams and banks bit-equal to an engine
    with telemetry off."""
    cfg, params = served
    pt.install_compile_listener()
    reg = pt.registry()
    rebuilt = [reg.value("recompile_total", fn=n) for n in
               ("serve_decode", "serve_spec_verify", "serve_copy_page")]
    builds = reg.value("program_build_total")
    eng, out = _serve(cfg, params, **kw)
    assert eng.compile_count <= eng.n_buckets + extra
    assert reg.value("program_build_total") - builds == eng.compile_count
    assert [reg.value("recompile_total", fn=n) for n in
            ("serve_decode", "serve_spec_verify",
             "serve_copy_page")] == rebuilt
    decode = ps.catalog()["serve_decode"]
    assert decode.flops > 0 and decode.bytes_accessed > ps.tree_bytes(params)
    assert eng._decode.steps > 1 and eng._decode._cache_size() == 1
    entries = ps.ledger()._entries
    eid = f"engine{eng.engine_id}"
    pool = "kv_page_pool" if kw else "kv_slot_bank"
    assert entries[("params", eid)] == ps.tree_bytes(params)
    assert entries[(pool, eid)] == eng.kv_cache_stats()["reserved_bytes"]
    if not kw:
        assert entries[(pool, eid)] == rps.kv_slot_bank_bytes(
            cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 2, 32, 4)
    pt.enable(False)
    try:
        quiet, quiet_out = _serve(cfg, params, **kw)
    finally:
        pt.enable(True)
    assert quiet_out.keys() == out.keys()
    for rid in out:
        assert np.array_equal(out[rid], quiet_out[rid])
    for name in eng._kv:
        assert torch.equal(eng._kv[name], quiet._kv[name])
    del eng
    import gc
    gc.collect()
    assert ("params", eid) not in ps.ledger()._entries


def test_engine_finalizer_waits_on_no_lock():
    """An engine collected while its thread holds the metrics registry's
    lock (the collector runs finalizers inside whatever allocation
    triggers it) queues its ledger releases instead of waiting on that
    lock; the next ledger read applies them and republishes the
    gauges."""
    led = ps.ledger()
    led.account("params", 123, name="finalizer-probe")
    lock = pt.registry()._lock

    def collect_under_lock():
        with lock:
            _release_ledger(led, "kv_slot_bank", "finalizer-probe")

    t = threading.Thread(target=collect_under_lock, daemon=True)
    t.start()
    t.join(10)
    stuck = t.is_alive()
    if stuck:       # free the registry for the rest of the run, then fail
        lock.release()
        t.join(10)
    assert not stuck, "the finalizer waited on the registry's lock"
    assert ("params", "finalizer-probe") not in led._entries
    assert "params" not in led.breakdown() or \
        pt.registry().value("hbm_ledger_bytes", category="params") == \
        led.breakdown()["params"]


def test_engine_ledger_matches_reference_engine(served):
    """The port engine accounts the same params and bank bytes as the
    reference engine over the same f32 config and weights."""
    import llama_refs
    from mxtpu.serve import ServeEngine as RefEngine
    jcfg, jparams = llama_refs.serve_config(), llama_refs.serve_weights(0)
    ref = RefEngine(jcfg, jparams, max_slots=2, max_len=32, min_bucket=4)
    port_cfg = replace(_tiny(remat=False), attn_impl="dense")
    port = ServeEngine(port_cfg, tl.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"), **SHAPE)
    r, p = rps.ledger()._entries, ps.ledger()._entries
    for cat in ("params", "kv_slot_bank"):
        assert p[(cat, f"engine{port.engine_id}")] == \
            r[(cat, f"engine{ref.engine_id}")]


# ---------------------------------------------------------------------------
# diagnosis
# ---------------------------------------------------------------------------
def test_diagnose_perf_renders_a_port_scrape(tmp_path, capsys):
    """A port scrape saved to a file renders through the unchanged
    ``tools/diagnose.py perf``, with the watched program's row."""
    from tools.diagnose import perf
    f = pt.watch(watcher.Program(lambda a: a @ a, "tp_cli_prog"),
                 "tp_cli_prog", loop="train")
    a = torch.ones(64, 64)
    for _ in range(3):
        f(a)
    path = tmp_path / "scrape.txt"
    path.write_text(pt.prometheus())
    assert perf(str(path)) is True
    out = capsys.readouterr().out
    assert "tp_cli_prog" in out
    assert "Roofline attribution" in out
