"""The port's serving-tier fault tolerance on the CPU: replica
supervision, deterministic re-dispatch, the self-healing disaggregated
path, and the serve half of the chaos harness
(``mxtpu_torch.contrib.chaos``).

Contracts (``tests/test_serve_chaos.py``'s, held on the port; every
fault is provoked by a seeded ``ServeChaosPlan`` or an injected wedge):
a request that survives a replica crash, a raise inside decode
dispatch, a stall or a killed prefill worker emits exactly its
``llama_refs.reference`` stream (mxtpu's memoized ``generate``),
speculative runs included; zero healthy replicas is a 503 with
Retry-After and a loud failure of parked work; Retry-After carries
seeded jitter; a severed KV channel reconnects, re-authenticates and
resends, and a wrong secret fails fast; sustained prefill failure trips
the breaker into colocated fallback; the trace survives a crash with an
explicit redispatch span, and ``tools/diagnose.py timeline`` stitches
the port's trace files; the KV frames' context header is versioned and
reads across the packages; an impossible SLO target degrades /healthz;
deadline-aware shedding runs in tiers.

Every engine keeps ``llama_refs``' shape (2 slots or 1, ``max_len`` 32,
buckets from 4) on the CPU, and every wait has a bound.
"""
import json
import os
import threading
import time
from dataclasses import fields

import jax
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu import rpc as j_rpc
from mxtpu.serve.gateway import disagg as j_disagg
from mxtpu.telemetry import distributed as j_dtrace
from mxtpu_torch import rpc, telemetry
from mxtpu_torch.contrib.chaos import ServeChaosPlan, attach_serve
from mxtpu_torch.models import llama as tl
from mxtpu_torch.serve import Request, ServeEngine, resume_key
from mxtpu_torch.serve.gateway import (CircuitBreaker, DisaggBackend,
                                       Gateway, GatewayClient,
                                       GatewayUnavailable, KVChannel)
from mxtpu_torch.serve.gateway import disagg
from mxtpu_torch.telemetry import distributed as dtrace

torch.set_num_threads(2)   # a CPU share for each xdist worker

# fast supervision for tests: tight heartbeat, tiny restart backoff
SUP = dict(heartbeat_s=0.05, stall_s=30.0, backoff_base_s=0.01,
           backoff_max_s=0.05)
WAIT = 60.0                # every join, result and socket wait


def _port_cfg(cfg):
    vals = {f.name: getattr(cfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    return tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    jcfg = llama_refs.serve_config()
    jparams = llama_refs.serve_weights(0)
    return jcfg, jparams, _port_cfg(jcfg), tl.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _ref(model, prompt, mnew, seed=0, temperature=0.0, top_k=None,
         top_p=None):
    jcfg, jparams, _, _ = model
    return llama_refs.reference(jcfg, jparams, prompt, mnew, seed=seed,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p)


def _engine(model, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("min_bucket", 4)
    return ServeEngine(model[2], model[3], device="cpu", **kw)


def _disagg(model, **kw):
    kw.setdefault("max_slots", 2)
    return DisaggBackend(model[2], model[3], max_len=32, min_bucket=4,
                         device="cpu", **kw)


# The reference's generate costs about a second a request on the CPU, so
# the file draws its requests from few streams: single-request tests
# share LONG (long enough to die mid-stream) or SHORT, and the client
# streams and the shedding test draw from one plan (``plan``)
LONG = dict(prompt=np.arange(6), mnew=8, seed=5, temperature=0.8)
SHORT = dict(prompt=np.arange(5), mnew=4, seed=6, temperature=0.9)


def _plan(cfg, n, seed):
    """A seeded client stream: prompts of 3, 5 or 9 tokens, 4 or 6 new
    ones, odd clients sampled with top_k."""
    rng = np.random.default_rng(seed)
    plan = []
    for i in range(n):
        plen = int(rng.choice([3, 5, 9]))
        samp = (dict(temperature=float(rng.choice([0.7, 0.9])),
                     top_k=int(rng.choice([5, 8])))
                if i % 2 else dict(temperature=0.0))
        plan.append(dict(prompt=rng.integers(0, cfg.vocab_size, plen),
                         mnew=int(rng.choice([4, 6])), seed=i,
                         delay=float(rng.exponential(0.01)), **samp))
    return plan


@pytest.fixture(scope="module")
def plan(model):
    return _plan(model[2], 8, 17)


def _job_ref(model, job):
    return _ref(model, job["prompt"], job["mnew"], seed=job["seed"],
                temperature=job["temperature"], top_k=job.get("top_k"))


def _submit(gw, job, **kw):
    return gw.submit(job["prompt"], job["mnew"], seed=job["seed"],
                     temperature=job["temperature"],
                     top_k=job.get("top_k"), **kw)


def _run_threads(fn, jobs):
    threads = [threading.Thread(target=fn, args=(i, j), daemon=True)
               for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a client timed out"


def _stream_over_http(model, port, plan):
    """Every job as its own HTTP client thread; each must complete with
    its reference stream."""
    results = {}

    def client(i, job):
        time.sleep(job["delay"])
        cli = GatewayClient("127.0.0.1", port, timeout=WAIT)
        results[i] = cli.generate(
            job["prompt"], job["mnew"], seed=job["seed"],
            temperature=job["temperature"],
            **({"top_k": job["top_k"]} if "top_k" in job else {}))

    _run_threads(client, plan)
    assert len(results) == len(plan)
    for i, job in enumerate(plan):
        assert results[i]["status"] == 200, (i, results[i])
        assert results[i]["reason"] == "complete", (i, results[i])
        assert results[i]["tokens"] == _job_ref(model, job), (i, job)


# ---------------------------------------------------------------------------
# the resume primitive
# ---------------------------------------------------------------------------
def test_resume_key_replays_sampling_chain(model):
    """A sampled request resumed after n streamed tokens — prompt +
    prefix re-prefilled with resume_key(seed, n) — continues the exact
    reference stream (sampling makes every split position observable;
    greedy would hide a broken chain)."""
    ref = _job_ref(model, LONG)
    for n in (0, 1, 3):
        resumed = np.concatenate([LONG["prompt"],
                                  np.asarray(ref[:n], np.int32)])
        eng = _engine(model)
        rid = eng.submit(Request(
            prompt=resumed, max_new_tokens=LONG["mnew"] - n,
            temperature=LONG["temperature"], seed=LONG["seed"],
            rng=resume_key(LONG["seed"], n) if n else None))
        res = eng.run()
        assert list(res[rid]) == ref[n:], n


# ---------------------------------------------------------------------------
# supervision + deterministic re-dispatch
# ---------------------------------------------------------------------------
def test_replica_kill_poisson_stream_matches_reference(model, plan):
    """A seeded multi-client Poisson stream through a 2-replica HTTP
    gateway with a chaos-killed replica: every request completes with
    its reference stream, and the restart counter proves the kill
    fired."""
    reg = telemetry.registry()
    r0 = reg.value("gateway_replica_restarts_total", reason="died")
    gw = Gateway(lambda: _engine(model), n_replicas=2, queue_max=256,
                 supervisor_opts=SUP)
    chaos = attach_serve(gw, ServeChaosPlan(seed=3, kill_replica={0: 2}))
    try:
        port = gw.start_http(port=0)
        _stream_over_http(model, port, plan)
        assert chaos.injected["replica_kill"] >= 1, chaos.injected
        assert reg.value("gateway_replica_restarts_total",
                         reason="died") - r0 >= 1
        sup = gw.supervisor.describe()
        assert sup["restarts"] >= 1
        assert any(h["reason"] == "died" for h in sup["history"])
    finally:
        gw.close()


def test_decode_raise_restart_history_and_state(model):
    """A raise inside decode dispatch on the only replica: the
    supervisor restarts it with a fresh engine, the stranded request
    resumes mid-stream to its reference stream, and /state carries the
    restart history."""
    reg = telemetry.registry()
    rd0 = reg.value("gateway_redispatch_total")
    gw = Gateway(lambda: _engine(model, max_slots=1), n_replicas=1,
                 queue_max=16, supervisor_opts=SUP)
    dead = gw.backend.replicas()[0]
    plan = attach_serve(gw, ServeChaosPlan(seed=1, raise_in_decode={0: 3}))
    try:
        h = _submit(gw, LONG)
        toks = h.result(timeout=WAIT)
        assert h.reason == "complete"
        assert list(toks) == _job_ref(model, LONG)
        assert plan.injected["decode_raise"] == 1
        assert reg.value("gateway_redispatch_total") - rd0 >= 1
        st = gw.state()
        sup = st["supervisor"]
        assert sup["restarts"] >= 1
        assert any(h_["reason"] == "died" for h_ in sup["history"])
        assert any("ServeChaosFault" in (h_["error"] or "")
                   for h_ in sup["history"])
        assert any(r["healthy"] for r in st["replicas"])
        # the replacement is another engine with its own decode program
        fresh = gw.backend.replicas()[0]
        assert fresh is not dead and fresh.engine is not dead.engine
        assert fresh.engine._decode is not dead.engine._decode
    finally:
        gw.close()


def test_replica_kill_mid_speculative_run_matches_reference(model):
    """A replica dies mid-accepted-run of a speculative paged engine:
    the re-dispatch fast-forwards the key chain by the EMITTED count,
    so both streams (a plateau prompt that keeps speculation firing,
    and a sampled one) are their reference streams."""
    reg = telemetry.registry()
    rd0 = reg.value("gateway_redispatch_total")
    gw = Gateway(lambda: _engine(model, paged=True, page_size=8,
                                 speculate_k=3),
                 n_replicas=1, queue_max=16, supervisor_opts=SUP)
    plan = attach_serve(gw, ServeChaosPlan(seed=5, raise_in_decode={0: 3}))
    try:
        jobs = [dict(prompt=[140, 141, 140], mnew=12, temperature=0.0,
                     seed=0),
                dict(prompt=[9, 4, 7, 1, 6], mnew=8, temperature=0.9,
                     top_k=7, seed=6)]
        hs = [gw.submit(j["prompt"], j["mnew"], seed=j["seed"],
                        temperature=j["temperature"],
                        **({"top_k": j["top_k"]} if "top_k" in j
                           else {}))
              for j in jobs]
        for h, j in zip(hs, jobs):
            toks = h.result(timeout=WAIT)
            assert h.reason == "complete", j
            assert list(toks) == _ref(
                model, j["prompt"], j["mnew"], seed=j["seed"],
                temperature=j["temperature"], top_k=j.get("top_k")), j
        assert plan.injected["decode_raise"] == 1
        assert reg.value("gateway_redispatch_total") - rd0 >= 1
        assert any(r["healthy"] for r in gw.state()["replicas"])
    finally:
        gw.close()


def test_zero_healthy_replicas_503_and_parked_failure(model):
    """Restart budget 0 + a dead only-replica: new submissions get the
    distinct unavailable error (HTTP 503 + Retry-After), the stranded
    request fails loudly with reason 'error', and /healthz reports
    degraded."""
    gw = Gateway(lambda: _engine(model, max_slots=1), n_replicas=1,
                 queue_max=16, supervisor_opts=dict(SUP, max_restarts=0))
    attach_serve(gw, ServeChaosPlan(seed=2, kill_replica={0: 1}))
    try:
        port = gw.start_http(port=0)
        h = gw.submit(np.arange(4), 8, seed=0)
        toks = h.result(timeout=WAIT)
        assert h.reason == "error" and len(toks) <= 8
        with pytest.raises(GatewayUnavailable):
            gw.submit(np.arange(4), 2, seed=1)
        cli = GatewayClient("127.0.0.1", port, timeout=WAIT)
        rec = cli.generate(np.arange(4), 2, seed=1)
        assert rec["status"] == 503
        assert rec["retry_after_s"] >= 1
        status, hz = cli.get_json("/healthz")
        assert status == 200
        assert hz["status"] == "degraded"
        assert hz["healthy_replicas"] == 0
    finally:
        gw.close()


def test_retry_after_jitter_spreads(model):
    """Consecutive Retry-After values from one overloaded gateway are
    jittered: seeded, so the sequence is the reference's for the same
    seed, and spread."""
    gw = Gateway(lambda: _engine(model, max_slots=1), n_replicas=1,
                 queue_max=2, started=False, supervise=False,
                 retry_jitter=4.0)
    try:
        for i in range(2):
            gw.submit(np.arange(4), 2, seed=i)
        values = []
        for i in range(8):
            try:
                gw.submit(np.arange(4), 2, seed=9)
            except Exception as e:
                values.append(e.retry_after)
        assert len(values) == 8
        assert len(set(values)) >= 2, values
        assert all(v >= 1 for v in values)
        gw.backend.start()                     # drain for a clean close
    finally:
        gw.close()


def test_supervisor_stall_detection(model):
    """A replica whose loop stops making step progress while holding
    work is STALLED: pulled from routing (reason 'stalled'), restarted,
    and the wedged request resumes elsewhere to its reference stream."""
    reg = telemetry.registry()
    s0 = reg.value("gateway_replica_restarts_total", reason="stalled")
    gw = Gateway(lambda: _engine(model, max_slots=1), n_replicas=1,
                 queue_max=16, supervisor_opts=dict(SUP, stall_s=0.3))
    try:
        eng = gw.backend.replicas()[0].engine
        orig = eng._dispatch
        fired = {"n": 0}

        def wedge(firsts):
            if fired["n"] == 2:
                fired["n"] += 1
                time.sleep(2.5)      # wedged well past stall_s
            else:
                fired["n"] += 1
            return orig(firsts)

        eng._dispatch = wedge
        h = _submit(gw, LONG)
        toks = h.result(timeout=WAIT)
        assert h.reason == "complete"
        assert list(toks) == _job_ref(model, LONG)
        assert reg.value("gateway_replica_restarts_total",
                         reason="stalled") - s0 >= 1
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# self-healing disagg
# ---------------------------------------------------------------------------
def _tcp_channel_pair(secret):
    """connect+accept a re-healable TCP channel pair (tx redials, rx
    re-accepts)."""
    listener, port = KVChannel.listen("127.0.0.1", 0)
    listener.settimeout(WAIT)
    out = {}

    def rx_side():
        out["rx"] = KVChannel.accept(listener, secret=secret,
                                     reaccept=True)

    t = threading.Thread(target=rx_side, daemon=True)
    t.start()
    tx = KVChannel.connect("127.0.0.1", port, secret=secret, timeout=WAIT)
    t.join(WAIT)
    assert not t.is_alive()
    return tx, out["rx"]


def test_kv_channel_sever_reconnect_reauth_bit_exact():
    """A TCP handoff channel severed mid-stream reconnects with backoff,
    re-authenticates via the HMAC hello, and the resent frame's arrays
    are bit-exact; counters prove the reconnect. A wrong-secret dial
    fails fast with an auth error."""
    reg = telemetry.registry()
    rc0 = reg.value("gateway_kv_reconnects_total")
    rs0 = reg.value("gateway_kv_resends_total")
    tx, rx = _tcp_channel_pair(b"kv-chaos")
    got = []
    done = threading.Event()

    def feeder():
        for _ in range(2):
            got.append(rx.recv_handoff())
        done.set()

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    block = np.arange(48, dtype=np.float32).reshape(2, 2, 6, 2)
    tx.send_handoff(("kv", 11, 5, 42, block, block * 2,
                     np.asarray([3, 4], np.uint32)))
    tx._sock.close()
    tx.send_handoff(("kv", 12, 5, 43, block + 1, block * 3,
                     np.asarray([5, 6], np.uint32)))
    assert done.wait(WAIT)
    assert [m[1] for m in got] == [11, 12]
    np.testing.assert_array_equal(got[1][4], block + 1)
    np.testing.assert_array_equal(got[1][5], block * 3)
    assert got[1][4].dtype == np.float32
    assert reg.value("gateway_kv_reconnects_total") - rc0 >= 1
    assert reg.value("gateway_kv_resends_total") - rs0 >= 1
    tx.close()
    rx.close()

    listener, port = KVChannel.listen("127.0.0.1", 0)
    listener.settimeout(WAIT)
    srv_err = {}

    def rx_auth():
        try:
            KVChannel.accept(listener, secret=b"right")
        except rpc.RPCAuthError as e:
            srv_err["e"] = e

    t2 = threading.Thread(target=rx_auth, daemon=True)
    t2.start()
    t0 = time.monotonic()
    with pytest.raises((rpc.RPCAuthError, rpc.RPCProtocolError)):
        KVChannel.connect("127.0.0.1", port, secret=b"wrong", timeout=WAIT)
    assert time.monotonic() - t0 < 5.0
    t2.join(WAIT)
    assert isinstance(srv_err.get("e"), rpc.RPCAuthError)
    listener.close()


def test_prefill_worker_kill_respawn_single_resubmit(model):
    """A chaos-killed prefill worker is respawned, its in-flight job
    resubmitted once, and the request completes with its reference
    stream."""
    reg = telemetry.registry()
    w0 = reg.value("gateway_prefill_restarts_total")
    be = _disagg(model, n_prefill=1, n_decode=1)
    gw = Gateway(backend=be, queue_max=16, supervisor_opts=SUP)
    plan = attach_serve(gw, ServeChaosPlan(seed=5, kill_prefill={0: 0}))
    try:
        h = _submit(gw, SHORT)
        toks = h.result(timeout=WAIT)
        assert h.reason == "complete"
        assert list(toks) == _job_ref(model, SHORT)
        assert plan.injected["prefill_kill"] == 1
        assert reg.value("gateway_prefill_restarts_total") - w0 == 1
        assert len(be.prefill) == 1 and be.prefill[0].alive
    finally:
        gw.close()


def test_breaker_trips_to_colocated_fallback(model):
    """Sustained prefill failure trips the breaker: requests fall back
    to colocated prefill with their reference streams, /healthz
    degrades, and a half-open probe after the cooldown closes it once
    the pool heals."""
    reg = telemetry.registry()
    fb0 = reg.value("gateway_breaker_fallback_total")
    now = {"t": 0.0}
    breaker = CircuitBreaker(threshold=2, cooldown_s=10.0,
                             clock=lambda: now["t"])
    be = _disagg(model, n_prefill=1, n_decode=1, breaker=breaker)
    gw = Gateway(backend=be, queue_max=16, supervisor_opts=SUP)
    try:
        port = gw.start_http(port=0)
        worker = be.prefill[0]
        orig_fn = worker._fn

        def poisoned(bucket):
            def f(*a, **k):
                raise RuntimeError("injected prefill failure")
            return f

        worker._fn = poisoned
        for i in range(2):
            h = gw.submit(np.arange(4), 2, seed=i)
            h.result(timeout=WAIT)
            assert h.reason == "error"
        assert breaker.describe()["state"] == "open"
        h = _submit(gw, LONG)
        assert list(h.result(timeout=WAIT)) == _job_ref(model, LONG)
        assert h.reason == "complete"
        assert reg.value("gateway_breaker_fallback_total") - fb0 >= 1
        cli = GatewayClient("127.0.0.1", port, timeout=WAIT)
        status, hz = cli.get_json("/healthz")
        assert status == 200 and hz["status"] == "degraded"
        assert hz["breaker"]["state"] == "open"
        worker._fn = orig_fn
        now["t"] = 11.0
        h = _submit(gw, SHORT)
        assert list(h.result(timeout=WAIT)) == _job_ref(model, SHORT)
        assert breaker.describe()["state"] == "closed"
        _, hz = cli.get_json("/healthz")
        assert hz["status"] == "ok" and hz["breaker"]["state"] == "closed"
    finally:
        gw.close()


def test_disagg_chaos_stream_over_tcp_matches_reference(model, plan):
    """A seeded client stream through disaggregated prefill/decode over
    an HMAC TCP channel with a killed prefill worker and severed,
    corrupted and delayed KV frames: every request completes with its
    reference stream; the counters prove the faults fired."""
    reg = telemetry.registry()
    rc0 = reg.value("gateway_kv_reconnects_total")
    w0 = reg.value("gateway_prefill_restarts_total")
    tx, rx = _tcp_channel_pair(b"kv-e2e")
    be = _disagg(model, n_prefill=2, n_decode=2, channel=(tx, rx))
    gw = Gateway(backend=be, queue_max=64, supervisor_opts=SUP)
    chaos = attach_serve(gw, ServeChaosPlan(
        seed=9, kill_prefill={1: 0},
        kv_frames={1: "sever", 3: "corrupt", 4: "delay"}, delay_s=0.01))
    try:
        port = gw.start_http(port=0)
        _stream_over_http(model, port, plan)
        assert chaos.injected["prefill_kill"] == 1
        assert chaos.injected["kv_sever"] == 1
        assert chaos.injected["kv_corrupt"] == 1
        assert reg.value("gateway_kv_reconnects_total") - rc0 >= 1
        assert reg.value("gateway_prefill_restarts_total") - w0 >= 1
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# distributed request tracing through a crash
# ---------------------------------------------------------------------------
def _trace_events_for(trace_dir, trace_id):
    evts = []
    for f in sorted(os.listdir(trace_dir)):
        if not f.endswith(".jsonl"):
            continue
        for line in open(os.path.join(trace_dir, f)):
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if (e.get("args") or {}).get("trace_id") == trace_id:
                evts.append(e)
    return evts


def test_replica_kill_keeps_trace_id_and_redispatch_span(
        model, tmp_path, monkeypatch):
    """A request whose replica is killed mid-decode resumes on another
    replica under the SAME trace_id; the seam is a
    ``gateway.redispatch`` span naming both replicas; both replicas'
    events carry the trace; ``diagnose timeline`` stitches the port's
    trace files into valid chrome-trace JSON."""
    from tools.diagnose import timeline
    monkeypatch.setenv("MXTPU_TELEMETRY_TRACE_DIR", str(tmp_path))
    reg = telemetry.registry()
    rd0 = reg.value("gateway_redispatch_total")
    gw = Gateway(lambda: _engine(model, max_slots=1), n_replicas=2,
                 queue_max=16, supervisor_opts=SUP)
    plan = attach_serve(gw, ServeChaosPlan(seed=11, kill_replica={0: 2}))
    try:
        port = gw.start_http(port=0)
        rec = GatewayClient("127.0.0.1", port, timeout=WAIT).generate(
            LONG["prompt"], LONG["mnew"], seed=LONG["seed"],
            temperature=LONG["temperature"])
        assert rec["status"] == 200 and rec["reason"] == "complete"
        assert rec["tokens"] == _job_ref(model, LONG)
        assert plan.injected["replica_kill"] >= 1
        assert reg.value("gateway_redispatch_total") - rd0 >= 1
        trace_id = rec["trace_id"]
        assert isinstance(trace_id, str) and len(trace_id) >= 8
        evts = _trace_events_for(str(tmp_path), trace_id)
        names = {e["name"] for e in evts}
        assert "gateway.submit" in names and "serve.done" in names
        rd = [e for e in evts if e["name"] == "gateway.redispatch"]
        assert rd and rd[0]["ph"] == "X"
        assert rd[0]["args"]["old_replica"] == "r0"
        assert rd[0]["args"]["new_replica"] not in (None, "r0")
        roles = {e["args"].get("role") for e in evts
                 if e["name"] == "serve.seat"}
        assert len(roles) >= 2, roles
        out = str(tmp_path / "timeline.json")
        path, mine = timeline(trace_id, trace_dir=str(tmp_path), out=out)
        assert path == out
        loaded = json.load(open(path))
        assert loaded and all(
            "name" in e and "ph" in e and "pid" in e for e in loaded)
        assert all("ts" in e and "tid" in e for e in loaded
                   if e["ph"] != "M")
        assert any(e["name"] == "gateway.redispatch" for e in loaded)
        assert {e["args"]["trace_id"] for e in loaded
                if e["ph"] != "M"} == {trace_id}
        rid = rd[0]["args"]["rid"]
        path2, mine2 = timeline(rid, trace_dir=str(tmp_path),
                                out=str(tmp_path / "t2.json"))
        assert path2 and len(mine2) == len(mine)
    finally:
        gw.close()


def test_disagg_trace_spans_every_hop(model, tmp_path, monkeypatch):
    """Disaggregated: ONE trace covers the front door, the prefill
    worker's span, the KV handoff receive and the decode seat."""
    monkeypatch.setenv("MXTPU_TELEMETRY_TRACE_DIR", str(tmp_path))
    gw = Gateway(backend=_disagg(model, n_prefill=1, n_decode=1),
                 queue_max=16, supervisor_opts=SUP)
    try:
        h = _submit(gw, SHORT)
        toks = h.result(timeout=WAIT)
        assert h.reason == "complete"
        assert list(toks) == _job_ref(model, SHORT)
        evts = _trace_events_for(str(tmp_path), h.trace_id)
        names = {e["name"] for e in evts}
        assert {"gateway.submit", "gateway.prefill",
                "gateway.handoff_recv", "serve.seat",
                "serve.done"} <= names, names
        pre = [e for e in evts if e["name"] == "gateway.prefill"]
        assert pre[0]["args"]["worker"].startswith("p")
    finally:
        gw.close()


def test_disagg_replica_kill_one_timeline(model, tmp_path, monkeypatch):
    """Disaggregated, a decode replica killed mid-decode: ONE trace_id
    spans the front door, the prefill worker, BOTH decode replicas and
    the re-dispatch, stitched into one timeline, with the reference's
    tokens."""
    from tools.diagnose import timeline
    monkeypatch.setenv("MXTPU_TELEMETRY_TRACE_DIR", str(tmp_path))
    be = _disagg(model, n_prefill=1, n_decode=2, max_slots=1)
    gw = Gateway(backend=be, queue_max=32, supervisor_opts=SUP)
    plan = attach_serve(gw, ServeChaosPlan(seed=13, kill_replica={0: 2}))
    try:
        port = gw.start_http(port=0)
        rec = GatewayClient("127.0.0.1", port, timeout=WAIT).generate(
            LONG["prompt"], LONG["mnew"], seed=LONG["seed"],
            temperature=LONG["temperature"])
        assert rec["status"] == 200 and rec["reason"] == "complete"
        assert rec["tokens"] == _job_ref(model, LONG)
        assert plan.injected["replica_kill"] >= 1
        trace_id = rec["trace_id"]
        evts = _trace_events_for(str(tmp_path), trace_id)
        names = {e["name"] for e in evts}
        assert {"gateway.submit", "gateway.prefill",
                "gateway.handoff_recv", "serve.seat",
                "gateway.redispatch", "serve.done"} <= names, names
        roles = {e["args"].get("role") for e in evts
                 if e["name"] == "serve.seat"}
        assert {"r0", "r1"} <= roles, roles
        rd = [e for e in evts if e["name"] == "gateway.redispatch"]
        assert rd and rd[0]["args"]["trace_id"] == trace_id
        path, mine = timeline(trace_id, trace_dir=str(tmp_path),
                              out=str(tmp_path / "acc.json"))
        loaded = json.load(open(path))
        assert {e["name"] for e in loaded} >= names
        assert all("ts" in e and "tid" in e for e in loaded
                   if e["ph"] != "M")
    finally:
        gw.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_kv_frame_context_header_is_versioned(writer):
    """A frame without the header splits to itself and decodes as a
    handoff; a wrapped frame carries its context through the codec; an
    unknown header version keeps the payload and drops the context —
    with the frame written by either package and read by the port and
    by the reference."""
    block = np.arange(24, dtype=np.float32).reshape(1, 2, 6, 2)
    w_rpc, w_dtrace, w_disagg = ((rpc, dtrace, disagg) if writer == "port"
                                 else (j_rpc, j_dtrace, j_disagg))
    h = w_disagg.KVHandoff(k=block, v=block * 2, true_len=5, token=42,
                           rng=np.asarray([1, 2], np.uint32))
    old_frame = w_disagg.handoff_to_wire(3, h)
    payload, ctx = w_rpc.split_context(old_frame)
    assert payload is old_frame and ctx is None
    tctx = w_dtrace.mint(rid=3, seed=7, deadline_abs=12.5)
    wrapped = bytes(w_rpc.encode(w_rpc.attach_context(old_frame,
                                                      tctx.to_wire())))
    future = bytes(w_rpc.encode(
        (w_rpc.CTX_TAG, w_rpc.CTX_VERSION + 1,
         tctx.to_wire() + ("new-field",), old_frame)))
    for r_rpc, r_dtrace, r_disagg in ((rpc, dtrace, disagg),
                                      (j_rpc, j_dtrace, j_disagg)):
        assert r_rpc.CTX_TAG == w_rpc.CTX_TAG
        payload, ctx = r_rpc.split_context(r_rpc.decode(wrapped))
        got = r_dtrace.TraceContext.from_wire(ctx)
        assert got.trace_id == tctx.trace_id and got.rid == 3
        assert got.seed == 7 and got.deadline_abs == 12.5
        rid, h3 = r_disagg.wire_to_handoff(payload)
        assert rid == 3 and h3.token == 42
        np.testing.assert_array_equal(h3.k, block)
        payload, ctx = r_rpc.split_context(r_rpc.decode(future))
        assert ctx is None
        assert r_disagg.wire_to_handoff(payload)[0] == 3


def test_slo_burn_rate_degrades_healthz(model, monkeypatch):
    """With an impossible TTFT target, one served request pushes the
    burn rate over threshold: /healthz degrades with the slo block
    populated and the SLO gauges land in the registry."""
    monkeypatch.setenv("MXTPU_GATEWAY_SLO_TTFT_MS", "0.0001")
    monkeypatch.setenv("MXTPU_GATEWAY_SLO_WINDOW_S", "600")
    gw = Gateway(lambda: _engine(model), n_replicas=1, queue_max=16,
                 supervise=False)
    try:
        assert gw.slo is not None
        gw.slo.tick(force=True)
        h = gw.submit(np.arange(4), 2, seed=0)
        h.result(timeout=WAIT)
        snap = gw.slo.tick(force=True)
        assert snap["ttft"]["burn"] is not None
        assert snap["ttft"]["burn"] > 1.0
        hz = gw.health()
        assert hz["status"] == "degraded"
        assert hz["slo"]["breached"] is True
        assert hz["slo"]["slos"]["ttft"]["target_ms"] == \
            pytest.approx(0.0001)
        reg = telemetry.registry()
        assert reg.value("gateway_slo_burn_rate", slo="ttft") > 1.0
        assert reg.value("gateway_slo_target_ms", slo="ttft") == \
            pytest.approx(0.0001)
        assert "gateway_slo_burn_rate" in gw.metrics_text()
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# graceful degradation: deadline-aware shedding tiers
# ---------------------------------------------------------------------------
def test_tier1_deadline_aware_shed_and_healthz(model, plan):
    """Past the soft bound the door sheds requests whose own deadline
    cannot survive the backlog (tier 1) and admits patient ones; at the
    hard bound everything sheds (tier 2); the admitted backlog completes
    with its reference streams."""
    gw = Gateway(lambda: _engine(model, max_slots=1), n_replicas=1,
                 queue_max=4, started=False, supervise=False)
    try:
        assert gw.health()["status"] == "ok"
        handles = [_submit(gw, job) for job in plan[:2]]
        with pytest.raises(Exception) as ei:
            gw.submit(np.arange(4), 2, seed=8, deadline_s=0.5)
        assert getattr(ei.value, "tier", None) == 1
        hz = gw.health()
        assert hz["tier"] == 1 and hz["status"] == "degraded"
        handles += [_submit(gw, job) for job in plan[2:4]]
        with pytest.raises(Exception) as ei:
            gw.submit(np.arange(4), 2, seed=9)
        assert getattr(ei.value, "tier", None) == 2
        assert gw.health()["tier"] == 2
        gw.backend.start()
        for job, h in zip(plan, handles):
            assert list(h.result(timeout=WAIT)) == _job_ref(model, job)
    finally:
        gw.close()


def test_chaos_plan_refuses_what_the_reference_refuses(model):
    """attach_serve checks its targets: an unknown kv action, a replica
    index past the set and kv/prefill faults on a colocated gateway
    raise ValueError, as the reference's do."""
    with pytest.raises(ValueError, match="kv chaos action"):
        ServeChaosPlan(kv_frames={0: "explode"})
    gw = Gateway(lambda: _engine(model, max_slots=1), n_replicas=1,
                 queue_max=4, started=False, supervise=False)
    try:
        with pytest.raises(ValueError, match="targets replica 3"):
            attach_serve(gw, ServeChaosPlan(kill_replica={3: 1}))
        with pytest.raises(ValueError, match="DisaggBackend"):
            attach_serve(gw, ServeChaosPlan(kill_prefill={0: 0}))
    finally:
        gw.close()
