"""The port's serving tier (``mxtpu_torch.serve.gateway``) on the CPU.

Contracts (``tests/test_gateway.py``'s, held on the port): a seeded
multi-client Poisson stream through the HTTP gateway across 2 engine
replicas gives, token for token, each request's
``llama_refs.reference`` (mxtpu's memoized ``generate``); admission past
the queue bound is shed with 429 + Retry-After; the gateway's default
deadline frees a slot end to end; the port's detached prefill injected
into an engine continues the reference's stream; the disaggregated
gateway over the framed-RPC channel and the KV channel's TCP
listen/connect carry handoffs; a failing prefill finalizes only its
request and a pending deadline counts from submit; the autoscaler's
decisions are deterministic under a fake clock, on a fake pool and a
real ``ReplicaSet``; ``interval_p99`` is per window. Across the
packages: the handoff frames encode byte for byte alike (f32 and
bf16), each package decodes the other's frames, a reference and a port
``KVChannel`` complete the HMAC handshake and carry handoffs both ways
on one socketpair, and both autoscalers decide alike.

Every engine keeps ``llama_refs``' shape (2 slots, ``max_len`` 32,
buckets from 4) on the CPU, and every wait has a bound.
"""
import socket
import threading
import time
from dataclasses import fields

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu import rpc as j_rpc
from mxtpu.serve import KVHandoff as JKVHandoff
from mxtpu.serve.gateway import autoscale as j_autoscale
from mxtpu.serve.gateway import disagg as j_disagg
from mxtpu_torch import prng, rpc, telemetry
from mxtpu_torch.models import llama as tl
from mxtpu_torch.serve import KVHandoff, Request, ServeEngine, bucket_for
from mxtpu_torch.serve.gateway import (AutoscalePolicy, Autoscaler,
                                       DisaggBackend, Gateway,
                                       GatewayClient, KVChannel, ReplicaSet)
from mxtpu_torch.serve.gateway import disagg
from mxtpu_torch.serve.gateway.autoscale import interval_p99

torch.set_num_threads(2)   # a CPU share for each xdist worker

SHAPE = dict(max_slots=2, max_len=32, min_bucket=4, device="cpu")
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


def _factory(model, **kw):
    _, _, tcfg, tparams = model
    return lambda: ServeEngine(tcfg, tparams, **{**SHAPE, **kw})


def _plan(cfg, n, seed):
    """tests/test_gateway.py's client stream: prompts of 3, 5 or 9
    tokens, 1-4 new ones, odd clients sampled with top_k. Every test of
    the file draws its requests from this one stream (``PLAN``), so each
    reference stream is computed once a file: the reference's
    ``generate`` costs about a second a request on the CPU."""
    rng = np.random.default_rng(seed)
    plan = []
    for i in range(n):
        plen = int(rng.choice([3, 5, 9]))
        samp = (dict(temperature=float(rng.choice([0.7, 0.9])),
                     top_k=int(rng.choice([5, 8])))
                if i % 2 else dict(temperature=0.0))
        plan.append(dict(prompt=rng.integers(0, cfg.vocab_size, plen),
                         mnew=int(rng.choice([1, 2, 4])), seed=i,
                         delay=float(rng.exponential(0.01)), **samp))
    return plan


def _generate_over_http(port, plan):
    """Every job of ``plan`` as its own HTTP client thread, after its
    delay; returns {job index: the client's record}."""
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
    return results


@pytest.fixture(scope="module")
def plan(model):
    return _plan(model[2], 8, 11)


def _job_ref(model, job):
    return _ref(model, job["prompt"], job["mnew"], seed=job["seed"],
                temperature=job["temperature"], top_k=job.get("top_k"))


def _submit(gw, job, **kw):
    return gw.submit(job["prompt"], job["mnew"], seed=job["seed"],
                     temperature=job["temperature"],
                     top_k=job.get("top_k"), **kw)


def _check_plan(model, plan, results):
    for i, job in enumerate(plan):
        assert results[i]["status"] == 200, results[i]
        assert results[i]["reason"] == "complete", results[i]
        assert results[i]["tokens"] == _job_ref(model, job), (i, job)


def _run_threads(fn, jobs):
    threads = [threading.Thread(target=fn, args=(i, j), daemon=True)
               for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a client timed out"


# ---------------------------------------------------------------------------
# the gateway: Poisson multi-client stream, 2 replicas, over HTTP
# ---------------------------------------------------------------------------
def test_gateway_two_replicas_poisson_matches_reference(model, plan):
    """8 seeded clients with Poisson-spaced arrivals through the HTTP
    front door over 2 replicas (mixed lengths and sampling configs):
    every stream is the request's reference stream; /state carries the
    replicas' KV occupancy and the scrape the gateway families."""
    gw = Gateway(_factory(model), n_replicas=2, queue_max=256)
    try:
        port = gw.start_http(port=0)
        _check_plan(model, plan, _generate_over_http(port, plan))
        st = gw.state()
        assert st["n_replicas"] == 2 and len(st["replicas"]) == 2
        kv = st["kv_cache"]
        assert kv["reserved_bytes"] == sum(
            r["kv_cache"]["reserved_bytes"] for r in st["replicas"])
        assert kv["reserved_bytes"] > 0 and kv["slots"] > 0
        assert 0.0 <= kv["occupancy"] <= 1.0
        for r in gw.backend.replicas():
            assert r.engine.compile_count <= r.engine.n_buckets + 1
        status, prom = GatewayClient("127.0.0.1", port,
                                     timeout=WAIT).get_text("/metrics")
        assert status == 200
        for fam in ("mxtpu_gateway_replicas",
                    "mxtpu_gateway_requests_total",
                    "mxtpu_gateway_ttft_ms",
                    "mxtpu_serve_tokens_total"):
            assert fam in prom, fam
        for line in prom.splitlines():
            assert line.startswith("#") or " " in line, line
    finally:
        gw.close()


def test_gateway_backpressure_429(model, plan):
    """Past the queue bound the front door sheds with 429 +
    Retry-After, counted; once the engines start, the accepted backlog
    completes with the reference's tokens."""
    reg = telemetry.registry()
    before = reg.value("gateway_requests_total", code="429")
    gw = Gateway(_factory(model, max_slots=1), n_replicas=1,
                 queue_max=2, started=False)
    try:
        port = gw.start_http(port=0)
        cli = GatewayClient("127.0.0.1", port, timeout=WAIT)
        handles = [_submit(gw, job) for job in plan[:2]]
        shed = plan[2]
        knobs = dict(seed=shed["seed"], temperature=shed["temperature"],
                     **({"top_k": shed["top_k"]} if "top_k" in shed
                        else {}))
        rec = cli.generate(shed["prompt"], shed["mnew"], **knobs)
        assert rec["status"] == 429
        assert rec["retry_after_s"] >= 1
        assert "queue full" in rec["error"]
        assert reg.value("gateway_requests_total",
                         code="429") - before == 1
        gw.backend.start()
        for job, h in zip(plan, handles):
            toks = h.result(timeout=WAIT)
            assert h.reason == "complete"
            assert list(toks) == _job_ref(model, job)
        rec = cli.generate(shed["prompt"], shed["mnew"], **knobs)
        assert rec["status"] == 200
        assert rec["tokens"] == _job_ref(model, shed)
    finally:
        gw.close()


def test_gateway_deadline_reclaims_slot_end_to_end(model, plan):
    """The gateway's default deadline plumbs into the engine: on an
    engine clock that advances 0.1 s a reading, a request with a 0.25 s
    budget ends 'deadline' early, and the freed slot serves the next
    request to completion."""
    ticks = {"t": 0.0}

    def clock():
        ticks["t"] += 0.1
        return ticks["t"]

    gw = Gateway(_factory(model, max_slots=1, clock=clock), n_replicas=1,
                 queue_max=64, default_deadline_s=0.25)
    try:
        h1 = gw.submit(np.arange(4), 28, seed=1)
        toks = h1.result(timeout=WAIT)
        assert h1.reason == "deadline"
        assert len(toks) < 28
        h2 = _submit(gw, plan[3], deadline_s=10 ** 6)
        assert list(h2.result(timeout=WAIT)) == _job_ref(model, plan[3])
        assert h2.reason == "complete"
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# disaggregated prefill/decode with KV handoff
# ---------------------------------------------------------------------------
def test_prefill_detached_inject_matches_reference(model, plan):
    """The port's prefill_detached (token, KV block, key) injected into
    a fresh engine continues to the reference's tokens, greedy and
    sampled with top_k; admission built one inject program and no
    prefill."""
    _, _, tcfg, tparams = model
    for job in plan[4:6]:
        n = len(job["prompt"])
        padded = torch.zeros((1, bucket_for(n, 4, 32)), dtype=torch.int32)
        padded[0, :n] = torch.as_tensor(job["prompt"])
        with torch.no_grad():
            tok, kb, vb, rng = tl.prefill_detached(
                tcfg, tparams, padded, n,
                prng.PRNGKey(job["seed"], device="cpu"), job["temperature"],
                job.get("top_k"), None)
        h = KVHandoff(k=kb.numpy(), v=vb.numpy(), true_len=n,
                      token=int(tok[0]), rng=prng.key_to_numpy(rng))
        eng = ServeEngine(tcfg, tparams, **SHAPE)
        rid = eng.submit_prefilled(h, Request(
            prompt=job["prompt"], max_new_tokens=job["mnew"],
            temperature=job["temperature"], top_k=job.get("top_k"),
            seed=job["seed"]))
        res = eng.run()
        assert list(res[rid]) == _job_ref(model, job)
        assert eng.n_buckets == 1 and len(eng._prefills) == 0
        assert eng.compile_count <= eng.n_buckets + 1


def test_disagg_gateway_over_rpc_channel(model, plan):
    """Prompts routed to 2 prefill workers, KV blocks framed over the
    rpc channel with HMAC, seated in 2 decode replicas: the reference's
    tokens; the handoff counters moved; each worker built one program
    per bucket it saw."""
    reg = telemetry.registry()
    before = reg.value("gateway_kv_handoffs_total")
    be = DisaggBackend(model[2], model[3], n_prefill=2, n_decode=2,
                       max_slots=2, max_len=32, min_bucket=4,
                       channel=KVChannel.pair(secret=b"kv-test"),
                       device="cpu")
    gw = Gateway(backend=be, queue_max=64)
    try:
        port = gw.start_http(port=0)
        _check_plan(model, plan, _generate_over_http(port, plan))
        assert reg.value("gateway_kv_handoffs_total") - before == 8
        hist = reg.get("gateway_kv_handoff_bytes")
        assert hist is not None and hist.count >= 8
        for w in be.prefill:
            assert w.compile_count == len(w._fns) <= 3
    finally:
        gw.close()


def test_disagg_prefill_error_and_pending_deadline(model, plan):
    """A failing prefill job finalizes ITS request ('error') and the
    worker serves the next one; a request whose budget is gone by
    seating time expires at the handoff ('deadline')."""
    reg = telemetry.registry()
    e0 = reg.value("gateway_prefill_errors_total")
    be = DisaggBackend(model[2], model[3], n_prefill=1, n_decode=1,
                       max_slots=2, max_len=32, min_bucket=4,
                       device="cpu")
    gw = Gateway(backend=be, queue_max=16)
    try:
        worker = be.prefill[0]
        orig_fn = worker._fn

        def poisoned(bucket):
            def f(*a, **k):
                raise RuntimeError("injected prefill failure")
            return f

        worker._fn = poisoned
        h = gw.submit(np.arange(4), 2, seed=0)
        toks = h.result(timeout=WAIT)
        assert h.reason == "error" and len(toks) == 0
        assert reg.value("gateway_prefill_errors_total") - e0 == 1
        worker._fn = orig_fn
        h2 = _submit(gw, plan[6])
        assert list(h2.result(timeout=WAIT)) == _job_ref(model, plan[6])
        assert h2.reason == "complete"
        d0 = reg.value("serve_cancelled_total", reason="deadline")
        h3 = gw.submit(np.arange(4), 8, seed=2, deadline_s=0.0)
        toks = h3.result(timeout=WAIT)
        assert h3.reason == "deadline" and len(toks) == 0
        assert reg.value("serve_cancelled_total",
                         reason="deadline") - d0 == 1
    finally:
        gw.close()


def _chunk_inputs(tcfg, plen, bucket, seed):
    rng = np.random.default_rng(seed)
    padded = torch.zeros((1, bucket), dtype=torch.int32)
    padded[0, :plen] = torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, plen).astype(np.int32))
    return padded


@pytest.mark.parametrize("knobs", [(0.0, None, None), (0.8, 5, 0.9)])
def test_chunk_program_tensor_position_matches_eager(model, knobs):
    """The chunk program the prefill worker captures on the card (start
    position a 0-d tensor, true_len a 0-d tensor, the sampling knobs
    (1,) tensors, RoPE tables of its own) against the eager
    ``prefill_detached_chunk`` with host ints, chunk by chunk over a
    bucket: every chunk's K/V, token and key, and the caches, bit for
    bit (greedy and sampled)."""
    _, _, tcfg, tparams = model
    plen, bucket, cw = 13, 16, 4
    padded = _chunk_inputs(tcfg, plen, bucket, 3)
    temp, tk, tp = knobs
    key = prng.PRNGKey(7, device="cpu")
    eager = tl.init_cache(tcfg, 1, bucket, device="cpu")
    k = torch.zeros_like(eager["k"])
    v = torch.zeros_like(eager["v"])
    rope = tl.rope_tables(tcfg, bucket, device="cpu")
    knob_t = (torch.tensor([temp], dtype=torch.float32),
              torch.tensor([tcfg.vocab_size if tk is None else tk]),
              torch.tensor([1.0 if tp is None else tp],
                           dtype=torch.float32))
    with torch.no_grad():
        for pos in range(0, bucket, cw):
            chunk = padded[:, pos:pos + cw]
            want = tl.prefill_detached_chunk(tcfg, tparams, chunk, eager,
                                             plen, key, temp, tk, tp)
            eager = want[4]
            got = tl.prefill_detached_chunk(
                tcfg, tparams, chunk.clone(),
                {"k": k, "v": v, "pos": torch.tensor(pos)},
                torch.tensor(plen), key, *knob_t, rope=rope)
            for a, b in zip(got[:4], want[:4]):
                assert a.dtype == b.dtype and torch.equal(a, b), pos
    assert torch.equal(k, eager["k"]) and torch.equal(v, eager["v"])


def _streamed_backend(model):
    return DisaggBackend(model[2], model[3], n_prefill=1, n_decode=1,
                         max_slots=2, max_len=32, min_bucket=4, paged=True,
                         page_size=4, stream_chunk=4, device="cpu")


def test_streamed_worker_reuses_its_cache(model, plan):
    """Streamed prefill (chunks of 4 over pages of 4) through the
    disaggregated gateway: each stream is the reference's; the worker's
    second request of a bucket runs on the cache the first left dirty
    and gives the stream a fresh worker gives; one chunk program a
    bucket, each a watched build."""
    jobs = [plan[2], plan[3], plan[2]]
    assert bucket_for(len(plan[2]["prompt"]), 4, 32) == \
        bucket_for(len(plan[3]["prompt"]), 4, 32)
    gw = Gateway(backend=_streamed_backend(model), queue_max=16)
    try:
        worker = gw.backend.prefill[0]
        assert worker.stream_chunk == 4
        got = []
        for job in jobs:
            h = _submit(gw, job)
            got.append(list(h.result(timeout=WAIT)))
            assert h.reason == "complete"
        assert len(worker._cfns) == 1 and worker.compile_count == \
            len(worker._fns) + 1
        program = next(iter(worker._cfns.values()))
        assert program.captures == 0 and program.calls >= 6
    finally:
        gw.close()
    fresh = Gateway(backend=_streamed_backend(model), queue_max=16)
    try:
        h = _submit(fresh, plan[3])
        first = list(h.result(timeout=WAIT))
    finally:
        fresh.close()
    assert got[1] == first == _job_ref(model, plan[3])
    assert got[0] == got[2] == _job_ref(model, plan[2])


def test_kv_channel_tcp_listen_connect():
    """The cross-host path: the handoff channel over TCP loopback with
    HMAC, same framed codec."""
    listener, port = KVChannel.listen("127.0.0.1", 0)
    listener.settimeout(WAIT)
    got = {}

    def rx_side():
        ch = KVChannel.accept(listener, secret=b"s")
        got["msg"] = ch.recv()
        ch.close()

    t = threading.Thread(target=rx_side, daemon=True)
    t.start()
    tx = KVChannel.connect("127.0.0.1", port, secret=b"s", timeout=WAIT)
    payload = ("kv", 7, 3, 42, np.ones((2, 2, 4, 2), np.float32),
               np.zeros((2, 2, 4, 2), np.float32),
               np.asarray([1, 2], np.uint32))
    tx.send(payload)
    t.join(WAIT)
    assert not t.is_alive()
    tx.close()
    listener.close()
    assert got["msg"][0] == "kv" and got["msg"][1] == 7
    np.testing.assert_array_equal(got["msg"][4], payload[4])


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------
class _FakePool:
    def __init__(self, n=1, slots_per=4):
        self.n = n
        self.slots_per = slots_per
        self.queued = 0
        self.active = 0
        self.calls = []

    @property
    def size(self):
        return self.n

    def load_total(self):
        return {"queued": self.queued, "active": self.active,
                "slots": self.n * self.slots_per}

    def scale_to(self, n):
        self.calls.append(n)
        self.n = n
        return n


# (t, queued, active, p99): the injected load, tick by tick
_LOAD = [(0.0, 0, 0, None), (1.0, 9, 0, None), (2.0, 9, 0, None),
         (12.0, 0, 8, 80.0), (23.0, 0, 0, None), (28.0, 0, 0, None),
         (33.5, 0, 0, None), (100.0, 0, 0, None), (200.0, 0, 0, None),
         (300.0, 0, 0, None)]


def _drive(autoscaler_cls, policy_cls):
    now = {"t": 0.0}
    lat = {"p99": None}
    pool = _FakePool(n=1, slots_per=4)
    pol = policy_cls(min_replicas=1, max_replicas=3, target_p99_ms=50.0,
                     queue_high=2.0, occupancy_low=0.25, cooldown_s=10.0,
                     interval_s=1.0)
    sc = autoscaler_cls(pool, pol, clock=lambda: now["t"],
                        latency_p99=lambda: lat["p99"])
    out = []
    for t, q, a, p in _LOAD:
        now["t"], pool.queued, pool.active, lat["p99"] = t, q, a, p
        out.append(sc.tick())
    return out, pool, sc


def test_autoscaler_up_down_deterministic():
    """Fake clock + injected load: a queue spike scales up once
    (cooldown absorbs the repeat), the latency signal scales up again,
    sustained idleness scales down once; telemetry counts both and the
    decision log carries the driving signals."""
    reg = telemetry.registry()
    up0 = reg.value("gateway_scale_events_total", direction="up")
    dn0 = reg.value("gateway_scale_events_total", direction="down")
    out, pool, sc = _drive(Autoscaler, AutoscalePolicy)
    assert out[:7] == [None, "up", None, "up", None, None, "down"]
    assert pool.calls[:3] == [2, 3, 2]
    assert reg.value("gateway_scale_events_total",
                     direction="up") - up0 == 2
    assert reg.value("gateway_scale_events_total",
                     direction="down") - dn0 == len(pool.calls) - 2
    dirs = [d["direction"] for d in sc.decisions]
    assert dirs[:3] == ["up", "up", "down"]
    assert sc.decisions[0]["pressure"] == 9.0
    assert sc.decisions[1]["p99_ms"] == 80.0
    assert pool.n >= 1


def test_autoscaler_decides_as_the_reference():
    """The same injected load and fake clock through both packages'
    autoscalers: the same decisions, the same scale calls and the same
    decision records."""
    got, pool, sc = _drive(Autoscaler, AutoscalePolicy)
    want, jpool, jsc = _drive(j_autoscale.Autoscaler,
                              j_autoscale.AutoscalePolicy)
    assert got == want
    assert pool.calls == jpool.calls
    assert sc.decisions == jsc.decisions
    assert sc.describe() == jsc.describe()


def test_autoscaler_scales_real_replica_set(model, plan):
    """scale_to on a live ReplicaSet adds a serving replica that takes
    traffic, and scaling down drains without dropping accepted work;
    the replica engines prune their per-request bookkeeping."""
    rs = ReplicaSet(_factory(model), 1)
    try:
        assert rs.size == 1
        rs.scale_to(2)
        assert rs.size == 2
        assert telemetry.registry().value("gateway_replicas") == 2
        got = {i: [] for i in range(4)}
        finished = {}
        tickets = []
        for i, job in enumerate(plan[4:]):
            req = Request(prompt=job["prompt"], max_new_tokens=job["mnew"],
                          seed=job["seed"], temperature=job["temperature"],
                          top_k=job.get("top_k"),
                          on_token=(lambda i: lambda rid, tok:
                                    got[i].append(tok))(i),
                          on_done=(lambda i: lambda rid, r:
                                   finished.setdefault(i, r))(i))
            tickets.append(rs.route(req))
        rs.scale_to(1)
        assert rs.size == 1
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline and len(finished) < 4:
            time.sleep(0.02)
        assert len(finished) == 4 and set(finished.values()) == \
            {"complete"}
        for i, job in enumerate(plan[4:]):
            assert got[i] == _job_ref(model, job)
        for t in tickets:
            eng = t.replica.engine
            assert t.rid not in eng._results
            assert t.rid not in eng._requests
    finally:
        rs.close()


def test_interval_p99_windows():
    """The latency signal is per window, as the reference computes it."""
    bounds = (1.0, 2.0, 4.0, 8.0)
    assert interval_p99(bounds, None, [0, 0, 0, 0, 0]) is None
    prev = [10, 0, 0, 0, 0]
    cur = [10, 0, 0, 5, 0]
    p = interval_p99(bounds, prev, cur)
    assert 4.0 < p <= 8.0
    assert p == j_autoscale.interval_p99(bounds, prev, cur)
    assert interval_p99(bounds, cur, cur) is None


# ---------------------------------------------------------------------------
# across the packages: wire frames and a mixed KV channel
# ---------------------------------------------------------------------------
def _handoffs(dtype):
    """The same handoff in both packages' host forms: bf16 as a CPU
    tensor in the port and as ml_dtypes' bfloat16 in the reference."""
    rng = np.random.default_rng(5)
    k = rng.normal(size=(2, 2, 16, 4)).astype(np.float32)
    v = rng.normal(size=(2, 2, 16, 4)).astype(np.float32)
    key = np.asarray([7, 9], np.uint32)
    if dtype == "float32":
        return (KVHandoff(k=k, v=v, true_len=11, token=5, rng=key),
                JKVHandoff(k=k, v=v, true_len=11, token=5, rng=key))
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    jk, jv = (t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
              for t in (tk, tv))
    return (KVHandoff(k=tk, v=tv, true_len=11, token=5, rng=key),
            JKVHandoff(k=jk, v=jv, true_len=11, token=5, rng=key))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_frames_byte_equal_to_the_reference(dtype):
    """handoff_to_wire and handoff_to_page_frames of one handoff,
    encoded by each package's rpc, are the same bytes."""
    th, jh = _handoffs(dtype)
    assert bytes(rpc.encode(disagg.handoff_to_wire(3, th))) == \
        bytes(j_rpc.encode(j_disagg.handoff_to_wire(3, jh)))
    tf = disagg.handoff_to_page_frames(3, th, 8)
    jf = j_disagg.handoff_to_page_frames(3, jh, 8)
    assert len(tf) == len(jf) == 3
    for a, b in zip(tf, jf):
        assert bytes(rpc.encode(a)) == bytes(j_rpc.encode(b))


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy() \
            if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_frames_decode_across_the_packages(dtype, writer):
    """A frame written by either package decodes in the other to equal
    arrays; the one-shot frame and the page frames both reassemble to
    the handoff's block and scalars."""
    th, jh = _handoffs(dtype)
    if writer == "port":
        one = bytes(rpc.encode(disagg.handoff_to_wire(4, th)))
        pages = [bytes(rpc.encode(f))
                 for f in disagg.handoff_to_page_frames(4, th, 8)]
        dec, to_handoff = j_rpc.decode, j_disagg.wire_to_handoff
        buf_cls = j_disagg._PageBuffer
    else:
        one = bytes(j_rpc.encode(j_disagg.handoff_to_wire(4, jh)))
        pages = [bytes(j_rpc.encode(f))
                 for f in j_disagg.handoff_to_page_frames(4, jh, 8)]
        dec, to_handoff = rpc.decode, disagg.wire_to_handoff
        buf_cls = disagg._PageBuffer
    rid, h = to_handoff(dec(one))
    buf = buf_cls()
    frames = [dec(p) for p in pages]
    for f in frames[:-1]:
        buf.add(f[2], f[3], f[4])
    prid, ph = buf.finish(frames[-1])
    assert rid == prid == 4
    for got in (h, ph):
        assert (got.true_len, got.token) == (11, 5)
        np.testing.assert_array_equal(np.asarray(got.rng), th.rng)
        np.testing.assert_array_equal(_bits(got.k)[:, :, :16],
                                      _bits(th.k))
        np.testing.assert_array_equal(_bits(got.v)[:, :, :16],
                                      _bits(th.v))


def test_mixed_package_kv_channel_handshake_and_handoffs():
    """A reference KVChannel and a port KVChannel on the two ends of one
    socketpair: the HMAC hello handshake completes in both directions of
    dial, and acked handoffs cross both ways byte-exact."""
    th, jh = _handoffs("bfloat16")
    for port_dials in (True, False):
        a, b = socket.socketpair()
        a.settimeout(WAIT)
        b.settimeout(WAIT)
        secret = b"mixed-kv"
        port_side = KVChannel(a, secret=secret)
        ref_side = j_disagg.KVChannel(b, secret=secret)
        dial, answer = ((KVChannel._handshake_client, a),
                        (j_disagg.KVChannel._handshake_server, b)) \
            if port_dials else \
            ((j_disagg.KVChannel._handshake_client, b),
             (KVChannel._handshake_server, a))
        err = []

        def serve_hello():
            try:
                answer[0](answer[1], secret)
            except Exception as e:      # reported below
                err.append(e)

        t = threading.Thread(target=serve_hello, daemon=True)
        t.start()
        dial[0](dial[1], secret)
        t.join(WAIT)
        assert not t.is_alive() and err == []
        for tx, rx, frame in (
                (port_side, ref_side, disagg.handoff_to_wire(1, th)),
                (ref_side, port_side, j_disagg.handoff_to_wire(2, jh))):
            got = {}
            t = threading.Thread(
                target=lambda: got.setdefault("m", rx.recv_handoff()),
                daemon=True)
            t.start()
            tx.send_handoff(frame)
            t.join(WAIT)
            assert not t.is_alive()
            assert got["m"][:4] == frame[:4]
            for x, y in zip(got["m"][4:], frame[4:]):
                np.testing.assert_array_equal(_bits(x), _bits(y))
        port_side.close()
        ref_side.close()
