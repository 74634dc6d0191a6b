"""The port's continuous-batching ``ServeEngine`` on the CPU.

Contracts (``tests/test_serve.py``'s and ``tests/test_gateway.py``'s
for mxtpu's engine, held on the port): a seeded Poisson stream of mixed
prompt and output lengths and mixed sampling configs gives, token for
token, each request's own batch-1 ``generate`` of the port, and four of
them (two greedy, two sampled) ``llama_refs.reference``, mxtpu's
memoized ``generate``; the streams do not depend on the slot count or
the overlap mode; churn builds one decode program and one program per
bucket; the int8 tree rides the same programs; tokens stream through
callbacks; ``submit`` refuses what ``generate`` refuses; cancel and
deadlines (on an injected clock) free slots at step boundaries; a
detached prefill handed off through ``submit_prefilled`` equals the
colocated path (a resume needs a paged engine); ``resume_key`` equals mxtpu's; the telemetry counters
stay exact with two engines on threads; a request's trace context tags
its events; the decode program holds its own RoPE tables. Every engine that meets the
reference keeps ``llama_refs``' engine shape (2 slots, ``max_len`` 32,
buckets from 4).
"""
import threading
from dataclasses import fields, replace

import jax
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu.serve import resume_key as j_resume_key
from mxtpu_torch import prng, telemetry
from mxtpu_torch.models import llama as tl
from mxtpu_torch.serve import (KVHandoff, Request, ServeEngine, bucket_for,
                               resume_key)
from mxtpu_torch.serve.engine import _DecodeGraph
from mxtpu_torch.telemetry import distributed as dtrace

torch.set_num_threads(2)   # a CPU share for each xdist worker

SHAPE = dict(max_slots=2, max_len=32, min_bucket=4, device="cpu")


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


def _poisson_requests(cfg, n, seed):
    """tests/test_serve.py's mixed stream: prompts of 3, 5 or 9 tokens,
    1-6 new ones, odd requests sampled (top_k or top_p on some)."""
    rng = np.random.default_rng(seed)
    reqs, arrival = [], 0.0
    for i in range(n):
        plen = int(rng.choice([3, 5, 9]))
        mnew = int(rng.choice([1, 2, 4, 6]))
        if i % 2:
            samp = dict(temperature=float(rng.choice([0.7, 0.9])),
                        top_k=int(rng.choice([5, 8])) if i % 4 == 1
                        else None,
                        top_p=0.8 if i % 4 == 3 else None)
        else:
            samp = dict(temperature=0.0)
        reqs.append(Request(prompt=rng.integers(0, cfg.vocab_size, plen),
                            max_new_tokens=mnew, seed=i,
                            arrival_step=int(arrival), **samp))
        arrival += rng.exponential(2.0)
    return reqs


_GENERATED = {}


def _generate(tcfg, tparams, req):
    """The port's batch-1 ``generate`` of a request (memoized; the tree
    is kept with its entry, so its id is never reused)."""
    key = (id(tparams), tuple(int(t) for t in req.prompt),
           req.max_new_tokens, req.seed, req.temperature, req.top_k,
           req.top_p)
    if key not in _GENERATED:
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32))[None]
        out = tl.generate(tcfg, tparams, prompt, req.max_new_tokens,
                          temperature=req.temperature, top_k=req.top_k,
                          top_p=req.top_p,
                          rng=prng.PRNGKey(req.seed, device="cpu"))
        _GENERATED[key] = (tparams, out[0, prompt.shape[1]:].numpy())
    return _GENERATED[key][1]


def _serve(tcfg, tparams, reqs, order=None, **kw):
    eng = ServeEngine(tcfg, tparams, **{**SHAPE, **kw})
    order = range(len(reqs)) if order is None else order
    rids = {i: eng.submit(reqs[i]) for i in order}
    res = eng.run()
    return eng, {i: res[rid] for i, rid in rids.items()}


def test_poisson_stream_matches_generate_and_the_reference(model):
    """10 requests, seeded Poisson arrivals: every stream equals the
    port's batch-1 generate; two greedy and two sampled ones equal
    mxtpu's generate."""
    jcfg, jparams, tcfg, tparams = model
    reqs = _poisson_requests(tcfg, 10, seed=0)
    eng, got = _serve(tcfg, tparams, reqs)
    assert eng.compile_count <= eng.n_buckets + 1
    for i, r in enumerate(reqs):
        assert got[i].dtype == np.int32
        np.testing.assert_array_equal(
            got[i], _generate(tcfg, tparams, r), err_msg=f"request {i}")
    greedy = [i for i, r in enumerate(reqs) if not r.temperature][:2]
    sampled = [i for i, r in enumerate(reqs) if r.temperature][:2]
    for i in greedy + sampled:
        r = reqs[i]
        ref = llama_refs.reference(jcfg, jparams, r.prompt, r.max_new_tokens,
                                   seed=r.seed, temperature=r.temperature,
                                   top_k=r.top_k, top_p=r.top_p)
        assert list(got[i]) == ref, f"request {i}"
    lat = eng.latency_stats()
    assert lat["n_gaps"] > 0
    assert lat["p99_token_ms"] >= lat["p50_token_ms"] >= 0.0


@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("overlap", [True, False])
def test_streams_do_not_depend_on_the_schedule(model, slots, overlap):
    """The same requests through 1-3 slots, overlapped or not, submitted
    in reverse: each stream is its own batch-1 generate."""
    _, _, tcfg, tparams = model
    reqs = _poisson_requests(tcfg, 8, seed=4)
    _, got = _serve(tcfg, tparams, reqs, order=reversed(range(8)),
                    max_slots=slots, overlap=overlap)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(got[i], _generate(tcfg, tparams, r))


def test_churn_builds_one_decode_program(model):
    """20 requests churning through 2 slots: one decode program and one
    prefill program per bucket."""
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(9)
    reqs = [Request(prompt=rng.integers(0, tcfg.vocab_size,
                                        int(rng.choice([3, 6, 11, 20]))),
                    max_new_tokens=int(rng.choice([1, 3, 5])),
                    arrival_step=i, seed=i) for i in range(20)]
    eng, got = _serve(tcfg, tparams, reqs, max_len=48)
    assert all(len(got[i]) == r.max_new_tokens for i, r in enumerate(reqs))
    buckets = {bucket_for(len(r.prompt), 4, 48) for r in reqs}
    assert eng.n_buckets == len(buckets)
    assert eng.compile_count == len(buckets) + 1
    assert eng._decode.steps == eng.steps_run > 20
    assert eng._decode.captures == 0          # the CPU runs no graph
    assert eng.load() == {"queued": 0, "active": 0, "slots": 2}


def test_int8_tree_rides_the_same_programs(model):
    _, _, tcfg, tparams = model
    q = tl.quantize_params_int8(tcfg, tparams)
    reqs = _poisson_requests(tcfg, 6, seed=2)
    eng, got = _serve(tcfg, q, reqs, max_slots=3)
    assert eng.compile_count <= eng.n_buckets + 1
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(got[i], _generate(tcfg, q, r))


def test_streaming_callbacks_and_validation(model):
    """Per-token callbacks stream in order and slots recycle (more
    requests than slots); submit() refuses what generate refuses."""
    _, _, tcfg, tparams = model
    streamed = []
    reqs = [Request(prompt=np.arange(4) + i, max_new_tokens=3, seed=i,
                    on_token=lambda rid, tok: streamed.append((rid, tok)))
            for i in range(5)]
    eng = ServeEngine(tcfg, tparams, **{**SHAPE, "max_len": 16})
    rids = [eng.submit(r) for r in reqs]
    res = eng.run()
    for rid in rids:
        assert [t for r, t in streamed if r == rid] == list(res[rid])
    bad = [dict(prompt=np.arange(4), max_new_tokens=0),
           dict(prompt=np.arange(30), max_new_tokens=5),
           dict(prompt=np.arange(4), max_new_tokens=2, top_p=1.5),
           dict(prompt=np.arange(4), max_new_tokens=2, top_k=0),
           dict(prompt=np.asarray([], np.int32), max_new_tokens=2)]
    for kw in bad:
        with pytest.raises(ValueError):
            eng.submit(Request(**kw))


def test_bucket_policy():
    assert bucket_for(1, 4, 64) == 4
    assert bucket_for(4, 4, 64) == 4
    assert bucket_for(5, 4, 64) == 8
    assert bucket_for(33, 4, 64) == 64
    assert bucket_for(50, 4, 60) == 60      # capped at max_len
    with pytest.raises(ValueError):
        bucket_for(65, 4, 64)


def test_cancel_frees_the_slot_and_counts(model):
    """cancel() from a token callback after 3 tokens: the slot frees at a
    step boundary, the partial stream is a prefix of generate's, the
    queued request then takes the slot, and a queued rid cancels without
    a slot; serve_cancelled_total{cancel} counts both."""
    _, _, tcfg, tparams = model
    reg = telemetry.registry()
    before = reg.value("serve_cancelled_total", reason="cancel")
    eng = ServeEngine(tcfg, tparams, **{**SHAPE, "max_slots": 1})
    done, box = {}, {}

    def on_tok(rid, tok):
        if len(eng._results[rid]) >= 3:
            eng.cancel(box["rid"])
    long_req = Request(prompt=np.arange(4), max_new_tokens=20, seed=1,
                       on_token=on_tok,
                       on_done=lambda rid, r: done.setdefault(rid, r))
    box["rid"] = eng.submit(long_req)
    queued = Request(prompt=np.arange(5), max_new_tokens=2, seed=2,
                     on_done=lambda rid, r: done.setdefault(rid, r))
    qrid = eng.submit(queued)
    crid = eng.submit(Request(prompt=np.arange(3), max_new_tokens=2,
                              arrival_step=10 ** 6,
                              on_done=lambda rid, r:
                              done.setdefault(rid, r)))
    assert eng.cancel(crid, "cancel")
    res = eng.run()
    n = len(res[box["rid"]])
    assert 3 <= n < 20 and done[box["rid"]] == "cancel"
    np.testing.assert_array_equal(res[box["rid"]],
                                  _generate(tcfg, tparams, long_req)[:n])
    np.testing.assert_array_equal(res[qrid],
                                  _generate(tcfg, tparams, queued))
    assert done[qrid] == "complete"
    assert len(res[crid]) == 0 and done[crid] == "cancel"
    assert reg.value("serve_cancelled_total", reason="cancel") - before == 2
    assert not eng.cancel(qrid) and not eng.cancel(12345)
    assert eng.load()["active"] == 0


def test_deadline_on_an_injected_clock(model):
    """A request whose budget expires mid-decode frees its slot at the
    next step boundary (reason 'deadline'); one that never expires is
    untouched."""
    _, _, tcfg, tparams = model
    reg = telemetry.registry()
    before = reg.value("serve_cancelled_total", reason="deadline")
    now = {"t": 100.0}
    eng = ServeEngine(tcfg, tparams, **SHAPE, clock=lambda: now["t"])
    done = {}

    def tick(rid, tok):
        if len(eng._results[rid]) >= 4:
            now["t"] = 200.0
    r1 = eng.submit(Request(prompt=np.arange(4), max_new_tokens=16, seed=5,
                            deadline_s=50.0, on_token=tick,
                            on_done=lambda rid, r: done.setdefault(rid, r)))
    keep = Request(prompt=np.arange(6), max_new_tokens=5, seed=6,
                   deadline_s=10 ** 6,
                   on_done=lambda rid, r: done.setdefault(rid, r))
    r2 = eng.submit(keep)
    res = eng.run()
    assert done[r1] == "deadline" and 4 <= len(res[r1]) < 16
    assert done[r2] == "complete"
    np.testing.assert_array_equal(res[r2], _generate(tcfg, tparams, keep))
    assert reg.value("serve_cancelled_total",
                     reason="deadline") - before == 1
    assert eng.load()["active"] == 0


def test_submit_prefilled_equals_the_colocated_path(model):
    """prefill_detached's block, token and key as a KVHandoff (host
    arrays), seated by inject: the same stream as submit()."""
    _, _, tcfg, tparams = model
    reqs = [Request(prompt=np.arange(5) + 7, max_new_tokens=6, seed=11),
            Request(prompt=np.arange(9) + 3, max_new_tokens=4, seed=12,
                    temperature=0.9, top_k=8)]
    _, colocated = _serve(tcfg, tparams, reqs)
    eng = ServeEngine(tcfg, tparams, **SHAPE)
    rids = []
    for r in reqs:
        n = len(r.prompt)
        bucket = bucket_for(n, 4, 32)
        pad = torch.zeros((1, bucket), dtype=torch.int32)
        pad[0, :n] = torch.as_tensor(r.prompt)
        tok, kb, vb, rng = tl.prefill_detached(
            tcfg, tparams, pad, n, prng.PRNGKey(r.seed, device="cpu"),
            r.temperature, r.top_k, r.top_p)
        h = KVHandoff(k=kb.numpy(), v=vb.numpy(), true_len=n,
                      token=int(tok[0]), rng=prng.key_to_numpy(rng))
        rids.append(eng.submit_prefilled(h, r))
    res = eng.run()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(res[rid], colocated[i])
    assert len(eng._injects) == eng.n_buckets == 2 and not eng._prefills
    assert eng.compile_count == 3
    h = KVHandoff(k=np.zeros((2, 2, 64, 16), np.float32), v=None,
                  true_len=3, token=0, rng=np.zeros(2, np.uint32))
    with pytest.raises(ValueError, match="bucket"):
        eng.submit_prefilled(h, Request(prompt=np.arange(3),
                                        max_new_tokens=2))
    with pytest.raises(ValueError, match="paged"):
        eng.submit_prefilled(replace(h, k=np.zeros((2, 2, 4, 16))),
                             Request(prompt=np.arange(5),
                                     max_new_tokens=2))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_resume_key_matches_mxtpu(seed):
    """resume_key(seed, n) is the key after n carry-half splits: the
    reference's, and what a resumed prefill takes as Request.rng."""
    for n in (0, 1, 2, 5, 17):
        got = resume_key(seed, n)
        assert got.dtype == np.uint32 and got.shape == (2,)
        np.testing.assert_array_equal(got, j_resume_key(seed, n))


def test_a_resumed_request_continues_the_stream(model):
    """Re-prefilling prompt + the first k emitted tokens with
    resume_key(seed, k) gives the rest of the fault-free stream."""
    _, _, tcfg, tparams = model
    full = Request(prompt=np.arange(4) + 20, max_new_tokens=8, seed=3,
                   temperature=0.8, top_p=0.9)
    want = _generate(tcfg, tparams, full)
    k = 3
    resumed = Request(prompt=np.concatenate([full.prompt, want[:k]]),
                      max_new_tokens=8 - k, seed=3, temperature=0.8,
                      top_p=0.9, rng=resume_key(3, k))
    _, got = _serve(tcfg, tparams, [resumed])
    np.testing.assert_array_equal(got[0], want[k:])


def test_telemetry_counters_exact_across_two_engines_on_threads(model):
    """Two engines on threads feed the process-wide registry: token and
    request counters exact, streams equal, spans and admission waits
    recorded, one decode program each."""
    _, _, tcfg, tparams = model
    reg = telemetry.registry()
    before_tok = reg.value("serve_tokens_total")
    before_req = reg.value("serve_requests_total")
    reqs = _poisson_requests(tcfg, 6, seed=3)
    results = {}

    def run_one(idx):
        results[idx] = _serve(tcfg, tparams, reqs)

    threads = [threading.Thread(target=run_one, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and len(results) == 2
    for i in results[0][1]:
        np.testing.assert_array_equal(results[0][1][i], results[1][1][i])
    total = sum(len(v) for _, res in results.values() for v in res.values())
    assert reg.value("serve_tokens_total") - before_tok == total
    assert reg.value("serve_requests_total") - before_req == 12
    assert reg.get("serve_admission_wait_steps").count >= 12
    assert reg.get("span_serve_decode_dispatch_ms").count > 0
    assert reg.get("span_serve_prefill_ms").count >= 12
    for eng, _ in results.values():
        assert eng.compile_count == eng.n_buckets + 1
        assert eng.latency_stats()["n_gaps"] > 0
        eng.reset_stats()
        assert eng.latency_stats()["n_gaps"] == 0 and eng.steps_run == 0
        stats = eng.kv_cache_stats()
        assert stats["reserved_bytes"] == 2 * 2 * 2 * 2 * 32 * 16 * 4
        assert stats["active"] == 0 and stats["occupancy"] == 0.0


def test_run_forever_serves_and_drains(model):
    """The replica loop serves submissions from another thread and,
    once stopped, drains what it accepted."""
    _, _, tcfg, tparams = model
    eng = ServeEngine(tcfg, tparams, **SHAPE)
    stop = threading.Event()
    loop = threading.Thread(target=eng.run_forever, args=(stop,))
    loop.start()
    reqs = _poisson_requests(tcfg, 4, seed=6)
    rids = [eng.submit(replace(r, arrival_step=0)) for r in reqs]
    stop.set()
    eng.wake()
    loop.join(60)
    assert not loop.is_alive()
    for rid, r in zip(rids, reqs):
        np.testing.assert_array_equal(eng._results[rid],
                                      _generate(tcfg, tparams, r))


def test_an_engine_built_in_inference_mode_serves_on_threads(model):
    """Built under ``torch.inference_mode()`` (which is per thread), two
    engines serve from ``run_forever`` threads, outside that mode, and
    write their banks there: every stream is its batch-1 generate."""
    _, _, tcfg, tparams = model
    with torch.inference_mode():
        engines = [ServeEngine(tcfg, tparams, **SHAPE) for _ in range(2)]
    reqs = _poisson_requests(tcfg, 4, seed=8)
    rids = [[eng.submit(replace(r, arrival_step=0)) for r in reqs]
            for eng in engines]
    stop, errors = threading.Event(), []

    def serve(eng):
        try:
            eng.run_forever(stop)
        except Exception as e:
            errors.append(e)
    loops = [threading.Thread(target=serve, args=(eng,)) for eng in engines]
    for t in loops:
        t.start()
    stop.set()
    for eng in engines:
        eng.wake()
    for t in loops:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in loops)
    for eng, ids in zip(engines, rids):
        for rid, r in zip(ids, reqs):
            np.testing.assert_array_equal(eng._results[rid],
                                          _generate(tcfg, tparams, r))


def test_what_the_engine_refuses(model):
    """What mxtpu's engine refuses (a negative ``speculate_k``, and
    ``speculate_k`` without ``paged``), and what waits for a later slice
    (a mesh)."""
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="speculate_k must be >= 0"):
        ServeEngine(tcfg, tparams, **SHAPE, paged=True, speculate_k=-1)
    with pytest.raises(ValueError, match="requires paged=True"):
        ServeEngine(tcfg, tparams, **SHAPE, speculate_k=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        ServeEngine(tcfg, tparams, **SHAPE, mesh=object())
    # the card by default, and params are never moved
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tcfg, tparams, max_slots=2, max_len=32)
    moved = dict(tparams, final_norm=tparams["final_norm"].to("meta"))
    with pytest.raises(ValueError, match="meta"):
        ServeEngine(tcfg, moved, **SHAPE)


def test_request_trace_context_tags_its_events(model):
    """A request carrying a TraceContext: its seat, prefill span and
    done events carry the trace's fields, another request's do not; a
    span lands in the flight ring."""
    _, _, tcfg, tparams = model
    ctx = dtrace.mint(rid=7, seed=3)
    assert dtrace.mint(trace_id="not hex").trace_id != "not hex"
    eng = ServeEngine(tcfg, tparams, **SHAPE)
    eng.submit(Request(prompt=np.arange(4), max_new_tokens=2, seed=3,
                       ctx=ctx))
    eng.submit(Request(prompt=np.arange(5), max_new_tokens=2, seed=4))
    n0 = len(telemetry.trace_events())
    eng.run()
    events = telemetry.trace_events()[n0:]
    tagged = [e["name"] for e in events
              if e["args"].get("trace_id") == ctx.trace_id]
    assert {"serve.seat", "serve.prefill", "serve.done"} <= set(tagged)
    assert all(e["args"]["rid"] == 7 for e in events
               if e["args"].get("trace_id") == ctx.trace_id)
    untagged = [e for e in events if e["name"] == "serve.prefill"
                and "trace_id" not in e["args"]]
    assert len(untagged) == 1
    assert any(e["kind"] == "span" for e in telemetry.flight().tail(50))


def test_decode_program_holds_its_own_rope_tables(model):
    """The decode program reads RoPE tables it owns, not the shared
    cache's (which drops entries: a captured graph would read freed
    memory): steps with the cache emptied in between equal eager
    ``decode_slots`` steps, tokens and bank bit for bit."""
    _, _, tcfg, tparams = model
    banks = []
    for _ in range(2):
        st = tl.init_slot_cache(tcfg, 2, 32, device="cpu")
        kv = {n: st[n] for n in ("k", "v")}
        sv = {n: st[n] for n in ("lengths", "tokens", "rngs")}
        for slot, (plen, t) in enumerate(((3, 0.0), (6, 0.9))):
            pad = torch.zeros((1, 8), dtype=torch.int32)
            pad[0, :plen] = torch.arange(plen) + 5 * slot
            tl.prefill_slot(tcfg, tparams, pad, plen, slot, kv, sv,
                            prng.PRNGKey(slot, device="cpu"), t, None, None)
        banks.append((kv, sv))
    step = _DecodeGraph(tcfg, tparams, *banks[0])
    cos, sin = tl.rope_tables(tcfg, 32)
    assert torch.equal(step._rope[0], cos) and torch.equal(step._rope[1], sin)
    knobs = (np.array([True, True]), np.array([0.0, 0.9], np.float32),
             np.array([tcfg.vocab_size, 8], np.int32),
             np.array([1.0, 0.9], np.float32))
    for _ in range(3):
        for m in range(33, 51):            # more keys than the cache holds
            tl._rope_cached(tcfg, m, torch.device("cpu"))
        assert step._rope[0] is not tl._rope_cached(
            tcfg, 32, torch.device("cpu"))[0]
        tl._rope_cached.cache_clear()
        got = step(*knobs)
        with torch.no_grad():
            want, _, _ = tl.decode_slots(tcfg, tparams, *banks[1],
                                         *map(torch.from_numpy, knobs))
        assert torch.equal(got, want)
        for n in ("k", "v"):
            assert torch.equal(banks[0][0][n], banks[1][0][n])
        for n in ("lengths", "tokens", "rngs"):
            assert torch.equal(banks[0][1][n], banks[1][1][n])
