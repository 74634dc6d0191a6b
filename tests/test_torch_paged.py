"""The port's paged KV pool on the CPU, against mxtpu's.

Contracts (``tests/test_paged_kv.py``'s for mxtpu, held on the port):
``PageAllocator`` and ``PrefixCache`` follow mxtpu's through the same
random sequences of operations, state and refusals alike;
``paged_decode_attention`` over a shuffled pool with aliased pages
equals the port's ``slot_decode_attention`` on the dense bank it was
paged from bit for bit, and mxtpu's within 1e-6, at page sizes 3, 8 and
16 and with 1-D and per-query lengths; ``_q8_token``, ``inject_paged_kv``
and ``copy_page`` equal mxtpu's bit for bit on the same inputs;
``prefill_slot_paged`` (cold, then warm over a forked boundary page) and
``decode_slots_paged`` give mxtpu's tokens and keys, pools within 1e-5
and the int8 codes bit for bit. Engines, on ``llama_refs``' tiny f32
model and engine shape (2 slots, ``max_len`` 32, buckets from 4) with
page_size 8: streams equal ``llama_refs.reference`` token for token with
prefix hits and a copy-on-write fork, under pool backpressure, when a
warm hit meets an exhausted pool, and through a journaled resume; a
trimmed handoff injects at its bucket; int8 pages are deterministic; a
paged engine serves a Poisson stream exactly as the dense one does.
"""
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu.models import llama as jl
from mxtpu.ops.attention import paged_decode_attention as j_paged_attention
from mxtpu.serve.engine import PageAllocator as JPageAllocator
from mxtpu.serve.engine import PrefixCache as JPrefixCache
from mxtpu_torch import prng
from mxtpu_torch.models import llama as tl
from mxtpu_torch.ops.attention import (paged_decode_attention,
                                       slot_decode_attention)
from mxtpu_torch.serve import (KVHandoff, PageAllocator, PrefixCache,
                               Request, ServeEngine, bucket_for, resume_key)

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPE = dict(max_slots=2, max_len=32, min_bucket=4, device="cpu")
PS = 8                      # tests/test_paged_kv.py's page size
SHARED = [7, 3, 9, 1, 5, 2, 8, 4, 6]    # 9 tokens: a page and one more


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


def _engine(tcfg, tparams, **kw):
    return ServeEngine(tcfg, tparams, **{**SHAPE, "paged": True,
                                         "page_size": PS, **kw})


def _reference(model, prompt, mnew, **knobs):
    jcfg, jparams, _, _ = model
    return llama_refs.reference(jcfg, jparams, prompt, mnew, **knobs)


# ---------------------------------------------------------------------------
# host: the allocator and the prefix cache follow mxtpu's
# ---------------------------------------------------------------------------
def _host_op(rng, held, prompts):
    """One random operation on (allocator, cache), as a replayable tuple."""
    op = rng.choice(["alloc", "retain", "release", "insert", "lookup",
                     "evict", "pin", "bad"])
    if op == "alloc":
        return ("alloc", int(rng.integers(-1, 5)))
    if op in ("retain", "release") and held:
        pick = rng.choice(len(held), size=min(len(held),
                                              int(rng.integers(1, 3))),
                          replace=False)
        return (op, tuple(int(held[i]) for i in pick))
    if op == "insert" and held:
        p = prompts[int(rng.integers(len(prompts)))]
        return ("insert", p, int(rng.integers(1, len(p) + 1)),
                tuple(held[:int(rng.integers(1, len(held) + 1))]))
    if op in ("lookup", "pin"):
        base = prompts[int(rng.integers(len(prompts)))]
        return (op, tuple(base[:int(rng.integers(1, len(base) + 1))])
                + tuple(int(t) for t in rng.integers(0, 9, 2)))
    if op == "evict":
        return ("evict",)
    return ("bad", int(rng.choice([0, 9])))   # scratch, or never live


def _apply(alloc, cache, op):
    """Apply ``op``; the result and any refusal, comparable across
    packages."""
    try:
        if op[0] == "alloc":
            return alloc.alloc(op[1])
        if op[0] == "retain":
            return alloc.retain(op[1])
        if op[0] == "release":
            return alloc.release(op[1])
        if op[0] == "insert":
            return cache.insert(op[1], op[2], op[3]).pages
        if op[0] == "lookup":
            e, m = cache.lookup(op[1])
            return (None if e is None else e.tokens, m)
        if op[0] == "pin":
            e, _ = cache.lookup(op[1])
            if e is not None:
                cache.pin(e)
            return None
        if op[0] == "evict":
            return cache.evict_lru()
        return alloc.retain([op[1]])
    except ValueError as err:
        return ("ValueError", str(err))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_and_prefix_cache_follow_mxtpu(seed):
    """400 random operations on a 12-page pool and a 3-entry cache:
    every grant, refusal, lookup and eviction, every refcount and the
    free stack equal mxtpu's after each step."""
    rng = np.random.default_rng(seed)
    ja, ta = JPageAllocator(12), PageAllocator(12)
    jc, tc = JPrefixCache(ja, max_entries=3), PrefixCache(ta, max_entries=3)
    prompts = [tuple(int(t) for t in rng.integers(0, 9, n))
               for n in (3, 6, 10, 10)]
    held = []
    for _ in range(400):
        op = _host_op(rng, held, prompts)
        want, got = _apply(ja, jc, op), _apply(ta, tc, op)
        assert got == want, op
        if op[0] == "alloc" and isinstance(got, list):
            held += got
        held = [p for p in held if ta.refcount(p) > 0]
        assert (ta.free_pages, ta.used_pages, ta.shared_pages) == (
            ja.free_pages, ja.used_pages, ja.shared_pages)
        assert ta._free == ja._free
        np.testing.assert_array_equal(ta._ref, ja._ref)
        assert len(tc) == len(jc) and tc.top() == jc.top()
    with pytest.raises(ValueError, match="scratch"):
        PageAllocator(1)


# ---------------------------------------------------------------------------
# attention over the pool
# ---------------------------------------------------------------------------
def _paged_bank(rng, S, hkv, cap, hd, ps):
    """A random dense bank and the same bank paged into a shuffled pool
    (page 0 scratch), slot 1's first two pages aliasing slot 0's."""
    P = cap // ps
    k = rng.standard_normal((S, hkv, cap, hd)).astype(np.float32)
    v = rng.standard_normal((S, hkv, cap, hd)).astype(np.float32)
    k[1, :, :2 * ps], v[1, :, :2 * ps] = k[0, :, :2 * ps], v[0, :, :2 * ps]
    table = rng.permutation(np.arange(1, 1 + S * P)).reshape(S, P)
    table = table.astype(np.int32)
    table[1, :2] = table[0, :2]
    kp = np.zeros((1 + S * P, hkv, ps, hd), np.float32)
    vp = np.zeros_like(kp)
    for s in range(S):
        for j in range(P):
            kp[table[s, j]] = k[s, :, j * ps:(j + 1) * ps]
            vp[table[s, j]] = v[s, :, j * ps:(j + 1) * ps]
    return k, v, kp, vp, table


@pytest.mark.parametrize("ps", [3, 8, 16])
@pytest.mark.parametrize("sq", [1, 3])
def test_paged_attention_equals_slot_attention_and_mxtpu(ps, sq):
    """GQA 4:1 over 48 keys: with 1-D lengths (0 and 48 among them) or
    per-query ones, at kv_block 16, 13 (a page size that does not divide
    it) and 512, bit for bit with the dense slot attention and within
    1e-6 of mxtpu's paged attention."""
    rng = np.random.default_rng(ps * 10 + sq)
    S, hq, hkv, hd, cap = 4, 8, 2, 16, 48
    k, v, kp, vp, table = _paged_bank(rng, S, hkv, cap, hd, ps)
    q = rng.standard_normal((S, hq, sq, hd)).astype(np.float32)
    if sq == 1:
        lengths = np.array([0, 48, 17, 5], np.int32)
    else:
        lengths = np.minimum(np.array([0, 45, 17, 5])[:, None]
                             + np.arange(sq), cap).astype(np.int32)
    for kv_block in (16, 13, 512):
        dense = slot_decode_attention(
            *map(torch.from_numpy, (q, k, v, lengths)), kv_block=kv_block)
        got = paged_decode_attention(
            *map(torch.from_numpy, (q, kp, vp, table, lengths)),
            kv_block=kv_block)
        assert torch.equal(got, dense), kv_block
        want = j_paged_attention(*map(jnp.asarray, (q, kp, vp, table,
                                                     lengths)),
                                 kv_block=kv_block)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)
    # the aliased prefix reads the same keys in both slots
    same = paged_decode_attention(
        torch.from_numpy(np.repeat(q[:1], 2, 0)), torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(table[:2]),
        torch.full((2,), 2 * ps, dtype=torch.int32))
    assert torch.equal(same[0], same[1])
    with pytest.raises(ValueError, match="page_table rows"):
        paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                               torch.from_numpy(vp),
                               torch.from_numpy(table[:2]),
                               torch.from_numpy(lengths))


def test_q8_token_matches_mxtpu():
    """Codes and scales bit for bit, on values that put x / s on .5
    boundaries (round half to even), an all-zero row (the 1e-8 floor)
    and a clipped extreme."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 3, 16)).astype(np.float32)
    x[0, 0] = np.arange(16) - 7.5            # max 8.5: many .5 ratios
    x[0, 1] = 0.0
    x[0, 2, 0] = 1e30
    x[1] = np.round(x[1] * 4) / 4
    q, s = tl._q8_token(torch.from_numpy(x))
    jq, js = jl._q8_token(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# the paged programs against mxtpu's on the same pool
# ---------------------------------------------------------------------------
N_PAGES = 1 + 2 * (32 // PS)


def _both_pools(jcfg, tcfg, int8):
    js = jl.init_paged_cache(jcfg, 2, N_PAGES, PS, int8=int8)
    ts = tl.init_paged_cache(tcfg, 2, N_PAGES, PS, int8=int8, device="cpu")
    names = ("k", "v", "ks", "vs") if int8 else ("k", "v")
    vec = ("lengths", "tokens", "rngs")
    for n in names + vec:
        assert tuple(ts[n].shape) == tuple(js[n].shape), n
    return ({n: js[n] for n in names}, {n: js[n] for n in vec},
            {n: ts[n] for n in names}, {n: ts[n] for n in vec})


def _same_pools(jkv, tkv, exact=False):
    """Pools within 1e-5 (bit for bit with ``exact``); int8 codes always
    bit for bit."""
    for n in jkv:
        want, got = np.asarray(jkv[n]), tkv[n].numpy()
        if exact or got.dtype == np.int8:
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=n)


def _same_vectors(jsv, tsv):
    np.testing.assert_array_equal(tsv["lengths"].numpy(),
                                  np.asarray(jsv["lengths"]))
    np.testing.assert_array_equal(tsv["tokens"].numpy(),
                                  np.asarray(jsv["tokens"]))
    np.testing.assert_array_equal(prng.key_to_numpy(tsv["rngs"]),
                                  np.asarray(jsv["rngs"]))


def test_init_paged_cache_and_its_refusals(model):
    _, _, tcfg, _ = model
    st = tl.init_paged_cache(tcfg, 2, 5, PS, int8=True, device="cpu")
    assert st["k"].dtype == torch.int8 and st["ks"].dtype == torch.float32
    assert tuple(st["ks"].shape) == (tcfg.n_layers, 5, tcfg.n_kv_heads, PS)
    assert bool((st["ks"] == 1).all()) and st["rngs"].dtype == torch.int64
    st = tl.init_paged_cache(tcfg, 2, 5, PS, device="cpu")
    assert st["k"].dtype == tcfg.dtype and "ks" not in st
    with pytest.raises(NotImplementedError, match="item 11"):
        tl.init_paged_cache(tcfg, 2, 5, PS, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        tl.paged_cache_specs(tcfg, object())


@pytest.mark.parametrize("int8", [False, True])
def test_inject_and_copy_page_match_mxtpu_bit_for_bit(model, int8):
    """The same handed-off block (a bucket of 12: a page and a half of
    pad) injected by both packages, then a fork of its second page: the
    pools and slot vectors equal, bit for bit."""
    jcfg, _, tcfg, _ = model
    jkv, jsv, tkv, tsv = _both_pools(jcfg, tcfg, int8)
    rng = np.random.default_rng(5)
    shape = (tcfg.n_layers, tcfg.n_kv_heads, 12, tcfg.head_dim)
    kb = rng.standard_normal(shape).astype(np.float32)
    vb = rng.standard_normal(shape).astype(np.float32)
    row = np.array([3, 7, 0, 0], np.int32)
    key = prng.key_to_numpy(prng.PRNGKey(11, device="cpu"))
    jkv, jsv = jl.inject_paged_kv(jcfg, jnp.asarray(kb), jnp.asarray(vb),
                                  10, jnp.asarray(row), 1, 42,
                                  jnp.asarray(key), jkv, jsv)
    tl.inject_paged_kv(tcfg, kb, vb, 10, row, 1, 42,
                       prng.key_from_numpy(key, "cpu"), tkv, tsv)
    _same_pools(jkv, tkv, exact=True)
    _same_vectors(jsv, tsv)
    jkv = jl.copy_page(jkv, 7, 5)
    assert tl.copy_page(tkv, 7, torch.tensor(5)) is tkv
    _same_pools(jkv, tkv, exact=True)
    assert torch.equal(tkv["k"][:, 5], tkv["k"][:, 7])


def _admit(model, jkv, jsv, tkv, tsv, prompt, prefix_len, row, slot, seed,
           knobs):
    """``prefill_slot_paged`` of ``prompt[prefix_len:]`` by both packages:
    the first tokens equal, the pools within 1e-5 (codes bit for bit)."""
    jcfg, jparams, tcfg, tparams = model
    suffix = prompt[prefix_len:]
    bucket = bucket_for(len(suffix), 4, 32)
    pad = np.zeros((1, bucket), np.int32)
    pad[0, :len(suffix)] = suffix
    jtok, jkv, jsv = jl.prefill_slot_paged(
        jcfg, jparams, jnp.asarray(pad), len(prompt), prefix_len,
        jnp.asarray(row), slot, jkv, jsv, jax.random.PRNGKey(seed), *knobs)
    ttok, _, _ = tl.prefill_slot_paged(
        tcfg, tparams, torch.from_numpy(pad), len(prompt), prefix_len, row,
        slot, tkv, tsv, prng.PRNGKey(seed, device="cpu"), *knobs)
    assert ttok.dtype == torch.int32 and ttok.shape == (1,)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _same_pools(jkv, tkv)
    _same_vectors(jsv, tsv)
    return jkv, jsv


@pytest.mark.parametrize("int8", [False, True])
def test_paged_prefill_and_decode_match_mxtpu(model, int8):
    """A cold admission of SHARED + 2 tokens into slot 0 (pages 1, 2, 3),
    then a warm one of SHARED + 1 into slot 1 sharing page 1 and a fork
    of page 2 into page 4 (prefix 9, suffix bucket 4), then three mixed
    greedy/sampled decode steps, slot 1 inactive on the last: tokens,
    keys and lengths equal, pools within 1e-5, int8 codes bit for bit."""
    jcfg, jparams, tcfg, tparams = model
    jkv, jsv, tkv, tsv = _both_pools(jcfg, tcfg, int8)
    table = np.array([[1, 2, 3, 0], [1, 4, 5, 0]], np.int32)
    jkv, jsv = _admit(model, jkv, jsv, tkv, tsv, SHARED + [11, 12], 0,
                      table[0], 0, 3, (0.0, None, None))
    jkv = jl.copy_page(jkv, 2, 4)
    tl.copy_page(tkv, 2, 4)
    jkv, jsv = _admit(model, jkv, jsv, tkv, tsv, SHARED + [13], 9,
                      table[1], 1, 4, (0.8, 5, 0.9))
    knobs = (np.array([0.0, 0.8], np.float32), np.array([256, 5], np.int32),
             np.array([1.0, 0.9], np.float32))
    step = jax.jit(lambda kv, sv, a, pt: jl.decode_slots_paged(
        jcfg, jparams, kv, sv, a, pt, *knobs))
    for i in range(3):
        active = np.array([True, i < 2])
        live = table * active[:, None]   # an inactive slot's row is zeroed
        jtok, jkv, jsv = step(jkv, jsv, active, jnp.asarray(live))
        ttok, _, _ = tl.decode_slots_paged(
            tcfg, tparams, tkv, tsv, torch.from_numpy(active),
            torch.from_numpy(live), *map(torch.from_numpy, knobs))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        _same_vectors(jsv, tsv)
    # page 0 took slot 1's last write, and its value is unspecified
    _same_pools({n: a[:, 1:] for n, a in jkv.items()},
                {n: a[:, 1:] for n, a in tkv.items()})
    np.testing.assert_array_equal(tsv["lengths"].numpy(), [14, 12])


# ---------------------------------------------------------------------------
# engines against the reference, token for token
# ---------------------------------------------------------------------------
def _tokens(out, rid):
    return [int(t) for t in out[rid]]


def test_paged_engine_equals_reference_with_prefix_sharing(model):
    """tests/test_paged_kv.py's four requests (three share a 9-token
    prompt, so the later ones hit the registered prefix and fork its
    boundary page), then a warm wave: every stream is the reference's,
    and the engine built its buckets, the decode step and the page
    copy, no more."""
    _, _, tcfg, tparams = model
    reqs = [dict(prompt=SHARED + [11, 12], max_new_tokens=6,
                 temperature=1.0, seed=0),
            dict(prompt=SHARED + [13], max_new_tokens=6, temperature=1.0,
                 seed=1),
            dict(prompt=[21, 22, 23], max_new_tokens=5, temperature=0.0),
            dict(prompt=SHARED + [14, 15], max_new_tokens=4,
                 temperature=1.0, top_k=8, seed=3)]
    e = _engine(tcfg, tparams)
    rids = [e.submit(Request(**r)) for r in reqs]
    out = e.run()
    for rid, r in zip(rids, reqs):
        assert _tokens(out, rid) == _reference(
            model, r["prompt"], r["max_new_tokens"], seed=r.get("seed", 0),
            temperature=r["temperature"], top_k=r.get("top_k")), r
    st = e.kv_cache_stats()
    assert st["prefix_hits"] >= 1 and st["cow_forks"] >= 1, st
    assert st["prefix_entries"] >= 1 and st["paged"], st
    assert e.compile_count <= e.n_buckets + 2, (e.compile_count,
                                               e.n_buckets)
    assert e._decode.captures == 0          # the CPU runs no graph
    p2 = SHARED + [31]
    rid = e.submit(Request(prompt=p2, max_new_tokens=5, temperature=1.0,
                           seed=7))
    assert _tokens(e.run(), rid) == _reference(model, p2, 5, seed=7,
                                               temperature=1.0)
    st2 = e.kv_cache_stats()
    assert st2["prefix_hits"] > st["prefix_hits"]
    assert st2["active"] == 0 and st2["pages_shared"] >= 1, st2
    assert st2["pages_free"] + st2["pages_used"] == st2["pages_total"]


def test_pool_exhaustion_backpressures_and_drains(model):
    """Five usable pages, under two full slots: admissions queue until
    completions free pages, and every stream is still the reference's."""
    _, _, tcfg, tparams = model
    e = _engine(tcfg, tparams, n_pages=6, prefix_cache=False)
    reqs = [([41, 42, 43], 4, 0), ([44, 45], 4, 1), ([46], 4, 2)]
    rids = [e.submit(Request(prompt=p, max_new_tokens=m, temperature=1.0,
                             seed=s)) for p, m, s in reqs]
    out = e.run()
    for rid, (p, m, s) in zip(rids, reqs):
        assert _tokens(out, rid) == _reference(model, p, m, seed=s,
                                               temperature=1.0)
    st = e.kv_cache_stats()
    assert st["pages_used"] == 0 and st["prefix_misses"] == 0


def test_warm_hit_under_pool_exhaustion_stays_safe(model):
    """Three usable pages: request A takes them all (two row pages and
    the registered boundary copy); a warm request B matching A's entry
    cannot fit even the warm plan, so the planner drops the share, evicts
    the entry and admits B cold: both streams the reference's, and B's
    prompt registered in A's place."""
    _, _, tcfg, tparams = model
    e = _engine(tcfg, tparams, n_pages=4)
    ra = e.submit(Request(prompt=SHARED, max_new_tokens=4, temperature=1.0,
                          seed=0))
    assert _tokens(e.run(), ra) == _reference(model, SHARED, 4, seed=0,
                                              temperature=1.0)
    assert e.kv_cache_stats()["prefix_entries"] == 1
    p2 = SHARED + [77, 78]
    rb = e.submit(Request(prompt=p2, max_new_tokens=5, temperature=1.0,
                          seed=1))
    assert _tokens(e.run(), rb) == _reference(model, p2, 5, seed=1,
                                              temperature=1.0)
    st = e.kv_cache_stats()
    assert st["prefix_entries"] == 1 and st["prefix_hits"] == 0, st


def _handoff(model, prompt, seed, bucket, temperature=1.0, top_k=None):
    """The port's detached prefill of ``prompt`` as a KVHandoff."""
    _, _, tcfg, tparams = model
    pad = torch.zeros((1, bucket), dtype=torch.int32)
    pad[0, :len(prompt)] = torch.as_tensor(prompt)
    tok, kb, vb, rng = tl.prefill_detached(
        tcfg, tparams, pad, len(prompt), prng.PRNGKey(seed, device="cpu"),
        temperature, top_k, None)
    return KVHandoff(k=kb.numpy(), v=vb.numpy(), true_len=len(prompt),
                     token=int(tok[0]), rng=prng.key_to_numpy(rng))


def test_paged_journaled_restore_resumes_stream(model):
    """A detached prefill's handoff, seated in a fresh paged engine
    after 2 emitted tokens with ``resume_key(seed, 2)``: the engine
    injects the block and prefills the 2 emitted tokens over it, and the
    stream goes on as the reference's. The same handoff without a resume
    takes the paged inject alone. A dense engine refuses the resume."""
    _, _, tcfg, tparams = model
    prompt, mnew, seed = [51, 52, 53, 54, 55], 6, 9
    full = _reference(model, prompt, mnew, seed=seed, temperature=1.0)
    h = _handoff(model, prompt, seed, 8)
    assert h.token == full[0]
    e = _engine(tcfg, tparams)
    rid = e.submit_prefilled(h, Request(
        prompt=prompt + full[:2], max_new_tokens=mnew - 2, temperature=1.0,
        rng=resume_key(seed, 2)))
    assert _tokens(e.run(), rid) == full[2:]
    assert e._injects == {8} and e._prefills == {4}
    e2 = _engine(tcfg, tparams)
    rid = e2.submit_prefilled(h, Request(prompt=prompt, max_new_tokens=mnew,
                                         temperature=1.0, seed=seed))
    assert _tokens(e2.run(), rid) == full and not e2._prefills
    dense = ServeEngine(tcfg, tparams, **SHAPE)
    with pytest.raises(ValueError, match="paged"):
        dense.submit_prefilled(h, Request(prompt=prompt + full[:2],
                                          max_new_tokens=2))
    with pytest.raises(ValueError, match="max_len"):
        e.submit_prefilled(h, Request(prompt=list(range(20)),
                                      max_new_tokens=13))


def test_trimmed_handoff_injects_at_its_bucket(model):
    """A handoff trimmed to the page multiple that covers its prompt
    (8 of a 16 bucket at page_size 4) is padded back to its bucket: one
    inject program a bucket, and the stream is the reference's."""
    _, _, tcfg, tparams = model
    prompt, mnew, seed = [61, 62, 63, 64, 65], 6, 3
    full = _reference(model, prompt, mnew, seed=seed, temperature=1.0)
    h = _handoff(model, prompt, seed, 16)
    trimmed = KVHandoff(k=h.k[:, :, :8], v=h.v[:, :, :8], true_len=5,
                        token=h.token, rng=h.rng)
    e = _engine(tcfg, tparams, page_size=4, min_bucket=16)
    assert e._inject_block_len(trimmed) == 16
    rid = e.submit_prefilled(trimmed, Request(
        prompt=prompt, max_new_tokens=mnew, temperature=1.0, seed=seed))
    assert _tokens(e.run(), rid) == full
    lens = {e._inject_block_len(KVHandoff(
        k=np.zeros((1, 1, min(-(-n // 4) * 4, 32), 1)), v=None,
        true_len=n, token=0, rng=None)) for n in range(1, 33)}
    assert lens <= {bucket_for(n, 16, 32) for n in range(1, 33)}


def test_int8_pages_are_deterministic(model):
    """Two engines over int8 pages serve the same stream (quantised K/V
    is not the f32 pool's, so the contract is determinism); the pool's
    reserved bytes hold the int8 codes and their f32 scales."""
    _, _, tcfg, tparams = model
    p = SHARED + [61, 62]
    outs = []
    for _ in range(2):
        e = _engine(tcfg, tparams, int8_pages=True)
        rid = e.submit(Request(prompt=p, max_new_tokens=5, temperature=1.0,
                               seed=4))
        outs.append(_tokens(e.run(), rid))
    assert outs[0] == outs[1] and len(outs[0]) == 5
    L, h, d = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    assert e.kv_cache_stats()["reserved_bytes"] == \
        2 * L * N_PAGES * h * PS * (d + 4)


def test_paged_engine_serves_the_dense_engines_streams(model):
    """A seeded stream of 8 mixed greedy and sampled requests, prompts of
    3-20 tokens, through the dense and the paged engine (both overlap
    modes): every stream equal, token for token."""
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(12)
    reqs = [Request(prompt=rng.integers(0, tcfg.vocab_size,
                                        int(rng.choice([3, 9, 20]))),
                    max_new_tokens=int(rng.choice([2, 5, 8])), seed=i,
                    arrival_step=i, **({"temperature": 0.9, "top_k": 8}
                                       if i % 2 else {}))
            for i in range(8)]
    dense = ServeEngine(tcfg, tparams, **SHAPE)
    want = [dense.submit(r) for r in reqs]
    want = [dense.run()[rid] for rid in want]
    for overlap in (True, False):
        e = _engine(tcfg, tparams, overlap=overlap)
        rids = [e.submit(r) for r in reqs]
        got = e.run()
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(got[rid], want[i])
        assert e.kv_cache_stats()["active"] == 0
