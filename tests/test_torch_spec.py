"""The port's speculative decoding on the CPU, against mxtpu's.

Contracts (``tests/test_spec_decode.py``'s for mxtpu, held on the
port): ``ngram_drafter`` equals mxtpu's on random and hand-made
histories; ``decode_slots_spec`` (a verify step over a paged pool with
drafts that are right, wrong, partly right or absent, one past the
row's capacity, one slot inactive) gives mxtpu's tokens, emission masks,
keys and lengths, pools within 1e-5 and int8 codes bit for bit. Engines,
on ``llama_refs``' tiny f32 model and engine shape with page_size 8 and
k = 3: greedy and sampled streams equal ``llama_refs.reference`` token
for token whatever the drafter proposes (the n-gram drafter on a
plateau, garbage, nothing, or the reference itself, which takes fewer
steps than tokens); a journaled resume mid-run through speculative
engines continues the stream; speculation over a shared, forked prefix
changes no token; the programs stay within buckets + 3.
"""
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu.models import llama as jl
from mxtpu.serve.engine import ngram_drafter as j_ngram_drafter
from mxtpu_torch import prng
from mxtpu_torch.models import llama as tl
from mxtpu_torch.serve import (KVHandoff, Request, ServeEngine,
                               ngram_drafter, resume_key)

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPE = dict(max_slots=2, max_len=32, min_bucket=4, device="cpu")
PS, K = 8, 3
SHARED = [7, 3, 9, 1, 5, 2, 8, 4, 6]


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
                                         "page_size": PS, "speculate_k": K,
                                         **kw})


def _reference(model, prompt, mnew, **knobs):
    jcfg, jparams, _, _ = model
    return llama_refs.reference(jcfg, jparams, prompt, mnew, **knobs)


def _tokens(out, rid):
    return [int(t) for t in out[rid]]


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------
HISTORIES = [[9, 142, 142, 142, 142], [7, 1, 2, 1, 2],
             [5, 6, 7, 8, 0, 7, 9, 5, 6, 7], [3, 4, 3, 5, 3], [1, 2, 3, 4],
             [7], [7, 7, 7], []]


@pytest.mark.parametrize("seed", [0, 1])
def test_ngram_drafter_equals_mxtpu(seed):
    """tests/test_spec_decode.py's histories (a plateau, a period, the
    longest gram, the most recent match, nothing to match) at k 0-5, and
    300 random histories over a 4-token alphabet (so grams repeat)."""
    rng = np.random.default_rng(seed)
    cases = [(h, k) for h in HISTORIES for k in range(6)]
    cases += [(list(rng.integers(0, 4, int(rng.integers(0, 30)))),
               int(rng.integers(0, 8))) for _ in range(300)]
    for h, k in cases:
        got = ngram_drafter(np.asarray(h, np.int32), k)
        want = j_ngram_drafter(np.asarray(h, np.int32), k)
        assert got.dtype == np.int32, (h, k)
        np.testing.assert_array_equal(got, want, err_msg=f"{h} {k}")


# ---------------------------------------------------------------------------
# the verify step against mxtpu's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("int8", [False, True])
def test_decode_slots_spec_matches_mxtpu(model, int8):
    """Two slots admitted cold (greedy, and sampled with top_k/top_p, 29
    tokens into its 32), then three verify steps. Slot 0 drafts the
    greedy continuation the plain step gives (all accepted), then
    nothing, then one token; slot 1 drafts garbage, then three tokens
    that reach past its row's capacity (those writes go to scratch),
    then is inactive. Tokens, emissions, keys and lengths equal mxtpu's;
    pools within 1e-5, int8 codes bit for bit."""
    jcfg, jparams, tcfg, tparams = model
    n_pages = 1 + 2 * (32 // PS)
    js = jl.init_paged_cache(jcfg, 2, n_pages, PS, int8=int8)
    ts = tl.init_paged_cache(tcfg, 2, n_pages, PS, int8=int8, device="cpu")
    names = ("k", "v", "ks", "vs") if int8 else ("k", "v")
    vec = ("lengths", "tokens", "rngs")
    jkv, jsv = {n: js[n] for n in names}, {n: js[n] for n in vec}
    tkv, tsv = {n: ts[n] for n in names}, {n: ts[n] for n in vec}
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    knobs = ((0.0, None, None), (0.8, 5, 0.9))
    for slot, plen in enumerate((5, 29)):
        pad = np.zeros((1, 32), np.int32)
        pad[0, :plen] = np.arange(plen) * 7 % 256
        jkv, jsv = jl.prefill_slot_paged(
            jcfg, jparams, jnp.asarray(pad), plen, 0,
            jnp.asarray(table[slot]), slot, jkv, jsv,
            jax.random.PRNGKey(slot), *knobs[slot])[1:]
        tl.prefill_slot_paged(tcfg, tparams, torch.from_numpy(pad), plen, 0,
                              table[slot], slot, tkv, tsv,
                              prng.PRNGKey(slot, device="cpu"),
                              *knobs[slot])
    host = (np.array([0.0, 0.8], np.float32), np.array([256, 5], np.int32),
            np.array([1.0, 0.9], np.float32))
    greedy = []
    st = {n: t.clone() for n, t in {**tkv, **tsv}.items()}
    for _ in range(K):               # slot 0's greedy continuation
        tok, _, _ = tl.decode_slots_paged(
            tcfg, tparams, {n: st[n] for n in names},
            {n: st[n] for n in vec}, torch.ones(2, dtype=torch.bool),
            torch.from_numpy(table), *map(torch.from_numpy, host))
        greedy.append(int(tok[0]))
    plan = [([greedy, [9, 9, 9]], [True, True]),
            ([[-1, -1, -1], [1, 2, 3]], [True, True]),
            ([[5, -1, -1], [-1, -1, -1]], [True, False])]
    step = jax.jit(lambda kv, sv, a, pt, d: jl.decode_slots_spec(
        jcfg, jparams, kv, sv, a, pt, d, *host))
    n_emit = []
    for drafts, active in plan:
        drafts, active = np.asarray(drafts, np.int32), np.asarray(active)
        live = table * active[:, None]
        jt, je, jkv, jsv = step(jkv, jsv, active, jnp.asarray(live),
                                jnp.asarray(drafts))
        tt, te, _, _ = tl.decode_slots_spec(
            tcfg, tparams, tkv, tsv, torch.from_numpy(active),
            torch.from_numpy(live), torch.from_numpy(drafts),
            *map(torch.from_numpy, host))
        assert tt.shape == (2, K + 1) and tt.dtype == torch.int32
        assert te.dtype == torch.bool
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        for n in vec:
            np.testing.assert_array_equal(np.asarray(tsv[n]),
                                          np.asarray(jsv[n]), err_msg=n)
        n_emit.append(te.sum(1).tolist())
    assert n_emit[0] == [K + 1, 1]           # the greedy drafts accepted
    for n in names:                          # page 0 is scratch
        want, got = np.asarray(jkv[n])[:, 1:], tkv[n][:, 1:].numpy()
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=n)


# ---------------------------------------------------------------------------
# engines against the reference, token for token
# ---------------------------------------------------------------------------
def test_spec_engine_equals_reference_on_mixed_configs(model):
    """tests/test_spec_decode.py's requests: two greedy on a prompt that
    plateaus (the n-gram drafter fires and is accepted), two sampled:
    every stream the reference's; speculation ran, and the programs are
    the buckets, the plain step, the page copy and the verify step."""
    _, _, tcfg, tparams = model
    reqs = [dict(prompt=[140, 141, 140], max_new_tokens=12,
                 temperature=0.0),
            dict(prompt=[140, 141, 140], max_new_tokens=10,
                 temperature=0.0, seed=1),
            dict(prompt=[9, 4, 7, 1, 6], max_new_tokens=6, temperature=1.0,
                 seed=2),
            dict(prompt=[21, 22, 23], max_new_tokens=5, temperature=0.9,
                 top_k=7, seed=3)]
    e = _engine(tcfg, tparams)
    assert not e.overlap                     # the drafter reads every token
    rids = [e.submit(Request(**r)) for r in reqs]
    out = e.run()
    for rid, r in zip(rids, reqs):
        assert _tokens(out, rid) == _reference(
            model, r["prompt"], r["max_new_tokens"], seed=r.get("seed", 0),
            temperature=r["temperature"], top_k=r.get("top_k")), r
    st = e.kv_cache_stats()
    assert st["spec_steps"] > 0 and st["spec_accepted"] > 0, st
    assert 0.0 < st["spec_accept_rate"] <= 1.0, st
    assert e.compile_count <= e.n_buckets + 3, (e.compile_count,
                                               e.n_buckets)
    assert e._spec_decode.steps == st["spec_steps"]
    assert e._decode.steps + e._spec_decode.steps == e.steps_run
    e.reset_stats()
    st = e.kv_cache_stats()
    assert st["spec_steps"] == st["spec_proposed"] == 0


def test_adversarial_and_silent_drafters_change_no_token(model):
    """A drafter proposing garbage costs verify work only; one that never
    drafts runs the plain step alone. Both give the reference's stream."""
    _, _, tcfg, tparams = model
    wrong = _engine(tcfg, tparams,
                    drafter=lambda h, k: np.full(k, 3, np.int32))
    silent = _engine(tcfg, tparams,
                     drafter=lambda h, k: np.empty(0, np.int32))
    p, mnew = [17, 3, 9], 8
    want = _reference(model, p, mnew, seed=4, temperature=0.9, top_k=5)
    for e in (wrong, silent):
        rid = e.submit(Request(prompt=p, max_new_tokens=mnew,
                               temperature=0.9, top_k=5, seed=4))
        assert _tokens(e.run(), rid) == want
    assert silent.kv_cache_stats()["spec_steps"] == 0
    assert silent.compile_count <= silent.n_buckets + 2
    st = wrong.kv_cache_stats()
    assert st["spec_steps"] > 0 and st["spec_accepted"] == 0, st


def _oracle(prompt, ref):
    """A drafter that reads the reference stream: every draft is right."""
    def draft(hist, k):
        n_em = int(hist.size) - len(prompt)
        if not 0 <= n_em < len(ref):
            return np.empty(0, np.int32)
        return np.asarray(ref[n_em:n_em + k], np.int32)
    return draft


def test_oracle_drafter_and_mid_run_resume(model):
    """A sampled stream drafted by an oracle: the same tokens in fewer
    steps than tokens (the key chain advances per accepted token, not per
    step). Then the journaled resume after 5 emitted tokens, inside an
    accepted run, through a fresh speculative engine with
    ``resume_key(seed, 5)``: the stream continues exactly."""
    _, _, tcfg, tparams = model
    p, mnew, seed = [9, 4, 7, 1], 8, 5
    ref = _reference(model, p, mnew, seed=seed, temperature=0.9, top_k=7)
    e1 = _engine(tcfg, tparams, drafter=_oracle(p, ref))
    r1 = e1.submit(Request(prompt=p, max_new_tokens=mnew, temperature=0.9,
                           top_k=7, seed=seed))
    assert _tokens(e1.run(), r1) == ref
    assert e1.steps_run < mnew, e1.steps_run
    assert e1.kv_cache_stats()["spec_accepted"] >= mnew // 2

    pad = torch.zeros((1, 4), dtype=torch.int32)
    pad[0] = torch.as_tensor(p)
    tok, kb, vb, rng = tl.prefill_detached(
        tcfg, tparams, pad, len(p), prng.PRNGKey(seed, device="cpu"), 0.9,
        7, None)
    assert int(tok[0]) == ref[0]
    h = KVHandoff(k=kb.numpy(), v=vb.numpy(), true_len=len(p), token=ref[0],
                  rng=prng.key_to_numpy(rng))
    e2 = _engine(tcfg, tparams, drafter=_oracle(p, ref))
    rid = e2.submit_prefilled(h, Request(
        prompt=p + ref[:5], max_new_tokens=mnew - 5, temperature=0.9,
        top_k=7, rng=resume_key(seed, 5)))
    assert _tokens(e2.run(), rid) == ref[5:]


def test_spec_over_shared_prefix_pages(model):
    """A cold request registers SHARED + 1 token; a second, sampled one
    shares its full page, forks the boundary page and speculates into
    the fork: both streams the reference's."""
    _, _, tcfg, tparams = model
    e = _engine(tcfg, tparams)
    for r in (dict(prompt=SHARED + [11], max_new_tokens=6,
                   temperature=0.0),
              dict(prompt=SHARED + [12], max_new_tokens=6, temperature=1.0,
                   seed=1)):
        rid = e.submit(Request(**r))
        assert _tokens(e.run(), rid) == _reference(
            model, r["prompt"], r["max_new_tokens"], seed=r.get("seed", 0),
            temperature=r["temperature"])
    st = e.kv_cache_stats()
    assert st["prefix_hits"] >= 1 and st["cow_forks"] >= 1, st
    assert st["speculate_k"] == K
