"""Parity of the port's serving slot programs with mxtpu's on the CPU.

Batched keys: ``prng.split``, ``fold_in``, ``uniform`` and
``categorical`` on a (S, 2) batch of keys equal ``jax.vmap`` of jax's,
bit for bit. ``slot_decode_attention`` is held to mxtpu's within
``atol=rtol=1e-5`` on ragged lengths (0 and ``max_len`` among them),
MHA and GQA 2:1 and 4:1, a tail block that does not divide ``max_len``,
and the 2-D per-query lengths. The slot programs (``prefill_slot``,
three mixed greedy/sampled ``decode_slots`` steps, ``prefill_detached``,
``prefill_detached_chunk`` iterated over a bucket, ``inject_slot_kv``)
run against mxtpu's on ``llama_refs``' tiny float32 serve model and
weights, at its engine shape (2 slots, ``max_len`` 32): tokens and keys
equal, the bank and ``lengths`` within ``1e-5``.
"""
from dataclasses import fields
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu.models import llama as jl
from mxtpu.ops.attention import slot_decode_attention as j_slot_attention
from mxtpu_torch import prng
from mxtpu_torch.models import llama as tl
from mxtpu_torch.ops.attention import slot_decode_attention

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-5, rtol=1e-5)
SEEDS = [0, 5, 2 ** 31 - 1, -3]
S, MAX_LEN = 2, 32          # llama_refs' engine shape
# (prompt length, seed, temperature, top_k, top_p) per slot
ADMITS = [(5, 3, 0.0, None, None), (7, 4, 0.8, 5, 0.9)]


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


def _keys():
    return (jnp.stack([jax.random.PRNGKey(s) for s in SEEDS]),
            torch.stack([prng.PRNGKey(s, device="cpu") for s in SEEDS]))


def _key_eq(jkey, tkey):
    np.testing.assert_array_equal(np.asarray(jkey), prng.key_to_numpy(tkey))


@pytest.mark.parametrize("num", [2, 3])
def test_batched_split_and_fold_in_match_jax_vmap(num):
    jk, tk = _keys()
    _key_eq(jk, tk)
    got = prng.split(tk, num)
    assert got.shape == (len(SEEDS), num, 2)
    _key_eq(jax.vmap(lambda k: jax.random.split(k, num))(jk), got)
    _key_eq(jax.vmap(lambda k: jax.random.fold_in(k, 7))(jk),
            prng.fold_in(tk, 7))
    # a batch of one key is that key's draw, with the batch axis kept
    np.testing.assert_array_equal(prng.split(tk[1:2], num)[0].numpy(),
                                  prng.split(tk[1], num).numpy())


def test_batched_draws_match_jax_vmap():
    """Row i of a batched draw is key i's over the row's own counters."""
    jk, tk = _keys()
    want = jax.vmap(lambda k: jax.random.uniform(k, (3, 5), jnp.float32))(jk)
    np.testing.assert_array_equal(prng.uniform(tk, (3, 5)).numpy(),
                                  np.asarray(want))
    lg = (np.random.default_rng(1).standard_normal((len(SEEDS), 97)) * 3) \
        .astype(np.float32)
    want = jax.vmap(lambda k, row: jax.random.categorical(k, row[None])[0])(
        jk, jnp.asarray(lg))
    got = prng.categorical(tk, torch.from_numpy(lg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="one row each"):
        prng.categorical(tk, torch.from_numpy(lg[:3]))
    with pytest.raises(TypeError, match="one key"):
        prng.bernoulli(tk, 0.5, (3,))
    with pytest.raises(TypeError, match="batch of them"):
        prng.split(torch.zeros((2, 2, 2), dtype=torch.int64))


def _attention_inputs(seed, hq, hkv, sq, max_len, lengths):
    r = np.random.default_rng(seed)
    q = r.standard_normal((len(lengths), hq, sq, 16)).astype(np.float32)
    k = r.standard_normal((len(lengths), hkv, max_len, 16)).astype(
        np.float32)
    v = r.standard_normal(k.shape).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("hq,hkv,kv_block", [(4, 4, 512), (4, 2, 16),
                                             (8, 2, 16), (8, 2, 13)])
def test_slot_decode_attention_matches_mxtpu(hq, hkv, kv_block):
    """Ragged 1-D lengths, 0 and max_len among them; kv_block 13 leaves
    a padded tail block of 37 = 2·13 + 11."""
    lengths = np.array([0, 37, 1, 7, 36, 20], np.int32)
    q, k, v = _attention_inputs(7, hq, hkv, 1, 37, lengths)
    want = j_slot_attention(*map(jnp.asarray, (q, k, v, lengths)),
                            kv_block=kv_block)
    got = slot_decode_attention(*map(torch.from_numpy, (q, k, v, lengths)),
                                kv_block=kv_block)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()            # a length-0 slot gives zeros


def test_slot_decode_attention_per_query_lengths_match_mxtpu():
    """(slots, s) lengths: query j of slot i sees [0, lengths[i, j])."""
    base = np.array([0, 5, 30, 33], np.int32)
    lengths = np.minimum(base[:, None] + np.arange(3)[None], 33).astype(
        np.int32)
    q, k, v = _attention_inputs(8, 8, 2, 3, 33, lengths)
    want = j_slot_attention(*map(jnp.asarray, (q, k, v, lengths)),
                            kv_block=16)
    got = slot_decode_attention(*map(torch.from_numpy, (q, k, v, lengths)),
                                kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="not divisible"):
        slot_decode_attention(torch.zeros(1, 3, 1, 16),
                              torch.zeros(1, 2, 8, 16),
                              torch.zeros(1, 2, 8, 16),
                              torch.ones(1, dtype=torch.int32))


def _prompt(plen, bucket=8, seed=1):
    pad = np.zeros((1, bucket), np.int32)
    pad[0, :plen] = np.random.default_rng(seed + plen).integers(0, 256, plen)
    return pad


def _both_banks(jcfg, tcfg):
    js = jl.init_slot_cache(jcfg, S, MAX_LEN)
    ts = tl.init_slot_cache(tcfg, S, MAX_LEN, device="cpu")
    split = ({n: js[n] for n in ("k", "v")},
             {n: js[n] for n in ("lengths", "tokens", "rngs")},
             {n: ts[n] for n in ("k", "v")},
             {n: ts[n] for n in ("lengths", "tokens", "rngs")})
    assert ts["rngs"].dtype == torch.int64 and ts["rngs"].shape == (S, 2)
    assert ts["lengths"].dtype == ts["tokens"].dtype == torch.int32
    return split


def _same_state(jkv, jsv, tkv, tsv):
    for n in ("k", "v"):
        np.testing.assert_allclose(tkv[n].numpy(), np.asarray(jkv[n]),
                                   **TOL, err_msg=n)
    np.testing.assert_allclose(tsv["lengths"].numpy(),
                               np.asarray(jsv["lengths"]), **TOL)
    np.testing.assert_array_equal(tsv["tokens"].numpy(),
                                  np.asarray(jsv["tokens"]))
    _key_eq(jsv["rngs"], tsv["rngs"])


@pytest.fixture(scope="module")
def j_decode(model):
    jcfg, jparams, _, _ = model
    return jax.jit(partial(jl.decode_slots, jcfg, jparams))


def test_prefill_slot_then_mixed_decode_steps_match_mxtpu(model, j_decode):
    """Two admissions (greedy, sampled with top_k and top_p), then three
    decode steps of the mixed bank, the second slot inactive on the
    last: tokens and keys equal, bank and lengths within 1e-5."""
    jcfg, jparams, tcfg, tparams = model
    jkv, jsv, tkv, tsv = _both_banks(jcfg, tcfg)
    for slot, (plen, seed, t, k, p) in enumerate(ADMITS):
        pad = _prompt(plen)
        jtok, jkv, jsv = jl.prefill_slot(
            jcfg, jparams, jnp.asarray(pad), plen, slot, jkv, jsv,
            jax.random.PRNGKey(seed), t, k, p)
        ttok, tkv2, tsv2 = tl.prefill_slot(
            tcfg, tparams, torch.from_numpy(pad), plen, slot, tkv, tsv,
            prng.PRNGKey(seed, device="cpu"), t, k, p)
        assert tkv2 is tkv and tsv2 is tsv       # written in place
        assert ttok.dtype == torch.int32 and ttok.shape == (1,)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        _same_state(jkv, jsv, tkv, tsv)
    knobs = (np.array([0.0, 0.8], np.float32), np.array([256, 5], np.int32),
             np.array([1.0, 0.9], np.float32))
    for step in range(3):
        active = np.array([True, step < 2])
        jtok, jkv, jsv = j_decode(jkv, jsv, active, *knobs)
        ttok, _, _ = tl.decode_slots(tcfg, tparams, tkv, tsv,
                                     torch.from_numpy(active),
                                     *map(torch.from_numpy, knobs))
        assert ttok.dtype == torch.int32 and ttok.shape == (S,)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        _same_state(jkv, jsv, tkv, tsv)
    np.testing.assert_array_equal(tsv["lengths"].numpy(), [8, 9])


def test_prefill_detached_matches_mxtpu(model):
    jcfg, jparams, tcfg, tparams = model
    pad = _prompt(7)
    want = jl.prefill_detached(jcfg, jparams, jnp.asarray(pad), 7,
                               jax.random.PRNGKey(4), 0.8, 5, 0.9)
    got = tl.prefill_detached(tcfg, tparams, torch.from_numpy(pad), 7,
                              prng.PRNGKey(4, device="cpu"), 0.8, 5, 0.9)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].shape == (tcfg.n_layers, tcfg.n_kv_heads, 8,
                            tcfg.head_dim)
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    _key_eq(want[3], got[3])


@pytest.mark.parametrize("cw", [8, 4, 2])
def test_prefill_detached_chunk_matches_mxtpu(model, cw):
    """The chunk program iterated over the bucket: every chunk's K/V and
    the token and key of the chunk that holds position true_len - 1
    equal mxtpu's, and equal the one-shot ``prefill_detached``."""
    jcfg, jparams, tcfg, tparams = model
    plen, pad = 7, _prompt(7)
    jc = jl.init_cache(jcfg, 1, 8)
    tc = tl.init_cache(tcfg, 1, 8, device="cpu")
    last = (plen - 1) // cw
    for i in range(8 // cw):
        sl = pad[:, i * cw:(i + 1) * cw]
        want = jl.prefill_detached_chunk(
            jcfg, jparams, jnp.asarray(sl), jc, plen,
            jax.random.PRNGKey(4), 0.8, 5, 0.9)
        got = tl.prefill_detached_chunk(
            tcfg, tparams, torch.from_numpy(sl), tc, plen,
            prng.PRNGKey(4, device="cpu"), 0.8, 5, 0.9)
        jc, tc = want[4], got[4]
        assert tc["pos"] == int(jc["pos"]) == (i + 1) * cw
        for a, b in zip(got[1:3], want[1:3]):
            assert a.shape == (tcfg.n_layers, tcfg.n_kv_heads, cw,
                               tcfg.head_dim)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        if i == last:
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            _key_eq(want[3], got[3])
            tok, rng = got[0], got[3]
    one = tl.prefill_detached(tcfg, tparams, torch.from_numpy(pad), plen,
                              prng.PRNGKey(4, device="cpu"), 0.8, 5, 0.9)
    np.testing.assert_array_equal(tok.numpy(), one[0].numpy())
    np.testing.assert_array_equal(rng.numpy(), one[3].numpy())
    np.testing.assert_allclose(tc["k"][:, 0].numpy(), one[1].numpy(), **TOL)
    np.testing.assert_allclose(tc["v"][:, 0].numpy(), one[2].numpy(), **TOL)


def test_inject_slot_kv_matches_mxtpu(model, j_decode):
    """A detached block seated in slot 1 by both packages, then one
    decode step of the bank."""
    jcfg, jparams, tcfg, tparams = model
    jkv, jsv, tkv, tsv = _both_banks(jcfg, tcfg)
    pad = _prompt(6)
    tok, kb, vb, rng = tl.prefill_detached(
        tcfg, tparams, torch.from_numpy(pad), 6,
        prng.PRNGKey(9, device="cpu"), 0.0, None, None)
    kb, vb, key = kb.numpy(), vb.numpy(), prng.key_to_numpy(rng)
    jkv, jsv = jl.inject_slot_kv(jcfg, jnp.asarray(kb), jnp.asarray(vb), 6,
                                 1, int(tok[0]), jnp.asarray(key), jkv, jsv)
    tl.inject_slot_kv(tcfg, kb, vb, 6, 1, int(tok[0]),
                      prng.key_from_numpy(key, "cpu"), tkv, tsv)
    _same_state(jkv, jsv, tkv, tsv)
    knobs = (np.zeros(S, np.float32), np.full(S, 256, np.int32),
             np.ones(S, np.float32))
    active = np.array([False, True])
    jtok, jkv, jsv = j_decode(jkv, jsv, active, *knobs)
    ttok, _, _ = tl.decode_slots(tcfg, tparams, tkv, tsv,
                                 torch.from_numpy(active),
                                 *map(torch.from_numpy, knobs))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _same_state(jkv, jsv, tkv, tsv)


def test_slot_programs_refuse_a_mesh(model):
    _, _, tcfg, tparams = model
    with pytest.raises(NotImplementedError, match="item 11"):
        tl.init_slot_cache(tcfg, S, MAX_LEN, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        tl.slot_cache_specs(tcfg, object())
    ts = tl.init_slot_cache(tcfg, S, MAX_LEN, device="cpu")
    kv = {n: ts[n] for n in ("k", "v")}
    sv = {n: ts[n] for n in ("lengths", "tokens", "rngs")}
    z = torch.zeros(S)
    with pytest.raises(NotImplementedError, match="item 11"):
        tl.decode_slots(tcfg, tparams, kv, sv, z.bool(), z, z.int(), z,
                        mesh=object())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_slot_cache(tcfg, S, MAX_LEN)
