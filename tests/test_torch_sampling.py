"""Parity of the port's sampler and sampled ``generate`` with mxtpu's
on the CPU.

``sample_logits`` draws with ``prng.categorical``, whose Gumbel noise
is within 2 ulp of jax's (``test_torch_prng.py``), on logits masked by
the same top-k threshold and nucleus formula; tokens are held equal,
and a test that meets a near-tie prints its margin. ``_nucleus_mask``
computes softmax and cumsum with torch's ``exp`` and summation order,
so a boundary whose ``cumsum - p`` lies within a few ulp of ``top_p``
may fall the other way: the mask is held equal everywhere else, and
such a boundary is printed with its margin. Sampled ``generate`` runs
on ``llama_refs``' tiny float32 serve model against its memoized
``generate`` oracle, token for token.
"""
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu.models import llama as jl
from mxtpu_torch import prng
from mxtpu_torch.models import llama as tl

torch.set_num_threads(2)   # a CPU share for each xdist worker

V = 97
# tests/test_serve.py's six sampling configs: (temperature, top_k, top_p)
CONFIGS = [(0.0, None, None), (0.7, None, None), (1.1, 5, None),
           (0.9, None, 0.6), (0.8, 12, 0.9), (1.0, 1, None)]
KEYS = [0, 5, 11, 42, 2 ** 31 - 1, -3]


def _logits(seed=11, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, V)) * 3).astype(np.float32)


def _traced(cfg, b, jax_side):
    """The per-row (b,) arrays of one static config."""
    t, k, p = cfg
    arrs = (np.full((b,), t, np.float32),
            np.full((b,), V if k is None else k, np.int32),
            np.full((b,), 1.0 if p is None else p, np.float32))
    return tuple(jnp.asarray(a) if jax_side else torch.from_numpy(a)
                 for a in arrs)


def _margin(jkey, lg, t, got, want):
    """Where tokens differ: jax's perturbed logits at both tokens."""
    noisy = np.asarray(jax.random.gumbel(jkey, lg.shape, jnp.float32)) \
        + lg / (t or 1.0)
    rows = np.nonzero(got != want)[0]
    return {int(r): (float(noisy[r, want[r]]), float(noisy[r, got[r]]))
            for r in rows}


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_sample_logits_matches_mxtpu(cfg):
    """Static and traced modes against mxtpu's, over six keys."""
    lg = _logits()
    t, k, p = cfg
    for seed in KEYS:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        want = np.asarray(jl.sample_logits(jkey, jnp.asarray(lg), t, k, p))
        got = tl.sample_logits(key, torch.from_numpy(lg), t, k, p)
        assert got.dtype == torch.int32 and got.shape == (4,)
        got = got.numpy()
        np.testing.assert_array_equal(
            got, want, err_msg=str(_margin(jkey, lg, t, got, want)))
        want_tr = np.asarray(jl.sample_logits(jkey, jnp.asarray(lg),
                                              *_traced(cfg, 4, True)))
        got_tr = tl.sample_logits(key, torch.from_numpy(lg),
                                  *_traced(cfg, 4, False)).numpy()
        np.testing.assert_array_equal(got_tr, want_tr)
        np.testing.assert_array_equal(got_tr, got)


def test_sample_logits_mixed_rows_match_mxtpu():
    """Per-row configs in one traced call: each row equals its static
    config's row, and mxtpu's mixed call."""
    lg = _logits(seed=12)
    rows = [(0.0, None, None), (0.7, None, None), (0.9, 5, None),
            (0.8, 12, 0.9)]
    mixed = ([0.0, 0.7, 0.9, 0.8], [V, V, 5, 12], [1.0, 1.0, 1.0, 0.9])
    for seed in KEYS[:3]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        got = tl.sample_logits(
            key, torch.from_numpy(lg), torch.tensor(mixed[0]),
            torch.tensor(mixed[1]), torch.tensor(mixed[2])).numpy()
        want = np.asarray(jl.sample_logits(
            jkey, jnp.asarray(lg), jnp.asarray(mixed[0], jnp.float32),
            jnp.asarray(mixed[1], jnp.int32),
            jnp.asarray(mixed[2], jnp.float32)))
        np.testing.assert_array_equal(got, want)
        for i, (t, k, p) in enumerate(rows):
            own = tl.sample_logits(key, torch.from_numpy(lg), t, k, p)
            assert int(got[i]) == int(own[i]), (seed, i, rows[i])
    # top_k past the vocab is clipped to V; 0 to 1 (the greedy token)
    key = prng.PRNGKey(1, device="cpu")
    out = tl.sample_logits(key, torch.from_numpy(lg), torch.ones(4),
                           torch.tensor([V + 50, 0, 0, 0]))
    np.testing.assert_array_equal(out[1:].numpy(), lg[1:].argmax(-1))


@pytest.mark.parametrize("top_p", [0.3, 0.6, 0.9, 0.95, 1.0])
def test_nucleus_mask_matches_mxtpu(top_p):
    lg = _logits(seed=13, b=6)
    got = tl._nucleus_mask(torch.from_numpy(lg), torch.tensor(top_p))
    want = np.asarray(jl._nucleus_mask(jnp.asarray(lg), top_p))
    got = got.numpy()
    # the reference's kept mass before each value, to read a boundary's
    # margin from top_p
    srt = -np.sort(-lg, axis=-1)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(srt), axis=-1))
    before = np.asarray(jnp.cumsum(jnp.asarray(probs), axis=-1)) - probs
    ulp = np.spacing(np.float32(top_p))
    for r, c in zip(*np.nonzero(got != want)):
        j = int(np.nonzero(srt[r] == lg[r, c])[0][0])
        margin = abs(float(before[r, j]) - np.float32(top_p)) / ulp
        print(f"row {r} token {c}: mass before it {before[r, j]!r}, "
              f"{margin:.1f} ulp from top_p {top_p}")
        assert margin <= 4, (r, c, margin)
    assert (np.isfinite(got) == np.isfinite(want)).mean() > 0.99
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  lg[np.isfinite(got)])


def _port_cfg(cfg):
    vals = {f.name: getattr(cfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    return tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)


@pytest.fixture(scope="module")
def serve():
    cfg, params = llama_refs.serve_config(), llama_refs.serve_weights(0)
    return cfg, params, _port_cfg(cfg), tl.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


PROMPTS = [[1, 2, 3, 4, 5], [7, 200, 31], [9, 9, 8, 7, 120, 64, 3]]


@pytest.mark.parametrize("kw", [
    {"temperature": 0.8}, {"temperature": 1.0, "top_k": 5},
    {"temperature": 0.9, "top_p": 0.7},
    {"temperature": 0.8, "top_k": 12, "top_p": 0.9}], ids=str)
def test_sampled_generate_matches_reference(serve, kw):
    cfg, params, tcfg, tparams = serve
    for prompt in PROMPTS:
        want = llama_refs.reference(cfg, params, prompt, 6, **kw)
        out = tl.generate(tcfg, tparams,
                          torch.tensor([prompt], dtype=torch.int32), 6, **kw)
        assert out.dtype == torch.int32 and out.shape == (1, len(prompt) + 6)
        assert out[0, :len(prompt)].tolist() == prompt
        assert out[0, len(prompt):].tolist() == want, (prompt, kw)


def test_generate_keys_and_traced_knobs(serve):
    """The default key is PRNGKey(0); another key gives another stream
    (the reference's, seed 3); per-row tensors give the static stream;
    a greedy call draws nothing, so its key is not looked at."""
    cfg, params, tcfg, tparams = serve
    prompt = torch.tensor([PROMPTS[0]] * 2, dtype=torch.int32)
    kw = {"temperature": 0.8, "top_k": 12, "top_p": 0.9}
    base = tl.generate(tcfg, tparams, prompt, 6, **kw)
    keyed = tl.generate(tcfg, tparams, prompt, 6, **kw,
                        rng=prng.PRNGKey(0, device="cpu"))
    assert torch.equal(base, keyed)
    other = tl.generate(tcfg, tparams, prompt[:1], 6, **kw,
                        rng=prng.PRNGKey(3, device="cpu"))
    assert other[0, 5:].tolist() == llama_refs.reference(
        cfg, params, PROMPTS[0], 6, seed=3, **kw)
    traced = tl.generate(tcfg, tparams, prompt, 6,
                         temperature=torch.full((2,), 0.8),
                         top_k=torch.full((2,), 12),
                         top_p=torch.full((2,), 0.9))
    assert torch.equal(traced, base)
    greedy = tl.generate(tcfg, tparams, prompt, 6)
    assert torch.equal(greedy, tl.generate(tcfg, tparams, prompt, 6,
                                           rng="not a key"))
    with pytest.raises(ValueError, match="top_k"):
        tl.generate(tcfg, tparams, prompt, 2, temperature=1.0, top_k=0)
