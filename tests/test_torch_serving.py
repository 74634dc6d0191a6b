"""Parity of the port's chunked prefill and int8 weight-only serving with
mxtpu's on the CPU.

Both packages run the tiny model in float32 on one weight tree drawn
by jax. ``chunked_prefill`` is held to ``mxtpu``'s (logits within
``atol=rtol=2e-5``, as ``tests/test_models.py`` holds mxtpu's chunked
prefill to its one-shot prefill) and to the port's own
``prefill(last_only=True)``: the caches equal and a decode step off
either continues the same. ``quantize_params_int8`` gives mxtpu's tree
bit for bit (``q8`` and ``s8``); int8 ``prefill`` and ``decode_step``
logits are held within ``atol=rtol=1e-4`` of mxtpu's, as the float
path is in ``test_torch_llama.py`` (the same f32 arithmetic after an
exact dequant), with greedy tokens equal, tied embeddings included.
"""
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.models import llama as jl
from mxtpu_torch.models import llama as tl

torch.set_num_threads(2)   # a CPU share for each xdist worker

CHUNK_TOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _port_cfg(cfg):
    vals = {f.name: getattr(cfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    return tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)


def _model(tie=False, seed=15):
    jcfg = replace(jl.CONFIGS["tiny"], dtype=jnp.float32, remat=False,
                   attn_impl="dense", tie_embeddings=tie)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, _port_cfg(jcfg), tl.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, 256, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("chunk", [24, 12, 8, 7, 4])
def test_chunked_prefill_matches_mxtpu_and_prefill(model, chunk):
    """24 is one pass (mxtpu's n == 1 fast path), 7 leaves a remainder
    of 3."""
    jcfg, jparams, tcfg, tparams = model
    prompt = _tokens(16, 2, 24)
    want, _ = jl.chunked_prefill(jcfg, jparams, jnp.asarray(prompt),
                                 jl.init_cache(jcfg, 2, 32), chunk)
    got, cache = tl.chunked_prefill(tcfg, tparams, torch.from_numpy(prompt),
                                    tl.init_cache(tcfg, 2, 32, device="cpu"),
                                    chunk)
    assert got.shape == (2, 1, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHUNK_TOL)
    one, one_cache = tl.prefill(tcfg, tparams, torch.from_numpy(prompt),
                                tl.init_cache(tcfg, 2, 32, device="cpu"),
                                last_only=True)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **CHUNK_TOL)
    assert cache["pos"] == one_cache["pos"] == 24
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), one_cache[k].numpy(),
                                   **CHUNK_TOL)
    tok = got[:, 0].argmax(-1, keepdim=True).to(torch.int32)
    d1, _ = tl.decode_step(tcfg, tparams, tok, cache)
    d2, _ = tl.decode_step(tcfg, tparams, tok, one_cache)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), **CHUNK_TOL)


def test_chunked_prefill_refuses_a_bad_chunk(model):
    _, _, tcfg, tparams = model
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk_size"):
        tl.chunked_prefill(tcfg, tparams, toks,
                           tl.init_cache(tcfg, 1, 8, device="cpu"), 0)
    with pytest.raises(NotImplementedError, match="mesh"):
        tl.chunked_prefill(tcfg, tparams, toks,
                           tl.init_cache(tcfg, 1, 8, device="cpu"), 2,
                           mesh=object())


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("tie", [False, True])
def test_int8_serving_matches_mxtpu(tie):
    """The quantized trees bit for bit; prefill and decode logits off the
    port's own tree and off mxtpu's carried as numpy; greedy tokens."""
    jcfg, jparams, tcfg, tparams = _model(tie=tie, seed=3)
    jq = jl.quantize_params_int8(jcfg, jparams)
    tq = tl.quantize_params_int8(tcfg, tparams)
    want_tree = jax.tree.map(np.asarray, jq)
    assert [p for p, _ in _leaves(want_tree)] == \
        [p for p, _ in _leaves(tl.params_to_numpy(tq))]
    for (path, a), (_, b) in zip(_leaves(want_tree),
                                 _leaves(tl.params_to_numpy(tq))):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=str(path))
    # params_from_numpy carries mxtpu's tree with q8 kept int8
    carried = tl.params_from_numpy(want_tree, device="cpu")
    assert carried["layers"]["wq"]["q8"].dtype == torch.int8
    assert carried["tok_embed"]["s8"].dtype == torch.float32
    assert ("lm_head" in carried) != tie

    prompt = _tokens(4, 2, 12)
    jc = jl.init_cache(jcfg, 2, 16)
    want, jc = jl.prefill(jcfg, jq, jnp.asarray(prompt), jc)
    for tree in (tq, carried):
        tc = tl.init_cache(tcfg, 2, 16, device="cpu")
        got, tc = tl.prefill(tcfg, tree, torch.from_numpy(prompt), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for _ in range(3):
        want_d, jc = jl.decode_step(jcfg, jq, tok, jc)
        got_d, tc = tl.decode_step(tcfg, carried,
                                   torch.from_numpy(np.array(tok)), tc)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
        tok = jnp.argmax(want_d, axis=-1).astype(jnp.int32)[:, None]
    want_gen = jl.generate(jcfg, jq, jnp.asarray(prompt[:, :5]), 5)
    got_gen = tl.generate(tcfg, tq, torch.from_numpy(prompt[:, :5]), 5)
    np.testing.assert_array_equal(got_gen.numpy(), np.asarray(want_gen))


def test_int8_is_for_serving_only(model):
    jcfg, _, tcfg, tparams = model
    tq = tl.quantize_params_int8(tcfg, tparams)
    toks = torch.from_numpy(_tokens(5, 1, 6))
    with pytest.raises(TypeError, match="float trees"):
        tl.forward(tcfg, tq, toks)
    with pytest.raises(TypeError, match="float trees"):
        tl.loss_fn(tcfg)(tq, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.quantize_params_int8(replace(tcfg, moe_experts=2), tparams)
    # the module's parameters require grad; quantization records nothing
    module = tl.Llama(tcfg, device="cpu")
    q = tl.quantize_params_int8(tcfg, module.tree())
    assert not q["layers"]["wq"]["s8"].requires_grad
