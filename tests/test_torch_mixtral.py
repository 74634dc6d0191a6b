"""Parity of the port's Llama with the MoE expert bank (Mixtral's layer)
with mxtpu's on the CPU.

One tiny MoE config for the whole file (``CONFIGS["tiny"]`` with 4
experts, top-2, f32, dense attention): mxtpu's ``init_params`` draws the
tree with jax, it crosses as numpy, and both packages run the same
tokens from a seeded numpy generator. Held here: ``forward`` at a
capacity that drops tokens; ``loss_fn`` with the load-balancing aux and
every grad leaf, under each remat setting and both aux averagings; a
4-step adamw trajectory through ``make_train_step``; ``prefill`` and
``decode_step``; greedy and sampled ``generate``; and the dense, paged
and speculative engines' streams against the reference's ``generate``
(the serving paths run the dropless mixture, ``moe_ffn_dense``).

Tolerances: logits ``atol=rtol=1e-4`` (f32 on both sides, two layers);
loss ``rtol=1e-5``; grads ``atol=rtol=1e-4``; params after 4 adamw
steps ``atol=rtol=1e-4``, lr/100 (at an Adam eps that keeps the
rounding of near-zero grads from becoming whole steps). Tokens are
equal.
"""
import math
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import llama_refs
from mxtpu.models import llama as jl
from mxtpu.parallel import mesh as pmesh, step as jstep
from mxtpu.parallel.sharding import P, ShardingRules
from mxtpu_torch.models import llama as tl
from mxtpu_torch.parallel import moe as tm, optim, step as tstep
from mxtpu_torch.parallel._tree import tree_leaves
from mxtpu_torch.serve import Request, ServeEngine

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
E = 4
SHAPE = dict(max_slots=2, max_len=32, min_bucket=4, device="cpu")


def _port_cfg(cfg, **kw):
    vals = {f.name: getattr(cfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    vals.update(kw)
    return tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, numpy tree, port cfg, port params)."""
    jcfg = replace(llama_refs.serve_config(), moe_experts=E, moe_top_k=2)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tree, _port_cfg(jcfg), tl.params_from_numpy(
        tree, device="cpu")


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, 256, size=(b, s)).astype(np.int32)


def _live(tree):
    params = tl.params_from_numpy(tree, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


def _assert_tree_close(got, want, tol, what):
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_tree_close(got[key], w, tol, f"{what}.{key}")
        else:
            np.testing.assert_allclose(got[key].detach().numpy(), w,
                                       err_msg=f"{what}.{key}", **tol)


def test_tree_and_module_carry_the_expert_bank(model):
    _, _, tree, tcfg, tparams = model
    layers = tparams["layers"]
    assert layers["moe_gate"].shape == (2, 64, E)
    assert layers["w_gate"].shape == (2, E, 64, 128)
    assert layers["w_down"].shape == (2, E, 128, 64)
    mod = tl.Llama(tcfg, device="cpu")
    assert {n for n, _ in mod.named_parameters()} >= {
        "layers.moe_gate", "layers.w_gate", "layers.w_up", "layers.w_down"}
    mod.load_numpy_tree(tree)
    toks = torch.from_numpy(_tokens(2, 1, 8))
    with torch.no_grad():
        np.testing.assert_array_equal(
            mod(toks).numpy(), tl.forward(tcfg, tparams, toks).numpy())
    with pytest.raises(NotImplementedError, match="int8"):
        tl.quantize_params_int8(tcfg, tparams)


def test_forward_matches_mxtpu_where_tokens_drop(model, monkeypatch):
    jcfg, jparams, tree, tcfg, tparams = model
    jc = replace(jcfg, moe_capacity=0.75)
    toks = _tokens(1, 2, 16)
    want = jl.forward(jc, jparams, jnp.asarray(toks))
    dropped, real = [], tl.moe_ffn

    def counting(p, x, *, top_k, capacity_factor):
        C = max(1, math.ceil(x.shape[0] * top_k / E * capacity_factor))
        dropped.append(int((~tm._route(p, x, top_k, C)[4]).sum()))
        return real(p, x, top_k=top_k, capacity_factor=capacity_factor)
    monkeypatch.setattr(tl, "moe_ffn", counting)
    got = tl.forward(_port_cfg(jc), tparams, torch.from_numpy(toks))
    assert got.shape == (2, 16, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(dropped) == 2 and min(dropped) > 0, dropped


_LOSS_BATCH = {"tokens": _tokens(3, 2, 16),
               "mask": np.random.default_rng(4).random((2, 16)) > 0.3}
_LOSS_REFS = {}


def _loss_ref(jcfg, jparams, scan):
    """mxtpu's jitted loss and grads on the file's batch (remat changes
    only its memory), once per aux averaging."""
    if scan not in _LOSS_REFS:
        jc = replace(jcfg, scan_layers=scan, moe_capacity=1.0)
        batch = {k: jnp.asarray(v) for k, v in _LOSS_BATCH.items()}
        want, grads = jax.jit(jax.value_and_grad(jl.loss_fn(jc)))(
            jparams, batch)
        _LOSS_REFS[scan] = (float(want), jax.tree.map(np.asarray, grads))
    return _LOSS_REFS[scan]


@pytest.mark.parametrize("scan,remat,policy", [
    (True, False, None), (True, True, None), (False, True, "dots_no_batch")])
def test_loss_and_grads_match_mxtpu(model, scan, remat, policy):
    """The loss with ``moe_aux_weight · aux`` (the aux averaged over
    layers as the reference's scan or loop rounds it) and every grad."""
    jcfg, jparams, tree, _, _ = model
    jc = replace(jcfg, scan_layers=scan, moe_capacity=1.0)
    want, wgrads = _loss_ref(jcfg, jparams, scan)
    toks, mask = _LOSS_BATCH["tokens"], _LOSS_BATCH["mask"]
    params = _live(tree)
    got = tl.loss_fn(_port_cfg(jc, remat=remat, remat_policy=policy))(
        params, {"tokens": torch.from_numpy(toks),
                 "mask": torch.from_numpy(mask)})
    got.backward()
    np.testing.assert_allclose(got.item(), want, **LOSS_TOL)
    _assert_tree_close(jax.tree.map(lambda p: p.grad, params), wgrads, TOL,
                       "grad")
    # the aux is in the loss: without its weight the loss moves
    x, aux = tl.forward_hidden(_port_cfg(jc), params,
                               torch.from_numpy(toks), with_aux=True)
    assert x.shape == (2, 16, 64) and 0.5 < aux.item() < 4.0


def test_dense_config_aux_is_zero():
    cfg = _port_cfg(jl.CONFIGS["tiny"])
    params = tl.init_params(cfg, device="cpu")
    _, aux = tl.forward_hidden(cfg, params, torch.zeros((1, 4), dtype=int),
                               with_aux=True)
    assert aux.item() == 0.0 and aux.dtype == torch.float32


def test_adamw_trajectory_matches_mxtpu(model):
    """Four adamw steps on both sides with ``eps=1e-5``. Adam's first
    step moves an entry by ``lr·g/(|g| + eps)``, so where |g| is near or
    under eps it turns the f32 rounding of g, about 1e-8 here (the grads
    of ``wq`` and of an expert's ``w_down`` reach down to 1.9e-9), into
    ``lr·δg/eps``: at the default eps of 1e-8 one ``w_down`` entry steps
    9e-4 apart on the two sides, at 1e-6 one ``wq`` entry 1.6e-4, at
    1e-5 every entry stays within 4e-5."""
    jcfg, jparams, tree, _, _ = model
    mesh = pmesh.create_mesh(devices=jax.devices()[:1])
    rules = ShardingRules([(r".*", P())])
    jtx, ttx = optax.adamw(1e-2, eps=1e-5), optim.adamw(1e-2, eps=1e-5)
    jstate = jstep.init_state(jparams, jtx, mesh, rules)
    jfn = jstep.make_train_step(jl.loss_fn(jcfg), jtx, mesh, rules)
    tstate = tstep.init_state(tl.params_from_numpy(tree, device="cpu"), ttx)
    tfn = tstep.make_train_step(tl.loss_fn(_port_cfg(jcfg, remat=True)),
                                ttx)
    toks = _tokens(5, 2, 16)
    for _ in range(4):
        jstate, jloss = jfn(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tloss = tfn(tstate, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    assert int(tstate.step) == int(jstate.step) == 4
    _assert_tree_close(tstate.params, jax.tree.map(np.asarray, jstate.params),
                       TOL, "param")


def test_prefill_and_decode_step_match_mxtpu(model):
    jcfg, jparams, _, tcfg, tparams = model
    toks = _tokens(6, 2, 7)
    jcache = jl.init_cache(jcfg, 2, 12)
    jlog, jcache = jl.prefill(jcfg, jparams, jnp.asarray(toks), jcache)
    tcache = tl.init_cache(tcfg, 2, 12, device="cpu")
    tlog, tcache = tl.prefill(tcfg, tparams, torch.from_numpy(toks), tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)[:, None]
    jd, _ = jl.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache)
    td, tcache = tl.decode_step(tcfg, tparams, torch.from_numpy(nxt), tcache)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert tcache["pos"] == 8
    # the cached path is dropless: the chunked prefill's last logits
    # equal the one-shot prefill's
    c2 = tl.init_cache(tcfg, 2, 12, device="cpu")
    clog, c2 = tl.chunked_prefill(tcfg, tparams, torch.from_numpy(toks), c2,
                                  chunk_size=3)
    np.testing.assert_allclose(clog[:, 0].numpy(), tlog[:, -1].numpy(),
                               **TOL)


def _reference(model, prompt, mnew, **knobs):
    jcfg, jparams = model[:2]
    return llama_refs.reference(jcfg, jparams, prompt, mnew, **knobs)


# every request of the file's engines: greedy and sampled, one prompt
# length per generate program the reference compiles
REQUESTS = [dict(prompt=[140, 141, 140], max_new_tokens=10,
                 temperature=0.0),
            dict(prompt=[9, 4, 7], max_new_tokens=10, temperature=0.9,
                 top_k=7, seed=2),
            dict(prompt=[21, 22, 23], max_new_tokens=10, temperature=1.0,
                 seed=3)]


@pytest.mark.parametrize("r", REQUESTS[:2])
def test_generate_matches_mxtpu(model, r):
    _, _, _, tcfg, tparams = model
    from mxtpu_torch import prng
    out = tl.generate(tcfg, tparams, torch.tensor([r["prompt"]]),
                      r["max_new_tokens"], temperature=r["temperature"],
                      top_k=r.get("top_k"),
                      rng=prng.PRNGKey(r.get("seed", 0), device="cpu"))
    want = _reference(model, r["prompt"], r["max_new_tokens"],
                      seed=r.get("seed", 0), temperature=r["temperature"],
                      top_k=r.get("top_k"))
    assert out[0, 3:].tolist() == want


@pytest.mark.parametrize("mode", [
    {}, {"paged": True, "page_size": 8},
    {"paged": True, "page_size": 8, "speculate_k": 2}])
def test_engines_equal_mxtpu_generate(model, mode):
    """The dense, paged and speculative engines serve every stream of
    the reference's batch-1 ``generate``: the serving mixture is
    per-token, so sharing the bank changes no token."""
    _, _, _, tcfg, tparams = model
    e = ServeEngine(tcfg, tparams, **SHAPE, **mode)
    rids = [e.submit(Request(**r)) for r in REQUESTS]
    out = e.run()
    for rid, r in zip(rids, REQUESTS):
        want = _reference(model, r["prompt"], r["max_new_tokens"],
                          seed=r.get("seed", 0),
                          temperature=r["temperature"], top_k=r.get("top_k"))
        assert [int(t) for t in out[rid]] == want, (mode, r)
    if mode.get("speculate_k"):
        assert e.kv_cache_stats()["spec_steps"] > 0
