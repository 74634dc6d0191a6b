"""Gluon on a mesh of ranks, the port against ``mxtpu``: ``GluonLlama``
``shard``-ed by llama's rules and trained by
``Trainer.make_fused_step`` reproduces the reference's functional
trajectory on the same mesh — ring attention on fsdp × sp × tp, MoE on
dp × ep × tp (with the expert bank really split over ep), both on
sp × ep × tp — and the fused step with ``grad_accum`` and dynamic AMP
skips an overflowing step as if it never happened. The functional MoE
step on dp × ep × tp is held against the reference too.

The port runs on 8 ``gloo`` ranks (``torch_rank_pool``: the meshes
need 8); the reference runs here on the same mesh shapes over the 8
virtual CPU devices. f32 losses agree within 1e-5 of the reference's
(the reference's own Gluon-vs-functional bound is 1e-6).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mxtpu import parallel as jpar
from mxtpu.models import llama as jllama

from torch_rank_pool import RankPool

torch.set_num_threads(2)
N = 8


def close(got, want, rtol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(N, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def reference(cfg_kw, axes, seed, shape, lr, steps, momentum=None,
              accum=1):
    """The reference's functional trajectory: (numpy tree, tokens,
    losses)."""
    jcfg = replace(jllama.CONFIGS["tiny"], dtype=jnp.float32, remat=False,
                   **cfg_kw)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed + 1), shape, 0, jcfg.vocab_size), np.int32)
    mesh = jpar.create_mesh(**axes)
    rules = jllama.sharding_rules(jcfg)
    tx = optax.sgd(lr, momentum=momentum)
    state = jpar.init_state(params, tx, mesh, rules)
    fn = jpar.make_train_step(jllama.loss_fn(jcfg, mesh), tx, mesh, rules,
                              grad_accum=accum)
    tok = jnp.asarray(tokens if accum == 1 else
                      tokens.reshape((accum, -1) + shape[1:]))
    losses = []
    for _ in range(steps):
        state, loss = fn(state, {"tokens": tok})
        losses.append(float(loss))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return tree, tokens, losses


MOE = {"attn_impl": "dense", "moe_experts": 4, "moe_top_k": 2,
       "moe_capacity": 4.0}


def test_gluon_llama_ring_attention_on_an_sp_mesh(pool):
    kw = {"attn_impl": "ring"}
    axes = dict(fsdp=2, sp=2, tp=2)
    tree, tokens, want = reference(kw, axes, 3, (4, 32), 0.1, 3)
    for losses, applied, compiles, _, _ in pool.run(
            "gluon_llama", tree, tokens, axes, kw, 3, 0.1):
        close(losses, want)
        assert applied == 3 and compiles == 1


def test_moe_llama_and_gluon_on_a_dp_ep_tp_mesh(pool):
    """The functional MoE step and the Gluon fused step on dp × ep × tp,
    against the reference; the bank holds E/ep experts a rank."""
    axes = dict(dp=2, ep=2, tp=2)
    tree, tokens, want = reference(MOE, axes, 11, (4, 24), 0.05, 3)
    for losses, _ in pool.run("llama_train", tree, tokens, axes, MOE, 3,
                              0.05):
        close(losses, want)
    for losses, _, _, local, _ in pool.run("gluon_llama", tree, tokens,
                                           axes, MOE, 3, 0.05):
        close(losses, want)
        assert local[:2] == (2, 2)        # (layers, E/ep) on each rank


def test_gluon_llama_moe_with_ring_on_an_sp_ep_mesh(pool):
    kw = dict(MOE, attn_impl="ring")
    axes = dict(sp=2, ep=2, tp=2)
    tree, tokens, want = reference(kw, axes, 21, (4, 32), 0.05, 3)
    assert want[-1] < want[0]
    for losses, _, _, local, _ in pool.run("gluon_llama", tree, tokens,
                                           axes, kw, 3, 0.05):
        close(losses, want)
        assert local[1] == 2


def test_gluon_moe_fused_grad_accum_with_dynamic_amp(pool):
    """grad_accum=2 with dynamic AMP on dp × ep × tp: the overflowing
    steps apply nothing, in one variant; the applied steps follow the
    no-AMP run, which follows the reference's accumulated trajectory
    (sgd with momentum)."""
    axes = dict(dp=2, ep=2, tp=2)
    steps = 8
    tree, tokens, want = reference(MOE, axes, 31, (4, 24), 0.05, steps,
                                   momentum=0.9, accum=2)
    amp = pool.run("gluon_llama", tree, tokens, axes, MOE, steps, 0.05, 0.9,
                   2, True)
    applied = amp[0][1]
    plain = pool.run("gluon_llama", tree, tokens, axes, MOE, applied, 0.05,
                     0.9, 2)
    for r, (losses, n, compiles, local, _) in enumerate(amp):
        assert n == applied and 1 <= applied < steps and compiles == 1
        assert losses[1] == pytest.approx(losses[0], rel=1e-6)
        close(losses[steps - applied:], plain[r][0], rtol=2e-5)
        close(plain[r][0], want[:applied])
        assert local[1] == 2
    # the skipped steps never happened: the AMP run's params are the
    # no-AMP run's after as many applied steps
    for a, p in amp[0][4].items():
        close(p, plain[0][4][a], rtol=2e-4, err_msg=a)
