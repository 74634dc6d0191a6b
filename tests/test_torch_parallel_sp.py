"""Sequence parallelism, the port against ``mxtpu``: ring and Ulysses
attention over the ``sp`` axis (causal and not, GQA with the K/V heads
crossing the all-to-all unrepeated or repeated first), forward and
gradients, and Llama's train step with ``attn_impl="ring"`` and
``"ulysses"`` on an sp × tp mesh.

The port runs on 4 ``gloo`` ranks (``torch_rank_pool``); the reference
runs here under ``shard_map`` on the same mesh shapes over
``jax.devices()[:4]``. Inputs are numpy from
``np.random.default_rng(seed)``; f32 results agree within 1e-5 of the
reference's largest magnitude.
"""
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from mxtpu import parallel as jpar
from mxtpu.models import llama as jllama
from mxtpu.ops.attention import (ring_attention as jring,
                                 ulysses_attention as julysses)
from mxtpu.parallel.compat import shard_map as jshard_map

from torch_rank_pool import RankPool

torch.set_num_threads(2)
N = 4


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


def jmesh(**axes):
    return jpar.create_mesh(devices=jax.devices()[:N], **axes)


CASES = [  # kind, causal, mesh, spec, kv heads
    ("ring", False, dict(sp=4), (None, None, "sp", None), 4),
    ("ring", True, dict(sp=4), (None, None, "sp", None), 2),
    ("ring", True, dict(dp=2, sp=2), ("dp", None, "sp", None), 2),
    ("ulysses", False, dict(sp=4), (None, None, "sp", None), 4),
    ("ulysses", True, dict(sp=4), (None, None, "sp", None), 2),   # repeat
    ("ulysses", True, dict(dp=2, sp=2), ("dp", None, "sp", None), 2),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sequence_parallel_attention_and_grads(pool, case):
    kind, causal, axes, spec, hkv = CASES[case]
    rng = np.random.default_rng(case)
    b, h, s, d = 2, 4, 32, 16
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    w = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kernel = jring if kind == "ring" else julysses
    # as the reference's llama calls them (its blockwise scan carries no
    # varying-axes types)
    f = jshard_map(partial(kernel, axis_name="sp", causal=causal),
                   mesh=jmesh(**axes), in_specs=(JP(*spec),) * 3,
                   out_specs=JP(*spec), check_vma=False)

    def loss(*qkv):
        out = f(*qkv)
        return jnp.sum(out * w), out
    (_, want), gwant = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    for out, grads in pool.run("attention", kind, q, k, v, w, axes, spec,
                               causal):
        close(out, want)
        for g, gw, name in zip(grads, gwant, "qkv"):
            close(g, gw, err_msg=name)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_llama_on_an_sp_mesh_matches_reference(pool, kind):
    """Llama's train step with ``attn_impl=kind`` on sp=2 × tp=2, three
    sgd steps: the reference's losses on the same mesh, and the port's
    flash (plain) losses on no mesh."""
    jcfg = replace(jllama.CONFIGS["tiny"], dtype=jnp.float32, remat=False,
                   attn_impl=kind)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    mesh = jmesh(sp=2, tp=2)
    rules = jllama.sharding_rules(jcfg)
    state = jpar.init_state(params, optax.sgd(0.1), mesh, rules)
    fn = jpar.make_train_step(jllama.loss_fn(jcfg, mesh), optax.sgd(0.1),
                              mesh, rules)
    want = []
    for _ in range(3):
        state, loss = fn(state, {"tokens": jnp.asarray(tokens)})
        want.append(float(loss))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    flash = pool.run("llama_train", tree, tokens, None, {}, 3, 0.1)[0][0]
    for losses, _ in pool.run("llama_train", tree, tokens, dict(sp=2, tp=2),
                              {"attn_impl": kind}, 3, 0.1):
        close(losses, want)
        close(losses, flash)


def test_ring_without_an_sp_mesh_raises_as_the_reference(pool):
    """``attn_impl="ring"`` with no mesh raises naming the sp axis, as
    the reference does."""
    from mxtpu_torch.models import llama as tl
    cfg = replace(tl.CONFIGS["tiny"], dtype=torch.float32, attn_impl="ring")
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(ValueError, match="sp"):
        tl.forward(cfg, params, torch.zeros((1, 8), dtype=torch.long))
