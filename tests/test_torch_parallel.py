"""Training over a mesh of ranks, the port (``mxtpu_torch.parallel``)
against ``mxtpu.parallel``: meshes, sharding rules and each rank's
local shards, the collectives, the dist bootstrap, the sharded train
step (dp, fsdp × tp, grad_accum), the sharded embedding, expert
parallelism and GPipe, and BERT's rules.

The port runs on 4 ``gloo`` ranks on the CPU (``torch_rank_pool``:
processes that import only torch and ``mxtpu_torch``); the reference
runs here on the same mesh shapes over ``jax.devices()[:4]`` of the
8-device virtual CPU mesh. Inputs are numpy from
``np.random.default_rng(seed)``; f32 results agree within 1e-5
relative unless a case says otherwise, local shards bit for bit.
"""
import os
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from mxtpu import parallel as jpar
from mxtpu.models import bert as jbert, llama as jllama
from mxtpu.parallel import moe as jmoe
from mxtpu.parallel.compat import shard_map as jshard_map
from mxtpu.parallel.pipeline import gpipe as jgpipe
from mxtpu.parallel.sparse_embed import (shard_embedding as jshard_embedding,
                                         sharded_embedding_lookup as jlookup)

from torch_rank_pool import RankPool

torch.set_num_threads(2)
N = 4
TOL = dict(rtol=1e-5, atol=1e-6)


def close(got, want, rtol=1e-5, err_msg=""):
    """Within ``rtol`` of the reference, relative to its largest
    magnitude (sums over ranks add in another order)."""
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


def shards_of(arr):
    """The reference's shard of each of the first N devices."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in jax.devices()[:N]]


def tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------------
# meshes, rules, shards
# ---------------------------------------------------------------------------
def test_ranks_are_a_gloo_group_that_imports_no_jax(pool):
    """The rank processes join one gloo group, and after every task the
    pool has run (the pool checks each reply) none has imported jax or
    mxtpu."""
    assert pool.run("rank_info") == [(r, N, "gloo", []) for r in range(N)]


def test_mesh_resolution_matches_reference(pool):
    configs = [{}, dict(dp=2, tp=2), dict(tp=2), dict(fsdp=2, sp=2),
               dict(dp=3, tp=4)]
    got = pool.run("mesh_info", configs)
    for i, axes in enumerate(configs):
        if i == len(configs) - 1:
            with pytest.raises(ValueError):
                jmesh(**axes)
            assert all(g[i][0] == "ValueError" for g in got)
            continue
        ref = jmesh(**axes)
        for r, g in enumerate(got):
            shape, dm_axes, index = g[i]
            assert shape == dict(ref.shape), (axes, shape)
            assert dm_axes == tuple(a for a in ref.axis_names
                                    if ref.shape[a] > 1) or \
                (dm_axes == ("dp",) and ref.size == 1 * N and
                 ref.shape["dp"] == N), dm_axes
            # rank r sits where device r sits in the reference's mesh
            coords = np.argwhere(np.asarray(ref.devices) ==
                                 jax.devices()[r])[0]
            assert index == dict(zip(ref.axis_names, map(int, coords)))


RULES = [(r"wq$", ("fsdp", "tp")), (r"wo$", (None, "tp")),
         (r"emb$", (("dp", "tp"), None)), (r"b$", ("dp",)), (r".*", ())]


def test_shard_pytree_local_shards_are_the_reference_shards(pool):
    rng = np.random.default_rng(0)
    tree = {"wq": rng.standard_normal((8, 6)).astype(np.float32),
            "wo": rng.standard_normal((6, 8)).astype(np.float32),
            "emb": rng.standard_normal((12, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32),
            "s": np.float32(rng.standard_normal((3,)))}
    for axes in (dict(fsdp=2, tp=2), dict(dp=2, tp=2)):
        got = pool.run("local_shards", tree, RULES, axes)
        rules = jpar.ShardingRules([(p, JP(*s)) for p, s in RULES])
        placed = jpar.shard_pytree(jax.tree.map(jnp.asarray, tree),
                                   jmesh(**axes), rules)
        for name, arr in placed.items():
            for r, want in enumerate(shards_of(arr)):
                np.testing.assert_array_equal(got[r][name], want,
                                              err_msg=f"{axes} {name} {r}")


def test_constrain_relays_and_is_a_noop_without_a_mesh(pool):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    specs = [("dp", "tp"), (("dp", "tp"),), (), (None, ("dp", "tp"))]
    got = pool.run("constrain_roundtrip", x, dict(dp=2, tp=2), specs)
    mesh = jmesh(dp=2, tp=2)
    for r, (outside, locs, full) in enumerate(got):
        assert outside
        np.testing.assert_array_equal(full, x)
        for sp, loc in zip(specs, locs):
            ref = jax.device_put(x, NamedSharding(mesh, JP(*sp)))
            np.testing.assert_array_equal(loc, shards_of(ref)[r],
                                          err_msg=str(sp))


def test_llama_and_bert_rules_place_as_the_reference(pool):
    """Both models' rule tables give each rank the reference's shard of
    every weight (llama with and without the MoE bank)."""
    for kw in ({}, {"moe_experts": 2}):
        jcfg = replace(jllama.CONFIGS["tiny"], dtype=jnp.float32, **kw)
        tree = tree_np(jllama.init_params(jcfg, jax.random.PRNGKey(0)))
        axes = dict(fsdp=2, tp=2) if not kw else dict(ep=2, tp=2)
        got = pool.run("model_shards", "llama", tree, axes, kw)
        placed = jpar.shard_pytree(tree, jmesh(**axes),
                                   jllama.sharding_rules(jcfg))
        for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
            name = "/".join(jpar.sharding.key_str(k) for k in path)
            for r, want in enumerate(shards_of(arr)):
                np.testing.assert_array_equal(got[r][name], want,
                                              err_msg=f"{kw} {name}")
    jcfg = jbert.CONFIGS["tiny"]
    tree = tree_np(jbert.init_params(jcfg, jax.random.PRNGKey(1)))
    got = pool.run("model_shards", "bert", tree, dict(fsdp=2, tp=2))
    placed = jpar.shard_pytree(tree, jmesh(fsdp=2, tp=2),
                               jbert.sharding_rules(jcfg))
    for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
        name = "/".join(jpar.sharding.key_str(k) for k in path)
        for r, want in enumerate(shards_of(arr)):
            np.testing.assert_array_equal(got[r][name], want, err_msg=name)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
COLLECTIVES = [
    # name, kwargs, mesh, in spec, out spec, global input shape
    ("allreduce", dict(axis="dp"), dict(dp=4), ("dp",), (), (4, 3)),
    ("allreduce", dict(axis=("dp", "tp")), dict(dp=2, tp=2),
     (("dp", "tp"),), (), (4, 3)),
    ("pmean", dict(axis="tp"), dict(dp=2, tp=2), ("tp", "dp"), (None, "dp"),
     (4, 6)),
    # the gathered value differs by rank from here on (a copy each)
    ("allgather", dict(axis="dp", dim=1, expand=True), dict(dp=4),
     (None, "dp"), ("dp",), (3, 8)),
    ("reduce_scatter", dict(axis="dp", dim=1), dict(dp=4), ("dp",),
     (None, "dp"), (8, 8)),
    ("ppermute_ring", dict(axis="dp", shift=1), dict(dp=4), ("dp",),
     ("dp",), (8, 2)),
    ("ppermute_ring", dict(axis="tp", shift=-1), dict(dp=2, tp=2),
     ("dp", "tp"), ("dp", "tp"), (4, 4)),
    ("alltoall", dict(axis="dp", split_dim=1, concat_dim=0), dict(dp=4),
     ("dp",), ("dp",), (8, 8)),
]

_JAX = {
    "allreduce": lambda v, axis: jax.lax.psum(v, axis),
    "pmean": lambda v, axis: jax.lax.pmean(v, axis),
    "allgather": lambda v, axis, dim, expand: jax.lax.all_gather(
        v, axis, axis=dim, tiled=True)[None],
    "reduce_scatter": lambda v, axis, dim: jax.lax.psum_scatter(
        v, axis, scatter_dimension=dim, tiled=True),
    "ppermute_ring": lambda v, axis, shift: jpar.ppermute_ring(
        v, axis, shift),
    "alltoall": lambda v, axis, split_dim, concat_dim: jax.lax.all_to_all(
        v, axis, split_dim, concat_dim, tiled=True),
}


@pytest.mark.parametrize("case", range(len(COLLECTIVES)))
def test_collective_and_its_transpose_match_jax(pool, case):
    """Each collective under shard_map, and the gradient of a weighted
    sum of its output (jax's transpose rules): the same global values."""
    name, kw, axes, ins, outs, shape = COLLECTIVES[case]
    rng = np.random.default_rng(case)
    x = rng.standard_normal(shape).astype(np.float32)
    mesh = jmesh(**axes)
    f = jshard_map(lambda v: _JAX[name](v, **kw), mesh=mesh,
                   in_specs=(JP(*ins),), out_specs=JP(*outs))
    want = np.asarray(f(jnp.asarray(x)))
    w = rng.standard_normal(want.shape).astype(np.float32)
    gwant = np.asarray(jax.grad(
        lambda v: jnp.sum(f(v) * w))(jnp.asarray(x)))
    got = pool.run("collective", name, x, axes, ins, outs, kw, w)
    for out, g in got:
        np.testing.assert_allclose(out, want, **TOL)
        np.testing.assert_allclose(g, gwant, **TOL)


UNEVEN = [((10, 3), dict(tp=4), ("tp",)),
          ((6, 8), dict(dp=2, tp=2), (("dp", "tp"),)),
          ((4, 6), dict(dp=2, tp=2), (None, ("dp", "tp")))]


def test_shard_map_refuses_uneven_shards_as_jax_does(pool):
    """A dim that does not divide over its axes: jax's shard_map refuses
    it, and so does the port's on every rank, naming the dim (the local
    regions place a shard at axis index x local size); so does a lookup
    into a 10-row embedding table blocked over tp=4."""
    for shape, axes, spec in UNEVEN:
        with pytest.raises(ValueError):
            jshard_map(lambda v: v, mesh=jmesh(**axes),
                       in_specs=(JP(*spec),),
                       out_specs=JP(*spec))(jnp.zeros(shape))
    for errs in pool.run("uneven_shard_map", UNEVEN):
        for (shape, _, spec), e in zip(UNEVEN, errs):
            d = next(i for i, a in enumerate(spec) if a is not None)
            assert e is not None and f"dim {d} of size {shape[d]}" in e, e
        assert errs[-1] is not None and "dim 0 of size 10" in errs[-1]


def test_axis_index_and_barrier(pool):
    got = pool.run("axis_indices", dict(dp=2, tp=2),
                   ["dp", "tp", ("dp", "tp"), "sp"])
    mesh = jmesh(dp=2, tp=2)
    f = jshard_map(
        lambda v: jnp.stack([jax.lax.axis_index(a) for a in
                             ("dp", "tp", ("dp", "tp"))])[None],
        mesh=mesh, in_specs=(JP(("dp", "tp")),),
        out_specs=JP(("dp", "tp")))
    want = np.asarray(f(jnp.zeros((N,))))
    for r, idx in enumerate(got):
        assert idx == list(want[r]) + [0]
    assert pool.run("barrier") == [1] * N


def test_dist_initialize_reads_dmlc_env(tmp_path):
    """``dist.initialize()`` with the reference's DMLC_* variables makes
    a one-rank gloo group (a coordinator and one worker); with none it
    is a no-op and a mesh stays the one-device placement."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = (
        "import os, torch\n"
        "from mxtpu_torch.parallel import dist, mesh\n"
        "dist.initialize(device='cpu', timeout=30)\n"
        "m = mesh.create_mesh(dp=-1)\n"
        "print(dist.is_initialized(), dist.process_count(), "
        "dist.process_index(), m.distributed, "
        "torch.distributed.is_initialized() and "
        "torch.distributed.get_backend())\n"
        "dist.shutdown()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = {k: v for k, v in os.environ.items() if not k.startswith("DMLC")}
    base["PYTHONPATH"] = root
    dmlc = dict(base, DMLC_PS_ROOT_URI="127.0.0.1",
                DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_WORKER="1",
                DMLC_WORKER_ID="0")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for env in (dmlc, base)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=60)
            out.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                   stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert out[0].returncode == 0, out[0].stderr[-2000:]
    assert out[0].stdout.split() == ["True", "1", "0", "True", "gloo"]
    assert out[1].returncode == 0, out[1].stderr[-2000:]
    assert out[1].stdout.split() == ["True", "1", "0", "False", "False"]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _linear_ref(w, xs, ys, axes, rules, tx, steps, accum=1):
    mesh = jmesh(**axes)
    rules = jpar.ShardingRules([(p, JP(*s)) for p, s in rules])

    def loss_fn(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] - y) ** 2)
    state = jpar.init_state({"w": jnp.asarray(w)}, tx, mesh, rules)
    fn = jpar.make_train_step(loss_fn, tx, mesh, rules, grad_accum=accum)
    batch = (jnp.asarray(xs), jnp.asarray(ys))
    losses = []
    for _ in range(steps):
        state, loss = fn(state, batch)
        losses.append(float(loss))
    return losses, np.asarray(state.params["w"]), state


def test_dp_step_matches_reference_and_one_device(pool):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    xs = rng.standard_normal((16, 4)).astype(np.float32)
    ys = rng.standard_normal((16, 3)).astype(np.float32)
    rules = [(".*", ())]
    want_l, want_w, _ = _linear_ref(w, xs, ys, dict(dp=4), rules,
                                    optax.sgd(0.1), 2)
    one = pool.run("linear_train", w, xs, ys, None, None, "sgd", 2)[0]
    for losses, wf, _, _, _ in pool.run("linear_train", w, xs, ys,
                                        dict(dp=4), rules, "sgd", 2):
        np.testing.assert_allclose(losses, want_l, **TOL)
        np.testing.assert_allclose(wf, want_w, **TOL)
        np.testing.assert_allclose(wf, one[1], **TOL)


def test_tp_step_keeps_the_layout_and_its_moments(pool):
    """A tp-sharded weight under adamw: the moments take its layout, the
    count stays plain, the layout survives the steps, and the
    trajectory is the reference's."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    xs = rng.standard_normal((16, 8)).astype(np.float32)
    ys = rng.standard_normal((16, 8)).astype(np.float32)
    rules = [(r"w$", (None, "tp"))]
    want_l, want_w, st = _linear_ref(w, xs, ys, dict(dp=2, tp=2), rules,
                                     optax.adamw(1e-2), 2)
    assert st.opt_state[0].mu["w"].sharding.spec == JP(None, "tp")
    for losses, wf, opt, _, wpl in pool.run(
            "linear_train", w, xs, ys, dict(dp=2, tp=2), rules, "adam", 2):
        np.testing.assert_allclose(losses, want_l, **TOL)
        np.testing.assert_allclose(wf, want_w, **TOL)
        assert wpl == "(Replicate(), Shard(dim=1))"
        assert opt[0] == ((), "plain")                       # the count
        assert opt[1:] == [((8, 8), wpl)] * 2                # mu, nu


def test_opt_state_shardings_match_reference(pool):
    """Each moment takes its parameter's spec, the count replicates."""
    rules = [(r"w$", (None, "tp"))]
    params = {"w": jnp.zeros((8, 8)), "b": jnp.zeros((3,))}
    ref = jpar.step.opt_state_shardings(
        optax.adamw(1e-2), params, jmesh(dp=2, tp=2),
        jpar.ShardingRules([(p, JP(*s)) for p, s in rules]))[0]
    want = {"count": tuple(ref.count.spec),
            **{f"{m}/{k}": tuple(getattr(ref, m)[k].spec)
               for m in ("mu", "nu") for k in ("w", "b")}}
    assert want["mu/w"] == (None, "tp")
    assert pool.run("opt_specs", dict(dp=2, tp=2), rules) == [want] * N


def test_grad_accum_equals_the_big_batch(pool):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    xs = rng.standard_normal((16, 4)).astype(np.float32)
    ys = rng.standard_normal((16, 2)).astype(np.float32)
    rules = [(".*", ())]
    big = pool.run("linear_train", w, xs, ys, dict(dp=4), rules, "sgd", 1)
    acc = pool.run("linear_train", w, xs.reshape(2, 8, 4),
                   ys.reshape(2, 8, 2), dict(dp=4), rules, "sgd", 1, 2)
    _, want_w, _ = _linear_ref(w, xs.reshape(2, 8, 4), ys.reshape(2, 8, 2),
                               dict(dp=4), rules, optax.sgd(0.1), 1, 2)
    for b, a in zip(big, acc):
        np.testing.assert_allclose(a[1], b[1], **TOL)
        np.testing.assert_allclose(a[1], want_w, **TOL)


def test_skip_nonfinite_skips_on_every_rank(pool):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    xs = rng.standard_normal((8, 4)).astype(np.float32)
    ys = rng.standard_normal((8, 2)).astype(np.float32)
    clean = pool.run("linear_train", w, xs, ys, dict(dp=4), [(".*", ())],
                     "sgd", 2)
    for c, p in zip(clean, pool.run("linear_train", w, xs, ys, dict(dp=4),
                                    [(".*", ())], "sgd", 2, 1, True)):
        assert p[3] == [True, False, False]
        np.testing.assert_array_equal(p[1], c[1])


def test_eval_step_on_the_mesh(pool):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    xs = rng.standard_normal((8, 4)).astype(np.float32)
    for out in pool.run("eval_linear", w, xs, dict(dp=2, tp=2)):
        np.testing.assert_allclose(out, xs @ w, **TOL)


def _llama_ref(cfg_kw, axes, steps, lr, opt, seed=0, accum=1):
    jcfg = replace(jllama.CONFIGS["tiny"], dtype=jnp.float32, remat=False,
                   **cfg_kw)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    mesh = jmesh(**axes)
    tx = optax.sgd(lr) if opt == "sgd" else optax.adamw(lr)
    rules = jllama.sharding_rules(jcfg)
    state = jpar.init_state(params, tx, mesh, rules)
    fn = jpar.make_train_step(jllama.loss_fn(jcfg, mesh), tx, mesh, rules,
                              grad_accum=accum)
    tok = jnp.asarray(tokens if accum == 1 else tokens.reshape(accum, -1, 16))
    losses = []
    for _ in range(steps):
        state, loss = fn(state, {"tokens": tok})
        losses.append(float(loss))
    return tree_np(params), tokens, losses, tree_np(state.params)


@pytest.mark.parametrize("axes,opt", [(dict(dp=2, tp=2), "sgd"),
                                      (dict(fsdp=2, tp=2), "adamw"),
                                      (dict(fsdp=2, sp=2), "sgd")])
def test_llama_step_on_the_mesh_matches_reference(pool, axes, opt):
    """Llama by its rules: the dp × tp step, the fsdp × tp step and the
    fsdp × sp step (the flash path: attention on each rank's rows and tp
    heads; over sp the sequence is gathered for it and each rank keeps
    its part, the cotangents reduce-scattered back), three steps, losses
    and final params against the reference on the same mesh and the port
    on no mesh."""
    tree, tokens, want, want_p = _llama_ref({}, axes, 3, 0.05, opt)
    got = pool.run("llama_train", tree, tokens, axes, {}, 3, 0.05, opt)
    one = pool.run("llama_train", tree, tokens, None, {}, 3, 0.05, opt)[0]
    for losses, _ in got:
        np.testing.assert_allclose(losses, want, **TOL)
        np.testing.assert_allclose(losses, one[0], **TOL)
    # adam's division by sqrt(v) magnifies the reordered sums: 1e-4
    for k in ("tok_embed", "lm_head"):
        close(got[0][1][k], want_p[k], rtol=1e-4, err_msg=k)
    for k, v in want_p["layers"].items():
        close(got[0][1]["layers"][k], v, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("axes", [dict(dp=2, tp=2), dict(fsdp=2, sp=2)])
def test_llama_grads_on_the_mesh_match_one_rank(pool, axes):
    """Every leaf's gradient of the loss on the mesh, gathered whole,
    within 1e-5 of its largest magnitude of the port's on no mesh."""
    jcfg = replace(jllama.CONFIGS["tiny"], dtype=jnp.float32)
    tree = tree_np(jllama.init_params(jcfg, jax.random.PRNGKey(5)))
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    for rels in pool.run("llama_grads", tree, tokens, axes, {}):
        assert max(rels.values()) <= 1e-5, rels


def test_llama_forward_on_the_mesh(pool):
    jcfg = replace(jllama.CONFIGS["tiny"], dtype=jnp.float32)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(jllama.forward(jcfg, params, jnp.asarray(tokens)))
    got = pool.run("llama_forward", tree_np(params), tokens,
                   dict(fsdp=2, tp=2), {})
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# sparse embedding, MoE, pipeline, BERT
# ---------------------------------------------------------------------------
def test_sharded_embedding_lookup_and_grads(pool):
    rng = np.random.default_rng(0)
    V, D = 32, 16
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = np.array([[0, 31, 7], [8, 8, 25]], np.int32)
    mesh = jmesh(dp=2, fsdp=2)
    jt = jshard_embedding(jnp.asarray(table), mesh, axis="fsdp")

    def loss(t):
        out = jlookup(t, jnp.asarray(ids), mesh, "fsdp")
        return (out ** 2).sum(), out
    (_, want), gwant = jax.jit(jax.value_and_grad(loss, has_aux=True))(jt)
    want, gwant = np.asarray(want), np.asarray(gwant)
    np.testing.assert_allclose(want, table[ids], rtol=1e-6)
    for r, (out, g, local, gpl) in enumerate(pool.run(
            "embedding", table, ids, dict(dp=2, fsdp=2), "fsdp")):
        np.testing.assert_array_equal(out, table[ids])
        np.testing.assert_allclose(g, gwant, **TOL)
        np.testing.assert_array_equal(local, shards_of(jt)[r])
        assert gpl == "(Replicate(), Shard(dim=0))"


@pytest.mark.parametrize("dispatch", ["einsum", "gather", "dense"])
def test_moe_expert_parallel_matches_reference(pool, dispatch):
    """moe_ffn (einsum and gather dispatch) and moe_ffn_dense with the
    banks over ep=2 (× tp=2): out and aux against the reference on the
    same mesh, grads against the port unsharded; the bank really
    split."""
    T, d, h, E, K = 32, 16, 32, 4, 2
    params = tree_np(jmoe.init_moe_params(jax.random.PRNGKey(2), d, h, E))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (T, d)),
                   np.float32)
    mesh = jmesh(ep=2, tp=2)
    espec = {"gate": JP(), "w_gate": JP("ep"), "w_up": JP("ep"),
             "w_down": JP("ep")}
    sp = jax.tree.map(lambda l, s: jax.device_put(l, NamedSharding(mesh, s)),
                      params, espec)
    dense = dispatch == "dense"
    kw = dict(top_k=K) if dense else dict(top_k=K, capacity_factor=2.0,
                                          dispatch=dispatch)
    jfn = jmoe.moe_ffn_dense if dense else jmoe.moe_ffn
    want, want_aux = jax.jit(lambda p, xx: jfn(p, xx, mesh=mesh, **kw))(
        sp, jnp.asarray(x))
    one = pool.run("moe", params, x, None, kw, dense)[0]
    for out, aux, grads, local in pool.run("moe", params, x,
                                           dict(ep=2, tp=2), kw, dense):
        np.testing.assert_allclose(out, np.asarray(want), rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(aux, float(want_aux), rtol=1e-6)
        assert local[0] == E // 2
        for n, g in grads.items():
            close(g, one[2][n], err_msg=n)


def _jlayer_fn(cfg, cos, sin):
    return lambda lp, xx: jllama._layer(cfg, None, cos, sin, xx, lp)[0]


def test_gpipe_two_stages_matches_sequential_forward_and_backward(pool):
    jcfg = replace(jllama.CONFIGS["tiny"], dtype=jnp.float32,
                   attn_impl="dense", remat=False, n_layers=4)
    layers = jllama.init_params(jcfg, jax.random.PRNGKey(0))["layers"]
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, jcfg.dim),
                          jnp.float32)
    cos, sin = jllama.rope_tables(jcfg, 16)
    layer_fn = _jlayer_fn(jcfg, cos, sin)
    mesh = jmesh(dp=2, pp=2)

    def loss(lp, xx):
        out = jgpipe(layer_fn, lp, xx, mesh=mesh, n_microbatches=2)
        return (out ** 2).sum(), out
    (_, want), gwant = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(layers, x)
    want = np.asarray(want)
    got = pool.run("gpipe_llama", tree_np(layers), np.asarray(x),
                   dict(dp=2, pp=2), {"attn_impl": "dense", "n_layers": 4},
                   2)
    for out, grads in got:
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
        for k, v in gwant[0].items():
            np.testing.assert_allclose(grads[k], np.asarray(v), rtol=5e-4,
                                       atol=5e-5, err_msg=k)
        np.testing.assert_allclose(grads["x"], np.asarray(gwant[1]),
                                   rtol=5e-4, atol=5e-5)


def test_gpipe_four_stages_and_one(pool):
    L, D = 8, 6
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    bs = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((8, D)).astype(np.float32)
    ref = x
    for i in range(L):
        ref = np.tanh(ref @ ws[i] + bs[i])
    for axes in (dict(pp=4), dict(dp=4)):
        for out in pool.run("gpipe_affine", ws, bs, x, axes, 4):
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_bert_step_on_the_mesh_matches_reference(pool):
    """BERT's loss by its rules on fsdp × tp: the reference's sharded
    trajectory and the port's unsharded one."""
    jcfg = replace(jbert.CONFIGS["tiny"], dtype=jnp.float32)
    params = jbert.init_params(jcfg, jax.random.PRNGKey(0))
    B, S, NP = 4, 16, 4
    rng = np.random.default_rng(0)
    mask = np.ones((B, S), np.float32)
    mask[1, 11:] = 0.0
    batch = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
             "mask": mask,
             "mlm_positions": rng.integers(0, S, (B, NP)).astype(np.int32),
             "mlm_labels": rng.integers(0, 256, (B, NP)).astype(np.int32),
             "mlm_weights": (rng.random((B, NP)) > 0.25).astype(np.float32),
             "nsp_labels": rng.integers(0, 2, (B,)).astype(np.int32)}
    mesh = jmesh(fsdp=2, tp=2)
    rules = jbert.sharding_rules(jcfg)
    state = jpar.init_state(params, optax.sgd(0.1), mesh, rules)
    fn = jpar.make_train_step(jbert.loss_fn(jcfg), optax.sgd(0.1), mesh,
                              rules)
    want = []
    for _ in range(2):
        state, loss = fn(state, jax.tree.map(jnp.asarray, batch))
        want.append(float(loss))
    tree = tree_np(params)
    one = pool.run("bert_train", tree, batch, None, {}, 2, 0.1)[0]
    for losses, _ in pool.run("bert_train", tree, batch, dict(fsdp=2, tp=2),
                              {}, 2, 0.1):
        np.testing.assert_allclose(losses, want, **TOL)
        np.testing.assert_allclose(losses, one[0], **TOL)
