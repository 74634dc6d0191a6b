"""Parity of the port's training path with mxtpu's on the CPU.

The port is held on the reference's weights: mxtpu's ``init_params``
draws a tiny tree with jax, it crosses as numpy, and both packages run
the same tokens (from a seeded numpy generator) in float32. Held here:
``chunked_softmax_xent`` and ``loss_fn`` (value and every grad leaf)
against ``jax.value_and_grad``, the three remat settings against each
other, and ``make_train_step`` trajectories (adamw, sgd with momentum,
grad accumulation, the non-finite skip) against
``mxtpu.parallel.step.make_train_step`` on a one-device mesh, with the
same optimizer hyperparameters on both sides.

Tolerances: loss ``rtol=1e-5``, grads ``atol=rtol=1e-4`` (f32 on both
sides; the largest grad difference at this size is about 2e-6).
Params after 4 steps: ``atol=rtol=1e-4`` — for adamw that is lr/100,
since Adam turns a near-zero grad's sign into a full lr-sized step (the
largest difference seen is 1.4e-5 at lr 1e-2).
"""
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mxtpu.models import llama as jl
from mxtpu.parallel import mesh as pmesh, step as jstep
from mxtpu.parallel.sharding import P, ShardingRules
from mxtpu_torch import prng
from mxtpu_torch.models import llama as tl
from mxtpu_torch.parallel import optim, step as tstep
from mxtpu_torch.parallel._tree import tree_leaves

torch.set_num_threads(2)   # a CPU share for each xdist worker

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(atol=1e-4, rtol=1e-4)


def _port_cfg(cfg, **kw):
    vals = {f.name: getattr(cfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    vals.update(kw)
    return tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)


@pytest.fixture(scope="module")
def ref():
    """(jax cfg, jax params, numpy tree) for the tiny f32 model."""
    jcfg = replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _batch(seed, b=2, s=16, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 256, size=(b, s)).astype(np.int32)}
    if mask:
        out["mask"] = rng.random((b, s)) > 0.3
    return out


def _live(tree):
    params = tl.params_from_numpy(tree, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


def _assert_tree_close(got, want, tol, what):
    """``got``: the port's tree of tensors; ``want``: numpy leaves."""
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_tree_close(got[key], w, tol, f"{what}.{key}")
        else:
            np.testing.assert_allclose(got[key].detach().numpy(), w,
                                       err_msg=f"{what}.{key}", **tol)


@pytest.mark.parametrize("chunk", [64, 100])      # 100 does not divide 256
def test_chunked_softmax_xent_matches_mxtpu(chunk):
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    head = (rng.standard_normal((32, 256)) / 6).astype(np.float32)
    targets = rng.integers(0, 256, size=(2, 9)).astype(np.int32)
    w = rng.random((2, 9)).astype(np.float32)   # a non-uniform upstream grad

    def ref_fn(x, head):
        return (jl.chunked_softmax_xent(x, head, jnp.asarray(targets),
                                        chunk) * w).sum()
    want, (wx, wh) = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    xt, ht = (torch.from_numpy(a).requires_grad_() for a in (x, head))
    nll = tl.chunked_softmax_xent(xt, ht, torch.from_numpy(targets), chunk)
    assert nll.shape == (2, 9) and nll.dtype == torch.float32
    got = (nll * torch.from_numpy(w)).sum()
    gx, gh = torch.autograd.grad(got, (xt, ht))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), **TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)


@pytest.mark.parametrize("mask,ce_chunk", [(False, None), (True, None),
                                           (False, 100), (True, 64)])
def test_loss_fn_value_and_grads_match_mxtpu(ref, mask, ce_chunk):
    jcfg, jparams, tree = ref
    batch = _batch(1, mask=mask)
    jc = replace(jcfg, ce_chunk=ce_chunk)
    want, wgrads = jax.value_and_grad(jl.loss_fn(jc))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = _live(tree)
    got = tl.loss_fn(_port_cfg(jc, remat=True))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    grads = jax.tree.map(lambda p: p.grad, params)
    _assert_tree_close(grads, jax.tree.map(np.asarray, wgrads), TOL, "grad")
    assert tl._resolve_ce_chunk(_port_cfg(jc)) == jl._resolve_ce_chunk(jc)


def test_remat_settings_give_the_same_grads(ref):
    """remat off, per-layer recompute, and the selective policy that
    saves the weight matmuls differ in memory only."""
    jcfg, _, tree = ref
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    grads = []
    for kw in ({"remat": False}, {"remat": True},
               {"remat": True, "remat_policy": "dots_no_batch"}):
        params = _live(tree)
        tl.loss_fn(_port_cfg(jcfg, **kw))(params, batch).backward()
        grads.append([p.grad for p in tree_leaves(params)])
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-7)
    with pytest.raises(ValueError, match="remat_policy"):
        tl.loss_fn(_port_cfg(jcfg, remat=True, remat_policy="nope"))(
            _live(tree), batch)


def _ref_step(jcfg, jparams, jtx, **kw):
    mesh = pmesh.create_mesh(devices=jax.devices()[:1])
    rules = ShardingRules([(r".*", P())])
    state = jstep.init_state(jparams, jtx, mesh, rules)
    return state, jstep.make_train_step(jl.loss_fn(jcfg), jtx, mesh, rules,
                                        **kw)


@pytest.mark.parametrize("opt", ["adamw", "sgd_momentum"])
def test_train_step_trajectory_matches_mxtpu(ref, opt):
    jcfg, jparams, tree = ref
    jtx, ttx = {"adamw": (optax.adamw(1e-2), optim.adamw(1e-2)),
                "sgd_momentum": (optax.sgd(0.1, momentum=0.9),
                                 optim.sgd(0.1, momentum=0.9))}[opt]
    jstate, jfn = _ref_step(jcfg, jparams, jtx)
    tstate = tstep.init_state(tl.params_from_numpy(tree, device="cpu"), ttx)
    tfn = tstep.make_train_step(tl.loss_fn(_port_cfg(jcfg, remat=True)), ttx)
    batch = _batch(3)
    for _ in range(4):
        jstate, jloss = jfn(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tloss = tfn(tstate, {"tokens":
                                     torch.from_numpy(batch["tokens"])})
        np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    assert int(tstate.step) == int(jstate.step) == 4
    _assert_tree_close(tstate.params, jax.tree.map(np.asarray, jstate.params),
                       TOL, "param")


def test_grad_accum_matches_mxtpu(ref):
    jcfg, jparams, tree = ref
    jstate, jfn = _ref_step(jcfg, jparams, optax.sgd(0.1), grad_accum=2)
    tfn = tstep.make_train_step(tl.loss_fn(_port_cfg(jcfg)), optim.sgd(0.1),
                                grad_accum=2)
    tstate = tstep.init_state(tl.params_from_numpy(tree, device="cpu"),
                              optim.sgd(0.1))
    toks = _batch(4, b=4)["tokens"].reshape(2, 2, 16)   # 2 microbatches
    for _ in range(2):
        jstate, jloss = jfn(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tloss = tfn(tstate, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    _assert_tree_close(tstate.params, jax.tree.map(np.asarray, jstate.params),
                       TOL, "param")


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_keyed_step_trajectory_matches_mxtpu(ref, grad_accum):
    """has_rng: a loss that masks its targets with a Bernoulli draw from
    the step's key. Four sgd steps, step t keyed with fold_in(key, t);
    with grad_accum 2 each microbatch draws on fold_in(its key, i).
    jax's 64-bit mode draws a Python p in float64, so the port's
    bernoulli is given a float64 p."""
    jcfg, jparams, tree = ref

    def jloss(params, batch, rng):
        mask = jax.random.bernoulli(rng, 0.7, batch["tokens"].shape)
        return jl.loss_fn(jcfg)(params, {**batch, "mask": mask})
    tlf = tl.loss_fn(_port_cfg(jcfg))

    def tloss(params, batch, rng):
        mask = prng.bernoulli(rng, torch.tensor(0.7, dtype=torch.float64),
                              batch["tokens"].shape)
        return tlf(params, {**batch, "mask": mask})
    mesh = pmesh.create_mesh(devices=jax.devices()[:1])
    rules = ShardingRules([(r".*", P())])
    jstate = jstep.init_state(jparams, optax.sgd(0.1), mesh, rules)
    jfn = jstep.make_train_step(jloss, optax.sgd(0.1), mesh, rules,
                                has_rng=True, grad_accum=grad_accum)
    tstate = tstep.init_state(tl.params_from_numpy(tree, device="cpu"),
                              optim.sgd(0.1))
    tfn = tstep.make_train_step(tloss, optim.sgd(0.1), has_rng=True,
                                grad_accum=grad_accum)
    toks = _batch(9, b=4)["tokens"]
    if grad_accum > 1:
        toks = toks.reshape(grad_accum, 4 // grad_accum, 16)
    jkey, tkey = jax.random.PRNGKey(7), prng.PRNGKey(7, device="cpu")
    losses = []
    for t in range(4):
        jstate, jloss_t = jfn(jstate, {"tokens": jnp.asarray(toks)},
                              jax.random.fold_in(jkey, t))
        tstate, tloss_t = tfn(tstate, {"tokens": torch.from_numpy(toks)},
                              prng.fold_in(tkey, t))
        np.testing.assert_allclose(tloss_t.item(), float(jloss_t),
                                   **LOSS_TOL)
        losses.append(tloss_t.item())
    assert len(set(losses)) == 4         # each step drew another mask
    _assert_tree_close(tstate.params, jax.tree.map(np.asarray, jstate.params),
                       TOL, "param")


def test_skip_nonfinite_keeps_the_state_as_mxtpu_does(ref):
    """A NaN parameter poisons the loss: both steps skip, leaving params,
    optimizer state and the step count as they were."""
    jcfg, jparams, tree = ref
    poisoned = jax.tree.map(np.copy, tree)
    poisoned["lm_head"][0, 0] = np.nan
    jp = jax.tree.map(jnp.asarray, poisoned)
    jstate, jfn = _ref_step(jcfg, jp, optax.adamw(1e-2), skip_nonfinite=True)
    ttx = optim.adamw(1e-2)
    tstate = tstep.init_state(tl.params_from_numpy(poisoned, device="cpu"),
                              ttx)
    tfn = tstep.make_train_step(tl.loss_fn(_port_cfg(jcfg)), ttx,
                                skip_nonfinite=True)
    batch = _batch(5)["tokens"]
    jstate, jloss, jskipped = jfn(jstate, {"tokens": jnp.asarray(batch)})
    tstate, tloss, tskipped = tfn(tstate, {"tokens": torch.from_numpy(batch)})
    assert bool(jskipped) and bool(tskipped)
    assert not np.isfinite(float(jloss)) and not np.isfinite(tloss.item())
    assert int(tstate.step) == int(jstate.step) == 0
    assert int(tstate.opt_state.count) == 0
    assert all(bool((t == 0).all()) for t in
               tree_leaves((tstate.opt_state.mu, tstate.opt_state.nu)))
    kept = tl.params_to_numpy(tstate.params)
    for a, b in zip(jax.tree.leaves(kept), jax.tree.leaves(poisoned)):
        np.testing.assert_array_equal(a, b)
    # a finite step is taken, and reported as not skipped
    tstate = tstep.init_state(tl.params_from_numpy(tree, device="cpu"), ttx)
    tstate, _, tskipped = tfn(tstate, {"tokens": torch.from_numpy(batch)})
    assert not bool(tskipped) and int(tstate.step) == 1


def test_step_refuses_what_one_device_lacks(ref):
    jcfg, _, tree = ref
    lf = tl.loss_fn(_port_cfg(jcfg))
    # ported (item 11a): the step takes a parallel.mesh.Mesh, and rules
    # that place a parameter need one
    with pytest.raises(TypeError, match="mesh"):
        tstep.make_train_step(lf, optim.sgd(0.1), mesh=object())
    with pytest.raises(ValueError, match="rules"):
        tstep.make_train_step(lf, optim.sgd(0.1),
                              rules=[(r".*", ("fsdp",))])
    # has_rng is ported: the step passes its key to the loss
    seen = []
    keyed = tstep.make_train_step(
        lambda p, b, rng: seen.append(rng) or lf(p, b), optim.sgd(0.1),
        has_rng=True)
    state = tstep.init_state(tl.params_from_numpy(tree, device="cpu"),
                             optim.sgd(0.1))
    key = prng.PRNGKey(3, device="cpu")
    keyed(state, {"tokens": torch.from_numpy(_batch(8)["tokens"])}, key)
    assert len(seen) == 1 and seen[0] is key
    with pytest.raises(ValueError, match="has_state"):
        tstep.make_train_step(lf, optim.sgd(0.1), has_state=True,
                              loss_has_aux=True)
    # replicated-only rules are one device, as in the reference
    tstep.make_train_step(lf, optim.sgd(0.1), rules=[(r".*", P())])


def test_model_state_and_aux_thread_through_the_step(ref):
    """has_state threads a model state (a running count here) through
    the step; loss_has_aux returns aux; make_eval_step runs without grad."""
    jcfg, _, tree = ref
    lf = tl.loss_fn(_port_cfg(jcfg))
    batch = {"tokens": torch.from_numpy(_batch(6)["tokens"])}

    def with_state(params, ms, b):
        return lf(params, b), {"seen": ms["seen"] + 1}
    state = tstep.init_state(tl.params_from_numpy(tree, device="cpu"),
                             optim.sgd(0.1),
                             model_state={"seen": torch.zeros(())})
    fn = tstep.make_train_step(with_state, optim.sgd(0.1), has_state=True)
    for _ in range(2):
        state, loss = fn(state, batch)
    assert state.model_state["seen"].item() == 2.0

    def with_aux(params, b):
        loss = lf(params, b)
        return loss, {"twice": 2 * loss}
    fn = tstep.make_train_step(with_aux, optim.sgd(0.1), loss_has_aux=True)
    state, loss, aux = fn(state, batch)
    assert not aux["twice"].requires_grad
    np.testing.assert_allclose(aux["twice"].item(), 2 * loss.item())
    evaluate = tstep.make_eval_step(lf)
    assert not evaluate(state.params, batch).requires_grad


def test_llama_module_trains(ref):
    """The module's parameters require grad; loss() matches loss_fn."""
    jcfg, _, tree = ref
    model = tl.Llama(_port_cfg(jcfg), device="cpu")
    model.load_numpy_tree(tree)
    batch = {"tokens": torch.from_numpy(_batch(7)["tokens"])}
    loss = model.loss(batch)
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    want = tl.loss_fn(_port_cfg(jcfg))(tl.params_from_numpy(tree, "cpu"),
                                       batch)
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)
    out = model.generate(batch["tokens"][:, :4], 2)
    assert out.shape == (2, 6) and not out.requires_grad
