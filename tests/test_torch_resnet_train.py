"""The port's ResNet train step against mxtpu's on the CPU.

``make_train_step(resnet.loss_fn(cfg), sgd(0.1, momentum=0.9),
has_state=True)`` in both packages, ``tiny`` (depth 18, width 8) in
f32, from the same numpy weights and running statistics
(``test_torch_resnet_refs``) on the same seeded batch, for 4 steps; the
reference runs on a one-device mesh. After every step the loss, every
parameter and every running BN statistic are compared.

The oracle is the reference's step with the space-to-depth stem, for
both of the port's stems: the s2d stem is an exact rewrite of the
standard one, and the reference's own standard-stem step is the odd one
out. Over these 4 steps the port's std and s2d trajectories and the
reference's s2d trajectory agree within 2.3e-5, while the reference's
std trajectory leaves all three at step 3 (4e-3, then 6e-2 at step 4);
that is the red reference test
``tests/test_models.py::test_resnet_s2d_stem_train_trajectory_matches_std``.
The port's std step is held against the reference's std step where
both start from the same state: the first step.

Tolerance ``atol=rtol=1e-4`` for the loss, params and statistics: f32
on both sides, differing in summation order only (seen: params and
statistics within 2.3e-5 after 4 steps; the loss within 2.2e-5
relative, at step 3).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_resnet_refs as refs
from mxtpu.models import resnet as jr
from mxtpu.parallel import mesh as pmesh, step as jstep
from mxtpu.parallel.sharding import P, ShardingRules
from mxtpu_torch.models import resnet as tr
from mxtpu_torch.parallel import optim, step as tstep

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 4


def _batch():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=8).astype(np.int32))


def _ref_trajectory(stem, steps):
    """[(loss, params leaves, state leaves)] after each reference step,
    copied out of the (donated) state."""
    ptree, stree = refs.weights("tiny")
    jcfg = replace(jr.CONFIGS["tiny"], dtype=jnp.float32, stem=stem)
    mesh = pmesh.create_mesh(devices=jax.devices()[:1])
    rules = ShardingRules([(r".*", P())])
    tx = optax.sgd(0.1, momentum=0.9)
    state = jstep.init_state(jax.tree.map(jnp.asarray, ptree), tx, mesh,
                             rules,
                             model_state=jax.tree.map(jnp.asarray, stree))
    fn = jstep.make_train_step(jr.loss_fn(jcfg), tx, mesh, rules,
                               has_state=True)
    images, labels = _batch()
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    out = []
    for _ in range(steps):
        state, loss = fn(state, batch)
        out.append((float(loss), [np.array(a) for a in
                                  jax.tree.leaves(state.params)],
                    [np.array(a) for a in jax.tree.leaves(state.model_state)]))
    assert int(state.step) == steps
    return out


@pytest.fixture(scope="module")
def ref_s2d():
    return _ref_trajectory("s2d", STEPS)


def _port_trajectory(stem, steps):
    ptree, stree = refs.weights("tiny")
    tcfg = replace(tr.CONFIGS["tiny"], dtype=torch.float32, stem=stem)
    tx = optim.sgd(0.1, momentum=0.9)
    state = tstep.init_state(
        tr.params_from_numpy(ptree, device="cpu"), tx,
        model_state=tr.params_from_numpy(stree, device="cpu"))
    fn = tstep.make_train_step(tr.loss_fn(tcfg), tx, has_state=True)
    images, labels = _batch()
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)}
    for _ in range(steps):
        state, loss = fn(state, batch)
        yield state, loss


def _assert_step_close(state, loss, want, what):
    wloss, wparams, wstate = want
    np.testing.assert_allclose(loss.item(), wloss, err_msg=what, **TOL)
    for kind, tree, leaves in (("param", state.params, wparams),
                               ("BN state", state.model_state, wstate)):
        got = refs.leaves(tr.params_to_numpy(tree))
        assert len(got) == len(leaves)
        for i, (a, b) in enumerate(zip(got, leaves)):
            np.testing.assert_allclose(a, b, err_msg=f"{what}: {kind} {i}",
                                       **TOL)


@pytest.mark.parametrize("stem", ["std", "s2d"])
def test_train_trajectory_matches_mxtpu(ref_s2d, stem):
    losses = []
    for i, (state, loss) in enumerate(_port_trajectory(stem, STEPS)):
        _assert_step_close(state, loss, ref_s2d[i], f"step {i + 1}")
        losses.append(loss.item())
    assert int(state.step) == STEPS
    assert losses[-1] < losses[0]
    # every running statistic moved, and none of them requires grad
    _, stree = refs.weights("tiny")
    moved = [not np.array_equal(a, b) for a, b in zip(
        refs.leaves(tr.params_to_numpy(state.model_state)),
        refs.leaves(stree))]
    assert all(moved)
    assert not any(t.requires_grad for t in
                   jax.tree.leaves(state.model_state))


def test_first_std_step_matches_mxtpu_std():
    want = _ref_trajectory("std", 1)[0]
    state, loss = next(_port_trajectory("std", 1))
    _assert_step_close(state, loss, want, "step 1")
