"""Parity of the port's ``optimizer``, ``initializer`` and
``lr_scheduler`` (``mxtpu_torch``) with ``mxtpu``'s on the CPU.

- Every update rule: a 4-step trajectory of two parameters (one with an
  lr and wd multiplier) from the same weights under the same gradients,
  through ``Updater``, weights and states compared after every step,
  within 1e-6 relative or 2 float32 ulps of the array's largest
  magnitude (the reference's jitted kernels may fuse a multiply into an
  add; the port rounds each op). SGD and Adam also through their
  multi-tensor ``fused_step``; SGLD's noise from the same seed.
- ``Updater.get_states``/``set_states`` round trips, with and without
  the optimizer, and states carried into a fresh updater continue the
  trajectory.
- Every initializer after ``mx.random.seed(s)`` gives the reference's
  weights (Orthogonal after the same numpy seed, which it draws from).
- Every lr scheduler gives the reference's rate at every step.
"""
import math

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx

torch.set_num_threads(2)

rng = np.random.default_rng(11)
W0 = [rng.standard_normal((3, 4)).astype(np.float32),
      rng.standard_normal((5,)).astype(np.float32)]
GRADS = [[rng.standard_normal(w.shape).astype(np.float32) for w in W0]
         for _ in range(4)]


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=2 * float(np.spacing(np.float32(top))),
                               err_msg=what)


def _states(st):
    if st is None:
        return []
    if isinstance(st, (tuple, list)):
        return [a for s in st for a in _states(s)]
    return [st.asnumpy()]


RULES = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, clip_gradient=0.5, rescale_grad=0.5)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("nag", dict(learning_rate=0.1)),
    ("adam", dict(learning_rate=0.01, wd=0.01)),
    ("adam", dict(learning_rate=0.01, clip_gradient=0.3)),
    ("adamw", dict(learning_rate=0.01, wd=0.1)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    ("adadelta", dict(rho=0.8, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=0.9)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.05, wd=0.01)),
    ("signum", dict(learning_rate=0.01, wd_lh=0.1)),
    ("signum", dict(learning_rate=0.01, momentum=0.0)),
    ("sgld", dict(learning_rate=0.01, wd=0.01)),
    ("lamb", dict(learning_rate=0.01, wd=0.01)),
    ("lamb", dict(learning_rate=0.01, lower_bound=0.5, upper_bound=2.0,
                  bias_correction=False)),
]


def trajectory(mx, ctx, name, kw, fused=False, dtype="float32",
               split_at=None):
    mx.random.seed(5)
    kw = dict(kw, multi_precision=dtype != "float32")
    opt = mx.optimizer.create(name, **kw)
    opt.set_lr_mult({1: 0.5})
    opt.set_wd_mult({1: 2.0})
    upd = mx.optimizer.get_updater(opt)
    ws = [mx.nd.array(w, ctx=ctx, dtype=dtype) for w in W0]
    out = []
    for step, gs in enumerate(GRADS):
        if step == split_at:
            blob = upd.get_states(dump_optimizer=True)
            upd = mx.optimizer.get_updater(mx.optimizer.create("sgd"))
            upd.set_states(blob)
            opt = upd.optimizer
        gnd = [mx.nd.array(g, ctx=ctx, dtype=dtype) for g in gs]
        if fused:
            for i, w in enumerate(ws):
                if i not in upd.states:
                    upd.states[i] = opt.create_state_multi_precision(i, w)
            assert opt.fused_step([0, 1], ws, gnd, [upd.states[0],
                                                    upd.states[1]])
        else:
            for i, (w, g) in enumerate(zip(ws, gnd)):
                upd(i, g, w)
        out.append([w.asnumpy() for w in ws] +
                   [a for i in (0, 1) for a in _states(upd.states.get(i))])
    return out


def check_trajectories(got, want, what):
    for step, (g_row, w_row) in enumerate(zip(got, want)):
        assert len(g_row) == len(w_row), what
        for k, (g, w) in enumerate(zip(g_row, w_row)):
            close(g, w, f"{what} step {step} array {k}")


@pytest.mark.parametrize("k", range(len(RULES)),
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(RULES)])
def test_rule_trajectory_matches_mxtpu(k):
    name, kw = RULES[k]
    want = trajectory(jmx, jmx.cpu(), name, kw)
    got = trajectory(tmx, "cpu", name, kw)
    check_trajectories(got, want, name)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, wd=0.01, rescale_grad=0.25)),
    ("adam", dict(learning_rate=0.01, wd=0.01, rescale_grad=0.5)),
])
def test_fused_step_matches_mxtpu(name, kw):
    want = trajectory(jmx, jmx.cpu(), name, kw, fused=True)
    got = trajectory(tmx, "cpu", name, kw, fused=True)
    check_trajectories(got, want, name + " fused")
    # the fused sequence is the per-parameter rule
    check_trajectories(got, trajectory(tmx, "cpu", name, kw), name)


def test_multi_precision_matches_mxtpu():
    kw = dict(learning_rate=0.1, momentum=0.9)
    want = trajectory(jmx, jmx.cpu(), "sgd", kw, dtype="float16")
    got = trajectory(tmx, "cpu", "sgd", kw, dtype="float16")
    check_trajectories(got, want, "sgd multi_precision")


@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_updater_states_round_trip(name):
    """States dumped with the optimizer after two steps and loaded into
    a fresh updater continue the same trajectory, in both packages."""
    kw = dict(RULES[[n for n, _ in RULES].index(name)][1])
    want = trajectory(jmx, jmx.cpu(), name, kw, split_at=2)
    got = trajectory(tmx, "cpu", name, kw, split_at=2)
    check_trajectories(got, want, name + " split")
    check_trajectories(got, trajectory(tmx, "cpu", name, kw), name)
    upd = tmx.optimizer.get_updater(tmx.optimizer.create(name))
    w = tmx.nd.array(W0[0], ctx="cpu")
    upd(0, tmx.nd.array(GRADS[0][0], ctx="cpu"), w)
    blob = upd.get_states()
    fresh = tmx.optimizer.get_updater(tmx.optimizer.create(name))
    fresh.set_states(blob)
    for a, b in zip(_states(fresh.states[0]), _states(upd.states[0])):
        np.testing.assert_array_equal(a, b)
    assert fresh.states[0] is not None and \
        _states(fresh.states[0])[0].dtype == np.float32


def test_registry_and_errors():
    assert sorted(tmx.optimizer.Optimizer.opt_registry) == \
        sorted(jmx.optimizer.Optimizer.opt_registry)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tmx.optimizer.create("nope")
    sched = tmx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt = tmx.optimizer.create("sgd", learning_rate=0.2, lr_scheduler=sched)
    with pytest.raises(UserWarning):
        opt.set_learning_rate(0.1)


INITS = [
    ("zero", {}), ("one", {}), ("constant", dict(value=0.25)),
    ("uniform", dict(scale=0.3)), ("normal", dict(sigma=0.2)),
    ("xavier", {}), ("xavier", dict(rnd_type="gaussian", factor_type="in",
                                    magnitude=2)),
    ("xavier", dict(factor_type="out")), ("msraprelu", dict(slope=0.1)),
    ("orthogonal", {}), ("orthogonal", dict(rand_type="normal")),
    ("bilinear", {}),
]
SHAPES = {"bilinear": (2, 3, 4, 4)}


def init_weights(mx, ctx, name, kw, seed):
    mx.random.seed(seed)
    np.random.seed(seed)
    init = mx.initializer.create(name, **kw)
    shape = SHAPES.get(name, (6, 4, 3))
    out = []
    for pname in ("fc_weight", "fc_bias", "bn_gamma", "bn_beta",
                  "bn_running_mean", "bn_running_var", "other"):
        arr = mx.nd.zeros(shape if pname in ("fc_weight", "other")
                          else shape[:1], ctx=ctx)
        init(mx.initializer.InitDesc(pname), arr)
        out.append(arr.asnumpy())
    return out


@pytest.mark.parametrize("k", range(len(INITS)),
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(INITS)])
def test_initializer_matches_mxtpu(k):
    name, kw = INITS[k]
    for seed in (0, 3):
        want = init_weights(jmx, jmx.cpu(), name, kw, seed)
        got = init_weights(tmx, "cpu", name, kw, seed)
        for g, w in zip(got, want):
            close(g, w, f"{name} seed {seed}")


def test_mixed_and_attr_initializers_match_mxtpu():
    def run(mx, ctx):
        mx.random.seed(1)
        mixed = mx.initializer.Mixed(["bias$", ".*"],
                                     [mx.initializer.Constant(0.5),
                                      mx.initializer.Uniform(0.1)])
        a, b = mx.nd.zeros((3, 4), ctx=ctx), mx.nd.zeros((3,), ctx=ctx)
        mixed("fc_weight", a)
        mixed("fc_bias", b)
        c = mx.nd.zeros((4, 5), ctx=ctx)
        desc = mx.initializer.InitDesc(
            "w_mean", attrs={"__init__": mx.initializer.Normal(0.5).dumps()})
        mx.initializer.Zero()(desc, c)
        return [a.asnumpy(), b.asnumpy(), c.asnumpy()]
    for g, w in zip(run(tmx, "cpu"), run(jmx, jmx.cpu())):
        close(g, w, "mixed")


def test_lstm_bias_sets_the_forget_gate():
    """The reference's LSTMBias writes into a read-only host copy and
    raises; the port's gives the forget-gate slice its bias, zeros
    elsewhere."""
    arr = tmx.nd.ones((8,), ctx="cpu")
    tmx.init.LSTMBias(forget_bias=2.0)(tmx.initializer.InitDesc("l_bias"),
                                       arr)
    np.testing.assert_array_equal(arr.asnumpy(), [0, 0, 2, 2, 0, 0, 0, 0])
    with pytest.raises(ValueError, match="read-only"):
        jmx.initializer.LSTMBias(forget_bias=2.0)(
            jmx.initializer.InitDesc("l_bias"), jmx.nd.ones((8,)))


SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, stop_factor_lr=1e-3,
                             base_lr=0.1, warmup_steps=2)),
    ("MultiFactorScheduler", dict(step=[3, 7, 12], factor=0.3,
                                  base_lr=0.2, warmup_steps=2,
                                  warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=20, base_lr=0.1, pwr=3, final_lr=1e-3,
                           warmup_steps=4, warmup_begin_lr=0.01)),
    ("CosineScheduler", dict(max_update=20, base_lr=0.1, final_lr=1e-3,
                             warmup_steps=3)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS)
def test_lr_scheduler_matches_mxtpu(name, kw):
    ref = getattr(jmx.lr_scheduler, name)(**kw)
    got = getattr(tmx.lr_scheduler, name)(**kw)
    for t in range(30):
        assert got(t) == ref(t), (name, t)
    assert math.isfinite(got(100))
