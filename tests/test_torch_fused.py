"""``Trainer.make_fused_step`` of the port (``mxtpu_torch.gluon.fused``)
against the reference's fused step (``mxtpu.gluon.fused``).

The reference runs its step on its CPU mesh (``create_mesh(dp=-1)``, the
suite's 8 host devices); the port runs on one device, on the CPU, where
the step body runs eagerly. Both nets start from the same weights
(``mx.random.seed(0)`` and the bit-equal initializers) and see the same
numpy batches. Losses, parameters and optimizer state agree within
1e-5 relative to the largest magnitude of each array, and parameters
within 1e-5 of the net's largest parameter magnitude (float32; the two
compute the same ops in the same order, grouped differently, and a
bias feeding a BatchNorm has a zero gradient whose noise is its whole
value). The
CUDA-graph branch runs here through a stand-in graph that replays the
captured function, as on the card a replay reruns the captured step.
"""
import importlib

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.parallel import mesh as jmesh
from mxtpu.parallel.sharding import P as JP, ShardingRules as JRules
from mxtpu_torch import checkpoint
from mxtpu_torch.gluon import fused as tfused
from mxtpu_torch.parallel import mesh as tmesh
from mxtpu_torch.parallel.sharding import P as TP, ShardingRules as TRules

torch.set_num_threads(2)

PKGS = {"ref": (jmx, jmx.cpu(), jmesh, JRules, JP),
        "port": (tmx, "cpu", tmesh, TRules, TP)}
RTOL = 1e-5

rng = np.random.default_rng(0)
X16 = rng.standard_normal((32, 16)).astype(np.float32)
Y8 = rng.standard_normal((32, 8)).astype(np.float32)
X8 = rng.standard_normal((32, 8)).astype(np.float32)
Y4 = rng.standard_normal((32, 4)).astype(np.float32)


def near(got, want, what, rtol=RTOL, scale=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = max(float(np.abs(want).max()) if want.size else 0.0, scale)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * top,
                               err_msg=what)


def net_of(mx, ctx, bn=False, dtype=None):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="f_")
    with net.name_scope():
        if bn:
            net.add(nn.Dense(16, in_units=8), nn.BatchNorm(in_channels=16),
                    nn.Dense(4, in_units=16))
        else:
            net.add(nn.Dense(32, activation="relu", in_units=16),
                    nn.Dense(8, in_units=32))
    mx.random.seed(0)
    net.initialize(ctx=ctx)
    if dtype is not None:
        for p in net.collect_params().values():
            p.cast(dtype)
    return net


def amp_of(mx):
    return importlib.import_module(mx.__name__ + ".amp")


def batch_of(mx, ctx, bn=False, dtype=None):
    xs, ys = (X8, Y4) if bn else (X16, Y8)
    if dtype == "bfloat16":             # numpy has none: via float32
        return (mx.nd.array(xs, ctx=ctx, dtype=dtype),
                mx.nd.array(ys, ctx=ctx, dtype=dtype))
    if dtype is not None:
        xs, ys = xs.astype(dtype), ys.astype(dtype)
    return (mx.nd.array(xs, ctx=ctx, dtype=xs.dtype),
            mx.nd.array(ys, ctx=ctx, dtype=ys.dtype))


def run(which, opt, kw, steps=4, bn=False, amp=None, scale=None,
        edit=None, accum=1, dtype=None, seed=None):
    """A fused step of ``opt`` on the dense (or BatchNorm) net: the
    losses, the parameters by name, and the step."""
    mx, ctx, mesh, Rules, P = PKGS[which]
    net = net_of(mx, ctx, bn, dtype)
    net.hybridize()
    net.shard(mesh.create_mesh(dp=-1), Rules([(r".*", P())]))
    tr = mx.gluon.Trainer(net.collect_params(), opt, dict(kw))
    if amp is not None:
        amp_of(mx).init(amp)
        amp_of(mx).init_trainer(tr)
        if scale is not None:
            tr._amp_loss_scaler.loss_scale = scale
    x, y = batch_of(mx, ctx, bn, dtype)
    step = tr.make_fused_step(
        net, loss_fn=lambda out, t: ((out - t) ** 2).mean(),
        grad_accum=accum, loss_args=1)
    if seed is not None:
        mx.random.seed(seed)
    losses = []
    for i in range(steps):
        if edit is not None:
            edit(i, tr)
        losses.append(float(step(x, y).asscalar()))
    return losses, {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}, step, tr


def check_same(got, want, what, rtol=RTOL):
    near(got[0], want[0], f"{what} losses", rtol)
    assert sorted(got[1]) == sorted(want[1]), what
    top = max(float(np.abs(v).max()) for v in want[1].values())
    for name in want[1]:
        near(got[1][name], want[1][name], f"{what} {name}", rtol, top)


def state_leaves(states):
    import jax
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(states)]


def lr_edit(i, tr):
    if i == 2:
        tr.set_learning_rate(0.05)


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 1.0}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01}),
    ("lamb", {"learning_rate": 0.01, "bias_correction": False,
              "lower_bound": 0.1, "upper_bound": 10.0}),
    ("adagrad", {"learning_rate": 0.05, "wd": 0.01}),
    ("adadelta", {"rho": 0.9, "epsilon": 1e-5}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.01}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
])
def test_optimizer_families_match_mxtpu(opt, kw):
    """Every family's trajectory, parameters and optimizer state, with
    an lr edit at step 2 that recompiles nothing."""
    want = run("ref", opt, kw, edit=lr_edit)
    got = run("port", opt, kw, edit=lr_edit)
    check_same(got, want, opt)
    w_state = state_leaves(want[2]._opt_states)
    g_state = [t.numpy() for s in got[2]._opt_states
               for t in tfused._leaves(s)]
    assert len(g_state) == len(w_state), opt
    for k, (g, w) in enumerate(zip(g_state, w_state)):
        near(g, w, f"{opt} state {k}")
    assert got[2].num_compiles() == want[2].num_compiles() == 1
    assert got[2].applied_updates() == 4


def test_matches_the_classic_trainer():
    """The fused step against the port's own record/backward/step."""
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
          "clip_gradient": 1.0}
    got = run("port", "sgd", kw, edit=lr_edit)
    net = net_of(tmx, "cpu")
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(kw))
    x, y = tmx.nd.array(X16, ctx="cpu"), tmx.nd.array(Y8, ctx="cpu")
    losses = []
    for i in range(4):
        lr_edit(i, tr)
        with tmx.autograd.record():
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        tr.step(1)
        losses.append(float(loss.asscalar()))
    check_same(got, (losses, {n: p.data().asnumpy() for n, p in
                              net.collect_params().items()}), "classic")
    assert all(s is not None for s in got[2]._opt_states)


def test_batchnorm_state_and_grad_accum():
    """BatchNorm's running statistics thread through the step, and
    through 4 microbatches in order; an indivisible batch refuses."""
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    for accum in (1, 4):
        want = run("ref", "sgd", kw, steps=3, bn=True, accum=accum)
        got = run("port", "sgd", kw, steps=3, bn=True, accum=accum)
        check_same(got, want, f"grad_accum={accum}")
        assert any("running" in n for n in got[1])
        assert got[2].num_compiles() == 1
    with pytest.raises(tmx.MXNetError, match="divisible"):
        got[2](tmx.nd.array(np.zeros((30, 8), np.float32), ctx="cpu"),
               tmx.nd.array(np.zeros((30, 4), np.float32), ctx="cpu"))


def test_multi_precision_bf16_matches_the_classic_trainer():
    """bfloat16 parameters on float32 masters (``multi_precision``, a
    branch the reference's fused rules do not have), with BatchNorm and
    ``grad_accum=2``, against the port's classic Trainer accumulating
    two microbatch backwards (``grad_req="add"``) and stepping over
    both: the losses, the bfloat16 parameters, the running statistics
    and the float32 masters agree bit for bit (the same ops in the same
    order)."""
    kw = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}
    got = run("port", "sgd", kw, steps=3, bn=True, accum=2,
              dtype="bfloat16")
    net = net_of(tmx, "cpu", bn=True)
    for p in net.collect_params().values():
        if p.grad_req != "null":
            p.grad_req = "add"
    net.collect_params().cast("bfloat16")
    net.hybridize()
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(kw))
    x, y = batch_of(tmx, "cpu", True, "bfloat16")
    half = x.shape[0] // 2
    losses = []
    for _ in range(3):
        tr.zero_grad()
        total = None
        for i in range(2):
            xi, yi = x[i * half:(i + 1) * half], y[i * half:(i + 1) * half]
            with tmx.autograd.record():
                loss = ((net(xi) - yi) ** 2).mean()
            loss.backward()
            total = loss if total is None else total + loss
        tr.step(2)
        losses.append(float((total / 2).asscalar()))
    want = (losses, {n: p.data().asnumpy()
                     for n, p in net.collect_params().items()})
    check_same(got, want, "multi_precision", rtol=0.0)
    assert all(v.dtype == torch.bfloat16 for v in got[2]._static.live)
    # the running statistics leave the step in float32, as the classic
    # step leaves them (and the reference's)
    assert [v.dtype for v in got[2]._static.frozen] == \
        [p.data()._data.dtype for p in tr._params
         if p.grad_req == "null"] == [torch.float32] * 2
    masters = [s[0] for s in got[2]._opt_states]
    assert all(m.dtype == torch.float32 for m in masters)
    live = [i for i, p in enumerate(tr._params) if p.grad_req != "null"]
    assert len(live) == len(masters) == 6
    for i, m in zip(live, masters):
        near(m.numpy(), tr._updaters[0].states[i][0].asnumpy(),
             f"master {tr._params[i].name}", 0.0)


def test_sgld_noise_follows_the_key_chain():
    """SGLD's noise comes from the step's key folded per parameter: the
    same ``mx.random.seed`` gives the reference's draws (normal within
    a few float32 ulps), fresh at every step."""
    kw = {"learning_rate": 1e-3, "wd": 0.0}
    want = run("ref", "sgld", kw, steps=2, seed=1234)
    got = run("port", "sgld", kw, steps=2, seed=1234)
    check_same(got, want, "sgld")
    one = run("port", "sgld", kw, steps=1, seed=1234)[1]
    drift = {n: got[1][n] - one[n] for n in one}
    assert max(np.abs(v).max() for v in drift.values()) > 1e-3


def test_dynamic_amp_overflow_skips_and_halves():
    """float16 AMP from a scale of 1e38 (capped at 2**126): step 1
    overflows, is skipped and halves the scale; steps 2-4 apply."""
    kw = {"learning_rate": 0.001, "momentum": 0.9}
    global Y8
    big = Y8
    Y8 = (100.0 * Y8).astype(np.float32)   # raw grads ~5: scaled, inf
    try:
        want = run("ref", "sgd", kw, amp="float16", scale=1e38)
        got = run("port", "sgd", kw, amp="float16", scale=1e38)
    finally:
        Y8 = big
    check_same(got, want, "amp")
    step, tr = got[2], got[3]
    assert step.loss_scale() == want[2].loss_scale() == 2.0 ** 125
    assert float(tr._amp_loss_scaler.loss_scale) == 2.0 ** 125
    assert step.applied_updates() == want[2].applied_updates() == 3
    assert got[0][1] == got[0][0] and got[0][3] < got[0][1]
    assert step.num_compiles() == 1


def test_dynamic_amp_adam_counts_applied_updates():
    """Under dynamic AMP Adam's bias correction counts applied updates:
    the reference's trajectory through a skipped step, within the
    reference test's own 2e-4 (Adam's m/sqrt(v) turns last-ulp
    gradient differences in near-zero elements into update-sized
    ones; the losses stay within 1e-5)."""
    global Y8
    big = Y8
    Y8 = (100.0 * Y8).astype(np.float32)
    try:
        want = run("ref", "adam", {"learning_rate": 0.01},
                   amp="float16", scale=1e38)
        got = run("port", "adam", {"learning_rate": 0.01},
                  amp="float16", scale=1e38)
    finally:
        Y8 = big
    near(got[0], want[0], "amp adam losses")
    check_same(got, want, "amp adam", rtol=2e-4)
    assert got[2].applied_updates() == want[2].applied_updates() == 3


def test_amp_float16_params_keep_dtype_and_late_init_raises():
    got = run("port", "sgd", {"learning_rate": 0.01}, steps=2,
              amp="float16", dtype="float16")
    assert all(v.dtype == np.float16 for v in got[1].values())
    assert got[2].num_compiles() == 1
    _, _, step, tr = run("port", "sgd", {"learning_rate": 0.1}, steps=1)
    tmx.amp.init("float16")
    tmx.amp.init_trainer(tr)                       # too late
    x = tmx.nd.array(X16, ctx="cpu")
    with pytest.raises(tmx.MXNetError, match="make_fused_step again"):
        step(x, tmx.nd.array(Y8, ctx="cpu"))


def test_retrace_on_frozen_knobs_and_state_width():
    """A momentum/clip edit rebuilds (2 variants); momentum 0 → 0.9
    re-creates the state zeroed. Both match the reference."""
    def knobs(i, tr):
        if i == 2:
            tr._optimizer.momentum = 0.5
            tr._optimizer.clip_gradient = 0.5

    def width(i, tr):
        if i == 2:
            tr._optimizer.momentum = 0.9

    for edit, kw in ((knobs, {"learning_rate": 0.05, "momentum": 0.9}),
                     (width, {"learning_rate": 0.05, "momentum": 0.0})):
        want = run("ref", "sgd", kw, edit=edit)
        got = run("port", "sgd", kw, edit=edit)
        check_same(got, want, edit.__name__)
        assert got[2].num_compiles() == want[2].num_compiles() == 2
        assert all(s is not None for s in got[2]._opt_states)


def test_state_dict_resumes_through_checkpoint(tmp_path):
    """A state_dict saved through ``mxtpu_torch.checkpoint`` and loaded
    into a freshly built step resumes the same trajectory, bit for bit;
    dynamic AMP's state rides along."""
    kw = {"learning_rate": 0.01}
    whole = run("port", "adam", kw, steps=4, amp="float16")
    first = run("port", "adam", kw, steps=2, amp="float16")
    checkpoint.save_state(str(tmp_path / "s"), first[2].state_dict())
    mx, ctx, mesh, Rules, P = PKGS["port"]
    tmx.random.seed(7)                 # other weights, overwritten
    net = net_of(tmx, "cpu")
    net.hybridize()
    net.shard(mesh.create_mesh(dp=-1), Rules([(r".*", P())]))
    tr = tmx.gluon.Trainer(net.collect_params(), "adam", dict(kw))
    tmx.amp.init("float16")
    tmx.amp.init_trainer(tr)
    step = tr.make_fused_step(
        net, loss_fn=lambda out, t: ((out - t) ** 2).mean(), loss_args=1)
    step.load_state_dict(checkpoint.load_state(
        str(tmp_path / "s"), step.state_dict(), device="cpu"))
    x, y = tmx.nd.array(X16, ctx="cpu"), tmx.nd.array(Y8, ctx="cpu")
    losses = [float(step(x, y).asscalar()) for _ in range(2)]
    assert losses == whole[0][2:]
    for n, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), whole[1][n])
    assert step.applied_updates() == 4
    with pytest.raises(tmx.MXNetError, match="no parameter"):
        step.load_state_dict({"params": {}})


class _StandInGraph:
    """What a replay computes: the captured step, run again."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _stand_in_capture(build, fn, warm, device):
    warm()
    return _StandInGraph(fn)


@pytest.mark.parametrize("opt,kw,bn,accum,dtype", [
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}, False, 1, None),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}, True, 2, None),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
             "multi_precision": True}, True, 2, "bfloat16")])
def test_cuda_graph_branch_with_a_stand_in_graph(monkeypatch, opt, kw, bn,
                                                 accum, dtype):
    """The card's branch: one capture across steps and an lr edit, the
    trajectory the eager branch gives bit for bit (BatchNorm's running
    statistics threaded through two microbatches too, and in a bfloat16
    net on float32 masters, where the first step settles the statistics'
    dtype), a parameter rebound between steps copied in, and the live
    Parameters bound to the step's own tensors."""

    def rebind(i, tr):
        lr_edit(i, tr)
        if i == 3:
            p = tr._params[0]
            p.set_data(p.data() * 0.5)

    eager = run("port", opt, kw, edit=rebind, bn=bn, accum=accum,
                dtype=dtype)
    monkeypatch.setattr(tfused, "_graphs_on", lambda device: True)
    monkeypatch.setattr(tfused, "capture_graph", _stand_in_capture)
    graph = run("port", opt, kw, edit=rebind, bn=bn, accum=accum,
                dtype=dtype)
    assert graph[0] == eager[0]
    for n in eager[1]:
        np.testing.assert_array_equal(graph[1][n], eager[1][n])
    step, tr = graph[2], graph[3]
    assert step.num_compiles() == 1
    live = [p for p in tr._params if p.grad_req != "null"]
    frozen = [p for p in tr._params if p.grad_req == "null"]
    assert len(frozen) == (2 if bn else 0)
    assert all(p._data._data is t for p, t in
               zip(live + frozen, step._static.live + step._static.frozen))


def test_mesh_subset_and_shard_checks():
    mesh = tmesh.create_mesh(dp=-1)
    assert mesh.size == 1 and tmesh.axis_size("dp", mesh) == 1
    with tmesh.use_mesh(mesh):
        assert tmesh.current_mesh() is mesh
        assert tmesh.mesh_axes() == tmesh.MESH_AXES
    for bad in (dict(tp=2), dict(dp=4)):
        with pytest.raises(NotImplementedError, match="item 11"):
            tmesh.create_mesh(**bad)
    net = tmx.gluon.nn.Dense(4, prefix="s_")
    net.initialize(ctx="cpu")                    # deferred in_units
    with pytest.raises(tmx.MXNetError, match="deferred"):
        net.shard(mesh, TRules([]))
    with pytest.raises(ValueError, match="lack"):
        run_net = net_of(tmx, "cpu")
        run_net.shard(mesh, TRules([(r".*", TP("model"))]))
