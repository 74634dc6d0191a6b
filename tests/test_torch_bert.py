"""Parity of mxtpu_torch.models.bert with mxtpu.models.bert on the CPU.

The port is held on the reference's weights: mxtpu's ``init_params``
draws the tiny tree with jax (stacked layers, and a list of per-layer
dicts with ``scan_layers=False``), it crosses as numpy, and both
packages run the same batch from a seeded numpy generator in float32.
Held here: ``forward`` with a padded mask (a fully padded row too),
``mlm_logits``, ``loss_fn`` with and without NSP and every grad leaf,
a 3-step adamw trajectory through ``make_train_step``, the
``max_seq_len`` raise, the list layout through ``params_from_numpy``,
and the ``Bert`` module. bf16 compute is held within a bound against
f32 on the same weights.

Tolerances: outputs and loss ``atol=rtol=1e-5`` (f32 on both sides,
two 64-wide layers); grads ``1e-4`` relative to each leaf's largest;
params after 3 adamw steps ``atol=rtol=1e-4``.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mxtpu.models import bert as jb
from mxtpu.parallel import mesh as pmesh, step as jstep
from mxtpu.parallel.sharding import P, ShardingRules
from mxtpu_torch.models import bert as tb
from mxtpu_torch.parallel import optim, step as tstep
from mxtpu_torch.parallel._tree import tree_leaves, tree_map

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL = 1e-4
B, S, NP = 3, 16, 4


def _port_cfg(jcfg, **kw):
    vals = {k: getattr(jcfg, k) for k in (
        "vocab_size", "dim", "n_layers", "n_heads", "hidden_dim",
        "max_seq_len", "type_vocab_size", "norm_eps", "remat",
        "scan_layers")}
    return tb.BertConfig(**{"dtype": torch.float32,
                            "param_dtype": torch.float32, **vals, **kw})


_TREES = {}


def _ref(scan=True):
    """(jax cfg, jax params, numpy tree) for the tiny f32 model."""
    if scan not in _TREES:
        jcfg = replace(jb.CONFIGS["tiny"], dtype=jnp.float32,
                       scan_layers=scan)
        jparams = jb.init_params(jcfg, jax.random.PRNGKey(0))
        _TREES[scan] = (jcfg, jparams, jax.tree.map(np.asarray, jparams))
    return _TREES[scan]


def _batch(seed, nsp=True):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.float32)
    mask[1, 11:] = 0.0                       # a padded row
    mask[2, :] = 0.0                         # a fully padded row
    out = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
           "token_types": (np.arange(S) >= S // 2).astype(np.int32)[None]
           .repeat(B, 0),
           "mask": mask,
           "mlm_positions": rng.integers(0, S, (B, NP)).astype(np.int32),
           "mlm_labels": rng.integers(0, 256, (B, NP)).astype(np.int32),
           "mlm_weights": (rng.random((B, NP)) > 0.25).astype(np.float32)}
    if nsp:
        out["nsp_labels"] = rng.integers(0, 2, (B,)).astype(np.int32)
    return out


def _live(tree):
    params = tb.params_from_numpy(tree, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


@pytest.mark.parametrize("scan", [True, False])
def test_forward_and_mlm_logits_match_mxtpu(scan):
    jcfg, jparams, tree = _ref(scan)
    batch = _batch(0)
    args = [batch[k] for k in ("tokens", "token_types", "mask")]
    seq, pooled = jax.jit(jb.forward, static_argnums=0)(
        jcfg, jparams, *map(jnp.asarray, args))
    wlog = jb.mlm_logits(jcfg, jparams, seq)
    tp = tb.params_from_numpy(tree, device="cpu")
    if not scan:
        assert isinstance(tp["layers"], list) and len(tp["layers"]) == 2
    tcfg = _port_cfg(jcfg)
    gseq, gpool = tb.forward(tcfg, tp, *map(torch.from_numpy, args))
    assert gseq.dtype == gpool.dtype == torch.float32
    assert gseq.shape == (B, S, 64) and gpool.shape == (B, 64)
    np.testing.assert_allclose(gseq.numpy(), np.asarray(seq), **TOL)
    np.testing.assert_allclose(gpool.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(tb.mlm_logits(tcfg, tp, gseq).numpy(),
                               np.asarray(wlog), **TOL)
    # defaults: all attended, type 0
    seq0, _ = jb.forward(jcfg, jparams, jnp.asarray(args[0]))
    got0, _ = tb.forward(tcfg, tp, torch.from_numpy(args[0]))
    np.testing.assert_allclose(got0.numpy(), np.asarray(seq0), **TOL)


def test_gelu_is_the_tanh_approximation():
    """At init the FFN's and the MLM head's GELU inputs are about 0.2,
    where erf and tanh GELU differ by about 1e-6; with those weights
    scaled by 25 the inputs reach |x| of 2-5, the two forms differ by
    up to 5e-4, and the outputs still match the reference's within
    1e-5."""
    jcfg, _, tree = _ref()
    tree = jax.tree.map(np.copy, tree)
    tree["layers"]["ffn_in_w"] *= 25.0
    tree["mlm_w"] *= 25.0
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = _batch(5)["tokens"]
    seq, _ = jb.forward(jcfg, jparams, jnp.asarray(tokens))
    want = jb.mlm_logits(jcfg, jparams, seq)
    tcfg, tp = _port_cfg(jcfg), tb.params_from_numpy(tree, device="cpu")
    gseq, _ = tb.forward(tcfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(gseq.numpy(), np.asarray(seq), **TOL)
    np.testing.assert_allclose(tb.mlm_logits(tcfg, tp, gseq).numpy(),
                               np.asarray(want), **TOL)
    x = torch.linspace(-5, 5, 101)
    gap = (torch.nn.functional.gelu(x) - torch.nn.functional.gelu(
        x, approximate="tanh")).abs().max().item()
    assert gap > 10 * TOL["atol"]


def test_max_seq_len_raises():
    jcfg, _, tree = _ref()
    tp = tb.params_from_numpy(tree, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        tb.forward(_port_cfg(jcfg), tp, torch.zeros((1, 65), dtype=int))
    # ported (item 11a): the rule table gives every weight the
    # reference's spec, stacked and listed layouts alike
    for scan in (True, False):
        jc, _, t = _ref(scan)
        want = jb.sharding_rules(jc)
        got = tb.sharding_rules(_port_cfg(jc))
        for path, _leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            assert tuple(got.spec(name)) == tuple(want.spec(name)), name


def _assert_grads_close(got, want, what=""):
    if isinstance(want, dict):
        for k in want:
            _assert_grads_close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            _assert_grads_close(g, w, f"{what}[{i}]")
    elif got is None:                # a leaf the loss does not reach
        assert not np.asarray(want).any(), what
    else:
        w = np.asarray(want)
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(got.detach().numpy() - w).max() / scale
        assert err <= GRAD_REL, (what, err)


@pytest.mark.parametrize("nsp,scan,remat", [
    (True, True, False), (False, True, True), (True, False, True)])
def test_loss_and_grads_match_mxtpu(nsp, scan, remat):
    jcfg, jparams, tree = _ref(scan)
    batch = _batch(1, nsp=nsp)
    want, wgrads = jax.jit(jax.value_and_grad(jb.loss_fn(jcfg)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = _live(tree)
    got = tb.loss_fn(_port_cfg(jcfg, remat=remat))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    _assert_grads_close(tree_map(lambda p: p.grad, params), wgrads)


def test_adamw_trajectory_matches_mxtpu():
    jcfg, jparams, tree = _ref()
    mesh = pmesh.create_mesh(devices=jax.devices()[:1])
    rules = ShardingRules([(r".*", P())])
    jtx, ttx = optax.adamw(1e-3), optim.adamw(1e-3)
    jstate = jstep.init_state(jparams, jtx, mesh, rules)
    jfn = jstep.make_train_step(jb.loss_fn(jcfg), jtx, mesh, rules)
    tstate = tstep.init_state(tb.params_from_numpy(tree, device="cpu"), ttx)
    tfn = tstep.make_train_step(tb.loss_fn(_port_cfg(jcfg)), ttx)
    batch = _batch(2)
    losses = []
    for _ in range(3):
        jstate, jloss = jfn(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        tstate, tloss = tfn(tstate, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
        losses.append(tloss.item())
    assert losses[-1] < losses[0]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, atol=1e-4, rtol=1e-4), tb.params_to_numpy(tstate.params),
        jax.tree.map(np.asarray, jstate.params))


def test_list_layout_round_trips_and_the_module_carries_it():
    """``scan_layers=False`` trees (a list of per-layer dicts) cross both
    ways bit for bit, and the module holds either layout."""
    jcfg, jparams, tree = _ref(scan=False)
    back = tb.params_to_numpy(tb.params_from_numpy(tree, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    batch = _batch(3)
    toks = torch.from_numpy(batch["tokens"])
    for scan in (True, False):
        jc, _, t = _ref(scan)
        mod = tb.Bert(_port_cfg(jc), device="cpu")
        mod.load_numpy_tree(t)
        want = tb.loss_fn(_port_cfg(jc))(
            tb.params_from_numpy(t, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_array_equal(
            mod.loss({k: torch.from_numpy(v) for k, v in batch.items()})
            .detach().numpy(), want.detach().numpy())
        with torch.no_grad():
            seq, _ = mod(toks)
        assert seq.shape == (B, S, 64)
    own = tb.init_params(_port_cfg(jcfg), device="cpu")
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        np.shape, tb.params_to_numpy(own))
    w = own["layers"][0]["qkv_w"]
    assert w.abs().max().item() <= 0.04 + 1e-7 and 0.015 < w.std() < 0.02


def test_bf16_compute_stays_near_f32():
    """The default config's bf16 activations against f32 compute on the
    same weights: the sequence output within 3e-2 relative (bf16 keeps
    8 bits; the LayerNorms renormalise every layer)."""
    jcfg, _, tree = _ref()
    tp = tb.params_from_numpy(tree, device="cpu")
    batch = _batch(4)
    args = [torch.from_numpy(batch[k]) for k in ("tokens", "token_types",
                                                  "mask")]
    f32, _ = tb.forward(_port_cfg(jcfg), tp, *args)
    bf16, _ = tb.forward(_port_cfg(jcfg, dtype=torch.bfloat16), tp, *args)
    rel = ((bf16 - f32).norm() / f32.norm()).item()
    assert bf16.dtype == torch.float32 and 0 < rel < 3e-2, rel
