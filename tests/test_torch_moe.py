"""Parity of mxtpu_torch.parallel.moe with mxtpu.parallel.moe on the CPU.

Both packages run the same expert bank: ``init_moe_params`` draws it
with jax, it crosses as numpy, and the tokens come from a seeded numpy
generator. Held here: the routed ``moe_ffn`` through both dispatches
(gather, einsum) at top_k 1, 2 and 3, at a capacity that drops tokens,
one that does not and ``no_drop``; ``moe_ffn_dense``;
``load_balance_loss``; the routing (experts, slot positions, kept
choices) equal; every grad against ``jax.grad``; the lower-index choice
among exactly equal probabilities; and bf16 routing against the
reference compiled with ``xla_allow_excess_precision`` off.

Tolerances: f32 outputs and aux ``atol=rtol=1e-5`` (products of 16-wide
rows, summed in another order); grads ``1e-4`` relative to the largest
grad of each leaf (one more product in the chain).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.parallel import moe as jm
from mxtpu_torch.parallel import moe as tm

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL = 1e-4
T, D, H, E = 24, 16, 32, 4


@pytest.fixture(scope="module")
def bank():
    """(numpy params, numpy x) shared by every test of the file."""
    params = jm.init_moe_params(jax.random.PRNGKey(3), D, H, E)
    x = np.random.default_rng(0).standard_normal((T, D)).astype(np.float32)
    return jax.tree.map(np.asarray, params), x


def _pair(tree, x, dtype=None):
    jp = jax.tree.map(jnp.asarray, tree)
    tp = {k: torch.tensor(v) for k, v in tree.items()}
    xt = torch.tensor(x)
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
        xt = xt.to(torch.bfloat16)
    return jp, jnp.asarray(np.asarray(xt.float()), dtype=jp["gate"].dtype), \
        tp, xt


def _routes_equal(jr, tr):
    names = ("idx", "pos", "keep")
    for name, a, b in zip(names, jr[1:2] + jr[3:], tr[1:2] + tr[3:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    np.testing.assert_allclose(tr[2].numpy(), np.asarray(jr[2]), **TOL)


def _capacity(mode):
    """(capacity_factor, no_drop) of a mode."""
    return {"drops": (0.5, False), "fits": (float(E), False),
            "no_drop": (1.25, True)}[mode]


@pytest.mark.parametrize("mode", ["drops", "fits", "no_drop"])
@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_moe_ffn_matches_mxtpu(bank, dispatch, top_k, mode):
    tree, x = bank
    jp, xj, tp, xt = _pair(tree, x)
    cf, no_drop = _capacity(mode)
    kw = dict(top_k=top_k, capacity_factor=cf, no_drop=no_drop,
              dispatch=dispatch)
    want, waux = jm.moe_ffn(jp, xj, **kw)
    got, gaux = tm.moe_ffn(tp, xt, **kw)
    assert got.shape == (T, D) and got.dtype == torch.float32
    assert gaux.shape == () and gaux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gaux.item(), float(waux), **TOL)
    C = T if no_drop else int(np.ceil(T * top_k / E * cf))
    jr, tr = jm._route(jp, xj, top_k, C), tm._route(tp, xt, top_k, C)
    _routes_equal(jr, tr)
    dropped = int((~tr[4]).sum())
    assert (dropped > 0) == (mode == "drops"), dropped


def test_dispatches_agree_and_refuse_unknown(bank):
    tree, x = bank
    _, _, tp, xt = _pair(tree, x)
    a, _ = tm.moe_ffn(tp, xt, dispatch="gather", capacity_factor=0.5)
    b, _ = tm.moe_ffn(tp, xt, dispatch="einsum", capacity_factor=0.5)
    c, _ = tm.moe_ffn(tp, xt, capacity_factor=0.5)        # auto: gather
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    np.testing.assert_array_equal(a.numpy(), c.numpy())
    with pytest.raises(ValueError, match="dispatch"):
        tm.moe_ffn(tp, xt, dispatch="alltoall")
    # ported (item 11a): expert parallelism takes a parallel.mesh.Mesh
    with pytest.raises(TypeError, match="Mesh"):
        tm.moe_ffn(tp, xt, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        tm.moe_ffn_dense(tp, xt, mesh=object())


def test_moe_ffn_dense_matches_mxtpu(bank):
    tree, x = bank
    jp, xj, tp, xt = _pair(tree, x)
    for k in (1, 2, 3):
        want, waux = jm.moe_ffn_dense(jp, xj, top_k=k)
        got, gaux = tm.moe_ffn_dense(tp, xt, top_k=k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(gaux.item(), float(waux), **TOL)
    # dropless routing at C = T is the same mixture
    routed, _ = tm.moe_ffn(tp, xt, top_k=2, no_drop=True)
    dense, _ = tm.moe_ffn_dense(tp, xt, top_k=2)
    np.testing.assert_allclose(routed.numpy(), dense.numpy(), **TOL)


def test_load_balance_loss_matches_mxtpu():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    first = rng.integers(0, 8, size=40).astype(np.int32)
    want = jm.load_balance_loss(jnp.asarray(probs), jnp.asarray(first))
    got = tm.load_balance_loss(torch.tensor(probs), torch.tensor(first))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    uniform = torch.full((8, 4), 0.25)
    assert tm.load_balance_loss(uniform, torch.arange(8) % 4).item() == 1.0


def _assert_grads_close(got, want, what):
    for name, g, w in zip(sorted(want), (got[k] for k in sorted(want)),
                          (want[k] for k in sorted(want))):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g.numpy() - w).max() / scale
        assert err <= GRAD_REL, (what, name, err)


@pytest.mark.parametrize("fn,kw", [
    ("moe_ffn", dict(dispatch="gather", capacity_factor=0.5)),
    ("moe_ffn", dict(dispatch="einsum", capacity_factor=0.5)),
    ("moe_ffn", dict(dispatch="gather", top_k=3, no_drop=True)),
    ("moe_ffn_dense", dict(top_k=2)),
])
def test_grads_match_jax(bank, fn, kw):
    """Grads of every param and of x through a weighted output sum plus
    the aux, against ``jax.grad``."""
    tree, x = bank
    jp, xj, tp, xt = _pair(tree, x)
    head = np.random.default_rng(1).standard_normal((T, D)).astype(
        np.float32)

    def ref(params, x):
        out, aux = getattr(jm, fn)(params, x, **kw)
        return (out * head).sum() + 0.5 * aux
    want_p, want_x = jax.grad(ref, argnums=(0, 1))(jp, xj)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xg = xt.clone().requires_grad_()
    out, aux = getattr(tm, fn)(leaves, xg, **kw)
    ((out * torch.tensor(head)).sum() + 0.5 * aux).backward()
    _assert_grads_close({k: v.grad for k, v in leaves.items()}, want_p, fn)
    _assert_grads_close({"x": xg.grad}, {"x": want_x}, fn)
    assert float(np.abs(np.asarray(want_p["gate"])).max()) > 0


def test_tied_probabilities_take_the_lower_expert(bank):
    """Gate columns 1, 2 and 3 equal: their probs tie exactly, and both
    packages pick the lower indices (``torch.topk`` would not)."""
    tree, x = bank
    tree = dict(tree)
    gate = tree["gate"].copy()
    gate[:, 2] = gate[:, 1]
    gate[:, 3] = gate[:, 1]
    tree["gate"] = gate
    jp, xj, tp, xt = _pair(tree, x)
    for k in (1, 2, 3):
        jr, tr = jm._route(jp, xj, k, T), tm._route(tp, xt, k, T)
        _routes_equal(jr, tr)
        ties = (tr[0][:, 1] == tr[0][:, 2]).all()
        assert ties
    idx = tr[1]
    # rows whose best is the tied group take 1, 2 (then 3), never 2, 3
    tied_best = (tr[0][:, 1] > tr[0][:, 0])
    assert tied_best.any()
    assert (idx[tied_best, 0] == 1).all() and (idx[tied_best, 1] == 2).all()
    for fn in ("moe_ffn", "moe_ffn_dense"):
        want, waux = getattr(jm, fn)(jp, xj, top_k=2)
        got, gaux = getattr(tm, fn)(tp, xt, top_k=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(gaux.item(), float(waux), **TOL)


def test_bf16_routing_matches_strict_reference(bank):
    """bf16 router and experts against the reference compiled without
    excess precision: the experts chosen are equal except where the
    reference's margin at a choice (the log-probability gap between
    neighbours in its order, the first K + 1) is within one bf16 ulp of
    the row's largest logit: two logits, each rounded within half an
    ulp, may then swap."""
    tree, _ = bank
    x = np.random.default_rng(7).standard_normal((256, D)).astype(
        np.float32)
    jp, xj, tp, xt = _pair(tree, x, dtype="bf16")
    K = 2
    fn = jax.jit(lambda p, x: jm._route(p, x, K, 256)[:2])
    probs, jidx = fn.lower(jp, xj).compile(
        compiler_options={"xla_allow_excess_precision": False})(jp, xj)
    tprobs, tidx, _ = tm._gates(tp, xt, K)
    jidx, probs = np.asarray(jidx), np.asarray(probs)
    differ = (tidx.numpy() != jidx).any(axis=1)
    logp = np.log(-np.sort(-probs, axis=1))
    gap = (logp[:, :K] - logp[:, 1:K + 1]).min(axis=1)
    ulp = 2.0 ** -7 * np.abs(
        np.asarray(xj.astype(jnp.float32)) @ tree["gate"]).max(axis=1)
    near = gap <= ulp
    print(f"bf16 routes differing: {int(differ.sum())} of 256, at near "
          f"ties: {int((differ & near).sum())}, near ties: {int(near.sum())}")
    assert not (differ & ~near).any()
    np.testing.assert_allclose(tprobs.numpy(), probs, atol=2e-2, rtol=0)
    out, _ = tm.moe_ffn(tp, xt, top_k=2, capacity_factor=1.25)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
