"""Parity of mxtpu_torch.models.resnet with mxtpu.models.resnet on the CPU,
at ``tiny`` (depth 18, width 8): forward in eval and train mode, the
space-to-depth stem, the weight carry, the SAME padding rule and the
``ResNet`` module. The bottleneck configuration is in
``test_torch_resnet50.py``; weights, images and the memoized runs of
both packages in ``test_torch_resnet_refs.py``.

Tolerances:
- f32: logits and the new BN state within ``atol=rtol=2e-4`` (both
  sides compute in f32 and differ in summation order only; the largest
  relative difference seen here is 9e-6).
- bf16 (the packages' default compute dtype), against the reference
  compiled to round wherever it casts (``test_torch_resnet_refs``):
  eval and train logits and every new-state leaf within 1e-5 relative
  distance (1.2e-7 seen: both round at the same places).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_resnet_refs as refs
from mxtpu.models import resnet as jr
from mxtpu_torch.models import resnet as tr

torch.set_num_threads(2)   # a CPU share for each xdist worker

F32_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def weights():
    return {name: refs.weights(name) for name in ("tiny", "r50w8")}


@pytest.mark.parametrize("hw", [32, 36])
def test_forward_eval_and_train_match_mxtpu_f32(hw):
    refs.check_f32("tiny", hw, F32_TOL, F32_TOL)


def test_forward_eval_and_train_match_mxtpu_bf16():
    refs.check_bf16("tiny", 32, 1e-5, 1e-5, 1e-5)


def test_s2d_stem_matches_mxtpu_s2d(weights):
    """The port's s2d stem against the reference's s2d stem (f32), and
    against the port's own std stem, which it rewrites exactly."""
    ptree, _ = weights["tiny"]
    jcfg = replace(jr.CONFIGS["tiny"], dtype=jnp.float32, stem="s2d")
    x = refs.images(1, 32)
    want = np.asarray(jax.jit(jr.forward, static_argnums=0)(
        jcfg, jax.tree.map(jnp.asarray, ptree), jnp.asarray(x)))
    tp = tr.params_from_numpy(ptree, device="cpu")
    tcfg = refs.port_cfg(jcfg, torch.float32)
    got = tr.forward(tcfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    std = tr.forward(replace(tcfg, stem="std"), tp,
                     torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, std, rtol=2e-5, atol=2e-5)


def test_space_to_depth_and_s2d_kernel_are_exact():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 6, 3))
    k = rng.standard_normal((7, 7, 3, 5))
    np.testing.assert_array_equal(
        tr.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jr.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tr.space_to_depth(torch.from_numpy(x[:, :6]), block=3).numpy(),
        np.asarray(jr.space_to_depth(jnp.asarray(x[:, :6]), block=3)))
    np.testing.assert_array_equal(
        tr.s2d_stem_kernel(torch.from_numpy(k)).numpy(),
        np.asarray(jr.s2d_stem_kernel(jnp.asarray(k))))
    # the rewrite is exact in f64: s2d conv == 7x7/2 SAME conv
    cfg = tr.ResNetConfig(depth=18, width=5, dtype=torch.float64)
    xs = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)))
    kt = torch.from_numpy(k)
    std = tr._stem(cfg, xs, kt)
    s2d = tr._stem(replace(cfg, stem="s2d"), xs, kt)
    assert std.shape == s2d.shape == (2, 8, 8, 5)
    np.testing.assert_allclose(s2d.numpy(), std.numpy(), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="7x7"):
        tr.s2d_stem_kernel(torch.zeros(3, 3, 3, 4))


def test_s2d_stem_refuses_odd_inputs(weights):
    ptree, _ = weights["tiny"]
    cfg = replace(tr.CONFIGS["tiny"], stem="s2d", dtype=torch.float32)
    with pytest.raises(ValueError, match="even spatial dims"):
        tr.forward(cfg, tr.params_from_numpy(ptree, device="cpu"),
                   torch.zeros(1, 33, 32, 3))


def test_same_pad_is_xla_same():
    """Output sizes and the (lo, hi) split of XLA's SAME, including odd
    sizes, against jax's own padding rule."""
    from jax import lax
    for size in (7, 8, 9, 14, 16, 18, 36, 56, 112, 224):
        for k, s in ((1, 1), (1, 2), (3, 1), (3, 2), (7, 2)):
            want = lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
            assert tr._same_pad(size, k, s) == tuple(want), (size, k, s)


def test_params_round_trip_bit_for_bit(weights):
    ptree, stree = weights["r50w8"]
    for tree in (ptree, stree):
        back = tr.params_to_numpy(tr.params_from_numpy(tree, device="cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the port's own init has the reference's tree, shapes and dtypes
    cfg = refs.ref_cfg("r50w8")
    tcfg = refs.port_cfg(cfg, torch.bfloat16)
    for mine, ref in ((tr.init_params(tcfg, device="cpu"), ptree),
                      (tr.init_state(tcfg, device="cpu"), stree)):
        mine = tr.params_to_numpy(mine)
        assert jax.tree.structure(mine) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            assert a.shape == b.shape and a.dtype == b.dtype


def test_module_matches_functions(weights):
    """ResNet in eval mode is forward(); in train mode it returns the
    train logits and takes the new running statistics into its buffers."""
    ptree, stree = weights["tiny"]
    cfg = replace(tr.CONFIGS["tiny"], dtype=torch.float32)
    model = tr.ResNet(cfg, device="cpu")
    with torch.no_grad():
        for dst, src in ((model.params.tree(), ptree),
                         (model.bn_state.tree(), stree)):
            tr._copy_into(dst, tr.params_from_numpy(src, device="cpu"))
    tp = tr.params_from_numpy(ptree, device="cpu")
    ts = tr.params_from_numpy(stree, device="cpu")
    x = torch.from_numpy(refs.images(2, 32))
    model.eval()
    np.testing.assert_array_equal(model(x).detach().numpy(),
                                  tr.forward(cfg, tp, x, ts).numpy())
    model.train()
    logits = model(x)
    want, new = tr.forward(cfg, tp, x, ts, train=True)
    np.testing.assert_array_equal(logits.detach().numpy(),
                                  want.detach().numpy())
    for a, b in zip(refs.leaves(tr.params_to_numpy(model.bn_state.tree())),
                    refs.leaves(tr.params_to_numpy(new))):
        np.testing.assert_array_equal(a, b)
    loss = model.loss({"image": x, "label": torch.arange(2)})
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    assert len(list(model.buffers())) == len(jax.tree.leaves(stree))


def test_experiment_bn_shapes_are_the_models(monkeypatch):
    """The shape experiment times the BatchNorm passes at shapes it
    computes from the config: they are the shapes ``forward`` feeds its
    BNs, odd sizes included."""
    from mxtpu_torch.tools import resnet_shape_experiment as exp
    seen = []
    apply_bn = tr._apply_bn

    def record(cfg, x, *rest):
        seen.append(tuple(x.shape))
        return apply_bn(cfg, x, *rest)
    monkeypatch.setattr(tr, "_apply_bn", record)
    for name, hw in (("r50w8", 36), ("tiny", 32)):
        jcfg = refs.ref_cfg(name)
        cfg = refs.port_cfg(jcfg, torch.float32)
        seen.clear()
        tr.forward(cfg, tr.init_params(cfg, device="cpu"),
                   torch.zeros(2, hw, hw, 3), train=True)
        assert sorted(seen) == sorted(exp.bn_shapes(cfg, 2, hw))
        assert len(seen) == len(jax.tree.leaves(
            jax.eval_shape(lambda: jr.init_state(jcfg)))) // 2
