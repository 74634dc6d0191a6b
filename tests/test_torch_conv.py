"""Parity of mxtpu_torch.ops.conv with the ResNet shape experiment's
Pallas conv on the CPU.

The reference is ``pallas_conv3x3`` of
``benchmark/resnet_shape_experiment.py``, loaded unmodified by path and
run in Pallas' TPU interpret mode, which executes the kernel body on the
CPU. The port's ``conv3x3`` on CPU tensors runs its plain version (the
CUDA kernel is held against that plain version on the card by
``chip_smoke.py``). Inputs are bf16 values drawn from a seeded numpy
generator, the same for both.

Tolerance: one bf16 ulp of each output (2^-7 relative to the output's
magnitude): both sides accumulate in f32 and round once to bf16, and
differ only in summation order, which can move a value across a
rounding boundary (at the shapes here they agree exactly).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.experimental.pallas import tpu as pltpu

from mxtpu_torch.ops import conv

torch.set_num_threads(2)   # a CPU share for each xdist worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def experiment():
    path = os.path.join(REPO, "benchmark", "resnet_shape_experiment.py")
    spec = importlib.util.spec_from_file_location("resnet_shape_experiment",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, b, h, w, c, o):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, o)) * 0.05).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    kt = torch.from_numpy(k).to(torch.bfloat16)
    # the same bf16 values on both sides
    return xt, kt, jnp.asarray(xt.float().numpy(), jnp.bfloat16), \
        jnp.asarray(kt.float().numpy(), jnp.bfloat16)


def _assert_within_one_ulp(got, want):
    """|got - want| <= one bf16 ulp of the larger magnitude (2^-7 of its
    power-of-two floor), elementwise; exact zeros compare exactly."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 0.0)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (f"{bad.sum()} of {bad.size} outputs differ by "
                           f"more than one bf16 ulp; max "
                           f"{np.abs(got - want).max()}")


@pytest.mark.parametrize("shape,images_per_cell", [
    ((4, 6, 6, 16, 8), 1), ((4, 6, 6, 16, 8), 2), ((2, 7, 7, 32, 24), 1),
    ((3, 5, 9, 8, 16), 3)])
def test_conv3x3_matches_pallas_interpret(experiment, shape,
                                          images_per_cell):
    xt, kt, xj, kj = _inputs(sum(shape) + images_per_cell, *shape)
    with pltpu.force_tpu_interpret_mode():
        want = experiment.pallas_conv3x3(xj, kj,
                                         images_per_cell=images_per_cell)
    want = np.asarray(jax.device_get(want)).astype(np.float32)
    got = conv.conv3x3(xt, kt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _assert_within_one_ulp(got.float().numpy(), want)
    # the plain version is the conv XLA computes
    native = np.asarray(experiment.native_conv3x3(xj, kj)).astype(np.float32)
    _assert_within_one_ulp(got.float().numpy(), native)


def test_conv3x3_plain_is_f32_exact_conv():
    """In f32 the plain version is a SAME cross-correlation: against
    ``F.conv2d`` with padding 1 on the channels-last view."""
    xt, kt, _, _ = _inputs(5, 2, 5, 4, 8, 16)
    x, k = xt.float(), kt.float()
    got = conv.conv3x3_plain(x, k)
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_conv3x3_refuses_wrong_rank_dtype_and_device():
    xt, kt, _, _ = _inputs(6, 1, 4, 4, 8, 8)
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        conv.conv3x3(xt[0], kt)
    with pytest.raises(ValueError, match=r"\(3, 3, C, O\)"):
        conv.conv3x3(xt, kt[:2])
    with pytest.raises(ValueError, match=r"\(3, 3, C, O\)"):
        conv.conv3x3(xt, kt[:, :, :4])
    with pytest.raises(TypeError, match="bfloat16"):
        conv.conv3x3(xt.float(), kt)
    with pytest.raises(TypeError, match="bfloat16"):
        conv.conv3x3(xt, kt.half())
    # a CPU tensor never reaches the kernel: its wrapper refuses it
    before = conv.conv3x3_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_kernel(xt, kt)
    conv.conv3x3(xt, kt)
    assert conv.conv3x3_kernel.launches == before


@pytest.mark.parametrize("shape", [(1, 1, 1, 8, 8), (2, 5, 7, 8, 16),
                                   (3, 5, 9, 64, 72)])
def test_conv_flops_count_only_taps_inside_the_image(shape):
    """``conv_flops`` is 2·C·O for every (output, tap) pair whose input
    pixel lies inside the image: count those pairs with a conv of ones."""
    from mxtpu_torch.tools import resnet_shape_experiment as exp
    b, h, w, c, o = shape
    taps = conv.conv3x3_plain(torch.ones((b, h, w, 1)),
                              torch.ones((3, 3, 1, 1))).sum().item()
    assert exp.conv_flops(*shape) == 2 * c * o * int(taps)
    assert exp.conv_flops(*shape) <= 2 * b * h * w * 9 * c * o


def test_conv_bound_at_the_experiments_shape():
    """26.8 GFLOP (the halo's zero taps left out) and 26.9 MB: 0.0271 ms
    at 989 TFLOP/s against 0.008 ms at 3.35 TB/s, so bound by
    operations; a thin conv is bound by bytes."""
    from mxtpu_torch.tools import resnet_shape_experiment as exp
    ms, by = exp.conv_bound_ms(*exp.CONV_SHAPE)
    assert by == "operations"
    np.testing.assert_allclose(ms, 2 * 128 * 256 * 256 * 40 * 40 / 989e9,
                               rtol=1e-12)
    assert abs(ms - 0.0271) < 1e-4
    ms, by = exp.conv_bound_ms(1, 64, 64, 8, 8)
    assert by == "bytes"
    np.testing.assert_allclose(
        ms, 2 * (64 * 64 * 8 * 2 + 9 * 8 * 8) / 3.35e9, rtol=1e-12)


@pytest.mark.parametrize("shape, ms, by", [
    ((32, 56, 56, 64, 64), 0.00769, "bytes"),
    ((32, 28, 28, 128, 128), 0.00713, "operations"),
    ((32, 7, 7, 512, 512), 0.006124, "operations"),
])
def test_conv_bound_at_resnet50_shapes(shape, ms, by):
    """ResNet-50's other 3x3 convs at batch 32, as ``chip_smoke.py``
    checks them."""
    from mxtpu_torch.tools import resnet_shape_experiment as exp
    got, got_by = exp.conv_bound_ms(*shape)
    assert got_by == by
    np.testing.assert_allclose(got, ms, rtol=5e-4)


# chip_smoke.py's kernel_conv shapes, (B, H, W, C, O), and the plan the
# kernel takes at each: (BN, split)
CHIP_SHAPES = [
    ((128, 14, 14, 256, 256), (128, 1)),   # the experiment: 392 tiles
    ((32, 56, 56, 64, 64), (64, 1)),       # 784 tiles, no masked columns
    ((32, 28, 28, 128, 128), (128, 1)),    # 196 tiles
    ((32, 7, 7, 512, 512), (128, 2)),      # 13 x 4 = 52 tiles: K in halves
    ((3, 5, 9, 64, 72), (64, 1)),          # 2 x 2 CTAs of 9 stages
]


def _assert_plan_partitions(shape):
    """Every (output pixel, output channel, tap, input channel) is
    computed by exactly one CTA of the plan: the tiles cover M x O once
    in each part, and the parts' K stages partition the nine taps' 64-wide
    channel runs."""
    b, h, w, c, o = shape
    plan = conv._conv_plan(*shape)
    m, bm = b * h * w, 128
    assert (plan.m_tiles - 1) * bm < m <= plan.m_tiles * bm
    assert (plan.n_tiles - 1) * plan.bn < o <= plan.n_tiles * plan.bn
    stages_of = {}
    for m0, n0, stages in plan.ctas():
        assert m0 % bm == 0 and m0 < m and n0 % plan.bn == 0 and n0 < o
        assert stages, "a CTA with no K stage"
        stages_of.setdefault((m0, n0), []).extend(stages)
    assert len(stages_of) == plan.m_tiles * plan.n_tiles
    want = [(t, c0) for t in range(9) for c0 in range(0, c, 64)]
    for stages in stages_of.values():
        assert sorted(stages) == want
    sizes = {len(s) for _, _, s in plan.ctas()}
    assert max(sizes) - min(sizes) <= 1           # equal runs of K
    assert plan.split in (1, 2)                   # the kernel's clusters
    return plan


@pytest.mark.parametrize("shape,want", CHIP_SHAPES)
def test_conv_plan_covers_every_tile_once_at_the_chip_shapes(shape, want):
    plan = _assert_plan_partitions(shape)
    assert (plan.bn, plan.split) == want


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 64), h=st.integers(1, 60), w=st.integers(1, 60),
       c=st.integers(1, 64).map(lambda n: 8 * n),
       o=st.integers(1, 80).map(lambda n: 8 * n))
def test_conv_plan_covers_every_tile_once_at_drawn_shapes(b, h, w, c, o):
    plan = _assert_plan_partitions((b, h, w, c, o))
    ctas = plan.split * plan.m_tiles * plan.n_tiles
    long_k = 9 * plan.chunks >= 27

    def fits(split, bn):
        return split * plan.m_tiles * -(-o // bn) <= 132

    if fits(1, 128):
        # a thin grid: every CTA has an SM of its own, with the least
        # work a CTA: K in halves if K is long and they fit, then BN 64
        assert ctas <= 132
        assert plan.split == (2 if long_k and fits(2, 128) else 1)
        assert plan.bn == (64 if fits(plan.split, 64) else 128)
    else:
        # more than one round of SMs: no split, BN by O
        assert (plan.split, plan.bn) == (1, 64 if o <= 64 else 128)


@pytest.mark.parametrize("o", [8, 16, 56, 64, 72, 128, 136, 512])
def test_conv_plan_tile_width_follows_o(o):
    """BN is 64 when O <= 64 (no tile computes masked columns); above,
    128 on a grid that fills the card, and 64 on one that leaves SMs
    idle (twice the CTAs, each with half the work)."""
    for b, h, w, thin in ((1, 3, 3, True), (32, 56, 56, False)):
        plan = conv._conv_plan(b, h, w, 64, o)
        assert plan.bn == (64 if o <= 64 or thin else 128)
        assert plan.n_tiles * plan.bn - o < plan.bn


@pytest.mark.parametrize("shape", [(2, 7, 7, 32, 48), (3, 5, 9, 64, 72),
                                   (1, 1, 1, 8, 8), (4, 3, 6, 72, 136),
                                   (2, 60, 50, 8, 16)])
def test_split_k_matches_plain_within_one_ulp(shape):
    """An arithmetic argument for the split, not a test of the kernel
    (``chip_smoke.py`` holds the kernel's split plans against its
    unsplit ones on the card): each CTA of a cluster sums its half of
    the K stages in f32, the leader adds rank 1's partial tile to its own
    in f32 and rounds once to bf16. On the same bf16 inputs that is
    ``conv3x3_plain`` (one f32 product over all nine taps, rounded once)
    with the f32 terms summed in another order: the f32 sums lie within
    the worst-case reordering bound 9C·2^-24·Σ|terms|, and the bf16
    results within one bf16 ulp wherever that bound is under half an
    ulp (most outputs; not those that cancel to near zero). The plan
    splits only at 27 stages or more, where the worst-case bound is
    loose; the halves' arithmetic is the same at any C, so small shapes
    take the split plan here and keep the bound tight."""
    b, h, w, c, o = shape
    xt, kt, _, _ = _inputs(sum(shape), *shape)
    plan = conv._conv_plan(*shape)._replace(split=2)
    x, k = xt.float(), kt.float()
    runs = {}
    for _, _, stages in plan.ctas():
        runs.setdefault(stages, None)
    assert len(runs) == plan.split
    got = None
    for stages in runs:                      # rank order
        mask = torch.zeros(9, c)
        for t, c0 in stages:
            mask[t, c0:c0 + 64] = 1.0
        part = conv.conv3x3_plain(x, k * mask.view(3, 3, c, 1))
        got = part if got is None else got + part
    full = conv.conv3x3_plain(x, k)
    bound = 9 * c * 2.0 ** -24 * conv.conv3x3_plain(x.abs(), k.abs())
    assert ((got - full).abs() <= bound).all()
    got16 = got.to(torch.bfloat16).float().numpy()
    want16 = conv.conv3x3_plain(xt, kt).float().numpy()
    mag = np.abs(full.numpy())
    ulp = 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    sure = bound.numpy() < ulp / 2
    assert sure.mean() > 0.75
    _assert_within_one_ulp(got16[sure], want16[sure])
