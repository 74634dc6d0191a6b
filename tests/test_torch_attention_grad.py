"""Grads of mxtpu_torch.ops.attention against mxtpu.ops.attention on the CPU.

The same numpy inputs and output grad (float32, from a seeded
generator) go through both packages: ``jax.vjp`` of mxtpu's
``flash_attention`` (which reaches ``blockwise_attention`` off the TPU)
and torch autograd through the port's (which reaches its own plain
``blockwise_attention``). The plain version of the CUDA backward
kernels, ``flash_attention_bwd_plain``, is held against torch autograd
through ``blockwise_attention``; ``chip_smoke.py`` holds the kernels
against it on the card.

Tolerance ``atol=rtol=1e-4`` on grads (both sides f32, differing in
summation order; the largest difference at these sizes is about 1e-6)
and ``1e-5`` on the row logsumexp.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops import attention as jattn
from mxtpu_torch.ops import attention as tattn

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-4, rtol=1e-4)
LSE_TOL = dict(atol=1e-5, rtol=1e-5)

# (hq, hkv, sq, skv): MHA and GQA, square and ragged, kv_block < s
SHAPES = [(4, 4, 24, 24), (4, 2, 24, 24), (4, 2, 20, 37), (4, 4, 33, 9)]


def _inputs(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    return q, k, v, do


def _port_grads(fn, q, k, v, do, **kw):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*leaves, **kw)
    return [g.numpy() for g in
            torch.autograd.grad(out, leaves, torch.from_numpy(do))]


def _ref_grads(fn, q, k, v, do, **kw):
    _, vjp = jax.vjp(lambda *a: fn(*a, **kw), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,sq,skv", SHAPES)
def test_flash_attention_grads_match_mxtpu(hq, hkv, sq, skv, causal):
    arrays = _inputs(0, 2, hq, hkv, sq, skv, 16)
    want = _ref_grads(jattn.flash_attention, *arrays, causal=causal,
                      kv_block=8)
    got = _port_grads(tattn.flash_attention, *arrays, causal=causal,
                      kv_block=8)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)
    # a CPU tensor never reaches a kernel, forward or backward
    assert tattn.flash_attention_fwd.launches == 0
    assert tattn.flash_attention_bwd_dkv.launches == 0
    assert tattn.flash_attention_bwd_dq.launches == 0


# (hq, hkv, sq, skv) at the edges of the backward kernels' tiles: a row
# and a key past a 64-row tile, and past 128 rows and 256 keys
KERNEL_TILE_SHAPES = [(4, 2, 65, 130), (4, 2, 129, 257)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,sq,skv", KERNEL_TILE_SHAPES)
def test_flash_attention_grads_at_the_kernel_tiles_match_mxtpu(
        hq, hkv, sq, skv, causal):
    arrays = _inputs(5, 1, hq, hkv, sq, skv, 64)
    want = _ref_grads(jattn.flash_attention, *arrays, causal=causal,
                      kv_block=64)
    got = _port_grads(tattn.flash_attention, *arrays, causal=causal,
                      kv_block=64)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_keys_that_no_query_sees_get_exactly_zero_grads():
    """Causal with sq < skv: the keys at or past sq see no query, so their
    dk and dv rows are exactly zero, in the plain version of the
    backward kernels and in mxtpu. The dK/dV kernel's CTAs of such keys
    have no work and must still write these zeros."""
    sq, skv = 65, 130
    q, k, v, do = _inputs(6, 1, 4, 2, sq, skv, 64)
    want = _ref_grads(jattn.flash_attention, q, k, v, do, causal=True,
                      kv_block=64)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = tattn.blockwise_attention(tq, tk, tv, causal=True,
                                         kv_block=64, return_lse=True)
    got = tattn.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                          causal=True, kv_block=64)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL)
    for name, g, w in zip("kv", got[1:], want[1:]):
        assert np.all(g.numpy()[:, :, sq:] == 0.0), f"plain d{name}"
        assert np.all(w[:, :, sq:] == 0.0), f"mxtpu d{name}"
        assert np.any(g.numpy()[:, :, :sq] != 0.0)


def test_fully_masked_rows_have_zero_grads():
    """Causal with a key offset: query rows that see no key have zero
    output and zero dq in both packages, and send nothing to dk, dv."""
    q, k, v, do = _inputs(2, 1, 2, 2, 6, 4, 16)
    kw = dict(causal=True, kv_block=3, kv_offset=3)
    want = _ref_grads(jattn.blockwise_attention, q, k, v, do, **kw)
    got = _port_grads(tattn.blockwise_attention, q, k, v, do, **kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)
    assert np.all(got[0][:, :, :3] == 0.0)
    assert all(np.all(np.isfinite(g)) for g in got)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,sq,skv", SHAPES)
def test_bwd_plain_matches_autograd_and_lse_matches_logsumexp(
        hq, hkv, sq, skv, causal):
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(1, 2, hq, hkv, sq, skv, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = tattn.blockwise_attention(*leaves, causal=causal,
                                         kv_block=8, return_lse=True)
    want = torch.autograd.grad(out, leaves, do)
    got = tattn.flash_attention_bwd_plain(q, k, v, out.detach(),
                                          lse.detach(), do, causal=causal,
                                          kv_block=8)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   err_msg=f"d{name}", **TOL)
    scores = torch.matmul(q, tattn._repeat_kv(q, k, v)[0]
                          .transpose(-1, -2)) / math.sqrt(16)
    if causal:
        scores = scores.masked_fill(
            ~tattn._causal_allowed(sq, skv, 0, 0, "cpu"), -math.inf)
    np.testing.assert_allclose(lse.detach().numpy(),
                               torch.logsumexp(scores, -1).numpy(),
                               **LSE_TOL)


def test_bwd_plain_gives_zero_grads_for_rows_with_no_key():
    """lse = +inf marks a row with no visible key: its P is exactly 0,
    so it gets a zero dq and adds nothing to dk and dv."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 1, 5, 7, 16))
    out, lse = tattn.blockwise_attention(q, k, v, causal=True,
                                         return_lse=True)
    lse_cut, do_cut = lse.clone(), do.clone()
    lse_cut[:, :, 2] = math.inf
    do_cut[:, :, 2] = 0.0        # what a dropped row's grad would be
    dq, dk, dv = tattn.flash_attention_bwd_plain(q, k, v, out, lse_cut, do,
                                                 causal=True)
    assert torch.all(dq[:, :, 2] == 0.0)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    _, dk_ref, dv_ref = tattn.flash_attention_bwd_plain(
        q, k, v, out, lse_cut, do_cut, causal=True)
    np.testing.assert_array_equal(dk.numpy(), dk_ref.numpy())
    np.testing.assert_array_equal(dv.numpy(), dv_ref.numpy())


def test_only_grads_the_kernels_cannot_read_are_copied():
    """The backward hands dO to the kernels through its strides; an
    expanded grad (stride 0) or one without a unit last-dim stride is
    what it copies first."""
    base = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    assert tattn._readable(base)
    assert tattn._readable(base.transpose(1, 2))      # (b, s, h, d) storage
    assert tattn._readable(base[:1].expand(3, -1, -1, -1)[:1])
    assert not tattn._readable(base[:1].expand(3, -1, -1, -1))
    assert not tattn._readable(torch.ones(()).expand(2, 4, 8, 64))
    assert not tattn._readable(base.transpose(2, 3))


def test_bwd_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(4, 1, 4, 2, 8, 8, 64))
    lse = torch.zeros((1, 4, 8))
    counters = (tattn.flash_attention_bwd_dkv.launches,
                tattn.flash_attention_bwd_dq.launches)
    for fn in (tattn.flash_attention_bwd_dkv, tattn.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, do, lse, lse)               # CPU tensors
        with pytest.raises(TypeError, match="bfloat16"):
            fn(q.float(), k.float(), v.float(), do, lse, lse)
        with pytest.raises(ValueError, match="must match q"):
            fn(q, k, v, do[:, :, :4], lse, lse)
        with pytest.raises(ValueError, match="multiple of kv heads"):
            fn(q[:, :3], k, v, do[:, :3], lse, lse)
    with pytest.raises(ValueError, match="must match q"):
        tattn.flash_attention_bwd(q, k, v, do[:, :2], lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_bwd(q, k, v, do, lse, do)
    assert (tattn.flash_attention_bwd_dkv.launches,
            tattn.flash_attention_bwd_dq.launches) == counters
