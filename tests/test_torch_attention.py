"""Parity of mxtpu_torch.ops.attention with mxtpu.ops.attention on the CPU.

The same numpy inputs (from a seeded generator, float32) go through
both packages. On the CPU mxtpu's ``flash_attention`` reaches
``blockwise_attention`` and the port's reaches its own plain version,
so these tests hold the algorithm; the CUDA kernel is held against the
same plain version on the card by ``chip_smoke.py``.

Tolerance ``atol=rtol=1e-5``: both sides compute in f32 with the same
block order, and differ only in summation order inside the matmuls
(a max difference of about 7e-7 at these sizes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops import attention as jattn
from mxtpu_torch.ops import attention as tattn

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    return q, k, v


def _both(fn_j, fn_t, arrays, **kw):
    out_j = np.asarray(fn_j(*map(jnp.asarray, arrays), **kw))
    out_t = fn_t(*map(torch.from_numpy, arrays), **kw).numpy()
    return out_j, out_t


# (hq, hkv): MHA and GQA; (sq, skv): square and ragged; kv_block < s
SHAPES = [(4, 4, 24, 24), (4, 2, 24, 24), (4, 2, 20, 37), (4, 4, 33, 9)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,sq,skv", SHAPES)
def test_flash_attention_matches_mxtpu(hq, hkv, sq, skv, causal):
    arrays = _qkv(0, 2, hq, hkv, sq, skv, 16)
    out_j, out_t = _both(jattn.flash_attention, tattn.flash_attention,
                         arrays, causal=causal, kv_block=8)
    np.testing.assert_allclose(out_t, out_j, **TOL)
    # a CPU call runs the plain version, never the kernel
    assert tattn.flash_attention_fwd.launches == 0


# chip_smoke.py's edge shapes for the kernel's 128-row q and 128-key
# K/V tiles, at that key tile: (b, hq, hkv, sq, skv, d, causal, bshd).
# tile_edge puts one row and one key past a tile edge (causal, GQA);
# bshd_d64 reads (b, s, h, d) storage through a transpose, as the model
# does, with ragged edges on both sides.
KERNEL_TILE_SHAPES = {
    "tile_edge": (1, 4, 2, 129, 257, 128, True, False),
    "bshd_d64": (2, 8, 2, 200, 333, 64, False, True),
}


@pytest.mark.parametrize("shape", list(KERNEL_TILE_SHAPES))
def test_flash_attention_kernel_tile_shapes_match_mxtpu(shape):
    b, hq, hkv, sq, skv, d, causal, bshd = KERNEL_TILE_SHAPES[shape]
    q, k, v = _qkv(5, b, hq, hkv, sq, skv, d)
    if bshd:   # the same values, stored (b, s, h, d)
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                   for a in (q, k, v))
    out_j = np.asarray(jattn.flash_attention(
        *(jnp.swapaxes(jnp.asarray(a), 1, 2) if bshd else jnp.asarray(a)
          for a in (q, k, v)), causal=causal, kv_block=128))
    views = [torch.from_numpy(a) for a in (q, k, v)]
    if bshd:
        views = [t.transpose(1, 2) for t in views]
        assert not views[0].is_contiguous()
    out_t = tattn.flash_attention(*views, causal=causal, kv_block=128).numpy()
    assert out_t.shape == (b, hq, sq, d)
    np.testing.assert_allclose(out_t, out_j, **TOL)
    assert tattn.flash_attention_fwd.launches == 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,sq,skv", SHAPES)
def test_dense_attention_matches_mxtpu(hq, hkv, sq, skv, causal):
    arrays = _qkv(1, 2, hq, hkv, sq, skv, 16)
    out_j, out_t = _both(jattn.dense_attention, tattn.dense_attention,
                         arrays, causal=causal)
    np.testing.assert_allclose(out_t, out_j, **TOL)


def test_dense_attention_mask_and_offsets_match_mxtpu():
    """The padding mask (BERT's use) and the shard offsets (ring's use)
    combine with the causal mask as in mxtpu."""
    arrays = _qkv(4, 2, 4, 2, 12, 12, 16)
    keep = np.random.default_rng(4).random((2, 1, 1, 12)) > 0.3
    out_j = np.asarray(jattn.dense_attention(
        *map(jnp.asarray, arrays), causal=True, mask=jnp.asarray(keep),
        q_offset=12, kv_offset=6))
    out_t = tattn.dense_attention(
        *map(torch.from_numpy, arrays), causal=True,
        mask=torch.from_numpy(keep), q_offset=12, kv_offset=6).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)


def test_fully_masked_rows_are_zero():
    """Causal with skv < sq and a key offset: rows that see no key come
    out as zeros in both packages (_finalize), not NaN or uniform."""
    arrays = _qkv(2, 1, 2, 2, 6, 4, 16)
    out_j, out_t = _both(jattn.blockwise_attention,
                         tattn.blockwise_attention, arrays, causal=True,
                         kv_block=3, kv_offset=3)
    np.testing.assert_allclose(out_t, out_j, **TOL)
    assert np.all(out_t[:, :, :3] == 0.0) and np.all(np.isfinite(out_t))


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(3, 1, 4, 2, 8, 8, 64))
    odd = torch.zeros((1, 4, 8, 96), dtype=torch.bfloat16)
    before = tattn.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention_fwd(odd, odd[:, :2], odd[:, :2])
    with pytest.raises(TypeError, match="bfloat16"):
        tattn.flash_attention_fwd(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tattn.flash_attention_fwd(q[:, :3], k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_fwd(q, k, v)        # CPU tensors
    # an input that requires grad is refused like any CPU tensor: the
    # kernel has a backward now, but only for tensors on the card
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_fwd(q.requires_grad_(), k, v)
    assert tattn.flash_attention_fwd.launches == before
