"""Attention: dense, blockwise (flash-style online softmax), and the
hand-written Hopper flash kernel — the port of ``mxtpu/ops/attention.py``.

All functions take (batch, num_heads, seq, head_dim) tensors. GQA is
supported: k/v may have fewer heads (num_heads % kv_heads == 0).

:func:`flash_attention` dispatches on where its inputs lie: a CPU
tensor runs :func:`blockwise_attention`, the plain version; a CUDA
tensor launches the CUDA C++ kernel of ``csrc/flash_attn_fwd.cu``
through :func:`flash_attention_fwd`, or raises. There is no fallback
from the kernel to the plain version, by shape or by exception.
``slot_decode_attention``, ``paged_decode_attention``,
``ring_attention`` and ``ulysses_attention`` come with later slices.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["dense_attention", "blockwise_attention", "flash_attention",
           "flash_attention_fwd"]

_NEG_INF = -1e30  # finite "minus infinity": keeps fully-masked rows NaN-free
_KERNEL_HEAD_DIMS = (64, 128)


def _repeat_kv(q, k, v):
    """Broadcast grouped KV heads up to the query head count (GQA)."""
    hq, hk = q.shape[1], k.shape[1]
    if hq != hk:
        rep = hq // hk
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def _scores(q, k, scale):
    """q kᵀ·scale with f32 results (JAX's preferred_element_type=f32):
    the operands are upcast, which is exact for bf16."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def _causal_allowed(sq, skv, q_off, kv_off, device):
    qpos = torch.arange(sq, device=device) + q_off
    kpos = torch.arange(skv, device=device) + kv_off
    return (qpos[:, None] >= kpos[None, :])[None, None]


def dense_attention(q, k, v, *, causal: bool = False,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0, kv_offset: int = 0):
    """Reference-semantics attention, fully materialized scores.

    ``q_offset``/``kv_offset`` are the global positions of element 0 —
    used by the ring variant where each device holds a sequence shard.
    """
    k, v = _repeat_kv(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = _scores(q, k, scale)
    allowed = None
    if causal:
        allowed = _causal_allowed(q.shape[2], k.shape[2], q_offset,
                                  kv_offset, q.device)
    if mask is not None:
        allowed = mask if allowed is None else (allowed & mask)
    if allowed is None:
        probs = torch.softmax(scores, dim=-1)
    else:
        # masked softmax with fully-masked rows → zeros (matches the
        # blockwise _finalize semantics), not uniform attention
        scores = torch.where(allowed, scores, _NEG_INF)
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        e = torch.where(allowed, e, 0.0)
        denom = e.sum(dim=-1, keepdim=True)
        probs = e / torch.where(denom == 0.0, 1.0, denom)
    return torch.matmul(probs.to(v.dtype), v)


def _online_block(q, k, v, m, l, o, scale, causal, q_off, kv_off,
                  extra_mask=None):
    """One flash step: fold a KV block into running (m, l, o) stats.

    m: (b,h,q) running row max; l: (b,h,q) running denominator;
    o: (b,h,q,d) running unnormalized numerator. All float32.
    """
    scores = _scores(q, k, scale)
    allowed = None
    if causal:
        allowed = _causal_allowed(q.shape[2], k.shape[2], q_off, kv_off,
                                  q.device)
    if extra_mask is not None:
        allowed = extra_mask if allowed is None else (allowed & extra_mask)
    if allowed is not None:
        scores = torch.where(allowed, scores, _NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    if allowed is not None:
        # fully-masked rows keep m_new == _NEG_INF, where exp(score -
        # m_new) == 1 would attend uniformly — zero them so l stays 0
        # and _finalize emits zeros for such rows
        p = torch.where(allowed, p, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.matmul(p, v.float())
    return m_new, l_new, o_new


def _finalize(m, l, o, dtype):
    l = torch.where(l == 0.0, 1.0, l)  # fully-masked rows → zeros, not NaN
    return (o / l[..., None]).to(dtype)


def blockwise_attention(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        kv_block: int = 512,
                        q_offset: int = 0, kv_offset: int = 0):
    """Flash-style attention as a loop over KV blocks: O(seq) memory, no
    materialized score matrix. The plain version of the flash kernel."""
    k, v = _repeat_kv(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, d = q.shape
    skv = k.shape[2]
    kv_block = min(kv_block, skv)
    nblk, rem = divmod(skv, kv_block)
    if rem:  # pad KV to a block multiple; padded keys are masked by offset
        pad = kv_block - rem
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        nblk += 1

    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    kpos0 = torch.arange(kv_block, device=q.device)
    for i in range(nblk):
        lo = i * kv_block
        blk_off = kv_offset + lo
        # padded tail keys: positions >= kv_offset+skv are masked out
        valid = (kpos0 + blk_off) < kv_offset + skv
        m, l, o = _online_block(
            q, k[:, :, lo:lo + kv_block], v[:, :, lo:lo + kv_block],
            m, l, o, scale, causal, q_offset, blk_off,
            extra_mask=valid[None, None, None, :])
    return _finalize(m, l, o, q.dtype)


def _check_kernel_args(q, k, v):
    """Raise on anything the CUDA kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention_fwd takes (b, heads, seq, d) "
                         f"tensors, got {q.shape}, {k.shape}, {v.shape}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match each other and q {tuple(q.shape)} in b, d")
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("flash_attention_fwd needs sq, skv >= 1")
    if hq > 65535 or b > 65535:
        raise ValueError(f"grid limit: heads {hq} and batch {b} must be "
                         "<= 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_fwd takes bfloat16 ({name} is "
                            f"{t.dtype}); the kernel has no other "
                            "instantiation")
        # a size-1 dim's stride is never stepped, so it may be anything
        strided = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.stride(3) != 1 or any(s % 8 for s in strided) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a unit last-dim stride, strides that are "
                f"multiples of 8 and a 16-byte aligned base; got strides "
                f"{t.stride()}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_fwd needs q, k, v on one "
                             f"CUDA device ({name} is on {t.device}); "
                             "CPU tensors take flash_attention's plain path")


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None):
    """Launch the CUDA flash-attention forward kernel on the current
    stream. bf16 (b, hq, sq, d) q and (b, hkv, skv, d) k/v on one CUDA
    device, d in {64, 128}; returns a new contiguous (b, hq, sq, d)
    bf16 tensor. Raises on anything else. Inference only in this slice:
    with grad mode on and an input that requires grad it raises, since
    the backward kernels come with the training slice."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention_fwd has no backward yet: the dq/dk/dv "
            "kernels come with the training slice; run under "
            "torch.no_grad() or torch.inference_mode()")
    _check_kernel_args(q, k, v)
    from ._build import check, load_kernels
    lib = load_kernels()
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):    # the launch goes to q's card
        err = lib.mxtpu_flash_attn_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            b, hq, hkv, sq, skv, d, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention_fwd launch")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_block: int = 512):
    """Fused attention: the hand-written CUDA kernel on a CUDA tensor,
    :func:`blockwise_attention` on a CPU tensor. ``kv_block`` sizes the
    plain version's blocks only."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return blockwise_attention(q, k, v, causal=causal, scale=scale,
                               kv_block=kv_block)
