"""Attention: dense, blockwise (flash-style online softmax), and the
hand-written Hopper flash kernels — the port of ``mxtpu/ops/attention.py``.

All functions take (batch, num_heads, seq, head_dim) tensors. GQA is
supported: k/v may have fewer heads (num_heads % kv_heads == 0).

:func:`flash_attention` dispatches on where its inputs lie: a CPU
tensor runs :func:`blockwise_attention`, the plain version, which
autograd differentiates; a CUDA tensor launches the CUDA C++ kernel of
``csrc/flash_attn_fwd.cu`` through :func:`flash_attention_fwd`, or
raises. Under grad it goes through :class:`_FlashAttention`, whose
backward launches the dQ kernel (which also writes D = rowsum(dO o))
and then the dK/dV kernel of ``csrc/flash_attn_bwd.cu`` through
:func:`flash_attention_bwd`; their plain version is
:func:`flash_attention_bwd_plain`. There is no fallback from a kernel to
a plain version, by shape or by exception.

Each kernel's work is counted here, beside it: :func:`attention_cost`
and :func:`bwd_cost` give the ``(flops, bytes)`` of a forward call and
of each backward kernel (:data:`BWD_WORK`), and the wrappers report
them to an active perfscope count (``telemetry.perfscope.reported``),
as the plain version does when it runs on a CPU tensor, so a program
counts the same whichever ran; :func:`attention_bound_ms` and
:func:`bwd_bound_ms` turn them into the least time on the card.
:func:`slot_decode_attention` and :func:`paged_decode_attention`, the
serving engine's length-masked attention over the slot bank and the
page pool, are plain PyTorch, as ``mxtpu``'s are plain ``jnp``; they
share one online-softmax body. :func:`ring_attention` and
:func:`ulysses_attention`, sequence parallelism over a mesh axis, are
plain PyTorch too, as the reference's are plain ``jnp``: they run on
each rank's sequence shard (inside ``parallel.collectives.shard_map``)
and move K/V or heads with the port's collectives.

The forward kernel's launch is the operator ``mxtpu_torch::flash_attn_fwd``
(``flash_attn_fwd_lse`` when the row logsumexp is asked for), defined
with ``torch.library`` for CUDA tensors, with a fake implementation
that gives its output shapes: so ``torch.export`` traces a call into
one node of the graph (``HybridBlock.export_stablehlo``), and an
exported program launches the kernel. The wrapper's checks run before
the operator; the base alignment, which only a real tensor has, is
checked inside it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..telemetry import perfscope
from . import _build

__all__ = ["dense_attention", "blockwise_attention", "flash_attention",
           "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_bwd_plain", "slot_decode_attention",
           "ring_attention", "ulysses_attention",
           "paged_decode_attention", "gather_pages", "visible_pairs",
           "attention_cost", "bwd_cost", "BWD_WORK", "attention_bound_ms",
           "bwd_bound_ms"]

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
                        q_offset: int = 0, kv_offset: int = 0,
                        return_lse: bool = False):
    """Flash-style attention as a loop over KV blocks: O(seq) memory, no
    materialized score matrix. The plain version of the flash forward
    kernel. With ``return_lse`` it also returns each row's logsumexp of
    the scaled, masked scores, f32 (b, h, sq), +inf for a row with no
    visible key: what the kernel writes for the backward."""
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
    out = _finalize(m, l, o, q.dtype)
    if not return_lse:
        return out
    return out, torch.where(l == 0.0, math.inf, m + torch.log(l))


def _slot_attention(q, lengths, n_keys, hkv, block, scale, kv_block):
    """The online-softmax body of :func:`slot_decode_attention` and
    :func:`paged_decode_attention`: ``block(lo, width)`` gives keys and
    values [lo, lo + width) of every slot, (slots, hkv, width, hd) in
    any float dtype, for ``kv_block``-wide blocks over ``n_keys`` keys.
    Each block is cast to f32, the tail block is padded and its padding
    masked by position, and running (max, denominator, numerator) carry
    in f32. Rows with no visible key (length 0) come out as zeros."""
    b, hq, sq, d = q.shape
    if hq % hkv:
        raise ValueError(f"{hq} q heads not divisible by {hkv} kv heads")
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_block = min(kv_block, n_keys)
    if lengths.ndim == 2:     # per query: (b, 1, 1, sq, 1) against kpos
        lim = lengths.reshape(b, 1, 1, sq, 1)
    else:
        lim = lengths.reshape(b, 1, 1, 1, 1)
    # the rep query heads of a kv head and their s queries share its keys:
    # rows of one (b, hkv) product, so no head is repeated
    qg = q.reshape(b, hkv, rep * sq, d).float()
    m = torch.full((b, hkv, rep, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, rep, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, hkv, rep, sq, d), dtype=torch.float32,
                    device=q.device)
    kpos0 = torch.arange(kv_block, device=q.device)
    for lo in range(0, n_keys, kv_block):
        kb, vb = block(lo, min(kv_block, n_keys - lo))
        kb, vb = kb.float(), vb.float()
        if kb.shape[2] < kv_block:          # the tail: pad, mask by position
            pad = kv_block - kb.shape[2]
            kb = F.pad(kb, (0, 0, 0, pad))
            vb = F.pad(vb, (0, 0, 0, pad))
        scores = torch.matmul(qg, kb.transpose(-1, -2)) * scale
        scores = scores.reshape(b, hkv, rep, sq, kv_block)
        allowed = (kpos0 + lo) < lim
        scores = torch.where(allowed, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(allowed, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.reshape(b, hkv, rep * sq, kv_block), vb)
        o = o * corr[..., None] + pv.reshape(b, hkv, rep, sq, d)
        m = m_new
    return _finalize(m, l, o, q.dtype).reshape(b, hq, sq, d)


def slot_decode_attention(q, k, v, lengths, *,
                          scale: Optional[float] = None, kv_block: int = 512):
    """Length-masked decode attention over a slot KV cache, the serving
    engine's attention (``mxtpu``'s ``slot_decode_attention``, plain
    ``jnp`` there, so plain PyTorch here): slot i holds its own request,
    whose cache row is valid only up to its own length.

    q: (slots, n_heads, s, hd), s = 1 in decode. k, v: (slots,
    n_kv_heads, max_len, hd), one layer of the slot bank; GQA groups the
    queries per kv head and never repeats the cache. lengths: (slots,)
    int, slot i attends keys [0, lengths[i]); or (slots, s), query j of
    slot i attends [0, lengths[i, j]) (the speculative verify step's
    causal mask).

    Blockwise online softmax over ``kv_block``-wide slices with running
    (max, denominator, numerator) in f32: one block of k and v is cast
    to f32 at a time, never the bank; the tail block is padded and its
    padding masked by position. Rows with no visible key (length 0)
    come out as zeros."""
    return _slot_attention(
        q, lengths, k.shape[2], k.shape[1],
        lambda lo, w: (k[:, :, lo:lo + w], v[:, :, lo:lo + w]),
        scale, kv_block)


def gather_pages(pool, page_table, lo, width, scales=None, dtype=None):
    """Keys [lo, lo + width) of every slot of a paged pool, contiguous:
    (..., slots, n_kv_heads, width, hd). pool: (..., n_pages, n_kv_heads,
    page_size, hd), any leading axes (a layer axis); page_table: (slots,
    pages_per_slot) int, slot i's logical page j at pool index
    ``page_table[i, j]``. Only the pages that cover the span are read.
    An int8 pool comes with its f32 per-token ``scales`` (..., n_pages,
    n_kv_heads, page_size) and is dequantised as ``mxtpu`` does it,
    ``f32(q) · s``, then cast to ``dtype``."""
    *lead, _, hkv, ps, d = pool.shape
    slots = page_table.shape[0]
    p0 = lo // ps
    p1 = -(-(lo + width) // ps)
    idx = page_table[:, p0:p1].reshape(-1).long()
    g = pool.index_select(-4, idx)
    if scales is not None:
        g = g.float() * scales.index_select(-3, idx)[..., None]
    g = g.view(*lead, slots, p1 - p0, hkv, ps, d).transpose(-4, -3).reshape(
        *lead, slots, hkv, (p1 - p0) * ps, d)
    g = g[..., lo - p0 * ps:lo - p0 * ps + width, :]
    return g if dtype is None else g.to(dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale: Optional[float] = None,
                           kv_block: int = 512, k_scales=None,
                           v_scales=None):
    """Decode attention over a paged KV pool (vLLM's PagedAttention, Kwon
    et al. SOSP '23; ``mxtpu``'s ``paged_decode_attention``): the cache
    is a flat pool of fixed-size pages and slot i's logical sequence is
    the concatenation of the pages its row of ``page_table`` names.

    q: (slots, n_heads, s, hd); k_pages, v_pages: (n_pages,
    n_kv_heads, page_size, hd); page_table: (slots, pages_per_slot)
    int; lengths: (slots,) or per query (slots, s), as for
    :func:`slot_decode_attention`. Page 0 is the engine's scratch page,
    which no attended position names. An int8 pool passes its f32
    ``k_scales``/``v_scales`` (n_pages, n_kv_heads, page_size); each
    block is dequantised to q's dtype (the reference dequantises the
    gathered row the same way before its slot attention).

    ``mxtpu`` gathers each slot's whole row and runs the slot attention
    on it. Here each ``kv_block``-wide block gathers only the pages that
    cover it (:func:`gather_pages`) and goes through the same online
    softmax body, so every product sees the operand the dense path
    would: paged attention equals :func:`slot_decode_attention` on the
    bank it was paged from, bit for bit, for any page size."""
    if q.shape[0] != page_table.shape[0]:
        raise ValueError(
            f"page_table rows {page_table.shape[0]} != slots {q.shape[0]}")
    cap = page_table.shape[1] * k_pages.shape[2]
    dt = None if k_scales is None else q.dtype
    return _slot_attention(
        q, lengths, cap, k_pages.shape[1],
        lambda lo, w: (gather_pages(k_pages, page_table, lo, w, k_scales, dt),
                       gather_pages(v_pages, page_table, lo, w, v_scales, dt)),
        scale, kv_block)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                              scale: Optional[float] = None,
                              kv_block: int = 512):
    """The plain version of the two backward kernels: (dq, dk, dv) of
    attention from q, k, v, its output ``o``, the row logsumexp ``lse``
    of :func:`blockwise_attention` and the output grad ``do``, computed
    blockwise over KV in f32 and returned in the inputs' dtypes. GQA's
    dk/dv are summed over each kv head's group of query heads. A row
    with ``lse`` = +inf (no visible key) gets zero grads."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, of, dof = q.float(), o.float(), do.float()
    kr, vr = _repeat_kv(qf, k.float(), v.float())
    delta = (dof * of).sum(dim=-1, keepdim=True)        # D = rowsum(dO o)
    lse = lse.float()[..., None]
    dq = torch.zeros_like(qf)
    dk = torch.empty((b, hq, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for lo in range(0, skv, kv_block):
        kb, vb = kr[:, :, lo:lo + kv_block], vr[:, :, lo:lo + kv_block]
        s = _scores(qf, kb, scale)
        if causal:
            s = torch.where(_causal_allowed(sq, kb.shape[2], 0, lo,
                                            q.device), s, _NEG_INF)
        p = torch.exp(s - lse)
        ds = p * (torch.matmul(dof, vb.transpose(-1, -2)) - delta)
        dv[:, :, lo:lo + kv_block] = torch.matmul(p.transpose(-1, -2), dof)
        dk[:, :, lo:lo + kv_block] = torch.matmul(
            ds.transpose(-1, -2), qf) * scale
        dq += torch.matmul(ds, kb) * scale
    dk = dk.view(b, hkv, hq // hkv, skv, d).sum(dim=2)
    dv = dv.view(b, hkv, hq // hkv, skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels' work: what they report to a perfscope count, and their bounds
# ---------------------------------------------------------------------------
def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(q, k) pairs the mask lets through: causal is qpos >= kpos, both
    counted from 0."""
    if not causal:
        return sq * skv
    m = min(sq, skv)
    return m * (m + 1) // 2 + max(sq - skv, 0) * skv


def attention_cost(b, hq, hkv, sq, skv, d, causal, lse: bool = False):
    """(flops, bytes) of one forward call: 2 products x 2 flops over
    every visible (q, k) pair and head; q, k, v read once and o written
    once in bf16, and with ``lse`` the f32 row logsumexp written too."""
    flops = 4 * d * hq * b * visible_pairs(sq, skv, causal)
    nbytes = 2 * d * b * (2 * hq * sq + 2 * hkv * skv)
    return flops, nbytes + (4 * b * hq * sq if lse else 0)


# The backward functions: (products, tensors read, tensors written). The
# dQ kernel recomputes S, then dP and dQ (and writes D = rowsum(dO o));
# the dK/dV kernel recomputes S and dP, then dV and dK; "pair" is the
# least work of the two together.
BWD_WORK = {
    "dkv": (4, ("q", "k", "v", "do", "lse", "delta"), ("dk", "dv")),
    "dq": (3, ("q", "k", "v", "do", "o", "lse"), ("dq", "delta")),
    "pair": (5, ("q", "k", "v", "do", "o", "lse"), ("dq", "dk", "dv")),
}


def bwd_cost(b, hq, hkv, sq, skv, d, causal, matmuls, reads, writes):
    """(flops, bytes) of a backward function doing ``matmuls`` products
    of 2*d flops over every visible (q, k) pair and head, reading each
    tensor named in ``reads`` once and writing each in ``writes`` once:
    q, o, do, dq (b, hq, sq, d) and k, v, dk, dv (b, hkv, skv, d) in
    bf16; lse and delta (b, hq, sq) in f32."""
    flops = 2 * matmuls * d * hq * b * visible_pairs(sq, skv, causal)
    size = dict.fromkeys(("q", "o", "do", "dq"), 2 * d * b * hq * sq)
    size.update(dict.fromkeys(("k", "v", "dk", "dv"), 2 * d * b * hkv * skv))
    size.update(dict.fromkeys(("lse", "delta"), 4 * b * hq * sq))
    return flops, sum(size[n] for n in reads + writes)


def attention_bound_ms(b, hq, hkv, sq, skv, d, causal, spec=None):
    """(ms, 'operations' | 'bytes'): the least time for one forward call
    (:func:`attention_cost` without the lse) on the H100, or on
    ``spec``'s device."""
    return perfscope.bound_ms(
        *attention_cost(b, hq, hkv, sq, skv, d, causal),
        spec or perfscope.spec_for("h100"))


def bwd_bound_ms(b, hq, hkv, sq, skv, d, causal, matmuls, reads, writes,
                 spec=None):
    """(ms, 'operations' | 'bytes'): the least time for a backward
    function (:func:`bwd_cost`) on the H100, or on ``spec``'s device."""
    return perfscope.bound_ms(
        *bwd_cost(b, hq, hkv, sq, skv, d, causal, matmuls, reads, writes),
        spec or perfscope.spec_for("h100"))


def _dims(q, k):
    """(b, hq, hkv, sq, skv, d) of a call."""
    b, hq, sq, d = q.shape
    return b, hq, k.shape[1], sq, k.shape[2], d


def _bwd_pair_cost(dims, causal):
    """What the dQ and dK/dV kernels report together."""
    dq = bwd_cost(*dims, causal, *BWD_WORK["dq"])
    dkv = bwd_cost(*dims, causal, *BWD_WORK["dkv"])
    return dq[0] + dkv[0], dq[1] + dkv[1]


def _strides_ok(t):
    """A unit last-dim stride and the other strides nonzero multiples of
    8 (a size-1 dim's stride is never stepped, so it may be anything):
    what a traced (fake) tensor can already show. ``t`` is 4-D; written
    out, as it runs three times in every kernel call."""
    s0, s1, s2, s3 = t.stride()
    n0, n1, n2, _ = t.shape
    return (s3 == 1 and (n0 < 2 or (s0 and not s0 % 8))
            and (n1 < 2 or (s1 and not s1 % 8))
            and (n2 < 2 or (s2 and not s2 % 8)))


def _readable(t):
    """Whether the kernels' tensor maps take ``t`` as it lies: the
    strides of :func:`_strides_ok` and a 16-byte aligned base."""
    return _strides_ok(t) and not t.data_ptr() % 16


def _misaligned(who, **ts):
    """The error for the first tensor whose base is not 16-byte aligned
    (checked where the tensors are real: inside the operator)."""
    name, t = next((n, t) for n, t in ts.items() if t.data_ptr() % 16)
    return ValueError(f"{name} needs a 16-byte aligned base for {who}; got "
                      f"data_ptr {t.data_ptr():#x}")


def _check_layout(who, name, t, device):
    """Raise unless ``t`` is bf16 on ``device`` (a CUDA device) with the
    strides and alignment the kernels read."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{who} takes bfloat16 ({name} is {t.dtype}); the "
                        "kernel has no other instantiation")
    if not _strides_ok(t):
        raise ValueError(
            f"{name} needs a unit last-dim stride, strides that are "
            f"nonzero multiples of 8 and a 16-byte aligned base; got strides "
            f"{t.stride()}")
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{who} needs its tensors on one CUDA device "
                         f"({name} is on {t.device}); CPU tensors take "
                         "flash_attention's plain path")


def _check_kernel_args(q, k, v, who="flash_attention_fwd"):
    """Raise on anything the CUDA kernels do not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{who} takes (b, heads, seq, d) "
                         f"tensors, got {q.shape}, {k.shape}, {v.shape}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match each other and q {tuple(q.shape)} in b, d")
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{who} takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError(f"{who} needs sq, skv >= 1")
    if hq > 65535 or b > 65535:
        raise ValueError(f"grid limit: heads {hq} and batch {b} must be "
                         "<= 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(who, name, t, q.device)


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """Launch the CUDA flash-attention forward kernel on the current
    stream. bf16 (b, hq, sq, d) q and (b, hkv, skv, d) k/v on one CUDA
    device, d in {64, 128}; returns a new contiguous (b, hq, sq, d)
    bf16 tensor, and with ``return_lse`` also the row logsumexp, f32
    (b, hq, sq), that the backward kernels read. Raises on anything
    else. Autograd does not see through this call: under grad,
    :func:`flash_attention` wraps it in :class:`_FlashAttention`."""
    _check_kernel_args(q, k, v)
    scale = float(scale if scale is not None
                  else 1.0 / math.sqrt(q.shape[3]))
    return perfscope.reported(
        lambda: attention_cost(*_dims(q, k), causal, lse=return_lse),
        _FWD_LSE_OP if return_lse else _FWD_OP, q, k, v, bool(causal),
        scale)


flash_attention_fwd.launches = 0


def _fwd_launch(q, k, v, causal, scale, return_lse):
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise _misaligned("flash_attention_fwd", q=q, k=k, v=v)
    lib = _build._lib or _build.load_kernels()
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    # the launch goes to q's card; entering a device context costs the
    # host more than the launch, so only when q is not on the current one
    with (contextlib.nullcontext() if q.device.index
          == torch.cuda.current_device() else torch.cuda.device(q.device)):
        err = lib.mxtpu_flash_attn_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            b, hq, hkv, sq, skv, d, float(scale), int(bool(causal)),
            torch._C._cuda_getCurrentRawStream(q.device.index))
    _build.check(err, "flash_attention_fwd launch")
    flash_attention_fwd.launches += 1
    return (o, lse) if return_lse else o


# the forward launch as an operator: a CUDA implementation (the launch)
# and a fake one (the output shapes), so torch.export keeps one node per
# call; defined on the dispatcher directly, whose call costs a few
# microseconds less than a torch.library.custom_op's
_LIB = torch.library.Library("mxtpu_torch", "FRAGMENT")
_LIB.define("flash_attn_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float scale) -> Tensor")
_LIB.define("flash_attn_fwd_lse(Tensor q, Tensor k, Tensor v, bool causal, "
            "float scale) -> (Tensor, Tensor)")
_LIB.impl("flash_attn_fwd",
          lambda q, k, v, causal, scale:
          _fwd_launch(q, k, v, causal, scale, False), "CUDA")
_LIB.impl("flash_attn_fwd_lse",
          lambda q, k, v, causal, scale:
          _fwd_launch(q, k, v, causal, scale, True), "CUDA")


@torch.library.register_fake("mxtpu_torch::flash_attn_fwd", lib=_LIB)
def _fwd_fake(q, k, v, causal, scale):
    return q.new_empty(q.shape)


@torch.library.register_fake("mxtpu_torch::flash_attn_fwd_lse", lib=_LIB)
def _fwd_lse_fake(q, k, v, causal, scale):
    return q.new_empty(q.shape), q.new_empty(q.shape[:3],
                                             dtype=torch.float32)


_FWD_OP = torch.ops.mxtpu_torch.flash_attn_fwd.default
_FWD_LSE_OP = torch.ops.mxtpu_torch.flash_attn_fwd_lse.default


def _check_bwd_args(who, q, k, v, do, lse):
    """Raise on anything the backward kernels do not take in q, k, v, do
    and lse."""
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    _check_kernel_args(q, k, v, who)
    _check_layout(who, "do", do, q.device)
    _check_rows(who, "lse", lse, q)


def _check_rows(who, name, t, q):
    """Raise unless ``t`` is contiguous f32 (b, hq, sq) on q's device."""
    if (t.shape != q.shape[:3] or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"{who}: {name} must be contiguous f32 "
                         f"{tuple(q.shape[:3])} on {q.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _strides(*ts):
    return tuple(s for t in ts for s in t.stride()[:3])


def _tail_args(q, k, causal, scale):
    b, hq, sq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return (b, hq, k.shape[1], sq, k.shape[2], d, float(scale),
            int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *,
                            causal: bool = False,
                            scale: Optional[float] = None):
    """Launch the dK/dV backward kernel on the current stream: returns
    new contiguous bf16 (dk, dv), (b, hkv, skv, d), summed over each kv
    head's group of query heads. q, k, v as for
    :func:`flash_attention_fwd`; ``do`` the grad of its output, laid
    out like q; ``lse`` its row logsumexp and ``delta`` = rowsum(dO o),
    both f32 (b, hq, sq) contiguous, ``delta`` as
    :func:`flash_attention_bwd_dq` returns it. ``.launches`` counts
    launches."""
    who = "flash_attention_bwd_dkv"
    _check_bwd_args(who, q, k, v, do, lse)
    _check_rows(who, "delta", delta, q)
    return perfscope.reported(
        lambda: bwd_cost(*_dims(q, k), causal, *BWD_WORK["dkv"]),
        _dkv_launch, q, k, v, do, lse, delta, causal, scale)


flash_attention_bwd_dkv.launches = 0


def _dkv_launch(q, k, v, do, lse, delta, causal, scale):
    from ._build import check, load_kernels
    lib = load_kernels()
    dk = torch.empty(tuple(k.shape), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        err = lib.mxtpu_flash_attn_bwd_dkv_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_strides(q, k, v, do), *_tail_args(q, k, causal, scale))
    check(err, "flash_attention_bwd_dkv launch")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, o, *,
                           causal: bool = False,
                           scale: Optional[float] = None):
    """Launch the dQ backward kernel on the current stream: returns a new
    contiguous bf16 dq, (b, hq, sq, d), and ``delta`` = rowsum(dO o),
    f32 (b, hq, sq), which the kernel computes on the way and
    :func:`flash_attention_bwd_dkv` reads. q, k, v, do and lse as for
    that function; ``o`` the forward's output, laid out like q.
    ``.launches`` counts launches."""
    who = "flash_attention_bwd_dq"
    _check_bwd_args(who, q, k, v, do, lse)
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} must match q "
                         f"{tuple(q.shape)}")
    _check_layout(who, "o", o, q.device)
    return perfscope.reported(
        lambda: bwd_cost(*_dims(q, k), causal, *BWD_WORK["dq"]),
        _dq_launch, q, k, v, do, lse, o, causal, scale)


flash_attention_bwd_dq.launches = 0


def _dq_launch(q, k, v, do, lse, o, causal, scale):
    from ._build import check, load_kernels
    lib = load_kernels()
    dq = torch.empty(tuple(q.shape), dtype=q.dtype, device=q.device)
    delta = torch.empty(tuple(q.shape[:3]), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mxtpu_flash_attn_bwd_dq_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            o.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_strides(q, k, v, do, o), *_tail_args(q, k, causal, scale))
    check(err, "flash_attention_bwd_dq launch")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        scale: Optional[float] = None):
    """The backward on the card: (dq, dk, dv) from q, k, v, the output
    ``o`` and row logsumexp ``lse`` of :func:`flash_attention_fwd`, and
    the output grad ``do``. The dQ kernel launches first and also writes
    D = rowsum(dO o), which the reference computes outside its kernels;
    the dK/dV kernel then reads it, on the same stream. Raises on what
    the kernels do not take."""
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} must match q "
                         f"{tuple(q.shape)}")
    dq, delta = flash_attention_bwd_dq(q, k, v, do, lse, o, causal=causal,
                                       scale=scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                     causal=causal, scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention on the card with the hand-written kernels both ways:
    the forward kernel also writes the row logsumexp, and the backward
    launches the dQ and dK/dV kernels. The counterpart of the custom VJP
    around the reference's Pallas flash attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        # the two kernels report their own work; the copy of a dO they
        # cannot read is part of it, as the plain version has none
        return perfscope.reported(lambda: (0, 0), _FlashAttention._grads,
                                  ctx, do)

    @staticmethod
    def _grads(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # The kernels read dO through its strides; autograd may hand over
        # a grad they cannot take (an expanded one has stride 0), which
        # alone is copied, into a fresh (aligned) buffer.
        if not _readable(do):
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


class _CountedPlainAttention(torch.autograd.Function):
    """The plain version on a CPU tensor under grad while a perfscope
    count is active: the forward is :func:`blockwise_attention`, counted
    as the forward kernel (which writes the lse for training), and the
    backward recomputes it on the saved q, k, v and differentiates it
    with autograd, counted as the dQ and dK/dV kernels. The same ops as
    autograd through :func:`blockwise_attention`, so the same grads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_block):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.kv_block = causal, scale, kv_block
        return perfscope.reported(
            lambda: attention_cost(*_dims(q, k), causal, lse=True),
            blockwise_attention, q, k, v, causal=causal, scale=scale,
            kv_block=kv_block)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors

        def grads():
            with torch.enable_grad():
                qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
                o = blockwise_attention(qd, kd, vd, causal=ctx.causal,
                                        scale=ctx.scale,
                                        kv_block=ctx.kv_block)
                return torch.autograd.grad(o, (qd, kd, vd), do)
        dq, dk, dv = perfscope.reported(
            lambda: _bwd_pair_cost(_dims(q, k), ctx.causal), grads)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_block: int = 512):
    """Fused attention: the hand-written CUDA kernels on a CUDA tensor
    (the forward, and under grad the backward too, through
    :class:`_FlashAttention`); :func:`blockwise_attention` on a CPU
    tensor, which autograd differentiates. ``kv_block`` sizes the plain
    version's blocks only. Under a perfscope count the plain version
    counts as the kernels do (:class:`_CountedPlainAttention` under
    grad)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if q.device.type == "cuda":
        if grad:
            return _FlashAttention.apply(q, k, v, causal, scale)
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if perfscope.active_count() is None:
        return blockwise_attention(q, k, v, causal=causal, scale=scale,
                                   kv_block=kv_block)
    if grad:
        return _CountedPlainAttention.apply(q, k, v, causal, scale, kv_block)
    return perfscope.reported(
        lambda: attention_cost(*_dims(q, k), causal), blockwise_attention,
        q, k, v, causal=causal, scale=scale, kv_block=kv_block)


def ring_attention(q, k, v, *, axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None, kv_block: int = 512,
                   mesh=None):
    """Ring attention over the ``axis_name`` mesh axis (of ``mesh`` or
    the ambient mesh), on this rank's sequence shard (b, h, s/n, d).
    Each of the n steps folds the K/V shard this rank holds into the
    online softmax (a shard that started on rank j holds positions
    from j·s/n), then hands it on round the ring; the backward rotates
    the cotangents the other way. ``kv_block`` is unused (each step
    takes its shard whole, as the reference's does)."""
    from ..parallel.collectives import _group, ppermute_ring
    k, v = _repeat_kv(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _, n, my = _group(axis_name, mesh)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for i in range(n):
        # after i rotations this rank holds the shard of rank (my - i)
        kv_off = ((my - i) % n) * skv
        m, l, o = _online_block(q, k, v, m, l, o, scale, causal, my * sq,
                                kv_off)
        if i < n - 1:
            k = ppermute_ring(k, axis_name, mesh=mesh)
            v = ppermute_ring(v, axis_name, mesh=mesh)
    return _finalize(m, l, o, q.dtype)


def ulysses_attention(q, k, v, *, axis_name: str = "sp",
                      causal: bool = False, scale: Optional[float] = None,
                      kv_block: int = 512, mesh=None):
    """Ulysses sequence parallelism (DeepSpeed-Ulysses) on this rank's
    sequence shard (b, h, s/n, d): two all-to-alls in (Q, then K and V)
    make each rank hold the full sequence of h/n heads,
    :func:`blockwise_attention` runs there, and one all-to-all out
    restores the sequence shard. K and V cross unrepeated (their GQA
    head count) when it divides by n."""
    from ..parallel.collectives import _group, alltoall
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _, n, _ = _group(axis_name, mesh)
    h, h_kv = q.shape[1], k.shape[1]
    if h % n:
        raise ValueError(f"{h} heads not divisible over {n} "
                         f"'{axis_name}' ranks (Ulysses reshard)")

    def seq_to_heads(x):            # (b, h, s/n, d) -> (b, h/n, s, d)
        return alltoall(x, axis_name, split_dim=1, concat_dim=2, mesh=mesh)

    if h_kv % n == 0:
        qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
        kh, vh = _repeat_kv(qh, kh, vh)
    else:
        k, v = _repeat_kv(q, k, v)
        qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    oh = blockwise_attention(qh, kh, vh, causal=causal, scale=scale,
                             kv_block=kv_block)
    return alltoall(oh, axis_name, split_dim=2, concat_dim=1, mesh=mesh)
