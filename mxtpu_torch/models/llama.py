"""Llama-family transformer — the port of ``mxtpu/models/llama.py``.

Plain functions over a parameter tree with ``mxtpu``'s keys and
layout (per-layer weights stacked on a leading layer dim), plus the
:class:`Llama` ``nn.Module`` façade. PyTorch runs eagerly, so the
layers are a Python loop over the stacked dim where ``mxtpu`` scans.
Attention in :func:`forward` goes through
:func:`mxtpu_torch.ops.attention.flash_attention`: the hand-written
CUDA kernel on the card, the blockwise plain version on the CPU.

What is ported: ``forward`` (the full-sequence scoring pass),
``generate`` (``prefill`` + ``decode_step`` over a KV cache), greedy
or sampled through :func:`sample_logits` on the Threefry chain of
:mod:`mxtpu_torch.prng`, ``chunked_prefill``, int8 weight-only serving
(``quantize_params_int8``: the cached path dequantises each weight as
it reads it), the serving engine's dense slot programs
(``init_slot_cache``, ``prefill_slot``, ``decode_slots``,
``prefill_detached``, ``prefill_detached_chunk``, ``inject_slot_kv``),
its paged pool (``init_paged_cache``, ``prefill_slot_paged``,
``decode_slots_paged``, ``inject_paged_kv``, ``copy_page``, with int8
pages) and speculative verify step (``decode_slots_spec``), which
:mod:`mxtpu_torch.serve` schedules, and the training loss
``loss_fn`` (``forward_hidden``
with per-layer recomputation, then the streamed
``chunked_softmax_xent``), which
``mxtpu_torch.parallel.step.make_train_step`` differentiates. Under
grad on the card, attention's backward runs the hand-written dK/dV and
dQ kernels. A config with ``moe_experts > 0`` (Mixtral) swaps each
layer's SwiGLU for the expert bank of :mod:`mxtpu_torch.parallel.moe`:
routed with a capacity in ``forward`` and the loss (whose load-balancing
aux ``loss_fn`` adds), the exact dropless mixture on every serving path.

Over a mesh of a process group (``forward``, ``forward_hidden`` and
``loss_fn`` take ``mesh=``), the params are DTensors laid out by
:func:`sharding_rules` (``parallel.shard_pytree`` or ``init_state``)
and the activations DTensors laid out as the reference constrains them
(``_ACT``: batch over dp/fsdp, sequence over sp). Each stage runs on
each rank's local shards (``parallel.collectives.shard_map``), Megatron
style: the embedding is a row-blocked lookup summed over ``tp``
(:mod:`mxtpu_torch.parallel.sparse_embed`); a layer takes its weights
with fsdp gathered (DTensor's all-gather; the gradients go back by
reduce-scatter), projects the rank's tokens onto its ``tp`` heads and
FFN columns, and sums the row-parallel products over ``tp``; attention
runs on the rank's heads (the flash kernels over the whole sequence,
gathered over ``sp`` when it is split, or ring/Ulysses attention over
``sp``); the MoE bank routes every token and runs the rank's ``ep``
experts; the final norm and the cross-entropy run on the rank's rows.
Serving over a mesh (the ``mesh=`` of the cached, slot
and paged paths) waits for ROADMAP Queue A item 11b and raises.

Numerics follow ``mxtpu``: ``rms_norm`` and RoPE compute in f32, and
the three einsums that ask for f32 results from ``cfg.dtype`` operands
(the logits heads and the cached attention scores) upcast their
operands, which is exact for bf16.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import prng
from ..context import DeviceLike, resolve_device
from ..ops.attention import (dense_attention, flash_attention, gather_pages,
                             paged_decode_attention, ring_attention,
                             slot_decode_attention, ulysses_attention)
from ..parallel.collectives import (PartialOver, allgather, allreduce,
                                    axis_index, pvary, shard_map)
from ..parallel.mesh import Mesh, axis_size
from ..parallel.moe import moe_ffn, moe_ffn_dense, routed_block
from ..parallel.sharding import (P, ShardingRules, constrain, is_dtensor,
                                 mcon, spmd)
from ..parallel.sparse_embed import sharded_embedding_lookup
from ._numpy_tree import params_from_numpy, params_to_numpy

__all__ = ["LlamaConfig", "CONFIGS", "init_params", "rms_norm",
           "rope_tables", "apply_rope", "forward_hidden", "forward",
           "init_cache", "prefill", "chunked_prefill", "decode_step",
           "sample_logits", "generate", "quantize_params_int8",
           "init_slot_cache", "slot_cache_specs", "decode_slots",
           "prefill_slot", "prefill_detached", "prefill_detached_chunk",
           "inject_slot_kv", "paged_cache_specs", "init_paged_cache",
           "decode_slots_paged", "prefill_slot_paged", "inject_paged_kv",
           "copy_page", "decode_slots_spec", "sharding_rules",
           "chunked_softmax_xent", "loss_fn", "train_step_flops",
           "params_from_numpy",
           "params_to_numpy", "Llama"]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336          # SwiGLU inner dim
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = torch.float32
    attn_impl: str = "flash"         # flash | dense | ring | ulysses
    remat: bool = True               # recompute each layer in the backward
    remat_policy: Optional[str] = None   # None | "dots_no_batch"
    scan_layers: bool = True         # picks the aux average; layers loop
    tie_embeddings: bool = False
    ce_chunk: Optional[int] = 0
    moe_experts: int = 0             # > 0: the MoE expert bank
    moe_top_k: int = 2
    moe_capacity: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                        remat=False),
    "llama3_8b": LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, hidden_dim=14336,
                             max_seq_len=8192),
    "llama2_7b": LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=32, hidden_dim=11008,
                             rope_theta=10000.0, max_seq_len=4096),
    "mixtral_8x7b": LlamaConfig(vocab_size=32000, dim=4096,
                                n_layers=32, n_heads=32, n_kv_heads=8,
                                hidden_dim=14336, rope_theta=1e6,
                                max_seq_len=4096, moe_experts=8,
                                moe_top_k=2),
}


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "serving over a mesh comes with ROADMAP Queue A item 11b; "
            "pass mesh=None")


def _check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` if it is one a process group spans (the DTensor path),
    None for no mesh or the one-device placement."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (create_mesh), "
                        f"not {type(mesh).__name__}")
    return mesh if mesh.distributed else None


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------
def sharding_rules(cfg: Optional[LlamaConfig] = None) -> ShardingRules:
    """``mxtpu``'s Megatron tp + fsdp placement: the stacked layer dim
    is never sharded; embedding rows over tp (the lookup sums over tp),
    lm_head columns over tp (vocab-parallel). A MoE config's expert
    banks gain a leading E dim over ep, with the same fsdp/tp layout per
    expert."""
    L = None
    moe = bool(cfg and cfg.moe_experts)
    ffn_up = P(L, "ep", "fsdp", "tp") if moe else P(L, "fsdp", "tp")
    ffn_dn = P(L, "ep", "tp", "fsdp") if moe else P(L, "tp", "fsdp")
    return ShardingRules([
        (r"tok_embed$", P("tp", "fsdp")),
        (r"layers/w[qkv]$", P(L, "fsdp", "tp")),       # column parallel
        (r"layers/wo$", P(L, "tp", "fsdp")),           # row parallel
        (r"layers/moe_gate$", P()),
        (r"layers/w_(gate|up)$", ffn_up),
        (r"layers/w_down$", ffn_dn),
        (r"norm", P()),
        (r"lm_head$", P("fsdp", "tp")),
        (r".*", P()),
    ])


# the reference's activation spec (sequence over sp); inside a layer
# q, k and v take its _QKV layout: batch over dp/fsdp, heads over tp,
# sequence over sp
_BATCH = ("dp", "fsdp")
_ACT = P(_BATCH, "sp", None)                  # (batch, seq, dim)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(cfg: LlamaConfig, n: int, gen: torch.Generator,
                device: torch.device):
    """Stacked params for n layers (leading dim = layer index), with
    ``mxtpu``'s shapes and fan-in scales, drawn from ``gen``."""
    hd = cfg.head_dim
    d = cfg.param_dtype

    def init(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=d)
        return w.div_(math.sqrt(fan_in))

    out = {
        "attn_norm": torch.ones((n, cfg.dim), dtype=d, device=device),
        "wq": init((n, cfg.dim, cfg.n_heads * hd), cfg.dim),
        "wk": init((n, cfg.dim, cfg.n_kv_heads * hd), cfg.dim),
        "wv": init((n, cfg.dim, cfg.n_kv_heads * hd), cfg.dim),
        "wo": init((n, cfg.n_heads * hd, cfg.dim),
                   cfg.n_heads * hd * 2 * cfg.n_layers),
        "ffn_norm": torch.ones((n, cfg.dim), dtype=d, device=device),
    }
    E = cfg.moe_experts
    bank = (n, E) if E else (n,)
    if E:
        out["moe_gate"] = init((n, cfg.dim, E), cfg.dim)
    out["w_gate"] = init(bank + (cfg.dim, cfg.hidden_dim), cfg.dim)
    out["w_up"] = init(bank + (cfg.dim, cfg.hidden_dim), cfg.dim)
    out["w_down"] = init(bank + (cfg.hidden_dim, cfg.dim),
                         cfg.hidden_dim * 2 * cfg.n_layers)
    return out


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    """Random parameters in ``mxtpu``'s tree layout. ``generator``
    must live on ``device``; by default a generator seeded with 0 is
    made there. The draws differ from ``jax.random``'s: to hold the
    two packages on the same weights, carry a tree with
    :func:`params_from_numpy`."""
    device = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)
    d = cfg.param_dtype
    params = {
        "tok_embed": torch.randn((cfg.vocab_size, cfg.dim), generator=gen,
                                 device=device, dtype=d).mul_(0.02),
        "layers": _init_layer(cfg, cfg.n_layers, gen, device),
        "final_norm": torch.ones((cfg.dim,), dtype=d, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(
            (cfg.dim, cfg.vocab_size), generator=gen, device=device,
            dtype=d).div_(math.sqrt(cfg.dim))
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def rms_norm(x, weight, eps):
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * weight.to(x.dtype)


def rope_tables(cfg: LlamaConfig, seq_len: int, offset: int = 0,
                device: DeviceLike = "cpu"):
    """(cos, sin), each (seq_len, hd/2) f32, for positions from offset."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    t = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                     device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


@functools.lru_cache(maxsize=16)
def _rope_cached(cfg: LlamaConfig, max_len: int, device: torch.device):
    """The (max_len, hd/2) RoPE tables of the cached and slot paths,
    built once per config, max_len and device for the eager steps,
    which only pick rows from them. The cache drops its least recent
    entry, so a captured step holds tables of its own
    (:func:`decode_slots`' ``rope``)."""
    return rope_tables(cfg, max_len, device=device)


def apply_rope(x, cos, sin):
    """x: (b, h, s, hd); rotate-half convention."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention(cfg: LlamaConfig, q, k, v, mesh: Optional[Mesh] = None):
    """Causal attention on local tensors. Ring and Ulysses attention
    need a mesh (its ``sp`` axis: of size 1 they are plain attention).
    Flash and dense attention on a rank's part of a sequence split over
    ``sp`` gather the whole sequence and keep this rank's part."""
    if cfg.attn_impl in ("ring", "ulysses"):
        if mesh is None:
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} needs a mesh with an 'sp' "
                "axis; pass mesh= to forward/loss_fn or use 'flash'")
        kernel = ring_attention if cfg.attn_impl == "ring" \
            else ulysses_attention
        return kernel(q, k, v, axis_name="sp", causal=True, mesh=mesh)
    if mesh is not None and axis_size("sp", mesh) > 1:
        i, s = axis_index("sp", mesh), q.shape[2]
        qf, kf, vf = (allgather(t, "sp", dim=2, mesh=mesh) for t in (q, k, v))
        return _attention(cfg, qf, kf, vf)[:, :, i * s:(i + 1) * s]
    if cfg.attn_impl == "dense":
        return dense_attention(q, k, v, causal=True)
    if cfg.attn_impl != "flash":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return flash_attention(q, k, v, causal=True)


def _wq8(w, dt):
    """Serving weight loader: a raw tensor, or a weight-only int8 dict
    ``{'q8': int8, 's8': f32 per-output-channel}`` (see
    :func:`quantize_params_int8`), dequantised as ``q8 · s8`` with both
    factors rounded to ``dt`` first, as ``mxtpu`` orders it. Where XLA
    fuses that product into the matmul's operand read, this makes a
    ``dt`` copy of the weight for each product."""
    if isinstance(w, dict):
        return w["q8"].to(dt) * w["s8"].to(dt)
    return w.to(dt)


def _head(cfg: LlamaConfig, params, dt):
    """The (dim, V) logits head in ``dt``: ``tok_embed``'s transpose when
    tied, dequantised before the transpose."""
    if cfg.tie_embeddings:
        return _wq8(params["tok_embed"], dt).T
    return _wq8(params["lm_head"], dt)


def _qkv(cfg: LlamaConfig, lp, h, cos, sin):
    """Projections + RoPE → q (b, h, s, hd), k and v (b, kvh, s, hd),
    the head counts the weights' (a rank's tp heads on a mesh)."""
    b, s, _ = h.shape
    hd, dt = cfg.head_dim, h.dtype
    wq, wk, wv = (_wq8(lp[n], dt) for n in ("wq", "wk", "wv"))
    q = (h @ wq).reshape(b, s, wq.shape[-1] // hd, hd)
    k = (h @ wk).reshape(b, s, wk.shape[-1] // hd, hd)
    v = (h @ wv).reshape(b, s, wv.shape[-1] // hd, hd)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def _tp(collective, t, mesh):
    """``collective`` (pvary or allreduce) over ``tp`` on ``mesh``; the
    identity with no mesh."""
    return t if mesh is None else collective(t, "tp", mesh)


def _ffn(cfg: LlamaConfig, lp, h, serving: bool = False, mesh=None):
    """FFN residual delta: dense SwiGLU, or the MoE expert bank when
    ``cfg.moe_experts`` is set. Returns (delta, aux), aux the MoE
    load-balancing term (a zero f32 scalar for dense configs).
    ``serving`` switches MoE to the exact dropless mixture
    (:func:`moe_ffn_dense`: routing is a pure per-token function), so
    generation never depends on batch composition. On a mesh of a
    process group ``h`` and the weights are a rank's shards (see
    :func:`_layer`)."""
    dt = h.dtype
    if cfg.moe_experts:
        b, s, d = h.shape
        mp = {"gate": lp["moe_gate"], "w_gate": lp["w_gate"],
              "w_up": lp["w_up"], "w_down": lp["w_down"]}
        if mesh is not None and mesh.distributed:
            # each ep rank backpropagates its experts' share
            return _local_moe(cfg, mesh, mp, pvary(h, "ep", mesh))
        if serving:
            out, aux = moe_ffn_dense(mp, h.reshape(b * s, d),
                                     top_k=cfg.moe_top_k)
        else:
            out, aux = moe_ffn(mp, h.reshape(b * s, d), top_k=cfg.moe_top_k,
                               capacity_factor=cfg.moe_capacity)
        return out.reshape(b, s, d), aux
    h = _tp(pvary, h, mesh)
    gate = torch.nn.functional.silu(h @ _wq8(lp["w_gate"], dt))
    up = h @ _wq8(lp["w_up"], dt)
    return _tp(allreduce, (gate * up) @ _wq8(lp["w_down"], dt), mesh), \
        torch.zeros((), dtype=torch.float32, device=h.device)


def _layer(cfg: LlamaConfig, cos, sin, x, lp, mesh=None):
    """One transformer block. x: (b, s, dim) in cfg.dtype. Returns (x,
    the FFN's aux). ``mesh`` is ring/Ulysses attention's ``sp`` axis.
    On a mesh of a process group (inside :func:`_mesh_hidden`'s
    ``shard_map``) the block runs on a rank's shards: x its rows and
    part of the sequence, cos and sin that part's, the weights laid out
    as :func:`_layer_specs` (the rank's tp heads and columns), and the
    row-parallel products summed over tp."""
    b, s, _ = x.shape
    # the tp ranks' heads and columns each read all of h: its cotangent
    # is the sum of theirs (Megatron's f, jax's pvary)
    h = _tp(pvary, rms_norm(x, lp["attn_norm"], cfg.norm_eps), mesh)
    q, k, v = _qkv(cfg, lp, h, cos, sin)
    o = _attention(cfg, q, k, v, mesh)
    o = o.transpose(1, 2).reshape(b, s, q.shape[1] * cfg.head_dim)
    x = x + _tp(allreduce, o @ _wq8(lp["wo"], x.dtype), mesh)
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    delta, aux = _ffn(cfg, lp, h, mesh=mesh)
    return x + delta, aux


# ---------------------------------------------------------------------------
# the mesh path: each stage on each rank's local shards
# ---------------------------------------------------------------------------
_TOKENS = ("dp", "fsdp", "sp")     # the axes a layer's tokens split over
_AUX = PartialOver(_TOKENS + ("ep",))


def _layer_specs(cfg: LlamaConfig):
    """The layout a layer's weights take in :func:`_layer` on a mesh: the
    rules' minus fsdp (gathered), with the layer dim gone."""
    specs = {"attn_norm": P(), "ffn_norm": P(), "wq": P(None, "tp"),
             "wk": P(None, "tp"), "wv": P(None, "tp"), "wo": P("tp", None)}
    if cfg.moe_experts:
        specs.update(moe_gate=P(), w_gate=P("ep"), w_up=P("ep"),
                     w_down=P("ep"))
    else:
        specs.update(w_gate=P(None, "tp"), w_up=P(None, "tp"),
                     w_down=P("tp", None))
    return specs


def _layer_grad_partial(cfg: LlamaConfig):
    """Per weight, the axes its local gradient is a part of: the token
    axes (each rank sees its tokens), and ``ep`` for the router (each
    rank backpropagates its experts' share)."""
    return {k: _TOKENS + (("ep",) if k == "moe_gate" else ())
            for k in _layer_specs(cfg)}


def _local_moe(cfg: LlamaConfig, mesh, mp, h):
    """The routed expert bank on one rank's tokens: every token is
    gathered and routed (the capacity is the global batch's), this
    rank's ``ep`` experts contribute, the contributions are summed over
    ``ep``, and the rank keeps its tokens' rows. The aux, the same on
    every rank, counts on the first rank of the token and ep axes."""
    b, s, d = h.shape
    hf = allgather(allgather(h, _BATCH, dim=0, mesh=mesh), "sp", dim=1,
                   mesh=mesh)
    B, S = hf.shape[:2]
    e0 = axis_index("ep", mesh) * mp["w_gate"].shape[0]
    out, aux = routed_block(mp, hf.reshape(B * S, d), e0, cfg.moe_top_k,
                            cfg.moe_capacity, "auto", axis_size("ep", mesh))
    out = allreduce(out, "ep", mesh).reshape(B, S, d)
    bi, si = axis_index(_BATCH, mesh), axis_index("sp", mesh)
    first = all(axis_index(a, mesh) == 0 for a in _TOKENS + ("ep",))
    return out[bi * b:(bi + 1) * b, si * s:(si + 1) * s], \
        aux * (1.0 if first else 0.0)


def _mesh_hidden(cfg: LlamaConfig, params, tokens, mesh, with_aux):
    """forward_hidden over a mesh of a process group (see the module
    doc); the layers are local regions, recomputed in the backward under
    ``cfg.remat``."""
    s = tokens.shape[1]
    x = constrain(_embed(cfg, params, tokens, mesh), *_ACT)
    # this rank's part of the sequence, and its positions
    n, j = axis_size("sp", mesh), axis_index("sp", mesh)
    cos, sin = (t[j * s // n:(j + 1) * s // n]
                for t in rope_tables(cfg, s, device=x.device))
    body = _remat(cfg, partial(_layer, cfg, cos, sin, mesh=mesh))
    layer = shard_map(body, mesh, (_ACT, _layer_specs(cfg)), (_ACT, _AUX),
                      grad_partial=((), _layer_grad_partial(cfg)))
    stacked = {k: _unstack(v) for k, v in params["layers"].items()}
    auxes = []
    for i in range(cfg.n_layers):
        x, a = layer(x, {k: v[i] for k, v in stacked.items()})
        auxes.append(a)
    norm = shard_map(partial(rms_norm, eps=cfg.norm_eps), mesh, (_ACT, P()),
                     _ACT, grad_partial=((), _TOKENS))
    x = norm(x, params["final_norm"])
    if not with_aux:
        return x
    # every aux has one layout: average the local parts
    from torch.distributed.tensor import DTensor
    loc = [a.to_local() for a in auxes]
    aux = torch.stack(loc).mean() if cfg.scan_layers else \
        sum(a / cfg.n_layers for a in loc)
    return x, DTensor.from_local(aux, auxes[0].device_mesh,
                                 auxes[0].placements, run_check=False)


def _unstack(t):
    """The layers of a stacked DTensor (its layer dim unsharded), each a
    DTensor of the same layout: split locally, so no op on the stack
    goes through DTensor's sharding search."""
    from torch.distributed.tensor import DTensor, Shard
    pl = []
    for p in t.placements:
        if p.is_shard():
            if p.dim == 0:
                raise ValueError("the stacked layer dim must not be sharded")
            p = Shard(p.dim - 1)
        pl.append(p)
    return [DTensor.from_local(x, t.device_mesh, pl, run_check=False,
                               shape=t.shape[1:], stride=x.new_empty(
                                   t.shape[1:], device="meta").stride())
            for x in t.to_local().unbind(0)]


def _layer_params(params, i: int):
    """Layer i's weights; an int8 weight's dict is indexed leaf by leaf."""
    def pick(v):
        return {k: t[i] for k, t in v.items()} if isinstance(v, dict) \
            else v[i]
    return {k: pick(v) for k, v in params["layers"].items()}


def _embed(cfg: LlamaConfig, params, tokens, mesh=None):
    """Gather the token rows, then cast them; an int8 table dequantises
    the gathered rows only (its scale is per dim channel). On a mesh of
    a process group the table's rows are blocked over ``tp`` and the
    lookup sums over it."""
    emb = params["tok_embed"]
    if mesh is not None:
        return sharded_embedding_lookup(emb, tokens, mesh, axis="tp",
                                        ids_spec=P(_BATCH, None)
                                        ).to(cfg.dtype)
    if isinstance(emb, dict):
        return emb["q8"][tokens.long()].to(cfg.dtype) * \
            emb["s8"][0].to(cfg.dtype)
    return emb[tokens.long()].to(cfg.dtype)


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots_no_batch"``
    (JAX's ``dots_with_no_batch_dims_saveable``): keep the outputs of
    the 2-D products — the weight matmuls and the MoE router — and
    recompute the rest, attention and the elementwise ops included. The
    MoE experts' products are batched (``bmm`` over the expert dim), so
    they are recomputed, as JAX's policy recomputes dots with batch
    dims."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: LlamaConfig, layer):
    """``layer`` wrapped for recomputation in the backward, as
    ``cfg.remat`` and ``cfg.remat_policy`` ask; ``layer`` itself when
    remat is off or grad mode is off (nothing would be recomputed)."""
    if not cfg.remat:
        return layer
    if cfg.remat_policy == "dots_no_batch":
        kw = {"context_fn": partial(create_selective_checkpoint_contexts,
                                    _save_weight_matmuls)}
    elif cfg.remat_policy is None:
        kw = {}
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "(use None or 'dots_no_batch')")
    if not torch.is_grad_enabled():
        return layer
    # a layer draws nothing from torch's generators (the port's random
    # draws take explicit keys), so there is no generator state to
    # carry into the recomputation; saving it would read the CUDA
    # generator, which a CUDA graph capture forbids
    return partial(checkpoint, layer, use_reentrant=False,
                   preserve_rng_state=False, **kw)


def forward_hidden(cfg: LlamaConfig, params, tokens, mesh=None,
                   with_aux: bool = False):
    """tokens: (batch, seq) int → final-norm hidden states
    (batch, seq, dim) in cfg.dtype; with ``with_aux`` also the MoE
    load-balancing aux, averaged over layers (0 for dense configs).
    Under grad with ``cfg.remat``, each layer is a
    ``torch.utils.checkpoint`` region: its activations are recomputed in
    the backward (``remat_policy=None``), or all but the weight matmuls'
    outputs are (``"dots_no_batch"``), as the reference's
    ``jax.checkpoint`` policies do. The layers are a Python loop;
    ``cfg.scan_layers`` only picks how the aux is averaged, as the
    reference rounds it (the mean of the stacked auxes, or Σ a/n).

    ``mesh``: a mesh over a process group runs the layers on DTensors
    (the params laid out by :func:`sharding_rules`; the tokens, the
    global batch on every rank or a DTensor, laid out on the batch axes);
    ring/Ulysses attention takes the mesh's ``sp`` axis. The one-device
    placement is the one-device path."""
    if isinstance(params["tok_embed"], dict):
        raise TypeError("an int8 tree serves (prefill, chunked_prefill, "
                        "decode_step, generate); forward and loss_fn take "
                        "float trees, as mxtpu's do")
    dmesh = _check_mesh(mesh)
    if dmesh is None:
        return _hidden(cfg, params, tokens, mesh, with_aux)
    if not is_dtensor(params["tok_embed"]):
        raise ValueError(
            "on a mesh the params must be laid out on it first: "
            "parallel.shard_pytree(params, mesh, llama.sharding_rules(cfg)) "
            "or parallel.init_state")
    with spmd(dmesh):
        tokens = mcon(dmesh, tokens, _BATCH, None)
        return _mesh_hidden(cfg, params, tokens, dmesh, with_aux)


def _hidden(cfg: LlamaConfig, params, tokens, mesh, with_aux):
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    cos, sin = rope_tables(cfg, s, device=x.device)
    layer = _remat(cfg, partial(_layer, cfg, cos, sin, mesh=mesh))
    # unbind once: its backward stacks the per-layer grads in one pass
    stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
    auxes = []
    for i in range(cfg.n_layers):
        x, a = layer(x, {k: v[i] for k, v in stacked.items()})
        auxes.append(a)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not with_aux:
        return x
    if cfg.scan_layers:
        aux = torch.stack(auxes).mean()
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in auxes:
            aux = aux + a / cfg.n_layers
    return x, aux


def _logits(cfg: LlamaConfig, params, x):
    """f32 logits from cfg.dtype hidden states and head (exact upcast)."""
    return torch.matmul(x.float(), _head(cfg, params, cfg.dtype).float())


def forward(cfg: LlamaConfig, params, tokens, mesh=None):
    """tokens: (batch, seq) int → logits (batch, seq, vocab) f32; on a
    mesh of a process group a DTensor laid out (batch over dp/fsdp, seq
    over sp)."""
    x = forward_hidden(cfg, params, tokens, mesh)
    dmesh = _check_mesh(mesh)
    if dmesh is None:
        return _logits(cfg, params, x)
    with spmd(dmesh):
        head = _head(cfg, params, cfg.dtype)
        return shard_map(lambda xl, hl: torch.matmul(xl.float(), hl.float()),
                         dmesh, (_ACT, P()), _ACT)(x, head)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
class _ChunkedXent(torch.autograd.Function):
    """Per-token NLL with a streamed logsumexp over vocab chunks; the
    backward recomputes each chunk's logits, so neither pass holds the
    (b, s, V) logits."""

    @staticmethod
    def forward(ctx, x, head, targets, chunk):
        b, s, _ = x.shape
        V = head.shape[1]
        xf = x.float()       # exact upcasts: f32 logits of bf16 operands
        m = torch.full((b, s), -math.inf, device=x.device)
        acc = torch.zeros((b, s), device=x.device)
        tl = torch.zeros((b, s), device=x.device)
        for c0 in range(0, V, chunk):
            logits = xf @ head[:, c0:c0 + chunk].float()
            nm = torch.maximum(m, logits.amax(dim=-1))
            acc = acc * torch.exp(m - nm) + \
                torch.exp(logits - nm[..., None]).sum(dim=-1)
            local = targets - c0
            hit = (local >= 0) & (local < logits.shape[-1])
            got = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)
                                [..., None])[..., 0]
            tl = tl + torch.where(hit, got, 0.0)
            m = nm
        lse = m + torch.log(acc)
        ctx.save_for_backward(x, head, targets, lse)
        ctx.chunk = chunk
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        x, head, targets, lse = ctx.saved_tensors
        b, s, d = x.shape
        xf = x.float().reshape(b * s, d)
        g, lse = g.float().reshape(b * s, 1), lse.reshape(b * s, 1)
        targets = targets.reshape(b * s, 1)
        dx = torch.zeros((b * s, d), device=x.device)
        dhead = torch.empty(head.shape, dtype=head.dtype, device=x.device) \
            if ctx.needs_input_grad[1] else None
        for c0 in range(0, head.shape[1], ctx.chunk):
            w = head[:, c0:c0 + ctx.chunk].float()
            # d nll / d logits = softmax - onehot(target), times g
            dl = torch.exp(xf @ w - lse)
            local = targets - c0
            hit = (local >= 0) & (local < w.shape[1])
            dl.scatter_add_(-1, local.clamp(0, w.shape[1] - 1),
                            -hit.float())
            dl.mul_(g)
            dx.addmm_(dl, w.T)
            if dhead is not None:
                dhead[:, c0:c0 + ctx.chunk] = xf.T @ dl
        return dx.reshape(b, s, d).to(x.dtype), dhead, None, None


def chunked_softmax_xent(x, head, targets, chunk: int):
    """Per-token causal-LM NLL via a streaming logsumexp over vocab
    chunks; the (b, s, V) logits are never materialized, forward or
    backward. x: (b, s, d) compute dtype; head: (d, V); targets:
    (b, s) int. Returns (b, s) f32. A chunk that does not divide V
    leaves a narrower last chunk, which is what the reference's zero
    padding masked to -inf amounts to."""
    return _ChunkedXent.apply(x, head, targets.long(), int(chunk))


def _resolve_ce_chunk(cfg: LlamaConfig) -> int:
    """0 = no chunking. Auto mode (``ce_chunk=0``) picks 8192-wide
    chunks once the vocab is big enough for logits to dominate memory;
    ``None`` or ``False`` opt out."""
    if cfg.ce_chunk is None or cfg.ce_chunk is False:
        return 0
    if cfg.ce_chunk == 0:
        return 8192 if cfg.vocab_size > 16384 else 0
    return int(cfg.ce_chunk)


def loss_fn(cfg: LlamaConfig, mesh=None):
    """Causal-LM loss for ``parallel.step.make_train_step``: batch is a
    dict with 'tokens' (b, s) and optional 'mask' (b, s); predicts token
    t+1 from the prefix up to t. Large vocabs take the chunked path
    (:func:`chunked_softmax_xent`). A MoE config adds
    ``cfg.moe_aux_weight`` times the load-balancing aux.

    On a mesh of a process group the loss takes DTensor params and a
    batch laid out on the batch axes (``make_train_step(...,
    mesh)`` does both); the cross-entropy runs on each rank's batch rows
    against the gathered head, and the loss is a replicated DTensor."""
    chunk = _resolve_ce_chunk(cfg)
    dmesh = _check_mesh(mesh)

    def sums(x, head, tokens, mask):
        """(Σ mask · nll, Σ mask) of next-token prediction."""
        x = x[:, :-1]
        targets = tokens[:, 1:].long()
        mask = (torch.ones(targets.shape, device=x.device) if mask is None
                else mask[:, 1:].float())
        if chunk:
            nll = chunked_softmax_xent(x, head, targets, chunk)
        else:
            logp = torch.log_softmax(x.float() @ head.float(), dim=-1)
            nll = -logp.gather(-1, targets[..., None])[..., 0]
        return (nll * mask).sum(), mask.sum()

    if dmesh is not None:
        # each rank its rows against the gathered head; the head's
        # cotangent is the sum of the rows' parts
        row = P(_BATCH, None)
        sums = shard_map(sums, dmesh, (P(_BATCH, None, None), P(), row, row),
                         (PartialOver(_BATCH),) * 2,
                         grad_partial=((), _BATCH, (), ()))

    def loss(params, batch):
        with spmd(dmesh):
            tokens = batch["tokens"]
            x, moe_aux = forward_hidden(cfg, params, tokens, mesh=mesh,
                                        with_aux=True)
            x = mcon(dmesh, x, _BATCH, None, None)      # the whole sequence
            num, den = sums(x, _head(cfg, params, cfg.dtype), tokens,
                            batch.get("mask"))
            ce = num / den.clamp_min(1.0)
            if cfg.moe_experts:
                ce = ce + cfg.moe_aux_weight * moe_aux
            return ce
    return loss


def train_step_flops(cfg: LlamaConfig, batch: int, seq: int) -> int:
    """The FLOPs one ``make_train_step(loss_fn(cfg), ...)`` step does on
    (batch, seq) tokens, counted as perfscope counts them: every weight
    product 2·m·k·n forward and twice that backward (dX and dW), once
    more forward in each layer's recomputation under ``remat`` but for
    the FFN's down projection (non-reentrant checkpointing stops
    recomputing once it holds every tensor the backward saved, and
    nothing saves that last product's output), none under
    ``remat_policy="dots_no_batch"`` (which saves the weight products'
    outputs); the attention kernels' own counts
    (:func:`~mxtpu_torch.ops.attention.attention_cost` for each forward,
    the recomputed one included, and the dQ and dK/dV kernels'
    :func:`~mxtpu_torch.ops.attention.bwd_cost` each backward); the
    logits head over the seq - 1 predicted positions, forward and
    backward, and with the chunked loss (:func:`chunked_softmax_xent`)
    the backward's recomputed logits too. Norms, RoPE, the loss's
    softmax and the optimizer are elementwise: 0 FLOPs. Dense configs
    with ``attn_impl="flash"``."""
    from ..ops.attention import BWD_WORK, attention_cost, bwd_cost
    if cfg.moe_experts or cfg.attn_impl != "flash":
        raise NotImplementedError("train_step_flops counts dense configs "
                                  "with flash attention")
    hd, L = cfg.head_dim, cfg.n_layers
    per_token = (2 * cfg.dim * cfg.n_heads * hd
                 + 2 * cfg.dim * cfg.n_kv_heads * hd
                 + 3 * cfg.dim * cfg.hidden_dim)
    products = 2 * batch * seq * per_token
    dims = (batch, cfg.n_heads, cfg.n_kv_heads, seq, seq, hd, True)
    attn_fwd = attention_cost(*dims)[0]
    attn_bwd = sum(bwd_cost(*dims, *BWD_WORK[k])[0] for k in ("dq", "dkv"))
    layers = L * (3 * products + attn_fwd + attn_bwd)
    if cfg.remat:
        layers += L * attn_fwd
        if cfg.remat_policy is None:
            layers += L * (products - 2 * batch * seq * cfg.hidden_dim
                           * cfg.dim)
    head = 2 * batch * (seq - 1) * cfg.dim * cfg.vocab_size
    return layers + head * (4 if _resolve_ce_chunk(cfg) else 3)


# ---------------------------------------------------------------------------
# KV-cache inference
# ---------------------------------------------------------------------------
def _quantize_int8(w):
    """``w ≈ q8 · s8``: symmetric per-output-channel scales over axis -2,
    ``s8 = max(max|w| / 127, 1e-12)`` in f32, ``q8 = clip(round(w / s8),
    -127, 127)`` in int8 (round half to even, as jax's). A stacked
    weight is quantised one layer at a time, which bounds the f32
    temporaries to one layer's."""
    if w.ndim > 2:
        parts = [_quantize_int8(wi) for wi in w.unbind(0)]
        return {k: torch.stack([p[k] for p in parts]) for k in ("q8", "s8")}
    w32 = w.float()
    # a divisor on w's device: a host scalar makes the card multiply by
    # its reciprocal, which rounds differently from jax's division
    s8 = (w32.abs().amax(dim=-2, keepdim=True)
          / torch.tensor(127.0, device=w.device)).clamp_min(1e-12)
    q8 = torch.round(w32 / s8).clamp_(-127, 127).to(torch.int8)
    return {"q8": q8, "s8": s8}


@torch.no_grad()
def quantize_params_int8(cfg: LlamaConfig, params):
    """Weight-only int8 quantization for serving (``prefill``,
    ``chunked_prefill``, ``decode_step``, ``generate``; ``forward`` and
    ``loss_fn`` take float trees): ``tok_embed``, the seven layer
    matrices and ``lm_head`` become ``{'q8', 's8'}`` dicts (see
    :func:`_quantize_int8`), the norms stay as they are. The same tree
    as ``mxtpu``'s ``quantize_params_int8``, bit for bit."""
    if cfg.moe_experts:
        raise NotImplementedError(
            "int8 serving quantization covers dense configs; the MoE "
            "expert banks serve via the dense-mixture path in bf16")
    out = {"tok_embed": _quantize_int8(params["tok_embed"]),
           "final_norm": params["final_norm"],
           "layers": dict(params["layers"])}
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        out["layers"][name] = _quantize_int8(params["layers"][name])
    if "lm_head" in params:
        out["lm_head"] = _quantize_int8(params["lm_head"])
    return out


def init_cache(cfg: LlamaConfig, batch_size: int, max_len: int, mesh=None,
               device: DeviceLike = None):
    """Preallocated GQA KV cache: k and v (L, b, n_kv_heads, max_len, hd)
    in the compute dtype, plus the write position ``pos`` (a host int).
    :func:`prefill` and :func:`decode_step` write into k and v IN PLACE
    and return the same tensors with ``pos`` advanced."""
    _no_mesh(mesh)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


def _layer_cached(cfg: LlamaConfig, cos, sin, pos, x, lp, ck, cv):
    """One block over the cache. x: (b, s, dim), s the prompt length or
    1; ck/cv: (b, kvh, max_len, hd), written in place at [pos, pos+s).
    ``pos`` is a host int, or a 0-d int64 tensor on x's device (a
    captured chunk): the rows are then written by an index op, and the
    same values reach the same ops."""
    b, s, _ = x.shape
    hd, dt = cfg.head_dim, cfg.dtype
    max_len = ck.shape[2]
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, cos, sin)
    rows = pos + torch.arange(s, device=x.device)
    if isinstance(pos, torch.Tensor):
        ck.index_copy_(2, rows, k)
        cv.index_copy_(2, rows, v)
    else:
        ck[:, :, pos:pos + s] = k
        cv[:, :, pos:pos + s] = v

    # attend q against the whole cache, masked to the causal prefix:
    # key j visible to query i iff j <= pos + i. GQA-native: group the
    # q heads per kv head instead of materializing repeated KV
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, rep, s, hd)
    logits = torch.einsum("bgrsd,bgkd->bgrsk", qg.float(), ck.float())
    logits = logits / math.sqrt(hd)
    kpos = torch.arange(max_len, device=x.device)[None, :]
    logits = torch.where(kpos <= rows[:, None], logits, -math.inf)
    p = torch.softmax(logits, dim=-1).to(dt)
    o = torch.einsum("bgrsk,bgkd->bgrsd", p, cv)
    o = o.reshape(b, cfg.n_heads, s, hd)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    x = x + o @ _wq8(lp["wo"], dt)
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    delta, _ = _ffn(cfg, lp, h, serving=True)
    return x + delta


def _forward_cached(cfg: LlamaConfig, params, tokens, cache,
                    last_only: bool = False, last_index=None, rope=None):
    """Shared prefill/decode body: runs the stack over the cache and
    returns (logits (b, s, V) f32, cache). ``last_only`` applies the
    lm_head to the final position only; ``last_index`` (a 0-d int
    tensor on the tokens' device) to that one position instead, picked
    by an index op: a bucketed serving prefill pads its prompt, so the
    last real position is not the last row. ``cache["pos"]`` is a host
    int, or a 0-d int64 tensor on the tokens' device, which is never
    read back (a captured chunk: its RoPE rows are picked by an index
    op from ``rope``, tables the caller holds, and the bound is the
    caller's). ``rope`` None takes the shared cached tables."""
    s = tokens.shape[1]
    max_len = cache["k"].shape[3]
    pos = cache["pos"]
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
        if pos + s > max_len:
            # mxtpu's dynamic_update_slice would clamp the write silently
            raise ValueError(f"cache overflow: pos {pos} + {s} new tokens "
                             f"> max_len {max_len}")
    x = _embed(cfg, params, tokens)
    cos_t, sin_t = rope or _rope_cached(cfg, max_len, x.device)
    if isinstance(pos, torch.Tensor):
        rows = pos + torch.arange(s, device=x.device)
        cos, sin = cos_t.index_select(0, rows), sin_t.index_select(0, rows)
    else:
        cos, sin = cos_t[pos:pos + s], sin_t[pos:pos + s]
    for i in range(cfg.n_layers):
        x = _layer_cached(cfg, cos, sin, pos, x, _layer_params(params, i),
                          cache["k"][i], cache["v"][i])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_index is not None:
        x = x.index_select(1, last_index.reshape(1).long())
    elif last_only:
        x = x[:, -1:]
    logits = _logits(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + s}


def prefill(cfg: LlamaConfig, params, tokens, cache, mesh=None,
            last_only: bool = False):
    """Run the prompt through the stack, filling the cache in place.
    Returns (logits (b, s, V) f32, or (b, 1, V) with ``last_only``,
    cache)."""
    _no_mesh(mesh)
    return _forward_cached(cfg, params, tokens, cache, last_only=last_only)


def chunked_prefill(cfg: LlamaConfig, params, tokens, cache,
                    chunk_size: int, mesh=None):
    """Streaming prefill: the prompt goes through the cached stack in
    ``chunk_size`` slices, then a remainder pass, so the inline
    attention's (b, h, chunk, max_len) logits, not the whole prompt's,
    set the peak. The prompt is never padded: pad tokens would take real
    cache slots and shift every RoPE position. Returns (logits (b, 1, V)
    f32 for the last prompt position, cache), which is
    ``prefill(..., last_only=True)``."""
    _no_mesh(mesh)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    n, rem = divmod(tokens.shape[1], chunk_size)
    logits = None
    for i in range(n + (rem > 0)):
        logits, cache = _forward_cached(
            cfg, params, tokens[:, i * chunk_size:(i + 1) * chunk_size],
            cache, last_only=True)
    return logits, cache


def decode_step(cfg: LlamaConfig, params, token, cache, mesh=None):
    """One autoregressive step. token: (b, 1) int. Returns
    (logits (b, V) f32 for the next position, cache)."""
    _no_mesh(mesh)
    logits, cache = _forward_cached(cfg, params, token, cache)
    return logits[:, 0], cache


def _is_static(temperature, top_k, top_p) -> bool:
    return (isinstance(temperature, (int, float))
            and (top_k is None or isinstance(top_k, int))
            and (top_p is None or isinstance(top_p, (int, float))))


def sample_logits(rng, lg, temperature=0.0, top_k=None, top_p=None):
    """The sampler of :func:`generate` and of the serving engine: lg
    (b, V) f32 logits → (b,) int32 tokens, drawn with
    ``prng.categorical`` on the key ``rng``, as ``mxtpu``'s. ``rng`` may
    also be (b, 2) keys, row i drawn from key i over its own (1, V) row:
    ``jax.vmap`` of ``mxtpu``'s sampler over per-row keys, which is how
    :func:`decode_slots` advances each slot's own chain.

    Two modes that give the same tokens on the same logits:

    - static (temperature, top_k and top_p Python numbers or None):
      temperature 0 is a bare argmax; otherwise lg / temperature, top-k
      masks values under the k-th largest, then the nucleus mask;
    - traced (any of them a (b,) tensor): one computation serves every
      per-row mix. ``top_k`` is clipped to [1, V] and applied as the
      k-th value of the sorted row, ``top_p`` 1.0 keeps the whole row,
      and rows with temperature 0 take the greedy token.
    """
    V = lg.shape[-1]
    if _is_static(temperature, top_k, top_p):
        if temperature == 0.0:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        lg = lg / _col(temperature, lg)
        if top_k is not None and top_k < V:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = torch.where(lg < kth, -math.inf, lg)
        if top_p is not None and top_p < 1.0:
            lg = _nucleus_mask(lg, _col(top_p, lg))
        return prng.categorical(rng, lg).to(torch.int32)

    t_col = _col(temperature, lg)
    k_col = _col(V if top_k is None else top_k, lg, torch.int64).clamp(1, V)
    p_col = _col(1.0 if top_p is None else top_p, lg)
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    slg = lg / torch.where(t_col == 0.0, 1.0, t_col)
    srt = torch.sort(slg, dim=-1, descending=True).values
    kth = srt.gather(-1, (k_col - 1).expand(*slg.shape[:-1], 1))
    slg = torch.where(slg < kth, -math.inf, slg)
    slg = _nucleus_mask(slg, p_col)
    sampled = prng.categorical(rng, slg).to(torch.int32)
    return torch.where(t_col[..., 0] == 0.0, greedy, sampled)


def _col(x, lg, dtype=torch.float32):
    """A scalar or a (b,) sampling knob as a column on lg's device. A
    divisor that is a host scalar would make the card multiply by its
    reciprocal, which rounds differently from a division."""
    x = torch.as_tensor(x, dtype=dtype, device=lg.device)
    return x.reshape(x.shape + (1,) * (lg.ndim - x.ndim))


def _nucleus_mask(lg, top_p):
    """Mask lg to the top-p nucleus: softmax once over the sorted row
    (``exp(x - max) / sum``, as jax's), keep the smallest prefix whose
    mass reaches p (the top token always survives), and apply the
    survivors as a ``>=`` threshold on the kept minimum."""
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    e = torch.exp(sorted_lg - sorted_lg[..., :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < top_p
    cutoff = torch.where(keep, sorted_lg, math.inf).amin(dim=-1,
                                                         keepdim=True)
    return torch.where(lg >= cutoff, lg, -math.inf)


def generate(cfg: LlamaConfig, params, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, rng=None, mesh=None):
    """Autoregressive generation: prefill, then one :func:`decode_step`
    per new token over a cache sized ``prompt_len + max_new_tokens``.
    Temperature 0 is greedy; otherwise each token is drawn by
    :func:`sample_logits` with a subkey split off ``rng`` (default
    ``prng.PRNGKey(0)`` on the prompt's device): every emission takes
    ``rng, sub = split(rng)``, as ``mxtpu``'s scan does, so the tokens
    equal the reference's on the same key. Returns (b, prompt_len +
    max_new_tokens) tokens in the prompt's dtype, on its device."""
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    # per-row (b,) tensors are not checked: sample_logits clips them
    if isinstance(top_k, int) and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if isinstance(top_p, (int, float)) and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    _no_mesh(mesh)
    b, s0 = prompt.shape
    # greedy draws nothing: its key chain is skipped, which no output
    # can tell
    greedy = _is_static(temperature, top_k, top_p) and temperature == 0.0
    if rng is None and not greedy:
        rng = prng.PRNGKey(0, device=prompt.device)

    def sample(lg):
        nonlocal rng
        if greedy:
            return sample_logits(None, lg)
        rng, sub = prng.split(rng)
        return sample_logits(sub, lg, temperature, top_k, top_p)

    cache = init_cache(cfg, b, s0 + max_new_tokens, device=prompt.device)
    logits, cache = _forward_cached(cfg, params, prompt, cache,
                                    last_only=True)
    tok = sample(logits[:, -1])
    out = [prompt, tok[:, None].to(prompt.dtype)]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(cfg, params, tok[:, None], cache)
        tok = sample(logits)
        out.append(tok[:, None].to(prompt.dtype))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# continuous-batching serving: the dense slot bank (the model half of
# mxtpu_torch.serve; the scheduler lives there)
# ---------------------------------------------------------------------------
# ``generate`` serves a whole batch that starts together. The slot
# programs serve a fixed bank of ``max_slots`` independent rows instead:
# admission overwrites a finished row in place, and per-slot length,
# token and key vectors drive one decode step for the whole bank, so
# requests entering and leaving never change its shapes (the engine
# captures it once as a CUDA graph). Where ``mxtpu`` donates the bank to
# each program, these write it in place.

_SLOT_MESH = ("the slot bank's mesh placement comes with ROADMAP Queue A "
              "item 11b")


def slot_cache_specs(cfg: LlamaConfig, mesh):
    """``mxtpu``'s PartitionSpecs of the slot state on a mesh: raises
    until the multi-device slice."""
    raise NotImplementedError(_SLOT_MESH)


def init_slot_cache(cfg: LlamaConfig, max_slots: int, max_len: int,
                    mesh=None, device: DeviceLike = None):
    """The serving engine's device state: the slot KV bank ``k``/``v``
    of (L, max_slots, n_kv_heads, max_len, hd) in the compute dtype,
    and per slot ``lengths`` (valid cache entries, int32), ``tokens``
    (the next input token, int32) and ``rngs`` ((max_slots, 2) int64
    keys of :mod:`mxtpu_torch.prng`, each request's own chain)."""
    if mesh is not None:
        raise NotImplementedError(_SLOT_MESH)
    device = resolve_device(device)
    shape = (cfg.n_layers, max_slots, cfg.n_kv_heads, max_len,
             cfg.head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "lengths": torch.zeros((max_slots,), **i32),
            "tokens": torch.zeros((max_slots,), **i32),
            "rngs": torch.zeros((max_slots, 2), dtype=torch.int64,
                                device=device)}


def _layer_slots(cfg: LlamaConfig, cos, sin, x, lp, attend):
    """One block of a slot step: x (S, W, dim), W new tokens per slot
    (1 in decode, k + 1 in the speculative verify step). ``attend(q, k,
    v)`` writes the new K/V into the slot's cache and returns its
    attention over the slot's prefix: the dense bank and the page pool
    differ only there."""
    b, s, _ = x.shape
    dt = cfg.dtype
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, cos, sin)
    o = attend(q, k, v)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    x = x + o @ _wq8(lp["wo"], dt)
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    delta, _ = _ffn(cfg, lp, h, serving=True)
    return x + delta


def _bank_attend(kv, pos):
    """``attend`` of :func:`_slot_forward` over the dense bank: slot i
    writes its new K/V at ``pos[i]`` of its row (one scatter for the
    bank) and attends its prefix [0, pos[i] + 1)."""
    def attend(i, q, k, v):
        ck, cv = kv["k"][i], kv["v"][i]
        at = pos.reshape(-1, 1, 1, 1).expand(-1, *k.shape[1:])
        ck.scatter_(2, at, k)
        cv.scatter_(2, at, v)
        return slot_decode_attention(q, ck, cv, pos + 1)
    return attend


def _slot_forward(cfg: LlamaConfig, params, tokens, cw, rope, attend):
    """Every slot's tokens (S, W) at positions ``cw`` (S, W) through the
    stack, layer i attending through ``attend(i, q, k, v)``: the f32
    logits (S, W, V)."""
    x = _embed(cfg, params, tokens)
    cos_t, sin_t = rope
    cos, sin = cos_t[cw][:, None], sin_t[cw][:, None]   # (S, 1, W, hd/2)
    for i in range(cfg.n_layers):
        x = _layer_slots(cfg, cos, sin, x, _layer_params(params, i),
                         partial(attend, i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x)


def _sample_slots(logits, sv, active, temperature, top_k, top_p):
    """The sampler and key chain of a one-token slot step: each slot
    splits its own key (``key, sub = split(key)``) and draws on its own
    (1, V) row, as a batch-1 :func:`generate` would; ``lengths``
    advance by ``active``, and ``tokens`` and ``rngs`` take the draw
    and the carried keys, in place."""
    keys = prng.split(sv["rngs"])                  # (S, 2, 2): carry, sub
    sampled = sample_logits(keys[:, 1], logits, temperature, top_k, top_p)
    sv["lengths"].add_(active.to(sv["lengths"].dtype))
    sv["tokens"].copy_(sampled)
    sv["rngs"].copy_(keys[:, 0])
    return sampled


def decode_slots(cfg: LlamaConfig, params, kv, sv, active, temperature,
                 top_k, top_p, mesh=None, rope=None):
    """One continuous-batching decode step over the whole slot bank: the
    one program the serving engine keeps hot. Per-slot position and
    length vectors drive the RoPE rows, the cache write and the
    length-masked attention, so requests entering and leaving the bank
    never change its shapes.

    kv: {"k", "v"}, the bank, written in place. sv: {"lengths",
    "tokens", "rngs"}, written in place too. active: (S,) bool; an
    inactive slot still flows through (fixed shapes), but its length
    does not advance and the engine discards its sample. temperature,
    top_k, top_p: (S,) per-slot tensors (``sample_logits``' traced
    mode, so a mixed batch shares the step). Each slot advances its own
    key as a batch-1 :func:`generate` would (``key, sub = split(key)``,
    then a draw on its (1, V) row), which makes the engine's tokens
    equal per-request generation. Nothing here reads a device value
    back to the host, so the step can be captured as a CUDA graph.
    rope: the (max_len, hd/2) (cos, sin) tables of :func:`rope_tables`;
    None takes the shared cached ones. A captured step must be given
    tables its owner holds: the shared cache may drop an entry, and a
    graph keeps reading the addresses it was captured with.
    Returns (sampled (S,) int32, kv, sv)."""
    _no_mesh(mesh)
    max_len = kv["k"].shape[3]
    pos = sv["lengths"].clamp(max=max_len - 1).long()  # each slot's write row
    logits = _slot_forward(cfg, params, sv["tokens"][:, None], pos[:, None],
                           rope or _rope_cached(cfg, max_len, pos.device),
                           _bank_attend(kv, pos))
    sampled = _sample_slots(logits[:, 0], sv, active, temperature, top_k,
                            top_p)
    return sampled, kv, sv


def _scalar(x, dtype, device):
    """A host int or a 0-d tensor as a 0-d tensor on ``device``."""
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(())


def _prefill_bucket(cfg: LlamaConfig, params, tokens, true_len, rng,
                    temperature, top_k, top_p, cache=None):
    """The bucketed prompt through the cached stack, then the first
    token from ``split(rng)``'s subkey: (tok (1,), cache, the carried
    key). ``cache`` defaults to a fresh bucket-sized one; a paged warm
    admission passes its gathered view with ``pos`` at the prefix
    length, and ``true_len`` counts the prefix too. Shared by
    :func:`prefill_slot`, :func:`prefill_detached` and
    :func:`prefill_slot_paged`."""
    b, bucket = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, bucket, device=tokens.device)
    last = _scalar(true_len, torch.int64, tokens.device) - cache["pos"] - 1
    logits, cache = _forward_cached(cfg, params, tokens, cache,
                                    last_index=last)
    rng, sub = prng.split(rng)
    tok = sample_logits(sub, logits[:, 0], temperature, top_k, top_p)
    return tok, cache, rng


def _seat_vectors(sv, true_len, slot, token, rng):
    """Seed slot ``slot``'s length, next token and key, by index ops on
    the vectors' device."""
    dev = sv["lengths"].device
    at = _scalar(slot, torch.int64, dev).reshape(1)
    sv["lengths"].index_copy_(0, at, _scalar(true_len, torch.int32,
                                             dev).reshape(1))
    sv["tokens"].index_copy_(0, at, _scalar(token, torch.int32,
                                            dev).reshape(1))
    sv["rngs"].index_copy_(0, at, rng.reshape(1, 2).to(dev))


def _seat_slot(kv, sv, k_block, v_block, true_len, slot, token, rng):
    """Write one request's (L, kvh, n, hd) K/V into positions [0, n) of
    bank row ``slot`` and its length, next token and key into the slot
    vectors, all by index ops on the bank's device."""
    dev = kv["k"].device
    at = _scalar(slot, torch.int64, dev).reshape(1)
    n = k_block.shape[2]
    for name, blk in (("k", k_block), ("v", v_block)):
        kv[name][:, :, :, :n].index_copy_(
            1, at, blk[:, None].to(kv[name].dtype))
    _seat_vectors(sv, true_len, slot, token, rng)


def prefill_slot(cfg: LlamaConfig, params, tokens, true_len, slot, kv, sv,
                 rng, temperature, top_k, top_p, mesh=None):
    """Admission: run one request's prompt, end-padded to its bucket,
    through the cached stack, write its K/V into row ``slot`` of the
    bank, seed the slot's length, next token and key, and sample the
    first generated token. End padding is exact: causal masking keeps
    every real position off the pads, the slot's length masks the pad
    K/V, and decode overwrites each before the length reaches it.

    tokens: (1, bucket) int; true_len, slot: ints or 0-d tensors; rng:
    the request's (2,) key; kv/sv as in :func:`decode_slots`, written
    in place. Returns (first token (1,) int32, kv, sv)."""
    _no_mesh(mesh)
    tok, tmp, rng = _prefill_bucket(cfg, params, tokens, true_len, rng,
                                    temperature, top_k, top_p)
    _seat_slot(kv, sv, tmp["k"][:, 0], tmp["v"][:, 0], true_len, slot,
               tok.reshape(()), rng)
    return tok, kv, sv


def prefill_detached(cfg: LlamaConfig, params, tokens, true_len, rng,
                     temperature, top_k, top_p, mesh=None):
    """Prefill one request without a slot bank (the prefill half of a
    disaggregated handoff): the end-padded prompt through the cached
    stack, with the same sampler and key chain as
    :func:`prefill_slot`. Returns (first token (1,), k_block, v_block,
    the carried key), the blocks (L, n_kv_heads, bucket, hd)."""
    _no_mesh(mesh)
    tok, tmp, rng = _prefill_bucket(cfg, params, tokens, true_len, rng,
                                    temperature, top_k, top_p)
    return tok, tmp["k"][:, 0], tmp["v"][:, 0], rng


def prefill_detached_chunk(cfg: LlamaConfig, params, chunk, cache,
                           true_len, rng, temperature, top_k, top_p,
                           mesh=None, rope=None):
    """One chunk of a streamed detached prefill: ``chunk`` (1, cw),
    positions ``cache["pos"]`` to ``pos + cw`` of the end-padded prompt,
    through the cached stack. Iterated over the bucket it is one
    :func:`prefill_detached`: each position masks the same causal
    prefix of the same bucket-sized cache, and each chunk splits the
    same request key once. ``cache``: the (L, 1, n_kv_heads, bucket, hd)
    buffers of :func:`init_cache` and ``pos``, carried across calls.
    Returns (tok (1,), k_chunk, v_chunk, the carried key, cache), the
    chunks (L, n_kv_heads, cw, hd); ``tok`` and the key mean something
    only from the chunk that holds position ``true_len - 1``.

    With ``cache["pos"]`` a 0-d int64 tensor, ``true_len`` a 0-d tensor
    and the sampling knobs (1,) tensors, nothing is read back to the
    host, so the chunk can be captured as a CUDA graph (pass ``rope``
    tables the caller holds); it gives the same bits as the host-int
    chunk."""
    _no_mesh(mesh)
    cw = chunk.shape[1]
    pos0 = cache["pos"]
    if not isinstance(pos0, torch.Tensor):
        pos0 = int(pos0)
    true_len = _scalar(true_len, torch.int64, chunk.device)
    last = (true_len - 1 - pos0).clamp(0, cw - 1)
    logits, cache = _forward_cached(cfg, params, chunk, cache,
                                    last_index=last, rope=rope)
    rng, sub = prng.split(rng)
    tok = sample_logits(sub, logits[:, 0], temperature, top_k, top_p)
    if isinstance(pos0, torch.Tensor):
        rows = pos0 + torch.arange(cw, device=chunk.device)
        k_chunk = cache["k"][:, 0].index_select(2, rows)
        v_chunk = cache["v"][:, 0].index_select(2, rows)
    else:
        k_chunk = cache["k"][:, 0, :, pos0:pos0 + cw].clone()
        v_chunk = cache["v"][:, 0, :, pos0:pos0 + cw].clone()
    return tok, k_chunk, v_chunk, rng, cache


def inject_slot_kv(cfg: LlamaConfig, k_block, v_block, true_len, slot,
                   token, rng, kv, sv, mesh=None):
    """Decode-side admission of a handed-off prefill: the scatter half
    of :func:`prefill_slot`. Writes the (L, n_kv_heads, bucket, hd) K/V
    into row ``slot`` of the bank and seeds the slot's length, token and
    key (the key after the first token's split). Returns (kv, sv)."""
    _no_mesh(mesh)
    dev = kv["k"].device
    _seat_slot(kv, sv, torch.as_tensor(k_block, device=dev),
               torch.as_tensor(v_block, device=dev), true_len, slot, token,
               rng)
    return kv, sv


# ---------------------------------------------------------------------------
# the paged pool (PagedAttention, Kwon et al. SOSP '23): the K/V of every
# slot lives in fixed-size pages of one pool, and a host-owned page table
# maps each slot's logical pages to pool pages. Admission is bounded by
# free pages, not slots, and read-only prefix pages are shared between
# slots (the refcounted allocator and the prefix cache live in
# mxtpu_torch.serve; these are their device halves). Page 0 is scratch:
# the engine never hands it out, zeroed table rows name it, and
# redirected writes land there, never attended.
# ---------------------------------------------------------------------------

def paged_cache_specs(cfg: LlamaConfig, mesh):
    """``mxtpu``'s PartitionSpecs of the paged pool on a mesh: raises
    until the multi-device slice."""
    raise NotImplementedError(_SLOT_MESH)


def init_paged_cache(cfg: LlamaConfig, max_slots: int, n_pages: int,
                     page_size: int, mesh=None, int8: bool = False,
                     device: DeviceLike = None):
    """The paged engine's device state: K/V pools ``k``/``v`` of (L,
    n_pages, n_kv_heads, page_size, hd) in the compute dtype, and the
    per-slot ``lengths``, ``tokens`` and ``rngs`` of
    :func:`init_slot_cache`. Page tables stay on the host, a small
    int32 operand of each step. ``int8=True`` stores int8 pools with f32
    per-token-per-head scales ``ks``/``vs`` of (L, n_pages, n_kv_heads,
    page_size), dequantised as they are gathered."""
    if mesh is not None:
        raise NotImplementedError(_SLOT_MESH)
    device = resolve_device(device)
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size,
             cfg.head_dim)
    if int8:
        pools = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "ks": torch.ones(shape[:4], dtype=torch.float32,
                                  device=device),
                 "vs": torch.ones(shape[:4], dtype=torch.float32,
                                  device=device)}
    else:
        pools = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    i32 = dict(dtype=torch.int32, device=device)
    pools.update({"lengths": torch.zeros((max_slots,), **i32),
                  "tokens": torch.zeros((max_slots,), **i32),
                  "rngs": torch.zeros((max_slots, 2), dtype=torch.int64,
                                      device=device)})
    return pools


def _q8_token(x):
    """Per-token-per-head symmetric int8 over the last axis: codes
    ``clip(round(x / s), ±127)``, rounding half to even, with
    ``s = max(max|x| / 127, 1e-8)`` in f32. The divisors are tensors on
    x's device: a division by a host scalar on the card is a multiply
    by its reciprocal, which can land an ulp away."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1)
    s = (s / torch.full_like(s, 127.0)).clamp_min(1e-8)
    q = torch.round(x32 / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _paged_attend(kv, page_table, phys, off, qlen):
    """``attend`` of :func:`_slot_forward` over the page pool: the new
    K/V of slot s's position j go to pool page ``phys[s, j]`` at
    in-page offset ``off[s, j]`` (one advanced-index write a pool;
    inactive slots and redirected positions all name scratch page 0, so
    those writes collide there, harmlessly), quantised first in an int8
    pool, then each query attends its own prefix [0, qlen[s, j])."""
    def attend(i, q, k, v):
        knew, vnew = k.transpose(1, 2), v.transpose(1, 2)  # (S, W, kvh, hd)
        ck, cv = kv["k"][i], kv["v"][i]
        if "ks" not in kv:
            ck[phys, :, off] = knew.to(ck.dtype)
            cv[phys, :, off] = vnew.to(cv.dtype)
            return paged_decode_attention(q, ck, cv, page_table, qlen)
        cks, cvs = kv["ks"][i], kv["vs"][i]
        for pool, scales, new in ((ck, cks, knew), (cv, cvs, vnew)):
            pool[phys, :, off], scales[phys, :, off] = _q8_token(new)
        return paged_decode_attention(q, ck, cv, page_table, qlen,
                                      k_scales=cks, v_scales=cvs)
    return attend


def _paged_logits(cfg: LlamaConfig, params, kv, sv, page_table, tokens,
                  rope):
    """Each slot's W tokens (S, W) at positions lengths + [0, W) through
    the stack over the pool: f32 logits (S, W, V). A position at or past
    the row's capacity writes to scratch page 0, never clamped onto the
    slot's last page; its RoPE row and query length are clamped."""
    ps = kv["k"].shape[3]
    cap = page_table.shape[1] * ps
    pt = page_table.long()
    pos = sv["lengths"].clamp(max=cap - 1).long()
    wpos = pos[:, None] + torch.arange(tokens.shape[1], device=pos.device)
    cw = wpos.clamp(max=cap - 1)
    phys = torch.where(wpos >= cap, 0, pt.gather(1, cw // ps))
    attend = _paged_attend(kv, pt, phys, cw % ps, wpos + 1)
    return _slot_forward(cfg, params, tokens, cw,
                         rope or _rope_cached(cfg, cap, pos.device), attend)


def decode_slots_paged(cfg: LlamaConfig, params, kv, sv, active,
                       page_table, temperature, top_k, top_p, mesh=None,
                       rope=None):
    """One decode step over the paged pool: :func:`decode_slots` with
    each slot's bank row replaced by its row of ``page_table`` (S,
    pages_per_slot) int32, a small per-step operand the host owns.
    Inactive slots carry zeroed rows, so their write lands in scratch
    page 0. Sampling, the key chain and the length mask are
    :func:`decode_slots`' own. kv: the pools of
    :func:`init_paged_cache` (with ``ks``/``vs`` when int8); sv, active,
    the knobs and ``rope`` (of the row's capacity) as for
    :func:`decode_slots`. Returns (sampled (S,) int32, kv, sv)."""
    _no_mesh(mesh)
    logits = _paged_logits(cfg, params, kv, sv, page_table,
                           sv["tokens"][:, None], rope)
    sampled = _sample_slots(logits[:, 0], sv, active, temperature, top_k,
                            top_p)
    return sampled, kv, sv


def _scatter_slot_pages(kv, pages_row, tmp_k, tmp_v, prefix_len, bucket):
    """Write positions [prefix_len, prefix_len + bucket) of a slot's
    contiguous (L, 1, kvh, n, hd) prefill view into the pool pages of
    ``pages_row``, quantised in an int8 pool; every other position keeps
    its stored bytes (quantise∘dequantise is not idempotent, so shared
    pages are never rewritten). Positions past the row's real pages
    name scratch page 0."""
    ps = kv["k"].shape[3]
    p = torch.arange(prefix_len, prefix_len + bucket, device=pages_row.device)
    phys, off = pages_row[p // ps], p % ps
    for name, tmp in (("k", tmp_k), ("v", tmp_v)):
        span = tmp[:, 0, :, prefix_len:prefix_len + bucket].permute(2, 0, 1, 3)
        if "ks" in kv:                         # (bucket, L, kvh, hd)
            kv[name][:, phys, :, off], kv[name + "s"][:, phys, :, off] = \
                _q8_token(span)
        else:
            kv[name][:, phys, :, off] = span.to(kv[name].dtype)


def prefill_slot_paged(cfg: LlamaConfig, params, tokens, true_len,
                       prefix_len, pages_row, slot, kv, sv, rng,
                       temperature, top_k, top_p, mesh=None):
    """Paged admission, cold or warm: gather the slot's pages into a
    contiguous view, run the suffix tokens (end-padded to their bucket)
    through the cached stack at ``pos=prefix_len``, write the span back
    into the pages, seed the slot vectors, and sample the first token.

    Warm admission (``prefix_len > 0``) is what prefix sharing buys:
    the shared pages hold positions [0, prefix_len), the suffix attends
    them through the causal mask as ``chunked_prefill`` attends an
    earlier chunk, and only the suffix pays forward work. Cold
    admission is the same program at ``prefix_len=0``. The view holds
    only the positions < prefix_len + bucket (the reference gathers the
    whole row; later positions are masked either way), so a cold
    admission attends over the keys the dense prefill does.

    tokens: (1, bucket) suffix; true_len: the total valid length
    (prefix + real suffix); prefix_len: a host int; pages_row:
    (pages_per_slot,) int, the slot's table row (scratch-0 entries past
    its pages). The engine keeps [prefix_len, prefix_len + bucket)
    inside the row and every page it touches private (forked). kv/sv
    are written in place. Returns (first token (1,) int32, kv, sv)."""
    _no_mesh(mesh)
    bucket = tokens.shape[1]
    ps = kv["k"].shape[3]
    m = int(prefix_len)
    n = m + bucket
    row = torch.as_tensor(pages_row, device=kv["k"].device).long()
    view = row[:-(-n // ps)]
    cache = {name: gather_pages(kv[name], view[None], 0, n,
                                kv.get(name + "s"), cfg.dtype).contiguous()
             for name in ("k", "v")}
    cache["pos"] = m
    tok, cache, rng = _prefill_bucket(cfg, params, tokens, true_len, rng,
                                      temperature, top_k, top_p, cache)
    _scatter_slot_pages(kv, row, cache["k"], cache["v"], m, bucket)
    _seat_vectors(sv, true_len, slot, tok.reshape(()), rng)
    return tok, kv, sv


def inject_paged_kv(cfg: LlamaConfig, k_block, v_block, true_len,
                    pages_row, slot, token, rng, kv, sv, mesh=None):
    """Decode-side admission of a handed-off prefill into the pool: the
    (L, n_kv_heads, bucket, hd) blocks, end-padded to whole pages,
    split into page_size chunks at the slot's first ceil(bucket / ps)
    pages (quantised per token in an int8 pool), and the slot's length,
    token and key seeded. Pad K/V past ``true_len`` lands in the slot's
    own pages, masked by its length. Returns (kv, sv)."""
    _no_mesh(mesh)
    dev = kv["k"].device
    ps = kv["k"].shape[3]
    row = torch.as_tensor(pages_row, device=dev).long()
    for name, blk in (("k", k_block), ("v", v_block)):
        blk = torch.as_tensor(blk, device=dev)
        L, hkv, bucket, hd = blk.shape
        n_blk = -(-bucket // ps)
        pages = torch.nn.functional.pad(
            blk, (0, 0, 0, n_blk * ps - bucket)).reshape(
                L, hkv, n_blk, ps, hd).transpose(1, 2)
        dst = row[:n_blk]
        if "ks" in kv:
            q, sc = _q8_token(pages)
            kv[name].index_copy_(1, dst, q)
            kv[name + "s"].index_copy_(1, dst, sc)
        else:
            kv[name].index_copy_(1, dst, pages.to(kv[name].dtype))
    _seat_vectors(sv, true_len, slot, token, rng)
    return kv, sv


def copy_page(kv, src, dst):
    """Copy pool page ``src`` onto page ``dst`` in every pool array (k,
    v, and ks, vs when int8): the engine's copy-on-write fork, one
    ``index_copy_`` an array for any src and dst (host ints or 0-d
    tensors). The slot vectors are untouched. Returns kv."""
    dev = kv["k"].device
    s = _scalar(src, torch.int64, dev).reshape(1)
    d = _scalar(dst, torch.int64, dev).reshape(1)
    for name in ("k", "v", "ks", "vs"):
        if name in kv:
            kv[name].index_copy_(1, d, kv[name].index_select(1, s))
    return kv


# ---------------------------------------------------------------------------
# speculative decoding: one batched verify forward over each slot's
# current token and its k drafted tokens against the pool, with an
# exact-match accept oracle (a draft is accepted iff it is the token the
# slot's own key chain would emit there), so the served stream is
# per-request generate's whatever the drafter proposes. Drafting is the
# host's (mxtpu_torch.serve.engine.ngram_drafter).
# ---------------------------------------------------------------------------

def decode_slots_spec(cfg: LlamaConfig, params, kv, sv, active,
                      page_table, drafts, temperature, top_k, top_p,
                      mesh=None, rope=None):
    """One speculative step over the pool: each slot's current token
    and its k drafts (W = k + 1 positions) through one forward, query j
    attending its own prefix [0, length + j + 1), then the accept oracle
    down each slot's key chain.

    Emission i + 1 of a slot is ``sample_logits`` of the logits after
    position length + i, drawn as :func:`decode_slots_paged` draws (one
    split per valid emission; a rejected position never advances the
    chain, so ``serve.resume_key(seed, n_emitted)`` stays exact).
    Emission i + 1 is valid iff every earlier draft equalled its
    emission, so a slot emits 1 to W tokens; the K/V written past the
    accepted run are masked by the new length and overwritten later.

    drafts: (S, k) int32, < 0 for no draft (a slot without drafts emits
    exactly the plain step's token). Writes past the row's capacity go
    to scratch page 0. page_table, the knobs and ``rope`` as for
    :func:`decode_slots_paged`. Returns (toks (S, W) int32, emits (S, W)
    bool, kv, sv): the engine emits ``toks[s, :emits[s].sum()]``."""
    _no_mesh(mesh)
    S, W = drafts.shape[0], drafts.shape[1] + 1
    tokens = torch.cat([sv["tokens"][:, None],
                        drafts.to(sv["tokens"].dtype)], dim=1)
    logits = _paged_logits(cfg, params, kv, sv, page_table, tokens, rope)
    # the draft emission i verifies (none after the last position)
    nxt = torch.cat([drafts.to(torch.int32),
                     torch.full((S, 1), -1, dtype=torch.int32,
                                device=drafts.device)], dim=1)
    key = sv["rngs"]
    ok = torch.ones(S, dtype=torch.bool, device=key.device)
    toks, emits = [], []
    for i in range(W):           # W is static: the oracle, batched over S
        keys = prng.split(key)
        tok = sample_logits(keys[:, 1], logits[:, i], temperature, top_k,
                            top_p)
        emits.append(ok)
        toks.append(tok)
        key = torch.where(ok[:, None], keys[:, 0], key)
        ok = ok & (nxt[:, i] >= 0) & (tok == nxt[:, i])
    toks, emits = torch.stack(toks, dim=1), torch.stack(emits, dim=1)
    n_emit = emits.sum(dim=1, dtype=torch.int32)           # (S,) in 1..W
    last = toks.gather(1, (n_emit - 1).clamp(min=0).long()[:, None])[:, 0]
    sv["lengths"].add_(n_emit * active.to(torch.int32))
    sv["tokens"].copy_(last)
    sv["rngs"].copy_(key)
    return toks, emits, kv, sv


# ---------------------------------------------------------------------------
# nn.Module façade
# ---------------------------------------------------------------------------
class Llama(nn.Module):
    """The parameters of one Llama under ``mxtpu``'s names and shapes
    (``tok_embed``, ``layers.{attn_norm, wq, wk, wv, wo, ffn_norm,
    w_gate, w_up, w_down}`` stacked on a leading layer dim, with
    ``moe_gate`` and an expert dim in a MoE config, ``final_norm``,
    ``lm_head``), with :meth:`forward`, :meth:`loss`
    and :meth:`generate` over the functions of this module. The
    parameters require grad, so :meth:`forward` and :meth:`loss` build
    an autograd graph unless grad mode is off; :meth:`generate` never
    does."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        tree = init_params(cfg, generator, device)
        self.layers = nn.ParameterDict()
        self._assign(tree)

    def _assign(self, tree):
        for k, v in tree.items():
            if k == "layers":
                for lk, lv in v.items():
                    self.layers[lk] = nn.Parameter(lv)
            else:
                setattr(self, k, nn.Parameter(v))

    def tree(self):
        """The parameters as ``mxtpu``'s nested dict (no copy)."""
        out = {k: p for k, p in self.named_parameters(recurse=False)}
        out["layers"] = dict(self.layers.items())
        return out

    @torch.no_grad()
    def load_numpy_tree(self, tree):
        """Copy a numpy tree (``mxtpu``'s keys and shapes) into the
        parameters, cast to their dtype and device."""
        own = self.tree()
        pairs = [(own[k], v) for k, v in tree.items() if k != "layers"]
        pairs += [(own["layers"][k], v) for k, v in tree["layers"].items()]
        for p, a in pairs:
            if tuple(p.shape) != tuple(np.shape(a)):
                raise ValueError(f"shape {np.shape(a)} does not match the "
                                 f"parameter's {tuple(p.shape)}")
            p.copy_(torch.tensor(np.asarray(a)))

    def forward(self, tokens):
        return forward(self.cfg, self.tree(), tokens)

    def loss(self, batch):
        """The causal-LM loss of :func:`loss_fn` on ``batch``."""
        return loss_fn(self.cfg)(self.tree(), batch)

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens: int, **kw):
        return generate(self.cfg, self.tree(), prompt, max_new_tokens, **kw)

