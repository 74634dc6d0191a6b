"""Llama-family transformer, inference half — the port of
``mxtpu/models/llama.py``.

Plain functions over a parameter tree with ``mxtpu``'s keys and
layout (per-layer weights stacked on a leading layer dim), plus the
:class:`Llama` ``nn.Module`` façade. PyTorch runs eagerly, so the
layers are a Python loop over the stacked dim where ``mxtpu`` scans.
Attention in :func:`forward` goes through
:func:`mxtpu_torch.ops.attention.flash_attention`: the hand-written
CUDA kernel on the card, the blockwise plain version on the CPU.

What this slice covers: ``forward`` (the full-sequence scoring pass)
and greedy ``generate`` (``prefill`` + ``decode_step`` over a KV
cache). What waits for later slices, and raises here: the backward and
training step, sampled generation (the ``jax.random`` chain), MoE,
int8 weights, ring/ulysses attention and mesh sharding.

Numerics follow ``mxtpu``: ``rms_norm`` and RoPE compute in f32, and
the three einsums that ask for f32 results from ``cfg.dtype`` operands
(the logits heads and the cached attention scores) upcast their
operands, which is exact for bf16.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..context import DeviceLike, resolve_device
from ..ops.attention import dense_attention, flash_attention

__all__ = ["LlamaConfig", "CONFIGS", "init_params", "rms_norm",
           "rope_tables", "apply_rope", "forward_hidden", "forward",
           "init_cache", "prefill", "decode_step", "sample_logits",
           "generate", "params_from_numpy", "params_to_numpy", "Llama"]

_RNG_SLICE = ("sampled generation (temperature/top_k/top_p) needs the "
              "port of the jax.random Threefry chain, a later slice")
_INT8_SLICE = "int8 weight-only serving comes with a later slice"


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
    attn_impl: str = "flash"         # flash | dense (ring | ulysses: later)
    remat: bool = True               # no effect at inference
    remat_policy: Optional[str] = None
    scan_layers: bool = True         # no effect: layers are a Python loop
    tie_embeddings: bool = False
    ce_chunk: Optional[int] = 0
    moe_experts: int = 0             # > 0 raises in this slice
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
            "mesh sharding comes with the multi-device slice; pass mesh=None")


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
# weight carry: mxtpu's tree as numpy arrays <-> the port's tree
# ---------------------------------------------------------------------------
def params_from_numpy(tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None):
    """A nested dict of numpy arrays (``mxtpu``'s keys and stacked
    layout, e.g. ``jax.tree.map(np.asarray, params)``) → the same tree
    of tensors on ``device``; ``dtype`` casts floating leaves."""
    device = resolve_device(device)

    def conv(a):
        t = torch.tensor(np.asarray(a))     # a copy: jax's arrays are read-only
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return {k: params_from_numpy(v, device, dtype) if isinstance(v, dict)
            else conv(v) for k, v in tree.items()}


def params_to_numpy(params):
    """The port's tree → a nested dict of numpy arrays, keys kept. A
    bf16 leaf comes back as float32, which numpy can hold exactly."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {k: params_to_numpy(v) if isinstance(v, dict) else conv(v)
            for k, v in params.items()}


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


def apply_rope(x, cos, sin):
    """x: (b, h, s, hd); rotate-half convention."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention(cfg: LlamaConfig, q, k, v):
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} needs sequence parallelism over "
            "torch.distributed, a later slice; use 'flash' or 'dense'")
    if cfg.attn_impl == "dense":
        return dense_attention(q, k, v, causal=True)
    if cfg.attn_impl != "flash":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return flash_attention(q, k, v, causal=True)


def _wq8(w, dt):
    """Serving weight loader: the raw-array branch. An int8 weight dict
    (``mxtpu``'s ``quantize_params_int8``) raises in this slice."""
    if isinstance(w, dict):
        raise NotImplementedError(_INT8_SLICE)
    return w.to(dt)


def _head(cfg: LlamaConfig, params):
    return (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])


def _qkv(cfg: LlamaConfig, lp, h, cos, sin):
    """Projections + RoPE → q (b, h, s, hd), k and v (b, kvh, s, hd)."""
    b, s, _ = h.shape
    hd, dt = cfg.head_dim, h.dtype
    q = (h @ _wq8(lp["wq"], dt)).reshape(b, s, cfg.n_heads, hd)
    k = (h @ _wq8(lp["wk"], dt)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ _wq8(lp["wv"], dt)).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def _ffn(cfg: LlamaConfig, lp, h):
    """Dense SwiGLU residual delta."""
    if cfg.moe_experts:
        raise NotImplementedError(
            "the MoE expert bank (moe_experts > 0) comes with a later slice")
    dt = h.dtype
    gate = torch.nn.functional.silu(h @ _wq8(lp["w_gate"], dt))
    up = h @ _wq8(lp["w_up"], dt)
    return (gate * up) @ _wq8(lp["w_down"], dt)


def _layer(cfg: LlamaConfig, cos, sin, x, lp):
    """One transformer block. x: (b, s, dim) in cfg.dtype."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, cos, sin)
    o = _attention(cfg, q, k, v)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    x = x + o @ _wq8(lp["wo"], x.dtype)
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    return x + _ffn(cfg, lp, h)


def _layer_params(params, i: int):
    return {k: v[i] for k, v in params["layers"].items()}


def _embed(cfg: LlamaConfig, params, tokens):
    """Gather the token rows, then cast them."""
    emb = params["tok_embed"]
    if isinstance(emb, dict):
        raise NotImplementedError(_INT8_SLICE)
    return emb[tokens.long()].to(cfg.dtype)


def forward_hidden(cfg: LlamaConfig, params, tokens, mesh=None):
    """tokens: (batch, seq) int → final-norm hidden states
    (batch, seq, dim) in cfg.dtype. ``cfg.remat`` and
    ``cfg.scan_layers`` change nothing here: there is no backward to
    save memory for in this slice, and the layers are a Python loop."""
    _no_mesh(mesh)
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    cos, sin = rope_tables(cfg, s, device=x.device)
    for i in range(cfg.n_layers):
        x = _layer(cfg, cos, sin, x, _layer_params(params, i))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _logits(cfg: LlamaConfig, params, x):
    """f32 logits from cfg.dtype hidden states and head (exact upcast)."""
    head = _wq8(_head(cfg, params), cfg.dtype)
    return torch.matmul(x.float(), head.float())


def forward(cfg: LlamaConfig, params, tokens, mesh=None):
    """tokens: (batch, seq) int → logits (batch, seq, vocab) f32."""
    return _logits(cfg, params, forward_hidden(cfg, params, tokens, mesh))


# ---------------------------------------------------------------------------
# KV-cache inference
# ---------------------------------------------------------------------------
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
    1; ck/cv: (b, kvh, max_len, hd), written in place at [pos, pos+s)."""
    b, s, _ = x.shape
    hd, dt = cfg.head_dim, cfg.dtype
    max_len = ck.shape[2]
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, cos, sin)
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
    qpos = pos + torch.arange(s, device=x.device)[:, None]
    logits = torch.where(kpos <= qpos, logits, -math.inf)
    p = torch.softmax(logits, dim=-1).to(dt)
    o = torch.einsum("bgrsk,bgkd->bgrsd", p, cv)
    o = o.reshape(b, cfg.n_heads, s, hd)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    x = x + o @ _wq8(lp["wo"], dt)
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    return x + _ffn(cfg, lp, h)


def _forward_cached(cfg: LlamaConfig, params, tokens, cache,
                    last_only: bool = False):
    """Shared prefill/decode body: runs the stack over the cache and
    returns (logits (b, s, V) f32, cache). ``last_only`` applies the
    lm_head to the final position only."""
    s = tokens.shape[1]
    max_len = cache["k"].shape[3]
    pos = int(cache["pos"])
    if pos + s > max_len:
        # mxtpu's dynamic_update_slice would clamp the write silently
        raise ValueError(f"cache overflow: pos {pos} + {s} new tokens > "
                         f"max_len {max_len}")
    x = _embed(cfg, params, tokens)
    cos_t, sin_t = rope_tables(cfg, max_len, device=x.device)
    cos, sin = cos_t[pos:pos + s], sin_t[pos:pos + s]
    for i in range(cfg.n_layers):
        x = _layer_cached(cfg, cos, sin, pos, x, _layer_params(params, i),
                          cache["k"][i], cache["v"][i])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
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


def decode_step(cfg: LlamaConfig, params, token, cache, mesh=None):
    """One autoregressive step. token: (b, 1) int. Returns
    (logits (b, V) f32 for the next position, cache)."""
    _no_mesh(mesh)
    logits, cache = _forward_cached(cfg, params, token, cache)
    return logits[:, 0], cache


def sample_logits(rng, lg, temperature=0.0, top_k=None, top_p=None):
    """lg: (b, V) f32 logits → (b,) tokens. Greedy (argmax) only in this
    slice; ``rng`` is unused."""
    if temperature != 0.0 or top_k is not None or top_p is not None:
        raise NotImplementedError(_RNG_SLICE)
    return torch.argmax(lg, dim=-1)


def generate(cfg: LlamaConfig, params, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, rng=None, mesh=None):
    """Greedy autoregressive generation: prefill, then one
    :func:`decode_step` per new token over a cache sized
    ``prompt_len + max_new_tokens``. Returns (b, prompt_len +
    max_new_tokens) tokens in the prompt's dtype, on its device."""
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature != 0.0 or top_k is not None or top_p is not None:
        raise NotImplementedError(_RNG_SLICE)
    _no_mesh(mesh)
    b, s0 = prompt.shape
    cache = init_cache(cfg, b, s0 + max_new_tokens, device=prompt.device)
    logits, cache = _forward_cached(cfg, params, prompt, cache,
                                    last_only=True)
    tok = sample_logits(rng, logits[:, -1])
    out = [prompt, tok[:, None].to(prompt.dtype)]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(cfg, params, tok[:, None], cache)
        tok = sample_logits(rng, logits)
        out.append(tok[:, None].to(prompt.dtype))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# nn.Module façade
# ---------------------------------------------------------------------------
class Llama(nn.Module):
    """The parameters of one Llama under ``mxtpu``'s names and shapes
    (``tok_embed``, ``layers.{attn_norm, wq, wk, wv, wo, ffn_norm,
    w_gate, w_up, w_down}`` stacked on a leading layer dim,
    ``final_norm``, ``lm_head``), with :meth:`forward` and
    :meth:`generate` over the functions of this module. Inference only
    in this slice: the parameters do not require grad."""

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
                    self.layers[lk] = nn.Parameter(lv, requires_grad=False)
            else:
                setattr(self, k, nn.Parameter(v, requires_grad=False))

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

    def generate(self, prompt, max_new_tokens: int, **kw):
        return generate(self.cfg, self.tree(), prompt, max_new_tokens, **kw)

