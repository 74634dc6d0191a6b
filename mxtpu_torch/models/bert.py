"""BERT masked-LM pretraining — the port of ``mxtpu/models/bert.py``.

Plain functions over a parameter tree with ``mxtpu``'s keys and layout,
plus the :class:`Bert` ``nn.Module`` façade: a post-LN transformer
encoder (original BERT) with learned positions and token types, bf16
activations over f32 params, optional per-layer recomputation, and the
MLM head (tied to the word embeddings) and NSP head. Each layer's
weights are stacked on a leading dim when ``cfg.scan_layers`` (the
default), else held as a list of per-layer dicts, as the reference
holds them; the layers are a Python loop either way.

Attention is :func:`mxtpu_torch.ops.attention.dense_attention` with the
padding mask, as the reference's is its ``dense_attention``: plain
PyTorch, no hand kernel (the reference reaches no Pallas here). GELU is
the tanh approximation, as ``jax.nn.gelu(approximate=True)`` is.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..context import DeviceLike, resolve_device
from ..ops.attention import dense_attention
from ..parallel.collectives import PartialOver, shard_map
from ..parallel.mesh import Mesh
from ..parallel.sharding import P, ShardingRules, spmd
from ._numpy_tree import params_from_numpy, params_to_numpy

__all__ = ["BertConfig", "CONFIGS", "init_params", "forward", "mlm_logits",
           "loss_fn", "sharding_rules", "params_from_numpy",
           "params_to_numpy", "Bert"]


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS: Dict[str, BertConfig] = {
    "tiny": BertConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                       hidden_dim=128, max_seq_len=64, remat=False),
    "bert_base": BertConfig(),
    "bert_large": BertConfig(dim=1024, n_layers=24, n_heads=16,
                             hidden_dim=4096),
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _tn(shape, gen, device, dtype):
    """BERT's truncated normal: std 0.02, clipped at ±2σ."""
    w = torch.empty(shape, dtype=dtype, device=device)
    return nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                 generator=gen).mul_(0.02)


def _init_layer(cfg: BertConfig, gen, device):
    d, h, dt = cfg.dim, cfg.hidden_dim, cfg.param_dtype

    def init(shape):
        return _tn(shape, gen, device, dt)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    return {
        "qkv_w": init((d, 3 * d)), "qkv_b": zeros(3 * d),
        "attn_out_w": init((d, d)), "attn_out_b": zeros(d),
        "ln1_g": ones(d), "ln1_b": zeros(d),
        "ffn_in_w": init((d, h)), "ffn_in_b": zeros(h),
        "ffn_out_w": init((h, d)), "ffn_out_b": zeros(d),
        "ln2_g": ones(d), "ln2_b": zeros(d),
    }


def init_params(cfg: BertConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    """Random parameters in ``mxtpu``'s tree layout. ``generator`` must
    live on ``device``; by default one seeded with 0 is made there. The
    draws differ from ``jax.random``'s: to hold the two packages on the
    same weights, carry a tree with :func:`params_from_numpy`."""
    device = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)
    d, dt = cfg.dim, cfg.param_dtype
    layers = [_init_layer(cfg, gen, device) for _ in range(cfg.n_layers)]
    if cfg.scan_layers:
        layers = {k: torch.stack([lp[k] for lp in layers])
                  for k in layers[0]}

    def tn(shape):
        return _tn(shape, gen, device, dt)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    return {
        "tok_emb": tn((cfg.vocab_size, d)),
        "pos_emb": tn((cfg.max_seq_len, d)),
        "type_emb": tn((cfg.type_vocab_size, d)),
        "emb_ln_g": torch.ones((d,), dtype=dt, device=device),
        "emb_ln_b": zeros(d),
        "layers": layers,
        "pool_w": tn((d, d)), "pool_b": zeros(d),
        "mlm_w": tn((d, d)), "mlm_b": zeros(d),
        "mlm_ln_g": torch.ones((d,), dtype=dt, device=device),
        "mlm_ln_b": zeros(d),
        "mlm_bias": zeros(cfg.vocab_size),
        "nsp_w": tn((d, 2)), "nsp_b": zeros(2),
    }


def sharding_rules(cfg: Optional[BertConfig] = None) -> ShardingRules:
    """``mxtpu``'s placement: tp over attention heads and the FFN inner
    dim, fsdp over the first axis of the big tables (llama's recipe).
    With ``scan_layers`` (the default) the per-layer params carry a
    leading layer dim, never sharded."""
    scan = cfg.scan_layers if cfg is not None else True
    return ShardingRules([
        (r".*tok_emb", P("fsdp", "tp")),
        (r".*pos_emb", P(None, "tp")),
        (r".*qkv_w", P(None, "fsdp", "tp") if scan else P("fsdp", "tp")),
        (r".*attn_out_w", P(None, "tp", "fsdp") if scan
         else P("tp", "fsdp")),
        (r".*ffn_in_w", P(None, "fsdp", "tp") if scan
         else P("fsdp", "tp")),
        (r".*ffn_out_w", P(None, "tp", "fsdp") if scan
         else P("tp", "fsdp")),
        (r".*mlm_w", P("fsdp", "tp")),
        (r".*", P()),
    ])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _layer_norm(x, g, b, eps):
    """f32 LayerNorm over the last dim (population variance, rsqrt),
    cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, correction=0, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * g.float() + b.float()).to(x.dtype)


def _encoder_layer(cfg: BertConfig, x, mask, lp):
    """One post-LN block. x: (B, S, D) in cfg.dtype; mask (B, S), > 0
    where a key may be attended."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    dt = cfg.dtype
    qkv = x @ lp["qkv_w"].to(dt) + lp["qkv_b"].to(dt)
    q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    # fully masked rows give zeros, not uniform attention
    ctx = dense_attention(q, k, v, mask=mask[:, None, None, :] > 0).to(dt)
    ctx = ctx.transpose(1, 2).reshape(B, S, D)
    ctx = ctx @ lp["attn_out_w"].to(dt) + lp["attn_out_b"].to(dt)
    x = _layer_norm(x + ctx, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
    h = F.gelu(x @ lp["ffn_in_w"].to(dt) + lp["ffn_in_b"].to(dt),
               approximate="tanh")
    h = h @ lp["ffn_out_w"].to(dt) + lp["ffn_out_b"].to(dt)
    return _layer_norm(x + h, lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)


def _layers(cfg: BertConfig, params):
    """The per-layer dicts, from the stacked or the listed layout."""
    layers = params["layers"]
    if isinstance(layers, dict):
        stacked = {k: v.unbind(0) for k, v in layers.items()}
        return [{k: v[i] for k, v in stacked.items()}
                for i in range(cfg.n_layers)]
    return list(layers)


def forward(cfg: BertConfig, params, tokens, token_types=None, mask=None):
    """tokens (B, S) int → (sequence_output (B, S, D) f32, pooled_output
    (B, D) f32). ``mask`` (B, S): > 0 where a token may be attended
    (default all); ``token_types`` default 0. Under grad with
    ``cfg.remat`` each layer is recomputed in the backward."""
    B, S = tokens.shape
    if S > cfg.max_seq_len:
        raise ValueError(
            f"sequence length {S} exceeds max_seq_len {cfg.max_seq_len}")
    dt = cfg.dtype
    dev = tokens.device
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=dev)
    if token_types is None:
        token_types = torch.zeros((B, S), dtype=torch.int64, device=dev)
    x = params["tok_emb"][tokens.long()].to(dt) + \
        params["pos_emb"][None, :S].to(dt) + \
        params["type_emb"][token_types.long()].to(dt)
    x = _layer_norm(x, params["emb_ln_g"], params["emb_ln_b"], cfg.norm_eps)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _layers(cfg, params):
        if remat:
            x = checkpoint(_encoder_layer, cfg, x, mask, lp,
                           use_reentrant=False)
        else:
            x = _encoder_layer(cfg, x, mask, lp)
    seq_out = x.float()
    pooled = torch.tanh(seq_out[:, 0] @ params["pool_w"].float()
                        + params["pool_b"].float())
    return seq_out, pooled


def mlm_logits(cfg: BertConfig, params, seq_out):
    """Masked-LM head: transform + tied-embedding decode, in f32."""
    h = F.gelu(seq_out @ params["mlm_w"].float() + params["mlm_b"].float(),
               approximate="tanh")
    h = _layer_norm(h, params["mlm_ln_g"], params["mlm_ln_b"], cfg.norm_eps)
    return h @ params["tok_emb"].float().T + params["mlm_bias"].float()


def _loss_sums(cfg: BertConfig, params, batch):
    """(Σ w·nll over the MLM positions, Σ w, Σ the NSP label log-probs
    (0 without labels), the batch rows) of one batch."""
    seq_out, pooled = forward(cfg, params, batch["tokens"],
                              batch.get("token_types"), batch["mask"])
    pos = batch["mlm_positions"].long()                      # (B, P)
    gathered = seq_out.gather(
        1, pos[..., None].expand(-1, -1, seq_out.shape[-1]))
    logp = torch.log_softmax(mlm_logits(cfg, params, gathered), dim=-1)
    lab = batch["mlm_labels"].long()
    nll = -logp.gather(-1, lab[..., None])[..., 0]
    w = batch["mlm_weights"].float()
    nsp_sum = torch.zeros((), dtype=torch.float32, device=w.device)
    if "nsp_labels" in batch:
        nsp = pooled @ params["nsp_w"].float() + params["nsp_b"].float()
        nsp_logp = torch.log_softmax(nsp, dim=-1)
        nsp_lab = batch["nsp_labels"].long()
        nsp_sum = nsp_logp.gather(-1, nsp_lab[:, None]).sum()
    rows = torch.full((), float(pos.shape[0]), device=w.device)
    return (nll * w).sum(), w.sum(), nsp_sum, rows


def loss_fn(cfg: BertConfig, mesh=None):
    """Pretraining loss over batches {'tokens', 'mask', 'mlm_positions',
    'mlm_labels', 'mlm_weights'[, 'token_types', 'nsp_labels']}: the
    weighted MLM cross-entropy, plus NSP's when labels are present.

    On a mesh of a process group (``make_train_step(..., mesh)`` lays
    the params out by :func:`sharding_rules` and the batch rows over
    dp/fsdp) each rank runs its batch rows on the weights gathered whole
    (fsdp's gather; their gradients are reduce-scattered back), and the
    four sums are added over the batch axes before the two means."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (create_mesh), "
                        f"not {type(mesh).__name__}")
    batch_axes = ("dp", "fsdp")
    sums = partial(_loss_sums, cfg)
    if mesh is not None and mesh.distributed:
        sums = shard_map(sums, mesh, (P(), P(batch_axes)),
                         (PartialOver(batch_axes),) * 4,
                         grad_partial=(batch_axes, ()))

    def loss(params, batch):
        with spmd(mesh):
            num, den, nsp_sum, rows = sums(params, batch)
            total = num / den.clamp_min(1.0)
            if "nsp_labels" in batch:
                total = total - nsp_sum / rows
            return total
    return loss


# ---------------------------------------------------------------------------
# nn.Module façade
# ---------------------------------------------------------------------------
class Bert(nn.Module):
    """The parameters of one BERT under ``mxtpu``'s names and shapes,
    with :meth:`forward` and :meth:`loss` over the functions of this
    module. The per-layer weights are ``layers`` (a ``ParameterDict`` of
    stacked tensors when ``cfg.scan_layers``, else a ``ModuleList`` of
    ``ParameterDict``s). The parameters require grad."""

    def __init__(self, cfg: BertConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        tree = init_params(cfg, generator, device)
        for k, v in tree.items():
            if k != "layers":
                setattr(self, k, nn.Parameter(v))
        layers = tree["layers"]
        if isinstance(layers, dict):
            self.layers = nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in layers.items()})
        else:
            self.layers = nn.ModuleList(nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in lp.items()})
                for lp in layers)

    def tree(self):
        """The parameters as ``mxtpu``'s tree (no copy)."""
        out = {k: p for k, p in self.named_parameters(recurse=False)}
        if isinstance(self.layers, nn.ParameterDict):
            out["layers"] = dict(self.layers.items())
        else:
            out["layers"] = [dict(lp.items()) for lp in self.layers]
        return out

    @torch.no_grad()
    def load_numpy_tree(self, tree):
        """Copy a numpy tree (``mxtpu``'s keys and shapes) into the
        parameters, cast to their dtype and device."""
        def walk(own, new):
            if isinstance(own, dict):
                for k, v in own.items():
                    walk(v, new[k])
            elif isinstance(own, list):
                for o, n in zip(own, new, strict=True):
                    walk(o, n)
            else:
                if tuple(own.shape) != tuple(np.shape(new)):
                    raise ValueError(f"shape {np.shape(new)} does not match "
                                     f"the parameter's {tuple(own.shape)}")
                own.copy_(torch.tensor(np.asarray(new)))
        walk(self.tree(), tree)

    def forward(self, tokens, token_types=None, mask=None):
        return forward(self.cfg, self.tree(), tokens, token_types, mask)

    def loss(self, batch):
        """The pretraining loss of :func:`loss_fn` on ``batch``."""
        return loss_fn(self.cfg)(self.tree(), batch)
