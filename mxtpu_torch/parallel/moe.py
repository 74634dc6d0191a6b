"""Mixture-of-Experts: the port of ``mxtpu/parallel/moe.py``, on one
device or with the expert banks sharded over a mesh's ``ep`` axis.

Token-choice top-k gating over a bank of SwiGLU experts, GShard's
capacity-factored dispatch (a gather and scatter-add, or the one-hot
einsums), the exact dropless mixture the serving paths run, and the
Switch load-balancing term. Everything is plain PyTorch: the reference
is plain ``jnp`` and reaches no Pallas kernel, and the large products
here are ``torch.matmul``/``bmm``/``einsum``.

Numerics follow ``mxtpu``: the router's logits are computed in
``x.dtype`` and upcast, the softmax, gates and aux are f32, and the
experts run in ``x.dtype``. Top-k keeps the lower index among equal
probabilities, as ``lax.top_k`` does (``torch.topk`` does not:
bf16 router logits tie often).

Over a mesh of a process group (``mesh=``), the layer runs on each
rank's expert block (:func:`~mxtpu_torch.parallel.collectives.shard_map`):
the banks are laid out ``P("ep")`` (any fsdp/tp layout is gathered),
the tokens are replicated, every rank routes all of them (the capacity
positions are the global ones, as the reference's), dispatches to and
runs its E/ep experts, and combines their share of each token; the
shares are summed over ``ep`` (a partial value the caller's next
re-layout reduces). The router's cotangent is the sum of the ranks'
parts; the load-balancing aux is counted on ``ep`` rank 0 only.
``"auto"`` picks the einsum dispatch when ``ep`` > 1, as the reference
does. For ``top_k <= 2`` the sharded sums equal the unsharded ones.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..context import DeviceLike, resolve_device
from .collectives import PartialOver, axis_index, shard_map
from .mesh import Mesh, axis_size
from .sharding import P

__all__ = ["init_moe_params", "moe_ffn", "moe_ffn_dense",
           "load_balance_loss", "routed_block"]


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (create_mesh), "
                        f"not {type(mesh).__name__}")


_BANK = {"gate": P(), "w_gate": P("ep"), "w_up": P("ep"), "w_down": P("ep")}


def _on_experts(fn, mesh, params, x):
    """``fn(params, x, e0)`` on each rank's expert block (e0: its first
    expert) with replicated tokens; returns (out, aux) summed over
    ``ep``. On no mesh, or the one-device placement, ``fn`` runs whole
    with e0 = 0."""
    if mesh is None or not mesh.distributed:
        return fn(params, x, 0)
    ep = axis_size("ep", mesh)

    def local(p, xl):
        idx = axis_index("ep", mesh)
        out, aux = fn(p, xl, idx * p["w_gate"].shape[0])
        # the aux is the same on every rank: count it once
        return out, aux * (1.0 if idx == 0 else 0.0)

    bank = {k: _BANK[k] for k in params}
    return shard_map(local, mesh, in_specs=(bank, P()),
                     out_specs=(PartialOver(("ep",)), PartialOver(("ep",))),
                     grad_partial=(("ep",), ("ep",)) if ep > 1 else ()
                     )(params, x)


def init_moe_params(dim: int, hidden: int, n_experts: int,
                    generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None, dtype=torch.float32):
    """Gate + SwiGLU expert bank with ``mxtpu``'s shapes and fan-in
    scales: gate (d, E); w_gate/w_up (E, d, h); w_down (E, h, d).
    ``generator`` must live on ``device``; by default one seeded with 0
    is made there. The draws differ from ``jax.random``'s."""
    device = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)

    def init(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w.div_(math.sqrt(fan_in))

    return {
        "gate": init((dim, n_experts), dim),
        "w_gate": init((n_experts, dim, hidden), dim),
        "w_up": init((n_experts, dim, hidden), dim),
        "w_down": init((n_experts, hidden, dim), hidden),
    }


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row. A
    comparison, so it reads nothing back to the host (capturable)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last dim, the lower
    index first among equal values, as ``lax.top_k`` orders them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(params, x, K: int):
    """Router: f32 probs (T, E) of logits computed in ``x.dtype``, the
    top-K experts (T, K) and their renormalised f32 gates (T, K)."""
    logits = (x @ params["gate"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = _top_k(probs, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, idx, gate_vals


def _route(params, x, K: int, C: int):
    """Shared router: top-k gating + GShard's k-major capacity-slot
    positions (per choice k, a cumsum of the one-hot minus the one-hot,
    plus the running counts of the earlier choices). Returns (probs,
    idx (T, K), gate_vals (T, K), pos (T, K) slot position per choice,
    keep (T, K))."""
    probs, idx, gate_vals = _gates(params, x, K)
    E = probs.shape[-1]
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device)
    poss, keeps = [], []
    for k in range(K):
        onehot = _one_hot(idx[:, k], E, torch.int64)
        pos = torch.cumsum(onehot, dim=0) - onehot + counts[None]
        pos_t = pos.gather(1, idx[:, k, None])[:, 0]            # (T,)
        poss.append(pos_t)
        keeps.append(pos_t < C)
        counts = counts + onehot.sum(0)
    return probs, idx, gate_vals, torch.stack(poss, 1), torch.stack(keeps, 1)


def _experts(params, xin):
    """SwiGLU expert bank over (E, C, d) dispatched activations, in
    ``xin.dtype``: three batched products (``bmm``)."""
    dt = xin.dtype
    h = F.silu(torch.bmm(xin, params["w_gate"].to(dt))) * \
        torch.bmm(xin, params["w_up"].to(dt))
    return torch.bmm(h, params["w_down"].to(dt))


def moe_ffn(params, x, *, top_k: int = 2, capacity_factor: float = 1.25,
            mesh=None, no_drop: bool = False, dispatch: str = "auto"):
    """Token-choice top-k MoE over SwiGLU experts.

    ``x``: (T, d) tokens (flatten batch×seq first). Returns ``(out (T,
    d), aux)``, ``aux`` the Switch load-balancing term (f32, ≈ 1 at
    uniform routing; add ``moe_aux_weight * aux`` to the loss).

    Tokens beyond an expert's capacity ``C = ceil(T·K/E · cf)`` are
    dropped: their expert contribution is zero and the residual stream
    carries them. ``no_drop`` sets C = T (exact, but the einsum
    dispatch's (T, E, C) tensors grow as T²); serving runs
    :func:`moe_ffn_dense` instead.

    ``dispatch``: ``"gather"`` fills (E, C + 1) slot tables (a trash
    column for dropped choices, a zero pad row for empty slots) with
    ``index_put``, gathers the tokens and combines with ``index_add``
    in ``x.dtype``; ``"einsum"`` is GShard's one-hot dispatch and
    combine. ``"auto"`` picks einsum when the mesh's ``ep`` axis is
    above 1, else gather. Each live token gets at most ``top_k`` contributions added
    onto zero, so for ``top_k <= 2`` the sum is the same in any order,
    atomics included; for ``top_k >= 3`` the order matters: on the CPU
    ``index_add`` adds in slot order (expert-major), sequentially as
    XLA's CPU scatter does, while the card's atomics add in any order."""
    _check_mesh(mesh)
    if dispatch not in ("auto", "gather", "einsum"):
        raise ValueError(
            f"dispatch={dispatch!r}: use 'auto', 'gather' or 'einsum'")
    ep = axis_size("ep", mesh)
    return _on_experts(
        lambda p, xl, e0: routed_block(p, xl, e0, top_k, capacity_factor,
                                       dispatch, ep, no_drop), mesh,
        params, x)


def routed_block(params, x, e0: int, top_k: int, capacity_factor: float,
                 dispatch: str, ep: int, no_drop: bool = False):
    """:func:`moe_ffn` on local tensors: every token of ``x`` routed over
    all E experts, the capacity C of the whole ``x``, and the
    contributions of the bank's experts [e0, e0 + its E) (the bank is
    one ``ep`` rank's block of an ``ep``-way split). Returns (out, aux)."""
    T, d = x.shape
    E = params["gate"].shape[-1]
    C = T if no_drop else max(
        1, int(math.ceil(T * top_k / E * capacity_factor)))
    if dispatch == "auto":
        dispatch = "einsum" if ep > 1 else "gather"
    return _moe_block(params, x, e0, top_k, C, dispatch)


def _moe_block(params, x, e0: int, K: int, C: int, dispatch: str):
    """The routed layer over experts [e0, e0 + the bank's E): every
    token is routed over all E, and the bank's experts contribute."""
    T, d = x.shape
    dt = x.dtype
    El = params["w_gate"].shape[0]
    probs, idx, gate_vals, pos, keep = _route(params, x, K, C)
    E = probs.shape[-1]

    if dispatch == "gather":
        slot_tok = torch.full((E, C + 1), T, dtype=torch.int64,
                              device=x.device)
        slot_gate = torch.zeros((E, C + 1), dtype=torch.float32,
                                device=x.device)
        tids = torch.arange(T, device=x.device)
        for k in range(K):
            pc = torch.where(keep[:, k], pos[:, k], C)    # C = trash col
            slot_tok = slot_tok.index_put((idx[:, k], pc), tids)
            slot_gate = slot_gate.index_put((idx[:, k], pc), gate_vals[:, k])
        slot_tok = slot_tok[e0:e0 + El, :C]
        slot_gate = slot_gate[e0:e0 + El, :C]
        xpad = torch.cat([x, x.new_zeros((1, d))], dim=0)
        eout = _experts(params, xpad[slot_tok])              # (E, C, d)
        out = x.new_zeros((T + 1, d)).index_add(
            0, slot_tok.reshape(-1),
            (eout * slot_gate[..., None].to(dt)).reshape(-1, d))[:T]
    else:
        dmask = torch.zeros((T, E, C), dtype=torch.float32, device=x.device)
        combine = torch.zeros_like(dmask)
        for k in range(K):
            onehot = _one_hot(idx[:, k], E, torch.float32)
            slot = _one_hot(torch.where(keep[:, k], pos[:, k], C), C,
                            torch.float32)
            contrib = onehot[:, :, None] * slot[:, None, :]
            dmask = dmask + contrib
            combine = combine + contrib * gate_vals[:, k][:, None, None]
        dmask, combine = dmask[:, e0:e0 + El], combine[:, e0:e0 + El]
        xin = torch.einsum("tec,td->ecd", dmask.to(dt), x)
        eout = _experts(params, xin)
        out = torch.einsum("tec,ecd->td", combine.to(dt), eout)

    aux = load_balance_loss(probs, idx[:, 0])
    return out, aux


def moe_ffn_dense(params, x, *, top_k: int = 2, mesh=None):
    """EXACT dropless MoE, the serving path: every token runs through
    every expert, and the top-k renormalised gates, scattered into (T,
    E), combine them. Routing is a pure per-token function, so no batch
    composition changes a token's result; work is linear in T at E/K×
    the routed path's. Static shapes and no host reads, so the engine's
    captured decode, paged and verify steps run it inside their CUDA
    graphs. Returns (out, aux) like :func:`moe_ffn`; over a mesh, each
    rank runs its ``ep`` block of experts."""
    _check_mesh(mesh)
    return _on_experts(lambda p, xl, e0: _dense_block(p, xl, e0, top_k),
                       mesh, params, x)


def _dense_block(params, x, e0: int, top_k: int):
    dt = x.dtype
    probs, idx, gate_vals = _gates(params, x, top_k)
    El = params["w_gate"].shape[0]
    w = torch.zeros_like(probs).scatter(1, idx, gate_vals)[:, e0:e0 + El]
    # x broadcast over the experts' batch dim: each product reads its
    # (E, ., .) weight in place (an einsum to (T, E, h) would first copy
    # every expert's weight into another layout)
    h = F.silu(torch.matmul(x, params["w_gate"].to(dt))) * \
        torch.matmul(x, params["w_up"].to(dt))                  # (E, T, h)
    eout = torch.bmm(h, params["w_down"].to(dt))                # (E, T, d)
    out = torch.einsum("etd,te->td", eout, w.to(dt))
    return out, load_balance_loss(probs, idx[:, 0])


def load_balance_loss(probs, first_choice):
    """Switch-Transformer load-balancing term: E · Σ_e f_e · p̄_e, where
    f_e is the fraction of tokens whose FIRST choice is e and p̄_e the
    mean router probability for e. Equals 1 at uniform routing;
    differentiable through p̄."""
    E = probs.shape[-1]
    f = _one_hot(first_choice, E, torch.float32).mean(0)
    return E * (f * probs.mean(0)).sum()
