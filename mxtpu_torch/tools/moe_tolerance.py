"""Support for the bounds that ``chip_smoke.py`` puts on the Mixtral and
BERT phases, measured on the CPU.

    python -m mxtpu_torch.tools.moe_tolerance [--layers 2 4 8]

A narrow Mixtral (``CONFIGS["mixtral_8x7b"]`` with dim 512, 4 query
heads over 1 KV head, so head dim 128 and GQA 4:1 as published, hidden
1792, vocab 4000; 8 experts, top-2; bf16 params and compute, seeded
random weights) and a narrow BERT (``CONFIGS["bert_base"]`` with dim
256, 4 heads of 64 as published, hidden 1024; f32 params, bf16
compute) at a few depths. For each depth it prints the relative
distance ``||a - b|| / ||b||``:

- ``flash_vs_dense``: Mixtral ``forward`` logits at (1, 512) with
  ``attn_impl="flash"`` (on the CPU the plain blockwise version, so only
  a proxy for the kernel's roundings) against ``"dense"``, at capacity
  E/K (C = T, nothing dropped), as phase 14(a) compares them;
- ``routed_vs_mixture``: the routed ``forward_hidden`` (``moe_ffn`` at
  C = T) against the same model through the serving mixture
  (``moe_ffn_dense``); planted faults in the routed path: expert 0's
  output lost (``lost_expert``), the top-k gates not renormalised
  (``unrenormalised``), and ``torch.topk``'s tie order in place of
  ``lax.top_k``'s (``topk_ties``, with the count of routing choices it
  changes);
- ``dropped``: the tokens the routed path drops at capacity 1.25, by
  layer (what phase 14(a) prints);
- ``chunked``: Mixtral's ``chunked_prefill`` of (1, 500) in chunks of
  128 against the one-shot prefill's last logits, as phase 14(b)
  compares (1, 4000) in chunks of 1024;
- ``train``: at one layer, Mixtral's loss and the grads of
  ``layers.moe_gate``, ``layers.w_gate`` and ``tok_embed`` with
  ``attn_impl="flash"`` against ``"dense"`` (f32 params, bf16 compute,
  remat) for three seeds, at capacity E/K (nothing dropped), as phase
  14(d) compares them, and at 1.25, where a flipped route also moves
  the slots, and so the drops, of later tokens;
- ``bert_bf16_vs_f32``: BERT's ``seq_out`` at (8, 128) with the last 32
  positions of half the rows masked, bf16 compute against f32 compute
  on the same weights, as phase 15(a) compares them; planted faults in
  the bf16 run: erf GELU in place of the tanh approximation
  (``erf_gelu``), the padding mask ignored (``mask_dropped``) and the
  position embeddings lost (``pos_dropped``).

The bounds in ``chip_smoke.py`` sit between the depth trend of the
clean distances and the faults' (a fault below the bound is one the
card's check cannot see: the CPU parity tests hold it instead).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
from dataclasses import replace
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from ..models import bert, llama
from ..parallel import moe

SEQ, BERT_BATCH, BERT_SEQ, BERT_PAD = 512, 8, 128, 32
CHUNK_PROMPT, CHUNK = 500, 128


def narrow_mixtral(n_layers: int) -> llama.LlamaConfig:
    return replace(llama.CONFIGS["mixtral_8x7b"], dim=512, n_heads=4,
                   n_kv_heads=1, hidden_dim=1792, vocab_size=4000,
                   n_layers=n_layers, param_dtype=torch.bfloat16)


def narrow_bert(n_layers: int) -> bert.BertConfig:
    return replace(bert.CONFIGS["bert_base"], dim=256, n_heads=4,
                   hidden_dim=1024, n_layers=n_layers)


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def token_rel(a, b):
    """Per-token relative distances (rows of the last dim): their 50th,
    90th and 99th percentiles and the largest. A token whose route
    flipped at a near-tie of its router takes other experts, so the
    global distance follows the few flipped tokens; the median follows
    the rest."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    d = (a - b).norm(dim=-1) / b.norm(dim=-1)
    q = torch.quantile(d, torch.tensor([0.5, 0.9, 0.99], device=d.device))
    return {"p50": q[0].item(), "p90": q[1].item(), "p99": q[2].item(),
            "max": d.max().item()}


@contextlib.contextmanager
def patched(module, **attrs):
    """Set ``module``'s attributes for the block, then restore them."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _mixture(p, x, *, top_k, capacity_factor):
    return moe.moe_ffn_dense(p, x, top_k=top_k)


def _unrenormalised_gates(params, x, K):
    probs = torch.softmax((x @ params["gate"].to(x.dtype)).float(), dim=-1)
    gate_vals, idx = moe._top_k(probs, K)
    return probs, idx, gate_vals


def _topk(probs, k):
    return torch.topk(probs, k, dim=-1)


def routed_fault(fault):
    """``llama.moe_ffn``'s stand-in with ``fault`` planted in the routed
    path only (None: the clean routed path)."""
    def routed(p, x, *, top_k, capacity_factor):
        if fault == "lost_expert":
            p = dict(p, w_down=p["w_down"].clone().index_fill_(
                0, torch.tensor([0]), 0.0))
        swaps = {"unrenormalised": {"_gates": _unrenormalised_gates},
                 "topk_ties": {"_top_k": _topk}}.get(fault, {})
        with patched(moe, **swaps):
            return moe.moe_ffn(p, x, top_k=top_k,
                               capacity_factor=capacity_factor)
    return routed


def topk_tie_changes(cfg, params, tokens) -> int:
    """Routing choices (token, k) where ``torch.topk`` picks another
    expert than the stable sort, over every layer's router input."""
    changed = [0]

    def count(p, x, *, top_k, capacity_factor):
        probs = torch.softmax((x @ p["gate"].to(x.dtype)).float(), dim=-1)
        a = moe._top_k(probs, top_k)[1]
        b = torch.topk(probs, top_k, dim=-1)[1]
        changed[0] += int((a != b).sum())
        return moe.moe_ffn(p, x, top_k=top_k,
                           capacity_factor=capacity_factor)
    with patched(llama, moe_ffn=count):
        llama.forward_hidden(cfg, params, tokens)
    return changed[0]


def dropped_by_layer(cfg, params, tokens):
    drops = []

    def count(p, x, *, top_k, capacity_factor):
        T, E = x.shape[0], p["gate"].shape[-1]
        C = max(1, int(math.ceil(T * top_k / E * capacity_factor)))
        drops.append(int((~moe._route(p, x, top_k, C)[4]).sum()))
        return moe.moe_ffn(p, x, top_k=top_k,
                           capacity_factor=capacity_factor)
    with patched(llama, moe_ffn=count):
        llama.forward_hidden(cfg, params, tokens)
    return drops


def recording_routes(ffn, routes):
    """``ffn`` (a stand-in of ``llama.moe_ffn``) that first appends each
    call's chosen experts, as a sorted (T, K) set, to ``routes``."""
    def rec(p, x, *, top_k, capacity_factor):
        probs = torch.softmax((x @ p["gate"].to(x.dtype)).float(), dim=-1)
        routes.append(moe._top_k(probs, top_k)[1].sort(-1).values)
        return ffn(p, x, top_k=top_k, capacity_factor=capacity_factor)
    return rec


def routes_changed(a, b):
    """Tokens whose expert set differs, layer by layer."""
    return [int((x != y).any(-1).sum()) for x, y in zip(a, b)]


def mixtral_rows(n_layers, seed):
    cfg = narrow_mixtral(n_layers)
    gen = torch.Generator().manual_seed(seed)
    params = llama.init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen)
    nodrop = replace(cfg, moe_capacity=cfg.moe_experts / cfg.moe_top_k)
    routes = {"flash": [], "dense": [], "mixture": []}
    with patched(llama, moe_ffn=recording_routes(moe.moe_ffn,
                                                 routes["flash"])):
        flash = llama.forward(nodrop, params, tokens)
    with patched(llama, moe_ffn=recording_routes(moe.moe_ffn,
                                                 routes["dense"])):
        dense = llama.forward(replace(nodrop, attn_impl="dense"), params,
                              tokens)
    yield {"check": "flash_vs_dense", "rel": rel(flash, dense),
           "token_rel": token_rel(flash, dense),
           "routes_changed": routes_changed(routes["flash"],
                                            routes["dense"])}
    with patched(llama, moe_ffn=recording_routes(_mixture,
                                                 routes["mixture"])):
        mixture = llama.forward_hidden(nodrop, params, tokens)
    for fault in (None, "lost_expert", "unrenormalised", "topk_ties"):
        with patched(llama, moe_ffn=routed_fault(fault)):
            routed = llama.forward_hidden(nodrop, params, tokens)
        row = {"check": "routed_vs_mixture", "fault": fault,
               "rel": rel(routed, mixture),
               "token_rel": token_rel(routed, mixture)}
        if fault == "topk_ties":
            row["choices_changed"] = topk_tie_changes(nodrop, params, tokens)
        yield row
    yield {"check": "dropped", "capacity": cfg.moe_capacity,
           "tokens": SEQ, "by_layer": dropped_by_layer(cfg, params, tokens)}
    prompt = tokens[:, :CHUNK_PROMPT]
    want, _ = llama.prefill(cfg, params, prompt, llama.init_cache(
        cfg, 1, CHUNK_PROMPT, device="cpu"), last_only=True)
    got, _ = llama.chunked_prefill(cfg, params, prompt, llama.init_cache(
        cfg, 1, CHUNK_PROMPT, device="cpu"), CHUNK)
    yield {"check": "chunked", "rel": rel(got, want),
           "argmax_equal": bool(torch.equal(got.argmax(-1),
                                            want.argmax(-1)))}


def train_row(seed, capacity):
    """Flash against dense loss and grads at one layer (phase 14(d))."""
    cfg = replace(narrow_mixtral(1), param_dtype=torch.float32,
                  moe_capacity=capacity)
    gen = torch.Generator().manual_seed(seed)
    params = llama.init_params(cfg, gen, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, SEQ),
                                     generator=gen)}
    picked = {"loss": None, "layers.moe_gate": ("layers", "moe_gate"),
              "layers.w_gate": ("layers", "w_gate"),
              "tok_embed": ("tok_embed",)}
    found = {}
    for impl in ("flash", "dense"):
        live = {k: ({lk: lv.detach().requires_grad_()
                     for lk, lv in v.items()} if k == "layers"
                    else v.detach().requires_grad_())
                for k, v in params.items()}
        with torch.enable_grad():
            loss = llama.loss_fn(replace(cfg, attn_impl=impl))(live, batch)
            leaves = [live[p[0]] if len(p) == 1 else live[p[0]][p[1]]
                      for p in list(picked.values())[1:]]
            found[impl] = [loss.detach()] + list(
                torch.autograd.grad(loss, leaves))
    return {"check": "train", "layers": 1, "seed": seed,
            "capacity": capacity, "rel": {
        name: rel(a, b) for name, a, b in zip(picked, found["flash"],
                                               found["dense"])}}


def bert_batch(cfg, gen):
    tokens = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen)
    mask = torch.ones((BERT_BATCH, BERT_SEQ))
    mask[::2, -BERT_PAD:] = 0.0
    return tokens, mask


def bert_rows(n_layers, seed):
    cfg = narrow_bert(n_layers)
    gen = torch.Generator().manual_seed(seed)
    params = bert.init_params(cfg, gen, device="cpu")
    tokens, mask = bert_batch(cfg, gen)
    want, _ = bert.forward(replace(cfg, dtype=torch.float32), params, tokens,
                           mask=mask)
    erf = SimpleNamespace(gelu=lambda x, approximate: F.gelu(x))
    no_pos = dict(params, pos_emb=torch.zeros_like(params["pos_emb"]))
    for fault in (None, "erf_gelu", "mask_dropped", "pos_dropped"):
        patch = {"F": erf} if fault == "erf_gelu" else {}
        with patched(bert, **patch):
            got, _ = bert.forward(cfg, no_pos if fault == "pos_dropped"
                                  else params, tokens,
                                  mask=None if fault == "mask_dropped"
                                  else mask)
        yield {"check": "bert_bf16_vs_f32", "fault": fault,
               "rel": rel(got, want), "token_rel": token_rel(got, want)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with torch.no_grad():
        for n_layers in args.layers:
            for rows in (mixtral_rows, bert_rows):
                for row in rows(n_layers, args.seed):
                    print(json.dumps({"layers": n_layers, **row}),
                          flush=True)
        for seed in range(args.seed, args.seed + 3):
            for capacity in (4.0, 1.25):
                print(json.dumps(train_row(seed, capacity)), flush=True)


if __name__ == "__main__":
    main()
