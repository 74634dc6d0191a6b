"""Support for the bounds that ``chip_smoke.py`` puts on the serving
paths, measured on the CPU.

    python -m mxtpu_torch.tools.serve_tolerance [--layers 2 4 8]

A narrow llama3_8b (head dim 128 and GQA 4:1 as Meta's, dim 512,
hidden 1792, vocab 20000; bf16 params and compute, seeded random
weights) at a few depths. For each depth it prints the relative
distance ``||a - b|| / ||b||`` of last-position logits:

- ``chunked``: ``chunked_prefill`` in chunks of 128 (a (1, 600) prompt:
  four chunks and a remainder of 88) against ``prefill(last_only=True)``
  on the same cache size, as ``chunked_prefill`` checks at (1, 6000) in
  chunks of 1024; planted faults: each chunk on an empty cache
  (``fresh_cache``, the past lost) and the remainder dropped
  (``no_remainder``);
- ``int8``: ``prefill`` off ``quantize_params_int8``'s tree against the
  bf16 tree's, at 4 prompts of 128 as ``generate_int8`` checks; planted
  faults: the scales dropped (``no_scale``) and each layer read with its
  neighbour's scales (``stale_scale``).

The bounds in ``chip_smoke.py`` sit between the depth trend of the
clean distances and the faults'.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import replace

import torch

from ..models import llama

CHUNK, PROMPT = 128, 600


def narrow_cfg(n_layers: int) -> llama.LlamaConfig:
    return replace(llama.CONFIGS["llama3_8b"], dim=512, n_heads=4,
                   n_kv_heads=1, hidden_dim=1792, vocab_size=20000,
                   n_layers=n_layers, param_dtype=torch.bfloat16)


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def chunked_dist(cfg, params, prompt, fault=None) -> float:
    b, s = prompt.shape
    want, _ = llama.prefill(cfg, params, prompt,
                            llama.init_cache(cfg, b, s, device="cpu"),
                            last_only=True)
    if fault is None:
        got, _ = llama.chunked_prefill(
            cfg, params, prompt, llama.init_cache(cfg, b, s, device="cpu"),
            CHUNK)
    elif fault == "fresh_cache":      # every chunk forgets the ones before
        for i in range(0, s, CHUNK):
            cache = llama.init_cache(cfg, b, s, device="cpu")
            cache["pos"] = i
            got, _ = llama.prefill(cfg, params, prompt[:, i:i + CHUNK],
                                   cache, last_only=True)
    elif fault == "no_remainder":
        n = s // CHUNK * CHUNK
        got, _ = llama.chunked_prefill(
            cfg, params, prompt[:, :n],
            llama.init_cache(cfg, b, s, device="cpu"), CHUNK)
    else:
        raise ValueError(fault)
    return rel(got, want)


def int8_tree(cfg, params, fault=None):
    q = llama.quantize_params_int8(cfg, params)
    if fault is None:
        return q
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w = q["layers"][name]
        if fault == "no_scale":
            s8 = torch.ones_like(w["s8"])
        elif fault == "stale_scale":
            s8 = w["s8"].roll(1, dims=0)
        else:
            raise ValueError(fault)
        q["layers"][name] = {"q8": w["q8"], "s8": s8}
    return q


def int8_dist(cfg, params, prompts, fault=None) -> float:
    b, s = prompts.shape

    def last_logits(tree):
        lg, _ = llama.prefill(cfg, tree, prompts,
                              llama.init_cache(cfg, b, s, device="cpu"),
                              last_only=True)
        return lg
    return rel(last_logits(int8_tree(cfg, params, fault)),
               last_logits(params))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for n_layers in args.layers:
        cfg = narrow_cfg(n_layers)
        gen = torch.Generator().manual_seed(args.seed)
        params = llama.init_params(cfg, gen, device="cpu")
        prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen)
        prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen)
        with torch.no_grad():
            for fault in (None, "fresh_cache", "no_remainder"):
                print(json.dumps({"check": "chunked", "layers": n_layers,
                                  "fault": fault, "rel": chunked_dist(
                                      cfg, params, prompt, fault)}),
                      flush=True)
            for fault in (None, "no_scale", "stale_scale"):
                print(json.dumps({"check": "int8", "layers": n_layers,
                                  "fault": fault, "rel": int8_dist(
                                      cfg, params, prompts, fault)}),
                      flush=True)


if __name__ == "__main__":
    main()
