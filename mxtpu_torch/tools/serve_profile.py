"""Where the time of one serving decode step goes, on one NVIDIA card.

    python -m mxtpu_torch.tools.serve_profile [--model llama3_8b]

Builds the state ``chip_smoke.py``'s ``serve_engine`` phase decodes
over: ``CONFIGS["llama3_8b"]`` with bf16 params from a seeded generator
(32 layers; ``--model mixtral_8x7b``: the ``mixtral`` phase's 8 layers
of Mixtral-8x7B, whose steps run the dropless expert mixture), a
16-slot bank at max_len 768 with every slot active at
length 300, every third slot sampled (temperature 0.8, top_k 50, top_p
0.95). Times, each the mean device time of a window queued behind a
spin of the card (``tools.timing.time_ms``): the whole step as the
engine runs it (the CUDA graph's replay) and the host time of one call
(staging the knobs, the replay, the tokens' clone) from an idle card,
and the
step's parts alone at their shapes, each captured as a CUDA graph too:
one layer (``_layer_slots``), the attention of one layer
(``slot_decode_attention``), the f32 logits head, and the sampler (the
keys' split and ``sample_logits`` on per-row knobs). Then it traces one
eager step with ``torch.profiler`` and prints the 15 kernels that took
longest and the device time by group. One JSON object, with the card's
name and power limit, and the bytes bound of the step: the weights it
reads (every layer, the final norm, the head, and one embedding row a
slot) and the live K/V prefixes, over the card's memory rate.

The same bank paged into a pool of 16-token pages, in shuffled order,
gives the paged step (``decode_slots_paged``) and the speculative verify
step (``decode_slots_spec``, 4 drafts a slot), each captured as the
engine captures them: their replayed device time and host time a call,
against the same bound (the drafts add 4 K/V entries a slot and 4 rows
to each product, which read no more weight bytes). On the same pool, one
eager paged prefill cold (a 392-token prompt, bucket 512) and one warm
(8 tokens over a shared 384-token prefix, bucket 64), the admissions of
``chip_smoke.py``'s time-to-first-token pair: the wall time of each with
its sync, the host time of the call, and the device time of its kernels
(``torch.profiler``).
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time
from collections import defaultdict
from dataclasses import replace

import numpy as np
import torch

from .. import prng
from ..models import llama
from ..ops.attention import slot_decode_attention
from ..serve.engine import _DecodeGraph
from .timing import graphed, time_ms

SLOTS, MAX_LEN, LENGTH = 16, 768, 300
PEAK_HBM_BYTES = 3.35e12


def _group(name: str) -> str:
    n = name.lower()
    if any(w in n for w in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul_f32" if "sgemm" in n or "f32f32" in n \
            else "matmul_bf16"
    if "sort" in n or "radix" in n:
        return "sort"
    return "other"


def _paged_steps(cfg, params, kv, sv, knobs, gen, reps, ps=16, k=4):
    """The dense bank's contents paged into a shuffled pool (scratch page
    0 first), and the paged and verify steps over it, replayed as the
    engine replays them: device ms, and host ms a call."""
    n = MAX_LEN // ps
    table = (torch.randperm(SLOTS * n, generator=gen, device="cuda")
             + 1).reshape(SLOTS, n)
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    pool = {}
    for name in ("k", "v"):
        pages = kv[name].reshape(L, SLOTS, kvh, n, ps, hd).transpose(
            2, 3).reshape(L, SLOTS * n, kvh, ps, hd)
        pool[name] = torch.zeros((L, 1 + SLOTS * n, kvh, ps, hd),
                                 dtype=cfg.dtype, device="cuda")
        pool[name].index_copy_(1, table.reshape(-1), pages)
    pt = table.int().cpu().numpy()
    drafts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SLOTS, k)).astype(np.int32)
    out = {"page_size": ps, "drafts": k}
    for name, program, extra in (
            ("paged_step", llama.decode_slots_paged, (pt,)),
            ("verify_step", llama.decode_slots_spec, (pt, drafts))):
        psv = {n: t.clone() for n, t in sv.items()}
        step = _DecodeGraph(cfg, params, pool, psv, program, MAX_LEN)
        call = (knobs[0],) + extra + knobs[1:]
        step(*call)                                # warm-up and capture
        psv["lengths"].fill_(LENGTH)
        out[f"{name}_ms"] = time_ms(step._graph.replay, reps)
        host = 0.0
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*call)
            host += time.perf_counter() - t0
        out[f"{name}_host_ms"] = host / reps * 1e3
        torch.cuda.synchronize()
        del step
    psv = {n: t.clone() for n, t in sv.items()}
    for name, prefix, suffix, bucket in (("cold", 0, 392, 512),
                                         ("warm", 384, 8, 64)):
        tokens = torch.randint(0, cfg.vocab_size, (1, bucket), generator=gen,
                               device="cuda")

        def prefill():
            with torch.no_grad():
                llama.prefill_slot_paged(
                    cfg, params, tokens, prefix + suffix, prefix, pt[0], 0,
                    pool, psv, prng.PRNGKey(0, "cuda"), 0.0, None, None)
        prefill()                                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[f"prefill_{name}"] = {
            "bucket": bucket, "prefix": prefix, "host_ms": host * 1e3,
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "device_ms": _device_ms(prefill)}
    return out


def _device_ms(fn):
    """The device time of one call of ``fn``: its kernels' sum in a
    ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_time_total for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama3_8b",
                    choices=["llama3_8b", "mixtral_8x7b"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = replace(llama.CONFIGS[args.model], param_dtype=torch.bfloat16,
                  n_layers={"llama3_8b": 32, "mixtral_8x7b": 8}[args.model])
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen, device="cuda")
    # what a step must read: every layer, the final norm and the head,
    # but only the SLOTS rows of the embedding that its tokens pick
    emb = params["tok_embed"]
    weight_bytes = SLOTS * emb[0].numel() * emb.element_size() + sum(
        t.numel() * t.element_size() for t in
        [params["lm_head"], params["final_norm"],
         *params["layers"].values()])
    # and each slot's live K/V prefix, with the entry it writes
    kv_bytes = (2 * cfg.n_layers * SLOTS * (LENGTH + 1) * cfg.n_kv_heads
                * cfg.head_dim * torch.finfo(cfg.dtype).bits // 8)
    state = llama.init_slot_cache(cfg, SLOTS, MAX_LEN, device="cuda")
    kv = {n: state[n] for n in ("k", "v")}
    sv = {n: state[n] for n in ("lengths", "tokens", "rngs")}
    kv["k"].normal_(generator=gen)
    kv["v"].normal_(generator=gen)
    sv["lengths"].fill_(LENGTH)
    sv["tokens"].copy_(torch.randint(0, cfg.vocab_size, (SLOTS,),
                                     generator=gen, device="cuda"))
    sv["rngs"].copy_(prng.split(prng.PRNGKey(0, "cuda"), SLOTS))
    sampled = np.arange(SLOTS) % 3 == 2
    knobs = (np.ones(SLOTS, bool), np.where(sampled, 0.8, 0.0)
             .astype(np.float32), np.where(sampled, 50, cfg.vocab_size)
             .astype(np.int32), np.where(sampled, 0.95, 1.0)
             .astype(np.float32))
    step = _DecodeGraph(cfg, params, kv, sv)
    step(*knobs)                                   # warm-up and capture
    sv["lengths"].fill_(LENGTH)
    out = {"card": card, "model": args.model, "slots": SLOTS,
           "max_len": MAX_LEN,
           "length": LENGTH, "n_layers": cfg.n_layers,
           "weights_gb": weight_bytes / 1e9,
           "weights_bound_ms": weight_bytes / PEAK_HBM_BYTES * 1e3,
           "kv_read_gb": kv_bytes / 1e9,
           "step_bound_ms": (weight_bytes + kv_bytes)
           / PEAK_HBM_BYTES * 1e3}
    reps = 10
    out["step_ms"] = time_ms(step._graph.replay, reps)
    host = 0.0
    for _ in range(reps):          # each call from an idle card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*knobs)
        host += time.perf_counter() - t0
    out["step_host_ms"] = host / reps * 1e3
    torch.cuda.synchronize()
    sv["lengths"].fill_(LENGTH)
    out.update(_paged_steps(cfg, params, kv, sv, knobs, gen, reps))

    with torch.no_grad():
        dev_knobs = [torch.from_numpy(k).cuda() for k in knobs]
        pos = sv["lengths"].long()
        cos_t, sin_t = step._rope
        cos, sin = cos_t[pos][:, None, None, :], sin_t[pos][:, None, None, :]
        x = llama._embed(cfg, params, sv["tokens"][:, None])
        lp = llama._layer_params(params, 0)
        ck, cv = kv["k"][0], kv["v"][0]
        q = torch.randn((SLOTS, cfg.n_heads, 1, cfg.head_dim),
                        generator=gen, device="cuda", dtype=cfg.dtype)
        logits = torch.randn((SLOTS, cfg.vocab_size), generator=gen,
                             device="cuda")
        attend = functools.partial(llama._bank_attend(kv, pos), 0)
        parts = {
            "layer": lambda: llama._layer_slots(cfg, cos, sin, x, lp,
                                                attend),
            "attention": lambda: slot_decode_attention(q, ck, cv, pos + 1),
            "logits_head": lambda: llama._logits(cfg, params, x),
            "sampler": lambda: llama.sample_logits(
                prng.split(sv["rngs"])[:, 1], logits, *dev_knobs[1:]),
        }
        out["parts_ms"] = {k: time_ms(graphed(f), reps)
                           for k, f in parts.items()}
        out["layers_ms"] = out["parts_ms"]["layer"] * cfg.n_layers
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            llama.decode_slots(cfg, params, kv, sv, *dev_knobs)
            torch.cuda.synchronize()
    by_name = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] += ev.device_time_total / 1e3     # us -> ms
    groups = defaultdict(float)
    for name, ms in by_name.items():
        groups[_group(name)] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    out["eager_device_ms"] = sum(by_name.values())
    out["groups_ms"] = dict(sorted(groups.items(), key=lambda kv: -kv[1]))
    out["top_kernels_ms"] = [[n[:120], ms] for n, ms in top]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
