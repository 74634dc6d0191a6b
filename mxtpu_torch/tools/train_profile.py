"""Where the time of one training step goes, by kernel, on one NVIDIA
card.

    python -m mxtpu_torch.tools.train_profile [--model llama3_8b]

Builds a step that ``chip_smoke.py`` drives, warms it for two steps,
then traces a third with ``torch.profiler``. ``--model``: ``llama3_8b``
(the ``train`` phase: 4 layers, f32 params, bf16 compute, remat,
chunked cross-entropy, ``adamw(3e-4)``, one seeded (1, 2048) batch),
``mixtral_8x7b`` (the ``mixtral`` phase's step: the same at one layer
of Mixtral-8x7B, capacity 1.25) or ``bert_base`` (the ``bert`` phase's
step: BERT-base, batch 128 × 128, 20 MLM positions, NSP labels,
``adamw(1e-4)``). Prints one JSON object:
the step's wall time, the device time summed over all kernels and its
share of the wall time, the device time by group (the port's flash
kernels, f32 and bf16 matrix products, everything else), and the 15
kernels that took longest. Then it times the optimizer's part of the
step alone (``adamw``'s update over grads of the params' shapes, and
adding the updates to the params in place) with CUDA events.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from collections import defaultdict
from dataclasses import replace

import torch

from ..models import bert, llama
from ..parallel import optim, step as pstep
from ..parallel._tree import tree_leaves, tree_map


def _group(name: str) -> str:
    """A kernel's group, from its name: one of the port's flash kernels,
    a cuBLAS/CUTLASS matrix product in f32 or in bf16, or other."""
    m = re.search(r"flash_\w+_kernel", name)
    if m:
        return m.group(0)
    n = name.lower()
    if any(w in n for w in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul_f32" if "sgemm" in n or "f32f32" in n \
            else "matmul_bf16"
    return "other"


def _setup(model: str, gen):
    """(params, loss, batch, lr) of ``model``'s step."""
    if model == "bert_base":
        cfg = bert.CONFIGS["bert_base"]
        b, s, n = 128, 128, 20

        def ints(high, shape):
            return torch.randint(0, high, shape, generator=gen,
                                 device="cuda")
        batch = {"tokens": ints(cfg.vocab_size, (b, s)),
                 "mask": torch.ones((b, s), device="cuda"),
                 "mlm_positions": ints(s, (b, n)).sort(-1).values,
                 "mlm_labels": ints(cfg.vocab_size, (b, n)),
                 "mlm_weights": torch.ones((b, n), device="cuda"),
                 "nsp_labels": ints(2, (b,))}
        return (bert.init_params(cfg, gen, device="cuda"),
                bert.loss_fn(cfg), batch, 1e-4)
    layers = {"llama3_8b": 4, "mixtral_8x7b": 1}[model]
    cfg = replace(llama.CONFIGS[model], n_layers=layers)
    params = llama.init_params(cfg, gen, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 2048),
                                     generator=gen, device="cuda")}
    return params, llama.loss_fn(cfg), batch, 3e-4


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama3_8b",
                    choices=["llama3_8b", "mixtral_8x7b", "bert_base"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_profile needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, loss_fn, batch, lr = _setup(args.model, gen)
    tx = optim.adamw(lr)
    state = pstep.init_state(params, tx)
    del params
    step = pstep.make_train_step(loss_fn, tx)
    for _ in range(2):
        state, loss = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] += ev.device_time_total / 1e3     # us -> ms
    groups = defaultdict(float)
    for name, ms in by_name.items():
        groups[_group(name)] += ms
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]

    grads = tree_map(torch.zeros_like, state.params)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        start.record()
        updates, _ = tx.update(grads, state.opt_state, state.params)
        for p, u in zip(tree_leaves(state.params), tree_leaves(updates)):
            p.add_(u)
        end.record()
    torch.cuda.synchronize()
    print(json.dumps({
        "card": card, "model": args.model, "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:120], ms] for n, ms in top],
        "optimizer_ms": start.elapsed_time(end),
        "loss": loss.item()}), flush=True)


if __name__ == "__main__":
    main()
