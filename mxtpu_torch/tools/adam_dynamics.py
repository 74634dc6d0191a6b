"""The loss trajectory of a few adamw steps at llama3_8b width, for
several variants of the model, on one NVIDIA card.

    python -m mxtpu_torch.tools.adam_dynamics

``chip_smoke.py`` trains ``CONFIGS["llama3_8b"]`` at 4 layers with
``adamw(3e-4)`` on one seeded (1, 2048) batch. Its loss does not fall at
every step. This script shows whether that comes from the port's
kernels or from the optimizer: it runs 5 steps of the same model, batch
and seed with flash attention (the hand-written kernels), with dense
attention, without the chunked cross-entropy, with dense attention in
f32 (no kernel of the port at all), at two smaller learning rates and
at one layer, and prints one JSON line of losses per variant.
"""
from __future__ import annotations

import json
import subprocess
from dataclasses import replace

import torch

from ..models import llama
from ..parallel import optim, step as pstep

VARIANTS = (("flash", {}, 3e-4),
            ("dense", {"attn_impl": "dense"}, 3e-4),
            ("flash_no_ce_chunk", {"ce_chunk": None}, 3e-4),
            ("dense_f32", {"attn_impl": "dense", "dtype": torch.float32},
             3e-4),
            ("flash_lr1e-4", {}, 1e-4),
            ("flash_lr3e-5", {}, 3e-5),
            ("flash_1_layer", {"n_layers": 1}, 3e-4))


def main(steps: int = 5, seed: int = 0) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("adam_dynamics needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    base = replace(llama.CONFIGS["llama3_8b"], n_layers=4)
    for name, kw, lr in VARIANTS:
        cfg = replace(base, **kw)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = llama.init_params(cfg, gen, device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                               device="cuda")
        tx = optim.adamw(lr)
        state = pstep.init_state(params, tx)
        del params
        step = pstep.make_train_step(llama.loss_fn(cfg), tx)
        losses = []
        for _ in range(steps):
            state, loss = step(state, {"tokens": tokens})
            losses.append(loss.item())
        print(json.dumps({"variant": name, "lr": lr, "losses": losses,
                          "card": card}), flush=True)
        del state, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
