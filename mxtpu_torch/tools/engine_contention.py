"""How long one serve engine's admissions take while another engine
decodes on the same NVIDIA card.

    python -m mxtpu_torch.tools.engine_contention [--layers 32] [--new 600]

Builds ``CONFIGS["llama3_8b"]`` with bf16 params from a seeded generator
(``--layers`` of its 32) and two engines of the gateway's shape (8
slots, max_len 768, buckets from 64), each on its own ``run_forever``
thread, as two gateway or fleet replicas run. Every bucket of both is
warmed first. Then engine A is given 4 prompts of 64 tokens (32 new
tokens each), twice: once with engine B idle, and once while B decodes
one request of ``--new`` tokens (B's steps in flight, queued one ahead
of their readback). For each run: the seconds from A's submissions to
each of its first 4 decode dispatches and to its last token, and B's
step time. One JSON object, with the card's name and power limit.

Both engines issue their work on the card's one default stream, and A's
admissions are eager programs with host syncs; a sync waits for every
kernel queued before it, B's step in flight among them, so the admission
delay grows with B's step time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time
from dataclasses import replace

import numpy as np
import torch

from ..models import llama
from ..serve import Request, ServeEngine

SLOTS, MAX_LEN, MIN_BUCKET = 8, 768, 64


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _marks(engine):
    """Wrap ``engine._dispatch`` to stamp each decode dispatch; returns
    (the stamps, the unwrapped dispatch)."""
    stamps = []
    dispatch = engine._dispatch

    def stamped(firsts):
        stamps.append(time.perf_counter())
        return dispatch(firsts)

    engine._dispatch = stamped
    return stamps, dispatch


def _serve(engine, reqs, wait=600.0):
    """Submit ``reqs`` to an engine serving on its thread and wait until
    every token has arrived; returns (submitted at, last token at)."""
    left = [sum(r.max_new_tokens for r in reqs)]
    lock = threading.Lock()
    done = threading.Event()

    def on_token(rid, tok):
        with lock:
            left[0] -= 1
            if left[0] == 0:
                done.set()

    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(replace(r, on_token=on_token))
    if not done.wait(wait):
        raise RuntimeError("an engine did not finish its requests")
    return t0, time.perf_counter()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--new", type=int, default=600)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("engine_contention: no CUDA card is visible")
    cfg = replace(llama.CONFIGS["llama3_8b"], n_layers=args.layers,
                  param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(0)
    engines = [ServeEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                           min_bucket=MIN_BUCKET, device="cuda")
               for _ in range(2)]
    stops = [threading.Event() for _ in engines]
    threads = [threading.Thread(target=e.run_forever, args=(s,),
                                daemon=True)
               for e, s in zip(engines, stops)]
    for t in threads:
        t.start()
    a, b = engines
    try:
        for e in engines:            # every bucket, and the capture
            _serve(e, [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                               max_new_tokens=8, seed=n)
                       for n in (64, 128, 256, 384)])
        rows = {}
        for name in ("b_idle", "b_decoding"):
            b_stamps = None
            if name == "b_decoding":
                b_stamps, b_dispatch = _marks(b)
                b.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 64),
                                 max_new_tokens=args.new, seed=7))
                while len(b_stamps) < 20:
                    time.sleep(0.005)
            a_stamps, a_dispatch = _marks(a)
            t0, t_end = _serve(a, [
                Request(prompt=rng.integers(0, cfg.vocab_size, 64),
                        max_new_tokens=32, seed=100 + i) for i in range(4)])
            a._dispatch = a_dispatch
            row = {"to_dispatch_s": [s - t0 for s in a_stamps[:4]],
                   "to_last_token_s": t_end - t0,
                   "a_dispatches": len(a_stamps)}
            if b_stamps is not None:
                b._dispatch = b_dispatch
                row["b_step_ms"] = float(1e3 * np.median(
                    np.diff(b_stamps[5:20])))
                row["b_dispatches_meanwhile"] = sum(
                    t0 <= s <= t_end for s in b_stamps)
            rows[name] = row
    finally:
        for s in stops:
            s.set()
        for e in engines:
            e.wake()
        for t in threads:
            t.join(600)
    print(json.dumps({"tool": "engine_contention", "card": _card(),
                      "layers": args.layers, "b_new_tokens": args.new,
                      "requests": 4, "prompt": 64, "new": 32, **rows}),
          flush=True)


if __name__ == "__main__":
    main()
