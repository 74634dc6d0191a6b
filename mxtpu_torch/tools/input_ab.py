"""Does ``NativeImageRecordIter``'s hand-over pay for itself?

On the card the iterator writes each uint8 batch and its labels into
one of two pinned buffer pairs and copies them, and normalizes, on its
own stream. The plain alternative (``pinned=False``) copies pageable
buffers on the consumer's stream. This tool writes ``--images`` of
``tools.synth_images``' photographic-like 500×375 JPEGs, builds its
bf16 ResNet-50 step (batch 256, 224²) and trains it through
``DevicePrefetcher`` from the native iterator with each hand-over in
turn (``--rounds`` rounds of pinned, pageable, pageable, pinned),
reading the loss after each step as a training loop does; it prints
the timed epoch's img/s and data-wait p50/p99 for each, and the step
fed from memory beside them::

    python -m mxtpu_torch.tools.input_ab [--rounds 2] [--images 1024]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from .synth_images import SynthImages, build_resnet50_step, write_rec

BATCH, SIZE = 256, 224
MEAN, STD = (123.7, 116.3, 103.5), (58.4, 57.1, 57.4)


def epoch(step, rec: str, threads: int, pinned: bool):
    """One warm epoch, then one timed: (img/s, waits in ms)."""
    from .. import io as mio
    from ..gluon.data import DevicePrefetcher
    it = mio.NativeImageRecordIter(
        rec, (3, SIZE, SIZE), BATCH, shuffle=True,
        preprocess_threads=threads, mean=list(MEAN), std=list(STD),
        ctx="cuda", pinned=pinned)
    waits = []
    with DevicePrefetcher(it, depth=2, device="cuda") as batches:
        for timed in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 0
            while True:
                w0 = time.perf_counter()
                try:
                    b = next(batches)
                except StopIteration:
                    break
                if timed:
                    waits.append(1e3 * (time.perf_counter() - w0))
                float(step(b.data[0], b.label[0]).asscalar())
                n += b.data[0].shape[0] - b.pad
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            batches.reset()
    return n / seconds, waits


def _pct(xs, q):
    xs = sorted(xs)
    return float(xs[min(len(xs) - 1, int(q / 100 * len(xs)))]) if xs else 0.0


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--images", type=int, default=1024)
    p.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    p.add_argument("--dir", default=os.path.join("build", "input_ab"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("input_ab measures the card: none here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.dir, exist_ok=True)
    rec = os.path.join(args.dir, "train.rec")
    try:
        write_rec(rec, args.images, SynthImages(0, args.images, 375, 500),
                  lambda i: float(i % 1000), args.threads)
        step = build_resnet50_step()
        x = torch.randn((BATCH, 3, SIZE, SIZE), device="cuda")
        y = torch.randint(0, 1000, (BATCH,), device="cuda").float()
        from ..ndarray import NDArray
        for _ in range(2):
            float(step(NDArray(x), NDArray(y)).asscalar())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            float(step(NDArray(x), NDArray(y)).asscalar())
        memory = 4 * BATCH / (time.perf_counter() - t0)
        rows = {"pinned_own_stream": [], "pageable_consumer_stream": []}
        for r in range(args.rounds):
            order = (True, False) if r % 2 == 0 else (False, True)
            for pinned in order + order[::-1]:
                rate, waits = epoch(step, rec, args.threads, pinned)
                rows["pinned_own_stream" if pinned else
                     "pageable_consumer_stream"].append(
                    {"img_per_s": rate, "wait_p50_ms": _pct(waits, 50),
                     "wait_p99_ms": _pct(waits, 99)})
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(json.dumps({"tool": "input_ab", "card": card,
                          "images": args.images, "threads": args.threads,
                          "from_memory_img_per_s": memory, **rows}),
              flush=True)
    finally:
        for ext in (".rec", ".idx"):
            path = os.path.splitext(rec)[0] + ext
            if os.path.exists(path):
                os.remove(path)


if __name__ == "__main__":
    main()
