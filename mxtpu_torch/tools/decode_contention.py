"""The native decode pipe's rate while another thread waits for the card.

A training loop reads its loss on the host after each step: its thread
waits for the step's work on the default stream. How it waits decides
whether the native pipe's workers (which copy each decoded image off
the card under nvJPEG) keep decoding meanwhile. This tool writes a
``.rec`` of 768 of ``tools.synth_images``' photographic-like 500×375
JPEGs, then drains 1,024 images through ``NativePipeline`` (224²,
``--threads`` workers) while the main thread loops over ~``--work-ms`` of bf16 products on the default stream
followed by one of these waits, and prints img/s for each::

    idle         no other thread
    stream_sync  torch.cuda.current_stream().synchronize()
    to_cpu       a 1-element tensor's .to("cpu") (waits inside the copy)
    asnumpy      mxtpu_torch's NDArray.asnumpy (waits, then copies)

Run it on the card:
``python -m mxtpu_torch.tools.decode_contention [--threads 8]``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import threading
import time

import torch

from .synth_images import SynthImages, write_rec

WAITS = ("idle", "stream_sync", "to_cpu", "asnumpy")


def decode_rate(rec: str, threads: int, wait: str, work_ms: float,
                images: int = 1024) -> float:
    import mxtpu_torch as mx
    from .. import native
    a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    one = torch.ones(1, device="cuda")
    one_nd = mx.nd.NDArray(one)
    # products that take about work_ms
    a @ a
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        a @ a
    torch.cuda.synchronize()
    reps = max(1, int(work_ms / (1e3 * (time.perf_counter() - t0) / 8)))
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            for _ in range(reps):
                a @ a
            if wait == "stream_sync":
                torch.cuda.current_stream().synchronize()
            elif wait == "to_cpu":
                one.to("cpu")
            elif wait == "asnumpy":
                # the wait this tool measures (image decode, not tokens)
                one_nd.asnumpy()  # mxlint: disable=MXL004
    t = threading.Thread(target=loop, daemon=True)
    pipe = native.NativePipeline(rec, 224, 224, 3, threads=threads,
                                 out_u8=True)
    try:
        if wait != "idle":
            t.start()
        t0 = time.perf_counter()
        n = 0
        while n < images:
            data, _ = pipe.next_batch(256)
            if not len(data):
                pipe.reset()
                continue
            n += len(data)
        return n / (time.perf_counter() - t0)
    finally:
        stop.set()
        if wait != "idle":
            t.join(timeout=60)
        pipe.close()
        torch.cuda.synchronize()


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    p.add_argument("--work-ms", type=float, default=250.0)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--dir", default=os.path.join("build",
                                                 "decode_contention"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_contention measures the card: none here")
    from .. import native
    os.makedirs(args.dir, exist_ok=True)
    rec = os.path.join(args.dir, "contention.rec")
    try:
        write_rec(rec, 768, SynthImages(0, 768, 375, 500), float,
                  args.threads)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        rows = {w: [] for w in WAITS}
        for _ in range(args.rounds):          # in turns
            for w in WAITS:
                rows[w].append(decode_rate(rec, args.threads, w,
                                           args.work_ms))
        print(json.dumps({"tool": "decode_contention", "card": card,
                          "codec": native.backend(),
                          "threads": args.threads,
                          "work_ms": args.work_ms,
                          "img_per_s": rows}), flush=True)
    finally:
        for ext in (".rec", ".idx"):
            path = os.path.splitext(rec)[0] + ext
            if os.path.exists(path):
                os.remove(path)


if __name__ == "__main__":
    main()
