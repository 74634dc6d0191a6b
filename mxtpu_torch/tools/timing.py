"""Device and host timing on one CUDA card, shared by ``chip_smoke.py``
and the tools.

:func:`time_ms` enqueues its window behind a spin of the card, so it
times the card alone and not the host's cost of each call, which
:func:`host_ms` reports beside it. A call of many eager ops can cost the
host more than the spin; :func:`graphed` captures it as a CUDA graph,
whose replay costs the host one launch.
"""
from __future__ import annotations

import time

import torch

# a queued window's spin, per call: about 0.27 ms at the H100's clock,
# several times what the host takes to enqueue a kernel call
SPIN_CYCLES = 500_000


def time_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, the
    window enqueued behind a spin of ``SPIN_CYCLES`` a call. A call whose
    host cost is above the spin still shows it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps, windows=5):
    """Median over ``windows`` windows of :func:`time_ms`."""
    times = sorted(time_ms(fn, reps, warmup=2 if i == 0 else 0)
                   for i in range(windows))
    return times[len(times) // 2]


def host_ms(fn, reps=20):
    """Host time of one call of ``fn`` (checks, encodings, the launch),
    from an idle card: when it is above the device time, the call is
    host-bound."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def graphed(fn):
    """``fn`` captured as a CUDA graph (warmed on a side stream first):
    its replay, whose host cost is far below the device time, so a
    queued window times the card even where eager calls are
    host-bound."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay
