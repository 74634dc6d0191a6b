"""Capturing a CUDA graph: the one sequence every captured program of the
port goes through (the serve engine's decode steps, the disaggregated
prefill chunk, Gluon's predict mode and fused step, the Executor)."""
from __future__ import annotations

import threading
from typing import Callable

import torch

from .telemetry import watcher

__all__ = ["capture_graph", "graphs_on"]

# one capture at a time in the process: engines and workers start on threads
CAPTURE_LOCK = threading.Lock()


def graphs_on(device: torch.device) -> bool:
    """Whether a predict-mode call on ``device`` replays a CUDA graph."""
    return device.type == "cuda"


def capture_graph(build: str, fn: Callable[[], None],
                  warm: Callable[[], None], device: torch.device):
    """``fn`` as one CUDA graph, counted as the build ``build``:
    ``warm`` (a run that leaves nothing the graph reads changed) goes
    first on a side stream, its blocks go back to the card, then ``fn``
    is captured in ``thread_local`` mode (autograd's device thread may
    run a backward onto the capturing stream). One capture at a time
    process-wide; a capture that fails raises."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    with CAPTURE_LOCK, watcher.build(build):
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm()
        main.wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn()
    return graph
