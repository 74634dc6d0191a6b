"""Pipeline parallelism over the ``pp`` mesh axis — the port of
``mxtpu/parallel/pipeline.py`` (GPipe).

The layer stack (stacked params, leading layer dim) splits into S
contiguous stages, one per ``pp`` rank. Microbatches enter stage 0 one
per tick; each tick every stage applies its layers to the microbatch it
holds, then the activations move one stage on by point-to-point
(:func:`~.collectives.ppermute_ring`). After M + S − 1 ticks every
microbatch has crossed every stage, and one sum over the axis hands the
last stage's outputs to every rank. The backward is the reverse
schedule: autograd runs the ticks back, and each rotation's backward
sends the cotangent the other way. Every rank builds the same graph
(stage-dependent choices are tensor selects, not Python branches), so
the ranks' collectives pair up, forward and backward.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ._tree import tree_leaves, tree_map
from .collectives import allreduce, axis_index, ppermute_ring, pvary, shard_map
from .mesh import Mesh, axis_size
from .sharding import P

__all__ = ["gpipe"]


def _apply_layers(layer_fn, stacked, x):
    n = tree_leaves(stacked)[0].shape[0]
    for i in range(n):
        x = layer_fn(tree_map(lambda t: t[i], stacked), x)
    return x


def gpipe(layer_fn: Callable[[Any, Any], Any], stacked_params: Any, x,
          *, mesh: Mesh, n_microbatches: int, axis: str = "pp"):
    """Run ``x`` through a stack of layers pipelined over ``axis``.

    ``layer_fn(layer_params, x) -> x`` applies one layer;
    ``stacked_params``: a tree whose leaves have a leading layer dim L
    divisible by the stage count; ``x``: (B, ...) with B divisible by
    ``n_microbatches``. Returns (B, ...), replicated. With one stage
    the layers run in order on ``x`` as it is."""
    S = axis_size(axis, mesh)
    if S == 1:
        return _apply_layers(layer_fn, stacked_params, x)
    M = n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    L = tree_leaves(stacked_params)[0].shape[0]
    if L % S:
        raise ValueError(
            f"layer count {L} not divisible by {S} pipeline stages")
    mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
    param_specs = tree_map(lambda t: P(axis, *([None] * (t.ndim - 1))),
                           stacked_params)

    def pp_fn(local_params, mb_all):
        stage = axis_index(axis, mesh)
        first = torch.tensor(stage == 0)
        last = torch.tensor(stage == S - 1)
        # only stage 0 reads the microbatches: their cotangent is the
        # sum of the stages' (jax's pvary)
        mb_all = pvary(mb_all, axis, mesh)
        zero = torch.zeros_like(mb_all[0])
        state, outs = zero, []
        for t in range(M + S - 1):
            inp = mb_all[t] if t < M else zero
            yy = _apply_layers(layer_fn, local_params,
                               torch.where(first, inp, state))
            if t >= S - 1:     # the last stage finishes microbatch t-S+1
                outs.append(yy)
            if t < M + S - 2:
                state = ppermute_ring(yy, axis, mesh=mesh)
        out = torch.where(last, torch.stack(outs), 0)
        return allreduce(out, axis, mesh)

    out = shard_map(pp_fn, mesh, in_specs=(param_specs, P()),
                    out_specs=P())(stacked_params, mb)
    return out.reshape((B,) + tuple(x.shape[1:]))
