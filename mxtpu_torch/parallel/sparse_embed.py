"""Sharded large-embedding lookup — the port of
``mxtpu/parallel/sparse_embed.py`` (reference row_sparse
parameter-server path, ``src/kvstore/kvstore_dist.h`` sparse
push/pull).

The table is laid out with its rows blocked over a mesh axis, and the
lookup runs on each rank's block (:func:`~.collectives.shard_map`):
each rank gathers the requested rows it owns, zeros the others, and one
sum over the axis assembles the result, so the full table never sits on
one rank. The table's gradient is the local scatter-add of the
cotangent into the owned rows (the backward of the gather); no
collective is needed for it.
"""
from __future__ import annotations

from typing import Optional

import torch

from .collectives import allreduce, axis_index, shard_map
from .mesh import Mesh
from .sharding import P, global_device_put, named

__all__ = ["shard_embedding", "sharded_embedding_lookup"]


def shard_embedding(table, mesh: Mesh, axis: str = "fsdp"):
    """A (vocab, dim) table laid out row-blocked over ``axis``."""
    return global_device_put(table, named(mesh, axis, None))


def _masked_rows(tbl, ids, lo):
    """Rows ``ids - lo`` of ``tbl``, zero where an id falls outside
    [lo, lo + rows)."""
    rows = tbl.shape[0]
    ids = ids.long()
    vals = tbl[(ids - lo).clamp(0, rows - 1)]
    mine = (ids >= lo) & (ids < lo + rows)
    return torch.where(mine[..., None], vals, 0).to(tbl.dtype)


def sharded_embedding_lookup(table, ids, mesh: Optional[Mesh],
                             axis: str = "fsdp", ids_spec=P()):
    """Differentiable lookup into a row-blocked table.

    ``table``: (V, D), laid out ``P(axis, None)`` (any other layout is
    redistributed to it); ``ids``: int, laid out ``ids_spec`` (default
    replicated). Returns ``(*ids.shape, D)`` laid out as the ids, with
    the feature dim replicated. An id outside [0, V) gives a zero row,
    as the sharded sum does. Without ``axis`` on the mesh, or on the
    one-device placement, the same masked gather runs whole."""
    if mesh is None or axis not in mesh.axis_names or not mesh.distributed:
        return _masked_rows(table, ids, 0)
    ids_axes = tuple(a for e in ids_spec if e is not None
                     for a in ((e,) if isinstance(e, str) else e))

    def local(tbl, ids_local):
        lo = axis_index(axis, mesh) * tbl.shape[0]
        return allreduce(_masked_rows(tbl, ids_local, lo), axis, mesh)

    return shard_map(local, mesh, in_specs=(P(axis, None), ids_spec),
                     out_specs=P(*ids_spec, None),
                     grad_partial=(ids_axes, ()))(table, ids)
