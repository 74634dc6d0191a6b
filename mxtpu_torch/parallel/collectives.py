"""Collectives over mesh axes, and ``shard_map`` — the port of
``mxtpu/parallel/collectives.py`` and ``compat.py``'s ``shard_map``
(reference ``src/kvstore/comm.h`` reduce/broadcast, ``kvstore_nccl.h``).

The collectives take this rank's local tensor, as the reference's do
inside ``shard_map``, and run over the process group of a mesh axis (or
of several axes, flattened major first) of the ambient mesh, or of
``mesh=``: ``torch.distributed``'s functional collectives for the
reductions, gathers and all-to-alls, point-to-point sends for the ring.
Each is an ``autograd.Function`` with jax's transpose as its backward.
As in jax, a reduced value is the same on every rank (unvarying), and
so is its cotangent, while a gathered one may go on to differ:

- ``allreduce`` (``psum``): the cotangent passes through; ``pmean``
  divides it by the axis size;
- ``allgather``: the ranks' cotangents are summed and scattered (a
  reduce-scatter);
- ``reduce_scatter``: the cotangent is all-gathered;
- ``ppermute_ring``: the cotangent rotates the other way;
- ``alltoall``: the cotangent goes back by the inverse all-to-all.

:func:`pvary` is the other side of that convention (jax's ``pvary``):
the identity forward, and an all-reduce of the cotangent, where a value
that is the same on every rank of an axis meets one that is not.

On an axis of size 1, or with no distributed mesh, every collective is
the identity and issues nothing. :data:`issued` counts, by name, the
collectives this package issued (:func:`count`; ``sharding`` counts its
redistributes and ``step`` its gradient reductions here too).

:func:`shard_map` runs a function on each rank's local shards: its
inputs are laid out by ``in_specs`` (``redistribute``) and taken with
``to_local``, its outputs wrapped with ``DTensor.from_local`` under
``out_specs``; :class:`PartialOver` marks an output whose local values
are summands over some axes. Inside, no mesh is ambient (``constrain``
is a no-op there, as on the reference's manual axes): collectives take
the mesh as ``mesh=``. ``grad_partial`` names, per input, the
axes over which that input's cotangent is a sum of the ranks' parts
(where the function couples it to values that vary over those axes).
"""
from __future__ import annotations

import collections
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

from ._tree import tree_map
from .mesh import Mesh, current_mesh, use_mesh

__all__ = ["allreduce", "pmean", "allgather", "reduce_scatter",
           "ppermute_ring", "alltoall", "axis_index", "barrier_sync",
           "pvary", "shard_map", "PartialOver", "issued", "count"]

Axis = Union[str, Sequence[str]]

issued: "collections.Counter[str]" = collections.Counter()


def count(name: str) -> None:
    """Count one collective issued by this package."""
    issued[name] += 1


_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, int]] = {}


def _group(axis: Axis, mesh: Optional[Mesh]):
    """(process group, size, this rank's index) of ``axis`` (a name or a
    tuple, major first) on ``mesh`` or the ambient mesh; (None, 1, 0)
    when the axes span one rank."""
    mesh = mesh if mesh is not None else current_mesh()
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if mesh is None:
        raise ValueError(f"collective over {axes} needs a mesh: pass mesh= "
                         "or enter use_mesh(mesh)")
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} lack {a!r}")
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if not axes or not mesh.distributed:
        return None, 1, 0
    key = (id(mesh.device_mesh), axes)
    hit = _GROUPS.get(key)
    if hit is None:
        sub = mesh.device_mesh[axes]
        if len(axes) > 1:
            sub = sub._flatten("_".join(axes))
        hit = (sub.get_group(), sub.get_local_rank())
        _GROUPS[key] = hit
    group, idx = hit
    return group, math.prod(mesh.shape[a] for a in axes), idx


def _wait(t):
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(t)


def _all_reduce(x, group):
    from torch.distributed import _functional_collectives as funcol
    count("all_reduce")
    return _wait(funcol.all_reduce(x.contiguous(), "sum", group))


def _all_gather(x, dim, group):
    from torch.distributed import _functional_collectives as funcol
    count("all_gather")
    return _wait(funcol.all_gather_tensor(x.contiguous(), dim, group))


def _reduce_scatter(x, dim, group):
    from torch.distributed import _functional_collectives as funcol
    count("reduce_scatter")
    return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim,
                                              group))


def _all_to_all(x, split_dim, concat_dim, group, n):
    """Tiled all-to-all: chunk i of ``split_dim`` goes to rank i; the
    chunks received are concatenated along ``concat_dim``."""
    from torch.distributed import _functional_collectives as funcol
    count("all_to_all")
    xs = x.movedim(split_dim, 0).contiguous()
    out = _wait(funcol.all_to_all_single(xs, None, None, group))
    out = out.movedim(0, split_dim)          # chunks stacked on split_dim
    parts = out.chunk(n, dim=split_dim)
    return torch.cat(parts, dim=concat_dim)


def _permute(x, shift, group, n, idx):
    """Send to rank (idx + shift) mod n, receive from (idx - shift)."""
    count("ppermute")
    x = x.contiguous()
    out = torch.empty_like(x)
    dst = tdist.get_global_rank(group, (idx + shift) % n)
    src = tdist.get_global_rank(group, (idx - shift) % n)
    ops = [tdist.P2POp(tdist.isend, x, dst, group),
           tdist.P2POp(tdist.irecv, out, src, group)]
    for w in tdist.batch_isend_irecv(ops):
        w.wait()
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        return _all_reduce(x, group) * scale if scale != 1 else \
            _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1 else g), None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group, n, idx):
        ctx.shift, ctx.group, ctx.n, ctx.idx = shift, group, n, idx
        return _permute(x, shift, group, n, idx)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, -ctx.shift, ctx.group, ctx.n, ctx.idx), \
            None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, n):
        ctx.args = (split_dim, concat_dim, group, n)
        return _all_to_all(x, split_dim, concat_dim, group, n)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group, n = ctx.args
        return _all_to_all(g, concat_dim, split_dim, group, n), \
            None, None, None, None


def allreduce(x, axis: Axis = "dp", mesh: Optional[Mesh] = None):
    """Sum over the axis (reference: KVStore push+pull fused)."""
    group, n, _ = _group(axis, mesh)
    return x if n == 1 else _AllReduce.apply(x, group, 1)


def pmean(x, axis: Axis = "dp", mesh: Optional[Mesh] = None):
    group, n, _ = _group(axis, mesh)
    return x if n == 1 else _AllReduce.apply(x, group, 1.0 / n)


def pvary(x, axis: Axis, mesh: Optional[Mesh] = None):
    """The identity; its cotangent is summed over the axis."""
    group, n, _ = _group(axis, mesh)
    return x if n == 1 else _PVary.apply(x, group)


def allgather(x, axis: Axis, dim: int = 0, tiled: bool = True,
              mesh: Optional[Mesh] = None):
    """The ranks' ``x`` concatenated along ``dim`` (stacked on a new
    ``dim`` with ``tiled=False``)."""
    group, n, _ = _group(axis, mesh)
    if not tiled:
        x = x.unsqueeze(dim)
    return x if n == 1 else _AllGather.apply(x, dim, group)


def reduce_scatter(x, axis: Axis, dim: int = 0,
                   mesh: Optional[Mesh] = None):
    """The sum over the axis, rank i keeping chunk i of ``dim``."""
    group, n, _ = _group(axis, mesh)
    return x if n == 1 else _ReduceScatter.apply(x, dim, group)


def ppermute_ring(x, axis: str, shift: int = 1,
                  mesh: Optional[Mesh] = None):
    """Rotate shards around the axis: rank i's ``x`` lands on rank
    (i + shift) mod n (ring attention's KV rotation)."""
    group, n, idx = _group(axis, mesh)
    if n == 1 or shift % n == 0:
        return x
    return _Permute.apply(x, shift, group, n, idx)


def alltoall(x, axis: str, split_dim: int, concat_dim: int,
             mesh: Optional[Mesh] = None):
    """Ulysses-style reshard: chunk i of ``split_dim`` goes to rank i,
    and the chunks a rank receives are concatenated on ``concat_dim``."""
    group, n, _ = _group(axis, mesh)
    return x if n == 1 else _AllToAll.apply(x, split_dim, concat_dim,
                                            group, n)


def axis_index(axis: Axis, mesh: Optional[Mesh] = None) -> int:
    """This rank's index along the axis (major first over a tuple)."""
    return _group(axis, mesh)[2]


def barrier_sync() -> None:
    """Wait for this process's queued work, then for every rank of the
    group (the reference's ``Engine::WaitForAll``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if tdist.is_initialized():
        count("barrier")
        tdist.barrier()


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PartialOver:
    """An output spec: the local values are summands over ``axes``,
    laid out as ``spec`` over the other axes."""
    axes: Tuple[str, ...]
    spec: Any = ()


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``, where ``specs`` is one spec for
    the whole subtree or a tree of specs of the same structure (None:
    leave the subtree alone)."""
    from .sharding import P
    if specs is None:
        return tree
    if isinstance(specs, (P, PartialOver)):
        return tree_map(lambda x: fn(x, specs), tree)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(specs, (tuple, list)):
        out = [_map_specs(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    raise TypeError(f"not a spec: {specs!r}")


def _axis_set(mesh: Mesh, axes) -> set:
    """The ``DeviceMesh`` dims of ``axes`` (those above size 1)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return {mesh.dm_axes.index(a) for a in axes if a in mesh.dm_axes
            and mesh.shape[a] > 1}


def shard_map(f, mesh: Optional[Mesh], in_specs, out_specs,
              grad_partial: Sequence[Axis] = ()):
    """``f`` over each rank's local shards (reference ``shard_map``).

    ``in_specs``: one spec per positional argument (or a tree of specs
    matching it; None leaves an argument as it is); a plain tensor
    argument is the same global value on every rank. ``out_specs``: a
    spec, a :class:`PartialOver`, or a tuple of them for a tuple of
    outputs. ``grad_partial[i]``: the axes over which argument i's
    cotangent is a sum of the ranks' parts (for a dict argument, a dict
    of such axes by key). On no mesh, or the
    one-device placement, ``f`` runs on the arguments as they are."""
    if mesh is None or not mesh.distributed:
        return f

    from torch.distributed.tensor import DTensor, Partial
    from .sharding import _lay, spec_placements
    dm = mesh.device_mesh

    def _check_even(x, spec, pl):
        # the local regions find their offsets as axis index x local
        # size, so every shard must be the same size (jax refuses too)
        parts = {}
        for i, p in enumerate(pl):
            if p.is_shard():
                parts[p.dim] = parts.get(p.dim, 1) * dm.size(i)
        for d, n in parts.items():
            if x.shape[d] % n:
                raise ValueError(
                    f"shard_map: dim {d} of size {x.shape[d]} does not "
                    f"divide over {spec[d]!r} ({n} ranks) in spec "
                    f"{tuple(spec)}")

    def to_local(x, spec, partial_axes):
        if not isinstance(x, torch.Tensor):
            return x
        pl = spec_placements(mesh, spec)
        _check_even(x, spec, pl)
        x = _lay(x, mesh, pl)
        grad_pl = list(pl)
        for i in partial_axes:
            if grad_pl[i].is_replicate():
                grad_pl[i] = Partial()
        return x.to_local(grad_placements=grad_pl)

    def from_local(o, spec):
        if not isinstance(o, torch.Tensor):
            return o
        if isinstance(spec, PartialOver):
            pl = list(spec_placements(mesh, spec.spec))
            for i in _axis_set(mesh, spec.axes):
                pl[i] = Partial()
        else:
            pl = spec_placements(mesh, spec)
        return DTensor.from_local(o, dm, pl, run_check=False)

    def call(*args):
        specs = tuple(in_specs)
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} arguments, {len(specs)} in_specs")
        locs = []
        for i, (a, s) in enumerate(zip(args, specs)):
            gp = grad_partial[i] if i < len(grad_partial) else ()
            if isinstance(gp, dict):     # per entry of a dict argument
                locs.append({k: _map_specs(
                    lambda x, sp, ax=_axis_set(mesh, gp.get(k, ())):
                    to_local(x, sp, ax), v, s[k] if isinstance(s, dict)
                    else s) for k, v in a.items()})
                continue
            ax = _axis_set(mesh, gp) if gp else set()
            locs.append(_map_specs(lambda x, sp: to_local(x, sp, ax), a, s))
        with use_mesh(None):   # local values: no ambient re-layout inside
            out = f(*locs)
        return _map_specs(from_local, out, out_specs)
    return call
