"""Sharding rules — the port of ``mxtpu/parallel/sharding.py``
(reference KVStore key placement, ``src/kvstore/kvstore_dist.h``).

A rule table maps parameter names (regex, first match wins) to a
partition spec ``P(...)``: one entry per array dim, each a mesh axis, a
tuple of axes, or None. On a mesh over a process group a spec is a
DTensor layout (:func:`spec_placements`): each mesh axis the entry of
dim ``d`` names is ``Shard(d)``, every other axis ``Replicate()``, and a
tuple such as ``("dp", "fsdp")`` shards one dim over both, the first
major, as jax orders it (so a tuple must follow ``MESH_AXES`` order). An
axis of size 1 shards nothing and has no dim in the ``DeviceMesh``, so
on a one-rank mesh every layout is replicated and DTensor issues no
collective.
``shard_pytree`` places a tree by the rules
(``distribute_tensor``, each rank taking its chunk of the same host
values), ``constrain``/``mcon`` re-lay a tensor (``redistribute``,
differentiable), dropping axes the mesh lacks.

On the one-device placement of a process with no group (``Mesh
.device_mesh`` None) a spec is recorded and checked but splits
nothing, and ``constrain`` is a no-op, as it is with no ambient mesh.
"""
from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from ._tree import key_str, path_str, tree_map, tree_map_with_path
from .mesh import Mesh, current_mesh, use_mesh

__all__ = ["P", "Placement", "ShardingRules", "named", "replicated",
           "batch_spec", "key_str", "shard_pytree", "constrain", "mcon",
           "global_device_put", "spec_placements", "is_dtensor", "to_full",
           "spmd"]


class P(tuple):
    """A partition spec: one entry per array dim, each an axis name, a
    tuple of axis names, or None (reference ``PartitionSpec``)."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _entry_axes(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def spec_placements(mesh: Mesh, spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per dim of
    its ``DeviceMesh`` (``mesh.dm_axes``), ``Shard(d)`` where dim d's
    entry names the axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.axis_names)
    out = [Replicate()] * len(mesh.dm_axes)
    taken = set()
    for d, e in enumerate(spec):
        axes = _entry_axes(e)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, "
                                 f"which mesh axes {names} lack")
            if a in taken:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r} "
                                 "twice")
            taken.add(a)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {e!r} shards one dim over several axes, "
                f"major first, in an order other than the mesh's {names}")
        for a in axes:
            if a in mesh.dm_axes and mesh.shape[a] > 1:
                out[mesh.dm_axes.index(a)] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class Placement:
    """A spec on a mesh (reference ``NamedSharding``)."""
    mesh: Mesh
    spec: P

    def _check_axes(self) -> None:
        for e in self.spec:
            for a in _entry_axes(e):
                if a not in self.mesh.axis_names:
                    raise ValueError(
                        f"spec {self.spec} names axis {a!r}, which mesh "
                        f"axes {self.mesh.axis_names} lack")

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)


def named(mesh: Mesh, *spec) -> Placement:
    """``named(mesh, 'dp', None)`` → the placement of P('dp', None)."""
    return Placement(mesh, P(*spec))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, P())


def batch_spec(mesh: Optional[Mesh] = None) -> P:
    """Canonical batch spec: the leading dim over the data axes (dp,
    fsdp) the mesh has."""
    axes: Tuple[str, ...] = ("dp", "fsdp")
    if mesh is not None:
        axes = tuple(a for a in axes if a in mesh.axis_names)
    return P(axes) if axes else P()


class ShardingRules:
    """Ordered (regex → spec) table.

    >>> rules = ShardingRules([(r".*attn.*(wq|wk|wv)$", P("fsdp", "tp")),
    ...                        (r".*", P())])
    >>> rules.spec("layer3_attn_wq")
    P('fsdp', 'tp')
    """

    def __init__(self, rules: Sequence[Tuple[str, P]]):
        self._rules = [(re.compile(pat), P(*spec)) for pat, spec in rules]

    def spec(self, name: str) -> P:
        for pat, spec in self._rules:
            if pat.search(name):
                return spec
        return P()

    def sharding(self, mesh: Mesh, name: str) -> Placement:
        return Placement(mesh, self.spec(name))

    def tree_specs(self, tree: Any, prefix: str = "") -> Any:
        """A tree of specs matching ``tree``, each leaf named by its
        '/'-joined key path."""
        return tree_map_with_path(
            lambda path, _leaf: self.spec(prefix + path_str(path)), tree)


def spmd(mesh: Optional[Mesh]):
    """The context a program runs in on a mesh: the ambient mesh
    (:func:`use_mesh`) and, on a mesh of a process group, plain tensors
    taken as replicated (DTensor's ``implicit_replication``). Nothing
    for no mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(use_mesh(mesh))
    if not mesh.distributed:
        return stack
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    # implicit_replication() clears the flag on exit, so a nested entry
    # would end the outer one's: enter it only at the outermost level
    if not getattr(DTensor._op_dispatcher, "_allow_implicit_replication",
                   False):
        stack.enter_context(implicit_replication())
    return stack


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def to_full(x):
    """A DTensor's global value as a plain tensor on this rank (others
    pass through)."""
    return x.full_tensor() if is_dtensor(x) else x


def global_device_put(arr, placement: Placement):
    """``arr`` laid out as ``placement``: on a mesh over a group, each
    rank takes its chunk of ``arr`` (every rank holds the same values,
    as under SPMD; nothing is sent); a DTensor is redistributed. On the
    one-device placement, ``arr`` moves to the mesh's device if it
    names one."""
    mesh = placement.mesh
    if not mesh.distributed:
        placement._check_axes()
        return arr if mesh.device is None else arr.to(mesh.device)
    return _lay(arr, mesh, placement.placements)


def _lay(x, mesh: Mesh, placements):
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        if tuple(x.placements) == tuple(placements):
            return x
        from .collectives import count
        count("redistribute")
        return x.redistribute(mesh.device_mesh, placements)
    x = torch.as_tensor(x)
    if x.device != mesh.device:
        x = x.to(mesh.device)
    if x.requires_grad:
        # differentiable: the replicated value, then each rank's chunk
        from torch.distributed.tensor import Replicate
        return DTensor.from_local(
            x, mesh.device_mesh, [Replicate()] * len(mesh.dm_axes),
            run_check=False).redistribute(mesh.device_mesh, placements)
    return distribute_tensor(x, mesh.device_mesh, placements,
                             src_data_rank=None)


def shard_pytree(tree: Any, mesh: Mesh, rules: ShardingRules,
                 prefix: str = "") -> Any:
    """Every leaf laid out by its rule (the reference's ``kv.init``)."""
    specs = rules.tree_specs(tree, prefix)
    return tree_map(lambda x, s: global_device_put(x, Placement(mesh, s)),
                    tree, specs)


def _filter_spec(spec, axis_names) -> P:
    """Drop axes the mesh doesn't have (model code names the full
    dp/fsdp/sp/tp layout; smaller meshes ignore what they lack)."""
    names = set(axis_names)

    def keep(e):
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in names)
            return kept if kept else None
        return e if e in names else None

    return P(*[keep(e) for e in spec])


def mcon(mesh: Optional[Mesh], x, *spec):
    """Re-lay ``x`` as ``spec`` on an explicit mesh (the ambient mesh's
    :func:`constrain` when ``mesh`` is None). A plain tensor on a
    distributed mesh is taken as replicated. Unknown axes are dropped."""
    if mesh is None:
        return constrain(x, *spec)
    if not mesh.distributed:
        return x
    return _redistribute(x, mesh, _filter_spec(spec, mesh.axis_names))


def _redistribute(x, mesh: Mesh, spec):
    from torch.distributed.tensor import DTensor, Replicate
    placements = spec_placements(mesh, spec)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh.device_mesh,
                               [Replicate()] * len(mesh.dm_axes),
                               run_check=False)
    return _lay(x, mesh, placements)


def constrain(x, *spec):
    """Re-lay ``x`` as ``spec`` on the ambient mesh (:func:`use_mesh`).
    A no-op with no ambient mesh, or on the one-device placement."""
    mesh = current_mesh()
    if mesh is None or not mesh.distributed:
        return x
    return _redistribute(x, mesh, _filter_spec(spec, mesh.axis_names))
