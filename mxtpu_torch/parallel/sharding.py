"""Sharding rules, their one-device subset — the port of
``mxtpu/parallel/sharding.py`` (reference KVStore key placement,
``src/kvstore/kvstore_dist.h``).

A rule table maps parameter names (regex, first match wins) to a
partition spec over the mesh's axes. On a one-device mesh (the only
kind the port builds, :mod:`.mesh`) every spec places the whole array
on that device, so a spec is recorded and checked but splits nothing;
``named``/``replicated`` give the placement as a :class:`Placement`.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from .mesh import Mesh

__all__ = ["P", "Placement", "ShardingRules", "named", "replicated",
           "batch_spec"]


class P(tuple):
    """A partition spec: one entry per array dim, each an axis name, a
    tuple of axis names, or None (reference ``PartitionSpec``)."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclass(frozen=True)
class Placement:
    """A spec on a mesh (reference ``NamedSharding``)."""
    mesh: Mesh
    spec: P

    def _check_axes(self) -> None:
        for e in self.spec:
            for a in (e if isinstance(e, (tuple, list)) else (e,)):
                if a is not None and a not in self.mesh.axis_names:
                    raise ValueError(
                        f"spec {self.spec} names axis {a!r}, which mesh "
                        f"axes {self.mesh.axis_names} lack")


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
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec(self, name: str) -> P:
        for pat, spec in self._rules:
            if pat.search(name):
                return spec
        return P()

    def sharding(self, mesh: Mesh, name: str) -> Placement:
        return Placement(mesh, self.spec(name))
