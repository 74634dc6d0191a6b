"""Device meshes — the port of ``mxtpu/parallel/mesh.py`` (reference
device lists and KVStore topology, ``src/kvstore/comm.h``).

A mesh names six logical axes (``dp``, ``fsdp``, ``pp``, ``ep``, ``sp``,
``tp``, in that order: ``dp`` outermost) over the devices it spans. The
port runs one device per process, so a mesh spans the ranks of the
process group :func:`mxtpu_torch.parallel.dist.initialize` joined: it
holds a ``torch.distributed`` ``DeviceMesh`` on the group's device type
(``cuda`` over NCCL, ``cpu`` over gloo), and sharding on it is DTensor's
(:mod:`.sharding`). The ``DeviceMesh`` has a dim for each axis above 1,
in ``MESH_AXES`` order (``Mesh.dm_axes``; one dim of size 1 when every
axis is 1): an axis of size 1 splits nothing, and DTensor's sharding
search grows with the mesh's dims.

In a process with no group, a mesh whose axes are all 1 is a placement
on the one device (``Mesh.device_mesh`` is None): specs are checked but
split nothing. ``Mesh.device`` is then the device the mesh names, or
None for "the device the parameters already live on" (a mesh built
without ``devices``), so ``net.shard(create_mesh(dp=-1), rules)`` keeps
a net where it was initialized. An axis above 1 without a group raises.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from . import dist

__all__ = ["Mesh", "MeshConfig", "create_mesh", "current_mesh", "use_mesh",
           "mesh_axes", "axis_size", "MESH_AXES"]

# canonical axis order: dp outermost, tp innermost (the reference's)
MESH_AXES = ("dp", "fsdp", "pp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    """Logical parallelism layout. Unspecified axes default to 1;
    ``dp=-1`` absorbs the remaining devices (at most one axis may be
    -1)."""
    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in MESH_AXES}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"only one mesh axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, this process's device, and the
    ``DeviceMesh`` over the group's ranks (None for the one-device
    placement of a process without a group)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: Optional[torch.device] = None
    device_mesh: Any = None
    dm_axes: Tuple[str, ...] = ()

    @property
    def distributed(self) -> bool:
        """Whether sharding on this mesh is DTensor's."""
        return self.device_mesh is not None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def devices(self) -> Tuple[Optional[torch.device], ...]:
        return (self.device,)


def create_mesh(config: Optional[MeshConfig] = None,
                devices: Optional[Sequence] = None,
                **axis_sizes) -> Mesh:
    """``create_mesh(dp=2, tp=2)`` or ``create_mesh(MeshConfig(...))``.

    With a process group, the mesh spans its ranks (one device each,
    the group's: ``devices`` must be None). Without one it is the
    one-device placement on ``devices[0]`` (default: the device the
    parameters occupy), and every axis must resolve to 1."""
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis kwargs, not both")
    if dist.process_count() > 1 or dist.device() is not None:
        if devices is not None:
            raise ValueError(
                "a mesh over a process group spans its ranks, one device "
                "each; pass devices=None")
        sizes = config.resolve(dist.process_count())
        shape = tuple(sizes[a] for a in MESH_AXES)
        dm_axes = tuple(a for a in MESH_AXES if sizes[a] > 1) or MESH_AXES[:1]
        from torch.distributed.device_mesh import init_device_mesh
        dev = dist.device()
        dm = init_device_mesh(dev.type, tuple(sizes[a] for a in dm_axes),
                              mesh_dim_names=dm_axes)
        return Mesh(MESH_AXES, shape, dev, dm, dm_axes)
    devices = list(devices) if devices is not None else [None]
    if len(devices) != 1:
        raise ValueError(
            f"a mesh over {len(devices)} devices needs one process per "
            "device: call mxtpu_torch.parallel.dist.initialize in each")
    try:
        sizes = config.resolve(1)
    except ValueError as e:
        raise ValueError(
            f"{e}: without a process group a mesh is one device; call "
            "mxtpu_torch.parallel.dist.initialize in each of the mesh's "
            "processes first") from None
    device = devices[0]
    return Mesh(MESH_AXES, tuple(sizes[a] for a in MESH_AXES),
                None if device is None else torch.device(device))


_state = threading.local()


def current_mesh() -> Optional[Mesh]:
    """The mesh installed by :func:`use_mesh` (or None)."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Install ``mesh`` as the ambient mesh of this thread."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_axes(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    mesh = mesh or current_mesh()
    return tuple(mesh.axis_names) if mesh is not None else ()


def axis_size(axis: str, mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]
