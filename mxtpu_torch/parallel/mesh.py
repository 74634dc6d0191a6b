"""Device meshes, their one-device subset — the port of
``mxtpu/parallel/mesh.py`` (reference device lists and KVStore
topology, ``src/kvstore/comm.h``).

A mesh names up to six logical axes (``dp``, ``fsdp``, ``pp``, ``ep``,
``sp``, ``tp``) over the devices it spans. The port runs one device per
process, so a mesh here is a placement on that one device: every axis
resolves to 1 (``create_mesh(dp=-1)`` absorbs the one device), and an
axis above 1 raises, naming ROADMAP Queue A item 11, which brings
meshes across cards. ``Mesh.device`` is the device the mesh names, or
None for "the device the parameters already live on" (a mesh built
without ``devices``), so ``net.shard(create_mesh(dp=-1), rules)`` keeps
a net where it was initialized, on the card or on the CPU.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh", "MeshConfig", "create_mesh", "current_mesh", "use_mesh",
           "mesh_axes", "axis_size", "MESH_AXES", "MULTI_DEVICE_SLICE"]

MESH_AXES = ("dp", "fsdp", "pp", "ep", "sp", "tp")
MULTI_DEVICE_SLICE = ("a mesh over more than one device comes with the "
                      "multi-device slice (ROADMAP Queue A item 11)")


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
    """A one-device mesh: its axis sizes (all 1) and its device."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: Optional[torch.device] = None

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
    """``create_mesh(dp=-1)`` or ``create_mesh(MeshConfig(...))`` over
    ``devices`` (default: the one device the parameters occupy)."""
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis kwargs, not both")
    devices = list(devices) if devices is not None else [None]
    explicit = [a for a in MESH_AXES if getattr(config, a) not in (1, -1)]
    if len(devices) != 1 or explicit:
        raise NotImplementedError(
            f"{MULTI_DEVICE_SLICE} (asked for {len(devices)} devices, axes "
            f"{ {a: getattr(config, a) for a in explicit} })")
    sizes = config.resolve(1)
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
