"""Multi-process bootstrap — the port of ``mxtpu/parallel/dist.py``
(reference ``3rdparty/ps-lite/src/postoffice.cc`` Postoffice::Start and
the ``tools/launch.py`` DMLC_* environment protocol).

One role (worker) and a rendezvous, over
``torch.distributed.init_process_group``. The reference's DMLC_*
variables are honoured as aliases:

  DMLC_PS_ROOT_URI:PORT → coordinator_address (``tcp://URI:PORT``)
  DMLC_NUM_WORKER       → num_processes
  DMLC_WORKER_ID        → process_id

The backend follows the device the caller names: ``nccl`` for a card
(the default, :func:`mxtpu_torch.context.default_device`), ``gloo`` for
``device="cpu"``. One process without a coordinator is a no-op, as in
the reference; with a coordinator (or an ``init_method``) and
``num_processes=1`` it makes a one-rank group, which is how one card
gets a NCCL mesh. ``init_method`` takes any store URL
``torch.distributed`` accepts (``file://`` needs no port). Every wait
is bounded by ``timeout`` seconds.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as tdist

from ..context import DeviceLike, resolve_device

__all__ = ["initialize", "is_initialized", "process_index", "process_count",
           "local_devices", "shutdown", "device"]

_initialized = False
_group_started = False     # whether init_process_group actually ran
_device: Optional[torch.device] = None
DEFAULT_TIMEOUT = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, *, device: DeviceLike = None,
               init_method: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the job. ``local_device_ids`` picks this process's card
    (its first entry) when ``device`` is None; ``device="cpu"`` runs
    the group over ``gloo``."""
    global _initialized, _group_started, _device
    if _initialized:
        return
    if coordinator_address is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9091")
        if uri:
            coordinator_address = f"{uri}:{port}"
    if num_processes is None and "DMLC_NUM_WORKER" in os.environ:
        num_processes = int(os.environ["DMLC_NUM_WORKER"])
    if process_id is None and "DMLC_WORKER_ID" in os.environ:
        process_id = int(os.environ["DMLC_WORKER_ID"])
    if device is None and local_device_ids:
        device = torch.device("cuda", int(list(local_device_ids)[0]))
    if coordinator_address is None and init_method is None \
            and num_processes in (None, 1):
        _initialized = True          # one process: nothing to rendezvous
        return
    dev = resolve_device(device)
    if init_method is None:
        if coordinator_address is None:
            raise ValueError(
                f"{num_processes} processes need a coordinator_address "
                "(or DMLC_PS_ROOT_URI) or an init_method")
        init_method = f"tcp://{coordinator_address}"
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
        kw["device_id"] = dev       # binds the communicator eagerly
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    tdist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    _device, _group_started, _initialized = dev, True, True


def is_initialized() -> bool:
    return _initialized


def process_index() -> int:
    return tdist.get_rank() if _group_started else 0


def process_count() -> int:
    return tdist.get_world_size() if _group_started else 1


def device() -> Optional[torch.device]:
    """The device this process's group runs on (None without a group)."""
    return _device if _group_started else None


def local_devices() -> List[torch.device]:
    """This process's device: one per process."""
    return [_device] if _group_started else [resolve_device(None)]


def shutdown() -> None:
    global _initialized, _group_started, _device
    if _group_started and tdist.is_initialized():
        tdist.destroy_process_group()
    _group_started = False
    _initialized = False
    _device = None
