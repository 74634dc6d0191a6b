"""``mx.runtime``: the features this process has — the port of
``mxtpu/runtime.py``.

The reference reported build flags (USE_CUDA, USE_CUDNN, ...) and
``mxtpu`` probes jax; here each feature is probed once from torch:
CUDA is a visible card, CUDNN, NCCL, MKLDNN and OPENMP are torch's
backends, X64 and INT64_TENSOR_SIZE hold (torch computes in float64 and
indexes with int64 everywhere), IMAGE_CODEC is a codec header the native
IO library can build against (``mxtpu_torch.native``; nothing is built
to find it), DIST_KVSTORE waits for the kvstore (ROADMAP item 11b), and
TPU is false.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name: str, enabled: bool):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _probe() -> Dict[str, bool]:
    import torch
    from . import native
    cuda = torch.cuda.is_available()
    return {
        "TPU": False,
        "CPU": True,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": cuda and torch.distributed.is_available()
        and torch.distributed.is_nccl_available(),
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "OPENMP": torch.backends.openmp.is_available(),
        "BLAS_OPEN": True,
        "X64": True,
        "DIST_KVSTORE": False,
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": True,
        "PROFILER": True,
        "TUTORIALS_EXIST": False,
        "OPENCV": False,
        "IMAGE_CODEC": bool(native._codec_headers()),
        "F16C": False,
        "JEMALLOC": False,
    }


class Features(dict):
    """Dict of Feature (reference ``mx.runtime.Features``)."""

    instance = None

    def __new__(cls):
        if cls.instance is None:
            cls.instance = super().__new__(cls)
            cls.instance.update(
                {k: Feature(k, v) for k, v in _probe().items()})
        return cls.instance

    def __init__(self):
        pass

    def __repr__(self):
        return "[" + ", ".join(repr(v) for v in self.values()) + "]"

    def is_enabled(self, name: str) -> bool:
        feat = self.get(name.upper())
        return bool(feat and feat.enabled)


def feature_list():
    return list(Features().values())
