"""What the port needs of ``mxtpu/base.py``: the error class, the
numeric type tuples and the dtype-name table (the imperative frontend),
and the env-var helpers (telemetry and serving).

This is a copy, not an import: ``mxtpu`` is never imported by the port.
The table maps MXNet's dtype names to ``torch.dtype``; ``bfloat16`` is a
dtype like any other (numpy has none, so no numpy dtype stands for it).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as _np
import torch

__all__ = ["MXNetError", "numeric_types", "integer_types", "DTYPES",
           "dtype_torch", "dtype_name", "env_int", "env_bool", "env_str"]


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: ``dmlc::Error``)."""


numeric_types = (float, int, _np.generic)
integer_types = (int, _np.integer)

DTYPES: Dict[str, torch.dtype] = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def dtype_torch(dtype: Any) -> torch.dtype:
    """A dtype-ish value (None, a name, a numpy dtype or type, a
    ``torch.dtype``) as a ``torch.dtype``; None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name not in DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r} (have: "
                        f"{sorted(DTYPES)})")
    return DTYPES[name]


def dtype_name(dtype: Any) -> str:
    """Printable dtype name ('float32', 'bfloat16', ...)."""
    return _NAMES[dtype_torch(dtype)]


# ---------------------------------------------------------------------------
# Env-var knobs. ``doc`` documents the knob at its call site (the
# reference also keeps a registry of them; the port has no reader of
# one yet).
# ---------------------------------------------------------------------------
def env_int(name: str, default: int, doc: str = "") -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def env_bool(name: str, default: bool, doc: str = "") -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.lower() not in ("0", "false", "off", "")


def env_str(name: str, default: str, doc: str = "") -> str:
    return os.environ.get(name, default)
