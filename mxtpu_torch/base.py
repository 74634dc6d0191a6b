"""What the port needs of ``mxtpu/base.py``: the error class, the
numeric type tuples and the dtype-name table (the imperative frontend),
the env-var knobs and their registry (telemetry and serving), and
``atomic_write`` (the flight recorder's crash dump).

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
           "dtype_torch", "dtype_name", "env_int", "env_bool", "env_str",
           "env_float", "registered_env_vars", "atomic_write"]


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
# Env-var knobs. Every knob a helper reads is registered with its default
# and ``doc``, so :func:`registered_env_vars` is the one documented list of
# what the port reads (the reference's ``mxtpu/base.py`` keeps the same).
# ---------------------------------------------------------------------------
_ENV_REGISTRY: Dict[str, Dict[str, Any]] = {}


def _register(name: str, default: Any, doc: str) -> None:
    _ENV_REGISTRY.setdefault(name, {"default": default, "doc": doc})


def env_int(name: str, default: int, doc: str = "") -> int:
    _register(name, default, doc)
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def env_bool(name: str, default: bool, doc: str = "") -> bool:
    _register(name, default, doc)
    val = os.environ.get(name)
    if val is None:
        return default
    return val.lower() not in ("0", "false", "off", "")


def env_str(name: str, default: str, doc: str = "") -> str:
    _register(name, default, doc)
    return os.environ.get(name, default)


def env_float(name: str, default: float, doc: str = "") -> float:
    _register(name, default, doc)
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def registered_env_vars() -> Dict[str, Dict[str, Any]]:
    """All env vars the port has read so far, with defaults and docs."""
    return dict(_ENV_REGISTRY)


def atomic_write(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically: a temp file in the same
    directory, fsync, then ``os.replace``, so a kill mid-write leaves
    either the whole old file or the whole new one, never a torn mix."""
    import tempfile
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
