"""Weight carry: ``mxtpu``'s parameter trees as numpy arrays <-> the
port's trees of tensors. Shared by every model of the port."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..context import DeviceLike, resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None):
    """A tree of numpy arrays (``mxtpu``'s keys and layout, e.g.
    ``jax.tree.map(np.asarray, params)``): nested dicts, and lists of
    per-layer dicts where a model does not stack its layers → the same
    tree of tensors on ``device``; ``dtype`` casts floating leaves.
    Without ``dtype`` the values are carried bit for bit."""
    device = resolve_device(device)

    def conv(a):
        t = torch.tensor(np.asarray(a))     # a copy: jax's arrays are read-only
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return conv(v)

    return walk(tree)


def params_to_numpy(params):
    """The port's tree → the same tree of numpy arrays (dicts and lists
    kept). A bf16 leaf comes back as float32, which numpy can hold
    exactly."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
