"""The deploy path, the port of ``mxtpu/contrib/deploy.py``: load and
run the artifacts ``HybridBlock.export_stablehlo`` writes, without the
model's Python class (the reference's C predict API). The artifact is
a ``torch.export`` archive (``.pt2``) with the weights baked in; its
graph calls the port's kernel operators, so loading imports only
``mxtpu_torch.ops``, which defines them.
"""
from __future__ import annotations

import torch
import torch.export.passes

from .. import ops  # noqa: F401  (defines the mxtpu_torch:: operators)
from ..context import resolve_device
from ..ndarray import NDArray

__all__ = ["load", "Predictor"]


def load(path: str, ctx=None) -> "Predictor":
    """Load a ``.pt2`` artifact into a callable Predictor whose weights
    lie on ``ctx`` (None: the innermost ``with ctx:`` scope, else the
    card)."""
    program = torch.export.load(path)
    dev = resolve_device(ctx)
    program = torch.export.passes.move_to_device_pass(program, dev)
    return Predictor(program, dev)


class Predictor:
    """Callable over NDArrays (the reference's PredictorHandle): the
    exported program, weights baked in, on one device."""

    def __init__(self, program, device):
        self._program = program
        self._module = program.module()
        self.device = device

    def __call__(self, *inputs):
        datas = [x._data if isinstance(x, NDArray) else x for x in inputs]
        with torch.no_grad():
            outs = self._module(*datas)
        res = tuple(NDArray(o) for o in outs)
        return res[0] if len(res) == 1 else res
