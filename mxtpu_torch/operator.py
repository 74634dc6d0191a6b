"""``mx.operator`` — Python custom operators, the port of
``mxtpu/operator.py`` (reference ``python/mxnet/operator.py`` over
``src/operator/custom/custom.cc``).

A ``CustomOpProp`` registered under a name describes the op (arguments,
outputs, shape and type inference) and makes a ``CustomOp`` whose
``forward``/``backward`` run on the host as Python (typically numpy)
code; ``mx.nd.Custom(*inputs, op_type=name, **kwargs)`` (and
``mx.sym.Custom``) calls it. Each call is one ``torch.autograd.Function``
taken through the tape's funnel: the forward hands the op copies of the
inputs on their device and zero output arrays there, and the backward
hands it the output gradients and collects ``in_grad``, so
``autograd.record()``, a hybridized block on the CPU and the Executor
all differentiate through ``CustomOp.backward``, as the reference's
eager tape node and its ``custom_vjp`` do.

Where the port differs from the reference, deliberately: a ``Custom``
op inside a CUDA-graph capture (a hybridized block's or the Executor's
predict graph, ``Trainer.make_fused_step``) raises ``MXNetError``
naming the op: a host callback cannot be captured, so the block must
be called un-hybridized. The reference rejects host callbacks on its
chip the same way. Shape and type inference (``mx.sym``'s, on meta
tensors) use the prop's ``infer_shape``/``infer_type`` and run no
Python op.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Type

import numpy as _np
import torch

from . import autograd
from .base import MXNetError, dtype_name, dtype_torch
from .ndarray.ndarray import NDArray, apply_op
from .ndarray.ops import register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "Custom"]

_REGISTRY: Dict[str, Type["CustomOpProp"]] = {}


class CustomOp:
    """User op base (reference ``mx.operator.CustomOp``)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst: NDArray, req: str, src) -> None:
        """Write ``src`` (an NDArray or anything numpy takes) into ``dst``
        under ``req``: 'null' skips, 'add' accumulates, 'write' and
        'inplace' overwrite."""
        if req == "null":
            return
        dev = dst._data.device
        src_data = src._data.to(dev) if isinstance(src, NDArray) else \
            torch.as_tensor(_np.asarray(src), device=dev)
        if req == "add":
            dst._set_data(dst._data + src_data.to(dst.dtype))
        else:
            dst._set_data(src_data.to(dst.dtype).reshape(dst.shape))


class CustomOpProp:
    """Op metadata and factory (reference ``mx.operator.CustomOpProp``)."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def infer_storage_type(self, in_stype):
        return in_stype, ["default"] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Register a CustomOpProp subclass under a name (reference
    ``mx.operator.register``); invoke it with ``mx.nd.Custom(...,
    op_type=reg_name)``."""
    def deco(prop_cls: Type[CustomOpProp]):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get_all_registered() -> List[str]:
    return sorted(_REGISTRY)


def _np_dtype(dt: torch.dtype):
    """The dtype a prop sees: numpy's (bfloat16, which numpy lacks, as
    the torch dtype)."""
    return dt if dt == torch.bfloat16 else _np.dtype(dtype_name(dt))


def _capturing(device: torch.device) -> bool:
    """Whether work on ``device`` is being captured into a CUDA graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class _Call:
    """One ``Custom`` call: the prop, its op, and the inferred outputs."""

    def __init__(self, prop: CustomOpProp, op_type: str, xs):
        self.prop, self.op_type = prop, op_type
        self.n_in, self.n_out = len(xs), len(prop.list_outputs())
        in_shapes = [list(x.shape) for x in xs]
        in_dtypes = [_np_dtype(x.dtype) for x in xs]
        _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
        _, out_dtypes, _ = prop.infer_type(in_dtypes)
        self.out_specs = [(tuple(int(d) for d in s), dtype_torch(t))
                          for s, t in zip(out_shapes, out_dtypes)]
        self.in_shapes, self.in_dtypes = in_shapes, in_dtypes
        self.op = None

    def forward(self, xs, is_train):
        dev = xs[0].device if xs else torch.device("cpu")
        if _capturing(dev):
            raise MXNetError(
                f"Custom op {self.op_type!r} runs Python on the host and "
                "cannot be captured into a CUDA graph; call the block "
                "un-hybridized (or the Executor with is_train=True)")
        self.op = self.prop.create_operator(None, self.in_shapes,
                                            self.in_dtypes)
        self.in_data = [NDArray(x.detach().clone()) for x in xs]
        self.out_data = [NDArray(torch.zeros(s, dtype=t, device=dev))
                         for s, t in self.out_specs]
        self.op.forward(is_train, ["write"] * self.n_out, self.in_data,
                        self.out_data, [])
        return tuple(o._data.to(dev) for o in self.out_data)

    def backward(self, gs):
        out_grad = [NDArray(g.detach().clone()) for g in gs]
        in_grad = [NDArray(torch.zeros_like(x._data)) for x in self.in_data]
        self.op.backward(["write"] * self.n_in, out_grad, self.in_data,
                         self.out_data, in_grad, [])
        return tuple(g._data.to(x._data.device)
                     for g, x in zip(in_grad, self.in_data))


class _CustomFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, is_train, *xs):
        ctx.call = call
        return call.forward(xs, is_train)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + ctx.call.backward(gs)


@register_op("Custom")
def Custom(*inputs, op_type: Optional[str] = None, **kwargs):
    """Run a registered Python CustomOp (reference ``mx.nd.Custom``)."""
    if op_type is None or op_type not in _REGISTRY:
        raise MXNetError(f"custom op {op_type!r} is not registered "
                         f"(known: {get_all_registered()})")
    prop = _REGISTRY[op_type](**{k: str(v) for k, v in kwargs.items()})
    n_out = len(prop.list_outputs())

    def _f(*xs):
        call = _Call(prop, op_type, xs)
        if any(x.is_meta for x in xs):      # mx.sym's inference
            outs = tuple(torch.empty(s, dtype=t, device="meta")
                         for s, t in call.out_specs)
        else:
            outs = _CustomFn.apply(call, autograd.is_training(), *xs)
        return outs[0] if n_out == 1 else tuple(outs)
    return apply_op(_f, list(inputs), f"Custom[{op_type}]", n_out=n_out)
