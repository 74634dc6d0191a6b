"""The ``mx.nd.*`` operator namespace — the port of ``mxtpu/ndarray/ops.py``.

Every op is registered in ``OP_REGISTRY`` under its MXNet name and
aliases, as the reference registers them, and funnels its math through
:func:`mxtpu_torch.ndarray.ndarray.apply_op`, the tape's single entry:
a raw function of tensors, run plainly, or under ``record()`` on
detached inputs whose pullback is one ``torch.autograd.grad``.

The math is PyTorch's on tensors: elementwise ops and reductions are
``torch`` calls, ``Convolution``/``Deconvolution`` are ``F.conv*d`` and
``F.conv_transpose*d`` (cuDNN on the card; the reference lowers them to
XLA's convolution, not to a Pallas kernel), pooling pads explicitly and
pools without padding (the reference's ``reduce_window`` over a padded
array, so the ``full`` convention keeps its own window count), and the
recurrences (``ctc_loss``, ``RNN``) are Python loops over time where
the reference scans.

``ops_extended`` registers the rest of the reference's op set (vision
ops, ``linalg_*``, the update ops, the ``sample_*`` ops, ...).
"""
from __future__ import annotations

import builtins
import functools
import math
from builtins import slice as builtins_slice
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from .. import autograd, prng, xla_math
from ..base import dtype_torch
from .ndarray import (NDArray, apply_op, array, _index, _norm, _arg, _prod,
                      _all_axes)
from .ndarray import concat as _nd_concat, stack as _nd_stack, \
    full as _nd_full

__all__ = ["OP_REGISTRY", "register_op"]

OP_REGISTRY: Dict[str, Callable] = {}


def register_op(name: str, aliases=()):
    """Register an op. The wrapped python fn takes NDArrays + params and
    returns NDArray(s); it must route math through apply_op."""
    def deco(fn):
        for n in (name,) + tuple(aliases):
            OP_REGISTRY[n] = fn
            globals()[n] = fn
            if n not in __all__:
                __all__.append(n)
        return fn
    return deco


def _tensor(b, like: torch.Tensor) -> torch.Tensor:
    """A scalar operand as a 0-d tensor on ``like``'s device (torch's
    promotion then treats it as a scalar, as jax treats a weak type)."""
    if isinstance(b, torch.Tensor):
        return b
    return torch.as_tensor(b, device=like.device)


def _unary(name, raw, aliases=()):
    @register_op(name, aliases)
    def op(data, **kwargs):
        return apply_op(raw, [data], name)
    op.__name__ = name
    return op


def _binary_broadcast(name, raw, aliases=()):
    @register_op(name, aliases)
    def op(lhs, rhs, **kwargs):
        if isinstance(rhs, NDArray):
            return apply_op(raw, [lhs, rhs], name)
        return apply_op(lambda x: raw(x, rhs), [lhs], name)
    op.__name__ = name
    return op


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _softrelu(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class _Lgamma(torch.autograd.Function):
    """``lgamma`` with ``digamma`` as its derivative; in float32 at x >=
    0.5 both as XLA expands them (the reference's ``gammaln`` and its
    gradient), elsewhere torch's."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.dtype != torch.float32:
            return torch.lgamma(x)
        return torch.where(x >= 0.5, xla_math.lgamma(x), torch.lgamma(x))

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        if x.dtype != torch.float32:
            return g * torch.digamma(x)
        return g * torch.where(x >= 0.5, xla_math.digamma(x),
                               torch.digamma(x))


def _float_of(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


# -- elementwise unary (reference src/operator/tensor/elemwise_unary_op*) ----
_unary("negative", torch.neg)
_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("round", torch.round)
_unary("rint", lambda x: torch.round(x) if x.is_floating_point()
       else x.to(torch.float32))
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("expm1", torch.expm1)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("reciprocal", torch.reciprocal)
_unary("erf", torch.special.erf)
_unary("erfinv", torch.special.erfinv)
_unary("gamma", lambda x: torch.exp(_Lgamma.apply(x)))
_unary("gammaln", _Lgamma.apply)
_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", F.softsign)
_unary("logical_not", lambda x: (x == 0).to(x.dtype))
_unary("zeros_like", torch.zeros_like)
_unary("ones_like", torch.ones_like)
_unary("identity", lambda x: x, aliases=("copy",))
_unary("stop_gradient", torch.Tensor.detach, aliases=("BlockGrad",))
_unary("make_loss", lambda x: x, aliases=("MakeLoss",))
_unary("isnan", lambda x: _float_of(torch.isnan(x)))
_unary("isinf", lambda x: _float_of(torch.isinf(x)))
_unary("isfinite", lambda x: _float_of(torch.isfinite(x)))


# -- elementwise binary with numpy broadcasting (broadcast_* family) ---------
def _tensor_op(fn):
    """``fn`` of two tensors, taking a scalar for either operand."""
    def op(a, b):
        if not isinstance(a, torch.Tensor):
            a = _tensor(a, b)
        return fn(a, _tensor(b, a))
    return op


_binary_broadcast("broadcast_add", torch.add, aliases=("elemwise_add", "add"))
_binary_broadcast("broadcast_sub", torch.sub,
                  aliases=("elemwise_sub", "subtract", "broadcast_minus"))
_binary_broadcast("broadcast_mul", torch.mul,
                  aliases=("elemwise_mul", "multiply"))
_binary_broadcast("broadcast_div", torch.true_divide,
                  aliases=("elemwise_div", "divide"))
_binary_broadcast("broadcast_mod", torch.remainder, aliases=("modulo",))
_binary_broadcast("broadcast_power", torch.pow, aliases=("power",))
_binary_broadcast("broadcast_maximum", _tensor_op(torch.maximum),
                  aliases=("maximum",))
_binary_broadcast("broadcast_minimum", _tensor_op(torch.minimum),
                  aliases=("minimum",))
_binary_broadcast("broadcast_hypot", _tensor_op(torch.hypot),
                  aliases=("hypot",))
_binary_broadcast("arctan2", _tensor_op(torch.atan2))


def _as_operand_dtype(fn):
    """A comparison or logical op returning 0/1 in the first operand's
    dtype (float32 for bool operands), as the reference casts."""
    def op(a, b):
        like = a if isinstance(a, torch.Tensor) else b
        dt = like.dtype if like.dtype != torch.bool else torch.float32
        return _tensor_op(fn)(a, b).to(dt)
    return op


for _nm, _raw in [("equal", torch.eq), ("not_equal", torch.ne),
                  ("greater", torch.gt), ("greater_equal", torch.ge),
                  ("lesser", torch.lt), ("lesser_equal", torch.le),
                  ("logical_and", torch.logical_and),
                  ("logical_or", torch.logical_or),
                  ("logical_xor", torch.logical_xor)]:
    _binary_broadcast("broadcast_" + _nm, _as_operand_dtype(_raw),
                      aliases=(_nm,))


# -- reductions (src/operator/tensor/broadcast_reduce_op_value*) -------------
def _dims(x, axis):
    return _all_axes(axis, x.ndim) if axis is not None else \
        tuple(range(x.ndim))


def _mean(x, axis, keepdims):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdims)


def _nanprod(x, axis, keepdims):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), axis,
                 keepdims)


def _reduce_op(name, raw, aliases=()):
    @register_op(name, aliases)
    def op(data, axis=None, keepdims=False, exclude=False, **kwargs):
        if exclude and axis is not None:
            ax = axis if isinstance(axis, (list, tuple)) else (axis,)
            axis = tuple(i for i in range(data.ndim) if i not in
                         tuple(a % data.ndim for a in ax))
        if isinstance(axis, list):
            axis = tuple(axis)
        return apply_op(lambda x: raw(x, axis, keepdims), [data], name)
    op.__name__ = name
    return op


_reduce_op("sum", lambda x, axis, keepdims: torch.sum(
    x, dim=_dims(x, axis), keepdim=keepdims), aliases=("sum_axis",))
_reduce_op("mean", _mean)
_reduce_op("prod", _prod)
_reduce_op("nansum", lambda x, axis, keepdims: torch.nansum(
    x, dim=_dims(x, axis), keepdim=keepdims))
_reduce_op("nanprod", _nanprod)
_reduce_op("max", lambda x, axis, keepdims: torch.amax(
    x, dim=_dims(x, axis), keepdim=keepdims), aliases=("max_axis",))
_reduce_op("min", lambda x, axis, keepdims: torch.amin(
    x, dim=_dims(x, axis), keepdim=keepdims), aliases=("min_axis",))


@register_op("norm")
def norm(data, ord=2, axis=None, keepdims=False, **kwargs):
    return apply_op(lambda x: _norm(x, ord, axis, keepdims), [data], "norm")


@register_op("argmax")
def argmax(data, axis=None, keepdims=False, **kwargs):
    return apply_op(lambda x: _arg(torch.argmax, x, axis, keepdims),
                    [data], "argmax")


@register_op("argmin")
def argmin(data, axis=None, keepdims=False, **kwargs):
    return apply_op(lambda x: _arg(torch.argmin, x, axis, keepdims),
                    [data], "argmin")


@register_op("topk")
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32", **kwargs):
    """``dtype`` is the index dtype (float32 rounds indices past 2^24,
    as the reference's default does)."""
    idt = dtype_torch(dtype)

    def _f(x):
        vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                               sorted=True)
        if ret_typ == "value":
            return vals
        if ret_typ == "both":
            return (vals, idx.to(idt))
        return idx.to(idt)
    n_out = 2 if ret_typ == "both" else 1
    return apply_op(_f, [data], "topk", n_out=n_out)


@register_op("sort")
def sort(data, axis=-1, is_ascend=True, **kwargs):
    def _f(x):
        s = torch.sort(x, dim=axis, stable=True).values
        return s if is_ascend else torch.flip(s, dims=(axis,))
    return apply_op(_f, [data], "sort")


@register_op("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32", **kwargs):
    def _f(x):
        s = torch.argsort(x, dim=axis, stable=True)
        if not is_ascend:
            s = torch.flip(s, dims=(axis,))
        return s.to(dtype_torch(dtype))
    return apply_op(_f, [data], "argsort")


# -- shape ops (src/operator/tensor/matrix_op*) ------------------------------
@register_op("reshape", aliases=("Reshape",))
def reshape(data, shape, reverse=False, **kwargs):
    return data.reshape(shape)


@register_op("transpose")
def transpose(data, axes=None, **kwargs):
    return data.transpose(axes if axes else None)


@register_op("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0, **kwargs):
    return data.swapaxes(dim1, dim2)


@register_op("expand_dims")
def expand_dims(data, axis, **kwargs):
    return data.expand_dims(axis)


@register_op("squeeze")
def squeeze(data, axis=None, **kwargs):
    return data.squeeze(axis)


@register_op("flatten", aliases=("Flatten",))
def flatten(data, **kwargs):
    return data.flatten()


@register_op("broadcast_to")
def broadcast_to(data, shape, **kwargs):
    shape = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.broadcast_to(shape)


@register_op("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis, size, **kwargs):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(axes, sizes):
        shape[a] = s
    return data.broadcast_to(tuple(shape))


@register_op("slice")
def slice(data, begin, end, step=None, **kwargs):  # noqa: A001
    idx = tuple(builtins_slice(b, e, s) for b, e, s in
                zip(begin, end, step or [None] * len(begin)))
    return apply_op(lambda x: _index(x, idx), [data], "slice")


@register_op("slice_axis")
def slice_axis(data, axis, begin, end, **kwargs):
    if end is None:
        end = data.shape[axis]
    return data.slice_axis(axis, begin, end)


@register_op("slice_like")
def slice_like(data, shape_like, axes=None, **kwargs):
    tgt = shape_like.shape
    idx = [builtins_slice(None)] * data.ndim
    axes = axes if axes else range(builtins.min(data.ndim, len(tgt)))
    for a in axes:
        idx[a] = builtins_slice(0, tgt[a])
    idx = tuple(idx)
    return apply_op(lambda x: x[idx], [data], "slice_like")


@register_op("concat", aliases=("Concat",))
def concat_op(*data, dim=1, **kwargs):
    return _nd_concat(*data, dim=dim)


@register_op("stack")
def stack_op(*data, axis=0, **kwargs):
    return _nd_stack(*data, axis=axis)


@register_op("split", aliases=("SliceChannel",))
def split(data, num_outputs, axis=1, squeeze_axis=False, **kwargs):
    def _f(x):
        parts = torch.chunk(x, num_outputs, dim=axis)
        if len(parts) != num_outputs or \
                x.shape[axis] % num_outputs:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {x.shape[axis]} into "
                             f"{num_outputs}")
        if squeeze_axis:
            parts = [p.squeeze(axis) for p in parts]
        return tuple(parts) if num_outputs > 1 else parts[0]
    out = apply_op(_f, [data], "split", n_out=num_outputs)
    return out if num_outputs > 1 else (out,)


@register_op("tile")
def tile(data, reps, **kwargs):
    return data.tile(reps)


@register_op("repeat")
def repeat(data, repeats, axis=None, **kwargs):
    return data.repeat(repeats, axis)


@register_op("flip", aliases=("reverse",))
def flip(data, axis, **kwargs):
    dims = (axis,) if isinstance(axis, int) else tuple(axis)
    return apply_op(lambda x: torch.flip(x, dims=dims), [data], "flip")


def _pad_index(n: int, before: int, after: int, mode: str, device):
    """The source index of each output position along one padded dim:
    numpy's ``edge`` clamps, ``reflect`` mirrors without the edge."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


@register_op("pad", aliases=("Pad",))
def pad(data, mode="constant", pad_width=None, constant_value=0, **kwargs):
    # MXNet pad_width is a flat tuple (before0, after0, before1, after1, ...)
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    if mode not in ("constant", "edge", "reflect"):
        raise KeyError(mode)

    def _f(x):
        if mode == "constant":
            flat = [p for b, a in reversed(pw) for p in (b, a)]
            return F.pad(x, flat, mode="constant", value=constant_value)
        for d, (b, a) in enumerate(pw):
            if b or a:
                x = torch.index_select(
                    x, d, _pad_index(x.shape[d], b, a, mode, x.device))
        return x
    return apply_op(_f, [data], "pad")


@register_op("clip")
def clip(data, a_min=None, a_max=None, **kwargs):
    return data.clip(a_min, a_max)


@register_op("cast", aliases=("Cast", "amp_cast"))
def cast(data, dtype, **kwargs):
    return data.astype(dtype)


@register_op("shape_array")
def shape_array(data, **kwargs):
    return array(list(data.shape), ctx=data.context, dtype="int64")


@register_op("size_array")
def size_array(data, **kwargs):
    return array([data.size], ctx=data.context, dtype="int64")


@register_op("diag")
def diag(data, k=0, **kwargs):
    return apply_op(lambda x: torch.diag(x, k) if x.ndim <= 2
                    else torch.diagonal(x, k, -2, -1), [data], "diag")


@register_op("where")
def where(condition, x, y, **kwargs):
    return apply_op(lambda c, a, b: torch.where(c.to(torch.bool), a, b),
                    [condition, x, y], "where")


# -- linalg (src/operator/tensor/dot-inl.h, la_op*) --------------------------
@register_op("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kwargs):
    def _f(a, b):
        if transpose_a:
            a = a.T if a.ndim <= 2 else torch.movedim(a, 0, -1)
        if transpose_b:
            b = b.T if b.ndim <= 2 else torch.movedim(b, -1, 0)
        if a.ndim == 1 and b.ndim == 1:
            return torch.dot(a, b)
        # MXNet dot: contract last axis of a with first axis of b
        return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))
    return apply_op(_f, [lhs, rhs], "dot")


@register_op("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **kwargs):
    def _f(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op(_f, [lhs, rhs], "batch_dot")


@register_op("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 **kwargs):
    def _f(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return alpha * torch.matmul(a, b)
    return apply_op(_f, [A, B], "linalg_gemm2")


@register_op("linalg_potrf")
def linalg_potrf(A, **kwargs):
    return apply_op(torch.linalg.cholesky, [A], "linalg_potrf")


@register_op("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0, **kwargs):
    def _f(a):
        at = a.transpose(-1, -2)
        return alpha * (torch.matmul(at, a) if transpose
                        else torch.matmul(a, at))
    return apply_op(_f, [A], "linalg_syrk")


@register_op("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **kwargs):
    def _f(a, b):
        a2 = a.transpose(-1, -2) if transpose else a
        low = lower != transpose
        if rightside:
            x = torch.linalg.solve_triangular(
                a2.transpose(-1, -2), b.transpose(-1, -2), upper=low)
            return alpha * x.transpose(-1, -2)
        return alpha * torch.linalg.solve_triangular(a2, b, upper=not low)
    return apply_op(_f, [A, B], "linalg_trsm")


# -- indexing (src/operator/tensor/indexing_op*) -----------------------------
@register_op("take")
def take(a, indices, axis=0, mode="clip", **kwargs):
    def _f(x, idx):
        n = x.shape[axis]
        idx = idx.to(torch.int64)
        idx = idx.clamp(0, n - 1) if mode == "clip" \
            else torch.remainder(idx, n)
        out = torch.index_select(x, axis, idx.reshape(-1))
        ax = axis % x.ndim
        return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])
    return apply_op(_f, [a, indices], "take")


@register_op("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip", **kwargs):
    def _f(x, idx):
        out = torch.gather(x, axis, idx.to(torch.int64).unsqueeze(axis))
        return out if keepdims else out.squeeze(axis)
    return apply_op(_f, [data, index], "pick")


@register_op("gather_nd")
def gather_nd(data, indices, **kwargs):
    def _f(x, idx):
        idx = idx.to(torch.int64)
        return x[tuple(idx[i] for i in range(idx.shape[0]))]
    return apply_op(_f, [data, indices], "gather_nd")


@register_op("scatter_nd")
def scatter_nd(data, indices, shape, **kwargs):
    def _f(d, idx):
        idx = idx.to(torch.int64)
        out = torch.zeros(tuple(shape), dtype=d.dtype, device=d.device)
        return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), d,
                             accumulate=True)
    return apply_op(_f, [data, indices], "scatter_nd")


def _hot(idx: torch.Tensor, depth: int, axis: int = -1) -> torch.Tensor:
    """Boolean one-hot of ``idx`` along ``axis``; indices outside [0,
    depth) give all-false rows, as ``jax.nn.one_hot`` does."""
    idx = idx.to(torch.int64).unsqueeze(axis)
    shape = [1] * idx.ndim
    shape[axis] = depth
    return idx == torch.arange(depth, device=idx.device).reshape(shape)


@register_op("one_hot")
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32",
            **kwargs):
    dt = dtype_torch(dtype)

    def _f(x):
        return _hot(x, depth).to(dt) * (on_value - off_value) + off_value
    return apply_op(_f, [indices], "one_hot")


@register_op("Embedding", aliases=("embedding",))
def Embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False, **kwargs):
    """Embedding lookup (reference src/operator/tensor/indexing_op.cc)."""
    def _f(idx, w):
        idx = idx.to(torch.int64)
        return torch.index_select(w, 0, idx.reshape(-1)).reshape(
            idx.shape + w.shape[1:])
    return apply_op(_f, [data, weight], "Embedding")


@register_op("sequence_mask", aliases=("SequenceMask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0, **kwargs):
    if not use_sequence_length or sequence_length is None:
        return data

    def _f(x, slen):
        T = x.shape[axis]
        shape = [1] * x.ndim
        shape[axis] = T
        pos = torch.arange(T, device=x.device).reshape(shape)
        bshape = [1] * x.ndim
        bshape[1 - axis] = x.shape[1 - axis]
        sl = slen.reshape(bshape)
        return torch.where(pos < sl, x, torch.full((), value, dtype=x.dtype,
                                                   device=x.device))
    return apply_op(_f, [data, sequence_length], "sequence_mask")


@register_op("sequence_last", aliases=("SequenceLast",))
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0, **kwargs):
    if not use_sequence_length or sequence_length is None:
        return apply_op(lambda x: x.select(axis, x.shape[axis] - 1),
                        [data], "sequence_last")

    def _f(x, slen):
        idx = (slen - 1).to(torch.int64)
        xm = torch.movedim(x, axis, 0)
        return xm[idx, torch.arange(xm.shape[1], device=x.device)]
    return apply_op(_f, [data, sequence_length], "sequence_last")


@register_op("sequence_reverse", aliases=("SequenceReverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0, **kwargs):
    if not use_sequence_length or sequence_length is None:
        return apply_op(lambda x: torch.flip(x, dims=(axis,)), [data],
                        "sequence_reverse")

    def _f(x, slen):
        T = x.shape[axis]
        xm = torch.movedim(x, axis, 0)          # (T, B, ...)
        pos = torch.arange(T, device=x.device)[:, None]
        sl = slen.to(torch.int64)[None, :]
        rev = torch.where(pos < sl, sl - 1 - pos, pos)
        rev = rev.reshape(rev.shape + (1,) * (xm.ndim - 2)).expand(xm.shape)
        return torch.movedim(torch.gather(xm, 0, rev), 0, axis)
    return apply_op(_f, [data, sequence_length], "sequence_reverse")


# -- neural-net ops (reference src/operator/nn/) -----------------------------
@register_op("FullyConnected", aliases=("fully_connected",))
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True, **kwargs):
    """y = x·Wᵀ + b (reference src/operator/nn/fully_connected.cc)."""
    arrs = [data, weight] + ([] if no_bias or bias is None else [bias])

    def _f(x, w, *b):
        if flatten:
            x = x.reshape(x.shape[0], -1)
        y = torch.matmul(x, w.T)
        if b:
            y = y + b[0]
        return y
    return apply_op(_f, arrs, "FullyConnected")


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": _softrelu,
                "softsign": F.softsign}


@register_op("Activation", aliases=("activation",))
def Activation(data, act_type="relu", **kwargs):
    return apply_op(_ACTIVATIONS[act_type], [data],
                    f"Activation[{act_type}]")


@register_op("LeakyReLU")
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334, **kwargs):
    if act_type in ("leaky", "rrelu"):
        return apply_op(lambda x: torch.where(x >= 0, x, slope * x), [data],
                        "LeakyReLU")
    if act_type == "elu":
        return apply_op(lambda x: F.elu(x, slope), [data], "elu")
    if act_type == "selu":
        return apply_op(torch.selu, [data], "selu")
    if act_type == "gelu":
        return apply_op(F.gelu, [data], "gelu")
    if act_type == "prelu":
        return apply_op(lambda x, g: torch.where(x >= 0, x, g * x),
                        [data, gamma], "prelu")
    raise ValueError(f"unknown act_type {act_type}")


@register_op("softmax")
def softmax(data, axis=-1, temperature=None, length=None, **kwargs):
    def _f(x):
        z = x / temperature if temperature else x
        return torch.softmax(z, dim=axis)
    return apply_op(_f, [data], "softmax")


@register_op("log_softmax")
def log_softmax(data, axis=-1, temperature=None, **kwargs):
    def _f(x):
        z = x / temperature if temperature else x
        return torch.log_softmax(z, dim=axis)
    return apply_op(_f, [data], "log_softmax")


@register_op("softmin")
def softmin(data, axis=-1, **kwargs):
    return apply_op(lambda x: torch.softmax(-x, dim=axis), [data], "softmin")


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax; the backward ignores the head gradient and
    injects (softmax - one_hot(label)) * grad_scale, as the reference's
    hard-coded backward does."""

    @staticmethod
    def forward(ctx, x, label, axis, grad_scale, ignore_label, use_ignore,
                normalization):
        out = torch.softmax(x, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.opts = (axis, grad_scale, ignore_label, use_ignore,
                    normalization)
        return out

    @staticmethod
    def backward(ctx, g):
        out, lab = ctx.saved_tensors
        axis, grad_scale, ignore_label, use_ignore, normalization = ctx.opts
        oh = _hot(lab, out.shape[axis], axis).to(out.dtype)
        gx = (out - oh) * grad_scale
        valid = (lab != ignore_label).to(out.dtype)
        if use_ignore:
            gx = gx * valid.unsqueeze(axis)
        if normalization == "batch":
            gx = gx / out.shape[0]
        elif normalization == "valid":
            cnt = torch.clamp_min(valid.sum(), 1.0) if use_ignore else \
                torch.tensor(float(lab.numel()), dtype=out.dtype)
            gx = gx / cnt
        return gx, None, None, None, None, None, None


@register_op("SoftmaxOutput", aliases=("softmax_output",))
def SoftmaxOutput(data, label=None, grad_scale=1.0, ignore_label=-1,
                  use_ignore=False, multi_output=False,
                  normalization="null", **kwargs):
    """Legacy combined softmax + cross-entropy-gradient op (reference
    src/operator/softmax_output.cc). ``normalization``: 'null' (sum over
    batch, reference default), 'batch' (divide by batch size), 'valid'
    (divide by non-ignored count)."""
    if label is None:
        return softmax(data, axis=-1)
    axis = 1 if multi_output else -1
    return apply_op(
        lambda x, lab: _SoftmaxOutput.apply(
            x, lab, axis, grad_scale, ignore_label, use_ignore,
            normalization), [data, label], "SoftmaxOutput")


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register_op("Convolution", aliases=("convolution",))
def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **kwargs):
    """N-D convolution, NCHW layout like the reference
    (src/operator/nn/convolution.cc), through ``F.conv*d`` (cuDNN on
    the card). Mixed operand dtypes convolve in the promoted dtype and
    come back in the activation's, as the reference's do."""
    nd = len(kernel) if kernel else (data.ndim - 2)
    stride = tuple(stride) if stride else (1,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    pad_ = tuple(pad) if pad else (0,) * nd
    arrs = [data, weight] + ([] if no_bias or bias is None else [bias])

    def _f(x, w, *b):
        ct = torch.promote_types(x.dtype, w.dtype)
        y = _CONV[nd](x.to(ct), w.to(ct), None, stride, pad_, dilate,
                      num_group)
        if b:
            y = y + b[0].reshape((1, -1) + (1,) * nd)
        return y.to(x.dtype)
    return apply_op(_f, arrs, "Convolution")


@register_op("Deconvolution", aliases=("deconvolution",))
def Deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=True, **kwargs):
    """Transposed convolution (reference src/operator/nn/deconvolution.cc);
    the (in, out/group, ...) weight is ``F.conv_transpose*d``'s layout."""
    nd = len(kernel)
    stride = tuple(stride) if stride else (1,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    pad_ = tuple(pad) if pad else (0,) * nd
    adj = tuple(adj) if adj else (0,) * nd
    arrs = [data, weight] + ([] if no_bias or bias is None else [bias])

    def _f(x, w, *b):
        y = _DECONV[nd](x, w, None, stride, pad_, adj, num_group, dilate)
        if b:
            y = y + b[0].reshape((1, -1) + (1,) * nd)
        return y
    return apply_op(_f, arrs, "Deconvolution")


def _window_sum(x, kernel, stride):
    """Sum over each pooling window of an already padded ``x``."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register_op("Pooling", aliases=("pooling",))
def Pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, **kwargs):
    """Pooling (reference src/operator/nn/pooling.cc), NC+spatial layout:
    the input padded explicitly (-inf for max, 0 otherwise; the ``full``
    convention extends the high side so the last partial window is
    kept), then pooled without padding."""
    nd = data.ndim - 2
    if global_pool:
        ax = tuple(range(2, 2 + nd))
        raw = {"max": lambda x: torch.amax(x, dim=ax, keepdim=True),
               "avg": lambda x: torch.mean(x, dim=ax, keepdim=True),
               "sum": lambda x: torch.sum(x, dim=ax, keepdim=True)
               }[pool_type]
        return apply_op(raw, [data], "GlobalPooling")
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else kernel
    pad_ = tuple(pad) if pad else (0,) * nd
    lo_hi = [[p, p] for p in pad_]
    if pooling_convention == "full":
        for i, (k, s, p) in enumerate(zip(kernel, stride, pad_)):
            in_dim = data.shape[2 + i]
            out_dim = int(math.ceil((in_dim + 2 * p - k) / s)) + 1
            need = (out_dim - 1) * s + k - in_dim - p
            lo_hi[i][1] = builtins.max(need, p)
    flat = [p for lo, hi in reversed(lo_hi) for p in (lo, hi)]

    def _f(x):
        if pool_type == "max":
            fill = -math.inf if x.is_floating_point() \
                else torch.iinfo(x.dtype).min
            xp = F.pad(x, flat, mode="constant", value=fill)
            return _MAX_POOL[nd](xp, kernel, stride)
        s = _window_sum(F.pad(x, flat, mode="constant", value=0), kernel,
                        stride)
        if pool_type == "sum":
            return s
        if count_include_pad:
            return s / math.prod(kernel)
        ones = F.pad(torch.ones_like(x), flat, mode="constant", value=0)
        return s / _window_sum(ones, kernel, stride)
    return apply_op(_f, [data], f"Pooling[{pool_type}]")


@register_op("BatchNorm", aliases=("batch_norm",))
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=False, use_global_stats=False,
              output_mean_var=False, axis=1, **kwargs):
    """BatchNorm forward (reference src/operator/nn/batch_norm.cc): batch
    statistics under ``autograd.is_training()`` (unless
    ``use_global_stats``), the moving ones otherwise. The running-stat
    update belongs to ``gluon.nn.BatchNorm``, which owns the state."""
    use_batch_stats = autograd.is_training() and not use_global_stats
    axis = axis % data.ndim
    red = tuple(i for i in range(data.ndim) if i != axis)
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]

    def _f(x, g, b, mm, mv):
        if fix_gamma:
            g = torch.ones_like(g)
        if use_batch_stats:
            xf = x.to(torch.float32)
            mean = torch.mean(xf, dim=red)
            var = torch.var(xf, dim=red, correction=0)
        else:
            mean, var = mm, mv
        inv = torch.rsqrt(var + eps) * g
        return (x - mean.reshape(bshape).to(x.dtype)) * \
            inv.reshape(bshape).to(x.dtype) + b.reshape(bshape).to(x.dtype)
    return apply_op(_f, [data, gamma, beta, moving_mean, moving_var],
                    "BatchNorm")


@register_op("LayerNorm", aliases=("layer_norm",))
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
              **kwargs):
    def _f(x, g, b):
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=axis, keepdim=True)
        var = torch.var(xf, dim=axis, keepdim=True, correction=0)
        out = (xf - mean) * torch.rsqrt(var + eps)
        bshape = [1] * x.ndim
        bshape[axis] = x.shape[axis]
        return (out * g.reshape(bshape) + b.reshape(bshape)).to(x.dtype)
    return apply_op(_f, [data, gamma, beta], "LayerNorm")


@register_op("InstanceNorm")
def InstanceNorm(data, gamma, beta, eps=1e-3, **kwargs):
    def _f(x, g, b):
        red = tuple(range(2, x.ndim))
        mean = torch.mean(x, dim=red, keepdim=True)
        var = torch.var(x, dim=red, keepdim=True, correction=0)
        bshape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - mean) * torch.rsqrt(var + eps) * g.reshape(bshape) + \
            b.reshape(bshape)
    return apply_op(_f, [data, gamma, beta], "InstanceNorm")


@register_op("L2Normalization")
def L2Normalization(data, eps=1e-10, mode="instance", **kwargs):
    def _f(x):
        if mode == "instance":
            n = torch.sqrt(torch.sum(torch.square(x.reshape(x.shape[0], -1)),
                                     dim=1) + eps)
            return x / n.reshape((-1,) + (1,) * (x.ndim - 1))
        if mode == "channel":
            n = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)
                           + eps)
            return x / n
        n = torch.sqrt(torch.sum(torch.square(x), dim=tuple(range(2, x.ndim)),
                                 keepdim=True) + eps)
        return x / n
    return apply_op(_f, [data], "L2Normalization")


def _keep_mask(key, p_keep: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p_keep, shape)`` with the reference's
    float64 probability (its Python float under x64)."""
    p = torch.tensor(p_keep, dtype=torch.float64, device=device)
    return prng.bernoulli(key, p, tuple(shape))


def _drop(x, keep, p):
    """``where(keep, x / (1 - p), 0)``, the division elementwise (a
    division by a scalar is a reciprocal multiply in torch)."""
    scale = torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale.expand(x.shape),
                       torch.zeros((), dtype=x.dtype, device=x.device))


@register_op("Dropout", aliases=("dropout",))
def Dropout(data, p=0.5, mode="training", axes=None, **kwargs):
    """Dropout (reference src/operator/nn/dropout.cc). Active only under
    autograd.train_mode; the mask is drawn from the ``mx.random`` key
    chain (a hybridized call's key inside its forward), as the
    reference's is."""
    if not autograd.is_training() or p <= 0:
        return apply_op(lambda x: x, [data], "Dropout")
    from . import random as _rnd
    key = _rnd._next_key(data.context)
    shape = data.shape
    if axes:
        shape = tuple(1 if i in axes else s for i, s in enumerate(shape))
    return apply_op(lambda x: _drop(x, _keep_mask(key, 1.0 - p, shape,
                                                  x.device), p),
                    [data], "Dropout")


@register_op("where_v2", aliases=())
def where_v2(condition, x, y, **kwargs):
    return where(condition, x, y)


# -- losses as ops ----------------------------------------------------------
@register_op("smooth_l1")
def smooth_l1(data, scalar=1.0, **kwargs):
    def _f(x):
        s2 = scalar * scalar
        ax = torch.abs(x)
        return torch.where(ax < 1.0 / s2, 0.5 * s2 * torch.square(x),
                           ax - 0.5 / s2)
    return apply_op(_f, [data], "smooth_l1")


@register_op("softmax_cross_entropy")
def softmax_cross_entropy(data, label, **kwargs):
    def _f(x, lab):
        lp = torch.log_softmax(x, dim=-1)
        return -torch.sum(_hot(lab, x.shape[-1]).to(lp.dtype) * lp)
    return apply_op(_f, [data, label], "softmax_cross_entropy")


def _logsumexp3(a, b, c, neg_inf):
    m = torch.maximum(torch.maximum(a, b), c)
    tot = m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                        + torch.exp(c - m))
    return torch.where(m <= neg_inf / 2, torch.full_like(m, neg_inf), tot)


@register_op("ctc_loss", aliases=("CTCLoss",))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             blank_label="first", **kwargs):
    """CTC negative log-likelihood (reference src/operator/nn/ctc_loss.cc /
    warp-ctc). ``data`` is (T, N, C) activations (softmax applied inside),
    ``label`` (N, L) class indices, 0 = padding when blank is 'first'.
    The log-alpha recursion runs as a loop over time, differentiated by
    autograd."""
    if blank_label != "first":
        raise NotImplementedError(
            "ctc_loss: only blank_label='first' (blank=class 0, labels "
            "1-based) is implemented; 'last' is not yet supported")
    arrs = [data, label]
    has_dl = data_lengths is not None
    has_ll = label_lengths is not None
    if has_dl:
        arrs.append(data_lengths)
    if has_ll:
        arrs.append(label_lengths)
    blank = 0

    def _f(x, lab, *rest):
        T, N, C = x.shape
        L = lab.shape[1]
        dev = x.device
        dl = rest[0].to(torch.int64) if has_dl else \
            torch.full((N,), T, dtype=torch.int64, device=dev)
        ll = rest[int(has_dl)].to(torch.int64) if has_ll else \
            torch.sum((lab > 0).to(torch.int64), dim=1)
        logp = torch.log_softmax(x.to(torch.float32), dim=-1)
        lab_i = lab.to(torch.int64)
        S = 2 * L + 1
        ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
        ext[:, 1::2] = lab_i
        neg_inf = -1e30
        can_skip = torch.cat(
            [torch.zeros((N, 2), dtype=torch.bool, device=dev),
             (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])],
            dim=1)[:, :S]
        col0 = torch.zeros((N, S), dtype=torch.bool, device=dev)
        col0[:, 0] = True
        alpha = torch.where(col0, logp[0, :, blank:blank + 1],
                            torch.full((N, S), neg_inf, device=dev))
        if L > 0:
            col1 = torch.zeros((N, S), dtype=torch.bool, device=dev)
            col1[:, 1] = True
            alpha = torch.where(col1, torch.gather(logp[0], 1, ext[:, 1:2]),
                                alpha)
        alphas = [alpha]
        pad1 = torch.full((N, 1), neg_inf, device=dev)
        pad2 = torch.full((N, 2), neg_inf, device=dev)
        for t in range(1, T):
            prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
            prev2 = torch.cat([pad2, alpha[:, :-2]], dim=1)[:, :S]
            prev2 = torch.where(can_skip, prev2, torch.full_like(prev2,
                                                                 neg_inf))
            alpha = _logsumexp3(alpha, prev1, prev2, neg_inf) + \
                torch.gather(logp[t], 1, ext)
            alphas.append(alpha)
        alphas = torch.stack(alphas, dim=0)             # (T, N, S)
        t_idx = torch.clamp(dl - 1, 0, T - 1)
        a_last = torch.gather(alphas, 0, t_idx[None, :, None].expand(
            1, N, S))[0]
        s1 = torch.clamp(2 * ll, 0, S - 1)
        s2 = torch.clamp(2 * ll - 1, 0, S - 1)
        a1 = torch.gather(a_last, 1, s1[:, None])[:, 0]
        a2 = torch.gather(a_last, 1, s2[:, None])[:, 0]
        # empty labels: the only valid path ends at s=0 — don't count it
        # twice through the clipped s2 index
        a2 = torch.where(ll > 0, a2, torch.full_like(a2, neg_inf))
        m = torch.maximum(a1, a2)
        return -(m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)))
    return apply_op(_f, arrs, "ctc_loss")


# -- scalar ops (reference _plus_scalar etc., the internal names the Symbol
# frontend and graph JSON use for array∘scalar arithmetic:
# src/operator/tensor/elemwise_binary_scalar_op_basic.cc) ---------------------
def _scalar_op(name, raw, rev=False):
    @register_op(name)
    def op(data, scalar=0.0, **kwargs):
        if rev:
            return apply_op(lambda x: raw(scalar, x), [data], name)
        return apply_op(lambda x: raw(x, scalar), [data], name)
    op.__name__ = name
    return op


_scalar_op("_plus_scalar", torch.add)
_scalar_op("_minus_scalar", torch.sub)
_scalar_op("_rminus_scalar", lambda s, x: s - x, rev=True)
_scalar_op("_mul_scalar", torch.mul)
_scalar_op("_div_scalar", torch.true_divide)
_scalar_op("_rdiv_scalar", lambda s, x: s / x, rev=True)
_scalar_op("_mod_scalar", torch.remainder)
_scalar_op("_rmod_scalar", _tensor_op(torch.remainder), rev=True)
_scalar_op("_power_scalar", torch.pow)
_scalar_op("_rpower_scalar", torch.pow, rev=True)
_scalar_op("_maximum_scalar", _tensor_op(torch.maximum))
_scalar_op("_minimum_scalar", _tensor_op(torch.minimum))
for _nm, _raw in [("_equal_scalar", torch.eq),
                  ("_not_equal_scalar", torch.ne),
                  ("_greater_scalar", torch.gt),
                  ("_greater_equal_scalar", torch.ge),
                  ("_lesser_scalar", torch.lt),
                  ("_lesser_equal_scalar", torch.le)]:
    _scalar_op(_nm, _as_operand_dtype(_raw))
_scalar_op("_hypot_scalar", _tensor_op(torch.hypot))


# -- misc -------------------------------------------------------------------
@register_op("add_n", aliases=("ElementWiseSum",))
def add_n(*args, **kwargs):
    return apply_op(lambda *xs: functools.reduce(torch.add, xs),
                    list(args), "add_n")


@register_op("cumsum")
def cumsum(a, axis=None, dtype=None, **kwargs):
    """``dtype`` is the accumulator's: the scan runs in it (an int32
    total past 2^31 does not wrap when it is int64)."""
    def _f(x):
        return torch.cumsum(x.reshape(-1) if axis is None else x,
                            dim=axis or 0,
                            dtype=dtype_torch(dtype) if dtype else None)
    return apply_op(_f, [a], "cumsum")


@register_op("full")
def full_op(shape, val, ctx=None, dtype=None, **kwargs):
    return _nd_full(shape, val, ctx, dtype)


# -- fused RNN (reference src/operator/rnn.cc / rnn_impl.h: cuDNN-packed
# multi-layer LSTM/GRU/vanilla RNN), a loop over time per layer ------------
def rnn_gates(mode: str) -> int:
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_layout(mode, input_size, state_size, num_layers,
                     bidirectional, projection_size=None):
    """Offsets of each (layer, direction) i2h/h2h weight/bias in the packed
    1-D parameter vector, cuDNN order: all weights (layer-major, then
    direction), then all biases."""
    ng = rnn_gates(mode)
    d = 2 if bidirectional else 1
    h = state_size
    entries = []  # (kind, layer, dir, shape)
    for layer in range(num_layers):
        isz = input_size if layer == 0 else h * d
        for dr in range(d):
            entries.append(("i2h_weight", layer, dr, (ng * h, isz)))
            entries.append(("h2h_weight", layer, dr, (ng * h, h)))
    for layer in range(num_layers):
        for dr in range(d):
            entries.append(("i2h_bias", layer, dr, (ng * h,)))
            entries.append(("h2h_bias", layer, dr, (ng * h,)))
    layout = {}
    off = 0
    for kind, layer, dr, shape in entries:
        layout[(kind, layer, dr)] = (off, shape)
        off += math.prod(shape)
    return layout, off


def _rnn_single_direction(x, h0, c0, wih, whh, bih, bhh, mode,
                          clip_min=None, clip_max=None):
    """x (T,N,C), h0/c0 (N,H). Returns (out (T,N,H), hT[, cT]); the
    input gemm is hoisted out of the loop over time."""
    if mode == "lstm":
        gx = torch.einsum("tnc,gc->tng", x, wih) + bih + bhh
        h, c, outs = h0, c0, []
        for t in range(x.shape[0]):
            gates = gx[t] + h @ whh.T
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            if clip_min is not None and clip_max is not None:
                c = torch.clamp(c, clip_min, clip_max)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs), h, c
    if mode == "gru":
        # cuDNN gru: r,z,n gate order; n's h2h term is gated by r before
        # adding, with its own bias
        H = h0.shape[-1]
        gx = torch.einsum("tnc,gc->tng", x, wih) + bih
        h, outs = h0, []
        for t in range(x.shape[0]):
            gh = h @ whh.T + bhh
            r = torch.sigmoid(gx[t, :, :H] + gh[..., :H])
            z = torch.sigmoid(gx[t, :, H:2 * H] + gh[..., H:2 * H])
            n = torch.tanh(gx[t, :, 2 * H:] + r * gh[..., 2 * H:])
            h = (1 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs), h
    act = torch.tanh if mode == "rnn_tanh" else torch.relu
    gx = torch.einsum("tnc,gc->tng", x, wih) + bih + bhh
    h, outs = h0, []
    for t in range(x.shape[0]):
        h = act(gx[t] + h @ whh.T)
        outs.append(h)
    return torch.stack(outs), h


@register_op("_rnn_init_state")
def _rnn_init_state(data, num_states=1, state_size=None, **kwargs):
    """Zero initial RNN state derived from a TNC input: (num_states, N, H)."""
    return apply_op(
        lambda x: torch.zeros((num_states, x.shape[1], int(state_size)),
                              dtype=x.dtype, device=x.device), [data],
        "_rnn_init_state")


@register_op("RNN")
def RNN(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, **kwargs):
    """Fused multi-layer RNN, reference semantics (src/operator/rnn.cc):
    ``data`` (T, N, C) [TNC], ``parameters`` the cuDNN-packed 1-D vector,
    ``state`` (L*D, N, H) initial hidden, ``state_cell`` likewise (LSTM).
    Returns out (T, N, D*H) [+ final h [+ final c]] per state_outputs.
    Dropout between layers draws from the ``mx.random`` key chain."""
    if projection_size is not None:
        raise NotImplementedError("RNN projection_size not supported")
    mode = mode.lower()
    d = 2 if bidirectional else 1
    h = int(state_size)
    L = int(num_layers)
    is_lstm = mode == "lstm"
    arrs = [data, parameters, state] + ([state_cell] if is_lstm else [])
    drop = float(p)
    keys = []
    if drop > 0 and autograd.is_training():
        from . import random as _rnd
        keys = [_rnd._next_key(data.context) for _ in range(L - 1)]

    def _f(x, params, h0, *rest):
        c0 = rest[0] if is_lstm else None
        input_size = x.shape[-1]
        layout, total = rnn_param_layout(mode, input_size, h, L,
                                         bidirectional)
        if params.shape[0] != total:
            raise ValueError(
                f"RNN parameters size {params.shape[0]} != expected {total} "
                f"(mode={mode}, input={input_size}, hidden={h}, layers={L}, "
                f"bidirectional={bidirectional})")

        def get(kind, layer, dr):
            off, shape = layout[(kind, layer, dr)]
            return params[off:off + math.prod(shape)].reshape(shape)

        out = x
        hTs, cTs = [], []
        for layer in range(L):
            outs_dir = []
            for dr in range(d):
                idx = layer * d + dr
                xin = torch.flip(out, dims=(0,)) if dr == 1 else out
                res = _rnn_single_direction(
                    xin, h0[idx], c0[idx] if is_lstm else None,
                    get("i2h_weight", layer, dr),
                    get("h2h_weight", layer, dr),
                    get("i2h_bias", layer, dr), get("h2h_bias", layer, dr),
                    mode, lstm_state_clip_min, lstm_state_clip_max)
                o = res[0]
                if dr == 1:
                    o = torch.flip(o, dims=(0,))
                outs_dir.append(o)
                hTs.append(res[1])
                if is_lstm:
                    cTs.append(res[2])
            out = outs_dir[0] if d == 1 else torch.cat(outs_dir, dim=-1)
            if keys and layer < L - 1:
                out = _drop(out, _keep_mask(keys[layer], 1.0 - drop,
                                            out.shape, out.device), drop)
        hT = torch.stack(hTs, dim=0)
        if is_lstm:
            return out, hT, torch.stack(cTs, dim=0)
        return out, hT

    n_out = (3 if is_lstm else 2) if state_outputs else 1
    if state_outputs:
        return apply_op(_f, arrs, "RNN", n_out=n_out)
    return apply_op(lambda *a: _f(*a)[0], arrs, "RNN")


# the extended coverage registers itself into OP_REGISTRY at import —
# keep last (it imports from here)
from . import ops_extended  # noqa: E402,F401
