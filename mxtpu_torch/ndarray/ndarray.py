"""NDArray: MXNet's imperative mutable array over a ``torch.Tensor`` —
the port of ``mxtpu/ndarray/ndarray.py``.

As in the reference, a buffer is never written in place: "mutation"
(``__setitem__``, ``+=`` and friends, ``copyto``) rebinds ``_data`` to a
new tensor and bumps ``_version``. Tape nodes hold the tensors an op
was given, so an in-place write would change what a later ``backward``
reads; rebinding cannot. CUDA work is asynchronous as the reference's
XLA dispatch is; ``MXNET_ENGINE_TYPE=NaiveEngine`` synchronizes the
stream after every op (the reference's synchronous-debugging engine).

Where the port differs from the reference, deliberately:

- ``dtype`` is a ``torch.dtype`` (numpy has no bfloat16), and a
  context is a ``torch.device`` (``mxtpu_torch.context``). ``ctx=None``
  means the card, and raises when no card is visible.
- Type promotion is torch's. The reference's tests run jax with x64
  on, where ``int32 * 2.5`` and ``float32 * np.float64(2)`` are
  float64; here (as in jax with x64 off) they are float32.
- ``asnumpy()`` of a bfloat16 array returns float32, an exact widening.
- ``load`` takes ``ctx``, None being the card; like the reference's,
  it makes float entries float32.

``mxtpu_torch.profiler`` times every dispatch while its hook is set, and
``mxtpu_torch.engine``'s NaN sanitizer checks every op's output while it
is on; with neither, ``apply_op`` reads two module globals and nothing
else.
"""
from __future__ import annotations

import operator
import os
from time import perf_counter as _perf_counter
from typing import Any, Callable, List, Sequence, Tuple, Union

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError, dtype_name, dtype_torch, numeric_types
from ..context import DeviceLike, resolve_device

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concat", "stack", "waitall", "save", "load"]

_NAIVE = os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEngine") == "NaiveEngine"

def _sync(data: torch.Tensor) -> None:
    """Wait for the work queued on ``data``'s stream (WaitToRead)."""
    if data.is_cuda:
        torch.cuda.current_stream(data.device).synchronize()


# set by mxtpu_torch.profiler while it aggregates: fn(op_name, secs)
_profile_hook = None
# set by mxtpu_torch.engine while the NaN sanitizer is on: fn(op_name, out)
_nan_check = None


def _parents_of(arrays) -> List[Any]:
    """Tape parent descriptor for each NDArray input (None for constants)."""
    out = []
    for a in arrays:
        if isinstance(a, NDArray):
            if a._ag is not None:
                out.append(a._ag)
            elif a._ag_leaf is not None:
                out.append(a._ag_leaf)
            else:
                out.append(None)
        else:
            out.append(None)
    return out


def apply_op(raw_fn: Callable, arrays: Sequence["NDArray"], name: str = "",
             n_out: int = 1):
    """Execute an op on NDArrays through the autograd-aware path.

    ``raw_fn`` takes/returns tensors (a tuple when n_out > 1; with
    ``n_out=None``, a tuple gives a tuple of results). This is
    the single funnel every imperative op goes through — the analogue of
    Imperative::Invoke → Engine::PushAsync.
    """
    parents = _parents_of(arrays)
    datas = [a._data if isinstance(a, NDArray) else a for a in arrays]
    if _profile_hook is None:
        out, node = autograd.invoke(raw_fn, datas, parents, name)
    else:
        t0 = _perf_counter()
        out, node = autograd.invoke(raw_fn, datas, parents, name)
        _profile_hook(name, _perf_counter() - t0)
    if _nan_check is not None:
        _nan_check(name, out)
    # results take the class of the first dense array input
    cls = next((type(a) for a in arrays
                if isinstance(a, NDArray) and a.stype == "default"),
               NDArray)
    multi = isinstance(out, tuple) if n_out is None else n_out != 1
    outs = tuple(out) if multi else (out,)
    results = []
    for i, o in enumerate(outs):
        r = cls(o)
        if node is not None:
            r._ag = (node, i)
        if _NAIVE:
            _sync(r._data)
        results.append(r)
    return tuple(results) if multi else results[0]


def _operand(other, like: torch.Tensor):
    """A binary op's other operand: an NDArray's tensor, a Python or
    numpy scalar as it is (a weak scalar in torch's promotion), anything
    else (numpy arrays, lists) as a tensor on ``like``'s device."""
    if isinstance(other, NDArray):
        return other._data
    if isinstance(other, (torch.Tensor,) + numeric_types):
        return other
    return torch.as_tensor(_np.asarray(other), device=like.device)


def _all_axes(axis, ndim: int):
    if axis is None:
        return tuple(range(ndim))
    return tuple(axis) if isinstance(axis, list) else axis


def _prod(x, axis, keepdims):
    axes = sorted(a % max(x.ndim, 1) for a in
                  ((axis,) if isinstance(axis, int)
                   else _all_axes(axis, x.ndim)))
    for a in reversed(axes):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


def _arg(fn, x, axis, keepdims):
    """argmax/argmin as float32 (the reference's dtype)."""
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
        if keepdims:
            out = out.reshape((1,) * x.ndim)
    else:
        out = fn(x, dim=axis, keepdim=keepdims)
    return out.to(torch.float32)


def _norm(x, ord, axis, keepdims):
    if axis is None:
        return torch.linalg.vector_norm(x.reshape(-1), ord=ord,
                                        keepdim=keepdims)
    if isinstance(axis, (tuple, list)) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord=ord, dim=tuple(axis),
                                        keepdim=keepdims)
    return torch.linalg.vector_norm(x, ord=ord, dim=axis, keepdim=keepdims)


def _squeeze(x, axis):
    if axis is None:
        return torch.squeeze(x)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which "
                             f"has size not equal to one (axis {a} of "
                             f"shape {tuple(x.shape)})")
    return torch.squeeze(x, dim=axes)


def _expand_dims(x, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    ndim = x.ndim + len(axes)
    for a in sorted(a % ndim for a in axes):
        x = x.unsqueeze(a)
    return x


def _take(x, idx, axis):
    idx = idx.to(device=x.device, dtype=torch.int64)
    n = x.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    axis %= x.ndim
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _index(x, key):
    """``x[key]`` with numpy's slices: torch takes no negative step, so
    each such slice becomes a flip of its dimension and a slice with a
    positive step."""
    items = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and (k.step or 1) < 0 for k in items):
        return x[key]

    def width(k):            # input dimensions an index item consumes
        if k is None:
            return 0
        if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            return k.ndim
        return 1
    rest = x.ndim - sum(width(k) for k in items if k is not Ellipsis)
    dim, out = 0, []
    for k in items:
        if isinstance(k, slice) and (k.step or 1) < 0:
            n = x.shape[dim]
            start, stop, step = k.indices(n)
            x = x.flip(dim)
            k = slice(n - 1 - start, n - 1 - stop, -step)
        out.append(k)
        dim += rest if k is Ellipsis else width(k)
    return x[tuple(out)]


def _one_hot(x, depth, on_value, off_value):
    """Indices outside [0, depth) give all-off rows, as jax's does."""
    hot = (x.to(torch.int64).unsqueeze(-1)
           == torch.arange(depth, device=x.device)).to(torch.float32)
    return hot * (on_value - off_value) + off_value


class NDArray:
    """Multi-dimensional, asynchronously-evaluated array."""

    __slots__ = ("_data", "_ag", "_ag_leaf", "grad", "_version")
    __array_priority__ = 1000.0

    def __init__(self, data: torch.Tensor):
        self._data = data          # torch.Tensor, never written in place
        self._ag = None            # (Node, out_index) when produced on tape
        self._ag_leaf = None       # autograd.Leaf when attach_grad()'d
        self.grad = None           # NDArray grad buffer
        self._version = 0

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def context(self) -> torch.device:
        return self._data.device

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return apply_op(lambda x: x.permute(*reversed(range(x.ndim))),
                        [self], "T")

    # -- sync / host interop ------------------------------------------------
    def wait_to_read(self) -> None:
        _sync(self._data)

    wait_to_write = wait_to_read

    def asnumpy(self) -> _np.ndarray:
        """A host copy as numpy; bfloat16 and the float8 types come back
        as float32 (numpy has none of them; the widening is exact). An
        array laid out on a mesh (a DTensor) is gathered whole."""
        t = self._data.detach()
        if type(t).__name__ == "DTensor":
            t = t.full_tensor()
        if t.is_floating_point() and (t.dtype == torch.bfloat16
                                      or t.element_size() == 1):
            t = t.float()           # bfloat16 and float8: exact widening
        if t.is_cuda:
            # wait for the stream here, not inside the copy: a thread
            # blocked in a device-to-host copy stalls every other
            # thread's copies on the card (the native decoder's among
            # them) until the work ahead of it ends
            torch.cuda.current_stream(t.device).synchronize()
        return t.to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return f"{self.asnumpy()!r}\n<NDArray {self.shape} @{self.context}>"

    def __reduce__(self):
        # pickle via host numpy, with the dtype name (bfloat16 crosses
        # as float32) and the device
        return (_unpickle_ndarray, (self.asnumpy(), dtype_name(self.dtype),
                                    str(self.context)))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- dtype / device movement -------------------------------------------
    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = dtype_torch(dtype)
        if not copy and self.dtype == dt:
            return self
        return apply_op(lambda x: x.to(dt), [self], "astype")

    def as_in_context(self, ctx: DeviceLike) -> "NDArray":
        dev = resolve_device(ctx)
        if _same_device(self._data.device, dev):
            return self
        return type(self)(self._data.to(dev))

    as_in_ctx = as_in_context

    def copyto(self, other: Union["NDArray", DeviceLike]) -> "NDArray":
        """Copy into ``other``'s buffer (rebound, in its dtype and on its
        device), or onto a device as a new array."""
        if not isinstance(other, NDArray):
            return type(self)(self._data.to(resolve_device(other),
                                            copy=True))
        other._set_data(self._data.to(other._data.device, other._data.dtype,
                                      copy=True))
        return other

    def copy(self) -> "NDArray":
        return type(self)(self._data.clone())

    def detach(self) -> "NDArray":
        return type(self)(self._data.detach())

    def to_dlpack(self):
        return torch.utils.dlpack.to_dlpack(self._data)

    # -- mutation -----------------------------------------------------------
    def _set_data(self, new_data: torch.Tensor) -> None:
        """Rebind the buffer (the 'write' side of the engine variable)."""
        if autograd.is_recording() and self._ag is not None:
            raise MXNetError(
                "in-place write to an array produced under autograd.record() "
                "is not allowed (it would invalidate the tape)")
        self._data = new_data
        self._ag = None
        self._version += 1

    def _norm_key(self, key):
        """Index keys as torch takes them: NDArrays as their tensors,
        lists and numpy arrays as int64 tensors on this array's device
        (an empty list selects nothing, as numpy's ``x[[]]`` does). In a
        tuple with an integer array, ints become one-element index
        arrays: numpy counts them among the advanced indices (which
        moves the result's dimensions when a slice separates them),
        torch does not."""
        def as_idx(seq):
            t = torch.as_tensor(_np.asarray(seq), device=self._data.device)
            return t.to(torch.int64) if t.numel() == 0 else t
        if isinstance(key, NDArray):
            return key._data
        if isinstance(key, (list, _np.ndarray)):
            return as_idx(key)
        if not isinstance(key, tuple):
            return key
        key = tuple(k._data if isinstance(k, NDArray)
                    else as_idx(k) if isinstance(k, (list, _np.ndarray))
                    else k for k in key)
        if any(isinstance(k, torch.Tensor) and k.ndim
               and k.dtype != torch.bool for k in key):
            key = tuple(torch.tensor([k], device=self._data.device)
                        if isinstance(k, int) else k for k in key)
        return key

    def __setitem__(self, key, value) -> None:
        """Rebind to a fresh tensor: the whole array for ``x[:] = v``
        (``v`` broadcast to this shape), else a clone with the indexed
        part written."""
        dev, dt = self._data.device, self._data.dtype
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, _np.generic):
            value = value.item()
        if isinstance(value, torch.Tensor):
            value = value.to(dev, dt)
        elif not _np.isscalar(value):
            value = torch.as_tensor(_np.asarray(value), device=dev).to(dt)
        key = self._norm_key(key)
        if key is None or key is Ellipsis or \
                (isinstance(key, slice) and key == slice(None)):
            if _np.isscalar(value):
                new = torch.full(self.shape, value, dtype=dt, device=dev)
            else:
                new = torch.broadcast_to(value, self.shape).clone()
        else:
            new = self._data.clone()
            # the flat positions the key selects (negative steps too)
            pos = _index(torch.arange(new.numel(), device=dev)
                         .reshape(new.shape), key)
            new.view(-1)[pos.reshape(-1)] = torch.broadcast_to(
                torch.as_tensor(value, dtype=dt, device=dev),
                pos.shape).reshape(-1)
        self._set_data(new)

    def __getitem__(self, key) -> "NDArray":
        key = self._norm_key(key)
        return apply_op(lambda x: _index(x, key), [self], "getitem")

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Allocate a gradient buffer and mark this array as a variable."""
        self.grad = type(self)(torch.zeros_like(self._data))
        self._ag_leaf = autograd.Leaf(self, grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad], retain_graph, train_mode)

    # -- arithmetic (each funnels through apply_op) --------------------------
    def _binop(self, other, fn, name):
        if isinstance(other, NDArray):
            return apply_op(fn, [self, other], name)
        o = _operand(other, self._data)
        return apply_op(lambda x: fn(x, o), [self], name)

    def _rbinop(self, other, fn, name):
        o = _operand(other, self._data)
        return apply_op(lambda x: fn(o, x), [self], name)

    def __add__(self, o): return self._binop(o, operator.add, "add")
    def __radd__(self, o): return self._rbinop(o, operator.add, "add")
    def __sub__(self, o): return self._binop(o, operator.sub, "sub")
    def __rsub__(self, o): return self._rbinop(o, operator.sub, "rsub")
    def __mul__(self, o): return self._binop(o, operator.mul, "mul")
    def __rmul__(self, o): return self._rbinop(o, operator.mul, "mul")
    def __truediv__(self, o): return self._binop(o, operator.truediv, "div")
    def __rtruediv__(self, o): return self._rbinop(o, operator.truediv, "rdiv")
    def __mod__(self, o): return self._binop(o, operator.mod, "mod")
    def __rmod__(self, o): return self._rbinop(o, operator.mod, "rmod")
    def __pow__(self, o): return self._binop(o, operator.pow, "pow")
    def __rpow__(self, o): return self._rbinop(o, operator.pow, "rpow")
    def __matmul__(self, o): return self._binop(o, operator.matmul, "matmul")
    def __neg__(self): return apply_op(torch.neg, [self], "neg")
    def __abs__(self): return apply_op(torch.abs, [self], "abs")

    def __eq__(self, o): return self._binop(o, lambda a, b: (a == b).to(a.dtype), "eq")
    def __ne__(self, o): return self._binop(o, lambda a, b: (a != b).to(a.dtype), "ne")
    def __gt__(self, o): return self._binop(o, lambda a, b: (a > b).to(a.dtype), "gt")
    def __ge__(self, o): return self._binop(o, lambda a, b: (a >= b).to(a.dtype), "ge")
    def __lt__(self, o): return self._binop(o, lambda a, b: (a < b).to(a.dtype), "lt")
    def __le__(self, o): return self._binop(o, lambda a, b: (a <= b).to(a.dtype), "le")

    __hash__ = object.__hash__

    # in-place operators rebind the buffer (engine-var write analogue)
    def _inplace(self, o, fn):
        self._set_data(fn(self._data, _operand(o, self._data)))
        return self

    def __iadd__(self, o): return self._inplace(o, operator.add)
    def __isub__(self, o): return self._inplace(o, operator.sub)
    def __imul__(self, o): return self._inplace(o, operator.mul)
    def __itruediv__(self, o): return self._inplace(o, operator.truediv)

    # -- shape manipulation / reductions (method forms) ----------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        # MXNet magic values: -1 infer (same as numpy), 0 copy-from-input
        if 0 in shape:
            shape = tuple(self.shape[i] if s == 0 else s
                          for i, s in enumerate(shape))
        return apply_op(lambda x: torch.reshape(x, shape), [self], "reshape")

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, axes=None):
        def _t(x):
            return x.permute(*(reversed(range(x.ndim)) if axes is None
                               else axes))
        return apply_op(_t, [self], "transpose")

    def swapaxes(self, a1, a2):
        return apply_op(lambda x: torch.swapaxes(x, a1, a2), [self],
                        "swapaxes")

    def flatten(self):
        n = self.shape[0] if self.ndim > 0 else 1
        return self.reshape(n, -1)

    def expand_dims(self, axis):
        return apply_op(lambda x: _expand_dims(x, axis), [self],
                        "expand_dims")

    def squeeze(self, axis=None):
        return apply_op(lambda x: _squeeze(x, axis), [self], "squeeze")

    def broadcast_to(self, shape):
        return apply_op(lambda x: torch.broadcast_to(x, tuple(shape)),
                        [self], "broadcast_to")

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def _reduce(self, fn, axis, keepdims, name):
        return apply_op(
            lambda x: fn(x, dim=_all_axes(axis, x.ndim), keepdim=keepdims),
            [self], name)

    def sum(self, axis=None, keepdims=False):
        return self._reduce(torch.sum, axis, keepdims, "sum")

    def mean(self, axis=None, keepdims=False):
        def _mean(x, dim, keepdim):
            if not x.is_floating_point():
                x = x.to(torch.float32)
            return torch.mean(x, dim=dim, keepdim=keepdim)
        return self._reduce(_mean, axis, keepdims, "mean")

    def max(self, axis=None, keepdims=False):
        return self._reduce(torch.amax, axis, keepdims, "max")

    def min(self, axis=None, keepdims=False):
        return self._reduce(torch.amin, axis, keepdims, "min")

    def prod(self, axis=None, keepdims=False):
        return apply_op(lambda x: _prod(x, axis, keepdims), [self], "prod")

    def norm(self, ord=2, axis=None, keepdims=False):
        return apply_op(lambda x: _norm(x, ord, axis, keepdims), [self],
                        "norm")

    def argmax(self, axis=None, keepdims=False):
        return apply_op(lambda x: _arg(torch.argmax, x, axis, keepdims),
                        [self], "argmax")

    def argmin(self, axis=None, keepdims=False):
        return apply_op(lambda x: _arg(torch.argmin, x, axis, keepdims),
                        [self], "argmin")

    def clip(self, a_min=None, a_max=None):
        return apply_op(lambda x: torch.clamp(x, a_min, a_max), [self],
                        "clip")

    def abs(self):
        return apply_op(torch.abs, [self], "abs")

    def sqrt(self):
        return apply_op(torch.sqrt, [self], "sqrt")

    def exp(self):
        return apply_op(torch.exp, [self], "exp")

    def log(self):
        return apply_op(torch.log, [self], "log")

    def relu(self):
        return apply_op(torch.relu, [self], "relu")

    def sigmoid(self):
        return apply_op(torch.sigmoid, [self], "sigmoid")

    def tanh(self):
        return apply_op(torch.tanh, [self], "tanh")

    def softmax(self, axis=-1):
        return apply_op(lambda x: torch.softmax(x, dim=axis), [self],
                        "softmax")

    def slice_axis(self, axis, begin, end):
        def _f(x):
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(begin, end)
            return x[tuple(idx)]
        return apply_op(_f, [self], "slice_axis")

    def take(self, indices, axis=0):
        idx = indices._data if isinstance(indices, NDArray) \
            else torch.as_tensor(_np.asarray(indices))
        return apply_op(lambda x: _take(x, idx, axis), [self], "take")

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return apply_op(lambda x: _one_hot(x, depth, on_value, off_value),
                        [self], "one_hot")

    def tile(self, reps):
        reps = (reps,) if isinstance(reps, int) else tuple(reps)
        return apply_op(lambda x: torch.tile(x, reps), [self], "tile")

    def repeat(self, repeats, axis=None):
        return apply_op(
            lambda x: torch.repeat_interleave(x, repeats, dim=axis),
            [self], "repeat")

    def pad(self, *a, **kw):
        from . import ops
        return ops.pad(self, *a, **kw)

    def dot(self, other):
        from . import ops
        return ops.dot(self, other)

    def zeros_like(self):
        return type(self)(torch.zeros_like(self._data))

    def ones_like(self):
        return type(self)(torch.ones_like(self._data))

    def asfloat(self):
        return self.astype("float32")

    def tostype(self, stype):
        """This array in storage ``stype`` ('default', 'csr' for 2-D,
        'row_sparse'), converted on its device."""
        if stype == "default":
            return self
        from .sparse import CSRNDArray, RowSparseNDArray
        if stype == "csr":
            return CSRNDArray.from_dense(self._data)
        if stype == "row_sparse":
            return RowSparseNDArray.from_dense(self._data)
        raise ValueError(f"unknown storage type {stype!r}")


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _unpickle_ndarray(np_val, dtype_name="float32", device="cpu"):
    return NDArray(torch.tensor(np_val, device=device)
                   .to(dtype_torch(dtype_name)))


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _shape(shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source, ctx: DeviceLike = None, dtype=None) -> NDArray:
    """A new array on ``ctx`` (None: the card) holding a copy of
    ``source``. Without ``dtype``: an NDArray's or a tensor's dtype is
    kept, an integer, unsigned or bool numpy array keeps its dtype, and
    everything else (float numpy arrays, lists, scalars) is float32, as
    in the reference."""
    dev = resolve_device(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        dt = source.dtype if dtype is None else dtype_torch(dtype)
        return NDArray(source.detach().to(dev, dt, copy=True))
    if dtype is None:
        dtype = source.dtype if isinstance(source, _np.ndarray) \
            and source.dtype.kind in "iub" else "float32"
    dt = dtype_torch(dtype)
    # numpy has no bfloat16: it goes through float32; a view with
    # negative strides (a flipped image) is copied, as torch needs
    np_val = _np.asarray(source, "float32" if dt == torch.bfloat16
                         else dtype_name(dt))
    if any(st < 0 for st in np_val.strides):
        np_val = np_val.copy()
    return NDArray(torch.tensor(np_val, device=dev).to(dt))


def empty(shape, ctx: DeviceLike = None, dtype=None) -> NDArray:
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx: DeviceLike = None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=dtype_torch(dtype),
                               device=resolve_device(ctx)))


def ones(shape, ctx: DeviceLike = None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=dtype_torch(dtype),
                              device=resolve_device(ctx)))


def full(shape, val, ctx: DeviceLike = None, dtype=None) -> NDArray:
    return NDArray(torch.full(_shape(shape), val, dtype=dtype_torch(dtype),
                              device=resolve_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx: DeviceLike = None,
           dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=dtype_torch(dtype),
                       device=resolve_device(ctx))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return NDArray(out)


def concat(*arrays, dim: int = 1) -> NDArray:
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return apply_op(lambda *xs: torch.cat(xs, dim=dim), list(arrays),
                    "concat")


def stack(*arrays, axis: int = 0) -> NDArray:
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return apply_op(lambda *xs: torch.stack(xs, dim=axis), list(arrays),
                    "stack")


def waitall() -> None:
    """Block until all queued computation completes (Engine::WaitForAll)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ---------------------------------------------------------------------------
# serialization — the reference's NDArray::Save/Load container
# ---------------------------------------------------------------------------
def save(fname: str, data) -> None:
    """Write an NDArray, a list of them or a dict of them to ``fname``
    in MXNet's ``.params`` format (``mxtpu_torch.serde``)."""
    from ..serde import save_ndarrays
    save_ndarrays(fname, data)


def load(fname: str, ctx: DeviceLike = None):
    """Read a ``.params`` file: a list of NDArrays, or a dict when the
    file names its arrays, on ``ctx`` (None: the card)."""
    from ..serde import load_ndarrays
    return load_ndarrays(fname, ctx)
