"""``mx.np`` — the NumPy-semantics array frontend, the port of
``mxtpu/numpy``.

``ndarray`` is an ``NDArray`` whose comparisons give bool arrays
(comparing with ``None`` is elementwise), whose ``reshape`` is NumPy's
(no MXNet magic values) and whose ``sort`` sorts in place. Every name
``jax.numpy`` serves (and ``linalg.*``, ``fft.*``) is a function of
:mod:`mxtpu_torch.numpy._table` written on torch ops with NumPy's
signature, called through ``apply_op``, so ``mx.np`` records under
``mx.autograd``, is counted by the profiler and checked by the NaN
sanitizer, and results keep the class of their first array input.
Functions whose result shape depends on the data (``nonzero``,
``unique``, ...) run eagerly and unrecorded, as the reference's do.

Where the port differs from the reference, deliberately:

- ``dtype`` is a ``torch.dtype`` as everywhere in the port, and the
  scalar-type names (``mx.np.float32``, ...) are callables that also
  stand for their dtype; a type torch has not (``int4``, ``float4_*``,
  some ``float8_*``) raises ``TypeError``.
- A Python float or a float list becomes float32, as float64 host data
  does in ``array`` (the reference's tests run jax in 64-bit mode,
  where they are float64); Python ints are int64.
- ``finfo``, ``iinfo``, ``dtype``, ``promote_types``, the print
  options and ``vectorize`` return what ``jax.numpy`` returns (the
  reference's wrapper raises on any value that is not an array);
  ``out=`` is written into (``jax.numpy`` refuses it).
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..base import dtype_torch
from ..context import resolve_device
from ..ndarray.ndarray import NDArray, apply_op
from . import _table

__all__ = ["ndarray", "array", "asarray", "zeros", "ones", "empty",
           "full", "arange", "linspace", "eye", "from_nd", "take"]

_np_default_dtype = torch.float32


class ndarray(NDArray):
    """NumPy-semantics array: bool comparisons, NumPy promotion."""

    __slots__ = ()

    def _cmp(self, other, name):
        if other is None:
            return ndarray(torch.full(self.shape, name == "not_equal",
                                      dtype=torch.bool,
                                      device=self._data.device))
        return _call(name, (self, other), {})

    def __eq__(self, o): return self._cmp(o, "equal")
    def __ne__(self, o): return self._cmp(o, "not_equal")
    def __gt__(self, o): return self._cmp(o, "greater")
    def __ge__(self, o): return self._cmp(o, "greater_equal")
    def __lt__(self, o): return self._cmp(o, "less")
    def __le__(self, o): return self._cmp(o, "less_equal")

    __hash__ = NDArray.__hash__

    # arithmetic follows NumPy's promotion (the table's binary ufuncs)
    def __add__(self, o): return _call("add", (self, o), {})
    def __radd__(self, o): return _call("add", (o, self), {})
    def __sub__(self, o): return _call("subtract", (self, o), {})
    def __rsub__(self, o): return _call("subtract", (o, self), {})
    def __mul__(self, o): return _call("multiply", (self, o), {})
    def __rmul__(self, o): return _call("multiply", (o, self), {})
    def __truediv__(self, o): return _call("divide", (self, o), {})
    def __rtruediv__(self, o): return _call("divide", (o, self), {})
    def __floordiv__(self, o): return _call("floor_divide", (self, o), {})
    def __rfloordiv__(self, o): return _call("floor_divide", (o, self), {})
    def __mod__(self, o): return _call("mod", (self, o), {})
    def __rmod__(self, o): return _call("mod", (o, self), {})
    def __pow__(self, o): return _call("power", (self, o), {})
    def __rpow__(self, o): return _call("power", (o, self), {})
    def __matmul__(self, o): return _call("matmul", (self, o), {})
    def __rmatmul__(self, o): return _call("matmul", (o, self), {})
    def __and__(self, o): return _call("bitwise_and", (self, o), {})
    def __or__(self, o): return _call("bitwise_or", (self, o), {})
    def __xor__(self, o): return _call("bitwise_xor", (self, o), {})
    def __invert__(self): return _call("invert", (self,), {})
    def __neg__(self): return _call("negative", (self,), {})
    def __pos__(self): return _call("positive", (self,), {})
    def __abs__(self): return _call("absolute", (self,), {})

    def _inplace(self, o, name):
        res = _call(name, (self, o), {})
        self._set_data(res._data.to(self.dtype))
        return self

    def __iadd__(self, o): return self._inplace(o, "add")
    def __isub__(self, o): return self._inplace(o, "subtract")
    def __imul__(self, o): return self._inplace(o, "multiply")
    def __itruediv__(self, o): return self._inplace(o, "divide")

    def as_nd_ndarray(self) -> NDArray:
        """This array as an ``mx.nd`` array: the same buffer, tape link
        and grad."""
        r = NDArray(self._data)
        r._ag, r._ag_leaf, r.grad = self._ag, self._ag_leaf, self.grad
        return r

    def item(self, *args):
        return self.asnumpy().item(*args)

    def tolist(self):
        return self.asnumpy().tolist()

    def __repr__(self):
        return "array(" + repr(self.asnumpy())[6:]

    @property
    def T(self):
        return _call("transpose", (self,), {})

    def reshape(self, *shape, order="C"):
        """NumPy's reshape: -1 infers one dimension, 0 is a size."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return _call("reshape", (self, shape), {"order": order})

    def transpose(self, *axes):
        if len(axes) == 1 and (axes[0] is None
                               or isinstance(axes[0], (list, tuple))):
            axes = axes[0]
        return _call("transpose", (self, axes or None), {})

    def ravel(self, order="C"):
        if order != "C":
            raise NotImplementedError(
                f"ravel(order={order!r}): only C order is supported")
        return _call("ravel", (self,), {})

    def flatten(self, order="C"):
        return self.ravel(order)

    def take(self, indices, axis=None, mode="raise"):
        # NumPy's default mode='raise' cannot be honoured by a gather
        # that never reads back; name the mode at the call site instead
        if mode not in ("clip", "wrap"):
            raise NotImplementedError(
                f"take(mode={mode!r}): a device gather cannot raise on "
                "out-of-range indices; pass mode='clip' or mode='wrap' "
                "explicitly")
        return _call("take", (self, indices), {"axis": axis, "mode": mode})

    def sort(self, axis=-1):
        """Sort in place (NumPy's method contract; ``mx.np.sort`` returns
        a sorted copy): the buffer is rebound, so under
        ``autograd.record()`` this raises like any write."""
        self._set_data(_table.sort(self._data, axis=axis))

    def nonzero(self):
        return _call("nonzero", (self,), {})

    @property
    def itemsize(self):
        return self._data.element_size()

    @property
    def nbytes(self):
        return self._data.element_size() * self._data.numel()

    def copy(self, order="C"):
        return ndarray(self._data.clone())


def _method(name):
    """An ndarray method: the table's function ``name``, array first."""
    def m(self, *args, **kwargs):
        return _call(name, (self,) + args, kwargs)
    m.__name__ = name
    return m


for _n in ("sum", "prod", "mean", "std", "var", "max", "min", "argmax",
           "argmin", "all", "any", "cumsum", "cumprod", "round", "clip",
           "argsort", "squeeze", "swapaxes", "repeat", "ptp", "trace",
           "diagonal", "dot", "conj", "conjugate", "searchsorted",
           "astype", "expand_dims", "broadcast_to", "tile",
           "flip", "argpartition"):
    setattr(ndarray, _n, _method(_n))
del _n


def from_nd(a: NDArray) -> ndarray:
    """View an ``mx.nd`` array as ``mx.np``: the same buffer, tape link
    and grad (a gradient written to either is seen by both)."""
    r = ndarray(a._data)
    r._ag, r._ag_leaf, r.grad = a._ag, a._ag_leaf, a.grad
    return r


# ---------------------------------------------------------------------------
# the funnel
# ---------------------------------------------------------------------------
class _Slot:
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def _mark(v, arrays):
    if isinstance(v, NDArray):
        arrays.append(v)
        return _Slot(len(arrays) - 1)
    if isinstance(v, (list, tuple)) and not hasattr(v, "_fields"):
        return type(v)(_mark(x, arrays) for x in v)
    if isinstance(v, dict):
        return {k: _mark(x, arrays) for k, x in v.items()}
    return v


def _fill(v, datas):
    if isinstance(v, _Slot):
        return datas[v.i]
    if isinstance(v, (list, tuple)) and not hasattr(v, "_fields"):
        return type(v)(_fill(x, datas) for x in v)
    if isinstance(v, dict):
        return {k: _fill(x, datas) for k, x in v.items()}
    return v


def _wrap(v):
    if isinstance(v, torch.Tensor):
        return ndarray(v)
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_wrap(x) for x in v))
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def _flat(out):
    """A function's result as (its tensors in order, rebuild), or
    (None, None) when it holds anything but tensors."""
    leaves = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            leaves.append(v)
            return len(leaves) - 1
        if isinstance(v, (list, tuple)) and v:
            return (type(v), [walk(x) for x in v])
        raise TypeError

    try:
        spec = walk(out)
    except TypeError:
        return None, None

    def rebuild(ts, s=spec):
        if isinstance(s, int):
            return ts[s]
        kind, items = s
        vals = [rebuild(ts, i) for i in items]
        return kind(*vals) if hasattr(kind, "_fields") else kind(vals)
    return tuple(leaves), rebuild


def _call(name: str, args, kwargs):
    """Run the table's function ``name`` on ``args``/``kwargs``: NDArray
    leaves anywhere in them (lists included) become ``apply_op`` inputs,
    everything else is closed over. ``out=`` is written into."""
    fn = _table.FUNCS[name]
    out_arr = kwargs.pop("out", None)
    arrays = []
    spec = _mark((tuple(args), dict(kwargs)), arrays)
    # no array: the current context, resolved only when a tensor is made
    dev = next((a._data.device for a in arrays), None) or \
        _table.tensor_device(spec)
    with _table.on_device(dev):
        if not arrays or name in _table.HOST or name in _table.UNTAPED:
            pos, kws = _fill(spec, [a._data for a in arrays])
            res = _wrap(fn(*pos, **kws))
        else:
            shape = {}

            def raw(*datas):
                pos, kws = _fill(spec, datas)
                out = fn(*pos, **kws)
                flat, rebuild = _flat(out)
                if flat is None:
                    raise TypeError(f"mx.np.{name} returned "
                                    f"{type(out).__name__}, not arrays")
                shape["rebuild"] = rebuild
                shape["multi"] = not isinstance(out, torch.Tensor)
                return flat if shape["multi"] else flat[0]
            res = apply_op(raw, arrays, name, n_out=None)
            if shape["multi"]:
                res = shape["rebuild"](res if isinstance(res, tuple)
                                       else (res,))
    if out_arr is not None:
        if not isinstance(res, NDArray):
            raise TypeError(f"mx.np.{name}: out= takes one array result")
        out_arr._set_data(res._data.to(out_arr.dtype))
        return out_arr
    return res


def _function(name):
    def fn(*args, **kwargs):
        return _call(name, args, kwargs)
    fn.__name__ = name
    fn.__qualname__ = f"np.{name}"
    fn.__doc__ = getattr(_table.FUNCS[name], "__doc__", None)
    return fn


class _Submodule:
    """``mx.np.linalg`` / ``mx.np.fft``: the table's ``<prefix>_<name>``
    functions under their own names."""

    def __init__(self, prefix, names):
        self._prefix = prefix
        self._names = names
        self.__name__ = f"mxtpu_torch.numpy.{prefix}"

    def __getattr__(self, fname):
        if fname not in self._names:
            raise AttributeError(f"module 'mxtpu_torch.numpy.{self._prefix}'"
                                 f" has no attribute {fname!r}")
        fn = _function(f"{self._prefix}_{fname}")
        fn.__name__ = fname
        setattr(self, fname, fn)
        return fn

    def __dir__(self):
        return sorted(self._names)


linalg = _Submodule("linalg", _table.LINALG)
fft = _Submodule("fft", _table.FFT)

def __getattr__(name):
    if name == "random":
        import importlib
        m = importlib.import_module("mxtpu_torch.numpy.random")
        globals()["random"] = m
        return m
    if name in _table.CONSTANTS:
        return _table.CONSTANTS[name]
    if name in _table.FUNCS:
        fn = _function(name)
        globals()[name] = fn
        return fn
    raise AttributeError(f"module 'mxtpu_torch.numpy' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(set(globals()) | set(_table.FUNCS) | set(_table.CONSTANTS)
                  | {"random", "linalg", "fft"})


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _shape(shape):
    return (int(shape),) if isinstance(shape, (int, _onp.integer)) \
        else tuple(int(s) for s in shape)


def array(obj, dtype=None, ctx=None, copy=True) -> ndarray:
    """A new array on ``ctx`` (None: the current context, the card
    outside a ``with`` scope). Without ``dtype`` an array keeps its
    dtype, float64 host data becomes float32 (the reference's
    ``_np_default_dtype``) and other host data keeps NumPy's dtype."""
    dt = None if dtype is None else dtype_torch(dtype)
    if isinstance(obj, NDArray):
        obj = obj._data
    if isinstance(obj, torch.Tensor):
        dev = obj.device if ctx is None else resolve_device(ctx)
        t = obj.detach().to(dev, dt or obj.dtype, copy=copy)
        return ndarray(t)
    val = _onp.asarray(obj)
    if val.dtype == _onp.float64 and dt is None:
        dt = _np_default_dtype
    if val.dtype.kind not in "biufc":
        raise TypeError(f"cannot make an mx.np array of {val.dtype}")
    t = torch.tensor(val.astype(_onp.float32) if dt == torch.bfloat16
                     else val, device=resolve_device(ctx))
    return ndarray(t if dt is None else t.to(dt))


def asarray(obj, dtype=None, ctx=None) -> ndarray:
    if isinstance(obj, ndarray) and (dtype is None
                                     or dtype_torch(dtype) == obj.dtype) \
            and ctx is None:
        return obj
    return array(obj, dtype=dtype, ctx=ctx, copy=False)


def _dt(dtype, default=torch.float32):
    return default if dtype is None else dtype_torch(dtype)


def zeros(shape, dtype=None, ctx=None, order="C") -> ndarray:
    return ndarray(torch.zeros(_shape(shape), dtype=_dt(dtype),
                               device=resolve_device(ctx)))


def ones(shape, dtype=None, ctx=None, order="C") -> ndarray:
    return ndarray(torch.ones(_shape(shape), dtype=_dt(dtype),
                              device=resolve_device(ctx)))


def empty(shape, dtype=None, ctx=None, order="C") -> ndarray:
    return zeros(shape, dtype, ctx)


def full(shape, fill_value, dtype=None, ctx=None, order="C") -> ndarray:
    dev = resolve_device(ctx)
    if isinstance(fill_value, NDArray):
        fill = fill_value._data.to(dev)
        out = torch.broadcast_to(fill, _shape(shape)).clone()
    else:
        out = torch.full(_shape(shape), fill_value, device=dev)
    return ndarray(out if dtype is None else out.to(dtype_torch(dtype)))


def arange(start, stop=None, step=None, dtype=None, ctx=None) -> ndarray:
    with _table.on_device(resolve_device(ctx)):
        return ndarray(_table.arange(start, stop, step, dtype=dtype))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None):
    with _table.on_device(resolve_device(ctx)):
        return _wrap(_table.linspace(start, stop, num, endpoint, retstep,
                                     dtype, axis))


def eye(N, M=None, k=0, dtype=None, ctx=None) -> ndarray:
    with _table.on_device(resolve_device(ctx)):
        return ndarray(_table.eye(N, M, k, dtype))


def take(a, indices, axis=None, mode="raise", out=None):
    """``np.take`` with the method's refusal of ``mode='raise'``;
    parameters in the reference's order (``mode`` before ``out``)."""
    if out is not None:
        raise NotImplementedError(
            "take(out=...) is not supported: use the return value")
    if not isinstance(a, ndarray):
        a = from_nd(a) if isinstance(a, NDArray) else array(a)
    return a.take(indices, axis=axis, mode=mode)


# the scalar types and other names that are not functions of arrays
globals().update(_table.TYPES)
