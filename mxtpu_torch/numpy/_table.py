"""The functions of ``mx.np``: one entry per callable ``jax.numpy``
serves, each written on torch ops with NumPy's signature.

Every function takes tensors where the caller gave arrays (``mx.np``'s
funnel has already unwrapped them) and anything array-like where the
caller gave host data, which ``_t`` puts on the call's device (the
device of the first array input, else the current context). Promotion
is NumPy's as ``jax.numpy`` has it (``promote``): torch's own table
agrees on every pair torch computes; the wide unsigned types, which
torch barely computes in, are computed in int64 and cast back.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Dict

import numpy as np
import torch

from ..base import DTYPES, dtype_torch

FUNCS: Dict[str, Any] = {}
HOST = set()        # results are host values: never recorded
UNTAPED = set()     # data-dependent shapes: run eagerly, unrecorded
LINALG = set()
FFT = set()

_tls = threading.local()


@contextlib.contextmanager
def on_device(dev):
    prev = getattr(_tls, "dev", None)
    _tls.dev = dev
    try:
        yield
    finally:
        _tls.dev = prev


def _dev():
    dev = getattr(_tls, "dev", None)
    if dev is None:
        from ..context import resolve_device
        dev = resolve_device(None)
    return dev


def tensor_device(spec):
    """The device of the first tensor anywhere in ``spec``."""
    if isinstance(spec, torch.Tensor):
        return spec.device
    if isinstance(spec, (list, tuple)):
        for v in spec:
            d = tensor_device(v)
            if d is not None:
                return d
    if isinstance(spec, dict):
        return tensor_device(list(spec.values()))
    return None


def fn(*names, host=False, untaped=False):
    """Register a function under ``names`` (``linalg_x``/``fft_x`` go
    to the submodules)."""
    def deco(f):
        for n in names or (f.__name__,):
            FUNCS[n] = f
            if host:
                HOST.add(n)
            if untaped:
                UNTAPED.add(n)
            if n.startswith("linalg_"):
                LINALG.add(n[7:])
            elif n.startswith("fft_"):
                FFT.add(n[4:])
        return f
    return deco


# ---------------------------------------------------------------------------
# conversion and promotion
# ---------------------------------------------------------------------------
_WIDE_U = (torch.uint16, torch.uint32, torch.uint64)
_UNSIGNED = (torch.uint8,) + _WIDE_U
_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)
_BITS = {torch.uint8: 8, torch.uint16: 16, torch.uint32: 32,
         torch.uint64: 64, torch.int8: 8, torch.int16: 16, torch.int32: 32,
         torch.int64: 64}


def _is_float(dt):
    return dt.is_floating_point


def _is_int(dt):
    return dt in _UNSIGNED or dt in _SIGNED


def promote(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """``jnp.promote_types`` on torch dtypes."""
    if a == b:
        return a
    if a not in _WIDE_U and b not in _WIDE_U:
        return torch.promote_types(a, b)
    if b in _WIDE_U:
        a, b = b, a
    if b == torch.bool or (b in _UNSIGNED and _BITS[b] <= _BITS[a]):
        return a
    if b in _UNSIGNED:
        return b
    if b in _SIGNED:
        if a == torch.uint64:
            return torch.float64
        need = 2 * _BITS[a]
        return {16: torch.int32, 32: torch.int32, 64: torch.int64}[
            max(need, _BITS[b])] if need <= 64 else torch.int64
    return b                           # floating or complex


def _t(x, dtype=None):
    """``x`` as a tensor on the call's device; a Python float (or list of
    them) is float32, a Python int int64, host arrays keep their dtype."""
    if isinstance(x, torch.Tensor):
        t = x
    elif isinstance(x, (list, tuple)) and any(
            isinstance(v, torch.Tensor) for v in _leaves(x)):
        parts = [_t(v) for v in x]
        dt = functools.reduce(promote, [p.dtype for p in parts])
        t = torch.stack([p.to(dt) for p in parts]) if parts else \
            torch.zeros(0)
    else:
        a = np.asarray(x)
        if a.dtype.kind not in "biufc":
            raise TypeError(f"cannot make an array of {type(x).__name__}")
        host = not isinstance(x, (np.ndarray, np.generic))
        if host and a.dtype == np.float64:
            a = a.astype(np.float32)
        elif host and a.dtype == np.complex128:
            a = a.astype(np.complex64)
        t = torch.tensor(a, device=_dev())
    return t if dtype is None else t.to(dtype_torch(dtype))


def _leaves(x):
    for v in x:
        if isinstance(v, (list, tuple)):
            yield from _leaves(v)
        else:
            yield v


def _weak(x):
    return isinstance(x, (bool, int, float, complex)) and \
        not isinstance(x, np.generic)


def result_dtype(*xs) -> torch.dtype:
    """The dtype of an op on ``xs``: arrays by ``promote``, Python
    scalars weakly (they never widen an array of their kind)."""
    strong = [_t(x).dtype for x in xs if not _weak(x) and x is not None]
    dt = functools.reduce(promote, strong) if strong else None
    for x in xs:
        if not _weak(x):
            continue
        kind = (torch.bool if isinstance(x, bool) else
                torch.int64 if isinstance(x, int) else
                torch.float32 if isinstance(x, float) else torch.complex64)
        if dt is None:
            dt = kind
        elif kind == torch.int64 and dt == torch.bool:
            dt = torch.int64
        elif kind == torch.float32 and not (_is_float(dt)
                                            or dt.is_complex):
            dt = torch.float32
        elif kind == torch.complex64 and not dt.is_complex:
            dt = torch.complex128 if dt == torch.float64 else \
                torch.complex64
    return dt


def _as(x, dt):
    """``x`` as a tensor of ``dt``: a Python scalar straight into ``dt``
    (never through float32)."""
    dt = dtype_torch(dt)
    if _weak(x):
        return torch.tensor(x, dtype=dt, device=_dev())
    return _t(x).to(dt)


def _args(*xs, dtype=None):
    dt = result_dtype(*xs) if dtype is None else dtype_torch(dtype)
    return [_as(x, dt) for x in xs], dt


def _back(t, dt):
    if t.dtype == dt or dt not in _WIDE_U:
        return t
    return t.view(torch.uint64) if dt == torch.uint64 else t.to(dt)


def _float(x):
    """``x`` as a floating tensor (ints and bools become float32)."""
    t = _t(x)
    if t.is_floating_point() or t.is_complex():
        return t
    return t.to(torch.float32)


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(a % max(ndim, 1) for a in axis)
    return (axis % max(ndim, 1),)


def _f64(v):
    """``v`` as a float64 tensor (a Python float is not rounded to
    float32 on the way)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float64)
    return torch.tensor(np.asarray(v, dtype=np.float64), device=_dev())


def _kd(out, x, axis, keepdims):
    if keepdims:
        for a in sorted(_axes(axis, x.ndim)):
            out = out.unsqueeze(a)
    return out


# ---------------------------------------------------------------------------
# scalar types, constants, host names
# ---------------------------------------------------------------------------
class ScalarType:
    """``mx.np.float32`` and friends: calling one casts to it (as the
    reference's wrapped ``jnp.float32`` does); it also stands for its
    dtype (``dtype_torch``, ``==`` a ``torch.dtype``)."""

    def __init__(self, name: str, torch_dtype):
        self.__name__ = name
        self.torch_dtype = torch_dtype
        self.dtype = np.dtype(name) if name in (
            "bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16",
            "int32", "int64", "float16", "float32", "float64", "complex64",
            "complex128") else None

    def __call__(self, x=0):
        if self.torch_dtype is None:
            raise TypeError(f"mx.np.{self.__name__}: torch has no such "
                            "dtype")
        from . import ndarray
        from ..ndarray.ndarray import NDArray
        if isinstance(x, NDArray):
            return ndarray(x._data.to(self.torch_dtype))
        return ndarray(_as(x, self.torch_dtype))

    def __eq__(self, other):
        try:
            return dtype_torch(other) == self.torch_dtype
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.torch_dtype)

    def __repr__(self):
        return f"<mx.np.{self.__name__}>"


_TYPE_NAMES = {
    "bool": "bool", "bool_": "bool", "uint8": "uint8", "uint16": "uint16",
    "uint32": "uint32", "uint64": "uint64", "uint": "uint64",
    "int8": "int8", "int16": "int16", "int32": "int32", "int64": "int64",
    "int_": "int64", "float16": "float16", "bfloat16": "bfloat16",
    "float32": "float32", "single": "float32", "float64": "float64",
    "double": "float64", "float_": "float64", "complex64": "complex64",
    "csingle": "complex64", "complex128": "complex128",
    "cdouble": "complex128", "complex_": "complex128",
    "float8_e4m3fn": "float8_e4m3fn", "float8_e5m2": "float8_e5m2",
    "float8_e4m3fnuz": "float8_e4m3fnuz",
    "float8_e5m2fnuz": "float8_e5m2fnuz",
    "float8_e8m0fnu": "float8_e8m0fnu",
    # types torch does not have
    "int2": None, "int4": None, "uint2": None, "uint4": None,
    "float4_e2m1fn": None, "float8_e3m4": None, "float8_e4m3": None,
    "float8_e4m3b11fnuz": None,
}

TYPES: Dict[str, Any] = {}
for _name, _tname in _TYPE_NAMES.items():
    _tdt = DTYPES.get(_tname) if _tname else None
    if _tdt is None and _tname:
        _tdt = getattr(torch, _tname, None)
    TYPES[_name] = ScalarType(_name, _tdt)
# NumPy's abstract type classes: for issubdtype, never called
for _name in ("character", "complexfloating", "flexible", "floating",
              "generic", "inexact", "integer", "number", "object_",
              "signedinteger", "unsignedinteger"):
    TYPES[_name] = getattr(np, _name)
TYPES["ComplexWarning"] = np.exceptions.ComplexWarning
FUNCS.update({k: v for k, v in TYPES.items()
              if isinstance(v, ScalarType)})
HOST.update(k for k, v in TYPES.items() if isinstance(v, ScalarType))

CONSTANTS = {"pi": math.pi, "e": math.e, "inf": math.inf,
             "nan": math.nan, "newaxis": None,
             "euler_gamma": 0.5772156649015329, "s_": np.s_,
             "index_exp": np.index_exp}


def _np_dtype(x):
    """A dtype-ish value (or an array) as a NumPy dtype, for the host
    predicates (bfloat16 has none: it reads as float32's kind)."""
    if isinstance(x, ScalarType):
        x = x.torch_dtype
    if isinstance(x, torch.Tensor):
        x = x.dtype
    if isinstance(x, torch.dtype):
        name = {v: k for k, v in DTYPES.items()}.get(x)
        if name is None or name == "bfloat16":
            return np.dtype(np.float32) if x == torch.bfloat16 else \
                np.dtype(str(x).replace("torch.", ""))
        return np.dtype(name)
    if isinstance(x, type) and issubclass(x, np.generic):
        return x
    return np.dtype(x)


@fn("dtype", host=True)
def dtype_(x, align=False, copy=False):
    return dtype_torch(x.torch_dtype if isinstance(x, ScalarType) else x)


@fn(host=True)
def finfo(x):
    return torch.finfo(x.dtype if isinstance(x, torch.Tensor)
                       else dtype_(x))


@fn(host=True)
def iinfo(x):
    return torch.iinfo(x.dtype if isinstance(x, torch.Tensor)
                       else dtype_(x))


@fn(host=True)
def promote_types(a, b):
    return promote(dtype_(a), dtype_(b))


@fn(host=True)
def result_type(*args):
    return result_dtype(*[a.torch_dtype if isinstance(a, ScalarType) else
                          torch.zeros((), dtype=dtype_(a))
                          if isinstance(a, (str, torch.dtype, np.dtype))
                          else a for a in args])


@fn(host=True)
def can_cast(from_, to, casting="safe"):
    return bool(np.can_cast(_np_dtype(from_), _np_dtype(to), casting))


@fn(host=True)
def issubdtype(arg1, arg2):
    a = _np_dtype(arg1)
    b = arg2 if isinstance(arg2, type) and issubclass(arg2, np.generic) \
        else _np_dtype(arg2)
    return bool(np.issubdtype(a, b))


@fn(host=True)
def isdtype(dtype_, kind):
    return bool(np.isdtype(_np_dtype(dtype_), kind))


@fn(host=True)
def iscomplexobj(x):
    return isinstance(x, torch.Tensor) and x.is_complex() or \
        isinstance(x, complex)


@fn(host=True)
def isrealobj(x):
    return not iscomplexobj(x)


@fn(host=True)
def isscalar(element):
    if isinstance(element, torch.Tensor):
        return element.ndim == 0
    return bool(np.isscalar(element))


@fn(host=True)
def iterable(y):
    if isinstance(y, torch.Tensor):
        return y.ndim > 0
    try:
        iter(y)
    except TypeError:
        return False
    return True


@fn("shape", host=True)
def shape_(a):
    return tuple(_t(a).shape) if not isinstance(a, torch.Tensor) \
        else tuple(a.shape)


@fn("ndim", host=True)
def ndim_(a):
    return len(shape_(a))


@fn("size", host=True)
def size_(a, axis=None):
    s = shape_(a)
    return math.prod(s) if axis is None else s[axis]


@fn(host=True)
def broadcast_shapes(*shapes):
    return tuple(torch.broadcast_shapes(*[
        (s,) if isinstance(s, int) else tuple(s) for s in shapes]))


@fn(host=True)
def get_printoptions():
    return np.get_printoptions()


@fn(host=True)
def set_printoptions(*args, **kwargs):
    return np.set_printoptions(*args, **kwargs)


@fn(host=True)
def printoptions(*args, **kwargs):
    return np.printoptions(*args, **kwargs)


def _host(x):
    t = x.detach()
    if t.is_floating_point() and (t.dtype == torch.bfloat16
                                  or t.element_size() == 1):
        t = t.float()
    return t.cpu().numpy()


@fn(host=True)
def array_repr(arr, max_line_width=None, precision=None,
               suppress_small=None):
    return np.array_repr(_host(_t(arr)), max_line_width, precision,
                         suppress_small)


@fn(host=True)
def array_str(a, max_line_width=None, precision=None, suppress_small=None):
    return np.array_str(_host(_t(a)), max_line_width, precision,
                        suppress_small)


@fn(host=True)
def ufunc(*args, **kwargs):
    raise TypeError("mx.np.ufunc is not ported: the reference's wrapper "
                    "cannot return a ufunc either; write the function on "
                    "mx.np arrays")


@fn(host=True)
def frompyfunc(func, nin, nout, *, identity=None):
    raise TypeError("mx.np.frompyfunc is not ported: the reference's "
                    "wrapper cannot return a ufunc either; use "
                    "mx.np.vectorize")


@fn(host=True)
def vectorize(pyfunc, *, excluded=frozenset(), signature=None):
    """``pyfunc`` mapped over the broadcast elements of its array
    arguments (``torch.vmap``, as ``jnp.vectorize`` vmaps); the function
    is called with 0-d ``mx.np`` arrays."""
    if signature is not None:
        raise NotImplementedError("vectorize(signature=...) is not ported")

    @functools.wraps(pyfunc)
    def wrapper(*args, **kwargs):
        from . import ndarray
        from ..ndarray.ndarray import NDArray
        pos = [i for i, a in enumerate(args)
               if i not in excluded and not isinstance(a, str)]
        arrs = [args[i]._data if isinstance(args[i], NDArray)
                else _t(args[i]) for i in pos]
        shape_ = torch.broadcast_shapes(*[a.shape for a in arrs])
        flat = [torch.broadcast_to(a, shape_).reshape(-1) for a in arrs]

        def one(*elems):
            call = list(args)
            for i, e in zip(pos, elems):
                call[i] = ndarray(e)
            out = pyfunc(*call, **kwargs)
            return out._data if isinstance(out, NDArray) else _t(out)
        out = torch.vmap(one)(*flat)
        return ndarray(out.reshape(shape_))
    return wrapper


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------
def _unary(torch_fn, floating=False):
    def f(x, /, out=None, **kw):
        t = _float(x) if floating else _t(x)
        return torch_fn(t)
    return f


for _names, _f, _fl in [
        (("sin",), torch.sin, True), (("cos",), torch.cos, True),
        (("tan",), torch.tan, True), (("arcsin", "asin"), torch.asin, True),
        (("arccos", "acos"), torch.acos, True),
        (("arctan", "atan"), torch.atan, True), (("sinh",), torch.sinh, True),
        (("cosh",), torch.cosh, True), (("tanh",), torch.tanh, True),
        (("arcsinh", "asinh"), torch.asinh, True),
        (("arccosh", "acosh"), torch.acosh, True),
        (("arctanh", "atanh"), torch.atanh, True),
        (("exp",), torch.exp, True), (("exp2",), torch.exp2, True),
        (("expm1",), torch.expm1, True), (("log",), torch.log, True),
        (("log10",), torch.log10, True), (("log2",), torch.log2, True),
        (("log1p",), torch.log1p, True), (("sqrt",), torch.sqrt, True),
        (("deg2rad", "radians"), torch.deg2rad, True),
        (("rad2deg", "degrees"), torch.rad2deg, True),
        (("sinc",), torch.sinc, True), (("i0",), torch.special.i0, True),
        (("negative",), torch.neg, False),
        (("positive",), lambda t: t.clone(), False),
        (("square",), torch.square, False),
        (("isnan",), torch.isnan, False), (("isinf",), torch.isinf, False),
        (("isfinite",), torch.isfinite, False),
        (("isposinf",), torch.isposinf, False),
        (("isneginf",), torch.isneginf, False),
        (("signbit",), torch.signbit, False),
        (("logical_not",), torch.logical_not, False),
        (("invert", "bitwise_not", "bitwise_invert"), torch.bitwise_not,
         False)]:
    fn(*_names)(_unary(_f, _fl))


@fn("cbrt")
def cbrt(x, /):
    t = _float(x)
    r = torch.abs(t) ** (1.0 / 3.0)
    r = r - (r * r * r - torch.abs(t)) / (3 * r * r)     # one Newton step
    r = torch.where(t == 0, t, r)
    return torch.copysign(r, t)


@fn("abs", "absolute")
def absolute(x, /):
    t = _t(x)
    return t.clone() if t.dtype == torch.bool or t.dtype in _UNSIGNED \
        else torch.abs(t)


@fn()
def fabs(x, /):
    return torch.abs(_float(x))


@fn()
def reciprocal(x, /):
    t = _t(x)
    return torch.reciprocal(t) if t.is_floating_point() or t.is_complex() \
        else torch.div(1, t, rounding_mode="trunc").to(t.dtype)


@fn()
def sign(x, /):
    t = _t(x)
    return torch.sgn(t) if t.is_complex() else torch.sign(t)


@fn()
def ceil(x, /):
    t = _t(x)
    return torch.ceil(t) if t.is_floating_point() else t.clone()


@fn()
def floor(x, /):
    t = _t(x)
    return torch.floor(t) if t.is_floating_point() else t.clone()


@fn()
def trunc(x, /):
    t = _t(x)
    return torch.trunc(t) if t.is_floating_point() else t.clone()


@fn()
def rint(x, /):
    t = _t(x)
    return torch.round(t) if t.is_floating_point() else t.to(
        torch.float32)


@fn("round", "around")
def round_(a, decimals=0, out=None):
    t = _t(a)
    if not (t.is_floating_point() or t.is_complex()):
        if decimals >= 0:
            return t.clone()
        f = 10 ** (-decimals)
        return (torch.round(t.double() / f) * f).to(t.dtype)
    if t.is_complex():
        return torch.complex(round_(t.real, decimals),
                             round_(t.imag, decimals))
    if decimals == 0:
        return torch.round(t)
    f = 10.0 ** decimals
    return torch.round(t * f) / f


@fn()
def fix(x, /):
    return trunc(x)


@fn("conj", "conjugate")
def conjugate(x, /):
    t = _t(x)
    return torch.conj(t).resolve_conj() if t.is_complex() else t.clone()


@fn()
def real(val, /):
    t = _t(val)
    return t.real.clone() if t.is_complex() else t.clone()


@fn()
def imag(val, /):
    t = _t(val)
    return t.imag.clone() if t.is_complex() else torch.zeros_like(t)


@fn()
def angle(z, deg=False):
    t = _t(z)
    if not (t.is_floating_point() or t.is_complex()):
        t = t.to(torch.float32)
    out = torch.angle(t)
    return torch.rad2deg(out) if deg else out


@fn()
def isreal(x):
    t = _t(x)
    return t.imag == 0 if t.is_complex() else torch.ones_like(
        t, dtype=torch.bool)


@fn()
def iscomplex(x):
    t = _t(x)
    return t.imag != 0 if t.is_complex() else torch.zeros_like(
        t, dtype=torch.bool)


@fn()
def spacing(x, /):
    t = _float(x)
    a = torch.abs(t)
    sp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    return torch.where(t < 0, -sp, sp)


@fn()
def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    t = _t(x)
    if not (t.is_floating_point() or t.is_complex()):
        return t.clone()
    return torch.nan_to_num(t, nan, posinf, neginf)


@fn()
def bitwise_count(x, /):
    t = _t(x)
    v = torch.abs(t.to(torch.int64)) if t.dtype in _SIGNED else \
        t.to(torch.int64)
    bits = _BITS.get(t.dtype, 8)
    count = torch.zeros_like(v)
    for i in range(bits):
        count += (v >> i) & 1
    return count.to(torch.uint8)


@fn()
def frexp(x, /):
    m, e = torch.frexp(_float(x))
    return m, e.to(torch.int32)


@fn()
def modf(x, /, out=None):
    t = _float(x)
    i = torch.trunc(t)
    return t - i, i


@fn()
def ldexp(x1, x2, /):
    a = _float(x1)
    return torch.ldexp(a, _t(x2)).to(a.dtype)


def _binary(torch_fn, floating=False, boolean=False, cmp=False):
    def f(x1, x2, /, out=None, **kw):
        (a, b), dt = _args(x1, x2)
        if floating and not (_is_float(dt) or dt.is_complex):
            a, b = a.to(torch.float32), b.to(torch.float32)
        elif dt in _WIDE_U and not cmp:
            return _back(torch_fn(a.to(torch.int64), b.to(torch.int64)),
                         dt)
        elif dt in _WIDE_U:
            a, b = a.to(torch.int64), b.to(torch.int64)
        return torch_fn(a, b)
    return f


for _names, _f, _kw in [
        (("add",), torch.add, {}), (("subtract",), torch.sub, {}),
        (("multiply",), torch.mul, {}),
        (("divide", "true_divide"), torch.div, {"floating": True}),
        (("floor_divide",), torch.floor_divide, {}),
        (("mod", "remainder"), torch.remainder, {}),
        (("fmod",), torch.fmod, {}),
        (("maximum",), torch.maximum, {}), (("minimum",), torch.minimum, {}),
        (("fmax",), torch.fmax, {}), (("fmin",), torch.fmin, {}),
        (("hypot",), torch.hypot, {"floating": True}),
        (("arctan2", "atan2"), torch.atan2, {"floating": True}),
        (("logaddexp",), torch.logaddexp, {"floating": True}),
        (("logaddexp2",), torch.logaddexp2, {"floating": True}),
        (("copysign",), torch.copysign, {"floating": True}),
        (("nextafter",), torch.nextafter, {"floating": True}),
        (("heaviside",), torch.heaviside, {"floating": True}),
        (("gcd",), torch.gcd, {}), (("lcm",), torch.lcm, {}),
        (("bitwise_and",), torch.bitwise_and, {}),
        (("bitwise_or",), torch.bitwise_or, {}),
        (("bitwise_xor",), torch.bitwise_xor, {}),
        (("left_shift", "bitwise_left_shift"), torch.bitwise_left_shift, {}),
        (("right_shift", "bitwise_right_shift"),
         torch.bitwise_right_shift, {}),
        (("logical_and",), torch.logical_and, {"cmp": True}),
        (("logical_or",), torch.logical_or, {"cmp": True}),
        (("logical_xor",), torch.logical_xor, {"cmp": True}),
        (("equal",), torch.eq, {"cmp": True}),
        (("not_equal",), torch.ne, {"cmp": True}),
        (("greater",), torch.gt, {"cmp": True}),
        (("greater_equal",), torch.ge, {"cmp": True}),
        (("less",), torch.lt, {"cmp": True}),
        (("less_equal",), torch.le, {"cmp": True})]:
    fn(*_names)(_binary(_f, **_kw))


@fn("power", "pow")
def power(x1, x2, /):
    (a, b), dt = _args(x1, x2)
    if dt in _WIDE_U:
        return _back(torch.pow(a.to(torch.int64), b.to(torch.int64)), dt)
    return torch.pow(a, b)


@fn()
def float_power(x1, x2, /):
    (a, b), dt = _args(x1, x2)
    wide = torch.complex128 if dt.is_complex else torch.float64
    return torch.pow(a.to(wide), b.to(wide))


@fn("divmod")
def divmod_(x1, x2, /):
    f = FUNCS["floor_divide"](x1, x2)
    return f, FUNCS["mod"](x1, x2)


@fn()
def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    (x, y), dt = _args(a, b)
    if not (_is_float(dt) or dt.is_complex):
        x, y = x.to(torch.float32), y.to(torch.float32)
    return torch.isclose(x, y, rtol, atol, equal_nan)


@fn()
def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.all(isclose(a, b, rtol, atol, equal_nan))


@fn()
def array_equal(a1, a2, equal_nan=False):
    x, y = _t(a1), _t(a2)
    if x.shape != y.shape:
        return torch.tensor(False, device=x.device)
    eq = x == y
    if equal_nan and (x.is_floating_point() or x.is_complex()):
        eq = eq | (torch.isnan(x) & torch.isnan(y))
    return torch.all(eq)


@fn()
def array_equiv(a1, a2):
    x, y = _t(a1), _t(a2)
    try:
        torch.broadcast_shapes(x.shape, y.shape)
    except RuntimeError:
        return torch.tensor(False, device=x.device)
    return torch.all(x == y)


@fn()
def clip(arr=None, /, min=None, max=None, *, a=None, a_min=None,
         a_max=None):
    t = _t(arr if arr is not None else a)
    lo = min if min is not None else a_min
    hi = max if max is not None else a_max
    dt = result_dtype(*[v for v in (t, lo, hi) if v is not None])
    t = t.to(dt)
    if lo is not None:
        t = torch.maximum(t, _as(lo, dt))
    if hi is not None:
        t = torch.minimum(t, _as(hi, dt))
    return t


@fn()
def where(condition, x=None, y=None, /):
    c = _t(condition)
    if x is None and y is None:
        return nonzero(c)
    (a, b), _ = _args(x, y)
    return torch.where(c.bool(), a, b)



# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _dim(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _acc(t, dtype):
    """NumPy's accumulator: small ints and bool sum in int64, uints in
    uint64 (computed in int64)."""
    if dtype is not None:
        return t.to(dtype_torch(dtype))
    if t.dtype == torch.bool or t.dtype in _SIGNED:
        return t.to(torch.int64)
    if t.dtype in _UNSIGNED:
        return t.to(torch.int64)
    return t


def _acc_back(out, t, dtype):
    if dtype is None and t.dtype in _UNSIGNED:
        return _back(out, torch.uint64)
    return out


def _where_fill(t, where, fill):
    if where is None:
        return t
    return torch.where(_t(where).bool(), t, torch.full_like(t, fill))


@fn("sum")
def sum_(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
         where=None, promote_integers=True):
    t = _acc(_t(a), dtype)
    t = _where_fill(t, where, 0)
    r = torch.sum(t, dim=_dim(axis), keepdim=keepdims) if axis is not None \
        else _kd(torch.sum(t), t, None, keepdims)
    if initial is not None:
        r = r + initial
    return _acc_back(r, _t(a), dtype)


@fn("prod")
def prod_(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
          where=None, promote_integers=True):
    t = _acc(_t(a), dtype)
    t = _where_fill(t, where, 1)
    r = t
    for ax in sorted(_axes(axis, t.ndim), reverse=True):
        r = torch.prod(r, dim=ax, keepdim=keepdims)
    if t.ndim == 0:
        r = t.clone()
    if initial is not None:
        r = r * initial
    return _acc_back(r, _t(a), dtype)


def _mean_in(t, dtype):
    if dtype is not None:
        return t.to(dtype_torch(dtype))
    return t if t.is_floating_point() or t.is_complex() else \
        t.to(torch.float32)


@fn()
def mean(a, axis=None, dtype=None, out=None, keepdims=False, *, where=None):
    t = _mean_in(_t(a), dtype)
    if where is not None:
        w = torch.broadcast_to(_t(where).bool(), t.shape)
        return sum_(t * w, axis, keepdims=keepdims) / sum_(
            w, axis, keepdims=keepdims).to(t.dtype)
    if t.ndim == 0:
        return t.clone()
    return torch.mean(t, dim=_dim(axis), keepdim=keepdims)


@fn()
def var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, *,
        where=None, correction=None):
    t = _mean_in(_t(a), dtype)
    ddof = correction if correction is not None else ddof
    if t.ndim == 0:
        return torch.zeros_like(t) / (1 - ddof) if ddof else \
            torch.zeros_like(t)
    m = torch.mean(t, dim=_dim(axis), keepdim=True)
    d = t - m
    sq = (d * d.conj()).real if t.is_complex() else d * d
    n = math.prod(t.shape[i] for i in _axes(axis, t.ndim))
    return torch.sum(sq, dim=_dim(axis), keepdim=keepdims) / (n - ddof)


@fn()
def std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, *,
        where=None, correction=None):
    return torch.sqrt(var(a, axis, dtype, None, ddof, keepdims,
                          correction=correction))


def _minmax(torch_fn):
    def f(a, axis=None, out=None, keepdims=False, initial=None,
          where=None):
        t = _t(a)
        if where is not None:
            t = _where_fill(t, where, initial)
        if t.ndim == 0:
            r = t.clone()
        elif axis is None:
            r = _kd(torch_fn(t.reshape(-1), dim=0), t, None, keepdims)
        else:
            r = torch_fn(t, dim=_dim(axis), keepdim=keepdims)
        if initial is not None:
            r = (torch.maximum if torch_fn is torch.amax else
                 torch.minimum)(r, torch.tensor(initial, dtype=r.dtype,
                                                device=r.device))
        return r
    return f


FUNCS["max"] = FUNCS["amax"] = _minmax(torch.amax)
FUNCS["min"] = FUNCS["amin"] = _minmax(torch.amin)


def _arg(torch_fn):
    def f(a, axis=None, out=None, keepdims=False):
        t = _t(a)
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        if axis is None:
            r = torch_fn(t.reshape(-1), dim=0)
            return r.reshape((1,) * t.ndim) if keepdims else r
        return torch_fn(t, dim=axis, keepdim=keepdims)
    return f


FUNCS["argmax"] = _arg(torch.argmax)
FUNCS["argmin"] = _arg(torch.argmin)


@fn("all")
def all_(a, axis=None, out=None, keepdims=False, *, where=None):
    t = _t(a).bool()
    if where is not None:
        t = t | ~_t(where).bool()
    return torch.all(t, dim=_dim(axis), keepdim=keepdims) \
        if axis is not None else _kd(torch.all(t), t, None, keepdims)


@fn("any")
def any_(a, axis=None, out=None, keepdims=False, *, where=None):
    t = _t(a).bool()
    if where is not None:
        t = t & _t(where).bool()
    return torch.any(t, dim=_dim(axis), keepdim=keepdims) \
        if axis is not None else _kd(torch.any(t), t, None, keepdims)


@fn()
def ptp(a, axis=None, out=None, keepdims=False):
    return FUNCS["max"](a, axis, keepdims=keepdims) - \
        FUNCS["min"](a, axis, keepdims=keepdims)


@fn()
def count_nonzero(a, axis=None, keepdims=False):
    t = _t(a) != 0
    return sum_(t, axis, keepdims=keepdims)


@fn()
def nansum(a, axis=None, dtype=None, out=None, keepdims=False,
           initial=None, where=None):
    t = _t(a)
    if t.is_floating_point():
        t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
    return sum_(t, axis, dtype, None, keepdims, initial, where)


@fn()
def nanprod(a, axis=None, dtype=None, out=None, keepdims=False,
            initial=None, where=None):
    t = _t(a)
    if t.is_floating_point():
        t = torch.where(torch.isnan(t), torch.ones_like(t), t)
    return prod_(t, axis, dtype, None, keepdims, initial, where)


def _valid(t):
    return ~torch.isnan(t) if t.is_floating_point() else \
        torch.ones_like(t, dtype=torch.bool)


@fn()
def nanmean(a, axis=None, dtype=None, out=None, keepdims=False, where=None):
    t = _mean_in(_t(a), dtype)
    v = _valid(t)
    s = sum_(torch.where(v, t, torch.zeros_like(t)), axis,
             keepdims=keepdims)
    return s / sum_(v, axis, keepdims=keepdims).to(t.dtype)


@fn()
def nanvar(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
           where=None, correction=None):
    t = _mean_in(_t(a), dtype)
    ddof = correction if correction is not None else ddof
    v = _valid(t)
    m = nanmean(t, axis, keepdims=True)
    d = torch.where(v, t - m, torch.zeros_like(t))
    n = sum_(v, axis, keepdims=keepdims).to(t.dtype)
    return sum_(d * d, axis, keepdims=keepdims) / torch.clamp_min(
        n - ddof, 0)


@fn()
def nanstd(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
           where=None, correction=None):
    return torch.sqrt(nanvar(a, axis, dtype, None, ddof, keepdims,
                             correction=correction))


def _nanext(name, fill):
    def f(a, axis=None, out=None, keepdims=False, initial=None,
          where=None):
        t = _t(a)
        if not t.is_floating_point():
            return FUNCS[name](t, axis, keepdims=keepdims)
        v = _valid(t)
        r = FUNCS[name](torch.where(v, t, torch.full_like(t, fill)), axis,
                        keepdims=keepdims)
        none = ~any_(v, axis, keepdims=keepdims)
        return torch.where(none, torch.full_like(r, math.nan), r)
    return f


FUNCS["nanmax"] = _nanext("max", -math.inf)
FUNCS["nanmin"] = _nanext("min", math.inf)


def _nanarg(name, fill):
    def f(a, axis=None, out=None, keepdims=False):
        t = _t(a)
        if t.is_floating_point():
            t = torch.where(torch.isnan(t), torch.full_like(t, fill), t)
        return FUNCS[name](t, axis, keepdims=keepdims)
    return f


FUNCS["nanargmax"] = _nanarg("argmax", -math.inf)
FUNCS["nanargmin"] = _nanarg("argmin", math.inf)


def _quantile(a, q, axis, keepdims, method, ignore_nan):
    """NumPy's quantile (the methods 'linear', 'lower', 'higher',
    'nearest', 'midpoint') by a sort; NaNs propagate unless
    ``ignore_nan``."""
    t = _float(a)
    qt = _f64(q).to(t.dtype)
    axes = _axes(axis, t.ndim)
    keep = [i for i in range(t.ndim) if i not in axes]
    x = t.permute(keep + list(axes)).reshape(
        [t.shape[i] for i in keep] + [-1])
    srt = torch.sort(x, dim=-1)[0]          # NaNs last
    nan_any = torch.isnan(x).any(-1, keepdim=True)
    n = x.shape[-1]
    cnt = (~torch.isnan(x)).sum(-1, keepdim=True) if ignore_nan else \
        torch.full_like(x[..., :1], n, dtype=torch.int64)
    qs = qt.reshape(-1)
    outs = []
    for qv in qs:
        pos = qv * (cnt.to(t.dtype) - 1)
        lo = torch.floor(pos).clamp_min(0)
        hi = torch.ceil(pos).clamp_min(0)
        vlo = torch.gather(srt, -1, lo.long())
        vhi = torch.gather(srt, -1, hi.long())
        frac = pos - lo
        if method == "linear":
            r = vlo + (vhi - vlo) * frac
            r = torch.where(frac >= 0.5, vhi - (vhi - vlo) * (1 - frac), r)
        elif method == "lower":
            r = vlo
        elif method == "higher":
            r = vhi
        elif method == "midpoint":
            r = (vlo + vhi) / 2
        elif method == "nearest":
            rnd = torch.round(pos).long()
            r = torch.gather(srt, -1, rnd)
        else:
            raise ValueError(f"method {method!r} is not supported")
        if ignore_nan:
            r = torch.where(cnt == 0, torch.full_like(r, math.nan), r)
        else:
            r = torch.where(nan_any, torch.full_like(r, math.nan), r)
        r = r[..., 0]
        if keepdims:
            full = list(t.shape)
            for i in axes:
                full[i] = 1
            r = r.reshape(full)
        outs.append(r)
    out = torch.stack(outs)
    return out.reshape(tuple(qt.shape) + tuple(out.shape[1:]))


@fn()
def quantile(a, q, axis=None, out=None, overwrite_input=False,
             method="linear", keepdims=False, *, interpolation=None):
    return _quantile(a, q, axis, keepdims, interpolation or method, False)


@fn()
def nanquantile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False, *, interpolation=None):
    return _quantile(a, q, axis, keepdims, interpolation or method, True)


@fn()
def percentile(a, q, axis=None, out=None, overwrite_input=False,
               method="linear", keepdims=False, *, interpolation=None):
    return _quantile(a, _f64(q) / 100, axis, keepdims,
                     interpolation or method, False)


@fn()
def nanpercentile(a, q, axis=None, out=None, overwrite_input=False,
                  method="linear", keepdims=False, *, interpolation=None):
    return _quantile(a, _f64(q) / 100, axis, keepdims,
                     interpolation or method, True)


@fn()
def median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return _quantile(a, 0.5, axis, keepdims, "midpoint", False)


@fn()
def nanmedian(a, axis=None, out=None, overwrite_input=False,
              keepdims=False):
    return _quantile(a, 0.5, axis, keepdims, "midpoint", True)


@fn()
def average(a, axis=None, weights=None, returned=False, keepdims=False):
    t = _float(a)
    if weights is None:
        avg = mean(t, axis, keepdims=keepdims)
        scl = torch.full_like(avg, t.numel() / max(avg.numel(), 1))
    else:
        w = _t(weights).to(promote(t.dtype, _t(weights).dtype))
        if w.ndim != t.ndim:
            shp = [1] * t.ndim
            shp[axis % t.ndim] = -1
            w = w.reshape(shp)
        w = torch.broadcast_to(w, t.shape)
        scl = sum_(w, axis, keepdims=keepdims)
        avg = sum_(t * w, axis, keepdims=keepdims) / scl
    return (avg, torch.broadcast_to(scl, avg.shape).clone()) if returned \
        else avg


def _cum(torch_fn, nan_fill=None):
    def f(a, axis=None, dtype=None, out=None):
        t = _acc(_t(a), dtype)
        if nan_fill is not None and t.is_floating_point():
            t = torch.where(torch.isnan(t), torch.full_like(t, nan_fill), t)
        if axis is None:
            t, axis = t.reshape(-1), 0
        return _acc_back(torch_fn(t, dim=axis), _t(a), dtype)
    return f


FUNCS["cumsum"] = _cum(torch.cumsum)
FUNCS["cumprod"] = _cum(torch.cumprod)
FUNCS["nancumsum"] = _cum(torch.cumsum, 0.0)
FUNCS["nancumprod"] = _cum(torch.cumprod, 1.0)


def _cumulative(name, ident):
    def f(x, /, *, axis=None, dtype=None, include_initial=False):
        t = _t(x)
        if axis is None:
            if t.ndim > 1:
                raise ValueError(f"{name}: axis is required for an array "
                                 "of more than one dimension")
            axis = 0
        r = FUNCS[name[11:].replace("sum", "cumsum").replace(
            "prod", "cumprod")](t, axis, dtype)
        if include_initial:
            shp = list(r.shape)
            shp[axis % r.ndim] = 1
            r = torch.cat([torch.full(shp, ident, dtype=r.dtype,
                                      device=r.device), r], axis)
        return r
    return f


FUNCS["cumulative_sum"] = _cumulative("cumulative_sum", 0)
FUNCS["cumulative_prod"] = _cumulative("cumulative_prod", 1)


# ---------------------------------------------------------------------------
# shape
# ---------------------------------------------------------------------------
@fn()
def reshape(a, shape=None, order="C", *, newshape=None, copy=None):
    if order != "C":
        raise NotImplementedError(f"reshape(order={order!r})")
    shape = newshape if shape is None else shape
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.reshape(_t(a), tuple(int(s) for s in shape)).clone()


@fn()
def ravel(a, order="C"):
    if order != "C":
        raise NotImplementedError(f"ravel(order={order!r})")
    return _t(a).reshape(-1).clone()


@fn()
def transpose(a, axes=None):
    t = _t(a)
    return t.permute(*(reversed(range(t.ndim)) if axes is None
                       else axes)).clone()


@fn()
def permute_dims(a, /, axes=None):
    return transpose(a, axes)


@fn("matrix_transpose", "linalg_matrix_transpose")
def matrix_transpose(x, /):
    return _t(x).transpose(-1, -2).clone()


@fn()
def swapaxes(a, axis1, axis2):
    return torch.swapaxes(_t(a), axis1, axis2).clone()


@fn()
def moveaxis(a, source, destination):
    return torch.movedim(_t(a), source, destination).clone()


@fn()
def rollaxis(a, axis, start=0):
    t = _t(a)
    n = t.ndim
    axis %= n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    return moveaxis(t, axis, start)


@fn()
def squeeze(a, axis=None):
    t = _t(a)
    if axis is None:
        return t.squeeze().clone()
    axes = _axes(axis, t.ndim)
    for ax in axes:
        if t.shape[ax] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which "
                             f"has size not equal to one (axis {ax})")
    return t.squeeze(axes).clone()


@fn()
def expand_dims(a, axis):
    t = _t(a)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    n = t.ndim + len(axes)
    for ax in sorted(x % n for x in axes):
        t = t.unsqueeze(ax)
    return t.clone()


def _atleast(n):
    def one(t):
        t = _t(t)
        if t.ndim >= n:
            return t
        if n == 1 or t.ndim == 0:
            return t.reshape((1,) * (n - 1) + (-1,)) if n < 3 else \
                t.reshape(1, -1, 1)
        if n == 2:
            return t.reshape(1, -1)
        return t.reshape(1, *t.shape, 1) if t.ndim == 1 else \
            t.unsqueeze(-1)

    def f(*arys):
        res = [one(a).clone() for a in arys]
        return res[0] if len(res) == 1 else res
    return f


FUNCS["atleast_1d"] = _atleast(1)
FUNCS["atleast_2d"] = _atleast(2)
FUNCS["atleast_3d"] = _atleast(3)


@fn()
def broadcast_to(array, shape):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.broadcast_to(_t(array), shape).clone()


@fn()
def broadcast_arrays(*args):
    ts = [_t(a) for a in args]
    return [b.clone() for b in torch.broadcast_tensors(*ts)]


def _same(arrays, dtype=None):
    ts = [_t(a) for a in arrays]
    dt = dtype_torch(dtype) if dtype is not None else \
        functools.reduce(promote, [t.dtype for t in ts])
    return [t.to(dt) for t in ts]


@fn("concatenate", "concat")
def concatenate(arrays, axis=0, dtype=None, out=None, casting=None):
    ts = _same(arrays, dtype)
    if axis is None:
        ts, axis = [t.reshape(-1) for t in ts], 0
    return torch.cat(ts, dim=axis)


@fn()
def stack(arrays, axis=0, out=None, dtype=None):
    return torch.stack(_same(arrays, dtype), dim=axis)


@fn()
def vstack(tup, dtype=None):
    return torch.cat([FUNCS["atleast_2d"](t) for t in _same(tup, dtype)], 0)


@fn()
def hstack(tup, dtype=None):
    ts = [FUNCS["atleast_1d"](t) for t in _same(tup, dtype)]
    return torch.cat(ts, 0 if ts[0].ndim == 1 else 1)


@fn()
def dstack(tup, dtype=None):
    return torch.cat([FUNCS["atleast_3d"](t) for t in _same(tup, dtype)], 2)


@fn()
def column_stack(tup):
    ts = [t.reshape(-1, 1) if t.ndim < 2 else t for t in _same(tup)]
    return torch.cat(ts, 1)


@fn()
def block(arrays):
    def depth(x):
        return 1 + depth(x[0]) if isinstance(x, list) else 0

    def rec(x, d, total):
        if not isinstance(x, list):
            t = _t(x)
            return t.reshape((1,) * (total - t.ndim) + tuple(t.shape))
        parts = [rec(v, d + 1, total) for v in x]
        dt = functools.reduce(promote, [p.dtype for p in parts])
        return torch.cat([p.to(dt) for p in parts], dim=-(total - d))

    dd = depth(arrays)
    nd = max([_t(v).ndim for v in _leaves(arrays)] + [dd])
    return rec(arrays, 0, nd)


def _split_points(n, ios, even):
    if isinstance(ios, int) or (isinstance(ios, torch.Tensor)
                                and ios.ndim == 0):
        k = int(ios)
        if even and n % k:
            raise ValueError("array split does not result in an equal "
                             "division")
        q, r = n // k, n % k
        sizes = [q + 1] * r + [q] * (k - r)
        return list(np.cumsum([0] + sizes))
    pts = [int(i) for i in (ios.tolist() if isinstance(ios, torch.Tensor)
                            else ios)]
    return [0] + pts + [n]


def _split(ary, ios, axis, even):
    t = _t(ary)
    axis %= t.ndim
    n = t.shape[axis]
    pts = _split_points(n, ios, even)
    out = []
    for lo, hi in zip(pts[:-1], pts[1:]):
        lo, hi = min(max(lo, 0), n), min(max(hi, 0), n)
        out.append(t.narrow(axis, lo, max(hi - lo, 0)).clone())
    return out


@fn()
def split(ary, indices_or_sections, axis=0):
    return _split(ary, indices_or_sections, axis, True)


@fn()
def array_split(ary, indices_or_sections, axis=0):
    return _split(ary, indices_or_sections, axis, False)


@fn()
def hsplit(ary, indices_or_sections):
    t = _t(ary)
    return _split(t, indices_or_sections, 0 if t.ndim == 1 else 1, True)


@fn()
def vsplit(ary, indices_or_sections):
    return _split(ary, indices_or_sections, 0, True)


@fn()
def dsplit(ary, indices_or_sections):
    return _split(ary, indices_or_sections, 2, True)


@fn()
def unstack(x, /, *, axis=0):
    return tuple(v.clone() for v in torch.unbind(_t(x), dim=axis))


@fn()
def tile(A, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(_t(A), reps)


@fn()
def repeat(a, repeats, axis=None, *, total_repeat_length=None):
    t = _t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    r = repeats if isinstance(repeats, int) else _t(repeats)
    return torch.repeat_interleave(t, r, dim=axis)


@fn()
def flip(m, axis=None):
    t = _t(m)
    return torch.flip(t, _axes(axis, t.ndim))


@fn()
def fliplr(m):
    return torch.flip(_t(m), (1,))


@fn()
def flipud(m):
    return torch.flip(_t(m), (0,))


@fn()
def roll(a, shift, axis=None):
    t = _t(a)
    if axis is None:
        return torch.roll(t.reshape(-1), shift).reshape(t.shape)
    return torch.roll(t, shift, axis)


@fn()
def rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(_t(m), k, list(axes))


@fn()
def resize(a, new_shape):
    t = _t(a).reshape(-1)
    shp = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    n = math.prod(shp)
    if t.numel() == 0:
        return torch.zeros(shp, dtype=t.dtype, device=t.device)
    reps = -(-n // t.numel())
    return t.repeat(reps)[:n].reshape(shp)


@fn()
def append(arr, values, axis=None):
    (a, v), _ = _args(arr, values)
    if axis is None:
        return torch.cat([a.reshape(-1), v.reshape(-1)])
    return torch.cat([a, v], axis)


@fn()
def insert(arr, obj, values, axis=None):
    t = _t(arr)
    if axis is None:
        t, axis = t.reshape(-1), 0
    axis %= t.ndim
    n = t.shape[axis]
    v = _as(values, t.dtype)
    if isinstance(obj, slice):
        obj = list(range(*obj.indices(n)))
    idx = _t(obj).reshape(-1).tolist()
    if len(idx) == 1 and not isinstance(obj, (list, tuple, np.ndarray,
                                              torch.Tensor)):
        i = idx[0] % (n + 1) if idx[0] < 0 else idx[0]
        shp = list(t.shape)
        vt = v if v.ndim == t.ndim else torch.moveaxis(
            v.reshape(v.shape + (1,) * (t.ndim - v.ndim)) if v.ndim else v,
            0, axis) if v.ndim else v
        shp[axis] = vt.shape[axis] if vt.ndim == t.ndim else 1
        vt = torch.broadcast_to(vt, shp)
        return torch.cat([t.narrow(axis, 0, i), vt,
                          t.narrow(axis, i, n - i)], axis)
    idx = [i + n if i < 0 else i for i in idx]
    order = np.argsort(idx, kind="stable")
    shp = list(t.shape)
    shp[axis] = len(idx)
    vals = torch.broadcast_to(v.reshape(
        v.shape if v.ndim == t.ndim else
        [len(idx) if d == axis else 1 for d in range(t.ndim)]
        if v.ndim else ()), shp)
    pieces, prev = [], 0
    for k in order:
        i = idx[k]
        pieces.append(t.narrow(axis, prev, i - prev))
        pieces.append(vals.narrow(axis, int(k), 1))
        prev = i
    pieces.append(t.narrow(axis, prev, n - prev))
    return torch.cat(pieces, axis)


@fn()
def delete(arr, obj, axis=None, *, assume_unique_indices=False):
    t = _t(arr)
    if axis is None:
        t, axis = t.reshape(-1), 0
    n = t.shape[axis]
    keep = torch.ones(n, dtype=torch.bool, device=t.device)
    if isinstance(obj, slice):
        keep[obj] = False
    else:
        idx = _t(obj).reshape(-1).long()
        keep[torch.where(idx < 0, idx + n, idx)] = False
    return torch.index_select(t, axis, torch.nonzero(keep)[:, 0])


def _pad_index(n, before, after, mode):
    i = np.arange(-before, n + after)
    if mode == "edge":
        return np.clip(i, 0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return np.zeros_like(i)
        p = 2 * (n - 1)
        j = i % p
        return np.where(j >= n, p - j, j)
    if mode == "symmetric":
        p = 2 * n
        j = i % p
        return np.where(j >= n, p - 1 - j, j)
    raise NotImplementedError(f"pad(mode={mode!r}) is not ported")


@fn()
def pad(array, pad_width, mode="constant", **kwargs):
    t = _t(array)
    pw = np.broadcast_to(np.asarray(pad_width, dtype=np.int64).reshape(
        -1, 2) if np.ndim(pad_width) else np.asarray(
        [[pad_width, pad_width]]), (t.ndim, 2))
    if mode == "constant":
        cv = np.broadcast_to(np.asarray(kwargs.get("constant_values", 0),
                                        dtype=np.float64).reshape(-1, 2)
                             if np.ndim(kwargs.get("constant_values", 0))
                             else np.asarray(
                                 [[kwargs.get("constant_values", 0)] * 2]),
                             (t.ndim, 2))
        for ax in range(t.ndim):
            b, a = int(pw[ax][0]), int(pw[ax][1])
            shp = list(t.shape)
            parts = []
            if b:
                shp[ax] = b
                parts.append(torch.full(shp, cv[ax][0], dtype=t.dtype,
                                        device=t.device))
            parts.append(t)
            if a:
                shp[ax] = a
                parts.append(torch.full(shp, cv[ax][1], dtype=t.dtype,
                                        device=t.device))
            t = torch.cat(parts, ax)
        return t
    if mode == "empty":
        return pad(t, pad_width)
    for ax in range(t.ndim):
        idx = _pad_index(t.shape[ax], int(pw[ax][0]), int(pw[ax][1]), mode)
        t = torch.index_select(t, ax, torch.as_tensor(idx, device=t.device))
    return t


@fn()
def trim_zeros(filt, trim="fb", axis=None):
    t = _t(filt)
    nz = torch.nonzero(t != 0)[:, 0].tolist()
    if not nz:
        return t[:0].clone()
    lo = nz[0] if "f" in trim.lower() else 0
    hi = nz[-1] + 1 if "b" in trim.lower() else t.shape[0]
    return t[lo:hi].clone()


@fn()
def diag(v, k=0):
    t = _t(v)
    return torch.diag(t, k) if t.ndim in (1, 2) else torch.diagonal(t, k)


@fn()
def diagflat(v, k=0):
    return torch.diag(_t(v).reshape(-1), k)


@fn()
def diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_t(a), offset, axis1, axis2).clone()


@fn()
def trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    return sum_(torch.diagonal(_t(a), offset, axis1, axis2), -1,
                dtype=dtype)


@fn()
def tril(m, k=0):
    return torch.tril(_t(m), k)


@fn()
def triu(m, k=0):
    return torch.triu(_t(m), k)


@fn()
def astype(x, dtype, /, *, copy=False, device=None):
    return _t(x).to(dtype_torch(dtype), copy=True)


@fn()
def copy(a, order=None):
    return _t(a).clone()


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _fdt(dtype, *vals):
    """An explicit dtype, else the dtype NumPy gives ``vals``: an int
    type when all are ints, else float32 (the port's default float)."""
    if dtype is not None:
        return dtype_torch(dtype)
    dts = [_t(v).dtype for v in vals if v is not None]
    dt = functools.reduce(promote, dts) if dts else torch.float32
    return dt if (_is_float(dt) or dt.is_complex) else torch.float32


@fn()
def arange(start, stop=None, step=None, dtype=None, *, device=None):
    if stop is None:
        start, stop = 0, start
    step = 1 if step is None else step
    vals = [_t(v).item() if isinstance(v, torch.Tensor) else v
            for v in (start, stop, step)]
    if dtype is None:
        dt = torch.int64 if all(isinstance(v, (int, np.integer))
                                for v in vals) else result_dtype(*vals)
    else:
        dt = dtype_torch(dtype)
    n = max(int(math.ceil((vals[1] - vals[0]) / vals[2])), 0)
    out = torch.arange(n, dtype=torch.float64 if not _is_int(dt)
                       else torch.int64, device=_dev())
    return (out * vals[2] + vals[0]).to(dt)


@fn()
def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, *, device=None):
    dt = _fdt(dtype, start, stop)
    s, e = _f64(start), _f64(stop)
    div = (num - 1) if endpoint else num
    step = (e - s) / div if div > 0 else torch.full_like(e - s, math.nan)
    shp = torch.broadcast_shapes(s.shape, e.shape)
    i = torch.arange(num, dtype=torch.float64, device=s.device).reshape(
        (-1,) + (1,) * len(shp))
    y = s + i * step if div > 0 else s + i * (e - s)
    if endpoint and num > 1:
        y[-1] = e
    y = torch.broadcast_to(y, (num,) + tuple(shp))
    y = torch.movedim(y, 0, axis % (len(shp) + 1))
    if not _is_float(dt) and not dt.is_complex:
        y = torch.floor(y)
    y = y.to(dt)
    return (y, step.to(dt)) if retstep else y


@fn()
def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0):
    dt = _fdt(dtype, start, stop)
    y = linspace(start, stop, num, endpoint, dtype=torch.float64, axis=axis)
    return torch.pow(_f64(base), y).to(dt)


@fn()
def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0):
    dt = _fdt(dtype, start, stop)
    s, e = _f64(start), _f64(stop)
    sign = torch.sign(s)
    y = sign * torch.pow(10.0, linspace(torch.log10(s * sign),
                                        torch.log10(e * sign), num,
                                        endpoint, dtype=torch.float64))
    y[0] = s
    if endpoint and num > 1:
        y[-1] = e
    return torch.movedim(y, 0, axis).to(dt)


@fn()
def eye(N, M=None, k=0, dtype=None, *, device=None):
    M = N if M is None else M
    out = torch.zeros((N, M), dtype=_fdt(dtype), device=_dev())
    i = torch.arange(max(0, min(N, M - k) if k >= 0 else min(N + k, M)),
                     device=_dev())
    rows, cols = (i, i + k) if k >= 0 else (i - k, i)
    out[rows, cols] = 1
    return out


@fn()
def identity(n, dtype=None):
    return eye(n, dtype=dtype)


@fn()
def tri(N, M=None, k=0, dtype=None):
    M = N if M is None else M
    return torch.tril(torch.ones((N, M), device=_dev()), k).to(
        _fdt(dtype))


def _shape_of(shape):
    return (int(shape),) if isinstance(shape, (int, np.integer)) else \
        tuple(int(s) for s in shape)


@fn("zeros", "empty")
def zeros(shape, dtype=None, *, device=None):
    return torch.zeros(_shape_of(shape), dtype=_fdt(dtype), device=_dev())


@fn()
def ones(shape, dtype=None, *, device=None):
    return torch.ones(_shape_of(shape), dtype=_fdt(dtype), device=_dev())


@fn()
def full(shape, fill_value, dtype=None, *, device=None):
    f = _t(fill_value) if dtype is None else _as(fill_value, dtype)
    return torch.broadcast_to(f, _shape_of(shape)).clone()


def _like(fill):
    def f(a, dtype=None, shape=None, *, device=None, **kw):
        t = _t(a)
        shp = t.shape if shape is None else _shape_of(shape)
        dt = t.dtype if dtype is None else dtype_torch(dtype)
        return torch.full(shp, fill, dtype=dt, device=t.device)
    return f


FUNCS["zeros_like"] = FUNCS["empty_like"] = _like(0)
FUNCS["ones_like"] = _like(1)


@fn()
def full_like(a, fill_value, dtype=None, shape=None, *, device=None):
    t = _t(a)
    shp = t.shape if shape is None else _shape_of(shape)
    dt = t.dtype if dtype is None else dtype_torch(dtype)
    return torch.broadcast_to(_as(fill_value, dt), shp).clone()


@fn("array", "asarray")
def array_(object, dtype=None, copy=True, order="K", ndmin=0, *,
           device=None):
    t = _t(object)
    if dtype is not None:
        t = t.to(dtype_torch(dtype))
    t = t.clone()
    while t.ndim < ndmin:
        t = t.unsqueeze(0)
    return t


@fn()
def indices(dimensions, dtype=None, sparse=False):
    dims = tuple(dimensions)
    dt = torch.int64 if dtype is None else dtype_torch(dtype)
    grids = torch.meshgrid(*[torch.arange(d, device=_dev()) for d in dims],
                           indexing="ij")
    if sparse:
        return tuple(torch.arange(d, device=_dev()).to(dt).reshape(
            [d if j == i else 1 for j in range(len(dims))])
            for i, d in enumerate(dims))
    return torch.stack(grids).to(dt) if dims else \
        torch.zeros((0,), dtype=dt, device=_dev())


@fn()
def meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    ts = [_t(x).reshape(-1) for x in xi]
    if sparse:
        n = len(ts)
        out = []
        for i, t in enumerate(ts):
            shp = [1] * n
            j = i
            if indexing == "xy" and n >= 2 and i < 2:
                j = 1 - i
            shp[j] = -1
            out.append(t.reshape(shp))
        return out
    return [g.clone() for g in torch.meshgrid(*ts, indexing=indexing)]


@fn()
def ix_(*args):
    n = len(args)
    out = []
    for i, a in enumerate(args):
        t = _t(a)
        if t.dtype == torch.bool:
            t = torch.nonzero(t)[:, 0]
        out.append(t.reshape([-1 if j == i else 1 for j in range(n)]))
    return tuple(out)


@fn()
def diag_indices(n, ndim=2):
    i = torch.arange(n, device=_dev())
    return tuple(i.clone() for _ in range(ndim))


@fn()
def diag_indices_from(arr):
    t = _t(arr)
    return diag_indices(t.shape[0], t.ndim)


@fn()
def tril_indices(n, k=0, m=None):
    ij = torch.tril_indices(n, n if m is None else m, k, device=_dev())
    return ij[0].clone(), ij[1].clone()


@fn()
def triu_indices(n, k=0, m=None):
    ij = torch.triu_indices(n, n if m is None else m, k, device=_dev())
    return ij[0].clone(), ij[1].clone()


@fn()
def tril_indices_from(arr, k=0):
    t = _t(arr)
    return tril_indices(t.shape[-2], k, t.shape[-1])


@fn()
def triu_indices_from(arr, k=0):
    t = _t(arr)
    return triu_indices(t.shape[-2], k, t.shape[-1])


@fn()
def mask_indices(n, mask_func, k=0, *, size=None):
    from . import ndarray
    from ..ndarray.ndarray import NDArray
    m = mask_func(ndarray(torch.ones((n, n), dtype=torch.int64,
                                     device=_dev())), k)
    m = m._data if isinstance(m, NDArray) else _t(m)
    return nonzero(m)


def _window(name, f):
    def w(M, *args):
        if M < 1:
            return torch.zeros(0, dtype=torch.float32, device=_dev())
        if M == 1:
            return torch.ones(1, dtype=torch.float32, device=_dev())
        n = torch.arange(M, dtype=torch.float64, device=_dev())
        return f(n, M, *args).to(torch.float32)
    w.__name__ = name
    FUNCS[name] = w


_window("bartlett", lambda n, M: 1 - torch.abs(2 * n / (M - 1) - 1))
_window("blackman", lambda n, M: 0.42 - 0.5 * torch.cos(
    2 * math.pi * n / (M - 1)) + 0.08 * torch.cos(4 * math.pi * n / (M - 1)))
_window("hamming", lambda n, M: 0.54 - 0.46 * torch.cos(
    2 * math.pi * n / (M - 1)))
_window("hanning", lambda n, M: 0.5 - 0.5 * torch.cos(
    2 * math.pi * n / (M - 1)))
_window("kaiser", lambda n, M, beta: torch.special.i0(
    beta * torch.sqrt(torch.clamp_min(
        1 - ((n - (M - 1) / 2) / ((M - 1) / 2)) ** 2, 0)))
    / torch.special.i0(torch.tensor(float(beta), dtype=torch.float64)))


@fn()
def fromfunction(function, shape, *, dtype=float, **kwargs):
    from . import ndarray
    from ..ndarray.ndarray import NDArray
    dt = torch.float32 if dtype is float else dtype_torch(dtype)
    grids = indices(shape, dt)
    out = function(*[ndarray(g) for g in grids], **kwargs)
    return out._data if isinstance(out, NDArray) else _t(out)


@fn()
def frombuffer(buffer, dtype=float, count=-1, offset=0):
    dt = np.float64 if dtype is float else dtype
    return torch.tensor(np.frombuffer(buffer, dt, count, offset).copy(),
                        device=_dev())


@fn()
def fromstring(string, dtype=float, count=-1, *, sep):
    dt = np.float64 if dtype is float else dtype
    return torch.tensor(np.fromstring(string, dt, count, sep=sep),
                        device=_dev())


@fn(host=True)
def fromfile(*args, **kwargs):
    raise NotImplementedError(
        "mx.np.fromfile is not implemented, as jnp.fromfile is not (it is "
        "not pure); read the file with numpy and pass it to mx.np.array")


@fn(host=True)
def fromiter(*args, **kwargs):
    raise NotImplementedError(
        "mx.np.fromiter is not implemented, as jnp.fromiter is not (it is "
        "not pure); build a numpy array and pass it to mx.np.array")


@fn()
def from_dlpack(x, /, *, device=None, copy=None):
    return torch.from_dlpack(x).clone()


@fn(host=True)
def load(file, *args, **kwargs):
    from . import ndarray
    out = np.load(file, *args, **kwargs)
    if isinstance(out, np.ndarray) and out.dtype.kind in "biufc":
        return ndarray(torch.tensor(out, device=_dev()))
    return out


@fn(host=True)
def save(file, arr, allow_pickle=True):
    np.save(file, _host(_t(arr)), allow_pickle=allow_pickle)


@fn(host=True)
def savez(file, *args, **kwds):
    np.savez(file, *[_host(_t(a)) for a in args],
             **{k: _host(_t(v)) for k, v in kwds.items()})


# ---------------------------------------------------------------------------
# indexing, searching, sorting, sets
# ---------------------------------------------------------------------------
@fn()
def take(a, indices, axis=None, out=None, mode=None, unique_indices=False,
         indices_are_sorted=False, fill_value=None):
    t = _t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    axis %= t.ndim
    idx = _t(indices).long()
    n = t.shape[axis]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    out_ = torch.index_select(t, axis, idx.reshape(-1))
    return out_.reshape(t.shape[:axis] + idx.shape + t.shape[axis + 1:])


@fn()
def take_along_axis(arr, indices, axis, mode=None, fill_value=None):
    t = _t(arr)
    idx = _t(indices).long()
    if axis is None:
        t, idx, axis = t.reshape(-1), idx.reshape(-1), 0
    n = t.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    shp = list(torch.broadcast_shapes(
        tuple(s if i != axis % t.ndim else 1 for i, s in enumerate(t.shape)),
        tuple(s if i != axis % t.ndim else 1
              for i, s in enumerate(idx.shape))))
    tshape, ishape = list(shp), list(shp)
    tshape[axis] = t.shape[axis]
    ishape[axis] = idx.shape[axis]
    return torch.gather(torch.broadcast_to(t, tshape), axis,
                        torch.broadcast_to(idx.clamp(0, n - 1), ishape))


def _no_inplace(name, inplace):
    if inplace:
        raise ValueError(f"mx.np.{name} cannot modify arrays in-place, as "
                         f"jax.numpy.{name} cannot; pass inplace=False and "
                         "use the result")


@fn()
def put(a, ind, v, mode=None, *, inplace=True):
    _no_inplace("put", inplace)
    t = _t(a).clone()
    flat = t.reshape(-1)
    idx = _t(ind).reshape(-1).long()
    n = flat.numel()
    idx = torch.remainder(idx, n) if mode == "wrap" else \
        torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    vals = _as(v, t.dtype).reshape(-1)
    vals = vals.repeat(-(-idx.numel() // max(vals.numel(), 1)))[
        :idx.numel()]
    flat[idx] = vals
    return t


@fn()
def put_along_axis(arr, indices, values, axis, inplace=True, mode=None):
    _no_inplace("put_along_axis", inplace)
    t = _t(arr).clone()
    idx = _t(indices).long()
    n = t.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    vals = torch.broadcast_to(_as(values, t.dtype), idx.shape)
    return t.scatter(axis, idx, vals)


@fn()
def place(arr, mask, vals, *, inplace=True):
    _no_inplace("place", inplace)
    t = _t(arr).clone()
    m = _t(mask).bool()
    k = int(m.sum())
    v = _as(vals, t.dtype).reshape(-1)
    if k:
        t[m] = v.repeat(-(-k // v.numel()))[:k]
    return t


@fn()
def fill_diagonal(a, val, wrap=False, *, inplace=True):
    _no_inplace("fill_diagonal", inplace)
    t = _t(a).clone()
    n = min(t.shape)
    i = torch.arange(n, device=t.device)
    v = _as(val, t.dtype).reshape(-1)
    t[(i,) * t.ndim] = v.repeat(-(-n // v.numel()))[:n]
    return t


@fn()
def choose(a, choices, out=None, mode="raise"):
    idx = _t(a).long()
    cs = torch.stack(_same(choices))
    shp = torch.broadcast_shapes(idx.shape, cs.shape[1:])
    cs = torch.broadcast_to(cs, (cs.shape[0],) + tuple(shp))
    idx = torch.broadcast_to(idx, shp)
    n = cs.shape[0]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    return torch.gather(cs, 0, idx.unsqueeze(0))[0]


@fn(untaped=True)
def compress(condition, a, axis=None, *, size=None, fill_value=0):
    c = _t(condition).reshape(-1).bool()
    t = _t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    idx = torch.nonzero(c[:t.shape[axis]])[:, 0]
    return torch.index_select(t, axis, idx)


@fn(untaped=True)
def extract(condition, arr, *, size=None, fill_value=0):
    return _t(arr).reshape(-1)[_t(condition).reshape(-1).bool()]


@fn()
def select(condlist, choicelist, default=0):
    chs = _same(list(choicelist) + [default])
    out = chs[-1]
    for c, ch in zip(reversed(condlist), reversed(chs[:-1])):
        out = torch.where(_t(c).bool(), ch, out)
    return torch.broadcast_to(out, torch.broadcast_shapes(
        *[_t(c).shape for c in condlist], *[c.shape for c in chs])).clone()


@fn(untaped=True)
def nonzero(a, *, size=None, fill_value=None):
    t = _t(a)
    if t.ndim == 0:
        t = t.reshape(1)
    return tuple(i.clone() for i in torch.nonzero(t, as_tuple=True))


@fn(untaped=True)
def argwhere(a, *, size=None, fill_value=None):
    t = _t(a)
    if t.ndim == 0:
        return torch.nonzero(t.reshape(1))[:, :0]
    return torch.nonzero(t)


@fn(untaped=True)
def flatnonzero(a, *, size=None, fill_value=0):
    return torch.nonzero(_t(a).reshape(-1))[:, 0]


@fn()
def searchsorted(a, v, side="left", sorter=None, *, method="scan"):
    s = _t(a)
    if sorter is not None:
        s = s[_t(sorter).long()]
    (s, x), _ = _args(s, v)
    return torch.searchsorted(s, x.contiguous(), right=side == "right",
                              out_int32=True)


@fn()
def digitize(x, bins, right=False, *, method=None):
    (xt, b), _ = _args(x, bins)
    if b.numel() > 1 and bool(b[-1] < b[0]):
        return (b.numel() - torch.searchsorted(
            b.flip(0), xt.contiguous(), right=not right)).to(torch.int32)
    return torch.searchsorted(b, xt.contiguous(), right=not right,
                              out_int32=True)


@fn()
def sort(a, axis=-1, *, kind=None, order=None, stable=True,
         descending=False):
    t = _t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    if t.dtype == torch.bool:
        return torch.sort(t.to(torch.uint8), dim=axis, stable=True,
                          descending=descending)[0].bool()
    return torch.sort(t, dim=axis, stable=True, descending=descending)[0]


@fn()
def argsort(a, axis=-1, *, kind=None, order=None, stable=True,
            descending=False):
    t = _t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return torch.sort(t, dim=axis, stable=True, descending=descending)[1]


def _partition(a, kth, axis, want_idx):
    t = _t(a)
    x = torch.movedim(t, axis, -1)
    n = x.shape[-1]
    kth = kth % n
    asc_v, asc_i = torch.sort(x, dim=-1, stable=True)
    desc_v, desc_i = torch.sort(x, dim=-1, stable=True, descending=True)
    v = torch.cat([asc_v[..., :kth + 1], desc_v[..., :n - kth - 1]], -1)
    i = torch.cat([asc_i[..., :kth + 1], desc_i[..., :n - kth - 1]], -1)
    return torch.movedim(i if want_idx else v, -1, axis)


@fn()
def partition(a, kth, axis=-1):
    return _partition(a, kth, axis, False)


@fn()
def argpartition(a, kth, axis=-1):
    return _partition(a, kth, axis, True).to(torch.int32)


@fn()
def lexsort(keys, axis=-1):
    ks = [_t(k) for k in keys] if not isinstance(keys, torch.Tensor) \
        else list(_t(keys))
    idx = torch.arange(ks[0].shape[axis], device=ks[0].device)
    shp = ks[0].shape
    idx = torch.broadcast_to(idx.reshape([-1 if d == axis % len(shp) else 1
                                          for d in range(len(shp))]), shp)
    for k in ks:
        kk = torch.gather(k, axis, idx)
        order = torch.sort(kk, dim=axis, stable=True)[1]
        idx = torch.gather(idx, axis, order)
    return idx


@fn()
def sort_complex(a):
    t = _t(a)
    if not t.is_complex():
        t = t.to(torch.complex128 if t.dtype == torch.float64
                 else torch.complex64)
    order = lexsort([t.imag, t.real])
    return torch.gather(t, -1, order)


@fn()
def unravel_index(indices, shape):
    idx = _t(indices).long()
    out = []
    for s in reversed(_shape_of(shape)):
        out.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return tuple(reversed(out))


@fn()
def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    flat = None
    for i, d in zip(multi_index, dims):
        i = _t(i).long()
        if mode == "wrap":
            i = torch.remainder(i, d)
        elif mode == "clip":
            i = i.clamp(0, d - 1)
        flat = i if flat is None else flat * d + i
    return flat


def _unique(t, axis=None):
    if axis is None:
        t = t.reshape(-1)
        vals, inv, cnt = torch.unique(t, sorted=True, return_inverse=True,
                                      return_counts=True)
    else:
        vals, inv, cnt = torch.unique(t, sorted=True, return_inverse=True,
                                      return_counts=True, dim=axis)
    n = inv.numel()
    first = torch.full((cnt.numel(),), n, dtype=torch.int64,
                       device=t.device).scatter_reduce(
        0, inv.reshape(-1), torch.arange(n, device=t.device), "amin")
    return vals, first, inv, cnt


@fn(untaped=True)
def unique(ar, return_index=False, return_inverse=False,
           return_counts=False, axis=None, *, equal_nan=True, size=None,
           fill_value=None, sorted=True):
    t = _t(ar)
    vals, first, inv, cnt = _unique(t, axis)
    if t.is_floating_point() and equal_nan and axis is None:
        nan = torch.isnan(vals)
        if int(nan.sum()) > 1:
            keep = ~nan
            keep[torch.nonzero(nan)[0, 0]] = True
            vals = vals[keep]
            cnt = torch.cat([cnt[~nan], cnt[nan].sum().reshape(1)])
            first = torch.cat([first[~nan], first[nan].min().reshape(1)])
    out = [vals]
    if return_index:
        out.append(first)
    if return_inverse:
        out.append(inv.reshape(t.shape) if axis is None and t.ndim > 1
                   else inv)
    if return_counts:
        out.append(cnt)
    return out[0] if len(out) == 1 else tuple(out)


@fn(untaped=True)
def unique_all(x, /, *, size=None, fill_value=None):
    t = _t(x)
    vals, first, inv, cnt = _unique(t)
    return vals, first, inv.reshape(t.shape), cnt


@fn(untaped=True)
def unique_counts(x, /, *, size=None, fill_value=None):
    vals, _, _, cnt = _unique(_t(x))
    return vals, cnt


@fn(untaped=True)
def unique_inverse(x, /, *, size=None, fill_value=None):
    t = _t(x)
    vals, _, inv, _ = _unique(t)
    return vals, inv.reshape(t.shape)


@fn(untaped=True)
def unique_values(x, /, *, size=None, fill_value=None):
    return _unique(_t(x))[0]


@fn(untaped=True)
def intersect1d(ar1, ar2, assume_unique=False, return_indices=False, *,
                size=None, fill_value=None):
    (a, b), _ = _args(ar1, ar2)
    ua, ia, _, _ = _unique(a)
    ub, ib, _, _ = _unique(b)
    m = torch.isin(ua, ub)
    vals = ua[m]
    if not return_indices:
        return vals
    pos = torch.searchsorted(ub, vals)
    return vals, ia[m], ib[pos]


@fn(untaped=True)
def union1d(ar1, ar2, *, size=None, fill_value=None):
    (a, b), _ = _args(ar1, ar2)
    return _unique(torch.cat([a.reshape(-1), b.reshape(-1)]))[0]


@fn(untaped=True)
def setdiff1d(ar1, ar2, assume_unique=False, *, size=None,
              fill_value=None):
    (a, b), _ = _args(ar1, ar2)
    ua = _unique(a)[0]
    return ua[~torch.isin(ua, b.reshape(-1))]


@fn(untaped=True)
def setxor1d(ar1, ar2, assume_unique=False, *, size=None,
             fill_value=None):
    (a, b), _ = _args(ar1, ar2)
    ua, ub = _unique(a)[0], _unique(b)[0]
    both = torch.cat([ua, ub])
    vals, _, _, cnt = _unique(both)
    return vals[cnt == 1]


@fn()
def isin(element, test_elements, assume_unique=False, invert=False, *,
         method="auto"):
    (e, s), _ = _args(element, test_elements)
    return torch.isin(e, s.reshape(-1), invert=invert)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------
def _mm_args(a, b):
    (x, y), dt = _args(a, b)
    if dt == torch.bool:
        return x.to(torch.uint8), y.to(torch.uint8), dt
    return x, y, dt


def _mm_back(out, dt):
    return out.bool() if dt == torch.bool else out


@fn("matmul", "linalg_matmul")
def matmul(a, b, /):
    x, y, dt = _mm_args(a, b)
    return _mm_back(torch.matmul(x, y), dt)


@fn()
def dot(a, b):
    x, y, dt = _mm_args(a, b)
    if x.ndim == 0 or y.ndim == 0:
        return _mm_back(x * y, dt)
    if y.ndim == 1 or x.ndim <= 2 and y.ndim <= 2:
        return _mm_back(torch.matmul(x, y), dt)
    return _mm_back(torch.tensordot(x, y, dims=([-1], [y.ndim - 2])), dt)


@fn()
def vdot(a, b):
    x, y, dt = _mm_args(a, b)
    x = x.reshape(-1)
    if x.is_complex():
        x = x.conj()
    return _mm_back(torch.sum(x * y.reshape(-1)), dt)


@fn()
def inner(a, b):
    x, y, dt = _mm_args(a, b)
    if x.ndim == 0 or y.ndim == 0:
        return _mm_back(x * y, dt)
    return _mm_back(torch.inner(x, y), dt)


@fn("outer", "linalg_outer")
def outer(a, b):
    x, y, dt = _mm_args(a, b)
    return _mm_back(torch.outer(x.reshape(-1), y.reshape(-1)), dt)


@fn("tensordot", "linalg_tensordot")
def tensordot(a, b, axes=2):
    x, y, dt = _mm_args(a, b)
    if not isinstance(axes, int):
        axes = tuple(list(ax) if isinstance(ax, (list, tuple)) else [ax]
                     for ax in axes)
    return _mm_back(torch.tensordot(x, y, dims=axes), dt)


@fn()
def einsum(subscripts, *operands, out=None, optimize="auto", precision=None,
           preferred_element_type=None, _dot_general=None):
    ts = _same(operands)
    return torch.einsum(subscripts, *ts)


@fn(host=True)
def einsum_path(subscripts, *operands, optimize="greedy"):
    host = [np.zeros(_t(o).shape) for o in operands]
    return np.einsum_path(subscripts, *host, optimize=optimize)


@fn()
def kron(a, b):
    x, y, dt = _mm_args(a, b)
    return _mm_back(torch.kron(x, y), dt)


@fn("cross")
def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    (x, y), _ = _args(a, b)
    if axis is not None:
        axisa = axisb = axisc = axis
    x = torch.movedim(x, axisa, -1)
    y = torch.movedim(y, axisb, -1)
    if x.shape[-1] == 2 and y.shape[-1] == 2:
        return x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]
    if x.shape[-1] == 2:
        x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
    if y.shape[-1] == 2:
        y = torch.cat([y, torch.zeros_like(y[..., :1])], -1)
    x, y = torch.broadcast_tensors(x, y)
    return torch.movedim(torch.linalg.cross(x, y, dim=-1), -1, axisc)


@fn("linalg_cross")
def linalg_cross(x1, x2, /, *, axis=-1):
    (x, y), _ = _args(x1, x2)
    x, y = torch.broadcast_tensors(x, y)
    return torch.linalg.cross(x, y, dim=axis)


@fn("vecdot", "linalg_vecdot")
def vecdot(x1, x2, /, *, axis=-1, precision=None,
           preferred_element_type=None):
    (x, y), _ = _args(x1, x2)
    if x.is_complex():
        x = x.conj()
    return torch.sum(x * y, dim=axis)


@fn()
def matvec(x1, x2, /):
    (x, y), _ = _args(x1, x2)
    return torch.matmul(x, y.unsqueeze(-1))[..., 0]


@fn()
def vecmat(x1, x2, /):
    (x, y), _ = _args(x1, x2)
    if x.is_complex():
        x = x.conj()
    return torch.matmul(x.unsqueeze(-2), y)[..., 0, :]


# ---------------------------------------------------------------------------
# statistics and signals
# ---------------------------------------------------------------------------
@fn()
def bincount(x, weights=None, minlength=0, *, length=None):
    t = _t(x).long()
    n = length if length is not None else max(
        int(t.max()) + 1 if t.numel() else 0, minlength)
    w = None if weights is None else _t(weights)
    out = torch.zeros(n, dtype=torch.int64 if w is None else w.dtype,
                      device=t.device)
    keep = (t >= 0) & (t < n)
    src = torch.ones_like(t) if w is None else w
    return out.index_add(0, t[keep], src[keep])


def _edges(a, bins, range_, weights=None):
    if isinstance(bins, (int, np.integer)):
        t = _float(a)
        lo, hi = (float(t.min()), float(t.max())) if range_ is None \
            and t.numel() else (range_ if range_ is not None else (0., 1.))
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        return linspace(lo, hi, int(bins) + 1, dtype=t.dtype)
    return _float(bins)


@fn()
def histogram_bin_edges(a, bins=10, range=None, weights=None):
    return _edges(a, bins, range)


def _bin_index(x, edges):
    i = torch.searchsorted(edges, x.contiguous(), right=True) - 1
    n = edges.numel() - 1
    i = torch.where(x == edges[-1], torch.full_like(i, n - 1), i)
    ok = (x >= edges[0]) & (x <= edges[-1])
    return i, ok


@fn()
def histogram(a, bins=10, range=None, weights=None, density=None):
    t = _float(a).reshape(-1)
    e = _edges(t, bins, range).to(t.dtype)
    i, ok = _bin_index(t, e)
    w = torch.ones_like(t) if weights is None else \
        _t(weights).reshape(-1).to(t.dtype)
    n = e.numel() - 1
    h = torch.zeros(n, dtype=w.dtype, device=t.device).index_add(
        0, i[ok], w[ok])
    if density:
        h = h / (h.sum() * torch.diff(e))
    return h, e


@fn()
def histogramdd(sample, bins=10, range=None, weights=None, density=None):
    s = _float(sample)
    if s.ndim == 1:
        s = s.reshape(-1, 1)
    d = s.shape[1]
    bins_ = bins if isinstance(bins, (list, tuple)) else [bins] * d
    ranges = range if range is not None else [None] * d
    edges = [_edges(s[:, k], bins_[k], ranges[k]).to(s.dtype)
             for k in builtins_range(d)]
    flat = torch.zeros(s.shape[0], dtype=torch.int64, device=s.device)
    ok = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    shape_ = []
    for k in builtins_range(d):
        i, o = _bin_index(s[:, k], edges[k])
        nb = edges[k].numel() - 1
        flat = flat * nb + i.clamp(0, nb - 1)
        ok &= o
        shape_.append(nb)
    w = torch.ones(s.shape[0], dtype=torch.int64, device=s.device) \
        if weights is None else _as(weights, s.dtype)
    h = torch.zeros(math.prod(shape_), dtype=w.dtype,
                    device=s.device).index_add(0, flat[ok], w[ok])
    h = h.reshape(shape_)
    if density:
        h = h / h.sum().to(s.dtype)
        for k, e in enumerate(edges):
            shp = [1] * d
            shp[k] = -1
            h = h / torch.diff(e).reshape(shp)
    return h, edges


builtins_range = range


@fn()
def histogram2d(x, y, bins=10, range=None, weights=None, density=None):
    if isinstance(bins, (list, tuple)) and len(bins) != 2:
        bins = [bins, bins]
    h, e = histogramdd(torch.stack([_float(x), _float(y)], 1), bins, range,
                       weights, density)
    return h, e[0], e[1]


@fn()
def interp(x, xp, fp, left=None, right=None, period=None):
    xt, xpt = _float(x), _float(xp)
    fpt = _t(fp)
    dt = promote(promote(xt.dtype, xpt.dtype), fpt.dtype)
    xt, xpt, fpt = xt.to(dt), xpt.to(dt), fpt.to(dt)
    if period is not None:
        xt = torch.remainder(xt, period)
        xpt = torch.remainder(xpt, period)
        order = torch.argsort(xpt)
        xpt, fpt = xpt[order], fpt[order]
        xpt = torch.cat([xpt[-1:] - period, xpt, xpt[:1] + period])
        fpt = torch.cat([fpt[-1:], fpt, fpt[:1]])
    i = torch.clamp(torch.searchsorted(xpt, xt.contiguous(), right=True), 1,
                    xpt.numel() - 1)
    x0, x1, f0, f1 = xpt[i - 1], xpt[i], fpt[i - 1], fpt[i]
    df = f1 - f0
    dx = x1 - x0
    out = f0 + (xt - x0) * (df / dx)
    out = torch.where(dx == 0, f0, out)
    lv = fpt[0] if left is None else left
    rv = fpt[-1] if right is None else right
    out = torch.where(xt < xpt[0], torch.as_tensor(lv, dtype=dt,
                                                   device=xt.device), out)
    out = torch.where(xt > xpt[-1], torch.as_tensor(rv, dtype=dt,
                                                    device=xt.device), out)
    return torch.where(xt == xpt[-1], fpt[-1], out) if period is None \
        else out


def _conv_full(a, v):
    n, m = a.numel(), v.numel()
    out = torch.zeros(n + m - 1, dtype=a.dtype, device=a.device)
    for j in builtins_range(m):
        out[j:j + n] += a * v[j]
    return out


def _conv_mode(full, n, m, mode):
    if mode == "full":
        return full
    if mode == "same":
        L = max(n, m)
        start = (min(n, m) - 1) // 2
        return full[start:start + L]
    if mode == "valid":
        return full[min(n, m) - 1:max(n, m)]
    raise ValueError(f"mode {mode!r} is not 'full', 'same' or 'valid'")


@fn()
def convolve(a, v, mode="full", *, precision=None,
             preferred_element_type=None):
    (x, y), _ = _args(a, v)
    x, y = x.reshape(-1), y.reshape(-1)
    if x.numel() < y.numel():
        x, y = y, x
    return _conv_mode(_conv_full(x, y), x.numel(), y.numel(), mode)


@fn()
def correlate(a, v, mode="valid", *, precision=None,
              preferred_element_type=None):
    (x, y), _ = _args(a, v)
    y = y.reshape(-1)
    if y.is_complex():
        y = y.conj()
    n, m = x.numel(), y.numel()
    full = _conv_full(x.reshape(-1), y.flip(0)) if n >= m else \
        _conv_full(y.flip(0), x.reshape(-1))
    return _conv_mode(full, n, m, mode)


@fn()
def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
        aweights=None):
    t = _float(m)
    if t.ndim == 1:
        t = t.reshape(1, -1)
    if not rowvar and t.shape[0] != 1:
        t = t.T
    if y is not None:
        yt = _float(y)
        yt = yt.reshape(1, -1) if yt.ndim == 1 else (yt if rowvar else yt.T)
        dt = promote(t.dtype, yt.dtype)
        t = torch.cat([t.to(dt), yt.to(dt)], 0)
    corr = ddof if ddof is not None else (0 if bias else 1)
    out = torch.cov(t, correction=corr,
                    fweights=None if fweights is None else _t(fweights),
                    aweights=None if aweights is None else _t(aweights))
    return out


@fn()
def corrcoef(x, y=None, rowvar=True):
    c = cov(x, y, rowvar)
    if c.ndim == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c).real)
    c = c / d[:, None] / d[None, :]
    return torch.clamp(c, -1, 1) if not c.is_complex() else c


@fn()
def gradient(f, *varargs, axis=None, edge_order=1):
    t = _float(f)
    axes = _axes(axis, t.ndim)
    sp = list(varargs) if varargs else [1.0] * len(axes)
    if len(sp) == 1 and len(axes) > 1:
        sp = sp * len(axes)
    outs = []
    for ax, h in zip(axes, sp):
        h = float(h)
        x = torch.movedim(t, ax, 0)
        g = torch.empty_like(x)
        g[1:-1] = (x[2:] - x[:-2]) / (2 * h)
        g[0] = (x[1] - x[0]) / h
        g[-1] = (x[-1] - x[-2]) / h
        outs.append(torch.movedim(g, 0, ax))
    return outs[0] if len(outs) == 1 else outs


@fn()
def diff(a, n=1, axis=-1, prepend=None, append=None):
    t = _t(a)
    pre = None if prepend is None else torch.broadcast_to(
        _as(prepend, t.dtype), [1 if d == axis % t.ndim else s
                                  for d, s in enumerate(t.shape)]
        if _t(prepend).ndim == 0 else _t(prepend).shape)
    app = None if append is None else torch.broadcast_to(
        _as(append, t.dtype), [1 if d == axis % t.ndim else s
                                 for d, s in enumerate(t.shape)]
        if _t(append).ndim == 0 else _t(append).shape)
    if t.dtype == torch.bool:
        x = torch.cat([p for p in (pre, t, app) if p is not None], axis)
        for _ in builtins_range(n):
            x = x.narrow(axis, 1, x.shape[axis] - 1) != \
                x.narrow(axis, 0, x.shape[axis] - 1)
        return x
    return torch.diff(t, n, axis, pre, app)


@fn()
def ediff1d(ary, to_end=None, to_begin=None):
    t = _t(ary).reshape(-1)
    d = t[1:] - t[:-1]
    parts = ([_as(to_begin, d.dtype).reshape(-1)] if to_begin is not None
             else []) + [d] + ([_as(to_end, d.dtype).reshape(-1)]
                               if to_end is not None else [])
    return torch.cat(parts)


@fn()
def trapezoid(y, x=None, dx=1.0, axis=-1):
    t = _float(y)
    if x is None:
        return torch.trapezoid(t, dx=dx, dim=axis)
    return torch.trapezoid(t, _float(x).to(t.dtype), dim=axis)


@fn()
def unwrap(p, discont=None, axis=-1, *, period=2 * math.pi):
    t = _float(p)
    dd = torch.diff(t, dim=axis)
    discont = period / 2 if discont is None else discont
    half = period / 2
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    corr = ddmod - dd
    corr = torch.where(torch.abs(dd) < discont, torch.zeros_like(corr),
                       corr)
    first = t.narrow(axis, 0, 1)
    rest = t.narrow(axis, 1, t.shape[axis] - 1) + torch.cumsum(corr, axis)
    return torch.cat([first, rest], axis)


# ---------------------------------------------------------------------------
# polynomials
# ---------------------------------------------------------------------------
@fn()
def poly(seq_of_zeros):
    z = _t(seq_of_zeros)
    if z.ndim == 2 and z.shape[0] == z.shape[1] and z.shape[0] > 0:
        z = torch.linalg.eigvals(z.to(torch.complex128 if z.dtype ==
                                      torch.float64 else torch.complex64))
    z = z.reshape(-1)
    dt = z.dtype if (z.is_floating_point() or z.is_complex()) else \
        torch.float32
    a = torch.ones(1, dtype=dt, device=z.device)
    for r in z:
        a = _conv_full(a, torch.stack([torch.ones_like(r), -r]).to(dt))
    return a


@fn()
def polyadd(a1, a2):
    (x, y), _ = _args(a1, a2)
    n = max(x.numel(), y.numel())
    x = torch.cat([torch.zeros(n - x.numel(), dtype=x.dtype,
                               device=x.device), x])
    y = torch.cat([torch.zeros(n - y.numel(), dtype=y.dtype,
                               device=y.device), y])
    return x + y


@fn()
def polysub(a1, a2):
    return polyadd(a1, -_t(a2))


@fn()
def polymul(a1, a2, *, trim_leading_zeros=False):
    (x, y), _ = _args(a1, a2)
    return _conv_full(x.reshape(-1), y.reshape(-1))


@fn()
def polydiv(u, v, *, trim_leading_zeros=False):
    (x, y), _ = _args(_float(u), _float(v))
    m, n = x.numel() - 1, y.numel() - 1
    scale = 1.0 / y[0]
    q = torch.zeros(max(m - n + 1, 1), dtype=x.dtype, device=x.device)
    r = x.clone()
    for k in builtins_range(0, m - n + 1):
        d = scale * r[k]
        q[k] = d
        r[k:k + n + 1] = r[k:k + n + 1] - d * y
    return q, r


@fn()
def polyder(p, m=1):
    t = _t(p)
    if not (t.is_floating_point() or t.is_complex()):
        t = t.to(torch.float32)
    for _ in builtins_range(m):
        n = t.numel() - 1
        t = t[:-1] * torch.arange(n, 0, -1, dtype=t.dtype, device=t.device)
    return t


@fn()
def polyint(p, m=1, k=None):
    t = _float(p)
    ks = [0.0] * m if k is None else (list(np.atleast_1d(k)) * m
                                      if np.size(k) == 1 else list(k))
    for i in builtins_range(m):
        n = t.numel()
        t = torch.cat([t / torch.arange(n, 0, -1, dtype=t.dtype,
                                        device=t.device),
                       torch.tensor([ks[i]], dtype=t.dtype,
                                    device=t.device)])
    return t


@fn()
def polyval(p, x, *, unroll=16):
    (c, xt), _ = _args(p, x)
    y = torch.zeros_like(xt)
    for ci in c:
        y = y * xt + ci
    return y


@fn()
def vander(x, N=None, increasing=False):
    t = _t(x).reshape(-1)
    N = t.numel() if N is None else N
    pw = torch.arange(N, device=t.device)
    if not increasing:
        pw = pw.flip(0)
    return t.unsqueeze(-1) ** pw.to(t.dtype if t.is_floating_point()
                                    else torch.int64)


@fn()
def polyfit(x, y, deg, rcond=None, full=False, w=None, cov=False):
    xt, yt = _float(x), _float(y)
    dt = promote(xt.dtype, yt.dtype)
    xt, yt = xt.to(dt), yt.to(dt)
    lhs = vander(xt, deg + 1)
    rhs = yt
    if w is not None:
        wt = _as(w, dt)
        lhs = lhs * wt[:, None]
        rhs = rhs * (wt if rhs.ndim == 1 else wt[:, None])
    scale = torch.sqrt((lhs * lhs).sum(0))
    sol = torch.linalg.lstsq(lhs / scale, rhs if rhs.ndim == 2
                             else rhs[:, None], driver="gelsd").solution
    c = (sol.T / scale).T
    return c[:, 0] if rhs.ndim == 1 else c


@fn()
def roots(p, *, strip_zeros=True):
    t = _float(p).reshape(-1)
    nz = torch.nonzero(t != 0)[:, 0]
    if nz.numel() == 0:
        return torch.zeros(0, dtype=t.dtype, device=t.device)
    trailing = t.numel() - 1 - int(nz[-1])
    t = t[int(nz[0]):int(nz[-1]) + 1]
    n = t.numel() - 1
    cdt = torch.complex128 if t.dtype == torch.float64 else torch.complex64
    if n < 1:
        r = torch.zeros(0, dtype=cdt, device=t.device)
    else:
        comp = torch.zeros((n, n), dtype=t.dtype, device=t.device)
        comp[0] = -t[1:] / t[0]
        if n > 1:
            comp[1:, :-1] = torch.eye(n - 1, dtype=t.dtype, device=t.device)
        r = torch.linalg.eigvals(comp)
    return torch.cat([r, torch.zeros(trailing, dtype=r.dtype,
                                     device=r.device)])


# ---------------------------------------------------------------------------
# bits
# ---------------------------------------------------------------------------
@fn()
def packbits(a, axis=None, bitorder="big"):
    t = (_t(a) != 0).to(torch.uint8)
    if axis is None:
        t, axis = t.reshape(-1), 0
    t = torch.movedim(t, axis, -1)
    n = t.shape[-1]
    pad_ = (-n) % 8
    if pad_:
        t = torch.cat([t, torch.zeros(t.shape[:-1] + (pad_,),
                                      dtype=t.dtype, device=t.device)], -1)
    t = t.reshape(t.shape[:-1] + (-1, 8)).to(torch.int64)
    w = torch.tensor([7, 6, 5, 4, 3, 2, 1, 0] if bitorder == "big"
                     else list(builtins_range(8)), device=t.device)
    out = (t << w).sum(-1).to(torch.uint8)
    return torch.movedim(out, -1, axis)


@fn()
def unpackbits(a, axis=None, count=None, bitorder="big"):
    t = _t(a).to(torch.int64)
    if axis is None:
        t, axis = t.reshape(-1), 0
    t = torch.movedim(t, axis, -1)
    w = torch.tensor([7, 6, 5, 4, 3, 2, 1, 0] if bitorder == "big"
                     else list(builtins_range(8)), device=t.device)
    bits = ((t.unsqueeze(-1) >> w) & 1).reshape(t.shape[:-1] + (-1,))
    if count is not None:
        bits = bits[..., :count]
    return torch.movedim(bits.to(torch.uint8), -1, axis)


# ---------------------------------------------------------------------------
# functions of functions
# ---------------------------------------------------------------------------
def _np_wrap(t):
    from . import ndarray
    return ndarray(t)


def _unwrap(v):
    from ..ndarray.ndarray import NDArray
    return v._data if isinstance(v, NDArray) else _t(v)


@fn()
def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    t = _t(arr)
    axis %= t.ndim
    x = torch.movedim(t, axis, -1)
    batch = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    outs = [_unwrap(func1d(_np_wrap(r), *args, **kwargs)) for r in rows]
    out = torch.stack(outs).reshape(tuple(batch) + tuple(outs[0].shape))
    k = outs[0].ndim
    return torch.movedim(out, tuple(builtins_range(len(batch), out.ndim)),
                         tuple(builtins_range(axis, axis + k))) if k else out


@fn()
def apply_over_axes(func, a, axes):
    t = _t(a)
    for ax in (axes if isinstance(axes, (list, tuple)) else [axes]):
        r = _unwrap(func(_np_wrap(t), ax))
        if r.ndim == t.ndim - 1:
            r = r.unsqueeze(ax)
        t = r
    return t


@fn()
def piecewise(x, condlist, funclist, *args, **kw):
    t = _t(x)
    conds = [_t(c).bool() for c in (condlist if isinstance(
        condlist, (list, tuple)) else [condlist])]
    if len(funclist) == len(conds) + 1:
        other = ~torch.stack([torch.broadcast_to(c, t.shape)
                              for c in conds]).any(0)
        conds = conds + [other]
    out = torch.zeros_like(t)
    for c, f in zip(conds, funclist):
        val = _unwrap(f(_np_wrap(t), *args, **kw)) if callable(f) else \
            _t(f)
        out = torch.where(c, val.to(t.dtype), out)
    return out


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------
def _lf(x):
    t = _float(x)
    return t


@fn("linalg_cholesky")
def linalg_cholesky(a, *, upper=False, symmetrize_input=True):
    t = _lf(a)
    if symmetrize_input:
        t = (t + t.transpose(-1, -2).conj()) / 2
    return torch.linalg.cholesky(t, upper=upper)


@fn("linalg_cond")
def linalg_cond(x, p=None):
    return torch.linalg.cond(_lf(x), p)


@fn("linalg_det")
def linalg_det(a):
    return torch.linalg.det(_lf(a))


@fn("linalg_slogdet")
def linalg_slogdet(a, *, method=None):
    s, l = torch.linalg.slogdet(_lf(a))
    return s, l


@fn("linalg_diagonal")
def linalg_diagonal(x, /, *, offset=0):
    return torch.diagonal(_t(x), offset, -2, -1).clone()


@fn("linalg_eig")
def linalg_eig(a):
    w, v = torch.linalg.eig(_lf(a))
    return w, v


@fn("linalg_eigvals")
def linalg_eigvals(a):
    return torch.linalg.eigvals(_lf(a))


@fn("linalg_eigh")
def linalg_eigh(a, UPLO=None, symmetrize_input=True):
    t = _lf(a)
    if symmetrize_input:
        t = (t + t.transpose(-1, -2).conj()) / 2
    w, v = torch.linalg.eigh(t, UPLO=UPLO or "L")
    return w, v


@fn("linalg_eigvalsh")
def linalg_eigvalsh(a, UPLO="L", *, symmetrize_input=True):
    return linalg_eigh(a, UPLO, symmetrize_input)[0]


@fn("linalg_inv")
def linalg_inv(a):
    return torch.linalg.inv(_lf(a))


@fn("linalg_lstsq")
def linalg_lstsq(a, b, rcond=None, *, numpy_resid=False):
    A, B = _lf(a), _lf(b)
    dt = promote(A.dtype, B.dtype)
    A, B = A.to(dt), B.to(dt)
    vec = B.ndim == 1
    Bm = B[:, None] if vec else B
    pinv_ = torch.linalg.pinv(A, rtol=rcond if rcond is not None else
                              max(A.shape) * torch.finfo(dt).eps)
    x = pinv_ @ Bm
    s = torch.linalg.svdvals(A)
    tol = (rcond if rcond is not None else max(A.shape)
           * torch.finfo(dt).eps) * s[0]
    rank = (s > tol).sum()
    r = Bm - A @ x
    resid = (r * r.conj()).real.sum(0) if (rank == A.shape[1]
                                           and A.shape[0] > A.shape[1]) \
        else torch.zeros(0, dtype=s.dtype, device=A.device)
    return (x[:, 0] if vec else x), (resid[:1] if vec and resid.numel()
                                     else resid), rank.to(torch.int32), s


@fn("linalg_matrix_norm")
def linalg_matrix_norm(x, /, *, keepdims=False, ord="fro"):
    return torch.linalg.matrix_norm(_lf(x), ord, keepdim=keepdims)


@fn("linalg_matrix_power")
def linalg_matrix_power(a, n):
    return torch.linalg.matrix_power(_t(a), n)


@fn("linalg_matrix_rank")
def linalg_matrix_rank(M, rtol=None, *, tol=None):
    t = _lf(M)
    if t.ndim < 2:
        return (t != 0).any().to(torch.int64)
    return torch.linalg.matrix_rank(t, atol=tol, rtol=rtol)


@fn("linalg_multi_dot")
def linalg_multi_dot(arrays, *, precision=None):
    ts = _same(arrays)
    first, last = ts[0].ndim == 1, ts[-1].ndim == 1
    if first:
        ts[0] = ts[0].unsqueeze(0)
    if last:
        ts[-1] = ts[-1].unsqueeze(-1)
    out = torch.linalg.multi_dot(ts)
    if first:
        out = out[0]
    if last:
        out = out[..., 0]
    return out


@fn("linalg_norm")
def linalg_norm(x, ord=None, axis=None, keepdims=False):
    t = _lf(x)
    if axis is None and ord is None:
        r = torch.linalg.vector_norm(t.reshape(-1))
        return r.reshape((1,) * t.ndim) if keepdims else r
    dim = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return torch.linalg.norm(t, ord, dim, keepdims)


@fn("linalg_pinv")
def linalg_pinv(a, rtol=None, hermitian=False, *, rcond=None):
    t = _lf(a)
    rt = rtol if rtol is not None else rcond
    if rt is None:
        rt = max(t.shape[-2:]) * torch.finfo(t.dtype).eps
    return torch.linalg.pinv(t, rtol=rt, hermitian=hermitian)


@fn("linalg_qr")
def linalg_qr(a, mode="reduced"):
    q, r = torch.linalg.qr(_lf(a), mode="r" if mode == "r" else mode)
    return r if mode == "r" else (q, r)


@fn("linalg_solve")
def linalg_solve(a, b):
    A, B = _lf(a), _lf(b)
    dt = promote(A.dtype, B.dtype)
    return torch.linalg.solve(A.to(dt), B.to(dt))


@fn("linalg_svd")
def linalg_svd(a, full_matrices=True, compute_uv=True, hermitian=False,
               subset_by_index=None):
    t = _lf(a)
    if not compute_uv:
        return torch.linalg.svdvals(t)
    u, s, vh = torch.linalg.svd(t, full_matrices=full_matrices)
    return u, s, vh


@fn("linalg_svdvals")
def linalg_svdvals(x, /):
    return torch.linalg.svdvals(_lf(x))


@fn("linalg_tensorinv")
def linalg_tensorinv(a, ind=2):
    return torch.linalg.tensorinv(_lf(a), ind)


@fn("linalg_tensorsolve")
def linalg_tensorsolve(a, b, axes=None):
    A, B = _lf(a), _lf(b)
    dt = promote(A.dtype, B.dtype)
    return torch.linalg.tensorsolve(A.to(dt), B.to(dt), axes)


@fn("linalg_trace")
def linalg_trace(x, /, *, offset=0, dtype=None):
    return sum_(torch.diagonal(_t(x), offset, -2, -1), -1, dtype=dtype)


@fn("linalg_vector_norm")
def linalg_vector_norm(x, /, *, axis=None, keepdims=False, ord=2):
    t = _lf(x)
    dim = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return torch.linalg.vector_norm(t, ord, dim, keepdims)


# ---------------------------------------------------------------------------
# fft
# ---------------------------------------------------------------------------
def _fft1(torch_fn):
    def f(a, n=None, axis=-1, norm=None):
        return torch_fn(_lf(a), n=n, dim=axis, norm=norm)
    return f


def _fftn(torch_fn, default_axes=None):
    def f(a, s=None, axes=default_axes, norm=None):
        return torch_fn(_lf(a), s=s, dim=axes, norm=norm)
    return f


for _n in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
    fn(f"fft_{_n}")(_fft1(getattr(torch.fft, _n)))
for _n in ("fft2", "ifft2", "rfft2", "irfft2"):
    fn(f"fft_{_n}")(_fftn(getattr(torch.fft, _n), (-2, -1)))
for _n in ("fftn", "ifftn", "rfftn", "irfftn"):
    fn(f"fft_{_n}")(_fftn(getattr(torch.fft, _n)))


@fn("fft_fftfreq")
def fft_fftfreq(n, d=1.0, *, dtype=None, device=None):
    return torch.fft.fftfreq(n, d, dtype=_fdt(dtype), device=_dev())


@fn("fft_rfftfreq")
def fft_rfftfreq(n, d=1.0, *, dtype=None, device=None):
    return torch.fft.rfftfreq(n, d, dtype=_fdt(dtype), device=_dev())


@fn("fft_fftshift")
def fft_fftshift(x, axes=None):
    return torch.fft.fftshift(_t(x), axes)


@fn("fft_ifftshift")
def fft_ifftshift(x, axes=None):
    return torch.fft.ifftshift(_t(x), axes)


# ---------------------------------------------------------------------------
# index tricks
# ---------------------------------------------------------------------------
def _slice_range(s: slice):
    start = 0 if s.start is None else s.start
    step = 1 if s.step is None else s.step
    if isinstance(step, complex):
        return linspace(start, s.stop, int(abs(step)))
    return arange(start, s.stop, step)


class _Grid:
    def __init__(self, sparse):
        self.sparse = sparse

    def __getitem__(self, key):
        from . import ndarray
        keys = key if isinstance(key, tuple) else (key,)
        axes = [_slice_range(k) for k in keys]
        if not isinstance(key, tuple):
            return ndarray(axes[0])
        dt = functools.reduce(promote, [a.dtype for a in axes])
        grids = meshgrid(*[a.to(dt) for a in axes], sparse=self.sparse,
                         indexing="ij")
        return [ndarray(g) for g in grids] if self.sparse else \
            ndarray(torch.stack(grids))


class _Concat:
    def __init__(self, column):
        self.column = column

    def __getitem__(self, key):
        from . import ndarray
        keys = key if isinstance(key, tuple) else (key,)
        if keys and isinstance(keys[0], str):
            raise NotImplementedError("mx.np.r_/c_ directives are not "
                                      "ported")
        parts = [_slice_range(k) if isinstance(k, slice) else
                 _unwrap(k) for k in keys]
        parts = [p.reshape(1) if p.ndim == 0 else p for p in parts]
        if self.column:
            parts = [p.reshape(-1, 1) if p.ndim == 1 else p for p in parts]
            return ndarray(torch.cat(_same(parts), -1))
        return ndarray(torch.cat(_same(parts), 0))


CONSTANTS.update(mgrid=_Grid(False), ogrid=_Grid(True), r_=_Concat(False),
                 c_=_Concat(True))
