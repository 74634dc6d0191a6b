"""mx.rtc — run-time-compiled user kernels: the port of ``mxtpu/rtc.py``.

On a TPU the user's kernel language was Pallas (``PallasModule``); on
Hopper it is CUDA C, as in MXNet 1.x's ``mx.rtc.CudaModule``::

    import mxtpu_torch as mx

    source = r'''
    extern "C" __global__ void scale_add(const float* x, const float* y,
                                         float* out, long long n) {
      for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
           i < n; i += (long long)gridDim.x * blockDim.x)
        out[i] = x[i] * 2.0f + y[i];
    }'''
    mod = mx.rtc.CudaModule(source, exports=["scale_add"])
    kern = mod.get_kernel("scale_add")
    out = kern.launch(x, y)                 # NDArrays on the card

**Launch convention.** ``launch(*args, out_shape=None, out_dtype=None,
grid=None, block=None, shared_mem=0)`` allocates the output (shape and
dtype default to the first NDArray argument's) and calls the kernel with
one parameter per argument, in order — a pointer for an NDArray, a
scalar for a Python number — then the output's pointer, then
``n = out.numel()``: ``__global__ void name(const T* in0, ..., T* out,
long long n)``. The grid defaults to ⌈n/256⌉ blocks of 256 threads.
Before anything runs, the kernel's parameter list, parsed from the
source, is held against the arguments: their number, pointer or scalar,
and element type (``float`` float32, ``double`` float64, ``__half``
float16, ``__nv_bfloat16`` bfloat16, ``int`` int32, ``long long``
int64, ``short`` int16, ``int8_t`` int8, ``uint8_t`` uint8, ``bool``),
and a mismatch raises :class:`MXNetError`. ``cuda_fp16.h`` and
``cuda_bf16.h`` are included ahead of the source.

The module compiles with ``nvcc`` for ``sm_90a`` at the first launch on
a CUDA tensor (``ops/_build.py``, into ``build/mxtpu_torch_rtc/``), so
a module is built, and its kernels looked up and checked, without a
card. There is no fallback: a launch on CPU arrays raises, and so does
a launch under ``autograd.record()`` with an input on the tape (the
reference raises there too: ``jax.vjp`` cannot linearise
``pallas_call``). A kernel that needs a gradient is written as a torch
function and wrapped with :func:`torch_kernel`, or launched inside
``autograd.pause()``.
"""
from __future__ import annotations

import collections
import ctypes
import math
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from . import autograd
from .base import (MXNetError, dtype_name, dtype_torch, integer_types,
                   numeric_types)
from .ndarray import NDArray
from .ndarray.ndarray import _parents_of, apply_op

__all__ = ["CudaModule", "CudaKernel", "torch_kernel", "launches"]

# launches of each rtc kernel, by kernel name
launches: Dict[str, int] = collections.Counter()


def torch_kernel(fn: Callable, name: Optional[str] = None) -> Callable:
    """Wrap a torch function into an NDArray op (tape-aware): the
    counterpart of the reference's ``jax_kernel``. ``fn`` takes and
    returns tensors; its gradient comes from torch autograd through
    the tape."""
    opname = name or getattr(fn, "__name__", "torch_kernel")

    def op(*arrays, **kwargs):
        raw = fn if not kwargs else (lambda *xs: fn(*xs, **kwargs))
        return apply_op(raw, list(arrays), opname)
    op.__name__ = opname
    return op


# ---------------------------------------------------------------------------
# parameter lists
# ---------------------------------------------------------------------------
# element types a pointer parameter may point to
_POINTEE = {
    "float": torch.float32, "double": torch.float64,
    "__half": torch.float16, "half": torch.float16,
    "__nv_bfloat16": torch.bfloat16, "nv_bfloat16": torch.bfloat16,
    "int": torch.int32, "int32_t": torch.int32,
    "long long": torch.int64, "long long int": torch.int64,
    "long": torch.int64, "int64_t": torch.int64,
    "short": torch.int16, "int16_t": torch.int16,
    "int8_t": torch.int8, "signed char": torch.int8,
    "uint8_t": torch.uint8, "unsigned char": torch.uint8,
    "bool": torch.bool,
}
# scalar parameters: C type -> (ctypes type, integral)
_SCALAR = {
    "int": (ctypes.c_int32, True), "int32_t": (ctypes.c_int32, True),
    "unsigned": (ctypes.c_uint32, True),
    "unsigned int": (ctypes.c_uint32, True),
    "uint32_t": (ctypes.c_uint32, True),
    "long long": (ctypes.c_int64, True),
    "long long int": (ctypes.c_int64, True),
    "long": (ctypes.c_int64, True), "int64_t": (ctypes.c_int64, True),
    "unsigned long long": (ctypes.c_uint64, True),
    "uint64_t": (ctypes.c_uint64, True), "size_t": (ctypes.c_uint64, True),
    "float": (ctypes.c_float, False), "double": (ctypes.c_double, False),
    "bool": (ctypes.c_bool, True),
}
_QUALIFIERS = {"const", "volatile", "__restrict__", "__restrict", "restrict"}
_KERNEL_RE = re.compile(
    r"(template\s*<[^>]*>\s*)?(?:extern\s+\"C\"\s+)?__global__\s+"
    r"(?:__launch_bounds__\s*\([^)]*\)\s*)?void\s+"
    r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(([^)]*)\)")


class Param(NamedTuple):
    """One kernel parameter: ``ctype`` is its C type without qualifiers
    (the pointee's for a pointer)."""
    name: str
    ctype: str
    pointer: bool
    const: bool

    def describe(self) -> str:
        return (f"{'const ' if self.const else ''}{self.ctype}"
                f"{'*' if self.pointer else ''} {self.name}")


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    return re.sub(r"//[^\n]*", " ", src)


def parse_params(params: str) -> List[Param]:
    """A C parameter list (``"const float* x, int n"``) as Params;
    raises MXNetError on a pointer to pointer or an unnamed one."""
    params = params.strip()
    if params in ("", "void"):
        return []
    out = []
    for raw in params.split(","):
        toks = re.findall(r"\w+|\*|&", raw)
        if "&" in toks or toks.count("*") > 1 or len(toks) < 2 \
                or not re.match(r"[A-Za-z_]\w*$", toks[-1]):
            raise MXNetError(f"unsupported kernel parameter {raw.strip()!r}")
        name, body = toks[-1], toks[:-1]
        pointer = "*" in body
        # a const before the '*' qualifies the pointee
        const = "const" in (body[:body.index("*")] if pointer else body)
        ctype = " ".join(t for t in body
                         if t != "*" and t not in _QUALIFIERS)
        out.append(Param(name, ctype, pointer, const))
    return out


def parse_kernels(source: str) -> Dict[str, List[Param]]:
    """Every non-template ``__global__`` function of ``source``, with
    its parameters, in the order they are defined."""
    return {m.group(2): parse_params(m.group(3))
            for m in _KERNEL_RE.finditer(_strip_comments(source))
            if not m.group(1)}


# ---------------------------------------------------------------------------
# modules and kernels
# ---------------------------------------------------------------------------
class CudaModule:
    """A CUDA C source with its kernels (MXNet's ``mx.rtc.CudaModule``):
    compiled with ``options`` (extra ``nvcc`` flags) at the first launch
    on a CUDA tensor; ``exports``, when given, are the only kernels
    ``get_kernel`` returns."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self._params = parse_kernels(source)
        missing = [e for e in self.exports if e not in self._params]
        if missing:
            raise MXNetError(f"exports {missing} are not __global__ "
                             f"functions of the source (it defines "
                             f"{sorted(self._params)})")
        self._lib = None
        self.build_info: Dict[str, object] = {}

    @property
    def kernel_names(self) -> List[str]:
        return list(self.exports or self._params)

    def get_kernel(self, name: str, signature: str = "") -> "CudaKernel":
        """The kernel ``name``; ``signature``, MXNet's parameter list
        (``"const float* x, float* y, long long n"``), is held against
        the source's when given."""
        if name not in self.kernel_names:
            raise MXNetError(f"kernel {name!r} not found in this module "
                             f"(have: {sorted(self.kernel_names)})")
        params = self._params[name]
        for p in params:
            table = _POINTEE if p.pointer else _SCALAR
            if p.ctype not in table:
                raise MXNetError(f"kernel {name!r}: parameter "
                                 f"{p.describe()!r} has a type rtc cannot "
                                 f"pass (have: {sorted(table)})")
        if signature:
            want = [(p.ctype, p.pointer, p.const)
                    for p in parse_params(signature)]
            if want != [(p.ctype, p.pointer, p.const) for p in params]:
                raise MXNetError(
                    f"kernel {name!r} is ({_describe(params)}) in the "
                    f"source, not ({signature})")
        return CudaKernel(self, name, params)

    def _load(self):
        """The module's library, built with nvcc at first use."""
        if self._lib is None:
            from .ops import _build
            self._lib, self.build_info = _build.load_rtc(
                self.source, self.kernel_names, self.options)
        return self._lib


def _describe(params: Sequence[Param]) -> str:
    return ", ".join(p.describe() for p in params)


def _dims(v, default) -> tuple:
    v = default if v is None else v
    v = (v,) if isinstance(v, int) else tuple(v)
    if not 1 <= len(v) <= 3 or any(int(d) < 1 for d in v):
        raise MXNetError(f"grid and block take 1 to 3 positive sizes, "
                         f"got {v}")
    return tuple(int(d) for d in v) + (1,) * (3 - len(v))


class CudaKernel:
    """One kernel of a :class:`CudaModule` (MXNet's
    ``CudaModule.Kernel``); see the module docstring for its launch
    convention."""

    def __init__(self, module: CudaModule, name: str, params: List[Param]):
        self.module = module
        self.name = name
        self.params = params

    def _plan(self, args, out_shape=None, out_dtype=None):
        """(output shape, output dtype) of a launch on ``args``, after
        holding the arguments against the kernel's parameters."""
        arrays = [a for a in args if isinstance(a, NDArray)]
        if not arrays:
            raise MXNetError("launch needs at least one input array")
        shape = tuple(out_shape) if out_shape is not None \
            else arrays[0].shape
        dtype = dtype_torch(out_dtype) if out_dtype is not None \
            else arrays[0].dtype
        ps = self.params
        if len(ps) != len(args) + 2:
            raise MXNetError(
                f"kernel {self.name!r} takes {len(ps)} parameters "
                f"({_describe(ps)}); a launch with {len(args)} arguments "
                f"passes {len(args) + 2} (the arguments, out, n)")
        for p, a in zip(ps, args):
            self._check_arg(p, a)
        out, n = ps[-2], ps[-1]
        if not out.pointer or out.const:
            raise MXNetError(f"kernel {self.name!r}: the output parameter "
                             f"{out.describe()!r} must be a non-const "
                             f"pointer")
        if _POINTEE[out.ctype] != dtype:
            raise MXNetError(f"kernel {self.name!r}: output parameter "
                             f"{out.describe()!r} is not {dtype_name(dtype)}"
                             f" (out_dtype defaults to the first input's)")
        if n.pointer or not _SCALAR[n.ctype][1]:
            raise MXNetError(f"kernel {self.name!r}: the last parameter "
                             f"{n.describe()!r} must be an integer (n)")
        return shape, dtype

    def _check_arg(self, p: Param, a) -> None:
        if isinstance(a, NDArray):
            if not p.pointer:
                raise MXNetError(f"kernel {self.name!r}: parameter "
                                 f"{p.describe()!r} is a scalar, got an "
                                 f"array")
            if _POINTEE[p.ctype] != a.dtype:
                raise MXNetError(f"kernel {self.name!r}: parameter "
                                 f"{p.describe()!r} takes "
                                 f"{dtype_name(_POINTEE[p.ctype])}, got "
                                 f"{dtype_name(a.dtype)}")
        elif isinstance(a, numeric_types):
            if p.pointer:
                raise MXNetError(f"kernel {self.name!r}: parameter "
                                 f"{p.describe()!r} is a pointer, got the "
                                 f"scalar {a!r}")
            if _SCALAR[p.ctype][1] and not isinstance(a, integer_types):
                raise MXNetError(f"kernel {self.name!r}: parameter "
                                 f"{p.describe()!r} is an integer, got "
                                 f"{a!r}")
        else:
            raise MXNetError(f"kernel {self.name!r}: launch takes NDArrays "
                             f"and Python numbers, got {type(a).__name__}")

    def launch(self, *args, out_shape=None, out_dtype=None, grid=None,
               block=None, shared_mem: int = 0) -> NDArray:
        """Run on NDArrays (and Python numbers for scalar parameters) on
        one CUDA device; returns the new output array, recorded as
        ``rtc[<name>]``."""
        shape, dtype = self._plan(args, out_shape, out_dtype)
        arrays = [a for a in args if isinstance(a, NDArray)]
        if autograd.is_recording() and any(
                p is not None for p in _parents_of(arrays)):
            raise MXNetError(
                f"rtc kernel {self.name!r} has no gradient: it cannot run "
                f"under autograd.record() on arrays on the tape; launch it "
                f"inside autograd.pause(), or wrap a torch function with "
                f"rtc.torch_kernel")
        dev = arrays[0].context
        if dev.type != "cuda" or any(a.context != dev for a in arrays):
            raise MXNetError(
                f"rtc kernel {self.name!r} runs on arrays on one CUDA "
                f"device, got {[str(a.context) for a in arrays]}; a CUDA C "
                f"kernel has no CPU version")
        n = math.prod(shape)
        if n >= 2 ** (8 * ctypes.sizeof(_SCALAR[self.params[-1].ctype][0])
                      - 1):
            raise MXNetError(f"kernel {self.name!r}: n = {n} does not fit "
                             f"its {self.params[-1].describe()!r}")
        blk = _dims(block, 256)
        grd = _dims(grid, max(1, -(-n // blk[0])))

        def run(*tensors):
            it = iter(tensors)
            vals = [next(it).contiguous() if isinstance(a, NDArray) else a
                    for a in args]
            out = torch.empty(shape, dtype=dtype, device=dev)
            if n:
                self._launch(vals + [out, n], grd, blk, shared_mem, dev)
            return out
        return apply_op(run, arrays, f"rtc[{self.name}]")

    def _launch(self, vals, grid, block, shared_mem, dev) -> None:
        lib = self.module._load()
        held = [ctypes.c_void_p(v.data_ptr()) if isinstance(v, torch.Tensor)
                else _SCALAR[p.ctype][0](v)
                for p, v in zip(self.params, vals)]
        # argv points at ``held``, which lives until this call returns
        argv = (ctypes.c_void_p * len(held))(*map(ctypes.addressof, held))
        entry = getattr(lib, f"mxtpu_rtc_launch_{self.name}")
        with torch.cuda.device(dev):
            err = entry(argv, *grid, *block, shared_mem,
                        torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise MXNetError(
                f"rtc kernel {self.name!r} launch failed: CUDA error {err} "
                f"({lib.mxtpu_rtc_error_string(err).decode()})")
        launches[self.name] += 1
