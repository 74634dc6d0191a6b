"""Build the port's CUDA C++ kernels, and ``mx.rtc``'s user modules, and
load them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (all
sources started together, one process each; the shared ``*.cuh``
headers are part of the build's hash) and linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The
library lands in ``build/mxtpu_torch_kernels/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and flags, so a tree
builds once and an edited source builds anew. Nothing is compiled when
a module is imported: :func:`load_kernels` builds at first use, which
needs ``nvcc`` (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
``PATH``) and nothing from outside the repository.

:func:`load_rtc` builds one ``mx.rtc.CudaModule``'s source the same way,
at its first launch: the user's source, the CUDA type headers before it
and one generated C entry point per kernel after it
(``mxtpu_rtc_launch_<name>``, which calls ``cudaLaunchKernel``), in one
``nvcc`` call, into ``build/mxtpu_torch_rtc/<hash>/``, keyed by a hash of
that text and the flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["load_kernels", "build_info", "check", "load_rtc", "SOURCES",
           "HEADERS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]
SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "conv3x3.cu")
HEADERS = ("hopper_common.cuh",)  # included by the sources
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_ptr = ctypes.c_void_p
_c_i64 = ctypes.c_longlong
_c_int = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    "mxtpu_flash_attn_fwd_bf16":
        [_c_ptr] * 5 + [_c_i64] * 9 + [_c_int] * 6
        + [ctypes.c_float, _c_int, _c_ptr],
    "mxtpu_flash_attn_bwd_dkv_bf16":
        [_c_ptr] * 8 + [_c_i64] * 12 + [_c_int] * 6
        + [ctypes.c_float, _c_int, _c_ptr],
    "mxtpu_flash_attn_bwd_dq_bf16":
        [_c_ptr] * 8 + [_c_i64] * 15 + [_c_int] * 6
        + [ctypes.c_float, _c_int, _c_ptr],
    "mxtpu_conv3x3_bf16": [_c_ptr] * 3 + [_c_int] * 7 + [_c_ptr],
    # the kernels' registers and shared memory, for reports
    "mxtpu_flash_attn_fwd_attrs": [_c_int, ctypes.POINTER(_c_int),
                                   ctypes.POINTER(_c_int)],
    "mxtpu_flash_attn_bwd_attrs": [_c_int, _c_int, ctypes.POINTER(_c_int),
                                   ctypes.POINTER(_c_int)],
    "mxtpu_conv3x3_attrs": [_c_int, _c_int, ctypes.POINTER(_c_int),
                            ctypes.POINTER(_c_int)],
}

_lib: Optional[ctypes.CDLL] = None
_info: Dict[str, object] = {}
_lock = threading.Lock()        # one build per process, however many callers


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's kernels are built on a machine with the CUDA "
        "toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    """Compile every source in parallel, then link one ``.so``."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs: List[subprocess.Popen] = []
    objs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for name, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    lib = out_dir / "libmxtpu_torch_kernels.so"
    tmp = out_dir / f".{lib.name}.{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-Xcompiler", "-fPIC", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)           # readers never see a half-written .so
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    return lib


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    with _lock:
        if _lib is None:
            _load()
    return _lib


def _load() -> None:
    global _lib
    out_dir = _ROOT / "build" / "mxtpu_torch_kernels" / _digest()
    lib_path = out_dir / "libmxtpu_torch_kernels.so"
    t0 = time.perf_counter()
    built = not lib_path.exists()
    if built:
        lib_path = _build(out_dir)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _c_int
    lib.mxtpu_cuda_error_string.argtypes = [_c_int]
    lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
    log = out_dir / "ptxas.log"
    _info.update(path=str(lib_path), built=built,
                 seconds=time.perf_counter() - t0,
                 ptxas=log.read_text() if log.exists() else "")
    _lib = lib


def build_info() -> Dict[str, object]:
    """Where the library came from: path, whether this process built it,
    the seconds that took, and ``nvcc -Xptxas -v``'s report."""
    return dict(_info)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load_kernels().mxtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# mx.rtc: user modules compiled at run time
# ---------------------------------------------------------------------------
_RTC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_RTC_PRELUDE = ("#include <cuda_runtime.h>\n#include <cuda_fp16.h>\n"
                "#include <cuda_bf16.h>\n#line 1 \"rtc_source.cu\"\n")
_RTC_ENTRY = """
extern "C" int mxtpu_rtc_launch_{name}(void** args, unsigned gx,
    unsigned gy, unsigned gz, unsigned bx, unsigned by, unsigned bz,
    unsigned smem, void* stream) {{
  const void* fn = (const void*)&{name};
  if (smem > 48 * 1024) {{
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }}
  return (int)cudaLaunchKernel(fn, dim3(gx, gy, gz), dim3(bx, by, bz), args,
                               (size_t)smem, (cudaStream_t)stream);
}}
"""
_RTC_ERROR = """
extern "C" const char* mxtpu_rtc_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
"""
_rtc_libs: Dict[str, Tuple[ctypes.CDLL, Dict[str, object]]] = {}


def load_rtc(source: str, kernels: Sequence[str],
             options: Sequence[str] = ()) -> Tuple[ctypes.CDLL,
                                                   Dict[str, object]]:
    """The shared library of one rtc module, built on first use and
    loaded once per process, and its build info (path, built, seconds,
    nvcc's log). ``kernels`` names the ``__global__`` functions of
    ``source`` that get an entry point. A source nvcc rejects raises
    :class:`MXNetError` with nvcc's log."""
    text = (_RTC_PRELUDE + source + "\n"
            + "".join(_RTC_ENTRY.format(name=k) for k in kernels)
            + _RTC_ERROR)
    flags = _RTC_FLAGS + list(options)
    digest = hashlib.sha256(
        (text + "\0" + " ".join(flags)).encode()).hexdigest()[:16]
    with _lock:
        if digest not in _rtc_libs:
            _rtc_libs[digest] = _load_rtc(text, kernels, flags, digest)
    return _rtc_libs[digest]


def _load_rtc(text, kernels, flags, digest):
    out_dir = _ROOT / "build" / "mxtpu_torch_rtc" / digest
    lib_path = out_dir / "libmxtpu_rtc.so"
    t0 = time.perf_counter()
    built = not lib_path.exists()
    if built:
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / f"module.{os.getpid()}.cu"
        tmp = out_dir / f".{lib_path.name}.{os.getpid()}"
        src.write_text(text)
        res = subprocess.run([nvcc, *flags, str(src), "-o", str(tmp)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise MXNetError(f"nvcc rejected the rtc module "
                             f"({src}):\n{res.stdout}")
        os.replace(tmp, lib_path)  # readers never see a half-written .so
        os.replace(src, out_dir / "module.cu")
        (out_dir / "nvcc.log").write_text(res.stdout)
    lib = ctypes.CDLL(str(lib_path))
    for k in kernels:
        fn = getattr(lib, f"mxtpu_rtc_launch_{k}")
        fn.argtypes = [_c_ptr] + [ctypes.c_uint] * 7 + [_c_ptr]
        fn.restype = _c_int
    lib.mxtpu_rtc_error_string.argtypes = [_c_int]
    lib.mxtpu_rtc_error_string.restype = ctypes.c_char_p
    log = out_dir / "nvcc.log"
    return lib, {"path": str(lib_path), "built": built,
                 "seconds": time.perf_counter() - t0,
                 "nvcc": log.read_text() if log.exists() else ""}
