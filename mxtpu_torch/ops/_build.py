"""Build the port's CUDA C++ kernels and load them with ctypes.

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
from typing import Dict, List, Optional

__all__ = ["load_kernels", "build_info", "check", "SOURCES", "HEADERS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]
SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "conv3x3.cu")
HEADERS = ("flash_common.cuh",)   # included by the sources
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
        [_c_ptr] * 7 + [_c_i64] * 12 + [_c_int] * 6
        + [ctypes.c_float, _c_int, _c_ptr],
    "mxtpu_conv3x3_bf16": [_c_ptr] * 3 + [_c_int] * 5 + [_c_ptr],
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
