"""The native IO library: the port of ``mxtpu/native.py``, ctypes
bindings to ``csrc/libmxtpu_io.cc`` (the RecordIO reader, the JPEG
codec, the threaded decode pipeline).

The library is built with ``g++ -O3 -std=c++17 -fPIC -shared`` at first
use, into ``build/mxtpu_torch_io/<hash>/`` at the root of the checkout
(the hash covers the source, the compiler, the flags and which codec
headers the host has), as the reference builds its own at first use; a
process that finds it built compiles nothing. The JPEG codec is decided when the library
is built, not when it runs: libjpeg (``-ljpeg``) where a program that
includes ``<jpeglib.h>`` compiles and links, else nvJPEG from the CUDA
toolkit (``$CUDA_HOME``, or ``/usr/local/cuda``) where ``nvjpeg.h`` is,
linked statically. :func:`backend` says which. nvJPEG runs on the card:
in a process that sees none, the codec raises ``RuntimeError`` naming
the cause (a DataLoader therefore decodes such samples on threads, not
in its worker processes, which hide the card).

Unlike the reference, nothing falls back to Python: when the library
cannot be built or loaded, :class:`NativeRecordReader`,
:func:`jpeg_decode`, :func:`jpeg_encode` and :class:`NativePipeline`
raise ``RuntimeError`` with the compiler's output. :func:`available`
reports whether the library loads, and is not a switch for any path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as onp

__all__ = ["get_lib", "available", "backend", "codec_calls",
           "NativeRecordReader", "jpeg_decode", "jpeg_encode",
           "NativePipeline"]

_SRC = Path(__file__).resolve().parent / "csrc" / "libmxtpu_io.cc"
_ROOT = Path(__file__).resolve().parents[1]
_CXX = "g++"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]
_JPEG_PROBE = ("#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n"
               "int main() { jpeg_decompress_struct c; "
               "jpeg_create_decompress(&c); return 0; }\n")

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None       # why the build failed, once it has
_LOCK = threading.Lock()


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _run(cmd: List[str]) -> Tuple[int, str]:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
    return proc.returncode, proc.stdout


def _probe_codec() -> str:
    """libjpeg where a program that includes ``<jpeglib.h>`` builds,
    else nvjpeg where the toolkit has ``nvjpeg.h``; raises with both
    findings otherwise."""
    with tempfile.TemporaryDirectory() as tmp:
        probe = os.path.join(tmp, "probe.cc")
        with open(probe, "w") as f:
            f.write(_JPEG_PROBE)
        rc, out = _run([_CXX, probe, "-o", os.path.join(tmp, "probe"),
                        "-ljpeg"])
    if rc == 0:
        return "libjpeg"
    cuda = _cuda_home()
    if os.path.isfile(os.path.join(cuda, "include", "nvjpeg.h")):
        return "nvjpeg"
    raise RuntimeError(
        "the native IO library needs libjpeg (<jpeglib.h> and -ljpeg) or "
        f"nvJPEG ({cuda}/include/nvjpeg.h); neither is here. The libjpeg "
        f"probe said:\n{out}")


def _codec_flags(codec: str) -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) of a codec."""
    if codec == "libjpeg":
        return [], ["-ljpeg", "-lpthread"]
    cuda = _cuda_home()
    return ["-DMXTPU_IO_NVJPEG", f"-I{cuda}/include"], [
        f"-L{cuda}/lib64", "-lnvjpeg_static", "-lculibos",
        "-lcudart_static", "-lpthread", "-ldl", "-lrt"]


def _codec_headers() -> List[str]:
    """The codecs' headers this host has where the compiler looks by
    default (and in ``CPATH``/``CPLUS_INCLUDE_PATH``): a few file checks
    that key the build, so that a build directory copied from a host
    with other headers is not taken for this host's."""
    dirs = ["/usr/local/include", "/usr/include"] + [
        d for var in ("CPATH", "CPLUS_INCLUDE_PATH")
        for d in os.environ.get(var, "").split(os.pathsep) if d]
    found = [os.path.join(d, "jpeglib.h") for d in dirs]
    found.append(os.path.join(_cuda_home(), "include", "nvjpeg.h"))
    return [f for f in found if os.path.isfile(f)]


def _build() -> Path:
    """The library's path, built when missing. Its directory is keyed by
    the source, the compiler, the flags, the codec probe and the codecs'
    headers found; the codec is probed only to build, so a process that
    finds the library built runs no compiler (``backend()`` asks the
    library which codec it holds)."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join([_CXX, _cuda_home(), _JPEG_PROBE] + _FLAGS
                      + _codec_headers()).encode())
    out_dir = _ROOT / "build" / "mxtpu_torch_io" / h.hexdigest()[:16]
    so = out_dir / "libmxtpu_io.so"
    if so.exists():
        return so
    codec = _probe_codec()
    cflags, ldflags = _codec_flags(codec)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{so.name}.{os.getpid()}.{threading.get_ident()}"
    rc, out = _run([_CXX, *_FLAGS, *cflags, str(_SRC), "-o", str(tmp),
                    *ldflags])
    if rc != 0:
        raise RuntimeError(f"g++ failed to build {_SRC.name} ({codec}):\n"
                           f"{out}")
    os.replace(tmp, so)            # readers never see a half-written .so
    return so


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    f32p = ctypes.POINTER(ctypes.c_float)
    intp = ctypes.POINTER(ctypes.c_int)
    sig = {
        "mxtpu_jpeg_backend": (ctypes.c_char_p, []),
        "mxtpu_codec_error": (ctypes.c_char_p, []),
        "mxtpu_rec_open": (ctypes.c_void_p, [ctypes.c_char_p]),
        "mxtpu_rec_count": (ctypes.c_long, [ctypes.c_void_p]),
        "mxtpu_rec_read": (ctypes.c_long, [ctypes.c_void_p, ctypes.c_long,
                                           ctypes.POINTER(u8p)]),
        "mxtpu_rec_close": (None, [ctypes.c_void_p]),
        "mxtpu_jpeg_decode": (ctypes.c_long, [u8p, ctypes.c_ulong,
                                              ctypes.c_int, u8p, intp, intp,
                                              intp]),
        "mxtpu_jpeg_encode": (ctypes.c_long, [u8p] + [ctypes.c_int] * 4
                              + [ctypes.POINTER(u8p)]),
        "mxtpu_free": (None, [ctypes.c_void_p]),
        "mxtpu_resize_bilinear": (None, [u8p] + [ctypes.c_int] * 3
                                  + [f32p, ctypes.c_int, ctypes.c_int]),
        "mxtpu_pipe_create": (ctypes.c_void_p, [ctypes.c_char_p]
                              + [ctypes.c_int] * 4
                              + [ctypes.c_uint, ctypes.c_int,
                                 ctypes.c_int]),
        "mxtpu_pipe_next_u8": (ctypes.c_long, [ctypes.c_void_p,
                                               ctypes.c_long, u8p, f32p]),
        "mxtpu_pipe_next": (ctypes.c_long, [ctypes.c_void_p, ctypes.c_long,
                                            f32p, f32p]),
        "mxtpu_pipe_reset": (None, [ctypes.c_void_p]),
        "mxtpu_pipe_destroy": (None, [ctypes.c_void_p]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def get_lib() -> ctypes.CDLL:
    """The library, built on first use and loaded once; raises
    ``RuntimeError`` (with the compiler's output) when it cannot be."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise RuntimeError(_ERROR)
        try:
            lib = ctypes.CDLL(str(_build()))
            _bind(lib)
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _ERROR = f"the native IO library is unavailable: {e}"
            raise RuntimeError(_ERROR) from e
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here (a report: no path of
    the port takes another road when it is False)."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def backend() -> str:
    """The JPEG codec the library was built with: libjpeg or nvjpeg."""
    return get_lib().mxtpu_jpeg_backend().decode()


def _codec_unavailable(lib: ctypes.CDLL) -> RuntimeError:
    """The error for a codec that cannot run in this process: nvJPEG
    with no CUDA device (a process that hides the card, as a DataLoader
    worker process does)."""
    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    return RuntimeError(
        f"the native library's JPEG codec ({lib.mxtpu_jpeg_backend().decode()}"
        f") cannot run in this process: {lib.mxtpu_codec_error().decode()} "
        f"(CUDA_VISIBLE_DEVICES={seen!r}). A DataLoader decodes such "
        f"samples on worker threads of the process that holds the card.")


_CODEC_CALLS = [0]


def codec_calls() -> int:
    """How many JPEG decodes and encodes this process has asked of the
    library (a DataLoader compares it before and after a sample to learn
    whether the sample went through the codec)."""
    return _CODEC_CALLS[0]


def _u8(arr: onp.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


class NativeRecordReader:
    """Random-access RecordIO reader over the native offset index."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.mxtpu_rec_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")

    def __len__(self) -> int:
        return int(self._lib.mxtpu_rec_count(self._h))

    def read(self, i: int) -> bytes:
        ptr = ctypes.POINTER(ctypes.c_ubyte)()
        n = self._lib.mxtpu_rec_read(self._h, i, ctypes.byref(ptr))
        if n < 0:
            raise IndexError(i)
        return ctypes.string_at(ptr, n)

    def close(self):
        if self._h:
            self._lib.mxtpu_rec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def jpeg_decode(buf: bytes, channels: int = 3) -> onp.ndarray:
    """Native JPEG decode → HWC uint8 (RGB, or luma for ``channels=1``)."""
    lib = get_lib()
    _CODEC_CALLS[0] += 1
    src = onp.frombuffer(bytes(buf), onp.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    dims = (ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    n = lib.mxtpu_jpeg_decode(_u8(src), src.size, channels, None, *dims)
    if n == -2:
        raise _codec_unavailable(lib)
    if n < 0:
        raise ValueError("JPEG decode failed")
    out = onp.empty(n, onp.uint8)
    got = lib.mxtpu_jpeg_decode(_u8(src), src.size, channels, _u8(out),
                                *dims)
    if got == -2:
        raise _codec_unavailable(lib)
    if got != n:
        raise ValueError("JPEG decode failed")
    return out.reshape(h.value, w.value, c.value)


def jpeg_encode(img, quality: int = 95) -> bytes:
    """Native JPEG encode of an HWC (or HW) uint8 image, 1 or 3
    channels, at ``quality`` (libjpeg's defaults: 4:2:0 chroma)."""
    lib = get_lib()
    _CODEC_CALLS[0] += 1
    px = onp.ascontiguousarray(img, onp.uint8)
    if px.ndim == 2:
        px = px[:, :, None]
    if px.ndim != 3 or px.shape[2] not in (1, 3):
        raise ValueError(f"JPEG encodes HWC images of 1 or 3 channels, "
                         f"not {px.shape}")
    h, w, c = px.shape
    out = ctypes.POINTER(ctypes.c_ubyte)()
    n = lib.mxtpu_jpeg_encode(_u8(px), h, w, c, int(quality),
                              ctypes.byref(out))
    if n == -2:
        raise _codec_unavailable(lib)
    if n < 0:
        raise ValueError("JPEG encode failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.mxtpu_free(out)


class NativePipeline:
    """Threaded read+decode+resize pipeline (the reference's C++
    ImageRecordIOParser2 + prefetcher, rebuilt)."""

    def __init__(self, rec_path: str, height: int, width: int,
                 channels: int = 3, shuffle: bool = False, seed: int = 0,
                 threads: int = 2, out_u8: bool = False):
        self._lib = get_lib()
        self._hwc = (height, width, channels)
        self._u8 = bool(out_u8)
        self._h = self._lib.mxtpu_pipe_create(
            rec_path.encode(), height, width, channels, int(shuffle), seed,
            threads, int(out_u8))
        if not self._h:
            raise IOError(f"cannot open {rec_path}")

    def next_batch(self, batch_size: int, data: Optional[onp.ndarray] = None):
        """Returns (data (n,h,w,c), labels (n,)) with n ≤ batch_size;
        n==0 means the epoch is exhausted. Data is float32, or uint8
        when built with ``out_u8``. ``data`` is an optional buffer of
        shape (batch_size, h, w, c) to fill (a pinned tensor's numpy
        view, say); the result is a view of it."""
        h, w, c = self._hwc
        shape = (batch_size, h, w, c)
        dtype = onp.uint8 if self._u8 else onp.float32
        if data is None:
            data = onp.empty(shape, dtype)
        elif data.shape != shape or data.dtype != dtype or \
                not data.flags.c_contiguous:
            raise ValueError(f"buffer must be C-contiguous {dtype.__name__} "
                             f"{shape}, not {data.dtype} {data.shape}")
        labels = onp.empty((batch_size,), onp.float32)
        lp = labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._u8:
            n = self._lib.mxtpu_pipe_next_u8(self._h, batch_size, _u8(data),
                                             lp)
        else:
            n = self._lib.mxtpu_pipe_next(
                self._h, batch_size,
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), lp)
        if n == -2:
            raise _codec_unavailable(self._lib)
        if n < 0:
            raise RuntimeError("pipe output-mode mismatch (out_u8 flag "
                               "does not match the create() mode)")
        return data[:n], labels[:n]

    def reset(self):
        self._lib.mxtpu_pipe_reset(self._h)

    def close(self):
        if self._h:
            self._lib.mxtpu_pipe_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
