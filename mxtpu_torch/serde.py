"""Binary (de)serialization of NDArray containers — the ``.params`` format.

The port of ``mxtpu/serde.py`` on torch tensors: MXNet 1.x's dense
layout, byte for byte the file the reference writes for the same
arrays, so weight files pass between the two packages:

    uint64 kMXAPINDArrayListMagic (0x112), uint64 reserved
    vector<NDArray>:  uint64 count, then per array:
        uint32 NDARRAY_V2_MAGIC (0xF993FAC9)
        int32  storage_type (0 == dense)
        TShape: uint32 ndim, uint32 dims[ndim]
        Context: int32 dev_type (1=cpu), int32 dev_id
        int32  type_flag (mshadow enum)
        raw data bytes
    vector<string> names: uint64 count, (uint64 len, bytes) each

A dtype without an mshadow flag here (int16) is written as float32, as
the reference writes it. bfloat16 (flag 12) is written from and read
into a bfloat16 tensor's raw bytes (numpy has no bfloat16). ``load``
makes every float entry float32 (float64, float16 and bfloat16 too),
as the reference's does by building each array with ``nd.array``;
integer and bool entries keep their dtype. Sparse arrays
(``mxtpu_torch.ndarray.sparse``) are written in the reference's own
sparse layout, storage type 1001 (row_sparse) or 1002 (csr):

    uint32 magic, int32 storage_type, TShape, Context, int32 type_flag,
    uint32 n_aux, per aux (row_sparse: indices; csr: indptr, indices):
        uint32 length, int32 values
    uint32 n_data (stored rows or values), raw data bytes

and read back as sparse arrays, their data in its own dtype. MXNet
1.x's sparse entries (storage types 1, 2) raise, as the reference's do.
"""
from __future__ import annotations

import math
import struct

import numpy as _np
import torch

from .base import MXNetError, numeric_types
from .context import DeviceLike, resolve_device

__all__ = ["save_ndarrays", "load_ndarrays"]

_LIST_MAGIC = 0x112
_ND_MAGIC = 0xF993FAC9

# mshadow type flags (3rdparty/mshadow/mshadow/base.h)
_TYPE_FLAG = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
              torch.uint8: 3, torch.int32: 4, torch.int8: 5, torch.int64: 6,
              torch.bool: 7, torch.bfloat16: 12}
_FLAG_TYPE = {v: k for k, v in _TYPE_FLAG.items()}

def _tensor_of(arr) -> torch.Tensor:
    """A host tensor of what ``save`` was given: an NDArray, a tensor, a
    numpy array or a number."""
    from .ndarray.ndarray import NDArray
    if isinstance(arr, NDArray):
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu()
    if isinstance(arr, (_np.ndarray, _np.generic) + numeric_types):
        return torch.from_numpy(_np.array(arr))
    raise TypeError(f"cannot save {type(arr)}")


def _raw_bytes(t: torch.Tensor) -> memoryview:
    t = t.contiguous().reshape(-1)
    if t.dtype in (torch.bfloat16, torch.bool):
        t = t.view(torch.uint8)
    return memoryview(t.numpy()).cast("B")


def _write_sparse(f, arr) -> None:
    """A sparse entry in the reference's layout (see the module doc)."""
    from .ndarray.sparse import RowSparseNDArray
    rsp = isinstance(arr, RowSparseNDArray)
    shape = arr.shape
    data = arr.data._data.detach().cpu()
    if data.dtype not in _TYPE_FLAG:
        data = data.to(torch.float32)
    auxes = [arr.indices] if rsp else [arr.indptr, arr.indices]
    f.write(struct.pack(f"<Ii{len(shape) + 1}Iiii", _ND_MAGIC,
                        1001 if rsp else 1002, len(shape), *shape, 1, 0,
                        _TYPE_FLAG[data.dtype]))
    f.write(struct.pack("<I", len(auxes)))
    for aux in auxes:
        a = aux._data.detach().cpu().to(torch.int32)
        f.write(struct.pack("<I", a.shape[0]))
        f.write(_raw_bytes(a))
    f.write(struct.pack("<I", data.shape[0]))
    f.write(_raw_bytes(data))


def _write_ndarray(f, t: torch.Tensor) -> None:
    if t.dtype not in _TYPE_FLAG:
        t = t.to(torch.float32)
    f.write(struct.pack(f"<IiI{t.ndim}Iiii", _ND_MAGIC, 0, t.ndim,
                        *t.shape, 1, 0, _TYPE_FLAG[t.dtype]))
    f.write(_raw_bytes(t))   # storage 0 (dense), ctx (cpu, 0), flag, data


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def read(self, fmt: str):
        at = self.skip(struct.calcsize("<" + fmt))
        vals = struct.unpack_from("<" + fmt, self.buf, at)
        return vals if len(vals) > 1 else vals[0]

    def skip(self, n: int) -> int:
        """Step over ``n`` bytes; where they start."""
        if self.pos + n > len(self.buf):
            raise MXNetError(f"truncated .params file: {n} bytes wanted at "
                             f"{self.pos}, {len(self.buf)} in all")
        self.pos += n
        return self.pos - n

    def read_bytes(self, n: int) -> bytes:
        return bytes(self.buf[self.skip(n):self.pos])


def _read_ndarray(r: _Reader, dev: torch.device) -> torch.Tensor:
    magic = r.read("I")
    if magic != _ND_MAGIC:
        raise MXNetError(f"bad NDArray magic {magic:#x} (legacy v0/v1 "
                         "formats not supported)")
    stype = r.read("i")
    # 0 == kDefaultStorage; -1 (kUndefinedStorage) was written by early
    # versions of the reference's codec
    if stype in (1, 2):
        raise MXNetError(
            "reference MXNet sparse .params entries (row_sparse/csr with "
            "the 1.x aux layout) are not supported; convert to dense or "
            "re-save with mxtpu")
    if stype in (1001, 1002):
        return _read_sparse(r, stype, dev)
    if stype not in (0, -1):
        raise MXNetError(f"unknown storage type {stype} in .params")
    ndim = r.read("I")
    shape = tuple(_np.frombuffer(r.read_bytes(4 * ndim), "<u4").tolist())
    r.read("ii")  # ctx
    flag = r.read("i")
    if flag not in _FLAG_TYPE:
        raise MXNetError(f"unknown type flag {flag} in .params")
    dtype = _FLAG_TYPE[flag]
    nbytes = math.prod(shape) * dtype.itemsize
    start = r.skip(nbytes)
    raw = torch.frombuffer(r.buf, dtype=torch.uint8, count=nbytes,
                           offset=start) if nbytes else \
        torch.empty(0, dtype=torch.uint8)
    # a copy on dev, aligned for its dtype (the file packs 4-byte fields)
    t = raw.to(dev, copy=True).view(dtype).reshape(shape)
    return t.float() if t.is_floating_point() else t   # as nd.array does


def _read_block(r: _Reader, n: int, dtype: torch.dtype,
                dev: torch.device) -> torch.Tensor:
    nbytes = n * dtype.itemsize
    start = r.skip(nbytes)
    raw = torch.frombuffer(r.buf, dtype=torch.uint8, count=nbytes,
                           offset=start) if nbytes else \
        torch.empty(0, dtype=torch.uint8)
    return raw.to(dev, copy=True).view(dtype)


def _read_sparse(r: _Reader, stype: int, dev: torch.device):
    from .ndarray.ndarray import NDArray
    from .ndarray.sparse import CSRNDArray, RowSparseNDArray
    ndim = r.read("I")
    shape = tuple(_np.frombuffer(r.read_bytes(4 * ndim), "<u4").tolist())
    r.read("ii")  # ctx
    flag = r.read("i")
    if flag not in _FLAG_TYPE:
        raise MXNetError(f"unknown type flag {flag} in .params")
    dtype = _FLAG_TYPE[flag]
    auxes = [NDArray(_read_block(r, r.read("I"), torch.int32, dev))
             for _ in range(r.read("I"))]
    n_data = r.read("I")
    row = tuple(shape[1:]) if stype == 1001 else ()
    data = _read_block(r, n_data * math.prod(row), dtype, dev)
    data = NDArray(data.reshape((n_data,) + row))
    if stype == 1001:
        return RowSparseNDArray(data, auxes[0], shape)
    return CSRNDArray(data, auxes[1], auxes[0], shape)


def save_ndarrays(fname: str, data) -> None:
    """``mx.nd.save``: data is an NDArray, a list of them, or a dict of
    name to NDArray."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        arrays, names = list(data), []
    else:
        arrays, names = [data], []
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
        from .ndarray.sparse import BaseSparseNDArray
        for a in arrays:
            if isinstance(a, BaseSparseNDArray):
                _write_sparse(f, a)
            else:
                _write_ndarray(f, _tensor_of(a))
        f.write(struct.pack("<Q", len(names)))
        for nm in names:
            b = nm.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load_ndarrays(fname: str, ctx: DeviceLike = None):
    """``mx.nd.load``: a list of NDArrays, or a dict when the file names
    them, on ``ctx`` (None: the card); float entries come back
    float32."""
    from .ndarray.ndarray import NDArray
    dev = resolve_device(ctx)
    with open(fname, "rb") as f:
        r = _Reader(bytearray(f.read()))
    if len(r.buf) < 16:
        raise MXNetError(f"invalid .params file ({len(r.buf)} bytes)")
    magic, _ = r.read("QQ")
    if magic != _LIST_MAGIC:
        raise MXNetError(f"invalid .params file (magic {magic:#x})")
    n = r.read("Q")
    arrays = [_read_ndarray(r, dev) for _ in range(n)]
    arrays = [a if isinstance(a, NDArray) else NDArray(a) for a in arrays]
    n_names = r.read("Q")
    if n_names == 0:
        return arrays
    names = []
    for _ in range(n_names):
        ln = r.read("Q")
        names.append(r.read_bytes(ln).decode("utf-8"))
    return dict(zip(names, arrays))
