"""Sparse NDArrays — the port of ``mxtpu/ndarray/sparse.py`` (reference
``python/mxnet/ndarray/sparse.py``): ``CSRNDArray`` and
``RowSparseNDArray``.

Storage is a set of component NDArrays on the array's device (``data``,
``indices`` and, for CSR, ``indptr``; the index arrays int32, as the
reference keeps them). The dense form is materialized only when
something asks for it (``_data``: an inherited dense op, ``asnumpy``,
``tostype('default')``), and is rebuilt when a component was written
since. The sparse paths never ask for it: ``dot`` of a CSR with a dense
array is a gather plus a segment sum over the stored entries, ``add``
of two row-sparse arrays sums their rows by index, and ``retain``
selects rows, all on the device.

Where the port differs from the reference, deliberately:

- ``dot(csr, dense, transpose_a=True)`` with a 2-D ``dense`` returns a
  ``RowSparseNDArray`` over the columns the CSR stores (MXNet 1.x's
  storage for csrᵀ·dense, the gradient of a sparse embedding); the
  reference returns its dense form, which at a real vocabulary does not
  fit (128,256 × 4,096 float32 is 2.1 GB). Its values are the
  reference's.
- ``NDArray.tostype('csr' | 'row_sparse')`` and ``cast_storage`` from a
  dense array work, on the device (the reference's dense ``tostype``
  raises).
- Segment sums accumulate with ``index_add_``, whose order of addition
  is not fixed on the card (atomics).
- Constructors take ``ctx``; None is the card, as everywhere in the
  port. A float64 numpy input becomes float32 unless ``dtype`` says
  otherwise, as ``mx.nd.array`` does.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, dtype_torch
from ..context import resolve_device
from .ndarray import NDArray, _same_device

__all__ = ["CSRNDArray", "RowSparseNDArray", "csr_matrix",
           "row_sparse_array", "BaseSparseNDArray", "retain", "dot",
           "add", "zeros"]


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    """A component: an NDArray's or a tensor's data, or a numpy value,
    on ``dev``."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        t = x.to(dev)
    else:
        a = _np.asarray(x)
        if dtype is None and a.dtype == _np.float64:
            dtype = torch.float32
        t = torch.as_tensor(_np.ascontiguousarray(a), device=dev)
    return t if dtype is None else t.to(dtype)


def _index(x, dev) -> NDArray:
    return x if isinstance(x, NDArray) else NDArray(
        _tensor(x, dev, torch.int32))


def _value(x, dev) -> NDArray:
    return x if isinstance(x, NDArray) else NDArray(_tensor(x, dev))


class BaseSparseNDArray(NDArray):
    """Common sparse behaviour; ``_data`` is the dense form, built on
    demand; the storage is the component arrays."""

    _COMPONENTS = ("data", "indices", "indptr")

    def __init__(self, shape):
        super().__init__(None)
        self._dense_cache = None
        self._cache_versions = None
        self._shape = tuple(int(s) for s in shape)

    def __setattr__(self, name, value):
        # a rebound component invalidates the dense form
        if name in BaseSparseNDArray._COMPONENTS:
            object.__setattr__(self, "_dense_cache", None)
        object.__setattr__(self, name, value)

    def _component_versions(self):
        return tuple(getattr(self, n)._version
                     for n in self._COMPONENTS if hasattr(self, n))

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        return int(_np.prod(self._shape))

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dtype(self):
        return self.data._data.dtype

    @property
    def context(self):
        return self.data._data.device

    ctx = context

    @property
    def _data(self):
        vers = self._component_versions()
        if self._dense_cache is None or vers != self._cache_versions:
            self._dense_cache = self._to_dense_raw()
            self._cache_versions = vers
        return self._dense_cache

    @_data.setter
    def _data(self, v):
        # NDArray.__init__ assigns None; a sparse array takes no dense data
        if v is not None:
            raise MXNetError("cannot assign dense data to a sparse array")

    def _to_dense_raw(self) -> torch.Tensor:
        raise NotImplementedError

    def tostype(self, stype: str):
        if stype == "default":
            return NDArray(self._to_dense_raw())
        if stype == self.stype:
            return self
        if stype == "row_sparse" and self.stype == "csr":
            return RowSparseNDArray.from_dense(self._to_dense_raw())
        if stype == "csr" and self.stype == "row_sparse":
            return CSRNDArray.from_dense(self._to_dense_raw())
        raise ValueError(f"cannot convert {self.stype} to {stype}")

    def asnumpy(self):
        return NDArray(self._to_dense_raw()).asnumpy()

    def wait_to_read(self):
        self.data.wait_to_read()

    def __repr__(self):
        return (f"<{type(self).__name__} {self.shape} "
                f"nnz-storage={self._storage_rows()} @{self.context}>")

    def _storage_rows(self) -> int:
        raise NotImplementedError


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (reference ``CSRNDArray``)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        super().__init__(shape)
        dev = data._data.device if isinstance(data, NDArray) else \
            resolve_device(ctx)
        self.data = _value(data, dev)
        self.indices = _index(indices, dev)
        self.indptr = _index(indptr, dev)

    @classmethod
    def from_dense(cls, dense: torch.Tensor) -> "CSRNDArray":
        if dense.ndim != 2:
            raise ValueError("csr requires a 2-D array")
        m = dense.detach().to_sparse_csr()
        return cls(NDArray(m.values()),
                   NDArray(m.col_indices().to(torch.int32)),
                   NDArray(m.crow_indices().to(torch.int32)),
                   tuple(dense.shape))

    def _row_ids(self) -> torch.Tensor:
        """The row of every stored entry (int64), from ``indptr``."""
        indptr = self.indptr._data
        nnz = self.data._data.shape[0]
        pos = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
        return torch.searchsorted(indptr, pos, right=True) - 1

    def _to_dense_raw(self) -> torch.Tensor:
        data = self.data._data
        out = torch.zeros(self.shape, dtype=data.dtype, device=data.device)
        return out.index_put_((self._row_ids(),
                               self.indices._data.to(torch.int64)), data,
                              accumulate=True)

    def _storage_rows(self) -> int:
        return int(self.data._data.shape[0])

    def asscipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix(
            (self.data.asnumpy(), self.indices.asnumpy(),
             self.indptr.asnumpy()), shape=self.shape)

    def astype(self, dtype, copy=True):
        return CSRNDArray(self.data.astype(dtype), self.indices,
                          self.indptr, self.shape)

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        if _same_device(self.context, dev):
            return self
        return CSRNDArray(*(NDArray(getattr(self, n)._data.to(dev))
                            for n in ("data", "indices", "indptr")),
                          self.shape)

    as_in_ctx = as_in_context

    def __getitem__(self, key):
        if isinstance(key, slice):
            if key.step is not None:
                raise ValueError("csr slicing supports contiguous rows")
            start, stop, _ = key.indices(self.shape[0])
            indptr = self.indptr._data
            lo, hi = int(indptr[start]), int(indptr[stop])
            return CSRNDArray(
                NDArray(self.data._data[lo:hi]),
                NDArray(self.indices._data[lo:hi]),
                NDArray(indptr[start:stop + 1] - indptr[start]),
                (stop - start, self.shape[1]))
        if isinstance(key, int):
            n = self.shape[0]
            if not -n <= key < n:
                raise IndexError(f"index {key} out of range for {n} rows")
            key = key % n
            return self[key:key + 1]
        raise TypeError(f"csr indexing with {type(key)} unsupported")


class RowSparseNDArray(BaseSparseNDArray):
    """First-dim-sparse tensor (reference ``RowSparseNDArray``): the rows
    present (``indices``) and their dense values (``data``)."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None):
        super().__init__(shape)
        dev = data._data.device if isinstance(data, NDArray) else \
            resolve_device(ctx)
        self.data = _value(data, dev)
        self.indices = _index(indices, dev)

    @classmethod
    def from_dense(cls, dense: torch.Tensor) -> "RowSparseNDArray":
        d = dense.detach()
        present = torch.nonzero(
            torch.any(d.reshape(d.shape[0], -1) != 0, dim=1))[:, 0]
        return cls(NDArray(d[present]), NDArray(present.to(torch.int32)),
                   tuple(d.shape))

    def _to_dense_raw(self) -> torch.Tensor:
        data = self.data._data
        out = torch.zeros(self.shape, dtype=data.dtype, device=data.device)
        return out.index_put_((self.indices._data.to(torch.int64),), data)

    def _storage_rows(self) -> int:
        return int(self.indices._data.shape[0])

    def astype(self, dtype, copy=True):
        return RowSparseNDArray(self.data.astype(dtype), self.indices,
                                self.shape)

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        if _same_device(self.context, dev):
            return self
        return RowSparseNDArray(NDArray(self.data._data.to(dev)),
                                NDArray(self.indices._data.to(dev)),
                                self.shape)

    as_in_ctx = as_in_context

    def retain(self, row_ids) -> "RowSparseNDArray":
        return retain(self, row_ids)


# ---------------------------------------------------------------------------
# constructors (reference mx.nd.sparse.csr_matrix / row_sparse_array)
# ---------------------------------------------------------------------------
def _dense_of(arg1, ctx, dtype) -> torch.Tensor:
    if isinstance(arg1, NDArray):
        return arg1._data if dtype is None else \
            arg1._data.to(dtype_torch(dtype))
    return _tensor(arg1, resolve_device(ctx),
                   dtype_torch(dtype) if dtype else None)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """A CSR matrix from ``(data, indices, indptr)`` with ``shape``, a
    scipy sparse matrix, or a dense array (an NDArray stays on its
    device; other inputs go to ``ctx``)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise ValueError("shape is required with (data, indices, "
                             "indptr)")
        dev = resolve_device(ctx)
        return CSRNDArray(
            NDArray(_tensor(data, dev, dtype_torch(dtype) if dtype
                            else None)), indices, indptr, shape, ctx=dev)
    try:
        import scipy.sparse as sp
    except ImportError:
        sp = None
    if sp is not None and sp.issparse(arg1):
        m = arg1.tocsr()
        m.sort_indices()
        return csr_matrix((m.data, m.indices, m.indptr), shape=m.shape,
                          ctx=ctx, dtype=dtype)
    return CSRNDArray.from_dense(_dense_of(arg1, ctx, dtype))


def row_sparse_array(arg1, shape=None, ctx=None,
                     dtype=None) -> RowSparseNDArray:
    """A row-sparse array from ``(data, indices)`` with ``shape`` or from
    a dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise ValueError("shape is required with (data, indices)")
        dev = resolve_device(ctx)
        return RowSparseNDArray(
            NDArray(_tensor(data, dev, dtype_torch(dtype) if dtype
                            else None)), indices, shape, ctx=dev)
    return RowSparseNDArray.from_dense(_dense_of(arg1, ctx, dtype))


def zeros(stype: str, shape, ctx=None, dtype=None):
    dev = resolve_device(ctx)
    dt = dtype_torch(dtype)
    if stype == "csr":
        return CSRNDArray(
            NDArray(torch.zeros((0,), dtype=dt, device=dev)),
            NDArray(torch.zeros((0,), dtype=torch.int32, device=dev)),
            NDArray(torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                device=dev)), shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            NDArray(torch.zeros((0,) + tuple(shape[1:]), dtype=dt,
                                device=dev)),
            NDArray(torch.zeros((0,), dtype=torch.int32, device=dev)), shape)
    from .ndarray import zeros as dzeros
    return dzeros(shape, ctx, dtype)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
def _csr_dot(lhs: CSRNDArray, rhs: NDArray, transpose_a, transpose_b):
    """csr · dense (or csrᵀ · dense): one gather of the dense rows the
    stored entries need, scaled by them and summed per output row."""
    from .ndarray import apply_op
    data = lhs.data._data
    cols = lhs.indices._data.to(torch.int64)
    row_ids = lhs._row_ids()
    n_rows, n_cols = lhs.shape

    if transpose_a and rhs.ndim == 2:
        # out rows: the distinct stored columns (one host read: their count)
        uniq, inv = torch.unique(cols, sorted=True, return_inverse=True)

        def _rsp(dense):
            d = dense.T if transpose_b else dense
            contrib = data[:, None] * d[row_ids]
            out = torch.zeros((uniq.shape[0], d.shape[1]),
                              dtype=contrib.dtype, device=contrib.device)
            return out.index_add_(0, inv, contrib)
        vals = apply_op(_rsp, [rhs], "sparse_dot")
        return RowSparseNDArray(vals, NDArray(uniq.to(torch.int32)),
                                (n_cols, vals.shape[1]))

    def _f(dense):
        vec = dense.ndim == 1
        d = dense[:, None] if vec else (dense.T if transpose_b else dense)
        if transpose_a:
            contrib = data[:, None] * d[row_ids]
            seg, n_out = cols, n_cols
        else:
            contrib = data[:, None] * d[cols]
            seg, n_out = row_ids, n_rows
        out = torch.zeros((n_out, d.shape[1]), dtype=contrib.dtype,
                          device=contrib.device)
        out = out.index_add_(0, seg, contrib)
        return out[:, 0] if vec else out
    return apply_op(_f, [rhs], "sparse_dot")


def dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """Sparse-aware dot (reference sparse ``dot``): csr × dense and
    csrᵀ × dense without the dense csr; other storage combinations
    through dense, as in the reference."""
    from . import ops
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray) and \
            not isinstance(rhs, BaseSparseNDArray):
        return _csr_dot(lhs, rhs, transpose_a, transpose_b)
    l = NDArray(lhs._data) if isinstance(lhs, BaseSparseNDArray) else lhs
    r = NDArray(rhs._data) if isinstance(rhs, BaseSparseNDArray) else rhs
    return ops.dot(l, r, transpose_a=transpose_a, transpose_b=transpose_b)


def add(lhs, rhs):
    """Sparse add: row_sparse + row_sparse stays row_sparse (rows summed
    by index, sorted); anything else goes through dense (the
    reference's storage fallback)."""
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        if lhs.shape != rhs.shape:
            raise ValueError("shape mismatch")
        idx = torch.cat([lhs.indices._data, rhs.indices._data])
        dat = torch.cat([lhs.data._data, rhs.data._data])
        uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
        summed = torch.zeros((uniq.shape[0],) + tuple(dat.shape[1:]),
                             dtype=dat.dtype, device=dat.device)
        summed.index_add_(0, inv, dat)
        return RowSparseNDArray(NDArray(summed), NDArray(uniq.to(
            torch.int32)), lhs.shape)
    l = NDArray(lhs._data) if isinstance(lhs, BaseSparseNDArray) else lhs
    r = NDArray(rhs._data) if isinstance(rhs, BaseSparseNDArray) else rhs
    return l + r


def retain(rsp: RowSparseNDArray, row_ids) -> RowSparseNDArray:
    """Keep only the requested rows, in stored order (reference
    ``sparse.retain``, the row_sparse_pull primitive), on the device."""
    stored = rsp.indices._data
    ids = row_ids._data if isinstance(row_ids, NDArray) else \
        torch.as_tensor(_np.asarray(row_ids), device=stored.device)
    keep = torch.isin(stored, ids.to(stored.device, stored.dtype))
    return RowSparseNDArray(NDArray(rsp.data._data[keep]),
                            NDArray(stored[keep]), rsp.shape)
