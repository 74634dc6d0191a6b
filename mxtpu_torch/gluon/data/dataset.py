"""Datasets — the port of ``mxtpu/gluon/data/dataset.py`` (reference
``python/mxnet/gluon/data/dataset.py``)."""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]

class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn) -> "Dataset":
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count) -> "_LazyTransformDataset":
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy: bool = True) -> "Dataset":
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy: bool = True) -> "Dataset":
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of equal-length arrays/lists (reference ``ArrayDataset``)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for data in args:
            assert len(data) == self._length, \
                f"all arrays must have the same length {self._length}"
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO ``.rec`` file and its ``.idx`` (reference
    ``RecordFileDataset``): item ``i`` is the raw bytes of the ``i``-th
    indexed record. (``mxtpu``'s opens ``recordio.IndexedRecordIO``,
    which its recordio module does not define; this opens
    ``MXIndexedRecordIO``.)"""

    def __init__(self, filename: str):
        from ... import recordio
        self._filename = filename
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
