"""mx.io — the DataIter protocol and the array iterators, the port of
``mxtpu/io/__init__.py`` (reference ``python/mxnet/io/io.py`` and the
C++ iterators of ``src/io/``).

``NDArrayIter`` serves in-memory arrays (its ``shuffle`` draws from
numpy's global generator, as the reference's does, so
``np.random.seed`` fixes the order in both packages); ``CSVIter``,
``MNISTIter`` and ``LibSVMIter`` (dense batches) read files into one;
``ResizeIter`` fixes an epoch's length and ``PrefetchingIter`` reads
ahead on a thread, every wait of it bounded. Batches come out on
``ctx`` (None: the card), as the reference's come out on its default
device.

The image half: ``ImageRecordIter`` routes as the reference's does, to
``NativeImageRecordIter`` (the native library's threaded read, JPEG
decode, centre crop and resize; uint8 to the card, where the batch is
made float32, normalized and laid out NCHW) when only those are asked
for and the images have 3 channels, and otherwise to ``mx.image``'s
``ImageIter`` under a ``PrefetchingIter``. Where the native route is
asked for and the library cannot be built, it raises, where the
reference falls back to the Python path.
"""
from __future__ import annotations

import gzip
import queue
import struct as _struct
import threading
from collections import namedtuple
from typing import Optional

import numpy as onp
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "ResizeIter", "PrefetchingIter", "ImageRecordIter", "MNISTIter",
           "LibSVMIter", "NativeImageRecordIter"]

# how long PrefetchingIter waits for its reader: a batch, or a stop
PREFETCH_TIMEOUT_S = 120.0


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name + shape (+ dtype/layout) of one input (reference DataDesc)."""

    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout: Optional[str]) -> int:
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One minibatch: lists of data/label arrays + padding info."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [d.shape for d in self.data or []]
        lshapes = [l.shape for l in self.label or []]
        return f"DataBatch: data shapes: {shapes} label shapes: {lshapes}"


class DataIter:
    """Base iterator (reference ``mx.io.DataIter``)."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _as_arrays(data, default_name: str):
    """Normalize array/list/dict input → list of (name, numpy array)."""
    if data is None:
        return []
    if isinstance(data, (NDArray, onp.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        out = []
        for i, d in enumerate(data):
            name = default_name if len(data) == 1 else \
                f"{default_name}_{i}"
            out.append((name, d.asnumpy() if isinstance(d, NDArray)
                        else onp.asarray(d)))
        return out
    if isinstance(data, dict):
        return [(k, v.asnumpy() if isinstance(v, NDArray)
                 else onp.asarray(v)) for k, v in sorted(data.items())]
    raise TypeError(f"cannot interpret {type(data)} as iterator data")


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference ``mx.io.NDArrayIter``):
    dict/list/array data+label, shuffle, last_batch_handle
    pad|discard|roll_over; batches on ``ctx`` (None: the card)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", ctx=None):
        super().__init__(batch_size)
        self.data = _as_arrays(data, data_name)
        self.label = _as_arrays(label, label_name)
        self.num_data = self.data[0][1].shape[0]
        if last_batch_handle == "discard":
            n = (self.num_data // batch_size) * batch_size
            self.data = [(k, v[:n]) for k, v in self.data]
            self.label = [(k, v[:n]) for k, v in self.label]
            self.num_data = n
        if self.num_data == 0:
            raise MXNetError("empty iterator")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.ctx = ctx
        self.idx = onp.arange(self.num_data)
        self.cursor = -batch_size
        self._rolled = None          # undelivered tail (roll_over mode)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        roll = self.last_batch_handle == "roll_over" and \
            0 < self.cursor < self.num_data
        if roll:
            # the undelivered tail, taken BEFORE reshuffling, so the
            # rolled batch serves exactly the held-over samples
            self._rolled = self.idx[self.cursor:].copy()
        if self.shuffle:
            onp.random.shuffle(self.idx)
        if roll:
            # this epoch's tail rolls into the next epoch's first batch
            # (the cursor goes negative; _batch_indices joins the two)
            self.cursor = -len(self._rolled) - self.batch_size
        else:
            self._rolled = None
            self.cursor = -self.batch_size

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        if self.last_batch_handle == "roll_over":
            # a rolled batch (negative cursor) is full; otherwise only
            # whole batches are served — the tail waits for the next epoch
            return self.cursor < 0 or \
                self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _batch_indices(self):
        """Index array for the current batch — the single source for
        both the data served (_take) and the reported order (getindex)."""
        lo = self.cursor
        hi = self.cursor + self.batch_size
        if lo < 0:       # roll_over: previous epoch's tail + new head
            return onp.concatenate([self._rolled, self.idx[:hi]]) \
                if hi > 0 else self._rolled
        if hi <= self.num_data:
            return self.idx[lo:hi]
        # pad: wrap around from the head
        return onp.concatenate(
            [self.idx[lo:], self.idx[:hi - self.num_data]])

    def _take(self, arrays):
        sel = self._batch_indices()
        return [nd.array(v[sel], ctx=self.ctx, dtype=v.dtype)
                for _, v in arrays]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self) -> int:
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        return self._batch_indices()


class _Wrapped(DataIter):
    """A file reader's batches: an NDArrayIter over what it read."""

    def _serve(self, data, label, batch_size, round_batch, ctx,
               data_name="data", label_name="softmax_label"):
        self._it = NDArrayIter(
            {data_name: data}, {label_name: label}, batch_size,
            last_batch_handle="pad" if round_batch else "discard", ctx=ctx)
        self.provide_data = self._it.provide_data
        self.provide_label = self._it.provide_label

    def reset(self):
        self._it.reset()

    def next(self):
        return self._it.next()


class CSVIter(_Wrapped):
    """CSV reader (reference ``src/io/iter_csv.cc``): ``data_csv`` +
    optional ``label_csv``, fixed row shapes."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 data_name="data", label_name="softmax_label", ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        data = onp.loadtxt(data_csv, delimiter=",", dtype=onp.float32,
                           ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = onp.loadtxt(label_csv, delimiter=",",
                                dtype=onp.float32, ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = onp.zeros((data.shape[0],), onp.float32)
        self._serve(data, label, batch_size, round_batch, ctx, data_name,
                    label_name)


class ResizeIter(DataIter):
    """Truncate/extend an iterator to a fixed number of batches
    (reference ``mx.io.ResizeIter``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


class PrefetchingIter(DataIter):
    """Background-thread prefetch (reference ``mx.io.PrefetchingIter`` /
    dmlc::ThreadedIter): reads batch k+1 while the card runs batch k.
    Every wait is bounded: ``next`` waits ``PREFETCH_TIMEOUT_S`` seconds
    for the reader, and ``reset``/``close`` wait as long for it to
    stop."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch: int = 2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise NotImplementedError(
                "PrefetchingIter wraps one iterator")
        self._it = iters[0]
        super().__init__(self._it.batch_size)
        self.provide_data = self._it.provide_data
        self.provide_label = self._it.provide_label
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread = None
        self._stop = threading.Event()
        self._done = False
        self._start()

    def _start(self):
        self._stop.clear()
        stop, q = self._stop, self._queue

        def worker():
            while not stop.is_set():
                try:
                    item = self._it.next()
                except StopIteration:
                    item = None
                except Exception as e:        # surface errors to consumer
                    item = e
                # an abortable put: reset()/close() can join even when
                # the consumer stopped draining
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if item is None or isinstance(item, Exception):
                    return

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="mxtpu-io-prefetch")
        self._thread.start()

    def _halt(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            # the reader checks _stop between batches: this waits for the
            # batch it is reading
            self._thread.join(timeout=PREFETCH_TIMEOUT_S)
            if self._thread.is_alive():
                raise RuntimeError(
                    "prefetch worker failed to stop (inner iterator "
                    "hung?) — not restarting over a live worker")
            self._thread = None

    def reset(self):
        self._halt()
        self._it.reset()
        self._queue = queue.Queue(maxsize=self._queue.maxsize)
        self._stop = threading.Event()
        self._done = False
        self._start()

    def close(self):
        """Stop the prefetch thread (joined, not left to die at exit) and
        close the inner iterator."""
        self._halt()
        self._done = True      # next() must raise, not block
        if hasattr(self._it, "close"):
            self._it.close()

    def next(self):
        if self._done:
            # keep raising after exhaustion (DataIter contract)
            raise StopIteration
        try:
            item = self._queue.get(timeout=PREFETCH_TIMEOUT_S)
        except queue.Empty:
            raise RuntimeError(
                f"PrefetchingIter: no batch from the reader in "
                f"{PREFETCH_TIMEOUT_S} s") from None
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        return item

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def ImageRecordIter(path_imgrec=None, data_shape=None, batch_size=1,
                    shuffle=False, preprocess_threads=2, prefetch_buffer=2,
                    ctx=None, **kwargs) -> DataIter:
    """RecordIO image pipeline (reference C++ ``ImageRecordIter``,
    ``src/io/iter_image_recordio_2.cc``); batches on ``ctx`` (None: the
    card).

    Accepts the reference's flag names (mean_r/g/b, std_r/g/b,
    rand_mirror, rand_crop, ...). When only decode/resize/normalize are
    asked for and the images have 3 channels, the native threaded
    pipeline serves the batches (and raises if the native library
    cannot be built); augmentation flags route through ``ImageIter``
    under a ``PrefetchingIter``."""
    mean = None
    if any(f"mean_{c}" in kwargs for c in "rgb"):
        mean = [kwargs.pop("mean_r", 0.0), kwargs.pop("mean_g", 0.0),
                kwargs.pop("mean_b", 0.0)]
    std = None
    if any(f"std_{c}" in kwargs for c in "rgb"):
        std = [kwargs.pop("std_r", 1.0), kwargs.pop("std_g", 1.0),
               kwargs.pop("std_b", 1.0)]
    # route natively only when EVERY remaining kwarg is semantics the
    # C++ pipeline implements (decode + center-crop + resize + mean/std);
    # anything else (label_width, hue, inter_method, augmenters, ...)
    # goes through the Python ImageIter
    native_ok_keys = {"seed", "data_name", "label_name"}
    device_pipeline = kwargs.pop("device_pipeline", True)
    blocking = {k for k, v in kwargs.items()
                if k not in native_ok_keys and v}
    if not blocking and data_shape and data_shape[0] == 3:
        return NativeImageRecordIter(
            path_imgrec=path_imgrec, data_shape=data_shape,
            batch_size=batch_size, shuffle=shuffle,
            preprocess_threads=preprocess_threads, mean=mean, std=std,
            seed=int(kwargs.get("seed", 0)),
            device_pipeline=device_pipeline, ctx=ctx)
    from ..image import ImageIter
    inner = ImageIter(batch_size, data_shape, path_imgrec=path_imgrec,
                      shuffle=shuffle, mean=mean, std=std, ctx=ctx,
                      **kwargs)
    return PrefetchingIter(inner, prefetch=prefetch_buffer)


def normalize_u8(x: torch.Tensor, mean: Optional[torch.Tensor],
                 std: Optional[torch.Tensor]) -> torch.Tensor:
    """uint8 NHWC → float32, minus ``mean``, over ``std``, NCHW: the
    counterpart of the reference's jitted ``post``, in its order, on
    whatever device ``x`` is (the card's result is bit-equal to the
    host's)."""
    y = x.to(torch.float32)
    if mean is not None:
        y = y - mean
    if std is not None:
        y = y / std
    return y.permute(0, 3, 1, 2).contiguous()


class NativeImageRecordIter(DataIter):
    """C++ decode pipeline (the native library): threaded RecordIO read
    + JPEG decode + centre crop + bilinear resize off the Python thread
    — the native counterpart of ImageRecordIter.

    With ``device_pipeline=True`` the host does only the irregular work
    (read, decode, crop/resize) and hands over rounded uint8 HWC, a
    quarter of the float bytes: the batch and its labels are written
    into one of two pinned host buffer pairs, copied to ``ctx`` (None:
    the card) on the iterator's own stream, and the batch converted to
    float32, normalized and laid out NCHW there (:func:`normalize_u8`);
    the consumer's stream waits for it. ``pinned=False`` copies new
    pageable buffers on the consumer's stream instead (the plain
    hand-over, which ``tools.input_ab`` measures against this one).
    ``device_pipeline=False`` keeps the all-host float32 path (the C++
    pipeline emits f32 and numpy normalizes and transposes)."""

    def __init__(self, path_imgrec, data_shape, batch_size=1,
                 shuffle=False, seed=0, preprocess_threads=2,
                 mean=None, std=None, data_name="data",
                 label_name="softmax_label", device_pipeline=True,
                 ctx=None, pinned=True, **kwargs):
        from ..context import resolve_device
        from ..native import NativePipeline
        super().__init__(batch_size)
        c, h, w = data_shape
        self._device = bool(device_pipeline)
        self._ctx = resolve_device(ctx)
        self._pipe = NativePipeline(path_imgrec, h, w, c, shuffle, seed,
                                    preprocess_threads,
                                    out_u8=self._device)
        self._shape = (c, h, w)
        self._mean = onp.asarray(mean, onp.float32) if mean is not None \
            else None
        self._std = onp.asarray(std, onp.float32) if std is not None \
            else None
        self._consts = [None if v is None else
                        torch.from_numpy(v).to(self._ctx)
                        for v in (self._mean, self._std)]
        cuda = self._ctx.type == "cuda"
        self._stream = torch.cuda.Stream(self._ctx) if cuda and \
            self._device and pinned else None
        self._bufs = []   # two pinned (images, labels) pairs, at first use
        self._copied = [None, None]   # the event of each pair's last copy
        self._turn = 0
        self.provide_data = [DataDesc(data_name, (batch_size,) + self._shape)]
        self.provide_label = [DataDesc(label_name, (batch_size,))]

    def reset(self):
        self._pipe.reset()

    def _host_buffers(self):
        """(images, labels, slot): uint8 NHWC and float32 buffers for a
        batch — on the way to the card one of two pinned pairs (slot 0
        or 1), waited for until its last copy is done; else new ones."""
        c, h, w = self._shape
        shapes = ((self.batch_size, h, w, c), (self.batch_size,))
        dtypes = (torch.uint8, torch.float32)
        if self._stream is None:
            return (*(torch.empty(sh, dtype=dt)
                      for sh, dt in zip(shapes, dtypes)), None)
        if not self._bufs:
            self._bufs = [[torch.empty(sh, dtype=dt, pin_memory=True)
                           for sh, dt in zip(shapes, dtypes)]
                          for _ in range(2)]
        i, self._turn = self._turn, self._turn ^ 1
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        return (*self._bufs[i], i)

    def _to_card(self, images, labels, i):
        """Copy and normalize on the iterator's stream (a pageable copy
        on the consumer's stream would wait for the step it is
        running); the consumer's stream waits for the result."""
        main = torch.cuda.current_stream(self._ctx)
        with torch.cuda.stream(self._stream):
            x = images.to(self._ctx, non_blocking=True)
            y = labels.to(self._ctx, non_blocking=True)
            self._copied[i] = torch.cuda.Event()
            self._copied[i].record(self._stream)
            out = normalize_u8(x, *self._consts)
            done = torch.cuda.Event()
            done.record(self._stream)
        main.wait_event(done)
        out.record_stream(main)
        y.record_stream(main)
        return out, y

    def next(self):
        if not self._device:
            return self._next_host()
        images, labels, slot = self._host_buffers()
        data, lab = self._pipe.next_batch(self.batch_size, images.numpy())
        n = len(data)
        if n == 0:
            raise StopIteration
        images[n:] = 0
        labels.zero_()
        labels[:n] = torch.from_numpy(lab)
        if slot is None:
            out = normalize_u8(images.to(self._ctx), *self._consts)
            y = labels.to(self._ctx)
        else:
            out, y = self._to_card(images, labels, slot)
        return DataBatch(data=[NDArray(out)], label=[NDArray(y)],
                         pad=self.batch_size - n)

    def _next_host(self):
        """The all-host float32 path."""
        data, labels = self._pipe.next_batch(self.batch_size)
        n = len(data)
        if n == 0:
            raise StopIteration
        pad = self.batch_size - n
        if pad:
            labels = onp.concatenate([labels, onp.zeros(pad, onp.float32)])
            data = onp.concatenate(
                [data, onp.zeros((pad,) + data.shape[1:], data.dtype)])
        if self._mean is not None:
            data = data - self._mean
        if self._std is not None:
            data = data / self._std
        data = onp.ascontiguousarray(data.transpose(0, 3, 1, 2))
        return DataBatch(data=[nd.array(data, ctx=self._ctx)],
                         label=[nd.array(labels, ctx=self._ctx)], pad=pad)

    def close(self):
        self._pipe.close()


def MNISTIter(image=None, label=None, batch_size=1, shuffle=False,
              flat=False, ctx=None, **kwargs) -> DataIter:
    """MNIST idx-format reader (reference ``src/io/iter_mnist.cc``)."""
    def read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic = _struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = _struct.unpack(f">{ndim}I", f.read(4 * ndim))
            return onp.frombuffer(f.read(), onp.uint8).reshape(dims)

    images = read_idx(image).astype(onp.float32) / 255.0
    labels = read_idx(label).astype(onp.float32)
    images = images.reshape(len(images), -1) if flat else \
        images[:, None, :, :]
    return NDArrayIter(images, labels, batch_size, shuffle=shuffle, ctx=ctx)


class LibSVMIter(_Wrapped):
    """LibSVM text reader (reference ``src/io/iter_libsvm.cc``) with
    dense batches (the sparse path comes with the sparse slice)."""

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 label_shape=None, round_batch=True, ctx=None, **kwargs):
        super().__init__(batch_size)
        num_features = int(onp.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = onp.zeros(num_features, onp.float32)
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    row[int(k)] = float(v)
                rows.append(row)
        data = onp.stack(rows).reshape((-1,) + tuple(data_shape))
        self._serve(data, onp.asarray(labels, onp.float32), batch_size,
                    round_batch, ctx)
