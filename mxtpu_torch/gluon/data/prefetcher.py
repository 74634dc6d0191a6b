"""Device prefetch — the port of ``mxtpu/gluon/data/prefetcher.py``:
upload batch k+1 to the card while the step runs on batch k.

A training loop that moves each batch inline issues the copy only when
the host reaches it, after the previous step's launch. The
:class:`DevicePrefetcher` pulls from the source and copies on a
background thread, ``depth`` batches ahead: each host tensor is pinned
(a tensor the DataLoader pinned already is not copied again) and sent
with ``non_blocking`` copies on a side stream; the consumer's stream
waits for that stream before it reads the batch, so the upload
overlaps the step and the step never reads a half-copied batch. The
stream is bit-identical to the source's.

It takes plain iterables of numpy arrays, torch tensors and NDArrays,
nested in dicts, lists and tuples (a DataLoader's batches, or a
functional step's), and ``mx.io`` iterators, whose ``io.DataBatch``es
come out with their data and labels on the device and the rest as
they were.
"""
from __future__ import annotations

import queue as _queue
import threading
import time as _time
from typing import Any, Iterable, Optional

import numpy as _np
import torch

from ... import telemetry
from ...context import resolve_device
from ...io import DataBatch
from ...ndarray import NDArray

__all__ = ["DevicePrefetcher"]

_SENTINEL = object()


class DevicePrefetcher:
    """Background-thread device prefetch with a bounded buffer.

    Parameters
    ----------
    source : iterable
        Yields batches. ``reset()``/``close()`` are forwarded when the
        source has them.
    depth : int
        Batches buffered beyond the one the consumer holds (1 = classic
        double buffering: one on device computing, one in flight).
    device : optional device
        Target device (default: the card; ``"cpu"`` moves nothing).
    timeout : float
        Seconds the consumer waits for the producer before raising —
        a stuck decode surfaces as an error, never a silent hang.
    """

    def __init__(self, source, depth: int = 1,
                 device: Optional[Any] = None, timeout: float = 120.0):
        self._source = source
        self._depth = max(1, int(depth))
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        # the copies' own stream, made by the first upload
        self._stream: Optional[torch.cuda.Stream] = None
        self._timeout = timeout
        # queue + stop event are created PER producer generation and
        # passed into the thread: a producer that outlives a timed-out
        # join (stuck decode) keeps its own (already-stopped) pair and
        # can never touch a successor generation's state
        self._q: Optional[_queue.Queue] = None
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # the data-wait leg of the step-time split: time the CONSUMER
        # spends blocked on the producer (0 when prefetch is winning)
        self._m_wait = telemetry.histogram(
            "train_data_wait_ms",
            "Time the training loop blocked waiting for the next "
            "prefetched batch")

    # -- device placement -------------------------------------------------
    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        if t.device == self._device:
            return t
        if self._cuda and t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(self._device, non_blocking=self._cuda)

    def _to_device(self, obj):
        if isinstance(obj, DataBatch):
            return DataBatch(
                data=[self._to_device(d) for d in (obj.data or [])],
                label=[self._to_device(lab) for lab in (obj.label or [])],
                pad=obj.pad, index=obj.index, bucket_key=obj.bucket_key,
                provide_data=obj.provide_data,
                provide_label=obj.provide_label)
        if isinstance(obj, NDArray):
            return NDArray(self._upload(obj._data))
        if isinstance(obj, torch.Tensor):
            return self._upload(obj)
        if isinstance(obj, (_np.ndarray, _np.generic)):
            return self._upload(torch.from_numpy(
                _np.ascontiguousarray(obj)))
        if isinstance(obj, dict):
            return {k: self._to_device(v) for k, v in obj.items()}
        if isinstance(obj, tuple):
            return tuple(self._to_device(v) for v in obj)
        if isinstance(obj, list):
            return [self._to_device(v) for v in obj]
        return obj

    def _place(self, batch):
        """Upload ``batch`` (producer thread): on the card, on the side
        stream, with an event the consumer waits on."""
        if not self._cuda:
            return self._to_device(batch), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        with torch.cuda.stream(self._stream):
            out = self._to_device(batch)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    @staticmethod
    def _tensors(obj):
        if isinstance(obj, NDArray):
            yield obj._data
        elif isinstance(obj, torch.Tensor):
            yield obj
        elif isinstance(obj, dict):
            for v in obj.values():
                yield from DevicePrefetcher._tensors(v)
        elif isinstance(obj, (tuple, list)):
            for v in obj:
                yield from DevicePrefetcher._tensors(v)

    # -- producer ---------------------------------------------------------
    @staticmethod
    def _bounded_put(q, stop, item) -> bool:
        # give up when the consumer is gone so close() can't deadlock
        # against a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def _producer(self, q, stop):
        try:
            for batch in self._source:
                if stop.is_set():
                    return
                if not self._bounded_put(q, stop, self._place(batch)):
                    return
        except StopIteration:
            pass
        except Exception as e:          # surfaced on the consumer side
            self._bounded_put(q, stop, e)
        self._bounded_put(q, stop, _SENTINEL)

    def _ensure_started(self):
        if self._closed:
            raise RuntimeError("DevicePrefetcher is closed")
        if self._thread is None:
            self._stop = threading.Event()
            self._q = _queue.Queue(maxsize=self._depth)
            self._thread = threading.Thread(
                target=self._producer, args=(self._q, self._stop),
                daemon=True, name="mxtpu-torch-device-prefetch")
            self._thread.start()

    def _stop_producer(self):
        if self._stop is not None:
            self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            # drain so a blocked put() notices the stop event promptly
            try:
                while True:
                    self._q.get_nowait()
            except _queue.Empty:
                pass
            t.join(timeout=30)
        self._q = None

    # -- consumer protocol ------------------------------------------------
    def __iter__(self):
        self._ensure_started()
        return self

    def __next__(self):
        self._ensure_started()
        t0 = _time.perf_counter()
        try:
            item = self._q.get(timeout=self._timeout)
            if item is not _SENTINEL:      # epoch-end is not data wait
                self._m_wait.observe(1e3 * (_time.perf_counter() - t0))
        except _queue.Empty:
            raise RuntimeError(
                f"DevicePrefetcher: no batch from source within "
                f"{self._timeout}s (stuck decode/upload?)") from None
        if item is _SENTINEL:
            self._thread = None         # epoch done; reset() restarts
            raise StopIteration
        if isinstance(item, Exception):
            self._stop_producer()
            raise item
        batch, done = item
        if done is not None:
            # the consumer's stream reads what the side stream wrote:
            # wait for the copies, and keep their memory from being
            # reused before this stream is done with it
            main = torch.cuda.current_stream(self._device)
            main.wait_event(done)
            for t in self._tensors(batch):
                if t.device.type == "cuda":
                    t.record_stream(main)
        return batch

    next = __next__                     # the DataIter spelling

    def reset(self):
        """End the current epoch (if mid-flight), reset the source, and
        restart prefetch lazily on the next pull. The source must be
        resettable: silently resuming a plain iterator mid-stream would
        drop the in-flight buffered batches."""
        mid_flight = self._thread is not None
        self._stop_producer()
        if hasattr(self._source, "reset"):
            self._source.reset()
        elif mid_flight:
            raise RuntimeError(
                "DevicePrefetcher.reset(): source has no reset() and an "
                "epoch is mid-flight — buffered batches would be lost. "
                "Wrap a resettable iterator (a DataLoader) to use "
                "reset().")

    def close(self):
        """Stop the producer, drain the buffer, close the source."""
        if self._closed:
            return
        self._closed = True
        self._stop_producer()
        if hasattr(self._source, "close"):
            self._source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getattr__(self, name):
        # delegate metadata (provide_data/provide_label/batch_size/...)
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.__dict__["_source"], name)
