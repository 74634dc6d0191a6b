"""DataLoader — the port of ``mxtpu/gluon/data/dataloader.py``
(reference ``python/mxnet/gluon/data/dataloader.py``).

Batches come out on the card (``context.default_device()``), as the
reference's come out on its default device, or on ``ctx`` when given
(``ctx="cpu"``: the host). With ``pin_memory=True`` they stay on the
host, pinned, for a ``DevicePrefetcher`` to upload on its side stream.
The worker model mirrors the reference:

- ``num_workers == 0``: load in the iterating thread, with ``prefetch``
  background threads when asked.
- ``num_workers > 0, thread_pool=True``: a threaded prefetch pipeline.
- ``num_workers > 0, thread_pool=False``: worker processes. Workers
  batchify with ``default_mp_batchify_fn`` (numpy) and send batches
  back to the parent, which wraps them as NDArrays. Workers never
  initialize CUDA: the card is hidden from them
  (``CUDA_VISIBLE_DEVICES`` is empty in every child), and a dataset
  whose samples hold CUDA tensors is refused before any worker starts.

  Workers start through the ``forkserver`` context by default (a fork
  of a parent whose CUDA runtime is up cannot use it, and a fork of a
  multithreaded parent can deadlock), so the dataset and batchify_fn
  are pickled to fresh workers; the server imports this module first,
  so a worker does not import torch before it can start. ``MXTPU_MP_START_METHOD=fork`` rides
  copy-on-write for datasets that do not pickle, at your own risk.

A worker that dies takes its batch with it; the first timeout restarts
the pool and resubmits every pending batch, a second raises with the
dead workers' exit codes.
"""
from __future__ import annotations

import multiprocessing as _mp
import os as _os
import queue as _queue
import threading
from typing import Callable, List, Optional

import numpy as _np
import torch

from ... import ndarray as nd
from ...context import resolve_device
from ...ndarray import NDArray
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data, ctx=None):
    """Stack samples into a batch (reference ``default_batchify_fn``):
    NDArrays stay where they are, anything else becomes an NDArray on
    ``ctx`` (None: the card)."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i, ctx) for i in data]
    out = _np.asarray(data)
    return nd.array(out, dtype=out.dtype, ctx=ctx)


def default_mp_batchify_fn(data):
    """Worker-side batchify: numpy only (the reference's variant built
    shared-memory NDArrays; here batches cross the process boundary as
    numpy)."""
    if isinstance(data[0], tuple):
        return [default_mp_batchify_fn(list(i)) for i in zip(*data)]
    arrs = [x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
            for x in data]
    return _np.stack(arrs)


def _np_to_nd(batch, device: torch.device, pin: bool = False):
    """A worker's numpy batch as NDArrays on ``device`` (on the host
    without a copy; pinned, which copies once, when asked and a card is
    there)."""
    if isinstance(batch, (list, tuple)):
        return [_np_to_nd(b, device, pin) for b in batch]
    if isinstance(batch, _np.ndarray):
        t = torch.from_numpy(_np.ascontiguousarray(batch))
        if pin and torch.cuda.is_available():
            t = t.pin_memory()
        return NDArray(t.to(device))
    return batch


def _pinned(batch):
    if isinstance(batch, (list, tuple)):
        return [_pinned(b) for b in batch]
    if isinstance(batch, NDArray) and batch._data.device.type == "cpu":
        return NDArray(batch._data.pin_memory())
    return batch


def _hide_card(env) -> None:
    """Keep a worker process off the card."""
    env["CUDA_VISIBLE_DEVICES"] = ""


# worker-process globals (set once per worker by the fork initializer —
# the reference passes the dataset the same way, riding fork COW)
_worker_dataset = None
_worker_batchify = None


def _worker_init(dataset, batchify_fn):
    global _worker_dataset, _worker_batchify
    # workers are numpy-only: the card stays hidden in this process
    _hide_card(_os.environ)
    _worker_dataset = dataset
    _worker_batchify = batchify_fn


def _worker_fn(indices):
    samples = [_worker_dataset[i] for i in indices]
    return _worker_batchify(samples)


class DataLoader:
    """Iterates a Dataset in mini-batches with background prefetch."""

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, sampler: Optional[Sampler] = None,
                 last_batch: Optional[str] = None,
                 batch_sampler: Optional[BatchSampler] = None,
                 batchify_fn: Optional[Callable] = None,
                 num_workers: int = 0, pin_memory: bool = False,
                 prefetch: Optional[int] = None, thread_pool: bool = False,
                 timeout: int = 120, ctx=None):
        """``ctx``: where batches go (None: the card; ignored with
        ``pin_memory=True``, which keeps them on the host, pinned)."""
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size is required when batch_sampler is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle and sampler are exclusive")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size/shuffle/sampler/last_batch are exclusive with "
                "batch_sampler")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._mp = self._num_workers > 0 and not thread_pool
        self._batchify_fn = batchify_fn or (
            default_mp_batchify_fn if self._mp else default_batchify_fn)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(1, num_workers))
        self._pin_memory = pin_memory
        self._ctx = ctx
        self._timeout = timeout

    def __len__(self):
        return len(self._batch_sampler)

    def _device(self) -> torch.device:
        """Where this loader's batches go."""
        return torch.device("cpu") if self._pin_memory else \
            resolve_device(self._ctx)

    def _make_batch(self, indices, device: torch.device) -> object:
        samples = [self._dataset[i] for i in indices]
        if self._batchify_fn is default_batchify_fn:
            batch = default_batchify_fn(samples, device)
        else:
            batch = self._batchify_fn(samples)
        return _pinned(batch) if self._pin_memory and \
            torch.cuda.is_available() else batch

    def _check_mp_safe(self):
        """Probe one sample in the parent: a CUDA tensor anywhere in it
        (a nested tuple/list/dict too) would make a worker initialize
        CUDA, which it must never do — refuse with the fix instead."""
        if len(self._dataset) == 0:
            return

        def on_card(x):
            if isinstance(x, NDArray):
                x = x._data
            if isinstance(x, torch.Tensor):
                return x.device.type != "cpu"
            if isinstance(x, (tuple, list)):
                return any(on_card(i) for i in x)
            if isinstance(x, dict):
                return any(on_card(v) for v in x.values())
            return False

        if on_card(self._dataset[0]):
            raise ValueError(
                "DataLoader(num_workers>0) runs worker processes, but "
                "this dataset yields CUDA tensors — worker processes must "
                "not touch the card. Use thread_pool=True or make the "
                "dataset/transforms yield host arrays.")

    @property
    def _pool(self):
        """Worker pool, started once and reused across epochs (the
        reference creates its pool in __init__). forkserver by default
        (see module docstring); MXTPU_MP_START_METHOD overrides."""
        pool = getattr(self, "_pool_cache", None)
        if pool is None:
            method = _os.environ.get("MXTPU_MP_START_METHOD")
            if not method:
                method = ("forkserver"
                          if "forkserver" in _mp.get_all_start_methods()
                          else "fork")
            ctx = _mp.get_context(method)
            if method == "forkserver":
                # a worker reads its dataset only once this module (and
                # torch) is imported, and the pool starts its workers one
                # after another: have the server import it once, so each
                # worker forks with it loaded (a server already running
                # keeps its own preload)
                ctx.set_forkserver_preload([__name__])
            # children take the environment at their start: hide the
            # card so neither the forkserver process nor a worker can
            # initialize CUDA (see _worker_init)
            old = _os.environ.get("CUDA_VISIBLE_DEVICES")
            _hide_card(_os.environ)
            try:
                pool = ctx.Pool(self._num_workers,
                                initializer=_worker_init,
                                initargs=(self._dataset,
                                          self._batchify_fn))
            finally:
                if old is None:
                    _os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                else:
                    _os.environ["CUDA_VISIBLE_DEVICES"] = old
            self._pool_cache = pool
        return pool

    def _track_workers(self) -> None:
        """Remember every worker Process the pool has ever run: the
        pool's maintenance thread reaps+replaces dead workers, so by
        the time a timeout fires the corpse may be gone from
        ``pool._pool`` — but the Process objects keep their exitcode."""
        reg = getattr(self, "_worker_registry", None)
        if reg is None:
            reg = self._worker_registry = {}
        pool = getattr(self, "_pool_cache", None)
        if pool is not None:
            for p in list(getattr(pool, "_pool", [])):
                reg[p.pid] = p

    def _dead_worker_report(self) -> str:
        self._track_workers()
        purged = getattr(self, "_purged_pids", set())
        dead = sorted(
            (pid, p.exitcode)
            for pid, p in getattr(self, "_worker_registry", {}).items()
            if p.exitcode not in (None, 0) and pid not in purged)
        if not dead:
            return "no worker exited abnormally (stuck, not dead?)"
        return "dead worker exit codes: " + ", ".join(
            f"pid {pid} -> {code}" for pid, code in dead)

    def _restart_pool(self) -> None:
        pool = getattr(self, "_pool_cache", None)
        if pool is not None:
            self._track_workers()
            # workers still alive here die by OUR terminate() below —
            # blaming their SIGTERM exit code in a later report would
            # misdiagnose a stuck worker as a crashed one
            purged = getattr(self, "_purged_pids", None)
            if purged is None:
                purged = self._purged_pids = set()
            purged.update(p.pid for p in list(getattr(pool, "_pool", []))
                          if p.is_alive())
            try:
                pool.terminate()
            except Exception:
                pass
            self._pool_cache = None

    def __del__(self):
        pool = getattr(self, "_pool_cache", None)
        if pool is not None:
            try:
                pool.terminate()
            except Exception:
                pass

    def _iter_multiprocess(self):
        """Worker pool: batches built in child processes (numpy),
        wrapped as NDArrays in the parent — the reference's
        multiprocessing DataLoader shape. A bounded window of
        apply_async tasks gives backpressure (imap would eagerly
        compute and buffer the whole epoch) while preserving batch
        order.

        Dead-worker recovery: a worker that dies (``os._exit``, OOM
        kill, segfault) takes its in-flight task with it — mp.Pool
        replaces the worker but never completes the task, so the
        result surfaces as a timeout. On the FIRST timeout the loader
        restarts the pool and resubmits every pending batch once; a
        second timeout on the same batch raises, naming the dead
        workers' exit codes."""
        import collections
        self._check_mp_safe()
        device = self._device()
        pool = self._pool
        window = max(self._prefetch, self._num_workers)
        # (indices, async_result): indices are kept so pending work
        # can be resubmitted to a fresh pool after a worker death
        pending = collections.deque()
        sampler_it = iter(self._batch_sampler)

        def fill():
            try:
                while len(pending) < window:
                    indices = next(sampler_it)
                    pending.append(
                        (indices,
                         pool.apply_async(_worker_fn, (indices,))))
            except StopIteration:
                pass
            finally:
                # register BEFORE any worker can die: a crash between
                # submission and the timeout report must find its
                # Process handle (and exit code) in the registry
                self._track_workers()

        fill()
        retried = False
        while pending:
            indices, res = pending[0]
            try:
                batch = res.get(self._timeout)
            except _mp.TimeoutError:
                report = self._dead_worker_report()
                if retried:
                    raise RuntimeError(
                        f"DataLoader worker timed out after "
                        f"{self._timeout}s twice for one batch "
                        f"({report})")
                retried = True
                # one recovery attempt: fresh pool, resubmit all
                # pending batches in order (completed-but-unread
                # results from the old pool are recomputed — cheaper
                # than reasoning about which worker died holding what)
                self._restart_pool()
                pool = self._pool
                pending = collections.deque(
                    (idx, pool.apply_async(_worker_fn, (idx,)))
                    for idx, _ in pending)
                continue
            retried = False
            pending.popleft()
            fill()
            yield _np_to_nd(batch, device, self._pin_memory)

    def __iter__(self):
        if self._mp:
            yield from self._iter_multiprocess()
            return
        device = self._device()
        if self._prefetch == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices, device)
            return
        q: _queue.Queue = _queue.Queue(maxsize=self._prefetch)
        sentinel = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer is gone, so an
            # abandoned iterator (break/exception mid-epoch) can't pin
            # the producer thread + in-flight batches forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def _producer():
            try:
                for indices in self._batch_sampler:
                    if stop.is_set() or \
                            not _put(self._make_batch(indices, device)):
                        return
            except Exception as e:  # surfaced on the consumer side
                _put(e)
            _put(sentinel)

        t = threading.Thread(target=_producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get(timeout=self._timeout)
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
