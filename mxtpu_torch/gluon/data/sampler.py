"""Samplers — the port of ``mxtpu/gluon/data/sampler.py`` (reference
``python/mxnet/gluon/data/sampler.py``). ``RandomSampler`` draws from
numpy's global generator, as the reference does, so one
``np.random.seed`` gives both packages the same order."""
from __future__ import annotations

import numpy as _np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length: int, start: int = 0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length: int):
        self._length = length

    def __iter__(self):
        indices = _np.random.permutation(self._length)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Wraps a sampler into batches of indices; last_batch in
    'keep'|'discard'|'rollover' like the reference."""

    def __init__(self, sampler: Sampler, batch_size: int,
                 last_batch: str = "keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev: list = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    f"last_batch must be keep/discard/rollover, got "
                    f"{self._last_batch}")

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(f"bad last_batch {self._last_batch}")
