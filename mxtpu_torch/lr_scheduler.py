"""Learning-rate schedulers — the port of ``mxtpu/lr_scheduler.py``
(reference ``python/mxnet/lr_scheduler.py``), plain Python as there.
All support linear warmup like the reference 1.x."""
from __future__ import annotations

import math
from typing import List, Optional

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr: float = 0.01, warmup_steps: int = 0,
                 warmup_begin_lr: float = 0.0, warmup_mode: str = "linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("warmup_mode must be 'linear' or 'constant'")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update: int) -> float:
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            increase = (self.warmup_final_lr - self.warmup_begin_lr) * \
                num_update / self.warmup_steps
            return self.warmup_begin_lr + increase
        return self.warmup_begin_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates."""

    def __init__(self, step: int, factor: float = 1.0, stop_factor_lr: float = 1e-8,
                 base_lr: float = 0.01, warmup_steps: int = 0,
                 warmup_begin_lr: float = 0.0, warmup_mode: str = "linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0
        self._curr = base_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self._curr *= self.factor
            if self._curr < self.stop_factor_lr:
                self._curr = self.stop_factor_lr
        return self._curr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each step in a milestone list."""

    def __init__(self, step: List[int], factor: float = 1.0,
                 base_lr: float = 0.01, warmup_steps: int = 0,
                 warmup_begin_lr: float = 0.0, warmup_mode: str = "linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(step, list) and len(step) >= 1
        for i, s in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("schedule steps must be increasing")
            if s < 1:
                raise ValueError("steps must be >= 1")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0
        self._curr = base_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self._curr *= self.factor
            else:
                return self._curr
        return self._curr


class PolyScheduler(LRScheduler):
    """Polynomial decay from base_lr to final_lr over max_update."""

    def __init__(self, max_update: int, base_lr: float = 0.01,
                 pwr: int = 2, final_lr: float = 0,
                 warmup_steps: int = 0, warmup_begin_lr: float = 0.0,
                 warmup_mode: str = "linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert max_update >= 1
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = 1 - (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (frac ** self.power)
        return self.final_lr


class CosineScheduler(LRScheduler):
    """Cosine decay from base_lr to final_lr over max_update."""

    def __init__(self, max_update: int, base_lr: float = 0.01,
                 final_lr: float = 0, warmup_steps: int = 0,
                 warmup_begin_lr: float = 0.0, warmup_mode: str = "linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert max_update >= 1
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * frac)) / 2
        return self.final_lr
