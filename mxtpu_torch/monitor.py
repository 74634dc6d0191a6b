"""mx.monitor — the port of ``mxtpu/monitor.py`` (reference
``python/mxnet/monitor.py``): periodic statistics over an executor's
outputs, arguments, gradients and aux states, for debugging
activations and gradients.

The reference installed a per-op engine callback on executors; this
Monitor, as ``mxtpu``'s, reads the bound Executor's dicts after
``forward`` (an intermediate value is observable through
``Symbol.get_internals()``, as the reference suggests).
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False,
                 monitor_all: bool = False):
        if stat_func is None:
            def stat_func(x: NDArray):
                return x.abs().mean()
        self.stat_func = stat_func
        self.interval = interval
        self.pattern = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all
        self.step = 0
        self.activated = False
        self.queue: List[Tuple[int, str, NDArray]] = []
        self.exes = []

    def install(self, exe) -> None:
        """Attach to an Executor (reference ``Monitor.install``)."""
        self.exes.append(exe)

    def install_module(self, module) -> None:
        self.install(module._exec)

    def tic(self) -> None:
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, str]]:
        if not self.activated:
            return []
        self.activated = False
        for exe in self.exes:
            names_outputs = list(zip(exe._symbol.list_outputs(),
                                     exe.outputs))
            sources = names_outputs
            if self.monitor_all:
                sources = sources + list(exe.arg_dict.items()) + \
                    [(f"{k}_grad", v) for k, v in exe.grad_dict.items()
                     if v is not None] + list(exe.aux_dict.items())
            for name, arr in sources:
                if self.pattern.match(name):
                    self.queue.append(
                        (self.step, name, self.stat_func(arr)))
        res = []
        items = sorted(self.queue, key=lambda q: q[1]) if self.sort \
            else self.queue
        for step, name, stat in items:
            res.append((step, name, str(stat.asnumpy())
                        if isinstance(stat, NDArray) else str(stat)))
        self.queue = []
        return res

    def toc_print(self) -> None:
        for step, name, stat in self.toc():
            print(f"Batch: {step:7d} {name:30s} {stat}")
