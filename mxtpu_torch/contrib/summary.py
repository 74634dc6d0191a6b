"""TensorBoard summaries, the port of ``mxtpu/contrib/summary.py``: the
in-tree counterpart of the external ``mxboard`` package, over
tensorboardX, imported when a writer is made (so it raises
``ImportError`` where tensorboardX is absent, as the reference does).
An NDArray on the card is read back through ``asnumpy``, which waits
for its stream first.

>>> from mxtpu_torch.contrib.summary import SummaryWriter
>>> with SummaryWriter(logdir="./logs") as sw:
...     sw.add_scalar("loss", 0.5, global_step=1)
"""
from __future__ import annotations

import numpy as _onp

from ..ndarray import NDArray

__all__ = ["SummaryWriter"]


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _onp.asarray(x)


class SummaryWriter:
    """mxboard-compatible writer (add_scalar/add_histogram/add_image/
    add_text), NDArray-aware."""

    def __init__(self, logdir: str = "./logs", flush_secs: int = 120,
                 **kwargs):
        from tensorboardX import SummaryWriter as _TBW
        self._w = _TBW(logdir=logdir, flush_secs=flush_secs, **kwargs)

    def add_scalar(self, tag, value, global_step=None):
        v = _np(value).reshape(-1)
        if v.size != 1:
            raise ValueError(
                f"add_scalar needs a scalar, got shape {_np(value).shape}"
                " — use add_histogram for vectors")
        self._w.add_scalar(tag, float(v[0]), global_step)

    def add_histogram(self, tag, values, global_step=None, bins="auto"):
        self._w.add_histogram(tag, _np(values), global_step, bins=bins)

    def add_image(self, tag, image, global_step=None,
                  dataformats="CHW"):
        self._w.add_image(tag, _np(image), global_step,
                          dataformats=dataformats)

    def add_text(self, tag, text, global_step=None):
        self._w.add_text(tag, text, global_step)

    def flush(self):
        self._w.flush()

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
