"""gluon.contrib.nn — the port of ``mxtpu/gluon/contrib/nn.py``
(reference ``python/mxnet/gluon/contrib/nn/basic_layers.py``): the
structural blocks, ``PixelShuffle2D``, and ``SyncBatchNorm``, which on
one device is ``BatchNorm`` (its batch is the whole batch)."""
from __future__ import annotations

from ..block import HybridBlock
from ..nn import BatchNorm
from ..nn.basic_layers import Concatenate, HybridConcatenate

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SyncBatchNorm",
           "PixelShuffle2D"]

Concurrent = Concatenate
HybridConcurrent = HybridConcatenate


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class SyncBatchNorm(BatchNorm):
    """Cross-device synchronized BatchNorm (reference ``SyncBatchNorm``
    over NCCL). A parameter lives on one device here, so the statistics
    are already the whole batch's; ``num_devices`` is accepted for the
    API and not used."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)


class PixelShuffle2D(HybridBlock):
    """(B, C*f1*f2, H, W) → (B, C, H*f1, W*f2) (reference contrib
    ``PixelShuffle2D``)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = (factor, factor) if isinstance(factor, int) \
            else tuple(factor)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factor
        b, c, h, w = x.shape
        c_out = c // (f1 * f2)
        x = x.reshape(b, c_out, f1, f2, h, w)
        x = x.transpose((0, 1, 4, 2, 5, 3))
        return x.reshape(b, c_out, h * f1, w * f2)
