"""Dynamic loss scaler — the port of ``mxtpu/amp/loss_scaler.py``
(reference ``python/mxnet/contrib/amp/loss_scaler.py``): double the
scale every ``scale_window`` clean steps, halve it on overflow.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler", "MAX_LOSS_SCALE"]

#: the largest loss scale whose float32 reciprocal is a normal number
#: (2**-126, the smallest normal). Unscaling multiplies by the
#: reciprocal on a device that flushes subnormals to zero, so a larger
#: scale would zero every gradient while the step counts as applied;
#: every write to ``loss_scale`` is capped here.
MAX_LOSS_SCALE = 2.0 ** 126


class LossScaler:
    def __init__(self, init_scale: float = 2 ** 16,
                 scale_factor: float = 2.0, scale_window: int = 2000,
                 min_scale: float = 1.0, dynamic: bool = True):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._min_scale = min_scale
        self._unskipped = 0
        # bfloat16 shares float32's exponent range: the scale stays fixed
        # and the per-step finiteness check (a host sync) is skipped
        self.dynamic = dynamic

    @property
    def loss_scale(self):
        return self._loss_scale

    @loss_scale.setter
    def loss_scale(self, v):
        # host values are capped eagerly; a device scalar (the fused
        # step's write-back, or update_scale's grow path on one) by a
        # device minimum, with no host sync
        if isinstance(v, torch.Tensor):
            v = torch.clamp(v.to(torch.float32), max=MAX_LOSS_SCALE)
        else:
            v = min(float(v), MAX_LOSS_SCALE)
        self._loss_scale = v

    def is_finite(self, grads) -> bool:
        """Whether every gradient is finite (no scale update): one
        device reduction and one host read, whatever the count."""
        if not grads:
            return True
        datas = [g._data if hasattr(g, "_data") else g for g in grads]
        return bool(torch.stack([torch.isfinite(d).all()
                                 for d in datas]).all())

    def update_scale(self, overflow: bool) -> None:
        """Apply the dynamic policy for one step's overflow decision."""
        if not self.dynamic:
            return
        if overflow:
            self.loss_scale = max(self._min_scale,
                                  self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale = self.loss_scale * self._scale_factor
                self._unskipped = 0

    def has_overflow(self, grads) -> bool:
        """Check grads for inf/nan and update the scale (reference
        ``LossScaler.has_overflow``)."""
        overflow = not self.is_finite(grads)
        self.update_scale(overflow)
        return overflow
