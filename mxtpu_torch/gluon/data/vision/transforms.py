"""Vision transforms — the port of
``mxtpu/gluon/data/vision/transforms.py`` (reference
``python/mxnet/gluon/data/vision/transforms.py``).

Transforms are blocks over HWC uint8 images (the datasets' layout) that
produce CHW float tensors, as the reference's do; they run where the
image is, on the host for a dataset's samples. The random ones draw
from numpy's global generator in the reference's order, so one
``np.random.seed`` gives both packages the same crops and flips.
``Resize`` is the reference's ``jax.image.resize(method="linear")``:
a triangle filter at half-pixel centres that widens by the scale when
it shrinks (antialiasing), as separable weight matrices;
:func:`resize_tensor` also holds jax's Keys cubic, lanczos3 and nearest
for ``mx.image.imresize``.
"""
from __future__ import annotations

import numpy as _np
import torch

from .... import ndarray as nd
from ....ndarray import NDArray
from ...block import Block, HybridBlock
from ...nn import HybridSequential, Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast"]


class Compose(Sequential):
    """Sequentially composed transforms."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def hybrid_forward(self, F, x):
        out = x.astype("float32") / 255.0
        if out.ndim == 3:
            return out.transpose((2, 0, 1))
        return out.transpose((0, 3, 1, 2))


class Normalize(HybridBlock):
    """Channel-wise (x - mean) / std. mean and std are Constant
    parameters, initialized here on the host (no ``net.initialize()``
    needed), and reach ``hybrid_forward`` as parameters do."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        mean = _np.asarray(mean, "float32").reshape(-1, 1, 1)
        std = _np.asarray(std, "float32").reshape(-1, 1, 1)
        with self.name_scope():
            self.mean = self.params.get_constant("mean", mean)
            self.std = self.params.get_constant("std", std)
        self.mean.initialize(ctx="cpu")
        self.std.initialize(ctx="cpu")

    def hybrid_forward(self, F, x, mean, std):
        return (x - mean) / std


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = _np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return _np.where(x >= 2.0, 0.0, out)


def _lanczos3(x, radius=3.0):
    y = radius * _np.sin(_np.pi * x) * _np.sin(_np.pi * x / radius)
    out = _np.where(x > 1e-3, y / _np.where(x != 0, _np.pi ** 2 * x ** 2, 1),
                    1.0)
    return _np.where(x > radius, 0.0, out)


# jax.image.resize's kernels, over |distance| / kernel scale
_KERNELS = {"linear": lambda x: _np.maximum(0.0, 1.0 - _np.abs(x)),
            "cubic": _keys_cubic, "lanczos3": _lanczos3}


def _resize_weights(n_in: int, n_out: int, method: str = "linear"
                    ) -> _np.ndarray:
    """(n_in, n_out) weights of jax's ``compute_weight_mat`` for the
    ``method`` kernel (linear's triangle, Keys cubic, lanczos3) with
    antialiasing, in float64."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (_np.arange(n_out, dtype=_np.float64) + 0.5) * inv - 0.5
    x = _np.abs(sample[None, :] - _np.arange(n_in, dtype=_np.float64)[:, None]
                ) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True)
    w = _np.where(_np.abs(total) > 1000.0 * float(_np.finfo(_np.float32).eps),
                  w / _np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return _np.where(inside[None, :], w, 0.0)


def _nearest_index(n_in: int, n_out: int) -> _np.ndarray:
    """jax's nearest source index, floor((i + 0.5) * n_in / n_out) in
    float32."""
    f = (_np.arange(n_out, dtype=_np.float32) + _np.float32(0.5)) \
        * _np.float32(n_in) / _np.float32(n_out)
    return _np.floor(f).astype(_np.int64)


def resize_tensor(t: torch.Tensor, sizes, axes, method: str = "linear"
                  ) -> torch.Tensor:
    """``jax.image.resize`` of ``t`` to ``sizes`` along ``axes``:
    float32 out for the kernels (linear, cubic, lanczos3), the input's
    dtype for ``nearest``."""
    out = t if method == "nearest" else t.to(torch.float32)
    for axis, n_out in zip(axes, sizes):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = torch.from_numpy(_nearest_index(n_in, n_out)).to(
                out.device)
            out = torch.index_select(out, axis, idx)
            continue
        m = torch.from_numpy(_resize_weights(n_in, n_out, method).astype(
            _np.float32)).to(out.device)
        out = torch.movedim(torch.tensordot(out, m, dims=([axis], [0])),
                            -1, axis)
    return out


def _resize_nd(x: NDArray, size) -> NDArray:
    if isinstance(size, int):
        size = (size, size)
    h, w = size[1], size[0]  # reference Resize takes (w, h)
    hw = (0, 1) if x.ndim == 3 else (1, 2)
    t = x._data
    return NDArray(resize_tensor(t, (h, w), hw).to(t.dtype))


class Resize(HybridBlock):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def hybrid_forward(self, F, x):
        return _resize_nd(x, self._size)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[-3:-1] if x.ndim == 3 else x.shape[1:3]
        if H < h or W < w:
            x = _resize_nd(x, (max(w, W), max(h, H)))
            H, W = (x.shape[0], x.shape[1]) if x.ndim == 3 else x.shape[1:3]
        y0 = (H - h) // 2
        x0 = (W - w) // 2
        if x.ndim == 3:
            return x[y0:y0 + h, x0:x0 + w, :]
        return x[:, y0:y0 + h, x0:x0 + w, :]


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        w, h = self._size
        if self._pad:
            p = self._pad
            pads = [(p, p), (p, p), (0, 0)] if x.ndim == 3 else \
                [(0, 0), (p, p), (p, p), (0, 0)]
            x = nd.array(_np.pad(x.asnumpy(), pads), ctx=x.context)
        H, W = (x.shape[0], x.shape[1]) if x.ndim == 3 else x.shape[1:3]
        y0 = int(_np.random.randint(0, H - h + 1))
        x0 = int(_np.random.randint(0, W - w + 1))
        if x.ndim == 3:
            return x[y0:y0 + h, x0:x0 + w, :]
        return x[:, y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = (x.shape[0], x.shape[1]) if x.ndim == 3 else x.shape[1:3]
        area = H * W
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            aspect = _np.random.uniform(*self._ratio)
            w = int(round(_np.sqrt(target_area * aspect)))
            h = int(round(_np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                y0 = int(_np.random.randint(0, H - h + 1))
                x0 = int(_np.random.randint(0, W - w + 1))
                crop = x[y0:y0 + h, x0:x0 + w, :] if x.ndim == 3 else \
                    x[:, y0:y0 + h, x0:x0 + w, :]
                return _resize_nd(crop, self._size)
        return _resize_nd(x, self._size)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return nd.flip(x, axis=1 if x.ndim == 3 else 2)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return nd.flip(x, axis=0 if x.ndim == 3 else 1)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._brightness = brightness

    def forward(self, x):
        alpha = 1.0 + _np.random.uniform(-self._brightness, self._brightness)
        return (x.astype("float32") * alpha).clip(0, 255).astype(x.dtype)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._contrast = contrast

    def forward(self, x):
        alpha = 1.0 + _np.random.uniform(-self._contrast, self._contrast)
        xf = x.astype("float32")
        gray_mean = float(xf.mean().asscalar())
        return ((xf - gray_mean) * alpha + gray_mean).clip(0, 255) \
            .astype(x.dtype)
