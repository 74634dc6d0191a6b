"""Image decode, resize and augmentation: the port of
``mxtpu/image/image.py`` (reference ``python/mxnet/image/image.py`` and
the C++ augmenters of ``src/io/image_aug_default.cc``).

The reference decodes and encodes with TensorFlow's codecs; here JPEG
goes through the native library's codec (``native.jpeg_decode`` and
``jpeg_encode``: libjpeg, or nvJPEG where the host has no libjpeg) and
PNG through ``_png`` (stdlib ``zlib`` and numpy), so PNG pixels are
bit-equal to the reference's and JPEG pixels within a few units.

Resizing is ``jax.image.resize``'s arithmetic (``transforms
.resize_tensor``). The functions and augmenters run where the image
is: an NDArray stays on its device, and a numpy image is worked on the
host (a CPU NDArray comes back). ``imdecode`` and ``imread`` put their
NDArray on ``ctx`` (None: the card). The random augmenters draw from
Python's ``random`` module in the reference's order (``LightingAug``
from numpy's global generator, as the reference's does), so one
``random.seed`` gives both packages the same crops and flips.
"""
from __future__ import annotations

import math
import os
import random as pyrandom
from typing import List

import numpy as onp
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray import NDArray
from ..gluon.data.vision.transforms import resize_tensor
from . import _png

__all__ = ["imdecode", "imencode", "imread", "imresize", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "CreateAugmenter", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "ColorJitterAug", "LightingAug",
           "RandomSizedCropAug", "ImageIter"]

_METHODS = {0: "nearest", 1: "linear", 2: "cubic", 3: "linear",
            4: "lanczos3"}


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------
def _decode_numpy(buf, flag: int = 1) -> onp.ndarray:
    channels = 1 if flag == 0 else 3
    if _png.is_png(buf):
        return _png.decode(buf, channels)
    if bytes(buf[:2]) == b"\xff\xd8":
        from .. import native
        return native.jpeg_decode(bytes(buf), channels)
    raise ValueError("imdecode reads JPEG and PNG images")


def imdecode(buf, flag: int = 1, to_rgb: bool = True, as_numpy: bool = False,
             ctx=None):
    """Decode a JPEG/PNG byte string → HWC uint8 image (reference
    ``mx.image.imdecode``; flag=0 grayscale, ``to_rgb=False`` BGR), as
    numpy or as an NDArray on ``ctx`` (None: the card)."""
    img = _decode_numpy(buf, flag)
    if not to_rgb:
        img = onp.ascontiguousarray(img[..., ::-1])   # OpenCV's BGR
    if as_numpy:
        return img
    return nd.array(img, ctx=ctx, dtype="uint8")


def imencode(img, img_fmt: str = ".jpg", quality: int = 95) -> bytes:
    if isinstance(img, NDArray):
        img = img.asnumpy()
    img = onp.ascontiguousarray(img).astype(onp.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img_fmt.lower() in (".jpg", ".jpeg"):
        from .. import native
        return native.jpeg_encode(img, quality=quality)
    if img_fmt.lower() == ".png":
        return _png.encode(img)
    raise ValueError(f"unsupported image format {img_fmt}")


def imread(filename: str, flag: int = 1, to_rgb: bool = True, ctx=None):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb, ctx=ctx)


def _tensor(src) -> torch.Tensor:
    """An image's tensor: an NDArray's own, a numpy image on the host."""
    if isinstance(src, NDArray):
        return src._data
    return torch.from_numpy(onp.ascontiguousarray(src))


def imresize(src, w: int, h: int, interp: int = 1):
    """Resize an HWC image to (h, w) (reference ``mx.image.imresize``,
    ``jax.image.resize`` with nearest, linear, cubic or lanczos3; a
    uint8 image is rounded and clipped back to uint8)."""
    t = _tensor(src)
    method = _METHODS.get(interp, "linear")
    out = resize_tensor(t, (h, w), (0, 1), method)
    if method == "nearest":
        out = out.to(torch.float32)
    if t.dtype == torch.uint8:
        out = out.round().clamp(0, 255).to(torch.uint8)
    return NDArray(out)


def resize_short(src, size: int, interp: int = 1):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0: int, y0: int, w: int, h: int, size=None, interp=1):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=1):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=1):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def _like(value, src) -> NDArray:
    """A constant as a float32 NDArray on ``src``'s device."""
    if isinstance(value, NDArray):
        return value.as_in_context(_tensor(src).device)
    return nd.array(value, ctx=_tensor(src).device)


def color_normalize(src, mean, std=None):
    src = src.astype("float32") if isinstance(src, NDArray) else \
        nd.array(src, ctx="cpu", dtype="float32")
    if mean is not None:
        src = src - _like(mean, src)
    if std is not None:
        src = src / _like(std, src)
    return src


# ---------------------------------------------------------------------------
# augmenters (reference Augmenter classes; each is callable img → img)
# ---------------------------------------------------------------------------
class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    """Random area+aspect crop then resize (inception-style)."""

    def __init__(self, size, area, ratio, interp=1):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        h, w = src.shape[:2]
        src_area = h * w
        for _ in range(10):
            target_area = pyrandom.uniform(*self.area) * src_area
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(pyrandom.uniform(*log_ratio))
            new_w = int(round(math.sqrt(target_area * aspect)))
            new_h = int(round(math.sqrt(target_area / aspect)))
            if new_w <= w and new_h <= h:
                x0 = pyrandom.randint(0, w - new_w)
                y0 = pyrandom.randint(0, h - new_h)
                return fixed_crop(src, x0, y0, new_w, new_h, self.size,
                                  self.interp)
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return src[:, ::-1] if not isinstance(src, NDArray) else \
                nd.flip(src, axis=1)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean if mean is None or isinstance(mean, NDArray) \
            else onp.asarray(mean, onp.float32)
        self.std = std if std is None or isinstance(std, NDArray) \
            else onp.asarray(std, onp.float32)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


_GRAY = [[[0.299, 0.587, 0.114]]]


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = onp.asarray(_GRAY, onp.float32)

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = src * _like(self.coef, src)
        gray = (3.0 * (1.0 - alpha) / gray.size) * gray.sum()
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = onp.asarray(_GRAY, onp.float32)

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = (src * _like(self.coef, src)).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness, contrast, saturation):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        augs = []
        if brightness > 0:
            augs.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            augs.append(ContrastJitterAug(contrast))
        if saturation > 0:
            augs.append(SaturationJitterAug(saturation))
        self.augs = augs

    def __call__(self, src):
        pyrandom.shuffle(self.augs)
        for aug in self.augs:
            src = aug(src)
        return src


class LightingAug(Augmenter):
    """PCA-based lighting noise (AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval)
        self.eigvec = onp.asarray(eigvec)

    def __call__(self, src):
        alpha = onp.random.normal(0, self.alphastd, size=(3,))
        rgb = onp.dot(self.eigvec * alpha, self.eigval)
        return src + _like(rgb, src)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2) -> List[Augmenter]:
    """Standard augmenter pipeline factory (reference
    ``mx.image.CreateAugmenter``)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = [55.46, 4.794, 1.148]
        eigvec = [[-0.5675, 0.7192, 0.4009],
                  [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = [123.68, 116.28, 103.53]
    if std is True:
        std = [58.395, 57.12, 57.375]
    if mean is not None and mean is not False:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# ImageIter (reference python ImageIter over .rec / .lst / folders)
# ---------------------------------------------------------------------------
class ImageIter:
    """Image data iterator over RecordIO or an image list (reference
    ``mx.image.ImageIter``): yields NCHW float batches on ``ctx``
    (None: the card). Each image is decoded and augmented on the host,
    one at a time: this is the path for augmentation, and
    ``mx.io.ImageRecordIter`` routes to the native pipeline when no
    augmenter is asked for."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 last_batch_handle="pad", ctx=None, **kwargs):
        from ..io import DataDesc
        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise ValueError("data_shape must be (C, H, W)")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.path_root = path_root
        self.ctx = ctx
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self.record = None
        self.imglist = None
        if path_imgrec is not None:
            from ..recordio import MXIndexedRecordIO, MXRecordIO
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.isfile(idx_path):
                self.record = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self.seq = list(self.record.keys)
            else:
                if shuffle:
                    raise MXNetError(
                        "shuffle=True needs random access: build the "
                        f"{idx_path} sidecar (python -m "
                        "mxtpu_torch.tools.im2rec) or pass shuffle=False")
                self.record = MXRecordIO(path_imgrec, "r")
                self.seq = None
        elif path_imglist is not None:
            entries = {}
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = onp.array(
                        [float(x) for x in parts[1:-1]], onp.float32)
                    entries[int(parts[0])] = (label, parts[-1])
            self.imglist = entries
            self.seq = list(entries.keys())
        elif imglist is not None:
            entries = {}
            for i, (label, fname) in enumerate(imglist):
                entries[i] = (onp.asarray(label, onp.float32).reshape(-1),
                              fname)
            self.imglist = entries
            self.seq = list(entries.keys())
        else:
            raise MXNetError(
                "ImageIter needs path_imgrec, path_imglist, or imglist")
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        lshape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, lshape)]
        self.cursor = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.record is not None and self.seq is None:
            self.record.reset()
        self.cursor = 0

    def next_sample(self):
        from ..recordio import unpack
        if self.record is not None:
            if self.seq is not None:
                if self.cursor >= len(self.seq):
                    raise StopIteration
                idx = self.seq[self.cursor]
                self.cursor += 1
                s = self.record.read_idx(idx)
            else:
                s = self.record.read()
                if s is None:
                    raise StopIteration
            header, img = unpack(s)
            return header.label, img
        if self.cursor >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cursor]
        self.cursor += 1
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root, fname), "rb") as f:
            return label, f.read()

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        from ..io import DataBatch
        c, h, w = self.data_shape
        batch_data = onp.zeros((self.batch_size, h, w, c), onp.float32)
        labels = onp.zeros((self.batch_size,) +
                           ((self.label_width,) if self.label_width > 1
                            else ()), onp.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                img = imdecode(s, flag=0 if c == 1 else 1, as_numpy=True)
                data = nd.array(img.astype(onp.float32), ctx="cpu")
                for aug in self.auglist:
                    data = aug(data)
                arr = data.asnumpy() if isinstance(data, NDArray) else data
                batch_data[i] = arr.reshape(h, w, c)
                labels[i] = label if self.label_width > 1 else \
                    onp.float32(label if onp.ndim(label) == 0 else label[0])
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = self.batch_size - i
        data_nd = nd.array(batch_data.transpose(0, 3, 1, 2), ctx=self.ctx)
        label_nd = nd.array(labels, ctx=self.ctx)
        return DataBatch(data=[data_nd], label=[label_nd], pad=pad)
