"""Object-detection image pipeline, the port of
``mxtpu/image/detection.py`` (reference
``python/mxnet/image/detection.py``):
``ImageDetIter`` + Det* augmenters that transform images AND their box
labels together — the input path SSD-style training used.

Label layout per image (the reference's packed detection label):
``[header_width, object_width, <extra header...>, (id, xmin, ymin,
xmax, ymax, <extra...>) * N]`` with coordinates normalized to [0, 1].
Batches pad the object dimension with -1 rows. Images are decoded and
augmented on the host, and batches come out on ``ctx`` (None: the
card). The Det* augmenters draw from numpy's global generator, as the
reference's do.
"""
from __future__ import annotations

import math
from typing import List

import numpy as onp

from ..base import MXNetError
from .. import ndarray as nd
from .image import Augmenter, ImageIter, imresize, CreateAugmenter

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "CreateDetAugmenter",
           "ImageDetIter"]


class DetAugmenter:
    """Augmenter over (image, label); label is (N, 5+) normalized."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a plain image Augmenter that doesn't move pixels' geometry
    (color jitter, cast...) — label passes through (reference
    DetBorrowAug)."""

    def __init__(self, augmenter: Augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        out = self.augmenter(nd.array(src, ctx="cpu")
                             if isinstance(src, onp.ndarray) else src)
        out = out.asnumpy() if hasattr(out, "asnumpy") \
            else onp.asarray(out)
        return out, label


class DetHorizontalFlipAug(DetAugmenter):
    """Random horizontal flip of image + boxes (reference
    DetHorizontalFlipAug)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, src, label):
        if onp.random.random() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            x2 = label[valid, 3].copy()
            label[valid, 1] = 1.0 - x2
            label[valid, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """IoU-constrained random crop (reference DetRandomCropAug /
    SSD-style sampling): pick a crop whose IoU with at least one box
    exceeds ``min_object_covered``-ish constraints; boxes are clipped
    and re-normalized, fully-cropped-out boxes dropped (-1 rows)."""

    def __init__(self, min_object_covered: float = 0.3,
                 aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.3, 1.0), max_attempts: int = 20):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _try_crop(self, h, w):
        area = h * w * onp.random.uniform(*self.area_range)
        ratio = onp.random.uniform(*self.aspect_ratio_range)
        ch = int(round(math.sqrt(area / ratio)))
        cw = int(round(math.sqrt(area * ratio)))
        if ch > h or cw > w:
            return None
        y0 = onp.random.randint(0, h - ch + 1)
        x0 = onp.random.randint(0, w - cw + 1)
        return x0, y0, cw, ch

    @staticmethod
    def _coverage(label, x0, y0, cw, ch, w, h):
        """Fraction of each valid box's area inside the crop."""
        valid = label[:, 0] >= 0
        if not valid.any():
            return onp.zeros(0)
        b = label[valid, 1:5] * [w, h, w, h]
        ix1 = onp.maximum(b[:, 0], x0)
        iy1 = onp.maximum(b[:, 1], y0)
        ix2 = onp.minimum(b[:, 2], x0 + cw)
        iy2 = onp.minimum(b[:, 3], y0 + ch)
        inter = onp.clip(ix2 - ix1, 0, None) * onp.clip(iy2 - iy1, 0,
                                                        None)
        area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        return inter / onp.maximum(area, 1e-12)

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            crop = self._try_crop(h, w)
            if crop is None:
                continue
            x0, y0, cw, ch = crop
            cov = self._coverage(label, x0, y0, cw, ch, w, h)
            if cov.size and cov.max() >= self.min_object_covered:
                src = src[y0:y0 + ch, x0:x0 + cw]
                out = label.copy()
                valid = out[:, 0] >= 0
                b = out[valid, 1:5] * [w, h, w, h]
                b[:, [0, 2]] = onp.clip(b[:, [0, 2]] - x0, 0, cw)
                b[:, [1, 3]] = onp.clip(b[:, [1, 3]] - y0, 0, ch)
                b /= [cw, ch, cw, ch]
                keep = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) > 1e-4
                new = onp.full_like(out, -1.0)
                rows = onp.where(valid)[0][keep]
                new[:len(rows), 0] = out[rows, 0]
                new[:len(rows), 1:5] = b[keep]
                if out.shape[1] > 5:
                    new[:len(rows), 5:] = out[rows, 5:]
                return src, new
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expand-pad (reference DetRandomPadAug): place the image
    on a larger canvas; boxes shrink accordingly."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts: int = 20,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            scale = onp.random.uniform(*self.area_range)
            if scale <= 1.0:
                return src, label
            ratio = onp.random.uniform(*self.aspect_ratio_range)
            nh = int(round(math.sqrt(h * w * scale / ratio)))
            nw = int(round(math.sqrt(h * w * scale * ratio)))
            if nh >= h and nw >= w:
                break
        else:
            return src, label
        y0 = onp.random.randint(0, nh - h + 1)
        x0 = onp.random.randint(0, nw - w + 1)
        canvas = onp.empty((nh, nw, src.shape[2]), src.dtype)
        canvas[...] = onp.asarray(self.pad_val, src.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = src
        out = label.copy()
        valid = out[:, 0] >= 0
        b = out[valid, 1:5] * [w, h, w, h]
        b[:, [0, 2]] += x0
        b[:, [1, 3]] += y0
        out[valid, 1:5] = b / [nw, nh, nw, nh]
        return canvas, out


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0.0, rand_pad=0.0,
                       rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0,
                       min_object_covered=0.3,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 3.0), max_attempts=20,
                       pad_val=(127, 127, 127), **kwargs):
    """Build the standard detection augmenter list (reference
    ``CreateDetAugmenter``)."""
    auglist: List[DetAugmenter] = []
    if rand_crop > 0:
        auglist.append(DetRandomCropAug(
            min_object_covered, aspect_ratio_range,
            (area_range[0], min(1.0, area_range[1])), max_attempts))
    if rand_pad > 0:
        auglist.append(DetRandomPadAug(
            aspect_ratio_range, (max(1.0, area_range[0]), area_range[1]),
            max_attempts, pad_val))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # color/cast/normalize borrow the classification augmenters — but
    # NEVER the geometric crops CreateAugmenter appends: a crop moves
    # pixels without moving the (pass-through) box coords, silently
    # corrupting labels. Whole-image resizes are safe (normalized
    # coords are size-relative); _augment_det resizes to data_shape at
    # the end anyway.
    from .image import CenterCropAug, RandomCropAug, RandomSizedCropAug
    geometric = (CenterCropAug, RandomCropAug, RandomSizedCropAug)
    for aug in CreateAugmenter(data_shape, resize=resize,
                               brightness=brightness, contrast=contrast,
                               saturation=saturation, mean=mean, std=std,
                               **kwargs):
        if isinstance(aug, geometric):
            continue
        auglist.append(DetBorrowAug(aug))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator (reference ``mx.image.ImageDetIter``): data
    batches like ImageIter, labels (batch, max_objects, 5) padded with
    -1 rows. Label source: the packed detection header format
    ``[hw, ow, ..., (id, x1, y1, x2, y2)*N]`` of im2rec detection
    lists (normalized coords)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="label", ctx=None, **kwargs):
        det_augs = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **kwargs)
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         shuffle=shuffle, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         ctx=ctx)
        self.det_auglist = det_augs
        self.max_objects = max(1, self._scan_max_objects())
        from ..io import DataDesc
        self.label_name = label_name
        self.provide_label = [DataDesc(
            label_name, (batch_size, self.max_objects, 5), "float32")]

    @staticmethod
    def _parse_label(raw) -> onp.ndarray:
        """Flat packed label → (N, 5) float array (id, x1, y1, x2, y2)."""
        a = onp.asarray(raw, onp.float32).ravel()
        if a.size < 2:
            raise MXNetError("detection label too short")
        hw = int(a[0])
        ow = int(a[1])
        if ow < 5 or hw < 2:
            raise MXNetError(f"bad detection header (hw={hw}, ow={ow})")
        body = a[hw:]
        n = body.size // ow
        return body[:n * ow].reshape(n, ow)[:, :5].copy()

    def _scan_max_objects(self) -> int:
        mx_obj = 0
        if self.imglist is not None:
            for label, _ in self.imglist.values():
                try:
                    mx_obj = max(mx_obj, self._parse_label(label).shape[0])
                except MXNetError:
                    continue
            return mx_obj
        # record-based: one independent pass over headers
        from ..recordio import MXRecordIO, unpack
        r = MXRecordIO(self.record.uri, "r")
        while True:
            s = r.read()
            if s is None:
                break
            header, _ = unpack(s)
            try:
                mx_obj = max(mx_obj,
                             self._parse_label(header.label).shape[0])
            except MXNetError:
                continue
        r.close()
        return mx_obj

    def reshape(self, data_shape=None, label_shape=None):
        """Change output shapes (reference ImageDetIter.reshape)."""
        from ..io import DataDesc
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            self.provide_data = [DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + self.data_shape)]
        if label_shape is not None:
            self.max_objects = int(label_shape[1])
            self.provide_label = [DataDesc(
                self.provide_label[0].name,
                (self.batch_size, self.max_objects, int(label_shape[2])),
                "float32")]

    def _augment_det(self, img: onp.ndarray, label: onp.ndarray):
        for aug in self.det_auglist:
            if isinstance(aug, DetAugmenter):
                img, label = aug(img, label)
            else:
                img = aug(img)
        c, hh, ww = self.data_shape
        if img.shape[:2] != (hh, ww):
            img = imresize(img, ww, hh)   # boxes normalized: unchanged
            img = img.asnumpy() if hasattr(img, "asnumpy") else \
                onp.asarray(img)
        return img, label

    def next(self):
        from ..io import DataBatch
        from .image import imdecode
        c, h, w = self.data_shape
        imgs = onp.zeros((self.batch_size, h, w, c), onp.float32)
        labels = onp.full((self.batch_size, self.max_objects, 5), -1.0,
                          onp.float32)
        i = 0
        try:
            while i < self.batch_size:
                raw_label, sbytes = self.next_sample()
                img = imdecode(sbytes, flag=0 if c == 1 else 1,
                               as_numpy=True)
                label = self._parse_label(raw_label)
                img, label = self._augment_det(
                    onp.asarray(img, onp.float32), label)
                imgs[i] = onp.asarray(img, onp.float32).reshape(h, w, c)
                k = min(label.shape[0], self.max_objects)
                labels[i, :k] = label[:k]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = self.batch_size - i
        return DataBatch(
            data=[nd.array(imgs.transpose(0, 3, 1, 2), ctx=self.ctx)],
            label=[nd.array(labels, ctx=self.ctx)], pad=pad)
