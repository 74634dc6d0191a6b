"""Vision datasets — the port of ``mxtpu/gluon/data/vision/datasets.py``
(reference ``python/mxnet/gluon/data/vision/datasets.py``).

MNIST/FashionMNIST read the standard IDX files, and CIFAR the binary
batches, from ``root`` when they are there (the layout the reference
downloads). Nothing is downloaded: when the files are missing the
datasets fall back to the reference's deterministic synthetic stand-in
(``synthetic=True`` forces it), the same arrays from the same seeds.
Samples are host NDArrays, HWC uint8, as MXNet's are.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as _np

from .... import ndarray as nd
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageFolderDataset"]

IMAGE_SLICE = ("decoding image files (mx.image) comes with ROADMAP Queue A "
               "item 10.4; ImageFolderDataset reads .npy files")


# 7x5 glyph masks for digits 0-9 (standard seven-segment-ish bitmaps)
_GLYPHS = [
    "01110100011001110101110011000101110",
    "00100011000010000100001000010001110",
    "01110100010000100110010001000111111",
    "01110100010000101110000011000101110",
    "00010001100101010010111110001000010",
    "11111100001111000001000011000101110",
    "01110100011000011110100011000101110",
    "11111000010001000100010001000010000",
    "01110100011000101110100011000101110",
    "01110100011000101111000011000101110",
]


def _render_digit(digit: int, rng: _np.random.RandomState) -> _np.ndarray:
    """A 28x28 noisy, randomly-shifted/scaled rendering of a digit glyph."""
    glyph = _np.array([int(c) for c in _GLYPHS[digit]],
                      dtype=_np.float32).reshape(7, 5)
    img = _np.kron(glyph, _np.ones((3, 3), _np.float32))  # 21x15
    h, w = img.shape
    canvas = _np.zeros((28, 28), _np.float32)
    # centered with small jitter — keeps the task learnable from ~1k
    # samples while still exercising spatial invariance
    dy = (28 - h) // 2 + rng.randint(-3, 4)
    dx = (28 - w) // 2 + rng.randint(-3, 4)
    canvas[dy:dy + h, dx:dx + w] = img
    canvas *= rng.uniform(0.6, 1.0)
    canvas += rng.uniform(0, 0.15, canvas.shape)
    return (_np.clip(canvas, 0, 1) * 255).astype(_np.uint8)


def _synth_mnist(num: int, seed: int) -> tuple:
    rng = _np.random.RandomState(seed)
    labels = rng.randint(0, 10, num).astype(_np.int32)
    data = _np.stack([_render_digit(int(l), rng) for l in labels])
    return data[..., None], labels  # HWC with C=1, like the reference


def _read_idx_images(path: str) -> _np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad IDX image magic {magic}"
        data = _np.frombuffer(f.read(), dtype=_np.uint8)
        return data.reshape(num, rows, cols, 1)


def _read_idx_labels(path: str) -> _np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad IDX label magic {magic}"
        return _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.int32)


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._root = os.path.expanduser(root)
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        img = nd.array(self._data[idx], dtype=self._data.dtype, ctx="cpu")
        label = int(self._label[idx])
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    """MNIST handwritten digits (reference ``gluon.data.vision.MNIST``)."""

    _train_files = [("train-images-idx3-ubyte", "train-labels-idx1-ubyte")]
    _test_files = [("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")]
    _synth_sizes = (8192, 2048)

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None, synthetic: Optional[bool] = None,
                 synthetic_size: Optional[int] = None):
        self._train = train
        self._synthetic = synthetic
        self._synthetic_size = synthetic_size
        super().__init__(root, transform)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        img_base, lbl_base = files[0]
        if not self._synthetic:
            for ext in ("", ".gz"):
                ip = os.path.join(self._root, img_base + ext)
                lp = os.path.join(self._root, lbl_base + ext)
                if os.path.exists(ip) and os.path.exists(lp):
                    self._data = _read_idx_images(ip)
                    self._label = _read_idx_labels(lp)
                    return
            if self._synthetic is False:
                raise RuntimeError(
                    f"MNIST files not found under {self._root} and "
                    "synthetic=False; nothing is downloaded")
        n = self._synthetic_size or \
            (self._synth_sizes[0] if self._train else self._synth_sizes[1])
        self._data, self._label = _synth_mnist(
            n, seed=42 if self._train else 1042)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None, **kwargs):
        super().__init__(root, train, transform, **kwargs)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 (reference ``gluon.data.vision.CIFAR10``); reads the binary
    batches when on disk, synthetic color-pattern fallback otherwise."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None, synthetic: Optional[bool] = None,
                 synthetic_size: int = 4096):
        self._train = train
        self._synthetic = synthetic
        self._synthetic_size = synthetic_size
        self._num_classes = 10
        super().__init__(root, transform)

    def _get_data(self):
        if not self._synthetic:
            batches = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                       if self._train else ["test_batch.bin"])
            paths = [os.path.join(self._root, "cifar-10-batches-bin", b)
                     for b in batches]
            if all(os.path.exists(p) for p in paths):
                data, labels = [], []
                for p in paths:
                    raw = _np.fromfile(p, dtype=_np.uint8).reshape(-1, 3073)
                    labels.append(raw[:, 0].astype(_np.int32))
                    data.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                                .transpose(0, 2, 3, 1))
                self._data = _np.concatenate(data)
                self._label = _np.concatenate(labels)
                return
            if self._synthetic is False:
                raise RuntimeError(
                    f"CIFAR10 binaries not found under {self._root}")
        rng = _np.random.RandomState(7 if self._train else 1007)
        n = self._synthetic_size
        self._label = rng.randint(0, self._num_classes, n).astype(_np.int32)
        freq = (self._label[:, None, None] + 1)
        yy = _np.linspace(0, _np.pi, 32)[None, :, None]
        xx = _np.linspace(0, _np.pi, 32)[None, None, :]
        base = _np.sin(freq * yy) * _np.cos(freq * xx)
        imgs = _np.stack([base, base[:, ::-1], base[:, :, ::-1]], axis=-1)
        imgs = imgs + rng.uniform(-0.2, 0.2, imgs.shape)
        self._data = (_np.clip((imgs + 1) / 2, 0, 1) * 255).astype(_np.uint8)


class CIFAR100(CIFAR10):
    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=False, transform=None, **kwargs):
        self._fine = fine_label
        super().__init__(root, train, transform, **kwargs)
        self._num_classes = 100 if fine_label else 20


class ImageFolderDataset(Dataset):
    """Images arranged in ``root/class_x/xxx.jpg`` folders (reference
    ``ImageFolderDataset``). ``.npy`` images load here; decoding the
    other formats comes with ``mx.image`` and raises."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if not path.endswith(".npy"):
            raise NotImplementedError(IMAGE_SLICE)
        img = nd.array(_np.load(path), ctx="cpu")
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
