"""Synthetic ImageNet-like JPEG records and the bf16 ResNet-50 step they
feed: shared by ``chip_smoke.py``'s ``image_record`` phase and the tools
that measure the image input path (``tools.input_ab``,
``tools.decode_contention``).

The images are those of the reference's
``example/image-classification/train_real_data.py`` (``synth_jpeg_rec``):
photographic-like, a sinusoidal gradient, a class tint and seeded noise,
so that JPEG decoding costs what a photograph's does.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["SynthImages", "write_rec", "build_resnet50_step"]


class SynthImages:
    """Image ``i`` of ``n`` at (h, w), uint8 HWC RGB: one of four
    sinusoidal gradients, a tint on channel ``(i % classes) % 3``, and
    noise from the ``i``-th child of ``SeedSequence(seed)``, so images
    are made on any thread in any order and come out the same."""

    def __init__(self, seed: int, n: int, h: int, w: int,
                 classes: int = 1000):
        self.seeds = np.random.SeedSequence(seed).spawn(n)
        self.hw = (h, w)
        self.classes = classes
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy, xx = yy / h, xx / w
        self.bases = [110 + 60 * np.sin(6.28 * (xx * (1 + k) + yy))
                      for k in range(4)]

    def __call__(self, i: int) -> np.ndarray:
        img = np.repeat(self.bases[i % 4][:, :, None], 3, axis=2)
        img[:, :, (i % self.classes) % 3] += 90.0
        img += 8.0 * np.random.default_rng(self.seeds[i]).standard_normal(
            self.hw + (3,), dtype=np.float32)
        return np.clip(img, 0, 255).astype(np.uint8)


def write_rec(path: str, n: int, make_image, label_of, threads: int,
              quality: int = 95) -> float:
    """An indexed ``.rec`` (and its ``.idx``) of ``make_image(i)`` for
    i < n, labelled ``label_of(i)`` and packed by ``recordio.pack_img``
    at ``quality``: made and encoded on ``threads`` threads (numpy and
    the codec release the interpreter lock), written in order; returns
    the seconds it took."""
    from .. import recordio

    def pack(i):
        return recordio.pack_img(recordio.IRHeader(0, label_of(i), i, 0),
                                 make_image(i), quality)
    t0 = time.perf_counter()
    w = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                   path, "w")
    try:
        with ThreadPoolExecutor(threads) as pool:
            for i, rec in enumerate(pool.map(pack, range(n))):
                w.write_idx(i, rec)
    finally:
        w.close()
    return time.perf_counter() - t0


def build_resnet50_step(lr: float = 0.05, momentum: float = 0.9,
                        wd: float = 1e-4, seed: int = 0, size: int = 224,
                        classes: int = 1000):
    """The zoo's ``resnet50_v1`` on the card in bf16 over float32 master
    weights, behind a block that casts the float32 NCHW batch inside the
    step, trained by sgd through ``Trainer.make_fused_step`` with a mean
    softmax cross-entropy: ``step(data, label)`` returns the loss."""
    import torch
    import mxtpu_torch as mx
    from ..parallel.mesh import create_mesh
    from ..parallel.sharding import P, ShardingRules

    class Cast(mx.gluon.HybridBlock):
        dtype = "float32"

        def hybrid_forward(self, F, x):
            return x.astype(self.dtype)
    mx.random.seed(seed)
    body = mx.gluon.model_zoo.vision.get_model("resnet50_v1",
                                               classes=classes)
    body.initialize(mx.initializer.Xavier(magnitude=2), ctx="cuda")
    with mx.autograd.predict_mode():
        body(mx.nd.NDArray(torch.zeros((2, 3, size, size), device="cuda")))
    cast = Cast(prefix="cast_")
    net = mx.gluon.nn.HybridSequential(prefix="ir_")
    net.add(cast, body)
    net.cast("bfloat16")
    cast.dtype = "bfloat16"
    net.hybridize()
    net.shard(create_mesh(dp=-1), ShardingRules([(r".*", P())]))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": lr, "momentum": momentum,
                                "wd": wd, "multi_precision": True})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    return trainer.make_fused_step(
        net, loss_fn=lambda out, y: loss_fn(out, y).mean(), loss_args=1)
