"""The int8 ResNet-50 of ``chip_smoke.py``'s ``op_set`` phase, and the
bound its check uses, measured on the CPU.

    python -m mxtpu_torch.tools.int8_tolerance [--batch 8] [--image 224]

Builds the model zoo's ResNet-50 (``resnet50_v1``, 1000 classes, float32,
NCHW; Xavier weights after ``mx.random.seed(0)``, BatchNorm at its
initial statistics), quantizes it with ``contrib.quantization
.quantize_net`` (naive calibration over 4 batches of seeded normal
images) and prints, as one JSON line, the relative distance
``||int8 - f32|| / ||f32||`` of the logits of one more batch, beside
the same distance with a planted fault (every activation threshold
halved, so half the range clips). ``chip_smoke.py`` runs the same
functions on the card at batch 64 (calibration) and 256 (evaluation).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

__all__ = ["resnet50", "images", "quantize", "logits_rel"]

SEED = 0
CALIB_BATCHES = 4


def resnet50(ctx, image=224):
    """The zoo's ResNet-50 on ``ctx`` (seeded Xavier weights), its
    shapes resolved, hybridized."""
    import mxtpu_torch as mx
    mx.random.seed(SEED)
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v1", classes=1000)
    net.initialize(mx.initializer.Xavier(magnitude=2), ctx=ctx)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 3, image, image), ctx=ctx))
    net.hybridize()
    return net


def images(n, image, seed) -> np.ndarray:
    """``n`` seeded standard-normal NCHW images (normalized input)."""
    return np.random.default_rng(seed).standard_normal(
        (n, 3, image, image)).astype(np.float32)


def quantize(net, batch, image, ctx, calib_mode="naive"):
    """``quantize_net`` of ``net`` over CALIB_BATCHES batches of
    ``batch`` images; the quantized SymbolBlock, hybridized."""
    import mxtpu_torch as mx
    from mxtpu_torch.contrib.quantization import quantize_net
    calib = mx.io.NDArrayIter(images(CALIB_BATCHES * batch, image, 1), None,
                              batch_size=batch, ctx=ctx)
    qnet = quantize_net(net, calib_data=calib, calib_mode=calib_mode,
                        num_calib_batches=CALIB_BATCHES)
    qnet.hybridize()
    return qnet


def logits_rel(a, b) -> float:
    """||a - b|| / ||b|| of two NDArrays, in float64."""
    a = a._data.double()
    b = b._data.double()
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b))


def _halve_thresholds(qnet):
    """A planted fault: every calibrated activation threshold halved."""
    for node in qnet._sb_symbol._topo():
        if "calib_max" in node.attrs:
            node.attrs["calib_min"] = node.attrs["calib_min"] / 2
            node.attrs["calib_max"] = node.attrs["calib_max"] / 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=224)
    args = ap.parse_args(argv)
    import mxtpu_torch as mx
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    net = resnet50("cpu", args.image)
    qnet = quantize(net, args.batch, args.image, "cpu")
    x = mx.nd.array(images(args.batch, args.image, 2), ctx="cpu")
    with mx.autograd.predict_mode():
        want = net(x)
        got = qnet(x)
        rel = logits_rel(got, want)
        _halve_thresholds(qnet)
        qnet.hybridize()          # drop the graph cached on the old attrs
        faulty = logits_rel(qnet(x), want)
    print(json.dumps({"tool": "int8_tolerance", "batch": args.batch,
                      "image": args.image, "calib_batches": CALIB_BATCHES,
                      "logits_rel": rel, "halved_thresholds_rel": faulty,
                      "max_abs_logit": float(want._data.abs().max()),
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
