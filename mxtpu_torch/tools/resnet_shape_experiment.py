"""The ResNet shape experiment on one NVIDIA card — the port of
``benchmark/resnet_shape_experiment.py``.

    python -m mxtpu_torch.tools.resnet_shape_experiment [--quick]

Probe 2 runs the port's hand-written ``conv3x3`` kernel at the
experiment's shape, (128, 14, 14, 256) → 256 with ``w·0.05``, from a
seeded generator, checks it against ``conv3x3_plain`` (f32 on the same
bf16 values), and times it beside ``F.conv2d`` on the channels-last
view (cuDNN, bf16, the library yardstick; the port never calls it for
this conv) and the plain version, with the bound of the card. Device
times here are ``tools.timing.time_ms``: windows queued behind a spin of
the card, so not the host's cost of a call.

Probe 1 runs ``make_train_step(resnet.loss_fn(cfg), sgd(0.1,
momentum=0.9), has_state=True)`` for ResNet-50 (width 64, batch 256) and
wide-ResNet-50-2 (width 128, batch 128) on 224×224 random bf16 images
and 1000 classes: img/s and step ms over a warmed loop fenced by
``torch.cuda.synchronize()``, FLOPs per step from
``torch.utils.flop_counter.FlopCounterMode`` over one step (the
counterpart of XLA's ``cost_analysis``), MFU against the H100's 989
TFLOP/s bf16 dense peak, and peak memory. For ResNet-50 it also times
the eager f32 BatchNorm passes alone (forward and backward of every BN
of the step at its shape) and traces one step with ``torch.profiler``,
summing device time by kernel group.

Each probe prints JSON objects, one per line; the first line names the
card and its power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import time
from collections import defaultdict
from dataclasses import replace

import torch
import torch.nn.functional as F

from ..models import resnet
from ..ops import conv
from ..parallel import optim, step as pstep
from .timing import time_ms

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
CONV_SHAPE = (128, 14, 14, 256, 256)     # B, H, W, C, O
CONV_TOL = 2e-2            # kernel vs plain, atol = rtol, bf16 output


def conv_flops(b, h, w, c, o):
    """The flops one conv3x3 needs: 2·B·C·O per tap that lands inside
    the image. Along an axis of n outputs the three taps land inside
    3n − 2 times (the two edge outputs lose one each), so the zero halo
    is not counted."""
    return 2 * b * c * o * (3 * h - 2) * (3 * w - 2)


def conv_bound_ms(b, h, w, c, o):
    """(ms, 'operations' | 'bytes'): the least time for one conv3x3:
    ``conv_flops`` at the bf16 peak, or x and w read once and y written
    once (bf16) at the memory rate."""
    flops = conv_flops(b, h, w, c, o)
    nbytes = 2 * (b * h * w * c + 9 * c * o + b * h * w * o)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def conv_inputs(shape, gen):
    """Seeded bf16 x (B, H, W, C) and w (3, 3, C, O)·0.05 on the card."""
    b, h, w, c, o = shape
    x = torch.randn((b, h, w, c), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((3, 3, c, o), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * 0.05
    return x, k


def cudnn_conv3x3(x, w):
    """One PyTorch call computing the same function (the yardstick)."""
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(x.permute(0, 3, 1, 2), wt, padding=1)


def check_conv(x, w, y):
    """The kernel's ``y`` against the plain version in f32 on the same
    bf16 values: max abs error, the reference's largest magnitude, and
    whether ``y`` has the right shape and dtype and agrees within
    ``CONV_TOL`` (atol = rtol)."""
    ref = conv.conv3x3_plain(x.float(), w.float())
    err = (y.float() - ref).abs().max().item()
    ok = (y.shape == ref.shape and y.dtype == torch.bfloat16
          and math.isfinite(err)
          and torch.allclose(y.float(), ref, atol=CONV_TOL, rtol=CONV_TOL))
    return {"max_abs_err": err, "ref_abs_max": ref.abs().max().item(),
            "tol": CONV_TOL, "ok": bool(ok)}


def probe_conv(reps=200, seed=0):
    """Probe 2: one launch of the kernel at the experiment's shape,
    checked against the plain version; with ``reps`` > 0 also the
    times. Raises if the kernel disagrees."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, w = conv_inputs(CONV_SHAPE, gen)
    y = conv.conv3x3(x, w)
    torch.cuda.synchronize()
    bound, bound_by = conv_bound_ms(*CONV_SHAPE)
    row = {"probe": "conv3x3", "shape": list(CONV_SHAPE),
           **check_conv(x, w, y), "bound_ms": bound, "bound_by": bound_by}
    if row["ok"] and reps:
        flops = conv_flops(*CONV_SHAPE)
        row["kernel_ms"] = time_ms(lambda: conv.conv3x3(x, w), reps)
        row["library_ms"] = time_ms(cudnn_conv3x3(x, w), reps)
        row["plain_ms"] = time_ms(lambda: conv.conv3x3_plain(x, w),
                                  max(reps // 20, 3), warmup=1)
        for k in ("kernel", "library"):
            row[f"{k}_tflops"] = flops / row[f"{k}_ms"] / 1e9
        row["bound_share"] = bound / row["kernel_ms"]
    if not row["ok"]:
        raise AssertionError(f"conv3x3 kernel disagrees with its plain "
                             f"version: max abs err {row['max_abs_err']}")
    return row


def bn_shapes(cfg, batch, hw=224):
    """(N, H, W, C) of the input of every BatchNorm of ``forward``."""
    h = -(-hw // 2)                     # stem conv, stride 2
    shapes = [(batch, h, h, cfg.width)]
    h = -(-h // 2)                      # max-pool, stride 2
    for _, stride, cin, mid, cout in resnet._blocks(cfg):
        ho = -(-h // stride)
        if cfg.bottleneck:
            shapes += [(batch, h, h, mid), (batch, ho, ho, mid),
                       (batch, ho, ho, cout)]
        else:
            shapes += [(batch, ho, ho, mid), (batch, ho, ho, cout)]
        if stride != 1 or cin != cout:
            shapes.append((batch, ho, ho, cout))
        h = ho
    return shapes


def bn_passes_ms(cfg, batch, reps=5):
    """Device time of the eager f32 BatchNorm passes of one train step:
    forward (train mode, with the running update) and backward of
    ``resnet._apply_bn`` on a bf16 input of each BN's shape, summed."""
    total = 0.0
    for shape in bn_shapes(cfg, batch):
        c = shape[-1]
        x = torch.randn(shape, device="cuda", dtype=cfg.dtype,
                        requires_grad=True)
        p = {"scale": torch.ones(c, device="cuda", requires_grad=True),
             "bias": torch.zeros(c, device="cuda", requires_grad=True)}
        s = {"mean": torch.zeros(c, device="cuda"),
             "var": torch.ones(c, device="cuda")}
        g = torch.ones(shape, device="cuda", dtype=cfg.dtype)

        def run():
            y = resnet._apply_bn(cfg, x, p, s, True, {}, ("bn",))
            torch.autograd.grad(y, [x, p["scale"], p["bias"]], g)
        total += time_ms(run, reps)
        del x, g
    return total


def _group(name: str) -> str:
    """A kernel's group, from its name: a convolution (cuDNN, forward
    or either backward), a matrix product, or other (the elementwise
    and reduction passes: BatchNorm, ReLU, adds, casts, pooling, the
    optimizer)."""
    n = name.lower()
    if re.search(r"conv|dgrad|wgrad|fprop|implicit|cudnn|xmma_.*nhwc", n):
        return "conv"
    if any(w in n for w in ("gemm", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def profile_step(step, state, batch):
    """One traced step: wall ms, summed device ms by kernel group and
    the 10 kernels that took longest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = defaultdict(float)
    counts = defaultdict(int)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] += ev.device_time_total / 1e3     # us -> ms
            counts[ev.name] += 1
    by_group = defaultdict(float)
    for n, ms in by_name.items():
        by_group[_group(n)] += ms
    kernels = [(ms, n[:90], counts[n]) for n, ms in by_name.items()]
    kernels.sort(reverse=True)
    device = sum(by_group.values())
    return state, {"wall_ms": wall * 1e3, "device_ms": device,
                   "device_busy": device / (wall * 1e3),
                   "by_group_ms": dict(by_group),
                   "top": [{"ms": m, "name": k, "count": c}
                           for m, k, c in kernels[:10]]}


def measure_train(name, width, batch, steps, detail=False, seed=0):
    """Probe 1 for one configuration: a warmed loop of ``steps`` train
    steps on one seeded batch."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = replace(resnet.CONFIGS["resnet50"], width=width)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = resnet.init_params(cfg, gen, device="cuda")
    tx = optim.sgd(0.1, momentum=0.9)
    state = pstep.init_state(params, tx,
                             model_state=resnet.init_state(cfg, "cuda"))
    del params
    step = pstep.make_train_step(resnet.loss_fn(cfg), tx, has_state=True)
    batch_d = {"image": torch.randn((batch, 224, 224, 3), generator=gen,
                                    device="cuda", dtype=torch.bfloat16),
               "label": torch.randint(0, cfg.num_classes, (batch,),
                                      generator=gen, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        state, loss = step(state, batch_d)       # also the first warm step
    flops = counter.get_total_flops()
    state, loss = step(state, batch_d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, batch_d)
    loss = loss.item()                            # fence
    dt = (time.perf_counter() - t0) / steps
    row = {"probe": "train", "name": name, "width": width, "batch": batch,
           "steps": steps, "img_s": batch / dt, "step_ms": dt * 1e3,
           "gflop_per_step": flops / 1e9, "tflops": flops / dt / 1e12,
           "mfu": flops / dt / PEAK_BF16_FLOPS, "loss": loss,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not math.isfinite(loss):
        raise AssertionError(f"{name}: non-finite loss {loss}")
    if detail:
        state, row["profile"] = profile_step(step, state, batch_d)
        del state, step
        torch.cuda.empty_cache()
        row["bn_passes_ms"] = bn_passes_ms(cfg, batch)
        row["bn_share_of_step"] = row["bn_passes_ms"] / row["step_ms"]
    return row


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="8 timed train steps instead of 20")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resnet_shape_experiment needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = 8 if args.quick else 20

    def emit(obj):
        print(json.dumps(obj), flush=True)
    emit({"card": nvidia_smi(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    emit(probe_conv())
    for name, width, batch in (("resnet50 (width 64)", 64, 256),
                               ("wide-50-2 (width 128)", 128, 128)):
        emit(measure_train(name, width, batch, steps, detail=width == 64))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
