"""The 3×3 stride-1 SAME convolution of the ResNet shape experiment — the
port of ``benchmark/resnet_shape_experiment.py``'s ``pallas_conv3x3``.

:func:`conv3x3` takes the reference's layout and types: x (B, H, W, C)
bf16 and w (3, 3, C, O) bf16 (HWIO) → (B, H, W, O) bf16, accumulated in
f32, with a zero halo of one pixel. A CPU tensor runs
:func:`conv3x3_plain`, the reference's arithmetic in PyTorch; a CUDA
tensor launches the hand-written implicit-GEMM kernel of
``csrc/conv3x3.cu`` through :func:`conv3x3_kernel`, or raises. There is
no fallback from the kernel to the plain version or to a library
convolution, by shape or by exception. The Pallas kernel's
``images_per_cell`` is a TPU grid choice that changes no result, so the
port's signature drops it; the kernel's own grid is :func:`_conv_plan`.

The launch is the operator ``mxtpu_torch::conv3x3`` (a CUDA
implementation and a fake one that gives its output's shape, as the
flash forward's in ``ops.attention``), so ``torch.export`` keeps one
node per call; the base alignment is checked inside it.

The kernel's work is counted here, beside it (:func:`conv_flops`,
:func:`conv_cost`, :func:`conv_bound_ms`): the kernel and the plain
version both report it to an active perfscope count, so a program
counts the same whichever ran.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..telemetry import perfscope

__all__ = ["conv3x3", "conv3x3_plain", "conv3x3_kernel", "conv_flops",
           "conv_cost", "conv_bound_ms"]

_BM = 128    # output pixels a CTA
_BK = 64     # input channels of one tap a K stage
_SMS = 132   # streaming multiprocessors of an H100 SXM
_SPLIT_STAGES = 27   # the fewest K stages a split pays for (tools.conv_plans)


class ConvPlan(NamedTuple):
    """The kernel's grid: ``m_tiles`` x ``n_tiles`` output tiles of 128
    pixels x ``bn`` channels, each computed by ``split`` (1 or 2) CTAs, a
    cluster along z, that share out the ``9 * chunks`` K stages (one
    tap, 64 input channels each, tap-major) in equal runs."""
    bn: int
    split: int
    m_tiles: int
    n_tiles: int
    chunks: int

    def ctas(self) -> Iterator[Tuple[int, int, Tuple[Tuple[int, int], ...]]]:
        """(first pixel, first channel, its K stages as (tap dy·3 + dx,
        first input channel)) of every CTA, as the kernel maps blockIdx
        (x, y, z) to them."""
        n_k = 9 * self.chunks
        for z in range(self.split):
            stages = tuple((k // self.chunks, k % self.chunks * _BK)
                           for k in range(z * n_k // self.split,
                                          (z + 1) * n_k // self.split))
            for y in range(self.n_tiles):
                for x in range(self.m_tiles):
                    yield x * _BM, y * self.bn, stages


def _conv_plan(b, h, w, c, o) -> ConvPlan:
    """The plan with the least work a CTA while every CTA still has an
    SM of its own: K split in halves when K has at least
    ``_SPLIT_STAGES`` stages (below that the cluster's reduction costs
    more than it saves), before tiles of 64 output channels, before 128.
    A grid that needs more than one round of SMs takes the tile width by
    O: 64 when O <= 64 (no tile computes masked columns), else 128."""
    m_tiles, chunks = -(-b * h * w // _BM), -(-c // _BK)
    for split in (2, 1) if 9 * chunks >= _SPLIT_STAGES else (1,):
        for bn in (64, 128):
            if split * m_tiles * -(-o // bn) <= _SMS:
                return ConvPlan(bn, split, m_tiles, -(-o // bn), chunks)
    bn = 64 if o <= 64 else 128
    return ConvPlan(bn, 1, m_tiles, -(-o // bn), chunks)


def conv_flops(b, h, w, c, o):
    """The flops one conv3x3 needs: 2·B·C·O per tap that lands inside
    the image. Along an axis of n outputs the three taps land inside
    3n − 2 times (the two edge outputs lose one each), so the zero halo
    is not counted."""
    return 2 * b * c * o * (3 * h - 2) * (3 * w - 2)


def conv_cost(b, h, w, c, o):
    """(flops, bytes) of one conv3x3: :func:`conv_flops`, and x and w
    read once and y written once, in bf16."""
    return conv_flops(b, h, w, c, o), \
        2 * (b * h * w * c + 9 * c * o + b * h * w * o)


def conv_bound_ms(b, h, w, c, o, spec=None):
    """(ms, 'operations' | 'bytes'): the least time for one conv3x3
    (:func:`conv_cost`) on the H100, or on ``spec``'s device."""
    return perfscope.bound_ms(*conv_cost(b, h, w, c, o),
                              spec or perfscope.spec_for("h100"))


def _shape(x, w):
    return (*x.shape, w.shape[-1])


def _check_args(x, w):
    """Raise unless x is (B, H, W, C) and w (3, 3, C, O), both bf16."""
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 takes x (B, H, W, C) and w (3, 3, C, O), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 takes bfloat16 x and w, got {x.dtype} and "
                        f"{w.dtype}")


def conv3x3_plain(x, w):
    """The reference's arithmetic: pad x by 1, concatenate the nine
    shifted (H·W, C) slices of each image into (B·H·W, 9C) patches, one
    f32 matmul against ``w.reshape(9C, O)``, and round to x's dtype.
    Takes any float dtype (f32 inputs give the unrounded f32 result)."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dy:dy + h, dx:dx + wd, :].reshape(b * h * wd, c)
                         for dy in range(3) for dx in range(3)], dim=1)
    out = patches.float() @ w.reshape(9 * c, o).float()
    return out.to(x.dtype).reshape(b, h, wd, o)


def conv3x3_kernel(x, w):
    """Launch the CUDA implicit-GEMM kernel on the current stream:
    contiguous bf16 x (B, H, W, C) and w (3, 3, C, O) on one CUDA device,
    C and O multiples of 8, 16-byte aligned; returns a new contiguous
    (B, H, W, O) bf16 tensor. Raises on anything else. ``.launches``
    counts launches."""
    _check_args(x, w)
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"conv3x3_kernel needs x and w on one CUDA "
                             f"device ({name} is on {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"conv3x3_kernel needs contiguous, 16-byte "
                             f"aligned tensors ({name} has strides "
                             f"{t.stride()})")
    b, h, wd, c = x.shape
    o = w.shape[-1]
    if c % 8 or o % 8:
        raise ValueError(f"conv3x3_kernel needs C and O to be multiples of "
                         f"8 (16-byte channel vectors), got C={c}, O={o}")
    if b * h * wd == 0:
        raise ValueError(f"conv3x3_kernel needs a non-empty x, got "
                         f"{tuple(x.shape)}")
    return _launch(x, w, _conv_plan(b, h, wd, c, o))


def _launch(x, w, plan: ConvPlan):
    """Launch the kernel on checked tensors with ``plan``
    (``tools.conv_plans`` times plans other than :func:`_conv_plan`'s)."""
    return perfscope.reported(lambda: conv_cost(*_shape(x, w)),
                              _CONV_OP, x, w, plan.bn, plan.split)


def _launch_plan(x, w, bn: int, split: int):
    from ._build import check, load_kernels
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"conv3x3_kernel needs contiguous, 16-byte "
                             f"aligned tensors ({name} is at "
                             f"{t.data_ptr():#x})")
    lib = load_kernels()
    b, h, wd, c = x.shape
    o = w.shape[-1]
    y = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    # entering a device context costs more than the launch at small shapes
    with (contextlib.nullcontext() if x.device.index
          == torch.cuda.current_device() else torch.cuda.device(x.device)):
        err = lib.mxtpu_conv3x3_bf16(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c, o,
            bn, split, torch._C._cuda_getCurrentRawStream(x.device.index))
    check(err, "conv3x3_kernel launch")
    conv3x3_kernel.launches += 1
    return y


conv3x3_kernel.launches = 0

_LIB = torch.library.Library("mxtpu_torch", "FRAGMENT")
_LIB.define("conv3x3(Tensor x, Tensor w, int bn, int split) -> Tensor")
_LIB.impl("conv3x3", _launch_plan, "CUDA")


@torch.library.register_fake("mxtpu_torch::conv3x3", lib=_LIB)
def _conv_fake(x, w, bn, split):
    return x.new_empty((*x.shape[:3], w.shape[-1]))


_CONV_OP = torch.ops.mxtpu_torch.conv3x3.default


def conv3x3(x, w):
    """3×3 stride-1 SAME conv, NHWC bf16: the CUDA kernel on a CUDA
    tensor, :func:`conv3x3_plain` on a CPU tensor. Raises on a wrong
    rank or dtype wherever the tensors lie."""
    _check_args(x, w)
    if x.device.type == "cuda":
        return conv3x3_kernel(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3 runs on cuda or cpu, not {x.device}")
    return perfscope.reported(lambda: conv_cost(*_shape(x, w)),
                              conv3x3_plain, x, w)
