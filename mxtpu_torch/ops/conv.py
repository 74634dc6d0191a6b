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
port's signature drops it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv3x3", "conv3x3_plain", "conv3x3_kernel"]


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
        if not t.is_contiguous() or t.data_ptr() % 16:
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
    from ._build import check, load_kernels
    lib = load_kernels()
    y = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mxtpu_conv3x3_bf16(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c, o,
            torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "conv3x3_kernel launch")
    conv3x3_kernel.launches += 1
    return y


conv3x3_kernel.launches = 0


def conv3x3(x, w):
    """3×3 stride-1 SAME conv, NHWC bf16: the CUDA kernel on a CUDA
    tensor, :func:`conv3x3_plain` on a CPU tensor. Raises on a wrong
    rank or dtype wherever the tensors lie."""
    _check_args(x, w)
    if x.device.type == "cuda":
        return conv3x3_kernel(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3 runs on cuda or cpu, not {x.device}")
    return conv3x3_plain(x, w)
