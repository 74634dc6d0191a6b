"""The rest of the op set — the port of ``mxtpu/ndarray/ops_extended.py``:
activations and special functions, ``LRN``/``GroupNorm``, resizing and
cropping, the sampling-grid family (``GridGenerator``,
``BilinearSampler``, ``SpatialTransformer``), ``DeformableConvolution``,
``Correlation``, ``SVMOutput``, the ``linalg_*`` family, the tensor
extras, the flat random ops and ``sample_*``, the optimizer update ops,
``im2col``/``col2im``, the masked softmaxes and the v1 aliases, all
registered into the shared ``OP_REGISTRY`` so ``mx.nd``, ``mx.sym`` and
hybridized blocks see them.

Every op is plain PyTorch over the reference's math (the reference is
plain ``jnp``; no Pallas kernel is on this path). Where the port
differs from the reference, deliberately:

- Dtypes are those of jax with 64-bit mode off (the reference's tests
  run it on): ``GridGenerator``'s affine grid and ``index_array`` are
  float32 and int32 where the reference gives float64 and int64.
  ``SpatialTransformer`` keeps its internal affine grid in float64, as
  the reference computes it, and returns the input's dtype.
- ``linalg_syevd`` and ``linalg_gelqf`` return what the device's
  solver gives (LAPACK on the CPU, cuSOLVER on the card): eigenvector
  and Q rows are defined up to sign.
- Gathers and scatters (``BilinearSampler``'s and
  ``DeformableConvolution``'s backward, ``index_add``, ``col2im``,
  ``histogram``) accumulate with atomics on the card, so their
  summation order may change from call to call there.
- The optimizer update ops rebind their state arrays (``mom``,
  ``mean``, ``var``, ``n``, ``z``, ``weight32``), as the reference does;
  with ``out=`` the new weight is written into ``out`` as well (the
  reference ignores ``out``).
- ``unique`` sorts on the array's device; the reference goes through
  numpy on the host.
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from .. import prng, xla_math
from ..base import MXNetError, dtype_torch
from ..context import resolve_device
from . import random as _random
from .ndarray import NDArray, apply_op
from .ops import OP_REGISTRY, register_op, _unary, _softrelu

__all__ = []  # names land in ops.__all__ via register_op


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` for a Python number ``d``, divided elementwise (torch
    turns a division by a host scalar into a reciprocal multiply)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device).expand(
        x.shape)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt: CUDA's is; torch's float32 sqrt on the
    CPU is not, so it goes through float64 there."""
    return torch.sqrt(x) if x.is_cuda else xla_math._sqrt(x)


# ---------------------------------------------------------------------------
# special functions / activations (src/operator/mshadow_op.h,
# nn/activation.cc)
# ---------------------------------------------------------------------------
class _Digamma(torch.autograd.Function):
    """``digamma`` with XLA's float32 expansion at x >= 0.5 (the
    reference's), torch's elsewhere; its derivative is trigamma."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.dtype != torch.float32:
            return torch.digamma(x)
        return torch.where(x >= 0.5, xla_math.digamma(x), torch.digamma(x))

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * torch.polygamma(1, x)


def _gelu(x):
    # jax.nn.gelu(approximate=False): 0.5 x erfc(-x sqrt(1/2))
    return 0.5 * x * torch.special.erfc(-x * math.sqrt(0.5))


def _selu(x):
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    return scale * torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


_unary("digamma", _Digamma.apply)
_unary("log_sigmoid", lambda x: -_softrelu(-x))
_unary("mish", lambda x: x * torch.tanh(_softrelu(x)))
_unary("gelu", _gelu, aliases=("GELU",))  # exact erf form
_unary("selu", _selu)
_unary("softrelu", _softrelu, aliases=("softplus",))
_unary("erfc", torch.special.erfc)


@register_op("elu")
def elu(data, alpha=1.0, **kwargs):
    def _f(x):
        neg = alpha * torch.expm1(torch.where(x > 0, torch.zeros_like(x), x))
        return torch.where(x > 0, x, neg)
    return apply_op(_f, [data], "elu")


@register_op("hard_sigmoid")
def hard_sigmoid(data, alpha=0.2, beta=0.5, **kwargs):
    return apply_op(lambda x: torch.clamp(alpha * x + beta, 0.0, 1.0),
                    [data], "hard_sigmoid")


@register_op("SoftmaxActivation", aliases=("softmax_activation",))
def SoftmaxActivation(data, mode="instance", **kwargs):
    """Deprecated reference op (src/operator/nn/softmax_activation.cc):
    softmax over the last axis ('instance') or over channels ('channel')."""
    axis = -1 if mode == "instance" else 1
    return apply_op(lambda x: torch.softmax(x, dim=axis), [data],
                    "SoftmaxActivation")


# ---------------------------------------------------------------------------
# normalization (nn/lrn.cc, nn/group_norm.cc)
# ---------------------------------------------------------------------------
@register_op("LRN", aliases=("lrn",))
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kwargs):
    """Local response normalization across channels, NCHW (reference
    src/operator/nn/lrn.cc): out = x / (knorm + alpha/nsize * sum_window
    x^2)^beta, the window summed in order over the zero-padded channels."""
    half = (nsize - 1) // 2

    def _f(x):
        C = x.shape[1]
        pads = [0, 0] * (x.ndim - 2) + [half, nsize - 1 - half]
        sq = F.pad(torch.square(x), pads)
        s = sq[:, 0:C]
        for i in range(1, nsize):
            s = s + sq[:, i:i + C]
        return x * torch.pow(knorm + (alpha / nsize) * s, -beta)
    return apply_op(_f, [data], "LRN")


@register_op("GroupNorm", aliases=("groupnorm",))
def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5, **kwargs):
    """Group normalization over channel groups, NC+spatial layout
    (reference src/operator/nn/group_norm.cc); statistics in float32."""
    def _f(x, g, b):
        N, C = x.shape[0], x.shape[1]
        spatial = tuple(x.shape[2:])
        xg = x.reshape((N, num_groups, C // num_groups) + spatial)
        red = tuple(range(2, xg.ndim))
        xf = xg.to(torch.float32)
        mean = torch.mean(xf, dim=red, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=red, keepdim=True)
        xn = ((xg - mean) * torch.rsqrt(var + eps)).to(x.dtype)
        xn = xn.reshape(x.shape)
        shape = (1, C) + (1,) * len(spatial)
        return xn * g.reshape(shape) + b.reshape(shape)
    return apply_op(_f, [data, gamma, beta], "GroupNorm")


# ---------------------------------------------------------------------------
# resize / rearrange (nn/upsampling.cc, tensor/matrix_op.cc)
# ---------------------------------------------------------------------------
def _resize(x, size, method):
    """``jax.image.resize`` on the last two axes: half-pixel centres,
    and for 'bilinear' a triangle kernel widened when shrinking (its
    antialiasing)."""
    if method == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    shrink = size[0] < x.shape[2] or size[1] < x.shape[3]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrink)


@register_op("UpSampling", aliases=("upsampling",))
def UpSampling(*data, scale=1, sample_type="nearest", num_filter=0,
               multi_input_mode="concat", num_args=1, **kwargs):
    """Spatial upsampling, NCHW (reference src/operator/nn/upsampling.cc).
    'nearest' repeats pixels; 'bilinear' resizes with the fixed bilinear
    kernel. Several inputs are each brought to one common size (the
    largest input × scale), then concatenated or summed."""
    arrs = list(data)

    def _up(x):
        if sample_type == "nearest":
            return x.repeat_interleave(scale, dim=2).repeat_interleave(
                scale, dim=3)
        return _resize(x, (x.shape[2] * scale, x.shape[3] * scale),
                       "bilinear")

    if len(arrs) == 1:
        return apply_op(_up, arrs, "UpSampling")

    def _multi(*xs):
        th = max(x.shape[2] for x in xs) * scale
        tw = max(x.shape[3] for x in xs) * scale
        ups = []
        for x in xs:
            if sample_type == "nearest" and th % x.shape[2] == 0 and \
                    tw % x.shape[3] == 0:
                u = x.repeat_interleave(th // x.shape[2], dim=2) \
                    .repeat_interleave(tw // x.shape[3], dim=3)
            else:
                u = _resize(x, (th, tw), sample_type)
            ups.append(u)
        if multi_input_mode == "sum":
            out = ups[0]
            for u in ups[1:]:
                out = out + u
            return out
        return torch.cat(ups, dim=1)
    return apply_op(_multi, arrs, "UpSampling")


@register_op("depth_to_space")
def depth_to_space(data, block_size, **kwargs):
    """DCR rearrange, NCHW (reference tensor/matrix_op.cc
    DepthToSpace): (N, C, H, W) → (N, C/b², H·b, W·b)."""
    b = int(block_size)

    def _f(x):
        N, C, H, W = x.shape
        y = x.reshape(N, b, b, C // (b * b), H, W)
        y = y.permute(0, 3, 4, 1, 5, 2)
        return y.reshape(N, C // (b * b), H * b, W * b)
    return apply_op(_f, [data], "depth_to_space")


@register_op("space_to_depth")
def space_to_depth(data, block_size, **kwargs):
    """Inverse of depth_to_space (reference tensor/matrix_op.cc)."""
    b = int(block_size)

    def _f(x):
        N, C, H, W = x.shape
        y = x.reshape(N, C, H // b, b, W // b, b)
        y = y.permute(0, 3, 5, 1, 2, 4)
        return y.reshape(N, C * b * b, H // b, W // b)
    return apply_op(_f, [data], "space_to_depth")


@register_op("BilinearResize2D", aliases=("_contrib_BilinearResize2D",))
def BilinearResize2D(data, height=None, width=None, scale_height=None,
                     scale_width=None, **kwargs):
    """Bilinear resize, NCHW (reference contrib/bilinear_resize.cc)."""
    def _f(x):
        N, C, H, W = x.shape
        h = int(height) if height else int(round(H * scale_height))
        w = int(width) if width else int(round(W * scale_width))
        return _resize(x, (h, w), "bilinear")
    return apply_op(_f, [data], "BilinearResize2D")


@register_op("reshape_like")
def reshape_like(lhs, rhs, **kwargs):
    return apply_op(lambda a, b: a.reshape(b.shape), [lhs, rhs],
                    "reshape_like")


@register_op("Crop", aliases=("crop",))
def Crop(*data, offset=(0, 0), h_w=(0, 0), center_crop=False, num_args=1,
         **kwargs):
    """Legacy crop op, NCHW (reference src/operator/crop.cc): crop the
    first input to h_w (or to the second input's spatial shape)."""
    arrs = list(data)
    like = tuple(h_w)

    def _f(x, *rest):
        th, tw = like if not rest else rest[0].shape[2:]
        if center_crop:
            oy = (x.shape[2] - th) // 2
            ox = (x.shape[3] - tw) // 2
        else:
            oy, ox = int(offset[0]), int(offset[1])
        return x[:, :, oy:oy + th, ox:ox + tw]
    return apply_op(_f, arrs, "Crop")


# ---------------------------------------------------------------------------
# sampling-grid family (grid_generator.cc, bilinear_sampler.cc,
# spatial_transformer.cc)
# ---------------------------------------------------------------------------
def _affine_grid(theta, H, W):
    """(N, 6) affine params → (N, 2, H, W) normalized sampling grid in
    float64, as the reference builds it (its linspace is float64)."""
    N = theta.shape[0]
    dev = theta.device
    ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float64, device=dev)
    xs = torch.linspace(-1.0, 1.0, W, dtype=torch.float64, device=dev)
    yt, xt = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([xt, yt, torch.ones_like(xt)], dim=0).reshape(
        3, H * W)
    th = theta.reshape(N, 2, 3).to(torch.float32).to(torch.float64)
    return torch.matmul(th, base).reshape(N, 2, H, W)   # (x, y)


def _gather_hw(img, yc, xc):
    """img (..., C, H, W), yc/xc (..., *pos) int → (..., C, *pos):
    img[..., :, yc, xc] per leading index."""
    lead = img.shape[:-3]
    C, H, W = img.shape[-3:]
    pos = yc.shape[len(lead):]
    flat = (yc * W + xc).reshape(lead + (1, -1)).expand(lead + (C, -1))
    out = torch.gather(img.reshape(lead + (C, H * W)), -1, flat)
    return out.reshape(lead + (C,) + tuple(pos))


def _bilinear_sample_raw(x, grid):
    """x (N,C,H,W), grid (N,2,Ho,Wo) normalized [-1,1] (x, y) →
    (N,C,Ho,Wo), zero padding outside (reference bilinear_sampler.cc);
    the arithmetic runs in the grid's dtype."""
    N, C, H, W = x.shape
    gx = (grid[:, 0] + 1.0) * (W - 1) / 2.0        # (N, Ho, Wo)
    gy = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    wdt = torch.promote_types(x.dtype, grid.dtype)

    def corner(xi, yi, w):
        valid = ((xi >= 0) & (xi <= W - 1) & (yi >= 0) &
                 (yi <= H - 1)).to(x.dtype)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        vals = _gather_hw(x, yc, xc)
        return vals.to(wdt) * (w * valid)[:, None]

    out = (corner(x0, y0, (1 - wx) * (1 - wy)) +
           corner(x0 + 1, y0, wx * (1 - wy)) +
           corner(x0, y0 + 1, (1 - wx) * wy) +
           corner(x0 + 1, y0 + 1, wx * wy))
    return out.to(x.dtype)


@register_op("GridGenerator")
def GridGenerator(data, transform_type="affine", target_shape=(0, 0),
                  **kwargs):
    """Sampling-grid generation (reference src/operator/grid_generator.cc).
    'affine': data (N, 6); 'warp': data is a flow field (N, 2, H, W)."""
    H, W = int(target_shape[0]), int(target_shape[1])

    def _f(d):
        if transform_type == "affine":
            return _affine_grid(d, H, W).to(torch.float32)
        n, _, h, w = d.shape
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=d.dtype, device=d.device),
            torch.arange(w, dtype=d.dtype, device=d.device), indexing="ij")
        fx = _div((xs + d[:, 0]) * 2.0, max(w - 1, 1)) - 1.0
        fy = _div((ys + d[:, 1]) * 2.0, max(h - 1, 1)) - 1.0
        return torch.stack([fx, fy], dim=1)
    return apply_op(_f, [data], "GridGenerator")


@register_op("BilinearSampler")
def BilinearSampler(data, grid, cudnn_off=False, **kwargs):
    """Bilinear sampling at grid positions (reference
    src/operator/bilinear_sampler.cc — the STN sampler)."""
    return apply_op(_bilinear_sample_raw, [data, grid], "BilinearSampler")


@register_op("SpatialTransformer")
def SpatialTransformer(data, loc, target_shape=(0, 0),
                       transform_type="affine", sampler_type="bilinear",
                       **kwargs):
    """Spatial transformer network op (reference
    src/operator/spatial_transformer.cc): affine grid from ``loc`` +
    bilinear sampling."""
    H, W = int(target_shape[0]), int(target_shape[1])

    def _f(x, theta):
        return _bilinear_sample_raw(x, _affine_grid(theta, H, W))
    return apply_op(_f, [data, loc], "SpatialTransformer")


# ---------------------------------------------------------------------------
# deformable convolution (contrib/deformable_convolution.cc)
# ---------------------------------------------------------------------------
@register_op("DeformableConvolution",
             aliases=("_contrib_DeformableConvolution",))
def DeformableConvolution(data, offset, weight, bias=None, kernel=(3, 3),
                          stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                          num_filter=None, num_group=1,
                          num_deformable_group=1, no_bias=False, **kwargs):
    """2-D deformable convolution (reference
    src/operator/contrib/deformable_convolution.cc). Offsets (N, 2·K·dg,
    Ho, Wo) perturb each kernel tap's sampling point; sampling is
    bilinear: the deformable im2col tensor from four gathers, then one
    batched matmul (cuBLAS on the card)."""
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    K = kh * kw
    dg = num_deformable_group
    arrs = [data, offset, weight] + \
        ([] if no_bias or bias is None else [bias])

    def _f(x, off, w, *b):
        N, C, H, W = x.shape
        dev = x.device
        Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
        Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
        ky, kx = torch.meshgrid(torch.arange(kh, device=dev),
                                torch.arange(kw, device=dev), indexing="ij")
        ky = ky.reshape(K) * dh
        kx = kx.reshape(K) * dw
        oy = torch.arange(Ho, device=dev) * sh - ph
        ox = torch.arange(Wo, device=dev) * sw - pw
        base_y = ky[:, None, None] + oy[None, :, None]   # (K, Ho, 1)
        base_x = kx[:, None, None] + ox[None, None, :]   # (K, 1, Wo)
        off = off.reshape(N, dg, K, 2, Ho, Wo)
        gy = base_y[None, None].to(off.dtype) + off[:, :, :, 0]
        gx = base_x[None, None].to(off.dtype) + off[:, :, :, 1]
        xg = x.reshape(N, dg, C // dg, H, W)
        y0 = torch.floor(gy)
        x0 = torch.floor(gx)
        wy = gy - y0
        wx = gx - x0

        def corner(yi, xi, wgt):
            valid = ((yi >= 0) & (yi <= H - 1) & (xi >= 0) &
                     (xi <= W - 1)).to(x.dtype)
            yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
            xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
            vals = _gather_hw(xg, yc, xc)     # (N, dg, C/dg, K, Ho, Wo)
            return vals * (wgt * valid)[:, :, None]

        col = (corner(y0, x0, (1 - wy) * (1 - wx)) +
               corner(y0, x0 + 1, (1 - wy) * wx) +
               corner(y0 + 1, x0, wy * (1 - wx)) +
               corner(y0 + 1, x0 + 1, wy * wx))
        col = col.reshape(N, C * K, Ho * Wo)
        O = w.shape[0]
        if num_group == 1:
            out = torch.matmul(w.reshape(O, C * K), col)
        else:
            G = num_group
            colg = col.reshape(N, G, (C // G) * K, Ho * Wo)
            wg = w.reshape(G, O // G, (C // G) * K)
            out = torch.matmul(wg, colg).reshape(N, O, Ho * Wo)
        out = out.to(x.dtype).reshape(N, O, Ho, Wo)
        if b:
            out = out + b[0].reshape(1, -1, 1, 1)
        return out
    return apply_op(_f, arrs, "DeformableConvolution")


# ---------------------------------------------------------------------------
# correlation (src/operator/correlation.cc — FlowNet)
# ---------------------------------------------------------------------------
@register_op("Correlation")
def Correlation(data1, data2, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True,
                **kwargs):
    """Patch correlation between two feature maps (reference
    src/operator/correlation.cc): one output channel per displacement in
    a (2·d/s2+1)² grid; each value is the channel-mean patch product.
    Each displacement multiplies only the rows and columns its output
    reads (the reference rolls the whole padded map; the border keeps
    every read inside it, so the products are the same)."""
    K = int(kernel_size)
    md = int(max_displacement)
    s1, s2 = int(stride1), int(stride2)
    p = int(pad_size)
    kr = (K - 1) // 2
    border = md + kr
    steps = md // s2
    disps = [(dy * s2, dx * s2)
             for dy in range(-steps, steps + 1)
             for dx in range(-steps, steps + 1)]

    def _f(a, b):
        N, C, H, W = a.shape
        ap = F.pad(a, (p, p, p, p))
        bp = F.pad(b, (p, p, p, p))
        Hp, Wp = H + 2 * p, W + 2 * p
        outH = int(math.ceil((Hp - 2 * border) / s1))
        outW = int(math.ceil((Wp - 2 * border) / s1))
        sumelems = K * K * C
        # the window of rows/cols the strided, K-summed output reads
        r0, r1 = border - kr, border + (outH - 1) * s1 + (K - kr)
        c0, c1 = border - kr, border + (outW - 1) * s1 + (K - kr)
        a_win = ap[:, :, r0:r1, c0:c1]
        chans = []
        for dy, dx in disps:
            b_win = bp[:, :, r0 + dy:r1 + dy, c0 + dx:c1 + dx]
            prod = a_win * b_win if is_multiply else -torch.abs(a_win - b_win)
            s = torch.sum(prod, dim=1, keepdim=True)
            if K > 1:
                acc = s[:, :, 0:s.shape[2] - K + 1, 0:s.shape[3] - K + 1]
                for i in range(K):
                    for j in range(K):
                        if i or j:
                            acc = acc + s[:, :, i:i + s.shape[2] - K + 1,
                                          j:j + s.shape[3] - K + 1]
                s = acc
            chans.append(_div(s[:, :, ::s1, ::s1][:, :, :outH, :outW],
                              sumelems))
        return torch.cat(chans, dim=1)
    return apply_op(_f, [data1, data2], "Correlation")


# ---------------------------------------------------------------------------
# SVMOutput (src/operator/svm_output.cc)
# ---------------------------------------------------------------------------
class _SVMOutput(torch.autograd.Function):
    """Identity forward; the backward ignores the head gradient and
    injects the (L1 or squared-L2) hinge gradient."""

    @staticmethod
    def forward(ctx, x, label, margin, reg, use_linear):
        ctx.save_for_backward(x, label)
        ctx.opts = (margin, reg, use_linear)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        x, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.opts
        oh = F.one_hot(label.to(torch.int64), x.shape[-1]).to(x.dtype)
        score_y = torch.sum(x * oh, dim=-1, keepdim=True)
        viol = margin - score_y + x
        if use_linear:
            mask = ((viol > 0) & (oh == 0)).to(x.dtype)
            gx = mask - oh * torch.sum(mask, dim=-1, keepdim=True)
        else:
            v = torch.clamp_min(viol, 0.0) * (1.0 - oh)
            gx = 2.0 * v - 2.0 * oh * torch.sum(v, dim=-1, keepdim=True)
        return gx * reg, None, None, None, None


@register_op("SVMOutput", aliases=("svm_output",))
def SVMOutput(data, label=None, margin=1.0,
              regularization_coefficient=1.0, use_linear=False, **kwargs):
    """Hinge-loss output layer (reference src/operator/svm_output.cc):
    forward is identity; backward ignores the incoming head gradient and
    injects the hinge gradient, like SoftmaxOutput."""
    if label is None:
        return apply_op(lambda x: x, [data], "SVMOutput")
    return apply_op(
        lambda x, l: _SVMOutput.apply(x, l, margin,
                                      regularization_coefficient,
                                      use_linear),
        [data, label], "SVMOutput")


# ---------------------------------------------------------------------------
# linalg family (src/operator/tensor/la_op.cc)
# ---------------------------------------------------------------------------
def _t(a):
    return a.transpose(-1, -2)


@register_op("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, **kwargs):
    def _f(a, b, c):
        a = _t(a) if transpose_a else a
        b = _t(b) if transpose_b else b
        return alpha * (a @ b) + beta * c
    return apply_op(_f, [A, B, C], "linalg_gemm")


@register_op("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **kwargs):
    def _f(a, b):
        t = torch.tril(a) if lower else torch.triu(a)
        t = _t(t) if transpose else t
        return alpha * (b @ t if rightside else t @ b)
    return apply_op(_f, [A, B], "linalg_trmm")


@register_op("linalg_potri")
def linalg_potri(A, **kwargs):
    """Inverse from a Cholesky factor L: (L Lᵀ)⁻¹ via one triangular
    solve for L⁻¹."""
    def _f(L):
        eye = torch.eye(L.shape[-1], dtype=L.dtype,
                        device=L.device).expand(L.shape)
        inv_l = torch.linalg.solve_triangular(L, eye, upper=False)
        return _t(inv_l) @ inv_l
    return apply_op(_f, [A], "linalg_potri")


@register_op("linalg_sumlogdiag")
def linalg_sumlogdiag(A, **kwargs):
    return apply_op(
        lambda a: torch.sum(torch.log(torch.diagonal(a, 0, -2, -1)), dim=-1),
        [A], "linalg_sumlogdiag")


@register_op("linalg_extractdiag")
def linalg_extractdiag(A, offset=0, **kwargs):
    return apply_op(lambda a: torch.diagonal(a, offset, -2, -1), [A],
                    "linalg_extractdiag")


@register_op("linalg_makediag")
def linalg_makediag(A, offset=0, **kwargs):
    def _f(a):
        n = a.shape[-1] + abs(offset)
        out = a.new_zeros(a.shape[:-1] + (n, n))
        idx = torch.arange(a.shape[-1], device=a.device)
        out[..., idx + max(-offset, 0), idx + max(offset, 0)] = a
        return out
    return apply_op(_f, [A], "linalg_makediag")


def _trian_indices(n, offset, lower, device):
    rows, cols = (_np.tril_indices(n, k=offset) if lower
                  else _np.triu_indices(n, k=offset))
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(cols, device=device))


@register_op("linalg_extracttrian")
def linalg_extracttrian(A, offset=0, lower=True, **kwargs):
    """Pack a triangle into a vector (reference la_op ExtractTrian)."""
    def _f(a):
        r, c = _trian_indices(a.shape[-1], offset, lower, a.device)
        return a[..., r, c]
    return apply_op(_f, [A], "linalg_extracttrian")


@register_op("linalg_maketrian")
def linalg_maketrian(A, offset=0, lower=True, **kwargs):
    """Unpack a vector into a triangular matrix (inverse of
    extracttrian): a packed triangle with |offset| k has
    (n-k)(n-k+1)/2 entries."""
    m = A.shape[-1]
    n = int((math.isqrt(8 * m + 1) - 1) // 2) + abs(offset)

    def _f(a):
        r, c = _trian_indices(n, offset, lower, a.device)
        out = a.new_zeros(a.shape[:-1] + (n, n))
        out[..., r, c] = a
        return out
    return apply_op(_f, [A], "linalg_maketrian")


@register_op("linalg_syevd")
def linalg_syevd(A, **kwargs):
    """Symmetric eigendecomposition A = Uᵀ diag(L) U (reference la_op
    syevd: eigenvectors are rows of U, each up to sign)."""
    def _f(a):
        w, v = torch.linalg.eigh(a)
        return _t(v), w
    return apply_op(_f, [A], "linalg_syevd", n_out=2)


@register_op("linalg_det", aliases=("det",))
def linalg_det(A, **kwargs):
    return apply_op(torch.linalg.det, [A], "linalg_det")


@register_op("linalg_slogdet", aliases=("slogdet",))
def linalg_slogdet(A, **kwargs):
    return apply_op(lambda a: tuple(torch.linalg.slogdet(a)), [A],
                    "linalg_slogdet", n_out=2)


@register_op("linalg_inverse", aliases=("inverse",))
def linalg_inverse(A, **kwargs):
    return apply_op(torch.linalg.inv, [A], "linalg_inverse")


@register_op("linalg_gelqf")
def linalg_gelqf(A, **kwargs):
    """LQ factorization A = L·Q with orthonormal Q rows (reference
    la_op gelqf): QR of Aᵀ transposed back."""
    def _f(a):
        q, r = torch.linalg.qr(_t(a))
        return _t(r), _t(q)
    return apply_op(_f, [A], "linalg_gelqf", n_out=2)


# ---------------------------------------------------------------------------
# tensor extras (tensor/histogram.cc, indexing_op.cc, matrix_op.cc,
# nn/moments.cc)
# ---------------------------------------------------------------------------
def _histogram_counts(flat, edges):
    """``jnp.histogram``'s counts: the right-closed last bin, values
    outside the edges dropped, counts in the data's float dtype."""
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], len(edges) - 1, idx)
    counts = torch.zeros(len(edges) + 1, dtype=flat.dtype, device=flat.device)
    counts.index_add_(0, idx, torch.ones_like(flat))
    return counts[1:len(edges)]


@register_op("histogram")
def histogram(data, bins=10, range=None, **kwargs):
    """(counts, bin_edges) like the reference tensor/histogram.cc.
    ``bins`` may be an int (with ``range``) or an NDArray of edges."""
    if isinstance(bins, NDArray):
        def _f(x, edges):
            return _histogram_counts(x.reshape(-1), edges.to(x.dtype)), edges
        return apply_op(_f, [data, bins], "histogram", n_out=2)

    def _g(x):
        flat = x.reshape(-1)
        fdt = flat.dtype if flat.is_floating_point() else torch.float32
        if range is not None:
            lo = torch.tensor(float(range[0]), dtype=fdt, device=x.device)
            hi = torch.tensor(float(range[1]), dtype=fdt, device=x.device)
        else:
            lo, hi = flat.min().to(fdt), flat.max().to(fdt)
        same = hi == lo
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                               hi)
        edges = _linspace(lo, hi, int(bins) + 1)
        return _histogram_counts(flat.to(fdt), edges), edges.to(x.dtype)
    return apply_op(_g, [data], "histogram", n_out=2)


def _linspace(lo, hi, num):
    """``jnp.linspace(lo, hi, num)`` for 0-d tensors, as jax computes it:
    lo + i·(hi - lo)/(num - 1), the last point exactly hi."""
    step = (hi - lo) / torch.tensor(num - 1, dtype=lo.dtype, device=lo.device)
    i = torch.arange(num, dtype=lo.dtype, device=lo.device)
    out = lo + i * step
    out[-1] = hi
    return out


@register_op("khatri_rao")
def khatri_rao(*matrices, **kwargs):
    """Column-wise Kronecker product (reference contrib/krprod.cc)."""
    def _f(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = (out[:, None, :] * m[None, :, :]).reshape(
                out.shape[0] * m.shape[0], out.shape[1])
        return out
    return apply_op(_f, list(matrices), "khatri_rao")


@register_op("batch_take")
def batch_take(a, indices, **kwargs):
    """out[i] = a[i, indices[i]] (reference tensor/indexing_op.cc)."""
    return apply_op(
        lambda x, idx: torch.gather(x, 1, idx.to(torch.int64)[:, None])[:, 0],
        [a, indices], "batch_take")


@register_op("argmax_channel")
def argmax_channel(data, **kwargs):
    return apply_op(lambda x: torch.argmax(x, dim=1).to(torch.float32),
                    [data], "argmax_channel")


@register_op("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None, **kwargs):
    def _f(a, b):
        if lhs_axes is not None:
            shape = list(a.shape)
            for la, ra in zip(lhs_axes, rhs_axes):
                shape[la % a.ndim] = b.shape[ra % b.ndim]
            return a.expand(tuple(shape))
        return a.expand(b.shape)
    return apply_op(_f, [lhs, rhs], "broadcast_like")


@register_op("unravel_index")
def unravel_index(data, shape=None, **kwargs):
    """(N,) flat indices → (k, N) coordinates (reference
    tensor/ravel.cc); out-of-range indices clip, as jax's do."""
    def _f(x):
        idx = x.to(torch.int64)
        coords = [None] * len(shape)
        for i, s in reversed(list(enumerate(shape))):
            idx, coords[i] = torch.div(idx, s, rounding_mode="floor"), \
                torch.remainder(idx, s)
        oob_pos, oob_neg = idx > 0, idx < -1
        coords = [torch.where(oob_pos, s - 1, torch.where(oob_neg, 0, c))
                  for s, c in zip(shape, coords)]
        return torch.stack(coords, dim=0).to(x.dtype)
    return apply_op(_f, [data], "unravel_index")


@register_op("ravel_multi_index")
def ravel_multi_index(data, shape=None, **kwargs):
    """(k, N) coordinates → (N,) flat indices, each coordinate clipped."""
    def _f(x):
        xi = x.to(torch.int64)
        out = torch.zeros_like(xi[0])
        stride = 1
        for i in reversed(range(xi.shape[0])):
            out = out + torch.clamp(xi[i], 0, shape[i] - 1) * stride
            stride *= shape[i]
        return out.to(x.dtype)
    return apply_op(_f, [data], "ravel_multi_index")


@register_op("index_add", aliases=("_contrib_index_add",))
def index_add(data, index, value, **kwargs):
    """out = data with out[index[i]] += value[i] along dim 0 (reference
    contrib/index_add.cc); duplicate indices accumulate."""
    return apply_op(
        lambda x, idx, v: x.index_add(0, idx.to(torch.int64), v.to(x.dtype)),
        [data, index, value], "index_add")


@register_op("moments")
def moments(data, axes=None, keepdims=False, **kwargs):
    """(mean, var) over ``axes`` (reference src/operator/nn/moments.cc)."""
    def _f(x):
        ax = tuple(axes) if axes is not None else tuple(range(x.ndim))
        mean = torch.mean(x, dim=ax, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=ax, keepdim=keepdims)
        return (mean if keepdims else mean.reshape(var.shape)), var
    return apply_op(_f, [data], "moments", n_out=2)


@register_op("roll")
def roll(data, shift=None, axis=None, **kwargs):
    sh = tuple(shift) if isinstance(shift, (list, tuple)) else shift
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if ax is None:
        return apply_op(lambda x: torch.roll(x, sh), [data], "roll")
    return apply_op(lambda x: torch.roll(x, sh, ax), [data], "roll")


@register_op("rot90")
def rot90(data, k=1, axes=(0, 1), **kwargs):
    return apply_op(lambda x: torch.rot90(x, k, tuple(axes)), [data],
                    "rot90")


@register_op("ediff1d")
def ediff1d(data, **kwargs):
    return apply_op(lambda x: torch.diff(x.reshape(-1)), [data], "ediff1d")


@register_op("searchsorted")
def searchsorted(a, v, side="left", **kwargs):
    return apply_op(
        lambda x, q: torch.searchsorted(x, q, side=side).to(torch.float32),
        [a, v], "searchsorted")


@register_op("index_array")
def index_array(data, axes=None, **kwargs):
    """Index coordinates of every element (reference
    contrib/index_array.cc): output (…, k), int32."""
    def _f(x):
        ax = tuple(axes) if axes is not None else tuple(range(x.ndim))
        grids = torch.meshgrid(*[torch.arange(s, device=x.device)
                                 for s in x.shape], indexing="ij")
        return torch.stack([grids[a] for a in ax], dim=-1).to(torch.int32)
    return apply_op(_f, [data], "index_array")


@register_op("trace")
def trace_op(data, offset=0, axis1=0, axis2=1, **kwargs):
    return apply_op(
        lambda x: torch.sum(torch.diagonal(x, offset, axis1, axis2), dim=-1),
        [data], "trace")


@register_op("unique")
def unique_op(data, **kwargs):
    """Sorted unique values, on the array's device (eager only: the
    output shape depends on the data, so no graph holds it)."""
    x = data._data if isinstance(data, NDArray) else torch.as_tensor(data)
    if x.is_meta:
        raise MXNetError("unique: the output shape depends on the data; "
                         "it cannot be inferred")
    return NDArray(torch.unique(x.detach().reshape(-1), sorted=True))


@register_op("scatter_set_nd", aliases=("_scatter_set_nd",))
def scatter_set_nd(lhs, rhs, indices, shape=None, **kwargs):
    """lhs with lhs[indices] = rhs (reference _scatter_set_nd)."""
    def _f(a, b, idx):
        ii = tuple(idx.to(torch.int64))
        return a.index_put(ii, b.to(a.dtype))
    return apply_op(_f, [lhs, rhs, indices], "scatter_set_nd")


@register_op("fill_element_0index")
def fill_element_0index(lhs, mhs, rhs, **kwargs):
    """out[i, rhs[i]] = mhs[i] (legacy reference op)."""
    def _f(a, m, r):
        rows = torch.arange(a.shape[0], device=a.device)
        return a.index_put((rows, r.to(torch.int64)), m.to(a.dtype))
    return apply_op(_f, [lhs, mhs, rhs], "fill_element_0index")


@register_op("cast_storage")
def cast_storage(data, stype="default", **kwargs):
    """Storage-type conversion (reference tensor/cast_storage):
    default/row_sparse/csr."""
    return data if data.stype == stype else data.tostype(stype)


@register_op("IdentityAttachKLSparseReg")
def IdentityAttachKLSparseReg(data, sparseness_target=0.1,
                              penalty=0.001, momentum=0.9, **kwargs):
    """Identity forward (the KL sparsity penalty is a training-time
    regularizer folded into the loss, as in the reference)."""
    return apply_op(lambda x: x, [data], "IdentityAttachKLSparseReg")


# ---------------------------------------------------------------------------
# legacy flat random-op names (src/operator/random/sample_op.cc):
# random_* take scalar params + shape; sample_* take per-element
# parameter ARRAYS and append `shape` draws per element
# ---------------------------------------------------------------------------
@register_op("random_uniform", aliases=("_random_uniform",))
def random_uniform(low=0.0, high=1.0, shape=(1,), dtype="float32",
                   ctx=None, **kwargs):
    return _random.uniform(low, high, shape, dtype, ctx)


@register_op("random_normal", aliases=("_random_normal",))
def random_normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32",
                  ctx=None, **kwargs):
    return _random.normal(loc, scale, shape, dtype, ctx)


@register_op("random_gamma", aliases=("_random_gamma",))
def random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32",
                 ctx=None, **kwargs):
    return _random.gamma(alpha, beta, shape, dtype, ctx)


@register_op("random_exponential", aliases=("_random_exponential",))
def random_exponential(lam=1.0, shape=(1,), dtype="float32", ctx=None,
                       **kwargs):
    return _random.exponential(1.0 / lam, shape, dtype, ctx)


@register_op("random_poisson", aliases=("_random_poisson",))
def random_poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None,
                   **kwargs):
    return _random.poisson(lam, shape, dtype, ctx)


def _sample_op(name, drawer):
    """A ``sample_*`` op: parameter arrays (or numbers) broadcast
    against ``shape`` extra draws per element, drawn in float64 as the
    reference's 64-bit jax draws them, then cast to ``dtype``."""
    @register_op(name)
    def op(*params, shape=None, dtype="float32", **kwargs):
        dev = next((p._data.device for p in params
                    if isinstance(p, NDArray)), None) or resolve_device(None)
        ps = [p._data if isinstance(p, NDArray) else
              torch.as_tensor(p, device=dev) for p in params]
        extra = _random._shape(shape)
        out_shape = tuple(ps[0].shape) + extra
        if dev.type == "meta":          # mx.sym's inference: no draw
            return NDArray(torch.empty(out_shape, dtype=dtype_torch(dtype),
                                       device=dev))
        pb = [p.reshape(tuple(p.shape) + (1,) * len(extra)) for p in ps]
        val = drawer(_random._next_key(dev), pb, out_shape)
        return NDArray(val.to(dtype_torch(dtype)))
    op.__name__ = name
    return op


def _f64(t):
    return t.to(torch.float64)


def _draw_uniform(k, p, s):
    return prng.uniform(k, s, torch.float64) * _f64(p[1] - p[0]) + _f64(p[0])


def _draw_normal(k, p, s):
    return prng.normal(k, s, torch.float64) * _f64(p[1]) + _f64(p[0])


def _draw_gamma(k, p, s):
    return prng.gamma(k, torch.broadcast_to(_f64(p[0]), s), s,
                      torch.float64) * _f64(p[1])


def _draw_exponential(k, p, s):
    e = prng.exponential(k, s, torch.float64)
    return e / torch.broadcast_to(_f64(p[0]), s)


def _draw_poisson(k, p, s):
    return prng.poisson(k, torch.broadcast_to(p[0], s), s).to(torch.float32)


_sample_op("sample_uniform", _draw_uniform)
_sample_op("sample_normal", _draw_normal)
_sample_op("sample_gamma", _draw_gamma)
_sample_op("sample_exponential", _draw_exponential)
_sample_op("sample_poisson", _draw_poisson)


@register_op("sample_multinomial", aliases=("_sample_multinomial",))
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                       **kwargs):
    n = _random._shape(shape)
    if isinstance(data, NDArray) and data._data.is_meta:
        out_shape = tuple(data.shape[:-1]) + n
        out = NDArray(torch.empty(out_shape, dtype=dtype_torch(dtype),
                                  device="meta"))
        return (out, NDArray(torch.empty(out_shape, dtype=data.dtype,
                                         device="meta"))) if get_prob else out
    return _random.multinomial(data, n, get_prob, dtype)


@register_op("shuffle", aliases=("_shuffle",))
def shuffle(data, **kwargs):
    if isinstance(data, NDArray) and data._data.is_meta:
        return NDArray(torch.empty_like(data._data))
    return _random.shuffle(data)


# ---------------------------------------------------------------------------
# optimizer update ops (src/operator/optimizer_op.cc): return the new
# weight; state buffers (mom/mean/var/n/z/weight32) are rebound to their
# new values on the NDArrays passed in, as the reference rebinds them.
# No call reads anything back to the host.
# ---------------------------------------------------------------------------
def _prep_grad(g, rescale_grad, clip_gradient):
    g = g * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _state(*arrays):
    """The tensors of state arrays, outside any autograd graph."""
    return [a._data.detach() for a in arrays]


def _updated(arrays, new, name, out):
    """The new weight as an op of ``arrays`` (the weight, and for the
    stateless rules the gradient: those the reference differentiates),
    written into ``out`` too when given."""
    res = apply_op(new, list(arrays), name)
    if out is None:
        return res
    out._set_data(res._data)
    return out


@register_op("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, out=None, **kwargs):
    def _f(w, g):
        g = _prep_grad(g, rescale_grad, clip_gradient)
        return w - lr * (g + wd * w)
    return _updated([weight, grad], _f, "sgd_update", out)


@register_op("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None, **kwargs):
    g, m, w0 = _state(grad, mom, weight)
    g = _prep_grad(g, rescale_grad, clip_gradient)
    new_mom = momentum * m - lr * (g + wd * w0)
    mom._set_data(new_mom)
    return _updated([weight], lambda w: w + new_mom, "sgd_mom_update", out)


@register_op("nag_mom_update")
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None, **kwargs):
    gr, m, w0 = _state(grad, mom, weight)
    g = _prep_grad(gr, rescale_grad, clip_gradient) + wd * w0
    new_mom = momentum * m + g
    mom._set_data(new_mom)
    return _updated([weight], lambda w: w - lr * (g + momentum * new_mom),
                    "nag_mom_update", out)


@register_op("adam_update")
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9,
                beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, out=None, **kwargs):
    gr, m0, v0, w0 = _state(grad, mean, var, weight)
    g = _prep_grad(gr, rescale_grad, clip_gradient) + wd * w0
    m = beta1 * m0 + (1 - beta1) * g
    v = beta2 * v0 + (1 - beta2) * g * g
    mean._set_data(m)
    var._set_data(v)
    return _updated([weight], lambda w: w - lr * m / (_sqrt(v) + epsilon),
                    "adam_update", out)


@register_op("adamw_update", aliases=("_adamw_update",))
def adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 rescale_grad=1.0, clip_gradient=-1.0, out=None, **kwargs):
    gr, m0, v0 = _state(grad, mean, var)
    g = _prep_grad(gr, rescale_grad, clip_gradient)
    m = beta1 * m0 + (1 - beta1) * g
    v = beta2 * v0 + (1 - beta2) * g * g
    mean._set_data(m)
    var._set_data(v)
    return _updated(
        [weight],
        lambda w: w - eta * (lr * m / (_sqrt(v) + epsilon) + wd * w),
        "adamw_update", out)


@register_op("signsgd_update")
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, out=None, **kwargs):
    def _f(w, g):
        g = _prep_grad(g, rescale_grad, clip_gradient)
        return w - lr * (torch.sign(g) + wd * w)
    return _updated([weight, grad], _f, "signsgd_update", out)


@register_op("rmsprop_update")
def rmsprop_update(weight, grad, n, lr=0.01, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, out=None,
                   **kwargs):
    gr, n0, w0 = _state(grad, n, weight)
    g = _prep_grad(gr, rescale_grad, clip_gradient) + wd * w0
    new_n = gamma1 * n0 + (1 - gamma1) * g * g
    n._set_data(new_n)
    return _updated([weight], lambda w: w - lr * g / _sqrt(new_n + epsilon),
                    "rmsprop_update", out)


@register_op("ftrl_update")
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0,
                wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, out=None,
                **kwargs):
    gr, z0, n0, w0 = _state(grad, z, n, weight)
    g = _prep_grad(gr, rescale_grad, clip_gradient)
    new_n = n0 + g * g
    sigma = _div(_sqrt(new_n) - _sqrt(n0), lr)
    new_z = z0 + g - sigma * w0
    z._set_data(new_z)
    n._set_data(new_n)

    def _f(w):
        shrunk = -(new_z - torch.sign(new_z) * lamda1) / (
            _div(beta + _sqrt(new_n), lr) + wd)
        return torch.where(torch.abs(new_z) <= lamda1,
                           torch.zeros_like(shrunk), shrunk).to(w.dtype)
    return _updated([weight], _f, "ftrl_update", out)


@register_op("mp_sgd_update")
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, out=None, **kwargs):
    """Multi-precision SGD: the float32 master weight updated, the
    low-precision weight re-derived from it (reference mp_sgd_update)."""
    gr, w32 = _state(grad, weight32)
    g = _prep_grad(gr.to(torch.float32), rescale_grad, clip_gradient)
    new32 = w32 - lr * (g + wd * w32)
    weight32._set_data(new32)
    return _updated([weight], lambda w: new32.to(w.dtype), "mp_sgd_update",
                    out)


@register_op("all_finite")
def all_finite(data, init_output=True, **kwargs):
    return apply_op(
        lambda x: torch.isfinite(x).all().to(torch.float32).reshape(1),
        [data], "all_finite")


@register_op("multi_all_finite")
def multi_all_finite(*data, num_arrays=None, init_output=True, **kwargs):
    def _f(*xs):
        fin = torch.stack([torch.isfinite(x).all() for x in xs]).all()
        return fin.to(torch.float32).reshape(1)
    return apply_op(_f, list(data), "multi_all_finite")


# ---------------------------------------------------------------------------
# im2col / col2im (src/operator/nn/im2col.cc), masked softmaxes
# ---------------------------------------------------------------------------
@register_op("im2col")
def im2col(data, kernel=(3, 3), stride=(1, 1), dilate=(1, 1),
           pad=(0, 0), **kwargs):
    """Unfold patches into columns (reference nn/im2col): NCHW →
    (N, C·kh·kw, Ho·Wo), channels outermost."""
    return apply_op(
        lambda x: F.unfold(x, tuple(kernel), tuple(dilate), tuple(pad),
                           tuple(stride)),
        [data], "im2col")


@register_op("col2im")
def col2im(data, output_size=None, kernel=(3, 3), stride=(1, 1),
           dilate=(1, 1), pad=(0, 0), **kwargs):
    """Fold columns back, summing overlaps — im2col's transpose
    (reference nn/col2im)."""
    return apply_op(
        lambda c: F.fold(c, tuple(output_size), tuple(kernel), tuple(dilate),
                         tuple(pad), tuple(stride)),
        [data], "col2im")


def _masked(x, m, temperature):
    mb = m.to(torch.bool)
    neg = torch.finfo(x.dtype).min
    return mb, torch.where(mb, _div(x, temperature), torch.full_like(x, neg))


@register_op("masked_softmax")
def masked_softmax(data, mask=None, axis=-1, temperature=1.0, **kwargs):
    """softmax over positions where mask is true; exact zeros elsewhere
    (reference nn/masked_softmax)."""
    if mask is None:
        return apply_op(lambda x: torch.softmax(_div(x, temperature), axis),
                        [data], "masked_softmax")

    def _f(x, m):
        mb, z = _masked(x, m, temperature)
        y = torch.softmax(z, axis)
        return torch.where(mb, y, torch.zeros_like(y))
    return apply_op(_f, [data, mask], "masked_softmax")


@register_op("masked_log_softmax")
def masked_log_softmax(data, mask=None, axis=-1, temperature=1.0,
                       **kwargs):
    if mask is None:
        return apply_op(
            lambda x: torch.log_softmax(_div(x, temperature), axis),
            [data], "masked_log_softmax")

    def _f(x, m):
        mb, z = _masked(x, m, temperature)
        y = torch.log_softmax(z, axis)
        return torch.where(mb, y, torch.full_like(y, -math.inf))
    return apply_op(_f, [data, mask], "masked_log_softmax")


# v1 aliases + lowercase contrib alias (in ``mx.nd`` too)
for _alias, _name in (("Convolution_v1", "Convolution"),
                      ("Pooling_v1", "Pooling"),
                      ("bilinear_resize2d", "BilinearResize2D")):
    register_op(_alias)(OP_REGISTRY[_name])
