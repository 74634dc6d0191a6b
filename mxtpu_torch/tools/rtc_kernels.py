"""Two ``mx.rtc`` user kernels in CUDA C, each with its plain PyTorch
version: what ``chip_smoke.py`` compiles, checks and times on the card,
and what the CPU tests hold against the reference's Pallas kernels of
the same bodies.

Both replace the user kernels the reference ran through
``mxtpu/rtc.py``'s ``PallasKernel.launch`` (``pl.pallas_call`` at
``:80``). Both are elementwise and bound by bytes on an H100: each
element is read and written once, and the arithmetic (2 to 6 f32
operations an element) is under 1/50 of the time the bytes take at
3.35 TB/s. So the design only moves the bytes well: a grid-stride loop
(right for any grid), 16-byte ``float4`` loads for ``scale_add`` and
4-byte ``__nv_bfloat162`` loads for ``swiglu`` when every pointer is
aligned for them, and a scalar loop for the tail and for pointers that
are not. The launch convention's default grid (⌈n/256⌉ blocks of 256
threads, one thread an element) leaves 3/4 or 1/2 of the blocks with
nothing to do, and their scheduling costs about a third of the time:
callers pass :func:`grid`, one thread a vector.

- ``scale_add``: ``out = x·2 + y`` in float32, the reference's test
  kernel (``tests/test_rtc.py``). ``x·2`` is exact, so the fused
  multiply-add rounds once, as ``x * 2 + y`` does: equal bit for bit.
- ``swiglu``: ``out = silu(g)·u`` with bfloat16 inputs and output,
  float32 arithmetic and one rounding (llama's FFN activation).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["SOURCE", "KERNELS", "VECTOR", "module", "grid", "scale_add_plain",
           "swiglu_plain", "scale_add_library"]

SOURCE = r"""
// mx.rtc user kernels for sm_90a; they replace the Pallas user kernels
// of mxtpu/rtc.py (PallasKernel.launch). Bound by bytes: see
// mxtpu_torch/tools/rtc_kernels.py.

extern "C" __global__ void scale_add(const float* __restrict__ x,
                                     const float* __restrict__ y,
                                     float* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if ((((unsigned long long)x | (unsigned long long)y
        | (unsigned long long)out) & 15) == 0) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long j = i; j < n4; j += stride) {
      const float4 a = x4[j], b = y4[j];
      o4[j] = make_float4(a.x * 2.0f + b.x, a.y * 2.0f + b.y,
                          a.z * 2.0f + b.z, a.w * 2.0f + b.w);
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride)
    out[j] = x[j] * 2.0f + y[j];
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

extern "C" __global__ void swiglu(const __nv_bfloat16* __restrict__ g,
                                  const __nv_bfloat16* __restrict__ u,
                                  __nv_bfloat16* __restrict__ out,
                                  long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if ((((unsigned long long)g | (unsigned long long)u
        | (unsigned long long)out) & 3) == 0) {
    const long long n2 = n / 2;
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(g);
    const __nv_bfloat162* u2 = reinterpret_cast<const __nv_bfloat162*>(u);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out);
    for (long long j = i; j < n2; j += stride) {
      const float2 a = __bfloat1622float2(g2[j]);
      const float2 b = __bfloat1622float2(u2[j]);
      o2[j] = __floats2bfloat162_rn(silu_mul(a.x, b.x), silu_mul(a.y, b.y));
    }
    done = n2 * 2;
  }
  for (long long j = done + i; j < n; j += stride)
    out[j] = __float2bfloat16_rn(
        silu_mul(__bfloat162float(g[j]), __bfloat162float(u[j])));
}
"""
KERNELS = ("scale_add", "swiglu")
VECTOR = {"scale_add": 4, "swiglu": 2}      # elements a thread loads at once


def module():
    """A new ``mx.rtc.CudaModule`` of :data:`SOURCE` exporting both
    kernels (built at its first launch)."""
    from .. import rtc
    return rtc.CudaModule(SOURCE, exports=KERNELS)


def grid(kernel: str, n: int) -> int:
    """Blocks of 256 threads for ``n`` elements, one thread a vector."""
    return max(1, -(-n // (256 * VECTOR[kernel])))


def scale_add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``scale_add``'s plain version: x·2 + y."""
    return x * 2 + y


def scale_add_library(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One PyTorch call computing ``scale_add``, a yardstick only."""
    return torch.add(y, x, alpha=2.0)


def swiglu_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``swiglu``'s plain version: silu(g)·u in float32, rounded once
    to bfloat16."""
    return (F.silu(g.float()) * u.float()).to(torch.bfloat16)
