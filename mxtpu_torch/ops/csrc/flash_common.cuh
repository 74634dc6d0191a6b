// Helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): bf16 packing, the mma.sync.m16n8k16 tile product
// and the global -> shared tile copy. conv3x3.cu uses the first two.
//
// Fragment layout of mma.sync.m16n8k16.row.col (g = lane / 4,
// t4 = lane % 4), which every kernel here indexes by hand:
//   A (16x16, row-major): a0 = A[g][2t4..2t4+1], a1 = A[g+8][2t4..],
//                         a2 = A[g][2t4+8..],     a3 = A[g+8][2t4+8..]
//   B (16x8, "col"):      b0 = B[2t4..2t4+1][g],  b1 = B[2t4+8..2t4+9][g]
//   C (16x8, f32):        c0,c1 = C[g][2t4..],    c2,c3 = C[g+8][2t4..]
// so the C fragments of two neighbouring n-tiles, packed to bf16, are
// exactly the A fragment of their 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kPad = 8;  // bf16 of padding per shared-memory row

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> one register of two bf16; `lo` lands in the low half,
// which mma.sync reads as the element of lower index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one 16x8x16 tile: a is 16x16 row-major, b 16x8 "col".
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r, r+16) and columns [c, c+16) of a row-major
// shared tile with row stride `stride` elements.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int stride, int r, int c, int g, int t4) {
  const __nv_bfloat16* p0 = tile + (r + g) * stride + c + t4 * 2;
  const __nv_bfloat16* p1 = p0 + 8 * stride;
  a[0] = ld_b32(p0);
  a[1] = ld_b32(p1);
  a[2] = ld_b32(p0 + 8);
  a[3] = ld_b32(p1 + 8);
}

// B fragment (16 along the contraction, 8 along n) read from a
// row-major shared tile whose rows run along n and whose columns run
// along the contraction (K in Q K^T): rows [n, n+8), columns [c, c+16).
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* tile, int stride,
                                       int n, int c, int g, int t4) {
  const __nv_bfloat16* p = tile + (n + g) * stride + c + t4 * 2;
  b0 = ld_b32(p);
  b1 = ld_b32(p + 8);
}

// B fragment (16 along the contraction, 8 along n) read from a
// row-major shared tile whose ROWS run along the contraction (V in P V): the two
// halves of each register are two rows of one column, so they are
// gathered with 16-bit loads. Contraction rows [r, r+16), columns
// [c, c+8).
__device__ __forceinline__ void load_b_trans(uint32_t& b0, uint32_t& b1,
                                             const __nv_bfloat16* tile, int stride,
                                             int r, int c, int g, int t4) {
  const uint16_t* p =
      reinterpret_cast<const uint16_t*>(tile) + (r + t4 * 2) * stride + c + g;
  b0 = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[stride]) << 16);
  b1 = static_cast<uint32_t>(p[8 * stride]) |
       (static_cast<uint32_t>(p[9 * stride]) << 16);
}

// Copy `rows` rows of D bf16 (row stride `ld` elements) into a
// kRows x (D + kPad) shared tile, 16 bytes per thread per step; rows
// past `rows` are zero-filled so padded rows hold no NaN.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* gmem,
                                          long long ld, int rows, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kStride = D + kPad;
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(gmem + r * ld + col);
    *reinterpret_cast<uint4*>(smem + r * kStride + col) = val;
  }
}

}  // namespace flash
