// 3x3 stride-1 SAME convolution for Hopper (sm_90a): NHWC bf16 in, f32
// accumulation, bf16 out.
//
// Replaces: benchmark/resnet_shape_experiment.py::pallas_conv3x3 (:80),
// whose pallas_call (:108) pads x by 1 in HBM, assembles the
// (nb*H*W, 9C) im2col patches of each grid cell in VMEM and runs one
// matmul against w reshaped to (9C, O). It computes
//     y[b, h, w, o] = sum_{dy, dx, c} xpad[b, h+dy, w+dx, c] * w[dy, dx, c, o]
// with x (B, H, W, C), w (3, 3, C, O) HWIO and y (B, H, W, O), all bf16,
// contiguous, and a zero halo of one pixel.
//
// Accepts: C % 8 == 0 and O % 8 == 0 (16-byte vectors of channels),
// any B, H, W >= 1; the ragged edges of M = B*H*W and of O are masked
// here. The Python wrapper checks dtype, layout and alignment and raises
// on anything else; this entry point returns cudaErrorInvalidValue.
//
// Design (an implicit GEMM, simple and right first): M = B*H*W output
// pixels, N = O, K = 9*C in the order (dy, dx, c) of w's reshape. Each
// CTA owns a 128-pixel x 128-channel output tile and walks K in 32-wide
// chunks, one tap and 32 input channels at a time. Each thread copies
// 16-byte vectors (8 NHWC channels) of the shifted input pixel straight
// into shared memory with cp.async, and writes zeros where the tap falls
// in the halo or past C (the zero-fill form of cp.async), so neither a
// padded x nor the im2col patches ever reach device memory. The weight
// chunk (32 x 128) is staged beside it. Three stages are in flight, so
// the copies of chunks k+1 and k+2 overlap the products of chunk k. Eight
// warps (2 along M x 4 along N) each own a 64 x 32 tile, load their
// fragments with ldmatrix (.trans for the k-major weight tile) and run
// mma.sync.m16n8k16 (bf16 in, f32 accumulators in registers). Shared
// rows are padded by 8 bf16 so ldmatrix hits 32 distinct banks.
//
// Bound at the experiment's shape (B=128, 14x14, 256->256): the taps
// that land inside the image, 2*B*C*O*(3H-2)*(3W-2) = 26.8 GFLOP (the
// zero halo's 2.8 GFLOP of 2*M*K*N are not needed), 0.0271 ms at 989
// TFLOP/s bf16 dense, against 26.9 MB of x, w and y, 0.008 ms at 3.35
// TB/s: bound by operations. What the design
// does about that: the tile is large enough (128 x 128, 64 f32
// accumulators a thread) that each staged byte feeds 64 mma operations,
// and the copies overlap the products. What it leaves on the table:
// mma.sync instead of wgmma (Hopper's full tensor-core rate needs
// warpgroup MMA), cp.async instead of TMA, no warp specialisation, and a
// 32-wide K chunk (one barrier per 32 of K).
#include "flash_common.cuh"

namespace {

constexpr int kBM = 128;     // output pixels per CTA
constexpr int kBN = 128;     // output channels per CTA
constexpr int kBK = 32;      // input channels of one tap per chunk
constexpr int kStages = 3;
constexpr int kThreads = 256;           // 8 warps: 2 along M x 4 along N
constexpr int kAStride = kBK + 8;       // bf16 per shared row, padded
constexpr int kBStride = kBN + 8;
constexpr int kStageElems = kBM * kAStride + kBK * kBStride;
constexpr int kSmem = kStages * kStageElems * sizeof(__nv_bfloat16);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; with
// `bytes` = 0 nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8. Register i of lane t holds row t / 4,
// columns 2(t % 4) and 2(t % 4) + 1 of matrix i (.trans: of its
// transpose).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ y, int B, int H, int W, int C, int O) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp % 2;  // 64-row slice of the tile
  const int wn = warp / 2;  // 32-column slice
  const long long M = static_cast<long long>(B) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int c_chunks = (C + kBK - 1) / kBK;
  const int n_k = 9 * c_chunks;

  // This thread's share of the A chunk: rows tid/4 and tid/4 + 64
  // (output pixels), channels (tid%4)*8 .. +7 of the chunk. The pixel
  // coordinates are decoded once.
  const int a_col = (tid % 4) * 8;
  int a_b[2], a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + tid / 4 + i * 64;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    a_b[i] = static_cast<int>(mm / (static_cast<long long>(H) * W));
    const int rem = static_cast<int>(mm - static_cast<long long>(a_b[i]) * H * W);
    a_h[i] = rem / W;
    a_w[i] = rem % W;
  }
  // ... of the B chunk: k rows tid/16 and tid/16 + 16, columns
  // (tid%16)*8 .. +7 of the 128 output channels.
  const int b_row = tid / 16;
  const int b_col = (tid % 16) * 8;
  const bool b_n_ok = n0 + b_col < O;

  auto load_chunk = [&](int stage, int kc) {
    __nv_bfloat16* As = smem + stage * kStageElems;
    __nv_bfloat16* Bs = As + kBM * kAStride;
    const int tap = kc / c_chunks;
    const int c0 = (kc - tap * c_chunks) * kBK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    const int c = c0 + a_col;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ih = a_h[i] + dy;
      const int iw = a_w[i] + dx;
      const bool ok = a_ok[i] && c < C && ih >= 0 && ih < H && iw >= 0 && iw < W;
      const __nv_bfloat16* src =
          ok ? x + ((static_cast<long long>(a_b[i]) * H + ih) * W + iw) * C + c : x;
      cp_async16(As + (tid / 4 + i * 64) * kAStride + a_col, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = c0 + b_row + i * 16;
      const bool ok = b_n_ok && k < C;
      const __nv_bfloat16* src =
          ok ? w + (static_cast<long long>(tap) * C + k) * O + n0 + b_col : w;
      cp_async16(Bs + (b_row + i * 16) * kBStride + b_col, src, ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  // Prologue: chunks 0 .. kStages-2 in flight. Every iteration commits
  // one group (empty past the end), so wait_group counts stay aligned.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_chunk(s, s);
    cp_async_commit();
  }

  for (int kc = 0; kc < n_k; ++kc) {
    cp_async_wait<kStages - 2>();  // chunk kc has landed (this thread's part)
    __syncthreads();               // ... every thread's, and chunk kc-1 is consumed
    const int nxt = kc + kStages - 1;
    if (nxt < n_k) load_chunk(nxt % kStages, nxt);
    cp_async_commit();

    const __nv_bfloat16* As = smem + (kc % kStages) * kStageElems;
    const __nv_bfloat16* Bs = As + kBM * kAStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], As + (wm * 64 + mi * 16 + lane % 16) * kAStride + kk +
                                (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: k rows kk..+7 | kk+8..+15, at n and at n + 8
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (kk + lane % 16) * kBStride + wn * 32 + nj * 16 +
                                 (lane / 16) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) flash::mma_16816(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  // Epilogue: C fragment rows g and g+8, columns 2*t4 and 2*t4+1 of
  // each 16x8 tile, rounded to bf16 and stored in pairs.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + wn * 32 + ni * 8 + (lane % 4) * 2;
      if (n >= O) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 64 + mi * 16 + lane / 4 + half * 8;
        if (m < M)
          *reinterpret_cast<uint32_t*>(y + m * O + n) =
              flash::pack_bf16(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take. x, w and y
// are contiguous bf16 with 16-byte aligned bases.
int mxtpu_conv3x3_bf16(const void* x, const void* w, void* y, int B, int H, int W,
                       int C, int O, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 8 || O < 8 || C % 8 || O % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * H * W;
  const long long m_tiles = (M + kBM - 1) / kBM;
  if (m_tiles > 0x7fffffffLL || (O + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(m_tiles), (O + kBN - 1) / kBN);
  conv3x3_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), B, H, W, C, O);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
