// Hopper (sm_90a) building blocks for the port's kernels: TMA tensor
// maps (tiled and im2col) and loads, mbarriers, wgmma shared-memory
// descriptors and instructions, setmaxnreg, and the cluster barrier and
// distributed shared memory. flash_attn_fwd.cu, flash_attn_bwd.cu and
// conv3x3.cu are built on them.
//
// Layouts (all bf16, 128-byte swizzle, every tile 1024-byte aligned):
// a TMA box is 64 columns (128 bytes) x R rows, written to shared
// memory as R rows of 128 bytes with the 16-byte chunks of row r XORed
// by r % 8. A d-wide tile (d = 64 or 128) is d / 64 such boxes, one
// after the other ("column halves").
//  - K-major operand (A or B whose contraction dim runs along the
//    row): rows at 128 B, 8-row groups at SBO = 1024 B, LBO unused; the
//    k-step of 16 columns adds 32 B to the start address inside a box,
//    and columns 64.. start at the next box.
//  - MN-major B operand (contraction dim runs down the rows, V in
//    P V): 8-row groups along the contraction at SBO = 1024 B, 64-column
//    atoms along n at LBO = the box's size in bytes (16 KB for a 128-row
//    box, 8 KB for a 64-row one); the k-step of 16 rows adds 2048 B.
// The m64nNk16 accumulator of a warpgroup is the m16n8 C fragment of
// each warp's 16 rows repeated over N / 8 column blocks: with
// g = lane / 4, t4 = lane % 4 and warp w of the warpgroup,
//   d[4j + 0, 1] = C[16w + g][8j + 2t4 + 0, 1],
//   d[4j + 2, 3] = C[16w + g + 8][8j + 2t4 + 0, 1],
// and the register A operand is the m16n8k16 A fragment of the same
// rows, so two neighbouring 8-column blocks of an accumulator, packed
// to bf16, are the A operand of their 16 columns.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

using EncodeIm2colFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                    void*, const cuuint64_t*, const cuuint64_t*,
                                    const int*, const int*, cuuint32_t, cuuint32_t,
                                    const cuuint32_t*, CUtensorMapInterleave,
                                    CUtensorMapSwizzle, CUtensorMapL2promotion,
                                    CUtensorMapFloatOOBfill);

// A driver function through the runtime's driver entry point, so the
// library needs no -lcuda; null if the driver does not have it.
template <class Fn>
inline Fn driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
             ? reinterpret_cast<Fn>(p)
             : nullptr;
}

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = driver_entry<EncodeTiledFn>("cuTensorMapEncodeTiled");
  return fn;
}

inline EncodeIm2colFn encode_im2col() {
  static const EncodeIm2colFn fn =
      driver_entry<EncodeIm2colFn>("cuTensorMapEncodeIm2col");
  return fn;
}

// Error codes of the encoders below, below every cudaError_t.
constexpr int kErrNoEncode = -1;       // driver has no cuTensorMapEncode*
constexpr int kErrEncodeBase = -1000;  // -1000 - CUresult of a failed encode

// A tensor map over a bf16 tensor of logical shape (b, h, s, d) with
// element strides (st_b, st_h, st_s, 1), as dims (d, s, h, b), for boxes
// of 64 columns x `box_rows` rows of one (h, b), 128-byte swizzled.
// Rows past s are zero-filled by the load, so a ragged tile never reads
// the next head. A dim of size 1 is never stepped, so its stride (which
// the caller may leave arbitrary) is replaced by a packed one that TMA
// accepts (a multiple of 16 bytes). Returns 0, or kErrNoEncode, or
// kErrEncodeBase - CUresult.
inline int encode_bf16_4d(CUtensorMap* map, const void* base, int d, int s,
                          int h, int b, long long st_s, long long st_h,
                          long long st_b, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  const long long e = sizeof(__nv_bfloat16);
  if (s == 1) st_s = d;
  if (h == 1) st_h = st_s * s;
  if (b == 1) st_b = st_h * h;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)(st_s * e), (cuuint64_t)(st_h * e),
                                 (cuuint64_t)(st_b * e)};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncodeBase - static_cast<int>(res);
}

// An im2col tensor map over a contiguous NHWC bf16 tensor x (b, h, w, c),
// as dims (c, w, h, b), for the taps of a 3x3 stride-1 SAME window:
// each load brings `pixels` consecutive output pixels (w fastest, then h,
// then b) x 64 channels, one 128-byte swizzled row a pixel, which is the
// K-major A layout above. The pixel box's corners are (-1, -1) and
// (-1, -1) in (w, h): the walk covers the w positions -1 .. w - 2 of
// each row, the top-left taps of the w outputs. A load whose coordinates
// are (c0, w0 - 1, h0 - 1, b0), with offsets (dx, dy) in 0..2, brings for
// output pixel (b, y, x) of the walk that starts at (b0, h0, w0) the
// input pixel (b, y + dy - 1, x + dx - 1), channels c0 .. c0 + 63; pixels
// outside the image, channels past c and pixels past the last image are
// zeros. Returns 0, or kErrNoEncode, or kErrEncodeBase - CUresult.
inline int encode_bf16_im2col(CUtensorMap* map, const void* base, int b, int h,
                              int w, int c, int pixels) {
  const EncodeIm2colFn encode = encode_im2col();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {c * e, (cuuint64_t)w * c * e,
                                 (cuuint64_t)h * w * c * e};
  const int lower[2] = {-1, -1};  // (w, h)
  const int upper[2] = {-1, -1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, lower, upper, 64, static_cast<cuuint32_t>(pixels), elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncodeBase - static_cast<int>(res);
}

// ---------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that
// lasts about two seconds of SM clock is a broken pipeline, not a slow
// one: it stores to address 0, so the fault surfaces as an illegal
// address at the caller's next synchronisation instead of a hang.
// (__trap() would do the same, but a trap anywhere in a kernel makes
// ptxas hold every warpgroup to the kernel-wide register count and
// ignore the budgets that setmaxnreg raises.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 32)) *reinterpret_cast<volatile int*>(0) = 0;
}

// TMA: the box at coordinates (c0, c1, c2, c3) of `map` (a
// __grid_constant__ parameter) into shared memory at `dst`, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// TMA im2col: the pixels of an encode_bf16_im2col map's walk from
// coordinates (c, w, h, n), each shifted by the tap's (off_w, off_h),
// into shared memory at `dst`, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d_im2col(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c, int w, int h,
                                                   int n, uint16_t off_w,
                                                   uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h),
      "r"(n), "h"(off_w), "h"(off_h)
      : "memory");
}

// TMA: shared memory at `src` into the box at (c0, c1, c2, c3) of `map`;
// rows outside the tensor are not written. Completes in a bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Close this thread's bulk group and wait until its stores have read
// their shared memory (which may then be reused or released).
__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy (TMA stores, wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers (id 0 is __syncthreads'): `count` threads take part,
// those that only signal call bar_arrive.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// Device: thread-block clusters
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier: every thread of every CTA of the cluster arrives
// (releasing its shared-memory writes) and then waits (acquiring the
// others'). Threads may reach it from different code.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of the same shared-memory location in CTA `rank` of the
// cluster, and a 16-byte load from it.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------
// Shared-memory matrix descriptor for a 128-byte-swizzled operand
// starting at shared address `addr` (1024-byte aligned atoms, so the
// base offset is 0); `lbo` and `sbo` in bytes (see the header comment).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Orders this warpgroup's register writes before the wgmmas that read
// them (accumulators, register A operands).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are
// still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator in place around a wgmma_wait: the compiler may not
// move a read of it above the wait, nor a write of it below.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Register budget of the calling warpgroup (every warp of it must run
// it; N a multiple of 8 in [24, 256]).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x and 1/x by the special-function unit (about 2 ulp). The IEEE
// division 1.f / x calls a slow-path subroutine, and a call in a
// warpgroup's code costs it its setmaxnreg budget, as a trap does.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, bf16 inputs, f32 accumulator d (N / 2
// registers a thread). `accumulate` = 0 overwrites d with A * B.
// B comes from shared memory (descriptor db); kTransB = 0: B is
// K-major, 1: MN-major (its n dim contiguous). SS: A from shared memory
// too (K-major descriptor da). RS: A from registers, the m16n8k16 A
// fragment of each warp's 16 rows (see the top of this file).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}

}  // namespace hopper
