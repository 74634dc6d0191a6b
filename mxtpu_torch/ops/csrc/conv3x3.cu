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
// Accepts: C % 8 == 0 and O % 8 == 0 (TMA strides are multiples of 16
// bytes), any B, H, W >= 1; the ragged edges of M = B*H*W, of C and of O
// are zero-filled on load and clipped on store. The Python wrapper
// checks dtype, layout and alignment and raises on anything else; this
// entry point returns cudaErrorInvalidValue.
//
// Bound: the taps that land inside the image,
// 2*B*C*O*(3H-2)*(3W-2) flops, against x, w and y moved once. At the
// experiment's shape (B=128, 14x14, 256->256): 26.8 GFLOP, 0.0271 ms at
// 989 TFLOP/s bf16 dense, against 26.9 MB, 0.008 ms at 3.35 TB/s: bound
// by operations, as are ResNet-50's (28x28, 128->128) and (7x7,
// 512->512) at batch 32. Its (56x56, 64->64) at batch 32 is bound by
// bytes (25.7 MB, 0.0077 ms), and so is anything with few channels.
//
// Design: an implicit GEMM with M = B*H*W output pixels, N = O and
// K = 9*C in w's (dy, dx, c) order, in the warp-specialised shape of the
// flash kernels. One K stage is 64 channels of one tap.
//  - A: one TMA im2col load a stage brings the 128 pixels of the CTA's
//    tile for the stage's tap and 64 channels (hopper::encode_bf16_im2col),
//    one 128-byte swizzled row a pixel: the K-major A layout. The tap is
//    the load's (dx, dy) offset; taps in the halo, channels past C and
//    pixels past M come back as zeros, so there is no padded x, no
//    patches in HBM and no address arithmetic in the consumers.
//  - B: w viewed as (O, C, 9) by a tiled map, 64 output channels x 64
//    input channels of one tap a box (input channels past C are zeros,
//    not the next tap's), read MN-major through the descriptor's
//    transpose bit.
//  - Warpgroup 0 gives up registers; one thread keeps a ring of 4-5
//    stages in flight on full/empty mbarriers. Warpgroups 1 and 2 own 64
//    rows each of the 128-row tile and issue SS wgmma m64n{BN}k16, 4 a
//    stage, keeping one stage's group in flight while the next lands.
//  - BN is 64 or 128 output channels (2 CTAs an SM with 96 KB of ring
//    each, or one with a 5-stage 160 KB ring). A grid that fills the card
//    takes BN by O: 64 for O <= 64, so ResNet's 64-channel convs compute
//    no masked columns, else 128.
//  - A grid too thin for the card gives each CTA an SM and as little work
//    as it can (ops/conv.py's _conv_plan): K split in halves when K has
//    27 stages or more, then BN 64 before 128 (as at 7x7, 512->512: 52
//    tiles of 128, 104 CTAs of half a K each for 132 SMs). A split is a
//    cluster of 2 CTAs along z over the first and second half of the
//    9 * ceil(C / 64) stages in (dy, dx, c) order; rank 1 leaves its f32
//    partial tile in its shared memory and the leader adds it through
//    distributed shared memory. One kernel, no atomics, no workspace, the
//    same bits every call. (A split in 3, one kernel row dy a CTA, needed
//    two rounds of clusters at 7x7 and lost to no split at all; at 18
//    stages or fewer the cluster's reduction costs more than it saves.)
//  - Epilogue: accumulators -> bf16 -> the drained ring, in the 128-byte
//    swizzle -> one TMA store a 64 x 64 box of y viewed as (M, O), which
//    clips rows past M and columns past O.
//  - Host: the shared-memory attribute is set once per instantiation and
//    device; the tensor maps are __grid_constant__ parameters.
// Against the mma.sync design it replaces (0.1536 ms at the experiment's
// shape, 17.7 % of its bound): wgmma instead of mma.sync; TMA and one
// producer thread instead of every thread computing addresses for
// cp.async; a 64-wide K stage on mbarriers instead of a 32-wide one
// behind __syncthreads; no masked half-tiles at O = 64; a filled grid at
// 7x7.
// What it leaves on the table: the grid is not persistent, so a CTA's
// prologue and epilogue do not overlap another tile's products (2 CTAs
// an SM hide some of it at BN = 64); the tensor maps are encoded on
// every call; the halo's zero taps are multiplied like the others.
// Tried and not kept: pairs of M tiles in a 2-CTA cluster, each loading
// one of w's two boxes and multicasting it to both (a quarter less L2
// traffic, but the shared empty barriers cost more than that saved), and
// 2 CTAs an SM at BN = 128 (ptxas needs about 90 registers for the
// m64n128 wgmma, above the 80 such a launch holds).
#include <atomic>

#include "hopper_common.cuh"

namespace {

constexpr int kBM = 128;                // output pixels per CTA, 64 a consumer
constexpr int kBK = 64;                 // channels of one tap a stage
constexpr int kThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;   // arrivals that free a stage
constexpr uint32_t kBox = 64 * 128;     // one 64-row x 128-byte box, bytes
constexpr long long kChunk = 1LL << 30;  // pixels a launch (int32 TMA coordinates)
// Named barriers of the consumers (0 is __syncthreads'): both are done
// with the ring, then warpgroup cw's epilogue at kStoreBar + cw.
constexpr int kDrainedBar = 1;
constexpr int kStoreBar = 2;

// Shared memory, in bytes from a 1024-byte aligned base: the ring (each
// stage the A tile, 128 pixel rows x 128 bytes, then B, BN / 64 boxes of
// 64 channel rows x 128 bytes), then the full and empty mbarriers.
template <int BN>
struct Cfg {
  static constexpr int kStages = BN == 64 ? 4 : 5;
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;     // CTAs an SM
  static constexpr int kConsumerRegs = kMinBlocks == 2 ? 96 : 232;
  static constexpr int kProducerRegs = 40;
  static constexpr uint32_t kA = kBM * 128;
  static constexpr uint32_t kStage = kA + (BN / 64) * kBox;
  static constexpr uint32_t kBars = kStages * kStage;
  static constexpr uint32_t kBytes = kBars + 16 * kStages + 1024;  // + alignment slack
  // the setmaxnreg budgets fit in the registers the launch holds
  static_assert(128 * kProducerRegs + 256 * kConsumerRegs <=
                    (65536 / (kThreads * kMinBlocks)) / 8 * 8 * kThreads,
                "register budgets exceed the launch's");
  // a split's f32 partial tile fits in the drained ring
  static_assert(kBM * BN * 4 <= kBars, "the partial tile does not fit");
};

// The 32-bit decode of a pixel index needs no 64-bit division (which
// ptxas compiles to a call, and a call costs every warpgroup its
// setmaxnreg budget): the chunk's first pixel (bs, hs, ws) comes from
// the host and the CTA's pixel is `off` after it.
struct Pixel {
  int b, h, w;
};

__device__ __forceinline__ Pixel decode(uint32_t off, int bs, int hs, int ws, int H,
                                        int W) {
  const uint32_t x = static_cast<uint32_t>(ws) + off;  // < 2^31 + W
  const uint32_t rows = x / static_cast<uint32_t>(W);
  const uint32_t y = static_cast<uint32_t>(hs) + rows;
  return {bs + static_cast<int>(y / static_cast<uint32_t>(H)),
          static_cast<int>(y % static_cast<uint32_t>(H)),
          static_cast<int>(x % static_cast<uint32_t>(W))};
}

template <int BN, int SPLIT>
__global__ void __launch_bounds__(kThreads, Cfg<BN>::kMinBlocks)
conv3x3_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_y, int H, int W, int C, int rows,
               int bs, int hs, int ws) {
  using L = Cfg<BN>;
  static_assert(SPLIT == 1 || SPLIT == 2, "the leader adds one partial tile");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * L::kStages;
  const int m0 = blockIdx.x * kBM;  // this chunk's rows
  const int n0 = blockIdx.y * BN;
  // The cluster's CTAs are its z blocks: rank r takes stages [k_begin,
  // k_begin + n_k) of the 9 * chunks, tap-major.
  const int part = SPLIT > 1 ? static_cast<int>(hopper::cluster_ctarank()) : 0;
  const int chunks = (C + kBK - 1) / kBK;
  const int k_begin = part * 9 * chunks / SPLIT;
  const int n_k = (part + 1) * 9 * chunks / SPLIT - k_begin;
  // Warp-uniform, so the role branches below are not divergent.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    hopper::prefetch_tensormap(&tm_x);
    hopper::prefetch_tensormap(&tm_w);
    hopper::prefetch_tensormap(&tm_y);
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumerThreads);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    hopper::setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      const Pixel p = decode(static_cast<uint32_t>(m0), bs, hs, ws, H, W);
      for (int k = 0; k < n_k; ++k) {
        const int t = (k_begin + k) / chunks;  // tap dy * 3 + dx
        const int c0 = (k_begin + k - t * chunks) * kBK;
        const int s = k % L::kStages;
        const uint32_t phase = (k / L::kStages) & 1;  // round 0 finds stages free
        const uint32_t a = base + s * L::kStage;
        hopper::mbar_wait(empty + 8 * s, phase ^ 1);
        hopper::mbar_arrive_expect_tx(full + 8 * s, L::kStage);
        hopper::tma_load_4d_im2col(a, &tm_x, full + 8 * s, c0, p.w - 1, p.h - 1, p.b,
                                   static_cast<uint16_t>(t % 3), static_cast<uint16_t>(t / 3));
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_4d(a + L::kA + j * kBox, &tm_w, full + 8 * s, n0 + 64 * j, c0, t,
                              0);
      }
    }
    if constexpr (SPLIT > 1) {  // every thread of the cluster meets twice
      hopper::cluster_sync();
      hopper::cluster_sync();
    }
    return;
  }

  // Consumers: warpgroup cw owns tile rows [64 cw, 64 cw + 64).
  hopper::setmaxnreg_inc<L::kConsumerRegs>();
  const int cw = wg - 1;
  const int ct = threadIdx.x - 128;  // 0 .. 255 over both consumers
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // accumulator row within the 8-row group
  const int t4 = lane & 3;  // accumulator column pair

  float acc[BN / 2];
  for (int k = 0; k < n_k; ++k) {
    const int s = k % L::kStages;
    const uint32_t a = base + s * L::kStage + cw * 64 * 128;
    const uint32_t b = base + s * L::kStage + L::kA;
    hopper::mbar_wait(full + 8 * s, (k / L::kStages) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A K-major: 32 bytes a 16-channel step inside the box; B MN-major:
      // 16 channel rows a step = 2048 bytes, 64-column atoms a box apart.
      const uint64_t da = hopper::desc_sw128(a + kk * 32, 16, 1024);
      const uint64_t db = hopper::desc_sw128(b + kk * 2048, kBox, 1024);
      if constexpr (BN == 128)
        hopper::wgmma_ss_m64n128k16<1>(acc, da, db, k > 0 || kk > 0);
      else
        hopper::wgmma_ss_m64n64k16<1>(acc, da, db, k > 0 || kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // stage k - 1's products are done: free it
    if (k > 0) hopper::mbar_arrive(empty + 8 * ((k - 1) % L::kStages));
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  // Both consumers are done with the ring, so it may be overwritten.
  hopper::bar_sync(kDrainedBar, kConsumerThreads);

  unsigned char* smem = smem_raw + (base - hopper::smem_u32(smem_raw));
  if constexpr (SPLIT > 1) {
    // Element 4i + e of consumer thread ct at float4 [i * 256 + ct]:
    // conflict-free, and the leader's thread ct reads the same places.
    float4* part4 = reinterpret_cast<float4*>(smem);
    if (part != 0) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        part4[i * 256 + ct] =
            make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    }
    hopper::cluster_sync();  // the partial is written
    if (part == 0) {
      const uint32_t remote = hopper::map_to_rank(base, 1);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float4 v = hopper::ld_cluster_f32x4(remote + (i * 256 + ct) * 16);
        acc[4 * i] += v.x;
        acc[4 * i + 1] += v.y;
        acc[4 * i + 2] += v.z;
        acc[4 * i + 3] += v.w;
      }
    }
    hopper::cluster_sync();  // the leader has read it
    if (part != 0) return;
  }

  // y: this warpgroup's 64 rows as bf16 at the start of the drained ring
  // (BN / 64 boxes of 64 rows x 128 bytes after the other warpgroup's),
  // in the 128-byte swizzle that TMA expects (16-byte chunk c of row r at
  // chunk c ^ (r % 8)), then one TMA store a box; it clips rows past the
  // chunk and columns past O.
  const uint32_t out = cw * (BN / 64) * kBox;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;  // row % 8 == g
      const uint32_t off = out + (j / 8) * kBox + row * 128 + (((j % 8) ^ g) * 16) + t4 * 4;
      *reinterpret_cast<uint32_t*>(smem + off) =
          hopper::pack_bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
  hopper::fence_proxy_async();
  hopper::bar_sync(kStoreBar + cw, 128);
  if (tid == 0 && m0 + 64 * cw < rows) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      hopper::tma_store_4d(&tm_y, base + out + j * kBox, n0 + 64 * j, m0 + 64 * cw, 0, 0);
    hopper::tma_store_commit_and_wait();
  }
}

// cudaFuncSetAttribute costs microseconds, so it runs once per
// instantiation and device (repeating it is harmless, so a race is too).
template <int BN, int SPLIT>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(conv3x3_kernel<BN, SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::kBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int BN, int SPLIT>
int launch(const void* x, const void* w, void* y, int B, int H, int W, int C, int O,
           cudaStream_t stream) {
  CUtensorMap tm_x, tm_w;
  int err = hopper::encode_bf16_im2col(&tm_x, x, B, H, W, C, kBM);
  // w as (O, C, 9): rows past C of a tap read zeros, not the next tap
  if (err == 0)
    err = hopper::encode_bf16_4d(&tm_w, w, O, C, 9, 1, O, static_cast<long long>(C) * O,
                                 9LL * C * O, kBK);
  if (err != 0) return err;
  cudaError_t cerr = allow_smem<BN, SPLIT>();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = SPLIT;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<BN>::kBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = SPLIT > 1 ? 1 : 0;
  // Launches of at most 2^30 pixels, so every row coordinate is an int.
  const long long hw = static_cast<long long>(H) * W;
  const long long M = B * hw;
  for (long long m = 0; m < M; m += kChunk) {
    const int rows = static_cast<int>(M - m < kChunk ? M - m : kChunk);
    CUtensorMap tm_y;  // this chunk's rows of y viewed as (M, O)
    err = hopper::encode_bf16_4d(&tm_y, static_cast<__nv_bfloat16*>(y) + m * O, O, rows,
                                 1, 1, O, static_cast<long long>(rows) * O,
                                 static_cast<long long>(rows) * O, 64);
    if (err != 0) return err;
    cfg.gridDim = dim3((rows + kBM - 1) / kBM, (O + BN - 1) / BN, SPLIT);
    cerr = cudaLaunchKernelEx(&cfg, conv3x3_kernel<BN, SPLIT>, tm_x, tm_w, tm_y, H, W, C,
                              rows, static_cast<int>(m / hw),
                              static_cast<int>(m % hw / W), static_cast<int>(m % W));
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int SPLIT>
int attrs(int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, conv3x3_kernel<BN, SPLIT>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem_bytes = Cfg<BN>::kBytes;
  return 0;
}

}  // namespace

extern "C" {

// Launches on `stream` with the plan the wrapper chose (ops/conv.py's
// _conv_plan): bn in {64, 128} output channels a tile, split in {1, 2}
// CTAs along K. Returns 0 on success, a cudaError_t, or one of
// hopper_common.cuh's negative tensor-map codes; cudaErrorInvalidValue
// for a shape or plan the kernel does not take. x, w and y are
// contiguous bf16 with 16-byte aligned bases.
int mxtpu_conv3x3_bf16(const void* x, const void* w, void* y, int B, int H, int W,
                       int C, int O, int bn, int split, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 8 || O < 8 || C % 8 || O % 8 ||
      (O + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64 && split == 1) return launch<64, 1>(x, w, y, B, H, W, C, O, s);
  if (bn == 64 && split == 2) return launch<64, 2>(x, w, y, B, H, W, C, O, s);
  if (bn == 128 && split == 1) return launch<128, 1>(x, w, y, B, H, W, C, O, s);
  if (bn == 128 && split == 2) return launch<128, 2>(x, w, y, B, H, W, C, O, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread of one instantiation as the runtime reports them,
// and the dynamic shared memory bytes every launch of it asks for;
// returns a cudaError_t.
int mxtpu_conv3x3_attrs(int bn, int split, int* regs, int* smem_bytes) {
  if (bn == 64 && split == 1) return attrs<64, 1>(regs, smem_bytes);
  if (bn == 64 && split == 2) return attrs<64, 2>(regs, smem_bytes);
  if (bn == 128 && split == 1) return attrs<128, 1>(regs, smem_bytes);
  if (bn == 128 && split == 2) return attrs<128, 2>(regs, smem_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
