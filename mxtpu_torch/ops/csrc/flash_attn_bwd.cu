// Flash-attention backward for Hopper (sm_90a): dQ (with D) and dK/dV,
// bf16 in, f32 accumulation, bf16 out.
//
// Replaces: the backward of mxtpu/ops/attention.py::_tpu_pallas_flash
// (:157), i.e. the custom_vjp of jax/experimental/pallas/ops/tpu/
// flash_attention.py (:204), whose _flash_attention_bwd (:254) calls
// _flash_attention_bwd_dkv (pallas_call at :1121) and
// _flash_attention_bwd_dq (pallas_call at :1456). With
//     S = scale * q k^T (causal-masked),  P = exp(S - lse),
//     dP = dO v^T,  D = rowsum(dO o),  dS = P (dP - D)
// they compute
//     dV = P^T dO,  dK = scale * dS^T q,  dQ = scale * dS k.
// lse is the forward's row logsumexp (flash_attn_fwd.cu writes it; +inf
// for a row with no visible key, whose P and grads are then exactly 0).
// GQA sums dK and dV over each kv head's group of q heads inside one
// CTA, with no atomics, so the result is deterministic, as the
// reference's is.
//
// The D fold. The reference computes D = rowsum(dO o) outside its
// kernels (flash_attention.py:273), which in eager PyTorch costs two f32
// copies and an f32 product of (b, hq, sq, d): about 235 MB of traffic
// at the main shape, some 0.1 ms, a third of what the pair aims to
// take. Here the dQ kernel computes D for its rows from the O and dO
// tiles it has in shared memory anyway (O costs one more tile load),
// keeps it in registers for its own dS, and writes it, f32 (b, hq, sq),
// for the dK/dV kernel, which the caller launches second on the same
// stream. So the caller launches dQ first and has no eager D.
//
// Shapes: q, dO, o (b, hq, sq, d); k, v (b, hkv, skv, d), hq a multiple
// of hkv; lse, D f32 (b, hq, sq) contiguous; dq (b, hq, sq, d) and dk,
// dv (b, hkv, skv, d) written contiguous in bf16. q, k, v, dO and o may
// be strided views with a unit last-dim stride and strides that are
// multiples of 8 elements: the TMA tensor maps take the strides as they
// are. d in {64, 128}; any sq, skv >= 1. Causal is qpos >= kpos with
// both counted from 0, as in the forward.
//
// Bounds at the main path's shape (llama3_8b, b=1, hq=32, hkv=8,
// s=2048, d=128, causal; 2.1 M visible (q, k) pairs a head, 17.2 GFLOP
// a product, 989 TFLOP/s dense bf16): dK/dV does 4 products (S, dP, dV,
// dK), 68.8 GFLOP, 0.0695 ms; dQ 3 (S, dP, dQ), 51.6 GFLOP, 0.0521 ms;
// the bytes (q, k, v, o, dO, lse, D and the grads, about 60 MB, 18 us
// at 3.35 TB/s) are well below. Both compute-bound. The backward's own
// bound is 5 products, 0.0869 ms; two kernels that both recompute S and
// dP cannot go below 7, 0.1216 ms.
//
// Design: both kernels take the warp-specialised shape of the forward
// (flash_attn_fwd.cu): one CTA of 3 warpgroups, one CTA an SM.
// Warpgroup 0 is the producer (setmaxnreg 24): one thread issues TMA
// loads into an mbarrier ring with full and empty barriers; warpgroups 1
// and 2 are the consumers (setmaxnreg 240) and run every product as a
// wgmma, SS m64n64k16 for the 64 x 64 score tiles and RS m64n{d}k16 for
// the grads, whose register A operand is the score accumulator packed to
// bf16 (P and dS never touch shared memory) and whose B operand is a
// 64-row tile read MN-major through the descriptor's transpose bit (no
// tile is ever transposed).
//  - dQ (and D): one CTA per (128-row q tile, q head, batch), each
//    consumer owning 64 rows. Q, dO and O are loaded once; K and V come
//    as 64-key tiles through a 3-stage ring. Prologue: D for the
//    consumer's rows from O and dO in shared memory. Per key tile:
//    S = Q K^T and dP = dO V^T as SS wgmmas, dS = P (dP - D) in f32
//    registers with ex2.approx, dQ += dS K as an RS wgmma with K read
//    MN-major. S and dP of tile j are issued together with dQ of tile
//    j-1, and dS of tile j is computed while that runs; the two
//    consumers take turns to issue (named barriers, ping-pong), as in
//    the forward. Epilogue: scale, pack to bf16 into the dead Q tile,
//    TMA store. Causal grids launch every head's heaviest q tile first.
//  - dK/dV: one CTA per (64-key tile, kv head, batch). K and V are
//    loaded once. The producer walks the group's q heads and, for each,
//    the 64-row q tiles from the first one the causal mask lets see the
//    key tile, into a 4-stage ring of Q and dO tiles; a second producer
//    warp fills each stage's lse and D with plain loads (their rows
//    start at (b hq sq + q0) * 4 bytes, 16-byte aligned only when
//    sq % 4 == 0, so TMA cannot take them; padded rows get lse = +inf
//    and D = 0) and arrives on the stage's full barrier too. The two
//    consumers take alternate q tiles (consumer c stages c and c + 2),
//    each with its own dK and dV accumulators for the CTA's 64 keys:
//    S^T = K Q^T and dP^T = V dO^T as SS wgmmas (keys x queries), P^T
//    and dS^T in registers, then dV += P^T dO and dK += dS^T Q as RS
//    wgmmas with dO and Q read MN-major. Epilogue: the second consumer
//    writes its f32 accumulators into its own (dead) ring stages, the
//    first adds them to its own in a fixed order (deterministic, no
//    atomics, no per-head partials), scales dK, packs to bf16 into the
//    dead K and V tiles and stores both by TMA. A CTA whose key tile no
//    query sees (causal, sq < skv) loads nothing, waits on nothing and
//    stores zeros. Causal grids launch key tile 0 (which sees every
//    query) of every (kv head, batch) first.
//  - Why 64-key dK/dV CTAs with the consumers splitting q tiles, and not
//    128-key CTAs with the consumers splitting keys: at the main shape,
//    causal, 128-key CTAs make 128 CTAs in one wave whose heaviest is
//    1.9x the mean, which caps the kernel near 53 % of what the card
//    could do with that work; 64-key CTAs make 256 whose heaviest (key
//    tile 0: 4 heads x 32 q tiles) is about the mean work of an SM over
//    132 SMs. The price is twice the L2 traffic for Q and dO, about 256
//    FLOP a byte from L2.
//  - Registers: a dK/dV consumer at d = 128 holds dK and dV (64 each),
//    S^T and dP^T (32 each) and the packed operands, 236 of the 240
//    registers it gets. It relies on the other consumer to keep the
//    tensor cores busy while it computes P^T and dS^T: named-barrier
//    turns between the two, as dQ takes them, spilled when tried, and
//    overlapping a consumer's own exp2 with its dP^T product fit but
//    gained no more than the run-to-run spread (PERF.md, section 6).
//    setmaxnreg is honoured only in a kernel with no call and no trap
//    (PERF.md, section 6), so there is no __trap(), no IEEE division and
//    no printf in either kernel: exp2 and 1/x by the SFU, and the
//    bounded mbarrier wait faults by a store to address 0.
//
// Against the mma.sync kernels this replaces (0.894 + 0.393 ms, 1.40 ms
// with the eager D, at the main shape): wgmma instead of mma.sync
// m16n8k16; TMA into mbarrier rings, so loads overlap the math, instead
// of synchronous copies between __syncthreads; B operands through
// transposed descriptors instead of 16-bit gathered fragments; 3
// warpgroups with setmaxnreg instead of 4 warps at 231-238 registers, 2
// CTAs an SM; dK/dV's causal grid heaviest first across heads; D folded
// into the dQ kernel.
// What it leaves on the table: both kernels recompute S and dP (a dQ
// accumulated with atomics in the dK/dV kernel would not, at the price
// of determinism); the dK/dV consumers neither ping-pong nor overlap
// their own dS with their products; no grid is persistent, so each CTA
// pays its prologue and epilogue alone; the diagonal tiles compute their
// masked half, and dQ's first consumer walks one key tile its rows
// cannot see (the turns need both consumers to issue alike); each call
// encodes six tensor maps on the host.
#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr uint32_t kBox64 = 64 * 128;    // bytes of a 64-row, 64-column box
constexpr uint32_t kBox128 = 128 * 128;  // bytes of a 128-row one
constexpr float kLog2e = 1.4426950408889634f;

// Issue acc (64 x 64) = A B^T over d as one run of SS wgmmas, A and B
// both K-major 64-column boxes (a_box, b_box bytes apart): the k-step of
// 16 columns is 32 bytes inside a box, columns 64.. the next box.
template <int D>
__device__ __forceinline__ void issue_ss_n64(float (&acc)[32], uint32_t a, uint32_t a_box,
                                             uint32_t b, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    hopper::wgmma_ss_m64n64k16<0>(acc, hopper::desc_sw128(a + (kk / 4) * a_box + col, 16, 1024),
                                  hopper::desc_sw128(b + (kk / 4) * b_box + col, 16, 1024),
                                  kk > 0);
  }
}

// Issue acc (64 x D) += A B over 64 contraction rows: A the bf16
// register fragments of a 64 x 64 accumulator (4 k-steps of 16), B a
// 64-row tile read MN-major (16 rows a step = 2048 bytes, 64-column
// atoms one 64-row box apart).
template <int D>
__device__ __forceinline__ void issue_rs_k64(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = hopper::desc_sw128(b + kk * 16 * 128, kBox64, 1024);
    if constexpr (D == 128)
      hopper::wgmma_rs_m64n128k16<1>(acc, a[kk], db, 1);
    else
      hopper::wgmma_rs_m64n64k16<1>(acc, a[kk], db, 1);
  }
}

// A 64 x 64 f32 accumulator as bf16 register A fragments: accumulator
// blocks 2kk and 2kk+1 are the A operand of columns [16kk, 16kk + 16).
__device__ __forceinline__ void pack_frag(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[kk][e] = hopper::pack_bf16x2(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
  }
}

// A warpgroup's 64 x D accumulator, times mul, as bf16 into the rows
// [row0, row0 + 64) of a tile of D / 64 boxes (box bytes apart), in the
// 128-byte swizzle TMA expects (16-byte chunk c of row r at c ^ (r % 8)).
template <int D>
__device__ __forceinline__ void stage_bf16(unsigned char* tile, uint32_t box, int row0,
                                           const float (&acc)[D / 2], float mul, int warp,
                                           int g, int t4) {
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + g + 8 * r;  // row % 8 == g
      const uint32_t off = (jn / 8) * box + row * 128 + (((jn % 8) ^ g) * 16) + t4 * 4;
      *reinterpret_cast<uint32_t*>(tile + off) =
          hopper::pack_bf16x2(acc[4 * jn + 2 * r] * mul, acc[4 * jn + 2 * r + 1] * mul);
    }
  }
}

// The causal grids walk their heaviest tiles first: the linear block
// index runs over every (head, batch) pair of one tile index before the
// next. Returns the tile index, sets h and bi.
__device__ __forceinline__ int heaviest_first(int& h, int& bi) {
  const int per = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  h = (lin % per) % gridDim.y;
  bi = (lin % per) / gridDim.y;
  return lin / per;
}

// ---------------------------------------------------------------------------
// dQ and D
// ---------------------------------------------------------------------------
namespace dq {

constexpr int kBlockM = 128;  // q rows per CTA, 64 per consumer
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kStages = 3;    // K/V ring depth
// Named barriers (0 is __syncthreads'): 1 + cw is consumer cw's turn to
// issue wgmmas, 3 + cw its epilogue.
constexpr int kTurnBar = 1;
constexpr int kStoreBar = 3;

// Shared memory from a 1024-byte aligned base: Q, dO and O (128 rows
// each), the K and V rings (64 rows a stage), then the mbarriers.
template <int D>
struct Smem {
  static constexpr uint32_t kRows = (D / 64) * kBox128;  // a 128-row tile
  static constexpr uint32_t kKv = (D / 64) * kBox64;     // a 64-row tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kRows;
  static constexpr uint32_t kO = 2 * kRows;
  static constexpr uint32_t kK = 3 * kRows;
  static constexpr uint32_t kV = kK + kStages * kKv;
  static constexpr uint32_t kBars = kV + kStages * kKv;
  // q_full, full[S], empty[S]; + alignment slack
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// dS = P (dP - D) of one 64 x 64 tile, in place of s: s[i] is row
// r0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) + 2 t4 + (i & 1).
// Masked scores (causal, or keys past skv, whose zero-filled K row would
// otherwise meet an unbounded P) give P = 0 exactly.
__device__ __forceinline__ void ds_tile(float (&s)[32], const float (&dp)[32], bool need_mask,
                                        int k0, int skv, int causal, const int (&qpos)[2],
                                        const float (&lse2)[2], const float (&dl)[2], int t4,
                                        float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x = fmaf(s[i], scale_log2, -lse2[r]);
    if (need_mask) {
      const int kpos = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (kpos >= skv || (causal && kpos > qpos[r])) x = -INFINITY;
    }
    s[i] = hopper::ex2_approx(x) * (dp[i] - dl[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_o,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const float* __restrict__ lse, float* __restrict__ delta, int hq,
                    int hkv, int sq, int skv, float scale, float scale_log2, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  int m_block = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  if (causal) m_block = gridDim.x - 1 - heaviest_first(h, bi);
  const int hk = h / (hq / hkv);
  const int q0 = m_block * kBlockM;
  // Rows with q0 >= skv see every key, so the causal end is clamped.
  const int kv_end = causal ? min(skv, q0 + kBlockM) : skv;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;  // >= 1
  // Warp-uniform, so the role branches below are not divergent.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    hopper::prefetch_tensormap(&tm_q);
    hopper::prefetch_tensormap(&tm_k);
    hopper::prefetch_tensormap(&tm_v);
    hopper::prefetch_tensormap(&tm_do);
    hopper::prefetch_tensormap(&tm_o);
    hopper::prefetch_tensormap(&tm_dq);
    hopper::mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(bar_full + 8 * st, 1);
      hopper::mbar_init(bar_empty + 8 * st, 256);  // both consumers read each tile
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(bar_q, 3 * L::kRows);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(base + L::kQ + c * kBox128, &tm_q, bar_q, c * 64, q0, h, bi);
        hopper::tma_load_4d(base + L::kDO + c * kBox128, &tm_do, bar_q, c * 64, q0, h, bi);
        hopper::tma_load_4d(base + L::kO + c * kBox128, &tm_o, bar_q, c * 64, q0, h, bi);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t phase = (j / kStages) & 1;  // round 0 finds slots free
        const uint32_t full = bar_full + 8 * st;
        hopper::mbar_wait(bar_empty + 8 * st, phase ^ 1);
        hopper::mbar_arrive_expect_tx(full, 2 * L::kKv);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(base + L::kK + st * L::kKv + c * kBox64, &tm_k, full, c * 64,
                              j * kBlockN, hk, bi);
          hopper::tma_load_4d(base + L::kV + st * L::kKv + c * kBox64, &tm_v, full, c * 64,
                              j * kBlockN, hk, bi);
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns tile rows [64 cw, 64 cw + 64).
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row within the 8-row group
    const int t4 = lane & 3;  // accumulator column pair
    const int r0 = 64 * cw + 16 * warp + g;  // this thread's rows: r0, r0 + 8
    const int qpos[2] = {q0 + r0, q0 + r0 + 8};
    const int row_min = q0 + 64 * cw;
    const long long row0 = (static_cast<long long>(bi) * hq + h) * sq;
    const uint32_t q_base = base + L::kQ + cw * 64 * 128;
    const uint32_t do_base = base + L::kDO + cw * 64 * 128;
    auto take_turn = [&] { hopper::bar_sync(kTurnBar + cw, 256); };
    auto pass_turn = [&] { hopper::bar_arrive(kTurnBar + 1 - cw, 256); };
    auto need_mask = [&](int k0) {
      return k0 + kBlockN > skv || (causal && k0 + kBlockN - 1 > row_min);
    };

    // Padded rows (qpos >= sq) get lse = +inf: their P is exactly 0.
    float lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse2[r] = qpos[r] < sq ? lse[row0 + qpos[r]] * kLog2e : INFINITY;

    // D for this thread's two rows: the quad that shares a row splits its
    // 16-byte chunks (chunk c of the row at c ^ g in its box) and sums
    // across the quad. Rows past sq are zero-filled, so their D is 0.
    hopper::mbar_wait(bar_q, 0);
    float dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t row = (r0 + 8 * r) * 128;
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < D / 32; ++cc) {
        const int c = 4 * cc + t4;
        const uint32_t off = (c / 8) * kBox128 + row + (((c % 8) ^ g) * 16);
        const uint4 ov = *reinterpret_cast<const uint4*>(smem + L::kO + off);
        const uint4 dv = *reinterpret_cast<const uint4*>(smem + L::kDO + off);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          sum = fmaf(of.x, df.x, sum);
          sum = fmaf(of.y, df.y, sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dl[r] = sum;
      if (t4 == 0 && qpos[r] < sq) delta[row0 + qpos[r]] = sum;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[32], dp[32];
    uint32_t df[4][4];

    if (cw == 1) pass_turn();

    // Tile 0: S, dP, dS.
    hopper::mbar_wait(bar_full, 0);
    take_turn();
    hopper::wgmma_fence();
    issue_ss_n64<D>(s, q_base, kBox128, base + L::kK, kBox64);
    issue_ss_n64<D>(dp, do_base, kBox128, base + L::kV, kBox64);
    hopper::wgmma_commit();
    pass_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    ds_tile(s, dp, need_mask(0), 0, skv, causal, qpos, lse2, dl, t4, scale_log2);
    pack_frag(df, s);

    // Tile j: issue S_j, dP_j and dQ += dS_{j-1} K_{j-1}; dS_j while the
    // last runs.
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t phase = (j / kStages) & 1;
      const int sp = (j - 1) % kStages;
      hopper::mbar_wait(bar_full + 8 * st, phase);
      take_turn();
      hopper::wgmma_fence();
      issue_ss_n64<D>(s, q_base, kBox128, base + L::kK + st * L::kKv, kBox64);
      issue_ss_n64<D>(dp, do_base, kBox128, base + L::kV + st * L::kKv, kBox64);
      hopper::wgmma_commit();
      issue_rs_k64<D>(acc, df, base + L::kK + sp * L::kKv);
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<1>();  // S_j and dP_j are done
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      ds_tile(s, dp, need_mask(j * kBlockN), j * kBlockN, skv, causal, qpos, lse2, dl, t4,
              scale_log2);
      hopper::wgmma_wait<0>();  // dQ of tile j-1 is done: its K/V slot is free
      hopper::fence_regs(acc);
      hopper::mbar_arrive(bar_empty + 8 * sp);
      pack_frag(df, s);
    }

    // The last tile's dQ.
    {
      const int sp = (n_tiles - 1) % kStages;
      take_turn();
      hopper::wgmma_fence();
      issue_rs_k64<D>(acc, df, base + L::kK + sp * L::kKv);
      hopper::wgmma_commit();
      if (cw == 0) pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(bar_empty + 8 * sp);
    }

    // dQ: scaled, as bf16 into this consumer's rows of the Q tile (which
    // no product reads any more), then one TMA store per 64-column box;
    // it skips rows past sq.
    stage_bf16<D>(smem + L::kQ, kBox128, 64 * cw, acc, scale, warp, g, t4);
    hopper::fence_proxy_async();
    hopper::bar_sync(kStoreBar + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_store_4d(&tm_dq, q_base + c * kBox128, c * 64, row_min, h, bi);
      hopper::tma_store_commit_and_wait();
    }
  }
}

}  // namespace dq

// ---------------------------------------------------------------------------
// dK and dV
// ---------------------------------------------------------------------------
namespace dkv {

constexpr int kBlockN = 64;  // keys per CTA
constexpr int kBlockM = 64;  // q rows per Q/dO tile
constexpr int kStages = 4;   // Q/dO ring depth: stages c and c + 2 are consumer c's
// Named barriers: the consumers' sum, then the first consumer's store.
constexpr int kSumBar = 1;
constexpr int kStoreBar = 2;

// Shared memory from a 1024-byte aligned base: K, V, the ring (stage st:
// Q then dO, 64 rows each), each stage's lse (log2 domain) and D, then
// the mbarriers. A stage is 64 * D * 4 bytes: exactly one consumer's f32
// dK or dV, which is how the second consumer hands its sums over.
template <int D>
struct Smem {
  static constexpr uint32_t kTile = (D / 64) * kBox64;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kTile;
  static constexpr uint32_t kRing = 2 * kTile;
  static constexpr uint32_t kStage = 2 * kTile;
  static constexpr uint32_t kLse = kRing + kStages * kStage;
  static constexpr uint32_t kDelta = kLse + kStages * kBlockM * 4;
  static constexpr uint32_t kBars = kDelta + kStages * kBlockM * 4;
  // kv_full, full[S], empty[S]; + alignment slack
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv,
                     const float* __restrict__ lse, const float* __restrict__ delta, int hq,
                     int hkv, int sq, int skv, float scale, float scale_log2, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - hopper::smem_u32(smem_raw));
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* d_s = reinterpret_cast<float*>(smem + L::kDelta);
  const uint32_t bar_kv = base + L::kBars;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  int n_block = blockIdx.x, hk = blockIdx.y, bi = blockIdx.z;
  if (causal) n_block = heaviest_first(hk, bi);  // key tile 0 sees every query
  const int k0 = n_block * kBlockN;
  const int rep = hq / hkv;
  const int n_mtiles = (sq + kBlockM - 1) / kBlockM;
  // The first q tile with a row that can see a key of this tile.
  const int m_start = causal ? min(k0 / kBlockM, n_mtiles) : 0;
  const int per_head = n_mtiles - m_start;
  const int n_work = rep * per_head;  // q tiles of the group; 0: no query sees these keys
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    hopper::prefetch_tensormap(&tm_q);
    hopper::prefetch_tensormap(&tm_k);
    hopper::prefetch_tensormap(&tm_v);
    hopper::prefetch_tensormap(&tm_do);
    hopper::prefetch_tensormap(&tm_dk);
    hopper::prefetch_tensormap(&tm_dv);
    hopper::mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(bar_full + 8 * st, 1 + 32);  // TMA thread + the lse/D warp
      hopper::mbar_init(bar_empty + 8 * st, 128);    // the one consumer of the stage
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0 && n_work > 0) {
      // TMA: K and V once, then Q and dO tile by tile.
      hopper::mbar_arrive_expect_tx(bar_kv, 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(base + L::kK + c * kBox64, &tm_k, bar_kv, c * 64, k0, hk, bi);
        hopper::tma_load_4d(base + L::kV + c * kBox64, &tm_v, bar_kv, c * 64, k0, hk, bi);
      }
      int h = hk * rep, mb = m_start;
      for (int t = 0; t < n_work; ++t) {
        const int st = t % kStages;
        const uint32_t full = bar_full + 8 * st;
        const uint32_t dst = base + L::kRing + st * L::kStage;
        hopper::mbar_wait(bar_empty + 8 * st, ((t / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full, L::kStage);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(dst + c * kBox64, &tm_q, full, c * 64, mb * kBlockM, h, bi);
          hopper::tma_load_4d(dst + L::kTile + c * kBox64, &tm_do, full, c * 64,
                              mb * kBlockM, h, bi);
        }
        if (++mb == n_mtiles) mb = m_start, ++h;
      }
    } else if (warp == 1) {
      // lse (to the log2 domain) and D of each stage's 64 rows.
      const int lane = threadIdx.x % 32;
      int h = hk * rep, mb = m_start;
      for (int t = 0; t < n_work; ++t) {
        const int st = t % kStages;
        hopper::mbar_wait(bar_empty + 8 * st, ((t / kStages) & 1) ^ 1);
        const long long row0 = (static_cast<long long>(bi) * hq + h) * sq;
#pragma unroll
        for (int r = lane; r < kBlockM; r += 32) {
          const int qrow = mb * kBlockM + r;
          lse_s[st * kBlockM + r] = qrow < sq ? lse[row0 + qrow] * kLog2e : INFINITY;
          d_s[st * kBlockM + r] = qrow < sq ? delta[row0 + qrow] : 0.f;
        }
        hopper::mbar_arrive(bar_full + 8 * st);
        if (++mb == n_mtiles) mb = m_start, ++h;
      }
    }
  } else {
    // Consumers: consumer cw takes q tiles cw, cw + 2, ... (stages cw and
    // cw + 2), all against the CTA's 64 keys.
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int kpos[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};  // this thread's keys
    const int n_mine = (n_work - cw + 1) / 2;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[32], dp[32];
    uint32_t pf[4][4], df[4][4];

    if (n_mine > 0) hopper::mbar_wait(bar_kv, 0);
    // The q tile of this consumer's next tile (its head only moves the
    // producers' coordinates); per_head >= 1 whenever n_mine > 0.
    int mb = m_start + cw;
    if (mb >= n_mtiles) mb -= per_head;
    for (int i = 0; i < n_mine; ++i) {
      const int t = cw + 2 * i;
      const int st = t % kStages;
      const int q0 = mb * kBlockM;
      const uint32_t q_st = base + L::kRing + st * L::kStage;
      const uint32_t do_st = q_st + L::kTile;
      hopper::mbar_wait(bar_full + 8 * st, (t / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries.
      hopper::wgmma_fence();
      issue_ss_n64<D>(s, base + L::kK, kBox64, q_st, kBox64);
      issue_ss_n64<D>(dp, base + L::kV, kBox64, do_st, kBox64);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P^T and dS^T: s[4j + e] is key kpos[e >> 1], query q0 + 8j + 2 t4
      // + (e & 1). Only the diagonal tile and a ragged key tile mask.
      const bool need_mask = k0 + kBlockN > skv || (causal && q0 < k0 + kBlockN - 1);
      const float* ls = lse_s + st * kBlockM;
      const float* ds = d_s + st * kBlockM;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = 4 * j + e;
          const int c = e & 1;
          float x = fmaf(s[i2], scale_log2, -(c ? l2.y : l2.x));
          if (need_mask) {
            const int kp = kpos[e >> 1];
            if (kp >= skv || (causal && kp > q0 + qc + c)) x = -INFINITY;
          }
          const float p = hopper::ex2_approx(x);
          s[i2] = p;
          dp[i2] = p * (dp[i2] - (c ? d2.y : d2.x));
        }
      }
      pack_frag(pf, s);
      pack_frag(df, dp);

      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major.
      hopper::wgmma_fence();
      issue_rs_k64<D>(dv, pf, do_st);
      issue_rs_k64<D>(dk, df, q_st);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::mbar_arrive(bar_empty + 8 * st);
      mb += 2;
      while (mb >= n_mtiles) mb -= per_head;
    }

    // The second consumer's sums, through its own stages (1 for dK, 3
    // for dV), into the first's registers: thread tid of both holds the
    // same accumulator elements, so element i goes to [i * 128 + tid]
    // (conflict-free) and the sum's order is fixed.
    float* xk = reinterpret_cast<float*>(smem + L::kRing + 1 * L::kStage);
    float* xv = reinterpret_cast<float*>(smem + L::kRing + 3 * L::kStage);
    if (cw == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        xk[i * 128 + tid] = dk[i];
        xv[i * 128 + tid] = dv[i];
      }
    }
    hopper::bar_sync(kSumBar, 256);
    if (cw == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dk[i] += xk[i * 128 + tid];
        dv[i] += xv[i * 128 + tid];
      }
      // dK scaled and dV as bf16 into the K and V tiles (both consumers
      // are past their last product), then TMA stores, which skip keys
      // past skv.
      stage_bf16<D>(smem + L::kK, kBox64, 0, dk, scale, warp, g, t4);
      stage_bf16<D>(smem + L::kV, kBox64, 0, dv, 1.f, warp, g, t4);
      hopper::fence_proxy_async();
      hopper::bar_sync(kStoreBar, 128);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_store_4d(&tm_dk, base + L::kK + c * kBox64, c * 64, k0, hk, bi);
          hopper::tma_store_4d(&tm_dv, base + L::kV + c * kBox64, c * 64, k0, hk, bi);
        }
        hopper::tma_store_commit_and_wait();
      }
    }
  }
}

}  // namespace dkv

// Strides in elements, (batch, head, seq) per tensor, in the order of the
// C entry points' arguments.
struct Strides {
  long long b, h, s;
};

int encode(CUtensorMap* map, const void* t, int d, int s, int h, int b, const Strides& st,
           int box_rows) {
  return hopper::encode_bf16_4d(map, t, d, s, h, b, st.s, st.h, st.b, box_rows);
}

Strides packed(int d, int s, int h) {
  return Strides{static_cast<long long>(h) * s * d, static_cast<long long>(s) * d, d};
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* o,
              const float* lse, float* delta, void* dq, const Strides (&st)[5], int b, int hq,
              int hkv, int sq, int skv, float scale, int causal, cudaStream_t stream) {
  using L = dq::Smem<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_o, tm_dq;
  int err = encode(&tm_q, q, D, sq, hq, b, st[0], dq::kBlockM);
  if (err == 0) err = encode(&tm_k, k, D, skv, hkv, b, st[1], dq::kBlockN);
  if (err == 0) err = encode(&tm_v, v, D, skv, hkv, b, st[2], dq::kBlockN);
  if (err == 0) err = encode(&tm_do, dout, D, sq, hq, b, st[3], dq::kBlockM);
  if (err == 0) err = encode(&tm_o, o, D, sq, hq, b, st[4], dq::kBlockM);
  // dq contiguous, 64-row boxes (one consumer's rows)
  if (err == 0) err = encode(&tm_dq, dq, D, sq, hq, b, packed(D, sq, hq), 64);
  if (err != 0) return err;
  const cudaError_t cerr = cudaFuncSetAttribute(
      dq::flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((sq + dq::kBlockM - 1) / dq::kBlockM, hq, b);
  dq::flash_bwd_dq_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_o, tm_dq, lse, delta, hq, hkv, sq, skv, scale,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               const Strides (&st)[4], int b, int hq, int hkv, int sq, int skv, float scale,
               int causal, cudaStream_t stream) {
  using L = dkv::Smem<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  int err = encode(&tm_q, q, D, sq, hq, b, st[0], dkv::kBlockM);
  if (err == 0) err = encode(&tm_k, k, D, skv, hkv, b, st[1], dkv::kBlockN);
  if (err == 0) err = encode(&tm_v, v, D, skv, hkv, b, st[2], dkv::kBlockN);
  if (err == 0) err = encode(&tm_do, dout, D, sq, hq, b, st[3], dkv::kBlockM);
  if (err == 0) err = encode(&tm_dk, dk, D, skv, hkv, b, packed(D, skv, hkv), dkv::kBlockN);
  if (err == 0) err = encode(&tm_dv, dv, D, skv, hkv, b, packed(D, skv, hkv), dkv::kBlockN);
  if (err != 0) return err;
  const cudaError_t cerr = cudaFuncSetAttribute(
      dkv::flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((skv + dkv::kBlockN - 1) / dkv::kBlockN, hkv, b);
  dkv::flash_bwd_dkv_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, lse, delta, hq, hkv, sq, skv, scale,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return 0, a cudaError_t, or
// one of hopper_common.cuh's negative tensor-map codes (see
// mxtpu_cuda_error_string). Strides are in elements: (batch, head, seq)
// per tensor, in the order of the tensors. lse and D are f32
// (b, hq, sq) contiguous; the grads are bf16 and contiguous.

// dK and dV from q, k, v, dO, lse and the D that the dQ entry point
// wrote; launch it after that one, on the same stream.
int mxtpu_flash_attn_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, int b, int hq, int hkv, int sq, int skv, int d, float scale,
    int causal, void* stream) {
  const Strides st[4] = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
                         {do_sb, do_sh, do_ss}};
  const auto* l = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, st, b, hq, hkv, sq, skv, scale,
                          causal, s);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, st, b, hq, hkv, sq, skv, scale,
                           causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dQ from q, k, v, dO and lse, and D = rowsum(dO o) from dO and the
// forward's output o, written to `delta` for the dK/dV entry point.
int mxtpu_flash_attn_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* o,
    const void* lse, void* delta, void* dq, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh, long long do_ss,
    long long o_sb, long long o_sh, long long o_ss, int b, int hq, int hkv, int sq,
    int skv, int d, float scale, int causal, void* stream) {
  const Strides st[5] = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
                         {do_sb, do_sh, do_ss}, {o_sb, o_sh, o_ss}};
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, o, l, dl, dq, st, b, hq, hkv, sq, skv, scale,
                         causal, s);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, o, l, dl, dq, st, b, hq, hkv, sq, skv, scale,
                          causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread of a d-wide backward kernel (which: 0 dK/dV, 1 dQ)
// as the runtime reports them, and the dynamic shared memory bytes every
// launch of it asks for; returns a cudaError_t.
int mxtpu_flash_attn_bwd_attrs(int which, int d, int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (which == 0 && d == 64) {
    err = cudaFuncGetAttributes(&a, dkv::flash_bwd_dkv_kernel<64>);
    *smem_bytes = dkv::Smem<64>::kBytes;
  } else if (which == 0 && d == 128) {
    err = cudaFuncGetAttributes(&a, dkv::flash_bwd_dkv_kernel<128>);
    *smem_bytes = dkv::Smem<128>::kBytes;
  } else if (which == 1 && d == 64) {
    err = cudaFuncGetAttributes(&a, dq::flash_bwd_dq_kernel<64>);
    *smem_bytes = dq::Smem<64>::kBytes;
  } else if (which == 1 && d == 128) {
    err = cudaFuncGetAttributes(&a, dq::flash_bwd_dq_kernel<128>);
    *smem_bytes = dq::Smem<128>::kBytes;
  }
  if (err == cudaSuccess) *regs = a.numRegs;
  return static_cast<int>(err);
}

}  // extern "C"
