// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces: mxtpu/ops/attention.py::_tpu_pallas_flash (:157), which wraps
// the forward pallas_call of jax/experimental/pallas/ops/tpu/
// flash_attention.py (:758). It computes
//     o = softmax(scale * q k^T, causal mask) v
// with q (b, hq, sq, d), k and v (b, hkv, skv, d), o (b, hq, sq, d) in
// q's dtype. GQA reads kv head h / (hq / hkv) directly; the repeated
// K/V of _repeat_kv is never materialised. The causal mask is
// qpos >= kpos with both counted from 0 (blockwise_attention's
// _online_block convention), and a row with no visible key comes out
// as zeros (_finalize). When `lse` is not null the kernel also writes
// each row's natural-log logsumexp of the scaled scores, f32
// (b, hq, sq) contiguous, for the backward kernels of
// flash_attn_bwd.cu; a row with no visible key gets +inf there, so the
// backward's exp(s - lse) is exactly 0 and its grads are zeros too.
// Writing lse changes nothing in o's arithmetic.
//
// Accepts: bf16 only (f32 inputs get a clear error from the Python
// wrapper), d in {64, 128}, any sq, skv >= 1 (the ragged edge is masked
// here), causal or not. q, k and v may be strided views with a unit
// last-dim stride and strides that are multiples of 8 elements (the
// (b, s, h, d) -> (b, h, s, d) transposes of the model need no copy):
// the TMA tensor maps take the strides as they are. o is written
// contiguous.
//
// Bound at the main path's shape (llama3_8b, b=1, hq=32, hkv=8,
// s=2048, d=128, causal): 4 * d * hq * s (s + 1) / 2 = 34.4 GFLOP of
// bf16 tensor-core work over the visible pairs, 34.8 us at 989 TFLOP/s
// dense, against 42 MB of q, k, v and o, 12.5 us at 3.35 TB/s:
// compute-bound, so the design is about keeping the tensor cores fed.
//
// Design: the warp-specialised shape of Hopper's fast kernels. One CTA
// of 3 warpgroups per (128-row q tile, q head, batch), one CTA per SM
// (about 160 KB of shared memory at d = 128).
//  - Warpgroup 0, the producer, gives up registers (setmaxnreg 24); one
//    thread issues TMA loads: the Q tile once, then K and V tiles of
//    128 keys into a 2-stage ring. K and V have their own "full" and
//    "empty" barriers, so Q K^T starts before V has landed and a K slot
//    is refilled as soon as its product is done.
//  - Warpgroups 1 and 2, the consumers (setmaxnreg 240), own 64 q rows
//    each. S = Q K^T is an SS wgmma m64n128k16 over d / 16 steps, Q and
//    K both K-major from 128-byte-swizzled shared memory. The online
//    softmax runs in f32 registers on the accumulator layout (row max
//    and sum across the 4 threads of a row, exp2 of scale*log2(e)
//    scores; masked scores are -inf with a finite running max, and only
//    the diagonal and ragged tiles are masked). P is the accumulator
//    packed to bf16 in registers, which is the register A operand of
//    O += P V, an RS wgmma m64n{d}k16 whose B is V read MN-major through
//    the descriptor's transpose bit: P never touches shared memory and
//    V is never transposed.
//  - Inside a warpgroup, Q K^T of tile j and P V of tile j-1 are issued
//    together and the softmax of tile j runs while P V is on the tensor
//    cores. Across the two, named barriers take turns (ping-pong), so one
//    warpgroup's products run while the other computes exp2.
//  - Epilogue: the rows are normalised, packed to bf16 into this
//    warpgroup's rows of the (now unused) Q tile in the swizzled layout,
//    and written by a TMA store that clips rows past sq.
//  - Causal grids launch the heaviest q tiles of every head first: the
//    linear block index walks all (head, batch) pairs of one q tile
//    before the next, q tiles counting down, so the longest tiles of
//    every head start in the first wave and the shortest fill the tail.
// Against the mma.sync design it replaces (84 TFLOP/s, 0.410 ms at the
// main shape): wgmma instead of mma.sync.m16n8k16; TMA into an
// mbarrier ring instead of synchronous copies between __syncthreads, so
// loads overlap the math; V read through the descriptor instead of
// 16-bit gathers; 128-row tiles with 128-key K/V tiles, so each K/V tile
// is fetched half as often from L2; exp2 and the softmax overlapped with
// the products.
// What it leaves on the table: the grid is not persistent, so each CTA
// pays its own prologue (Q load, first K tile) and epilogue without
// overlap; on the causal diagonal the first warpgroup computes 64 keys
// that its rows cannot see; rescaling O on every tile costs d / 2
// multiplies a thread even when the row max did not move.
#include <math.h>
#include <stdio.h>

#include "hopper_common.cuh"

namespace {

constexpr int kBlockM = 128;  // q rows per CTA, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;  // arrivals that free a slot
constexpr float kNegInf = -1e30f;      // finite start of the running max
// Named barriers of the consumers (0 is __syncthreads'): 1 + cw is
// warpgroup cw's turn to issue wgmmas, 3 + cw its epilogue.
constexpr int kTurnBar = 1;
constexpr int kStoreBar = 3;

// Shared memory, in bytes from a 1024-byte aligned base: Q, then the K
// and V rings, each tile d / 64 boxes of 128 rows x 128 bytes; then the
// mbarriers.
template <int D>
struct Smem {
  static constexpr uint32_t kBox = kBlockN * 128;  // one 64-column box
  static constexpr uint32_t kTile = (D / 64) * kBox;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTile;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBars = kV + kStages * kTile;
  // q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};
static_assert(kBlockM == kBlockN, "Q and K/V tiles share one box shape");

// Barrier addresses: q_full, then per stage k_full, v_full, k_empty,
// v_empty.
struct Bars {
  uint32_t q, k, v, ek, ev;
  __device__ Bars(uint32_t at)
      : q(at), k(at + 8), v(k + 8 * kStages), ek(v + 8 * kStages), ev(ek + 8 * kStages) {}
};

// One tile's online softmax, in place: raw scores s -> probabilities p
// (f32), updating the running max m (log2 domain) and this thread's
// share l of the row sums; corr is the factor for the rows' earlier
// sums. s[i] is row r0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) +
// 2 t4 + (i & 1). Masked scores become -inf, so exp2 gives them exactly
// 0 while the running max stays finite (>= kNegInf).
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool need_mask, int k0, int skv,
                                             int causal, const int (&qpos)[2],
                                             int t4, float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i] * scale_log2;
    if (need_mask) {
      const int kpos = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (kpos >= skv || (causal && kpos > qpos[r])) x = -INFINITY;
    }
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = hopper::ex2_approx(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = hopper::ex2_approx(s[i] - m[r]);
    l[r] += s[i];
  }
}

// P as bf16 register A fragments: accumulator blocks 2kk and 2kk+1 are
// the A operand of keys [16kk, 16kk + 16).
__device__ __forceinline__ void pack_p(uint32_t (&pf)[kBlockN / 16][4],
                                       const float (&s)[kBlockN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pf[kk][e] = hopper::pack_bf16x2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  }
}

// Issue S = Q K^T (64 rows x 128 keys) as one wgmma group: K-major A
// and B; the k-step of 16 columns is 32 bytes inside a box, and columns
// 64.. are the next box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBlockN / 2], uint32_t q_base,
                                         uint32_t k_base) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * L::kBox + (kk % 4) * 32;
    hopper::wgmma_ss_m64n128k16<0>(s, hopper::desc_sw128(q_base + off, 16, 1024),
                                   hopper::desc_sw128(k_base + off, 16, 1024), kk > 0);
  }
  hopper::wgmma_commit();
}

// Issue O += P V as one wgmma group: V MN-major (d contiguous), 16 keys
// a step = 2048 bytes, 64-column atoms one box apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pf)[kBlockN / 16][4],
                                         uint32_t v_base) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t dv = hopper::desc_sw128(v_base + kk * 16 * 128, L::kBox, 1024);
    if constexpr (D == 128)
      hopper::wgmma_rs_m64n128k16<1>(acc, pf[kk], dv, 1);
    else
      hopper::wgmma_rs_m64n64k16<1>(acc, pf[kk], dv, 1);
  }
  hopper::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                 float scale_log2, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const Bars bar(base + L::kBars);

  int m_block = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  if (causal) {  // heaviest q tiles of every (head, batch) first
    const int per = gridDim.y * gridDim.z;
    const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    m_block = gridDim.x - 1 - lin / per;
    h = (lin % per) % gridDim.y;
    bi = (lin % per) / gridDim.y;
  }
  const int hk = h / (hq / hkv);
  const int q0 = m_block * kBlockM;
  // Rows with q0 >= skv see every key, so the causal end is clamped.
  const int kv_end = causal ? min(skv, q0 + kBlockM) : skv;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  // Warp-uniform, so the role branches below are not divergent.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    hopper::prefetch_tensormap(&tm_q);
    hopper::prefetch_tensormap(&tm_k);
    hopper::prefetch_tensormap(&tm_v);
    hopper::prefetch_tensormap(&tm_o);
    hopper::mbar_init(bar.q, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(bar.k + 8 * st, 1);
      hopper::mbar_init(bar.v + 8 * st, 1);
      hopper::mbar_init(bar.ek + 8 * st, kConsumerThreads);
      hopper::mbar_init(bar.ev + 8 * st, kConsumerThreads);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(bar.q, L::kTile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(base + L::kQ + c * L::kBox, &tm_q, bar.q, c * 64, q0, h, bi);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t phase = (j / kStages) & 1;  // round 0 finds slots free
        const uint32_t k_dst = base + L::kK + st * L::kTile;
        const uint32_t v_dst = base + L::kV + st * L::kTile;
        hopper::mbar_wait(bar.ek + 8 * st, phase ^ 1);
        hopper::mbar_arrive_expect_tx(bar.k + 8 * st, L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          hopper::tma_load_4d(k_dst + c * L::kBox, &tm_k, bar.k + 8 * st, c * 64,
                              j * kBlockN, hk, bi);
        hopper::mbar_wait(bar.ev + 8 * st, phase ^ 1);
        hopper::mbar_arrive_expect_tx(bar.v + 8 * st, L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          hopper::tma_load_4d(v_dst + c * L::kBox, &tm_v, bar.v + 8 * st, c * 64,
                              j * kBlockN, hk, bi);
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
    const uint32_t q_base = base + L::kQ + cw * 64 * 128;
    // Ping-pong: wait for this warpgroup's turn to issue, then hand the
    // turn to the other. Both issue n_tiles + 1 times; warpgroup 1 gives
    // warpgroup 0 the first turn and skips handing over its last.
    auto take_turn = [&] { hopper::bar_sync(kTurnBar + cw, kConsumerThreads); };
    auto pass_turn = [&] { hopper::bar_arrive(kTurnBar + 1 - cw, kConsumerThreads); };
    auto need_mask = [&](int k0) {
      return k0 + kBlockN > skv || (causal && k0 + kBlockN - 1 > row_min);
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    float corr[2];
    float s[kBlockN / 2];
    uint32_t pf[kBlockN / 16][4];

    if (cw == 1) pass_turn();
    hopper::mbar_wait(bar.q, 0);

    // Tile 0: S, softmax, P.
    hopper::mbar_wait(bar.k, 0);
    take_turn();
    hopper::wgmma_fence();
    issue_qk<D>(s, q_base, base + L::kK);
    pass_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::mbar_arrive(bar.ek);
    softmax_tile(s, m_run, l_run, corr, need_mask(0), 0, skv, causal, qpos, t4, scale_log2);
    pack_p(pf, s);

    // Tile j: issue S_j and P_{j-1} V_{j-1}; softmax of S_j while the
    // second product runs.
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t phase = (j / kStages) & 1;
      const int sp = (j - 1) % kStages;
      const uint32_t pphase = ((j - 1) / kStages) & 1;
      hopper::mbar_wait(bar.k + 8 * st, phase);
      take_turn();
      hopper::wgmma_fence();
      issue_qk<D>(s, q_base, base + L::kK + st * L::kTile);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      hopper::mbar_wait(bar.v + 8 * sp, pphase);
      hopper::wgmma_fence();
      issue_pv<D>(acc, pf, base + L::kV + sp * L::kTile);
      pass_turn();
      hopper::wgmma_wait<1>();  // S_j is done
      hopper::fence_regs(s);
      hopper::mbar_arrive(bar.ek + 8 * st);
      const int k0 = j * kBlockN;
      softmax_tile(s, m_run, l_run, corr, need_mask(k0), k0, skv, causal, qpos, t4,
                   scale_log2);
      hopper::wgmma_wait<0>();  // P_{j-1} V_{j-1} is done
      hopper::fence_regs(acc);
      hopper::mbar_arrive(bar.ev + 8 * sp);
      pack_p(pf, s);
    }

    // The last tile's P V.
    {
      const int sp = (n_tiles - 1) % kStages;
      const uint32_t pphase = ((n_tiles - 1) / kStages) & 1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      hopper::mbar_wait(bar.v + 8 * sp, pphase);
      take_turn();
      hopper::wgmma_fence();
      issue_pv<D>(acc, pf, base + L::kV + sp * L::kTile);
      if (cw == 0) pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(bar.ev + 8 * sp);
    }

    // Finish the row sums across the quad that shares each row, then
    // normalise; a row that saw no key (l == 0) has acc == 0 -> zeros.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = l > 0.f ? hopper::rcp_approx(l) : 0.f;
      // m_run is in the log2 domain: lse = ln(2) * (m + log2(l)).
      if (lse != nullptr && t4 == 0 && qpos[r] < sq)
        lse[(static_cast<long long>(bi) * hq + h) * sq + qpos[r]] =
            l > 0.f ? (m_run[r] + log2f(l)) * 0.6931471805599453f : INFINITY;
    }

    // o: this warpgroup's 64 rows as bf16 into its rows of the Q tile,
    // which no product reads any more, in the 128-byte swizzle that TMA
    // expects (16-byte chunk c of row r at chunk c ^ (r % 8)), then one
    // TMA store per 64-column box; it skips rows past sq.
    unsigned char* smem = smem_raw + (base - hopper::smem_u32(smem_raw));
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int col = (8 * jn) % 64 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;  // row % 8 == g
        const uint32_t off = L::kQ + (jn / 8) * L::kBox + (64 * cw + row) * 128 +
                             (((col / 8) ^ g) * 16) + (col % 8) * 2;
        *reinterpret_cast<uint32_t*>(smem + off) = hopper::pack_bf16x2(
            acc[4 * jn + 2 * r] * inv[r], acc[4 * jn + 2 * r + 1] * inv[r]);
      }
    }
    hopper::fence_proxy_async();
    hopper::bar_sync(kStoreBar + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_store_4d(&tm_o, q_base + c * L::kBox, c * 64, row_min, h, bi);
      hopper::tma_store_commit_and_wait();
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long (&st)[9], int b, int hq, int hkv, int sq, int skv,
           float scale, int causal, cudaStream_t stream) {
  using L = Smem<D>;
  // q, k, v as the caller laid them out; o contiguous, 64-row boxes (one
  // consumer warpgroup's rows).
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int err = hopper::encode_bf16_4d(&tm_q, q, D, sq, hq, b, st[2], st[1], st[0], kBlockM);
  if (err == 0)
    err = hopper::encode_bf16_4d(&tm_k, k, D, skv, hkv, b, st[5], st[4], st[3], kBlockN);
  if (err == 0)
    err = hopper::encode_bf16_4d(&tm_v, v, D, skv, hkv, b, st[8], st[7], st[6], kBlockN);
  if (err == 0)
    err = hopper::encode_bf16_4d(&tm_o, o, D, sq, hq, b, D, static_cast<long long>(sq) * D,
                                 static_cast<long long>(hq) * sq * D, kBlockM / 2);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, hq, b);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_o, lse, hq, hkv, sq, skv, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 on success, a cudaError_t, or one of
// hopper_common.cuh's negative tensor-map codes (see
// mxtpu_cuda_error_string). Strides are in elements: (batch, head, seq)
// for q, k and v. `lse` may be null (inference), else f32 (b, hq, sq)
// contiguous.
int mxtpu_flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh,
                              long long k_ss, long long v_sb, long long v_sh,
                              long long v_ss, int b, int hq, int hkv, int sq,
                              int skv, int d, float scale, int causal,
                              void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d == 64) return launch<64>(q, k, v, o, l, st, b, hq, hkv, sq, skv, scale, causal, s);
  if (d == 128) return launch<128>(q, k, v, o, l, st, b, hq, hkv, sq, skv, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread of the d-wide forward kernel as the runtime reports
// them, and the dynamic shared memory bytes every launch of it asks
// for; returns a cudaError_t.
int mxtpu_flash_attn_fwd_attrs(int d, int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64) {
    err = cudaFuncGetAttributes(&a, flash_fwd_kernel<64>);
    *smem_bytes = Smem<64>::kBytes;
  } else if (d == 128) {
    err = cudaFuncGetAttributes(&a, flash_fwd_kernel<128>);
    *smem_bytes = Smem<128>::kBytes;
  }
  if (err == cudaSuccess) *regs = a.numRegs;
  return static_cast<int>(err);
}

const char* mxtpu_cuda_error_string(int err) {
  static thread_local char msg[96];
  if (err == hopper::kErrNoEncode)
    return "the CUDA driver has no cuTensorMapEncodeTiled or cuTensorMapEncodeIm2col";
  if (err <= hopper::kErrEncodeBase) {
    snprintf(msg, sizeof msg, "a tensor-map encode failed with CUresult %d",
             hopper::kErrEncodeBase - err);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
