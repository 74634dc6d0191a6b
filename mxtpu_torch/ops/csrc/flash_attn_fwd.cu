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
//
// Accepts: bf16 only (f32 inputs get a clear error from the Python
// wrapper; there is no SIMT instantiation), d in {64, 128}, any
// sq, skv >= 1 (the ragged edge is masked here), causal or not. q, k
// and v may be strided views with a unit last-dim stride and 16-byte
// aligned rows (the (b, s, h, d) -> (b, h, s, d) transposes of the
// model need no copy); o is written contiguous.
//
// Design (simple and right first): one CTA per (64-row q tile, q head,
// batch), 4 warps, each owning 16 q rows. The CTA stages its Q tile in
// shared memory once and keeps its A fragments in registers; it then
// walks K/V in 64-key tiles staged in shared memory, computes
// S = Q K^T and O += P V with mma.sync.m16n8k16 (bf16 in, f32 out) and
// keeps the online softmax (running max and sum) in f32 registers. The
// S accumulator fragment is re-packed in registers as the A operand of
// P V, so P never touches shared memory. Tiles wholly above the
// diagonal are skipped when causal, and causal CTAs launch heaviest
// first. Rows are padded by 8 bf16 in shared memory so the fragment
// loads hit 32 distinct banks.
//
// Bound at the main path's shape (llama3_8b, b=1, hq=32, hkv=8,
// s=2048, d=128, causal): 2*s^2*d*hq = 34.4 GFLOP of bf16 tensor-core
// work, 34.7 us at 989 TFLOP/s dense, against 42 MB of q, k, v and o,
// 12.5 us at 3.35 TB/s: compute-bound. What this design leaves on the
// table: mma.sync instead of wgmma (Hopper's full tensor-core rate is
// reached only through warpgroup MMA), synchronous global->shared copies
// with no double buffering (no cp.async/TMA pipeline, so loads and MMAs
// do not overlap), V's B fragments gathered with 16-bit shared loads
// instead of ldmatrix.trans, and no warp specialisation.
#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::kPad;
using flash::Strides;

constexpr int kBlockM = 64;   // q rows per CTA
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kWarps = 4;     // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // finite start of the running max

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,
                 Strides qst, Strides kst, Strides vst,
                 int hq, int hkv, int sq, int skv,
                 float scale_log2, int causal) {
  constexpr int kStride = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockM * kStride;
  __nv_bfloat16* Vs = Ks + kBlockN * kStride;

  const int m_block = causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t4 = lane & 3;  // fragment column pair

  const int q0 = m_block * kBlockM;
  const __nv_bfloat16* qb = q + bi * qst.b + h * qst.h + q0 * qst.s;
  const __nv_bfloat16* kb = k + bi * kst.b + hk * kst.h;
  const __nv_bfloat16* vb = v + bi * vst.b + hk * vst.h;
  __nv_bfloat16* ob = o + ((static_cast<long long>(bi) * hq + h) * sq + q0) * D;

  flash::load_tile<D, kBlockM, kThreads>(Qs, qb, qst.s, min(kBlockM, sq - q0), tid);
  __syncthreads();

  // A fragments of this warp's 16 x D slice of Q.
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    flash::load_a(qf[kk], Qs, kStride, warp * 16, kk * 16, g, t4);

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};

  const int kv_end = causal ? min(skv, q0 + kBlockM) : skv;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  for (int nb = 0; nb < n_tiles; ++nb) {
    const int k0 = nb * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    flash::load_tile<D, kBlockN, kThreads>(Ks, kb + k0 * kst.s, kst.s,
                                           min(kBlockN, skv - k0), tid);
    flash::load_tile<D, kBlockN, kThreads>(Vs, vb + k0 * vst.s, vst.s,
                                           min(kBlockN, skv - k0), tid);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        uint32_t b0, b1;
        flash::load_b(b0, b1, Ks, kStride, nt * 8, kk * 16, g, t4);
        flash::mma_16816(s[nt], qf[kk], b0, b1);
      }
    }

    // Scale into the log2 domain, mask, and take the row max. Masked
    // scores become -inf, so exp2 gives them exactly 0 while the
    // running max stays finite (>= kNegInf).
    const bool need_mask = (k0 + kBlockN > skv) || (causal && k0 + kBlockN - 1 > q0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[nt][j] * scale_log2;
        if (need_mask) {
          const int kpos = k0 + nt * 8 + t4 * 2 + (j & 1);
          if (kpos >= skv || (causal && kpos > qpos[j >> 1])) x = -INFINITY;
        }
        s[nt][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[nt][j] - m_run[j >> 1]);
        l_run[j >> 1] += p;
        s[nt][j] = p;
      }
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are exactly
    // the A fragment of keys [16kk, 16kk+16). V's B fragment pairs two
    // keys of one column, so it is gathered with two 16-bit loads.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = flash::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = flash::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = flash::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = flash::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t b0, b1;
        flash::load_b_trans(b0, b1, Vs, kStride, kk * 16, nt * 8, g, t4);
        flash::mma_16816(acc[nt], a, b0, b1);
      }
    }
  }

  // Finish the row sums across the quad that shares each row, then
  // normalise; a row that saw no key (l == 0) has acc == 0 -> zeros.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = l > 0.f ? 1.f / l : 0.f;
    // m_run is in the log2 domain: lse = ln(2) * (m + log2(l)).
    if (lse != nullptr && t4 == 0 && qpos[i] < sq)
      lse[(static_cast<long long>(bi) * hq + h) * sq + qpos[i]] =
          l > 0.f ? (m_run[i] + log2f(l)) * 0.6931471805599453f : INFINITY;
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
    if (qpos[0] < sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * D + col) =
          flash::pack_bf16(acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    if (qpos[1] < sq)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * D + col) =
          flash::pack_bf16(acc[nt][2] * inv[1], acc[nt][3] * inv[1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Strides qst, Strides kst, Strides vst, int b, int hq, int hkv,
           int sq, int skv, float scale, int causal, cudaStream_t stream) {
  constexpr int kSmem = (kBlockM + 2 * kBlockN) * (D + kPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, hq, b);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, qst, kst, vst, hq, hkv, sq, skv, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// Strides are in elements: (batch, head, seq) for q, k and v. `lse` may
// be null (inference), else f32 (b, hq, sq) contiguous.
int mxtpu_flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh,
                              long long k_ss, long long v_sb, long long v_sh,
                              long long v_ss, int b, int hq, int hkv, int sq,
                              int skv, int d, float scale, int causal,
                              void* stream) {
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss}, vst{v_sb, v_sh, v_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, o, static_cast<float*>(lse), qst, kst, vst, b, hq, hkv, sq, skv, scale, causal, st);
  if (d == 128)
    return launch<128>(q, k, v, o, static_cast<float*>(lse), qst, kst, vst, b, hq, hkv, sq, skv, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
