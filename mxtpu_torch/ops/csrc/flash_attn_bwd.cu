// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in,
// f32 accumulation, bf16 out.
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
// for a row with no visible key, whose P and grads are then exactly 0)
// and D is computed by the caller, as the reference computes it outside
// its kernels (flash_attention.py:274-276).
//
// Shapes: q, dO (b, hq, sq, d); k, v (b, hkv, skv, d), GQA with hq a
// multiple of hkv; lse, D f32 (b, hq, sq) contiguous; dq (b, hq, sq, d)
// and dk, dv (b, hkv, skv, d) written contiguous in bf16. q, k, v and dO
// may be strided views with a unit last-dim stride and 16-byte aligned
// rows. d in {64, 128}; any sq, skv >= 1. Causal is qpos >= kpos with
// both counted from 0, as in the forward.
//
// Design (simple and right first; no wgmma, TMA or pipelining):
// - dK/dV: one CTA per (64-key tile, kv head, batch), 4 warps, each
//   owning 16 keys. K_j and V_j stay in shared memory; the CTA walks the
//   hq/hkv query heads of its group and, for each, the 64-row query
//   tiles from the first one the causal mask lets see the tile. A warp
//   works through a staged query tile 16 queries at a time: S^T = K Q^T
//   and dP^T = V dO^T (16 keys x 16 queries), then P^T and dS^T in
//   registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//   re-packed in registers as A fragments. The group's heads are summed
//   in the f32 accumulators, so GQA needs no atomics and no repeated
//   K/V; dK and dV are written once.
// - dQ: one CTA per (64-row query tile, q head, batch), 4 warps of 16
//   rows; Q and dO fragments stay in registers, and the CTA walks K/V
//   tiles up to the causal limit, 16 keys at a time: S = Q K^T,
//   dP = dO V^T, dS, and dQ += dS K.
// - Register budget: a dK/dV thread holds two 16 x d f32 accumulators
//   (2 * d/2 registers), so the 16-query step keeps S^T and dP^T at 8
//   registers each and reloads the K/V fragments from shared memory
//   instead of keeping them in registers (see PERF.md for ptxas' report).
//
// Bound at the main path's shape (llama3_8b, b=1, hq=32, hkv=8, s=2048,
// d=128, causal): 5 matmuls over 2.1 M visible (q, k) pairs per head,
// 86 GFLOP, 87 us at 989 TFLOP/s dense; about 50 MB of q, k, v, o, dO,
// lse, D and the grads, 15 us at 3.35 TB/s: compute-bound. Left on the
// table: wgmma, cp.async/TMA double buffering, ldmatrix for the gathered
// B fragments, and the dS/P recomputation shared between the two kernels.
#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::kPad;
using flash::Strides;

constexpr int kBlockQ = 64;   // query rows per tile
constexpr int kBlockKV = 64;  // keys per tile
constexpr int kWarps = 4;     // each warp owns 16 rows of its CTA's tile
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     Strides qst, Strides kst, Strides vst, Strides dost,
                     int hq, int hkv, int sq, int skv, float scale, int causal) {
  constexpr int kStride = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kBlockKV * kStride;
  __nv_bfloat16* Qs = Vs + kBlockKV * kStride;
  __nv_bfloat16* dOs = Qs + kBlockQ * kStride;
  float* lse_s = reinterpret_cast<float*>(dOs + kBlockQ * kStride);  // log2 domain
  float* d_s = lse_s + kBlockQ;

  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int rep = hq / hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;

  const int k0 = blockIdx.x * kBlockKV;
  const int kv_rows = min(kBlockKV, skv - k0);
  flash::load_tile<D, kBlockKV, kThreads>(Ks, k + bi * kst.b + hk * kst.h + k0 * kst.s,
                                          kst.s, kv_rows, tid);
  flash::load_tile<D, kBlockKV, kThreads>(Vs, v + bi * vst.b + hk * vst.h + k0 * vst.s,
                                          vst.s, kv_rows, tid);
  const int kr0 = warp * 16 + g;  // this thread's key rows: kr0, kr0 + 8
  const int kpos[2] = {k0 + kr0, k0 + kr0 + 8};

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nt][j] = dv_acc[nt][j] = 0.f;

  // The first query tile holding a row that can see a key of this tile.
  const int m_start = causal ? k0 / kBlockQ : 0;
  const int n_mtiles = (sq + kBlockQ - 1) / kBlockQ;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const __nv_bfloat16* qh = q + bi * qst.b + h * qst.h;
    const __nv_bfloat16* doh = dout + bi * dost.b + h * dost.h;
    const long long row0 = (static_cast<long long>(bi) * hq + h) * sq;
    for (int mb = m_start; mb < n_mtiles; ++mb) {
      const int q0 = mb * kBlockQ;
      const int q_rows = min(kBlockQ, sq - q0);
      __syncthreads();  // every warp is done with the previous tile
      flash::load_tile<D, kBlockQ, kThreads>(Qs, qh + q0 * qst.s, qst.s, q_rows, tid);
      flash::load_tile<D, kBlockQ, kThreads>(dOs, doh + q0 * dost.s, dost.s, q_rows, tid);
      // Padded query rows get lse = +inf and D = 0: their P is exactly 0.
      for (int r = tid; r < kBlockQ; r += kThreads) {
        lse_s[r] = r < q_rows ? lse[row0 + q0 + r] * kLog2e : INFINITY;
        d_s[r] = r < q_rows ? delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();
      const bool need_mask =
          (k0 + kBlockKV > skv) || (causal && q0 < k0 + kBlockKV - 1);

#pragma unroll 1
      for (int c = 0; c < kBlockQ / 16; ++c) {  // 16 queries at a time
        // S^T = K Q^T and dP^T = V dO^T, 16 keys x 16 queries (2 n-tiles).
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[n][j] = dpt[n][j] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ka[4], va[4];
          flash::load_a(ka, Ks, kStride, warp * 16, kk * 16, g, t4);
          flash::load_a(va, Vs, kStride, warp * 16, kk * 16, g, t4);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint32_t b0, b1;
            flash::load_b(b0, b1, Qs, kStride, c * 16 + n * 8, kk * 16, g, t4);
            flash::mma_16816(st[n], ka, b0, b1);
            flash::load_b(b0, b1, dOs, kStride, c * 16 + n * 8, kk * 16, g, t4);
            flash::mma_16816(dpt[n], va, b0, b1);
          }
        }
        // P^T and dS^T: element (n, j) is key kr0 + 8 * (j >> 1) and
        // query c*16 + n*8 + 2*t4 + (j & 1) of the tile.
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qr = c * 16 + n * 8 + t4 * 2 + (j & 1);
            float x = st[n][j] * scale_log2;
            if (need_mask) {
              const int kp = kpos[j >> 1];
              if (kp >= skv || (causal && kp > q0 + qr)) x = -INFINITY;
            }
            const float p = exp2f(x - lse_s[qr]);
            st[n][j] = p;
            dpt[n][j] = p * (dpt[n][j] - d_s[qr]);
          }
        }
        uint32_t pa[4], da[4];
        pa[0] = flash::pack_bf16(st[0][0], st[0][1]);
        pa[1] = flash::pack_bf16(st[0][2], st[0][3]);
        pa[2] = flash::pack_bf16(st[1][0], st[1][1]);
        pa[3] = flash::pack_bf16(st[1][2], st[1][3]);
        da[0] = flash::pack_bf16(dpt[0][0], dpt[0][1]);
        da[1] = flash::pack_bf16(dpt[0][2], dpt[0][3]);
        da[2] = flash::pack_bf16(dpt[1][0], dpt[1][1]);
        da[3] = flash::pack_bf16(dpt[1][2], dpt[1][3]);
        // dV += P^T dO and dK += dS^T Q over these 16 queries.
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          uint32_t b0, b1;
          flash::load_b_trans(b0, b1, dOs, kStride, c * 16, nt * 8, g, t4);
          flash::mma_16816(dv_acc[nt], pa, b0, b1);
          flash::load_b_trans(b0, b1, Qs, kStride, c * 16, nt * 8, g, t4);
          flash::mma_16816(dk_acc[nt], da, b0, b1);
        }
      }
    }
  }

  __nv_bfloat16* dkb = dk + ((static_cast<long long>(bi) * hkv + hk) * skv + k0) * D;
  __nv_bfloat16* dvb = dv + ((static_cast<long long>(bi) * hkv + hk) * skv + k0) * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kpos[i] >= skv) continue;
      const int r = kr0 + 8 * i;
      *reinterpret_cast<uint32_t*>(dkb + r * D + col) =
          flash::pack_bf16(dk_acc[nt][2 * i] * scale, dk_acc[nt][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + r * D + col) =
          flash::pack_bf16(dv_acc[nt][2 * i], dv_acc[nt][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq,
                    Strides qst, Strides kst, Strides vst, Strides dost,
                    int hq, int hkv, int sq, int skv, float scale, int causal) {
  constexpr int kStride = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kBlockQ * kStride;
  __nv_bfloat16* Ks = dOs + kBlockQ * kStride;
  __nv_bfloat16* Vs = Ks + kBlockKV * kStride;

  // Causal CTAs launch heaviest (latest query tile) first.
  const int m_block = causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;

  const int q0 = m_block * kBlockQ;
  const int q_rows = min(kBlockQ, sq - q0);
  flash::load_tile<D, kBlockQ, kThreads>(Qs, q + bi * qst.b + h * qst.h + q0 * qst.s,
                                         qst.s, q_rows, tid);
  flash::load_tile<D, kBlockQ, kThreads>(dOs, dout + bi * dost.b + h * dost.h + q0 * dost.s,
                                         dost.s, q_rows, tid);
  __syncthreads();

  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    flash::load_a(qf[kk], Qs, kStride, warp * 16, kk * 16, g, t4);
    flash::load_a(df[kk], dOs, kStride, warp * 16, kk * 16, g, t4);
  }
  const int r0 = warp * 16 + g;
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  const long long row0 = (static_cast<long long>(bi) * hq + h) * sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = qpos[i] < sq ? lse[row0 + qpos[i]] * kLog2e : INFINITY;
    dl[i] = qpos[i] < sq ? delta[row0 + qpos[i]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const __nv_bfloat16* kb = k + bi * kst.b + hk * kst.h;
  const __nv_bfloat16* vb = v + bi * vst.b + hk * vst.h;
  const int kv_end = causal ? min(skv, q0 + kBlockQ) : skv;
  const int n_tiles = (kv_end + kBlockKV - 1) / kBlockKV;
  for (int nb = 0; nb < n_tiles; ++nb) {
    const int k0 = nb * kBlockKV;
    __syncthreads();  // every warp is done with the previous tile
    flash::load_tile<D, kBlockKV, kThreads>(Ks, kb + k0 * kst.s, kst.s,
                                            min(kBlockKV, skv - k0), tid);
    flash::load_tile<D, kBlockKV, kThreads>(Vs, vb + k0 * vst.s, vst.s,
                                            min(kBlockKV, skv - k0), tid);
    __syncthreads();
    const bool need_mask =
        (k0 + kBlockKV > skv) || (causal && k0 + kBlockKV - 1 > q0);

#pragma unroll 1
    for (int c = 0; c < kBlockKV / 16; ++c) {  // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t b0, b1;
          flash::load_b(b0, b1, Ks, kStride, c * 16 + n * 8, kk * 16, g, t4);
          flash::mma_16816(s[n], qf[kk], b0, b1);
          flash::load_b(b0, b1, Vs, kStride, c * 16 + n * 8, kk * 16, g, t4);
          flash::mma_16816(dp[n], df[kk], b0, b1);
        }
      }
      // dS: element (n, j) is row r0 + 8 * (j >> 1), key
      // k0 + c*16 + n*8 + 2*t4 + (j & 1).
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          float x = s[n][j] * scale_log2;
          if (need_mask) {
            const int kp = k0 + c * 16 + n * 8 + t4 * 2 + (j & 1);
            if (kp >= skv || (causal && kp > qpos[i])) x = -INFINITY;
          }
          const float p = exp2f(x - lse2[i]);
          dp[n][j] = p * (dp[n][j] - dl[i]);
        }
      }
      uint32_t da[4];
      da[0] = flash::pack_bf16(dp[0][0], dp[0][1]);
      da[1] = flash::pack_bf16(dp[0][2], dp[0][3]);
      da[2] = flash::pack_bf16(dp[1][0], dp[1][1]);
      da[3] = flash::pack_bf16(dp[1][2], dp[1][3]);
      // dQ += dS K over these 16 keys.
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t b0, b1;
        flash::load_b_trans(b0, b1, Ks, kStride, c * 16, nt * 8, g, t4);
        flash::mma_16816(acc[nt], da, b0, b1);
      }
    }
  }

  __nv_bfloat16* dqb = dq + (row0 + q0) * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qpos[i] >= sq) continue;
      *reinterpret_cast<uint32_t*>(dqb + (r0 + 8 * i) * D + col) =
          flash::pack_bf16(acc[nt][2 * i] * scale, acc[nt][2 * i + 1] * scale);
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  Strides qst, kst, vst, dost;
  int b, hq, hkv, sq, skv;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
int launch_dkv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv) {
  constexpr int kSmem = (2 * kBlockKV + 2 * kBlockQ) * (D + kPad) * sizeof(__nv_bfloat16) +
                        2 * kBlockQ * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.skv + kBlockKV - 1) / kBlockKV, a.hkv, a.b);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, a.qst, a.kst, a.vst, a.dost,
      a.hq, a.hkv, a.sq, a.skv, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Args& a, __nv_bfloat16* dq) {
  constexpr int kSmem = (2 * kBlockQ + 2 * kBlockKV) * (D + kPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.hq, a.b);
  flash_bwd_dq_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.qst, a.kst, a.vst, a.dost,
      a.hq, a.hkv, a.sq, a.skv, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const long long* st, int b,
               int hq, int hkv, int sq, int skv, float scale, int causal,
               void* stream) {
  return Args{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<const __nv_bfloat16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              Strides{st[0], st[1], st[2]},
              Strides{st[3], st[4], st[5]},
              Strides{st[6], st[7], st[8]},
              Strides{st[9], st[10], st[11]},
              b, hq, hkv, sq, skv, scale, causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return cudaGetLastError()
// (0 on success). Strides are in elements: (batch, head, seq) for q, k,
// v and dO, in that order. lse and D are f32 (b, hq, sq) contiguous;
// the outputs are bf16 and contiguous.
int mxtpu_flash_attn_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, int b, int hq, int hkv, int sq, int skv, int d, float scale,
    int causal, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  const Args a = make_args(q, k, v, dout, lse, delta, st, b, hq, hkv, sq, skv,
                           scale, causal, stream);
  auto* dk_ = static_cast<__nv_bfloat16*>(dk);
  auto* dv_ = static_cast<__nv_bfloat16*>(dv);
  if (d == 64) return launch_dkv<64>(a, dk_, dv_);
  if (d == 128) return launch_dkv<128>(a, dk_, dv_);
  return static_cast<int>(cudaErrorInvalidValue);
}

int mxtpu_flash_attn_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh, long long do_ss,
    int b, int hq, int hkv, int sq, int skv, int d, float scale, int causal,
    void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  const Args a = make_args(q, k, v, dout, lse, delta, st, b, hq, hkv, sq, skv,
                           scale, causal, stream);
  auto* dq_ = static_cast<__nv_bfloat16*>(dq);
  if (d == 64) return launch_dq<64>(a, dq_);
  if (d == 128) return launch_dq<128>(a, dq_);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
