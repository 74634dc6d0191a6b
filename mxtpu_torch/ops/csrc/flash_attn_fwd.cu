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
// as zeros (_finalize).
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // q rows per CTA
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kWarps = 4;     // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 of padding per shared-memory row
constexpr float kNegInf = -1e30f;  // finite start of the running max
static_assert(kBlockM == kBlockN, "load_tile stages Q and K/V tiles alike");

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

// Copy `rows` rows of D bf16 (row stride `ld` elements) into a
// kBlockN x (D + kPad) shared tile, 16 bytes per thread per step;
// rows past `rows` are zero-filled so padded keys hold no NaN.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* gmem,
                                          long long ld, int rows, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kStride = D + kPad;
  for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(gmem + r * ld + col);
    *reinterpret_cast<uint4*>(smem + r * kStride + col) = val;
  }
}

struct Strides {
  long long b, h, s;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 Strides qst, Strides kst, Strides vst,
                 int hq, int hkv, int sq, int skv,
                 float scale_log2, int causal) {
  constexpr int kStride = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockM * kStride;
  __nv_bfloat16* Vs = Ks + kBlockN * kStride;
  const uint16_t* Vh = reinterpret_cast<const uint16_t*>(Vs);

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

  load_tile<D>(Qs, qb, qst.s, min(kBlockM, sq - q0), tid);
  __syncthreads();

  // A fragments of this warp's 16 x D slice of Q.
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = Qs + r0 * kStride + kk * 16 + t4 * 2;
    const __nv_bfloat16* p1 = p0 + 8 * kStride;
    qf[kk][0] = ld_b32(p0);
    qf[kk][1] = ld_b32(p1);
    qf[kk][2] = ld_b32(p0 + 8);
    qf[kk][3] = ld_b32(p1 + 8);
  }

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
    load_tile<D>(Ks, kb + k0 * kst.s, kst.s, min(kBlockN, skv - k0), tid);
    load_tile<D>(Vs, vb + k0 * vst.s, vst.s, min(kBlockN, skv - k0), tid);
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
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * kStride + kk * 16 + t4 * 2;
        mma_16816(s[nt], qf[kk], ld_b32(kp), ld_b32(kp + 8));
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
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* vp = Vh + (kk * 16 + t4 * 2) * kStride + g;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const uint16_t* c = vp + nt * 8;
        const uint32_t b0 = static_cast<uint32_t>(c[0]) |
                            (static_cast<uint32_t>(c[kStride]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(c[8 * kStride]) |
                            (static_cast<uint32_t>(c[9 * kStride]) << 16);
        mma_16816(acc[nt], a, b0, b1);
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
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
    if (qpos[0] < sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * D + col) =
          pack_bf16(acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    if (qpos[1] < sq)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * D + col) =
          pack_bf16(acc[nt][2] * inv[1], acc[nt][3] * inv[1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
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
      qst, kst, vst, hq, hkv, sq, skv, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// Strides are in elements: (batch, head, seq) for q, k and v.
int mxtpu_flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh,
                              long long k_ss, long long v_sb, long long v_sh,
                              long long v_ss, int b, int hq, int hkv, int sq,
                              int skv, int d, float scale, int causal,
                              void* stream) {
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss}, vst{v_sb, v_sh, v_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, o, qst, kst, vst, b, hq, hkv, sq, skv, scale, causal, st);
  if (d == 128)
    return launch<128>(q, k, v, o, qst, kst, vst, b, hq, hkv, sq, skv, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
