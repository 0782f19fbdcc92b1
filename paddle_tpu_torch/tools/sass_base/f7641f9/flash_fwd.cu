// Flash attention forward on CUDA cores, float32 or bf16 in, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd).  Same function: blockwise attention over
// q,k,v [B, L, H, D] with an online softmax in the exp2 domain, per-batch
// kv_lens, runtime q_offset / kv_offset for the causal rule
// kv_offset + k_pos <= q_offset + q_pos, output O [B, Lq, H, D] in the
// inputs' type and the natural-log LSE [B, H, Lq] in float32.  bf16 inputs
// are converted to float32 as they are staged into shared memory (the TPU
// kernel upcasts before its dots); all arithmetic is float32.  Fully-masked
// rows give O = 0 and LSE = NEG_INF / LOG2E + log(1e-30), like l_safe in
// the TPU kernel.
//
// What bounds it on the H100: operations.  A prefill chunk of c rows against
// a gathered cache does 4 * D * (visible q,k pairs) flops per head on
// O(c + visible keys) bytes, far above the float32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte).  Float32 here has no tensor-core path that keeps
// the 1e-4 agreement with the plain version (TF32 keeps ~3 digits), so both
// products run as CUDA-core FMAs.
//
// Design: one block of 256 threads per (64-row q tile, batch*head).  The q
// tile (pre-scaled by scale*log2e) stays in shared memory; 64-row K and V
// tiles stream through shared memory; each thread owns a 4x4 patch of the
// 64x64 score tile and a 4x8 patch of the 64xD output accumulator.
// The KV sweep stops at the causal diagonal of the tile's last row (the
// bound of _causal_nk_eff) and at the row's kv_len, so an 8-row chunk at
// offset t reads about t keys, not the whole gathered cache.  Inputs are
// read through their strides: no transposed copy is made.
//
// The body is a template on <T, EXP2, SPLIT>.  Kernel 1 is the <exp2,
// unsplit> instance (every tile masked), at float32 and at bf16.  The other
// bf16 instances are the f32-dot rows of the forward ablation sweep
// (tools/flash_variants.py::_fwd_kernel_v2 with bf16_dots=False, ported in
// ops/flash_variants.py): EXP2 off works in the natural-exp domain (q
// scaled by `scale`, expf, LSE = m + log l), and SPLIT runs the tiles that
// every row of the q tile sees whole (below the causal diagonal of its
// first row and inside kv_len) without the visibility test, then the
// boundary tiles with it, as the TPU kernel's two loops do.
// flash_common.cuh holds the tile loader, the store of four outputs and
// the visibility rule, shared with the backward kernels (flash_bwd.cu).

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr size_t kSmemBytes =
    sizeof(float) * (kBq * kQs + kBk * kQs + kBk * kDMax + kBq * kPs);

// scale_q folds into q as it is staged: scale * log2(e) with EXP2, scale
// without.
template <typename T, bool EXP2, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v,
                 const int* __restrict__ kv_lens, T* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int H, int D,
                 long long sqb, long long sql, long long sqh,
                 long long skb, long long skl, long long skh,
                 long long svb, long long svl, long long svh,
                 int q_off, int kv_off, int causal, float scale_q) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kBq][kQs]
  float* sK = sQ + kBq * kQs;                    // [kBk][kQs]
  float* sV = sK + kBk * kQs;                    // [kBk][kDMax]
  float* sP = sV + kBk * kDMax;                  // [kBq][kPs]

  const int qi = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qi * kBq;
  const int row_len = min(kv_lens[b], Lk);
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  load_tile(sQ, kQs, qb, sql, q0, Lq, D, scale_q);

  // KV tiles this q tile can see (flash_common.cuh kv_tiles)
  const int nk_eff =
      kv_tiles(qi, (Lk + kBk - 1) / kBk, row_len, causal, q_off, kv_off);
  // SPLIT: tiles [0, j_full) are visible to every row of the q tile
  // (tools/flash_variants.py j_full; division truncates as lax.div does)
  int j_full = 0;
  if (SPLIT) {
    long long jf = nk_eff;
    if (causal) {
      jf = ((long long)q_off - kv_off + (long long)q0 + 1) / kBk;
      jf = jf < 0 ? 0 : min(jf, (long long)nk_eff);
    }
    j_full = (int)min(jf, (long long)(row_len / kBk));
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < nk_eff; ++j) {
    const int k0 = j * kBk;
    __syncthreads();                   // previous tile fully consumed
    load_tile(sK, kQs, kb, skl, k0, Lk, D, 1.f);
    load_tile(sV, kDMax, vb, svl, k0, Lk, D, 1.f);
    __syncthreads();

    // scores (log2 domain): rows ty + 16i, keys tx + 16jj
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * kQs + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kk[jj] =
            *reinterpret_cast<const float4*>(sK + (tx + 16 * jj) * kQs + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = dot4(a[i], kk[jj], sc[i][jj]);
    }

    // masked online softmax; a row's 64 keys live on the 16 threads that
    // share its ty (one half-warp), reduced with xor shuffles 8..1
    const bool masked = !SPLIT || j >= j_full;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = (long long)q_off + q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = k0 + tx + 16 * jj;
        ok[jj] = !masked || visible(qpos, kp, row_len, causal, kv_off);
        if (!ok[jj]) sc[i][jj] = kNegInf;
        mx = fmaxf(mx, sc[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = EXP2 ? exp2f(m[i] - m_new) : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = !ok[jj] ? 0.f
                        : EXP2  ? exp2f(sc[i][jj] - m_new)
                                : expf(sc[i][jj] - m_new);
        sP[(ty + 16 * i) * kPs + tx + 16 * jj] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // O += P V: columns tx*4..+3 and 64 + tx*4..+3 of rows ty + 16i
    for (int kk = 0; kk < kBk; ++kk) {
      const float4 v0 = *reinterpret_cast<const float4*>(sV + kk * kDMax + tx * 4);
      const float4 v1 =
          *reinterpret_cast<const float4*>(sV + kk * kDMax + 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty + 16 * i) * kPs + kk];
        acc[i][0] = fmaf(p, v0.x, acc[i][0]);
        acc[i][1] = fmaf(p, v0.y, acc[i][1]);
        acc[i][2] = fmaf(p, v0.z, acc[i][2]);
        acc[i][3] = fmaf(p, v0.w, acc[i][3]);
        acc[i][4] = fmaf(p, v1.x, acc[i][4]);
        acc[i][5] = fmaf(p, v1.y, acc[i][5]);
        acc[i][6] = fmaf(p, v1.z, acc[i][6]);
        acc[i][7] = fmaf(p, v1.w, acc[i][7]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / l_safe;
    T* out = o + (((long long)b * Lq + row) * H + h) * D;
    if (tx * 4 < D)
      store4(out + tx * 4, acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
             acc[i][3] * inv);
    if (64 + tx * 4 < D)
      store4(out + 64 + tx * 4, acc[i][4] * inv, acc[i][5] * inv,
             acc[i][6] * inv, acc[i][7] * inv);
    if (tx == 0)
      lse[((long long)b * H + h) * Lq + row] =
          EXP2 ? m[i] * (1.f / kLog2e) + logf(l_safe) : m[i] + logf(l_safe);
  }
}

template <typename T, bool EXP2, bool SPLIT>
int launch(const void* q, const void* k, const void* v, const void* kv_lens,
           void* o, void* lse, int B, int Lq, int Lk, int H, int D,
           long long sqb, long long sql, long long sqh, long long skb,
           long long skl, long long skh, long long svb, long long svl,
           long long svh, int q_off, int kv_off, int causal, float scale_q,
           void* stream) {
  auto kernel = flash_fwd_kernel<T, EXP2, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBq - 1) / kBq, B * H);
  kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)kv_lens, (T*)o,
      (float*)lse, Lq, Lk, H, D, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
      q_off, kv_off, causal, scale_q);
  return (int)cudaGetLastError();
}

}  // namespace

#define FLASH_FWD_ARGS                                                      \
  const void *q, const void *k, const void *v, const void *kv_lens, void *o, \
      void *lse, int B, int Lq, int Lk, int H, int D, long long sqb,         \
      long long sql, long long sqh, long long skb, long long skl,            \
      long long skh, long long svb, long long svl, long long svh, int q_off, \
      int kv_off, int causal, float scale_q, void *stream
#define FLASH_FWD_PASS                                                       \
  q, k, v, kv_lens, o, lse, B, Lq, Lk, H, D, sqb, sql, sqh, skb, skl, skh,  \
      svb, svl, svh, q_off, kv_off, causal, scale_q, stream

// Kernel 1 (scale_q = scale * log2 e), float32 in and out.
extern "C" int flash_fwd_f32(FLASH_FWD_ARGS) {
  return launch<float, true, false>(FLASH_FWD_PASS);
}

// Kernel 1 on bf16 q/k/v: O in bf16, LSE in float32.
extern "C" int flash_fwd_bf16(FLASH_FWD_ARGS) {
  return launch<__nv_bfloat16, true, false>(FLASH_FWD_PASS);
}

// The sweep's f32-dot rows on bf16 q/k/v: scale_q is scale * log2 e with
// exp2, scale without.
extern "C" int flash_fwd_f32dots_bf16(FLASH_FWD_ARGS, int exp2, int split) {
  if (exp2)
    return split ? launch<__nv_bfloat16, true, true>(FLASH_FWD_PASS)
                 : launch<__nv_bfloat16, true, false>(FLASH_FWD_PASS);
  return split ? launch<__nv_bfloat16, false, true>(FLASH_FWD_PASS)
               : launch<__nv_bfloat16, false, false>(FLASH_FWD_PASS);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
