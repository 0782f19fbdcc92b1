// Flash attention backward, float32, for Hopper (sm_90a): dK/dV and dQ.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/flash_attention.py::
// _bwd_dkdv_kernel (launched by _flash_bwd.dkdv_call) and _bwd_dq_kernel
// (launched by _flash_bwd): the FlashAttention-2 backward split, P
// recomputed from q, k and the natural-log LSE of the forward
// (p = exp2(s * scale * log2e - lse * log2e)) under the same kv_lens and
// offset-causal masks, with delta = rowsum(dO * O) - g_lse computed by the
// wrapper (so the LSE output's cotangent reaches dQ and dK):
//   dV = P^T dO,  dS = P * (dO V^T - delta),  dK = scale * dS^T Q,
//   dQ = scale * dS K.
//
// What bounds it on the H100: operations.  At the training shape (B 8,
// T 4096, 4 heads of 128, causal) dK/dV does 4 products and dQ 3 over the
// 8.39 M visible pairs of each (batch, head), 2 * D flops a pair for each
// product, on O(T * D) bytes: far above the float32 ridge of ~20
// flop/byte.  Float32 has no tensor-core path that keeps the 1e-4
// agreement with the plain version (TF32 keeps ~3 digits), so every
// product is CUDA-core FMAs, with the tile layout of flash_fwd.cu.
//
// dK/dV: one block of 256 threads per (64-key tile, batch*head).  The K
// and V tile stay in shared memory; q, dO, LSE and delta stream through it
// in 64-row tiles, from the first q tile that can see the key tile
// (first_q_tile, the transposed causal bound _causal_i0) to the last q
// row.  Each thread owns a 4x4 patch of the score and dP tiles and a 4x8
// patch of both accumulators; dK and dV are written once.  A block owns
// its tile, so there are no atomics and the result is the same every run;
// a key tile past the row's kv_len writes zeros.  The TPU wrapper windows
// the q axis past _DKDV_MAX_ROWS because its kernel keeps whole q rows in
// VMEM; this kernel streams q from device memory and needs no windowing.
//
// dQ: one block per (64-row q tile, batch*head).  The q tile (pre-scaled
// by scale * log2e), its dO rows, LSE and delta stay resident; K and V
// tiles stream up to kv_tiles (the causal bound _causal_nk_eff and the
// row's kv_len, the same rule the forward uses).
//
// Inputs are read through their strides: no transposed copy is made.
// Every tile is masked (no unmasked interior split, as in flash_fwd.cu).

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr size_t kDkdvSmemBytes =
    sizeof(float) * (4 * kBk * kQs + 2 * kBq * kPs + 2 * kBq);
constexpr size_t kDqSmemBytes = sizeof(float) * (4 * kBq * kQs + kBq * kPs);

// Scores (log2 domain) and dP of one (q tile, key tile) pair: q rows
// ty + 16a, keys tx + 16c.  sQ/sG hold the q tile and its dO rows,
// sK/sV the key tile.
__device__ __forceinline__ void scores_and_dp(const float* sQ,
                                              const float* sG,
                                              const float* sK,
                                              const float* sV, int D,
                                              int tx, int ty, float mul,
                                              float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * a) * kQs + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * kQs + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dot4(x[a], y[c], s[a][c]);
  }
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(sG + (ty + 16 * a) * kQs + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = *reinterpret_cast<const float4*>(sV + (tx + 16 * c) * kQs + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[a][c] = dot4(x[a], y[c], dp[a][c]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] *= mul;
}

__device__ __forceinline__ void fma4(float* acc, float w, float4 x) {
  acc[0] = fmaf(w, x.x, acc[0]);
  acc[1] = fmaf(w, x.y, acc[1]);
  acc[2] = fmaf(w, x.z, acc[2]);
  acc[3] = fmaf(w, x.w, acc[3]);
}

// Write rows r0 + ty + 16a (< nrows) of a 4x8 accumulator patch, times
// `mul`, into a [B, L, H, D] float32 tensor at (b, h).
__device__ __forceinline__ void store_patch(float* out, float acc[4][8],
                                           int r0, int nrows, int b, int h,
                                           int H, int D, int tx, int ty,
                                           float mul) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + ty + 16 * a;
    if (row >= nrows) continue;
    float* dst = out + (((long long)b * nrows + row) * H + h) * D;
    if (tx * 4 < D)
      *reinterpret_cast<float4*>(dst + tx * 4) =
          make_float4(acc[a][0] * mul, acc[a][1] * mul, acc[a][2] * mul,
                      acc[a][3] * mul);
    if (64 + tx * 4 < D)
      *reinterpret_cast<float4*>(dst + 64 + tx * 4) =
          make_float4(acc[a][4] * mul, acc[a][5] * mul, acc[a][6] * mul,
                      acc[a][7] * mul);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ kv_lens, float* __restrict__ dk,
                      float* __restrict__ dv, int Lq, int Lk, int H, int D,
                      long long sqb, long long sql, long long sqh,
                      long long skb, long long skl, long long skh,
                      long long svb, long long svl, long long svh,
                      long long sgb, long long sgl, long long sgh, int q_off,
                      int kv_off, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [kBk][kQs]
  float* sV = sK + kBk * kQs;                    // [kBk][kQs]
  float* sQ = sV + kBk * kQs;                    // [kBq][kQs]
  float* sG = sQ + kBq * kQs;                    // [kBq][kQs] dO rows
  float* sP = sG + kBq * kQs;                    // [kBq][kPs]
  float* sS = sP + kBq * kPs;                    // [kBq][kPs] dS
  float* sL = sS + kBq * kPs;                    // [kBq] lse * log2e
  float* sD = sL + kBq;                          // [kBq] delta

  const int kj = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kj * kBk;
  const int row_len = min(kv_lens[b], Lk);
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const float* gb = g + b * sgb + h * sgh;
  const float* lb = lse + ((long long)b * H + h) * Lq;
  const float* db = delta + ((long long)b * H + h) * Lq;
  const float scale_log2 = scale * kLog2e;

  load_tile(sK, kQs, kb, skl, k0, Lk, D, 1.f);
  load_tile(sV, kQs, vb, svl, k0, Lk, D, 1.f);

  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  const int nq = (Lq + kBq - 1) / kBq;
  const int i0 = first_q_tile(kj, nq, row_len, causal, q_off, kv_off);
  for (int i = i0; i < nq; ++i) {
    const int q0 = i * kBq;
    __syncthreads();                   // previous q tile fully consumed
    load_tile(sQ, kQs, qb, sql, q0, Lq, D, 1.f);
    load_tile(sG, kQs, gb, sgl, q0, Lq, D, 1.f);
    if (threadIdx.x < kBq) {
      const int r = q0 + threadIdx.x;
      sL[threadIdx.x] = r < Lq ? lb[r] * kLog2e : 0.f;
      sD[threadIdx.x] = r < Lq ? db[r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp(sQ, sG, sK, sV, D, tx, ty, scale_log2, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const long long qpos = (long long)q_off + q0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok =
            q0 + r < Lq && visible(qpos, k0 + tx + 16 * c, row_len, causal,
                                   kv_off);
        const float p = ok ? exp2f(s[a][c] - sL[r]) : 0.f;
        sP[r * kPs + tx + 16 * c] = p;
        sS[r * kPs + tx + 16 * c] = p * (dp[a][c] - sD[r]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: keys ty + 16a, columns tx*4..+3 and
    // 64 + tx*4..+3
    for (int r = 0; r < kBq; ++r) {
      const float4 g0 = *reinterpret_cast<const float4*>(sG + r * kQs + tx * 4);
      const float4 g1 =
          *reinterpret_cast<const float4*>(sG + r * kQs + 64 + tx * 4);
      const float4 x0 = *reinterpret_cast<const float4*>(sQ + r * kQs + tx * 4);
      const float4 x1 =
          *reinterpret_cast<const float4*>(sQ + r * kQs + 64 + tx * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = sP[r * kPs + ty + 16 * a];
        const float ds = sS[r * kPs + ty + 16 * a];
        fma4(acc_v[a], p, g0);
        fma4(acc_v[a] + 4, p, g1);
        fma4(acc_k[a], ds, x0);
        fma4(acc_k[a] + 4, ds, x1);
      }
    }
  }

  store_patch(dk, acc_k, k0, Lk, b, h, H, D, tx, ty, scale);
  store_patch(dv, acc_v, k0, Lk, b, h, H, D, tx, ty, 1.f);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_lens, float* __restrict__ dq,
                    int Lq, int Lk, int H, int D, long long sqb,
                    long long sql, long long sqh, long long skb,
                    long long skl, long long skh, long long svb,
                    long long svl, long long svh, long long sgb,
                    long long sgl, long long sgh, int q_off, int kv_off,
                    int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kBq][kQs], * scale*log2e
  float* sG = sQ + kBq * kQs;                    // [kBq][kQs] dO rows
  float* sK = sG + kBq * kQs;                    // [kBk][kQs]
  float* sV = sK + kBk * kQs;                    // [kBk][kQs]
  float* sS = sV + kBk * kQs;                    // [kBq][kPs] dS

  const int qi = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qi * kBq;
  const int row_len = min(kv_lens[b], Lk);
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const float* gb = g + b * sgb + h * sgh;
  const float* lb = lse + ((long long)b * H + h) * Lq;
  const float* db = delta + ((long long)b * H + h) * Lq;

  load_tile(sQ, kQs, qb, sql, q0, Lq, D, scale * kLog2e);
  load_tile(sG, kQs, gb, sgl, q0, Lq, D, 1.f);
  float l2[4], dl[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    l2[a] = row < Lq ? lb[row] * kLog2e : 0.f;
    dl[a] = row < Lq ? db[row] : 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  const int nk_eff =
      kv_tiles(qi, (Lk + kBk - 1) / kBk, row_len, causal, q_off, kv_off);
  for (int j = 0; j < nk_eff; ++j) {
    const int k0 = j * kBk;
    __syncthreads();                   // previous key tile fully consumed
    load_tile(sK, kQs, kb, skl, k0, Lk, D, 1.f);
    load_tile(sV, kQs, vb, svl, k0, Lk, D, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp(sQ, sG, sK, sV, D, tx, ty, 1.f, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const long long qpos = (long long)q_off + q0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok =
            q0 + r < Lq && visible(qpos, k0 + tx + 16 * c, row_len, causal,
                                   kv_off);
        sS[r * kPs + tx + 16 * c] =
            ok ? exp2f(s[a][c] - l2[a]) * (dp[a][c] - dl[a]) : 0.f;
      }
    }
    __syncthreads();

    // dQ += dS K: rows ty + 16a, columns tx*4..+3 and 64 + tx*4..+3
    for (int kk = 0; kk < kBk; ++kk) {
      const float4 k0v =
          *reinterpret_cast<const float4*>(sK + kk * kQs + tx * 4);
      const float4 k1v =
          *reinterpret_cast<const float4*>(sK + kk * kQs + 64 + tx * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = sS[(ty + 16 * a) * kPs + kk];
        fma4(acc[a], ds, k0v);
        fma4(acc[a] + 4, ds, k1v);
      }
    }
  }

  store_patch(dq, acc, q0, Lq, b, h, H, D, tx, ty, scale);
}

}  // namespace

extern "C" int flash_bwd_dkdv_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, const void* kv_lens, void* dk,
    void* dv, int B, int Lq, int Lk, int H, int D, long long sqb,
    long long sql, long long sqh, long long skb, long long skl,
    long long skh, long long svb, long long svl, long long svh,
    long long sgb, long long sgl, long long sgh, int q_off, int kv_off,
    int causal, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkdvSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + kBk - 1) / kBk, B * H);
  flash_bwd_dkdv_kernel<<<grid, kThreads, kDkdvSmemBytes,
                          (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)lse, (const float*)delta, (const int*)kv_lens,
      (float*)dk, (float*)dv, Lq, Lk, H, D, sqb, sql, sqh, skb, skl, skh,
      svb, svl, svh, sgb, sgl, sgh, q_off, kv_off, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, const void* kv_lens, void* dq,
    int B, int Lq, int Lk, int H, int D, long long sqb, long long sql,
    long long sqh, long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh, long long sgb,
    long long sgl, long long sgh, int q_off, int kv_off, int causal,
    float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBq - 1) / kBq, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmemBytes,
                        (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)lse, (const float*)delta, (const int*)kv_lens,
      (float*)dq, Lq, Lk, H, D, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
      sgb, sgl, sgh, q_off, kv_off, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
