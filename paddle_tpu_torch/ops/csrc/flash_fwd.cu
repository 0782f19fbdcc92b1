// Flash attention forward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd).  Same function: blockwise attention over
// q,k,v [B, L, H, D] with an online softmax in the exp2 domain, per-batch
// kv_lens, runtime q_offset / kv_offset for the causal rule
// kv_offset + k_pos <= q_offset + q_pos, output O [B, Lq, H, D] and the
// natural-log LSE [B, H, Lq].  Fully-masked rows give O = 0 and
// LSE = NEG_INF / LOG2E + log(1e-30), like l_safe in the TPU kernel.
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
// read through their strides: no transposed copy is made.  The TPU kernel's
// unmasked interior loop is not split out here; every tile is masked.
// flash_common.cuh holds the tile loader and the visibility rule, shared
// with the backward kernels (flash_bwd.cu).

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr size_t kSmemBytes =
    sizeof(float) * (kBq * kQs + kBk * kQs + kBk * kDMax + kBq * kPs);

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int* __restrict__ kv_lens, float* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int H, int D,
                 long long sqb, long long sql, long long sqh,
                 long long skb, long long skl, long long skh,
                 long long svb, long long svl, long long svh,
                 int q_off, int kv_off, int causal, float scale_log2) {
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
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;

  load_tile(sQ, kQs, qb, sql, q0, Lq, D, scale_log2);

  // KV tiles this q tile can see (flash_common.cuh kv_tiles)
  const int nk_eff =
      kv_tiles(qi, (Lk + kBk - 1) / kBk, row_len, causal, q_off, kv_off);

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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = (long long)q_off + q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = k0 + tx + 16 * jj;
        ok[jj] = visible(qpos, kp, row_len, causal, kv_off);
        if (!ok[jj]) sc[i][jj] = kNegInf;
        mx = fmaxf(mx, sc[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? exp2f(sc[i][jj] - m_new) : 0.f;
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
    float* out = o + (((long long)b * Lq + row) * H + h) * D;
    if (tx * 4 < D)
      *reinterpret_cast<float4*>(out + tx * 4) = make_float4(
          acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    if (64 + tx * 4 < D)
      *reinterpret_cast<float4*>(out + 64 + tx * 4) = make_float4(
          acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv, acc[i][7] * inv);
    if (tx == 0)
      lse[((long long)b * H + h) * Lq + row] =
          m[i] * (1.f / kLog2e) + logf(l_safe);
  }
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* kv_lens, void* o, void* lse, int B,
                             int Lq, int Lk, int H, int D, long long sqb,
                             long long sql, long long sqh, long long skb,
                             long long skl, long long skh, long long svb,
                             long long svl, long long svh, int q_off,
                             int kv_off, int causal, float scale_log2,
                             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBq - 1) / kBq, B * H);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)kv_lens,
      (float*)o, (float*)lse, Lq, Lk, H, D, sqb, sql, sqh, skb, skl, skh, svb,
      svl, svh, q_off, kv_off, causal, scale_log2);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
