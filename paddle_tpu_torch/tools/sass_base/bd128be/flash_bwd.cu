// Flash attention backward for Hopper (sm_90a): dK/dV and dQ, on float32
// operands on the CUDA cores, on bf16 operands on the tensor cores.
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
// Both instances keep the TPU kernels' work split: dK/dV owns a key tile
// and streams q tiles, dQ owns a q tile and streams key tiles, so a block
// owns its outputs, there are no atomics and the result is the same every
// run.  The visibility rule is flash_common.cuh's (first_q_tile for dK/dV,
// kv_tiles for dQ).  Inputs are read through their strides: no transposed
// copy is made.  The TPU wrapper windows the q axis past _DKDV_MAX_ROWS
// because its kernel keeps whole q rows in VMEM; these kernels stream from
// device memory and need no windowing.
//
// What bounds them on the H100: operations.  At the LM's training shape
// (B 8, T 4096, 4 heads of 128, causal) dK/dV does 4 products and dQ 3
// over the 8.39 M visible pairs of each (batch, head), 2 * D flops a pair
// for each product, on O(T * D) bytes: far above the ridge of either
// peak.
//
// float32 (flash_bwd_{dkdv,dq}_kernel<float>).  Float32 has no tensor-core
// path that keeps the 1e-4 agreement with the plain version (TF32 keeps
// ~3 digits), so every product is CUDA-core FMAs, with the tile layout of
// flash_fwd.cu.  dK/dV: one block of 256 threads per (64-key tile,
// batch*head); the K and V tile stay in shared memory, q, dO, LSE and
// delta stream through it in 64-row tiles from the first q tile that can
// see the key tile to the last q row; each thread owns a 4x4 patch of the
// score and dP tiles and a 4x8 patch of both accumulators.  dQ: one block
// per (64-row q tile, batch*head); the q tile (pre-scaled by scale *
// log2e), its dO rows, LSE and delta stay resident, K and V tiles stream
// up to kv_tiles.  Every tile is masked.  The kernels stay templates on
// the operand type, instantiated at float alone, so that their machine
// code and names are those chip_smoke.py pins against tools/sass_base/.
//
// bf16 (flash_bwd_{dkdv,dq}_mma_kernel<DT>, DT the head tile: 64 for
// D <= 64, else 128).  Every product is mma.sync m16n8k16 on bf16
// operands with float32 accumulation (mma_bf16.cuh; the tile loaders,
// fragment offsets and stores are flash_mma.cuh's, shared with the
// forward): the tensor cores' 989 TFLOP/s, where the CUDA cores' float32
// FMAs peak at 67.  The Pallas
// kernels upcast q, k, v and dO and run every dot in float32; here S =
// QK^T and dP = dO V^T take the bf16 operands as they are, whose products
// are exact in float32, so they differ from the Pallas arithmetic only in
// the order of the sums; dV = P^T dO, dK = dS^T Q and dQ = dS K take P and
// dS rounded once to bf16 (as FlashAttention-2 does), at most 2^-8 of
// each term.  ops/flash_attention.py::_mma_bwd is this arithmetic in plain
// torch.  S is scaled by scale * log2e in float32 after the product (Q is
// not pre-scaled, which would round it a second time); LSE and delta are
// float32; the accumulators are float32 to the end and each output is
// rounded to bf16 once (dK after its scale).
//   dK/dV: a block of 4 warps owns a 64-key tile, 16 keys a warp.  K and V
//   arrive once by cp.async into padded bf16 shared memory (rows of DT + 8
//   elements, so ldmatrix's eight row addresses fall in distinct banks);
//   the q tiles (q, dO, and LSE and delta of their rows) stream through two
//   cp.async stages, tile i+1's copy in flight while tile i is computed.
//   Per q tile each warp takes 32 queries at a time (to bound registers):
//   S^T = K Q^T and dP^T = V dO^T with A = its K (V) rows through ldmatrix
//   and B = the Q (dO) rows through ldmatrix; P^T and dS^T = P^T * (dP^T -
//   delta) in float32 under the mask; then P^T and dS^T, re-packed in
//   registers as A operands (the accumulator's layout is the A operand's),
//   go into dV += P^T dO and dK += dS^T Q with dO and Q through
//   ldmatrix.trans.  P and dS never touch shared memory.  Shared memory:
//   K and V 34,816 bytes and the two q stages 70,656 at DT 128 (two
//   blocks an SM, where the float32 kernel allows one).
//   dQ: a block of 4 warps owns a 64-row q tile, 16 rows a warp.  Its Q
//   and dO rows come from shared memory once, as A fragments kept in
//   registers; K and V tiles stream through two cp.async stages.  Per key
//   tile, 32 keys at a time: S = Q K^T and dP = dO V^T (K, V through
//   ldmatrix), dS = P * (dP - delta), and dQ += dS K with dS re-packed as
//   A and K through ldmatrix.trans.  Heavy q tiles (the causal bottom
//   rows) are scheduled first.
// Edges: rows past Lq, keys past the row's kv_len and head columns past D
// are zero-filled in shared memory, and every element outside the
// visibility rule is set to zero (a select, so junk past kv_len cannot
// reach a gradient); a row that is not 16-byte aligned (D or a stride not
// a multiple of 8) is copied 8 bytes at a time.  A tile pair whose every
// query sees every key (tile_full: the causal interior, unpadded rows)
// skips the visibility test, as the TPU kernels' unmasked interior loop
// does: the elementwise work between the products issues more
// instructions than the products themselves, and the test was a large
// part of it.  wgmma, TMA and warp specialisation are later work.

#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

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
// `mul`, into a contiguous [B, L, H, D] tensor of T at (b, h).
template <typename T>
__device__ __forceinline__ void store_patch(T* out, float acc[4][8], int r0,
                                           int nrows, int b, int h, int H,
                                           int D, int tx, int ty,
                                           float mul) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + ty + 16 * a;
    if (row >= nrows) continue;
    T* dst = out + (((long long)b * nrows + row) * H + h) * D;
    if (tx * 4 < D)
      store4(dst + tx * 4, acc[a][0] * mul, acc[a][1] * mul,
             acc[a][2] * mul, acc[a][3] * mul);
    if (64 + tx * 4 < D)
      store4(dst + 64 + tx * 4, acc[a][4] * mul, acc[a][5] * mul,
             acc[a][6] * mul, acc[a][7] * mul);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ kv_lens, T* __restrict__ dk,
                      T* __restrict__ dv, int Lq, int Lk, int H, int D,
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
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const T* gb = g + b * sgb + h * sgh;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_lens, T* __restrict__ dq,
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
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const T* gb = g + b * sgb + h * sgh;
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


// ------------------------------------------------- bf16, on tensor cores
// Shared memory at head tile DT: six padded 64-row bf16 tiles each (dK/dV:
// K, V and two stages of q and dO, with LSE and delta of two q tiles; dQ:
// q, dO and two stages of K and V).
template <int DT>
constexpr size_t kDkdvMmaSmem =
    sizeof(bf16) * 6 * kBq * kMs<DT> + sizeof(float) * 4 * kBq;
template <int DT>
constexpr size_t kDqMmaSmem = sizeof(bf16) * 6 * kBq * kMs<DT>;

// Copy floats r0..r0+63 of a row of LSE or delta, zero past `nrows`.
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               int r0, int nrows) {
  for (int r = threadIdx.x; r < kBq; r += kMmaThreads) {
    if (r0 + r < nrows) cp_async4(dst + r, src + r0 + r);
    else dst[r] = 0.f;
  }
}

// P^T and dS^T = P^T * (dP^T - delta) in place of the S^T and dP^T
// accumulators of one warp and 32 queries: element e of n-tile n is key
// key0 (+ 8 for e >= 2), query q0 + c0 + 8n + 2t + (e & 1).  MASKED zeroes
// what the query does not see.
template <bool MASKED>
__device__ __forceinline__ void p_and_ds_t(
    float (&s)[4][4], float (&dp)[4][4], const float* sLs, const float* sDs,
    int c0, int t, int q0, int key0, int Lq, int q_off, int row_len,
    int causal, int kv_off, float scale_log2) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = c0 + n * 8 + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(sLs + c);
    const float2 d2 = *reinterpret_cast<const float2*>(sDs + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[n][e] * scale_log2
                            - ((e & 1) ? l2.y : l2.x) * kLog2e);
      const float ds = p * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
      const int qr = q0 + c + (e & 1);
      const bool ok = !MASKED || (qr < Lq && visible((long long)q_off + qr,
                                                     key0 + (e >> 1) * 8,
                                                     row_len, causal,
                                                     kv_off));
      s[n][e] = ok ? p : 0.f;
      dp[n][e] = ok ? ds : 0.f;
    }
  }
}

// dS = P * (dP - delta) in place of the dP accumulator of one warp and 32
// keys: element e of n-tile n is row row0 (+ 8 for e >= 2), key
// kc + 8n + 2t + (e & 1); l2 and dl are the two rows' LSE (log2 domain)
// and delta.  MASKED zeroes what the row does not see.
template <bool MASKED>
__device__ __forceinline__ void ds_of(const float (&s)[4][4],
                                      float (&dp)[4][4], const float (&l2)[2],
                                      const float (&dl)[2], int row0, int kc,
                                      int t, int Lq, int q_off, int row_len,
                                      int causal, int kv_off,
                                      float scale_log2) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + (e >> 1) * 8;
      const float p = ex2(s[n][e] * scale_log2 - l2[e >> 1]);
      const bool ok = !MASKED || (r < Lq && visible((long long)q_off + r,
                                                    kc + n * 8 + 2 * t
                                                        + (e & 1),
                                                    row_len, causal,
                                                    kv_off));
      dp[n][e] = ok ? p * (dp[n][e] - dl[e >> 1]) : 0.f;
    }
}

template <int DT>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ kv_lens,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int Lq, int Lk, int H, int D, long long sqb,
                          long long sql, long long sqh, long long skb,
                          long long skl, long long skh, long long svb,
                          long long svl, long long svh, long long sgb,
                          long long sgl, long long sgh, int q_off,
                          int kv_off, int causal, float scale, int vec16) {
  constexpr int S = kMs<DT>;
  constexpr int KD = DT / 16;               // 16-deep steps over the head
  constexpr int ND = DT / 8;                // 8-wide n-tiles of dK, dV
  extern __shared__ uint4 smem_u4[];
  bf16* sK = reinterpret_cast<bf16*>(smem_u4);   // [kBk][S]
  bf16* sV = sK + kBk * S;                       // [kBk][S]
  bf16* sQ = sV + kBk * S;                       // [2][kBq][S]
  bf16* sG = sQ + 2 * kBq * S;                   // [2][kBq][S] dO rows
  float* sL = reinterpret_cast<float*>(sG + 2 * kBq * S);  // [2][kBq] lse
  float* sD = sL + 2 * kBq;                                // [2][kBq]

  const int kj = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int k0 = kj * kBk;
  const int key0 = k0 + warp * 16 + (lane >> 2);   // and key0 + 8
  const int row_len = min(kv_lens[b], Lk);
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  const bf16* gb = g + b * sgb + h * sgh;
  const float* lb = lse + ((long long)b * H + h) * Lq;
  const float* db = delta + ((long long)b * H + h) * Lq;
  const float scale_log2 = scale * kLog2e;
  const int nq = (Lq + kBq - 1) / kBq;
  const int i0 = first_q_tile(kj, nq, row_len, causal, q_off, kv_off);

  auto load_q_tile = [&](int i, int st) {
    const int q0 = i * kBq;
    load_tile_async<DT>(sQ + st * kBq * S, qb, sql, q0, Lq, D, vec16);
    load_tile_async<DT>(sG + st * kBq * S, gb, sgl, q0, Lq, D, vec16);
    load_vec_async(sL + st * kBq, lb, q0, Lq);
    load_vec_async(sD + st * kBq, db, q0, Lq);
  };
  if (i0 < nq) {                         // else the tile writes zeros
    load_tile_async<DT>(sK, kb, skl, k0, row_len, D, vec16);
    load_tile_async<DT>(sV, vb, svl, k0, row_len, D, vec16);
    load_q_tile(i0, 0);
  }
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const bf16* sKw = sK + warp * 16 * S + frag_a_offset<DT>(lane);
  const bf16* sVw = sV + warp * 16 * S + frag_a_offset<DT>(lane);
  for (int i = i0; i < nq; ++i) {
    const int st = (i - i0) & 1;
    if (i + 1 < nq) {
      load_q_tile(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                // tile i (and K, V) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = i * kBq;
    const bf16* sQs = sQ + st * kBq * S;
    const bf16* sGs = sG + st * kBq * S;
    const float* sLs = sL + st * kBq;
    const float* sDs = sD + st * kBq;
    const bool full = tile_full(q0, k0, Lq, row_len, causal, q_off, kv_off);
#pragma unroll 1
    for (int c0 = 0; c0 < kBq; c0 += 32) {
      // S^T and dP^T of the warp's 16 keys x queries c0..c0+31
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, sKw + kd * 16);
        ldmatrix_x4(va, sVw + kd * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int off = (c0 + np * 16) * S + frag_b_offset<DT>(lane)
                          + kd * 16;
          uint32_t qf[4], gf[4];
          ldmatrix_x4(qf, sQs + off);
          ldmatrix_x4(gf, sGs + off);
          mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
          mma_bf16(dp[2 * np], va, gf[0], gf[1]);
          mma_bf16(dp[2 * np + 1], va, gf[2], gf[3]);
        }
      }
      if (full)
        p_and_ds_t<false>(s, dp, sLs, sDs, c0, t, q0, key0, Lq, q_off,
                          row_len, causal, kv_off, scale_log2);
      else
        p_and_ds_t<true>(s, dp, sLs, sDs, c0, t, q0, key0, Lq, q_off,
                         row_len, causal, kv_off, scale_log2);
      // dV += P^T dO and dK += dS^T Q over these 32 queries
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], da[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
        const int off = (c0 + kk * 16) * S + frag_a_offset<DT>(lane);
#pragma unroll
        for (int nd = 0; nd < KD; ++nd) {
          uint32_t gf[4], qf[4];
          ldmatrix_x4_trans(gf, sGs + off + nd * 16);
          ldmatrix_x4_trans(qf, sQs + off + nd * 16);
          mma_bf16(acc_v[2 * nd], pa, gf[0], gf[1]);
          mma_bf16(acc_v[2 * nd + 1], pa, gf[2], gf[3]);
          mma_bf16(acc_k[2 * nd], da, qf[0], qf[1]);
          mma_bf16(acc_k[2 * nd + 1], da, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();                     // stage st consumed by every warp
  }
  cp_async_wait<0>();                    // no copy outlives the block

  store_rows<DT>(dk, acc_k, key0, Lk, b, h, H, D, t, scale);
  store_rows<DT>(dv, acc_v, key0, Lk, b, h, H, D, t, 1.f);
}

template <int DT>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ kv_lens,
                        bf16* __restrict__ dq, int Lq, int Lk, int H, int D,
                        long long sqb, long long sql, long long sqh,
                        long long skb, long long skl, long long skh,
                        long long svb, long long svl, long long svh,
                        long long sgb, long long sgl, long long sgh,
                        int q_off, int kv_off, int causal, float scale,
                        int vec16) {
  constexpr int S = kMs<DT>;
  constexpr int KD = DT / 16;
  constexpr int ND = DT / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);   // [kBq][S]
  bf16* sG = sQ + kBq * S;                       // [kBq][S] dO rows
  bf16* sK = sG + kBq * S;                       // [2][kBk][S]
  bf16* sV = sK + 2 * kBk * S;                   // [2][kBk][S]

  const int qi = gridDim.x - 1 - blockIdx.x;     // heavy tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int q0 = qi * kBq;
  const int row0 = q0 + warp * 16 + (lane >> 2);   // and row0 + 8
  const int row_len = min(kv_lens[b], Lk);
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  const bf16* gb = g + b * sgb + h * sgh;
  const float* lb = lse + ((long long)b * H + h) * Lq;
  const float* db = delta + ((long long)b * H + h) * Lq;
  const float scale_log2 = scale * kLog2e;
  const int nk_eff =
      kv_tiles(qi, (Lk + kBk - 1) / kBk, row_len, causal, q_off, kv_off);

  auto load_kv_tile = [&](int j, int st) {
    load_tile_async<DT>(sK + st * kBk * S, kb, skl, j * kBk, row_len, D,
                        vec16);
    load_tile_async<DT>(sV + st * kBk * S, vb, svl, j * kBk, row_len, D,
                        vec16);
  };
  load_tile_async<DT>(sQ, qb, sql, q0, Lq, D, vec16);
  load_tile_async<DT>(sG, gb, sgl, q0, Lq, D, vec16);
  cp_async_commit();
  if (nk_eff > 0) load_kv_tile(0, 0);
  cp_async_commit();
  // LSE (log2 domain) and delta of the thread's two rows
  float l2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + 8 * e;
    l2[e] = r < Lq ? lb[r] * kLog2e : 0.f;
    dl[e] = r < Lq ? db[r] : 0.f;
  }
  cp_async_wait<1>();                    // the q tile has landed
  __syncthreads();
  uint32_t qa[KD][4], ga[KD][4];
  const int a_off = warp * 16 * S + frag_a_offset<DT>(lane);
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    ldmatrix_x4(qa[kd], sQ + a_off + kd * 16);
    ldmatrix_x4(ga[kd], sG + a_off + kd * 16);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < nk_eff; ++j) {
    const int st = j & 1;
    if (j + 1 < nk_eff) {
      load_kv_tile(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                // tile j has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * kBk;
    const bf16* sKs = sK + st * kBk * S;
    const bf16* sVs = sV + st * kBk * S;
    const bool full = tile_full(q0, k0, Lq, row_len, causal, q_off, kv_off);
#pragma unroll 1
    for (int c0 = 0; c0 < kBk; c0 += 32) {
      // S and dP of the warp's 16 rows x keys c0..c0+31
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int off = (c0 + np * 16) * S + frag_b_offset<DT>(lane)
                          + kd * 16;
          uint32_t kf[4], vf[4];
          ldmatrix_x4(kf, sKs + off);
          ldmatrix_x4(vf, sVs + off);
          mma_bf16(s[2 * np], qa[kd], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa[kd], kf[2], kf[3]);
          mma_bf16(dp[2 * np], ga[kd], vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], ga[kd], vf[2], vf[3]);
        }
      if (full)
        ds_of<false>(s, dp, l2, dl, row0, k0 + c0, t, Lq, q_off, row_len,
                     causal, kv_off, scale_log2);
      else
        ds_of<true>(s, dp, l2, dl, row0, k0 + c0, t, Lq, q_off, row_len,
                    causal, kv_off, scale_log2);
      // dQ += dS K over these 32 keys
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t da[4];
        pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
        const int off = (c0 + kk * 16) * S + frag_a_offset<DT>(lane);
#pragma unroll
        for (int nd = 0; nd < KD; ++nd) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, sKs + off + nd * 16);
          mma_bf16(acc[2 * nd], da, kf[0], kf[1]);
          mma_bf16(acc[2 * nd + 1], da, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();                     // stage st consumed by every warp
  }
  cp_async_wait<0>();

  store_rows<DT>(dq, acc, row0, Lq, b, h, H, D, t, scale);
}

#define FLASH_BWD_STRIDES                                                 \
  long long sqb, long long sql, long long sqh, long long skb, long long skl, \
      long long skh, long long svb, long long svl, long long svh,           \
      long long sgb, long long sgl, long long sgh, int q_off, int kv_off,   \
      int causal, float scale, void *stream
#define FLASH_BWD_PASS                                                     \
  sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sgb, sgl, sgh, q_off, kv_off, \
      causal, scale

template <typename T>
int dkdv_launch(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, const void* kv_lens,
                void* dk, void* dv, int B, int Lq, int Lk, int H, int D,
                FLASH_BWD_STRIDES) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkdvSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + kBk - 1) / kBk, B * H);
  flash_bwd_dkdv_kernel<T><<<grid, kThreads, kDkdvSmemBytes,
                             (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
      (const float*)delta, (const int*)kv_lens, (T*)dk, (T*)dv, Lq, Lk, H, D,
      FLASH_BWD_PASS);
  return (int)cudaGetLastError();
}

template <typename T>
int dq_launch(const void* q, const void* k, const void* v, const void* g,
              const void* lse, const void* delta, const void* kv_lens,
              void* dq, int B, int Lq, int Lk, int H, int D,
              FLASH_BWD_STRIDES) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBq - 1) / kBq, B * H);
  flash_bwd_dq_kernel<T><<<grid, kThreads, kDqSmemBytes,
                           (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
      (const float*)delta, (const int*)kv_lens, (T*)dq, Lq, Lk, H, D,
      FLASH_BWD_PASS);
  return (int)cudaGetLastError();
}

template <int DT>
int dkdv_mma_launch(const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta,
                    const void* kv_lens, void* dk, void* dv, int B, int Lq,
                    int Lk, int H, int D, FLASH_BWD_STRIDES) {
  auto kernel = flash_bwd_dkdv_mma_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkdvMmaSmem<DT>);
  if (err != cudaSuccess) return (int)err;
  const long long st[12] = {sqb, sql, sqh, skb, skl, skh,
                            svb, svl, svh, sgb, sgl, sgh};
  const int vec16 = rows_16b(D, st);
  dim3 grid((Lk + kBk - 1) / kBk, B * H);
  kernel<<<grid, kMmaThreads, kDkdvMmaSmem<DT>, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)delta, (const int*)kv_lens, (bf16*)dk,
      (bf16*)dv, Lq, Lk, H, D, FLASH_BWD_PASS, vec16);
  return (int)cudaGetLastError();
}

template <int DT>
int dq_mma_launch(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, const void* kv_lens,
                  void* dq, int B, int Lq, int Lk, int H, int D,
                  FLASH_BWD_STRIDES) {
  auto kernel = flash_bwd_dq_mma_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqMmaSmem<DT>);
  if (err != cudaSuccess) return (int)err;
  const long long st[12] = {sqb, sql, sqh, skb, skl, skh,
                            svb, svl, svh, sgb, sgl, sgh};
  const int vec16 = rows_16b(D, st);
  dim3 grid((Lq + kBq - 1) / kBq, B * H);
  kernel<<<grid, kMmaThreads, kDqMmaSmem<DT>, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)delta, (const int*)kv_lens, (bf16*)dq,
      Lq, Lk, H, D, FLASH_BWD_PASS, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per instance and kernel: q, k, v, dO and the outputs
// float32 (_f32, the CUDA-core kernels) or bf16 (_bf16, the tensor-core
// kernels at the head tile D fits); LSE and delta float32 in both.
#define DKDV_ARGS                                                          \
  const void *q, const void *k, const void *v, const void *g,             \
      const void *lse, const void *delta, const void *kv_lens, void *dk,  \
      void *dv, int B, int Lq, int Lk, int H, int D, FLASH_BWD_STRIDES
#define DKDV_PASS                                                          \
  q, k, v, g, lse, delta, kv_lens, dk, dv, B, Lq, Lk, H, D, FLASH_BWD_PASS, \
      stream
#define DQ_ARGS                                                            \
  const void *q, const void *k, const void *v, const void *g,             \
      const void *lse, const void *delta, const void *kv_lens, void *dq,  \
      int B, int Lq, int Lk, int H, int D, FLASH_BWD_STRIDES
#define DQ_PASS                                                            \
  q, k, v, g, lse, delta, kv_lens, dq, B, Lq, Lk, H, D, FLASH_BWD_PASS, stream

extern "C" int flash_bwd_dkdv_f32(DKDV_ARGS) {
  return dkdv_launch<float>(DKDV_PASS);
}
extern "C" int flash_bwd_dkdv_bf16(DKDV_ARGS) {
  return D <= 64 ? dkdv_mma_launch<64>(DKDV_PASS)
                 : dkdv_mma_launch<128>(DKDV_PASS);
}
extern "C" int flash_bwd_dq_f32(DQ_ARGS) {
  return dq_launch<float>(DQ_PASS);
}
extern "C" int flash_bwd_dq_bf16(DQ_ARGS) {
  return D <= 64 ? dq_mma_launch<64>(DQ_PASS) : dq_mma_launch<128>(DQ_PASS);
}

// Registers and local memory (bytes a thread: stack and spills) of a bf16
// tensor-core kernel: `dkdv` 1 for dK/dV, 0 for dQ, at head tile `dt`
// (64 or 128).
extern "C" int flash_bwd_mma_resources(int dkdv, int dt, int* regs,
                                       int* local_bytes) {
  const void* fn =
      dkdv ? (dt == 64 ? (const void*)flash_bwd_dkdv_mma_kernel<64>
                       : (const void*)flash_bwd_dkdv_mma_kernel<128>)
           : (dt == 64 ? (const void*)flash_bwd_dq_mma_kernel<64>
                       : (const void*)flash_bwd_dq_mma_kernel<128>);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
