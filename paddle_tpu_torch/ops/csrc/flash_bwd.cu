// Flash attention backward for Hopper (sm_90a): dK/dV and dQ on the tensor
// cores, float32 operands as split TF32 (3xTF32), bf16 and float16 operands
// as they are.
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
// for each product (274.9 and 206.2 GFLOP), on O(T * D) bytes: far above
// the ridge of every peak.
//
// float32 (flash_bwd_{dkdv,dq}_tf32_kernel<DT>, DT 64 for D <= 64, else
// 128; they replace the CUDA-core kernels flash_bwd_{dkdv,dq}_kernel<float>,
// which ran every product as float32 FMAs at 67 TFLOP/s).  Every product is
// three mma.sync m16n8k8 TF32 products with float32 accumulation, lo.hi +
// hi.lo + hi.hi of each operand's split x = hi + lo (mma_tf32.cuh: hi =
// rna(x), lo = rna(x - hi), rounded as cvt.rna.tf32.f32 rounds), which
// keeps each product within 3 * 2^-22 of its magnitude where one TF32 product keeps
// 2^-10.  The bound is three products at TF32's 495 TFLOP/s, 165 TFLOP/s
// of float32 work: 1.666 ms for dK/dV and 1.250 for dQ at the LM shape,
// where float32 FMAs take 4.104 and 3.078.  P = exp2(s * scale * log2e -
// lse * log2e), dS = P * (dP - delta), LSE and delta stay float32; P and dS
// are split like any operand.  ops/flash_attention.py::_tf32x3_bwd is this
// arithmetic in plain torch.  The work split (dK/dV owns a 64-key tile,
// dQ a 64-row q tile, heavy q tiles first), the visibility rule and the
// skip of the test where every query sees every key, the element layout of
// S^T / S (p_and_ds_t, ds_of) and S scaled by scale * log2e after the
// product are the 16-bit kernels'; what differs:
//   - 8 warps in 4 pairs: a pair owns 16 rows, each warp half of the head;
//     S and dP are taken over the warp's half and added across the pair
//     through shared memory, both warps form the same P and dS, and each
//     accumulates its half of the head's output columns.  A thread holds
//     64 accumulator floats at DT 128 (the 16-bit kernels hold 128 in 4
//     warps), and each scheduler has two warps;
//   - fragments of 32-bit elements: ldmatrix moves them as pairs of
//     16-bit ones for the [row g][column t] reads (S, dP), one 32-bit load
//     an element for the [row 2t][column g] reads (dV, dK, dQ); rows of
//     DT + 4 floats (4 mod 32 words) keep both free of bank conflicts;
//   - the m16n8 accumulator holds columns 2t and 2t+1 where the TF32 A
//     fragment wants t and t+4, so the reduction over queries (keys in dQ)
//     is permuted inside each 8-deep step, B reading rows 2t and 2t+1: P^T
//     and dS^T (dS in dQ) are the next product's A fragments in registers,
//     with no shuffle and no shared memory;
//   - the streamed operand comes in 32-row sub-tiles through cp.async (the
//     next lands while one is computed) and is split once a sub-tile into
//     hi and lo planes, where four warp pairs would each split all of it;
//     the resident tile stays float32 (its planes and a landing buffer do
//     not fit beside it in 227 KB) and is split as it is read;
//   - the tensor cores round each product's sum toward zero, so each
//     sub-tile's contribution to dK, dV (dQ) is summed in a fragment of its
//     own and added to the accumulator in float32 (rows_product): kept in
//     one accumulator over 4096 queries, dK drifted by 5e-5 of its max.
// wgmma is not used: its TF32 operands must be K-major, and dV = P^T dO and
// dK = dS^T Q read dO and Q along their rows (MN-major), so it needs
// transposed copies; wgmma with TMA is later work.
//
// bf16 and float16 (flash_bwd_{dkdv,dq}_mma_kernel<E, DT>, E the element
// type, bf16 or f16, DT the head tile: 64 for D <= 64, else 128).  Every
// product is mma.sync m16n8k16 on E operands with float32 accumulation
// (mma_bf16.cuh's Elem16<E>; the tile loaders,
// fragment offsets and stores are flash_mma.cuh's, shared with the
// forward): the tensor cores' 989 TFLOP/s, where the CUDA cores' float32
// FMAs peak at 67.  The Pallas
// kernels upcast q, k, v and dO and run every dot in float32; here S =
// QK^T and dP = dO V^T take the E operands as they are, whose products
// are exact in float32, so they differ from the Pallas arithmetic only in
// the order of the sums; dV = P^T dO, dK = dS^T Q and dQ = dS K take P and
// dS rounded once to E (as FlashAttention-2 does), at most 2^-8 of each
// term at bf16, 2^-11 at f16.  ops/flash_attention.py::_mma_bwd is this
// arithmetic in plain torch.  S is scaled by scale * log2e in float32
// after the product (Q is not pre-scaled, which would round it a second
// time); LSE and delta are float32; the accumulators are float32 to the
// end and each output is rounded to E once (dK after its scale).
//   dK/dV: a block of 4 warps owns a 64-key tile, 16 keys a warp.  K and V
//   arrive once by cp.async into padded 16-bit shared memory (rows of DT + 8
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
#include "mma_tf32.cuh"

namespace {

using namespace flash;

// ------------------------------------------ bf16 and f16, tensor cores
// Shared memory at head tile DT: six padded 64-row 16-bit tiles each (dK/dV:
// K, V and two stages of q and dO, with LSE and delta of two q tiles; dQ:
// q, dO and two stages of K and V).
template <int DT>
constexpr size_t kDkdvMmaSmem =
    sizeof(uint16_t) * 6 * kBq * kMs<DT> + sizeof(float) * 4 * kBq;
template <int DT>
constexpr size_t kDqMmaSmem = sizeof(uint16_t) * 6 * kBq * kMs<DT>;

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

template <typename E, int DT>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const E* __restrict__ q,
                          const E* __restrict__ k,
                          const E* __restrict__ v,
                          const E* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ kv_lens,
                          E* __restrict__ dk, E* __restrict__ dv,
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
  E* sK = reinterpret_cast<E*>(smem_u4);         // [kBk][S]
  E* sV = sK + kBk * S;                          // [kBk][S]
  E* sQ = sV + kBk * S;                          // [2][kBq][S]
  E* sG = sQ + 2 * kBq * S;                      // [2][kBq][S] dO rows
  float* sL = reinterpret_cast<float*>(sG + 2 * kBq * S);  // [2][kBq] lse
  float* sD = sL + 2 * kBq;                                // [2][kBq]

  const int kj = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int k0 = kj * kBk;
  const int key0 = k0 + warp * 16 + (lane >> 2);   // and key0 + 8
  const int row_len = min(kv_lens[b], Lk);
  const E* qb = q + b * sqb + h * sqh;
  const E* kb = k + b * skb + h * skh;
  const E* vb = v + b * svb + h * svh;
  const E* gb = g + b * sgb + h * sgh;
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

  const E* sKw = sK + warp * 16 * S + frag_a_offset<DT>(lane);
  const E* sVw = sV + warp * 16 * S + frag_a_offset<DT>(lane);
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
    const E* sQs = sQ + st * kBq * S;
    const E* sGs = sG + st * kBq * S;
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
          Elem16<E>::mma(s[2 * np], ka, qf[0], qf[1]);
          Elem16<E>::mma(s[2 * np + 1], ka, qf[2], qf[3]);
          Elem16<E>::mma(dp[2 * np], va, gf[0], gf[1]);
          Elem16<E>::mma(dp[2 * np + 1], va, gf[2], gf[3]);
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
        pack_a<E>(pa, s[2 * kk], s[2 * kk + 1]);
        pack_a<E>(da, dp[2 * kk], dp[2 * kk + 1]);
        const int off = (c0 + kk * 16) * S + frag_a_offset<DT>(lane);
#pragma unroll
        for (int nd = 0; nd < KD; ++nd) {
          uint32_t gf[4], qf[4];
          ldmatrix_x4_trans(gf, sGs + off + nd * 16);
          ldmatrix_x4_trans(qf, sQs + off + nd * 16);
          Elem16<E>::mma(acc_v[2 * nd], pa, gf[0], gf[1]);
          Elem16<E>::mma(acc_v[2 * nd + 1], pa, gf[2], gf[3]);
          Elem16<E>::mma(acc_k[2 * nd], da, qf[0], qf[1]);
          Elem16<E>::mma(acc_k[2 * nd + 1], da, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();                     // stage st consumed by every warp
  }
  cp_async_wait<0>();                    // no copy outlives the block

  store_rows<DT>(dk, acc_k, key0, Lk, b, h, H, D, t, scale);
  store_rows<DT>(dv, acc_v, key0, Lk, b, h, H, D, t, 1.f);
}

template <typename E, int DT>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const E* __restrict__ q,
                        const E* __restrict__ k,
                        const E* __restrict__ v,
                        const E* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ kv_lens,
                        E* __restrict__ dq, int Lq, int Lk, int H, int D,
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
  E* sQ = reinterpret_cast<E*>(smem_u4);         // [kBq][S]
  E* sG = sQ + kBq * S;                          // [kBq][S] dO rows
  E* sK = sG + kBq * S;                          // [2][kBk][S]
  E* sV = sK + 2 * kBk * S;                      // [2][kBk][S]

  const int qi = gridDim.x - 1 - blockIdx.x;     // heavy tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int q0 = qi * kBq;
  const int row0 = q0 + warp * 16 + (lane >> 2);   // and row0 + 8
  const int row_len = min(kv_lens[b], Lk);
  const E* qb = q + b * sqb + h * sqh;
  const E* kb = k + b * skb + h * skh;
  const E* vb = v + b * svb + h * svh;
  const E* gb = g + b * sgb + h * sgh;
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
    const E* sKs = sK + st * kBk * S;
    const E* sVs = sV + st * kBk * S;
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
          Elem16<E>::mma(s[2 * np], qa[kd], kf[0], kf[1]);
          Elem16<E>::mma(s[2 * np + 1], qa[kd], kf[2], kf[3]);
          Elem16<E>::mma(dp[2 * np], ga[kd], vf[0], vf[1]);
          Elem16<E>::mma(dp[2 * np + 1], ga[kd], vf[2], vf[3]);
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
        pack_a<E>(da, dp[2 * kk], dp[2 * kk + 1]);
        const int off = (c0 + kk * 16) * S + frag_a_offset<DT>(lane);
#pragma unroll
        for (int nd = 0; nd < KD; ++nd) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, sKs + off + nd * 16);
          Elem16<E>::mma(acc[2 * nd], da, kf[0], kf[1]);
          Elem16<E>::mma(acc[2 * nd + 1], da, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();                     // stage st consumed by every warp
  }
  cp_async_wait<0>();

  store_rows<DT>(dq, acc, row0, Lq, b, h, H, D, t, scale);
}

// ---------------------------------------- float32, tensor cores (3xTF32)
// Shared memory at head tile DT: the resident 64-row pair, the landing
// 32-row pair, its four TF32 planes, the pairs' partial sums (8 warps x
// 4 KB) and, in dK/dV, two stages of LSE and delta: 202,240 and 201,728
// bytes at DT 128, one block an SM.
template <int DT>
constexpr size_t kDkdvTf32Smem =
    sizeof(float) * (2 * kBk * tf32::kTs<DT> + 6 * tf32::kSub * tf32::kTs<DT>
                     + 4 * tf32::kSub + tf32::kThreads / 32 * 1024);
template <int DT>
constexpr size_t kDqTf32Smem =
    sizeof(float) * (2 * kBq * tf32::kTs<DT> + 6 * tf32::kSub * tf32::kTs<DT>
                     + tf32::kThreads / 32 * 1024);
static_assert(tf32::kThreads == 8 * 32 && kBq == 4 * 16 && kBk == 4 * 16,
              "four pairs of warps, 16 rows a pair");
static_assert(tf32::kSub == 32, "a sub-tile is the 32 queries (keys) of "
              "one S^T (S) chunk");

template <int DT>
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_bwd_dkdv_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ g,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ kv_lens,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int Lq, int Lk, int H, int D, long long sqb,
                           long long sql, long long sqh, long long skb,
                           long long skl, long long skh, long long svb,
                           long long svl, long long svh, long long sgb,
                           long long sgl, long long sgh, int q_off,
                           int kv_off, int causal, float scale) {
  constexpr int S = tf32::kTs<DT>;
  constexpr int R = tf32::kSub;
  constexpr int KH = DT / 16;      // 8-deep steps over half of the head;
                                   // the 8-wide n-tiles of a warp's dK, dV
  extern __shared__ float4 smem_f4[];
  float* sK = reinterpret_cast<float*>(smem_f4);   // [kBk][S]
  float* sV = sK + kBk * S;                        // [kBk][S]
  float* sQr = sV + kBk * S;                       // [R][S] q rows landing
  float* sGr = sQr + R * S;                        // [R][S] dO rows landing
  float* sQh = sGr + R * S;                        // [R][S] q, TF32 hi
  float* sQl = sQh + R * S;                        //        and lo
  float* sGh = sQl + R * S;                        // [R][S] dO, hi
  float* sGl = sGh + R * S;                        //        and lo
  float* sL = sGl + R * S;                         // [2][R] lse
  float* sD = sL + 2 * R;                          // [2][R] delta
  float* sX = sD + 2 * R;                          // [8 warps][32][32]

  const int kj = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp & 3, c_own = (warp >> 2) * (DT / 2);
  const int gr = lane >> 2, t = lane & 3;
  const int k0 = kj * kBk;
  const int key0 = k0 + pair * 16 + gr;           // and key0 + 8
  const int row_len = min(kv_lens[b], Lk);
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const float* gb = g + b * sgb + h * sgh;
  const float* lb = lse + ((long long)b * H + h) * Lq;
  const float* db = delta + ((long long)b * H + h) * Lq;
  const float scale_log2 = scale * kLog2e;
  // sub-tiles [j0, nj) of R queries: from the first q tile that sees the
  // key tile, less its first half when no query of that half does
  const int nj = (Lq + R - 1) / R;
  const int nq = (Lq + kBq - 1) / kBq;
  int j0 = first_q_tile(kj, nq, row_len, causal, q_off, kv_off) * (kBq / R);
  if (j0 < nj && causal &&
      (long long)kv_off + k0 > (long long)q_off + j0 * R + R - 1)
    ++j0;

  auto load_sub = [&](int j) {
    const int r0 = j * R, st = (j - j0) & 1;
    tf32::load_rows<DT, R>(sQr, qb, sql, r0, Lq, D);
    tf32::load_rows<DT, R>(sGr, gb, sgl, r0, Lq, D);
    tf32::load_vec(sL + st * R, lb, r0, Lq, R);
    tf32::load_vec(sD + st * R, db, r0, Lq, R);
  };
  if (j0 < nj) {                         // else the tile writes zeros
    tf32::load_rows<DT, kBk>(sK, kb, skl, k0, row_len, D);
    tf32::load_rows<DT, kBk>(sV, vb, svl, k0, row_len, D);
    load_sub(j0);
  }
  cp_async_commit();

  float acc_k[KH][4], acc_v[KH][4];
#pragma unroll
  for (int n = 0; n < KH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // fragment corners: the A fragments of the pair's keys in the warp's
  // half of the head (ldmatrix), the B fragments of the sub-tile's queries
  // (ldmatrix on the planes), and the [2t][g] reads of the planes' rows
  const int a_off = pair * 16 * S + c_own + tf32::a_lane<S>(lane);
  const int b_off = c_own + tf32::b_lane<S>(lane);
  const int r_off = 2 * t * S + c_own + gr;
  float* x_mine = sX + warp * 1024 + lane * 4;
  const float* x_theirs = sX + (warp ^ 4) * 1024 + lane * 4;
  for (int j = j0; j < nj; ++j) {
    const int st = (j - j0) & 1;
    cp_async_wait<0>();
    __syncthreads();                     // j landed; planes of j-1 read
    tf32::split_rows<DT, R>(sQh, sQl, sQr);
    tf32::split_rows<DT, R>(sGh, sGl, sGr);
    __syncthreads();                     // planes of j ready
    if (j + 1 < nj) load_sub(j + 1);
    cp_async_commit();
    const int q0 = j * R;
    const bool full = tf32::span_full(q0, R, k0, kBk, Lq, row_len, causal,
                                      q_off, kv_off);
    // S^T = K Q^T and dP^T = V dO^T of the pair's 16 keys x these 32
    // queries (n-tile n: queries q0 + 8n ..), over the warp's half of the
    // head, then over the whole head from the pair's two halves
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KH; ++kd) {
      tf32::SplitA ak, av;
      tf32::load_a(ak, sK + a_off + kd * 8);
      tf32::load_a(av, sV + a_off + kd * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int o = b_off + np * 16 * S + kd * 8;
        tf32::SplitB bq[2], bg[2];
        tf32::load_b2(bq, sQh + o, sQl + o);
        tf32::load_b2(bg, sGh + o, sGl + o);
        tf32::mma3(s[2 * np], ak, bq[0]);
        tf32::mma3(s[2 * np + 1], ak, bq[1]);
        tf32::mma3(dp[2 * np], av, bg[0]);
        tf32::mma3(dp[2 * np + 1], av, bg[1]);
      }
    }
    tf32::pair_sum(s, dp, x_mine, x_theirs, pair);
    if (full)
      p_and_ds_t<false>(s, dp, sL + st * R, sD + st * R, 0, t, q0, key0, Lq,
                        q_off, row_len, causal, kv_off, scale_log2);
    else
      p_and_ds_t<true>(s, dp, sL + st * R, sD + st * R, 0, t, q0, key0, Lq,
                       q_off, row_len, causal, kv_off, scale_log2);
    // dV += P^T dO and dK += dS^T Q over these 32 queries, the warp's
    // columns: P^T and dS^T are the A fragments as they stand, dO and Q
    // the B fragments of rows 2t and 2t+1 of each 8-query step
    tf32::rows_product<S, KH>(acc_v, s, sGh + r_off, sGl + r_off);
    tf32::rows_product<S, KH>(acc_k, dp, sQh + r_off, sQl + r_off);
  }
  cp_async_wait<0>();                    // no copy outlives the block

  tf32::store_rows<KH>(dk, acc_k, key0, Lk, b, h, H, D, c_own, t, scale);
  tf32::store_rows<KH>(dv, acc_v, key0, Lk, b, h, H, D, c_own, t, 1.f);
}

template <int DT>
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_lens,
                         float* __restrict__ dq, int Lq, int Lk, int H,
                         int D, long long sqb, long long sql, long long sqh,
                         long long skb, long long skl, long long skh,
                         long long svb, long long svl, long long svh,
                         long long sgb, long long sgl, long long sgh,
                         int q_off, int kv_off, int causal, float scale) {
  constexpr int S = tf32::kTs<DT>;
  constexpr int R = tf32::kSub;
  constexpr int KH = DT / 16;
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);   // [kBq][S]
  float* sG = sQ + kBq * S;                        // [kBq][S] dO rows
  float* sKr = sG + kBq * S;                       // [R][S] K rows landing
  float* sVr = sKr + R * S;                        // [R][S] V rows landing
  float* sKh = sVr + R * S;                        // [R][S] K, TF32 hi
  float* sKl = sKh + R * S;                        //        and lo
  float* sVh = sKl + R * S;                        // [R][S] V, hi
  float* sVl = sVh + R * S;                        //        and lo
  float* sX = sVl + R * S;                         // [8 warps][32][32]

  const int qi = gridDim.x - 1 - blockIdx.x;     // heavy tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp & 3, c_own = (warp >> 2) * (DT / 2);
  const int gr = lane >> 2, t = lane & 3;
  const int q0 = qi * kBq;
  const int row0 = q0 + pair * 16 + gr;           // and row0 + 8
  const int row_len = min(kv_lens[b], Lk);
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const float* gb = g + b * sgb + h * sgh;
  const float* lb = lse + ((long long)b * H + h) * Lq;
  const float* db = delta + ((long long)b * H + h) * Lq;
  const float scale_log2 = scale * kLog2e;
  // sub-tiles [0, nj) of R keys: those of the key tiles the q tile sees,
  // less the last one when no row of the tile sees it
  int nj = kv_tiles(qi, (Lk + kBk - 1) / kBk, row_len, causal, q_off,
                    kv_off) * (kBk / R);
  if (nj > 0 && ((nj - 1) * R >= row_len ||
                 (causal && (long long)kv_off + (nj - 1) * R >
                                (long long)q_off + q0 + kBq - 1)))
    --nj;

  auto load_sub = [&](int j) {
    tf32::load_rows<DT, R>(sKr, kb, skl, j * R, row_len, D);
    tf32::load_rows<DT, R>(sVr, vb, svl, j * R, row_len, D);
  };
  tf32::load_rows<DT, kBq>(sQ, qb, sql, q0, Lq, D);
  tf32::load_rows<DT, kBq>(sG, gb, sgl, q0, Lq, D);
  if (nj > 0) load_sub(0);
  cp_async_commit();
  // LSE (log2 domain) and delta of the thread's two rows
  float l2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + 8 * e;
    l2[e] = r < Lq ? lb[r] * kLog2e : 0.f;
    dl[e] = r < Lq ? db[r] : 0.f;
  }

  float acc[KH][4];
#pragma unroll
  for (int n = 0; n < KH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // fragment corners: the A fragments of the pair's rows in the warp's
  // half of the head (ldmatrix), the B fragments of the sub-tile's keys
  // (ldmatrix on the planes), and the [2t][g] reads of the K planes' rows
  const int a_off = pair * 16 * S + c_own + tf32::a_lane<S>(lane);
  const int b_off = c_own + tf32::b_lane<S>(lane);
  const int r_off = 2 * t * S + c_own + gr;
  float* x_mine = sX + warp * 1024 + lane * 4;
  const float* x_theirs = sX + (warp ^ 4) * 1024 + lane * 4;
  for (int j = 0; j < nj; ++j) {
    cp_async_wait<0>();
    __syncthreads();                     // j landed; planes of j-1 read
    tf32::split_rows<DT, R>(sKh, sKl, sKr);
    tf32::split_rows<DT, R>(sVh, sVl, sVr);
    __syncthreads();                     // planes of j ready
    if (j + 1 < nj) load_sub(j + 1);
    cp_async_commit();
    const int k0 = j * R;
    const bool full = tf32::span_full(q0, kBq, k0, R, Lq, row_len, causal,
                                      q_off, kv_off);
    // S = Q K^T and dP = dO V^T of the pair's 16 rows x these 32 keys
    // (n-tile n: keys k0 + 8n ..), over the warp's half of the head, then
    // over the whole head from the pair's two halves
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KH; ++kd) {
      tf32::SplitA aq, ag;
      tf32::load_a(aq, sQ + a_off + kd * 8);
      tf32::load_a(ag, sG + a_off + kd * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int o = b_off + np * 16 * S + kd * 8;
        tf32::SplitB bk[2], bv[2];
        tf32::load_b2(bk, sKh + o, sKl + o);
        tf32::load_b2(bv, sVh + o, sVl + o);
        tf32::mma3(s[2 * np], aq, bk[0]);
        tf32::mma3(s[2 * np + 1], aq, bk[1]);
        tf32::mma3(dp[2 * np], ag, bv[0]);
        tf32::mma3(dp[2 * np + 1], ag, bv[1]);
      }
    }
    tf32::pair_sum(s, dp, x_mine, x_theirs, pair);
    if (full)
      ds_of<false>(s, dp, l2, dl, row0, k0, t, Lq, q_off, row_len, causal,
                   kv_off, scale_log2);
    else
      ds_of<true>(s, dp, l2, dl, row0, k0, t, Lq, q_off, row_len, causal,
                  kv_off, scale_log2);
    // dQ += dS K over these 32 keys, the warp's columns: dS is the A
    // fragment as it stands, K the B fragments of rows 2t and 2t+1 of each
    // 8-key step
    tf32::rows_product<S, KH>(acc, dp, sKh + r_off, sKl + r_off);
  }
  cp_async_wait<0>();

  tf32::store_rows<KH>(dq, acc, row0, Lq, b, h, H, D, c_own, t, scale);
}

#define FLASH_BWD_STRIDES                                                 \
  long long sqb, long long sql, long long sqh, long long skb, long long skl, \
      long long skh, long long svb, long long svl, long long svh,           \
      long long sgb, long long sgl, long long sgh, int q_off, int kv_off,   \
      int causal, float scale, void *stream
#define FLASH_BWD_PASS                                                     \
  sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sgb, sgl, sgh, q_off, kv_off, \
      causal, scale

template <typename E, int DT>
int dkdv_mma_launch(const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta,
                    const void* kv_lens, void* dk, void* dv, int B, int Lq,
                    int Lk, int H, int D, FLASH_BWD_STRIDES) {
  auto kernel = flash_bwd_dkdv_mma_kernel<E, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkdvMmaSmem<DT>);
  if (err != cudaSuccess) return (int)err;
  const long long st[12] = {sqb, sql, sqh, skb, skl, skh,
                            svb, svl, svh, sgb, sgl, sgh};
  const int vec16 = rows_16b(D, st);
  dim3 grid((Lk + kBk - 1) / kBk, B * H);
  kernel<<<grid, kMmaThreads, kDkdvMmaSmem<DT>, (cudaStream_t)stream>>>(
      (const E*)q, (const E*)k, (const E*)v, (const E*)g,
      (const float*)lse, (const float*)delta, (const int*)kv_lens, (E*)dk,
      (E*)dv, Lq, Lk, H, D, FLASH_BWD_PASS, vec16);
  return (int)cudaGetLastError();
}

template <typename E, int DT>
int dq_mma_launch(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, const void* kv_lens,
                  void* dq, int B, int Lq, int Lk, int H, int D,
                  FLASH_BWD_STRIDES) {
  auto kernel = flash_bwd_dq_mma_kernel<E, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqMmaSmem<DT>);
  if (err != cudaSuccess) return (int)err;
  const long long st[12] = {sqb, sql, sqh, skb, skl, skh,
                            svb, svl, svh, sgb, sgl, sgh};
  const int vec16 = rows_16b(D, st);
  dim3 grid((Lq + kBq - 1) / kBq, B * H);
  kernel<<<grid, kMmaThreads, kDqMmaSmem<DT>, (cudaStream_t)stream>>>(
      (const E*)q, (const E*)k, (const E*)v, (const E*)g,
      (const float*)lse, (const float*)delta, (const int*)kv_lens, (E*)dq,
      Lq, Lk, H, D, FLASH_BWD_PASS, vec16);
  return (int)cudaGetLastError();
}

template <int DT>
int dkdv_tf32_launch(const void* q, const void* k, const void* v,
                     const void* g, const void* lse, const void* delta,
                     const void* kv_lens, void* dk, void* dv, int B, int Lq,
                     int Lk, int H, int D, FLASH_BWD_STRIDES) {
  auto kernel = flash_bwd_dkdv_tf32_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkdvTf32Smem<DT>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + kBk - 1) / kBk, B * H);
  kernel<<<grid, tf32::kThreads, kDkdvTf32Smem<DT>, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)lse, (const float*)delta, (const int*)kv_lens,
      (float*)dk, (float*)dv, Lq, Lk, H, D, FLASH_BWD_PASS);
  return (int)cudaGetLastError();
}

template <int DT>
int dq_tf32_launch(const void* q, const void* k, const void* v,
                   const void* g, const void* lse, const void* delta,
                   const void* kv_lens, void* dq, int B, int Lq, int Lk,
                   int H, int D, FLASH_BWD_STRIDES) {
  auto kernel = flash_bwd_dq_tf32_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqTf32Smem<DT>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBq - 1) / kBq, B * H);
  kernel<<<grid, tf32::kThreads, kDqTf32Smem<DT>, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)lse, (const float*)delta, (const int*)kv_lens,
      (float*)dq, Lq, Lk, H, D, FLASH_BWD_PASS);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per instance and kernel: q, k, v, dO and the outputs
// float32 (_f32, the 3xTF32 kernels), bf16 (_bf16) or float16 (_f16), each
// at the head tile D fits; LSE and delta float32 in all.
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
  return D <= 64 ? dkdv_tf32_launch<64>(DKDV_PASS)
                 : dkdv_tf32_launch<128>(DKDV_PASS);
}
extern "C" int flash_bwd_dkdv_bf16(DKDV_ARGS) {
  return D <= 64 ? dkdv_mma_launch<bf16, 64>(DKDV_PASS)
                 : dkdv_mma_launch<bf16, 128>(DKDV_PASS);
}
extern "C" int flash_bwd_dkdv_f16(DKDV_ARGS) {
  return D <= 64 ? dkdv_mma_launch<f16, 64>(DKDV_PASS)
                 : dkdv_mma_launch<f16, 128>(DKDV_PASS);
}
extern "C" int flash_bwd_dq_f32(DQ_ARGS) {
  return D <= 64 ? dq_tf32_launch<64>(DQ_PASS)
                 : dq_tf32_launch<128>(DQ_PASS);
}
extern "C" int flash_bwd_dq_bf16(DQ_ARGS) {
  return D <= 64 ? dq_mma_launch<bf16, 64>(DQ_PASS)
                 : dq_mma_launch<bf16, 128>(DQ_PASS);
}
extern "C" int flash_bwd_dq_f16(DQ_ARGS) {
  return D <= 64 ? dq_mma_launch<f16, 64>(DQ_PASS)
                 : dq_mma_launch<f16, 128>(DQ_PASS);
}

namespace {
template <typename E>
const void* bwd_mma_fn(int dkdv, int dt) {
  return dkdv ? (dt == 64 ? (const void*)flash_bwd_dkdv_mma_kernel<E, 64>
                          : (const void*)flash_bwd_dkdv_mma_kernel<E, 128>)
              : (dt == 64 ? (const void*)flash_bwd_dq_mma_kernel<E, 64>
                          : (const void*)flash_bwd_dq_mma_kernel<E, 128>);
}
}  // namespace

// Registers and local memory (bytes a thread: stack and spills) of a
// tensor-core kernel: `dkdv` 1 for dK/dV, 0 for dQ, at head tile `dt`
// (64 or 128), on bf16 operands or, with `is_f16`, float16 ones.
extern "C" int flash_bwd_mma_resources(int dkdv, int dt, int is_f16,
                                       int* regs, int* local_bytes) {
  const void* fn = is_f16 ? bwd_mma_fn<f16>(dkdv, dt)
                          : bwd_mma_fn<bf16>(dkdv, dt);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Registers and local memory (bytes a thread: stack and spills) of a
// float32 (3xTF32) kernel: `dkdv` 1 for dK/dV, 0 for dQ, at head tile `dt`
// (64 or 128).
extern "C" int flash_bwd_f32_resources(int dkdv, int dt, int* regs,
                                       int* local_bytes) {
  const void* fn =
      dkdv ? (dt == 64 ? (const void*)flash_bwd_dkdv_tf32_kernel<64>
                       : (const void*)flash_bwd_dkdv_tf32_kernel<128>)
           : (dt == 64 ? (const void*)flash_bwd_dq_tf32_kernel<64>
                       : (const void*)flash_bwd_dq_tf32_kernel<128>);
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
