// The forward ablation sweep's tensor-core variants, bf16, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of tools/flash_variants.py::run_fwd:
// _fwd_kernel_v2 with bf16_dots=True (rows B, C, D and F of the sweep, and
// the fourth flag combination, split without exp2) and _fwd_kernel_pipe
// (rows G).  Same function: q, k, v [B, L, H, D] bf16;
//   S = (q . k^T) in float32 from bf16 operands, times scale * log2(e)
//       (EXP2) or scale (exp domain);
//   an online softmax over KV tiles of BK keys (exp2f or expf);
//   P rounded to bf16 for the P . V product, accumulated in float32;
//   O = acc / max(l, 1e-30) written in bf16, and the natural-log LSE
//   m / log2(e) + log(l_safe) (or m + log(l_safe)) in float32, [B*H, L];
// under the causal bound of _causal_nk_eff (the q tile's last row) and the
// row_len bound (run_fwd passes kv_lens = Lk and offsets 0, so the rule is
// k < Lk and, causal, k <= q).  L % BQ == 0 and Lk % BK == 0, the TPU
// tool's own contract (the wrapper checks).
//
// What bounds it on the H100: operations.  At the sweep's shape (B 8, H 8,
// L 4096, D 64, causal) the function does 137 GFLOP on ~135 MB: ~1000 flop
// a byte, far above the bf16 ridge (989 TFLOP/s over 3.35 TB/s = 295).
//
// Design for this card (the TPU's 512 to 2048-row blocks do not fit: a
// 2048 x 64 bf16 K block alone is 256 KB, past a block's 227 KB of shared
// memory).  A block of BQ / 16 warps owns BQ q rows (BQ 64 or 128, chosen
// at launch); each warp owns 16 of them, end to end:
//   - the q tile arrives by cp.async and each warp loads its Q fragments
//     once with ldmatrix, kept in registers for the whole sweep;
//   - K and V tiles of BK rows arrive by cp.async (16-byte copies, rows
//     padded by 16 bytes so ldmatrix's eight row addresses fall in distinct
//     banks);
//   - both products are mma.sync.aligned.m16n8k16 bf16 -> f32: S from Q
//     fragments and K through ldmatrix, P . V with V through ldmatrix.trans;
//   - a row's max and sum are reduced over the four threads of a quad with
//     shuffles (the sum stays a per-thread partial until the end, since
//     the rescale factor is the same across the quad);
//   - P is re-packed in registers, the score accumulator's layout being the
//     A operand's, and never touches shared memory.
// Without PIPE each tile's V copy overlaps its score product.  With PIPE
// (row G: exp2 and split included, as _fwd_kernel_pipe has them) K and V
// are double-buffered and tile j+1's score mma is issued into a second
// accumulator before tile j's softmax, so the tensor cores work while the
// softmax runs; tile j+2's K and j+1's V copy meanwhile.  Past the last
// tile no score is computed (the TPU kernel redoes the last one).
// SPLIT runs the tiles that every row of the q tile sees whole without the
// visibility test, as the TPU kernel's unmasked interior loop does.  Heavy
// q tiles (the causal bottom rows) are scheduled first.
//
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"

namespace {

using flash::kLog2e;
using flash::kNegInf;

constexpr int kMaxThreads = 256;            // BQ 128: 8 warps

using namespace mma;

template <bool EXP2>
__device__ __forceinline__ float exp_fn(float x) {
  return EXP2 ? exp2f(x) : expf(x);
}

template <int D>
constexpr int kRowStride = D + 8;          // bf16 elements, 16 bytes of pad

// Shared memory of one block: the q tile, then NBUF K and NBUF V tiles.
template <int D, int BK, bool PIPE>
constexpr size_t smem_bytes(int bq) {
  return sizeof(bf16) * kRowStride<D> * (bq + (PIPE ? 4 : 2) * BK);
}

// Copy `rows` rows of D bf16 (row stride `ld` elements) from row r0 into
// shared memory with cp.async, 16 bytes a copy.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int r0, int rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = idx % kChunks;
    cp_async16(dst + r * kRowStride<D> + c * 8,
               src + (long long)(r0 + r) * ld + c * 8);
  }
}

// S = Q . K^T for one K tile of BK keys: ldmatrix.x4 gives the B fragments
// of two n-tiles (keys n0..n0+7 and n0+8..n0+15) for one 16-deep step.
template <int D, int BK>
__device__ __forceinline__ void score(float (&s)[BK / 8][4],
                                      const uint32_t (&qf)[D / 16][4],
                                      const bf16* sKb, int lane) {
  constexpr int S = kRowStride<D>;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, sKb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * S
                           + kd * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], qf[kd], bfr[0], bfr[1]);
      mma_bf16(s[2 * np + 1], qf[kd], bfr[2], bfr[3]);
    }
}

// Whether row `row` sees key `kp` (kv_lens = Lk, offsets 0; the rule of
// flash_common.cuh's visible in 32-bit integers).
__device__ __forceinline__ bool visible(int kp, int row, int row_len,
                                        int causal) {
  return kp < row_len && (!causal || kp <= row);
}

// The online softmax of one tile (keys k0..k0+BK-1) and O += P . V.
// Element e of n-tile n is row (e < 2 ? row0 : row0 + 8), key
// k0 + 8n + 2t + (e & 1); m, l of the two rows are this thread's (l a
// partial over its columns).
template <int D, int BK, bool EXP2, bool MASKED>
__device__ __forceinline__ void softmax_pv(
    float (&s)[BK / 8][4], float (&o_acc)[D / 8][4], float& m0, float& m1,
    float& l0, float& l1, const bf16* sVb, int k0, int row0, int row_len,
    int causal, float scale_s, int lane) {
  constexpr int S = kRowStride<D>;
  constexpr int NKT = BK / 8, NDT = D / 8;
  const int t = lane & 3;
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int n = 0; n < NKT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * scale_s;
      if (MASKED && !visible(k0 + n * 8 + 2 * t + (e & 1),
                             e < 2 ? row0 : row0 + 8, row_len, causal))
        x = kNegInf;
      s[n][e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float corr0 = exp_fn<EXP2>(m0 - mx0);
  const float corr1 = exp_fn<EXP2>(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < NKT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp_fn<EXP2>(s[n][e] - (e < 2 ? m0 : m1));
      // zero under the mask, as _fwd_kernel_v2 does; _fwd_kernel_pipe does
      // not, which differs only on a row that sees no key yet - run_fwd's
      // inputs (kv_lens = Lk, offsets 0) have none
      if (MASKED && !visible(k0 + n * 8 + 2 * t + (e & 1),
                             e < 2 ? row0 : row0 + 8, row_len, causal))
        p = 0.f;
      s[n][e] = p;
      if (e < 2) rs0 += p;
      else rs1 += p;
    }
  l0 = l0 * corr0 + rs0;
  l1 = l1 * corr1 + rs1;
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
    o_acc[n][0] *= corr0;
    o_acc[n][1] *= corr0;
    o_acc[n][2] *= corr1;
    o_acc[n][3] *= corr1;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // P's 16 x 16 block of keys 16kk.. as the A fragment, in registers
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NDT / 2; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sVb + (kk * 16 + (lane & 7)
                                   + ((lane >> 3) & 1) * 8) * S
                                + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o_acc[2 * dp], a, vf[0], vf[1]);
      mma_bf16(o_acc[2 * dp + 1], a, vf[2], vf[3]);
    }
  }
}

// One tile: the visibility test only on a boundary tile (`masked`).
template <int D, int BK, bool EXP2>
__device__ __forceinline__ void softmax_pv_tile(
    bool masked, float (&s)[BK / 8][4], float (&o_acc)[D / 8][4], float& m0,
    float& m1, float& l0, float& l1, const bf16* sVb, int k0, int row0,
    int row_len, int causal, float scale_s, int lane) {
  if (masked)
    softmax_pv<D, BK, EXP2, true>(s, o_acc, m0, m1, l0, l1, sVb, k0, row0,
                                  row_len, causal, scale_s, lane);
  else
    softmax_pv<D, BK, EXP2, false>(s, o_acc, m0, m1, l0, l1, sVb, k0, row0,
                                   row_len, causal, scale_s, lane);
}

template <int D, int BK, bool EXP2, bool SPLIT, bool PIPE>
__global__ void __launch_bounds__(kMaxThreads)
flash_variant_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int L, int Lk, int H,
                     long long sqb, long long sql, long long sqh,
                     long long skb, long long skl, long long skh,
                     long long svb, long long svl, long long svh,
                     int causal, float scale_s) {
  constexpr int S = kRowStride<D>;
  constexpr int NKT = BK / 8;               // score n-tiles of a warp
  constexpr int NDT = D / 8;                // output n-tiles of a warp
  constexpr int KD = D / 16;                // k-steps of Q . K^T
  constexpr int NBUF = PIPE ? 2 : 1;
  extern __shared__ uint4 smem_u4[];
  const int BQ = blockDim.x / 32 * 16;
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);   // [BQ][S]
  bf16* sK = sQ + BQ * S;                         // [NBUF][BK][S]
  bf16* sV = sK + NBUF * BK * S;                  // [NBUF][BK][S]

  const int qi = gridDim.x - 1 - blockIdx.x;      // heavy tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qi * BQ;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int row_len = Lk;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;

  // KV tiles the q tile sees: _causal_nk_eff, then the row length; the
  // first j_full of them every row sees whole
  const int nk = Lk / BK;
  int nk_eff = nk;
  if (causal) nk_eff = min(nk, (q0 + BQ + BK - 1) / BK);
  nk_eff = min(nk_eff, (row_len + BK - 1) / BK);
  int j_full = 0;
  if (SPLIT) {
    j_full = causal ? min((q0 + 1) / BK, nk_eff) : nk_eff;
    j_full = min(j_full, row_len / BK);
  }

  load_rows<D>(sQ, qb, sql, q0, BQ);
  cp_async_commit();
  if (PIPE && nk_eff > 0) {
    load_rows<D>(sK, kb, skl, 0, BK);                   // K_0
    cp_async_commit();
    load_rows<D>(sV, vb, svl, 0, BK);                   // V_0
    if (nk_eff > 1) load_rows<D>(sK + BK * S, kb, skl, BK, BK);   // K_1
    cp_async_commit();
    cp_async_wait<1>();                                 // q and K_0
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // this warp's 16 q rows as A fragments: a0 rows 0-7 / a1 rows 8-15 of
  // columns k0..k0+7, a2 / a3 of columns k0+8..k0+15
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldmatrix_x4(qf[kd], sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * S + kd * 16 + (lane >> 4) * 8);

  float o_acc[NDT][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;

  if (PIPE) {
    float s_cur[NKT][4];
    if (nk_eff > 0) score<D, BK>(s_cur, qf, sK, lane);
    for (int j = 0; j < nk_eff; ++j) {
      cp_async_wait<0>();       // V_j and K_{j+1} have landed
      __syncthreads();          // and every warp is done with tile j-1
      if (j + 1 < nk_eff)
        load_rows<D>(sV + ((j + 1) & 1) * BK * S, vb, svl, (j + 1) * BK, BK);
      if (j + 2 < nk_eff)
        load_rows<D>(sK + (j & 1) * BK * S, kb, skl, (j + 2) * BK, BK);
      cp_async_commit();
      float s_next[NKT][4];
      if (j + 1 < nk_eff)
        score<D, BK>(s_next, qf, sK + ((j + 1) & 1) * BK * S, lane);
      softmax_pv_tile<D, BK, EXP2>(j >= j_full, s_cur, o_acc, m0, m1, l0, l1,
                                   sV + (j & 1) * BK * S, j * BK, row0,
                                   row_len, causal, scale_s, lane);
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_cur[n][e] = s_next[n][e];
    }
  } else {
    for (int j = 0; j < nk_eff; ++j) {
      __syncthreads();          // every warp is done with tile j-1
      load_rows<D>(sK, kb, skl, j * BK, BK);
      cp_async_commit();
      load_rows<D>(sV, vb, svl, j * BK, BK);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();          // K_j has landed
      float s[NKT][4];
      score<D, BK>(s, qf, sK, lane);
      cp_async_wait<0>();
      __syncthreads();          // V_j has landed
      softmax_pv_tile<D, BK, EXP2>(j >= j_full, s, o_acc, m0, m1, l0, l1, sV,
                                   j * BK, row0, row_len, causal, scale_s,
                                   lane);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  bf16* out0 = o + (((long long)b * L + row0) * H + h) * D;
  bf16* out1 = o + (((long long)b * L + row1) * H + h) * D;
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
    *reinterpret_cast<uint32_t*>(out0 + n * 8 + 2 * t) =
        pack_bf16(o_acc[n][0] / ls0, o_acc[n][1] / ls0);
    *reinterpret_cast<uint32_t*>(out1 + n * 8 + 2 * t) =
        pack_bf16(o_acc[n][2] / ls1, o_acc[n][3] / ls1);
  }
  if (t == 0) {
    lse[(long long)bh * L + row0] =
        EXP2 ? m0 * (1.f / kLog2e) + logf(ls0) : m0 + logf(ls0);
    lse[(long long)bh * L + row1] =
        EXP2 ? m1 * (1.f / kLog2e) + logf(ls1) : m1 + logf(ls1);
  }
}

template <int D, int BK, bool EXP2, bool SPLIT, bool PIPE>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int L, int Lk, int H, long long sqb, long long sql,
           long long sqh, long long skb, long long skl, long long skh,
           long long svb, long long svl, long long svh, int causal,
           float scale_s, int bq, void* stream) {
  auto kernel = flash_variant_kernel<D, BK, EXP2, SPLIT, PIPE>;
  const size_t smem = smem_bytes<D, BK, PIPE>(bq);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L / bq, B * H);
  kernel<<<grid, bq / 16 * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      L, Lk, H, sqb, sql, sqh, skb, skl, skh, svb, svl, svh, causal, scale_s);
  return (int)cudaGetLastError();
}

}  // namespace

// The instances: (D, BK, EXP2, SPLIT, PIPE).  ops/flash_variants.py
// VARIANT_INSTANCES lists the same set; BQ (64 or 128) is chosen at launch.
#define FLASH_VARIANT_INSTANCES(X) \
  X(64, 64, 0, 0, 0)               \
  X(64, 64, 1, 0, 0)               \
  X(64, 64, 0, 1, 0)               \
  X(64, 64, 1, 1, 0)               \
  X(64, 64, 1, 1, 1)               \
  X(64, 128, 1, 1, 0)              \
  X(64, 128, 1, 1, 1)              \
  X(128, 64, 0, 0, 0)              \
  X(128, 64, 1, 0, 0)              \
  X(128, 64, 0, 1, 0)              \
  X(128, 64, 1, 1, 0)              \
  X(128, 64, 1, 1, 1)              \
  X(128, 128, 1, 1, 0)             \
  X(128, 128, 1, 1, 1)

// Returns cudaErrorInvalidValue (1) for a combination that is not an
// instance or a BQ other than 64 or 128; the wrapper checks first.
extern "C" int flash_variant_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int L, int Lk, int H, int D, long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh, long long svb,
    long long svl, long long svh, int causal, float scale_s, int bq, int bk,
    int exp2, int split, int pipe, void* stream) {
  if (bq != 64 && bq != 128) return (int)cudaErrorInvalidValue;
#define FLASH_VARIANT_CASE(d, bk_, e, s, p)                                  \
  if (D == d && bk == bk_ && exp2 == e && split == s && pipe == p)         \
    return launch<d, bk_, (e != 0), (s != 0), (p != 0)>(                   \
        q, k, v, o, lse, B, L, Lk, H, sqb, sql, sqh, skb, skl, skh, svb,    \
        svl, svh, causal, scale_s, bq, stream);
  FLASH_VARIANT_INSTANCES(FLASH_VARIANT_CASE)
#undef FLASH_VARIANT_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
