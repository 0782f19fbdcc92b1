// Flash attention forward for Hopper (sm_90a) on the tensor cores: float32
// operands as split TF32 (3xTF32), bf16 and float16 operands as they are.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd).  Same function: blockwise attention over
// q,k,v [B, L, H, D] with an online softmax in the exp2 domain, per-batch
// kv_lens, runtime q_offset / kv_offset for the causal rule
// kv_offset + k_pos <= q_offset + q_pos, output O [B, Lq, H, D] in the
// inputs' type and the natural-log LSE [B, H, Lq] in float32.  Fully-masked
// rows give O = 0 and LSE = NEG_INF / LOG2E + log(1e-30), like l_safe in
// the TPU kernel.  The visibility rule (which KV tiles a q tile sweeps:
// the causal diagonal of its last row, then the row's kv_len) is
// flash_common.cuh's kv_tiles, so an 8-row chunk at offset t reads about
// t keys, not the whole gathered cache.  Inputs are read through their
// strides: no transposed copy is made.
//
// What bounds it on the H100: operations.  A prefill chunk of c rows against
// a gathered cache does 4 * D * (visible q,k pairs) flops per head on
// O(c + visible keys) bytes, far above the ridge of either peak (float32
// 67 TFLOP/s or bf16 989 TFLOP/s over 3.35 TB/s: 20 or 295 flop/byte).
//
// float32, kernel 1 (flash_fwd_tf32_kernel<DT>, DT 64 for D <= 64, else
// 128).  Both products are three mma.sync m16n8k8 TF32 products with
// float32 accumulation, lo.hi + hi.lo + hi.hi of each operand's split x =
// hi + lo (mma_tf32.cuh, as the float32 backward kernels take theirs):
// within 3 * 2^-22 of |a||b| a product, where one TF32 product keeps
// 2^-10.  The bound is three products at TF32's 495 TFLOP/s, 165 TFLOP/s of
// float32 work: 0.833 ms at the LM's training shape, where float32 FMAs
// take 2.05.  As in the Pallas kernel, q is scaled by scale * log2e in
// float32 before its product (here as its landed tile is split), so S is
// in the log2 domain as it leaves the tensor cores; P = 2^(S - m) in
// float32, the row sum l adds it, LSE = m / log2e + log(max(l, 1e-30)).
// ops/flash_attention.py::_tf32x3_fwd is this arithmetic in plain torch.
// The float32 backward's dQ kernel's layout, which the forward's two
// products fit as its S and dQ do:
//   - 8 warps in 4 pairs over a 64-row q tile (heavy tiles first): a pair
//     owns 16 rows, each warp half of the head; S is taken over the warp's
//     half and added across the pair through shared memory (pair_sum),
//     both warps form the same P, and each accumulates its half of O's
//     columns: 32 O floats a thread at DT 128, where a warp owning whole
//     rows would hold 64 and its tile's P . V 64 more;
//   - the q tile lands once and is split once, scaled, into TF32 planes;
//     each warp then holds its 16 rows x half of the head as split A
//     fragments in registers for the whole sweep (64 a thread at DT 128),
//     which takes a quarter of the shared-memory reads out of each
//     sub-tile;
//   - K and V stream in 32-key sub-tiles through cp.async, two stages
//     ahead of the one being split (a thread's 16-byte copies at one
//     column and fixed rows, immediate shared offsets, zero-filled past
//     kv_len by the copy's source size), and are split once a sub-tile
//     into hi and lo planes: S reads K's as [g][t] (ldmatrix), P . V reads
//     V's as [2t][g] (one 32-bit load an element), the keys permuted
//     inside each 8-deep step so that P, S's accumulator, is the A
//     fragment as it stands.  The split rounds on the bit pattern (two
//     integer instructions, mma_tf32.cuh rna) where cvt.rna.tf32.f32 runs
//     at the conversion rate;
//   - O = O * corr + P V: the rows are rescaled, then each sub-tile's P . V
//     is summed in a fragment of its own and added in float32
//     (rows_product), never accumulated on the tensor cores across tiles,
//     which round each product's sum toward zero;
//   - sub-tiles every query of the tile sees whole skip the visibility
//     test (span_full).
//   Shared memory at DT 128: the q planes, two landing stages of K and V,
//   their four planes and the pair exchange, 219,136 bytes (one block an
//   SM; 120,832 at DT 64).  Every block splits the K and V sub-tiles it
//   reads, as each q tile of a head sweeps the same keys: splitting them
//   once a call into planes in device memory (a pre-pass) was slower at
//   the LM's shape on the H100, the planes' doubled bytes costing more
//   than the split they saved.

// The f32-dot rows of the forward ablation sweep (flash_fwd_kernel<bf16,
// EXP2, SPLIT>: bf16 in, converted to float32 as staged, flash_common.cuh
// load_tile; tools/flash_variants.py::_fwd_kernel_v2 with bf16_dots=False,
// ported in ops/flash_variants.py) run on the CUDA cores: one block of 256
// threads per (64-row q tile, batch*head); the q tile (pre-scaled) stays
// in shared memory; 64-row K and V tiles stream through shared memory;
// each thread owns a 4x4 patch of the 64x64 score tile and a 4x8 patch of
// the 64xD output accumulator.  EXP2 off works in the natural-exp domain
// (q scaled by `scale`, expf, LSE = m + log l), and SPLIT runs the tiles
// that every row of the q tile sees whole (below the causal diagonal of
// its first row and inside kv_len) without the visibility test, then the
// boundary tiles with it, as the TPU kernel's two loops do.  These
// instances keep their machine code (chip_smoke.py pins it against
// tools/sass_base/).
//
// bf16 and float16, kernel 1 (flash_fwd_mma_kernel<E, DT>, E the element
// type, bf16 or f16, DT the head tile: 64 for D <= 64, else 128).  Both
// products are mma.sync m16n8k16 on E operands with float32 accumulation
// (mma_bf16.cuh's Elem16<E>, flash_mma.cuh): the
// tensor cores' 989 TFLOP/s, where the float32 FMAs of the instance
// before it peaked at 67 (its floor alone was 15x the bf16 bound).  The
// Pallas kernel upcasts q, k and v and runs both dots in float32; here
// S = QK^T takes the E operands as they are, whose products are exact
// in float32, so it differs only in the order of the sums, and is scaled
// by scale * log2e in float32 after the product (q is not pre-scaled,
// which would round it a second time).  P is rounded once to E for
// O += P V, as SDPA and FlashAttention-2 do; the row sum l adds the
// float32 p, so the LSE = m / log2e + log(max(l, 1e-30)) is float32
// throughout; O is rounded to E once, at its store.  At f16 P's rounding
// is 8 times finer than at bf16 (11 significant bits against 8); the
// code is the same, instantiated on the other 16-bit type.
// ops/flash_attention.py::_mma_fwd is this arithmetic in plain torch.
//   A block of 4 warps owns a 64-row q tile of the Pallas grid, 16 rows a
//   warp, end to end; heavy q tiles (the causal bottom rows) are scheduled
//   first.  The q tile arrives by cp.async into padded shared memory and
//   each warp keeps its Q fragments in registers (ldmatrix) for the whole
//   sweep; 64-key K and V tiles stream through two cp.async stages, tile
//   j+1's copy in flight while tile j is computed, one barrier a tile.
//   Per tile: S (K through ldmatrix), the online softmax in the exp2
//   domain with 2^x from the MUFU and each row's max reduced over its quad
//   by shuffles (the sum stays a per-thread partial to the end), then P
//   re-packed in registers as the A operand of O += P V (V through
//   ldmatrix.trans): P never touches shared memory.  A tile pair that
//   every query sees whole (tile_full: the causal interior, unpadded
//   rows) skips the visibility test, as the TPU kernel's unmasked interior
//   loop does; on the backward kernels the test was most of the
//   elementwise work between the products.
//   Edges: rows past Lq, keys past the row's kv_len and head columns past
//   D are zero-filled in shared memory; every masked score is a select to
//   NEG_INF and its p to 0, so nothing past kv_len reaches O; a row that
//   is not 16-byte aligned (D or a stride not a multiple of 8) is copied 8
//   bytes at a time.  Shared memory: q and two stages of K and V, 87,040
//   bytes at DT 128 (two blocks an SM).  wgmma, TMA, warp specialisation
//   and a pipelined variant (the sweep's row G) are later work.

#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "mma_tf32.cuh"

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

// ------------------------------------------ bf16 and f16, tensor cores
// Shared memory at head tile DT: the q tile and two stages of K and V.
template <int DT>
constexpr size_t kFwdMmaSmem = sizeof(uint16_t) * 5 * kBq * kMs<DT>;

// The online softmax of one key tile in place of its score accumulator
// (element e of n-tile n is row row0 (+ 8 for e >= 2), key k0 + 8n + 2t +
// (e & 1)): S * scale_log2 (masked to NEG_INF where MASKED and the row
// does not see the key), each row's running max over its quad, p =
// 2^(s - m) (0 where masked), the row sum's per-thread partial and the
// rescale factor of the rows' earlier sums.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[kBk / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int row0,
                                             int k0, int t, int q_off,
                                             int row_len, int causal,
                                             int kv_off, float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * scale_log2;
      if (MASKED && !visible((long long)q_off + row0 + (e >> 1) * 8,
                             k0 + n * 8 + 2 * t + (e & 1), row_len, causal,
                             kv_off))
        x = kNegInf;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
    mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(s[n][e] - mx[e >> 1]);
      if (MASKED && !visible((long long)q_off + row0 + (e >> 1) * 8,
                             k0 + n * 8 + 2 * t + (e & 1), row_len, causal,
                             kv_off))
        p = 0.f;
      s[n][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    corr[i] = ex2(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] = l[i] * corr[i] + rs[i];
  }
}

template <typename E, int DT>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v,
                     const int* __restrict__ kv_lens, E* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, int H, int D,
                     long long sqb, long long sql, long long sqh,
                     long long skb, long long skl, long long skh,
                     long long svb, long long svl, long long svh, int q_off,
                     int kv_off, int causal, float scale_log2, int vec16) {
  constexpr int S = kMs<DT>;
  constexpr int KD = DT / 16;               // 16-deep steps over the head
  constexpr int ND = DT / 8;                // 8-wide n-tiles of O
  constexpr int NK = kBk / 8;               // 8-wide n-tiles of S
  extern __shared__ uint4 smem_u4[];
  E* sQ = reinterpret_cast<E*>(smem_u4);         // [kBq][S]
  E* sK = sQ + kBq * S;                          // [2][kBk][S]
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
  const int nk_eff =
      kv_tiles(qi, (Lk + kBk - 1) / kBk, row_len, causal, q_off, kv_off);

  auto load_kv_tile = [&](int j, int st) {
    load_tile_async<DT>(sK + st * kBk * S, kb, skl, j * kBk, row_len, D,
                        vec16);
    load_tile_async<DT>(sV + st * kBk * S, vb, svl, j * kBk, row_len, D,
                        vec16);
  };
  load_tile_async<DT>(sQ, qb, sql, q0, Lq, D, vec16);
  if (nk_eff > 0) load_kv_tile(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KD][4];
  const int a_off = warp * 16 * S + frag_a_offset<DT>(lane);
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) ldmatrix_x4(qa[kd], sQ + a_off + kd * 16);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < nk_eff; ++j) {
    const int st = j & 1;
    if (j > 0) {
      cp_async_wait<0>();                // tile j has landed
      __syncthreads();                   // and every warp is done with j-1
    }
    if (j + 1 < nk_eff) {
      load_kv_tile(j + 1, st ^ 1);
      cp_async_commit();
    }
    const int k0 = j * kBk;
    const E* sKs = sK + st * kBk * S;
    const E* sVs = sV + st * kBk * S;
    // S = Q K^T of the warp's 16 rows x the tile's 64 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sKs + np * 16 * S + frag_b_offset<DT>(lane)
                            + kd * 16);
        Elem16<E>::mma(s[2 * np], qa[kd], kf[0], kf[1]);
        Elem16<E>::mma(s[2 * np + 1], qa[kd], kf[2], kf[3]);
      }
    float corr[2];
    if (tile_full(q0, k0, Lq, row_len, causal, q_off, kv_off))
      softmax_tile<false>(s, m, l, corr, row0, k0, t, q_off, row_len,
                          causal, kv_off, scale_log2);
    else
      softmax_tile<true>(s, m, l, corr, row0, k0, t, q_off, row_len, causal,
                         kv_off, scale_log2);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V over the tile's keys, 16 at a time
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t pa[4];
      pack_a<E>(pa, s[2 * kk], s[2 * kk + 1]);
      const int off = kk * 16 * S + frag_a_offset<DT>(lane);
#pragma unroll
      for (int nd = 0; nd < KD; ++nd) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sVs + off + nd * 16);
        Elem16<E>::mma(acc[2 * nd], pa, vf[0], vf[1]);
        Elem16<E>::mma(acc[2 * nd + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // the rows' sums over their quads; O = acc / l_safe, rounded once
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] *= inv[0];
    acc[n][1] *= inv[0];
    acc[n][2] *= inv[1];
    acc[n][3] *= inv[1];
  }
  store_rows<DT>(o, acc, row0, Lq, b, h, H, D, t, 1.f);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r < Lq)
        lse[((long long)b * H + h) * Lq + r] =
            m[i] * (1.f / kLog2e) + logf(l[i]);
    }
  }
}

template <typename E, int DT>
int fwd_mma_launch(const void* q, const void* k, const void* v,
                   const void* kv_lens, void* o, void* lse, int B, int Lq,
                   int Lk, int H, int D, long long sqb, long long sql,
                   long long sqh, long long skb, long long skl, long long skh,
                   long long svb, long long svl, long long svh, int q_off,
                   int kv_off, int causal, float scale_log2, void* stream) {
  auto kernel = flash_fwd_mma_kernel<E, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdMmaSmem<DT>);
  if (err != cudaSuccess) return (int)err;
  const long long st[9] = {sqb, sql, sqh, skb, skl, skh, svb, svl, svh};
  const int vec16 = rows_16b(D, st);
  dim3 grid((Lq + kBq - 1) / kBq, B * H);
  kernel<<<grid, kMmaThreads, kFwdMmaSmem<DT>, (cudaStream_t)stream>>>(
      (const E*)q, (const E*)k, (const E*)v, (const int*)kv_lens, (E*)o,
      (float*)lse, Lq, Lk, H, D, sqb, sql, sqh, skb, skl, skh, svb,
      svl, svh, q_off, kv_off, causal, scale_log2, vec16);
  return (int)cudaGetLastError();
}

// ---------------------------------------- float32, tensor cores (3xTF32)
// Shared memory at head tile DT: the q tile's two planes, two landing
// stages of the 32-key K and V sub-tiles, their four planes and the pairs'
// S exchange (8 warps x 2 KB).
template <int DT>
constexpr size_t kFwdTf32Smem =
    sizeof(float) * (2 * kBq * tf32::kTs<DT> + 8 * tf32::kSub * tf32::kTs<DT>
                     + tf32::kThreads / 32 * 512);
static_assert(tf32::kThreads == 8 * 32 && kBq == 4 * 16,
              "four pairs of warps, 16 rows a pair");
static_assert(kBq == 2 * tf32::kSub && kBk % tf32::kSub == 0,
              "the q tile's raw rows land in the K planes' two sub-tiles");

// The online softmax of a 32-key sub-tile in place of its score
// accumulator, S already in the log2 domain (element e of n-tile n is row
// row0 (+ 8 for e >= 2), key k0 + 8n + 2t + (e & 1)): masked to NEG_INF
// where MASKED and the row does not see the key, each row's running max
// over its quad, p = 2^(s - m) (0 where masked), the row sum's per-thread
// partial and the rescale factor of the rows' earlier sums.
template <bool MASKED>
__device__ __forceinline__ void softmax_sub(float (&s)[4][4], float (&m)[2],
                                            float (&l)[2], float (&corr)[2],
                                            int row0, int k0, int t,
                                            int q_off, int row_len,
                                            int causal, int kv_off) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED && !visible((long long)q_off + row0 + (e >> 1) * 8,
                             k0 + n * 8 + 2 * t + (e & 1), row_len, causal,
                             kv_off))
        s[n][e] = kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
    mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(s[n][e] - mx[e >> 1]);
      if (MASKED && !visible((long long)q_off + row0 + (e >> 1) * 8,
                             k0 + n * 8 + 2 * t + (e & 1), row_len, causal,
                             kv_off))
        p = 0.f;
      s[n][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    corr[i] = ex2(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] = l[i] * corr[i] + rs[i];
  }
}

template <int DT>
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ kv_lens,
                      float* __restrict__ o, float* __restrict__ lse, int Lq,
                      int Lk, int H, int D, long long sqb, long long sql,
                      long long sqh, long long skb, long long skl,
                      long long skh, long long svb, long long svl,
                      long long svh, int q_off, int kv_off, int causal,
                      float scale_log2) {
  constexpr int S = tf32::kTs<DT>;
  constexpr int R = tf32::kSub;
  constexpr int KH = DT / 16;      // 8-deep steps over half of the head;
                                   // the 8-wide n-tiles of a warp's O
  extern __shared__ float4 smem_f4[];
  float* sQh = reinterpret_cast<float*>(smem_f4);  // [kBq][S] q, TF32 hi
  float* sQl = sQh + kBq * S;                      //          and lo
  float* sKr = sQl + kBq * S;                      // [2][R][S] K landing
  float* sVr = sKr + 2 * R * S;                    // [2][R][S] V landing
  float* sKh = sVr + 2 * R * S;                    // [R][S] K, TF32 hi
  float* sKl = sKh + R * S;                        //        and lo
  float* sVh = sKl + R * S;                        // [R][S] V, hi
  float* sVl = sVh + R * S;                        //        and lo
  float* sX = sVl + R * S;                         // [8 warps][4][32][4]

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
  // sub-tiles [0, nj) of R keys: those of the key tiles the q tile sees,
  // less the last one when no row of the tile sees it
  int nj = kv_tiles(qi, (Lk + kBk - 1) / kBk, row_len, causal, q_off,
                    kv_off) * (kBk / R);
  if (nj > 0 && ((nj - 1) * R >= row_len ||
                 (causal && (long long)kv_off + (nj - 1) * R >
                                (long long)q_off + q0 + kBq - 1)))
    --nj;

  // sub-tile j lands in stage j & 1, two sub-tiles ahead of the one split.
  // A thread copies 16 bytes at column cc of rows rr + i kStep of K and V,
  // one base address a side (the other rows at immediate shared offsets and
  // fixed global steps); a row past the batch row's kv_len, or a column
  // past D, reads nothing and lands as zeros
  constexpr int kCpr = DT / 4, kStep = tf32::kThreads / kCpr;
  const int cc = threadIdx.x % kCpr * 4, rr = threadIdx.x / kCpr;
  const uint32_t k_dst = mma::smem_u32(sKr + rr * S + cc);
  const uint32_t v_dst = mma::smem_u32(sVr + rr * S + cc);
  const float* k_src = kb + rr * skl + cc;
  const float* v_src = vb + rr * svl + cc;
  auto load_sub = [&](int j) {
    const uint32_t st = (j & 1) * R * S * 4;
    const float* ks = k_src + j * R * skl;
    const float* vs = v_src + j * R * svl;
    mma::static_for<R / kStep>([&](auto ic) {
      constexpr int i = decltype(ic)::value;
      const bool ok = cc < D && j * R + rr + i * kStep < row_len;
      constexpr int kOff = i * kStep * S * 4;
      mma::copy_or_zero<16, kOff>(k_dst + st, ok ? ks + i * kStep * skl : k,
                                  ok);
      mma::copy_or_zero<16, kOff>(v_dst + st, ok ? vs + i * kStep * svl : v,
                                  ok);
    });
  };
  // q's raw rows land where the K planes go, beside the first sub-tiles
  tf32::load_rows<DT, kBq>(sKh, qb, sql, q0, Lq, D);
  if (nj > 0) load_sub(0);
  cp_async_commit();
  if (nj > 1) load_sub(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  tf32::split_rows<DT, kBq>(sQh, sQl, sKh, scale_log2);

  float acc[KH][4];
#pragma unroll
  for (int n = 0; n < KH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // fragment corners: the A fragments of the pair's rows in the warp's
  // half of the head (ldmatrix on the q planes), the B fragments of the
  // sub-tile's keys (ldmatrix on the K planes), and the [2t][g] reads of
  // the V planes' rows
  const int a_off = pair * 16 * S + c_own + tf32::a_lane<S>(lane);
  const int b_off = c_own + tf32::b_lane<S>(lane);
  const int r_off = 2 * t * S + c_own + gr;
  float* x_mine = sX + warp * 512 + lane * 4;
  const float* x_theirs = sX + (warp ^ 4) * 512 + lane * 4;
  // the pair's q rows in the warp's half of the head, as split A fragments
  // held in registers for the whole sweep
  __syncthreads();                       // the q planes are complete
  tf32::SplitA aq[KH];
#pragma unroll
  for (int kd = 0; kd < KH; ++kd)
    tf32::load_a_planes(aq[kd], sQh + a_off + kd * 8, sQl + a_off + kd * 8);
  for (int j = 0; j < nj; ++j) {
    cp_async_wait<1>();
    __syncthreads();                     // j landed; planes of j-1 read
    tf32::split_rows<DT, R>(sKh, sKl, sKr + (j & 1) * R * S);
    tf32::split_rows<DT, R>(sVh, sVl, sVr + (j & 1) * R * S);
    __syncthreads();                     // planes of j ready, its stage free
    if (j + 2 < nj) load_sub(j + 2);
    cp_async_commit();
    const int k0 = j * R;
    const bool full = tf32::span_full(q0, kBq, k0, R, Lq, row_len, causal,
                                      q_off, kv_off);
    // S = Q K^T of the pair's 16 rows x these 32 keys (n-tile n: keys
    // k0 + 8n ..), over the warp's half of the head, then over the whole
    // head from the pair's two halves
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KH; ++kd) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = b_off + np * 16 * S + kd * 8;
        tf32::SplitB bk[2];
        tf32::load_b2(bk, sKh + off, sKl + off);
        tf32::mma3(s[2 * np], aq[kd], bk[0]);
        tf32::mma3(s[2 * np + 1], aq[kd], bk[1]);
      }
    }
    tf32::pair_sum(s, x_mine, x_theirs, pair);
    float corr[2];
    if (full)
      softmax_sub<false>(s, m, l, corr, row0, k0, t, q_off, row_len, causal,
                         kv_off);
    else
      softmax_sub<true>(s, m, l, corr, row0, k0, t, q_off, row_len, causal,
                        kv_off);
#pragma unroll
    for (int n = 0; n < KH; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V over these 32 keys, the warp's columns: P is the A fragment
    // as it stands, V the B fragments of rows 2t and 2t+1 of each 8-key
    // step
    tf32::rows_product<S, KH>(acc, s, sVh + r_off, sVl + r_off);
  }
  cp_async_wait<0>();                    // no copy outlives the block

  // the rows' sums over their quads; O = acc / l_safe
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
  }
#pragma unroll
  for (int n = 0; n < KH; ++n) {
    acc[n][0] *= inv[0];
    acc[n][1] *= inv[0];
    acc[n][2] *= inv[1];
    acc[n][3] *= inv[1];
  }
  tf32::store_rows<KH>(o, acc, row0, Lq, b, h, H, D, c_own, t, 1.f);
  if (c_own == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r < Lq)
        lse[((long long)b * H + h) * Lq + r] =
            m[i] * (1.f / kLog2e) + logf(l[i]);
    }
  }
}

template <int DT>
int fwd_tf32_launch(const void* q, const void* k, const void* v,
                    const void* kv_lens, void* o, void* lse, int B, int Lq,
                    int Lk, int H, int D, long long sqb, long long sql,
                    long long sqh, long long skb, long long skl,
                    long long skh, long long svb, long long svl,
                    long long svh, int q_off, int kv_off, int causal,
                    float scale_log2, void* stream) {
  auto kernel = flash_fwd_tf32_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdTf32Smem<DT>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBq - 1) / kBq, B * H);
  kernel<<<grid, tf32::kThreads, kFwdTf32Smem<DT>, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const int*)kv_lens, (float*)o, (float*)lse, Lq, Lk, H, D, sqb, sql,
      sqh, skb, skl, skh, svb, svl, svh, q_off, kv_off, causal, scale_log2);
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

// Kernel 1 (scale_q = scale * log2 e), float32 in and out, on the tensor
// cores as split TF32 at the head tile D fits.
extern "C" int flash_fwd_f32(FLASH_FWD_ARGS) {
  return D <= 64 ? fwd_tf32_launch<64>(FLASH_FWD_PASS)
                 : fwd_tf32_launch<128>(FLASH_FWD_PASS);
}

// Kernel 1 on bf16 q/k/v, on the tensor cores at the head tile D fits:
// O in bf16, LSE in float32.
extern "C" int flash_fwd_bf16(FLASH_FWD_ARGS) {
  return D <= 64 ? fwd_mma_launch<bf16, 64>(FLASH_FWD_PASS)
                 : fwd_mma_launch<bf16, 128>(FLASH_FWD_PASS);
}

// Kernel 1 on float16 q/k/v: the same kernel on f16 operands (P rounded
// to f16), O in float16, LSE in float32.
extern "C" int flash_fwd_f16(FLASH_FWD_ARGS) {
  return D <= 64 ? fwd_mma_launch<f16, 64>(FLASH_FWD_PASS)
                 : fwd_mma_launch<f16, 128>(FLASH_FWD_PASS);
}

// Registers and local memory (bytes a thread: stack and spills) of the
// tensor-core kernel at head tile `dt` (64 or 128), on bf16 operands or,
// with `is_f16`, float16 ones.
extern "C" int flash_fwd_mma_resources(int dt, int is_f16, int* regs,
                                       int* local_bytes) {
  const void* fn =
      is_f16 ? (dt == 64 ? (const void*)flash_fwd_mma_kernel<f16, 64>
                         : (const void*)flash_fwd_mma_kernel<f16, 128>)
             : (dt == 64 ? (const void*)flash_fwd_mma_kernel<bf16, 64>
                         : (const void*)flash_fwd_mma_kernel<bf16, 128>);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Registers and local memory (bytes a thread: stack and spills) of the
// float32 (3xTF32) kernel at head tile `dt` (64 or 128).
extern "C" int flash_fwd_f32_resources(int dt, int* regs, int* local_bytes) {
  const void* fn = dt == 64 ? (const void*)flash_fwd_tf32_kernel<64>
                            : (const void*)flash_fwd_tf32_kernel<128>;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
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
