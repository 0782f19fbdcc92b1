// The split-TF32 ("3xTF32") tensor-core building blocks of the float32
// kernels on the tensor cores (flash_bwd.cu's flash_bwd_{dkdv,dq}_tf32_kernel,
// flash_fwd.cu's flash_fwd_tf32_kernel, conv_bn.cu's
// conv3x3_tf32_stats_kernel): the split of a float32 value into two TF32
// parts, mma.sync m16n8k8 on TF32 operands with float32 accumulation, the
// three products that stand for one float32 product, the fragment loads
// from padded float32 tiles (or their TF32 planes) in shared memory, the
// cp.async tile loader, the split of a landed tile into TF32 planes, the
// exchange of a warp pair's partial sums and the store of a warp's float32
// rows.
//
// The split: hi = rna(x) and lo = rna(x - hi), both rounded to nearest
// with ties away from zero as PTX's cvt.rna.tf32.f32 rounds (TF32 keeps
// float32's exponent and 10 mantissa bits, held in a 32-bit register with
// the 13 low bits zero).  x - hi is exact in float32, and hi + lo is x
// within 2^-22 of |x|.  A product a.b is taken as lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b, accumulated in float32 in that order (the small terms first):
// it leaves out lo_a.lo_b and the split's remainders, within 3 * 2^-22 of
// |a||b|, where one TF32 product (hi_a.hi_b) is off by up to 2^-10.  The
// tensor cores round each product's sum toward zero, so a long sum kept in
// one accumulator drifts by up to an ulp of the running sum a product (5e-5
// of max |dK| over 4096 queries); the kernels sum each 32-row sub-tile's
// products in a fragment of their own and add it to the running sum in
// float32.
// ops/flash_attention.py::_tf32x3_bwd is this arithmetic in plain torch,
// with the same rounding on the float32 bit pattern.
//
// Fragments (m16n8k8, lane = 4 g + t): A (16 x 8, row) a0 = A[g][t], a1 =
// A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; B (8 x 8, col) b0 = B[t][g],
// b1 = B[t+4][g]; C (16 x 8) c0, c1 = C[g][2t], C[g][2t+1], c2, c3 the same
// at row g+8.  The kernels read fragments in two patterns:
//   [g][t]: a row index from g, a column from t - the A fragments of the
//   resident tile and the B fragments of S = Q K^T and dP = dO V^T, whose
//   operands are row-major [row][head column]: ldmatrix, which moves
//   32-bit words as pairs of 16-bit ones, reads four such 8 x 4 blocks at
//   once (load_a, load_b2);
//   [2t][g]: a row index from t, a column from g - the B fragments of dV =
//   P^T dO, dK = dS^T Q and dQ = dS K, which reduce over the tile's rows:
//   one 32-bit shared load an element (load_b_rows).
// A row stride of DT + 4 words (4 mod 32) serves both: ldmatrix's eight
// 16-byte rows fall in distinct bank groups, and 2t (DT + 4) + g = 8 t + g
// (mod 32) covers the 32 banks.  The second pattern reads rows 2t and 2t+1
// where the fragment wants reduction indices t and t+4: the reduction
// index is permuted inside each 8-deep step, consistently in A and B, so
// the float32 accumulator of the product before (its columns 2t and 2t+1)
// is the A fragment as it stands (a_of_acc), with no shuffle and no trip
// through shared memory.  The streamed operand is split once a sub-tile
// into hi and lo planes (split_rows); the resident tile and P and dS are
// split in registers as they are read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace tf32 {

constexpr int kThreads = 256;               // 8 warps: 4 pairs
constexpr int kSub = 32;                    // rows of a streamed sub-tile

template <int DT>
constexpr int kTs = DT + 4;                 // padded row of a float32 tile

// x rounded to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds it, on the bit pattern: half a unit of the 13
// dropped bits added to the magnitude (a carry into the exponent is the
// rounding up, past the largest finite value to inf), then those bits
// cleared (ops/flash_attention.py::_tf32_rna is the same on the CPU; a NaN
// may come back as inf, and its lo part, x - hi, is NaN).  Two integer
// instructions at the integer ALU's rate, where cvt runs at the far lower
// rate of the conversions (PERF.md, PR 13).
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An A fragment (four elements) and a B fragment (two), each element as
// its TF32 high and low parts.
struct SplitA {
  uint32_t hi[4], lo[4];
};
struct SplitB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// c += a . b, one TF32 product: a 16 x 8 (row), b 8 x 8 (col), c 16 x 8
// float32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b as three TF32 products: lo.hi, hi.lo, then hi.hi.
__device__ __forceinline__ void mma3(float (&c)[4], const SplitA& a,
                                     const SplitB& b) {
  mma(c, a.lo, b.hi[0], b.hi[1]);
  mma(c, a.hi, b.lo[0], b.lo[1]);
  mma(c, a.hi, b.hi[0], b.hi[1]);
}

// ldmatrix (m8n8, b16) moves 32-bit words as well: of each 8 x 4-float
// matrix, lane 4 g + t gets the word at row g, float column t, which is the
// [g][t] read of the fragments.  Lane offsets into a tile with row stride
// S for ldmatrix.x4: the A fragment (rows 0-7 and 8-15 at columns 0-3, then
// at 4-7: a0, a1, a2, a3) and the B fragments of two 8-row n-tiles of an
// [n][k] tile (rows 0-7 at columns 0-3 and 4-7: b0, b1 of the first, then
// rows 8-15: the second).  Each row address is 16-byte aligned (S and the
// column offsets are multiples of 4 floats), and eight rows of DT + 4
// floats fall in eight distinct 16-byte bank groups.
template <int S>
__device__ __forceinline__ int a_lane(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 4;
}
template <int S>
__device__ __forceinline__ int b_lane(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * S + ((lane >> 3) & 1) * 4;
}

// The A fragment of a float32 tile, split as it is read: p is the tile's
// fragment corner plus a_lane.
__device__ __forceinline__ void load_a(SplitA& a, const float* p) {
  uint32_t r[4];
  mma::ldmatrix_x4(r, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), a.hi[i], a.lo[i]);
}

// The A fragment of a tile held as its TF32 parts (split_rows): hi and lo
// are the planes' fragment corners plus a_lane.
__device__ __forceinline__ void load_a_planes(SplitA& a, const float* hi,
                                              const float* lo) {
  mma::ldmatrix_x4(a.hi, hi);
  mma::ldmatrix_x4(a.lo, lo);
}

// The B fragments of two n-tiles from an [n][k] tile held as its TF32
// parts (split_rows): hi and lo are the planes' fragment corners plus
// b_lane.
__device__ __forceinline__ void load_b2(SplitB (&b)[2], const float* hi,
                                        const float* lo) {
  uint32_t h[4], l[4];
  mma::ldmatrix_x4(h, hi);
  mma::ldmatrix_x4(l, lo);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    b[n].hi[0] = h[2 * n];
    b[n].hi[1] = h[2 * n + 1];
    b[n].lo[0] = l[2 * n];
    b[n].lo[1] = l[2 * n + 1];
  }
}

// The B fragment of a [k][n] tile held as its TF32 parts, the reduction
// over its rows permuted (logical k t and t+4 are rows 2t and 2t+1): hi and
// lo point at [k0 + 2t][n0 + g] of planes with row stride S.
template <int S>
__device__ __forceinline__ void load_b_rows(SplitB& b, const float* hi,
                                            const float* lo) {
  b.hi[0] = __float_as_uint(hi[0]);
  b.hi[1] = __float_as_uint(hi[S]);
  b.lo[0] = __float_as_uint(lo[0]);
  b.lo[1] = __float_as_uint(lo[S]);
}

// An m16n8 float32 accumulator (columns 2t, 2t+1 of rows g, g+8) as the A
// fragment of the next product's 8-deep step under load_b_rows'
// permutation: logical column t is column 2t, t+4 is 2t+1.
__device__ __forceinline__ void a_of_acc(SplitA& a, const float (&c)[4]) {
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
}

// acc += the sub-tile's product over its 32 rows: A the four 8-deep steps
// of c (accumulators of the product before, a_of_acc), B the [2t][g]
// fragments of planes hi and lo (corners plus 2t rows and g columns; step
// kk and n-tile nd at kk * 8 rows and nd * 8 columns further).  Each
// n-tile's twelve products go into a fragment of their own, added to acc
// in float32.
template <int S, int N>
__device__ __forceinline__ void rows_product(float (&acc)[N][4],
                                             const float (&c)[4][4],
                                             const float* hi,
                                             const float* lo) {
  SplitA x[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) a_of_acc(x[kk], c[kk]);
#pragma unroll
  for (int nd = 0; nd < N; ++nd) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int o = kk * 8 * S + nd * 8;
      SplitB f;
      load_b_rows<S>(f, hi + o, lo + o);
      mma3(d, x[kk], f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] += d[e];
  }
}

// Copy rows r0..r0+ROWS-1 of a [*, D] float32 slice (row stride `ld`
// floats, a multiple of 4, 16-byte aligned rows) into a padded tile with
// 16-byte cp.async copies; rows past `nrows` and columns past D (a
// multiple of 4) are zeroed with plain stores.
template <int DT, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ld, int r0, int nrows,
                                          int D) {
  constexpr int kChunks = DT / 4;
  static_assert(ROWS * kChunks % kThreads == 0, "whole passes of the block");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks * 4;
    float* d = dst + r * kTs<DT> + c;
    if (r0 + r < nrows && c < D)
      mma::cp_async16(d, src + (long long)(r0 + r) * ld + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Split ROWS padded rows of float32 (`raw`, as they landed, times `mul`)
// into their TF32 parts, `hi` and `lo` in the same layout: each streamed
// sub-tile is split once by the whole block, where each of the four warp
// pairs would split every element it reads again.
template <int DT, int ROWS>
__device__ __forceinline__ void split_rows(float* hi, float* lo,
                                           const float* raw,
                                           float mul = 1.f) {
  constexpr int kChunks = DT / 4;
  static_assert(ROWS * kChunks % kThreads == 0, "whole passes of the block");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int o = idx / kChunks * kTs<DT> + idx % kChunks * 4;
    float4 x = *reinterpret_cast<const float4*>(raw + o);
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// Copy floats r0..r0+n-1 of a row of LSE or delta, zero past `nrows`.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int r0, int nrows, int n) {
  const int r = threadIdx.x;
  if (r < n) {
    if (r0 + r < nrows) mma::cp_async4(dst + r, src + r0 + r);
    else dst[r] = 0.f;
  }
}

// The two warps of pair `pair` (warps pair and pair + 4) meet: named
// barrier 1 + pair over their 64 threads (barrier 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// Whether every query of q0..q0+nq-1 sees every key of k0..k0+nk-1 (the
// visibility rule of flash_common.cuh): such a span skips the test.
__device__ __forceinline__ bool span_full(int q0, int nq, int k0, int nk,
                                          int Lq, int row_len, int causal,
                                          int q_off, int kv_off) {
  return q0 + nq <= Lq && k0 + nk <= row_len &&
         (!causal ||
          (long long)kv_off + k0 + nk - 1 <= (long long)q_off + q0);
}

// Write the accumulator rows `row` (c0, c1) and `row + 8` (c2, c3) of a
// warp's N n-tiles, columns c0 + 8n + 2t and the next, times `mul`, into a
// contiguous float32 [B, L, H, D] tensor at (b, h), two columns a store;
// rows past L and columns past D are not written.
template <int N>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[N][4], int row,
                                           int L, int b, int h, int H, int D,
                                           int c0, int t, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= L) continue;
    float* dst = out + (((long long)b * L + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = c0 + n * 8 + 2 * t;
      if (c < D)
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

// A warp's 16 partial sums of S (its half of the head) handed to the other
// warp of its pair through `mine` and `theirs` ([4][32][4] floats each,
// laid out as below), and the pair's sums formed: own + other.
__device__ __forceinline__ void pair_sum(float (&s)[4][4], float* mine,
                                         const float* theirs, int pair) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    *reinterpret_cast<float4*>(mine + n * 128) =
        make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
  pair_sync(pair);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float4 x = *reinterpret_cast<const float4*>(theirs + n * 128);
    s[n][0] += x.x;
    s[n][1] += x.y;
    s[n][2] += x.z;
    s[n][3] += x.w;
  }
}

// A warp's 32 partial sums (S and dP of its half of the head) handed to
// the other warp of its pair through `mine` and `theirs` ([8][32][4]
// floats each: four values of a lane in one 16-byte store, neighbouring
// lanes on neighbouring 16 bytes), and the pair's sums formed: own +
// other, the same float in both warps since float addition commutes.
__device__ __forceinline__ void pair_sum(float (&s)[4][4], float (&dp)[4][4],
                                         float* mine, const float* theirs,
                                         int pair) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<float4*>(mine + n * 128) =
        make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    *reinterpret_cast<float4*>(mine + (4 + n) * 128) =
        make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
  }
  pair_sync(pair);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float4 x = *reinterpret_cast<const float4*>(theirs + n * 128);
    const float4 y = *reinterpret_cast<const float4*>(theirs + (4 + n) * 128);
    s[n][0] += x.x;
    s[n][1] += x.y;
    s[n][2] += x.z;
    s[n][3] += x.w;
    dp[n][0] += y.x;
    dp[n][1] += y.y;
    dp[n][2] += y.z;
    dp[n][3] += y.w;
  }
}

}  // namespace tf32
