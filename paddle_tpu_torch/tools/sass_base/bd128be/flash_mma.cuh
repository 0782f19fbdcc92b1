// What the bf16 flash-attention kernels on the tensor cores share
// (flash_fwd.cu's forward, flash_bwd.cu's dK/dV and dQ): a block of 4
// warps over flash_common.cuh's 64-row tiles, bf16 tiles in shared memory
// with rows padded by 16 bytes (so ldmatrix's eight row addresses fall in
// distinct banks), their cp.async loaders with zero-filled edges, the
// ldmatrix lane offsets of the A and B fragments, the re-packing of a
// float32 accumulator as the next product's A operand, the store of a
// warp's rows as bf16, 2^x on the MUFU, the test of a tile pair that
// every query sees whole, and the host's test of 16-byte rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"

namespace flash {

using mma::bf16;
using mma::cp_async16;
using mma::cp_async4;
using mma::cp_async8;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;
using mma::pack_bf16;

constexpr int kMmaThreads = 128;            // 4 warps, 16 rows each
static_assert(kBq == 64 && kBk == 64 && kMmaThreads / 32 * 16 == kBq,
              "a warp owns 16 of the 64 rows of its block's tile");

template <int DT>
constexpr int kMs = DT + 8;                 // padded row of a bf16 tile

// Copy rows r0..r0+63 of a [*, D] bf16 slice (row stride `ld` elements)
// into a padded tile with cp.async, W elements a copy (8: 16 bytes, 4: 8
// bytes).  Rows past `nrows` and columns past D are zeroed with plain
// stores.
template <int DT, int W>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long ld, int r0, int nrows,
                                          int D) {
  constexpr int kChunks = DT / W;
  for (int idx = threadIdx.x; idx < kBq * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = idx % kChunks * W;
    bf16* d = dst + r * kMs<DT> + c;
    const bool live = r0 + r < nrows && c < D;
    const bf16* s = src + (long long)(r0 + r) * ld + c;
    if (W == 8) {
      if (live) cp_async16(d, s);
      else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      if (live) cp_async8(d, s);
      else *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
    }
  }
}

// A 64-row tile: 16-byte copies when `vec16` (D and every stride
// multiples of 8), else 8-byte ones.
template <int DT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long ld, int r0,
                                                int nrows, int D,
                                                bool vec16) {
  if (vec16) copy_rows<DT, 8>(dst, src, ld, r0, nrows, D);
  else copy_rows<DT, 4>(dst, src, ld, r0, nrows, D);
}

// Lane offsets into a padded tile for ldmatrix.x4: the A fragment of 16
// rows x 16 columns (also the .trans B fragment of 16 k-rows x two 8-wide
// n-tiles) and the B fragment of two 8-row n-tiles x 16 k-columns.
template <int DT>
__device__ __forceinline__ int frag_a_offset(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * kMs<DT> + (lane >> 4) * 8;
}
template <int DT>
__device__ __forceinline__ int frag_b_offset(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * kMs<DT> + ((lane >> 3) & 1) * 8;
}

// Two accumulator n-tiles (16 columns) as the A fragment of the next
// product's 16-deep step, each value rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Write the accumulator rows `row` (e = 0, 1) and `row + 8` (e = 2, 3) of
// a warp's [16, DT] tile, times `mul`, as bf16 into a contiguous
// [B, L, H, D] tensor at (b, h); rows past L and columns past D are not
// written.
template <int DT>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[DT / 8][4],
                                           int row, int L, int b, int h,
                                           int H, int D, int t, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= L) continue;
    bf16* dst = out + (((long long)b * L + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DT / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D)
        *reinterpret_cast<uint32_t*>(dst + c) =
            pack_bf16(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

// 2^x on the MUFU unit alone (ex2.approx.ftz: a result below 2^-126
// flushes to zero, which no bf16 P or dS term can tell from its own
// rounding of it); exp2f adds a denormal fix-up around the same MUFU.EX2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Whether every query of the q tile at q0 sees every key of the key tile
// at k0: such a tile skips the visibility test, as the TPU kernels'
// unmasked interior loop does.
__device__ __forceinline__ bool tile_full(int q0, int k0, int Lq,
                                          int row_len, int causal, int q_off,
                                          int kv_off) {
  return q0 + kBq <= Lq && k0 + kBk <= row_len &&
         (!causal ||
          (long long)kv_off + k0 + kBk - 1 <= (long long)q_off + q0);
}

// Whether every row of the operands is 16-byte aligned (the data is, the
// wrappers check): D and every stride multiples of 8 bf16.
template <int N>
inline int rows_16b(int D, const long long (&st)[N]) {
  if (D % 8) return 0;
  for (long long s : st)
    if (s % 8) return 0;
  return 1;
}

}  // namespace flash
