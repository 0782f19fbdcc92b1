// What the flash-attention kernels on CUDA cores share (flash_fwd.cu and
// flash_bwd.cu): the tile geometry, the masked-score sentinel and exp2
// fold, the tile loader (float32 or bf16 in, float32 in shared memory),
// the store of four float32 results as float32 or bf16, and the
// visibility rule - which KV tiles a q tile sees and which q tiles
// see a KV tile - as one definition, the way
// paddle_tpu/ops/flash_attention.py keeps _causal_nk_eff and _causal_i0.
//
// The rule: query row q (global position q_off + q) sees key k (global
// position kv_off + k) when k < row_len (the batch row's kv_len, capped at
// Lk) and, under causal masking, kv_off + k <= q_off + q.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace flash {

constexpr float kNegInf = -1e30f;           // core/config.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBq = 64;                     // q rows per tile
constexpr int kBk = 64;                     // keys per tile
constexpr int kDMax = 128;                  // widest head the tiles hold
constexpr int kThreads = 256;               // 16 x 16 threads
constexpr int kQs = kDMax + 4;              // padded row stride of [*, D] tiles
constexpr int kPs = kBk + 4;                // padded row stride of [64, 64] tiles
static_assert(kBq == kBk, "load_tile fills kBk rows for q tiles too");
static_assert(kThreads == 16 * 16 && kBq == 4 * 16 && kDMax == 8 * 16,
              "each thread owns 4 rows x 4 keys and 4 rows x 8 columns");

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Load kBk rows of a [*, D] slice (row stride `ld` elements of T, float or
// __nv_bfloat16) starting at row `r0` into float shared memory with row
// stride `sld`, scaled by `mul`, zero past `nrows` and past D.  D and every
// stride are multiples of 4 (the wrappers check).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int sld, const T* src,
                                          long long ld, int r0, int nrows,
                                          int D, float mul) {
  constexpr int kVecs = kDMax / 4;
  for (int idx = threadIdx.x; idx < kBk * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = idx % kVecs;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < nrows && c * 4 < D) {
      val = load4(src + (r0 + r) * ld + c * 4);
      val.x *= mul; val.y *= mul; val.z *= mul; val.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * sld + c * 4) = val;
  }
}

// Four floats stored as four consecutive elements of T: one 16-byte store
// for float, one 8-byte store of round-to-nearest bf16 pairs for bf16.
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Whether the query at global position qpos sees key kp of this call.
__device__ __forceinline__ bool visible(long long qpos, int kp, int row_len,
                                        int causal, int kv_off) {
  return kp < row_len && (!causal || (long long)kv_off + kp <= qpos);
}

// KV tiles q tile qi sweeps, [0, n): the causal diagonal of its last row
// (_causal_nk_eff), then the row's length.
__device__ __forceinline__ int kv_tiles(int qi, int nk, int row_len,
                                        int causal, int q_off, int kv_off) {
  int n = nk;
  if (causal) {
    const long long num =
        (long long)q_off - kv_off + (long long)(qi + 1) * kBq + kBk - 1;
    n = num <= 0 ? 0 : (int)min((long long)nk, num / kBk);
  }
  return min(n, (row_len + kBk - 1) / kBk);
}

// q tiles that see KV tile kj, [first, nq): from the first q tile whose
// rows reach the tile's first key (_causal_i0); none when the tile starts
// at or past the row's length.
__device__ __forceinline__ int first_q_tile(int kj, int nq, int row_len,
                                            int causal, int q_off,
                                            int kv_off) {
  if (kj * kBk >= row_len) return nq;
  if (!causal) return 0;
  const long long num = (long long)kv_off + (long long)kj * kBk - q_off;
  return num <= 0 ? 0 : (int)min((long long)nq, num / kBq);
}

}  // namespace flash
