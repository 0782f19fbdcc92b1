// The second pass of every per-channel statistic in ops/csrc: per-block
// partial sums [R, C] (two of them) reduced over R into [C], in a fixed
// order, so that a statistic is the same on every run (no float atomics).
//
// Used by bn_stats.cu (kernels 7a and 7b) and conv_bn.cu (the epilogues of
// kernels 8 and 9).  A block owns 32 channels; its 8 warps take turns
// over the rows 0, stride, 2 stride, ... of the partials, and their sums
// meet in shared memory in warp order.  finish() is one such pass over every row, one
// block for each 32 channels: at ResNet-50's R = 6272 rows of 256
// channels that is 8 blocks to stream 12.8 MB.  finish_chunked() first
// sums each run of kChunk rows into the run's first row (a block a run
// and 32 channels), then reduces those heads; on the H100 that took 0.06
// ms off each bf16 conv call at batch 256 (chip_smoke.py).

#pragma once

#include <cuda_runtime.h>

namespace stat_reduce {
namespace {

constexpr int kCh = 32;     // channels a block owns, one a lane
constexpr int kWarps = 8;   // warps splitting the rows of the partials

constexpr int kChunk = 64;  // rows a block of finish_chunked's first pass

// out[c] = sum of rows 0, stride, 2 stride, ... (< R) of the partials.
__global__ void __launch_bounds__(kCh * kWarps)
finish_kernel(const float* __restrict__ part_a,
              const float* __restrict__ part_b, int R, int C, int stride,
              float* __restrict__ out_a, float* __restrict__ out_b) {
  __shared__ float red[2][kWarps][kCh];
  const int lane = threadIdx.x % kCh, wy = threadIdx.x / kCh;
  const int c = blockIdx.x * kCh + lane;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int r = wy * stride; r < R; r += kWarps * stride) {
      a += part_a[(long long)r * C + c];
      b += part_b[(long long)r * C + c];
    }
  }
  red[0][wy][lane] = a;
  red[1][wy][lane] = b;
  __syncthreads();
  if (wy == 0 && c < C) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ta += red[0][i][lane];
      tb += red[1][i][lane];
    }
    out_a[c] = ta;
    out_b[c] = tb;
  }
}

// Rows [k kChunk, (k + 1) kChunk) of the partials summed into row k kChunk
// (block (channels, k); only this block reads those rows).
__global__ void __launch_bounds__(kCh * kWarps)
chunk_kernel(float* __restrict__ part_a, float* __restrict__ part_b, int R,
             int C) {
  __shared__ float red[2][kWarps][kCh];
  const int lane = threadIdx.x % kCh, wy = threadIdx.x / kCh;
  const int c = blockIdx.x * kCh + lane;
  const int r0 = blockIdx.y * kChunk, r1 = min(R, r0 + kChunk);
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int r = r0 + wy; r < r1; r += kWarps) {
      a += part_a[(long long)r * C + c];
      b += part_b[(long long)r * C + c];
    }
  }
  red[0][wy][lane] = a;
  red[1][wy][lane] = b;
  __syncthreads();
  if (wy == 0 && c < C) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ta += red[0][i][lane];
      tb += red[1][i][lane];
    }
    part_a[(long long)r0 * C + c] = ta;
    part_b[(long long)r0 * C + c] = tb;
  }
}

// Launch the second pass; returns the launch's CUDA error.
inline cudaError_t finish(const float* part_a, const float* part_b, int R,
                          int C, float* out_a, float* out_b,
                          cudaStream_t stream) {
  finish_kernel<<<(C + kCh - 1) / kCh, kCh * kWarps, 0, stream>>>(
      part_a, part_b, R, C, 1, out_a, out_b);
  return cudaGetLastError();
}

// The same sums over runs of kChunk rows first (two launches, the partials
// overwritten), for R in the thousands.
inline cudaError_t finish_chunked(float* part_a, float* part_b, int R, int C,
                                  float* out_a, float* out_b,
                                  cudaStream_t stream) {
  if (R <= kChunk) return finish(part_a, part_b, R, C, out_a, out_b, stream);
  const dim3 grid((C + kCh - 1) / kCh, (R + kChunk - 1) / kChunk);
  chunk_kernel<<<grid, kCh * kWarps, 0, stream>>>(part_a, part_b, R, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<<<(C + kCh - 1) / kCh, kCh * kWarps, 0, stream>>>(
      part_a, part_b, R, C, kChunk, out_a, out_b);
  return cudaGetLastError();
}

}  // namespace
}  // namespace stat_reduce
