// The second pass of every per-channel statistic in ops/csrc: per-block
// partial sums [R, C] (two of them) reduced over R into [C], in a fixed
// order, so that a statistic is the same on every run (no float atomics).
//
// Used by bn_stats.cu (kernels 7a and 7b) and conv_bn.cu (the epilogues of
// kernels 8 and 9).  A block owns 32 channels; its 8 warps take every 8th
// row of the partials, and their sums meet in shared memory in warp order.
// R is at most a few thousand, so this pass moves a few MB at most.

#pragma once

#include <cuda_runtime.h>

namespace stat_reduce {
namespace {

constexpr int kCh = 32;     // channels a block owns, one a lane
constexpr int kWarps = 8;   // warps splitting the rows of the partials

__global__ void __launch_bounds__(kCh * kWarps)
finish_kernel(const float* __restrict__ part_a,
              const float* __restrict__ part_b, int R, int C,
              float* __restrict__ out_a, float* __restrict__ out_b) {
  __shared__ float red[2][kWarps][kCh];
  const int lane = threadIdx.x % kCh, wy = threadIdx.x / kCh;
  const int c = blockIdx.x * kCh + lane;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int r = wy; r < R; r += kWarps) {
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

// Launch the second pass; returns the launch's CUDA error.
inline cudaError_t finish(const float* part_a, const float* part_b, int R,
                          int C, float* out_a, float* out_b,
                          cudaStream_t stream) {
  finish_kernel<<<(C + kCh - 1) / kCh, kCh * kWarps, 0, stream>>>(
      part_a, part_b, R, C, out_a, out_b);
  return cudaGetLastError();
}

}  // namespace
}  // namespace stat_reduce
