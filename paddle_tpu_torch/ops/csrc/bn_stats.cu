// Batch-norm statistic passes for Hopper (sm_90a): float32 instances and
// the bf16 and float16 instances the bf16 and fp16 precision policies
// reach.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/fused_bn.py:
//   kernel 7a  _fwd_stats (_fwd4_kernel, _fwd2_kernel): per channel, sum x
//              and sum x^2 in one pass over x;
//   kernel 7b  _bwd_stats (_bwd4_kernel, _bwd2_kernel, _bwd_body): per
//              channel, sum dy and sum dy * xhat in one pass over (dout, x),
//              with dy = relu'(x * w + b) * dout (or dout, linear) and
//              xhat = (x - mean) * inv recomputed in the kernel from
//              per-channel w, b, mean and inv, so the post-BN tensor and
//              the relu mask are never stored.
// Any [..., C] tensor is a row-major [P, C] matrix here, so one kernel
// serves the TPU's rank-4 and rank-2 variants.
//
// What bounds them on the H100: bytes.  At the stem BN of ResNet-50 (batch
// 128, [128, 112, 112, 64]) 7a reads 411 MB (0.123 ms at 3.35 TB/s) and 7b
// 822 MB (0.245 ms) for ~2 flops a byte.  The design aims at full-rate,
// coalesced reads and a result that is the same on every run:
//
// - The TPU kernels add into one output block along a sequential grid; on
//   the H100 blocks run in parallel, so each block writes its partial sums
//   to [R, C] scratch and a second small launch (stat_reduce.cuh) adds the
//   R rows in a fixed order.  No float atomics.
// - A block owns 32 channels (a warp's lanes read 128 consecutive bytes of
//   a row) and a slab of rows; its 8 warps take every 8th row of the slab,
//   four rows in flight a thread, and meet in shared memory in warp order.
//   The wrapper picks R so that ~1000 blocks cover the card.
// - Rows past P are never read: a slab ends at P.
// - 7b's relu mask must keep exactly the elements the forward kept.  The
//   forward folds x * w + b as two PyTorch ops, rounding twice; nvcc would
//   contract the same expression into one FMA, which rounds once and can
//   disagree in sign where the fold lies within a rounding of 0.  So the
//   fold is __fmul_rn then __fadd_rn, bit-equal to the forward.
//
// Operand types (template parameter T, the activation type of x and dout):
// float32, and bf16 or float16 for both, the combinations the JAX
// package's kernels meet in a bf16 or fp16 ResNet step (x and dout 16-bit;
// w, b, mean and inv float32 per channel).  A 16-bit element is converted
// to float as it is loaded and
// every sum is float32, as in the Pallas kernels, which upcast x and dout;
// the partials and their fixed-order finish are the float32 instances'.
// At bf16 the mask is the JAX package's fold in x's own dtype: w and b
// rounded to bf16, the product rounded to bf16 (a product of two bf16
// values is exact in float32, so that is one correct rounding), then the
// sum rounded to bf16, then compared with 0.  xhat stays float32, as in
// the Pallas kernel.  At float16 the mask is the fold as XLA evaluates it
// in the JAX package's jitted steps: w and b rounded to f16, then x * w + b
// as one float32 multiply-add (the product of two f16 values is exact in
// float32) rounded once to f16, where its CPU backend contracts the two
// ops (bf16 it rounds op by op; ops/fused_bn.py::_fold does the same).
// The float32 instances are the code before the templates.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "dtype.cuh"
#include "stat_reduce.cuh"

namespace {

constexpr int kCh = 32;                 // channels a block owns
constexpr int kRowLanes = 8;            // warps, each on every 8th row
constexpr int kThreads = kCh * kRowLanes;
constexpr int kUnroll = 4;              // rows in flight a thread

// v rounded to T (bf16 or f16) and back to float.
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, __half) {
  return __half2float(__float2half_rn(v));
}

// A per-channel scalar as the fold in T uses it: itself at float32,
// rounded to T at bf16 or f16 (the JAX fold casts w and b to x's dtype).
template <typename T>
__device__ __forceinline__ float in_t(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else
    return round_to(v, T{});
}

// The forward's fold x * w + b, rounded as the forward rounds it: two
// float32 roundings; at bf16 each op's result rounded to bf16; at f16 the
// float32 sum of the exact product and b, rounded once to f16 (w and b
// come in already rounded, in_t).
template <typename T>
__device__ __forceinline__ float fold(float xv, float w, float b) {
  if constexpr (std::is_same_v<T, float>) {
    return __fadd_rn(__fmul_rn(xv, w), b);
  } else if constexpr (std::is_same_v<T, __half>) {
    return round_to(__fadd_rn(__fmul_rn(xv, w), b), T{});
  } else {
    const float p = round_to(__fmul_rn(xv, w), T{});
    return round_to(__fadd_rn(p, b), T{});
  }
}

// The block's per-warp sums of (a, b) met in warp order and written as row
// blockIdx.y of the partials.
__device__ __forceinline__ void write_partials(float a, float b, int lane,
                                               int wy, int c, int C,
                                               float* __restrict__ part_a,
                                               float* __restrict__ part_b) {
  __shared__ float red[2][kRowLanes][kCh];
  red[0][wy][lane] = a;
  red[1][wy][lane] = b;
  __syncthreads();
  if (wy == 0 && c < C) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < kRowLanes; ++i) {
      ta += red[0][i][lane];
      tb += red[1][i][lane];
    }
    part_a[(long long)blockIdx.y * C + c] = ta;
    part_b[(long long)blockIdx.y * C + c] = tb;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_partial_kernel(const T* __restrict__ x, long long P, int C,
                   long long slab, float* __restrict__ part_s,
                   float* __restrict__ part_sq) {
  const int lane = threadIdx.x % kCh, wy = threadIdx.x / kCh;
  const int c = blockIdx.x * kCh + lane;
  const long long r0 = (long long)blockIdx.y * slab;
  const long long r1 = r0 + slab < P ? r0 + slab : P;
  float s = 0.f, sq = 0.f;
  if (c < C) {
    long long r = r0 + wy;
    for (; r + (kUnroll - 1) * kRowLanes < r1; r += kUnroll * kRowLanes) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = to_f(x[(r + u * kRowLanes) * C + c]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s += v[u];
        sq = fmaf(v[u], v[u], sq);
      }
    }
    for (; r < r1; r += kRowLanes) {
      const float v = to_f(x[r * C + c]);
      s += v;
      sq = fmaf(v, v, sq);
    }
  }
  write_partials(s, sq, lane, wy, c, C, part_s, part_sq);
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bwd_partial_kernel(const T* __restrict__ dout,
                   const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b,
                   const float* __restrict__ mean,
                   const float* __restrict__ inv, long long P, int C,
                   long long slab, float* __restrict__ part_dy,
                   float* __restrict__ part_dyx) {
  const int lane = threadIdx.x % kCh, wy = threadIdx.x / kCh;
  const int c = blockIdx.x * kCh + lane;
  const long long r0 = (long long)blockIdx.y * slab;
  const long long r1 = r0 + slab < P ? r0 + slab : P;
  float sdy = 0.f, sdyx = 0.f;
  if (c < C) {
    const float wc = in_t<T>(w[c]), bc = in_t<T>(b[c]), mc = mean[c],
                ic = inv[c];
    auto add = [&](float xv, float dv) {
      // the forward's fold, rounded as the forward rounds it
      const float dy = (!kRelu || fold<T>(xv, wc, bc) > 0.f) ? dv : 0.f;
      sdy += dy;
      sdyx = fmaf(dy, __fmul_rn(__fsub_rn(xv, mc), ic), sdyx);
    };
    long long r = r0 + wy;
    for (; r + (kUnroll - 1) * kRowLanes < r1; r += kUnroll * kRowLanes) {
      float xv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xv[u] = to_f(x[(r + u * kRowLanes) * C + c]);
        dv[u] = to_f(dout[(r + u * kRowLanes) * C + c]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(xv[u], dv[u]);
    }
    for (; r < r1; r += kRowLanes)
      add(to_f(x[r * C + c]), to_f(dout[r * C + c]));
  }
  write_partials(sdy, sdyx, lane, wy, c, C, part_dy, part_dyx);
}

template <typename T>
int fwd_stats(const void* x, long long P, int C, int R, long long slab,
              void* part, void* s, void* sq, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  float* pa = (float*)part;
  float* pb = pa + (long long)R * C;
  fwd_partial_kernel<T><<<dim3((C + kCh - 1) / kCh, R), kThreads, 0, st>>>(
      (const T*)x, P, C, slab, pa, pb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)stat_reduce::finish(pa, pb, R, C, (float*)s, (float*)sq, st);
}

template <typename T>
int bwd_stats(const void* dout, const void* x, const void* w, const void* b,
              const void* mean, const void* inv, long long P, int C,
              int relu, int R, long long slab, void* part, void* sum_dy,
              void* sum_dyx, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  float* pa = (float*)part;
  float* pb = pa + (long long)R * C;
  const dim3 grid((C + kCh - 1) / kCh, R);
  if (relu)
    bwd_partial_kernel<T, true><<<grid, kThreads, 0, st>>>(
        (const T*)dout, (const T*)x, (const float*)w, (const float*)b,
        (const float*)mean, (const float*)inv, P, C, slab, pa, pb);
  else
    bwd_partial_kernel<T, false><<<grid, kThreads, 0, st>>>(
        (const T*)dout, (const T*)x, (const float*)w, (const float*)b,
        (const float*)mean, (const float*)inv, P, C, slab, pa, pb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)stat_reduce::finish(pa, pb, R, C, (float*)sum_dy,
                                  (float*)sum_dyx, st);
}

}  // namespace

// One C entry per instance: x (and dout) float32 (f32), bf16 (bf16) or
// float16 (f16).
// x [P, C]; partials [2, R, C] scratch; s, sq [C].  R slabs of `slab` rows
// cover P (the wrapper picks both).
#define FWD_ARGS                                                         \
  const void *x, long long P, int C, int R, long long slab, void *part,  \
      void *s, void *sq, void *stream
#define FWD_PASS x, P, C, R, slab, part, s, sq, stream
extern "C" int bn_fwd_stats_f32(FWD_ARGS) {
  return fwd_stats<float>(FWD_PASS);
}
extern "C" int bn_fwd_stats_bf16(FWD_ARGS) {
  return fwd_stats<__nv_bfloat16>(FWD_PASS);
}
extern "C" int bn_fwd_stats_f16(FWD_ARGS) {
  return fwd_stats<__half>(FWD_PASS);
}

// dout, x [P, C]; w, b, mean, inv [C] float32; relu 0 or 1; partials
// [2, R, C]; sum_dy, sum_dyx [C].
#define BWD_ARGS                                                           \
  const void *dout, const void *x, const void *w, const void *b,           \
      const void *mean, const void *inv, long long P, int C, int relu,     \
      int R, long long slab, void *part, void *sum_dy, void *sum_dyx,      \
      void *stream
#define BWD_PASS \
  dout, x, w, b, mean, inv, P, C, relu, R, slab, part, sum_dy, sum_dyx, stream
extern "C" int bn_bwd_stats_f32(BWD_ARGS) {
  return bwd_stats<float>(BWD_PASS);
}
extern "C" int bn_bwd_stats_bf16(BWD_ARGS) {
  return bwd_stats<__nv_bfloat16>(BWD_PASS);
}
extern "C" int bn_bwd_stats_f16(BWD_ARGS) {
  return bwd_stats<__half>(BWD_PASS);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
