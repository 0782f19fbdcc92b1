// Convolution with the batch-norm statistics in its epilogue, for Hopper
// (sm_90a): float32 instances, and the bf16 instances the bf16 precision
// policy reaches.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/conv_bn.py:
//   kernel 8  matmul_stats_fwd (_matmul_stats_kernel): y = x W over
//             x [P, Ci], W [Ci, Co] (a 1x1 stride-1 NHWC conv), with the
//             per-column sum y and sum y^2 taken while y is in registers;
//   kernel 9  conv3x3_stats_fwd (_conv3x3_stats_kernel): the 3x3 stride-1
//             SAME NHWC conv with an HWIO kernel, same epilogue.
// The statistics cost no second pass over y: that pass is what the TPU
// kernels exist to remove.
//
// What bounds them on the H100: operations.  ResNet-50's res2 expand
// ([401408, 64] x [64, 256]) is 13.2 GFLOP against 0.27 GB (0.196 ms of
// float32 FMAs at 67 TFLOP/s against 0.080 ms of bytes); its res2 3x3
// ([128, 56, 56, 64] -> 64) 29.6 GFLOP.  The products run in full float32
// on the CUDA cores (no TF32: y must agree with its plain version to 1e-4
// of its scale), so the design is a SIMT tiled product:
//
// - One kernel template serves both: kernel 9 is an implicit GEMM over
//   K = 9 Ci (k = (dh * 3 + dw) * Ci + ci, which is the HWIO kernel's own
//   row-major order), whose A operand is gathered from x as it is staged:
//   each row of A is an output pixel, and a tap that falls outside the
//   image reads zeros.  There is no tile constraint on H or W (the TPU
//   kernel needed its h-tile to divide H and fetched clamped halo rows).
// - A block owns a 128 x 128 tile of y (output pixels x output channels)
//   and walks K in slices of 8: each slice of A (transposed, padded
//   against bank conflicts) and of W is staged in shared memory, the next
//   slice's loads in flight in registers while the current one is
//   multiplied (two buffers, one barrier a slice).  256 threads each hold
//   8 x 8 sums.  Where Ci and Co are multiples of 4 the loads and the y
//   stores are 16-byte vectors; otherwise scalar.
// - Ragged edges: rows of A past P (or pixels outside the image) and
//   columns of W past Co load zeros, so they add nothing to the
//   statistics; y is written only inside [P, Co].
// - Statistics: each thread sums its 8 rows per column, the 16 threads of
//   a column meet in shared memory in a fixed order, and the block writes
//   one row of [R, Co] partials (R = ceil(P / 128)); a second small launch
//   (stat_reduce.cuh) adds the R rows in a fixed order.  No float atomics:
//   the statistics are the same on every run.
//
// Operand types (template parameter T of the loaders, x's and W's type):
// float32, or bf16 for both, as the JAX package's conv layers cast x and
// the kernel to the compute dtype.  At bf16 an element is converted to
// float as it is staged and every FMA stays float32: a product of two bf16
// values is exact in float32, so this is the MXU's arithmetic (bf16 x bf16
// with float32 accumulation), on the CUDA cores.  The statistics come from
// the float32 accumulators, and y is rounded to bf16 once, at its store.
// The vector path moves 4 elements a load at either type: 16 bytes of
// float32 or 8 of bf16, so at bf16 it needs Ci and Co multiples of 4 and
// 8-byte aligned operands (the wrapper checks).  A tensor-core instance
// (mma.sync bf16 -> f32) is later work; the bound is stated at the float32
// FMA rate these instances use.  The float32 instances are the code before
// the templates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "dtype.cuh"
#include "stat_reduce.cuh"

namespace {

constexpr int kBM = 128;      // output pixels a block
constexpr int kBN = 128;      // output channels a block
constexpr int kBK = 8;        // depth of one staged slice
constexpr int kThreads = 256;
constexpr int kTX = 16;       // threads across the channels
constexpr int kTY = 16;       // threads across the pixels
constexpr int kAPad = 4;      // keeps the transposed A stores conflict-free

struct __align__(16) Smem {
  union {
    struct {
      float A[2][kBK][kBM + kAPad];
      float B[2][kBK][kBN];
    } st;
    float red[2][kTY][kBN];
  };
};

// A = x [P, K] row-major (kernel 8).
template <typename T>
struct DenseA {
  using Elem = T;
  const T* a;
  int M, K;
  struct Row { const T* p; };
  struct Col { int k; };
  __device__ Row row(int m) const {
    return {m < M ? a + (long long)m * K : nullptr};
  }
  __device__ Col col(int k) const { return {k}; }
  __device__ const T* ptr(const Row& r, const Col& c) const {
    return (r.p && c.k < K) ? r.p + c.k : nullptr;
  }
};

// A = the 3x3 SAME patches of x [N, H, W, Ci] (kernel 9): row m is output
// pixel (n, h, w), column k = (dh * 3 + dw) * Ci + ci reads
// x[n, h + dh - 1, w + dw - 1, ci], zero outside the image.
template <typename T>
struct Conv3x3A {
  using Elem = T;
  const T* x;
  int M, K, H, W, Ci;
  struct Row { const T* p; int h, w; };
  struct Col { int ci, dh, dw; bool ok; };
  __device__ Row row(int m) const {
    if (m >= M) return {nullptr, 0, 0};
    const int w = m % W, t = m / W;
    const int h = t % H, n = t / H;
    return {x + (long long)n * H * W * Ci, h, w};
  }
  __device__ Col col(int k) const {
    if (k >= K) return {0, 0, 0, false};
    const int tap = k / Ci, dh = tap / 3;
    return {k - tap * Ci, dh - 1, tap - 3 * dh - 1, true};
  }
  __device__ const T* ptr(const Row& r, const Col& c) const {
    if (!r.p || !c.ok) return nullptr;
    const int hh = r.h + c.dh, ww = r.w + c.dw;
    if ((unsigned)hh >= (unsigned)H || (unsigned)ww >= (unsigned)W)
      return nullptr;
    return r.p + ((long long)hh * W + ww) * Ci + c.ci;
  }
};

// y [M, Co] = A [M, K] B [K, Co], with per-column sum y and sum y^2 of this
// block's rows written to row (tile / n_col_tiles) of part_s and part_ss.
// A, B and y are of the loader's element type T.  kVec: K and Co are
// multiples of 4 and every operand is aligned to 4 elements.
template <class ALoader, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
gemm_stats_kernel(ALoader A, const typename ALoader::Elem* __restrict__ B,
                  int M, int K, int Co, int n_col_tiles,
                  typename ALoader::Elem* __restrict__ y,
                  float* __restrict__ part_s, float* __restrict__ part_ss) {
  using T = typename ALoader::Elem;
  __shared__ Smem sm;
  const int rt = blockIdx.x / n_col_tiles, ct = blockIdx.x % n_col_tiles;
  const int m0 = rt * kBM, c0 = ct * kBN;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;

  // staging: a vector thread loads A[row][k..k+3] of one row and
  // B[k][c..c+3]; a scalar one A[row + 32 e][k] and B[k + 2 e][c], e < 4
  constexpr int kAR = kVec ? 1 : 4;
  const int a_row = kVec ? tid / 2 : tid / kBK;
  const int a_k = kVec ? (tid % 2) * 4 : tid % kBK;
  const int b_k = kVec ? tid / 32 : tid / kBN;
  const int b_c = kVec ? (tid % 32) * 4 : tid % kBN;
  typename ALoader::Row rows[kAR];
#pragma unroll
  for (int e = 0; e < kAR; ++e) rows[e] = A.row(m0 + a_row + 32 * e);
  float a_st[4], b_st[4];

  auto load = [&](int k0) {
    const typename ALoader::Col ac = A.col(k0 + a_k);
    if constexpr (kVec) {
      const T* p = A.ptr(rows[0], ac);
      const float4 v = p ? ldg4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
      a_st[0] = v.x; a_st[1] = v.y; a_st[2] = v.z; a_st[3] = v.w;
      const int k = k0 + b_k, c = c0 + b_c;
      const float4 u = (k < K && c < Co) ? ldg4(B + (long long)k * Co + c)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
      b_st[0] = u.x; b_st[1] = u.y; b_st[2] = u.z; b_st[3] = u.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* p = A.ptr(rows[e], ac);
        a_st[e] = p ? to_f(__ldg(p)) : 0.f;
        const int k = k0 + b_k + 2 * e, c = c0 + b_c;
        b_st[e] = (k < K && c < Co) ? to_f(__ldg(B + (long long)k * Co + c))
                                    : 0.f;
      }
    }
  };
  auto store = [&](int buf) {
    if constexpr (kVec) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sm.st.A[buf][a_k + i][a_row] = a_st[i];
      *reinterpret_cast<float4*>(&sm.st.B[buf][b_k][b_c]) =
          make_float4(b_st[0], b_st[1], b_st[2], b_st[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sm.st.A[buf][a_k][a_row + 32 * e] = a_st[e];
        sm.st.B[buf][b_k + 2 * e][b_c] = b_st[e];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (K + kBK - 1) / kBK;
  load(0);
  for (int t = 0; t < n_k; ++t) {
    const int buf = t & 1;
    store(buf);
    __syncthreads();
    if (t + 1 < n_k) load((t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sm.st.A[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.st.A[buf][kk][64 + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&sm.st.B[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sm.st.B[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // y: thread rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and
  // 64 + tx*4 + j
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    T* yr = y + (long long)m * Co;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + h * 64 + tx * 4;
      if constexpr (kVec && std::is_same_v<T, float>) {
        if (c < Co)
          *reinterpret_cast<float4*>(yr + c) =
              make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                          acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else if constexpr (kVec) {
        if (c < Co) {
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(acc[i][h * 4], acc[i][h * 4 + 1]);
          const __nv_bfloat162 hi =
              __floats2bfloat162_rn(acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
          uint2 u;
          u.x = *reinterpret_cast<const unsigned*>(&lo);
          u.y = *reinterpret_cast<const unsigned*>(&hi);
          *reinterpret_cast<uint2*>(yr + c) = u;
        }
      } else if constexpr (std::is_same_v<T, float>) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < Co) yr[c + j] = acc[i][h * 4 + j];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < Co) yr[c + j] = __float2bfloat16_rn(acc[i][h * 4 + j]);
      }
    }
  }

  // statistics: this thread's 8 rows, then the 16 threads of a column in
  // ty order (rows past M hold zeros)
  __syncthreads();   // the last slice's reads are done; reuse the buffers
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += acc[i][j];
      ss = fmaf(acc[i][j], acc[i][j], ss);
    }
    const int col = (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    sm.red[0][ty][col] = s;
    sm.red[1][ty][col] = ss;
  }
  __syncthreads();
  if (tid < kBN && c0 + tid < Co) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int t = 0; t < kTY; ++t) {
      s += sm.red[0][t][tid];
      ss += sm.red[1][t][tid];
    }
    part_s[(long long)rt * Co + c0 + tid] = s;
    part_ss[(long long)rt * Co + c0 + tid] = ss;
  }
}

template <class ALoader>
int launch(const ALoader& a, const void* w, int M, int K, int Co, int vec,
           void* y, void* part, void* s, void* ss, cudaStream_t st) {
  using T = typename ALoader::Elem;
  const int n_row = (M + kBM - 1) / kBM, n_col = (Co + kBN - 1) / kBN;
  float* pa = (float*)part;
  float* pb = pa + (long long)n_row * Co;
  if (vec)
    gemm_stats_kernel<ALoader, true><<<n_row * n_col, kThreads, 0, st>>>(
        a, (const T*)w, M, K, Co, n_col, (T*)y, pa, pb);
  else
    gemm_stats_kernel<ALoader, false><<<n_row * n_col, kThreads, 0, st>>>(
        a, (const T*)w, M, K, Co, n_col, (T*)y, pa, pb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)stat_reduce::finish(pa, pb, n_row, Co, (float*)s, (float*)ss,
                                  st);
}

template <typename T>
int matmul_stats(const void* x, const void* w, int P, int Ci, int Co,
                 int vec, void* y, void* part, void* s, void* ss,
                 void* stream) {
  const DenseA<T> a{(const T*)x, P, Ci};
  return launch(a, w, P, Ci, Co, vec, y, part, s, ss, (cudaStream_t)stream);
}

template <typename T>
int conv3x3_stats(const void* x, const void* w, int N, int H, int W, int Ci,
                  int Co, int vec, void* y, void* part, void* s, void* ss,
                  void* stream) {
  const int M = N * H * W, K = 9 * Ci;
  const Conv3x3A<T> a{(const T*)x, M, K, H, W, Ci};
  return launch(a, w, M, K, Co, vec, y, part, s, ss, (cudaStream_t)stream);
}

}  // namespace

// One C entry per instance: x and w float32 (f32) or bf16 (bf16); y in
// their type, s and ss float32.
// x [P, Ci], w [Ci, Co] -> y [P, Co], s and ss [Co]; part is [2, R, Co]
// scratch with R = ceil(P / 128).
#define MM_ARGS                                                            \
  const void *x, const void *w, int P, int Ci, int Co, int vec, void *y,   \
      void *part, void *s, void *ss, void *stream
#define MM_PASS x, w, P, Ci, Co, vec, y, part, s, ss, stream
extern "C" int matmul_stats_f32(MM_ARGS) {
  return matmul_stats<float>(MM_PASS);
}
extern "C" int matmul_stats_bf16(MM_ARGS) {
  return matmul_stats<__nv_bfloat16>(MM_PASS);
}

// x [N, H, W, Ci], w [3, 3, Ci, Co] -> y [N, H, W, Co], s and ss [Co];
// part is [2, R, Co] scratch with R = ceil(N H W / 128).
#define C3_ARGS                                                           \
  const void *x, const void *w, int N, int H, int W, int Ci, int Co,      \
      int vec, void *y, void *part, void *s, void *ss, void *stream
#define C3_PASS x, w, N, H, W, Ci, Co, vec, y, part, s, ss, stream
extern "C" int conv3x3_stats_f32(C3_ARGS) {
  return conv3x3_stats<float>(C3_PASS);
}
extern "C" int conv3x3_stats_bf16(C3_ARGS) {
  return conv3x3_stats<__nv_bfloat16>(C3_PASS);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
