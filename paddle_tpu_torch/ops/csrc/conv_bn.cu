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
// kernels exist to remove.  Kernel 9 is an implicit GEMM over
// K = 9 Ci (k = (dh * 3 + dw) * Ci + ci, which is the HWIO kernel's own
// row-major order), whose A operand is gathered from x as it is staged:
// each row of A is an output pixel, and a tap that falls outside the
// image reads zeros.  There is no tile constraint on H or W (the TPU
// kernel needed its h-tile to divide H and fetched clamped halo rows).
// Statistics, every instance: each block writes one row of [R, Co]
// partial sums (R = ceil(P / 128): a block owns 128 output pixels) taken
// from the float32 accumulators in a fixed order, and a second small
// launch (stat_reduce.cuh) adds the R rows in a fixed order.  No float
// atomics: the statistics are the same on every run.  Rows of A past P
// (or pixels outside the image) and columns of W past Co load zeros, so
// they add nothing to the statistics; y is written only inside [P, Co].
//
// What bounds them on the H100: operations, at float32.  ResNet-50's res2
// expand ([401408, 64] x [64, 256]) is 13.2 GFLOP against 0.27 GB (0.196
// ms of float32 FMAs at 67 TFLOP/s against 0.080 ms of bytes); its res2
// 3x3 ([128, 56, 56, 64] -> 64) 29.6 GFLOP.  At bf16 on the tensor cores
// (989 TFLOP/s) the res2 3x3 at batch 256 is bound by its bytes: 59.2
// GFLOP (0.060 ms) against x and y, 0.21 GB (0.061 ms).
//
// The SIMT tile (gemm_stats_kernel): kernel 8 at float32 and bf16,
// kernel 9 at float32.  The products run in full float32 on the CUDA
// cores (no TF32: y must agree with its plain version to 1e-4 of its
// scale).  A block owns a 128 x 128 tile of y (output pixels x output
// channels) and walks K in slices of 8: each slice of A (transposed,
// padded against bank conflicts) and of W is staged in shared memory, the
// next slice's loads in flight in registers while the current one is
// multiplied (two buffers, one barrier a slice).  256 threads each hold
// 8 x 8 sums; each sums its 8 rows per column and the 16 threads of a
// column meet in shared memory.  Where Ci and Co are multiples of 4 the
// loads and the y stores are vectors (16 bytes of float32, 8 of bf16);
// otherwise scalar.  Kernel 8's bf16 instance converts each element to
// float as it is staged and runs float32 FMAs: a product of two bf16
// values is exact in float32, so this is the MXU's arithmetic; y is
// rounded to bf16 once, at its store.  Its tensor-core instance is later
// work; the float32 instances are the code before the templates.
//
// Kernel 9 at bf16 (conv3x3_mma_stats_kernel<W>), on the tensor cores.
// The JAX kernel computes y in float32 from bf16 operands; mma.sync
// m16n8k16 bf16 -> float32 computes the same, up to the order of the
// sums, and the statistics come from the same unrounded accumulators.
// A block of 8 warps owns 128 pixels x 64 channels of y (so Co = 64, all
// of res2, wastes nothing; ResNet-50's Co are multiples of 64), each warp
// 32 x 32.  K is walked a tap at a time in slices of 32 input channels:
// a slice of A, [128 pixels, 32 channels of one tap], is gathered by
// cp.async straight from x's NHWC rows (a pixel's 32 channels are
// contiguous), the matching [32, 64] slice of W by cp.async, both into
// shared memory with rows padded by 16 bytes (ldmatrix's eight row
// addresses fall in distinct banks); three stages, two slices in flight
// while one is multiplied, one barrier a slice.  A fragments come by
// ldmatrix, B fragments by ldmatrix.trans.  W, the copy width, is 8
// elements (16 bytes; Ci and Co multiples of 8, operands 16-byte
// aligned), 4 (8 bytes; multiples of 4) or 1 (plain loads and stores),
// as the wrapper chooses; a tap's channels past Ci and columns past Co
// are zero-filled.  Epilogue: y rounded to bf16 once and stored as bf16
// pairs; each column's sum and sum of squares over the thread's 4 rows,
// then over the 8 lanes that share the column (shuffles), then over the
// 4 warps along the pixels in shared memory, in a fixed order.  Each
// slice's products accumulate on the tensor cores into fresh registers,
// which join the running sums in float32 adds: the tensor cores' own
// accumulation, run through all of K, moved the statistics by a bias that
// grew with K, past the plain version's spread at res5 (K = 4608).  wgmma
// with TMA im2col is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "dtype.cuh"
#include "mma_bf16.cuh"
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

// ------------------------------------------ kernel 9 at bf16, tensor cores
using mma::bf16;

constexpr int kMmaBM = 128;     // output pixels a block: R = ceil(P / 128)
constexpr int kMmaBN = 64;      // output channels a block
constexpr int kMmaBK = 32;      // input channels of one tap a slice
constexpr int kMmaThreads = 256;   // 8 warps: 4 along pixels x 2 channels
constexpr int kStages = 3;
constexpr int kAS = kMmaBK + 8;    // padded row of an A slice (bf16)
constexpr int kBS = kMmaBN + 8;    // padded row of a W slice
constexpr int kStageElems = kMmaBM * kAS + kMmaBK * kBS;
static_assert(kMmaBM == kBM, "the partial statistics keep R = ceil(P / 128)");

// y [M, Co] and the per-column partial statistics of this block's rows
// (row blockIdx.x / n_col_tiles of part_s and part_ss) for the 3x3 SAME
// conv of x [N, H, Wd, Ci] (M = N H Wd pixels) with w [3, 3, Ci, Co], W
// elements a copy.
template <int W>
__global__ void __launch_bounds__(kMmaThreads, 2)
conv3x3_mma_stats_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w, int M, int H, int Wd,
                         int Ci, int Co, int n_col_tiles,
                         bf16* __restrict__ y, float* __restrict__ part_s,
                         float* __restrict__ part_ss) {
  __shared__ __align__(16) bf16 smem[kStages * kStageElems];
  __shared__ float red[2][4][kMmaBN];
  const int rt = blockIdx.x / n_col_tiles, ct = blockIdx.x % n_col_tiles;
  const int m0 = rt * kMmaBM, c0 = ct * kMmaBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int cpt = (Ci + kMmaBK - 1) / kMmaBK;    // slices a tap
  const int n_slices = 9 * cpt;

  // A: a thread copies channels ac..ac+W-1 of rows tid / kCpr + j kRStep;
  // each row's pixel index (-1 past M) and (h << 16 | w), kept for W 8
  // and 4, recomputed for W 1
  constexpr int kCpr = kMmaBK / W;
  constexpr int kRStep = kMmaThreads / kCpr;
  constexpr int kNR = kMmaBM / kRStep;
  constexpr bool kKeep = W > 1;
  const int ac = (tid % kCpr) * W;
  int pix[kKeep ? kNR : 1], phw[kKeep ? kNR : 1];
  auto pixel = [&](int r, int& m, int& hw) {
    m = m0 + r;
    if (m >= M) {
      m = -1;
      hw = 0;
      return;
    }
    const int ww = m % Wd, hh = (m / Wd) % H;
    hw = (hh << 16) | ww;
  };
  if constexpr (kKeep) {
#pragma unroll
    for (int j = 0; j < kNR; ++j) pixel(tid / kCpr + j * kRStep, pix[j], phw[j]);
  }
  // W: a thread copies columns of rows idx / kBCpr, idx = tid + j threads
  constexpr int kBCpr = kMmaBN / W;
  constexpr int kBIters = kMmaBK * kBCpr / kMmaThreads;

  auto load_slice = [&](int sl, int st) {
    const int tap = sl / cpt, cb = (sl - tap * cpt) * kMmaBK;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    bf16* sA = smem + st * kStageElems;
    bf16* sB = sA + kMmaBM * kAS;
    const int ci = cb + ac;
#pragma unroll
    for (int j = 0; j < kNR; ++j) {
      const int r = tid / kCpr + j * kRStep;
      int m, hw;
      if constexpr (kKeep) {
        m = pix[j];
        hw = phw[j];
      } else {
        pixel(r, m, hw);
      }
      const int hh = (hw >> 16) + dh, ww = (hw & 0xffff) + dw;
      const bool ok = m >= 0 && ci < Ci && (unsigned)hh < (unsigned)H &&
                      (unsigned)ww < (unsigned)Wd;
      const bf16* src = x + ((long long)m + dh * Wd + dw) * Ci + ci;
      bf16* dst = sA + r * kAS + ac;
      if constexpr (W == 8) {
        if (ok) mma::cp_async16(dst, src);
        else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else if constexpr (W == 4) {
        if (ok) mma::cp_async8(dst, src);
        else *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      } else {
        *dst = ok ? *src : __float2bfloat16_rn(0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < kBIters; ++j) {
      const int idx = tid + j * kMmaThreads;
      const int kk = idx / kBCpr, cc = idx % kBCpr * W;
      const bool ok = cb + kk < Ci && c0 + cc < Co;
      const bf16* src = w + ((long long)tap * Ci + cb + kk) * Co + c0 + cc;
      bf16* dst = sB + kk * kBS + cc;
      if constexpr (W == 8) {
        if (ok) mma::cp_async16(dst, src);
        else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else if constexpr (W == 4) {
        if (ok) mma::cp_async8(dst, src);
        else *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      } else {
        *dst = ok ? *src : __float2bfloat16_rn(0.f);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < n_slices) load_slice(sl, sl);
    mma::cp_async_commit();
  }
  for (int it = 0; it < n_slices; ++it) {
    mma::cp_async_wait<kStages - 2>();   // slice it has landed
    __syncthreads();                     // and every warp is done with it-1
    if (it + kStages - 1 < n_slices)
      load_slice(it + kStages - 1, (it + kStages - 1) % kStages);
    mma::cp_async_commit();
    const bf16* sA = smem + (it % kStages) * kStageElems;
    const bf16* sB = sA + kMmaBM * kAS;
    float sl_acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sl_acc[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma::ldmatrix_x4(af[i], sA + (wm * 32 + i * 16 + (lane & 15)) * kAS
                                    + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        mma::ldmatrix_x4_trans(bfr[jp], sB + (kk * 16 + (lane & 15)) * kBS
                                            + wn * 32 + jp * 16
                                            + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma::mma_bf16(sl_acc[i][2 * jp], af[i], bfr[jp][0], bfr[jp][1]);
          mma::mma_bf16(sl_acc[i][2 * jp + 1], af[i], bfr[jp][2],
                        bfr[jp][3]);
        }
    }
    // the slice's sums join the running ones in float32 adds: run through
    // all of K, the tensor cores' own accumulation moved the statistics
    // by a bias that grew with K (on the H100, up to 1.2e-6 of their
    // scale at res2, 7.5e-6 at res5)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += sl_acc[i][n][e];
  }
  mma::cp_async_wait<0>();               // no copy outlives the block

  // y: rows m0 + 32 wm + 16 i + g (+ 8), columns c0 + 32 wn + 8 n + 2t (+ 1)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * half;
      if (m >= M) continue;
      bf16* yr = y + (long long)m * Co;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = c0 + wn * 32 + n * 8 + 2 * t;
        const float a = acc[i][n][2 * half], b = acc[i][n][2 * half + 1];
        if constexpr (W > 1) {         // Co even: c < Co puts c + 1 inside
          if (c < Co)
            *reinterpret_cast<uint32_t*>(yr + c) = mma::pack_bf16(a, b);
        } else {
          if (c < Co) yr[c] = __float2bfloat16_rn(a);
          if (c + 1 < Co) yr[c + 1] = __float2bfloat16_rn(b);
        }
      }
    }

  // statistics: the thread's 4 rows of each of its 8 columns, then the 8
  // lanes of a column (xor 4, 8, 16), then the 4 warps along the pixels
  // in wm order (rows past M and columns past Co hold zeros)
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v = acc[i][n][2 * half + par];
          s += v;
          ss = fmaf(v, v, ss);
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (g == 0) {
        const int col = wn * 32 + n * 8 + 2 * t + par;
        red[0][wm][col] = s;
        red[1][wm][col] = ss;
      }
    }
  __syncthreads();
  if (tid < kMmaBN && c0 + tid < Co) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s += red[0][r][tid];
      ss += red[1][r][tid];
    }
    part_s[(long long)rt * Co + c0 + tid] = s;
    part_ss[(long long)rt * Co + c0 + tid] = ss;
  }
}

template <int W>
int conv3x3_mma_launch(const void* x, const void* w, int N, int H, int Wd,
                       int Ci, int Co, void* y, void* part, void* s,
                       void* ss, cudaStream_t st) {
  const int M = N * H * Wd;
  const int n_row = (M + kMmaBM - 1) / kMmaBM;
  const int n_col = (Co + kMmaBN - 1) / kMmaBN;
  float* pa = (float*)part;
  float* pb = pa + (long long)n_row * Co;
  conv3x3_mma_stats_kernel<W><<<n_row * n_col, kMmaThreads, 0, st>>>(
      (const bf16*)x, (const bf16*)w, M, H, Wd, Ci, Co, n_col, (bf16*)y, pa,
      pb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)stat_reduce::finish(pa, pb, n_row, Co, (float*)s, (float*)ss,
                                  st);
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
// The bf16 instance runs on the tensor cores; `vec` is its copy width:
// 2 for 16 bytes, 1 for 8, 0 for one element.
extern "C" int conv3x3_stats_bf16(C3_ARGS) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec == 2)
    return conv3x3_mma_launch<8>(x, w, N, H, W, Ci, Co, y, part, s, ss, st);
  if (vec == 1)
    return conv3x3_mma_launch<4>(x, w, N, H, W, Ci, Co, y, part, s, ss, st);
  return conv3x3_mma_launch<1>(x, w, N, H, W, Ci, Co, y, part, s, ss, st);
}

// Registers and local memory (bytes a thread: stack and spills) of the
// bf16 tensor-core kernel 9 at copy width `width` (8, 4 or 1 elements).
extern "C" int conv3x3_mma_resources(int width, int* regs,
                                     int* local_bytes) {
  const void* fn =
      width == 8 ? (const void*)conv3x3_mma_stats_kernel<8>
      : width == 4 ? (const void*)conv3x3_mma_stats_kernel<4>
                   : (const void*)conv3x3_mma_stats_kernel<1>;
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
