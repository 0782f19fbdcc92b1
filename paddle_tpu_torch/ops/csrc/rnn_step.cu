// One LSTM step and one GRU step, for Hopper (sm_90a): float32, and the
// bf16 and float16 instances the bf16 and fp16 precision policies reach.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/fused_rnn.py::_lstm_kernel
// (launched by _lstm_pallas) and ::_gru_kernel (launched by _gru_pallas).
// Same functions, each computing its own product on CUDA cores in full
// float32 (no TF32: the step must agree with its plain version to 1e-4):
//
//   LSTM  g = x + h W + b, gates [i, f, c~, o] of H columns each;
//         c' = sig(f) c + sig(i) tanh(c~);  h' = sig(o) tanh(c')
//   GRU   [z, r] = sig(x[:, :2H] + h W_g + b[:2H]);
//         c~ = tanh(x[:, 2H:] + (r h) W_c + b[2H:]);  h' = (1 - z) h + z c~
//
// and a row whose mask is 0 copies its old h (and c) bit for bit.
//
// What bounds them on the H100: operations.  At the LSTM route's shape
// (B 128, H 512) a step is 2 * 128 * 512 * 2048 flops against ~6.3 MB of
// traffic, 4.0 us of float32 FMAs against 1.9 us of bytes; at the NMT
// encoder's GRU (B 256, H 512) 6.0 us against 1.7 us.  Both are too small
// to fill the card at full rate, so the design aims at parallelism first:
//
// - One tiled product, tile_product, serves all three kernels: a block
//   owns a 16-row x 128-column tile of the product and splits its depth
//   over 4 groups of 128 threads (512 a block, 16 warps on an SM where a
//   single group would give 4: the warps that hide each other's latency).
//   A group stages 16-deep slices of h (or r h) and of the weight columns
//   in its own shared memory, the next slice's loads in flight while the
//   current one is multiplied; each thread accumulates 2 rows x 8
//   columns, and the groups' partial sums meet in shared memory (a fixed
//   order: the result is the same on every run).  W is read from device
//   memory (it stays in the 50 MB L2 from one step to the next, the CUDA
//   side of the TPU kernel's VMEM-resident weights); no kernel stages all
//   of W, which at H 512 is 4 MB (LSTM) or 2 + 1 MB (GRU).
// - LSTM: the gate math is separable per hidden unit, so a block takes 32
//   units and gathers their four gate columns (u, H+u, 2H+u, 3H+u) into
//   its 128 tile columns; a thread then holds all four gates of its 2
//   units and finishes them in registers.  Grid (H / 32, B / 16): 128
//   blocks at B 128, H 512.
// - GRU: the candidate's product needs the whole r h row, so one wrapper
//   call makes two launches: gru_gates_kernel tiles the [B, 2H] product
//   and writes z and r h to scratch ([B, H] each), then gru_cand_kernel
//   tiles the [B, H] candidate product and blends.  Grids (2H / 128,
//   B / 16) and (H / 128, B / 16): 128 and 64 blocks at B 256, H 512.
// - Ragged edges (B not a multiple of 16, H not a multiple of 32 or 128)
//   read zeros and skip their writes, so any B and H launch.
//
// Every operand is a contiguous row-major array; b is read at an offset of
// 2H for the GRU's candidate bias (the TPU wrapper passes it pre-split),
// and the mask is [B] values.  h, c, the weights and the bias are float32;
// x and the mask are float32, bf16 or float16 (template parameters X and
// M), the combinations the JAX package reaches under its bf16 and fp16
// policies: x is an fc output in the compute dtype, the mask float32 from
// an @len feed or in x's dtype when the recurrence makes its own ones.  A
// 16-bit value is read as float where it enters the gate sums, so all
// arithmetic stays float32, as in the Pallas kernels, which upcast every
// operand; the outputs follow h and are float32.  The products read h (or r h) and W
// only, so the 16-bit instances run the same tile_product as the float32
// ones; the float32 instances are the code before the templates.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int kBM = 16;                 // batch rows per tile
constexpr int kBN = 128;                // product columns per tile
constexpr int kBK = 16;                 // depth a group stages per pass
constexpr int kTileThreads = 128;       // the threads of one tile's sums
constexpr int kKG = 4;                  // groups splitting the depth
constexpr int kThreads = kTileThreads * kKG;
constexpr int kTX = 16;                 // threads across the columns
constexpr int kTY = kTileThreads / kTX; // 8 across the rows
constexpr int kTM = kBM / kTY;          // 2 rows a thread
constexpr int kTN = kBN / kTX;          // 8 columns a thread, kTX apart
constexpr int kAL = kBM * kBK / kTileThreads;  // elements of A a thread
constexpr int kAR = kTileThreads / kBK;        // rows of A a pass covers
constexpr int kUnits = kBN / 4;         // LSTM: hidden units per block

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// Column maps: tile column jj -> column of W, or -1 outside the matrix.
struct LstmCols {           // jj -> gate jj / kUnits, unit u0 + jj % kUnits
  int u0, H;
  __device__ int operator()(int jj) const {
    const int u = u0 + jj % kUnits;
    return u < H ? (jj / kUnits) * H + u : -1;
  }
};

struct SpanCols {           // jj -> c0 + jj
  int c0, n;
  __device__ int operator()(int jj) const {
    return c0 + jj < n ? c0 + jj : -1;
  }
};

// Load the kBK-deep slice at k0 that this thread stages: rows k0..k0+kBK-1
// of W's column wcol (-1: outside W) and kAL elements of A, zeros outside.
__device__ __forceinline__ void load_slice(const float* __restrict__ A,
                                           int rows, int row0, int ar,
                                           int akk,
                                           const float* __restrict__ W,
                                           int ldw, int K, int wcol, int k0,
                                           float (&a_st)[kAL],
                                           float (&w_st)[kBK]) {
#pragma unroll
  for (int e = 0; e < kBK; ++e) {
    const int k = k0 + e;
    w_st[e] = (k < K && wcol >= 0) ? W[(long long)k * ldw + wcol] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < kAL; ++e) {
    const int row = row0 + ar + kAR * e, k = k0 + akk;
    a_st[e] = (row < rows && k < K) ? A[(long long)row * K + k] : 0.f;
  }
}

// tile_product's shared memory: each group's staged slices while the
// groups multiply, then groups 1..kKG-1's partial sums (36.25 KB).
union TileSmem {
  struct {
    float As[kKG][kBK][kBM + 1];
    float Ws[kKG][kBK][kBN];
  } st;
  float red[kKG - 1][kTM * kTN][kTileThreads];
};

// acc[i][j] = sum_k A[row0 + ty * kTM + i][k] * W[k][cols(tx + kTX * j)]
// for A [rows, K] and W [K, ldw], both row-major.  The block's kKG groups
// of kTileThreads threads split the depth: group g takes the slices
// k0 = (p * kKG + g) * kBK, each loaded into registers while the group
// multiplies the previous one out of its own shared memory; then groups
// 1..kKG-1 hand their sums to group 0 through shared memory.  Returns
// true for group 0's threads, which hold the full sums (the others may
// return from the kernel: no barrier follows).  Within a group, thread t
// always stages tile column t of W (a warp reads 32 neighbouring columns
// of one row) and kAL elements of A.
template <typename Cols>
__device__ __forceinline__ bool tile_product(const float* __restrict__ A,
                                             int rows, int row0,
                                             const float* __restrict__ W,
                                             int ldw, int K, Cols cols,
                                             float (&acc)[kTM][kTN]) {
  static_assert(kTileThreads == kBN, "a thread stages one column of W");
  __shared__ TileSmem sm;
  const int g = threadIdx.x / kTileThreads, t = threadIdx.x % kTileThreads;
  const int tx = t % kTX, ty = t / kTX;
  const int wcol = cols(t), akk = t % kBK, ar = t / kBK;
  const int passes = (K + kKG * kBK - 1) / (kKG * kBK);
  float a_st[kAL], w_st[kBK];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  load_slice(A, rows, row0, ar, akk, W, ldw, K, wcol, g * kBK, a_st, w_st);
  for (int p = 0; p < passes; ++p) {
#pragma unroll
    for (int e = 0; e < kBK; ++e) sm.st.Ws[g][e][t] = w_st[e];
#pragma unroll
    for (int e = 0; e < kAL; ++e) sm.st.As[g][akk][ar + kAR * e] = a_st[e];
    __syncthreads();
    if (p + 1 < passes)
      load_slice(A, rows, row0, ar, akk, W, ldw, K, wcol,
                 ((p + 1) * kKG + g) * kBK, a_st, w_st);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], w[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = sm.st.As[g][kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) w[j] = sm.st.Ws[g][kk][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (g > 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) sm.red[g - 1][i * kTN + j][t] = acc[i][j];
  }
  __syncthreads();
  if (g > 0) return false;
#pragma unroll
  for (int q = 0; q < kKG - 1; ++q)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] += sm.red[q][i * kTN + j][t];
  return true;
}

template <typename X, typename M>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const X* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ w,
                 const float* __restrict__ b, const M* __restrict__ m,
                 float* __restrict__ h_out, float* __restrict__ c_out, int B,
                 int H) {
  const int row0 = blockIdx.y * kBM, u0 = blockIdx.x * kUnits;
  float acc[kTM][kTN];
  if (!tile_product(h, B, row0, w, 4 * H, H, LstmCols{u0, H}, acc))
    return;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  constexpr int kQ = kTN / 4;           // units a thread finishes
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty * kTM + i;
    if (row >= B) continue;
    const bool live = to_f(m[row]) > 0.f;
    const X* xr = x + (long long)row * 4 * H;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      // thread column j = g * kQ + q is tile column kUnits * g + kTX * q
      // + tx: gate g of unit u
      const int u = u0 + kTX * q + tx;
      if (u >= H) continue;
      const long long at = (long long)row * H + u;
      const float hv = h[at], cv = c[at];
      if (!live) {
        h_out[at] = hv;
        c_out[at] = cv;
        continue;
      }
      const float gi = to_f(xr[u]) + acc[i][q] + b[u];
      const float gf = to_f(xr[H + u]) + acc[i][kQ + q] + b[H + u];
      const float gc =
          to_f(xr[2 * H + u]) + acc[i][2 * kQ + q] + b[2 * H + u];
      const float go =
          to_f(xr[3 * H + u]) + acc[i][3 * kQ + q] + b[3 * H + u];
      const float c_new = sigmoid_f(gf) * cv + sigmoid_f(gi) * tanhf(gc);
      h_out[at] = sigmoid_f(go) * tanhf(c_new);
      c_out[at] = c_new;
    }
  }
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
gru_gates_kernel(const X* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ wg, const float* __restrict__ b,
                 float* __restrict__ z, float* __restrict__ rh, int B,
                 int H) {
  const int row0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
  if (!tile_product(h, B, row0, wg, 2 * H, H, SpanCols{c0, 2 * H}, acc))
    return;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty * kTM + i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = c0 + tx + kTX * j;
      if (col >= 2 * H) continue;
      const float v = sigmoid_f(to_f(x[(long long)row * 3 * H + col]) +
                                acc[i][j] + b[col]);
      if (col < H) {
        z[(long long)row * H + col] = v;
      } else {
        const long long at = (long long)row * H + (col - H);
        rh[at] = v * h[at];
      }
    }
  }
}

template <typename X, typename M>
__global__ void __launch_bounds__(kThreads)
gru_cand_kernel(const X* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ z, const float* __restrict__ rh,
                const float* __restrict__ wc, const float* __restrict__ b,
                const M* __restrict__ m, float* __restrict__ h_out,
                int B, int H) {
  const int row0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
  if (!tile_product(rh, B, row0, wc, H, H, SpanCols{c0, H}, acc))
    return;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty * kTM + i;
    if (row >= B) continue;
    const bool live = to_f(m[row]) > 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int u = c0 + tx + kTX * j;
      if (u >= H) continue;
      const long long at = (long long)row * H + u;
      const float hv = h[at];
      if (!live) {
        h_out[at] = hv;
        continue;
      }
      const float cand = tanhf(to_f(x[(long long)row * 3 * H + 2 * H + u]) +
                               acc[i][j] + b[2 * H + u]);
      const float zv = z[at];
      h_out[at] = (1.f - zv) * hv + zv * cand;
    }
  }
}

template <typename X, typename M>
int lstm_launch(const void* x, const void* h, const void* c, const void* w,
                const void* b, const void* m, void* h_out, void* c_out,
                int B, int H, void* stream) {
  dim3 grid((H + kUnits - 1) / kUnits, (B + kBM - 1) / kBM);
  lstm_step_kernel<X, M><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const X*)x, (const float*)h, (const float*)c, (const float*)w,
      (const float*)b, (const M*)m, (float*)h_out, (float*)c_out, B, H);
  return (int)cudaGetLastError();
}

template <typename X, typename M>
int gru_launch(const void* x, const void* h, const void* wg, const void* wc,
               const void* b, const void* m, void* z, void* rh, void* h_out,
               int B, int H, void* stream) {
  const int rows = (B + kBM - 1) / kBM;
  gru_gates_kernel<X><<<dim3((2 * H + kBN - 1) / kBN, rows), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const X*)x, (const float*)h, (const float*)wg, (const float*)b,
      (float*)z, (float*)rh, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gru_cand_kernel<X, M><<<dim3((H + kBN - 1) / kBN, rows), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const X*)x, (const float*)h, (const float*)z, (const float*)rh,
      (const float*)wc, (const float*)b, (const M*)m, (float*)h_out, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per instance: x and the mask float32 (f32), x bf16 with a
// float32 mask (bf16), both bf16 (bf16_mbf16), x float16 with a float32
// mask (f16), both float16 (f16_mf16).
#define LSTM_ARGS                                                        \
  const void *x, const void *h, const void *c, const void *w,           \
      const void *b, const void *m, void *h_out, void *c_out, int B,    \
      int H, void *stream
#define LSTM_PASS x, h, c, w, b, m, h_out, c_out, B, H, stream
#define GRU_ARGS                                                         \
  const void *x, const void *h, const void *wg, const void *wc,         \
      const void *b, const void *m, void *z, void *rh, void *h_out,     \
      int B, int H, void *stream
#define GRU_PASS x, h, wg, wc, b, m, z, rh, h_out, B, H, stream

extern "C" int lstm_step_f32(LSTM_ARGS) {
  return lstm_launch<float, float>(LSTM_PASS);
}
extern "C" int lstm_step_bf16(LSTM_ARGS) {
  return lstm_launch<__nv_bfloat16, float>(LSTM_PASS);
}
extern "C" int lstm_step_bf16_mbf16(LSTM_ARGS) {
  return lstm_launch<__nv_bfloat16, __nv_bfloat16>(LSTM_PASS);
}
extern "C" int lstm_step_f16(LSTM_ARGS) {
  return lstm_launch<__half, float>(LSTM_PASS);
}
extern "C" int lstm_step_f16_mf16(LSTM_ARGS) {
  return lstm_launch<__half, __half>(LSTM_PASS);
}
extern "C" int gru_step_f32(GRU_ARGS) {
  return gru_launch<float, float>(GRU_PASS);
}
extern "C" int gru_step_bf16(GRU_ARGS) {
  return gru_launch<__nv_bfloat16, float>(GRU_PASS);
}
extern "C" int gru_step_bf16_mbf16(GRU_ARGS) {
  return gru_launch<__nv_bfloat16, __nv_bfloat16>(GRU_PASS);
}
extern "C" int gru_step_f16(GRU_ARGS) {
  return gru_launch<__half, float>(GRU_PASS);
}
extern "C" int gru_step_f16_mf16(GRU_ARGS) {
  return gru_launch<__half, __half>(GRU_PASS);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
