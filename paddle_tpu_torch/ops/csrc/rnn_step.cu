// One LSTM step and one GRU step, for Hopper (sm_90a): float32, and the
// bf16 and float16 instances the bf16 and fp16 precision policies reach.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/fused_rnn.py::_lstm_kernel
// (launched by _lstm_pallas) and ::_gru_kernel (launched by _gru_pallas).
// Same functions, each computing its own product in float32 (the step must
// agree with its plain version to 1e-4, which TF32 alone, ~3 digits, does
// not):
//
//   LSTM  g = x + h W + b, gates [i, f, c~, o] of H columns each;
//         c' = sig(f) c + sig(i) tanh(c~);  h' = sig(o) tanh(c')
//   GRU   [z, r] = sig(x[:, :2H] + h W_g + b[:2H]);
//         c~ = tanh(x[:, 2H:] + (r h) W_c + b[2H:]);  h' = (1 - z) h + z c~
//
// and a row whose mask is 0 copies its old h (and c) bit for bit.
//
// What bounds them on the H100.  At the LSTM route's shape (B 128, H 512)
// a step is 2 * 128 * 512 * 2048 flops against ~6.3 MB of traffic, 4.0 us
// of float32 FMAs against 1.9 us of bytes; at the NMT encoder's GRU (B
// 256, H 512) 0.40 GFLOP, 6.0 us of FMAs, 2.4 us as three TF32 products at
// 495 TFLOP/s, against ~5.6 MB, 1.7 us of bytes.  Both are too small to
// fill the card at full rate, so the designs aim at parallelism first.
//
// LSTM (lstm_step_kernel), on the CUDA cores' float32 FMAs:
// - tile_product: a block owns a 16-row x 128-column tile of the product
//   and splits its depth over 4 groups of 128 threads (512 a block, 16
//   warps on an SM where a single group would give 4: the warps that hide
//   each other's latency).  A group stages 16-deep slices of h and of the
//   weight columns in its own shared memory, the next slice's loads in
//   flight while the current one is multiplied; each thread accumulates 2
//   rows x 8 columns, and the groups' partial sums meet in shared memory
//   (a fixed order: the result is the same on every run).  W is read from
//   device memory (it stays in the 50 MB L2 from one step to the next, the
//   CUDA side of the TPU kernel's VMEM-resident weights).
// - The gate math is separable per hidden unit, so a block takes 32 units
//   and gathers their four gate columns (u, H+u, 2H+u, 3H+u) into its 128
//   tile columns; a thread then holds all four gates of its 2 units and
//   finishes them in registers.  Grid (H / 32, B / 16): 128 blocks at B
//   128, H 512.
//
// GRU (gru_tf32_kernel<kPhase, X, M, W>), on the tensor cores as split
// TF32 (mma_tf32.cuh): every product a . b is three mma.sync m16n8k8 TF32
// products, lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, of the operands' splits x =
// hi + lo, accumulated in float32, within 3 * 2^-22 of |a||b|
// (ops/fused_rnn.py::_tf32x3_gru_step is this arithmetic in plain torch).
// The candidate's product needs the whole r h row, so one wrapper call is
// two launches of the same kernel: phase 0 takes the [B, 2H] product h W_g
// and writes z and r h to scratch ([B, H] each), phase 1 the [B, H]
// product (r h) W_c and blends.  Each:
// - A block of 8 warps owns 128 batch rows x 64 product columns, each warp
//   32 x 32 (conv_bn.cu's float32 tile).  Its W panel, [K range, 64], is
//   read from memory once, split once into TF32 hi and lo planes and kept
//   in shared memory for the block's whole run, transposed to [n][k] (B
//   fragments by ldmatrix); the A operand's panel (h, or r h: 128 rows
//   of the split's at most 128 columns) is copied by cp.async, all of it
//   in flight while the W panel is read and split, and is split in
//   registers as it is read.  Each 32-deep slice's products go into fresh
//   registers, added to the running sums in float32 (the tensor cores
//   round each product's sum toward zero).
// - W is read and split once for every 128 batch rows: at B 256, H 512
//   twice a call, 6 MB of L2 reads, where the CUDA-core pair (16-row tiles)
//   read its 3 MB sixteen times, 48 MB; A is read once for each 64 product
//   columns, 24 times, 12 MB (the pair: 12 times, 6 MB); and the split
//   sums below write and read 12 MB: 30 MB a call against 54.
// - The tiles are few (32 for the gates, 16 for the candidate at B 256), so
//   K is split across blocks: at most kGMaxSlices slices a split (the W
//   panel's shared memory), as few splits as that allows (each split more
//   is more partial sums to write and fold: on the H100 more, shorter
//   splits were slower), 4 at H 512: 128 and 64 blocks.  Each block writes
//   its tile's partial sums to scratch, fences, and adds one to the tile's
//   arrival counter; the block that arrives last adds the partials in
//   split order (a fixed order: the same result on every run, with no
//   float atomics and no block waiting for another), applies the gate math
//   and puts the counter back to 0 for the next launch.  That last block's
//   tail is most of a launch's time beside the products, so it walks the
//   tile in row order, 16 bytes a thread a load and a store, each round's
//   operands loaded at once before its math.
// - Ragged edges (B not a multiple of 128, H not a multiple of 32 or 64)
//   read zeros and skip their writes, so any B and H launch; W, the copy
//   width of A, of the W panel and of the last block's tail, is 4 floats
//   (16-byte copies, loads and stores: H a multiple of 4, h, the weights,
//   b and x aligned) or 1.
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
// operand; the outputs follow h and are float32.  The products read h (or
// r h) and W only, so the 16-bit instances run the same products as the
// float32 ones; lstm_step_kernel's float32 instance is the code before the
// templates.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"
#include "mma_tf32.cuh"

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

// ------------------------------------------ kernel 6, tensor cores (3xTF32)
using mma::copy_or_zero;
using mma::static_for;

constexpr int kGBM = 128;          // batch rows a block
constexpr int kGBN = 64;           // product columns a block
constexpr int kGBK = 32;           // depth of a slice
constexpr int kGThreads = 256;     // 8 warps: 4 along the rows x 2 columns
constexpr int kGMaxSlices = 4;     // slices a split of K takes at most
constexpr int kGPS = kGMaxSlices * kGBK + 4;   // padded row of A and planes
constexpr size_t kGSmem = sizeof(float) * (kGBM + 2 * kGBN) * kGPS;
static_assert(kGPS % 32 == 4,
              "ldmatrix's eight rows fall in distinct bank groups");

// Four consecutive x elements (16 bytes of float32, 8 of a 16-bit type) as
// floats.
__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p) {
  return load4(p);
}
__device__ __forceinline__ float4 load_x4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Phase 0: the gates' product a W (a = h [B, H], w = W_g [H, 2H]), then
// z = sig(x[:, :H] + . + b[:H]) and r h = sig(x[:, H:2H] + . + b[H:2H]) h
// into z and rh; phase 1: the candidate's (a = rh, w = W_c [H, H]), then
// h_out = h where the mask is 0, else (1 - z) h + z tanh(x[:, 2H:] + . +
// b[2H:]).  Block (tile, split): tile = row tile * n_col_tiles + column
// tile, K's slices [split sps, (split + 1) sps); the partial sums go
// through part ([split][tile][kGBM][kGBN] floats) and arrived (one zeroed
// counter a tile).
template <int kPhase, typename X, typename M, int W>
__global__ void __launch_bounds__(kGThreads, 1)
gru_tf32_kernel(const X* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ a, const float* __restrict__ w,
                const float* __restrict__ b, const M* __restrict__ m,
                float* __restrict__ z, float* __restrict__ rh,
                float* __restrict__ h_out, float* __restrict__ part,
                unsigned* __restrict__ arrived, int B, int H, int n_col_tiles,
                int sps) {
  static_assert(W == 4 || W == 1, "16-byte copies or one float");
  // the A panel [kGBM][kGPS]; the W panel's planes hi, lo [kGBN][kGPS]
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* p_hi = smem + kGBM * kGPS;
  float* p_lo = p_hi + kGBN * kGPS;
  __shared__ bool s_last;
  const int N = kPhase == 0 ? 2 * H : H;    // product columns
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int m0 = tile / n_col_tiles * kGBM, c0 = tile % n_col_tiles * kGBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int n_slices = (H + kGBK - 1) / kGBK;
  const int s0 = split * sps;
  const int ns = max(0, min(sps, n_slices - s0));   // this split's slices
  const int k0 = s0 * kGBK;

  // the A panel, rows m0.. and the split's columns k0..k0 + 32 ns - 1,
  // every copy in flight at once (a split is at most kGMaxSlices slices,
  // so no stage is reused): a thread copies columns ac..ac+W-1 of a slice's
  // rows ar + j kRStep
  constexpr int kCpr = kGBK / W;
  constexpr int kRStep = kGThreads / kCpr;
  constexpr int kNR = kGBM / kRStep;
  const int ar = tid / kCpr, ac = (tid % kCpr) * W;
  for (int sl = 0; sl < ns; ++sl) {
    const int k = k0 + sl * kGBK + ac;
    const uint32_t dst = mma::smem_u32(smem + ar * kGPS + sl * kGBK + ac);
    static_for<kNR>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      const int row = m0 + ar + j * kRStep;
      const bool ok = row < B && k < H;
      copy_or_zero<W * 4, j * kRStep * kGPS * 4>(
          dst, ok ? a + ((long long)row * H + k) : a, ok);
    });
  }
  mma::cp_async_commit();

  // the W panel, rows k0..k0 + 32 ns - 1 and columns c0..c0 + 63 (zeros
  // outside W), split into the planes (row n, column k) while the A panel
  // lands, every load of a thread in flight at once.  At W 4
  // lane (2 k + q) of a warp reads 16 bytes, columns 4q..4q+3 of row k
  // (sixteen 32-byte runs a warp), and its plane stores (4 (4q + u) + k
  // mod 32, for its u-th column) fall in distinct banks; at W 1 lane (4 n
  // + k) reads one float (four 32-byte runs), stores at 4 n + k mod 32
  const int rows = ns * kGBK;
  if constexpr (W == 4) {
    constexpr int kLd = kGMaxSlices * kGBK * kGBN / 4 / kGThreads;
    float4 v[kLd];
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = tid + i * kGThreads, blk = e >> 5, ln = e & 31;
      const int kk = (blk >> 3) * 16 + (ln >> 1);
      const int c = c0 + ((blk & 7) * 2 + (ln & 1)) * 4;
      v[i] = kk < rows && k0 + kk < H && c < N
                 ? __ldg(reinterpret_cast<const float4*>(
                       w + (long long)(k0 + kk) * N + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = tid + i * kGThreads, blk = e >> 5, ln = e & 31;
      const int kk = (blk >> 3) * 16 + (ln >> 1);
      const int n = ((blk & 7) * 2 + (ln & 1)) * 4;
      if (kk >= rows) continue;
      const float f[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t hi, lo;
        tf32::split(f[u], hi, lo);
        p_hi[(n + u) * kGPS + kk] = __uint_as_float(hi);
        p_lo[(n + u) * kGPS + kk] = __uint_as_float(lo);
      }
    }
  } else {
    constexpr int kLd = kGMaxSlices * kGBK * kGBN / kGThreads;
    float v[kLd];
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = tid + i * kGThreads, blk = e >> 5, ln = e & 31;
      const int n = (blk & 7) * 8 + (ln >> 2), kk = (blk >> 3) * 4 + (ln & 3);
      const int k = k0 + kk, c = c0 + n;
      v[i] = kk < rows && k < H && c < N ? __ldg(w + (long long)k * N + c)
                                         : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = tid + i * kGThreads, blk = e >> 5, ln = e & 31;
      const int n = (blk & 7) * 8 + (ln >> 2), kk = (blk >> 3) * 4 + (ln & 3);
      if (kk >= rows) continue;
      uint32_t hi, lo;
      tf32::split(v[i], hi, lo);
      p_hi[n * kGPS + kk] = __uint_as_float(hi);
      p_lo[n * kGPS + kk] = __uint_as_float(lo);
    }
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  // fragment corners: the warp's A rows (ldmatrix, split as read) and its
  // 32 columns of the W planes (ldmatrix, two n-tiles a call)
  const int a_off = wm * 32 * kGPS + tf32::a_lane<kGPS>(lane);
  const int b_off = wn * 32 * kGPS + tf32::b_lane<kGPS>(lane);
  mma::cp_async_wait<0>();               // the A panel has landed
  __syncthreads();                       // and the planes are in
  for (int it = 0; it < ns; ++it) {
    float fr[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) fr[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kGBK / 8; ++kk) {
      tf32::SplitB bw[4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int o = b_off + np * 16 * kGPS + it * kGBK + kk * 8;
        tf32::SplitB two[2];
        tf32::load_b2(two, p_hi + o, p_lo + o);
        bw[2 * np] = two[0];
        bw[2 * np + 1] = two[1];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tf32::SplitA af;
        tf32::load_a(af, smem + a_off + i * 16 * kGPS + it * kGBK + kk * 8);
#pragma unroll
        for (int n = 0; n < 4; ++n) tf32::mma3(fr[i][n], af, bw[n]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += fr[i][n][e];
  }

  // this lane's sums (rows 32 wm + 16 i + g (+ 8), columns 32 wn + 8 n +
  // 2t (+ 1) of the tile) to the tile's partials, [split][tile][kGBM][kGBN]
  const long long tile_sz = kGBM * kGBN;
  float* mine = part + ((long long)split * gridDim.x + tile) * tile_sz;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<float2*>(
            mine + (wm * 32 + i * 16 + g + 8 * half) * kGBN + wn * 32 +
            n * 8 + 2 * t) =
            make_float2(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(arrived + tile, 1u) == (unsigned)(splits - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) arrived[tile] = 0u;

  // the last block to arrive: the tile in row order, 4 columns a thread a
  // group (16 threads a row: 16-byte loads and stores, whole lines), kEpi
  // groups a thread, in two rounds of kEpi / 2.  The partials added in
  // split order, then every operand of a round's groups loaded at once,
  // then the gate math, only inside [B, N]
  constexpr int kEpi = kGBM * kGBN / 4 / kGThreads;
  constexpr int kRound = kEpi / 2;
  const float4* first = reinterpret_cast<const float4*>(
      part + (long long)tile * tile_sz) + tid;
  const long long step = (long long)gridDim.x * tile_sz / 4;
  const int xo = kPhase == 0 ? 0 : 2 * H;    // x's and b's column offset
#pragma unroll
  for (int rd = 0; rd < kEpi; rd += kRound) {
    float sum[kRound][4];
#pragma unroll
    for (int e = 0; e < kRound; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u) sum[e][u] = 0.f;
    for (int j = 0; j < splits; ++j) {
#pragma unroll
      for (int e = 0; e < kRound; ++e) {
        const float4 p = __ldcg(first + j * step + (rd + e) * kGThreads);
        sum[e][0] += p.x;
        sum[e][1] += p.y;
        sum[e][2] += p.z;
        sum[e][3] += p.w;
      }
    }
    float xv[kRound][4], bv[kRound][4], hv[kRound][4], zv[kRound][4];
    bool live[kRound];
#pragma unroll
    for (int e = 0; e < kRound; ++e) {
      const int q = tid + (rd + e) * kGThreads;
      const int row = m0 + (q >> 4), col = c0 + (q & 15) * 4;
      const bool rok = row < B;
      live[e] = kPhase == 1 && rok && to_f(m[row]) > 0.f;
      if constexpr (W == 4) {   // a whole group in [B, N] or none of it
        const bool ok = rok && col < N;
        const long long at = (long long)row * H + col;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 xf =
            ok ? load_x4(x + (long long)row * 3 * H + xo + col) : zero;
        const float4 bf =
            ok ? *reinterpret_cast<const float4*>(b + xo + col) : zero;
        const float4 hf =
            ok && (kPhase == 1 || col >= H)
                ? *reinterpret_cast<const float4*>(h + at - (kPhase ? 0 : H))
                : zero;
        const float4 zf = ok && kPhase == 1
                              ? *reinterpret_cast<const float4*>(z + at)
                              : zero;
        xv[e][0] = xf.x, xv[e][1] = xf.y, xv[e][2] = xf.z, xv[e][3] = xf.w;
        bv[e][0] = bf.x, bv[e][1] = bf.y, bv[e][2] = bf.z, bv[e][3] = bf.w;
        hv[e][0] = hf.x, hv[e][1] = hf.y, hv[e][2] = hf.z, hv[e][3] = hf.w;
        zv[e][0] = zf.x, zv[e][1] = zf.y, zv[e][2] = zf.z, zv[e][3] = zf.w;
        continue;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = rok && col + u < N;
        const long long at = (long long)row * H + col + u;
        xv[e][u] = ok ? to_f(x[(long long)row * 3 * H + xo + col + u]) : 0.f;
        bv[e][u] = ok ? b[xo + col + u] : 0.f;
        if constexpr (kPhase == 0) {
          hv[e][u] = ok && col + u >= H ? h[at - H] : 0.f;
        } else {
          hv[e][u] = ok ? h[at] : 0.f;
          zv[e][u] = ok ? z[at] : 0.f;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kRound; ++e) {
      const int q = tid + (rd + e) * kGThreads;
      const int row = m0 + (q >> 4), col = c0 + (q & 15) * 4;
      if (row >= B) continue;
      float out[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (kPhase == 0) {
          const float v = sigmoid_f(xv[e][u] + sum[e][u] + bv[e][u]);
          out[u] = col + u < H ? v : v * hv[e][u];
        } else if (!live[e]) {
          out[u] = hv[e][u];
        } else {
          const float cand = tanhf(xv[e][u] + sum[e][u] + bv[e][u]);
          out[u] = (1.f - zv[e][u]) * hv[e][u] + zv[e][u] * cand;
        }
      }
      // phase 0 writes z's columns (< H) and r h's; phase 1 h_out
      float* dst = kPhase == 1 ? h_out + (long long)row * H + col
                   : col < H   ? z + (long long)row * H + col
                               : rh + (long long)row * H + col - H;
      if constexpr (W == 4) {   // N and H multiples of 4: a whole group
        if (col < N)
          *reinterpret_cast<float4*>(dst) =
              make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (col + u >= N) continue;
          if (kPhase == 0 && col < H && col + u >= H)   // past z: r h's
            rh[(long long)row * H + col + u - H] = out[u];
          else
            dst[u] = out[u];
        }
      }
    }
  }
}

template <int kPhase, typename X, typename M>
const void* gru_fn(int width) {
  return width == 4 ? (const void*)gru_tf32_kernel<kPhase, X, M, 4>
                    : (const void*)gru_tf32_kernel<kPhase, X, M, 1>;
}

// One phase over `splits` splits of K; `vec` 1 for
// 16-byte copies of A and loads of the W panel.
template <int kPhase, typename X, typename M>
int gru_phase(const void* x, const void* h, const void* a, const void* w,
              const void* b, const void* m, void* z, void* rh, void* h_out,
              void* part, void* arrived, int B, int H, int vec, int splits,
              cudaStream_t st) {
  const int N = kPhase == 0 ? 2 * H : H;
  const int n_col = (N + kGBN - 1) / kGBN, n_row = (B + kGBM - 1) / kGBM;
  const int n_slices = (H + kGBK - 1) / kGBK;
  const int sps = splits > 0 ? (n_slices + splits - 1) / splits : 0;
  if (sps < 1 || sps > kGMaxSlices) return (int)cudaErrorInvalidValue;
  auto* kernel = vec ? gru_tf32_kernel<kPhase, X, M, 4>
                     : gru_tf32_kernel<kPhase, X, M, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_row * n_col, splits), kGThreads, kGSmem, st>>>(
      (const X*)x, (const float*)h, (const float*)a, (const float*)w,
      (const float*)b, (const M*)m, (float*)z, (float*)rh, (float*)h_out,
      (float*)part, (unsigned*)arrived, B, H, n_col, sps);
  return (int)cudaGetLastError();
}

template <typename X, typename M>
int gru_launch(const void* x, const void* h, const void* wg, const void* wc,
               const void* b, const void* m, void* z, void* rh, void* h_out,
               void* part, void* arrived, int B, int H, int vec, int splits,
               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  // phase 0 reads no mask (M float stands in) and writes no h_out; phase 1
  // reads r h as its A and writes none
  const int err = gru_phase<0, X, float>(x, h, h, wg, b, m, z, rh, nullptr,
                                         part, arrived, B, H, vec, splits,
                                         st);
  if (err != 0) return err;
  return gru_phase<1, X, M>(x, h, rh, wc, b, m, z, nullptr, h_out, part,
                            arrived, B, H, vec, splits, st);
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
// The GRU's scratch: z and rh [B, H] float32; part the split sums
// ([splits][tiles][128][64] floats for the gates' [B, 2H] tiles); arrived
// one zeroed uint32 counter a tile, left zero.  K (= H) in `splits` splits
// of at most 4 slices of 32.  vec 1: H a multiple of 4, h, wg, wc and b
// 16-byte aligned, x aligned to 4 of its elements.
#define GRU_ARGS                                                         \
  const void *x, const void *h, const void *wg, const void *wc,         \
      const void *b, const void *m, void *z, void *rh, void *h_out,     \
      void *part, void *arrived, int B, int H, int vec, int splits,     \
      void *stream
#define GRU_PASS                                                         \
  x, h, wg, wc, b, m, z, rh, h_out, part, arrived, B, H, vec, splits, stream

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

// Registers and local memory (bytes a thread: stack and spills) of the
// GRU's float32 instance of phase `phase` (0: the gates, 1: the candidate)
// at copy width `width` (4 or 1 floats).
extern "C" int gru_tf32_resources(int phase, int width, int* regs,
                                  int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, phase == 0 ? gru_fn<0, float, float>(width)
                        : gru_fn<1, float, float>(width));
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
