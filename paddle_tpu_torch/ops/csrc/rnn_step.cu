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
// a step is 0.27 GFLOP (2 * 128 * 512 * 2048), 1.6 us as three TF32
// products at 495 TFLOP/s (4.0 us of float32 FMAs), against ~6.3 MB, 1.9
// us of bytes; at the NMT encoder's GRU (B 256, H 512) 0.40 GFLOP, 2.4 us
// as three TF32 products (6.0 us of FMAs), against ~5.6 MB, 1.7 us of
// bytes.  Both are too small to fill the card at full rate, so the designs
// aim at parallelism first.
//
// Both run on the tensor cores as split TF32 (mma_tf32.cuh): every product
// a . b is three mma.sync m16n8k8 TF32 products, lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b, of the operands' splits x = hi + lo, accumulated in float32,
// within 3 * 2^-22 of |a||b| (ops/fused_rnn.py::_tf32x3_lstm_step and
// ::_tf32x3_gru_step are this arithmetic in plain torch).  One product
// tile serves both (copy_a_panel, split_w_panel, panel_product, publish,
// fold):
// - A block of 8 warps owns 128 batch rows x 64 product columns, each warp
//   32 x 32.  Its W panel, [K range, 64], is read from memory once,
//   split once into TF32 hi and lo planes and kept in shared memory for the
//   block's whole run, transposed to [n][k] (B fragments by ldmatrix); the
//   A operand's panel (h, or r h: 128 rows of the split's at most 128
//   columns) is copied by cp.async, all of it in flight while the W panel
//   is read and split, and is split in registers as it is read.  Each
//   16-deep half slice's products go into fresh registers, added to the
//   running sums in float32 (the tensor cores round each product's sum
//   toward zero).
// - W is read and split once for every 128 batch rows (once a call at the
//   LSTM route's B 128, twice at the GRU's B 256), where the CUDA-core
//   kernels before (16-row tiles) read it eight or sixteen times.
// - The tiles are few (32 for the LSTM and the GRU's gates, 16 for its
//   candidate), so K is split across blocks: at most kGMaxSlices slices a
//   split (the W panel's shared memory), as few splits as that allows (each
//   split more is more partial sums to write and fold: on the H100 more,
//   shorter splits were slower), 4 at H 512: 128 blocks (the candidate's
//   64).  Each block writes its tile's partial sums to scratch, fences, and
//   adds one to the tile's arrival counter; the block that arrives last
//   adds the partials in split order (a fixed order: the same result on
//   every run, with no float atomics and no block waiting for another),
//   applies the gate math and puts the counter back to 0 for the next
//   launch.  That last block's tail is most of a launch's time beside the
//   products, so it walks the tile in row order, 16 bytes a thread a load
//   and a store, each round's operands loaded at once before its math.
// - Ragged edges (B not a multiple of 128, H not a multiple of the tile's
//   units or slices) read zeros and skip their writes, so any B and H
//   launch; W, the copy width of A, of the W panel and of the last block's
//   tail, is 4 floats (16-byte copies, loads and stores: H a multiple of 4,
//   h, c, the weights and b aligned, x aligned to 4 of its elements) or 1.
//
// LSTM (lstm_tf32_kernel<X, M, W>): one launch a call.  A tile's 64
// columns are the four gates of kLU = 16 hidden units (u0..u0 + 15, W's
// columns gate * H + u: LstmCols), so the block that folds a tile holds
// every gate of its units and finishes c' and h' itself; W's gathered
// columns are runs of 16 units, so the 16-byte copies stay.  At B 128, H
// 512: 32 tiles x 4 splits, 128 blocks (32 units x 8 splits, the same
// count with an eighth of K a block, was slower on the H100: its last
// blocks fold four times the partials, twice the columns from twice the
// splits).
// GRU (gru_tf32_kernel<kPhase, X, M, W>): the candidate's product needs the
// whole r h row, so one wrapper call is two launches of the same kernel:
// phase 0 takes the [B, 2H] product h W_g and writes z and r h to scratch
// ([B, H] each), phase 1 the [B, H] product (r h) W_c and blends; 64
// product columns a tile.
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
// float32 ones.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"
#include "mma_tf32.cuh"

namespace {

using mma::copy_or_zero;
using mma::static_for;

constexpr int kGBM = 128;          // batch rows a block
constexpr int kGBN = 64;           // product columns a block
constexpr int kLU = kGBN / 4;      // the LSTM's hidden units a block
constexpr int kGBK = 32;           // depth of a slice
constexpr int kGThreads = 256;     // 8 warps: 4 along the rows x 2 columns
constexpr int kGMaxSlices = 4;     // slices a split of K takes at most
constexpr int kGPS = kGMaxSlices * kGBK + 4;   // padded row of A and planes
// The depth of a fresh fragment of products.  The tensor cores round each
// mma.sync's sum toward zero, so a fragment's error grows with its chain
// of mmas.  On the H100, kept over a whole 32-deep slice it put the LSTM
// route's first layer 1.6 times as far from the plain route's (a mean of
// 6.1e-9 against 3.8e-9) for 1% less time, and the bf16 route's first
// loss 1.3e-4 from the plain route's, past chip_smoke.py's 1e-4; 8 deep
// read 3.2e-9 and took 4% more time (PERF.md, row 5).
constexpr int kFrag = 16;
static_assert(kGPS % 32 == 4,
              "ldmatrix's eight rows fall in distinct bank groups");

// A block's dynamic shared memory: the A panel [kGBM][kGPS], then the W
// panel's planes hi and lo, [kGBN][kGPS] each.
constexpr size_t kGSmem = sizeof(float) * (kGBM + 2 * kGBN) * kGPS;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

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

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Column maps of a tile: tile column n -> the column of W it takes, or -1
// outside W.  Both map each run of 4 columns from a multiple of 4 to 4
// adjacent columns of W, all inside W or none when H is a multiple of 4.
struct GruCols {            // columns c0.. of a product N wide
  int c0, N;
  __device__ int operator()(int n) const { return c0 + n < N ? c0 + n : -1; }
};
struct LstmCols {           // n -> gate n / kLU of unit u0 + n % kLU
  int u0, H;
  __device__ int operator()(int n) const {
    const int u = u0 + n % kLU;
    return u < H ? n / kLU * H + u : -1;
  }
};

// The A panel: rows m0..m0 + 127 of a ([rows, K], row-major) and the
// split's columns k0..k0 + 32 ns - 1 into smem ([kGBM][kGPS]), zeros
// outside a, every copy in flight at once as one cp.async group (a split is
// at most kGMaxSlices slices, so no stage is reused): a thread copies
// columns ac..ac+W-1 of a slice's rows ar + j kRStep.
template <int W>
__device__ __forceinline__ void copy_a_panel(float* smem,
                                             const float* __restrict__ a,
                                             int rows, int K, int m0, int k0,
                                             int ns) {
  constexpr int kCpr = kGBK / W;
  constexpr int kRStep = kGThreads / kCpr;
  constexpr int kNR = kGBM / kRStep;
  const int ar = threadIdx.x / kCpr, ac = (threadIdx.x % kCpr) * W;
  for (int sl = 0; sl < ns; ++sl) {
    const int k = k0 + sl * kGBK + ac;
    const uint32_t dst = mma::smem_u32(smem + ar * kGPS + sl * kGBK + ac);
    static_for<kNR>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      const int row = m0 + ar + j * kRStep;
      const bool ok = row < rows && k < K;
      copy_or_zero<W * 4, j * kRStep * kGPS * 4>(
          dst, ok ? a + ((long long)row * K + k) : a, ok);
    });
  }
  mma::cp_async_commit();
}

// The W panel: rows k0..k0 + rows - 1 (below K) of W's columns cols(0),
// ..., cols(63) (W row-major, ldw floats a row; zeros outside W),
// split into the planes (row n, column k - k0), every load of a thread in
// flight at once.  At W 4 lane (2 k + q) of a warp reads 16 bytes, the
// q-th run of 4 columns of a pair in row k (sixteen 32-byte runs a warp),
// and its plane stores (4 (4q + u) + k mod 32, for its u-th column) fall in
// distinct banks; at W 1 lane (4 n + k) reads one float (four 32-byte
// runs), stores at 4 n + k mod 32.
template <int W, typename Cols>
__device__ __forceinline__ void split_w_panel(float* p_hi, float* p_lo,
                                              const float* __restrict__ w,
                                              int ldw, int K, int k0,
                                              int rows, Cols cols) {
  const int tid = threadIdx.x;
  if constexpr (W == 4) {
    constexpr int kPairs = kGBN / 8;    // pairs of 4-column runs a row
    constexpr int kLd = kGMaxSlices * kGBK * kGBN / 4 / kGThreads;
    float4 v[kLd];
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = tid + i * kGThreads, blk = e >> 5, ln = e & 31;
      const int kk = blk / kPairs * 16 + (ln >> 1);
      const int c = cols((blk % kPairs * 2 + (ln & 1)) * 4);
      v[i] = kk < rows && k0 + kk < K && c >= 0
                 ? __ldg(reinterpret_cast<const float4*>(
                       w + (long long)(k0 + kk) * ldw + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = tid + i * kGThreads, blk = e >> 5, ln = e & 31;
      const int kk = blk / kPairs * 16 + (ln >> 1);
      const int n = (blk % kPairs * 2 + (ln & 1)) * 4;
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
    constexpr int kGroups = kGBN / 8;   // groups of 8 columns
    constexpr int kLd = kGMaxSlices * kGBK * kGBN / kGThreads;
    float v[kLd];
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = tid + i * kGThreads, blk = e >> 5, ln = e & 31;
      const int n = blk % kGroups * 8 + (ln >> 2);
      const int kk = blk / kGroups * 4 + (ln & 3);
      const int k = k0 + kk, c = cols(n);
      v[i] = kk < rows && k < K && c >= 0 ? __ldg(w + (long long)k * ldw + c)
                                          : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = tid + i * kGThreads, blk = e >> 5, ln = e & 31;
      const int n = blk % kGroups * 8 + (ln >> 2);
      const int kk = blk / kGroups * 4 + (ln & 3);
      if (kk >= rows) continue;
      uint32_t hi, lo;
      tf32::split(v[i], hi, lo);
      p_hi[n * kGPS + kk] = __uint_as_float(hi);
      p_lo[n * kGPS + kk] = __uint_as_float(lo);
    }
  }
}

// acc = the A panel times the W planes over the split's ns slices, warp
// (wm, wn) = (warp % 4, warp / 4) its rows 32 wm + 16 i + g (+ 8) and
// columns 32 wn + 8 n + 2t (+ 1) of the tile: A fragments by ldmatrix,
// split as read, and the W planes' two n-tiles an ldmatrix.  Each
// kFrag-deep part of a slice's products goes into a fresh fragment, added
// to acc in float32 (the tensor cores round each mma's sum toward zero).
__device__ __forceinline__ void panel_product(float (&acc)[2][4][4],
                                              const float* smem,
                                              const float* p_hi,
                                              const float* p_lo, int ns) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a_off = (warp & 3) * 32 * kGPS + tf32::a_lane<kGPS>(lane);
  const int b_off = (warp >> 2) * 32 * kGPS + tf32::b_lane<kGPS>(lane);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  for (int it = 0; it < ns; ++it) {
#pragma unroll
    for (int hh = 0; hh < kGBK / kFrag; ++hh) {
      float fr[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) fr[i][n][e] = 0.f;
#pragma unroll
      for (int k8 = 0; k8 < kFrag / 8; ++k8) {
        const int kk = hh * (kFrag / 8) + k8;
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
  }
}

// This lane's sums (panel_product's rows and columns) to the block's share
// of the partials, part[split = blockIdx.y][tile = blockIdx.x][kGBM][kGBN],
// then one arrival at the tile's counter.  True in the block that arrives
// last: every split's partials of the tile are in, and the counter is back
// to 0 for the next launch.
__device__ __forceinline__ bool publish(float* part,
                                        const float (&acc)[2][4][4],
                                        unsigned* arrived) {
  __shared__ bool s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x;
  float* mine =
      part + ((long long)blockIdx.y * gridDim.x + tile) * kGBM * kGBN;
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
    s_last = atomicAdd(arrived + tile, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  if (tid == 0) arrived[tile] = 0u;
  return true;
}

// sum[e] = the float4 q[e] of the tile's partials, added over the splits in
// split order (the same result on every run): tile_part is split 0's
// partials of the tile as float4s, `step` the float4s from one split's
// partials to the next's.
template <int N>
__device__ __forceinline__ void fold(float (&sum)[N][4],
                                     const float4* tile_part, long long step,
                                     int splits, const int (&q)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e)
#pragma unroll
    for (int u = 0; u < 4; ++u) sum[e][u] = 0.f;
  for (int j = 0; j < splits; ++j) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float4 p = __ldcg(tile_part + j * step + q[e]);
      sum[e][0] += p.x;
      sum[e][1] += p.y;
      sum[e][2] += p.z;
      sum[e][3] += p.w;
    }
  }
}

// ---------------------------------------------------------- kernel 5, LSTM
// Block (tile, split): tile = row tile * n_col_tiles + unit tile, the unit
// tile's kLU units u0.. and its 64 product columns (LstmCols), K's slices
// [split sps, (split + 1) sps); the partial sums go through part
// ([split][tile][kGBM][kGBN] floats) and arrived (one zeroed counter a
// tile).
template <typename X, typename M, int W>
__global__ void __launch_bounds__(kGThreads, 1)
lstm_tf32_kernel(const X* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ w,
                 const float* __restrict__ b, const M* __restrict__ m,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 float* __restrict__ part, unsigned* __restrict__ arrived,
                 int B, int H, int n_col_tiles, int sps) {
  static_assert(W == 4 || W == 1, "16-byte copies or one float");
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* p_hi = smem + kGBM * kGPS;
  float* p_lo = p_hi + kGBN * kGPS;
  const int tile = blockIdx.x, splits = gridDim.y;
  const int m0 = tile / n_col_tiles * kGBM, u0 = tile % n_col_tiles * kLU;
  const int tid = threadIdx.x;
  const int n_slices = (H + kGBK - 1) / kGBK;
  const int s0 = blockIdx.y * sps;
  const int ns = max(0, min(sps, n_slices - s0));   // this split's slices
  const int k0 = s0 * kGBK;

  copy_a_panel<W>(smem, h, B, H, m0, k0, ns);
  split_w_panel<W>(p_hi, p_lo, w, 4 * H, H, k0, ns * kGBK, LstmCols{u0, H});
  float acc[2][4][4];
  mma::cp_async_wait<0>();               // the A panel has landed
  __syncthreads();                       // and the planes are in
  panel_product(acc, smem, p_hi, p_lo, ns);
  if (!publish(part, acc, arrived)) return;

  // the last block to arrive: the tile's output runs (4 units of a row, 16
  // bytes of h' and of c'; kOQ a row) in row order, kEpi a thread, all at
  // once: each run's four gates' partials folded in split order and every
  // operand loaded at once, then the gate math, only inside [B, H].  A
  // thread's units u..u+3 are the same in each of its runs (kGThreads is a
  // multiple of kOQ), so b is read once.  (Capped at 128 registers, two
  // blocks' worth of the register file, this tail ran slower on the H100
  // and spilled at one-float copies; shared memory holds one block an SM
  // anyway.)
  constexpr int kOQ = kLU / 4;
  constexpr int kEpi = kGBM * kOQ / kGThreads;
  const float4* tile_part =
      reinterpret_cast<const float4*>(part) + (long long)tile * kGBM * kGBN / 4;
  const long long step = (long long)gridDim.x * kGBM * kGBN / 4;
  const int uq = tid % kOQ, u = u0 + 4 * uq;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float bv[4][4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if constexpr (W == 4) {
      const float4 bf =
          u < H ? *reinterpret_cast<const float4*>(b + g * H + u) : zero;
      bv[g][0] = bf.x, bv[g][1] = bf.y, bv[g][2] = bf.z, bv[g][3] = bf.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[g][e] = u + e < H ? b[g * H + u + e] : 0.f;
    }
  }
  int q[kEpi * 4];
  float xv[kEpi][4][4], hv[kEpi][4], cv[kEpi][4];
  bool live[kEpi];
#pragma unroll
  for (int r = 0; r < kEpi; ++r) {
    const int tr = (tid + r * kGThreads) / kOQ;   // the tile's row
    const int row = m0 + tr;
    const bool rok = row < B;
#pragma unroll
    for (int g = 0; g < 4; ++g) q[4 * r + g] = tr * (kGBN / 4) + g * kOQ + uq;
    live[r] = rok && to_f(m[row]) > 0.f;
    const X* xr = x + (long long)row * 4 * H;
    const long long at = (long long)row * H + u;
    if constexpr (W == 4) {   // a whole run inside [B, H] or none of it
      const bool ok = rok && u < H;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 xf = ok ? load_x4(xr + g * H + u) : zero;
        xv[r][g][0] = xf.x, xv[r][g][1] = xf.y, xv[r][g][2] = xf.z,
        xv[r][g][3] = xf.w;
      }
      const float4 hf = ok ? *reinterpret_cast<const float4*>(h + at) : zero;
      const float4 cf = ok ? *reinterpret_cast<const float4*>(c + at) : zero;
      hv[r][0] = hf.x, hv[r][1] = hf.y, hv[r][2] = hf.z, hv[r][3] = hf.w;
      cv[r][0] = cf.x, cv[r][1] = cf.y, cv[r][2] = cf.z, cv[r][3] = cf.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = rok && u + e < H;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          xv[r][g][e] = ok ? to_f(xr[g * H + u + e]) : 0.f;
        hv[r][e] = ok ? h[at + e] : 0.f;
        cv[r][e] = ok ? c[at + e] : 0.f;
      }
    }
  }
  float sum[kEpi * 4][4];
  fold(sum, tile_part, step, splits, q);
#pragma unroll
  for (int r = 0; r < kEpi; ++r) {
    const int row = m0 + (tid + r * kGThreads) / kOQ;
    if (row >= B) continue;
    float ho[4], co[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!live[r]) {
        ho[e] = hv[r][e];
        co[e] = cv[r][e];
        continue;
      }
      const float gi = xv[r][0][e] + sum[4 * r][e] + bv[0][e];
      const float gf = xv[r][1][e] + sum[4 * r + 1][e] + bv[1][e];
      const float gc = xv[r][2][e] + sum[4 * r + 2][e] + bv[2][e];
      const float go = xv[r][3][e] + sum[4 * r + 3][e] + bv[3][e];
      co[e] = sigmoid_f(gf) * cv[r][e] + sigmoid_f(gi) * tanhf(gc);
      ho[e] = sigmoid_f(go) * tanhf(co[e]);
    }
    const long long at = (long long)row * H + u;
    if constexpr (W == 4) {
      if (u < H) {
        store4(h_out + at, ho);
        store4(c_out + at, co);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (u + e >= H) continue;
        h_out[at + e] = ho[e];
        c_out[at + e] = co[e];
      }
    }
  }
}

template <typename X, typename M>
const void* lstm_fn(int width) {
  return width == 4 ? (const void*)lstm_tf32_kernel<X, M, 4>
                    : (const void*)lstm_tf32_kernel<X, M, 1>;
}

// One call over `splits` splits of K; `vec` 1 for 16-byte copies.
template <typename X, typename M>
int lstm_launch(const void* x, const void* h, const void* c, const void* w,
                const void* b, const void* m, void* h_out, void* c_out,
                void* part, void* arrived, int B, int H, int vec, int splits,
                void* stream) {
  const int n_col = (H + kLU - 1) / kLU, n_row = (B + kGBM - 1) / kGBM;
  const int n_slices = (H + kGBK - 1) / kGBK;
  const int sps = splits > 0 ? (n_slices + splits - 1) / splits : 0;
  if (sps < 1 || sps > kGMaxSlices) return (int)cudaErrorInvalidValue;
  auto* kernel = vec ? lstm_tf32_kernel<X, M, 4> : lstm_tf32_kernel<X, M, 1>;
  constexpr size_t smem = kGSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_row * n_col, splits), kGThreads, smem,
           (cudaStream_t)stream>>>(
      (const X*)x, (const float*)h, (const float*)c, (const float*)w,
      (const float*)b, (const M*)m, (float*)h_out, (float*)c_out,
      (float*)part, (unsigned*)arrived, B, H, n_col, sps);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- kernel 6, GRU
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
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* p_hi = smem + kGBM * kGPS;
  float* p_lo = p_hi + kGBN * kGPS;
  const int N = kPhase == 0 ? 2 * H : H;    // product columns
  const int tile = blockIdx.x, splits = gridDim.y;
  const int m0 = tile / n_col_tiles * kGBM, c0 = tile % n_col_tiles * kGBN;
  const int tid = threadIdx.x;
  const int n_slices = (H + kGBK - 1) / kGBK;
  const int s0 = blockIdx.y * sps;
  const int ns = max(0, min(sps, n_slices - s0));   // this split's slices
  const int k0 = s0 * kGBK;

  copy_a_panel<W>(smem, a, B, H, m0, k0, ns);
  split_w_panel<W>(p_hi, p_lo, w, N, H, k0, ns * kGBK, GruCols{c0, N});
  float acc[2][4][4];
  mma::cp_async_wait<0>();               // the A panel has landed
  __syncthreads();                       // and the planes are in
  panel_product(acc, smem, p_hi, p_lo, ns);
  if (!publish(part, acc, arrived)) return;

  // the last block to arrive: the tile in row order, 4 columns a thread a
  // group (16 threads a row: 16-byte loads and stores, whole lines), kEpi
  // groups a thread, in two rounds of kEpi / 2.  The partials added in
  // split order, then every operand of a round's groups loaded at once,
  // then the gate math, only inside [B, N]
  constexpr int kEpi = kGBM * kGBN / 4 / kGThreads;
  constexpr int kRound = kEpi / 2;
  const float4* tile_part =
      reinterpret_cast<const float4*>(part) + (long long)tile * kGBM * kGBN / 4;
  const long long step = (long long)gridDim.x * kGBM * kGBN / 4;
  const int xo = kPhase == 0 ? 0 : 2 * H;    // x's and b's column offset
#pragma unroll
  for (int rd = 0; rd < kEpi; rd += kRound) {
    int qs[kRound];
#pragma unroll
    for (int e = 0; e < kRound; ++e) qs[e] = tid + (rd + e) * kGThreads;
    float sum[kRound][4];
    fold(sum, tile_part, step, splits, qs);
    float xv[kRound][4], bv[kRound][4], hv[kRound][4], zv[kRound][4];
    bool live[kRound];
#pragma unroll
    for (int e = 0; e < kRound; ++e) {
      const int q = qs[e];
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
      const int q = qs[e];
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
        if (col < N) store4(dst, out);
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
  constexpr size_t smem = kGSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_row * n_col, splits), kGThreads, smem, st>>>(
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
// The LSTM's scratch: part the split sums ([splits][tiles][128][64]
// floats, a tile 128 rows of 16 hidden units); arrived one zeroed uint32
// counter a tile, left zero.  K (= H) in `splits` splits of at most 4
// slices of 32.  vec 1: H a multiple of 4, h, c, w and b 16-byte aligned,
// x aligned to 4 of its elements.
#define LSTM_ARGS                                                        \
  const void *x, const void *h, const void *c, const void *w,           \
      const void *b, const void *m, void *h_out, void *c_out,           \
      void *part, void *arrived, int B, int H, int vec, int splits,     \
      void *stream
#define LSTM_PASS                                                        \
  x, h, c, w, b, m, h_out, c_out, part, arrived, B, H, vec, splits, stream
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

namespace {
int read_resources(const void* fn, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}
}  // namespace

// Registers and local memory (bytes a thread: stack and spills) of the
// LSTM's float32 instance at copy width `width` (4 or 1 floats).
extern "C" int lstm_tf32_resources(int width, int* regs, int* local_bytes) {
  return read_resources(lstm_fn<float, float>(width), regs, local_bytes);
}

// The same for the GRU's float32 instance of phase `phase` (0: the gates,
// 1: the candidate) at copy width `width`.
extern "C" int gru_tf32_resources(int phase, int width, int* regs,
                                  int* local_bytes) {
  return read_resources(phase == 0 ? gru_fn<0, float, float>(width)
                                   : gru_fn<1, float, float>(width),
                        regs, local_bytes);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
