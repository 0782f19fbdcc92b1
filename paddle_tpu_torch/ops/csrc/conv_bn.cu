// Convolution with the batch-norm statistics in its epilogue, for Hopper
// (sm_90a): float32 instances, and the bf16 and float16 instances the bf16
// and fp16 precision policies reach.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/conv_bn.py:
//   kernel 8  matmul_stats_fwd (_matmul_stats_kernel): y = x W over
//             x [P, Ci], W [Ci, Co] (a 1x1 stride-1 NHWC conv), with the
//             per-column sum y and sum y^2 taken while y is in registers;
//   kernel 9  conv3x3_stats_fwd (_conv3x3_stats_kernel): the 3x3 stride-1
//             SAME NHWC conv with an HWIO kernel, same epilogue.
// The statistics cost no second pass over y: that pass is what the TPU
// kernels exist to remove.  Both are one implicit GEMM over K = kTaps Ci
// (k = tap * Ci + ci; for kernel 9 tap = dh * 3 + dw, which is the HWIO
// kernel's own row-major order), whose A operand is gathered from x as it
// is staged: each row of A is an output pixel; kernel 8's (kTaps 1) is x's
// own row, kernel 9's (kTaps 9) the pixel's 3x3 patch, a tap outside the
// image reading zeros.  There is no tile constraint on H or W (the TPU
// kernel needed its h-tile to divide H and fetched clamped halo rows).
// Statistics, every instance: each block writes one row of [R, Co]
// partial sums (R = ceil(P / 128): a block owns 128 output pixels) taken
// from the float32 accumulators in a fixed order, and stat_reduce.cuh's
// finish_chunked adds the R rows in a fixed order (runs of 64 rows first,
// so the pass is spread over the card; two launches).  No float atomics:
// the statistics are the same on every run.  Rows of A past P (or pixels
// outside the image) and columns of W past Co load zeros, so they add
// nothing to the statistics; y is written only inside [P, Co].
//
// What bounds them on the H100.  ResNet-50's res2 expand ([401408, 64] x
// [64, 256], batch 128) is 13.2 GFLOP against 0.514 GB at float32 (x 0.103,
// y 0.411: 0.153 ms of bytes): its float32 FMAs at 67 TFLOP/s take 0.196
// ms, three TF32 products at 495 TFLOP/s 0.080 ms, so on the tensor cores
// it is bound by bytes, y 80% of them.  Its res2 3x3 ([128, 56, 56, 64] ->
// 64) is 29.6 GFLOP against 0.21 GB: bound by operations (0.179 ms as
// three TF32 products).  At bf16 (989 TFLOP/s), bytes: the res2 expand at
// batch 256 ([802816, 64] x [64, 256]) is 26.3 GFLOP (0.027 ms) against
// 0.51 GB (0.153 ms), of which y is 0.41 GB; the res2 3x3 59.2 GFLOP
// (0.060 ms) against x and y, 0.21 GB (0.061 ms).
//
// The bf16 and float16 instances (conv_mma_stats_kernel<E, kTaps, W>: E
// the element type, bf16 or f16) run on the tensor cores.  The JAX kernels
// compute y in float32 from bf16 (f16) operands; mma.sync m16n8k16 bf16
// (f16) -> float32 computes the same, up to the order of the sums, and the
// statistics come from the same unrounded accumulators.  y is rounded to
// E once; at f16 a y past 65504 becomes inf, in both packages.
// A block of 8 warps owns 128 pixels x 64 channels of y, each warp
// 32 x 32 (ResNet-50's Co are multiples of 64, so no column is wasted).
// 64 channels and not 128 where Co >= 128: with the per-slice sums below
// a 32 x 64 warp tile would hold 64 accumulators and their slice's, one
// block an SM; a 64-wide tile re-reads A once for each 64 of Co, from L2,
// since a row tile's column tiles are neighbours in the grid.  K is walked
// a tap at a time in slices of 32 input channels: a slice of A, [128
// pixels, 32 channels of one tap], is copied by cp.async straight from
// x's rows (a pixel's channels are contiguous; for kernel 8 row m is at
// x + m Ci), the matching [32, 64] slice of W by cp.async, both into
// shared memory with rows padded by 16 bytes (ldmatrix's eight row
// addresses fall in distinct banks); three stages, two slices in flight
// while one is multiplied, one barrier a slice.  A fragments come by
// ldmatrix, B fragments by ldmatrix.trans.  W, the copy width, is 8
// elements (16 bytes; Ci and Co multiples of 8, operands 16-byte
// aligned), 4 (8 bytes; multiples of 4) or 1 (plain loads and stores),
// as the wrapper chooses; a tap's channels past Ci and columns past Co
// are zero-filled by the copy itself.  The first slice's products
// accumulate on the tensor cores into acc; each later slice's, a quarter
// of the warp's tile at a time, into 8 fresh registers, which join the
// running sums in float32 adds: the tensor cores' own accumulation, run
// through all of K, moved the statistics by a bias that grew with K, past
// the plain version's spread at res5 (K = 4608 for kernel 9; kernel 8's K
// reaches 2048).  Epilogue: y rounded to E once and staged in the
// operands' shared memory; each column's sum and sum of squares over the
// thread's 4 rows, then over the 8 lanes that share the column (a halving
// exchange: 14 shuffles for the thread's 16 sums), then over the 4 warps
// along the pixels in shared memory, in a fixed order; then y stored in
// row order, W elements a store (at W 8, eight threads write a row's 128
// bytes: y is most of kernel 8's bytes).  Kernel 8 at W 8 fits in 80
// registers, so three blocks share an SM (two for the others): at K 64
// its blocks are short, and a third block on the SM hides more of each
// one's load and epilogue.  wgmma, TMA loads (im2col for kernel 9) and a
// persistent grid are later work.
//
// The float32 instances of both (conv_tf32_stats_kernel<kTaps, W>) run on
// the tensor cores as split TF32 (mma_tf32.cuh): every product a . b is
// three mma.sync m16n8k8 TF32 products, lo_a.hi_b + hi_a.lo_b + hi_a.hi_b,
// of the operands' splits x = hi + lo (each part rounded to TF32 to
// nearest, ties away, as cvt.rna rounds), accumulated in float32: within
// 3 * 2^-22 of |a||b| where one TF32 product keeps 2^-10, so y holds the
// float32 plain version's 1e-4.  Bounds at three TF32 products a float32
// one (165 TFLOP/s of float32 work): kernel 9 at res2 0.179 ms (float32
// FMAs 0.44); kernel 8 at res2 expand 0.080 ms of operations against
// 0.153 ms of bytes, a ResNet-50 step's 30 launches 2.35 ms (operations
// at K 256 and up).  ops/conv_bn.py::_tf32x3_matmul_stats and
// _tf32x3_conv3x3_stats are this arithmetic in plain torch.  The 16-bit
// kernel's geometry (128 pixels x 64 channels a block, 8 warps of 32 x 32,
// slices of 32 input channels of one tap gathered from x by cp.async,
// three stages, one row of partial statistics a block reduced by
// finish_chunked) on float32 operands; what differs:
//   - A, the [pixel][channel] slice, is read as the TF32 A fragment's
//     [g][t] by ldmatrix on 32-bit words (rows of 36 floats, 4 mod 32) and
//     split in registers as it is read (two warps share an A element);
//   - W, which every block reads whole, is split once a call by a
//     pre-pass (split_w_planes_kernel) into hi and lo planes in device
//     memory, transposed to [tap][co][ci] and zero-padded to whole slices
//     and column tiles, in the scratch after the partial statistics: each
//     slice copies its [64][32] planes whole, B is read as [g][t] by
//     ldmatrix (four 32-bit words a lane an instruction, where W's [k][n]
//     would need one shared load an element), and the slice needs one
//     barrier, where splitting the landed W in every block took a pass
//     and a second barrier a slice;
//   - each slice's 12 products of a fragment go into fresh registers (the
//     warp's whole tile: k-steps outside, so each B fragment is read once
//     a warp) added to the running sums in float32, as at 16 bits: the
//     tensor cores round each product's sum toward zero;
//   - the splits round on the bit pattern (mma_tf32.cuh rna), two integer
//     instructions where cvt.rna.tf32.f32 runs at the conversion rate;
//   - kernel 8's y, float32, is staged through the stage buffers (rows of
//     72 floats, 8 mod 32: a half-warp's 8-byte writes of its fragment
//     rows fall in distinct banks) and stored in row order, 16 bytes a
//     thread, so that 16 threads write a row's 256 bytes in whole 128-byte
//     lines: y is 80% of its bytes.  Kernel 9 stores y from the
//     accumulators (four lanes write a row's 32-byte sector), which was
//     faster there than staging it.
// Shared memory: three stages of A (18,432 bytes) and the W planes
// (18,432): 110,592 bytes; with 125 or so registers a thread, two blocks
// an SM.  Kernel 8 keeps the three stages at one tap, where at K 64 (res2)
// a block walks only two slices: its blocks cannot go to three an SM as
// the 16-bit kernel 8's did (that takes 85 registers a thread, and the
// 3xTF32 tile holds 32 running sums, 32 fresh ones and the split
// fragments), so fewer stages would free shared memory that no third block
// could use; at K 64 the prologue puts both slices in flight at once, and
// at K 256 to 2048 the third stage hides the copy behind two slices of
// products.  W, x's copy width, is 4 floats (16-byte cp.async and 16-byte
// y stores; Ci and Co multiples of 4, operands 16-byte aligned) or 1
// (4-byte copies and stores), as the wrapper's _vec finds; the planes
// always copy 16 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "stat_reduce.cuh"

namespace {

// ---------------------- kernels 8 and 9 at bf16 and f16, tensor cores
using mma::bf16;
using mma::copy_or_zero;
using mma::Elem16;
using mma::f16;
using mma::static_for;

constexpr int kMmaBM = 128;     // output pixels a block: R = ceil(P / 128)
constexpr int kMmaBN = 64;      // output channels a block
constexpr int kMmaBK = 32;      // input channels of one tap a slice
constexpr int kMmaThreads = 256;   // 8 warps: 4 along pixels x 2 channels
constexpr int kStages = 3;
constexpr int kAS = kMmaBK + 8;    // padded row of an A slice (16-bit)
constexpr int kBS = kMmaBN + 8;    // padded row of a W slice
constexpr int kYS = kMmaBN + 8;    // padded row of the staged y tile
constexpr int kStageElems = kMmaBM * kAS + kMmaBK * kBS;
static_assert(kMmaBM * kYS <= kStages * kStageElems,
              "y's tile is staged in the operands' buffers");

// c ? a : b, a select on the values
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\nselp.f32 %0, %1, %2, p;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)c));
  return r;
}

// One step of the halving exchange of v[0 .. 2W) over the lanes xor 2W: a
// lane keeps the lower half (or, with lane bit 2W set, the upper half),
// adding its partner's copy of it, into v[0 .. W).
template <int kW>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool hi = lane & (2 * kW);
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const float keep = pick(hi, v[kW + k], v[k]);
    const float give = pick(hi, v[k], v[kW + k]);
    v[k] = keep + __shfl_xor_sync(0xffffffffu, give, 2 * kW);
  }
}

// y [M, Co] and the per-column partial statistics of this block's rows
// (row blockIdx.x / n_col_tiles of part_s and part_ss), W elements a copy.
// kTaps says how A is gathered from x: 1, A is x [M, Ci] itself (kernel 8,
// H and Wd unused); 9, A is the 3x3 SAME patches of x [N, H, Wd, Ci] with
// w [3, 3, Ci, Co] (kernel 9, M = N H Wd).
template <typename E, int kTaps, int W>
__global__ void __launch_bounds__(kMmaThreads, kTaps == 1 && W == 8 ? 3 : 2)
conv_mma_stats_kernel(const E* __restrict__ x,
                      const E* __restrict__ w, int M, int H, int Wd,
                      int Ci, int Co, int n_col_tiles,
                      E* __restrict__ y, float* __restrict__ part_s,
                      float* __restrict__ part_ss) {
  static_assert(kTaps == 1 || kTaps == 9, "a dense A or the 3x3 patches");
  __shared__ __align__(16) E smem[kStages * kStageElems];
  __shared__ float red[2][4][kMmaBN];
  const int rt = blockIdx.x / n_col_tiles, ct = blockIdx.x % n_col_tiles;
  const int m0 = rt * kMmaBM, c0 = ct * kMmaBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int cpt = (Ci + kMmaBK - 1) / kMmaBK;    // slices a tap
  const int n_slices = kTaps * cpt;

  // A: a thread copies channels ac..ac+W-1 of rows tid / kCpr + j kRStep;
  // each row's pixel index (-1 past M) and, for the 3x3 patches,
  // (h << 16 | w), kept for W 8 and 4, recomputed for W 1
  constexpr int kCpr = kMmaBK / W;
  constexpr int kRStep = kMmaThreads / kCpr;
  constexpr int kNR = kMmaBM / kRStep;
  constexpr bool kKeep = kTaps == 9 && W > 1;
  const int ar = tid / kCpr, ac = (tid % kCpr) * W;
  int pix[kKeep ? kNR : 1], phw[kKeep ? kNR : 1];
  auto pixel = [&](int r, int& m, int& hw) {
    m = m0 + r;
    hw = 0;
    if (m >= M) {
      m = -1;
      return;
    }
    if constexpr (kTaps == 9) {
      const int ww = m % Wd, hh = (m / Wd) % H;
      hw = (hh << 16) | ww;
    }
  };
  if constexpr (kKeep) {
#pragma unroll
    for (int j = 0; j < kNR; ++j) pixel(ar + j * kRStep, pix[j], phw[j]);
  }
  // W: a thread copies columns of rows idx / kBCpr, idx = tid + j threads
  constexpr int kBCpr = kMmaBN / W;
  constexpr int kBIters = kMmaBK * kBCpr / kMmaThreads;

  auto load_slice = [&](int sl, int st) {
    const int tap = kTaps == 1 ? 0 : sl / cpt;
    const int cb = (sl - tap * cpt) * kMmaBK;
    const int dh = kTaps == 1 ? 0 : tap / 3 - 1;
    const int dw = kTaps == 1 ? 0 : tap % 3 - 1;
    E* sA = smem + st * kStageElems;
    E* sB = sA + kMmaBM * kAS;
    const int ci = cb + ac;
    // shared addresses: this thread's first row, the others at immediate
    // offsets from it
    const uint32_t a_dst = mma::smem_u32(sA + ar * kAS + ac);
    static_for<kNR>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      int m, hw;
      if constexpr (kKeep) {
        m = pix[j];
        hw = phw[j];
      } else {
        pixel(ar + j * kRStep, m, hw);
      }
      bool ok = m >= 0 && ci < Ci;
      if constexpr (kTaps == 9) {
        const int hh = (hw >> 16) + dh, ww = (hw & 0xffff) + dw;
        ok = ok && (unsigned)hh < (unsigned)H && (unsigned)ww < (unsigned)Wd;
      }
      // 32-bit offsets: x and w have fewer than 2^31 elements (the wrapper
      // checks)
      const E* src = x + ((m + dh * Wd + dw) * Ci + ci);
      if constexpr (W > 1) {
        copy_or_zero<W * 2, j * kRStep * kAS * 2>(a_dst, ok ? src : x, ok);
      } else {
        E* dst = sA + (ar + j * kRStep) * kAS + ac;
        *dst = ok ? *src : Elem16<E>::from(0.f);
      }
    });
#pragma unroll
    for (int j = 0; j < kBIters; ++j) {
      const int idx = tid + j * kMmaThreads;
      const int kk = idx / kBCpr, cc = idx % kBCpr * W;
      const bool ok = cb + kk < Ci && c0 + cc < Co;
      const E* src = w + ((tap * Ci + cb + kk) * Co + c0 + cc);
      E* dst = sB + kk * kBS + cc;
      if constexpr (W > 1)
        copy_or_zero<W * 2, 0>(mma::smem_u32(dst), ok ? src : w, ok);
      else
        *dst = ok ? *src : Elem16<E>::from(0.f);
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
  // the stages slice it is in, and slice it + kStages - 1 goes to
  int st_use = 0, st_load = kStages - 1;
  for (int it = 0; it < n_slices; ++it) {
    mma::cp_async_wait<kStages - 2>();   // slice it has landed
    __syncthreads();                     // and every warp is done with it-1
    if (it + kStages - 1 < n_slices) load_slice(it + kStages - 1, st_load);
    mma::cp_async_commit();
    st_load = st_load == kStages - 1 ? 0 : st_load + 1;
    const E* sA = smem + st_use * kStageElems;
    st_use = st_use == kStages - 1 ? 0 : st_use + 1;
    const E* sB = sA + kMmaBM * kAS;
    // a slice's products join the running sums in float32 adds, the first
    // slice's straight into acc, which holds zeros: run through all of K,
    // the tensor cores' own accumulation moved the statistics by a bias
    // that grew with K (on the H100, up to 1.2e-6 of their scale at res2,
    // 7.5e-6 at res5).  A quarter of the warp's tile at a time (16 rows x
    // 16 columns), so the fresh sums take 8 registers and, for kernel 8 at
    // W 8, three blocks fit an SM
    if (it == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
#pragma unroll
          for (int kk = 0; kk < kMmaBK / 16; ++kk) {
            uint32_t af[4], bfr[4];
            mma::ldmatrix_x4(af, sA + (wm * 32 + i * 16 + (lane & 15)) * kAS
                                     + kk * 16 + (lane >> 4) * 8);
            mma::ldmatrix_x4_trans(bfr, sB + (kk * 16 + (lane & 15)) * kBS
                                            + wn * 32 + jp * 16
                                            + (lane >> 4) * 8);
            Elem16<E>::mma(acc[i][2 * jp], af, bfr[0], bfr[1]);
            Elem16<E>::mma(acc[i][2 * jp + 1], af, bfr[2], bfr[3]);
          }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        float sl[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < kMmaBK / 16; ++kk) {
          uint32_t af[4], bfr[4];
          mma::ldmatrix_x4(af, sA + (wm * 32 + i * 16 + (lane & 15)) * kAS
                                   + kk * 16 + (lane >> 4) * 8);
          mma::ldmatrix_x4_trans(bfr, sB + (kk * 16 + (lane & 15)) * kBS
                                          + wn * 32 + jp * 16
                                          + (lane >> 4) * 8);
          Elem16<E>::mma(sl[0], af, bfr[0], bfr[1]);
          Elem16<E>::mma(sl[1], af, bfr[2], bfr[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][2 * jp][e] += sl[0][e];
          acc[i][2 * jp + 1][e] += sl[1][e];
        }
      }
  }
  mma::cp_async_wait<0>();               // no copy outlives the block
  __syncthreads();                       // every warp is done with the slices

  // y, rounded to E once, staged in shared memory: rows 32 wm + 16 i +
  // g (+ 8), columns 32 wn + 8 n + 2t (+ 1) of the tile
  E* sY = smem;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + i * 16 + g + 8 * half;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<uint32_t*>(sY + r * kYS + wn * 32 + n * 8 + 2 * t) =
            Elem16<E>::pack(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
    }

  // statistics, from the unrounded sums: the thread's 4 rows of each of
  // its 8 columns (v[2c], v[2c + 1]: sum and sum of squares of column
  // c = 2n + par), then the 8 lanes that share the columns (g = 0..7) in
  // a halving exchange: at xor 16, 8 and 4 a lane keeps half of its
  // values, adding its partner's, so lane g ends with column g's two sums
  // (14 shuffles where a shuffle a value a step takes 48); then the 4
  // warps along the pixels in wm order (rows past M and columns past Co
  // hold zeros)
  float v[16];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      float sm_ = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float a = acc[i][n][2 * half + par];
          sm_ += a;
          sq = fmaf(a, a, sq);
        }
      v[2 * (2 * n + par)] = sm_;
      v[2 * (2 * n + par) + 1] = sq;
    }
  halve<8>(v, lane);                     // lane bit 4: g's bit 2
  halve<4>(v, lane);                     // lane bit 3: g's bit 1
  halve<2>(v, lane);                     // lane bit 2: g's bit 0
  {
    const int col = wn * 32 + (g >> 1) * 8 + 2 * t + (g & 1);
    red[0][wm][col] = v[0];
    red[1][wm][col] = v[1];
  }
  __syncthreads();                       // y's tile and red are complete
  // y out in row order, W elements a store (16 bytes at W 8: 8 threads
  // write a row's 128 bytes), only inside [M, Co]
  constexpr int kYCpr = kMmaBN / W;
#pragma unroll 4
  for (int idx = tid; idx < kMmaBM * kYCpr; idx += kMmaThreads) {
    const int r = idx / kYCpr, cc = idx % kYCpr * W;
    const int m = m0 + r, c = c0 + cc;
    if (m >= M || c >= Co) continue;     // Co a multiple of W
    const E* src = sY + r * kYS + cc;
    E* dst = y + (long long)m * Co + c;
    if constexpr (W == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else if constexpr (W == 4)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    else
      *dst = *src;
  }
  // the 4 warps along the pixels, in wm order
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

// The tensor-core instances of both kernels on E (bf16 or f16): M output
// pixels (P for kernel 8, N H Wd for kernel 9), `vec` the copy width (2:
// 16 bytes, 1: 8, 0: one element).
template <typename E, int kTaps>
int conv_mma_launch(const void* x, const void* w, int M, int H, int Wd,
                    int Ci, int Co, int vec, void* y, void* part, void* s,
                    void* ss, cudaStream_t st) {
  const int n_row = (M + kMmaBM - 1) / kMmaBM;
  const int n_col = (Co + kMmaBN - 1) / kMmaBN;
  float* pa = (float*)part;
  float* pb = pa + (long long)n_row * Co;
  auto* kernel = vec == 2   ? conv_mma_stats_kernel<E, kTaps, 8>
                 : vec == 1 ? conv_mma_stats_kernel<E, kTaps, 4>
                            : conv_mma_stats_kernel<E, kTaps, 1>;
  kernel<<<n_row * n_col, kMmaThreads, 0, st>>>(
      (const E*)x, (const E*)w, M, H, Wd, Ci, Co, n_col, (E*)y, pa,
      pb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)stat_reduce::finish_chunked(pa, pb, n_row, Co, (float*)s,
                                          (float*)ss, st);
}

template <typename E, int kTaps>
const void* conv_mma_fn(int width) {
  return width == 8   ? (const void*)conv_mma_stats_kernel<E, kTaps, 8>
         : width == 4 ? (const void*)conv_mma_stats_kernel<E, kTaps, 4>
                      : (const void*)conv_mma_stats_kernel<E, kTaps, 1>;
}

// ---------------------- kernels 8 and 9 at float32, tensor cores (3xTF32)
constexpr int kTfAS = kMmaBK + 4;     // padded row of an A slice (floats)
constexpr int kTfPS = kMmaBK + 4;     // padded row of a W plane, [n][k]
constexpr int kTfYS = kMmaBN + 8;     // padded row of the staged y tile
constexpr int kTfStage = kMmaBM * kTfAS + 2 * kMmaBN * kTfPS;
constexpr size_t kTfSmem = sizeof(float) * kStages * kTfStage;
constexpr int kTfT = 32;              // the plane pre-pass's square tile
static_assert(kMmaBK == kTfT && kMmaBN % kTfT == 0,
              "the W planes are padded to whole slices and column tiles");
static_assert(kMmaBM * kTfYS <= kStages * kTfStage,
              "y's tile is staged in the stage buffers");

// w [taps, Ci, Co] split into TF32 planes hi and lo [taps][Cop][Cip],
// transposed (a tap's [n][k]) and zero past Ci and Co (Cip, Cop: Ci and Co
// rounded up to whole slices and column tiles), so that the conv kernel
// copies each slice's planes whole: one kTfT x kTfT tile of one tap a
// block, read along Co and written along Ci through shared memory.
__global__ void __launch_bounds__(kTfT * 8)
split_w_planes_kernel(const float* __restrict__ w, int Ci, int Co, int Cip,
                      int Cop, float* __restrict__ hi,
                      float* __restrict__ lo) {
  __shared__ float tile[kTfT][kTfT + 1];
  const int tap = blockIdx.z, ci0 = blockIdx.x * kTfT,
            co0 = blockIdx.y * kTfT;
  const int tx = threadIdx.x % kTfT, ty = threadIdx.x / kTfT;
  for (int r = ty; r < kTfT; r += 8) {
    const int ci = ci0 + r, co = co0 + tx;
    tile[r][tx] = ci < Ci && co < Co
                      ? w[((long long)tap * Ci + ci) * Co + co]
                      : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < kTfT; r += 8) {
    uint32_t h, l;
    tf32::split(tile[tx][r], h, l);
    const long long o = ((long long)tap * Cop + co0 + r) * Cip + ci0 + tx;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

// y [M, Co], float32, and the per-column partial statistics of this
// block's rows (row blockIdx.x / n_col_tiles of part_s and part_ss), W
// floats a copy of x (4 or 1).  kTaps says how A is gathered from x: 1, A
// is x [M, Ci] itself (kernel 8, H and Wd unused); 9, A is the 3x3 SAME
// patches of x [N, H, Wd, Ci] (kernel 9, M = N H Wd).  w_hi holds w's
// planes (split_w_planes_kernel: [kTaps][Cop][Cip] each, lo right after
// hi).
template <int kTaps, int W>
__global__ void __launch_bounds__(kMmaThreads, 2)
conv_tf32_stats_kernel(const float* __restrict__ x,
                       const float* __restrict__ w_hi, int M, int H, int Wd,
                       int Ci, int Co, int Cip, int Cop, int n_col_tiles,
                       float* __restrict__ y, float* __restrict__ part_s,
                       float* __restrict__ part_ss) {
  static_assert(kTaps == 1 || kTaps == 9, "a dense A or the 3x3 patches");
  static_assert(W == 4 || W == 1, "16-byte copies or one float");
  // kStages x [A [kMmaBM][kTfAS]; W hi, lo [kMmaBN][kTfPS]]; then y's tile
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  __shared__ float red[2][4][kMmaBN];
  const int rt = blockIdx.x / n_col_tiles, ct = blockIdx.x % n_col_tiles;
  const int m0 = rt * kMmaBM, c0 = ct * kMmaBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int cpt = (Ci + kMmaBK - 1) / kMmaBK;    // slices a tap
  const int n_slices = kTaps * cpt;

  // A: a thread copies channels ac..ac+W-1 of rows ar + j kRStep; each
  // row's pixel index (-1 past M) and, for the 3x3 patches, (h << 16 | w),
  // kept for W 4, recomputed for W 1
  constexpr int kCpr = kMmaBK / W;
  constexpr int kRStep = kMmaThreads / kCpr;
  constexpr int kNR = kMmaBM / kRStep;
  constexpr bool kKeep = kTaps == 9 && W > 1;
  const int ar = tid / kCpr, ac = (tid % kCpr) * W;
  int pix[kKeep ? kNR : 1], phw[kKeep ? kNR : 1];
  auto pixel = [&](int r, int& m, int& hw) {
    m = m0 + r;
    hw = 0;
    if (m >= M) {
      m = -1;
      return;
    }
    if constexpr (kTaps == 9) {
      const int ww = m % Wd, hh = (m / Wd) % H;
      hw = (hh << 16) | ww;
    }
  };
  if constexpr (kKeep) {
#pragma unroll
    for (int j = 0; j < kNR; ++j) pixel(ar + j * kRStep, pix[j], phw[j]);
  }
  // W's planes: a thread copies 16 bytes of rows tid / 8 and tid / 8 + 32
  // of each plane
  constexpr int kBIters = 2 * kMmaBN * (kMmaBK / 4) / kMmaThreads;
  static_assert(kBIters == 4 && kMmaThreads / 8 == 32, "four copies");
  const int w_plane = kTaps * Cop * Cip;  // w_lo - w_hi

  auto load_slice = [&](int sl, int st) {
    const int tap = kTaps == 1 ? 0 : sl / cpt;
    const int cb = (sl - tap * cpt) * kMmaBK;
    const int dh = kTaps == 1 ? 0 : tap / 3 - 1;
    const int dw = kTaps == 1 ? 0 : tap % 3 - 1;
    float* sA = smem + st * kTfStage;
    float* sB = sA + kMmaBM * kTfAS;
    const int ci = cb + ac;
    // one base address each side; the other three copies at immediate
    // (shared) and fixed (global) offsets from it
    const uint32_t b_dst = mma::smem_u32(sB + (tid >> 3) * kTfPS
                                         + (tid & 7) * 4);
    const float* b_src = w_hi + ((tap * Cop + c0 + (tid >> 3)) * Cip + cb
                                 + (tid & 7) * 4);
    static_for<kBIters>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      copy_or_zero<16, ((j >> 1) * kMmaBN + (j & 1) * 32) * kTfPS * 4>(
          b_dst, b_src + (j >> 1) * w_plane + (j & 1) * 32 * Cip, true);
    });
    const uint32_t a_dst = mma::smem_u32(sA + ar * kTfAS + ac);
    static_for<kNR>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      int m, hw;
      if constexpr (kKeep) {
        m = pix[j];
        hw = phw[j];
      } else {
        pixel(ar + j * kRStep, m, hw);
      }
      bool ok = m >= 0 && ci < Ci;
      if constexpr (kTaps == 9) {
        const int hh = (hw >> 16) + dh, ww = (hw & 0xffff) + dw;
        ok = ok && (unsigned)hh < (unsigned)H && (unsigned)ww < (unsigned)Wd;
      }
      // 32-bit offsets: x and w have fewer than 2^31 elements (the wrapper
      // checks)
      const float* src = x + ((m + dh * Wd + dw) * Ci + ci);
      copy_or_zero<W * 4, j * kRStep * kTfAS * 4>(a_dst, ok ? src : x,
                                                      ok);
    });
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
  // fragment corners: the warp's A rows (ldmatrix, split as read) and its
  // 32 columns of the W planes (ldmatrix, two n-tiles a call)
  const int a_off = wm * 32 * kTfAS + tf32::a_lane<kTfAS>(lane);
  const int b_off = wn * 32 * kTfPS + tf32::b_lane<kTfPS>(lane);
  // the stages slice it is in, and slice it + kStages - 1 goes to
  int st_use = 0, st_load = kStages - 1;
  for (int it = 0; it < n_slices; ++it) {
    mma::cp_async_wait<kStages - 2>();   // slice it has landed
    __syncthreads();                     // every warp is done with it - 1
    if (it + kStages - 1 < n_slices) load_slice(it + kStages - 1, st_load);
    mma::cp_async_commit();
    st_load = st_load == kStages - 1 ? 0 : st_load + 1;
    const float* sA = smem + st_use * kTfStage;
    const float* sWh = sA + kMmaBM * kTfAS;
    const float* sWl = sWh + kMmaBN * kTfPS;
    st_use = st_use == kStages - 1 ? 0 : st_use + 1;
    // the slice's products in fresh registers, added to the running sums
    // in float32
    float fr[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) fr[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 8; ++kk) {
      tf32::SplitB bw[4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int o = b_off + np * 16 * kTfPS + kk * 8;
        tf32::SplitB two[2];
        tf32::load_b2(two, sWh + o, sWl + o);
        bw[2 * np] = two[0];
        bw[2 * np + 1] = two[1];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tf32::SplitA a;
        tf32::load_a(a, sA + a_off + i * 16 * kTfAS + kk * 8);
#pragma unroll
        for (int n = 0; n < 4; ++n) tf32::mma3(fr[i][n], a, bw[n]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += fr[i][n][e];
  }
  mma::cp_async_wait<0>();               // no copy outlives the block

  // y: rows 32 wm + 16 i + g (+ 8), columns 32 wn + 8 n + 2t (+ 1) of the
  // tile.  Kernel 8 stages it in the stage buffers, stored in row order
  // below; kernel 9 stores it from the accumulators, only inside [M, Co]
  // (four lanes write a row's 32-byte sector: staging it was slower there
  // on the H100)
  float* sY = smem;
  if constexpr (kTaps == 1) __syncthreads();   // every warp is done with
                                               // the slices
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + i * 16 + g + 8 * half;
      const int m = m0 + r;
      if (kTaps == 9 && m >= M) continue;
      float* dst = y + (long long)m * Co;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int cc = wn * 32 + n * 8 + 2 * t, c = c0 + cc;
        const float v0 = acc[i][n][2 * half], v1 = acc[i][n][2 * half + 1];
        if constexpr (kTaps == 1) {
          *reinterpret_cast<float2*>(sY + r * kTfYS + cc) =
              make_float2(v0, v1);
        } else if constexpr (W == 4) {         // Co a multiple of 4
          if (c < Co)
            *reinterpret_cast<float2*>(dst + c) = make_float2(v0, v1);
        } else {
          if (c < Co) dst[c] = v0;
          if (c + 1 < Co) dst[c + 1] = v1;
        }
      }
    }

  // statistics, from the same sums, as the 16-bit kernel takes them: the
  // thread's 4 rows of each of its 8 columns, the 8 lanes that share the
  // columns in a halving exchange, then the 4 warps along the pixels in wm
  // order (rows past M and columns past Co hold zeros)
  float v[16];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      float sm_ = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float a = acc[i][n][2 * half + par];
          sm_ += a;
          sq = fmaf(a, a, sq);
        }
      v[2 * (2 * n + par)] = sm_;
      v[2 * (2 * n + par) + 1] = sq;
    }
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  {
    const int col = wn * 32 + (g >> 1) * 8 + 2 * t + (g & 1);
    red[0][wm][col] = v[0];
    red[1][wm][col] = v[1];
  }
  __syncthreads();                       // y's tile and red are complete
  // kernel 8's y out in row order, W floats a store (16 bytes at W 4: 16
  // threads write a row's 256 bytes), only inside [M, Co]
  constexpr int kYCpr = kMmaBN / W;
#pragma unroll 4
  for (int idx = tid; kTaps == 1 && idx < kMmaBM * kYCpr;
       idx += kMmaThreads) {
    const int r = idx / kYCpr, cc = idx % kYCpr * W;
    const int m = m0 + r, c = c0 + cc;
    if (m >= M || c >= Co) continue;     // Co a multiple of W
    const float* src = sY + r * kTfYS + cc;
    float* dst = y + (long long)m * Co + c;
    if constexpr (W == 4)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else
      *dst = *src;
  }
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

template <int kTaps>
const void* conv_tf32_fn(int width) {
  return width == 4 ? (const void*)conv_tf32_stats_kernel<kTaps, 4>
                    : (const void*)conv_tf32_stats_kernel<kTaps, 1>;
}

// Kernels 8 (kTaps 1) and 9 (kTaps 9) at float32 over M output pixels: w
// [kTaps, Ci, Co]; `vec` 1 for 16-byte copies of x and stores of y, 0 for
// one float; part holds the [2, R, Co] partial statistics, then (from the
// next 16-byte boundary) w's two planes, kTaps Cop Cip floats each.
template <int kTaps>
int conv_tf32_launch(const void* x, const void* w, int M, int H, int Wd,
                     int Ci, int Co, int vec, void* y, void* part, void* s,
                     void* ss, cudaStream_t st) {
  const int n_row = (M + kMmaBM - 1) / kMmaBM;
  const int n_col = (Co + kMmaBN - 1) / kMmaBN;
  const int Cip = (Ci + kMmaBK - 1) / kMmaBK * kMmaBK;
  const int Cop = n_col * kMmaBN;
  float* pa = (float*)part;
  float* pb = pa + (long long)n_row * Co;
  float* w_hi = pa + ((2LL * n_row * Co + 3) & ~3LL);
  float* w_lo = w_hi + (long long)kTaps * Cop * Cip;
  split_w_planes_kernel<<<dim3(Cip / kTfT, Cop / kTfT, kTaps), kTfT * 8, 0,
                          st>>>((const float*)w, Ci, Co, Cip, Cop, w_hi,
                                w_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto* kernel = vec ? conv_tf32_stats_kernel<kTaps, 4>
                     : conv_tf32_stats_kernel<kTaps, 1>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTfSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_row * n_col, kMmaThreads, kTfSmem, st>>>(
      (const float*)x, w_hi, M, H, Wd, Ci, Co, Cip, Cop, n_col, (float*)y,
      pa, pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)stat_reduce::finish_chunked(pa, pb, n_row, Co, (float*)s,
                                          (float*)ss, st);
}

}  // namespace

// One C entry per instance: x and w float32 (f32), bf16 (bf16) or float16
// (f16); y in their type, s and ss float32.  The float32 instances take
// `vec` 1 for 16-byte copies, 0 for one float; the bf16 and f16 ones the
// copy width: 2 for 16 bytes, 1 for 8, 0 for one element.
// x [P, Ci], w [Ci, Co] -> y [P, Co], s and ss [Co]; part is [2, R, Co]
// scratch with R = ceil(P / 128), at float32 followed by w's planes.
#define MM_ARGS                                                            \
  const void *x, const void *w, int P, int Ci, int Co, int vec, void *y,   \
      void *part, void *s, void *ss, void *stream
extern "C" int matmul_stats_f32(MM_ARGS) {
  return conv_tf32_launch<1>(x, w, P, 1, 1, Ci, Co, vec, y, part, s, ss,
                             (cudaStream_t)stream);
}
extern "C" int matmul_stats_bf16(MM_ARGS) {
  return conv_mma_launch<bf16, 1>(x, w, P, 1, 1, Ci, Co, vec, y, part, s,
                                  ss, (cudaStream_t)stream);
}
extern "C" int matmul_stats_f16(MM_ARGS) {
  return conv_mma_launch<f16, 1>(x, w, P, 1, 1, Ci, Co, vec, y, part, s,
                                 ss, (cudaStream_t)stream);
}

// x [N, H, W, Ci], w [3, 3, Ci, Co] -> y [N, H, W, Co], s and ss [Co];
// part is [2, R, Co] scratch with R = ceil(N H W / 128), as above.
#define C3_ARGS                                                           \
  const void *x, const void *w, int N, int H, int W, int Ci, int Co,      \
      int vec, void *y, void *part, void *s, void *ss, void *stream
extern "C" int conv3x3_stats_f32(C3_ARGS) {
  return conv_tf32_launch<9>(x, w, N * H * W, H, W, Ci, Co, vec, y, part,
                             s, ss, (cudaStream_t)stream);
}
extern "C" int conv3x3_stats_bf16(C3_ARGS) {
  return conv_mma_launch<bf16, 9>(x, w, N * H * W, H, W, Ci, Co, vec, y,
                                  part, s, ss, (cudaStream_t)stream);
}
extern "C" int conv3x3_stats_f16(C3_ARGS) {
  return conv_mma_launch<f16, 9>(x, w, N * H * W, H, W, Ci, Co, vec, y,
                                 part, s, ss, (cudaStream_t)stream);
}

// Registers and local memory (bytes a thread: stack and spills) of the
// tensor-core kernel: `taps` 1 (kernel 8) or 9 (kernel 9), copy width
// `width` (8, 4 or 1 elements), on bf16 operands or, with `is_f16`, f16.
extern "C" int conv_mma_resources(int taps, int width, int is_f16,
                                  int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const void* fn =
      is_f16 ? (taps == 1 ? conv_mma_fn<f16, 1>(width)
                          : conv_mma_fn<f16, 9>(width))
             : (taps == 1 ? conv_mma_fn<bf16, 1>(width)
                          : conv_mma_fn<bf16, 9>(width));
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Registers and local memory (bytes a thread: stack and spills) of the
// float32 (3xTF32) kernel: `taps` 1 (kernel 8) or 9 (kernel 9), copy width
// `width` (4 or 1 floats).
extern "C" int conv_tf32_resources(int taps, int width, int* regs,
                                   int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, taps == 1 ? conv_tf32_fn<1>(width) : conv_tf32_fn<9>(width));
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
