// Paged decode attention, float32, for Hopper (sm_90a): one launch, the
// kv-split fold included.
//
// Replaces the Pallas TPU kernel
// paddle_tpu/ops/paged_attention.py::_decode_kernel (launched by
// _pallas_paged) and the merge_partial fold its wrapper runs after it.
// Same function: one decode query per sequence attends its logical
// positions <= pos[s], reading K/V rows in place from the block pool
// [NB, BS, H, D] through the block table [S, MB]; no gathered copy of the
// logical view is made.  Output O [S, H, D]; no LSE (the decoders read
// none).
//
// What bounds it on the H100: bytes.  Each visible key costs 2 * D * 4
// bytes of K and V for 4 * D flops, 0.5 flop/byte, far below the float32
// ridge.  The design spends nothing on reuse and everything on streaming:
// - The split.  Row s's live blocks [0, n) with n = ceil((pos[s] + 1) / BS)
//   (at most MB) are cut into G contiguous ranges, split g taking blocks
//   [g n / G, (g + 1) n / G): a short row leaves splits empty only where it
//   has fewer than G live blocks, and no split holds more than ceil(n / G).
//   Grid (G, H, S): one block of 16 warps a (split, head, sequence).
// - The stream.  A block walks its positions in stages of 32 keys through
//   a 3-stage cp.async ring in shared memory (16 bytes a lane; two stages,
//   64 KB of K and V, in flight a block at D 128; a warp copies whole
//   rows, so no lane divides).  A stage's 32 pool rows come from the
//   table by one warp-wide load issued a stage before the copies that use
//   them, so the table read is off the copies' path.  Each of the 16
//   warps scores 2 keys of a stage (a lane holds 4 of the D elements;
//   shuffles sum the dot) and keeps its own online-softmax state in the
//   exp2 domain (q pre-scaled by scale * log2 e).  On the H100 16 warps
//   scoring 2 keys each streamed a block's keys faster than 8 scoring 4
//   or 4 scoring 8: a stage's time is more its chain of loads, shuffles
//   and exponentials than its bytes.  A block of any size is tiled by rows: the slab call (BS = max_len,
//   identity table) never stages a whole block.  Positions past pos[s]
//   are never read, so hole rows (table all 0, pos 0) stay on scratch
//   block 0.
// - The fold.  With G = 1 a block writes O itself.  Otherwise each split
//   leaves its state (m, l and the unnormalised acc[D]) in a scratch,
//   fences, and adds one to its (sequence, head) counter; the block that
//   arrives last folds the G states in the fixed order g = 0 .. G-1
//   (m = max m_g, O = sum acc_g 2^(m_g - m) / sum l_g 2^(m_g - m)), writes
//   O and puts the counter back to 0 for the next launch.  So the result
//   is the same on every run, and any G works; an empty split has l = 0
//   and weighs nothing.  (A cluster with distributed shared memory would
//   cap G at 8 or 16; the wrapper admits any G up to MB.)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;           // core/config.py NEG_INF
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;                   // keys a stage
constexpr int kPerWarp = kKeys / kWarps;    // keys a warp scores a stage
constexpr int kStages = 3;
constexpr int kDMax = 128;                  // 32 lanes x 4 elements
static_assert(kKeys == 32, "a stage's rows are one warp-wide load");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Split g of G over a row with n live blocks: blocks [b0, b1).
__device__ __forceinline__ void split_blocks(int n, int g, int G, int& b0,
                                             int& b1) {
  b0 = (int)((long long)g * n / G);
  b1 = (int)((long long)(g + 1) * n / G);
}

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ pk,
                    const float* __restrict__ pv,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, float* __restrict__ out,
                    float* __restrict__ part, unsigned* __restrict__ arrived,
                    int H, int D, int BS,
                    int MB, float scale_log2) {
  extern __shared__ __align__(16) float ring[];   // [kStages][2][kKeys][D]
  __shared__ int s_row[kStages][kKeys];           // pool row of each key
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float4 s_acc[kWarps][kDMax / 4];
  __shared__ bool s_last;

  const int g = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int G = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool lane_on = lane * 4 < D;            // lane holds 4 of the D

  // this split's positions [lo, hi)
  const int p = pos[s];
  const int n_live = min(MB, p / BS + 1);
  int b0, b1;
  split_blocks(n_live, g, G, b0, b1);
  const int lo = b0 * BS, hi = min(b1 * BS, p + 1);
  const int n_st = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;

  const int* trow = table + (long long)s * MB;
  const long long row_stride = (long long)H * D;  // one pool row
  const float* pk_lane = pk + (long long)h * D + lane * 4;
  const float* pv_lane = pv + (long long)h * D + lane * 4;
  // the pool row of key `lane` of stage `st`, -1 past hi
  auto row_of = [&](int st) -> int {
    const int t = lo + st * kKeys + lane;
    return (st < n_st && t < hi) ? __ldg(trow + t / BS) * BS + t % BS : -1;
  };
  // a warp copies keys warp, warp + 16: a lane 16 bytes of each row
  auto issue = [&](int st, int slot) {
    if (st < n_st && lane_on) {
      float* sk = ring + slot * 2 * kKeys * D + lane * 4;
      float* sv = sk + kKeys * D;
      const int* rows = s_row[slot];
#pragma unroll
      for (int key = warp; key < kKeys; key += kWarps) {
        const int r = rows[key];
        if (r >= 0) {
          cp_async16(sk + key * D, pk_lane + r * row_stride);
          cp_async16(sv + key * D, pv_lane + r * row_stride);
        }
      }
    }
    cp_async_commit();
  };

  float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane_on) {
    qv = *reinterpret_cast<const float4*>(q + ((long long)s * H + h) * D +
                                          lane * 4);
    qv.x *= scale_log2; qv.y *= scale_log2;
    qv.z *= scale_log2; qv.w *= scale_log2;
  }

  // prologue: the rows of stages 0 and 1 and their copies; stage 2's
  // rows in flight in warp 0's registers
  if (warp == 0) {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) s_row[st][lane] = row_of(st);
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st, st);
  int next_row = warp == 0 ? row_of(kStages - 1) : -1;

  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int slot = 0, slot_next = kStages - 1;  // of stages it and it + 2
  for (int it = 0; it < n_st; ++it) {
    // stage it + 2's rows go to the slot stage it - 1's copies read
    if (warp == 0) s_row[slot_next][lane] = next_row;
    cp_async_wait<kStages - 2>();         // stage it has landed
    __syncthreads();                      // and every warp is done with it-1
    issue(it + kStages - 1, slot_next);
    if (warp == 0) next_row = row_of(it + kStages);
    slot_next = slot_next == kStages - 1 ? 0 : slot_next + 1;

    const float* sk = ring + slot * 2 * kKeys * D;
    slot = slot == kStages - 1 ? 0 : slot + 1;
    const float* sv = sk + kKeys * D;
    const int base = lo + it * kKeys + warp * kPerWarp;
    float sc[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lane_on)
        kv = *reinterpret_cast<const float4*>(
            sk + (warp * kPerWarp + i) * D + lane * 4);
      float d = qv.x * kv.x;
      d = fmaf(qv.y, kv.y, d);
      d = fmaf(qv.z, kv.z, d);
      d = fmaf(qv.w, kv.w, d);
      sc[i] = d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i)
        sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], off);
    // keys past hi hold stale rows: never in the max, never accumulated
    // (the test is the same for every lane of the warp)
    float mx = m;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i)
      if (base + i < hi) mx = fmaxf(mx, sc[i]);
    const float corr = exp2f(m - mx);
    l *= corr;
    acc.x *= corr; acc.y *= corr; acc.z *= corr; acc.w *= corr;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      if (base + i < hi) {
        const float pr = exp2f(sc[i] - mx);
        l += pr;
        if (lane_on) {
          const float4 vv = *reinterpret_cast<const float4*>(
              sv + (warp * kPerWarp + i) * D + lane * 4);
          acc.x = fmaf(pr, vv.x, acc.x);
          acc.y = fmaf(pr, vv.y, acc.y);
          acc.z = fmaf(pr, vv.z, acc.z);
          acc.w = fmaf(pr, vv.w, acc.w);
        }
      }
    }
    m = mx;
  }
  cp_async_wait<0>();                     // no copy outlives the block

  // fold the warps' online-softmax states (warp order)
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  s_acc[warp][lane] = acc;
  __syncthreads();
  float m_blk = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_blk = fmaxf(m_blk, s_m[w]);
  const float* acc_f = reinterpret_cast<const float*>(s_acc);
  float l_blk = 0.f, a = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float wgt = exp2f(s_m[w] - m_blk);
    l_blk = fmaf(s_l[w], wgt, l_blk);
    if (tid < D) a = fmaf(acc_f[w * kDMax + tid], wgt, a);
  }
  const long long sh = (long long)s * H + h;
  if (G == 1) {
    if (tid < D) out[sh * D + tid] = a / fmaxf(l_blk, 1e-30f);
    return;
  }

  // fold the splits: the last block of (s, h) to arrive reads all G
  // states, in split order.  A state is D + 2 floats: acc, then (m, l).
  const int sd = D + 2;
  float* mine = part + (((long long)s * G + g) * H + h) * sd;
  if (tid < D) mine[tid] = a;
  if (tid == 0)
    *reinterpret_cast<float2*>(mine + D) = make_float2(m_blk, l_blk);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(arrived + sh, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* first = part + (long long)s * G * H * sd + (long long)h * sd;
  const long long step = (long long)H * sd;       // from split j to j + 1
  float m_all = kNegInf;
  for (int j = 0; j < G; ++j)
    m_all = fmaxf(m_all, __ldcg(first + j * step + D));
  float l_all = 0.f, o = 0.f;
  for (int j = 0; j < G; ++j) {
    const float* pj = first + j * step;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(pj + D));
    const float wj = exp2f(ml.x - m_all);
    l_all = fmaf(ml.y, wj, l_all);
    if (tid < D) o = fmaf(__ldcg(pj + tid), wj, o);
  }
  if (tid < D) out[sh * D + tid] = o / fmaxf(l_all, 1e-30f);
  if (tid == 0) arrived[sh] = 0u;
}

}  // namespace

// q [S, H, D], pool pk / pv [NB, BS, H, D], table [S, MB], pos [S] ->
// out [S, H, D].  With G > 1, part [S, G, H, D + 2] is scratch and
// arrived [S H] (uint32) holds zeros, which the launch leaves as it found
// them.
extern "C" int paged_decode_f32(const void* q, const void* pk,
                                const void* pv, const void* table,
                                const void* pos, void* out, void* part,
                                void* arrived, int S, int H, int D, int BS,
                                int MB, int G, float scale_log2,
                                void* stream) {
  // the ring takes up to 96 KB: past the 48 KB a launch gets unasked,
  // asked for once a device
  static bool ring_set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ring_set[dev]) {
    err = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStages * 2 * kKeys * kDMax * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ring_set[dev] = true;
  }
  const int smem = kStages * 2 * kKeys * D * (int)sizeof(float);
  dim3 grid(G, H, S);
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)pk, (const float*)pv,
      (const int*)table, (const int*)pos, (float*)out, (float*)part,
      (unsigned*)arrived, H, D, BS, MB, scale_log2);
  return (int)cudaGetLastError();
}

// Registers and local memory (bytes a thread: stack and spills).
extern "C" int paged_decode_resources(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, paged_decode_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
