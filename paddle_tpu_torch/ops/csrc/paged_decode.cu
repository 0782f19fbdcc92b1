// Paged decode attention, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/paged_attention.py::_decode_kernel
// (launched by _pallas_paged).  Same function: one decode query per sequence
// attends its logical positions <= pos[s], reading K/V rows in place from the
// block pool [NB, BS, H, D] through the block table [S, MB]; no gathered copy
// of the logical view is made.  The logical blocks are cut into G kv-splits
// of bps = ceil(MB / G) blocks each; every (sequence, split, head) writes a
// normalized partial O [S, G, H, D] and its natural-log LSE [S, G, H], which
// the wrapper folds with merge_partial, as the TPU wrapper folds them outside
// its kernel.  A split with no live position writes O = 0 and
// LSE = NEG_INF / LOG2E + log(1e-30), so its merge weight is 0.
//
// What bounds it on the H100: bytes.  Each visible key costs 2 * D * 4 bytes
// of K and V for 4 * D flops, 0.5 flop/byte, far below the float32 ridge.
// The design therefore spends nothing on reuse and everything on streaming:
// each warp owns every fourth group of 4 keys, a lane holds 4 of the D
// elements, so each key row is one coalesced 512-byte read per warp, and the
// 4 keys of a group are loaded before any is reduced, keeping 8 loads in
// flight per lane.  Positions are walked one key at a time through the
// table, so a block of any size is tiled by rows: the slab call
// (BS = max_len, identity table) never stages a whole block.  Positions past
// pos[s] are never read, which skips every block with blk_start > pos and
// keeps hole rows (table all 0, pos 0) on scratch block 0.  Grid
// (head, split, sequence) puts S * G * H blocks in flight.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;           // core/config.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;                   // keys a warp loads at once
constexpr int kDMax = 128;                  // 32 lanes x 4 elements

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ pk,
                    const float* __restrict__ pv,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, float* __restrict__ o_part,
                    float* __restrict__ lse_part, int H, int D, int BS,
                    int MB, int bps, float scale_log2) {
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float4 s_acc[kWarps][kDMax / 4];

  const int h = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int G = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lane_on = lane * 4 < D;

  // this split's logical positions [lo, hi), cut at the row's position
  const long long lo = (long long)g * bps * BS;
  long long hi = (long long)min((g + 1) * bps, MB) * BS;
  hi = min(hi, (long long)pos[s] + 1);

  float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane_on) {
    qv = *reinterpret_cast<const float4*>(q + ((long long)s * H + h) * D +
                                          lane * 4);
    qv.x *= scale_log2; qv.y *= scale_log2;
    qv.z *= scale_log2; qv.w *= scale_log2;
  }
  const int* row = table + (long long)s * MB;
  const long long head_off = (long long)h * D + lane * 4;
  const long long row_stride = (long long)H * D;   // one pool row

  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long base = lo + (long long)warp * kGroup; base < hi;
       base += (long long)kWarps * kGroup) {
    float4 kv[kGroup], vv[kGroup];
    bool ok[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const long long t = base + i;
      ok[i] = t < hi;
      kv[i] = vv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok[i] && lane_on) {
        const long long blk = row[t / BS];
        const long long off =
            (blk * BS + t % BS) * row_stride + head_off;
        kv[i] = *reinterpret_cast<const float4*>(pk + off);
        vv[i] = *reinterpret_cast<const float4*>(pv + off);
      }
    }
    float sc[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      float d = qv.x * kv[i].x;
      d = fmaf(qv.y, kv[i].y, d);
      d = fmaf(qv.z, kv[i].z, d);
      d = fmaf(qv.w, kv[i].w, d);
      sc[i] = d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], off);
    float mx = m;
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (ok[i]) mx = fmaxf(mx, sc[i]);
    const float corr = exp2f(m - mx);
    l *= corr;
    acc.x *= corr; acc.y *= corr; acc.z *= corr; acc.w *= corr;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float p = ok[i] ? exp2f(sc[i] - mx) : 0.f;
      l += p;
      acc.x = fmaf(p, vv[i].x, acc.x);
      acc.y = fmaf(p, vv[i].y, acc.y);
      acc.z = fmaf(p, vv[i].z, acc.z);
      acc.w = fmaf(p, vv[i].w, acc.w);
    }
    m = mx;
  }

  // fold the warps' online-softmax states
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  s_acc[warp][lane] = acc;
  __syncthreads();
  float m_tot = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, s_m[w]);
  float l_tot = 0.f;
  float wgt[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = exp2f(s_m[w] - m_tot);
    l_tot = fmaf(s_l[w], wgt[w], l_tot);
  }
  const float l_safe = fmaxf(l_tot, 1e-30f);
  const long long out = ((long long)s * G + g) * H + h;
  const int d = threadIdx.x;
  if (d < D) {
    const float* acc_f = reinterpret_cast<const float*>(s_acc);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a = fmaf(acc_f[w * kDMax + d], wgt[w], a);
    o_part[out * D + d] = a / l_safe;
  }
  if (threadIdx.x == 0)
    lse_part[out] = m_tot * (1.f / kLog2e) + logf(l_safe);
}

}  // namespace

extern "C" int paged_decode_f32(const void* q, const void* pk,
                                const void* pv, const void* table,
                                const void* pos, void* o_part,
                                void* lse_part, int S, int H, int D, int BS,
                                int MB, int G, float scale_log2,
                                void* stream) {
  const int bps = (MB + G - 1) / G;
  dim3 grid(H, G, S);
  paged_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)pk, (const float*)pv,
      (const int*)table, (const int*)pos, (float*)o_part, (float*)lse_part,
      H, D, BS, MB, bps, scale_log2);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
