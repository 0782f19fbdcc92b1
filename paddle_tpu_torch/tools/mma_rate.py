"""The card's rate for the warp-level tensor-core products the hand-written
kernels issue: ``mma.sync`` m16n8k8 on TF32 operands (the float32 kernels'
three products a float32 one, ``ops/csrc/mma_tf32.cuh``) and m16n8k16 on
bf16 (the 16-bit kernels'), float32 accumulation, beside the published
dense peaks (``tools/timing.py``).

    python -m paddle_tpu_torch.tools.mma_rate

Each kernel keeps 8 or 16 independent accumulators a warp and issues
nothing but products from registers (no memory traffic), 8 warps a block,
one or two blocks an SM on every SM; the best of its launches is the
rate the instruction can reach, the ceiling of a kernel built on it.
Prints one line a configuration and a JSON line last.  Needs the CUDA
toolkit's ``nvcc`` and a card; the source is built into ``ops/_build/``
as the kernels are.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.tools.timing import PEAK_BF16_FLOPS, PEAK_TF32_FLOPS

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int KIND>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if (KIND == 0)
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
  else
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

// iters rounds of one product into each of NACC accumulators
template <int KIND, int NACC>
__global__ void products(float* out, int iters) {
  float c[NACC][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int n = 0; n < NACC; ++n) mma<KIND>(c[n], a, b0, b1);
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < NACC; ++n) s += c[n][0] + c[n][1] + c[n][2] + c[n][3];
  if (s == 1234.5f) out[0] = s;      // keeps the products live
}

template <int KIND, int NACC>
static int run(int blocks, int warps, int iters, float* out, float* ms) {
  products<KIND, NACC><<<blocks, warps * 32>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  products<KIND, NACC><<<blocks, warps * 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}

// kind 0: TF32 m16n8k8, 1: bf16 m16n8k16; nacc 8 or 16 accumulators
extern "C" int mma_rate(int kind, int nacc, int blocks, int warps, int iters,
                        float* out, float* ms) {
  if (kind == 0)
    return nacc == 8 ? run<0, 8>(blocks, warps, iters, out, ms)
                     : run<0, 16>(blocks, warps, iters, out, ms);
  return nacc == 8 ? run<1, 8>(blocks, warps, iters, out, ms)
                   : run<1, 16>(blocks, warps, iters, out, ms);
}
"""

ITERS = 4096
WARPS = 8


def build() -> ctypes.CDLL:
    """The rate kernels' library, built with ``_build.NVCC_FLAGS``."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "mma_rate.cu")
    so = os.path.join(_build.BUILD_DIR, "libmma_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.mma_rate.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.mma_rate.restype = ctypes.c_int
    return lib


def main() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mma_rate: no CUDA device")
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    rows = []
    for kind, name, k, peak in ((0, "tf32 m16n8k8", 8, PEAK_TF32_FLOPS),
                                (1, "bf16 m16n8k16", 16, PEAK_BF16_FLOPS)):
        for nacc in (8, 16):
            for per_sm in (1, 2):
                ms = ctypes.c_float()
                err = lib.mma_rate(kind, nacc, sms * per_sm, WARPS, ITERS,
                                   ctypes.c_void_p(out.data_ptr()),
                                   ctypes.byref(ms))
                if err:
                    raise RuntimeError(f"mma_rate: CUDA error {err}")
                flops = (2.0 * 16 * 8 * k * ITERS * nacc * WARPS * sms
                         * per_sm)
                rate = flops / (ms.value * 1e-3)
                rows.append(dict(product=name, accumulators=nacc,
                                 blocks_per_sm=per_sm, ms=ms.value,
                                 tflops=rate / 1e12,
                                 share_of_peak=rate / peak))
                print(f"{name}: {nacc} accumulators a warp, {per_sm} "
                      f"block(s) of {WARPS} warps an SM: "
                      f"{rate / 1e12:.1f} TFLOP/s, {rate / peak:.1%} of the "
                      f"{peak / 1e12:.0f} TFLOP/s peak", flush=True)
    best = {name: max(r["tflops"] for r in rows if r["product"] == name)
            for name in ("tf32 m16n8k8", "bf16 m16n8k16")}
    result = {"device": torch.cuda.get_device_name(0), "rows": rows,
              "best_tflops": best,
              "tf32x3_ceiling_tflops": best["tf32 m16n8k8"] / 3}
    print(json.dumps({"mma_rate": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
