// Elements of float32, bf16 or float16 as float, for the kernels with
// 16-bit instances (flash_common.cuh, rnn_step.cu, bn_stats.cu,
// conv_bn.cu): every overload for float is the identity, so the float32
// instances compile to the code they had before the bf16 ones.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// Four bf16 held in 8 bytes as floats.
__device__ __forceinline__ float4 bf16x4_to_f(uint2 u) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four consecutive elements at p as floats: one 16-byte load of float32,
// one 8-byte load of bf16; ldg4 the same through the read-only cache.
// (The float16 instances read one element a lane, to_f.)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return bf16x4_to_f(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return bf16x4_to_f(__ldg(reinterpret_cast<const uint2*>(p)));
}
