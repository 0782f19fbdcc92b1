// The warp-level 16-bit tensor-core building blocks that the hand-written
// kernels share (flash_variants.cu, the forward sweep; flash_fwd.cu,
// flash_bwd.cu and conv_bn.cu at bf16 and float16; the copies also serve
// the float32 kernels): cp.async copies into shared memory (with a
// zero-filling form at an immediate offset, and the compile-time loop that
// unrolls a thread's copies), ldmatrix (plain and transposed) fragment
// loads, which move 16-bit lanes whatever their type, mma.sync m16n8k16
// bf16 or f16 -> float32, and the packing of two floats into a bf16 or f16
// pair, which re-packs a float32 accumulator as the A operand of the next
// product in registers.  Elem16<E> selects the product and the packing by element
// type, so one kernel template serves both.  PTX for sm_80 and later;
// every build here targets sm_90a.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace mma {

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), c 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a . b on the tensor cores: a 16 x 16 f16 (row), b 16 x 8 f16 (col),
// c 16 x 8 float32.
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as an f16 pair, `lo` in the low half, each rounded to
// nearest (a value below f16's range rounds to a subnormal or 0).
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 16-bit element type E of a tensor-core kernel: its product (mma),
// the packing of two floats as an E pair (pack) and one float as E (from).
template <typename E>
struct Elem16;
template <>
struct Elem16<bf16> {
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
  static __device__ __forceinline__ bf16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Elem16<f16> {
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_f16(c, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
  static __device__ __forceinline__ f16 from(float v) {
    return __float2half_rn(v);
  }
};

// The narrower copies of the same kind: 8 bytes (a row of bf16 that is
// only 8-byte aligned) and 4 bytes (one float), through L1 (cp.async.cg
// takes 16 bytes only).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

// kBytes (16, 8 or 4) from src to the shared address smem + kOff, or zeros
// where !ok (a source size of 0 reads nothing; src must still be a valid
// address).  The immediate offset lets one base address serve a thread's
// rows.
template <int kBytes, int kOff>
__device__ __forceinline__ void copy_or_zero(uint32_t smem, const void* src,
                                             bool ok) {
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4,
                "16-, 8- or 4-byte copies");
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0+%3], [%1], 16, %2;\n" ::"r"(
                     smem),
                 "l"(src), "r"(ok ? 16 : 0), "n"(kOff)
                 : "memory");
  else if constexpr (kBytes == 8)
    asm volatile("cp.async.ca.shared.global [%0+%3], [%1], 8, %2;\n" ::"r"(
                     smem),
                 "l"(src), "r"(ok ? 8 : 0), "n"(kOff)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0+%3], [%1], 4, %2;\n" ::"r"(
                     smem),
                 "l"(src), "r"(ok ? 4 : 0), "n"(kOff)
                 : "memory");
}

// f(std::integral_constant<int, i>) for i = 0 .. N-1, i a constant in f
template <class F, int... I>
__device__ __forceinline__ void static_for_impl(
    F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

}  // namespace mma
