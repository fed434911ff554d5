// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace mt {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch and XLA
}

// 2^x on the special-function unit, one MUFU op (subnormal results flush to
// zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cp.async copies global -> shared of 16 or 4 bytes; ok false writes zeros
// (src is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// value rounded to T's precision and widened back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// the half-split rotation of the pair (x1, x2) = (x[d], x[d + D/2]) at the
// position's cos/sin (f32 tables), in f32 with the tables rounded to bf16
// first, rounded once to bf16 (two lanes at a time). K2 and K4 rotate by it.
__device__ __forceinline__ void rope_pair(__nv_bfloat162& a, __nv_bfloat162& b, float2 c,
                                          float2 s) {
  const float c0 = round_to<__nv_bfloat16>(c.x), c1 = round_to<__nv_bfloat16>(c.y);
  const float s0 = round_to<__nv_bfloat16>(s.x), s1 = round_to<__nv_bfloat16>(s.y);
  const float2 x1 = __bfloat1622float2(a), x2 = __bfloat1622float2(b);
  a = __floats2bfloat162_rn(__fsub_rn(__fmul_rn(x1.x, c0), __fmul_rn(x2.x, s0)),
                            __fsub_rn(__fmul_rn(x1.y, c1), __fmul_rn(x2.y, s1)));
  b = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(x2.x, c0), __fmul_rn(x1.x, s0)),
                            __fadd_rn(__fmul_rn(x2.y, c1), __fmul_rn(x1.y, s1)));
}

// the same rotation in f32 (each product and the sum rounded, as torch's
// elementwise ops do)
__device__ __forceinline__ void rope_pair(float2& a, float2& b, float2 c, float2 s) {
  const float2 x1 = a, x2 = b;
  a = make_float2(__fsub_rn(__fmul_rn(x1.x, c.x), __fmul_rn(x2.x, s.x)),
                  __fsub_rn(__fmul_rn(x1.y, c.y), __fmul_rn(x2.y, s.y)));
  b = make_float2(__fadd_rn(__fmul_rn(x2.x, c.x), __fmul_rn(x1.x, s.x)),
                  __fadd_rn(__fmul_rn(x2.y, c.y), __fmul_rn(x1.y, s.y)));
}

}  // namespace mt
