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

// value rounded to T's precision and widened back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

}  // namespace mt
