// Shared helpers for the port's CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Finite masked-score sentinel, as in the Pallas kernels: a fully masked
// row softmaxes to the uniform mean of v instead of NaN.
constexpr float kNegInf = -1e30f;

// dtype codes passed by the Python wrappers.
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Element strides of one (batch, head, sequence) indexed operand whose
// last (feature) dimension is contiguous.
struct Strides3 {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

}  // namespace repro_torch

// Message for a cudaError_t code returned by an entry point.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
