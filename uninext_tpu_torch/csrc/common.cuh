// Shared helpers of the package's kernels: dtype codes, float conversion,
// and the error-string entry point every library exports.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (ops/_build.py callers)
#define UNINEXT_F32 0
#define UNINEXT_BF16 1

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

extern "C" const char* uninext_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
