// Shared device helpers for the repro_torch kernels (sm_90a).
//
// The kernels load every element type as float and accumulate in f32,
// as the TPU kernels they replace did.  Warp reductions use
// __shfl_xor_sync: the hardware form of the warp collectives
// (red_add / red_max) that COX rebuilds on the CPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (kernels/build.py)
enum CoxDType { COX_F32 = 0, COX_BF16 = 1, COX_F16 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// A max that propagates NaN, as jnp.max and torch.amax do (fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// 16-byte vectors: 4 floats or 8 half-width values per load/store.
template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ T get(int i) const {
    return reinterpret_cast<const T*>(&raw)[i];
  }
  __device__ __forceinline__ void set(int i, T v) { reinterpret_cast<T*>(&raw)[i] = v; }
};

template <typename T> __device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr unsigned FULL_MASK = 0xffffffffu;
