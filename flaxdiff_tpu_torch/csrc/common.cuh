// Shared helpers for the port's Hopper kernels: dtype codes, float
// conversion and 16-byte vector access.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// Codes passed from the Python wrappers (flaxdiff_tpu_torch/ops/_build.py).
enum DTypeCode : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// N consecutive elements moved as one access (16 bytes when N * sizeof(T) == 16).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, N>& v) {
  *reinterpret_cast<Vec<T, N>*>(p) = v;
}

// Elements per 16-byte access.
template <typename T>
__host__ __device__ constexpr int vec16() { return 16 / static_cast<int>(sizeof(T)); }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// Grid size for a grid-stride loop over `work` items: enough blocks to fill
// every SM several times over, never more than the work needs.
inline int grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}
