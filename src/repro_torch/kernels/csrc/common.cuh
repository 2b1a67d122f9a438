// Shared helpers of the port's elementwise Hopper kernels.
//
// The kernels are built with --fmad=false (see kernels/_build.py): every
// multiply and add rounds on its own, as the plain PyTorch versions and the
// reference's op-by-op f32 arithmetic do, so kernel and plain version agree
// bit for bit on the same inputs.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, NaN stays NaN
}

// Elements of T in one 16-byte access.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 16-byte loads/stores of V consecutive elements; the caller guarantees
// 16-byte alignment (the Python wrappers check every pointer).
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ src, T (&dst)[V]) {
  static_assert((V * sizeof(T)) % 16 == 0, "whole 16-byte words only");
#pragma unroll
  for (int j = 0; j < V * (int)sizeof(T) / 16; ++j)
    reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(src)[j];
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ dst, const T (&src)[V]) {
#pragma unroll
  for (int j = 0; j < V * (int)sizeof(T) / 16; ++j)
    reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(src)[j];
}

// Grid size for a grid-stride loop over n_vec vectors: enough blocks to
// fill every SM several times over, never more than there is work.
inline int grid_blocks(int64_t n_vec, int threads) {
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (sm_count <= 0) sm_count = 132;
  }
  int64_t want = (n_vec + threads - 1) / threads;
  int64_t cap = (int64_t)sm_count * 8;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

}  // namespace rt
