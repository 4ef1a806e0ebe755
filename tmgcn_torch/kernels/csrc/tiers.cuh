// Precision tiers of the windowed segment kernels (K1, K3), shared by their
// sources.
//
// float32: each product rounded to float32, then added in float32.
// bfloat16: the value is rounded to bf16 and the gathered features arrive in
// bf16 (the JAX package casts X before the gather); their product is exact
// in float32, is rounded to bf16 (the TPU kernels' bf16 `g * v` and
// `.astype(g_ref.dtype)`), then added in float32. The output is float32.
#pragma once

#include <cuda_bf16.h>

template <typename T>
struct Tier;

template <>
struct Tier<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Tier<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};
