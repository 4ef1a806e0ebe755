// Precision tiers of the windowed segment kernels (K1, K3), shared by their
// sources. A tier is a tag type: the type the kernel reads its gathered
// features in (In), and where it rounds. Each term of a sum is
//
//   product(value(v) * feature(x)),  the multiply rounded to float32,
//
// and the terms are added in float32; the output is float32.
//
// F32: nothing else is rounded.
// Bf16: the gathered features arrive in bf16 (the JAX package casts X before
//   the gather) and the value is rounded to bf16; their product is exact in
//   float32 and is rounded to bf16 (the TPU kernels' bf16 `g * v` and
//   `.astype(g_ref.dtype)`).
// F32FastK1: K1's fast tier, float32 chunks at the TPU's DEFAULT matrix
//   precision (tmgcn_tpu/kernels/spmm_pallas.py:608-647, "DEFAULT rounds the
//   value operand to bf16"): the float32 product g * v of the vector unit,
//   rounded to bf16 by the one-hot matmul, whose one-hot side is exact. The
//   value and the features are not rounded before the multiply.
// F32FastK3: K3's fast tier, float32 tile blocks at DEFAULT (:510-557): the
//   expand matmul rounds both of its operands, the value and the features,
//   to bf16 (their product is exact in float32), and the scatter matmul
//   rounds that product to bf16. Bf16's arithmetic on float32 features
//   rounded on load.
//
// The fast tiers follow the JAX code's own account of DEFAULT; interpret
// mode on a CPU computes float32 there, so only a TPU shows what it does.
#pragma once

#include <cuda_bf16.h>

namespace tier {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct F32 {
  using In = float;
  static __device__ __forceinline__ float value(float v) { return v; }
  static __device__ __forceinline__ float feature(float x) { return x; }
  static __device__ __forceinline__ float product(float p) { return p; }
};

struct Bf16 {
  using In = __nv_bfloat16;
  static __device__ __forceinline__ float value(float v) { return round_bf16(v); }
  static __device__ __forceinline__ float feature(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float product(float p) { return round_bf16(p); }
};

struct F32FastK1 {
  using In = float;
  static __device__ __forceinline__ float value(float v) { return v; }
  static __device__ __forceinline__ float feature(float x) { return x; }
  static __device__ __forceinline__ float product(float p) { return round_bf16(p); }
};

struct F32FastK3 {
  using In = float;
  static __device__ __forceinline__ float value(float v) { return round_bf16(v); }
  static __device__ __forceinline__ float feature(float x) { return round_bf16(x); }
  static __device__ __forceinline__ float product(float p) { return round_bf16(p); }
};

}  // namespace tier
