// Shared conventions of the port's attention kernels (sm_90a).
//
// The constants mirror repro_torch/kernels/ops.py: scores, running max m,
// denominator l and accumulator acc are fp32; masked scores are NEG_INF;
// a running max at or below MASKED_M_THRESHOLD means "no valid token seen";
// the output is acc / max(l, DENOM_EPS).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr float DENOM_EPS = 1e-20f;
constexpr float MASKED_M_THRESHOLD = NEG_INF * 0.5f;

// dtype codes passed over the C interface
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace attn
