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

// Head blocks of one (tile, KV group) (ops.head_split): a tile of bq
// query positions of a group of rep heads holds bq * rep (row, head)
// pairs; where they are more than max_pairs, the rep heads split into hb
// blocks of at most hpc heads, each a CTA (the last may hold fewer).
struct HeadSplit {
  int hb, hpc;
};
__host__ __device__ inline HeadSplit head_split(int rep, int bq,
                                                int max_pairs) {
  const int fit = bq > 0 ? max_pairs / bq : max_pairs;
  const int per = fit > 1 ? fit : 1;                // heads beside bq rows
  const int hb = (rep + per - 1) / per;
  return {hb, (rep + hb - 1) / hb};
}

// The (row, head) pairs one CTA holds: pair i is query position i / hc of
// its tile, head h0 + i % hc, for the hc heads h0 .. of head block hb of
// group g (grid index g * hb_count + hb).
struct HeadBlock {
  int g, h0, hc;
  __device__ static HeadBlock split(int y, int rep, HeadSplit hs) {
    const int hb = y % hs.hb;
    return {y / hs.hb, (y / hs.hb) * rep + hb * hs.hpc,
            min(hs.hpc, rep - hb * hs.hpc)};
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace attn
