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

constexpr int WARPS = 4;                 // every kernel runs 128 threads
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS_PER_WARP = 4;     // query rows of one block <= 16

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy one page's rows for one KV group into shared memory as fp32.
// Token t of the page sits at src + t * row_stride (elements), Dh
// contiguous elements each. 16-byte vector loads: Dh * sizeof(T) is a
// multiple of 16 and the pool base is 16-byte aligned (the wrapper checks).
// dst row stride is dst_stride floats (Dh + 1 pads the K rows so that lane
// t reading row t hits bank (t + d) % 32).
template <typename T>
__device__ __forceinline__ void load_page(float* __restrict__ dst,
                                          int dst_stride,
                                          const T* __restrict__ src,
                                          size_t row_stride, int ps, int Dh) {
  constexpr int EPC = 16 / sizeof(T);    // elements per 16-byte chunk
  const int cpr = Dh / EPC;              // chunks per row
  for (int i = threadIdx.x; i < ps * cpr; i += blockDim.x) {
    const int t = i / cpr;
    const int c = i - t * cpr;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + t * row_stride + c * EPC);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + t * dst_stride + c * EPC;
#pragma unroll
    for (int j = 0; j < EPC; ++j) d[j] = to_f32(e[j]);
  }
}

// One online-softmax update of ``rows`` query rows (this warp's share)
// against the ps tokens of one page held in shared memory.
//
//   q_s   : rows of the block, Dh floats each (row r at q_s + r * Dh)
//   k_s   : ps rows, stride Dh + 1;  v_s : ps rows, stride Dh
//   limit : per row, the last key position it may see (inclusive);
//           tokens of this page are tok0 .. tok0 + ps - 1
//
// A probability is forced to 0 while the row's running max is still at
// NEG_INF (the dead-split / dead-row guard), so fully masked rows and
// splits keep l = 0 and acc = 0.
template <int DPL>
__device__ __forceinline__ void attend_page(
    const float* __restrict__ q_s, const float* __restrict__ k_s,
    const float* __restrict__ v_s, int ps, int Dh, int tok0,
    const int (&limit)[MAX_ROWS_PER_WARP], int first_row, int nrows,
    float scale,
    float (&m)[MAX_ROWS_PER_WARP], float (&l)[MAX_ROWS_PER_WARP],
    float (&acc)[MAX_ROWS_PER_WARP][DPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ri = 0; ri < MAX_ROWS_PER_WARP; ++ri) {
    const int r = first_row + ri * WARPS;
    if (r >= nrows) continue;  // warp-uniform: the whole warp skips
    const float* qr = q_s + r * Dh;
    for (int t0 = 0; t0 < ps; t0 += 32) {
      const int t = t0 + lane;
      float s = NEG_INF;
      if (t < ps && tok0 + t <= limit[ri]) {
        const float* kr = k_s + t * (Dh + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m[ri], warp_max(s));
      const float p =
          (t < ps && m_new > MASKED_M_THRESHOLD) ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[ri] - m_new);
      l[ri] = l[ri] * alpha + warp_sum(p);
      m[ri] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[ri][j] *= alpha;
      const int nt = min(32, ps - t0);
      for (int tt = 0; tt < nt; ++tt) {
        const float pt = __shfl_sync(0xffffffffu, p, tt);
        const float* vr = v_s + (t0 + tt) * Dh + lane;
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          acc[ri][j] = fmaf(pt, vr[32 * j], acc[ri][j]);
      }
    }
  }
}

}  // namespace attn
