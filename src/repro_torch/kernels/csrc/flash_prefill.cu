// Causal GQA flash attention for prefill, for Hopper (sm_90a).
//
// Replaces the Pallas kernel flash_prefill of
// src/repro/kernels/flash_prefill.py (_kernel).
//
// Contract (as the reference): q (B, Sq, H, Dh); k/v (B, Sk, G, Dh) fp32 or
// bf16; query i sits at absolute position q_offset + i (chunked prefill:
// the queries are the tail of the key range); key k is valid for query i
// iff k <= q_offset + i and k < kv_len. Output (B, Sq, H, Dh) in q's type.
// Unlike the Pallas kernel, Sq and Sk need not divide by any block size:
// every block masks its ragged edge itself.
//
// Design: one block per (query block, KV group, batch). Its ROWS = 64 rows
// are BQ = 64 / rep query positions times the rep query heads of group g,
// which share every K/V tile. The block loops over KV tiles of KEY_TILE
// keys up to the causal limit of its last query (this loop replaces the
// Pallas grid's sequential ki axis), so no tile beyond the diagonal is
// read. Q (transposed), K (transposed) and V tiles and the tile's
// probabilities sit in shared memory as fp32; scores, the running max m,
// the denominator l and the accumulator stay in registers in fp32.
//
// Thread layout (128 threads): lane l of warp w owns rows
// rg * 4 .. rg * 4 + 3 with rg = 4 w + l / 8, and, with c = l % 8, the keys
// c * 4 .. c * 4 + 3 of a tile for the scores and the head dims
// {c * 4 + 32 j + e} for the output. The 8 lanes of a row group combine
// their partial row max and row sum with shuffles. Every shared-memory
// read in the inner loops is a broadcast or 32 consecutive floats.
//
// Bound: operations at the serving path's chunk shapes (4 * Dh flops per
// valid (query head, key) pair over 989 bf16 TFLOP/s). This first version
// runs fp32 FMAs on the CUDA cores (67 TFLOP/s); mma.sync / wgmma tiles on
// the tensor cores are later work.
#include "attn_common.cuh"

using namespace attn;

namespace {

constexpr int ROWS = 64;            // query rows (positions x heads) a block
constexpr int KEY_TILE = 32;        // keys staged per step
constexpr int QS = ROWS + 4;        // qT / pT row stride (floats)
constexpr int KS = KEY_TILE + 4;    // kT row stride (floats)

template <typename T, int Dh>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
    int G, int q_offset, int kv_end, float scale) {
  constexpr int DPT = Dh / 8;       // output dims per thread
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = Dh / EPC;     // 16-byte chunks per row
  const int rep = H / G;
  const int BQ = ROWS / rep;
  const int q0 = blockIdx.x * BQ, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp * 4 + (lane >> 3), c = lane & 7;

  extern __shared__ float smem[];
  float* qT = smem;                 // [Dh][QS]: qT[d][row]
  float* kT = qT + Dh * QS;         // [Dh][KS]: kT[d][key]
  float* v_s = kT + Dh * KS;        // [KEY_TILE][Dh]
  float* pT = v_s + KEY_TILE * Dh;  // [KEY_TILE][QS]: pT[key][row]

  // Q rows of the block, transposed; rows past Sq are zeros. Row r is
  // query q0 + r / rep, head g * rep + r % rep.
  for (int i = threadIdx.x; i < ROWS * CPR; i += blockDim.x) {
    const int r = i % ROWS, ch = i / ROWS;
    const int qi = q0 + r / rep;
    float vals[EPC];
    if (qi < Sq) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + qi) * H + g * rep + r % rep) * Dh +
          ch * EPC);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < EPC; ++j) vals[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < EPC; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < EPC; ++j) qT[(ch * EPC + j) * QS + r] = vals[j];
  }

  // the last key any row of this block may see
  const int q_last = min(Sq, q0 + BQ) - 1;
  const int key_end = min(kv_end, q_offset + q_last + 1);
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + (rg * 4 + i) / rep;
    qpos[i] = qi < Sq ? q_offset + qi : -1;   // -1: a dead row
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const size_t kv_row = (size_t)G * Dh;
  const T* k_base = k + ((size_t)b * Sk * G + g) * Dh;
  const T* v_base = v + ((size_t)b * Sk * G + g) * Dh;
  for (int k0 = 0; k0 < key_end; k0 += KEY_TILE) {
    const int nk = min(KEY_TILE, key_end - k0);
    __syncthreads();  // Q staged / the previous tile fully consumed
    // K transposed (key fastest across threads: conflict-free stores)
    for (int i = threadIdx.x; i < KEY_TILE * CPR; i += blockDim.x) {
      const int key = i % KEY_TILE, ch = i / KEY_TILE;
      float vals[EPC];
      if (key < nk) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            k_base + (size_t)(k0 + key) * kv_row + ch * EPC);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < EPC; ++j) vals[j] = to_f32(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < EPC; ++j) vals[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < EPC; ++j) kT[(ch * EPC + j) * KS + key] = vals[j];
    }
    // V as is (rows past nk are never read)
    for (int i = threadIdx.x; i < nk * CPR; i += blockDim.x) {
      const int key = i / CPR, ch = i % CPR;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          v_base + (size_t)(k0 + key) * kv_row + ch * EPC);
      const T* e = reinterpret_cast<const T*>(&raw);
      float* d = v_s + key * Dh + ch * EPC;
#pragma unroll
      for (int j = 0; j < EPC; ++j) d[j] = to_f32(e[j]);
    }
    __syncthreads();

    // scores of rows rg*4+i against keys c*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * QS + rg * 4);
      const float4 kk = *reinterpret_cast<const float4*>(kT + d * KS + c * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + c * 4 + j;
        s[i][j] = (key < key_end && key <= qpos[i]) ? s[i][j] * scale
                                                     : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = m_new > MASKED_M_THRESHOLD ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (c * 4 + j) * QS + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha[i];
    for (int key = 0; key < nk; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(pT + key * QS +
                                                        rg * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < DPT / 4; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(
            v_s + key * Dh + c * 4 + 32 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * j + 0] = fmaf(pv[i], vv.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(pv[i], vv.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pv[i], vv.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pv[i], vv.w, acc[i][4 * j + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    const int qi = q0 + r / rep;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], DENOM_EPS);
    T* o = out + (((size_t)b * Sq + qi) * H + g * rep + r % rep) * Dh;
#pragma unroll
    for (int j = 0; j < DPT / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[c * 4 + 32 * j + e] = from_f32<T>(acc[i][4 * j + e] * inv);
  }
}

template <typename T, int Dh>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int G,
                         int q_offset, int kv_end, float scale,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(Dh * QS + Dh * KS + KEY_TILE * Dh +
                               KEY_TILE * QS);
  auto kernel = flash_prefill_kernel<T, Dh>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int bq = ROWS / (H / G);
  dim3 grid((Sq + bq - 1) / bq, G, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, G,
      q_offset, kv_end, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int G,
                        int q_offset, int kv_end, float scale,
                        cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch_flash<T, 32>(q, k, v, out, B, Sq, Sk, H, G, q_offset,
                                 kv_end, scale, stream);
    case 64:
      return launch_flash<T, 64>(q, k, v, out, B, Sq, Sk, H, G, q_offset,
                                 kv_end, scale, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, out, B, Sq, Sk, H, G, q_offset,
                                  kv_end, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// grid (ceil(Sq / (64 / rep)), G, B); out (B, Sq, H, Dh). kv_end is
// min(Sk, kv_len).
int flash_prefill_launch(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int G,
                         int Dh, int q_offset, int kv_end, float scale,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (H % G || (ROWS % (H / G)) != 0)
    e = cudaErrorInvalidValue;
  else if (dtype == DTYPE_F32)
    e = dispatch_dh<float>(Dh, q, k, v, out, B, Sq, Sk, H, G, q_offset,
                           kv_end, scale, st);
  else if (dtype == DTYPE_BF16)
    e = dispatch_dh<__nv_bfloat16>(Dh, q, k, v, out, B, Sq, Sk, H, G,
                                   q_offset, kv_end, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
