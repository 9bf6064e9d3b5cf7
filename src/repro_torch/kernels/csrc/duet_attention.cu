// Fused mixed-phase (duet) attention over the slab KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel duet_attention of
// src/repro/kernels/duet_attention.py (_kernel, _attend_tile, _write_tile).
//
// Contract (as the reference): q (T*bq, H, Dh) query rows grouped in tiles
// of bq rows; row_pos (T*bq,) int32 absolute position per row (-1 = pad
// row); tile_slot (T,) int32 slab slot per tile (-1 = pad tile); k/v slab
// (Ns, S, G, Dh) fp32 or bf16. Row i of tile t attends causally over slot
// tile_slot[t]: key position k is valid iff k <= row_pos[i] and the tile
// and row are live. Decode rows and the prefill chunk's rows run in ONE
// launch.
//
// Design: the paged kernel (duet_attention_paged.cu) with slab addressing.
// One block per (tile, KV group) holds the tile's bq * rep query rows of
// that group in shared memory and walks the slot's keys KEY_TILE at a time
// (K/V rows of the group staged in shared memory as fp32, online softmax
// per row in fp32, attn_common.cuh). Key k of the slot sits at
// (slot * S + k) * G * Dh: no table lookup. The Pallas grid walks all S
// keys in block_k steps; this kernel stops after the tile holding the
// tile's largest row_pos, so a decode row at position p reads p + 1 keys
// and not S. Pad rows and pad tiles see no valid key; the dead-row guard
// keeps their l = 0 and acc = 0, so they come out as zeros (the reference
// kernel leaves the mean of V there; only unpacked rows are ever read).
//
// Bound: memory, the live KV bytes (each tile's keys 0..max row_pos of its
// group) at 3.35 TB/s. Tiles of one slot re-read its keys once per tile.
#include "attn_common.cuh"

using namespace attn;

constexpr int KEY_TILE = 64;  // keys staged per step (shared memory)

template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS) duet_attention_kernel(
    const T* __restrict__ q, const int* __restrict__ row_pos,
    const int* __restrict__ tile_slot, const T* __restrict__ k_slab,
    const T* __restrict__ v_slab, T* __restrict__ out, int H, int G, int S,
    int bq, float scale) {
  constexpr int Dh = DPL * 32;
  const int t = blockIdx.x, g = blockIdx.y;
  const int rep = H / G;
  const int nrows = bq * rep;            // block row i: tile row i / rep,
                                         // head g * rep + i % rep
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ float smem[];
  float* q_s = smem;                     // nrows rows of Dh
  float* k_s = q_s + nrows * Dh;         // KEY_TILE rows, stride Dh + 1
  float* v_s = k_s + KEY_TILE * (Dh + 1);  // KEY_TILE rows, stride Dh

  for (int i = threadIdx.x; i < nrows * Dh; i += blockDim.x) {
    const int row = i / Dh, d = i - row * Dh;
    const int r = row / rep, j = row - r * rep;
    q_s[i] = to_f32(q[((size_t)(t * bq + r) * H + g * rep + j) * Dh + d]);
  }

  const int slot = tile_slot[t];
  int maxpos = -1;
  if (slot >= 0)
    for (int r = 0; r < bq; ++r) maxpos = max(maxpos, row_pos[t * bq + r]);

  int limit[MAX_ROWS_PER_WARP];
  float m[MAX_ROWS_PER_WARP], l[MAX_ROWS_PER_WARP];
  float acc[MAX_ROWS_PER_WARP][DPL];
#pragma unroll
  for (int ri = 0; ri < MAX_ROWS_PER_WARP; ++ri) {
    const int row = warp + ri * WARPS;
    limit[ri] = (slot >= 0 && row < nrows) ? row_pos[t * bq + row / rep] : -1;
    m[ri] = NEG_INF;
    l[ri] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[ri][j] = 0.f;
  }

  // keys 0 .. n_keys - 1 can be valid for some row of this tile
  const int n_keys = maxpos < 0 ? 0 : min(S, maxpos + 1);
  const size_t row_stride = (size_t)G * Dh;
  const T* k_base = k_slab + ((size_t)max(slot, 0) * S * G + g) * Dh;
  const T* v_base = v_slab + ((size_t)max(slot, 0) * S * G + g) * Dh;
  for (int k0 = 0; k0 < n_keys; k0 += KEY_TILE) {
    const int nk = min(KEY_TILE, n_keys - k0);
    __syncthreads();  // q_s written / the previous tile consumed
    load_page<T>(k_s, Dh + 1, k_base + k0 * row_stride, row_stride, nk, Dh);
    load_page<T>(v_s, Dh, v_base + k0 * row_stride, row_stride, nk, Dh);
    __syncthreads();
    attend_page<DPL>(q_s, k_s, v_s, nk, Dh, k0, limit, warp, nrows, scale, m,
                     l, acc);
  }

#pragma unroll
  for (int ri = 0; ri < MAX_ROWS_PER_WARP; ++ri) {
    const int row = warp + ri * WARPS;
    if (row >= nrows) continue;
    const int r = row / rep, j = row - r * rep;
    const float denom = fmaxf(l[ri], DENOM_EPS);
    T* o = out + ((size_t)(t * bq + r) * H + g * rep + j) * Dh;
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj)
      o[lane + 32 * jj] = from_f32<T>(acc[ri][jj] / denom);
  }
}

template <typename T, int DPL>
static cudaError_t launch_duet(const void* q, const int* row_pos,
                               const int* tile_slot, const void* k,
                               const void* v, void* out, int T_, int bq,
                               int H, int G, int S, float scale,
                               cudaStream_t stream) {
  constexpr int Dh = DPL * 32;
  const int nrows = bq * (H / G);
  const size_t smem = sizeof(float) * (size_t)(nrows * Dh +
                                               KEY_TILE * (Dh + 1) +
                                               KEY_TILE * Dh);
  auto kernel = duet_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(T_, G), THREADS, smem, stream>>>(
      static_cast<const T*>(q), row_pos, tile_slot, static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, G, S, bq, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_dh(int Dh, const void* q, const int* row_pos,
                               const int* tile_slot, const void* k,
                               const void* v, void* out, int T_, int bq,
                               int H, int G, int S, float scale,
                               cudaStream_t stream) {
#define DA_CASE(DH)                                                        \
  case DH:                                                                 \
    return launch_duet<T, DH / 32>(q, row_pos, tile_slot, k, v, out, T_,   \
                                   bq, H, G, S, scale, stream);
  switch (Dh) {
    DA_CASE(32)
    DA_CASE(64)
    DA_CASE(128)
    DA_CASE(256)
  }
#undef DA_CASE
  return cudaErrorInvalidValue;
}

extern "C" {

// grid (T, G); out (T*bq, H, Dh).
int duet_attention_launch(const void* q, const void* row_pos,
                          const void* tile_slot, const void* k, const void* v,
                          void* out, int T_, int bq, int H, int G, int Dh,
                          int S, float scale, int dtype, void* stream) {
  const int* rp = static_cast<const int*>(row_pos);
  const int* ts = static_cast<const int*>(tile_slot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DTYPE_F32)
    e = dispatch_dh<float>(Dh, q, rp, ts, k, v, out, T_, bq, H, G, S, scale,
                           st);
  else if (dtype == DTYPE_BF16)
    e = dispatch_dh<__nv_bfloat16>(Dh, q, rp, ts, k, v, out, T_, bq, H, G, S,
                                   scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
