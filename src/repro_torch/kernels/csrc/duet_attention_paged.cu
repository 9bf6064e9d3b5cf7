// Fused mixed-phase (duet) attention over the paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel duet_attention_paged of
// src/repro/kernels/duet_attention.py (_paged_kernel, _attend_tile,
// _write_tile).
//
// Contract (as the reference): q (T*bq, H, Dh) query rows grouped in tiles
// of bq rows; row_pos (T*bq,) int32 absolute position per row (-1 = pad
// row); tile_slot (T,) int32 row of ``tables`` per tile (-1 = pad tile);
// k/v pages (N,ps,G,Dh) fp32 or bf16; tables (B,P) int32. Row i of tile t
// attends causally over its tile's page chain: key position k is valid iff
// k <= row_pos[i] and the tile and row are live. Decode rows and the
// prefill chunk's rows run in ONE launch.
//
// Design: one block per (tile, KV group) holds the tile's bq * rep query
// rows of that group in shared memory and walks the tile's table row a page
// at a time (K/V rows of the group staged in shared memory as fp32, online
// softmax per row in fp32, as in paged_decode.cu). It stops after the page
// holding the tile's largest row_pos: later keys are masked for every row.
// Pad rows and pad tiles see no valid key; the dead-row guard keeps their
// l = 0 and acc = 0, so they come out as zeros (the reference kernel leaves
// the mean of V there; only unpacked rows are ever read). Tile order is
// scheduling only: every block computes its rows independently, so the
// numerics do not depend on it.
//
// Bound: memory for the unique KV bytes; this simple kernel re-reads a
// chain once per tile (each prefill row of the engine's bq = 1 layout is
// its own tile), so it moves more than the bound counts.
#include "attn_common.cuh"

using namespace attn;

template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS) duet_attention_paged_kernel(
    const T* __restrict__ q, const int* __restrict__ row_pos,
    const int* __restrict__ tile_slot, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    T* __restrict__ out, int H, int G, int ps, int P, int bq, float scale) {
  constexpr int Dh = DPL * 32;
  const int t = blockIdx.x, g = blockIdx.y;
  const int rep = H / G;
  const int nrows = bq * rep;            // block row i: tile row i / rep,
                                         // head g * rep + i % rep
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ float smem[];
  float* q_s = smem;                     // nrows rows of Dh
  float* k_s = q_s + nrows * Dh;         // ps rows, stride Dh + 1
  float* v_s = k_s + ps * (Dh + 1);      // ps rows, stride Dh

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

  const int n_pages = maxpos < 0 ? 0 : min(P, maxpos / ps + 1);
  const int* trow = tables + (size_t)max(slot, 0) * P;
  const size_t row_stride = (size_t)G * Dh;
  for (int p = 0; p < n_pages; ++p) {
    const size_t base = ((size_t)trow[p] * ps * G + g) * Dh;
    __syncthreads();  // q_s written / the previous page consumed
    load_page<T>(k_s, Dh + 1, k_pages + base, row_stride, ps, Dh);
    load_page<T>(v_s, Dh, v_pages + base, row_stride, ps, Dh);
    __syncthreads();
    attend_page<DPL>(q_s, k_s, v_s, ps, Dh, p * ps, limit, warp, nrows,
                     scale, m, l, acc);
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
                               const void* v, const int* tables, void* out,
                               int T_, int bq, int H, int G, int ps, int P,
                               float scale, cudaStream_t stream) {
  constexpr int Dh = DPL * 32;
  const int nrows = bq * (H / G);
  const size_t smem = sizeof(float) * (size_t)(nrows * Dh + ps * (Dh + 1) +
                                               ps * Dh);
  auto kernel = duet_attention_paged_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(T_, G), THREADS, smem, stream>>>(
      static_cast<const T*>(q), row_pos, tile_slot, static_cast<const T*>(k),
      static_cast<const T*>(v), tables, static_cast<T*>(out), H, G, ps, P,
      bq, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_dh(int Dh, const void* q, const int* row_pos,
                               const int* tile_slot, const void* k,
                               const void* v, const int* tables, void* out,
                               int T_, int bq, int H, int G, int ps, int P,
                               float scale, cudaStream_t stream) {
#define DA_CASE(DH)                                                       \
  case DH:                                                                \
    return launch_duet<T, DH / 32>(q, row_pos, tile_slot, k, v, tables,   \
                                   out, T_, bq, H, G, ps, P, scale, stream);
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
int duet_attention_paged_launch(const void* q, const void* row_pos,
                                const void* tile_slot, const void* k,
                                const void* v, const void* tables, void* out,
                                int T_, int bq, int H, int G, int Dh, int ps,
                                int P, float scale, int dtype, void* stream) {
  const int* rp = static_cast<const int*>(row_pos);
  const int* ts = static_cast<const int*>(tile_slot);
  const int* tb = static_cast<const int*>(tables);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DTYPE_F32)
    e = dispatch_dh<float>(Dh, q, rp, ts, k, v, tb, out, T_, bq, H, G, ps, P,
                           scale, st);
  else if (dtype == DTYPE_BF16)
    e = dispatch_dh<__nv_bfloat16>(Dh, q, rp, ts, k, v, tb, out, T_, bq, H,
                                   G, ps, P, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
