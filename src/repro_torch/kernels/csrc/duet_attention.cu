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
// Design (decode_core.cuh): grid (T, G, C) with clusters of C CTAs along z.
// The tile's keys 0 .. max(row_pos) (the Pallas grid walks all S keys in
// block_k steps; no row of the tile sees a later key) split into C
// contiguous spans of whole 64-key units; CTA rank r streams span r's K/V
// rows of its group through the cp.async ring (key k of the slot sits at
// (slot * S + k) * G * Dh: no table lookup) and takes each stage against
// all bq * rep query rows of the (tile, group); the ranks combine the
// cluster's partials through distributed shared memory. Pad rows and pad
// tiles see no valid key; the dead-row guard keeps their l = 0 and acc = 0,
// so they come out as zeros (the reference kernel leaves the mean of V
// there; only unpacked rows are ever read).
//
// A tile of more than 16 (row, head) pairs (block_q * rep > 16: the slab
// decode's one-row tiles at granite-20b's rep 48, or prefill tiles) runs
// duet_attention_block_kernel instead: prefill_core.cuh's 64-row block
// over the same span of the slot's keys, each row masked at its own
// row_pos, the ranks' partials combined by the same cluster combine; a
// tile of more than 64 pairs splits its group's heads into head blocks on
// grid y (attn::head_split). The role follows block_q and rep alone, so
// the host picks the kernel and prices the one it launches.
//
// Log-sum-exp (optional, for context-parallel decode): with ``lse`` given
// (fp32, (T*bq, H)), each row and head also gets the natural-log
// log-sum-exp of its scores over the keys the launch saw, (m + log2 l) *
// ln 2 from the cluster combine's (m, l) (-inf for a row that saw no valid
// key); a rank of a sequence group combines its span's (out, lse) with
// its peers'. The caller shifts row_pos by the span's first key: a row
// before the span comes out dead (out 0, lse -inf), a row past it sees all
// of it. With lse the block role combines through the cluster's partials
// also at C = 1 (one store per row and head more); without it nothing
// changes.
//
// Bound: memory, the live KV bytes (each tile's keys 0..max row_pos of its
// group) at 3.35 TB/s. Tiles of one slot re-read its keys once per tile
// (and once per head block).
#include "attn_common.cuh"
#include "decode_core.cuh"
#include "prefill_core.cuh"

using namespace attn;

template <typename T, int DH, int NRB>
__global__ void __launch_bounds__(dcore::Cfg<T, DH, NRB>::THREADS)
    duet_attention_cluster_kernel(const T* __restrict__ q,
                                  const int* __restrict__ row_pos,
                                  const int* __restrict__ tile_slot,
                                  const T* __restrict__ k_slab,
                                  const T* __restrict__ v_slab,
                                  T* __restrict__ out,
                                  float* __restrict__ lse, int H, int G,
                                  int S, int bq, float scale) {
  using Cf = dcore::Cfg<T, DH, NRB>;
  extern __shared__ __align__(16) char core_smem[];
  const int t = blockIdx.x, g = blockIdx.y;
  const int C = gridDim.z;               // the cluster spans z
  const int rank = blockIdx.z;
  const int rep = H / G;
  const int nrows = bq * rep;            // CTA row i: tile row i / rep,
                                         // head g * rep + i % rep

  // keys 0 .. n_keys - 1 can be valid for some row of this tile; this
  // CTA's span of its 64-key units (ops.cluster_spans)
  const int slot = tile_slot[t];
  int maxpos = -1;
  if (slot >= 0)
    for (int r = 0; r < bq; ++r) maxpos = max(maxpos, row_pos[t * bq + r]);
  const int n_keys = maxpos < 0 ? 0 : min(S, maxpos + 1);
  const int units = (n_keys + dcore::SPLIT_KEYS - 1) / dcore::SPLIT_KEYS;
  const int span = (units + C - 1) / C;
  const int u0 = min(rank * span, units), u1 = min(u0 + span, units);

  auto row_head = [&](int i) {   // (row of q / out, head) of CTA row i
    return ((size_t)t * bq + i / rep) * H + (size_t)g * rep + i % rep;
  };
  const dcore::SlabSrc src{((size_t)max(slot, 0) * S * G + g) * DH,
                           (size_t)G * DH};
  dcore::decode_cluster<Cf>(
      core_smem, k_slab, v_slab, src, u0 * dcore::SPLIT_KEYS,
      min(u1 * dcore::SPLIT_KEYS, n_keys),
      [&](int i) { return q + row_head(i) * DH; },
      [&](int i) { return slot >= 0 ? row_pos[t * bq + i / rep] : -1; },
      nrows, scale,
      [&](int i, int d, float x) {
        out[row_head(i) * DH + d] = from_f32<T>(x);
      },
      [&](int i, float x) {
        if (lse) lse[row_head(i)] = x;
      });
}

// the block role: grid (T, G * hb, C), clusters of C along z
template <typename T, int DH>
__global__ void __launch_bounds__(pcore::BlockCfg<T, DH>::THREADS, 2)
    duet_attention_block_kernel(const T* __restrict__ q,
                                const int* __restrict__ row_pos,
                                const int* __restrict__ tile_slot,
                                const T* __restrict__ k_slab,
                                const T* __restrict__ v_slab,
                                T* __restrict__ out,
                                float* __restrict__ lse, int H, int G,
                                int S, int bq, HeadSplit hs, float scale) {
  extern __shared__ __align__(128) char block_smem[];
  const int t = blockIdx.x;
  const HeadBlock hb = HeadBlock::split(blockIdx.y, H / G, hs);
  const int C = gridDim.z, rank = blockIdx.z;
  const int nrows = bq * hb.hc;          // CTA row i: tile row i / hc,
                                         // head h0 + i % hc

  const int slot = tile_slot[t];
  int maxpos = -1;
  if (slot >= 0)
    for (int r = 0; r < bq; ++r) maxpos = max(maxpos, row_pos[t * bq + r]);
  const int n_keys = maxpos < 0 ? 0 : min(S, maxpos + 1);
  const int units = (n_keys + dcore::SPLIT_KEYS - 1) / dcore::SPLIT_KEYS;
  const int span = (units + C - 1) / C;
  const int u0 = min(rank * span, units), u1 = min(u0 + span, units);

  auto row_head = [&](int i) {   // (row of q / out, head) of CTA row i
    return ((size_t)t * bq + i / hb.hc) * H + hb.h0 + i % hb.hc;
  };
  const dcore::SlabSrc src{((size_t)max(slot, 0) * S * G + hb.g) * DH,
                           (size_t)G * DH};
  pcore::block_cluster<T, DH>(
      block_smem, q, k_slab, v_slab, out, src, u0 * dcore::SPLIT_KEYS,
      min(u1 * dcore::SPLIT_KEYS, n_keys),
      [&](int i) -> long long {
        return i < nrows ? (long long)(row_head(i) * DH) : -1LL;
      },
      [&](int i) { return slot >= 0 ? row_pos[t * bq + i / hb.hc] : -1; },
      nrows, scale, C,
      [&](int i, int d, float x) {
        out[row_head(i) * DH + d] = from_f32<T>(x);
      },
      lse != nullptr, [&](int i, float x) {
        if (lse) lse[row_head(i)] = x;
      });
}

static cudaError_t launch_slab(const void* q, const void* row_pos,
                               const void* tile_slot, const void* k,
                               const void* v, void* out, void* lse, int T_,
                               int bq, int H, int G, int Dh, int S, int C,
                               float scale, int dtype, cudaStream_t stream) {
  if (C < 1 || C > dcore::MAX_CLUSTER || G < 1 || H % G || bq < 1 ||
      bq > pcore::ROWS)
    return cudaErrorInvalidValue;
  const HeadSplit hs = head_split(H / G, bq, pcore::ROWS);
  if (bq * hs.hpc > dcore::MAX_ROWS)     // the block role
    return pcore::dispatch_t_dh(dtype, Dh, [&](auto tt, auto dh) {
      using T = std::remove_pointer_t<decltype(tt)>;
      constexpr int DH = decltype(dh)::value;
      using Bc = pcore::BlockCfg<T, DH>;
      return dcore::launch_cluster<Bc>(
          duet_attention_block_kernel<T, DH>, dim3(T_, G * hs.hb, C), C,
          (size_t)Bc::MAIN_BYTES, stream, static_cast<const T*>(q),
          static_cast<const int*>(row_pos),
          static_cast<const int*>(tile_slot), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<float*>(lse), H, G, S, bq, hs, scale);
    });
  return dcore::dispatch(dtype, Dh, bq * (H / G), [&](auto cf) {
    using Cf = decltype(cf);
    using T = typename Cf::T;
    return dcore::launch_cluster<Cf>(
        duet_attention_cluster_kernel<T, Cf::DH, Cf::NRB>, dim3(T_, G, C), C,
        (size_t)Cf::FIXED_BYTES, stream, static_cast<const T*>(q),
        static_cast<const int*>(row_pos), static_cast<const int*>(tile_slot),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), static_cast<float*>(lse), H, G, S, bq, scale);
  });
}

static cudaError_t slab_occupancy(int Dh, int rows, int C, int dtype,
                                  int* res) {
  if (C < 1 || C > dcore::MAX_CLUSTER || rows < 1)
    return cudaErrorInvalidValue;
  if (rows > dcore::MAX_ROWS)            // the block role
    return pcore::dispatch_t_dh(dtype, Dh, [&](auto tt, auto dh) {
      using T = std::remove_pointer_t<decltype(tt)>;
      constexpr int DH = decltype(dh)::value;
      using Bc = pcore::BlockCfg<T, DH>;
      res[1] = Bc::MAIN_BYTES;
      res[2] = Bc::MMA ? (pcore::NSTAGE - 1) * pcore::MmaCfg<DH>::STAGE_BYTES
                       : 0;
      return dcore::max_active_clusters<Bc>(
          duet_attention_block_kernel<T, DH>, C, (size_t)res[1], &res[0]);
    });
  return dcore::dispatch(dtype, Dh, rows, [&](auto cf) {
    using Cf = decltype(cf);
    res[1] = Cf::FIXED_BYTES;
    res[2] = (dcore::NSTAGE - 1) * Cf::STAGE_BYTES;
    return dcore::max_active_clusters<Cf>(
        duet_attention_cluster_kernel<typename Cf::T, Cf::DH, Cf::NRB>, C,
        (size_t)res[1], &res[0]);
  });
}

extern "C" {

// grid (T, G, C) (block_q * rep <= 16) or (T, G * head blocks, C) (the
// block role) in clusters of C CTAs along z; out (T*bq, H, Dh); lse
// (T*bq, H) fp32, or null where the log-sum-exp is not asked for.
int duet_attention_launch(const void* q, const void* row_pos,
                          const void* tile_slot, const void* k, const void* v,
                          void* out, void* lse, int T_, int bq, int H, int G,
                          int Dh, int S, int C, float scale, int dtype,
                          void* stream) {
  return (int)launch_slab(q, row_pos, tile_slot, k, v, out, lse, T_, bq, H,
                          G, Dh, S, C, scale, dtype,
                          static_cast<cudaStream_t>(stream));
}

// duet_attention_launch's occupancy for ``rows`` (= bq * heads of a head
// block) query rows per CTA, of the role it launches (the block role above
// 16 rows): res = {clusters of C CTAs the card holds at once, dynamic
// shared memory bytes per CTA, bytes the ring loads ahead}.
int duet_attention_occupancy(int Dh, int rows, int C, int dtype, void* res) {
  return (int)slab_occupancy(Dh, rows, C, dtype, static_cast<int*>(res));
}

}  // extern "C"
