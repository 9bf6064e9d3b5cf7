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
// prefill chunk's rows run in ONE launch. Pad rows and pad tiles come out
// as zeros (the reference kernel leaves the mean of V there; only unpacked
// rows are ever read). Tile order is scheduling only: every (tile, group)
// computes its rows independently, so the numerics do not depend on it.
//
// Bound: memory, the live KV bytes of the tiles (each chain's keys 0 ..
// the largest row_pos on it, read once: 45 MB at the main shape, 8 decode
// rows at 256..2048 tokens beside a 256-row chunk at 512..767) at 3.35
// TB/s.
//
// Design: grid (T, G x head blocks, C) with clusters of C CTAs along z
// (cudaLaunchKernelEx); the host picks C (ops.cluster_size: the largest
// grid the card runs in one wave). Each CTA reads its tile's row_pos on the device: the live
// rows are the tile's rows up to its last one with row_pos >= 0
// (build_duet_schedule fills tiles from the front), and the tile's keys
// are 0 .. its largest row_pos. Those keys split into C contiguous spans
// of whole 64-key units (ops.cluster_spans); a CTA copies its span's page
// ids from the table row into shared memory once, and every K/V copy takes
// its address from the page id of its key (dcore::PagedSrc). Then, by the
// number of (live row, head) pairs of its group, the CTA takes one of two
// roles:
//
// * Decode role (at most DECODE_ROWS = 16 pairs: a decode row, rep <= 16):
//   decode_core.cuh's decode_cluster over the span, exactly as
//   paged_decode runs it: a cp.async ring, mma.sync S^T = K Q^T with the
//   rows in the n dimension (8- or 16-row buckets), the warps' partials
//   and then the cluster's combined by the ranks through distributed shared
//   memory.
// * Prefill role (more pairs, at most 64: a tile of the prefill chunk):
//   prefill_core.cuh's block, the one flash_prefill runs, over the span's
//   keys: 64 (position, head) rows of group g on mma.sync, 64-key K/V
//   tiles gathered through the page table by cp.async into a swizzled
//   ring, each row masked at its own row_pos, the walk stopping after the
//   span's last key (the tile's largest row_pos). With C > 1 each rank
//   leaves its 64 rows' (m, l, acc) partial in its ring (64 x (Dh + 2) x 4
//   B = 33 KB at Dh 128) and the ranks combine them through distributed
//   shared memory in rank order, each rank a 1/C share of the rows
//   (dcore::cluster_combine, as the decode role).
//
// A prefill tile holds 64 / rep chunk positions, so a chunk's chain is read
// once per 64 / rep rows (16 at qwen3-4b's rep 4) where a tile of one row
// read it once per row: the engine's 256-row chunk reads its 768-key chain
// 16 times (per group) instead of 256, and each K/V tile feeds 64 rows of
// tensor-core products instead of one row of CUDA-core dot products.
// A tile of more than 64 pairs (rep > 64 at one row a tile, or a caller's
// block_q * rep > 64) splits its group's heads into head blocks on grid y
// (attn::head_split; one block at every registered config): CTA (t, y)
// holds the nlive * hc pairs of head block y % hb of group y / hb, and
// takes the decode role when nlive * hpc <= 16, so every head block of a
// tile takes the same role (a last, smaller head block of at most 8 pairs
// takes the decode role too). At granite-20b's rep 48 the engine's tiles
// hold one position each (48 pairs), decode rows and chunk positions
// alike, and all take the prefill role; the chunk's chain is then read
// once per chunk position.
// fp32 serves parity only: its decode role is decode_core's CUDA-core path,
// its prefill role prefill_core's CUDA-core block. Dh 256 takes both roles
// too (the prefill block keeps Q in shared memory there).
#include "decode_core.cuh"
#include "prefill_core.cuh"

using namespace attn;

namespace {

constexpr int DECODE_ROWS = 16;     // a tile's pairs the decode role takes
constexpr int TILE_ROWS = pcore::ROWS;   // a tile's pairs at most

template <typename T, int DH>
struct DuetCfg {
  static constexpr bool MMA = sizeof(T) == 2;
  using Small = dcore::Cfg<T, DH, MMA ? 8 : 4>;   // decode buckets
  using Big = dcore::Cfg<T, DH, DECODE_ROWS>;
  using Block = pcore::BlockCfg<T, DH>;            // the prefill role
  static constexpr int THREADS = Big::THREADS;
  static constexpr int MAIN_BYTES =
      dcore::cmax(dcore::cmax(Small::FIXED_BYTES, Big::FIXED_BYTES),
                  Block::MAIN_BYTES);
  static_assert(Small::THREADS == THREADS && Block::THREADS == THREADS,
                "both roles run the same block");
  static_assert(pcore::BM == TILE_ROWS && DECODE_ROWS == dcore::MAX_ROWS,
                "a prefill block holds a tile");
};

// most page ids a CTA's span of whole 64-key units touches
int span_pages(int P, int ps, int C) {
  const int units = (P * ps + dcore::SPLIT_KEYS - 1) / dcore::SPLIT_KEYS;
  const int span = (units + C - 1) / C;
  return (span * dcore::SPLIT_KEYS + ps - 1) / ps + 1;
}

template <typename T, int DH>
__global__ void __launch_bounds__(DuetCfg<T, DH>::THREADS, 2)
    duet_attention_paged_kernel(const T* __restrict__ q,
                                const int* __restrict__ row_pos,
                                const int* __restrict__ tile_slot,
                                const T* __restrict__ k_pages,
                                const T* __restrict__ v_pages,
                                const int* __restrict__ tables,
                                T* __restrict__ out, int H, int G, int ps,
                                int P, int bq, HeadSplit hs, float scale) {
  using D = DuetCfg<T, DH>;
  extern __shared__ __align__(128) char smem[];
  const int t = blockIdx.x;
  const HeadBlock hb = HeadBlock::split(blockIdx.y, H / G, hs);
  const int C = gridDim.z;               // the cluster spans z
  const int rank = blockIdx.z;

  // the live rows (a prefix of the tile) and the tile's largest position
  const int slot = tile_slot[t];
  int nlive = 0, maxpos = -1;
  if (slot >= 0)
    for (int r = 0; r < bq; ++r) {
      const int p = row_pos[t * bq + r];
      if (p >= 0) {
        nlive = r + 1;
        maxpos = max(maxpos, p);
      }
    }
  const int nrows = nlive * hb.hc;       // CTA row i: tile row i / hc,
                                         // head h0 + i % hc
  auto row_head = [&](int i) {
    return ((size_t)t * bq + i / hb.hc) * H + hb.h0 + i % hb.hc;
  };
  if (rank == 0)                         // rows past the live ones: zeros
    for (int i = nrows * DH + threadIdx.x; i < bq * hb.hc * DH;
         i += D::THREADS)
      out[row_head(i / DH) * DH + i % DH] = from_f32<T>(0.f);
  if (nrows == 0) return;                // the whole cluster returns
  const bool prefill = nlive * hs.hpc > DECODE_ROWS;

  // this CTA's span of the tile's 64-key units (ops.cluster_spans)
  const int n_keys = min(P * ps, maxpos + 1);
  const int units = (n_keys + dcore::SPLIT_KEYS - 1) / dcore::SPLIT_KEYS;
  const int span = (units + C - 1) / C;
  const int u0 = min(rank * span, units), u1 = min(u0 + span, units);
  const int k_begin = u0 * dcore::SPLIT_KEYS;
  const int k_end = min(u1 * dcore::SPLIT_KEYS, n_keys);
  const int pg0 = k_begin / ps;
  const int pg1 = k_end > k_begin ? (k_end + ps - 1) / ps : pg0;
  int* pid = reinterpret_cast<int*>(smem + D::MAIN_BYTES);
  for (int i = threadIdx.x; i < pg1 - pg0; i += D::THREADS)
    pid[i] = tables[(size_t)slot * P + pg0 + i];
  __syncthreads();                       // page ids in place

  const size_t row_elems = (size_t)G * DH;
  const int ps_shift = (ps & (ps - 1)) ? -1 : __ffs(ps) - 1;
  const dcore::PagedSrc src{pid, pg0 * ps, ps, ps_shift,
                            (size_t)ps * row_elems, row_elems,
                            (size_t)hb.g * DH};
  auto lim_of = [&](int i) { return row_pos[t * bq + i / hb.hc]; };
  auto write_out = [&](int i, int d, float x) {
    out[row_head(i) * DH + d] = from_f32<T>(x);
  };
  auto qrow = [&](int i) { return q + row_head(i) * DH; };
  // (written in this order: with "!prefill &&" in the first test the duet
  // launch at qwen3-4b's main shape measured 7% slower on an H100 80GB
  // HBM3 at 700 W)
  if (nrows <= D::Small::NRB) {
    dcore::decode_cluster<typename D::Small>(
        smem, k_pages, v_pages, src, k_begin, k_end, qrow, lim_of, nrows,
        scale, write_out);
  } else if (!prefill) {
    dcore::decode_cluster<typename D::Big>(
        smem, k_pages, v_pages, src, k_begin, k_end, qrow, lim_of, nrows,
        scale, write_out);
  } else {
    pcore::block_cluster<T, DH>(
        smem, q, k_pages, v_pages, out, src, k_begin, k_end,
        [&](int i) -> long long {
          return i < nrows ? (long long)(row_head(i) * DH) : -1LL;
        },
        lim_of, nrows, scale, C, write_out);
  }
}

// dynamic shared memory of one CTA: the larger role's + the span's page ids
template <typename T, int DH>
size_t duet_smem(int P, int ps, int C) {
  return DuetCfg<T, DH>::MAIN_BYTES + sizeof(int) * span_pages(P, ps, C);
}

cudaError_t launch_duet(const void* q, const void* row_pos,
                        const void* tile_slot, const void* k, const void* v,
                        const void* tables, void* out, int T_, int bq, int H,
                        int G, int Dh, int ps, int P, int C, float scale,
                        int dtype, cudaStream_t stream) {
  if (C < 1 || C > dcore::MAX_CLUSTER || G < 1 || H % G || bq < 1 ||
      bq > TILE_ROWS)
    return cudaErrorInvalidValue;
  const HeadSplit hs = head_split(H / G, bq, TILE_ROWS);
  return pcore::dispatch_t_dh(dtype, Dh, [&](auto tt, auto dh) {
    using T = std::remove_pointer_t<decltype(tt)>;
    constexpr int DH = decltype(dh)::value;
    return dcore::launch_cluster<typename DuetCfg<T, DH>::Big>(
        duet_attention_paged_kernel<T, DH>, dim3(T_, G * hs.hb, C), C,
        duet_smem<T, DH>(P, ps, C), stream, static_cast<const T*>(q),
        static_cast<const int*>(row_pos), static_cast<const int*>(tile_slot),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(tables), static_cast<T*>(out), H, G, ps, P,
        bq, hs, scale);
  });
}

cudaError_t duet_occupancy(int Dh, int ps, int P, int C, int dtype,
                           int* res, cudaStream_t stream) {
  if (C < 1 || C > dcore::MAX_CLUSTER) return cudaErrorInvalidValue;
  return pcore::dispatch_t_dh(dtype, Dh, [&](auto tt, auto dh) {
    using T = std::remove_pointer_t<decltype(tt)>;
    constexpr int DH = decltype(dh)::value;
    auto kernel = duet_attention_paged_kernel<T, DH>;
    res[1] = (int)duet_smem<T, DH>(P, ps, C);
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    res[2] = attr.numRegs;
    return dcore::max_active_clusters<typename DuetCfg<T, DH>::Big>(
        kernel, C, (size_t)res[1], &res[0], stream);
  });
}

}  // namespace

extern "C" {

// grid (T, G * head blocks, C) in clusters of C CTAs along z (C <= 8);
// out (T*bq, H, Dh).
int duet_attention_paged_launch(const void* q, const void* row_pos,
                                const void* tile_slot, const void* k,
                                const void* v, const void* tables, void* out,
                                int T_, int bq, int H, int G, int Dh, int ps,
                                int P, int C, float scale, int dtype,
                                void* stream) {
  return (int)launch_duet(q, row_pos, tile_slot, k, v, tables, out, T_, bq,
                          H, G, Dh, ps, P, C, scale, dtype,
                          static_cast<cudaStream_t>(stream));
}

// duet_attention_paged_launch's residency for tables of width P over pages
// of ps tokens: res = {clusters of C CTAs the SMs of ``stream``'s context
// (null: the card) hold at once, dynamic shared memory bytes per CTA,
// registers per thread}.
int duet_attention_paged_occupancy(int Dh, int ps, int P, int C, int dtype,
                                   void* res, void* stream) {
  return (int)duet_occupancy(Dh, ps, P, C, dtype, static_cast<int*>(res),
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
