// Hopper (sm_90a) warpgroup block: the bf16 "block role" of
// paged_decode.cu's paged_decode_block_kernel, redesigned for decode.
//
// A block-role CTA holds the up to 64 query heads of one KV group of one
// decode row (rep > 16: granite-20b's MQA puts 48 heads on one KV head)
// and walks one span of the request's keys; the spans of a cluster of up
// to 16 CTAs combine in rank order (cluster_combine below). Bound: memory.
// The span's K/V bytes are read once, at 4 FLOP an element; the rows add
// no bytes. prefill_core.cuh's mma.sync block, which ran this role before,
// kept one 64-key tile in flight on 4 warps and started its copies only
// after a __syncthreads() behind the page-id load. This block:
//
// * Rows on a warpgroup. The CTA's 64 rows are the M of wgmma m64nNk16
//   (bf16 in, fp32 accumulators) on warps 0-3: S = Q K^T with Q and K
//   from shared memory (m64n64k16 over the head dim), and O += P V with P
//   from registers (the S accumulators repacked as bf16, no trip through
//   shared memory) and V from shared memory, transposed (m64nDHk16 over
//   the tile's 64 rows). Rows the CTA does not hold are zeros in Q and
//   are never written.
// * Copies ahead of compute. Warp 4 is a producer: it reads its span's
//   page ids from the block table into registers (two 32-page windows a
//   lane, no shared memory and no CTA barrier in front of the first copy)
//   and issues TMA copies (cp.async.bulk.tensor, one 4-d tensor map over
//   the pool (Dh, G, page rows, pages)): a box of 64 dims x one group x a
//   page's rows per page, each landing 128-byte-swizzled as wgmma reads
//   it. They fill a ring of NSTAGE = 3 stages of K and V tiles on full /
//   empty mbarriers, so two tiles are in flight while one is computed.
// * Tiles of whole pages. A tile's 64 rows hold 64 / rs whole pages of ps
//   <= 64 rows, each box at a slot of rs = ps rounded up to 8 rows (a
//   1024-byte swizzle atom starts every box): 64 keys at pages of 16, 48
//   at pages of 12. Pages of more than 64 rows give one box of bh rows a
//   tile, bh the largest divisor of ps up to 64 (Tiles, made on the host
//   by tiles_for; in Python ops.block_tile_keys). Rows that hold no key of
//   the tile (a slot's tail, keys past the span) are masked by a select,
//   so stale or NaN rows of K never reach a probability, and their V rows
//   are zeroed in shared memory before P V (0 x NaN is NaN).
// * Online softmax in registers, in the log2 domain (scores times scale *
//   log2 e), each thread holding 2 rows x 16 keys of a tile, the row max
//   reduced over a quad; l sums the bf16-rounded P as P V sees it.
// * The producer sets up the ring and issues its first copies without
//   waiting for Q; the combine reads every rank's partial rows through
//   distributed shared memory, all ranks' loads in flight at once.
//
// The host picks this block (paged_decode.paged_engine) for
// paged_decode.cu's block role in bf16 at Dh 64, 128 or 256 over tables of
// at least ops.PAGED_WG_MIN_KEYS keys. fp32, Dh 32, shorter tables, the
// slab duet_attention's block role and the prefill tiles keep
// prefill_core.cuh's block.
#pragma once

#include <cuda.h>

#include <cooperative_groups.h>

#include "attn_common.cuh"
#include "decode_core.cuh"   // MAX_CLUSTER
#include "prefill_core.cuh"  // dispatch_t_dh
#include "sm90_mma.cuh"      // smem_addr, ex2, pack_bf16
#include "sm90_wgmma.cuh"

namespace wgb {

using namespace sm90;
using attn::DENOM_EPS;
using attn::MASKED_M_THRESHOLD;
using attn::NEG_INF;
using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;             // (row, head) pairs a CTA: wgmma's M
constexpr int BN = 64;               // keys a tile: the N of S = Q K^T
constexpr int NSTAGE = 3;            // ring depth: 2 tiles in flight
constexpr int CONSUMERS = 128;       // warps 0-3: one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int PRODUCER_WARP = CONSUMERS / 32;
constexpr int MAX_CLUSTER = 16;      // non-portable cluster size
constexpr int ROW_BYTES = 128;       // a swizzled row: 64 bf16
constexpr int PANEL_BYTES = BN * ROW_BYTES;   // 64 rows x 64 dims
constexpr int CONSUMER_BAR = 1;      // named barriers: the consumers',
constexpr int INIT_BAR = 2;          // and the ring's set-up (all threads)
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one CTA at head dim DH: the ring (NSTAGE x (K, V)
// tiles, each DH / 64 panels of 64 rows x 128 bytes), Q's 64 rows in the
// same panels, then the full and empty mbarriers and the combine's. The
// ring, reused after the walk, holds the CTA's partial (a record of REC
// floats a row: m, l, 2 unused, acc[DH]), which the cluster's ranks read
// through distributed shared memory.
template <int DH>
struct Cfg {
  static_assert(DH == 64 || DH == 128 || DH == 256, "head dim");
  static constexpr int PANELS = DH / 64;
  static constexpr int TILE_BYTES = PANELS * PANEL_BYTES;   // K (or V)
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
  static constexpr int Q_BYTES = PANELS * ROWS * ROW_BYTES;
  static constexpr int BAR_OFF = RING_BYTES + Q_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFF + 2 * NSTAGE * 8;
  static constexpr int REC = DH + 4;                 // floats a row record
  static_assert(4 * REC * ROWS <= RING_BYTES, "records fit the ring");
};

// Which block a block-role CTA of element type T at head dim DH runs: this
// warpgroup block where the host asks for it (``want``; it takes bf16 at Dh
// 64-256 only), else prefill_core.cuh's.
template <typename T, int DH, bool want>
struct Role {
  static constexpr bool WG = want && sizeof(T) == 2 && DH >= 64;
  static constexpr int THREADS = WG ? wgb::THREADS : 128;
  // two CTAs an SM up to Dh 128 (115 KB of shared memory each)
  static constexpr int MIN_BLOCKS = WG && DH > 128 ? 1 : 2;
  static constexpr int MAX_CLUSTER =
      WG ? wgb::MAX_CLUSTER : dcore::MAX_CLUSTER;
};

// Keys to boxes: key k lies in page k / ps at row k % ps, page i of the
// request is pages[i]. The producer loads the page ids of pages guess ..
// guess + 63 before the span is known (the span of a request whose live
// pages fill its table); a span that starts elsewhere loads its own window
// once it is known.
struct Keys {
  const int* pages;
  int n_pages;            // entries of pages that may be read
  int ps, guess;
};

// A tile: tk keys in boxes of bh rows (of one page each), box j at rows
// j * rs .. j * rs + bh - 1 of the tile (rs a multiple of 8, or the whole
// tile); rows past tk / bh boxes or past a box's bh rows hold no key.
struct Tiles {
  int tk, bh, rs;
};

// The block over keys k_begin .. k_end - 1 ((k_begin, k_end) = span(),
// called once every load the block can issue without it is in flight) in
// tiles ``tl``, for rows r with row_off(r) >= 0 (element offset in q and
// out), each seeing keys up to lim_of(r). With part == nullptr it writes
// acc / max(l, DENOM_EPS) to out + row_off(r); otherwise it leaves each
// row's partial record (m in log2 units or NEG_INF, l, 2 unused, acc) at
// part + r * REC. Every thread of the CTA (THREADS) calls it.
template <int DH, class Span, class RowOff, class LimOf>
__device__ __forceinline__ void wg_block(
    char* smem, const bf16* __restrict__ q, bf16* __restrict__ out,
    const CUtensorMap* kmap, const CUtensorMap* vmap, const Keys& keys,
    int g, Span span, Tiles tl, RowOff row_off, LimOf lim_of, float scale,
    float* part) {
  using Cf = Cfg<DH>;
  constexpr int CPR = DH / 8;                     // 16-byte chunks of a row
  constexpr int QPT = ROWS * CPR / CONSUMERS;     // Q chunks a consumer
  const int tk = tl.tk, bh = tl.bh;
  const unsigned ring = smem_addr(smem);
  const unsigned q_s = ring + Cf::RING_BYTES;
  const unsigned full0 = ring + Cf::BAR_OFF;
  const unsigned empty0 = full0 + NSTAGE * 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Loads that need no span go first, so their latency overlaps the
  // span's own loads: the producer's page-id window (pages w0 + lane and
  // w0 + 32 + lane) at the guess, and each consumer's chunks of Q. The
  // producer initialises the ring's barriers itself and starts its copies
  // without waiting for Q; the consumers wait for the barriers (INIT_BAR)
  // once their Q is in place.
  int w0 = 0, pid_lo = 0, pid_hi = 0;
  auto load_window = [&](int first) {
    w0 = first;
    const int a = first + lane, b = a + 32;
    pid_lo = a < keys.n_pages ? keys.pages[a] : 0;
    pid_hi = b < keys.n_pages ? keys.pages[b] : 0;
  };
  uint4 qv[QPT];
  if (warp == PRODUCER_WARP) {
    // the barriers first: their fence waits for this thread's loads in
    // flight, so none is
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < NSTAGE; ++s) {
        mbar_init(full0 + 8 * s, 1);                 // the producer's arrive
        mbar_init(empty0 + 8 * s, CONSUMERS / 32);   // one a consumer warp
      }
      mbar_init_fence();
      tma_prefetch_map(kmap);
      tma_prefetch_map(vmap);
    }
    __syncwarp();
    named_bar_arrive(INIT_BAR, THREADS);
    load_window(keys.guess);
  } else {
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int i = threadIdx.x + j * CONSUMERS, r = i / CPR;
      const long long off = row_off(r);
      qv[j] = off >= 0 ? *reinterpret_cast<const uint4*>(
                             q + off + (i % CPR) * 8)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const int2 sp = span();
  const int k_begin = sp.x, k_end = sp.y;
  const int n_keys = max(k_end - k_begin, 0);
  const int n_tiles = (n_keys + tk - 1) / tk;
  // a consumer's rows of the 64: warp * 16 + gq (h = 0) and + 8 (h = 1),
  // and the last key each sees (its loads beside Q's)
  const int gq = lane >> 2, c = lane & 3;
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    lim[h] = row_off(r) >= 0 ? min(lim_of(r), k_end - 1) : -1;
  }
  if (warp < PRODUCER_WARP) {
    // Q's rows into their swizzled panels (rows the CTA does not hold:
    // zeros): 16-byte chunk ch of row r at chunk (ch % 8) ^ (r % 8) of the
    // row in panel ch / 8
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int i = threadIdx.x + j * CONSUMERS, r = i / CPR, ch = i % CPR;
      st_shared_v4(q_s + (ch >> 3) * PANEL_BYTES + r * ROW_BYTES +
                       (((ch & 7) ^ (r & 7)) << 4),
                   qv[j]);
    }
    fence_proxy_async();
    named_bar_sync(INIT_BAR, THREADS);   // barriers initialised, Q in place
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DH / 2];                   // O: n-tile nt's 4 values at 4 nt
  const float qs = scale * LOG2E;
  if (warp == PRODUCER_WARP) {
    // ------------------------------------------------------------ producer
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NSTAGE;
      if (t >= NSTAGE) mbar_wait(empty0 + 8 * s, ((t / NSTAGE) & 1) ^ 1);
      const int k0 = k_begin + t * tk;
      const int nbox = (min(tk, k_end - k0) + bh - 1) / bh;
      if (k0 / keys.ps < w0 ||                         // warp-uniform
          (k0 + nbox * bh - 1) / keys.ps >= w0 + 64)
        load_window(k0 / keys.ps);
      if (lane == 0)
        mbar_arrive_tx(full0 + 8 * s,
                       nbox * bh * ROW_BYTES * Cf::PANELS * 2);
      __syncwarp();
      const unsigned kst = ring + s * Cf::STAGE_BYTES;
      for (int j0 = 0; j0 < nbox; j0 += 32) {
        const int j = j0 + lane, kb = k0 + j * bh;
        const int pg = kb / keys.ps, rel = pg - w0;
        const int lo = __shfl_sync(0xffffffffu, pid_lo, rel & 31);
        const int hi = __shfl_sync(0xffffffffu, pid_hi, rel & 31);
        if (j < nbox) {
          const int pid = rel < 32 ? lo : hi;
          const int row = kb - pg * keys.ps;
#pragma unroll
          for (int p = 0; p < Cf::PANELS; ++p) {
            const unsigned dst =
                kst + p * PANEL_BYTES + j * tl.rs * ROW_BYTES;
            tma_load_4d(dst, kmap, 64 * p, g, row, pid, full0 + 8 * s);
            tma_load_4d(dst + Cf::TILE_BYTES, vmap, 64 * p, g, row, pid,
                        full0 + 8 * s);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    // this thread's keys of a tile: nt * 8 + 2c and + 1, nt = 0 .. 7
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    // n-tile nt's 8 rows of a tile (rs is a multiple of 8: one box each):
    // the key of its first row past k0, and how many of its rows hold keys
    int kof[BN / 8], nrow[BN / 8];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int j = nt * 8 / tl.rs, w = nt * 8 - j * tl.rs;
      kof[nt] = j * bh + w;
      nrow[nt] = j * bh < tk ? min(bh - w, 8) : 0;
    }
    // a tile row's key past k0, or -1 where the row holds none
    auto row_key = [&](int r) {
      const int j = r / tl.rs, w = r - j * tl.rs;
      return j * bh < tk && w < bh ? j * bh + w : -1;
    };

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NSTAGE;
      const int k0 = k_begin + t * tk;
      const int nk = min(tk, k_end - k0);
      const unsigned kst = ring + s * Cf::STAGE_BYTES;
      const unsigned vst = kst + Cf::TILE_BYTES;
      mbar_wait(full0 + 8 * s, (t / NSTAGE) & 1);
      if (nk < BN) {     // V rows that hold no key of the tile: zeros
        for (int i = threadIdx.x; i < BN * 8 * Cf::PANELS; i += CONSUMERS) {
          const int r = (i >> 3) % BN;
          const int key = row_key(r);
          if (key < 0 || key >= nk)
            st_shared_v4(vst + (i >> 3) / BN * PANEL_BYTES + r * ROW_BYTES +
                             ((i & 7) << 4),
                         make_uint4(0u, 0u, 0u, 0u));
        }
        fence_proxy_async();
        named_bar_sync(CONSUMER_BAR, CONSUMERS);
      }

      // S = Q K^T over DH / 16 k-steps: k-step kk reads 32 bytes at
      // (kk % 4) * 32 of every row of panel kk / 4
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const unsigned off = (kk >> 2) * PANEL_BYTES + (kk & 3) * 32;
        wgmma_ss_n64(sc, desc_sw128(q_s + off, 16, 1024),
                     desc_sw128(kst + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // sc[4 nt + i]: row gq + 8 (i / 2) against tile row nt * 8 + 2c +
      // i % 2, key k0 + kof[nt] + 2c + i % 2; rows that hold no key and
      // keys past the span or a row's limit are masked by a select
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 2 * c + (i & 1);
          if (e >= nrow[nt] || kof[nt] + e >= nk ||
              k0 + kof[nt] + e > lim[i >> 1])
            sc[4 * nt + i] = NEG_INF;
        }

      // online softmax in the log2 domain; a row that has seen no valid
      // key keeps a scaled max of 0, so its masked scores give p = 0
      float alpha[2], msc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
          mx = fmaxf(mx, fmaxf(sc[4 * nt + 2 * h], sc[4 * nt + 2 * h + 1]));
        float mr = fmaxf(m[h], mx);
        mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
        mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
        msc[h] = mr > MASKED_M_THRESHOLD ? mr * qs : 0.f;
        alpha[h] = ex2(m[h] * qs - msc[h]);
        m[h] = mr;
      }
      // P as bf16 A fragments (k-step kj: n-tiles 2 kj and 2 kj + 1), and
      // this thread's share of the row sums of the rounded P
      uint32_t pa[BN / 16][4];
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t pk =
              pack_bf16(ex2(fmaf(sc[4 * nt + 2 * h], qs, -msc[h])),
                        ex2(fmaf(sc[4 * nt + 2 * h + 1], qs, -msc[h])));
          pa[nt >> 1][2 * (nt & 1) + h] = pk;
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&pk));
          ls[h] += f.x + f.y;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ls[h];
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        o[4 * nt] *= alpha[0];
        o[4 * nt + 1] *= alpha[0];
        o[4 * nt + 2] *= alpha[1];
        o[4 * nt + 3] *= alpha[1];
      }

      // O += P V: k-step kj takes keys 16 kj .. + 15 of every V panel (the
      // descriptor's lbo steps the panels along the head dim)
      wgmma_fence();
#pragma unroll
      for (int kj = 0; kj < BN / 16; ++kj) {
        const uint64_t dv =
            desc_sw128(vst + kj * 16 * ROW_BYTES, PANEL_BYTES, 1024);
        if constexpr (DH == 64) wgmma_rs_n64(o, pa[kj], dv);
        else if constexpr (DH == 128) wgmma_rs_n128(o, pa[kj], dv);
        else wgmma_rs_n256(o, pa[kj], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);   // the stage is free
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {    // the row sums over the quad
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    if (part == nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + gq + 8 * h;
        const long long off = row_off(r);
        if (off < 0) continue;
        const float inv = 1.f / fmaxf(l[h], DENOM_EPS);
        bf16* orow = out + off;
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt)
          *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * c) = pack_bf16(
              o[4 * nt + 2 * h] * inv, o[4 * nt + 2 * h + 1] * inv);
      }
    }
  }
  if (part == nullptr || warp == PRODUCER_WARP) return;
  named_bar_sync(CONSUMER_BAR, CONSUMERS);   // every tile consumed: the
                                             // ring is free
  // the records of the rows the CTA holds (no other row's is read)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    if (row_off(r) < 0) continue;
    float* rec = part + r * Cf::REC;
    if (c == 0)
      *reinterpret_cast<float2*>(rec) = make_float2(
          m[h] > MASKED_M_THRESHOLD ? m[h] * qs : NEG_INF, l[h]);
    float* a = rec + 4 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<float2*>(a + nt * 8) =
          make_float2(o[4 * nt + 2 * h], o[4 * nt + 2 * h + 1]);
  }
}

// The cluster's combine of the partial records wg_block left at part in
// every CTA of a cluster of C CTAs (any C from 1 to CP, CP a power of two
// up to MAX_CLUSTER). Rank r combines rows [r * ceil(nrows / C), ...):
// after a cluster barrier (every rank's records written), a thread an item
// (a row, 4 columns) reads the row's (m, l) and 4 acc values of every rank
// through distributed shared memory, MAX_CLUSTER / CP items at a time (all
// C ranks' loads of them in flight at once; no load names a rank past
// C - 1), weighs the ranks in rank order (a rank whose max is at or below
// MASKED_M_THRESHOLD weighs 0), and writes 4 bf16 of the output to out +
// row_off(row). A second cluster barrier, arrived (release: after every
// load of this thread has returned) once this rank's reads are done and
// waited on last, keeps every rank's records alive until every rank has
// read them: a load still in flight to a rank that has exited faults the
// launch. Every CTA of the cluster calls it.
template <int DH, int CP, class RowOff>
__device__ __forceinline__ void cluster_combine(float* part, bf16* out,
                                                int nrows, int C,
                                                RowOff row_off) {
  constexpr int REC = Cfg<DH>::REC;
  constexpr int V = DH / 4;               // float4s a row
  constexpr int IPB = MAX_CLUSTER / CP;   // items a thread has in flight
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int share = (nrows + C - 1) / C;
  const int r0 = min(rank * share, nrows), r1 = min(r0 + share, nrows);
  unsigned base[CP];                      // part in each rank's window
#pragma unroll
  for (int c = 0; c < CP; ++c)
    base[c] = c < C ? mapa(smem_addr(part), c) : 0u;
  cluster_arrive_release();               // this rank's records written
  cluster_wait();
  const int n_items = (r1 - r0) * V;
  for (int i0 = threadIdx.x; i0 < n_items; i0 += IPB * THREADS) {
    float2 ml[IPB][CP];
    float4 x[IPB][CP];
#pragma unroll
    for (int k = 0; k < IPB; ++k) {
      const int i = i0 + k * THREADS;
      if (i >= n_items) break;       // no load whose value goes unused
      const unsigned off = ((r0 + i / V) * REC) * 4;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        if (c < C) {
          ml[k][c] = ld_dsmem_v2(base[c] + off);
          x[k][c] = ld_dsmem_v4(base[c] + off + (4 + (i % V) * 4) * 4);
        } else {                     // no such rank: weighs 0
          ml[k][c] = make_float2(NEG_INF, 0.f);
          x[k][c] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < IPB; ++k) {
      const int i = i0 + k * THREADS;
      if (i >= n_items) break;
      const int r = r0 + i / V, d = (i % V) * 4;
      float ms = NEG_INF;
#pragma unroll
      for (int c = 0; c < CP; ++c) ms = fmaxf(ms, ml[k][c].x);
      float ls = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const float w =
            ml[k][c].x > MASKED_M_THRESHOLD ? exp2f(ml[k][c].x - ms) : 0.f;
        ls += w * ml[k][c].y;
        a.x += w * x[k][c].x;
        a.y += w * x[k][c].y;
        a.z += w * x[k][c].z;
        a.w += w * x[k][c].w;
      }
      const float inv = 1.f / fmaxf(ls, DENOM_EPS);
      *reinterpret_cast<uint2*>(out + row_off(r) + d) =
          make_uint2(pack_bf16(a.x * inv, a.y * inv),
                     pack_bf16(a.z * inv, a.w * inv));
    }
  }
  cluster_arrive_release();               // this rank's reads are done
  cluster_wait();                         // (no rank exits before)
}

// The block over this CTA's span of a cluster of C CTAs (1 <= C <=
// MAX_CLUSTER; arguments as wg_block's), then, with C > 1, the ranks'
// partials combined in rank order (cluster_combine, instantiated for the
// power of two at or above C). With C = 1 the block writes its rows
// itself. Every CTA of the cluster calls it.
template <int DH, class Span, class RowOff, class LimOf>
__device__ __forceinline__ void block_cluster(
    char* smem, const bf16* q, bf16* out, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const Keys& keys, int g, Span span, Tiles tl,
    RowOff row_off, LimOf lim_of, int nrows, float scale, int C) {
  float* part = C > 1 ? reinterpret_cast<float*>(smem) : nullptr;
  wg_block<DH>(smem, q, out, kmap, vmap, keys, g, span, tl, row_off, lim_of,
               scale, part);
  if (!part) return;
  if (C <= 2) return cluster_combine<DH, 2>(part, out, nrows, C, row_off);
  if (C <= 4) return cluster_combine<DH, 4>(part, out, nrows, C, row_off);
  if (C <= 8) return cluster_combine<DH, 8>(part, out, nrows, C, row_off);
  return cluster_combine<DH, 16>(part, out, nrows, C, row_off);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
// The tiles over pages of ps rows (ops.block_tile_keys): boxes of a whole
// page at slots of ps rounded up to 8 rows where ps <= 64, else one box a
// tile of the largest divisor of ps up to 64.
inline Tiles tiles_for(int ps) {
  if (ps <= BN) {
    const int rs = (ps + 7) / 8 * 8;
    return {BN / rs * ps, ps, rs};
  }
  int d = BN;
  while (ps % d) --d;
  return {d, d, BN};
}

// Calls fn(T*, integral_constant<Dh>, integral_constant<bool, WG>) for a
// block-role launch's dtype and head dim, with WG the host's ``wg`` (ask
// for the warpgroup block; an error where Role does not take it).
template <class Fn>
cudaError_t dispatch_block(int dtype, int Dh, int wg, Fn fn) {
  return pcore::dispatch_t_dh(dtype, Dh, [&](auto tt,
                                             auto dh) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tt)>;
    constexpr int DH = decltype(dh)::value;
    if constexpr (Role<T, DH, true>::WG) {
      if (wg) return fn(tt, dh, std::true_type{});
    } else {
      if (wg) return cudaErrorInvalidValue;
    }
    return fn(tt, dh, std::false_type{});
  });
}

// The 4-d tensor map of a bf16 pool (pages, rows, G, Dh): boxes of 64 dims
// x 1 group x bh rows x 1 page, 128-byte swizzled.
inline cudaError_t pool_map(CUtensorMap* map, const void* base,
                            long long pages, int rows, int G, int Dh,
                            int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)G,
                              (cuuint64_t)rows, (cuuint64_t)pages};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2, (cuuint64_t)G * Dh * 2,
                                 (cuuint64_t)rows * G * Dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)bh, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wgb
