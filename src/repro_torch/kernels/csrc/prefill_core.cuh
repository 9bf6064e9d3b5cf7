// Hopper (sm_90a) prefill-attention core: one block of 64 query rows of one
// KV group walks a key range in tiles, with the online softmax in
// registers.
//
// Used by every kernel of the port for a CTA that holds more (row, head)
// pairs than the decode core's 16 (the "block role"): flash_prefill.cu
// (keys of a contiguous (B, Sk, G, Dh) tensor, dcore::SlabSrc),
// duet_attention.cu (a slab row, dcore::SlabSrc), and paged_decode.cu and
// duet_attention_paged.cu (a page chain, dcore::PagedSrc). The caller says
// which rows the block holds and how far each may see:
//
//   row_off(r) : element offset of row r in q and out, or -1 (no row)
//   lim_of(r)  : the last key row r may see (-1: none); read for rows with
//                row_off(r) >= 0
//
// and the block walks keys k_begin .. k_end - 1, every row clamped to
// k_end - 1. With part == nullptr it writes acc / max(l, DENOM_EPS) to
// out + row_off(r) (a row with no valid key comes out as zeros);
// otherwise it leaves each row's partial (m in log2 units, or NEG_INF for
// a row with no valid key; l; acc) in shared memory at ``part`` in the
// layout dcore::cluster_combine reads (m[ROWS], l[ROWS], acc[ROWS][Dh]),
// for a cluster's rank-order combine (block_cluster does both).
//
// Head blocks (attn::head_split): a tile of bq query positions of a group
// of rep heads holds bq * rep (row, head) pairs; where that is more than
// the block's 64 rows, the group's heads split into hb blocks of at most
// ceil(rep / hb) heads (each a CTA of its own on another grid index), so
// every GQA shape (rep 3, 5, 48, 128 ...) fits, at the cost of re-reading
// the group's keys once per head block (twice at rep 96 or 128; never for
// a registered config).
//
// bf16 (mma_block), FlashAttention-2 style on mma.sync:
//
// * Rows. A block owns ROWS = 64 query rows, 16 a warp, the m of mma.sync
//   m16n8k16. The caller lays them out (flash_prefill: 64 / hpc positions
//   times the hpc heads of a head block, which share every K/V tile; rows
//   past the last whole position are not held).
// * K/V in flight. K and V tiles of BN = 64 keys go through a ring of
//   NSTAGE = 2 stages in shared memory (the next tile loads while this one
//   is computed; a third stage measured no faster) with 16-byte
//   cp.async.cg copies, in bf16; each copy takes its address from the key
//   source (a multiply for a contiguous tensor; the key's page id, read
//   from shared memory, for a page chain). The 16-byte chunks of a row are
//   XOR-swizzled by key (chunk ^ (key / rows per 128-byte line) mod 8) so
//   that the 8 rows of an ldmatrix tile hit 8 bank groups; a lane's
//   ldmatrix addresses are 32-bit shared-window offsets computed once, and
//   moving to chunk 2x of the same rows is an XOR with x * 32. Keys past
//   k_end are zero-filled (cp.async with a source size of 0): stale shared
//   memory could hold NaN, and 0 x NaN is NaN. Up to Dh 128, Q is read
//   once from global memory straight into its A fragments, which stay in
//   registers for the whole key loop. At Dh 256 a warp's 16 x 256 fp32
//   output tile alone is 128 registers a thread, and Q's fragments would
//   be 64 more: Q goes to shared memory with the first K/V tile (a 32 KB
//   swizzled tile beside the 128 KB ring, so one block an SM) and each
//   k-step's A fragment is loaded by ldmatrix inside the key loop.
// * Tensor-core math. S = Q K^T (mma.sync m16n8k16, bf16 -> fp32, K by
//   ldmatrix); the online softmax runs in registers in the log2 domain
//   (ex2 of the scores times scale * log2 e), the row max reduced over the
//   4 lanes of a quad with shuffles; P is repacked from the S
//   accumulators into bf16 A fragments in registers (no trip through
//   shared memory); O += P V with V by ldmatrix.trans. m, l and acc are
//   fp32; l is summed from the bf16-rounded P, as P V sees it, by the
//   tensor cores (P times a column of ones).
// * Masks. Only tiles that cross one of a warp's rows' limits apply the
//   mask; a warp skips a tile that lies wholly past all its rows' limits.
//
// fp32 (simt_block) has no tensor-core type of its precision and runs FMAs
// on the CUDA cores (67 TFLOP/s): the block loops over KV tiles of
// KEY_TILE keys. Q (transposed), K (transposed) and V tiles and the tile's
// probabilities sit in shared memory as fp32; scores, the running max m,
// the denominator l and the accumulator stay in registers. Thread layout
// (128 threads): lane l of warp w owns rows rg * 4 .. rg * 4 + 3 with rg =
// 4 w + l / 8, and, with c = l % 8, the keys c * 4 .. c * 4 + 3 of a tile
// for the scores and the head dims {c * 4 + 32 j + e} for the output; the
// 8 lanes of a row group combine their partial row max and row sum with
// shuffles.
#pragma once

#include <climits>
#include <type_traits>

#include "attn_common.cuh"
#include "decode_core.cuh"   // the key sources and the cluster combine
#include "sm90_mma.cuh"

namespace pcore {

using namespace sm90;   // cp.async, ldmatrix, mma.sync (sm90_mma.cuh)
using attn::DENOM_EPS;
using attn::MASKED_M_THRESHOLD;
using attn::NEG_INF;
using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;            // query rows a block, both paths
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;        // 16 query rows each
constexpr int BM = 16 * MMA_WARPS;  // query rows a block
constexpr int BN = 64;              // keys a K/V tile
constexpr int NSTAGE = 2;           // ring depth: 1 tile in flight
constexpr uint32_t BF16_ONES = 0x3F803F80u;   // two bf16 1.0

template <int DH_>
struct MmaCfg {
  static constexpr int DH = DH_;
  static constexpr int THREADS = 32 * MMA_WARPS;
  static constexpr int ROW_BYTES = DH * 2;
  static constexpr int CPR = ROW_BYTES / 16;    // 16-byte chunks a row
  static constexpr int RPL = CPR >= 8 ? 1 : 8 / CPR;  // rows a 128-B line
  static constexpr int SWZ = CPR >= 8 ? 8 : CPR;      // chunk XOR span
  static constexpr int KPP = THREADS / CPR;     // rows a copy pass
  // a thread copies the same chunk of rows KPP apart; where their swizzle
  // agrees, one offset serves every pass
  static constexpr bool SAME_SWZ = KPP % (8 * RPL) == 0;
  static constexpr int TILE_BYTES = BN * ROW_BYTES;   // K (or V) of a tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
  // Dh 256: Q in shared memory after the ring (see the header)
  static constexpr bool Q_SMEM = DH > 128;
  static constexpr int SMEM_BYTES = RING_BYTES + (Q_SMEM ? BM * ROW_BYTES : 0);
  static_assert(THREADS % CPR == 0 && BN % KPP == 0 && BM % KPP == 0,
                "copy split");

  // byte offset of chunk ch of row t in a K (or V) tile, or in Q's
  __device__ static unsigned chunk_at(int t, int ch) {
    return t * ROW_BYTES + ((ch ^ ((t / RPL) & (SWZ - 1))) * 16);
  }
};

template <int DH, class Src, class RowOff, class LimOf>
__device__ __forceinline__ void mma_block(
    char* smem, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, const Src& src,
    int k_begin, int k_end, RowOff row_off, LimOf lim_of, float scale,
    float* part) {
  using Cf = MmaCfg<DH>;
  constexpr int RB = Cf::ROW_BYTES;
  constexpr int KT = DH / 16;       // k-steps of Q K^T
  constexpr int DT = DH / 8;        // n-tiles of O
  const unsigned ring = smem_addr(smem);        // NSTAGE x (K, V) tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, c = lane & 3;       // mma row group, column pair
  const int j8 = lane >> 3, r8 = lane & 7;      // ldmatrix: tile, row
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  // thread i copies chunk i % CPR of rows i / CPR + j * KPP of a tile, K
  // and V: shared offsets j * KPP rows apart
  const int r0 = threadIdx.x / Cf::CPR;
  const int ch = threadIdx.x % Cf::CPR;
  const unsigned cp_dst = Cf::chunk_at(r0, ch);
  // shared offset of this thread's chunk of row r0 + j * KPP
  auto dst_at = [&](int j) -> unsigned {
    if constexpr (Cf::SAME_SWZ) return cp_dst + j * Cf::KPP * RB;
    else return Cf::chunk_at(r0 + j * Cf::KPP, ch);
  };
  auto issue = [&](int t) {
    const unsigned st = ring + (t % NSTAGE) * Cf::STAGE_BYTES;
    const int key0 = k_begin + t * BN + r0;
    if (k_begin + (t + 1) * BN <= k_end) {   // a full tile
#pragma unroll
      for (int j = 0; j < BN / Cf::KPP; ++j) {
        const size_t off = src.offset(key0 + j * Cf::KPP) + ch * 8;
        cp_async16(st + dst_at(j), k + off);
        cp_async16(st + dst_at(j) + Cf::TILE_BYTES, v + off);
      }
    } else {                        // the last: keys past k_end get zeros
#pragma unroll
      for (int j = 0; j < BN / Cf::KPP; ++j) {
        const int key = key0 + j * Cf::KPP;
        const bool live = key < k_end;
        const size_t off = live ? src.offset(key) + ch * 8 : 0;
        cp_async16(st + dst_at(j), k + off, live ? 16 : 0);
        cp_async16(st + dst_at(j) + Cf::TILE_BYTES, v + off, live ? 16 : 0);
      }
    }
  };
  // Dh 256: the block's Q rows into shared memory (rows it does not hold
  // are zeros), in the first tile's copy group
  const unsigned q_smem = ring + Cf::RING_BYTES;
  if constexpr (Cf::Q_SMEM) {
#pragma unroll
    for (int j = 0; j < BM / Cf::KPP; ++j) {
      const long long off = row_off(r0 + j * Cf::KPP);
      cp_async16(q_smem + dst_at(j), q + (off >= 0 ? off + ch * 8 : 0),
                 off >= 0 ? 16 : 0);
    }
  }
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // this lane's two rows (mma rows gq and gq + 8 of the warp): up to Dh
  // 128 their A fragments of Q, read once from global memory, and the
  // last key each may see (-1: none); rows the block does not hold read
  // no key either
  uint32_t qa[Cf::Q_SMEM ? 1 : KT][4];
  int lim[2];
  long long roff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    roff[h] = row_off(r);
    lim[h] = roff[h] >= 0 ? min(lim_of(r), k_end - 1) : -1;
    if constexpr (!Cf::Q_SMEM) {
      const bf16* qr = q + (roff[h] >= 0 ? roff[h] : 0);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          qa[kk][h + 2 * e] =
              roff[h] >= 0 ? *reinterpret_cast<const uint32_t*>(
                                 qr + kk * 16 + 8 * e + 2 * c)
                           : 0u;
    }
  }
  // Dh 256: the ldmatrix lane offset of the warp's Q A fragments: tiles
  // (rows 0-7, chunk 0), (8-15, 0), (0-7, 1), (8-15, 1) of its 16 rows
  const unsigned q_lane = Cf::chunk_at(warp * 16 + r8 + 8 * (j8 & 1), j8 >> 1);
  // the warp's rows: keys below w_full are valid for every row it writes,
  // keys above w_last for none
  int w_full = min(roff[0] >= 0 ? lim[0] + 1 : INT_MAX,
                   roff[1] >= 0 ? lim[1] + 1 : INT_MAX);
  int w_last = max(lim[0], lim[1]);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    w_full = min(w_full, __shfl_xor_sync(0xffffffffu, w_full, o));
    w_last = max(w_last, __shfl_xor_sync(0xffffffffu, w_last, o));
  }

  // ldmatrix lane offsets within a 16-row block of K or V: the x4 tiles of
  // K (B of Q K^T) are (rows 0-7, chunk 0), (0-7, 1), (8-15, 0), (8-15,
  // 1); of V (B of P V, transposed) (0-7, 0), (8-15, 0), (0-7, 1), (8-15,
  // 1). Chunk 2x of the same lane is the offset XOR x * 32 (the swizzle
  // XORs chunk bits with row bits only); 16-row steps add 16 rows.
  const unsigned k_lane = Cf::chunk_at(r8 + 8 * (j8 >> 1), j8 & 1);
  const unsigned v_lane = Cf::chunk_at(r8 + 8 * (j8 & 1), j8 >> 1);
  const uint32_t ones[2] = {BF16_ONES, BF16_ONES};

  const float qs = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NSTAGE - 2>();    // this thread's copies of tile t landed
    __syncthreads();                // everyone's; tile t - 1 is consumed
    if (t + NSTAGE - 1 < n_tiles) issue(t + NSTAGE - 1);
    cp_async_commit();
    const int k0 = k_begin + t * BN;
    if (k0 > w_last) continue;      // warp-uniform: no key visible to it
    const unsigned ks = ring + (t % NSTAGE) * Cf::STAGE_BYTES;
    const unsigned vs = ks + Cf::TILE_BYTES;

    // S = Q K^T: s[nt] holds keys nt * 8 + 2c, + 1 of rows gq (0, 1) and
    // gq + 8 (2, 3)
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const unsigned kx = ks + (k_lane ^ (kk * 32));
      const uint32_t(&a)[4] = qa[Cf::Q_SMEM ? 0 : kk];
      if constexpr (Cf::Q_SMEM) ldsm_x4(qa[0], q_smem + (q_lane ^ (kk * 32)));
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t r[4];
        ldsm_x4(r, kx + np * 16 * RB);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(s[2 * np], a, b0);
        mma_bf16(s[2 * np + 1], a, b1);
      }
    }
    if (k0 + BN > w_full) {         // the tile crosses a row's limit
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + nt * 8 + 2 * c + (i & 1) > lim[i >> 1])
            s[nt][i] = NEG_INF;
    }

    // online softmax in the log2 domain; a row that has seen no valid key
    // keeps a scaled max of 0, so its masked scores give p = 0
    float alpha[2], msc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx[BN / 16];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        mx[j] = fmaxf(fmaxf(s[2 * j][2 * h], s[2 * j][2 * h + 1]),
                      fmaxf(s[2 * j + 1][2 * h], s[2 * j + 1][2 * h + 1]));
#pragma unroll
      for (int w = BN / 32; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) mx[j] = fmaxf(mx[j], mx[j + w]);
      float mr = fmaxf(m[h], mx[0]);
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
      msc[h] = mr > MASKED_M_THRESHOLD ? mr * qs : 0.f;
      alpha[h] = ex2(m[h] * qs - msc[h]);
      m[h] = mr;
    }
    // P in bf16 A fragments (k-step j takes n-tiles 2j and 2j + 1); the
    // row sums of the rounded P, as P V sees them, come from the tensor
    // cores as P times a column of ones
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pa[nt >> 1][2 * (nt & 1) + h] =
            pack_bf16(ex2(fmaf(s[nt][2 * h], qs, -msc[h])),
                      ex2(fmaf(s[nt][2 * h + 1], qs, -msc[h])));
    float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kj = 0; kj < BN / 16; ++kj) mma_bf16(ls, pa[kj], ones);
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[2];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: V fragments by ldmatrix.trans of the key-major tile
#pragma unroll
    for (int kj = 0; kj < BN / 16; ++kj)
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_t(r, vs + kj * 16 * RB + (v_lane ^ (dp * 32)));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(o[2 * dp], pa[kj], b0);
        mma_bf16(o[2 * dp + 1], pa[kj], b1);
      }
  }
  cp_async_wait<0>();

  if (part == nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (roff[h] < 0) continue;
      const float inv = 1.f / fmaxf(l[h], DENOM_EPS);
      bf16* orow = out + roff[h];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * c) =
            pack_bf16(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
    }
    return;
  }
  __syncthreads();                  // the ring is free for the partials
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    if (c == 0) {
      part[r] = m[h] > MASKED_M_THRESHOLD ? m[h] * qs : NEG_INF;
      part[BM + r] = l[h];
    }
    float* a = part + 2 * BM + r * DH + 2 * c;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(a + dt * 8) =
          make_float2(o[dt][2 * h], o[dt][2 * h + 1]);
  }
}

// Calls fn(MmaCfg<Dh>{}) for a head dim of 32, 64, 128 or 256.
template <class Fn>
cudaError_t dispatch_mma(int Dh, Fn fn) {
  switch (Dh) {
    case 32: return fn(MmaCfg<32>{});
    case 64: return fn(MmaCfg<64>{});
    case 128: return fn(MmaCfg<128>{});
    case 256: return fn(MmaCfg<256>{});
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int SIMT_THREADS = 128;
constexpr int KEY_TILE = 32;        // keys staged per step
constexpr int QS = ROWS + 4;        // qT / pT row stride (floats)
constexpr int KS = KEY_TILE + 4;    // kT row stride (floats)

// dynamic shared memory of simt_block for head dim Dh
constexpr int simt_smem_bytes(int Dh) {
  return 4 * (Dh * QS + Dh * KS + KEY_TILE * Dh + KEY_TILE * QS);
}

template <typename T, int Dh, class Src, class RowOff, class LimOf>
__device__ __forceinline__ void simt_block(
    char* smem_raw, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, const Src& src,
    int k_begin, int k_end, RowOff row_off, LimOf lim_of, float scale,
    float* part) {
  using attn::from_f32;
  using attn::to_f32;
  constexpr int DPT = Dh / 8;       // output dims per thread
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = Dh / EPC;     // 16-byte chunks per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp * 4 + (lane >> 3), c = lane & 7;

  float* smem = reinterpret_cast<float*>(smem_raw);
  float* qT = smem;                 // [Dh][QS]: qT[d][row]
  float* kT = qT + Dh * QS;         // [Dh][KS]: kT[d][key]
  float* v_s = kT + Dh * KS;        // [KEY_TILE][Dh]
  float* pT = v_s + KEY_TILE * Dh;  // [KEY_TILE][QS]: pT[key][row]

  // Q rows of the block, transposed; rows the block does not hold are
  // zeros
  for (int i = threadIdx.x; i < ROWS * CPR; i += SIMT_THREADS) {
    const int r = i % ROWS, ch = i / ROWS;
    const long long off = row_off(r);
    float vals[EPC];
    if (off >= 0) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(q + off + ch * EPC);
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

  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    lim[i] = row_off(r) >= 0 ? min(lim_of(r), k_end - 1) : -1;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += KEY_TILE) {
    const int nk = min(KEY_TILE, k_end - k0);
    __syncthreads();  // Q staged / the previous tile fully consumed
    // K transposed (key fastest across threads: conflict-free stores)
    for (int i = threadIdx.x; i < KEY_TILE * CPR; i += SIMT_THREADS) {
      const int key = i % KEY_TILE, ch = i / KEY_TILE;
      float vals[EPC];
      if (key < nk) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            k + src.offset(k0 + key) + ch * EPC);
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
    for (int i = threadIdx.x; i < nk * CPR; i += SIMT_THREADS) {
      const int key = i / CPR, ch = i % CPR;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          v + src.offset(k0 + key) + ch * EPC);
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
        s[i][j] = k0 + c * 4 + j <= lim[i] ? s[i][j] * scale : NEG_INF;
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

  if (part == nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long off = row_off(rg * 4 + i);
      if (off < 0) continue;
      const float inv = 1.f / fmaxf(l[i], DENOM_EPS);
      T* o = out + off;
#pragma unroll
      for (int j = 0; j < DPT / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[c * 4 + 32 * j + e] = from_f32<T>(acc[i][4 * j + e] * inv);
    }
    return;
  }
  __syncthreads();                  // the tiles are free for the partials
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (c == 0) {   // natural-log max to log2 units
      part[r] = m[i] > MASKED_M_THRESHOLD ? m[i] * LOG2E : NEG_INF;
      part[ROWS + r] = l[i];
    }
#pragma unroll
    for (int j = 0; j < DPT / 4; ++j)
      *reinterpret_cast<float4*>(part + 2 * ROWS + r * Dh + c * 4 + 32 * j) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                      acc[i][4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// a block-role CTA of a cluster
// ---------------------------------------------------------------------------
// Dynamic shared memory of a block-role CTA: its ring (bf16) or tiles
// (fp32), reused after the walk for its partial and the cluster combine's
// weights (dcore::cluster_combine's layout for ROWS rows).
template <typename T, int DH>
struct BlockCfg {
  static constexpr bool MMA = sizeof(T) == 2;
  static constexpr int THREADS = 128;
  static constexpr int TILE_BYTES =
      MMA ? MmaCfg<DH>::SMEM_BYTES : simt_smem_bytes(DH);
  static constexpr int PART_BYTES =
      4 * ROWS * ((DH + 2) + (dcore::MAX_CLUSTER + 1));
  static constexpr int MAIN_BYTES = dcore::cmax(TILE_BYTES, PART_BYTES);
  static_assert(THREADS == (MMA ? MmaCfg<DH>::THREADS : SIMT_THREADS),
                "one block shape");
};

// The block over this CTA's span k_begin .. k_end - 1 of a cluster of C
// CTAs (rows and limits as for mma_block), then, with C > 1 or
// ``want_lse``, the ranks' partials combined in rank order
// (dcore::cluster_combine) and row r, column d of the output handed to
// write_out(r, d, value) and the row's log-sum-exp to write_lse(r, value).
// With C = 1 and no log-sum-exp asked for the block writes its rows
// itself. Every CTA of the cluster must call it.
template <typename T, int DH, class Src, class RowOff, class LimOf,
          class Out, class Lse = dcore::NoLse>
__device__ __forceinline__ void block_cluster(
    char* smem, const T* q, const T* k, const T* v, T* out, const Src& src,
    int k_begin, int k_end, RowOff row_off, LimOf lim_of, int nrows,
    float scale, int C, Out write_out, bool want_lse = false,
    Lse write_lse = Lse{}) {
  float* part = C > 1 || want_lse ? reinterpret_cast<float*>(smem)
                                  : nullptr;
  if constexpr (BlockCfg<T, DH>::MMA)
    mma_block<DH>(smem, q, k, v, out, src, k_begin, k_end, row_off, lim_of,
                  scale, part);
  else
    simt_block<T, DH>(smem, q, k, v, out, src, k_begin, k_end, row_off,
                      lim_of, scale, part);
  if (part)
    dcore::cluster_combine<ROWS, DH, BlockCfg<T, DH>::THREADS>(
        part, nrows, write_out, write_lse);
}

// Calls fn((T*)nullptr, std::integral_constant<int, Dh>{}) for the dtype
// code and a head dim of 32, 64, 128 or 256.
template <class Fn>
cudaError_t dispatch_t_dh(int dtype, int Dh, Fn fn) {
#define PCORE_CASE(TT, D) \
  if (Dh == D) return fn((TT*)nullptr, std::integral_constant<int, D>{});
  if (dtype == attn::DTYPE_F32) {
    PCORE_CASE(float, 32)
    PCORE_CASE(float, 64)
    PCORE_CASE(float, 128)
    PCORE_CASE(float, 256)
  } else if (dtype == attn::DTYPE_BF16) {
    PCORE_CASE(__nv_bfloat16, 32)
    PCORE_CASE(__nv_bfloat16, 64)
    PCORE_CASE(__nv_bfloat16, 128)
    PCORE_CASE(__nv_bfloat16, 256)
  }
#undef PCORE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace pcore
