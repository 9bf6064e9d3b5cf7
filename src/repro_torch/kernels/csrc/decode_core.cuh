// Hopper (sm_90a) decode-attention core: a key range split across a
// thread-block cluster, each CTA fed by a cp.async ring.
//
// Used by paged_decode.cu (the plain page walk, paged_decode_launch) and
// duet_attention.cu (the slab kernel). Both are bound by memory: each live
// KV byte is read once and the arithmetic is 4 FLOP per KV element, far
// below the card's ridge. What this core does about it:
//
// * Enough CTAs. A request (or slab tile) and KV group own a cluster of C
//   CTAs (grid z, cluster dims (1, 1, C)); the host picks the largest C (at
//   most 8) whose grid the card runs in one wave (ops.cluster_size). Each
//   CTA walks one contiguous span of the keys and keeps its partial
//   (m, l, acc) in its own shared memory. After cluster.sync(), each rank
//   reads a 1/C share of the rows from every rank's partial through
//   distributed shared memory and does the log-sum-exp combine in rank
//   order (a split whose max is at or below MASKED_M_THRESHOLD weighs 0),
//   then writes those rows. A second cluster.sync() keeps every CTA's
//   shared memory alive until all have read it. One launch, no HBM
//   scratch, a fixed sum order.
// * Loads in flight. K/V rows go to a ring of NSTAGE stages of SK keys with
//   16-byte cp.async.cg copies (commit_group / wait_group), NSTAGE - 1 stages
//   ahead of the compute; the stage being computed is the only one waited
//   for. Rows stay in the input dtype in shared memory. One key offset
//   serves the K and the V copy. TMA is not used: a paged row is 256 B with
//   a 2 KB stride behind a table indirection, which a tensor map
//   (cuTensorMapEncodeTiled, driver API, -lcuda) would need per page;
//   per-thread cp.async addresses take the indirection directly.
// * Every lane busy, few instructions per key. Warps split a stage's keys
//   and each key is taken against all query rows of the group at once.
//   bf16 (the serving paths) runs on the tensor cores: mma.sync m16n8k16
//   computes S^T = K Q^T (16 keys x 8 query rows a warp, so up to 8 rows
//   fill the n dimension without padding to 16) and O^T += V^T P^T; K and V
//   tiles come in by ldmatrix (.trans for V) from a ring whose 16-byte
//   chunks are XOR-swizzled by key so that the 8 rows of a tile hit 8
//   different bank groups; P^T goes through a 256-byte tile per warp. fp32
//   runs on the CUDA cores (fp32 has no tensor-core path of that
//   precision): tokens across warps, Dh across lanes, the 32 partial dot
//   products of a warp step (TPS keys x NRB rows) summed by one 31-shuffle
//   transpose-reduce. Scores, m, l and acc are fp32 in both; scores are in
//   the log2 domain (scaled by scale * log2(e)). The bf16 path rounds P to
//   bf16 for the P.V product and sums l from the rounded values. The
//   cp.async, ldmatrix and mma.sync wrappers live in sm90_mma.cuh, shared
//   with flash_prefill.cu.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"
#include "sm90_mma.cuh"

namespace dcore {

namespace cg = cooperative_groups;
using namespace sm90;   // cp.async, ldmatrix, mma.sync (sm90_mma.cuh)
using attn::DENOM_EPS;
using attn::MASKED_M_THRESHOLD;
using attn::NEG_INF;

constexpr int NSTAGE = 3;            // ring depth: 2 stages in flight
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int MAX_ROWS = 16;         // query rows of a CTA (the row buckets)
constexpr int SPLIT_KEYS = 64;       // the duet kernels' split unit (keys)
constexpr int MMA_WARPS = 4;         // bf16: 16 keys a warp, SK = 64
constexpr int SIMT_WARPS = 4;        // fp32
constexpr int SIMT_STAGE = 16384;    // fp32: bytes of K + V per stage
constexpr float LOG2E = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Compile-time shape of one CTA. NRB: the query-row bucket (bf16: 8 or 16,
// fp32: 4 or 16).
template <typename T_, int DH_, int NRB_>
struct Cfg {
  using T = T_;
  static constexpr int DH = DH_, NRB = NRB_;
  static constexpr bool MMA = sizeof(T) == 2;
  static constexpr int WARPS = MMA ? MMA_WARPS : SIMT_WARPS;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int ROW_BYTES = DH * (int)sizeof(T);
  static constexpr int SK =
      MMA ? 16 * WARPS
          : cmax(16, cmin(64, SIMT_STAGE / (2 * ROW_BYTES)));  // keys a stage
  static constexpr int CPR = ROW_BYTES / 16;       // 16-byte chunks a row
  static constexpr int SWZ = MMA ? cmin(8, CPR) : 1;   // chunk XOR span
  static constexpr int STAGE_BYTES = 2 * SK * ROW_BYTES;   // K rows, V rows
  static constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
  // fp32 (CUDA cores): a lane's columns and the warp steps
  static constexpr int EPL = DH / 32;              // elements per lane
  static constexpr int TPS = 32 / NRB;             // keys per warp step
  static constexpr int TPW = SK / WARPS;           // keys per warp
  static constexpr int STEPS = (TPW + TPS - 1) / TPS;
  // per warp: fp32 probabilities of a stage, or the bf16 P^T tiles
  static constexpr int PROB_BYTES =
      WARPS * (MMA ? (NRB / 8) * 256 : STEPS * 32 * 4);
  // after the walk the ring holds the warps' partials, the CTA's, and
  // the combine's weights
  static constexpr int PART_BYTES =
      ((WARPS + 1) * NRB * (DH + 2) + NRB * (MAX_CLUSTER + 1)) * 4;
  static constexpr int MAIN_BYTES = cmax(RING_BYTES, PART_BYTES);
  static constexpr int FIXED_BYTES = MAIN_BYTES + PROB_BYTES;  // + page ids
  static_assert(SK % WARPS == 0 && SPLIT_KEYS % SK == 0, "stage keys");
  static_assert(MMA ? NRB % 8 == 0 : NRB * TPS == 32, "row bucket");

  // byte offset of chunk ch of key t in a stage's K (or V) rows
  __device__ static int chunk_at(int t, int ch) {
    return t * ROW_BYTES + ((ch ^ (t & (SWZ - 1))) * 16);
  }
};

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------
// Key addressing, in elements from the pool (or slab) base.
struct PagedSrc {            // key -> page pid[(key - key0) / ps]
  const int* pid;            // the span's page ids (shared memory)
  int key0, ps;
  int ps_shift;              // log2(ps), or -1 if ps is no power of two
  size_t page_elems, row_elems, goff;
  __device__ size_t offset(int key) const {
    const int rel = key - key0;
    const int pi = ps_shift >= 0 ? rel >> ps_shift : rel / ps;
    return (size_t)pid[pi] * page_elems + (size_t)(rel - pi * ps) * row_elems +
           goff;
  }
};
struct SlabSrc {             // key -> row key of the slot
  size_t base, row_elems;
  __device__ size_t offset(int key) const {
    return base + (size_t)key * row_elems;
  }
};

// Copy keys k0 .. k0 + nk - 1 (nk <= SK) of K and V into one ring stage:
// thread i copies 16-byte chunk i % CPR of every (THREADS / CPR)-th key,
// from K and from V, so one key offset serves two copies. The bf16 path
// zero-fills keys past nk (its P.V product reads whole 16-key tiles).
template <class Cf, typename T, class Src>
__device__ __forceinline__ void issue_stage(char* stage, const T* k,
                                            const T* v, const Src& src,
                                            int k0, int nk) {
  constexpr int KPP = Cf::THREADS / Cf::CPR;      // keys per pass
  static_assert(Cf::THREADS % Cf::CPR == 0 && Cf::SK % KPP == 0,
                "copy split");
  const int c = threadIdx.x % Cf::CPR;
#pragma unroll
  for (int j = 0; j < Cf::SK / KPP; ++j) {
    const int t = threadIdx.x / Cf::CPR + j * KPP;
    char* dst = stage + Cf::chunk_at(t, c);
    if (t < nk) {
      const size_t off = src.offset(k0 + t);
      cp_async16(dst, reinterpret_cast<const char*>(k + off) + c * 16);
      cp_async16(dst + Cf::SK * Cf::ROW_BYTES,
                 reinterpret_cast<const char*>(v + off) + c * 16);
    } else if (Cf::MMA) {
      cp_async16(dst, k, 0);
      cp_async16(dst + Cf::SK * Cf::ROW_BYTES, v, 0);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
// One lane's state on the tensor-core path. With g = lane / 4, c = lane % 4,
// the lane holds rows nt * 8 + 2c and 2c + 1 of every 8-row tile nt: their
// running max and (its share of) the denominator, the B fragments of Q^T,
// and the O^T fragments of columns mt * 16 + g and + g + 8.
template <class Cf>
struct MmaState {
  static constexpr int NT = Cf::NRB / 8, KS = Cf::DH / 16, MT = Cf::DH / 16;
  uint32_t qb[KS][NT][2];
  float acc[MT][NT][4];
  float m[NT][2], l[NT][2];
  int lim[NT][2];
  float qscale;

  template <class RowOf, class LimOf>
  __device__ __forceinline__ void init(RowOf qrow, LimOf lim_of, int nrows,
                                       float scale) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    qscale = scale * LOG2E;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int row = nt * 8 + g;
      const __nv_bfloat16* q = row < nrows ? qrow(row) : nullptr;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          qb[kk][nt][h] =
              q ? *reinterpret_cast<const uint32_t*>(q + kk * 16 + h * 8 +
                                                     2 * c)
                : 0u;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = nt * 8 + 2 * c + j;
        lim[nt][j] = r < nrows ? lim_of(r) : -1;
        m[nt][j] = NEG_INF;
        l[nt][j] = 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }

  // keys k0 .. k0 + nk - 1 of a landed stage; this warp takes 16 of them
  __device__ __forceinline__ void attend(const char* stage, char* pt, int k0,
                                         int nk) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    const int t_w = warp * 16;
    const int n_w = min(16, nk - t_w);           // warp-uniform
    if (n_w <= 0) return;
    const char* ks = stage;
    const char* vs = stage + Cf::SK * Cf::ROW_BYTES;
    const int j8 = lane >> 3, r8 = lane & 7;     // ldmatrix: matrix, row

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    const int kt = t_w + r8 + 8 * (j8 & 1);      // S^T: A = K (keys x dims)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_addr(ks + Cf::chunk_at(kt, 2 * kk + (j8 >> 1))));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(s[nt], a, qb[kk][nt]);
    }

    // online softmax; s[nt][i]: key g + 8 (i / 2), row nt * 8 + 2c + i % 2
    float alpha[NT][2];
    uint32_t* ptw = reinterpret_cast<uint32_t*>(pt);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = g + 8 * (i >> 1);
        s[nt][i] = (t < n_w && k0 + t_w + t <= lim[nt][i & 1])
                       ? s[nt][i] * qscale
                       : NEG_INF;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = fmaxf(s[nt][j], s[nt][j + 2]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[nt][j], mx);
        alpha[nt][j] = exp2f(m[nt][j] - m_new);
        // dead-row guard: while the row has seen no valid key, p = 0
        const bool live = m_new > MASKED_M_THRESHOLD;
        s[nt][j] = live ? exp2f(s[nt][j] - m_new) : 0.f;
        s[nt][j + 2] = live ? exp2f(s[nt][j + 2] - m_new) : 0.f;
        m[nt][j] = m_new;
      }
      // P^T tile [key][8 rows] in bf16; l from the rounded values
      const uint32_t lo = pack_bf16(s[nt][0], s[nt][1]);
      const uint32_t hi = pack_bf16(s[nt][2], s[nt][3]);
      ptw[nt * 64 + g * 4 + c] = lo;
      ptw[nt * 64 + (g + 8) * 4 + c] = hi;
      const float2 fl = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&lo));
      const float2 fh = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hi));
      l[nt][0] = l[nt][0] * alpha[nt][0] + fl.x + fh.x;
      l[nt][1] = l[nt][1] * alpha[nt][1] + fl.y + fh.y;
    }
    __syncwarp();
    uint32_t pb[NT][2];                          // B = P^T (keys x rows)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      ldsm_x2_t(pb[nt], smem_addr(pt + nt * 256 + (lane & 15) * 16));

    const int vt = t_w + r8 + 8 * (j8 >> 1);     // O^T: A = V^T (dims x keys)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldsm_x4_t(a, smem_addr(vs + Cf::chunk_at(vt, 2 * mt + (j8 & 1))));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[mt][nt][0] *= alpha[nt][0];
        acc[mt][nt][1] *= alpha[nt][1];
        acc[mt][nt][2] *= alpha[nt][0];
        acc[mt][nt][3] *= alpha[nt][1];
        mma_bf16(acc[mt][nt], a, pb[nt]);
      }
    }
    __syncwarp();                                // pt is reused next stage
  }

  __device__ __forceinline__ void write_partials(float* w_m, float* w_l,
                                                 float* w_acc) {
    constexpr int NRB = Cf::NRB, DH = Cf::DH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float lt = l[nt][j];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          lt += __shfl_xor_sync(0xffffffffu, lt, o);
        const int r = nt * 8 + 2 * c + j;
        if (g == 0) {
          w_m[warp * NRB + r] = m[nt][j];
          w_l[warp * NRB + r] = lt;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* a = w_acc + (warp * NRB + r) * DH + mt * 16 + g;
          a[0] = acc[mt][nt][j];
          a[8] = acc[mt][nt][j + 2];
        }
      }
  }
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
// Lane L ends with the sum over the warp of value L (31 shuffles for 32
// sums): at each step a lane keeps the half of its values whose index bit
// matches its lane bit and adds the partner's copy of that half. One
// template per step keeps every index of v a constant (registers, not
// local memory).
template <int O>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}
__device__ __forceinline__ float transpose_reduce32(float (&v)[32], int lane) {
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// One lane's state on the CUDA-core path: columns lane + 32 e of every
// query row (q pre-scaled, acc), and the running max and denominator share
// of row lane % NRB.
template <class Cf>
struct SimtState {
  static constexpr int NRB = Cf::NRB, EPL = Cf::EPL, DH = Cf::DH;
  float q[NRB][EPL];
  float acc[NRB][EPL];
  float m, l;
  int lim;

  template <class RowOf, class LimOf>
  __device__ __forceinline__ void init(RowOf qrow, LimOf lim_of, int nrows,
                                       float scale) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < NRB; ++r)
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        q[r][e] = r < nrows ? qrow(r)[lane + 32 * e] * (scale * LOG2E) : 0.f;
        acc[r][e] = 0.f;
      }
    const int r = lane % NRB;
    lim = r < nrows ? lim_of(r) : -1;
    m = NEG_INF;
    l = 0.f;
  }

  __device__ __forceinline__ void attend(const char* stage, char* pbuf,
                                         int k0, int nk) {
    constexpr int TPS = Cf::TPS, TPW = Cf::TPW;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t_w = warp * TPW;                  // the warp's first key
    const int n_w = min(TPW, nk - t_w);          // its live keys
    if (n_w <= 0) return;
    const float* ks = reinterpret_cast<const float*>(stage);
    const float* vs = ks + Cf::SK * DH;
    float* prob = reinterpret_cast<float*>(pbuf);

    float s[Cf::STEPS];
    float mx = NEG_INF;
#pragma unroll
    for (int st = 0; st < Cf::STEPS; ++st) {
      float v[32];
#pragma unroll
      for (int tt = 0; tt < TPS; ++tt) {
        const int tl = st * TPS + tt;
        float kf[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          kf[e] = tl < n_w ? ks[(t_w + tl) * DH + lane + 32 * e] : 0.f;
#pragma unroll
        for (int r = 0; r < NRB; ++r) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d = fmaf(q[r][e], kf[e], d);
          v[tt * NRB + r] = d;
        }
      }
      const float x = transpose_reduce32(v, lane);
      const int tl = st * TPS + lane / NRB;
      s[st] = (tl < n_w && k0 + t_w + tl <= lim) ? x : NEG_INF;
      mx = fmaxf(mx, s[st]);
    }
#pragma unroll
    for (int o = NRB; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    // dead-row guard: while the row has seen no valid key, p = 0
    const bool live = m_new > MASKED_M_THRESHOLD;
    float psum = 0.f;
#pragma unroll
    for (int st = 0; st < Cf::STEPS; ++st) {
      const float p = live ? exp2f(s[st] - m_new) : 0.f;
      prob[st * 32 + lane] = p;                  // [key][row]
      psum += p;
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int r = 0; r < NRB; ++r) {
      const float a = __shfl_sync(0xffffffffu, alpha, r);   // lane r: row r
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= a;
    }
    __syncwarp();
#pragma unroll
    for (int tl = 0; tl < TPW; ++tl) {
      if (tl >= n_w) break;
      float vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vf[e] = vs[(t_w + tl) * DH + lane + 32 * e];
#pragma unroll
      for (int r4 = 0; r4 < NRB; r4 += 4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(prob + tl * NRB + r4);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[r4 + r][e] = fmaf(pr[r], vf[e], acc[r4 + r][e]);
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ void write_partials(float* w_m, float* w_l,
                                                 float* w_acc) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float lt = l;
#pragma unroll
    for (int o = NRB; o < 32; o <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    if (lane < NRB) {                            // lane r holds row r
      w_m[warp * NRB + lane] = m;
      w_l[warp * NRB + lane] = lt;
    }
#pragma unroll
    for (int r = 0; r < NRB; ++r)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        w_acc[(warp * NRB + r) * DH + lane + 32 * e] = acc[r][e];
  }
};

// ---------------------------------------------------------------------------
// the CTA and the cluster
// ---------------------------------------------------------------------------
// The cluster's combine: every CTA holds its partial of ``nrows`` rows at
// c_m in the layout m[NRB] (log2 units; at or below MASKED_M_THRESHOLD: no
// valid key), l[NRB], acc[NRB][DH], followed by room for weights
// [NRB][MAX_CLUSTER] and inverse denominators [NRB]. Rank r combines rows
// [r * ceil(nrows / C), ...) of every rank's partial in rank order (each
// rank keeps its rows' weights in its own room), reading (m, l) one thread
// a row and acc as float4s, one per rank in flight at once, through
// distributed shared memory, and hands row r, column d of the output to
// write_out(r, d, value) and the row's natural-log log-sum-exp over the
// cluster's keys, (max m + log2 l) * ln 2 (-inf for a row that saw no
// valid key), to write_lse(r, value). Every CTA of the cluster must call
// it.
struct NoLse {   // the default write_lse: the log-sum-exp is not asked for
  __device__ void operator()(int, float) const {}
};

template <int NRB, int DH, int THREADS, class Out, class Lse = NoLse>
__device__ __forceinline__ void cluster_combine(float* c_m, int nrows,
                                                Out write_out,
                                                Lse write_lse = Lse{}) {
  float* c_l = c_m + NRB;
  float* c_acc = c_l + NRB;
  float* wgt = c_acc + NRB * DH;                    // [NRB][MAX_CLUSTER]
  float* den = wgt + NRB * MAX_CLUSTER;             // [NRB]
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int C = (int)cluster.num_blocks();
  const int share = (nrows + C - 1) / C;
  const int r0 = min((int)cluster.block_rank() * share, nrows);
  const int r1 = min(r0 + share, nrows);
  if (threadIdx.x < r1 - r0) {
    const int r = r0 + threadIdx.x;
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      mr[c] = c < C ? *cluster.map_shared_rank(c_m + r, c) : NEG_INF;
      lr[c] = c < C ? *cluster.map_shared_rank(c_l + r, c) : 0.f;
    }
    float ms = NEG_INF;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) ms = fmaxf(ms, mr[c]);
    float ls = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      const float wt = mr[c] > MASKED_M_THRESHOLD ? exp2f(mr[c] - ms) : 0.f;
      wgt[r * MAX_CLUSTER + c] = wt;
      ls += wt * lr[c];
    }
    den[r] = 1.f / fmaxf(ls, DENOM_EPS);
    write_lse(r, ms > MASKED_M_THRESHOLD && ls > 0.f
                     ? (ms + log2f(ls)) * 0.6931471805599453f
                     : __int_as_float((int)0xff800000u));    // -inf
  }
  __syncthreads();
  constexpr int V = DH / 4;                         // float4s a row
#pragma unroll 2
  for (int i = threadIdx.x; i < (r1 - r0) * V; i += THREADS) {
    const int r = r0 + i / V, d = (i % V) * 4;
    float4 x[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      x[c] = c < C ? *reinterpret_cast<const float4*>(
                         cluster.map_shared_rank(c_acc + r * DH + d, c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      const float w = c < C ? wgt[r * MAX_CLUSTER + c] : 0.f;
      a.x += w * x[c].x;
      a.y += w * x[c].y;
      a.z += w * x[c].z;
      a.w += w * x[c].w;
    }
    const float inv = den[r];
    write_out(r, d, a.x * inv);
    write_out(r, d + 1, a.y * inv);
    write_out(r, d + 2, a.z * inv);
    write_out(r, d + 3, a.w * inv);
  }
  cluster.sync();                  // keep every rank's partial alive
}

// Walk keys k_begin .. k_end - 1 of this CTA's span through the ring for
// ``nrows`` query rows (row r at qrow(r), seeing keys up to lim_of(r)),
// combine the warps' partials, then the cluster's, and hand row r,
// column d of the output to write_out(r, d, value) and its log-sum-exp
// to write_lse(r, value) (cluster_combine). Every CTA of the cluster must
// call it, also with an empty span.
template <class Cf, class Src, class RowOf, class LimOf, class Out,
          class Lse = NoLse>
__device__ __forceinline__ void decode_cluster(
    char* smem, const typename Cf::T* k, const typename Cf::T* v,
    const Src& src, int k_begin, int k_end, RowOf qrow, LimOf lim_of,
    int nrows, float scale, Out write_out, Lse write_lse = Lse{}) {
  constexpr int SK = Cf::SK, NRB = Cf::NRB, DH = Cf::DH;
  constexpr int WARPS = Cf::WARPS, THREADS = Cf::THREADS;
  using State =
      typename std::conditional<Cf::MMA, MmaState<Cf>, SimtState<Cf>>::type;
  const int warp = threadIdx.x >> 5;
  char* pbuf = smem + Cf::MAIN_BYTES + warp * (Cf::PROB_BYTES / WARPS);

  State st;
  st.init(qrow, lim_of, nrows, scale);

  const int n_keys = max(k_end - k_begin, 0);
  const int n_st = (n_keys + SK - 1) / SK;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_st)
      issue_stage<Cf>(smem + s * Cf::STAGE_BYTES, k, v, src, k_begin + s * SK,
                      min(SK, n_keys - s * SK));
    cp_async_commit();
  }
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<NSTAGE - 2>();   // this thread's copies of stage s landed
    __syncthreads();               // everyone's; stage s - 1 is consumed
    const int nx = s + NSTAGE - 1;
    if (nx < n_st)
      issue_stage<Cf>(smem + (nx % NSTAGE) * Cf::STAGE_BYTES, k, v, src,
                      k_begin + nx * SK, min(SK, n_keys - nx * SK));
    cp_async_commit();
    st.attend(smem + (s % NSTAGE) * Cf::STAGE_BYTES, pbuf, k_begin + s * SK,
              min(SK, n_keys - s * SK));
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free for the partials

  // the warps' partials: (m, l) per row, acc per row and column
  float* w_m = reinterpret_cast<float*>(smem);      // [WARPS][NRB]
  float* w_l = w_m + WARPS * NRB;                   // [WARPS][NRB]
  float* w_acc = w_l + WARPS * NRB;                 // [WARPS][NRB][DH]
  float* c_m = w_acc + WARPS * NRB * DH;            // [NRB]: this CTA's
  float* c_l = c_m + NRB;                           // [NRB]
  float* c_acc = c_l + NRB;                         // [NRB][DH]
  st.write_partials(w_m, w_l, w_acc);
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * DH; i += THREADS) {
    const int r = i / DH, d = i - r * DH;
    float mc = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mc = fmaxf(mc, w_m[w * NRB + r]);
    float lc = 0.f, ac = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = w_m[w * NRB + r];
      const float wt = mw > MASKED_M_THRESHOLD ? exp2f(mw - mc) : 0.f;
      lc += wt * w_l[w * NRB + r];
      ac += wt * w_acc[(w * NRB + r) * DH + d];
    }
    c_acc[r * DH + d] = ac;
    if (d == 0) {
      c_m[r] = mc;
      c_l[r] = lc;
    }
  }

  cluster_combine<NRB, DH, THREADS>(c_m, nrows, write_out, write_lse);
}

// Shared memory above 48 KB and clusters above the portable 8 CTAs are
// allowed per kernel, before a launch or an occupancy query.
template <typename... Params>
cudaError_t allow(void (*kernel)(Params...), int C, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (C > MAX_CLUSTER)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return cudaSuccess;
}

// Launch ``kernel`` (Cf's instantiation) on grid with cluster dims
// (1, 1, C).
template <class Cf, typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int C,
                           size_t smem, cudaStream_t stream, Args... args) {
  {
    const cudaError_t e = allow(kernel, C, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Cf::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How many clusters of C CTAs of ``kernel`` (with ``smem`` bytes each) the
// SMs of ``stream``'s context hold at once (cudaOccupancyMaxActiveClusters:
// with a green context's stream in the configuration it counts that
// context's SMs; the null stream, the whole card).
template <class Cf, typename... Params>
cudaError_t max_active_clusters(void (*kernel)(Params...), int C, size_t smem,
                                int* n, cudaStream_t stream) {
  {
    const cudaError_t e = allow(kernel, C, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, C);
  cfg.blockDim = dim3(Cf::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, (void*)kernel, &cfg);
}

// Calls fn(Cfg<T, DH, NRB>{}) for the dtype code, head dim and query rows
// of one CTA (bf16: NRB 8 up to 8 rows, else 16; fp32: 4 up to 4, else 16).
template <class Fn>
cudaError_t dispatch(int dtype, int Dh, int rows, Fn fn) {
  if (rows < 1 || rows > MAX_ROWS) return cudaErrorInvalidValue;
#define DCORE_CASE(TT, D, SMALL)                                          \
  if (Dh == D)                                                            \
    return rows <= SMALL ? fn(Cfg<TT, D, SMALL>{}) : fn(Cfg<TT, D, 16>{});
  if (dtype == attn::DTYPE_F32) {
    DCORE_CASE(float, 32, 4)
    DCORE_CASE(float, 64, 4)
    DCORE_CASE(float, 128, 4)
    DCORE_CASE(float, 256, 4)
  } else if (dtype == attn::DTYPE_BF16) {
    DCORE_CASE(__nv_bfloat16, 32, 8)
    DCORE_CASE(__nv_bfloat16, 64, 8)
    DCORE_CASE(__nv_bfloat16, 128, 8)
    DCORE_CASE(__nv_bfloat16, 256, 8)
  }
#undef DCORE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace dcore
