// Causal GQA flash attention for prefill, for Hopper (sm_90a).
//
// Replaces the Pallas kernel flash_prefill of
// src/repro/kernels/flash_prefill.py (_kernel).
//
// Contract (as the reference): q (B, Sq, H, Dh); k/v (B, Sk, G, Dh) fp32 or
// bf16; query i sits at absolute position q_offset + i (chunked prefill:
// the queries are the tail of the key range); key k is valid for query i
// iff k <= q_offset + i and k < kv_len. Output (B, Sq, H, Dh) in q's type,
// acc / max(l, DENOM_EPS), so a row with no valid key comes out as zeros.
// Unlike the Pallas kernel, Sq and Sk need not divide by any block size:
// every block masks its ragged edge itself.
//
// Bound: operations. Each valid (query head, key) pair costs 4 * Dh flops
// against 4 * Dh bytes of K/V per key, read once per block of rows; at
// the serving path's chunk shapes the arithmetic is far above the card's
// 295 FLOP/byte ridge, so the bound is 989 bf16 TFLOP/s on the tensor
// cores. This kernel issues mma.sync from registers; every K/V fragment
// goes shared memory -> ldmatrix -> registers, and the softmax, the
// rescale of O and the copies share each warp's issue slots with the
// MMAs, so at long prompts it is bound by instruction issue and latency
// well short of the tensor cores' peak (a warpgroup design on wgmma,
// reading K and V straight from shared memory, is what removes that). At
// a short chunk (the main shape: 256 queries over 768 keys, 128 blocks)
// each block walks its 9 to 12 tiles one after another, and the launch
// and that serial walk set the time.
//
// bf16 (flash_prefill_mma_kernel), FlashAttention-2 style on mma.sync:
//
// * Rows and grid. A block owns BM = 64 query rows of one KV group: BQ =
//   64 / rep positions times the rep heads of the group, which share
//   every K/V tile (row r is position q0 + r / rep, head g * rep + r %
//   rep). Each of its 4 warps owns 16 rows, the m of mma.sync m16n8k16.
//   Grid (ceil(Sq / BQ), G, B); block x takes row tile gridDim.x - 1 - x,
//   so the tiles with the most keys (causal: the work grows with the
//   position) start first and do not form the tail.
// * Two blocks an SM (__launch_bounds__(128, 2); ptxas gives the Dh 128
//   kernel 195 registers a thread, no spills; 64 KB of shared memory a
//   block). Each block syncs its 4 warps once a tile, so one block's
//   softmax overlaps the other's MMAs. Blocks of 128 rows (8 warps, one
//   block an SM by registers), a third block of 64 rows (168 registers,
//   with spills) and warps of 32 rows (two m16 tiles sharing each K/V
//   fragment; 255 registers and spills) all measured slower
//   (flash_prefill_sweep.py times the first two).
// * K/V in flight. K and V tiles of BN = 64 keys go through a ring of
//   NSTAGE = 2 stages in shared memory (the next tile loads while this one
//   is computed; a third stage measured no faster) with 16-byte
//   cp.async.cg copies, in bf16. The 16-byte chunks
//   of a row are XOR-swizzled by key (chunk ^ (key / rows per 128-byte
//   line) mod 8) so that the 8 rows of an ldmatrix tile hit 8 bank
//   groups; a lane's ldmatrix addresses are 32-bit shared-window offsets
//   computed once, and moving to chunk 2x of the same rows is an XOR with
//   x * 32. Keys past the block's last valid key are zero-filled
//   (cp.async with a source size of 0): stale shared memory could hold
//   NaN, and 0 x NaN is NaN. Q is read once from global memory straight
//   into its A fragments, which stay in registers for the whole key loop.
// * Tensor-core math. S = Q K^T (mma.sync m16n8k16, bf16 -> fp32, K by
//   ldmatrix); the online softmax runs in registers in the log2 domain
//   (ex2 of the scores times scale * log2 e), the row max reduced over the
//   4 lanes of a quad with shuffles; P is repacked from the S
//   accumulators into bf16 A fragments in registers (no trip through
//   shared memory); O += P V with V by ldmatrix.trans. m, l and acc are
//   fp32; l is summed from the bf16-rounded P, as P V sees it, by the
//   tensor cores (P times a column of ones).
// * Causal tiles. The key loop stops at min(kv_len, q_offset + the
//   block's last position + 1). Only tiles that cross one of a warp's
//   rows' diagonal or kv_len apply the mask; a warp skips a tile that
//   lies wholly past all its rows' diagonals.
//
// fp32 (flash_prefill_kernel) has no tensor-core type of its precision and
// runs FMAs on the CUDA cores (67 TFLOP/s): one block per (query block,
// KV group, batch) of ROWS = 64 rows (64 / rep positions times the rep
// heads) loops over KV tiles of KEY_TILE keys up to the causal limit of
// its last query. Q (transposed), K (transposed) and V tiles and the
// tile's probabilities sit in shared memory as fp32; scores, the running
// max m, the denominator l and the accumulator stay in registers. Thread
// layout (128 threads): lane l of warp w owns rows rg * 4 .. rg * 4 + 3
// with rg = 4 w + l / 8, and, with c = l % 8, the keys c * 4 .. c * 4 + 3
// of a tile for the scores and the head dims {c * 4 + 32 j + e} for the
// output; the 8 lanes of a row group combine their partial row max and
// row sum with shuffles.
#include "attn_common.cuh"
#include "sm90_mma.cuh"

using namespace attn;

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 4;        // 16 query rows each
constexpr int BM = 16 * MMA_WARPS;  // query rows a block
constexpr int BN = 64;              // keys a K/V tile
constexpr int NSTAGE = 2;           // ring depth: 1 tile in flight
constexpr int MMA_BLOCKS = 2;       // resident blocks an SM (64 KB each)
constexpr float LOG2E = 1.4426950408889634f;
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
  static constexpr int TILE_BYTES = BN * ROW_BYTES;   // K (or V) of a tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int SMEM_BYTES = NSTAGE * STAGE_BYTES;
  // a thread copies the same chunk of rows KPP apart, whose swizzle agrees
  static_assert(THREADS % CPR == 0 && BN % KPP == 0 && KPP % (8 * RPL) == 0,
                "copy split");

  // byte offset of chunk ch of row t in a K (or V) tile
  __device__ static unsigned chunk_at(int t, int ch) {
    return t * ROW_BYTES + ((ch ^ ((t / RPL) & (SWZ - 1))) * 16);
  }
};

template <int DH>
__global__ void __launch_bounds__(32 * MMA_WARPS, MMA_BLOCKS)
    flash_prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Sk,
    int H, int G, int q_offset, int kv_end, float scale) {
  using Cf = MmaCfg<DH>;
  constexpr int RB = Cf::ROW_BYTES;
  constexpr int KT = DH / 16;       // k-steps of Q K^T
  constexpr int DT = DH / 8;        // n-tiles of O
  extern __shared__ __align__(128) char mma_smem[];
  const unsigned ring = smem_addr(mma_smem);    // NSTAGE x (K, V) tiles
  const int rep = H / G;
  const int BQ = BM / rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, c = lane & 3;       // mma row group, column pair
  const int j8 = lane >> 3, r8 = lane & 7;      // ldmatrix: tile, row

  // the keys of this block: up to the causal limit of its last live query
  const int q_last = min(Sq, q0 + BQ) - 1;
  const int key_end = max(0, min(kv_end, q_offset + q_last + 1));
  const int n_tiles = (key_end + BN - 1) / BN;

  // thread i copies chunk i % CPR of rows i / CPR + j * KPP of a tile, K
  // and V: shared offsets j * KPP rows apart, global ones j * KPP keys
  const int r0 = threadIdx.x / Cf::CPR;
  const unsigned cp_dst = Cf::chunk_at(r0, threadIdx.x % Cf::CPR);
  const size_t kv_row = (size_t)G * DH;
  const size_t cp_src =
      ((size_t)b * Sk * G + g) * DH + (threadIdx.x % Cf::CPR) * 8;
  auto issue = [&](int t) {
    const unsigned st = ring + (t % NSTAGE) * Cf::STAGE_BYTES + cp_dst;
    const bf16* kr = k + cp_src + (size_t)(t * BN + r0) * kv_row;
    const bf16* vr = v + cp_src + (size_t)(t * BN + r0) * kv_row;
    const size_t step = Cf::KPP * kv_row;
    if ((t + 1) * BN <= key_end) {  // a full tile
#pragma unroll
      for (int j = 0; j < BN / Cf::KPP; ++j) {
        cp_async16(st + j * Cf::KPP * RB, kr + j * step);
        cp_async16(st + j * Cf::KPP * RB + Cf::TILE_BYTES, vr + j * step);
      }
    } else {                        // the last: keys past key_end get zeros
#pragma unroll
      for (int j = 0; j < BN / Cf::KPP; ++j) {
        const bool live = t * BN + r0 + j * Cf::KPP < key_end;
        cp_async16(st + j * Cf::KPP * RB, live ? kr + j * step : k,
                   live ? 16 : 0);
        cp_async16(st + j * Cf::KPP * RB + Cf::TILE_BYTES,
                   live ? vr + j * step : v, live ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // this lane's two rows (mma rows gq and gq + 8 of the warp): their A
  // fragments of Q, read once from global memory, and the last key each
  // may see (-1: a dead row)
  uint32_t qa[KT][4];
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    const int p = q0 + r / rep;
    lim[h] = p < Sq ? min(q_offset + p, kv_end - 1) : -1;
    const bf16* qr =
        q + (((size_t)b * Sq + p) * H + (size_t)g * rep + r % rep) * DH;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        qa[kk][h + 2 * e] =
            p < Sq ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 +
                                                        8 * e + 2 * c)
                   : 0u;
  }
  // the warp's rows: keys below w_full are valid for all of them, keys
  // above w_last for none
  const int p_first = q0 + (warp * 16) / rep;
  const int p_last = min(Sq - 1, q0 + (warp * 16 + 15) / rep);
  const int w_full = min(kv_end, q_offset + p_first + 1);
  const int w_last = p_first < Sq ? min(kv_end - 1, q_offset + p_last) : -1;

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
    const int k0 = t * BN;
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
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t r[4];
        ldsm_x4(r, kx + np * 16 * RB);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(s[2 * np], qa[kk], b0);
        mma_bf16(s[2 * np + 1], qa[kk], b1);
      }
    }
    if (k0 + BN > w_full) {         // the tile crosses a diagonal or kv_len
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

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    const int p = q0 + r / rep;
    if (p >= Sq) continue;
    const float inv = 1.f / fmaxf(l[h], DENOM_EPS);
    bf16* orow =
        out + (((size_t)b * Sq + p) * H + (size_t)g * rep + r % rep) * DH;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * c) =
          pack_bf16(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
  }
}

template <int DH>
cudaError_t prepare_mma() {
  constexpr int smem = MmaCfg<DH>::SMEM_BYTES;
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(flash_prefill_mma_kernel<DH>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)
             : cudaSuccess;
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int H, int G, int q_offset,
                       int kv_end, float scale, cudaStream_t stream) {
  using Cf = MmaCfg<DH>;
  const cudaError_t e = prepare_mma<DH>();
  if (e != cudaSuccess) return e;
  const int bq = BM / (H / G);
  dim3 grid((Sq + bq - 1) / bq, G, B);
  flash_prefill_mma_kernel<DH><<<grid, Cf::THREADS, Cf::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, G,
      q_offset, kv_end, scale);
  return cudaGetLastError();
}

// the bf16 kernel's residency: res = {blocks an SM holds at once, dynamic
// shared memory bytes a block}
template <int DH>
cudaError_t occupancy_mma(int* res) {
  using Cf = MmaCfg<DH>;
  const cudaError_t e = prepare_mma<DH>();
  if (e != cudaSuccess) return e;
  res[1] = Cf::SMEM_BYTES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &res[0], flash_prefill_mma_kernel<DH>, Cf::THREADS, Cf::SMEM_BYTES);
}

// Calls fn(MmaCfg<Dh>{}) for a head dim of 32, 64 or 128.
template <class Fn>
cudaError_t dispatch_mma(int Dh, Fn fn) {
  switch (Dh) {
    case 32: return fn(MmaCfg<32>{});
    case 64: return fn(MmaCfg<64>{});
    case 128: return fn(MmaCfg<128>{});
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(int Dh, const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int G,
                         int q_offset, int kv_end, float scale,
                         cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch_flash<float, 32>(q, k, v, out, B, Sq, Sk, H, G, q_offset,
                                     kv_end, scale, stream);
    case 64:
      return launch_flash<float, 64>(q, k, v, out, B, Sq, Sk, H, G, q_offset,
                                     kv_end, scale, stream);
    case 128:
      return launch_flash<float, 128>(q, k, v, out, B, Sq, Sk, H, G,
                                      q_offset, kv_end, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out (B, Sq, H, Dh); kv_end is min(Sk, kv_len). Grid (ceil(Sq / (64 /
// rep)), G, B): 64 query rows (positions x heads) a block.
int flash_prefill_launch(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int G,
                         int Dh, int q_offset, int kv_end, float scale,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (H % G || (ROWS % (H / G)) != 0)
    e = cudaErrorInvalidValue;
  else if (dtype == DTYPE_F32)
    e = dispatch_f32(Dh, q, k, v, out, B, Sq, Sk, H, G, q_offset, kv_end,
                     scale, st);
  else if (dtype == DTYPE_BF16)
    e = dispatch_mma(Dh, [&](auto cf) {
      return launch_mma<decltype(cf)::DH>(q, k, v, out, B, Sq, Sk, H, G,
                                          q_offset, kv_end, scale, st);
    });
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// the bf16 kernel's residency for head dim Dh: res = {blocks an SM holds
// at once, dynamic shared memory bytes a block}
int flash_prefill_occupancy(int Dh, void* res) {
  return (int)dispatch_mma(Dh, [&](auto cf) {
    return occupancy_mma<decltype(cf)::DH>(static_cast<int*>(res));
  });
}

}  // extern "C"
