// Paged decode attention for Hopper (sm_90a): one cluster launch on
// decode_core.cuh serves both the plain page walk and the split-KV
// (flash-decoding) variant.
//
// Replaces the Pallas kernels of src/repro/kernels/paged_decode.py
// (paged_decode: _kernel, paged_decode_splitkv: _splitkv_kernel).
//
// Contract (as the reference): q (B,H,Dh); k/v pages (N,ps,G,Dh) fp32 or
// bf16; tables (B,P) int32 page ids; lengths (B,) int32. Head h reads KV
// group h / rep. Token tok of request b is valid iff tok < lengths[b].
//
// paged_decode_cluster_kernel: grid (B, G, C) with clusters of C CTAs
// along z. The request's live pages ceil(lengths / ps) (every later page
// is fully masked, so the result is the reference's) split into C
// contiguous spans of ceil(live / C) pages; CTA rank r walks span r. The
// CTA first copies its span's page ids from the block table into shared
// memory, then streams the pages' K/V rows of its group through the
// cp.async ring, taking each stage against all rep query rows of the
// group; the ranks combine the cluster's partials through distributed
// shared memory in rank order, and write the output. Design notes in
// decode_core.cuh.
//
// paged_decode_block_kernel: the same grid, spans and combine for a group
// of more than 16 query heads (rep > 16: granite-20b's MQA has 48), which
// the decode core's row buckets do not take (widening its 16-row bucket
// to 48 would hold an O^T accumulator of 192 fp32 registers a thread).
// The CTA runs prefill_core.cuh's 64-row block instead, the one the paged
// duet kernel gives its chunk tiles: its rows are the rep heads of the
// request's one query, each seeing the request's keys, its K/V gathered
// through the span's page ids; a group of more than 64 heads splits into
// head blocks on grid y (attn::head_split), which re-read the group's
// keys once each. The role follows rep alone, so the host picks the
// kernel (ops.cta_role) and prices the one it launches.
//
// The two wrappers differ only in C. paged_decode picks it on the host for
// one wave of CTAs (ops.cluster_size). paged_decode_splitkv takes the
// caller's static split count S (at most 8, the portable cluster size) as
// C: its splits are the cluster's spans, so the split partials never
// leave shared memory, there is no HBM scratch and no second launch, and
// the combine's sum order is fixed.
//
// Bound: memory. Each live KV byte is read once and the arithmetic is
// 4 FLOP per KV element, far below the card's 295 FLOP/byte ridge.
#include "decode_core.cuh"
#include "prefill_core.cuh"

using namespace attn;

// ---------------------------------------------------------------------------
// the cluster launch on decode_core.cuh
// ---------------------------------------------------------------------------
template <typename T, int DH, int NRB>
__global__ void __launch_bounds__(dcore::Cfg<T, DH, NRB>::THREADS)
    paged_decode_cluster_kernel(const T* __restrict__ q,
                                const T* __restrict__ k_pages,
                                const T* __restrict__ v_pages,
                                const int* __restrict__ tables,
                                const int* __restrict__ lengths,
                                T* __restrict__ out, int H, int G, int ps,
                                int P, float scale) {
  using Cf = dcore::Cfg<T, DH, NRB>;
  extern __shared__ __align__(16) char core_smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int C = gridDim.z;               // the cluster spans z
  const int rank = blockIdx.z;
  const int rep = H / G;

  // this CTA's span of the live pages (ops.cluster_spans)
  const int len = max(lengths[b], 0);
  const int live = min(P, (len + ps - 1) / ps);
  const int span = (live + C - 1) / C;
  const int p0 = min(rank * span, live), p1 = min(p0 + span, live);
  int* pid = reinterpret_cast<int*>(core_smem + Cf::FIXED_BYTES);
  for (int i = threadIdx.x; i < p1 - p0; i += Cf::THREADS)
    pid[i] = tables[(size_t)b * P + p0 + i];
  __syncthreads();                       // page ids in place

  const size_t row_elems = (size_t)G * DH;
  const int ps_shift = (ps & (ps - 1)) ? -1 : __ffs(ps) - 1;
  const dcore::PagedSrc src{pid, p0 * ps, ps, ps_shift,
                            (size_t)ps * row_elems, row_elems,
                            (size_t)g * DH};
  const T* qb = q + ((size_t)b * H + (size_t)g * rep) * DH;
  T* ob = out + ((size_t)b * H + (size_t)g * rep) * DH;
  dcore::decode_cluster<Cf>(
      core_smem, k_pages, v_pages, src, p0 * ps, min(p1 * ps, len),
      [&](int r) { return qb + (size_t)r * DH; },
      [&](int) { return len - 1; }, rep, scale,
      [&](int r, int d, float x) {
        ob[(size_t)r * DH + d] = from_f32<T>(x);
      });
}

// the block role: grid (B, G * hb, C), clusters of C along z
template <typename T, int DH>
__global__ void __launch_bounds__(pcore::BlockCfg<T, DH>::THREADS, 2)
    paged_decode_block_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ tables,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, int H, int G, int ps,
                              int P, HeadSplit hs, float scale) {
  using Bc = pcore::BlockCfg<T, DH>;
  extern __shared__ __align__(128) char block_smem[];
  const int b = blockIdx.x;
  const HeadBlock hb = HeadBlock::split(blockIdx.y, H / G, hs);
  const int C = gridDim.z, rank = blockIdx.z;

  const int len = max(lengths[b], 0);
  const int live = min(P, (len + ps - 1) / ps);
  const int span = (live + C - 1) / C;
  const int p0 = min(rank * span, live), p1 = min(p0 + span, live);
  int* pid = reinterpret_cast<int*>(block_smem + Bc::MAIN_BYTES);
  for (int i = threadIdx.x; i < p1 - p0; i += Bc::THREADS)
    pid[i] = tables[(size_t)b * P + p0 + i];
  __syncthreads();                       // page ids in place

  const size_t row_elems = (size_t)G * DH;
  const int ps_shift = (ps & (ps - 1)) ? -1 : __ffs(ps) - 1;
  const dcore::PagedSrc src{pid, p0 * ps, ps, ps_shift,
                            (size_t)ps * row_elems, row_elems,
                            (size_t)hb.g * DH};
  const size_t o0 = ((size_t)b * H + hb.h0) * DH;   // the block's first head
  pcore::block_cluster<T, DH>(
      block_smem, q, k_pages, v_pages, out, src, p0 * ps, min(p1 * ps, len),
      [&](int r) -> long long {
        return r < hb.hc ? (long long)(o0 + (size_t)r * DH) : -1LL;
      },
      [&](int) { return len - 1; }, hb.hc, scale, C,
      [&](int r, int d, float x) {
        out[o0 + (size_t)r * DH + d] = from_f32<T>(x);
      });
}

// dynamic shared memory of one CTA: the role's + the span's page ids
static size_t pid_bytes(int P, int C) {
  return sizeof(int) * (size_t)((P + C - 1) / C);
}
template <class Cf>
static size_t cluster_smem(int P, int C) {
  return Cf::FIXED_BYTES + pid_bytes(P, C);
}
template <typename T, int DH>
static size_t block_smem_bytes(int P, int C) {
  return pcore::BlockCfg<T, DH>::MAIN_BYTES + pid_bytes(P, C);
}

static cudaError_t launch_paged(const void* q, const void* k, const void* v,
                                const void* tables, const void* lengths,
                                void* out, int B, int H, int G, int Dh,
                                int ps, int P, int C, float scale, int dtype,
                                cudaStream_t stream) {
  if (C < 1 || C > dcore::MAX_CLUSTER || G < 1 || H % G)
    return cudaErrorInvalidValue;
  const int rep = H / G;
  if (rep > dcore::MAX_ROWS) {                       // the block role
    const HeadSplit hs = head_split(rep, 1, pcore::ROWS);
    return pcore::dispatch_t_dh(dtype, Dh, [&](auto tt, auto dh) {
      using T = std::remove_pointer_t<decltype(tt)>;
      constexpr int DH = decltype(dh)::value;
      return dcore::launch_cluster<pcore::BlockCfg<T, DH>>(
          paged_decode_block_kernel<T, DH>, dim3(B, G * hs.hb, C), C,
          block_smem_bytes<T, DH>(P, C), stream, static_cast<const T*>(q),
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const int*>(tables), static_cast<const int*>(lengths),
          static_cast<T*>(out), H, G, ps, P, hs, scale);
    });
  }
  return dcore::dispatch(dtype, Dh, rep, [&](auto cf) {
    using Cf = decltype(cf);
    using T = typename Cf::T;
    return dcore::launch_cluster<Cf>(
        paged_decode_cluster_kernel<T, Cf::DH, Cf::NRB>, dim3(B, G, C), C,
        cluster_smem<Cf>(P, C), stream, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(tables), static_cast<const int*>(lengths),
        static_cast<T*>(out), H, G, ps, P, scale);
  });
}

static cudaError_t paged_occupancy(int Dh, int rows, int P, int C, int dtype,
                                   int* res) {
  if (C < 1 || C > dcore::MAX_CLUSTER || rows < 1)
    return cudaErrorInvalidValue;
  if (rows > dcore::MAX_ROWS)                            // the block role
    return pcore::dispatch_t_dh(dtype, Dh, [&](auto tt, auto dh) {
      using T = std::remove_pointer_t<decltype(tt)>;
      constexpr int DH = decltype(dh)::value;
      using Bc = pcore::BlockCfg<T, DH>;
      res[1] = (int)block_smem_bytes<T, DH>(P, C);
      res[2] = Bc::MMA ? (pcore::NSTAGE - 1) * pcore::MmaCfg<DH>::STAGE_BYTES
                       : 0;
      return dcore::max_active_clusters<Bc>(
          paged_decode_block_kernel<T, DH>, C, (size_t)res[1], &res[0]);
    });
  return dcore::dispatch(dtype, Dh, rows, [&](auto cf) {
    using Cf = decltype(cf);
    res[1] = (int)cluster_smem<Cf>(P, C);
    res[2] = (dcore::NSTAGE - 1) * Cf::STAGE_BYTES;
    return dcore::max_active_clusters<Cf>(
        paged_decode_cluster_kernel<typename Cf::T, Cf::DH, Cf::NRB>, C,
        (size_t)res[1], &res[0]);
  });
}

extern "C" {

// Both wrappers: grid (B, G, C) (rep <= 16) or (B, G * head blocks, C)
// (rep > 16, the block role) in clusters of C CTAs along z (C <= 8);
// writes out (B,H,Dh) directly.
int paged_decode_launch(const void* q, const void* k, const void* v,
                        const void* tables, const void* lengths, void* out,
                        int B, int H, int G, int Dh, int ps, int P, int C,
                        float scale, int dtype, void* stream) {
  return (int)launch_paged(q, k, v, tables, lengths, out, B, H, G, Dh, ps, P,
                           C, scale, dtype,
                           static_cast<cudaStream_t>(stream));
}

// paged_decode_launch's occupancy for ``rows`` (= rep) query rows of a
// group, of the role it launches (the block role above 16 rows): res =
// {clusters of C CTAs the card holds at once, dynamic shared memory bytes
// per CTA, bytes the ring loads ahead}.
int paged_decode_occupancy(int Dh, int rows, int P, int C, int dtype,
                           void* res) {
  return (int)paged_occupancy(Dh, rows, P, C, dtype, static_cast<int*>(res));
}

}  // extern "C"
