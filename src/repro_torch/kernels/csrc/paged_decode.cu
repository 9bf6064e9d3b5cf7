// Paged decode attention for Hopper (sm_90a): the plain page walk as one
// cluster launch, and the split-KV (flash-decoding) partials + combine.
//
// Replaces the Pallas kernels of src/repro/kernels/paged_decode.py
// (paged_decode: _kernel, paged_decode_splitkv: _splitkv_kernel).
//
// Contract (as the reference): q (B,H,Dh); k/v pages (N,ps,G,Dh) fp32 or
// bf16; tables (B,P) int32 page ids; lengths (B,) int32. Head h reads KV
// group h / rep. Token tok of request b is valid iff tok < lengths[b].
//
// paged_decode (paged_decode_cluster_kernel, on decode_core.cuh): grid
// (B, G, C) with clusters of C CTAs along z. The request's live pages
// ceil(lengths / ps) (every later page is fully masked, so the result is
// the reference's) split into C contiguous spans of ceil(live / C) pages;
// CTA rank r walks span r. The CTA first copies its span's page ids from
// the block table into shared memory, then streams the pages' K/V rows of
// its group through the cp.async ring, taking each stage against all rep
// query rows of the group; rank 0 combines the cluster's partials through
// distributed shared memory. Design notes in decode_core.cuh.
//
// paged_decode_splitkv (paged_decode_kernel with FINAL = false, on
// attn_common.cuh): one block per (request, KV group, split) walks its span
// of the block table one page at a time, staging the page's K and V rows in
// shared memory as fp32 (16-byte loads) before an online softmax per warp
// and row; the split partials (m, l, acc) go to fp32 scratch and a second
// kernel does the log-sum-exp combine, skipping dead splits
// (m <= MASKED_M_THRESHOLD).
//
// Bound: memory. Each live KV byte is read once and the arithmetic is
// 4 FLOP per KV element, far below the card's 295 FLOP/byte ridge.
#include "attn_common.cuh"
#include "decode_core.cuh"

using namespace attn;

template <typename T, int DPL, bool FINAL>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int H, int G, int ps, int P, int pps,
    float scale) {
  constexpr int Dh = DPL * 32;
  const int b = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int S = gridDim.z;
  const int rep = H / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ float smem[];
  float* q_s = smem;                     // rep rows of Dh
  float* k_s = q_s + rep * Dh;           // ps rows, stride Dh + 1
  float* v_s = k_s + ps * (Dh + 1);      // ps rows, stride Dh

  const T* qb = q + ((size_t)b * H + (size_t)g * rep) * Dh;
  for (int i = threadIdx.x; i < rep * Dh; i += blockDim.x)
    q_s[i] = to_f32(qb[i]);

  const int len = lengths[b];
  int limit[MAX_ROWS_PER_WARP];
  float m[MAX_ROWS_PER_WARP], l[MAX_ROWS_PER_WARP];
  float acc[MAX_ROWS_PER_WARP][DPL];
#pragma unroll
  for (int ri = 0; ri < MAX_ROWS_PER_WARP; ++ri) {
    limit[ri] = len - 1;
    m[ri] = NEG_INF;
    l[ri] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[ri][j] = 0.f;
  }

  const int live_pages = min(P, (len + ps - 1) / ps);
  const int p_end = min((s + 1) * pps, live_pages);
  const size_t row_stride = (size_t)G * Dh;
  for (int p = s * pps; p < p_end; ++p) {
    const int page = tables[(size_t)b * P + p];
    const size_t base = ((size_t)page * ps * G + g) * Dh;
    __syncthreads();  // q_s written / the previous page consumed
    load_page<T>(k_s, Dh + 1, k_pages + base, row_stride, ps, Dh);
    load_page<T>(v_s, Dh, v_pages + base, row_stride, ps, Dh);
    __syncthreads();
    attend_page<DPL>(q_s, k_s, v_s, ps, Dh, p * ps, limit, warp, rep, scale,
                     m, l, acc);
  }

#pragma unroll
  for (int ri = 0; ri < MAX_ROWS_PER_WARP; ++ri) {
    const int r = warp + ri * WARPS;
    if (r >= rep) continue;
    const int h = g * rep + r;
    if constexpr (FINAL) {
      const float denom = fmaxf(l[ri], DENOM_EPS);
      T* o = out + ((size_t)b * H + h) * Dh;
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        o[lane + 32 * j] = from_f32<T>(acc[ri][j] / denom);
    } else {
      const size_t idx = ((size_t)b * S + s) * H + h;
      if (lane == 0) {
        m_part[idx] = m[ri];
        l_part[idx] = l[ri];
      }
      float* a = acc_part + idx * Dh;
#pragma unroll
      for (int j = 0; j < DPL; ++j) a[lane + 32 * j] = acc[ri][j];
    }
  }
}

// Log-sum-exp combine of the split partials: one block per (request, head).
template <typename T>
__global__ void __launch_bounds__(THREADS) splitkv_combine_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, T* __restrict__ out, int S, int H,
    int Dh) {
  const int b = blockIdx.x, h = blockIdx.y;
  float m_star = NEG_INF;
  for (int s = 0; s < S; ++s)
    m_star = fmaxf(m_star, m_part[((size_t)b * S + s) * H + h]);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float l_star = 0.f, a = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t idx = ((size_t)b * S + s) * H + h;
      const float ms = m_part[idx];
      const float w = ms > MASKED_M_THRESHOLD ? expf(ms - m_star) : 0.f;
      l_star += w * l_part[idx];
      a += w * acc_part[idx * Dh + d];
    }
    out[((size_t)b * H + h) * Dh + d] =
        from_f32<T>(a / fmaxf(l_star, DENOM_EPS));
  }
}

template <typename T, int DPL, bool FINAL>
static cudaError_t launch_decode(const void* q, const void* k, const void* v,
                                 const int* tables, const int* lengths,
                                 void* out, float* m_part, float* l_part,
                                 float* acc_part, int B, int H, int G, int ps,
                                 int P, int S, float scale,
                                 cudaStream_t stream) {
  constexpr int Dh = DPL * 32;
  const int rep = H / G;
  const int pps = (P + S - 1) / S;
  const size_t smem = sizeof(float) * (size_t)(rep * Dh + ps * (Dh + 1) +
                                               ps * Dh);
  auto kernel = paged_decode_kernel<T, DPL, FINAL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(B, G, S), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out),
      m_part, l_part, acc_part, H, G, ps, P, pps, scale);
  return cudaGetLastError();
}

template <typename T, bool FINAL>
static cudaError_t dispatch_dh(int Dh, const void* q, const void* k,
                               const void* v, const int* tables,
                               const int* lengths, void* out, float* m_part,
                               float* l_part, float* acc_part, int B, int H,
                               int G, int ps, int P, int S, float scale,
                               cudaStream_t stream) {
#define PD_CASE(DH)                                                        \
  case DH:                                                                 \
    return launch_decode<T, DH / 32, FINAL>(q, k, v, tables, lengths, out, \
                                            m_part, l_part, acc_part, B,   \
                                            H, G, ps, P, S, scale, stream);
  switch (Dh) {
    PD_CASE(32)
    PD_CASE(64)
    PD_CASE(128)
    PD_CASE(256)
  }
#undef PD_CASE
  return cudaErrorInvalidValue;
}

template <bool FINAL>
static int decode_entry(const void* q, const void* k, const void* v,
                        const void* tables, const void* lengths, void* out,
                        void* m_part, void* l_part, void* acc_part, int B,
                        int H, int G, int Dh, int ps, int P, int S,
                        float scale, int dtype, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DTYPE_F32)
    e = dispatch_dh<float, FINAL>(Dh, q, k, v, tb, ln, out, mp, lp, ap, B, H,
                                  G, ps, P, S, scale, st);
  else if (dtype == DTYPE_BF16)
    e = dispatch_dh<__nv_bfloat16, FINAL>(Dh, q, k, v, tb, ln, out, mp, lp,
                                          ap, B, H, G, ps, P, S, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// ---------------------------------------------------------------------------
// paged_decode: one cluster launch on decode_core.cuh
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

// dynamic shared memory of one CTA: the core's + the span's page ids
template <class Cf>
static size_t cluster_smem(int P, int C) {
  return Cf::FIXED_BYTES + sizeof(int) * (size_t)((P + C - 1) / C);
}

static cudaError_t launch_paged(const void* q, const void* k, const void* v,
                                const void* tables, const void* lengths,
                                void* out, int B, int H, int G, int Dh,
                                int ps, int P, int C, float scale, int dtype,
                                cudaStream_t stream) {
  if (C < 1 || C > dcore::MAX_CLUSTER) return cudaErrorInvalidValue;
  return dcore::dispatch(dtype, Dh, H / G, [&](auto cf) {
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
  if (C < 1 || C > dcore::MAX_CLUSTER) return cudaErrorInvalidValue;
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

// The plain walk: grid (B, G, C) in clusters of C CTAs along z; writes out
// (B,H,Dh) directly.
int paged_decode_launch(const void* q, const void* k, const void* v,
                        const void* tables, const void* lengths, void* out,
                        int B, int H, int G, int Dh, int ps, int P, int C,
                        float scale, int dtype, void* stream) {
  return (int)launch_paged(q, k, v, tables, lengths, out, B, H, G, Dh, ps, P,
                           C, scale, dtype,
                           static_cast<cudaStream_t>(stream));
}

// paged_decode_launch's occupancy for ``rows`` query rows per CTA: res =
// {clusters of C CTAs the card holds at once, dynamic shared memory bytes
// per CTA, bytes the ring loads ahead}.
int paged_decode_occupancy(int Dh, int rows, int P, int C, int dtype,
                           void* res) {
  return (int)paged_occupancy(Dh, rows, P, C, dtype, static_cast<int*>(res));
}

// Split-KV partials: grid (B, G, S); m/l (B,S,H) and acc (B,S,H,Dh) fp32.
int paged_decode_partials_launch(const void* q, const void* k,
                                 const void* v, const void* tables,
                                 const void* lengths, void* m_part,
                                 void* l_part, void* acc_part, int B, int H,
                                 int G, int Dh, int ps, int P, int S,
                                 float scale, int dtype, void* stream) {
  return decode_entry<false>(q, k, v, tables, lengths, nullptr, m_part,
                             l_part, acc_part, B, H, G, Dh, ps, P, S, scale,
                             dtype, stream);
}

// Split-KV combine: grid (B, H), writes out (B,H,Dh).
int paged_decode_combine_launch(const void* m_part, const void* l_part,
                                const void* acc_part, void* out, int B,
                                int H, int Dh, int S, int dtype,
                                void* stream) {
  const float* mp = static_cast<const float*>(m_part);
  const float* lp = static_cast<const float*>(l_part);
  const float* ap = static_cast<const float*>(acc_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    splitkv_combine_kernel<float><<<dim3(B, H), THREADS, 0, st>>>(
        mp, lp, ap, static_cast<float*>(out), S, H, Dh);
  else if (dtype == DTYPE_BF16)
    splitkv_combine_kernel<__nv_bfloat16><<<dim3(B, H), THREADS, 0, st>>>(
        mp, lp, ap, static_cast<__nv_bfloat16*>(out), S, H, Dh);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
