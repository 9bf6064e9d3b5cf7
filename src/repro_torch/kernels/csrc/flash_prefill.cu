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
// The block is prefill_core.cuh's (shared with duet_attention_paged.cu's
// prefill role; design notes there), over the contiguous keys k[b, :, g]
// (dcore::SlabSrc). This file lays the rows out and launches it:
//
// * Rows and grid. A block owns 64 query rows of one KV group: BQ = 64 /
//   hpc positions times the hpc heads of a head block of the group, which
//   share every K/V tile (row r is position q0 + r / hc, head h0 + r %
//   hc; attn::head_split gives one head block of hpc = rep heads up to rep
//   64, so BQ = 64 // rep and rows past BQ * rep are not held: 63 of 64
//   at rep 3, 60 at rep 5, 48 at rep 48; above rep 64 the heads split into
//   blocks of one position each); row r sees keys up to min(q_offset + its
//   position, kv_len - 1), and the block walks keys 0 .. the limit of its
//   last position. Grid (ceil(Sq / BQ), G x head blocks, B); block x takes
//   row tile gridDim.x - 1 - x, so the tiles with the most keys (causal:
//   the work grows with the position) start first and do not form the
//   tail.
// * bf16 (flash_prefill_mma_kernel): two blocks an SM
//   (__launch_bounds__(128, 2); ptxas gives the Dh 128 kernel 198
//   registers a thread, no spills; 64 KB of shared memory a block; one
//   block an SM at Dh 256, whose ring and Q take 160 KB). Each
//   block syncs its 4 warps once a tile, so one block's softmax overlaps
//   the other's MMAs. Blocks of 128 rows (8 warps, one block an SM by
//   registers), a third block of 64 rows (168 registers, with spills) and
//   warps of 32 rows (two m16 tiles sharing each K/V fragment; 255
//   registers and spills) all measured slower (flash_prefill_sweep.py
//   times the first two).
// * fp32 (flash_prefill_kernel) runs the core's CUDA-core block.
#include "decode_core.cuh"    // dcore::SlabSrc
#include "prefill_core.cuh"

using namespace attn;

namespace {

using bf16 = __nv_bfloat16;
constexpr int MMA_BLOCKS = 2;       // resident bf16 blocks an SM

// the keys and rows of one block of ROWS rows: row r of the block is
// position q0 + r / hc of query tile x, head h0 + r % hc of its head block
struct Rows {
  HeadBlock hb;
  int q0, BQ, Sq, H, b, q_offset, kv_end, key_end;
  __device__ Rows(int Sq_, int H_, int G, HeadSplit hs, int q_offset_,
                  int kv_end_, int x)
      : hb(HeadBlock::split(blockIdx.y, H_ / G, hs)), Sq(Sq_), H(H_),
        b(blockIdx.z), q_offset(q_offset_), kv_end(kv_end_) {
    BQ = pcore::ROWS / hs.hpc;
    q0 = x * BQ;
    const int q_last = min(Sq, q0 + BQ) - 1;
    key_end = max(0, min(kv_end, q_offset + q_last + 1));
  }
  __device__ long long off(int r, int DH) const {
    const int p = q0 + r / hb.hc;
    return r < BQ * hb.hc && p < Sq
               ? (((long long)b * Sq + p) * H + hb.h0 + r % hb.hc) * DH
               : -1;
  }
  __device__ int lim(int r) const {
    return min(q_offset + q0 + r / hb.hc, kv_end - 1);
  }
};

template <typename T, int Dh>
__global__ void __launch_bounds__(pcore::SIMT_THREADS) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
    int G, HeadSplit hs, int q_offset, int kv_end, float scale) {
  extern __shared__ __align__(16) char simt_smem[];
  const Rows rows(Sq, H, G, hs, q_offset, kv_end, blockIdx.x);
  const dcore::SlabSrc src{((size_t)rows.b * Sk * G + rows.hb.g) * Dh,
                           (size_t)G * Dh};
  pcore::simt_block<T, Dh>(
      simt_smem, q, k, v, out, src, 0, rows.key_end,
      [&](int r) { return rows.off(r, Dh); },
      [&](int r) { return rows.lim(r); }, scale, nullptr);
}

template <typename T, int Dh>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int G,
                         int q_offset, int kv_end, float scale,
                         cudaStream_t stream) {
  constexpr int smem = pcore::simt_smem_bytes(Dh);
  auto kernel = flash_prefill_kernel<T, Dh>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const HeadSplit hs = head_split(H / G, 1, pcore::ROWS);
  const int bq = pcore::ROWS / hs.hpc;
  dim3 grid((Sq + bq - 1) / bq, G * hs.hb, B);
  kernel<<<grid, pcore::SIMT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, G, hs,
      q_offset, kv_end, scale);
  return cudaGetLastError();
}

template <int DH>
__global__ void __launch_bounds__(32 * pcore::MMA_WARPS, MMA_BLOCKS)
    flash_prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Sk,
    int H, int G, HeadSplit hs, int q_offset, int kv_end, float scale) {
  extern __shared__ __align__(128) char mma_smem[];
  // heaviest row tiles first
  const Rows rows(Sq, H, G, hs, q_offset, kv_end,
                  gridDim.x - 1 - blockIdx.x);
  const dcore::SlabSrc src{((size_t)rows.b * Sk * G + rows.hb.g) * DH,
                           (size_t)G * DH};
  pcore::mma_block<DH>(
      mma_smem, q, k, v, out, src, 0, rows.key_end,
      [&](int r) { return rows.off(r, DH); },
      [&](int r) { return rows.lim(r); }, scale, nullptr);
}

template <int DH>
cudaError_t prepare_mma() {
  constexpr int smem = pcore::MmaCfg<DH>::SMEM_BYTES;
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
  using Cf = pcore::MmaCfg<DH>;
  const cudaError_t e = prepare_mma<DH>();
  if (e != cudaSuccess) return e;
  const HeadSplit hs = head_split(H / G, 1, pcore::BM);
  const int bq = pcore::BM / hs.hpc;
  dim3 grid((Sq + bq - 1) / bq, G * hs.hb, B);
  flash_prefill_mma_kernel<DH><<<grid, Cf::THREADS, Cf::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, G, hs,
      q_offset, kv_end, scale);
  return cudaGetLastError();
}

// the bf16 kernel's residency: res = {blocks an SM holds at once, dynamic
// shared memory bytes a block}
template <int DH>
cudaError_t occupancy_mma(int* res) {
  using Cf = pcore::MmaCfg<DH>;
  const cudaError_t e = prepare_mma<DH>();
  if (e != cudaSuccess) return e;
  res[1] = Cf::SMEM_BYTES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &res[0], flash_prefill_mma_kernel<DH>, Cf::THREADS, Cf::SMEM_BYTES);
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
    case 256:
      return launch_flash<float, 256>(q, k, v, out, B, Sq, Sk, H, G,
                                      q_offset, kv_end, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out (B, Sq, H, Dh); kv_end is min(Sk, kv_len). Grid (ceil(Sq / (64 /
// hpc)), G x head blocks, B): up to 64 query rows (positions x heads) a
// block (attn::head_split).
int flash_prefill_launch(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int G,
                         int Dh, int q_offset, int kv_end, float scale,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (G < 1 || H % G)
    e = cudaErrorInvalidValue;
  else if (dtype == DTYPE_F32)
    e = dispatch_f32(Dh, q, k, v, out, B, Sq, Sk, H, G, q_offset, kv_end,
                     scale, st);
  else if (dtype == DTYPE_BF16)
    e = pcore::dispatch_mma(Dh, [&](auto cf) {
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
  return (int)pcore::dispatch_mma(Dh, [&](auto cf) {
    return occupancy_mma<decltype(cf)::DH>(static_cast<int*>(res));
  });
}

}  // extern "C"
