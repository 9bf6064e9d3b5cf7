// Streaming-read probe: the HBM bandwidth exactly `ctas` SMs reach.
//
// Replaces no TPU kernel. The reference prices its partitions with
// Pi(S) / B(S) tables sampled from an analytic spec and leaves the hook
// for measured ones (src/repro/core/multiplexer.py: pi_table / bw_table);
// on the card the multiplexer's B(S) is this kernel's rate at S = 2u SMs
// for u = 1 .. the card's TPCs (core/device.py: partition_curves).
//
// One launch reads a whole int32 buffer once (the caller makes it at
// least 4x the L2, so the read streams from HBM) with exactly `ctas` CTAs
// of THREADS threads. Each CTA asks for more than half of an SM's shared
// memory, so no two CTAs can share an SM and the launch reads through
// exactly `ctas` SMs: those the block scheduler picks, spread over the
// GPCs, not whole TPCs or GPCs as a green context would hand out. Each
// CTA writes the SM it ran on (%smid), so the caller can hold that.
//
// Bound: bytes, at the rate `ctas` SMs can draw. A thread keeps UNROLL
// 16-byte loads in flight a loop step (128 KB a CTA), which is what lets
// a few SMs draw well above their share of the card's rate (the
// superlinear curve of the paper's Fig. 3a). The loads feed a checksum,
// each CTA's int64 sum of its elements, so the compiler keeps them; the
// elements lie in [0, 2^16) (the caller's contract), so a loop step's
// 4 x UNROLL elements sum in int32 and one 64-bit add a step keeps the
// ALU work far below the load rate.
//
// CTA b reads the 16-byte vectors i with (i / THREADS) % ctas == b (a
// grid-stride walk), the schedule kernels/sm_probe.py:sm_probe_plain
// restates.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int UNROLL = 8;

__device__ __forceinline__ int vsum(int4 v) { return v.x + v.y + v.z + v.w; }

__global__ void __launch_bounds__(THREADS, 1)
sm_probe_kernel(const int4* __restrict__ buf, long long n_vec,
                long long* __restrict__ partial, int* __restrict__ smid) {
  extern __shared__ long long warp_sums[];
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long acc = 0;
  for (; i + (UNROLL - 1) * stride < n_vec; i += UNROLL * stride) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = buf[i + u * stride];
    int s = 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) s += vsum(v[u]);
    acc += s;
  }
  for (; i < n_vec; i += stride) acc += vsum(buf[i]);

  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sums[lane];   // THREADS / 32 == 32 warps
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      unsigned id;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
      partial[blockIdx.x] = acc;
      smid[blockIdx.x] = (int)id;
    }
  }
}

// Dynamic shared memory a CTA asks for: more than half of what one SM
// holds, so an SM takes one CTA. 0 where the card cannot give it.
int probe_smem_bytes() {
  int dev, per_sm, per_block;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_block,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const int bytes = per_sm / 2 + 1024;
  return bytes <= per_block ? bytes : 0;
}

}  // namespace

extern "C" {

// buf: n_vec 16-byte vectors of int32 in [0, 2^16); partial (ctas,) int64
// and smid (ctas,) int32 out. 1 <= ctas <= the card's SMs.
int sm_probe_launch(const void* buf, long long n_vec, void* partial,
                    void* smid, int ctas, void* stream) {
  int dev, sms;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  const int smem = probe_smem_bytes();
  if (ctas < 1 || ctas > sms || n_vec < 0 || smem == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sm_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sm_probe_kernel<<<ctas, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(buf), n_vec, static_cast<long long*>(partial),
      static_cast<int*>(smid));
  return (int)cudaGetLastError();
}

// res = {CTAs an SM holds at once, dynamic shared memory bytes a CTA}
int sm_probe_occupancy(void* res) {
  int* out = static_cast<int*>(res);
  out[1] = probe_smem_bytes();
  if (out[1] == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sm_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[1]);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], sm_probe_kernel,
                                                    THREADS, out[1]);
  return (int)e;
}

}  // extern "C"
