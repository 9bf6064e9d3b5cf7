// Disjoint SM partitions of one card: the driver's green contexts.
//
// Replaces no TPU kernel. The reference runs a duet iteration's decode
// tiles and prefill tiles in one kernel grid, in an order that stands in
// for the paper's SM split (DESIGN.md §2: "the TPU analogue of SM
// masking"; src/repro/kernels/ops.py:build_duet_schedule). On the card
// the port runs the two halves of a duet super-iteration at once, each on
// its own set of SMs: core/device.py:SmSplit holds the two green contexts
// this file makes, core/lookahead.py forks the halves onto their streams.
//
// One split cuts the card's SM resource once (cuDevSmResourceSplitByCount
// with one group): a group of at least `group_sms` SMs, rounded up to the
// driver's granularity, and the remainder. Each becomes a green context
// (cuDevResourceGenerateDesc, cuGreenCtxCreate) with a non-blocking stream
// of its own (cuGreenCtxStreamCreate); the caller wraps the streams in
// torch.cuda.ExternalStream. Two torch GreenContext.create calls each cut
// the whole card afresh, so their SM sets can overlap; one cut cannot.
//
// A kernel launched on one of the streams sizes its clusters on its
// context: cudaOccupancyMaxActiveClusters with the stream in the launch
// configuration counts that context's SMs (kernels/ops.py:
// split_stream_kw).
//
// Every entry point returns 0 or the CUresult it failed with. Linked
// against libcuda (kernels/_build.py: EXTRA_FLAGS).

#include <cuda.h>

namespace {

CUresult card_sm_resource(int ordinal, CUdevice* dev, CUdevResource* res) {
  CUresult e = cuInit(0);
  if (e != CUDA_SUCCESS) return e;
  e = cuDeviceGet(dev, ordinal);
  if (e != CUDA_SUCCESS) return e;
  return cuDeviceGetDevResource(*dev, res, CU_DEV_RESOURCE_TYPE_SM);
}

// The SM group of at least min_sms SMs the driver cuts off `whole`, and
// the remainder.
CUresult cut(const CUdevResource* whole, int min_sms, CUdevResource* group,
             CUdevResource* rest) {
  unsigned int groups = 1;
  CUresult e = cuDevSmResourceSplitByCount(group, &groups, whole, rest, 0,
                                           (unsigned int)min_sms);
  if (e != CUDA_SUCCESS) return e;
  return groups == 1 ? CUDA_SUCCESS : CUDA_ERROR_INVALID_VALUE;
}

CUresult make_context(CUdevice dev, CUdevResource* res, CUgreenCtx* ctx,
                      CUstream* stream) {
  CUdevResourceDesc desc;
  CUresult e = cuDevResourceGenerateDesc(&desc, res, 1);
  if (e != CUDA_SUCCESS) return e;
  e = cuGreenCtxCreate(ctx, desc, dev, CU_GREEN_CTX_DEFAULT_STREAM);
  if (e != CUDA_SUCCESS) return e;
  e = cuGreenCtxStreamCreate(stream, *ctx, CU_STREAM_NON_BLOCKING, 0);
  if (e != CUDA_SUCCESS) {
    cuGreenCtxDestroy(*ctx);
    *ctx = nullptr;
  }
  return e;
}

}  // namespace

extern "C" {

// res = {the card's SMs, the smallest group the driver cuts off, the step
// between the group sizes it cuts}
int green_split_granularity(int device, void* res) {
  int* out = static_cast<int*>(res);
  CUdevice dev;
  CUdevResource whole, group, rest;
  CUresult e = card_sm_resource(device, &dev, &whole);
  if (e != CUDA_SUCCESS) return (int)e;
  out[0] = (int)whole.sm.smCount;
  e = cut(&whole, 1, &group, &rest);
  if (e != CUDA_SUCCESS) return (int)e;
  out[1] = (int)group.sm.smCount;
  e = cut(&whole, out[1] + 1, &group, &rest);
  if (e != CUDA_SUCCESS) return (int)e;
  out[2] = (int)group.sm.smCount - out[1];
  return 0;
}

// out (8 x int64) = {the group's green context, its stream, its SMs, the
// remainder's green context, its stream, its SMs, 0, 0}. Nothing is left
// behind on failure.
int green_split_create(int device, int group_sms, void* out) {
  long long* o = static_cast<long long*>(out);
  CUdevice dev;
  CUdevResource whole, res[2];
  CUresult e = card_sm_resource(device, &dev, &whole);
  if (e != CUDA_SUCCESS) return (int)e;
  e = cut(&whole, group_sms, &res[0], &res[1]);
  if (e != CUDA_SUCCESS) return (int)e;
  CUgreenCtx ctx[2] = {nullptr, nullptr};
  CUstream stream[2] = {nullptr, nullptr};
  for (int i = 0; i < 2; ++i) {
    e = make_context(dev, &res[i], &ctx[i], &stream[i]);
    if (e != CUDA_SUCCESS) {
      if (i == 1) {
        cuStreamDestroy(stream[0]);
        cuGreenCtxDestroy(ctx[0]);
      }
      return (int)e;
    }
  }
  for (int i = 0; i < 2; ++i) {
    o[3 * i] = (long long)ctx[i];
    o[3 * i + 1] = (long long)stream[i];
    o[3 * i + 2] = (long long)res[i].sm.smCount;
  }
  o[6] = o[7] = 0;
  return 0;
}

// Destroy both halves of a split made by green_split_create (the streams
// first; the caller has drained them).
int green_split_destroy(void* ctx0, void* stream0, void* ctx1,
                        void* stream1) {
  CUresult first = CUDA_SUCCESS;
  void* streams[2] = {stream0, stream1};
  void* ctxs[2] = {ctx0, ctx1};
  for (int i = 0; i < 2; ++i) {
    CUresult e = cuStreamDestroy(static_cast<CUstream>(streams[i]));
    if (first == CUDA_SUCCESS) first = e;
    e = cuGreenCtxDestroy(static_cast<CUgreenCtx>(ctxs[i]));
    if (first == CUDA_SUCCESS) first = e;
  }
  return (int)first;
}

}  // extern "C"
