// Shared code of the K14 micro-kernels (probe_gather.cu, probe_stream.cu,
// probe_stages.cu, probe_pipeline.cu): the measurements that the JAX
// package's Pallas probes (scripts/probe_gather.py, scripts/probe/) took on
// a TPU, asked again of the port's own layout on Hopper.
#pragma once

#include <cuda_runtime.h>

#include "lanczos_common.cuh"

namespace tpl {

// The scale at which a probe folds work it must not drop (an index standing
// in for a gathered value, an extra ALU chain, an extra gather) into its
// output: far below any output's ulp at the instances' magnitudes, yet a
// data dependence the compiler must keep.
constexpr float kTiny = 1e-30f;

// the ALU chain's step of the stage and pipeline probes' "alu N" mode,
// r = r * kAluMul + kAluAdd, rounded after each
constexpr float kAluMul = 0.999f;
constexpr float kAluAdd = 1e-3f;

// kkt_node_row_warp's load for the stages without the gather: the entry's
// arc index a, as 1e-30 * float(a), in place of x_a[a].
struct IndexAsValue {
  const float* base;
  __device__ __forceinline__ float operator()(const float* p) const {
    return __fmul_rn(kTiny, __int2float_rn(static_cast<int>(p - base)));
  }
};

// Streaming multiprocessors of the current device (cached per process).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return sms;
}

// A persistent grid for `kernel`: as many blocks as are resident at once
// (SMs x blocks per SM at `threads` and `smem` bytes), at most `want`.
template <typename Kernel>
inline int resident_grid(Kernel kernel, int threads, size_t smem,
                         long long want) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  if (per_sm < 1) per_sm = 1;
  const long long cap = static_cast<long long>(sm_count()) * per_sm;
  const long long g = want < cap ? want : cap;
  return g < 1 ? 1 : static_cast<int>(g);
}

// Hopper's copy engine (TMA) on plain byte ranges, and the mbarriers its
// copies complete: the staging of K14a's smem and cluster tiers and K14d's
// arc ring. A bulk copy needs 16-byte aligned ends in both memories and a
// size that is a multiple of 16; its bytes complete the transaction count
// that mbarrier.arrive.expect_tx armed. An mbarrier's phase completes when
// its arrivals (the count given at init) and its armed bytes are all in;
// try_wait.parity(P) returns once the phase of parity P has completed (a
// fresh barrier is in phase 0, so parity 1 passes at once).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread inits; mbar_init_fence makes the inits visible to the copy
// engine, and a barrier of the block to the other threads.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// This thread's arrival, arming the phase for `bytes` more of copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// `bytes` from global src into this block's shared memory at dst, their
// arrival counted on the mbarrier bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Orders this thread's shared-memory writes before the copy engine's reads
// of them (a bulk store of what the threads wrote).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` from this block's shared memory at src to global dst, in this
// thread's current bulk group; bulk_commit closes the group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most N of this thread's bulk groups still read shared memory
// (their sources may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Until at most N of this thread's bulk groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace tpl
