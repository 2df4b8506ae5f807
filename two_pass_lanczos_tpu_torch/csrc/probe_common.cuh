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

}  // namespace tpl
