// The persistent form of the fused passes: one cooperative launch runs a
// whole pass (K2 in lanczos_pass_one.cu, K3 in lanczos_pass_two.cu, and
// their double-float counterparts K9 in df_lanczos_pass_one.cu, K10 in
// df_lanczos_pass_two.cu), with grid barriers between the phases of each
// step.
//
// Why. The TPU kernels (_pass_one_kernel, two_pass_lanczos_tpu/ops/
// kkt_fused.py:581; _pass_two_kernel, :841) ran all k steps in one launch
// with the state in VMEM. As separate launches a Hopper step pays one
// launch boundary per phase, each a drain of the whole card, plus one-block
// folds that leave 131 of 132 SMs idle. Here the grid stays resident: it is
// launched with cudaLaunchCooperativeKernel, and cooperative_groups' grid
// sync orders the phases. A card that refuses the launch makes the entry
// point return the error: there is no fallback to the per-step launches.
//
// Bits. Every phase walks VIRTUAL blocks: the blocks of the launch it
// replaces, numbered as that launch numbered them, each resident block
// taking an even, contiguous share of them (share_of). A virtual block
// computes exactly what the block of the same number did (same elements,
// same per-thread order, the same block_sum tree, its partial stored at its
// own number), so the result does not depend on how many blocks are
// resident, and the passes are bitwise the launches they replace. Pass
// one deals its node rows to warps, not blocks (row_share): each is one
// warp's kkt_node_row_warp, bitwise K1's block row, whichever warp runs it.
// Vectors that another block wrote earlier in the launch are read with
// CachedLoad (never the read-only path); data that no block writes (the
// layout, b, alpha, beta, y) is read straight.
//
// What bounds it on the H100: at the headline size (n = 501,155) one step
// moves ~30 MB through the 50 MB L2 (the matvec and the passes over the
// (n,) vectors), and the matvec's node rows gather x_a from all over it, so
// a step is bound by the L2 and by its grid barriers (~1-2 us each, every
// resident block a round trip through the L2), repeated over 500 dependent
// steps. The design removes the launches and the one-block folds (every
// block folds the block partials itself, in the same order, so alpha and
// beta stay in registers), and fuses phases until a step has as few
// barriers as its dependencies allow: two in pass one (the two dots), one
// in pass two.
#pragma once

#include <cooperative_groups.h>

#include "lanczos_common.cuh"

namespace tpl {

// Resident blocks per SM, at most, of K3 (pass one has its own,
// kPassOneBlocksPerSM in lanczos_pass_one.cu). Fewer than the occupancy
// allows (6 for K3 at kThreads) is faster on the H100: grids of 3 to 8
// blocks an SM were tried and 5 was fastest. The sums do not depend on it.
constexpr int kPersistentBlocksPerSM = 5;
// The df passes' own cap (K9, K10). Their kernels are built with it as
// __launch_bounds__' minimum blocks per SM, so that every build of them
// (with and without the phase timer) reaches it and runs on the same grid.
constexpr int kDFPersistentBlocksPerSM = 5;

__device__ __forceinline__ void grid_sync() {
  cooperative_groups::this_grid().sync();
}

// The virtual blocks [begin, end) of `count` that this block runs: an even,
// contiguous share, so that the blocks with work spread over the whole grid
// whatever the count.
struct Share {
  int begin, end;
};
__device__ __forceinline__ Share share_of(int count) {
  const long long b = blockIdx.x, g = gridDim.x;
  return {static_cast<int>(b * count / g),
          static_cast<int>((b + 1) * count / g)};
}

// The node rows [begin, end) of `rows` that THIS WARP computes (one warp a
// row, kkt_node_row_warp): an even, contiguous share over all the grid's
// warps, so that the rows spread over every SM. The bits do not depend on
// it: a row is one warp's, whichever. (Putting the rows only on the blocks
// that share_of leaves without dot work was slower at the headline;
// PERF.md §6.)
__device__ __forceinline__ Share row_share(int rows) {
  const long long at = static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / kWarpSize;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  return {static_cast<int>(at * rows / warps),
          static_cast<int>((at + 1) * rows / warps)};
}

// A hand-over from one thread to another inside a phase, with no atomic:
// the producer's earlier stores are visible to a consumer that has seen
// `tag` (a release store; relaxed loads, then the consumer's acquire fence).
__device__ __forceinline__ void publish(int* flag, int tag) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(tag)
               : "memory");
}
__device__ __forceinline__ void wait_for(const int* flag, int tag) {
  for (;;) {
    int seen;
    asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
                 : "=r"(seen)
                 : "l"(flag)
                 : "memory");
    if (seen == tag) break;
    __nanosleep(32);
  }
  __threadfence();
}

// The phase timer of the persistent passes (chip_smoke.py phase 7 prints
// what it records). Every solve passes clock == nullptr, and then it does
// nothing. Otherwise, for the kTimedSteps steps from step `first`, every
// resident block stamps %globaltimer (ns) at the end of each phase:
// thread 0 writes clock[(s * gridDim.x + blockIdx.x) * stamps + e] for
// sampled step s and stamp e, after a __syncthreads so that the whole
// block has finished the phase. A phase that each warp ends on its own (the
// warp rows of K2-K6) is stamped with no barrier: warp_stamp leaves
// each warp's end in the block's `ends`, and the next stamp writes the
// latest of them, so that the block's other warps never wait for its row
// warps. It changes no value the pass computes.
constexpr int kTimedSteps = 8;
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct PhaseClock {
  long long* clock;
  int first, stamps;
  __device__ __forceinline__ bool timed(int j) const {
    return clock != nullptr && j >= first && j < first + kTimedSteps;
  }
  __device__ __forceinline__ long long* at(int j) const {
    return clock +
           (static_cast<long long>(j - first) * gridDim.x + blockIdx.x) *
               stamps;
  }
  __device__ __forceinline__ void stamp(int j, int e) const {
    if (clock == nullptr || j < first || j >= first + kTimedSteps) return;
    __syncthreads();  // j is the same in every thread: no divergence
    if (threadIdx.x == 0) at(j)[e] = global_ns();
  }
  // stamp e of a phase each warp ends on its own: no barrier; lane 0 leaves
  // the warp's end in ends[warp] (kWarps slots in shared memory)
  __device__ __forceinline__ void warp_stamp(int j, int e,
                                             long long* ends) const {
    if (!timed(j)) return;
    if (threadIdx.x % kWarpSize == 0)
      ends[threadIdx.x / kWarpSize] = global_ns();
  }
  // stamp e after a warp_stamp(j, e - 1, ends): that stamp is the latest
  // warp's end
  __device__ __forceinline__ void stamp(int j, int e,
                                        const long long* ends) const {
    if (!timed(j)) return;
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long t = global_ns();
      long long last = ends[0];
      for (int w = 1; w < kWarps; ++w) last = last > ends[w] ? last : ends[w];
      at(j)[e - 1] = last;
      at(j)[e] = t;
    }
  }
};

// A phase timer that records nothing. The df passes (K9, K10) are built once
// with it, for the solves, and once with PhaseClock, for the timer, so a
// solve carries none of the timer's code or registers.
struct NoClock {
  __device__ __forceinline__ void stamp(int, int) const {}
};

// x[i] * scale, read as CachedLoad reads x[i]: a gather of the normalised
// v = w * (1/beta) straight from w, bitwise what normalise would store.
struct ScaledLoad {
  float scale;
  __device__ __forceinline__ float operator()(const float* p) const {
    return normalise(__ldca(p), scale);
  }
};

// The cooperative grid of `kernel`: blocks per SM (at most `cap`) and SMs.
template <typename P>
cudaError_t persistent_grid(void (*kernel)(P), int* blocks_per_sm, int* sms,
                            int cap = kPersistentBlocksPerSM) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      kThreads, 0);
  if (*blocks_per_sm > cap) *blocks_per_sm = cap;
  return err;
}

// Launch `kernel(params)` on `stream` as one cooperative grid of
// persistent_grid's blocks; returns the launch's error, if any.
template <typename P>
cudaError_t launch_persistent(void (*kernel)(P), P params,
                              cudaStream_t stream,
                              int cap = kPersistentBlocksPerSM) {
  int per_sm = 0, sms = 0;
  cudaError_t err = persistent_grid(kernel, &per_sm, &sms, cap);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(per_sm * sms), dim3(kThreads), args,
                                    0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace tpl
