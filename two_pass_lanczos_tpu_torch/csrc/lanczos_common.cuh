// Shared device code of the port's Lanczos kernels (kkt_matvec.cu,
// kkt_shard_matvec.cu, lanczos_pass_one.cu, lanczos_pass_two.cu,
// eft_check.cu; lanczos_persistent.cuh builds the persistent passes on it),
// built together into one shared library by
// two_pass_lanczos_tpu_torch/ops/_build.py.
//
// Bitwise replay. Pass two regenerates pass one's basis from the stored
// alpha and beta, so the vector update
//     w -= beta_prev * v_prev;  w -= alpha * v;  v_next = w * (1 / beta)
// must round identically in both passes. Both call the routines below, which
// spell every operation with an explicit round-to-nearest intrinsic, so the
// compiler cannot contract a multiply and a subtract into an FMA in one
// pass and not in the other. 1/beta and sqrt are the IEEE-rounded
// __frcp_rn / __fsqrt_rn (the build never passes --use_fast_math).
//
// Determinism. Every reduction is a fixed-order two-stage sum (per-thread
// strided partials, a fixed shared-memory tree per block, then one block
// folding the block partials) with a launch configuration that depends on
// n only. No atomics anywhere on the Lanczos path.
#pragma once

#include <cuda_runtime.h>

namespace tpl {

constexpr int kThreads = 256;       // every kernel of the library
// Block partials of one reduction: plane 0 holds the sums (the hi parts in
// the compensated build), plane 1 the lo parts; the wrapper's partials
// buffer holds 2 * kMaxPartials floats (4 * for the persistent passes one,
// whose two dots keep their partials apart).
constexpr int kMaxPartials = 1024;

// w - c * x, rounded after the product and after the difference.
__device__ __forceinline__ float sub_scaled(float w, float c, float x) {
  return __fsub_rn(w, __fmul_rn(c, x));
}

// The full replay update of one element: (w - beta_prev*vp) - alpha*v.
__device__ __forceinline__ float lanczos_update(float w, float beta_prev,
                                                float vp, float alpha,
                                                float v) {
  return sub_scaled(sub_scaled(w, beta_prev, vp), alpha, v);
}

// v_next = w * (1/beta), with 1/beta computed by lanczos_inverse.
__device__ __forceinline__ float normalise(float w, float inv_beta) {
  return __fmul_rn(w, inv_beta);
}

__device__ __forceinline__ float lanczos_inverse(float beta) {
  return __frcp_rn(beta);
}

// Round-to-nearest arithmetic for float and double, spelled with the
// intrinsics so that code templated on the scalar type contracts nothing.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// How a shared routine reads a vector element: straight (every standalone
// kernel, where the compiler may take the read-only path for a const
// __restrict__ input), or with an explicit ld.global.ca (the persistent
// passes, lanczos_persistent.cuh), for vectors that other blocks wrote
// earlier in the same launch. Such a load may never take the read-only
// (.nc) path, which is only for data no thread writes during the kernel;
// through the L1 it sees the other blocks' stores, because the grid
// barrier's acquire fence invalidates the L1. Either way the value, and so
// the arithmetic, is the same.
struct DirectLoad {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* p) const {
    return *p;
  }
};
struct CachedLoad {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* p) const {
    return __ldca(p);
  }
};

// Fixed-order block sum over kThreads threads; every thread must call it.
// Returns the total in every thread.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = add_rn(sh[t], sh[t + s]);
    __syncthreads();
  }
  T total = sh[0];
  __syncthreads();
  return total;
}

// The two parts of one KKT matvec, shared by K1/K8 (kkt_matvec.cu) and K7
// (kkt_shard_matvec.cu) so that both round alike.
// Arc row j: (d_j * x_j + g_u) - g_v, g_u and g_v the gathered node values.
template <typename T>
__device__ __forceinline__ T kkt_arc_row(T d, T x, T gu, T gv) {
  return sub_rn(add_rn(mul_rn(d, x), gu), gv);
}

// Node row: the sum of +-x_a over the node's CSR segment ptr/ent (entry ~a
// is arc a with sign -1), walked in a fixed strided order and folded with
// block_sum: deterministic, no atomics. Every thread of the block must call
// it; returns the sum in every thread. x_a is read through `load`. The
// block-row reference entry points and K3 run it; every other matvec (and
// every K14 probe) runs kkt_node_row_warp, which gives the same bits.
template <typename T, typename Load = DirectLoad>
__device__ __forceinline__ T kkt_node_row(const int* __restrict__ ptr,
                                          const int* __restrict__ ent,
                                          const T* __restrict__ xa, int node,
                                          T* sh, Load load = Load()) {
  const int end = ptr[node + 1];
  T acc = T(0);
  for (int q = ptr[node] + threadIdx.x; q < end; q += kThreads) {
    const int a = ent[q];
    acc = a >= 0 ? add_rn(acc, load(xa + a)) : sub_rn(acc, load(xa + ~a));
  }
  return block_sum(acc, sh);
}

constexpr int kWarpSize = 32;
constexpr int kWarps = kThreads / kWarpSize;  // warps of a block: 8

// The same node row computed by ONE warp, bitwise kkt_node_row. Lane l
// stands for the threads vt = l + 32 r (r = 0..7) of kkt_node_row's block:
// each folds the entries ptr[node] + vt + 256 i in increasing i with the
// same add_rn / sub_rn, so each of the 256 partials is kkt_node_row's. Then
// block_sum's tree, pair for pair: its levels s = 128, 64, 32 add partial
// vt + s into partial vt, here acc[r + s / 32] into acc[r] in registers;
// its levels s = 16 .. 1 add lane l + s into lane l by a full-mask shuffle,
// the lane's own value first. A round issues the lane's 8 entry loads, then
// its 8 x_a loads, then the 8 adds: 8 gathers in flight a lane where the
// block row had one. Every lane of the warp must call it; lane 0 returns
// the row (a degree-0 node gives +0, as kkt_node_row). No shared memory,
// no barrier, no atomic: the warp's other work and the block's other warps
// never wait for it.
template <typename T, typename Load = DirectLoad>
__device__ __forceinline__ T kkt_node_row_warp(const int* __restrict__ ptr,
                                               const int* __restrict__ ent,
                                               const T* __restrict__ xa,
                                               int node, Load load = Load()) {
  constexpr int kLanes = kWarpSize;
  constexpr int kPer = kThreads / kLanes;  // partials a lane holds: 8
  const int end = ptr[node + 1];
  T acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = T(0);
  for (int q0 = ptr[node] + threadIdx.x % kLanes; q0 < end; q0 += kThreads) {
    int a[kPer];
    T x[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      a[r] = q0 + r * kLanes < end ? ent[q0 + r * kLanes] : 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      x[r] = q0 + r * kLanes < end ? load(xa + (a[r] >= 0 ? a[r] : ~a[r]))
                                   : T(0);
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      if (q0 + r * kLanes < end)
        acc[r] = a[r] >= 0 ? add_rn(acc[r], x[r]) : sub_rn(acc[r], x[r]);
  }
#pragma unroll
  for (int s = kPer / 2; s > 0; s >>= 1)
#pragma unroll
    for (int r = 0; r < s; ++r) acc[r] = add_rn(acc[r], acc[r + s]);
#pragma unroll
  for (int s = kLanes / 2; s > 0; s >>= 1)
    acc[0] = add_rn(acc[0], __shfl_down_sync(0xffffffffu, acc[0], s));
  return acc[0];
}

// Error-free transformations of the compensated (two-float) reductions,
// the counterparts of _two_sum_k, _two_prod and _df_add2 in
// two_pass_lanczos_tpu/ops/kkt_fused.py. Every operation is an explicit
// round-to-nearest intrinsic, so nvcc can neither contract nor reorder them
// (a contracted or reassociated two_sum returns a zero error term).
// csrc/eft_check.cu checks them on the card against exact values.

// s + e == a + b exactly (Knuth).
__device__ __forceinline__ float2 two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  const float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return make_float2(s, e);
}

// p + e == a * b exactly: Hopper's fused multiply-add rounds once, so
// fma(a, b, -p) is the product's rounding error. The TPU kernel's mantissa
// split (_mask_split) existed only to dodge contraction on the XLA CPU path.
__device__ __forceinline__ float2 two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  return make_float2(p, __fmaf_rn(a, b, -p));
}

// (ah, al) + (bh, bl) as a renormalised two-float pair, in _df_add2's order.
__device__ __forceinline__ float2 df_add2(float ah, float al, float bh,
                                          float bl) {
  const float s = __fadd_rn(ah, bh);
  const float bb = __fsub_rn(s, ah);
  const float e = __fadd_rn(
      __fadd_rn(__fsub_rn(ah, __fsub_rn(s, bb)), __fsub_rn(bh, bb)),
      __fadd_rn(al, bl));
  const float hi = __fadd_rn(s, e);
  return make_float2(hi, __fsub_rn(e, __fsub_rn(hi, s)));
}

// block_sum for two-float pairs: the same fixed tree, folding with df_add2.
__device__ __forceinline__ float2 block_sum2(float2 v, float* sh, float* sl) {
  const int t = threadIdx.x;
  sh[t] = v.x;
  sl[t] = v.y;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      const float2 r = df_add2(sh[t], sl[t], sh[t + s], sl[t + s]);
      sh[t] = r.x;
      sl[t] = r.y;
    }
    __syncthreads();
  }
  const float2 total = make_float2(sh[0], sl[0]);
  __syncthreads();
  return total;
}

// Number of blocks of the grid-strided reductions over n elements: a
// function of n alone, so pass one reduces in the same order in every run.
inline int reduction_blocks(int n) {
  int g = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (g < 1) g = 1;
  return g < kMaxPartials ? g : kMaxPartials;
}

// Enqueue one y = A x of the KKT matrix (kkt_matvec.cu), for T = float or
// double. With gate != null the launch is a no-op unless gate_lt < *gate,
// read on the device, which is how the passes mask steps after a breakdown
// without a host sync.
template <typename T>
cudaError_t launch_kkt_matvec(const T* d, const int* u, const int* v,
                              const int* ptr, const int* ent, int m, int p,
                              const T* x, T* y, const int* gate, int gate_lt,
                              cudaStream_t stream);

}  // namespace tpl
