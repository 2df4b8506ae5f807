// K12: one shard's part of the double-float y = A x of the KKT matrix
// A = [[D, E^T], [E, 0]], for the arc-sharded df solver
// (parallel/fused_sharded_df.py).
//
// Replaces _df_matvec_streaming_kernel (two_pass_lanczos_tpu/ops/
// kkt_fused_df.py:602, launched by df_kkt_streaming_matvec :632), the
// per-device df matvec of DFShardedFusedKKTSolver for shards past the
// TPU's resident df cap: it streamed a shard's dual sorted arc planes (d
// hi/lo, x and y as (2, R, 128) pairs) from HBM in a sequential grid of
// chunks and carried the (2, P2, 128) df node partial in VMEM scratch. Here
// a shard is the f32 solver's Hopper layout over its own arcs (arcs in
// their original order, a node-sorted incidence CSR over the GLOBAL node
// ids) with d as a (2, m_d) hi/lo pair; the local vector is [x_a of the
// shard, x_n] as m_d + p (hi, lo) pairs (df_common.cuh), so that each
// gathered entry is one 8-byte load and one L2 sector. It computes, with
// the pair K11's rows (df_kkt_pair_block),
//   arc part   y_a[j], one thread per arc: df_kkt_arc_row (exact product
//              with cross terms, df difference of the gathered node pairs,
//              df_add2);
//   node part  s[i], one block per node: df_kkt_node_row (df_add2 fold of
//              the shard's segment, block_sum2), this shard's df partial of
//              E x_a, which the solver df-folds across ranks.
// One launch and no atomics. With one shard (the whole instance) the output
// is bitwise K11's (either instance) in both halves of every pair.
//
// What bounds it on the H100: the function moves d, x_a, y_a as hi/lo pairs
// and u, v once (32 B per arc) and the x_n, s pairs once (16 B per node):
// 32 m_d + 16 p bytes, 160 MB at the 5M-arc instance (200 MB with the CSR),
// past the 50 MB L2, so it streams from HBM; ~50 f32 operations per arc.
#include "df_common.cuh"

namespace tpl {
namespace {

__global__ void __launch_bounds__(kThreads)
df_kkt_shard_matvec_kernel(const float* __restrict__ d2,
                           const int* __restrict__ u,
                           const int* __restrict__ v,
                           const int* __restrict__ ptr,
                           const int* __restrict__ ent, int m, int arc_blocks,
                           const float2* __restrict__ x,
                           float2* __restrict__ y) {
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  df_kkt_pair_block(d2, u, v, ptr, ent, m, arc_blocks, x, y, sh, sl);
}

}  // namespace
}  // namespace tpl

// d2 (2 x m) one shard's costs, hi in row 0 and lo in row 1; u, v, ptr,
// ent its layout; x and y the local (m + p) pairs, (hi_i, lo_i) at element
// i. All pointers are device pointers. Does not synchronise; returns
// cudaGetLastError().
extern "C" int tpl_df_kkt_shard_matvec(const float* d2, const int* u,
                                       const int* v, const int* ptr,
                                       const int* ent, int m, int p,
                                       const float* x, float* y,
                                       cudaStream_t stream) {
  const int arc_blocks = (m + tpl::kThreads - 1) / tpl::kThreads;
  tpl::df_kkt_shard_matvec_kernel<<<arc_blocks + p, tpl::kThreads, 0,
                                    stream>>>(
      d2, u, v, ptr, ent, m, arc_blocks, reinterpret_cast<const float2*>(x),
      reinterpret_cast<float2*>(y));
  return static_cast<int>(cudaGetLastError());
}
