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
// ids) with d as a (2, m_d) hi/lo pair; the local vector is the (2, m_d + p)
// pair [x_a of the shard, x_n]. It computes
//   arc part   y_a[j], one thread per arc: K11's df_kkt_arc_row (exact
//              product with cross terms, df difference of the gathered node
//              pairs, df_add2);
//   node part  s[i], one block per node: K11's df_kkt_node_row (df_add2
//              fold of the shard's segment, block_sum2), this shard's df
//              partial of E x_a, which the solver df-folds across ranks.
// One launch and no atomics. With one shard (the whole instance) the output
// is bitwise K11's in both planes.
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
                           const int* __restrict__ ent, int m, int n,
                           int arc_blocks, const float* __restrict__ x2,
                           float* __restrict__ y2) {
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  const float* xh = x2;
  const float* xl = x2 + n;
  if (blockIdx.x < arc_blocks) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j < m) {
      const int a = m + u[j];
      const int b = m + v[j];
      const float2 y = df_kkt_arc_row(d2[j], d2[m + j], xh[j], xl[j],
                                      __ldg(xh + a), __ldg(xl + a),
                                      __ldg(xh + b), __ldg(xl + b));
      y2[j] = y.x;
      y2[n + j] = y.y;
    }
    return;  // block-uniform: arc blocks never reach block_sum2
  }
  const int node = blockIdx.x - arc_blocks;
  const float2 total = df_kkt_node_row(ptr, ent, xh, xl, node, sh, sl);
  if (threadIdx.x == 0) {
    y2[m + node] = total.x;
    y2[n + m + node] = total.y;
  }
}

}  // namespace
}  // namespace tpl

// d2 (2 x m) one shard's costs, hi in row 0 and lo in row 1; u, v, ptr,
// ent its layout; x2 and y2 (2 x (m + p)) the local pairs. All pointers are
// device pointers. Does not synchronise; returns cudaGetLastError().
extern "C" int tpl_df_kkt_shard_matvec(const float* d2, const int* u,
                                       const int* v, const int* ptr,
                                       const int* ent, int m, int p,
                                       const float* x2, float* y2,
                                       cudaStream_t stream) {
  const int arc_blocks = (m + tpl::kThreads - 1) / tpl::kThreads;
  tpl::df_kkt_shard_matvec_kernel<<<arc_blocks + p, tpl::kThreads, 0,
                                    stream>>>(d2, u, v, ptr, ent, m, m + p,
                                              arc_blocks, x2, y2);
  return static_cast<int>(cudaGetLastError());
}
