// K7: one shard's part of y = A x of the KKT matrix A = [[D, E^T], [E, 0]],
// for the arc-sharded solver (parallel/fused_sharded.py).
//
// Replaces _matvec_streaming_kernel (two_pass_lanczos_tpu/ops/kkt_fused.py
// :937, launched by kkt_streaming_matvec :992), the per-device matvec of
// ShardedFusedKKTSolver. The TPU kernel streamed a shard's dual sorted,
// 128-lane padded arc planes from HBM in a sequential grid of 128-row
// chunks (VMEM could not hold a large shard), gathered through windowed lane
// selects, and carried the node partial in VMEM scratch to its last step.
// Here a shard is the f32 solver's Hopper layout over its own arcs (arcs in
// their original order, a node-sorted incidence CSR over the GLOBAL node
// ids, ops/kkt_fused.py KKTLayout) and the local vector is
// [x_a of the shard (m_d), x_n (p)]. With a static scale e (the JAX SoL
// bench's e_scale, default 1) it computes
//   arc part   y_a[j] = (d[j] * x_a[j] + e * x_n[u[j]]) - e * x_n[v[j]]
//              one thread per arc, K1's kkt_arc_row with scaled gathers;
//   node part  s[i] = e * (sum over the shard's entries of node i of +-x_a)
//              one block per node, K1's kkt_node_row; s is this shard's
//              partial of E x_a, which the solver folds across ranks.
// One launch, as K1. e * g is exact at e = 1, so with e = 1 and one shard
// (the whole instance) the output is bitwise K1's.
//
// What bounds it on the H100: the function moves d, u, v, x_a and y_a once
// (20 B per arc) and x_n, s once (8 B per node): 20 m_d + 8 p bytes. At the
// distributed tier's 5M-arc instance that is 100 MB (140 MB with the CSR),
// past the 50 MB L2, so a matvec streams from HBM as the TPU kernel streamed
// from HBM past VMEM: coalesced arc reads and writes, the 14.6 KB node table
// gathered through the read-only path, x_a gathered by the node blocks.
#include "lanczos_common.cuh"

namespace tpl {
namespace {

__global__ void __launch_bounds__(kThreads)
kkt_shard_matvec_kernel(const float* __restrict__ d, const int* __restrict__ u,
                        const int* __restrict__ v, const int* __restrict__ ptr,
                        const int* __restrict__ ent, int m, int arc_blocks,
                        float e, const float* __restrict__ x,
                        float* __restrict__ y) {
  __shared__ float sh[kThreads];
  const float* xn = x + m;
  if (blockIdx.x < arc_blocks) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j < m)
      y[j] = kkt_arc_row(d[j], x[j], __fmul_rn(e, __ldg(xn + u[j])),
                         __fmul_rn(e, __ldg(xn + v[j])));
    return;  // block-uniform: arc blocks never reach block_sum
  }
  const int node = blockIdx.x - arc_blocks;
  const float total = kkt_node_row(ptr, ent, x, node, sh);
  if (threadIdx.x == 0) y[m + node] = __fmul_rn(e, total);
}

}  // namespace
}  // namespace tpl

// d, u, v (m), ptr (p + 1), ent (2 m): one shard's layout; x and y
// (m + p): [x_a of the shard, x_n] and [y_a of the shard, node partial].
// All pointers are device pointers. Does not synchronise; returns
// cudaGetLastError().
extern "C" int tpl_kkt_shard_matvec(const float* d, const int* u,
                                    const int* v, const int* ptr,
                                    const int* ent, int m, int p,
                                    float e_scale, const float* x, float* y,
                                    cudaStream_t stream) {
  const int arc_blocks = (m + tpl::kThreads - 1) / tpl::kThreads;
  tpl::kkt_shard_matvec_kernel<<<arc_blocks + p, tpl::kThreads, 0, stream>>>(
      d, u, v, ptr, ent, m, arc_blocks, e_scale, x, y);
  return static_cast<int>(cudaGetLastError());
}
