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
//              one warp per node, K1's kkt_node_row_warp, e applied by its
//              lane 0; s is this shard's partial of E x_a, which the solver
//              folds across ranks.
// One launch, as K1: ceil(p / 8) node blocks of 8 warp rows, numbered
// before the arc blocks, as K1's (numbered after them K7 took 0.0155 ms
// against 0.0124 at the headline and 0.148 against 0.120 at 5M on the
// H100; PERF.md §6). e * g is exact at e = 1, so with e = 1 and one shard (the
// whole instance) the output is bitwise K1's. The block-row kernel it
// replaced (kkt_node_row, one block a node, after the arc blocks) stays as
// the reference, reached only by tpl_kkt_shard_matvec_blockrows.
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


// BlockRows: the reference (one block row a node, after the arc blocks).
template <bool BlockRows>
__global__ void __launch_bounds__(kThreads)
kkt_shard_matvec_kernel(const float* __restrict__ d, const int* __restrict__ u,
                        const int* __restrict__ v, const int* __restrict__ ptr,
                        const int* __restrict__ ent, int m, int p,
                        int arc_blocks, int node_blocks, float e,
                        const float* __restrict__ x, float* __restrict__ y) {
  const float* xn = x + m;
  const bool first = !BlockRows;  // the longest jobs first
  const int b = blockIdx.x;
  const int nb = first ? b : b - arc_blocks;  // node block, if in range
  if (nb < 0 || nb >= node_blocks) {
    const int j = (first ? b - node_blocks : b) * kThreads + threadIdx.x;
    if (j < m)
      y[j] = kkt_arc_row(d[j], x[j], __fmul_rn(e, __ldg(xn + u[j])),
                         __fmul_rn(e, __ldg(xn + v[j])));
    return;  // block-uniform: arc blocks never reach a node row
  }
  if constexpr (BlockRows) {
    __shared__ float sh[kThreads];
    const float total = kkt_node_row(ptr, ent, x, nb, sh);
    if (threadIdx.x == 0) y[m + nb] = __fmul_rn(e, total);
  } else {
    const int node = nb * kWarps + threadIdx.x / kWarpSize;
    if (node >= p) return;  // warp-uniform
    const float total = kkt_node_row_warp(ptr, ent, x, node);
    if (threadIdx.x % kWarpSize == 0) y[m + node] = __fmul_rn(e, total);
  }
}

template <bool BlockRows>
int launch(const float* d, const int* u, const int* v, const int* ptr,
           const int* ent, int m, int p, float e_scale, const float* x,
           float* y, cudaStream_t stream) {
  const int arc_blocks = (m + kThreads - 1) / kThreads;
  const int node_blocks = BlockRows ? p : (p + kWarps - 1) / kWarps;
  kkt_shard_matvec_kernel<BlockRows>
      <<<arc_blocks + node_blocks, kThreads, 0, stream>>>(
          d, u, v, ptr, ent, m, p, arc_blocks, node_blocks, e_scale, x, y);
  return static_cast<int>(cudaGetLastError());
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
  return tpl::launch<false>(d, u, v, ptr, ent, m, p, e_scale, x, y, stream);
}

// The reference: the block-row kernel K7 replaced, bitwise K7.
extern "C" int tpl_kkt_shard_matvec_blockrows(const float* d, const int* u,
                                              const int* v, const int* ptr,
                                              const int* ent, int m, int p,
                                              float e_scale, const float* x,
                                              float* y, cudaStream_t stream) {
  return tpl::launch<true>(d, u, v, ptr, ent, m, p, e_scale, x, y, stream);
}
