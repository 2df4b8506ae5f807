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
//
// The fused step (shard_step.cuh) adds two instances, kkt_shard_matvec_kernel
// <StepPassOne> and <StepPassTwo>: the same arc rows at e = 1 and the same
// node blocks, the node partial written to a buffer of its own, and each arc
// thread going on with the recurrence's arc work on the y_a[j] it holds, so
// y_a is never stored. Pass one's arc thread reads v_prev_a[j] and writes
// w_a[j] (4 B an arc more than the plain instance), pass two's reads
// v_prev_a[j], writes v_next_a[j] and updates x_a[j] (12 B an arc more, 8
// more for each further f row). No thread reads a vector that its launch
// writes: v, which the node blocks gather, is only read.
#include "shard_step.cuh"

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

// Pass one's arc work: w_a[j] = y_a[j] - beta_prev v_prev_a[j], and the
// block's fixed-order partial of <v_a, w_a>.
struct StepPassOne {
  const float* __restrict__ vp;        // v_prev, the local vector
  float* __restrict__ w;               // w, the local vector (arcs here)
  float* __restrict__ partials;        // one a block of arcs
  const ShardStepState* __restrict__ state;

  __device__ __forceinline__ void arcs(bool live, int j, float vj, float yj,
                                       int block) const {
    __shared__ float sh[kThreads];
    float part = 0.0f;
    if (live) {
      const float wj = sub_scaled(yj, state->beta_prev, vp[j]);
      w[j] = wj;
      part = mul_rn(vj, wj);
    }
    const float total = block_sum(part, sh);
    if (threadIdx.x == 0) partials[block] = total;
  }
};

// Pass two's arc work from the stored alpha_j, beta_j: v_next_a[j] and, for
// each of the nf rows of y, x_a[j] += y_{j+1} v_next_a[j]. An inactive step
// writes nothing here (two_nodes moves the state on).
struct StepPassTwo {
  const float* __restrict__ vp;     // v_prev
  float* __restrict__ vnext;        // v_next
  const float* __restrict__ alphas;
  const float* __restrict__ betas;
  const int* __restrict__ steps;    // steps_taken
  const float* __restrict__ y;      // (nf, k)
  float* __restrict__ xs;           // the solutions, (nf, n)
  int nf, k, n, step;

  __device__ __forceinline__ void arcs(bool live, int j, float vj, float yj,
                                       int) const {
    const PassTwoScalars s = pass_two_scalars(alphas, betas, steps, step);
    if (!live || !s.active) return;
    const float vn = normalise(
        lanczos_update(yj, s.beta_prev, vp[j], s.alpha, vj), s.inv_beta);
    vnext[j] = vn;
    for (int f = 0; f < nf; ++f)
      xs[f * n + j] = add_rn(xs[f * n + j], mul_rn(y[f * k + step + 1], vn));
  }
};

// K7's step instances: K7 at e = 1 (kkt_arc_row on the gathered x_n, the
// warp node rows first), the node partial into s, and Step's arc work in
// the thread that computed y_a[j]. Every thread of an arc block reaches
// Step::arcs, whose block sum needs them all.
template <class Step>
__global__ void __launch_bounds__(kThreads)
kkt_shard_matvec_kernel(const float* __restrict__ d, const int* __restrict__ u,
                        const int* __restrict__ v, const int* __restrict__ ptr,
                        const int* __restrict__ ent, int m, int p,
                        int node_blocks, const float* __restrict__ x,
                        float* __restrict__ s, Step step) {
  const float* xn = x + m;
  const int b = blockIdx.x;
  if (b >= node_blocks) {
    const int block = b - node_blocks;
    const int j = block * kThreads + threadIdx.x;
    const bool live = j < m;
    float xj = 0.0f, yj = 0.0f;
    if (live) {
      xj = x[j];
      yj = kkt_arc_row(d[j], xj, __ldg(&xn[u[j]]), __ldg(&xn[v[j]]));
    }
    step.arcs(live, j, xj, yj, block);
    return;  // block-uniform: arc blocks never reach a node row
  }
  const int node = b * kWarps + threadIdx.x / kWarpSize;
  if (node >= p) return;  // warp-uniform
  const float total = kkt_node_row_warp(ptr, ent, x, node);
  if (threadIdx.x % kWarpSize == 0) s[node] = total;
}

template <class Step>
int launch_step(const float* d, const int* u, const int* v, const int* ptr,
                const int* ent, int m, int p, const float* x, float* s,
                const Step& step, cudaStream_t stream) {
  const int arc_blocks = (m + kThreads - 1) / kThreads;
  const int node_blocks = (p + kWarps - 1) / kWarps;
  kkt_shard_matvec_kernel<Step>
      <<<node_blocks + arc_blocks, kThreads, 0, stream>>>(
          d, u, v, ptr, ent, m, p, node_blocks, x, s, step);
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

// K7's pass-one step instance over one shard's layout (d ... p as above):
// from v_prev and v (m + p each, local vectors), w_a into w[0, m), the node
// partial into s (p), and <v_a, w_a>'s block partials into partials
// (ceil(m / 256)); state is the step's ShardStepState slot (int32 x 4).
extern "C" int tpl_shard_step_one_matvec(const float* d, const int* u,
                                         const int* v, const int* ptr,
                                         const int* ent, int m, int p,
                                         const float* v_prev,
                                         const float* v_curr, float* w,
                                         float* s, float* partials,
                                         const int* state,
                                         cudaStream_t stream) {
  const tpl::StepPassOne step{
      v_prev, w, partials,
      reinterpret_cast<const tpl::ShardStepState*>(state)};
  return tpl::launch_step(d, u, v, ptr, ent, m, p, v_curr, s, step, stream);
}

// K7's pass-two step instance: step `step` of pass two from v_prev and v,
// v_next_a into v_next[0, m) and x_a of each of the nf rows of x (nf, m + p)
// updated with y (nf, k); alphas, betas (k) and steps_taken (1) as stored
// by pass one; the node partial into s (p).
extern "C" int tpl_shard_step_two_matvec(const float* d, const int* u,
                                         const int* v, const int* ptr,
                                         const int* ent, int m, int p,
                                         const float* v_prev,
                                         const float* v_curr, float* v_next,
                                         float* s, const float* alphas,
                                         const float* betas, const int* steps,
                                         const float* y, int nf, int k,
                                         int step, float* x,
                                         cudaStream_t stream) {
  const tpl::StepPassTwo two{v_prev, v_next, alphas, betas, steps, y, x,
                             nf, k, m + p, step};
  return tpl::launch_step(d, u, v, ptr, ent, m, p, v_curr, s, two, stream);
}
