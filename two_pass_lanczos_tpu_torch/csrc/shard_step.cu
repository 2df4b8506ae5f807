// The kernels that run after each fold of the arc-sharded solver's fused
// Lanczos step (parallel/sharded_step.py; the step's outline and its
// buffers in shard_step.cuh). On a card they take the place of the PyTorch
// operations that algorithms/core.py's pass_one_scan and pass_two_scan
// issue one at a time around K7 and the folds (~34 launches a step): the
// fold's adds, each dot's cuBLAS dot, reduce and add, each vector update,
// the torch.where masks and the 0-d flag updates.
//
// No TPU kernel: the JAX solver ran the same recurrence in XLA around its
// streaming matvec and lax.psum. What bounds them is the step's vector
// traffic over the shard (m_d + p floats a vector): orthogonalise reads w
// and v and writes w (12 B an element), advance reads w and writes v_next
// (8 B); node_fold, norm and two_nodes touch the p node rows and the block
// partials alone. At 1.25M arcs a rank the vectors and the layout fit in
// the 50 MB L2.
//
// Loads. A vector that a kernel writes it reads with plain loads of
// pointers that are neither const nor __restrict__, so the compiler cannot
// take the read-only path for it; no kernel here uses __ldg.
#include "shard_step.cuh"

namespace tpl {
namespace {

// The vector kernels (orthogonalise, advance) take kQuad elements a thread:
// the elements 4t .. 4t + 3 of the local vector, read and written as one
// 16-byte access (the vectors' rows start 16-byte aligned), element by
// element where a row ends inside the quad.
constexpr int kQuad = 4;
constexpr int kQuadBlock = kThreads * kQuad;  // elements a block

__device__ __forceinline__ void load_quad(const float* row, int e, int n,
                                          float (&q)[kQuad]) {
  if (e + kQuad <= n) {
    const float4 t = *reinterpret_cast<const float4*>(row + e);
    q[0] = t.x;
    q[1] = t.y;
    q[2] = t.z;
    q[3] = t.w;
  } else {
    for (int c = 0; c < kQuad; ++c) q[c] = e + c < n ? row[e + c] : 0.0f;
  }
}

__device__ __forceinline__ void store_quad(float* row, int e, int n,
                                           const float (&q)[kQuad]) {
  if (e + kQuad <= n) {
    *reinterpret_cast<float4*>(row + e) = make_float4(q[0], q[1], q[2], q[3]);
  } else {
    for (int c = 0; c < kQuad && e + c < n; ++c) row[e + c] = q[c];
  }
}

// This block's share (block b of kFoldParts) of the sum of `parts` block
// partials: a contiguous slice, strided over the threads.
__device__ __forceinline__ float slice_sum(const float* __restrict__ partials,
                                           int parts) {
  const int per = (parts + kFoldParts - 1) / kFoldParts;
  const int end = min(parts, (static_cast<int>(blockIdx.x) + 1) * per);
  float acc = 0.0f;
  for (int i = blockIdx.x * per + threadIdx.x; i < end; i += kThreads)
    acc = add_rn(acc, partials[i]);
  return acc;
}

// kFoldParts blocks: y_n = the rank-ordered fold of the gathered node
// partials, w_n = y_n - beta_prev v_prev_n into w[m, m + p), and each
// block's shares of <v_n, w_n> and of the sum of K7's block partials of
// <v_a, w_a> (this rank's arc part of alpha).
__global__ void __launch_bounds__(kThreads)
shard_step_node_fold_kernel(const float* __restrict__ g, int ranks, int m,
                            int p, const float* __restrict__ v_prev,
                            const float* __restrict__ v, float* w,
                            const float* __restrict__ partials, int parts,
                            const ShardStepState* __restrict__ state,
                            float* __restrict__ scal) {
  __shared__ float sh[kThreads];
  const float beta_prev = state->beta_prev;
  float arc = slice_sum(partials, parts), node = 0.0f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p;
       i += kFoldParts * kThreads) {
    const float wi = sub_scaled(fold_ranks(g, ranks, p, i), beta_prev,
                                v_prev[m + i]);
    w[m + i] = wi;
    node = add_rn(node, mul_rn(v[m + i], wi));
  }
  arc = block_sum(arc, sh);
  node = block_sum(node, sh);
  if (threadIdx.x == 0) {
    scal[kAlphaArc + blockIdx.x] = arc;
    scal[kNodeDot + blockIdx.x] = node;
  }
}

// kQuad elements a thread: alpha = fold_dot of the gathered arc parts and
// the node parts, w -= alpha v, and the fixed-order block partials of
// <w_a, w_a> (one a block that holds arcs). Block 0 stores alpha_j, 0
// unless the step executes.
__global__ void __launch_bounds__(kThreads)
shard_step_orthogonalise_kernel(const float* __restrict__ g, int ranks, int m,
                                int n, const float* __restrict__ v, float* w,
                                float* __restrict__ partials,
                                const ShardStepState* __restrict__ state,
                                int k_limit, float* __restrict__ alpha_out,
                                const float* __restrict__ scal) {
  __shared__ float sh[kThreads];
  const float alpha = fold_dot(g, ranks, &scal[kNodeDot]);
  const int e = (blockIdx.x * kThreads + threadIdx.x) * kQuad;
  float part = 0.0f;
  if (e < n) {
    float wq[kQuad], vq[kQuad];
    load_quad(w, e, n, wq);
    load_quad(v, e, n, vq);
    for (int c = 0; c < kQuad; ++c) {
      wq[c] = sub_scaled(wq[c], alpha, vq[c]);
      if (e + c < m) part = add_rn(part, mul_rn(wq[c], wq[c]));
    }
    store_quad(w, e, n, wq);
  }
  if (blockIdx.x * kQuadBlock < m) {  // block-uniform
    const float total = block_sum(part, sh);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *alpha_out = step_executes(state, k_limit) ? alpha : 0.0f;
}

// kFoldParts blocks: each block's shares of the sum of orthogonalise's
// block partials of <w_a, w_a> (this rank's arc part of beta^2) and of
// <w_n, w_n>.
__global__ void __launch_bounds__(kThreads)
shard_step_norm_kernel(int m, int p, const float* __restrict__ w,
                       const float* __restrict__ partials, int parts,
                       float* __restrict__ scal) {
  __shared__ float sh[kThreads];
  float arc = slice_sum(partials, parts), node = 0.0f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p;
       i += kFoldParts * kThreads)
    node = add_rn(node, mul_rn(w[m + i], w[m + i]));
  arc = block_sum(arc, sh);
  node = block_sum(node, sh);
  if (threadIdx.x == 0) {
    scal[kBeta2Arc + blockIdx.x] = arc;
    scal[kNodeBeta2 + blockIdx.x] = node;
  }
}

// kQuad elements a thread: beta = sqrt(fold_dot of the gathered arc parts
// and the node parts); if the step executes and beta > tol it advances,
// v_next = w (1/beta) in place of w; else the state moves one buffer on
// unchanged (v into w's buffer, v_prev into v's). basis_row, if not null,
// receives v (0 unless the step executes). Block 0 writes the next state
// slot and beta_j (0 unless the step advances); every block reads only the
// slot the step started from.
__global__ void __launch_bounds__(kThreads)
shard_step_advance_kernel(const float* __restrict__ g, int ranks, int n,
                          const float* __restrict__ v_prev, float* v,
                          float* w, float* __restrict__ basis_row,
                          const ShardStepState* __restrict__ state,
                          ShardStepState* __restrict__ next_state,
                          int k_limit, float tol, float* __restrict__ beta_out,
                          const float* __restrict__ scal) {
  const float beta = __fsqrt_rn(fold_dot(g, ranks, &scal[kNodeBeta2]));
  const bool executes = step_executes(state, k_limit);
  const bool breakdown = beta <= tol;
  const bool advance = executes && !breakdown;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * kQuad;
  if (e < n) {
    float q[kQuad];
    if (advance) {
      const float inv = lanczos_inverse(beta);
      load_quad(w, e, n, q);
      for (int c = 0; c < kQuad; ++c) q[c] = normalise(q[c], inv);
      store_quad(w, e, n, q);
    }
    if (basis_row != nullptr || !advance) load_quad(v, e, n, q);
    if (basis_row != nullptr)
      for (int c = 0; c < kQuad && e + c < n; ++c)
        basis_row[e + c] = executes ? q[c] : 0.0f;
    if (!advance) {
      store_quad(w, e, n, q);
      load_quad(v_prev, e, n, q);
      store_quad(v, e, n, q);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    next_state->beta_prev = advance ? beta : state->beta_prev;
    next_state->done = state->done | (executes && breakdown);
    next_state->steps = state->steps + (executes ? 1 : 0);
    next_state->b_norm = state->b_norm;
    *beta_out = advance ? beta : 0.0f;
  }
}

// Pass two after its node fold, one thread a node row: the update of
// K7's pass-two instance on the folded y_n, v_next_n and x_n of each of the
// nf rows. On an inactive step the node rows' blocks copy the state one
// buffer on (v into v_next's buffer, v_prev into v's) over the whole local
// vector, grid-strided, and nothing else: x no longer changes. Only the
// steps after a breakdown are inactive, so the copy's few blocks are rare.
__global__ void __launch_bounds__(kThreads)
shard_step_two_nodes_kernel(const float* __restrict__ g, int ranks, int m,
                            int p, const float* __restrict__ v_prev, float* v,
                            float* v_next, const float* __restrict__ alphas,
                            const float* __restrict__ betas,
                            const int* __restrict__ steps,
                            const float* __restrict__ y, int nf, int k,
                            int step, float* x) {
  const PassTwoScalars s = pass_two_scalars(alphas, betas, steps, step);
  const int n = m + p;
  if (!s.active) {
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += gridDim.x * kThreads) {
      v_next[i] = v[i];
      v[i] = v_prev[i];
    }
    return;
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const int e = m + i;
  const float vn = normalise(
      lanczos_update(fold_ranks(g, ranks, p, i), s.beta_prev, v_prev[e],
                     s.alpha, v[e]),
      s.inv_beta);
  v_next[e] = vn;
  for (int f = 0; f < nf; ++f)
    x[f * n + e] = add_rn(x[f * n + e], mul_rn(y[f * k + step + 1], vn));
}

int blocks_of(int count, int per_block = kThreads) {
  return (count + per_block - 1) / per_block;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace
}  // namespace tpl

// g: the gathered (ranks, p) node partials; v_prev, v, w: the step's local
// vectors (m + p each; w[m, m + p) is written); partials: K7's (parts) block
// partials of <v_a, w_a>; state: the step's slot (int32 x 4); scal: the
// step's f32 (4,) scalars. All device pointers; no synchronisation; each
// entry point returns cudaGetLastError().
extern "C" int tpl_shard_step_node_fold(const float* g, int ranks, int m,
                                        int p, const float* v_prev,
                                        const float* v, float* w,
                                        const float* partials, int parts,
                                        const int* state, float* scal,
                                        cudaStream_t stream) {
  tpl::shard_step_node_fold_kernel<<<tpl::kFoldParts, tpl::kThreads, 0,
                                     stream>>>(
      g, ranks, m, p, v_prev, v, w, partials, parts,
      reinterpret_cast<const tpl::ShardStepState*>(state), scal);
  return tpl::launched();
}

// g: the gathered (ranks,) arc parts of alpha; alpha: where alpha_j goes;
// partials receives ceil(m / 256) block partials of <w_a, w_a>.
extern "C" int tpl_shard_step_orthogonalise(const float* g, int ranks, int m,
                                            int p, const float* v, float* w,
                                            float* partials,
                                            const int* state, int k_limit,
                                            float* alpha, const float* scal,
                                            cudaStream_t stream) {
  tpl::shard_step_orthogonalise_kernel<<<tpl::blocks_of(m + p,
                                                         tpl::kQuadBlock),
                                         tpl::kThreads, 0, stream>>>(
      g, ranks, m, m + p, v, w, partials,
      reinterpret_cast<const tpl::ShardStepState*>(state), k_limit, alpha,
      scal);
  return tpl::launched();
}

extern "C" int tpl_shard_step_norm(int m, int p, const float* w,
                                   const float* partials, int parts,
                                   float* scal, cudaStream_t stream) {
  tpl::shard_step_norm_kernel<<<tpl::kFoldParts, tpl::kThreads, 0,
                                stream>>>(
      m, p, w, partials, parts, scal);
  return tpl::launched();
}

// g: the gathered (ranks,) arc parts of beta^2; basis_row: null, or the
// (m + p) row of the one-pass basis; next_state: the slot the next step
// reads; beta: where beta_j goes.
extern "C" int tpl_shard_step_advance(const float* g, int ranks, int m, int p,
                                      const float* v_prev, float* v, float* w,
                                      float* basis_row, const int* state,
                                      int* next_state, int k_limit, float tol,
                                      float* beta, const float* scal,
                                      cudaStream_t stream) {
  tpl::shard_step_advance_kernel<<<tpl::blocks_of(m + p, tpl::kQuadBlock),
                                   tpl::kThreads, 0, stream>>>(
      g, ranks, m + p, v_prev, v, w, basis_row,
      reinterpret_cast<const tpl::ShardStepState*>(state),
      reinterpret_cast<tpl::ShardStepState*>(next_state), k_limit, tol, beta,
      scal);
  return tpl::launched();
}

// Step `step` of pass two after its node fold: g the gathered (ranks, p)
// node partials, the vectors and x (nf, m + p) as for K7's pass-two
// instance.
extern "C" int tpl_shard_step_two_nodes(const float* g, int ranks, int m,
                                        int p, const float* v_prev, float* v,
                                        float* v_next, const float* alphas,
                                        const float* betas, const int* steps,
                                        const float* y, int nf, int k,
                                        int step, float* x,
                                        cudaStream_t stream) {
  tpl::shard_step_two_nodes_kernel<<<tpl::blocks_of(p), tpl::kThreads, 0,
                                     stream>>>(
      g, ranks, m, p, v_prev, v, v_next, alphas, betas, steps, y, nf, k, step,
      x);
  return tpl::launched();
}
