// The fused Lanczos step of the arc-sharded f32 solver on a card
// (parallel/sharded_step.py), shared by K7's step instances
// (kkt_shard_matvec.cu) and the kernels that run after each fold
// (shard_step.cu).
//
// A step of pass one on a rank is K7's pass-one instance, then three folds,
// each an NCCL all-gather, each followed by one small kernel:
//   K7    y = A_shard v; the arc blocks go on to w_a = y_a -
//         beta_prev v_prev_a and the fixed-order block partials of
//         <v_a, w_a>; the node blocks write the shard's node partial s
//   fold  s, gathered (D, p)
//   node_fold     y_n = s_0 + s_1 + ... in rank order, w_n = y_n -
//                 beta_prev v_prev_n, and 16 blocks' shares of <v_n, w_n>
//                 and of the sum of K7's partials (this rank's alpha part)
//   fold  alpha's arc parts, gathered (D, 16)
//   orthogonalise alpha = fold + <v_n, w_n>, w -= alpha v over the whole
//                 local vector, block partials of <w_a, w_a>
//   norm          16 blocks' shares of beta^2's arc part and <w_n, w_n>
//   fold  beta^2's arc parts, gathered (D, 16)
//   advance       beta = sqrt(fold + <w_n, w_n>), the breakdown test,
//                 v_next = w (1/beta), the masked state, alpha_j, beta_j
// A step of pass two is K7's pass-two instance (the whole arc update from
// the stored alpha_j, beta_j and x_a += y_{j+1} v_next_a), one node fold,
// and two_nodes (the node rows' update and x_n).
//
// The vectors rotate through three buffers that the host names per step:
// step j reads v_prev from buffer j % 3 and v from (j + 1) % 3 and writes w,
// then v_next, into (j + 2) % 3, so no launch overwrites a vector that its
// own node blocks still gather. A step that does not advance copies the
// state one buffer on (advance, two_nodes), so the host's rotation holds
// the masked state. The scalar state alternates between two slots, step j
// reading slot j % 2 and writing (j + 1) % 2: no block reads what another
// block of its launch writes.
//
// Every vector operation is a routine of lanczos_common.cuh, so that given
// the same alpha and beta the vectors round as the per-operation PyTorch
// recurrence (algorithms/core.py) rounds them; only the dots' order is new:
// a fixed tree of block partials, folded in rank order. No atomics.
#pragma once

#include "lanczos_common.cuh"

namespace tpl {

// One slot of pass one's scalar state, 16 bytes (an int32 (2, 4) tensor on
// the host, the floats by their bits).
struct ShardStepState {
  float beta_prev;
  int done;   // a breakdown or a zero b
  int steps;  // steps executed
  float b_norm;
};

// The step's scalars between its kernels (an f32 (4 * kFoldParts,)
// tensor): node_fold and norm run kFoldParts blocks, and each block leaves
// its share of each sum in its slot of a group; an arc group is gathered
// whole, as a (D, kFoldParts) buffer.
constexpr int kFoldParts = 16;
enum ShardStepScalar : int {
  kAlphaArc = 0,                // this rank's <v_a, w_a>, gathered
  kNodeDot = kFoldParts,        // <v_n, w_n>
  kBeta2Arc = 2 * kFoldParts,   // this rank's <w_a, w_a>, gathered
  kNodeBeta2 = 3 * kFoldParts,  // <w_n, w_n>
};

// The sum of a group's kFoldParts shares, in order.
__device__ __forceinline__ float sum_parts(const float* q) {
  float acc = q[0];
  for (int c = 1; c < kFoldParts; ++c) acc = add_rn(acc, q[c]);
  return acc;
}

// A dot of the whole local vector from its gathered (ranks, kFoldParts)
// arc shares and its node shares: each rank's arc part summed, the parts
// folded in rank order, ((a_0 + a_1) + a_2) + ..., as
// parallel/comm.gather_fold folds them, then the node part added.
__device__ __forceinline__ float fold_dot(const float* g, int ranks,
                                          const float* node) {
  float acc = sum_parts(g);
  for (int r = 1; r < ranks; ++r)
    acc = add_rn(acc, sum_parts(&g[r * kFoldParts]));
  return add_rn(acc, sum_parts(node));
}

// Element i of the rank-ordered fold of the gathered (ranks, p) node
// partials: ((g_0 + g_1) + g_2) + ..., gather_fold's bits.
__device__ __forceinline__ float fold_ranks(const float* g, int ranks, int p,
                                            int i) {
  float acc = g[i];
  for (int r = 1; r < ranks; ++r) acc = add_rn(acc, g[r * p + i]);
  return acc;
}

// Whether a step of pass one executes: not done and under the step limit.
__device__ __forceinline__ bool step_executes(const ShardStepState* st,
                                              int k_limit) {
  return !st->done && st->steps < k_limit;
}

// The scalars of step `step` of pass two (core.pass_two_scan's): it is
// active while step < steps_taken - 1; 1/beta_j is taken of a positive
// beta_j only, and is 0 on an inactive step.
struct PassTwoScalars {
  float alpha;
  float beta_prev;
  float inv_beta;
  bool active;
};

__device__ __forceinline__ PassTwoScalars pass_two_scalars(
    const float* alphas, const float* betas, const int* steps, int step) {
  PassTwoScalars s;
  const float beta = betas[step];
  s.alpha = alphas[step];
  s.beta_prev = step > 0 ? betas[step - 1] : 0.0f;
  s.active = step < *steps - 1;
  s.inv_beta = s.active ? lanczos_inverse(beta > 0.0f ? beta : 1.0f) : 0.0f;
  return s;
}

}  // namespace tpl
