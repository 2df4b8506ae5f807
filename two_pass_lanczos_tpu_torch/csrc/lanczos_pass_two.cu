// K3: Lanczos pass two, basis replay and accumulation of x = sum_j y_j v_j.
//
// Replaces the TPU kernel _pass_two_kernel (two_pass_lanczos_tpu/ops/
// kkt_fused.py:841), and like it runs the whole pass in ONE launch: a
// resident cooperative grid (lanczos_persistent.cuh). It computes no inner
// product: step j (0 <= j < steps_taken - 1) regenerates v_{j+2} from the
// stored alpha_j, beta_{j-1}, beta_j with the same device routines as pass
// one (lanczos_common.cuh), so the basis is bit-identical to pass one's,
// and adds y_{j+1} v_{j+2} to every one of the nf accumulators. As in
// :880-912 of the TPU kernel, steps_taken is read on the device (every
// block reads the same value, so every block runs the same steps), 1/beta_j
// is guarded against beta_j = 0, and x_0 = y_0 v_1 with v_1 = b / ||b||
// from the stored ||b||.
//
// A step is ONE phase and one grid barrier: K1's blocks as virtual blocks,
// and each row i of w = A v, as soon as it is formed, goes through the
// update of element i that the per-step kernel did after the matvec:
//   v_next = (w_i - beta_prev v_prev_i - alpha v_i) * (1/beta);
//   x_f[i] += y_f[j+1] v_next
// v_next overwrites v_prev_i, which no other block reads in the step (the
// matvec gathers v only), and v_prev and v_curr swap roles by pointer. The
// rows keep K1's arithmetic and the update the per-step kernel's, so x and
// the final state are bitwise those of the two launches a step this kernel
// replaced (K1, then the update).
//
// K3 keeps K1's block rows (kkt_node_row, one block a row): one warp a row
// (kkt_node_row_warp, as in K1 and pass one) gave the same bits but was
// slower here on the H100 at every grid tried, 3 to 5 blocks an SM, at the
// headline or at 5M (PERF.md §6).
//
// What bounds it on the H100: per step one matvec, whose node rows gather
// v from all over the 50 MB L2, and the update's stream over v_prev, v and
// the nf accumulators (L2-resident at the headline size), then one grid
// barrier; 499 dependent steps, with no launch between them.
#include "lanczos_persistent.cuh"

namespace tpl {
namespace {

struct PassTwo {
  const float* d;
  const int* u;
  const int* v;
  const int* ptr;
  const int* ent;
  int m, p, n, k, nf, arc_blocks;
  float ztol;
  const float* b;       // (n,)
  const float* alphas;  // (k,)
  const float* betas;   // (k,)
  const float* y;       // (nf, k)
  const float* bnorm;   // (1,)
  const int* steps;     // (1,)
  float* x;             // (nf, n)
  float* vp;
  float* vc;
  PhaseClock clock;     // 4 stamps a step (see the loop), or nullptr
};

__global__ void __launch_bounds__(kThreads)
pass_two_persistent_kernel(PassTwo a) {
  __shared__ float sh[kThreads];
  const CachedLoad ld;
  const int m = a.m, n = a.n, k = a.k;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;

  const float nb = a.bnorm[0];
  const float inv_n = nb <= a.ztol ? 0.0f : lanczos_inverse(nb);
  for (int i = first; i < n; i += stride) {
    const float v1 = normalise(a.b[i], inv_n);
    a.vc[i] = v1;
    a.vp[i] = 0.0f;
    for (int f = 0; f < a.nf; ++f)
      a.x[static_cast<size_t>(f) * n + i] = __fmul_rn(a.y[f * k], v1);
  }
  const int steps = a.steps[0];
  grid_sync();

  // v_prev and v_curr swap roles every step: element i's update writes
  // v_{j+2} over its v_j, which no other block reads in that step
  float* prev = a.vp;
  float* cur = a.vc;
  for (int j = 0; j + 1 < k && j + 1 < steps; ++j) {
    const float alpha = a.alphas[j];
    const float beta_prev = j > 0 ? a.betas[j - 1] : 0.0f;
    const float beta_j = a.betas[j];
    const float inv_b = lanczos_inverse(beta_j > 0.0f ? beta_j : 1.0f);
    a.clock.stamp(j, 0);
    // step_kernel's update of element i, given row i of w = A v
    const auto update = [&](int i, float wi) {
      const float v = ld(cur + i);
      const float vn = normalise(
          lanczos_update(wi, beta_prev, ld(prev + i), alpha, v), inv_b);
      for (int f = 0; f < a.nf; ++f) {
        float* xf = a.x + static_cast<size_t>(f) * n;
        xf[i] = __fadd_rn(ld(xf + i), __fmul_rn(a.y[f * k + j + 1], vn));
      }
      prev[i] = vn;
    };
    // K1's blocks as virtual blocks: this block's share of the node rows
    // (the heavy ones) first, then its share of the arc blocks; each row of
    // A v is updated where it is formed
    const Share nodes = share_of(a.p);
    for (int node = nodes.begin; node < nodes.end; ++node) {
      const float total = kkt_node_row(a.ptr, a.ent, cur, node, sh, ld);
      if (threadIdx.x == 0) update(m + node, total);
    }
    a.clock.stamp(j, 1);
    const Share arcs = share_of(a.arc_blocks);
    for (int ab = arcs.begin; ab < arcs.end; ++ab) {
      const int i = ab * kThreads + threadIdx.x;
      if (i < m)
        update(i, kkt_arc_row(a.d[i], ld(cur + i), ld(cur + m + a.u[i]),
                              ld(cur + m + a.v[i])));
    }
    a.clock.stamp(j, 2);
    grid_sync();
    a.clock.stamp(j, 3);
    float* const t = prev;
    prev = cur;
    cur = t;
  }
  if (cur != a.vc) {  // an odd number of steps: name the state as the caller
    for (int i = first; i < n; i += stride) {
      const float v = ld(a.vp + i);
      a.vp[i] = ld(a.vc + i);
      a.vc[i] = v;
    }
  }
}

}  // namespace
}  // namespace tpl

// All pointers are device pointers except matvec_launches (host). Inputs:
// b (n), alphas, betas (k), y (nf x k, row-major, zero beyond steps_taken,
// scaled by ||b||), bnorm (1), steps (1). Output: x (nf x n). Scratch:
// v_prev, v_curr (n each); on return v_curr holds v_{steps_taken}. clock:
// the phase timer's stamps ((8, grid, 4) int64, tpl::PhaseClock) or nullptr.
// *matvec_launches counts the k - 1 matvec phases of the launch, each gated
// on steps_taken.
// Allocates nothing and does not synchronise; returns the cooperative
// launch's error, if any.
extern "C" int tpl_lanczos_pass_two(
    const float* d, const int* u, const int* v, const int* ptr,
    const int* ent, int m, int p, const float* b, int k, float ztol,
    const float* alphas, const float* betas, const float* y, int nf,
    const float* bnorm, const int* steps, float* x, float* v_prev,
    float* v_curr, long long* clock, int* matvec_launches,
    cudaStream_t stream) {
  *matvec_launches = 0;
  const tpl::PassTwo args{d, u, v, ptr, ent, m, p, m + p, k, nf,
                          (m + tpl::kThreads - 1) / tpl::kThreads, ztol, b,
                          alphas, betas, y, bnorm, steps, x, v_prev, v_curr,
                          tpl::PhaseClock{clock, k / 2, 4}};
  const cudaError_t err = tpl::launch_persistent(
      tpl::pass_two_persistent_kernel, args, stream);
  if (err == cudaSuccess) *matvec_launches = k - 1;
  return static_cast<int>(err);
}

// K3's cooperative grid: resident blocks per SM and SMs.
extern "C" int tpl_lanczos_pass_two_grid(int* blocks_per_sm, int* sms) {
  return static_cast<int>(tpl::persistent_grid(
      tpl::pass_two_persistent_kernel, blocks_per_sm, sms));
}
