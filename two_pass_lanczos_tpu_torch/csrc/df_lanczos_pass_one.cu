// K9: Lanczos pass one in double-float, scalars only.
//
// Replaces _df_pass_one_kernel (two_pass_lanczos_tpu/ops/kkt_fused_df.py:381,
// launched by _raw_p1 :837). The TPU ran all k steps in one launch with the
// hi/lo state of both arc orderings in VMEM. So does K9 on the H100:
// df_pass_one_persistent_kernel runs the start from b and all k steps in
// ONE cooperative launch (lanczos_persistent.cuh), on the pattern of K2's
// pass_one_persistent_kernel (lanczos_pass_one.cu). Its working vectors
// (w's two halves, v_prev, v_curr) are (hi, lo) pairs (df_common.cuh), so
// every element is one 8-byte access and every gathered entry one L2
// sector; b comes in and the final state goes out in planes. A step has
// the two grid barriers its two dots need, and no launch:
//   phase 1  the node rows of w = A v (K11's df_kkt_node_row), each
//            published by a release store; then the first dot's virtual
//            blocks: an arc element rotates (v_prev = v; v = w_last (x)
//            1/beta, the previous step's rotate) and forms its arc row
//            (K11's df_kkt_arc_row), a node element waits for its
//            published row; w -= beta_prev v_prev; <v, w> joins the df
//            partial
//   phase 2  every block folds alpha (df_fold_partials); w -= alpha v;
//            df partials of <w, w>
//   then     every block folds beta (df_scalar_sqrt), takes the breakdown
//            decision and 1/beta (df_scalar_recip)
// The matvec gathers v as df_scale(w_last, 1/beta) (DFPairScaledLoad) from
// the other half of a two-half w (step 0: b's pairs, stored there in the
// start), so no block writes what another gathers. The
// dots walk the g = reduction_blocks(n) virtual blocks of the per-step
// launches below and fold their df partials with the same
// df_fold_partials, so alpha and beta (hi and lo), ||b||, steps and the
// final v_prev, v_curr pairs are bitwise those of the per-step launches.
// alpha and beta stay in registers; every block takes the same breakdown
// decision from the same folded beta, so all blocks leave the loop
// together (a block that left alone would deadlock the next barrier).
//
// The per-step launches it replaced stay, on the planes and the planar
// K11, as the reference that chip_smoke.py and the card tests hold it to
// bit for bit (tpl_df_lanczos_pass_one_steps; no solve reaches it): the
// pairs change where values lie, not one rounding. Each step is a fixed
// sequence of launches that one C++
// routine (enqueue_step) enqueues on the caller's stream with no host
// synchronisation:
//   1. the K11 df matvec           w = A v
//   2. df_sub_dot                  w -= beta_prev*v_prev; partials of <v,w>
//   3. df_finalize_alpha (1 block) alpha = df fold of the partials
//   4. df_sub_dot                  w -= alpha*v;          partials of <w,w>
//   5. df_finalize_beta (1 block)  beta = df_sqrt(fold); breakdown; steps
//   6. df_rotate                   v_prev = v; v = w * df_recip(beta)
// Each thread folds exact products with their cross terms (df_prod,
// df_square) into a df pair with df_add2, each block folds its threads with
// block_sum2 into one df partial (hi plane and lo plane of the partials
// scratch), and one block folds the partials: a fixed order that depends on
// n only. The step mirrors :418-475: breakdown when beta_hi <= 1000*2^-49
// (DF_BREAKDOWN_TOL) clears the live flag on the device and every later
// launch returns at once; the step that breaks down counts and writes alpha
// but not beta. A zero b (||b||_hi <= 1000*tiny) starts with the flag
// cleared: 0 steps.
//
// What bounds it on the H100: per step the df matvec plus three passes over
// the n-pair vectors, ~24 MB of L2 traffic at the headline with the whole
// state (12 MB of vectors, 4 MB of d, 6 MB of layout) L2-resident, so like
// K2 a step is bound by the L2, by the node rows' scattered x_a gathers (one
// sector an entry on pairs, two on planes) and by its two grid barriers,
// over 500 dependent steps. The df arithmetic is ~10x K2's f32 operations
// per element, still far below the card's f32 rate; every df value is a
// pair, so a thread holds twice K2's registers (hence the df passes' own
// cap, kDFPersistentBlocksPerSM).
#include <cstddef>

#include "df_common.cuh"
#include "lanczos_persistent.cuh"

namespace tpl {
namespace {

// scal: [0..1] beta_prev (hi, lo), [2..3] alpha, [4..5] 1/beta or 1/||b||.
// flags[0] = live (1 until a breakdown or a zero b).
// coeffs (4, k): rows alpha_hi, alpha_lo, beta_hi, beta_lo.

// Block total of the threads' df sums, stored by thread 0 as the partial of
// block `slot` (hi in plane 0, lo in plane 1).
__device__ __forceinline__ void store_df_partial(float2 acc, float* sh,
                                                 float* sl, float* partials,
                                                 int slot) {
  const float2 s = block_sum2(acc, sh, sl);
  if (threadIdx.x == 0) {
    partials[slot] = s.x;
    partials[kMaxPartials + slot] = s.y;
  }
}

__global__ void __launch_bounds__(kThreads)
df_sq_partials_kernel(const float* __restrict__ b2, int n,
                      float* __restrict__ partials) {
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  float2 acc = make_float2(0.0f, 0.0f);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float2 sq = df_square(b2[i], b2[n + i]);
    acc = df_add2(acc.x, acc.y, sq.x, sq.y);
  }
  store_df_partial(acc, sh, sl, partials, blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
df_init_kernel(const float* __restrict__ partials, int g, float ztol, int k,
               float* __restrict__ coeffs, float* __restrict__ bnorm2,
               int* __restrict__ steps, float* __restrict__ scal,
               int* __restrict__ flags) {
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  for (int i = threadIdx.x; i < 4 * k; i += kThreads) coeffs[i] = 0.0f;
  const float2 nb2 = df_fold_partials(partials, g, sh, sl);
  if (threadIdx.x == 0) {
    const float2 nb = df_scalar_sqrt(nb2.x, nb2.y);
    const bool zero_b = nb.x <= ztol;
    const float2 inv = df_scalar_recip(zero_b ? 1.0f : nb.x, nb.y);
    bnorm2[0] = nb.x;
    bnorm2[1] = nb.y;
    steps[0] = 0;
    scal[0] = 0.0f;
    scal[1] = 0.0f;
    scal[4] = zero_b ? 0.0f : inv.x;
    scal[5] = zero_b ? 0.0f : inv.y;
    flags[0] = zero_b ? 0 : 1;
  }
}

// v_curr = b * (1/||b||), v_prev = 0.
__global__ void __launch_bounds__(kThreads)
df_init_vectors_kernel(const float* __restrict__ b2, int n,
                       const float* __restrict__ scal, float* __restrict__ vp2,
                       float* __restrict__ vc2) {
  const float ih = scal[4];
  const float il = scal[5];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float2 v1 = df_scale(b2[i], b2[n + i], ih, il);
    vc2[i] = v1.x;
    vc2[n + i] = v1.y;
    vp2[i] = 0.0f;
    vp2[n + i] = 0.0f;
  }
}

// w -= (coef[0], coef[1]) * x; partials of <partner, w> (partner == nullptr:
// <w, w>).
__global__ void __launch_bounds__(kThreads)
df_sub_dot_kernel(float* __restrict__ w2, const float* __restrict__ x2,
                  const float* __restrict__ coef,
                  const float* __restrict__ partner2, int n,
                  float* __restrict__ partials,
                  const int* __restrict__ flags) {
  if (flags[0] == 0) return;
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  const float ch = coef[0];
  const float cl = coef[1];
  float2 acc = make_float2(0.0f, 0.0f);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float2 wi = df_axpy(w2[i], w2[n + i], ch, cl, x2[i], x2[n + i]);
    w2[i] = wi.x;
    w2[n + i] = wi.y;
    const float2 pr = partner2 != nullptr
                          ? df_prod(partner2[i], partner2[n + i], wi.x, wi.y)
                          : df_square(wi.x, wi.y);
    acc = df_add2(acc.x, acc.y, pr.x, pr.y);
  }
  store_df_partial(acc, sh, sl, partials, blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
df_finalize_alpha_kernel(const float* __restrict__ partials, int g, int j,
                         int k, float* __restrict__ coeffs,
                         float* __restrict__ scal,
                         const int* __restrict__ flags) {
  if (flags[0] == 0) return;
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  const float2 alpha = df_fold_partials(partials, g, sh, sl);
  if (threadIdx.x == 0) {
    scal[2] = alpha.x;
    scal[3] = alpha.y;
    coeffs[j] = alpha.x;
    coeffs[k + j] = alpha.y;
  }
}

__global__ void __launch_bounds__(kThreads)
df_finalize_beta_kernel(const float* __restrict__ partials, int g, int j,
                        int k, float tol, float* __restrict__ coeffs,
                        int* __restrict__ steps, float* __restrict__ scal,
                        int* __restrict__ flags) {
  if (flags[0] == 0) return;
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  const float2 beta2 = df_fold_partials(partials, g, sh, sl);
  if (threadIdx.x == 0) {
    const float2 beta = df_scalar_sqrt(beta2.x, beta2.y);
    steps[0] += 1;
    if (beta.x <= tol) {
      flags[0] = 0;  // breakdown: this step counts, nothing advances
    } else {
      const float2 inv = df_scalar_recip(beta.x, beta.y);
      coeffs[2 * k + j] = beta.x;
      coeffs[3 * k + j] = beta.y;
      scal[0] = beta.x;
      scal[1] = beta.y;
      scal[4] = inv.x;
      scal[5] = inv.y;
    }
  }
}

// v_prev = v_curr; v_curr = w * (1/beta).
__global__ void __launch_bounds__(kThreads)
df_rotate_kernel(const float* __restrict__ w2, float* __restrict__ vp2,
                 float* __restrict__ vc2, int n,
                 const float* __restrict__ scal,
                 const int* __restrict__ flags) {
  if (flags[0] == 0) return;
  const float ih = scal[4];
  const float il = scal[5];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float2 vn = df_scale(w2[i], w2[n + i], ih, il);
    vp2[i] = vc2[i];
    vp2[n + i] = vc2[n + i];
    vc2[i] = vn.x;
    vc2[n + i] = vn.y;
  }
}

// Everything one df pass-one run touches; see the entry points for sizes.
struct DFPassOne {
  const float* d2;
  const int* u;
  const int* v;
  const int* ptr;
  const int* ent;
  int m, p, n, k;
  float tol, ztol;
  float* coeffs;
  float* bnorm2;
  int* steps;
  float* vp2;
  float* vc2;
  float* w2;
  float* partials;
  float* scal;  // the per-step launches only
  int* flags;
};

// K9's one launch: the start and k steps of the per-step launches, on one
// resident grid (see the top of the file). Clock is PhaseClock (6 stamps a
// step, see the loop) or NoClock (every solve). It works on pairs
// (df_common.cuh): w's two halves and v_prev, v_curr; s.vp2 and s.vc2 get
// the final state in planes.
template <typename Clock>
struct DFPersistent {
  DFPassOne s;
  const float* b2;
  int g;  // reduction_blocks(n): the dots' virtual blocks
  float2* w;  // (2, n) pairs: this step's w in one half, the last's in the
              // other
  float2* v;  // (2, n) pairs: v_prev, v_curr
  Clock clock;
};

// Virtual blocks [0, g) of a df reduction of stride g * kThreads: virtual
// block vb folds body(acc, i) over the elements that block vb of
// df_sub_dot_kernel (or df_sq_partials_kernel) walks, in the same order,
// and stores its df partial at vb.
template <typename Body>
__device__ __forceinline__ void df_reduce_phase(int g, int n, float* partials,
                                                float* sh, float* sl,
                                                Body body) {
  const Share mine = share_of(g);
  for (int vb = mine.begin; vb < mine.end; ++vb) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int i = vb * kThreads + threadIdx.x; i < n; i += g * kThreads)
      acc = body(acc, i);
    store_df_partial(acc, sh, sl, partials, vb);
  }
}

template <typename Clock>
__global__ void __launch_bounds__(kThreads, kDFPersistentBlocksPerSM)
df_pass_one_persistent_kernel(DFPersistent<Clock> a) {
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  const DFPassOne& s = a.s;
  const CachedLoad ld;
  const int m = s.m, n = s.n, k = s.k, g = a.g;
  float2* const vp = a.v;
  float2* const vc = a.v + n;
  int* const ready = s.flags + 1;  // p: the step whose node row is in w
  // alpha's partials in pa, ||b||^2's and beta's in pb, each a hi and a lo
  // plane: a block may start the beta dot while another still folds
  // alpha's, and step 0 may store its first partials while another block
  // still folds ||b||^2
  float* const pa = s.partials;
  float* const pb = s.partials + 2 * kMaxPartials;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const float2 zero = make_float2(0.0f, 0.0f);

  // the start: df_sq_partials_kernel, df_init_kernel, df_init_vectors_kernel;
  // b's pairs go to w's second half, which step 0 gathers
  float2* const bp = a.w + n;
  df_reduce_phase(g, n, pb, sh, sl, [&](float2 acc, int i) {
    const float bh = a.b2[i], bl = a.b2[n + i];
    bp[i] = make_float2(bh, bl);
    const float2 sq = df_square(bh, bl);
    return df_add2(acc.x, acc.y, sq.x, sq.y);
  });
  for (int i = first; i < 4 * k; i += stride) s.coeffs[i] = 0.0f;
  for (int i = first; i < s.p; i += stride) ready[i] = 0;
  grid_sync();
  const float2 nb2 = df_fold_partials(pb, g, sh, sl, ld);
  const float2 nb = df_scalar_sqrt(nb2.x, nb2.y);
  const bool zero_b = nb.x <= s.ztol;
  float2 inv = zero_b ? zero : df_scalar_recip(nb.x, nb.y);
  for (int i = first; i < n; i += stride) {
    vc[i] = df_scale(a.b2[i], a.b2[n + i], inv.x, inv.y);
    vp[i] = zero;
  }
  // no barrier: before its first barrier, step 0 reads b's pairs, not
  // v_prev or v_curr

  float2 beta_prev = zero, alpha = zero;
  int steps = 0;
  bool live = !zero_b;
  const float2* src = bp;  // this step's v is src (x) inv
  for (int j = 0; live && j < k; ++j) {
    // step 0's v = b (x) 1/||b|| is already in v_curr; a later step's v is
    // w (x) 1/beta_prev, and the step does the previous step's rotate
    // (df_rotate_kernel) element by element, where it first reads the
    // element
    const bool rotate = j > 0;
    const DFPairScaledLoad vld{src, inv.x, inv.y};
    float2* const wn = a.w + (j & 1) * n;  // src is the other half
    a.clock.stamp(j, 0);
    // 1. one phase for w = A v and the first df_sub_dot. First this block's
    //    node rows (K11's node blocks, gathering v from src): thread 0
    //    rotates the node's element, leaves the row in wn and publishes it
    const Share nodes = share_of(s.p);
    for (int node = nodes.begin; node < nodes.end; ++node) {
      const float2 total = df_kkt_node_row(s.ptr, s.ent, node, sh, sl, vld);
      if (threadIdx.x == 0) {
        const int i = m + node;
        if (rotate) {
          vp[i] = __ldca(vc + i);
          vc[i] = vld(i);
        }
        wn[i] = total;
        publish(ready + node, j + 1);
      }
    }
    a.clock.stamp(j, 1);
    //    Then its share of the dot's virtual blocks, in df_sub_dot's order:
    //    an arc element rotates and forms its row (K11's arc row, x_n
    //    gathered from src), a node element waits for its row; then
    //    w -= beta_prev v_prev, and v (x) w joins the sum. A block waits
    //    only after its own node rows, so every awaited row is being
    //    computed: no deadlock.
    df_reduce_phase(g, n, pa, sh, sl, [&](float2 acc, int i) {
      float2 y, vpi, vci;
      if (i < m) {
        vci = vld(i);
        vpi = rotate ? __ldca(vc + i) : zero;
        if (rotate) {
          vp[i] = vpi;
          vc[i] = vci;
        }
        const float2 gu = vld(m + s.u[i]);
        const float2 gv = vld(m + s.v[i]);
        y = df_kkt_arc_row(s.d2[i], s.d2[m + i], vci.x, vci.y, gu.x, gu.y,
                           gv.x, gv.y);
      } else {
        wait_for(ready + (i - m), j + 1);
        vpi = rotate ? __ldca(vp + i) : zero;
        vci = rotate ? __ldca(vc + i) : vld(i);
        y = __ldca(wn + i);
      }
      const float2 wi = df_axpy(y.x, y.y, beta_prev.x, beta_prev.y, vpi.x,
                                vpi.y);
      wn[i] = wi;
      const float2 pr = df_prod(vci.x, vci.y, wi.x, wi.y);
      return df_add2(acc.x, acc.y, pr.x, pr.y);
    });
    a.clock.stamp(j, 2);
    grid_sync();
    a.clock.stamp(j, 3);
    // 2. every block folds alpha (df_finalize_alpha_kernel); the second
    //    df_sub_dot
    alpha = df_fold_partials(pa, g, sh, sl, ld);
    if (lead) {
      s.coeffs[j] = alpha.x;
      s.coeffs[k + j] = alpha.y;
    }
    df_reduce_phase(g, n, pb, sh, sl, [&](float2 acc, int i) {
      const float2 wo = __ldca(wn + i);
      const float2 vci = __ldca(vc + i);
      const float2 wi = df_axpy(wo.x, wo.y, alpha.x, alpha.y, vci.x, vci.y);
      wn[i] = wi;
      const float2 sq = df_square(wi.x, wi.y);
      return df_add2(acc.x, acc.y, sq.x, sq.y);
    });
    a.clock.stamp(j, 4);
    grid_sync();
    a.clock.stamp(j, 5);
    // 3. every block folds beta (df_finalize_beta_kernel) and takes the
    //    same breakdown decision
    const float2 beta2 = df_fold_partials(pb, g, sh, sl, ld);
    const float2 beta = df_scalar_sqrt(beta2.x, beta2.y);
    steps = j + 1;
    if (beta.x <= s.tol) {  // breakdown: this step counts, nothing advances
      live = false;
      break;
    }
    if (lead) {
      s.coeffs[2 * k + j] = beta.x;
      s.coeffs[3 * k + j] = beta.y;
    }
    beta_prev = beta;
    inv = df_scalar_recip(beta.x, beta.y);
    src = wn;
  }
  // the state in planes, as the per-step launches leave it: after the last
  // step's rotate (df_rotate_kernel) while live, else as the loop left it
  const DFPairScaledLoad last{src, inv.x, inv.y};
  for (int i = first; i < n; i += stride) {
    const float2 vci = __ldca(vc + i);
    const float2 vpo = live ? vci : __ldca(vp + i);
    const float2 vco = live ? last(i) : vci;
    s.vp2[i] = vpo.x;
    s.vp2[n + i] = vpo.y;
    s.vc2[i] = vco.x;
    s.vc2[n + i] = vco.y;
  }
  if (lead) {  // the outputs the per-step launches leave behind
    s.bnorm2[0] = nb.x;
    s.bnorm2[1] = nb.y;
    s.steps[0] = steps;
    s.flags[0] = live ? 1 : 0;
  }
}

// K9's cooperative launch, built with the phase timer or without it.
template <typename Clock>
cudaError_t launch_pass_one(const DFPassOne& s, const float* b2, float* pairs,
                            Clock clock, cudaStream_t stream) {
  return launch_persistent(
      df_pass_one_persistent_kernel<Clock>,
      DFPersistent<Clock>{s, b2, reduction_blocks(s.n),
                          reinterpret_cast<float2*>(s.w2),
                          reinterpret_cast<float2*>(pairs), clock},
      stream, kDFPersistentBlocksPerSM);
}

cudaError_t enqueue_start(const DFPassOne& s, const float* b2,
                          cudaStream_t stream) {
  const int g = reduction_blocks(s.n);
  df_sq_partials_kernel<<<g, kThreads, 0, stream>>>(b2, s.n, s.partials);
  df_init_kernel<<<1, kThreads, 0, stream>>>(s.partials, g, s.ztol, s.k,
                                             s.coeffs, s.bnorm2, s.steps,
                                             s.scal, s.flags);
  df_init_vectors_kernel<<<df_elementwise_blocks(s.n), kThreads, 0,
                           stream>>>(b2, s.n, s.scal, s.vp2, s.vc2);
  return cudaGetLastError();
}

// The six launches of step j (see the top of the file).
cudaError_t enqueue_step(const DFPassOne& s, int j, int* matvec_launches,
                         cudaStream_t stream) {
  const int g = reduction_blocks(s.n);
  cudaError_t err = launch_df_kkt_matvec(s.d2, s.u, s.v, s.ptr, s.ent, s.m,
                                         s.p, s.vc2, s.w2, s.flags, 0, stream);
  if (err != cudaSuccess) return err;
  *matvec_launches += 1;
  df_sub_dot_kernel<<<g, kThreads, 0, stream>>>(
      s.w2, s.vp2, s.scal + 0, s.vc2, s.n, s.partials, s.flags);
  df_finalize_alpha_kernel<<<1, kThreads, 0, stream>>>(
      s.partials, g, j, s.k, s.coeffs, s.scal, s.flags);
  df_sub_dot_kernel<<<g, kThreads, 0, stream>>>(
      s.w2, s.vc2, s.scal + 2, nullptr, s.n, s.partials, s.flags);
  df_finalize_beta_kernel<<<1, kThreads, 0, stream>>>(
      s.partials, g, j, s.k, s.tol, s.coeffs, s.steps, s.scal, s.flags);
  df_rotate_kernel<<<df_elementwise_blocks(s.n), kThreads, 0, stream>>>(
      s.w2, s.vp2, s.vc2, s.n, s.scal, s.flags);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpl

// All pointers are device pointers except matvec_launches (host). Common
// arguments: the layout (d2 (2 x m) hi/lo costs, u, v, ptr, ent; m arcs,
// p nodes, n = m + p), b2 (2 x n), k, the breakdown and zero-b tolerances.
// Outputs: coeffs (4 x k: alpha hi, alpha lo, beta hi, beta lo), bnorm2
// (2: ||b|| hi, lo), steps (1). Scratch: v_prev2, v_curr2 (2 x n each); on
// return they hold the state after the last step. Each entry point
// allocates nothing and does not synchronise; it returns the error of its
// launches.

// K9: one cooperative launch, on pairs inside. Scratch besides: w2 (2 x n
// pairs: two halves), pairs (2 x n pairs: v_prev, v_curr), partials (4 *
// tpl::kMaxPartials: alpha's hi and lo planes, then beta's), flags (1 + p
// ints). clock: the phase timer's stamps ((8, grid, 6) int64,
// tpl::PhaseClock), or nullptr (every solve: the build without the timer).
// *matvec_launches counts the k matvec phases inside the launch.
extern "C" int tpl_df_lanczos_pass_one(
    const float* d2, const int* u, const int* v, const int* ptr,
    const int* ent, int m, int p, const float* b2, int k, float tol,
    float ztol, float* coeffs, float* bnorm2, int* steps, float* v_prev2,
    float* v_curr2, float* w2, float* pairs, float* partials, int* flags,
    long long* clock, int* matvec_launches, cudaStream_t stream) {
  *matvec_launches = 0;
  const tpl::DFPassOne s{d2,     u,       v,       ptr,     ent,      m,
                         p,      m + p,   k,       tol,     ztol,     coeffs,
                         bnorm2, steps,   v_prev2, v_curr2, w2,       partials,
                         nullptr, flags};
  const cudaError_t err =
      clock == nullptr
          ? tpl::launch_pass_one(s, b2, pairs, tpl::NoClock{}, stream)
          : tpl::launch_pass_one(s, b2, pairs,
                                 tpl::PhaseClock{clock, k / 2, 6}, stream);
  if (err == cudaSuccess) *matvec_launches = k;
  return static_cast<int>(err);
}

// K9's cooperative grid: resident blocks per SM and SMs (the build with the
// timer runs on the same grid: both reach kDFPersistentBlocksPerSM).
extern "C" int tpl_df_lanczos_pass_one_grid(int* blocks_per_sm, int* sms) {
  return static_cast<int>(tpl::persistent_grid(
      tpl::df_pass_one_persistent_kernel<tpl::NoClock>, blocks_per_sm, sms,
      tpl::kDFPersistentBlocksPerSM));
}

// The per-step launches K9 replaced (see the top of the file), the
// reference K9 is held to; no solve calls it. Scratch besides: w2 (2 x n),
// partials (2 * tpl::kMaxPartials), scal (6 floats), flags (1 int).
// *matvec_launches counts its k K11 launches.
extern "C" int tpl_df_lanczos_pass_one_steps(
    const float* d2, const int* u, const int* v, const int* ptr,
    const int* ent, int m, int p, const float* b2, int k, float tol,
    float ztol, float* coeffs, float* bnorm2, int* steps, float* v_prev2,
    float* v_curr2, float* w2, float* partials, float* scal, int* flags,
    int* matvec_launches, cudaStream_t stream) {
  const tpl::DFPassOne s{d2,   u,      v,     ptr,     ent,     m,
                         p,    m + p,  k,     tol,     ztol,    coeffs,
                         bnorm2, steps, v_prev2, v_curr2, w2,    partials,
                         scal, flags};
  *matvec_launches = 0;
  cudaError_t err = tpl::enqueue_start(s, b2, stream);
  for (int j = 0; j < k && err == cudaSuccess; ++j)
    err = tpl::enqueue_step(s, j, matvec_launches, stream);
  return static_cast<int>(err);
}
