// Lanczos pass one: K2 (scalars only), K4 (with the basis), K5 (resumable
// chunks), each with a compensated instance (K6).
//
// Replaces the TPU kernels _pass_one_kernel (two_pass_lanczos_tpu/ops/
// kkt_fused.py:581), _pass_one_basis_kernel (:752) and
// _pass_one_chunk_kernel (:647), and their comp=True builds (:567). The TPU
// ran all k steps inside one launch with the whole state in VMEM.
//
// K2, K4 and K5 do the same on the H100: each is ONE cooperative
// launch of pass_one_persistent_kernel (lanczos_persistent.cuh), an
// instance of one template, that runs the start from b and the steps; K6
// is their compensated instances (Comp), chosen by the entry points' comp. A
// step has the two grid barriers its two dots need, and no launch:
//   phase 1  the node rows of w = A v, one warp a row (kkt_node_row_warp,
//            dealt by row_share), each published by a release store; the
//            block's other warps start the first dot's virtual blocks at
//            once, with no block barrier before its first block_sum: an arc
//            element rotates (v_prev = v; v = w_last * (1/beta), the
//            previous step's rotate) and forms its arc row, a node element
//            waits for its published row; w -= beta_prev * v_prev; partials
//            of <v, w>. A row warp computes its row before it enters the
//            dot, and every block is resident (a cooperative launch), so
//            every awaited row is in progress: no deadlock
//   phase 2  every block folds the alpha partials; w -= alpha * v;
//            partials of <w, w>
//   then     every block folds the beta partials (breakdown, steps)
// The matvec gathers v as w_last * (1/beta) (ScaledLoad) from the other
// half of a two-half w, so no block writes what another gathers. The dots
// walk the g = reduction_blocks(n) virtual blocks of the per-step launches
// below and fold their partials with the same fold_partials, so alpha,
// beta, steps, ||b||, the final v_prev, v_curr and K4's basis rows are
// bitwise those of the per-step launches on any grid. alpha and beta stay
// in registers; every block takes the same breakdown decision from the
// same folded beta, so all blocks leave the loop together (a block that
// left alone would deadlock the next barrier). The instances differ only
// in what the template adds:
//   K2 tpl_lanczos_pass_one        the start from b, then steps 0..k-1;
//   K4 tpl_lanczos_pass_one_basis  the same, and row j of a (k, n) basis is
//      v_{j+1}: row 0 is stored by the start, row j by step j's phase 1,
//      where the rotate of step j - 1 first forms each element (arcs in
//      the dot's body, nodes by lane 0 of the row's warp). A step that
//      does not advance stores nothing, so the caller must pass a zeroed
//      basis. The
//      rows (2 MB a step, 1 GB at k = 500) go to HBM with streaming stores
//      (st.global.cs), so that they do not evict the L2-resident working
//      set;
//   K5 tpl_lanczos_pass_one_chunk  steps j0..j0+count-1 on state that the
//      caller keeps between calls: v_prev and v_curr already rotated,
//      scal[0] = beta_prev, flags[0] = live, steps, bnorm, the node-row
//      tags (flags + 1) and the two-half w. The start from b runs only
//      when j0 == 0; a resumed chunk's first step does no rotate, reads
//      the carried v_prev and beta_prev, and gathers v from v_curr itself
//      (ScaledLoad{1}: x * 1 is exact). The tags are the global j + 1 and
//      rise across chunks; a chunk that starts after a breakdown returns
//      at once in every block. Each chunk ends as K2 ends: with the last
//      step's rotate. Only scal[2] (1/beta) may differ from the per-step
//      launches, after a breakdown in a resumed chunk's first step, where
//      nothing reads it again;
//   K6 Comp, the compensated instance of each of the three: only the
//      reductions (the start's ||b||^2 and the two dots) change, each
//      thread folding exact products (two_prod) into a two-float pair with
//      df_add2, the block tree and the fold doing the same, the result
//      hi + lo. A block partial is then a pair, hi at slot and lo at
//      kMaxPartials + slot, so the two dots' partials take four planes:
//      <v, w>'s hi and lo, then ||b||^2's and <w, w>'s.
//
// The per-step launches they replaced have one entry point,
// tpl_lanczos_pass_one_steps, which no solve reaches: the reference that
// chip_smoke.py and the card tests hold K2, K4 and K5 to (comp == 0) and
// their compensated instances (comp != 0) bit for bit. Each step
// is a short, fixed sequence of launches that one C++ routine
// (enqueue_step) enqueues on the caller's stream, with no host
// synchronisation:
//   1. the K1 matvec               w = A v
//   2. sub_dot                     w -= beta_prev * v_prev; partials of <v,w>
//   3. finalize_alpha (1 block)    alpha = fold(partials)
//   4. sub_dot                     w -= alpha * v;          partials of <w,w>
//   5. finalize_beta (1 block)     beta = sqrt(fold); breakdown; steps
//   6. rotate                      v_prev = v; v = w * (1/beta); basis row
// alpha, beta, the live flag and steps_taken stay on the device. Breakdown
// (beta <= 1000 eps) clears the live flag and every later launch returns at
// once: the masked fixed-length loop of algorithms/core.py, where the last
// executed step still counts and writes alpha but not beta. A zero b
// (||b|| <= 1000 tiny) starts with the flag cleared: 0 steps. The same
// routine runs steps [j0, j0 + count) with or without basis rows, so one
// entry point is the per-step form of all three persistent instances.
// With comp != 0 they change only the reductions of steps 2, 4 and of
// ||b||, as K6 does, through the same accumulate, store_partial and
// fold_partials.
//
// What bounds it on the H100: each step moves ~30 MB through the 50 MB L2
// (the matvec plus three passes over the (n,) vectors), so at the headline
// size a step is bound by the L2, by the node rows' scattered x_a gathers
// and by its synchronisation: two grid barriers in the persistent kernel,
// six launches of a few microseconds each on the per-step path, over 500
// dependent steps. K4 adds a 2 MB store per step that leaves the L2 for
// HBM (1 GB at k = 500, 0.6 us a step at 3.35 TB/s). K6's compensated
// reductions add operations (a df_add2 of 11 flops and a two_prod per
// element of each dot), not bytes: its step has the same two barriers.
#include <cstddef>

#include "lanczos_persistent.cuh"

namespace tpl {
namespace {

// The persistent pass one's resident blocks per SM, at most, and the
// minimum its build is held to (__launch_bounds__), so that every instance
// reaches it (at most 64 registers a thread). With the warp rows, 4 was
// faster on the H100 than 3, 5 or more, at the headline and at 5M
// (PERF.md §6). The sums do not depend on it.
constexpr int kPassOneBlocksPerSM = 4;

// scal[0] = beta_prev, scal[1] = alpha, scal[2] = 1/beta (or 1/||b||)
// flags[0] = live (1 until a breakdown or a zero b)

// One thread's running sum of x*y: a float (fma) or a two-float pair of
// exact products.
template <bool Comp>
__device__ __forceinline__ float2 accumulate(float2 acc, float x, float y) {
  if constexpr (Comp) {
    const float2 pr = two_prod(x, y);
    return df_add2(acc.x, acc.y, pr.x, pr.y);
  } else {
    return make_float2(__fmaf_rn(x, y, acc.x), 0.0f);
  }
}

// Block total of the threads' sums, stored by thread 0 as the partial of
// block `slot` (hi in plane 0, lo in plane 1).
template <bool Comp>
__device__ __forceinline__ void store_partial(float2 acc, float* sh,
                                              float* sl, float* partials,
                                              int slot) {
  if constexpr (Comp) {
    const float2 s = block_sum2(acc, sh, sl);
    if (threadIdx.x == 0) {
      partials[slot] = s.x;
      partials[kMaxPartials + slot] = s.y;
    }
  } else {
    const float s = block_sum(acc.x, sh);
    if (threadIdx.x == 0) partials[slot] = s;
  }
}

// The fold of g block partials, in one block; every thread gets the total.
template <bool Comp, typename Load = DirectLoad>
__device__ __forceinline__ float fold_partials(const float* partials, int g,
                                               float* sh, float* sl,
                                               Load load = Load()) {
  if constexpr (Comp) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int i = threadIdx.x; i < g; i += kThreads)
      acc = df_add2(acc.x, acc.y, load(partials + i),
                    load(partials + kMaxPartials + i));
    const float2 t = block_sum2(acc, sh, sl);
    return __fadd_rn(t.x, t.y);
  } else {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < g; i += kThreads)
      acc = __fadd_rn(acc, load(partials + i));
    return block_sum(acc, sh);
  }
}

template <bool Comp>
__global__ void __launch_bounds__(kThreads)
sq_partials_kernel(const float* __restrict__ b, int n,
                   float* __restrict__ partials) {
  __shared__ float sh[kThreads];
  __shared__ float sl[Comp ? kThreads : 1];
  float2 acc = make_float2(0.0f, 0.0f);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    acc = accumulate<Comp>(acc, b[i], b[i]);
  store_partial<Comp>(acc, sh, sl, partials, blockIdx.x);
}

template <bool Comp>
__global__ void __launch_bounds__(kThreads)
init_kernel(const float* __restrict__ partials, int g, float ztol, int k,
            float* __restrict__ alphas, float* __restrict__ betas,
            float* __restrict__ bnorm, int* __restrict__ steps,
            float* __restrict__ scal, int* __restrict__ flags) {
  __shared__ float sh[kThreads];
  __shared__ float sl[Comp ? kThreads : 1];
  for (int i = threadIdx.x; i < k; i += kThreads) {
    alphas[i] = 0.0f;
    betas[i] = 0.0f;
  }
  const float nb = __fsqrt_rn(fold_partials<Comp>(partials, g, sh, sl));
  if (threadIdx.x == 0) {
    const bool zero_b = nb <= ztol;
    bnorm[0] = nb;
    steps[0] = 0;
    scal[0] = 0.0f;
    scal[2] = zero_b ? 0.0f : lanczos_inverse(nb);
    flags[0] = zero_b ? 0 : 1;
  }
}

// v_curr = b * (1/||b||), v_prev = 0; basis row 0 (when given) = v_curr.
__global__ void __launch_bounds__(kThreads)
init_vectors_kernel(const float* __restrict__ b, int n,
                    const float* __restrict__ scal, float* __restrict__ vp,
                    float* __restrict__ vc, float* __restrict__ row) {
  const float inv_n = scal[2];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float v1 = normalise(b[i], inv_n);
    vc[i] = v1;
    vp[i] = 0.0f;
    if (row != nullptr) row[i] = v1;
  }
}

// w -= (*coef) * x; partials of <partner, w> (partner == nullptr: <w, w>).
template <bool Comp>
__global__ void __launch_bounds__(kThreads)
sub_dot_kernel(float* __restrict__ w, const float* __restrict__ x,
               const float* __restrict__ coef,
               const float* __restrict__ partner, int n,
               float* __restrict__ partials, const int* __restrict__ flags) {
  if (flags[0] == 0) return;
  __shared__ float sh[kThreads];
  __shared__ float sl[Comp ? kThreads : 1];
  const float c = *coef;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float wi = sub_scaled(w[i], c, x[i]);
    w[i] = wi;
    acc = accumulate<Comp>(acc, partner != nullptr ? partner[i] : wi, wi);
  }
  store_partial<Comp>(acc, sh, sl, partials, blockIdx.x);
}

template <bool Comp>
__global__ void __launch_bounds__(kThreads)
finalize_alpha_kernel(const float* __restrict__ partials, int g, int j,
                      float* __restrict__ alphas, float* __restrict__ scal,
                      const int* __restrict__ flags) {
  if (flags[0] == 0) return;
  __shared__ float sh[kThreads];
  __shared__ float sl[Comp ? kThreads : 1];
  const float alpha = fold_partials<Comp>(partials, g, sh, sl);
  if (threadIdx.x == 0) {
    scal[1] = alpha;
    alphas[j] = alpha;
  }
}

template <bool Comp>
__global__ void __launch_bounds__(kThreads)
finalize_beta_kernel(const float* __restrict__ partials, int g, int j,
                     float tol, float* __restrict__ betas,
                     int* __restrict__ steps, float* __restrict__ scal,
                     int* __restrict__ flags) {
  if (flags[0] == 0) return;
  __shared__ float sh[kThreads];
  __shared__ float sl[Comp ? kThreads : 1];
  const float beta = __fsqrt_rn(fold_partials<Comp>(partials, g, sh, sl));
  if (threadIdx.x == 0) {
    steps[0] += 1;
    if (beta <= tol) {
      flags[0] = 0;  // breakdown: this step counts, nothing advances
    } else {
      betas[j] = beta;
      scal[0] = beta;
      scal[2] = lanczos_inverse(beta);
    }
  }
}

// v_prev = v_curr; v_curr = w * (1/beta); basis row (when given) = v_curr.
__global__ void __launch_bounds__(kThreads)
rotate_kernel(const float* __restrict__ w, float* __restrict__ vp,
              float* __restrict__ vc, int n, const float* __restrict__ scal,
              const int* __restrict__ flags, float* __restrict__ row) {
  if (flags[0] == 0) return;
  const float inv_b = scal[2];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float vn = normalise(w[i], inv_b);
    vp[i] = vc[i];
    vc[i] = vn;
    if (row != nullptr) row[i] = vn;
  }
}

inline int elementwise_blocks(int n) {
  int g = (n + kThreads - 1) / kThreads;
  return g < 4096 ? g : 4096;
}

// Everything one pass-one run touches; see the entry points for the sizes.
struct PassOne {
  const float* d;
  const int* u;
  const int* v;
  const int* ptr;
  const int* ent;
  int m, p, n, k;
  float tol, ztol;
  float* alphas;
  float* betas;
  float* bnorm;
  int* steps;
  float* vp;
  float* vc;
  float* w;
  float* partials;
  float* scal;
  int* flags;
  float* basis;  // (k, n) rows v_{j+1}, or nullptr
};

// One launch of K2, K4 or K5 (or K6, their compensated instances): the
// start and the steps [j0, j0 + count) of the per-step path's kernels, on
// one resident grid (see the top of the file).
struct Persistent {
  PassOne s;
  const float* b;
  int g;  // reduction_blocks(n): the dots' virtual blocks
  PhaseClock clock;  // 6 stamps a step (see the loop), or clock == nullptr
  int j0, count;     // K5's chunk; K2 and K4 run [0, k)
};

// Virtual blocks [0, g) of a reduction of stride g * kThreads: virtual block
// vb folds body(acc, i) over the elements that block vb of sub_dot_kernel
// (or sq_partials_kernel) walks, in the same order, and stores its partial
// as store_partial<Comp> does: at partials[vb], and with Comp its lo part
// at partials[kMaxPartials + vb].
template <bool Comp, typename Body>
__device__ __forceinline__ void reduce_phase(int g, int n, float* partials,
                                             float* sh, float* sl,
                                             Body body) {
  const Share mine = share_of(g);
  for (int vb = mine.begin; vb < mine.end; ++vb) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int i = vb * kThreads + threadIdx.x; i < n; i += g * kThreads)
      acc = body(acc, i);
    store_partial<Comp>(acc, sh, sl, partials, vb);
  }
}

// The persistent pass one: K2 (from b), K4 (Basis: from b, the rows
// stored) and K5 (Resume: the chunk [j0, j0 + count)), each with its
// compensated instance (Comp: K6); see the top of the file. K4's rows go
// out with streaming stores (__stcs, st.global.cs: evict first, so that
// they do not push the working set out of the L2).
template <bool Basis, bool Resume, bool Comp>
__global__ void __launch_bounds__(kThreads, kPassOneBlocksPerSM)
pass_one_persistent_kernel(Persistent a) {
  static_assert(!(Basis && Resume), "K4 runs from b in one launch");
  __shared__ float sh[kThreads];
  __shared__ float sl[Comp ? kThreads : 1];  // the lo parts (Comp)
  __shared__ long long row_ends[kWarps];      // the phase timer's
  const PassOne& s = a.s;
  const CachedLoad ld;
  const int m = s.m, n = s.n, g = a.g;
  float* const w = s.w;  // 2n: this step's w in one half, the last's in
                         // the other
  float* const vp = s.vp;
  float* const vc = s.vc;
  int* const ready = s.flags + 1;  // p: the step whose node row is in w
  // the <v, w> partials in pa, the ||b||^2 and <w, w> ones in pb, each one
  // plane (a hi and a lo plane with Comp): a block may start the beta dot
  // while another still folds alpha's, and step 0 may store its first
  // partials while another block still folds ||b||^2
  float* const pa = s.partials;
  float* const pb = s.partials + (Comp ? 2 : 1) * kMaxPartials;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int j0 = Resume ? a.j0 : 0;
  const int j_end = Resume ? a.j0 + a.count : s.k;

  float nb, inv_b, beta_prev = 0.0f, alpha = 0.0f;
  bool live;
  const float* src;  // this step's v is src * inv_b
  if (j0 == 0) {
    // the start: sq_partials_kernel, init_kernel, init_vectors_kernel
    reduce_phase<Comp>(g, n, pb, sh, sl, [&](float2 acc, int i) {
      return accumulate<Comp>(acc, a.b[i], a.b[i]);
    });
    for (int i = first; i < s.k; i += stride) {
      s.alphas[i] = 0.0f;
      s.betas[i] = 0.0f;
    }
    for (int i = first; i < s.p; i += stride) ready[i] = 0;
    grid_sync();
    nb = __fsqrt_rn(fold_partials<Comp>(pb, g, sh, sl, ld));
    const bool zero_b = nb <= s.ztol;
    inv_b = zero_b ? 0.0f : lanczos_inverse(nb);
    for (int i = first; i < n; i += stride) {
      const float v1 = normalise(a.b[i], inv_b);
      vc[i] = v1;
      vp[i] = 0.0f;
      if constexpr (Basis) __stcs(s.basis + i, v1);  // row 0
    }
    // no barrier: before its first barrier, step 0 reads b, not v_prev or
    // v_curr
    live = !zero_b;
    src = a.b;
  } else {
    // a resumed chunk (K5): the state the last chunk left, read by every
    // block before its first barrier and written back by the lead block
    // after its last, so every block takes the same decision
    live = ld(s.flags) != 0;
    if (!live) return;  // after a breakdown: no step, no store
    nb = ld(s.bnorm);
    beta_prev = ld(s.scal);
    inv_b = 1.0f;  // v_curr is already rotated: v = v_curr * 1, exactly
    src = vc;
  }

  int steps = 0;
  for (int j = j0; live && j < j_end; ++j) {
    // step 0's v = b * (1/||b||) is already in v_curr; a later step's v is
    // w * (1/beta_prev), and the step does the previous step's rotate
    // (rotate_kernel) element by element, where it first reads the element.
    // A resumed chunk's first step does no rotate, but its v_prev is real.
    const bool rotate = j > j0;
    const bool resumed = Resume && j > 0 && !rotate;
    float* const wn = w + (j & 1) * n;  // src is the other half
    float* const row =  // K4's row j: v_{j+1}, formed by this step's rotate
        Basis ? s.basis + static_cast<size_t>(j) * n : nullptr;
    a.clock.stamp(j, 0);
    // 1. one phase for w = A v and the first sub_dot. First this warp's
    //    node rows (row_share: one warp a row, gathering v from src): lane 0
    //    rotates the node's element, leaves the row in wn and publishes it.
    //    No barrier follows: the block's other warps start the dot at once
    const Share rows = row_share(s.p);
    for (int node = rows.begin; node < rows.end; ++node) {
      const float total = kkt_node_row_warp(s.ptr, s.ent, src, node,
                                            ScaledLoad{inv_b});
      if (threadIdx.x % kWarpSize == 0) {
        const int i = m + node;
        if (rotate) {
          vp[i] = ld(vc + i);
          const float vn = normalise(ld(src + i), inv_b);
          vc[i] = vn;
          if constexpr (Basis) __stcs(row + i, vn);
        }
        wn[i] = total;
        publish(ready + node, j + 1);
      }
    }
    a.clock.warp_stamp(j, 1, row_ends);
    //    Then its share of the dot's virtual blocks, in sub_dot's order: an
    //    arc element rotates and forms its row (K1's arc row, x_n gathered
    //    from src), a node element waits for its row; then w -= beta_prev
    //    v_prev, and v * w joins the sum. A warp waits only after its own
    //    node rows, and every block is resident, so every awaited row is
    //    being computed: no deadlock.
    reduce_phase<Comp>(g, n, pa, sh, sl, [&](float2 acc, int i) {
      float y, vpi, vci;
      if (i < m) {
        vci = normalise(ld(src + i), inv_b);
        vpi = rotate ? ld(vc + i) : resumed ? ld(vp + i) : 0.0f;
        if (rotate) {
          vp[i] = vpi;
          vc[i] = vci;
          if constexpr (Basis) __stcs(row + i, vci);
        }
        y = kkt_arc_row(s.d[i], vci, normalise(ld(src + m + s.u[i]), inv_b),
                        normalise(ld(src + m + s.v[i]), inv_b));
      } else {
        wait_for(ready + (i - m), j + 1);
        vpi = rotate || resumed ? ld(vp + i) : 0.0f;
        vci = rotate ? ld(vc + i) : normalise(ld(src + i), inv_b);
        y = ld(wn + i);
      }
      const float wi = sub_scaled(y, beta_prev, vpi);
      wn[i] = wi;
      return accumulate<Comp>(acc, vci, wi);
    });
    a.clock.stamp(j, 2, row_ends);
    grid_sync();
    a.clock.stamp(j, 3);
    // 2. every block folds alpha (finalize_alpha_kernel); the second sub_dot
    alpha = fold_partials<Comp>(pa, g, sh, sl, ld);
    if (lead) s.alphas[j] = alpha;
    reduce_phase<Comp>(g, n, pb, sh, sl, [&](float2 acc, int i) {
      const float wi = sub_scaled(ld(wn + i), alpha, ld(vc + i));
      wn[i] = wi;
      return accumulate<Comp>(acc, wi, wi);
    });
    a.clock.stamp(j, 4);
    grid_sync();
    a.clock.stamp(j, 5);
    // 3. every block folds beta (finalize_beta_kernel) and takes the same
    //    breakdown decision
    const float beta = __fsqrt_rn(fold_partials<Comp>(pb, g, sh, sl, ld));
    steps = j + 1;
    if (beta <= s.tol) {  // breakdown: this step counts, nothing advances
      live = false;
      break;
    }
    if (lead) s.betas[j] = beta;
    beta_prev = beta;
    inv_b = lanczos_inverse(beta);
    src = wn;
  }
  if (live) {  // the last step's rotate; K4's row k does not exist
    for (int i = first; i < n; i += stride) {
      const float vn = normalise(ld(src + i), inv_b);
      vp[i] = ld(vc + i);
      vc[i] = vn;
    }
  }
  if (lead) {  // the scalars the per-step path leaves behind
    s.bnorm[0] = nb;
    s.steps[0] = steps;
    s.flags[0] = live ? 1 : 0;
    s.scal[0] = beta_prev;
    s.scal[1] = alpha;
    s.scal[2] = inv_b;
  }
}

template <bool Comp>
cudaError_t enqueue_start(const PassOne& s, const float* b,
                          cudaStream_t stream) {
  const int g = reduction_blocks(s.n);
  sq_partials_kernel<Comp><<<g, kThreads, 0, stream>>>(b, s.n, s.partials);
  init_kernel<Comp><<<1, kThreads, 0, stream>>>(s.partials, g, s.ztol, s.k,
                                                s.alphas, s.betas, s.bnorm,
                                                s.steps, s.scal, s.flags);
  init_vectors_kernel<<<elementwise_blocks(s.n), kThreads, 0, stream>>>(
      b, s.n, s.scal, s.vp, s.vc, s.basis);
  return cudaGetLastError();
}

// The six launches of step j (see the top of the file).
template <bool Comp>
cudaError_t enqueue_step(const PassOne& s, int j, int* matvec_launches,
                         cudaStream_t stream) {
  const int g = reduction_blocks(s.n);
  cudaError_t err = launch_kkt_matvec(s.d, s.u, s.v, s.ptr, s.ent, s.m, s.p,
                                      s.vc, s.w, s.flags, 0, stream);
  if (err != cudaSuccess) return err;
  *matvec_launches += 1;
  sub_dot_kernel<Comp><<<g, kThreads, 0, stream>>>(
      s.w, s.vp, s.scal + 0, s.vc, s.n, s.partials, s.flags);
  finalize_alpha_kernel<Comp><<<1, kThreads, 0, stream>>>(
      s.partials, g, j, s.alphas, s.scal, s.flags);
  sub_dot_kernel<Comp><<<g, kThreads, 0, stream>>>(
      s.w, s.vc, s.scal + 1, nullptr, s.n, s.partials, s.flags);
  finalize_beta_kernel<Comp><<<1, kThreads, 0, stream>>>(
      s.partials, g, j, s.tol, s.betas, s.steps, s.scal, s.flags);
  float* row = s.basis != nullptr && j + 1 < s.k
                   ? s.basis + static_cast<size_t>(j + 1) * s.n
                   : nullptr;
  rotate_kernel<<<elementwise_blocks(s.n), kThreads, 0, stream>>>(
      s.w, s.vp, s.vc, s.n, s.scal, s.flags, row);
  return cudaGetLastError();
}

// Steps [j0, j0 + count), preceded by the start from b when j0 == 0.
template <bool Comp>
cudaError_t enqueue_run(const PassOne& s, const float* b, int j0, int count,
                        int* matvec_launches, cudaStream_t stream) {
  *matvec_launches = 0;
  if (j0 == 0) {
    const cudaError_t err = enqueue_start<Comp>(s, b, stream);
    if (err != cudaSuccess) return err;
  }
  for (int j = j0; j < j0 + count; ++j) {
    const cudaError_t err = enqueue_step<Comp>(s, j, matvec_launches, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int run(const PassOne& s, int comp, const float* b, int j0, int count,
        int* matvec_launches, cudaStream_t stream) {
  const cudaError_t err =
      comp ? enqueue_run<true>(s, b, j0, count, matvec_launches, stream)
           : enqueue_run<false>(s, b, j0, count, matvec_launches, stream);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace tpl

// All pointers are device pointers except matvec_launches (host). Common
// arguments: the layout (d, u, v, ptr, ent; m arcs, p nodes, n = m + p), b
// (n), k, the breakdown and zero-b tolerances. Outputs: alphas, betas (k),
// bnorm (1), steps (1). Scratch: v_prev, v_curr (n each), w (2n for the
// persistent K2, K4 and K5; n for the per-step launches), partials (4 *
// tpl::kMaxPartials for K2, K4 and K5, whose compensated instances use all
// four planes; 2 * tpl::kMaxPartials for the per-step launches), scal (3
// floats), flags (1 + p ints for K2, K4 and K5; 1 for the per-step
// launches); on return v_prev and v_curr hold the state after the last
// step. Each entry point allocates nothing and does not synchronise; it
// returns the error of its launches (a refused cooperative launch included:
// there is no fallback). K2, K4 and K5 (comp selects the instance) are one
// cooperative launch each and *matvec_launches counts the matvec phases
// inside it; the per-step launches (tpl_lanczos_pass_one_steps) count
// their K1 launches.
#define TPL_PASS_ONE_ARGS                                                    \
  const float *d, const int *u, const int *v, const int *ptr,               \
      const int *ent, int m, int p, const float *b, int k, float tol,       \
      float ztol, float *alphas, float *betas, float *bnorm, int *steps,    \
      float *v_prev, float *v_curr, float *w, float *partials, float *scal, \
      int *flags
#define TPL_PASS_ONE_STATE(basis)                                            \
  tpl::PassOne {                                                             \
    d, u, v, ptr, ent, m, p, m + p, k, tol, ztol, alphas, betas, bnorm,     \
        steps, v_prev, v_curr, w, partials, scal, flags, basis               \
  }

namespace tpl {
namespace {

using PersistentKernel = void (*)(Persistent);

// The instance of the persistent kernel that an entry point launches: the
// compensated one (K6) when comp != 0.
template <bool Basis, bool Resume>
PersistentKernel pass_one_instance(int comp) {
  return comp ? pass_one_persistent_kernel<Basis, Resume, true>
              : pass_one_persistent_kernel<Basis, Resume, false>;
}

// One cooperative launch of the persistent instance `kernel` over the steps
// [j0, j0 + count) of s; *matvec_launches counts its matvec phases.
int launch_pass_one(PersistentKernel kernel, const PassOne& s,
                    const float* b, PhaseClock clock, int j0, int count,
                    int* matvec_launches, cudaStream_t stream) {
  *matvec_launches = 0;
  const Persistent args{s, b, reduction_blocks(s.n), clock, j0, count};
  const cudaError_t err =
      launch_persistent(kernel, args, stream, kPassOneBlocksPerSM);
  if (err == cudaSuccess) *matvec_launches = count;
  return static_cast<int>(err);
}

}  // namespace
}  // namespace tpl

// K2: k steps from b, scalars only (comp != 0: its compensated instance).
// clock: the phase timer's stamps ((8, grid, 6) int64, tpl::PhaseClock) or
// nullptr.
extern "C" int tpl_lanczos_pass_one(TPL_PASS_ONE_ARGS, int comp,
                                    long long* clock, int* matvec_launches,
                                    cudaStream_t stream) {
  return tpl::launch_pass_one(tpl::pass_one_instance<false, false>(comp),
                              TPL_PASS_ONE_STATE(nullptr), b,
                              tpl::PhaseClock{clock, k / 2, 6}, 0, k,
                              matvec_launches, stream);
}

// K4: k steps from b; row j of basis (k x n, zeroed by the caller) becomes
// v_{j+1} for every executed step j (comp != 0: the compensated instance).
// clock: as K2's.
extern "C" int tpl_lanczos_pass_one_basis(TPL_PASS_ONE_ARGS, int comp,
                                          float* basis, long long* clock,
                                          int* matvec_launches,
                                          cudaStream_t stream) {
  return tpl::launch_pass_one(tpl::pass_one_instance<true, false>(comp),
                              TPL_PASS_ONE_STATE(basis), b,
                              tpl::PhaseClock{clock, k / 2, 6}, 0, k,
                              matvec_launches, stream);
}

// K5: steps [j0, j0 + count) of a k-step run (j0 + count <= k) on scratch
// and outputs kept by the caller between calls; j0 == 0 starts from b
// (comp != 0: the compensated instance, on the scratch of its own runs).
// clock: as K2's, stamped by the chunks that run steps k/2 .. k/2 + 7 (the
// steps' global numbers).
extern "C" int tpl_lanczos_pass_one_chunk(TPL_PASS_ONE_ARGS, int comp,
                                          int j0, int count, long long* clock,
                                          int* matvec_launches,
                                          cudaStream_t stream) {
  return tpl::launch_pass_one(tpl::pass_one_instance<false, true>(comp),
                              TPL_PASS_ONE_STATE(nullptr), b,
                              tpl::PhaseClock{clock, k / 2, 6}, j0, count,
                              matvec_launches, stream);
}

// The per-step launches (see the top of the file), which no solve calls:
// the reference that K2, K4 and K5 are held to bit for bit (comp == 0),
// and their compensated instances (comp != 0). Steps [j0, j0 + count) as K5
// runs them (j0 == 0 starts from b), storing K4's basis rows when basis !=
// nullptr (k x n, zeroed by the caller). Scratch: w of n, partials of 2 *
// tpl::kMaxPartials and flags of 1 suffice. *matvec_launches counts its K1
// launches.
extern "C" int tpl_lanczos_pass_one_steps(TPL_PASS_ONE_ARGS, int comp,
                                          float* basis, int j0, int count,
                                          int* matvec_launches,
                                          cudaStream_t stream) {
  return tpl::run(TPL_PASS_ONE_STATE(basis), comp, b, j0, count,
                  matvec_launches, stream);
}

// The cooperative grids of K2, K4 and K5 (comp != 0: of their compensated
// instances): resident blocks per SM and SMs.
extern "C" int tpl_lanczos_pass_one_grid(int comp, int* blocks_per_sm,
                                         int* sms) {
  return static_cast<int>(tpl::persistent_grid(
      tpl::pass_one_instance<false, false>(comp), blocks_per_sm, sms,
      tpl::kPassOneBlocksPerSM));
}
extern "C" int tpl_lanczos_pass_one_basis_grid(int comp, int* blocks_per_sm,
                                               int* sms) {
  return static_cast<int>(tpl::persistent_grid(
      tpl::pass_one_instance<true, false>(comp), blocks_per_sm, sms,
      tpl::kPassOneBlocksPerSM));
}
extern "C" int tpl_lanczos_pass_one_chunk_grid(int comp, int* blocks_per_sm,
                                               int* sms) {
  return static_cast<int>(tpl::persistent_grid(
      tpl::pass_one_instance<false, true>(comp), blocks_per_sm, sms,
      tpl::kPassOneBlocksPerSM));
}
