// K9: Lanczos pass one in double-float, scalars only.
//
// Replaces _df_pass_one_kernel (two_pass_lanczos_tpu/ops/kkt_fused_df.py:381,
// launched by _raw_p1 :837). The TPU ran all k steps in one launch with the
// hi/lo state of both arc orderings in VMEM. Here, on the pattern of K2
// (lanczos_pass_one.cu), each step is a fixed sequence of launches that one
// C++ routine (enqueue_step) enqueues on the caller's stream with no host
// synchronisation, on (2, n) hi/lo vectors:
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
// What bounds it on the H100: per step the K11 matvec plus three passes over
// the (2, n) vectors, ~24 MB of L2 traffic at the headline with the whole
// state (12 MB of vectors, 4 MB of d, 6 MB of layout) L2-resident, and six
// launches; like K2 it is bound by launch latency and L2 bandwidth. The df
// arithmetic is ~10x K2's f32 operations per element, still far below the
// card's f32 rate.
#include <cstddef>

#include "df_common.cuh"

namespace tpl {
namespace {

// scal: [0..1] beta_prev (hi, lo), [2..3] alpha, [4..5] 1/beta or 1/||b||.
// flags[0] = live (1 until a breakdown or a zero b).
// coeffs (4, k): rows alpha_hi, alpha_lo, beta_hi, beta_lo.

__device__ __forceinline__ void store_df_partial(float2 acc, float* sh,
                                                 float* sl, float* partials) {
  const float2 s = block_sum2(acc, sh, sl);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s.x;
    partials[kMaxPartials + blockIdx.x] = s.y;
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
  store_df_partial(acc, sh, sl, partials);
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
  store_df_partial(acc, sh, sl, partials);
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

// Everything one df pass-one run touches; see the entry point for sizes.
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
  float* scal;
  int* flags;
};

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

// All pointers are device pointers except matvec_launches (host). Inputs:
// the layout (d2 (2 x m) hi/lo costs, u, v, ptr, ent; m arcs, p nodes,
// n = m + p), b2 (2 x n), k, the breakdown and zero-b tolerances. Outputs:
// coeffs (4 x k: alpha hi, alpha lo, beta hi, beta lo), bnorm2 (2: ||b||
// hi, lo), steps (1). Scratch: v_prev2, v_curr2, w2 (2 x n each), partials
// (2 * tpl::kMaxPartials), scal (6 floats), flags (1 int); on return
// v_prev2 and v_curr2 hold the state after the last step. Allocates
// nothing and does not synchronise; returns cudaGetLastError().
extern "C" int tpl_df_lanczos_pass_one(
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
