// K2: Lanczos pass one, k steps, scalars only.
//
// Replaces the TPU kernel _pass_one_kernel (two_pass_lanczos_tpu/ops/
// kkt_fused.py:581), which ran all k steps inside one launch with the whole
// state in VMEM. A Hopper grid cannot carry a sum from one block to the
// next, so each step here is a short, fixed sequence of launches that one
// C++ loop enqueues on the caller's stream, with no host synchronisation:
//   1. the K1 matvec               w = A v
//   2. sub_dot                     w -= beta_prev * v_prev; partials of <v,w>
//   3. finalize_alpha (1 block)    alpha = fold(partials)
//   4. sub_dot                     w -= alpha * v;          partials of <w,w>
//   5. finalize_beta (1 block)     beta = sqrt(fold); breakdown; steps
//   6. rotate                      v_prev = v; v = w * (1/beta)
// alpha, beta, the live flag and steps_taken stay on the device. Breakdown
// (beta <= 1000 eps) clears the live flag and every later launch returns at
// once: the masked fixed-length loop of algorithms/core.py, where the last
// executed step still counts and writes alpha but not beta. A zero b
// (||b|| <= 1000 tiny) starts with the flag cleared: 0 steps.
//
// What bounds it on the H100: each step moves ~30 MB through the 50 MB L2
// (the matvec plus three passes over the (n,) vectors) and issues six
// launches of a few microseconds each, so at the headline size the pass is
// bound by launch latency and L2 bandwidth, not by HBM. This first version
// keeps each launch simple and fuses what it can (axpy with its dot, the
// rotate with the normalisation); a persistent grid-synced kernel or a CUDA
// graph of the step is the next step (ROADMAP).
#include "lanczos_common.cuh"

namespace tpl {
namespace {

// scal[0] = beta_prev, scal[1] = alpha, scal[2] = 1/beta (or 1/||b||)
// flags[0] = live (1 until a breakdown or a zero b)

__global__ void __launch_bounds__(kThreads)
sq_partials_kernel(const float* __restrict__ b, int n,
                   float* __restrict__ partials) {
  __shared__ float sh[kThreads];
  float acc = 0.0f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    acc = __fmaf_rn(b[i], b[i], acc);
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__device__ __forceinline__ float fold_partials(const float* partials, int g,
                                               float* sh) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < g; i += kThreads)
    acc = __fadd_rn(acc, partials[i]);
  return block_sum(acc, sh);
}

__global__ void __launch_bounds__(kThreads)
init_kernel(const float* __restrict__ partials, int g, float ztol, int k,
            float* __restrict__ alphas, float* __restrict__ betas,
            float* __restrict__ bnorm, int* __restrict__ steps,
            float* __restrict__ scal, int* __restrict__ flags) {
  __shared__ float sh[kThreads];
  for (int i = threadIdx.x; i < k; i += kThreads) {
    alphas[i] = 0.0f;
    betas[i] = 0.0f;
  }
  const float nb = __fsqrt_rn(fold_partials(partials, g, sh));
  if (threadIdx.x == 0) {
    const bool zero_b = nb <= ztol;
    bnorm[0] = nb;
    steps[0] = 0;
    scal[0] = 0.0f;
    scal[2] = zero_b ? 0.0f : lanczos_inverse(nb);
    flags[0] = zero_b ? 0 : 1;
  }
}

__global__ void __launch_bounds__(kThreads)
init_vectors_kernel(const float* __restrict__ b, int n,
                    const float* __restrict__ scal, float* __restrict__ vp,
                    float* __restrict__ vc) {
  const float inv_n = scal[2];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    vc[i] = normalise(b[i], inv_n);
    vp[i] = 0.0f;
  }
}

// w -= (*coef) * x; partials of <partner, w> (partner == nullptr: <w, w>).
__global__ void __launch_bounds__(kThreads)
sub_dot_kernel(float* __restrict__ w, const float* __restrict__ x,
               const float* __restrict__ coef,
               const float* __restrict__ partner, int n,
               float* __restrict__ partials, const int* __restrict__ flags) {
  if (flags[0] == 0) return;
  __shared__ float sh[kThreads];
  const float c = *coef;
  float acc = 0.0f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float wi = sub_scaled(w[i], c, x[i]);
    w[i] = wi;
    acc = __fmaf_rn(partner != nullptr ? partner[i] : wi, wi, acc);
  }
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
finalize_alpha_kernel(const float* __restrict__ partials, int g, int j,
                      float* __restrict__ alphas, float* __restrict__ scal,
                      const int* __restrict__ flags) {
  if (flags[0] == 0) return;
  __shared__ float sh[kThreads];
  const float alpha = fold_partials(partials, g, sh);
  if (threadIdx.x == 0) {
    scal[1] = alpha;
    alphas[j] = alpha;
  }
}

__global__ void __launch_bounds__(kThreads)
finalize_beta_kernel(const float* __restrict__ partials, int g, int j,
                     float tol, float* __restrict__ betas,
                     int* __restrict__ steps, float* __restrict__ scal,
                     int* __restrict__ flags) {
  if (flags[0] == 0) return;
  __shared__ float sh[kThreads];
  const float beta = __fsqrt_rn(fold_partials(partials, g, sh));
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

__global__ void __launch_bounds__(kThreads)
rotate_kernel(const float* __restrict__ w, float* __restrict__ vp,
              float* __restrict__ vc, int n, const float* __restrict__ scal,
              const int* __restrict__ flags) {
  if (flags[0] == 0) return;
  const float inv_b = scal[2];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    vp[i] = vc[i];
    vc[i] = normalise(w[i], inv_b);
  }
}

inline int elementwise_blocks(int n) {
  int g = (n + kThreads - 1) / kThreads;
  return g < 4096 ? g : 4096;
}

}  // namespace
}  // namespace tpl

// All pointers are device pointers except matvec_launches (host). Outputs:
// alphas, betas (k), bnorm (1), steps (1). Scratch: v_prev, v_curr, w (n
// each, n = m + p), partials (tpl::kMaxPartials), scal (3 floats), flags
// (1 int). On return v_prev and v_curr hold the final state. Allocates
// nothing and does not synchronise; returns cudaGetLastError().
extern "C" int tpl_lanczos_pass_one(
    const float* d, const int* u, const int* v, const int* ptr,
    const int* ent, int m, int p, const float* b, int k, float tol,
    float ztol, float* alphas, float* betas, float* bnorm, int* steps,
    float* v_prev, float* v_curr, float* w, float* partials, float* scal,
    int* flags, int* matvec_launches, cudaStream_t stream) {
  using namespace tpl;
  const int n = m + p;
  const int g = reduction_blocks(n);
  const int ge = elementwise_blocks(n);
  *matvec_launches = 0;
  sq_partials_kernel<<<g, kThreads, 0, stream>>>(b, n, partials);
  init_kernel<<<1, kThreads, 0, stream>>>(partials, g, ztol, k, alphas, betas,
                                          bnorm, steps, scal, flags);
  init_vectors_kernel<<<ge, kThreads, 0, stream>>>(b, n, scal, v_prev,
                                                   v_curr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int j = 0; j < k; ++j) {
    err = launch_kkt_matvec(d, u, v, ptr, ent, m, p, v_curr, w, flags, 0,
                            stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    *matvec_launches += 1;
    sub_dot_kernel<<<g, kThreads, 0, stream>>>(w, v_prev, scal + 0, v_curr,
                                               n, partials, flags);
    finalize_alpha_kernel<<<1, kThreads, 0, stream>>>(partials, g, j, alphas,
                                                      scal, flags);
    sub_dot_kernel<<<g, kThreads, 0, stream>>>(w, v_curr, scal + 1, nullptr,
                                               n, partials, flags);
    finalize_beta_kernel<<<1, kThreads, 0, stream>>>(partials, g, j, tol,
                                                     betas, steps, scal,
                                                     flags);
    rotate_kernel<<<ge, kThreads, 0, stream>>>(w, v_prev, v_curr, n, scal,
                                               flags);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
