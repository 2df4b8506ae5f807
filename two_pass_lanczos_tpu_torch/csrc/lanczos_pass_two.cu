// K3: Lanczos pass two, basis replay and accumulation of x = sum_j y_j v_j.
//
// Replaces the TPU kernel _pass_two_kernel (two_pass_lanczos_tpu/ops/
// kkt_fused.py:841). It computes no inner product: step j (0 <= j < k-1)
// regenerates v_{j+2} from the stored alpha_j, beta_{j-1}, beta_j with the
// same device routines as pass one (lanczos_common.cuh), so the basis is
// bit-identical to pass one's, and adds y_{j+1} v_{j+2} to every one of the
// nf accumulators. As in :880-912 of the TPU kernel, step j is active only
// while j < steps_taken - 1 (read on the device: an inactive step's two
// launches return at once), 1/beta_j is guarded against beta_j = 0, and
// x_0 = y_0 v_1 with v_1 = b / ||b|| from the stored ||b||.
//
// What bounds it on the H100: per step one matvec plus one fused pass that
// reads w, v_prev, v and nf accumulators and writes v_prev, v and the
// accumulators, all resident in the 50 MB L2 at the headline size; with
// two launches per step the pass is bound by launch latency and L2
// bandwidth, not by HBM.
#include "lanczos_common.cuh"

namespace tpl {
namespace {

__global__ void __launch_bounds__(kThreads)
init_kernel(const float* __restrict__ b, int n, float ztol,
            const float* __restrict__ bnorm, const float* __restrict__ y,
            int nf, int k, float* __restrict__ x, float* __restrict__ vp,
            float* __restrict__ vc) {
  const float nb = bnorm[0];
  const float inv_n = nb <= ztol ? 0.0f : lanczos_inverse(nb);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float v1 = normalise(b[i], inv_n);
    vc[i] = v1;
    vp[i] = 0.0f;
    for (int f = 0; f < nf; ++f)
      x[static_cast<size_t>(f) * n + i] = __fmul_rn(y[f * k], v1);
  }
}

__global__ void __launch_bounds__(kThreads)
step_kernel(const float* __restrict__ w, float* __restrict__ vp,
            float* __restrict__ vc, float* __restrict__ x, int n,
            const float* __restrict__ alphas,
            const float* __restrict__ betas, const float* __restrict__ y,
            int nf, int k, const int* __restrict__ steps, int j) {
  if (!(j + 1 < steps[0])) return;  // inactive step
  const float alpha = alphas[j];
  const float beta_prev = j > 0 ? betas[j - 1] : 0.0f;
  const float beta_j = betas[j];
  const float inv_b = lanczos_inverse(beta_j > 0.0f ? beta_j : 1.0f);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float v = vc[i];
    const float vn =
        normalise(lanczos_update(w[i], beta_prev, vp[i], alpha, v), inv_b);
    for (int f = 0; f < nf; ++f) {
      float* xf = x + static_cast<size_t>(f) * n;
      xf[i] = __fadd_rn(xf[i], __fmul_rn(y[f * k + j + 1], vn));
    }
    vp[i] = v;
    vc[i] = vn;
  }
}

inline int elementwise_blocks(int n) {
  int g = (n + kThreads - 1) / kThreads;
  return g < 4096 ? g : 4096;
}

}  // namespace
}  // namespace tpl

// All pointers are device pointers except matvec_launches (host). Inputs:
// b (n), alphas, betas (k), y (nf x k, row-major, zero beyond steps_taken,
// scaled by ||b||), bnorm (1), steps (1). Output: x (nf x n). Scratch:
// v_prev, v_curr, w (n each); on return v_curr holds v_{steps_taken}.
// Allocates nothing and does not synchronise; returns cudaGetLastError().
extern "C" int tpl_lanczos_pass_two(
    const float* d, const int* u, const int* v, const int* ptr,
    const int* ent, int m, int p, const float* b, int k, float ztol,
    const float* alphas, const float* betas, const float* y, int nf,
    const float* bnorm, const int* steps, float* x, float* v_prev,
    float* v_curr, float* w, int* matvec_launches, cudaStream_t stream) {
  using namespace tpl;
  const int n = m + p;
  const int ge = elementwise_blocks(n);
  *matvec_launches = 0;
  init_kernel<<<ge, kThreads, 0, stream>>>(b, n, ztol, bnorm, y, nf, k, x,
                                           v_prev, v_curr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int j = 0; j + 1 < k; ++j) {
    // active iff j + 1 < steps_taken
    err = launch_kkt_matvec(d, u, v, ptr, ent, m, p, v_curr, w, steps, j + 1,
                            stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    *matvec_launches += 1;
    step_kernel<<<ge, kThreads, 0, stream>>>(w, v_prev, v_curr, x, n, alphas,
                                             betas, y, nf, k, steps, j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
