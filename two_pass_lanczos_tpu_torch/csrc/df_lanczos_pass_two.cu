// K10: Lanczos pass two in double-float: replay from the stored df alpha and
// beta, and accumulate x = sum_j y_j v_j in df.
//
// Replaces _df_pass_two_kernel (two_pass_lanczos_tpu/ops/kkt_fused_df.py:486,
// launched by _raw_p2 :867). It computes no inner product: step j
// (0 <= j < k-1) regenerates v_{j+2} with the routines K9 uses
// (df_common.cuh: df_axpy with beta_{j-1}, df_axpy with alpha_j, df_scale
// by df_scalar_recip of the stored df beta_j), so the hi and the lo plane
// of the basis are bit-identical to pass one's, and adds
// y_{j+1} (x) v_{j+2} to x (df_prod, then df_add2). As in :531-592, step j
// is active only while j < steps_taken - 1 (read on the device: an inactive
// step's two launches return at once), and x_0 = v_1 (x) y_0 with v_1 = b /
// ||b|| from the stored df ||b||. The zero-b cut of pass one
// (||b||_hi <= 1000*tiny gives 1/||b|| = 0) applies here too, so a
// subnormal b gives x = 0, never 0 * inf = NaN (:502-510).
//
// What bounds it on the H100: per step one K11 matvec and one fused pass
// that reads w, v_prev, v and x and writes v_prev, v and x, all (2, n) and
// L2-resident at the headline; two launches per step, so like K3 it is
// bound by launch latency and L2 bandwidth.
#include <cstddef>

#include "df_common.cuh"

namespace tpl {
namespace {

__global__ void __launch_bounds__(kThreads)
df_init_kernel(const float* __restrict__ b2, int n, float ztol,
               const float* __restrict__ bnorm2, const float* __restrict__ y2,
               int k, float* __restrict__ x2, float* __restrict__ vp2,
               float* __restrict__ vc2) {
  const bool zero_b = bnorm2[0] <= ztol;
  const float2 r = df_scalar_recip(zero_b ? 1.0f : bnorm2[0], bnorm2[1]);
  const float ih = zero_b ? 0.0f : r.x;
  const float il = zero_b ? 0.0f : r.y;
  const float y0h = y2[0];
  const float y0l = y2[k];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float2 v1 = df_scale(b2[i], b2[n + i], ih, il);
    const float2 x0 = df_scale(v1.x, v1.y, y0h, y0l);
    vc2[i] = v1.x;
    vc2[n + i] = v1.y;
    vp2[i] = 0.0f;
    vp2[n + i] = 0.0f;
    x2[i] = x0.x;
    x2[n + i] = x0.y;
  }
}

__global__ void __launch_bounds__(kThreads)
df_step_kernel(const float* __restrict__ w2, float* __restrict__ vp2,
               float* __restrict__ vc2, float* __restrict__ x2, int n,
               const float* __restrict__ coeffs, const float* __restrict__ y2,
               int k, const int* __restrict__ steps, int j) {
  if (!(j + 1 < steps[0])) return;  // inactive step
  const float ah = coeffs[j];
  const float al = coeffs[k + j];
  const float bph = j > 0 ? coeffs[2 * k + j - 1] : 0.0f;
  const float bpl = j > 0 ? coeffs[3 * k + j - 1] : 0.0f;
  const float bjh = coeffs[2 * k + j];
  const float bjl = coeffs[3 * k + j];
  const float2 ib = df_scalar_recip(bjh > 0.0f ? bjh : 1.0f, bjl);
  const float ynh = y2[j + 1];
  const float ynl = y2[k + j + 1];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float vh = vc2[i];
    const float vl = vc2[n + i];
    float2 w = df_axpy(w2[i], w2[n + i], bph, bpl, vp2[i], vp2[n + i]);
    w = df_axpy(w.x, w.y, ah, al, vh, vl);
    const float2 vn = df_scale(w.x, w.y, ib.x, ib.y);
    const float2 pr = df_prod(vn.x, vn.y, ynh, ynl);
    const float2 xn = df_add2(x2[i], x2[n + i], pr.x, pr.y);
    x2[i] = xn.x;
    x2[n + i] = xn.y;
    vp2[i] = vh;
    vp2[n + i] = vl;
    vc2[i] = vn.x;
    vc2[n + i] = vn.y;
  }
}

}  // namespace
}  // namespace tpl

// All pointers are device pointers except matvec_launches (host). Inputs:
// the layout (as tpl_df_lanczos_pass_one), b2 (2 x n), k, the zero-b
// tolerance, pass one's coeffs (4 x k), y2 (2 x k: y hi, y lo, zero beyond
// steps_taken, scaled by ||b||), bnorm2 (2), steps (1). Output: x2
// (2 x n). Scratch: v_prev2, v_curr2, w2 (2 x n each); on return v_curr2
// holds v_{steps_taken}. Allocates nothing and does not synchronise;
// returns cudaGetLastError().
extern "C" int tpl_df_lanczos_pass_two(
    const float* d2, const int* u, const int* v, const int* ptr,
    const int* ent, int m, int p, const float* b2, int k, float ztol,
    const float* coeffs, const float* y2, const float* bnorm2,
    const int* steps, float* x2, float* v_prev2, float* v_curr2, float* w2,
    int* matvec_launches, cudaStream_t stream) {
  using namespace tpl;
  const int n = m + p;
  const int ge = df_elementwise_blocks(n);
  *matvec_launches = 0;
  df_init_kernel<<<ge, kThreads, 0, stream>>>(b2, n, ztol, bnorm2, y2, k, x2,
                                              v_prev2, v_curr2);
  cudaError_t err = cudaGetLastError();
  for (int j = 0; j + 1 < k && err == cudaSuccess; ++j) {
    // active iff j + 1 < steps_taken
    err = launch_df_kkt_matvec(d2, u, v, ptr, ent, m, p, v_curr2, w2, steps,
                               j + 1, stream);
    if (err != cudaSuccess) break;
    *matvec_launches += 1;
    df_step_kernel<<<ge, kThreads, 0, stream>>>(w2, v_prev2, v_curr2, x2, n,
                                                coeffs, y2, k, steps, j);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
