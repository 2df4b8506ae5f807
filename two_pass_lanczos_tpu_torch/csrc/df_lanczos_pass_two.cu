// K10: Lanczos pass two in double-float: replay from the stored df alpha and
// beta, and accumulate x = sum_j y_j v_j in df.
//
// Replaces _df_pass_two_kernel (two_pass_lanczos_tpu/ops/kkt_fused_df.py:486,
// launched by _raw_p2 :867), and like it runs the whole pass in ONE launch:
// a resident cooperative grid (lanczos_persistent.cuh), on the pattern of
// K3's pass_two_persistent_kernel (lanczos_pass_two.cu). It computes no
// inner product: step j (0 <= j < k-1) regenerates v_{j+2} with the
// routines K9 uses (df_common.cuh: df_axpy with beta_{j-1}, df_axpy with
// alpha_j, df_scale by df_scalar_recip of the stored df beta_j), so the hi
// and the lo plane of the basis are bit-identical to pass one's, and adds
// y_{j+1} (x) v_{j+2} to x (df_prod, then df_add2). As in :531-592, step j
// is active only while j < steps_taken - 1 (steps_taken is read once on the
// device; every block reads the same value, so every block runs the same
// steps), and x_0 = v_1 (x) y_0 with v_1 = b / ||b|| from the stored df
// ||b||. The zero-b cut of pass one (||b||_hi <= 1000*tiny gives 1/||b|| =
// 0) applies here too, so a subnormal b gives x = 0, never 0 * inf = NaN
// (:502-510).
//
// A step is ONE phase and one grid barrier: K11's blocks as virtual blocks,
// and each row i of w = A v, as soon as it is formed, goes through the
// update of element i that df_step_kernel did after the matvec:
//   w_i -= beta_prev v_prev_i; w_i -= alpha v_i; v_next = w_i (x) 1/beta;
//   x_i += y_{j+1} (x) v_next
// v_next overwrites v_prev_i, which no other block reads in the step (the
// matvec gathers v only), and v_prev and v_curr swap roles by pointer.
// v_prev, v_curr and x are (hi, lo) pairs (df_common.cuh): an element is
// one 8-byte access and a gathered entry one L2 sector; b is read and x
// and the state are written in planes, once a pass. The rows keep K11's
// arithmetic and the update df_step_kernel's, so x and the final state are
// bitwise those of the two launches a step it replaced, which stay, on the
// planes and the planar K11, as the reference that chip_smoke.py and the
// card tests hold it to (tpl_df_lanczos_pass_two_steps; no solve reaches
// it).
//
// What bounds it on the H100: per step one df matvec, whose node rows gather
// v from all over the 50 MB L2, and the update's stream over the v_prev, v
// and x pairs (L2-resident at the headline), then one grid barrier; 499
// dependent steps, with no launch between them.
#include <cstddef>

#include "df_common.cuh"
#include "lanczos_persistent.cuh"

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

// Everything one df pass-two run touches; see the entry points for sizes.
struct DFPassTwo {
  const float* d2;
  const int* u;
  const int* v;
  const int* ptr;
  const int* ent;
  int m, p, n, k, arc_blocks;
  float ztol;
  const float* b2;      // (2, n)
  const float* coeffs;  // (4, k)
  const float* y2;      // (2, k)
  const float* bnorm2;  // (2,)
  const int* steps;     // (1,)
  float* x2;            // (2, n)
  float* vp2;           // (2, n)
  float* vc2;           // (2, n)
  float2* pairs;        // (3, n) pairs: v_prev, v_curr, x
};

// K10's one launch. Clock is PhaseClock (4 stamps a step, see the loop) or
// NoClock (every solve).
template <typename Clock>
struct DFPersistentTwo {
  DFPassTwo s;
  Clock clock;
};

template <typename Clock>
__global__ void __launch_bounds__(kThreads, kDFPersistentBlocksPerSM)
df_pass_two_persistent_kernel(DFPersistentTwo<Clock> a) {
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  const DFPassTwo& s = a.s;
  const int m = s.m, n = s.n, k = s.k;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  float2* const x = s.pairs + 2 * n;

  // df_init_kernel, from the planes of b into pairs
  const bool zero_b = s.bnorm2[0] <= s.ztol;
  const float2 r = df_scalar_recip(zero_b ? 1.0f : s.bnorm2[0], s.bnorm2[1]);
  const float ih = zero_b ? 0.0f : r.x;
  const float il = zero_b ? 0.0f : r.y;
  const float y0h = s.y2[0];
  const float y0l = s.y2[k];
  for (int i = first; i < n; i += stride) {
    const float2 v1 = df_scale(s.b2[i], s.b2[n + i], ih, il);
    s.pairs[n + i] = v1;
    s.pairs[i] = make_float2(0.0f, 0.0f);
    x[i] = df_scale(v1.x, v1.y, y0h, y0l);
  }
  const int steps = s.steps[0];
  grid_sync();

  // v_prev and v_curr swap roles every step: element i's update writes
  // v_{j+2} over its v_j, which no other block reads in that step
  float2* prev = s.pairs;
  float2* cur = s.pairs + n;
  for (int j = 0; j + 1 < k && j + 1 < steps; ++j) {
    const float ah = s.coeffs[j];
    const float al = s.coeffs[k + j];
    const float bph = j > 0 ? s.coeffs[2 * k + j - 1] : 0.0f;
    const float bpl = j > 0 ? s.coeffs[3 * k + j - 1] : 0.0f;
    const float bjh = s.coeffs[2 * k + j];
    const float bjl = s.coeffs[3 * k + j];
    const float2 ib = df_scalar_recip(bjh > 0.0f ? bjh : 1.0f, bjl);
    const float ynh = s.y2[j + 1];
    const float ynl = s.y2[k + j + 1];
    const DFPairCachedLoad vld{cur};
    a.clock.stamp(j, 0);
    // df_step_kernel's update of element i, given row i of w = A v
    const auto update = [&](int i, float2 wi) {
      const float2 vi = vld(i);
      const float2 vpi = __ldca(prev + i);
      float2 w = df_axpy(wi.x, wi.y, bph, bpl, vpi.x, vpi.y);
      w = df_axpy(w.x, w.y, ah, al, vi.x, vi.y);
      const float2 vn = df_scale(w.x, w.y, ib.x, ib.y);
      const float2 pr = df_prod(vn.x, vn.y, ynh, ynl);
      const float2 xi = __ldca(x + i);
      x[i] = df_add2(xi.x, xi.y, pr.x, pr.y);
      prev[i] = vn;
    };
    // K11's blocks as virtual blocks: this block's share of the node rows
    // (the heavy ones) first, then its share of the arc blocks; each row of
    // A v is updated where it is formed
    const Share nodes = share_of(s.p);
    for (int node = nodes.begin; node < nodes.end; ++node) {
      const float2 total = df_kkt_node_row(s.ptr, s.ent, node, sh, sl, vld);
      if (threadIdx.x == 0) update(m + node, total);
    }
    a.clock.stamp(j, 1);
    const Share arcs = share_of(s.arc_blocks);
    for (int ab = arcs.begin; ab < arcs.end; ++ab) {
      const int i = ab * kThreads + threadIdx.x;
      if (i < m) {
        const float2 xi = vld(i);
        const float2 gu = vld(m + s.u[i]);
        const float2 gv = vld(m + s.v[i]);
        update(i, df_kkt_arc_row(s.d2[i], s.d2[m + i], xi.x, xi.y, gu.x,
                                 gu.y, gv.x, gv.y));
      }
    }
    a.clock.stamp(j, 2);
    grid_sync();
    a.clock.stamp(j, 3);
    float2* const t = prev;
    prev = cur;
    cur = t;
  }
  // x and the state in planes, named as the caller reads them (v_curr2
  // holds v_{steps_taken})
  for (int i = first; i < n; i += stride) {
    const float2 xi = __ldca(x + i);
    const float2 vpi = __ldca(prev + i);
    const float2 vci = __ldca(cur + i);
    s.x2[i] = xi.x;
    s.x2[n + i] = xi.y;
    s.vp2[i] = vpi.x;
    s.vp2[n + i] = vpi.y;
    s.vc2[i] = vci.x;
    s.vc2[n + i] = vci.y;
  }
}

// K10's cooperative launch, built with the phase timer or without it.
template <typename Clock>
cudaError_t launch_pass_two(const DFPassTwo& s, Clock clock,
                            cudaStream_t stream) {
  return launch_persistent(df_pass_two_persistent_kernel<Clock>,
                           DFPersistentTwo<Clock>{s, clock}, stream,
                           kDFPersistentBlocksPerSM);
}

}  // namespace
}  // namespace tpl

// All pointers are device pointers except matvec_launches (host). Common
// arguments: the layout (as tpl_df_lanczos_pass_one), b2 (2 x n), k, the
// zero-b tolerance, pass one's coeffs (4 x k), y2 (2 x k: y hi, y lo, zero
// beyond steps_taken, scaled by ||b||), bnorm2 (2), steps (1). Output: x2
// (2 x n). Scratch: v_prev2, v_curr2 (2 x n each); on return v_curr2 holds
// v_{steps_taken}. Each entry point allocates nothing and does not
// synchronise; it returns the error of its launches.

// K10: one cooperative launch, on pairs inside. Scratch besides: pairs (3 x
// n pairs: v_prev, v_curr, x). clock: the phase timer's stamps ((8, grid,
// 4) int64, tpl::PhaseClock), or nullptr (every solve: the build without
// the timer). *matvec_launches counts the k - 1 matvec phases of the
// launch, each gated on steps_taken.
extern "C" int tpl_df_lanczos_pass_two(
    const float* d2, const int* u, const int* v, const int* ptr,
    const int* ent, int m, int p, const float* b2, int k, float ztol,
    const float* coeffs, const float* y2, const float* bnorm2,
    const int* steps, float* x2, float* v_prev2, float* v_curr2,
    float* pairs, long long* clock, int* matvec_launches,
    cudaStream_t stream) {
  using namespace tpl;
  *matvec_launches = 0;
  const DFPassTwo s{d2, u, v, ptr, ent, m, p, m + p, k,
                    (m + kThreads - 1) / kThreads, ztol, b2, coeffs,
                    y2, bnorm2, steps, x2, v_prev2, v_curr2,
                    reinterpret_cast<float2*>(pairs)};
  const cudaError_t err =
      clock == nullptr
          ? launch_pass_two(s, NoClock{}, stream)
          : launch_pass_two(s, PhaseClock{clock, k / 2, 4}, stream);
  if (err == cudaSuccess) *matvec_launches = k - 1;
  return static_cast<int>(err);
}

// K10's cooperative grid: resident blocks per SM and SMs (the build with the
// timer runs on the same grid: both reach kDFPersistentBlocksPerSM).
extern "C" int tpl_df_lanczos_pass_two_grid(int* blocks_per_sm, int* sms) {
  return static_cast<int>(tpl::persistent_grid(
      tpl::df_pass_two_persistent_kernel<tpl::NoClock>, blocks_per_sm, sms,
      tpl::kDFPersistentBlocksPerSM));
}

// The two launches a step that K10 replaced (the K11 matvec, then
// df_step_kernel), the reference K10 is held to; no solve calls it.
// Scratch besides: w2 (2 x n). *matvec_launches counts its k - 1 K11
// launches, each gated on steps_taken.
extern "C" int tpl_df_lanczos_pass_two_steps(
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
