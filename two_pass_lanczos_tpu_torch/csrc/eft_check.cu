// K13: the tripwire of the error-free transformations.
//
// Replaces the inline test kernel `kern` of tests/test_fused_df.py:274
// (launched at :286), which pinned _two_sum_k,
// _two_prod and _df_add2 through the interpret-mode XLA CPU pipeline. Here
// it applies the header's two_sum, two_prod and df_add2 (lanczos_common.cuh)
// elementwise, compiled in the same library with the same flags as the
// compensated reductions, so a build that contracts or reorders them (an
// FMA where an intrinsic was meant, --use_fast_math) shows as a zero error
// term. FusedKKTSolver(compensated=True) runs it once on the card before it
// trusts the compensated build; the expected values are exact.
//
// What bounds it: its launch. 128 elements are one block's few elementwise
// operations each; a check, not a hot path. tpl_empty_launch (below), a
// kernel that does nothing, is timed beside it as the launch floor
// (chip_smoke.py phase 19, PERF.md §6 row 13).
#include "lanczos_common.cuh"

namespace tpl {
namespace {

__global__ void __launch_bounds__(kThreads)
eft_check_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 int n, float* __restrict__ out) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float2 s = two_sum(a[i], b[i]);
    const float2 pr = two_prod(a[i], a[i]);
    const float2 df = df_add2(a[i], 0.0f, b[i], 0.0f);
    out[0 * n + i] = s.x;
    out[1 * n + i] = s.y;
    out[2 * n + i] = pr.x;
    out[3 * n + i] = pr.y;
    out[4 * n + i] = df.x;
    out[5 * n + i] = df.y;
  }
}

// Does nothing: one launch of it is the floor under any kernel's time, the
// yardstick beside K13's (a launch's fixed cost, not a TPU kernel's port).
__global__ void empty_kernel() {}

}  // namespace
}  // namespace tpl

// a, b (n) and out (6 x n, row-major) are device pointers. Rows of out:
// two_sum(a, b) = (s, e), two_prod(a, a) = (p, e), df_add2((a, 0), (b, 0)) =
// (hi, lo). Does not synchronise; returns cudaGetLastError().
extern "C" int tpl_eft_check(const float* a, const float* b, int n,
                             float* out, cudaStream_t stream) {
  using namespace tpl;
  int g = (n + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  eft_check_kernel<<<g, kThreads, 0, stream>>>(a, b, n, out);
  return static_cast<int>(cudaGetLastError());
}

// One block of one thread that does nothing, on stream. Does not
// synchronise; returns cudaGetLastError().
extern "C" int tpl_empty_launch(cudaStream_t stream) {
  tpl::empty_kernel<<<1, 1, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
