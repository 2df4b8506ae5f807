// K11: one double-float y = A x of the KKT matrix A = [[D, E^T], [E, 0]].
//
// Replaces _df_matvec_kernel (two_pass_lanczos_tpu/ops/kkt_fused_df.py:673,
// launched by df_kkt_matvec :684), whose body _df_emit_matvec (:167) /
// _df_chunk_matvec_scatter (:197) also runs inside the df passes K9 and K10.
// The TPU kept two sorted copies of the arcs padded to 128 lanes, built its
// gathers from windowed lane selects and scattered through masked row folds
// into 256-node windows. Hopper gathers natively, so this kernel works on
// the f32 solver's layout (arcs in their original order plus the
// node-sorted incidence CSR ptr/ent, ops/kkt_fused.py KKTLayout) with d as
// a (2, m) hi/lo pair:
//   arc part   one thread per arc j, in the order of :219-222:
//              (p, e) = d_j (x) x_j, the exact product with cross terms;
//              t = x_n[u_j] (-) x_n[v_j] (df_add2 of the gathered pairs,
//              which move hi and lo unchanged); y_j = df_add2(p, e, t);
//   node part  one block per node walks its CSR segment in a fixed strided
//              order, each thread folding +-x_a[arc] with df_add2, then the
//              fixed tree of block_sum2: a compensated segmented sum with
//              no atomics, deterministic run to run.
// Both parts are one launch, as K1. The arc part rounds exactly as the
// plain version (algorithms/df.py DFKKTOperator.plain_matvec_df, whose
// product is the exact two_prod of ops/eft.py); the node part folds in
// another order than the plain pairwise table fold.
//
// What bounds it on the H100: at the headline (m = 500,000, p = 1,155) the
// function moves d, u, v, x and y once, 32 m + 16 p bytes = 16.0 MB, and
// does ~50 f32 operations per arc; the layout adds the CSR (8 m + 4 p
// bytes). Everything stays in the 50 MB L2 inside a pass, so it is bound by
// L2 bandwidth and launch latency; one launch, coalesced arc reads and
// writes, gathers for the node part.
#include "df_common.cuh"

namespace tpl {
namespace {

__global__ void __launch_bounds__(kThreads)
df_kkt_matvec_kernel(const float* __restrict__ d2, const int* __restrict__ u,
                     const int* __restrict__ v, const int* __restrict__ ptr,
                     const int* __restrict__ ent, int m, int n,
                     int arc_blocks, const float* __restrict__ x2,
                     float* __restrict__ y2, const int* __restrict__ gate,
                     int gate_lt) {
  if (gate != nullptr && !(gate_lt < *gate)) return;
  __shared__ float sh[kThreads];
  __shared__ float sl[kThreads];
  const float* xh = x2;
  const float* xl = x2 + n;
  if (blockIdx.x < arc_blocks) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j < m) {
      const int a = m + u[j];
      const int b = m + v[j];
      const float2 pr = df_prod(d2[j], d2[m + j], xh[j], xl[j]);
      const float2 t = df_add2(__ldg(xh + a), __ldg(xl + a), -__ldg(xh + b),
                               -__ldg(xl + b));
      const float2 y = df_add2(pr.x, pr.y, t.x, t.y);
      y2[j] = y.x;
      y2[n + j] = y.y;
    }
    return;  // block-uniform: arc blocks never reach block_sum2
  }
  const int node = blockIdx.x - arc_blocks;
  const int end = ptr[node + 1];
  float2 acc = make_float2(0.0f, 0.0f);
  for (int q = ptr[node] + threadIdx.x; q < end; q += kThreads) {
    const int a = ent[q];
    acc = a >= 0 ? df_add2(acc.x, acc.y, xh[a], xl[a])
                 : df_add2(acc.x, acc.y, -xh[~a], -xl[~a]);
  }
  const float2 total = block_sum2(acc, sh, sl);
  if (threadIdx.x == 0) {
    y2[m + node] = total.x;
    y2[n + m + node] = total.y;
  }
}

}  // namespace

cudaError_t launch_df_kkt_matvec(const float* d2, const int* u, const int* v,
                                 const int* ptr, const int* ent, int m, int p,
                                 const float* x2, float* y2, const int* gate,
                                 int gate_lt, cudaStream_t stream) {
  const int arc_blocks = (m + kThreads - 1) / kThreads;
  df_kkt_matvec_kernel<<<arc_blocks + p, kThreads, 0, stream>>>(
      d2, u, v, ptr, ent, m, m + p, arc_blocks, x2, y2, gate, gate_lt);
  return cudaGetLastError();
}

}  // namespace tpl

// d2 (2 x m), x2 and y2 (2 x (m + p)) hold hi in row 0 and lo in row 1; all
// pointers are device pointers. Does not synchronise; returns
// cudaGetLastError().
extern "C" int tpl_df_kkt_matvec(const float* d2, const int* u, const int* v,
                                 const int* ptr, const int* ent, int m, int p,
                                 const float* x2, float* y2,
                                 cudaStream_t stream) {
  return static_cast<int>(tpl::launch_df_kkt_matvec(d2, u, v, ptr, ent, m, p,
                                                    x2, y2, nullptr, 0,
                                                    stream));
}
