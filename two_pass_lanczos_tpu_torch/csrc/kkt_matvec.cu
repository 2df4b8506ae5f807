// K1: one y = A x of the KKT matrix A = [[D, E^T], [E, 0]].
//
// Replaces the TPU kernel _matvec_kernel (two_pass_lanczos_tpu/ops/
// kkt_fused.py:924; body _emit_matvec :397 with _group_self_tile :379,
// _window_gather :332 and _rowwise_window_gather :350). The TPU has no
// hardware gather and a serial scatter, so it kept two sorted copies of the
// arcs padded to 128 lanes and built both gathers from lane selects. Hopper
// gathers natively, so the port keeps the arcs in their original order:
//   arc part   y_a[j] = (d[j] * x_a[j] + x_n[u[j]]) - x_n[v[j]]
//              one thread per arc; the node table (4.6 KB at 1,155 nodes)
//              stays in L1/L2 and is read through the read-only path;
//   node part  y_n[i] = sum over node i's incidence entries of +-x_a[arc]
//              one block per node walks its CSR segment (ptr/ent, entry
//              ~a means arc a with sign -1) in a fixed strided order and
//              folds it with the fixed tree of block_sum: deterministic, no
//              atomics. A degree-0 node gives 0; a hub node is just a
//              longer strided loop.
// Both parts are one launch: blocks [0, arc_blocks) are arc blocks, the
// next p blocks are node blocks.
//
// What bounds it on the H100: at the headline size (m = 500,000, p = 1,155)
// one matvec reads d, u, v, ent and x (~14 MB) and writes y (2 MB). That
// fits in the 50 MB L2 with the rest of the Lanczos state, so within a pass
// it is bound by L2 bandwidth and by launch latency, not by HBM. The design
// keeps it to one launch and one pass over each array; the arc part's
// reads and writes are coalesced, the node part's x_a reads are gathers.
#include "lanczos_common.cuh"

namespace tpl {

__global__ void __launch_bounds__(kThreads)
kkt_matvec_kernel(const float* __restrict__ d, const int* __restrict__ u,
                  const int* __restrict__ v, const int* __restrict__ ptr,
                  const int* __restrict__ ent, int m, int arc_blocks,
                  const float* __restrict__ x, float* __restrict__ y,
                  const int* __restrict__ gate, int gate_lt) {
  if (gate != nullptr && !(gate_lt < *gate)) return;
  __shared__ float sh[kThreads];
  const float* xn = x + m;
  if (blockIdx.x < arc_blocks) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j < m) {
      float t = __fmul_rn(d[j], x[j]);
      t = __fadd_rn(t, __ldg(xn + u[j]));
      y[j] = __fsub_rn(t, __ldg(xn + v[j]));
    }
    return;  // block-uniform: arc blocks never reach block_sum
  }
  const int node = blockIdx.x - arc_blocks;
  const int end = ptr[node + 1];
  float acc = 0.0f;
  for (int q = ptr[node] + threadIdx.x; q < end; q += kThreads) {
    const int a = ent[q];
    acc = a >= 0 ? __fadd_rn(acc, x[a]) : __fsub_rn(acc, x[~a]);
  }
  const float total = block_sum(acc, sh);
  if (threadIdx.x == 0) y[m + node] = total;
}

cudaError_t launch_kkt_matvec(const float* d, const int* u, const int* v,
                              const int* ptr, const int* ent, int m, int p,
                              const float* x, float* y, const int* gate,
                              int gate_lt, cudaStream_t stream) {
  const int arc_blocks = (m + kThreads - 1) / kThreads;
  kkt_matvec_kernel<<<arc_blocks + p, kThreads, 0, stream>>>(
      d, u, v, ptr, ent, m, arc_blocks, x, y, gate, gate_lt);
  return cudaGetLastError();
}

}  // namespace tpl

extern "C" int tpl_kkt_matvec(const float* d, const int* u, const int* v,
                              const int* ptr, const int* ent, int m, int p,
                              const float* x, float* y, cudaStream_t stream) {
  return static_cast<int>(tpl::launch_kkt_matvec(d, u, v, ptr, ent, m, p, x,
                                                 y, nullptr, 0, stream));
}

extern "C" const char* tpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
