// K1 and K8: one y = A x of the KKT matrix A = [[D, E^T], [E, 0]], for
// T = float (K1, and K8 in f32) or double (K8 in f64).
//
// Replaces two TPU kernels that compute the same function:
// * _matvec_kernel (two_pass_lanczos_tpu/ops/kkt_fused.py:924; body
//   _emit_matvec :397 with _group_self_tile :379, _window_gather :332 and
//   _rowwise_window_gather :350), the matvec inside the fused passes. The
//   TPU has no hardware gather and a serial scatter, so it kept two sorted
//   copies of the arcs padded to 128 lanes and built both gathers from lane
//   selects;
// * _kkt_kernel (two_pass_lanczos_tpu/ops/spmv_pallas.py:52, launched by
//   _kkt_pallas_padded :147), the matvec of PallasKKTOperator under the
//   generic solvers. It pads the arcs to a multiple of 2048, gathers with a
//   per-lane dynamic_gather from a (128, ceil(p/128)) node table, and
//   scatters through one-hot MXU contractions with an exact bf16x3 split,
//   accumulated in VMEM across a sequential grid.
// Hopper gathers natively and scatters deterministically with a sorted
// walk, so one kernel serves both, with the arcs in their original order:
//   arc part   y_a[j] = (d[j] * x_a[j] + x_n[u[j]]) - x_n[v[j]]
//              one thread per arc; the node table (4.6 KB in f32 at 1,155
//              nodes) stays in L1/L2 and is read through the read-only path;
//   node part  y_n[i] = sum over node i's incidence entries of +-x_a[arc]
//              one warp per node (kkt_node_row_warp) walks its CSR segment
//              (ptr/ent, entry ~a means arc a with sign -1) in a fixed
//              strided order and folds it with block_sum's fixed tree:
//              deterministic, no atomics. A degree-0 node gives 0; a hub
//              node is just a longer strided loop.
// Both parts are one launch: ceil(p / 8) node blocks of 8 warp rows each,
// numbered before the arc blocks, so that the longest jobs start first
// (numbered after them, as the block rows were, K1 took 0.0156 ms against
// 0.0124 on the H100; PERF.md §6); the bits are the same either way.
// Every operation is an explicit round-to-nearest intrinsic (add_rn,
// sub_rn, mul_rn), so nvcc contracts nothing differently between pass one
// and pass two; the float instance is the same arithmetic as the
// untemplated K1 it replaced.
//
// The warp row is bitwise the block row it replaced (kkt_node_row: one
// block of 256 threads a node, the node blocks after the arc blocks). That
// kernel stays as the reference, the BlockRows instance, which only the
// entry points tpl_kkt_matvec_blockrows{,_f64} reach (chip_smoke.py and the
// card tests hold K1 and K8 to it bit for bit).
//
// What bounds it on the H100: at the headline size (m = 500,000, p = 1,155)
// one f32 matvec reads d, u, v, ent and x (~14 MB) and writes y (2 MB), the
// f64 one ~20 MB. That fits in the 50 MB L2 with the rest of the Lanczos
// state, so within a pass it is bound by L2 bandwidth and by launch latency,
// not by HBM. The design keeps it to one launch and one pass over each
// array; the arc part's reads and writes are coalesced, the node part's x_a
// reads are gathers.
#include "lanczos_common.cuh"

namespace tpl {


// BlockRows: the reference, one block row (kkt_node_row) a node, the node
// blocks after the arc blocks. Otherwise K1/K8: 8 warp rows a node block.
template <typename T, bool BlockRows>
__global__ void __launch_bounds__(kThreads)
kkt_matvec_kernel(const T* __restrict__ d, const int* __restrict__ u,
                  const int* __restrict__ v, const int* __restrict__ ptr,
                  const int* __restrict__ ent, int m, int p, int arc_blocks,
                  int node_blocks, const T* __restrict__ x,
                  T* __restrict__ y, const int* __restrict__ gate,
                  int gate_lt) {
  if (gate != nullptr && !(gate_lt < *gate)) return;
  const T* xn = x + m;
  const bool first = !BlockRows;  // the longest jobs first
  const int b = blockIdx.x;
  const int nb = first ? b : b - arc_blocks;  // node block, if in range
  if (nb < 0 || nb >= node_blocks) {
    const int j = (first ? b - node_blocks : b) * kThreads + threadIdx.x;
    if (j < m)
      y[j] = kkt_arc_row(d[j], x[j], __ldg(xn + u[j]), __ldg(xn + v[j]));
    return;  // block-uniform: arc blocks never reach a node row
  }
  if constexpr (BlockRows) {
    __shared__ T sh[kThreads];
    const T total = kkt_node_row(ptr, ent, x, nb, sh);
    if (threadIdx.x == 0) y[m + nb] = total;
  } else {
    const int node = nb * kWarps + threadIdx.x / kWarpSize;
    if (node >= p) return;  // warp-uniform
    const T total = kkt_node_row_warp(ptr, ent, x, node);
    if (threadIdx.x % kWarpSize == 0) y[m + node] = total;
  }
}

template <typename T, bool BlockRows>
cudaError_t launch_rows(const T* d, const int* u, const int* v,
                        const int* ptr, const int* ent, int m, int p,
                        const T* x, T* y, const int* gate, int gate_lt,
                        cudaStream_t stream) {
  const int arc_blocks = (m + kThreads - 1) / kThreads;
  const int node_blocks = BlockRows ? p : (p + kWarps - 1) / kWarps;
  kkt_matvec_kernel<T, BlockRows>
      <<<arc_blocks + node_blocks, kThreads, 0, stream>>>(
          d, u, v, ptr, ent, m, p, arc_blocks, node_blocks, x, y, gate,
          gate_lt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kkt_matvec(const T* d, const int* u, const int* v,
                              const int* ptr, const int* ent, int m, int p,
                              const T* x, T* y, const int* gate, int gate_lt,
                              cudaStream_t stream) {
  return launch_rows<T, false>(d, u, v, ptr, ent, m, p, x, y, gate, gate_lt,
                               stream);
}

template cudaError_t launch_kkt_matvec<float>(
    const float*, const int*, const int*, const int*, const int*, int, int,
    const float*, float*, const int*, int, cudaStream_t);
template cudaError_t launch_kkt_matvec<double>(
    const double*, const int*, const int*, const int*, const int*, int, int,
    const double*, double*, const int*, int, cudaStream_t);

}  // namespace tpl

extern "C" int tpl_kkt_matvec(const float* d, const int* u, const int* v,
                              const int* ptr, const int* ent, int m, int p,
                              const float* x, float* y, cudaStream_t stream) {
  return static_cast<int>(tpl::launch_kkt_matvec(d, u, v, ptr, ent, m, p, x,
                                                 y, nullptr, 0, stream));
}

extern "C" int tpl_kkt_matvec_f64(const double* d, const int* u,
                                  const int* v, const int* ptr,
                                  const int* ent, int m, int p,
                                  const double* x, double* y,
                                  cudaStream_t stream) {
  return static_cast<int>(tpl::launch_kkt_matvec(d, u, v, ptr, ent, m, p, x,
                                                 y, nullptr, 0, stream));
}

// The reference: the block-row kernel K1 and K8 replaced, bitwise theirs.
extern "C" int tpl_kkt_matvec_blockrows(const float* d, const int* u,
                                        const int* v, const int* ptr,
                                        const int* ent, int m, int p,
                                        const float* x, float* y,
                                        cudaStream_t stream) {
  return static_cast<int>(tpl::launch_rows<float, true>(
      d, u, v, ptr, ent, m, p, x, y, nullptr, 0, stream));
}

extern "C" int tpl_kkt_matvec_blockrows_f64(const double* d, const int* u,
                                            const int* v, const int* ptr,
                                            const int* ent, int m, int p,
                                            const double* x, double* y,
                                            cudaStream_t stream) {
  return static_cast<int>(tpl::launch_rows<double, true>(
      d, u, v, ptr, ent, m, p, x, y, nullptr, 0, stream));
}

extern "C" const char* tpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
