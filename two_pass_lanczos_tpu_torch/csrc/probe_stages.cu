// K14c: K7, one shard's KKT matvec (kkt_shard_matvec.cu), with its stages
// switched at run time, and with extra ALU or gather work per arc.
//
// Replaces the Pallas stage probes: stream_stages.py's kern
// (scripts/probe/stream_stages.py:29/98: the production streaming kernel
// with the gather and the scatter each switchable, modes full, no_go,
// no_gather, stream_only) and stream_overlap.py's kern
// (scripts/probe/stream_overlap.py:70/112: extra ALU work or gathers per
// arc, to see whether they hide under the stream). Here the stages are
// K7's on the port's layout:
//   full            K7 exactly: the arc blocks, then one block per node,
//                   through lanczos_common.cuh's kkt_arc_row and
//                   kkt_node_row; bitwise K7;
//   arc_only        the arc blocks alone (y_n not written);
//   node_only       the node blocks alone (y_a not written);
//   node_no_gather  the node blocks alone, each entry's x_a[a] replaced by
//                   1e-30 * float(a): the CSR walk without its gather;
//   no_gather       both parts with every gather replaced by
//                   1e-30 * float(index);
//   stream_only     y_a = d * x_a, nothing else;
//   alu N           full, plus N chained multiply-adds per arc on a
//                   register value folded into y_a at 1e-30;
//   gather G        full, plus G more gathers of x_n per arc (at
//                   u + 1, ..., u + G, wrapped at p) folded into y_a at
//                   1e-30.
// The split answers which stage bounds K7 at 5M arcs: the arc stream
// (d, u, v, x_a in, y_a out, x_n gathered from a 14.6 KB table) or the node
// blocks' scattered reads of x_a.
//
// What bounds it on the H100: K7's function, 20 m + 8 p bytes over HBM.
#include "probe_common.cuh"

namespace tpl {
namespace {

enum StagesMode {
  kFull = 0,
  kArcOnly = 1,
  kNodeOnly = 2,
  kNodeNoGather = 3,
  kNoGather = 4,
  kStreamOnly = 5,
  kAlu = 6,
  kGather = 7,
};
// the ALU chain's step, r = r * kAluMul + kAluAdd, rounded after each
constexpr float kAluMul = 0.999f;
constexpr float kAluAdd = 1e-3f;

__device__ __forceinline__ float node_row_no_gather(const int* __restrict__ ptr,
                                                    const int* __restrict__ ent,
                                                    int node, float* sh) {
  const int end = ptr[node + 1];
  float acc = 0.0f;
  for (int q = ptr[node] + threadIdx.x; q < end; q += kThreads) {
    const int a = ent[q];
    acc = a >= 0 ? __fadd_rn(acc, __fmul_rn(kTiny, __int2float_rn(a)))
                 : __fsub_rn(acc, __fmul_rn(kTiny, __int2float_rn(~a)));
  }
  return block_sum(acc, sh);
}

__global__ void __launch_bounds__(kThreads)
probe_stages_kernel(const float* __restrict__ d, const int* __restrict__ u,
                    const int* __restrict__ v, const int* __restrict__ ptr,
                    const int* __restrict__ ent, int m, int p,
                    int arc_blocks, float e, const float* __restrict__ x,
                    float* __restrict__ y, int mode, int param) {
  __shared__ float sh[kThreads];
  const float* xn = x + m;
  if (static_cast<int>(blockIdx.x) < arc_blocks) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j >= m) return;  // arc blocks never reach block_sum
    if (mode == kStreamOnly) {
      y[j] = __fmul_rn(d[j], x[j]);
      return;
    }
    if (mode == kNoGather) {
      y[j] = kkt_arc_row(d[j], x[j],
                         __fmul_rn(e, __fmul_rn(kTiny, __int2float_rn(u[j]))),
                         __fmul_rn(e, __fmul_rn(kTiny, __int2float_rn(v[j]))));
      return;
    }
    const int uj = u[j];
    float yj = kkt_arc_row(d[j], x[j], __fmul_rn(e, __ldg(xn + uj)),
                           __fmul_rn(e, __ldg(xn + v[j])));
    if (mode == kAlu) {
      float r = x[j];
      for (int i = 0; i < param; ++i)
        r = __fadd_rn(__fmul_rn(r, kAluMul), kAluAdd);
      yj = __fadd_rn(yj, __fmul_rn(kTiny, r));
    } else if (mode == kGather) {
      float acc = 0.0f;
      for (int g = 1; g <= param; ++g) {
        int t = uj + g;
        if (t >= p) t -= p;
        acc = __fadd_rn(acc, __ldg(xn + t));
      }
      yj = __fadd_rn(yj, __fmul_rn(kTiny, acc));
    }
    y[j] = yj;
    return;
  }
  const int node = blockIdx.x - arc_blocks;
  const float total = (mode == kNoGather || mode == kNodeNoGather)
                          ? node_row_no_gather(ptr, ent, node, sh)
                          : kkt_node_row(ptr, ent, x, node, sh);
  if (threadIdx.x == 0) y[m + node] = __fmul_rn(e, total);
}

}  // namespace
}  // namespace tpl

// K7's arguments (one shard's layout, e_scale, x, y; kkt_shard_matvec.cu),
// then mode (StagesMode) and its param (N for alu, G < p for gather).
// A mode without arc blocks leaves y_a unwritten, one without node blocks
// y_n. Device pointers; does not synchronise; returns cudaGetLastError().
extern "C" int tpl_probe_stages(const float* d, const int* u, const int* v,
                                const int* ptr, const int* ent, int m, int p,
                                float e_scale, const float* x, float* y,
                                int mode, int param, cudaStream_t stream) {
  if (mode < tpl::kFull || mode > tpl::kGather || param < 0
      || (mode == tpl::kGather && param >= p))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool arcs = mode != tpl::kNodeOnly && mode != tpl::kNodeNoGather;
  const bool nodes = mode != tpl::kArcOnly && mode != tpl::kStreamOnly;
  const int arc_blocks = arcs ? (m + tpl::kThreads - 1) / tpl::kThreads : 0;
  const int grid = arc_blocks + (nodes ? p : 0);
  tpl::probe_stages_kernel<<<grid, tpl::kThreads, 0, stream>>>(
      d, u, v, ptr, ent, m, p, arc_blocks, e_scale, x, y, mode, param);
  return static_cast<int>(cudaGetLastError());
}
