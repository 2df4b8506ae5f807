// K14c: K7, one shard's KKT matvec (kkt_shard_matvec.cu), with its stages
// switched, and with extra ALU or gather work per arc.
//
// Replaces the Pallas stage probes: stream_stages.py's kern
// (scripts/probe/stream_stages.py:29/98: the production streaming kernel
// with the gather and the scatter each switchable, modes full, no_go,
// no_gather, stream_only) and stream_overlap.py's kern
// (scripts/probe/stream_overlap.py:70/112: extra ALU work or gathers per
// arc, to see whether they hide under the stream). Here the stages are
// K7's, in K7's block order: ceil(p / 8) node blocks of 8 warp rows
// (lanczos_common.cuh's kkt_node_row_warp) numbered first, then the arc
// blocks (kkt_arc_row), one thread an arc. Each stage is its own instance
// of the kernel (template <int Mode>), so no thread branches on the stage
// at run time and `full` compiles to K7's instruction stream:
//   full            K7 exactly; bitwise K7;
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
//                   1e-30;
//   node_sorted     the node blocks alone on a node-sorted signed copy
//                   xs[q] = +-x_a[arc of ent[q]] (built by the wrapper
//                   before the launch) read through the identity index
//                   q: node_only's instruction stream with its x_a gather
//                   made contiguous, a 128-byte line per 32 entries of a
//                   warp. Its y_n is bitwise full's (x - y == x + (-y) in
//                   IEEE arithmetic). It keeps the index read, as a
//                   relabelled layout keeps ent for its other endpoint.
// The split answers which stage bounds K7: the arc stream (d, u, v, x_a
// in, y_a out, x_n gathered from a 4.6 or 14.6 KB table) or the node
// blocks' scattered reads of x_a, and node_sorted bounds from above what an
// arc relabelling (each node's entries of one endpoint contiguous in x_a)
// could give the node walk.
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
  kNodeSorted = 8,
};
template <int Mode>
__host__ __device__ constexpr bool has_arcs() {
  return Mode != kNodeOnly && Mode != kNodeNoGather && Mode != kNodeSorted;
}
template <int Mode>
__host__ __device__ constexpr bool has_nodes() {
  return Mode != kArcOnly && Mode != kStreamOnly;
}

template <int Mode>
__global__ void __launch_bounds__(kThreads)
probe_stages_kernel(const float* __restrict__ d, const int* __restrict__ u,
                    const int* __restrict__ v, const int* __restrict__ ptr,
                    const int* __restrict__ ent, int m, int p,
                    int node_blocks, float e, const float* __restrict__ x,
                    float* __restrict__ y, int param) {
  const float* xn = x + m;
  const int b = blockIdx.x;
  if (b >= node_blocks) {  // block-uniform: an arc block
    if constexpr (has_arcs<Mode>()) {
      const int j = (b - node_blocks) * kThreads + threadIdx.x;
      if (j >= m) return;
      if constexpr (Mode == kStreamOnly) {
        y[j] = __fmul_rn(d[j], x[j]);
      } else if constexpr (Mode == kNoGather) {
        y[j] = kkt_arc_row(
            d[j], x[j], __fmul_rn(e, __fmul_rn(kTiny, __int2float_rn(u[j]))),
            __fmul_rn(e, __fmul_rn(kTiny, __int2float_rn(v[j]))));
      } else {
        const int uj = u[j];
        float yj = kkt_arc_row(d[j], x[j], __fmul_rn(e, __ldg(xn + uj)),
                               __fmul_rn(e, __ldg(xn + v[j])));
        if constexpr (Mode == kAlu) {
          float r = x[j];
          for (int i = 0; i < param; ++i)
            r = __fadd_rn(__fmul_rn(r, kAluMul), kAluAdd);
          yj = __fadd_rn(yj, __fmul_rn(kTiny, r));
        } else if constexpr (Mode == kGather) {
          float acc = 0.0f;
          for (int g = 1; g <= param; ++g) {
            int t = uj + g;
            if (t >= p) t -= p;
            acc = __fadd_rn(acc, __ldg(xn + t));
          }
          yj = __fadd_rn(yj, __fmul_rn(kTiny, acc));
        }
        y[j] = yj;
      }
    }
    return;
  }
  if constexpr (has_nodes<Mode>()) {
    const int node = b * kWarps + threadIdx.x / kWarpSize;
    if (node >= p) return;  // warp-uniform
    float total;
    if constexpr (Mode == kNoGather || Mode == kNodeNoGather)
      total = kkt_node_row_warp(ptr, ent, x, node, IndexAsValue{x});
    else
      total = kkt_node_row_warp(ptr, ent, x, node);
    if (threadIdx.x % kWarpSize == 0) y[m + node] = __fmul_rn(e, total);
  }
}

template <int Mode>
int launch(const float* d, const int* u, const int* v, const int* ptr,
           const int* ent, int m, int p, float e, const float* x, float* y,
           int param, cudaStream_t stream) {
  const int arc_blocks = has_arcs<Mode>() ? (m + kThreads - 1) / kThreads : 0;
  const int node_blocks = has_nodes<Mode>() ? (p + kWarps - 1) / kWarps : 0;
  probe_stages_kernel<Mode><<<node_blocks + arc_blocks, kThreads, 0, stream>>>(
      d, u, v, ptr, ent, m, p, node_blocks, e, x, y, param);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpl

// K7's arguments (one shard's layout, e_scale, x, y; kkt_shard_matvec.cu),
// then mode (StagesMode) and its param (N for alu, G < p for gather).
// For node_sorted, ent is the identity 0 .. 2m - 1 and x the signed copy
// xs (2m floats); y is still (m + p). A mode without arc blocks leaves y_a
// unwritten, one without node blocks y_n. Device pointers; does not
// synchronise; returns cudaGetLastError().
extern "C" int tpl_probe_stages(const float* d, const int* u, const int* v,
                                const int* ptr, const int* ent, int m, int p,
                                float e_scale, const float* x, float* y,
                                int mode, int param, cudaStream_t stream) {
  if (param < 0 || (mode == tpl::kGather && param >= p))
    return static_cast<int>(cudaErrorInvalidValue);
#define TPL_STAGE(M)                                                        \
  case tpl::M:                                                              \
    return tpl::launch<tpl::M>(d, u, v, ptr, ent, m, p, e_scale, x, y,     \
                               param, stream)
  switch (mode) {
    TPL_STAGE(kFull);
    TPL_STAGE(kArcOnly);
    TPL_STAGE(kNodeOnly);
    TPL_STAGE(kNodeNoGather);
    TPL_STAGE(kNoGather);
    TPL_STAGE(kStreamOnly);
    TPL_STAGE(kAlu);
    TPL_STAGE(kGather);
    TPL_STAGE(kNodeSorted);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPL_STAGE
}
