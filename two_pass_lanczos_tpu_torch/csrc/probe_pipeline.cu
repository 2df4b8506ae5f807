// K14d: K7's matvec (kkt_shard_matvec.cu) with its arc stream fed by an
// explicit ring of bulk copies, and the modes of the JAX pipeline probe.
//
// Replaces stream_manual.py's man_kernel (scripts/probe/stream_manual.py:70,
// built at :194): the streaming matvec on a hand-built double-buffered DMA
// pipeline (make_async_copy and semaphores), which asked whether a
// hand-managed pipeline lets the arc stream overlap the compute where the
// compiler's grid pipeline was additive (modes man_full, man_stream,
// man_alu<N>, man_tiny<N>). The TPU layout (128-lane planes, int16 index
// planes, windowed gathers, a VMEM accumulator) is not carried over: the
// layout is K7's KKTLayout, arcs in their original order and the
// node-sorted CSR. Two kernels, launched side by side by the wrapper (one
// forked stream, joined back):
//   the arc kernel  a persistent grid (the blocks resident at once); each
//       block walks the tiles blockIdx.x, blockIdx.x + grid, ... of T arcs
//       through a ring of S stages in dynamic shared memory. A producer warp
//       of its own (one elected lane) waits for a stage's `empty` mbarrier,
//       arms its `full` mbarrier with expect_tx for the tile's bytes and
//       issues one bulk copy (cp.async.bulk, the TMA engine on a byte
//       range) per array: d, u, v and x_a, 4 T bytes each. Eight consumer
//       warps wait for the `full` barrier's parity, compute each arc from
//       the stage with K7's kkt_arc_row and x_n read through __ldg, and
//       arrive on `empty` once a warp is done with the stage. The phase
//       bit flips each time the ring wraps. A bulk copy needs 16-byte ends,
//       so a tile copies its multiple-of-4 body and the consumers read the
//       up to 3 tail words of the ragged last tile from global memory.
//       y_a is stored either directly by the consumers (store = direct,
//       coalesced) or as man_kernel's output DMAs did (store = bulk): the
//       consumers write the tile into an output stage, fence it for the
//       async proxy, meet at a named barrier, and one thread bulk-stores
//       the body; an output stage is rewritten only after
//       cp.async.bulk.wait_group.read has seen its last store read.
//   the node kernel  K7's node blocks: ceil(p / 8) blocks of 8 warp rows
//       (kkt_node_row_warp), no shared memory, so the ring's bytes never
//       limit them (dynamic shared memory is fixed for a whole launch: node
//       blocks in the arc launch would each carry the ring).
// Each mode is its own instance (template <int Mode>), and each is bitwise
// the K14c mode of the same name (probe_stages.cu): the same routines on
// the same values.
//   full         K7 exactly (man_full);
//   arc_only     the arc kernel alone, y_n not written;
//   stream_only  y_a = d * x_a, the ring carrying d and x_a only, no node
//                kernel (man_stream);
//   no_gather    every arc array through the ring, each gather replaced by
//                1e-30 * index, the node walk with IndexAsValue;
//   alu N        full, plus the chain r = r * 0.999 + 1e-3, N steps on x_a,
//                folded into y_a at 1e-30 (man_alu<N>; man_tiny<N> is the
//                same on a GPU, where a register chain never spills).
//
// What bounds it on the H100: K7's function, 20 m + 8 p bytes over HBM;
// the ring holds S x T x 16 bytes of arcs in flight per block (plus S x T
// x 4 of output stages with store = bulk), which sets the blocks per SM.
#include <cstdint>

#include "probe_common.cuh"

namespace tpl {
namespace {

enum PipelineMode {
  kFull = 0,
  kArcOnly = 1,
  kNoGather = 4,
  kStreamOnly = 5,
  kAlu = 6,
};
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * kWarpSize;  // 256
constexpr int kArcThreads = kConsumers + kWarpSize;     // + the producer warp
constexpr int kRingHeader = 128;  // the 2 S mbarriers (S <= 4), padded

template <int Mode>
__host__ __device__ constexpr bool has_nodes() {
  return Mode != kArcOnly && Mode != kStreamOnly;
}
// the arc kernel's instance of a mode (arc_only streams as full does) and
// the node kernel's (alu walks the nodes as full does)
template <int Mode>
__host__ __device__ constexpr int arc_kind() {
  return Mode == kArcOnly ? kFull : Mode;
}
template <int Mode>
__host__ __device__ constexpr int node_kind() {
  return Mode == kAlu ? kFull : Mode;
}
// arrays a stage holds: d, x_a for stream_only; d, u, v, x_a otherwise
template <int Mode>
__host__ __device__ constexpr int ring_arrays() {
  return Mode == kStreamOnly ? 2 : 4;
}
template <int Mode, int T, int S, bool Bulk>
constexpr size_t ring_bytes() {
  return kRingHeader + sizeof(float) * static_cast<size_t>(S) * T
                           * (ring_arrays<Mode>() + (Bulk ? 1 : 0));
}

__device__ __forceinline__ int tile_count(int m, long long base, int t) {
  const long long left = m - base;
  return left < t ? static_cast<int>(left) : t;
}

// the consumer warps' barrier (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

template <int Mode>
__device__ __forceinline__ float arc_row(float dj, float xj, int uj, int vj,
                                         const float* __restrict__ xn,
                                         float e, int param) {
  if constexpr (Mode == kNoGather) {
    return kkt_arc_row(
        dj, xj, __fmul_rn(e, __fmul_rn(kTiny, __int2float_rn(uj))),
        __fmul_rn(e, __fmul_rn(kTiny, __int2float_rn(vj))));
  } else {
    float yj = kkt_arc_row(dj, xj, __fmul_rn(e, __ldg(xn + uj)),
                           __fmul_rn(e, __ldg(xn + vj)));
    if constexpr (Mode == kAlu) {
      float r = xj;
      for (int i = 0; i < param; ++i)
        r = __fadd_rn(__fmul_rn(r, kAluMul), kAluAdd);
      yj = __fadd_rn(yj, __fmul_rn(kTiny, r));
    }
    return yj;
  }
}

template <int Mode, int T, int S, bool Bulk>
__global__ void __launch_bounds__(kArcThreads)
probe_pipeline_arcs(const float* __restrict__ d, const int* __restrict__ u,
                    const int* __restrict__ v, int m, float e,
                    const float* __restrict__ x, float* __restrict__ y,
                    int param) {
  constexpr int kArrays = ring_arrays<Mode>();
  constexpr int kPer = T / kConsumers;  // arcs a consumer takes a tile
  static_assert(T % kConsumers == 0 && S >= 2 && S <= 4, "ring shape");
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem + kRingHeader);
  const unsigned full = smem_addr(smem);  // stage s: full + 8 s
  const unsigned empty = full + 8 * S;    // stage s: empty + 8 s
  const float* xn = x + m;
  const int ntiles = (m + T - 1) / T;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x != kConsumers) return;  // its elected lane
    int k = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
      const int s = k % S;
      mbar_wait(empty + 8 * s, ((k / S) & 1) ^ 1);  // the stage is free
      const long long base = static_cast<long long>(tile) * T;
      const unsigned bytes = 4u * (tile_count(m, base, T) & ~3);
      const unsigned bar = full + 8 * s;
      float* slot = ring + s * kArrays * T;
      mbar_expect_tx(bar, kArrays * bytes);
      if (bytes) {
        bulk_load(slot, d + base, bytes, bar);
        if constexpr (kArrays == 4) {
          bulk_load(slot + T, u + base, bytes, bar);
          bulk_load(slot + 2 * T, v + base, bytes, bar);
        }
        bulk_load(slot + (kArrays - 1) * T, x + base, bytes, bar);
      }
    }
    return;
  }
  const int c = threadIdx.x;  // a consumer
  int k = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
    const int s = k % S;
    mbar_wait(full + 8 * s, (k / S) & 1);  // the stage has landed
    const long long base = static_cast<long long>(tile) * T;
    const int count = tile_count(m, base, T);
    const int body = count & ~3;  // the bulk-copied words; the tail is not
    const float* slot = ring + s * kArrays * T;
    const int* su = reinterpret_cast<const int*>(slot + T);
    const int* sv = reinterpret_cast<const int*>(slot + 2 * T);
    const float* sx = slot + (kArrays - 1) * T;
    float* ys = ring + (S * kArrays + s) * T;  // the output stage (Bulk)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = c + i * kConsumers;
      if (t < count) {
        const bool staged = t < body;
        const long long j = base + t;
        const float dj = staged ? slot[t] : d[j];
        const float xj = staged ? sx[t] : x[j];
        float yj;
        if constexpr (Mode == kStreamOnly) {
          yj = __fmul_rn(dj, xj);
        } else {
          yj = arc_row<Mode>(dj, xj, staged ? su[t] : u[j],
                             staged ? sv[t] : v[j], xn, e, param);
        }
        if constexpr (Bulk) {
          if (staged)
            ys[t] = yj;
          else
            y[j] = yj;
        } else {
          y[j] = yj;
        }
      }
    }
    __syncwarp();
    if (c % kWarpSize == 0) mbar_arrive(empty + 8 * s);  // done with it
    if constexpr (Bulk) {
      fence_proxy_async();  // the output stage's writes, for the bulk store
      // the output stage of tile k + 1 was the source of tile k + 1 - S's
      // store: read before any consumer passes the barrier
      if (c == 0) bulk_wait_read<S - 2>();
      consumers_sync();
      if (c == 0 && body > 0) {
        bulk_store(y + base, ys, 4u * body);
        bulk_commit();
      }
    }
  }
  if constexpr (Bulk) {
    if (c == 0) bulk_wait<0>();
  }
}

template <int Mode>
__global__ void __launch_bounds__(kThreads)
probe_pipeline_nodes(const int* __restrict__ ptr, const int* __restrict__ ent,
                     int m, int p, float e, const float* __restrict__ x,
                     float* __restrict__ y) {
  const int node = blockIdx.x * kWarps + threadIdx.x / kWarpSize;
  if (node >= p) return;  // warp-uniform
  float total;
  if constexpr (Mode == kNoGather)
    total = kkt_node_row_warp(ptr, ent, x, node, IndexAsValue{x});
  else
    total = kkt_node_row_warp(ptr, ent, x, node);
  if (threadIdx.x % kWarpSize == 0) y[m + node] = __fmul_rn(e, total);
}

struct PipeCall {
  const float* d;
  const int* u;
  const int* v;
  const int* ptr;
  const int* ent;
  int m, p;
  float e;
  const float* x;
  float* y;
  int param, with_nodes;
  cudaStream_t arc_stream, node_stream;
  int* per_sm;  // non-null: report the arc kernel's occupancy, launch nothing
  int* smem;
};

// The arc kernel's dynamic shared memory past 48 KB; once per instance,
// before any capture.
template <int A, int T, int S, bool Bulk>
cudaError_t prepare_arcs() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      probe_pipeline_arcs<A, T, S, Bulk>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ring_bytes<A, T, S, Bulk>()));
  done = err == cudaSuccess;
  return err;
}

template <int Mode, int T, int S, bool Bulk>
cudaError_t run(const PipeCall& c) {
  constexpr int A = arc_kind<Mode>();
  constexpr size_t smem = ring_bytes<A, T, S, Bulk>();
  auto arcs = probe_pipeline_arcs<A, T, S, Bulk>;
  cudaError_t err = prepare_arcs<A, T, S, Bulk>();
  if (err != cudaSuccess) return err;
  if (c.per_sm) {
    *c.smem = static_cast<int>(smem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(c.per_sm, arcs,
                                                         kArcThreads, smem);
  }
  // the node blocks first: they hold the longest jobs (a hub row)
  if constexpr (has_nodes<Mode>()) {
    const int node_blocks = c.with_nodes ? (c.p + kWarps - 1) / kWarps : 0;
    if (node_blocks > 0) {
      probe_pipeline_nodes<node_kind<Mode>()>
          <<<node_blocks, kThreads, 0, c.node_stream>>>(c.ptr, c.ent, c.m,
                                                        c.p, c.e, c.x, c.y);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  if (c.m > 0) {
    const long long ntiles = (static_cast<long long>(c.m) + T - 1) / T;
    const int grid = resident_grid(arcs, kArcThreads, smem, ntiles);
    arcs<<<grid, kArcThreads, smem, c.arc_stream>>>(c.d, c.u, c.v, c.m, c.e,
                                                    c.x, c.y, c.param);
    err = cudaGetLastError();
  }
  return err;
}

template <int Mode, int T, int S>
cudaError_t by_store(int bulk, const PipeCall& c) {
  switch (bulk) {
    case 0:
      return run<Mode, T, S, false>(c);
    case 1:
      return run<Mode, T, S, true>(c);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int Mode, int T>
cudaError_t by_stages(int stages, int bulk, const PipeCall& c) {
  switch (stages) {
    case 2:
      return by_store<Mode, T, 2>(bulk, c);
    case 3:
      return by_store<Mode, T, 3>(bulk, c);
    case 4:
      return by_store<Mode, T, 4>(bulk, c);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int Mode>
cudaError_t by_tile(int tile, int stages, int bulk, const PipeCall& c) {
  switch (tile) {
    case 512:
      return by_stages<Mode, 512>(stages, bulk, c);
    case 1024:
      return by_stages<Mode, 1024>(stages, bulk, c);
    case 2048:
      return by_stages<Mode, 2048>(stages, bulk, c);
    default:
      return cudaErrorInvalidValue;
  }
}

// the instance of mode, tile T, stages S and store (bulk = 1) for the call
cudaError_t dispatch(int mode, int tile, int stages, int bulk,
                     const PipeCall& c) {
#define TPL_PIPE(M) \
  case M:           \
    return by_tile<M>(tile, stages, bulk, c)
  switch (mode) {
    TPL_PIPE(kFull);
    TPL_PIPE(kArcOnly);
    TPL_PIPE(kNoGather);
    TPL_PIPE(kStreamOnly);
    TPL_PIPE(kAlu);
    default:
      return cudaErrorInvalidValue;
  }
#undef TPL_PIPE
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
}  // namespace tpl

// K7's arguments (one shard's layout, e_scale, x, y; kkt_shard_matvec.cu),
// then mode (PipelineMode), its param (N for alu), the ring's tile T (512,
// 1024 or 2048 arcs) and stages S (2, 3 or 4), store (0 direct, 1 bulk),
// with_nodes (0: the arc kernel alone, to part the two kernels' times),
// and two streams: the arc kernel launches on arc_stream, the node kernel
// (the modes with a node part) on node_stream; the caller forks and joins
// them (or passes one stream twice). d, u, v, x and y must be 16-byte
// aligned. A mode without the node part leaves y_n unwritten. Device
// pointers; does not synchronise; returns the first launch's
// cudaGetLastError() that is not cudaSuccess (cudaErrorInvalidValue for an
// argument the kernels cannot take).
extern "C" int tpl_probe_pipeline(const float* d, const int* u, const int* v,
                                  const int* ptr, const int* ent, int m,
                                  int p, float e_scale, const float* x,
                                  float* y, int mode, int param, int tile,
                                  int stages, int bulk, int with_nodes,
                                  cudaStream_t arc_stream,
                                  cudaStream_t node_stream) {
  if (param < 0 || m < 0 || p < 0 || !tpl::aligned16(d)
      || !tpl::aligned16(u) || !tpl::aligned16(v) || !tpl::aligned16(x)
      || !tpl::aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const tpl::PipeCall c{d,     u,          v,           ptr,     ent,
                        m,     p,          e_scale,     x,       y,
                        param, with_nodes, arc_stream, node_stream,
                        nullptr, nullptr};
  return static_cast<int>(tpl::dispatch(mode, tile, stages, bulk, c));
}

// The arc kernel of mode, tile, stages and store: its blocks resident per
// SM at its dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// into *blocks_per_sm, those bytes into *smem_bytes. Sets the instance's
// attribute first; launches nothing. Returns the query's error.
extern "C" int tpl_probe_pipeline_blocks(int mode, int tile, int stages,
                                         int bulk, int* blocks_per_sm,
                                         int* smem_bytes) {
  *blocks_per_sm = 0;
  *smem_bytes = 0;
  const tpl::PipeCall c{nullptr, nullptr, nullptr, nullptr, nullptr,
                        0,       0,       0.0f,    nullptr, nullptr,
                        0,       0,       nullptr, nullptr, blocks_per_sm,
                        smem_bytes};
  return static_cast<int>(tpl::dispatch(mode, tile, stages, bulk, c));
}
