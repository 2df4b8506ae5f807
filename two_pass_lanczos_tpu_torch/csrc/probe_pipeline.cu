// K14d: K7's matvec (kkt_shard_matvec.cu) with its arc part fed through a
// hand-managed, double-buffered asynchronous copy pipeline.
//
// Replaces stream_manual.py's man_kernel (scripts/probe/stream_manual.py:70,
// built at :194): the streaming matvec on a hand-built double-buffered DMA
// pipeline (make_async_copy and semaphores), bit-identical to the grid
// kernel, which asked whether explicit prefetch beats the compiler's
// pipeline. On Hopper the arc part runs on a grid of resident blocks; each
// walks the tiles blockIdx.x, blockIdx.x + grid, ... of 1,024 arcs and
// copies tile j + 1's d, u, v and x_a into shared memory with cp.async
// (16 bytes a thread and array, cache-global) before it computes tile j from
// the other buffer, so the next tile's loads are in flight while this one
// computes. Each arc is K7's kkt_arc_row on the staged words with x_n read
// through __ldg, and the node part is K7's node blocks (kkt_node_row)
// unchanged, appended to the same launch: the whole y is bitwise K7's.
//
// What bounds it on the H100: K7's function, 20 m + 8 p bytes over HBM.
// Shared memory: 2 buffers x 4 arrays x 4 KB = 32 KB a block, plus K7's
// 1 KB reduction scratch; the node blocks of the same launch carry it too,
// so at most 6 of them share an SM where K7 fits 8.
#include "probe_common.cuh"

namespace tpl {
namespace {

constexpr int kTile = 4 * kThreads;  // arcs a tile: one 16-byte chunk a
                                     // thread and array

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Tiles {
  float d[2][kTile];
  int u[2][kTile];
  int v[2][kTile];
  float x[2][kTile];
};

// Issue the copies of tile `tile` into buffer `buf` and commit them as one
// group. A whole tile moves in 16-byte chunks (the arrays are 16-byte
// aligned and a tile starts at a multiple of 1,024 arcs), the ragged last
// tile in 4-byte words.
__device__ __forceinline__ void issue_tile(Tiles& s, int buf, int tile, int m,
                                           const float* d, const int* u,
                                           const int* v, const float* x) {
  const long long base = static_cast<long long>(tile) * kTile;
  const long long left = m - base;
  if (left >= kTile) {
    const int c = 4 * threadIdx.x;
    cp_async16(&s.d[buf][c], d + base + c);
    cp_async16(&s.u[buf][c], u + base + c);
    cp_async16(&s.v[buf][c], v + base + c);
    cp_async16(&s.x[buf][c], x + base + c);
  } else {
    for (int t = threadIdx.x; t < left; t += kThreads) {
      cp_async4(&s.d[buf][t], d + base + t);
      cp_async4(&s.u[buf][t], u + base + t);
      cp_async4(&s.v[buf][t], v + base + t);
      cp_async4(&s.x[buf][t], x + base + t);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
probe_pipeline_kernel(const float* __restrict__ d, const int* __restrict__ u,
                      const int* __restrict__ v, const int* __restrict__ ptr,
                      const int* __restrict__ ent, int m, int arc_grid,
                      float e, const float* __restrict__ x,
                      float* __restrict__ y) {
  __shared__ __align__(16) Tiles s;
  __shared__ float sh[kThreads];
  const float* xn = x + m;
  if (static_cast<int>(blockIdx.x) < arc_grid) {
    const int ntiles = (m + kTile - 1) / kTile;
    int tile = blockIdx.x;
    int buf = 0;
    issue_tile(s, 0, tile, m, d, u, v, x);
    for (; tile < ntiles; tile += arc_grid) {
      const int next = tile + arc_grid;
      if (next < ntiles) {
        issue_tile(s, buf ^ 1, next, m, d, u, v, x);
      } else {
        cp_async_commit();  // an empty group keeps wait_group's count
      }
      cp_async_wait_one();  // this tile's group has landed (this thread's)
      __syncthreads();      // ... and every thread's
      const long long base = static_cast<long long>(tile) * kTile;
      const long long left = m - base;
      const int count = left < kTile ? static_cast<int>(left) : kTile;
      for (int t = threadIdx.x; t < count; t += kThreads) {
        y[base + t] = kkt_arc_row(s.d[buf][t], s.x[buf][t],
                                  __fmul_rn(e, __ldg(xn + s.u[buf][t])),
                                  __fmul_rn(e, __ldg(xn + s.v[buf][t])));
      }
      __syncthreads();  // the buffer is refilled two tiles on
      buf ^= 1;
    }
    return;  // block-uniform: arc blocks never reach block_sum
  }
  const int node = blockIdx.x - arc_grid;
  const float total = kkt_node_row(ptr, ent, x, node, sh);
  if (threadIdx.x == 0) y[m + node] = __fmul_rn(e, total);
}

}  // namespace
}  // namespace tpl

// K7's arguments (one shard's layout, e_scale, x, y; kkt_shard_matvec.cu),
// then with_nodes: 0 launches the pipelined arc part alone (y_n not
// written), to set against probe_stages' arc_only. d, u, v and x must be
// 16-byte aligned. Device pointers; does not synchronise; returns
// cudaGetLastError().
extern "C" int tpl_probe_pipeline(const float* d, const int* u, const int* v,
                                  const int* ptr, const int* ent, int m,
                                  int p, float e_scale, const float* x,
                                  float* y, int with_nodes,
                                  cudaStream_t stream) {
  const long long ntiles = (m + tpl::kTile - 1) / tpl::kTile;
  const int arc_grid = m > 0 ? tpl::resident_grid(
      tpl::probe_pipeline_kernel, tpl::kThreads, 0, ntiles) : 0;
  const int grid = arc_grid + (with_nodes ? p : 0);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  tpl::probe_pipeline_kernel<<<grid, tpl::kThreads, 0, stream>>>(
      d, u, v, ptr, ent, m, arc_grid, e_scale, x, y);
  return static_cast<int>(cudaGetLastError());
}
