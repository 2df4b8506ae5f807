// K15: y = A x for a general sparse matrix in CSR form (the SortedCOO of
// ops/spmv.py: vals, int64 cols, int64 indptr), one launch a product, for
// V = float, double, complex<float> or complex<double>: the product of
// SparseOperator and the owned and remote products of
// ShardedSparseOperator.
//
// Replaces no TPU kernel. The JAX package's coo_spmv
// (two_pass_lanczos_tpu/ops/spmv.py:133) is XLA's gather and sorted
// scatter-add, with no Pallas kernel; the port ran it as x[cols], a
// multiply and torch.segment_reduce (CUB's segmented reduce, 4 launches a
// product, 519 us on the 2.5M-nonzero KKT matrix on the H100). This kernel
// is the one hand-written product of the generic tier.
//
// Deterministic and fixed-order. Each row is summed in an order that
// depends only on indptr (through the row-block plan, which is built from
// indptr alone): no atomics, no dependence on scheduling or on x, so pass
// two's products round as pass one's did and two runs give the same bits.
// Every operation is an explicit round-to-nearest intrinsic (a product
// rounded, then added), in the matrix's own dtype; a complex row sums its
// real and imaginary parts in the same order.
//
// The row-block plan (CSR-adaptive, Greathouse & Daga, SC 2014), built once
// a matrix on the host (ops/spmv.row_blocks): block b of the launch owns
// rows blocks[b] .. blocks[b+1], consecutive rows of at most `budget`
// nonzeros and `budget` rows in all, or one longer row alone. In a block of
// R rows, L = the largest power of two <= 256 / R threads sum each row
// (one thread a row when R > 128): lane l of a row folds the row's entries
// l, l + L, l + 2L, ... in that order, then the L partials meet in a tree
// of fixed shape (warp shuffles at distances 16 .. 1 within a warp, then
// across the warps of the row at distances L/64 .. 1). When L < 32 (R > 8)
// the block first streams its products vals[i] * x[cols[i]] into shared
// memory with coalesced loads, so that short rows are read as one
// contiguous stream; with L >= 32 every warp already reads 32 consecutive
// entries of its row, and a row longer than the budget is read straight
// from global memory.
//
// What bounds it on the H100: the bytes. A product reads vals, cols (8
// bytes a nonzero, as stored), indptr and the plan, gathers x and writes y:
// on the 500k-arc KKT matrix (n = 501,155, 2.5M nonzeros, f32) about 38 MB,
// 11 us at 3.35 TB/s, less where the matrix stays in the 50 MB L2 between
// products. The plan paces each block by its nonzeros, not by its longest
// row: the KKT's 1,155 node rows (866 nonzeros each on average) get a
// block of 256 threads each, its 500,000 arc rows of 3 share blocks of 341
// rows; loads are issued four a thread before their sums, so each thread
// keeps four gathers in flight.
#include "lanczos_common.cuh"

namespace tpl {

// A complex value as torch stores it: the real part, then the imaginary.
template <typename R>
struct alignas(2 * sizeof(R)) Complex {
  R re, im;
};

namespace {

// The arithmetic of one value type: zero, the product a * x, the sum and a
// warp shuffle, each spelled with the round-to-nearest intrinsics.
template <typename V>
struct Arith {
  static __device__ __forceinline__ V zero() { return V(0); }
  static __device__ __forceinline__ V mul(V a, V x) { return mul_rn(a, x); }
  static __device__ __forceinline__ V add(V a, V b) { return add_rn(a, b); }
  static __device__ __forceinline__ V down(V v, int s, int width) {
    return __shfl_down_sync(0xffffffffu, v, s, width);
  }
};

template <typename R>
struct Arith<Complex<R>> {
  using V = Complex<R>;
  static __device__ __forceinline__ V zero() { return V{R(0), R(0)}; }
  static __device__ __forceinline__ V mul(V a, V x) {
    return V{sub_rn(mul_rn(a.re, x.re), mul_rn(a.im, x.im)),
             add_rn(mul_rn(a.re, x.im), mul_rn(a.im, x.re))};
  }
  static __device__ __forceinline__ V add(V a, V b) {
    return V{add_rn(a.re, b.re), add_rn(a.im, b.im)};
  }
  static __device__ __forceinline__ V down(V v, int s, int width) {
    return V{__shfl_down_sync(0xffffffffu, v.re, s, width),
             __shfl_down_sync(0xffffffffu, v.im, s, width)};
  }
};

// entries a thread loads before it sums them
constexpr int kBatch = 4;

// The sum of the L partials of a row group (L a power of two, 2 .. 256;
// the group's lanes are consecutive threads). Every thread of the block
// calls it; the group's lane 0 gets the row's sum.
template <typename V>
__device__ __forceinline__ V group_sum(V acc, int lanes, V* warp_sums) {
  using A = Arith<V>;
  const int width = lanes < kWarpSize ? lanes : kWarpSize;
  for (int s = width / 2; s > 0; s >>= 1)
    acc = A::add(acc, A::down(acc, s, width));
  if (lanes <= kWarpSize) return acc;
  const int warp = threadIdx.x / kWarpSize, lane = threadIdx.x % kWarpSize;
  const int per = lanes / kWarpSize;  // warps a row: 2 .. 8
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp % per == 0) {  // the row's first warp folds its warps' sums
    V v = lane < per ? warp_sums[warp + lane] : A::zero();
    for (int s = per / 2; s > 0; s >>= 1) v = A::add(v, A::down(v, s, per));
    acc = v;
  }
  return acc;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const V* __restrict__ vals, const long long* __restrict__ cols,
                const long long* __restrict__ indptr,
                const long long* __restrict__ blocks, int budget,
                const V* __restrict__ x, V* __restrict__ y) {
  using A = Arith<V>;
  extern __shared__ __align__(16) unsigned char staged_bytes[];
  V* staged = reinterpret_cast<V*>(staged_bytes);
  __shared__ V warp_sums[kWarps];
  const long long r0 = blocks[blockIdx.x];
  const int rows = static_cast<int>(blocks[blockIdx.x + 1] - r0);
  const long long e0 = indptr[r0];
  int lanes = kThreads;  // threads a row
  while (lanes > 1 && lanes * rows > kThreads) lanes >>= 1;
  const int groups = kThreads / lanes;
  const int group = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  // several rows in at most `budget` nonzeros (always so for more than
  // one row, by the plan; the test keeps a foreign plan in bounds): the
  // products are the same either way, only where they are read from differs
  const long long count = indptr[r0 + rows] - e0;
  const bool stage = lanes < kWarpSize && count <= budget;  // block-uniform
  if (stage) {
    for (int i0 = threadIdx.x; i0 < count; i0 += kThreads * kBatch) {
      long long c[kBatch];
      V a[kBatch], xv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * kThreads;
        if (i < count) {
          c[k] = cols[e0 + i];
          a[k] = vals[e0 + i];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (i0 + k * kThreads < count) xv[k] = x[c[k]];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (i0 + k * kThreads < count)
          staged[i0 + k * kThreads] = A::mul(a[k], xv[k]);
    }
    __syncthreads();
  }
  for (int base = 0; base < rows; base += groups) {  // one pass if lanes > 1
    const int r = base + group;
    V acc = A::zero();
    if (r < rows) {
      const long long end = indptr[r0 + r + 1];
      if (stage) {
        for (long long i = indptr[r0 + r] + lane; i < end; i += lanes)
          acc = A::add(acc, staged[i - e0]);
      } else {
        for (long long q = indptr[r0 + r] + lane; q < end;
             q += static_cast<long long>(lanes) * kBatch) {
          long long c[kBatch];
          V a[kBatch], xv[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const long long i = q + static_cast<long long>(k) * lanes;
            if (i < end) {
              c[k] = cols[i];
              a[k] = vals[i];
            }
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            if (q + static_cast<long long>(k) * lanes < end) xv[k] = x[c[k]];
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            if (q + static_cast<long long>(k) * lanes < end)
              acc = A::add(acc, A::mul(a[k], xv[k]));
        }
      }
    }
    if (lanes > 1) acc = group_sum(acc, lanes, warp_sums);
    if (r < rows && lane == 0) y[r0 + r] = acc;
  }
}

template <typename V>
cudaError_t launch_csr_spmv(const V* vals, const long long* cols,
                            const long long* indptr, const long long* blocks,
                            int n_blocks, int budget, const V* x, V* y,
                            cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(budget) * sizeof(V);
  csr_spmv_kernel<V><<<n_blocks, kThreads, smem, stream>>>(
      vals, cols, indptr, blocks, budget, x, y);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpl

// One entry point a value type, each spelled out so that the C interface
// can be checked against ops/_build._SIGNATURES.
extern "C" int tpl_csr_spmv_f32(const float* vals, const long long* cols,
                                const long long* indptr,
                                const long long* blocks, int n_blocks,
                                int budget, const float* x, float* y,
                                cudaStream_t stream) {
  return static_cast<int>(tpl::launch_csr_spmv(
      vals, cols, indptr, blocks, n_blocks, budget, x, y, stream));
}

extern "C" int tpl_csr_spmv_f64(const double* vals, const long long* cols,
                                const long long* indptr,
                                const long long* blocks, int n_blocks,
                                int budget, const double* x, double* y,
                                cudaStream_t stream) {
  return static_cast<int>(tpl::launch_csr_spmv(
      vals, cols, indptr, blocks, n_blocks, budget, x, y, stream));
}

extern "C" int tpl_csr_spmv_c64(const tpl::Complex<float>* vals,
                                const long long* cols,
                                const long long* indptr,
                                const long long* blocks, int n_blocks,
                                int budget, const tpl::Complex<float>* x,
                                tpl::Complex<float>* y, cudaStream_t stream) {
  return static_cast<int>(tpl::launch_csr_spmv(
      vals, cols, indptr, blocks, n_blocks, budget, x, y, stream));
}

extern "C" int tpl_csr_spmv_c128(const tpl::Complex<double>* vals,
                                 const long long* cols,
                                 const long long* indptr,
                                 const long long* blocks, int n_blocks,
                                 int budget, const tpl::Complex<double>* x,
                                 tpl::Complex<double>* y,
                                 cudaStream_t stream) {
  return static_cast<int>(tpl::launch_csr_spmv(
      vals, cols, indptr, blocks, n_blocks, budget, x, y, stream));
}
