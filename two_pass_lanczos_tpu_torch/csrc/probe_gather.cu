// K14a: the gather probe, g[j] = tab[idx[j]] (f32 table, one output per
// index), on the port's layout.
//
// Replaces the Pallas gather probes: probe_sublane, probe_twostep,
// probe_int16 and probe_time (scripts/probe_gather.py:31/41, :55/70, :84/93,
// :118/142) and bench (scripts/probe/bench_gather.py:14/63). On the TPU they
// asked how to gather from a (p2, 128) node plane without a hardware gather
// (sublane take_along_axis, a two-step hi/lo gather, windowed one-hot MXU
// selects) and what narrow index planes cost. Hopper gathers natively; the
// questions left are where the table should sit and what the indices cost:
//   mode smem     the table staged into each block's shared memory by one
//                 bulk copy (cp.async.bulk, completion on an mbarrier),
//                 then read from there; tables up to 58,104 floats;
//   mode ldg      each read through the read-only path (__ldg), as K1/K7
//                 read x_n;
//   mode plain    each read a plain global load (ld.global, no .nc), as
//                 K7's node blocks read x_a;
//   mode cluster  the table split over a thread-block cluster's distributed
//                 shared memory: C blocks (C a power of two up to 16), block
//                 rank r bulk-copies the slice [r 2^s, (r + 1) 2^s) into its
//                 own shared memory, the cluster syncs, and a gather of entry
//                 t reads rank t >> s's shared memory at t & (2^s - 1)
//                 (cluster.map_shared_rank); for the tables one SM cannot
//                 hold, such as x_a at the headline (500,000 floats, 2.0 MB,
//                 16 slices of 32,768); launched by cudaLaunchKernelEx with
//                 the cluster dimension, every resident cluster staging the
//                 whole table;
//   mode cluster_stage_only  the cluster tier's staging alone (no gather,
//                 nothing written), to part the gather rate from the
//                 staging cost;
//   idx int32, int16 or uint8, widened in the kernel (probe_int16's load and
//               widen); a two-level index tab[hi * 128 + lo] with uint16 hi
//               and the narrow lo plane (probe_twostep's H plane).
// The probe runs it on the instances' own gathers: x_n[u] and x_n[v] (the
// arc part's), x_a[arc of ent] in the CSR's node order (the node part's),
// and uniform random indices over tables of 1K to 8M entries.
//
// What bounds it on the H100: each index read once and each output written
// once (4 + 4 bytes per entry for int32, 2 + 4 for int16, 1 + 4 for uint8,
// 3 + 4 two-level) plus the table once; a gather of scattered entries moves
// a 32-byte sector per read when the table lies past L2 or in it cold, which
// is the cost the probe exposes. The design keeps many gathers in flight: a
// resident grid strides over quads of 4 consecutive entries, each thread
// loading a quad's indices with one vector load (16 bytes of int32, 8 of
// int16, 4 of uint8), issuing its 4 gathers and those of the next quad (8 in
// flight) before the first use, and storing each quad with one 16-byte
// store. The wrapper's plan (probes/gather.py vector_plan) gives the scalar
// head that aligns the indices, the number of quads and, from n, the tail;
// it allocates g at the indices' phase so that the quads' stores are
// aligned too.
#include <cooperative_groups.h>

#include <cstdint>

#include "probe_common.cuh"

namespace tpl {
namespace {

namespace cg = cooperative_groups;

enum GatherMode {
  kGatherSmem = 0,
  kGatherLdg = 1,
  kGatherPlain = 2,
  kGatherCluster = 3,
  kGatherClusterStage = 4,
};
constexpr int kGatherThreads = 256;
constexpr int kVec = 4;     // entries a thread takes a step
constexpr int kUnroll = 2;  // quads a thread issues together: 8 gathers
constexpr int kSmemBytes = 232448;  // a block's shared memory (227 KB)
constexpr int kStageHeader = 16;    // the mbarrier, padded to 16 bytes
// floats a block stages: its shared memory less the header and the up to
// 3 floats that align the bulk copy's destination with its source
constexpr int kMaxStaged = (kSmemBytes - kStageHeader - 16) / 4;  // 58,104
constexpr int kMaxCluster = 16;

template <int kMode>
__host__ __device__ constexpr bool clustered() {
  return kMode == kGatherCluster || kMode == kGatherClusterStage;
}
template <int kMode>
__host__ __device__ constexpr bool staged() {
  return kMode == kGatherSmem || clustered<kMode>();
}

__device__ __forceinline__ float load_plain(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// Stage count floats from src into this block's shared memory; every thread
// of the block calls it. The 16-byte aligned middle moves by one bulk copy
// (cp.async.bulk, the copy engine computes the addresses) whose bytes
// complete an mbarrier's phase; the up to 3 floats before and after it are
// copied by the threads. The floats land at smem + kStageHeader + 4 * shift,
// shift = src's float phase mod 4, so the bulk copy's destination is as
// aligned as its source. Returns where entry 0 landed; on return this
// thread sees the bulk copy's bytes, and the threads' own stores are
// visible after the caller's next barrier.
__device__ __forceinline__ float* stage_slice(const float* src, int count,
                                              unsigned char* smem) {
  const int shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) / 4) % 4);
  float* dst = reinterpret_cast<float*>(smem + kStageHeader) + shift;
  if (count < 0) count = 0;
  const int head = min((kVec - shift) % kVec, count);
  const int body = (count - head) / kVec * kVec;
  const unsigned bytes = static_cast<unsigned>(body) * 4u;
  const unsigned bar = smem_addr(smem);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, bytes);
    if (bytes) bulk_load(dst + head, src + head, bytes, bar);
  }
  for (int i = threadIdx.x; i < count - body; i += kGatherThreads) {
    const int k = i < head ? i : i + body;
    dst[k] = src[k];
  }
  mbar_wait(bar, 0);
  return dst;
}

template <typename I>
struct QuadOf;
template <>
struct QuadOf<int32_t> {
  using T = int4;
};
template <>
struct QuadOf<int16_t> {
  using T = short4;
};
template <>
struct QuadOf<uint8_t> {
  using T = uchar4;
};
template <>
struct QuadOf<uint16_t> {
  using T = ushort4;
};

// 4 consecutive indices from one vector load, streamed (evict-first: read
// once, so the table's lines stay in L2 ahead of them; without the hints
// the x_a gather at 5M took 4.5 % longer on the H100, PERF.md §6).
template <typename I>
__device__ __forceinline__ int4 load_quad(const I* p) {
  const auto q = __ldcs(reinterpret_cast<const typename QuadOf<I>::T*>(p));
  return make_int4(static_cast<int>(q.x), static_cast<int>(q.y),
                   static_cast<int>(q.z), static_cast<int>(q.w));
}

template <typename I, bool kTwo>
__device__ __forceinline__ int entry(const I* __restrict__ idx,
                                     const uint16_t* __restrict__ hi, int j) {
  int t = static_cast<int>(idx[j]);
  if (kTwo) t += static_cast<int>(hi[j]) << 7;
  return t;
}

template <typename I, bool kTwo>
__device__ __forceinline__ int4 quad_entries(const I* __restrict__ idx,
                                             const uint16_t* __restrict__ hi,
                                             int j) {
  int4 t = load_quad(idx + j);
  if (kTwo) {
    const int4 h = load_quad(hi + j);
    t = make_int4(t.x + (h.x << 7), t.y + (h.y << 7), t.z + (h.z << 7),
                  t.w + (h.w << 7));
  }
  return t;
}

template <int kMode>
__device__ __forceinline__ float fetch(const float* __restrict__ tab,
                                       float* stab, int slice_log2, int t) {
  if constexpr (kMode == kGatherSmem) {
    return stab[t];
  } else if constexpr (kMode == kGatherCluster) {
    const float* owner = cg::this_cluster().map_shared_rank(
        stab, static_cast<unsigned>(t >> slice_log2));
    return owner[t & ((1 << slice_log2) - 1)];
  } else if constexpr (kMode == kGatherLdg) {
    return __ldg(tab + t);
  } else {
    return load_plain(tab + t);
  }
}

template <typename I, bool kTwo, int kMode>
__global__ void __launch_bounds__(kGatherThreads)
probe_gather_kernel(const float* __restrict__ tab, int ntab,
                    const I* __restrict__ idx,
                    const uint16_t* __restrict__ hi, int n, int head,
                    int quads, int slice_log2, float* __restrict__ g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stab = nullptr;
  if constexpr (kMode == kGatherSmem) {
    stab = stage_slice(tab, ntab, smem);
    __syncthreads();  // the threads' ragged ends
  } else if constexpr (clustered<kMode>()) {
    cg::cluster_group cluster = cg::this_cluster();
    const int first = static_cast<int>(cluster.block_rank()) << slice_log2;
    stab = stage_slice(tab + first, min(ntab - first, 1 << slice_log2),
                       smem);
    cluster.sync();  // every slice staged, cluster-wide
    if constexpr (kMode == kGatherClusterStage) return;  // nobody reads
  }
  const int tid = blockIdx.x * kGatherThreads + threadIdx.x;
  const int stride = gridDim.x * kGatherThreads;
  // the scalar head [0, head) and tail [head + 4 quads, n)
  const int ends = n - kVec * quads;
  for (int s = tid; s < ends; s += stride) {
    const int j = s < head ? s : s + kVec * quads;
    g[j] = fetch<kMode>(tab, stab, slice_log2, entry<I, kTwo>(idx, hi, j));
  }
  // the quads: kUnroll quads a thread, every index load, then every
  // gather, then the stores
  for (int q0 = tid; q0 < quads; q0 += kUnroll * stride) {
    int4 t[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (q0 + k * stride < quads)
        t[k] = quad_entries<I, kTwo>(idx, hi, head + kVec * (q0 + k * stride));
    float4 val[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (q0 + k * stride < quads)
        val[k] = make_float4(fetch<kMode>(tab, stab, slice_log2, t[k].x),
                             fetch<kMode>(tab, stab, slice_log2, t[k].y),
                             fetch<kMode>(tab, stab, slice_log2, t[k].z),
                             fetch<kMode>(tab, stab, slice_log2, t[k].w));
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (q0 + k * stride < quads)
        __stcs(reinterpret_cast<float4*>(g + head + kVec * (q0 + k * stride)),
               val[k]);
  }
  if constexpr (clustered<kMode>())
    cg::this_cluster().sync();  // no block leaves while its slice is read
}

struct GatherArgs {
  const float* tab;
  int ntab;
  const void* idx;
  const void* hi;
  int n, head, quads, cluster, slice_log2, clusters;
  float* g;
};

// dynamic shared memory of a staging block holding `entries` floats
inline size_t staged_bytes(int entries) {
  return static_cast<size_t>(kStageHeader) + 4u * (3u + entries);
}

// The kernel's attributes: the full 227 KB of dynamic shared memory for
// the staging tiers and, for the cluster tiers, clusters past the portable
// 8 blocks. Set once per instance, before any capture.
template <typename I, bool kTwo, int kMode>
cudaError_t prepare() {
  static bool done = false;
  if (done || !staged<kMode>()) return cudaSuccess;
  auto kernel = probe_gather_kernel<I, kTwo, kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess && clustered<kMode>())
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return e;
}

template <typename I, bool kTwo, int kMode>
cudaLaunchConfig_t cluster_config(const GatherArgs& a, int grid,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kGatherThreads);
  cfg.dynamicSmemBytes = staged_bytes(1 << a.slice_log2);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of a.cluster blocks, each holding a 2^slice_log2 slice, that
// the card holds at once (0: none).
template <typename I, bool kTwo, int kMode>
cudaError_t active_clusters(const GatherArgs& a, int* active) {
  cudaError_t e = prepare<I, kTwo, kMode>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<I, kTwo, kMode>(a, a.cluster, &attr, nullptr);
  return cudaOccupancyMaxActiveClusters(
      active, probe_gather_kernel<I, kTwo, kMode>, &cfg);
}

template <typename I, bool kTwo, int kMode>
cudaError_t launch_gather(const GatherArgs& a, cudaStream_t stream) {
  auto kernel = probe_gather_kernel<I, kTwo, kMode>;
  cudaError_t e = prepare<I, kTwo, kMode>();
  if (e != cudaSuccess) return e;
  // threads the work needs: the scalar ends, or kUnroll quads a thread
  const long long ends = static_cast<long long>(a.n) - kVec * a.quads;
  const long long steps = (static_cast<long long>(a.quads) + kUnroll - 1)
                          / kUnroll;
  const long long work = ends > steps ? ends : steps;
  const long long want = (work + kGatherThreads - 1) / kGatherThreads;
  if constexpr (clustered<kMode>()) {
    // every resident cluster (as the wrapper's query found them), at most
    // as many as the work needs; a refused launch is returned as it is
    long long c = (want + a.cluster - 1) / a.cluster;
    if (c > a.clusters) c = a.clusters;
    if (c < 1) c = 1;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config<I, kTwo, kMode>(
        a, static_cast<int>(c) * a.cluster, &attr, stream);
    return cudaLaunchKernelEx(&cfg, kernel, a.tab, a.ntab,
                              static_cast<const I*>(a.idx),
                              static_cast<const uint16_t*>(a.hi), a.n,
                              a.head, a.quads, a.slice_log2, a.g);
  } else {
    const size_t smem = kMode == kGatherSmem ? staged_bytes(a.ntab) : 0;
    const int grid = resident_grid(kernel, kGatherThreads, smem, want);
    kernel<<<grid, kGatherThreads, smem, stream>>>(
        a.tab, a.ntab, static_cast<const I*>(a.idx),
        static_cast<const uint16_t*>(a.hi), a.n, a.head, a.quads,
        a.slice_log2, a.g);
    return cudaGetLastError();
  }
}

// launch (query = false) or count the resident clusters (query = true) of
// the instance that mode, the index type and hi name
template <typename I>
cudaError_t dispatch_gather(int mode, const GatherArgs& a, bool query,
                            int* active, cudaStream_t stream) {
  const bool two = a.hi != nullptr;
#define TPL_GATHER(M)                                                       \
  case M:                                                                   \
    if (query)                                                              \
      return two ? active_clusters<I, true, M>(a, active)                   \
                 : active_clusters<I, false, M>(a, active);                 \
    return two ? launch_gather<I, true, M>(a, stream)                       \
               : launch_gather<I, false, M>(a, stream)
  switch (mode) {
    TPL_GATHER(kGatherSmem);
    TPL_GATHER(kGatherLdg);
    TPL_GATHER(kGatherPlain);
    TPL_GATHER(kGatherCluster);
    TPL_GATHER(kGatherClusterStage);
    default:
      return cudaErrorInvalidValue;
  }
#undef TPL_GATHER
}

cudaError_t dispatch_type(int idx_type, int mode, const GatherArgs& a,
                          bool query, int* active, cudaStream_t stream) {
  switch (idx_type) {
    case 0:
      return dispatch_gather<int32_t>(mode, a, query, active, stream);
    case 1:
      return dispatch_gather<int16_t>(mode, a, query, active, stream);
    case 2:
      return dispatch_gather<uint8_t>(mode, a, query, active, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

size_t index_bytes(int idx_type) {
  return idx_type == 0 ? 4 : idx_type == 1 ? 2 : 1;
}

// The cluster shape is one the kernel can stage: C a power of two up to
// 16, slices of 2^s floats with 4 <= 2^s <= kMaxStaged, C slices holding
// the table.
bool cluster_ok(int ntab, int cluster, int slice_log2) {
  return cluster >= 1 && cluster <= kMaxCluster
      && (cluster & (cluster - 1)) == 0 && slice_log2 >= 2
      && slice_log2 < 31 && (1 << slice_log2) <= kMaxStaged
      && static_cast<long long>(cluster) << slice_log2 >= ntab;
}

}  // namespace
}  // namespace tpl

// tab (ntab) f32; idx (n) of idx_type 0 = int32, 1 = int16, 2 = uint8; hi
// (n) uint16 or null (then g[j] = tab[idx[j]], else tab[hi[j] * 128 +
// idx[j]]); mode 0 = smem, 1 = ldg, 2 = plain, 3 = cluster, 4 =
// cluster_stage_only; the plan (probes/gather.py): head scalar entries,
// then quads of 4 (idx + head, hi + head and g + head aligned to 4
// entries), then the tail; for the cluster modes cluster blocks a cluster,
// slices of 2^slice_log2 floats and at most `clusters` clusters (the
// resident ones, tpl_probe_gather_clusters), else 0s; g (n) f32 (mode 4
// writes nothing). Every index must lie in [0, ntab). Device pointers;
// does not synchronise; returns cudaGetLastError(), or the cluster
// launch's error as it is (cudaErrorInvalidValue for a smem table past
// 58,104 floats, a plan or cluster shape the kernel cannot run, or an
// unknown mode or type).
extern "C" int tpl_probe_gather(const float* tab, int ntab, const void* idx,
                                int idx_type, const void* hi, int n,
                                int head, int quads, int mode, int cluster,
                                int slice_log2, int clusters, float* g,
                                cudaStream_t stream) {
  const size_t quad_bytes = tpl::kVec * tpl::index_bytes(idx_type);
  if (n < 0 || head < 0 || quads < 0
      || static_cast<long long>(head) + 4LL * quads > n
      || (quads && (!tpl::aligned(static_cast<const char*>(idx)
                                      + head * tpl::index_bytes(idx_type),
                                  quad_bytes)
                    || !tpl::aligned(g + head, 16)
                    || (hi && !tpl::aligned(
                                  static_cast<const uint16_t*>(hi) + head,
                                  8))))
      || (mode == tpl::kGatherSmem && ntab > tpl::kMaxStaged)
      || ((mode == tpl::kGatherCluster || mode == tpl::kGatherClusterStage)
          && (!tpl::cluster_ok(ntab, cluster, slice_log2) || clusters < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const tpl::GatherArgs a{tab,   ntab,  idx,     hi,         n,        head,
                          quads, cluster, slice_log2, clusters, g};
  return static_cast<int>(
      tpl::dispatch_type(idx_type, mode, a, false, nullptr, stream));
}

// The clusters of `cluster` blocks with 2^slice_log2-float slices of the
// cluster instance (mode 3 or 4) for idx_type and a two-level index (two)
// that the card holds at once, into *active (0: no such cluster is
// resident). Sets the instance's attributes first. Returns the occupancy
// query's error.
extern "C" int tpl_probe_gather_clusters(int idx_type, int two, int mode,
                                         int ntab, int cluster,
                                         int slice_log2, int* active) {
  if ((mode != tpl::kGatherCluster && mode != tpl::kGatherClusterStage)
      || !tpl::cluster_ok(ntab, cluster, slice_log2))
    return static_cast<int>(cudaErrorInvalidValue);
  static const uint16_t kSomeHi = 0;  // any non-null pointer picks two-level
  tpl::GatherArgs a{nullptr, ntab, nullptr, two ? &kSomeHi : nullptr, 0, 0,
                    0,       cluster, slice_log2, 1, nullptr};
  *active = 0;
  return static_cast<int>(
      tpl::dispatch_type(idx_type, mode, a, true, active, nullptr));
}
