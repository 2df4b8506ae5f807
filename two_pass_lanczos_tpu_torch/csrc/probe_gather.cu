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
//   mode smem   the table staged into shared memory once per block (tables
//               up to 227 KB, 58,112 floats), then read from there;
//   mode ldg    each read through the read-only path (__ldg), as K1/K7
//               read x_n;
//   mode plain  each read a plain global load (ld.global, no .nc), as K7's
//               node blocks read x_a;
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
// is the cost the probe exposes. A grid of resident blocks strides over the
// entries with coalesced index reads and output writes.
#include <cstdint>

#include "probe_common.cuh"

namespace tpl {
namespace {

enum GatherMode { kGatherSmem = 0, kGatherLdg = 1, kGatherPlain = 2 };
constexpr int kGatherThreads = 256;
constexpr int kMaxSmemTable = 232448 / 4;  // 227 KB of floats

__device__ __forceinline__ float load_plain(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <typename I, bool kTwo, int kMode>
__global__ void __launch_bounds__(kGatherThreads)
probe_gather_kernel(const float* __restrict__ tab, int ntab,
                    const I* __restrict__ idx,
                    const uint16_t* __restrict__ hi, int n,
                    float* __restrict__ g) {
  extern __shared__ float stab[];
  if (kMode == kGatherSmem) {
    for (int i = threadIdx.x; i < ntab; i += kGatherThreads) stab[i] = tab[i];
    __syncthreads();
  }
  const int stride = gridDim.x * kGatherThreads;
  for (int j = blockIdx.x * kGatherThreads + threadIdx.x; j < n;
       j += stride) {
    int t = static_cast<int>(idx[j]);
    if (kTwo) t += static_cast<int>(hi[j]) << 7;
    float val;
    if (kMode == kGatherSmem) {
      val = stab[t];
    } else if (kMode == kGatherLdg) {
      val = __ldg(tab + t);
    } else {
      val = load_plain(tab + t);
    }
    g[j] = val;
  }
}

template <typename I, bool kTwo, int kMode>
cudaError_t launch_gather(const float* tab, int ntab, const void* idx,
                          const void* hi, int n, float* g,
                          cudaStream_t stream) {
  auto kernel = probe_gather_kernel<I, kTwo, kMode>;
  size_t smem = 0;
  if (kMode == kGatherSmem) {
    if (ntab > kMaxSmemTable) return cudaErrorInvalidValue;
    smem = static_cast<size_t>(ntab) * sizeof(float);
    static bool raised = false;  // once per instance, before any capture
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmemTable * static_cast<int>(sizeof(float)));
      if (e != cudaSuccess) return e;
      raised = true;
    }
  }
  const int grid = resident_grid(
      kernel, kGatherThreads, smem,
      (static_cast<long long>(n) + kGatherThreads - 1) / kGatherThreads);
  kernel<<<grid, kGatherThreads, smem, stream>>>(
      tab, ntab, static_cast<const I*>(idx),
      static_cast<const uint16_t*>(hi), n, g);
  return cudaGetLastError();
}

template <typename I>
cudaError_t dispatch_gather(int mode, const float* tab, int ntab,
                            const void* idx, const void* hi, int n, float* g,
                            cudaStream_t stream) {
  const bool two = hi != nullptr;
  switch (mode) {
    case kGatherSmem:
      return two ? launch_gather<I, true, kGatherSmem>(tab, ntab, idx, hi, n,
                                                       g, stream)
                 : launch_gather<I, false, kGatherSmem>(tab, ntab, idx, hi,
                                                        n, g, stream);
    case kGatherLdg:
      return two ? launch_gather<I, true, kGatherLdg>(tab, ntab, idx, hi, n,
                                                      g, stream)
                 : launch_gather<I, false, kGatherLdg>(tab, ntab, idx, hi, n,
                                                       g, stream);
    case kGatherPlain:
      return two ? launch_gather<I, true, kGatherPlain>(tab, ntab, idx, hi,
                                                        n, g, stream)
                 : launch_gather<I, false, kGatherPlain>(tab, ntab, idx, hi,
                                                         n, g, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpl

// tab (ntab) f32; idx (n) of idx_type 0 = int32, 1 = int16, 2 = uint8; hi
// (n) uint16 or null (then g[j] = tab[idx[j]], else tab[hi[j] * 128 +
// idx[j]]); mode 0 = smem, 1 = ldg, 2 = plain; g (n) f32. Every index must
// lie in [0, ntab). Device pointers; does not synchronise; returns
// cudaGetLastError() (cudaErrorInvalidValue for a smem table past 227 KB or
// an unknown mode or type).
extern "C" int tpl_probe_gather(const float* tab, int ntab, const void* idx,
                                int idx_type, const void* hi, int n, int mode,
                                float* g, cudaStream_t stream) {
  cudaError_t e;
  switch (idx_type) {
    case 0:
      e = tpl::dispatch_gather<int32_t>(mode, tab, ntab, idx, hi, n, g,
                                        stream);
      break;
    case 1:
      e = tpl::dispatch_gather<int16_t>(mode, tab, ntab, idx, hi, n, g,
                                        stream);
      break;
    case 2:
      e = tpl::dispatch_gather<uint8_t>(mode, tab, ntab, idx, hi, n, g,
                                        stream);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
