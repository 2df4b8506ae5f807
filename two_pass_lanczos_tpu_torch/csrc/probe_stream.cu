// K14b: the streaming probe,
//   y[j] = d[j] * x[j] + 1e-30 * (float(u[j]) + float(v[j])),
// which reads each arc's four words (d, u, v, x) once and writes y once:
// the arc stream of K7 with its gathers taken out.
//
// Replaces the Pallas streaming probes: stream_blocks.py's kern
// (scripts/probe/stream_blocks.py:34/44: the pure streaming floor of
// y = d * x + 1e-30 * (es + eo) against the DMA block size) and
// stream_planes.py's _kern_multi and _kern_merged (scripts/probe/
// stream_planes.py:132/190, :153/202: four DMA planes per ordering against
// one interleaved record, at constant bytes). On Hopper the block size is
// the threads per block (128 to 1024) and the arcs each thread handles (1
// to 8, coalesced: thread t of a block takes arcs base + i * threads + t);
// the layouts are
//   soa  four planes d, u, v, x, each read as one coalesced 4-byte stream;
//   aos  one interleaved 16-byte record {d, u, v, x} per arc, read as one
//        float4 (u and v as their int bits).
// Every rounding is spelled (__fmul_rn, __fadd_rn) so the plain PyTorch
// version matches it bitwise.
//
// What bounds it on the H100: 20 bytes per arc (16 read, 4 written) over
// the 3.35 TB/s of HBM once the arcs lie past the 50 MB L2; two
// multiplies and two adds per arc are far below the f32 rate.
#include "probe_common.cuh"

namespace tpl {
namespace {

__device__ __forceinline__ float stream_row(float d, int u, int v, float x) {
  return __fadd_rn(__fmul_rn(d, x),
                   __fmul_rn(kTiny, __fadd_rn(__int2float_rn(u),
                                              __int2float_rn(v))));
}

template <int kT, int kApt>
__global__ void __launch_bounds__(kT)
probe_stream_soa(const float* __restrict__ d, const int* __restrict__ u,
                 const int* __restrict__ v, const float* __restrict__ x,
                 int m, float* __restrict__ y) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kT * kApt + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kApt; ++i) {
    const long long j = base + static_cast<long long>(i) * kT;
    if (j < m) y[j] = stream_row(d[j], u[j], v[j], x[j]);
  }
}

template <int kT, int kApt>
__global__ void __launch_bounds__(kT)
probe_stream_aos(const float4* __restrict__ rec, int m,
                 float* __restrict__ y) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kT * kApt + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kApt; ++i) {
    const long long j = base + static_cast<long long>(i) * kT;
    if (j < m) {
      const float4 r = rec[j];
      y[j] = stream_row(r.x, __float_as_int(r.y), __float_as_int(r.z), r.w);
    }
  }
}

template <int kT, int kApt>
cudaError_t launch_stream(const float* d, const int* u, const int* v,
                          const float* x, const float4* rec, int m, float* y,
                          cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kT) * kApt;
  const int grid = static_cast<int>((m + per_block - 1) / per_block);
  if (grid < 1) return cudaSuccess;
  if (rec != nullptr) {
    probe_stream_aos<kT, kApt><<<grid, kT, 0, stream>>>(rec, m, y);
  } else {
    probe_stream_soa<kT, kApt><<<grid, kT, 0, stream>>>(d, u, v, x, m, y);
  }
  return cudaGetLastError();
}

template <int kT>
cudaError_t stream_apt(int apt, const float* d, const int* u, const int* v,
                       const float* x, const float4* rec, int m, float* y,
                       cudaStream_t stream) {
  switch (apt) {
    case 1: return launch_stream<kT, 1>(d, u, v, x, rec, m, y, stream);
    case 2: return launch_stream<kT, 2>(d, u, v, x, rec, m, y, stream);
    case 4: return launch_stream<kT, 4>(d, u, v, x, rec, m, y, stream);
    case 8: return launch_stream<kT, 8>(d, u, v, x, rec, m, y, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpl

// Four planes d, u, v, x (m each; rec null) or the (m, 4) record rec (d, u,
// v, x null); threads in {128, 256, 512, 1024}, arcs per thread in {1, 2,
// 4, 8}; y (m) f32. Device pointers; does not synchronise; returns
// cudaGetLastError() (cudaErrorInvalidValue for another block shape).
extern "C" int tpl_probe_stream(const float* d, const int* u, const int* v,
                                const float* x, const float4* rec, int m,
                                int threads, int apt, float* y,
                                cudaStream_t stream) {
  cudaError_t e;
  switch (threads) {
    case 128: e = tpl::stream_apt<128>(apt, d, u, v, x, rec, m, y, stream);
      break;
    case 256: e = tpl::stream_apt<256>(apt, d, u, v, x, rec, m, y, stream);
      break;
    case 512: e = tpl::stream_apt<512>(apt, d, u, v, x, rec, m, y, stream);
      break;
    case 1024: e = tpl::stream_apt<1024>(apt, d, u, v, x, rec, m, y, stream);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
