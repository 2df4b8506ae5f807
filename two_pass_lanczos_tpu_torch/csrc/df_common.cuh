// Shared device code of the double-float (df) kernels: K11 the df matvec
// (df_kkt_matvec.cu), K9 df pass one (df_lanczos_pass_one.cu) and K10 df
// pass two (df_lanczos_pass_two.cu).
//
// A df value is the unevaluated sum hi + lo of two floats; a df vector of
// length n is one contiguous (2, n) array, hi plane first. The routines
// below are the counterparts of _df_axpy, _df_scale, _df_scalar_sqrt and
// _df_scalar_recip in two_pass_lanczos_tpu/ops/kkt_fused_df.py:118-164, in
// their operation order, on the error-free transformations of
// lanczos_common.cuh (two_sum, two_prod, df_add2, block_sum2), which K13
// checks as exact on the card. Every operation is an explicit
// round-to-nearest intrinsic, so nvcc can neither contract a product into a
// sum nor reorder: pass one and pass two call the same routines and round
// identically, which is what makes pass two's hi and lo basis bitwise pass
// one's. The float routines of lanczos_common.cuh are untouched.
#pragma once

#include "lanczos_common.cuh"

namespace tpl {

// The df product of (ah, al) and (bh, bl) before renormalisation:
// p + e with p + e0 = ah*bh exactly (two_prod), then
// e = e0 + (ah*bl + al*bh) in that order; al*bl (~2^-98) is below the
// format's resolution and left out, as on the TPU.
__device__ __forceinline__ float2 df_prod(float ah, float al, float bh,
                                          float bl) {
  const float2 p = two_prod(ah, bh);
  return make_float2(
      p.x, __fadd_rn(p.y, __fadd_rn(__fmul_rn(ah, bl), __fmul_rn(al, bh))));
}

// (h, l) squared before renormalisation: e0 + 2*(h*l).
__device__ __forceinline__ float2 df_square(float h, float l) {
  const float2 p = two_prod(h, h);
  return make_float2(p.x, __fadd_rn(p.y, __fmul_rn(2.0f, __fmul_rn(h, l))));
}

// hi = s + e, lo = e - (hi - s): renormalise a pair with |s| >= |e|.
__device__ __forceinline__ float2 fast_two_sum(float s, float e) {
  const float hi = __fadd_rn(s, e);
  return make_float2(hi, __fsub_rn(e, __fsub_rn(hi, s)));
}

// w - a*x, elementwise with scalar a (_df_axpy).
__device__ __forceinline__ float2 df_axpy(float wh, float wl, float a_h,
                                          float a_l, float xh, float xl) {
  const float2 p = df_prod(xh, xl, a_h, a_l);
  return df_add2(wh, wl, -p.x, -p.y);
}

// x*a with scalar a, renormalised (_df_scale).
__device__ __forceinline__ float2 df_scale(float xh, float xl, float a_h,
                                           float a_l) {
  const float2 p = df_prod(xh, xl, a_h, a_l);
  return fast_two_sum(p.x, p.y);
}

// sqrt of a df scalar, Karp-Markstein (_df_scalar_sqrt); a non-positive
// input gives (0, 0).
__device__ __forceinline__ float2 df_scalar_sqrt(float xh, float xl) {
  const float s = __fsqrt_rn(xh > 0.0f ? xh : 1.0f);
  const float2 p = two_prod(s, s);
  const float2 r = df_add2(xh, xl, -p.x, -p.y);
  const float c = __fdiv_rn(r.x, __fmul_rn(2.0f, s));
  const float2 out = fast_two_sum(s, c);
  return xh > 0.0f ? out : make_float2(0.0f, 0.0f);
}

// 1 / (yh, yl) with two Newton corrections (_df_scalar_recip).
__device__ __forceinline__ float2 df_scalar_recip(float yh, float yl) {
  const float q1 = __fdiv_rn(1.0f, yh);
  // r = 1 - y*q1 in df
  float2 p = two_prod(yh, q1);
  p.y = __fadd_rn(p.y, __fmul_rn(yl, q1));
  const float2 r = df_add2(1.0f, 0.0f, -p.x, -p.y);
  const float q2 = __fdiv_rn(r.x, yh);
  float2 p2 = two_prod(yh, q2);
  p2.y = __fadd_rn(p2.y, __fmul_rn(yl, q2));
  const float2 r2 = df_add2(r.x, r.y, -p2.x, -p2.y);
  const float q3 = __fdiv_rn(r2.x, yh);
  const float s = __fadd_rn(q1, q2);
  const float t = __fsub_rn(q2, __fsub_rn(s, q1));
  const float tq = __fadd_rn(t, q3);
  const float hi = __fadd_rn(s, tq);
  return make_float2(hi, __fsub_rn(tq, __fsub_rn(hi, s)));
}

// The df fold of g block partials (hi in partials[0..g), lo in
// partials[kMaxPartials..]), in one block; every thread gets the pair.
__device__ __forceinline__ float2 df_fold_partials(const float* partials,
                                                   int g, float* sh,
                                                   float* sl) {
  float2 acc = make_float2(0.0f, 0.0f);
  for (int i = threadIdx.x; i < g; i += kThreads)
    acc = df_add2(acc.x, acc.y, partials[i], partials[kMaxPartials + i]);
  return block_sum2(acc, sh, sl);
}

// Blocks of an elementwise grid-strided launch over n elements.
inline int df_elementwise_blocks(int n) {
  int g = (n + kThreads - 1) / kThreads;
  return g < 4096 ? g : 4096;
}

// Enqueue one df y = A x of the KKT matrix (df_kkt_matvec.cu): d2 (2, m),
// x2 and y2 (2, m + p). With gate != null the launch is a no-op unless
// gate_lt < *gate, read on the device, as launch_kkt_matvec.
cudaError_t launch_df_kkt_matvec(const float* d2, const int* u, const int* v,
                                 const int* ptr, const int* ent, int m, int p,
                                 const float* x2, float* y2, const int* gate,
                                 int gate_lt, cudaStream_t stream);

}  // namespace tpl
