// Shared device code of the double-float (df) kernels: K11 the df matvec
// (df_kkt_matvec.cu), K12 one shard's df matvec (df_kkt_shard_matvec.cu),
// K9 df pass one (df_lanczos_pass_one.cu) and K10 df pass two
// (df_lanczos_pass_two.cu), which run K11's rows as a phase of every step.
//
// A df value is the unevaluated sum hi + lo of two floats. A df vector of
// length n is stored in one of two layouts: planar, one contiguous (2, n)
// array, hi plane first (every entry point's arguments, the per-step
// references and the planar K11 they launch); or pairs, a float2 array
// whose element i is (hi_i, lo_i) (the vectors that K9, K10, the pair K11
// and K12 gather from: one 8-byte load, one 32-byte sector an entry, where
// the planes take two). A layout moves values and rounds none. The
// routines below are the counterparts of _df_axpy, _df_scale,
// _df_scalar_sqrt and _df_scalar_recip in
// two_pass_lanczos_tpu/ops/kkt_fused_df.py:118-164, in their operation
// order, on the error-free transformations of
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
// partials[kMaxPartials..]), in one block; every thread gets the pair. The
// partials are read through `load` (CachedLoad in the persistent K9, whose
// other blocks wrote them earlier in the launch).
template <typename Load = DirectLoad>
__device__ __forceinline__ float2 df_fold_partials(const float* partials,
                                                   int g, float* sh,
                                                   float* sl,
                                                   Load load = Load()) {
  float2 acc = make_float2(0.0f, 0.0f);
  for (int i = threadIdx.x; i < g; i += kThreads)
    acc = df_add2(acc.x, acc.y, load(partials + i),
                  load(partials + kMaxPartials + i));
  return block_sum2(acc, sh, sl);
}

// How a df routine reads element i of a df vector, as a pair. Each loader
// carries its vector. Planar: straight from the two planes (the planar K11,
// where the compiler may take the read-only path). Pairs: one 8-byte load,
// straight through the read-only path (__ldg; the pair K11 and K12), with
// ld.global.ca for a vector that other blocks wrote earlier in the same
// launch (the persistent K9 and K10; see CachedLoad), or as the normalised
// v = w (x) (1/beta) of df_scale, read straight from w (K9's matvec phase:
// bitwise what the per-step path's rotate stores, see ScaledLoad). The
// value, and so the arithmetic, depends on neither the layout nor the load.
struct DFDirectLoad {
  const float* xh;
  const float* xl;
  __device__ __forceinline__ float2 operator()(int i) const {
    return make_float2(xh[i], xl[i]);
  }
};
struct DFPairDirectLoad {
  const float2* x;
  __device__ __forceinline__ float2 operator()(int i) const {
    return __ldg(x + i);
  }
};
struct DFPairCachedLoad {
  const float2* x;
  __device__ __forceinline__ float2 operator()(int i) const {
    return __ldca(x + i);
  }
};
struct DFPairScaledLoad {
  const float2* x;
  float sh, sl;  // 1/beta (or 1/||b||) as a df pair
  __device__ __forceinline__ float2 operator()(int i) const {
    const float2 w = __ldca(x + i);
    return df_scale(w.x, w.y, sh, sl);
  }
};

// The two parts of one df KKT matvec, shared by K11 (df_kkt_matvec.cu) and
// K12 (df_kkt_shard_matvec.cu) so that both round alike.
// Arc row j, in the order of _df_emit_matvec: (p, e) = d_j (x) x_j, the
// exact product with cross terms; t = g_u (-) g_v (df_add2 of the gathered
// pairs, which move hi and lo unchanged); y_j = df_add2(p, e, t).
__device__ __forceinline__ float2 df_kkt_arc_row(float dh, float dl, float xh,
                                                 float xl, float guh,
                                                 float gul, float gvh,
                                                 float gvl) {
  const float2 pr = df_prod(dh, dl, xh, xl);
  const float2 t = df_add2(guh, gul, -gvh, -gvl);
  return df_add2(pr.x, pr.y, t.x, t.y);
}

// Node row: the node's CSR segment of +-x_a pairs, each thread folding its
// strided share with df_add2, then the fixed tree of block_sum2. Every
// thread of the block must call it; returns the pair in every thread. x_a
// is read through `load` (a DF*Load above), in either layout.
template <typename Load>
__device__ __forceinline__ float2 df_kkt_node_row(const int* __restrict__ ptr,
                                                  const int* __restrict__ ent,
                                                  int node, float* sh,
                                                  float* sl, Load load) {
  const int end = ptr[node + 1];
  float2 acc = make_float2(0.0f, 0.0f);
  for (int q = ptr[node] + threadIdx.x; q < end; q += kThreads) {
    const int a = ent[q];
    const float2 x = load(a >= 0 ? a : ~a);
    acc = a >= 0 ? df_add2(acc.x, acc.y, x.x, x.y)
                 : df_add2(acc.x, acc.y, -x.x, -x.y);
  }
  return block_sum2(acc, sh, sl);
}

// One block of the df matvec on pairs (the pair K11 and K12): x and y are
// (m + p) pairs, d2 the planar (2, m) costs, streamed. Blocks below
// arc_blocks form one arc row a thread; block arc_blocks + i forms node row
// i. Planar K11 in pairs, bit for bit.
__device__ __forceinline__ void df_kkt_pair_block(
    const float* __restrict__ d2, const int* __restrict__ u,
    const int* __restrict__ v, const int* __restrict__ ptr,
    const int* __restrict__ ent, int m, int arc_blocks,
    const float2* __restrict__ x, float2* __restrict__ y, float* sh,
    float* sl) {
  if (blockIdx.x < arc_blocks) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j < m) {
      const float2 xj = __ldg(x + j);
      const float2 gu = __ldg(x + m + u[j]);
      const float2 gv = __ldg(x + m + v[j]);
      y[j] = df_kkt_arc_row(d2[j], d2[m + j], xj.x, xj.y, gu.x, gu.y, gv.x,
                            gv.y);
    }
    return;  // block-uniform: arc blocks never reach block_sum2
  }
  const int node = blockIdx.x - arc_blocks;
  const float2 total =
      df_kkt_node_row(ptr, ent, node, sh, sl, DFPairDirectLoad{x});
  if (threadIdx.x == 0) y[m + node] = total;
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
