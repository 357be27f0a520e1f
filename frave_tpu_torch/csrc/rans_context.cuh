// The f32 context chain shared by the step-tensor decode kernels for
// Hopper (sm_90a): kernel D (rans_step_decode.cu) and the tp-sharded step
// kernel DT (rans_tp_decode.cu). One symbol's bucket and prediction from
// its six tap values, as ops/torch_ops.py contexts computes them: every
// product and sum rounded to f32 on its own, left to right (__fmul_rn /
// __fadd_rn, so nothing contracts into an FMA).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 6;
constexpr int kPredClamp = 255;

// The count of edges <= w (NaN and negative widths: 0).
__device__ __forceinline__ int bucket_of(float w, const float* s_edges, int nedges) {
  if (isnan(w)) w = 0.0f;
  w = fmaxf(w, 0.0f);
  int b = 0;
  // the first 16 edges unrolled, so that their loads go out together
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < nedges) b += w >= s_edges[e] ? 1 : 0;
  for (int e = 16; e < nedges; ++e) b += w >= s_edges[e] ? 1 : 0;
  return b;
}

// Context bucket and clamped prediction of one symbol (torch_ops.contexts):
// both the LF and the HF forms, then one bucket search on the chosen width
// (a warp mixes the two kinds, so branches would run both anyway).
__device__ __forceinline__ void lane_context(const int (&v)[kTaps], bool lf, const float* vp,
                                             const float* wp, const float* s_edges, int nedges,
                                             int* bucket, int* pred) {
  const int mx = max(v[0], v[2]);
  const int mn = min(v[0], v[2]);
  const int p_lf = v[1] >= mx ? mx : (v[1] <= mn ? mn : v[0] + v[2] - v[1]);
  float f[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) f[k] = static_cast<float>(v[k]);
  const float g1 = fabsf(__fsub_rn(f[0], f[3]));
  const float g2 = fabsf(__fsub_rn(f[1], f[2]));
  const float g3 = fabsf(__fsub_rn(f[4], f[5]));
  const float g4 = fabsf(__fsub_rn(f[1], f[5]));
  const float g5 = fabsf(__fsub_rn(f[2], f[4]));
  float w = __fadd_rn(wp[0], __fmul_rn(wp[1], g1));
  w = __fadd_rn(w, __fmul_rn(wp[2], g2));
  w = __fadd_rn(w, __fmul_rn(wp[3], g3));
  w = __fadd_rn(w, __fmul_rn(wp[4], g4));
  w = __fadd_rn(w, __fmul_rn(wp[5], g5));
  const float gsum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(g1, g2), g3), g4), g5);
  if (gsum == 0.0f) w = 0.0f;
  float pf = __fmul_rn(f[0], vp[0]);
#pragma unroll
  for (int k = 1; k < kTaps; ++k) pf = __fadd_rn(pf, __fmul_rn(f[k], vp[k]));
  if (isnan(pf)) pf = 0.0f;
  pf = fminf(fmaxf(pf, -1e9f), 1e9f);
  *bucket = bucket_of(lf ? static_cast<float>(abs(v[0] - v[2])) : w, s_edges, nedges);
  const int p = lf ? p_lf : __float2int_rz(pf);
  *pred = min(max(p, -kPredClamp), kPredClamp);
}

}  // namespace
