// What K13's kernels (batch_norm.cu, batch_norm_bwd.cu) share: the partition of a channel
// among warps (one per (channel, sample, slice of the sample's plane)), the fixed-order sums
// in double, and the per-element arithmetic of the norm and its activation, each product and
// sum rounded alone (__fmul_rn / __fadd_rn, so the compiler contracts nothing into an FMA)
// in the plain version's order.
#pragma once

#include <cuda_runtime.h>

#include "launchers.h"

namespace tris {
namespace bn {

constexpr int kThreads = kBatchNormThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = kBatchNormSlice;

// Warp w of a launch over (channel, sample, slice): warp w = (c * N + n) * slices + slice
// (launchers.h); its elements are [e0, e1) of the plane x + plane.
struct SliceWarp {
  int c, n, e0, e1;
  long long plane;
};

__device__ __forceinline__ SliceWarp slice_warp(long long w, int N, int C, int HW, int slices) {
  SliceWarp s;
  const int sl = (int)(w % slices);
  const long long cn = w / slices;
  s.n = (int)(cn % N);
  s.c = (int)(cn / N);
  s.plane = ((long long)s.n * C + s.c) * HW;
  s.e0 = sl * kSlice;
  s.e1 = min(s.e0 + kSlice, HW);
  return s;
}

// The warp's sum of v on every lane, the lanes added in a fixed xor tree.
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One channel's normalisation: with `norm`, x-hat = (x - mean) * rstd; without (the eval
// fold), x-hat = x. Then y = x-hat * w + b.
struct Channel {
  float mean, rstd, w, b;
  bool norm;
};

__device__ __forceinline__ Channel channel(const float* mean, const float* rstd,
                                           const float* w, const float* b, int c) {
  Channel p;
  p.norm = mean != nullptr;
  p.mean = p.norm ? mean[c] : 0.f;
  p.rstd = p.norm ? rstd[c] : 1.f;
  p.w = w[c];
  p.b = b[c];
  return p;
}

__device__ __forceinline__ float xhat(float x, const Channel& p) {
  return p.norm ? __fmul_rn(__fsub_rn(x, p.mean), p.rstd) : x;
}

__device__ __forceinline__ float affine(float xh, const Channel& p) {
  return __fadd_rn(__fmul_rn(xh, p.w), p.b);
}

// The activation of v (the norm's output plus the residual, where one is added).
__device__ __forceinline__ float activate(float v, int act, float a) {
  if (act == kBatchNormActRelu) return v < 0.f ? 0.f : v;
  if (act == kBatchNormActPrelu) return v >= 0.f ? v : __fmul_rn(a, v);
  return v;
}

// The gradient at the norm's output (dz) from g = dL/dout: ReLU's mask from the output
// `o` (out > 0 exactly where the input of the ReLU is), PReLU's from the recomputed
// pre-activation y (the forward's bits), whose slope gradient gets g * y where y < 0.
__device__ __forceinline__ float grad_z(float g, float xh, float o, const Channel& p, int act,
                                        float a, double& dslope) {
  if (act == kBatchNormActRelu) return o > 0.f ? g : 0.f;
  if (act == kBatchNormActPrelu) {
    const float y = affine(xh, p);
    if (y >= 0.f) return g;
    dslope += (double)g * (double)y;
    return __fmul_rn(a, g);
  }
  return g;
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace bn
}  // namespace tris
