// K13 backward: BatchNorm with the activation that follows it, three launches.
//
// Replaces the gradient of tris_tpu/models/layers.py:181 TorchBatchNorm's train path
// (:219-229) and of the ReLU, residual add + ReLU or PReLU after it (see batch_norm.cu).
// With g = dL/dout, x-hat = (x - mean) * rstd, dz = dL/dy (y = x-hat * w + b) and n = M =
// N * HW per channel:
//   dz     = g * act'                   (ReLU: out > 0; PReLU: 1 where y >= 0, else a)
//   dw     = sum(dz * x-hat),  db = sum(dz),  da = sum(g * y over y < 0)   (PReLU's slope)
//   dx     = (w * rstd) * ((dz - db / n) - x-hat * (dw / n))   (batch statistics)
//   dx     = dz * w                                            (the eval fold: w is a)
//   dres   = dz                                                (the residual's gradient)
// The forward keeps x, mean and rstd, and its output where the activation is ReLU: out > 0
// is the ReLU's mask exactly. PReLU's pre-activation is recomputed from x with the
// forward's operations, so its mask is the forward's bit for bit.
//
// batch_norm_bwd_partial_kernel: a warp per (channel, sample, slice of the plane), the
// statistics' partition (launchers.h), sums dz, dz * x-hat and the slope's terms in double,
// the lanes in a fixed xor tree. batch_norm_bwd_final_kernel: a warp per channel adds its
// N * slices partials (lane l those from l in steps of 32, then the xor tree): dw, db and the
// two coefficients, each rounded once, and the channel's slope sum in double.
// batch_norm_bwd_apply_kernel: a thread per 4 elements (float4, as the forward's apply)
// writes dx and dres; for PReLU its first warp also adds the channels' slope sums in a fixed
// order into dslope. No atomics: the same bits run to run.
//
// Bound: bytes. The sums read g and x (and out); the apply reads them again and writes dx
// (and dres).

#include "batch_norm.cuh"

namespace {

using namespace tris::bn;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
batch_norm_bwd_partial_kernel(const float* __restrict__ g, const float* __restrict__ x,
                              const float* __restrict__ out, const float* __restrict__ mean,
                              const float* __restrict__ rstd, const float* __restrict__ w,
                              const float* __restrict__ b, const float* __restrict__ slope,
                              double* __restrict__ partial, int N, int C, int HW, int slices,
                              long long warps, int act) {
  const long long wi = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (wi >= warps) return;
  const int lane = threadIdx.x % 32;
  const SliceWarp sw = slice_warp(wi, N, C, HW, slices);
  const Channel p = channel(mean, rstd, w, b, sw.c);
  const float a = slope != nullptr ? *slope : 0.f;
  const float* gp = g + sw.plane;
  const float* xp = x + sw.plane;
  const float* op = out != nullptr ? out + sw.plane : nullptr;
  double sdz = 0.0, sdzx = 0.0, sslope = 0.0;
  if (kVec) {
    for (int e = sw.e0 + 4 * lane; e < sw.e1; e += 4 * 32) {
      const float4 gv = *reinterpret_cast<const float4*>(gp + e);
      const float4 xv = *reinterpret_cast<const float4*>(xp + e);
      const float4 ov = op != nullptr ? *reinterpret_cast<const float4*>(op + e)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      const float gs[4] = {gv.x, gv.y, gv.z, gv.w}, xs[4] = {xv.x, xv.y, xv.z, xv.w},
                  os[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xh = xhat(xs[j], p);
        const float dz = grad_z(gs[j], xh, os[j], p, act, a, sslope);
        sdz += dz;
        sdzx += (double)dz * (double)xh;
      }
    }
  } else {
    for (int e = sw.e0 + lane; e < sw.e1; e += 32) {
      const float xh = xhat(xp[e], p);
      const float dz = grad_z(gp[e], xh, op != nullptr ? op[e] : 0.f, p, act, a, sslope);
      sdz += dz;
      sdzx += (double)dz * (double)xh;
    }
  }
  sdz = warp_sum(sdz);
  sdzx = warp_sum(sdzx);
  sslope = warp_sum(sslope);
  if (lane == 0) {
    partial[3 * wi] = sdz;
    partial[3 * wi + 1] = sdzx;
    partial[3 * wi + 2] = sslope;
  }
}

// A warp per channel over its `parts` = N * slices partials; slope_sums [C] or null.
__global__ void __launch_bounds__(kThreads)
batch_norm_bwd_final_kernel(const double* __restrict__ partial, float* __restrict__ coef,
                            float* __restrict__ dw, float* __restrict__ db,
                            double* __restrict__ slope_sums, int C, int parts, long long M) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (c >= C) return;
  const double* q = partial + 3 * (long long)c * parts;
  double sdz = 0.0, sdzx = 0.0, sslope = 0.0;
  for (int j = lane; j < parts; j += 32) {
    sdz += q[3 * j];
    sdzx += q[3 * j + 1];
    sslope += q[3 * j + 2];
  }
  sdz = warp_sum(sdz);
  sdzx = warp_sum(sdzx);
  sslope = warp_sum(sslope);
  if (lane != 0) return;
  dw[c] = (float)sdzx;
  db[c] = (float)sdz;
  coef[c] = (float)(sdz / (double)M);
  coef[C + c] = (float)(sdzx / (double)M);
  if (slope_sums != nullptr) slope_sums[c] = sslope;
}

// dx (and dres) of one element
__device__ __forceinline__ float grad_x(float g, float x, float o, const Channel& p, int act,
                                        float a, float k1, float k2, float& dz) {
  double unused = 0.0;
  const float xh = xhat(x, p);
  dz = grad_z(g, xh, o, p, act, a, unused);
  if (!p.norm) return __fmul_rn(dz, p.w);
  return __fmul_rn(__fmul_rn(p.w, p.rstd), __fsub_rn(__fsub_rn(dz, k1), __fmul_rn(xh, k2)));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
batch_norm_bwd_apply_kernel(const float* __restrict__ g, const float* __restrict__ x,
                            const float* __restrict__ out, const float* __restrict__ mean,
                            const float* __restrict__ rstd, const float* __restrict__ w,
                            const float* __restrict__ b, const float* __restrict__ slope,
                            const float* __restrict__ coef,
                            const double* __restrict__ slope_sums, float* __restrict__ dslope,
                            float* __restrict__ dx, float* __restrict__ dres, long long total,
                            int C, int HW, int act) {
  if (dslope != nullptr && blockIdx.x == 0 && threadIdx.x < 32) {   // the channels' slope sums
    double t = 0.0;
    for (int c = threadIdx.x; c < C; c += 32) t += slope_sums[c];
    t = warp_sum(t);
    if (threadIdx.x == 0) *dslope = (float)t;
  }
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * (kVec ? 4 : 1);
  if (i >= total) return;
  const int c = (int)(((unsigned)i / (unsigned)HW) % (unsigned)C);
  const Channel p = channel(mean, rstd, w, b, c);
  const float a = slope != nullptr ? *slope : 0.f;
  const float k1 = p.norm ? coef[c] : 0.f, k2 = p.norm ? coef[C + c] : 0.f;
  if (kVec) {
    const float4 gv = *reinterpret_cast<const float4*>(g + i);
    const float4 xv = *reinterpret_cast<const float4*>(x + i);
    const float4 ov = out != nullptr ? *reinterpret_cast<const float4*>(out + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 dz;
    const float4 d = make_float4(grad_x(gv.x, xv.x, ov.x, p, act, a, k1, k2, dz.x),
                                 grad_x(gv.y, xv.y, ov.y, p, act, a, k1, k2, dz.y),
                                 grad_x(gv.z, xv.z, ov.z, p, act, a, k1, k2, dz.z),
                                 grad_x(gv.w, xv.w, ov.w, p, act, a, k1, k2, dz.w));
    *reinterpret_cast<float4*>(dx + i) = d;
    if (dres != nullptr) *reinterpret_cast<float4*>(dres + i) = dz;
  } else {
    float dz;
    dx[i] = grad_x(g[i], x[i], out != nullptr ? out[i] : 0.f, p, act, a, k1, k2, dz);
    if (dres != nullptr) dres[i] = dz;
  }
}

}  // namespace

namespace tris {

cudaError_t batch_norm_bwd(const float* g, const float* x, const float* out, const float* mean,
                           const float* rstd, const float* weight, const float* bias,
                           const float* slope, double* partial, float* coef, float* dweight,
                           float* dbias, float* dslope, float* dx, float* dres, int N, int C,
                           int HW, int act, cudaStream_t stream) {
  const long long M = (long long)N * HW, total = M * C;
  const int slices = (int)batch_norm_slices(HW);
  const long long warps = (long long)C * N * slices;
  double* slope_sums = dslope != nullptr ? partial + 3 * warps : nullptr;
  const bool vec = HW % 4 == 0 && bn::aligned16(g) && bn::aligned16(x) && bn::aligned16(out) &&
                   bn::aligned16(dx) && bn::aligned16(dres);
  const unsigned blocks = (unsigned)((warps + bn::kWarps - 1) / bn::kWarps);
  if (vec)
    batch_norm_bwd_partial_kernel<true><<<blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, slope, partial, N, C, HW, slices, warps, act);
  else
    batch_norm_bwd_partial_kernel<false><<<blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, slope, partial, N, C, HW, slices, warps, act);
  batch_norm_bwd_final_kernel<<<(C + bn::kWarps - 1) / bn::kWarps, bn::kThreads, 0, stream>>>(
      partial, coef, dweight, dbias, slope_sums, C, N * slices, M);
  const long long items = vec ? total / 4 : total;
  const unsigned apply_blocks = (unsigned)((items + bn::kThreads - 1) / bn::kThreads);
  if (vec)
    batch_norm_bwd_apply_kernel<true><<<apply_blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, slope, coef, slope_sums, dslope, dx, dres, total, C,
        HW, act);
  else
    batch_norm_bwd_apply_kernel<false><<<apply_blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, slope, coef, slope_sums, dslope, dx, dres, total, C,
        HW, act);
  return cudaGetLastError();
}

}  // namespace tris
