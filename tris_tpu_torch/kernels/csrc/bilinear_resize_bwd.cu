// K6, bilinear half, backward: the adjoint of the resize, d x = Ry^T . g . Rx.
//
// The gradient of tris_tpu/ops/resize.py::bilinear_resize (line 57), which
// the JAX package takes by autodiff of its two HIGHEST-precision matrix
// products; the forward here is bilinear_resize.cu, which samples the
// matrices' two taps per output index (ops/resize.py::interp_taps). With
// those taps, for an input element (Y, X):
//   R[oy, X]  = sum_{ox: lo(ox) = X} wx0[ox] g[oy, ox] + sum_{ox: hi(ox) = X} wx1[ox] g[oy, ox]
//   dx[Y, X]  = sum_{oy: lo(oy) = Y} wy0[oy] R[oy, X] + sum_{oy: hi(oy) = Y} wy1[oy] R[oy, X]
// The taps are monotone, so each sum runs over one contiguous range of
// output indices, built once on the host (kernels/response_head.py::
// adjoint_taps_on). A gather with no atomics: one thread per input element
// sums its terms in a fixed order, so the gradient is the same run to run
// (the plain version's index backward scatters, with atomics on CUDA).
//
// Shapes on the IRN training step (crop 512, B = 24): the heads' upsamples,
// g [24, 32, 128, 128] -> [24, 32, 64, 64] (x2) and [24, 32, 32, 32] (x4) for
// the edge taps, [24, 256, 64, 64] -> [24, 256, 32, 32] (x2) for dp4 and
// dp5, and [24, 256, 128, 128] -> [24, 256, 64, 64] (x2) for dp6; one launch
// each.
//
// Bound: bytes - g read once (the terms of neighbouring inputs overlap and
// hit L1/L2) and dx written once; 2 flops per term, 16 terms per input at x2
// and 64 at x4. Design: consecutive threads on consecutive input columns,
// so a warp's reads of g fall on a few contiguous runs of one or two rows.

#include "launchers.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bilinear_resize_bwd_kernel(const float* __restrict__ g, float* __restrict__ dx, long long n_in,
                           int h, int w, int oh, int ow, tris::TapArrays ty, tris::TapArrays tx,
                           tris::TapRanges ry, tris::TapRanges rx) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n_in) return;
  const int X = (int)(i % w);
  const long long t = i / w;
  const int Y = (int)(t % h);
  const float* gp = g + (t / h) * oh * (long long)ow;
  const int xlb = rx.lo_begin[X], xle = rx.lo_end[X], xhb = rx.hi_begin[X], xhe = rx.hi_end[X];
  // R[oy, X] for one output row
  auto row = [&](int oy) {
    const float* r = gp + (long long)oy * ow;
    float acc = 0.f;
    for (int ox = xlb; ox < xle; ++ox) acc = fmaf(tx.w0[ox], r[ox], acc);
    for (int ox = xhb; ox < xhe; ++ox) acc = fmaf(tx.w1[ox], r[ox], acc);
    return acc;
  };
  float acc = 0.f;
  for (int oy = ry.lo_begin[Y]; oy < ry.lo_end[Y]; ++oy) acc = fmaf(ty.w0[oy], row(oy), acc);
  for (int oy = ry.hi_begin[Y]; oy < ry.hi_end[Y]; ++oy) acc = fmaf(ty.w1[oy], row(oy), acc);
  dx[i] = acc;
}

}  // namespace

cudaError_t tris::bilinear_resize_bwd(const float* g, float* dx, int64_t planes, int h, int w,
                                      int oh, int ow, TapArrays ty, TapArrays tx, TapRanges ry,
                                      TapRanges rx, cudaStream_t stream) {
  const long long n_in = planes * h * (long long)w;
  if (n_in == 0) return cudaSuccess;
  const long long blocks = (n_in + kThreads - 1) / kThreads;
  bilinear_resize_bwd_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(g, dx, n_in, h, w, oh, ow,
                                                                        ty, tx, ry, rx);
  return cudaGetLastError();
}
