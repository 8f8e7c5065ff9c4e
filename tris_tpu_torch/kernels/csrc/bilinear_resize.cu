// K6, bilinear half: a stack of float32 planes resized bilinearly.
//
// Replaces tris_tpu/ops/resize.py::bilinear_resize (line 57), which resizes
// [..., H, W] by two HIGHEST-precision products with the interpolation
// matrices; here each output element samples its four taps
// (ops/resize.py::interp_taps, the matrices' two nonzeros per row) with
// tris::sample2: rows first into one value per column tap, then the
// columns, each product and sum rounded on its own (__fmul_rn/__fadd_rn;
// nvcc would otherwise contract a*b + c into an FMA), so the plain PyTorch
// version, which does the same operations in the same order, agrees bit
// for bit. Either align_corners setting: the taps carry it.
//
// Shapes on the IRNet ins-seg path at a 480x640 image: the heads' x2 and x4
// upsamples of [2, 32..256, 30..60, 40..80] (NCHW, planes = 2 * channels),
// the CAM [480, 640] -> the [120, 160] grid (align_corners=True) and the
// walk [K, 120, 160] -> [K, 480, 640] (align_corners=False); one launch each.
//
// Bound: bytes - each output element is four reads that hit L1/L2 (the
// input is read about once from device memory) and one write; six flops.
// Design: one thread per output element, consecutive threads on
// consecutive output columns, so the writes coalesce and the reads of one
// warp fall on one or two input rows.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bilinear_resize_kernel(const float* __restrict__ x, float* __restrict__ out, long long n_out,
                       int h, int w, int oh, int ow, tris::TapArrays ty, tris::TapArrays tx) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int ox = (int)(i % ow);
  const long long t = i / ow;
  const int oy = (int)(t % oh);
  const long long plane = t / oh;
  out[i] = tris::sample2(x + plane * h * w, w, ty.lo[oy], ty.hi[oy], ty.w0[oy], ty.w1[oy],
                         tx.lo[ox], tx.hi[ox], tx.w0[ox], tx.w1[ox]);
}

}  // namespace

cudaError_t tris::bilinear_resize(const float* x, float* out, int64_t planes, int h, int w,
                                  int oh, int ow, TapArrays ty, TapArrays tx,
                                  cudaStream_t stream) {
  const long long n_out = planes * oh * (long long)ow;
  if (n_out == 0) return cudaSuccess;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  bilinear_resize_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(x, out, n_out, h, w, oh, ow,
                                                                    ty, tx);
  return cudaGetLastError();
}
