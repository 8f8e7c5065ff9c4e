// K9: centroid refinement, 300 steps of c += bilinear(displacement, c).
//
// Replaces tris_tpu/pseudo/labels.py::_refine_centroids (line 71), a
// lax.scan over an [HW, 8] table of each pixel's four corner values of both
// displacement fields (the field edge-replicated to [H + 1, W + 1], corners
// (y, x), (y, x + 1), (y + 1, x), (y + 1, x + 1)). Here one thread per
// pixel keeps its centroid in registers for all the steps and reads the
// corners from the field itself with the +1 index clamped to the last row
// or column: the edge-replicated table's values, without the table.
//
// Exactness: the step's terms are rounded one by one in the JAX order
// (labels.py:105-110): t1 = (n[6:8] * yc) * xc, t2 = (n[2:4] * (1 - yc)) *
// xc, t3 = (n[4:6] * yc) * (1 - xc), t4 = (n[0:2] * (1 - yc)) * (1 - xc),
// v = ((t1 + t2) + t3) + t4, then clip(c + v, 0, size - 1), with
// __fmul_rn/__fadd_rn/__fsub_rn: an FMA contracted by nvcc would move a
// centroid after 300 steps. The end is rintf (round half to even, as
// jnp.round), so the int32 centroids equal the plain version's and JAX's.
//
// Shapes: the stride-4 grid of one image, [2, 120, 160] at 480x640.
// Bound: operations - 300 steps of about 40 flops and 8 loads per pixel
// (the 150 KB field stays in L1/L2); reading the field and writing the
// centroids once is 0.3 MB. Design: the loop has no shared state, so a
// thread never waits for another.

#include <math.h>

#include "launchers.h"

namespace {

constexpr int kThreads = 128;

// The bilinear step of one field at (iy, ix) + (yc, xc), in the JAX term order.
__device__ __forceinline__ float step(const float* __restrict__ f, int row0, int row1, int x0,
                                      int x1, float yc, float xc, float omy, float omx) {
  const float t1 = __fmul_rn(__fmul_rn(f[row1 + x1], yc), xc);
  const float t2 = __fmul_rn(__fmul_rn(f[row0 + x1], omy), xc);
  const float t3 = __fmul_rn(__fmul_rn(f[row1 + x0], yc), omx);
  const float t4 = __fmul_rn(__fmul_rn(f[row0 + x0], omy), omx);
  return __fadd_rn(__fadd_rn(__fadd_rn(t1, t2), t3), t4);
}

__global__ void __launch_bounds__(kThreads)
refine_centroids_kernel(const float* __restrict__ disp, int* __restrict__ out, int H, int W,
                        int iterations) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n = H * W;
  if (i >= n) return;
  const float* fy = disp;
  const float* fx = disp + n;
  const float hmax = (float)(H - 1), wmax = (float)(W - 1);
  float cy = (float)(i / W), cx = (float)(i % W);
  for (int it = 0; it < iterations; ++it) {
    const int iy = (int)floorf(cy), ix = (int)floorf(cx);
    const float yc = __fsub_rn(cy, (float)iy), xc = __fsub_rn(cx, (float)ix);
    const float omy = __fsub_rn(1.f, yc), omx = __fsub_rn(1.f, xc);
    const int row0 = iy * W, row1 = min(iy + 1, H - 1) * W, x1 = min(ix + 1, W - 1);
    const float vy = step(fy, row0, row1, ix, x1, yc, xc, omy, omx);
    const float vx = step(fx, row0, row1, ix, x1, yc, xc, omy, omx);
    cy = fminf(fmaxf(__fadd_rn(cy, vy), 0.f), hmax);
    cx = fminf(fmaxf(__fadd_rn(cx, vx), 0.f), wmax);
  }
  out[i] = (int)rintf(cy);
  out[n + i] = (int)rintf(cx);
}

}  // namespace

cudaError_t tris::refine_centroids(const float* disp, int* out, int H, int W, int iterations,
                                   cudaStream_t stream) {
  const int n = H * W;
  if (n == 0) return cudaSuccess;
  refine_centroids_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      disp, out, H, W, iterations);
  return cudaGetLastError();
}
