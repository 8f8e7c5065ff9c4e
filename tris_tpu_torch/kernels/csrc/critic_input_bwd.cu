// K5 backward: the gradient of the critic's input with respect to the maps,
// float32.
//
// The gradient of tris_tpu/train/stage1.py::stage1_loss lines 70-73 (the
// align_corners=True resize of the sigmoid map and of the image to the
// critic's size, their product) and of the space-to-depth of
// tris_tpu/models/clip.py::PatchEmbed, which the JAX package takes by
// autodiff. The image is data and gets no gradient. From dA
// [P * g^2, 3 * ps * ps] (columns (c, py, px), as the forward writes A):
//   d cam_n[p, y, x] = sum_c dA[p, y, x, c] * img_n[p / S, c, y, x]
// with img_n the image resized to n x n by the forward's taps (recomputed),
// then the adjoint of the H x W -> n x n resize of the map:
//   dt[p, y, X] = sum_{x: lo(x) = X} wx0[x] d cam_n[p, y, x] + sum_{x: hi(x) = X} wx1[x] ...
//   d cams[p, Y, X] = sum_{y: lo(y) = Y} wy0[y] dt[p, y, X] + sum_{y: hi(y) = Y} wy1[y] ...
// The taps are monotone, so each sum runs over a contiguous range of output
// indices, computed once on the host (kernels/response_head.py::
// adjoint_taps_on). A gather, with no atomics: the gradient is the same run
// to run (the plain version's index backward scatters with atomics and can
// differ by ulps from run to run).
//
// Shapes on the stage-1 train path: P = 48 maps, S = 1, 320 -> 224, ps = 32
// (g = 7): dA [2352, 3072]; one call per step (2 launches).
//
// Bound: bytes - dA (28.9 MB) and the image (58.9 MB) read once, d cams
// (19.7 MB) written once. Design: pass 1, one block per (row y of n, map p):
// threads over the n columns read dA's three channel values (a warp reads
// 128-byte lines within one patch row), sample the image's three planes and
// keep d cam_n's row in shared memory, then threads over the W source
// columns gather it into dt[p, y, :] (scratch [P, n, W], 13.8 MB). Pass 2,
// one block per (source row Y, map p): threads over X gather dt's rows.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = 256;

// grid (n, P). smem: d cam_n's row [n].
__global__ void __launch_bounds__(kThreads)
cols_kernel(const float* __restrict__ dA, const float* __restrict__ image, float* __restrict__ dt,
            int S, int H, int W, int n, int ps, tris::TapArrays ty, tris::TapArrays tx,
            tris::TapRanges rx) {
  extern __shared__ float row[];
  const int y = blockIdx.x, p = blockIdx.y, b = p / S;
  const int g = n / ps, gy = y / ps, py = y % ps, plane = ps * ps;
  const int y0 = ty.lo[y], y1 = ty.hi[y];
  const float a0 = ty.w0[y], a1 = ty.w1[y];
  const long long hw = (long long)H * W;
  const float* img = image + b * 3 * hw;
  for (int x = threadIdx.x; x < n; x += kThreads) {
    const int x0 = tx.lo[x], x1 = tx.hi[x];
    const float b0 = tx.w0[x], b1 = tx.w1[x];
    const float* d = dA + ((long long)p * g * g + gy * g + x / ps) * 3 * plane + py * ps + x % ps;
    float acc = 0.f;
    for (int c = 0; c < 3; ++c)
      acc = fmaf(d[c * plane], tris::sample2(img + c * hw, W, y0, y1, a0, a1, x0, x1, b0, b1), acc);
    row[x] = acc;
  }
  __syncthreads();
  float* o = dt + ((long long)p * n + y) * W;
  for (int X = threadIdx.x; X < W; X += kThreads) {
    float acc = 0.f;
    for (int x = rx.lo_begin[X]; x < rx.lo_end[X]; ++x) acc = fmaf(tx.w0[x], row[x], acc);
    for (int x = rx.hi_begin[X]; x < rx.hi_end[X]; ++x) acc = fmaf(tx.w1[x], row[x], acc);
    o[X] = acc;
  }
}

// grid (H, P): d cams[p, Y, :].
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ dt, float* __restrict__ dcams, int H, int W, int n,
            tris::TapArrays ty, tris::TapRanges ry) {
  const int Y = blockIdx.x, p = blockIdx.y;
  const float* d = dt + (long long)p * n * W;
  float* o = dcams + ((long long)p * H + Y) * W;
  const int lb = ry.lo_begin[Y], le = ry.lo_end[Y], hb = ry.hi_begin[Y], he = ry.hi_end[Y];
  for (int X = threadIdx.x; X < W; X += kThreads) {
    float acc = 0.f;
    for (int y = lb; y < le; ++y) acc = fmaf(ty.w0[y], d[(long long)y * W + X], acc);
    for (int y = hb; y < he; ++y) acc = fmaf(ty.w1[y], d[(long long)y * W + X], acc);
    o[X] = acc;
  }
}

}  // namespace

cudaError_t tris::critic_input_bwd(const float* dA, const float* image, float* dt, float* dcams,
                                   int P, int S, int H, int W, int n, int ps, TapArrays ty,
                                   TapArrays tx, TapRanges ry, TapRanges rx,
                                   cudaStream_t stream) {
  cols_kernel<<<dim3(n, P), kThreads, sizeof(float) * n, stream>>>(dA, image, dt, S, H, W, n, ps,
                                                                   ty, tx, rx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_kernel<<<dim3(H, P), kThreads, 0, stream>>>(dt, dcams, H, W, n, ty, ry);
  return cudaGetLastError();
}
