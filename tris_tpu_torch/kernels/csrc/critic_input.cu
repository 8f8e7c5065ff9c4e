// K5: the critic's input, forward, float32.
//
// Replaces tris_tpu/eval/validate.py::make_prms_forward lines 276-284 (the
// same step is train/stage1.py lines 70-75) and the space-to-depth of
// tris_tpu/models/clip.py::PatchEmbed (lines 199-200): per (image,
// sentence) pair p of image b = p / S, the relu'd response map cams[p] and
// the image's three planes are resized H x W -> n x n (align_corners=True),
// multiplied, and laid out as the patch GEMM's A operand
// [P * g^2, 3 * ps * ps], g = n / ps, with columns (c, py, px) to match the
// OIHW conv1 weight.
//
// Shapes on the PRMS path: P = 32 pairs (8 images x 4 sentences),
// H = W = 320, n = 224, ps = 32 (g = 7): A is [1568, 3072]; one launch per
// batch.
//
// Bound: bytes - the image and the maps read once, A written once (about
// 42 MB); about one flop per byte. Design: one block per (output row y,
// pair); the row taps are the block's constants, and each thread takes an
// output column x, samples the map once and the three image planes with the
// JAX package's taps (ops/resize.py::interp_taps, rows first, as its two
// matmuls), and stores the three products. A warp's 32 columns fall in one
// patch row, so with ps = 32 each store is one 128-byte line. Pair -> image
// is indexed here, so the image is never repeated over sentences, and the
// n x n planes never reach device memory.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
critic_input_kernel(const float* __restrict__ cams, const float* __restrict__ image,
                    float* __restrict__ out, int S, int H, int W, int n, int ps,
                    const int* __restrict__ ylo, const int* __restrict__ yhi,
                    const float* __restrict__ wy0, const float* __restrict__ wy1,
                    const int* __restrict__ xlo, const int* __restrict__ xhi,
                    const float* __restrict__ wx0, const float* __restrict__ wx1) {
  const int y = blockIdx.x, p = blockIdx.y, b = p / S;
  const int g = n / ps, gy = y / ps, py = y % ps, plane = ps * ps;
  const int y0 = ylo[y], y1 = yhi[y];
  const float a0 = wy0[y], a1 = wy1[y];
  const long long hw = (long long)H * W;
  const float* cam = cams + p * hw;
  const float* img = image + b * 3 * hw;
  for (int x = threadIdx.x; x < n; x += kThreads) {
    const int x0 = xlo[x], x1 = xhi[x];
    const float b0 = wx0[x], b1 = wx1[x];
    const float m = tris::sample2(cam, W, y0, y1, a0, a1, x0, x1, b0, b1);
    float* o = out + ((long long)p * g * g + gy * g + x / ps) * 3 * plane + py * ps + x % ps;
    for (int c = 0; c < 3; ++c)
      o[c * plane] =
          __fmul_rn(m, tris::sample2(img + c * hw, W, y0, y1, a0, a1, x0, x1, b0, b1));
  }
}

}  // namespace

cudaError_t tris::critic_input(const float* cams, const float* image, float* out, int P, int S,
                               int H, int W, int n, int ps, const int* ylo, const int* yhi,
                               const float* wy0, const float* wy1, const int* xlo,
                               const int* xhi, const float* wx0, const float* wx1,
                               cudaStream_t stream) {
  critic_input_kernel<<<dim3(n, P), kThreads, 0, stream>>>(
      cams, image, out, S, H, W, n, ps, ylo, yhi, wy0, wy1, xlo, xhi, wx0, wx1);
  return cudaGetLastError();
}
