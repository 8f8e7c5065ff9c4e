// K7, backward: the gradient of aff = 1 - max(edge along each pair's path)
// with respect to the edge map.
//
// The gradient of tris_tpu/pseudo/indexing.py::path_max_affinity_slices
// (line 110), which the JAX package takes by autodiff of vals.max(axis=0):
// reduce_max's VJP splits the cotangent evenly among all the elements equal
// to the max, so an entry (b, d, r, c) whose path max m is reached at
// `count` steps sends -g / count to each of them (torch.amax's backward
// does the same). Ties are real in IRN training: crops are padded with a
// constant, and flat regions give bit-equal edge values.
//
// Two passes, no atomics:
//   1. one thread per entry (b, d, r, c), as the forward: it walks the
//      path's steps again for m and the number of steps equal to m, and
//      writes m and the count to two scratch arrays of aff's shape (m
//      itself, since 1 - (1 - m) need not round back to m);
//   2. one thread per edge pixel (b, y, x): for every direction d and step
//      (dy, dx) of its path, the entry that read this pixel through that
//      step is (r, c) = (y - dy, x - rf - dx); where it lies in the window
//      and this pixel equals its m, the thread subtracts g / count.
//
// Pass 2 divides and adds in double and rounds once to float: up to 2134
// terms reach one pixel at radius 10, and a float sum of them would depend
// on its order (amax's autograd, the plain version, adds them in another
// float order). The result is the exact gradient rounded to float, so it is
// held to the plain version run in float64, and it is the same run to run.
//
// Shapes on the IRN training step (crop 512, radius 10, B = 24): edge
// [24, 128, 128], aff and g [24, 152, 119, 110] (191 MB each); the scratch
// arrays are aff's size (m float, the count one byte).
//
// Bound: bytes - g read once and d edge written once; pass 1 reads the edge
// map through L1/L2 as the forward does and writes the scratch; pass 2 reads
// m at every (direction, step) of every pixel, g and the count where they
// tie. Design: consecutive threads on consecutive columns in both passes, so
// each step's reads coalesce.

#include <math.h>

#include "launchers.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
path_max_prep_kernel(const float* __restrict__ edge, float* __restrict__ pmax,
                     unsigned char* __restrict__ count_out, long long n_out, int H,
                     int W, int rf, int n_dirs, int ch, int cw, const int* __restrict__ steps,
                     const int* __restrict__ offsets) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int c = (int)(i % cw);
  long long t = i / cw;
  const int r = (int)(t % ch);
  t /= ch;
  const int d = (int)(t % n_dirs);
  const long long b = t / n_dirs;
  const float* e = edge + b * H * W + rf + c;
  float m = -INFINITY;
  for (int s = offsets[d]; s < offsets[d + 1]; ++s)
    m = fmaxf(m, e[(steps[2 * s] + r) * W + steps[2 * s + 1]]);
  int count = 0;
  for (int s = offsets[d]; s < offsets[d + 1]; ++s)
    count += e[(steps[2 * s] + r) * W + steps[2 * s + 1]] == m;
  pmax[i] = m;
  count_out[i] = (unsigned char)count;  // a path has at most 255 steps (checked on the host)
}

__global__ void __launch_bounds__(kThreads)
path_max_gather_kernel(const float* __restrict__ edge, const float* __restrict__ g,
                       const float* __restrict__ pmax, const unsigned char* __restrict__ count,
                       float* __restrict__ dedge, long long n_pix,
                       int H, int W, int rf, int n_dirs, int ch, int cw,
                       const int* __restrict__ steps, const int* __restrict__ offsets) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n_pix) return;
  const int x = (int)(i % W);
  const long long t = i / W;
  const int y = (int)(t % H);
  const long long b = t / H;
  const float v = edge[i];
  const long long plane = (long long)ch * cw;
  double acc = 0.0;
  for (int d = 0; d < n_dirs; ++d) {
    const long long base = (b * n_dirs + d) * plane;
    for (int s = offsets[d]; s < offsets[d + 1]; ++s) {
      const int r = y - steps[2 * s], c = x - rf - steps[2 * s + 1];
      if (r < 0 || r >= ch || c < 0 || c >= cw) continue;
      const long long j = base + (long long)r * cw + c;
      if (pmax[j] == v) acc -= (double)g[j] / (double)count[j];
    }
  }
  dedge[i] = __double2float_rn(acc);
}

}  // namespace

cudaError_t tris::path_max_affinity_bwd(const float* edge, const float* g, float* pmax,
                                        unsigned char* count, float* dedge, int64_t B, int H, int W, int rf,
                                        int n_dirs, const int* steps, const int* offsets,
                                        cudaStream_t stream) {
  const int ch = H - rf, cw = W - 2 * rf;
  const long long n_out = B * n_dirs * (long long)ch * cw, n_pix = B * H * (long long)W;
  if (n_pix <= 0) return cudaSuccess;
  if (n_out > 0) {
    path_max_prep_kernel<<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        edge, pmax, count, n_out, H, W, rf, n_dirs, ch, cw, steps, offsets);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  path_max_gather_kernel<<<(unsigned)((n_pix + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      edge, g, pmax, count, dedge, n_pix, H, W, rf, n_dirs, ch, cw, steps, offsets);
  return cudaGetLastError();
}
