// K7, forward: pixel-pair affinities as 1 - max(edge along the pair's path).
//
// Replaces tris_tpu/pseudo/indexing.py::path_max_affinity_slices (line 110),
// which stacks one static slice of the edge map per path step,
// edge[dy : dy + ch, rf + dx : rf + dx + cw], and takes their max per
// direction. Here one thread per (image, direction, window pixel) walks that
// direction's path steps (a small table of (dy, dx) built on the host from
// PathIndex.paths_by_length, directions in the path-length groups' concat
// order that the walk and the IRN loss read) and writes 1 - max. A max is
// exact and so is 1 - m (__fsub_rn), so the kernel equals its plain version
// and the JAX package bit for bit. Any radius: the table carries it.
//
// Shapes: the random walk at radius 5 reads the padded [H + 5, W + 10] edge
// map of a bucketed grid (a 480x640 image: [133, 170]) and writes
// [34, 129, 162]; IRN training (radius 10) batches [B, 128, 128].
//
// Bound: bytes - one read of the edge map (the path steps' reads of
// neighbouring pixels hit L1/L2) and one write per (direction, pixel).
// Design: consecutive threads on consecutive window columns, so each step's
// reads and the write coalesce; the table (a few hundred ints) stays in L1.

#include <math.h>

#include "launchers.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
path_max_kernel(const float* __restrict__ edge, float* __restrict__ out, long long n_out, int H,
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
  out[i] = __fsub_rn(1.f, m);
}

}  // namespace

cudaError_t tris::path_max_affinity(const float* edge, float* out, int64_t B, int H, int W,
                                    int rf, int n_dirs, const int* steps, const int* offsets,
                                    cudaStream_t stream) {
  const int ch = H - rf, cw = W - 2 * rf;
  const long long n_out = B * n_dirs * (long long)ch * cw;
  if (n_out <= 0) return cudaSuccess;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  path_max_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(edge, out, n_out, H, W, rf, n_dirs,
                                                             ch, cw, steps, offsets);
  return cudaGetLastError();
}
