// K10, transition build: the random walk's dense column-normalised matrix.
//
// Replaces the dense prefix of tris_tpu/pseudo/indexing.py::_walk_program
// (line 441): _affinity_band (:172) assembles the symmetric [HW, HW]
// affinity with unit diagonal from the per-direction path-max grids, and
// _band_to_dense (:236) materialises it; then scaled = dense ** beta and
// trans = scaled / scaled.sum(axis=0) (:519-520). The squarings after it
// stay large matrix products (torch.matmul), as they were XLA's dots.
//
// A direction (dy, dx) with flat offset o = dy * W + dx > 0 links pixel
// s = (r, c) to s + o when r < H - dy and max(0, -dx) <= c < min(W, W - dx)
// (the rectangle of :208-221), with affinity aff[d, r, c + woff]; the
// matrix holds it at (s, s + o) and (s + o, s). Since it is symmetric
// before the normalisation, column j's sum is row j's: 1 + the <= 2 * n_dirs
// affinities ** beta that touch pixel j.
//
// One kernel: a block owns 256 columns and a run of rows. Each thread sums
// its column (1 + <= 68 terms at radius 5; each run of 512 rows recomputes
// them, 68 powf against 512 stores) and then writes its column's element of
// each row: zero off the band, powf(a, beta) / colsum[j] on it (a look-up
// table maps j - i to its direction). powf as torch's CUDA pow by a float
// scalar; the quotient is IEEE-rounded. The column sum adds its terms in
// double, in ascending band offset (a table of the band's nonzero offsets),
// the order in which the plain version adds the band's columns, and rounds
// once to float: kernel and plain version agree bit for bit. (Summed in
// float in two orders, T differed by 3e-6 of its scale at the 128x160
// bucket on an H100, and the walk's eight squarings carried that to 4e-4
// of its max.)
//
// Shapes: a 480x640 image's grid bucketed to 128x160, HW = 20480: T is
// [20480, 20480], 1.68 GB of float32.
// Bound: bytes - the write of T (the band is 1289 of 20480 columns).
// Design: the 256 threads of a block store one row's 1 KB run at a time,
// coalesced; off the band a thread only compares two integers.
//
// Directions must have distinct positive offsets (W > 2 * (radius - 1));
// the wrapper refuses narrower grids, whose shared offsets the plain
// version accumulates.

#include "launchers.h"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 512;
constexpr int kDiag = -2;  // look-up value of offset 0; -1 marks no direction

struct Grid {
  const float* aff;
  const int* dirs;
  int ch, cw, H, W, woff;
};

// Whether source pixel s has a pair in direction d; if so, its affinity ** beta in *v.
__device__ __forceinline__ bool pair_pow(const Grid& g, int d, int s, float beta, float* v) {
  const int dy = g.dirs[2 * d], dx = g.dirs[2 * d + 1];
  const int r = s / g.W, c = s % g.W;
  if (r >= g.H - dy || c < max(0, -dx) || c >= min(g.W, g.W - dx)) return false;
  *v = powf(g.aff[((long long)d * g.ch + r) * g.cw + c + g.woff], beta);
  return true;
}

__global__ void __launch_bounds__(kThreads)
walk_transition_kernel(Grid g, const int* __restrict__ seq, int n_seq,
                       const int* __restrict__ lut, int max_off, float beta,
                       float* __restrict__ out) {
  const int n = g.H * g.W;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  // column j's sum = row j's, over its band offsets o in ascending order:
  // seq[k] = 2 * d + (o > 0) for direction d at o = -+offset(d), -1 the
  // diagonal (1 ** beta); j is the source at o > 0, the destination at o < 0
  double sum = 0.0;
  float v;
  for (int k = 0; k < n_seq; ++k) {
    const int c = seq[k];
    if (c < 0) {
      sum = __dadd_rn(sum, 1.0);
      continue;
    }
    const int d = c >> 1;
    const int src = (c & 1) ? j : j - (g.dirs[2 * d] * g.W + g.dirs[2 * d + 1]);
    if (src >= 0 && pair_pow(g, d, src, beta, &v)) sum = __dadd_rn(sum, (double)v);
  }
  const float colsum = __double2float_rn(sum);
  const int i_end = min(n, (int)(blockIdx.y + 1) * kRowsPerBlock);
  for (int i = blockIdx.y * kRowsPerBlock; i < i_end; ++i) {
    const int off = j - i;
    float t = 0.f;
    if (off >= -max_off && off <= max_off) {
      const int code = lut[off + max_off];
      if (code == kDiag)
        t = __fdiv_rn(1.f, colsum);
      else if (code >= 0 && pair_pow(g, code, off > 0 ? i : j, beta, &v))  // the source
        t = __fdiv_rn(v, colsum);
    }
    out[(long long)i * n + j] = t;
  }
}

}  // namespace

cudaError_t tris::walk_transition(const float* aff, const int* dirs, const int* seq, int n_seq,
                                  const int* lut, float* out, int ch, int cw, int H, int W,
                                  int woff, int max_off, float beta, cudaStream_t stream) {
  const int n = H * W;
  if (n == 0) return cudaSuccess;
  const Grid g{aff, dirs, ch, cw, H, W, woff};
  const dim3 grid((n + kThreads - 1) / kThreads, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  walk_transition_kernel<<<grid, kThreads, 0, stream>>>(g, seq, n_seq, lut, max_off, beta, out);
  return cudaGetLastError();
}
