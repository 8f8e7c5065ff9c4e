// K7, forward: pixel-pair affinities as 1 - max(edge along the pair's path).
//
// Replaces tris_tpu/pseudo/indexing.py::path_max_affinity_slices (line 110), which
// stacks one static slice of the edge map per path step,
// edge[dy : dy + ch, rf + dx : rf + dx + cw], and takes their max per
// direction. The path table (each direction's (dy, dx) steps, built on the host from
// PathIndex.paths_by_length, directions in the path-length groups' concat order that the
// walk and the IRN loss read) gives every pair (b, d, r, c) of the window [H - rf, W - 2 rf]
// the max m over d's steps of edge[b, r + dy, rf + c + dx]; out[b, d, r, c] = 1 - m. A max is
// exact and so is 1 - m (__fsub_rn), and both kernels take the steps in table order from
// -inf, so each equals its plain version and the JAX package bit for bit.
//
// Shapes: the random walk at radius 5 reads the padded [H + 5, W + 10] edge map of a
// bucketed grid (a 480x640 image: [133, 170]) and writes [34, 129, 162] (242 path steps);
// at radius 10 (IRN training's [B, 128, 128], which its fused loss now takes instead)
// [B, 152, 119, 110] (2134 steps).
//
// Bound: bytes - the write of n_dirs values a pair (the edge map is read once and is small).
// What the first design (the direct kernel below, a thread an output) met instead was the
// instructions it issued: four 64-bit divisions to split its index, the table read from
// device memory at a step-dependent index and the edge map read from L1 at every step - 10x
// its bound at both radii.
//
// Design: the tiles of path_max_tiles.cuh over pairs (launchers.h::path_tile_plan,
// kPathMaxForward). A block issues the staging of one tile's edge map and its halo by
// cp.async (tile_rows + rf rows of kPathTileCols + 2 rf values, -inf off the image, which no
// max takes), copies its directions' step offsets from the table, passed as a
// __grid_constant__ kernel parameter, into shared memory meanwhile, and waits for both. Each
// thread owns one column and rpt rows of the tile and, for each direction of its block's
// group in table order, takes the max over the direction's steps from shared memory (the
// step's offset read once for the warp, the same address for every lane; the steps unrolled
// by 4, so that their loads overlap) and writes 1 - m: a warp's 32 consecutive columns are
// one 128-byte store. No division on the path.
//
// At radius 5 the window (102 tiles of 8 x 32 pairs) is too small to fill the card, so the
// plan splits a tile's 34 directions between 2 blocks (204 blocks; 1, 2, 4 and 8 groups were
// timed, tools/kernel_ab.py). A block there lives about 4-5 us: its first reads of the
// parameter (the constant cache's misses, the staging hidden behind them), then its
// directions' short chains of dependent shared loads, with the launch and the blocks'
// staggered starts around them (tools/path_max_phases.py). At radius 10 (384 blocks, 3 an SM,
// each living the whole call) the directions' shared loads hold it: 5 a step for 4 rows (the
// offset and 4 values), issued below one a clock an SM.
//
// The direct kernel stays for tables the kernel parameter cannot hold (past kPathTableSteps
// steps or kPathTableDirs directions: radius 13 and up); launchers.h::path_max_forward_tiled
// chooses.
//
// A measurement build (nvcc -DTRIS_K7_STAMPS; never the extension) has thread 0 of each tiled
// block write the clock64 cycles of its phases into k7_stamps[block * kK7Stamps + k], k = 1..3
// (the staging issued and the table's copy, the staging's wait with the barrier's, the
// directions), 0 and 4
// %globaltimer at entry and exit, 5 the SM (tools/path_max_phases.py).

#include <math.h>

#include "path_max_tiles.cuh"

namespace {

using tris::kPathThreads;
using tris::kPathTileCols;

constexpr int kDirectThreads = 256;  // the direct kernel's block

constexpr int kK7Stamps = 6;
#ifdef TRIS_K7_STAMPS
__device__ unsigned long long* k7_stamps;
__device__ __forceinline__ unsigned long long k7_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K7_SLOT(k) k7_stamps[(unsigned long long)blockIdx.x * kK7Stamps + (k)]
#define K7_STAMP_ENTRY()           \
  long long k7_clock_ = clock64(); \
  if (threadIdx.x == 0) K7_SLOT(0) = k7_globaltimer();
#define K7_PHASE(k)                                    \
  if (threadIdx.x == 0) {                              \
    const long long t_ = clock64();                    \
    K7_SLOT(k) = (unsigned long long)(t_ - k7_clock_); \
    k7_clock_ = t_;                                    \
  }
#define K7_STAMP_EXIT()                             \
  if (threadIdx.x == 0) {                           \
    unsigned sm;                                    \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm)); \
    K7_SLOT(4) = k7_globaltimer();                  \
    K7_SLOT(5) = sm;                                \
  }
#else
#define K7_STAMP_ENTRY()
#define K7_PHASE(k)
#define K7_STAMP_EXIT()
#endif

__global__ void __launch_bounds__(kDirectThreads)
path_max_kernel(const float* __restrict__ edge, float* __restrict__ out, long long n_out, int H,
                int W, int rf, int n_dirs, int ch, int cw, const int* __restrict__ steps,
                const int* __restrict__ offsets) {
  const long long i = blockIdx.x * (long long)kDirectThreads + threadIdx.x;
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

template <int RPT>
__global__ void __launch_bounds__(kPathThreads)
path_max_tiled_kernel(const __grid_constant__ tris::PathTable t, const float* __restrict__ edge,
                      float* __restrict__ out, int H, int W, int rf, int tiles_y, int tiles_x,
                      int groups) {
  constexpr int kWarps = kPathThreads / kPathTileCols, TR = kWarps * RPT;
  const int P = kPathTileCols + 2 * rf, SR = TR + rf, ch = H - rf, cw = W - 2 * rf;
  const int n_dirs = t.n_dirs;
  extern __shared__ __align__(16) unsigned char smem[];
  short* soff = reinterpret_cast<short*>(smem);
  float* se = reinterpret_cast<float*>(smem + 2 * tris::kPathTableSteps);  // [SR, P] edge map
  K7_STAMP_ENTRY();

  const int group = blockIdx.x % groups, tile = blockIdx.x / groups;
  const int tx = tile % tiles_x, ty = tile / tiles_x % tiles_y;
  const long long b = tile / (tiles_x * tiles_y), hw = (long long)H * W;
  const int d0 = n_dirs * group / groups, d1 = n_dirs * (group + 1) / groups;
  const int r0 = ty * TR, c0 = tx * kPathTileCols;  // the tile's first pair (r0, c0)
  // the tile and its halo from the tile's first pair (r0, c0), in flight while the table's
  // offsets are copied
  const float* plane0 = edge + b * hw;
  for (int i = threadIdx.x; i < SR * P; i += kPathThreads) {
    const int y = r0 + i / P, x = c0 + i % P;
    if (y < H && x < W)
      tris::cp_async4(se + i, plane0 + (long long)y * W + x, true);
    else
      se[i] = -INFINITY;
  }
  tris::cp_async_commit();
  for (int i = t.begin[d0] + threadIdx.x; i < t.begin[d1]; i += kPathThreads) soff[i] = t.off[i];
  K7_PHASE(1);
  tris::cp_async_wait<0>();
  __syncthreads();
  K7_PHASE(2);

  const int lane = threadIdx.x % kPathTileCols, wrow = threadIdx.x / kPathTileCols;
  const int c = c0 + lane;
  const long long plane = (long long)ch * cw;
  int pix[RPT];
  bool live[RPT];
  float* dst[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int row = wrow + kWarps * k, r = r0 + row;
    pix[k] = row * P + rf + lane;  // the source pixel of the pair (r, c)
    live[k] = r < ch && c < cw;
    dst[k] = out + (b * n_dirs + d0) * plane + (long long)r * cw + c;
  }
  for (int d = d0; d < d1; ++d) {
    float m[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) m[k] = -INFINITY;
#pragma unroll 4
    for (int s = t.begin[d]; s < t.begin[d + 1]; ++s) {
      const int o = soff[s];
#pragma unroll
      for (int k = 0; k < RPT; ++k) m[k] = fmaxf(m[k], se[pix[k] + o]);
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (live[k]) *dst[k] = __fsub_rn(1.f, m[k]);
      dst[k] += plane;
    }
  }
  K7_PHASE(3);
  K7_STAMP_EXIT();
}

}  // namespace

#ifdef TRIS_K7_STAMPS
// The measurement build's stamp buffer (tools/path_max_phases.py).
extern "C" cudaError_t k7_set_stamps(unsigned long long* stamps) {
  return cudaMemcpyToSymbol(k7_stamps, &stamps, sizeof(stamps));
}
#endif

cudaError_t tris::path_max_affinity(const PathTilePlan* plan, const PathSteps& table,
                                    const int* dev_steps, const int* dev_offsets,
                                    const float* edge, float* out, int64_t B, int H, int W,
                                    int rf, cudaStream_t stream, PathMaxLaunchShape* shape) {
  const int ch = H - rf, cw = W - 2 * rf, n_dirs = table.n_dirs;
  const long long n_out = B * n_dirs * (long long)ch * cw;
  if (plan == nullptr) {
    const long long blocks = (n_out + kDirectThreads - 1) / kDirectThreads;
    *shape = {0, blocks, kDirectThreads, 1, 1, 0};
    if (n_out <= 0) return cudaSuccess;
    path_max_kernel<<<(unsigned)blocks, kDirectThreads, 0, stream>>>(
        edge, out, n_out, H, W, rf, n_dirs, ch, cw, dev_steps, dev_offsets);
    return cudaGetLastError();
  }
  *shape = {1, plan->blocks, kPathThreads, plan->rpt, plan->dir_groups, plan->smem};
  if (n_out <= 0) return cudaSuccess;
  const PathTable t = path_table(table, plan->pitch);
  auto kernel = plan->rpt == 4   ? &path_max_tiled_kernel<4>
                : plan->rpt == 2 ? &path_max_tiled_kernel<2>
                                 : &path_max_tiled_kernel<1>;
  cudaError_t err = allow_smem(kernel, (size_t)plan->smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)plan->blocks, kPathThreads, (size_t)plan->smem, stream>>>(
      t, edge, out, H, W, rf, plan->tiles_y, plan->tiles_x, plan->dir_groups);
  return cudaGetLastError();
}
