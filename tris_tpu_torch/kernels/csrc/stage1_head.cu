// K3, training half: the stage-1 classification head, forward and backward,
// float32.
//
// Replaces tris_tpu/models/stage1.py::TRISStage1.__call__ lines 100-131 with
// train=True (and its autodiff): per image b of the batch, with T texts (T = B on one process;
// a rank's B images against the global batch's T texts in a process group, image b's own text
// o = b + offset),
//   score[b, p, q] = exp(logit_scale) * <vis_p[b, p], lan_p[b, q]>   (D channels)
//   feats = [1 (bg); score[b, :, q] for each q]  over the 1+T channels, per pixel p
//   masks = softmax over the channels;  gap, gmp = mean and max over p;
//   cls_out[b, q] = gap + gmp + (1 - mbar)^fp * log(fc + mbar),  mbar = mean_p masks
//   cls_fg[b] = mbar of channel o (no gradient: a metric, as in the JAX package)
//   seg[b] = upsample(score[b, :, o]) h*w -> H*W (align_corners=False);
//   relu_map = relu(seg), sig_map = sigmoid(seg).
//
// Shapes on the stage-1 train path: B = 48, h = w = 10, D = 1024,
// H = W = 320; one launch forward and one backward per step.
//
// Bound: bytes - vis_p (19.7 MB) and lan_p (9.4 MB) read once and the two
// maps (39.3 MB) written once dominate the forward, the maps' gradient read
// once and the two input gradients written once the backward; the score and
// its gradient are small GEMMs (0.47 GFLOP each way, 7 and 14 us at the FP32
// rate). The first design took seven launches: a padded 32 x 32-tile GEMM
// for each contraction, a block per image for the softmax head (48 blocks on
// 132 SMs, serial chains over the texts) and a block per output row for the
// maps, and dscore and a [B, H, w] column sum made the round trip through
// device memory. Design (launchers.h, stage1_head_plan): a cluster of R
// blocks an image, one launch each way.
//  - Forward. Rank r forms the scores of its share of the pixels against all T
//    texts, a tile of 56 pixels by 48 texts a pass: both operands staged 128
//    channels at a time through three shared buffers by cp.async (two stages
//    in flight; two buffers where three do not fit; the copy engine's 1-D
//    copies, a row each on an mbarrier a buffer, took 1.7x as long). A rank's
//    tile is small (50x48 scores at the train step), so the block's eight
//    warps split the channels, not the scores: warp j sums the groups of 4
//    channels j, j + 8, ..., its four steps a stage unrolled, its lanes 4x8, a
//    lane 14 pixels by 6 texts read as float4s (20 loads feed 336 FMAs; a 4x4
//    tile a thread got 2 FMAs a float from the shared-memory pipe, which a
//    16-byte load holds four cycles whatever its lanes share), and the warps'
//    sums are added in warp order: a score's rounding does not depend on R.
//    R=2, a block an SM: a rank's share fits one tile, so the texts' rows are
//    read once a rank. Each rank forms its own pixels' softmax statistics; the
//    ranks copy each other's rows and statistics through distributed shared
//    memory; each rank then writes cls_out on its share of the texts (GAP, GMP
//    with its first argmax, and the focal term of mbar, a warp a text) and
//    both maps on its band of output rows, each row's interpolated score row t
//    = wy0 s[y0] + wy1 s[y1] (w floats) formed once in shared memory, then out
//    = wx0 t[x0] + wx1 t[x1] with the x taps in registers and 16-byte stores,
//    each product and sum rounded alone as tris::sample2 does. The score plane
//    and the statistics (per pixel the softmax max and sum, per text mbar and
//    the argmax) go to device memory once, for the backward.
//  - Backward. Every rank stages the plane and the forward's statistics
//    (cp.async, in flight under the maps' phase); rank r forms d seg on its
//    band of rows (d sig_map * s (1 - s), plus d relu_map where seg > 0): a
//    thread takes four columns and a third of the band, streams its rows in
//    order (float4 loads, the next four rows' in flight while it sums four)
//    and sums each onto the h rows as it goes (the row adjoint, two h rows
//    open at once); the thirds' sums are added once, in order, and each h row
//    reduced onto the w columns (the column adjoint, fmaf chains over its
//    ranges; no atomics). The ranks' [h, w] partials are summed in rank order
//    through distributed shared memory: the gradient is the same run to run.
//    dscore [hw, T] is formed in shared memory, in the plane's place, every
//    element at once; the GMP's gradient goes to the first argmax alone (JAX
//    splits it among tied maxima, as the plain version's amax does; ties have
//    probability zero on continuous scores, and the constant bg row, where all
//    pixels tie, is dropped from cls_out). Rank r then writes d vis_p = scale
//    dscore . lan_p and d lan_p = scale dscore^T . vis_p on its 1/R of the
//    channels, a thread 8 rows by 8 channels (4 loads feed 64 FMAs), the
//    operand's rows staged 8 at a time through three buffers (cp.async) so
//    each is read from device memory once a block: each gradient is written
//    once with 16-byte stores, and dscore never reaches device memory. R=4
//    (192 blocks, two an SM: one wave; clusters of 5 and of 8 took two, and
//    R=2 with 8x16 tiles a thread at 255 registers left too few warps to
//    overlap the loads with the FMAs). The logistic function is the hardware's
//    exp2 and a fast division: IEEE expf and division held the maps and d seg
//    to the issue rate of their dozens of instructions.
// A cluster barrier after each rank's last read of another's shared memory
// keeps every rank's shared memory alive until its readers are done.

#include <cooperative_groups.h>

#include "common.cuh"
#include "launchers.h"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = tris::kStage1HeadThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = tris::kStage1HeadChunk;
constexpr int kPitch = kChunk + tris::kStage1HeadPad;
constexpr int kTileP = tris::kStage1HeadTilePixels, kTileT = tris::kStage1HeadTileTexts;
constexpr int kLaneP = kTileP / 4, kLaneT = kTileT / 8;  // a lane's pixels and texts
constexpr int kMapLoads = tris::kStage1HeadMapLoads;
constexpr int kGradRows = tris::kStage1HeadGradRows;
constexpr int kGradGroups = tris::kStage1HeadGradGroups;
constexpr int kGradChunk = tris::kStage1HeadGradChunk;
constexpr int kGradStages = tris::kStage1HeadGradStages;
static_assert(tris::kStage1HeadKSplit == kWarps, "a warp a split of the channels");
static_assert(kTileP % 4 == 0 && kTileT % 8 == 0, "a warp's lanes are 4 x 8");
static_assert(kChunk % (4 * kWarps) == 0 && kGradRows == 8, "the tiles are read as float4s");
static_assert(kGradStages >= 2 && kGradStages <= 6, "wait_stages takes 2 to 6 buffers");
static_assert(tris::kStage1HeadStages >= 2 && tris::kStage1HeadStages <= 6,
              "wait_stages takes 2 to 6 buffers");

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// A measurement build (nvcc -DTRIS_S1_STAMPS; never the extension) has thread 0 of each block
// write the clock64 cycles of its phases into s1_stamps[block * kS1Stamps + k], k = 1..7 (the
// forward's: the scores, the exchange, the head, the t-rows, the maps, the last barrier; the
// backward's: the plane's issue, d seg onto the partial, the exchange and the plane's arrival,
// the statistics, dscore, the gradients, the last barrier), 0 and 8 %globaltimer at entry and
// exit, 9 the SM. Without the flag the macros are nothing.
constexpr int kS1Stamps = 10;
#ifdef TRIS_S1_STAMPS
__device__ unsigned long long* s1_stamps;
__device__ __forceinline__ unsigned long long s1_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define S1_SLOT(k) \
  s1_stamps[((unsigned long long)blockIdx.y * gridDim.x + blockIdx.x) * kS1Stamps + (k)]
#define S1_STAMP_ENTRY()             \
  long long s1_clock_ = clock64();   \
  if (threadIdx.x == 0) S1_SLOT(0) = s1_globaltimer();
#define S1_PHASE(k)                                         \
  if (threadIdx.x == 0) {                                   \
    const long long t_ = clock64();                         \
    S1_SLOT(k) = (unsigned long long)(t_ - s1_clock_);      \
    s1_clock_ = t_;                                         \
  }
#define S1_STAMP_EXIT()                             \
  if (threadIdx.x == 0) {                           \
    unsigned sm;                                    \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm)); \
    S1_SLOT(8) = s1_globaltimer();                  \
    S1_SLOT(9) = sm;                                \
  }
#else
#define S1_STAMP_ENTRY()
#define S1_PHASE(k)
#define S1_STAMP_EXIT()
#endif

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float focal(float x, float fp, float fc) {
  return powf(1.f - x, fp) * logf(fc + x);
}

__device__ __forceinline__ float focal_grad(float x, float fp, float fc) {
  return -fp * powf(1.f - x, fp - 1.f) * logf(fc + x) + powf(1.f - x, fp) / (fc + x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the logistic function by the hardware's exp2 and a fast division (a few ulps; IEEE's expf and
// division held the maps and d seg to the issue rate of their dozens of instructions). The
// softmax's exps and divisions take the same (within 1e-6 of the masks, inside the bars).
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

// until the oldest of `stages` - 1 groups of copies in flight has landed
__device__ __forceinline__ void wait_stages(int stages) {
  switch (stages) {
    case 2: tris::cp_async_wait<0>(); break;
    case 3: tris::cp_async_wait<1>(); break;
    case 4: tris::cp_async_wait<2>(); break;
    case 5: tris::cp_async_wait<3>(); break;
    default: tris::cp_async_wait<4>(); break;
  }
}

// every rank's rows [q hw / R, (q + 1) hw / R) of the [hw, T] plane, and of its statistics mx
// and z, into this rank's copies
__device__ void gather_plane(cg::cluster_group& cluster, float* plane, float* mx, float* z,
                             int hw, int T, int R, int rank) {
  for (int q = 0; q < R; ++q) {
    if (q == rank) continue;
    const int p0 = q * hw / R, p1 = (q + 1) * hw / R;
    const float* src = cluster.map_shared_rank(plane, q);
    if (T % 4 == 0) {  // rows of 16-byte multiples: the share's floats four at a time
      const float4* s4 = reinterpret_cast<const float4*>(src + p0 * T);
      float4* d4 = reinterpret_cast<float4*>(plane + p0 * T);
#pragma unroll 4
      for (int i = threadIdx.x; i < (p1 - p0) * T / 4; i += kThreads) d4[i] = s4[i];
    } else {
#pragma unroll 4
      for (int i = p0 * T + threadIdx.x; i < p1 * T; i += kThreads) plane[i] = src[i];
    }
    const float* smx = cluster.map_shared_rank(mx, q);
    const float* sz = cluster.map_shared_rank(z, q);
    for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
      mx[p] = smx[p];
      z[p] = sz[p];
    }
  }
}

// Per pixel p in [p0, p1) of the [hw, T] plane, the softmax max mx (over the T scores and the
// bg logit 1) and sum z; a warp a pixel.
__device__ void softmax_stats(const float* plane, int p0, int p1, int T, float* mx, float* z) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = p0 + warp; p < p1; p += kWarps) {
    const float* r = plane + p * T;
    float m = 1.f;
    for (int q = lane; q < T; q += 32) m = fmaxf(m, r[q]);
    m = tris::warp_max(m);
    float s = 0.f;
    for (int q = lane; q < T; q += 32) s += __expf(r[q] - m);
    s = tris::warp_sum(s);
    if (lane == 0) {
      mx[p] = m;
      z[p] = s + __expf(1.f - m);
    }
  }
}

// The t-rows of output rows [y0, y0 + rows): t[r][j] = wy0 own[ylo][j] + wy1 own[yhi][j], each
// product and sum rounded alone; own[p] is the diagonal score plane, at plane[p * stride].
__device__ void t_rows(const float* own, int stride, int w, int y0, int rows, tris::TapArrays ty,
                       float* t) {
  const int n = rows * w, step_r = kThreads / w, step_j = kThreads - step_r * w;
  int r = threadIdx.x / w, j = threadIdx.x - r * w;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int y = y0 + r;
    t[e] = __fadd_rn(__fmul_rn(ty.w0[y], own[(ty.lo[y] * w + j) * stride]),
                     __fmul_rn(ty.w1[y], own[(ty.hi[y] * w + j) * stride]));
    j += step_j;
    r += step_r;
    if (j >= w) {
      j -= w;
      ++r;
    }
  }
}

// seg at kVec columns from c of t-row tr, taps in registers
template <int kVec>
struct ColTaps {
  int lo[kVec], hi[kVec];
  float a[kVec], b[kVec];
  __device__ ColTaps(tris::TapArrays tx, int c, int W) {
    if constexpr (kVec == 4) {  // W % 4 == 0: four columns, four 16-byte loads
      const int4 l4 = *reinterpret_cast<const int4*>(tx.lo + c);
      const int4 h4 = *reinterpret_cast<const int4*>(tx.hi + c);
      const float4 a4 = ld4(tx.w0 + c), b4 = ld4(tx.w1 + c);
      lo[0] = l4.x, lo[1] = l4.y, lo[2] = l4.z, lo[3] = l4.w;
      hi[0] = h4.x, hi[1] = h4.y, hi[2] = h4.z, hi[3] = h4.w;
      a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
      b[0] = b4.x, b[1] = b4.y, b[2] = b4.z, b[3] = b4.w;
    } else {
      const bool in = c < W;
      lo[0] = in ? tx.lo[c] : 0;
      hi[0] = in ? tx.hi[c] : 0;
      a[0] = in ? tx.w0[c] : 0.f;
      b[0] = in ? tx.w1[c] : 0.f;
    }
  }
  __device__ float seg(const float* tr, int k) const {
    return __fadd_rn(__fmul_rn(a[k], tr[lo[k]]), __fmul_rn(b[k], tr[hi[k]]));
  }
};

// out[r][4 g + e] = scale * sum_s a[s][r] op[s][4 g + e] over s = 0..n-1 in order, for the
// rows r < rows and the channel groups g < ng of op and out (rows of D floats in device memory,
// from the rank's first group); a [n][apitch] in shared memory. A thread a tile of kGradRows rows
// by kGradGroups groups q, q + nq, ... (nq = ceil(ng / kGradGroups)); op's rows come through
// `stages` in chunks of kGradChunk rows (cp.async), every thread of the block calling it alike.
__device__ void grad_rows(const float* a, int apitch, int rows, int n,
                          const float* __restrict__ op, float* __restrict__ out, int D, int ng,
                          float scale, float* stages) {
  const int nq = (ng + kGradGroups - 1) / kGradGroups;
  const int tiles = (rows + kGradRows - 1) / kGradRows * nq;
  const int chunks = (n + kGradChunk - 1) / kGradChunk, spitch = 4 * ng, tid = threadIdx.x;
  auto stage = [&](int c) {
    float* dst = stages + c % kGradStages * kGradChunk * spitch;
    for (int i = tid; c < chunks && i < kGradChunk * ng; i += kThreads) {
      const int r = i / ng, g = i - r * ng, s = c * kGradChunk + r;
      tris::cp_async16(dst + r * spitch + 4 * g, s < n ? op + (long long)s * D + 4 * g : op, s < n);
    }
    tris::cp_async_commit();
  };
  for (int base = 0; base < tiles; base += kThreads) {
    const int tile = base + tid;
    const bool active = tile < tiles;
    const int rg = active ? tile / nq : 0, q = active ? tile - rg * nq : 0, r0 = rg * kGradRows;
    float4 acc[kGradRows][kGradGroups];
#pragma unroll
    for (int i = 0; i < kGradRows; ++i)
#pragma unroll
      for (int u = 0; u < kGradGroups; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < kGradStages - 1; ++c) stage(c);
    for (int c = 0; c < chunks; ++c) {
      wait_stages(kGradStages);  // chunk c has landed
      __syncthreads();           // and chunk c - 1's buffer is free
      stage(c + kGradStages - 1);
      const float* buf = stages + c % kGradStages * kGradChunk * spitch;
      if (!active) continue;
#pragma unroll
      for (int e = 0; e < kGradChunk; ++e) {
        // past n the staged operand row is zero: fmaf(d, 0, acc) leaves acc as it is
        const int s = c * kGradChunk + e < n ? c * kGradChunk + e : n - 1;
        float4 o[kGradGroups];
#pragma unroll
        for (int u = 0; u < kGradGroups; ++u)
          o[u] = q + u * nq < ng ? ld4(buf + e * spitch + 4 * (q + u * nq))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 d0 = ld4(a + s * apitch + r0), d1 = ld4(a + s * apitch + r0 + 4);
        const float dd[kGradRows] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int i = 0; i < kGradRows; ++i)
#pragma unroll
          for (int u = 0; u < kGradGroups; ++u) {
            acc[i][u].x = fmaf(dd[i], o[u].x, acc[i][u].x);
            acc[i][u].y = fmaf(dd[i], o[u].y, acc[i][u].y);
            acc[i][u].z = fmaf(dd[i], o[u].z, acc[i][u].z);
            acc[i][u].w = fmaf(dd[i], o[u].w, acc[i][u].w);
          }
      }
    }
    tris::cp_async_wait<0>();
    __syncthreads();  // the stages are free for the next round
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < kGradRows; ++i) {
      if (r0 + i >= rows) break;
      float4* o = reinterpret_cast<float4*>(out + (long long)(r0 + i) * D);
#pragma unroll
      for (int u = 0; u < kGradGroups; ++u)
        if (q + u * nq < ng)
          o[q + u * nq] = make_float4(__fmul_rn(scale, acc[i][u].x), __fmul_rn(scale, acc[i][u].y),
                                      __fmul_rn(scale, acc[i][u].z), __fmul_rn(scale, acc[i][u].w));
    }
  }
}

// Grid (R, B) in clusters of R along x; kVec map columns a thread.
template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
stage1_head_fwd_kernel(const float* __restrict__ vis, const float* __restrict__ lan,
                       const float* __restrict__ scale_ptr, float* __restrict__ score,
                       float* __restrict__ stats, float* __restrict__ cls_out,
                       float* __restrict__ cls_fg, float* __restrict__ relu_map,
                       float* __restrict__ sig_map, int T, int off, int h, int w, int D, int H,
                       int W, int stages, float fp, float fc, tris::TapArrays ty,
                       tris::TapArrays tx) {
  // [hw][T] the image's scores (rounded to 16 bytes), then the operands' stages, later the
  // statistics [2][hw] and the band's t-rows
  extern __shared__ __align__(16) float smem[];
  S1_STAMP_ENTRY();
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.y, hw = h * w, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* plane = smem;
  float* work = smem + round_up(hw * T, 4);

  // 1. the scores of this rank's pixels [p0, p0 + np) against the T texts, a tile of kTileP
  // pixels by kTileT texts a pass: the tile's rows staged (zero past the share and T), then
  // warp j sums the channel groups j, j + kWarps, ... of each stage; lane (pl, tl) the pixels
  // pl + 4 i and texts tl + 8 j of the tile; the warps' sums then added in warp order
  const int p0 = rank * hw / R, np = (rank + 1) * hw / R - p0;
  const float* va = vis + ((long long)b * hw + p0) * D;
  const float* lb = lan + (long long)b * T * D;
  const int chunks = (D + kChunk - 1) / kChunk, ntt = (T + kTileT - 1) / kTileT;
  const int passes = (np + kTileP - 1) / kTileP * ntt;
  constexpr int kRows = kTileP + kTileT;
  const int pl = lane / 8, tl = lane % 8;
  const float scale = *scale_ptr;
  for (int pass = 0; pass < passes; ++pass) {
    const int pt = pass / ntt * kTileP, tt = pass % ntt * kTileT;
    // stage c of the channels into its buffer, as one group of copies (an empty group past D)
    auto stage = [&](int c) {
      float* dst = work + c % stages * kRows * kPitch;
      const int c0 = c * kChunk;
      for (int i = tid; c < chunks && i < kRows * (kChunk / 4); i += kThreads) {
        const int r = i / (kChunk / 4), k = i % (kChunk / 4) * 4;
        const bool pixel = r < kTileP;
        const int row = pixel ? pt + r : tt + r - kTileP;
        const bool valid = row < (pixel ? np : T) && c0 + k < D;
        const float* src = valid ? (pixel ? va : lb) + (long long)row * D + c0 + k : vis;
        tris::cp_async16(dst + r * kPitch + k, src, valid);
      }
      tris::cp_async_commit();
    };
    float acc[kLaneP][kLaneT];
#pragma unroll
    for (int i = 0; i < kLaneP; ++i)
#pragma unroll
      for (int j = 0; j < kLaneT; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < stages - 1; ++c) stage(c);
    for (int c = 0; c < chunks; ++c) {
      wait_stages(stages);  // stage c has landed
      __syncthreads();      // and stage c - 1's buffer is free
      stage(c + stages - 1);
      const float* a = work + c % stages * kRows * kPitch + pl * kPitch;
      const float* l = work + c % stages * kRows * kPitch + (kTileP + tl) * kPitch;
#pragma unroll
      for (int step = 0; step < kChunk / (4 * kWarps); ++step) {
        const int k = 4 * (warp + step * kWarps);
        float4 av[kLaneP], lv[kLaneT];
#pragma unroll
        for (int i = 0; i < kLaneP; ++i) av[i] = ld4(a + 4 * i * kPitch + k);
#pragma unroll
        for (int j = 0; j < kLaneT; ++j) lv[j] = ld4(l + 8 * j * kPitch + k);
#pragma unroll
        for (int i = 0; i < kLaneP; ++i)
#pragma unroll
          for (int j = 0; j < kLaneT; ++j) {
            acc[i][j] = fmaf(av[i].x, lv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, lv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, lv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, lv[j].w, acc[i][j]);
          }
      }
    }
    tris::cp_async_wait<0>();
    __syncthreads();  // the stages are free: the warps' sums take their place
    float* sums = work;  // [kWarps][kTileP][kTileT]
#pragma unroll
    for (int i = 0; i < kLaneP; ++i)
#pragma unroll
      for (int j = 0; j < kLaneT; ++j)
        sums[(warp * kTileP + pl + 4 * i) * kTileT + tl + 8 * j] = acc[i][j];
    __syncthreads();
    for (int e = tid; e < kTileP * kTileT; e += kThreads) {
      const int r = e / kTileT, t = e - r * kTileT;
      if (pt + r < np && tt + t < T) {
        float s = sums[e];
        for (int j = 1; j < kWarps; ++j) s = __fadd_rn(s, sums[j * kTileP * kTileT + e]);
        plane[(p0 + pt + r) * T + tt + t] = __fmul_rn(scale, s);
      }
    }
    __syncthreads();  // the sums are read: the next pass's stages may take their place
  }
  S1_PHASE(1);

  // 2. this rank's pixels' softmax statistics; every rank's rows and statistics into this
  // rank's copies; this rank's rows and statistics to device memory
  float* mx = work;
  float* z = work + round_up(hw, 4);
  softmax_stats(plane, p0, p0 + np, T, mx, z);
  cluster.sync();
  gather_plane(cluster, plane, mx, z, hw, T, R, rank);
  float* out = score + (long long)b * hw * T;
  for (int i = p0 * T + tid; i < (p0 + np) * T; i += kThreads) out[i] = plane[i];
  float* st = stats + b * tris::stage1_head_stats(hw, T);
  for (int p = p0 + tid; p < p0 + np; p += kThreads) {
    st[p] = mx[p];
    st[hw + p] = z[p];
  }
  cluster_arrive();  // this rank reads the others' planes no more
  __syncthreads();
  S1_PHASE(2);

  // 3. cls_out on this rank's texts, a warp a text; mbar and the first argmax to device memory
  for (int q = rank * T / R + warp; q < (rank + 1) * T / R; q += kWarps) {
    float gap = 0.f, gmp = -INFINITY, mbar = 0.f;
    int arg = hw;
    for (int p = lane; p < hw; p += 32) {
      const float v = plane[p * T + q];
      gap += v;
      if (v > gmp) {
        gmp = v;
        arg = p;
      }
      mbar += __fdividef(__expf(v - mx[p]), z[p]);
    }
    gap = tris::warp_sum(gap);
    mbar = tris::warp_sum(mbar) / hw;
    for (int o = 16; o > 0; o >>= 1) {  // the max, at its first pixel
      const float og = __shfl_xor_sync(0xffffffffu, gmp, o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
      if (og > gmp || (og == gmp && oa < arg)) {
        gmp = og;
        arg = oa;
      }
    }
    if (lane == 0) {
      cls_out[(long long)b * T + q] = gap / hw + gmp + focal(mbar, fp, fc);
      st[2 * hw + q] = mbar;
      st[2 * hw + T + q] = (float)arg;
      if (q == b + off) cls_fg[b] = mbar;
    }
  }
  S1_PHASE(3);

  // 4. the maps on this rank's band of output rows [y0, y0 + nrows): the t-rows once, then a
  // thread kVec columns of group q (its x taps in registers) and every rpar-th row from r0
  const int y0 = rank * H / R, nrows = (rank + 1) * H / R - y0;
  float* t = z + round_up(hw, 4);
  t_rows(plane + b + off, T, w, y0, nrows, ty, t);
  __syncthreads();
  S1_PHASE(4);
  const int groups = (W + kVec - 1) / kVec;
  const int tgroups = groups < kThreads ? groups : kThreads, rpar = kThreads / tgroups;
  const int r0 = tid / tgroups;
  for (int q = tid - r0 * tgroups; r0 < rpar && q < groups; q += tgroups) {
    const int c = q * kVec;
    const ColTaps<kVec> taps(tx, c, W);
    for (int r = r0; r < nrows; r += rpar) {
      float rv[kVec], sv[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float v = taps.seg(t + r * w, k);
        rv[k] = fmaxf(v, 0.f);
        sv[k] = sigmoid(v);
      }
      const long long o = ((long long)b * H + y0 + r) * W + c;
      if constexpr (kVec == 4) {
        *reinterpret_cast<float4*>(relu_map + o) = make_float4(rv[0], rv[1], rv[2], rv[3]);
        *reinterpret_cast<float4*>(sig_map + o) = make_float4(sv[0], sv[1], sv[2], sv[3]);
      } else {
        relu_map[o] = rv[0];
        sig_map[o] = sv[0];
      }
    }
  }
  S1_PHASE(5);
  cluster_wait();  // no rank leaves while another may still read its plane
  S1_PHASE(6);
  S1_STAMP_EXIT();
}

// Grid (R, B) in clusters of R along x; kVec map columns a thread.
template <int kVec>
__global__ void __launch_bounds__(kThreads, 2)
stage1_head_bwd_kernel(const float* __restrict__ g_cls, const float* __restrict__ g_relu,
                       const float* __restrict__ g_sig, const float* __restrict__ vis,
                       const float* __restrict__ lan, const float* __restrict__ scale_ptr,
                       const float* __restrict__ score, const float* __restrict__ stats,
                       float* __restrict__ d_vis, float* __restrict__ d_lan, int T, int off, int h,
                       int w, int D, int H, int W, float fp, float fc, tris::TapArrays ty,
                       tris::TapArrays tx, tris::TapRanges ry, tris::TapRanges rx) {
  extern __shared__ __align__(16) float smem[];
  S1_STAMP_ENTRY();
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.y, hw = h * w, tid = threadIdx.x;
  const int band = (H + R - 1) / R, tq = round_up(T, 8), hq = round_up(hw, 8);
  const int vhw = round_up(hw, 4), vt = round_up(T, 4), vband = round_up(band * w, 4);
  const int G = D / 4, g0 = rank * G / R, ng = (rank + 1) * G / R - g0;
  float* plane = smem;          // [hw][tq] the scores, then the masks, then dscore
  float* own = plane + hw * tq;  // [hw] the diagonal plane
  float* part = own + vhw;      // [hw] this rank's d seg partial (the others read it)
  float* down = part + vhw;     // [hw] d seg, every rank's partial summed
  float* mx = down + vhw;       // [hw] the softmax max and sum, from the forward
  float* z = mx + vhw;
  float* dot = z + vhw;
  float* gc = dot + vhw;  // [T] d cls_out[b]
  float* gq = gc + vt;    // [T] mbar, then the focal term's gradient a pixel
  int* am = reinterpret_cast<int*>(gq + vt);  // [T] the first argmax
  float* trow = reinterpret_cast<float*>(am + vt);  // [band][w] the t-rows
  // the row groups' d seg on the h rows [kMapGroups][h][map pitch]; then dscore transposed
  // [T][hq] and the gradients' operand stages [kGradStages][kGradChunk][4 groups]
  float* big = trow + vband;

  // 0. the plane and the per-pixel statistics in flight; the diagonal, d cls_out[b] and the
  // per-text statistics now
  const float* sp = score + (long long)b * hw * T;
  const float* st = stats + b * tris::stage1_head_stats(hw, T);
  for (int i = tid; i < hw * T; i += kThreads) {
    const int p = i / T;
    tris::cp_async4(plane + p * tq + i - p * T, sp + i, true);
  }
  for (int p = tid; p < hw; p += kThreads) {
    tris::cp_async4(mx + p, st + p, true);
    tris::cp_async4(z + p, st + hw + p, true);
    own[p] = sp[p * T + b + off];
  }
  tris::cp_async_commit();
  for (int q = tid; q < T; q += kThreads) {
    gc[q] = g_cls[(long long)b * T + q];
    gq[q] = st[2 * hw + q];
    am[q] = (int)st[2 * hw + T + q];
  }
  __syncthreads();
  S1_PHASE(1);

  // 1. d seg on this rank's band [y0, y0 + nrows), onto its [h, w] partial. A thread takes
  // kVec columns and a row group's rows (rgroups sub-bands), streams them in order kMapLoads rows
  // at a time (their loads first) and sums each onto the h rows as it goes (two h rows open at
  // once: a row's taps are lo and lo + 1 or lo alone); the row groups' sums are then added in
  // order on each column, and each h row reduced onto the w columns.
  const int y0 = rank * H / R, nrows = (rank + 1) * H / R - y0;
  if (g_sig || g_relu) {
    const int groups = (W + kVec - 1) / kVec, tg = groups < kThreads ? groups : kThreads;
    const int rgroups = tris::stage1_head_map_groups(W);
    const int pitch = tris::stage1_head_map_pitch(W), rg = tid / tg;
    for (int i = tid; i < rgroups * h * pitch; i += kThreads) big[i] = 0.f;
    t_rows(own, 1, w, y0, nrows, ty, trow);
    __syncthreads();
    const int ya = y0 + rg * nrows / rgroups, yb = y0 + (rg + 1) * nrows / rgroups;
    for (int q = tid - rg * tg; rg < rgroups && q < groups && ya < yb; q += tg) {
      const int c = q * kVec;
      const ColTaps<kVec> taps(tx, c, W);
      float* u = big + rg * h * pitch + c;
      int cur = ty.lo[ya];
      float acc_a[kVec], acc_b[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc_a[k] = acc_b[k] = 0.f;
      // rows [y, y + kMapLoads) of g_sig into g (zero past yb)
      auto load = [&](int y, float (&g)[kMapLoads][kVec]) {
#pragma unroll
        for (int e = 0; e < kMapLoads; ++e) {
          const long long o = ((long long)b * H + y + e) * W + c;
          const bool in = y + e < yb && g_sig;
          if constexpr (kVec == 4) {
            const float4 s4 = in ? __ldg(reinterpret_cast<const float4*>(g_sig + o))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            g[e][0] = s4.x, g[e][1] = s4.y, g[e][2] = s4.z, g[e][3] = s4.w;
          } else {
            g[e][0] = in ? g_sig[o] : 0.f;
          }
        }
      };
      float gcur[kMapLoads][kVec], gnext[kMapLoads][kVec];
      load(ya, gcur);
      for (int y = ya; y < yb; y += kMapLoads) {
        if (y + kMapLoads < yb) load(y + kMapLoads, gnext);  // in flight while these are summed
        // the batch's d seg first, every row's independent of the others
        float dseg[kMapLoads][kVec];
#pragma unroll
        for (int e = 0; e < kMapLoads; ++e) {
          const int yy = y + e < yb ? y + e : yb - 1;
          const long long o = ((long long)b * H + yy) * W + c;
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const float v = taps.seg(trow + (yy - y0) * w, k);
            const float sg = sigmoid(v);
            float d = __fmul_rn(__fmul_rn(gcur[e][k], sg), 1.f - sg);
            if (g_relu && v > 0.f) d = __fadd_rn(d, g_relu[o + k]);
            dseg[e][k] = d;
          }
        }
        // then onto the h rows, in order
#pragma unroll
        for (int e = 0; e < kMapLoads; ++e) {
          const int yy = y + e;
          if (yy >= yb) break;
          const int lo = ty.lo[yy], hi = ty.hi[yy];
          const float a0 = ty.w0[yy], a1 = ty.w1[yy];
          while (lo > cur) {  // h row cur takes no more: it goes to shared memory
#pragma unroll
            for (int k = 0; k < kVec; ++k) {
              if (c + k < W) u[cur * pitch + k] = acc_a[k];
              acc_a[k] = acc_b[k];
              acc_b[k] = 0.f;
            }
            ++cur;
          }
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            acc_a[k] = fmaf(a0, dseg[e][k], acc_a[k]);
            if (hi == cur)
              acc_a[k] = fmaf(a1, dseg[e][k], acc_a[k]);
            else
              acc_b[k] = fmaf(a1, dseg[e][k], acc_b[k]);
          }
        }
#pragma unroll
        for (int e = 0; e < kMapLoads; ++e)
#pragma unroll
          for (int k = 0; k < kVec; ++k) gcur[e][k] = gnext[e][k];
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (c + k >= W) continue;
        u[cur * pitch + k] = acc_a[k];
        if (cur + 1 < h) u[(cur + 1) * pitch + k] = acc_b[k];
      }
    }
    __syncthreads();
    // the row groups' sums added in order, into the first's rows
    for (int i = tid; i < h * W; i += kThreads) {
      const int r = i / W, e = r * pitch + i - r * W;
      float v = big[e];
      for (int g = 1; g < rgroups; ++g) v = __fadd_rn(v, big[g * h * pitch + e]);
      big[e] = v;
    }
    __syncthreads();
    // a thread an (h row, w column), a chain over the column adjoint's ranges
    for (int p = tid; p < hw; p += kThreads) {
      const int i = p / w, j = p - i * w;
      const float* ur = big + i * pitch;
      float acc = 0.f;
#pragma unroll 8
      for (int x = rx.lo_begin[j]; x < rx.lo_end[j]; ++x) acc = fmaf(tx.w0[x], ur[x], acc);
#pragma unroll 8
      for (int x = rx.hi_begin[j]; x < rx.hi_end[j]; ++x) acc = fmaf(tx.w1[x], ur[x], acc);
      part[p] = acc;
    }
  } else {
    for (int p = tid; p < hw; p += kThreads) part[p] = 0.f;
  }
  S1_PHASE(2);

  // 2. the ranks' partials summed in rank order
  cluster.sync();
  for (int p = tid; p < hw; p += kThreads) {
    float s = 0.f;
    for (int q = 0; q < R; ++q) s = __fadd_rn(s, cluster.map_shared_rank(part, q)[p]);
    down[p] = s;
  }
  cluster_arrive();  // this rank reads the others' partials no more
  tris::cp_async_wait<0>();
  __syncthreads();
  S1_PHASE(3);

  // 3. the masks in the plane's place and the focal term's gradient a pixel; then
  // dot[p] = sum_q mask[p, q] gq[q], a thread a pixel
  for (int i = tid; i < hw * T; i += kThreads) {
    const int p = i / T, e = p * tq + i - p * T;
    plane[e] = __fdividef(__expf(plane[e] - mx[p]), z[p]);
  }
  for (int q = tid; q < T; q += kThreads) gq[q] = gc[q] * focal_grad(gq[q], fp, fc) / hw;
  __syncthreads();
  for (int p = tid; p < hw; p += kThreads) {
    const float* m = plane + p * tq;
    float acc = 0.f;
    for (int q = 0; q < T; ++q) acc = fmaf(m[q], gq[q], acc);
    dot[p] = acc;
  }
  __syncthreads();
  S1_PHASE(4);

  // 4. dscore in the plane's place ([hw][tq]) and transposed ([T][hq])
  float* ds = plane;
  float* dsT = big;
  float* ops = big + T * hq;  // the gradients' operand stages
  for (int i = tid; i < hw * T; i += kThreads) {
    const int p = i / T, q = i - p * T, e = p * tq + q;
    float d = gc[q] / hw + plane[e] * (gq[q] - dot[p]);
    if (p == am[q]) d += gc[q];
    if (q == b + off) d += down[p];
    ds[e] = d;
    dsT[q * hq + p] = d;
  }
  __syncthreads();
  S1_PHASE(5);

  // 5. this rank's channel groups [g0, g0 + ng) of d vis_p (rows: the pixels, a chain over the
  // texts) and of d lan_p (rows: the texts, a chain over the pixels)
  const float scale = *scale_ptr;
  const long long vb = (long long)b * hw * D + 4 * g0, lb = (long long)b * T * D + 4 * g0;
  grad_rows(dsT, hq, hw, T, lan + lb, d_vis + vb, D, ng, scale, ops);
  grad_rows(ds, tq, T, hw, vis + vb, d_lan + lb, D, ng, scale, ops);
  S1_PHASE(6);
  cluster_wait();  // no rank leaves while another may still read its partial
  S1_PHASE(7);
  S1_STAMP_EXIT();
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const tris::Stage1HeadPlan& p, int B, cudaStream_t stream,
                   tris::Stage1HeadLaunchShape* shape, Args... args) {
  cudaError_t err = tris::allow_smem(kernel, (size_t)p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ranks, B);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {p.blocks, p.ranks, p.threads, p.vec, p.smem};
  return err;
}

}  // namespace

#ifdef TRIS_S1_STAMPS
// The measurement build's stamp buffer (tools/stage1_head_phases.py).
extern "C" cudaError_t s1_set_stamps(unsigned long long* stamps) {
  return cudaMemcpyToSymbol(s1_stamps, &stamps, sizeof(stamps));
}
#endif

cudaError_t tris::stage1_head(const float* vis_p, const float* lan_p, const float* scale,
                              float* score, float* stats, float* cls_out, float* cls_fg,
                              float* relu_map, float* sig_map, int B, int T, int offset, int h,
                              int w, int D, int H, int W, float focal_p, float focal_c,
                              TapArrays ty, TapArrays tx, cudaStream_t stream,
                              Stage1HeadLaunchShape* shape) {
  const Stage1HeadPlan p = stage1_head_plan(B, T, h, w, D, H, W, false);
  const auto kernel = p.vec == 4 ? &stage1_head_fwd_kernel<4> : &stage1_head_fwd_kernel<1>;
  return launch(kernel, p, B, stream, shape, vis_p, lan_p, scale, score, stats, cls_out, cls_fg,
                relu_map, sig_map, T, offset, h, w, D, H, W, p.stages, focal_p, focal_c, ty, tx);
}

cudaError_t tris::stage1_head_bwd(const float* g_cls, const float* g_relu, const float* g_sig,
                                  const float* vis_p, const float* lan_p, const float* scale,
                                  const float* score, const float* stats, float* d_vis,
                                  float* d_lan, int B, int T, int offset, int h, int w, int D,
                                  int H, int W, float focal_p, float focal_c, TapArrays ty,
                                  TapArrays tx, TapRanges ry, TapRanges rx, cudaStream_t stream,
                                  Stage1HeadLaunchShape* shape) {
  const Stage1HeadPlan p = stage1_head_plan(B, T, h, w, D, H, W, true);
  const auto kernel = p.vec == 4 ? &stage1_head_bwd_kernel<4> : &stage1_head_bwd_kernel<1>;
  return launch(kernel, p, B, stream, shape, g_cls, g_relu, g_sig, vis_p, lan_p, scale, score,
                stats, d_vis, d_lan, T, offset, h, w, D, H, W, focal_p, focal_c, ty, tx, ry, rx);
}
