// K7's tiles: the path table, the staging of a tile and its halo, and the tiled gather that is
// the backward of K7 (path_max_affinity_bwd.cu) and of the IRN loss fused with it
// (irn_affinity.cu).
//
// The pair (d, r, c) of direction d has its source at pixel (r, rf + c) of the [H, W] edge
// map and reads the pixels (r + dy, rf + c + dx) of d's path steps (dy, dx); its affinity is
// 1 - m with m the path's max (tris_tpu/pseudo/indexing.py:110
// path_max_affinity_slices). Its gradient with respect to the edge map, as JAX's reduce_max
// VJP gives it, sends -q = -(d aff) / count to each of the `count` steps equal to m.
//
// The gather: a block owns a tile of pixels of one image (launchers.h::path_tile_plan). It
// stages the edge map over the tile and an rf halo on every side, then takes the directions
// in table order; for direction d the pairs whose path can reach the tile are the tile
// shifted back by d's steps' box, at most (tile_rows + rf) x (tile_cols + 2 rf). Its threads
// first compute, for each such pair, m, the tie count and q into shared memory (q in
// double, as (double)(d aff) / count), then each pixel adds -q over d's steps (dy, dx) whose
// pair (y - dy, x - rf - dx) has m equal to the pixel: directions in table order, steps in
// path order, in double, rounded to float once at the end. So d edge is the exact gradient
// rounded once, whatever the tiling. No atomics, nothing of the pairs' size in device memory.
//
// The table is a kernel parameter (__grid_constant__); a block first copies its steps'
// offsets to shared memory, where every thread of a warp reads the same step at once (read
// from the parameter at a step-dependent index, the loops waited on the constant cache
// once a thread took fewer than four rows). The offsets are in the staged rows' pitch, so
// the same step is +off from a pair's source and -off from a pixel.

#pragma once

#include <math.h>

#include "common.cuh"
#include "launchers.h"

namespace tris {

struct PathTable {
  int n_dirs;
  short begin[kPathTableDirs + 1];     // direction d's steps at [begin[d], begin[d + 1])
  short off[kPathTableSteps];          // a step's dy * pitch + dx
  signed char dy_max[kPathTableDirs];  // the box of d's steps and the pair's source:
  signed char dx_min[kPathTableDirs];  //   0 <= dy <= dy_max, dx_min <= dx <= dx_max
  signed char dx_max[kPathTableDirs];
  signed char dst_dy[kPathTableDirs];  // the pair's destination, the path's first step
  signed char dst_dx[kPathTableDirs];
};

inline PathTable path_table(const PathSteps& t, int pitch) {
  PathTable p{};
  p.n_dirs = t.n_dirs;
  for (int d = 0; d < t.n_dirs; ++d) {
    const int begin = t.offsets[d], end = t.offsets[d + 1];
    int dy_max = 0, dx_min = 0, dx_max = 0;
    for (int s = begin; s < end; ++s) {
      const int dy = t.steps[2 * s], dx = t.steps[2 * s + 1];
      p.off[s] = (short)(dy * pitch + dx);
      dy_max = dy > dy_max ? dy : dy_max;
      dx_min = dx < dx_min ? dx : dx_min;
      dx_max = dx > dx_max ? dx : dx_max;
    }
    p.begin[d] = (short)begin;
    p.dy_max[d] = (signed char)dy_max;
    p.dx_min[d] = (signed char)dx_min;
    p.dx_max[d] = (signed char)dx_max;
    p.dst_dy[d] = (signed char)t.steps[2 * begin];
    p.dst_dx[d] = (signed char)t.steps[2 * begin + 1];
  }
  p.begin[t.n_dirs] = (short)t.offsets[t.n_dirs];
  return p;
}

// The table's step offsets into shared memory (kPathTableSteps int16 at the front of the
// dynamic shared memory); the caller synchronises before reading them.
__device__ __forceinline__ short* stage_offsets(unsigned char* smem, const PathTable& t) {
  short* off = reinterpret_cast<short*>(smem);
  for (int i = threadIdx.x; i < t.begin[t.n_dirs]; i += kPathThreads) off[i] = t.off[i];
  return off;
}

// rows x pitch values of one image's [H, W] plane from (row0, col0) into shared memory; `fill`
// off the image
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int H, int W,
                                           int row0, int col0, int rows, int pitch, T fill) {
  const int n = rows * pitch;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kPathThreads) {
    const int r = i / pitch, c = i - r * pitch, y = row0 + r, x = col0 + c;
    dst[i] = y >= 0 && y < H && x >= 0 && x < W ? src[(long long)y * W + x] : fill;
  }
}

// A pair's class from its source's label a and its destination's b: 0 none (a label at or
// above max_valid), 1 bg positive, 2 fg positive, 3 negative
__device__ __forceinline__ int pair_class(int a, int b, int max_valid) {
  if (a >= max_valid || b >= max_valid) return 0;
  return a != b ? 3 : a == 0 ? 1 : 2;
}

// abs' slope as the JAX package takes it (jnp.abs: 1 where v >= 0, exact zeros included)
__device__ __forceinline__ float sgn(float v) { return v >= 0.f ? 1.f : -1.f; }

// The displacement losses' gradient (d pair_0, d pair_1) of a pair of class cls with source
// values (s0, s1), destination values (t0, t1) and destination offset (dy, dx): a fg pair's
// g_fg * sgn(p - (dy, dx)), a bg pair's g_bg * sgn(p) (p - 0 is p, so one formula)
__device__ __forceinline__ void dp_grad(int cls, float s0, float s1, float t0, float t1, float dy,
                                        float dx, float g_fg, float g_bg, float& g0, float& g1) {
  const bool fg = cls == 2;
  const float gs = fg ? g_fg : g_bg;
  g0 = gs * sgn(__fsub_rn(__fsub_rn(s0, t0), fg ? dy : 0.f));
  g1 = gs * sgn(__fsub_rn(__fsub_rn(s1, t1), fg ? dx : 0.f));
}

// The tiled gather. kLoss: the cotangent of each pair is the IRN loss's d aff from the staged
// labels and the sums' gradients gsum, and the block also gathers d dp (the displacement
// losses' gradient at each pixel as the source, then as the destination, of d's pair, in
// float, directions in table order); else it is g [B, n_dirs, ch, cw] read from device
// memory.
template <int RPT, bool kLoss>
__global__ void __launch_bounds__(kPathThreads)
path_max_gather_kernel(const __grid_constant__ PathTable t, const float* __restrict__ edge,
                       const float* __restrict__ g, const unsigned char* __restrict__ labels,
                       const float* __restrict__ dp, const float* __restrict__ gsum,
                       float* __restrict__ dedge, float* __restrict__ ddp, int H, int W, int rf,
                       int tiles_y, int tiles_x, float eps, float one_eps, int max_valid) {
  constexpr int kWarps = kPathThreads / kPathTileCols, TR = kWarps * RPT;
  const int P = kPathTileCols + 2 * rf, SR = TR + 2 * rf, RR = TR + rf;
  const int ch = H - rf, cw = W - 2 * rf, n_dirs = t.n_dirs;
  extern __shared__ __align__(16) unsigned char smem[];
  const short* soff = stage_offsets(smem, t);
  double* sq = reinterpret_cast<double*>(smem + 2 * kPathTableSteps);  // [RR, P] a direction's q
  float* sm = reinterpret_cast<float*>(sq + RR * P);  // [RR, P] its path max (NaN: no pair)
  float* se = sm + RR * P;                            // [SR, P] the edge map
  float* sd0 = se + SR * P;                           // [SR, P] x 2 dp (kLoss)
  float* sd1 = sd0 + SR * P;
  unsigned char* sl = reinterpret_cast<unsigned char*>(sd1 + SR * P);  // [SR, P] labels

  const int tx = blockIdx.x % tiles_x, ty = blockIdx.x / tiles_x % tiles_y;
  const long long b = blockIdx.x / (tiles_x * tiles_y), hw = (long long)H * W;
  const int y0 = ty * TR, x0 = tx * kPathTileCols;
  stage_tile(se, edge + b * hw, H, W, y0 - rf, x0 - rf, SR, P, NAN);
  if (kLoss) {
    stage_tile(sd0, dp + 2 * b * hw, H, W, y0 - rf, x0 - rf, SR, P, 0.f);
    stage_tile(sd1, dp + 2 * b * hw + hw, H, W, y0 - rf, x0 - rf, SR, P, 0.f);
    stage_tile(sl, labels + b * hw, H, W, y0 - rf, x0 - rf, SR, P, (unsigned char)255);
  }
  // the sums' gradients: bg and fg affinity, negative affinity, fg and bg displacement
  float g_bg = 0.f, g_fg = 0.f, g_neg = 0.f, g_dfg = 0.f, g_dbg = 0.f;
  if (kLoss) {
    g_bg = gsum[0];
    g_fg = gsum[1];
    g_neg = gsum[2];
    g_dfg = gsum[3];
    g_dbg = gsum[4];
  }
  __syncthreads();

  const int lane = threadIdx.x % kPathTileCols, wrow = threadIdx.x / kPathTileCols;
  const int x = x0 + lane;
  int pix[RPT], la[RPT];
  float v[RPT], a0[RPT], a1[RPT], acc0[RPT], acc1[RPT];
  double acc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    pix[k] = (rf + wrow + kWarps * k) * P + rf + lane;
    v[k] = se[pix[k]];  // NaN off the image: ties nothing
    acc[k] = 0.0;
    if (kLoss) {
      la[k] = sl[pix[k]];
      a0[k] = sd0[pix[k]];
      a1[k] = sd1[pix[k]];
      acc0[k] = acc1[k] = 0.f;
    }
  }

  for (int d = 0; d < n_dirs; ++d) {
    const int begin = t.begin[d], end = t.begin[d + 1], doff = soff[begin];
    const int dy_max = t.dy_max[d], dx_max = t.dx_max[d];
    // the pairs whose path reaches the tile: sources at staged rows [rf - dy_max, rf + TR),
    // columns [rf - dx_max, rf + tile_cols - dx_min)
    const int rw = kPathTileCols + dx_max - t.dx_min[d], n = (TR + dy_max) * rw;
    const unsigned magic = 0xffffffffu / rw + 1;  // i / rw = umulhi(i, magic) for i < 2^16
    // kPathPairs pairs a thread at once (i0, i0 + kPathThreads, ...): one table read a step
    // serves them all; a slot past n walks its first pair's path again and stores nothing
    for (int i0 = threadIdx.x; i0 < n; i0 += kPathPairs * kPathThreads) {
      int idx[kPathPairs];
      bool live[kPathPairs];
      float m[kPathPairs], cot[kPathPairs];
      int count[kPathPairs];
#pragma unroll
      for (int u = 0; u < kPathPairs; ++u) {
        const int i = i0 + u * kPathThreads < n ? i0 + u * kPathThreads : i0;
        const int rr = __umulhi((unsigned)i, magic), fr = rf - dy_max + rr;
        const int fc = rf - dx_max + i - rr * rw;
        const int r = y0 - rf + fr, c = x0 - rf + fc - rf;  // the pair (r, c): source (r, rf + c)
        idx[u] = fr * P + fc;
        live[u] = i == i0 + u * kPathThreads && r >= 0 && r < ch && c >= 0 && c < cw;
        if (!live[u] && i == i0 + u * kPathThreads) sm[idx[u]] = NAN;  // off the window
        cot[u] = kLoss || !live[u] ? 0.f : g[((b * n_dirs + d) * ch + r) * (long long)cw + c];
        m[u] = -INFINITY;
        count[u] = 0;
      }
      for (int s = begin; s < end; ++s) {  // the max and how many steps reach it
        const int o = soff[s];
#pragma unroll
        for (int u = 0; u < kPathPairs; ++u) {
          const float e = se[idx[u] + o];
          count[u] = e > m[u] ? 1 : count[u] + (e == m[u]);
          m[u] = fmaxf(m[u], e);
        }
      }
#pragma unroll
      for (int u = 0; u < kPathPairs; ++u) {
        if (!live[u]) continue;
        if (kLoss) {  // d aff of IRN's affinity losses at aff = 1 - m
          const int cls = pair_class(sl[idx[u]], sl[idx[u] + doff], max_valid);
          const float a = __fsub_rn(1.f, m[u]);
          cot[u] = cls == 0   ? 0.f
                   : cls == 3 ? __fdiv_rn(g_neg, __fsub_rn(one_eps, a))
                              : -__fdiv_rn(cls == 1 ? g_bg : g_fg, __fadd_rn(a, eps));
        }
        sm[idx[u]] = m[u];
        // a division only where it is one: a zero (an ignored pair) or a lone max is exact
        sq[idx[u]] = count[u] == 1 || cot[u] == 0.f ? (double)cot[u]
                                                    : (double)cot[u] / (double)count[u];
      }
    }
    __syncthreads();
    for (int s = begin; s < end; ++s) {
      const int o = soff[s];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int j = pix[k] - o;
        if (sm[j] == v[k]) acc[k] -= sq[j];
      }
    }
    if (kLoss) {
      const float fdy = t.dst_dy[d], fdx = t.dst_dx[d];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        // the pixel as the source of d's pair (y, x - rf), then as the destination of the
        // pair (y - dy, x - rf - dx); only bg and fg pairs have a displacement loss
        const int y = y0 + wrow + kWarps * k, r = y - t.dst_dy[d], c = x - rf - t.dst_dx[d];
        const int js = pix[k] + doff, jd = pix[k] - doff;
        const int cs = y < ch && x - rf >= 0 && x - rf < cw ? pair_class(la[k], sl[js], max_valid)
                                                           : 0;
        const int cd = r >= 0 && r < ch && c >= 0 && c < cw ? pair_class(sl[jd], la[k], max_valid)
                                                           : 0;
        float g0, g1;
        dp_grad(cs, a0[k], a1[k], sd0[js], sd1[js], fdy, fdx, g_dfg, g_dbg, g0, g1);
        if (cs == 1 || cs == 2) {
          acc0[k] = __fadd_rn(acc0[k], g0);
          acc1[k] = __fadd_rn(acc1[k], g1);
        }
        dp_grad(cd, sd0[jd], sd1[jd], a0[k], a1[k], fdy, fdx, g_dfg, g_dbg, g0, g1);
        if (cd == 1 || cd == 2) {
          acc0[k] = __fadd_rn(acc0[k], -g0);
          acc1[k] = __fadd_rn(acc1[k], -g1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int y = y0 + wrow + kWarps * k;
    if (y >= H || x >= W) continue;
    const long long p = (long long)y * W + x;
    dedge[b * hw + p] = __double2float_rn(acc[k]);
    if (kLoss) {
      ddp[2 * b * hw + p] = acc0[k];
      ddp[2 * b * hw + hw + p] = acc1[k];
    }
  }
}

// Launch the gather of `plan` (its rpt picks the instantiation).
template <bool kLoss>
cudaError_t launch_path_max_gather(const PathTilePlan& plan, const PathSteps& table,
                                   const float* edge, const float* g,
                                   const unsigned char* labels, const float* dp,
                                   const float* gsum, float* dedge, float* ddp, int H, int W,
                                   int rf, float eps, float one_eps, int max_valid,
                                   cudaStream_t stream) {
  if (plan.blocks <= 0) return cudaSuccess;
  const PathTable t = path_table(table, plan.pitch);
  auto kernel = plan.rpt == 4   ? &path_max_gather_kernel<4, kLoss>
                : plan.rpt == 2 ? &path_max_gather_kernel<2, kLoss>
                                : &path_max_gather_kernel<1, kLoss>;
  cudaError_t err = allow_smem(kernel, (size_t)plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)plan.blocks, kPathThreads, (size_t)plan.smem, stream>>>(
      t, edge, g, labels, dp, gsum, dedge, ddp, H, W, rf, plan.tiles_y, plan.tiles_x, eps,
      one_eps, max_valid);
  return cudaGetLastError();
}

}  // namespace tris
