// K4: the eval resize, normalise and metrics step, forward, float32.
//
// Replaces tris_tpu/eval/validate.py::_resize_norm_valid + _metrics_core
// (lines 102-153): each [h, w] response map of image b is upsampled
// (align_corners=True) to that image's ORIGINAL size (oh_b, ow_b), divided by
// (its max over that region + 1e-5), thresholded at 1e-9, and reduced to
// I = |pred & gt|, U = |pred | gt|, the peak (row-major first tie, flat index
// with stride maxW) and hit (peak inside the inclusive gt box) / hitm (gt at
// the peak). Alternatively it writes the normalised [maxH, maxW] plane, zero
// outside (oh_b, ow_b), for callers that need the maps on the host.
//
// Shapes on the stage-1 eval path: [B=8, S=4] maps of 320x320 to originals
// of up to 640x640; PRMS's selected maps [8, 1], and their normalised planes
// when it saves CAMs. One launch per batch.
//
// Bound: bytes - the maps read once and the gt masks over each valid region;
// only [B, S] scalars are written (or the padded planes). The work is two
// passes over up to 640 x 640 samples a map: one block a map leaves the card
// nearly empty (32 blocks at [8, 4], 8 at [8, 1]) and runs the passes in
// series on one SM. Design (launchers.h, eval_metrics_plan): a cluster of R
// blocks a map, grid (R, S, B), rank r owning a contiguous band of the map's
// valid output rows. A rank copies its rows' y taps into shared memory, then
// forms the band's interpolated rows t = wy0 x[y0] + wy1 x[y1] (w floats
// each, every product and sum rounded alone, so the bits are
// tris::sample2's) once there, from float4 loads: t depends only on (output
// row, input column), so it is not formed again for each output column and
// pass. A thread owns an output column (consecutive lanes on consecutive
// columns, so the reads of t hit distinct banks or broadcast) and holds its
// x taps in registers for every row of the band. Pass 1 samples the columns
// from t and takes the band's max; the ranks push their maxes into every
// rank's shared memory, meet at one cluster barrier, and each takes the max
// over all ranks (exact in any order). Pass 2 samples again. v = RN(u / d),
// d = max + 1e-5, does not decrease in u where d > 0, so every warp finds by
// search the least u whose v passes the threshold 1e-9 and the least u whose
// v equals the peak RN(max / d), and the samples are compared with those two
// cuts instead of divided (where d <= 0 each sample is divided by
// __fdiv_rn); the gt mask is read eight rows ahead (a warp reads 32
// consecutive bytes), I and U are counted as integers and the lowest flat
// index at the peak kept for the argmax; the ranks push those into rank 0,
// which combines them in rank order after a second barrier and writes the
// four stats. Integer sums and a lowest-index argmax do not depend on the
// order, and no atomics are used: the bits equal the plain version's on
// every run. With the plane requested, each rank writes its band, four
// columns a thread (16-byte stores where maxW % 4 == 0), and its share of the
// zero rows below oh after the max exchange.

#include <cooperative_groups.h>
#include <limits.h>

#include "common.cuh"
#include "launchers.h"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = tris::kEvalThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaskBatch = 8;      // gt bytes a thread has in flight in pass 2

// The cluster's barrier: relaxed (this block has started), or releasing this block's writes
// (to its own and the other ranks' shared memory) to every block's wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A measurement build (nvcc -DTRIS_EVAL_STAMPS; never the extension) has thread 0 of each
// block write the clock64 cycles of its phases into eval_stamps[block * kEvalStamps + k]: 1
// the t-rows formed, 2 pass 1 and the block's max, 3 the max exchange (the cluster's
// barrier), 4 the cuts, 5 pass 2 and the block's reductions, 6 the partials' barrier; 0 and 7
// %globaltimer at entry and exit, 8 the SM. Without the flag the macros are nothing.
constexpr int kEvalStamps = 9;
#ifdef TRIS_EVAL_STAMPS
__device__ unsigned long long* eval_stamps;
__device__ __forceinline__ unsigned long long eval_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define EVAL_SLOT(k)                                                                         \
  eval_stamps[((unsigned long long)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +       \
               blockIdx.x) * kEvalStamps + (k)]
#define EVAL_STAMP_ENTRY()                            \
  long long eval_clock_ = clock64();                  \
  if (threadIdx.x == 0) EVAL_SLOT(0) = eval_globaltimer();
#define EVAL_PHASE(k)                                               \
  if (threadIdx.x == 0) {                                           \
    const long long t_ = clock64();                                 \
    EVAL_SLOT(k) = (unsigned long long)(t_ - eval_clock_);          \
    eval_clock_ = t_;                                               \
  }
#define EVAL_STAMP_EXIT()                                  \
  if (threadIdx.x == 0) {                                  \
    unsigned sm;                                           \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));        \
    EVAL_SLOT(7) = eval_globaltimer();                     \
    EVAL_SLOT(8) = sm;                                     \
  }
#else
#define EVAL_STAMP_ENTRY()
#define EVAL_PHASE(k)
#define EVAL_STAMP_EXIT()
#endif

// One rank's pass-2 result, pushed into rank 0.
struct Partial {
  float best;
  int idx, inter, uni;
};

// A thread's output column: its x taps, held in registers for every row of the band.
struct Column {
  int lo, hi;
  float a, b;
};

// The band's row i (output row y) at the thread's column, each product and sum rounded alone:
// staged from the band's t-row, else from the map as tris::sample2.
template <bool kStaged>
__device__ __forceinline__ float sample(const Column& c, const float* tband, const float* plane,
                                        int w, int i, int y, const int* yl, const int* yh,
                                        const float* ya, const float* yb) {
  if constexpr (kStaged) {
    const float* t = tband + (long long)i * w;
    return __fadd_rn(__fmul_rn(c.a, t[c.lo]), __fmul_rn(c.b, t[c.hi]));
  } else {
    return tris::sample2(plane, w, yl[y], yh[y], ya[y], yb[y], c.lo, c.hi, c.a, c.b);
  }
}

// Ordered keys of the non-NaN floats: a < b exactly where key(a) < key(b) (+0 and -0 share 0).
__device__ __forceinline__ long long key_of(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? (long long)b : -(long long)(b & 0x7fffffff);
}
__device__ __forceinline__ float float_of(long long k) {
  return k >= 0 ? __int_as_float((int)k) : __int_as_float((int)((unsigned)(-k) | 0x80000000u));
}

// By one warp: the least float u (as a key in (lo, hi]) with RN(u / d) > thr (kStrict) or
// >= thr, where that holds at hi and not at lo; RN(u / d) does not decrease in u for d > 0,
// so a search over keys finds it, 32 candidates a step.
template <bool kStrict>
__device__ float least_quotient(long long lo, long long hi, float d, float thr, int lane) {
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long k = min(lo + step * (lane + 1), hi);
    const float v = __fdiv_rn(float_of(k), d);
    const unsigned ball = __ballot_sync(0xffffffffu, kStrict ? v > thr : v >= thr);
    const int f = __ffs(ball) - 1;  // lane 31's candidate is hi, where it holds
    const long long nhi = min(lo + step * (f + 1), hi);
    lo = f == 0 ? lo : lo + step * f;
    hi = nhi;
  }
  return float_of(hi);
}

// The same search in one step where the cut lies among the 32 keys from `guess` - 15: each
// lane tests one, and where the condition fails at the first and holds at the last, the first
// lane where it holds is the cut; else the search over all of (lo, hi].
template <bool kStrict>
__device__ float least_quotient_near(float guess, long long lo, long long hi, float d, float thr,
                                     int lane) {
  const long long w0 = max(min(key_of(guess) - 15, hi - 31), lo);
  const long long k = min(w0 + lane, hi);
  const float v = __fdiv_rn(float_of(k), d);
  const unsigned ball = __ballot_sync(0xffffffffu, kStrict ? v > thr : v >= thr);
  if (!(ball & 1u) && (ball >> 31)) return float_of(w0 + __ffs(ball) - 1);
  return least_quotient<kStrict>(lo, hi, d, thr, lane);
}

// kVecMap: w % 4 == 0 and the map 16-byte aligned (the t-rows formed from float4 loads);
// kStaged: the plan's. Grid (R, S, B) in clusters of R along x.
template <bool kVecMap, bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
eval_metrics_kernel(const float* __restrict__ cams, int S, int h, int w, int maxH, int maxW,
                    const int* __restrict__ ylo, const int* __restrict__ yhi,
                    const float* __restrict__ wy0, const float* __restrict__ wy1,
                    const int* __restrict__ xlo, const int* __restrict__ xhi,
                    const float* __restrict__ wx0, const float* __restrict__ wx1,
                    const int* __restrict__ orig_hw, const unsigned char* __restrict__ targets,
                    const float* __restrict__ boxes, float* __restrict__ norm_out,
                    float* __restrict__ stats, int band_cap) {
  // [band_cap][w] the band's t-rows, then its rows' y taps [4][band_cap]
  extern __shared__ __align__(16) float tband[];
  __shared__ float red[32];
  __shared__ int red_idx[32], red_i[32], red_u[32];
  __shared__ float maxes[tris::kEvalWideRanks];
  __shared__ Partial parts[tris::kEvalWideRanks];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster_arrive_relaxed();  // this block has started: the others may write its maxes
  EVAL_STAMP_ENTRY();
  const int s = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int oh = orig_hw[2 * b], ow = orig_hw[2 * b + 1];
  const int y_begin = (int)((long long)rank * oh / R);
  const int n = (int)((long long)(rank + 1) * oh / R) - y_begin;
  const float* plane = cams + ((long long)b * S + s) * h * w;
  const int* yl = ylo + (long long)b * maxH;
  const int* yh = yhi + (long long)b * maxH;
  const float* ya = wy0 + (long long)b * maxH;
  const float* yb = wy1 + (long long)b * maxH;
  const int* xl = xlo + (long long)b * maxW;
  const int* xh = xhi + (long long)b * maxW;
  const float* xa = wx0 + (long long)b * maxW;
  const float* xb = wx1 + (long long)b * maxW;

  if constexpr (kStaged) {
    // the band's rows' y taps first, then its t-rows from float4 loads (kVecMap) or floats,
    // every load of the map independent of the others
    int* sy0 = reinterpret_cast<int*>(tband + (long long)band_cap * w);
    int* sy1 = sy0 + band_cap;
    float* sa = reinterpret_cast<float*>(sy1 + band_cap);
    float* sb = sa + band_cap;
    for (int i = tid; i < n; i += kThreads) {
      sy0[i] = yl[y_begin + i];
      sy1[i] = yh[y_begin + i];
      sa[i] = ya[y_begin + i];
      sb[i] = yb[y_begin + i];
    }
    __syncthreads();
    const int per_row = kVecMap ? w / 4 : w;
    const unsigned t_items = (unsigned)n * (unsigned)per_row;
#pragma unroll 8
    for (unsigned k = tid; k < t_items; k += kThreads) {
      const int i = (int)(k / per_row), j = (int)(k - (unsigned)i * per_row);
      const float a = sa[i], c = sb[i];
      const float* r0 = plane + (long long)sy0[i] * w;
      const float* r1 = plane + (long long)sy1[i] * w;
      float* t = tband + (long long)i * w;
      if constexpr (kVecMap) {
        const float4 p = reinterpret_cast<const float4*>(r0)[j];
        const float4 q = reinterpret_cast<const float4*>(r1)[j];
        reinterpret_cast<float4*>(t)[j] =
            make_float4(__fadd_rn(__fmul_rn(a, p.x), __fmul_rn(c, q.x)),
                        __fadd_rn(__fmul_rn(a, p.y), __fmul_rn(c, q.y)),
                        __fadd_rn(__fmul_rn(a, p.z), __fmul_rn(c, q.z)),
                        __fadd_rn(__fmul_rn(a, p.w), __fmul_rn(c, q.w)));
      } else {
        t[j] = __fadd_rn(__fmul_rn(a, r0[j]), __fmul_rn(c, r1[j]));
      }
    }
    __syncthreads();
  }
  EVAL_PHASE(1);

  // Thread tid owns column c0 + tid % cols of each pass over the columns (c0 = 0, cols, ...),
  // and the band rows tid / cols, + rpar, ...: consecutive lanes on consecutive columns.
  const int cols = ow < kThreads ? ow : kThreads;
  const int rpar = cols > 0 ? kThreads / cols : 1;
  const int col = cols > 0 ? tid % cols : 0, rofs = cols > 0 ? tid / cols : 0;
  const bool active = rofs < rpar;
  auto column = [&](int x) {
    return Column{xl[x], xh[x], xa[x], xb[x]};
  };

  // pass 1: the band's max
  float mx = -INFINITY;
  for (int c0 = 0; c0 < ow; c0 += cols) {
    const int x = c0 + col;
    if (!active || x >= ow) continue;
    const Column c = column(x);
#pragma unroll 4
    for (int i = rofs; i < n; i += rpar)
      mx = fmaxf(mx, sample<kStaged>(c, tband, plane, w, i, y_begin + i, yl, yh, ya, yb));
  }
  mx = tris::block_max(mx, red);
  EVAL_PHASE(2);
  cluster_wait();  // every rank has started
  if (tid < R) cluster.map_shared_rank(maxes, tid)[rank] = mx;
  cluster_arrive();  // every rank now holds the R maxes
  cluster_wait();
  EVAL_PHASE(3);
  float m = maxes[0];
  for (int q = 1; q < R; ++q) m = fmaxf(m, maxes[q]);
  const float denom = m + 1e-5f;

  if (norm_out) {
    // the band's rows over all maxW columns, 4 a thread (one 16-byte store where maxW % 4 ==
    // 0): normalised inside ow, zero past it; then this rank's share of the zero rows past oh
    float* o = norm_out + ((long long)b * S + s) * maxH * maxW;
    const int quads = (maxW + 3) / 4;
    const int qcols = quads < kThreads ? quads : kThreads;
    const int qpar = kThreads / qcols, qcol = tid % qcols, qofs = tid / qcols;
    for (int q0 = 0; q0 < quads; q0 += qcols) {
      const int x = 4 * (q0 + qcol);
      if (qofs >= qpar || x >= maxW) continue;
      Column c4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) c4[k] = x + k < ow ? column(x + k) : Column{0, 0, 0.f, 0.f};
#pragma unroll 2
      for (int i = qofs; i < n; i += qpar) {
        const int y = y_begin + i;
        float r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          r[k] = x + k < ow
                     ? __fdiv_rn(sample<kStaged>(c4[k], tband, plane, w, i, y, yl, yh, ya, yb),
                                 denom)
                     : 0.f;
        float* dst = o + (long long)y * maxW + x;
        if (maxW % 4 == 0) {
          *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
        } else {
          for (int k = 0; k < 4 && x + k < maxW; ++k) dst[k] = r[k];
        }
      }
    }
    const int z_begin = oh + (int)((long long)rank * (maxH - oh) / R);
    const int z_end = oh + (int)((long long)(rank + 1) * (maxH - oh) / R);
    const long long z0 = (long long)z_begin * maxW, z1 = (long long)z_end * maxW;
    if (maxW % 4 == 0) {
      for (long long e = z0 + 4LL * tid; e < z1; e += 4LL * kThreads)
        *reinterpret_cast<float4*>(o + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (long long e = z0 + tid; e < z1; e += kThreads) o[e] = 0.f;
    }
    EVAL_PHASE(5);
    EVAL_STAMP_EXIT();
    return;  // no rank reads another's shared memory after the barrier above
  }

  // pass 2: normalise, threshold, count and keep the first peak. With d = max + 1e-5 > 0,
  // v = RN(u / d) does not decrease in u, so v > 1e-9 exactly where u >= u_p, the least u with
  // RN(u / d) > 1e-9, and v equals the peak RN(max / d) exactly where u >= u_lo, the least u
  // with RN(u / d) >= RN(max / d): two warps find both by search, and the samples are then
  // compared, not divided. Otherwise (every sample below -1e-5) each is divided.
  const unsigned char* tg = targets + (long long)b * maxH * maxW;
  int inter = 0, uni = 0, best_i = INT_MAX;
  float best = -INFINITY;
  const bool compare = denom > 0.f;
  if (compare) {
    // every warp finds both cuts itself: no barrier
    const float peak = __fdiv_rn(m, denom);
    const float u_p = least_quotient_near<true>(__fmul_rn(1e-9f, denom), key_of(-INFINITY),
                                                key_of(INFINITY), denom, 1e-9f, lane);
    const float u_lo =
        least_quotient_near<false>(m, key_of(-INFINITY), key_of(m), denom, peak, lane);
    EVAL_PHASE(4);
    for (int c0 = 0; c0 < ow; c0 += cols) {
      const int x = c0 + col;
      if (!active || x >= ow) continue;
      const Column c = column(x);
      // kMaskBatch rows at a time: their gt bytes are all loaded before any is used
      for (int i0 = rofs; i0 < n; i0 += kMaskBatch * rpar) {
        unsigned char g[kMaskBatch];
#pragma unroll
        for (int k = 0; k < kMaskBatch; ++k) {
          const int i = i0 + k * rpar;
          g[k] = i < n ? tg[(y_begin + i) * maxW + x] : 0;
        }
#pragma unroll
        for (int k = 0; k < kMaskBatch; ++k) {
          const int i = i0 + k * rpar;
          if (i >= n) break;
          const int y = y_begin + i;
          const float u = sample<kStaged>(c, tband, plane, w, i, y, yl, yh, ya, yb);
          const int flat = y * maxW + x;
          const bool pred = u >= u_p, gt = g[k] != 0;
          inter += pred && gt;
          uni += pred || gt;
          if (u >= u_lo && flat < best_i) best_i = flat;
        }
      }
    }
    if (best_i != INT_MAX) best = peak;
  } else {
    for (int c0 = 0; c0 < ow; c0 += cols) {
      const int x = c0 + col;
      if (!active || x >= ow) continue;
      const Column c = column(x);
#pragma unroll 4
      for (int i = rofs; i < n; i += rpar) {
        const int y = y_begin + i;
        const float v =
            __fdiv_rn(sample<kStaged>(c, tband, plane, w, i, y, yl, yh, ya, yb), denom);
        const int flat = y * maxW + x;
        const bool pred = v > 1e-9f, g = tg[flat] != 0;
        inter += pred && g;
        uni += pred || g;
        if (v > best || (v == best && flat < best_i)) {
          best = v;
          best_i = flat;
        }
      }
    }
  }
  // block argmax, ties to the lowest flat index, plus the two counts
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  inter = tris::warp_sum_int(inter);
  uni = tris::warp_sum_int(uni);
  __syncthreads();  // every thread has read red (block_max) before it is reused
  if (lane == 0) {
    red[warp] = best;
    red_idx[warp] = best_i;
    red_i[warp] = inter;
    red_u[warp] = uni;
  }
  __syncthreads();
  EVAL_PHASE(5);
  if (warp == 0) {
    best = lane < kWarps ? red[lane] : -INFINITY;
    best_i = lane < kWarps ? red_idx[lane] : INT_MAX;
    inter = lane < kWarps ? red_i[lane] : 0;
    uni = lane < kWarps ? red_u[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    inter = tris::warp_sum_int(inter);
    uni = tris::warp_sum_int(uni);
    if (lane == 0) cluster.map_shared_rank(parts, 0)[rank] = {best, best_i, inter, uni};
  }
  cluster_arrive();  // rank 0 now holds the R partials
  cluster_wait();
  EVAL_PHASE(6);
  EVAL_STAMP_EXIT();
  if (rank != 0 || tid != 0) return;
  // rank order: integer sums, and the argmax with ties to the lowest flat index
  Partial p = parts[0];
  for (int q = 1; q < R; ++q) {
    const Partial r = parts[q];
    p.inter += r.inter;
    p.uni += r.uni;
    if (r.best > p.best || (r.best == p.best && r.idx < p.idx)) {
      p.best = r.best;
      p.idx = r.idx;
    }
  }
  const int at = p.idx == INT_MAX ? 0 : p.idx;  // no valid pixel: the plain argmax's 0
  const float py = (float)(at / maxW), px = (float)(at % maxW);
  const float* bx = boxes + 4 * b;
  const bool hit = bx[0] <= px && px <= bx[2] && bx[1] <= py && py <= bx[3];
  float* st = stats + 4 * ((long long)b * S + s);
  st[0] = (float)p.inter;
  st[1] = (float)p.uni;
  st[2] = hit ? 1.f : 0.f;
  st[3] = (float)tg[at];
}

using Kernel = decltype(&eval_metrics_kernel<true, true>);

Kernel pick(bool vec_map, bool staged) {
  if (!staged) return &eval_metrics_kernel<false, false>;
  return vec_map ? &eval_metrics_kernel<true, true> : &eval_metrics_kernel<false, true>;
}

// Opt `kernel` in to `smem` bytes and, past 8 blocks, to non-portable clusters.
cudaError_t allow(Kernel kernel, int cluster, long long smem) {
  cudaError_t err = tris::allow_smem(kernel, (size_t)smem);
  if (err == cudaSuccess && cluster > tris::kEvalMaxRanks)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t config(dim3 grid, int cluster, long long smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether the card runs a cluster of `plan`'s blocks at all (cudaOccupancyMaxActiveClusters).
bool fits(const tris::EvalMetricsPlan& plan) {
  const Kernel kernel = pick(true, plan.staged != 0);
  int n = 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(dim3(plan.ranks), plan.ranks, plan.smem, nullptr, attr);
  if (allow(kernel, plan.ranks, plan.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return n > 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

}  // namespace

#ifdef TRIS_EVAL_STAMPS
// The measurement build's stamp buffer, and how many clusters of a plan's blocks the card holds
// at once (tools/eval_metrics_phases.py).
extern "C" cudaError_t eval_set_stamps(unsigned long long* stamps) {
  return cudaMemcpyToSymbol(eval_stamps, &stamps, sizeof(stamps));
}
extern "C" int eval_resident_clusters(int ranks, int staged, long long smem) {
  const Kernel kernel = pick(true, staged != 0);
  int n = 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(dim3(ranks), ranks, smem, nullptr, attr);
  if (allow(kernel, ranks, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}
#endif

tris::EvalMetricsPlan tris::eval_metrics_device_plan(int B, int S, int maxH, int maxW, int h,
                                                     int w) {
  EvalMetricsPlan p = eval_metrics_plan(B, S, maxH, maxW, h, w, kEvalWideRanks);
  if (p.ranks > kEvalMaxRanks && !fits(p))
    p = eval_metrics_plan(B, S, maxH, maxW, h, w, kEvalMaxRanks);
  return p;
}

cudaError_t tris::eval_metrics(const float* cams, int B, int S, int h, int w, int maxH, int maxW,
                               const int* ylo, const int* yhi, const float* wy0,
                               const float* wy1, const int* xlo, const int* xhi,
                               const float* wx0, const float* wx1, const int* orig_hw,
                               const unsigned char* targets, const float* boxes,
                               float* norm_out, float* stats, cudaStream_t stream,
                               EvalMetricsLaunchShape* shape) {
  if (B == 0 || S == 0) return cudaSuccess;
  const EvalMetricsPlan plan = eval_metrics_device_plan(B, S, maxH, maxW, h, w);
  const bool vec_map = w % 4 == 0 && aligned16(cams);
  const Kernel kernel = pick(vec_map, plan.staged != 0);
  cudaError_t err = allow(kernel, plan.ranks, plan.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(dim3(plan.ranks, S, B), plan.ranks, plan.smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, cams, S, h, w, maxH, maxW, ylo, yhi, wy0, wy1, xlo, xhi,
                           wx0, wx1, orig_hw, targets, boxes, norm_out, stats, plan.band_rows);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {plan.blocks, plan.ranks, kThreads, plan.smem, plan.staged, vec_map ? 16 : 4};
  return err;
}
