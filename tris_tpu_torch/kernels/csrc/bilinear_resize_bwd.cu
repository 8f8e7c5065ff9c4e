// K6, bilinear half, backward: the adjoint of the resize, d x = Ry^T . g . Rx.
//
// The gradient of tris_tpu/ops/resize.py::bilinear_resize (line 57), which
// the JAX package takes by autodiff of its two HIGHEST-precision matrix
// products; the forward here is bilinear_resize.cu, which samples the
// matrices' two taps per output index (ops/resize.py::interp_taps). With
// those taps, for an input element (Y, X):
//   R[oy, X]  = sum_{ox: lo(ox) = X} wx0[ox] g[oy, ox] + sum_{ox: hi(ox) = X} wx1[ox] g[oy, ox]
//   dx[Y, X]  = sum_{oy: lo(oy) = Y} wy0[oy] R[oy, X] + sum_{oy: hi(oy) = Y} wy1[oy] R[oy, X]
// The taps are monotone, so each sum runs over one contiguous range of
// output indices, built once on the host (kernels/response_head.py::
// adjoint_taps_on). A gather with no atomics: each sum is a chain of fmaf in
// a fixed order (the lo range, then the hi range), so the gradient is the
// same run to run (the plain version's index backward scatters, with atomics
// on CUDA).
//
// Shapes on the IRN training step (crop 512, B = 24): the heads' upsamples,
// g [24, 32, 128, 128] -> [24, 32, 64, 64] (x2) and [24, 32, 32, 32] (x4) for
// the edge taps, [24, 256, 64, 64] -> [24, 256, 32, 32] (x2) for dp4 and
// dp5, and [24, 256, 128, 128] -> [24, 256, 64, 64] (x2) for dp6; on the
// stage-2 step, the decoder's x2 taps [48, 64..256, 10..40^2] and the heads'
// [48, 1, 20..80^2] <- 320^2. One launch each.
//
// Bound: bytes - g read once and dx written once; 2 flops per term, 4 terms
// an element of g. A thread an input element (the first design, kept as the
// direct path below) re-reads each g element from L1 or L2 for every input
// row whose range holds it, 4 times at x2 and 16 at x4, with the column taps
// again for each output row, and at the heads' x16 it leaves 75 blocks of
// serial 1024-term chains on 132 SMs. Design (launchers.h,
// bilinear_resize_bwd_plan): a block takes a band of consecutive input rows
// of the flattened planes; the g rows their ranges cover are one contiguous
// run, which it copies into shared memory (cp.async, all copies in flight)
// with the column taps and ranges. Then R for every staged row and input
// column, once each, and dx for the band from R, each chain the first
// design's: the same terms in the same order, so dx is the same bit for bit.
// At up to x2 (ow <= 2 w: IRNet's dp and e3 taps, the decoder's), R's lanes
// are on columns, a thread holding its column's few taps in registers for
// every row it takes (128 threads a block, many blocks an SM: the pass is
// bound by the instructions it issues, so the taps stay out of its inner
// loop); the rows are copied 16 bytes a copy. Beyond
// (the heads' x4 to x16, the edge taps' x4), a column's taps are many and
// lanes on columns would read g 4 to 16 ways into one bank, so R's lanes
// are on rows, whose odd pitch (copied 4 bytes a copy) puts them in distinct
// banks, and bands of several rows (two blocks an SM) read each g row fewer
// times.

#include <limits.h>

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = tris::kResizeBwdThreads;

// The flattened row f as (plane, row): one 32-bit division where f fits.
__device__ __forceinline__ void plane_row(long long f, int n, long long& plane, int& row) {
  if (f <= INT_MAX) {
    const unsigned q = (unsigned)f / (unsigned)n;
    plane = q;
    row = (int)((unsigned)f - q * (unsigned)n);
  } else {
    plane = f / n;
    row = (int)(f - plane * n);
  }
}

// Grid (bands); kVec columns a thread in dx; kColLanes: R's lanes on columns; kCopy16: g
// staged 16 bytes a copy (g_pitch and ow multiples of 4, g 16-byte aligned).
template <int kVec, bool kColLanes, bool kCopy16>
__global__ void __launch_bounds__(kColLanes ? tris::kResizeBwdColThreads : kThreads)
bilinear_resize_bwd_kernel(const float* __restrict__ g, float* __restrict__ dx, long long total,
                           int h, int w, int oh, int ow, int band, int span_rows, int g_pitch,
                           int r_pitch, tris::TapArrays ty, tris::TapArrays tx,
                           tris::TapRanges ry, tris::TapRanges rx) {
  constexpr int kT = kColLanes ? tris::kResizeBwdColThreads : kThreads;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                                                  // [span_rows][r_pitch]
  float* gs = rs + (long long)span_rows * r_pitch;                   // [span_rows][g_pitch]
  float* xw0 = gs + tris::resize_bwd_round4((long long)span_rows * g_pitch);  // [ow]
  float* xw1 = xw0 + tris::resize_bwd_round4(ow);                    // [ow]
  float* yw0 = xw1 + tris::resize_bwd_round4(ow);                    // [span_rows]
  float* yw1 = yw0 + tris::resize_bwd_round4(span_rows);             // [span_rows]
  int* xr = reinterpret_cast<int*>(yw1 + tris::resize_bwd_round4(span_rows));  // [4][w]
  const int tid = threadIdx.x;

  // the band's input rows [f0, f1) and the g rows [g0, g0 + S) their ranges cover: from the
  // first row's hi range (hi_begin <= lo_begin) to the last row's lo range (lo_end >= hi_end)
  const long long f0 = (long long)blockIdx.x * band;
  const long long f1 = min(f0 + band, total);
  long long p0, p1;
  int y0, y1;
  plane_row(f0, h, p0, y0);
  plane_row(f1 - 1, h, p1, y1);
  const long long g0 = p0 * oh + ry.hi_begin[y0];
  const int S = (int)(p1 * oh + ry.lo_end[y1] - g0);  // <= span_rows (the plan's bound)

  // stage g's rows, every copy in flight at once (kCopy16: 16 bytes a copy): copy k of the run
  // is row k / cols, column k % cols, walked without a division
  {
    const float* src = g + g0 * ow;
    constexpr int q = kCopy16 ? 4 : 1;
    const int cols = ow / q, n = S * cols, step_r = kT / cols, step_c = kT - step_r * cols;
    int r = tid / cols, c = tid - r * cols;
    for (int k = tid; k < n; k += kT) {
      if constexpr (kCopy16)
        tris::cp_async16(gs + r * g_pitch + 4 * c, src + 4LL * k, true);
      else
        tris::cp_async4(gs + r * g_pitch + c, src + k, true);
      r += step_r;
      c += step_c;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
    tris::cp_async_commit();
  }
  // the column taps and ranges, and the weights of the staged rows (row s is output row
  // (g0 + s) % oh), while the copies fly
  for (int i = tid; i < ow; i += kT) {
    xw0[i] = tx.w0[i];
    xw1[i] = tx.w1[i];
  }
  for (int i = tid; i < w; i += kT) {
    xr[i] = rx.lo_begin[i];
    xr[w + i] = rx.lo_end[i];
    xr[2 * w + i] = rx.hi_begin[i];
    xr[3 * w + i] = rx.hi_end[i];
  }
  for (int s = tid; s < S; s += kT) {
    const int oy = (int)((g0 + s) % oh);
    yw0[s] = ty.w0[oy];
    yw1[s] = ty.w1[oy];
  }
  tris::cp_async_wait<0>();
  __syncthreads();

  // R[s, X] for every staged row and input column
  if (kColLanes && S > 0) {
    // a thread a column X and every rpar-th row from s0, the column's taps in registers (a
    // range longer than kTaps, which no scale up to 2 gives, reads them from shared memory)
    constexpr int kTaps = tris::kResizeBwdTaps;
    const int xt = w < kT ? w : kT, rpar = kT / xt, s0 = tid / xt;
    for (int X = tid - s0 * xt; s0 < rpar && X < w; X += xt) {
      const int lb = xr[X], nl = xr[w + X] - lb, hb = xr[2 * w + X], nh = xr[3 * w + X] - hb;
      float a[kTaps], c[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        a[k] = k < nl ? xw0[lb + k] : 0.f;
        c[k] = k < nh ? xw1[hb + k] : 0.f;
      }
      const bool fits = nl <= kTaps && nh <= kTaps;
      for (int s = s0; s < S; s += rpar) {
        const float* r = gs + s * g_pitch;
        float acc = 0.f;
        if (fits) {
#pragma unroll
          for (int k = 0; k < kTaps; ++k)
            if (k < nl) acc = fmaf(a[k], r[lb + k], acc);
#pragma unroll
          for (int k = 0; k < kTaps; ++k)
            if (k < nh) acc = fmaf(c[k], r[hb + k], acc);
        } else {
          for (int ox = lb; ox < lb + nl; ++ox) acc = fmaf(xw0[ox], r[ox], acc);
          for (int ox = hb; ox < hb + nh; ++ox) acc = fmaf(xw1[ox], r[ox], acc);
        }
        rs[s * r_pitch + X] = acc;
      }
    }
  } else if (S > 0) {
    // element e is row e % S, column e / S: lanes on consecutive rows
    const int n = S * w, step_x = kT / S, step_s = kT - step_x * S;
    int X = tid / S, s = tid - X * S;
    for (int e = tid; e < n; e += kT) {
      const float* r = gs + s * g_pitch;
      const int lb = xr[X], le = xr[w + X], hb = xr[2 * w + X], he = xr[3 * w + X];
      float acc = 0.f;
#pragma unroll 4
      for (int ox = lb; ox < le; ++ox) acc = fmaf(xw0[ox], r[ox], acc);
#pragma unroll 4
      for (int ox = hb; ox < he; ++ox) acc = fmaf(xw1[ox], r[ox], acc);
      rs[s * r_pitch + X] = acc;
      s += step_s;
      X += step_x;
      if (s >= S) {
        s -= S;
        ++X;
      }
    }
  }
  __syncthreads();

  // dx for the band's rows, kVec columns a thread: element e is row e / groups, column group
  // e % groups
  const int groups = w / kVec, rows = (int)(f1 - f0), n = rows * groups;
  const int step_i = kT / groups, step_q = kT - step_i * groups;
  int i = tid / groups, q = tid - i * groups;
  for (int e = tid; e < n; e += kT) {
    long long plane;
    int Y;
    plane_row(f0 + i, h, plane, Y);
    const long long base = plane * oh - g0;  // staged row of output row oy: base + oy
    const int X = q * kVec;
    float acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
    auto terms = [&](int oy_begin, int oy_end, const float* wy) {
      for (int oy = oy_begin; oy < oy_end; ++oy) {
        const int s = (int)(base + oy);
        const float wt = wy[s];
        const float* r = rs + s * r_pitch + X;
        if constexpr (kVec == 4) {
          const float4 v = *reinterpret_cast<const float4*>(r);
          acc[0] = fmaf(wt, v.x, acc[0]);
          acc[1] = fmaf(wt, v.y, acc[1]);
          acc[2] = fmaf(wt, v.z, acc[2]);
          acc[3] = fmaf(wt, v.w, acc[3]);
        } else {
          acc[0] = fmaf(wt, r[0], acc[0]);
        }
      }
    };
    terms(ry.lo_begin[Y], ry.lo_end[Y], yw0);
    terms(ry.hi_begin[Y], ry.hi_end[Y], yw1);
    float* o = dx + (f0 + i) * w + X;
    if constexpr (kVec == 4)
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    else
      o[0] = acc[0];
    q += step_q;
    i += step_i;
    if (q >= groups) {
      q -= groups;
      ++i;
    }
  }
}

// The direct path (staged 0: a band's span past shared memory): a thread an input element,
// g read from device memory; the same chains in the same order.
__global__ void __launch_bounds__(kThreads)
bilinear_resize_bwd_direct_kernel(const float* __restrict__ g, float* __restrict__ dx,
                                  long long n_in, int h, int w, int oh, int ow,
                                  tris::TapArrays ty, tris::TapArrays tx, tris::TapRanges ry,
                                  tris::TapRanges rx) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n_in) return;
  const int X = (int)(i % w);
  const long long t = i / w;
  const int Y = (int)(t % h);
  const float* gp = g + (t / h) * oh * (long long)ow;
  const int xlb = rx.lo_begin[X], xle = rx.lo_end[X], xhb = rx.hi_begin[X], xhe = rx.hi_end[X];
  // R[oy, X] for one output row
  auto row = [&](int oy) {
    const float* r = gp + (long long)oy * ow;
    float acc = 0.f;
    for (int ox = xlb; ox < xle; ++ox) acc = fmaf(tx.w0[ox], r[ox], acc);
    for (int ox = xhb; ox < xhe; ++ox) acc = fmaf(tx.w1[ox], r[ox], acc);
    return acc;
  };
  float acc = 0.f;
  for (int oy = ry.lo_begin[Y]; oy < ry.lo_end[Y]; ++oy) acc = fmaf(ty.w0[oy], row(oy), acc);
  for (int oy = ry.hi_begin[Y]; oy < ry.hi_end[Y]; ++oy) acc = fmaf(ty.w1[oy], row(oy), acc);
  dx[i] = acc;
}

template <int kVec, bool kColLanes, bool kCopy16>
cudaError_t launch(const tris::ResizeBwdPlan& p, const float* g, float* dx, long long total,
                   int h, int w, int oh, int ow, tris::TapArrays ty, tris::TapArrays tx,
                   tris::TapRanges ry, tris::TapRanges rx, cudaStream_t stream) {
  const auto kernel = bilinear_resize_bwd_kernel<kVec, kColLanes, kCopy16>;
  const cudaError_t err = tris::allow_smem(kernel, (size_t)p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)p.blocks, p.threads, p.smem, stream>>>(
      g, dx, total, h, w, oh, ow, p.band, p.span_rows, p.g_pitch, p.r_pitch, ty, tx, ry, rx);
  return cudaGetLastError();
}

}  // namespace

cudaError_t tris::bilinear_resize_bwd(const float* g, float* dx, int64_t planes, int h, int w,
                                      int oh, int ow, TapArrays ty, TapArrays tx, TapRanges ry,
                                      TapRanges rx, cudaStream_t stream,
                                      ResizeBwdLaunchShape* shape) {
  const long long total = planes * h;
  if (total == 0 || w == 0) return cudaSuccess;
  const ResizeBwdPlan p = bilinear_resize_bwd_plan(planes, h, w, oh, ow);
  cudaError_t err;
  if (!p.staged) {
    bilinear_resize_bwd_direct_kernel<<<(unsigned)p.blocks, kThreads, 0, stream>>>(
        g, dx, total * w, h, w, oh, ow, ty, tx, ry, rx);
    err = cudaGetLastError();
  } else {
    // 16-byte copies where the pitch and the rows allow them and g is 16-byte aligned
    const bool c16 = p.g_pitch % 4 == 0 && ow % 4 == 0 &&
                     (reinterpret_cast<unsigned long long>(g) & 15) == 0;
    const bool v4 = p.vec == 4;
    const auto run = !p.col_lanes ? (v4 ? &launch<4, false, false> : &launch<1, false, false>)
                     : c16        ? (v4 ? &launch<4, true, true> : &launch<1, true, true>)
                                  : (v4 ? &launch<4, true, false> : &launch<1, true, false>);
    err = run(p, g, dx, total, h, w, oh, ow, ty, tx, ry, rx, stream);
  }
  if (err == cudaSuccess && shape != nullptr)
    *shape = {p.blocks, p.threads, p.band, p.span_rows, p.vec, p.staged, p.smem};
  return err;
}
