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
//   R[p, y, X]      = sum_{x: lo(x) = X} wx0[x] d cam_n[p, y, x] + sum_{x: hi(x) = X} wx1[x] ...
//   d cams[p, Y, X] = sum_{y: lo(y) = Y} wy0[y] R[p, y, X] + sum_{y: hi(y) = Y} wy1[y] ...
// The taps are monotone, so each sum runs over a contiguous range of output
// indices, computed once on the host (kernels/response_head.py::
// adjoint_taps_on). A gather, with no atomics: each sum is a chain of fmaf in
// a fixed order (the channels; the lo range, then the hi range), so the
// gradient is the same run to run (the plain version's index backward
// scatters with atomics and can differ by ulps from run to run).
//
// Shapes on the stage-1 train path: P = 48 maps, S = 1, 320 -> 224, ps = 32
// (g = 7): dA [2352, 3072]; one launch per step.
//
// Bound: bytes - dA (28.9 MB) and the image (58.9 MB) read once, d cams
// (19.7 MB) written once: 0.032 ms at 3.35 TB/s. The first design took two
// launches, d cam_n's rows and their column adjoint R into a scratch
// [P, n, W] (13.8 MB written, then read back: 27.6 MB the bound does not
// need), then the row adjoint, with a quarter of its lanes idle at W = 320.
// Design (launchers.h, critic_input_bwd_plan): a block takes a band of 8
// source rows of one map; the output rows whose adjoint ranges cover the band
// are one contiguous run (at most 10), sampling at most 10 image rows. The
// block copies those image rows and the taps into shared memory with every
// copy in flight (cp.async) while each thread loads its column's dA values
// for the run into registers (a warp's 32 columns one 128-byte line a
// channel); then, a thread a column in each pass, it forms d cam_n's rows,
// their column adjoint R (in the image rows' space) and d cams for its band
// from R, every chain unrolled over its few taps. R never reaches device
// memory, and every chain is the first design's, so d cams is the same bit
// for bit. What holds it (clock64 stamps of each phase at three blocks an
// SM): the bands' halos (10 image rows and ~7 dA rows a band of 8, the taps a
// block) take ~147 MB through L2 where the bound counts 107.5 MB, and each
// block's copies and its three passes follow one another, overlapping only
// with the other blocks on its SM.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = tris::kCriticBwdMaxThreads;
constexpr int kTaps = 4;  // a range's terms a pass unrolls (no scale below 4 gives more)

// A measurement build (nvcc -DTRIS_K5_STAMPS; never the extension) has thread 0 of each block
// write the clock64 cycles of its phases into k5_stamps[block * kK5Stamps + k], k = 1..4 (the
// copies and dA's loads with their wait, d cam_n, R, d cams), 0 and 5 %globaltimer at entry
// and exit, 6 the SM. Without the flag the macros are nothing.
constexpr int kK5Stamps = 7;
#ifdef TRIS_K5_STAMPS
__device__ unsigned long long* k5_stamps;
__device__ __forceinline__ unsigned long long k5_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K5_SLOT(k) k5_stamps[(unsigned long long)blockIdx.x * kK5Stamps + (k)]
#define K5_STAMP_ENTRY()           \
  long long k5_clock_ = clock64(); \
  if (threadIdx.x == 0) K5_SLOT(0) = k5_globaltimer();
#define K5_PHASE(k)                                    \
  if (threadIdx.x == 0) {                              \
    const long long t_ = clock64();                    \
    K5_SLOT(k) = (unsigned long long)(t_ - k5_clock_); \
    k5_clock_ = t_;                                    \
  }
#define K5_STAMP_EXIT()                             \
  if (threadIdx.x == 0) {                           \
    unsigned sm;                                    \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm)); \
    K5_SLOT(5) = k5_globaltimer();                  \
    K5_SLOT(6) = sm;                                \
  }
#else
#define K5_STAMP_ENTRY()
#define K5_PHASE(k)
#define K5_STAMP_EXIT()
#endif

// the fmaf chain of w[k] * v(k) over k in [lb, lb + nl), then of w[off + k] * v(k) over
// [hb, hb + nh), from 0: unrolled up to kTaps terms a range, else a loop
template <typename V>
__device__ __forceinline__ float adjoint(const float* w, int off, int lb, int nl, int hb, int nh,
                                         V v) {
  float acc = 0.f;
  if (nl <= kTaps && nh <= kTaps) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      if (k < nl) acc = fmaf(w[lb + k], v(lb + k), acc);
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      if (k < nh) acc = fmaf(w[off + hb + k], v(hb + k), acc);
  } else {
#pragma unroll 1
    for (int k = lb; k < lb + nl; ++k) acc = fmaf(w[k], v(k), acc);
#pragma unroll 1
    for (int k = hb; k < hb + nh; ++k) acc = fmaf(w[off + k], v(k), acc);
  }
  return acc;
}

// Grid (P * bands): block b is band b % bands of map b / bands, a thread a column in each pass.
// smem: the image rows [3][img_rows][W] (then R [span_rows][W]), d cam_n's rows
// [span_rows][n], the columns' weights and indices [4][n] and ranges [4][W], the span rows'
// weights and indices [4][span_rows] and the band rows' ranges [4][band].
__global__ void __launch_bounds__(kThreads)
critic_input_bwd_kernel(const float* __restrict__ dA, const float* __restrict__ image,
                        float* __restrict__ dcams, int sents, int H, int W, int n, int ps,
                        int band, int span_rows, int img_rows, bool copy16, tris::TapArrays ty,
                        tris::TapArrays tx, tris::TapRanges ry, tris::TapRanges rx) {
  extern __shared__ __align__(16) float smem[];
  float* ims = smem;
  float* dc = ims + tris::critic_input_bwd_img_floats(span_rows, img_rows, W);
  float* xw = dc + tris::resize_bwd_round4((long long)span_rows * n);
  int* xi = reinterpret_cast<int*>(xw + 2 * n);
  int* xr = xi + 2 * n;
  float* yw = reinterpret_cast<float*>(xr + 4 * W);
  int* yi = reinterpret_cast<int*>(yw + 2 * span_rows);
  int* yr = yi + 2 * span_rows;
  const int tid = threadIdx.x, T = blockDim.x;
  K5_STAMP_ENTRY();

  // the band: source rows [Y0, Y1) of map p; the output rows [y0, y0 + S) their adjoint
  // ranges cover, from the first row's hi range (hi_begin <= lo_begin) to the last row's lo
  // range (lo_end >= hi_end); the image rows [r0, r0 + nr) those sample, within [Y0 - 1, Y1]
  const int bands = (H + band - 1) / band;
  const int p = blockIdx.x / bands;
  const int Y0 = (blockIdx.x - p * bands) * band, Y1 = min(Y0 + band, H), rows = Y1 - Y0;
  const int y0 = ry.hi_begin[Y0];
  const int S = ry.lo_end[Y1 - 1] - y0;  // <= span_rows (the plan's bound)
  float* out = dcams + ((long long)p * H + Y0) * W;
  if (S <= 0) {  // no output row reaches the band: its gradient is 0
    for (int e = tid; e < rows * W; e += T) out[e] = 0.f;
    return;
  }
  const int r0 = ty.lo[y0], nr = ty.hi[y0 + S - 1] + 1 - r0;  // <= img_rows

  // stage the image rows and the taps, every copy in flight at once (the image 16 bytes a
  // copy where W % 4 == 0 and it is 16-byte aligned)
  {
    const long long hw = (long long)H * W;
    const float* img = image + ((long long)(p / sents) * 3 * H + r0) * W;
    for (int c = 0; c < 3; ++c) {
      float* dst = ims + (long long)c * img_rows * W;
      const float* src = img + c * hw;
      if (copy16)
        for (int k = 4 * tid; k < nr * W; k += 4 * T) tris::cp_async16(dst + k, src + k, true);
      else
        for (int k = tid; k < nr * W; k += T) tris::cp_async4(dst + k, src + k, true);
    }
    auto taps = [&](void* dst, const void* src, int count) {
      for (int k = tid; k < count; k += T)
        tris::cp_async4(static_cast<int*>(dst) + k, static_cast<const int*>(src) + k, true);
    };
    taps(xw, tx.w0, n);
    taps(xw + n, tx.w1, n);
    taps(xi, tx.lo, n);
    taps(xi + n, tx.hi, n);
    taps(xr, rx.lo_begin, W);
    taps(xr + W, rx.lo_end, W);
    taps(xr + 2 * W, rx.hi_begin, W);
    taps(xr + 3 * W, rx.hi_end, W);
    taps(yw, ty.w0 + y0, S);
    taps(yw + span_rows, ty.w1 + y0, S);
    taps(yi, ty.lo + y0, S);
    taps(yi + span_rows, ty.hi + y0, S);
    taps(yr, ry.lo_begin + Y0, rows);
    taps(yr + band, ry.lo_end + Y0, rows);
    taps(yr + 2 * band, ry.hi_begin + Y0, rows);
    taps(yr + 3 * band, ry.hi_end + Y0, rows);
    tris::cp_async_commit();
  }

  // d cam_n[y, x] = the channels' fmaf chain of dA times the image sampled at (y, x)
  // (tris::sample2 on the staged rows). dA is read from device memory, a warp's 32 columns
  // one 128-byte line of a patch row where ps = 32: a thread's rows' values are loaded before
  // the copies are waited for
  {
    const int x = tid, g = n / ps, plane = ps * ps, gx = x / ps;
    const float* dp = dA + (long long)p * g * g * 3 * plane + gx * 3 * plane + (x - gx * ps);
    constexpr int kRows = tris::kCriticBwdPrefetchRows;
    float d[kRows][3];
#pragma unroll
    for (int s = 0; s < kRows; ++s)
      if (x < n && s < S) {
        const int y = y0 + s, gy = y / ps;
        const float* dr = dp + (long long)gy * g * 3 * plane + (y - gy * ps) * ps;
#pragma unroll
        for (int c = 0; c < 3; ++c) d[s][c] = dr[c * plane];
      }
    tris::cp_async_wait<0>();
    __syncthreads();
    K5_PHASE(1);
    if (x < n) {
      const int x0 = xi[x], x1 = xi[n + x];
      const float b0 = xw[x], b1 = xw[n + x];
      auto row = [&](int s, const float* dv) {
        const int yl = yi[s] - r0, yh = yi[span_rows + s] - r0;
        const float a0 = yw[s], a1 = yw[span_rows + s];
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc = fmaf(dv[c], tris::sample2(ims + c * img_rows * W, W, yl, yh, a0, a1, x0, x1, b0, b1),
                     acc);
        dc[s * n + x] = acc;
      };
#pragma unroll
      for (int s = 0; s < kRows; ++s)
        if (s < S) row(s, d[s]);
      for (int s = kRows; s < S; ++s) {  // rows past the prefetch (a span no path has)
        const int y = y0 + s, gy = y / ps;
        const float* dr = dp + (long long)gy * g * 3 * plane + (y - gy * ps) * ps;
        const float dv[3] = {dr[0], dr[plane], dr[2 * plane]};
        row(s, dv);
      }
    }
  }
  __syncthreads();
  K5_PHASE(2);

  // R[s, X] in the image rows' space (rows of W floats): a column's ranges read once, its rows
  float* rs = ims;
  for (int X = tid; X < W; X += T) {
    const int lb = xr[X], nl = xr[W + X] - lb, hb = xr[2 * W + X], nh = xr[3 * W + X] - hb;
#pragma unroll 2
    for (int s = 0; s < S; ++s) {
      const float* r = dc + s * n;
      rs[s * W + X] = adjoint(xw, n, lb, nl, hb, nh, [&](int x) { return r[x]; });
    }
  }
  __syncthreads();
  K5_PHASE(3);

  // d cams[p, Y, X] for the band's rows (a row's ranges are the block's)
  for (int X = tid; X < W; X += T) {
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      const int lb = yr[r] - y0, hb = yr[2 * band + r] - y0;
      out[(long long)r * W + X] = adjoint(yw, span_rows, lb, yr[band + r] - y0 - lb, hb,
                                          yr[3 * band + r] - y0 - hb,
                                          [&](int s) { return rs[s * W + X]; });
    }
  }
  K5_PHASE(4);
  K5_STAMP_EXIT();
}

}  // namespace

#ifdef TRIS_K5_STAMPS
// The measurement build's stamp buffer (tools/critic_input_phases.py).
extern "C" cudaError_t k5_set_stamps(unsigned long long* stamps) {
  return cudaMemcpyToSymbol(k5_stamps, &stamps, sizeof(stamps));
}
#endif

cudaError_t tris::critic_input_bwd(const float* dA, const float* image, float* dcams, int P,
                                   int S, int H, int W, int n, int ps, TapArrays ty,
                                   TapArrays tx, TapRanges ry, TapRanges rx, cudaStream_t stream,
                                   CriticBwdLaunchShape* shape) {
  if (P == 0 || H == 0 || W == 0) return cudaSuccess;
  const CriticBwdPlan p = critic_input_bwd_plan(P, H, W, n);
  if (!p.fits) return cudaErrorInvalidValue;
  const bool copy16 = W % 4 == 0 && (reinterpret_cast<unsigned long long>(image) & 15) == 0;
  cudaError_t err = tris::allow_smem(critic_input_bwd_kernel, (size_t)p.smem);
  if (err != cudaSuccess) return err;
  critic_input_bwd_kernel<<<(unsigned)p.blocks, p.threads, p.smem, stream>>>(
      dA, image, dcams, S, H, W, n, ps, p.band, p.span_rows, p.img_rows, copy16, ty, tx, ry, rx);
  err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {p.blocks, p.threads, p.band, p.span_rows, p.smem};
  return err;
}
