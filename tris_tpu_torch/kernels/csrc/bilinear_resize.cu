// K6, bilinear half: a stack of float32 planes resized bilinearly.
//
// Replaces tris_tpu/ops/resize.py::bilinear_resize (line 57), which resizes
// [..., H, W] by two HIGHEST-precision products with the interpolation
// matrices; here each output element takes its four taps
// (ops/resize.py::interp_taps, the matrices' two nonzeros per row) rows
// first into one value per input column, t = wy0 x[y0] + wy1 x[y1], then the
// columns, out = wx0 t[x0] + wx1 t[x1], each product and sum rounded on its
// own (__fmul_rn/__fadd_rn; nvcc would otherwise contract a*b + c into an
// FMA), so the plain PyTorch version, which does the same operations in the
// same order, agrees bit for bit. Either align_corners setting: the taps
// carry it.
//
// Shapes: IRNet's heads' x2 and x4 upsamples of [2, 32..256, 30..60, 40..80],
// the CAM [480, 640] -> the [120, 160] grid (align_corners=True) and the walk
// [K, 120, 160] -> [K, 480, 640]; stage 2's decoder taps [48, 64..256,
// 10..40^2] x2 and its heads [48, 1, 20..80^2] -> 320^2.
//
// Bound: bytes - the input read once and the output written once; six flops
// an output. A thread an output element pays index arithmetic, eight tap loads
// and four gathers for every 4-byte store, so the heads ran at a fifth of the
// card's rate whatever their input size. Design (launchers.h,
// bilinear_resize_plan): the planes' output rows are flattened into planes *
// oh rows, and a block takes a band of consecutive rows (small planes share a
// block; a row finds its plane with one division) and a tile of columns. A
// thread owns `vec` consecutive columns: their x taps stay in registers for
// the whole band, and with vec = 4 (ow % 4 == 0) its outputs leave in one
// 16-byte store. With one tile the block first copies the input rows its
// band spans, contiguous in x, into shared memory (cp.async, every copy in
// flight at once). The band goes rows * rpt rows at a time, a thread taking
// rpt of them: each row's t over the input columns its tile spans is formed
// once into shared memory (two buffers, one barrier a chunk), where the
// columns sample it; at x2 and more that removes most products and gathers,
// as t is shared by every output column between two input columns, and rpt
// rows a thread keep several stores in flight for each barrier. Where a t-row
// would hold more values than its outputs (w > ow: the CAM to the walk's
// grid), or the t-rows would not fit kResizeSmem, each output samples device
// memory directly, a column a thread.

#include <limits.h>

#include "common.cuh"
#include "launchers.h"

namespace {

// The flattened output row r as (plane, oy): one 32-bit division where r fits.
__device__ __forceinline__ void plane_row(long long r, int oh, long long& plane, int& oy) {
  if (r <= INT_MAX) {
    const unsigned q = (unsigned)r / (unsigned)oh;
    plane = q;
    oy = (int)((unsigned)r - q * (unsigned)oh);
  } else {
    plane = r / oh;
    oy = (int)(r - plane * oh);
  }
}

template <int kVec>
__device__ __forceinline__ void store(float* o, const float (&v)[kVec]) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  else
    o[0] = v[0];
}

// bfloat16 outputs: each value rounded once, 4 of them an 8-byte store
template <int kVec>
__device__ __forceinline__ void store(__nv_bfloat16* o, const float (&v)[kVec]) {
  if constexpr (kVec == 4)
    tris::store4_bf16(o, make_float4(v[0], v[1], v[2], v[3]));
  else
    o[0] = __float2bfloat16_rn(v[0]);
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// w0 a + w1 b, each product and the sum rounded on their own; rounded to bfloat16 for a
// bfloat16 resize (T)
template <class T>
__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  const float v = __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
  return std::is_same_v<T, float> ? v : tris::round_bf16(v);
}

// Grid (bands, tiles); threads (rows of tile_groups); kVec columns a thread, rpt rows of each
// chunk. in_floats > 0: the band's input rows are copied to shared memory first (kAligned: 16
// bytes a copy, w % 4 == 0 and x 16-byte aligned; else 4; bfloat16 widened a value at a time).
// T: float, or __nv_bfloat16 (--bf16).
template <int kVec, bool kStaged, bool kAligned, class T>
__global__ void __launch_bounds__(tris::kResizeThreads)
bilinear_resize_kernel(const T* __restrict__ x, T* __restrict__ out, long long total,
                       int h, int w, int oh, int ow, int tile_groups, int pitch, int rpt,
                       int chunks, long long in_floats, tris::TapArrays ty, tris::TapArrays tx) {
  // [in_floats] the band's input rows, then [2][rows * rpt][pitch] t-rows
  extern __shared__ __align__(16) float smem[];
  const int rows = blockDim.x / tile_groups, crow = rows * rpt;
  const int gi = threadIdx.x / tile_groups, q = threadIdx.x - gi * tile_groups;
  // this tile's columns, and the input columns [j0, j1) their taps span
  const int c_begin = blockIdx.y * tile_groups * kVec;
  const int c_end = min(c_begin + tile_groups * kVec, ow);
  const int c = c_begin + q * kVec;
  const int j0 = tx.lo[c_begin], j1 = tx.hi[c_end - 1] + 1;
  const long long band0 = (long long)blockIdx.x * crow * chunks;
  // the band's input: flattened input rows [f0, f1) of x, where they fit
  long long f0 = 0;
  bool in_smem = false;
  if constexpr (kStaged) {
    if (in_floats > 0) {
      const long long r_last = min(band0 + (long long)crow * chunks, total) - 1;
      long long p0, p1;
      int oy0, oy1;
      plane_row(band0, oh, p0, oy0);
      plane_row(r_last, oh, p1, oy1);
      f0 = p0 * h + ty.lo[oy0];
      const long long need = (p1 * h + ty.hi[oy1] + 1 - f0) * w;
      in_smem = need <= in_floats;
      if (in_smem) {
        const T* src = x + f0 * w;
        if constexpr (!std::is_same_v<T, float>) {
          for (long long k = threadIdx.x; k < need; k += blockDim.x) smem[k] = load(src + k);
        } else if constexpr (kAligned) {
          for (long long k = 4LL * threadIdx.x; k < need; k += 4LL * blockDim.x)
            tris::cp_async16(smem + k, src + k, true);
        } else {
          for (long long k = threadIdx.x; k < need; k += blockDim.x)
            tris::cp_async4(smem + k, src + k, true);
        }
        tris::cp_async_commit();
      }
    }
  }
  // the thread's columns' x taps, relative to j0, for the whole band (while the copies fly)
  int lo[kVec], hi[kVec];
  float a[kVec], b[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const bool in = c + k < ow;
    lo[k] = in ? tx.lo[c + k] - j0 : 0;
    hi[k] = in ? tx.hi[c + k] - j0 : 0;
    a[k] = in ? tx.w0[c + k] : 0.f;
    b[k] = in ? tx.w1[c + k] : 0.f;
  }
  if constexpr (kStaged) {
    if (in_smem && std::is_same_v<T, float>) tris::cp_async_wait<0>();
    __syncthreads();
  }
  float* tbuf = smem + in_floats;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const long long rc = band0 + (long long)chunk * crow;
    float v[kVec];
    if constexpr (kStaged) {
      float* tb = tbuf + (long long)(chunk & 1) * crow * pitch;
      // the thread's rows of the chunk: their t-rows, then their outputs
      for (int k = 0; k < rpt; ++k) {
        const int lr = gi + k * rows;
        const long long r = rc + lr;
        if (r >= total) break;
        long long plane;
        int oy;
        plane_row(r, oh, plane, oy);
        const float wy0 = ty.w0[oy], wy1 = ty.w1[oy];
        // input rows f = plane * h + y, from shared memory (row f - f0) or from x
        const long long f0r = plane * h + ty.lo[oy], f1r = plane * h + ty.hi[oy];
        float* t = tb + lr * pitch;
        auto t_row = [&](const auto* r0, const auto* r1) {
#pragma unroll 4
          for (int j = j0 + q; j < j1; j += tile_groups)
            t[j - j0] = lerp2<T>(wy0, load(r0 + j), wy1, load(r1 + j));
        };
        if (in_smem)
          t_row(smem + (f0r - f0) * w, smem + (f1r - f0) * w);
        else
          t_row(x + f0r * w, x + f1r * w);
      }
      __syncthreads();  // the chunk's t-rows are in; the buffer written next was read a chunk ago
      for (int k = 0; k < rpt; ++k) {
        const int lr = gi + k * rows;
        const long long r = rc + lr;
        if (r >= total || c >= ow) break;
        const float* t = tb + lr * pitch;
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = lerp2<T>(a[e], t[lo[e]], b[e], t[hi[e]]);
        store<kVec>(out + r * ow + c, v);
      }
    } else {
      for (int k = 0; k < rpt; ++k) {
        const long long r = rc + gi + k * rows;
        if (r >= total || c >= ow) break;
        long long plane;
        int oy;
        plane_row(r, oh, plane, oy);
        const T* src = x + plane * h * w;
        const T* y0 = src + (long long)ty.lo[oy] * w;
        const T* y1 = src + (long long)ty.hi[oy] * w;
        const float wy0 = ty.w0[oy], wy1 = ty.w1[oy];
        // the two t values of each column, then the column's lerp: sample2's order
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int x0 = lo[e] + j0, x1 = hi[e] + j0;
          v[e] = lerp2<T>(a[e], lerp2<T>(wy0, load(y0 + x0), wy1, load(y1 + x0)), b[e],
                          lerp2<T>(wy0, load(y0 + x1), wy1, load(y1 + x1)));
        }
        store<kVec>(out + r * ow + c, v);
      }
    }
  }
}

template <int kVec, bool kStaged, bool kAligned, class T>
cudaError_t launch(const tris::ResizePlan& p, const T* x, T* out, long long total, int h, int w,
                   int oh, int ow, tris::TapArrays ty, tris::TapArrays tx, cudaStream_t stream) {
  bilinear_resize_kernel<kVec, kStaged, kAligned, T>
      <<<dim3((unsigned)p.bands, (unsigned)p.tiles), p.threads, p.smem, stream>>>(
          x, out, total, h, w, oh, ow, p.tile_groups, p.pitch, p.rpt, p.chunks, p.in_floats, ty,
          tx);
  return cudaGetLastError();
}

// The plan's launch on T's planes (bfloat16 staging takes no cp.async: kAligned false).
template <class T>
cudaError_t resize(const T* x, T* out, int64_t planes, int h, int w, int oh, int ow,
                   tris::TapArrays ty, tris::TapArrays tx, cudaStream_t stream,
                   tris::ResizeLaunchShape* shape) {
  const long long total = planes * oh;
  if (total == 0 || ow == 0) return cudaSuccess;
  const tris::ResizePlan p = tris::bilinear_resize_plan(planes, h, w, oh, ow);
  const bool aligned = std::is_same_v<T, float> && w % 4 == 0 &&
                       (reinterpret_cast<unsigned long long>(x) & 15) == 0;
  cudaError_t err;
  if (!p.staged)
    err = p.vec == 4 ? launch<4, false, false>(p, x, out, total, h, w, oh, ow, ty, tx, stream)
                     : launch<1, false, false>(p, x, out, total, h, w, oh, ow, ty, tx, stream);
  else if (p.vec == 4)
    err = aligned ? launch<4, true, true>(p, x, out, total, h, w, oh, ow, ty, tx, stream)
                  : launch<4, true, false>(p, x, out, total, h, w, oh, ow, ty, tx, stream);
  else
    err = aligned ? launch<1, true, true>(p, x, out, total, h, w, oh, ow, ty, tx, stream)
                  : launch<1, true, false>(p, x, out, total, h, w, oh, ow, ty, tx, stream);
  if (err == cudaSuccess && shape != nullptr)
    *shape = {p.blocks, p.tiles, p.threads, p.band_rows, p.vec, p.staged, p.in_floats, p.smem};
  return err;
}

}  // namespace

cudaError_t tris::bilinear_resize(const float* x, float* out, int64_t planes, int h, int w,
                                  int oh, int ow, TapArrays ty, TapArrays tx,
                                  cudaStream_t stream, ResizeLaunchShape* shape) {
  return resize(x, out, planes, h, w, oh, ow, ty, tx, stream, shape);
}

cudaError_t tris::bilinear_resize_bf16(const Bf16Bits* x, Bf16Bits* out, int64_t planes, int h,
                                       int w, int oh, int ow, TapArrays ty, TapArrays tx,
                                       cudaStream_t stream, ResizeLaunchShape* shape) {
  return resize(reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<__nv_bfloat16*>(out),
                planes, h, w, oh, ow, ty, tx, stream, shape);
}
