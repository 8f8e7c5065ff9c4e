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
// of up to 640x640; one launch per batch.
//
// Bound: bytes - the maps read once and the gt masks over each valid region;
// only [B, S] scalars are written. The JAX package builds padded [maxH, h]
// and [maxW, w] interpolation matrices and materialises the padded
// normalised plane; here one block per (b, s) samples the map with the same
// matrices' two taps per row (built on the host in float64 and cast, as the
// matrices are) in two passes over the valid region: the max, then the
// normalised value, threshold, I/U counts and argmax, all in registers and
// one block reduction each. The [h, w] map (400 KB) stays in L2 between the
// passes; no padded plane exists unless the caller asks for it.

#include <limits.h>

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// tables: [B, maxH] (y) and [B, maxW] (x) taps per image; grid (S, B)
__global__ void __launch_bounds__(kThreads)
eval_metrics_kernel(const float* __restrict__ cams, int S, int h, int w, int maxH, int maxW,
                    const int* __restrict__ ylo, const int* __restrict__ yhi,
                    const float* __restrict__ wy0, const float* __restrict__ wy1,
                    const int* __restrict__ xlo, const int* __restrict__ xhi,
                    const float* __restrict__ wx0, const float* __restrict__ wx1,
                    const int* __restrict__ orig_hw, const unsigned char* __restrict__ targets,
                    const float* __restrict__ boxes, float* __restrict__ norm_out,
                    float* __restrict__ stats) {
  __shared__ float red[32];
  __shared__ int red_i[32];
  __shared__ int red_u[32];
  const int s = blockIdx.x, b = blockIdx.y;
  const int oh = orig_hw[2 * b], ow = orig_hw[2 * b + 1];
  const float* plane = cams + ((long long)b * S + s) * h * w;
  const int* yl = ylo + (long long)b * maxH;
  const int* yh = yhi + (long long)b * maxH;
  const float* ya = wy0 + (long long)b * maxH;
  const float* yb = wy1 + (long long)b * maxH;
  const int* xl = xlo + (long long)b * maxW;
  const int* xh = xhi + (long long)b * maxW;
  const float* xa = wx0 + (long long)b * maxW;
  const float* xb = wx1 + (long long)b * maxW;
  const int n = oh * ow;

  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int y = i / ow, x = i % ow;
    mx = fmaxf(mx, tris::sample2(plane, w, yl[y], yh[y], ya[y], yb[y], xl[x], xh[x], xa[x], xb[x]));
  }
  mx = tris::block_max(mx, red);
  const float denom = mx + 1e-5f;
  __syncthreads();  // every thread has read red before it is reused below

  if (norm_out) {
    float* o = norm_out + ((long long)b * S + s) * maxH * maxW;
    for (int i = threadIdx.x; i < maxH * maxW; i += kThreads) {
      const int y = i / maxW, x = i % maxW;
      float v = 0.f;
      if (y < oh && x < ow)
        v = __fdiv_rn(tris::sample2(plane, w, yl[y], yh[y], ya[y], yb[y], xl[x], xh[x], xa[x], xb[x]),
                      denom);
      o[i] = v;
    }
    return;
  }

  const unsigned char* tg = targets + (long long)b * maxH * maxW;
  int inter = 0, uni = 0, best_i = INT_MAX;
  float best = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int y = i / ow, x = i % ow;
    const float v = __fdiv_rn(
        tris::sample2(plane, w, yl[y], yh[y], ya[y], yb[y], xl[x], xh[x], xa[x], xb[x]), denom);
    const bool pred = v > 1e-9f;
    const bool gt = tg[y * maxW + x] != 0;
    inter += pred && gt;
    uni += pred || gt;
    const int flat = y * maxW + x;   // visited in increasing order per thread
    if (v > best) {
      best = v;
      best_i = flat;
    }
  }
  // block argmax, ties to the lowest flat index, plus the two counts
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
  __shared__ int red_idx[32];
  if (lane == 0) {
    red[warp] = best;
    red_idx[warp] = best_i;
    red_i[warp] = inter;
    red_u[warp] = uni;
  }
  __syncthreads();
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
    if (lane == 0) {
      const float py = (float)(best_i / maxW), px = (float)(best_i % maxW);
      const float* bx = boxes + 4 * b;
      const bool hit = bx[0] <= px && px <= bx[2] && bx[1] <= py && py <= bx[3];
      float* st = stats + 4 * ((long long)b * S + s);
      st[0] = (float)inter;
      st[1] = (float)uni;
      st[2] = hit ? 1.f : 0.f;
      st[3] = (float)tg[best_i];
    }
  }
}

}  // namespace

cudaError_t tris::eval_metrics(const float* cams, int B, int S, int h, int w, int maxH, int maxW,
                               const int* ylo, const int* yhi, const float* wy0,
                               const float* wy1, const int* xlo, const int* xhi,
                               const float* wx0, const float* wx1, const int* orig_hw,
                               const unsigned char* targets, const float* boxes,
                               float* norm_out, float* stats, cudaStream_t stream) {
  eval_metrics_kernel<<<dim3(S, B), kThreads, 0, stream>>>(
      cams, S, h, w, maxH, maxW, ylo, yhi, wy0, wy1, xlo, xhi, wx0, wx1, orig_hw, targets,
      boxes, norm_out, stats);
  return cudaGetLastError();
}
