// K3, training half, on bfloat16 operands (--bf16): the stage-1 classification head, forward
// and backward, with lan_p bfloat16 and vis_p bfloat16 (the seeded --bf16 init, and
// --clip_weights) or float32 (--pretrain of a float32 checkpoint), the scale float32.
//
// Replaces tris_tpu/models/stage1.py::TRISStage1.__call__ lines 100-131 with train=True and
// its autodiff, as jnp promotes the operands: the dot in their promoted dtype with float32
// sums (rounded to bfloat16 when both are bfloat16), times the float32 scale in float32, and
// everything after in float32 (stage1_head.cu gives the formulas). GMP's gradient is split
// evenly among the tied maxima of a channel, as JAX's max splits it: with both operands
// bfloat16 the dot keeps 8 significant bits and ties among a channel's pixels are likely.
//
// Shapes on the stage-1 train path: B = 48 images against T = 48 texts, h = w = 10, D = 1024,
// H = W = 320; one launch forward and one backward per step.
//
// Design: a block an image, 512 threads, each way one launch (stage1_head.cu's cluster design
// stages float32 rows with cp.async; this first bfloat16 design widens the operands as it
// stages them by plain loads).
//  - Forward. The [hw, T] scores in shared memory, summed over kS1Bf16Chunk channels at a
//    time: both operands' chunk widened into shared memory, a thread a 4 x 4 tile of (pixel,
//    text) adding the chunk's products in channel order onto its entries; then the dot
//    rounded (both bfloat16) and times the scale. A warp a pixel forms the softmax's max and
//    sum over the bg logit and the T scores; a warp a text GAP, GMP with its count of tied
//    pixels, mbar and the focal term, cls_out and cls_fg; the threads the two maps from the
//    own plane with the taps, each product and sum rounded alone as tris::sample2 does. The
//    plane and stats [B, stage1_head_bf16_stats(hw, T)] (per pixel the max and sum, per text
//    mbar, GMP and the count) go to device memory for the backward.
//  - Backward. d seg at each output pixel (d sig_map * s (1 - s), plus d relu_map where seg >
//    0) summed onto the w columns of its row through the adjoint ranges (a thread a (row,
//    column)), then onto the h rows (a thread a plane entry): d own. A warp a pixel forms
//    dscore on its row in shared memory (GAP's g / hw, GMP's g / count at the tied maxima,
//    the softmax's m (dm - sum m dm) with dm = g focal'(mbar) / hw, and d own on the image's
//    own text), times the scale (rounded to bfloat16 when both operands are). Then, a chunk
//    of kS1Bf16GradChunk channels at a time with the other operand's chunk widened into
//    shared memory: d vis_p = dscore . lan_p and d lan_p = dscore^T . vis_p, each summed in
//    order in float32 and written in its operand's dtype.
// No atomics: the same bits run to run.
//
// Bound: bytes - the operands (9.4 MB of lan_p and 9.8 or 19.7 MB of vis_p) read and the two
// maps (39.3 MB) written forward; the maps' gradients read and the two gradients written
// backward.

#include <type_traits>

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = tris::kS1Bf16Threads;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = tris::kS1Bf16Chunk;
constexpr int kGradChunk = tris::kS1Bf16GradChunk;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same_v<T, float>)
    return x;
  else
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float focal(float x, float fp, float fc) {
  return powf(1.f - x, fp) * logf(fc + x);
}

__device__ __forceinline__ float focal_grad(float x, float fp, float fc) {
  return -fp * powf(1.f - x, fp - 1.f) * logf(fc + x) + powf(1.f - x, fp) / (fc + x);
}

// rows [0, n) x channels [c0, c0 + width) of a [n, D] operand at src into dst [n][width]
// float32, zeros past D
template <class T>
__device__ __forceinline__ void widen(float* dst, const T* __restrict__ src, int n, int D, int c0,
                                      int width) {
  for (int i = threadIdx.x; i < n * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[i] = c0 + c < D ? to_f(src[(long long)r * D + c0 + c]) : 0.f;
  }
}

// the same chunk transposed, dst [width][pitch] (channel-major), zeros past n and D
template <class T>
__device__ __forceinline__ void widen_t(float* dst, const T* __restrict__ src, int n, int pitch,
                                        int D, int c0, int width) {
  for (int i = threadIdx.x; i < pitch * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[c * pitch + r] = r < n && c0 + c < D ? to_f(src[(long long)r * D + c0 + c]) : 0.f;
  }
}

// seg at output (y, x) from the own plane o [h, w] with the taps, rows first, each product
// and sum rounded alone
__device__ __forceinline__ float seg_at(const float* o, int w, int y, int x, tris::TapArrays ty,
                                        tris::TapArrays tx) {
  const int y0 = ty.lo[y], y1 = ty.hi[y], x0 = tx.lo[x], x1 = tx.hi[x];
  return tris::sample2(o, w, y0, y1, ty.w0[y], ty.w1[y], x0, x1, tx.w0[x], tx.w1[x]);
}

// Grid B: a block an image.
template <class TV>
__global__ void __launch_bounds__(kThreads)
stage1_head_bf16_fwd_kernel(const TV* __restrict__ vis, const __nv_bfloat16* __restrict__ lan,
                            const float* __restrict__ scale_ptr, float* __restrict__ score,
                            float* __restrict__ stats, float* __restrict__ cls_out,
                            float* __restrict__ cls_fg, float* __restrict__ relu_map,
                            float* __restrict__ sig_map, int T, int off, int h, int w, int D,
                            int H, int W, float fp, float fc, tris::TapArrays ty,
                            tris::TapArrays tx) {
  constexpr bool kRound = std::is_same_v<TV, __nv_bfloat16>;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, hw = h * w, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hw4 = (hw + 3) / 4 * 4, t4 = (T + 3) / 4 * 4;
  float* plane = smem;                         // [hw][T]
  float* va = plane + (hw * T + 3) / 4 * 4;    // [kChunk][hw4], channel-major
  float* lb = va + kChunk * hw4;               // [kChunk][t4]
  float* mx = lb + kChunk * t4;                // [hw]
  float* z = mx + hw;                          // [hw]
  float* own = z + hw;                         // [hw]
  const TV* vb = vis + (long long)b * hw * D;
  const __nv_bfloat16* lt = lan + (long long)b * T * D;

  // 1. the scores: a thread a 4 x 4 tile of (pixel, text), its entries summed chunk by chunk
  for (int i = tid; i < hw * T; i += kThreads) plane[i] = 0.f;
  const int tt = t4 / 4, tiles = hw4 / 4 * tt;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    __syncthreads();  // the previous chunk is read
    widen_t(va, vb, hw, hw4, D, c0, kChunk);
    widen_t(lb, lt, T, t4, D, c0, kChunk);
    __syncthreads();
    for (int t = tid; t < tiles; t += kThreads) {
      const int p0 = t / tt * 4, q0 = t % tt * 4;
      float acc[4][4] = {};
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        const float4 a4 = *reinterpret_cast<const float4*>(va + c * hw4 + p0);
        const float4 l4 = *reinterpret_cast<const float4*>(lb + c * t4 + q0);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w}, l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], l[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p0 + i < hw && q0 + j < T) plane[(p0 + i) * T + q0 + j] += acc[i][j];
    }
  }
  __syncthreads();
  const float scale = *scale_ptr;
  float* out = score + (long long)b * hw * T;
  for (int i = tid; i < hw * T; i += kThreads) {
    const float dot = plane[i];
    const float s = __fmul_rn(scale, kRound ? tris::round_bf16(dot) : dot);
    plane[i] = s;
    out[i] = s;
  }
  __syncthreads();

  // 2. each pixel's softmax max and sum over the bg logit 1 and the T scores
  float* st = stats + (long long)b * tris::stage1_head_bf16_stats(hw, T);
  for (int p = warp; p < hw; p += kWarps) {
    const float* r = plane + p * T;
    float m = 1.f;
    for (int q = lane; q < T; q += 32) m = fmaxf(m, r[q]);
    m = tris::warp_max(m);
    float s = 0.f;
    for (int q = lane; q < T; q += 32) s += expf(r[q] - m);
    s = tris::warp_sum(s);
    if (lane == 0) {
      mx[p] = m;
      z[p] = s + expf(1.f - m);
      st[p] = m;
      st[hw + p] = z[p];
    }
  }
  for (int p = tid; p < hw; p += kThreads) own[p] = plane[p * T + b + off];
  __syncthreads();

  // 3. cls_out, a warp a text: GAP, GMP and its tied pixels, mbar and the focal term
  for (int q = warp; q < T; q += kWarps) {
    float gap = 0.f, gmp = -INFINITY, mbar = 0.f;
    for (int p = lane; p < hw; p += 32) {
      const float v = plane[p * T + q];
      gap += v;
      gmp = fmaxf(gmp, v);
      mbar += expf(v - mx[p]) / z[p];
    }
    gap = tris::warp_sum(gap) / (float)hw;
    gmp = tris::warp_max(gmp);
    mbar = tris::warp_sum(mbar) / (float)hw;
    int ties = 0;
    for (int p = lane; p < hw; p += 32) ties += plane[p * T + q] == gmp;
    ties = tris::warp_sum_int(ties);
    if (lane == 0) {
      cls_out[(long long)b * T + q] = gap + gmp + focal(mbar, fp, fc);
      if (q == b + off) cls_fg[b] = mbar;
      st[2 * hw + q] = mbar;
      st[2 * hw + T + q] = gmp;
      st[2 * hw + 2 * T + q] = (float)ties;
    }
  }

  // 4. the maps of the own plane
  const long long mo = (long long)b * H * W;
  for (int i = tid; i < H * W; i += kThreads) {
    const int y = i / W, x = i - y * W;
    const float s = seg_at(own, w, y, x, ty, tx);
    relu_map[mo + i] = s > 0.f ? s : 0.f;
    sig_map[mo + i] = sigmoid(s);
  }
}

// Grid B: a block an image. g_relu and g_sig [B, H, W] or null; ry and rx the taps' adjoint
// ranges.
template <class TV>
__global__ void __launch_bounds__(kThreads)
stage1_head_bf16_bwd_kernel(const float* __restrict__ g_cls, const float* __restrict__ g_relu,
                            const float* __restrict__ g_sig, const TV* __restrict__ vis,
                            const __nv_bfloat16* __restrict__ lan,
                            const float* __restrict__ scale_ptr, const float* __restrict__ score,
                            const float* __restrict__ stats, TV* __restrict__ d_vis,
                            __nv_bfloat16* __restrict__ d_lan, int T, int off, int h, int w,
                            int D, int H, int W, float fp, float fc, tris::TapArrays ty,
                            tris::TapArrays tx, tris::TapRanges ry, tris::TapRanges rx) {
  constexpr bool kRound = std::is_same_v<TV, __nv_bfloat16>;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, hw = h * w, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ds = smem;                    // [hw][T]: the scores, then dscore times the scale
  float* own = ds + (hw * T + 3) / 4 * 4;  // [hw]
  float* down = own + hw;              // [hw]: d own
  float* rows = down + hw;             // [H][w]: d seg summed onto the columns
  float* dm = rows + H * w;            // [T]: g focal'(mbar) / hw
  float* stage = dm + T;               // [max(hw, T)][kGradChunk]
  const float* st = stats + (long long)b * tris::stage1_head_bf16_stats(hw, T);
  const float* gc = g_cls + (long long)b * T;
  const float* sc = score + (long long)b * hw * T;
  for (int i = tid; i < hw * T; i += kThreads) ds[i] = sc[i];
  for (int q = tid; q < T; q += kThreads)
    dm[q] = gc[q] * focal_grad(st[2 * hw + q], fp, fc) / (float)hw;
  __syncthreads();
  for (int p = tid; p < hw; p += kThreads) own[p] = ds[p * T + b + off];
  __syncthreads();

  // 1. d own: d seg onto the columns of each output row, then onto the h rows
  const long long mo = (long long)b * H * W;
  const bool maps = g_relu != nullptr || g_sig != nullptr;
  auto dseg = [&](int y, int x) {
    const float s = seg_at(own, w, y, x, ty, tx);
    float d = 0.f;
    if (g_sig != nullptr) {
      const float sg = sigmoid(s);
      d = g_sig[mo + (long long)y * W + x] * sg * (1.f - sg);
    }
    if (g_relu != nullptr && s > 0.f) d += g_relu[mo + (long long)y * W + x];
    return d;
  };
  if (maps) {
    for (int i = tid; i < H * w; i += kThreads) {
      const int y = i / w, j = i - y * w;
      float a = 0.f;
      for (int x = rx.lo_begin[j]; x < rx.lo_end[j]; ++x) a = fmaf(tx.w0[x], dseg(y, x), a);
      for (int x = rx.hi_begin[j]; x < rx.hi_end[j]; ++x) a = fmaf(tx.w1[x], dseg(y, x), a);
      rows[i] = a;
    }
    __syncthreads();
    for (int p = tid; p < hw; p += kThreads) {
      const int i = p / w, j = p - i * w;
      float a = 0.f;
      for (int y = ry.lo_begin[i]; y < ry.lo_end[i]; ++y) a = fmaf(ty.w0[y], rows[y * w + j], a);
      for (int y = ry.hi_begin[i]; y < ry.hi_end[i]; ++y) a = fmaf(ty.w1[y], rows[y * w + j], a);
      down[p] = a;
    }
  } else {
    for (int p = tid; p < hw; p += kThreads) down[p] = 0.f;
  }
  __syncthreads();

  // 2. dscore times the scale, a warp a pixel, in the scores' place
  const float scale = *scale_ptr;
  for (int p = warp; p < hw; p += kWarps) {
    float* r = ds + p * T;
    const float m0 = st[p], z0 = st[hw + p];
    float s = 0.f;  // sum over the channels of m dm (the bg channel's dm is 0)
    for (int q = lane; q < T; q += 32) s += expf(r[q] - m0) / z0 * dm[q];
    s = tris::warp_sum(s);
    for (int q = lane; q < T; q += 32) {
      const float v = r[q], m = expf(v - m0) / z0;
      float d = gc[q] / (float)hw + m * (dm[q] - s);
      if (v == st[2 * hw + T + q]) d += gc[q] / st[2 * hw + 2 * T + q];  // GMP, split
      if (q == b + off) d += down[p];
      const float a = __fmul_rn(scale, d);
      r[q] = kRound ? tris::round_bf16(a) : a;
    }
  }

  // 3. the gradients, a chunk of channels at a time
  const TV* vb = vis + (long long)b * hw * D;
  const __nv_bfloat16* lt = lan + (long long)b * T * D;
  TV* dv = d_vis + (long long)b * hw * D;
  __nv_bfloat16* dl = d_lan + (long long)b * T * D;
  for (int c0 = 0; c0 < D; c0 += kGradChunk) {
    const int width = min(kGradChunk, D - c0);
    __syncthreads();  // dscore formed; the previous chunk's stage read
    widen(stage, lt, T, D, c0, kGradChunk);
    __syncthreads();
    for (int i = tid; i < hw * width; i += kThreads) {  // d vis_p = dscore . lan_p
      const int p = i / width, c = i - p * width;
      float a = 0.f;
      for (int q = 0; q < T; ++q) a = fmaf(ds[p * T + q], stage[q * kGradChunk + c], a);
      dv[(long long)p * D + c0 + c] = from_f<TV>(a);
    }
    __syncthreads();
    widen(stage, vb, hw, D, c0, kGradChunk);
    __syncthreads();
    for (int i = tid; i < T * width; i += kThreads) {  // d lan_p = dscore^T . vis_p
      const int q = i / width, c = i - q * width;
      float a = 0.f;
      for (int p = 0; p < hw; ++p) a = fmaf(ds[p * T + q], stage[p * kGradChunk + c], a);
      dl[(long long)q * D + c0 + c] = __float2bfloat16_rn(a);
    }
  }
}

template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int B, long long smem, cudaStream_t stream, Args... args) {
  if (smem > tris::kS1Bf16MaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = tris::allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, (size_t)smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

cudaError_t tris::stage1_head_bf16(const void* vis_p, bool vis_bf16, const Bf16Bits* lan_p,
                                   const float* scale, float* score, float* stats,
                                   float* cls_out, float* cls_fg, float* relu_map,
                                   float* sig_map, int B, int T, int offset, int h, int w, int D,
                                   int H, int W, float focal_p, float focal_c, TapArrays ty,
                                   TapArrays tx, cudaStream_t stream) {
  const long long smem = stage1_head_bf16_smem(h * w, T, H, w, false);
  const auto* lan = reinterpret_cast<const __nv_bfloat16*>(lan_p);
  if (vis_bf16)
    return launch(stage1_head_bf16_fwd_kernel<__nv_bfloat16>, B, smem, stream,
                  static_cast<const __nv_bfloat16*>(vis_p), lan, scale, score, stats, cls_out,
                  cls_fg, relu_map, sig_map, T, offset, h, w, D, H, W, focal_p, focal_c, ty, tx);
  return launch(stage1_head_bf16_fwd_kernel<float>, B, smem, stream,
                static_cast<const float*>(vis_p), lan, scale, score, stats, cls_out, cls_fg,
                relu_map, sig_map, T, offset, h, w, D, H, W, focal_p, focal_c, ty, tx);
}

cudaError_t tris::stage1_head_bwd_bf16(const float* g_cls, const float* g_relu,
                                       const float* g_sig, const void* vis_p, bool vis_bf16,
                                       const Bf16Bits* lan_p, const float* scale,
                                       const float* score, const float* stats, void* d_vis,
                                       Bf16Bits* d_lan, int B, int T, int offset, int h, int w,
                                       int D, int H, int W, float focal_p, float focal_c,
                                       TapArrays ty, TapArrays tx, TapRanges ry, TapRanges rx,
                                       cudaStream_t stream) {
  const long long smem = stage1_head_bf16_smem(h * w, T, H, w, true);
  const auto* lan = reinterpret_cast<const __nv_bfloat16*>(lan_p);
  auto* dl = reinterpret_cast<__nv_bfloat16*>(d_lan);
  if (vis_bf16)
    return launch(stage1_head_bf16_bwd_kernel<__nv_bfloat16>, B, smem, stream, g_cls, g_relu,
                  g_sig, static_cast<const __nv_bfloat16*>(vis_p), lan, scale, score, stats,
                  static_cast<__nv_bfloat16*>(d_vis), dl, T, offset, h, w, D, H, W, focal_p,
                  focal_c, ty, tx, ry, rx);
  return launch(stage1_head_bf16_bwd_kernel<float>, B, smem, stream, g_cls, g_relu, g_sig,
                static_cast<const float*>(vis_p), lan, scale, score, stats,
                static_cast<float*>(d_vis), dl, T, offset, h, w, D, H, W, focal_p, focal_c, ty,
                tx, ry, rx);
}
