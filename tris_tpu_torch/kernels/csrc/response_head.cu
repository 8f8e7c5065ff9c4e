// K3: the stage-1 response head, forward, float32.
//
// Replaces tris_tpu/models/stage1.py::TRISStage1.response_maps lines 168-179
// (and the eval branch of __call__, lines 97-113): per (image, sentence)
// pair, the fusion residual vis_p = new_vis * alpha + norm_vis[b] (b = pair /
// S), the score exp(logit_scale) * <vis_p, lan_p> over D channels at each of
// the h*w pixels, an align_corners=False bilinear upsample h*w -> H*W, relu.
//
// Shapes on the stage-1 eval path: D = 1024, h = w = 10, H = W = 320, 32
// pairs (8 images x 4 sentences); one launch per forward.
//
// Bound: bytes - the [pairs, h*w, D] fused plane read once and the
// [pairs, H, W] maps written once; a handful of flops per byte. Design: one
// block per pair. Warps over pixels, lanes over channels form the score
// plane in shared memory (the residual is fused, so vis_p never reaches
// device memory), then all threads write the upsampled, relu'd plane in
// coalesced rows. The interpolation taps are the JAX package's matrix rows
// (ops/resize.py::interp_taps), sampled rows first as its matmuls are.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
response_head_kernel(const float* __restrict__ vis_new, const float* __restrict__ vis_base,
                     const float* __restrict__ lan, float* __restrict__ out, int S, int h,
                     int w, int D, int H, int W, float alpha,
                     const float* __restrict__ scale_ptr,
                     const int* __restrict__ ylo, const int* __restrict__ yhi,
                     const float* __restrict__ wy0, const float* __restrict__ wy1,
                     const int* __restrict__ xlo, const int* __restrict__ xhi,
                     const float* __restrict__ wx0, const float* __restrict__ wx1) {
  extern __shared__ float score[];  // [h*w]
  const float scale = *scale_ptr;
  const int pair = blockIdx.x, b = pair / S, hw = h * w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* l = lan + (long long)pair * D;
  for (int p = warp; p < hw; p += kWarps) {
    const float* vb = vis_base + ((long long)b * hw + p) * D;
    const float* vn = vis_new ? vis_new + ((long long)pair * hw + p) * D : nullptr;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = vn ? __fadd_rn(__fmul_rn(vn[c], alpha), vb[c]) : vb[c];
      s = fmaf(v, l[c], s);
    }
    s = tris::warp_sum(s);
    if (lane == 0) score[p] = scale * s;
  }
  __syncthreads();

  float* o = out + (long long)pair * H * W;
  for (int i = threadIdx.x; i < H * W; i += kThreads) {
    const int y = i / W, x = i % W;
    const float v = tris::sample2(score, w, ylo[y], yhi[y], wy0[y], wy1[y], xlo[x], xhi[x],
                                  wx0[x], wx1[x]);
    o[i] = fmaxf(v, 0.f);
  }
}

}  // namespace

cudaError_t tris::response_head(const float* vis_new, const float* vis_base, const float* lan,
                                float* out, int P, int S, int h, int w, int D, int H, int W,
                                float alpha, const float* scale, const int* ylo, const int* yhi,
                                const float* wy0, const float* wy1, const int* xlo,
                                const int* xhi, const float* wx0, const float* wx1,
                                cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)h * w;
  const cudaError_t err = tris::allow_smem(response_head_kernel, smem);
  if (err != cudaSuccess) return err;
  response_head_kernel<<<P, kThreads, smem, stream>>>(
      vis_new, vis_base, lan, out, S, h, w, D, H, W, alpha, scale, ylo, yhi, wy0, wy1,
      xlo, xhi, wx0, wx1);
  return cudaGetLastError();
}
