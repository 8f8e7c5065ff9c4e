// K11: PixelAttention's pixel-word attention, forward, float32.
//
// Replaces the two einsums and the softmax between them of the JAX
// package's tris_tpu/models/fusion.py::PixelAttention (lines 37-40):
//   G[pair, p] = softmax_t(q[n, p] . Lk[pair, t] / d) . Lv[pair]
// with n = pair / S: q (the InstanceNorm'd Wq projection of the pixels)
// exists once per image and each of the image's S sentences (pairs) reads it
// in place, as K2 does. No token mask: every one of the T tokens attends, as
// in JAX and the reference. The Dense layers around it stay cuBLAS GEMMs.
//
// Shapes on the stage-2 train path (B = 48 images, one sentence each, T = 20
// tokens): c2 HW = 1600 pixels x Ci = 512, c3 400 x 1024, c4 100 x 2048; on
// the eval path 8 images x S = 4 pairs. One launch per call.
//
// Bound: bytes (q read once per pair and G written once; 2 T multiply-adds
// per element of each). Design: one block per (pair, tile of 16 pixels), one
// warp per pixel. The pair's Lk rows, then its Lv rows, are staged through
// shared memory in chunks of 128 channels (T x 128 floats), which every warp
// of the block reads with lanes over channels (conflict-free). Each lane keeps
// T partial logits in registers; a butterfly warp sum gives every lane all T
// logits, the softmax runs in registers in float32, and the second pass forms
// G's row chunk by chunk with lanes over channels (coalesced writes).

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;   // channels of Lk / Lv staged at a time

// grid (ceil(HW / kWarps), P)
__global__ void __launch_bounds__(kThreads)
pixel_attn_kernel(const float* __restrict__ q, const float* __restrict__ lk,
                  const float* __restrict__ lv, float* __restrict__ out, int HW, int T, int C,
                  int S, float div) {
  __shared__ float kv[tris::kPixelAttnMaxT * kChunk];
  const int pair = blockIdx.y, n = pair / S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * kWarps + warp;
  const bool live = p < HW;
  const float* qr = q + ((long long)n * HW + (live ? p : 0)) * C;
  const float* kb = lk + (long long)pair * T * C;
  const float* vb = lv + (long long)pair * T * C;

  float s[tris::kPixelAttnMaxT];
#pragma unroll
  for (int t = 0; t < tris::kPixelAttnMaxT; ++t) s[t] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cw = min(kChunk, C - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < T * kChunk; i += kThreads) {
      const int t = i / kChunk, c = i % kChunk;
      kv[i] = c < cw ? kb[(long long)t * C + c0 + c] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int c = lane; c < cw; c += 32) {
      const float qc = qr[c0 + c];
#pragma unroll
      for (int t = 0; t < tris::kPixelAttnMaxT; ++t)
        if (t < T) s[t] = fmaf(qc, kv[t * kChunk + c], s[t]);
    }
  }
  // every lane gets all T logits, then the softmax over them
  float mx = -INFINITY;
#pragma unroll
  for (int t = 0; t < tris::kPixelAttnMaxT; ++t) {
    if (t < T) {
      s[t] = tris::warp_sum(s[t]) / div;
      mx = fmaxf(mx, s[t]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < tris::kPixelAttnMaxT; ++t) {
    if (t < T) {
      s[t] = expf(s[t] - mx);
      sum += s[t];
    }
  }
#pragma unroll
  for (int t = 0; t < tris::kPixelAttnMaxT; ++t)
    if (t < T) s[t] = s[t] / sum;

  float* o = out + ((long long)pair * HW + (live ? p : 0)) * C;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cw = min(kChunk, C - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < T * kChunk; i += kThreads) {
      const int t = i / kChunk, c = i % kChunk;
      kv[i] = c < cw ? vb[(long long)t * C + c0 + c] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int c = lane; c < cw; c += 32) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < tris::kPixelAttnMaxT; ++t)
        if (t < T) acc = fmaf(s[t], kv[t * kChunk + c], acc);
      o[c0 + c] = acc;
    }
  }
}

}  // namespace

cudaError_t tris::pixel_attn(const float* q, const float* lk, const float* lv, float* out, int P,
                             int HW, int T, int C, int S, float div, cudaStream_t stream) {
  if (P == 0 || HW == 0) return cudaSuccess;
  const dim3 grid((HW + kWarps - 1) / kWarps, P);
  pixel_attn_kernel<<<grid, kThreads, 0, stream>>>(q, lk, lv, out, HW, T, C, S, div);
  return cudaGetLastError();
}
