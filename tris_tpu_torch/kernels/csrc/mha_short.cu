// K1: short-sequence multi-head attention, forward, float32.
//
// Replaces the JAX package's hand-shaped XLA attention,
// tris_tpu/models/layers.py::multi_head_attention (lines 25-48):
//   out = softmax((q * hd^-1/2) . k^T + mask) . v
// per (sequence, head), q scaled BEFORE the dot and the mask additive (-inf
// for the causal mask, so masked logits vanish in the exp).
//
// Shapes on the stage-1 path: the CLIP text tower, L = 20 causal, 8 heads,
// hd 64, over N = B*S sequences, 12 launches per forward. The same kernel
// takes attnpool's 101 tokens (32 heads) and the critic's 50 (12 heads).
//
// Bound: at L <= 128 the work is ~4*L*hd flops per loaded q/k/v float, far
// below the card's flop:byte ratio, so it is bound by the bytes of q, k, v
// and out. Design: one block per (sequence, head) keeps that head's whole K
// and V tile in shared memory (read from device memory once); each warp
// takes query rows in turn, lanes over keys for the logits (K rows padded to
// hd+1 floats so lanes hit distinct banks) and over channels for P.V. The
// logits and the softmax live in shared memory; nothing but out is written.

#include "common.cuh"
#include "launchers.h"

namespace {

using tris::warp_max;
using tris::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// q/k/v element (n, l, h*hd + d) lives at base + n*seq + l*row + h*hd + d;
// out is contiguous [N, Lq, n_head*hd]; mask is [Lq, Lk] or null.
__global__ void __launch_bounds__(kThreads)
mha_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, int Lq, int Lk, int hd, int n_head,
                 long long q_seq, long long q_row, long long k_seq, long long k_row,
                 long long v_seq, long long v_row, float scale) {
  extern __shared__ float smem[];
  const int kp = hd + 1;                       // padded K row
  float* ks = smem;                            // [Lk, hd+1]
  float* vs = ks + Lk * kp;                    // [Lk, hd]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = vs + Lk * hd + warp * (hd + Lk);  // this warp's scaled q row
  float* ps = qs + hd;                          // this warp's probabilities

  const int h = blockIdx.x, n = blockIdx.y;
  const float* kb = k + n * k_seq + h * hd;
  const float* vb = v + n * v_seq + h * hd;
  for (int i = threadIdx.x; i < Lk * hd; i += kThreads) {
    const int j = i / hd, d = i % hd;
    ks[j * kp + d] = kb[j * k_row + d];
    vs[j * hd + d] = vb[j * v_row + d];
  }
  __syncthreads();

  const int C = n_head * hd;
  for (int i = warp; i < Lq; i += kWarps) {
    const float* qr = q + n * q_seq + i * q_row + h * hd;
    for (int d = lane; d < hd; d += 32) qs[d] = qr[d] * scale;
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kr = ks + j * kp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[d], kr[d], s);
      if (mask) s += mask[i * Lk + j];
      ps[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(ps[j] - m);
      ps[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Lk; j += 32) ps[j] = ps[j] / sum;
    __syncwarp();

    float* orow = out + ((long long)n * Lq + i) * C + h * hd;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(ps[j], vs[j * hd + d], acc);
      orow[d] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

cudaError_t tris::mha_short(const float* q, const float* k, const float* v, const float* mask,
                            float* out, int N, int Lq, int Lk, int hd, int n_head,
                            int64_t q_seq, int64_t q_row, int64_t k_seq, int64_t k_row,
                            int64_t v_seq, int64_t v_row, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)Lk * (hd + 1) + (size_t)Lk * hd +
                                       (size_t)kWarps * (hd + Lk));
  const cudaError_t err = tris::allow_smem(mha_short_kernel, smem);
  if (err != cudaSuccess) return err;
  mha_short_kernel<<<dim3(n_head, N), kThreads, smem, stream>>>(
      q, k, v, mask, out, Lq, Lk, hd, n_head, q_seq, q_row, k_seq, k_row, v_seq,
      v_row, scale);
  return cudaGetLastError();
}
