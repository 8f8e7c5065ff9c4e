// K1 backward: short-sequence multi-head attention, float32.
//
// The gradient of tris_tpu/models/layers.py::multi_head_attention (lines
// 25-48), which the JAX package takes by autodiff of its XLA program: with
// P = softmax((q * s) . k^T + mask) per (sequence, head), s = hd^-1/2,
//   dP = dO . V^T,  D_i = sum_j P_ij dP_ij,  dS = P * (dP - D),
//   dq = s * dS . K,  dk = dS^T . (q * s),  dv = P^T . dO.
// D_i uses P and dP, so the forward's output is not needed.
//
// Shapes on the stage-1 train path: the stage-1 text tower (N = 48, L = 20
// causal, 8 heads) and the frozen ViT-B/32 critic's vision tower (N = 48,
// L = 50, 12 heads), hd = 64; 24 launches per step. The critic's text tower
// runs without autograd and never reaches this kernel.
//
// Bound: bytes - q, k, v, dO read once and dq, dk, dv written once; about
// 10 * L flops per float moved, below the card's flop:byte ratio at L <= 128.
// Design: one block per (sequence, head), as the forward. K and V live in
// shared memory (rows padded to hd+1 floats so lanes over keys hit distinct
// banks). P is recomputed from q and k, never saved by the forward: each warp
// takes query rows in turn, forms its logits and softmax exactly as the
// forward kernel does, then dP, D and dS, keeping P and dS in shared memory
// ([Lq, Lk+1] each), and writes its dq row. After a barrier each warp takes
// key rows and forms dk and dv with lanes over channels, reading q and dO
// rows from device memory (L2) coalesced. A -inf mask entry gives P = 0 and
// dS = 0 exactly. Every output element is summed by one thread in a fixed
// order: the result does not change from run to run.

#include "common.cuh"
#include "launchers.h"

namespace {

using tris::warp_max;
using tris::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
mha_short_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk, int hd,
                     int n_head, long long q_seq, long long q_row, long long k_seq,
                     long long k_row, long long v_seq, long long v_row, float scale) {
  extern __shared__ float smem[];
  const int kp = hd + 1, pp = Lk + 1;
  float* ks = smem;                 // [Lk, hd+1]
  float* vs = ks + Lk * kp;         // [Lk, hd+1]
  float* ps = vs + Lk * kp;         // [Lq, Lk+1] probabilities
  float* dss = ps + Lq * pp;        // [Lq, Lk+1] gradient of the logits
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = dss + Lq * pp + warp * 2 * hd;  // this warp's scaled q row
  float* gs = qs + hd;                        // this warp's dO row

  const int h = blockIdx.x, n = blockIdx.y, C = n_head * hd;
  const float* kb = k + n * k_seq + h * hd;
  const float* vb = v + n * v_seq + h * hd;
  for (int i = threadIdx.x; i < Lk * hd; i += kThreads) {
    const int j = i / hd, d = i % hd;
    ks[j * kp + d] = kb[j * k_row + d];
    vs[j * kp + d] = vb[j * v_row + d];
  }
  __syncthreads();

  for (int i = warp; i < Lq; i += kWarps) {
    const float* qr = q + n * q_seq + i * q_row + h * hd;
    const float* gr = dout + ((long long)n * Lq + i) * C + h * hd;
    for (int d = lane; d < hd; d += 32) {
      qs[d] = qr[d] * scale;
      gs[d] = gr[d];
    }
    __syncwarp();
    float* prow = ps + i * pp;
    float* drow = dss + i * pp;

    // P, as the forward computes it
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kr = ks + j * kp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[d], kr[d], s);
      if (mask) s += mask[i * Lk + j];
      prow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);

    // dP, D, dS
    float dsum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float p = prow[j] / sum;
      const float* vr = vs + j * kp;
      float dp = 0.f;
      for (int d = 0; d < hd; ++d) dp = fmaf(gs[d], vr[d], dp);
      prow[j] = p;
      drow[j] = dp;
      dsum = fmaf(p, dp, dsum);
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < Lk; j += 32) drow[j] = prow[j] * (drow[j] - dsum);
    __syncwarp();

    float* dqr = dq + ((long long)n * Lq + i) * C + h * hd;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(drow[j], ks[j * kp + d], acc);
      dqr[d] = acc * scale;
    }
    __syncwarp();
  }
  __syncthreads();

  const float* qb = q + n * q_seq + h * hd;
  const float* gb = dout + (long long)n * Lq * C + h * hd;
  for (int j = warp; j < Lk; j += kWarps) {
    float* dkr = dk + ((long long)n * Lk + j) * C + h * hd;
    float* dvr = dv + ((long long)n * Lk + j) * C + h * hd;
    for (int d = lane; d < hd; d += 32) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < Lq; ++i) {
        ak = fmaf(dss[i * pp + j], qb[i * q_row + d] * scale, ak);
        av = fmaf(ps[i * pp + j], gb[(long long)i * C + d], av);
      }
      dkr[d] = ak;
      dvr[d] = av;
    }
  }
}

}  // namespace

cudaError_t tris::mha_short_bwd(const float* dout, const float* q, const float* k, const float* v,
                                const float* mask, float* dq, float* dk, float* dv, int N, int Lq,
                                int Lk, int hd, int n_head, int64_t q_seq, int64_t q_row,
                                int64_t k_seq, int64_t k_row, int64_t v_seq, int64_t v_row,
                                float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)Lk * (hd + 1) + 2 * (size_t)Lq * (Lk + 1) +
                                       (size_t)kWarps * 2 * hd);
  const cudaError_t err = tris::allow_smem(mha_short_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  mha_short_bwd_kernel<<<dim3(n_head, N), kThreads, smem, stream>>>(
      dout, q, k, v, mask, dq, dk, dv, Lq, Lk, hd, n_head, q_seq, q_row, k_seq, k_row, v_seq,
      v_row, scale);
  return cudaGetLastError();
}
