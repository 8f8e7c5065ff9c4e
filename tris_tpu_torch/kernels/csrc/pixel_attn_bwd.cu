// K11 backward: PixelAttention's pixel-word attention, float32.
//
// The gradient of G = softmax(q Lk^T / d) Lv (tris_tpu/models/fusion.py::
// PixelAttention, lines 37-40), which the JAX package takes by autodiff.
// Per pair i of image n = i / S, with A = softmax(q Lk^T / d) [HW, T]:
//   dA  = dG Lv^T,   dL = A * (dA - rowsum(A * dA))   (the logits' gradient, times d)
//   dq[n]  = sum over the image's S pairs of dL Lk / d
//   dLk[i] = dL^T q[n] / d,   dLv[i] = A^T dG[i]
//
// Shapes on the stage-2 train path: B = 48 images, one sentence each, T = 20
// tokens; c2 HW = 1600 x Ci = 512, c3 400 x 1024, c4 100 x 2048.
//
// Bound: bytes (q and dG read, dq, dLk, dLv written; 6 T multiply-adds per
// element of q). Three kernels, none with atomics, so the gradient is the
// same run to run:
//  A - per (pair, tile of 16 pixels), a warp per pixel: the logits and dA
//      (Lk and Lv staged through shared memory in chunks of 128 channels,
//      lanes over channels), A recomputed (the forward saves nothing but its
//      inputs), the softmax backward; writes A and dL ([P, HW, T] scratch,
//      6 MB each at c2).
//  B - per (image, tile of 32 pixels), dq: four pixels a warp and four
//      channels a lane, the sum over the image's pairs and tokens in a fixed
//      order, each pair's Lk chunk staged once per block.
//  C - per (pair, tile of 64 channels), dLk and dLv: 256 threads as 64
//      channels x 4 pixel groups, each thread summing its group's pixels for
//      all T tokens in registers (coalesced reads of q and dG rows), then the
//      four groups added in a fixed order through shared memory. The sums
//      over up to 1600 pixels stay inside the block; at c4 (2048 channels)
//      that is 32 blocks a pair, 1536 at B = 48.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kMaxT = tris::kPixelAttnMaxT;
constexpr int kChunk = 128;

// ---- A: A and dL ---------------------------------------------------------------------

constexpr int kWarpsA = 16;

__global__ void __launch_bounds__(32 * kWarpsA)
probs_kernel(const float* __restrict__ dg, const float* __restrict__ q,
             const float* __restrict__ lk, const float* __restrict__ lv, float* __restrict__ a_out,
             float* __restrict__ dl_out, int HW, int T, int C, int S, float div) {
  __shared__ float ks[kMaxT * kChunk];
  __shared__ float vs[kMaxT * kChunk];
  const int pair = blockIdx.y, n = pair / S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * kWarpsA + warp;
  const bool live = p < HW;
  const float* qr = q + ((long long)n * HW + (live ? p : 0)) * C;
  const float* gr = dg + ((long long)pair * HW + (live ? p : 0)) * C;
  const float* kb = lk + (long long)pair * T * C;
  const float* vb = lv + (long long)pair * T * C;

  float s[kMaxT], da[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) s[t] = da[t] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cw = min(kChunk, C - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < T * kChunk; i += 32 * kWarpsA) {
      const int t = i / kChunk, c = i % kChunk;
      const bool in = c < cw;
      ks[i] = in ? kb[(long long)t * C + c0 + c] : 0.f;
      vs[i] = in ? vb[(long long)t * C + c0 + c] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int c = lane; c < cw; c += 32) {
      const float qc = qr[c0 + c], gc = gr[c0 + c];
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < T) {
          s[t] = fmaf(qc, ks[t * kChunk + c], s[t]);
          da[t] = fmaf(gc, vs[t * kChunk + c], da[t]);
        }
      }
    }
  }
  if (!live) return;   // no barrier below
  float mx = -INFINITY;
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t < T) {
      s[t] = tris::warp_sum(s[t]) / div;
      da[t] = tris::warp_sum(da[t]);
      mx = fmaxf(mx, s[t]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t < T) {
      s[t] = expf(s[t] - mx);
      sum += s[t];
    }
  }
  float dsum = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t < T) {
      s[t] = s[t] / sum;
      dsum = fmaf(s[t], da[t], dsum);
    }
  }
  if (lane == 0) {
    float* ao = a_out + ((long long)pair * HW + p) * T;
    float* dlo = dl_out + ((long long)pair * HW + p) * T;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < T) {
        ao[t] = s[t];
        dlo[t] = s[t] * (da[t] - dsum);
      }
    }
  }
}

// ---- B: dq -------------------------------------------------------------------------------

constexpr int kWarpsB = 8;
constexpr int kPixB = 4;                    // pixels a warp
constexpr int kTileB = kWarpsB * kPixB;     // 32 pixels a block
constexpr int kChB = 4;                     // channels a lane: 128 a chunk

// grid (ceil(HW / kTileB), N); dynamic smem: dL of the tile for every pair
// of the image [S][kTileB][T], then one pair's Lk chunk [T][kChunk]
__global__ void __launch_bounds__(32 * kWarpsB)
dq_kernel(const float* __restrict__ dl, const float* __restrict__ lk, float* __restrict__ dq,
          int HW, int T, int C, int S, float div) {
  extern __shared__ float smem[];
  float* dls = smem;                          // [S][kTileB][T]
  float* ks = dls + (size_t)S * kTileB * T;   // [T][kChunk]
  const int n = blockIdx.y, p0 = blockIdx.x * kTileB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < S * kTileB * T; i += 32 * kWarpsB) {
    const int j = i / (kTileB * T), r = i % (kTileB * T), pp = r / T, t = r % T;
    const int p = p0 + pp;
    dls[i] = p < HW ? dl[(((long long)n * S + j) * HW + p) * T + t] : 0.f;
  }
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cw = min(kChunk, C - c0);
    float acc[kPixB][kChB];
#pragma unroll
    for (int i = 0; i < kPixB; ++i)
#pragma unroll
      for (int k = 0; k < kChB; ++k) acc[i][k] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float* kb = lk + ((long long)n * S + j) * T * C;
      __syncthreads();
      for (int i = threadIdx.x; i < T * kChunk; i += 32 * kWarpsB) {
        const int t = i / kChunk, c = i % kChunk;
        ks[i] = c < cw ? kb[(long long)t * C + c0 + c] : 0.f;
      }
      __syncthreads();
      const float* dj = dls + (size_t)j * kTileB * T;
      for (int t = 0; t < T; ++t) {
        float kc[kChB];
#pragma unroll
        for (int k = 0; k < kChB; ++k) kc[k] = ks[t * kChunk + lane + 32 * k];
#pragma unroll
        for (int i = 0; i < kPixB; ++i) {
          const float d = dj[(warp * kPixB + i) * T + t];
#pragma unroll
          for (int k = 0; k < kChB; ++k) acc[i][k] = fmaf(d, kc[k], acc[i][k]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPixB; ++i) {
      const int p = p0 + warp * kPixB + i;
      if (p >= HW) continue;
      float* o = dq + ((long long)n * HW + p) * C + c0;
#pragma unroll
      for (int k = 0; k < kChB; ++k) {
        const int c = lane + 32 * k;
        if (c < cw) o[c] = acc[i][k] / div;
      }
    }
  }
}

// ---- C: dLk and dLv ----------------------------------------------------------------------

constexpr int kChC = 64;        // channels a block
constexpr int kGroups = 4;      // pixel groups
constexpr int kThreadsC = kChC * kGroups;
constexpr int kPixC = 32;       // pixels of A and dL staged at a time

// grid (ceil(C / kChC), P)
__global__ void __launch_bounds__(kThreadsC)
dkv_kernel(const float* __restrict__ dg, const float* __restrict__ q, const float* __restrict__ a,
           const float* __restrict__ dl, float* __restrict__ dlk, float* __restrict__ dlv, int HW,
           int T, int C, int S, float div) {
  __shared__ float as[kPixC * kMaxT];
  __shared__ float dls[kPixC * kMaxT];
  __shared__ float red[kGroups * kMaxT * kChC];
  const int pair = blockIdx.y, n = pair / S;
  const int cl = threadIdx.x % kChC, g = threadIdx.x / kChC;
  const int c = blockIdx.x * kChC + cl;
  const bool in = c < C;
  const float* qb = q + (long long)n * HW * C;
  const float* gb = dg + (long long)pair * HW * C;
  const float* ab = a + (long long)pair * HW * T;
  const float* db = dl + (long long)pair * HW * T;

  float ak[kMaxT], av[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) ak[t] = av[t] = 0.f;
  for (int p0 = 0; p0 < HW; p0 += kPixC) {
    const int np = min(kPixC, HW - p0);
    __syncthreads();
    for (int i = threadIdx.x; i < np * T; i += kThreadsC) {
      as[i] = ab[(long long)p0 * T + i];
      dls[i] = db[(long long)p0 * T + i];
    }
    __syncthreads();
    if (!in) continue;
    for (int pp = g; pp < np; pp += kGroups) {
      const long long row = (long long)(p0 + pp) * C + c;
      const float qv = qb[row], gv = gb[row];
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < T) {
          ak[t] = fmaf(dls[pp * T + t], qv, ak[t]);
          av[t] = fmaf(as[pp * T + t], gv, av[t]);
        }
      }
    }
  }
  // the four groups' partials added in order 0, 1, 2, 3: first dLk, then dLv
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kMaxT; ++t)
      if (t < T) red[(g * kMaxT + t) * kChC + cl] = which == 0 ? ak[t] : av[t];
    __syncthreads();
    if (!in) continue;
    float* out = (which == 0 ? dlk : dlv) + (long long)pair * T * C;
    for (int t = g; t < T; t += kGroups) {
      float v = red[t * kChC + cl];
      for (int gg = 1; gg < kGroups; ++gg) v += red[(gg * kMaxT + t) * kChC + cl];
      out[(long long)t * C + c] = which == 0 ? v / div : v;
    }
  }
}

}  // namespace

cudaError_t tris::pixel_attn_bwd(const float* dg, const float* q, const float* lk, const float* lv,
                                 float* a, float* dl, float* dq, float* dlk, float* dlv, int P,
                                 int HW, int T, int C, int S, float div, cudaStream_t stream) {
  if (P == 0 || HW == 0) return cudaSuccess;
  probs_kernel<<<dim3((HW + kWarpsA - 1) / kWarpsA, P), 32 * kWarpsA, 0, stream>>>(
      dg, q, lk, lv, a, dl, HW, T, C, S, div);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * ((size_t)S * kTileB * T + (size_t)T * kChunk);
  err = tris::allow_smem(dq_kernel, smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((HW + kTileB - 1) / kTileB, P / S), 32 * kWarpsB, smem, stream>>>(
      dl, lk, dq, HW, T, C, S, div);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3((C + kChC - 1) / kChC, P), kThreadsC, 0, stream>>>(dg, q, a, dl, dlk, dlv, HW,
                                                                       T, C, S, div);
  return cudaGetLastError();
}
