// K2 backward: the BilateralPrompt cross-attention, float32, one sentence
// per image (S = 1).
//
// The gradient of the two single-head attentions of
// tris_tpu/models/fusion.py::BilateralPrompt (lines 85-89), which the JAX
// package takes by autodiff. Per image n, with d = sqrt(Ci):
//   vision -> text:  Av = softmax_t(Qv Kt^T / d),  new_vis = Av Vt
//   text -> vision:  At = softmax_p(Qt Kv^T / d),  new_lan = At Vv
// and, from G = d new_vis, H = d new_lan:
//   dAv = G Vt^T,  dLv = Av * (dAv - rowsum(Av * dAv)) / d,
//   dQv = dLv Kt,  dKt = dLv^T Qv,  dVt = Av^T G;
//   dAt = H Vv^T,  dLt = At * (dAt - rowsum(At * dAt)) / d,
//   dQt = dLt Kv,  dKv = dLt^T Qt,  dVv = At^T H.
//
// Shapes on the stage-1 train path: N = 48 images, HW = 100 pixels, T = 48
// texts (every text of the batch), m = 1024; one call per step.
//
// Bound: bytes (each output float costs T or HW multiply-adds). As in the
// forward, a 1024-wide K/V row set does not fit a shared-memory tile, so the
// channels are streamed from device memory (L2) with lanes over channels.
// Four kernels, none with atomics, so the gradient is the same run to run:
//  A_vis, A_lan - per (image, tile of R queries): the logits and dA rows
//    (warps over keys, lanes over channels, R rows per pass so each key row
//    is read once per tile), the softmax and the softmax backward; they
//    write P and dL ([N, HW, T] and [N, T, HW], 0.9 MB each at the train
//    shape) to scratch. P is recomputed here, never saved by the forward.
//  B_vis - per (image, tile of R pixels): dQv, dKv, dVv, each a sum over
//    the T texts of the image done by one thread per channel in a fixed
//    order (the reduction over T stays inside the block).
//  B_lan - per (image, tile of R texts): dQt, dKt, dVt, sums over HW.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int R = 4;  // queries per block

// Rows q0..q0+R-1 of Q and G ([nq, m] planes of one image) against the nk
// key rows of K and V: P = softmax(Q K^T / d) and dL = P * (G V^T - D) / d,
// written as [nq, nk] rows of p_out and dl_out.
// smem: Q and G tiles [R][m] each, logits and dA [R][nk] each, 32 floats.
__device__ void attn_rows_bwd(const float* __restrict__ Q, const float* __restrict__ G,
                              const float* __restrict__ K, const float* __restrict__ V,
                              float* __restrict__ p_out, float* __restrict__ dl_out, int q0,
                              int nq, int nk, int m, float div, float* smem) {
  float* qs = smem;             // [R][m]
  float* gs = qs + R * m;       // [R][m]
  float* lg = gs + R * m;       // [R][nk]
  float* da = lg + R * nk;      // [R][nk]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < R * m; i += kThreads) {
    const int r = i / m, c = i % m, row = q0 + r;
    qs[i] = row < nq ? Q[(long long)row * m + c] : 0.f;
    gs[i] = row < nq ? G[(long long)row * m + c] : 0.f;
  }
  __syncthreads();
  for (int j = warp; j < nk; j += kWarps) {
    const float* kr = K + (long long)j * m;
    const float* vr = V + (long long)j * m;
    float s[R], a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = a[r] = 0.f;
    for (int c = lane; c < m; c += 32) {
      const float kc = kr[c], vc = vr[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(qs[r * m + c], kc, s[r]);
        a[r] = fmaf(gs[r * m + c], vc, a[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = tris::warp_sum(s[r]);
      a[r] = tris::warp_sum(a[r]);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lg[r * nk + j] = s[r] / div;
        da[r * nk + j] = a[r];
      }
    }
  }
  __syncthreads();
  // one warp per query row: softmax, then the softmax backward
  for (int r = warp; r < R; r += kWarps) {
    const int row = q0 + r;
    if (row >= nq) continue;
    float* l = lg + r * nk;
    const float* g = da + r * nk;
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, l[j]);
    mx = tris::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(l[j] - mx);
      l[j] = e;
      sum += e;
    }
    sum = tris::warp_sum(sum);
    float dsum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float p = l[j] / sum;
      l[j] = p;
      dsum = fmaf(p, g[j], dsum);
    }
    dsum = tris::warp_sum(dsum);
    float* po = p_out + (long long)row * nk;
    float* dlo = dl_out + (long long)row * nk;
    for (int j = lane; j < nk; j += 32) {
      po[j] = l[j];
      dlo[j] = l[j] * (g[j] - dsum) / div;
    }
  }
}

// grid (ceil(HW/R), N): P and dL of the vision -> text half.
__global__ void __launch_bounds__(kThreads)
a_vis_kernel(const float* __restrict__ qv, const float* __restrict__ g_vis,
             const float* __restrict__ kt, const float* __restrict__ vt, float* __restrict__ pv,
             float* __restrict__ dlv, int HW, int T, int m, float div) {
  extern __shared__ float smem[];
  const long long n = blockIdx.y;
  attn_rows_bwd(qv + n * HW * m, g_vis + n * HW * m, kt + n * T * m, vt + n * T * m,
                pv + n * HW * T, dlv + n * HW * T, blockIdx.x * R, HW, T, m, div, smem);
}

// grid (ceil(T/R), N): P and dL of the text -> vision half.
__global__ void __launch_bounds__(kThreads)
a_lan_kernel(const float* __restrict__ qt, const float* __restrict__ g_lan,
             const float* __restrict__ kv, const float* __restrict__ vv, float* __restrict__ pt,
             float* __restrict__ dlt, int HW, int T, int m, float div) {
  extern __shared__ float smem[];
  const long long n = blockIdx.y;
  attn_rows_bwd(qt + n * T * m, g_lan + n * T * m, kv + n * HW * m, vv + n * HW * m,
                pt + n * T * HW, dlt + n * T * HW, blockIdx.x * R, T, HW, m, div, smem);
}

// grid (ceil(HW/R), N): for pixels p of image n,
//   dQv[p] = sum_t dLv[p,t] Kt[t],  dKv[p] = sum_t dLt[t,p] Qt[t],  dVv[p] = sum_t At[t,p] H[t].
// smem: the three coefficient tiles [R][T].
__global__ void __launch_bounds__(kThreads)
b_vis_kernel(const float* __restrict__ kt, const float* __restrict__ qt,
             const float* __restrict__ g_lan, const float* __restrict__ dlv,
             const float* __restrict__ dlt, const float* __restrict__ pt,
             float* __restrict__ dqv, float* __restrict__ dkv, float* __restrict__ dvv, int HW,
             int T, int m) {
  extern __shared__ float smem[];
  float* cq = smem;          // dLv[p, t]
  float* ck = cq + R * T;    // dLt[t, p]
  float* cv = ck + R * T;    // At[t, p]
  const long long n = blockIdx.y;
  const int p0 = blockIdx.x * R;
  for (int i = threadIdx.x; i < R * T; i += kThreads) {
    const int r = i / T, t = i % T, p = p0 + r;
    const bool ok = p < HW;
    cq[i] = ok ? dlv[(n * HW + p) * T + t] : 0.f;
    ck[i] = ok ? dlt[(n * T + t) * HW + p] : 0.f;
    cv[i] = ok ? pt[(n * T + t) * HW + p] : 0.f;
  }
  __syncthreads();
  const float* ktn = kt + n * T * m;
  const float* qtn = qt + n * T * m;
  const float* gn = g_lan + n * T * m;
  for (int c = threadIdx.x; c < m; c += kThreads) {
    float aq[R], ak[R], av[R];
#pragma unroll
    for (int r = 0; r < R; ++r) aq[r] = ak[r] = av[r] = 0.f;
    for (int t = 0; t < T; ++t) {
      const float kc = ktn[(long long)t * m + c], qc = qtn[(long long)t * m + c],
                  gc = gn[(long long)t * m + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        aq[r] = fmaf(cq[r * T + t], kc, aq[r]);
        ak[r] = fmaf(ck[r * T + t], qc, ak[r]);
        av[r] = fmaf(cv[r * T + t], gc, av[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r;
      if (p >= HW) break;
      const long long o = (n * HW + p) * m + c;
      dqv[o] = aq[r];
      dkv[o] = ak[r];
      dvv[o] = av[r];
    }
  }
}

// grid (ceil(T/R), N): for texts t of image n,
//   dKt[t] = sum_p dLv[p,t] Qv[p],  dVt[t] = sum_p Av[p,t] G[p],  dQt[t] = sum_p dLt[t,p] Kv[p].
// smem: the three coefficient tiles [R][HW].
__global__ void __launch_bounds__(kThreads)
b_lan_kernel(const float* __restrict__ qv, const float* __restrict__ g_vis,
             const float* __restrict__ kv, const float* __restrict__ dlv,
             const float* __restrict__ pv, const float* __restrict__ dlt,
             float* __restrict__ dqt, float* __restrict__ dkt, float* __restrict__ dvt, int HW,
             int T, int m) {
  extern __shared__ float smem[];
  float* ck = smem;          // dLv[p, t]
  float* cv = ck + R * HW;   // Av[p, t]
  float* cq = cv + R * HW;   // dLt[t, p]
  const long long n = blockIdx.y;
  const int t0 = blockIdx.x * R;
  for (int i = threadIdx.x; i < R * HW; i += kThreads) {
    const int r = i / HW, p = i % HW, t = t0 + r;
    const bool ok = t < T;
    ck[i] = ok ? dlv[(n * HW + p) * T + t] : 0.f;
    cv[i] = ok ? pv[(n * HW + p) * T + t] : 0.f;
    cq[i] = ok ? dlt[(n * T + t) * HW + p] : 0.f;
  }
  __syncthreads();
  const float* qvn = qv + n * HW * m;
  const float* gn = g_vis + n * HW * m;
  const float* kvn = kv + n * HW * m;
  for (int c = threadIdx.x; c < m; c += kThreads) {
    float ak[R], av[R], aq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ak[r] = av[r] = aq[r] = 0.f;
    for (int p = 0; p < HW; ++p) {
      const float qc = qvn[(long long)p * m + c], gc = gn[(long long)p * m + c],
                  kc = kvn[(long long)p * m + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ak[r] = fmaf(ck[r * HW + p], qc, ak[r]);
        av[r] = fmaf(cv[r * HW + p], gc, av[r]);
        aq[r] = fmaf(cq[r * HW + p], kc, aq[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r;
      if (t >= T) break;
      const long long o = (n * T + t) * m + c;
      dkt[o] = ak[r];
      dvt[o] = av[r];
      dqt[o] = aq[r];
    }
  }
}

}  // namespace

cudaError_t tris::cross_attn_bwd(const float* g_vis, const float* g_lan, const float* qv,
                                 const float* kv, const float* vv, const float* qt,
                                 const float* kt, const float* vt, float* pv, float* dlv,
                                 float* pt, float* dlt, float* dqv, float* dkv, float* dvv,
                                 float* dqt, float* dkt, float* dvt, int N, int HW, int T, int m,
                                 float div, cudaStream_t stream) {
  const size_t smem_av = sizeof(float) * (2 * (size_t)R * m + 2 * (size_t)R * T);
  const size_t smem_al = sizeof(float) * (2 * (size_t)R * m + 2 * (size_t)R * HW);
  const size_t smem_bv = sizeof(float) * 3 * (size_t)R * T;
  const size_t smem_bl = sizeof(float) * 3 * (size_t)R * HW;
  cudaError_t err;
  if ((err = tris::allow_smem(a_vis_kernel, smem_av)) != cudaSuccess) return err;
  if ((err = tris::allow_smem(a_lan_kernel, smem_al)) != cudaSuccess) return err;
  if ((err = tris::allow_smem(b_vis_kernel, smem_bv)) != cudaSuccess) return err;
  if ((err = tris::allow_smem(b_lan_kernel, smem_bl)) != cudaSuccess) return err;
  const dim3 grid_p((HW + R - 1) / R, N), grid_t((T + R - 1) / R, N);
  a_vis_kernel<<<grid_p, kThreads, smem_av, stream>>>(qv, g_vis, kt, vt, pv, dlv, HW, T, m, div);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  a_lan_kernel<<<grid_t, kThreads, smem_al, stream>>>(qt, g_lan, kv, vv, pt, dlt, HW, T, m, div);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  b_vis_kernel<<<grid_p, kThreads, smem_bv, stream>>>(kt, qt, g_lan, dlv, dlt, pt, dqv, dkv, dvv,
                                                      HW, T, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  b_lan_kernel<<<grid_t, kThreads, smem_bl, stream>>>(qv, g_vis, kv, dlv, pv, dlt, dqt, dkt, dvt,
                                                      HW, T, m);
  return cudaGetLastError();
}
