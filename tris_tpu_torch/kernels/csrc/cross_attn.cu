// K2: the BilateralPrompt cross-attention, forward, float32.
//
// Replaces the two single-head attentions of the JAX package's
// tris_tpu/models/fusion.py::BilateralPrompt (lines 78-89), channel width m,
// logits divided by sqrt(Ci) (Ci = the language width, fusion.py:85-86):
//   vision -> text:  new_vis[pair, p] = softmax_t(Qv[b, p] . Kt[pair, t] / d) . Vt[pair]
//   text -> vision:  new_lan[pair, t] = softmax_p(Qt[pair, t] . Kv[b, p] / d) . Vv[b]
// with b = pair / S: the vision projections exist once per image and every
// one of its S sentences (pairs) reads them in place, so the JAX package's
// jnp.repeat over sentences (stage1.py:164-166) is never materialised.
//
// Shapes on the stage-1 eval path: m = 1024, HW = 100 pixels (320 px), T = 1
// text token per pair in response_maps (T = B in forward(train=False)); two
// launches per forward. At T = 1 the vision->text softmax is over one key,
// exp(0)/1 = 1 exactly, so new_vis is exactly Vt.
//
// Bound: bytes (each output float costs T (or HW) multiply-adds, a few per
// byte). A 1024-wide head does not fit in shared memory at HW = 100 keys
// (K and V are 400 KB each), so neither kernel tiles K/V: one block per
// (pair, query) computes its logits with warps over keys and lanes over
// channels, keeps the softmax in shared memory, then forms sum_k p_k V_k with
// threads over channels (coalesced rows of V, which the other queries of the
// same image find in L2).

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// grid (HW, P): one block per (pair, vision query p); smem: T logits.
__global__ void __launch_bounds__(kThreads)
vis_to_text_kernel(const float* __restrict__ qv, const float* __restrict__ kt,
                   const float* __restrict__ vt, float* __restrict__ out, int HW,
                   int T, int m, int S, float div) {
  extern __shared__ float probs[];
  const int p = blockIdx.x, pair = blockIdx.y, b = pair / S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* q = qv + ((long long)b * HW + p) * m;
  const float* kb = kt + (long long)pair * T * m;
  const float* vb = vt + (long long)pair * T * m;

  for (int t = warp; t < T; t += kWarps) {
    float s = 0.f;
    for (int c = lane; c < m; c += 32) s = fmaf(q[c], kb[(long long)t * m + c], s);
    s = tris::warp_sum(s);
    if (lane == 0) probs[t] = s / div;
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, probs[t]);
    mx = tris::warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(probs[t] - mx);
      probs[t] = e;
      sum += e;
    }
    sum = tris::warp_sum(sum);
    for (int t = lane; t < T; t += 32) probs[t] = probs[t] / sum;
  }
  __syncthreads();

  float* o = out + ((long long)pair * HW + p) * m;
  for (int c = threadIdx.x; c < m; c += kThreads) {
    float acc = 0.f;
    for (int t = 0; t < T; ++t) acc = fmaf(probs[t], vb[(long long)t * m + c], acc);
    o[c] = acc;
  }
}

// grid (T, P): one block per (pair, text query t); smem: the query row (m)
// and HW logits, plus 32 floats for reductions.
__global__ void __launch_bounds__(kThreads)
text_to_vis_kernel(const float* __restrict__ qt, const float* __restrict__ kv,
                   const float* __restrict__ vv, float* __restrict__ out, int HW,
                   int T, int m, int S, float div) {
  extern __shared__ float smem[];
  float* qs = smem;             // [m]
  float* probs = qs + m;        // [HW]
  float* red = probs + HW;      // [32]
  const int t = blockIdx.x, pair = blockIdx.y, b = pair / S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* q = qt + ((long long)pair * T + t) * m;
  const float* kb = kv + (long long)b * HW * m;
  const float* vb = vv + (long long)b * HW * m;

  for (int c = threadIdx.x; c < m; c += kThreads) qs[c] = q[c];
  __syncthreads();
  for (int p = warp; p < HW; p += kWarps) {
    float s = 0.f;
    for (int c = lane; c < m; c += 32) s = fmaf(qs[c], kb[(long long)p * m + c], s);
    s = tris::warp_sum(s);
    if (lane == 0) probs[p] = s / div;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int p = threadIdx.x; p < HW; p += kThreads) mx = fmaxf(mx, probs[p]);
  mx = tris::block_max(mx, red);
  float sum = 0.f;
  for (int p = threadIdx.x; p < HW; p += kThreads) {
    const float e = expf(probs[p] - mx);
    probs[p] = e;
    sum += e;
  }
  sum = tris::block_sum(sum, red);   // its barriers also publish the e's
  for (int p = threadIdx.x; p < HW; p += kThreads) probs[p] = probs[p] / sum;
  __syncthreads();

  float* o = out + ((long long)pair * T + t) * m;
  for (int c = threadIdx.x; c < m; c += kThreads) {
    float acc = 0.f;
    for (int p = 0; p < HW; ++p) acc = fmaf(probs[p], vb[(long long)p * m + c], acc);
    o[c] = acc;
  }
}

}  // namespace

cudaError_t tris::cross_attn(const float* qv, const float* kv, const float* vv, const float* qt,
                             const float* kt, const float* vt, float* new_vis, float* new_lan,
                             int P, int HW, int T, int m, int S, float div, cudaStream_t stream) {
  const size_t smem_a = sizeof(float) * (size_t)T;
  const size_t smem_b = sizeof(float) * ((size_t)m + HW + 32);
  cudaError_t err = tris::allow_smem(vis_to_text_kernel, smem_a);
  if (err != cudaSuccess) return err;
  err = tris::allow_smem(text_to_vis_kernel, smem_b);
  if (err != cudaSuccess) return err;
  vis_to_text_kernel<<<dim3(HW, P), kThreads, smem_a, stream>>>(qv, kt, vt, new_vis, HW, T, m, S, div);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  text_to_vis_kernel<<<dim3(T, P), kThreads, smem_b, stream>>>(qt, kv, vv, new_lan, HW, T, m, S, div);
  return cudaGetLastError();
}
