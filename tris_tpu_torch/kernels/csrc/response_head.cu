// K3: the stage-1 response head, forward, float32.
//
// Replaces tris_tpu/models/stage1.py::TRISStage1.response_maps lines 168-179
// (and the eval branch of __call__, lines 97-113): per (image, sentence)
// pair, the fusion residual vis_p = new_vis * alpha + norm_vis[b] (b = pair /
// S), the score exp(logit_scale) * <vis_p, lan_p> over D channels at each of
// the h*w pixels, an align_corners=False bilinear upsample h*w -> H*W, relu.
//
// Shapes on the stage-1 eval path: D = 1024, h = w = 10, H = W = 320, 32
// pairs (8 images x 4 sentences); the train forward's eval branch takes S = 1.
// One launch per forward.
//
// Bound: bytes - the [pairs, h*w, D] fused plane read once and the
// [pairs, H, W] maps written once; a handful of flops per byte. One block a
// pair (the first design) put 32 blocks on 132 SMs, each forming 102,400
// outputs with an integer division and eight tap loads from device memory
// apiece. Design (launchers.h, response_head_plan): a cluster of R blocks a
// pair, grid (R, pairs). Rank r forms the scores of its share of the pixels,
// a warp a pixel, lanes over channels, the residual fused (vis_p never
// reaches device memory), the chain of each lane and the warp's sum as
// before, so the scores keep their bits; after a cluster barrier each rank
// copies the others' scores out of their shared memory (distributed shared
// memory), then writes its band of output rows: each row's interpolated
// score row t = wy0 s[y0] + wy1 s[y1] (w floats) formed once in shared
// memory, then its columns out = wx0 t[x0] + wx1 t[x1], relu'd, `vec` a
// thread from x taps held in registers, in 16-byte stores: each product and
// sum rounded alone as tris::sample2 does, so the maps keep their bits too.
// A cluster barrier after the last read of another rank's scores keeps every
// rank's shared memory alive until its readers are done.
//
// --bf16: the same kernel reads bfloat16 norm_vis and lan_p, two channels a lane a load,
// and vis_new in float32 (kMixed: the fusion on float32 leaves, whose residual and dot are
// float32) or in bfloat16 (kBf16: the residual's product and sum rounded to bfloat16, and the
// dot rounded to bfloat16 before the float32 scale, as the JAX einsum of two bfloat16
// operands rounds); the upsample as above, in float32.

#include <cooperative_groups.h>

#include "common.cuh"
#include "launchers.h"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = tris::kResponseHeadThreads;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the operands' dtypes: all float32; vis_new float32 with bfloat16 vis_base and lan; all
// bfloat16 (vis_new may be null)
enum In { kF32, kMixed, kBf16 };

// Grid (R, pairs) in clusters of R along x; kVec columns a thread; kIn the operands' dtypes.
template <int kVec, int kIn>
__global__ void __launch_bounds__(kThreads)
response_head_kernel(const void* __restrict__ vis_new_p, const void* __restrict__ vis_base_p,
                     const void* __restrict__ lan_p, float* __restrict__ out, int S, int h,
                     int w, int D, int H, int W, float alpha,
                     const float* __restrict__ scale_ptr,
                     const int* __restrict__ ylo, const int* __restrict__ yhi,
                     const float* __restrict__ wy0, const float* __restrict__ wy1,
                     const int* __restrict__ xlo, const int* __restrict__ xhi,
                     const float* __restrict__ wx0, const float* __restrict__ wx1) {
  // [hw] the score plane (rounded to 16 bytes), then [rows][w] the band's t-rows
  extern __shared__ __align__(16) float smem[];
  const int hw = h * w;
  float* score = smem;
  float* t = smem + (hw + 3) / 4 * 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int pair = blockIdx.y, b = pair / S, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // 1. the scores of this rank's pixels [p0, p1)
  const float scale = *scale_ptr;
  for (int p = rank * hw / R + warp; p < (rank + 1) * hw / R; p += kWarps) {
    const long long base = ((long long)b * hw + p) * D, fresh = ((long long)pair * hw + p) * D;
    float s = 0.f;
    if constexpr (kIn == kF32) {
      const float* l = static_cast<const float*>(lan_p) + (long long)pair * D;
      const float* vb = static_cast<const float*>(vis_base_p) + base;
      const float* vn = vis_new_p ? static_cast<const float*>(vis_new_p) + fresh : nullptr;
      for (int c = lane; c < D; c += 32) {
        const float v = vn ? __fadd_rn(__fmul_rn(vn[c], alpha), vb[c]) : vb[c];
        s = fmaf(v, l[c], s);
      }
    } else {
      using Pair = __nv_bfloat162;
      const Pair* l = static_cast<const Pair*>(lan_p) + (long long)pair * D / 2;
      const Pair* vb = static_cast<const Pair*>(vis_base_p) + base / 2;
      for (int c = lane; c < D / 2; c += 32) {
        float2 v = __bfloat1622float2(vb[c]);
        if (vis_new_p != nullptr) {
          if constexpr (kIn == kMixed) {
            const float2 n = static_cast<const float2*>(vis_new_p)[fresh / 2 + c];
            v = make_float2(__fadd_rn(__fmul_rn(n.x, alpha), v.x),
                            __fadd_rn(__fmul_rn(n.y, alpha), v.y));
          } else {
            const float2 n = __bfloat1622float2(static_cast<const Pair*>(vis_new_p)[fresh / 2 + c]);
            v = make_float2(tris::round_bf16(__fadd_rn(tris::round_bf16(__fmul_rn(n.x, alpha)), v.x)),
                            tris::round_bf16(__fadd_rn(tris::round_bf16(__fmul_rn(n.y, alpha)), v.y)));
          }
        }
        const float2 lc = __bfloat1622float2(l[c]);
        s = fmaf(v.y, lc.y, fmaf(v.x, lc.x, s));
      }
    }
    s = tris::warp_sum(s);
    if (lane == 0) score[p] = scale * (kIn == kBf16 ? tris::round_bf16(s) : s);
  }

  // 2. every rank's scores into this rank's plane
  cluster.sync();
  for (int q = 0; q < R; ++q) {
    if (q == rank) continue;
    const float* src = cluster.map_shared_rank(score, q);
    for (int i = q * hw / R + tid; i < (q + 1) * hw / R; i += kThreads) score[i] = src[i];
  }
  cluster_arrive();  // this rank reads the others' scores no more
  __syncthreads();

  // 3. the t-rows of this rank's output rows [y0, y0 + rows): element e is row e / w, column
  // e % w, walked without a division
  const int y0 = rank * H / R, rows = (rank + 1) * H / R - y0;
  {
    const int n = rows * w, step_r = kThreads / w, step_j = kThreads - step_r * w;
    int r = tid / w, j = tid - r * w;
    for (int e = tid; e < n; e += kThreads) {
      const int y = y0 + r;
      t[e] = __fadd_rn(__fmul_rn(wy0[y], score[ylo[y] * w + j]),
                       __fmul_rn(wy1[y], score[yhi[y] * w + j]));
      j += step_j;
      r += step_r;
      if (j >= w) {
        j -= w;
        ++r;
      }
    }
  }
  __syncthreads();

  // 4. the rows' outputs: a thread owns kVec columns of group q (its x taps in registers) and
  // every rpar-th row of the band from r0
  const int groups = (W + kVec - 1) / kVec;
  const int tg = groups < kThreads ? groups : kThreads, rpar = kThreads / tg;
  const int r0 = tid / tg;
  for (int q = tid - r0 * tg; r0 < rpar && q < groups; q += tg) {
    const int c = q * kVec;
    int lo[kVec], hi[kVec];
    float a[kVec], bw[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const bool in = c + k < W;
      lo[k] = in ? xlo[c + k] : 0;
      hi[k] = in ? xhi[c + k] : 0;
      a[k] = in ? wx0[c + k] : 0.f;
      bw[k] = in ? wx1[c + k] : 0.f;
    }
    for (int r = r0; r < rows; r += rpar) {
      const float* tr = t + r * w;
      float v[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        v[k] = fmaxf(__fadd_rn(__fmul_rn(a[k], tr[lo[k]]), __fmul_rn(bw[k], tr[hi[k]])), 0.f);
      float* o = out + ((long long)pair * H + y0 + r) * W + c;
      if constexpr (kVec == 4)
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      else
        o[0] = v[0];
    }
  }
  cluster_wait();  // no rank leaves while another may still read its scores
}

}  // namespace

namespace {

cudaError_t launch_head(int in, const void* vis_new, const void* vis_base, const void* lan,
                        float* out, int P, int S, int h, int w, int D, int H, int W, float alpha,
                        const float* scale, const int* ylo, const int* yhi, const float* wy0,
                        const float* wy1, const int* xlo, const int* xhi, const float* wx0,
                        const float* wx1, cudaStream_t stream,
                        tris::ResponseHeadLaunchShape* shape) {
  if (P == 0) return cudaSuccess;
  const tris::ResponseHeadPlan p = tris::response_head_plan(P, S, h, w, D, H, W);
  using Kernel = decltype(&response_head_kernel<1, kF32>);
  const Kernel kernels[2][3] = {
      {&response_head_kernel<1, kF32>, &response_head_kernel<1, kMixed>,
       &response_head_kernel<1, kBf16>},
      {&response_head_kernel<4, kF32>, &response_head_kernel<4, kMixed>,
       &response_head_kernel<4, kBf16>}};
  const Kernel kernel = kernels[p.vec == 4][in];
  cudaError_t err = tris::allow_smem(kernel, (size_t)p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ranks, P);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, vis_new, vis_base, lan, out, S, h, w, D, H, W, alpha,
                           scale, ylo, yhi, wy0, wy1, xlo, xhi, wx0, wx1);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {p.blocks, p.ranks, p.threads, p.vec, p.smem};
  return err;
}

}  // namespace

cudaError_t tris::response_head(const float* vis_new, const float* vis_base, const float* lan,
                                float* out, int P, int S, int h, int w, int D, int H, int W,
                                float alpha, const float* scale, const int* ylo, const int* yhi,
                                const float* wy0, const float* wy1, const int* xlo,
                                const int* xhi, const float* wx0, const float* wx1,
                                cudaStream_t stream, ResponseHeadLaunchShape* shape) {
  return launch_head(kF32, vis_new, vis_base, lan, out, P, S, h, w, D, H, W, alpha, scale, ylo,
                     yhi, wy0, wy1, xlo, xhi, wx0, wx1, stream, shape);
}

cudaError_t tris::response_head_bf16(const void* vis_new, bool new_f32, const Bf16Bits* vis_base,
                                     const Bf16Bits* lan, float* out, int P, int S, int h, int w,
                                     int D, int H, int W, float alpha, const float* scale,
                                     const int* ylo, const int* yhi, const float* wy0,
                                     const float* wy1, const int* xlo, const int* xhi,
                                     const float* wx0, const float* wx1, cudaStream_t stream,
                                     ResponseHeadLaunchShape* shape) {
  if (D % 2) return cudaErrorInvalidValue;
  return launch_head(new_f32 && vis_new != nullptr ? kMixed : kBf16, vis_new, vis_base, lan, out,
                     P, S, h, w, D, H, W, alpha, scale, ylo, yhi, wy0, wy1, xlo, xhi, wx0, wx1,
                     stream, shape);
}
