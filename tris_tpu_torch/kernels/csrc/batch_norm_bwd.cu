// K13 backward: BatchNorm with the activation that follows it, in the design
// launchers.h::batch_norm_plan chooses by the shape: fused (one launch; with PReLU a second
// adds the channels' slope sums) where a channel's g and x fit on chip, else two-pass (three
// launches).
//
// Replaces the gradient of tris_tpu/models/layers.py:181 TorchBatchNorm's train path
// (:219-229) and of the ReLU, residual add + ReLU or PReLU after it (see batch_norm.cu).
// With g = dL/dout, x-hat = (x - mean) * rstd, dz = dL/dy (y = x-hat * w + b) and n = M =
// N * HW per channel:
//   dz     = g * act'                   (ReLU: out > 0; PReLU: 1 where y >= 0, else a)
//   dw     = sum(dz * x-hat),  db = sum(dz),  da = sum(g * y over y < 0)   (PReLU's slope)
//   dx     = (w * rstd) * ((dz - db / n) - x-hat * (dw / n))   (batch statistics)
//   dx     = dz * w                                            (the eval fold: w is a)
//   dres   = dz                                                (the residual's gradient)
// The forward keeps x, mean and rstd, and its output where the activation is ReLU: out > 0
// is the ReLU's mask exactly. PReLU's pre-activation is recomputed from x with the
// forward's operations, so its mask is the forward's bit for bit. dw, db and the two
// coefficients db / n, dw / n are each rounded once from their double sums; dx takes each
// product and sum rounded alone. No atomics: the same bits run to run.
//
// batch_norm_bwd_fused_kernel: the forward's fused blocks (a cluster of R a channel, rank r
// staging samples [r N / R, (r + 1) N / R)), here g's and x's planes, both on a sample's
// mbarrier. A sample's group of lanes, once its planes have landed, forms dz (ReLU's mask
// from `out`, read beside, kUnroll float4s in flight a lane), writes it over g's plane, sums
// dz, dz * x-hat and the slope's terms in double (lane l its items l, l + group, ..., the
// elements in order, then the group's xor tree and its warps' totals in warp order). Each
// rank writes its samples' sums into every rank's shared memory; after the cluster's
// barrier every rank adds the N in batch order alike, rank 0 writes dw, db and the channel's
// slope sum, and each rank writes dx (and dres) from its staged dz and x. g, x and out are
// read from device memory once. batch_norm_bwd_slope_kernel (PReLU): one warp adds the
// channels' slope sums, lane l those from l in steps of 32, then the xor tree.
//
// The two-pass design: batch_norm_bwd_partial_kernel, a warp per (channel, sample, slice of
// the plane), the statistics' partition (launchers.h), sums dz, dz * x-hat and the slope's
// terms in double, the lanes in a fixed xor tree. batch_norm_bwd_final_kernel: a warp per
// channel adds its N * slices partials (lane l those from l in steps of 32, then the xor
// tree). batch_norm_bwd_apply_kernel: a thread per 4 elements (float4; per element where HW %
// 4 != 0 or a pointer is not 16-byte aligned) writes dx and dres; for PReLU its first warp
// also adds the channels' slope sums into dslope.
//
// --bf16 training (batch_norm_bwd_bf16): the two-pass design on bfloat16 g, x and out at every
// shape, three launches: the partial kernel instantiated on bfloat16, the final kernel, and
// batch_norm_bwd_apply_bf16_kernel (8 values a thread): dx formed in float32 as the float32
// apply forms it and rounded to bfloat16 once; dres the masked g (bfloat16 exactly); dweight
// and dbias float32. ReLU or nothing (no PReLU: stage 2's, not in bfloat16 yet).
//
// Bound: bytes. The fused kernel reads g and x (and out) once and writes dx (and dres); the
// two-pass design reads them twice.

#include "batch_norm.cuh"

namespace {

using namespace tris;
using namespace tris::bn;

// Grid C * R blocks in clusters of R: block b is rank b % R of channel b / R. slope_sums [C]
// with PReLU, else null.
template <bool kVec, int kUnroll>
__global__ void __launch_bounds__(kBatchNormFusedThreadsWide)
batch_norm_bwd_fused_kernel(const float* __restrict__ g, const float* __restrict__ x,
                            const float* __restrict__ out, const float* __restrict__ mean,
                            const float* __restrict__ rstd, const float* __restrict__ w,
                            const float* __restrict__ b, const float* __restrict__ slope,
                            float* __restrict__ dw, float* __restrict__ db,
                            double* __restrict__ slope_sums, float* __restrict__ dx,
                            float* __restrict__ dres, int N, int C, int HW, int samples,
                            int group, int act) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BN_STAMP_ENTRY();
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int c = blockIdx.x / R;
  const int first = rank_first(rank, R, N), count = rank_first(rank + 1, R, N) - first;
  const FusedSmem s = fused_smem(smem_raw, N, HW, samples, true);
  const long long pitch = batch_norm_pitch(HW), nstride = (long long)C * HW;
  float* dzs = s.stage;  // g's planes, then dz in their place
  const float* xs = s.stage + s.set;
  const float* planes[2] = {g + (long long)c * HW, x + (long long)c * HW};
  if (kVec) {
    issue_planes(planes, 2, s.stage, s.set, s.bars, first, count, nstride, HW);
    __syncthreads();
  } else {
    load_planes(planes, 2, s.stage, s.set, first, count, nstride, HW);
  }
  BN_PHASE(2);
  cluster_arrive_relaxed();  // this block has started: the others may write its sums

  // the channel's parameters, read while its planes land
  const Channel p = channel(mean, rstd, w, b, c);
  const float a = slope != nullptr ? *slope : 0.f;
  const int groups = blockDim.x / group, gi = threadIdx.x / group, gl = threadIdx.x % group;
  const int items = kVec ? HW / 4 : HW, rounds = (count + groups - 1) / groups;
  constexpr int U = kUnroll;
  cluster_wait();
  for (int r = 0; r < rounds; ++r) {  // the same rounds on every thread: group_sums is collective
    const int i = gi + r * groups;
    double v[3] = {0.0, 0.0, 0.0};  // dz, dz * x-hat, the slope's g * y
    if (i < count) {
      float* dzp = dzs + i * pitch;
      const float* xp = xs + i * pitch;
      const float* op = out != nullptr ? out + (first + i) * nstride + (long long)c * HW : nullptr;
      if (kVec) mbar_wait(&s.bars[i], 0);
      for (int e0 = gl; e0 < items; e0 += U * group) {
        if (kVec) {
          float4 o[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * group;
            o[u] = op != nullptr && e < items ? reinterpret_cast<const float4*>(op)[e]
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * group;
            if (e >= items) break;
            const float4 gv = reinterpret_cast<const float4*>(dzp)[e];
            const float4 xv = reinterpret_cast<const float4*>(xp)[e];
            const float gs[4] = {gv.x, gv.y, gv.z, gv.w}, xq[4] = {xv.x, xv.y, xv.z, xv.w},
                        os[4] = {o[u].x, o[u].y, o[u].z, o[u].w};
            float dz[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float xh = xhat(xq[q], p);
              dz[q] = grad_z(gs[q], xh, os[q], p, act, a, v[2]);
              v[0] = __dadd_rn(v[0], (double)dz[q]);
              v[1] = __dadd_rn(v[1], __dmul_rn((double)dz[q], (double)xh));
            }
            reinterpret_cast<float4*>(dzp)[e] = make_float4(dz[0], dz[1], dz[2], dz[3]);
          }
        } else {
          float o[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * group;
            o[u] = op != nullptr && e < items ? op[e] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * group;
            if (e >= items) break;
            const float xh = xhat(xp[e], p);
            const float dz = grad_z(dzp[e], xh, o[u], p, act, a, v[2]);
            v[0] = __dadd_rn(v[0], (double)dz);
            v[1] = __dadd_rn(v[1], __dmul_rn((double)dz, (double)xh));
            dzp[e] = dz;
          }
        }
      }
    }
    group_sums(v, group, s.part);
    if (i < count && gl == 0)
      for (int q = 0; q < R; ++q) {
        double* to = cluster.map_shared_rank(s.sums, q) + 3 * (first + i);
        to[0] = v[0];
        to[1] = v[1];
        to[2] = v[2];
      }
  }
  BN_PHASE(3);
  cluster_arrive();  // every rank now holds the channel's N sums
  cluster_wait();
  BN_PHASE(4);
  double t[3] = {0.0, 0.0, 0.0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) t[k] = s.sums[k];
#pragma unroll 4
    for (int n = 1; n < N; ++n)
      for (int k = 0; k < 3; ++k) t[k] = __dadd_rn(t[k], s.sums[3 * n + k]);
    const double M = (double)N * HW;
    s.coef[0] = (float)__ddiv_rn(t[0], M);
    s.coef[1] = (float)__ddiv_rn(t[1], M);
  }
  __syncthreads();
  BN_PHASE(5);
  if (rank == 0 && threadIdx.x == 0) {  // off the block's barrier
    dw[c] = (float)t[1];
    db[c] = (float)t[0];
    if (slope_sums != nullptr) slope_sums[c] = t[2];
  }

  const float k1 = p.norm ? s.coef[0] : 0.f, k2 = p.norm ? s.coef[1] : 0.f;
  for (int i = gi; i < count; i += groups) {
    const float* dzp = dzs + i * pitch;
    const float* xp = xs + i * pitch;
    const long long off = (first + i) * nstride + (long long)c * HW;
    for (int e = gl; e < items; e += group) {
      if (kVec) {
        const float4 dz = reinterpret_cast<const float4*>(dzp)[e];
        const float4 xv = reinterpret_cast<const float4*>(xp)[e];
        reinterpret_cast<float4*>(dx + off)[e] =
            make_float4(grad_x(dz.x, xhat(xv.x, p), p, k1, k2),
                        grad_x(dz.y, xhat(xv.y, p), p, k1, k2),
                        grad_x(dz.z, xhat(xv.z, p), p, k1, k2),
                        grad_x(dz.w, xhat(xv.w, p), p, k1, k2));
        if (dres != nullptr) reinterpret_cast<float4*>(dres + off)[e] = dz;
      } else {
        dx[off + e] = grad_x(dzp[e], xhat(xp[e], p), p, k1, k2);
        if (dres != nullptr) dres[off + e] = dzp[e];
      }
    }
  }
  BN_STAMP_EXIT();
}

// One warp: dslope = the channels' slope sums, lane l those from l in steps of 32, then the
// xor tree.
__device__ __forceinline__ void slope_total(const double* __restrict__ slope_sums, int C,
                                            float* __restrict__ dslope) {
  double t = 0.0;
  for (int c = threadIdx.x; c < C; c += 32) t += slope_sums[c];
  t = warp_sum(t);
  if (threadIdx.x == 0) *dslope = (float)t;
}

__global__ void __launch_bounds__(32)
batch_norm_bwd_slope_kernel(const double* __restrict__ slope_sums, int C,
                            float* __restrict__ dslope) {
  slope_total(slope_sums, C, dslope);
}

// T: float, or __nv_bfloat16 (--bf16 training: g, x and out bfloat16, widened exactly).
template <class T, bool kVec>
__global__ void __launch_bounds__(kThreads)
batch_norm_bwd_partial_kernel(const T* __restrict__ g, const T* __restrict__ x,
                              const T* __restrict__ out, const float* __restrict__ mean,
                              const float* __restrict__ rstd, const float* __restrict__ w,
                              const float* __restrict__ b, const float* __restrict__ slope,
                              double* __restrict__ partial, int N, int C, int HW, int slices,
                              long long warps, int act) {
  const long long wi = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (wi >= warps) return;
  const int lane = threadIdx.x % 32;
  const SliceWarp sw = slice_warp(wi, N, C, HW, slices);
  const Channel p = channel(mean, rstd, w, b, sw.c);
  const float a = slope != nullptr ? *slope : 0.f;
  const T* gp = g + sw.plane;
  const T* xp = x + sw.plane;
  const T* op = out != nullptr ? out + sw.plane : nullptr;
  double sdz = 0.0, sdzx = 0.0, sslope = 0.0;
  if (kVec) {
    for (int e = sw.e0 + 4 * lane; e < sw.e1; e += 4 * 32) {
      const float4 gv = load4(gp + e);
      const float4 xv = load4(xp + e);
      const float4 ov = op != nullptr ? load4(op + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float gs[4] = {gv.x, gv.y, gv.z, gv.w}, xs[4] = {xv.x, xv.y, xv.z, xv.w},
                  os[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xh = xhat(xs[j], p);
        const float dz = grad_z(gs[j], xh, os[j], p, act, a, sslope);
        sdz += dz;
        sdzx += (double)dz * (double)xh;
      }
    }
  } else {
    for (int e = sw.e0 + lane; e < sw.e1; e += 32) {
      const float xh = xhat(load1(xp + e), p);
      const float dz = grad_z(load1(gp + e), xh, op != nullptr ? load1(op + e) : 0.f, p, act, a,
                              sslope);
      sdz += dz;
      sdzx += (double)dz * (double)xh;
    }
  }
  sdz = warp_sum(sdz);
  sdzx = warp_sum(sdzx);
  sslope = warp_sum(sslope);
  if (lane == 0) {
    partial[3 * wi] = sdz;
    partial[3 * wi + 1] = sdzx;
    partial[3 * wi + 2] = sslope;
  }
}

// A warp per channel over its `parts` = N * slices partials; slope_sums [C] or null.
__global__ void __launch_bounds__(kThreads)
batch_norm_bwd_final_kernel(const double* __restrict__ partial, float* __restrict__ coef,
                            float* __restrict__ dw, float* __restrict__ db,
                            double* __restrict__ slope_sums, int C, int parts, long long M) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (c >= C) return;
  const double* q = partial + 3 * (long long)c * parts;
  double sdz = 0.0, sdzx = 0.0, sslope = 0.0;
  for (int j = lane; j < parts; j += 32) {
    sdz += q[3 * j];
    sdzx += q[3 * j + 1];
    sslope += q[3 * j + 2];
  }
  sdz = warp_sum(sdz);
  sdzx = warp_sum(sdzx);
  sslope = warp_sum(sslope);
  if (lane != 0) return;
  dw[c] = (float)sdzx;
  db[c] = (float)sdz;
  coef[c] = (float)(sdz / (double)M);
  coef[C + c] = (float)(sdzx / (double)M);
  if (slope_sums != nullptr) slope_sums[c] = sslope;
}

// dx (and dres's dz) of one element from g, x and out
__device__ __forceinline__ float grad_x_of(float g, float x, float o, const Channel& p, int act,
                                           float a, float k1, float k2, float& dz) {
  double unused = 0.0;
  const float xh = xhat(x, p);
  dz = grad_z(g, xh, o, p, act, a, unused);
  return grad_x(dz, xh, p, k1, k2);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
batch_norm_bwd_apply_kernel(const float* __restrict__ g, const float* __restrict__ x,
                            const float* __restrict__ out, const float* __restrict__ mean,
                            const float* __restrict__ rstd, const float* __restrict__ w,
                            const float* __restrict__ b, const float* __restrict__ slope,
                            const float* __restrict__ coef,
                            const double* __restrict__ slope_sums, float* __restrict__ dslope,
                            float* __restrict__ dx, float* __restrict__ dres, long long total,
                            int C, int HW, int act) {
  if (dslope != nullptr && blockIdx.x == 0 && threadIdx.x < 32)  // the channels' slope sums
    slope_total(slope_sums, C, dslope);
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * (kVec ? 4 : 1);
  if (i >= total) return;
  const int c = (int)(((unsigned)i / (unsigned)HW) % (unsigned)C);
  const Channel p = channel(mean, rstd, w, b, c);
  const float a = slope != nullptr ? *slope : 0.f;
  const float k1 = p.norm ? coef[c] : 0.f, k2 = p.norm ? coef[C + c] : 0.f;
  if (kVec) {
    const float4 gv = *reinterpret_cast<const float4*>(g + i);
    const float4 xv = *reinterpret_cast<const float4*>(x + i);
    const float4 ov = out != nullptr ? *reinterpret_cast<const float4*>(out + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 dz;
    const float4 d = make_float4(grad_x_of(gv.x, xv.x, ov.x, p, act, a, k1, k2, dz.x),
                                 grad_x_of(gv.y, xv.y, ov.y, p, act, a, k1, k2, dz.y),
                                 grad_x_of(gv.z, xv.z, ov.z, p, act, a, k1, k2, dz.z),
                                 grad_x_of(gv.w, xv.w, ov.w, p, act, a, k1, k2, dz.w));
    *reinterpret_cast<float4*>(dx + i) = d;
    if (dres != nullptr) *reinterpret_cast<float4*>(dres + i) = dz;
  } else {
    float dz;
    dx[i] = grad_x_of(g[i], x[i], out != nullptr ? out[i] : 0.f, p, act, a, k1, k2, dz);
    if (dres != nullptr) dres[i] = dz;
  }
}

// dx (rounded to bfloat16 once) and the residual's dz (exact in bfloat16) of 8 bfloat16
// elements (kVec: 16-byte accesses) or one; a thread an item, its channel's coefficients
// read once.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
batch_norm_bwd_apply_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                                 const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ out,
                                 const float* __restrict__ mean, const float* __restrict__ rstd,
                                 const float* __restrict__ w, const float* __restrict__ b,
                                 const float* __restrict__ coef, __nv_bfloat16* __restrict__ dx,
                                 __nv_bfloat16* __restrict__ dres, long long total, int C, int HW,
                                 int act) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * (kVec ? 8 : 1);
  if (i >= total) return;
  const int c = (int)(((unsigned long long)i / (unsigned)HW) % (unsigned)C);
  const Channel p = channel(mean, rstd, w, b, c);
  const float k1 = coef[c], k2 = coef[C + c];
  if (kVec) {
    const uint4 gv = *reinterpret_cast<const uint4*>(g + i);
    const uint4 xv = *reinterpret_cast<const uint4*>(x + i);
    const uint4 ov =
        out != nullptr ? *reinterpret_cast<const uint4*>(out + i) : make_uint4(0, 0, 0, 0);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    uint4 dxv, dzv;
    __nv_bfloat162* dxp = reinterpret_cast<__nv_bfloat162*>(&dxv);
    __nv_bfloat162* dzp = reinterpret_cast<__nv_bfloat162*>(&dzv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 gf = __bfloat1622float2(gp[j]), xf = __bfloat1622float2(xp[j]),
                   of = __bfloat1622float2(op[j]);
      float dz0, dz1;
      const float d0 = grad_x_of(gf.x, xf.x, of.x, p, act, 0.f, k1, k2, dz0);
      const float d1 = grad_x_of(gf.y, xf.y, of.y, p, act, 0.f, k1, k2, dz1);
      dxp[j] = __floats2bfloat162_rn(d0, d1);
      dzp[j] = __floats2bfloat162_rn(dz0, dz1);
    }
    *reinterpret_cast<uint4*>(dx + i) = dxv;
    if (dres != nullptr) *reinterpret_cast<uint4*>(dres + i) = dzv;
  } else {
    float dz;
    const float d = grad_x_of(__bfloat162float(g[i]), __bfloat162float(x[i]),
                              out != nullptr ? __bfloat162float(out[i]) : 0.f, p, act, 0.f, k1,
                              k2, dz);
    dx[i] = __float2bfloat16_rn(d);
    if (dres != nullptr) dres[i] = __float2bfloat16_rn(dz);
  }
}

}  // namespace

namespace tris {
namespace bn {

// Whether the card runs a cluster of `plan`'s fused backward blocks at all.
bool fused_bwd_fits(const BatchNormPlan& plan) {
  return resident_clusters(&batch_norm_bwd_fused_kernel<true, kBatchNormFusedUnrollWide>,
                           plan.ranks, plan.threads, plan.smem) > 0;
}

}  // namespace bn
}  // namespace tris

#ifdef TRIS_BN_STAMPS
// The measurement build's stamp buffer for this file's fused kernel (batch_norm.cuh).
extern "C" cudaError_t bn_set_stamps_bwd(unsigned long long* stamps) {
  return cudaMemcpyToSymbol(tris::bn::bn_stamps, &stamps, sizeof(stamps));
}
#endif

namespace tris {

BatchNormPlan batch_norm_device_plan(int N, int C, int HW, bool training, bool backward, int act,
                                     int force) {
  BatchNormPlan p = batch_norm_plan(N, C, HW, training, backward, act,
                                    backward ? kBatchNormWideRanks : kBatchNormMaxRanks);
  if (p.design == kBatchNormFused && p.ranks > kBatchNormMaxRanks && !bn::fused_bwd_fits(p))
    p = batch_norm_plan(N, C, HW, training, backward, act, kBatchNormMaxRanks);
  if (force == kBatchNormTwoPass && p.design == kBatchNormFused)
    p = {kBatchNormTwoPass, 0, 0, 0, 0, 0, 0, 3, p.max_ranks};
  return p;
}

cudaError_t batch_norm_bwd_partial(const float* g, const float* x, const float* out,
                                   const float* mean, const float* rstd, const float* weight,
                                   const float* bias, const float* slope, double* partial, int N,
                                   int C, int HW, int act, cudaStream_t stream,
                                   BatchNormLaunchShape* shape) {
  const bool vec = HW % 4 == 0 && bn::aligned16(g) && bn::aligned16(x) && bn::aligned16(out);
  const int slices = (int)batch_norm_slices(HW);
  const long long warps = (long long)C * N * slices;
  const unsigned blocks = (unsigned)((warps + bn::kWarps - 1) / bn::kWarps);
  if (vec)
    batch_norm_bwd_partial_kernel<float, true><<<blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, slope, partial, N, C, HW, slices, warps, act);
  else
    batch_norm_bwd_partial_kernel<float, false><<<blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, slope, partial, N, C, HW, slices, warps, act);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {(int)blocks, 1, bn::kThreads, 0, vec ? 16 : 4};
  return err;
}

cudaError_t batch_norm_bwd_final(const double* partial, float* coef, float* dweight,
                                 float* dbias, double* slope_sums, int N, int C, int HW,
                                 cudaStream_t stream, BatchNormLaunchShape* shape) {
  const int slices = (int)batch_norm_slices(HW);
  const unsigned final_blocks = (unsigned)((C + bn::kWarps - 1) / bn::kWarps);
  batch_norm_bwd_final_kernel<<<final_blocks, bn::kThreads, 0, stream>>>(
      partial, coef, dweight, dbias, slope_sums, C, N * slices, (long long)N * HW);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {(int)final_blocks, 1, bn::kThreads, 0, 8};
  return err;
}

cudaError_t batch_norm_bwd_apply(const float* g, const float* x, const float* out,
                                 const float* mean, const float* rstd, const float* weight,
                                 const float* bias, const float* slope, const float* coef,
                                 const double* slope_sums, float* dslope, float* dx, float* dres,
                                 int N, int C, int HW, int act, cudaStream_t stream,
                                 BatchNormLaunchShape* shape) {
  const bool vec = HW % 4 == 0 && bn::aligned16(g) && bn::aligned16(x) && bn::aligned16(out) &&
                   bn::aligned16(dx) && bn::aligned16(dres);
  const long long total = (long long)N * HW * C;
  const long long items = vec ? total / 4 : total;
  const unsigned apply_blocks = (unsigned)((items + bn::kThreads - 1) / bn::kThreads);
  if (vec)
    batch_norm_bwd_apply_kernel<true><<<apply_blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, slope, coef, slope_sums, dslope, dx, dres, total, C,
        HW, act);
  else
    batch_norm_bwd_apply_kernel<false><<<apply_blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, slope, coef, slope_sums, dslope, dx, dres, total, C,
        HW, act);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {(int)apply_blocks, 1, bn::kThreads, 0, vec ? 16 : 4};
  return err;
}

cudaError_t batch_norm_bwd_bf16(const Bf16Bits* g_bits, const Bf16Bits* x_bits,
                                const Bf16Bits* out_bits, const float* mean, const float* rstd,
                                const float* weight, const float* bias, double* partial,
                                float* coef, float* dweight, float* dbias, Bf16Bits* dx_bits,
                                Bf16Bits* dres_bits, int N, int C, int HW, int act,
                                cudaStream_t stream, BatchNormLaunchShape* shapes) {
  if (act != kBatchNormActNone && act != kBatchNormActRelu) return cudaErrorInvalidValue;
  const auto* g = reinterpret_cast<const __nv_bfloat16*>(g_bits);
  const auto* x = reinterpret_cast<const __nv_bfloat16*>(x_bits);
  const auto* out = reinterpret_cast<const __nv_bfloat16*>(out_bits);
  auto* dx = reinterpret_cast<__nv_bfloat16*>(dx_bits);
  auto* dres = reinterpret_cast<__nv_bfloat16*>(dres_bits);
  const int slices = (int)batch_norm_slices(HW);
  const long long warps = (long long)C * N * slices;
  const unsigned blocks = (unsigned)((warps + bn::kWarps - 1) / bn::kWarps);
  const bool vec = HW % 4 == 0 && bn::aligned(g, 8) && bn::aligned(x, 8) && bn::aligned(out, 8);
  if (vec)
    batch_norm_bwd_partial_kernel<__nv_bfloat16, true><<<blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, nullptr, partial, N, C, HW, slices, warps, act);
  else
    batch_norm_bwd_partial_kernel<__nv_bfloat16, false><<<blocks, bn::kThreads, 0, stream>>>(
        g, x, out, mean, rstd, weight, bias, nullptr, partial, N, C, HW, slices, warps, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  shapes[0] = {(int)blocks, 1, bn::kThreads, 0, vec ? 8 : 2};
  if ((err = batch_norm_bwd_final(partial, coef, dweight, dbias, nullptr, N, C, HW, stream,
                                  shapes + 1)) != cudaSuccess)
    return err;
  const bool vec8 = HW % 8 == 0 && bn::aligned16(g) && bn::aligned16(x) && bn::aligned16(out) &&
                    bn::aligned16(dx) && bn::aligned16(dres);
  const long long total = (long long)N * HW * C;
  const long long items = vec8 ? total / 8 : total;
  const unsigned apply_blocks = (unsigned)((items + bn::kThreads - 1) / bn::kThreads);
  auto* kernel = vec8 ? &batch_norm_bwd_apply_bf16_kernel<true>
                      : &batch_norm_bwd_apply_bf16_kernel<false>;
  kernel<<<apply_blocks, bn::kThreads, 0, stream>>>(g, x, out, mean, rstd, weight, bias, coef,
                                                     dx, dres, total, C, HW, act);
  if ((err = cudaGetLastError()) == cudaSuccess)
    shapes[2] = {(int)apply_blocks, 1, bn::kThreads, 0, vec8 ? 16 : 2};
  return err;
}

cudaError_t batch_norm_bwd(const BatchNormPlan& plan, const float* g, const float* x,
                           const float* out, const float* mean, const float* rstd,
                           const float* weight, const float* bias, const float* slope,
                           double* partial, float* coef, float* dweight, float* dbias,
                           float* dslope, float* dx, float* dres, int N, int C, int HW, int act,
                           cudaStream_t stream, BatchNormLaunchShape* shapes) {
  const bool vec = HW % 4 == 0 && bn::aligned16(g) && bn::aligned16(x) && bn::aligned16(out) &&
                   bn::aligned16(dx) && bn::aligned16(dres);
  if (plan.design == kBatchNormFused) {
    double* slope_sums = dslope != nullptr ? partial : nullptr;
    const bool wide = plan.threads == kBatchNormFusedThreadsWide;
    constexpr int kU = kBatchNormFusedUnroll, kW = kBatchNormFusedUnrollWide;
    auto* kernel = vec ? (wide ? &batch_norm_bwd_fused_kernel<true, kW>
                               : &batch_norm_bwd_fused_kernel<true, kU>)
                       : (wide ? &batch_norm_bwd_fused_kernel<false, kW>
                               : &batch_norm_bwd_fused_kernel<false, kU>);
    cudaError_t err = bn::launch(kernel, plan.blocks, plan.ranks, plan.threads, plan.smem,
                                 vec ? 16 : 4, stream, shapes, g, x, out, mean, rstd, weight,
                                 bias, slope, dweight, dbias, slope_sums, dx, dres, N, C, HW,
                                 plan.samples, plan.group, act);
    if (err != cudaSuccess || dslope == nullptr) return err;
    batch_norm_bwd_slope_kernel<<<1, 32, 0, stream>>>(slope_sums, C, dslope);
    err = cudaGetLastError();
    if (err == cudaSuccess) shapes[1] = {1, 1, 32, 0, 8};
    return err;
  }
  const long long warps = (long long)C * N * batch_norm_slices(HW);
  double* slope_sums = dslope != nullptr ? partial + 3 * warps : nullptr;
  cudaError_t err = batch_norm_bwd_partial(g, x, out, mean, rstd, weight, bias, slope, partial,
                                           N, C, HW, act, stream, shapes);
  if (err != cudaSuccess) return err;
  err = batch_norm_bwd_final(partial, coef, dweight, dbias, slope_sums, N, C, HW, stream,
                             shapes + 1);
  if (err != cudaSuccess) return err;
  return batch_norm_bwd_apply(g, x, out, mean, rstd, weight, bias, slope, coef, slope_sums,
                              dslope, dx, dres, N, C, HW, act, stream, shapes + 2);
}

}  // namespace tris
