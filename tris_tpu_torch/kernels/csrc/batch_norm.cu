// K13: BatchNorm with the activation that follows it, forward: the fused design (one launch a
// norm: the statistics and the apply from one read of x) where a channel fits on chip, else
// the two-pass design (the batch statistics, two launches, and the apply pass, one launch);
// the eval fold is the apply pass alone. launchers.h::batch_norm_plan chooses by the shape.
//
// Replaces the JAX package's tris_tpu/models/layers.py:181 TorchBatchNorm (train path
// :219-229, eval fold :213-217) as its callers use it: followed by ReLU (CLIP's stem and a
// bottleneck's first two norms, tris_tpu/models/clip.py:95-100), by the residual add and
// ReLU (a bottleneck's tail), by nothing (its downsample), or by the channel-shared PReLU
// (stage 2's ConvBNRelu, tris_tpu/models/stage2.py:35-50). For x [N, C, HW] float32 and
// each channel c over its M = N * HW elements:
//   mean = sum(x) / M,  var = sum((x - mean)^2) / M (biased),  rstd = 1 / sqrt(var + eps)
//   y = act(((x - mean) * rstd) * weight + bias [+ residual])
// and the running statistics, where asked: rm = (1 - m) rm + m mean, rv = (1 - m) rv +
// m var M / max(M - 1, 1). The eval fold is the apply pass alone with weight a and bias b
// (the plain version's fold) and no normalisation: y = act(x * a + b).
//
// Shapes on the main paths: the CLIP RN50 trunk's 55 norms at B = 48, 320 px, from
// [48, 32, 160, 160] (the stem) to [48, 2048, 10, 10] (layer4), 4.88 GB of inputs a
// forward; stage 2's decoder [48, 32..512, 10^2..80^2]. Every one but the stem's three
// (4.8 MB a channel) takes the fused design.
//
// Statistics, the same numbers as the plain version (kernels/batch_norm.py::
// batch_stats_plain): each sample's plane gives its mean m_n and sum of squared deviations
// q_n in double (from sums of x - k and (x - k)^2, k = x[0, c, 0] a shift that keeps the
// squares from cancelling), each rounded once to float32; then in float32, the samples in
// batch order: mean = (sum m_n) / N and var = (sum q_n + HW * sum (m_n - mean)^2) / M; rstd =
// 1 / sqrt(var + eps) in double, rounded once. A sample's moments are exact to float32; the
// batch combine keeps float32's dependence on the batch order, as torch's and the JAX
// package's statistics have. The running update in double, rounded once. No atomics: the
// same bits run to run.
//
// batch_norm_fwd_fused_kernel: a cluster of R blocks a channel, rank r staging samples
// [r N / R, (r + 1) N / R) in shared memory (a plane a cp.async.bulk on its own mbarrier,
// issued by warp 0's lanes; or the block's 4-byte loads where HW % 4 != 0 or a pointer is
// not 16-byte aligned). A group of
// `group` lanes sums a sample as soon as its plane has landed: lane l the plane's items
// (float4, or floats) l, l + group, ..., each float4 as (d0 + d1) + (d2 + d3) and its squares
// alike (d = x - k, every double operation rounded alone), then the group's xor tree (and
// its warps' totals in warp order); tools/batch_norm_schedule.py::fused_channel_stats
// emulates that order. Each rank writes its samples' moments into every rank's shared
// memory (distributed shared memory); after the cluster's barrier every rank combines the
// N in batch order alike, rank 0 writes stats [3, C] and moves the running buffers, and
// each rank applies the norm and its activation to its staged planes, reading the residual
// and writing y with 16-byte accesses. x is read from device memory once.
//
// batch_norm_stats_partial_kernel: a warp per (channel, sample, slice of its plane)
// (launchers.h) sums in double, the lanes in a fixed tree, and writes partial[c][n][slice].
// batch_norm_stats_final_kernel: a warp per channel adds each sample's slices in order,
// then one lane combines the samples. The two kernels are apart so that a cross-rank
// combine of the samples' moments can go between them.
//
// batch_norm_apply_kernel: a block over (planes, chunk of a plane) in address order: a plane
// of at least kBatchNormApplyThreads items takes whole blocks, smaller planes share one; a
// thread an item (no divide an element), each product and sum rounded alone in the plain
// version's order: given the same mean and rstd it gives the plain route's bits, and the
// eval fold gives them exactly.
//
// batch_norm_fold_bf16_kernel (--bf16): the eval fold on bfloat16 x, residual and y, the
// apply kernel's layout with 8 values an item, each product and sum rounded to bfloat16 as
// the plain version's bfloat16 ops round; then ReLU, or stage 2's PReLU with a bfloat16 slope
// (y bfloat16, a * y rounded) or a float32 one (a float32 checkpoint's: y float32, as jnp
// promotes where(y >= 0, y, a * y)).
//
// --bf16 training (batch_norm_forward_bf16): the two-pass design on bfloat16 x at every shape,
// three launches: the partial and final kernels instantiated on bfloat16 (the statistics the
// same numbers as on the float32 copy of x), then batch_norm_apply_bf16_kernel (the fold
// kernel's layout): y in float32 as the float32 apply forms it, rounded to bfloat16 once, plus
// the residual, rounded, then ReLU, as the plain version's bfloat16 ops.
//
// Bound: bytes. The fused kernel reads x (and the residual) and writes y; the two-pass design
// reads x twice.

#include "batch_norm.cuh"

namespace {

using namespace tris;
using namespace tris::bn;

// Grid C * R blocks in clusters of R: block b is rank b % R of channel b / R.
template <bool kVec>
__global__ void __launch_bounds__(kBatchNormFusedThreadsWide)
batch_norm_fwd_fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ b, const float* __restrict__ res,
                            const float* __restrict__ slope, float* __restrict__ y,
                            float* __restrict__ stats, float* __restrict__ rm,
                            float* __restrict__ rv, int N, int C, int HW, int samples, int group,
                            int act, double momentum, double eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BN_STAMP_ENTRY();
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int c = blockIdx.x / R;
  const int first = rank_first(rank, R, N), count = rank_first(rank + 1, R, N) - first;
  const FusedSmem s = fused_smem(smem_raw, N, HW, samples, false);
  const long long pitch = batch_norm_pitch(HW), nstride = (long long)C * HW;
  const float* xc = x + (long long)c * HW;  // sample 0's plane of channel c
  if (kVec) {
    issue_planes(&xc, 1, s.stage, s.set, s.bars, first, count, nstride, HW);
    __syncthreads();
  } else {
    load_planes(&xc, 1, s.stage, s.set, first, count, nstride, HW);
  }
  BN_PHASE(2);
  cluster_arrive_relaxed();  // this block has started: the others may write its moments

  // the channel's parameters, read while its planes land
  const double k = xc[0];
  Channel ch;
  ch.norm = true;
  ch.w = w[c];
  ch.b = b[c];
  const float a = slope != nullptr ? *slope : 0.f;
  const bool has_res = res != nullptr;
  const int groups = blockDim.x / group, gi = threadIdx.x / group, gl = threadIdx.x % group;
  const int items = kVec ? HW / 4 : HW, rounds = (count + groups - 1) / groups;
  cluster_wait();
  for (int r = 0; r < rounds; ++r) {  // the same rounds on every thread: group_sums is collective
    const int i = gi + r * groups;
    double v[3] = {0.0, 0.0, 0.0};
    if (i < count) {
      if (kVec) mbar_wait(&s.bars[i], 0);
      const float* p = s.stage + i * pitch;
      for (int e = gl; e < items; e += group) {
        if (kVec) {
          const float4 q = reinterpret_cast<const float4*>(p)[e];
          const double d0 = __dsub_rn((double)q.x, k), d1 = __dsub_rn((double)q.y, k),
                       d2 = __dsub_rn((double)q.z, k), d3 = __dsub_rn((double)q.w, k);
          v[0] = __dadd_rn(v[0], __dadd_rn(__dadd_rn(d0, d1), __dadd_rn(d2, d3)));
          v[1] = __dadd_rn(v[1], __dadd_rn(__dadd_rn(__dmul_rn(d0, d0), __dmul_rn(d1, d1)),
                                           __dadd_rn(__dmul_rn(d2, d2), __dmul_rn(d3, d3))));
        } else {
          const double d = __dsub_rn((double)p[e], k);
          v[0] = __dadd_rn(v[0], d);
          v[1] = __dadd_rn(v[1], __dmul_rn(d, d));
        }
      }
    }
    group_sums(v, group, s.part);
    if (i < count && gl == 0) {
      const float2 mq = sample_moments(v[0], v[1], k, HW);
      for (int q = 0; q < R; ++q) cluster.map_shared_rank(s.moments, q)[first + i] = mq;
    }
  }
  BN_PHASE(3);
  cluster_arrive();  // every rank now holds the channel's N moments
  cluster_wait();
  BN_PHASE(4);
  if (threadIdx.x == 0) {
    const BatchStats st = combine_batch(s.moments, N, HW, eps);
    s.coef[0] = st.mean;
    s.coef[1] = st.var;
    s.coef[2] = st.rstd;
  }
  __syncthreads();
  BN_PHASE(5);
  ch.mean = s.coef[0];
  ch.rstd = s.coef[2];
  if (rank == 0 && threadIdx.x == 0)  // off the block's barrier: rm and rv are read here
    store_stats({ch.mean, s.coef[1], ch.rstd}, stats, rm, rv, c, C, (long long)N * HW, momentum);

  constexpr int U = kBatchNormFusedUnroll;
  for (int i = gi; i < count; i += groups) {
    const float* sp = s.stage + i * pitch;
    const long long off = (first + i) * nstride + (long long)c * HW;
    for (int e0 = gl; e0 < items; e0 += U * group) {
      if (kVec) {
        float4 rr[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * group;
          rr[u] = has_res && e < items ? reinterpret_cast<const float4*>(res + off)[e]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * group;
          if (e >= items) break;
          const float4 q = reinterpret_cast<const float4*>(sp)[e];
          reinterpret_cast<float4*>(y + off)[e] =
              make_float4(forward_one(q.x, rr[u].x, has_res, ch, act, a),
                          forward_one(q.y, rr[u].y, has_res, ch, act, a),
                          forward_one(q.z, rr[u].z, has_res, ch, act, a),
                          forward_one(q.w, rr[u].w, has_res, ch, act, a));
        }
      } else {
        float rr[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * group;
          rr[u] = has_res && e < items ? res[off + e] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * group;
          if (e >= items) break;
          y[off + e] = forward_one(sp[e], rr[u], has_res, ch, act, a);
        }
      }
    }
  }
  BN_STAMP_EXIT();
}

// T: float, or __nv_bfloat16 (--bf16 training; each value exact in float and double).
template <class T, bool kVec>
__global__ void __launch_bounds__(kThreads)
batch_norm_stats_partial_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                                long long shift_stride, double* __restrict__ partial, int N,
                                int C, int HW, int slices, long long warps) {
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= warps) return;
  const int lane = threadIdx.x % 32;
  const SliceWarp sw = slice_warp(w, N, C, HW, slices);
  const double k = load1(shift + (long long)sw.c * shift_stride);
  const T* plane = x + sw.plane;
  const int e0 = sw.e0, e1 = sw.e1;
  double s1 = 0.0, s2 = 0.0;
  if (kVec) {
    for (int e = e0 + 4 * lane; e < e1; e += 4 * 32) {
      const float4 v = load4(plane + e);
      const double d0 = (double)v.x - k, d1 = (double)v.y - k, d2 = (double)v.z - k,
                   d3 = (double)v.w - k;
      s1 += (d0 + d1) + (d2 + d3);
      s2 += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  } else {
    for (int e = e0 + lane; e < e1; e += 32) {
      const double d = (double)load1(plane + e) - k;
      s1 += d;
      s2 += d * d;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    partial[2 * w] = s1;
    partial[2 * w + 1] = s2;
  }
}

// A warp per channel: the lanes form the samples' moments (sample n on lane n % 32, its
// slices in order) into shared memory, then lane 0 combines them in batch order.
template <class T>
__global__ void __launch_bounds__(32)
batch_norm_stats_final_kernel(const T* __restrict__ shift, long long shift_stride,
                              const double* __restrict__ partial, float* __restrict__ stats,
                              float* __restrict__ rm, float* __restrict__ rv, int N, int C,
                              int HW, int slices, double momentum, double eps) {
  extern __shared__ float2 moments[];  // [N]
  const int c = blockIdx.x;
  const double k = load1(shift + (long long)c * shift_stride);
  const double* q = partial + 2 * (long long)c * N * slices;
  for (int n = threadIdx.x; n < N; n += 32) {
    const double* qn = q + 2 * (long long)n * slices;
    double s1 = 0.0, s2 = 0.0;
    for (int sl = 0; sl < slices; ++sl) {
      s1 += qn[2 * sl];
      s2 += qn[2 * sl + 1];
    }
    moments[n] = sample_moments(s1, s2, k, HW);
  }
  __syncwarp();
  if (threadIdx.x != 0) return;
  store_stats(combine_batch(moments, N, HW, eps), stats, rm, rv, c, C, (long long)N * HW,
              momentum);
}

// A block takes `per` = kBatchNormApplyThreads / tpp planes of tpp threads each, and of each
// plane one chunk of tpp items: block b chunk b % chunks of the planes from (b / chunks) *
// per, so neighbouring blocks read neighbouring addresses; thread j of a plane takes item
// chunk * tpp + j.
template <bool kVec>
__global__ void __launch_bounds__(kBatchNormApplyThreads)
batch_norm_apply_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                        const float* __restrict__ rstd, const float* __restrict__ w,
                        const float* __restrict__ b, const float* __restrict__ res,
                        const float* __restrict__ slope, float* __restrict__ y,
                        long long planes, int C, int HW, int tpp, int chunks, int act) {
  const int per = kBatchNormApplyThreads / tpp;
  if ((int)threadIdx.x >= per * tpp) return;
  const long long plane = blockIdx.x / chunks * per + threadIdx.x / tpp;
  const int e = (int)(blockIdx.x % chunks) * tpp + threadIdx.x % tpp;
  if (plane >= planes || e >= (kVec ? HW / 4 : HW)) return;
  const Channel p = channel(mean, rstd, w, b, (int)(plane % C));
  const float a = slope != nullptr ? *slope : 0.f;
  const bool has_res = res != nullptr;
  const long long off = plane * HW;
  if (kVec) {
    const float4 v = reinterpret_cast<const float4*>(x + off)[e];
    const float4 r = has_res ? reinterpret_cast<const float4*>(res + off)[e]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(y + off)[e] = make_float4(
        forward_one(v.x, r.x, has_res, p, act, a), forward_one(v.y, r.y, has_res, p, act, a),
        forward_one(v.z, r.z, has_res, p, act, a), forward_one(v.w, r.w, has_res, p, act, a));
  } else {
    y[off + e] = forward_one(x[off + e], has_res ? res[off + e] : 0.f, has_res, p, act, a);
  }
}

// y of one bfloat16 element of the eval fold (a, b and r bfloat16 values as floats): each
// product and sum exact in float32 or rounded there, then rounded to bfloat16; then ReLU, or
// PReLU with slope s (kF32Out: a float32 product; else rounded to bfloat16)
template <bool kF32Out = false>
__device__ __forceinline__ float fold_one_bf16(float x, float a, float b, float r, bool has_res,
                                               int act, float s = 0.f) {
  float o = round_bf16(__fadd_rn(round_bf16(__fmul_rn(x, a)), b));
  if (has_res) o = round_bf16(__fadd_rn(o, r));
  if (act == kBatchNormActPrelu && !(o >= 0.f))
    return kF32Out ? __fmul_rn(s, o) : round_bf16(__fmul_rn(s, o));
  return act == kBatchNormActRelu && o < 0.f ? 0.f : o;
}

// The eval fold in bfloat16 with batch_norm_apply_kernel's layout: an item is 8 values (a
// 16-byte access of x) with kVec, else one. y bfloat16, or float32 with kF32Out (PReLU with a
// float32 slope).
template <bool kVec, bool kF32Out>
__global__ void __launch_bounds__(kBatchNormApplyThreads)
batch_norm_fold_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ a,
                            const __nv_bfloat16* __restrict__ b,
                            const __nv_bfloat16* __restrict__ res,
                            const __nv_bfloat16* __restrict__ slope16,
                            const float* __restrict__ slope32, void* __restrict__ yv,
                            long long planes, int C, int HW, int tpp, int chunks, int act) {
  const int per = kBatchNormApplyThreads / tpp;
  if ((int)threadIdx.x >= per * tpp) return;
  const long long plane = blockIdx.x / chunks * per + threadIdx.x / tpp;
  const int e = (int)(blockIdx.x % chunks) * tpp + threadIdx.x % tpp;
  if (plane >= planes || e >= (kVec ? HW / 8 : HW)) return;
  const int c = (int)(plane % C);
  const float ac = __bfloat162float(a[c]), bc = __bfloat162float(b[c]);
  const float s = slope32 != nullptr   ? *slope32
                  : slope16 != nullptr ? __bfloat162float(*slope16)
                                       : 0.f;
  const bool has_res = res != nullptr;
  const long long off = plane * HW;
  if (kVec) {
    const uint4 xv = reinterpret_cast<const uint4*>(x + off)[e];
    const uint4 rv = has_res ? reinterpret_cast<const uint4*>(res + off)[e] : make_uint4(0, 0, 0, 0);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rv);
    float o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(xp[i]), rf = __bfloat1622float2(rp[i]);
      o[2 * i] = fold_one_bf16<kF32Out>(xf.x, ac, bc, rf.x, has_res, act, s);
      o[2 * i + 1] = fold_one_bf16<kF32Out>(xf.y, ac, bc, rf.y, has_res, act, s);
    }
    if constexpr (kF32Out) {
      float4* yp = reinterpret_cast<float4*>(static_cast<float*>(yv) + off) + 2 * e;
      yp[0] = make_float4(o[0], o[1], o[2], o[3]);
      yp[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
      uint4 out;
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int i = 0; i < 4; ++i) op[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
      reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(yv) + off)[e] = out;
    }
  } else {
    const float r = has_res ? __bfloat162float(res[off + e]) : 0.f;
    const float o =
        fold_one_bf16<kF32Out>(__bfloat162float(x[off + e]), ac, bc, r, has_res, act, s);
    if constexpr (kF32Out)
      static_cast<float*>(yv)[off + e] = o;
    else
      static_cast<__nv_bfloat16*>(yv)[off + e] = __float2bfloat16_rn(o);
  }
}

// y of one bfloat16 element of the train forward: the norm in float32 as forward_one forms
// it, rounded to bfloat16; plus the residual, rounded; then ReLU
__device__ __forceinline__ float train_one_bf16(float x, float r, bool has_res, const Channel& p,
                                                int act) {
  float o = round_bf16(affine(xhat(x, p), p));
  if (has_res) o = round_bf16(__fadd_rn(o, r));
  return act == kBatchNormActRelu && o < 0.f ? 0.f : o;
}

// The train forward's apply pass on bfloat16 x, residual and y with float32 statistics and
// parameters: batch_norm_fold_bf16_kernel's layout, 8 values an item with kVec, else one.
template <bool kVec>
__global__ void __launch_bounds__(kBatchNormApplyThreads)
batch_norm_apply_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mean,
                             const float* __restrict__ rstd, const float* __restrict__ w,
                             const float* __restrict__ b, const __nv_bfloat16* __restrict__ res,
                             __nv_bfloat16* __restrict__ y, long long planes, int C, int HW,
                             int tpp, int chunks, int act) {
  const int per = kBatchNormApplyThreads / tpp;
  if ((int)threadIdx.x >= per * tpp) return;
  const long long plane = blockIdx.x / chunks * per + threadIdx.x / tpp;
  const int e = (int)(blockIdx.x % chunks) * tpp + threadIdx.x % tpp;
  if (plane >= planes || e >= (kVec ? HW / 8 : HW)) return;
  const Channel p = channel(mean, rstd, w, b, (int)(plane % C));
  const bool has_res = res != nullptr;
  const long long off = plane * HW;
  if (kVec) {
    const uint4 xv = reinterpret_cast<const uint4*>(x + off)[e];
    const uint4 rv =
        has_res ? reinterpret_cast<const uint4*>(res + off)[e] : make_uint4(0, 0, 0, 0);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rv);
    uint4 out;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(xp[i]), rf = __bfloat1622float2(rp[i]);
      op[i] = __floats2bfloat162_rn(train_one_bf16(xf.x, rf.x, has_res, p, act),
                                    train_one_bf16(xf.y, rf.y, has_res, p, act));
    }
    reinterpret_cast<uint4*>(y + off)[e] = out;
  } else {
    const float r = has_res ? __bfloat162float(res[off + e]) : 0.f;
    y[off + e] = __float2bfloat16_rn(
        train_one_bf16(__bfloat162float(x[off + e]), r, has_res, p, act));
  }
}

}  // namespace

#ifdef TRIS_BN_STAMPS
// The measurement build's stamp buffer for this file's fused kernel (batch_norm.cuh).
extern "C" cudaError_t bn_set_stamps_fwd(unsigned long long* stamps) {
  return cudaMemcpyToSymbol(tris::bn::bn_stamps, &stamps, sizeof(stamps));
}
#endif

namespace tris {

cudaError_t batch_norm_stats_partial(const float* x, const float* shift, double* partial, int N,
                                     int C, int HW, cudaStream_t stream,
                                     BatchNormLaunchShape* shape) {
  const int slices = (int)batch_norm_slices(HW);
  const long long warps = (long long)C * N * slices;
  const unsigned blocks = (unsigned)((warps + bn::kWarps - 1) / bn::kWarps);
  const bool vec = HW % 4 == 0 && bn::aligned16(x);
  // the shift: x's first value of each channel, or the caller's [C]
  const float* k = shift != nullptr ? shift : x;
  const long long stride = shift != nullptr ? 1 : HW;
  if (vec)
    batch_norm_stats_partial_kernel<float, true><<<blocks, bn::kThreads, 0, stream>>>(
        x, k, stride, partial, N, C, HW, slices, warps);
  else
    batch_norm_stats_partial_kernel<float, false><<<blocks, bn::kThreads, 0, stream>>>(
        x, k, stride, partial, N, C, HW, slices, warps);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {(int)blocks, 1, bn::kThreads, 0, vec ? 16 : 4};
  return err;
}

cudaError_t batch_norm_stats_final(const float* shift, long long shift_stride,
                                   const double* partial, float* stats, float* running_mean,
                                   float* running_var, int N, int C, int HW, double momentum,
                                   double eps, cudaStream_t stream, BatchNormLaunchShape* shape) {
  const int slices = (int)batch_norm_slices(HW);
  const long long smem = (long long)N * sizeof(float2);
  batch_norm_stats_final_kernel<float><<<C, 32, smem, stream>>>(shift, shift_stride, partial, stats,
                                                         running_mean, running_var, N, C, HW,
                                                         slices, momentum, eps);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr) *shape = {C, 1, 32, smem, 8};
  return err;
}

cudaError_t batch_norm_stats(const float* x, double* partial, float* stats, float* running_mean,
                             float* running_var, int N, int C, int HW, double momentum,
                             double eps, cudaStream_t stream, BatchNormLaunchShape* shapes) {
  cudaError_t err = batch_norm_stats_partial(x, nullptr, partial, N, C, HW, stream, shapes);
  if (err != cudaSuccess) return err;
  return batch_norm_stats_final(x, HW, partial, stats, running_mean, running_var, N, C, HW,
                                momentum, eps, stream, shapes != nullptr ? shapes + 1 : nullptr);
}

cudaError_t batch_norm_apply(const float* x, const float* mean, const float* rstd,
                             const float* weight, const float* bias, const float* residual,
                             const float* slope, float* y, int N, int C, int HW, int act,
                             cudaStream_t stream, BatchNormLaunchShape* shape) {
  const bool vec = HW % 4 == 0 && bn::aligned16(x) && bn::aligned16(residual) &&
                   bn::aligned16(y);
  const int items = vec ? HW / 4 : HW;
  const int tpp = items >= kBatchNormApplyThreads ? kBatchNormApplyThreads : items;
  const int per = kBatchNormApplyThreads / tpp;
  const long long planes = (long long)N * C;
  const int chunks = (items + tpp - 1) / tpp;
  const long long blocks = (planes + per - 1) / per * chunks;
  if (vec)
    batch_norm_apply_kernel<true><<<(unsigned)blocks, kBatchNormApplyThreads, 0, stream>>>(
        x, mean, rstd, weight, bias, residual, slope, y, planes, C, HW, tpp, chunks, act);
  else
    batch_norm_apply_kernel<false><<<(unsigned)blocks, kBatchNormApplyThreads, 0, stream>>>(
        x, mean, rstd, weight, bias, residual, slope, y, planes, C, HW, tpp, chunks, act);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {(int)blocks, 1, kBatchNormApplyThreads, 0, vec ? 16 : 4};
  return err;
}

cudaError_t batch_norm_fold_bf16(const Bf16Bits* x, const Bf16Bits* a, const Bf16Bits* b,
                                 const Bf16Bits* residual, const Bf16Bits* slope16,
                                 const float* slope32, void* y, int N, int C, int HW, int act,
                                 cudaStream_t stream, BatchNormLaunchShape* shape) {
  const bool prelu = act == kBatchNormActPrelu;
  if (act != kBatchNormActNone && act != kBatchNormActRelu && !prelu) return cudaErrorInvalidValue;
  if (prelu != (slope16 != nullptr || slope32 != nullptr) || (slope16 && slope32) ||
      (prelu && residual != nullptr))
    return cudaErrorInvalidValue;
  const bool vec = HW % 8 == 0 && bn::aligned16(x) && bn::aligned16(residual) &&
                   bn::aligned16(y);
  const int items = vec ? HW / 8 : HW;
  const int tpp = items >= kBatchNormApplyThreads ? kBatchNormApplyThreads : items;
  const int per = kBatchNormApplyThreads / tpp;
  const long long planes = (long long)N * C;
  const int chunks = (items + tpp - 1) / tpp;
  const long long blocks = (planes + per - 1) / per * chunks;
  const bool f32_out = slope32 != nullptr;
  auto* kernel = vec ? (f32_out ? &batch_norm_fold_bf16_kernel<true, true>
                                : &batch_norm_fold_bf16_kernel<true, false>)
                     : (f32_out ? &batch_norm_fold_bf16_kernel<false, true>
                                : &batch_norm_fold_bf16_kernel<false, false>);
  kernel<<<(unsigned)blocks, kBatchNormApplyThreads, 0, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(a),
      reinterpret_cast<const __nv_bfloat16*>(b), reinterpret_cast<const __nv_bfloat16*>(residual),
      reinterpret_cast<const __nv_bfloat16*>(slope16), slope32, y, planes, C, HW, tpp, chunks,
      act);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {(int)blocks, 1, kBatchNormApplyThreads, 0, vec ? 16 : 2};
  return err;
}

cudaError_t batch_norm_forward_bf16(const Bf16Bits* x_bits, const float* weight, const float* bias,
                                    const Bf16Bits* residual_bits, Bf16Bits* y_bits, float* stats,
                                    double* partial, float* running_mean, float* running_var,
                                    int N, int C, int HW, int act, double momentum, double eps,
                                    cudaStream_t stream, BatchNormLaunchShape* shapes) {
  if (act != kBatchNormActNone && act != kBatchNormActRelu) return cudaErrorInvalidValue;
  const auto* x = reinterpret_cast<const __nv_bfloat16*>(x_bits);
  const auto* residual = reinterpret_cast<const __nv_bfloat16*>(residual_bits);
  auto* y = reinterpret_cast<__nv_bfloat16*>(y_bits);
  // the statistics: the two-pass design's partial and final launches on bfloat16 x
  const int slices = (int)batch_norm_slices(HW);
  const long long warps = (long long)C * N * slices;
  const unsigned blocks = (unsigned)((warps + bn::kWarps - 1) / bn::kWarps);
  const bool vec = HW % 4 == 0 && bn::aligned(x, 8);
  if (vec)
    batch_norm_stats_partial_kernel<__nv_bfloat16, true><<<blocks, bn::kThreads, 0, stream>>>(
        x, x, HW, partial, N, C, HW, slices, warps);
  else
    batch_norm_stats_partial_kernel<__nv_bfloat16, false><<<blocks, bn::kThreads, 0, stream>>>(
        x, x, HW, partial, N, C, HW, slices, warps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  shapes[0] = {(int)blocks, 1, bn::kThreads, 0, vec ? 8 : 2};
  const long long smem = (long long)N * sizeof(float2);
  batch_norm_stats_final_kernel<__nv_bfloat16><<<C, 32, smem, stream>>>(
      x, HW, partial, stats, running_mean, running_var, N, C, HW, slices, momentum, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  shapes[1] = {C, 1, 32, smem, 8};
  // the apply pass
  const bool vec8 = HW % 8 == 0 && bn::aligned16(x) && bn::aligned16(residual) &&
                    bn::aligned16(y);
  const int items = vec8 ? HW / 8 : HW;
  const int tpp = items >= kBatchNormApplyThreads ? kBatchNormApplyThreads : items;
  const int per = kBatchNormApplyThreads / tpp;
  const long long planes = (long long)N * C;
  const int chunks = (items + tpp - 1) / tpp;
  const long long apply_blocks = (planes + per - 1) / per * chunks;
  auto* kernel = vec8 ? &batch_norm_apply_bf16_kernel<true> : &batch_norm_apply_bf16_kernel<false>;
  kernel<<<(unsigned)apply_blocks, kBatchNormApplyThreads, 0, stream>>>(
      x, stats, stats + 2 * C, weight, bias, residual, y, planes, C, HW, tpp, chunks, act);
  if ((err = cudaGetLastError()) == cudaSuccess)
    shapes[2] = {(int)apply_blocks, 1, kBatchNormApplyThreads, 0, vec8 ? 16 : 2};
  return err;
}

cudaError_t batch_norm_forward(const BatchNormPlan& plan, const float* x, const float* weight,
                               const float* bias, const float* residual, const float* slope,
                               float* y, float* stats, double* partial, float* running_mean,
                               float* running_var, int N, int C, int HW, int act,
                               double momentum, double eps, cudaStream_t stream,
                               BatchNormLaunchShape* shapes) {
  if (plan.design == kBatchNormFused) {
    const bool vec = HW % 4 == 0 && bn::aligned16(x) && bn::aligned16(residual) &&
                     bn::aligned16(y);
    auto* kernel = vec ? &batch_norm_fwd_fused_kernel<true> : &batch_norm_fwd_fused_kernel<false>;
    return bn::launch(kernel, plan.blocks, plan.ranks, plan.threads, plan.smem, vec ? 16 : 4,
                      stream, shapes, x, weight, bias, residual, slope, y, stats, running_mean,
                      running_var, N, C, HW, plan.samples, plan.group, act, momentum, eps);
  }
  cudaError_t err = batch_norm_stats(x, partial, stats, running_mean, running_var, N, C, HW,
                                     momentum, eps, stream, shapes);
  if (err != cudaSuccess) return err;
  return batch_norm_apply(x, stats, stats + 2 * C, weight, bias, residual, slope, y, N, C, HW,
                          act, stream, shapes + 2);
}

}  // namespace tris
