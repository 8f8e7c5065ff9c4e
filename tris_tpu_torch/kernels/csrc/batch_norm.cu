// K13: BatchNorm with the activation that follows it, forward: the batch statistics (two
// launches) and the apply pass (one launch).
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
// forward; stage 2's decoder [48, 32..512, 10^2..80^2].
//
// Statistics, the same sums in the same order as the plain version
// (kernels/batch_norm.py::batch_stats_plain): each sample's plane gives its mean m_n and
// sum of squared deviations q_n in double (from sums of x - k and (x - k)^2, k = x[0, c, 0]
// a shift that keeps the squares from cancelling), each rounded once to float32; then in
// float32, the samples in batch order: mean = (sum m_n) / N and var = (sum q_n + HW *
// sum (m_n - mean)^2) / M; rstd = 1 / sqrt(var + eps) in double, rounded once. A sample's
// moments are exact to float32; the batch combine keeps float32's dependence on the batch
// order, as torch's and the JAX package's statistics have (the train checks' noise floor
// reverses the batch). batch_norm_stats_partial_kernel: a warp per (channel, sample,
// slice of its plane) (launchers.h) sums in double, the lanes in a fixed tree, and writes
// partial[c][n][slice]. batch_norm_stats_final_kernel: a warp per channel adds each
// sample's slices in order, then one lane combines the samples as above; with `update` it moves
// the running buffers in double from the float32 mean and var, rounded once. No atomics:
// the same bits run to run. The two kernels are apart so that a cross-rank combine of the
// samples' moments can go between them.
//
// Apply: a thread per 4 elements (float4; per element where HW % 4 != 0 or a pointer is not
// 16-byte aligned), each product and sum rounded alone in the plain version's order: given
// the same mean and rstd it gives the plain route's bits, and the eval fold gives them
// exactly.
//
// Bound: bytes. Statistics read x once; apply reads x (and the residual) and writes y.

#include "batch_norm.cuh"

namespace {

using namespace tris::bn;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
batch_norm_stats_partial_kernel(const float* __restrict__ x, double* __restrict__ partial, int N,
                                int C, int HW, int slices, long long warps) {
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= warps) return;
  const int lane = threadIdx.x % 32;
  const SliceWarp sw = slice_warp(w, N, C, HW, slices);
  const double k = x[(long long)sw.c * HW];
  const float* plane = x + sw.plane;
  const int e0 = sw.e0, e1 = sw.e1;
  double s1 = 0.0, s2 = 0.0;
  if (kVec) {
    for (int e = e0 + 4 * lane; e < e1; e += 4 * 32) {
      const float4 v = *reinterpret_cast<const float4*>(plane + e);
      const double d0 = (double)v.x - k, d1 = (double)v.y - k, d2 = (double)v.z - k,
                   d3 = (double)v.w - k;
      s1 += (d0 + d1) + (d2 + d3);
      s2 += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  } else {
    for (int e = e0 + lane; e < e1; e += 32) {
      const double d = (double)plane[e] - k;
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

// Sample n's mean and sum of squared deviations from it, in double from its slices'
// shifted sums, each rounded once to float32.
__device__ __forceinline__ void sample_moments(const double* q, int slices, double k, int HW,
                                               float& mean, float& m2) {
  double s1 = 0.0, s2 = 0.0;
  for (int sl = 0; sl < slices; ++sl) {
    s1 += q[2 * sl];
    s2 += q[2 * sl + 1];
  }
  const double d = s1 / (double)HW, dev = s2 - s1 * d;
  mean = (float)(k + d);
  m2 = (float)(dev > 0.0 ? dev : 0.0);
}

// A warp per channel: the lanes form the samples' moments (sample n on lane n % 32) into
// shared memory, then lane 0 combines them in batch order.
__global__ void __launch_bounds__(32)
batch_norm_stats_final_kernel(const float* __restrict__ x, const double* __restrict__ partial,
                              float* __restrict__ stats, float* __restrict__ rm,
                              float* __restrict__ rv, int N, int C, int HW, int slices,
                              double momentum, double eps) {
  extern __shared__ float moments[];                  // m[N], then q[N]
  const int c = blockIdx.x;
  const double k = x[(long long)c * HW];
  const double* q = partial + 2 * (long long)c * N * slices;
  for (int n = threadIdx.x; n < N; n += 32)
    sample_moments(q + 2 * (long long)n * slices, slices, k, HW, moments[n], moments[N + n]);
  __syncwarp();
  if (threadIdx.x != 0) return;
  float s = moments[0], m2 = moments[N];              // the batch in order, in float32
  for (int n = 1; n < N; ++n) {
    s = __fadd_rn(s, moments[n]);
    m2 = __fadd_rn(m2, moments[N + n]);
  }
  const float mean = __fdiv_rn(s, (float)N);
  float between = 0.f;
  for (int n = 0; n < N; ++n) {
    const float t = __fsub_rn(moments[n], mean), t2 = __fmul_rn(t, t);
    between = n == 0 ? t2 : __fadd_rn(between, t2);
  }
  const long long M = (long long)N * HW;
  const float var = __fdiv_rn(__fadd_rn(m2, __fmul_rn((float)HW, between)), (float)M);
  stats[c] = mean;
  stats[C + c] = var;
  stats[2 * C + c] = (float)rsqrt((double)var + eps);
  if (rm != nullptr) {
    const double unbiased = (double)var * ((double)M / (double)(M > 1 ? M - 1 : 1));
    rm[c] = (float)((1.0 - momentum) * (double)rm[c] + momentum * (double)mean);
    rv[c] = (float)((1.0 - momentum) * (double)rv[c] + momentum * unbiased);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
batch_norm_apply_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                        const float* __restrict__ rstd, const float* __restrict__ w,
                        const float* __restrict__ b, const float* __restrict__ res,
                        const float* __restrict__ slope, float* __restrict__ y, long long total,
                        int C, int HW, int act) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * (kVec ? 4 : 1);
  if (i >= total) return;
  const int c = (int)(((unsigned)i / (unsigned)HW) % (unsigned)C);
  const Channel p = channel(mean, rstd, w, b, c);
  const float a = slope != nullptr ? *slope : 0.f;
  if (kVec) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    float4 o = make_float4(affine(xhat(v.x, p), p), affine(xhat(v.y, p), p),
                           affine(xhat(v.z, p), p), affine(xhat(v.w, p), p));
    if (res != nullptr) {
      const float4 r = *reinterpret_cast<const float4*>(res + i);
      o = make_float4(__fadd_rn(o.x, r.x), __fadd_rn(o.y, r.y), __fadd_rn(o.z, r.z),
                      __fadd_rn(o.w, r.w));
    }
    *reinterpret_cast<float4*>(y + i) = make_float4(activate(o.x, act, a), activate(o.y, act, a),
                                                    activate(o.z, act, a), activate(o.w, act, a));
  } else {
    float o = affine(xhat(x[i], p), p);
    if (res != nullptr) o = __fadd_rn(o, res[i]);
    y[i] = activate(o, act, a);
  }
}

}  // namespace

namespace tris {

cudaError_t batch_norm_stats(const float* x, double* partial, float* stats, float* running_mean,
                             float* running_var, int N, int C, int HW, double momentum,
                             double eps, cudaStream_t stream) {
  const int slices = (int)batch_norm_slices(HW);
  const long long warps = (long long)C * N * slices;
  const unsigned blocks = (unsigned)((warps + bn::kWarps - 1) / bn::kWarps);
  if (HW % 4 == 0 && bn::aligned16(x))
    batch_norm_stats_partial_kernel<true><<<blocks, bn::kThreads, 0, stream>>>(
        x, partial, N, C, HW, slices, warps);
  else
    batch_norm_stats_partial_kernel<false><<<blocks, bn::kThreads, 0, stream>>>(
        x, partial, N, C, HW, slices, warps);
  batch_norm_stats_final_kernel<<<C, 32, 2 * N * sizeof(float), stream>>>(
      x, partial, stats, running_mean, running_var, N, C, HW, slices, momentum, eps);
  return cudaGetLastError();
}

cudaError_t batch_norm_apply(const float* x, const float* mean, const float* rstd,
                             const float* weight, const float* bias, const float* residual,
                             const float* slope, float* y, int N, int C, int HW, int act,
                             cudaStream_t stream) {
  const long long total = (long long)N * C * HW;
  const bool vec = HW % 4 == 0 && bn::aligned16(x) && bn::aligned16(residual) &&
                   bn::aligned16(y);
  const long long items = vec ? total / 4 : total;
  const unsigned blocks = (unsigned)((items + bn::kThreads - 1) / bn::kThreads);
  if (vec)
    batch_norm_apply_kernel<true><<<blocks, bn::kThreads, 0, stream>>>(
        x, mean, rstd, weight, bias, residual, slope, y, total, C, HW, act);
  else
    batch_norm_apply_kernel<false><<<blocks, bn::kThreads, 0, stream>>>(
        x, mean, rstd, weight, bias, residual, slope, y, total, C, HW, act);
  return cudaGetLastError();
}

}  // namespace tris
