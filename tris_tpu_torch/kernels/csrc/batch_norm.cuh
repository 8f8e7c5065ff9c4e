// What K13's kernels (batch_norm.cu, batch_norm_bwd.cu) share: the two-pass design's partition
// of a channel among warps (one per (channel, sample, slice of the sample's plane)); the fused
// design's staging of a rank's planes (cp.async.bulk on an mbarrier a plane), its lane groups
// and its cluster barriers; the fixed-order sums in double; the batch combine; and the
// per-element arithmetic of the norm and its activation, each product and sum rounded alone
// (__fmul_rn / __fadd_rn, so the compiler contracts nothing into an FMA) in the plain
// version's order.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "launchers.h"

namespace tris {
namespace bn {

namespace cg = cooperative_groups;

constexpr int kThreads = kBatchNormThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = kBatchNormSlice;

// Warp w of a launch over (channel, sample, slice): warp w = (c * N + n) * slices + slice
// (launchers.h); its elements are [e0, e1) of the plane x + plane.
struct SliceWarp {
  int c, n, e0, e1;
  long long plane;
};

__device__ __forceinline__ SliceWarp slice_warp(long long w, int N, int C, int HW, int slices) {
  SliceWarp s;
  const int sl = (int)(w % slices);
  const long long cn = w / slices;
  s.n = (int)(cn % N);
  s.c = (int)(cn / N);
  s.plane = ((long long)s.n * C + s.c) * HW;
  s.e0 = sl * kSlice;
  s.e1 = min(s.e0 + kSlice, HW);
  return s;
}

// The warp's sum of v on every lane, the lanes added in a fixed xor tree.
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A sample's mean and sum of squared deviations from its double sums of x - k and (x - k)^2
// over HW elements, each rounded once to float32.
__device__ __forceinline__ float2 sample_moments(double s1, double s2, double k, int HW) {
  const double d = __ddiv_rn(s1, (double)HW), dev = __dsub_rn(s2, __dmul_rn(s1, d));
  return make_float2((float)__dadd_rn(k, d), (float)(dev > 0.0 ? dev : 0.0));
}

// A channel's batch statistics from its N samples' (mean, squared deviations), in float32
// in batch order: mean = (sum m_n) / N, var = (sum q_n + HW * sum (m_n - mean)^2) / M; rstd
// in double, rounded once.
struct BatchStats {
  float mean, var, rstd;
};

__device__ __forceinline__ BatchStats combine_batch(const float2* mq, int N, int HW, double eps) {
  float s = mq[0].x, m2 = mq[0].y;
#pragma unroll 8
  for (int n = 1; n < N; ++n) {
    s = __fadd_rn(s, mq[n].x);
    m2 = __fadd_rn(m2, mq[n].y);
  }
  BatchStats b;
  b.mean = __fdiv_rn(s, (float)N);
  float between = 0.f;
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    const float t = __fsub_rn(mq[n].x, b.mean), t2 = __fmul_rn(t, t);
    between = n == 0 ? t2 : __fadd_rn(between, t2);
  }
  const long long M = (long long)N * HW;
  b.var = __fdiv_rn(__fadd_rn(m2, __fmul_rn((float)HW, between)), (float)M);
  b.rstd = (float)rsqrt((double)b.var + eps);
  return b;
}

// stats [3, C] at channel c, and the running buffers (unless null) moved in double from the
// float32 mean and the unbiased var, rounded once.
__device__ __forceinline__ void store_stats(const BatchStats& b, float* stats, float* rm,
                                            float* rv, int c, int C, long long M,
                                            double momentum) {
  stats[c] = b.mean;
  stats[C + c] = b.var;
  stats[2 * C + c] = b.rstd;
  if (rm != nullptr) {
    const double unbiased = (double)b.var * ((double)M / (double)(M > 1 ? M - 1 : 1));
    rm[c] = (float)((1.0 - momentum) * (double)rm[c] + momentum * (double)b.mean);
    rv[c] = (float)((1.0 - momentum) * (double)rv[c] + momentum * unbiased);
  }
}

// One channel's normalisation: with `norm`, x-hat = (x - mean) * rstd; without (the eval
// fold), x-hat = x. Then y = x-hat * w + b.
struct Channel {
  float mean, rstd, w, b;
  bool norm;
};

__device__ __forceinline__ Channel channel(const float* mean, const float* rstd,
                                           const float* w, const float* b, int c) {
  Channel p;
  p.norm = mean != nullptr;
  p.mean = p.norm ? mean[c] : 0.f;
  p.rstd = p.norm ? rstd[c] : 1.f;
  p.w = w[c];
  p.b = b[c];
  return p;
}

__device__ __forceinline__ float xhat(float x, const Channel& p) {
  return p.norm ? __fmul_rn(__fsub_rn(x, p.mean), p.rstd) : x;
}

__device__ __forceinline__ float affine(float xh, const Channel& p) {
  return __fadd_rn(__fmul_rn(xh, p.w), p.b);
}

// The activation of v (the norm's output plus the residual, where one is added).
__device__ __forceinline__ float activate(float v, int act, float a) {
  if (act == kBatchNormActRelu) return v < 0.f ? 0.f : v;
  if (act == kBatchNormActPrelu) return v >= 0.f ? v : __fmul_rn(a, v);
  return v;
}

// y of one element from its x (and residual r, 0 without one)
__device__ __forceinline__ float forward_one(float x, float r, bool has_res, const Channel& p,
                                             int act, float a) {
  float o = affine(xhat(x, p), p);
  if (has_res) o = __fadd_rn(o, r);
  return activate(o, act, a);
}

// The gradient at the norm's output (dz) from g = dL/dout: ReLU's mask from the output
// `o` (out > 0 exactly where the input of the ReLU is), PReLU's from the recomputed
// pre-activation y (the forward's bits), whose slope gradient gets g * y where y < 0.
__device__ __forceinline__ float grad_z(float g, float xh, float o, const Channel& p, int act,
                                        float a, double& dslope) {
  if (act == kBatchNormActRelu) return o > 0.f ? g : 0.f;
  if (act == kBatchNormActPrelu) {
    const float y = affine(xh, p);
    if (y >= 0.f) return g;
    dslope += (double)g * (double)y;
    return __fmul_rn(a, g);
  }
  return g;
}

// dx of one element from its dz and x-hat: (w * rstd) * ((dz - k1) - x-hat * k2) with the
// batch statistics' coefficients k1 = sum dz / M and k2 = sum dz x-hat / M; dz * w (the eval
// fold's a) without.
__device__ __forceinline__ float grad_x(float dz, float xh, const Channel& p, float k1,
                                        float k2) {
  if (!p.norm) return __fmul_rn(dz, p.w);
  return __fmul_rn(__fmul_rn(p.w, p.rstd), __fsub_rn(__fsub_rn(dz, k1), __fmul_rn(xh, k2)));
}

// Four (or one) elements from float32 or bfloat16 data as floats: one 16-byte (8-byte) load.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) { return load4_bf16(p); }
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

inline bool aligned(const void* p, unsigned bytes) {
  return p == nullptr || (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// ---- phase stamps ---------------------------------------------------------------------------

// A measurement build (nvcc -DTRIS_BN_STAMPS, tools/batch_norm_phases.py; never the
// extension) has thread 0 of each fused block write its phases' clock64 cycles into
// bn_stamps[block * kBnStamps + k]: 2 the copies issued, 3 its own samples summed (waiting
// for their copies included), 4 the channel's sums in (the cluster's barrier), 5 the
// combine, 6 the writes; 0 and 7 %globaltimer at entry and exit, 8 the SM. Without the flag
// the macros are nothing.
constexpr int kBnStamps = 9;
#ifdef TRIS_BN_STAMPS
static __device__ unsigned long long* bn_stamps;  // one a file: its setter sets it
__device__ __forceinline__ unsigned long long bn_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned bn_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define BN_SLOT(k) bn_stamps[(unsigned long long)blockIdx.x * kBnStamps + (k)]
#define BN_STAMP_ENTRY()                                 \
  long long bn_clock_ = clock64();                       \
  if (threadIdx.x == 0) BN_SLOT(0) = bn_globaltimer();
#define BN_PHASE(k)                                     \
  if (threadIdx.x == 0) {                               \
    const long long t_ = clock64();                     \
    BN_SLOT(k) = (unsigned long long)(t_ - bn_clock_);  \
    bn_clock_ = t_;                                     \
  }
#define BN_STAMP_EXIT()                                 \
  __syncthreads();                                      \
  BN_PHASE(6);                                          \
  if (threadIdx.x == 0) {                               \
    BN_SLOT(7) = bn_globaltimer();                      \
    BN_SLOT(8) = bn_smid();                             \
  }
#else
#define BN_STAMP_ENTRY()
#define BN_PHASE(k)
#define BN_STAMP_EXIT()
#endif

// ---- the fused design ----------------------------------------------------------------------

// A fused block's shared memory (launchers.h, batch_norm_fused_smem): the staged planes
// (`sets` sets of `samples` planes; backward: g's, then x's), the channel's exchanged sample
// sums, three double partials a warp, an mbarrier a staged sample and the channel's
// coefficients.
struct FusedSmem {
  float* stage;
  long long set;    // floats a set
  float2* moments;  // forward: [N] (mean, squared deviations)
  double* sums;     // backward: [N][3] (dz, dz x-hat, PReLU's g y)
  double* part;     // [warps][3]
  uint64_t* bars;   // [samples]
  float* coef;      // [4]
};

__device__ __forceinline__ FusedSmem fused_smem(unsigned char* base, int N, int HW, int samples,
                                                bool backward) {
  FusedSmem s;
  s.set = samples * batch_norm_pitch(HW);
  s.stage = reinterpret_cast<float*>(base);
  unsigned char* p = base + (backward ? 2 : 1) * s.set * 4;
  s.moments = reinterpret_cast<float2*>(p);
  s.sums = reinterpret_cast<double*>(p);
  p += (backward ? 24 : 8) * (long long)N;
  s.part = reinterpret_cast<double*>(p);
  p += 24 * (blockDim.x / 32);
  s.bars = reinterpret_cast<uint64_t*>(p);
  p += 8 * samples;
  s.coef = reinterpret_cast<float*>(p);
  return s;
}

// Rank r of R stages samples [first, first + count) of the batch.
__device__ __forceinline__ int rank_first(int rank, int R, int N) {
  return (int)((long long)rank * N / R);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16) from device memory at src to shared memory at dst (both 16-byte
// aligned) by the copy engine (TMA's 1-D copy), completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The cluster's barrier: relaxed (this block has started), or releasing this block's writes
// (to its own and the other ranks' shared memory) to every block's wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Warp 0: the rank's samples [first, first + count) of a channel, `sets` planes each
// (planes[k] + n * nstride), copied by the copy engine to buf + k * set + i * pitch, sample
// i's on its mbarrier bars[i], which lane i % 32 initialises and issues. kVec only: HW % 4 ==
// 0 and every plane 16-byte aligned. The block's barrier follows.
__device__ __forceinline__ void issue_planes(const float* const* planes, int sets, float* buf,
                                             long long set, uint64_t* bars, int first,
                                             int count, long long nstride, int HW) {
  const long long pitch = batch_norm_pitch(HW);
  if (threadIdx.x >= 32) return;
  for (int i = threadIdx.x; i < count; i += 32) mbar_init(&bars[i], 1);
  mbar_fence_init();
  for (int i = threadIdx.x; i < count; i += 32) {
    mbar_expect(&bars[i], (unsigned)(sets * HW * 4));
    for (int k = 0; k < sets; ++k)
      bulk_load(buf + k * set + i * pitch, planes[k] + (first + i) * nstride, (unsigned)(HW * 4),
                &bars[i]);
  }
}

// The block: the same planes by 4-byte loads, then a block barrier.
__device__ __forceinline__ void load_planes(const float* const* planes, int sets, float* buf,
                                            long long set, int first, int count,
                                            long long nstride, int HW) {
  const long long pitch = batch_norm_pitch(HW), total = (long long)count * HW;
  for (long long j = threadIdx.x; j < total; j += blockDim.x) {
    const int i = (int)(j / HW), e = (int)(j - (long long)i * HW);
    for (int k = 0; k < sets; ++k)
      buf[k * set + i * pitch + e] = planes[k][(first + i) * nstride + e];
  }
  __syncthreads();
}

// The sums of one sample's group of `group` lanes (a power of two) on each lane of it, three
// at a time: within a warp an xor tree from min(group, 32) / 2 down to 1; a group of several
// warps then adds its warps' totals in warp order (through part, with two block barriers:
// every thread of the block calls it alike).
__device__ __forceinline__ void group_sums(double (&v)[3], int group, double* part) {
  const int width = group < 32 ? group : 32;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    for (int o = width / 2; o > 0; o >>= 1)
      v[k] = __dadd_rn(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
  if (group <= 32) return;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0)
    for (int k = 0; k < 3; ++k) part[3 * warp + k] = v[k];
  __syncthreads();
  const int first = (threadIdx.x / group) * (group / 32);
  for (int k = 0; k < 3; ++k) {
    double t = part[3 * first + k];
    for (int j = 1; j < group / 32; ++j) t = __dadd_rn(t, part[3 * (first + j) + k]);
    v[k] = t;
  }
  __syncthreads();
}

// Opt `kernel` in to `smem` bytes and, for clusters past 8 blocks, to non-portable ones.
template <typename Kernel>
cudaError_t allow_cluster(Kernel kernel, int cluster, long long smem) {
  cudaError_t err = allow_smem(kernel, (size_t)smem);
  if (err == cudaSuccess && cluster > kBatchNormMaxRanks)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// How many clusters of `cluster` blocks of `threads` with `smem` bytes each the card runs at
// once (cudaOccupancyMaxActiveClusters; 0 where it runs none or refuses the question).
template <typename Kernel>
int resident_clusters(Kernel kernel, int cluster, int threads, long long smem) {
  int n = 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (allow_cluster(kernel, cluster, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// A launch of `kernel` on `blocks` blocks of `threads` in clusters of `cluster` along x with
// `smem` bytes of dynamic shared memory, *shape completed once CUDA has taken it.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int blocks, int cluster, int threads,
                   long long smem, int load_bytes, cudaStream_t stream,
                   BatchNormLaunchShape* shape, Args... args) {
  cudaError_t err = allow_cluster(kernel, cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && shape != nullptr)
    *shape = {blocks, cluster, threads, smem, load_bytes};
  return err;
}


}  // namespace bn
}  // namespace tris
