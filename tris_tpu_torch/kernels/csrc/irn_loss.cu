// K8: IRNet's affinity and displacement losses as masked sums, with the
// pair labels built on the fly, forward and backward.
//
// Replaces tris_tpu/pseudo/train_irn.py::affinity_labels_on_device (line
// 91) and the masked sums of irn_loss (lines 127-157), with the loss fields
// of tris_tpu/pseudo/irnet.py::affinity_displacement_losses (lines
// 197-221). For an entry (b, d, r, c) of the pair window (direction d with
// search offset (dy, dx), source pixel (r, rf + c), destination (r + dy,
// rf + c + dx)) of the quarter-scale ir label map L (0 bg, 1 fg, 255
// ignore):
//   valid = L[src] < max_valid && L[dst] < max_valid;  equal = L[src] == L[dst]
//   bg = valid && equal && L[src] == 0;  fg = valid && equal && L[src] > 0
//   neg = valid && !equal
// and with p_k = dp[b, k, src] - dp[b, k, dst] the pair displacement:
//   sums[0] = sum bg  * -log(aff + eps)       sums[1] = sum fg * -log(aff + eps)
//   sums[2] = sum neg * -log(1 + eps - aff)
//   sums[3] = sum fg  * (|p_0 - dy| + |p_1 - dx|)   sums[4] = sum bg * (|p_0| + |p_1|)
//   counts  = (sum bg, sum fg, sum neg), in integers
// The three masks, the two loss fields and the two [B, 2, n_dirs, n_pairs]
// pair-displacement fields are never written to memory. The counts are
// integers: at B = 24 a mask has 47.7 M entries, beyond float32's exact
// integers. The caller turns sums and counts into IRN's five losses.
//
// Forward, two launches: per block, each thread sums its entries in float
// and the block adds the threads' sums in double in a fixed tree; one final
// block adds the blocks' partials in a fixed order. The grid depends on the
// problem size alone, so the result is the same run to run.
//
// Backward, two launches, from the gradients of the five sums (read on the
// device): d aff per entry (one thread each); d dp per pixel (one thread
// each), a gather over the directions: the pixel is the source of every
// direction's pair at (r, c) = (y, x - rf) and the destination of the pair
// at (y - dy, x - rf - dx), each where it lies in the window. Fixed order,
// no atomics. abs' derivative is sign(), 0 at 0, as JAX's and torch's.
//
// Shapes on the IRN training step (crop 512, radius 10, B = 24): labels u8
// [24, 128, 128], aff [24, 152, 119, 110], dp [24, 2, 128, 128].
//
// Bound: bytes - aff read once (191 MB) and, backward, d aff written once;
// the labels (393 KB) and dp (3.1 MB) are read from L1/L2 at every entry.
// Design: consecutive threads on consecutive window columns, so the reads
// of aff, the labels and dp coalesce.

#include <math.h>

#include "launchers.h"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // entries per thread in the forward's first pass

struct Entry {
  long long src, dst;  // flat pixel offsets within one image's [H, W] plane
  int dy, dx;
  bool bg, fg, neg;
};

__device__ __forceinline__ Entry entry(const unsigned char* __restrict__ lab, int W, int r, int c,
                                       int rf, int dy, int dx, int max_valid) {
  Entry e;
  e.dy = dy;
  e.dx = dx;
  e.src = (long long)r * W + rf + c;
  e.dst = (long long)(r + dy) * W + rf + c + dx;
  const int a = lab[e.src], b = lab[e.dst];
  const bool valid = a < max_valid && b < max_valid, equal = a == b;
  e.bg = valid && equal && a == 0;
  e.fg = valid && equal && a > 0;
  e.neg = valid && !equal;
  return e;
}

__device__ __forceinline__ float sgn(float v) { return (float)((v > 0.f) - (v < 0.f)); }

__global__ void __launch_bounds__(kThreads)
irn_loss_partial_kernel(const unsigned char* __restrict__ labels, const float* __restrict__ aff,
                        const float* __restrict__ dp, const int* __restrict__ dirs,
                        double* __restrict__ psum, long long* __restrict__ pcount,
                        long long n, int H, int W, int rf, int n_dirs, int ch, int cw, float eps,
                        float one_eps, int max_valid) {
  __shared__ double sred[5][kThreads];
  __shared__ long long cred[3][kThreads];
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  int cnt[3] = {0, 0, 0};
  const long long hw = (long long)H * W;
  const long long first = (long long)blockIdx.x * kThreads * kItems + threadIdx.x;
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + (long long)k * kThreads;
    if (i >= n) break;
    const int c = (int)(i % cw);
    long long t = i / cw;
    const int r = (int)(t % ch);
    t /= ch;
    const int d = (int)(t % n_dirs);
    const long long b = t / n_dirs;
    const Entry e =
        entry(labels + b * hw, W, r, c, rf, dirs[2 * d], dirs[2 * d + 1], max_valid);
    if (!(e.bg || e.fg || e.neg)) continue;
    const float a = aff[i];
    if (e.neg) {
      s[2] += -logf(__fsub_rn(one_eps, a));
      ++cnt[2];
      continue;
    }
    const float pos = -logf(__fadd_rn(a, eps));
    const float* d0 = dp + b * 2 * hw;
    const float p0 = __fsub_rn(d0[e.src], d0[e.dst]);
    const float p1 = __fsub_rn(d0[hw + e.src], d0[hw + e.dst]);
    if (e.fg) {
      s[1] += pos;
      s[3] += fabsf(__fsub_rn(p0, (float)e.dy)) + fabsf(__fsub_rn(p1, (float)e.dx));
      ++cnt[1];
    } else {
      s[0] += pos;
      s[4] += fabsf(p0) + fabsf(p1);
      ++cnt[0];
    }
  }
  for (int j = 0; j < 5; ++j) sred[j][threadIdx.x] = s[j];
  for (int j = 0; j < 3; ++j) cred[j][threadIdx.x] = cnt[j];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      for (int j = 0; j < 5; ++j) sred[j][threadIdx.x] += sred[j][threadIdx.x + half];
      for (int j = 0; j < 3; ++j) cred[j][threadIdx.x] += cred[j][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x < 5) psum[blockIdx.x * 5 + threadIdx.x] = sred[threadIdx.x][0];
  if (threadIdx.x < 3) pcount[blockIdx.x * 3 + threadIdx.x] = cred[threadIdx.x][0];
}

// One block: the blocks' partials, each thread a fixed stride of them, then
// the same fixed tree.
__global__ void __launch_bounds__(kThreads)
irn_loss_final_kernel(const double* __restrict__ psum, const long long* __restrict__ pcount,
                      int blocks, float* __restrict__ sums, long long* __restrict__ counts) {
  __shared__ double sred[5][kThreads];
  __shared__ long long cred[3][kThreads];
  double s[5] = {0, 0, 0, 0, 0};
  long long cnt[3] = {0, 0, 0};
  for (int blk = threadIdx.x; blk < blocks; blk += kThreads) {
    for (int j = 0; j < 5; ++j) s[j] += psum[blk * 5 + j];
    for (int j = 0; j < 3; ++j) cnt[j] += pcount[blk * 3 + j];
  }
  for (int j = 0; j < 5; ++j) sred[j][threadIdx.x] = s[j];
  for (int j = 0; j < 3; ++j) cred[j][threadIdx.x] = cnt[j];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      for (int j = 0; j < 5; ++j) sred[j][threadIdx.x] += sred[j][threadIdx.x + half];
      for (int j = 0; j < 3; ++j) cred[j][threadIdx.x] += cred[j][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x < 5) sums[threadIdx.x] = (float)sred[threadIdx.x][0];
  if (threadIdx.x < 3) counts[threadIdx.x] = cred[threadIdx.x][0];
}

__global__ void __launch_bounds__(kThreads)
irn_loss_daff_kernel(const unsigned char* __restrict__ labels, const float* __restrict__ aff,
                     const int* __restrict__ dirs, const float* __restrict__ gsum,
                     float* __restrict__ daff, long long n, int H, int W, int rf, int n_dirs,
                     int ch, int cw, float eps, float one_eps, int max_valid) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % cw);
  long long t = i / cw;
  const int r = (int)(t % ch);
  t /= ch;
  const int d = (int)(t % n_dirs);
  const long long b = t / n_dirs;
  const Entry e = entry(labels + b * (long long)H * W, W, r, c, rf, dirs[2 * d], dirs[2 * d + 1],
                        max_valid);
  float v = 0.f;
  if (e.neg) v = __fdiv_rn(gsum[2], __fsub_rn(one_eps, aff[i]));
  else if (e.bg || e.fg) v = -__fdiv_rn(gsum[e.bg ? 0 : 1], __fadd_rn(aff[i], eps));
  daff[i] = v;
}

__global__ void __launch_bounds__(kThreads)
irn_loss_ddp_kernel(const unsigned char* __restrict__ labels, const float* __restrict__ dp,
                    const int* __restrict__ dirs, const float* __restrict__ gsum,
                    float* __restrict__ ddp, long long n_pix, int H, int W, int rf, int n_dirs,
                    int ch, int cw, int max_valid) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n_pix) return;
  const int x = (int)(i % W);
  const long long t = i / W;
  const int y = (int)(t % H);
  const long long b = t / H, hw = (long long)H * W;
  const unsigned char* lab = labels + b * hw;
  const float* d0 = dp + b * 2 * hw;
  const float g_fg = gsum[3], g_bg = gsum[4];
  float acc0 = 0.f, acc1 = 0.f;
  // d pair_k of one entry, added with `sign` (+1 at the source, -1 at the destination)
  auto add = [&](const Entry& e, float sign) {
    if (!(e.bg || e.fg)) return;
    const float p0 = __fsub_rn(d0[e.src], d0[e.dst]);
    const float p1 = __fsub_rn(d0[hw + e.src], d0[hw + e.dst]);
    float g0, g1;
    if (e.fg) {
      g0 = g_fg * sgn(__fsub_rn(p0, (float)e.dy));
      g1 = g_fg * sgn(__fsub_rn(p1, (float)e.dx));
    } else {
      g0 = g_bg * sgn(p0);
      g1 = g_bg * sgn(p1);
    }
    acc0 = __fadd_rn(acc0, sign * g0);
    acc1 = __fadd_rn(acc1, sign * g1);
  };
  const int cs = x - rf;
  for (int d = 0; d < n_dirs; ++d) {
    const int dy = dirs[2 * d], dx = dirs[2 * d + 1];
    if (y < ch && cs >= 0 && cs < cw) add(entry(lab, W, y, cs, rf, dy, dx, max_valid), 1.f);
    const int r = y - dy, c = cs - dx;
    if (r >= 0 && r < ch && c >= 0 && c < cw) add(entry(lab, W, r, c, rf, dy, dx, max_valid), -1.f);
  }
  ddp[b * 2 * hw + (long long)y * W + x] = acc0;
  ddp[b * 2 * hw + hw + (long long)y * W + x] = acc1;
}

unsigned grid(long long n, long long per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

int tris::irn_loss_blocks(int64_t n) { return (int)grid(n, (long long)kThreads * kItems); }

cudaError_t tris::irn_loss(const unsigned char* labels, const float* aff, const float* dp,
                           const int* dirs, double* psum, long long* pcount, float* sums,
                           long long* counts, int64_t B, int H, int W, int rf, int n_dirs,
                           float eps, float one_eps, int max_valid, cudaStream_t stream) {
  const int ch = H - rf, cw = W - 2 * rf;
  const long long n = B * n_dirs * (long long)ch * cw;
  const int blocks = irn_loss_blocks(n);
  if (blocks > 0) {
    irn_loss_partial_kernel<<<blocks, kThreads, 0, stream>>>(labels, aff, dp, dirs, psum, pcount, n,
                                                             H, W, rf, n_dirs, ch, cw, eps,
                                                             one_eps, max_valid);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  irn_loss_final_kernel<<<1, kThreads, 0, stream>>>(psum, pcount, blocks, sums, counts);
  return cudaGetLastError();
}

cudaError_t tris::irn_loss_bwd(const unsigned char* labels, const float* aff, const float* dp,
                               const int* dirs, const float* gsum, float* daff, float* ddp,
                               int64_t B, int H, int W, int rf, int n_dirs, float eps,
                               float one_eps, int max_valid, cudaStream_t stream) {
  const int ch = H - rf, cw = W - 2 * rf;
  const long long n = B * n_dirs * (long long)ch * cw, n_pix = B * H * (long long)W;
  if (n_pix <= 0) return cudaSuccess;
  if (n > 0) {
    irn_loss_daff_kernel<<<grid(n, kThreads), kThreads, 0, stream>>>(
        labels, aff, dirs, gsum, daff, n, H, W, rf, n_dirs, ch, cw, eps, one_eps, max_valid);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  irn_loss_ddp_kernel<<<grid(n_pix, kThreads), kThreads, 0, stream>>>(labels, dp, dirs, gsum, ddp,
                                                                      n_pix, H, W, rf, n_dirs, ch,
                                                                      cw, max_valid);
  return cudaGetLastError();
}
