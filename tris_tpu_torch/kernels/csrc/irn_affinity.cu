// K7 + K8: IRNet's affinity and displacement losses as masked sums straight from the edge map,
// forward and backward; the pair affinities never reach device memory.
//
// Replaces, fused, tris_tpu/pseudo/indexing.py:110 path_max_affinity_slices (K7: aff = 1 -
// the max of the edge map along each pair's path), tris_tpu/pseudo/train_irn.py:91
// affinity_labels_on_device and the masked sums of irn_loss (:127-157) (K8), with the loss
// fields of tris_tpu/pseudo/irnet.py:197-221 affinity_displacement_losses. For the pair (d, r,
// c) of direction d with destination (dy, dx) (its path's first step), source (r, rf + c) and
// destination (r + dy, rf + c + dx) of the quarter-scale ir label map L (0 bg, 1 fg, 255
// ignore):
//   valid = L[src] < max_valid && L[dst] < max_valid;  equal = L[src] == L[dst]
//   bg = valid && equal && L[src] == 0;  fg = valid && equal && L[src] > 0
//   neg = valid && !equal
// and with p_k = dp[b, k, src] - dp[b, k, dst] the pair displacement:
//   sums[0] = sum bg  * -log(aff + eps)       sums[1] = sum fg * -log(aff + eps)
//   sums[2] = sum neg * -log(1 + eps - aff)
//   sums[3] = sum fg  * (|p_0 - dy| + |p_1 - dx|)   sums[4] = sum bg * (|p_0| + |p_1|)
//   counts  = (sum bg, sum fg, sum neg), in integers
// (at B = 24 a mask has 47.7 M pairs, beyond float32's exact integers). Every term is
// formed in float as the JAX package's loss fields are; the caller turns sums and counts
// into IRN's five losses.
//
// Forward, two launches: a block per image tile of kPathTileCols x tile_rows source pixels
// (launchers.h::path_tile_plan, kPathLossForward) stages the edge map, the labels and dp
// over the tile plus rf rows below and rf columns each side, then each thread takes its
// rpt source pixels through every direction in table order: the path max from shared
// memory (the step's offset read from the table's copy in shared memory, the same for the
// whole warp), aff = 1 - m (__fsub_rn, as K7), the pair's class and terms. A thread adds its terms
// in double, the block its threads' sums in double in a fixed tree; one final block adds the
// blocks' partials in a fixed order. The result is the same run to run.
//
// Backward, one launch: path_max_tiles.cuh's gather, the pairs' cotangent d aff formed from
// the staged labels (as K8's d aff: gsum[2] / (1 + eps - aff) for a negative pair,
// -gsum[0 or 1] / (aff + eps) for a bg or fg one), and d dp gathered at each pixel beside it.
// abs' slope is the JAX package's: 1 where the difference is >= 0, exact zeros included, and
// -1 below (torch's abs would take 0 at 0); the plain version's loss fields take the same.
//
// Shapes on the IRN training step (crop 512, radius 10, B = 24): labels u8 [24, 128, 128],
// edge [24, 128, 128], dp [24, 2, 128, 128], 152 directions, 2134 path steps, the pair window
// 119 x 110: 47.7 M pairs, 670 M path steps.
//
// Bound: the inputs (5.1 MB) are read once and little is written, so the bound is the path
// steps' maxima: operations. What the design meets first is shared memory's rate, one 4-byte
// load a path step a pair (forward) and, backward, one a pair's step and one a pixel's.

#include <math.h>

#include "path_max_tiles.cuh"

namespace {

using tris::kPathThreads;
using tris::kPathTileCols;

// lane 0 of each warp gets the warp's sum, added in a fixed order
template <typename T>
__device__ __forceinline__ T warp_sum_down(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int RPT>
__global__ void __launch_bounds__(kPathThreads)
irn_affinity_loss_kernel(const __grid_constant__ tris::PathTable t,
                         const unsigned char* __restrict__ labels, const float* __restrict__ edge,
                         const float* __restrict__ dp, double* __restrict__ psum,
                         long long* __restrict__ pcount, int H, int W, int rf, int tiles_y,
                         int tiles_x, float eps, float one_eps, int max_valid) {
  constexpr int kWarps = kPathThreads / kPathTileCols, TR = kWarps * RPT;
  const int P = kPathTileCols + 2 * rf, SR = TR + rf, ch = H - rf, cw = W - 2 * rf;
  extern __shared__ __align__(16) unsigned char smem[];
  const short* soff = tris::stage_offsets(smem, t);
  float* se = reinterpret_cast<float*>(smem + 2 * tris::kPathTableSteps);  // [SR, P] edge map
  float* sd0 = se + SR * P;                     // [SR, P] x 2 dp
  float* sd1 = sd0 + SR * P;
  unsigned char* sl = reinterpret_cast<unsigned char*>(sd1 + SR * P);  // [SR, P] labels
  __shared__ double wsum[kWarps][5];
  __shared__ long long wcount[kWarps][3];

  const int tx = blockIdx.x % tiles_x, ty = blockIdx.x / tiles_x % tiles_y;
  const long long b = blockIdx.x / (tiles_x * tiles_y), hw = (long long)H * W;
  const int r0 = ty * TR, c0 = tx * kPathTileCols;  // the tile's first pair (r0, c0)
  tris::stage_tile(se, edge + b * hw, H, W, r0, c0, SR, P, NAN);
  tris::stage_tile(sd0, dp + 2 * b * hw, H, W, r0, c0, SR, P, 0.f);
  tris::stage_tile(sd1, dp + 2 * b * hw + hw, H, W, r0, c0, SR, P, 0.f);
  tris::stage_tile(sl, labels + b * hw, H, W, r0, c0, SR, P, (unsigned char)255);
  __syncthreads();

  const int lane = threadIdx.x % kPathTileCols, wrow = threadIdx.x / kPathTileCols;
  int pix[RPT], la[RPT];
  bool valid[RPT];
  float a0[RPT], a1[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int row = wrow + kWarps * k;
    pix[k] = row * P + rf + lane;  // the source pixel of the pair (r0 + row, c0 + lane)
    valid[k] = r0 + row < ch && c0 + lane < cw;
    la[k] = sl[pix[k]];
    a0[k] = sd0[pix[k]];
    a1[k] = sd1[pix[k]];
  }
  double s[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  int cnt[3] = {0, 0, 0};
  for (int d = 0; d < t.n_dirs; ++d) {
    const int begin = t.begin[d], end = t.begin[d + 1], doff = soff[begin];
    float m[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) m[k] = -INFINITY;
    for (int i = begin; i < end; ++i) {
      const int o = soff[i];
#pragma unroll
      for (int k = 0; k < RPT; ++k) m[k] = fmaxf(m[k], se[pix[k] + o]);
    }
    const float fdy = t.dst_dy[d], fdx = t.dst_dx[d];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {  // every term formed, the pair's class picks (no branches)
      const int j = pix[k] + doff;
      const int cls = valid[k] ? tris::pair_class(la[k], sl[j], max_valid) : 0;
      const float a = __fsub_rn(1.f, m[k]);
      const float lg = -logf(cls == 3 ? __fsub_rn(one_eps, a) : __fadd_rn(a, eps));
      const float p0 = __fsub_rn(a0[k], sd0[j]), p1 = __fsub_rn(a1[k], sd1[j]);
      const float d_fg = fabsf(__fsub_rn(p0, fdy)) + fabsf(__fsub_rn(p1, fdx));
      const float d_bg = fabsf(p0) + fabsf(p1);
      if (cls == 1) {
        s[0] += (double)lg;
        s[4] += (double)d_bg;
        ++cnt[0];
      } else if (cls == 2) {
        s[1] += (double)lg;
        s[3] += (double)d_fg;
        ++cnt[1];
      } else if (cls == 3) {
        s[2] += (double)lg;
        ++cnt[2];
      }
    }
  }

  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 5; ++j) s[j] = warp_sum_down(s[j]);
  long long c[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) c[j] = warp_sum_down((long long)cnt[j]);
  if (threadIdx.x % 32 == 0) {
    for (int j = 0; j < 5; ++j) wsum[warp][j] = s[j];
    for (int j = 0; j < 3; ++j) wcount[warp][j] = c[j];
  }
  __syncthreads();
  if (threadIdx.x < 5) {
    double total = 0.0;
    for (int w = 0; w < kWarps; ++w) total += wsum[w][threadIdx.x];
    psum[blockIdx.x * 5LL + threadIdx.x] = total;
  } else if (threadIdx.x < 8) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += wcount[w][threadIdx.x - 5];
    pcount[blockIdx.x * 3LL + threadIdx.x - 5] = total;
  }
}

// One block: the blocks' partials, each thread a fixed stride of them, then a fixed tree.
__global__ void __launch_bounds__(kPathThreads)
irn_affinity_loss_final_kernel(const double* __restrict__ psum,
                               const long long* __restrict__ pcount, long long blocks,
                               float* __restrict__ sums, long long* __restrict__ counts) {
  __shared__ double sred[5][kPathThreads];
  __shared__ long long cred[3][kPathThreads];
  double s[5] = {0, 0, 0, 0, 0};
  long long cnt[3] = {0, 0, 0};
  for (long long blk = threadIdx.x; blk < blocks; blk += kPathThreads) {
    for (int j = 0; j < 5; ++j) s[j] += psum[blk * 5 + j];
    for (int j = 0; j < 3; ++j) cnt[j] += pcount[blk * 3 + j];
  }
  for (int j = 0; j < 5; ++j) sred[j][threadIdx.x] = s[j];
  for (int j = 0; j < 3; ++j) cred[j][threadIdx.x] = cnt[j];
  __syncthreads();
  for (int half = kPathThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      for (int j = 0; j < 5; ++j) sred[j][threadIdx.x] += sred[j][threadIdx.x + half];
      for (int j = 0; j < 3; ++j) cred[j][threadIdx.x] += cred[j][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x < 5) sums[threadIdx.x] = (float)sred[threadIdx.x][0];
  if (threadIdx.x < 3) counts[threadIdx.x] = cred[threadIdx.x][0];
}

}  // namespace

cudaError_t tris::irn_affinity_loss(const PathTilePlan& plan, const PathSteps& table,
                                    const unsigned char* labels, const float* edge,
                                    const float* dp, double* psum, long long* pcount,
                                    float* sums, long long* counts, int H, int W, int rf,
                                    float eps, float one_eps, int max_valid,
                                    cudaStream_t stream) {
  if (plan.blocks > 0) {
    const PathTable t = path_table(table, plan.pitch);
    auto kernel = plan.rpt == 4   ? &irn_affinity_loss_kernel<4>
                  : plan.rpt == 2 ? &irn_affinity_loss_kernel<2>
                                  : &irn_affinity_loss_kernel<1>;
    cudaError_t err = allow_smem(kernel, (size_t)plan.smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)plan.blocks, kPathThreads, (size_t)plan.smem, stream>>>(
        t, labels, edge, dp, psum, pcount, H, W, rf, plan.tiles_y, plan.tiles_x, eps, one_eps,
        max_valid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  irn_affinity_loss_final_kernel<<<1, kPathThreads, 0, stream>>>(psum, pcount, plan.blocks, sums,
                                                                counts);
  return cudaGetLastError();
}

cudaError_t tris::irn_affinity_loss_bwd(const PathTilePlan& plan, const PathSteps& table,
                                        const unsigned char* labels, const float* edge,
                                        const float* dp, const float* gsum, float* dedge,
                                        float* ddp, int H, int W, int rf, float eps,
                                        float one_eps, int max_valid, cudaStream_t stream) {
  return launch_path_max_gather<true>(plan, table, edge, nullptr, labels, dp, gsum, dedge, ddp,
                                      H, W, rf, eps, one_eps, max_valid, stream);
}
