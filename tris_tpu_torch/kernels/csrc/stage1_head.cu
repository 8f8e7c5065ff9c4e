// K3, training half: the stage-1 classification head, forward and backward,
// float32.
//
// Replaces tris_tpu/models/stage1.py::TRISStage1.__call__ lines 100-131 with
// train=True (and its autodiff): per image b of the batch, with T = B texts,
//   score[b, p, q] = exp(logit_scale) * <vis_p[b, p], lan_p[b, q]>   (D channels)
//   feats = [1 (bg); score[b, :, q] for each q]  over the 1+T channels, per pixel p
//   masks = softmax over the channels;  gap, gmp = mean and max over p;
//   cls_out[b, q] = gap + gmp + (1 - mbar)^fp * log(fc + mbar),  mbar = mean_p masks
//   cls_fg[b] = mbar of channel b (no gradient: a metric, as in the JAX package)
//   seg[b] = upsample(score[b, :, b]) h*w -> H*W (align_corners=False);
//   relu_map = relu(seg), sig_map = sigmoid(seg).
//
// Shapes on the stage-1 train path: B = 48, h = w = 10, D = 1024,
// H = W = 320; one forward (3 launches) and one backward (4) per step.
//
// Bound: bytes - vis_p (19.7 MB) and lan_p (9.4 MB) read once and the two
// maps (39.3 MB) written once dominate; the score and its gradient are two
// small GEMMs (0.47 GFLOP each way). Design:
//  - The three D = 1024 contractions (the score, d vis_p = scale * dscore .
//    lan_p, d lan_p = scale * dscore^T . vis_p) are one tiled batched-GEMM
//    kernel here (32 x 32 output tiles, 32-deep slices of both operands in
//    shared memory, 2 x 2 outputs per thread), not a library call.
//  - head_fwd / head_bwd: one block per image holds its [h*w, T] score plane
//    in shared memory; per-pixel softmax statistics (max with the constant
//    bg logit 1, and the sum), then per-channel GAP, GMP, mbar. The GMP's
//    gradient goes to the first argmax alone; JAX splits it among tied
//    maxima (the plain version's amax does too). Ties have probability zero
//    on continuous scores, and the constant bg row, where all pixels tie, is
//    dropped from cls_out.
//  - maps_fwd / maps_bwd: one block per (output row, image). The forward
//    samples the diagonal plane with the eval half's taps (the JAX matrices'
//    rows, rows first); the backward recomputes seg, forms d seg from d
//    sig_map (and d relu_map when given), and reduces each row onto the w
//    coarse columns over the tap ranges (the upsample's adjoint as a
//    gather). head_bwd then reduces the rows onto the h coarse rows the same
//    way. No atomics: the gradient is the same run to run.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kTile = 32;
constexpr int kMapThreads = 256;
constexpr int kHeadThreads = 256;

// C[b] (M x N) = alpha * A[b] (M x K) . Bm[b] (K x N); element (i, j) of X at
// X + b * sXb + i * sXi + j * sXj. grid (ceil(N/32), ceil(M/32), batch), 256
// threads as 16 x 16, each 2 x 2 outputs.
__global__ void __launch_bounds__(256)
bmm_kernel(const float* __restrict__ A, long long sAb, long long sAm, long long sAk,
           const float* __restrict__ Bm, long long sBb, long long sBk, long long sBn,
           float* __restrict__ C, long long sCb, long long sCm, long long sCn, int M, int N,
           int K, const float* __restrict__ alpha) {
  __shared__ float as[kTile][kTile + 1];  // [k][m]
  __shared__ float bs[kTile][kTile + 1];  // [k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const long long b = blockIdx.z;
  const float* a = A + b * sAb;
  const float* bm = Bm + b * sBb;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < K; k0 += kTile) {
    for (int i = threadIdx.x; i < kTile * kTile; i += 256) {
      // the unit-stride index runs fastest across threads: coalesced loads
      const int hi = i / kTile, lo = i % kTile;
      const int ak = sAk == 1 ? lo : hi, am = sAk == 1 ? hi : lo;
      const int bk = sBk == 1 ? lo : hi, bn = sBk == 1 ? hi : lo;
      as[ak][am] = (m0 + am < M && k0 + ak < K) ? a[(m0 + am) * sAm + (k0 + ak) * sAk] : 0.f;
      bs[bk][bn] = (n0 + bn < N && k0 + bk < K) ? bm[(k0 + bk) * sBk + (n0 + bn) * sBn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float a0 = as[kk][ty], a1 = as[kk][ty + 16];
      const float b0 = bs[kk][tx], b1 = bs[kk][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  const float s = *alpha;
  float* c = C + b * sCb;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) c[m * sCm + n * sCn] = s * acc[i][j];
    }
}

cudaError_t bmm(const float* A, long long sAb, long long sAm, long long sAk, const float* Bm,
                long long sBb, long long sBk, long long sBn, float* C, long long sCb,
                long long sCm, long long sCn, int batch, int M, int N, int K,
                const float* alpha, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, batch);
  bmm_kernel<<<grid, 256, 0, stream>>>(A, sAb, sAm, sAk, Bm, sBb, sBk, sBn, C, sCb, sCm, sCn, M,
                                       N, K, alpha);
  return cudaGetLastError();
}

__device__ __forceinline__ float focal(float x, float fp, float fc) {
  return powf(1.f - x, fp) * logf(fc + x);
}

__device__ __forceinline__ float focal_grad(float x, float fp, float fc) {
  return -fp * powf(1.f - x, fp - 1.f) * logf(fc + x) + powf(1.f - x, fp) / (fc + x);
}

// The [hw, T] score plane of image b into sc; per pixel, the softmax max mx
// (over the T scores and the bg logit 1) and sum z.
__device__ void load_plane_stats(const float* __restrict__ score, int b, int hw, int T,
                                 float* sc, float* mx, float* z) {
  const float* s = score + (long long)b * hw * T;
  for (int i = threadIdx.x; i < hw * T; i += blockDim.x) sc[i] = s[i];
  __syncthreads();
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float* r = sc + p * T;
    float m = 1.f;
    for (int q = 0; q < T; ++q) m = fmaxf(m, r[q]);
    float sum = expf(1.f - m);
    for (int q = 0; q < T; ++q) sum += expf(r[q] - m);
    mx[p] = m;
    z[p] = sum;
  }
  __syncthreads();
}

// grid B: cls_out[b, :] and cls_fg[b]. smem: sc [hw*T], mx, z [hw].
__global__ void __launch_bounds__(kHeadThreads)
head_fwd_kernel(const float* __restrict__ score, float* __restrict__ cls_out,
                float* __restrict__ cls_fg, int hw, int T, float fp, float fc) {
  extern __shared__ float smem[];
  float* sc = smem;
  float* mx = sc + hw * T;
  float* z = mx + hw;
  const int b = blockIdx.x;
  load_plane_stats(score, b, hw, T, sc, mx, z);
  for (int q = threadIdx.x; q < T; q += blockDim.x) {
    float gap = 0.f, gmp = -INFINITY, mbar = 0.f;
    for (int p = 0; p < hw; ++p) {
      const float v = sc[p * T + q];
      gap += v;
      gmp = fmaxf(gmp, v);
      mbar += expf(v - mx[p]) / z[p];
    }
    gap /= hw;
    mbar /= hw;
    cls_out[(long long)b * T + q] = gap + gmp + focal(mbar, fp, fc);
    if (q == b) cls_fg[b] = mbar;
  }
}

// grid (H, B): output row y of image b's relu and sigmoid maps.
// smem: the diagonal plane [hw].
__global__ void __launch_bounds__(kMapThreads)
maps_fwd_kernel(const float* __restrict__ score, float* __restrict__ relu_map,
                float* __restrict__ sig_map, int T, int h, int w, int H, int W,
                tris::TapArrays ty, tris::TapArrays tx) {
  extern __shared__ float own[];
  const int y = blockIdx.x, b = blockIdx.y, hw = h * w;
  for (int p = threadIdx.x; p < hw; p += blockDim.x)
    own[p] = score[((long long)b * hw + p) * T + b];
  __syncthreads();
  const int y0 = ty.lo[y], y1 = ty.hi[y];
  const float a0 = ty.w0[y], a1 = ty.w1[y];
  const long long o = ((long long)b * H + y) * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const float v = tris::sample2(own, w, y0, y1, a0, a1, tx.lo[x], tx.hi[x], tx.w0[x], tx.w1[x]);
    relu_map[o + x] = fmaxf(v, 0.f);
    sig_map[o + x] = 1.f / (1.f + expf(-v));
  }
}

// grid (H, B): d seg on output row y of image b, reduced onto the w coarse
// columns: dt[b, y, j]. smem: the diagonal plane [hw], the d seg row [W].
__global__ void __launch_bounds__(kMapThreads)
maps_bwd_kernel(const float* __restrict__ score, const float* __restrict__ g_relu,
                const float* __restrict__ g_sig, float* __restrict__ dt, int T, int h, int w,
                int H, int W, tris::TapArrays ty, tris::TapArrays tx, tris::TapRanges rx) {
  extern __shared__ float smem[];
  float* own = smem;
  float* row = own + h * w;
  const int y = blockIdx.x, b = blockIdx.y, hw = h * w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = threadIdx.x; p < hw; p += blockDim.x)
    own[p] = score[((long long)b * hw + p) * T + b];
  __syncthreads();
  const int y0 = ty.lo[y], y1 = ty.hi[y];
  const float a0 = ty.w0[y], a1 = ty.w1[y];
  const long long o = ((long long)b * H + y) * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const float v = tris::sample2(own, w, y0, y1, a0, a1, tx.lo[x], tx.hi[x], tx.w0[x], tx.w1[x]);
    float d = 0.f;
    if (g_sig) {
      const float s = 1.f / (1.f + expf(-v));
      d = g_sig[o + x] * s * (1.f - s);
    }
    if (g_relu && v > 0.f) d += g_relu[o + x];
    row[x] = d;
  }
  __syncthreads();
  for (int j = warp; j < w; j += kMapThreads / 32) {
    float acc = 0.f;
    for (int x = rx.lo_begin[j] + lane; x < rx.lo_end[j]; x += 32) acc = fmaf(tx.w0[x], row[x], acc);
    for (int x = rx.hi_begin[j] + lane; x < rx.hi_end[j]; x += 32) acc = fmaf(tx.w1[x], row[x], acc);
    acc = tris::warp_sum(acc);
    if (lane == 0) dt[((long long)b * H + y) * w + j] = acc;
  }
}

// grid B: dscore[b] [hw, T] from d cls_out[b] and (dt non-null) the map's
// column-reduced gradient dt[b] [H, w]. smem: sc [hw*T], mx, z, down, dot
// [hw], gc, gq [T], am [T] ints.
__global__ void __launch_bounds__(kHeadThreads)
head_bwd_kernel(const float* __restrict__ score, const float* __restrict__ g_cls,
                const float* __restrict__ dt, float* __restrict__ dscore, int h, int w, int T,
                int H, float fp, float fc, tris::TapArrays ty, tris::TapRanges ry) {
  extern __shared__ float smem[];
  const int hw = h * w;
  float* sc = smem;
  float* mx = sc + hw * T;
  float* z = mx + hw;
  float* down = z + hw;
  float* dot = down + hw;
  float* gc = dot + hw;
  float* gq = gc + T;
  int* am = reinterpret_cast<int*>(gq + T);
  const int b = blockIdx.x;
  for (int q = threadIdx.x; q < T; q += blockDim.x) gc[q] = g_cls[(long long)b * T + q];
  load_plane_stats(score, b, hw, T, sc, mx, z);
  for (int q = threadIdx.x; q < T; q += blockDim.x) {
    float mbar = 0.f, best = -INFINITY;
    int arg = 0;
    for (int p = 0; p < hw; ++p) {
      const float v = sc[p * T + q];
      mbar += expf(v - mx[p]) / z[p];
      if (v > best) {  // the first argmax takes the whole GMP gradient
        best = v;
        arg = p;
      }
    }
    mbar /= hw;
    gq[q] = gc[q] * focal_grad(mbar, fp, fc) / hw;
    am[q] = arg;
  }
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const int i = p / w, j = p % w;
    float acc = 0.f;
    if (dt) {
      const float* d = dt + (long long)b * H * w + j;
      for (int y = ry.lo_begin[i]; y < ry.lo_end[i]; ++y) acc = fmaf(ty.w0[y], d[y * w], acc);
      for (int y = ry.hi_begin[i]; y < ry.hi_end[i]; ++y) acc = fmaf(ty.w1[y], d[y * w], acc);
    }
    down[p] = acc;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < T; ++q) acc = fmaf(expf(sc[p * T + q] - mx[p]) / z[p], gq[q], acc);
    dot[p] = acc;
  }
  __syncthreads();
  float* ds = dscore + (long long)b * hw * T;
  for (int i = threadIdx.x; i < hw * T; i += blockDim.x) {
    const int p = i / T, q = i % T;
    const float mask = expf(sc[i] - mx[p]) / z[p];
    float d = gc[q] / hw + mask * (gq[q] - dot[p]);
    if (p == am[q]) d += gc[q];
    if (q == b) d += down[p];
    ds[i] = d;
  }
}

size_t head_smem(int hw, int T) { return sizeof(float) * ((size_t)hw * T + 4 * (size_t)hw + 3 * (size_t)T); }

}  // namespace

cudaError_t tris::stage1_head(const float* vis_p, const float* lan_p, const float* scale,
                              float* score, float* cls_out, float* cls_fg, float* relu_map,
                              float* sig_map, int B, int h, int w, int D, int H, int W,
                              float focal_p, float focal_c, TapArrays ty, TapArrays tx,
                              cudaStream_t stream) {
  const int hw = h * w, T = B;
  cudaError_t err = bmm(vis_p, (long long)hw * D, D, 1, lan_p, (long long)T * D, 1, D, score,
                        (long long)hw * T, T, 1, B, hw, T, D, scale, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = head_smem(hw, T);
  if ((err = tris::allow_smem(head_fwd_kernel, smem)) != cudaSuccess) return err;
  head_fwd_kernel<<<B, kHeadThreads, smem, stream>>>(score, cls_out, cls_fg, hw, T, focal_p,
                                                     focal_c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  maps_fwd_kernel<<<dim3(H, B), kMapThreads, sizeof(float) * hw, stream>>>(
      score, relu_map, sig_map, T, h, w, H, W, ty, tx);
  return cudaGetLastError();
}

cudaError_t tris::stage1_head_bwd(const float* g_cls, const float* g_relu, const float* g_sig,
                                  const float* vis_p, const float* lan_p, const float* scale,
                                  const float* score, float* dt, float* dscore, float* d_vis,
                                  float* d_lan, int B, int h, int w, int D, int H, int W,
                                  float focal_p, float focal_c, TapArrays ty, TapArrays tx,
                                  TapRanges ry, TapRanges rx, cudaStream_t stream) {
  const int hw = h * w, T = B;
  cudaError_t err;
  const bool maps = g_relu || g_sig;
  if (maps) {
    maps_bwd_kernel<<<dim3(H, B), kMapThreads, sizeof(float) * (hw + W), stream>>>(
        score, g_relu, g_sig, dt, T, h, w, H, W, ty, tx, rx);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = head_smem(hw, T);
  if ((err = tris::allow_smem(head_bwd_kernel, smem)) != cudaSuccess) return err;
  head_bwd_kernel<<<B, kHeadThreads, smem, stream>>>(score, g_cls, maps ? dt : nullptr, dscore,
                                                     h, w, T, H, focal_p, focal_c, ty, ry);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // d vis_p[b] = scale * dscore[b] [hw, T] . lan_p[b] [T, D]
  err = bmm(dscore, (long long)hw * T, T, 1, lan_p, (long long)T * D, D, 1, d_vis,
            (long long)hw * D, D, 1, B, hw, D, T, scale, stream);
  if (err != cudaSuccess) return err;
  // d lan_p[b] = scale * dscore[b]^T [T, hw] . vis_p[b] [hw, D]
  return bmm(dscore, (long long)hw * T, 1, T, vis_p, (long long)hw * D, D, 1, d_lan,
             (long long)T * D, D, 1, B, T, D, hw, scale, stream);
}
