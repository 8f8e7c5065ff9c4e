// K10, the walk's products: C = A @ B for the random walk's banded float32
// matrices, summed in double and rounded once to float.
//
// Replaces the matrix products of tris_tpu/pseudo/indexing.py::_walk_program
// (line 441): the exp_times squarings T <- T @ T (:524-527; on the TPU the
// leading ones block-banded, _block_banded_squarings :293) and the thin step
// x * (1 - edge) @ T (:529-534).
//
// Band: A[i, k] is zero where |k - i| > band_a and B[k, j] where
// |j - k| > band_b (the transition has half-width max_off, its 2^s-th power
// 2^s * max_off; a dense operand passes its inner size). A block owns a
// 128 x 128 tile of C, rows [i0, i1) and columns [j0, j1), and runs k only
// over [max(i0 - band_a, j0 - band_b), min(i1 - 1 + band_a, j1 - 1 + band_b)]:
// outside it every product has a zero factor. A tile off the product's band
// writes zeros. At a 480x640 image's bucket (HW = 20480, max_off = 642) the
// eight squarings and the thin step do 3.9 dense products' work, not 8.
//
// Precision: a product of two floats is exact in double, and each element's
// sum runs in double (DFMA) in ascending k, rounded once to float. The
// result is the exact product rounded to float unless the sum lies within
// about 1e-12 of a rounding boundary, so it depends neither on the tiling
// nor on the band; the plain version (a product in double, rounded to
// float) agrees to one rounding. Summed in float, two correct orders put the
// walk's outputs 1e-4 of their max apart (tests/test_torch_irnet.py).
//
// Design: 256 threads, each an 8 x 8 register tile of doubles at rows and
// columns 32 * (t / 2) + 2 * thread + t % 2 (t = 0..7), so that a warp's
// 16-byte shared loads fall on consecutive addresses; k in steps of 8
// through shared memory held as double (A's tile transposed), the next
// step's float4 loads in registers while the current step computes.
// Bound: operations (the nonzero products, 2 each).
//
// The caller guarantees K % 8 == 0, N % 4 == 0 and 16-byte aligned rows.

#include "launchers.h"

namespace {

constexpr int kTile = 128, kStep = 8, kThreads = 256;

__device__ __forceinline__ int tile_index(int t, int thread) {
  return 32 * (t >> 1) + 2 * thread + (t & 1);
}

__global__ void __launch_bounds__(kThreads, 1)
walk_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ c, int M, int N, int K, int band_a, int band_b) {
  __shared__ __align__(16) double as[2][kStep][kTile];  // as[k][i] = A[i0 + i, k]
  __shared__ __align__(16) double bs[2][kStep][kTile];  // bs[k][j] = B[k, j0 + j]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  // the tile's k range of possibly nonzero products, in whole steps
  int k_lo = max(0, max(i0 - band_a, j0 - band_b));
  int k_hi = min(K, min(i0 + kTile - 1 + band_a, j0 + kTile - 1 + band_b) + 1);
  k_lo = k_lo / kStep * kStep;
  k_hi = min(K, (k_hi + kStep - 1) / kStep * kStep);

  double acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0;

  // loaders: A's row ar, 4 floats from k offset ak; B's row bk, 4 floats from column bc
  const int ar = tid >> 1, ak = (tid & 1) * 4, bk = tid >> 5, bc = (tid & 31) * 4;
  const bool a_in = i0 + ar < M, b_in = j0 + bc < N;
  const float* a_row = a + (long long)(i0 + ar) * K + ak;
  const float* b_col = b + (long long)bk * N + j0 + bc;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra = zero, rb = zero;
  auto load = [&](int k) {
    ra = a_in ? *reinterpret_cast<const float4*>(a_row + k) : zero;
    rb = b_in ? *reinterpret_cast<const float4*>(b_col + (long long)k * N) : zero;
  };
  auto store = [&](int buf) {
    as[buf][ak + 0][ar] = ra.x;
    as[buf][ak + 1][ar] = ra.y;
    as[buf][ak + 2][ar] = ra.z;
    as[buf][ak + 3][ar] = ra.w;
    double2* bp = reinterpret_cast<double2*>(&bs[buf][bk][bc]);
    bp[0] = make_double2(rb.x, rb.y);
    bp[1] = make_double2(rb.z, rb.w);
  };

  if (k_lo < k_hi) {
    load(k_lo);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int k = k_lo; k < k_hi; k += kStep) {
      const bool more = k + kStep < k_hi;
      if (more) load(k + kStep);
#pragma unroll
      for (int kk = 0; kk < kStep; ++kk) {
        double av[8], bv[8];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const double2 x = *reinterpret_cast<const double2*>(&as[buf][kk][32 * h + 2 * ty]);
          const double2 y = *reinterpret_cast<const double2*>(&bs[buf][kk][32 * h + 2 * tx]);
          av[2 * h] = x.x;
          av[2 * h + 1] = x.y;
          bv[2 * h] = y.x;
          bv[2 * h + 1] = y.y;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
      }
      if (more) store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + tile_index(i, ty);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int col = j0 + 32 * h + 2 * tx;
      if (col < N)
        *reinterpret_cast<float2*>(c + (long long)row * N + col) =
            make_float2(__double2float_rn(acc[i][2 * h]), __double2float_rn(acc[i][2 * h + 1]));
    }
  }
}

}  // namespace

cudaError_t tris::walk_matmul(const float* a, const float* b, float* c, int M, int N, int K,
                              int band_a, int band_b, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  walk_matmul_kernel<<<grid, kThreads, 0, stream>>>(a, b, c, M, N, K, band_a, band_b);
  return cudaGetLastError();
}
