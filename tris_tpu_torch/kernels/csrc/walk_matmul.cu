// K10, the walk's products: C = A @ B for the random walk's banded float32
// matrices, each product exact in double, each element summed in double and
// rounded once to float.
//
// Replaces the matrix products of tris_tpu/pseudo/indexing.py::_walk_program
// (line 441): the exp_times squarings T <- T @ T (:524-527; on the TPU the
// leading ones block-banded, _block_banded_squarings :293) and the thin step
// x * (1 - edge) @ T (:529-534).
//
// Three kernels, the two products on the FP64 tensor cores: mma.sync
// m16n8k16 .f64 (DMMA.16x8x16 on sm_90; wgmma has no f64 form).
//
// walk_tile_occupancy_kernel: which tiles of an operand hold a nonzero, on
// the square kernel's k-step grid: rows[i][k] for the 128-row x 16-column
// tile (i, k), cols[k][j] for the 16-row x 128-column tile (k, j). A block
// reads a 128 x 128 region once (a warp 16 rows, 16-byte loads). Bound:
// bytes (the operand read once).
//
// walk_square_kernel (the squarings): a block owns a 128 x 128 tile of C, rows
// [i0, i1) and columns [j0, j1), 8 warps a 64 x 32 sub-tile each. Its k
// loop takes k-tiles of 16 on a global grid, only those inside
// [max(i0 - band_a, j0 - band_b), min(i1 - 1 + band_a, j1 - 1 + band_b)]
// (outside it every product has a zero factor) where A's (i, k) and B's
// (k, j) occupancy entries both hold (else every product of the tile is
// zero): the block lists them in shared memory first, in ascending k. The
// float32 tiles stream through a ring of 4 stages filled by cp.async, 16
// bytes a thread; each thread converts the chunks it copied once into one
// of 4 double stages, kLead k-tiles ahead of the one the tensor cores run,
// between its DMMAs. Double stages are padded so that the fragment loads
// fall on distinct banks (A's rows 20 doubles apart, B's 132). No block
// barrier in the loop: a thread's own cp.async wait covers what it
// converts, and mbarriers per double stage (full: all threads converted,
// empty: all threads read their fragments) let warps drift apart by up to
// kLead k-tiles. A tile with no k-tile writes zeros. Bound: operations (2
// per product of two nonzeros) over the FP64 tensor-core peak.
//
// walk_thin_kernel (the thin step x [16, HW] @ T): a block per
// 32 columns of B and 16 rows of A, 8 warps; warp w runs the 16-row
// k-chunks q = w (mod 8) of B's strip, 4 n-tiles, from a ring of its own
// (cp.async, 4 chunks in flight, rows 40 floats apart), converting B's
// fragments in registers; A comes through shared memory as double in
// pieces of 512 k, copied a piece ahead. The 8 warps' sums are added in
// ascending warp at the end. Bound: bytes (B read once).
//
// Precision: a product of two floats is exact in double, so each element's
// result is its sum of exact products in double, rounded once to float: the
// exact product rounded to float unless the sum lies within about 1e-12 of a
// rounding boundary. The plain version (a float64 product, rounded) agrees
// to one rounding. The order of the sum is fixed by the tiling alone (no
// atomics, no split across blocks): the result is the same run to run, and
// a skipped k-tile or chunk adds exact zeros, so banded equals dense and
// skip equals no skip bit for bit. Built without -ftz: T's powers reach
// float32 subnormals, which the conversion to double keeps.
//
// Tile sizes: launchers.h. Which kernel a product takes is the wrapper's
// choice (kernels/walk.py: at most 32 rows of A, the thin one); either serves
// any M. The caller guarantees K % 8 == 0, N % 4 == 0 and 16-byte aligned
// rows.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kTile = tris::kWalkTile, kStep = tris::kWalkStep;
constexpr int kStages = 4, kThreads = 256, kGroup = 8;
static_assert(kTile == 128 && kStep == 16 && kThreads == 256,
              "the warp layouts and the copies are written for 128 x 128 tiles, k-steps of 16 "
              "and 8 warps");
constexpr int kDStages = 4, kLead = 2;  // double stages; k-tiles converted ahead
constexpr int kAPitch = kStep + 4;   // doubles between A's rows in a double stage
constexpr int kBPitch = kTile + 4;   // doubles between B's rows in a double stage
constexpr int kFloatStage = 2 * kTile * kStep;                    // floats: A then B
constexpr int kDoubleStage = kTile * kAPitch + kStep * kBPitch;   // doubles: A then B

using tris::cp_async16;
using tris::cp_async_commit;
using tris::cp_async_wait;
using tris::smem_addr;

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra.uni WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// d += a @ b for a 16 x 16 tile of A, a 16 x 8 tile of B and a 16 x 8 tile of C,
// with g = lane / 4, t = lane % 4: a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)],
// b[i] = B[t + 4 i][g], d[i] = C[g + 8 (i / 2)][2 t + i % 2]
__device__ __forceinline__ void dmma16816(double* d, const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__global__ void __launch_bounds__(kThreads)
walk_tile_occupancy_kernel(const float* __restrict__ x, int R, int C, bool* __restrict__ rows,
                           bool* __restrict__ cols) {
  __shared__ unsigned ballots[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * kTile + warp * kStep, col = blockIdx.x * kTile + 4 * lane;
  bool nz = false;
  if (col < C) {
#pragma unroll
    for (int r = 0; r < kStep; ++r) {
      if (r0 + r < R) {
        const float4 v = *reinterpret_cast<const float4*>(x + (long long)(r0 + r) * C + col);
        nz |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
      }
    }
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, nz);
  const int n_col_tiles = (C + kTile - 1) / kTile, n_steps = (C + kStep - 1) / kStep;
  if (lane == 0) {
    ballots[warp] = ballot;
    if (r0 < R) cols[(long long)(r0 / kStep) * n_col_tiles + blockIdx.x] = ballot != 0;
  }
  __syncthreads();
  // rows: the 16 columns of step c are lanes 4c .. 4c + 3 of every warp
  const int c = threadIdx.x, step = blockIdx.x * (kTile / kStep) + c;
  if (c < kTile / kStep && step < n_steps) {
    unsigned any = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) any |= (ballots[w] >> (4 * c)) & 0xfu;
    rows[(long long)blockIdx.y * n_steps + step] = any != 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
walk_square_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const bool* __restrict__ occ_a, const bool* __restrict__ occ_b,
                   float* __restrict__ c, int M, int N, int K, int band_a, int band_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* fstage = reinterpret_cast<float*>(smem);                         // [kStages][kFloatStage]
  double* dstage = reinterpret_cast<double*>(fstage + kStages * kFloatStage);  // [kDStages][..]
  int* list = reinterpret_cast<int*>(dstage + kDStages * kDoubleStage);   // the k-tiles to run
  __shared__ int warp_counts[kThreads / 32];
  __shared__ unsigned long long full[kDStages], empty[kDStages];
  if (threadIdx.x == 0)
    for (int d = 0; d < kDStages; ++d) {
      mbar_init(&full[d], kThreads);
      mbar_init(&empty[d], kThreads);
    }
  __syncthreads();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // tiles in groups of kGroup rows of tiles, so that blocks in flight share operand tiles in L2
  const int n_i = (M + kTile - 1) / kTile, n_j = (N + kTile - 1) / kTile;
  const int per_group = kGroup * n_j, first_i = blockIdx.x / per_group * kGroup;
  const int group_rows = min(n_i - first_i, kGroup), in_group = blockIdx.x % per_group;
  const int ti = first_i + in_group % group_rows, tj = in_group / group_rows;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int n_steps = (K + kStep - 1) / kStep;

  // the k-tiles this tile runs, ascending: inside the band's range, both tiles occupied
  const int k_lo = max(0, max(i0 - band_a, j0 - band_b));
  const int k_hi = min(K, min(i0 + kTile - 1 + band_a, j0 + kTile - 1 + band_b) + 1);
  const int s_lo = k_lo / kStep, s_hi = k_lo < k_hi ? (k_hi + kStep - 1) / kStep : s_lo;
  int n_list = 0;
  for (int base = s_lo; base < s_hi; base += kThreads) {
    const int s = base + tid;
    const bool run = s < s_hi && occ_a[(long long)ti * n_steps + s] &&
                     occ_b[(long long)s * n_j + tj];
    const unsigned ballot = __ballot_sync(0xffffffffu, run);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < warp ? warp_counts[w] : 0;
      total += warp_counts[w];
    }
    if (run) list[n_list + before + __popc(ballot & ((1u << lane) - 1u))] = s;
    n_list += total;
    __syncthreads();
  }

  // float stage it % kStages <- k-tile list[it]: A [128][16] and B [16][128] floats, this
  // thread's 2 + 2 chunks of 16 bytes
  auto load = [&](int it) {
    float* fa = fstage + (it % kStages) * kFloatStage;
    float* fb = fa + kTile * kStep;
    const int k0 = list[it] * kStep;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * kThreads;
      const int ar = e >> 2, aq = (e & 3) * 4;
      const bool a_in = i0 + ar < M && k0 + aq < K;
      cp_async16(fa + ar * kStep + aq, a_in ? a + (long long)(i0 + ar) * K + k0 + aq : a, a_in);
      const int br = e >> 5, bq = (e & 31) * 4;
      const bool b_in = k0 + br < K && j0 + bq < N;
      cp_async16(fb + br * kTile + bq, b_in ? b + (long long)(k0 + br) * N + j0 + bq : b, b_in);
    }
  };

  double acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;

  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  if (n_list > 0) {
    // full[d]: every thread has converted its chunks into double stage d; empty[d]:
    // every thread has read its fragments of d
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s < n_list) load(s);
      cp_async_commit();
    }
    // double stage it % kDStages <- this thread's chunks of k-tile it (part < 2: A's)
    auto convert_own = [&](int it, int part) {
      const float* fa = fstage + (it % kStages) * kFloatStage;
      double* da = dstage + (it % kDStages) * kDoubleStage;
      const int e = tid + (part & 1) * kThreads;
      if (part < 2) {
        const int ar = e >> 2, aq = (e & 3) * 4;
        const float4 v = *reinterpret_cast<const float4*>(fa + ar * kStep + aq);
        double2* d2 = reinterpret_cast<double2*>(da + ar * kAPitch + aq);
        d2[0] = make_double2(v.x, v.y);
        d2[1] = make_double2(v.z, v.w);
      } else {
        const int br = e >> 5, bq = (e & 31) * 4;
        const float4 v = *reinterpret_cast<const float4*>(fa + kTile * kStep + br * kTile + bq);
        double2* d2 = reinterpret_cast<double2*>(da + kTile * kAPitch + br * kBPitch + bq);
        d2[0] = make_double2(v.x, v.y);
        d2[1] = make_double2(v.z, v.w);
      }
    };
    for (int c = 0; c < kLead; ++c) {
      cp_async_wait<kStages - 1>();
      if (c < n_list) {
#pragma unroll
        for (int part = 0; part < 4; ++part) convert_own(c, part);
        mbar_arrive(&full[c % kDStages]);
      }
      if (c + kStages < n_list) load(c + kStages);
      cp_async_commit();
    }
    for (int it = 0; it < n_list; ++it) {
      const int conv = it + kLead;
      mbar_wait(&full[it % kDStages], (it / kDStages) & 1);
      const double* da = dstage + (it % kDStages) * kDoubleStage;
      const double* db = da + kTile * kAPitch;
      double bf[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) bf[nt][i] = db[(t + 4 * i) * kBPitch + wn + 8 * nt + g];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        double af[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          af[i] = da[(wm + 16 * mt + g + 8 * (i & 1)) * kAPitch + t + 4 * (i >> 1)];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) dmma16816(acc[mt][nt], af, bf[nt]);
        if (conv < n_list) {
          if (mt == 0) {
            cp_async_wait<kStages - 1>();  // this thread's chunks of k-tile conv have landed
            mbar_wait(&empty[conv % kDStages], ((conv / kDStages) + 1) & 1);
          }
          convert_own(conv, mt);
        }
      }
      mbar_arrive(&empty[it % kDStages]);  // this thread has read its fragments of k-tile it
      if (conv < n_list) mbar_arrive(&full[conv % kDStages]);
      if (conv + kStages < n_list) load(conv + kStages);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + wm + 16 * mt + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = j0 + wn + 8 * nt + 2 * t;
        if (col < N)
          *reinterpret_cast<float2*>(c + (long long)row * N + col) =
              make_float2(__double2float_rn(acc[mt][nt][2 * h]),
                          __double2float_rn(acc[mt][nt][2 * h + 1]));
      }
    }
}

// the thin step: a block per 32 columns of B and 16 rows of A, 8 warps; warp w runs the
// 16-row k-chunks q = w (mod 8) of B's strip, 4 n-tiles of 8
constexpr int kThinCols = tris::kWalkThinCols, kThinRows = tris::kWalkThinRows;
constexpr int kThinChunk = tris::kWalkThinChunk, kThinWarps = tris::kWalkThinWarps;
constexpr int kThinAlign = kThinChunk * kThinWarps, kThinPiece = 512;
constexpr int kThinPitch = 40, kThinDepth = 4, kThinXPitch = 20;
static_assert(kThinCols == 32 && kThinRows == 16 && kThinChunk == 16 &&
                  kThinWarps == kThreads / 32,
              "the lanes' copies and fragments are written for 16 x 32 blocks, chunks of 16 "
              "rows and 8 warps");
constexpr int kThinChunkFloats = kThinChunk * kThinPitch;

__global__ void __launch_bounds__(kThreads, 1)
walk_thin_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, int M, int N, int K, int band_a, int band_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* xs = reinterpret_cast<double*>(smem);                  // [kThinPiece][kThinXPitch]
  float* xf = reinterpret_cast<float*>(xs + kThinPiece * kThinXPitch);  // [kThinRows][kThinPiece]
  float* ring = xf + kThinRows * kThinPiece;  // [warps][kThinDepth][kThinChunk][kThinPitch]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kThinCols, m0 = blockIdx.y * kThinRows;
  // k over the band's range, in pieces of 512 rows from a multiple of kThinAlign
  const int k_lo = max(0, max(m0 - band_a, j0 - band_b));
  const int k_hi = min(K, min(m0 + kThinRows - 1 + band_a, j0 + kThinCols - 1 + band_b) + 1);
  const int lo = k_lo / kThinAlign * kThinAlign, hi = k_lo < k_hi ? k_hi : lo;
  // this warp's chunks: rows lo + 16 (warp + 8 j), j < n_mine; chunk q of the strip (rows
  // 16 q ..) goes to warp q % 8, since lo is a multiple of 128
  const int span = hi - lo - kThinChunk * warp;
  const int n_mine = span > 0 ? (span + kThinAlign - 1) / kThinAlign : 0;
  float* my_ring = ring + warp * kThinDepth * kThinChunkFloats;
  // a lane copies rows lane / 8 + 4 r (r < 4) of a chunk, columns 4 (lane % 8) ..
  const int cr = lane >> 3, cq = (lane & 7) * 4;
  auto fetch = [&](int j) {
    if (j < n_mine) {
      const int k0 = lo + kThinChunk * (warp + kThinWarps * j);
      float* dst = my_ring + (j % kThinDepth) * kThinChunkFloats;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = cr + 4 * r;
        const bool in = k0 + row < K && j0 + cq < N;
        cp_async16(dst + row * kThinPitch + cq,
                   in ? b + (long long)(k0 + row) * N + j0 + cq : b, in);
      }
    }
  };
  // A's rows over piece p as float: this thread's 8 chunks of 16 bytes
  auto fetch_x = [&](int p) {
    const int kb = lo + p * kThinPiece;
    if (kb >= hi) return;
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const int e = tid + h * kThreads, m = e & (kThinRows - 1), kq = (e >> 4) * 4;
      const bool in = m0 + m < M && kb + kq < hi;
      cp_async16(xf + m * kThinPiece + kq, in ? a + (long long)(m0 + m) * K + kb + kq : a, in);
    }
  };

  double acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0;

  // a warp's chunks of one piece; piece p + 1's A travels in the group of chunk
  // per_piece * (p + 1), which has landed when that piece starts
  constexpr int per_piece = kThinPiece / kThinAlign;
  static_assert(per_piece == kThinDepth, "one piece of A in flight with the warp's chunks");
  fetch_x(0);
#pragma unroll
  for (int j = 0; j < kThinDepth; ++j) {
    fetch(j);
    cp_async_commit();
  }
  for (int kb = lo, p = 0; kb < hi; kb += kThinPiece, ++p) {
    cp_async_wait<kThinDepth - 1>();  // this piece's A and the warp's first chunk have landed
    __syncthreads();                  // every warp is done with the last piece
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const int e = tid + h * kThreads, m = e & (kThinRows - 1), kq = (e >> 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(xf + m * kThinPiece + kq);
      xs[(kq + 0) * kThinXPitch + m] = v.x;
      xs[(kq + 1) * kThinXPitch + m] = v.y;
      xs[(kq + 2) * kThinXPitch + m] = v.z;
      xs[(kq + 3) * kThinXPitch + m] = v.w;
    }
    __syncthreads();
    for (int j = p * per_piece; j < min(n_mine, (p + 1) * per_piece); ++j) {
      cp_async_wait<kThinDepth - 1>();  // chunk j has landed (this lane's rows)
      __syncwarp();                     // and every lane's
      const float* tile = my_ring + (j % kThinDepth) * kThinChunkFloats;
      const double* xr =
          xs + (kThinChunk * (warp + kThinWarps * (j - p * per_piece))) * kThinXPitch;
      double af[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) af[i] = xr[(t + 4 * (i >> 1)) * kThinXPitch + g + 8 * (i & 1)];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        double bf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bf[i] = tile[(t + 4 * i) * kThinPitch + 8 * nt + g];
        dmma16816(acc[nt], af, bf);
      }
      __syncwarp();  // every lane has read chunk j before its slot is refilled
      fetch(j + kThinDepth);
      if ((j + kThinDepth) % per_piece == 0) fetch_x((j + kThinDepth) / per_piece);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // the 8 warps' sums added in ascending warp
  __syncthreads();
  double* sums = xs;  // [kThinWarps][kThinRows][kThinCols]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sums[(warp * kThinRows + g + 8 * (i >> 1)) * kThinCols + 8 * nt + 2 * t + (i & 1)] =
          acc[nt][i];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = tid + h * kThreads, m = o / kThinCols, j = o % kThinCols;
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kThinWarps; ++w) s += sums[(w * kThinRows + m) * kThinCols + j];
    if (m0 + m < M && j0 + j < N) c[(long long)(m0 + m) * N + j0 + j] = __double2float_rn(s);
  }
}

}  // namespace

cudaError_t tris::walk_tile_occupancy(const float* x, bool* rows, bool* cols, int R, int C,
                                      cudaStream_t stream) {
  if (R == 0 || C == 0) return cudaSuccess;
  const dim3 grid((C + kTile - 1) / kTile, (R + kTile - 1) / kTile);
  walk_tile_occupancy_kernel<<<grid, kThreads, 0, stream>>>(x, R, C, rows, cols);
  return cudaGetLastError();
}

size_t tris::walk_square_smem(int K) {
  return sizeof(float) * kStages * kFloatStage + sizeof(double) * kDStages * kDoubleStage +
         sizeof(int) * ((K + kStep - 1) / kStep);
}

cudaError_t tris::walk_square(const float* a, const float* b, const bool* occ_a,
                              const bool* occ_b, float* c, int M, int N, int K, int band_a,
                              int band_b, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const size_t smem = walk_square_smem(K);
  cudaError_t err = allow_smem(walk_square_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = ((M + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  walk_square_kernel<<<blocks, kThreads, smem, stream>>>(a, b, occ_a, occ_b, c, M, N, K, band_a,
                                                         band_b);
  return cudaGetLastError();
}

cudaError_t tris::walk_thin(const float* a, const float* b, float* c, int M, int N, int K,
                            int band_a, int band_b, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + kThinCols - 1) / kThinCols, (M + kThinRows - 1) / kThinRows);
  const size_t smem = sizeof(double) * kThinPiece * kThinXPitch +
                      sizeof(float) * (kThinRows * kThinPiece + kThinWarps * kThinDepth * kThinChunkFloats);
  cudaError_t err = allow_smem(walk_thin_kernel, smem);
  if (err != cudaSuccess) return err;
  walk_thin_kernel<<<grid, kThreads, smem, stream>>>(a, b, c, M, N, K, band_a, band_b);
  return cudaGetLastError();
}
