// K2's tiles, shared by its forward (cross_attn.cu) and backward
// (cross_attn_bwd.cu): a block's share of a tile of kCrossAttnRows query rows.
//
// A tile's m channels are cut into slices of kCrossAttnSlice, one block of a
// cluster each (cross_attn_slices(m) blocks), and its keys into blocks of at
// most kCrossAttnKeyBlock, which shared memory holds at once. Each block reads
// its slice of the tile's query rows and key/value rows through shared memory:
//  - slice_logits: the block's partial logits Q K^T over its slice (in the
//    backward dA = G V^T), a register-tiled FP32 FFMA product over chunks
//    of kCrossAttnChunk channels staged with cp.async;
//  - the cluster's partials are summed in rank order through distributed
//    shared memory (each caller does this);
//  - PvStream: Pm V over the slice's channels (one to three such products),
//    V staged kCrossAttnKeyChunk keys at a time, each thread owning 8 rows x
//    4 channels in registers, which may carry a sum from one key block to
//    the next.
// Every sum runs in a fixed order (channels, then ranks, then keys
// ascending), so a result is the same run to run. An operand may be bfloat16
// (--bf16): it is read 4 values an 8-byte load and widened into the same
// float32 staging (float32 operands keep their cp.async copies), and a
// bfloat16 output is rounded once at its store.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "launchers.h"

namespace tris {
namespace xattn {

namespace cg = cooperative_groups;

constexpr int kRows = kCrossAttnRows, kSlice = kCrossAttnSlice, kChunk = kCrossAttnChunk,
              kKeyChunk = kCrossAttnKeyChunk, kKeyBlock = kCrossAttnKeyBlock;
// a warp per 4 query rows; blocks an SM holds at the register budget of
// 128 a thread (the layouts below keep within it)
constexpr int kThreads = 8 * kRows, kWarps = kThreads / 32, kMinBlocks = 512 / kThreads;
// floats between staged rows of a logits chunk: an odd number of 16-byte
// units, so the lanes' 16-byte reads of 8 consecutive rows hit distinct banks
constexpr int kChunkPitch = kChunk + 4;
static_assert(kChunkPitch % 8 == 4, "an odd number of 16-byte units");
constexpr int kPvStage = kKeyChunk * kSlice;  // floats of one stage of V
constexpr int kLogitStages = 3, kPvStages = 3;
static_assert(kRows % 16 == 0 && kThreads <= 512 && kSlice == 256 && kChunk % 4 == 0 &&
                  kKeyChunk % 4 == 0 && kKeyBlock % 32 == 0 && kKeyBlock <= 256 &&
                  kKeyBlock % kKeyChunk == 0,
              "the thread layouts are written for 16-row units and 256-channel slices");

// Keys a launch's tiles hold at once (a key block), rounded up to warp-wide
// slots of 32, and the pitch of a [kRows][keys] tile in shared memory.
__host__ __device__ inline int key_capacity(int keys) {
  return ((keys < kKeyBlock ? keys : kKeyBlock) + 31) / 32 * 32;
}
// key blocks that cover keys
__host__ __device__ inline int key_blocks(int keys) { return (keys + kKeyBlock - 1) / kKeyBlock; }
__host__ __device__ inline int tile_pitch(int kcap) { return kcap + 4; }
// tiles of kRows rows that cover rows
__host__ __device__ inline int row_tiles(int rows) { return (rows + kRows - 1) / kRows; }
// floats of one stage of slice_logits
__host__ __device__ inline int logit_stage(int kcap) { return (kRows + kcap) * kChunkPitch; }
// floats of the staging area, which slice_logits and then PvStream use
__host__ __device__ inline int stage_floats(int kcap) {
  const int a = kLogitStages * logit_stage(kcap), b = kPvStages * kPvStage;
  return a > b ? a : b;
}

// The operands' dtypes of a launch: kF32 all float32; kMixed the vision projections float32
// and the text ones bfloat16 (the fusion on float32 leaves: every product float32, as jnp
// promotes them); kBf16 all bfloat16, the logits, the quotient by div and each op of the
// softmax rounded to bfloat16 and the outputs bfloat16.
enum Mode { kF32, kMixed, kBf16 };
template <int kMode>
struct Dtypes {
  using Vis = std::conditional_t<kMode == kBf16, __nv_bfloat16, float>;
  using Txt = std::conditional_t<kMode == kF32, float, __nv_bfloat16>;
  using Out = Vis;
};

// 4 values at src into dst in shared memory, zeros when !ok (src is then any valid
// pointer): a float32 operand by one 16-byte cp.async, a bfloat16 one by an 8-byte load
// widened to float32
template <class T>
__device__ __forceinline__ void stage4(float* dst, const T* src, bool ok) {
  if constexpr (std::is_same_v<T, float>)
    cp_async16(dst, src, ok);
  else
    *reinterpret_cast<float4*>(dst) = ok ? load4_bf16(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}

// acc + p.x v[0] + p.y v[1] + p.z v[2] + p.w v[3], in that order
__device__ __forceinline__ float4 axpy4(float4 p, const float4* v, float4 acc) {
  acc.x = fmaf(p.w, v[3].x, fmaf(p.z, v[2].x, fmaf(p.y, v[1].x, fmaf(p.x, v[0].x, acc.x))));
  acc.y = fmaf(p.w, v[3].y, fmaf(p.z, v[2].y, fmaf(p.y, v[1].y, fmaf(p.x, v[0].y, acc.y))));
  acc.z = fmaf(p.w, v[3].z, fmaf(p.z, v[2].z, fmaf(p.y, v[1].z, fmaf(p.x, v[0].z, acc.z))));
  acc.w = fmaf(p.w, v[3].w, fmaf(p.z, v[2].w, fmaf(p.y, v[1].w, fmaf(p.x, v[0].w, acc.w))));
  return acc;
}

// The block's partial product L = A B^T over channels [c0, c0 + mc): A's
// kRows rows at a (rows >= nrows read as zeros), B's nk rows at b (nk <= 32
// KS), rows m floats apart; written to part[r pitch + j] for j < 32 ceil(nk /
// 32). L is cut into units of 16 rows x 32 keys, warp w taking units w, w +
// kWarps, ...; in a unit, lane (ry, kx) = (l / 8, l % 8) sums rows ry + 4 i
// against keys kx + 8 j (i, j < 4) over ascending channels, so that a warp's
// 16-byte reads of a staged chunk fall on 4 consecutive rows of A and 8 of
// B, one bank each: one shared-memory wavefront per read.
template <int KS, class TA = float, class TB = float>
__device__ __forceinline__ void slice_logits(const TA* a, const TB* b, int nrows, int nk,
                                             int m, int c0, int mc, int kcap, float* stage,
                                             float* part, int pitch) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ry = lane >> 3, kx = lane & 7;
  const int slots = (nk + 31) >> 5, span = kRows + 32 * slots;  // rows staged
  constexpr int kPieces = kChunk / 4;                             // 16-byte pieces a row
  constexpr int kUnitsPerWarp = ((kRows / 16) * KS + kWarps - 1) / kWarps;
  const int units = (kRows / 16) * slots;
  const int sfl = logit_stage(kcap), chunks = (mc + kChunk - 1) / kChunk;
  auto load = [&](int ch, int s) {
    float* st = stage + s * sfl;
    const int c = ch * kChunk;
    for (int i = tid; i < span * kPieces; i += kThreads) {
      const int piece = (i % kPieces) * 4, rr = i / kPieces;
      const bool is_a = rr < kRows;
      const int src = is_a ? rr : rr - kRows;
      const bool ok = (src < (is_a ? nrows : nk)) && c + piece < mc;
      const long long at = (long long)src * m + c0 + c + piece;
      if constexpr (std::is_same_v<TA, float> && std::is_same_v<TB, float>) {
        const float* base = is_a ? a : b;
        cp_async16(st + rr * kChunkPitch + piece, ok ? base + at : base, ok);
      } else if (is_a) {
        stage4(st + rr * kChunkPitch + piece, ok ? a + at : a, ok);
      } else {
        stage4(st + rr * kChunkPitch + piece, ok ? b + at : b, ok);
      }
    }
  };
  // unit u of this warp: whether it has one, its first row and first key
  bool uon[kUnitsPerWarp];
  int ur[kUnitsPerWarp], uk[kUnitsPerWarp];
#pragma unroll
  for (int u = 0; u < kUnitsPerWarp; ++u) {
    const int unit = warp + kWarps * u;
    uon[u] = unit < units;
    ur[u] = 16 * (unit % (kRows / 16));
    uk[u] = 32 * (unit / (kRows / 16));
  }
  float acc[kUnitsPerWarp][4][4];
#pragma unroll
  for (int u = 0; u < kUnitsPerWarp; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[u][i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kLogitStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kLogitStages - 2>();  // chunk ch has landed (this thread's copies)
    __syncthreads();                    // everyone's copies, and chunk ch - 1 is done with
    if (ch + kLogitStages - 1 < chunks)
      load(ch + kLogitStages - 1, (ch + kLogitStages - 1) % kLogitStages);
    cp_async_commit();
    const float* st = stage + (ch % kLogitStages) * sfl;
#pragma unroll
    for (int u = 0; u < kUnitsPerWarp; ++u) {
      if (uon[u]) {
        const float* as = st + (ur[u] + ry) * kChunkPitch;
        const float* bs = st + (kRows + uk[u] + kx) * kChunkPitch;
#pragma unroll
        for (int kk = 0; kk < kChunk; kk += 4) {
          float4 x[4], y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[i] = *reinterpret_cast<const float4*>(as + 4 * i * kChunkPitch + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y[j] = *reinterpret_cast<const float4*>(bs + 8 * j * kChunkPitch + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[u][i][j] = dot4(x[i], y[j], acc[u][i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int u = 0; u < kUnitsPerWarp; ++u)
    if (uon[u])
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[(ur[u] + ry + 4 * i) * pitch + uk[u] + kx + 8 * j] = acc[u][i][j];
  __syncthreads();  // the staging area is free, the partials are written
}

// NJ products pm_q V_q (q < NJ) of one tile and channel slice, all with nk
// keys: out_q[r][c0 + c] = acc + sum_j pm_q[r][j] V_q[j][c0 + c] for rows r <
// nrows and channels c < mc, acc zero or the sum run() was given. pm_q is a
// [kRows][pitch] tile in shared memory (zeros from nk up to a multiple of
// 4), V_q's nk rows are at v[q], m floats apart,
// out_q's rows at out[q], m apart. The V_q stream through one ring of
// kPvStages stages, kKeyChunk rows a chunk, one product after the other, so
// the next product's first chunks come in while this one's last are used.
// Thread (warp w, lane l) owns rows 8 (w / 2) .. + 8 and channels 128 (w % 2)
// + 4 l .. + 4, summed over ascending keys. V and out may be bfloat16 (TV, TO).
template <int NJ, class TV = float, class TO = float>
struct PvStream {
  const float* pm[NJ];
  const TV* v[NJ];
  TO* out[NJ];
  int nk, m, c0, mc;

  __device__ __forceinline__ int chunks() const { return (nk + kKeyChunk - 1) / kKeyChunk; }

  template <typename T>
  __device__ __forceinline__ static T pick(const T (&x)[NJ], int q) {
    T r = x[0];
#pragma unroll
    for (int i = 1; i < NJ; ++i)
      if (q == i) r = x[i];
    return r;
  }

  // chunk g of the stream (product g / chunks(), its chunk g % chunks()) into its stage
  __device__ __forceinline__ void load(int g, float* stage) const {
    const int per = chunks(), pieces = mc / 4;
    const TV* src = pick(v, g / per);
    float* st = stage + (g % kPvStages) * kPvStage;
    const int j0 = (g % per) * kKeyChunk;
    for (int i = threadIdx.x; i < kKeyChunk * pieces; i += kThreads) {
      const int row = i / pieces, piece = (i % pieces) * 4, j = j0 + row;
      const bool ok = j < nk;
      stage4(st + row * kSlice + piece, ok ? src + (long long)j * m + c0 + piece : src, ok);
    }
  }

  // the first kPvStages - 1 chunks, committed as as many groups (copies
  // issued before and not yet committed join the first)
  __device__ __forceinline__ void prologue(float* stage) const {
#pragma unroll
    for (int s = 0; s < kPvStages - 1; ++s) {
      if (s < NJ * chunks()) load(s, stage);
      cp_async_commit();
    }
  }

  // the products, after prologue(stage), each written once summed
  __device__ __forceinline__ void run(int pitch, int nrows, float* stage) const {
    float4 acc[8];
    clear(acc);
    run(pitch, nrows, stage, acc, true);
  }

  // zeros for run()'s first sum
  __device__ __forceinline__ static void clear(float4 (&acc)[8]) {
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // the products, after prologue(stage), added to acc (clear()ed, or a sum
  // over earlier keys): with flush each is written and acc cleared for the
  // next, else acc keeps the sum (NJ = 1) for a later key block
  __device__ __forceinline__ void run(int pitch, int nrows, float* stage, float4 (&acc)[8],
                                      bool flush) const {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int r0 = (warp >> 1) * 8, c = (warp & 1) * 128 + lane * 4;
    const bool active = c < mc;
    const int per = chunks(), total = NJ * per;
    for (int g = 0; g < total; ++g) {
      cp_async_wait<kPvStages - 2>();
      __syncthreads();
      if (g + kPvStages - 1 < total) load(g + kPvStages - 1, stage);
      cp_async_commit();
      const float* st = stage + (g % kPvStages) * kPvStage;
      const int q = g / per, j0 = (g % per) * kKeyChunk, jn = nk - j0;  // 4-key steps below jn
      const float* p_rows = pick(pm, q) + r0 * pitch + j0;
      auto quad = [&](int jq) {
        float4 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vv[u] = *reinterpret_cast<const float4*>(st + (jq + u) * kSlice + c);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(p_rows + r * pitch + jq);
          acc[r] = axpy4(p, vv, acc[r]);
        }
      };
      if (active) {
        if (jn >= kKeyChunk) {
#pragma unroll
          for (int jq = 0; jq < kKeyChunk; jq += 4) quad(jq);
        } else {
          for (int jq = 0; jq < jn; jq += 4) quad(jq);
        }
        if (flush && g % per == per - 1) {  // product q is summed: write it, start the next
          TO* o = pick(out, q) + (long long)r0 * m + c0 + c;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (r0 + r < nrows) {
              if constexpr (std::is_same_v<TO, float>)
                *reinterpret_cast<float4*>(o + (long long)r * m) = acc[r];
              else
                store4_bf16(o + (long long)r * m, acc[r]);
            }
            acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      }
    }
    cp_async_wait<0>();
  }
};

// The sum over the cluster's n blocks, in rank order, of the 4 floats at x
// in each block's shared memory: the n loads are issued before the adds.
__device__ __forceinline__ float4 cluster_sum4(cg::cluster_group& cluster, float* x, int n) {
  float4 v[kCrossAttnMaxSlices];
#pragma unroll
  for (int rank = 0; rank < kCrossAttnMaxSlices; ++rank)
    if (rank < n) v[rank] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(x, rank));
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int rank = 0; rank < kCrossAttnMaxSlices; ++rank) {
    if (rank < n) {
      s.x += v[rank].x;
      s.y += v[rank].y;
      s.z += v[rank].z;
      s.w += v[rank].w;
    }
  }
  return s;
}

// dst[k][j] = (the sum over the cluster in rank order of part[r][j]) / d for
// r = rank + n k < nrows and j < 32 slots: the rows this block owns of a tile
// whose partials the n blocks of the cluster hold (every row when `all`, r =
// k). dst and part are [kRows][pitch]. With `round` (bfloat16 logits) the sum
// and the quotient are each rounded to bfloat16.
__device__ __forceinline__ void gather_rows(cg::cluster_group& cluster, float* part, float* dst,
                                            int pitch, int slots, int nrows, bool all, float d,
                                            bool round = false) {
  const int n = cluster.num_blocks(), rank = cluster.block_rank();
  const int first = all ? 0 : rank, step = all ? 1 : n;
  const int owned = nrows > first ? (nrows - first + step - 1) / step : 0, quads = 8 * slots;
#pragma unroll 4
  for (int i = threadIdx.x; i < owned * quads; i += kThreads) {
    const int q = (i % quads) * 4, k = i / quads;
    float4 s = cluster_sum4(cluster, part + (first + step * k) * pitch + q, n);
    if (round) {
      s = make_float4(round_bf16(round_bf16(s.x) / d), round_bf16(round_bf16(s.y) / d),
                      round_bf16(round_bf16(s.z) / d), round_bf16(round_bf16(s.w) / d));
    } else {
      s.x /= d;
      s.y /= d;
      s.z /= d;
      s.w /= d;
    }
    *reinterpret_cast<float4*>(dst + k * pitch + q) = s;
  }
}

// the cluster barrier in two halves: arrive once this block's shared memory
// may be read no more by the others, wait before leaving
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A launch of `kernel` on clusters of `cluster` blocks along x, its shape
// written to *shape once CUDA has taken it.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int cluster, size_t smem,
                            cudaStream_t stream, LaunchShape* shape, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
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
  if (err == cudaSuccess)
    *shape = {(int)cfg.gridDim.x, (int)attr[0].val.clusterDim.x, (int)cfg.blockDim.x, kRows,
              (long long)cfg.dynamicSmemBytes};
  return err;
}

}  // namespace xattn
}  // namespace tris
