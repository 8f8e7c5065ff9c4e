// K1's tiles, shared by its forward (mha_short.cu) and backward
// (mha_short_bwd.cu): one block per (sequence, head), its operands staged in
// shared memory and every product formed in FP32 register tiles.
//
// A block of mha_short_threads(LP) threads pads the head's rows to the length
// bucket LP and its channels to the head-dim bucket HD (launchers.h), zeros in
// the padding, so every loop below has compile-time bounds. Thread t is lane
// tx = t % kLanes of row group ty = t / kLanes; a warp holds 4 row groups,
// and a thread kRows rows (2 below LP = 64, then 4: fewer rows a thread keep
// more warps in flight at short lengths, more rows read shared memory less
// often per FFMA at long ones).
//  - stage: a [rows, hd] operand into [LP][HD + kMhaShortPad] with 16-byte
//    cp.async copies (VEC) or 4-byte ones; the odd number of 16-byte units a
//    row keeps the 16-byte reads of 8 consecutive rows on distinct banks.
//  - logits: a "rows x keys" tile A B^T, thread (ty, tx) holding rows
//    ty + kGroups i (i < kRows) against keys tx + kLanes j (j < kKeys), so
//    a row's keys lie on the kLanes lanes of one warp; channels in chunks of
//    4 ascending, each chunk's float4 of B feeding kRows products.
//  - softmax: the mask (from device memory, the thread's own pairs), -inf
//    past Lk, and the row's max and sum by three xor shuffles.
//  - rows_by_keys: O += P V, thread (ty, tx) holding the same rows against
//    channels 4 tx + 4 kLanes g (float4s), keys ascending in steps of 4.
//  - keys_by_rows: O += P^T X, thread (ty, tx) holding keys kRows ty + i
//    against the same channels, rows ascending.
// Each output element is summed by one thread in a fixed order: a result is
// the same run to run.

#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "launchers.h"

namespace tris {
namespace mha {

constexpr int kLanes = kMhaShortLanes;
static_assert(kLanes == 8, "8-lane rows");

template <int LP, int HD>
struct Tiles {
  // rows (or keys) of a thread's tiles: mha_short_rows(LP)
  static constexpr int kRows = LP >= kMhaShortLong ? kMhaShortRowsLong : kMhaShortRows;
  static constexpr int kGroups = LP / kRows;              // row groups: thread ty
  static constexpr int kThreads = kGroups * kLanes;
  static constexpr int kKeys = LP / kLanes;               // keys of a thread's logits
  static constexpr int kChan4 = HD / (4 * kLanes);        // float4s of a thread's channels
  static constexpr int kPitch = HD + kMhaShortPad;        // floats a staged row
  static constexpr int kPPitch = (LP + 31) / 32 * 32 + kMhaShortProbPad;  // a row of P / dS
  static constexpr int kOperand = LP * kPitch;
  static constexpr int kLoads = LP * HD / 4 / kThreads;   // float4s a thread stages
  static_assert(kRows == 2 || kRows % 4 == 0, "float2 or float4 key groups");
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
  static_assert(LP % kLanes == 0 && HD % (4 * kLanes) == 0 && kChan4 >= 1, "bucket sizes");
  static_assert(LP * HD / 4 % kThreads == 0, "the staging loop");
  static_assert(kPitch % 8 == 4 && kPPitch % 32 == 8,
                "16-byte rows: an odd number of units for operands, 8 banks apart for P");
};

// a thread's logits tile (rows x keys) and its output tile (rows x float4 channels)
template <int LP, int HD>
using Logits = float[Tiles<LP, HD>::kRows][Tiles<LP, HD>::kKeys];
template <int LP, int HD>
using Acc = float4[Tiles<LP, HD>::kRows][Tiles<LP, HD>::kChan4];

__device__ __forceinline__ int lane_x() { return threadIdx.x % kLanes; }
__device__ __forceinline__ int group_y() { return threadIdx.x / kLanes; }

// over the kLanes lanes that hold one row's keys (a butterfly: fixed order)
__device__ __forceinline__ float lanes_max(float v) {
  for (int o = 1; o < kLanes; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float lanes_sum(float v) {
  for (int o = 1; o < kLanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}

// acc + p.x v[0] + p.y v[1] + p.z v[2] + p.w v[3], in that order
__device__ __forceinline__ float4 axpy4(float4 p, const float4 (&v)[4], float4 acc) {
  acc.x = fmaf(p.w, v[3].x, fmaf(p.z, v[2].x, fmaf(p.y, v[1].x, fmaf(p.x, v[0].x, acc.x))));
  acc.y = fmaf(p.w, v[3].y, fmaf(p.z, v[2].y, fmaf(p.y, v[1].y, fmaf(p.x, v[0].y, acc.y))));
  acc.z = fmaf(p.w, v[3].z, fmaf(p.z, v[2].z, fmaf(p.y, v[1].z, fmaf(p.x, v[0].z, acc.z))));
  acc.w = fmaf(p.w, v[3].w, fmaf(p.z, v[2].w, fmaf(p.y, v[1].w, fmaf(p.x, v[0].w, acc.w))));
  return acc;
}

// acc + p x, componentwise
__device__ __forceinline__ float4 axpy(float p, float4 x, float4 acc) {
  return make_float4(fmaf(p, x.x, acc.x), fmaf(p, x.y, acc.y), fmaf(p, x.z, acc.z),
                     fmaf(p, x.w, acc.w));
}

// One operand of a block: rows [0, rows) x channels [0, hd) at src (row stride
// `row` floats) copied into a [LP][kPitch] tile by cp.async, 16 bytes a copy
// (VEC) or 4, zeros past rows and hd. A block issues every operand's copies,
// then waits for its own (cp_async_commit, cp_async_wait<0>) and, for q,
// scales the chunks it copied (scale_own) before the block's barrier.
template <int LP, int HD, bool VEC>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, long long row,
                                      int rows, int hd) {
  using T = Tiles<LP, HD>;
#pragma unroll
  for (int it = 0; it < T::kLoads; ++it) {
    const int i = threadIdx.x + it * T::kThreads, r = i / (HD / 4), c = i % (HD / 4) * 4;
    float* d = dst + r * T::kPitch + c;
    if constexpr (VEC) {
      const bool ok = r < rows && c < hd;
      tris::cp_async16(d, ok ? src + r * row + c : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = r < rows && c + e < hd;
        tris::cp_async4(d + e, ok ? src + r * row + c + e : src, ok);
      }
    }
  }
}

// A bfloat16 [rows, hd] operand at src (row stride `row` elements) into a [LP][kPitch]
// float32 tile, zeros past rows and hd: 8 values a 16-byte load (VEC) or one a load; with
// `scale`, each value times scale rounded to bfloat16 (q).
template <int LP, int HD, bool VEC>
__device__ __forceinline__ void stage_bf16(float* dst, const __nv_bfloat16* __restrict__ src,
                                           long long row, int rows, int hd, bool scaled,
                                           float scale) {
  using T = Tiles<LP, HD>;
  auto put = [&](float x) { return scaled ? tris::round_bf16(x * scale) : x; };
  constexpr int kPer = VEC ? 8 : 1;
  for (int i = threadIdx.x; i < LP * HD / kPer; i += T::kThreads) {
    const int r = i / (HD / kPer), c = i % (HD / kPer) * kPer;
    float* d = dst + r * T::kPitch + c;
    if constexpr (VEC) {
      float f[8] = {};
      if (r < rows && c < hd) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + r * row + c);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 t = __bfloat1622float2(p[e]);
          f[2 * e] = put(t.x);
          f[2 * e + 1] = put(t.y);
        }
      }
      reinterpret_cast<float4*>(d)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(d)[1] = make_float4(f[4], f[5], f[6], f[7]);
    } else {
      *d = r < rows && c < hd ? put(__bfloat162float(src[r * row + c])) : 0.f;
    }
  }
}

// the chunks of a staged tile this thread copied, times scale (rounded, as
// the JAX function rounds q * hd^-1/2 before the dot)
template <int LP, int HD>
__device__ __forceinline__ void scale_own(float* tile, float scale) {
  using T = Tiles<LP, HD>;
#pragma unroll
  for (int it = 0; it < T::kLoads; ++it) {
    const int i = threadIdx.x + it * T::kThreads;
    float4* p = reinterpret_cast<float4*>(tile + i / (HD / 4) * T::kPitch + i % (HD / 4) * 4);
    const float4 x = *p;
    *p = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
}

// close this thread's group of copies and wait until at most `Pending` groups
// are in flight, then scale its chunks of q (may be null)
template <int LP, int HD, int Pending = 0>
__device__ __forceinline__ void staged(float* q_tile, float scale) {
  tris::cp_async_commit();
  tris::cp_async_wait<Pending>();
  if (q_tile != nullptr) scale_own<LP, HD>(q_tile, scale);
}

// acc[i][j] += a[ty + kGroups i] . b[tx + kLanes j] over the HD channels of two
// staged operands, chunks of 4 channels ascending
template <int LP, int HD>
__device__ __forceinline__ void logits(const float* a, const float* b,
                                       Logits<LP, HD>& acc) {
  using T = Tiles<LP, HD>;
  const float* ar = a + group_y() * T::kPitch;
  const float* br = b + lane_x() * T::kPitch;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 x[T::kRows];
#pragma unroll
    for (int i = 0; i < T::kRows; ++i)
      x[i] = *reinterpret_cast<const float4*>(ar + i * T::kGroups * T::kPitch + d);
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(br + j * kLanes * T::kPitch + d);
#pragma unroll
      for (int i = 0; i < T::kRows; ++i) acc[i][j] = dot4(x[i], y, acc[i][j]);
    }
  }
}

// The logits tile made probabilities in place: keys >= Lk at -inf, rows < Lq
// plus mask[row][key] (mask [Lq, Lk] or null), exp(s - max) / sum per row
template <int LP, int HD>
__device__ __forceinline__ void softmax(Logits<LP, HD>& s,
                                        const float* __restrict__ mask, int Lq, int Lk) {
  using T = Tiles<LP, HD>;
  const int tx = lane_x(), ty = group_y();
#pragma unroll
  for (int i = 0; i < T::kRows; ++i) {
    const int r = ty + i * T::kGroups;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j) {
      const int key = tx + j * kLanes;
      if (key >= Lk)
        s[i][j] = -INFINITY;
      else if (mask != nullptr && r < Lq)
        s[i][j] += __ldg(mask + r * Lk + key);
      m = fmaxf(m, s[i][j]);
    }
    m = lanes_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j) {
      s[i][j] = expf(s[i][j] - m);
      sum += s[i][j];
    }
    sum = lanes_sum(sum);
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j) s[i][j] = s[i][j] / sum;
  }
}

// a logits-layout tile to / from a [LP][kPPitch] tile in shared memory
template <int LP, int HD>
__device__ __forceinline__ void put_probs(float* p, const Logits<LP, HD>& s) {
  using T = Tiles<LP, HD>;
  float* pr = p + group_y() * T::kPPitch + lane_x();
#pragma unroll
  for (int i = 0; i < T::kRows; ++i)
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j) pr[i * T::kGroups * T::kPPitch + j * kLanes] = s[i][j];
}
template <int LP, int HD>
__device__ __forceinline__ float get_prob(const float* p, int i, int j) {
  using T = Tiles<LP, HD>;
  return p[(group_y() + i * T::kGroups) * T::kPPitch + lane_x() + j * kLanes];
}

// acc[i][g] += sum over keys [0, nk) of p[ty + kGroups i][key] x[key][4 tx + 32 g ..+3],
// keys ascending in steps of 4 (nk a multiple of 4, p zero past the keys)
template <int LP, int HD>
__device__ __forceinline__ void rows_by_keys(const float* p, const float* x, int nk,
                                             Acc<LP, HD>& acc) {
  using T = Tiles<LP, HD>;
  const float* pr = p + group_y() * T::kPPitch;
  const float* xc = x + 4 * lane_x();
#pragma unroll 2
  for (int k0 = 0; k0 < nk; k0 += 4) {
    float4 pk[T::kRows];
#pragma unroll
    for (int i = 0; i < T::kRows; ++i)
      pk[i] = *reinterpret_cast<const float4*>(pr + i * T::kGroups * T::kPPitch + k0);
#pragma unroll
    for (int g = 0; g < T::kChan4; ++g) {
      float4 y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = *reinterpret_cast<const float4*>(xc + (k0 + e) * T::kPitch + 4 * kLanes * g);
#pragma unroll
      for (int i = 0; i < T::kRows; ++i) acc[i][g] = axpy4(pk[i], y, acc[i][g]);
    }
  }
}

// acc[i][g] += sum over rows [0, nr) of p[row][kRows ty + i] x[row][4 tx + 32 g ..+3],
// rows ascending
template <int LP, int HD>
__device__ __forceinline__ void keys_by_rows(const float* p, const float* x, int nr,
                                             Acc<LP, HD>& acc) {
  using T = Tiles<LP, HD>;
  const float* pc = p + T::kRows * group_y();
  const float* xc = x + 4 * lane_x();
#pragma unroll 4
  for (int r = 0; r < nr; ++r) {
    float pk[T::kRows];
    if constexpr (T::kRows == 2) {
      const float2 t = *reinterpret_cast<const float2*>(pc + r * T::kPPitch);
      pk[0] = t.x;
      pk[1] = t.y;
    } else {
#pragma unroll
      for (int i = 0; i < T::kRows; i += 4) {
        const float4 t = *reinterpret_cast<const float4*>(pc + r * T::kPPitch + i);
        pk[i] = t.x;
        pk[i + 1] = t.y;
        pk[i + 2] = t.z;
        pk[i + 3] = t.w;
      }
    }
#pragma unroll
    for (int g = 0; g < T::kChan4; ++g) {
      const float4 y = *reinterpret_cast<const float4*>(xc + r * T::kPitch + 4 * kLanes * g);
#pragma unroll
      for (int i = 0; i < T::kRows; ++i) acc[i][g] = axpy(pk[i], y, acc[i][g]);
    }
  }
}

// acc[i][g] * scale to dst rows (the tile's row i, below nrows) of a [rows, C] output with
// row stride C, channels 4 tx + 32 g ..+3 below hd; `row_of` maps i to the tile's row
template <int LP, int HD, bool VEC, class RowOf>
__device__ __forceinline__ void put_rows(float* __restrict__ dst, long long C, int nrows, int hd,
                                         float scale, const Acc<LP, HD>& acc,
                                         RowOf row_of) {
  using T = Tiles<LP, HD>;
#pragma unroll
  for (int i = 0; i < T::kRows; ++i) {
    const int r = row_of(i);
    if (r >= nrows) continue;
#pragma unroll
    for (int g = 0; g < T::kChan4; ++g) {
      const int c = 4 * lane_x() + 4 * kLanes * g;
      const float4 v = make_float4(acc[i][g].x * scale, acc[i][g].y * scale, acc[i][g].z * scale,
                                   acc[i][g].w * scale);
      float* o = dst + r * C + c;
      if constexpr (VEC) {
        if (c < hd) *reinterpret_cast<float4*>(o) = v;
      } else {
        if (c < hd) o[0] = v.x;
        if (c + 1 < hd) o[1] = v.y;
        if (c + 2 < hd) o[2] = v.z;
        if (c + 3 < hd) o[3] = v.w;
      }
    }
  }
}

// Whether a launch can take 16-byte loads and stores: every pointer 16-byte aligned and
// every stride and hd a multiple of 4 floats.
inline bool aligned16(std::initializer_list<const void*> ptrs,
                      std::initializer_list<long long> strides, int hd) {
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long s : strides)
    if (s % 4) return false;
  return hd % 4 == 0;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<LP>, Int<HD>, bool_constant<VEC>) at the launch's buckets: the kernels are
// instantiated at every bucket of their direction (mha_short_len_bucket)
template <bool Backward, class F>
cudaError_t dispatch(int lp, int hdb, bool vec, F&& f) {
  auto by_vec = [&](auto L, auto H) {
    return vec ? f(L, H, std::true_type{}) : f(L, H, std::false_type{});
  };
  auto by_hd = [&](auto L) {
    return hdb == 32   ? by_vec(L, Int<32>{})
           : hdb == 64 ? by_vec(L, Int<64>{})
                       : by_vec(L, Int<128>{});
  };
  if constexpr (!Backward) {
    if (lp == 56) return by_hd(Int<56>{});
  }
  return lp == 16 ? by_hd(Int<16>{}) : lp == 32 ? by_hd(Int<32>{}) : lp == 64 ? by_hd(Int<64>{})
                                                                         : by_hd(Int<128>{});
}

// Launch `kernel` on a block per (sequence, head) and report the launch in *shape.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int lp, int hdb, bool vec, bool backward, int N, int n_head,
                   cudaStream_t stream, MhaLaunchShape* shape, Args... args) {
  const long long smem = mha_short_smem(lp, hdb, backward);
  const int blocks = N * n_head, threads = mha_short_threads(lp);
  cudaError_t err = allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, (size_t)smem, stream>>>(args...);
  if (shape != nullptr) *shape = {blocks, threads, lp, hdb, vec ? 16 : 4, smem};
  return cudaGetLastError();
}

}  // namespace mha
}  // namespace tris
