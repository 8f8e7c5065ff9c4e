// K11's tiles, shared by its forward (pixel_attn.cu) and backward
// (pixel_attn_bwd.cu): a block's share of an image's tile of kTile pixels,
// for each of the image's S pairs in ascending order.
//
// The T tokens are padded to the bucket TB (launchers.h), so every loop over
// tokens has compile-time bounds; a padded token's staged key and value rows
// are zeros and its logit -inf. A block holds its tile's rows of q (and, in
// the backward, dG) and the pair's key and value rows for `held` channels of
// its slice at once, each row pitch floats (an odd number of 16-byte units,
// so the 16-byte reads of 8, or of 4, rows at one column fall on distinct
// banks). Lane l of a warp is (l / 4, l % 4):
//  - logits: acc[i][j] over a share of the held channels, float4 by float4
//    ascending, pixel pg + 8 i (i < 4) against token tg + 4 j (j < TB / 4):
//    every 16-byte read of q feeds TB / 4 float4 products, of a key 4.
//  - put_logits / sum_partials: the warps' partials through shared memory,
//    added in warp order; the cluster's block partials are then added in
//    rank order through distributed shared memory (K2's cluster_sum4, a
//    float4 a thread; K2's gather_rows, unrolled by 4, made these kernels
//    spill registers).
//  - softmax: a pixel's tokens lie on 4 lanes of one warp, its max and sum
//    two xor shuffles.
//  - rows_by_tokens: O = P B over tokens ascending (G = P Lv, dq = dL Lk),
//    thread holding pixels pg + 8 i against 4 channels, passes of kPass
//    channels; B's float4 feeds 4 pixels, P's float4 4 tokens.
//  - tokens_by_rows: acc += Y^T X over the tile's pixels ascending (dLk =
//    dL^T q, dLv = A^T dG), thread holding tokens tg + 4 j against 4
//    channels of a pass.
// Every sum has one owner and a fixed order, so a result is the same run to
// run. Staging is cp.async, 16 bytes a copy (VEC) or 4.

#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "cross_attn_tiles.cuh"
#include "launchers.h"

namespace tris {
namespace pattn {

namespace cg = cooperative_groups;

constexpr int kTile = kPixelAttnTile, kThreads = kPixelAttnThreads, kWarps = kThreads / 32;
constexpr int kByToken = kTile + 4;         // a row of dL and A by token: 9 16-byte units
constexpr int kPass = 128;                  // channels of a pass over the held ones
constexpr int kPasses = kPixelAttnSlice / kPass;
static_assert(kTile == 32 && kWarps == 8, "8 pixel groups of 4 lanes, 4 pixels a thread");
static_assert(kTile * kPixelAttnMaxT / 4 <= kThreads, "a float4 of a [kTile][TB] tile a thread");
static_assert(kPixelAttnSlice % kPass == 0 && kPasses == 2 &&
                  kPixelAttnMaxRanks <= kCrossAttnMaxSlices,
              "passes of 128 channels; clusters K2's cluster_sum4 sums");

template <int TB>
struct Tok {
  static constexpr int kPitch = pixel_attn_token_pitch(TB);  // a [pixel][token] row
  static_assert(TB % 4 == 0 && TB <= kPixelAttnMaxTForward && kPitch % 8 == 4, "token buckets");
};

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp() { return threadIdx.x >> 5; }

// The float4 pieces [x, y) of `pieces` that member m of `members` takes.
__device__ __forceinline__ int2 share(int pieces, int m, int members) {
  const int per = (pieces + members - 1) / members, k0 = min(pieces, m * per);
  return make_int2(k0, min(pieces, k0 + per));
}

// Rows [0, nrows) x channels [0, cw) of src (rows ld floats apart) into dst's
// rows [0, cap) x columns [0, held) (pitch floats apart): zeros past nrows and
// cw. `any` is a valid address for the zero-filled copies.
template <bool VEC>
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src, long long ld,
                                      int cap, int nrows, int held, int cw, const float* any) {
  const int pieces = held >> 2, n = cap * pieces;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / pieces, c = (i - r * pieces) << 2;
    float* d = dst + r * pitch + c;
    if constexpr (VEC) {
      const bool ok = r < nrows && c < cw;
      cp_async16(d, ok ? src + r * ld + c : any, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = r < nrows && c + e < cw;
        cp_async4(d + e, ok ? src + r * ld + c + e : any, ok);
      }
    }
  }
}

// acc[i][j] += the dot products of a's row pg + 8 i with b's row tg + 4 j over
// float4 pieces [k0, k1), ascending.
template <int TB>
__device__ __forceinline__ void logits(const float* a, const float* b, int pitch, int k0, int k1,
                                       float (&acc)[4][TB / 4]) {
  const float* ar = a + (lane() >> 2) * pitch;
  const float* br = b + (lane() & 3) * pitch;
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    float4 x[4], y[TB / 4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(ar + 8 * i * pitch + 4 * k);
#pragma unroll
    for (int j = 0; j < TB / 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(br + 4 * j * pitch + 4 * k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TB / 4; ++j) acc[i][j] = xattn::dot4(x[i], y[j], acc[i][j]);
  }
}

// This warp's logits tile into red's [warp][kTile][token pitch] rows.
template <int TB>
__device__ __forceinline__ void put_logits(float* red, const float (&acc)[4][TB / 4]) {
  float* r = red + (warp() * kTile + (lane() >> 2)) * Tok<TB>::kPitch + (lane() & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TB / 4; ++j) r[8 * i * Tok<TB>::kPitch + 4 * j] = acc[i][j];
}

// part[g][p][t] = the sum over the warps m of group g in order of red[g members + m][p][t]:
// one group of 8 warps (the forward's logits) or two of 4 (the backward's logits, dA); all
// [kTile][token pitch].
template <int TB>
__device__ __forceinline__ void sum_partials(const float* red, float* part, int groups) {
  constexpr int kTP = Tok<TB>::kPitch;
  const int members = kWarps / groups;
  for (int i = threadIdx.x; i < groups * kTile * TB; i += kThreads) {
    const int g = i / (kTile * TB), p = i / TB % kTile, t = i % TB;
    const float* r = red + (g * members * kTile + p) * kTP + t;
    float s = r[0];
    for (int m = 1; m < members; ++m) s += r[m * kTile * kTP];
    part[(g * kTile + p) * kTP + t] = s;
  }
}

// dst's kTile rows x TB columns = (the sum over the cluster's blocks in rank order of
// part's) / d, a float4 a thread (two in turn past kPixelAttnMaxT tokens); both [kTile][token
// pitch].
template <int TB>
__device__ __forceinline__ void gather(cg::cluster_group& cluster, float* part, float* dst,
                                       float d) {
  constexpr int kTP = Tok<TB>::kPitch;
  for (int i = threadIdx.x; i < kTile * TB / 4; i += kThreads) {
    const int r = i / (TB / 4), c = i % (TB / 4) * 4;
    const float4 s = xattn::cluster_sum4(cluster, part + r * kTP + c, (int)cluster.num_blocks());
    *reinterpret_cast<float4*>(dst + r * kTP + c) =
        make_float4(s.x / d, s.y / d, s.z / d, s.w / d);
  }
}

// The cluster's round: the warps' partials in red, `products` tiles of them (see
// sum_partials), summed into part and then over the cluster in rank order into full (the
// first divided by div0); part and full [products][kTile][token pitch]. A block's part is
// written after the others have read its previous round (`later`: not its first).
template <int TB>
__device__ __forceinline__ void exchange(cg::cluster_group& cluster, const float* red,
                                         float* part, float* full, int products, bool later,
                                         float div0) {
  if (later) xattn::cluster_wait();
  sum_partials<TB>(red, part, products);
  xattn::cluster_arrive();
  xattn::cluster_wait();
  for (int k = 0; k < products; ++k)
    gather<TB>(cluster, part + k * kTile * Tok<TB>::kPitch, full + k * kTile * Tok<TB>::kPitch,
               k == 0 ? div0 : 1.f);
  xattn::cluster_arrive();
  __syncthreads();
}

// The row softmax of warp w < 4's pixels 8 w + lane / 4 over tokens lane % 4 + 4 k: s[k]
// from full (-inf past T), the max and the sum of exponentials over the pixel's 4 lanes.
template <int TB>
__device__ __forceinline__ void softmax(const float* full, int T, float (&s)[TB / 4]) {
  const int p = warp() * 8 + (lane() >> 2), tl = lane() & 3;
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < TB / 4; ++k) {
    s[k] = tl + 4 * k < T ? full[p * Tok<TB>::kPitch + tl + 4 * k] : -INFINITY;
    mx = fmaxf(mx, s[k]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < TB / 4; ++k) {
    s[k] = tl + 4 * k < T ? expf(s[k] - mx) : 0.f;
    sum += s[k];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
  for (int k = 0; k < TB / 4; ++k) s[k] = s[k] / sum;
}

// 4 floats to dst (the first `left` of them without VEC); with `add`, added to what is
// there.
template <bool VEC>
__device__ __forceinline__ void put4(float* dst, float4 v, int left, bool add) {
  if constexpr (VEC) {
    if (add) {
      const float4 o = *reinterpret_cast<const float4*>(dst);
      v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
    }
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < left) dst[k] = add ? dst[k] + e[k] : e[k];
  }
}

// out[pg + 8 i][4 pc ..] = (sum over tokens ascending of prob[pg + 8 i][t] b[t][4 pc ..]) /
// div for the rows below nrows and channels below cw, pc = 32 pass + 4 warp + lane % 4 over
// the held channels' pieces; with `add`, added to out. prob is [kTile][token pitch].
template <int TB, bool VEC>
__device__ __forceinline__ void rows_by_tokens(const float* prob, const float* b, int pitch,
                                               int held, float* out, long long ld, int nrows,
                                               int cw, float div, bool add) {
  constexpr int kTP = Tok<TB>::kPitch;
  const int pg = lane() >> 2;
#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    const int c = 4 * (32 * pass + 4 * warp() + (lane() & 3));
    if (c >= held) continue;
    float4 o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int t = 0; t < TB; t += 4) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = *reinterpret_cast<const float4*>(b + (t + k) * pitch + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = xattn::axpy4(*reinterpret_cast<const float4*>(prob + (pg + 8 * i) * kTP + t), v,
                            o[i]);
    }
    if (c >= cw) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (pg + 8 * i < nrows)
        put4<VEC>(out + (pg + 8 * i) * ld + c,
                  make_float4(o[i].x / div, o[i].y / div, o[i].z / div, o[i].w / div), cw - c,
                  add);
    }
  }
}

// acc[pass][j] += sum over the tile's pixels ascending of y[tg + 4 j][p] x[p][4 pc ..], pc =
// 32 pass + 8 (warp % 4) + lane / 4 over the held channels' pieces, tg = lane % 4. y is
// [TB][kByToken], x [kTile][pitch].
template <int TB>
__device__ __forceinline__ void tokens_by_rows(const float* y, const float* x, int pitch,
                                               int held, float4 (&acc)[kPasses][TB / 4]) {
  const int tg = lane() & 3;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int c = 4 * (32 * pass + 8 * (warp() & 3) + (lane() >> 2));
    if (c >= held) continue;
#pragma unroll 1
    for (int p = 0; p < kTile; p += 4) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = *reinterpret_cast<const float4*>(x + (p + k) * pitch + c);
#pragma unroll
      for (int j = 0; j < TB / 4; ++j)
        acc[pass][j] = xattn::axpy4(
            *reinterpret_cast<const float4*>(y + (tg + 4 * j) * kByToken + p), v, acc[pass][j]);
    }
  }
}

// Whether a launch can take 16-byte loads and stores: every pointer 16-byte aligned and C a
// multiple of 4 floats.
inline bool aligned16(std::initializer_list<const void*> ptrs, int C) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return C % 4 == 0;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<TB>, bool_constant<VEC>) at the launch's token bucket (pixel_attn_t_bucket), of at
// most kPixelAttnMaxT tokens (the backward's) or, `forward`, of kPixelAttnMaxTForward
template <bool forward = false, class F>
cudaError_t dispatch(int tb, bool vec, F&& f) {
  auto by_vec = [&](auto B) { return vec ? f(B, std::true_type{}) : f(B, std::false_type{}); };
  if constexpr (forward) {
    if (tb == 40) return by_vec(Int<40>{});
    if (tb == 48) return by_vec(Int<48>{});
  }
  return tb == 8    ? by_vec(Int<8>{})
         : tb == 16 ? by_vec(Int<16>{})
         : tb == 20 ? by_vec(Int<20>{})
         : tb == 24 ? by_vec(Int<24>{})
                    : by_vec(Int<32>{});
}

// A launch of `kernel` on `blocks` blocks in clusters of `cluster` along x, *shape
// completed with the grid once CUDA has taken it.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), long long blocks, int cluster, long long smem,
                   cudaStream_t stream, PixelAttnLaunchShape* shape, Args... args) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
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
  if (err == cudaSuccess && shape != nullptr) {
    shape->blocks = (int)cfg.gridDim.x;
    shape->cluster = (int)attr[0].val.clusterDim.x;
    shape->threads = (int)cfg.blockDim.x;
    shape->smem = (long long)cfg.dynamicSmemBytes;
  }
  return err;
}

}  // namespace pattn
}  // namespace tris
