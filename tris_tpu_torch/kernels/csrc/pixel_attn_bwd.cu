// K11 backward: PixelAttention's pixel-word attention, float32.
//
// The gradient of G = softmax(q Lk^T / d) Lv (tris_tpu/models/fusion.py::
// PixelAttention, lines 37-40), which the JAX package takes by autodiff.
// Per pair i of image n = i / S, with A = softmax(q Lk^T / d) [HW, T]:
//   dA  = dG Lv^T,   dL = A * (dA - rowsum(A * dA))   (the logits' gradient, times d)
//   dq[n]  = sum over the image's S pairs of dL Lk / d
//   dLk[i] = dL^T q[n] / d,   dLv[i] = A^T dG[i]
//
// Shapes on the stage-2 train path: B = 48 images, one sentence each, T = 20
// tokens; c2 HW = 1600 x Ci = 512, c3 400 x 1024, c4 100 x 2048.
//
// Bound: bytes (q and dG read, dq written; 5 T multiply-adds per element of
// q, near the FP32 rate's worth at T = 20). Two kernels, no atomics, so the
// gradient is the same run to run (pixel_attn_tiles.cuh):
//  1. pixel_attn_bwd_probs_dq_kernel: a block per (image, group of
//     pixel_attn_block_tiles(N, HW, C) pixel tiles, channel slice of at most
//     256), clusters splitting C (2 at c2, 4 at c3, 8 at c4); one block an SM
//     (its register tiles take up to 255 registers a thread). For each pair
//     and each of its tiles in turn it forms the logits (warps 0-3) and dA
//     (warps 4-7) in register tiles from the tile's q and dG and the pair's
//     keys and values (staged once a pair), adds the partials in warp order
//     and the cluster's in rank order, recomputes A, forms dL in registers,
//     adds the tile's dL^T q (warps 0-3) and A^T dG (warps 4-7) to register
//     tiles it writes, once its group's tiles are done, as the group's
//     partials, then forms dq for its slice (summed over the image's pairs in
//     ascending order, the later ones added to what the first wrote) while
//     the next tile's q and dG are copied in.
//  2. pixel_attn_bwd_dkv_kernel: dLk and dLv, each the sum of its groups'
//     partials in ascending order (dLk then divided by d).
// No [P, HW, T] scratch: A and dL live in shared memory. The partials are
// 2 P groups T C floats (27.5 MB at c2: 7 groups of 8 tiles).

#include "pixel_attn_tiles.cuh"

namespace {

using namespace tris::pattn;

// grid: (image, group, rank) with rank fastest, clusters of the ranks; width channels a rank,
// per_block tiles a group, groups groups an image
template <int TB, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
pixel_attn_bwd_probs_dq_kernel(const float* __restrict__ dg, const float* __restrict__ q,
                               const float* __restrict__ lk, const float* __restrict__ lv,
                               float* __restrict__ dq, float* __restrict__ part_k,
                               float* __restrict__ part_v, int HW, int T, int C, int S, int width,
                               int per_block, int groups, float div) {
  constexpr int kTP = Tok<TB>::kPitch;
  extern __shared__ float4 smem4[];
  const int held = tris::pixel_attn_held(width), nsub = tris::pixel_attn_subslices(width);
  const int pitch = tris::pixel_attn_pitch(held);
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const gs = qs + kTile * pitch;
  float* const ks = gs + kTile * pitch;
  float* const vs = ks + TB * pitch;
  float* const red = vs + TB * pitch;  // the warps' partials; the whole logits and dA over them
  float* const part = red + kWarps * kTile * kTP;  // the block's logits, then dA
  float* const dlr = part + 2 * kTile * kTP;       // dL [kTile][kTP]
  float* const dlt = dlr + kTile * kTP;            // dL [TB][kByToken]
  float* const at = dlt + TB * kByToken;           // A [TB][kByToken]
  float* const full = red;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int ntiles = tris::pixel_attn_tiles(HW), bid = blockIdx.x / ranks;
  const int n = bid / groups, g = bid % groups;
  const bool by_q = warp() < 4;  // warps 0-3: logits, dLk; 4-7: dA, dLv

  // q's and dG's rows of a tile of pair j, sub-slice u, into qs and gs (keys with `keys`)
  auto stage_tile = [&](int j, int tile, int u, bool keys) {
    const long long pair = (long long)n * S + j;
    const int c0 = rank * width + u * tris::kPixelAttnSlice, p0 = tile * kTile;
    const int cw = max(0, min(min(held, width - u * tris::kPixelAttnSlice), C - c0));
    const int nrows = min(kTile, HW - p0);
    stage<VEC>(qs, pitch, q + ((long long)n * HW + p0) * C + c0, C, kTile, nrows, held, cw, q);
    stage<VEC>(gs, pitch, dg + (pair * HW + p0) * C + c0, C, kTile, nrows, held, cw, dg);
    if (keys) stage<VEC>(ks, pitch, lk + pair * T * C + c0, C, TB, T, held, cw, lk);
  };
  const int first = g * per_block, end = min(ntiles, first + per_block);
  float4 kv[kPasses][TB / 4];  // the thread's dLk (or dLv) sums over the group's tiles
  auto clear_sums = [&]() {
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
      for (int j = 0; j < TB / 4; ++j) kv[pass][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  bool later = false;
  // With one sub-slice the block's items (pair, tile) run in order, each tile's q and dG
  // copied while the tile before forms dq; the pair's keys and values once a pair.
  if (nsub == 1) stage_tile(0, first, 0, false);
  for (int j = 0; j < S; ++j) {
    const long long pair = (long long)n * S + j;
    clear_sums();
    for (int tile = first; tile < end; ++tile) {
      const bool last = tile + 1 == end;
      const int p0 = tile * kTile, nrows = min(kTile, HW - p0);
      float acc[4][TB / 4] = {};
      for (int u = 0; u < nsub; ++u) {
        const int c0 = rank * width + u * tris::kPixelAttnSlice;
        const int cw = max(0, min(min(held, width - u * tris::kPixelAttnSlice), C - c0));
        __syncthreads();  // the block is done with the staged rows
        if (nsub > 1) stage_tile(j, tile, u, false);
        if (nsub > 1 || tile == first) {
          stage<VEC>(ks, pitch, lk + pair * T * C + c0, C, TB, T, held, cw, lk);
          stage<VEC>(vs, pitch, lv + pair * T * C + c0, C, TB, T, held, cw, lv);
        }
        tris::cp_async_commit();
        tris::cp_async_wait<0>();
        __syncthreads();
        const int2 r = share(held / 4, warp() & 3, 4);
        logits<TB>(by_q ? qs : gs, by_q ? ks : vs, pitch, r.x, r.y, acc);
      }
      put_logits<TB>(red, acc);
      __syncthreads();
      exchange<TB>(cluster, red, part, full, 2, later, div);
      later = true;
      if (warp() < 4) {  // A again, and dL = A (dA - sum_t A dA)
        float a[TB / 4];
        softmax<TB>(full, T, a);
        const int p = warp() * 8 + (lane() >> 2), tl = lane() & 3;
        float d[TB / 4], dsum = 0.f;
#pragma unroll
        for (int k = 0; k < TB / 4; ++k) {
          d[k] = tl + 4 * k < T ? full[(kTile + p) * kTP + tl + 4 * k] : 0.f;
          dsum = fmaf(a[k], d[k], dsum);
        }
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
#pragma unroll
        for (int k = 0; k < TB / 4; ++k) {
          const int t = tl + 4 * k;
          const float dl = a[k] * (d[k] - dsum);
          dlr[p * kTP + t] = dl;
          dlt[t * kByToken + p] = dl;
          at[t * kByToken + p] = a[k];
        }
      }
      for (int u = 0; u < nsub; ++u) {
        const int c0 = rank * width + u * tris::kPixelAttnSlice;
        const int cw = max(0, min(min(held, width - u * tris::kPixelAttnSlice), C - c0));
        if (nsub > 1) {
          __syncthreads();
          stage_tile(j, tile, u, true);
          tris::cp_async_commit();
          tris::cp_async_wait<0>();
        }
        __syncthreads();  // dL, A and the staged rows
        tokens_by_rows<TB>(by_q ? dlt : at, by_q ? qs : gs, pitch, held, kv);
        if (last) {
          float* const pt = (by_q ? part_k : part_v) + ((pair * groups + g) * T) * C + c0;
          const int tg = lane() & 3;
#pragma unroll
          for (int pass = 0; pass < kPasses; ++pass) {
            const int c = 4 * (32 * pass + 8 * (warp() & 3) + (lane() >> 2));
#pragma unroll
            for (int k = 0; k < TB / 4; ++k) {
              if (c < held && c < cw && tg + 4 * k < T)
                put4<VEC>(pt + (long long)(tg + 4 * k) * C + c, kv[pass][k], cw - c, false);
            }
          }
          clear_sums();
        }
        if (nsub == 1 && (!last || j + 1 < S)) {  // the next item's q and dG land during dq
          __syncthreads();
          stage_tile(last ? j + 1 : j, last ? first : tile + 1, 0, false);
        }
        rows_by_tokens<TB, VEC>(dlr, ks, pitch, held, dq + ((long long)n * HW + p0) * C + c0, C,
                                nrows, cw, div, j > 0);
      }
    }
  }
  tris::cp_async_commit();
  tris::cp_async_wait<0>();
  if (later) tris::xattn::cluster_wait();  // the others are done reading this block's partials
}

// dlk = (sum over the groups g ascending of part_k[pair][g]) / div, dlv the same of part_v
// without the division: n = P T C floats, `per_pair` = T C of them a pair.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
pixel_attn_bwd_dkv_kernel(const float* __restrict__ part_k, const float* __restrict__ part_v,
                          float* __restrict__ dlk, float* __restrict__ dlv, long long n,
                          long long per_pair, int groups, float div) {
  constexpr int kW = VEC ? 4 : 1;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * kW; e < n;
       e += stride * kW) {
    const long long pair = e / per_pair, r = e - pair * per_pair;
    const long long base = pair * groups * per_pair + r;
    if constexpr (VEC) {
      float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
      for (int g = 0; g < groups; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(part_k + base + g * per_pair);
        const float4 b = *reinterpret_cast<const float4*>(part_v + base + g * per_pair);
        sk = make_float4(sk.x + a.x, sk.y + a.y, sk.z + a.z, sk.w + a.w);
        sv = make_float4(sv.x + b.x, sv.y + b.y, sv.z + b.z, sv.w + b.w);
      }
      *reinterpret_cast<float4*>(dlk + e) =
          make_float4(sk.x / div, sk.y / div, sk.z / div, sk.w / div);
      *reinterpret_cast<float4*>(dlv + e) = sv;
    } else {
      float sk = 0.f, sv = 0.f;
      for (int g = 0; g < groups; ++g) {
        sk += part_k[base + g * per_pair];
        sv += part_v[base + g * per_pair];
      }
      dlk[e] = sk / div;
      dlv[e] = sv;
    }
  }
}

}  // namespace

cudaError_t tris::pixel_attn_bwd(const float* dg, const float* q, const float* lk, const float* lv,
                                 float* partials, float* dq, float* dlk, float* dlv, int P,
                                 int HW, int T, int C, int S, float div, cudaStream_t stream,
                                 PixelAttnLaunchShape* shapes) {
  if (!pixel_attn_takes(T, C, S, true)) return cudaErrorInvalidValue;
  if (P == 0) return cudaSuccess;
  const int tb = pixel_attn_t_bucket(T), ranks = pixel_attn_ranks(C, true);
  const long long N = P / S;
  const int width = pixel_attn_width(C, true), per_block = pixel_attn_block_tiles(N, HW, C, true);
  const int groups = pixel_attn_groups(N, HW, C, true);
  const bool vec = pattn::aligned16({dg, q, lk, lv, partials, dq, dlk, dlv}, C);
  const long long per_pair = (long long)T * C, total = P * per_pair;
  float* const part_k = partials;
  float* const part_v = partials + (long long)P * groups * per_pair;
  cudaError_t err = cudaSuccess;
  if (HW > 0) {
    const long long blocks = N * groups * ranks;
    shapes[0] = {0, 0, 0, tb, pattn::kTile, width, groups, vec ? 16 : 4, 0};
    err = pattn::dispatch(tb, vec, [&](auto B, auto V) {
      constexpr int TB = decltype(B)::value;
      return pattn::launch(pixel_attn_bwd_probs_dq_kernel<TB, decltype(V)::value>, blocks, ranks,
                           pixel_attn_smem(TB, C, true), stream, &shapes[0], dg, q, lk, lv, dq,
                           part_k, part_v, HW, T, C, S, width, per_block, groups, div);
    });
    if (err != cudaSuccess) return err;
  }
  // a thread per 4 floats (or 1), at most kPixelAttnSumBlocks blocks, looping past
  const long long items = (total + (vec ? 3 : 0)) / (vec ? 4 : 1);
  long long blocks = (items + pattn::kThreads - 1) / pattn::kThreads;
  blocks = blocks < kPixelAttnSumBlocks ? blocks : kPixelAttnSumBlocks;
  shapes[1] = {0, 0, 0, tb, pattn::kTile, width, groups, vec ? 16 : 4, 0};
  auto dkv = vec ? &pixel_attn_bwd_dkv_kernel<true> : &pixel_attn_bwd_dkv_kernel<false>;
  return pattn::launch(dkv, blocks, 1, 0, stream, &shapes[1], part_k, part_v, dlk, dlv, total,
                       per_pair, groups, div);
}
