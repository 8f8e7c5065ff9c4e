// K11: PixelAttention's pixel-word attention, forward, float32.
//
// Replaces the two einsums and the softmax between them of the JAX
// package's tris_tpu/models/fusion.py::PixelAttention (lines 37-40):
//   G[pair, p] = softmax_t(q[n, p] . Lk[pair, t] / d) . Lv[pair]
// with n = pair / S: q (the InstanceNorm'd Wq projection of the pixels)
// exists once per image, and each of the image's S sentences (pairs) reads it.
// No token mask: every one of the T tokens attends, as in JAX and the
// reference. The Dense layers around it stay cuBLAS GEMMs.
//
// Shapes on the stage-2 train path (B = 48 images, one sentence each, T = 20
// tokens): c2 HW = 1600 pixels x Ci = 512, c3 400 x 1024, c4 100 x 2048; on
// the eval path 8 images x S = 4 pairs; the demo's T = 20 a comma-separated phrase (up to
// kPixelAttnMaxTForward = 48 tokens here, 32 in the backward). One launch per call.
//
// Bound: bytes (q read once and G written once; 2 T multiply-adds per element
// of G, a third of the FP32 rate's worth at T = 20). Design
// (pixel_attn_tiles.cuh): a block per (image, group of 32-pixel tiles,
// channel slice of at most 256), clusters of pixel_attn_ranks(C) blocks
// splitting C (2 at c2, 4 at c3, 8 at c4). A block takes its group's tiles in
// turn and serves the image's S pairs from one read of a tile's q, in order;
// per (tile, pair): the logits in register tiles of 4 pixels x T / 4 tokens
// over an eighth of the slice a warp, the warps' partials added in order, the
// cluster's in rank order through distributed shared memory, the softmax in
// registers (4 lanes a pixel), then G for its slice in register tiles of 4
// pixels x 4 channels, written with 16-byte stores. The next tile's q (and,
// with S > 1, the next pair's keys and values) is copied while the current
// one is formed; with S = 1 a block stages the pair's keys and values once.

#include "pixel_attn_tiles.cuh"

namespace {

using namespace tris::pattn;

// The logits of warp-partials acc made probabilities in prob, through the cluster's round.
template <int TB>
__device__ __forceinline__ void probabilities(cg::cluster_group& cluster,
                                              const float (&acc)[4][TB / 4], float* red,
                                              float* part, float* prob, int T, bool later,
                                              float div) {
  put_logits<TB>(red, acc);
  __syncthreads();
  exchange<TB>(cluster, red, part, red, 1, later, div);
  if (warp() < 4) {
    float s[TB / 4];
    softmax<TB>(red, T, s);
    float* pr = prob + (warp() * 8 + (lane() >> 2)) * Tok<TB>::kPitch + (lane() & 3);
#pragma unroll
    for (int k = 0; k < TB / 4; ++k) pr[4 * k] = s[k];
  }
}

// grid: (image, group of per_block tiles, rank) with rank fastest, clusters of the ranks;
// width channels a rank, `groups` groups an image
template <int TB, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
pixel_attn_kernel(const float* __restrict__ q, const float* __restrict__ lk,
                  const float* __restrict__ lv, float* __restrict__ out, int HW, int T, int C,
                  int S, int width, int per_block, int groups, float div) {
  constexpr int kTP = Tok<TB>::kPitch;
  extern __shared__ float4 smem4[];
  const int held = tris::pixel_attn_held(width), nsub = tris::pixel_attn_subslices(width);
  const int pitch = tris::pixel_attn_pitch(held);
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + kTile * pitch;
  float* const vs = ks + TB * pitch;
  float* const red = vs + TB * pitch;  // the warps' partial logits; the whole logits over them
  float* const part = red + kWarps * kTile * kTP;
  float* const prob = part + kTile * kTP;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int ntiles = tris::pixel_attn_tiles(HW), bid = blockIdx.x / ranks;
  const int n = bid / groups, first = bid % groups * per_block;
  const int end = min(ntiles, first + per_block);
  auto q_tile = [&](int tile) { return q + ((long long)n * HW + tile * kTile) * C; };
  auto rows = [&](int tile) { return min(kTile, HW - tile * kTile); };
  auto pair_of = [&](int j) { return (long long)n * S + j; };

  if (nsub == 1) {
    // The block's items (tile, pair) in order, each one's copies issued while the one
    // before is formed: a tile's q once its last pair's logits are formed, a pair's keys
    // once the last ones are (the values once G is formed); with S = 1 the keys and values
    // are staged once a block. Groups of copies: A (q, keys) and B (values), alternately.
    const int c0 = rank * width, cw = min(held, C - c0);
    stage<VEC>(qs, pitch, q_tile(first) + c0, C, kTile, rows(first), held, cw, q);
    stage<VEC>(ks, pitch, lk + pair_of(0) * T * C + c0, C, TB, T, held, cw, lk);
    tris::cp_async_commit();
    stage<VEC>(vs, pitch, lv + pair_of(0) * T * C + c0, C, TB, T, held, cw, lv);
    tris::cp_async_commit();
    bool later = false;
    for (int tile = first; tile < end; ++tile) {
      for (int j = 0; j < S; ++j) {
        const bool next_tile = j + 1 == S, more = !next_tile || tile + 1 < end;
        tris::cp_async_wait<1>();  // A: this tile's q and this pair's keys
        __syncthreads();
        float acc[4][TB / 4] = {};
        const int2 k = share(held / 4, warp(), kWarps);
        logits<TB>(qs, ks, pitch, k.x, k.y, acc);
        __syncthreads();  // the block is done with q and the keys
        if (more && next_tile)
          stage<VEC>(qs, pitch, q_tile(tile + 1) + c0, C, kTile, rows(tile + 1), held, cw, q);
        if (more && S > 1)
          stage<VEC>(ks, pitch, lk + pair_of(next_tile ? 0 : j + 1) * T * C + c0, C, TB, T,
                     held, cw, lk);
        tris::cp_async_commit();
        probabilities<TB>(cluster, acc, red, part, prob, T, later, div);
        later = true;
        tris::cp_async_wait<1>();  // B: this pair's values
        __syncthreads();
        rows_by_tokens<TB, VEC>(prob, vs, pitch, held,
                                out + (pair_of(j) * HW + tile * kTile) * C + c0, C, rows(tile),
                                cw, 1.f, false);
        if (more && S > 1) {
          __syncthreads();  // the block is done with the values
          stage<VEC>(vs, pitch, lv + pair_of(next_tile ? 0 : j + 1) * T * C + c0, C, TB, T,
                     held, cw, lv);
        }
        tris::cp_async_commit();
      }
    }
    tris::cp_async_wait<0>();
  } else {
    // Wider slices, a tile a block: each item's sub-slices in turn.
    for (int j = 0; j < S; ++j) {
      const long long pair = pair_of(j);
      float acc[4][TB / 4] = {};
      for (int u = 0; u < nsub; ++u) {
        const int c0 = rank * width + u * tris::kPixelAttnSlice;
        const int cw = max(0, min(min(held, width - u * tris::kPixelAttnSlice), C - c0));
        __syncthreads();  // the block is done with the staged rows
        stage<VEC>(qs, pitch, q_tile(first) + c0, C, kTile, rows(first), held, cw, q);
        stage<VEC>(ks, pitch, lk + pair * T * C + c0, C, TB, T, held, cw, lk);
        tris::cp_async_commit();
        tris::cp_async_wait<0>();
        __syncthreads();
        const int2 k = share(held / 4, warp(), kWarps);
        logits<TB>(qs, ks, pitch, k.x, k.y, acc);
      }
      probabilities<TB>(cluster, acc, red, part, prob, T, j > 0, div);
      for (int u = 0; u < nsub; ++u) {
        const int c0 = rank * width + u * tris::kPixelAttnSlice;
        const int cw = max(0, min(min(held, width - u * tris::kPixelAttnSlice), C - c0));
        __syncthreads();
        stage<VEC>(vs, pitch, lv + pair * T * C + c0, C, TB, T, held, cw, lv);
        tris::cp_async_commit();
        tris::cp_async_wait<0>();
        __syncthreads();  // P and the values
        rows_by_tokens<TB, VEC>(prob, vs, pitch, held, out + (pair * HW + first * kTile) * C + c0,
                                C, rows(first), cw, 1.f, false);
      }
    }
  }
  tris::xattn::cluster_wait();  // the others are done reading this block's partials
}

}  // namespace

cudaError_t tris::pixel_attn(const float* q, const float* lk, const float* lv, float* out, int P,
                             int HW, int T, int C, int S, float div, cudaStream_t stream,
                             PixelAttnLaunchShape* shape) {
  if (!pixel_attn_takes(T, C, S, false)) return cudaErrorInvalidValue;
  if (P == 0 || HW == 0) return cudaSuccess;
  const int tb = pixel_attn_t_bucket(T), ranks = pixel_attn_ranks(C, false);
  const int width = pixel_attn_width(C, false);
  const bool vec = pattn::aligned16({q, lk, lv, out}, C);
  const long long N = P / S;
  const int per_block = pixel_attn_block_tiles(N, HW, C, false);
  const int groups = pixel_attn_groups(N, HW, C, false);
  const long long blocks = N * groups * ranks, smem = pixel_attn_smem(tb, C, false);
  if (shape != nullptr) *shape = {0, 0, 0, tb, pattn::kTile, width, groups, vec ? 16 : 4, 0};
  return pattn::dispatch<true>(tb, vec, [&](auto B, auto V) {
    constexpr int TB = decltype(B)::value;
    return pattn::launch(pixel_attn_kernel<TB, decltype(V)::value>, blocks, ranks, smem, stream,
                         shape, q, lk, lv, out, HW, T, C, S, width, per_block, groups, div);
  });
}
