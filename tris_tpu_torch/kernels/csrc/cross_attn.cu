// K2: the BilateralPrompt cross-attention, forward, float32.
//
// Replaces the two single-head attentions of the JAX package's
// tris_tpu/models/fusion.py::BilateralPrompt (lines 78-89), channel width m,
// logits divided by sqrt(Ci) (Ci = the language width, fusion.py:85-86):
//   vision -> text:  new_vis[pair, p] = softmax_t(Qv[b, p] . Kt[pair, t] / d) . Vt[pair]
//   text -> vision:  new_lan[pair, t] = softmax_p(Qt[pair, t] . Kv[b, p] / d) . Vv[b]
// with b = pair / S: the vision projections exist once per image and every
// one of its S sentences (pairs) reads them in place, so the JAX package's
// jnp.repeat over sentences (stage1.py:164-166) is never materialised.
//
// Shapes on the paths: the stage-1 train step and forward(train=False), N =
// 48 images, HW = 100 pixels (320 px), T = 48 texts, S = 1, m = 1024;
// response_maps (eval, PRMS, stage-2 eval) 8 images, S = 4, T = 1.
//
// Bound: bytes (each output float costs T or HW multiply-adds). One launch
// for both halves: a tile is kCrossAttnRows query rows of one group against
// the group's keys -
//  - text -> vision: a group is an image, its rows all S x T text queries of
//    its pairs, so the S pairs share one read of the image's Kv and Vv;
//  - vision -> text: a group is a pair, its rows the image's HW pixels.
// A cluster of cross_attn_slices(m) blocks takes a tile, one 256-channel
// slice each (cross_attn_tiles.cuh): each block reads its slice of the
// tile's Q, K and V once, forms partial logits, sums the cluster's partials
// in rank order through distributed shared memory, takes the row softmax
// and writes its slice of P V. So each K/V element is read once per tile
// of kCrossAttnRows queries, not once per query. The text tiles come first in the grid
// (HW keys: the longer ones). A tile with more keys than a key block
// (kCrossAttnKeyBlock: HW past 512 px, or T) forms each block's logits twice:
// a first round for each row's max and sum of exponentials over all blocks,
// a second for the softmax and P V, summed over the blocks in order; the
// paths' tiles have at most 100 keys, one block. At T = 1 a vision tile's softmax is over one
// key, exp(0) / 1 = 1 exactly: its logits are skipped and P = 1, so new_vis
// is exactly Vt.
//
// --bf16 (the same kernel, instantiated per operand dtypes): with the fusion on float32
// leaves the vision projections are float32 and the text ones bfloat16, widened as they are
// staged, every product and sum float32 and the outputs float32, as jnp promotes them; on
// bfloat16 leaves all six are bfloat16, each logit, its quotient by div (given in bfloat16),
// and each op of the softmax (x - max, exp, the sum, the quotient) rounded to bfloat16, P V
// summed in float32 and rounded at the store; such a launch takes one key block (HW and T
// at most kCrossAttnKeyBlock), where the softmax's max is over every key before any exp.
// With pv and pt (training), it writes the probabilities as the float32 launch does, each
// rounded to bfloat16 on bfloat16 leaves, for the backward (cross_attn_bwd.cu).

#include <type_traits>

#include "cross_attn_tiles.cuh"

namespace {

using namespace tris::xattn;

// One half's groups: query plane g / q_div ([rows, m] at q), key and value
// planes g ([keys, m] at k, v), output plane g ([rows, m] at out), and, when
// p is not null, the probabilities' plane g ([rows, keys] at p). TQ, TK: the
// query's and the keys' and values' dtype (float or __nv_bfloat16), TO the output's.
template <class TQ, class TK, class TO>
struct HalfT {
  const TQ* q;
  const TK *k, *v;
  TO* out;
  float* p;
  int rows, keys, q_div;
};
using Half = HalfT<float, float, float>;


// Tile t of half h: a block's share (its channel slice) of kRows query rows against every key.
// smem: P [kRows][pitch], the partial logits [kRows][pitch], the staging area.
// kBlocks: a launch whose tiles may have more keys than a key block (a kernel of its own, so
// the sum it carries from block to block costs the one-block kernel no registers). kRound:
// bfloat16 rounding (one key block only: the launcher refuses more).
template <int KS, bool kBlocks, bool kRound, class TQ, class TK, class TO>
__device__ __forceinline__ void tile_body(const HalfT<TQ, TK, TO>& h, int t, int m, int kcap,
                                          float div, float* pm, float* part, float* stage,
                                          int pitch) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int tiles = row_tiles(h.rows);
  const int g = t / tiles, q0 = (t % tiles) * kRows, nrows = min(kRows, h.rows - q0);
  const int c0 = rank * kSlice, mc = min(kSlice, m - c0), nk = h.keys;
  const TQ* q = h.q + ((long long)(g / h.q_div) * h.rows + q0) * m;
  const TK* k = h.k + (long long)g * nk * m;
  const TK* v = h.v + (long long)g * nk * m;
  TO* out = h.out + ((long long)g * h.rows + q0) * m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kRowsPerWarp = kRows / kWarps;
  auto keys_of = [&](int kb) { return min(kKeyBlock, nk - kb * kKeyBlock); };
  using Pv = PvStream<1, TK, TO>;
  // P V over key block kb
  auto pv_of = [&](int kb) {
    return Pv{{pm}, {v + (long long)kb * kKeyBlock * m}, {out}, keys_of(kb), m, c0, mc};
  };
  // rank 0 writes key block kb of P (every block of the cluster holds the same)
  auto store_p = [&](int kb) {
    if (h.p == nullptr || rank != 0) return;
    float* po = h.p + ((long long)g * h.rows + q0) * nk + kb * kKeyBlock;
    for (int r = warp; r < nrows; r += kWarps)
      for (int j = lane; j < keys_of(kb); j += 32) po[(long long)r * nk + j] = pm[r * pitch + j];
  };
  if (nk == 1) {  // a softmax over one key: P = 1, zeros to the 4-key step
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads)
      pm[(i / 4) * pitch + i % 4] = i % 4 == 0 ? 1.f : 0.f;
    const Pv pv = pv_of(0);
    pv.prologue(stage);
    __syncthreads();
    store_p(0);
    pv.run(pitch, nrows, stage);
    return;
  }

  // the tile's logits over key block kb, divided by div, into pm (every block
  // of the cluster gets all of them); with pv, V's first chunks come in meanwhile
  int rounds = 0;
  auto logits = [&](int kb, const Pv* pv) {
    if (rounds++ > 0) {
      __syncthreads();  // the staging area is free
      cluster_wait();   // no block reads this one's partials any more
    }
    slice_logits<KS>(q, k + (long long)kb * kKeyBlock * m, nrows, keys_of(kb), m, c0, mc, kcap,
                     stage, part, pitch);
    if (pv != nullptr) pv->prologue(stage);
    cluster.sync();  // every block's partials are written
    gather_rows(cluster, part, pm, pitch, (keys_of(kb) + 31) >> 5, kRows, true, div, kRound);
    cluster_arrive();  // this block reads the others' partials no more
    __syncthreads();
  };
  // exp(x - mx), each op rounded to bfloat16 under kRound
  auto expd = [](float x, float mx) {
    return kRound ? tris::round_bf16(expf(tris::round_bf16(x - mx))) : expf(x - mx);
  };
  // row r (warp w: rows 4w..4w+3): its running max and sum of exp(x - max)
  // over key blocks 0..kb, from key block kb's logits in pm (under kRound, one block, the sum
  // rounded to bfloat16)
  float rmax[kRowsPerWarp], rsum[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) rmax[rr] = -INFINITY, rsum[rr] = 0.f;
  auto stats = [&](int kb) {
    const int kn = keys_of(kb), slots = (kn + 31) >> 5;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float x[KS], mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int j = lane + 32 * i;
        x[i] = i < slots && j < kn ? pm[r * pitch + j] : -INFINITY;
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(rmax[rr], tris::warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KS; ++i) sum += lane + 32 * i < kn ? expd(x[i], mx) : 0.f;
      if constexpr (kRound)
        rsum[rr] = tris::round_bf16(tris::warp_sum(sum));
      else
        rsum[rr] = rsum[rr] * expf(rmax[rr] - mx) + tris::warp_sum(sum);
      rmax[rr] = mx;
    }
  };
  // key block kb of the rows' softmax, in place, zeros from its keys to the slots' end
  auto normalize = [&](int kb) {
    const int kn = keys_of(kb), slots = (kn + 31) >> 5;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int j = lane + 32 * i;
        if (i < slots) {
          float p = 0.f;
          if (j < kn) {
            p = expd(pm[r * pitch + j], rmax[rr]) / rsum[rr];
            if constexpr (kRound) p = tris::round_bf16(p);
          }
          pm[r * pitch + j] = p;
        }
      }
    }
    __syncthreads();
  };

  const int nkb = key_blocks(nk);
  if (!kBlocks || nkb == 1) {  // one key block: its logits formed once
    const Pv pv = pv_of(0);
    logits(0, &pv);
    stats(0);
    normalize(0);
    store_p(0);
    pv.run(pitch, nrows, stage);
  } else {  // the rows' statistics over every key block, then P V block by block
    for (int kb = 0; kb < nkb; ++kb) {
      logits(kb, nullptr);
      stats(kb);
    }
    float4 acc[8];
    Pv::clear(acc);
    for (int kb = 0; kb < nkb; ++kb) {
      const Pv pv = pv_of(kb);
      logits(kb, &pv);
      normalize(kb);
      store_p(kb);
      pv.run(pitch, nrows, stage, acc, kb == nkb - 1);
    }
  }
}

// The text half h0 (its queries the text projections, keys and values the vision ones) and
// the vision half h1, their tiles in that order along the grid.
template <int KS, bool kBlocks, int kMode>
__global__ void __launch_bounds__(kThreads, KS <= 4 ? kMinBlocks : 1)
cross_attn_kernel(HalfT<typename Dtypes<kMode>::Txt, typename Dtypes<kMode>::Vis,
                        typename Dtypes<kMode>::Out> h0,
                  HalfT<typename Dtypes<kMode>::Vis, typename Dtypes<kMode>::Txt,
                        typename Dtypes<kMode>::Out> h1,
                  int tiles0, int m, int kcap, float div) {
  extern __shared__ float4 smem4[];
  float* pm = reinterpret_cast<float*>(smem4);
  const int pitch = tile_pitch(kcap);
  float* part = pm + kRows * pitch;
  float* stage = part + kRows * pitch;
  const int tile = blockIdx.x / cg::this_cluster().num_blocks();
  constexpr bool kRound = kMode == kBf16;
  if constexpr (kMode == kF32) {  // one type of half: one body
    const Half h = tile < tiles0 ? h0 : h1;
    tile_body<KS, kBlocks, kRound>(h, tile < tiles0 ? tile : tile - tiles0, m, kcap, div, pm,
                                   part, stage, pitch);
  } else if (tile < tiles0) {
    tile_body<KS, kBlocks, kRound>(h0, tile, m, kcap, div, pm, part, stage, pitch);
  } else {
    tile_body<KS, kBlocks, kRound>(h1, tile - tiles0, m, kcap, div, pm, part, stage, pitch);
  }
  cluster_wait();  // no block leaves while its partials may be read
}

template <int kMode>
cudaError_t launch_mode(const void* qv, const void* kv, const void* vv, const void* qt,
                        const void* kt, const void* vt, void* new_vis, void* new_lan, float* pv,
                        float* pt, int P, int HW, int T, int m, int S, float div,
                        cudaStream_t stream, tris::LaunchShape* shape) {
  using D = Dtypes<kMode>;
  using V = typename D::Vis;
  using X = typename D::Txt;
  using O = typename D::Out;
  if (!tris::cross_attn_takes(m) || S < 1 || P % S) return cudaErrorInvalidValue;
  if (kMode == kBf16 && key_blocks(HW > T ? HW : T) > 1) return cudaErrorInvalidValue;
  const int N = P / S, slices = tris::cross_attn_slices(m);
  const HalfT<X, V, O> text{static_cast<const X*>(qt), static_cast<const V*>(kv),
                            static_cast<const V*>(vv), static_cast<O*>(new_lan), pt, S * T, HW, 1};
  const HalfT<V, X, O> vis{static_cast<const V*>(qv), static_cast<const X*>(kt),
                           static_cast<const X*>(vt), static_cast<O*>(new_vis), pv, HW, T, S};
  const int tiles_text = N * row_tiles(S * T), tiles_vis = P * row_tiles(HW);
  const int kcap = key_capacity(HW > T ? HW : T);
  const size_t smem =
      sizeof(float) * ((size_t)2 * kRows * tile_pitch(kcap) + stage_floats(kcap));
  const int blocks = slices * (tiles_text + tiles_vis);
  if (key_blocks(HW > T ? HW : T) > 1)
    return launch_clusters(cross_attn_kernel<8, true, kMode>, blocks, slices, smem, stream, shape,
                           text, vis, tiles_text, m, kcap, div);
  if (kcap <= 128)
    return launch_clusters(cross_attn_kernel<4, false, kMode>, blocks, slices, smem, stream,
                           shape, text, vis, tiles_text, m, kcap, div);
  return launch_clusters(cross_attn_kernel<8, false, kMode>, blocks, slices, smem, stream, shape,
                         text, vis, tiles_text, m, kcap, div);
}

}  // namespace

cudaError_t tris::cross_attn(const float* qv, const float* kv, const float* vv, const float* qt,
                             const float* kt, const float* vt, float* new_vis, float* new_lan,
                             float* pv, float* pt, int P, int HW, int T, int m, int S, float div,
                             cudaStream_t stream, LaunchShape* shape) {
  return launch_mode<kF32>(qv, kv, vv, qt, kt, vt, new_vis, new_lan, pv, pt, P, HW, T, m, S, div,
                           stream, shape);
}

cudaError_t tris::cross_attn_bf16(const void* qv, const void* kv, const void* vv,
                                  const Bf16Bits* qt, const Bf16Bits* kt, const Bf16Bits* vt,
                                  void* new_vis, void* new_lan, float* pv, float* pt,
                                  bool vis_bf16, int P, int HW, int T, int m, int S, float div,
                                  cudaStream_t stream, LaunchShape* shape) {
  if (vis_bf16)
    return launch_mode<kBf16>(qv, kv, vv, qt, kt, vt, new_vis, new_lan, pv, pt, P, HW, T, m, S,
                              div, stream, shape);
  return launch_mode<kMixed>(qv, kv, vv, qt, kt, vt, new_vis, new_lan, pv, pt, P, HW, T, m, S,
                             div, stream, shape);
}
