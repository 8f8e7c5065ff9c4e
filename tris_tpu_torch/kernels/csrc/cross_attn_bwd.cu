// K2 backward: the BilateralPrompt cross-attention, float32, one sentence
// per image (S = 1).
//
// The gradient of the two single-head attentions of
// tris_tpu/models/fusion.py::BilateralPrompt (lines 85-89), which the JAX
// package takes by autodiff. Per image n, with d = sqrt(Ci):
//   vision -> text:  Av = softmax_t(Qv Kt^T / d),  new_vis = Av Vt
//   text -> vision:  At = softmax_p(Qt Kv^T / d),  new_lan = At Vv
// and, from G = d new_vis, H = d new_lan:
//   dAv = G Vt^T,  dLv = Av * (dAv - rowsum(Av * dAv)) / d,
//   dQv = dLv Kt,  dKt = dLv^T Qv,  dVt = Av^T G;
//   dAt = H Vv^T,  dLt = At * (dAt - rowsum(At * dAt)) / d,
//   dQt = dLt Kv,  dKv = dLt^T Qt,  dVv = At^T H.
//
// Shapes on the stage-1 train path: N = 48 images, HW = 100 pixels, T = 48
// texts (every text of the batch), m = 1024; one call per step.
//
// Bound: bytes (each output float costs T or HW multiply-adds). Two
// launches, the tiles of cross_attn_tiles.cuh, no atomics, so the gradient
// is the same run to run:
//  cross_attn_probs_bwd_kernel - per (image, tile of kCrossAttnRows queries)
//    of each half, a cluster of cross_attn_slices(m) blocks: each block forms
//    its slice's partial dA = G V^T (slice_logits); the partials are summed
//    in rank order through distributed shared memory, block `rank` taking
//    rows rank, rank + slices, ... of the tile: the softmax backward with the
//    probabilities P the forward wrote, written as dL ([N, HW, T] and [N, T,
//    HW], 0.9 MB each at the train shape, held in L2) to scratch.
//  cross_attn_grads_bwd_kernel - the six products coefficient x operand,
//    each [rows, m] and summed over T or HW, in two groups of three with the
//    same rows: a block per (group, image, tile of kCrossAttnRows rows,
//    256-channel slice) holds the group's three coefficient tiles in shared
//    memory and streams the three operands' rows through one PvStream.
//    The text rows (summed over HW) come first in the grid.
// With more keys than a key block (kCrossAttnKeyBlock), pass A writes each
// block's dA into dL's place and, once every block has added to the rows'
// sums of P dA, turns it into dL; pass B takes the products one after the
// other, each summed over the key blocks in order. The train step's tiles
// have at most 100 keys, one block.

#include "cross_attn_tiles.cuh"

namespace {

using namespace tris::xattn;

// One half of pass A: per image n the query plane's cotangent g ([rows, m]),
// the value plane v ([keys, m]) and the forward's probabilities p ([rows,
// keys]); dL out, [rows, keys] per image.
struct ProbsHalf {
  const float *g, *v, *p;
  float* dl;
  int rows, keys;
};

// smem: the partial dA [kRows][pitch], the staging area. kBlocks: a launch
// whose tiles may have more keys than a key block (a kernel of its own, as
// in the forward).
template <int KS, bool kBlocks>
__global__ void __launch_bounds__(kThreads, KS <= 4 ? kMinBlocks : 1)
cross_attn_probs_bwd_kernel(ProbsHalf h0, ProbsHalf h1, int tiles0, int m, int kcap, float div) {
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);
  const int pitch = tile_pitch(kcap);
  float* stage = part + kRows * pitch;
  cg::cluster_group cluster = cg::this_cluster();
  const int slices = cluster.num_blocks(), rank = cluster.block_rank();
  const int tile = blockIdx.x / slices;
  const ProbsHalf h = tile < tiles0 ? h0 : h1;
  const int t = tile < tiles0 ? tile : tile - tiles0, tiles = row_tiles(h.rows);
  const int n = t / tiles, q0 = (t % tiles) * kRows, nrows = min(kRows, h.rows - q0);
  const int c0 = rank * kSlice, mc = min(kSlice, m - c0), nk = h.keys;
  const int nkb = kBlocks ? key_blocks(nk) : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this block's rows rank, rank + slices, ... of the tile, warp w taking its
  // rows w, w + kWarps, ...: each one's lane-wise partial sum of P dA
  constexpr int kOwn = kRows / kWarps;
  float dsum[kOwn];
#pragma unroll
  for (int ki = 0; ki < kOwn; ++ki) dsum[ki] = 0.f;
  float* rows = stage;  // [kRows][pitch]: this block's rows of dA over a key block

  for (int kb = 0; kb < nkb; ++kb) {
    const int j0 = kb * kKeyBlock, kn = min(kKeyBlock, nk - j0), slots = (kn + 31) >> 5;
    if (kb > 0) {
      __syncthreads();  // the staging area is free
      cluster_wait();   // no block reads this one's partials any more
    }
    slice_logits<KS>(h.g + ((long long)n * h.rows + q0) * m, h.v + ((long long)n * nk + j0) * m,
                     nrows, kn, m, c0, mc, kcap, stage, part, pitch);
    cluster.sync();  // every block's partials are written
    gather_rows(cluster, part, rows, pitch, slots, nrows, false, 1.f);
    cluster_arrive();  // this block reads the others' partials no more
    __syncthreads();
#pragma unroll
    for (int ki = 0; ki < kOwn; ++ki) {
      const int k = warp + kWarps * ki, r = rank + slices * k;
      if (r >= nrows) break;
      const long long o = ((long long)n * h.rows + q0 + r) * nk + j0;
      float x[KS], da[KS], ds = kBlocks ? dsum[ki] : 0.f;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int j = lane + 32 * i;
        const bool in = i < slots && j < kn;
        x[i] = in ? h.p[o + j] : 0.f;
        da[i] = in ? rows[k * pitch + j] : 0.f;
        ds = fmaf(x[i], da[i], ds);
      }
      if (kBlocks) dsum[ki] = ds;
      // one key block: dL at once; more: dA into dL's place until the sum is whole
      if (nkb == 1) ds = tris::warp_sum(ds);
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int j = lane + 32 * i;
        if (j < kn) h.dl[o + j] = nkb == 1 ? x[i] * (da[i] - ds) / div : da[i];
      }
    }
  }
  if (nkb > 1) {  // each thread reads back the dA it wrote
#pragma unroll
    for (int ki = 0; ki < kOwn; ++ki) {
      const int r = rank + slices * (warp + kWarps * ki);
      if (r >= nrows) break;
      const float ds = tris::warp_sum(dsum[ki]);
      const long long o = ((long long)n * h.rows + q0 + r) * nk;
      for (int j = lane; j < nk; j += 32) h.dl[o + j] = h.p[o + j] * (h.dl[o + j] - ds) / div;
    }
  }
  cluster_wait();  // no block leaves while its partials may be read
}

// Three products of pass B with the same rows and keys: out_q[n] ([rows, m])
// = C_q[n] x_q[n], x_q[n] [keys, m], C_q[n][r][j] = coef_q[n][r][j] (coef_q
// [N, rows, keys]) or, transposed, coef_q[n][j][r] (coef_q [N, keys, rows]).
struct Products {
  const float* coef[3];
  const float* x[3];
  float* out[3];
  int trans[3];
  int rows, keys;
};

// smem: the three coefficient tiles [3][kRows][pitch], the staging area.
// kBlocks as in pass A.
template <bool kBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cross_attn_grads_bwd_kernel(Products g0, Products g1, int tiles0, int slices, int m, int kcap) {
  extern __shared__ float4 smem4[];
  float* cm = reinterpret_cast<float*>(smem4);
  const int pitch = tile_pitch(kcap);
  float* stage = cm + 3 * kRows * pitch;
  const int tile = blockIdx.x / slices, slice = blockIdx.x % slices;
  const Products pr = tile < tiles0 ? g0 : g1;
  const int t = tile < tiles0 ? tile : tile - tiles0, tiles = row_tiles(pr.rows);
  const int n = t / tiles, q0 = (t % tiles) * kRows, nrows = min(kRows, pr.rows - q0);
  const int nk = pr.keys, nkb = kBlocks ? key_blocks(nk) : 1;
  const int c0 = slice * kSlice, mc = min(kSlice, m - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // product q's coefficient tile over key block kb into dst, zeros past the
  // rows and keys to the 4-key step
  auto load_coef = [&](int q, int kb, float* dst) {
    const int j0 = kb * kKeyBlock, kn = min(kKeyBlock, nk - j0), kr = (kn + 3) / 4 * 4;
    const float* coef = pr.coef[q] + (long long)n * pr.rows * nk;
    if (pr.trans[q]) {  // lanes along the rows, which are contiguous in coef_q
      for (int j = warp; j < kr; j += kWarps)
        for (int r = lane; r < kRows; r += 32) {
          const bool ok = r < nrows && j < kn;
          const float* src = coef + (long long)(j0 + j) * pr.rows + q0 + r;
          tris::cp_async4(dst + r * pitch + j, ok ? src : coef, ok);
        }
    } else {
      for (int r = warp; r < kRows; r += kWarps)
        for (int j = lane; j < kr; j += 32) {
          const bool ok = r < nrows && j < kn;
          const float* src = coef + (long long)(q0 + r) * nk + j0 + j;
          tris::cp_async4(dst + r * pitch + j, ok ? src : coef, ok);
        }
    }
  };
  const auto x_of = [&](int q, int kb) {
    return pr.x[q] + ((long long)n * nk + (long long)kb * kKeyBlock) * m;
  };
  const auto out_of = [&](int q) { return pr.out[q] + ((long long)n * pr.rows + q0) * m; };
  if (nkb == 1) {  // the three products in one stream
#pragma unroll
    for (int q = 0; q < 3; ++q) load_coef(q, 0, cm + q * kRows * pitch);
    const PvStream<3> pv{{cm, cm + kRows * pitch, cm + 2 * kRows * pitch},
                         {x_of(0, 0), x_of(1, 0), x_of(2, 0)},
                         {out_of(0), out_of(1), out_of(2)},
                         nk, m, c0, mc};
    pv.prologue(stage);  // the coefficients land with the first chunk
    pv.run(pitch, nrows, stage);
    return;
  }
  // more keys than a block: one product after the other, each summed over its
  // key blocks in order through one coefficient tile
  float4 acc[8];
  PvStream<1>::clear(acc);
#pragma unroll
  for (int q = 0; q < 3; ++q)
    for (int kb = 0; kb < nkb; ++kb) {
      __syncthreads();  // the coefficient tile and the staging area are free
      load_coef(q, kb, cm);
      const PvStream<1> pv{{cm}, {x_of(q, kb)}, {out_of(q)},
                           min(kKeyBlock, nk - kb * kKeyBlock), m, c0, mc};
      pv.prologue(stage);
      pv.run(pitch, nrows, stage, acc, kb == nkb - 1);
    }
}

// --bf16 (training on the fusion's two leaf regimes, one key block: HW and T at most
// kCrossAttnKeyBlock). Pass A per tile as above, on the operands' dtypes: G the outputs'
// cotangent (float32 with float32 vision projections, else bfloat16), V the value plane; on
// bfloat16 leaves (kRound) dA = G V^T is rounded to bfloat16 as the JAX einsum rounds it, and
// dL = P (dA - rowsum(P dA)) / div formed in float32 and rounded once. Pass B takes the six
// products one after the other, each through one coefficient tile and a PvStream of its own
// operand's dtype, written in the gradient's dtype (the text projections' bfloat16 in both
// regimes, rounded at the store).
template <class TG, class TV>
struct ProbsHalfT {
  const TG* g;
  const TV* v;
  const float* p;
  float* dl;
  int rows, keys;
};

template <int KS, bool kRound, class TG, class TV>
__device__ __forceinline__ void probs_body(const ProbsHalfT<TG, TV>& h, int t, int m, int kcap,
                                           float div, float* part, float* stage, int pitch) {
  cg::cluster_group cluster = cg::this_cluster();
  const int slices = cluster.num_blocks(), rank = cluster.block_rank();
  const int tiles = row_tiles(h.rows);
  const int n = t / tiles, q0 = (t % tiles) * kRows, nrows = min(kRows, h.rows - q0);
  const int c0 = rank * kSlice, mc = min(kSlice, m - c0), nk = h.keys, slots = (nk + 31) >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kOwn = kRows / kWarps;
  float* rows = stage;  // [kRows][pitch]: this block's rows of dA
  slice_logits<KS>(h.g + ((long long)n * h.rows + q0) * m, h.v + (long long)n * nk * m, nrows,
                   nk, m, c0, mc, kcap, stage, part, pitch);
  cluster.sync();  // every block's partials are written
  gather_rows(cluster, part, rows, pitch, slots, nrows, false, 1.f, kRound);
  cluster_arrive();  // this block reads the others' partials no more
  __syncthreads();
#pragma unroll
  for (int ki = 0; ki < kOwn; ++ki) {
    const int k = warp + kWarps * ki, r = rank + slices * k;
    if (r >= nrows) break;
    const long long o = ((long long)n * h.rows + q0 + r) * nk;
    float x[KS], da[KS], ds = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int j = lane + 32 * i;
      const bool in = i < slots && j < nk;
      x[i] = in ? h.p[o + j] : 0.f;
      da[i] = in ? rows[k * pitch + j] : 0.f;
      ds = fmaf(x[i], da[i], ds);
    }
    ds = tris::warp_sum(ds);
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int j = lane + 32 * i;
      if (j < nk) {
        const float d = x[i] * (da[i] - ds) / div;
        h.dl[o + j] = kRound ? tris::round_bf16(d) : d;
      }
    }
  }
}

template <int KS, int kMode>
__global__ void __launch_bounds__(kThreads, KS <= 4 ? kMinBlocks : 1)
cross_attn_probs_bwd_bf16_kernel(
    ProbsHalfT<typename Dtypes<kMode>::Out, typename Dtypes<kMode>::Vis> h0,
    ProbsHalfT<typename Dtypes<kMode>::Out, typename Dtypes<kMode>::Txt> h1, int tiles0, int m,
    int kcap, float div) {
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);
  const int pitch = tile_pitch(kcap);
  float* stage = part + kRows * pitch;
  const int tile = blockIdx.x / cg::this_cluster().num_blocks();
  constexpr bool kRound = kMode == kBf16;
  if (tile < tiles0)
    probs_body<KS, kRound>(h0, tile, m, kcap, div, part, stage, pitch);
  else
    probs_body<KS, kRound>(h1, tile - tiles0, m, kcap, div, part, stage, pitch);
  cluster_wait();  // no block leaves while its partials may be read
}

// Pass B's three products of one row group with their operands' dtypes: out_q[n] ([rows, m],
// TO) = C_q[n] x_q[n] as in Products.
template <class X0, class X1, class X2, class TO>
struct ProductsT {
  const float* coef[3];
  const X0* x0;
  const X1* x1;
  const X2* x2;
  TO* out[3];
  int trans[3];
  int rows, keys;
};

// coefficient tile q of image n ([rows, keys] or, transposed, [keys, rows]) into dst, zeros
// past the rows and keys to the 4-key step; one key block
__device__ __forceinline__ void load_coef_tile(const float* coef, bool trans, int rows, int nk,
                                               int q0, int nrows, float* dst, int pitch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, kr = (nk + 3) / 4 * 4;
  if (trans) {  // lanes along the rows, which are contiguous in coef
    for (int j = warp; j < kr; j += kWarps)
      for (int r = lane; r < kRows; r += 32) {
        const bool ok = r < nrows && j < nk;
        tris::cp_async4(dst + r * pitch + j, ok ? coef + (long long)j * rows + q0 + r : coef, ok);
      }
  } else {
    for (int r = warp; r < kRows; r += kWarps)
      for (int j = lane; j < kr; j += 32) {
        const bool ok = r < nrows && j < nk;
        tris::cp_async4(dst + r * pitch + j, ok ? coef + (long long)(q0 + r) * nk + j : coef, ok);
      }
  }
}

template <class TX, class TO>
__device__ __forceinline__ void one_product(const float* coef, bool trans, const TX* x, TO* out,
                                            int n, int rows, int nk, int q0, int nrows, int m,
                                            int c0, int mc, float* cm, float* stage, int pitch) {
  __syncthreads();  // the coefficient tile and the staging area are free
  load_coef_tile(coef + (long long)n * rows * nk, trans, rows, nk, q0, nrows, cm, pitch);
  const PvStream<1, TX, TO> pv{{cm}, {x + (long long)n * nk * m},
                               {out + ((long long)n * rows + q0) * m}, nk, m, c0, mc};
  pv.prologue(stage);  // the coefficients land with the first chunk
  pv.run(pitch, nrows, stage);
}

template <class X0, class X1, class X2, class TO>
__device__ __forceinline__ void grads_body(const ProductsT<X0, X1, X2, TO>& pr, int t, int slice,
                                           int m, float* cm, float* stage, int pitch) {
  const int tiles = row_tiles(pr.rows);
  const int n = t / tiles, q0 = (t % tiles) * kRows, nrows = min(kRows, pr.rows - q0);
  const int c0 = slice * kSlice, mc = min(kSlice, m - c0);
  one_product(pr.coef[0], pr.trans[0], pr.x0, pr.out[0], n, pr.rows, pr.keys, q0, nrows, m, c0,
              mc, cm, stage, pitch);
  one_product(pr.coef[1], pr.trans[1], pr.x1, pr.out[1], n, pr.rows, pr.keys, q0, nrows, m, c0,
              mc, cm, stage, pitch);
  one_product(pr.coef[2], pr.trans[2], pr.x2, pr.out[2], n, pr.rows, pr.keys, q0, nrows, m, c0,
              mc, cm, stage, pitch);
}

template <int kMode>
using LanRows = ProductsT<typename Dtypes<kMode>::Vis, typename Dtypes<kMode>::Vis,
                          typename Dtypes<kMode>::Out, typename Dtypes<kMode>::Txt>;
template <int kMode>
using VisRows = ProductsT<typename Dtypes<kMode>::Txt, typename Dtypes<kMode>::Txt,
                          typename Dtypes<kMode>::Out, typename Dtypes<kMode>::Vis>;

// smem: one coefficient tile [kRows][pitch], the staging area.
template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cross_attn_grads_bwd_bf16_kernel(LanRows<kMode> g0, VisRows<kMode> g1, int tiles0, int slices,
                                 int m, int kcap) {
  extern __shared__ float4 smem4[];
  float* cm = reinterpret_cast<float*>(smem4);
  const int pitch = tile_pitch(kcap);
  float* stage = cm + kRows * pitch;
  const int tile = blockIdx.x / slices, slice = blockIdx.x % slices;
  if (tile < tiles0)
    grads_body(g0, tile, slice, m, cm, stage, pitch);
  else
    grads_body(g1, tile - tiles0, slice, m, cm, stage, pitch);
}

template <int kMode>
cudaError_t launch_bwd_mode(const void* g_vis, const void* g_lan, const void* qv, const void* kv,
                            const void* vv, const void* qt, const void* kt, const void* vt,
                            const float* pv, const float* pt, float* dlv, float* dlt, void* dqv,
                            void* dkv, void* dvv, void* dqt, void* dkt, void* dvt, int N, int HW,
                            int T, int m, float div, cudaStream_t stream,
                            tris::LaunchShape* shapes) {
  using D = Dtypes<kMode>;
  using V = typename D::Vis;
  using X = typename D::Txt;
  using O = typename D::Out;
  if (!tris::cross_attn_takes(m) || key_blocks(HW > T ? HW : T) > 1) return cudaErrorInvalidValue;
  const int slices = tris::cross_attn_slices(m);
  const int kcap = key_capacity(HW > T ? HW : T), pitch = tile_pitch(kcap);
  // pass A: the text half (HW keys) first
  const ProbsHalfT<O, V> lan{static_cast<const O*>(g_lan), static_cast<const V*>(vv), pt, dlt, T,
                             HW};
  const ProbsHalfT<O, X> vis{static_cast<const O*>(g_vis), static_cast<const X*>(vt), pv, dlv, HW,
                             T};
  const int tiles_lan = N * row_tiles(T), tiles_vis = N * row_tiles(HW);
  const size_t smem_a = sizeof(float) * ((size_t)kRows * pitch + stage_floats(kcap));
  const int blocks_a = slices * (tiles_lan + tiles_vis);
  cudaError_t err =
      kcap <= 128 ? launch_clusters(cross_attn_probs_bwd_bf16_kernel<4, kMode>, blocks_a, slices,
                                    smem_a, stream, &shapes[0], lan, vis, tiles_lan, m, kcap, div)
                  : launch_clusters(cross_attn_probs_bwd_bf16_kernel<8, kMode>, blocks_a, slices,
                                    smem_a, stream, &shapes[0], lan, vis, tiles_lan, m, kcap, div);
  if (err != cudaSuccess) return err;
  // pass B: rows T (summed over HW) first, then rows HW (summed over T)
  // dQt = dLt Kv, dKt = dLv^T Qv, dVt = Av^T G; dQv = dLv Kt, dKv = dLt^T Qt, dVv = At^T H
  const LanRows<kMode> lan_rows{{dlt, dlv, pv}, static_cast<const V*>(kv),
                                static_cast<const V*>(qv), static_cast<const O*>(g_vis),
                                {static_cast<X*>(dqt), static_cast<X*>(dkt), static_cast<X*>(dvt)},
                                {0, 1, 1}, T, HW};
  const VisRows<kMode> vis_rows{{dlv, dlt, pt}, static_cast<const X*>(kt),
                                static_cast<const X*>(qt), static_cast<const O*>(g_lan),
                                {static_cast<V*>(dqv), static_cast<V*>(dkv), static_cast<V*>(dvv)},
                                {0, 1, 1}, HW, T};
  const int tiles_t = N * row_tiles(T), tiles_p = N * row_tiles(HW);
  const size_t smem_b = sizeof(float) * ((size_t)kRows * pitch + kPvStages * kPvStage);
  const int blocks_b = slices * (tiles_t + tiles_p);
  auto* grads = &cross_attn_grads_bwd_bf16_kernel<kMode>;
  if ((err = tris::allow_smem(grads, smem_b)) != cudaSuccess) return err;
  grads<<<blocks_b, kThreads, smem_b, stream>>>(lan_rows, vis_rows, tiles_t, slices, m, kcap);
  if ((err = cudaGetLastError()) == cudaSuccess)
    shapes[1] = {blocks_b, 1, kThreads, kRows, (long long)smem_b};
  return err;
}

}  // namespace

cudaError_t tris::cross_attn_bwd_bf16(const void* g_vis, const void* g_lan, const void* qv,
                                      const void* kv, const void* vv, const Bf16Bits* qt,
                                      const Bf16Bits* kt, const Bf16Bits* vt, const float* pv,
                                      const float* pt, float* dlv, float* dlt, void* dqv,
                                      void* dkv, void* dvv, Bf16Bits* dqt, Bf16Bits* dkt,
                                      Bf16Bits* dvt, bool vis_bf16, int N, int HW, int T, int m,
                                      float div, cudaStream_t stream, LaunchShape* shapes) {
  if (vis_bf16)
    return launch_bwd_mode<kBf16>(g_vis, g_lan, qv, kv, vv, qt, kt, vt, pv, pt, dlv, dlt, dqv,
                                  dkv, dvv, dqt, dkt, dvt, N, HW, T, m, div, stream, shapes);
  return launch_bwd_mode<kMixed>(g_vis, g_lan, qv, kv, vv, qt, kt, vt, pv, pt, dlv, dlt, dqv,
                                 dkv, dvv, dqt, dkt, dvt, N, HW, T, m, div, stream, shapes);
}

cudaError_t tris::cross_attn_bwd(const float* g_vis, const float* g_lan, const float* qv,
                                 const float* kv, const float* vv, const float* qt,
                                 const float* kt, const float* vt, const float* pv,
                                 const float* pt, float* dlv, float* dlt, float* dqv, float* dkv,
                                 float* dvv, float* dqt, float* dkt, float* dvt, int N, int HW,
                                 int T, int m, float div, cudaStream_t stream,
                                 LaunchShape* shapes) {
  if (!cross_attn_takes(m)) return cudaErrorInvalidValue;
  const int slices = cross_attn_slices(m);
  const int kcap = key_capacity(HW > T ? HW : T), pitch = tile_pitch(kcap);

  // pass A: the text half (HW keys) first
  const ProbsHalf lan{g_lan, vv, pt, dlt, T, HW};
  const ProbsHalf vis{g_vis, vt, pv, dlv, HW, T};
  const int tiles_lan = N * row_tiles(T), tiles_vis = N * row_tiles(HW);
  const size_t smem_a = sizeof(float) * ((size_t)kRows * pitch + stage_floats(kcap));
  const int blocks_a = slices * (tiles_lan + tiles_vis);
  const bool many_keys = key_blocks(HW > T ? HW : T) > 1;
  cudaError_t err;
  if (many_keys)
    err = launch_clusters(cross_attn_probs_bwd_kernel<8, true>, blocks_a, slices, smem_a, stream,
                          &shapes[0], lan, vis, tiles_lan, m, kcap, div);
  else if (kcap <= 128)
    err = launch_clusters(cross_attn_probs_bwd_kernel<4, false>, blocks_a, slices, smem_a, stream,
                          &shapes[0], lan, vis, tiles_lan, m, kcap, div);
  else
    err = launch_clusters(cross_attn_probs_bwd_kernel<8, false>, blocks_a, slices, smem_a, stream,
                          &shapes[0], lan, vis, tiles_lan, m, kcap, div);
  if (err != cudaSuccess) return err;

  // pass B: rows T (summed over HW) first, then rows HW (summed over T)
  const Products lan_rows{{dlt, dlv, pv}, {kv, qv, g_vis}, {dqt, dkt, dvt}, {0, 1, 1}, T, HW};
  const Products vis_rows{{dlv, dlt, pt}, {kt, qt, g_lan}, {dqv, dkv, dvv}, {0, 1, 1}, HW, T};
  // dQt = dLt Kv, dKt = dLv^T Qv, dVt = Av^T G; dQv = dLv Kt, dKv = dLt^T Qt, dVv = At^T H
  const int tiles_t = N * row_tiles(T), tiles_p = N * row_tiles(HW);
  const size_t smem_b = sizeof(float) * ((size_t)3 * kRows * pitch + kPvStages * kPvStage);
  const int blocks_b = slices * (tiles_t + tiles_p);
  void (*grads)(Products, Products, int, int, int, int) =
      many_keys ? &cross_attn_grads_bwd_kernel<true> : &cross_attn_grads_bwd_kernel<false>;
  if ((err = tris::allow_smem(grads, smem_b)) != cudaSuccess) return err;
  grads<<<blocks_b, kThreads, smem_b, stream>>>(lan_rows, vis_rows, tiles_t, slices, m, kcap);
  if ((err = cudaGetLastError()) == cudaSuccess)
    shapes[1] = {blocks_b, 1, kThreads, kRows, (long long)smem_b};
  return err;
}
