// The host-side launchers of the kernels in this directory: one declaration
// each, included by the .cu file that defines it and by bindings.cpp that
// calls it, so the compiler holds both sides to the same signature. Each
// launches on `stream`, allocates nothing and returns cudaGetLastError().
// Pointers are to contiguous float32 data unless a stride says otherwise;
// bfloat16 data is passed as its bits (Bf16Bits), so that this header needs
// no CUDA type, and the .cu files read it as __nv_bfloat16.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tris {

using Bf16Bits = uint16_t;

// A resize's interpolation taps (ops/resize.py::interp_taps), one entry per
// output index o: out[o] = w0[o] * x[lo[o]] + w1[o] * x[hi[o]].
struct TapArrays {
  const int *lo, *hi;
  const float *w0, *w1;
};

// The same resize's adjoint as a gather, one entry per input index i: the
// output indices o with lo[o] == i are [lo_begin[i], lo_end[i]), those with
// hi[o] == i are [hi_begin[i], hi_end[i]) (the taps are monotone).
struct TapRanges {
  const int *lo_begin, *lo_end, *hi_begin, *hi_end;
};

// K1: a block per (sequence, head) holds the head's operands padded to
// lp = mha_short_len_bucket(max(Lq, Lk), backward) rows and hd_bucket = mha_short_hd_bucket(hd)
// channels, each staged row followed by kMhaShortPad floats, and P (backward: P, then dS in
// its place) in rows of mha_short_prob_pitch(lp) floats. Its mha_short_threads(lp) threads
// hold register tiles of mha_short_rows(lp) rows (or keys) each: kMhaShortRows below lp =
// kMhaShortLong, kMhaShortRowsLong from there; a row's keys and a row's channels are spread
// over kMhaShortLanes lanes of one warp. The forward holds q, k and v; the backward
// mha_short_bwd_buffers(lp, hd_bucket) operands at once.
constexpr int kMhaShortMaxLen = 128;
constexpr int kMhaShortMaxHeadDim = 128;
constexpr int kMhaShortRows = 2;
constexpr int kMhaShortRowsLong = 4;
constexpr int kMhaShortLong = 64;
constexpr int kMhaShortLanes = 8;
constexpr int kMhaShortPad = 4;
constexpr int kMhaShortProbPad = 8;
constexpr long long kMhaShortMaxSmem = 227 * 1024;  // bytes one block may use on Hopper
// the forward also has a 56-row bucket (the ViT's 50 tokens); the backward, whose
// products over keys take a thread's keys as float4s, goes from 32 to 64
constexpr int mha_short_len_bucket(int L, bool backward) {
  return L <= 16 ? 16 : L <= 32 ? 32 : L <= 56 && !backward ? 56 : L <= 64 ? 64 : 128;
}
constexpr int mha_short_hd_bucket(int hd) { return hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }
constexpr int mha_short_rows(int lp) {
  return lp >= kMhaShortLong ? kMhaShortRowsLong : kMhaShortRows;
}
constexpr int mha_short_threads(int lp) { return lp / mha_short_rows(lp) * kMhaShortLanes; }
// floats of one staged operand and of the P / dS tile
constexpr long long mha_short_operand(int lp, int hdb) {
  return (long long)lp * (hdb + kMhaShortPad);
}
// P's rows: the bucket rounded up to 32 floats plus kMhaShortProbPad, so consecutive rows
// start kMhaShortProbPad banks apart
constexpr int mha_short_prob_pitch(int lp) { return (lp + 31) / 32 * 32 + kMhaShortProbPad; }
constexpr long long mha_short_probs(int lp) {
  return (long long)lp * mha_short_prob_pitch(lp);
}
// operands the backward holds at once: q, dO and k (then v, then k again) where they
// fit beside P, else q and k (then dO and v, then q and k again)
constexpr int mha_short_bwd_buffers(int lp, int hdb) {
  return 4 * (3 * mha_short_operand(lp, hdb) + mha_short_probs(lp)) <= kMhaShortMaxSmem ? 3 : 2;
}
// bytes of dynamic shared memory a block takes: forward, P over q and k once the logits
// are formed, and v; backward, the operands it holds at once and P / dS
constexpr long long mha_short_smem(int lp, int hdb, bool backward) {
  const long long op = mha_short_operand(lp, hdb), pr = mha_short_probs(lp);
  if (!backward) return 4 * ((2 * op > pr ? 2 * op : pr) + op);
  return 4 * (mha_short_bwd_buffers(lp, hdb) * op + pr);
}
// the shapes the kernels take: 1 <= Lq, Lk <= kMhaShortMaxLen, 1 <= hd <= kMhaShortMaxHeadDim,
// and the block's shared memory within kMhaShortMaxSmem
constexpr bool mha_short_takes(int Lq, int Lk, int hd, bool backward) {
  return Lq >= 1 && Lk >= 1 && hd >= 1 && Lq <= kMhaShortMaxLen && Lk <= kMhaShortMaxLen &&
         hd <= kMhaShortMaxHeadDim &&
         mha_short_smem(mha_short_len_bucket(Lq > Lk ? Lq : Lk, backward),
                        mha_short_hd_bucket(hd), backward) <= kMhaShortMaxSmem;
}
// A launch of K1 as its launcher made it: blocks, threads a block, the length and head-dim
// buckets, the bytes of each global load (16, or 4 where a pointer, a stride or hd is not
// a multiple of 16 bytes) and bytes of dynamic shared memory a block.
struct MhaLaunchShape {
  int blocks, threads, lp, hd_bucket, load_bytes;
  long long smem;
};

// K1: q/k/v element (n, l, c) at base + n*x_seq + l*x_row + c; out [N, Lq, n_head*hd];
// mask [Lq, Lk] or null. *shape receives the launch's shape.
cudaError_t mha_short(const float* q, const float* k, const float* v, const float* mask,
                      float* out, int N, int Lq, int Lk, int hd, int n_head, int64_t q_seq,
                      int64_t q_row, int64_t k_seq, int64_t k_row, int64_t v_seq,
                      int64_t v_row, float scale, cudaStream_t stream, MhaLaunchShape* shape);

// K1 forward on bfloat16 q, k and v (--bf16, the text tower on bfloat16 leaves), the same
// tiles: q * scale and the logits rounded to bfloat16 (scale bfloat16's hd^-1/2), then the
// float32 mask (required) added, the softmax and P V in float32; out [N, Lq, C] float32.
// 16-byte loads where hd % 8 == 0 and the pointers and strides allow, else 2-byte ones.
cudaError_t mha_short_bf16(const Bf16Bits* q, const Bf16Bits* k, const Bf16Bits* v,
                           const float* mask, float* out, int N, int Lq, int Lk, int hd,
                           int n_head, int64_t q_seq, int64_t q_row, int64_t k_seq, int64_t k_row,
                           int64_t v_seq, int64_t v_row, float scale, cudaStream_t stream,
                           MhaLaunchShape* shape);

// K1 backward: dout [N, Lq, C]; q/k/v as the forward; dq [N, Lq, C], dk and dv [N, Lk, C].
cudaError_t mha_short_bwd(const float* dout, const float* q, const float* k, const float* v,
                          const float* mask, float* dq, float* dk, float* dv, int N, int Lq,
                          int Lk, int hd, int n_head, int64_t q_seq, int64_t q_row,
                          int64_t k_seq, int64_t k_row, int64_t v_seq, int64_t v_row,
                          float scale, cudaStream_t stream, MhaLaunchShape* shape);

// K1 backward on bfloat16 q, k and v with the float32 mask (required) and dout (--bf16): the
// same tiles and limits as mha_short_bwd; dq, dk and dv bfloat16 [N, L, C], each rounded
// where the JAX function's VJP rounds (see mha_short_bwd.cu). scale: bfloat16's hd^-1/2.
cudaError_t mha_short_bwd_bf16(const float* dout, const Bf16Bits* q, const Bf16Bits* k,
                               const Bf16Bits* v, const float* mask, Bf16Bits* dq, Bf16Bits* dk,
                               Bf16Bits* dv, int N, int Lq, int Lk, int hd, int n_head,
                               int64_t q_seq, int64_t q_row, int64_t k_seq, int64_t k_row,
                               int64_t v_seq, int64_t v_row, float scale, cudaStream_t stream,
                               MhaLaunchShape* shape);

// K2: qv/kv/vv [P/S, HW, m]; qt/kt/vt [P, T, m]; new_vis [P, HW, m]; new_lan [P, T, m].
// Its kernels (cross_attn.cu, cross_attn_bwd.cu, cross_attn_tiles.cuh) take tiles of
// kCrossAttnRows query rows against their keys (T for the vision queries, HW for the text
// ones) in blocks of at most kCrossAttnKeyBlock, which a tile holds in shared memory; a
// tile's m channels are split into slices of kCrossAttnSlice over a cluster of
// cross_attn_slices(m) blocks, each slice's logits summed in chunks of kCrossAttnChunk
// channels and its P.V in chunks of kCrossAttnKeyChunk keys. HW and T have no limit;
// m must pass cross_attn_takes.
constexpr int kCrossAttnRows = 32;
constexpr int kCrossAttnKeyBlock = 256;
constexpr int kCrossAttnSlice = 256;
constexpr int kCrossAttnMaxSlices = 8;
constexpr int kCrossAttnChunk = 32;
constexpr int kCrossAttnKeyChunk = 16;
inline int cross_attn_slices(int m) { return (m + kCrossAttnSlice - 1) / kCrossAttnSlice; }
// the widths the kernels take: 16-byte copies, at most a cluster of kCrossAttnMaxSlices
inline bool cross_attn_takes(int m) {
  return m > 0 && m % 4 == 0 && cross_attn_slices(m) <= kCrossAttnMaxSlices;
}
// A launch as its launcher made it: blocks, blocks a cluster, threads a block, query rows
// a tile and bytes of dynamic shared memory a block.
struct LaunchShape {
  int blocks, cluster, threads, rows;
  long long smem;
};
// With pv and pt (both or neither), the forward also writes the probabilities for the
// backward: pv [P, HW, T] and pt [P/S, S*T, HW]. *shape receives the launch's shape.
cudaError_t cross_attn(const float* qv, const float* kv, const float* vv, const float* qt,
                       const float* kt, const float* vt, float* new_vis, float* new_lan, float* pv,
                       float* pt, int P, int HW, int T, int m, int S, float div,
                       cudaStream_t stream, LaunchShape* shape);

// K2 forward on bfloat16 text projections qt/kt/vt (--bf16), the same tiles: with vis_bf16
// the vision projections and both outputs bfloat16 too, the logits, their quotient by div
// and the softmax's ops rounded to bfloat16 (HW and T at most kCrossAttnKeyBlock, one key
// block); else the vision projections and the outputs float32 and every product float32.
// With pv and pt (both or neither), the probabilities for the backward as cross_attn's
// (float32; on bfloat16 leaves each a bfloat16 value).
cudaError_t cross_attn_bf16(const void* qv, const void* kv, const void* vv, const Bf16Bits* qt,
                            const Bf16Bits* kt, const Bf16Bits* vt, void* new_vis, void* new_lan,
                            float* pv, float* pt, bool vis_bf16, int P, int HW, int T, int m,
                            int S, float div, cudaStream_t stream, LaunchShape* shape);

// K2 backward on cross_attn_bf16's operands (--bf16), one sentence per image and one key block
// (HW and T at most kCrossAttnKeyBlock): with vis_bf16 every operand, cotangent and gradient
// bfloat16; else the vision projections, both cotangents and the vision gradients float32 and
// the text ones bfloat16. pv, pt, dlv and dlt as cross_attn_bwd's (float32).
cudaError_t cross_attn_bwd_bf16(const void* g_vis, const void* g_lan, const void* qv,
                                const void* kv, const void* vv, const Bf16Bits* qt,
                                const Bf16Bits* kt, const Bf16Bits* vt, const float* pv,
                                const float* pt, float* dlv, float* dlt, void* dqv, void* dkv,
                                void* dvv, Bf16Bits* dqt, Bf16Bits* dkt, Bf16Bits* dvt,
                                bool vis_bf16, int N, int HW, int T, int m, float div,
                                cudaStream_t stream, LaunchShape* shapes);

// K2 backward, one sentence per image: g_vis, qv/kv/vv and their gradients [N, HW, m];
// g_lan, qt/kt/vt and their gradients [N, T, m]; pv [N, HW, T] and pt [N, T, HW] as the
// forward wrote them; scratch dlv [N, HW, T] and dlt [N, T, HW]. The same tiles and
// limits as the forward; shapes[0] and shapes[1] receive its two launches' shapes.
cudaError_t cross_attn_bwd(const float* g_vis, const float* g_lan, const float* qv,
                           const float* kv, const float* vv, const float* qt, const float* kt,
                           const float* vt, const float* pv, const float* pt, float* dlv,
                           float* dlt, float* dqv, float* dkv, float* dvv, float* dqt, float* dkt,
                           float* dvt, int N, int HW, int T, int m, float div,
                           cudaStream_t stream, LaunchShape* shapes);

// K3, training head (stage1_head.cu): one launch each way, a cluster of R blocks an image, grid
// (R, B), every image scored against T >= B texts (T = B on one process; across the ranks of a
// process group, this rank's B images against the T texts of the global batch), image b's own
// text at b + offset.
// Forward: rank r forms the scores of the image's pixels [r hw / R, (r + 1) hw / R) against all T
// texts, a tile of kStage1HeadTilePixels pixels by kStage1HeadTileTexts texts at a time (a pass; a
// share or T past one tile takes more passes over D, each reading the texts' rows again). A pass
// stages the tile's pixel and text rows kStage1HeadChunk channels at a time through `stages`
// buffers (cp.async, stages - 1 in flight; kStage1HeadStages, fewer where the block would pass
// kStage1HeadMaxSmem bytes, at least 2), each row followed by kStage1HeadPad floats. The channels
// are split over the block's kStage1HeadKSplit warps by groups of 4: warp j takes the groups g = j
// mod kStage1HeadKSplit, its lanes 4 rows of pixels by 8 of texts, a lane kStage1HeadTilePixels /
// 4 pixels by kStage1HeadTileTexts / 8 texts (strided by 4 and 8), each an fmaf chain over the
// warp's channels in order; the warps' sums are then added in warp order, so R does not enter a
// score's rounding. Each rank forms its pixels' softmax statistics; the ranks copy each other's
// rows and statistics through distributed shared memory; each then writes cls_out on its share of
// the texts [r T / R, (r + 1) T / R) and both maps on its band of output rows [r H / R, (r + 1) H
// / R) from t-rows, `vec` columns a thread (16-byte stores where W % 4 == 0). The statistics the
// backward needs go to device memory beside the scores: per pixel the softmax max and sum, per
// text mbar and the first argmax.
// Backward: rank r stages the plane as the forward wrote it and forms d seg on its band from g_sig
// (and g_relu): a thread `vec` columns and a row group's rows (the band cut into
// stage1_head_map_groups(W) sub-bands), streamed in order kStage1HeadMapLoads rows at a time and
// summed onto the h rows as they go (the row adjoint, an fmaf chain a tap); the row groups' sums
// (rows of stage1_head_map_pitch(W) floats) are added in order and each h row reduced onto the w
// columns (the column adjoint's ranges); the ranks' [h, w] partials are summed in rank order
// through distributed shared memory. dscore [hw, T] is formed in shared memory from the forward's
// statistics and never reaches device memory; rank r then writes d vis_p and d lan_p on its
// channel groups [r G / R, (r + 1) G / R) of G = D / 4 groups of 4 channels, a thread a tile of
// kStage1HeadGradRows pixels (or texts) by kStage1HeadGradGroups groups, each gradient a chain
// over the T texts (or the hw pixels) in order, the operand's rows staged kStage1HeadGradChunk at
// a time through kStage1HeadGradStages buffers (cp.async).
// R: doubled from 1, up to the portable cluster of kStage1HeadMaxRanks, while the doubled grid B *
// 2R stays within kStage1HeadWaveBlocks (backward: kStage1HeadBwdWaveBlocks) and a rank keeps at
// least kStage1HeadMinRows output rows. At B = 48 the forward takes 2, a block an SM: a rank's
// share of the pixels fits one tile, so the texts' rows are read once a rank. The backward takes
// 4, two blocks an SM: its shared loads and FMAs overlap only with the warps of two blocks (R = 2
// with 255 registers a thread and 8 x 16 tiles took 1.8x as long); clusters of 5 and of 8 did not
// all fit the card at once, and their grids took two waves.
constexpr int kStage1HeadThreads = 256;
constexpr int kStage1HeadMaxRanks = 8;
constexpr int kStage1HeadWaveBlocks = 132;     // a block an SM of 132
constexpr int kStage1HeadBwdWaveBlocks = 264;  // two
constexpr int kStage1HeadMinRows = 8;
constexpr int kStage1HeadKSplit = 8;        // the block's warps
constexpr int kStage1HeadTilePixels = 56;   // 4 rows of lanes x 14
constexpr int kStage1HeadTileTexts = 48;    // 8 columns of lanes x 6
constexpr int kStage1HeadChunk = 128;
constexpr int kStage1HeadStages = 3;
constexpr int kStage1HeadMaxSmem = 232448;  // 227 KiB, a block's most on Hopper
constexpr int kStage1HeadPad = 4;
constexpr int kStage1HeadMapGroups = 3;
constexpr int kStage1HeadMapLoads = 4;
constexpr int kStage1HeadGradRows = 8;
constexpr int kStage1HeadGradGroups = 2;
constexpr int kStage1HeadGradChunk = 8;
constexpr int kStage1HeadGradStages = 3;

constexpr long long stage1_head_round(long long n, int m) { return (n + m - 1) / m * m; }
constexpr int stage1_head_map_pitch(int W) { return W | 1; }
// the backward's row groups: as many as a block holds of W's column groups (of 4 where W % 4 ==
// 0), at most kStage1HeadMapGroups
constexpr int stage1_head_map_groups(int W) {
  const int groups = W % 4 == 0 ? W / 4 : W;
  const int tg = groups < kStage1HeadThreads ? groups : kStage1HeadThreads;
  return kStage1HeadThreads / tg < kStage1HeadMapGroups ? kStage1HeadThreads / tg
                                                        : kStage1HeadMapGroups;
}

// floats of an image's statistics: the softmax max and sum a pixel, mbar and the first argmax
// (as a float) a text
constexpr long long stage1_head_stats(long long hw, long long T) { return 2 * (hw + T); }

struct Stage1HeadPlan {
  int ranks;      // blocks an image, one cluster
  int threads;    // threads a block
  int pixels;     // pixels a rank's share holds at most, ceil(hw / R)
  int band_rows;  // output rows a rank's band holds at most, ceil(H / R)
  int vec;        // map columns a thread takes: 4 (W % 4 == 0) or 1
  int passes;     // forward: tiles of the rank's scores, a pass over D each
  int stages;     // forward: the operands' buffers
  int groups;     // backward: channel groups a rank's slice holds at most, ceil(D / 4 / R)
  long long blocks;
  long long smem;  // bytes of dynamic shared memory a block
};

// K3's rule, by the shape: B images, T texts, [h, w] score planes of D channels, maps [H, W].
// The forward's block holds the plane [hw, T], then `stages` stages of kStage1HeadTilePixels +
// kStage1HeadTileTexts rows of kStage1HeadChunk + kStage1HeadPad floats, or the warps' sums of a
// tile [kStage1HeadKSplit, kStage1HeadTilePixels, kStage1HeadTileTexts], later the statistics
// [2, hw] and the band's t-rows; the backward's the plane (rows padded to 8 floats), six [hw]
// vectors, three [T], the band's t-rows [band_rows, w], and either the row groups' d seg on the h
// rows [stage1_head_map_groups(W), h, stage1_head_map_pitch(W)] or dscore transposed ([T, hw],
// rows padded to 8 floats; dscore itself takes the plane's place) with the gradients' operand
// stages [kStage1HeadGradStages, kStage1HeadGradChunk, 4 groups]. Each vector starts on 16 bytes.
constexpr Stage1HeadPlan stage1_head_plan(long long B, long long T, int h, int w, int D, int H,
                                          int W, bool backward) {
  const long long hw = (long long)h * w;
  const int wave = backward ? kStage1HeadBwdWaveBlocks : kStage1HeadWaveBlocks;
  int R = 1;
  while (R < kStage1HeadMaxRanks && B * 2 * R <= wave && 2 * R * kStage1HeadMinRows <= H) R *= 2;
  const int pixels = (int)((hw + R - 1) / R), band = (H + R - 1) / R;
  const int groups = (D / 4 + R - 1) / R;
  const long long passes = ((pixels + kStage1HeadTilePixels - 1) / kStage1HeadTilePixels) *
                           ((T + kStage1HeadTileTexts - 1) / kStage1HeadTileTexts);
  const long long vec_hw = stage1_head_round(hw, 4);
  const long long trows = stage1_head_round((long long)band * w, 4);
  long long floats = 0;
  int stages = 0;
  if (!backward) {
    const long long stage = (long long)(kStage1HeadTilePixels + kStage1HeadTileTexts) *
                            (kStage1HeadChunk + kStage1HeadPad);
    const long long sums = (long long)kStage1HeadKSplit * kStage1HeadTilePixels *
                           kStage1HeadTileTexts;
    long long after = 2 * vec_hw + trows;
    after = sums > after ? sums : after;
    for (stages = kStage1HeadStages;; --stages) {
      floats = stage1_head_round(hw * T, 4) + (stages * stage > after ? stages * stage : after);
      if (stages == 2 || 4 * floats <= kStage1HeadMaxSmem) break;
    }
  } else {
    const long long seg = (long long)stage1_head_map_groups(W) * h * stage1_head_map_pitch(W);
    const long long grads =
        T * stage1_head_round(hw, 8) + 4LL * kStage1HeadGradStages * kStage1HeadGradChunk * groups;
    floats = hw * stage1_head_round(T, 8) + 6 * vec_hw + 3 * stage1_head_round(T, 4) + trows +
             (seg > grads ? seg : grads);
  }
  return {R,
          kStage1HeadThreads,
          pixels,
          band,
          W % 4 == 0 ? 4 : 1,
          backward ? 0 : (int)passes,
          stages,
          backward ? groups : 0,
          B * R,
          4 * floats};
}

// A launch of K3's training head as its launcher made it: blocks, blocks a cluster, threads a
// block, map columns a thread and bytes of dynamic shared memory a block.
struct Stage1HeadLaunchShape {
  long long blocks;
  int cluster, threads, vec;
  long long smem;
};

// K3, training head: vis_p [B, h*w, D]; lan_p [B, T, D] (D % 4 == 0, both 16-byte aligned;
// 0 <= offset, B + offset <= T: image b's own text is b + offset); scale a device scalar; taps
// h -> H rows and w -> W columns. Writes score [B, h*w, T] and stats [B, stage1_head_stats(h*w,
// T)] (for the backward), cls_out [B, T], cls_fg [B] (mbar of the own text), relu_map and
// sig_map [B, H, W] (of the own text's plane). *shape receives the launch's shape.
cudaError_t stage1_head(const float* vis_p, const float* lan_p, const float* scale,
                        float* score, float* stats, float* cls_out, float* cls_fg,
                        float* relu_map, float* sig_map, int B, int T, int offset, int h, int w,
                        int D, int H, int W, float focal_p, float focal_c, TapArrays ty,
                        TapArrays tx, cudaStream_t stream, Stage1HeadLaunchShape* shape);

// K3 backward: g_cls [B, T]; g_relu and g_sig [B, H, W] or null (both null: no map gradient;
// 16-byte aligned); score and stats as the forward wrote them; taps and their adjoint ranges;
// d_vis [B, h*w, D], d_lan [B, T, D]. *shape receives the launch's shape.
cudaError_t stage1_head_bwd(const float* g_cls, const float* g_relu, const float* g_sig,
                            const float* vis_p, const float* lan_p, const float* scale,
                            const float* score, const float* stats, float* d_vis, float* d_lan,
                            int B, int T, int offset, int h, int w, int D, int H, int W, float focal_p,
                            float focal_c, TapArrays ty, TapArrays tx, TapRanges ry,
                            TapRanges rx, cudaStream_t stream, Stage1HeadLaunchShape* shape);

// K3's training head on bfloat16 operands (stage1_head_bf16.cu, --bf16): lan_p [B, T, D]
// bfloat16, vis_p [B, h*w, D] bfloat16 (vis_bf16) or float32, scale float32; a block of
// kS1Bf16Threads an image each way, the operands widened kS1Bf16Chunk (forward) or
// kS1Bf16GradChunk (backward) channels at a time into shared memory. Writes score [B, h*w, T]
// and stats [B, stage1_head_bf16_stats(h*w, T)] (per pixel the softmax's max and sum, per text
// mbar, GMP and its count of tied pixels) for the backward, cls_out [B, T], cls_fg [B] and
// the maps [B, H, W], float32. The backward takes stage1_head_bwd's arguments and writes
// d_vis in vis_p's dtype and d_lan bfloat16. A launch needs stage1_head_bf16_smem bytes of
// shared memory, at most kS1Bf16MaxSmem.
constexpr int kS1Bf16Threads = 512;
constexpr int kS1Bf16Chunk = 32;
constexpr int kS1Bf16GradChunk = 64;
constexpr long long kS1Bf16MaxSmem = 227 * 1024;
constexpr long long stage1_head_bf16_stats(long long hw, long long T) { return 2 * hw + 3 * T; }
constexpr long long stage1_head_bf16_smem(long long hw, long long T, long long H, long long w,
                                          bool backward) {
  const long long plane = (hw * T + 3) / 4 * 4, hw4 = (hw + 3) / 4 * 4, t4 = (T + 3) / 4 * 4;
  return 4 * (backward ? plane + 2 * hw + H * w + T + (hw > T ? hw : T) * kS1Bf16GradChunk
                       : plane + kS1Bf16Chunk * (hw4 + t4) + 3 * hw);
}
cudaError_t stage1_head_bf16(const void* vis_p, bool vis_bf16, const Bf16Bits* lan_p,
                             const float* scale, float* score, float* stats, float* cls_out,
                             float* cls_fg, float* relu_map, float* sig_map, int B, int T,
                             int offset, int h, int w, int D, int H, int W, float focal_p,
                             float focal_c, TapArrays ty, TapArrays tx, cudaStream_t stream);
cudaError_t stage1_head_bwd_bf16(const float* g_cls, const float* g_relu, const float* g_sig,
                                 const void* vis_p, bool vis_bf16, const Bf16Bits* lan_p,
                                 const float* scale, const float* score, const float* stats,
                                 void* d_vis, Bf16Bits* d_lan, int B, int T, int offset, int h,
                                 int w, int D, int H, int W, float focal_p, float focal_c,
                                 TapArrays ty, TapArrays tx, TapRanges ry, TapRanges rx,
                                 cudaStream_t stream);

// K3, the eval head (response_head.cu): a cluster of R blocks a pair, grid (R, P). Rank r
// forms the scores of the pair's pixels [r hw / R, (r + 1) hw / R) (a warp a pixel), the
// ranks read each other's through distributed shared memory, and rank r writes the output
// rows [r H / R, (r + 1) H / R), each row's interpolated score row (w floats) formed once in
// shared memory, `vec` columns a thread (4 where W % 4 == 0: 16-byte stores), their x taps
// in registers. R: doubled from 1, up to the portable cluster of kResponseHeadMaxRanks,
// while the doubled grid P * 2R stays within one wave of kResponseHeadWaveBlocks and a rank
// keeps at least kResponseHeadMinRows rows (two blocks an SM formed their scores more slowly
// than one).
constexpr int kResponseHeadThreads = 512;
constexpr int kResponseHeadMaxRanks = 8;
constexpr int kResponseHeadWaveBlocks = 132;  // a block an SM
constexpr int kResponseHeadMinRows = 8;

struct ResponseHeadPlan {
  int ranks;        // blocks a pair, one cluster
  int threads;      // threads a block
  int pixels;       // score pixels a rank forms at most, ceil(hw / R)
  int band_rows;    // output rows a rank writes at most, ceil(H / R)
  int vec;          // columns a thread writes: 4 (W % 4 == 0) or 1
  long long blocks;
  long long smem;   // bytes of dynamic shared memory a block: the score plane and the t-rows
};

// K3's rule, by the shape: P pairs of S sentences an image, [h, w] score planes of D
// channels, maps [H, W] (S and D do not enter it: every pair is a cluster of its own, whatever
// its image, and a warp takes a pixel's D channels whatever D).
constexpr ResponseHeadPlan response_head_plan(long long P, int S, int h, int w, int D, int H,
                                              int W) {
  const int hw = h * w;
  int R = 1;
  while (R < kResponseHeadMaxRanks && P * 2 * R <= kResponseHeadWaveBlocks &&
         2 * R * kResponseHeadMinRows <= H)
    R *= 2;
  const int band = (H + R - 1) / R;
  return {R,
          kResponseHeadThreads,
          (hw + R - 1) / R,
          band,
          W % 4 == 0 ? 4 : 1,
          P * R,
          4 * ((hw + 3LL) / 4 * 4 + (long long)band * w)};
}

// A launch of K3's eval head as its launcher made it: blocks, blocks a cluster, threads a
// block, columns a thread and bytes of dynamic shared memory a block.
struct ResponseHeadLaunchShape {
  long long blocks;
  int cluster, threads, vec;
  long long smem;
};

// K3: vis_new [P, h*w, D] or null; vis_base [P/S, h*w, D]; lan [P, D]; out [P, H, W];
// scale a device scalar; y taps [H], x taps [W]. *shape receives the launch's shape.
cudaError_t response_head(const float* vis_new, const float* vis_base, const float* lan,
                          float* out, int P, int S, int h, int w, int D, int H, int W,
                          float alpha, const float* scale, const int* ylo, const int* yhi,
                          const float* wy0, const float* wy1, const int* xlo, const int* xhi,
                          const float* wx0, const float* wx1, cudaStream_t stream,
                          ResponseHeadLaunchShape* shape);

// K3's eval head on bfloat16 operands (--bf16), the same grid: vis_base and lan bfloat16 and
// vis_new either float32 (new_f32: the fusion on float32 leaves; the residual and the dot in
// float32, as their promoted dtype is) or bfloat16 or null (the residual's product and sum
// and the dot rounded to bfloat16, then times the float32 scale); out float32. D even: a
// lane reads 2 channels a load (4-byte bfloat162 loads, 8-byte float2 ones of vis_new).
cudaError_t response_head_bf16(const void* vis_new, bool new_f32, const Bf16Bits* vis_base,
                               const Bf16Bits* lan, float* out, int P, int S, int h, int w, int D,
                               int H, int W, float alpha, const float* scale, const int* ylo,
                               const int* yhi, const float* wy0, const float* wy1,
                               const int* xlo, const int* xhi, const float* wx0,
                               const float* wx1, cudaStream_t stream,
                               ResponseHeadLaunchShape* shape);

// K4: a cluster of R blocks a map (eval_metrics.cu). Rank r of map (b, s) owns the valid
// output rows [r oh / R, (r + 1) oh / R) of image b's original (oh, ow) and holds in shared
// memory its rows' y taps and interpolated rows t = wy0 x[y0] + wy1 x[y1], each w floats
// (staged: where they fit kEvalSmemTarget, else every sample reads the map from device memory).
// A block's kEvalThreads threads each own an output column, its x taps in registers, and rows
// of the band. The ranks trade their maxes, then their counts and argmax, through distributed
// shared memory. R: doubled from 1 while the grid B * S * R is below kEvalWaveBlocks and a rank
// keeps at least kEvalMinRows of maxH, then while the band does not fit kEvalSmemTarget (two
// blocks an SM), up to kEvalMaxRanks (portable) or, where the card runs such clusters
// (cudaOccupancyMaxActiveClusters), kEvalWideRanks.
constexpr int kEvalThreads = 640;  // a column a thread at the widest COCO original
constexpr int kEvalMaxRanks = 8;
constexpr int kEvalWideRanks = 16;
constexpr int kEvalMinRows = 8;
constexpr int kEvalWaveBlocks = 256;
constexpr int kEvalSmemTarget = 114688;  // 112 KiB of dynamic shared memory: two blocks an SM

// rows a rank's band holds at most, and a staged block's bytes: the band's t-rows and its
// rows' y taps
constexpr int eval_metrics_band_rows(int maxH, int R) { return (maxH + R - 1) / R; }
constexpr long long eval_metrics_smem(int maxH, int w, int R) {
  return 4LL * eval_metrics_band_rows(maxH, R) * (w + 4);
}

struct EvalMetricsPlan {
  int ranks;       // blocks a map, one cluster
  int threads;     // threads a block
  int band_rows;   // output rows a rank holds at most
  int staged;      // 1: the band's t-rows in shared memory
  long long smem;  // bytes of dynamic shared memory a block (0 unstaged)
  long long blocks;
  int max_ranks;   // the largest cluster the plan could take
};

// K4's rule, by the shape: B images of S maps [h, w] to originals within [maxH, maxW] (h
// and maxW do not enter it: a band's t-rows are w floats whatever the map's height, and a
// block's threads take the columns in turn).
constexpr EvalMetricsPlan eval_metrics_plan(int B, int S, int maxH, int maxW, int h, int w,
                                            int max_ranks) {
  int R = 1;
  while (R < max_ranks && (long long)B * S * R < kEvalWaveBlocks && 2 * R * kEvalMinRows <= maxH)
    R *= 2;
  while (R < max_ranks && eval_metrics_smem(maxH, w, R) > kEvalSmemTarget) R *= 2;
  const long long smem = eval_metrics_smem(maxH, w, R);
  const bool staged = smem <= kEvalSmemTarget;
  return {R, kEvalThreads, eval_metrics_band_rows(maxH, R), staged ? 1 : 0, staged ? smem : 0,
          (long long)B * S * R, max_ranks};
}

// The rule on this card: eval_metrics_plan with max_ranks kEvalWideRanks where the card runs
// a cluster of that many of the plan's blocks, else kEvalMaxRanks.
EvalMetricsPlan eval_metrics_device_plan(int B, int S, int maxH, int maxW, int h, int w);

// A launch of K4 as its launcher made it: blocks, blocks a cluster, threads a block, bytes of
// dynamic shared memory a block, whether the band was staged, and the bytes of each load of
// the map (16 or 4).
struct EvalMetricsLaunchShape {
  long long blocks;
  int cluster, threads;
  long long smem;
  int staged, map_load_bytes;
};

// K4: cams [B, S, h, w]; y taps [B, maxH], x taps [B, maxW]; orig_hw [B, 2];
// either norm_out [B, S, maxH, maxW] (targets, boxes and stats null) or
// stats [B, S, 4] from targets [B, maxH, maxW] and boxes [B, 4] (norm_out null).
// *shape receives the launch's shape.
cudaError_t eval_metrics(const float* cams, int B, int S, int h, int w, int maxH, int maxW,
                         const int* ylo, const int* yhi, const float* wy0, const float* wy1,
                         const int* xlo, const int* xhi, const float* wx0, const float* wx1,
                         const int* orig_hw, const unsigned char* targets, const float* boxes,
                         float* norm_out, float* stats, cudaStream_t stream,
                         EvalMetricsLaunchShape* shape);

// K5: cams [P, H, W]; image [P/S, 3, H, W]; y taps [n], x taps [n];
// out [P * (n/ps)^2, 3 * ps * ps], columns (c, py, px).
cudaError_t critic_input(const float* cams, const float* image, float* out, int P, int S, int H,
                         int W, int n, int ps, const int* ylo, const int* yhi, const float* wy0,
                         const float* wy1, const int* xlo, const int* xhi, const float* wx0,
                         const float* wx1, cudaStream_t stream);

// K6: image uint8 [B, H, W, 3] (n_pix = B*H*W pixels, hw = H*W); out [B, 3, H, W];
// scale and bias point to 3 floats each in host memory.
cudaError_t normalize_u8(const unsigned char* image, float* out, int64_t n_pix, int64_t hw,
                         const float* scale, const float* bias, cudaStream_t stream);

// K6, bilinear half (bilinear_resize.cu): the planes' output rows flattened, planes * oh rows
// of ow columns. A block takes a band of consecutive rows and a tile of columns; its threads
// are `rows` rows of `tile_groups` threads, each owning `vec` consecutive columns (4 where
// ow % 4 == 0 and w <= ow: one 16-byte store), whose x taps it holds in registers for the
// whole band. With one tile, the block first copies the input rows its band spans (contiguous in x: at
// most in_floats floats) into shared memory, all copies in flight at once (cp.async). The band
// is then taken rows * rpt rows at a time (a chunk, a thread taking rpt of them): each row's
// interpolated row t = wy0 x[y0] + wy1 x[y1] over the input columns its tile spans (at most
// `pitch`) goes to shared memory (two buffers, one barrier a chunk), then the columns sample
// it. A band is `chunks` chunks, so that the grid stays near kResizeWaveBlocks blocks; a
// resize of fewer than kResizeMinBands chunks takes fewer rows a thread, then fewer rows of
// threads. Where the band's input does not fit beside the t-rows in kResizeSmem, the t-rows
// read device memory (in_floats 0). Where a t-row would hold more values than its outputs (w
// > ow) or the t-rows do not fit, every output samples device memory (staged 0).
constexpr int kResizeThreads = 256;
constexpr int kResizeTileGroups = 256;
constexpr int kResizeRowsPerThread = 4;
constexpr int kResizeWaveBlocks = 528;   // 4 blocks an SM of 132
constexpr int kResizeMinBands = 132;     // a block an SM
constexpr int kResizeMaxChunks = 4;
constexpr int kResizeSmem = 49152;       // 48 KiB: no opt-in

struct ResizePlan {
  int vec;          // columns a thread: 4 (16-byte stores) or 1 (ow % 4 != 0, or w > ow)
  int groups;       // column groups a row, ceil(ow / vec)
  int tile_groups;  // threads a row of a tile
  int tiles;        // column tiles
  int rows;         // rows of threads
  int rpt;          // rows a thread takes of each chunk
  int threads;      // rows * tile_groups
  int pitch;        // floats of a t-row: the input columns a tile spans at most
  int staged;       // 1: t-rows in shared memory
  int chunks;       // chunks a band
  int band_rows;    // rows * rpt * chunks
  long long bands;  // ceil(planes * oh / band_rows)
  long long blocks; // bands * tiles
  long long in_floats;  // the band's input rows in shared memory (a multiple of 4; 0: none)
  long long smem;   // bytes of dynamic shared memory a block
};

// Input rows (of the planes' flattened [planes * h] rows) that `d` + 1 consecutive output rows
// span at most: d steps of at most max(h / oh, (h - 1) / (oh - 1)) rows, one row more at each
// of the at most d / oh + 1 planes' edges crossed, and 3 for the taps' floors and the last
// row's upper tap.
constexpr long long bilinear_resize_span_rows(long long d, int h, int oh) {
  const long long s1 = (d * h + oh - 1) / oh;
  const long long s2 = oh > 1 ? (d * (h - 1) + oh - 2) / (oh - 1) : 0;
  return (s1 > s2 ? s1 : s2) + d / oh + 1 + 3;
}

// K6's rule, by the shape.
constexpr ResizePlan bilinear_resize_plan(long long planes, int h, int w, int oh, int ow) {
  ResizePlan p = {};
  p.vec = ow % 4 == 0 && w <= ow ? 4 : 1;
  p.groups = (ow + p.vec - 1) / p.vec;
  p.tile_groups = p.groups < kResizeTileGroups ? p.groups : kResizeTileGroups;
  p.tiles = (p.groups + p.tile_groups - 1) / p.tile_groups;
  const long long total = planes * oh;
  p.rows = kResizeThreads / p.tile_groups;
  p.rpt = kResizeRowsPerThread;
  while (p.rpt > 1 && (total + p.rows * p.rpt - 1) / (p.rows * p.rpt) < kResizeMinBands)
    p.rpt /= 2;
  if ((total + p.rows - 1) / p.rows < kResizeMinBands)
    p.rows = total / kResizeMinBands < 1 ? 1 : (int)(total / kResizeMinBands);
  p.threads = p.rows * p.tile_groups;
  // a tile of n columns spans at most (n - 1) w / (ow - 1) + 3 input columns (either
  // align_corners)
  const long long n = (long long)p.tile_groups * p.vec;
  const long long span = p.tiles == 1 ? w : (n - 1) * w / (ow > 1 ? ow - 1 : 1) + 3;
  p.pitch = (int)(span < w ? span : w);
  const long long t_smem = 2LL * p.rows * p.rpt * p.pitch * 4;
  p.staged = w <= ow && t_smem <= kResizeSmem ? 1 : 0;
  const long long chunks = (total + p.rows * p.rpt - 1) / (p.rows * p.rpt);
  const long long c = chunks * p.tiles / kResizeWaveBlocks;
  p.chunks = c < 1 ? 1 : c > kResizeMaxChunks ? kResizeMaxChunks : (int)c;
  p.band_rows = p.rows * p.rpt * p.chunks;
  p.bands = (total + p.band_rows - 1) / p.band_rows;
  p.blocks = p.bands * p.tiles;
  long long in_rows = bilinear_resize_span_rows(p.band_rows - 1, h, oh);
  if (in_rows > planes * h) in_rows = planes * h;
  p.in_floats = (in_rows * w + 3) / 4 * 4;
  if (!p.staged || p.tiles > 1 || p.in_floats * 4 + t_smem > kResizeSmem) p.in_floats = 0;
  p.smem = p.staged ? p.in_floats * 4 + t_smem : 0;
  return p;
}

// A launch of K6's forward as its launcher made it.
struct ResizeLaunchShape {
  long long blocks;
  int tiles, threads, band_rows, vec, staged;
  long long in_floats, smem;
};

// K6, bilinear half: x [planes, h, w]; out [planes, oh, ow]; taps h -> oh rows, w -> ow columns.
// *shape receives the launch's shape.
cudaError_t bilinear_resize(const float* x, float* out, int64_t planes, int h, int w, int oh,
                            int ow, TapArrays ty, TapArrays tx, cudaStream_t stream,
                            ResizeLaunchShape* shape);

// K6, bilinear half, backward (bilinear_resize_bwd.cu): dx = Ry^T g Rx. The planes' input rows
// are flattened, planes * h rows of w columns, and a block takes a band of `band` consecutive
// ones. The g rows their adjoint ranges cover are one contiguous run of the flattened g (at
// most span_rows), which the block copies into shared memory (rows of g_pitch floats), with
// the column taps and ranges. It forms R = g Rx there for every staged row and input column
// (rows of r_pitch floats), then dx = Ry^T R for its band, `vec` columns a thread (4 where
// w % 4 == 0: 16-byte stores). Where ow <= 2 w (col_lanes), R's lanes are on consecutive
// columns, each thread holding its column's taps (at most kResizeBwdTaps a range) in
// registers for every row it takes, and the rows, of ow floats, are copied 16 bytes a copy
// where ow % 4 == 0; else R's lanes are on consecutive rows, which rows of an odd number of
// floats (ow made odd, copied 4 bytes a copy) put in distinct banks, the taps read from
// shared memory. band: halved from kResizeBwdMaxBand while the
// grid is below kResizeBwdWaveBlocks or a block's shared memory above kResizeBwdSmem (R's lanes
// on rows: kResizeBwdRowsWaveBlocks and kResizeBwdRowsSmem, whose wider rows a bigger band
// reads fewer times). Where one row's span does not fit kResizeBwdSmemMax, a thread takes an
// input element and reads g from device memory (staged 0). All sum each term in the same
// order, so dx is the same.
constexpr int kResizeBwdThreads = 256;
constexpr int kResizeBwdColThreads = 128;   // a col_lanes block's
constexpr int kResizeBwdMaxBand = 64;
constexpr int kResizeBwdWaveBlocks = 528;   // 4 blocks an SM of 132
constexpr int kResizeBwdSmem = 32768;       // 32 KiB: seven blocks an SM
constexpr int kResizeBwdRowsWaveBlocks = 264;  // 2 blocks an SM
constexpr int kResizeBwdRowsSmem = 86016;      // 84 KiB: two blocks an SM
constexpr int kResizeBwdSmemMax = 232448;   // 227 KiB: the most a block may have
constexpr int kResizeBwdTaps = 4;           // a range's taps a col_lanes thread holds

// g rows (of the planes' flattened [planes * oh] rows) that d + 1 consecutive input rows' adjoint
// ranges span at most: source coordinates in an interval of d + 2.5 rows (align_corners=False;
// the clamp at the top adds half a row) or d + 2 closed at the end (align_corners=True), and two
// rows more at each of the d / h + 1 planes' edges crossed, and the intervals' rounding.
constexpr long long bilinear_resize_bwd_span_rows(long long d, int h, int oh) {
  const long long s1 = ((2 * d + 5) * oh + 2LL * h - 1) / (2LL * h);
  const long long s2 = h > 1 ? ((d + 2) * (oh - 1) + h - 2) / (h - 1) + 1 : 0;
  return (s1 > s2 ? s1 : s2) + d / h + 2;
}

constexpr long long resize_bwd_round4(long long n) { return (n + 3) / 4 * 4; }

// bytes of a staged block: R [span][r_pitch], g [span][g_pitch], the column weights [2][ow],
// the span rows' weights [2][span] and the column ranges [4][w] (each rounded to 16 bytes)
constexpr long long bilinear_resize_bwd_smem(long long span, int w, int ow, int g_pitch,
                                             int r_pitch) {
  return 4 * (span * r_pitch + resize_bwd_round4(span * g_pitch) + 2 * resize_bwd_round4(ow) +
              2 * resize_bwd_round4(span) + resize_bwd_round4(4LL * w));
}

struct ResizeBwdPlan {
  int staged;       // 1: bands staged in shared memory; 0: a thread an input element
  int band;         // input rows a band (staged)
  int span_rows;    // g rows a band spans at most (staged)
  int g_pitch;      // floats of a staged g row: ow (col_lanes), else ow made odd
  int r_pitch;      // floats of a row of R: w rounded up to 4, an odd multiple of 4
  int vec;          // columns a thread writes: 4 (w % 4 == 0) or 1
  int col_lanes;    // 1: R's lanes on columns, taps in registers (ow <= 2 w); 0: on rows
  int threads;      // threads a block
  long long blocks;
  long long smem;   // bytes of dynamic shared memory a block (0 direct)
};

// K6 backward's rule, by the shape [planes, h, w] <- [oh, ow].
constexpr ResizeBwdPlan bilinear_resize_bwd_plan(long long planes, int h, int w, int oh, int ow) {
  ResizeBwdPlan p = {};
  const long long total = planes * h;
  p.vec = w % 4 == 0 ? 4 : 1;
  p.col_lanes = ow <= 2LL * w ? 1 : 0;
  p.threads = p.col_lanes ? kResizeBwdColThreads : kResizeBwdThreads;
  p.g_pitch = p.col_lanes ? ow : ow | 1;
  p.r_pitch = (w + 3) / 4 * 4;
  if (p.r_pitch % 8 == 0) p.r_pitch += 4;
  const long long wave = p.col_lanes ? kResizeBwdWaveBlocks : kResizeBwdRowsWaveBlocks;
  const long long most = p.col_lanes ? kResizeBwdSmem : kResizeBwdRowsSmem;
  long long band = kResizeBwdMaxBand, span = 0;
  for (;;) {
    span = bilinear_resize_bwd_span_rows(band - 1, h, oh);
    if (span > planes * oh) span = planes * oh;
    if (band == 1 || ((total + band - 1) / band >= wave &&
                      bilinear_resize_bwd_smem(span, w, ow, p.g_pitch, p.r_pitch) <= most))
      break;
    band /= 2;
  }
  const long long smem = bilinear_resize_bwd_smem(span, w, ow, p.g_pitch, p.r_pitch);
  p.staged = smem <= kResizeBwdSmemMax ? 1 : 0;
  if (p.staged) {
    p.band = (int)band;
    p.span_rows = (int)span;
    p.blocks = (total + band - 1) / band;
    p.smem = smem;
  } else {
    p.threads = kResizeBwdThreads;
    p.blocks = (total * w + p.threads - 1) / p.threads;
  }
  return p;
}

// A launch of K6's backward as its launcher made it.
struct ResizeBwdLaunchShape {
  long long blocks;
  int threads, band, span_rows, vec, staged;
  long long smem;
};

// K6, bilinear half, backward: g [planes, oh, ow]; dx [planes, h, w]; the forward's taps and
// their adjoint ranges over [h] rows and [w] columns. *shape receives the launch's shape.
cudaError_t bilinear_resize_bwd(const float* g, float* dx, int64_t planes, int h, int w, int oh,
                                int ow, TapArrays ty, TapArrays tx, TapRanges ry, TapRanges rx,
                                cudaStream_t stream, ResizeBwdLaunchShape* shape);

// K5 backward (critic_input_bwd.cu): d cams = Ry^T (d cam_n) Rx, d cam_n[y, x] the sum over
// the channels of dA and the image resized to n x n. A block takes a band of `band`
// consecutive source rows [Y0, Y0 + band) of one map (the grid: bands of map 0, then of map 1,
// ...). The output rows y whose adjoint ranges cover the band are one contiguous run (at most
// span_rows: bilinear_resize_bwd_span_rows of one map), which sample the image rows
// [Y0 - 1, Y0 + band] at most (img_rows). The block copies those image rows and the taps into
// shared memory (cp.async, every copy in flight) while its threads load their columns' dA
// values for the run's first kCriticBwdPrefetchRows rows, forms d cam_n's rows, then the
// column adjoint R of every such row in the image rows' space, then d cams for the band's rows
// from R, each chain the first design's: the same terms in the same order. A thread takes a
// column in each pass (threads: the larger of n and W rounded up to a warp, at most
// kCriticBwdMaxThreads). band: halved from kCriticBwdMaxBand while the grid is below
// kCriticBwdWaveBlocks or a block's shared memory above kCriticBwdSmem; fits is 0 where one
// row's band does not fit kCriticBwdSmemMax or n exceeds the threads (the wrapper refuses the
// shape before a launch).
constexpr int kCriticBwdMaxThreads = 1024;
constexpr int kCriticBwdMaxBand = 8;
constexpr int kCriticBwdPrefetchRows = 10;  // a band of 8 spans 10 rows at 320 -> 224
constexpr int kCriticBwdWaveBlocks = 396;   // 3 blocks an SM of 132
constexpr int kCriticBwdSmem = 75776;       // 74 KiB: three blocks an SM
constexpr int kCriticBwdSmemMax = 232448;   // 227 KiB: the most a block may have

constexpr int critic_input_bwd_img_rows(int band, int H) { return band + 2 < H ? band + 2 : H; }

// floats of the image rows' space: the image rows [3][img_rows][W], then R [span][W]
constexpr long long critic_input_bwd_img_floats(long long span, int img_rows, int W) {
  return resize_bwd_round4((3LL * img_rows > span ? 3LL * img_rows : span) * W);
}

// bytes of a block: the image rows' space, d cam_n's rows [span][n] (rounded to 16 bytes) and
// the taps: the columns' [4][n] and their ranges [4][W], the span rows' [4][span] and the band
// rows' ranges [4][band]
constexpr long long critic_input_bwd_smem(long long span, int band, int H, int W, int n) {
  return 4 * (critic_input_bwd_img_floats(span, critic_input_bwd_img_rows(band, H), W) +
              resize_bwd_round4(span * n) + 4LL * n + 4LL * W + 4 * span + 4LL * band);
}

struct CriticBwdPlan {
  int fits;         // 0: one row's band does not fit shared memory, or n > threads (refused)
  int band;         // source rows a band
  int span_rows;    // output rows a band spans at most
  int img_rows;     // image rows a band samples at most
  int threads;      // threads a block: a column each
  long long blocks; // P * ceil(H / band)
  long long smem;   // bytes of dynamic shared memory a block
};

// K5 backward's rule, by the shape: P maps [H, W] <- [n, n] (align_corners=True).
constexpr CriticBwdPlan critic_input_bwd_plan(long long P, int H, int W, int n) {
  CriticBwdPlan p = {};
  const long long cols = ((n > W ? n : W) + 31LL) / 32 * 32;
  p.threads = (int)(cols < kCriticBwdMaxThreads ? cols : kCriticBwdMaxThreads);
  long long band = kCriticBwdMaxBand, span = 0;
  for (;;) {
    span = bilinear_resize_bwd_span_rows(band - 1, H, n);
    if (span > n) span = n;
    if (band == 1 || (P * ((H + band - 1) / band) >= kCriticBwdWaveBlocks &&
                      critic_input_bwd_smem(span, (int)band, H, W, n) <= kCriticBwdSmem))
      break;
    band /= 2;
  }
  p.smem = critic_input_bwd_smem(span, (int)band, H, W, n);
  p.fits = p.smem <= kCriticBwdSmemMax && n <= p.threads ? 1 : 0;
  p.band = (int)band;
  p.span_rows = (int)span;
  p.img_rows = critic_input_bwd_img_rows((int)band, H);
  p.blocks = P * ((H + band - 1) / band);
  return p;
}

// A launch of K5's backward as its launcher made it.
struct CriticBwdLaunchShape {
  long long blocks;
  int threads, band, span_rows;
  long long smem;
};

// K5 backward: dA [P * (n/ps)^2, 3 * ps * ps]; image [P/S, 3, H, W]; taps H -> n rows and
// W -> n columns with their ranges over [H] and [W]; dcams [P, H, W]. One launch, as
// critic_input_bwd_plan says (the caller has checked that it fits). *shape receives the
// launch's shape.
cudaError_t critic_input_bwd(const float* dA, const float* image, float* dcams, int P, int S,
                             int H, int W, int n, int ps, TapArrays ty, TapArrays tx,
                             TapRanges ry, TapRanges rx, cudaStream_t stream,
                             CriticBwdLaunchShape* shape);

// K7's tiles (path_max_tiles.cuh): K7's forward (path_max_affinity.cu), K7's backward and the
// IRN loss fused with K7 (K7 + K8, irn_affinity.cu). A block takes one image's tile of
// kPathTileCols columns and kPathThreads / kPathTileCols * rpt rows: a warp on consecutive
// columns of a row, each thread rpt rows 8 apart. The forwards tile the pair window
// [H - rf, W - 2 rf] of source pixels: the loss's takes every direction of the table in turn;
// K7's splits the directions among dir_groups blocks a tile (contiguous runs in table order),
// doubled from 1 up to kPathForwardGroups while the grid is below kPathWaveBlocks, once rpt
// is down to 1, so that a small window still fills the card. The backwards tile the
// [H, W] pixels, each gathering over every direction and step in table order. Shared memory
// holds the edge map (the loss: with the labels and dp) over the tile and its halo, rows of
// pitch = kPathTileCols + 2 rf values (a forward tile_rows + rf rows from its first
// source row; a backward tile_rows + 2 rf rows from rf above its first pixel, rf left of its
// first column), and, in a backward, one direction at a time, the path max and the cotangent
// over the tie count (double) of every pair whose path reaches the tile (at most tile_rows +
// rf rows of pitch). rpt: halved from kPathRowsPerThread while the grid is below
// kPathWaveBlocks. The path table travels as a kernel parameter of at most kPathTableSteps
// steps and kPathTableDirs directions; a block copies its steps' offsets to shared memory,
// whence a warp reads each step's at once.
constexpr int kPathTileCols = 32;
constexpr int kPathThreads = 256;
constexpr int kPathRowsPerThread = 4;
constexpr int kPathPairs = 2;          // a backward's pairs a thread takes at once
constexpr int kPathWaveBlocks = 264;   // 2 blocks an SM of 132
constexpr int kPathTableSteps = 4096;  // radius 12: 3606 steps
constexpr int kPathTableDirs = 256;    // radius 12: 218 directions
constexpr int kPathForwardGroups = 2;  // K7's forward: the most blocks a tile's directions take
// what a plan tiles
constexpr int kPathLossForward = 0;    // the fused loss's forward: pairs, edge + labels + dp
constexpr int kPathLossBackward = 1;   // its backward: pixels, edge + labels + dp
constexpr int kPathMaxBackward = 2;    // K7's backward: pixels, edge
constexpr int kPathMaxForward = 3;     // K7's forward: pairs, edge, directions in groups

struct PathTilePlan {
  int rpt;          // rows a thread
  int tile_rows;    // kPathThreads / kPathTileCols * rpt
  int tile_cols;    // kPathTileCols
  int pitch;        // values of a staged row: tile_cols + 2 rf
  int staged_rows;  // forward tile_rows + rf, backward tile_rows + 2 rf
  int region_rows;  // a backward's pairs a direction: tile_rows + rf (forward 0)
  int tiles_y, tiles_x;
  int dir_groups;   // K7's forward: blocks a tile, each a run of directions (else 1)
  long long blocks;
  long long smem;   // bytes of dynamic shared memory a block
};

// The tiles of `kind` over B images of [H, W] at radius floor rf (H > rf, W > 2 rf).
constexpr PathTilePlan path_tile_plan(int kind, long long B, int H, int W, int rf) {
  PathTilePlan p = {};
  const bool pairs = kind == kPathLossForward || kind == kPathMaxForward;
  const int rows = pairs ? H - rf : H, cols = pairs ? W - 2 * rf : W;
  const int warps = kPathThreads / kPathTileCols;
  p.tile_cols = kPathTileCols;
  p.tiles_x = (cols + kPathTileCols - 1) / kPathTileCols;
  p.rpt = kPathRowsPerThread;
  while (p.rpt > 1 && B * ((rows + warps * p.rpt - 1) / (warps * p.rpt)) * p.tiles_x <
                          kPathWaveBlocks)
    p.rpt /= 2;
  p.tile_rows = warps * p.rpt;
  p.tiles_y = (rows + p.tile_rows - 1) / p.tile_rows;
  const long long tiles = B * p.tiles_y * p.tiles_x;
  p.dir_groups = 1;
  while (kind == kPathMaxForward && p.dir_groups < kPathForwardGroups &&
         tiles * p.dir_groups < kPathWaveBlocks)
    p.dir_groups *= 2;
  p.blocks = tiles * p.dir_groups;
  p.pitch = kPathTileCols + 2 * rf;
  p.staged_rows = p.tile_rows + (pairs ? rf : 2 * rf);
  p.region_rows = pairs ? 0 : p.tile_rows + rf;
  // the table's step offsets (int16) first, then a backward's q (double) and path max, the
  // edge map, the loss's dp planes and labels
  const long long staged = (long long)p.staged_rows * p.pitch;
  const long long region = (long long)p.region_rows * p.pitch;
  const bool edge_only = kind == kPathMaxBackward || kind == kPathMaxForward;
  p.smem = 2LL * kPathTableSteps + (region * 12 + staged * (edge_only ? 4 : 13) + 15) / 16 * 16;
  return p;
}

// K7's forward takes the tiles (kPathMaxForward) where the table fits the kernel parameter
// and the tile a block's shared memory (kPathMaxSmem); else the direct kernel, a thread an
// output reading the table from device memory (any radius).
constexpr int kPathMaxSmem = 232448;  // 227 KiB
constexpr bool path_max_forward_tiled(const PathTilePlan& p, int n_dirs, int n_steps) {
  return n_dirs <= kPathTableDirs && n_steps <= kPathTableSteps && p.smem <= kPathMaxSmem;
}

// A path table in host memory: steps [n_steps, 2] the (dy, dx) of every direction's path,
// direction d's at [offsets[d], offsets[d + 1]), its first step the pair's destination; every
// step within 0 <= dy <= rf, |dx| <= rf; n_steps <= kPathTableSteps, n_dirs <= kPathTableDirs
// (the wrappers check).
struct PathSteps {
  const int* steps;
  const int* offsets;
  int n_dirs;
};

// K7's last forward launch: tiled or direct, blocks, threads, rows a thread, direction groups,
// bytes of dynamic shared memory a block.
struct PathMaxLaunchShape {
  int tiled;
  long long blocks;
  int threads, rpt, dir_groups;
  long long smem;
};

// K7: edge [B, H, W]; out [B, n_dirs, H - rf, W - 2 * rf]. With `plan` (kPathMaxForward, the
// caller has checked path_max_forward_tiled) the tiled kernel takes the host table as a
// kernel parameter; with plan == nullptr the direct kernel reads dev_steps [n_steps, 2] and
// dev_offsets [n_dirs + 1] (device memory). *shape receives the launch's shape.
cudaError_t path_max_affinity(const PathTilePlan* plan, const PathSteps& table,
                              const int* dev_steps, const int* dev_offsets, const float* edge,
                              float* out, int64_t B, int H, int W, int rf, cudaStream_t stream,
                              PathMaxLaunchShape* shape);

// K7 backward as `plan` (kPathMaxBackward) says: edge [B, H, W]; g [B, n_dirs, H - rf,
// W - 2 rf]; dedge [B, H, W].
cudaError_t path_max_affinity_bwd(const PathTilePlan& plan, const PathSteps& table,
                                  const float* edge, const float* g, float* dedge, int H, int W,
                                  int rf, cudaStream_t stream);

// K7 + K8, the IRN loss from the edge map, as `plan` (kPathLossForward) says: labels uint8
// [B, H, W]; edge [B, H, W]; dp [B, 2, H, W]; scratch psum [plan.blocks, 5] and pcount
// [plan.blocks, 3]; sums [5] float and counts [3] int64 on the device. A pair is valid where
// both its labels are below max_valid.
cudaError_t irn_affinity_loss(const PathTilePlan& plan, const PathSteps& table,
                              const unsigned char* labels, const float* edge, const float* dp,
                              double* psum, long long* pcount, float* sums, long long* counts,
                              int H, int W, int rf, float eps, float one_eps, int max_valid,
                              cudaStream_t stream);

// Its backward as `plan` (kPathLossBackward) says: gsum [5] the sums' gradients on the
// device; dedge as edge, ddp as dp.
cudaError_t irn_affinity_loss_bwd(const PathTilePlan& plan, const PathSteps& table,
                                  const unsigned char* labels, const float* edge,
                                  const float* dp, const float* gsum, float* dedge, float* ddp,
                                  int H, int W, int rf, float eps, float one_eps, int max_valid,
                                  cudaStream_t stream);

// K9 (refine_centroids.cu): where the edge-replicated table of the field, [(H + 1) * (W + 1)]
// (dy, dx) pairs as float2, fits a block's shared memory (staged), at most kCentroidsBlocks
// blocks, one an SM, share the H * W pixels evenly (block b takes the flat pixels
// [b * n / blocks, (b + 1) * n / blocks)), a thread a pixel, and each block stages the whole
// table once; else (direct, the first design) a thread a pixel in blocks of
// kCentroidsDirectThreads, reading the field from device memory with the +1 corners clamped.
// On both, a warp is 32 consecutive pixels of its block and stops once a step leaves every
// lane's centroid as it was, bit for bit (a step is a pure function of the centroid and the
// field, so every later step would repeat it); steps[warp] is the first such step (or
// `iterations`). The staged kernel votes every kCentroidsCheck steps, so it may run up to
// kCentroidsCheck - 1 steps past that step, which change nothing.
constexpr int kCentroidsBlocks = 132;         // one an SM
constexpr int kCentroidsCheck = 8;            // steps between a warp's votes
constexpr int kCentroidsDirectThreads = 128;
constexpr int kCentroidsSmemMax = 232448;     // 227 KiB: the most a block may have

struct CentroidsPlan {
  int staged;       // 1: the table in shared memory; 0: direct
  int threads;      // threads a block
  long long blocks;
  long long warps;  // warps in the grid: the entries of steps
  long long smem;   // bytes of dynamic shared memory a block (0 direct)
};

// K9's rule, by the grid [H, W].
constexpr CentroidsPlan refine_centroids_plan(int H, int W) {
  CentroidsPlan p = {};
  const long long n = (long long)H * W;
  const long long table = 8LL * (H + 1) * (W + 1);
  long long blocks = (n + 31) / 32;
  if (blocks > kCentroidsBlocks) blocks = kCentroidsBlocks;
  const long long per = blocks > 0 ? (n + blocks - 1) / blocks : 0;
  p.staged = n > 0 && table <= kCentroidsSmemMax && per <= 1024 ? 1 : 0;
  if (p.staged) {
    p.threads = (int)((per + 31) / 32 * 32);
    p.blocks = blocks;
    p.smem = table;
  } else {
    p.threads = kCentroidsDirectThreads;
    p.blocks = (n + p.threads - 1) / p.threads;
  }
  p.warps = p.blocks * (p.threads / 32);
  return p;
}

// K9: disp [2, H, W]; out int32 [2, H, W], the rounded centroids after `iterations` steps;
// steps int32 [refine_centroids_plan(H, W).warps], the steps each warp took.
cudaError_t refine_centroids(const float* disp, int* out, int* steps, int H, int W,
                             int iterations, cudaStream_t stream);

// K10: aff [n_dirs, ch, cw]; dirs [n_dirs, 2] (dy, dx); seq [n_seq] the band's nonzero
// offsets in ascending order (2 * d + (offset > 0), -1 the diagonal); lut [2 * max_off + 1]
// the direction of each flat offset (-2 the diagonal, -1 none); out [H * W, H * W].
cudaError_t walk_transition(const float* aff, const int* dirs, const int* seq, int n_seq,
                            const int* lut, float* out, int ch, int cw, int H, int W, int woff,
                            int max_off, float beta, cudaStream_t stream);

// K10, the walk's products: c [M, N] = a [M, K] @ b [K, N], summed in double; a is zero
// where |k - i| > band_a, b where |j - k| > band_b (0 <= band <= max(M, N, K)). K % 8 == 0,
// N % 4 == 0, 16-byte aligned rows. Either kernel serves any M; the caller sends the thin
// step (few rows of a) to walk_thin.
//
// walk_square (FP64 tensor cores): a block per kWalkTile x kWalkTile tile of c, k-tiles of
// kWalkStep on a global grid; it skips the k-tiles where occ_a [ceil(M / kWalkTile),
// ceil(K / kWalkStep)] or occ_b [ceil(K / kWalkStep), ceil(N / kWalkTile)] (the rows map of
// a, the cols map of b) is false, and takes walk_square_smem(K) bytes of dynamic shared
// memory.
constexpr int kWalkTile = 128;
constexpr int kWalkStep = 16;
cudaError_t walk_square(const float* a, const float* b, const bool* occ_a, const bool* occ_b,
                        float* c, int M, int N, int K, int band_a, int band_b,
                        cudaStream_t stream);
size_t walk_square_smem(int K);
// walk_thin: a block per kWalkThinRows rows of a and kWalkThinCols columns of b; its
// kWalkThinWarps warps take the kWalkThinChunk-row chunks of b by turns, from a multiple of
// kWalkThinChunk * kWalkThinWarps below the band's first row, and their sums are added in
// ascending warp.
constexpr int kWalkThinRows = 16;
constexpr int kWalkThinCols = 32;
constexpr int kWalkThinChunk = 16;
constexpr int kWalkThinWarps = 8;
cudaError_t walk_thin(const float* a, const float* b, float* c, int M, int N, int K, int band_a,
                      int band_b, cudaStream_t stream);

// K10's occupancy maps of x [R, C] (C % 4 == 0) on walk_square's grid: rows
// [ceil(R / kWalkTile), ceil(C / kWalkStep)] true where the kWalkTile x kWalkStep tile holds a
// nonzero, cols [ceil(R / kWalkStep), ceil(C / kWalkTile)] the same for the kWalkStep x
// kWalkTile tiles.
cudaError_t walk_tile_occupancy(const float* x, bool* rows, bool* cols, int R, int C,
                                cudaStream_t stream);

// K11: a block per (image, group of tiles of kPixelAttnTile pixels, channel slice), taking
// the group's tiles in turn and serving every one of the image's S pairs from one read of a
// tile's q ([P/S, HW, C]; pair i reads image i / S). Its kernels (pixel_attn.cu,
// pixel_attn_bwd.cu, pixel_attn_tiles.cuh) pad the T tokens to pixel_attn_t_bucket(T) (zeros
// in the staged keys and values, -inf logits), and split C over a cluster of
// pixel_attn_ranks(C, backward) blocks, pixel_attn_width(C, backward) channels each, whose
// partial logits are summed in rank order through distributed shared memory. A block holds
// at most kPixelAttnSlice channels of its slice at once (more are taken in turn, a sub-slice
// at a time, a tile a block), rows of pixel_attn_pitch(held) floats. Its kPixelAttnThreads
// threads hold register tiles of 4 pixels x bucket / 4 tokens in the logits (a pixel's
// tokens on 4 lanes of one warp), 4 pixels x 4 channels in the products over tokens and
// bucket / 4 tokens x 4 channels in the backward's products over pixels. A block takes
// pixel_attn_block_tiles(N, HW, C, backward) tiles of an image, so that the grid stays near
// kPixelAttnWaveBlocks blocks (kPixelAttnWaveBlocksBwd backward); the backward writes its
// dLk and dLv partials for each of pixel_attn_groups(N, HW, C, true) groups of tiles, which
// its second kernel adds in ascending order.
constexpr int kPixelAttnMaxT = 32;         // the backward's tokens (its buckets: 8 to 32)
constexpr int kPixelAttnMaxTForward = 48;  // the forward's: buckets 40 and 48 past 32
constexpr int kPixelAttnTile = 32;
constexpr int kPixelAttnThreads = 256;
constexpr int kPixelAttnSlice = 256;
constexpr int kPixelAttnSliceBwd = 256;
constexpr int kPixelAttnMaxRanks = 8;
constexpr int kPixelAttnMaxBlockTiles = 8;
constexpr int kPixelAttnWaveBlocks = 1056;    // the forward's: 8 blocks an SM of 132
constexpr int kPixelAttnWaveBlocksBwd = 528;  // the backward's: 4 an SM
constexpr int kPixelAttnSumBlocks = 8 * 132;  // at most the backward's second kernel's grid
constexpr long long kPixelAttnMaxSmem = 227 * 1024;  // bytes one block may use on Hopper
constexpr int pixel_attn_t_bucket(int T) {
  return T <= 8 ? 8 : T <= 16 ? 16 : T <= 20 ? 20 : T <= 24 ? 24 : T <= 32 ? 32
         : T <= 40 ? 40 : 48;
}
// a [pixel][token] row: the bucket made an odd number of 16-byte units
constexpr int pixel_attn_token_pitch(int tb) { return tb / 4 % 2 ? tb : tb + 4; }
constexpr int pixel_attn_ranks(int C, bool backward) {
  const long long s = backward ? kPixelAttnSliceBwd : kPixelAttnSlice, r = (C + s - 1) / s;
  return r < 1 ? 1 : r > kPixelAttnMaxRanks ? kPixelAttnMaxRanks : (int)r;
}
// channels a rank takes, a multiple of 4
constexpr int pixel_attn_width(int C, bool backward) {
  const long long r = pixel_attn_ranks(C, backward);
  return (int)(((C + r - 1) / r + 3) / 4 * 4);
}
// channels a block holds at once, the sub-slices its width takes, and a held row's floats
// (an odd number of 16-byte units)
constexpr int pixel_attn_held(int width) {
  return width < kPixelAttnSlice ? width : kPixelAttnSlice;
}
constexpr int pixel_attn_subslices(int width) {
  return (width + kPixelAttnSlice - 1) / kPixelAttnSlice;
}
constexpr int pixel_attn_pitch(int held) { return (held + 7) / 8 * 8 + 4; }
constexpr int pixel_attn_tiles(int HW) { return (HW + kPixelAttnTile - 1) / kPixelAttnTile; }
// tiles a block takes in turn (one where its width takes sub-slices), and the groups of
// tiles an image's tiles make
constexpr int pixel_attn_block_tiles(long long N, int HW, int C, bool backward) {
  if (pixel_attn_subslices(pixel_attn_width(C, backward)) > 1) return 1;
  const long long t = N * pixel_attn_tiles(HW) * pixel_attn_ranks(C, backward) /
                      (backward ? kPixelAttnWaveBlocksBwd : kPixelAttnWaveBlocks);
  return t < 1 ? 1 : t > kPixelAttnMaxBlockTiles ? kPixelAttnMaxBlockTiles : (int)t;
}
constexpr int pixel_attn_groups(long long N, int HW, int C, bool backward) {
  const int per = pixel_attn_block_tiles(N, HW, C, backward);
  return (pixel_attn_tiles(HW) + per - 1) / per;
}
// bytes of dynamic shared memory a block takes. Forward: q's tile, the pair's keys and
// values, the warps' partial logits (the whole logits over them), the block's partial
// logits and P. Backward: q's and dG's tiles, keys and values, the warps' partial logits
// and dA, the block's two partials, dL by pixel, and dL and A by token.
constexpr long long pixel_attn_smem(int tb, int C, bool backward) {
  const long long pitch = pixel_attn_pitch(pixel_attn_held(pixel_attn_width(C, backward)));
  const long long tp = pixel_attn_token_pitch(tb), tile = kPixelAttnTile;
  const long long red = kPixelAttnThreads / 32 * tile * tp, part = tile * tp;
  if (!backward) return 4 * (tile * pitch + 2 * tb * pitch + red + part + tile * tp);
  return 4 * (2 * tile * pitch + 2 * tb * pitch + red + 2 * part + tile * tp +
              2 * tb * (tile + 4));
}
// the shapes the kernels take: 1 <= T <= kPixelAttnMaxT tokens (the forward alone up to
// kPixelAttnMaxTForward: the demo's comma-separated phrases, 20 tokens each), any C >= 1 and
// S >= 1 (any HW), within kPixelAttnMaxSmem
constexpr bool pixel_attn_takes(int T, int C, int S, bool backward) {
  return T >= 1 && T <= (backward ? kPixelAttnMaxT : kPixelAttnMaxTForward) && C >= 1 && S >= 1 &&
         pixel_attn_smem(pixel_attn_t_bucket(T), C, backward) <= kPixelAttnMaxSmem;
}
// A launch of K11 as its launcher made it: blocks, blocks a cluster, threads a block, the
// token bucket, pixels a tile, channels a rank, tile groups an image,
// the bytes of each global load (16, or 4 where a pointer or C is not a multiple of 16
// bytes) and bytes of dynamic shared memory a block.
struct PixelAttnLaunchShape {
  int blocks, cluster, threads, t_bucket, tile, width, groups, load_bytes;
  long long smem;
};

// K11: q [P/S, HW, C]; lk, lv [P, T, C]; out [P, HW, C]. *shape receives the launch's shape.
cudaError_t pixel_attn(const float* q, const float* lk, const float* lv, float* out, int P, int HW,
                       int T, int C, int S, float div, cudaStream_t stream,
                       PixelAttnLaunchShape* shape);

// K11 backward: dg [P, HW, C]; q, lk, lv as the forward; scratch partials [2, P,
// pixel_attn_groups(P / S, HW, C, true), T, C] (dLk's, then dLv's); dq [P/S, HW, C], dlk and
// dlv [P, T, C]. shapes[0] and shapes[1] receive its two launches' shapes.
cudaError_t pixel_attn_bwd(const float* dg, const float* q, const float* lk, const float* lv,
                           float* partials, float* dq, float* dlk, float* dlv, int P, int HW,
                           int T, int C, int S, float div, cudaStream_t stream,
                           PixelAttnLaunchShape* shapes);

// K12: table [n_leaves, 4] of (teacher pointer, student pointer, numel, kind: 0 float32
// lerp, 1 int64 copy); starts [n_leaves] the first chunk of each leaf, n_chunks in all,
// `chunk` elements each. Teacher e := e * d + p * omd.
cudaError_t ema_update(const long long* table, const long long* starts, int n_leaves,
                       long long n_chunks, long long chunk, float d, float omd,
                       cudaStream_t stream);

// K13: BatchNorm over x [N, C, HW] (contiguous float32) with the activation that follows it
// (batch_norm.cu, batch_norm_bwd.cu), in one of two designs, chosen by batch_norm_plan on the
// shape alone. Fused, where a channel fits on chip: a cluster of R blocks owns a channel,
// rank r staging its samples [r N / R, (r + 1) N / R) (the forward's x, the backward's g and
// x) in shared memory, so each input is read from device memory once and a call is one
// launch (the backward with PReLU two). Two-pass, where it does not: the statistics and the
// backward's sums take a warp per (channel, sample, slice of at most kBatchNormSlice
// elements of the sample's plane): batch_norm_slices(HW) slices a plane, warp w = (c * N + n)
// * slices + slice, kBatchNormThreads / 32 warps a block; an apply pass follows. The eval
// fold's forward is the apply pass alone. tools/batch_norm_schedule.py reads these constants
// and rules.
constexpr int kBatchNormThreads = 256;
constexpr int kBatchNormSlice = 4096;
constexpr int kBatchNormMaxBatch = 4096;  // the statistics hold a channel's N moments in 32 KB
// the activation after the norm: none, ReLU, or the channel-shared PReLU where(y >= 0, y, a y)
constexpr int kBatchNormActNone = 0;
constexpr int kBatchNormActRelu = 1;
constexpr int kBatchNormActPrelu = 2;
constexpr long long batch_norm_slices(long long HW) {
  return (HW + kBatchNormSlice - 1) / kBatchNormSlice;
}

// The designs: two-pass (forward: statistics 2 launches and the apply 1; backward 3), fused
// (1; the backward with PReLU 2: the channels' slope sums are added by a second launch), the
// eval fold's forward (the apply, 1).
constexpr int kBatchNormTwoPass = 0;
constexpr int kBatchNormFused = 1;
constexpr int kBatchNormApplyOnly = 2;
// Fused blocks: R up to the portable cluster of 8; the backward may take a non-portable
// cluster of kBatchNormWideRanks where the card fits one (cudaOccupancyMaxActiveClusters). R: the first whose block fits the small target
// (four blocks an SM, kBatchNormFusedThreads each), else the first within the target (two
// blocks an SM), else the first within the most a block may have (one block an SM,
// kBatchNormFusedThreadsWide), else R = 16 (backward). A cluster owns one channel: the
// blocks an SM holds at once overlap one's copies with another's sums and writes.
constexpr int kBatchNormMaxRanks = 8;
constexpr int kBatchNormWideRanks = 16;
constexpr int kBatchNormSmemSmall = 57344;    // 56 KiB
constexpr int kBatchNormSmemTarget = 115712;  // 113 KiB
constexpr int kBatchNormSmemMax = 232448;     // 227 KiB
constexpr int kBatchNormFusedThreads = 256;
constexpr int kBatchNormFusedThreadsWide = 512;
// the apply pass: blocks of kBatchNormApplyThreads over (planes, chunk of a plane), an item
// (float4 or float) a thread; the fused kernels keep kBatchNormFusedUnroll items a lane of
// the residual or ReLU's output in flight, the fused backward's blocks of
// kBatchNormFusedThreadsWide (one an SM, registers to spare) kBatchNormFusedUnrollWide
constexpr int kBatchNormApplyThreads = 256;
constexpr int kBatchNormFusedUnroll = 4;
constexpr int kBatchNormFusedUnrollWide = 8;

// items of a plane: float4 where HW % 4 == 0, else floats
constexpr int batch_norm_items(int HW) { return HW % 4 == 0 ? HW / 4 : HW; }
// floats of a staged plane: HW rounded up to 16 bytes
constexpr long long batch_norm_pitch(int HW) { return ((long long)HW + 3) / 4 * 4; }

// A fused block's shared memory: `samples` staged planes (the backward's g, then x: two
// sets), the channel's N exchanged sample sums (forward: float mean and squared deviations;
// backward: double sums of dz, dz x-hat and PReLU's g y), three double partials a warp, an
// mbarrier a staged sample and 4 floats of the channel's coefficients.
constexpr long long batch_norm_fused_smem(int N, int HW, bool backward, int samples,
                                          int threads) {
  return (backward ? 2 : 1) * samples * batch_norm_pitch(HW) * 4 + (backward ? 24LL : 8LL) * N +
         24LL * (threads / 32) + 8LL * samples + 16;
}

// Lanes that sum a sample: the largest power of two g with g * samples <= threads, no more
// than the plane has items (g >= items stops the doubling).
constexpr int batch_norm_group(int threads, int samples, int items) {
  int g = 1;
  while (2LL * g * samples <= threads && g < items) g *= 2;
  return g;
}

struct BatchNormPlan {
  int design;      // kBatchNormTwoPass, kBatchNormFused or kBatchNormApplyOnly
  int ranks;       // fused: blocks a channel, one cluster
  int samples;     // fused: planes a rank stages at most, ceil(N / ranks)
  int threads;     // fused: threads a block
  int group;       // fused: lanes that sum a sample
  long long smem;  // fused: bytes of dynamic shared memory a block
  int blocks;      // fused: C * ranks
  int launches;    // kernel launches of the call
  int max_ranks;   // the largest cluster the plan could take
};

// K13's rule: the design of a call, by its shape. training: batch statistics (else the eval
// fold); backward: the gradient's call; act as kBatchNormAct*; max_ranks: the largest
// cluster the card takes (kBatchNormMaxRanks, or kBatchNormWideRanks for the backward). The
// residual is read from device memory, so it changes nothing here.
constexpr BatchNormPlan batch_norm_plan(int N, int C, int HW, bool training, bool backward,
                                        int act, int max_ranks) {
  BatchNormPlan p = {kBatchNormTwoPass, 0, 0, 0, 0, 0, 0, 3, max_ranks};
  if (!training && !backward) {
    p.design = kBatchNormApplyOnly;
    p.launches = 1;
    return p;
  }
  if (N > kBatchNormMaxBatch || (long long)N * HW >= (1LL << 24)) return p;
  const int portable = N < kBatchNormMaxRanks ? N : kBatchNormMaxRanks;
  for (int pass = 0; pass < 4 && p.ranks == 0; ++pass) {
    const int threads = pass < 2 ? kBatchNormFusedThreads : kBatchNormFusedThreadsWide;
    const long long most = pass == 0   ? kBatchNormSmemSmall
                           : pass == 1 ? kBatchNormSmemTarget
                                       : kBatchNormSmemMax;
    const int first = pass == 3 ? kBatchNormWideRanks : 1;
    const int last = pass < 3 ? portable
                     : backward && max_ranks >= kBatchNormWideRanks && N >= kBatchNormWideRanks
                         ? kBatchNormWideRanks
                         : 0;
    for (int r = first; r <= last; ++r) {
      const int samples = (N + r - 1) / r;
      const long long smem = batch_norm_fused_smem(N, HW, backward, samples, threads);
      if (smem <= most) {
        p = {kBatchNormFused, r, samples, threads,
             batch_norm_group(threads, samples, batch_norm_items(HW)), smem, C * r,
             backward && act == kBatchNormActPrelu ? 2 : 1, max_ranks};
        break;
      }
    }
  }
  return p;
}

// The rule on this card: batch_norm_plan with max_ranks kBatchNormWideRanks for the backward
// where its fused kernel fits a cluster of that many blocks at the plan's shared memory
// (cudaOccupancyMaxActiveClusters), else kBatchNormMaxRanks. force: -1 or kBatchNormFused
// the rule; kBatchNormTwoPass the two-pass design wherever the rule fuses (to time one design
// against the other).
BatchNormPlan batch_norm_device_plan(int N, int C, int HW, bool training, bool backward, int act,
                                     int force);

// A launch of K13 as its launcher made it: blocks, blocks a cluster, threads a block, bytes of
// dynamic shared memory a block and of each load from device memory.
struct BatchNormLaunchShape {
  int blocks, cluster, threads;
  long long smem;
  int load_bytes;
};

// K13 statistics, two launches: partial [C * N * batch_norm_slices(HW) * 2] double scratch;
// stats [3, C] receives mean, biased var and rstd = 1 / sqrt(var + eps); running_mean and
// running_var [C] move by `momentum` (the unbiased var) unless null. N * C * HW < 2^31,
// 1 <= N * HW < 2^24, N <= kBatchNormMaxBatch. shapes[0..2) receive the launches' shapes
// unless null.
cudaError_t batch_norm_stats(const float* x, double* partial, float* stats, float* running_mean,
                             float* running_var, int N, int C, int HW, double momentum,
                             double eps, cudaStream_t stream, BatchNormLaunchShape* shapes);

// K13's two-pass statistics in their stages, for a batch split across ranks
// (kernels/batch_norm.py gathers the partials of every rank between them). The partial
// launch writes partial [C, N, batch_norm_slices(HW), 2] (double) of x's N samples, each
// sample's sums shifted by shift[c] (null: x's first value of channel c, as
// batch_norm_stats takes); the final launch reads the partials of N samples (every rank's,
// in rank order) and the shift as shift[c * shift_stride], and writes stats as
// batch_norm_stats does, the running buffers moved by the count N * HW.
cudaError_t batch_norm_stats_partial(const float* x, const float* shift, double* partial, int N,
                                     int C, int HW, cudaStream_t stream,
                                     BatchNormLaunchShape* shape);
cudaError_t batch_norm_stats_final(const float* shift, long long shift_stride,
                                   const double* partial, float* stats, float* running_mean,
                                   float* running_var, int N, int C, int HW, double momentum,
                                   double eps, cudaStream_t stream, BatchNormLaunchShape* shape);

// K13 apply, one launch: y = act(((x - mean) * rstd) * weight + bias [+ residual]), each
// product and sum rounded alone; mean and rstd null: y = act(x * weight + bias) (the eval
// fold, weight and bias its a and b). residual as x or null; slope [1] (PReLU) or null.
cudaError_t batch_norm_apply(const float* x, const float* mean, const float* rstd,
                             const float* weight, const float* bias, const float* residual,
                             const float* slope, float* y, int N, int C, int HW, int act,
                             cudaStream_t stream, BatchNormLaunchShape* shape);

// K13's eval fold in bfloat16 (--bf16), one launch: x, residual and y bfloat16, a and b the
// fold's [C] rounded to bfloat16; y = act(bf16(bf16(x * a) + b) [+ residual, rounded]), each
// product and sum formed in float32 and rounded to bfloat16 as the bfloat16 ops of the plain
// version round; act kBatchNormActNone or kBatchNormActRelu (no PReLU). 16-byte accesses
// (8 values) where HW % 8 == 0 and x, residual and y are 16-byte aligned, else 2-byte ones.
cudaError_t batch_norm_fold_bf16(const Bf16Bits* x, const Bf16Bits* a, const Bf16Bits* b,
                                 const Bf16Bits* residual, Bf16Bits* y, int N, int C, int HW,
                                 int act, cudaStream_t stream, BatchNormLaunchShape* shape);

// K13 train forward on bfloat16 x, residual and y (--bf16), three launches (the two-pass
// design at every shape): the statistics of x's values as batch_norm_stats forms them (stats
// [3, C] float32, the running buffers moved unless null; partial as batch_norm_stats'), then
// y = act(bf16(bf16(((x - mean) * rstd) * weight + bias) [+ residual])), the norm formed in
// float32 as batch_norm_apply forms it and each rounding the plain version's; weight and bias
// float32; act kBatchNormActNone or kBatchNormActRelu. shapes[0..3) receive the launches'.
cudaError_t batch_norm_forward_bf16(const Bf16Bits* x, const float* weight, const float* bias,
                                    const Bf16Bits* residual, Bf16Bits* y, float* stats,
                                    double* partial, float* running_mean, float* running_var,
                                    int N, int C, int HW, int act, double momentum, double eps,
                                    cudaStream_t stream, BatchNormLaunchShape* shapes);

// K13 train forward as `plan` (batch_norm_device_plan, training) says: y = act(((x - mean) *
// rstd) * weight + bias [+ residual]) on the batch statistics, which stats [3, C] receives as
// batch_norm_stats does, the running buffers moved unless null. partial: the two-pass
// design's scratch as batch_norm_stats' (null when fused). shapes[0..plan.launches) receive
// the launches' shapes.
cudaError_t batch_norm_forward(const BatchNormPlan& plan, const float* x, const float* weight,
                               const float* bias, const float* residual, const float* slope,
                               float* y, float* stats, double* partial, float* running_mean,
                               float* running_var, int N, int C, int HW, int act,
                               double momentum, double eps, cudaStream_t stream,
                               BatchNormLaunchShape* shapes);

// K13's two-pass backward in its stages (batch_norm_bwd's, for a batch split across
// ranks). partial: [C, N, batch_norm_slices(HW), 3] (double) sums of dz, dz x-hat and
// PReLU's g y; final: of N samples' partials (a rank's own, or every rank's in rank order),
// coef [2, C] (the sums over M = N * HW), dweight and dbias [C] (the sums), slope_sums [C]
// or null; apply: dx (and dres, dslope) from the coefficients and slope sums given.
cudaError_t batch_norm_bwd_partial(const float* g, const float* x, const float* out,
                                   const float* mean, const float* rstd, const float* weight,
                                   const float* bias, const float* slope, double* partial, int N,
                                   int C, int HW, int act, cudaStream_t stream,
                                   BatchNormLaunchShape* shape);
cudaError_t batch_norm_bwd_final(const double* partial, float* coef, float* dweight,
                                 float* dbias, double* slope_sums, int N, int C, int HW,
                                 cudaStream_t stream, BatchNormLaunchShape* shape);
cudaError_t batch_norm_bwd_apply(const float* g, const float* x, const float* out,
                                 const float* mean, const float* rstd, const float* weight,
                                 const float* bias, const float* slope, const float* coef,
                                 const double* slope_sums, float* dslope, float* dx, float* dres,
                                 int N, int C, int HW, int act, cudaStream_t stream,
                                 BatchNormLaunchShape* shape);

// K13 train backward on bfloat16 g, x and out (--bf16), three launches (the two-pass
// design): partial [C * N * batch_norm_slices(HW) * 3] double and coef [2, C] scratch;
// dweight and dbias [C] float32; dx (rounded to bfloat16 once) and dres (the masked g, or
// null) bfloat16 as x. act kBatchNormActNone or kBatchNormActRelu (out the forward's y, the
// ReLU's mask). shapes[0..3) receive the launches' shapes.
cudaError_t batch_norm_bwd_bf16(const Bf16Bits* g, const Bf16Bits* x, const Bf16Bits* out,
                                const float* mean, const float* rstd, const float* weight,
                                const float* bias, double* partial, float* coef, float* dweight,
                                float* dbias, Bf16Bits* dx, Bf16Bits* dres, int N, int C, int HW,
                                int act, cudaStream_t stream, BatchNormLaunchShape* shapes);

// K13 backward as `plan` (batch_norm_device_plan, backward) says, from g = dL/dy: out the
// forward's y (ReLU's mask; null for the other activations); mean and rstd as the forward
// (null: the eval fold, x-hat = x and no batch-statistics terms); partial: double scratch,
// two-pass [C * N * batch_norm_slices(HW) * 3 (+ C with a slope)], fused [C] with a slope
// (else unused); coef [2, C] scratch (two-pass); dweight, dbias [C]; dslope [1] (PReLU) or
// null; dx as x; dres as x (the residual's gradient) or null. shapes[0..plan.launches)
// receive the launches' shapes.
cudaError_t batch_norm_bwd(const BatchNormPlan& plan, const float* g, const float* x,
                           const float* out, const float* mean, const float* rstd,
                           const float* weight, const float* bias, const float* slope,
                           double* partial, float* coef, float* dweight, float* dbias,
                           float* dslope, float* dx, float* dres, int N, int C, int HW, int act,
                           cudaStream_t stream, BatchNormLaunchShape* shapes);

}  // namespace tris
