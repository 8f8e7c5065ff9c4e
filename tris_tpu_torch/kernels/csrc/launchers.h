// The host-side launchers of the kernels in this directory: one declaration
// each, included by the .cu file that defines it and by bindings.cpp that
// calls it, so the compiler holds both sides to the same signature. Each
// launches on `stream`, allocates nothing and returns cudaGetLastError().
// Pointers are to contiguous float32 data unless a stride says otherwise.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tris {

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

// K1 backward: dout [N, Lq, C]; q/k/v as the forward; dq [N, Lq, C], dk and dv [N, Lk, C].
cudaError_t mha_short_bwd(const float* dout, const float* q, const float* k, const float* v,
                          const float* mask, float* dq, float* dk, float* dv, int N, int Lq,
                          int Lk, int hd, int n_head, int64_t q_seq, int64_t q_row,
                          int64_t k_seq, int64_t k_row, int64_t v_seq, int64_t v_row,
                          float scale, cudaStream_t stream, MhaLaunchShape* shape);

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

// K3, training head: vis_p [B, h*w, D]; lan_p [B, B, D]; scale a device scalar; taps
// h -> H rows and w -> W columns. Writes score [B, h*w, B], cls_out [B, B], cls_fg [B],
// relu_map and sig_map [B, H, W].
cudaError_t stage1_head(const float* vis_p, const float* lan_p, const float* scale,
                        float* score, float* cls_out, float* cls_fg, float* relu_map,
                        float* sig_map, int B, int h, int w, int D, int H, int W, float focal_p,
                        float focal_c, TapArrays ty, TapArrays tx, cudaStream_t stream);

// K3 backward: g_cls [B, B]; g_relu and g_sig [B, H, W] or null (both null: no map
// gradient); score as the forward wrote it; scratch dt [B, H, w] and dscore
// [B, h*w, B]; d_vis [B, h*w, D], d_lan [B, B, D].
cudaError_t stage1_head_bwd(const float* g_cls, const float* g_relu, const float* g_sig,
                            const float* vis_p, const float* lan_p, const float* scale,
                            const float* score, float* dt, float* dscore, float* d_vis,
                            float* d_lan, int B, int h, int w, int D, int H, int W,
                            float focal_p, float focal_c, TapArrays ty, TapArrays tx,
                            TapRanges ry, TapRanges rx, cudaStream_t stream);

// K3: vis_new [P, h*w, D] or null; vis_base [P/S, h*w, D]; lan [P, D]; out [P, H, W];
// scale a device scalar; y taps [H], x taps [W].
cudaError_t response_head(const float* vis_new, const float* vis_base, const float* lan,
                          float* out, int P, int S, int h, int w, int D, int H, int W,
                          float alpha, const float* scale, const int* ylo, const int* yhi,
                          const float* wy0, const float* wy1, const int* xlo, const int* xhi,
                          const float* wx0, const float* wx1, cudaStream_t stream);

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

// K5 backward: dA [P * (n/ps)^2, 3 * ps * ps]; image [P/S, 3, H, W]; taps H -> n rows
// and W -> n columns with their ranges; scratch dt [P, n, W]; dcams [P, H, W].
cudaError_t critic_input_bwd(const float* dA, const float* image, float* dt, float* dcams, int P,
                             int S, int H, int W, int n, int ps, TapArrays ty, TapArrays tx,
                             TapRanges ry, TapRanges rx, cudaStream_t stream);

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

// K6, bilinear half, backward: g [planes, oh, ow]; dx [planes, h, w]; the forward's taps and
// their adjoint ranges over [h] rows and [w] columns.
cudaError_t bilinear_resize_bwd(const float* g, float* dx, int64_t planes, int h, int w, int oh,
                                int ow, TapArrays ty, TapArrays tx, TapRanges ry, TapRanges rx,
                                cudaStream_t stream);

// K7: edge [B, H, W]; out [B, n_dirs, H - rf, W - 2 * rf]; steps [n_steps, 2] the (dy, dx)
// of every direction's path, direction d's at [offsets[d], offsets[d + 1]).
cudaError_t path_max_affinity(const float* edge, float* out, int64_t B, int H, int W, int rf,
                              int n_dirs, const int* steps, const int* offsets,
                              cudaStream_t stream);

// K7 backward: edge [B, H, W]; g, and the scratch pmax (float) and count (one byte, so no path
// has more than 255 steps), [B, n_dirs, H - rf, W - 2 * rf]; dedge [B, H, W]; the forward's
// path table.
cudaError_t path_max_affinity_bwd(const float* edge, const float* g, float* pmax,
                                  unsigned char* count, float* dedge, int64_t B, int H, int W,
                                  int rf, int n_dirs, const int* steps, const int* offsets,
                                  cudaStream_t stream);

// K8: labels uint8 [B, H, W]; aff [B, n_dirs, H - rf, W - 2 * rf]; dp [B, 2, H, W]; dirs
// [n_dirs, 2] each direction's (dy, dx); scratch psum [blocks, 5] and pcount [blocks, 3] with
// blocks = irn_loss_blocks(aff's numel); sums [5] float and counts [3] int64 on the device.
// A pair is valid where both its labels are below max_valid.
int irn_loss_blocks(int64_t n);
cudaError_t irn_loss(const unsigned char* labels, const float* aff, const float* dp,
                     const int* dirs, double* psum, long long* pcount, float* sums,
                     long long* counts, int64_t B, int H, int W, int rf, int n_dirs, float eps,
                     float one_eps, int max_valid, cudaStream_t stream);

// K8 backward: gsum [5] the sums' gradients on the device; daff as aff, ddp as dp.
cudaError_t irn_loss_bwd(const unsigned char* labels, const float* aff, const float* dp,
                         const int* dirs, const float* gsum, float* daff, float* ddp, int64_t B,
                         int H, int W, int rf, int n_dirs, float eps, float one_eps,
                         int max_valid, cudaStream_t stream);

// K9: disp [2, H, W]; out int32 [2, H, W], the rounded centroids after `iterations` steps.
cudaError_t refine_centroids(const float* disp, int* out, int H, int W, int iterations,
                             cudaStream_t stream);

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
constexpr int kPixelAttnMaxT = 32;
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
  return T <= 8 ? 8 : T <= 16 ? 16 : T <= 20 ? 20 : T <= 24 ? 24 : 32;
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
// the shapes the kernels take: 1 <= T <= kPixelAttnMaxT tokens, any C >= 1 and S >= 1 (any
// HW), within kPixelAttnMaxSmem
constexpr bool pixel_attn_takes(int T, int C, int S, bool backward) {
  return T >= 1 && T <= kPixelAttnMaxT && C >= 1 && S >= 1 &&
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

// K13 apply, one launch: y = act(((x - mean) * rstd) * weight + bias [+ residual]), each
// product and sum rounded alone; mean and rstd null: y = act(x * weight + bias) (the eval
// fold, weight and bias its a and b). residual as x or null; slope [1] (PReLU) or null.
cudaError_t batch_norm_apply(const float* x, const float* mean, const float* rstd,
                             const float* weight, const float* bias, const float* residual,
                             const float* slope, float* y, int N, int C, int HW, int act,
                             cudaStream_t stream, BatchNormLaunchShape* shape);

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
