// The host-side launchers of the kernels in this directory: one declaration
// each, included by the .cu file that defines it and by bindings.cpp that
// calls it, so the compiler holds both sides to the same signature. Each
// launches on `stream`, allocates nothing and returns cudaGetLastError().
// Pointers are to contiguous float32 data unless a stride says otherwise.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tris {

// K1: q/k/v element (n, l, c) at base + n*x_seq + l*x_row + c; out [N, Lq, n_head*hd];
// mask [Lq, Lk] or null.
cudaError_t mha_short(const float* q, const float* k, const float* v, const float* mask,
                      float* out, int N, int Lq, int Lk, int hd, int n_head, int64_t q_seq,
                      int64_t q_row, int64_t k_seq, int64_t k_row, int64_t v_seq,
                      int64_t v_row, float scale, cudaStream_t stream);

// K2: qv/kv/vv [P/S, HW, m]; qt/kt/vt [P, T, m]; new_vis [P, HW, m]; new_lan [P, T, m].
cudaError_t cross_attn(const float* qv, const float* kv, const float* vv, const float* qt,
                       const float* kt, const float* vt, float* new_vis, float* new_lan, int P,
                       int HW, int T, int m, int S, float div, cudaStream_t stream);

// K3: vis_new [P, h*w, D] or null; vis_base [P/S, h*w, D]; lan [P, D]; out [P, H, W];
// scale a device scalar; y taps [H], x taps [W].
cudaError_t response_head(const float* vis_new, const float* vis_base, const float* lan,
                          float* out, int P, int S, int h, int w, int D, int H, int W,
                          float alpha, const float* scale, const int* ylo, const int* yhi,
                          const float* wy0, const float* wy1, const int* xlo, const int* xhi,
                          const float* wx0, const float* wx1, cudaStream_t stream);

// K4: cams [B, S, h, w]; y taps [B, maxH], x taps [B, maxW]; orig_hw [B, 2];
// either norm_out [B, S, maxH, maxW] (targets, boxes and stats null) or
// stats [B, S, 4] from targets [B, maxH, maxW] and boxes [B, 4] (norm_out null).
cudaError_t eval_metrics(const float* cams, int B, int S, int h, int w, int maxH, int maxW,
                         const int* ylo, const int* yhi, const float* wy0, const float* wy1,
                         const int* xlo, const int* xhi, const float* wx0, const float* wx1,
                         const int* orig_hw, const unsigned char* targets, const float* boxes,
                         float* norm_out, float* stats, cudaStream_t stream);

}  // namespace tris
