// K1: short-sequence multi-head attention, forward, float32.
//
// Replaces the JAX package's hand-shaped XLA attention,
// tris_tpu/models/layers.py::multi_head_attention (lines 25-48):
//   out = softmax((q * hd^-1/2) . k^T + mask) . v
// per (sequence, head), q scaled and rounded BEFORE the dot and the mask
// additive (-inf for the causal mask, so masked logits vanish in the exp).
//
// Shapes on the paths, hd = 64: the CLIP text towers, L = 20 causal, 8 heads
// (N = 32 at eval, 48 in training), and the ViT-B/32 critic, L = 50, 12
// heads (N = 32 in PRMS, 48 in training). attnpool's 101 tokens (32 heads)
// are taken too, on no path.
//
// Bound: at these shapes the FP32 products (4 L^2 hd flops a head) and the
// bytes of q, k, v and out are within 2x of each other: the ViT's 0.0037 ms
// of FFMA against 0.0059 of bytes at N = 32. Design (mha_short_tiles.cuh): a
// block per (sequence, head) stages the head's q (scaled), k and v once with
// 16-byte cp.async copies, padded to the length bucket (50 tokens to 56) and
// the head-dim bucket, v landing while the logits are formed; each thread
// forms a (2 or 4)-row x (LP/8)-key tile of the logits in registers, several
// FFMAs per 16-byte shared-memory read; the softmax runs in registers with
// three shuffles a row; P goes to shared memory over q and k, and each
// thread forms its rows x (HD/8) channels of P V, written with 16-byte
// stores.
//
// mha_short_bf16_kernel (--bf16, the text tower on bfloat16 leaves): bfloat16 q, k and v
// read with 16-byte loads and widened into the same float32 tiles (q times the bfloat16
// scale, rounded to bfloat16), the logits rounded to bfloat16 before the float32 mask is
// added, as the JAX function's einsum rounds them; the softmax and P V as above, out float32.

#include "mha_short_tiles.cuh"

namespace {

using namespace tris::mha;

// q/k/v element (n, l, h*hd + d) lives at base + n*seq + l*row + h*hd + d;
// out is contiguous [N, Lq, n_head*hd]; mask is [Lq, Lk] or null.
template <int LP, int HD, bool VEC>
__global__ void __launch_bounds__(Tiles<LP, HD>::kThreads)
mha_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, int Lq, int Lk, int hd, int n_head, long long q_seq,
                 long long q_row, long long k_seq, long long k_row, long long v_seq,
                 long long v_row, float scale) {
  using T = Tiles<LP, HD>;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + T::kOperand;
  float* const ps = qs;  // P, over q and k once the logits are formed
  constexpr int kFront = 2 * T::kOperand > LP * T::kPPitch ? 2 * T::kOperand : LP * T::kPPitch;
  float* const vs = qs + kFront;

  const int n = blockIdx.x / n_head, h = blockIdx.x % n_head;
  const long long col = (long long)h * hd;
  stage<LP, HD, VEC>(qs, q + n * q_seq + col, q_row, Lq, hd);
  stage<LP, HD, VEC>(ks, k + n * k_seq + col, k_row, Lk, hd);
  tris::cp_async_commit();
  stage<LP, HD, VEC>(vs, v + n * v_seq + col, v_row, Lk, hd);
  staged<LP, HD, 1>(qs, scale);  // v lands while the logits are formed
  __syncthreads();

  float s[T::kRows][T::kKeys] = {};
  logits<LP, HD>(qs, ks, s);
  softmax<LP, HD>(s, mask, Lq, Lk);
  tris::cp_async_wait<0>();
  __syncthreads();  // every thread's logits formed and v landed: P may overwrite q and k
  put_probs<LP, HD>(ps, s);
  __syncthreads();

  float4 o[T::kRows][T::kChan4] = {};
  rows_by_keys<LP, HD>(ps, vs, (Lk + 3) / 4 * 4, o);
  const int ty = group_y();
  put_rows<LP, HD, VEC>(out + (long long)n * Lq * n_head * hd + col, (long long)n_head * hd, Lq,
                        hd, 1.f, o, [&](int i) { return ty + i * T::kGroups; });
}

template <int LP, int HD, bool VEC>
__global__ void __launch_bounds__(Tiles<LP, HD>::kThreads)
mha_short_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                      float* __restrict__ out, int Lq, int Lk, int hd, int n_head,
                      long long q_seq, long long q_row, long long k_seq, long long k_row,
                      long long v_seq, long long v_row, float scale) {
  using T = Tiles<LP, HD>;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + T::kOperand;
  float* const ps = qs;  // P, over q and k once the logits are formed
  constexpr int kFront = 2 * T::kOperand > LP * T::kPPitch ? 2 * T::kOperand : LP * T::kPPitch;
  float* const vs = qs + kFront;

  const int n = blockIdx.x / n_head, h = blockIdx.x % n_head;
  const long long col = (long long)h * hd;
  stage_bf16<LP, HD, VEC>(qs, q + n * q_seq + col, q_row, Lq, hd, true, scale);
  stage_bf16<LP, HD, VEC>(ks, k + n * k_seq + col, k_row, Lk, hd, false, 1.f);
  stage_bf16<LP, HD, VEC>(vs, v + n * v_seq + col, v_row, Lk, hd, false, 1.f);
  __syncthreads();

  float s[T::kRows][T::kKeys] = {};
  logits<LP, HD>(qs, ks, s);
#pragma unroll
  for (int i = 0; i < T::kRows; ++i)
#pragma unroll
    for (int j = 0; j < T::kKeys; ++j) s[i][j] = tris::round_bf16(s[i][j]);
  softmax<LP, HD>(s, mask, Lq, Lk);
  __syncthreads();  // every thread's logits formed: P may overwrite q and k
  put_probs<LP, HD>(ps, s);
  __syncthreads();

  float4 o[T::kRows][T::kChan4] = {};
  rows_by_keys<LP, HD>(ps, vs, (Lk + 3) / 4 * 4, o);
  const int ty = group_y();
  put_rows<LP, HD, VEC>(out + (long long)n * Lq * n_head * hd + col, (long long)n_head * hd, Lq,
                        hd, 1.f, o, [&](int i) { return ty + i * T::kGroups; });
}

}  // namespace

cudaError_t tris::mha_short_bf16(const Bf16Bits* q, const Bf16Bits* k, const Bf16Bits* v,
                                 const float* mask, float* out, int N, int Lq, int Lk, int hd,
                                 int n_head, int64_t q_seq, int64_t q_row, int64_t k_seq,
                                 int64_t k_row, int64_t v_seq, int64_t v_row, float scale,
                                 cudaStream_t stream, MhaLaunchShape* shape) {
  if (!mha_short_takes(Lq, Lk, hd, false) || mask == nullptr) return cudaErrorInvalidValue;
  const int lp = mha_short_len_bucket(Lq > Lk ? Lq : Lk, false), hdb = mha_short_hd_bucket(hd);
  // 16-byte loads: every pointer 16-byte aligned, hd and every stride a multiple of 8 values
  const bool vec = hd % 8 == 0 && q_seq % 8 == 0 && q_row % 8 == 0 && k_seq % 8 == 0 &&
                   k_row % 8 == 0 && v_seq % 8 == 0 && v_row % 8 == 0 &&
                   aligned16({q, k, v, out}, {}, 4);
  const cudaError_t err = dispatch<false>(lp, hdb, vec, [&](auto L, auto H, auto V) {
    constexpr int LP = decltype(L)::value, HD = decltype(H)::value;
    return launch(mha_short_bf16_kernel<LP, HD, decltype(V)::value>, LP, HD, decltype(V)::value,
                  false, N, n_head, stream, shape, reinterpret_cast<const __nv_bfloat16*>(q),
                  reinterpret_cast<const __nv_bfloat16*>(k),
                  reinterpret_cast<const __nv_bfloat16*>(v), mask, out, Lq, Lk, hd, n_head,
                  q_seq, q_row, k_seq, k_row, v_seq, v_row, scale);
  });
  if (err == cudaSuccess && shape != nullptr) shape->load_bytes = vec ? 16 : 2;
  return err;
}

cudaError_t tris::mha_short(const float* q, const float* k, const float* v, const float* mask,
                            float* out, int N, int Lq, int Lk, int hd, int n_head,
                            int64_t q_seq, int64_t q_row, int64_t k_seq, int64_t k_row,
                            int64_t v_seq, int64_t v_row, float scale, cudaStream_t stream,
                            MhaLaunchShape* shape) {
  if (!mha_short_takes(Lq, Lk, hd, false)) return cudaErrorInvalidValue;
  const int lp = mha_short_len_bucket(Lq > Lk ? Lq : Lk, false), hdb = mha_short_hd_bucket(hd);
  const bool vec = aligned16({q, k, v, out}, {q_seq, q_row, k_seq, k_row, v_seq, v_row}, hd);
  return dispatch<false>(lp, hdb, vec, [&](auto L, auto H, auto V) {
    constexpr int LP = decltype(L)::value, HD = decltype(H)::value;
    static_assert(mha_short_smem(LP, HD, false) ==
                      4LL * ((2 * Tiles<LP, HD>::kOperand > LP * Tiles<LP, HD>::kPPitch
                                  ? 2 * Tiles<LP, HD>::kOperand
                                  : LP * Tiles<LP, HD>::kPPitch) +
                             Tiles<LP, HD>::kOperand),
                  "launchers.h's shared memory is the kernel's layout");
    return launch(mha_short_kernel<LP, HD, decltype(V)::value>, LP, HD, decltype(V)::value, false,
                  N, n_head, stream, shape, q, k, v, mask, out, Lq, Lk, hd, n_head, q_seq, q_row,
                  k_seq, k_row, v_seq, v_row, scale);
  });
}
