// K1 backward: short-sequence multi-head attention, float32.
//
// The gradient of tris_tpu/models/layers.py::multi_head_attention (lines
// 25-48), which the JAX package takes by autodiff of its XLA program: with
// P = softmax((q * s) . k^T + mask) per (sequence, head), s = hd^-1/2,
//   dP = dO . V^T,  D_i = sum_j P_ij dP_ij,  dS = P * (dP - D),
//   dq = s * dS . K,  dk = dS^T . (q * s),  dv = P^T . dO.
// D_i uses P and dP, so the forward's output is not needed, and P is formed
// again from q and k rather than saved.
//
// Shapes on the stage-1 train path: the stage-1 text tower (N = 48, L = 20
// causal, 8 heads) and the frozen ViT-B/32 critic's vision tower (N = 48,
// L = 50, 12 heads), hd = 64; 24 launches per step. The critic's text tower
// runs without autograd and never reaches this kernel.
//
// Bound: bytes - q, k, v, dO read once and dq, dk, dv written once (0.0154
// ms for the ViT at N = 48) - with the five L^2 hd products close behind
// (0.0110 ms of FFMA). Design (mha_short_tiles.cuh): a block per (sequence,
// head), the forward's staging and register tiles (the length buckets
// without 56: the products over keys take a thread's 4 keys as one float4).
// P is formed again in registers and goes to shared memory; dV = P^T dO;
// dP = dO V^T in the logits' layout, D by three shuffles a row, and
// dS = P (dP - D) is written over P; then dK = dS^T (q s) and dQ = s dS K.
// No operand is read from device memory inside a product. Three operands
// are held at once (q, dO, and k, then v, then k again), so three blocks fit
// on an SM at the ViT's shape: v is staged while dV is formed and k again
// while dK is; where three do not fit beside P (lp = hd = 128), two (q and k,
// then dO and v, then q and k). A -inf mask entry gives P = 0 and dS = 0
// exactly. Every output element is summed by one thread in a fixed order:
// the result does not change from run to run.

#include "mha_short_tiles.cuh"

namespace {

using namespace tris::mha;

// A float32 [rows, hd] operand (row stride `row`) into a [LP][kPitch] tile by plain loads,
// zeros past rows and hd (the bfloat16 kernel's dO).
template <int LP, int HD>
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src, long long row,
                                          int rows, int hd) {
  using T = Tiles<LP, HD>;
  for (int i = threadIdx.x; i < LP * HD; i += T::kThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * T::kPitch + c] = r < rows && c < hd ? src[r * row + c] : 0.f;
  }
}

// acc[i][g] rounded to bfloat16 to dst rows (the tile's row i, below nrows) of a [rows, C]
// bfloat16 output, channels 4 tx + 32 g ..+3 below hd; with post != 1 (dq) the rounded sum
// is then multiplied by post and rounded again, as the JAX function's bfloat16 ops round.
template <int LP, int HD, class RowOf>
__device__ __forceinline__ void put_rows_bf16(__nv_bfloat16* __restrict__ dst, long long C,
                                              int nrows, int hd, float post,
                                              const Acc<LP, HD>& acc, RowOf row_of) {
  using T = Tiles<LP, HD>;
#pragma unroll
  for (int i = 0; i < T::kRows; ++i) {
    const int r = row_of(i);
    if (r >= nrows) continue;
#pragma unroll
    for (int g = 0; g < T::kChan4; ++g) {
      const int c = 4 * lane_x() + 4 * kLanes * g;
      const float v[4] = {acc[i][g].x, acc[i][g].y, acc[i][g].z, acc[i][g].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e >= hd) break;
        float t = tris::round_bf16(v[e]);
        if (post != 1.f) t = tris::round_bf16(t * post);
        dst[r * C + c + e] = __float2bfloat16_rn(t);
      }
    }
  }
}

template <int LP, int HD, bool VEC, int BUFS>
__global__ void __launch_bounds__(Tiles<LP, HD>::kThreads)
mha_short_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk, int hd,
                     int n_head, long long q_seq, long long q_row, long long k_seq,
                     long long k_row, long long v_seq, long long v_row, float scale) {
  static_assert(BUFS == 2 || BUFS == 3, "two or three staged operands");
  using T = Tiles<LP, HD>;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + T::kOperand;  // k, then v, then k again
  float* const vs = ks;
  float* const gs = BUFS == 3 ? ks + T::kOperand : qs;  // dO
  float* const ps = qs + BUFS * T::kOperand;            // P, then dS in its place

  const int n = blockIdx.x / n_head, h = blockIdx.x % n_head, ty = group_y();
  const long long col = (long long)h * hd, C = (long long)n_head * hd;
  const float* const qb = q + n * q_seq + col;
  const float* const kb = k + n * k_seq + col;
  const float* const vb = v + n * v_seq + col;
  const float* const gb = dout + (long long)n * Lq * C + col;

  stage<LP, HD, VEC>(qs, qb, q_row, Lq, hd);
  stage<LP, HD, VEC>(ks, kb, k_row, Lk, hd);
  if constexpr (BUFS == 3) {
    tris::cp_async_commit();
    stage<LP, HD, VEC>(gs, gb, C, Lq, hd);  // dO lands while P is formed
    staged<LP, HD, 1>(qs, scale);
  } else {
    staged<LP, HD>(qs, scale);
  }
  __syncthreads();

  {  // P, as the forward forms it
    float s[T::kRows][T::kKeys] = {};
    logits<LP, HD>(qs, ks, s);
    softmax<LP, HD>(s, mask, Lq, Lk);
    __syncthreads();  // every thread's logits formed: v may overwrite k (with two, dO q)
    stage<LP, HD, VEC>(vs, vb, v_row, Lk, hd);
    if constexpr (BUFS == 2) stage<LP, HD, VEC>(gs, gb, C, Lq, hd);
    put_probs<LP, HD>(ps, s);
  }
  staged<LP, HD, BUFS == 3 ? 1 : 0>(nullptr, 1.f);  // dO landed; with three, v may be landing
  __syncthreads();

  const auto key_of = [&](int i) { return T::kRows * ty + i; };
  const auto row_of = [&](int i) { return ty + i * T::kGroups; };
  {  // dV = P^T dO, while v lands
    float4 acc[T::kRows][T::kChan4] = {};
    keys_by_rows<LP, HD>(ps, gs, Lq, acc);
    put_rows<LP, HD, VEC>(dv + (long long)n * Lk * C + col, C, Lk, hd, 1.f, acc, key_of);
  }
  tris::cp_async_wait<0>();
  __syncthreads();  // v landed, and dV's reads of P done: dS may overwrite P

  {  // dP = dO V^T in the logits' layout, D, and dS = P (dP - D) over P
    float ds[T::kRows][T::kKeys] = {};
    logits<LP, HD>(gs, vs, ds);
#pragma unroll
    for (int i = 0; i < T::kRows; ++i) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < T::kKeys; ++j) d = fmaf(get_prob<LP, HD>(ps, i, j), ds[i][j], d);
      d = lanes_sum(d);
#pragma unroll
      for (int j = 0; j < T::kKeys; ++j) ds[i][j] = get_prob<LP, HD>(ps, i, j) * (ds[i][j] - d);
    }
    put_probs<LP, HD>(ps, ds);
  }
  __syncthreads();  // dS written, dP's reads of v and dO done: k may overwrite v
  stage<LP, HD, VEC>(ks, kb, k_row, Lk, hd);
  if constexpr (BUFS == 2) {
    stage<LP, HD, VEC>(qs, qb, q_row, Lq, hd);
    staged<LP, HD>(qs, scale);
    __syncthreads();
  } else {
    tris::cp_async_commit();
  }

  {  // dK = dS^T (q s), while k lands (with three)
    float4 acc[T::kRows][T::kChan4] = {};
    keys_by_rows<LP, HD>(ps, qs, Lq, acc);
    put_rows<LP, HD, VEC>(dk + (long long)n * Lk * C + col, C, Lk, hd, 1.f, acc, key_of);
  }
  if constexpr (BUFS == 3) {
    tris::cp_async_wait<0>();
    __syncthreads();
  }
  {  // dQ = s dS K
    float4 acc[T::kRows][T::kChan4] = {};
    rows_by_keys<LP, HD>(ps, ks, (Lk + 3) / 4 * 4, acc);
    put_rows<LP, HD, VEC>(dq + (long long)n * Lq * C + col, C, Lq, hd, scale, acc, row_of);
  }
}

// The backward on bfloat16 q, k and v with the float32 mask and dO (--bf16, the text tower on
// bfloat16 leaves), the float32 kernel's design with the operands staged by plain loads and
// widened: q s and the logits rounded to bfloat16 as the forward rounds them, P in float32;
// dV = P^T dO summed in float32 and rounded once; dP, D and dS in float32, dS rounded to
// bfloat16 before its products; dK = dS^T (q s) and dS K rounded, dQ = bfloat16(dS K) s rounded.
template <int LP, int HD, bool VEC, int BUFS>
__global__ void __launch_bounds__(Tiles<LP, HD>::kThreads)
mha_short_bwd_bf16_kernel(const float* __restrict__ dout, const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                          __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int hd, int n_head,
                          long long q_seq, long long q_row, long long k_seq, long long k_row,
                          long long v_seq, long long v_row, float scale) {
  static_assert(BUFS == 2 || BUFS == 3, "two or three staged operands");
  using T = Tiles<LP, HD>;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + T::kOperand;  // k, then v, then k again
  float* const vs = ks;
  float* const gs = BUFS == 3 ? ks + T::kOperand : qs;  // dO (with two, over q)
  float* const ps = qs + BUFS * T::kOperand;            // P, then dS in its place

  const int n = blockIdx.x / n_head, h = blockIdx.x % n_head, ty = group_y();
  const long long col = (long long)h * hd, C = (long long)n_head * hd;
  const __nv_bfloat16* const qb = q + n * q_seq + col;
  const __nv_bfloat16* const kb = k + n * k_seq + col;
  const __nv_bfloat16* const vb = v + n * v_seq + col;
  const float* const gb = dout + (long long)n * Lq * C + col;

  stage_bf16<LP, HD, VEC>(qs, qb, q_row, Lq, hd, true, scale);
  stage_bf16<LP, HD, VEC>(ks, kb, k_row, Lk, hd, false, 1.f);
  if constexpr (BUFS == 3) stage_f32<LP, HD>(gs, gb, C, Lq, hd);
  __syncthreads();

  {  // P, as the forward forms it
    float s[T::kRows][T::kKeys] = {};
    logits<LP, HD>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < T::kRows; ++i)
#pragma unroll
      for (int j = 0; j < T::kKeys; ++j) s[i][j] = tris::round_bf16(s[i][j]);
    softmax<LP, HD>(s, mask, Lq, Lk);
    __syncthreads();  // every thread's logits formed: v may overwrite k (with two, dO q)
    stage_bf16<LP, HD, VEC>(vs, vb, v_row, Lk, hd, false, 1.f);
    if constexpr (BUFS == 2) stage_f32<LP, HD>(gs, gb, C, Lq, hd);
    put_probs<LP, HD>(ps, s);
  }
  __syncthreads();

  const auto key_of = [&](int i) { return T::kRows * ty + i; };
  const auto row_of = [&](int i) { return ty + i * T::kGroups; };
  {  // dV = P^T dO
    float4 acc[T::kRows][T::kChan4] = {};
    keys_by_rows<LP, HD>(ps, gs, Lq, acc);
    put_rows_bf16<LP, HD>(dv + (long long)n * Lk * C + col, C, Lk, hd, 1.f, acc, key_of);
  }
  __syncthreads();  // dV's reads of P done: dS may overwrite P

  {  // dP = dO V^T in the logits' layout, D, and dS = P (dP - D) over P, rounded
    float ds[T::kRows][T::kKeys] = {};
    logits<LP, HD>(gs, vs, ds);
#pragma unroll
    for (int i = 0; i < T::kRows; ++i) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < T::kKeys; ++j) d = fmaf(get_prob<LP, HD>(ps, i, j), ds[i][j], d);
      d = lanes_sum(d);
#pragma unroll
      for (int j = 0; j < T::kKeys; ++j)
        ds[i][j] = tris::round_bf16(get_prob<LP, HD>(ps, i, j) * (ds[i][j] - d));
    }
    put_probs<LP, HD>(ps, ds);
  }
  __syncthreads();  // dS written, dP's reads of v and dO done: k may overwrite v
  stage_bf16<LP, HD, VEC>(ks, kb, k_row, Lk, hd, false, 1.f);
  if constexpr (BUFS == 2) stage_bf16<LP, HD, VEC>(qs, qb, q_row, Lq, hd, true, scale);
  __syncthreads();

  {  // dK = dS^T (q s)
    float4 acc[T::kRows][T::kChan4] = {};
    keys_by_rows<LP, HD>(ps, qs, Lq, acc);
    put_rows_bf16<LP, HD>(dk + (long long)n * Lk * C + col, C, Lk, hd, 1.f, acc, key_of);
  }
  {  // dQ = bfloat16(dS K) s
    float4 acc[T::kRows][T::kChan4] = {};
    rows_by_keys<LP, HD>(ps, ks, (Lk + 3) / 4 * 4, acc);
    put_rows_bf16<LP, HD>(dq + (long long)n * Lq * C + col, C, Lq, hd, scale, acc, row_of);
  }
}

}  // namespace

cudaError_t tris::mha_short_bwd_bf16(const float* dout, const Bf16Bits* q, const Bf16Bits* k,
                                     const Bf16Bits* v, const float* mask, Bf16Bits* dq,
                                     Bf16Bits* dk, Bf16Bits* dv, int N, int Lq, int Lk, int hd,
                                     int n_head, int64_t q_seq, int64_t q_row, int64_t k_seq,
                                     int64_t k_row, int64_t v_seq, int64_t v_row, float scale,
                                     cudaStream_t stream, MhaLaunchShape* shape) {
  if (!mha_short_takes(Lq, Lk, hd, true) || mask == nullptr) return cudaErrorInvalidValue;
  const int lp = mha_short_len_bucket(Lq > Lk ? Lq : Lk, true), hdb = mha_short_hd_bucket(hd);
  // 16-byte loads of q, k and v: every pointer 16-byte aligned, hd and every stride a multiple
  // of 8 values
  const bool vec = hd % 8 == 0 && q_seq % 8 == 0 && q_row % 8 == 0 && k_seq % 8 == 0 &&
                   k_row % 8 == 0 && v_seq % 8 == 0 && v_row % 8 == 0 &&
                   aligned16({q, k, v}, {}, 4);
  using B = __nv_bfloat16;
  const cudaError_t err = dispatch<true>(lp, hdb, vec, [&](auto L, auto H, auto V) {
    constexpr int LP = decltype(L)::value, HD = decltype(H)::value;
    constexpr int kBufs = mha_short_bwd_buffers(LP, HD);
    return launch(mha_short_bwd_bf16_kernel<LP, HD, decltype(V)::value, kBufs>, LP, HD,
                  decltype(V)::value, true, N, n_head, stream, shape, dout,
                  reinterpret_cast<const B*>(q), reinterpret_cast<const B*>(k),
                  reinterpret_cast<const B*>(v), mask, reinterpret_cast<B*>(dq),
                  reinterpret_cast<B*>(dk), reinterpret_cast<B*>(dv), Lq, Lk, hd, n_head, q_seq,
                  q_row, k_seq, k_row, v_seq, v_row, scale);
  });
  if (err == cudaSuccess && shape != nullptr) shape->load_bytes = vec ? 16 : 2;
  return err;
}

cudaError_t tris::mha_short_bwd(const float* dout, const float* q, const float* k, const float* v,
                                const float* mask, float* dq, float* dk, float* dv, int N, int Lq,
                                int Lk, int hd, int n_head, int64_t q_seq, int64_t q_row,
                                int64_t k_seq, int64_t k_row, int64_t v_seq, int64_t v_row,
                                float scale, cudaStream_t stream, MhaLaunchShape* shape) {
  if (!mha_short_takes(Lq, Lk, hd, true)) return cudaErrorInvalidValue;
  const int lp = mha_short_len_bucket(Lq > Lk ? Lq : Lk, true), hdb = mha_short_hd_bucket(hd);
  const bool vec =
      aligned16({dout, q, k, v, dq, dk, dv}, {q_seq, q_row, k_seq, k_row, v_seq, v_row}, hd);
  return dispatch<true>(lp, hdb, vec, [&](auto L, auto H, auto V) {
    constexpr int LP = decltype(L)::value, HD = decltype(H)::value;
    constexpr int kBufs = mha_short_bwd_buffers(LP, HD);
    using T = Tiles<LP, HD>;
    static_assert(mha_short_smem(LP, HD, true) == 4LL * (kBufs * T::kOperand + LP * T::kPPitch),
                  "launchers.h's shared memory is the kernel's layout");
    return launch(mha_short_bwd_kernel<LP, HD, decltype(V)::value, kBufs>, LP, HD,
                  decltype(V)::value, true, N, n_head, stream, shape, dout, q, k, v, mask, dq, dk,
                  dv, Lq, Lk, hd, n_head, q_seq, q_row, k_seq, k_row, v_seq, v_row, scale);
  });
}
