// PyTorch bindings of the kernels in this directory, built by
// torch.utils.cpp_extension (../build.py). Each op checks where and how its
// tensors lie, allocates its outputs, launches on the current stream of its
// inputs' device and raises if the launch fails. Shapes are checked by the
// Python wrappers beside build.py, which are the only callers.

#include <algorithm>
#include <array>
#include <cstdint>
#include <map>
#include <optional>
#include <string>
#include <vector>

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

#include "launchers.h"

namespace {

// `t` lies on `device` with `dtype`, contiguous (or, with `rows`, with unit
// stride in its last dimension only).
void check(const at::Tensor& t, const char* what, at::ScalarType dtype,
           const at::Device& device, bool rows = false) {
  TORCH_CHECK(t.is_cuda() && t.device() == device, what, ": expected a tensor on ", device,
              ", got ", t.device());
  TORCH_CHECK(t.scalar_type() == dtype, what, ": expected ", dtype, ", got ", t.scalar_type());
  TORCH_CHECK(rows ? t.stride(-1) == 1 : t.is_contiguous(), what,
              rows ? ": expected unit stride in the last dimension" : ": expected contiguous");
}

// An interpolation table (lo, hi, w_lo, w_hi) as four pointers.
struct Taps {
  const int *lo, *hi;
  const float *w0, *w1;
};

Taps taps(const std::vector<at::Tensor>& t, const char* what, const at::Device& device) {
  TORCH_CHECK(t.size() == 4, what, ": expected (lo, hi, w_lo, w_hi)");
  check(t[0], what, at::kInt, device);
  check(t[1], what, at::kInt, device);
  check(t[2], what, at::kFloat, device);
  check(t[3], what, at::kFloat, device);
  return {t[0].data_ptr<int>(), t[1].data_ptr<int>(), t[2].data_ptr<float>(),
          t[3].data_ptr<float>()};
}

tris::TapArrays tap_arrays(const std::vector<at::Tensor>& t, const char* what,
                           const at::Device& device) {
  const Taps x = taps(t, what, device);
  return {x.lo, x.hi, x.w0, x.w1};
}

// A resize's adjoint ranges (lo_begin, lo_end, hi_begin, hi_end), int32.
tris::TapRanges tap_ranges(const std::vector<at::Tensor>& t, const char* what,
                           const at::Device& device) {
  TORCH_CHECK(t.size() == 4, what, ": expected (lo_begin, lo_end, hi_begin, hi_end)");
  for (const at::Tensor& r : t) check(r, what, at::kInt, device);
  return {t[0].data_ptr<int>(), t[1].data_ptr<int>(), t[2].data_ptr<int>(),
          t[3].data_ptr<int>()};
}

void launched(cudaError_t err, const char* name) {
  TORCH_CHECK(err == cudaSuccess, name, ": CUDA launch failed: ", cudaGetErrorString(err));
}

cudaStream_t stream() { return at::cuda::getCurrentCUDAStream().stream(); }

// The shape of the last launch of each of K1's, K2's and K11's kernels, as its launcher made it.
std::map<std::string, tris::MhaLaunchShape> k1_shapes;
std::map<std::string, tris::LaunchShape> k2_shapes;
std::map<std::string, tris::PixelAttnLaunchShape> k11_shapes;

template <typename T>
T* ptr(const std::optional<at::Tensor>& t) {
  return t ? t->data_ptr<T>() : nullptr;
}

// a bfloat16 tensor's data as the launchers take it (its bits)
const tris::Bf16Bits* bits(const at::Tensor& t) {
  return reinterpret_cast<const tris::Bf16Bits*>(t.data_ptr<at::BFloat16>());
}
tris::Bf16Bits* bits_out(at::Tensor& t) {
  return reinterpret_cast<tris::Bf16Bits*>(t.data_ptr<at::BFloat16>());
}

// K1: q, k, v [N, L, C] (rows may be strided, as column slices of one qkv
// tensor); mask [Lq, Lk] or None. Returns [N, Lq, C].
at::Tensor mha_short(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                     const std::optional<at::Tensor>& mask, int64_t n_head, double scale) {
  const at::Device dev = q.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(q, "mha_short: q", at::kFloat, dev, true);
  check(k, "mha_short: k", at::kFloat, dev, true);
  check(v, "mha_short: v", at::kFloat, dev, true);
  if (mask) check(*mask, "mha_short: mask", at::kFloat, dev);
  const int64_t N = q.size(0), Lq = q.size(1), C = q.size(2);
  at::Tensor out = at::empty({N, Lq, C}, q.options());
  launched(tris::mha_short(q.data_ptr<float>(), k.data_ptr<float>(), v.data_ptr<float>(),
                           ptr<float>(mask), out.data_ptr<float>(), N, Lq, k.size(1),
                           C / n_head, n_head, q.stride(0), q.stride(1), k.stride(0),
                           k.stride(1), v.stride(0), v.stride(1), (float)scale, stream(),
                           &k1_shapes["mha_short"]),
           "mha_short");
  return out;
}

// K1 on bfloat16 q, k, v [N, L, C] (rows may be strided) with a float32 mask [Lq, Lk]
// (--bf16): returns [N, Lq, C] float32.
at::Tensor mha_short_bf16(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                          const at::Tensor& mask, int64_t n_head, double scale) {
  const at::Device dev = q.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(q, "mha_short_bf16: q", at::kBFloat16, dev, true);
  check(k, "mha_short_bf16: k", at::kBFloat16, dev, true);
  check(v, "mha_short_bf16: v", at::kBFloat16, dev, true);
  check(mask, "mha_short_bf16: mask", at::kFloat, dev);
  const int64_t N = q.size(0), Lq = q.size(1), C = q.size(2);
  at::Tensor out = at::empty({N, Lq, C}, q.options().dtype(at::kFloat));
  launched(tris::mha_short_bf16(bits(q), bits(k), bits(v), mask.data_ptr<float>(),
                                out.data_ptr<float>(), N, Lq, k.size(1), C / n_head, n_head,
                                q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                                v.stride(1), (float)scale, stream(), &k1_shapes["mha_short_bf16"]),
           "mha_short_bf16");
  return out;
}

// K1 backward: dout [N, Lq, C] contiguous; q, k, v and mask as the forward.
// Returns (dq, dk, dv), each contiguous [N, L, C].
std::vector<at::Tensor> mha_short_bwd(const at::Tensor& dout, const at::Tensor& q,
                                      const at::Tensor& k, const at::Tensor& v,
                                      const std::optional<at::Tensor>& mask, int64_t n_head,
                                      double scale) {
  const at::Device dev = q.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(dout, "mha_short_bwd: dout", at::kFloat, dev);
  check(q, "mha_short_bwd: q", at::kFloat, dev, true);
  check(k, "mha_short_bwd: k", at::kFloat, dev, true);
  check(v, "mha_short_bwd: v", at::kFloat, dev, true);
  if (mask) check(*mask, "mha_short_bwd: mask", at::kFloat, dev);
  const int64_t N = q.size(0), Lq = q.size(1), Lk = k.size(1), C = q.size(2);
  at::Tensor dq = at::empty({N, Lq, C}, q.options());
  at::Tensor dk = at::empty({N, Lk, C}, q.options());
  at::Tensor dv = at::empty({N, Lk, C}, q.options());
  launched(tris::mha_short_bwd(dout.data_ptr<float>(), q.data_ptr<float>(), k.data_ptr<float>(),
                               v.data_ptr<float>(), ptr<float>(mask), dq.data_ptr<float>(),
                               dk.data_ptr<float>(), dv.data_ptr<float>(), N, Lq, Lk, C / n_head,
                               n_head, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                               v.stride(0), v.stride(1), (float)scale, stream(),
                               &k1_shapes["mha_short_bwd"]),
           "mha_short_bwd");
  return {dq, dk, dv};
}

// K1 backward on bfloat16 q, k, v (rows may be strided) with the float32 mask and dout
// [N, Lq, C] (--bf16). Returns (dq, dk, dv) bfloat16, each contiguous [N, L, C].
std::vector<at::Tensor> mha_short_bwd_bf16(const at::Tensor& dout, const at::Tensor& q,
                                           const at::Tensor& k, const at::Tensor& v,
                                           const at::Tensor& mask, int64_t n_head, double scale) {
  const at::Device dev = q.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(dout, "mha_short_bwd_bf16: dout", at::kFloat, dev);
  check(q, "mha_short_bwd_bf16: q", at::kBFloat16, dev, true);
  check(k, "mha_short_bwd_bf16: k", at::kBFloat16, dev, true);
  check(v, "mha_short_bwd_bf16: v", at::kBFloat16, dev, true);
  check(mask, "mha_short_bwd_bf16: mask", at::kFloat, dev);
  const int64_t N = q.size(0), Lq = q.size(1), Lk = k.size(1), C = q.size(2);
  at::Tensor dq = at::empty({N, Lq, C}, q.options());
  at::Tensor dk = at::empty({N, Lk, C}, q.options());
  at::Tensor dv = at::empty({N, Lk, C}, q.options());
  launched(tris::mha_short_bwd_bf16(dout.data_ptr<float>(), bits(q), bits(k), bits(v),
                                    mask.data_ptr<float>(), bits_out(dq), bits_out(dk),
                                    bits_out(dv), N, Lq, Lk, C / n_head, n_head, q.stride(0),
                                    q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                                    v.stride(1), (float)scale, stream(),
                                    &k1_shapes["mha_short_bwd_bf16"]),
           "mha_short_bwd_bf16");
  return {dq, dk, dv};
}

// Whether K1's kernels take (Lq, Lk, hd), forward or (with backward) both (launchers.h).
bool mha_short_takes(int64_t Lq, int64_t Lk, int64_t hd, bool backward) {
  return Lq <= INT32_MAX && Lk <= INT32_MAX && hd <= INT32_MAX &&
         tris::mha_short_takes((int)Lq, (int)Lk, (int)hd, backward);
}

// The last launch of K1's `name` (mha_short, mha_short_bwd) in this process: blocks,
// threads a block, bytes of shared memory a block, the length and head-dim buckets and
// the bytes of each global load.
std::map<std::string, int64_t> mha_short_launch_shape(const std::string& name) {
  const auto it = k1_shapes.find(name);
  TORCH_CHECK(it != k1_shapes.end(), "mha_short_launch_shape: no launch of ", name);
  const tris::MhaLaunchShape& s = it->second;
  return {{"blocks", s.blocks}, {"threads", s.threads}, {"smem_bytes", s.smem},
          {"lp", s.lp}, {"hd_bucket", s.hd_bucket}, {"load_bytes", s.load_bytes}};
}

// K2: qv, kv, vv [N, HW, m]; qt, kt, vt [N*S, T, m]. Returns (new_vis
// [N*S, HW, m], new_lan [N*S, T, m]) and, with save_p, the probabilities for
// the backward (pv [N*S, HW, T], pt [N, S*T, HW]).
std::vector<at::Tensor> cross_attn(const at::Tensor& qv, const at::Tensor& kv,
                                   const at::Tensor& vv, const at::Tensor& qt,
                                   const at::Tensor& kt, const at::Tensor& vt, int64_t S,
                                   double div, bool save_p) {
  const at::Device dev = qv.device();
  const c10::cuda::CUDAGuard guard(dev);
  for (const at::Tensor* t : {&qv, &kv, &vv, &qt, &kt, &vt})
    check(*t, "cross_attn", at::kFloat, dev);
  const int64_t N = qv.size(0), HW = qv.size(1), m = qv.size(2), P = qt.size(0), T = qt.size(1);
  at::Tensor new_vis = at::empty({P, HW, m}, qv.options());
  at::Tensor new_lan = at::empty({P, T, m}, qv.options());
  std::vector<at::Tensor> out = {new_vis, new_lan};
  if (save_p) {
    out.push_back(at::empty({P, HW, T}, qv.options()));
    out.push_back(at::empty({N, P / N * T, HW}, qv.options()));
  }
  launched(tris::cross_attn(qv.data_ptr<float>(), kv.data_ptr<float>(), vv.data_ptr<float>(),
                            qt.data_ptr<float>(), kt.data_ptr<float>(), vt.data_ptr<float>(),
                            new_vis.data_ptr<float>(), new_lan.data_ptr<float>(),
                            save_p ? out[2].data_ptr<float>() : nullptr,
                            save_p ? out[3].data_ptr<float>() : nullptr, P, HW, T, m, S,
                            (float)div, stream(), &k2_shapes["cross_attn"]),
           "cross_attn");
  return out;
}

// K2 backward at S = 1: g_vis [N, HW, m], g_lan [N, T, m], the forward's
// inputs and its probabilities pv [N, HW, T], pt [N, T, HW]. Returns (dqv,
// dkv, dvv, dqt, dkt, dvt).
std::vector<at::Tensor> cross_attn_bwd(const at::Tensor& g_vis, const at::Tensor& g_lan,
                                       const at::Tensor& qv, const at::Tensor& kv,
                                       const at::Tensor& vv, const at::Tensor& qt,
                                       const at::Tensor& kt, const at::Tensor& vt,
                                       const at::Tensor& pv, const at::Tensor& pt, double div) {
  const at::Device dev = qv.device();
  const c10::cuda::CUDAGuard guard(dev);
  for (const at::Tensor* t : {&g_vis, &g_lan, &qv, &kv, &vv, &qt, &kt, &vt, &pv, &pt})
    check(*t, "cross_attn_bwd", at::kFloat, dev);
  const int64_t N = qv.size(0), HW = qv.size(1), m = qv.size(2), T = qt.size(1);
  TORCH_CHECK(qt.size(0) == N, "cross_attn_bwd: one sentence per image");
  TORCH_CHECK(pv.numel() == N * HW * T && pt.numel() == N * T * HW,
              "cross_attn_bwd: the forward's probabilities");
  at::Tensor dlv = at::empty({N, HW, T}, qv.options()), dlt = at::empty({N, T, HW}, qv.options());
  std::vector<at::Tensor> out;
  for (const at::Tensor* t : {&qv, &kv, &vv, &qt, &kt, &vt}) out.push_back(at::empty_like(*t));
  tris::LaunchShape shapes[2] = {};
  launched(tris::cross_attn_bwd(
               g_vis.data_ptr<float>(), g_lan.data_ptr<float>(), qv.data_ptr<float>(),
               kv.data_ptr<float>(), vv.data_ptr<float>(), qt.data_ptr<float>(),
               kt.data_ptr<float>(), vt.data_ptr<float>(), pv.data_ptr<float>(),
               pt.data_ptr<float>(), dlv.data_ptr<float>(), dlt.data_ptr<float>(),
               out[0].data_ptr<float>(), out[1].data_ptr<float>(), out[2].data_ptr<float>(),
               out[3].data_ptr<float>(), out[4].data_ptr<float>(), out[5].data_ptr<float>(), N,
               HW, T, m, (float)div, stream(), shapes),
           "cross_attn_bwd");
  k2_shapes["cross_attn_bwd_a"] = shapes[0];
  k2_shapes["cross_attn_bwd_b"] = shapes[1];
  return out;
}

// Whether K2's kernels take channel width m (launchers.h).
bool cross_attn_takes(int64_t m) { return m <= INT32_MAX && tris::cross_attn_takes((int)m); }

// The last launch of K2's `name` (cross_attn, cross_attn_bwd_a, cross_attn_bwd_b) in this
// process: blocks, blocks a cluster, threads a block, query rows a tile, bytes of shared
// memory a block.
std::map<std::string, int64_t> cross_attn_launch_shape(const std::string& name) {
  const auto it = k2_shapes.find(name);
  TORCH_CHECK(it != k2_shapes.end(), "cross_attn_launch_shape: no launch of ", name);
  const tris::LaunchShape& s = it->second;
  return {{"blocks", s.blocks}, {"cluster", s.cluster}, {"threads", s.threads},
          {"tile_rows", s.rows}, {"smem_bytes", s.smem}};
}

// K3: vis_new [N*S, h*w, D] or None; vis_base [N, h*w, D]; lan [N*S, D];
// scale a 0-d tensor; ty, tx the taps to [H] rows and [W] columns.
// Returns [N*S, H, W].
tris::ResponseHeadLaunchShape k3_shape;
bool k3_launched = false;

// K2 on bfloat16 text projections (--bf16): the vision ones float32 (outputs float32) or
// bfloat16 (outputs bfloat16), as cross_attn's shapes; returns (new_vis, new_lan) and, with
// save_p, the probabilities for the backward (float32, as cross_attn's).
std::vector<at::Tensor> cross_attn_bf16(const at::Tensor& qv, const at::Tensor& kv,
                                        const at::Tensor& vv, const at::Tensor& qt,
                                        const at::Tensor& kt, const at::Tensor& vt, int64_t S,
                                        double div, bool save_p) {
  const at::Device dev = qv.device();
  const c10::cuda::CUDAGuard guard(dev);
  const bool vis_bf16 = qv.scalar_type() == at::kBFloat16;
  for (const at::Tensor* t : {&qv, &kv, &vv})
    check(*t, "cross_attn_bf16: vision", vis_bf16 ? at::kBFloat16 : at::kFloat, dev);
  for (const at::Tensor* t : {&qt, &kt, &vt}) check(*t, "cross_attn_bf16: text", at::kBFloat16, dev);
  const int64_t N = qv.size(0), HW = qv.size(1), m = qv.size(2), P = qt.size(0), T = qt.size(1);
  at::Tensor new_vis = at::empty({P, HW, m}, qv.options());
  at::Tensor new_lan = at::empty({P, T, m}, qv.options());
  std::vector<at::Tensor> out = {new_vis, new_lan};
  if (save_p) {
    const at::TensorOptions f = qv.options().dtype(at::kFloat);
    out.push_back(at::empty({P, HW, T}, f));
    out.push_back(at::empty({N, P / N * T, HW}, f));
  }
  launched(tris::cross_attn_bf16(qv.data_ptr(), kv.data_ptr(), vv.data_ptr(), bits(qt),
                                 bits(kt), bits(vt), new_vis.data_ptr(), new_lan.data_ptr(),
                                 save_p ? out[2].data_ptr<float>() : nullptr,
                                 save_p ? out[3].data_ptr<float>() : nullptr, vis_bf16, P, HW, T,
                                 m, S, (float)div, stream(), &k2_shapes["cross_attn_bf16"]),
           "cross_attn_bf16");
  return out;
}

// K2 backward on cross_attn_bf16's operands at S = 1 (--bf16): g_vis and g_lan in the
// outputs' dtype, pv and pt float32 as its save_p wrote them. Returns (dqv, dkv, dvv, dqt,
// dkt, dvt), each in its operand's dtype.
std::vector<at::Tensor> cross_attn_bwd_bf16(const at::Tensor& g_vis, const at::Tensor& g_lan,
                                            const at::Tensor& qv, const at::Tensor& kv,
                                            const at::Tensor& vv, const at::Tensor& qt,
                                            const at::Tensor& kt, const at::Tensor& vt,
                                            const at::Tensor& pv, const at::Tensor& pt,
                                            double div) {
  const at::Device dev = qv.device();
  const c10::cuda::CUDAGuard guard(dev);
  const bool vis_bf16 = qv.scalar_type() == at::kBFloat16;
  const at::ScalarType vis_type = vis_bf16 ? at::kBFloat16 : at::kFloat;
  for (const at::Tensor* t : {&g_vis, &g_lan, &qv, &kv, &vv})
    check(*t, "cross_attn_bwd_bf16: vision and cotangents", vis_type, dev);
  for (const at::Tensor* t : {&qt, &kt, &vt})
    check(*t, "cross_attn_bwd_bf16: text", at::kBFloat16, dev);
  check(pv, "cross_attn_bwd_bf16: pv", at::kFloat, dev);
  check(pt, "cross_attn_bwd_bf16: pt", at::kFloat, dev);
  const int64_t N = qv.size(0), HW = qv.size(1), m = qv.size(2), T = qt.size(1);
  TORCH_CHECK(qt.size(0) == N, "cross_attn_bwd_bf16: one sentence per image");
  at::Tensor dlv = at::empty({N, HW, T}, pv.options()), dlt = at::empty({N, T, HW}, pv.options());
  at::Tensor dqv = at::empty_like(qv), dkv = at::empty_like(kv), dvv = at::empty_like(vv);
  at::Tensor dqt = at::empty_like(qt), dkt = at::empty_like(kt), dvt = at::empty_like(vt);
  tris::LaunchShape shapes[2] = {};
  launched(tris::cross_attn_bwd_bf16(g_vis.data_ptr(), g_lan.data_ptr(), qv.data_ptr(),
                                     kv.data_ptr(), vv.data_ptr(), bits(qt), bits(kt), bits(vt),
                                     pv.data_ptr<float>(), pt.data_ptr<float>(),
                                     dlv.data_ptr<float>(), dlt.data_ptr<float>(), dqv.data_ptr(),
                                     dkv.data_ptr(), dvv.data_ptr(), bits_out(dqt),
                                     bits_out(dkt), bits_out(dvt), vis_bf16, N, HW, T, m,
                                     (float)div, stream(), shapes),
           "cross_attn_bwd_bf16");
  k2_shapes["cross_attn_bwd_bf16_a"] = shapes[0];
  k2_shapes["cross_attn_bwd_bf16_b"] = shapes[1];
  return {dqv, dkv, dvv, dqt, dkt, dvt};
}

at::Tensor response_head(const std::optional<at::Tensor>& vis_new, const at::Tensor& vis_base,
                         const at::Tensor& lan, const at::Tensor& scale,
                         const std::vector<at::Tensor>& ty, const std::vector<at::Tensor>& tx,
                         int64_t S, int64_t h, int64_t w, double alpha) {
  const at::Device dev = vis_base.device();
  const c10::cuda::CUDAGuard guard(dev);
  if (vis_new) check(*vis_new, "response_head: vis_new", at::kFloat, dev);
  check(vis_base, "response_head: vis_base", at::kFloat, dev);
  check(lan, "response_head: lan", at::kFloat, dev);
  check(scale, "response_head: scale", at::kFloat, dev);
  const Taps y = taps(ty, "response_head: row taps", dev);
  const Taps x = taps(tx, "response_head: column taps", dev);
  const int64_t P = lan.size(0), D = vis_base.size(2), H = ty[0].size(0), W = tx[0].size(0);
  at::Tensor out = at::empty({P, H, W}, vis_base.options());
  launched(tris::response_head(ptr<float>(vis_new), vis_base.data_ptr<float>(),
                               lan.data_ptr<float>(), out.data_ptr<float>(), P, S, h, w, D, H, W,
                               (float)alpha, scale.data_ptr<float>(), y.lo, y.hi, y.w0, y.w1,
                               x.lo, x.hi, x.w0, x.w1, stream(), &k3_shape),
           "response_head");
  k3_launched = true;
  return out;
}

// K3's eval head on bfloat16 vis_base and lan (--bf16), vis_new float32, bfloat16 or None;
// returns [P, H, W] float32.
at::Tensor response_head_bf16(const std::optional<at::Tensor>& vis_new,
                              const at::Tensor& vis_base, const at::Tensor& lan,
                              const at::Tensor& scale, const std::vector<at::Tensor>& ty,
                              const std::vector<at::Tensor>& tx, int64_t S, int64_t h, int64_t w,
                              double alpha) {
  const at::Device dev = vis_base.device();
  const c10::cuda::CUDAGuard guard(dev);
  const bool new_f32 = vis_new && vis_new->scalar_type() == at::kFloat;
  if (vis_new)
    check(*vis_new, "response_head_bf16: vis_new", new_f32 ? at::kFloat : at::kBFloat16, dev);
  check(vis_base, "response_head_bf16: vis_base", at::kBFloat16, dev);
  check(lan, "response_head_bf16: lan", at::kBFloat16, dev);
  check(scale, "response_head_bf16: scale", at::kFloat, dev);
  const Taps y = taps(ty, "response_head_bf16: row taps", dev);
  const Taps x = taps(tx, "response_head_bf16: column taps", dev);
  const int64_t P = lan.size(0), D = vis_base.size(2), H = ty[0].size(0), W = tx[0].size(0);
  at::Tensor out = at::empty({P, H, W}, vis_base.options().dtype(at::kFloat));
  launched(tris::response_head_bf16(vis_new ? vis_new->data_ptr() : nullptr, new_f32,
                                    bits(vis_base), bits(lan), out.data_ptr<float>(), P, S, h, w,
                                    D, H, W, (float)alpha, scale.data_ptr<float>(), y.lo, y.hi,
                                    y.w0, y.w1, x.lo, x.hi, x.w0, x.w1, stream(), &k3_shape),
           "response_head_bf16");
  k3_launched = true;
  return out;
}

// K3's plan (launchers.h, response_head_plan): ranks, threads, pixels, band_rows, vec, blocks
// and smem_bytes.
std::map<std::string, int64_t> response_head_plan(int64_t P, int64_t S, int64_t h, int64_t w,
                                                  int64_t D, int64_t H, int64_t W) {
  TORCH_CHECK(P >= 0 && P <= 65535 && S > 0 && h > 0 && w > 0 && D > 0 && H > 0 && W > 0 &&
                  h * w < INT32_MAX && H * W < INT32_MAX && D < INT32_MAX,
              "response_head_plan: shape out of range");
  const tris::ResponseHeadPlan p =
      tris::response_head_plan(P, (int)S, (int)h, (int)w, (int)D, (int)H, (int)W);
  return {{"ranks", p.ranks}, {"threads", p.threads}, {"pixels", p.pixels},
          {"band_rows", p.band_rows}, {"vec", p.vec}, {"blocks", p.blocks},
          {"smem_bytes", p.smem}};
}

// K3's last launch in this process: blocks, blocks a cluster, threads a block, columns a thread
// and bytes of shared memory a block.
std::map<std::string, int64_t> response_head_launch_shape() {
  TORCH_CHECK(k3_launched, "response_head_launch_shape: no launch of response_head");
  const tris::ResponseHeadLaunchShape& s = k3_shape;
  return {{"blocks", s.blocks}, {"cluster", s.cluster}, {"threads", s.threads},
          {"vec", s.vec}, {"smem_bytes", s.smem}};
}

// K3, training head: vis_p [B, h*w, D]; lan_p [B, T, D], image b's own text b + offset;
// scale a 0-d tensor; ty, tx the taps to [H] rows and [W] columns. Returns (score [B, h*w,
// T], stats [B, 2 (h*w + T)] (both for the backward), cls_out [B, T], cls_fg [B],
// relu_map [B, H, W], sig_map [B, H, W]).
tris::Stage1HeadLaunchShape k3_train_shapes[2];
bool k3_train_launched[2] = {false, false};

std::vector<at::Tensor> stage1_head(const at::Tensor& vis_p, const at::Tensor& lan_p,
                                    const at::Tensor& scale, const std::vector<at::Tensor>& ty,
                                    const std::vector<at::Tensor>& tx, int64_t h, int64_t w,
                                    double focal_p, double focal_c, int64_t offset) {
  const at::Device dev = vis_p.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(vis_p, "stage1_head: vis_p", at::kFloat, dev);
  check(lan_p, "stage1_head: lan_p", at::kFloat, dev);
  check(scale, "stage1_head: scale", at::kFloat, dev);
  const tris::TapArrays y = tap_arrays(ty, "stage1_head: row taps", dev);
  const tris::TapArrays x = tap_arrays(tx, "stage1_head: column taps", dev);
  const int64_t B = vis_p.size(0), T = lan_p.size(1), D = vis_p.size(2), H = ty[0].size(0),
                W = tx[0].size(0);
  TORCH_CHECK(offset >= 0 && B + offset <= T, "stage1_head: the own texts [offset, offset + B) ",
              "must lie in the T texts");
  const at::TensorOptions o = vis_p.options();
  at::Tensor score = at::empty({B, h * w, T}, o), cls_out = at::empty({B, T}, o);
  at::Tensor stats = at::empty({B, tris::stage1_head_stats(h * w, T)}, o);
  at::Tensor cls_fg = at::empty({B}, o);
  at::Tensor relu_map = at::empty({B, H, W}, o), sig_map = at::empty({B, H, W}, o);
  launched(tris::stage1_head(vis_p.data_ptr<float>(), lan_p.data_ptr<float>(),
                             scale.data_ptr<float>(), score.data_ptr<float>(),
                             stats.data_ptr<float>(), cls_out.data_ptr<float>(),
                             cls_fg.data_ptr<float>(),
                             relu_map.data_ptr<float>(), sig_map.data_ptr<float>(), B, T, offset,
                             h, w, D, H, W, (float)focal_p, (float)focal_c, y, x, stream(),
                             &k3_train_shapes[0]),
           "stage1_head");
  k3_train_launched[0] = true;
  return {score, stats, cls_out, cls_fg, relu_map, sig_map};
}

// K3 backward: g_cls [B, T]; g_relu, g_sig [B, H, W] or None; the forward's
// inputs, score and stats, and its offset; ry, rx the adjoint ranges of the taps. Returns
// (d_vis [B, h*w, D], d_lan [B, T, D]).
std::vector<at::Tensor> stage1_head_bwd(
    const at::Tensor& g_cls, const std::optional<at::Tensor>& g_relu,
    const std::optional<at::Tensor>& g_sig, const at::Tensor& vis_p, const at::Tensor& lan_p,
    const at::Tensor& scale, const at::Tensor& score, const at::Tensor& stats,
    const std::vector<at::Tensor>& ty,
    const std::vector<at::Tensor>& tx, const std::vector<at::Tensor>& ry,
    const std::vector<at::Tensor>& rx, int64_t h, int64_t w, double focal_p, double focal_c,
    int64_t offset) {
  const at::Device dev = vis_p.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(g_cls, "stage1_head_bwd: g_cls", at::kFloat, dev);
  if (g_relu) check(*g_relu, "stage1_head_bwd: g_relu", at::kFloat, dev);
  if (g_sig) check(*g_sig, "stage1_head_bwd: g_sig", at::kFloat, dev);
  check(vis_p, "stage1_head_bwd: vis_p", at::kFloat, dev);
  check(lan_p, "stage1_head_bwd: lan_p", at::kFloat, dev);
  check(scale, "stage1_head_bwd: scale", at::kFloat, dev);
  check(score, "stage1_head_bwd: score", at::kFloat, dev);
  check(stats, "stage1_head_bwd: stats", at::kFloat, dev);
  const tris::TapArrays y = tap_arrays(ty, "stage1_head_bwd: row taps", dev);
  const tris::TapArrays x = tap_arrays(tx, "stage1_head_bwd: column taps", dev);
  const tris::TapRanges yr = tap_ranges(ry, "stage1_head_bwd: row ranges", dev);
  const tris::TapRanges xr = tap_ranges(rx, "stage1_head_bwd: column ranges", dev);
  const int64_t B = vis_p.size(0), T = lan_p.size(1), D = vis_p.size(2), H = ty[0].size(0),
                W = tx[0].size(0);
  TORCH_CHECK(offset >= 0 && B + offset <= T, "stage1_head_bwd: the own texts [offset, ",
              "offset + B) must lie in the T texts");
  at::Tensor d_vis = at::empty_like(vis_p), d_lan = at::empty_like(lan_p);
  launched(tris::stage1_head_bwd(g_cls.data_ptr<float>(), ptr<float>(g_relu), ptr<float>(g_sig),
                                 vis_p.data_ptr<float>(), lan_p.data_ptr<float>(),
                                 scale.data_ptr<float>(), score.data_ptr<float>(),
                                 stats.data_ptr<float>(), d_vis.data_ptr<float>(),
                                 d_lan.data_ptr<float>(), B, T, offset, h, w, D, H,
                                 W, (float)focal_p, (float)focal_c, y, x, yr, xr, stream(),
                                 &k3_train_shapes[1]),
           "stage1_head_bwd");
  k3_train_launched[1] = true;
  return {d_vis, d_lan};
}

// K3's training-head plan (launchers.h, stage1_head_plan) for B images and T texts: ranks,
// threads, pixels, band_rows, vec, passes, stages, groups, blocks and smem_bytes.
// K3's training head on bfloat16 lan_p and bfloat16 or float32 vis_p (--bf16), as
// stage1_head's arguments; returns (score, stats, cls_out, cls_fg, relu_map, sig_map) float32.
std::vector<at::Tensor> stage1_head_bf16(const at::Tensor& vis_p, const at::Tensor& lan_p,
                                         const at::Tensor& scale,
                                         const std::vector<at::Tensor>& ty,
                                         const std::vector<at::Tensor>& tx, int64_t h, int64_t w,
                                         double focal_p, double focal_c, int64_t offset) {
  const at::Device dev = vis_p.device();
  const c10::cuda::CUDAGuard guard(dev);
  const bool vis_bf16 = vis_p.scalar_type() == at::kBFloat16;
  check(vis_p, "stage1_head_bf16: vis_p", vis_bf16 ? at::kBFloat16 : at::kFloat, dev);
  check(lan_p, "stage1_head_bf16: lan_p", at::kBFloat16, dev);
  check(scale, "stage1_head_bf16: scale", at::kFloat, dev);
  const tris::TapArrays y = tap_arrays(ty, "stage1_head_bf16: row taps", dev);
  const tris::TapArrays x = tap_arrays(tx, "stage1_head_bf16: column taps", dev);
  const int64_t B = vis_p.size(0), T = lan_p.size(1), D = vis_p.size(2), H = ty[0].size(0),
                W = tx[0].size(0);
  TORCH_CHECK(offset >= 0 && B + offset <= T, "stage1_head_bf16: the own texts [offset, ",
              "offset + B) must lie in the T texts");
  const at::TensorOptions o = vis_p.options().dtype(at::kFloat);
  at::Tensor score = at::empty({B, h * w, T}, o), cls_out = at::empty({B, T}, o);
  at::Tensor stats = at::empty({B, tris::stage1_head_bf16_stats(h * w, T)}, o);
  at::Tensor cls_fg = at::empty({B}, o);
  at::Tensor relu_map = at::empty({B, H, W}, o), sig_map = at::empty({B, H, W}, o);
  launched(tris::stage1_head_bf16(vis_p.data_ptr(), vis_bf16, bits(lan_p),
                                  scale.data_ptr<float>(), score.data_ptr<float>(),
                                  stats.data_ptr<float>(), cls_out.data_ptr<float>(),
                                  cls_fg.data_ptr<float>(), relu_map.data_ptr<float>(),
                                  sig_map.data_ptr<float>(), B, T, offset, h, w, D, H, W,
                                  (float)focal_p, (float)focal_c, y, x, stream()),
           "stage1_head_bf16");
  return {score, stats, cls_out, cls_fg, relu_map, sig_map};
}

// K3's training head backward on stage1_head_bf16's operands: d_vis in vis_p's dtype, d_lan
// bfloat16.
std::vector<at::Tensor> stage1_head_bwd_bf16(
    const at::Tensor& g_cls, const std::optional<at::Tensor>& g_relu,
    const std::optional<at::Tensor>& g_sig, const at::Tensor& vis_p, const at::Tensor& lan_p,
    const at::Tensor& scale, const at::Tensor& score, const at::Tensor& stats,
    const std::vector<at::Tensor>& ty, const std::vector<at::Tensor>& tx,
    const std::vector<at::Tensor>& ry, const std::vector<at::Tensor>& rx, int64_t h, int64_t w,
    double focal_p, double focal_c, int64_t offset) {
  const at::Device dev = vis_p.device();
  const c10::cuda::CUDAGuard guard(dev);
  const bool vis_bf16 = vis_p.scalar_type() == at::kBFloat16;
  check(g_cls, "stage1_head_bwd_bf16: g_cls", at::kFloat, dev);
  if (g_relu) check(*g_relu, "stage1_head_bwd_bf16: g_relu", at::kFloat, dev);
  if (g_sig) check(*g_sig, "stage1_head_bwd_bf16: g_sig", at::kFloat, dev);
  check(vis_p, "stage1_head_bwd_bf16: vis_p", vis_bf16 ? at::kBFloat16 : at::kFloat, dev);
  check(lan_p, "stage1_head_bwd_bf16: lan_p", at::kBFloat16, dev);
  check(scale, "stage1_head_bwd_bf16: scale", at::kFloat, dev);
  check(score, "stage1_head_bwd_bf16: score", at::kFloat, dev);
  check(stats, "stage1_head_bwd_bf16: stats", at::kFloat, dev);
  const tris::TapArrays y = tap_arrays(ty, "stage1_head_bwd_bf16: row taps", dev);
  const tris::TapArrays x = tap_arrays(tx, "stage1_head_bwd_bf16: column taps", dev);
  const tris::TapRanges yr = tap_ranges(ry, "stage1_head_bwd_bf16: row ranges", dev);
  const tris::TapRanges xr = tap_ranges(rx, "stage1_head_bwd_bf16: column ranges", dev);
  const int64_t B = vis_p.size(0), T = lan_p.size(1), D = vis_p.size(2), H = ty[0].size(0),
                W = tx[0].size(0);
  TORCH_CHECK(offset >= 0 && B + offset <= T, "stage1_head_bwd_bf16: the own texts [offset, ",
              "offset + B) must lie in the T texts");
  at::Tensor d_vis = at::empty_like(vis_p), d_lan = at::empty_like(lan_p);
  launched(tris::stage1_head_bwd_bf16(g_cls.data_ptr<float>(), ptr<float>(g_relu),
                                      ptr<float>(g_sig), vis_p.data_ptr(), vis_bf16,
                                      bits(lan_p), scale.data_ptr<float>(),
                                      score.data_ptr<float>(), stats.data_ptr<float>(),
                                      d_vis.data_ptr(), bits_out(d_lan), B, T, offset, h, w, D,
                                      H, W, (float)focal_p, (float)focal_c, y, x, yr, xr,
                                      stream()),
           "stage1_head_bwd_bf16");
  return {d_vis, d_lan};
}

// The shared memory of a launch of K3's bfloat16 training head (launchers.h).
int64_t stage1_head_bf16_smem(int64_t hw, int64_t T, int64_t H, int64_t w, bool backward) {
  return tris::stage1_head_bf16_smem(hw, T, H, w, backward);
}

std::map<std::string, int64_t> stage1_head_plan(int64_t B, int64_t T, int64_t h, int64_t w,
                                                int64_t D, int64_t H, int64_t W, bool backward) {
  TORCH_CHECK(B > 0 && B <= 65535 && T >= B && h > 0 && w > 0 && D > 0 && H > 0 && W > 0 &&
                  h * w * T < INT32_MAX && H * W < INT32_MAX && D < INT32_MAX,
              "stage1_head_plan: shape out of range");
  const tris::Stage1HeadPlan p =
      tris::stage1_head_plan(B, T, (int)h, (int)w, (int)D, (int)H, (int)W, backward);
  return {{"ranks", p.ranks}, {"threads", p.threads}, {"pixels", p.pixels},
          {"band_rows", p.band_rows}, {"vec", p.vec}, {"passes", p.passes},
          {"stages", p.stages}, {"groups", p.groups}, {"blocks", p.blocks},
          {"smem_bytes", p.smem}};
}

// The last launch in this process of K3's training head (backward: its backward): blocks,
// blocks a cluster, threads a block, map columns a thread and bytes of shared memory a block.
std::map<std::string, int64_t> stage1_head_launch_shape(bool backward) {
  TORCH_CHECK(k3_train_launched[backward], "stage1_head_launch_shape: no launch of ",
              backward ? "stage1_head_bwd" : "stage1_head");
  const tris::Stage1HeadLaunchShape& s = k3_train_shapes[backward];
  return {{"blocks", s.blocks}, {"cluster", s.cluster}, {"threads", s.threads},
          {"vec", s.vec}, {"smem_bytes", s.smem}};
}

// K4: cams [B, S, h, w]; ty [B, maxH] x4, tx [B, maxW] x4; orig_hw [B, 2]
// int32. With targets [B, maxH, maxW] uint8 and boxes [B, 4]: returns stats
// [B, S, 4] (I, U, hit, hitm). Without them: the normalised maps
// [B, S, maxH, maxW].
tris::EvalMetricsLaunchShape k4_shape;
bool k4_launched = false;

at::Tensor eval_metrics(const at::Tensor& cams, const std::vector<at::Tensor>& ty,
                        const std::vector<at::Tensor>& tx, const at::Tensor& orig_hw,
                        const std::optional<at::Tensor>& targets,
                        const std::optional<at::Tensor>& boxes) {
  const at::Device dev = cams.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(cams, "eval_metrics: cams", at::kFloat, dev);
  check(orig_hw, "eval_metrics: orig_hw", at::kInt, dev);
  const Taps y = taps(ty, "eval_metrics: row taps", dev);
  const Taps x = taps(tx, "eval_metrics: column taps", dev);
  TORCH_CHECK(targets.has_value() == boxes.has_value(),
              "eval_metrics: pass targets and boxes together, or neither");
  const int64_t B = cams.size(0), S = cams.size(1), maxH = ty[0].size(1), maxW = tx[0].size(1);
  at::Tensor out;
  if (targets) {
    check(*targets, "eval_metrics: targets", at::kByte, dev);
    check(*boxes, "eval_metrics: boxes", at::kFloat, dev);
    out = at::empty({B, S, 4}, cams.options());
  } else {
    out = at::empty({B, S, maxH, maxW}, cams.options());
  }
  launched(tris::eval_metrics(cams.data_ptr<float>(), B, S, cams.size(2), cams.size(3), maxH,
                              maxW, y.lo, y.hi, y.w0, y.w1, x.lo, x.hi, x.w0, x.w1,
                              orig_hw.data_ptr<int>(), ptr<unsigned char>(targets),
                              ptr<float>(boxes), targets ? nullptr : out.data_ptr<float>(),
                              targets ? out.data_ptr<float>() : nullptr, stream(), &k4_shape),
           "eval_metrics");
  k4_launched = true;
  return out;
}

// K4's plan on this card (launchers.h, eval_metrics_device_plan): ranks, threads,
// band_rows, staged, smem_bytes, blocks and max_ranks.
std::map<std::string, int64_t> eval_metrics_plan(int64_t B, int64_t S, int64_t maxH, int64_t maxW,
                                                 int64_t h, int64_t w) {
  TORCH_CHECK(B > 0 && S > 0 && maxH > 0 && maxW > 0 && h > 0 && w > 0 && B <= 65535 &&
                  S <= 65535 && maxH * maxW < INT32_MAX && h * w < INT32_MAX,
              "eval_metrics_plan: shape out of range");
  const tris::EvalMetricsPlan p =
      tris::eval_metrics_device_plan((int)B, (int)S, (int)maxH, (int)maxW, (int)h, (int)w);
  return {{"ranks", p.ranks}, {"threads", p.threads}, {"band_rows", p.band_rows},
          {"staged", p.staged}, {"smem_bytes", p.smem}, {"blocks", p.blocks},
          {"max_ranks", p.max_ranks}};
}

// K4's last launch in this process: blocks, blocks a cluster, threads a block, bytes of
// shared memory a block, staged, and the bytes of each load of the map.
std::map<std::string, int64_t> eval_metrics_launch_shape() {
  TORCH_CHECK(k4_launched, "eval_metrics_launch_shape: no launch of eval_metrics");
  const tris::EvalMetricsLaunchShape& s = k4_shape;
  return {{"blocks", s.blocks}, {"cluster", s.cluster}, {"threads", s.threads},
          {"smem_bytes", s.smem}, {"staged", s.staged}, {"map_load_bytes", s.map_load_bytes}};
}

// K5: cams [P, H, W]; image [P/S, 3, H, W]; ty, tx the taps to [n] rows and
// columns. Returns A [P * (n/ps)^2, 3 * ps * ps].
at::Tensor critic_input(const at::Tensor& cams, const at::Tensor& image,
                        const std::vector<at::Tensor>& ty, const std::vector<at::Tensor>& tx,
                        int64_t S, int64_t ps) {
  const at::Device dev = cams.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(cams, "critic_input: cams", at::kFloat, dev);
  check(image, "critic_input: image", at::kFloat, dev);
  const Taps y = taps(ty, "critic_input: row taps", dev);
  const Taps x = taps(tx, "critic_input: column taps", dev);
  const int64_t P = cams.size(0), n = ty[0].size(0), g = n / ps;
  at::Tensor out = at::empty({P * g * g, 3 * ps * ps}, cams.options());
  launched(tris::critic_input(cams.data_ptr<float>(), image.data_ptr<float>(),
                              out.data_ptr<float>(), P, S, cams.size(1), cams.size(2), n, ps,
                              y.lo, y.hi, y.w0, y.w1, x.lo, x.hi, x.w0, x.w1, stream()),
           "critic_input");
  return out;
}

// K5 backward: dA [P * (n/ps)^2, 3 * ps * ps]; image [P/S, 3, H, W]; ty, tx the taps to [n]
// rows and columns, ry, rx their adjoint ranges over [H] and [W]. Returns d cams [P, H, W].
tris::CriticBwdLaunchShape k5_bwd_shape;
bool k5_bwd_launched = false;

at::Tensor critic_input_bwd(const at::Tensor& dA, const at::Tensor& image,
                            const std::vector<at::Tensor>& ty, const std::vector<at::Tensor>& tx,
                            const std::vector<at::Tensor>& ry, const std::vector<at::Tensor>& rx,
                            int64_t P, int64_t S, int64_t ps) {
  const at::Device dev = dA.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(dA, "critic_input_bwd: dA", at::kFloat, dev);
  check(image, "critic_input_bwd: image", at::kFloat, dev);
  const tris::TapArrays y = tap_arrays(ty, "critic_input_bwd: row taps", dev);
  const tris::TapArrays x = tap_arrays(tx, "critic_input_bwd: column taps", dev);
  const tris::TapRanges yr = tap_ranges(ry, "critic_input_bwd: row ranges", dev);
  const tris::TapRanges xr = tap_ranges(rx, "critic_input_bwd: column ranges", dev);
  const int64_t H = image.size(2), W = image.size(3), n = ty[0].size(0);
  at::Tensor dcams = at::empty({P, H, W}, dA.options());
  launched(tris::critic_input_bwd(dA.data_ptr<float>(), image.data_ptr<float>(),
                                  dcams.data_ptr<float>(), P, S, H, W, n, ps, y, x, yr, xr,
                                  stream(), &k5_bwd_shape),
           "critic_input_bwd");
  k5_bwd_launched = true;
  return dcams;
}

// K5 backward's plan (launchers.h, critic_input_bwd_plan) for P maps [H, W] <- [n, n].
std::map<std::string, int64_t> critic_input_bwd_plan(int64_t P, int64_t H, int64_t W,
                                                     int64_t n) {
  TORCH_CHECK(P >= 0 && H > 0 && W > 0 && n > 0 && H < INT32_MAX && W < INT32_MAX &&
                  n < INT32_MAX,
              "critic_input_bwd_plan: shape out of range");
  const tris::CriticBwdPlan p = tris::critic_input_bwd_plan(P, (int)H, (int)W, (int)n);
  return {{"fits", p.fits}, {"band", p.band}, {"span_rows", p.span_rows},
          {"img_rows", p.img_rows}, {"threads", p.threads}, {"blocks", p.blocks},
          {"smem_bytes", p.smem}};
}

// K5 backward's last launch in this process: blocks, threads a block, source rows a band, the
// output rows it may span and bytes of shared memory a block.
std::map<std::string, int64_t> critic_input_bwd_launch_shape() {
  TORCH_CHECK(k5_bwd_launched, "critic_input_bwd_launch_shape: no launch of critic_input_bwd");
  const tris::CriticBwdLaunchShape& s = k5_bwd_shape;
  return {{"blocks", s.blocks}, {"threads", s.threads}, {"band", s.band},
          {"span_rows", s.span_rows}, {"smem_bytes", s.smem}};
}

// K6: image uint8 [B, H, W, 3]; scale, bias 3 values each. Returns the
// normalised [B, 3, H, W] float32.
at::Tensor normalize_u8(const at::Tensor& image, const std::vector<double>& scale,
                        const std::vector<double>& bias) {
  const at::Device dev = image.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(image, "normalize_u8: image", at::kByte, dev);
  TORCH_CHECK(scale.size() == 3 && bias.size() == 3, "normalize_u8: 3 scales and 3 biases");
  const int64_t B = image.size(0), H = image.size(1), W = image.size(2);
  const float s[3] = {(float)scale[0], (float)scale[1], (float)scale[2]};
  const float b[3] = {(float)bias[0], (float)bias[1], (float)bias[2]};
  at::Tensor out = at::empty({B, 3, H, W}, image.options().dtype(at::kFloat));
  launched(tris::normalize_u8(image.data_ptr<unsigned char>(), out.data_ptr<float>(), B * H * W,
                              H * W, s, b, stream()),
           "normalize_u8");
  return out;
}

// K6, bilinear half: x [N, h, w]; ty, tx the taps to [oh] rows and [ow] columns.
// Returns [N, oh, ow].
tris::ResizeLaunchShape k6_shape;
bool k6_launched = false;

at::Tensor bilinear_resize(const at::Tensor& x, const std::vector<at::Tensor>& ty,
                           const std::vector<at::Tensor>& tx) {
  const at::Device dev = x.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(x, "bilinear_resize: x", at::kFloat, dev);
  const tris::TapArrays y = tap_arrays(ty, "bilinear_resize: row taps", dev);
  const tris::TapArrays c = tap_arrays(tx, "bilinear_resize: column taps", dev);
  const int64_t N = x.size(0), oh = ty[0].size(0), ow = tx[0].size(0);
  at::Tensor out = at::empty({N, oh, ow}, x.options());
  launched(tris::bilinear_resize(x.data_ptr<float>(), out.data_ptr<float>(), N, x.size(1),
                                 x.size(2), oh, ow, y, c, stream(), &k6_shape),
           "bilinear_resize");
  k6_launched = true;
  return out;
}

// K6's plan (launchers.h, bilinear_resize_plan) for [planes, h, w] -> [oh, ow].
std::map<std::string, int64_t> bilinear_resize_plan(int64_t planes, int64_t h, int64_t w,
                                                    int64_t oh, int64_t ow) {
  TORCH_CHECK(planes >= 0 && h > 0 && w > 0 && oh > 0 && ow > 0 && h < INT32_MAX &&
                  w < INT32_MAX && oh < INT32_MAX && ow < INT32_MAX,
              "bilinear_resize_plan: shape out of range");
  const tris::ResizePlan p = tris::bilinear_resize_plan(planes, (int)h, (int)w, (int)oh, (int)ow);
  return {{"vec", p.vec}, {"groups", p.groups}, {"tile_groups", p.tile_groups},
          {"tiles", p.tiles}, {"rows", p.rows}, {"rpt", p.rpt}, {"threads", p.threads},
          {"pitch", p.pitch},
          {"staged", p.staged}, {"chunks", p.chunks}, {"band_rows", p.band_rows},
          {"bands", p.bands}, {"blocks", p.blocks}, {"in_floats", p.in_floats},
          {"smem_bytes", p.smem}};
}

// K6's last forward launch in this process: blocks, column tiles, threads a block, rows a
// band, columns a thread, staged, the floats of a band's staged input and bytes of shared
// memory a block.
std::map<std::string, int64_t> bilinear_resize_launch_shape() {
  TORCH_CHECK(k6_launched, "bilinear_resize_launch_shape: no launch of bilinear_resize");
  const tris::ResizeLaunchShape& s = k6_shape;
  return {{"blocks", s.blocks}, {"tiles", s.tiles}, {"threads", s.threads},
          {"band_rows", s.band_rows}, {"vec", s.vec}, {"staged", s.staged},
          {"in_floats", s.in_floats}, {"smem_bytes", s.smem}};
}

// K6, bilinear half, backward: g [N, oh, ow]; ty, tx the forward's taps to [oh] rows and
// [ow] columns, ry, rx their adjoint ranges over [h] and [w]. Returns dx [N, h, w].
tris::ResizeBwdLaunchShape k6_bwd_shape;
bool k6_bwd_launched = false;

at::Tensor bilinear_resize_bwd(const at::Tensor& g, const std::vector<at::Tensor>& ty,
                               const std::vector<at::Tensor>& tx,
                               const std::vector<at::Tensor>& ry,
                               const std::vector<at::Tensor>& rx) {
  const at::Device dev = g.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(g, "bilinear_resize_bwd: g", at::kFloat, dev);
  const tris::TapArrays y = tap_arrays(ty, "bilinear_resize_bwd: row taps", dev);
  const tris::TapArrays c = tap_arrays(tx, "bilinear_resize_bwd: column taps", dev);
  const tris::TapRanges yr = tap_ranges(ry, "bilinear_resize_bwd: row ranges", dev);
  const tris::TapRanges cr = tap_ranges(rx, "bilinear_resize_bwd: column ranges", dev);
  const int64_t N = g.size(0), oh = g.size(1), ow = g.size(2), h = ry[0].size(0),
                w = rx[0].size(0);
  TORCH_CHECK(ty[0].size(0) == oh && tx[0].size(0) == ow,
              "bilinear_resize_bwd: taps do not match g");
  at::Tensor dx = at::empty({N, h, w}, g.options());
  launched(tris::bilinear_resize_bwd(g.data_ptr<float>(), dx.data_ptr<float>(), N, h, w, oh, ow,
                                     y, c, yr, cr, stream(), &k6_bwd_shape),
           "bilinear_resize_bwd");
  k6_bwd_launched = true;
  return dx;
}

// K6 backward's plan (launchers.h, bilinear_resize_bwd_plan) for [planes, h, w] <- [oh, ow].
std::map<std::string, int64_t> bilinear_resize_bwd_plan(int64_t planes, int64_t h, int64_t w,
                                                        int64_t oh, int64_t ow) {
  TORCH_CHECK(planes >= 0 && h > 0 && w > 0 && oh > 0 && ow > 0 && h < INT32_MAX &&
                  w < INT32_MAX && oh < INT32_MAX && ow < INT32_MAX,
              "bilinear_resize_bwd_plan: shape out of range");
  const tris::ResizeBwdPlan p =
      tris::bilinear_resize_bwd_plan(planes, (int)h, (int)w, (int)oh, (int)ow);
  return {{"staged", p.staged}, {"band", p.band}, {"span_rows", p.span_rows},
          {"g_pitch", p.g_pitch}, {"r_pitch", p.r_pitch}, {"vec", p.vec},
          {"col_lanes", p.col_lanes}, {"threads", p.threads}, {"blocks", p.blocks},
          {"smem_bytes", p.smem}};
}

// K6's last backward launch in this process: blocks, threads a block, input rows a band, the
// g rows it may stage, columns a thread, staged and bytes of shared memory a block.
std::map<std::string, int64_t> bilinear_resize_bwd_launch_shape() {
  TORCH_CHECK(k6_bwd_launched,
              "bilinear_resize_bwd_launch_shape: no launch of bilinear_resize_bwd");
  const tris::ResizeBwdLaunchShape& s = k6_bwd_shape;
  return {{"blocks", s.blocks}, {"threads", s.threads}, {"band", s.band},
          {"span_rows", s.span_rows}, {"vec", s.vec}, {"staged", s.staged},
          {"smem_bytes", s.smem}};
}

// K7's tiles: a host path table (steps [n_steps, 2], offsets [n_dirs + 1], int32 CPU tensors;
// the wrappers hold each step within the window of rf and the table within its limits).
tris::PathSteps path_steps(const at::Tensor& steps, const at::Tensor& offsets, const char* name) {
  TORCH_CHECK(steps.device().is_cpu() && offsets.device().is_cpu() &&
                  steps.scalar_type() == at::kInt && offsets.scalar_type() == at::kInt &&
                  steps.is_contiguous() && offsets.is_contiguous() && steps.dim() == 2 &&
                  steps.size(1) == 2 && offsets.dim() == 1 && offsets.size(0) >= 1,
              name, ": expected the path table as int32 CPU tensors [n_steps, 2], [n_dirs + 1]");
  const int64_t n_dirs = offsets.size(0) - 1;
  TORCH_CHECK(n_dirs <= tris::kPathTableDirs && steps.size(0) <= tris::kPathTableSteps, name,
              ": the path table is larger than the kernels take");
  return {steps.data_ptr<int>(), offsets.data_ptr<int>(), (int)n_dirs};
}

tris::PathTilePlan tile_plan(int64_t kind, int64_t B, int64_t H, int64_t W, int64_t rf,
                             const char* name) {
  TORCH_CHECK(kind >= 0 && kind <= 3 && B >= 0 && rf >= 0 && H > rf && W > 2 * rf &&
                  H < INT32_MAX && W < INT32_MAX,
              name, ": shape out of range");
  return tris::path_tile_plan((int)kind, B, (int)H, (int)W, (int)rf);
}

// K7's tiles' plan (launchers.h, path_tile_plan): kind 0 the fused loss's forward, 1 its
// backward, 2 K7's backward, 3 K7's forward.
std::map<std::string, int64_t> path_tile_plan(int64_t kind, int64_t B, int64_t H, int64_t W,
                                              int64_t rf) {
  const tris::PathTilePlan p = tile_plan(kind, B, H, W, rf, "path_tile_plan");
  return {{"rpt", p.rpt}, {"tile_rows", p.tile_rows}, {"tile_cols", p.tile_cols},
          {"pitch", p.pitch}, {"staged_rows", p.staged_rows}, {"region_rows", p.region_rows},
          {"tiles_y", p.tiles_y}, {"tiles_x", p.tiles_x}, {"dir_groups", p.dir_groups},
          {"blocks", p.blocks}, {"smem_bytes", p.smem}};
}

// K7's forward plan (launchers.h: path_tile_plan's kPathMaxForward tiles and
// path_max_forward_tiled) for B edge maps [H, W] and a table of n_dirs directions and n_steps
// steps; with groups > 0 the tiled plan's dir_groups is set to it (a measurement's override).
tris::PathTilePlan path_max_plan(int64_t B, int64_t H, int64_t W, int64_t rf, int64_t groups,
                                 bool* tiled, int64_t n_dirs, int64_t n_steps) {
  TORCH_CHECK(groups >= 0 && groups <= 64, "path_max_affinity: groups out of range");
  tris::PathTilePlan p = tile_plan(tris::kPathMaxForward, B, H, W, rf, "path_max_affinity");
  if (groups > 0) {
    p.blocks = p.blocks / p.dir_groups * groups;
    p.dir_groups = (int)groups;
  }
  *tiled = n_dirs <= INT32_MAX && n_steps <= INT32_MAX &&
           tris::path_max_forward_tiled(p, (int)n_dirs, (int)n_steps);
  return p;
}

std::map<std::string, int64_t> path_max_forward_plan(int64_t B, int64_t H, int64_t W,
                                                     int64_t rf, int64_t n_dirs,
                                                     int64_t n_steps) {
  bool tiled = false;
  const tris::PathTilePlan p = path_max_plan(B, H, W, rf, 0, &tiled, n_dirs, n_steps);
  return {{"tiled", tiled}, {"rpt", p.rpt}, {"tile_rows", p.tile_rows},
          {"tile_cols", p.tile_cols}, {"pitch", p.pitch}, {"staged_rows", p.staged_rows},
          {"tiles_y", p.tiles_y}, {"tiles_x", p.tiles_x}, {"dir_groups", p.dir_groups},
          {"blocks", p.blocks}, {"smem_bytes", p.smem}};
}

// K7: edge [B, H, W]; the path table twice, as int32 CPU tensors (the tiled kernel's
// parameter) and on the device (the direct kernel's), steps [n_steps, 2] and offsets
// [n_dirs + 1]. Returns [B, n_dirs, H - rf, W - 2 * rf]. groups > 0 overrides the tiled
// plan's direction groups.
tris::PathMaxLaunchShape k7_shape;
bool k7_launched = false;

at::Tensor path_max_affinity(const at::Tensor& edge, const at::Tensor& steps,
                             const at::Tensor& offsets, const at::Tensor& dev_steps,
                             const at::Tensor& dev_offsets, int64_t rf, int64_t groups) {
  const at::Device dev = edge.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(edge, "path_max_affinity: edge", at::kFloat, dev);
  check(dev_steps, "path_max_affinity: steps", at::kInt, dev);
  check(dev_offsets, "path_max_affinity: offsets", at::kInt, dev);
  TORCH_CHECK(steps.device().is_cpu() && offsets.device().is_cpu() &&
                  steps.scalar_type() == at::kInt && offsets.scalar_type() == at::kInt &&
                  steps.is_contiguous() && offsets.is_contiguous() && steps.dim() == 2 &&
                  offsets.dim() == 1 && offsets.size(0) >= 1 &&
                  steps.sizes() == dev_steps.sizes() && offsets.sizes() == dev_offsets.sizes(),
              "path_max_affinity: expected the path table as int32 CPU tensors and on the "
              "device");
  const int64_t B = edge.size(0), H = edge.size(1), W = edge.size(2);
  const int64_t n_dirs = offsets.size(0) - 1;
  bool tiled = false;
  const tris::PathTilePlan plan =
      path_max_plan(B, H, W, rf, groups, &tiled, n_dirs, steps.size(0));
  const tris::PathSteps table = {steps.data_ptr<int>(), offsets.data_ptr<int>(), (int)n_dirs};
  at::Tensor out = at::empty({B, n_dirs, H - rf, W - 2 * rf}, edge.options());
  launched(tris::path_max_affinity(tiled ? &plan : nullptr, table, dev_steps.data_ptr<int>(),
                                   dev_offsets.data_ptr<int>(), edge.data_ptr<float>(),
                                   out.data_ptr<float>(), B, (int)H, (int)W, (int)rf, stream(),
                                   &k7_shape),
           "path_max_affinity");
  k7_launched = true;
  return out;
}

// K7's last forward launch in this process: tiled (1) or direct (0), blocks, threads, rows a
// thread, direction groups, bytes of shared memory a block.
std::map<std::string, int64_t> path_max_affinity_launch_shape() {
  TORCH_CHECK(k7_launched, "path_max_affinity_launch_shape: no launch of path_max_affinity");
  const tris::PathMaxLaunchShape& s = k7_shape;
  return {{"tiled", s.tiled}, {"blocks", s.blocks}, {"threads", s.threads}, {"rpt", s.rpt},
          {"dir_groups", s.dir_groups}, {"smem_bytes", s.smem}};
}

// K7 backward: edge [B, H, W]; g [B, n_dirs, H - rf, W - 2 * rf]; the path table.
// Returns d edge [B, H, W].
at::Tensor path_max_affinity_bwd(const at::Tensor& edge, const at::Tensor& g,
                                 const at::Tensor& steps, const at::Tensor& offsets, int64_t rf) {
  const at::Device dev = edge.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(edge, "path_max_affinity_bwd: edge", at::kFloat, dev);
  check(g, "path_max_affinity_bwd: g", at::kFloat, dev);
  const tris::PathSteps table = path_steps(steps, offsets, "path_max_affinity_bwd");
  const int64_t B = edge.size(0), H = edge.size(1), W = edge.size(2);
  TORCH_CHECK(g.dim() == 4 && g.size(0) == B && g.size(1) == table.n_dirs &&
                  g.size(2) == H - rf && g.size(3) == W - 2 * rf,
              "path_max_affinity_bwd: g does not match the edge map and the table");
  const tris::PathTilePlan plan =
      tile_plan(tris::kPathMaxBackward, B, H, W, rf, "path_max_affinity_bwd");
  at::Tensor dedge = at::empty_like(edge);
  launched(tris::path_max_affinity_bwd(plan, table, edge.data_ptr<float>(), g.data_ptr<float>(),
                                       dedge.data_ptr<float>(), H, W, rf, stream()),
           "path_max_affinity_bwd");
  return dedge;
}

// The fused loss's inputs, forward and backward: labels uint8 [B, H, W]; edge [B, H, W]; dp
// [B, 2, H, W].
void check_irn_affinity(const char* name, const at::Tensor& labels, const at::Tensor& edge,
                        const at::Tensor& dp) {
  const at::Device dev = edge.device();
  check(labels, (std::string(name) + ": labels").c_str(), at::kByte, dev);
  check(edge, (std::string(name) + ": edge").c_str(), at::kFloat, dev);
  check(dp, (std::string(name) + ": dp").c_str(), at::kFloat, dev);
  TORCH_CHECK(labels.dim() == 3 && edge.sizes() == labels.sizes() && dp.dim() == 4 &&
                  dp.size(0) == labels.size(0) && dp.size(1) == 2 &&
                  dp.size(2) == labels.size(1) && dp.size(3) == labels.size(2),
              name, ": labels, edge and dp do not match");
}

// K7 + K8, the IRN loss from the edge map. Returns (sums [5] float32, counts [3] int64).
std::vector<at::Tensor> irn_affinity_loss(const at::Tensor& labels, const at::Tensor& edge,
                                          const at::Tensor& dp, const at::Tensor& steps,
                                          const at::Tensor& offsets, int64_t rf, double eps,
                                          double one_eps, int64_t max_valid) {
  const c10::cuda::CUDAGuard guard(edge.device());
  check_irn_affinity("irn_affinity_loss", labels, edge, dp);
  const tris::PathSteps table = path_steps(steps, offsets, "irn_affinity_loss");
  const int64_t B = labels.size(0), H = labels.size(1), W = labels.size(2);
  const tris::PathTilePlan plan =
      tile_plan(tris::kPathLossForward, B, H, W, rf, "irn_affinity_loss");
  const int64_t blocks = std::max<int64_t>(plan.blocks, 1);
  at::Tensor psum = at::empty({blocks, 5}, edge.options().dtype(at::kDouble));
  at::Tensor pcount = at::empty({blocks, 3}, edge.options().dtype(at::kLong));
  at::Tensor sums = at::empty({5}, edge.options());
  at::Tensor counts = at::empty({3}, edge.options().dtype(at::kLong));
  launched(tris::irn_affinity_loss(plan, table, labels.data_ptr<unsigned char>(),
                                   edge.data_ptr<float>(), dp.data_ptr<float>(),
                                   psum.data_ptr<double>(),
                                   reinterpret_cast<long long*>(pcount.data_ptr<int64_t>()),
                                   sums.data_ptr<float>(),
                                   reinterpret_cast<long long*>(counts.data_ptr<int64_t>()), H, W,
                                   rf, (float)eps, (float)one_eps, (int)max_valid, stream()),
           "irn_affinity_loss");
  return {sums, counts};
}

// Its backward: gsum [5] float32, the gradients of the sums. Returns (d edge, d dp).
std::vector<at::Tensor> irn_affinity_loss_bwd(const at::Tensor& labels, const at::Tensor& edge,
                                              const at::Tensor& dp, const at::Tensor& gsum,
                                              const at::Tensor& steps, const at::Tensor& offsets,
                                              int64_t rf, double eps, double one_eps,
                                              int64_t max_valid) {
  const c10::cuda::CUDAGuard guard(edge.device());
  check_irn_affinity("irn_affinity_loss_bwd", labels, edge, dp);
  check(gsum, "irn_affinity_loss_bwd: gsum", at::kFloat, edge.device());
  TORCH_CHECK(gsum.numel() == 5, "irn_affinity_loss_bwd: expected the 5 sums' gradients");
  const tris::PathSteps table = path_steps(steps, offsets, "irn_affinity_loss_bwd");
  const int64_t B = labels.size(0), H = labels.size(1), W = labels.size(2);
  const tris::PathTilePlan plan =
      tile_plan(tris::kPathLossBackward, B, H, W, rf, "irn_affinity_loss_bwd");
  at::Tensor dedge = at::empty_like(edge), ddp = at::empty_like(dp);
  launched(tris::irn_affinity_loss_bwd(plan, table, labels.data_ptr<unsigned char>(),
                                       edge.data_ptr<float>(), dp.data_ptr<float>(),
                                       gsum.data_ptr<float>(), dedge.data_ptr<float>(),
                                       ddp.data_ptr<float>(), H, W, rf, (float)eps,
                                       (float)one_eps, (int)max_valid, stream()),
           "irn_affinity_loss_bwd");
  return {dedge, ddp};
}

// K9: disp [2, H, W]. Returns the int32 centroids [2, H, W] and the steps each warp took
// (int32 [refine_centroids_plan(H, W).warps]).
std::vector<at::Tensor> refine_centroids(const at::Tensor& disp, int64_t iterations) {
  const at::Device dev = disp.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(disp, "refine_centroids: disp", at::kFloat, dev);
  const int64_t H = disp.size(1), W = disp.size(2);
  at::Tensor out = at::empty({2, H, W}, disp.options().dtype(at::kInt));
  at::Tensor steps = at::empty({tris::refine_centroids_plan((int)H, (int)W).warps},
                               disp.options().dtype(at::kInt));
  launched(tris::refine_centroids(disp.data_ptr<float>(), out.data_ptr<int>(),
                                  steps.data_ptr<int>(), H, W, iterations, stream()),
           "refine_centroids");
  return {out, steps};
}

// K9's plan (launchers.h, refine_centroids_plan) for the grid [H, W].
std::map<std::string, int64_t> refine_centroids_plan(int64_t H, int64_t W) {
  TORCH_CHECK(H >= 0 && W >= 0 && H * W < INT32_MAX, "refine_centroids_plan: shape out of range");
  const tris::CentroidsPlan p = tris::refine_centroids_plan((int)H, (int)W);
  return {{"staged", p.staged}, {"threads", p.threads}, {"blocks", p.blocks},
          {"warps", p.warps}, {"smem_bytes", p.smem}};
}

// K10: aff [n_dirs, ch, cw]; dirs [n_dirs, 2], seq [n_seq] and lut [2 * max_off + 1]
// int32. Returns T [H * W, H * W].
at::Tensor walk_transition(const at::Tensor& aff, const at::Tensor& dirs, const at::Tensor& seq,
                           const at::Tensor& lut, int64_t H, int64_t W, int64_t woff,
                           double beta) {
  const at::Device dev = aff.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(aff, "walk_transition: aff", at::kFloat, dev);
  check(dirs, "walk_transition: dirs", at::kInt, dev);
  check(seq, "walk_transition: seq", at::kInt, dev);
  check(lut, "walk_transition: lut", at::kInt, dev);
  at::Tensor out = at::empty({H * W, H * W}, aff.options());
  launched(tris::walk_transition(aff.data_ptr<float>(), dirs.data_ptr<int>(), seq.data_ptr<int>(),
                                 seq.size(0), lut.data_ptr<int>(), out.data_ptr<float>(),
                                 aff.size(1), aff.size(2), H, W, woff, (lut.size(0) - 1) / 2,
                                 (float)beta, stream()),
           "walk_transition");
  return out;
}

// K10, the walk's products: a [M, K], b [K, N]; a zero where |k - i| > band_a, b where
// |j - k| > band_b. Checks what both kernels need; returns the dense band clamped to the
// largest size, which no offset exceeds.
void check_products(const at::Tensor& a, const at::Tensor& b, const at::Device& dev,
                    int64_t& band_a, int64_t& band_b) {
  check(a, "walk products: a", at::kFloat, dev);
  check(b, "walk products: b", at::kFloat, dev);
  TORCH_CHECK(a.dim() == 2 && b.dim() == 2 && a.size(1) == b.size(0),
              "walk products: expected [M, K] @ [K, N]");
  const int64_t M = a.size(0), K = a.size(1), N = b.size(1);
  TORCH_CHECK(K % 8 == 0 && N % 4 == 0, "walk products: expected K % 8 == 0 and N % 4 == 0");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(a.data_ptr()) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b.data_ptr()) % 16 == 0,
              "walk products: expected 16-byte aligned operands");
  TORCH_CHECK(band_a >= 0 && band_b >= 0, "walk products: bands must be >= 0");
  band_a = std::min(band_a, std::max({M, N, K}));
  band_b = std::min(band_b, std::max({M, N, K}));
}

// The FP64 tensor-core kernel with the occupancy maps of walk_tile_occupancy (bool, the rows
// map of a and the cols map of b); it skips the k-tiles they mark empty. Returns a @ b.
at::Tensor walk_square(const at::Tensor& a, const at::Tensor& b, const at::Tensor& occ_a,
                       const at::Tensor& occ_b, int64_t band_a, int64_t band_b) {
  const at::Device dev = a.device();
  const c10::cuda::CUDAGuard guard(dev);
  check_products(a, b, dev, band_a, band_b);
  check(occ_a, "walk_square: occ_a", at::kBool, dev);
  check(occ_b, "walk_square: occ_b", at::kBool, dev);
  const int64_t M = a.size(0), K = a.size(1), N = b.size(1);
  const int64_t tiles_m = (M + tris::kWalkTile - 1) / tris::kWalkTile;
  const int64_t tiles_n = (N + tris::kWalkTile - 1) / tris::kWalkTile;
  const int64_t steps = (K + tris::kWalkStep - 1) / tris::kWalkStep;
  TORCH_CHECK(occ_a.dim() == 2 && occ_a.size(0) == tiles_m && occ_a.size(1) == steps &&
                  occ_b.dim() == 2 && occ_b.size(0) == steps && occ_b.size(1) == tiles_n,
              "walk_square: expected maps [", tiles_m, ", ", steps, "] and [", steps, ", ",
              tiles_n, "], got ", occ_a.sizes(), " and ", occ_b.sizes());
  int smem_max = 0;
  TORCH_CHECK(cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                     dev.index()) == cudaSuccess,
              "walk_square: cannot read the card's shared memory size");
  TORCH_CHECK(tris::walk_square_smem(K) <= static_cast<size_t>(smem_max), "walk_square: K = ",
              K, " needs ", tris::walk_square_smem(K), " bytes of shared memory, the card has ",
              smem_max);
  at::Tensor out = at::empty({M, N}, a.options());
  launched(tris::walk_square(a.data_ptr<float>(), b.data_ptr<float>(), occ_a.data_ptr<bool>(),
                             occ_b.data_ptr<bool>(), out.data_ptr<float>(), M, N, K, band_a,
                             band_b, stream()),
           "walk_square");
  return out;
}

// The thin-step kernel, which streams b once. Returns a @ b.
at::Tensor walk_thin(const at::Tensor& a, const at::Tensor& b, int64_t band_a, int64_t band_b) {
  const at::Device dev = a.device();
  const c10::cuda::CUDAGuard guard(dev);
  check_products(a, b, dev, band_a, band_b);
  at::Tensor out = at::empty({a.size(0), b.size(1)}, a.options());
  launched(tris::walk_thin(a.data_ptr<float>(), b.data_ptr<float>(), out.data_ptr<float>(),
                           a.size(0), b.size(1), a.size(1), band_a, band_b, stream()),
           "walk_thin");
  return out;
}

// K10's occupancy maps: x [R, C] (C % 4 == 0). Returns (rows [ceil(R / kWalkTile),
// ceil(C / kWalkStep)], cols [ceil(R / kWalkStep), ceil(C / kWalkTile)]), bool.
std::vector<at::Tensor> walk_tile_occupancy(const at::Tensor& x) {
  const at::Device dev = x.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(x, "walk_tile_occupancy: x", at::kFloat, dev);
  TORCH_CHECK(x.dim() == 2 && x.size(1) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0,
              "walk_tile_occupancy: expected [R, C] with C % 4 == 0, 16-byte aligned");
  const int64_t R = x.size(0), C = x.size(1), tile = tris::kWalkTile, step = tris::kWalkStep;
  at::Tensor rows = at::empty({(R + tile - 1) / tile, (C + step - 1) / step},
                              x.options().dtype(at::kBool));
  at::Tensor cols = at::empty({(R + step - 1) / step, (C + tile - 1) / tile},
                              x.options().dtype(at::kBool));
  launched(tris::walk_tile_occupancy(x.data_ptr<float>(), rows.data_ptr<bool>(),
                                     cols.data_ptr<bool>(), R, C, stream()),
           "walk_tile_occupancy");
  return {rows, cols};
}

// K11: q [N, HW, C]; lk, lv [N*S, T, C]. Returns G [N*S, HW, C].
at::Tensor pixel_attn(const at::Tensor& q, const at::Tensor& lk, const at::Tensor& lv, int64_t S,
                      double div) {
  const at::Device dev = q.device();
  const c10::cuda::CUDAGuard guard(dev);
  for (const at::Tensor* t : {&q, &lk, &lv}) check(*t, "pixel_attn", at::kFloat, dev);
  const int64_t HW = q.size(1), C = q.size(2), P = lk.size(0), T = lk.size(1);
  TORCH_CHECK(HW <= INT32_MAX && C <= INT32_MAX && P <= INT32_MAX && S <= INT32_MAX,
              "pixel_attn: sizes past 32-bit indices");
  at::Tensor out = at::empty({P, HW, C}, q.options());
  launched(tris::pixel_attn(q.data_ptr<float>(), lk.data_ptr<float>(), lv.data_ptr<float>(),
                            out.data_ptr<float>(), P, HW, T, C, S, (float)div, stream(),
                            &k11_shapes["pixel_attn"]),
           "pixel_attn");
  return out;
}

// K11 backward: dg [N*S, HW, C] and the forward's inputs. Returns (dq, dlk, dlv).
std::vector<at::Tensor> pixel_attn_bwd(const at::Tensor& dg, const at::Tensor& q,
                                       const at::Tensor& lk, const at::Tensor& lv, int64_t S,
                                       double div) {
  const at::Device dev = q.device();
  const c10::cuda::CUDAGuard guard(dev);
  for (const at::Tensor* t : {&dg, &q, &lk, &lv}) check(*t, "pixel_attn_bwd", at::kFloat, dev);
  const int64_t HW = q.size(1), C = q.size(2), P = lk.size(0), T = lk.size(1);
  TORCH_CHECK(HW <= INT32_MAX && C <= INT32_MAX && P <= INT32_MAX && S <= INT32_MAX,
              "pixel_attn_bwd: sizes past 32-bit indices");
  const int64_t groups = tris::pixel_attn_groups(q.size(0), (int)HW, (int)C, true);
  at::Tensor partials = at::empty({2, P, groups, T, C}, q.options());
  at::Tensor dq = at::empty_like(q), dlk = at::empty_like(lk), dlv = at::empty_like(lv);
  tris::PixelAttnLaunchShape shapes[2] = {};
  launched(tris::pixel_attn_bwd(dg.data_ptr<float>(), q.data_ptr<float>(), lk.data_ptr<float>(),
                                lv.data_ptr<float>(), partials.data_ptr<float>(),
                                dq.data_ptr<float>(), dlk.data_ptr<float>(), dlv.data_ptr<float>(),
                                P, HW, T, C, S, (float)div, stream(), shapes),
           "pixel_attn_bwd");
  if (HW > 0) k11_shapes["pixel_attn_bwd_probs_dq"] = shapes[0];
  k11_shapes["pixel_attn_bwd_dkv"] = shapes[1];
  return {dq, dlk, dlv};
}

// Whether K11's kernels take (T, C, S), forward or (with backward) backward (launchers.h).
bool pixel_attn_takes(int64_t T, int64_t C, int64_t S, bool backward) {
  return T <= INT32_MAX && C <= INT32_MAX && S <= INT32_MAX &&
         tris::pixel_attn_takes((int)T, (int)C, (int)S, backward);
}

// The last launch of K11's `name` (pixel_attn, pixel_attn_bwd_probs_dq, pixel_attn_bwd_dkv)
// in this process: blocks, blocks a cluster, threads a block, bytes of shared memory a
// block, the token bucket, pixels a tile, channels a rank, tile groups an image and the
// bytes of each global load.
std::map<std::string, int64_t> pixel_attn_launch_shape(const std::string& name) {
  const auto it = k11_shapes.find(name);
  TORCH_CHECK(it != k11_shapes.end(), "pixel_attn_launch_shape: no launch of ", name);
  const tris::PixelAttnLaunchShape& s = it->second;
  return {{"blocks", s.blocks}, {"cluster", s.cluster}, {"threads", s.threads},
          {"smem_bytes", s.smem}, {"t_bucket", s.t_bucket}, {"tile", s.tile},
          {"width", s.width}, {"groups", s.groups}, {"load_bytes", s.load_bytes}};
}

// K12: table [L, 4] and starts [L] int64 on the card (kernels/ema.py builds them);
// teacher := teacher * d + student * omd over every float leaf, int64 leaves copied.
void ema_update(const at::Tensor& table, const at::Tensor& starts, int64_t n_chunks,
                int64_t chunk, double d, double omd) {
  const at::Device dev = table.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(table, "ema_update: table", at::kLong, dev);
  check(starts, "ema_update: starts", at::kLong, dev);
  TORCH_CHECK(table.dim() == 2 && table.size(1) == 4 && starts.size(0) == table.size(0),
              "ema_update: expected a [L, 4] table and [L] chunk starts");
  launched(tris::ema_update(reinterpret_cast<const long long*>(table.data_ptr<int64_t>()),
                            reinterpret_cast<const long long*>(starts.data_ptr<int64_t>()),
                            table.size(0), n_chunks, chunk, (float)d, (float)omd, stream()),
           "ema_update");
}

// K13's x [N, C, H, W] (or any [N, C, ...]): contiguous float32 on `dev`, N * HW >= 1 and
// fewer than 2^31 elements. Returns (N, C, HW).
std::array<int, 3> check_batch_norm(const at::Tensor& x, const char* name) {
  check(x, name, at::kFloat, x.device());
  TORCH_CHECK(x.dim() >= 2 && x.numel() > 0 && x.numel() < INT32_MAX, name,
              ": expected [N, C, ...] with 1 to 2^31 - 1 elements, got ", x.sizes());
  return {(int)x.size(0), (int)x.size(1), (int)(x.numel() / (x.size(0) * x.size(1)))};
}

void check_channels(const at::Tensor& t, const char* what, const at::Device& dev, int64_t C) {
  check(t, what, at::kFloat, dev);
  TORCH_CHECK(t.numel() == C, what, ": expected ", C, " values, got ", t.numel());
}

// K13's plan on this card for a call of x [N, C, HW] (launchers.h, batch_norm_device_plan):
// design (0 two-pass, 1 fused, 2 the eval fold's apply), ranks, samples, threads, group,
// smem_bytes, blocks, launches and max_ranks. force: -1 the rule, 0 two-pass (measurements).
std::map<std::string, int64_t> batch_norm_plan(int64_t N, int64_t C, int64_t HW, bool training,
                                               bool backward, int64_t act, int64_t force) {
  TORCH_CHECK(N > 0 && C > 0 && HW > 0 && N * C * HW < INT32_MAX,
              "batch_norm_plan: expected 1 to 2^31 - 1 elements");
  const tris::BatchNormPlan p =
      tris::batch_norm_device_plan((int)N, (int)C, (int)HW, training, backward, (int)act,
                                   (int)force);
  return {{"design", p.design}, {"ranks", p.ranks}, {"samples", p.samples},
          {"threads", p.threads}, {"group", p.group}, {"smem_bytes", p.smem},
          {"blocks", p.blocks}, {"launches", p.launches}, {"max_ranks", p.max_ranks}};
}

// The shape of the last launch of each of K13's kernels, as its launcher made it.
std::map<std::string, tris::BatchNormLaunchShape> k13_shapes;

void record_k13(const char* const* names, const tris::BatchNormLaunchShape* shapes, int n) {
  for (int i = 0; i < n; ++i) k13_shapes[names[i]] = shapes[i];
}

// The last launch of K13's `name` in this process (batch_norm_fwd_fused,
// batch_norm_stats_partial, batch_norm_stats_final, batch_norm_apply, batch_norm_bwd_fused,
// batch_norm_bwd_slope, batch_norm_bwd_partial, batch_norm_bwd_final, batch_norm_bwd_apply):
// blocks, blocks a cluster, threads a block, bytes of shared memory a block and of each load.
std::map<std::string, int64_t> batch_norm_launch_shape(const std::string& name) {
  const auto it = k13_shapes.find(name);
  TORCH_CHECK(it != k13_shapes.end(), "batch_norm_launch_shape: no launch of ", name);
  const tris::BatchNormLaunchShape& s = it->second;
  return {{"blocks", s.blocks}, {"cluster", s.cluster}, {"threads", s.threads},
          {"smem_bytes", s.smem}, {"load_bytes", s.load_bytes}};
}

const char* const kStatsNames[] = {"batch_norm_stats_partial", "batch_norm_stats_final",
                                   "batch_norm_apply"};

// K13 statistics of x [N, C, ...] (the two-pass design's two launches): returns [3, C] (mean,
// biased var, rstd); with the running buffers given, they move by `momentum` in place.
at::Tensor batch_norm_stats(const at::Tensor& x, const std::optional<at::Tensor>& running_mean,
                            const std::optional<at::Tensor>& running_var, double momentum,
                            double eps) {
  const c10::cuda::CUDAGuard guard(x.device());
  const auto [N, C, HW] = check_batch_norm(x, "batch_norm_stats: x");
  TORCH_CHECK(running_mean.has_value() == running_var.has_value(),
              "batch_norm_stats: give both running buffers or neither");
  if (running_mean) {
    check_channels(*running_mean, "batch_norm_stats: running_mean", x.device(), C);
    check_channels(*running_var, "batch_norm_stats: running_var", x.device(), C);
  }
  TORCH_CHECK((int64_t)N * HW < (1 << 24) && N <= tris::kBatchNormMaxBatch,
              "batch_norm_stats: N * HW must be below 2^24 and N at most ",
              tris::kBatchNormMaxBatch);
  const int64_t slices = tris::batch_norm_slices(HW);
  at::Tensor partial = at::empty({C * N * slices * 2}, x.options().dtype(at::kDouble));
  at::Tensor stats = at::empty({3, C}, x.options());
  tris::BatchNormLaunchShape shapes[2] = {};
  launched(tris::batch_norm_stats(x.data_ptr<float>(), partial.data_ptr<double>(),
                                  stats.data_ptr<float>(), ptr<float>(running_mean),
                                  ptr<float>(running_var), N, C, HW, momentum, eps, stream(),
                                  shapes),
           "batch_norm_stats");
  record_k13(kStatsNames, shapes, 2);
  return stats;
}

void check_apply_args(const at::Tensor& x, int C, const at::Tensor& weight,
                      const at::Tensor& bias, const std::optional<at::Tensor>& residual,
                      const std::optional<at::Tensor>& slope, int64_t act, const char* name) {
  const at::Device dev = x.device();
  check_channels(weight, name, dev, C);
  check_channels(bias, name, dev, C);
  if (residual) {
    check(*residual, name, at::kFloat, dev);
    TORCH_CHECK(residual->sizes() == x.sizes(), name, ": residual not x's shape");
  }
  TORCH_CHECK(act >= tris::kBatchNormActNone && act <= tris::kBatchNormActPrelu, name,
              ": unknown activation ", act);
  TORCH_CHECK((act == tris::kBatchNormActPrelu) == slope.has_value(), name,
              ": a slope goes with PReLU and only with it");
  if (slope) check_channels(*slope, name, dev, 1);
}

// K13 apply: y = act(((x - mean) * rstd) * weight + bias [+ residual]); without mean and rstd
// the eval fold y = act(x * weight + bias). act: 0 none, 1 ReLU, 2 PReLU (slope [1]).
at::Tensor batch_norm_apply(const at::Tensor& x, const std::optional<at::Tensor>& mean,
                            const std::optional<at::Tensor>& rstd, const at::Tensor& weight,
                            const at::Tensor& bias, const std::optional<at::Tensor>& residual,
                            const std::optional<at::Tensor>& slope, int64_t act) {
  const at::Device dev = x.device();
  const c10::cuda::CUDAGuard guard(dev);
  const auto [N, C, HW] = check_batch_norm(x, "batch_norm_apply: x");
  TORCH_CHECK(mean.has_value() == rstd.has_value(), "batch_norm_apply: mean and rstd go together");
  if (mean) {
    check_channels(*mean, "batch_norm_apply: mean", dev, C);
    check_channels(*rstd, "batch_norm_apply: rstd", dev, C);
  }
  check_apply_args(x, C, weight, bias, residual, slope, act, "batch_norm_apply");
  at::Tensor y = at::empty_like(x);
  tris::BatchNormLaunchShape shape = {};
  launched(tris::batch_norm_apply(x.data_ptr<float>(), ptr<float>(mean), ptr<float>(rstd),
                                  weight.data_ptr<float>(), bias.data_ptr<float>(),
                                  ptr<float>(residual), ptr<float>(slope), y.data_ptr<float>(),
                                  N, C, HW, (int)act, stream(), &shape),
           "batch_norm_apply");
  record_k13(kStatsNames + 2, &shape, 1);
  return y;
}

// K13's eval fold on bfloat16 x [N, C, ...] (--bf16): a and b [C] bfloat16 (the fold rounded),
// residual as x or None, act 0 none or 1 ReLU; returns y bfloat16.
at::Tensor batch_norm_fold_bf16(const at::Tensor& x, const at::Tensor& a, const at::Tensor& b,
                                const std::optional<at::Tensor>& residual, int64_t act) {
  const at::Device dev = x.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(x, "batch_norm_fold_bf16: x", at::kBFloat16, dev);
  TORCH_CHECK(x.dim() >= 2 && x.numel() > 0 && x.numel() < INT32_MAX,
              "batch_norm_fold_bf16: expected [N, C, ...] with 1 to 2^31 - 1 elements");
  const int N = (int)x.size(0), C = (int)x.size(1), HW = (int)(x.numel() / (x.size(0) * x.size(1)));
  check(a, "batch_norm_fold_bf16: a", at::kBFloat16, dev);
  check(b, "batch_norm_fold_bf16: b", at::kBFloat16, dev);
  TORCH_CHECK(a.numel() == C && b.numel() == C, "batch_norm_fold_bf16: expected [", C, "] a, b");
  if (residual) {
    check(*residual, "batch_norm_fold_bf16: residual", at::kBFloat16, dev);
    TORCH_CHECK(residual->sizes() == x.sizes(), "batch_norm_fold_bf16: residual not x's shape");
  }
  TORCH_CHECK(act == tris::kBatchNormActNone || act == tris::kBatchNormActRelu,
              "batch_norm_fold_bf16: act must be none or ReLU");
  at::Tensor y = at::empty_like(x);
  tris::BatchNormLaunchShape shape = {};
  launched(tris::batch_norm_fold_bf16(bits(x), bits(a), bits(b),
                                      residual ? bits(*residual) : nullptr, bits_out(y), N, C, HW,
                                      (int)act, stream(), &shape),
           "batch_norm_fold_bf16");
  k13_shapes["batch_norm_fold_bf16"] = shape;
  return y;
}

// K13 train forward, the design of the plan (`force` as batch_norm_plan's): returns (y,
// stats [3, C] as batch_norm_stats'); with the running buffers given, they move by
// `momentum` in place.
std::vector<at::Tensor> batch_norm_fwd(const at::Tensor& x, const at::Tensor& weight,
                                       const at::Tensor& bias,
                                       const std::optional<at::Tensor>& residual,
                                       const std::optional<at::Tensor>& slope,
                                       const std::optional<at::Tensor>& running_mean,
                                       const std::optional<at::Tensor>& running_var, int64_t act,
                                       double momentum, double eps, int64_t force) {
  const at::Device dev = x.device();
  const c10::cuda::CUDAGuard guard(dev);
  const auto [N, C, HW] = check_batch_norm(x, "batch_norm_fwd: x");
  TORCH_CHECK(running_mean.has_value() == running_var.has_value(),
              "batch_norm_fwd: give both running buffers or neither");
  if (running_mean) {
    check_channels(*running_mean, "batch_norm_fwd: running_mean", dev, C);
    check_channels(*running_var, "batch_norm_fwd: running_var", dev, C);
  }
  TORCH_CHECK((int64_t)N * HW < (1 << 24) && N <= tris::kBatchNormMaxBatch,
              "batch_norm_fwd: N * HW must be below 2^24 and N at most ",
              tris::kBatchNormMaxBatch);
  check_apply_args(x, C, weight, bias, residual, slope, act, "batch_norm_fwd");
  const tris::BatchNormPlan plan =
      tris::batch_norm_device_plan(N, C, HW, true, false, (int)act, (int)force);
  const bool fused = plan.design == tris::kBatchNormFused;
  at::Tensor partial =
      fused ? at::Tensor()
            : at::empty({C * N * tris::batch_norm_slices(HW) * 2}, x.options().dtype(at::kDouble));
  at::Tensor y = at::empty_like(x), stats = at::empty({3, C}, x.options());
  tris::BatchNormLaunchShape shapes[3] = {};
  launched(tris::batch_norm_forward(plan, x.data_ptr<float>(), weight.data_ptr<float>(),
                                    bias.data_ptr<float>(), ptr<float>(residual),
                                    ptr<float>(slope), y.data_ptr<float>(),
                                    stats.data_ptr<float>(),
                                    fused ? nullptr : partial.data_ptr<double>(),
                                    ptr<float>(running_mean), ptr<float>(running_var), N, C, HW,
                                    (int)act, momentum, eps, stream(), shapes),
           "batch_norm_fwd");
  static const char* const fused_names[] = {"batch_norm_fwd_fused"};
  record_k13(fused ? fused_names : kStatsNames, shapes, plan.launches);
  return {y, stats};
}

// K13 train forward on bfloat16 x [N, C, ...] (--bf16), three launches: weight, bias [C]
// float32, residual as x or None, act 0 none or 1 ReLU, the running buffers (float32, both
// or neither) moved in place. Returns (y bfloat16, stats [3, C] float32).
std::vector<at::Tensor> batch_norm_fwd_bf16(const at::Tensor& x, const at::Tensor& weight,
                                            const at::Tensor& bias,
                                            const std::optional<at::Tensor>& residual,
                                            const std::optional<at::Tensor>& running_mean,
                                            const std::optional<at::Tensor>& running_var,
                                            int64_t act, double momentum, double eps) {
  const at::Device dev = x.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(x, "batch_norm_fwd_bf16: x", at::kBFloat16, dev);
  TORCH_CHECK(x.dim() >= 2 && x.numel() > 0 && x.numel() < INT32_MAX,
              "batch_norm_fwd_bf16: expected [N, C, ...] with 1 to 2^31 - 1 elements");
  const int N = (int)x.size(0), C = (int)x.size(1), HW = (int)(x.numel() / (x.size(0) * x.size(1)));
  TORCH_CHECK((int64_t)N * HW < (1 << 24) && N <= tris::kBatchNormMaxBatch,
              "batch_norm_fwd_bf16: N * HW must be below 2^24 and N at most ",
              tris::kBatchNormMaxBatch);
  check_channels(weight, "batch_norm_fwd_bf16: weight", dev, C);
  check_channels(bias, "batch_norm_fwd_bf16: bias", dev, C);
  TORCH_CHECK(running_mean.has_value() == running_var.has_value(),
              "batch_norm_fwd_bf16: give both running buffers or neither");
  if (running_mean) {
    check_channels(*running_mean, "batch_norm_fwd_bf16: running_mean", dev, C);
    check_channels(*running_var, "batch_norm_fwd_bf16: running_var", dev, C);
  }
  if (residual) {
    check(*residual, "batch_norm_fwd_bf16: residual", at::kBFloat16, dev);
    TORCH_CHECK(residual->sizes() == x.sizes(), "batch_norm_fwd_bf16: residual not x's shape");
  }
  TORCH_CHECK(act == tris::kBatchNormActNone || act == tris::kBatchNormActRelu,
              "batch_norm_fwd_bf16: act must be none or ReLU");
  at::Tensor partial = at::empty({(int64_t)C * N * tris::batch_norm_slices(HW) * 2},
                                 x.options().dtype(at::kDouble));
  at::Tensor y = at::empty_like(x), stats = at::empty({3, C}, x.options().dtype(at::kFloat));
  tris::BatchNormLaunchShape shapes[3] = {};
  launched(tris::batch_norm_forward_bf16(bits(x), weight.data_ptr<float>(), bias.data_ptr<float>(),
                                         residual ? bits(*residual) : nullptr, bits_out(y),
                                         stats.data_ptr<float>(), partial.data_ptr<double>(),
                                         ptr<float>(running_mean), ptr<float>(running_var), N, C,
                                         HW, (int)act, momentum, eps, stream(), shapes),
           "batch_norm_fwd_bf16");
  static const char* const names[] = {"batch_norm_stats_partial.bf16",
                                      "batch_norm_stats_final.bf16", "batch_norm_apply.bf16"};
  record_k13(names, shapes, 3);
  return {y, stats};
}

// K13 train backward on bfloat16 g, x (and out, the forward's y, with ReLU) (--bf16), three
// launches: mean, rstd, weight, bias [C] float32. Returns (dx bfloat16, dweight, dbias [C]
// float32, dres bfloat16 or empty); dres is written when `residual` is set.
std::vector<at::Tensor> batch_norm_bwd_bf16(const at::Tensor& g, const at::Tensor& x,
                                            const std::optional<at::Tensor>& out,
                                            const at::Tensor& mean, const at::Tensor& rstd,
                                            const at::Tensor& weight, const at::Tensor& bias,
                                            int64_t act, bool residual) {
  const at::Device dev = x.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(x, "batch_norm_bwd_bf16: x", at::kBFloat16, dev);
  check(g, "batch_norm_bwd_bf16: g", at::kBFloat16, dev);
  TORCH_CHECK(x.dim() >= 2 && x.numel() > 0 && x.numel() < INT32_MAX && g.sizes() == x.sizes(),
              "batch_norm_bwd_bf16: expected g and x [N, C, ...] with 1 to 2^31 - 1 elements");
  const int N = (int)x.size(0), C = (int)x.size(1), HW = (int)(x.numel() / (x.size(0) * x.size(1)));
  TORCH_CHECK(act == tris::kBatchNormActNone || act == tris::kBatchNormActRelu,
              "batch_norm_bwd_bf16: act must be none or ReLU");
  TORCH_CHECK((act == tris::kBatchNormActRelu) == out.has_value(),
              "batch_norm_bwd_bf16: the output goes with ReLU and only with it");
  if (out) {
    check(*out, "batch_norm_bwd_bf16: out", at::kBFloat16, dev);
    TORCH_CHECK(out->sizes() == x.sizes(), "batch_norm_bwd_bf16: out not x's shape");
  }
  for (const at::Tensor* t : {&mean, &rstd, &weight, &bias})
    check_channels(*t, "batch_norm_bwd_bf16: statistics and parameters", dev, C);
  const at::TensorOptions f = x.options().dtype(at::kFloat);
  at::Tensor partial = at::empty({(int64_t)C * N * tris::batch_norm_slices(HW) * 3},
                                 x.options().dtype(at::kDouble));
  at::Tensor coef = at::empty({2, C}, f), dw = at::empty({C}, f), db = at::empty({C}, f);
  at::Tensor dx = at::empty_like(x), dres = residual ? at::empty_like(x) : at::Tensor();
  tris::BatchNormLaunchShape shapes[3] = {};
  launched(tris::batch_norm_bwd_bf16(bits(g), bits(x), out ? bits(*out) : nullptr,
                                     mean.data_ptr<float>(), rstd.data_ptr<float>(),
                                     weight.data_ptr<float>(), bias.data_ptr<float>(),
                                     partial.data_ptr<double>(), coef.data_ptr<float>(),
                                     dw.data_ptr<float>(), db.data_ptr<float>(), bits_out(dx),
                                     residual ? bits_out(dres) : nullptr, N, C, HW, (int)act,
                                     stream(), shapes),
           "batch_norm_bwd_bf16");
  static const char* const names[] = {"batch_norm_bwd_partial.bf16", "batch_norm_bwd_final.bf16",
                                      "batch_norm_bwd_apply.bf16"};
  record_k13(names, shapes, 3);
  return {dx, dw, db, dres};
}

// K13 backward from g = dL/dout, the design of the plan (`force` as batch_norm_plan's): out
// the forward's output (ReLU only), mean and rstd as the forward's (none: the eval fold).
// Returns (dx, dweight, dbias, dslope [1] or empty, dres or empty); dres is written when
// `residual` is set.
std::vector<at::Tensor> batch_norm_bwd(const at::Tensor& g, const at::Tensor& x,
                                       const std::optional<at::Tensor>& out,
                                       const std::optional<at::Tensor>& mean,
                                       const std::optional<at::Tensor>& rstd,
                                       const at::Tensor& weight, const at::Tensor& bias,
                                       const std::optional<at::Tensor>& slope, int64_t act,
                                       bool residual, int64_t force) {
  const at::Device dev = x.device();
  const c10::cuda::CUDAGuard guard(dev);
  const auto [N, C, HW] = check_batch_norm(x, "batch_norm_bwd: x");
  check(g, "batch_norm_bwd: g", at::kFloat, dev);
  TORCH_CHECK(g.sizes() == x.sizes(), "batch_norm_bwd: g not x's shape");
  TORCH_CHECK(act >= tris::kBatchNormActNone && act <= tris::kBatchNormActPrelu,
              "batch_norm_bwd: unknown activation ", act);
  TORCH_CHECK((act == tris::kBatchNormActRelu) == out.has_value(),
              "batch_norm_bwd: the output goes with ReLU and only with it");
  TORCH_CHECK((act == tris::kBatchNormActPrelu) == slope.has_value(),
              "batch_norm_bwd: a slope goes with PReLU and only with it");
  if (out) {
    check(*out, "batch_norm_bwd: out", at::kFloat, dev);
    TORCH_CHECK(out->sizes() == x.sizes(), "batch_norm_bwd: out not x's shape");
  }
  TORCH_CHECK(mean.has_value() == rstd.has_value(), "batch_norm_bwd: mean and rstd go together");
  if (mean) {
    check_channels(*mean, "batch_norm_bwd: mean", dev, C);
    check_channels(*rstd, "batch_norm_bwd: rstd", dev, C);
  }
  check_channels(weight, "batch_norm_bwd: weight", dev, C);
  check_channels(bias, "batch_norm_bwd: bias", dev, C);
  if (slope) check_channels(*slope, "batch_norm_bwd: slope", dev, 1);
  const tris::BatchNormPlan plan = tris::batch_norm_device_plan(
      N, C, HW, mean.has_value(), true, (int)act, (int)force);
  const bool fused = plan.design == tris::kBatchNormFused;
  const int64_t warps = (int64_t)C * N * tris::batch_norm_slices(HW);
  at::Tensor partial = at::empty({(fused ? 0 : warps * 3) + (slope ? C : 0)},
                                 x.options().dtype(at::kDouble));
  at::Tensor coef = fused ? at::Tensor() : at::empty({2, C}, x.options());
  at::Tensor dx = at::empty_like(x), dw = at::empty({C}, x.options()),
             db = at::empty({C}, x.options());
  at::Tensor dslope = slope ? at::empty({1}, x.options()) : at::Tensor();
  at::Tensor dres = residual ? at::empty_like(x) : at::Tensor();
  tris::BatchNormLaunchShape shapes[3] = {};
  launched(tris::batch_norm_bwd(plan, g.data_ptr<float>(), x.data_ptr<float>(), ptr<float>(out),
                                ptr<float>(mean), ptr<float>(rstd), weight.data_ptr<float>(),
                                bias.data_ptr<float>(), ptr<float>(slope),
                                partial.data_ptr<double>(),
                                fused ? nullptr : coef.data_ptr<float>(), dw.data_ptr<float>(),
                                db.data_ptr<float>(), slope ? dslope.data_ptr<float>() : nullptr,
                                dx.data_ptr<float>(), residual ? dres.data_ptr<float>() : nullptr,
                                N, C, HW, (int)act, stream(), shapes),
           "batch_norm_bwd");
  static const char* const fused_names[] = {"batch_norm_bwd_fused", "batch_norm_bwd_slope"};
  static const char* const two_pass_names[] = {"batch_norm_bwd_partial", "batch_norm_bwd_final",
                                               "batch_norm_bwd_apply"};
  record_k13(fused ? fused_names : two_pass_names, shapes, plan.launches);
  return {dx, dw, db, dslope, dres};
}

// K13 across ranks (kernels/batch_norm.py): the two-pass design's stages apart, so that the
// per-sample partials of every rank can be gathered between them.

// The forward's partial launch: x [N, C, ...]; shift [C], the first value of each channel on
// rank 0. Returns partial [C, N, slices, 2] (double).
at::Tensor batch_norm_stats_partial(const at::Tensor& x, const at::Tensor& shift) {
  const c10::cuda::CUDAGuard guard(x.device());
  const auto [N, C, HW] = check_batch_norm(x, "batch_norm_stats_partial: x");
  check_channels(shift, "batch_norm_stats_partial: shift", x.device(), C);
  TORCH_CHECK((int64_t)N * HW < (1 << 24), "batch_norm_stats_partial: N * HW must be below 2^24");
  at::Tensor partial =
      at::empty({C, N, tris::batch_norm_slices(HW), 2}, x.options().dtype(at::kDouble));
  tris::BatchNormLaunchShape shape = {};
  launched(tris::batch_norm_stats_partial(x.data_ptr<float>(), shift.data_ptr<float>(),
                                          partial.data_ptr<double>(), N, C, HW, stream(), &shape),
           "batch_norm_stats_partial");
  record_k13(kStatsNames, &shape, 1);
  return partial;
}

// The forward's final launch over partial [C, N, slices, 2] of N samples (every rank's, in
// rank order) with planes of HW values: returns stats [3, C] (mean, biased var, rstd); the
// running buffers, when given, move by `momentum` with the count N * HW.
at::Tensor batch_norm_stats_final(const at::Tensor& partial, const at::Tensor& shift, int64_t HW,
                                  const std::optional<at::Tensor>& running_mean,
                                  const std::optional<at::Tensor>& running_var, double momentum,
                                  double eps) {
  const at::Device dev = partial.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(partial, "batch_norm_stats_final: partial", at::kDouble, dev);
  TORCH_CHECK(partial.dim() == 4 && partial.size(3) == 2 && HW > 0 &&
                  partial.size(2) == tris::batch_norm_slices(HW),
              "batch_norm_stats_final: expected partial [C, N, slices of HW, 2]");
  const int64_t C = partial.size(0), N = partial.size(1);
  TORCH_CHECK(N >= 1 && N <= tris::kBatchNormMaxBatch && N * HW < (1 << 24) &&
                  N * C * HW < INT32_MAX,
              "batch_norm_stats_final: N * HW must be below 2^24 and N at most ",
              tris::kBatchNormMaxBatch);
  check_channels(shift, "batch_norm_stats_final: shift", dev, C);
  TORCH_CHECK(running_mean.has_value() == running_var.has_value(),
              "batch_norm_stats_final: give both running buffers or neither");
  if (running_mean) {
    check_channels(*running_mean, "batch_norm_stats_final: running_mean", dev, C);
    check_channels(*running_var, "batch_norm_stats_final: running_var", dev, C);
  }
  at::Tensor stats = at::empty({3, C}, partial.options().dtype(at::kFloat));
  tris::BatchNormLaunchShape shape = {};
  launched(tris::batch_norm_stats_final(shift.data_ptr<float>(), 1, partial.data_ptr<double>(),
                                        stats.data_ptr<float>(), ptr<float>(running_mean),
                                        ptr<float>(running_var), N, C, HW, momentum, eps,
                                        stream(), &shape),
           "batch_norm_stats_final");
  record_k13(kStatsNames + 1, &shape, 1);
  return stats;
}

void check_bwd_args(const at::Tensor& g, const at::Tensor& x, const std::optional<at::Tensor>& out,
                    const at::Tensor& mean, const at::Tensor& rstd, const at::Tensor& weight,
                    const at::Tensor& bias, const std::optional<at::Tensor>& slope, int64_t act,
                    int C, const char* name) {
  const at::Device dev = x.device();
  check(g, name, at::kFloat, dev);
  TORCH_CHECK(g.sizes() == x.sizes(), name, ": g not x's shape");
  TORCH_CHECK(act >= tris::kBatchNormActNone && act <= tris::kBatchNormActPrelu, name,
              ": unknown activation ", act);
  TORCH_CHECK((act == tris::kBatchNormActRelu) == out.has_value(), name,
              ": the output goes with ReLU and only with it");
  TORCH_CHECK((act == tris::kBatchNormActPrelu) == slope.has_value(), name,
              ": a slope goes with PReLU and only with it");
  if (out) {
    check(*out, name, at::kFloat, dev);
    TORCH_CHECK(out->sizes() == x.sizes(), name, ": out not x's shape");
  }
  for (const at::Tensor* t : {&mean, &rstd, &weight, &bias}) check_channels(*t, name, dev, C);
  if (slope) check_channels(*slope, name, dev, 1);
}

const char* const kBwdNames[] = {"batch_norm_bwd_partial", "batch_norm_bwd_final",
                                 "batch_norm_bwd_apply"};

// The backward's partial launch, as batch_norm_bwd's two-pass design: returns partial [C, N,
// slices, 3] (double) of this rank's samples.
at::Tensor batch_norm_bwd_partial(const at::Tensor& g, const at::Tensor& x,
                                  const std::optional<at::Tensor>& out, const at::Tensor& mean,
                                  const at::Tensor& rstd, const at::Tensor& weight,
                                  const at::Tensor& bias, const std::optional<at::Tensor>& slope,
                                  int64_t act) {
  const c10::cuda::CUDAGuard guard(x.device());
  const auto [N, C, HW] = check_batch_norm(x, "batch_norm_bwd_partial: x");
  check_bwd_args(g, x, out, mean, rstd, weight, bias, slope, act, C, "batch_norm_bwd_partial");
  at::Tensor partial =
      at::empty({C, N, tris::batch_norm_slices(HW), 3}, x.options().dtype(at::kDouble));
  tris::BatchNormLaunchShape shape = {};
  launched(tris::batch_norm_bwd_partial(g.data_ptr<float>(), x.data_ptr<float>(), ptr<float>(out),
                                        mean.data_ptr<float>(), rstd.data_ptr<float>(),
                                        weight.data_ptr<float>(), bias.data_ptr<float>(),
                                        ptr<float>(slope), partial.data_ptr<double>(), N, C, HW,
                                        (int)act, stream(), &shape),
           "batch_norm_bwd_partial");
  record_k13(kBwdNames, &shape, 1);
  return partial;
}

// The backward's final launch over partial [C, N, slices, 3] of N samples with planes of HW
// values: returns (coef [2, C], dweight [C], dbias [C], slope sums [C] double or empty).
std::vector<at::Tensor> batch_norm_bwd_final(const at::Tensor& partial, int64_t HW, bool slope) {
  const at::Device dev = partial.device();
  const c10::cuda::CUDAGuard guard(dev);
  check(partial, "batch_norm_bwd_final: partial", at::kDouble, dev);
  TORCH_CHECK(partial.dim() == 4 && partial.size(3) == 3 && HW > 0 &&
                  partial.size(2) == tris::batch_norm_slices(HW) && partial.size(1) >= 1 &&
                  partial.size(1) * partial.size(0) * HW < INT32_MAX,
              "batch_norm_bwd_final: expected partial [C, N, slices of HW, 3]");
  const int64_t C = partial.size(0), N = partial.size(1);
  const at::TensorOptions o = partial.options().dtype(at::kFloat);
  at::Tensor coef = at::empty({2, C}, o), dw = at::empty({C}, o), db = at::empty({C}, o);
  at::Tensor sums = slope ? at::empty({C}, partial.options()) : at::Tensor();
  tris::BatchNormLaunchShape shape = {};
  launched(tris::batch_norm_bwd_final(partial.data_ptr<double>(), coef.data_ptr<float>(),
                                      dw.data_ptr<float>(), db.data_ptr<float>(),
                                      slope ? sums.data_ptr<double>() : nullptr, N, C, HW,
                                      stream(), &shape),
           "batch_norm_bwd_final");
  record_k13(kBwdNames + 1, &shape, 1);
  return {coef, dw, db, sums};
}

// The backward's apply launch from coef [2, C] and, with PReLU, the slope sums [C] (double):
// returns (dx, dslope [1] or empty, dres or empty); dres is written when `residual` is set.
std::vector<at::Tensor> batch_norm_bwd_apply(
    const at::Tensor& g, const at::Tensor& x, const std::optional<at::Tensor>& out,
    const at::Tensor& mean, const at::Tensor& rstd, const at::Tensor& weight,
    const at::Tensor& bias, const std::optional<at::Tensor>& slope, const at::Tensor& coef,
    const std::optional<at::Tensor>& slope_sums, int64_t act, bool residual) {
  const at::Device dev = x.device();
  const c10::cuda::CUDAGuard guard(dev);
  const auto [N, C, HW] = check_batch_norm(x, "batch_norm_bwd_apply: x");
  check_bwd_args(g, x, out, mean, rstd, weight, bias, slope, act, C, "batch_norm_bwd_apply");
  check_channels(coef, "batch_norm_bwd_apply: coef", dev, 2 * C);
  TORCH_CHECK(slope.has_value() == slope_sums.has_value(),
              "batch_norm_bwd_apply: the slope sums go with a slope and only with it");
  if (slope_sums) {
    check(*slope_sums, "batch_norm_bwd_apply: slope_sums", at::kDouble, dev);
    TORCH_CHECK(slope_sums->numel() == C, "batch_norm_bwd_apply: expected [C] slope sums");
  }
  at::Tensor dx = at::empty_like(x);
  at::Tensor dslope = slope ? at::empty({1}, x.options()) : at::Tensor();
  at::Tensor dres = residual ? at::empty_like(x) : at::Tensor();
  tris::BatchNormLaunchShape shape = {};
  launched(tris::batch_norm_bwd_apply(
               g.data_ptr<float>(), x.data_ptr<float>(), ptr<float>(out), mean.data_ptr<float>(),
               rstd.data_ptr<float>(), weight.data_ptr<float>(), bias.data_ptr<float>(),
               ptr<float>(slope), coef.data_ptr<float>(),
               slope_sums ? slope_sums->data_ptr<double>() : nullptr,
               slope ? dslope.data_ptr<float>() : nullptr, dx.data_ptr<float>(),
               residual ? dres.data_ptr<float>() : nullptr, N, C, HW, (int)act, stream(), &shape),
           "batch_norm_bwd_apply");
  record_k13(kBwdNames + 2, &shape, 1);
  return {dx, dslope, dres};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("mha_short", &mha_short, "K1: short-sequence multi-head attention");
  m.def("mha_short_bf16", &mha_short_bf16, "K1 on bfloat16 q, k, v (--bf16)");
  m.def("mha_short_bwd", &mha_short_bwd, "K1 backward");
  m.def("mha_short_bwd_bf16", &mha_short_bwd_bf16, "K1 backward on bfloat16 q, k, v (--bf16)");
  m.def("mha_short_takes", &mha_short_takes, "K1: whether its kernels take (Lq, Lk, hd)");
  m.def("mha_short_launch_shape", &mha_short_launch_shape, "K1: its last launch's grid");
  m.def("cross_attn", &cross_attn, "K2: BilateralPrompt cross-attention");
  m.def("cross_attn_bf16", &cross_attn_bf16, "K2 on bfloat16 text projections (--bf16)");
  m.def("cross_attn_bwd", &cross_attn_bwd, "K2 backward (one sentence per image)");
  m.def("cross_attn_bwd_bf16", &cross_attn_bwd_bf16, "K2 backward on cross_attn_bf16's operands");
  m.def("cross_attn_takes", &cross_attn_takes, "K2: whether its kernels take width m");
  m.def("cross_attn_launch_shape", &cross_attn_launch_shape, "K2: its last launch's grid");
  m.def("response_head", &response_head, "K3: stage-1 response head");
  m.def("response_head_bf16", &response_head_bf16, "K3 on bfloat16 operands (--bf16)");
  m.def("response_head_plan", &response_head_plan, "K3: the cluster a pair takes");
  m.def("response_head_launch_shape", &response_head_launch_shape, "K3: its last launch's grid");
  m.def("stage1_head", &stage1_head, "K3: stage-1 training head");
  m.def("stage1_head_bwd", &stage1_head_bwd, "K3: stage-1 training head, backward");
  m.def("stage1_head_bf16", &stage1_head_bf16, "K3's training head on bfloat16 (--bf16)");
  m.def("stage1_head_bwd_bf16", &stage1_head_bwd_bf16, "K3's training head backward, bfloat16");
  m.def("stage1_head_bf16_smem", &stage1_head_bf16_smem,
        "K3's bfloat16 training head: a launch's shared memory");
  m.def("stage1_head_plan", &stage1_head_plan, "K3: the cluster an image takes in training");
  m.def("stage1_head_launch_shape", &stage1_head_launch_shape,
        "K3: its training head's last launch's grid");
  m.def("eval_metrics", &eval_metrics, "K4: eval resize, normalise and metrics");
  m.def("eval_metrics_plan", &eval_metrics_plan, "K4: the cluster a map takes on this card");
  m.def("eval_metrics_launch_shape", &eval_metrics_launch_shape, "K4: its last launch's grid");
  m.def("critic_input", &critic_input, "K5: the critic's resized, modulated patch matrix");
  m.def("critic_input_bwd", &critic_input_bwd, "K5 backward, to the maps");
  m.def("critic_input_bwd_plan", &critic_input_bwd_plan, "K5 backward's plan for a shape");
  m.def("critic_input_bwd_launch_shape", &critic_input_bwd_launch_shape,
        "K5 backward's last launch");
  m.def("normalize_u8", &normalize_u8, "K6: u8 NHWC image to normalised f32 NCHW");
  m.def("bilinear_resize", &bilinear_resize, "K6: bilinear resize of a stack of planes");
  m.def("bilinear_resize_plan", &bilinear_resize_plan, "K6: the bands and tiles a resize takes");
  m.def("bilinear_resize_launch_shape", &bilinear_resize_launch_shape,
        "K6: its last forward launch's grid");
  m.def("path_max_affinity", &path_max_affinity, "K7: 1 - max(edge along each pair's path)");
  m.def("bilinear_resize_bwd", &bilinear_resize_bwd, "K6 backward: the resize's adjoint");
  m.def("bilinear_resize_bwd_plan", &bilinear_resize_bwd_plan,
        "K6 backward: the bands a resize's adjoint takes");
  m.def("bilinear_resize_bwd_launch_shape", &bilinear_resize_bwd_launch_shape,
        "K6 backward: its last launch's grid");
  m.def("path_max_affinity_bwd", &path_max_affinity_bwd, "K7 backward, ties split evenly");
  m.def("path_tile_plan", &path_tile_plan, "K7's tiles: the blocks a fused loss or K7 takes");
  m.def("path_max_forward_plan", &path_max_forward_plan, "K7's forward: tiled or direct, tiles");
  m.def("path_max_affinity_launch_shape", &path_max_affinity_launch_shape,
        "K7's last forward launch: kernel, grid, shared memory");
  m.def("irn_affinity_loss", &irn_affinity_loss, "K7 + K8: IRN's loss sums and pair counts");
  m.def("irn_affinity_loss_bwd", &irn_affinity_loss_bwd, "K7 + K8 backward: d edge and d dp");
  m.def("refine_centroids", &refine_centroids, "K9: centroid refinement by displacement");
  m.def("refine_centroids_plan", &refine_centroids_plan, "K9's plan for a grid");
  m.def("walk_transition", &walk_transition, "K10: the walk's column-normalised transition");
  m.def("walk_square", &walk_square, "K10: the walk's squarings on the FP64 tensor cores");
  m.def("walk_thin", &walk_thin, "K10: the walk's thin step, summed in double");
  m.def("walk_tile_occupancy", &walk_tile_occupancy, "K10: the operands' tile occupancy maps");
  m.def("pixel_attn", &pixel_attn, "K11: PixelAttention's pixel-word attention");
  m.def("pixel_attn_bwd", &pixel_attn_bwd, "K11 backward: dq, dLk, dLv");
  m.def("pixel_attn_takes", &pixel_attn_takes, "K11: whether its kernels take (T, C, S)");
  m.def("pixel_attn_launch_shape", &pixel_attn_launch_shape, "K11: its last launch's grid");
  m.def("ema_update", &ema_update, "K12: the EMA teacher update over a leaf table");
  m.def("batch_norm_plan", &batch_norm_plan, "K13: the design a call takes on this card");
  m.def("batch_norm_launch_shape", &batch_norm_launch_shape, "K13: a kernel's last launch");
  m.def("batch_norm_fwd", &batch_norm_fwd, "K13: the train forward, y and the statistics");
  m.def("batch_norm_stats", &batch_norm_stats, "K13: BatchNorm's batch statistics (two-pass)");
  m.def("batch_norm_apply", &batch_norm_apply, "K13: the norm, its affine and activation");
  m.def("batch_norm_fwd_bf16", &batch_norm_fwd_bf16, "K13 train forward on bfloat16 (--bf16)");
  m.def("batch_norm_bwd_bf16", &batch_norm_bwd_bf16, "K13 train backward on bfloat16 (--bf16)");
  m.def("batch_norm_fold_bf16", &batch_norm_fold_bf16, "K13: the eval fold in bfloat16 (--bf16)");
  m.def("batch_norm_bwd", &batch_norm_bwd, "K13 backward: dx, dweight, dbias, dslope, dres");
  m.def("batch_norm_stats_partial", &batch_norm_stats_partial,
        "K13 across ranks: a rank's per-sample partial sums of the statistics");
  m.def("batch_norm_stats_final", &batch_norm_stats_final,
        "K13 across ranks: the statistics of every rank's partials");
  m.def("batch_norm_bwd_partial", &batch_norm_bwd_partial,
        "K13 across ranks: a rank's per-sample partial sums of the backward");
  m.def("batch_norm_bwd_final", &batch_norm_bwd_final,
        "K13 across ranks: the backward's coefficients and sums of given partials");
  m.def("batch_norm_bwd_apply", &batch_norm_bwd_apply,
        "K13 across ranks: dx from the backward's coefficients");
}
