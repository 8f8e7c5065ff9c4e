// PyTorch bindings of the kernels in this directory, built by
// torch.utils.cpp_extension (../build.py). Each op checks where and how its
// tensors lie, allocates its outputs, launches on the current stream of its
// inputs' device and raises if the launch fails. Shapes are checked by the
// Python wrappers beside build.py, which are the only callers.

#include <optional>
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

void launched(cudaError_t err, const char* name) {
  TORCH_CHECK(err == cudaSuccess, name, ": CUDA launch failed: ", cudaGetErrorString(err));
}

cudaStream_t stream() { return at::cuda::getCurrentCUDAStream().stream(); }

template <typename T>
T* ptr(const std::optional<at::Tensor>& t) {
  return t ? t->data_ptr<T>() : nullptr;
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
                           k.stride(1), v.stride(0), v.stride(1), (float)scale, stream()),
           "mha_short");
  return out;
}

// K2: qv, kv, vv [N, HW, m]; qt, kt, vt [N*S, T, m]. Returns (new_vis
// [N*S, HW, m], new_lan [N*S, T, m]).
std::vector<at::Tensor> cross_attn(const at::Tensor& qv, const at::Tensor& kv,
                                   const at::Tensor& vv, const at::Tensor& qt,
                                   const at::Tensor& kt, const at::Tensor& vt, int64_t S,
                                   double div) {
  const at::Device dev = qv.device();
  const c10::cuda::CUDAGuard guard(dev);
  for (const at::Tensor* t : {&qv, &kv, &vv, &qt, &kt, &vt})
    check(*t, "cross_attn", at::kFloat, dev);
  const int64_t HW = qv.size(1), m = qv.size(2), P = qt.size(0), T = qt.size(1);
  at::Tensor new_vis = at::empty({P, HW, m}, qv.options());
  at::Tensor new_lan = at::empty({P, T, m}, qv.options());
  launched(tris::cross_attn(qv.data_ptr<float>(), kv.data_ptr<float>(), vv.data_ptr<float>(),
                            qt.data_ptr<float>(), kt.data_ptr<float>(), vt.data_ptr<float>(),
                            new_vis.data_ptr<float>(), new_lan.data_ptr<float>(), P, HW, T, m,
                            S, (float)div, stream()),
           "cross_attn");
  return {new_vis, new_lan};
}

// K3: vis_new [N*S, h*w, D] or None; vis_base [N, h*w, D]; lan [N*S, D];
// scale a 0-d tensor; ty, tx the taps to [H] rows and [W] columns.
// Returns [N*S, H, W].
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
                               x.lo, x.hi, x.w0, x.w1, stream()),
           "response_head");
  return out;
}

// K4: cams [B, S, h, w]; ty [B, maxH] x4, tx [B, maxW] x4; orig_hw [B, 2]
// int32. With targets [B, maxH, maxW] uint8 and boxes [B, 4]: returns stats
// [B, S, 4] (I, U, hit, hitm). Without them: the normalised maps
// [B, S, maxH, maxW].
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
                              targets ? out.data_ptr<float>() : nullptr, stream()),
           "eval_metrics");
  return out;
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

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("mha_short", &mha_short, "K1: short-sequence multi-head attention");
  m.def("cross_attn", &cross_attn, "K2: BilateralPrompt cross-attention");
  m.def("response_head", &response_head, "K3: stage-1 response head");
  m.def("eval_metrics", &eval_metrics, "K4: eval resize, normalise and metrics");
  m.def("critic_input", &critic_input, "K5: the critic's resized, modulated patch matrix");
  m.def("normalize_u8", &normalize_u8, "K6: u8 NHWC image to normalised f32 NCHW");
}
