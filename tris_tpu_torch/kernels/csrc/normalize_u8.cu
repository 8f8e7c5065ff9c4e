// K6, normalise half: the u8 image feed to normalised float32 NCHW.
//
// Replaces tris_tpu/ops/normalize.py::image_input_to_f32 (lines 24-29) on
// the u8 feed, fused with the NHWC -> NCHW layout change that the port's
// convolutions take: out[b, c, y, x] = in[b, y, x, c] * scale[c] + bias[c],
// with ((v / 255) - mean) / std folded into (scale, bias) as
// tris_tpu_torch/ops/normalize.py does.
//
// Shapes on the eval and PRMS paths: [8, 320, 320, 3] u8 -> [8, 3, 320, 320]
// f32, one launch per batch.
//
// Bound: bytes - 1 byte read and 4 written per value, one multiply and one
// add. Design: one thread per pixel; a warp reads 96 consecutive bytes and
// writes three coalesced 128-byte runs, one per channel plane. The multiply
// and the add are rounded one by one (__fmul_rn, __fadd_rn): PyTorch's plain
// version is two operations, and a contracted FMA would differ by an ulp.

#include "launchers.h"

namespace {

constexpr int kThreads = 256;

struct Affine3 {
  float scale[3], bias[3];
};

__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const unsigned char* __restrict__ in, float* __restrict__ out,
                    long long n_pix, long long hw, Affine3 f) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n_pix) return;
  const unsigned char* px = in + 3 * i;
  const long long b = i / hw;
  float* o = out + 2 * b * hw + i;  // (b, 0, pixel) of [B, 3, hw]
  for (int c = 0; c < 3; ++c)
    o[c * hw] = __fadd_rn(__fmul_rn((float)px[c], f.scale[c]), f.bias[c]);
}

}  // namespace

cudaError_t tris::normalize_u8(const unsigned char* image, float* out, int64_t n_pix,
                               int64_t hw, const float* scale, const float* bias,
                               cudaStream_t stream) {
  if (n_pix == 0) return cudaSuccess;
  Affine3 f;
  for (int c = 0; c < 3; ++c) {
    f.scale[c] = scale[c];
    f.bias[c] = bias[c];
  }
  const long long blocks = (n_pix + kThreads - 1) / kThreads;
  normalize_u8_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(image, out, n_pix, hw, f);
  return cudaGetLastError();
}
