// tris_jpeg: fused JPEG decode + Pillow-exact bilinear resize + normalize.
//
// The host input pipeline (tris_tpu_torch/data/transforms.py, mirroring the
// reference's dataset/transform.py:57-63) decodes a JPEG with PIL, resizes it
// to size x size with PIL's bilinear resampler, scales to [0, 1] and
// normalizes with ImageNet stats. PERF_NOTES measured that chain at
// ~80 img/s/core — enough for one chip per 8-core host but not for denser
// deployments. This file is the native lever: one C call per image doing
//
//   JPEG bytes -> RGB uint8 (libjpeg, default ISLOW DCT — the same library
//                 and settings PIL uses, so the decode is byte-identical)
//   -> Pillow's exact two-pass fixed-point bilinear resample (Resample.c
//      semantics: triangle filter; double-precision coefficient windows
//      converted to INT32 at PRECISION_BITS = 22; uint8 rounding/clipping
//      between the horizontal and vertical passes)
//   -> ((v / 255) - mean) / std into float32, same f32 operation order as
//      the numpy chain -> bit-identical output (tests/test_torch_native.py).
//
// "fast" mode additionally lets libjpeg reconstruct at the smallest DCT
// scale m/8 whose scaled dims still cover the target before resampling —
// NOT byte-identical to PIL (a documented, test-cross-validated
// approximation) but skips most of the IDCT work for large downscales.
//
// Unsupported inputs (CMYK/YCCK jpegs, truncated files) return an error; the
// binding returns None for them and the caller decodes that file with PIL
// (tris_tpu_torch/native/__init__.py, tris_tpu_torch/data/transforms.py).
//
// Build: tris_tpu_torch/native/__init__.py compiles this with tris_native.cpp
// and links -ljpeg when <jpeglib.h> is present; otherwise the entry points
// compile to stubs that report "unavailable" (tris_jpeg_available() == 0).
// A copy of the JAX package's native/tris_jpeg.cpp.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef TRIS_HAVE_JPEG
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Pillow-exact bilinear resampling (Pillow src/libImaging/Resample.c)
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// precompute_coeffs for the triangle (bilinear, support=1) filter. Returns
// ksize; fills bounds[out*2] = (min, count) and kk[out*ksize] INT32 weights.
int precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                      std::vector<int32_t>* kk) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds->resize(static_cast<size_t>(out_size) * 2);
  kk->assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> prekk(ksize);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    // Pillow rounds the window bounds by +0.5 truncation
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      double w = (x + xmin - center + 0.5) * ss;
      w = w < 0 ? -w : w;
      prekk[x] = w < 1.0 ? 1.0 - w : 0.0;  // triangle filter
      ww += prekk[x];
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) prekk[x] /= ww;
    }
    int32_t* k = kk->data() + static_cast<size_t>(xx) * ksize;
    for (int x = 0; x < xmax; x++) {
      // Pillow normalize_coeffs_8bpc: round-half-away-from-zero to INT32
      k[x] = static_cast<int32_t>(prekk[x] < 0
                                      ? -0.5 + prekk[x] * (1 << kPrecisionBits)
                                      : 0.5 + prekk[x] * (1 << kPrecisionBits));
    }
    (*bounds)[xx * 2] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  return ksize;
}

// in [h, w, c] u8 -> out [h, ow, c] u8
void resample_horizontal(const uint8_t* in, int h, int w, int c, int ow,
                         const int* bounds, const int32_t* kk, int ksize,
                         uint8_t* out) {
  for (int y = 0; y < h; y++) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * c;
    uint8_t* orow = out + static_cast<size_t>(y) * ow * c;
    for (int xx = 0; xx < ow; xx++) {
      const int xmin = bounds[xx * 2];
      const int xmax = bounds[xx * 2 + 1];
      const int32_t* k = kk + static_cast<size_t>(xx) * ksize;
      if (c == 3) {
        // one pass over the taps for all 3 channels (sequential reads)
        int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        const uint8_t* p = row + static_cast<size_t>(xmin) * 3;
        for (int x = 0; x < xmax; x++, p += 3) {
          const int32_t kx = k[x];
          s0 += p[0] * kx;
          s1 += p[1] * kx;
          s2 += p[2] * kx;
        }
        uint8_t* o = orow + static_cast<size_t>(xx) * 3;
        o[0] = clip8(s0);
        o[1] = clip8(s1);
        o[2] = clip8(s2);
      } else {
        for (int ch = 0; ch < c; ch++) {
          int ss = 1 << (kPrecisionBits - 1);
          const uint8_t* p = row + static_cast<size_t>(xmin) * c + ch;
          for (int x = 0; x < xmax; x++) ss += p[static_cast<size_t>(x) * c] * k[x];
          orow[static_cast<size_t>(xx) * c + ch] = clip8(ss);
        }
      }
    }
  }
}

// in [h, w, c] u8 -> out [oh, w, c] u8
void resample_vertical(const uint8_t* in, int h, int w, int c, int oh,
                       const int* bounds, const int32_t* kk, int ksize,
                       uint8_t* out) {
  const size_t stride = static_cast<size_t>(w) * c;
  for (int yy = 0; yy < oh; yy++) {
    const int ymin = bounds[yy * 2];
    const int ymax = bounds[yy * 2 + 1];
    const int32_t* k = kk + static_cast<size_t>(yy) * ksize;
    uint8_t* orow = out + static_cast<size_t>(yy) * stride;
    for (size_t x = 0; x < stride; x++) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; y++) ss += in[(ymin + y) * stride + x] * k[y];
      orow[x] = clip8(ss);
    }
  }
}

// Vertical pass fused with normalization: each output u8 value (identical to
// resample_vertical's clip8 result) maps through a per-channel 256-entry LUT
// holding ((v / 255) - mean) / std in float32 — the exact value the numpy
// chain computes for that u8, so fusing preserves bit-identity while saving
// a full extra pass over the image.
void resample_vertical_norm(const uint8_t* in, int h, int w, int c, int oh,
                            const int* bounds, const int32_t* kk, int ksize,
                            const float* lut /* [c][256] */, float* out) {
  const size_t stride = static_cast<size_t>(w) * c;
  for (int yy = 0; yy < oh; yy++) {
    const int ymin = bounds[yy * 2];
    const int ymax = bounds[yy * 2 + 1];
    const int32_t* k = kk + static_cast<size_t>(yy) * ksize;
    float* orow = out + static_cast<size_t>(yy) * stride;
    int ch = 0;
    for (size_t x = 0; x < stride; x++) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; y++) ss += in[(ymin + y) * stride + x] * k[y];
      orow[x] = lut[ch * 256 + clip8(ss)];
      if (++ch == c) ch = 0;
    }
  }
}

// Full two-pass resize (horizontal then vertical, as ImagingResample does).
void resize_u8(const uint8_t* in, int h, int w, int c, int oh, int ow,
               uint8_t* out) {
  if (oh == h && ow == w) {
    std::memcpy(out, in, static_cast<size_t>(h) * w * c);
    return;
  }
  std::vector<int> bounds;
  std::vector<int32_t> kk;
  if (ow != w && oh != h) {
    std::vector<uint8_t> tmp(static_cast<size_t>(h) * ow * c);
    int ks = precompute_coeffs(w, ow, &bounds, &kk);
    resample_horizontal(in, h, w, c, ow, bounds.data(), kk.data(), ks, tmp.data());
    ks = precompute_coeffs(h, oh, &bounds, &kk);
    resample_vertical(tmp.data(), h, ow, c, oh, bounds.data(), kk.data(), ks, out);
  } else if (ow != w) {
    int ks = precompute_coeffs(w, ow, &bounds, &kk);
    resample_horizontal(in, h, w, c, ow, bounds.data(), kk.data(), ks, out);
  } else {
    int ks = precompute_coeffs(h, oh, &bounds, &kk);
    resample_vertical(in, h, w, c, oh, bounds.data(), kk.data(), ks, out);
  }
}

#ifdef TRIS_HAVE_JPEG

// ---------------------------------------------------------------------------
// libjpeg decode (error-manager longjmp so corrupt files return, not exit)
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf env;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->env, 1);
}

void jpeg_silent(j_common_ptr, int) {}

// Decode to RGB u8. fast: pick the smallest DCT scale m/8 (m in 1..8) whose
// scaled dims are >= (min_h, min_w); 0 = full scale (PIL-exact).
// Returns 0 ok, -1 decode error / unsupported colorspace.
int decode_rgb(const uint8_t* buf, size_t len, int fast, int min_h, int min_w,
               std::vector<uint8_t>* out, int* h, int* w, int* orig_h,
               int* orig_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  jerr.pub.emit_message = jpeg_silent;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *orig_h = cinfo.image_height;
  *orig_w = cinfo.image_width;
  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    // PIL applies an Adobe-inversion dance here; punt to the PIL fallback
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;  // gray sources convert in-library
  if (fast && min_h > 0 && min_w > 0) {
    int m = 8;
    for (int cand = 1; cand <= 8; cand++) {
      long sh = (static_cast<long>(cinfo.image_height) * cand + 7) / 8;
      long sw = (static_cast<long>(cinfo.image_width) * cand + 7) / 8;
      if (sh >= min_h && sw >= min_w) {
        m = cand;
        break;
      }
    }
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  out->resize(static_cast<size_t>(*h) * *w * 3);
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW rows[1] = {out->data() + cinfo.output_scanline * stride};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

#endif  // TRIS_HAVE_JPEG

}  // namespace

extern "C" {

int tris_jpeg_available(void) {
#ifdef TRIS_HAVE_JPEG
  return 1;
#else
  return 0;
#endif
}

// Pillow-exact bilinear resize, u8 [h, w, c] -> [oh, ow, c].
void tris_resize_bilinear_u8(const uint8_t* in, int h, int w, int c, int oh,
                             int ow, uint8_t* out) {
  resize_u8(in, h, w, c, oh, ow, out);
}

// Probe a JPEG's dimensions. Returns 0 ok, -1 error, -2 not compiled in.
int tris_jpeg_probe(const uint8_t* buf, size_t len, int32_t* h, int32_t* w) {
#ifdef TRIS_HAVE_JPEG
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  jerr.pub.emit_message = jpeg_silent;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
#else
  (void)buf; (void)len; (void)h; (void)w;
  return -2;
#endif
}

// Full-scale decode to RGB u8 into caller buffer sized [h, w, 3] from
// tris_jpeg_probe. Byte-identical to PIL's Image.open().convert("RGB") for
// RGB/grayscale baseline+progressive JPEGs (same libjpeg algorithm family).
// Returns 0 ok, -1 error, -2 not compiled in.
int tris_jpeg_decode_u8(const uint8_t* buf, size_t len, uint8_t* out) {
#ifdef TRIS_HAVE_JPEG
  std::vector<uint8_t> px;
  int h, w, oh, ow;
  int rc = decode_rgb(buf, len, 0, 0, 0, &px, &h, &w, &oh, &ow);
  if (rc != 0) return rc;
  std::memcpy(out, px.data(), px.size());
  return 0;
#else
  (void)buf; (void)len; (void)out;
  return -2;
#endif
}

// Fused decode + square bilinear resize to [size, size] + normalize:
//   out[y, x, ch] = ((v / 255) - mean[ch]) / stdv[ch]   (float32 ops, the
// numpy chain's exact operation order). mean/stdv may be null for raw [0, 1].
// fast != 0 enables DCT-domain scaling (approximate, see header comment).
// orig_hw receives the pre-resize image size. Returns 0 ok, -1 decode error
// (caller should fall back to PIL), -2 not compiled in.
int tris_jpeg_decode_resize_norm(const uint8_t* buf, size_t len, int size,
                                 const float* mean, const float* stdv, int fast,
                                 float* out, int32_t* orig_hw) {
#ifdef TRIS_HAVE_JPEG
  std::vector<uint8_t> px;
  int h, w, oh, ow;
  int rc = decode_rgb(buf, len, fast, size, size, &px, &h, &w, &oh, &ow);
  if (rc != 0) return rc;
  orig_hw[0] = oh;
  orig_hw[1] = ow;
  // ((v / 255) - mean) / std for every u8 v, per channel — exact f32 op order
  // of the numpy chain, so indexing the LUT preserves bit-identity.
  float lut[3 * 256];
  for (int ch = 0; ch < 3; ch++) {
    for (int v = 0; v < 256; v++) {
      float f = static_cast<float>(v) / 255.0f;
      if (mean != nullptr) f = (f - mean[ch]) / stdv[ch];
      lut[ch * 256 + v] = f;
    }
  }
  std::vector<int> bounds;
  std::vector<int32_t> kk;
  if (h == size && w == size) {
    int chn = 0;
    const size_t n = px.size();
    for (size_t i = 0; i < n; i++) {
      out[i] = lut[chn * 256 + px[i]];
      if (++chn == 3) chn = 0;
    }
    return 0;
  }
  if (w != size) {
    std::vector<uint8_t> tmp(static_cast<size_t>(h) * size * 3);
    int ks = precompute_coeffs(w, size, &bounds, &kk);
    resample_horizontal(px.data(), h, w, 3, size, bounds.data(), kk.data(), ks,
                        tmp.data());
    px.swap(tmp);
    w = size;
  }
  if (h != size) {
    int ks = precompute_coeffs(h, size, &bounds, &kk);
    resample_vertical_norm(px.data(), h, size, 3, size, bounds.data(),
                           kk.data(), ks, lut, out);
  } else {
    // horizontal-only resize: normalize in a final LUT pass
    int chn = 0;
    const size_t n = static_cast<size_t>(size) * size * 3;
    for (size_t i = 0; i < n; i++) {
      out[i] = lut[chn * 256 + px[i]];
      if (++chn == 3) chn = 0;
    }
  }
  return 0;
#else
  (void)buf; (void)len; (void)size; (void)mean; (void)stdv; (void)fast;
  (void)out; (void)orig_hw;
  return -2;
#endif
}

// Fused decode + square bilinear resize to [size, size, 3] uint8 (NO
// normalize) — the u8 feed's host half (normalization happens on the card,
// K6). Byte-identical to PIL decode ->
// resize(BILINEAR) (same fixed-point resampler as tris_resize_bilinear_u8).
// fast != 0 enables DCT-domain scaling (approximate). orig_hw receives the
// pre-resize size. Returns 0 ok, -1 decode error, -2 not compiled in.
int tris_jpeg_decode_resize_u8(const uint8_t* buf, size_t len, int size,
                               int fast, uint8_t* out, int32_t* orig_hw) {
#ifdef TRIS_HAVE_JPEG
  std::vector<uint8_t> px;
  int h, w, oh, ow;
  int rc = decode_rgb(buf, len, fast, size, size, &px, &h, &w, &oh, &ow);
  if (rc != 0) return rc;
  orig_hw[0] = oh;
  orig_hw[1] = ow;
  if (h == size && w == size) {
    std::memcpy(out, px.data(), px.size());
    return 0;
  }
  resize_u8(px.data(), h, w, 3, size, size, out);
  return 0;
#else
  (void)buf; (void)len; (void)size; (void)fast; (void)out; (void)orig_hw;
  return -2;
#endif
}

}  // extern "C"
