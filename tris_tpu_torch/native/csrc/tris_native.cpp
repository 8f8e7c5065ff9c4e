// tris_native: host-side native code of the PyTorch port (tris_tpu_torch).
//
// Contents:
//  - COCO RLE codec + polygon rasterization (replaces pycocotools' C core;
//    implements the COCO mask format spec, cf. tris_tpu_torch/data/mask_ops.py).
//  - 4-connectivity connected components (replaces skimage.measure.label).
//  - Dense CRF mean-field inference with permutohedral-lattice Gaussian and
//    bilateral filtering (replaces pydensecrf; Krahenbuhl & Koltun NIPS'11,
//    Adams et al. 2010 lattice). Used by the CAM->ir_label pass
//    (tris_tpu_torch/pseudo/crf.py).
//  - tris_set_num_threads: the OpenMP team the lattice's loops take, set by
//    the caller before each call (the ir-label pass runs one process per
//    core; a full team in each would oversubscribe the host). It is the
//    library's own per-thread setting, not the OpenMP runtime's, which the
//    caller's PyTorch may share.
//
// A copy of the JAX package's native/tris_native.cpp with the thread setter
// added. Build and binding: tris_tpu_torch/native/__init__.py (g++, at first
// use, into tris_tpu_torch/native/build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
namespace {
// The team of this thread's lattice loops (their num_threads clause): the
// library's own setting, so that a call leaves the process's OpenMP runtime,
// which it may share with the caller's (PyTorch's), as it was.
thread_local int g_threads = 1;
}  // namespace
#endif

extern "C" {

// The OpenMP team of this thread's later lattice loops (1: none). Returns the
// count in force, 1 in a build without OpenMP.
int tris_set_num_threads(int n) {
#ifdef _OPENMP
  g_threads = n < 1 ? 1 : n;
  return g_threads;
#else
  (void)n;
  return 1;
#endif
}

// ---------------------------------------------------------------------------
// RLE codec (column-major runs, alternating 0/1)
// ---------------------------------------------------------------------------

void tris_rle_decode(const uint32_t* counts, int n, int h, int w, uint8_t* mask_out) {
  // mask_out is row-major [h, w]; runs are column-major.
  std::memset(mask_out, 0, (size_t)h * w);
  long pos = 0;
  for (int i = 0; i < n; ++i) {
    if (i % 2 == 1) {
      for (uint32_t j = 0; j < counts[i]; ++j) {
        long p = pos + j;
        mask_out[(p % h) * (long)w + (p / h)] = 1;
      }
    }
    pos += counts[i];
  }
}

int tris_rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts_out, int max_counts) {
  // returns number of counts written, or -1 if max_counts too small.
  int n = 0;
  uint8_t cur = 0;
  uint32_t run = 0;
  for (long col = 0; col < w; ++col) {
    for (long row = 0; row < h; ++row) {
      uint8_t v = mask[row * w + col] ? 1 : 0;
      if (v == cur) {
        ++run;
      } else {
        if (n >= max_counts) return -1;
        counts_out[n++] = run;
        cur = v;
        run = 1;
      }
    }
  }
  if (n >= max_counts) return -1;
  counts_out[n++] = run;
  return n;
}

// ---------------------------------------------------------------------------
// Polygon -> RLE (COCO 5x supersampled boundary algorithm)
// ---------------------------------------------------------------------------

int tris_polygon_to_rle(const double* xy, int k, int h, int w,
                        uint32_t* counts_out, int max_counts) {
  const double scale = 5.0;
  std::vector<long> x(k + 1), y(k + 1);
  for (int j = 0; j < k; ++j) {
    x[j] = (long)(scale * xy[2 * j] + 0.5);
    y[j] = (long)(scale * xy[2 * j + 1] + 0.5);
  }
  x[k] = x[0];
  y[k] = y[0];

  // dense boundary walk at supersampled resolution
  std::vector<long> u, v;
  for (int j = 0; j < k; ++j) {
    long xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
    long dx = std::labs(xe - xs), dy = std::labs(ye - ys);
    bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
    if (flip) {
      std::swap(xs, xe);
      std::swap(ys, ye);
    }
    if (dx >= dy) {
      double s = dx ? (double)(ye - ys) / dx : 0.0;
      for (long d = 0; d <= dx; ++d) {
        long t = flip ? dx - d : d;
        u.push_back(t + xs);
        v.push_back((long)(ys + s * t + 0.5));
      }
    } else {
      double s = dy ? (double)(xe - xs) / dy : 0.0;
      for (long d = 0; d <= dy; ++d) {
        long t = flip ? dy - d : d;
        v.push_back(t + ys);
        u.push_back((long)(xs + s * t + 0.5));
      }
    }
  }

  // vertical crossings -> downsampled boundary points (column-major positions)
  std::vector<long> pos;
  for (size_t j = 1; j < u.size(); ++j) {
    if (u[j] == u[j - 1]) continue;
    double xd = (double)(u[j] < u[j - 1] ? u[j] : u[j] - 1);
    xd = (xd + 0.5) / scale - 0.5;
    if (std::floor(xd) != xd || xd < 0 || xd > w - 1) continue;
    double yd = (double)(v[j] < v[j - 1] ? v[j] : v[j - 1]);
    yd = (yd + 0.5) / scale - 0.5;
    if (yd < 0) yd = 0;
    if (yd > h) yd = h;
    yd = std::ceil(yd);
    pos.push_back((long)xd * h + (long)yd);
  }
  std::sort(pos.begin(), pos.end());
  pos.push_back((long)h * w);

  // deltas -> collapse zero runs (parity fill)
  std::vector<uint32_t> counts;
  long prev = 0;
  std::vector<long> diffs;
  for (long p : pos) {
    diffs.push_back(p - prev);
    prev = p;
  }
  size_t j = 0;
  while (j < diffs.size()) {
    long d = diffs[j];
    if (d > 0 || j == 0) {
      counts.push_back((uint32_t)d);
      ++j;
    } else {
      ++j;
      if (j < diffs.size()) {
        counts.back() += (uint32_t)diffs[j];
        ++j;
      }
    }
  }
  if ((int)counts.size() > max_counts) return -1;
  std::copy(counts.begin(), counts.end(), counts_out);
  return (int)counts.size();
}

// ---------------------------------------------------------------------------
// Connected components (4-connectivity, background = 0)
// ---------------------------------------------------------------------------

int tris_connected_components(const uint8_t* mask, int h, int w, int32_t* labels_out) {
  std::vector<int32_t> parent(1, 0);
  auto find = [&](int32_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  };
  auto unite = [&](int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  };

  for (long r = 0; r < h; ++r) {
    for (long c = 0; c < w; ++c) {
      long i = r * w + c;
      if (!mask[i]) {
        labels_out[i] = 0;
        continue;
      }
      int32_t left = (c > 0 && mask[i - 1]) ? labels_out[i - 1] : 0;
      int32_t up = (r > 0 && mask[i - w]) ? labels_out[i - w] : 0;
      if (!left && !up) {
        int32_t nl = (int32_t)parent.size();
        parent.push_back(nl);
        labels_out[i] = nl;
      } else if (left && up) {
        labels_out[i] = std::min(left, up);
        unite(left, up);
      } else {
        labels_out[i] = left ? left : up;
      }
    }
  }
  // flatten + relabel consecutively
  std::unordered_map<int32_t, int32_t> remap;
  int32_t next = 1;
  for (long i = 0; i < (long)h * w; ++i) {
    if (!labels_out[i]) continue;
    int32_t root = find(labels_out[i]);
    auto it = remap.find(root);
    if (it == remap.end()) {
      remap[root] = next;
      labels_out[i] = next++;
    } else {
      labels_out[i] = it->second;
    }
  }
  return next - 1;
}

// ---------------------------------------------------------------------------
// Permutohedral lattice (Adams et al. 2010)
// ---------------------------------------------------------------------------

namespace {

// Flat open-addressing hash table for short-vector lattice keys.
class KeyTable {
 public:
  KeyTable(int key_size, size_t expected)
      : key_size_(key_size) {
    capacity_ = 16;
    while (capacity_ < expected * 2) capacity_ <<= 1;
    slots_.assign(capacity_, -1);
    keys_.reserve(expected * key_size);
  }

  size_t hash(const short* k) const {
    size_t hsh = 14695981039346656037ull;
    for (int i = 0; i < key_size_; ++i) {
      hsh ^= (size_t)(uint16_t)k[i];
      hsh *= 1099511628211ull;
    }
    return hsh;
  }

  // insert-or-get index
  int find(const short* k, bool create) {
    size_t slot = hash(k) & (capacity_ - 1);
    while (true) {
      int idx = slots_[slot];
      if (idx < 0) {
        if (!create) return -1;
        idx = (int)(keys_.size() / key_size_);
        keys_.insert(keys_.end(), k, k + key_size_);
        slots_[slot] = idx;
        if ((size_t)idx * 2 > capacity_) grow();
        return idx;
      }
      if (std::memcmp(&keys_[(size_t)idx * key_size_], k,
                      key_size_ * sizeof(short)) == 0)
        return idx;
      slot = (slot + 1) & (capacity_ - 1);
    }
  }

  int size() const { return (int)(keys_.size() / key_size_); }
  const short* key(int i) const { return &keys_[(size_t)i * key_size_]; }

 private:
  void grow() {
    capacity_ <<= 1;
    slots_.assign(capacity_, -1);
    int n = size();
    for (int i = 0; i < n; ++i) {
      size_t slot = hash(key(i)) & (capacity_ - 1);
      while (slots_[slot] >= 0) slot = (slot + 1) & (capacity_ - 1);
      slots_[slot] = i;
    }
  }

  int key_size_;
  size_t capacity_;
  std::vector<int> slots_;
  std::vector<short> keys_;
};

class Permutohedral {
 public:
  void init(const float* features, int d, int n) {
    d_ = d;
    n_ = n;
    offset_.assign((size_t)n * (d + 1), 0);
    barycentric_.assign((size_t)n * (d + 1), 0.f);

    std::vector<float> scale_factor(d);
    const float inv_std_dev = std::sqrt(2.0f / 3.0f) * (d + 1);
    for (int i = 0; i < d; ++i)
      scale_factor[i] = 1.0f / std::sqrt((float)(i + 2) * (i + 1)) * inv_std_dev;

    KeyTable hash(d, (size_t)n * (d + 1) / 4 + 16);
    std::vector<float> elevated(d + 1);
    std::vector<float> barycentric(d + 2);
    std::vector<short> rem0(d + 1), rank(d + 1), key(d);

    for (int p = 0; p < n; ++p) {
      const float* f = features + (size_t)p * d;
      // embed into the hyperplane sum=0 (E matrix application)
      float sm = 0;
      for (int j = d; j > 0; --j) {
        float cf = f[j - 1] * scale_factor[j - 1];
        elevated[j] = sm - j * cf;
        sm += cf;
      }
      elevated[0] = sm;

      // nearest remainder-0 lattice point
      const float down_factor = 1.0f / (d + 1);
      int sum = 0;
      for (int i = 0; i <= d; ++i) {
        int rd = (int)std::round(down_factor * elevated[i]);
        rem0[i] = (short)(rd * (d + 1));
        sum += rd;
      }
      // rank differential
      std::fill(rank.begin(), rank.end(), 0);
      for (int i = 0; i < d; ++i) {
        double di = elevated[i] - rem0[i];
        for (int j = i + 1; j <= d; ++j) {
          double dj = elevated[j] - rem0[j];
          if (di < dj)
            ++rank[i];
          else
            ++rank[j];
        }
      }
      // fix out-of-bounds points
      for (int i = 0; i <= d; ++i) {
        rank[i] += sum;
        if (rank[i] < 0) {
          rank[i] += d + 1;
          rem0[i] += (short)(d + 1);
        } else if (rank[i] > d) {
          rank[i] -= d + 1;
          rem0[i] -= (short)(d + 1);
        }
      }
      // barycentric coordinates
      std::fill(barycentric.begin(), barycentric.end(), 0.f);
      for (int i = 0; i <= d; ++i) {
        float delta = (elevated[i] - rem0[i]) * down_factor;
        barycentric[d - rank[i]] += delta;
        barycentric[d - rank[i] + 1] -= delta;
      }
      barycentric[0] += 1.0f + barycentric[d + 1];

      // register the d+1 simplex vertices
      for (int rm = 0; rm <= d; ++rm) {
        for (int i = 0; i < d; ++i) {
          key[i] = rem0[i] + (short)(rank[i] >= d + 1 - rm ? rm - (d + 1) : rm);
        }
        // canonical simplex vertex: for vertex rm, coordinate i is
        // rm - (d+1) if rank[i] >= d+1-rm else rm.
        int idx = hash.find(key.data(), /*create=*/true);
        offset_[(size_t)p * (d + 1) + rm] = idx;
        barycentric_[(size_t)p * (d + 1) + rm] = barycentric[rm];
      }
    }

    m_ = hash.size();
    // neighbor structure for the blur along each of the d+1 lattice axes
    blur_n1_.assign((size_t)m_ * (d + 1), -1);
    blur_n2_.assign((size_t)m_ * (d + 1), -1);
    std::vector<short> np1(d), np2(d);
    for (int i = 0; i < m_; ++i) {
      const short* kk = hash.key(i);
      for (int j = 0; j <= d; ++j) {
        for (int t = 0; t < d; ++t) {
          np1[t] = (short)(kk[t] + 1);
          np2[t] = (short)(kk[t] - 1);
        }
        if (j < d) {
          np1[j] = (short)(kk[j] - d);
          np2[j] = (short)(kk[j] + d);
        }
        blur_n1_[(size_t)i * (d + 1) + j] = hash.find(np1.data(), false);
        blur_n2_[(size_t)i * (d + 1) + j] = hash.find(np2.data(), false);
      }
    }
  }

  // filter: out[n x vd] = K * in[n x vd]
  void compute(const float* in, float* out, int vd) const {
    std::vector<float> values((size_t)(m_ + 2) * vd, 0.f);
    std::vector<float> new_values((size_t)(m_ + 2) * vd, 0.f);

    // splat
    for (int p = 0; p < n_; ++p) {
      for (int rm = 0; rm <= d_; ++rm) {
        int o = offset_[(size_t)p * (d_ + 1) + rm] + 1;
        float wgt = barycentric_[(size_t)p * (d_ + 1) + rm];
        for (int c = 0; c < vd; ++c)
          values[(size_t)o * vd + c] += wgt * in[(size_t)p * vd + c];
      }
    }
    // blur along each lattice direction
    for (int j = 0; j <= d_; ++j) {
#pragma omp parallel for schedule(static) num_threads(g_threads)
      for (int i = 0; i < m_; ++i) {
        int n1 = blur_n1_[(size_t)i * (d_ + 1) + j] + 1;
        int n2 = blur_n2_[(size_t)i * (d_ + 1) + j] + 1;
        const float* vi = &values[(size_t)(i + 1) * vd];
        const float* v1 = &values[(size_t)n1 * vd];
        const float* v2 = &values[(size_t)n2 * vd];
        float* ni = &new_values[(size_t)(i + 1) * vd];
        for (int c = 0; c < vd; ++c) ni[c] = vi[c] + 0.5f * (v1[c] + v2[c]);
      }
      std::swap(values, new_values);
    }
    // slice (alpha corrects for the blur gain)
    const float alpha = 1.0f / (1.0f + std::pow(2.0f, -(float)d_));
#pragma omp parallel for schedule(static) num_threads(g_threads)
    for (int p = 0; p < n_; ++p) {
      for (int c = 0; c < vd; ++c) out[(size_t)p * vd + c] = 0.f;
      for (int rm = 0; rm <= d_; ++rm) {
        int o = offset_[(size_t)p * (d_ + 1) + rm] + 1;
        float wgt = barycentric_[(size_t)p * (d_ + 1) + rm];
        for (int c = 0; c < vd; ++c)
          out[(size_t)p * vd + c] += wgt * values[(size_t)o * vd + c] * alpha;
      }
    }
  }

 private:
  int d_ = 0, n_ = 0, m_ = 0;
  std::vector<int> offset_;
  std::vector<float> barycentric_;
  std::vector<int> blur_n1_, blur_n2_;
};

void normalized_filter(const Permutohedral& lattice, const float* q, float* out,
                       int n, int L, const std::vector<float>& norm) {
  // symmetric normalization: out = N^{1/2-ish} K (N q), densecrf style
  std::vector<float> tmp((size_t)n * L);
#pragma omp parallel for schedule(static) num_threads(g_threads)
  for (int p = 0; p < n; ++p)
    for (int c = 0; c < L; ++c) tmp[(size_t)p * L + c] = q[(size_t)p * L + c] * norm[p];
  lattice.compute(tmp.data(), out, L);
#pragma omp parallel for schedule(static) num_threads(g_threads)
  for (int p = 0; p < n; ++p)
    for (int c = 0; c < L; ++c) out[(size_t)p * L + c] *= norm[p];
}

std::vector<float> make_norm(const Permutohedral& lattice, int n) {
  std::vector<float> ones(n, 1.f), norm(n);
  lattice.compute(ones.data(), norm.data(), 1);
  for (int p = 0; p < n; ++p) norm[p] = 1.0f / std::sqrt(std::max(norm[p], 1e-20f));
  return norm;
}

}  // namespace

// K independent mean-field problems over the SAME image share the lattice
// construction (the dominant cost) and run fused: one splat/blur/slice per
// kernel per iteration over all K*L channels. unary/q_out: [K, L, h*w].
void tris_dense_crf_multi(const uint8_t* img, const float* unary, int K, int h,
                          int w, int L, int n_iters, float gxy, float gcompat,
                          float bxy, float brgb, float bcompat, float* q_out) {
  const int n = h * w;
  const int C = K * L;  // fused channel count

  // build lattices (once for all K problems)
  std::vector<float> feat_g((size_t)n * 2);
  std::vector<float> feat_b((size_t)n * 5);
  for (int r = 0; r < h; ++r) {
    for (int c = 0; c < w; ++c) {
      int p = r * w + c;
      feat_g[(size_t)p * 2 + 0] = c / gxy;
      feat_g[(size_t)p * 2 + 1] = r / gxy;
      feat_b[(size_t)p * 5 + 0] = c / bxy;
      feat_b[(size_t)p * 5 + 1] = r / bxy;
      feat_b[(size_t)p * 5 + 2] = img[(size_t)p * 3 + 0] / brgb;
      feat_b[(size_t)p * 5 + 3] = img[(size_t)p * 3 + 1] / brgb;
      feat_b[(size_t)p * 5 + 4] = img[(size_t)p * 3 + 2] / brgb;
    }
  }
  Permutohedral lat_g, lat_b;
  lat_g.init(feat_g.data(), 2, n);
  lat_b.init(feat_b.data(), 5, n);
  std::vector<float> norm_g = make_norm(lat_g, n);
  std::vector<float> norm_b = make_norm(lat_b, n);

  // unary comes in [K, L, h*w]; work pixel-major [n, K*L]
  std::vector<float> U((size_t)n * C), Q((size_t)n * C), tmp1((size_t)n * C),
      f1((size_t)n * C), f2((size_t)n * C);
  for (int k = 0; k < K; ++k)
    for (int c = 0; c < L; ++c)
      for (int p = 0; p < n; ++p)
        U[(size_t)p * C + k * L + c] = unary[((size_t)k * L + c) * n + p];

  auto exp_normalize = [&](const std::vector<float>& src) {
#pragma omp parallel for schedule(static) num_threads(g_threads)
    for (int p = 0; p < n; ++p) {
      for (int k = 0; k < K; ++k) {
        const float* s = &src[(size_t)p * C + k * L];
        float mx = s[0];
        for (int c = 1; c < L; ++c) mx = std::max(mx, s[c]);
        float sum = 0;
        float* qd = &Q[(size_t)p * C + k * L];
        for (int c = 0; c < L; ++c) {
          qd[c] = std::exp(s[c] - mx);
          sum += qd[c];
        }
        for (int c = 0; c < L; ++c) qd[c] /= sum;
      }
    }
  };

  for (size_t i = 0; i < U.size(); ++i) tmp1[i] = -U[i];
  exp_normalize(tmp1);

  for (int it = 0; it < n_iters; ++it) {
    normalized_filter(lat_g, Q.data(), f1.data(), n, C, norm_g);
    normalized_filter(lat_b, Q.data(), f2.data(), n, C, norm_b);
    for (size_t i = 0; i < U.size(); ++i)
      tmp1[i] = -U[i] + gcompat * f1[i] + bcompat * f2[i];
    exp_normalize(tmp1);
  }

  for (int k = 0; k < K; ++k)
    for (int c = 0; c < L; ++c)
      for (int p = 0; p < n; ++p)
        q_out[((size_t)k * L + c) * n + p] = Q[(size_t)p * C + k * L + c];
}

void tris_dense_crf(const uint8_t* img, const float* unary, int h, int w, int L,
                    int n_iters, float gxy, float gcompat, float bxy, float brgb,
                    float bcompat, float* q_out) {
  tris_dense_crf_multi(img, unary, 1, h, w, L, n_iters, gxy, gcompat, bxy, brgb,
                       bcompat, q_out);
}

}  // extern "C"
