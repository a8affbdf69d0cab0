// Native host-side preprocessing for the port's input pipeline: the JAX
// package's loader (celebrity_image_denoiser_tpu/data/_native/loader.cpp),
// copied, with one entry more.
//
// Multi-threaded bicubic resize + NHWC batch assembly over decoded uint8
// images, called from Python via ctypes with the GIL released, writing
// straight into the batch buffer the device copy reads from.  Two batch
// entries: cid_assemble_batch (float32, normalised, the paired datasets)
// and cid_assemble_batch_u8 (uint8 with cid_resize_u8's rounding, the
// clean images of the on-the-fly path, whose normalisation and noise run
// on the card).
//
// Build: data/_native/build.py (g++ -O3 -shared -fPIC, no dependencies).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Catmull-Rom cubic kernel (a = -0.5), the convention PIL/OpenCV use.
inline float cubic_weight(float x) {
  x = std::fabs(x);
  if (x < 1.0f) return ((1.5f * x - 2.5f) * x) * x + 1.0f;
  if (x < 2.0f) return (((-0.5f * x + 2.5f) * x) - 4.0f) * x + 2.0f;
  return 0.0f;
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Precomputed antialiased sampling plan for one axis, PIL-style: on
// downscale the cubic kernel's support is scaled by the ratio (antialias),
// on upscale it stays the classic 4-tap Catmull-Rom.
struct AxisPlan {
  int taps;                 // taps per output position
  std::vector<int> idx;     // [len * taps] clamped source indices
  std::vector<float> w;     // [len * taps] normalized weights
};

AxisPlan make_plan(int src_len, int dst_len) {
  AxisPlan p;
  const float scale = static_cast<float>(src_len) / dst_len;
  const float filter_scale = std::max(scale, 1.0f);
  const float support = 2.0f * filter_scale;  // cubic support = 2
  p.taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  p.idx.assign(static_cast<size_t>(dst_len) * p.taps, 0);
  p.w.assign(static_cast<size_t>(dst_len) * p.taps, 0.0f);
  for (int o = 0; o < dst_len; ++o) {
    const float center = (o + 0.5f) * scale - 0.5f;
    const int start = static_cast<int>(std::floor(center - support)) + 1;
    float sum = 0.0f;
    for (int k = 0; k < p.taps; ++k) {
      const int s = start + k;
      const float wv = cubic_weight((s - center) / filter_scale);
      p.idx[o * p.taps + k] = clampi(s, 0, src_len - 1);
      p.w[o * p.taps + k] = wv;
      sum += wv;
    }
    for (int k = 0; k < p.taps; ++k) p.w[o * p.taps + k] /= sum;
  }
  return p;
}

// Bicubic (antialiased, PIL convention) resize of one uint8 HWC image into a
// float HWC buffer, fused with normalize: out = (px/255 - mean) / std.
void resize_bicubic_normalize_one(const uint8_t* src, int sh, int sw,
                                  float* dst, int dh, int dw, int c,
                                  float mean, float inv_std) {
  const AxisPlan py = make_plan(sh, dh);
  const AxisPlan px = make_plan(sw, dw);
  std::vector<float> row(sw * c);
  for (int oy = 0; oy < dh; ++oy) {
    // vertical pass into a single fused row
    std::fill(row.begin(), row.end(), 0.0f);
    for (int k = 0; k < py.taps; ++k) {
      const float wv = py.w[oy * py.taps + k];
      if (wv == 0.0f) continue;
      const uint8_t* srow =
          src + static_cast<size_t>(py.idx[oy * py.taps + k]) * sw * c;
      for (int x = 0; x < sw * c; ++x) row[x] += wv * srow[x];
    }
    // horizontal pass + normalize
    float* out_row = dst + static_cast<size_t>(oy) * dw * c;
    for (int ox = 0; ox < dw; ++ox) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int k = 0; k < px.taps; ++k)
          acc += px.w[ox * px.taps + k] * row[px.idx[ox * px.taps + k] * c + ch];
        // clamp over/undershoot to the valid pixel range before
        // normalizing (matches decode→ToTensor semantics)
        acc = std::min(255.0f, std::max(0.0f, acc));
        out_row[ox * c + ch] = (acc * (1.0f / 255.0f) - mean) * inv_std;
      }
    }
  }
}

// uint8 → uint8 resize of one image: the float path with mean 0, std 1,
// then out = round(v·255) clamped to [0, 255].
void resize_u8_one(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                   int dw, int c) {
  std::vector<float> tmp(static_cast<size_t>(dh) * dw * c);
  resize_bicubic_normalize_one(src, sh, sw, tmp.data(), dh, dw, c, 0.0f,
                               1.0f);
  for (size_t i = 0; i < tmp.size(); ++i) {
    float v = tmp[i] * 255.0f;
    dst[i] = static_cast<uint8_t>(clampi(static_cast<int>(v + 0.5f), 0, 255));
  }
}

// Run fn(i) for i in [0, n) on `threads` std::threads.
template <typename Fn>
void parallel_for(int n, int threads, Fn fn) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      fn(i);
    }
  };
  const int t = std::max(1, threads);
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Parallel batch assembly: n source images (uint8 HWC, per-image sizes in
// shs/sws) → one float32 NHWC batch (n, dh, dw, c), resized bicubic and
// normalized.  Runs on `threads` std::threads (call with GIL released).
void cid_assemble_batch(const uint8_t** srcs, const int* shs, const int* sws,
                        int n, int c, float* dst, int dh, int dw,
                        float mean, float std_dev, int threads) {
  const float inv_std = 1.0f / std_dev;
  parallel_for(n, threads, [&](int i) {
    resize_bicubic_normalize_one(
        srcs[i], shs[i], sws[i],
        dst + static_cast<size_t>(i) * dh * dw * c, dh, dw, c, mean,
        inv_std);
  });
}

// The same assembly into a uint8 NHWC batch, each image as cid_resize_u8
// gives it.
void cid_assemble_batch_u8(const uint8_t** srcs, const int* shs,
                           const int* sws, int n, int c, uint8_t* dst, int dh,
                           int dw, int threads) {
  parallel_for(n, threads, [&](int i) {
    resize_u8_one(srcs[i], shs[i], sws[i],
                  dst + static_cast<size_t>(i) * dh * dw * c, dh, dw, c);
  });
}

// Single-image resize (uint8 → uint8).
void cid_resize_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                   int dw, int c) {
  resize_u8_one(src, sh, sw, dst, dh, dw, c);
}

int cid_version() { return 2; }
}
