// The device code of the noise kernel (normalize_gaussian_noise.cu, whose
// header sets out the design): the Philox4x32-10 stream, the transforms of
// each kind in each noise variant and output domain, and the 8-element
// chunk a thread owns.  Also built into noise_issue_probe.cu, whose
// one-kind kernels (variant 1, [-1, 1]) chip_smoke.py compiles on its own to
// count the instructions a chunk issues.

#pragma once

#include <cstdint>

#include "common.cuh"

namespace cid {
namespace noise {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // elements per thread

// kind codes, as ops/cuda/noise.py's KIND_CODES
constexpr int kGaussian = 0, kSaltPepper = 1, kSpeckle = 2, kPoisson = 3,
              kUniform = 4;
// variant 0: the blind-sigma Gaussian (every sample gaussian, its sigma
// drawn per sample); 1, 2, 3: the noise variants of ops/cuda/noise.py
constexpr int kBlind = 0;
// poisson guide: 1025 counts per row, at a = j 2^22 for j = 0..1024
constexpr int kGuideShift = 22, kGuideRow = 1025;
constexpr float kInv255 = 0.00392156862745098f;  // RN(1 / 255)
constexpr float kInv256 = 0.00390625f;           // 1 / 256, exact

// the launch's constants (ops/cuda/noise.py computes them)
struct Params {
  float sigma01;   // gaussian: sigma on [0, 1]
  float speckle;   // speckle: sigma (variant 3: 1)
  float uniform;   // uniform: (high - low) on [0, 1]
  float low;       // uniform: low on [0, 1] (variants 2 and 3)
  float sp_a;      // salt & pepper: the threshold of the uniform of word a
  float sp_b;      // ... and of word b, rounded to float
  float blind_lo;  // blind sigma, 0-255 scale: lo + u span
  float blind_span;
};

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kW0;  // the key is bumped between rounds; the last bump is unused
    k1 += kW1;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// the block of element pair `pair` (elements 2 pair, 2 pair + 1)
__device__ __forceinline__ Philox4 block_of(unsigned long long pair,
                                            uint32_t k0, uint32_t k1) {
  return philox4x32_10((uint32_t)pair, (uint32_t)(pair >> 32), 0u, 0u, k0,
                       k1);
}

__device__ __forceinline__ float uniform24(uint32_t w) {
  return __fmul_rn((float)(w >> 8), 1.0f / 16777216.0f);
}

// Box-Muller on the top 24 bits of a and b.
__device__ __forceinline__ float normal_from_bits(uint32_t a, uint32_t b) {
  const float u1 = __fadd_rn(uniform24(a), 1.0f / 33554432.0f);
  const float u2 = uniform24(b);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
}

// The blind sigma of sample s on [0, 1]: (lo + u span) RN(1/255), u from
// word 0 of the block at counter (lo32(s), hi32(s), 1, 0).
__device__ __forceinline__ float blind_sigma01(long long s, uint32_t k0,
                                               uint32_t k1, const Params& p) {
  const unsigned long long su = (unsigned long long)s;
  const Philox4 r =
      philox4x32_10((uint32_t)su, (uint32_t)(su >> 32), 1u, 0u, k0, k1);
  return __fmul_rn(
      __fadd_rn(__fmul_rn(uniform24(r.w[0]), p.blind_span), p.blind_lo),
      kInv255);
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}
__device__ __forceinline__ float to_pm1(float v) {
  return __fadd_rn(__fmul_rn(v, 2.0f), -1.0f);
}
// a value on [0, 1] in the output domain: itself (UNIT) or * 2 - 1
template <bool UNIT>
__device__ __forceinline__ float out_of(float v) {
  return UNIT ? v : to_pm1(v);
}
__device__ __forceinline__ float x01_of(uint8_t x) {
  return __fmul_rn((float)x, kInv255);
}

// K ~ Poisson(lambda) from the word a: the thresholds it passes, in the row
// of byte x (variant 1: lambda = x; 2 and 3: lambda = x 256 / 255).  The
// count lies between the guide's counts at the ends of a's bucket (a >>
// 22), equal for 94% of the words; a binary search between them reads the
// table the rest of the time.  The guide holds counts up to 255: variant 1
// saturates there (K / 255 >= 1), variants 2 and 3 tell 256 apart.
template <int V>
__device__ __forceinline__ int poisson_count(uint8_t x, uint32_t a,
                                             const uint32_t* __restrict__ table,
                                             const uint8_t* __restrict__ guide) {
  const uint8_t* g = guide + x * kGuideRow + (a >> kGuideShift);
  int lo = g[0], hi = g[1];
  const uint32_t* row = table + x * 256;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < a)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (V != 1 && lo == 255 && row[255] < a) lo = 256;
  return lo;
}

// the noisy value on [0, 1] of a poisson count
template <int V>
__device__ __forceinline__ float poisson_of(int k) {
  return clip01(__fmul_rn((float)k, V == 1 ? kInv255 : kInv256));
}

// salt & pepper of one element given its words (variant 1: the words of
// the pixel's channel-0 element), on [0, 1]:
//   variants 1 and 3: 0 if u_b < sp_b, else 1 if u_a < sp_a (pepper last);
//   variant 2: if u_a < sp_a (flip), 1 if u_b < sp_b (salted), else 0.
template <int V>
__device__ __forceinline__ float salt_pepper01(float img, uint32_t a,
                                               uint32_t b, const Params& p) {
  if (V == 2) {
    if (uniform24(a) < p.sp_a) return uniform24(b) < p.sp_b ? 1.0f : 0.0f;
    return img;
  }
  if (uniform24(b) < p.sp_b) return 0.0f;
  if (uniform24(a) < p.sp_a) return 1.0f;
  return img;
}

// The noisy value of one element of a sample of kind KIND (salt & pepper
// with its own words: variants 2 and 3, or variant 1 given the pixel's),
// from its words (a, b), in the output domain.
template <int KIND, int V, bool UNIT>
__device__ __forceinline__ float noisy_of(uint8_t x, uint32_t a, uint32_t b,
                                          const Params& p,
                                          const uint32_t* __restrict__ table,
                                          const uint8_t* __restrict__ guide) {
  const float img = x01_of(x);
  if (KIND == kGaussian) {
    const float n = normal_from_bits(a, b);
    return out_of<UNIT>(clip01(__fadd_rn(img, __fmul_rn(p.sigma01, n))));
  }
  if (KIND == kSpeckle) {
    const float n = normal_from_bits(a, b);
    return out_of<UNIT>(
        clip01(__fadd_rn(img, __fmul_rn(img, __fmul_rn(p.speckle, n)))));
  }
  if (KIND == kUniform) {
    float t = __fmul_rn(uniform24(a), p.uniform);
    if (V != 1) t = __fadd_rn(p.low, t);
    return out_of<UNIT>(clip01(__fadd_rn(img, t)));
  }
  if (KIND == kSaltPepper) return out_of<UNIT>(salt_pepper01<V>(img, a, b, p));
  // poisson
  return out_of<UNIT>(poisson_of<V>(poisson_count<V>(x, a, table, guide)));
}

// the words (a, b) of element i
__device__ __forceinline__ void words_of(long long i, uint32_t k0, uint32_t k1,
                                         uint32_t& a, uint32_t& b) {
  const Philox4 r = block_of((unsigned long long)i >> 1, k0, k1);
  a = (i & 1) ? r.w[2] : r.w[0];
  b = (i & 1) ? r.w[3] : r.w[1];
}

// The noisy values, in the output domain, of the kChunk elements from i0
// (even), all of one sample of kind KIND; xs their bytes.  channels: the
// samples' C (variant 1's salt & pepper).
template <int KIND, int V, bool UNIT>
__device__ __forceinline__ void chunk_of(const uint8_t (&xs)[kChunk],
                                         long long i0, int channels,
                                         uint32_t k0, uint32_t k1,
                                         const Params& p,
                                         const uint32_t* __restrict__ table,
                                         const uint8_t* __restrict__ guide,
                                         float (&out)[kChunk]) {
  if (KIND == kPoisson) {
    // the eight searches in step, so that their loads are in flight
    // together (each a dependent read of L2 otherwise)
    uint32_t a[kChunk];
    int lo[kChunk], hi[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk / 2; ++q) {
      const Philox4 r = block_of((unsigned long long)(i0 >> 1) + q, k0, k1);
      a[2 * q] = r.w[0];
      a[2 * q + 1] = r.w[2];
    }
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const uint8_t* g = guide + xs[e] * kGuideRow + (a[e] >> kGuideShift);
      lo[e] = g[0];
      hi[e] = g[1];
    }
    bool open = true;
    while (open) {
      open = false;
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        if (lo[e] < hi[e]) {
          const int mid = (lo[e] + hi[e]) >> 1;
          if (table[xs[e] * 256 + mid] < a[e])
            lo[e] = mid + 1;
          else
            hi[e] = mid;
          open |= lo[e] < hi[e];
        }
    }
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      if (V != 1 && lo[e] == 255 && table[xs[e] * 256 + 255] < a[e])
        lo[e] = 256;
      out[e] = out_of<UNIT>(poisson_of<V>(lo[e]));
    }
    return;
  }
  if (KIND == kSaltPepper && V == 1) {
    // pixel by pixel (a pixel's channels are consecutive elements): which
    // elements turn to pepper or salt, as bit masks over the chunk
    uint32_t pepper = 0, salt = 0;
    for (long long q = i0 - i0 % channels; q < i0 + kChunk; q += channels) {
      uint32_t a, b;
      words_of(q, k0, k1, a, b);
      const int lo = q > i0 ? (int)(q - i0) : 0;
      const int hi = q + channels < i0 + kChunk ? (int)(q + channels - i0)
                                                : kChunk;
      const uint32_t bits = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
      if (uniform24(b) < p.sp_b)
        pepper |= bits;
      else if (uniform24(a) < p.sp_a)
        salt |= bits;
    }
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      out[e] = (pepper >> e) & 1u ? (UNIT ? 0.0f : -1.0f)
               : (salt >> e) & 1u ? 1.0f
                                  : out_of<UNIT>(x01_of(xs[e]));
    return;
  }
#pragma unroll
  for (int q = 0; q < kChunk / 2; ++q) {
    const Philox4 r = block_of((unsigned long long)(i0 >> 1) + q, k0, k1);
    out[2 * q] =
        noisy_of<KIND, V, UNIT>(xs[2 * q], r.w[0], r.w[1], p, table, guide);
    out[2 * q + 1] = noisy_of<KIND, V, UNIT>(xs[2 * q + 1], r.w[2], r.w[3],
                                             p, table, guide);
  }
}

__device__ __forceinline__ void load8(const uint8_t* __restrict__ x,
                                      uint8_t (&xs)[kChunk]) {
  const unsigned long long raw = *reinterpret_cast<const unsigned long long*>(x);
#pragma unroll
  for (int e = 0; e < kChunk; ++e) xs[e] = (uint8_t)(raw >> (8 * e));
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ dst,
                                       const float (&v)[kChunk]) {
  __align__(16) T vals[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) vals[j] = cid::from_f32<T>(v[j]);
  constexpr int kStores = kChunk * (int)sizeof(T) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(vals);
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int s = 0; s < kStores; ++s) out[s] = src[s];
}

// the clean target of the chunk, in the output domain
template <bool UNIT>
__device__ __forceinline__ void store_clean(float* __restrict__ dst,
                                            const uint8_t (&xs)[kChunk]) {
  float v[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) v[e] = out_of<UNIT>(x01_of(xs[e]));
  store8<float>(dst, v);
}

}  // namespace noise
}  // namespace cid
