// Building blocks of the int8 convolutions (conv3x3_s8.cu, convt2x2_s8.cu)
// and of the s8-out mode of conv3x3_bias_relu.cu: the shared-memory rows of
// s8 operands, and the epilogue of the JAX package's s8 program
// (ops/quant_unet.py:49-59).
//
// Operands lie in shared memory as rows of 32 bytes (32 channels of one
// pixel, or 32 input channels of one weight row: K is walked 32 channels at
// a time), each row two 16-byte pieces, piece j stored at j ^ ((row >> 2) &
// 1).  For activations that puts the eight pixels one ldmatrix matrix reads
// on distinct banks, and a row holds the same bytes as a 16-channel bf16
// row, so the A fragments come from ldmatrix_x4 with the bf16 kernels'
// addressing (mma.cuh).  For weights it is the K-major, 32-byte-swizzled B
// tile of the s8 wgmma (mma.cuh, wgmma_desc_k32): 64 output channels of one
// 32-channel chunk are 64 consecutive rows, 2048 bytes.
//
// The epilogue rounds where the JAX program rounds, every step exact:
//   h = bf16(f32(acc) * w_scale[c]);  h = bf16(h + bias[c]);  ReLU if asked;
//   then either h (bf16 out) or s8 = clamp(rint(h / s_next[c]), -127, 127).
// The two channels of an accumulator pair are converted to bf16 and their
// bias added as one packed bf16x2 operation each (both round once, to
// nearest even, as the scalar steps do).  The quantization takes the
// correctly rounded h / s without a division: a product by 1/s
// precomputed per channel and one fma correction (quantize_bits), then
// rounds and clamps with two float additions.  The generic
// transform (ops/quant.py) takes f32(acc) * w_scale[c] alone (f32 out) and
// adds its correction and bias itself.
//
// The wide kernels stage a warp's s8 or bf16 outputs in shared memory
// (Staging) and write each pixel's channel run with 16-byte stores: stored
// straight from the accumulator fragments, a warp's two-byte stores covered
// a quarter of each 32-byte sector they touched.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "conv_mma.cuh"

namespace cid {
namespace s8 {

constexpr int kKC = 32;         // input channels per chunk: one k32 step
constexpr int kRowBytes = kKC;  // one staged row

enum OutMode { kOutS8 = 0, kOutBF16 = 1, kOutF32 = 2 };

// shared-memory address of piece j (0 or 1) of row r
__device__ __forceinline__ uint32_t row_addr(uint32_t base, int r, int j) {
  return base + r * kRowBytes + ((j ^ conv::swizzle<kRowBytes>(r)) << 4);
}

// A batch of NHWC s8 images with contiguous channels: pixel (n, y, x) starts
// at p + n * sn + y * sh + x * sw (bytes), so a cropped view is an Image too.
// C and the strides are multiples of 16 and p is 16-byte aligned (the
// wrappers check), so every 16-channel piece can be copied whole.
struct Image {
  const int8_t* p;
  long long sn;
  int C, sh, sw;
};

// A conv input given as two channel ranges, a.C channels from `a` and the
// rest from `b` (b.C = 0: one input); the concatenation is never written.
// a.C is a multiple of kKC, so a chunk lies in one of the two.
struct Input {
  Image a, b;
  __device__ __forceinline__ Image of(int c0, int n) const {
    const bool f = c0 < a.C;
    return Image{(f ? a.p : b.p) + n * (f ? a.sn : b.sn), 0, f ? a.C : b.C,
                 f ? a.sh : b.sh, f ? a.sw : b.sw};
  }
  __device__ __forceinline__ int local(int c0) const {
    return c0 < a.C ? c0 : c0 - a.C;
  }
};

// ---- bits --------------------------------------------------------------
#ifndef CID_EMULATE_MMA
__device__ __forceinline__ uint32_t float_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ float bits_float(uint32_t u) {
  return __uint_as_float(u);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
// {lo, hi} rounded to bf16 (nearest even) and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t u;  // cvt puts its first source in the upper half
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}
// a + b on packed bf16 pairs, each sum rounded once to nearest even (a fma
// by 1.0: the product is exact)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}
#else
inline uint32_t float_bits(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  return u;
}
inline float bits_float(uint32_t u) {
  float v;
  std::memcpy(&v, &u, 4);
  return v;
}
inline float fma_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__float2bfloat16(lo).bits |
         ((uint32_t)__float2bfloat16(hi).bits << 16);
}
// a + b rounded once to bf16 (nearest even), as fma.rn.bf16x2 by 1.0 does,
// computed without any float rounding in between: TwoSum gives s + e = a + b
// exactly (s the double nearest), and s is rounded to a multiple of the
// bf16 ulp at its binade with e breaking a tie (s on a midpoint) and a
// double's half ulp unable to cross one otherwise.
inline uint16_t bf16_of_sum(float a, float b) {
  const double x = a, y = b, s = x + y;
  if (!std::isfinite(s)) return __float2bfloat16((float)s).bits;
  const double z = s - x, e = (x - (s - z)) + (y - z);
  const double m = std::fabs(s), em = s < 0 ? -e : e;  // e toward |s|
  int ex;
  std::frexp(m, &ex);  // m = f * 2^ex, 0.5 <= f < 1
  const double ulp = std::ldexp(1.0, std::max(ex - 8, -133));
  const double q = m / ulp, r = std::floor(q), frac = q - r;
  const bool up = frac > 0.5 || (frac == 0.5 && (em > 0 || (em == 0 &&
                                                 std::fmod(r, 2.0) != 0)));
  const float v = (float)((r + (up ? 1.0 : 0.0)) * ulp);  // exact or inf
  uint32_t u;
  std::memcpy(&u, &v, 4);
  return (uint16_t)((u >> 16) | (s < 0 || (s == 0 && std::signbit(s))
                                     ? 0x8000u : 0u));
}
inline uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  return (uint32_t)bf16_of_sum(bits_float(a << 16), bits_float(b << 16)) |
         ((uint32_t)bf16_of_sum(bits_float(a & 0xFFFF0000u),
                                bits_float(b & 0xFFFF0000u)) << 16);
}
#endif
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return bits_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return bits_float(u & 0xFFFF0000u);
}

// ---- per-channel constants ----------------------------------------------
// The quantization's constants of one scale s > 0: h / s is computed as
// (h * p) / (s * p) with p a power of two (1, or 2^±64 where s lies far
// out) that keeps s' = s * p and 1/s' normal and the divisions that matter
// clear of underflow; r = RN(1/s').
struct QScale {
  float s, r, p;
};
__device__ __forceinline__ QScale qscale_of(float s) {
  const float p = s < 0x1p-100f ? 0x1p64f : s > 0x1p100f ? 0x1p-64f : 1.f;
  const float sp = __fmul_rn(s, p);
  return QScale{sp, __fdiv_rn(1.f, sp), p};
}

// Copied once to shared memory, zero beyond Cout: the weight scale, the
// bias as packed bf16 pairs, and the next layer's activation scale as
// QScale's three numbers.
struct Consts {
  float* ws;
  float* snext;  // s'
  float* rnext;  // r
  float* pnext;  // p
  uint32_t* bias2;  // [c / 2]: channels c (low half), c + 1
};
// bytes of the constants of `padded` channels (a multiple of 8)
__host__ __device__ constexpr int consts_bytes(int padded) {
  return 18 * padded;
}
__device__ __forceinline__ Consts consts_at(unsigned char* p, int padded) {
  float* f = reinterpret_cast<float*>(p);
  return Consts{f, f + padded, f + 2 * padded, f + 3 * padded,
                reinterpret_cast<uint32_t*>(f + 4 * padded)};
}
__device__ __forceinline__ void load_consts(const Consts& c,
                                            const float* __restrict__ ws,
                                            const conv::bf16* __restrict__ bias,
                                            const float* __restrict__ snext,
                                            int count, int padded, int tid,
                                            int nthr) {
  const uint16_t* b16 = reinterpret_cast<const uint16_t*>(bias);
  for (int i = tid; i < padded; i += nthr) {
    const bool in = i < count;
    const QScale q = qscale_of(in && snext ? snext[i] : 1.f);
    c.ws[i] = in ? ws[i] : 0.f;
    c.snext[i] = q.s;
    c.rnext[i] = q.r;
    c.pnext[i] = q.p;
    if (i % 2 == 0) {
      const uint32_t lo = in && bias ? b16[i] : 0u;
      const uint32_t hi = i + 1 < count && bias ? b16[i + 1] : 0u;
      c.bias2[i / 2] = lo | (hi << 16);
    }
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The constants of the channel pair c, c + 1 (c even), read once into
// registers: an epilogue reads them before its shared-memory stores, which
// the compiler cannot move loads across.
struct Pair {
  float ws0, ws1;
  uint32_t bias2;
  QScale q0, q1;
};
__device__ __forceinline__ Pair pair_at(const Consts& k, int c) {
  return Pair{k.ws[c], k.ws[c + 1], k.bias2[c / 2],
              QScale{k.snext[c], k.rnext[c], k.pnext[c]},
              QScale{k.snext[c + 1], k.rnext[c + 1], k.pnext[c + 1]}};
}

// h of a channel pair from its accumulators (bf16 and s8 outputs)
__device__ __forceinline__ void dequant2(int acc0, int acc1, const Pair& k,
                                         bool relu, float& h0, float& h1) {
  const uint32_t u = add_bf16x2(pack_bf16x2(__fmul_rn((float)acc0, k.ws0),
                                            __fmul_rn((float)acc1, k.ws1)),
                                k.bias2);
  h0 = bf16_lo(u);
  h1 = bf16_hi(u);
  if (relu) {
    h0 = relu_f32(h0);
    h1 = relu_f32(h1);
  }
}

// clamp(rint(h / s), -127, 127), with the IEEE division's result, for the
// scale q = qscale_of(s); returned as the bits of a float whose low byte is
// that s8 value.  No division and no branch:
//   t = RN(h' * r) is within an ulp of h' / s' (h' = h * p), the residual
//   h' - t * s' is exact in one fma, and RN(t + residual * r) is the
//   correctly rounded h' / s' = h / s (Markstein's theorem: r the
//   correctly rounded 1/s', t within an ulp).  The scaling by p keeps the
//   residual clear of underflow wherever the quotient lies near [0.5, 128);
//   an infinite t (the quotient overflows) is kept as it is.
// Adding 1.5 * 2^23 to the clamped quotient rounds it to an integer (half
// to even) in the float's low mantissa bits; clamp(rint(v)) =
// rint(clamp(v)) for the bounds ±127, fmaxf sends a NaN to -127 as before,
// and a zero h gives 0 (-0 too).
__device__ __forceinline__ uint32_t quantize_bits(float h, float s, float r,
                                                  float p) {
  constexpr float kMagic = 0x1.8p23f;
  const float hp = __fmul_rn(h, p);
  const float t = __fmul_rn(hp, r);
  float v = fma_rn(fma_rn(-t, s, hp), r, t);
  if (!(fmaxf(t, -t) <= 0x1.fffffep127f)) v = t;
  return float_bits(__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), kMagic));
}
__device__ __forceinline__ int8_t quantize(float h, const QScale& q) {
  return (int8_t)(quantize_bits(h, q.s, q.r, q.p) & 0xFFu);
}
// the s8 values of a channel pair as two bytes, the first in the low one
__device__ __forceinline__ uint32_t quantize2(float h0, float h1,
                                              const Pair& k) {
  return (quantize_bits(h0, k.q0.s, k.q0.r, k.q0.p) & 0xFFu) |
         ((quantize_bits(h1, k.q1.s, k.q1.r, k.q1.p) & 0xFFu) << 8);
}

// Store the two neighbouring channels c, c + 1 (c even) of one output
// pixel that an accumulator pair holds straight to device memory (the f32
// output and the narrow conv); y + off is the pixel's channel 0 (element
// offset); channels >= Cout are not stored.  pair: Cout is even, so the
// pair's address is aligned for one store.
__device__ __forceinline__ void store_pair(void* y, long long off, int c,
                                           int Cout, int acc0, int acc1,
                                           const Consts& k, int mode,
                                           bool relu, bool pair) {
  if (c >= Cout) return;
  const bool two = c + 1 < Cout;
  const long long o = off + c;
  if (mode == kOutF32) {
    const float v0 = __fmul_rn((float)acc0, k.ws[c]);
    const float v1 = __fmul_rn((float)acc1, k.ws[c + 1]);
    float* out = static_cast<float*>(y) + o;
    if (two && pair) {
      *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
    } else {
      out[0] = v0;
      if (two) out[1] = v1;
    }
    return;
  }
  const Pair kc = pair_at(k, c);
  float h0, h1;
  dequant2(acc0, acc1, kc, relu, h0, h1);
  if (mode == kOutBF16) {
    conv::bf16* out = static_cast<conv::bf16*>(y) + o;
    const uint32_t u = pack_bf16x2(h0, h1);
    if (two && pair) {
      *reinterpret_cast<uint32_t*>(out) = u;
    } else {
      reinterpret_cast<uint16_t*>(out)[0] = (uint16_t)u;
      if (two) reinterpret_cast<uint16_t*>(out)[1] = (uint16_t)(u >> 16);
    }
    return;
  }
  int8_t* out = static_cast<int8_t*>(y) + o;
  const uint32_t q = quantize2(h0, h1, kc);
  if (two && pair) {
    *reinterpret_cast<uint16_t*>(out) = (uint16_t)q;
  } else {
    out[0] = (int8_t)(q & 0xFFu);
    if (two) out[1] = (int8_t)(q >> 8);
  }
}

// ---- staged stores --------------------------------------------------------
// A warp's outputs of NPIX pixels x 64 channels of ES bytes, in shared
// memory: pixel p holds 64 * ES bytes, its 16-byte chunk j stored at
// j ^ swz(p), so that the warp's pair writes (eight pixels, four channel
// pairs) fall on distinct banks.
template <int ES, int NPIX>
struct Staging {
  static_assert(ES == 1 || ES == 2, "s8 or bf16");
  static constexpr int kPitch = 64 * ES;
  static constexpr int kChunks = kPitch / 16;
  static constexpr int kBytes = NPIX * kPitch;
  unsigned char* buf;
  __device__ __forceinline__ static int swz(int p) {
    return ES == 1 ? (p >> 1) & 3 : p & 7;
  }
  // the s8 pair (two bytes) or bf16 pair (four) of channels c, c + 1
  __device__ __forceinline__ void put(int p, int c, uint32_t v) const {
    const int b = c * ES;
    unsigned char* a = buf + p * kPitch + (((b >> 4) ^ swz(p)) << 4) + (b & 15);
    if (ES == 1)
      *reinterpret_cast<uint16_t*>(a) = (uint16_t)v;
    else
      *reinterpret_cast<uint32_t*>(a) = v;
  }
  // Write pixel p's first `valid` channels (<= 64) to dst(p), a byte pointer
  // (null: not stored); vec: every dst(p) is 16-byte aligned, so whole
  // chunks go as one store.  The warp walks the chunks in order, so a
  // pixel run that is contiguous in memory goes out as consecutive stores.
  template <class Dst>
  __device__ __forceinline__ void flush(int valid, bool vec, Dst dst) const {
    const int lane = threadIdx.x % 32;
    for (int i = lane; i < NPIX * kChunks; i += 32) {
      const int p = i / kChunks, j = i % kChunks;
      const int c0 = j * 16 / ES;  // the chunk's first channel
      unsigned char* o = dst(p);
      if (o == nullptr || c0 >= valid) continue;
      const unsigned char* s = buf + p * kPitch + ((j ^ swz(p)) << 4);
      if (vec && c0 + 16 / ES <= valid) {
        *reinterpret_cast<uint4*>(o + j * 16) =
            *reinterpret_cast<const uint4*>(s);
      } else {
        for (int e = 0; e < 16 && c0 * ES + e < valid * ES; ++e)
          o[j * 16 + e] = s[e];
      }
    }
  }
};

// ldmatrix addressing of B: 16 weight rows (two n8 blocks) of a chunk,
// lane l pointing at row 8 * (l / 16) + l % 8, piece (l / 8) % 2; for one
// n8 block (ldmatrix_x2) lanes 0..15 give row l % 8, piece l / 8.
__device__ __forceinline__ int b_row() {
  const int lane = threadIdx.x % 32;
  return (lane % 8) + 8 * (lane / 16);
}
__device__ __forceinline__ int b_piece() { return (threadIdx.x % 32 / 8) % 2; }

}  // namespace s8
}  // namespace cid
