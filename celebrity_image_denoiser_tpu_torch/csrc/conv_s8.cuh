// Building blocks of the int8 convolutions (conv3x3_s8.cu, convt2x2_s8.cu):
// s8 operands on mma.sync m16n8k32 with s32 accumulation, and the
// epilogue of the JAX package's s8 program (ops/quant_unet.py:49-59).
//
// Operands lie in shared memory as rows of 32 bytes (32 channels of one
// pixel, or 32 input channels of one weight row: K is walked 32 channels at
// a time), each row two 16-byte pieces, piece j stored at j ^ ((row >> 2) &
// 1) so that the eight rows one ldmatrix matrix reads (eight neighbouring
// pixels, or eight neighbouring output channels) fall on distinct banks.
// A row holds the same bytes as a 16-channel bf16 row, so the A fragments
// come from ldmatrix_x4 with the bf16 kernels' addressing (mma.cuh).
//
// The epilogue rounds where the JAX program rounds, with single IEEE
// operations that nvcc may not contract or approximate:
//   h = bf16(f32(acc) * w_scale[c]);  h = bf16(h + bias[c]);  ReLU if asked;
//   then either h (bf16 out) or s8 = clamp(rint(h / s_next[c]), -127, 127).
// The generic transform (ops/quant.py) takes f32(acc) * w_scale[c] alone
// (f32 out) and adds its correction and bias itself.
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

// Per-output-channel constants, copied once to shared memory (zero beyond
// Cout): the weight scale, the bias (bf16 values) and the next layer's
// activation scale.
struct Consts {
  float* ws;
  float* bias;
  float* snext;
};
__device__ __forceinline__ void load_consts(const Consts& c,
                                            const float* __restrict__ ws,
                                            const conv::bf16* __restrict__ bias,
                                            const float* __restrict__ snext,
                                            int count, int padded, int tid,
                                            int nthr) {
  for (int i = tid; i < padded; i += nthr) {
    const bool in = i < count;
    c.ws[i] = in ? ws[i] : 0.f;
    c.bias[i] = in && bias ? __bfloat162float(bias[i]) : 0.f;
    c.snext[i] = in && snext ? snext[i] : 1.f;
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// h for channel c of accumulator acc (bf16 and s8 outputs)
__device__ __forceinline__ float dequant(int acc, const Consts& k, int c,
                                         bool relu) {
  float h = bf16_round(__fmul_rn((float)acc, k.ws[c]));
  h = bf16_round(__fadd_rn(h, k.bias[c]));
  return relu ? relu_f32(h) : h;
}

// 0 / s is 0 for every scale (s > 0), so a zero (half of a ReLU's outputs)
// skips the division: on the H100 that took K2's s8 mode from 2.17 to 1.54
// ms and K5 from 9.33 to 7.88 ms per int8 step (PERF.md), so the division
// costs most where its numerator is zero.
__device__ __forceinline__ int8_t quantize(float h, float s) {
  if (h == 0.f) return 0;
  const float q = rintf(__fdiv_rn(h, s));
  return (int8_t)(int)fminf(fmaxf(q, -127.f), 127.f);
}

// Store the two neighbouring channels c, c + 1 (c even) of one output
// pixel that an accumulator pair holds; out points at the pixel's channel 0
// (element offset `off` into y); channels >= Cout are not stored.  pair:
// Cout is even, so the pair's address is aligned for one store.
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
  const float h0 = dequant(acc0, k, c, relu);
  const float h1 = dequant(acc1, k, c + 1, relu);
  if (mode == kOutBF16) {
    conv::bf16* out = static_cast<conv::bf16*>(y) + o;
    __nv_bfloat162 pr;
    pr.x = __float2bfloat16(h0);
    pr.y = __float2bfloat16(h1);
    if (two && pair) {
      *reinterpret_cast<__nv_bfloat162*>(out) = pr;
    } else {
      out[0] = pr.x;
      if (two) out[1] = pr.y;
    }
    return;
  }
  int8_t* out = static_cast<int8_t*>(y) + o;
  const int8_t q0 = quantize(h0, k.snext[c]);
  const int8_t q1 = quantize(h1, k.snext[c + 1]);
  if (two && pair) {
    *reinterpret_cast<char2*>(out) = make_char2(q0, q1);
  } else {
    out[0] = q0;
    if (two) out[1] = q1;
  }
}

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
