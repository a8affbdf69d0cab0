// Fused U-Net double conv: relu(conv3x3(relu(conv3x3(x) + b1)) + b2), both
// 'same', stride 1, in one kernel.
//
// Replaces celebrity_image_denoiser_tpu/ops/pallas/double_conv.py::
// double_conv3x3_relu (:108, kernel body :38-103).  As there, the
// intermediate activation never reaches device memory: it lives in shared
// memory, stored in x's dtype (:85), and conv2's zero padding sees 0
// outside the image, not conv1 evaluated past the edge (the mask at :70-84).
//
// Layout: x (N,H,W,C0) NHWC; w1 (3,3,C0,C1), w2 (3,3,C1,C2) HWIO in x's
// dtype; b1 (C1,), b2 (C2,) float32; y (N,H,W,C2) NHWC.
//
// What bounds it on an H100: every U-Net pair is far above the ridge point
// (e.g. bottleneck 128->256->256), so it is bound by operations; this first
// version computes on the CUDA cores in f32 FMA, not the tensor cores.  Its
// design:
//   * one block owns an 8x8 output tile and all C2 channels.  conv1 is
//     evaluated over the 10x10 halo of that tile (the 1-pixel ring conv2
//     needs), so conv1 does 100/64 of its useful work; that is the price of
//     keeping the intermediate on chip and is what a larger tile would cut;
//   * the TPU kernel tiled only H; this one tiles H and W, so the
//     intermediate is zeroed outside the image on all four sides of every
//     tile (the generalised :70-84 mask);
//   * the whole intermediate (10*10*C1p values, C1p = C1 rounded up to 64)
//     stays in dynamic shared memory; the input is streamed through a
//     12x12 window CIC channels at a time while conv1 accumulates, and each
//     weight chunk (9*CIC*64) is staged beside it.  For upconv2 in f32 that
//     is 23 KB + 51 KB, for the bottleneck 23 KB + 102 KB, within the 227 KB
//     a block may use (set through cudaFuncAttributeMaxDynamicSharedMemorySize);
//   * conv1 is computed 64 intermediate channels at a time and conv2 64
//     output channels at a time, 256 threads as 16 channel groups of 4 x
//     16 pixel groups; bias + ReLU run in the f32 epilogues.
// The TPU artifacts (C0 < 8 padding, kpack, H % tile_h == 0) are not carried
// over: any C0, C1, C2 and any H, W work, ragged edges masked.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TH = 8, TW = 8;           // output tile
constexpr int MH = TH + 2, MW = TW + 2;  // intermediate tile (1-pixel halo)
constexpr int IH = TH + 4, IW = TW + 4;  // input window (2-pixel halo)
constexpr int COT = 64;                  // channels per pass (conv1 and conv2)
constexpr int CIC = 8;                   // input channels per staged chunk
constexpr int CG = COT / 4;              // 16 channel groups of 4
constexpr int PG = kThreads / CG;        // 16 pixel groups
constexpr int P1 = (MH * MW + PG - 1) / PG;  // conv1 positions per thread (7)
constexpr int P2 = TH * TW / PG;             // conv2 positions per thread (4)
constexpr int kWsFloats = 9 * CIC * COT;
constexpr int kXsFloats = CIC * IH * IW;

template <typename T>
__global__ void __launch_bounds__(kThreads)
double_conv3x3_relu_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                           const float* __restrict__ b1,
                           const T* __restrict__ w2,
                           const float* __restrict__ b2, T* __restrict__ y,
                           int H, int W, int C0, int C1, int C2, int C1p,
                           int tiles_h, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);   // [tap][c][co]
  float* xs = ws + kWsFloats;                   // [c][row][col]
  T* hs = reinterpret_cast<T*>(xs + kXsFloats);  // [pos][c1], pos = r*MW+c

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int pg = tid / CG;

  int t = blockIdx.x;
  const int tx = t % tiles_w;
  t /= tiles_w;
  const int ty = t % tiles_h;
  const int n = t / tiles_h;
  const int y0 = ty * TH, x0 = tx * TW;
  const size_t img = (size_t)n * H * W;

  // ---- conv1 + b1 + ReLU over the 10x10 halo -> hs ----------------------
  // position p = pg + PG*i (i < P1, p < MH*MW); its window offset in xs
  int woff[P1];
#pragma unroll
  for (int i = 0; i < P1; ++i) {
    const int p = pg + PG * i;
    woff[i] = (p / MW) * IW + p % MW;
  }
  for (int c10 = 0; c10 < C1p; c10 += COT) {
    float acc[P1][4];
#pragma unroll
    for (int i = 0; i < P1; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

    for (int ci0 = 0; ci0 < C0; ci0 += CIC) {
      __syncthreads();
      for (int i = tid; i < kXsFloats; i += kThreads) {
        const int c = i % CIC;
        const int p = i / CIC;
        const int gy = y0 - 2 + p / IW;
        const int gx = x0 - 2 + p % IW;
        const int gc = ci0 + c;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C0)
          v = cid::to_f32(x[(img + (size_t)gy * W + gx) * C0 + gc]);
        xs[c * IH * IW + p] = v;
      }
      for (int i = tid; i < kWsFloats; i += kThreads) {
        const int co = i % COT;
        const int r = i / COT;
        const int c = r % CIC;
        const int tap = r / CIC;
        const int gc = ci0 + c, gco = c10 + co;
        float v = 0.f;
        if (gc < C0 && gco < C1)
          v = cid::to_f32(w1[((size_t)tap * C0 + gc) * C1 + gco]);
        ws[i] = v;
      }
      __syncthreads();

      for (int c = 0; c < CIC; ++c) {
        const float* xc = xs + c * IH * IW;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 wv = *reinterpret_cast<const float4*>(
                &ws[((dy * 3 + dx) * CIC + c) * COT + cg * 4]);
#pragma unroll
            for (int i = 0; i < P1; ++i) {
              if (pg + PG * i < MH * MW) {
                const float a = xc[woff[i] + dy * IW + dx];
                acc[i][0] = fmaf(a, wv.x, acc[i][0]);
                acc[i][1] = fmaf(a, wv.y, acc[i][1]);
                acc[i][2] = fmaf(a, wv.z, acc[i][2]);
                acc[i][3] = fmaf(a, wv.w, acc[i][3]);
              }
            }
          }
        }
      }
    }

    // epilogue: bias, ReLU, zero outside the image (conv2's padding), store
    // in x's dtype.  Channels in [C1, C1p) are written as zeros so conv2 can
    // read whole chunks.
#pragma unroll
    for (int i = 0; i < P1; ++i) {
      const int p = pg + PG * i;
      if (p >= MH * MW) continue;
      const int gy = y0 - 1 + p / MW;
      const int gx = x0 - 1 + p % MW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c1 = c10 + cg * 4 + k;
        float v = 0.f;
        if (inside && c1 < C1) v = cid::relu_f32(acc[i][k] + b1[c1]);
        hs[p * C1p + c1] = cid::from_f32<T>(v);
      }
    }
  }

  // ---- conv2 + b2 + ReLU over the 8x8 tile -> y -------------------------
  int hoff[P2];
#pragma unroll
  for (int i = 0; i < P2; ++i) {
    const int q = pg + PG * i;
    hoff[i] = (q / TW) * MW + q % TW;
  }
  for (int c20 = 0; c20 < C2; c20 += COT) {
    float acc[P2][4];
#pragma unroll
    for (int i = 0; i < P2; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

    for (int ci0 = 0; ci0 < C1p; ci0 += CIC) {
      __syncthreads();  // hs complete; previous chunk's weight reads done
      for (int i = tid; i < kWsFloats; i += kThreads) {
        const int co = i % COT;
        const int r = i / COT;
        const int c = r % CIC;
        const int tap = r / CIC;
        const int gc = ci0 + c, gco = c20 + co;
        float v = 0.f;
        if (gc < C1 && gco < C2)
          v = cid::to_f32(w2[((size_t)tap * C1 + gc) * C2 + gco]);
        ws[i] = v;
      }
      __syncthreads();

      for (int c = 0; c < CIC; ++c) {
        const T* hc = hs + ci0 + c;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 wv = *reinterpret_cast<const float4*>(
                &ws[((dy * 3 + dx) * CIC + c) * COT + cg * 4]);
#pragma unroll
            for (int i = 0; i < P2; ++i) {
              const float a =
                  cid::to_f32(hc[(size_t)(hoff[i] + dy * MW + dx) * C1p]);
              acc[i][0] = fmaf(a, wv.x, acc[i][0]);
              acc[i][1] = fmaf(a, wv.y, acc[i][1]);
              acc[i][2] = fmaf(a, wv.z, acc[i][2]);
              acc[i][3] = fmaf(a, wv.w, acc[i][3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < P2; ++i) {
      const int q = pg + PG * i;
      const int gy = y0 + q / TW;
      const int gx = x0 + q % TW;
      if (gy >= H || gx >= W) continue;
      T* out = y + (img + (size_t)gy * W + gx) * C2;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c2 = c20 + cg * 4 + k;
        if (c2 < C2) out[c2] = cid::from_f32<T>(cid::relu_f32(acc[i][k] + b2[c2]));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y, int n, int h,
                   int wd, int c0, int c1, int c2, cudaStream_t stream) {
  const int c1p = (c1 + COT - 1) / COT * COT;
  const size_t smem = sizeof(float) * (kWsFloats + kXsFloats) +
                      sizeof(T) * (size_t)MH * MW * c1p;
  // a C1 too wide for one block's shared memory is refused here, and the
  // error comes back to the wrapper
  cudaError_t err = cudaFuncSetAttribute(
      double_conv3x3_relu_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + TH - 1) / TH;
  const int tiles_w = (wd + TW - 1) / TW;
  const long long blocks = (long long)n * tiles_h * tiles_w;
  if (!cid::grid_fits(blocks)) return cudaErrorInvalidConfiguration;
  double_conv3x3_relu_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(y), h, wd, c0, c1, c2,
      c1p, tiles_h, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cid_double_conv3x3_relu(const void* x, const void* w1,
                                       const void* b1, const void* w2,
                                       const void* b2, void* y, int n, int h,
                                       int wd, int c0, int c1, int c2,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == cid::kDtypeF32)
    return (int)launch<float>(x, w1, b1, w2, b2, y, n, h, wd, c0, c1, c2, s);
  if (dtype == cid::kDtypeBF16)
    return (int)launch<__nv_bfloat16>(x, w1, b1, w2, b2, y, n, h, wd, c0, c1,
                                      c2, s);
  return (int)cudaErrorInvalidValue;
}
