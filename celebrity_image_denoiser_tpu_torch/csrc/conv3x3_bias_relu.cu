// 3x3 'same' convolution, stride 1, with fused bias and optional ReLU.
//
// Replaces (one kernel, two Python entry points in ops/cuda/conv3x3.py):
//   celebrity_image_denoiser_tpu/ops/pallas/conv_fused.py::conv3x3_bias_relu    (:143, halo DMA)
//   celebrity_image_denoiser_tpu/ops/pallas/conv_fused.py::conv3x3_bias_relu_v2 (:85, shifted inputs)
// Both compute y = maybe_relu(conv3x3_same(x, W) + b) with f32 accumulation
// and store y in x's dtype; they differ only in how the TPU moves data, so
// on Hopper they are one kernel.
//
// Layout: x (N,H,W,Cin) NHWC, W (3,3,Cin,Cout) HWIO in x's dtype, b (Cout,)
// float32, y (N,H,W,Cout) NHWC.
//
// What bounds it on an H100: upconv1.0 (Cin 128 -> Cout 64) is above the
// card's bf16 ridge point, so bound by operations; upconv1.2 (64 -> 3) is
// below it, bound by reading its input.  This first version runs the
// products on the CUDA cores in f32 FMA, not on the tensor cores, so it
// sits well above its bound; the design keeps what makes it right and cheap
// to move to mma/wgmma later:
//   * one block computes a TH x TW output tile for COT output channels;
//     the (TH+2) x (TW+2) halo window is staged in shared memory with zeros
//     outside the image (the ragged H/W edges are masked, no tile divides
//     the image), so each activation is read from device memory once per
//     channel tile instead of nine times;
//   * Cin is walked in CIC-wide chunks (window + 9*CIC*COT weights in
//     shared memory), accumulating the nine taps in registers;
//   * each thread owns PPT pixels of one tile row x 4 output channels, so a
//     row of PPT+2 window values is reused across the three dx taps and one
//     float4 of weights across PPT pixels;
//   * bias + ReLU run in the f32 epilogue, and channels >= Cout are never
//     stored (Cout = 3 for upconv1.2 is not padded into the output).
// The TPU artifacts of the Pallas version (channel padding to 128 lanes,
// H % tile_h == 0) are not carried over.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int TH, int TW, int COT, int CIC>
__global__ void __launch_bounds__(kThreads)
conv3x3_bias_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ bias, T* __restrict__ y,
                         int H, int W, int Cin, int Cout, int relu,
                         int tiles_h, int tiles_w) {
  constexpr int CG = COT / 4;        // groups of 4 output channels
  constexpr int PG = kThreads / CG;  // pixel groups
  constexpr int PPT = TH * TW / PG;  // pixels per thread, along one row
  constexpr int GPR = TW / PPT;      // pixel groups per tile row
  static_assert(COT % 4 == 0 && kThreads % CG == 0, "channel tiling");
  static_assert((TH * TW) % PG == 0 && TW % PPT == 0 && PG == TH * GPR,
                "pixel tiling");
  constexpr int IH = TH + 2, IW = TW + 2, IHW = IH * IW;

  // window as [c][row][col]; weights as [tap][c][co]
  __shared__ float xs[CIC * IHW];
  __shared__ __align__(16) float ws[9 * CIC * COT];

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int pg = tid / CG;
  const int pr = pg / GPR;          // tile row of this thread's pixels
  const int pc = (pg % GPR) * PPT;  // first tile column

  int t = blockIdx.x;
  const int tx = t % tiles_w;
  t /= tiles_w;
  const int ty = t % tiles_h;
  const int n = t / tiles_h;
  const int y0 = ty * TH, x0 = tx * TW;
  const int co0 = blockIdx.y * COT;
  const size_t img = (size_t)n * H * W;

  float acc[PPT][4];
#pragma unroll
  for (int j = 0; j < PPT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CIC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < CIC * IHW; i += kThreads) {
      const int c = i % CIC;
      const int p = i / CIC;
      const int gy = y0 - 1 + p / IW;
      const int gx = x0 - 1 + p % IW;
      const int gc = ci0 + c;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Cin)
        v = cid::to_f32(x[(img + (size_t)gy * W + gx) * Cin + gc]);
      xs[c * IHW + p] = v;
    }
    for (int i = tid; i < 9 * CIC * COT; i += kThreads) {
      const int co = i % COT;
      const int r = i / COT;
      const int c = r % CIC;
      const int tap = r / CIC;
      const int gc = ci0 + c, gco = co0 + co;
      float v = 0.f;
      if (gc < Cin && gco < Cout)
        v = cid::to_f32(w[((size_t)tap * Cin + gc) * Cout + gco]);
      ws[i] = v;
    }
    __syncthreads();

    for (int c = 0; c < CIC; ++c) {
      const float* xc = xs + c * IHW;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xv[PPT + 2];
#pragma unroll
        for (int j = 0; j < PPT + 2; ++j) xv[j] = xc[(pr + dy) * IW + pc + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(
              &ws[((dy * 3 + dx) * CIC + c) * COT + cg * 4]);
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            const float a = xv[j + dx];
            acc[j][0] = fmaf(a, wv.x, acc[j][0]);
            acc[j][1] = fmaf(a, wv.y, acc[j][1]);
            acc[j][2] = fmaf(a, wv.z, acc[j][2]);
            acc[j][3] = fmaf(a, wv.w, acc[j][3]);
          }
        }
      }
    }
  }

  const int gy = y0 + pr;
  if (gy >= H) return;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int gx = x0 + pc + j;
    if (gx >= W) continue;
    T* out = y + (img + (size_t)gy * W + gx) * Cout;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int co = co0 + cg * 4 + k;
      if (co >= Cout) continue;
      float v = acc[j][k] + bias[co];
      if (relu) v = cid::relu_f32(v);
      out[co] = cid::from_f32<T>(v);
    }
  }
}

template <typename T, int TH, int TW, int COT, int CIC>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int n, int h, int wd, int cin, int cout, int relu,
                   cudaStream_t stream) {
  const int tiles_h = (h + TH - 1) / TH;
  const int tiles_w = (wd + TW - 1) / TW;
  const long long blocks = (long long)n * tiles_h * tiles_w;
  if (!cid::grid_fits(blocks)) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks, (unsigned)((cout + COT - 1) / COT));
  conv3x3_bias_relu_kernel<T, TH, TW, COT, CIC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), h, wd, cin, cout,
      relu, tiles_h, tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* y,
                     int n, int h, int wd, int cin, int cout, int relu,
                     cudaStream_t stream) {
  // Narrow outputs (upconv1.2: Cout = 3) take a 4-channel tile over a wide
  // pixel tile instead of wasting 61 of 64 channel lanes.
  if (cout <= 4)
    return launch<T, 32, 64, 4, 4>(x, w, b, y, n, h, wd, cin, cout, relu,
                                   stream);
  return launch<T, 16, 8, 64, 8>(x, w, b, y, n, h, wd, cin, cout, relu,
                                 stream);
}

}  // namespace

extern "C" int cid_conv3x3_bias_relu(const void* x, const void* w,
                                     const void* b, void* y, int n, int h,
                                     int wd, int cin, int cout, int relu,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == cid::kDtypeF32)
    return (int)dispatch<float>(x, w, b, y, n, h, wd, cin, cout, relu, s);
  if (dtype == cid::kDtypeBF16)
    return (int)dispatch<__nv_bfloat16>(x, w, b, y, n, h, wd, cin, cout, relu,
                                        s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
