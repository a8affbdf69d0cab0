// K8: depthwise 3x3 'same' convolution over NHWC float32, with an optional
// gated-GELU epilogue.  Restormer's two depthwise convs (Zamir et al., CVPR
// 2022, restormer_arch.py): MDTA's qkv_dwconv (3C channels in and out, no
// gate) and GDFN's dwconv followed by its gate (2 hidden channels in,
// hidden out: y[c] = gelu(dw(x)[c]) * dw(x)[c + hidden], GELU in its exact
// erf form), so that the 2 hidden-channel result of the conv is never
// written to device memory.
//
// No TPU kernel precedes it: the JAX package serves no model with a
// depthwise conv.  It is written for Hopper from the start.
//
// Layout: x (N,H,W,Cx) NHWC f32, contiguous; w (3,3,Cx) f32, tap-major (the
// published (Cx,1,3,3) weight permuted); y (N,H,W,Co) with Co = Cx, or Cx/2
// with the gate.  No bias (Restormer's convs have none).  Any H, W, Cx.
//
// What bounds it on an H100: bytes.  A pixel-channel takes 9 FMAs against
// 4 bytes in and 4 out (8 in with the gate), far under the card's ridge
// point; at 1024^2 GDFN's dwconv at 510 -> 255 channels moves 3.2 GB, 0.96
// ms at 3.35 TB/s.  Hence:
//   * a block is 64 consecutive channels x 4 groups of 4 columns (256
//     threads); a warp's lanes read 32 consecutive channels of one pixel,
//     so every load and store is a contiguous 128-byte run;
//   * a thread walks kRows rows of its 4 columns down a rolling 3 x 6
//     window in registers: each step loads one new row of six pixels (1.5
//     loads an output; the two edge ones are its neighbours' own loads,
//     served by L1) and keeps the other two rows, so DRAM sees each input
//     about once.  One column a thread (three loads an output) ran at 38-47%
//     of the bound at 1024^2, cuDNN's depthwise conv at 78% without the gate;
//   * a thread's 9 (18 with the gate) weights sit in registers;
//   * the sum of each output runs over the taps in row-major order, one FMA
//     each: no split, no atomics, so two runs are bit-equal.
// With the gate, channels are not vectorised: GDFN's hidden widths (127,
// 255, 510, 1021 in the published model) put the gate's second half at an
// odd offset.  Without it (MDTA's 3C: 144 to 1152 channels, all multiples
// of 4), a thread owns four channels as one float4 and the block's threads
// are laid flat over (channel group, column pair) of a strip: a warp reads
// 512 contiguous bytes of a pixel, no lane idles where 64 does not divide
// the width, and a thread issues a quarter of the loads.  The scalar body
// (one channel a thread, 64 a block) ran the 1024^2 x 288 conv at 63% of
// its bound, behind cuDNN's 79%; four channels x two columns x eight rows a
// thread ran it at 82-83% (ahead of cuDNN), four columns 68%, sixteen rows
// 79%, a prefetched row 67%.  The taps' order and FMAs are the scalar body's,
// so the two bodies give the same bits.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCh = 64;     // channels a block
constexpr int kGroups = 4;  // column groups a block
constexpr int kPerT = 4;    // columns a thread
constexpr int kCols = kGroups * kPerT;  // columns a block
constexpr int kRows = 8;    // rows a thread walks
constexpr int kThreads = kCh * kGroups;
constexpr int kWin = kPerT + 2;  // a thread's window row
// the float4 body (no gate, Cx % 4 == 0)
constexpr int kVecCols = 2;  // columns a thread
constexpr int kVecRows = 8;  // rows a thread walks
constexpr int kVecWin = kVecCols + 2;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
}

// row ``row`` of one image's channel plane c at columns col0 - 1 ..
// col0 + kPerT, zero outside the image
__device__ __forceinline__ void load_row(float (&r)[kWin], const float* img,
                                         int row, int col0, int h, int wd,
                                         int cx, int c) {
  const bool in = row >= 0 && row < h;
  const float* line = img + (long long)row * wd * cx + c;
  for (int j = 0; j < kWin; ++j) {
    const int col = col0 - 1 + j;
    r[j] = in && col >= 0 && col < wd ? line[(long long)col * cx] : 0.f;
  }
}

// the tap sum of output column j of the window, taps in row-major order
__device__ __forceinline__ float taps(const float (&a)[3][kWin],
                                      const float (&w)[9], int j) {
  float s = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int jj = 0; jj < 3; ++jj) s = fmaf(a[i][j + jj], w[i * 3 + jj], s);
  return s;
}

__device__ __forceinline__ void fma4(float4& s, float4 v, float4 k) {
  s.x = fmaf(v.x, k.x, s.x);
  s.y = fmaf(v.y, k.y, s.y);
  s.z = fmaf(v.z, k.z, s.z);
  s.w = fmaf(v.w, k.w, s.w);
}

// The float4 body: thread t of block b owns item b * kThreads + t of
// (image, strip of kVecRows rows, pair of columns, group of 4 channels),
// the channel group fastest.
__device__ __forceinline__ void dwconv3x3_x4(const float* __restrict__ x,
                                             const float* __restrict__ w,
                                             float* __restrict__ y, int n,
                                             int h, int wd, int cx) {
  const int groups = cx / 4;
  const int pairs = (wd + kVecCols - 1) / kVecCols;
  const int strips = (h + kVecRows - 1) / kVecRows;
  long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int g = (int)(item % groups);
  item /= groups;
  const int col0 = (int)(item % pairs) * kVecCols;
  item /= pairs;
  const int row0 = (int)(item % strips) * kVecRows;
  const long long img = item / strips;
  if (img >= n) return;
  const long long plane = (long long)h * wd * groups;  // float4s an image
  const float4* xi = reinterpret_cast<const float4*>(x) + img * plane + g;
  float4* yi = reinterpret_cast<float4*>(y) + img * plane + g;
  const long long line = (long long)wd * groups;  // float4s a row
  float4 wt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k)
    wt[k] = reinterpret_cast<const float4*>(w + (long long)k * cx)[g];
  float4 a[3][kVecWin];
  // row ``row`` at columns col0 - 1 .. col0 + kVecCols, zero outside
  auto load = [&](float4 (&r)[kVecWin], int row) {
    const bool in = row >= 0 && row < h;
#pragma unroll
    for (int j = 0; j < kVecWin; ++j) {
      const int col = col0 - 1 + j;
      r[j] = in && col >= 0 && col < wd
                 ? xi[row * line + (long long)col * groups]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load(a[0], row0 - 1);
  load(a[1], row0);
#pragma unroll
  for (int i = 0; i < kVecRows; ++i) {
    const int row = row0 + i;
    if (row >= h) break;
    load(a[2], row + 1);
#pragma unroll
    for (int j = 0; j < kVecCols; ++j) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int ii = 0; ii < 3; ++ii)
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) fma4(s, a[ii][j + jj], wt[ii * 3 + jj]);
      if (col0 + j < wd) yi[row * line + (long long)(col0 + j) * groups] = s;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < kVecWin; ++j) a[r][j] = a[r + 1][j];
  }
}

// kVec 4: the float4 body (no gate).  kVec 1: blockIdx.x is a (image,
// strip of kRows rows, group of kCols columns) tile, blockIdx.y a group of
// kCh output channels.
template <bool kGate, int kVec>
__global__ void __launch_bounds__(kThreads) dwconv3x3_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ y, int n, int h, int wd, int cx, int co) {
  if constexpr (kVec == 4) {
    static_assert(!kGate, "the float4 body has no gate");
    dwconv3x3_x4(x, w, y, n, h, wd, cx);
    return;
  }
  const int t = threadIdx.x;
  const int c = blockIdx.y * kCh + t % kCh;
  const int tiles_w = (wd + kCols - 1) / kCols;
  const int strips = (h + kRows - 1) / kRows;
  long long tile = blockIdx.x;
  const int col0 = (int)(tile % tiles_w) * kCols + (t / kCh) * kPerT;
  tile /= tiles_w;
  const int row0 = (int)(tile % strips) * kRows;
  const long long img_n = tile / strips;
  if (c >= co || col0 >= wd) return;  // no barrier below: a lane may leave
  const int row1 = min(row0 + kRows, h);
  float wa[9], wb[9];
  for (int k = 0; k < 9; ++k) {
    wa[k] = w[(long long)k * cx + c];
    wb[k] = kGate ? w[(long long)k * cx + c + co] : 0.f;
  }
  const float* img = x + img_n * h * wd * cx;
  float* out = y + img_n * h * wd * co;
  float a[3][kWin], b[3][kWin];
  load_row(a[0], img, row0 - 1, col0, h, wd, cx, c);
  load_row(a[1], img, row0, col0, h, wd, cx, c);
  if (kGate) {
    load_row(b[0], img, row0 - 1, col0, h, wd, cx, c + co);
    load_row(b[1], img, row0, col0, h, wd, cx, c + co);
  }
  for (int row = row0; row < row1; ++row) {
    load_row(a[2], img, row + 1, col0, h, wd, cx, c);
    if (kGate) load_row(b[2], img, row + 1, col0, h, wd, cx, c + co);
    float* line = out + (long long)row * wd * co + c;
    for (int j = 0; j < kPerT; ++j) {
      float v = taps(a, wa, j);
      if (kGate) v = gelu_erf(v) * taps(b, wb, j);
      if (col0 + j < wd) line[(long long)(col0 + j) * co] = v;
    }
    for (int j = 0; j < kWin; ++j) {
      a[0][j] = a[1][j];
      a[1][j] = a[2][j];
      if (kGate) {
        b[0][j] = b[1][j];
        b[1][j] = b[2][j];
      }
    }
  }
}

}  // namespace

// f32 x (N,H,W,Cx) -> f32 y (N,H,W,Co): Co = Cx, or with gate != 0, Co =
// Cx / 2 and y = gelu(dw[:Co]) * dw[Co:] (Cx even).  Returns a CUDA error
// code (0: launched).
extern "C" int cid_dwconv3x3(const void* xv, const void* wv, void* yv, int n,
                             int h, int wd, int cx, int gate, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cx < 1 || (gate && cx % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const int co = gate ? cx / 2 : cx;
  const float* x = static_cast<const float*>(xv);
  const float* w = static_cast<const float*>(wv);
  float* y = static_cast<float*>(yv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool x4 = !gate && cx % 4 == 0 &&
                  ((uintptr_t)xv | (uintptr_t)wv | (uintptr_t)yv) % 16 == 0;
  if (x4) {
    const long long items = (long long)n * ((h + kVecRows - 1) / kVecRows) *
                            ((wd + kVecCols - 1) / kVecCols) * (cx / 4);
    const long long blocks = (items + kThreads - 1) / kThreads;
    if (!cid::grid_fits(blocks)) return (int)cudaErrorInvalidConfiguration;
    dwconv3x3_f32_kernel<false, 4><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, w, y, n, h, wd, cx, co);
    return (int)cudaGetLastError();
  }
  const long long tiles = (long long)n * ((h + kRows - 1) / kRows) *
                          ((wd + kCols - 1) / kCols);
  if (!cid::grid_fits(tiles)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)((co + kCh - 1) / kCh));
  if (gate)
    dwconv3x3_f32_kernel<true, 1><<<grid, kThreads, 0, s>>>(x, w, y, n, h,
                                                            wd, cx, co);
  else
    dwconv3x3_f32_kernel<false, 1><<<grid, kThreads, 0, s>>>(x, w, y, n, h,
                                                             wd, cx, co);
  return (int)cudaGetLastError();
}
