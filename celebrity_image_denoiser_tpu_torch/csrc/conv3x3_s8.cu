// 3x3 'same' convolution, stride 1, s8 x s8 -> s32, with the s8 program's
// epilogue (K5 of the port).
//
// No TPU kernel: the JAX package computes these convs in XLA
// (celebrity_image_denoiser_tpu/ops/quant_unet.py::_conv_q:55, and the
// generic transform's replay, ops/quant.py:247-251), and PyTorch has no CUDA
// int8 convolution.  It carries the nine 3x3 int8 convs of the s8
// skip-storage U-Net (convs 1-5, 7, 8, 10, 11) and the generic transform's
// 3x3 convs.
//
// Layout: x (N,H,W,Ca) s8 NHWC and optionally x2 (N,H,W,Cb), a strided view
// with contiguous channels, standing for cat([x, x2], channels): the U-Net's
// skip concats are read in place.  W (Cout,3,3,Cin) s8 ("OHWI": input
// channels contiguous, as mma.sync's col-major B wants them), w_scale
// (Cout,) f32, bias (Cout,) bf16, s_next (Cout,) f32.  Output y (N,H,W,Cout)
// dense: s8 at s_next, bf16, or the raw f32(acc) * w_scale (conv_s8.cuh).
// Ca and Cb multiples of 32; any H, W, Cout; ragged tiles are masked.
//
// What bounds it on an H100: the U-Net's convs do 2 * 9 * Cin * Cout
// operations per pixel against Cin + Cout bytes, far above the card's int8
// ridge (about 590 operations a byte at 1979 TOP/s and 3.35 TB/s), so the
// tensor cores; the Cout = 3 output conv is bound by reading its input.
//
// Design, simple first: mma.sync m16n8k32 (s8 in, s32 accumulate) per 16x16
// output tile, one work item = (tile, 64-channel output pass, 32-channel
// chunk).  Eight warps, each two tile rows (two m16 position tiles) by the
// pass's eight n8 blocks; A comes by ldmatrix_x4 from the 18x18 halo window
// (a tap is a shift of the row addresses, no im2col), B by ldmatrix from the
// chunk's [tap][n][32] weight rows.  Every thread starts 16-byte cp.async
// copies of the next item into the other half of a two-stage ring.  Blocks
// are persistent (two per SM).  Cout <= 8 (the output conv) runs one n8
// block per pass.  Weights are re-read from L2 with every item.  (Four tile
// rows a warp, a three-stage ring and one block per SM was tried and was
// slower: PERF.md.)

#include <cstdint>

#include "common.cuh"
#include "conv_s8.cuh"

namespace {

namespace conv = cid::conv;
namespace mma = cid::mma;
namespace s8 = cid::s8;

constexpr int kThreads = 256;   // eight warps, two tile rows each
constexpr int kTile = 16;       // output tile, pixels a side
constexpr int kWin = kTile + 2;  // its halo window
constexpr int kWinBytes = kWin * kWin * s8::kRowBytes;

template <int NT>  // n8 blocks per output pass
__host__ __device__ constexpr int stage_bytes() {
  return kWinBytes + 9 * NT * 8 * s8::kRowBytes;
}

struct TileAt { int n, y0, x0; };
__device__ __forceinline__ TileAt tile_at(int t, int tiles_h, int tiles_w) {
  TileAt r;
  r.x0 = (t % tiles_w) * kTile;
  t /= tiles_w;
  r.y0 = (t % tiles_h) * kTile;
  r.n = t / tiles_h;
  return r;
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_s8_kernel(s8::Input in, const int8_t* __restrict__ w,
                  const float* __restrict__ wscale,
                  const conv::bf16* __restrict__ bias,
                  const float* __restrict__ snext, void* __restrict__ y,
                  int H, int W, int Cout, int relu, int mode, int tiles_h,
                  int tiles_w, int total_tiles) {
  constexpr int NB = NT * 8;  // output channels per pass
  constexpr int SB = stage_bytes<NT>();
  extern __shared__ __align__(1024) unsigned char smem_s8[];
  const int Cin = in.a.C + in.b.C;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int nchunks = Cin / s8::kKC;
  const int npass = (Cout + NB - 1) / NB;
  const int units = total_tiles * npass;  // (tile, pass)
  const int my_units =
      (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nitems = my_units * nchunks;

  float* cbuf = reinterpret_cast<float*>(smem_s8 + 2 * SB);
  const s8::Consts k{cbuf, cbuf + npass * NB, cbuf + 2 * npass * NB};
  s8::load_consts(k, wscale, bias, snext, Cout, npass * NB, tid, kThreads);

  auto fill = [&](int item, int stage) {
    const int u = (int)blockIdx.x + (item / nchunks) * (int)gridDim.x;
    const int c0 = (item % nchunks) * s8::kKC;
    const TileAt at = tile_at(u / npass, tiles_h, tiles_w);
    const int n0 = (u % npass) * NB;
    const uint32_t st = mma::smem_u32(smem_s8 + stage * SB);
    const s8::Image im = in.of(c0, at.n);
    const int cl = in.local(c0);
    for (int i = tid; i < kWin * kWin * 2; i += kThreads) {
      const int p = i / 2, j = i % 2;
      const int gy = at.y0 - 1 + p / kWin, gx = at.x0 - 1 + p % kWin;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int8_t* src =
          ok ? im.p + ((long long)gy * im.sh + (long long)gx * im.sw + cl +
                       16 * j)
             : im.p;
      mma::cp_async16(s8::row_addr(st, p, j), src, ok);
    }
    const uint32_t wst = st + kWinBytes;  // rows (tap, n): [9][NB][32]
    for (int i = tid; i < 9 * NB * 2; i += kThreads) {
      const int r = i / 2, j = i % 2;
      const int tap = r / NB, co = n0 + r % NB;
      const bool ok = co < Cout;
      const int8_t* src =
          ok ? w + ((long long)co * 9 + tap) * Cin + c0 + 16 * j : w;
      mma::cp_async16(s8::row_addr(wst, r, j), src, ok);
    }
  };

  int pbase[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    pbase[mt] = (warp * 2 + mt) * kWin + conv::ldm_row();
  const int khalf = conv::ldm_khalf();

  int acc[2][NT][4];
  if (nitems > 0) fill(0, 0);
  mma::cp_async_commit();
  for (int item = 0; item < nitems; ++item) {
    const int stage = item & 1;
    if (item + 1 < nitems) fill(item + 1, stage ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if (item % nchunks == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < NT; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0;
    }
    const uint32_t st = mma::smem_u32(smem_s8 + stage * SB);
    const uint32_t wst = st + kWinBytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * kWin + tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma::ldmatrix_x4(a[mt], s8::row_addr(st, pbase[mt] + shift, khalf));
      if constexpr (NT == 1) {
        uint32_t b[2];
        mma::ldmatrix_x2(b, s8::row_addr(wst, tap * NB + lane % 8,
                                         s8::b_piece()));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma::mma_m16n8k32_s8(acc[mt][0], a[mt], b);
      } else {
#pragma unroll
        for (int nb = 0; nb < NT; nb += 2) {
          uint32_t b4[4];
          mma::ldmatrix_x4(b4, s8::row_addr(wst, tap * NB + nb * 8 + s8::b_row(),
                                            s8::b_piece()));
          const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma::mma_m16n8k32_s8(acc[mt][nb], a[mt], b0);
            mma::mma_m16n8k32_s8(acc[mt][nb + 1], a[mt], b1);
          }
        }
      }
    }
    if (item % nchunks == nchunks - 1) {
      const int u = (int)blockIdx.x + (item / nchunks) * (int)gridDim.x;
      const TileAt at = tile_at(u / npass, tiles_h, tiles_w);
      const int n0 = (u % npass) * NB;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int gy = at.y0 + warp * 2 + mt;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int gx = at.x0 + g + 8 * hf;
          if (gy >= H || gx >= W) continue;
          const long long off =
              (((long long)at.n * H + gy) * W + gx) * (long long)Cout;
#pragma unroll
          for (int nb = 0; nb < NT; ++nb)
            s8::store_pair(y, off, n0 + nb * 8 + 2 * q, Cout,
                           acc[mt][nb][2 * hf], acc[mt][nb][2 * hf + 1], k,
                           mode, relu != 0, Cout % 2 == 0);
        }
      }
    }
    __syncthreads();
  }
}

template <int NT>
cudaError_t launch(const s8::Input& in, const int8_t* w, const float* ws,
                   const conv::bf16* b, const float* sn, void* y, int n,
                   int h, int wd, int cout, int relu, int mode,
                   cudaStream_t stream) {
  constexpr int NB = NT * 8;
  const int npass = (cout + NB - 1) / NB;
  const int smem = 2 * stage_bytes<NT>() + 3 * npass * NB * 4;
  if (smem > conv::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_s8_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + kTile - 1) / kTile, tiles_w = (wd + kTile - 1) / kTile;
  const long long tiles = (long long)n * tiles_h * tiles_w;
  const int sms = conv::sm_count();
  if (!cid::grid_fits(tiles * npass) || sms <= 0)
    return cudaErrorInvalidConfiguration;
  const long long units = tiles * npass;
  const unsigned grid = (unsigned)(units < 2 * sms ? units : 2 * sms);
  conv3x3_s8_kernel<NT><<<grid, kThreads, smem, stream>>>(
      in, w, ws, b, sn, y, h, wd, cout, relu, mode, tiles_h, tiles_w,
      (int)tiles);
  return cudaGetLastError();
}

bool image_ok(const void* p, long long sn, long long sh, long long sw,
              int c) {
  return p != nullptr && conv::aligned16(p) && c % s8::kKC == 0 &&
         sn % 16 == 0 && sh % 16 == 0 && sw % 16 == 0 &&
         conv::strides_fit(sh, sw);
}

}  // namespace

// x2 may be null (cb = 0); strides in elements (bytes).  mode: 0 s8 out at
// s_next, 1 bf16 out, 2 the raw f32 product (bias, s_next unused).
extern "C" int cid_conv3x3_s8(const void* x, const void* x2, const void* w,
                              const void* wscale, const void* bias,
                              const void* snext, void* y, int n, int h,
                              int wd, int ca, int cb, int cout, int relu,
                              int mode, long long x2_sn, long long x2_sh,
                              long long x2_sw, void* stream) {
  const long long sh = (long long)wd * ca, sn = sh * h;
  if (n < 1 || h < 1 || wd < 1 || cout < 1 || ca < 1 ||
      !image_ok(x, sn, sh, ca, ca) || !conv::aligned16(w) ||
      (x2 != nullptr && (cb < 1 || !image_ok(x2, x2_sn, x2_sh, x2_sw, cb))) ||
      (x2 == nullptr && cb != 0) || mode < 0 || mode > 2 ||
      (mode != s8::kOutF32 && bias == nullptr) ||
      (mode == s8::kOutS8 && snext == nullptr) ||
      (mode == s8::kOutF32 && relu))
    return (int)cudaErrorInvalidValue;
  const s8::Input in{
      s8::Image{static_cast<const int8_t*>(x), sn, ca, (int)sh, ca},
      s8::Image{static_cast<const int8_t*>(x2 ? x2 : x), x2_sn, cb, (int)x2_sh,
                (int)x2_sw}};
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* ws = static_cast<const float*>(wscale);
  const auto* b = static_cast<const conv::bf16*>(bias);
  const auto* sn8 = static_cast<const float*>(snext);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 8)
    return (int)launch<1>(in, wq, ws, b, sn8, y, n, h, wd, cout, relu, mode, s);
  return (int)launch<8>(in, wq, ws, b, sn8, y, n, h, wd, cout, relu, mode, s);
}
