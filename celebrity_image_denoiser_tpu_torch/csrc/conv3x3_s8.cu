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
// channels contiguous, the K-major B that the s8 wgmma takes), w_scale
// (Cout,) f32, bias (Cout,) bf16, s_next (Cout,) f32.  Output y (N,H,W,Cout)
// dense: s8 at s_next, bf16, or the raw f32(acc) * w_scale (conv_s8.cuh).
// Ca and Cb multiples of 32, Ca + Cb <= 256; any H, W, Cout; ragged tiles
// are masked.
//
// What bounds it on an H100: the U-Net's convs do 2 * 9 * Cin * Cout
// operations per pixel against Cin + Cout bytes, far above the card's int8
// ridge (about 590 operations a byte at 1979 TOP/s and 3.35 TB/s), so the
// tensor cores; the Cout = 3 output conv is bound by reading its input.
//
// Design (Cout > 8): an implicit GEMM per 16x16-pixel tile on the s8 wgmma
// m64n64k32, in the shape of the bf16 kernels (conv_mma.cuh).  A
// persistent block owns one 64-channel output block and walks its tiles, so
// the block's weight slice (9 x Cin x 64 bytes: 36,864 at Cin 64, 147,456
// at Cin 256) is copied into shared memory once, with the first tile, and
// stays; only the 18x18 halo windows stream, 64 channels (two 32-channel
// windows) a work item, through a ring of as many stages (two to four) as
// fit beside the weights.  One producer warpgroup only starts the cp.async
// copies (setmaxnreg hands its registers to the consumers); four consumer
// warpgroups each own one 64-position m-tile (four tile rows, a warp per
// row), take A by ldmatrix_x4 from the window (a tap is a shift of the row
// addresses, no im2col) and B, the tap's 64 x 32-byte K-major weight rows,
// through the wgmma descriptor; a work item's last batch of wgmmas runs on
// into the next item.  The epilogue (conv_s8.cuh) stages each warp's 16
// pixels x 64 channels in shared memory and writes every pixel's channel
// run with 16-byte stores; sixteen consumer warps rather than eight hide
// its dependent steps' latency, and it overlaps the producer's copies of
// the next tile.  Cout <= 8 (the output conv, bound by its input bytes)
// keeps mma.sync m16n8k32 with one n8 block: eight warps of two tile rows
// each, a two-stage ring that every thread feeds, two blocks per SM.

#include <cstdint>

#include "common.cuh"
#include "conv_s8.cuh"

namespace {

namespace conv = cid::conv;
namespace mma = cid::mma;
namespace s8 = cid::s8;

constexpr int kTile = 16;        // output tile, pixels a side
constexpr int kWin = kTile + 2;  // its halo window
constexpr int kWinBytes = kWin * kWin * s8::kRowBytes;  // 10,368
constexpr int kMaxCin = 256;     // the weight slice stays in shared memory

struct TileAt { int n, y0, x0; };
__device__ __forceinline__ TileAt tile_at(int t, int tiles_h, int tiles_w) {
  TileAt r;
  r.x0 = (t % tiles_w) * kTile;
  t /= tiles_w;
  r.y0 = (t % tiles_h) * kTile;
  r.n = t / tiles_h;
  return r;
}

// ---- Cout > 8: wgmma ------------------------------------------------------
constexpr int kNB = 64;  // output channels of a block (the wgmma's N)
constexpr int kTapBytes = kNB * s8::kRowBytes;  // B tile of one tap, chunk
constexpr int kChunkWBytes = 9 * kTapBytes;     // a chunk's weights: 18,432
constexpr int kSub = 2;  // 32-channel chunks per work item
constexpr int kStageBytes = kSub * kWinBytes;  // an item's windows
// Four consumer warpgroups, each one m64 position tile (four tile rows, a
// warp per row), and one producer warpgroup: sixteen warps share the
// epilogue, whose dependent steps want many warps in flight.
constexpr int kConsumerWGs = 4;
constexpr int kMT = 4 / kConsumerWGs;  // m64 position tiles per warpgroup
constexpr int kConsumers = 128 * kConsumerWGs, kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;
// registers a thread: what the launch gives every thread (the compiler
// uses all of it in a kernel with setmaxnreg), then the split
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 56, kConsumerRegs = 104;
static_assert(kConsumers * kConsumerRegs + kProducers * kProducerRegs <=
                  kLaunchRegs * kThreads,
              "setmaxnreg.inc would wait for registers that never come");
constexpr int kWarpPix = kMT * kTile;  // pixels a consumer warp stores
template <int ES>
using WarpStaging = s8::Staging<ES, kWarpPix>;
// staged outputs of the consumer warps (none for the f32 product)
__host__ __device__ constexpr int out_bytes(int mode) {
  return mode == s8::kOutS8     ? kConsumers / 32 * WarpStaging<1>::kBytes
         : mode == s8::kOutBF16 ? kConsumers / 32 * WarpStaging<2>::kBytes
                                : 0;
}
__host__ __device__ constexpr int wide_smem(int nchunks, int mode,
                                            int stages) {
  return nchunks * kChunkWBytes + stages * kStageBytes + out_bytes(mode) +
         s8::consts_bytes(kNB);
}

// Where a block's walk over its (tile, step) items stands, step s covering
// chunks kSub * s, ...; producers and consumers each carry their own along,
// so no item costs a division.
struct Cursor {
  int chunk, tile;  // chunk: the item's step within its tile
  TileAt at;
  __device__ __forceinline__ void start(int t, int tiles_h, int tiles_w) {
    chunk = 0;
    tile = t;
    at = tile_at(tile, tiles_h, tiles_w);
  }
  __device__ __forceinline__ void advance(int nchunks, int step, int tiles_h,
                                          int tiles_w) {
    if (++chunk < nchunks) return;
    chunk = 0;
    tile += step;
    at = tile_at(tile, tiles_h, tiles_w);
  }
};

// acc (+)= the item's nsub (1 or 2) chunks, nine taps each: A, the
// chunk's window at st + s * kWinBytes, B, its weights at wc + s *
// kChunkWBytes.  The (chunk, tap) steps run in batches of three: a batch's
// A fragments are loaded into a, then its wgmmas started under one fence
// and one commit; the fragments are double-buffered, so a batch loads
// while the one before runs.  The wgmmas read only registers and the
// resident weights, so the item's window is free once its fragments are
// loaded: unless `drain` (the tile's last item, whose sums the epilogue
// reads, or an odd number of batches), the last batch is left running
// into the next item, and the tensor cores do not idle across the ring's
// barriers.
constexpr int kBatch = 3;
__device__ __forceinline__ void mma_item(int (&acc)[kMT][32],
                                         uint32_t (&a)[2][kBatch][kMT][4],
                                         uint32_t st, uint32_t wc, int nsub,
                                         const int (&pbase)[kMT], int khalf,
                                         bool accumulate, bool drain) {
#pragma unroll
  for (int b0 = 0; b0 < 9 * kSub; b0 += kBatch) {
    const int par = (b0 / kBatch) & 1, s = b0 / 9;
    if (s >= nsub) break;
    const uint32_t sw = st + s * kWinBytes;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int tap = (b0 + i) % 9, shift = (tap / 3) * kWin + tap % 3;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        mma::ldmatrix_x4(a[par][i][mt],
                         s8::row_addr(sw, pbase[mt] + shift, khalf));
    }
    mma::wgmma_fence();
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int tap = (b0 + i) % 9;
      const uint64_t desc = mma::wgmma_desc_k32(wc + s * kChunkWBytes +
                                                tap * kTapBytes);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        mma::wgmma_m64n64k32_s8(acc[mt], a[par][i][mt], desc,
                                accumulate || b0 + i > 0);
    }
    mma::wgmma_commit();
    mma::wgmma_wait<1>();  // the other buffer's products are done
  }
  if (drain) mma::wgmma_wait<0>();
}

// A consumer warp's s8 or bf16 outputs: its tile rows (row0, row0 + 4,
// ...) staged, then written as 16-byte chunks of each pixel's channel run.
template <int ES>
__device__ __forceinline__ void epilogue_staged(
    const int (&acc)[kMT][32], const s8::Consts& k, unsigned char* buf,
    bool relu, int row0, const TileAt& at, void* y, int H, int W, int Cout,
    int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const WarpStaging<ES> stg{buf};
  // channel pair by channel pair, so that only one pair's constants are
  // live beside the accumulators
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * i + 2 * q;
    const s8::Pair kc = s8::pair_at(k, c);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float h0, h1;
        s8::dequant2(acc[mt][4 * i + 2 * hf], acc[mt][4 * i + 2 * hf + 1], kc,
                     relu, h0, h1);
        stg.put(mt * kTile + g + 8 * hf, c,
                ES == 1 ? s8::quantize2(h0, h1, kc)
                        : s8::pack_bf16x2(h0, h1));
      }
  }
  mma::warp_sync();
  const int valid = Cout - n0 < kNB ? Cout - n0 : kNB;
  stg.flush(valid, (Cout * ES) % 16 == 0, [&](int p) -> unsigned char* {
    const int gy = at.y0 + row0 + (p / kTile) * 4, gx = at.x0 + p % kTile;
    if (gy >= H || gx >= W) return nullptr;
    return static_cast<unsigned char*>(y) +
           ((((long long)at.n * H + gy) * W + gx) * Cout + n0) * ES;
  });
  mma::warp_sync();  // the buffer is free again
}

// Block b computes output channels [64 * (b % npass), +64) of tiles
// b / npass, + gridDim.x / npass, ...; S window stages.
template <int S>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_s8_wgmma_kernel(s8::Input in, const int8_t* __restrict__ w,
                        const float* __restrict__ wscale,
                        const conv::bf16* __restrict__ bias,
                        const float* __restrict__ snext, void* __restrict__ y,
                        int H, int W, int Cout, int relu, int mode,
                        int tiles_h, int tiles_w, int total_tiles, int npass) {
  extern __shared__ __align__(1024) unsigned char smem_s8[];
  const int Cin = in.a.C + in.b.C;
  const int tid = threadIdx.x;
  const int nchunks = Cin / s8::kKC;
  const int nsteps = (nchunks + kSub - 1) / kSub;  // items per tile
  const int n0 = ((int)blockIdx.x % npass) * kNB;
  const int tile0 = (int)blockIdx.x / npass, tstep = (int)gridDim.x / npass;
  const int my_tiles =
      tile0 < total_tiles ? (total_tiles - tile0 + tstep - 1) / tstep : 0;
  const int nitems = my_tiles * nsteps;
  unsigned char* wres = smem_s8;  // [nchunks][9 taps][64 rows][32 bytes]
  unsigned char* xst = wres + nchunks * kChunkWBytes;  // [S][kSub windows]
  unsigned char* outs = xst + S * kStageBytes;  // [consumer warps][staging]
  const s8::Consts k = s8::consts_at(outs + out_bytes(mode), kNB);
  s8::load_consts(k, wscale + n0, bias ? bias + n0 : nullptr,
                  snext ? snext + n0 : nullptr, Cout - n0, kNB, tid,
                  kThreads);

  if (tid >= kConsumers) {
    mma::setmaxnreg_dec<kProducerRegs>();
    const int ptid = tid - kConsumers;
    Cursor ahead;
    ahead.start(tile0, tiles_h, tiles_w);
    conv::produce<S>(nitems, [&](int item, int stage) {
      for (int s = 0; s < kSub; ++s) {
        const int chunk = ahead.chunk * kSub + s;
        if (chunk >= nchunks) break;
        const int c0 = chunk * s8::kKC;
        const uint32_t st =
            mma::smem_u32(xst + stage * kStageBytes + s * kWinBytes);
        const s8::Image im = in.of(c0, ahead.at.n);
        const int cl = in.local(c0);
        for (int i = ptid; i < kWin * kWin * 2; i += kProducers) {
          const int p = i / 2, j = i % 2;
          const int gy = ahead.at.y0 - 1 + p / kWin;
          const int gx = ahead.at.x0 - 1 + p % kWin;
          const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const int8_t* src =
              ok ? im.p + ((long long)gy * im.sh + (long long)gx * im.sw +
                           cl + 16 * j)
                 : im.p;
          mma::cp_async16(s8::row_addr(st, p, j), src, ok);
        }
        // the first tile brings each chunk's weights, which stay: rows
        // (tap, n) of 32 input channels, the K-major B tile of each tap
        if (item < nsteps) {
          const uint32_t wst = mma::smem_u32(wres + chunk * kChunkWBytes);
          for (int i = ptid; i < 9 * kNB * 2; i += kProducers) {
            const int r = i / 2, j = i % 2;
            const int tap = r / kNB, co = n0 + r % kNB;
            const bool ok = co < Cout;
            const int8_t* src =
                ok ? w + ((long long)co * 9 + tap) * Cin + c0 + 16 * j : w;
            mma::cp_async16(s8::row_addr(wst, r, j), src, ok);
          }
        }
      }
      ahead.advance(nsteps, tstep, tiles_h, tiles_w);
    });
    return;
  }
  mma::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128, warp = (tid / 32) % 4;
  int pbase[kMT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
    pbase[mt] = ((wg * kMT + mt) * 4 + warp) * kWin + conv::ldm_row();
  const int khalf = conv::ldm_khalf();
  const int row0 = wg * kMT * 4 + warp;  // this warp's first tile row
  unsigned char* buf =
      outs + (tid / 32) * (mode == s8::kOutS8 ? WarpStaging<1>::kBytes
                                              : WarpStaging<2>::kBytes);

  Cursor cur;
  cur.start(tile0, tiles_h, tiles_w);
  int acc[kMT][32];
  uint32_t afrag[2][kBatch][kMT][4];
  conv::consume<S>(nitems, [&](int, int stage) {
    const int c = cur.chunk * kSub;  // the item's first chunk
    const int nsub = nchunks - c < kSub ? nchunks - c : kSub;
    mma_item(acc, afrag, mma::smem_u32(xst + stage * kStageBytes),
             mma::smem_u32(wres + c * kChunkWBytes), nsub, pbase, khalf,
             c > 0, cur.chunk == nsteps - 1 || (9 * nsub / kBatch) % 2 != 0);
    if (cur.chunk == nsteps - 1) {
      const TileAt at = cur.at;
      if (mode == s8::kOutS8) {
        epilogue_staged<1>(acc, k, buf, relu != 0, row0, at, y, H, W, Cout,
                           n0);
      } else if (mode == s8::kOutBF16) {
        epilogue_staged<2>(acc, k, buf, relu != 0, row0, at, y, H, W, Cout,
                           n0);
      } else {
        const int lane = tid % 32, g = lane / 4, q = lane % 4;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int gy = at.y0 + row0 + 4 * mt, gx = at.x0 + g + 8 * hf;
            if (gy >= H || gx >= W) continue;
            const long long off =
                (((long long)at.n * H + gy) * W + gx) * Cout + n0;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              s8::store_pair(y, off, 8 * i + 2 * q, Cout - n0,
                             acc[mt][4 * i + 2 * hf],
                             acc[mt][4 * i + 2 * hf + 1], k, mode, false,
                             Cout % 2 == 0);
          }
      }
    }
    cur.advance(nsteps, tstep, tiles_h, tiles_w);
  });
}

cudaError_t launch_wide(const s8::Input& in, const int8_t* w, const float* ws,
                        const conv::bf16* b, const float* sn, void* y, int n,
                        int h, int wd, int cout, int relu, int mode,
                        cudaStream_t stream) {
  // as many window stages (up to four) as fit beside the weights
  const int nchunks = (in.a.C + in.b.C) / s8::kKC;
  int stages = 4;
  while (stages > 2 && wide_smem(nchunks, mode, stages) > conv::kMaxSmem)
    --stages;
  const int smem = wide_smem(nchunks, mode, stages);
  if (smem > conv::kMaxSmem) return cudaErrorInvalidValue;
  auto* kernel = stages == 4   ? conv3x3_s8_wgmma_kernel<4>
                 : stages == 3 ? conv3x3_s8_wgmma_kernel<3>
                               : conv3x3_s8_wgmma_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
#ifndef CID_EMULATE_MMA
  // the register split assumes the compiler gave every thread kLaunchRegs:
  // with fewer, setmaxnreg.inc would hang the kernel, so refuse instead
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != kLaunchRegs) return cudaErrorInvalidConfiguration;
#endif
  const int tiles_h = (h + kTile - 1) / kTile, tiles_w = (wd + kTile - 1) / kTile;
  const long long tiles = (long long)n * tiles_h * tiles_w;
  const int sms = conv::sm_count();
  const int npass = (cout + kNB - 1) / kNB;
  if (!cid::grid_fits(tiles * npass) || sms <= 0)
    return cudaErrorInvalidConfiguration;
  // one block per SM, as many for each output block
  long long per_pass = sms / npass > 1 ? sms / npass : 1;
  if (per_pass > tiles) per_pass = tiles;
  kernel<<<(unsigned)(per_pass * npass), kThreads, smem, stream>>>(
      in, w, ws, b, sn, y, h, wd, cout, relu, mode, tiles_h, tiles_w,
      (int)tiles, npass);
  return cudaGetLastError();
}

// ---- Cout <= 8: mma.sync, one n8 block ------------------------------------
constexpr int kNarrowThreads = 256;  // eight warps, two tile rows each
constexpr int kNarrowStage = kWinBytes + 9 * 8 * s8::kRowBytes;

__global__ void __launch_bounds__(kNarrowThreads, 2)
conv3x3_s8_narrow_kernel(s8::Input in, const int8_t* __restrict__ w,
                         const float* __restrict__ wscale,
                         const conv::bf16* __restrict__ bias,
                         const float* __restrict__ snext,
                         void* __restrict__ y, int H, int W, int Cout,
                         int relu, int mode, int tiles_h, int tiles_w,
                         int total_tiles) {
  extern __shared__ __align__(1024) unsigned char smem_s8[];
  const int Cin = in.a.C + in.b.C;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int nchunks = Cin / s8::kKC;
  const int my_tiles =
      (total_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nitems = my_tiles * nchunks;

  const s8::Consts k = s8::consts_at(smem_s8 + 2 * kNarrowStage, 8);
  s8::load_consts(k, wscale, bias, snext, Cout, 8, tid, kNarrowThreads);

  auto fill = [&](int item, int stage) {
    const int t = (int)blockIdx.x + (item / nchunks) * (int)gridDim.x;
    const int c0 = (item % nchunks) * s8::kKC;
    const TileAt at = tile_at(t, tiles_h, tiles_w);
    const uint32_t st = mma::smem_u32(smem_s8 + stage * kNarrowStage);
    const s8::Image im = in.of(c0, at.n);
    const int cl = in.local(c0);
    for (int i = tid; i < kWin * kWin * 2; i += kNarrowThreads) {
      const int p = i / 2, j = i % 2;
      const int gy = at.y0 - 1 + p / kWin, gx = at.x0 - 1 + p % kWin;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int8_t* src =
          ok ? im.p + ((long long)gy * im.sh + (long long)gx * im.sw + cl +
                       16 * j)
             : im.p;
      mma::cp_async16(s8::row_addr(st, p, j), src, ok);
    }
    const uint32_t wst = st + kWinBytes;  // rows (tap, n): [9][8][32]
    for (int i = tid; i < 9 * 8 * 2; i += kNarrowThreads) {
      const int r = i / 2, j = i % 2;
      const int tap = r / 8, co = r % 8;
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

  int acc[2][4];
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
        for (int e = 0; e < 4; ++e) acc[mt][e] = 0;
    }
    const uint32_t st = mma::smem_u32(smem_s8 + stage * kNarrowStage);
    const uint32_t wst = st + kWinBytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * kWin + tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma::ldmatrix_x4(a[mt], s8::row_addr(st, pbase[mt] + shift, khalf));
      uint32_t b[2];
      mma::ldmatrix_x2(b, s8::row_addr(wst, tap * 8 + lane % 8,
                                       s8::b_piece()));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma::mma_m16n8k32_s8(acc[mt], a[mt], b);
    }
    if (item % nchunks == nchunks - 1) {
      const int t = (int)blockIdx.x + (item / nchunks) * (int)gridDim.x;
      const TileAt at = tile_at(t, tiles_h, tiles_w);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int gy = at.y0 + warp * 2 + mt;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int gx = at.x0 + g + 8 * hf;
          if (gy >= H || gx >= W) continue;
          const long long off =
              (((long long)at.n * H + gy) * W + gx) * (long long)Cout;
          s8::store_pair(y, off, 2 * q, Cout, acc[mt][2 * hf],
                         acc[mt][2 * hf + 1], k, mode, relu != 0,
                         Cout % 2 == 0);
        }
      }
    }
    __syncthreads();
  }
}

cudaError_t launch_narrow(const s8::Input& in, const int8_t* w,
                          const float* ws, const conv::bf16* b,
                          const float* sn, void* y, int n, int h, int wd,
                          int cout, int relu, int mode, cudaStream_t stream) {
  const int smem = 2 * kNarrowStage + s8::consts_bytes(8);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_s8_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + kTile - 1) / kTile, tiles_w = (wd + kTile - 1) / kTile;
  const long long tiles = (long long)n * tiles_h * tiles_w;
  const int sms = conv::sm_count();
  if (!cid::grid_fits(tiles) || sms <= 0) return cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(tiles < 2 * sms ? tiles : 2 * sms);
  conv3x3_s8_narrow_kernel<<<grid, kNarrowThreads, smem, stream>>>(
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
  if (n < 1 || h < 1 || wd < 1 || cout < 1 || ca < 1 || ca + cb > kMaxCin ||
      !conv::aligned16(y) ||
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
    return (int)launch_narrow(in, wq, ws, b, sn8, y, n, h, wd, cout, relu,
                              mode, s);
  return (int)launch_wide(in, wq, ws, b, sn8, y, n, h, wd, cout, relu, mode,
                          s);
}
