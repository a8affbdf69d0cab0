// 3x3 'same' convolution, stride 1, with fused bias and optional ReLU.
//
// Replaces (one source, two Python entry points in ops/cuda/conv3x3.py):
//   celebrity_image_denoiser_tpu/ops/pallas/conv_fused.py::conv3x3_bias_relu    (:143, halo DMA)
//   celebrity_image_denoiser_tpu/ops/pallas/conv_fused.py::conv3x3_bias_relu_v2 (:85, shifted inputs)
// Both compute y = maybe_relu(conv3x3_same(x, W) + b) with f32 accumulation
// and store y in x's dtype; they differ only in how the TPU moves data, so
// on Hopper they are one function.
//
// Layout: x (N,H,W,Cin) NHWC, W (3,3,Cin,Cout) HWIO in x's dtype, b (Cout,)
// float32, y (N,H,W,Cout) NHWC.  Any H, W, Cin, Cout; ragged edges are
// masked, and channels >= Cout are never stored.  On the tensor-core paths
// the input may come as two tensors, x (ca channels) and x2 (cb channels, a
// strided NHWC view with contiguous channels), standing for their
// concatenation: the U-Net's skip concat before upconv1.0 is then never
// written to device memory, in bf16 or f32.
//
// What bounds it on an H100: upconv1.0 (Cin 128 -> Cout 64) and the
// families' 64 -> 64 and 64 -> 256 convs are above the card's ridge point
// in bf16 and in f32, so bound by operations, and only the tensor cores
// come near that bound; upconv1.2 (64 -> 3) is below it, bound by reading
// its input once.
//
// bfloat16 runs on the tensor cores (blocks from conv_mma.cuh):
//   * Cout > 8: an implicit GEMM per 16x16-pixel tile on wgmma m64n64k16.
//     A block is four warpgroups.  Two consume: each owns two 64-pixel
//     position tiles (four tile rows each, one warp per tile row) and
//     accumulates 64 output channels in registers; A comes from the 18x18
//     halo window by ldmatrix (a tap is a shift of the row addresses), B is
//     the tap's [ci][co] weight slice read by wgmma through its descriptor.
//     The other two produce: they only start the 16-byte cp.async copies, S
//     - 1 work items ahead, with most of their registers handed to the
//     consumers (setmaxnreg); eight producer warps, because a warp keeps only
//     so many copies in flight and four moved a third fewer bytes a clock.
//     Blocks are persistent (one per SM) and the ring runs
//     across tile boundaries, so a tile's epilogue overlaps the next tile's
//     copies.
//     Where one output pass covers Cout and all the weights fit beside the
//     window stages (upconv1.0: 9 x 128 x 64 weights = 147,456 bytes beside
//     four 32-channel window stages of 20,736) the weights are loaded once
//     per block and stay resident: streamed with every window they were 2.4
//     of the 3.8 GB a bench step pulled through L2, and the copies, not the
//     tensor cores, set the kernel's pace.  Otherwise weights and windows
//     are streamed together, 32 channels at a time through three stages, or
//     16 through four where Cin is not a multiple of 32.
//   * Cout <= 8 (upconv1.2): bound by bytes, so N is padded to 8 in
//     registers only: mma.sync m16n8k16, eight warps of two tile rows each,
//     the B fragments read from a small [tap][8][KC] weight tile.  A
//     persistent two-stage ring (every thread starts copies; at most two
//     blocks per SM) brings the windows; results are staged in shared memory
//     and written as contiguous runs (a tile row of 16 pixels x Cout
//     channels).
//   * s8 out (cid_conv3x3_bias_relu_q8, the first conv of the int8 U-Net,
//     ops/quant_unet.py:73,182-183): the same wgmma path with another
//     epilogue, in the JAX program's order: the conv rounded to bf16, the
//     bias added in bf16, ReLU, then s8 = clamp(rint(h / s[c]), -127, 127).
//     The 64-channel bf16 activation is never written to device memory.
//     Bound by its bytes (reading 3 bf16 channels, writing 64 s8 ones), it
//     lost most of its time to a scalar epilogue: per value two bf16
//     roundings and one byte store covering a sixteenth of its sector.  The
//     epilogue works on channel pairs as K5's does (conv_s8.cuh): one packed
//     rounding, one packed bf16x2 bias add, the division-free quantize, each
//     pair's constants read once into registers; the bytes are staged per
//     warp (2 tile rows x 16 pixels x 64 channels) and leave as 16-byte
//     stores of each pixel's contiguous channel run.
// float32 also runs on the tensor cores, at f32's tolerance, where Cout > 4
// (cid_conv3x3_bias_relu_tf32): every multiply is three TF32 products
// (conv_mma.cuh's last section).  One TF32 product keeps 11 bits of each
// operand and misses the f32 check by 10-18x; with v = hi + lo (hi =
// tf32(v), lo = tf32(v - hi)) the sum a_lo b_hi + a_hi b_lo + a_hi b_hi
// drops only a_lo b_lo, ~2^-22 of the product.  Bound: operations at 495 /
// 3 TFLOP/s (the TF32 rate over three).
//   * the bf16 body's block, 16x16 tile, producer warps and persistent ring,
//     on wgmma m64n64k8 tf32 with A from registers: the activations are
//     split as ldmatrix delivers them, the weights come split and K-major
//     (the only B layout wgmma takes for 32-bit types) from the wrapper,
//     made once per loaded weights;
//   * a work item is one 8-channel chunk (one k8 step): its 18x18 window
//     (10,368 bytes) and its 9 taps' hi and lo B tiles (36,864), four
//     stages (188,928 bytes) -- f32 doubles the window's bytes and the
//     split doubles the weights', so the bf16 body's 32-channel chunks and
//     resident weights do not fit;
//   * each chunk's 72 products go into a fresh wgmma accumulator, added to
//     the running total rounded to nearest: the tensor cores' own
//     accumulation truncates, and one accumulator over all of K erred by
//     1.04e-5 of max|ref| at upconv1.0 (K = 1152) against 1.76e-6 so
//     (ops/cuda/ablation.py --only f32, H100);
//   * each output's summation order is fixed (no split-K, no atomics), so
//     two runs are bit-equal.
// Cout <= 4 (upconv1.2, dncnn's last conv, the cGAN's tail) runs f32 FMA
// on the CUDA cores (cid_conv3x3_bias_relu).  It is bound by reading its
// input once: at 512^2, 64 -> 3 that is 67.1 MB in and 3.1 MB out, 0.021 ms
// at 3.35 TB/s, while its 453 M FMAs take 0.0135 ms at 67 TFLOP/s -- so the
// FMAs hide under the copies only if no output channel is padded and the
// shared-memory reads stay few per FMA.  Hence:
//   * persistent blocks (one per SM) walk (tile, 64-channel chunk) items of
//     8 x 32-pixel tiles through a ring of two stages of 16-byte cp.async
//     copies (4-byte ones where Cin % 4 != 0 or x is unaligned), which runs
//     across tile boundaries; at Cin = 64 a chunk is a pixel's whole
//     256-byte channel run, read in whole lines;
//   * Cout is a template parameter (1-4): no FMA on a padded channel;
//   * 16 lanes share a run of 16 pixels, one group of 4 channels each: a
//     lane keeps its group's 9 x 4 x Cout weights in registers (loaded once
//     per block where Cin <= 64) and, per window row, reads each of its 18
//     pixels' float4 once for the three taps that use it (192 x Cout FMAs
//     a row for 18 shared-memory reads, none of them weights); the run's
//     lanes read one pixel's contiguous channels, so no bank conflict;
//   * a tile's partial sums are summed over the run's 16 lanes by shuffles
//     in a fixed tree, no split, no atomics: two runs are bit-equal.
// ops/cuda/ablation.py --only narrow times the alternatives (on an H100):
// runs of 8 pixels with four stages and chunks of 32 or 16 channels were
// slower, as was the same ring on mma.sync TF32 (three products a multiply).
// The TPU artifacts of the Pallas version (channel padding to 128 lanes,
// H % tile_h == 0) are not carried over.

#include <cstdint>

#include "common.cuh"
#include "conv_mma.cuh"
#include "conv_s8.cuh"

namespace {

// ---- float32, Cout <= 4: CUDA cores ---------------------------------------
// A persistent block walks work items (tile, chunk of KC channels) through a
// ring of S stages of 16-byte copies.  A stage holds the chunk's halo window,
// pixel-major as the copies land it (each pixel's KC channels contiguous, its
// 16-byte pieces swizzled by the pixel: group j at piece j ^ (p & 7)), and
// the chunk's weights as [group][tap][c][co].  The KC / 4 lanes of a run
// each own a group of 4 channels and one run of P pixels of a tile row: a
// lane holds its group's 9 x 4 x Cout weights in registers (loaded once per
// block where Cin <= KC) and its P x Cout partial sums; per window row it
// reads the P + 2 pixels' float4 of its group once and applies all three
// taps to them.  The run's lanes read one pixel's contiguous channels: no
// bank conflict.  After a tile's last chunk the partial sums are summed over
// the run's lanes by shuffles in a fixed tree (halving: each lane keeps half
// of what it holds), so that each lane ends with one pixel's Cout outputs.
// Each output's sum has one order: no split, no atomics.
constexpr int kN32KC = 64;      // channels a chunk: a pixel's 256-byte run
constexpr int kN32P = 16;       // pixels of a run
constexpr int kN32Stages = 2;   // the ring
constexpr int kN32Threads = 256;
constexpr int kN32GL = kN32KC / 4;                // lanes of a run
constexpr int kN32Runs = kN32Threads / kN32GL;    // runs of a tile
constexpr int kN32Cols = 2 * kN32P;               // tile columns
constexpr int kN32Rows = kN32Runs * kN32P / kN32Cols;  // tile rows
constexpr int kN32WinCols = kN32Cols + 2, kN32WinRows = kN32Rows + 2;
constexpr int kN32Pitch = kN32KC * 4;  // bytes a window pixel
constexpr int kN32WinBytes = kN32WinRows * kN32WinCols * kN32Pitch;
constexpr int kN32Swz = (kN32GL < 8 ? kN32GL : 8) - 1;  // the piece swizzle
static_assert(kN32GL >= 2 && 32 % kN32GL == 0, "a run's lanes in one warp");
static_assert((kN32P & (kN32P - 1)) == 0, "the shuffle tree halves runs");
template <int COUT>
__host__ __device__ constexpr int n32_stage_bytes() {
  return kN32WinBytes + 9 * kN32KC * COUT * 4;
}
// the address of channel group j of window pixel p in a stage
__device__ __forceinline__ int n32_at(int p, int j) {
  return p * kN32Pitch + ((j ^ (p & kN32Swz)) << 4);
}

__device__ __forceinline__ float f4at(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

struct Tile32 { int n, y0, x0; };

// What a narrow block walks: its items, (tile, chunk) of tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...
struct Narrow32 {
  const float* x;
  const float* w;
  int H, W, Cin, nchunks, tiles_h, tiles_w, nitems;
  bool vec_x;  // Cin % 4 == 0 and x 16-byte aligned
  __device__ Narrow32(const float* x_, const float* w_, int H_, int W_,
                      int Cin_, int tiles_h_, int tiles_w_, int total_tiles,
                      int vec_x_)
      : x(x_), w(w_), H(H_), W(W_), Cin(Cin_),
        nchunks((Cin_ + kN32KC - 1) / kN32KC), tiles_h(tiles_h_),
        tiles_w(tiles_w_), vec_x(vec_x_ != 0) {
    const int my_tiles =
        (total_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    nitems = my_tiles * nchunks;
  }
  __device__ __forceinline__ Tile32 tile(int k) const {
    int t = (int)blockIdx.x + k * (int)gridDim.x;
    Tile32 r;
    r.x0 = (t % tiles_w) * kN32Cols;
    t /= tiles_w;
    r.y0 = (t % tiles_h) * kN32Rows;
    r.n = t / tiles_h;
    return r;
  }

  // Start the copies of item `item` into the stage at `st` (NT threads):
  // the window, 16 bytes (vec_x) or 4 bytes a copy, zeros outside the image
  // and beyond Cin; and, unless every stage already holds them (one chunk
  // per tile), the chunk's weights, 4 bytes a copy.
  template <int COUT, int NT, int S>
  __device__ __forceinline__ void fill(unsigned char* st, int item,
                                       int tid) const {
    namespace mma = cid::mma;
    constexpr int WIN = kN32WinRows * kN32WinCols;
    const int ci0 = (item % nchunks) * kN32KC;
    const Tile32 at = tile(item / nchunks);
    const float* img = x + (size_t)at.n * H * W * Cin;
    const uint32_t d0 = mma::smem_u32(st);
    if (vec_x) {
      // a thread keeps its 16-byte piece and steps through the pixels
      static_assert(NT % kN32GL == 0, "a thread keeps its piece");
      constexpr int STEP = NT / kN32GL;
      const int j = tid % kN32GL, c = ci0 + 4 * j;
      int p = tid / kN32GL, py = p / kN32WinCols, px = p % kN32WinCols;
      for (; p < WIN; p += STEP) {
        const int gy = at.y0 - 1 + py, gx = at.x0 - 1 + px;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
        mma::cp_async16(d0 + n32_at(p, j),
                        ok ? img + ((size_t)gy * W + gx) * Cin + c : x, ok);
        py += STEP / kN32WinCols;
        px += STEP % kN32WinCols;
        if (px >= kN32WinCols) {
          px -= kN32WinCols;
          ++py;
        }
      }
    } else {
      for (int u = tid; u < WIN * kN32KC; u += NT) {
        const int p = u / kN32KC, e = u % kN32KC;
        const int gy = at.y0 - 1 + p / kN32WinCols;
        const int gx = at.x0 - 1 + p % kN32WinCols, c = ci0 + e;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
        mma::cp_async4(d0 + n32_at(p, e / 4) + (e % 4) * 4,
                       ok ? img + ((size_t)gy * W + gx) * Cin + c : x, ok);
      }
    }
    if (nchunks > 1 || item < S) {
      for (int e = tid; e < 9 * kN32KC * COUT; e += NT) {
        const int co = e % COUT, r = e / COUT;  // (j * 9 + tap) * 4 + c
        const int tap = (r / 4) % 9, ci = ci0 + 4 * (r / 36) + r % 4;
        const bool ok = ci < Cin;
        mma::cp_async4(d0 + kN32WinBytes + e * 4,
                       ok ? w + ((size_t)tap * Cin + ci) * COUT + co : w, ok);
      }
    }
  }
};

// The V values each of a run's GL lanes holds, summed over those lanes in a
// fixed tree: H halving steps (lane bit M set: keep the upper half of what
// it holds, send the lower), then whole steps.  Each lane ends with the
// block of V >> H values whose index is its halving bits, summed.
template <int N, int M, int H>
__device__ __forceinline__ void n32_reduce(float* v, int lane) {
  if constexpr (M >= 1) {
    if constexpr (H > 0) {
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const float keep = up ? v[k + N / 2] : v[k];
        v[k] = keep + cid::mma::shfl_xor(up ? v[k] : v[k + N / 2], M);
      }
      n32_reduce<N / 2, M / 2, H - 1>(v, lane);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] += cid::mma::shfl_xor(v[k], M);
      n32_reduce<N, M / 2, 0>(v, lane);
    }
  }
}

__host__ __device__ constexpr int n32_log2(int v) {
  return v <= 1 ? 0 : 1 + n32_log2(v / 2);
}

template <int COUT, int S>
__global__ void __launch_bounds__(kN32Threads, 1)
conv3x3_f32_narrow_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          float* __restrict__ y, int H, int W, int Cin,
                          int relu, int tiles_h, int tiles_w, int total_tiles,
                          int vec_x) {
  constexpr int NT = kN32Threads, P = kN32P, GL = kN32GL;
  constexpr int SB = n32_stage_bytes<COUT>();
  // the shuffle tree: halving steps, and pixels a lane ends with
  constexpr int HALVE = n32_log2(GL < P ? GL : P), PX = P >> HALVE;
  constexpr int WHOLE = n32_log2(GL) - HALVE;
  static_assert(SB % 16 == 0, "stages on 16-byte boundaries");
  namespace mma = cid::mma;
  extern __shared__ __align__(1024) unsigned char smem_mma[];

  const int tid = threadIdx.x, lane = tid % 32, g = lane % GL;
  const int run = tid / GL, row = run / (kN32Cols / P);
  const int c0 = (run % (kN32Cols / P)) * P;
  const Narrow32 nw(x, w, H, W, Cin, tiles_h, tiles_w, total_tiles, vec_x);
  const int nchunks = nw.nchunks, nitems = nw.nitems;

  // start the copies of work item `item` into stage `stage`
  auto fill32 = [&](int item, int stage) {
    nw.fill<COUT, NT, S>(smem_mma + stage * SB, item, tid);
  };

  // this lane's group of 4 channels of its run, the window rows in turn:
  // each pixel's float4 read once and given to the taps that use it
  auto compute32 = [&](int stage, const float (&wr)[9][4][COUT],
                       float (&acc)[P][COUT]) {
    const unsigned char* st = smem_mma + stage * SB;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int p0 = (row + dy) * kN32WinCols + c0;
#pragma unroll
      for (int jc = 0; jc < P + 2; ++jc) {
        const float4 v =
            *reinterpret_cast<const float4*>(st + n32_at(p0 + jc, g));
#pragma unroll
        for (int dx = 2; dx >= 0; --dx) {
          const int j = jc - dx;
          if (j < 0 || j >= P) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int co = 0; co < COUT; ++co)
              acc[j][co] = fmaf(f4at(v, c), wr[dy * 3 + dx][c][co],
                                acc[j][co]);
        }
      }
    }
  };

  // the run's sums over its lanes, bias, ReLU and stores: each lane that
  // ends with a block stores its PX pixels
  auto store32 = [&](int tile_k, float (&acc)[P][COUT]) {
    float* v = &acc[0][0];
    n32_reduce<P * COUT, GL / 2, HALVE>(v, lane);
    if ((g & ((1 << WHOLE) - 1)) != 0) return;
    const Tile32 at = nw.tile(tile_k);
    const int gy = at.y0 + row, j0 = (g >> WHOLE) * PX;
    if (gy >= H) return;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int gx = at.x0 + c0 + j0 + j;
      if (gx >= W) continue;
      float* out = y + (((size_t)at.n * H + gy) * W + gx) * COUT;
#pragma unroll
      for (int co = 0; co < COUT; ++co) {
        const float s = v[j * COUT + co] + bias[co];
        out[co] = relu ? cid::relu_f32(s) : s;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nitems) fill32(s, s);
    mma::cp_async_commit();
  }
  float wr[9][4][COUT];  // this lane's group's weights: [tap][c][co]
  float acc[P][COUT];
  for (int item = 0; item < nitems; ++item) {
    mma::cp_async_wait<S - 2>();  // this item's copies (this thread's)
    __syncthreads();              // everyone's; and item - 1's reads done
    if (item + S - 1 < nitems) fill32(item + S - 1, (item + S - 1) % S);
    mma::cp_async_commit();
    const int chunk = item % nchunks;
    if (nchunks > 1 || item == 0) {
      const float4* ws = reinterpret_cast<const float4*>(
          smem_mma + (item % S) * SB + kN32WinBytes) + g * 9 * COUT;
#pragma unroll
      for (int k = 0; k < 9 * COUT; ++k) {
        const float4 t = ws[k];
        const float e[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int f = 4 * k + i;  // (tap * 4 + c) * COUT + co
          wr[f / (4 * COUT)][(f / COUT) % 4][f % COUT] = e[i];
        }
      }
    }
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int co = 0; co < COUT; ++co) acc[j][co] = 0.f;
    }
#ifdef CID_NARROW_DROP_LAST_CHUNK  // the CPU tests' control build only
    if (chunk != nchunks - 1)
#endif
    compute32(item % S, wr, acc);
    if (chunk == nchunks - 1) store32(item / nchunks, acc);
  }
}

template <int COUT>
cudaError_t launch_f32_narrow_t(const float* x, const float* w, const float* b,
                                float* y, int n, int h, int wd, int cin,
                                int relu, cudaStream_t stream) {
  constexpr int S = kN32Stages;
  constexpr int smem = S * n32_stage_bytes<COUT>();
  const auto kernel = conv3x3_f32_narrow_kernel<COUT, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + kN32Rows - 1) / kN32Rows;
  const int tiles_w = (wd + kN32Cols - 1) / kN32Cols;
  const long long tiles = (long long)n * tiles_h * tiles_w;
  const int sms = cid::conv::sm_count();
  if (!cid::grid_fits(tiles) || sms <= 0 || cin < 1)
    return cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, kN32Threads, smem, stream>>>(
      x, w, b, y, h, wd, cin, relu, tiles_h, tiles_w, (int)tiles,
      cin % 4 == 0 && cid::conv::aligned16(x));
  return cudaGetLastError();
}

// Cout <= 4 (upconv1.2, dncnn body.47, the cGAN's tail: Cout = 3): bound by
// bytes; wider outputs take the TF32 body (dispatch_tf32).
cudaError_t launch_f32_narrow(const void* xv, const void* wv, const void* bv,
                              void* yv, int n, int h, int wd, int cin,
                              int cout, int relu, cudaStream_t stream) {
  const float* x = static_cast<const float*>(xv);
  const float* w = static_cast<const float*>(wv);
  const float* b = static_cast<const float*>(bv);
  float* y = static_cast<float*>(yv);
  switch (cout) {
    case 1:
      return launch_f32_narrow_t<1>(x, w, b, y, n, h, wd, cin, relu, stream);
    case 2:
      return launch_f32_narrow_t<2>(x, w, b, y, n, h, wd, cin, relu, stream);
    case 3:
      return launch_f32_narrow_t<3>(x, w, b, y, n, h, wd, cin, relu, stream);
    case 4:
      return launch_f32_narrow_t<4>(x, w, b, y, n, h, wd, cin, relu, stream);
  }
  return cudaErrorInvalidValue;
}

// ---- bfloat16: tensor cores -------------------------------------------------
using cid::conv::bf16;
namespace conv = cid::conv;
namespace mma = cid::mma;

constexpr int kTile = 16;        // output tile, pixels a side
constexpr int kWin = kTile + 2;  // its halo window

struct TileAt { int n, y0, x0; };
__device__ __forceinline__ TileAt tile_at(int t, int tiles_h, int tiles_w) {
  TileAt r;
  r.x0 = (t % tiles_w) * kTile;
  t /= tiles_w;
  r.y0 = (t % tiles_h) * kTile;
  r.n = t / tiles_h;
  return r;
}

// Where a block's walk over its work items stands.  Producer and consumers
// each carry their own along, so that no item costs a division.
struct Cursor {
  int chunk, pass, tile;
  TileAt at;
  __device__ __forceinline__ void start(int tiles_h, int tiles_w) {
    chunk = pass = 0;
    tile = blockIdx.x;
    at = tile_at(tile, tiles_h, tiles_w);
  }
  __device__ __forceinline__ void advance(int nchunks, int npass, int tiles_h,
                                          int tiles_w) {
    if (++chunk < nchunks) return;
    chunk = 0;
    if (++pass < npass) return;
    pass = 0;
    tile += gridDim.x;
    at = tile_at(tile, tiles_h, tiles_w);
  }
};

// The s8 program's first conv (quant_unet.py::_conv_f, then _q) for the
// channel pair c, c + 1 of one pixel: the f32 sums rounded to bf16, the
// bias pair (bf16) added in bf16, ReLU, then quantized at the pair's
// scales; the two s8 values as two bytes, c in the low one.  The JAX
// program adds in f32 and rounds the sum to bf16; one packed bf16x2 add
// rounds the exact sum once, which is the same value (a sum of two bf16
// values rounded to f32, 24 bits, and then to bf16, 8 bits, is rounded
// as if once: 24 >= 2 * 8 + 2).
__device__ __forceinline__ uint32_t q8_pair(float acc0, float acc1,
                                            const cid::s8::Pair& k,
                                            bool relu) {
  namespace s8 = cid::s8;
  const uint32_t u = s8::add_bf16x2(s8::pack_bf16x2(acc0, acc1), k.bias2);
  float h0 = s8::bf16_lo(u), h1 = s8::bf16_hi(u);
  if (relu) {
    h0 = cid::relu_f32(h0);
    h1 = cid::relu_f32(h1);
  }
  return s8::quantize2(h0, h1, k);
}

// s8 out: a consumer warp's MT tile rows of 16 pixels x 64 channels,
// staged, then written as 16-byte chunks of each pixel's channel run
constexpr int kQ8WarpPix = 2 * kTile;
using Q8Staging = cid::s8::Staging<1, kQ8WarpPix>;
constexpr int kQ8StageBytes = conv::kConsumers / 32 * Q8Staging::kBytes;

// The s8 epilogue of a consumer warp: rows row0 + 4 * mt of the tile, the
// pass's 64 channels from n0.  Channel pair by channel pair, so that one
// pair's constants (bias pair, two scales) sit in registers beside the
// accumulators; the staged bytes go out as 16-byte stores (vec: Cout a
// multiple of 16 and y 16-byte aligned, so every pixel's run is aligned).
template <int MT>
__device__ __forceinline__ void epilogue_q8(
    const float (&acc)[MT][32], const float* bs, const cid::s8::QScale* qs,
    unsigned char* buf, bool relu, int row0, const TileAt& at, int8_t* yq,
    int H, int W, int Cout, int n0, bool vec) {
  static_assert(MT * kTile <= kQ8WarpPix,
                "a warp's MT tile rows overrun its Q8Staging");
  namespace s8 = cid::s8;
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const Q8Staging stg{buf};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * i + 2 * q;
    const s8::Pair k{0.f, 0.f, s8::pack_bf16x2(bs[n0 + c], bs[n0 + c + 1]),
                     qs[n0 + c], qs[n0 + c + 1]};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        stg.put(mt * kTile + g + 8 * hf, c,
                q8_pair(acc[mt][4 * i + 2 * hf], acc[mt][4 * i + 2 * hf + 1],
                        k, relu));
  }
  mma::warp_sync();
  const int valid = Cout - n0 < conv::kNB ? Cout - n0 : conv::kNB;
  stg.flush(valid, vec, [&](int p) -> unsigned char* {
    const int gy = at.y0 + row0 + (p / kTile) * 4, gx = at.x0 + p % kTile;
    if (gy >= H || gx >= W) return nullptr;
    return reinterpret_cast<unsigned char*>(
        yq + (((long long)at.n * H + gy) * W + gx) * Cout + n0);
  });
  mma::warp_sync();  // the buffer is free again
}

// Cout > 8.  One work item = (tile, 64-channel output pass, KC-channel chunk);
// a block walks the items of tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// resident: all the weights (one slot per chunk) are loaded with the first
// tile and stay; else they are streamed with the windows (S slots).  Q8:
// the s8-out mode (qscale, yq), compiled apart, so that the bf16 mode's
// code is the same as without it.
template <int KC, int S, bool Q8>
__global__ void __launch_bounds__(conv::kThreads, 1)
conv3x3_wgmma_kernel(conv::Input in, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ y,
                     int H, int W, int Cout, int relu, int tiles_h,
                     int tiles_w, int total_tiles, int vec_w, int pair_ok,
                     int resident, const float* __restrict__ qscale,
                     int8_t* __restrict__ yq, int q8_vec) {
  const int Cin = in.a.C + in.b.C;
  constexpr int WB = conv::weight_stage_bytes(KC);
  constexpr int XB = kWin * kWin * 2 * KC;
  constexpr int MT = 2;  // position tiles (4 tile rows each) per warpgroup
  extern __shared__ __align__(1024) unsigned char smem_mma[];

  const int tid = threadIdx.x;
  const int nchunks = (Cin + KC - 1) / KC;
  const int npass = (Cout + conv::kNB - 1) / conv::kNB;
  const int my_tiles =
      (total_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nitems = my_tiles * npass * nchunks;
  unsigned char* wst = smem_mma;  // [resident ? nchunks : S][WB]
  unsigned char* xst = smem_mma + (resident ? nchunks : S) * WB;  // [S][XB]
  float* bs = reinterpret_cast<float*>(xst + S * XB);  // [npass * 64]
  conv::load_bias(bs, bias, Cout, npass * conv::kNB, tid, conv::kThreads);
  // s8 out: the scales as s8::qscale_of gives them, [npass * 64] each
  cid::s8::QScale* qs =
      reinterpret_cast<cid::s8::QScale*>(bs + npass * conv::kNB);
  if (Q8)
    for (int i = tid; i < npass * conv::kNB; i += conv::kThreads)
      qs[i] = cid::s8::qscale_of(i < Cout ? qscale[i] : 1.f);
  // s8 out: the consumer warps' staging, [kConsumers / 32][Q8Staging]
  unsigned char* q8stage =
      reinterpret_cast<unsigned char*>(qs + npass * conv::kNB);

  if (tid >= conv::kConsumers) {
    mma::setmaxnreg_dec<conv::kProducerRegs>();
    const int ptid = tid - conv::kConsumers;
    Cursor ahead;
    ahead.start(tiles_h, tiles_w);
    conv::produce<S>(nitems, [&](int item, int stage) {
      const int c0 = ahead.chunk * KC;
      conv::load_window<KC, kWin, kWin, conv::kProducers>(
          xst + stage * XB, in.of(c0, ahead.at.n), H, W, in.local(c0),
          ahead.at.y0 - 1, ahead.at.x0 - 1, ptid);
      if (!resident || item < nchunks)
        conv::load_weights<KC, conv::kProducers>(
            wst + (resident ? ahead.chunk : stage) * WB, w, Cin, Cout, c0,
            ahead.pass * conv::kNB, vec_w, ptid);
      ahead.advance(nchunks, npass, tiles_h, tiles_w);
    });
    return;
  }
  mma::setmaxnreg_inc<conv::kConsumerRegs>();
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  int pbase[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    pbase[mt] = ((wg * MT + mt) * 4 + warp) * kWin + conv::ldm_row();

  Cursor cur;
  cur.start(tiles_h, tiles_w);
  float acc[MT][32];
  conv::consume<S>(nitems, [&](int, int stage) {
    if (cur.chunk == 0) conv::zero_acc(acc);
    conv::mma_chunk<KC, MT>(
        acc, conv::WindowAddr<KC>{mma::smem_u32(xst + stage * XB)}, pbase,
        kWin, mma::smem_u32(wst + (resident ? cur.chunk : stage) * WB));
    if (Q8 && cur.chunk == nchunks - 1) {
      epilogue_q8<MT>(acc, bs, qs, q8stage + (tid / 32) * Q8Staging::kBytes,
                      relu, (wg * MT) * 4 + warp, cur.at, yq, H, W, Cout,
                      cur.pass * conv::kNB, q8_vec);
    } else if (cur.chunk == nchunks - 1) {
      const int n0 = cur.pass * conv::kNB;
      const TileAt at = cur.at;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int gy = at.y0 + (wg * MT + mt) * 4 + warp;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int gx = at.x0 + lane / 4 + 8 * hf;
          if (gy >= H || gx >= W) continue;
          const size_t pix = (size_t)at.n * H * W + (size_t)gy * W + gx;
          bf16* out = y + pix * Cout;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int co = n0 + 8 * i + 2 * (lane % 4);
            conv::store_pair(out, co, Cout,
                             conv::finish_pair(bs, co, Cout,
                                               acc[mt][4 * i + 2 * hf],
                                               acc[mt][4 * i + 2 * hf + 1],
                                               relu),
                             pair_ok);
          }
        }
      }
    }
    cur.advance(nchunks, npass, tiles_h, tiles_w);
  });
}

// Cout <= 8.  One work item = (tile, KC-channel chunk).
constexpr int kNarrowThreads = 256;  // eight warps, two tile rows each
constexpr int kNarrowOutBytes = kTile * kTile * 8 * 2;
template <int KC>
__host__ __device__ constexpr int narrow_stage_bytes() {
  return kWin * kWin * 2 * KC + 9 * 8 * (KC + 8) * 2;
}

template <int KC>
__global__ void __launch_bounds__(kNarrowThreads, 2)
conv3x3_narrow_kernel(conv::Image im, const bf16* __restrict__ w,
                      const float* __restrict__ bias, bf16* __restrict__ y,
                      int H, int W, int Cout, int relu, int tiles_h,
                      int tiles_w, int total_tiles) {
  const int Cin = im.C;
  constexpr int XB = kWin * kWin * 2 * KC;
  constexpr int SB = narrow_stage_bytes<KC>();
  constexpr int WP = KC + 8;  // weight row pitch: rows fall on distinct banks
  constexpr int KS = KC / 16;
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  bf16* outs = reinterpret_cast<bf16*>(smem_mma + 2 * SB);  // [row][px][Cout]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int nchunks = (Cin + KC - 1) / KC;
  const int my_tiles =
      (total_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nitems = my_tiles * nchunks;

  auto fill = [&](int item, int stage) {
    const int t = (int)blockIdx.x + (item / nchunks) * (int)gridDim.x;
    const int c0 = (item % nchunks) * KC;
    const TileAt at = tile_at(t, tiles_h, tiles_w);
    unsigned char* st = smem_mma + stage * SB;
    conv::load_window<KC, kWin, kWin, kNarrowThreads>(
        st, im.at(at.n), H, W, c0, at.y0 - 1, at.x0 - 1, tid);
    // with one chunk per tile both stages keep the weights they were given
    if (nchunks > 1 || item < 2) {
      bf16* ws = reinterpret_cast<bf16*>(st + XB);  // [tap][n][WP]
      for (int i = tid; i < 9 * 8 * KC; i += kNarrowThreads) {
        const int k = i % KC, n = (i / KC) % 8, tap = i / (8 * KC);
        bf16 v = __float2bfloat16(0.f);
        if (c0 + k < Cin && n < Cout)
          v = w[((size_t)tap * Cin + c0 + k) * Cout + n];
        ws[(tap * 8 + n) * WP + k] = v;
      }
    }
  };

  int pbase[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    pbase[mt] = (warp * 2 + mt) * kWin + conv::ldm_row();
  const int khalf = conv::ldm_khalf();

  float acc[2][4];
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
        for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
    }
    const conv::WindowAddr<KC> addr{mma::smem_u32(smem_mma + stage * SB)};
    const unsigned char* ws = smem_mma + stage * SB + XB;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * kWin + tap % 3;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t* wr = reinterpret_cast<const uint32_t*>(
            ws + ((tap * 8 + g) * WP + ks * 16 + 2 * q) * 2);
        const uint32_t b[2] = {wr[0], wr[4]};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
          mma::ldmatrix_x4(a, addr(pbase[mt] + shift, ks * 2 + khalf));
          mma::mma_m16n8k16(acc[mt], a, b);
        }
      }
    }
    if (item % nchunks == nchunks - 1) {
      const int t = (int)blockIdx.x + (item / nchunks) * (int)gridDim.x;
      const TileAt at = tile_at(t, tiles_h, tiles_w);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int px = g + 8 * (e / 2), co = 2 * q + e % 2;
          if (co >= Cout) continue;
          float v = acc[mt][e] + bias[co];
          if (relu) v = cid::relu_f32(v);
          outs[((warp * 2 + mt) * kTile + px) * Cout + co] =
              __float2bfloat16(v);
        }
      __syncthreads();
      // each tile row is one contiguous run of the output
      const int run = min(kTile, W - at.x0) * Cout;
      for (int i = tid; i < kTile * kTile * Cout; i += kNarrowThreads) {
        const int r = i / (kTile * Cout), e = i % (kTile * Cout);
        const int gy = at.y0 + r;
        if (gy < H && e < run)
          y[((size_t)at.n * H * W + (size_t)gy * W + at.x0) * Cout + e] =
              outs[i];
      }
    }
    __syncthreads();
  }
}

constexpr int bias_bytes(int cout) {
  return (cout + conv::kNB - 1) / conv::kNB * conv::kNB * 4;
}
template <int KC, int S>
constexpr int wide_ring_bytes(int weight_slots) {
  return weight_slots * conv::weight_stage_bytes(KC) + S * kWin * kWin * 2 * KC;
}

template <int KC, int S>
cudaError_t launch_wide(const conv::Input& in, const bf16* w, const float* b,
                        bf16* y, int n, int h, int wd, int cout, int relu,
                        bool resident, const float* qscale, int8_t* yq,
                        cudaStream_t stream) {
  const int cin = in.a.C + in.b.C;
  const int nchunks = (cin + KC - 1) / KC;
  // s8 out: QScales (12 bytes a channel) beside the f32 bias, and staging
  const int smem = wide_ring_bytes<KC, S>(resident ? nchunks : S) +
                   bias_bytes(cout) * (qscale ? 4 : 1) +
                   (qscale ? kQ8StageBytes : 0);
  const auto kernel = qscale ? conv3x3_wgmma_kernel<KC, S, true>
                             : conv3x3_wgmma_kernel<KC, S, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + kTile - 1) / kTile, tiles_w = (wd + kTile - 1) / kTile;
  const long long tiles = (long long)n * tiles_h * tiles_w;
  const int sms = conv::sm_count();
  if (!cid::grid_fits(tiles) || sms <= 0) return cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, conv::kThreads, smem, stream>>>(
      in, w, b, y, h, wd, cout, relu, tiles_h, tiles_w, (int)tiles,
      cout % 8 == 0 && conv::aligned16(w),
      cout % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 3) == 0, resident,
      qscale, yq, cout % 16 == 0 && conv::aligned16(yq));
  return cudaGetLastError();
}

template <int KC>
cudaError_t launch_narrow(const bf16* x, const bf16* w, const float* b,
                          bf16* y, int n, int h, int wd, int cin, int cout,
                          int relu, cudaStream_t stream) {
  constexpr int smem = 2 * narrow_stage_bytes<KC>() + kNarrowOutBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_narrow_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + kTile - 1) / kTile, tiles_w = (wd + kTile - 1) / kTile;
  const long long tiles = (long long)n * tiles_h * tiles_w;
  const int sms = conv::sm_count();
  if (!cid::grid_fits(tiles) || sms <= 0) return cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(tiles < 2 * sms ? tiles : 2 * sms);
  conv3x3_narrow_kernel<KC><<<grid, kNarrowThreads, smem, stream>>>(
      conv::dense_image(x, h, wd, cin), w, b, y, h, wd, cout, relu, tiles_h,
      tiles_w, (int)tiles);
  return cudaGetLastError();
}

// ---- float32, Cout > 4: tensor cores, three TF32 products -------------------
// One work item = (tile, 64-channel output pass, 8-channel chunk): the
// chunk's 18x18 window (10,368 bytes) and its 9 taps' hi and lo B tiles
// (36,864 bytes), S stages of them.
constexpr int kWin32Bytes = kWin * kWin * 32;
constexpr int kW32Bytes = 9 * conv::kTapBytes32;
constexpr int kStages32 = 4;

template <int S>
__global__ void __launch_bounds__(conv::kThreads, 1)
conv3x3_tf32_kernel(conv::Input in, const float* __restrict__ wk,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int H, int W, int Cout, int relu, int tiles_h,
                    int tiles_w, int total_tiles, int pair_ok) {
  const int Cin = (in.a.C + in.b.C) / 2;  // the loaders count bf16 halves
  constexpr int MT = 2;  // position tiles (4 tile rows each) per warpgroup
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  unsigned char* wst = smem_mma;                  // [S][kW32Bytes]
  unsigned char* xst = smem_mma + S * kW32Bytes;  // [S][kWin32Bytes]

  const int tid = threadIdx.x;
  const int nchunks = (Cin + conv::kKC32 - 1) / conv::kKC32;
  const int npass = (Cout + conv::kNB - 1) / conv::kNB;
  const int my_tiles =
      (total_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nitems = my_tiles * npass * nchunks;
  float* bs = reinterpret_cast<float*>(xst + S * kWin32Bytes);  // [npass*64]
  conv::load_bias(bs, bias, Cout, npass * conv::kNB, tid, conv::kThreads);

  if (tid >= conv::kConsumers) {
    mma::setmaxnreg_dec<conv::kProducerRegs>();
    const int ptid = tid - conv::kConsumers;
    Cursor ahead;
    ahead.start(tiles_h, tiles_w);
    conv::produce<S>(nitems, [&](int, int stage) {
      const int c0 = 2 * conv::kKC32 * ahead.chunk;  // in bf16 halves
      conv::load_window<2 * conv::kKC32, kWin, kWin, conv::kProducers>(
          xst + stage * kWin32Bytes, in.of(c0, ahead.at.n), H, W,
          in.local(c0), ahead.at.y0 - 1, ahead.at.x0 - 1, ptid);
      conv::load_weights_tf32<9, conv::kProducers>(
          wst + stage * kW32Bytes,
          wk + (size_t)(ahead.pass * nchunks + ahead.chunk) * 9 *
                   conv::kTapFloats32,
          ptid);
      ahead.advance(nchunks, npass, tiles_h, tiles_w);
    });
    return;
  }
  mma::setmaxnreg_inc<conv::kConsumerRegs>();
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  int pbase[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    pbase[mt] = ((wg * MT + mt) * 4 + warp) * kWin + conv::ldm_row();

  Cursor cur;
  cur.start(tiles_h, tiles_w);
  float acc[MT][32], part[MT][32];
  conv::consume<S>(nitems, [&](int, int stage) {
    conv::mma_taps_tf32<9, MT>(
        part, conv::WindowAddr<2 * conv::kKC32>{
                  mma::smem_u32(xst + stage * kWin32Bytes)},
        pbase, 0, kWin, mma::smem_u32(wst + stage * kW32Bytes), true);
    conv::add_part(acc, part, cur.chunk == 0);
    if (cur.chunk == nchunks - 1) {
      const int n0 = cur.pass * conv::kNB;
      const TileAt at = cur.at;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int gy = at.y0 + (wg * MT + mt) * 4 + warp;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int gx = at.x0 + lane / 4 + 8 * hf;
          if (gy >= H || gx >= W) continue;
          float* out = y + ((size_t)at.n * H * W + (size_t)gy * W + gx) * Cout;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int co = n0 + 8 * i + 2 * (lane % 4);
            conv::store_pair_f32(
                out, co, Cout,
                conv::finish_pair_f32(bs, co, Cout, acc[mt][4 * i + 2 * hf],
                                      acc[mt][4 * i + 2 * hf + 1], relu),
                pair_ok);
          }
        }
      }
    }
    cur.advance(nchunks, npass, tiles_h, tiles_w);
  });
}

// x2 (may be null): a second input of cb channels behind x's ca, read in
// place; x's channels must end on a chunk boundary (ca % 8 == 0).  wk: the
// split weights, (ceil(Cout / 64), ceil(Cin / 8), 9, 2, 64, 8) f32.
cudaError_t dispatch_tf32(const void* xv, const void* x2v, const void* wk,
                          const void* bv, void* yv, int n, int h, int wd,
                          int ca, int cb, int cout, int relu, long long x2_sn,
                          long long x2_sh, long long x2_sw, cudaStream_t s) {
  const int cin = ca + cb;
  if (cout <= 4 || wk == nullptr) return cudaErrorInvalidValue;
  if (x2v != nullptr && (ca % conv::kKC32 != 0 || cb < 1 ||
                         !conv::strides_fit(2 * x2_sh, 2 * x2_sw)))
    return cudaErrorInvalidValue;
  if (!conv::strides_fit(2LL * wd * ca, 2LL * ca)) return cudaErrorInvalidValue;
  const conv::Input in{
      conv::f32_image(static_cast<const float*>(xv), ca, (long long)h * wd * ca,
                      (long long)wd * ca, ca),
      conv::f32_image(static_cast<const float*>(x2v), cb, x2_sn, x2_sh,
                      x2_sw)};
  constexpr int S = kStages32;
  const int smem = S * (kW32Bytes + kWin32Bytes) + bias_bytes(cout);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_tf32_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + kTile - 1) / kTile, tiles_w = (wd + kTile - 1) / kTile;
  const long long tiles = (long long)n * tiles_h * tiles_w;
  const int sms = conv::sm_count();
  if (!cid::grid_fits(tiles) || sms <= 0 || cin < 1)
    return cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  float* y = static_cast<float*>(yv);
  conv3x3_tf32_kernel<S><<<grid, conv::kThreads, smem, s>>>(
      in, static_cast<const float*>(wk), static_cast<const float*>(bv), y, h,
      wd, cout, relu, tiles_h, tiles_w, (int)tiles,
      cout % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7) == 0);
  return cudaGetLastError();
}

// x2 (may be null): a second input of cb channels, concatenated behind x's
// ca; its strides in elements.  It needs the wgmma path and a first input
// that ends on a chunk boundary; the wrapper concatenates otherwise.
cudaError_t dispatch_bf16(const void* xv, const void* x2v, const void* wv,
                          const void* bv, void* yv, int n, int h, int wd,
                          int ca, int cb, int cout, int relu, long long x2_sn,
                          long long x2_sh, long long x2_sw, cudaStream_t s,
                          const float* qscale = nullptr,
                          int8_t* yq = nullptr) {
  const bf16* x = static_cast<const bf16*>(xv);
  const bf16* w = static_cast<const bf16*>(wv);
  const float* b = static_cast<const float*>(bv);
  bf16* y = static_cast<bf16*>(yv);
  const int cin = ca + cb;
  if (x2v != nullptr && (cout <= 8 || ca % 32 != 0 || cb < 1 ||
                         !conv::strides_fit(x2_sh, x2_sw)))
    return cudaErrorInvalidValue;
  if (!conv::strides_fit((long long)wd * cin, cin))
    return cudaErrorInvalidValue;
  if (qscale != nullptr && (x2v != nullptr || cout <= 8 || yq == nullptr))
    return cudaErrorInvalidValue;
  if (cout <= 8) {
    if (cin % 64 == 0)
      return launch_narrow<64>(x, w, b, y, n, h, wd, cin, cout, relu, s);
    return launch_narrow<16>(x, w, b, y, n, h, wd, cin, cout, relu, s);
  }
  conv::Input in{conv::dense_image(x, h, wd, ca),
                 conv::strided_image(static_cast<const bf16*>(x2v), cb, x2_sn,
                                     x2_sh, x2_sw)};
  // One 64-channel output pass and room for every chunk's weights beside
  // four 32-channel window stages (upconv1.0: 147,456 + 82,944 bytes): the
  // weights stay resident.  Else weights and windows are streamed together,
  // 32 channels at a time through three stages, or 16 through four where Cin
  // is ragged.
  if (cin % 32 == 0 && cout <= conv::kNB &&
      wide_ring_bytes<32, 4>(cin / 32) + 4 * bias_bytes(cout) +
              (qscale ? kQ8StageBytes : 0) <=
          conv::kMaxSmem)
    return launch_wide<32, 4>(in, w, b, y, n, h, wd, cout, relu, true, qscale,
                              yq, s);
  if (cin % 32 == 0)
    return launch_wide<32, 3>(in, w, b, y, n, h, wd, cout, relu, false,
                              qscale, yq, s);
  return launch_wide<16, 4>(in, w, b, y, n, h, wd, cout, relu, false, qscale,
                            yq, s);
}

}  // namespace

extern "C" int cid_conv3x3_bias_relu(const void* x, const void* x2,
                                     const void* w, const void* b, void* y,
                                     int n, int h, int wd, int ca, int cb,
                                     int cout, int relu, long long x2_sn,
                                     long long x2_sh, long long x2_sw,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == cid::kDtypeF32 && x2 == nullptr)
    return (int)launch_f32_narrow(x, w, b, y, n, h, wd, ca, cout, relu, s);
  if (dtype == cid::kDtypeBF16)
    return (int)dispatch_bf16(x, x2, w, b, y, n, h, wd, ca, cb, cout, relu,
                              x2_sn, x2_sh, x2_sw, s);
  return (int)cudaErrorInvalidValue;
}

// f32 x (N,H,W,ca) [and x2 (N,H,W,cb)] -> f32 y (N,H,W,Cout), Cout > 4, on
// the tensor cores; wk: the split weights (dispatch_tf32).  Cout <= 4 takes
// cid_conv3x3_bias_relu's narrow body.
extern "C" int cid_conv3x3_bias_relu_tf32(const void* x, const void* x2,
                                          const void* wk, const void* b,
                                          void* y, int n, int h, int wd,
                                          int ca, int cb, int cout, int relu,
                                          long long x2_sn, long long x2_sh,
                                          long long x2_sw, void* stream) {
  return (int)dispatch_tf32(x, x2, wk, b, y, n, h, wd, ca, cb, cout, relu,
                            x2_sn, x2_sh, x2_sw,
                            static_cast<cudaStream_t>(stream));
}

// bf16 x (N,H,W,Cin) -> s8 y (N,H,W,Cout) at the per-channel scales qscale
// (Cout,) f32, Cout > 8, one input; the epilogue of q8_pair.
extern "C" int cid_conv3x3_bias_relu_q8(const void* x, const void* w,
                                        const void* b, const void* qscale,
                                        void* y, int n, int h, int wd,
                                        int cin, int cout, int relu,
                                        void* stream) {
  if (qscale == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch_bf16(x, nullptr, w, b, nullptr, n, h, wd, cin, 0, cout,
                            relu, 0, 0, 0, static_cast<cudaStream_t>(stream),
                            static_cast<const float*>(qscale),
                            static_cast<int8_t*>(y));
}

extern "C" const char* cid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
