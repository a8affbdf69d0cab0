// Fused U-Net double conv: relu(conv3x3(relu(conv3x3(x) + b1)) + b2), both
// 'same', stride 1, in one kernel.
//
// Replaces celebrity_image_denoiser_tpu/ops/pallas/double_conv.py::
// double_conv3x3_relu (:108, kernel body :38-103).  As there, the
// intermediate activation never reaches device memory: it lives in shared
// memory, stored in x's dtype (:85), and conv2's zero padding sees 0
// outside the image, not conv1 evaluated past the edge (the mask at :70-84,
// here on all four sides of every tile, since H and W are both tiled).
//
// Layout: x (N,H,W,C0) NHWC; w1 (3,3,C0,C1), w2 (3,3,C1,C2) HWIO in x's
// dtype; b1 (C1,), b2 (C2,) float32; y (N,H,W,C2) NHWC.  Any C0, C1, C2, H,
// W; ragged edges are masked.  x may come as two tensors, x and x2 (a
// strided NHWC view), standing for their channel concatenation: upconv2
// reads the upsampled tensor and the cropped skip tensor in place, in bf16
// and in f32.
//
// What bounds it on an H100: every U-Net pair is far above the ridge point
// (e.g. bottleneck 128->256->256) in bf16 and in f32 alike, so it is bound
// by operations, and only the tensor cores come near that bound.  Once the
// products run there, the next limit is the weights: every block reads all
// of w1 and w2 from L2, so the tile must be large enough to amortise them.
//
// bfloat16 runs on the tensor cores (blocks from conv_mma.cuh; wgmma
// m64n64k16; two consumer warpgroups and two producer warpgroups a block, the
// producers only starting the cp.async copies one work item ahead):
//   * a block owns a 16x16 output tile and all C2 channels, for every layer:
//     the bottleneck's 18x18xC1 intermediate (165,888 bytes at C1 = 256) is
//     the largest that still leaves room in 227 KB for two stages of a
//     16-channel input window and weight chunk (2 x 31,232 bytes) and the
//     biases; against an 8x8 tile it cuts the weight reads per pixel
//     fourfold and conv1's halo overwork from 100/64 to 324/256 (384/256
//     after padding the 324 positions to six 64-row wgmma tiles, three per
//     warpgroup);
//   * conv1 is an implicit GEMM over the 324 halo positions, 64 intermediate
//     channels per pass; the 20x20 input window and w1 arrive KC1 channels
//     at a time through the two-stage ring.  Its epilogue adds b1, applies
//     ReLU, zeroes positions outside the image, rounds to bf16 once and
//     stores into the intermediate tile (pixel-major, swizzled);
//   * conv2 reads its A operand straight from that tile (a tap is a shift of
//     ldmatrix's row addresses), 64 output channels per pass over 256
//     positions (two 64-row tiles per warpgroup), w2 streamed KC2 channels at
//     a time through the same ring;
//   * blocks are persistent (one per SM) and one ring runs across conv1,
//     conv2 and tiles, so no phase starts with an empty ring;
//   * KC1, KC2 are 32 where the layer's shared memory allows, else 16
//     (bottleneck: 16, 16; down2, upconv2: 32, 32; down1: 16, 32).  down1's
//     conv1 has C0 = 3: its K is padded per tap to 16 channels (144 instead
//     of 27) and still runs on the tensor cores - the stage is 4% of the
//     layer's operations, so an im2col to K = 32 would not pay for its copy;
//     its window (rows of 6 bytes, not 16-byte aligned) is staged by plain
//     loads packed into 16-byte stores.
// float32 also runs on the tensor cores, at f32's tolerance: every multiply
// is three TF32 products (conv_mma.cuh's last section).  One TF32 product
// keeps 11 bits of each operand and misses the f32 check by 10-18x; with
// v = hi + lo (hi = tf32(v), lo = tf32(v - hi)) the sum a_lo b_hi + a_hi b_lo
// + a_hi b_hi drops only a_lo b_lo, ~2^-22 of the product.  The
// activations are split in registers as ldmatrix delivers them (the conv1
// window, and conv2's f32 intermediate as it is read); the weights come
// split and K-major (the only B layout wgmma takes for 32-bit types) from
// the wrapper, made once per loaded weights.  Bound: operations at 495 / 3
// TFLOP/s (the TF32 rate over three) for every U-Net pair.
//   * wgmma m64n64k8 tf32 with A from registers; the block, ring, producer
//     warps and persistence are the bf16 kernel's.  A work item is one
//     8-channel chunk (one k8 step) of a 64-channel pass of conv1 or conv2:
//     its 9 taps' hi and lo B tiles (36,864 bytes) and, for conv1, its input
//     window;
//   * the intermediate stays f32 in shared memory (x's dtype, as the Pallas
//     kernel keeps it), so the tile is chosen by C1p, its padded width:
//     (TH + 2) x 18 x C1p x 4 bytes for a TH x 16 output tile.  C1p = 64:
//     TH = 16, 82,944 bytes and three stages of 49,664 -- exactly the
//     232,448 a block may have (C2 <= 64; a wider C2's biases leave room
//     for six stages of one tap row).  C1p = 128: TH = 8, 92,160 bytes
//     and three stages of 44,544 (a 16x16 tile, 165,888, leaves room for
//     two stages of a third of an item only).  C1p = 256 (the bottleneck):
//     a 16x16 tile's 331,776 bytes exceed the block's limit and an 8x16
//     tile's 184,320 leave room for one stage of 9 taps, so its items are
//     one tap row (12,288 bytes of B tiles, 6,400 of window), two stages
//     (dispatch_tf32 has the measured cost of the smaller items);
//   * the tensor cores add into a wgmma accumulator by truncation, an error
//     biased one way that grew with K (2.35e-5 of max|ref| at the
//     bottleneck when one accumulator took all 2304 products of an output,
//     2.0e-6 as below; ops/cuda/ablation.py --only f32, H100).  So each
//     chunk's 72 products go into a fresh accumulator (part) that is then
//     added, rounded to nearest, to a running total: conv2's in registers,
//     conv1's in the intermediate itself (no registers held across
//     chunks, where conv1's three 64-row tiles already fill them);
//   * conv1's halo positions fill 64-row tiles (324 in 384 at TH = 16, 180
//     in 256 at TH = 8, where the second warpgroup's last tile is padding
//     only and computed all the same); conv2 walks C1's chunks only;
//   * C0 = 3 pads K per tap to one k8 step (72 instead of 27);
//   * each output's summation order is fixed (no split-K, no atomics), so
//     two runs are bit-equal.
// The TPU artifacts (C0 < 8 padding, kpack, H % tile_h == 0) are not carried
// over.

#include <cstdint>

#include "common.cuh"
#include "conv_mma.cuh"

namespace {

// ---- bfloat16: tensor cores -------------------------------------------------
using cid::conv::bf16;
namespace conv = cid::conv;
namespace mma = cid::mma;

constexpr int kTile = 16;            // output tile, pixels a side
constexpr int kMid = kTile + 2;      // intermediate tile (1-pixel halo)
constexpr int kWin = kTile + 4;      // input window (2-pixel halo)
constexpr int kMidPos = kMid * kMid;  // 324 positions, in 6 tiles of 64
constexpr int kMT1 = 3, kMT2 = 2;    // 64-row tiles per warpgroup

__host__ __device__ constexpr int stage_w_bytes(int kc1, int kc2) {
  return conv::weight_stage_bytes(kc1 > kc2 ? kc1 : kc2);
}
__host__ __device__ constexpr int stage_x_bytes(int kc1) {
  return kWin * kWin * 2 * kc1;
}
__host__ __device__ constexpr int pad64(int c) {
  return (c + conv::kNB - 1) / conv::kNB * conv::kNB;
}
inline long long smem_bytes(int kc1, int kc2, int c1p, int c2) {
  return 2LL * (stage_w_bytes(kc1, kc2) + stage_x_bytes(kc1)) +
         (long long)kMidPos * c1p * 2 + (c1p + pad64(c2)) * 4;
}

// Where a block's walk over its work items stands.  Producer and consumers
// each carry their own along, so that no item costs a division.
struct Cursor {
  int conv2, pass, chunk, tile, n, y0, x0;
  __device__ __forceinline__ void set_tile(int t, int tiles_h, int tiles_w) {
    tile = t;
    x0 = (t % tiles_w) * kTile;
    t /= tiles_w;
    y0 = (t % tiles_h) * kTile;
    n = t / tiles_h;
  }
  __device__ __forceinline__ void start(int tiles_h, int tiles_w) {
    conv2 = pass = chunk = 0;
    set_tile(blockIdx.x, tiles_h, tiles_w);
  }
};

// One work item is one chunk of one 64-channel pass of conv1 or conv2 of one
// tile.  A block is persistent: it walks the items of tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... in one two-stage ring, so conv2's first
// weights arrive while conv1's last chunk is multiplied, and the next tile's
// first window while this tile's last chunk is.
template <int KC1, int KC2>
__global__ void __launch_bounds__(conv::kThreads, 1)
double_conv3x3_wgmma_kernel(conv::Input in, const bf16* __restrict__ w1,
                            const float* __restrict__ b1,
                            const bf16* __restrict__ w2,
                            const float* __restrict__ b2,
                            bf16* __restrict__ y, int H, int W, int C1, int C2,
                            int C1p, int tiles_h, int tiles_w, int total_tiles,
                            int vec_w1, int vec_w2, int pair_ok) {
  const int C0 = in.a.C + in.b.C;
  constexpr int S = 2;
  constexpr int WB = stage_w_bytes(KC1, KC2);
  constexpr int XB = stage_x_bytes(KC1);
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  unsigned char* wst = smem_mma;              // [S][WB]
  unsigned char* xst = smem_mma + S * WB;     // [S][XB]
  unsigned char* hs = xst + S * XB;           // [324][C1p] bf16, swizzled
  const int hpitch = C1p * 2;
  float* bs1 = reinterpret_cast<float*>(hs + kMidPos * hpitch);  // [C1p]
  float* bs2 = bs1 + C1p;                                        // [pad64(C2)]

  const int tid = threadIdx.x;
  conv::load_bias(bs1, b1, C1, C1p, tid, conv::kThreads);
  conv::load_bias(bs2, b2, C2, pad64(C2), tid, conv::kThreads);
  const int nchunks1 = (C0 + KC1 - 1) / KC1, nchunks2 = C1p / KC2;
  const int npass1 = C1p / conv::kNB, npass2 = (C2 + conv::kNB - 1) / conv::kNB;
  const int my_tiles =
      (total_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nitems = my_tiles * (npass1 * nchunks1 + npass2 * nchunks2);
  auto advance = [&](Cursor& c) {
    if (++c.chunk < (c.conv2 ? nchunks2 : nchunks1)) return;
    c.chunk = 0;
    if (++c.pass < (c.conv2 ? npass2 : npass1)) return;
    c.pass = 0;
    c.conv2 ^= 1;
    if (!c.conv2) c.set_tile(c.tile + gridDim.x, tiles_h, tiles_w);
  };

  if (tid >= conv::kConsumers) {
    mma::setmaxnreg_dec<conv::kProducerRegs>();
    const int ptid = tid - conv::kConsumers;
    Cursor ahead;
    ahead.start(tiles_h, tiles_w);
    conv::produce<S>(nitems, [&](int, int stage) {
      if (!ahead.conv2) {
        const int c0 = ahead.chunk * KC1;
        conv::load_window<KC1, kWin, kWin, conv::kProducers>(
            xst + stage * XB, in.of(c0, ahead.n), H, W, in.local(c0),
            ahead.y0 - 2, ahead.x0 - 2, ptid);
        conv::load_weights<KC1, conv::kProducers>(
            wst + stage * WB, w1, C0, C1, c0, ahead.pass * conv::kNB, vec_w1,
            ptid);
      } else {
        conv::load_weights<KC2, conv::kProducers>(
            wst + stage * WB, w2, C1, C2, ahead.chunk * KC2,
            ahead.pass * conv::kNB, vec_w2, ptid);
      }
      advance(ahead);
    });
    return;
  }
  mma::setmaxnreg_inc<conv::kConsumerRegs>();
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  // conv1: 324 halo positions in 6 tiles of 64; those past the 324th are
  // padding, which reads pixel 0 and stores nothing.  conv2: 256 positions.
  int pbase1[kMT1], pbase2[kMT2];
#pragma unroll
  for (int mt = 0; mt < kMT1; ++mt) {
    const int q = (wg * kMT1 + mt) * 64 + warp * 16 + conv::ldm_row();
    pbase1[mt] = q < kMidPos ? (q / kMid) * kWin + q % kMid : 0;
  }
#pragma unroll
  for (int mt = 0; mt < kMT2; ++mt)
    pbase2[mt] = ((wg * kMT2 + mt) * 4 + warp) * kMid + conv::ldm_row();

  Cursor cur;
  cur.start(tiles_h, tiles_w);
  float acc[kMT1][32];  // conv2 uses the first kMT2 tiles
  float(&acc2)[kMT2][32] = reinterpret_cast<float(&)[kMT2][32]>(acc);
  conv::consume<S>(nitems, [&](int, int stage) {
    const int y0 = cur.y0, x0 = cur.x0, n0 = cur.pass * conv::kNB;
    if (!cur.conv2) {
      // ---- conv1 + b1 + ReLU over the 18x18 halo -> hs --------------------
      if (cur.chunk == 0) conv::zero_acc(acc);
      conv::mma_chunk<KC1, kMT1>(
          acc, conv::WindowAddr<KC1>{mma::smem_u32(xst + stage * XB)}, pbase1,
          kWin, mma::smem_u32(wst + stage * WB));
      if (cur.chunk == nchunks1 - 1) {
#pragma unroll
        for (int mt = 0; mt < kMT1; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int q =
                (wg * kMT1 + mt) * 64 + warp * 16 + lane / 4 + 8 * hf;
            if (q >= kMidPos) continue;
            const int gy = y0 - 1 + q / kMid, gx = x0 - 1 + q % kMid;
            // outside the image the intermediate is conv2's zero padding
            const int c1 = gy >= 0 && gy < H && gx >= 0 && gx < W ? C1 : 0;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int c = n0 + 8 * i + 2 * (lane % 4);
              *reinterpret_cast<__nv_bfloat162*>(
                  hs + (size_t)q * hpitch + (((c / 8) ^ (q & 7)) << 4) +
                  (c % 8) * 2) =
                  conv::finish_pair(bs1, c, c1, acc[mt][4 * i + 2 * hf],
                                    acc[mt][4 * i + 2 * hf + 1], true);
            }
          }
      }
    } else {
      // ---- conv2 + b2 + ReLU over the 16x16 tile -> y -----------------------
      if (cur.chunk == 0) conv::zero_acc(acc2);
      conv::mma_chunk<KC2, kMT2>(
          acc2,
          conv::WideAddr{mma::smem_u32(hs), hpitch, cur.chunk * (KC2 / 8)},
          pbase2, kMid, mma::smem_u32(wst + stage * WB));
      if (cur.chunk == nchunks2 - 1) {
#pragma unroll
        for (int mt = 0; mt < kMT2; ++mt) {
          const int gy = y0 + (wg * kMT2 + mt) * 4 + warp;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int gx = x0 + lane / 4 + 8 * hf;
            if (gy >= H || gx >= W) continue;
            bf16* out = y + ((size_t)cur.n * H * W + (size_t)gy * W + gx) * C2;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int co = n0 + 8 * i + 2 * (lane % 4);
              conv::store_pair(out, co, C2,
                               conv::finish_pair(bs2, co, C2,
                                                 acc2[mt][4 * i + 2 * hf],
                                                 acc2[mt][4 * i + 2 * hf + 1],
                                                 true),
                               pair_ok);
            }
          }
        }
      }
    }
    advance(cur);
  });
}

template <int KC1, int KC2>
cudaError_t launch_bf16(const conv::Input& in, const bf16* w1, const float* b1,
                        const bf16* w2, const float* b2, bf16* y, int n, int h,
                        int wd, int c1, int c2, int c1p, cudaStream_t stream) {
  const int smem = (int)smem_bytes(KC1, KC2, c1p, c2);
  cudaError_t err = cudaFuncSetAttribute(
      double_conv3x3_wgmma_kernel<KC1, KC2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + kTile - 1) / kTile, tiles_w = (wd + kTile - 1) / kTile;
  const long long tiles = (long long)n * tiles_h * tiles_w;
  const int sms = conv::sm_count();
  if (!cid::grid_fits(tiles) || sms <= 0) return cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  double_conv3x3_wgmma_kernel<KC1, KC2>
      <<<grid, conv::kThreads, smem, stream>>>(
          in, w1, b1, w2, b2, y, h, wd, c1, c2, c1p, tiles_h, tiles_w,
          (int)tiles, c1 % 8 == 0 && conv::aligned16(w1),
          c2 % 8 == 0 && conv::aligned16(w2),
          c2 % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 3) == 0);
  return cudaGetLastError();
}

// The widest chunks whose two stages fit beside the intermediate tile; a C1
// too wide for one block's shared memory is refused, and the error comes
// back to the wrapper.
// x2 (may be null): a second input of cb channels, concatenated behind x's
// ca; its strides in elements.  The first input must end on a 32-channel
// chunk boundary; the wrapper concatenates otherwise.
cudaError_t dispatch_bf16(const void* xv, const void* x2v, const void* w1v,
                          const void* b1v, const void* w2v, const void* b2v,
                          void* yv, int n, int h, int wd, int ca, int cb,
                          int c1, int c2, long long x2_sn, long long x2_sh,
                          long long x2_sw, cudaStream_t s) {
  if (x2v != nullptr &&
      (ca % 32 != 0 || cb < 1 || !conv::strides_fit(x2_sh, x2_sw)))
    return cudaErrorInvalidValue;
  if (!conv::strides_fit((long long)wd * ca, ca)) return cudaErrorInvalidValue;
  const int c0 = ca + cb;
  const conv::Input in{
      conv::dense_image(static_cast<const bf16*>(xv), h, wd, ca),
      conv::strided_image(static_cast<const bf16*>(x2v), cb, x2_sn, x2_sh,
                          x2_sw)};
  const bf16* w1 = static_cast<const bf16*>(w1v);
  const bf16* w2 = static_cast<const bf16*>(w2v);
  const float* b1 = static_cast<const float*>(b1v);
  const float* b2 = static_cast<const float*>(b2v);
  bf16* y = static_cast<bf16*>(yv);
  const int c1p = pad64(c1);
#define CID_TRY(KC1, KC2)                                                    \
  if (smem_bytes(KC1, KC2, c1p, c2) <= conv::kMaxSmem)                       \
    return launch_bf16<KC1, KC2>(in, w1, b1, w2, b2, y, n, h, wd, c1, c2, c1p, \
                                 s);
  if (c0 % 32 == 0) CID_TRY(32, 32)
  CID_TRY(16, 32)
  CID_TRY(16, 16)
#undef CID_TRY
  return cudaErrorInvalidValue;
}

// ---- float32: tensor cores, three TF32 products ------------------------------
// A TH x 16 output tile (TH = 16 or 8, chosen per layer by C1p: the f32
// intermediate must fit), its (TH + 2) x 18 intermediate in shared memory
// in f32, pixel-major, 16-byte pieces of 4 channels swizzled by pixel.  One
// work item = TAPS taps (all 9, or one tap row of 3 where shared memory is
// short) of one 8-channel chunk of one 64-channel pass of conv1 or conv2:
// those taps' hi and lo B tiles (4,096 bytes a tap) and, for conv1, the
// input rows they read ((TH + 4) x 20 pixels for 9 taps, (TH + 2) x 20 for
// a tap row), S stages of them.  A chunk's products are summed apart and
// added to the running total when its last item is done.
constexpr int kTW32 = 16;            // output tile width
constexpr int kMW32 = kTW32 + 2;     // intermediate width (1-pixel halo)
constexpr int kWW32 = kTW32 + 4;     // input window width (2-pixel halo)

template <int TH, int TAPS>
struct Tile32 {
  static_assert(TAPS == 3 || TAPS == 9, "a tap row or all taps an item");
  static constexpr int kRows = TAPS / 3;            // tap rows an item
  static constexpr int kMH = TH + 2;                // intermediate rows
  static constexpr int kPos1 = kMH * kMW32;         // conv1 positions
  static constexpr int kMT1 = (kPos1 + 127) / 128;  // 64-row tiles a warpgroup
  // conv2's 64-row tiles (4 tile rows each) a warpgroup; rows past TH (at
  // TH = 12) are padding
  static constexpr int kMT2 = (TH / 4 + 1) / 2;
  static constexpr int kXRows = kMH + kRows - 1;    // an item's window rows
  static constexpr int kXBytes = kXRows * kWW32 * 32;
  static constexpr int kWBytes = TAPS * conv::kTapBytes32;
  static constexpr int kStageBytes = kWBytes + kXBytes;
};
template <int TH, int TAPS>
inline long long smem_bytes_tf32(int stages, int c1p, int c2) {
  using T = Tile32<TH, TAPS>;
  return (long long)stages * T::kStageBytes + (long long)T::kPos1 * c1p * 4 +
         (c1p + pad64(c2)) * 4;
}

struct Cursor32 {
  int conv2, pass, chunk, row, tile, n, y0, x0;
  __device__ __forceinline__ void set_tile(int t, int th, int tiles_h,
                                           int tiles_w) {
    tile = t;
    x0 = (t % tiles_w) * kTW32;
    t /= tiles_w;
    y0 = (t % tiles_h) * th;
    n = t / tiles_h;
  }
};

template <int TH, int S, int TAPS>
__global__ void __launch_bounds__(conv::kThreads, 1)
double_conv3x3_tf32_kernel(conv::Input in, const float* __restrict__ w1k,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2k,
                           const float* __restrict__ b2,
                           float* __restrict__ y, int H, int W, int C1,
                           int C2, int C1p, int tiles_h, int tiles_w,
                           int total_tiles, int pair_ok) {
  using T = Tile32<TH, TAPS>;
  constexpr int MT1 = T::kMT1, MT2 = T::kMT2, GROUPS = 3 / T::kRows;
  const int C0 = (in.a.C + in.b.C) / 2;  // the loaders count bf16 halves
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  unsigned char* wst = smem_mma;                   // [S][kWBytes]
  unsigned char* xst = smem_mma + S * T::kWBytes;  // [S][kXBytes]
  unsigned char* hs = xst + S * T::kXBytes;       // [kPos1][C1p] f32
  const int hpitch = C1p * 4;
  float* bs1 = reinterpret_cast<float*>(hs + T::kPos1 * hpitch);  // [C1p]
  float* bs2 = bs1 + C1p;                                         // [pad64(C2)]

  const int tid = threadIdx.x;
  conv::load_bias(bs1, b1, C1, C1p, tid, conv::kThreads);
  conv::load_bias(bs2, b2, C2, pad64(C2), tid, conv::kThreads);
  // conv2 walks C1's chunks only: the intermediate is zero beyond C1
  const int nchunks1 = (C0 + conv::kKC32 - 1) / conv::kKC32;
  const int nchunks2 = (C1 + conv::kKC32 - 1) / conv::kKC32;
  const int npass1 = C1p / conv::kNB, npass2 = (C2 + conv::kNB - 1) / conv::kNB;
  const int my_tiles =
      (total_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nitems =
      my_tiles * GROUPS * (npass1 * nchunks1 + npass2 * nchunks2);
  auto start = [&](Cursor32& c) {
    c.conv2 = c.pass = c.chunk = c.row = 0;
    c.set_tile(blockIdx.x, TH, tiles_h, tiles_w);
  };
  auto advance = [&](Cursor32& c) {  // row: the item's first tap row
    if ((c.row += T::kRows) < 3) return;
    c.row = 0;
    if (++c.chunk < (c.conv2 ? nchunks2 : nchunks1)) return;
    c.chunk = 0;
    if (++c.pass < (c.conv2 ? npass2 : npass1)) return;
    c.pass = 0;
    c.conv2 ^= 1;
    if (!c.conv2) c.set_tile(c.tile + gridDim.x, TH, tiles_h, tiles_w);
  };

  if (tid >= conv::kConsumers) {
    mma::setmaxnreg_dec<conv::kProducerRegs>();
    const int ptid = tid - conv::kConsumers;
    Cursor32 ahead;
    start(ahead);
    conv::produce<S>(nitems, [&](int, int stage) {
      const size_t tap0 = 3 * ahead.row;
      if (!ahead.conv2) {
        const int c0 = 2 * conv::kKC32 * ahead.chunk;  // in bf16 halves
        conv::load_window<2 * conv::kKC32, T::kXRows, kWW32,
                          conv::kProducers>(
            xst + stage * T::kXBytes, in.of(c0, ahead.n), H, W, in.local(c0),
            ahead.y0 - 2 + ahead.row, ahead.x0 - 2, ptid);
        conv::load_weights_tf32<TAPS, conv::kProducers>(
            wst + stage * T::kWBytes,
            w1k + ((size_t)(ahead.pass * nchunks1 + ahead.chunk) * 9 + tap0) *
                      conv::kTapFloats32,
            ptid);
      } else {
        conv::load_weights_tf32<TAPS, conv::kProducers>(
            wst + stage * T::kWBytes,
            w2k + ((size_t)(ahead.pass * nchunks2 + ahead.chunk) * 9 + tap0) *
                      conv::kTapFloats32,
            ptid);
      }
      advance(ahead);
    });
    return;
  }
  mma::setmaxnreg_inc<conv::kConsumerRegs>();
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  // conv1: the halo positions in 64-row tiles; those past kPos1 are padding,
  // which reads pixel 0 and stores nothing.  An item's window starts at its
  // first tap row, so position (r, c) reads window pixel (r + tap / 3, c +
  // tap % 3) for the item's taps.
  int pbase1[MT1], pbase2[MT2];
#pragma unroll
  for (int mt = 0; mt < MT1; ++mt) {
    const int q = (wg * MT1 + mt) * 64 + warp * 16 + conv::ldm_row();
    pbase1[mt] = q < T::kPos1 ? (q / kMW32) * kWW32 + q % kMW32 : 0;
  }
#pragma unroll
  for (int mt = 0; mt < MT2; ++mt) {
    const int r = (wg * MT2 + mt) * 4 + warp;  // padding rows read row 0
    pbase2[mt] = (r < TH ? r : 0) * kMW32 + conv::ldm_row();
  }

  // part: a chunk's partial sums (mma_taps_tf32), conv2 using the first
  // MT2 tiles.  conv1's running total lives in the intermediate itself,
  // conv2's in acc2.
  Cursor32 cur;
  start(cur);
  float part[MT1 > MT2 ? MT1 : MT2][32], acc2[MT2][32];
  float(&part1)[MT1][32] = reinterpret_cast<float(&)[MT1][32]>(part);
  float(&part2)[MT2][32] = reinterpret_cast<float(&)[MT2][32]>(part);
  conv::consume<S>(nitems, [&](int, int stage) {
    const int y0 = cur.y0, x0 = cur.x0, n0 = cur.pass * conv::kNB;
    const bool fresh = cur.row == 0;            // the chunk's first item
    const bool last = cur.row + T::kRows == 3;  // the chunk's last item
    const uint32_t wstage = mma::smem_u32(wst + stage * T::kWBytes);
    if (!cur.conv2) {
      // ---- conv1 + b1 + ReLU over the halo -> hs -------------------------
      conv::mma_taps_tf32<TAPS, MT1>(
          part1, conv::WindowAddr<2 * conv::kKC32>{
                     mma::smem_u32(xst + stage * T::kXBytes)},
          pbase1, 0, kWW32, wstage, fresh);
      if (last) {
        // the chunk's sums into the running total in hs; after the last
        // chunk, + b1, ReLU, and 0 outside the image (conv2's padding)
        const bool first_chunk = cur.chunk == 0;
        const bool last_chunk = cur.chunk == nchunks1 - 1;
#pragma unroll
        for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int q =
                (wg * MT1 + mt) * 64 + warp * 16 + lane / 4 + 8 * hf;
            if (q >= T::kPos1) continue;
            const int gy = y0 - 1 + q / kMW32, gx = x0 - 1 + q % kMW32;
            const int c1 = gy >= 0 && gy < H && gx >= 0 && gx < W ? C1 : 0;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int c = n0 + 8 * i + 2 * (lane % 4);
              float2* h = reinterpret_cast<float2*>(
                  hs + (size_t)q * hpitch + (((c / 4) ^ (q & 7)) << 4) +
                  (c % 4) * 4);
              float2 v = make_float2(part1[mt][4 * i + 2 * hf],
                                     part1[mt][4 * i + 2 * hf + 1]);
              if (!first_chunk) {
                const float2 o = *h;
                v = make_float2(o.x + v.x, o.y + v.y);
              }
              if (last_chunk) v = conv::finish_pair_f32(bs1, c, c1, v.x, v.y,
                                                        true);
              *h = v;
            }
          }
      }
    } else {
      // ---- conv2 + b2 + ReLU over the output tile -> y -----------------------
      conv::mma_taps_tf32<TAPS, MT2>(
          part2,
          conv::WideAddr{mma::smem_u32(hs), hpitch,
                         cur.chunk * (conv::kKC32 / 4)},
          pbase2, cur.row * kMW32, kMW32, wstage, fresh);
      if (last) conv::add_part(acc2, part2, cur.chunk == 0);
      if (cur.chunk == nchunks2 - 1 && last) {
#pragma unroll
        for (int mt = 0; mt < MT2; ++mt) {
          const int r = (wg * MT2 + mt) * 4 + warp, gy = y0 + r;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int gx = x0 + lane / 4 + 8 * hf;
            if (r >= TH || gy >= H || gx >= W) continue;
            float* out = y + ((size_t)cur.n * H * W + (size_t)gy * W + gx) * C2;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int co = n0 + 8 * i + 2 * (lane % 4);
              conv::store_pair_f32(
                  out, co, C2,
                  conv::finish_pair_f32(bs2, co, C2, acc2[mt][4 * i + 2 * hf],
                                        acc2[mt][4 * i + 2 * hf + 1], true),
                  pair_ok);
            }
          }
        }
      }
    }
    advance(cur);
  });
}

template <int TH, int S, int TAPS>
cudaError_t launch_tf32(const conv::Input& in, const float* w1k,
                        const float* b1, const float* w2k, const float* b2,
                        float* y, int n, int h, int wd, int c1, int c2,
                        int c1p, cudaStream_t stream) {
  const int smem = (int)smem_bytes_tf32<TH, TAPS>(S, c1p, c2);
  cudaError_t err = cudaFuncSetAttribute(
      double_conv3x3_tf32_kernel<TH, S, TAPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + TH - 1) / TH, tiles_w = (wd + kTW32 - 1) / kTW32;
  const long long tiles = (long long)n * tiles_h * tiles_w;
  const int sms = conv::sm_count();
  if (!cid::grid_fits(tiles) || sms <= 0) return cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  double_conv3x3_tf32_kernel<TH, S, TAPS>
      <<<grid, conv::kThreads, smem, stream>>>(
      in, w1k, b1, w2k, b2, y, h, wd, c1, c2, c1p, tiles_h, tiles_w,
      (int)tiles, c2 % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7) == 0);
  return cudaGetLastError();
}

// The tile and ring by C1p, the intermediate's channels (whole 64-channel
// passes).  The f32 intermediate takes (TH + 2) x 18 x C1p x 4 bytes:
//   C1p =  64, 16x16 tile:  82,944 bytes, beside it three stages of 9-tap
//                          items (49,664 bytes each: exactly the 232,448 a
//                          block may have with C2 <= 64), else six of 3-tap
//                          items (23,808);
//   C1p = 128,  8x16 tile:  92,160 bytes, three stages of 9-tap items
//                          (44,544); a 16x16 tile (165,888) leaves room
//                          for two stages of 3-tap items only, which took
//                          1.2x as long at upconv2 (256 -> 128 -> 128,
//                          256x256);
//   C1p = 256,  8x16 tile: 184,320 bytes (a 16x16 one, 331,776, exceeds the
//                          block's limit), two stages of 3-tap items
//                          (18,688): one stage of 9 taps is all that fits.
// Items of all 9 taps meet the block's barriers a third as often: 3-tap
// items took 1.16-1.32x as long at C1p = 64 (down1, 64 -> 64 -> 64; both
// at 512x512).  Times on an H100 80GB HBM3 at 700 W: ops/cuda/ablation.py
// --only f32.
// A wider C1 is refused, and the error comes back to the wrapper.  x2 (may
// be null): a second input behind x's ca channels, read in place; x's
// channels must end on a chunk boundary (ca % 8 == 0).  w1k, w2k: the
// split weights (conv3x3.py::tf32_weights).
cudaError_t dispatch_tf32(const void* xv, const void* x2v, const void* w1k,
                          const void* b1v, const void* w2k, const void* b2v,
                          void* yv, int n, int h, int wd, int ca, int cb,
                          int c1, int c2, long long x2_sn, long long x2_sh,
                          long long x2_sw, cudaStream_t s) {
  if (w1k == nullptr || w2k == nullptr) return cudaErrorInvalidValue;
  if (x2v != nullptr && (ca % conv::kKC32 != 0 || cb < 1 ||
                         !conv::strides_fit(2 * x2_sh, 2 * x2_sw)))
    return cudaErrorInvalidValue;
  if (!conv::strides_fit(2LL * wd * ca, 2LL * ca)) return cudaErrorInvalidValue;
  const conv::Input in{
      conv::f32_image(static_cast<const float*>(xv), ca, (long long)h * wd * ca,
                      (long long)wd * ca, ca),
      conv::f32_image(static_cast<const float*>(x2v), cb, x2_sn, x2_sh,
                      x2_sw)};
  const float* w1 = static_cast<const float*>(w1k);
  const float* w2 = static_cast<const float*>(w2k);
  const float* b1 = static_cast<const float*>(b1v);
  const float* b2 = static_cast<const float*>(b2v);
  float* y = static_cast<float*>(yv);
  const int c1p = pad64(c1);
#define CID_TRY(TH, S, TAPS)                                              \
  if (smem_bytes_tf32<TH, TAPS>(S, c1p, c2) <= conv::kMaxSmem)            \
    return launch_tf32<TH, S, TAPS>(in, w1, b1, w2, b2, y, n, h, wd, c1, c2, \
                                    c1p, s);
  CID_TRY(16, 3, 9)
  CID_TRY(16, 6, 3)
  CID_TRY(8, 3, 9)
  CID_TRY(8, 2, 3)
#undef CID_TRY
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int cid_double_conv3x3_relu(const void* x, const void* x2,
                                       const void* w1, const void* b1,
                                       const void* w2, const void* b2, void* y,
                                       int n, int h, int wd, int ca, int cb,
                                       int c1, int c2, long long x2_sn,
                                       long long x2_sh, long long x2_sw,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == cid::kDtypeBF16)
    return (int)dispatch_bf16(x, x2, w1, b1, w2, b2, y, n, h, wd, ca, cb, c1,
                              c2, x2_sn, x2_sh, x2_sw, s);
  return (int)cudaErrorInvalidValue;
}

// f32 x (N,H,W,ca) [and x2 (N,H,W,cb)] -> f32 y (N,H,W,C2) on the tensor
// cores; w1k, w2k: the split weights (dispatch_tf32).
extern "C" int cid_double_conv3x3_relu_tf32(
    const void* x, const void* x2, const void* w1k, const void* b1,
    const void* w2k, const void* b2, void* y, int n, int h, int wd, int ca,
    int cb, int c1, int c2, long long x2_sn, long long x2_sh, long long x2_sw,
    void* stream) {
  return (int)dispatch_tf32(x, x2, w1k, b1, w2k, b2, y, n, h, wd, ca, cb, c1,
                            c2, x2_sn, x2_sh, x2_sw,
                            static_cast<cudaStream_t>(stream));
}
