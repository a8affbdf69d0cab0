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
// W; ragged edges are masked.  In bf16 x may come as two tensors, x and x2 (a
// strided NHWC view), standing for their channel concatenation: upconv2
// reads the upsampled tensor and the cropped skip tensor in place.
//
// What bounds it on an H100: every U-Net pair is far above the bf16 ridge
// point (e.g. bottleneck 128->256->256), so it is bound by operations, and
// only the tensor cores come near that bound.  Once the products run there,
// the next limit is the weights: every block reads all of w1 and w2 from L2,
// so the tile must be large enough to amortise them.
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
// float32 keeps f32 FMA on the CUDA cores (no tensor-core type holds f32's
// tolerance; TF32 must fail it): an 8x8 output tile, conv1 over its 10x10
// halo, 64 channels per pass, 256 threads as 16 channel groups of 4 x 16
// pixel groups, the input streamed 8 channels at a time.
// The TPU artifacts (C0 < 8 padding, kpack, H % tile_h == 0) are not carried
// over.

#include <cstdint>

#include "common.cuh"
#include "conv_mma.cuh"

namespace {

// ---- float32: CUDA cores --------------------------------------------------
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

using T = float;

__global__ void __launch_bounds__(kThreads)
double_conv3x3_f32_kernel(const T* __restrict__ x, const T* __restrict__ w1,
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

cudaError_t launch_f32(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* y, int n, int h,
                       int wd, int c0, int c1, int c2, cudaStream_t stream) {
  const int c1p = (c1 + COT - 1) / COT * COT;
  const size_t smem = sizeof(float) * (kWsFloats + kXsFloats) +
                      sizeof(T) * (size_t)MH * MW * c1p;
  // a C1 too wide for one block's shared memory is refused here, and the
  // error comes back to the wrapper
  cudaError_t err = cudaFuncSetAttribute(
      double_conv3x3_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + TH - 1) / TH;
  const int tiles_w = (wd + TW - 1) / TW;
  const long long blocks = (long long)n * tiles_h * tiles_w;
  if (!cid::grid_fits(blocks)) return cudaErrorInvalidConfiguration;
  double_conv3x3_f32_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(y), h, wd, c0, c1, c2,
      c1p, tiles_h, tiles_w);
  return cudaGetLastError();
}

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

}  // namespace

extern "C" int cid_double_conv3x3_relu(const void* x, const void* x2,
                                       const void* w1, const void* b1,
                                       const void* w2, const void* b2, void* y,
                                       int n, int h, int wd, int ca, int cb,
                                       int c1, int c2, long long x2_sn,
                                       long long x2_sh, long long x2_sw,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == cid::kDtypeF32 && x2 == nullptr)
    return (int)launch_f32(x, w1, b1, w2, b2, y, n, h, wd, ca, c1, c2, s);
  if (dtype == cid::kDtypeBF16)
    return (int)dispatch_bf16(x, x2, w1, b1, w2, b2, y, n, h, wd, ca, cb, c1,
                              c2, x2_sn, x2_sh, x2_sw, s);
  return (int)cudaErrorInvalidValue;
}
