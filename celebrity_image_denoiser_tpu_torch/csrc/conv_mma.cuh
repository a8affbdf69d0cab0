// Building blocks of the bf16 and f32 3x3 convolutions as implicit GEMMs on
// the tensor cores, shared by conv3x3_bias_relu.cu and
// double_conv3x3_relu.cu.
//
// One conv stage is a GEMM per tile: M = positions of the tile (64 per
// wgmma), N = output channels (64 per wgmma), K = 9 taps x input channels,
// walked tap by tap and KC channels at a time.  The activations of a tile
// (with its halo) lie in shared memory pixel-major, channels contiguous, so
// a tap is a shift of the row addresses that ldmatrix is given and nothing
// is copied per tap (no im2col).  The weights of a chunk lie beside them as
// the wgmma B tiles: for each 64-channel output block and tap, KC rows of 64
// output channels (128 bytes), 128-byte swizzled.
//
// Both operands arrive by 16-byte asynchronous copies with zero-fill (out of
// image, out of channels); tensors whose rows are not 16-byte aligned (Cin or
// Cout not a multiple of 8, e.g. Cin = 3) are staged by plain 2-byte loads
// into the same layout.
//
// float32 runs the same GEMMs as three TF32 products per multiply (the
// section at the end): each operand v is split into hi = tf32(v) and lo =
// tf32(v - hi), and a_lo b_hi + a_hi b_lo, then a_hi b_hi, are accumulated
// in f32 on wgmma m64n64k8 (the dropped a_lo b_lo is ~2^-22 relative), a
// partial sum a chunk of 8 input channels added to the running total.  A
// (the activations) is split in registers as it leaves ldmatrix; B (the
// weights) arrives split, K-major, from the wrapper.
#pragma once

#include "mma.cuh"

namespace cid {
namespace conv {

using bf16 = __nv_bfloat16;

// A wgmma block: two consumer warpgroups (ldmatrix, wgmma, epilogue) and two
// producer warpgroups that only start the copies, so their address
// arithmetic stays out of the consumers' instruction stream.  Eight producer
// warps rather than four: a warp keeps a limited number of copies in flight,
// and with four the bottleneck layer's copies alone took half as long again.
// The register split must fit the SM's file: 256 x 216 + 256 x 40 = 65,536.
constexpr int kConsumers = 256;
constexpr int kProducers = 256;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kProducerRegs = 40, kConsumerRegs = 216;  // setmaxnreg
constexpr int kNB = 64;         // output channels per wgmma and per B tile
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// ---- activation tiles ----------------------------------------------------
// Pixel p of a tile holds `pitch` bytes (its channels); the 16-byte piece j
// is stored at piece j ^ swizzle(p), so the eight rows of one ldmatrix
// matrix (eight neighbouring pixels) fall on distinct banks.
template <int PITCH>
__device__ __forceinline__ int swizzle(int p) {
  static_assert(PITCH == 32 || PITCH == 64 || PITCH >= 128, "pixel pitch");
  if (PITCH >= 128) return p & 7;
  if (PITCH == 64) return (p >> 1) & 3;
  return (p >> 2) & 1;
}

// A window of KC channels staged from the image, pitch 2 * KC bytes.
template <int KC>
struct WindowAddr {
  uint32_t base;
  __device__ __forceinline__ uint32_t operator()(int p, int piece) const {
    return base + p * (2 * KC) + ((piece ^ swizzle<2 * KC>(p)) << 4);
  }
};

// A tile with all its channels (pitch >= 128 bytes, a multiple of 128),
// read from channel piece0 * 8 on.
struct WideAddr {
  uint32_t base;
  int pitch;
  int piece0;
  __device__ __forceinline__ uint32_t operator()(int p, int piece) const {
    return base + p * pitch + (((piece0 + piece) ^ (p & 7)) << 4);
  }
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// SMs of the current device (the persistent kernels launch one block on
// each); 0 if the runtime cannot say.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// A batch of NHWC images whose channels are contiguous: pixel (n, y, x) starts
// at p + n * sn + y * sh + x * sw (in elements), so a cropped view of a
// larger tensor is an Image too.  vec: C and the strides are multiples of 8
// and p is 16-byte aligned, so every 8-channel piece is.  The strides inside
// one image are 32-bit (strides_fit), which keeps the producers' address
// arithmetic and registers small.
struct Image {
  const bf16* p;
  long long sn;
  int C, sh, sw;
  bool vec;
  // image n alone
  __device__ __forceinline__ Image at(int n) const {
    return Image{p + n * sn, 0, C, sh, sw, vec};
  }
};
inline bool strides_fit(long long sh, long long sw) {
  return sh >= 0 && sh <= 2147483647LL && sw >= 0 && sw <= 2147483647LL;
}
inline Image strided_image(const bf16* p, int C, long long sn, long long sh,
                           long long sw) {
  return Image{p, sn, C, (int)sh, (int)sw,
               C % 8 == 0 && sn % 8 == 0 && sh % 8 == 0 && sw % 8 == 0 &&
                   aligned16(p)};
}
inline Image dense_image(const bf16* p, int H, int W, int C) {
  return strided_image(p, C, (long long)H * W * C, (long long)W * C, C);
}

// A conv input given as two channel ranges, the first a.C channels from `a`
// and the rest from `b` (b.C = 0: one input): the concatenation is never
// written to device memory.  A chunk of KC channels lies in one of the two
// (a.C is a multiple of KC whenever b.C > 0; the launcher sees to it).
struct Input {
  Image a, b;
  // image n of the input that holds channel c0; field by field: a
  // reference picked at run time would send both images through local memory
  __device__ __forceinline__ Image of(int c0, int n) const {
    const bool f = c0 < a.C;
    return Image{(f ? a.p : b.p) + n * (f ? a.sn : b.sn), 0, f ? a.C : b.C,
                 f ? a.sh : b.sh, f ? a.sw : b.sw, f ? a.vec : b.vec};
  }
  __device__ __forceinline__ int local(int c0) const {
    return c0 < a.C ? c0 : c0 - a.C;
  }
};

// Stage channels [c0, c0 + KC) of the WH x WW window whose top-left pixel is
// (gy0, gx0) of the one image `im` (H x W); zeros outside the image and
// beyond im.C.  Called by NTHR threads numbered tid.  A thread's copies keep
// their 16-byte piece and step through the pixels by a constant.
template <int KC, int WH, int WW, int NTHR>
__device__ __forceinline__ void load_window(unsigned char* dst, const Image& im,
                                            int H, int W, int c0, int gy0,
                                            int gx0, int tid) {
  constexpr int PITCH = 2 * KC, PIECES = KC / 8;
  const bf16* img = im.p;
  const int C = im.C;
  if (im.vec) {
    static_assert(NTHR % PIECES == 0, "a thread keeps its piece");
    constexpr int STEP = NTHR / PIECES;  // pixels between a thread's copies
    const uint32_t d0 = mma::smem_u32(dst);
    const int j = tid % PIECES, c = c0 + 8 * j;
    // (row, column) are carried along instead of dividing in the loop
    int p = tid / PIECES, py = p / WW, px = p % WW;
    for (; p < WH * WW; p += STEP) {
      const int gy = gy0 + py, gx = gx0 + px;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
      const bf16* src = ok ? img + ((long long)gy * im.sh + gx * im.sw + c) : img;
      mma::cp_async16(d0 + p * PITCH + ((j ^ swizzle<PITCH>(p)) << 4), src,
                      ok);
      py += STEP / WW;
      px += STEP % WW;
      if (px >= WW) {
        px -= WW;
        ++py;
      }
    }
  } else {
    // one unit is one 16-byte piece of a pixel: its channels (up to 8, those
    // below C) are read one by one, packed and stored at once
#pragma unroll 2
    for (int u = tid; u < WH * WW * PIECES; u += NTHR) {
      const int p = u / PIECES, j = u % PIECES;
      const int gy = gy0 + p / WW, gx = gx0 + p % WW, c = c0 + 8 * j;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bf16* src = img + ((long long)gy * im.sh + gx * im.sw + c);
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = __float2bfloat16(0.f);
        if (inside && c + e < C) v[e] = src[e];
      }
      *reinterpret_cast<uint4*>(dst + p * PITCH +
                                ((j ^ swizzle<PITCH>(p)) << 4)) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// ---- weight tiles ----------------------------------------------------------
// Bytes of one staged weight chunk: 9 taps x KC rows of 64 output channels.
__host__ __device__ constexpr int weight_stage_bytes(int kc) {
  return 9 * kc * 128;
}

// Stage w[tap][c0 .. c0+KC)[n0 .. n0 + 64) (HWIO, Cin x Cout) as the wgmma B
// tiles of one output block at dst (1024-aligned): row (tap * KC + k) is 128
// bytes, piece j at j ^ (k % 8); zeros beyond Cin and Cout.
// vec: Cout % 8 == 0 and w 16-byte aligned.  Called by NTHR threads numbered
// tid; a thread keeps its piece and its row within a group of NTHR / 8 rows,
// and walks taps and row groups by adding constants.
template <int KC, int NTHR>
__device__ __forceinline__ void load_weights(unsigned char* dst, const bf16* w,
                                             int Cin, int Cout, int c0, int n0,
                                             bool vec, int tid) {
  if (vec) {
    constexpr int ROWS = NTHR / 8;  // rows one pass of the threads covers
    static_assert(KC % ROWS == 0 || ROWS % KC == 0, "row groups");
    const uint32_t d0 = mma::smem_u32(dst);
    const int j = tid % 8, co = n0 + 8 * j;
    if (ROWS <= KC) {
      const int k0 = tid / 8;
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int k = k0; k < KC; k += ROWS) {
          const bool ok = c0 + k < Cin && co < Cout;
          const bf16* src =
              ok ? w + ((size_t)tap * Cin + c0 + k) * Cout + co : w;
          mma::cp_async16(d0 + (tap * KC + k) * 128 + ((j ^ (k & 7)) << 4),
                          src, ok);
        }
    } else {  // several taps per pass
      const int k = (tid / 8) % KC;
      const bool ok = c0 + k < Cin && co < Cout;
      for (int tap = (tid / 8) / KC; tap < 9; tap += ROWS / KC) {
        const bf16* src = ok ? w + ((size_t)tap * Cin + c0 + k) * Cout + co : w;
        mma::cp_async16(d0 + (tap * KC + k) * 128 + ((j ^ (k & 7)) << 4), src,
                        ok);
      }
    }
  } else {
    for (int i = tid; i < 9 * KC * kNB; i += NTHR) {
      const int n = i % kNB, r = i / kNB;
      const int k = r % KC, tap = r / KC;
      const int c = c0 + k, co = n0 + n;
      bf16 v = __float2bfloat16(0.f);
      if (c < Cin && co < Cout) v = w[((size_t)tap * Cin + c) * Cout + co];
      *reinterpret_cast<bf16*>(dst + r * 128 + (((n / 8) ^ (k & 7)) << 4) +
                               (n % 8) * 2) = v;
    }
  }
}

// ---- the ring --------------------------------------------------------------
// The producer warps' loop over a block's work items: fill(item,
// stage) starts the copies of an item into one of S stages, S - 1 items
// ahead of the one being multiplied.  Each item has two block-wide barriers,
// which the consumers meet in consume(): the first when the item's data has
// landed, the second when its stage may be overwritten.
template <int S, class Fill>
__device__ __forceinline__ void produce(int nitems, Fill fill) {
  for (int item = 0; item < S - 1; ++item) {
    if (item < nitems) fill(item, item);
    mma::cp_async_commit();
  }
  for (int item = 0; item < nitems; ++item) {
    mma::cp_async_wait<S - 2>();  // all but the S - 2 newest groups: item's
    __syncthreads();
    const int ahead = item + S - 1;
    if (ahead < nitems) fill(ahead, ahead % S);
    mma::cp_async_commit();
    __syncthreads();
  }
}
template <int S, class Work>
__device__ __forceinline__ void consume(int nitems, Work work) {
  for (int item = 0; item < nitems; ++item) {
    __syncthreads();
    work(item, item % S);
    __syncthreads();
  }
}

// Bias vectors are copied to shared memory once, zero-padded to whole
// 64-channel passes: an epilogue that fetched them from device memory held
// the tensor cores up for its loads' latency.
__device__ __forceinline__ void load_bias(float* dst, const float* bias,
                                          int count, int padded, int tid,
                                          int nthr) {
  for (int i = tid; i < padded; i += nthr) dst[i] = i < count ? bias[i] : 0.f;
}

// ---- the product of one chunk ---------------------------------------------
// This thread's part of ldmatrix's addressing: which of the warp's 16 rows
// it points at, and which half of the 16 k.
__device__ __forceinline__ int ldm_row() {
  const int lane = threadIdx.x % 32;
  return (lane % 8) + 8 * ((lane / 8) % 2);
}
__device__ __forceinline__ int ldm_khalf() { return (threadIdx.x % 32) / 16; }

// acc[mt] += A_mt (64 positions x 9*KC) * B (9*KC x 64) for the warpgroup's
// MT position tiles.  `addr(p, piece)` is the shared address of 16 bytes of
// pixel p; pbase[mt] is the pixel under tap (0, 0) of the row this thread
// points ldmatrix at; row_pitch the tile's width in pixels; wstage the
// staged weight chunk.
// The 9 * KC / 16 steps (tap, 16 channels) run in batches of three: the A
// fragments of a batch are loaded, then its wgmmas started under one fence
// and one commit.  The fragments are double-buffered: a batch is loaded
// while the one before runs.
template <int KC, int MT, class Addr>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][32],
                                          const Addr& addr,
                                          const int (&pbase)[MT],
                                          int row_pitch, uint32_t wstage) {
  constexpr int KS = KC / 16, STEPS = 9 * KS, BATCH = 3;
  static_assert(STEPS % BATCH == 0, "batches");
  const int khalf = ldm_khalf();
  uint32_t a[2][BATCH][MT][4];
#pragma unroll
  for (int b0 = 0; b0 < STEPS; b0 += BATCH) {
    const int par = (b0 / BATCH) & 1;
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int tap = (b0 + i) / KS, ks = (b0 + i) % KS;
      const int shift = (tap / 3) * row_pitch + tap % 3;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma::ldmatrix_x4(a[par][i][mt],
                         addr(pbase[mt] + shift, ks * 2 + khalf));
    }
    mma::wgmma_fence();
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int tap = (b0 + i) / KS, ks = (b0 + i) % KS;
      const uint64_t desc =
          mma::wgmma_desc(wstage + (tap * KC + ks * 16) * 128, 1024);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma::wgmma_m64n64k16(acc[mt], a[par][i][mt], desc);
    }
    mma::wgmma_commit();
    mma::wgmma_wait<1>();  // the other buffer's products are done
  }
  mma::wgmma_wait<0>();
}

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][32]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[mt][e] = 0.f;
}

// ---- epilogues -------------------------------------------------------------
// v + bias, ReLU if asked, for the two neighbouring channels co, co + 1 (co
// even) an accumulator pair holds; channels >= Cout give 0.  bias: the
// zero-padded copy in shared memory.
__device__ __forceinline__ __nv_bfloat162 finish_pair(const float* bias, int co,
                                                      int Cout, float v0,
                                                      float v1, bool relu) {
  const float2 b = *reinterpret_cast<const float2*>(bias + co);
  v0 = co < Cout ? v0 + b.x : 0.f;
  v1 = co + 1 < Cout ? v1 + b.y : 0.f;
  if (relu) {
    v0 = relu_f32(v0);
    v1 = relu_f32(v1);
  }
  __nv_bfloat162 pr;
  pr.x = __float2bfloat16(v0);
  pr.y = __float2bfloat16(v1);
  return pr;
}

// Store such a pair of one output pixel straight to device memory; channels
// >= Cout are not stored.  pair_ok: out + co is 4-byte aligned.
__device__ __forceinline__ void store_pair(bf16* out, int co, int Cout,
                                           __nv_bfloat162 pr, bool pair_ok) {
  if (co >= Cout) return;
  if (co + 1 < Cout && pair_ok) {
    *reinterpret_cast<__nv_bfloat162*>(out + co) = pr;
    return;
  }
  out[co] = pr.x;
  if (co + 1 < Cout) out[co + 1] = pr.y;
}

// ---- float32 on the tensor cores: three TF32 products ----------------------
// K is walked 8 f32 channels at a time (one k8 step, 32 bytes a pixel).  The
// activations are staged by the bf16 loaders above: an f32 channel is two
// bf16 halves to them, so a window of 8 f32 channels is WindowAddr<16>'s
// 32-byte pitch, and ldmatrix_x4 on it gives the tf32 A fragment (mma.cuh).
// The weights come from the wrapper as (pass, chunk, tap, hi/lo, 64 n, 8 k)
// f32 (ops/cuda/conv3x3.py::tf32_weights): one tap of one 8-channel chunk
// is a hi and a lo B tile of 2048 bytes each, copied as they lie.
constexpr int kKC32 = 8;                 // f32 input channels per chunk
constexpr int kTileBytes32 = 64 * 32;    // one B tile: 64 n x 8 k f32
constexpr int kTapBytes32 = 2 * kTileBytes32;  // hi and lo of one tap
constexpr int kTapFloats32 = kTapBytes32 / 4;

// An f32 NHWC image (strides in f32 elements) as the bf16 loaders see it.
inline Image f32_image(const float* p, int C, long long sn, long long sh,
                       long long sw) {
  return strided_image(reinterpret_cast<const bf16*>(p), 2 * C, 2 * sn,
                       2 * sh, 2 * sw);
}

// Stage TAPS taps of one (pass, chunk) of the split weights (src: its first
// tap) at dst (256-aligned): row r of 32 bytes (tap, hi/lo, n), its piece j
// at j ^ ((r >> 2) & 1), the 32-byte swizzle of the B descriptor.
template <int TAPS, int NTHR>
__device__ __forceinline__ void load_weights_tf32(unsigned char* dst,
                                                  const float* src, int tid) {
  constexpr int PIECES = TAPS * kTapBytes32 / 16;
  static_assert(PIECES % NTHR == 0, "whole passes of the threads");
  const uint32_t d0 = mma::smem_u32(dst);
#pragma unroll
  for (int pass = 0; pass < PIECES / NTHR; ++pass) {
    const int i = tid + pass * NTHR, r = i / 2, j = i % 2;
    mma::cp_async16(d0 + r * 32 + ((j ^ ((r >> 2) & 1)) << 4), src + 4 * i,
                    true);
  }
}

// part[mt] (+)= A_mt (64 positions x TAPS * 8) * B (TAPS * 8 x 64) for the
// warpgroup's MT position tiles, three TF32 products a tap; fresh: the
// first product sets part instead (wgmma's scale-d).  Tap t reads pixel
// pbase[mt] + row_shift + (t / 3) * row_pitch + t % 3 of `addr` (pieces 0
// and 1: the chunk's 8 channels) and the hi and lo B tiles at wstage + t *
// kTapBytes32.  A tap's fragments are loaded and split while the tap
// before is multiplied (two buffers, one commit group a tap); all products
// are done on return.
// part is a partial sum over one 8-channel chunk: the caller adds it into
// its f32 total (round to nearest) chunk by chunk.  The tensor cores add
// into their accumulator by truncation, and that error, biased one way,
// grew with K (2.35e-5 of max|ref| at K = 2304 on the card when one wgmma
// accumulator took every product, 2.0e-6 so); over a chunk's 72 products
// it stays near the split's own.
// CID_TF32_NO_CORRECTION (only the CPU tests' control build defines it)
// leaves out the two correction products: one TF32 product, which must
// fail the f32 tolerance.
template <int TAPS, int MT, class Addr>
__device__ __forceinline__ void mma_taps_tf32(float (&part)[MT][32],
                                              const Addr& addr,
                                              const int (&pbase)[MT],
                                              int row_shift, int row_pitch,
                                              uint32_t wstage, bool fresh) {
  const int khalf = ldm_khalf();
  uint32_t a[2][MT][2][4];  // [buffer][tile][hi, lo][register]
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const int par = t & 1;
    const int shift = row_shift + (t / 3) * row_pitch + t % 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t raw[4];
      mma::ldmatrix_x4(raw, addr(pbase[mt] + shift, khalf));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma::tf32_split(raw[i], a[par][mt][0][i], a[par][mt][1][i]);
    }
    mma::wgmma_fence();
    const uint32_t hi = wstage + t * kTapBytes32, lo = hi + kTileBytes32;
    const bool keep = t > 0 || !fresh;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#ifdef CID_TF32_NO_CORRECTION
      mma::wgmma_m64n64k8_tf32(part[mt], a[par][mt][0],
                               mma::wgmma_desc_k32(hi), keep);
#else
      mma::wgmma_m64n64k8_tf32(part[mt], a[par][mt][1],
                               mma::wgmma_desc_k32(hi), keep);
      mma::wgmma_m64n64k8_tf32(part[mt], a[par][mt][0],
                               mma::wgmma_desc_k32(lo), true);
      mma::wgmma_m64n64k8_tf32(part[mt], a[par][mt][0],
                               mma::wgmma_desc_k32(hi), true);
#endif
    }
    mma::wgmma_commit();
    mma::wgmma_wait<1>();  // the other buffer's products are done
  }
  mma::wgmma_wait<0>();
}

// acc = part (first) or acc + part, element by element, rounded to nearest.
template <int MT>
__device__ __forceinline__ void add_part(float (&acc)[MT][32],
                                         const float (&part)[MT][32],
                                         bool first) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 32; ++e)
      acc[mt][e] = first ? part[mt][e] : acc[mt][e] + part[mt][e];
}

// v + bias, ReLU if asked, for the channel pair co, co + 1 as finish_pair,
// kept in f32.
__device__ __forceinline__ float2 finish_pair_f32(const float* bias, int co,
                                                  int Cout, float v0, float v1,
                                                  bool relu) {
  const float2 b = *reinterpret_cast<const float2*>(bias + co);
  v0 = co < Cout ? v0 + b.x : 0.f;
  v1 = co + 1 < Cout ? v1 + b.y : 0.f;
  if (relu) {
    v0 = relu_f32(v0);
    v1 = relu_f32(v1);
  }
  return make_float2(v0, v1);
}

// Store such a pair of one output pixel; channels >= Cout are not stored.
// pair_ok: out + co is 8-byte aligned.
__device__ __forceinline__ void store_pair_f32(float* out, int co, int Cout,
                                               float2 v, bool pair_ok) {
  if (co >= Cout) return;
  if (co + 1 < Cout && pair_ok) {
    *reinterpret_cast<float2*>(out + co) = v;
    return;
  }
  out[co] = v.x;
  if (co + 1 < Cout) out[co + 1] = v.y;
}

}  // namespace conv
}  // namespace cid
