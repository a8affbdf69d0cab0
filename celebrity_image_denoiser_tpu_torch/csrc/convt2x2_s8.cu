// 2x2 stride-2 transpose convolution, s8 x s8 -> s32, with the s8 program's
// epilogue (K6 of the port).
//
// No TPU kernel: the JAX package computes it in XLA
// (celebrity_image_denoiser_tpu/ops/quant_unet.py::_convt_q:62, a
// fractionally-strided conv with the kernel flipped and its channel axes
// swapped, and the generic transform's replay of ops/conv.py::
// conv2d_transpose).  For a 2x2 kernel at stride 2 that conv touches each
// input pixel once per output pixel of its 2x2 block:
//   y[n, 2i+a, 2j+b, co] = sum_ci x[n, i, j, ci] * W[a, b, co, ci],
// with W the layer's (kH, kW, Cout, Cin) kernel as the JAX package holds
// it, so the op is one GEMM [N*H*W, Cin] x [Cin, 4*Cout] whose columns
// scatter to the 2x2 blocks.  It carries the U-Net's up2 (256 -> 128) and
// up1 (128 -> 64).
//
// Layout: x (N,H,W,Cin) s8 dense; W (2,2,Cout,Cin) s8, i.e. [4*Cout][Cin],
// input channels contiguous: the K-major B that the s8 wgmma takes; w_scale
// (Cout,) f32, bias (Cout,) bf16, s_next (Cout,) f32; y (N,2H,2W,Cout)
// dense, s8 / bf16 / raw f32 as in conv_s8.cuh.  Cin a multiple of 32, at
// most 256.
//
// What bounds it on an H100: 2 * 4 * Cout operations per input channel
// byte at up2 (1024) and up1 (512), near or above the int8 ridge point
// (about 590): the tensor cores at up2, the bytes at up1.
//
// Design: the GEMM reads each operand once.  A persistent block keeps the
// whole weight in shared memory (131,072 bytes at up2, 32,768 at up1,
// copied with its first tile) and walks 128-pixel tiles of A, each copied
// once (all of K, up to 32 KB) through a two-stage cp.async ring by two
// producer warpgroups.  Two consumer warpgroups each own 64 pixels: they
// load the tile's A fragments for all of K once (ldmatrix_x4, 32-byte
// swizzled rows) and sweep the 4 * Cout columns 64 at a time with the s8
// wgmma m64n64k32, B read from the resident K-major weight rows by
// descriptor.  Two accumulator sets alternate, so the epilogue of one
// column block runs while the tensor cores compute the next.  The epilogue
// (conv_s8.cuh) stages a warp's 16 pixels x 64 columns in shared memory
// and writes them as 16-byte chunks of contiguous runs: where Cout is a
// multiple of 64 a column block is one (a, b) output pixel's 64-channel
// run.  Other Cout, and the raw f32 product, are stored from the fragments.

#include <cstdint>

#include "common.cuh"
#include "conv_s8.cuh"

namespace {

namespace conv = cid::conv;
namespace mma = cid::mma;
namespace s8 = cid::s8;

constexpr int kM = 128;      // pixels per tile: 64 per consumer warpgroup
constexpr int kNB = 64;      // GEMM columns per wgmma
constexpr int kStages = 2;   // A ring
constexpr int kMaxCin = 256;  // a tile's A fragments cover all of K
constexpr int kMaxChunks = kMaxCin / s8::kKC;
template <int ES>
using WarpStaging = s8::Staging<ES, 16>;  // a warp's 16 pixels x 64 columns
constexpr int kOffBytes = 16 * 8;          // and their output offsets
__host__ __device__ constexpr int warp_bytes(int mode) {
  return kOffBytes + (mode == s8::kOutS8     ? WarpStaging<1>::kBytes
                      : mode == s8::kOutBF16 ? WarpStaging<2>::kBytes
                                             : 0);
}
__host__ __device__ constexpr int col_blocks(int cout) {
  return (4 * cout + kNB - 1) / kNB;
}
__host__ __device__ constexpr int smem_bytes(int cin, int cout, int mode) {
  return cin * col_blocks(cout) * kNB + kStages * kM * cin +
         8 * warp_bytes(mode) + s8::consts_bytes((cout + 7) / 8 * 8);
}

// acc = the warpgroup's 64 pixels x columns [64 nb, +64): A from the
// fragments a, B from the resident weights (chunk c at wbase + c * wchunk)
__device__ __forceinline__ void issue(int (&acc)[32],
                                      const uint32_t (&a)[kMaxChunks][4],
                                      int nchunks, uint32_t wbase,
                                      int wchunk, int nb) {
  mma::wgmma_fence();
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
    if (c < nchunks)
      mma::wgmma_m64n64k32_s8(
          acc, a[c],
          mma::wgmma_desc_k32(wbase + c * wchunk + nb * kNB * s8::kRowBytes),
          c > 0);
  mma::wgmma_commit();
}

// Column block nb of a warp's 16 pixels, whose output offsets (element of
// the (a, b) = (0, 0) pixel's channel 0; -1 beyond the last pixel) lie at
// off.
template <int ES>
__device__ __forceinline__ void epilogue(const int (&acc)[32],
                                         const s8::Consts& k,
                                         unsigned char* buf,
                                         const long long* off, int nb,
                                         int W, int Cout, int mode, void* y) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int ncols = 4 * Cout;
  const int col0 = nb * kNB, ab0 = col0 / Cout, co0 = col0 - ab0 * Cout;
  if (ES == 0 || Cout % kNB != 0) {  // from the fragments
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long o = off[g + 8 * hf];
      if (o < 0) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (col0 + 8 * i + 2 * q >= ncols) continue;
        int ab = ab0, co = co0 + 8 * i + 2 * q;
        while (co >= Cout) {
          co -= Cout;
          ++ab;
        }
        s8::store_pair(y, o + ((ab / 2) * 2 * (long long)W + ab % 2) * Cout,
                       co, Cout, acc[4 * i + 2 * hf], acc[4 * i + 2 * hf + 1],
                       k, mode, false, true);
      }
    }
    return;
  }
  // one (a, b) and a 64-channel run [co0, co0 + 64) of each pixel
  const WarpStaging<ES == 0 ? 1 : ES> stg{buf};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * i + 2 * q;
    const s8::Pair kc = s8::pair_at(k, co0 + c);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float h0, h1;
      s8::dequant2(acc[4 * i + 2 * hf], acc[4 * i + 2 * hf + 1], kc, false,
                   h0, h1);
      stg.put(g + 8 * hf, c,
              ES == 1 ? s8::quantize2(h0, h1, kc) : s8::pack_bf16x2(h0, h1));
    }
  }
  mma::warp_sync();
  const long long run = ((ab0 / 2) * 2 * (long long)W + ab0 % 2) * Cout + co0;
  stg.flush(kNB, (Cout * ES) % 16 == 0, [&](int p) -> unsigned char* {
    return off[p] < 0 ? nullptr
                      : static_cast<unsigned char*>(y) + (off[p] + run) * ES;
  });
  mma::warp_sync();
}

__global__ void __launch_bounds__(conv::kThreads, 1)
convt2x2_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ wscale,
                   const conv::bf16* __restrict__ bias,
                   const float* __restrict__ snext, void* __restrict__ y,
                   long long pixels, int H, int W, int Cin, int Cout,
                   int mode, int mtiles) {
  extern __shared__ __align__(1024) unsigned char smem_s8[];
  const int tid = threadIdx.x;
  const int nchunks = Cin / s8::kKC;
  const int ncols = 4 * Cout, ncb = col_blocks(Cout);
  const int wchunk = ncb * kNB * s8::kRowBytes;  // weight bytes of a chunk
  const int sbytes = nchunks * kM * s8::kRowBytes;  // an A stage
  unsigned char* wres = smem_s8;            // [chunk][column][32 bytes]
  unsigned char* xst = wres + nchunks * wchunk;  // [stage][chunk][pixel][32]
  unsigned char* outs = xst + kStages * sbytes;  // [8 warps][warp_bytes]
  const int padded = (Cout + 7) / 8 * 8;
  const s8::Consts k = s8::consts_at(outs + 8 * warp_bytes(mode), padded);
  s8::load_consts(k, wscale, bias, snext, Cout, padded, tid, conv::kThreads);
  const int nitems =
      (mtiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (tid >= conv::kConsumers) {
    mma::setmaxnreg_dec<conv::kProducerRegs>();
    const int ptid = tid - conv::kConsumers;
    const int pieces = Cin / 16;  // 16-byte pieces of a pixel or weight row
    conv::produce<kStages>(nitems, [&](int item, int stage) {
      const long long m0 =
          ((long long)blockIdx.x + (long long)item * gridDim.x) * kM;
      const uint32_t st = mma::smem_u32(xst + stage * sbytes);
      // neighbouring threads copy neighbouring pieces of a pixel's row
      for (int i = ptid; i < kM * pieces; i += conv::kProducers) {
        const int r = i / pieces, pc = i % pieces;
        const bool ok = m0 + r < pixels;
        const int8_t* src = ok ? x + (m0 + r) * Cin + 16 * pc : x;
        mma::cp_async16(
            s8::row_addr(st + (pc / 2) * kM * s8::kRowBytes, r, pc % 2), src,
            ok);
      }
      if (item == 0) {  // the whole weight, which stays
        const uint32_t wst = mma::smem_u32(wres);
        for (int i = ptid; i < ncb * kNB * pieces; i += conv::kProducers) {
          const int r = i / pieces, pc = i % pieces;
          const bool ok = r < ncols;
          const int8_t* src = ok ? w + (long long)r * Cin + 16 * pc : w;
          mma::cp_async16(s8::row_addr(wst + (pc / 2) * wchunk, r, pc % 2),
                          src, ok);
        }
      }
    });
    return;
  }
  mma::setmaxnreg_inc<conv::kConsumerRegs>();
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  unsigned char* wbuf = outs + (tid / 32) * warp_bytes(mode);
  long long* off = reinterpret_cast<long long*>(wbuf);
  unsigned char* buf = wbuf + kOffBytes;
  const uint32_t wbase = mma::smem_u32(wres);
  const long long hw = (long long)H * W;

  uint32_t a[kMaxChunks][4];
  int acc0[32], acc1[32];
  conv::consume<kStages>(nitems, [&](int item, int stage) {
    const long long m0 =
        ((long long)blockIdx.x + (long long)item * gridDim.x) * kM;
    const long long pw = m0 + wg * 64 + warp * 16;  // the warp's first pixel
    if (lane < 16) {
      const long long p = pw + lane;
      long long o = -1;
      if (p < pixels) {
        const long long img = p / hw;
        const int rem = (int)(p - img * hw), i = rem / W, jx = rem % W;
        o = ((img * 2 * H + 2 * i) * 2 * W + 2 * jx) * (long long)Cout;
      }
      off[lane] = o;
    }
    const uint32_t st = mma::smem_u32(xst + stage * sbytes);
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c)
      if (c < nchunks)
        mma::ldmatrix_x4(a[c],
                         s8::row_addr(st + c * kM * s8::kRowBytes,
                                      wg * 64 + warp * 16 + conv::ldm_row(),
                                      conv::ldm_khalf()));
    mma::warp_sync();  // the offsets are written
    auto finish = [&](const int (&acc)[32], int nb) {
      if (mode == s8::kOutS8)
        epilogue<1>(acc, k, buf, off, nb, W, Cout, mode, y);
      else if (mode == s8::kOutBF16)
        epilogue<2>(acc, k, buf, off, nb, W, Cout, mode, y);
      else
        epilogue<0>(acc, k, buf, off, nb, W, Cout, mode, y);
    };
    for (int nb = 0; nb < ncb; ++nb) {
      if (nb % 2 == 0)
        issue(acc0, a, nchunks, wbase, wchunk, nb);
      else
        issue(acc1, a, nchunks, wbase, wchunk, nb);
      if (nb > 0) {
        mma::wgmma_wait<1>();  // column block nb - 1 is done
        if (nb % 2 == 0)
          finish(acc1, nb - 1);
        else
          finish(acc0, nb - 1);
      }
    }
    mma::wgmma_wait<0>();
    if ((ncb - 1) % 2 == 0)
      finish(acc0, ncb - 1);
    else
      finish(acc1, ncb - 1);
    mma::warp_sync();  // the offsets are read
  });
}

}  // namespace

// mode: 0 s8 out at s_next, 1 bf16 out, 2 the raw f32 product.
extern "C" int cid_convt2x2_s8(const void* x, const void* w,
                               const void* wscale, const void* bias,
                               const void* snext, void* y, int n, int h,
                               int wd, int cin, int cout, int mode,
                               void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cin % s8::kKC != 0 ||
      cin > kMaxCin ||
      cout < 2 || cout % 2 != 0 || !conv::aligned16(x) || !conv::aligned16(y) ||
      !conv::aligned16(w) || mode < 0 || mode > 2 ||
      (mode != s8::kOutF32 && bias == nullptr) ||
      (mode == s8::kOutS8 && snext == nullptr) ||
      (long long)h * wd > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)n * h * wd;
  const long long mtiles = (pixels + kM - 1) / kM;
  const int smem = smem_bytes(cin, cout, mode);
  if (smem > conv::kMaxSmem || mtiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      convt2x2_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = conv::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(mtiles < sms ? mtiles : sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  convt2x2_s8_kernel<<<grid, conv::kThreads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(wscale), static_cast<const conv::bf16*>(bias),
      static_cast<const float*>(snext), y, pixels, h, wd, cin, cout, mode,
      (int)mtiles);
  return (int)cudaGetLastError();
}
