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
// input channels contiguous as mma.sync's col-major B wants them; w_scale
// (Cout,) f32, bias (Cout,) bf16, s_next (Cout,) f32; y (N,2H,2W,Cout)
// dense, s8 / bf16 / raw f32 as in conv_s8.cuh.  Cin a multiple of 32, at
// most 256.
//
// What bounds it on an H100: 2 * 4 * Cout operations per input channel
// byte at up2 (1024) and up1 (512), near or above the int8 ridge point
// (about 590): the tensor cores at up2, the bytes at up1.
//
// Design, simple first: mma.sync m16n8k32; one work item = (128 input
// pixels, 64 GEMM columns) with all of K (Cin <= 256) in one stage, so a
// block meets its barriers once per tile and not once per 32 channels;
// eight warps, each one m16 position tile by eight n8 blocks; A and B by
// ldmatrix from 32-byte rows; a two-stage cp.async ring that every thread
// feeds; persistent blocks.  (The whole weight resident in shared memory,
// each input tile read once for all columns, was tried and was no faster:
// PERF.md.)

#include <cstdint>

#include "common.cuh"
#include "conv_s8.cuh"

namespace {

namespace conv = cid::conv;
namespace mma = cid::mma;
namespace s8 = cid::s8;

constexpr int kThreads = 256;
constexpr int kM = 128;  // input pixels per item (one m16 tile a warp)
constexpr int kN = 64;   // GEMM columns per item
constexpr int kChunkBytes = (kM + kN) * s8::kRowBytes;  // 32 channels
constexpr int kMaxCin = 256;  // a stage holds all of K

__global__ void __launch_bounds__(kThreads, 2)
convt2x2_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ wscale,
                   const conv::bf16* __restrict__ bias,
                   const float* __restrict__ snext, void* __restrict__ y,
                   long long pixels, int H, int W, int Cin, int Cout,
                   int mode, int mtiles, int ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_s8[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int ncols = 4 * Cout;
  const int nchunks = Cin / s8::kKC;
  const int stage_bytes = nchunks * kChunkBytes;
  const long long units = (long long)mtiles * ntiles;
  const long long nitems =
      (units - (long long)blockIdx.x + gridDim.x - 1) / gridDim.x;

  const int padded = (Cout + 7) / 8 * 8;
  float* cbuf = reinterpret_cast<float*>(smem_s8 + 2 * stage_bytes);
  const s8::Consts k{cbuf, cbuf + padded, cbuf + 2 * padded};
  s8::load_consts(k, wscale, bias, snext, Cout, padded, tid, kThreads);

  // item = one (128-pixel, 64-column) output tile with all of K: chunk c of
  // a stage holds 128 A rows then 64 B rows of 32 channels each
  auto unit_of = [&](long long item) {
    return (long long)blockIdx.x + item * (long long)gridDim.x;
  };
  auto fill = [&](long long item, int stage) {
    const long long u = unit_of(item);
    const long long m0 = (u / ntiles) * kM;
    const int n0 = (int)(u % ntiles) * kN;
    const uint32_t st = mma::smem_u32(smem_s8 + stage * stage_bytes);
    for (int i = tid; i < nchunks * (kM + kN) * 2; i += kThreads) {
      const int c = i / ((kM + kN) * 2), r = (i / 2) % (kM + kN), j = i % 2;
      const int c0 = c * s8::kKC + 16 * j;
      bool ok;
      const int8_t* src;
      if (r < kM) {
        ok = m0 + r < pixels;
        src = ok ? x + (m0 + r) * Cin + c0 : x;
      } else {
        ok = n0 + (r - kM) < ncols;
        src = ok ? w + (long long)(n0 + r - kM) * Cin + c0 : w;
      }
      mma::cp_async16(s8::row_addr(st + c * kChunkBytes, r, j), src, ok);
    }
  };

  int acc[8][4];
  if (nitems > 0) fill(0, 0);
  mma::cp_async_commit();
  for (long long item = 0; item < nitems; ++item) {
    const int stage = (int)(item & 1);
    if (item + 1 < nitems) fill(item + 1, stage ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0;
    const uint32_t st0 = mma::smem_u32(smem_s8 + stage * stage_bytes);
    for (int c = 0; c < nchunks; ++c) {
      const uint32_t st = st0 + c * kChunkBytes;
      uint32_t a[4];
      mma::ldmatrix_x4(a, s8::row_addr(st, warp * 16 + conv::ldm_row(),
                                       conv::ldm_khalf()));
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t b4[4];
        mma::ldmatrix_x4(b4, s8::row_addr(st, kM + nb * 8 + s8::b_row(),
                                          s8::b_piece()));
        const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
        mma::mma_m16n8k32_s8(acc[nb], a, b0);
        mma::mma_m16n8k32_s8(acc[nb + 1], a, b1);
      }
    }
    const long long u = unit_of(item);
    const long long m0 = (u / ntiles) * kM;
    const int n0 = (int)(u % ntiles) * kN;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long p = m0 + warp * 16 + g + 8 * hf;
      if (p >= pixels) continue;
      const long long img = p / ((long long)H * W);
      const int rem = (int)(p % ((long long)H * W));
      const int i = rem / W, jx = rem % W;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int col = n0 + nb * 8 + 2 * q;  // even; Cout is even
        if (col >= ncols) continue;
        const int ab = col / Cout, co = col % Cout;
        const long long off =
            ((img * 2 * H + 2 * i + ab / 2) * 2 * W + 2 * jx + ab % 2) *
            (long long)Cout;
        s8::store_pair(y, off, co, Cout, acc[nb][2 * hf],
                       acc[nb][2 * hf + 1], k, mode, false, true);
      }
    }
    __syncthreads();
  }
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
      cout < 2 || cout % 2 != 0 || !conv::aligned16(x) ||
      !conv::aligned16(w) || mode < 0 || mode > 2 ||
      (mode != s8::kOutF32 && bias == nullptr) ||
      (mode == s8::kOutS8 && snext == nullptr) ||
      (long long)h * wd > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)n * h * wd;
  const long long mtiles = (pixels + kM - 1) / kM;
  const int ntiles = (4 * cout + kN - 1) / kN;
  const int smem = 2 * (cin / s8::kKC) * kChunkBytes +
                   3 * ((cout + 7) / 8 * 8) * 4;
  if (smem > conv::kMaxSmem || mtiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      convt2x2_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = conv::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long units = mtiles * ntiles;
  const unsigned grid = (unsigned)(units < 2 * sms ? units : 2 * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  convt2x2_s8_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(wscale), static_cast<const conv::bf16*>(bias),
      static_cast<const float*>(snext), y, pixels, h, wd, cin, cout, mode,
      (int)mtiles, ntiles);
  return (int)cudaGetLastError();
}
