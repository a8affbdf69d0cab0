// Probes of mma.cuh: each computes one small matrix product through the
// wrappers exactly as the conv kernels use them (cp.async into the swizzled
// shared-memory layouts of conv_mma.cuh and conv_s8.cuh, ldmatrix, then
// mma.sync in bf16 or s8, or wgmma in bf16, s8 or tf32)
// and writes the result out by the documented fragment layout.  The CPU
// tests run them under the g++ emulation and chip_smoke.py runs them on the
// card, both against a plain product, so the emulation's layouts are held
// to the hardware's.  A last probe runs the s8 epilogue's quantization
// (conv_s8.cuh) over given values and scales, to be held against the IEEE
// division it stands for.

#include <cstdint>

#include "common.cuh"
#include "conv_mma.cuh"
#include "conv_s8.cuh"

namespace {

using cid::conv::bf16;
namespace conv = cid::conv;
namespace mma = cid::mma;

// d (16x8) = a (16x16, row-major) * b (16x8, [k][n]); one warp.
__global__ void probe_mma_sync_kernel(const bf16* __restrict__ a,
                                      const bf16* __restrict__ b,
                                      float* __restrict__ d) {
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  const int lane = threadIdx.x, g = lane / 4, q = lane % 4;
  const conv::WindowAddr<16> addr{mma::smem_u32(smem_mma)};
  mma::cp_async16(addr(lane / 2, lane % 2), a + (lane / 2) * 16 + (lane % 2) * 8,
                  true);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t fa[4];
  mma::ldmatrix_x4(fa, addr(conv::ldm_row(), conv::ldm_khalf()));
  uint32_t fb[2];
  for (int i = 0; i < 2; ++i) {
    const int k = 2 * q + 8 * i;
    __nv_bfloat162 pr;
    pr.x = b[k * 8 + g];
    pr.y = b[(k + 1) * 8 + g];
    fb[i] = *reinterpret_cast<uint32_t*>(&pr);
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  mma::mma_m16n8k16(acc, fa, fb);
  for (int e = 0; e < 4; ++e)
    d[(g + 8 * (e / 2)) * 8 + 2 * q + e % 2] = acc[e];
}

// d (64x64) = a (64 x 16*ksteps, row-major) * b (16*ksteps x 64, [k][n]);
// one warpgroup, ksteps <= 4.
__global__ void probe_wgmma_kernel(const bf16* __restrict__ a,
                                   const bf16* __restrict__ b,
                                   float* __restrict__ d, int ksteps) {
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  unsigned char* bs = smem_mma;             // 64 rows of 128 bytes
  unsigned char* as = smem_mma + 64 * 128;  // 64 pixels of 128 bytes
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int K = 16 * ksteps;
  const conv::WindowAddr<64> addr{mma::smem_u32(as)};
  const uint32_t b0 = mma::smem_u32(bs);
  for (int i = tid; i < 64 * 8; i += 128) {
    const int r = i / 8, j = i % 8;
    mma::cp_async16(addr(r, j), 8 * j < K ? a + r * K + 8 * j : a, 8 * j < K);
    mma::cp_async16(b0 + r * 128 + ((j ^ (r & 7)) << 4),
                    r < K ? b + r * 64 + 8 * j : b, r < K);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  float acc[32];
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t fa[4];
    mma::ldmatrix_x4(fa, addr(warp * 16 + conv::ldm_row(),
                              ks * 2 + conv::ldm_khalf()));
    mma::wgmma_fence();
    mma::wgmma_m64n64k16(acc, fa, mma::wgmma_desc(b0 + ks * 16 * 128, 1024));
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
  }
  for (int e = 0; e < 32; ++e) {
    const int row = warp * 16 + lane / 4 + 8 * ((e % 4) / 2);
    const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
    d[row * 64 + col] = acc[e];
  }
}

// s8: d (16 x 24 s32) = a (16 x 32, row-major) * b^T with b (16 x 32) given
// as the kernels stage weights, [n][k]; columns 0..15 through ldmatrix_x4
// (two n8 blocks, as the conv kernels load B), columns 16..23 again n8
// block 1 through ldmatrix_x2 (the Cout <= 8 path).  32-byte rows, swizzled
// as conv_s8.cuh lays them out; one warp.
__global__ void probe_mma_s8_kernel(const int8_t* __restrict__ a,
                                    const int8_t* __restrict__ b,
                                    int* __restrict__ d) {
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  namespace s8 = cid::s8;
  const int lane = threadIdx.x, g = lane / 4, q = lane % 4;
  const uint32_t as = mma::smem_u32(smem_mma), bs = as + 16 * 32;
  mma::cp_async16(s8::row_addr(as, lane / 2, lane % 2), a + lane * 16, true);
  mma::cp_async16(s8::row_addr(bs, lane / 2, lane % 2), b + lane * 16, true);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t fa[4], b4[4], b2[2];
  mma::ldmatrix_x4(fa, s8::row_addr(as, conv::ldm_row(), conv::ldm_khalf()));
  mma::ldmatrix_x4(b4, s8::row_addr(bs, s8::b_row(), s8::b_piece()));
  mma::ldmatrix_x2(b2, s8::row_addr(bs, 8 + lane % 8, s8::b_piece()));
  int acc[3][4] = {};
  const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
  mma::mma_m16n8k32_s8(acc[0], fa, b0);
  mma::mma_m16n8k32_s8(acc[1], fa, b1);
  mma::mma_m16n8k32_s8(acc[2], fa, b2);
  for (int nb = 0; nb < 3; ++nb)
    for (int e = 0; e < 4; ++e)
      d[(g + 8 * (e / 2)) * 24 + nb * 8 + 2 * q + e % 2] = acc[nb][e];
}

// s8 wgmma: d (64 x 64 s32) = a (64 x 32*ksteps, row-major) * b^T, b (64 x
// 32*ksteps) given as the kernels stage weights, [n][k]: A by ldmatrix_x4
// from 32-byte swizzled pixel rows, B as K-major 32-byte swizzled rows by
// descriptor, one k32 step (2048 bytes of B) at a time; one warpgroup,
// ksteps <= 4.
__global__ void probe_wgmma_s8_kernel(const int8_t* __restrict__ a,
                                      const int8_t* __restrict__ b,
                                      int* __restrict__ d, int ksteps) {
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  namespace s8 = cid::s8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int K = 32 * ksteps;
  const uint32_t bs = mma::smem_u32(smem_mma);  // [ks][64 n][32]
  const uint32_t as = bs + 4 * 2048;            // [ks][64 rows][32]
  for (int i = tid; i < 64 * 2 * ksteps; i += 128) {
    const int ks = i / 128, r = (i / 2) % 64, j = i % 2;
    mma::cp_async16(s8::row_addr(as + ks * 2048, r, j),
                    a + r * K + ks * 32 + 16 * j, true);
    mma::cp_async16(s8::row_addr(bs + ks * 2048, r, j),
                    b + r * K + ks * 32 + 16 * j, true);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  int acc[32];
  for (int e = 0; e < 32; ++e) acc[e] = -7;  // overwritten by the first step
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t fa[4];
    mma::ldmatrix_x4(fa, s8::row_addr(as + ks * 2048,
                                      warp * 16 + conv::ldm_row(),
                                      conv::ldm_khalf()));
    mma::wgmma_fence();
    mma::wgmma_m64n64k32_s8(acc, fa, mma::wgmma_desc_k32(bs + ks * 2048),
                            ks > 0);
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
  }
  for (int e = 0; e < 32; ++e) {
    const int row = warp * 16 + lane / 4 + 8 * ((e % 4) / 2);
    const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
    d[row * 64 + col] = acc[e];
  }
}

// tf32 wgmma: d (64 x 64) = a (64 x 8*ksteps, row-major) * b^T, b (64 x
// 8*ksteps) given as the f32 kernels stage weights, [n][k]; both f32 as they
// are, of which the tensor cores read the upper 19 bits.  A by ldmatrix_x4
// from 32-byte swizzled pixel rows (the f32 window's layout), B as the
// K-major 32-byte swizzled tile by descriptor, one k8 step (2048 bytes of
// each) at a time, the first overwriting the accumulators; one warpgroup,
// ksteps <= 4.
__global__ void probe_wgmma_tf32_kernel(const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        float* __restrict__ d, int ksteps) {
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int K = 8 * ksteps;
  const uint32_t bs = mma::smem_u32(smem_mma);  // [ks][64 n][32 bytes]
  const uint32_t as = bs + 4 * 2048;            // [ks][64 rows][32 bytes]
  for (int i = tid; i < 64 * 2 * ksteps; i += 128) {
    const int ks = i / 128, r = (i / 2) % 64, j = i % 2;
    const uint32_t at = ks * 2048 + r * 32 + ((j ^ ((r >> 2) & 1)) << 4);
    mma::cp_async16(as + at, a + r * K + ks * 8 + 4 * j, true);
    mma::cp_async16(bs + at, b + r * K + ks * 8 + 4 * j, true);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  float acc[32];
  for (int e = 0; e < 32; ++e) acc[e] = -7.f;  // overwritten by the first step
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t fa[4];
    mma::ldmatrix_x4(fa, conv::WindowAddr<16>{as + ks * 2048}(
                             warp * 16 + conv::ldm_row(), conv::ldm_khalf()));
    mma::wgmma_fence();
    mma::wgmma_m64n64k8_tf32(acc, fa, mma::wgmma_desc_k32(bs + ks * 2048),
                             ks > 0);
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
  }
  for (int e = 0; e < 32; ++e) {
    const int row = warp * 16 + lane / 4 + 8 * ((e % 4) / 2);
    const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
    d[row * 64 + col] = acc[e];
  }
}

// hi[i], lo[i] = mma.cuh's split of v[i] into two tf32 values
constexpr int kSplitThreads = 256;
__global__ void probe_tf32_split_kernel(const uint32_t* __restrict__ v,
                                        long long n, uint32_t* __restrict__ hi,
                                        uint32_t* __restrict__ lo) {
  for (long long i = (long long)blockIdx.x * kSplitThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kSplitThreads)
    mma::tf32_split(v[i], hi[i], lo[i]);
}

// out[j * nh + i] = the s8 epilogue's quantization of h[i] at scale s[j]
constexpr int kQuantizeThreads = 256;
__global__ void probe_quantize_kernel(const float* __restrict__ h, int nh,
                                      const float* __restrict__ s, int ns,
                                      int8_t* __restrict__ out) {
  namespace s8 = cid::s8;
  const long long total = (long long)nh * ns;
  for (long long i = (long long)blockIdx.x * kQuantizeThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kQuantizeThreads) {
    out[i] = s8::quantize(h[i % nh], s8::qscale_of(s[i / nh]));
  }
}

}  // namespace

extern "C" int cid_probe_wgmma_s8(const void* a, const void* b, void* d,
                                  int ksteps, void* stream) {
  if (ksteps < 1 || ksteps > 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_wgmma_s8_kernel<<<1, 128, 8 * 2048, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int*>(d), ksteps);
  return (int)cudaGetLastError();
}

extern "C" int cid_probe_quantize(const void* h, int nh, const void* sc,
                                  int ns, void* out, void* stream) {
  if (nh < 1 || ns < 1) return (int)cudaErrorInvalidValue;
  const int sms = cid::conv::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_quantize_kernel<<<4 * sms, kQuantizeThreads, 0, s>>>(
      static_cast<const float*>(h), nh, static_cast<const float*>(sc), ns,
      static_cast<int8_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int cid_probe_mma_s8(const void* a, const void* b, void* d,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_mma_s8_kernel<<<1, 32, 1024, s>>>(static_cast<const int8_t*>(a),
                                          static_cast<const int8_t*>(b),
                                          static_cast<int*>(d));
  return (int)cudaGetLastError();
}

extern "C" int cid_probe_mma_sync(const void* a, const void* b, void* d,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_mma_sync_kernel<<<1, 32, 1024, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(d));
  return (int)cudaGetLastError();
}

extern "C" int cid_probe_wgmma(const void* a, const void* b, void* d,
                               int ksteps, void* stream) {
  if (ksteps < 1 || ksteps > 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_wgmma_kernel<<<1, 128, 2 * 64 * 128, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(d), ksteps);
  return (int)cudaGetLastError();
}

extern "C" int cid_probe_wgmma_tf32(const void* a, const void* b, void* d,
                                    int ksteps, void* stream) {
  if (ksteps < 1 || ksteps > 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_wgmma_tf32_kernel<<<1, 128, 8 * 2048, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(d), ksteps);
  return (int)cudaGetLastError();
}

extern "C" int cid_probe_tf32_split(const void* v, long long n, void* hi,
                                    void* lo, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_tf32_split_kernel<<<64, kSplitThreads, 0, s>>>(
      static_cast<const uint32_t*>(v), n, static_cast<uint32_t*>(hi),
      static_cast<uint32_t*>(lo));
  return (int)cudaGetLastError();
}
