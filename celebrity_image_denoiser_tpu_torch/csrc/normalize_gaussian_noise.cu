// Fused uint8 -> [-1, 1] normalisation with additive Gaussian noise.
//
// Replaces:
//   celebrity_image_denoiser_tpu/ops/pallas/noise_kernel.py::fused_normalize_gaussian_noise (:46)
// which is the training input stage: for every element of a uint8 NHWC
// batch,
//   out = clip(x * (1/255) + (sigma / 255) * n, 0, 1) * 2 - 1,  n ~ N(0, 1),
// one read of a byte and one write of a float or bfloat16, nothing else in
// device memory.  The normal is a Box-Muller transform of two 24-bit
// uniforms, u1 in (0, 1] and u2 in [0, 1), as in the Pallas body (:33-38).
//
// Random bits.  The TPU kernel reads its core's hardware generator, whose
// stream no other machine can reproduce.  Here the bits come from
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), written out below so that the plain PyTorch version in
// ops/cuda/noise.py can reproduce the stream bit for bit:
//   * i is the flat element index over the whole tensor, 64 bits;
//   * counter = (lo32(i >> 1), hi32(i >> 1), 0, 0), key = (lo32(seed),
//     hi32(seed));
//   * an even i takes output words 0, 1 as (a, b), an odd i words 2, 3;
//   * u1 = (a >> 8) * 2^-24 + 2^-25,  u2 = (b >> 8) * 2^-24;
//   * n = sqrt(-2 ln u1) * cos(2 pi u2).
// So the output depends on (seed, index) only, never on the launch grid:
// the same (seed, shape) gives the same tensor, as the original promises.
// Every float operation that the compiler could contract into an FMA is
// written with a round-to-nearest intrinsic, so the arithmetic is the
// plain version's, operation for operation.
//
// What bounds it on an H100: bytes (1 read + 2 or 4 written per element);
// at the training batch (16 x 256 x 256 x 3) that is microseconds, below
// the cost of a launch.  The design is therefore plain: a thread owns 16
// consecutive elements (one 16-byte load, eight Philox blocks, two or four
// 16-byte stores); the last, partial chunk and unaligned tensors take a
// scalar loop over the same indices.  None of the Pallas version's VMEM
// matters (one image per grid step, (rows, 128) lanes, a padded tail) is
// carried over.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // elements per thread

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kW0;  // the key is bumped between rounds; the last bump is unused
    k1 += kW1;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// Box-Muller on the top 24 bits of a and b.
__device__ __forceinline__ float normal_from_bits(uint32_t a, uint32_t b) {
  const float u1 = __fadd_rn(
      __fmul_rn((float)(a >> 8), 1.0f / 16777216.0f), 1.0f / 33554432.0f);
  const float u2 = __fmul_rn((float)(b >> 8), 1.0f / 16777216.0f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
}

__device__ __forceinline__ float transform(uint8_t x, float sigma01, float n) {
  const float x01 = __fmul_rn((float)x, 0.00392156862745098f);  // 1/255
  float v = __fadd_rn(x01, __fmul_rn(sigma01, n));
  v = fminf(fmaxf(v, 0.0f), 1.0f);
  return __fadd_rn(__fmul_rn(v, 2.0f), -1.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
normalize_gaussian_noise_kernel(const uint8_t* __restrict__ x,
                                T* __restrict__ y, long long total,
                                uint32_t k0, uint32_t k1, float sigma01,
                                int aligned) {
  const long long chunk =
      (long long)blockIdx.x * kThreads + (long long)threadIdx.x;
  const long long i0 = chunk * kChunk;  // even, so pairs never straddle
  if (i0 >= total) return;

  if (aligned && i0 + kChunk <= total) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + i0);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    float out[kChunk];
#pragma unroll
    for (int p = 0; p < kChunk / 2; ++p) {
      const unsigned long long pair = (unsigned long long)(i0 >> 1) + p;
      const Philox4 r = philox4x32_10((uint32_t)pair, (uint32_t)(pair >> 32),
                                      0u, 0u, k0, k1);
      const uint32_t word = words[p / 2];
      const uint8_t xe = (uint8_t)(word >> ((p % 2) * 16));
      const uint8_t xo = (uint8_t)(word >> ((p % 2) * 16 + 8));
      out[2 * p] = transform(xe, sigma01, normal_from_bits(r.w[0], r.w[1]));
      out[2 * p + 1] =
          transform(xo, sigma01, normal_from_bits(r.w[2], r.w[3]));
    }
    __align__(16) T vals[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) vals[j] = cid::from_f32<T>(out[j]);
    constexpr int kStores = kChunk * (int)sizeof(T) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(vals);
    uint4* dst = reinterpret_cast<uint4*>(y + i0);
#pragma unroll
    for (int s = 0; s < kStores; ++s) dst[s] = src[s];
    return;
  }

  const long long end = i0 + kChunk < total ? i0 + kChunk : total;
  for (long long i = i0; i < end; ++i) {
    const unsigned long long pair = (unsigned long long)i >> 1;
    const Philox4 r = philox4x32_10((uint32_t)pair, (uint32_t)(pair >> 32), 0u,
                                    0u, k0, k1);
    const float n = (i & 1) ? normal_from_bits(r.w[2], r.w[3])
                            : normal_from_bits(r.w[0], r.w[1]);
    y[i] = cid::from_f32<T>(transform(x[i], sigma01, n));
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long total,
                   unsigned long long seed, float sigma01,
                   cudaStream_t stream) {
  const long long chunks = (total + kChunk - 1) / kChunk;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  if (!cid::grid_fits(blocks)) return cudaErrorInvalidConfiguration;
  const int aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0)
                          ? 1
                          : 0;
  normalize_gaussian_noise_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<T*>(y), total,
      (uint32_t)seed, (uint32_t)(seed >> 32), sigma01, aligned);
  return cudaGetLastError();
}

}  // namespace

// x: `total` uint8 values; y: `total` values of `dtype` (common.cuh codes).
extern "C" int cid_normalize_gaussian_noise(const void* x, void* y,
                                            long long total,
                                            unsigned long long seed,
                                            float sigma01, int dtype,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == cid::kDtypeF32)
    return (int)launch<float>(x, y, total, seed, sigma01, s);
  if (dtype == cid::kDtypeBF16)
    return (int)launch<__nv_bfloat16>(x, y, total, seed, sigma01, s);
  return (int)cudaErrorInvalidValue;
}
