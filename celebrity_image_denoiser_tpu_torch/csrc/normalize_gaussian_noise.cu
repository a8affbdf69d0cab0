// The training input stage in one launch: a uint8 NHWC batch in, its noisy
// version and its clean target out, both float32 in [-1, 1].
//
// Replaces:
//   celebrity_image_denoiser_tpu/ops/pallas/noise_kernel.py::fused_normalize_gaussian_noise (:46)
// (uint8 -> clip(x / 255 + (sigma / 255) n, 0, 1) * 2 - 1 with n ~ N(0, 1))
// and, around it, the rest of the JAX package's on-the-fly input stage,
// celebrity_image_denoiser_tpu/data/noise.py::random_noise_batch (:207-229):
// one compiled program in which every sample takes the noise kind it drew
// (vmap + lax.switch), and the trainer's normalisation of the clean batch.
// Each sample n takes kind codes[kinds[n]] of variant 1 (noise.py:47-86):
//   gaussian     clip(x01 + (sigma / 255) n)                 sigma = 25
//   salt_pepper  per pixel: 0 if up < 1 - e^(-0.02 C), else 1 if
//                us < 1 - e^(-0.02 C), else x01 (pepper over salt)
//   speckle      clip(x01 + x01 (0.1 n))
//   poisson      clip(K / 255), K ~ Poisson(x), counts >= 255 alike
//   uniform      clip(x01 + u (25 / 255))
// then * 2 - 1; the clean target is x01 * 2 - 1.  x01 = x * RN(1/255): on
// the card PyTorch divides by a scalar as a product with its reciprocal,
// so this is the trainer's clean.to(float32) / 255.0 * 2.0 - 1.0 there.
//
// Random bits.  The TPU kernel reads its core's hardware generator, whose
// stream no other machine can reproduce.  Here the bits come from
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), written out below so that the plain PyTorch version in
// ops/cuda/noise.py reproduces the stream bit for bit:
//   * i is the flat element index over the whole batch, 64 bits;
//   * counter = (lo32(i >> 1), hi32(i >> 1), 0, 0), key = (lo32(seed),
//     hi32(seed)); the seed is read from device memory (the trainer draws
//     it on the card: nothing comes to the host) or given by value;
//   * an even i takes output words 0, 1 as (a, b), an odd i words 2, 3;
//   * u1 = (a >> 8) 2^-24 + 2^-25, u2 = (b >> 8) 2^-24,
//     n = sqrt(-2 ln u1) cos(2 pi u2) (gaussian, speckle); u = (a >> 8)
//     2^-24 (uniform); salt & pepper take us, up from (a, b) of the
//     pixel's channel-0 element; poisson takes the whole word a.
// So a gaussian sample gets exactly what the gaussian-only kernel gives at
// the same index, and the output depends on (seed, index, kinds) only,
// never on the launch grid.  Every float operation the compiler could
// contract into an FMA is written with a round-to-nearest intrinsic, and
// logf / cosf / sqrtf are the precise ones torch.log / torch.cos /
// torch.sqrt call on the card, so the arithmetic is the plain version's,
// operation for operation.
//
// Poisson without a rejection loop.  lambda = x is an integer in 0..255 and
// every count >= 255 gives the same output, so inversion against a table is
// exact: row lambda holds T[k] = ceil(P(K <= k) 2^32) - 1 (float64 on the
// host, 256 x 256 uint32 = 256 KB, which stays in L2), and K = #{k : T[k] <
// a}, at most 255; P(K <= k) is then exact to 2^-32.  A guide holds K at
// a = j 2^22 (1025 bytes a row, 256 KB): K lies between the counts at the
// ends of a's bucket, which are equal for 94% of the words at random
// lambda; a binary search between them costs 0.07 table reads a word on
// average, the eight words of a thread searched in step.  A warp waits for
// its longest search: about 3.4 steps at random lambda (6.5 with 256
// buckets), mostly in the buckets at the ends, where the thresholds of the
// tails crowd together.
//
// What bounds it on an H100.  Bytes: one read of a byte and two writes of
// a float per element (3.1 MB + 25.2 MB at the train batch, 16 x 256 x 256
// x 3, 8.4 us at 3.35 TB/s).  Operations: Philox's 40 multiplies per two
// elements and, for the gaussian and speckle samples, the precise log, cos
// and sqrt; chip_smoke.py counts the instructions every chunk of each kind
// must issue (noise_issue_probe, in SASS) against the SMs' issue rate.
// The design: a thread owns 8 consecutive elements of one sample (an
// 8-byte load, four Philox blocks, 16-byte stores of the noisy and clean
// floats): 393,216 threads at the train batch, more than the 270,336 the
// card holds at once, so each SM keeps its four schedulers fed; the kind
// is uniform over a chunk (a warp's 256 elements straddle two samples only
// where a sample's size is not a multiple of 8), so a warp takes one
// branch.  Chunks across a sample boundary, the batch's tail and
// unaligned tensors take a scalar loop over the same indices.  None of
// the Pallas version's VMEM matters (one image per grid step, (rows, 128)
// lanes, a padded tail) is carried over.

#include <cstdint>

#include "common.cuh"
#include "noise.cuh"

namespace {

using namespace cid::noise;

// codes: 4 bits per entry of `types`; kinds: the entry each sample drew (a
// null kinds: every sample entry 0).  A code beyond the five gives NaN.
__device__ __forceinline__ int kind_of(const long long* __restrict__ kinds,
                                       uint32_t codes, long long s) {
  const long long t = kinds == nullptr ? 0 : kinds[s];
  return t >= 0 && t < 8 ? (int)((codes >> (4 * t)) & 0xFu) : 0xF;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
noise_batch_kernel(const uint8_t* __restrict__ x, T* __restrict__ noisy,
                   float* __restrict__ clean,
                   const long long* __restrict__ kinds, uint32_t codes,
                   const unsigned long long* __restrict__ seed_ptr,
                   unsigned long long seed, long long total,
                   long long per_sample, int channels,
                   const uint32_t* __restrict__ table,
                   const uint8_t* __restrict__ guide, Params p, int aligned) {
  const long long i0 =
      ((long long)blockIdx.x * kThreads + (long long)threadIdx.x) * kChunk;
  if (i0 >= total) return;
  if (seed_ptr != nullptr) seed = *seed_ptr;
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  const long long s0 = i0 / per_sample;

  if (aligned && i0 + kChunk <= total && i0 + kChunk <= (s0 + 1) * per_sample) {
    uint8_t xs[kChunk];
    load8(x + i0, xs);
    float out[kChunk];
    switch (kind_of(kinds, codes, s0)) {
      case kGaussian:
        chunk_of<kGaussian>(xs, i0, channels, k0, k1, p, table, guide, out);
        break;
      case kSaltPepper:
        chunk_of<kSaltPepper>(xs, i0, channels, k0, k1, p, table, guide, out);
        break;
      case kSpeckle:
        chunk_of<kSpeckle>(xs, i0, channels, k0, k1, p, table, guide, out);
        break;
      case kPoisson:
        chunk_of<kPoisson>(xs, i0, channels, k0, k1, p, table, guide, out);
        break;
      case kUniform:
        chunk_of<kUniform>(xs, i0, channels, k0, k1, p, table, guide, out);
        break;
      default:
#pragma unroll
        for (int e = 0; e < kChunk; ++e) out[e] = nanf("");
    }
    store8<T>(noisy + i0, out);
    if (clean != nullptr) store_clean(clean + i0, xs);
    return;
  }

  const long long end = i0 + kChunk < total ? i0 + kChunk : total;
  for (long long i = i0; i < end; ++i) {
    const uint8_t xe = x[i];
    const int kind = kind_of(kinds, codes, i / per_sample);
    uint32_t a, b;
    words_of(kind == kSaltPepper ? i - i % channels : i, k0, k1, a, b);
    float v;
    switch (kind) {
      case kGaussian: v = noisy_of<kGaussian>(xe, a, b, p, table, guide); break;
      case kSaltPepper: v = salt_pepper_of(xe, a, b, p); break;
      case kSpeckle: v = noisy_of<kSpeckle>(xe, a, b, p, table, guide); break;
      case kPoisson: v = noisy_of<kPoisson>(xe, a, b, p, table, guide); break;
      case kUniform: v = noisy_of<kUniform>(xe, a, b, p, table, guide); break;
      default: v = nanf("");
    }
    noisy[i] = cid::from_f32<T>(v);
    if (clean != nullptr) clean[i] = to_pm1(x01_of(xe));
  }
}

bool aligned_to(const void* ptr, uintptr_t n) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % n == 0;
}

template <typename T>
cudaError_t launch(const void* x, void* noisy, float* clean,
                   const long long* kinds, uint32_t codes,
                   const unsigned long long* seed_ptr, unsigned long long seed,
                   long long total, long long per_sample, int channels,
                   const uint32_t* table, const uint8_t* guide,
                   const Params& p, cudaStream_t stream) {
  const long long chunks = (total + kChunk - 1) / kChunk;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  if (!cid::grid_fits(blocks)) return cudaErrorInvalidConfiguration;
  const int aligned =
      aligned_to(x, 8) && aligned_to(noisy, 16) && aligned_to(clean, 16);
  noise_batch_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<T*>(noisy), clean, kinds,
      codes, seed_ptr, seed, total, per_sample, channels, table, guide, p,
      aligned);
  return cudaGetLastError();
}

}  // namespace

// x: `total` uint8 values, samples of `per_sample` elements (a multiple of
// `channels`); noisy: `total` values of `dtype` (common.cuh codes); clean:
// `total` floats or null; kinds: one int64 per sample, an index into the
// 4-bit `codes`, or null (every sample entry 0); the seed from seed_ptr (8
// bytes on the device) or, if that is null, `seed`; table (256 x 256
// uint32) and guide (256 x 1025 uint8): the poisson inversion, needed
// where a code is poisson.
extern "C" int cid_noise_batch(const void* x, void* noisy, void* clean,
                               const void* kinds, unsigned int codes,
                               const void* seed_ptr, unsigned long long seed,
                               long long total, long long per_sample,
                               int channels, const void* table,
                               const void* guide, float sigma01,
                               float speckle, float uniform, float salt,
                               float pepper, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total <= 0 || per_sample <= 0 || channels <= 0 ||
      per_sample % channels != 0 || total % per_sample != 0)
    return (int)cudaErrorInvalidValue;
  for (uint32_t c = codes; c != 0; c >>= 4)
    if ((c & 0xFu) == kPoisson && (table == nullptr || guide == nullptr))
      return (int)cudaErrorInvalidValue;
  const Params p{sigma01, speckle, uniform, salt, pepper};
  const auto* k = static_cast<const long long*>(kinds);
  const auto* sp = static_cast<const unsigned long long*>(seed_ptr);
  const auto* t = static_cast<const uint32_t*>(table);
  const auto* g = static_cast<const uint8_t*>(guide);
  float* c = static_cast<float*>(clean);
  if (dtype == cid::kDtypeF32)
    return (int)launch<float>(x, noisy, c, k, codes, sp, seed, total,
                              per_sample, channels, t, g, p, s);
  if (dtype == cid::kDtypeBF16)
    return (int)launch<__nv_bfloat16>(x, noisy, c, k, codes, sp, seed, total,
                                      per_sample, channels, t, g, p, s);
  return (int)cudaErrorInvalidValue;
}

// The gaussian-only entry of the Pallas original: every element gaussian,
// no clean output, the seed by value.
extern "C" int cid_normalize_gaussian_noise(const void* x, void* y,
                                            long long total,
                                            unsigned long long seed,
                                            float sigma01, int dtype,
                                            void* stream) {
  return cid_noise_batch(x, y, nullptr, nullptr, (unsigned)kGaussian, nullptr,
                         seed, total, total, 1, nullptr, nullptr, sigma01, 0.f,
                         0.f, 0.f, 0.f, dtype, stream);
}
