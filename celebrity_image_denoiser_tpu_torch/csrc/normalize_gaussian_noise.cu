// The training input stage in one launch: a uint8 NHWC batch in, its noisy
// version and its clean target out, float32 in [-1, 1] or on [0, 1].
//
// Replaces:
//   celebrity_image_denoiser_tpu/ops/pallas/noise_kernel.py::fused_normalize_gaussian_noise (:46)
// (uint8 -> clip(x / 255 + (sigma / 255) n, 0, 1) * 2 - 1 with n ~ N(0, 1))
// and, around it, the rest of the JAX package's on-the-fly input stage,
// celebrity_image_denoiser_tpu/data/noise.py::random_noise_batch (:207-229):
// one compiled program in which every sample takes the noise kind it drew
// (vmap + lax.switch), and the trainer's normalisation of the clean batch;
// and blind_gaussian_batch (:232-242), dncnn's input stage.  Each sample n
// takes kind codes[kinds[n]] of its variant (noise.py:45-170), on x01:
//              variant 1               variant 2             variant 3
//   gaussian   x01 + (25/255) n        the same              x01 + 0.1 n
//   s & p      per pixel: 0 if         per element: if       per element: 0
//              up < 1 - e^(-0.02 C),   uf < 0.05, 1 if       if up < 0.002,
//              else 1 if us < that     us < 0.5 else 0       else 1 if
//              (pepper over salt)                            us < 0.002
//   speckle    x01 + x01 (0.1 n)       the same              x01 + x01 n
//   poisson    K / 255, K ~ Pois(x),   K / 256, K ~ Pois(x01 256), counts
//              counts >= 255 alike     >= 256 alike (JAX's on-device vals)
//   uniform    x01 + u (25/255)        x01 + (-50/255 +      x01 + (-0.05 +
//                                      u (100/255))          u 0.1)
// each clipped to [0, 1]; the blind-sigma Gaussian: x01 + sigma_n n with
// sigma_n = (5 + u_n 45) RN(1/255) per sample.  On [-1, 1] every output
// and the clean target x01 then take * 2 - 1.  x01 = x * RN(1/255): on the
// card PyTorch divides by a scalar as a product with its reciprocal, so
// this is the trainer's clean.to(float32) / 255.0 there.
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
//     2^-24 (uniform); poisson takes the whole word a; salt & pepper take
//     us = (a >> 8) 2^-24 and the second uniform up (variant 2: uf and us)
//     = (b >> 8) 2^-24 from the element's (a, b), or in variant 1 from the
//     (a, b) of the pixel's channel-0 element;
//   * the blind sigma of sample n: u_n = (w0 >> 8) 2^-24 from word 0 of the
//     block at counter (lo32(n), hi32(n), 1, 0), apart from every element's
//     counter by its third word.
// So a gaussian sample gets exactly what the gaussian-only kernel gives at
// the same index, and the output depends on (seed, index, kinds) only,
// never on the launch grid.  A launch over samples [k, k + n) of a batch
// (first_sample = k: one rank's share of a data-parallel step) takes their
// indices and blind-sigma blocks in the whole batch, so it writes rows k ..
// k + n - 1 of the whole batch's launch, bit for bit.  Every float operation the compiler could
// contract into an FMA is written with a round-to-nearest intrinsic, and
// logf / cosf / sqrtf are the precise ones torch.log / torch.cos /
// torch.sqrt call on the card, so the arithmetic is the plain version's,
// operation for operation.
//
// One template instance per (variant, domain): noise_batch_kernel<T, V,
// UNIT>, f32 for variants 0 (blind) to 3 in both domains and bf16 for
// variant 1 on [-1, 1] (the gaussian-only entry).  Not a parameter table in
// constant memory: the variants differ in code, not only in constants (salt
// & pepper per pixel or per element and with which rule, the poisson
// table's scale and cap, the uniform's offset, the blind sigma), so an
// instance holds only its own variant's branches, and variant 1's is the
// code it was before the other variants came, with the constants it had.
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
// tails crowd together.  Variants 2 and 3 take lambda = x 256 / 255 (still
// one of 256 values a row, in a table of their own) and K / 256: a count
// of 256 differs from 255 there, and the guide, whose counts stop at 255,
// is followed by one more look at T[255] when the search ends at 255.
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

// V: the variant (kBlind: every sample gaussian with its own sigma; kinds
// and codes unread); UNIT: outputs on [0, 1] instead of [-1, 1].
template <typename T, int V, bool UNIT>
__global__ void __launch_bounds__(kThreads)
noise_batch_kernel(const uint8_t* __restrict__ x, T* __restrict__ noisy,
                   float* __restrict__ clean,
                   const long long* __restrict__ kinds, uint32_t codes,
                   const unsigned long long* __restrict__ seed_ptr,
                   unsigned long long seed, long long first_sample,
                   long long total, long long per_sample, int channels,
                   const uint32_t* __restrict__ table,
                   const uint8_t* __restrict__ guide, Params p, int aligned) {
  const long long i0 =
      ((long long)blockIdx.x * kThreads + (long long)threadIdx.x) * kChunk;
  if (i0 >= total) return;
  if (seed_ptr != nullptr) seed = *seed_ptr;
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  // i indexes this launch's tensors, base + i the stream (the element's
  // index in the whole batch); s the kinds, first_sample + s the blind sigma
  const long long base = first_sample * per_sample;
  const long long s0 = i0 / per_sample;

  if (aligned && i0 + kChunk <= total && i0 + kChunk <= (s0 + 1) * per_sample) {
    uint8_t xs[kChunk];
    load8(x + i0, xs);
    float out[kChunk];
    if constexpr (V == kBlind) {
      Params q = p;
      q.sigma01 = blind_sigma01(first_sample + s0, k0, k1, p);
      chunk_of<kGaussian, 1, UNIT>(xs, base + i0, channels, k0, k1, q, table,
                                   guide, out);
    } else {
      switch (kind_of(kinds, codes, s0)) {
        case kGaussian:
          chunk_of<kGaussian, V, UNIT>(xs, base + i0, channels, k0, k1,
                                       p, table, guide, out);
          break;
        case kSaltPepper:
          chunk_of<kSaltPepper, V, UNIT>(xs, base + i0, channels, k0, k1,
                                         p, table, guide, out);
          break;
        case kSpeckle:
          chunk_of<kSpeckle, V, UNIT>(xs, base + i0, channels, k0, k1,
                                      p, table, guide, out);
          break;
        case kPoisson:
          chunk_of<kPoisson, V, UNIT>(xs, base + i0, channels, k0, k1,
                                      p, table, guide, out);
          break;
        case kUniform:
          chunk_of<kUniform, V, UNIT>(xs, base + i0, channels, k0, k1,
                                      p, table, guide, out);
          break;
        default:
#pragma unroll
          for (int e = 0; e < kChunk; ++e) out[e] = nanf("");
      }
    }
    store8<T>(noisy + i0, out);
    if (clean != nullptr) store_clean<UNIT>(clean + i0, xs);
    return;
  }

  const long long end = i0 + kChunk < total ? i0 + kChunk : total;
  for (long long i = i0; i < end; ++i) {
    const uint8_t xe = x[i];
    const long long s = i / per_sample;
    float v;
    uint32_t a, b;
    if constexpr (V == kBlind) {
      Params q = p;
      q.sigma01 = blind_sigma01(first_sample + s, k0, k1, p);
      words_of(base + i, k0, k1, a, b);
      v = noisy_of<kGaussian, 1, UNIT>(xe, a, b, q, table, guide);
    } else {
      const int kind = kind_of(kinds, codes, s);
      // variant 1's salt & pepper takes the words of the pixel's channel 0
      words_of(base + (V == 1 && kind == kSaltPepper ? i - i % channels : i),
               k0, k1, a, b);
      switch (kind) {
        case kGaussian:
          v = noisy_of<kGaussian, V, UNIT>(xe, a, b, p, table, guide);
          break;
        case kSaltPepper:
          v = noisy_of<kSaltPepper, V, UNIT>(xe, a, b, p, table, guide);
          break;
        case kSpeckle:
          v = noisy_of<kSpeckle, V, UNIT>(xe, a, b, p, table, guide);
          break;
        case kPoisson:
          v = noisy_of<kPoisson, V, UNIT>(xe, a, b, p, table, guide);
          break;
        case kUniform:
          v = noisy_of<kUniform, V, UNIT>(xe, a, b, p, table, guide);
          break;
        default: v = nanf("");
      }
    }
    noisy[i] = cid::from_f32<T>(v);
    if (clean != nullptr) clean[i] = out_of<UNIT>(x01_of(xe));
  }
}

bool aligned_to(const void* ptr, uintptr_t n) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % n == 0;
}

template <typename T, int V, bool UNIT>
cudaError_t launch(const void* x, void* noisy, float* clean,
                   const long long* kinds, uint32_t codes,
                   const unsigned long long* seed_ptr, unsigned long long seed,
                   long long first_sample, long long total,
                   long long per_sample, int channels, const uint32_t* table,
                   const uint8_t* guide, const Params& p,
                   cudaStream_t stream) {
  const long long chunks = (total + kChunk - 1) / kChunk;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  if (!cid::grid_fits(blocks)) return cudaErrorInvalidConfiguration;
  // a chunk takes its words from whole Philox blocks (pairs of elements
  // from an even index): an odd stream offset takes the scalar loop
  const int aligned = aligned_to(x, 8) && aligned_to(noisy, 16) &&
                      aligned_to(clean, 16) &&
                      (first_sample * per_sample) % 2 == 0;
  noise_batch_kernel<T, V, UNIT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<T*>(noisy), clean, kinds,
      codes, seed_ptr, seed, first_sample, total, per_sample, channels, table,
      guide, p, aligned);
  return cudaGetLastError();
}

// the f32 instance of (V, unit)
template <int V>
cudaError_t launch_f32(bool unit, const void* x, void* noisy, float* clean,
                       const long long* kinds, uint32_t codes,
                       const unsigned long long* seed_ptr,
                       unsigned long long seed, long long first_sample,
                       long long total, long long per_sample, int channels,
                       const uint32_t* table, const uint8_t* guide,
                       const Params& p, cudaStream_t stream) {
  return unit ? launch<float, V, true>(x, noisy, clean, kinds, codes,
                                       seed_ptr, seed, first_sample, total,
                                       per_sample, channels, table, guide, p,
                                       stream)
              : launch<float, V, false>(x, noisy, clean, kinds, codes,
                                        seed_ptr, seed, first_sample, total,
                                        per_sample, channels, table, guide, p,
                                        stream);
}

}  // namespace

// x: `total` uint8 values, samples of `per_sample` elements (a multiple of
// `channels`); noisy: `total` values of `dtype` (common.cuh codes; bf16 in
// variant 1 on [-1, 1] only); clean: `total` floats or null; kinds: one
// int64 per sample, an index into the 4-bit `codes`, or null (every sample
// entry 0); the seed from seed_ptr (8 bytes on the device) or, if that is
// null, `seed`; first_sample: the index of x's first sample in the batch
// whose stream it takes (x's sample s draws what sample first_sample + s
// draws in a launch over the whole batch: one rank's share of a
// data-parallel step; 0 for a whole batch); table (256 x 256 uint32) and guide (256 x 1025 uint8): the
// poisson inversion of the variant, needed where a code is poisson;
// variant: 0 (the blind-sigma Gaussian: kinds, codes, table and guide
// unread), 1, 2 or 3; unit: outputs on [0, 1] (else [-1, 1]).
extern "C" int cid_noise_batch(const void* x, void* noisy, void* clean,
                               const void* kinds, unsigned int codes,
                               const void* seed_ptr, unsigned long long seed,
                               long long first_sample, long long total,
                               long long per_sample, int channels,
                               const void* table,
                               const void* guide, int variant, int unit,
                               float sigma01, float speckle, float uniform,
                               float low, float sp_a, float sp_b,
                               float blind_lo, float blind_span, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total <= 0 || per_sample <= 0 || channels <= 0 ||
      per_sample % channels != 0 || total % per_sample != 0 || variant < 0 ||
      variant > 3 || first_sample < 0)
    return (int)cudaErrorInvalidValue;
  if (variant != kBlind)
    for (uint32_t c = codes; c != 0; c >>= 4)
      if ((c & 0xFu) == kPoisson && (table == nullptr || guide == nullptr))
        return (int)cudaErrorInvalidValue;
  const Params p{sigma01, speckle, uniform, low, sp_a, sp_b, blind_lo,
                 blind_span};
  const auto* k = static_cast<const long long*>(kinds);
  const auto* sp = static_cast<const unsigned long long*>(seed_ptr);
  const auto* t = static_cast<const uint32_t*>(table);
  const auto* g = static_cast<const uint8_t*>(guide);
  float* c = static_cast<float*>(clean);
  if (dtype == cid::kDtypeBF16) {
    if (variant != 1 || unit) return (int)cudaErrorInvalidValue;
    return (int)launch<__nv_bfloat16, 1, false>(x, noisy, c, k, codes, sp,
                                                seed, first_sample, total,
                                                per_sample, channels, t, g, p,
                                                s);
  }
  if (dtype != cid::kDtypeF32) return (int)cudaErrorInvalidValue;
  const bool u = unit != 0;
  switch (variant) {
    case kBlind:
      return (int)launch_f32<kBlind>(u, x, noisy, c, k, codes, sp, seed,
                                     first_sample, total, per_sample,
                                     channels, t, g, p, s);
    case 1:
      return (int)launch_f32<1>(u, x, noisy, c, k, codes, sp, seed,
                                first_sample, total, per_sample, channels, t,
                                g, p, s);
    case 2:
      return (int)launch_f32<2>(u, x, noisy, c, k, codes, sp, seed,
                                first_sample, total, per_sample, channels, t,
                                g, p, s);
    default:
      return (int)launch_f32<3>(u, x, noisy, c, k, codes, sp, seed,
                                first_sample, total, per_sample, channels, t,
                                g, p, s);
  }
}

// The gaussian-only entry of the Pallas original: every element gaussian,
// no clean output, the seed by value.
extern "C" int cid_normalize_gaussian_noise(const void* x, void* y,
                                            long long total,
                                            unsigned long long seed,
                                            float sigma01, int dtype,
                                            void* stream) {
  return cid_noise_batch(x, y, nullptr, nullptr, (unsigned)kGaussian, nullptr,
                         seed, 0, total, total, 1, nullptr, nullptr, 1, 0,
                         sigma01, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, dtype,
                         stream);
}
