// One chunk of one noise kind per thread: the fast path of
// normalize_gaussian_noise.cu's batch kernel alone (total a multiple of
// kChunk, one sample).  Not part of the port's kernel library: chip_smoke.py
// builds this source on its own, counts the instructions each kind's kernel
// must issue in its SASS (the arithmetic floor of the batch kernel) and
// times the kinds one by one.

#include <cstdint>

#include "common.cuh"
#include "noise.cuh"

namespace {

using namespace cid::noise;

template <int KIND>
__global__ void __launch_bounds__(kThreads)
noise_issue_probe(const uint8_t* __restrict__ x, float* __restrict__ noisy,
                  float* __restrict__ clean,
                  const unsigned long long* __restrict__ seed_ptr,
                  long long total, int channels,
                  const uint32_t* __restrict__ table,
                  const uint8_t* __restrict__ guide, Params p) {
  const long long i0 =
      ((long long)blockIdx.x * kThreads + (long long)threadIdx.x) * kChunk;
  if (i0 >= total) return;
  const unsigned long long seed = *seed_ptr;
  uint8_t xs[kChunk];
  load8(x + i0, xs);
  float out[kChunk];
  chunk_of<KIND>(xs, i0, channels, (uint32_t)seed, (uint32_t)(seed >> 32), p,
                 table, guide, out);
  store8<float>(noisy + i0, out);
  store_clean(clean + i0, xs);
}

template <int KIND>
cudaError_t launch_probe(const void* x, float* noisy, float* clean,
                         const unsigned long long* seed_ptr, long long total,
                         int channels, const uint32_t* table,
                         const uint8_t* guide, const Params& p,
                         cudaStream_t stream) {
  const long long blocks = (total / kChunk + kThreads - 1) / kThreads;
  noise_issue_probe<KIND><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), noisy, clean, seed_ptr, total, channels,
      table, guide, p);
  return cudaGetLastError();
}

}  // namespace

// noise_issue_probe of one kind (x, noisy, clean as for cid_noise_batch, f32;
// total a multiple of 8, one sample).
extern "C" int cid_noise_issue_probe(int kind, const void* x, void* noisy,
                                     void* clean, const void* seed_ptr,
                                     long long total, int channels,
                                     const void* table, const void* guide,
                                     float sigma01, float speckle,
                                     float uniform, float salt, float pepper,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total <= 0 || total % kChunk != 0 || channels <= 0 ||
      seed_ptr == nullptr || table == nullptr || guide == nullptr ||
      !cid::grid_fits((total / kChunk + kThreads - 1) / kThreads))
    return (int)cudaErrorInvalidValue;
  const Params p{sigma01, speckle, uniform, salt, pepper};
  const auto* sp = static_cast<const unsigned long long*>(seed_ptr);
  const auto* t = static_cast<const uint32_t*>(table);
  const auto* g = static_cast<const uint8_t*>(guide);
  float* n = static_cast<float*>(noisy);
  float* c = static_cast<float*>(clean);
  switch (kind) {
    case kGaussian:
      return (int)launch_probe<kGaussian>(x, n, c, sp, total, channels, t, g,
                                          p, s);
    case kSaltPepper:
      return (int)launch_probe<kSaltPepper>(x, n, c, sp, total, channels, t,
                                            g, p, s);
    case kSpeckle:
      return (int)launch_probe<kSpeckle>(x, n, c, sp, total, channels, t, g,
                                         p, s);
    case kPoisson:
      return (int)launch_probe<kPoisson>(x, n, c, sp, total, channels, t, g,
                                         p, s);
    case kUniform:
      return (int)launch_probe<kUniform>(x, n, c, sp, total, channels, t, g,
                                         p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
