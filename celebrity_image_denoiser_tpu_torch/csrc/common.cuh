// Shared helpers for the port's hand-written Hopper kernels.
//
// Activations are either float or __nv_bfloat16; every kernel accumulates
// in float32 and converts once on store (round to nearest even, like
// torch's .to(torch.bfloat16)).  The C entry points take a dtype code:
// 0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cid {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ReLU that keeps NaN (torch.relu / jnp.maximum(x, 0) semantics).
__device__ __forceinline__ float relu_f32(float v) { return v < 0.f ? 0.f : v; }

// Grid sizes are computed in 64 bits on the host; a launch whose block
// count does not fit gridDim.x is refused rather than wrapped.
inline bool grid_fits(long long blocks) {
  return blocks > 0 && blocks <= 2147483647LL;
}

}  // namespace cid
