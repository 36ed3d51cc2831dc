// Device functions shared by the denoiser kernels (`denoiser_chain.cu`,
// `denoiser_step.cu`). Each kernel source is its own translation unit and
// library, so the anonymous namespace gives each its own copy.
#pragma once
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mish(float v) {
  // softplus as logaddexp(v, 0) = max(v, 0) + log1p(exp(-|v|)), as
  // jax.nn.softplus computes it
  const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  return v * tanhf(sp);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
