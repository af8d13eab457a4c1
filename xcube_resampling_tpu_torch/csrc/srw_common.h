// Tap weights and helpers shared by the SRW and fused-reproject kernels.
//
// Rounding follows the JAX package's jitted XLA code as its compiler emits
// it: every ``a + b * c`` that XLA contracts into a fused multiply-add (the
// tap sums and the lerps) is an explicit fmaf here, and the library is
// built with -fmad=false so that nothing else is contracted.  The port's
// plain PyTorch versions round the same way (their fma emulates the single
// rounding in float64), so a kernel agrees with its plain version bit for
// bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace xrt {

enum Method : int { kBilinear = 0, kNearest = 1, kTriangular = 2 };

// Weight of tap row/column k for a sample at position p: the hat for
// bilinear and triangular; for nearest 1 where rint(p) == k.  rintf
// rounds half to even like jnp.round and torch.round (never roundf).
__device__ __forceinline__ float tap_weight(float p, float k, int method) {
  if (method == kNearest) return rintf(p) == k ? 1.0f : 0.0f;
  return fmaxf(0.0f, 1.0f - fabsf(p - k));
}

// The (1, -1) mixed-difference taps of the triangular correction:
// +1 at floor(p), -1 at floor(p) + 1.
__device__ __forceinline__ float tap_dweight(float p, float k) {
  const float f = floorf(p);
  return (f == k ? 1.0f : 0.0f) - (f + 1.0f == k ? 1.0f : 0.0f);
}

// a + t * (b - a) with one rounding of the product-sum, as XLA emits it
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return fmaf(t, b - a, a);
}

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

}  // namespace xrt
