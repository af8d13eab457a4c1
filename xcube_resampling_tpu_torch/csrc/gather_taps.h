// The 4-tap gather of the JAX package's gather_interp
// (xcube_resampling_tpu/ops/reproject_ops.py:108-147), shared by K3
// (fused_reproject.cu) and K7 (ij_gather.cu): the bounds mask, the clamp to
// the source extent, the tap offsets and fractions (taps<M>), and the
// nearest, bilinear or triangular value (gather<M> on float32, gather_t<M, T>
// on the thirteen data types: bool for nearest only, as jnp's boolean
// subtract raises).
//
// Rounding follows the jitted XLA code: positions and fractions in float32;
// every lerp a fused multiply-add in the arithmetic type of the taps
// (float32 for float32, float16, bfloat16 and integer sources, float64 for
// float64 ones); the tap differences b - a taken in the source type, so
// integer differences wrap as jnp's do and half differences round.  Output
// types as jnp promotes them: the source type for nearest, float64 for
// float64 sources, float32 otherwise.
#pragma once

#include <type_traits>

#include "kernel_types.h"
#include "srw_common.h"

namespace xrt {

// The taps of one pixel: the top-left tap's offset in its plane, the steps
// to the right and down (0 where the clamp folds them onto the edge), the
// fractional parts, the mask.
struct Taps {
  unsigned off, dx, dy;
  float fx, fy;
  bool ok;
};

// A source plane's extent: the bounds in float32, as the JAX package
// compares them, and the clamp limits.
struct TapBounds {
  int src_w, src_h;
  float x_hi, y_hi, x_max, y_max;
};

__host__ inline TapBounds tap_bounds(int64_t src_h, int64_t src_w) {
  return {static_cast<int>(src_w), static_cast<int>(src_h),
          static_cast<float>(static_cast<double>(src_w) - 0.5),
          static_cast<float>(static_cast<double>(src_h) - 0.5),
          static_cast<float>(src_w - 1), static_cast<float>(src_h - 1)};
}

template <int M>
__device__ __forceinline__ Taps taps(float ix, float iy, const TapBounds& a) {
  Taps t;
  t.ok = ix > -0.5f && ix < a.x_hi && iy > -0.5f && iy < a.y_hi;
  ix = fminf(fmaxf(ix, 0.0f), a.x_max);
  iy = fminf(fmaxf(iy, 0.0f), a.y_max);
  if (M == kNearest) {
    t.off = static_cast<unsigned>(rintf(iy)) * a.src_w + static_cast<unsigned>(rintf(ix));
    t.dx = t.dy = 0u;
    t.fx = t.fy = 0.0f;
    return t;
  }
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  t.fx = ix - x0f;
  t.fy = iy - y0f;
  const unsigned x0 = static_cast<unsigned>(x0f);
  const unsigned y0 = static_cast<unsigned>(y0f);
  t.off = y0 * a.src_w + x0;
  t.dx = x0 + 1 < static_cast<unsigned>(a.src_w) ? 1u : 0u;
  t.dy = y0 + 1 < static_cast<unsigned>(a.src_h) ? static_cast<unsigned>(a.src_w) : 0u;
  return t;
}

// The taps' value on a float32 plane.  Every offset is inside the plane
// (the position was clamped), so the taps are read whether the pixel is
// valid or not.
template <int M>
__device__ __forceinline__ float gather(const float* __restrict__ p, const Taps& t) {
  const float* q = p + t.off;
  if (M == kNearest) return __ldg(q);
  const float v00 = __ldg(q);
  const float v01 = __ldg(q + t.dx);
  const float v10 = __ldg(q + t.dy);
  const float v11 = __ldg(q + t.dy + t.dx);
  if (M == kTriangular) {
    const float v_near = fmaf(t.fy, v10 - v00, lerp(v00, v01, t.fx));
    const float v_far = fmaf(1.0f - t.fy, v01 - v11, lerp(v11, v10, 1.0f - t.fx));
    return t.fx + t.fy < 1.0f ? v_near : v_far;
  }
  return lerp(lerp(v00, v01, t.fx), lerp(v10, v11, t.fx), t.fy);
}

// The arithmetic type of a source type's lerps, and gather_interp's output
// type for method M.
template <typename T>
using ArithOf = std::conditional_t<std::is_same<T, double>::value, double, float>;
template <int M, typename T>
using GatherOut = std::conditional_t<M == kNearest, T, ArithOf<T>>;

template <typename A>
__device__ __forceinline__ A fused(A a, A b, A c) {
  if constexpr (std::is_same<A, double>::value) {
    return fma(a, b, c);
  } else {
    return fmaf(a, b, c);
  }
}

// b - a in the source type (wrapping for integers, rounded for the half
// types: the float32 difference of two half values rounds once to theirs),
// as the arithmetic type
template <typename T>
__device__ __forceinline__ ArithOf<T> tap_diff(T b, T a) {
  if constexpr (std::is_floating_point<T>::value) {
    return b - a;
  } else if constexpr (is_half_v<T>) {
    return to_f32(T(to_f32(b) - to_f32(a)));
  } else {
    using U = std::make_unsigned_t<T>;
    return to_f32(static_cast<T>(static_cast<U>(static_cast<U>(b) - static_cast<U>(a))));
  }
}

// The taps' value on a plane of any of the data types (float32 takes
// gather<M> itself, so K3's rounding carries over bit for bit; bool nearest
// only), read through the read-only data path as gather<M> reads float32.
// A tap widens to the arithmetic type once (64-bit integers round once).
template <int M, typename T>
__device__ __forceinline__ GatherOut<M, T> gather_t(const T* __restrict__ p, const Taps& t) {
  if constexpr (std::is_same<T, float>::value) {
    return gather<M>(p, t);
  } else {
    using A = ArithOf<T>;
    const T* q = p + t.off;
    if constexpr (M == kNearest) {
      return ldg(q);
    } else {
      static_assert(!std::is_same<T, bool>::value, "bool takes nearest only");
      const T v00 = ldg(q);
      const T v01 = ldg(q + t.dx);
      const T v10 = ldg(q + t.dy);
      const T v11 = ldg(q + t.dy + t.dx);
      auto wide = [](T v) -> A {
        if constexpr (std::is_same<A, double>::value) {
          return v;
        } else {
          return to_f32(v);
        }
      };
      if constexpr (M == kTriangular) {
        const A v_near = fused(A(t.fy), tap_diff(v10, v00),
                               fused(A(t.fx), tap_diff(v01, v00), wide(v00)));
        const A v_far = fused(A(1.0f - t.fy), tap_diff(v01, v11),
                              fused(A(1.0f - t.fx), tap_diff(v10, v11), wide(v11)));
        return t.fx + t.fy < 1.0f ? v_near : v_far;
      } else {
        const A a = fused(A(t.fx), tap_diff(v01, v00), wide(v00));
        const A b = fused(A(t.fx), tap_diff(v11, v10), wide(v10));
        return fused(A(t.fy), b - a, a);
      }
    }
  }
}

}  // namespace xrt
