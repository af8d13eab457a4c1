// Data types of the affine gather (K4) and the coarsen reducers (K5, K6):
// the codes the wrappers pass (xcube_resampling_tpu_torch/_device.py
// DTYPE_CODES), the dispatch from a code to a C++ type, NaN tests that are
// false for integers, and the one rounding of a float64 result to a data
// type (rint and saturation for integers, NaN to 0, as XLA converts).
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace xrt {

enum DType : int { kF32 = 0, kF64 = 1, kI8 = 2, kI16 = 3, kI32 = 4, kU8 = 5, kU16 = 6 };

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the data type of *code* (the seven DATA_DTYPES).
template <typename F>
__host__ inline cudaError_t with_data_type(int code, F&& f) {
  switch (code) {
    case kF32: return f(Tag<float>{});
    case kF64: return f(Tag<double>{});
    case kI8: return f(Tag<int8_t>{});
    case kI16: return f(Tag<int16_t>{});
    case kI32: return f(Tag<int32_t>{});
    case kU8: return f(Tag<uint8_t>{});
    case kU16: return f(Tag<uint16_t>{});
    default: return cudaErrorInvalidValue;
  }
}

// The code of a data type (the inverse of with_data_type).
template <typename T>
__host__ __device__ constexpr int code_of() {
  return std::is_same<T, float>::value      ? kF32
         : std::is_same<T, double>::value   ? kF64
         : std::is_same<T, int8_t>::value   ? kI8
         : std::is_same<T, int16_t>::value  ? kI16
         : std::is_same<T, int32_t>::value  ? kI32
         : std::is_same<T, uint8_t>::value  ? kU8
                                            : kU16;
}

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  if constexpr (std::is_floating_point<T>::value) {
    return isnan(v);
  } else {
    return false;
  }
}

// The range of an integer type, in float64 (exact for these types).
template <typename T>
struct Range;
template <> struct Range<int8_t> { static constexpr double lo = -128.0, hi = 127.0; };
template <> struct Range<int16_t> { static constexpr double lo = -32768.0, hi = 32767.0; };
template <> struct Range<int32_t> { static constexpr double lo = -2147483648.0, hi = 2147483647.0; };
template <> struct Range<uint8_t> { static constexpr double lo = 0.0, hi = 255.0; };
template <> struct Range<uint16_t> { static constexpr double lo = 0.0, hi = 65535.0; };

// v rounded once to T: a cast for floats; for integers rint (half to
// even), NaN to 0 and the range clamped.
template <typename T>
__device__ __forceinline__ T round_from(double v) {
  if constexpr (std::is_floating_point<T>::value) {
    return static_cast<T>(v);
  } else {
    const double r = rint(v);
    if (isnan(r)) return T(0);
    return static_cast<T>(fmin(fmax(r, Range<T>::lo), Range<T>::hi));
  }
}

}  // namespace xrt
