// Data types of the kernels that take more than float32 (K1, K2, K3, K4,
// its downscale form, K5, K6, K7, K9): the codes the wrappers pass
// (xcube_resampling_tpu_torch/_device.py DTYPE_CODES), the dispatch from a
// code to a C++ type, loads, widening to float64, NaN tests that are false
// for integers and bool, and the one rounding of a float64 result to a data
// type (rint and saturation for integers, NaN to 0, as XLA converts; float16
// rounded once, bfloat16 through float32, bool the test != 0).
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace xrt {

enum DType : int {
  kF32 = 0, kF64 = 1, kI8 = 2, kI16 = 3, kI32 = 4, kU8 = 5, kU16 = 6,
  kI64 = 7, kU32 = 8, kU64 = 9, kF16 = 10, kBF16 = 11, kBool = 12,
};

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the data type of *code* (the thirteen DATA_DTYPES).
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
    case kI64: return f(Tag<int64_t>{});
    case kU32: return f(Tag<uint32_t>{});
    case kU64: return f(Tag<uint64_t>{});
    case kF16: return f(Tag<__half>{});
    case kBF16: return f(Tag<__nv_bfloat16>{});
    case kBool: return f(Tag<bool>{});
    default: return cudaErrorInvalidValue;
  }
}

// The code of a data type (the inverse of with_data_type).
template <typename T>
__host__ __device__ constexpr int code_of() {
  return std::is_same<T, float>::value           ? kF32
         : std::is_same<T, double>::value        ? kF64
         : std::is_same<T, int8_t>::value        ? kI8
         : std::is_same<T, int16_t>::value       ? kI16
         : std::is_same<T, int32_t>::value       ? kI32
         : std::is_same<T, uint8_t>::value       ? kU8
         : std::is_same<T, uint16_t>::value      ? kU16
         : std::is_same<T, int64_t>::value       ? kI64
         : std::is_same<T, uint32_t>::value      ? kU32
         : std::is_same<T, uint64_t>::value      ? kU64
         : std::is_same<T, __half>::value        ? kF16
         : std::is_same<T, __nv_bfloat16>::value ? kBF16
                                                 : kBool;
}

// The half types: floating point, but not to std::is_floating_point.
template <typename T>
constexpr bool is_half_v = std::is_same<T, __half>::value || std::is_same<T, __nv_bfloat16>::value;
template <typename T>
constexpr bool is_float_v = std::is_floating_point<T>::value || is_half_v<T>;
// Integers of a sign, bool apart (JAX sums bool into int64)
template <typename T>
constexpr bool is_unsigned_int_v = std::is_unsigned<T>::value && !std::is_same<T, bool>::value;

// v as float64 (exact for every data type but the 64-bit integers, which
// round once)
template <typename T>
__device__ __forceinline__ double to_f64(T v) {
  if constexpr (std::is_same<T, __half>::value) {
    return static_cast<double>(__half2float(v));
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return static_cast<double>(__bfloat162float(v));
  } else {
    return static_cast<double>(v);
  }
}

// v as float32, rounded once
template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half2float(v);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else {
    return static_cast<float>(v);
  }
}

// *p through the read-only data path, for every data type
template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  if constexpr (std::is_same<T, bool>::value) {
    return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
  } else if constexpr (std::is_integral<T>::value && sizeof(T) == 8) {
    return static_cast<T>(__ldg(reinterpret_cast<const unsigned long long*>(p)));
  } else {
    return __ldg(p);
  }
}

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  if constexpr (std::is_same<T, __half>::value) {
    return __hisnan(v);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __hisnan(v);
  } else if constexpr (std::is_floating_point<T>::value) {
    return isnan(v);
  } else {
    return false;
  }
}

// The range of an integer type up to 32 bits, in float64 (exact).
template <typename T>
struct Range;
template <> struct Range<int8_t> { static constexpr double lo = -128.0, hi = 127.0; };
template <> struct Range<int16_t> { static constexpr double lo = -32768.0, hi = 32767.0; };
template <> struct Range<int32_t> { static constexpr double lo = -2147483648.0, hi = 2147483647.0; };
template <> struct Range<uint8_t> { static constexpr double lo = 0.0, hi = 255.0; };
template <> struct Range<uint16_t> { static constexpr double lo = 0.0, hi = 65535.0; };
template <> struct Range<uint32_t> { static constexpr double lo = 0.0, hi = 4294967295.0; };

// float64 -> float16 rounded once: rounded to odd into float32 (toward
// zero, the last bit set where inexact), then to nearest even into float16,
// exact as float32 holds 13 more bits than float16; the same steps as the
// plain version (_device.round_to)
__device__ __forceinline__ __half f64_to_f16(double v) {
  float f = __double2float_rz(v);
  if (!isnan(v) && static_cast<double>(f) != v) {
    f = __int_as_float(__float_as_int(f) | 1);
  }
  return __float2half_rn(f);
}

// v rounded once to T: a cast for float32 and float64; float16 rounded
// once; bfloat16 through float32 (as XLA and ml_dtypes convert); bool the
// test v != 0 (NaN is true); for integers rint (half to even), NaN to 0 and
// the range saturated (2^63 and 2^64, which no 64-bit integer holds, to the
// largest): the 64-bit integers by PTX's cvt.rni, which rounds to nearest
// even, saturates and takes NaN to 0 as XLA's convert does.
template <typename T>
__device__ __forceinline__ T round_from(double v) {
  if constexpr (std::is_floating_point<T>::value) {
    return static_cast<T>(v);
  } else if constexpr (std::is_same<T, __half>::value) {
    return f64_to_f16(v);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(static_cast<float>(v));
  } else if constexpr (std::is_same<T, bool>::value) {
    return v != 0.0;
  } else {
    if constexpr (std::is_same<T, int64_t>::value) {
      return static_cast<T>(__double2ll_rn(v));
    } else if constexpr (std::is_same<T, uint64_t>::value) {
      return static_cast<T>(__double2ull_rn(v));
    } else {
      const double r = rint(v);
      if (isnan(r)) return T(0);
      return static_cast<T>(fmin(fmax(r, Range<T>::lo), Range<T>::hi));
    }
  }
}

}  // namespace xrt
