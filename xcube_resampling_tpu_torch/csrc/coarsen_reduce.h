// The window reducers of K5 (coarsen_reduce.cu), shared with K4's
// downscale form (affine_gather_reduce.cu), so that the two reduce a
// window with the same code and cannot drift apart.
//
// reduce<T, AGG>(taps, jd, id, pa, pb) reduces a jd x id window through an
// accessor: taps.row(r) prepares window row r and returns f, and f(q) is
// the tap (r, q).  K5 reads the taps from device memory, the downscale
// form gathers them from the source (a row's source columns loaded and
// lerped in row(r)).  The rows are asked for in order (a second pass for
// std and var starts again at row 0), and a row's taps in order
// (each_tap): with a run-time width id four at a time unrolled, so that
// their loads overlap; with a compile-time width (std::integral_constant)
// every tap unrolled, q a constant, so that an accessor can keep each
// tap's geometry in registers.  A pick asks for its one tap (pa, pb).
// f(q) returns T (for the float64 moments, sum and prod a double is taken
// too: the downscale form's unrounded ceiling for tools/).
//   mean, std, var: NaN-aware float64 moments of the valid taps (two
//     passes: the mean, then the centred squares), rounded once to the
//     data type (rint and saturation for integers, rint then != 0 for
//     bool); NaN for an all-NaN window;
//   sum, prod: float data NaN-aware in float64, rounded once (an all-NaN
//     window gives 0 and 1); integers and bool wrap in 64 bits and come
//     back int64 (uint64 for unsigned data);
//   min, max: NaN-aware for floats (NaN only for an all-NaN window);
//   count: the taps that are not 0 (NaN counts), int64;
//   first, last, center: the tap at (pa, pb) of the window.
#pragma once

#include <utility>

#include "kernel_types.h"

namespace xrt {

enum Agg : int {
  kMean = 0, kSum = 1, kStd = 2, kVar = 3, kMin = 4, kMax = 5, kProd = 6,
  kCount = 7, kPick = 8,
};

// The result type: int64 counts, 64-bit integer sums and products, else
// the data type.
template <typename T, int AGG>
struct OutType {
  using type = typename std::conditional<
      AGG == kCount, int64_t,
      typename std::conditional<
          (AGG == kSum || AGG == kProd) && !is_float_v<T>,
          typename std::conditional<is_unsigned_int_v<T>, uint64_t, int64_t>::type,
          T>::type>::type;
};

// A float64 statistic in the data type O, as coarsen_jax's int_roundtrip
// takes it back: rint first for integers and bool.
template <typename O>
__device__ __forceinline__ O stat_round(double v) {
  if constexpr (std::is_same<O, bool>::value) {
    return round_from<O>(rint(v));
  } else {
    return round_from<O>(v);
  }
}

// A tap index as an integer: a run-time q itself, a compile-time one's
// value (std::integral_constant's conversion is a host function to nvcc).
template <typename Q>
__host__ __device__ constexpr int64_t tap_index(Q q) {
  if constexpr (std::is_integral<Q>::value) {
    return q;
  } else {
    return Q::value;
  }
}

// f(q) for the taps q = 0 .. id - 1 of a window row, in order: a run-time
// width unrolled four at a time, a compile-time width fully.
template <typename F>
__device__ __forceinline__ void each_tap(int64_t id, F&& f) {
#pragma unroll 4
  for (int64_t q = 0; q < id; ++q) f(q);
}

template <typename F, int... Q>
__device__ __forceinline__ void each_tap_seq(F& f, std::integer_sequence<int, Q...>) {
  (f(std::integral_constant<int, Q>{}), ...);
}

template <int N, typename F>
__device__ __forceinline__ void each_tap(std::integral_constant<int, N>, F&& f) {
  each_tap_seq(f, std::make_integer_sequence<int, N>{});
}

// The reducers' steps over a row's taps, functors whose calls are inlined
// (a lambda's call may be left a call, around which ptxas spills what is
// live).
template <typename T, typename Tap>
struct CountStep {
  int64_t& c;
  Tap& tap;
  template <typename Q>
  __device__ __forceinline__ void operator()(Q q) const {
    c += tap(q) != T(0);
  }
};

template <typename T, int AGG, typename Tap>
struct MinMaxStep {
  T& m;
  bool& have;
  Tap& tap;
  bool first_row;
  template <typename Q>
  __device__ __forceinline__ void operator()(Q q) const {
    const T v = tap(q);
    if (first_row && tap_index(q) == 0) m = v;  // the result when every tap is NaN
    if (is_nan(v)) return;
    if (!have || (AGG == kMin ? v < m : v > m)) m = v;
    have = true;
  }
};

template <int AGG, typename Tap>
struct WrapStep {
  uint64_t& acc;
  Tap& tap;
  template <typename Q>
  __device__ __forceinline__ void operator()(Q q) const {
    // two's complement wraps alike for signed and unsigned data
    const uint64_t v = static_cast<uint64_t>(static_cast<int64_t>(tap(q)));
    acc = AGG == kSum ? acc + v : acc * v;
  }
};

template <int AGG, typename Tap>
struct MomentStep {
  double& acc;
  int64_t& n;
  Tap& tap;
  template <typename Q>
  __device__ __forceinline__ void operator()(Q q) const {
    const auto v = tap(q);
    if (is_nan(v)) return;
    acc = AGG == kProd ? acc * to_f64(v) : acc + to_f64(v);
    ++n;
  }
};

template <typename Tap>
struct SquareStep {
  double& sq;
  double mean;
  Tap& tap;
  template <typename Q>
  __device__ __forceinline__ void operator()(Q q) const {
    const auto v = tap(q);
    if (is_nan(v)) return;
    const double d = to_f64(v) - mean;
    sq = sq + d * d;
  }
};

template <typename T, int AGG, typename Taps, typename W>
__device__ __forceinline__ typename OutType<T, AGG>::type reduce(
    Taps& taps, int64_t jd, W id, int64_t pa, int64_t pb) {
  using O = typename OutType<T, AGG>::type;
  if constexpr (AGG == kPick) {
    return taps.row(pa)(pb);
  } else if constexpr (AGG == kCount) {
    int64_t c = 0;
    for (int64_t r = 0; r < jd; ++r) {
      auto tap = taps.row(r);
      each_tap(id, CountStep<T, decltype(tap)>{c, tap});
    }
    return c;
  } else if constexpr (AGG == kMin || AGG == kMax) {
    T m{};
    bool have = false;
    for (int64_t r = 0; r < jd; ++r) {
      auto tap = taps.row(r);
      each_tap(id, MinMaxStep<T, AGG, decltype(tap)>{m, have, tap, r == 0});
    }
    return m;
  } else if constexpr (!is_float_v<T> && (AGG == kSum || AGG == kProd)) {
    uint64_t acc = AGG == kSum ? 0u : 1u;
    for (int64_t r = 0; r < jd; ++r) {
      auto tap = taps.row(r);
      each_tap(id, WrapStep<AGG, decltype(tap)>{acc, tap});
    }
    return static_cast<O>(acc);
  } else {
    // float64 accumulation over the valid taps
    double acc = AGG == kProd ? 1.0 : 0.0;
    int64_t n = 0;
    for (int64_t r = 0; r < jd; ++r) {
      auto tap = taps.row(r);
      each_tap(id, MomentStep<AGG, decltype(tap)>{acc, n, tap});
    }
    if constexpr (AGG == kSum || AGG == kProd) {
      return round_from<O>(acc);  // float data only
    } else {
      const double mean = acc / static_cast<double>(n);
      if constexpr (AGG == kMean) {
        return stat_round<O>(mean);
      } else {
        double sq = 0.0;
        for (int64_t r = 0; r < jd; ++r) {
          auto tap = taps.row(r);
          each_tap(id, SquareStep<decltype(tap)>{sq, mean, tap});
        }
        const double var = sq / static_cast<double>(n);
        return stat_round<O>(AGG == kStd ? sqrt(var) : var);
      }
    }
  }
}

// f(std::integral_constant<int, AGG>{}) for the reducer code *agg*.
template <typename F>
__host__ inline cudaError_t with_agg(int agg, F&& f) {
  switch (agg) {
    case kMean: return f(std::integral_constant<int, kMean>{});
    case kSum: return f(std::integral_constant<int, kSum>{});
    case kStd: return f(std::integral_constant<int, kStd>{});
    case kVar: return f(std::integral_constant<int, kVar>{});
    case kMin: return f(std::integral_constant<int, kMin>{});
    case kMax: return f(std::integral_constant<int, kMax>{});
    case kProd: return f(std::integral_constant<int, kProd>{});
    case kCount: return f(std::integral_constant<int, kCount>{});
    case kPick: return f(std::integral_constant<int, kPick>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace xrt
