// K5: the window reducers (statistics and positional picks).
//
// Every j_div x i_div window of a (batch, h, w) array becomes one value of
// a (batch, h / j_div, w / i_div) array:
//   mean, std, var: NaN-aware float64 moments of the valid taps (two
//     passes: the mean, then the centred squares), rounded once to the
//     data type (rint and saturation for integers); NaN for an all-NaN
//     window;
//   sum, prod: float data NaN-aware in float64, rounded once (an all-NaN
//     window gives 0 and 1); integers wrap in 64 bits and come back int64
//     (uint64 for unsigned data);
//   min, max: NaN-aware for floats (NaN only for an all-NaN window);
//   count: the taps that are not 0 (NaN counts), int64;
//   first, last, center: the tap at (pa, pb) of the window.
//
// Replaces the XLA device path of xcube_resampling_tpu/ops/coarsen_ops.py:
// coarsen_jax (:36-87), whose semantics these are under x64.  JAX sums
// float32 in float32 in XLA's order; accumulating in float64 and rounding
// once puts the kernel within a few float32 ulp of it (PERF.md).
//
// Bound on the H100: device memory.  The work must read every input once
// (a pick only the sectors its taps touch) and write every output once,
// with one or two float64 operations a tap.  Design: a thread owns one
// output; neighbouring threads take neighbouring windows of one output
// row, so a warp's loads of one window position are i_div elements apart
// and the other positions hit the same sectors in L1.  The reducer is a
// template parameter; offsets are 64-bit.
#include "kernel_types.h"

namespace {

constexpr int kThreads = 128;

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
          (AGG == kSum || AGG == kProd) && !std::is_floating_point<T>::value,
          typename std::conditional<std::is_unsigned<T>::value, uint64_t, int64_t>::type,
          T>::type>::type;
};

struct Args {
  const void* src;
  void* out;
  int64_t h, w, oh, ow, jd, id, pa, pb, n_rows;  // n_rows = batch * oh
};

template <typename T, int AGG>
__device__ __forceinline__ typename OutType<T, AGG>::type reduce(const T* p, const Args& a) {
  using O = typename OutType<T, AGG>::type;
  if constexpr (AGG == kPick) {
    return p[a.pa * a.w + a.pb];
  } else if constexpr (AGG == kCount) {
    int64_t c = 0;
    for (int64_t r = 0; r < a.jd; ++r)
      for (int64_t q = 0; q < a.id; ++q) c += p[r * a.w + q] != T(0);
    return c;
  } else if constexpr (AGG == kMin || AGG == kMax) {
    T m = p[0];
    bool have = !xrt::is_nan(m);
    for (int64_t r = 0; r < a.jd; ++r) {
      for (int64_t q = 0; q < a.id; ++q) {
        const T v = p[r * a.w + q];
        if (xrt::is_nan(v)) continue;
        if (!have || (AGG == kMin ? v < m : v > m)) m = v;
        have = true;
      }
    }
    return m;  // NaN (p[0]) when every tap is NaN
  } else if constexpr (!std::is_floating_point<T>::value && (AGG == kSum || AGG == kProd)) {
    // two's complement wraps alike for signed and unsigned data
    uint64_t acc = AGG == kSum ? 0u : 1u;
    for (int64_t r = 0; r < a.jd; ++r) {
      for (int64_t q = 0; q < a.id; ++q) {
        const uint64_t v = static_cast<uint64_t>(static_cast<int64_t>(p[r * a.w + q]));
        acc = AGG == kSum ? acc + v : acc * v;
      }
    }
    return static_cast<O>(acc);
  } else {
    // float64 accumulation over the valid taps
    double acc = AGG == kProd ? 1.0 : 0.0;
    int64_t n = 0;
    for (int64_t r = 0; r < a.jd; ++r) {
      for (int64_t q = 0; q < a.id; ++q) {
        const T v = p[r * a.w + q];
        if (xrt::is_nan(v)) continue;
        acc = AGG == kProd ? acc * static_cast<double>(v) : acc + static_cast<double>(v);
        ++n;
      }
    }
    if constexpr (AGG == kSum || AGG == kProd) {
      return static_cast<O>(acc);  // float data only
    } else {
      const double mean = acc / static_cast<double>(n);
      if constexpr (AGG == kMean) {
        return xrt::round_from<O>(mean);
      } else {
        double sq = 0.0;
        for (int64_t r = 0; r < a.jd; ++r) {
          for (int64_t q = 0; q < a.id; ++q) {
            const T v = p[r * a.w + q];
            if (xrt::is_nan(v)) continue;
            const double d = static_cast<double>(v) - mean;
            sq = sq + d * d;
          }
        }
        const double var = sq / static_cast<double>(n);
        return xrt::round_from<O>(AGG == kStd ? sqrt(var) : var);
      }
    }
  }
}

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreads) coarsen_reduce_kernel(const Args a) {
  using O = typename OutType<T, AGG>::type;
  const int64_t oi = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (oi >= a.ow) return;
  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out);
  for (int64_t row = blockIdx.y; row < a.n_rows; row += gridDim.y) {
    const int64_t b = row / a.oh;
    const int64_t oj = row - b * a.oh;
    const T* p = src + (b * a.h + oj * a.jd) * a.w + oi * a.id;
    out[row * a.ow + oi] = reduce<T, AGG>(p, a);
  }
}

template <typename T, int AGG>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.ow + kThreads - 1) / kThreads),
                  static_cast<unsigned>(a.n_rows < 65535 ? a.n_rows : 65535));
  coarsen_reduce_kernel<T, AGG><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// agg: the Agg code; (pa, pb) the tap of kPick; returns cudaGetLastError().
extern "C" int xrt_coarsen_reduce(
    const void* src, void* out, int64_t batch, int64_t h, int64_t w,
    int64_t j_div, int64_t i_div, int agg, int64_t pa, int64_t pb, int code,
    void* stream) {
  if (batch < 1 || j_div < 1 || i_div < 1 || h < j_div || w < i_div ||
      h % j_div || w % i_div || pa < 0 || pa >= j_div || pb < 0 || pb >= i_div) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{src, out, h, w, h / j_div, w / i_div, j_div, i_div, pa, pb,
               batch * (h / j_div)};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(xrt::with_data_type(code, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    switch (agg) {
      case kMean: return launch<T, kMean>(a, s);
      case kSum: return launch<T, kSum>(a, s);
      case kStd: return launch<T, kStd>(a, s);
      case kVar: return launch<T, kVar>(a, s);
      case kMin: return launch<T, kMin>(a, s);
      case kMax: return launch<T, kMax>(a, s);
      case kProd: return launch<T, kProd>(a, s);
      case kCount: return launch<T, kCount>(a, s);
      case kPick: return launch<T, kPick>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }));
}
