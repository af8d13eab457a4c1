// K9: the JAX package's host gathers, in float64, on the card.
//
// Numpy-backed variables take the JAX package's host paths, whose results
// the port keeps bit for bit:
//   * ij_map mode replaces rectify Phase B's host gather,
//     xcube_resampling_tpu/ops/rectify_ops.py:var_image_from_ij_map
//     (:2767-2855, native/phase_b.cpp): the map's index truncated,
//     u = map - trunc(map) in float64, nearest taking the next pixel where
//     u > 0.5, taps clipped to the source, lerps in float64 on float64
//     taps, NaN map cells to the fill;
//   * window mode replaces the reproject host path,
//     xcube_resampling_tpu/reproject.py:_gather_through_windows (:166-206)
//     through ops/gather.py:grid_sample (:162-217): per target tile, the
//     positions (x - x_origin) / x_res and (y - y_origin) / -y_res in the
//     tile's source window (float64 target centres, float32-quantised window
//     origins), the window of a source padded with the fill (the padding is
//     not materialised: a tap outside the source reads the fill),
//     rint-and-clip nearest, floor/ceil bilinear and triangular taps with
//     their differences taken in the source type (wrapping for integers,
//     rounded to float32 for float32), the rest in float64.
// Each result is rounded once to the source type: a cast for floats
// (float16 once, bfloat16 through float32, as ml_dtypes); for integers
// rint, then the conversion numpy's float64 -> integer casts make on x86
// (up to 32 bits through int32, INT32_MIN where out of its range or NaN;
// int64 INT64_MIN out of its range; uint64 modulo 2^64); bool x != 0.  The
// window mode's bool takes nearest only (numpy's boolean subtract raises;
// the wrapper refuses it), the ij_map mode's lerps bool's taps in float64,
// as var_image_from_ij_map upcasts them.
//
// Bound on the H100: device memory for both modes (a pixel reads its float64
// map or centres, 16 bytes, and its taps; a few tens of float64 operations,
// far below the 34 TFLOP/s float64 peak at these bytes).  Design: one thread
// a pixel, the bands in a loop, so positions and tap offsets are computed
// once for every band.
#include "kernel_types.h"
#include "srw_common.h"

namespace {

constexpr int kThreads = 256;

// numpy's float64 -> int32 conversion on x86 (cvttsd2si): truncation,
// INT32_MIN out of range and for NaN
__device__ __forceinline__ int to_i32(double x) {
  return (x >= -2147483648.0 && x < 2147483648.0) ? static_cast<int>(x) : INT32_MIN;
}

// numpy's x86 float64 -> int64 conversion (cvttsd2si): INT64_MIN out of
// range and for NaN
__device__ __forceinline__ int64_t to_i64(double x) {
  return (x >= -9223372036854775808.0 && x < 9223372036854775808.0) ? __double2ll_rz(x)
                                                                    : INT64_MIN;
}

// numpy's rounding of a float64 result to the source type (see above)
template <typename T>
__device__ __forceinline__ T host_round(double v) {
  if constexpr (xrt::is_float_v<T> || std::is_same<T, bool>::value) {
    return xrt::round_from<T>(v);
  } else if constexpr (std::is_same<T, uint64_t>::value) {
    const double r = rint(v);
    return static_cast<T>(to_i64(r >= 9223372036854775808.0 ? r - 18446744073709551616.0 : r));
  } else if constexpr (std::is_same<T, int64_t>::value) {
    return to_i64(rint(v));
  } else if constexpr (std::is_same<T, uint32_t>::value) {
    // through int64 (saturating, NaN to 0): modulo 2^32 (rint(v) of a
    // value of the source range lies in it)
    return static_cast<T>(__double2ll_rn(v));
  } else {
    return static_cast<T>(to_i32(rint(v)));
  }
}

// b - a in the source type (float32, float16 and bfloat16 rounding, integer
// wraparound), as float64
template <typename T>
__device__ __forceinline__ double host_diff(T b, T a) {
  if constexpr (std::is_same<T, bool>::value) {
    return 0.0;  // not reached: bool takes nearest only
  } else if constexpr (xrt::is_half_v<T>) {
    return xrt::to_f64(T(xrt::to_f32(b) - xrt::to_f32(a)));
  } else if constexpr (std::is_floating_point<T>::value) {
    return static_cast<double>(static_cast<T>(b - a));
  } else {
    using U = std::make_unsigned_t<T>;
    return static_cast<double>(static_cast<T>(static_cast<U>(static_cast<U>(b) - static_cast<U>(a))));
  }
}

// a fill in the source type: an integer's exact bits, else the float
template <typename T>
__device__ __forceinline__ T fill_of(double fill, int64_t bits) {
  if constexpr (std::is_integral<T>::value) {
    return static_cast<T>(bits);
  } else {
    return xrt::round_from<T>(fill);
  }
}

__device__ __forceinline__ int64_t clampi(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

struct IjArgs {
  const void* src;
  const double* map;  // (2, out_h, out_w)
  void* out;
  int64_t batch, src_h, src_w, n_out;
  double fill;
  int64_t fill_bits;
};

template <int M, typename T>
__global__ void __launch_bounds__(kThreads) exact_ij_kernel(const IjArgs a) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= a.n_out) return;
  const T* src = static_cast<const T*>(a.src);
  T* out = static_cast<T*>(a.out);
  const int64_t src_plane = a.src_h * a.src_w;
  const double mi = a.map[p];
  const double mj = a.map[a.n_out + p];
  if (isnan(mi) || isnan(mj)) {
    for (int64_t b = 0; b < a.batch; ++b) out[b * a.n_out + p] = fill_of<T>(a.fill, a.fill_bits);
    return;
  }
  // truncation, as numpy's astype(int64) of the (non-negative) map
  const int64_t i0 = static_cast<int64_t>(mi);
  const int64_t j0 = static_cast<int64_t>(mj);
  const double u = mi - static_cast<double>(i0);
  const double v = mj - static_cast<double>(j0);
  if constexpr (M == xrt::kNearest) {
    const int64_t sp = clampi(v > 0.5 ? j0 + 1 : j0, a.src_h) * a.src_w +
                       clampi(u > 0.5 ? i0 + 1 : i0, a.src_w);
    for (int64_t b = 0; b < a.batch; ++b) out[b * a.n_out + p] = src[b * src_plane + sp];
  } else {
    const int64_t i0c = clampi(i0, a.src_w);
    const int64_t j0c = clampi(j0, a.src_h);
    const int64_t i1 = i0c + 1 > a.src_w - 1 ? a.src_w - 1 : i0c + 1;
    const int64_t j1 = j0c + 1 > a.src_h - 1 ? a.src_h - 1 : j0c + 1;
    for (int64_t b = 0; b < a.batch; ++b) {
      const T* s = src + b * src_plane;
      const double v00 = xrt::to_f64(s[j0c * a.src_w + i0c]);
      const double v01 = xrt::to_f64(s[j0c * a.src_w + i1]);
      const double v10 = xrt::to_f64(s[j1 * a.src_w + i0c]);
      const double v11 = xrt::to_f64(s[j1 * a.src_w + i1]);
      double value;
      if constexpr (M == xrt::kTriangular) {
        value = u + v < 1.0 ? v00 + u * (v01 - v00) + v * (v10 - v00)
                            : v11 + (1.0 - u) * (v10 - v11) + (1.0 - v) * (v01 - v11);
      } else {
        const double vu0 = v00 + u * (v01 - v00);
        const double vu1 = v10 + u * (v11 - v10);
        value = vu0 + v * (vu1 - vu0);
      }
      out[b * a.n_out + p] = host_round<T>(value);
    }
  }
}

struct WinArgs {
  const void* src;
  const double* xx;      // (out_h, out_w) target centres in the source CRS
  const double* yy;
  const int64_t* itab;   // per target tile: the window's (i0, j0), padded
  const double* dtab;    // per target tile: the window origin (x, y)
  void* out;
  int64_t batch, src_h, src_w, out_h, out_w;
  int64_t tile_h, tile_w, n_tiles_x, win_h, win_w, pad_top, pad_left;
  double x_res, neg_y_res, fill;
  int64_t fill_bits;
};

// the tap at (jp, ip) of the padded source: the fill outside the source
template <typename T>
__device__ __forceinline__ T padded_tap(const T* s, int64_t jp, int64_t ip, const WinArgs& a, T fill) {
  const int64_t j = jp - a.pad_top;
  const int64_t i = ip - a.pad_left;
  return (j >= 0 && j < a.src_h && i >= 0 && i < a.src_w) ? s[j * a.src_w + i] : fill;
}

template <int M, typename T>
__global__ void __launch_bounds__(kThreads) exact_win_kernel(const WinArgs a) {
  const int64_t n_out = a.out_h * a.out_w;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n_out) return;
  const int64_t row = p / a.out_w;
  const int64_t col = p - row * a.out_w;
  const int64_t tile = (row / a.tile_h) * a.n_tiles_x + col / a.tile_w;
  const int64_t wi = a.itab[2 * tile];
  const int64_t wj = a.itab[2 * tile + 1];
  const double ix = (a.xx[p] - a.dtab[2 * tile]) / a.x_res;
  const double iy = (a.yy[p] - a.dtab[2 * tile + 1]) / a.neg_y_res;
  const T* src = static_cast<const T*>(a.src);
  T* out = static_cast<T*>(a.out);
  const int64_t src_plane = a.src_h * a.src_w;
  const T fill = fill_of<T>(a.fill, a.fill_bits);
  if constexpr (M == xrt::kNearest) {
    const int64_t jy = wj + clampi(to_i32(rint(iy)), a.win_h);
    const int64_t jx = wi + clampi(to_i32(rint(ix)), a.win_w);
    for (int64_t b = 0; b < a.batch; ++b) {
      out[b * n_out + p] = padded_tap(src + b * src_plane, jy, jx, a, fill);
    }
  } else {
    const double ixf = floor(ix);
    const double iyf = floor(iy);
    const double dx = ix - ixf;
    const double dy = iy - iyf;
    const int64_t x0 = wi + clampi(to_i32(ixf), a.win_w);
    const int64_t y0 = wj + clampi(to_i32(iyf), a.win_h);
    const int64_t x1 = wi + clampi(to_i32(ceil(ix)), a.win_w);
    const int64_t y1 = wj + clampi(to_i32(ceil(iy)), a.win_h);
    for (int64_t b = 0; b < a.batch; ++b) {
      const T* s = src + b * src_plane;
      const T v00 = padded_tap(s, y0, x0, a, fill);
      const T v01 = padded_tap(s, y0, x1, a, fill);
      const T v10 = padded_tap(s, y1, x0, a, fill);
      const T v11 = padded_tap(s, y1, x1, a, fill);
      double value;
      if constexpr (M == xrt::kTriangular) {
        value = dx + dy < 1.0
                    ? xrt::to_f64(v00) + dx * host_diff(v01, v00) + dy * host_diff(v10, v00)
                    : xrt::to_f64(v11) + (1.0 - dx) * host_diff(v10, v11) +
                          (1.0 - dy) * host_diff(v01, v11);
      } else {
        const double u0 = xrt::to_f64(v00) + dx * host_diff(v01, v00);
        const double u1 = xrt::to_f64(v10) + dx * host_diff(v11, v10);
        value = u0 + dy * (u1 - u0);
      }
      out[b * n_out + p] = host_round<T>(value);
    }
  }
}

template <int M>
cudaError_t launch_ij(int code, const IjArgs& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.n_out + kThreads - 1) / kThreads));
  return xrt::with_data_type(code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    exact_ij_kernel<M, T><<<grid, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  });
}

template <int M>
cudaError_t launch_win(int code, const WinArgs& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.out_h * a.out_w + kThreads - 1) / kThreads));
  return xrt::with_data_type(code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if constexpr (std::is_same<T, bool>::value && M != xrt::kNearest) {
      return cudaErrorInvalidValue;
    } else {
      exact_win_kernel<M, T><<<grid, kThreads, 0, s>>>(a);
      return cudaGetLastError();
    }
  });
}

template <typename L>
cudaError_t by_method(int method, L&& launch) {
  switch (method) {
    case xrt::kBilinear: return launch(std::integral_constant<int, xrt::kBilinear>{});
    case xrt::kNearest: return launch(std::integral_constant<int, xrt::kNearest>{});
    case xrt::kTriangular: return launch(std::integral_constant<int, xrt::kTriangular>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src (batch, src_h, src_w) and out (batch, out_h, out_w) of data type
// `code`; ij_map (2, out_h, out_w) float64; fill representable in the type.
extern "C" int xrt_exact_gather_ij(
    const void* src, const double* ij_map, void* out, int64_t batch, int64_t src_h,
    int64_t src_w, int64_t out_h, int64_t out_w, int method, double fill, int64_t fill_bits,
    int code, void* stream) {
  if (batch < 1 || src_h < 1 || src_w < 1 || out_h < 1 || out_w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const IjArgs a{src, ij_map, out, batch, src_h, src_w, out_h * out_w, fill, fill_bits};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_method(method, [&](auto m) {
    return launch_ij<decltype(m)::value>(code, a, s);
  }));
}

// src (batch, src_h, src_w) and out (batch, out_h, out_w) of data type
// `code`; xx, yy (out_h, out_w) float64; itab, dtab (n_tiles, 2), row-major
// over the target's tiles of tile_h x tile_w; windows of win_h x win_w in
// the source padded by pad_top rows and pad_left columns.
extern "C" int xrt_exact_gather_windows(
    const void* src, const double* xx, const double* yy, const int64_t* itab,
    const double* dtab, void* out, int64_t batch, int64_t src_h, int64_t src_w,
    int64_t out_h, int64_t out_w, int64_t tile_h, int64_t tile_w, int64_t n_tiles_x,
    int64_t win_h, int64_t win_w, int64_t pad_top, int64_t pad_left, double x_res,
    double neg_y_res, int method, double fill, int64_t fill_bits, int code, void* stream) {
  if (batch < 1 || src_h < 1 || src_w < 1 || out_h < 1 || out_w < 1 || tile_h < 1 ||
      tile_w < 1 || win_h < 1 || win_w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WinArgs a{src, xx, yy, itab, dtab, out, batch, src_h, src_w, out_h, out_w,
                  tile_h, tile_w, n_tiles_x, win_h, win_w, pad_top, pad_left,
                  x_res, neg_y_res, fill, fill_bits};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_method(method, [&](auto m) {
    return launch_win<decltype(m)::value>(code, a, s);
  }));
}
