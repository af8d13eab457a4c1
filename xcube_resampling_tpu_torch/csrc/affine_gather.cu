// K4: the separable affine gather.
//
// For each output pixel (b, j, i) the source plane b is sampled at
//   y = j * j_scale + j_off,  x = i * i_scale + i_off   (float64)
// nearest: floor(y + 0.5) clipped, valid on [-0.5, n - 0.5] inclusive, the
//   value copied in its own type;
// bilinear: floor and fraction, taps y0, y0 + 1 (and x0, x0 + 1) clipped to
//   the source, valid on [0, n - 1] inclusive; rows first,
//   r0 * (1 - fy) + r1 * fy at both tap columns, then the columns, every
//   operation rounded in float64 (built with -fmad=false, nothing is
//   contracted), all four taps always summed, so a NaN neighbour reaches
//   the output as in the JAX package;
// outside: the fill (cast by the wrapper to the source type for nearest,
//   to its float type for bilinear).  The bilinear result is rounded once
//   on store: to the source type (rint and saturation for integers) or
//   kept in float64 (the two-pass NaN recovery divides it).
//
// Replaces the XLA device path of xcube_resampling_tpu/ops/gather.py:
// affine_gather and grid_gather_separable's separable branches (:29-143),
// which run eagerly under x64: positions and lerps in float64.  Hopper
// runs float64 natively (half its float32 rate), so the kernel keeps that
// arithmetic and agrees with it bit for bit.  These are not K3's edge
// conventions (K3 selects the fill outside the open interval
// (-0.5, n - 0.5)), so nothing of srw_common.h is shared.
//
// Bound on the H100: device memory.  The work must read the source pixels
// its taps reach once and write every output once; a pixel takes about 20
// float64 operations, far below the float64 rate.  Design: a thread owns
// one output column (its x part computed once) and walks kRows rows of a
// row block, kLanes apart, computing each row's y part once for every
// band; neighbouring threads take neighbouring columns, so at scales near
// 1 a warp's tap reads and its stores are coalesced, and the second tap
// row is read again from L1/L2.  The source may be strided: the wrapper
// passes its plane and row pitches (a clipped view of a large raster is
// read in place).  Offsets are 64-bit.
#include "kernel_types.h"

namespace {

constexpr int kCols = 64;   // threads across a block: output columns
constexpr int kLanes = 4;   // threads down a block
constexpr int kRows = 16;   // output rows of a row block

struct Args {
  const void* src;
  void* out;
  int64_t batch, src_h, src_w, pitch_b, pitch_h, out_h, out_w, n_row_blocks;
  double j_scale, i_scale, j_off, i_off, fill;
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int64_t clip(double f, int64_t n) {
  return static_cast<int64_t>(fmin(fmax(f, 0.0), static_cast<double>(n - 1)));
}

template <typename T, typename O, int ORDER>
__global__ void __launch_bounds__(kCols * kLanes) affine_gather_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x;
  if (i >= a.out_w) return;
  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out);
  const int64_t out_plane = a.out_h * a.out_w;
  const double x = static_cast<double>(i) * a.i_scale + a.i_off;
  for (int64_t rb = blockIdx.y; rb < a.n_row_blocks; rb += gridDim.y) {
    const int64_t j1 = lmin((rb + 1) * kRows, a.out_h);
    for (int64_t j = rb * kRows + threadIdx.y; j < j1; j += kLanes) {
      const double y = static_cast<double>(j) * a.j_scale + a.j_off;
      O* o = out + j * a.out_w + i;
      if (ORDER == 0) {
        const bool ok = y >= -0.5 && y <= static_cast<double>(a.src_h) - 0.5 &&
                        x >= -0.5 && x <= static_cast<double>(a.src_w) - 0.5;
        const int64_t off = clip(floor(y + 0.5), a.src_h) * a.pitch_h +
                            clip(floor(x + 0.5), a.src_w);
        const O fill = static_cast<O>(a.fill);
        for (int64_t b = 0; b < a.batch; ++b) {
          o[b * out_plane] = ok ? static_cast<O>(src[b * a.pitch_b + off]) : fill;
        }
        continue;
      }
      const bool ok = y >= 0.0 && y <= static_cast<double>(a.src_h - 1) &&
                      x >= 0.0 && x <= static_cast<double>(a.src_w - 1);
      const double y0f = floor(y);
      const double x0f = floor(x);
      const double fy = y - y0f;
      const double fx = x - x0f;
      const double gy = 1.0 - fy;
      const double gx = 1.0 - fx;
      const int64_t y0 = clip(y0f, a.src_h);
      const int64_t x0 = clip(x0f, a.src_w);
      const int64_t r0 = y0 * a.pitch_h;
      const int64_t r1 = lmin(y0 + 1, a.src_h - 1) * a.pitch_h;
      const int64_t x1 = lmin(x0 + 1, a.src_w - 1);
      for (int64_t b = 0; b < a.batch; ++b) {
        const T* p = src + b * a.pitch_b;
        // the row lerp at both tap columns, then the column lerp
        const double c0 = static_cast<double>(p[r0 + x0]) * gy +
                          static_cast<double>(p[r1 + x0]) * fy;
        const double c1 = static_cast<double>(p[r0 + x1]) * gy +
                          static_cast<double>(p[r1 + x1]) * fy;
        const double v = c0 * gx + c1 * fx;
        o[b * out_plane] = xrt::round_from<O>(ok ? v : a.fill);
      }
    }
  }
}

template <typename T, typename O>
cudaError_t launch(const Args& a, int order, cudaStream_t s) {
  const dim3 block(kCols, kLanes);
  const dim3 grid(static_cast<unsigned>((a.out_w + kCols - 1) / kCols),
                  static_cast<unsigned>(a.n_row_blocks < 65535 ? a.n_row_blocks : 65535));
  if (order == 0) {
    affine_gather_kernel<T, O, 0><<<grid, block, 0, s>>>(a);
  } else {
    affine_gather_kernel<T, O, 1><<<grid, block, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// order 0 (nearest, out_code == in_code) or 1 (bilinear, out_code the
// source's or float64); pitches in elements; returns cudaGetLastError().
extern "C" int xrt_affine_gather(
    const void* src, void* out, int64_t batch, int64_t src_h, int64_t src_w,
    int64_t pitch_b, int64_t pitch_h, int64_t out_h, int64_t out_w,
    double j_scale, double i_scale, double j_off, double i_off, int order,
    double fill, int in_code, int out_code, void* stream) {
  if (batch < 1 || src_h < 1 || src_w < 1 || out_h < 1 || out_w < 1 ||
      (order != 0 && order != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{src, out, batch, src_h, src_w, pitch_b, pitch_h, out_h, out_w,
               (out_h + kRows - 1) / kRows, j_scale, i_scale, j_off, i_off, fill};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(xrt::with_data_type(in_code, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    if (out_code == xrt::code_of<T>()) return launch<T, T>(a, order, s);
    if (out_code == xrt::kF64 && order == 1) return launch<T, double>(a, order, s);
    return cudaErrorInvalidValue;
  }));
}
