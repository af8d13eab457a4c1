// The arithmetic of the separable affine gather, shared by K4
// (affine_gather.cu) and its downscale form (affine_gather_reduce.cu), so
// that both sample the source with the same operations in the same order.
//
// Output row j samples the source at y = j * j_scale + j_off, column i at
// x = i * i_scale + i_off (float64).
//   bilinear: floor and fraction, taps y0, y0 + 1 (and x0, x0 + 1) clipped
//     to the source, valid on [0, n - 1] inclusive; rows first,
//     r0 * (1 - fy) + r1 * fy at both tap columns, then the columns, every
//     operation rounded in float64 (built with -fmad=false, nothing is
//     contracted), all four taps always summed, so a NaN neighbour reaches
//     the output as in the JAX package;
//   nearest: floor(y + 0.5) clipped, valid on [-0.5, n - 0.5] inclusive.
// Each axis is taken once per row or column (Axis); the kernels take each
// row lerp (row_lerp) once for the outputs that share its column, which
// gives the bits of lerps taken afresh for every output.
#pragma once

#include "kernel_types.h"

namespace xrt {

// One axis of one output row or column: the tap index (bilinear: the lower
// of two, the upper being min(t0 + 1, n - 1)), the fraction f and 1 - f,
// and whether the position lies inside the source.
template <typename I>
struct Axis {
  I t0;
  double f, g;
  bool ok;
};

template <typename I>
__device__ __forceinline__ I imin(I a, I b) {
  return a < b ? a : b;
}

template <typename I>
__device__ __forceinline__ I clip_index(double f, int64_t n) {
  return static_cast<I>(fmin(fmax(f, 0.0), static_cast<double>(n - 1)));
}

// Output index k on an axis of n source pixels (bilinear).
template <typename I>
__device__ __forceinline__ Axis<I> bilinear_axis(int64_t k, double scale, double off,
                                                 int64_t n) {
  const double p = static_cast<double>(k) * scale + off;
  const double p0 = floor(p);
  Axis<I> a;
  a.ok = p >= 0.0 && p <= static_cast<double>(n - 1);
  a.f = p - p0;
  a.g = 1.0 - a.f;
  a.t0 = clip_index<I>(p0, n);
  return a;
}

// Output index k on an axis of n source pixels (nearest).
template <typename I>
__device__ __forceinline__ Axis<I> nearest_axis(int64_t k, double scale, double off,
                                                int64_t n) {
  const double p = static_cast<double>(k) * scale + off;
  Axis<I> a;
  a.ok = p >= -0.5 && p <= static_cast<double>(n) - 0.5;
  a.f = a.g = 0.0;
  a.t0 = clip_index<I>(floor(p + 0.5), n);
  return a;
}

// The row lerp of source pixels t0 (row y0) and t1 (row y1) of one column:
// the first step of a bilinear value, rows first at both tap columns, then
// the columns (the order of the JAX package's separable gather).
template <typename T>
__device__ __forceinline__ double row_lerp(T t0, T t1, double fy, double gy) {
  return to_f64(t0) * gy + to_f64(t1) * fy;
}

// The blocks down a grid of *cols* blocks across: as many as the card's
// SMs hold in one wave at the kernel's occupancy (a second, partial wave
// would take as long as the first), at least 1, at most *need* and 65535.
template <typename K>
__host__ inline cudaError_t wave_rows(K kernel, int threads, size_t smem, int64_t cols,
                                      int64_t need, unsigned* rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (e != cudaSuccess) return e;
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  int64_t r = slots / cols > 1 ? slots / cols : 1;
  r = r < need ? r : need;
  *rows = static_cast<unsigned>(r < 65535 ? r : 65535);
  return cudaSuccess;
}

}  // namespace xrt
