// K2 on float64: the SRW horizontal tap pass of a float64 source, and of
// its band form (K2's function, srw_horizontal.cu, on the float64 v and vd
// K1 writes for float64 sources).
//
// The JAX package's tiled SRW (xcube_resampling_tpu/ops/srw.py:670-695)
// multiplies its float32 weights by the vertical pass's values: for a
// float64 source those are float64, so the products and the sums are
// float64 (jnp promotes float32 * float64), and so is the output.  Each
// tap is one fused multiply-add in float64 with the float32 weight widened,
// every d_h taps summed (zero-weight taps included, so a NaN reaches the
// outputs whose taps read it); the triangular correction acc - s * acc_d
// the same; the fill where the position lies outside the source.  The
// positions, the mask and s are K2's float32 geometry (FieldColumn, the
// operations of srw_common.h's FieldCols).
//
// Bound on the H100: device memory (v read once, the output written once).
// Design, the simplest that is right: a thread an output pixel, its taps
// read through L1 (a warp's 32 neighbouring columns read overlapping runs
// of one v row), the bands in a loop so that the geometry is taken once.
#include "srw_common.h"

namespace {

constexpr int kThreads = 128;

struct Args {
  const double* v;
  const double* vd;
  const float* ix_c;
  const float* iy_c;
  const int32_t* base;  // (tiles, out_w)
  double* out;
  int64_t batch, out_h, out_w, src_h, src_w, ncj, nci, row_tile, tiles, row0;
  float inv;
  double fill;
  int d_h;
};

template <int M>
__global__ void __launch_bounds__(kThreads) srw_horizontal_f64_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.out_w) return;
  xrt::FieldColumn fx(a.ix_c, a.ncj, a.nci, static_cast<float>(i), a.inv);
  xrt::FieldColumn fy(a.iy_c, a.ncj, a.nci, static_cast<float>(i), a.inv);
  const float x_hi = static_cast<float>(static_cast<double>(a.src_w) - 0.5);
  const float y_hi = static_cast<float>(static_cast<double>(a.src_h) - 0.5);
  for (int64_t j = blockIdx.y; j < a.out_h; j += gridDim.y) {
    const float row = static_cast<float>(a.row0 + j);
    const float p = fx.at(row);
    const float iy = fy.at(row);
    const bool ok = p > -0.5f && p < x_hi && iy > -0.5f && iy < y_hi;
    float corr = 0.0f;
    if (M == xrt::kTriangular) {
      const float u = p - floorf(p);
      const float vf = iy - floorf(iy);
      corr = fminf(u * vf, (1.0f - u) * (1.0f - vf));
    }
    const int64_t t = j / a.row_tile < a.tiles ? j / a.row_tile : a.tiles - 1;
    const int b0 = a.base[t * a.out_w + i];
    const float fp = floorf(p);
    const float rp = rintf(p);
    for (int64_t b = 0; b < a.batch; ++b) {
      const double* vr = a.v + (b * a.out_h + j) * a.src_w;
      const double* vdr = M == xrt::kTriangular ? a.vd + (b * a.out_h + j) * a.src_w : nullptr;
      double acc = 0.0;
      double acc_d = 0.0;
      float k = static_cast<float>(b0);  // k += 1.0f is exact below 2^24
      for (int d = 0; d < a.d_h; ++d) {
        const int64_t c = xrt::clamp_index(b0 + d, a.src_w);
        const float w = M == xrt::kNearest ? (rp == k ? 1.0f : 0.0f)
                                           : fmaxf(0.0f, 1.0f - fabsf(p - k));
        acc = xrt::fused_v(w, vr[c], acc);
        if (M == xrt::kTriangular) {
          const float dw = (fp == k ? 1.0f : 0.0f) - (fp + 1.0f == k ? 1.0f : 0.0f);
          acc_d = xrt::fused_v(dw, vdr[c], acc_d);
        }
        k += 1.0f;
      }
      if (M == xrt::kTriangular) acc = xrt::fused_v(-corr, acc_d, acc);
      a.out[(b * a.out_h + j) * a.out_w + i] = ok ? acc : a.fill;
    }
  }
}

}  // namespace

// K2 on float64 and its band form: v (and vd for triangular) (batch, out_h,
// src_w) float64 holding the band's rows from global row row0 (0 for K2);
// base_h (tiles, out_w), the tile of row j min(j / row_tile, tiles - 1);
// out (batch, out_h, out_w) float64.
extern "C" int xrt_srw_horizontal_f64(
    const double* v, const double* vd, const float* ix_c, const float* iy_c,
    const int32_t* base_h, double* out, int64_t batch, int64_t out_h, int64_t out_w,
    int64_t src_h, int64_t src_w, int64_t ncj, int64_t nci, int step, int64_t row_tile,
    int64_t tiles, int d_h, int method, double fill, int64_t row0, void* stream) {
  if (batch < 1 || out_h < 1 || out_w < 1 || src_w < 1 || row_tile < 1 || tiles < 1 ||
      step < 1 || d_h < 1 || row0 < 0 || ncj < 2 || nci < 2 ||
      (method == xrt::kTriangular) != (vd != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{v, vd, ix_c, iy_c, base_h, out, batch, out_h, out_w, src_h, src_w, ncj, nci,
               row_tile, tiles, row0, static_cast<float>(1.0 / step), fill, d_h};
  const dim3 grid(static_cast<unsigned>((out_w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(out_h < 65535 ? out_h : 65535));
  const auto s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case xrt::kBilinear: srw_horizontal_f64_kernel<xrt::kBilinear><<<grid, kThreads, 0, s>>>(a); break;
    case xrt::kNearest: srw_horizontal_f64_kernel<xrt::kNearest><<<grid, kThreads, 0, s>>>(a); break;
    case xrt::kTriangular:
      srw_horizontal_f64_kernel<xrt::kTriangular><<<grid, kThreads, 0, s>>>(a);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
