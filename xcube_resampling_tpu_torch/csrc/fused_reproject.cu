// K3: the fused direct reprojection gather.
//
// For each target pixel (j, i):
//   1. bilinearly interpolate the coarse fractional source-index fields
//      ix_c, iy_c (one sample every `step` target pixels);
//   2. valid = ix, iy inside (-0.5, n - 0.5);
//   3. clamp ix, iy to the source extent;
//   4. take the nearest, bilinear or triangular 4-tap gather;
//   5. out = valid ? value : fill.
//
// Replaces the XLA kernel of xcube_resampling_tpu/ops/reproject_ops.py:
// make_fused_reproject_fn (:170-176: _interp_field :65-105 and
// gather_interp :108-147).  It is the exact tier: the port runs it where
// the tiled SRW plan is refused or XRTPU_EXACT=1.
//
// Bound on the H100: device memory and the gather's scattered reads.  Per
// target pixel it reads four source values per band (neighbouring pixels
// read neighbouring source pixels for mild warps, so most reads hit L1/L2)
// and writes one value per band; the coarse fields are small and stay in
// L2.  Design: one thread per (j, i) with i fastest; the field
// interpolation, mask and tap offsets are computed once and reused for
// every band; the field interpolation is srw_common.h's, shared with K1
// and K2.  64-bit offsets.
#include "srw_common.h"

namespace {

__global__ void fused_reproject_kernel(
    const float* __restrict__ src, const float* __restrict__ ix_c,
    const float* __restrict__ iy_c, float* __restrict__ out, int64_t batch,
    int64_t src_h, int64_t src_w, int64_t ncj, int64_t nci, int64_t out_h,
    int64_t out_w, float inv, int method, float fill) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= out_w) return;
  const float col = static_cast<float>(i);
  // the bounds in float32, as the JAX package compares them
  const float x_hi = static_cast<float>(static_cast<double>(src_w) - 0.5);
  const float y_hi = static_cast<float>(static_cast<double>(src_h) - 0.5);
  const float x_max = static_cast<float>(src_w - 1);
  const float y_max = static_cast<float>(src_h - 1);
  for (int64_t j = blockIdx.y; j < out_h; j += gridDim.y) {
    const float row = static_cast<float>(j);
    float ix = xrt::interp_field(ix_c, ncj, nci, row, col, inv);
    float iy = xrt::interp_field(iy_c, ncj, nci, row, col, inv);
    const bool ok = ix > -0.5f && ix < x_hi && iy > -0.5f && iy < y_hi;
    ix = fminf(fmaxf(ix, 0.0f), x_max);
    iy = fminf(fmaxf(iy, 0.0f), y_max);
    int64_t x0, y0, x1 = 0, y1 = 0;
    float fx = 0.0f, fy = 0.0f;
    if (method == xrt::kNearest) {
      x0 = static_cast<int64_t>(rintf(ix));
      y0 = static_cast<int64_t>(rintf(iy));
    } else {
      const float x0f = floorf(ix);
      const float y0f = floorf(iy);
      fx = ix - x0f;
      fy = iy - y0f;
      x0 = static_cast<int64_t>(x0f);
      y0 = static_cast<int64_t>(y0f);
      x1 = xrt::clamp_index(x0 + 1, src_w);
      y1 = xrt::clamp_index(y0 + 1, src_h);
    }
    for (int64_t b = 0; b < batch; ++b) {
      const float* plane = src + b * src_h * src_w;
      float val;
      if (method == xrt::kNearest) {
        val = plane[y0 * src_w + x0];
      } else {
        const float v00 = plane[y0 * src_w + x0];
        const float v01 = plane[y0 * src_w + x1];
        const float v10 = plane[y1 * src_w + x0];
        const float v11 = plane[y1 * src_w + x1];
        if (method == xrt::kTriangular) {
          const float v_near = fmaf(fy, v10 - v00, xrt::lerp(v00, v01, fx));
          const float v_far = fmaf(1.0f - fy, v01 - v11,
                                   xrt::lerp(v11, v10, 1.0f - fx));
          val = fx + fy < 1.0f ? v_near : v_far;
        } else {
          val = xrt::lerp(xrt::lerp(v00, v01, fx), xrt::lerp(v10, v11, fx), fy);
        }
      }
      out[(b * out_h + j) * out_w + i] = ok ? val : fill;
    }
  }
}

}  // namespace

extern "C" int xrt_fused_reproject_f32(
    const float* src, const float* ix_c, const float* iy_c, float* out,
    int64_t batch, int64_t src_h, int64_t src_w, int64_t ncj, int64_t nci,
    int64_t out_h, int64_t out_w, int step, int method, float fill,
    void* stream) {
  const float inv = static_cast<float>(1.0 / step);
  const dim3 block(256);
  const dim3 grid(static_cast<unsigned>((out_w + 255) / 256),
                  static_cast<unsigned>(out_h < 65535 ? out_h : 65535));
  fused_reproject_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      src, ix_c, iy_c, out, batch, src_h, src_w, ncj, nci, out_h, out_w, inv,
      method, fill);
  return static_cast<int>(cudaGetLastError());
}
