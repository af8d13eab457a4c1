// K2: the SRW horizontal tap pass, the triangular correction and the fill.
//
//   acc   = sum_{d < d_h} w(pos_h[j, i], base + d)  * v[b, j, clamp(base + d)]
//   acc_d = sum_{d < d_h} dw(pos_h[j, i], base + d) * vd[b, j, clamp(base + d)]
//   out[b, j, i] = valid[j, i] ? (triangular ? acc - s[j, i] * acc_d : acc) : fill
//   with base = base_h[j / row_tile, i].
//
// Replaces the XLA horizontal pass of xcube_resampling_tpu/ops/srw.py:
// make_srw_fn (:670-695).
//
// Bound on the H100: device memory.  Per output element it reads pos_h,
// base_h, valid (and s) once, d_h values of the row of v, and writes the
// output once.  Design: one thread per (j, i) with i fastest, looping over
// the band axis so the geometry is read once for all bands.  Neighbouring
// threads tap neighbouring columns of the same row of v, so the tap reads
// coalesce and the overlap between taps hits L1.  64-bit offsets.
#include "srw_common.h"

namespace {

__global__ void srw_horizontal_kernel(
    const float* __restrict__ v, const float* __restrict__ vd,
    const float* __restrict__ pos, const int32_t* __restrict__ base,
    const uint8_t* __restrict__ valid, const float* __restrict__ s,
    float* __restrict__ out, int64_t batch, int64_t out_h, int64_t out_w,
    int64_t src_w, int64_t row_tile, int d_h, int method, float fill) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= out_w) return;
  for (int64_t j = blockIdx.y; j < out_h; j += gridDim.y) {
    const int64_t g = j * out_w + i;
    const float p = pos[g];
    const int64_t b0 = base[(j / row_tile) * out_w + i];
    const bool ok = valid[g] != 0;
    const float sv = vd != nullptr ? s[g] : 0.0f;
    for (int64_t b = 0; b < batch; ++b) {
      const int64_t row = (b * out_h + j) * src_w;
      float acc = 0.0f;
      float acc_d = 0.0f;
      for (int d = 0; d < d_h; ++d) {
        const float k = static_cast<float>(b0 + d);
        const int64_t col = row + xrt::clamp_index(b0 + d, src_w);
        acc = fmaf(xrt::tap_weight(p, k, method), v[col], acc);
        if (vd != nullptr) acc_d = fmaf(xrt::tap_dweight(p, k), vd[col], acc_d);
      }
      if (vd != nullptr) acc = fmaf(-sv, acc_d, acc);
      out[(b * out_h + j) * out_w + i] = ok ? acc : fill;
    }
  }
}

}  // namespace

extern "C" int xrt_srw_horizontal_f32(
    const float* v, const float* vd, const float* pos_h, const int32_t* base_h,
    const uint8_t* valid, const float* s, float* out, int64_t batch,
    int64_t out_h, int64_t out_w, int64_t src_w, int64_t row_tile, int d_h,
    int method, float fill, void* stream) {
  const dim3 block(256);
  const dim3 grid(static_cast<unsigned>((out_w + 255) / 256),
                  static_cast<unsigned>(out_h < 65535 ? out_h : 65535));
  srw_horizontal_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      v, vd, pos_h, base_h, valid, s, out, batch, out_h, out_w, src_w,
      row_tile, d_h, method, fill);
  return static_cast<int>(cudaGetLastError());
}
