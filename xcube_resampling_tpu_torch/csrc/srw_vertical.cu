// K1: the SRW vertical tap pass.
//
//   v[b, j, c]  = sum_{d < d_v} w(pos_v[j, c], base + d)  * src[b, clamp(base + d), c]
//   vd[b, j, c] = sum_{d < d_v} dw(pos_v[j, c], base + d) * src[b, clamp(base + d), c]
//   with base = base_v[j, c / col_tile]; vd only for triangular.
//
// Replaces the Pallas kernel xcube_resampling_tpu/ops/pallas_kernels.py:
// srw_vertical_pallas and the XLA taps of ops/srw.py:make_srw_fn
// (:647-668).  It follows the XLA taps' semantics: exactly d_v taps from
// base, zero-weight taps included, so a NaN source row reaches exactly the
// outputs whose taps read it.
//
// Bound on the H100: device memory.  Per output element it reads pos_v
// once and d_v source values, and writes v once; the source reads of
// neighbouring output rows overlap and mostly hit L1/L2.  Design: one
// thread per (j, c) with c fastest, so reads of src and pos_v and writes of
// v are coalesced; the thread loops over the band axis so pos_v and the
// base are read once for all bands; one launch covers every column tile
// (the JAX path runs one kernel per tile).  The TPU kernel's 8-aligned
// VMEM windows and edge padding are not carried over: the clamp does the
// padding.  Offsets are 64-bit: a 20480^2 raster with 6 bands passes 2^31
// elements.  Staging the source window in shared memory is later work.
#include "srw_common.h"

namespace {

__global__ void srw_vertical_kernel(
    const float* __restrict__ src, const float* __restrict__ pos,
    const int32_t* __restrict__ base, float* __restrict__ v,
    float* __restrict__ vd, int64_t batch, int64_t src_h, int64_t src_w,
    int64_t out_h, int64_t n_col_tiles, int64_t col_tile, int d_v,
    int method) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= src_w) return;
  const int64_t tile = c / col_tile;
  for (int64_t j = blockIdx.y; j < out_h; j += gridDim.y) {
    const float p = pos[j * src_w + c];
    const int64_t b0 = base[j * n_col_tiles + tile];
    for (int64_t b = 0; b < batch; ++b) {
      const float* plane = src + b * src_h * src_w;
      float acc = 0.0f;
      float acc_d = 0.0f;
      for (int d = 0; d < d_v; ++d) {
        const float k = static_cast<float>(b0 + d);
        const float s = plane[xrt::clamp_index(b0 + d, src_h) * src_w + c];
        acc = fmaf(xrt::tap_weight(p, k, method), s, acc);
        if (vd != nullptr) acc_d = fmaf(xrt::tap_dweight(p, k), s, acc_d);
      }
      const int64_t o = (b * out_h + j) * src_w + c;
      v[o] = acc;
      if (vd != nullptr) vd[o] = acc_d;
    }
  }
}

}  // namespace

extern "C" int xrt_srw_vertical_f32(
    const float* src, const float* pos_v, const int32_t* base_v, float* v,
    float* vd, int64_t batch, int64_t src_h, int64_t src_w, int64_t out_h,
    int64_t n_col_tiles, int64_t col_tile, int d_v, int method,
    void* stream) {
  const dim3 block(256);
  const dim3 grid(static_cast<unsigned>((src_w + 255) / 256),
                  static_cast<unsigned>(out_h < 65535 ? out_h : 65535));
  srw_vertical_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      src, pos_v, base_v, v, vd, batch, src_h, src_w, out_h, n_col_tiles,
      col_tile, d_v, method);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
