// K7: rectify's device Phase B gather through a fractional (i, j) map.
//
// Replaces the XLA kernels of xcube_resampling_tpu/ops/rectify_ops.py:
// make_device_var_image_fn: `kernel` (:2752-2759, gather_interp at the
// float32 positions cast from the map, valid where the map is not NaN) and
// the edge-band gather of `fn_srw` (:2731-2742, gather_interp at a list of
// pixels, valid by the bounds rule, written into the SRW interior's
// output).  Two forms, one kernel:
//   * the map form: pixel k of the (h, w) map, valid[k] from the map;
//   * the list form: pixel k of a list, written at (rows[k], cols[k]) of the
//     output, valid where its position lies inside (-0.5, n - 0.5).
// Every band of a (B, H, W) source goes through one launch.  The taps, the
// clamp and the lerps are K3's (gather_taps.h), so the rounding is the
// same; data types are the seven of the affine engine, with gather_interp's
// output types (the source type for nearest, float64 for float64 sources,
// float32 otherwise).
//
// Bound on the H100: device memory.  A pixel reads its two float32
// positions and its mask once and its four taps per band (neighbouring
// pixels share most taps, through L1/L2), and writes one value per band.
// Design: one thread a pixel, the bands in a loop, so the position, the
// clamp and the tap offsets are computed once for every band.  Offsets
// inside a plane are 32-bit (the wrapper refuses planes of 2^31 elements
// or more), band offsets 64-bit.
#include "gather_taps.h"
#include "kernel_types.h"

namespace {

constexpr int kThreads = 256;

struct Args {
  const void* src;
  const float* ix;
  const float* iy;
  const uint8_t* valid;  // map form: the map's mask; list form: nullptr
  const int* rows;       // list form: the output pixel of each position
  const int* cols;
  void* out;
  int64_t n;             // positions
  int64_t batch;
  int64_t out_w;         // list form: the output's row length
  int64_t out_plane;     // output elements a band
  xrt::TapBounds tb;
  double fill;
};

template <int M, typename T>
__global__ void __launch_bounds__(kThreads) ij_gather_kernel(const Args a) {
  using O = xrt::GatherOut<M, T>;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= a.n) return;
  xrt::Taps t = xrt::taps<M>(a.ix[k], a.iy[k], a.tb);
  int64_t o = k;
  if (a.rows != nullptr) {
    o = static_cast<int64_t>(a.rows[k]) * a.out_w + a.cols[k];
  } else {
    t.ok = a.valid[k] != 0;
  }
  const T* src = static_cast<const T*>(a.src);
  O* out = static_cast<O*>(a.out);
  const int64_t src_plane = static_cast<int64_t>(a.tb.src_h) * a.tb.src_w;
  const O fill = static_cast<O>(a.fill);
  for (int64_t b = 0; b < a.batch; ++b) {
    out[b * a.out_plane + o] = t.ok ? xrt::gather_t<M, T>(src + b * src_plane, t) : fill;
  }
}

template <int M>
cudaError_t launch(int code, const Args& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.n + kThreads - 1) / kThreads));
  return xrt::with_data_type(code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    ij_gather_kernel<M, T><<<grid, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  });
}

}  // namespace

// src (batch, src_h, src_w) of data type `code`; ix, iy (n) float32
// positions; map form: valid (n) bytes, rows = cols = nullptr, out (batch,
// n); list form: valid = nullptr, rows, cols (n) int32, out (batch,
// out_plane / out_w, out_w).  out's type: the source type for nearest,
// float64 for float64 sources, float32 otherwise.
extern "C" int xrt_ij_gather(
    const void* src, const float* ix, const float* iy, const uint8_t* valid,
    const int* rows, const int* cols, void* out, int64_t n, int64_t batch,
    int64_t src_h, int64_t src_w, int64_t out_w, int64_t out_plane, int method,
    double fill, int code, void* stream) {
  constexpr int64_t kMaxPlane = (int64_t{1} << 31) - 1;
  if (src_h * src_w > kMaxPlane || src_h < 1 || src_w < 1 || batch < 1 || n < 1 ||
      n > kMaxPlane || (rows == nullptr) != (cols == nullptr) ||
      (rows == nullptr) == (valid == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{src, ix, iy, valid, rows, cols, out, n, batch, out_w, out_plane,
               xrt::tap_bounds(src_h, src_w), fill};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (method) {
    case xrt::kBilinear: rc = launch<xrt::kBilinear>(code, a, s); break;
    case xrt::kNearest: rc = launch<xrt::kNearest>(code, a, s); break;
    case xrt::kTriangular: rc = launch<xrt::kTriangular>(code, a, s); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}
