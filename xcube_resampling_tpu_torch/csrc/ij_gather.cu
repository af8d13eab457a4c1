// K7: rectify's device Phase B gather through a fractional (i, j) map.
//
// Replaces the XLA kernels of xcube_resampling_tpu/ops/rectify_ops.py:
// make_device_var_image_fn: `kernel` (:2752-2759, gather_interp at the
// float32 positions cast from the map, valid where the map is not NaN) and
// the edge-band gather of `fn_srw` (:2731-2742, gather_interp at a list of
// pixels, valid by the bounds rule, written into the SRW interior's
// output).  Two forms, one kernel:
//   * the map form: pixel k of the (h, w) map, valid from the map;
//   * the list form: pixel k of a list, written at (rows[k], cols[k]) of the
//     output, valid where its position lies inside (-0.5, n - 0.5).
// Every band of a (B, H, W) source goes through one launch.  The taps, the
// clamp and the lerps are K3's (gather_taps.h), so the rounding is the
// same; data types are the seven of the affine engine, with gather_interp's
// output types (the source type for nearest, float64 for float64 sources,
// float32 otherwise).
//
// Bound on the H100: device memory.  A pixel reads its two float32
// positions and its mask once and its taps in every band, and writes one
// value a band; neighbouring pixels share most taps.  What held the first
// design (one thread a pixel, the bands one after another) at 2.3x the
// bound for bilinear and triangular: 61 registers a thread, so an SM held
// half its 2048 threads, each with one band's four tap loads in flight:
// too few loads in flight to cover the latency.  Design: one thread a
// pixel over kThreads consecutive pixels of the flattened map (or of the
// list) a block; a thread gathers kBands = 2 bands at a time, all their
// tap loads issued before the lerps and the stores (source and output
// restrict); __launch_bounds__ caps a float32 kernel at 32 registers, so
// that every SM runs 2048 threads (the other types at 64, where 32 would
// spill).  The position, the clamp and the tap offsets are computed once
// for all bands.  Blocks over 2D tiles of the map, meant to keep the tap
// rows of neighbouring output rows in one SM's L1, were measured and
// dropped: no gain for bilinear, up to a third lost for nearest, whose
// stores then straddle rows.  Offsets inside a plane are 32-bit (the
// wrapper refuses planes of 2^31 elements or more), band offsets 64-bit.
#include "gather_taps.h"
#include "kernel_types.h"

namespace {

// consecutive pixels of the flattened map (or of the list) a block
constexpr int kThreads = 256;
// bands a thread gathers with their tap loads issued together
constexpr int kBands = 2;
// blocks an SM must hold for float32 sources: caps the registers at 65536
// / (kThreads * kMinBlocks), 32 a thread, so that every SM runs 2048
// threads; half as many for the other types, whose taps and conversions
// would spill in 32
constexpr int kMinBlocks = 8;

struct Args {
  const void* src;
  const float* ix;
  const float* iy;
  const uint8_t* valid;  // map form: the map's mask; list form: nullptr
  const int* rows;       // list form: the output pixel of each position
  const int* cols;
  void* out;
  int n;                 // positions
  int batch;
  int out_w;             // list form: the output's row length
  int64_t out_plane;     // output elements a band
  int64_t src_plane;     // source elements a band
  xrt::TapBounds tb;
  double fill;
};

template <int M, typename T>
__global__ void __launch_bounds__(kThreads,
                                  std::is_same<T, float>::value ? kMinBlocks : (kMinBlocks + 1) / 2)
    ij_gather_kernel(const Args a) {
  using O = xrt::GatherOut<M, T>;
  const unsigned k = blockIdx.x * kThreads + threadIdx.x;  // the position's index
  if (k >= static_cast<unsigned>(a.n)) return;
  xrt::Taps t = xrt::taps<M>(a.ix[k], a.iy[k], a.tb);
  int o = static_cast<int>(k);  // its output pixel in a band
  if (a.rows != nullptr) {
    o = a.rows[k] * a.out_w + a.cols[k];
  } else {
    t.ok = a.valid[k] != 0;
  }
  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out) + o;
  const O fill = static_cast<O>(a.fill);
  for (int b0 = 0; b0 < a.batch; b0 += kBands) {
    O v[kBands];
#pragma unroll
    for (int g = 0; g < kBands; ++g) {
      v[g] = fill;
      if (t.ok && b0 + g < a.batch) {
        v[g] = xrt::gather_t<M, T>(src + (b0 + g) * a.src_plane, t);
      }
    }
#pragma unroll
    for (int g = 0; g < kBands; ++g) {
      if (b0 + g < a.batch) out[(b0 + g) * a.out_plane] = v[g];
    }
  }
}

template <int M>
cudaError_t launch(int code, const Args& a, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(a.n) + kThreads - 1) /
                                                kThreads);
  return xrt::with_data_type(code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    ij_gather_kernel<M, T><<<blocks, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  });
}

}  // namespace

// src (batch, src_h, src_w) of data type `code`; ix, iy (n) float32
// positions; map form: valid (n) bytes, rows = cols = nullptr, out (batch,
// n / out_w, out_w), out_plane = n; list form: valid = nullptr, rows,
// cols (n) int32, out (batch, out_plane / out_w, out_w).  out's type: the
// source type for nearest, float64 for float64 sources, float32 otherwise.
extern "C" int xrt_ij_gather(
    const void* src, const float* ix, const float* iy, const uint8_t* valid,
    const int* rows, const int* cols, void* out, int64_t n, int64_t batch,
    int64_t src_h, int64_t src_w, int64_t out_w, int64_t out_plane, int method,
    double fill, int code, void* stream) {
  constexpr int64_t kMaxPlane = (int64_t{1} << 31) - 1;
  if (src_h * src_w > kMaxPlane || src_h < 1 || src_w < 1 || batch < 1 || n < 1 ||
      n > kMaxPlane || out_w < 1 || out_plane < 1 || out_plane > kMaxPlane ||
      out_plane % out_w != 0 || batch > kMaxPlane ||
      (rows == nullptr) != (cols == nullptr) || (rows == nullptr) == (valid == nullptr) ||
      (rows == nullptr && n != out_plane)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{src, ix, iy, valid, rows, cols, out, static_cast<int>(n),
               static_cast<int>(batch), static_cast<int>(out_w), out_plane, src_h * src_w,
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
