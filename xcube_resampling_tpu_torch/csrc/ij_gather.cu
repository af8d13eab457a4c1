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
// same; data types are the thirteen of kernel_types.h (bool for nearest
// only: jnp's boolean subtract raises), with gather_interp's output types
// (the source type for nearest, float64 for float64 sources, float32
// otherwise).  The band form (ij_gather_band) takes them too.
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
//
// The band form (ij_gather_band, float32, a kernel of its own) is
// the sharded rectify step's gather, make_sharded_rectify_step.band_step
// (xcube_resampling_tpu/parallel/halo.py:923-977): the source is one mesh
// band extended by its halo (ext_h rows, its row 0 at global source row
// `off`, negative on band 0), the positions are the band's rows of the
// float32 map itself, valid where both are finite.  The taps clamp to the
// global source (src_h rows) and take their fractions from the global
// position, exactly as the map form does; only the integer tap rows are
// rebased by `off`, and a pixel whose tap rows leave the band (nearest:
// off <= row < off + ext_h; bilinear and triangular: y0 >= off and y1 <
// off + ext_h, halo.py:949 and :975) takes the fill.  Its bound is K7's.
// It first shared the map form's kernel (a `B` branch, its row
// arithmetic in int64 under the float32 cap of 32 registers): 0.8485 ms
// at R3's band 1 (21 bands, ext 1615 x 4865 -> 1121 x 5755, bilinear),
// 2.7x its bound, where F.grid_sample took 0.6042.  Its own kernel,
// timed over its launch constants with tools/tune_ij_gather.py --band on
// an H100 80GB HBM3 at 700 W: 0.5686 at the same 32-register cap (the cap
// was not the cause); 0.567-0.618 at 40 to 64 registers; 0.488 with two
// consecutive output pixels a thread (their bilinear taps share sectors,
// and the position work is amortised; four: 0.529).  float2 position
// loads and stores lost 7%, bands a thread at a time (1, 2, 4) moved it
// under 8%, and band-major grids (blocks of 1 to 7 bands on blockIdx.y,
// so that the blocks in flight read a few planes) gained at most 0.3% and
// lost up to 150%: the cache footprint of 21 planes was not what held it.
// Nearest keeps one pixel a thread (two: 0.0412 against 0.0417 ms at R1's
// band, within the noise).
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
  int64_t fill_bits;  // an integer fill's bits
};

// A fill in the output type: an integer's exact bits, else the float.
template <typename O>
__device__ __forceinline__ O fill_of(double fill, int64_t bits) {
  if constexpr (std::is_integral<O>::value) {
    return static_cast<O>(bits);
  } else {
    return xrt::round_from<O>(fill);
  }
}

template <int M, typename T>
__global__ void __launch_bounds__(kThreads,
                                  std::is_same<T, float>::value ? kMinBlocks : (kMinBlocks + 1) / 2)
    ij_gather_kernel(const Args a) {
  using O = xrt::GatherOut<M, T>;
  const unsigned k = blockIdx.x * kThreads + threadIdx.x;  // the position's index
  if (k >= static_cast<unsigned>(a.n)) return;
  const float ix = a.ix[k], iy = a.iy[k];
  xrt::Taps t = xrt::taps<M>(ix, iy, a.tb);
  int o = static_cast<int>(k);  // its output pixel in a band
  if (a.rows != nullptr) {
    o = a.rows[k] * a.out_w + a.cols[k];
  } else {
    t.ok = a.valid[k] != 0;
  }
  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out) + o;
  const O fill = fill_of<O>(a.fill, a.fill_bits);
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

unsigned blocks_of(const Args& a) {
  return static_cast<unsigned>((static_cast<int64_t>(a.n) + kThreads - 1) / kThreads);
}

template <int M>
cudaError_t launch(int code, const Args& a, cudaStream_t s) {
  return xrt::with_data_type(code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if constexpr (std::is_same<T, bool>::value && M != xrt::kNearest) {
      return cudaErrorInvalidValue;  // jnp's boolean subtract raises
    } else {
      ij_gather_kernel<M, T><<<blocks_of(a), kThreads, 0, s>>>(a);
      return cudaGetLastError();
    }
  });
}

// The band form's launch constants (tools/tune_ij_gather.py --band):
// threads a block; consecutive output pixels a thread (nearest:
// kBandPixelsNearest); bands a thread gathers with their tap loads issued
// together; blocks an SM must hold (the register cap, 65536 / (threads *
// blocks))
constexpr int kBandThreads = 256;
constexpr int kBandPixels = 2;
constexpr int kBandPixelsNearest = 1;
constexpr int kBandStep = 2;
constexpr int kBandMinBlocks = 4;

template <int M>
constexpr int kBandPx = M == xrt::kNearest ? kBandPixelsNearest : kBandPixels;

struct BandArgs {
  const void* ext;    // (batch, ext_h, src_w) of the data type
  const float* ix;    // (n) the map's rows, i then j
  const float* iy;
  void* out;          // (batch, n) of GatherOut<M, T>
  int n, batch;
  int64_t off, end;   // the global rows ext holds: off .. end - 1
  unsigned off_elems; // off * src_w, wrapping
  int64_t ext_plane;  // ext_h * src_w
  xrt::TapBounds tb;  // the global source's
  double fill;
  int64_t fill_bits;
};

// float32 as before; the other data types half the blocks an SM (their
// 64-bit taps and outputs take more registers)
template <int M, typename T>
__global__ void __launch_bounds__(kBandThreads,
                                  std::is_same<T, float>::value ? kBandMinBlocks
                                                                : kBandMinBlocks / 2)
    ij_gather_band_kernel(const BandArgs a) {
  using O = xrt::GatherOut<M, T>;
  constexpr int PX = kBandPx<M>;
  const int64_t k0 = (int64_t{blockIdx.x} * kBandThreads + threadIdx.x) * PX;
  if (k0 >= a.n) return;
  float ixs[PX], iys[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int k = static_cast<int>(k0 + p < a.n ? k0 + p : a.n - 1);
    ixs[p] = a.ix[k];
    iys[p] = a.iy[k];
  }
  xrt::Taps t[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const float ix = ixs[p], iy = iys[p];
    t[p] = xrt::taps<M>(ix, iy, a.tb);
    // the tap rows at the clamped global row, rebased into ext (the
    // unsigned offset wraps back into the band wherever t.ok holds)
    const float iyc = fminf(fmaxf(iy, 0.0f), a.tb.y_max);
    const int64_t y0 = static_cast<int64_t>(M == xrt::kNearest ? rintf(iyc) : floorf(iyc));
    const int64_t y1 = y0 + (t[p].dy != 0u ? 1 : 0);
    t[p].ok = k0 + p < a.n && isfinite(ix) && isfinite(iy) && y0 >= a.off && y1 < a.end;
    t[p].off -= a.off_elems;
  }
  const T* __restrict__ ext = static_cast<const T*>(a.ext);
  O* __restrict__ out = static_cast<O*>(a.out) + k0;
  const O fill = fill_of<O>(a.fill, a.fill_bits);
  // The band loop starts at blockIdx.y * batch, 0 (the grid has one
  // row): from a constant start ptxas schedules it into 64 registers
  // (bilinear) and it runs 15% slower at R3's band (0.570 against 0.497 ms
  // on an H100); kBandStep is the unrolling
  const int b_lo = blockIdx.y * a.batch;
#pragma unroll 1
  for (int b0 = b_lo; b0 < a.batch; b0 += kBandStep) {
    O v[kBandStep][PX];
#pragma unroll
    for (int g = 0; g < kBandStep; ++g) {
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        v[g][p] = fill;
        if (t[p].ok && b0 + g < a.batch) {
          v[g][p] = xrt::gather_t<M, T>(ext + (b0 + g) * a.ext_plane, t[p]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kBandStep; ++g) {
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        if (b0 + g < a.batch && k0 + p < a.n) out[static_cast<int64_t>(b0 + g) * a.n + p] = v[g][p];
      }
    }
  }
}

template <int M>
cudaError_t launch_band(int code, const BandArgs& a, cudaStream_t s) {
  const int64_t per_block = int64_t{kBandThreads} * kBandPx<M>;
  return xrt::with_data_type(code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if constexpr (std::is_same<T, bool>::value && M != xrt::kNearest) {
      return cudaErrorInvalidValue;  // jnp's boolean subtract raises
    } else {
      ij_gather_band_kernel<M, T><<<static_cast<unsigned>((a.n + per_block - 1) / per_block),
                                    kBandThreads, 0, s>>>(a);
      return cudaGetLastError();
    }
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
    double fill, int64_t fill_bits, int code, void* stream) {
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
               xrt::tap_bounds(src_h, src_w), fill, fill_bits};
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

// The band form: ext (batch, ext_h, src_w) of data type `code`, its row 0
// at global source row off of a source src_h rows high; map (2, out_h,
// out_w) float32 (i, then j); out (batch, out_h, out_w) of xrt_ij_gather's
// output type.
extern "C" int xrt_ij_gather_band(
    const void* ext, const float* map, void* out, int64_t batch, int64_t ext_h,
    int64_t src_w, int64_t out_h, int64_t out_w, int64_t off, int64_t src_h, int method,
    double fill, int64_t fill_bits, int code, void* stream) {
  constexpr int64_t kMaxPlane = (int64_t{1} << 31) - 1;
  const int64_t n = out_h * out_w;
  if (ext_h < 1 || src_w < 1 || src_h < 1 || batch < 1 || n < 1 || n > kMaxPlane ||
      ext_h * src_w > kMaxPlane || src_h * src_w > kMaxPlane || batch > kMaxPlane ||
      off <= -ext_h || off >= src_h) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BandArgs a{ext, map, map + n, out, static_cast<int>(n), static_cast<int>(batch),
                   off, off + ext_h, static_cast<unsigned>(off * src_w), ext_h * src_w,
                   xrt::tap_bounds(src_h, src_w), fill, fill_bits};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (method) {
    case xrt::kBilinear: rc = launch_band<xrt::kBilinear>(code, a, s); break;
    case xrt::kNearest: rc = launch_band<xrt::kNearest>(code, a, s); break;
    case xrt::kTriangular: rc = launch_band<xrt::kTriangular>(code, a, s); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}
