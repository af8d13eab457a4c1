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
// gather_interp :108-147).  The port runs it where the tiled SRW plan is
// refused (singular warps such as the global EPSG:4326 -> EPSG:3035
// reproject) and under XRTPU_EXACT=1.
//
// Bound on the H100: device memory.  The work must write every output once
// and read the source window its taps reach once; the coarse fields are
// small and stay in L1/L2.  Where the target is finer than the source, the
// four taps of neighbouring pixels fall on the same few source pixels, so
// most reads hit L1.  What holds it above that bound is the arithmetic of a
// pixel (field lerps, mask, clamp, floors, tap addresses: about 40
// instructions), not its bytes (PERF.md; tools/tune_fused.py).
//
// Design: a block covers a tile of kTileRows target rows by kTileCols
// columns, kWarpCols threads across (each owning kVec consecutive columns)
// by kLanes threads down; a thread walks the tile's rows kLanes apart.  The
// field interpolation (srw_common.h's FieldCols) takes each column's cell
// and fraction once and keeps the row lerps of both fields at all of a
// thread's columns while its rows stay in one coarse cell: one test a row,
// and a tile aligned to the coarse grid loads its coarse corners once.
// Per row a thread computes the tap offsets, weights and mask of its kVec
// pixels once for every band and stores the kVec outputs of a band as one
// float4 where out_w % 4 == 0 and the output is 16-byte aligned.  This
// launch shape was the fastest of those tools/tune_fused.py timed on an
// H100 (rows 16 or 32, lanes 1, 2 or 4, scalar or float4 stores).
// The method is a template parameter; offsets inside a plane are 32-bit
// and unsigned (the wrapper refuses planes of 2^31 elements or more), band
// offsets 64-bit.  Always 4 taps per pixel (1 for nearest), zero weights
// included, so NaN reach follows gather_interp (taps and gather in
// gather_taps.h, shared with K7).  Staging a tile's tap
// window in shared memory with cp.async was measured 20-25% slower in
// every case, so the taps read through L1.
//
// The band form (fused_reproject_band; B = true) is the sharded regrid's
// gather, xcube_resampling_tpu/parallel/halo.py:169-205: the source plane
// is one mesh band extended by its halo (ext_h rows, its row 0 at global
// source row `off`), and output row j lies at global target row row0 + j.
// The fields are interpolated there; the mask is the global source's
// bounds and the band's (iy clamped to the true source, then rebased by
// off in float32, inside (-0.5, ext_h - 0.5)); the taps clamp to the
// band.  B is a template parameter: the single-chip kernels (B = false)
// compile as before.
#include "gather_taps.h"

namespace {

constexpr int kVec = 4;                   // output columns of a thread
constexpr int kWarpCols = 32;             // threads across a tile
constexpr int kLanes = 2;                 // threads down a tile
constexpr int kTileCols = kVec * kWarpCols;
constexpr int kTileRows = 16;             // target rows of a tile

struct Args {
  const float* src;
  float* out;
  xrt::CoarseFields<2> field;  // ix_c, iy_c
  int64_t batch;
  xrt::TapBounds tb;  // the source plane's bounds and clamp limits
  int out_h, out_w;
  float fill;
  int n_row_tiles;
  bool vec4;  // out_w % 4 == 0 and out 16-byte aligned
  // the band form's: the global target row of output row 0, the true
  // source's bounds (tb holds the band's) and the band's row offset
  int row0;
  xrt::TapBounds global;
  float off;
};

// The taps of one pixel: the single-chip gather's, or the band form's.
template <int M, bool B>
__device__ __forceinline__ xrt::Taps pixel_taps(float ix, float iy, const Args& a) {
  if constexpr (!B) {
    return xrt::taps<M>(ix, iy, a.tb);
  } else {
    const xrt::TapBounds& g = a.global;
    const bool in_src = ix > -0.5f && ix < g.x_hi && iy > -0.5f && iy < g.y_hi;
    // taps<M> on the band: the band's mask (iy_l inside (-0.5, ext_h - 0.5))
    // and clamps
    xrt::Taps t = xrt::taps<M>(ix, fminf(fmaxf(iy, 0.0f), g.y_max) - a.off, a.tb);
    t.ok = in_src && t.ok;
    return t;
  }
}

// One thread: kVec consecutive columns from i, rows kLanes apart.  At
// least 12 blocks an SM hold ptxas to 80 registers a thread; left free it
// took 96, and K3 was 10% slower at the UTM shape on an H100
// (tools/tune_fused.py).
template <int M, bool B>
__global__ void __launch_bounds__(kWarpCols * kLanes, 12) fused_reproject_kernel(const Args a) {
  const int i = (blockIdx.x * kWarpCols + threadIdx.x) * kVec;
  if (i >= a.out_w) return;
  const int64_t src_plane = static_cast<int64_t>(a.tb.src_h) * a.tb.src_w;
  const int64_t out_plane = static_cast<int64_t>(a.out_h) * a.out_w;
  const int n = a.out_w - i < kVec ? a.out_w - i : kVec;
  xrt::FieldCols<2, kVec> field(a.field, static_cast<float>(i));
  for (int tr = blockIdx.y; tr < a.n_row_tiles; tr += gridDim.y) {
    const int j1 = min((tr + 1) * kTileRows, a.out_h);
    for (int j = tr * kTileRows + threadIdx.y; j < j1; j += kLanes) {
      // the kVec pixels of this row: taps once, then every band
      float f[2][kVec];  // ix, iy
      field.at(a.field, static_cast<float>(B ? a.row0 + j : j), f);
      xrt::Taps t[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) t[c] = pixel_taps<M, B>(f[0][c], f[1][c], a);
      for (int64_t b = 0; b < a.batch; ++b) {
        const float* p = a.src + b * src_plane;
        float v[kVec];
#pragma unroll
        for (int c = 0; c < kVec; ++c) v[c] = xrt::gather<M>(p, t[c]);
#pragma unroll
        for (int c = 0; c < kVec; ++c) v[c] = t[c].ok ? v[c] : a.fill;
        float* o = a.out + b * out_plane + j * a.out_w + i;
        if (a.vec4 && n == kVec) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            if (c < n) o[c] = v[c];
          }
        }
      }
    }
  }
}

template <bool B>
int dispatch(const float* src, const float* ix_c, const float* iy_c, float* out,
             int64_t batch, int64_t src_h, int64_t src_w, int64_t ncj,
             int64_t nci, int64_t out_h, int64_t out_w, int step, int method,
             float fill, int64_t row0, int64_t off, int64_t true_h,
             void* stream) {
  constexpr int64_t kMaxPlane = (int64_t{1} << 31) - 1;
  if (src_h * src_w > kMaxPlane || out_h * out_w > kMaxPlane ||
      ncj * nci > kMaxPlane || step < 1 || batch < 1 || row0 + out_h > kMaxPlane) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec4 = out_w % kVec == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const Args a{src, out,
               {{ix_c, iy_c}, static_cast<int>(ncj), static_cast<int>(nci),
                static_cast<float>(1.0 / step)},
               batch, xrt::tap_bounds(src_h, src_w),
               static_cast<int>(out_h), static_cast<int>(out_w), fill,
               static_cast<int>((out_h + kTileRows - 1) / kTileRows), vec4,
               static_cast<int>(row0), xrt::tap_bounds(true_h, src_w),
               static_cast<float>(off)};
  const dim3 block(kWarpCols, kLanes);
  const dim3 grid(static_cast<unsigned>((out_w + kTileCols - 1) / kTileCols),
                  static_cast<unsigned>(a.n_row_tiles < 65535 ? a.n_row_tiles : 65535));
  const auto s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case xrt::kBilinear: fused_reproject_kernel<xrt::kBilinear, B><<<grid, block, 0, s>>>(a); break;
    case xrt::kNearest: fused_reproject_kernel<xrt::kNearest, B><<<grid, block, 0, s>>>(a); break;
    case xrt::kTriangular: fused_reproject_kernel<xrt::kTriangular, B><<<grid, block, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int xrt_fused_reproject_f32(
    const float* src, const float* ix_c, const float* iy_c, float* out,
    int64_t batch, int64_t src_h, int64_t src_w, int64_t ncj, int64_t nci,
    int64_t out_h, int64_t out_w, int step, int method, float fill,
    void* stream) {
  return dispatch<false>(src, ix_c, iy_c, out, batch, src_h, src_w, ncj, nci,
                         out_h, out_w, step, method, fill, 0, 0, src_h, stream);
}

// The band form: src is the band's ext (batch, ext_h, src_w), its row 0 at
// global source row off; out_h output rows from global row row0; src_h the
// source's true height.
extern "C" int xrt_fused_reproject_band_f32(
    const float* ext, const float* ix_c, const float* iy_c, float* out,
    int64_t batch, int64_t ext_h, int64_t src_w, int64_t ncj, int64_t nci,
    int64_t out_h, int64_t out_w, int step, int method, float fill,
    int64_t row0, int64_t off, int64_t src_h, void* stream) {
  return dispatch<true>(ext, ix_c, iy_c, out, batch, ext_h, src_w, ncj, nci,
                        out_h, out_w, step, method, fill, row0, off, src_h, stream);
}
