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
// The band form (fused_reproject_band) is the sharded regrid's gather,
// xcube_resampling_tpu/parallel/halo.py:169-205: the source plane is one
// mesh band extended by its halo (ext_h rows, its row 0 at global source
// row `off`), and output row j lies at global target row row0 + j.  The
// fields are interpolated there; the mask is the global source's bounds
// and the band's (iy clamped to the true source, then rebased by off in
// float32, inside (-0.5, ext_h - 0.5)); the taps clamp to the band.  A
// band is a few row tiles high (1024 rows at BASELINE #5's gate), so K3's
// grid there ran 1.3 waves of its 12 blocks an SM, each thread's 8 rows
// one after another.  The band form has a kernel of its own
// (fused_reproject_band_kernel): the grid is one wave of the blocks an SM
// holds (kBandBlocks of kWarpCols x kBandLanes threads), each block a run
// of consecutive rows of its 128 columns, the runs as even as the lanes
// allow, so that no partial wave is left and a thread's rows stay in one
// coarse cell of the fields for as long as K3's.  Its pixels take the same
// operations as K3's.  (Two rows a thread at once, which keeps twice the
// tap loads in flight, took 148 registers for bilinear and ran slower at
// the gate's band 1 on an H100: 0.0296-0.0330 ms against 0.0210,
// tools/tune_fused.py --band.)
#include "affine_gather.h"
#include "gather_taps.h"

namespace {

constexpr int kVec = 4;                   // output columns of a thread
constexpr int kWarpCols = 32;             // threads across a tile
constexpr int kLanes = 2;                 // threads down a tile
constexpr int kTileCols = kVec * kWarpCols;
constexpr int kTileRows = 16;             // target rows of a tile
// the band form's block: kBandLanes threads down; kBandBlocks blocks an SM
// (its register cap)
constexpr int kBandLanes = 1;
constexpr int kBandBlocks = 16;

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
template <int M>
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
      field.at(a.field, static_cast<float>(j), f);
      xrt::Taps t[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) t[c] = pixel_taps<M, false>(f[0][c], f[1][c], a);
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

// The band form: kVec consecutive columns from i, the rows of the block's
// run kBandLanes apart.
template <int M>
__global__ void __launch_bounds__(kWarpCols * kBandLanes, kBandBlocks) fused_reproject_band_kernel(
    const Args a, int run) {
  const int i = (blockIdx.x * kWarpCols + threadIdx.x) * kVec;
  if (i >= a.out_w) return;
  const int64_t src_plane = static_cast<int64_t>(a.tb.src_h) * a.tb.src_w;
  const int64_t out_plane = static_cast<int64_t>(a.out_h) * a.out_w;
  const int n = a.out_w - i < kVec ? a.out_w - i : kVec;
  xrt::FieldCols<2, kVec> field(a.field, static_cast<float>(i));
  const int j0 = static_cast<int>(blockIdx.y) * run;
  const int j1 = min(j0 + run, a.out_h);
  for (int j = j0 + static_cast<int>(threadIdx.y); j < j1; j += kBandLanes) {
    float f[2][kVec];  // ix, iy
    field.at(a.field, static_cast<float>(a.row0 + j), f);
    xrt::Taps t[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) t[c] = pixel_taps<M, true>(f[0][c], f[1][c], a);
    for (int64_t b = 0; b < a.batch; ++b) {
      const float* p = a.src + b * src_plane;
      float v[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) v[c] = xrt::gather<M>(p, t[c]);
#pragma unroll
      for (int c = 0; c < kVec; ++c) v[c] = t[c].ok ? v[c] : a.fill;
      float* o = a.out + b * out_plane + static_cast<int64_t>(j) * a.out_w + i;
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

// The band form's launch: one wave of blocks down the columns, each a run
// of rows (a multiple of the lanes) as even as they allow.
template <int M>
cudaError_t launch_band(const Args& a, cudaStream_t s) {
  const int64_t cols = (a.out_w + kTileCols - 1) / kTileCols;
  unsigned rows = 1;
  const cudaError_t e = xrt::wave_rows(fused_reproject_band_kernel<M>, kWarpCols * kBandLanes, 0,
                                       cols, (a.out_h + kBandLanes - 1) / kBandLanes, &rows);
  if (e != cudaSuccess) return e;
  const int per = (a.out_h + static_cast<int>(rows) - 1) / static_cast<int>(rows);
  const int run = (per + kBandLanes - 1) / kBandLanes * kBandLanes;
  const unsigned grid_y = static_cast<unsigned>((a.out_h + run - 1) / run);
  fused_reproject_band_kernel<M><<<dim3(static_cast<unsigned>(cols), grid_y),
                                   dim3(kWarpCols, kBandLanes), 0, s>>>(a, run);
  return cudaGetLastError();
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
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (B) {
    switch (method) {
      case xrt::kBilinear: return static_cast<int>(launch_band<xrt::kBilinear>(a, s));
      case xrt::kNearest: return static_cast<int>(launch_band<xrt::kNearest>(a, s));
      case xrt::kTriangular: return static_cast<int>(launch_band<xrt::kTriangular>(a, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 block(kWarpCols, kLanes);
  const dim3 grid(static_cast<unsigned>((out_w + kTileCols - 1) / kTileCols),
                  static_cast<unsigned>(a.n_row_tiles < 65535 ? a.n_row_tiles : 65535));
  switch (method) {
    case xrt::kBilinear: fused_reproject_kernel<xrt::kBilinear><<<grid, block, 0, s>>>(a); break;
    case xrt::kNearest: fused_reproject_kernel<xrt::kNearest><<<grid, block, 0, s>>>(a); break;
    case xrt::kTriangular: fused_reproject_kernel<xrt::kTriangular><<<grid, block, 0, s>>>(a); break;
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
