// K13: the exact separable warp (ESW), and its band form.
//
// Replaces the XLA kernels of xcube_resampling_tpu/ops/esw.py (precompute
// :616-651 and kernel :653-876 of _get_impls) and of the sharded ESW step,
// xcube_resampling_tpu/parallel/halo.py:650-791 (_precompute, band_step).
// The JAX kernel is gather-free because the TPU serialises dynamic
// gathers: it selects S consecutive source rows per (output row, source
// column) into S full-size fields and routes the taps by exact index
// match over tiled tap bases.  On Hopper each output pixel reads its taps
// directly, as K3 does, and computes the same function from the coarse
// fields, with no per-pixel statics.  For each target pixel (r, x):
//   1. ix, iy: the coarse fields ix_c, iy_c interpolated as K3 does (global
//      source indices), the validity mask, the clamp to the global source;
//   2. y0 = floor(iy) and i0 = floor(ix) (rint for nearest), fy, fx; the
//      window offsets subtracted only after rounding (j_off in float32,
//      i_off in int32, esw.py:782-799);
//   3. at each tap column c = i0 and min(i0 + 1, W - 1) (window space,
//      both clamped to the plane): the anchor m = floor(iy*(r, c) - (S -
//      2) / 2) from the coarse field iystar_c, the selection s0 = clip(y0 -
//      m, 0, S - 2) (S - 1 for nearest, esw.py:838), and the rows m + s0
//      and m + s0 + 1 clipped to the window;
//   4. the vertical lerp a + fy (b - a) per column first, then cv0 + fx
//      (cv1 - cv0); for triangular the four taps and the two-triangle split
//      of gather.grid_sample (esw.py:856-867); nearest takes a;
//   5. out = valid ? value : fill.
// Every lerp is a fused multiply-add where XLA's CPU backend contracts it
// (the library is built with -fmad=false, so nothing else is contracted),
// so the kernel equals its plain version and the JAX package bit for bit.
// The JAX layout's shift alignment moves values, not positions (the
// shifted source and anchors are value-equal to the unshifted ones), and
// its tap bases cover every selected row with a margin, so reading the
// selected rows directly gives the same values.
//
// The band form (esw_gather_band_kernel) is the sharded step's: the plane
// is one mesh band extended by its halo (its row 0 at global source row
// off), output row j lies at global target row row0 + j, there is no
// window (j_off = i_off = 0), the rows clip to the true source's height
// and are then read off rows up (halo.py:684, 700-701).
//
// Bound on the H100: device memory, as K3's.  A pixel reads 4 taps (1 for
// nearest) and writes one float per band; the coarse fields (ix_c, iy_c,
// iystar_c) stay in L1 and L2.  What holds it is each pixel's work; per
// pixel, the anchor took half of it: at each of two tap columns four
// iystar_c loads, three lerps and a floor on the chain ahead of the taps.
// Design: K13 stages each tile's anchors (esw_pixel.h's staged_tile).  A
// block of kWarpCols x kLanes threads owns a tile of kTileRows target rows
// by kTileCols columns.  The anchor m(r, c) depends only on the target row
// and the window column, and a tile's pixels tap a narrow span of window
// columns (about 60 at the ESW cell), so each warp bounds that span from
// the finite corners of ix_c around the tile's coarse cells, the block
// computes the anchor of every (tile row, span column) once into shared
// memory (each column's cell once, its column lerps once a coarse row
// cell, the rows unrolled), and after one barrier each pixel reads its two
// anchors and goes straight to its selection, its rows clipped by 32-bit
// clamps, and its taps.  A tile whose span exceeds the stage (esw_pixel.h's
// stage_limit) runs the per-pixel body, the same function, as every tile
// does when the C entry is asked for no stage (staged 0):
// K3's design, a thread owns kVec consecutive columns and walks rows, the
// ix, iy interpolation keeps its row lerps while the rows stay in one
// coarse cell (srw_common.h's FieldCols), each pixel's taps are taken once
// for every band.  The grid runs row tiles as K3's.  The band form runs
// the same tiles and grid as a kernel of its own, its tiles at global
// target rows row0 + j (the coarse span and the stage read the coarse
// fields there) and its rows clipped by the band's three 32-bit clamps
// (esw_pixel.h's Clip::kBand), so that no flag reaches either kernel's hot
// loop; a band too small to fill one wave in 16-row tiles takes shorter
// tiles (band_tile_rows), staged only from kBandStageRows rows.  Offsets
// inside a plane are 32-bit and unsigned (the wrapper refuses planes of
// 2^31 elements or more), band offsets 64-bit.  The per-pixel function and
// the staged tile are esw_pixel.h's, which K16's ESW pieces run too.
#include "esw_pixel.h"

namespace {

using xrt::esw::Args;
using xrt::esw::Clip;
using xrt::esw::kStageCols;
using xrt::esw::kTileRows;
using xrt::esw::kVec;

constexpr int kWarpCols = 32;  // threads across a tile
constexpr int kLanes = 2;      // threads down a tile
constexpr int kTileCols = kVec * kWarpCols;
// the band kernel's blocks an SM (launch bounds: 80 registers): at band 1
// of the ESW cell 2-4% below K13's 72 registers at 14 (tools/tune_esw.py)
constexpr int kBandBlocks = 12;

// the fewest rows a band's tile stages its anchors in (below, every tile
// of the launch computes them per pixel, its span not bounded): staged,
// tiles of 11 rows ran 16% below per pixel, tiles of 2 rows 38% above
// (tools/tune_esw.py)
constexpr int kBandStageRows = 8;

// The band form's rows a tile (ops/esw.py's band_tile_rows): kTileRows,
// or, where the band's tiles would fill less than one wave of kBandBlocks
// blocks an SM on *sms* SMs, as few as spread its rows over that wave, at
// least a row a lane.  A band of 128 rows by 512 columns (the sheared
// 512^2 target over 4 bands) would otherwise run 32 blocks: 3.3x the
// parent's one-wave launch (tools/tune_esw.py).
int band_tile_rows(int64_t out_h, int64_t out_w, int sms) {
  const int64_t cols = (out_w + kTileCols - 1) / kTileCols;
  const int64_t slots = static_cast<int64_t>(sms) * kBandBlocks;
  if (cols * ((out_h + kTileRows - 1) / kTileRows) >= slots) return kTileRows;
  const int64_t rows = (out_h * cols + slots - 1) / slots;
  return static_cast<int>(rows < kLanes ? kLanes : rows);
}

// A block's tiles, a tile of a.tile_rows x kTileCols at a time down its
// column of tiles, its anchors staged in shared memory unless *staged* is 0
// (esw_pixel.h's staged_tile), the rows clipped as C says.  The band form
// with no stage walks its rows per pixel without bounding each tile's span
// first (at the sheared target's band 1, in tiles of 2 rows: 0.0046
// against 0.0050 device ms on an H100); K13 keeps staged_tile's own
// fall-back, whose code this branch took to 64 registers and a spill
// (tools/tune_esw.py).
template <int M, Clip C>
__device__ __forceinline__ void tiles(const Args& a, int staged, float* stage) {
  const int i = (blockIdx.x * kWarpCols + threadIdx.x) * kVec;
  const int n = a.out_w - i < kVec ? a.out_w - i : kVec;
  xrt::FieldCols<2, kVec> field(a.field, static_cast<float>(i));
  const int i_last = min((static_cast<int>(blockIdx.x) + 1) * kTileCols, a.out_w) - 1;
  // K13's tiles are kTileRows high (a load of a.tile_rows in its loop cost
  // it 2-4% at 4 bands)
  const int th = C == Clip::kPlane ? kTileRows : a.tile_rows;
  for (int tr = blockIdx.y; tr < a.n_row_tiles; tr += gridDim.y) {
    const int j0 = tr * th;
    const int j1 = min(j0 + th, a.out_h);
    if (C == Clip::kBand && !staged) {
      for (int j = j0 + static_cast<int>(threadIdx.y); j < j1 && n > 0; j += kLanes) {
        xrt::esw::one_row<M, C>(a, field, j, i, n);
      }
    } else {
      xrt::esw::staged_tile<M, kLanes, C>(a, field, j0, j1, i, n, i_last, stage, staged != 0,
                                          tr != static_cast<int>(blockIdx.y));
    }
  }
}

// K13: the rows clip to the window (clip_h == src_h, no row offset).
template <int M>
__global__ void __launch_bounds__(kWarpCols * kLanes) esw_gather_kernel(const Args a,
                                                                        int staged) {
  __shared__ float stage[kTileRows * kStageCols];
  tiles<M, Clip::kPlane>(a, staged, stage);
}

// The band form: the rows clip to the source, then read row_off rows up.
template <int M>
__global__ void __launch_bounds__(kWarpCols * kLanes, kBandBlocks) esw_gather_band_kernel(
    const Args a, int staged) {
  __shared__ float stage[kTileRows * kStageCols];
  tiles<M, Clip::kBand>(a, staged, stage);
}

// A block a column of tiles and a row tile (B: the band form).
template <int M, bool B>
cudaError_t launch(const Args& a, int staged, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.out_w + kTileCols - 1) / kTileCols),
                  static_cast<unsigned>(a.n_row_tiles < 65535 ? a.n_row_tiles : 65535));
  const auto kernel = B ? esw_gather_band_kernel<M> : esw_gather_kernel<M>;
  kernel<<<grid, dim3(kWarpCols, kLanes), 0, s>>>(a, staged);
  return cudaGetLastError();
}

template <bool B>
int dispatch(const float* src, const float* iystar, const float* ix_c, const float* iy_c,
             float* out, int64_t batch, int64_t src_h, int64_t src_w, int64_t ncj, int64_t ncc,
             int64_t nci, int64_t out_h, int64_t out_w, int step, int n_samples, int method,
             float fill, int64_t bound_h, int64_t bound_w, int64_t j_off, int64_t i_off,
             int64_t clip_h, int64_t row_off, int64_t row0, int staged, void* stream) {
  constexpr int64_t kMaxPlane = (int64_t{1} << 31) - 1;
  if (src_h * src_w > kMaxPlane || out_h * out_w > kMaxPlane || ncj * nci > kMaxPlane ||
      ncj * ncc > kMaxPlane || step < 1 || batch < 1 || n_samples < 3 || n_samples > 64 ||
      row0 < 0 || row0 + out_h > (int64_t{1} << 24) || clip_h < 1 || bound_h < 1 ||
      bound_w < 1 || i_off < 0 || i_off > kMaxPlane || j_off < 0 || j_off > kMaxPlane ||
      row_off < clip_h - 1 - kMaxPlane || row_off > kMaxPlane || clip_h > kMaxPlane ||
      src_h < 1 || src_w < 1 || staged < 0 || staged > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const xrt::TapBounds g = xrt::tap_bounds(bound_h, bound_w);
  Args a{};
  a.src = src;
  a.iystar = iystar;
  a.out = out;
  a.field = {{ix_c, iy_c}, static_cast<int>(ncj), static_cast<int>(nci),
             static_cast<float>(1.0 / step)};
  a.ncc = static_cast<int>(ncc);
  a.batch = batch;
  a.src_h = static_cast<int>(src_h);
  a.src_w = static_cast<int>(src_w);
  a.pitch = static_cast<int>(src_w);
  a.src_plane = src_h * src_w;
  a.x_hi = g.x_hi;
  a.y_hi = g.y_hi;
  a.x_max = g.x_max;
  a.y_max = g.y_max;
  a.half = static_cast<float>((n_samples - 2) / 2.0);
  a.s_max = static_cast<float>(method == xrt::kNearest ? n_samples - 1 : n_samples - 2);
  a.j_off = static_cast<float>(j_off);
  a.i_off = static_cast<int>(i_off);
  a.clip_h = static_cast<int>(clip_h);
  a.row_off = static_cast<int>(row_off);
  a.out_h = static_cast<int>(out_h);
  a.out_w = static_cast<int>(out_w);
  a.out_pitch = static_cast<int>(out_w);
  a.out_plane = out_h * out_w;
  a.fill = fill;
  a.tile_rows = kTileRows;
  if (B) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    a.tile_rows = band_tile_rows(out_h, out_w, sms);
    if (a.tile_rows < kBandStageRows) staged = 0;
  }
  a.n_row_tiles = static_cast<int>((out_h + a.tile_rows - 1) / a.tile_rows);
  a.vec4 = out_w % kVec == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.row0 = static_cast<int>(row0);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (method) {
    case xrt::kBilinear:
      e = launch<xrt::kBilinear, B>(a, staged, s);
      break;
    case xrt::kNearest:
      e = launch<xrt::kNearest, B>(a, staged, s);
      break;
    case xrt::kTriangular:
      e = launch<xrt::kTriangular, B>(a, staged, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // namespace

// K13: src is the source window (batch, src_h, src_w), its origin at
// global source row j_off and column i_off of a source src_h_g x src_w_g;
// staged 1: each tile stages its anchors where its span fits the stage;
// 0: every tile runs the per-pixel body (the same bits).
extern "C" int xrt_esw_gather_f32(const float* src, const float* iystar_c, const float* ix_c,
                                  const float* iy_c, float* out, int64_t batch, int64_t src_h,
                                  int64_t src_w, int64_t ncj, int64_t ncc, int64_t nci,
                                  int64_t out_h, int64_t out_w, int step, int n_samples,
                                  int method, float fill, int64_t src_h_g, int64_t src_w_g,
                                  int64_t j_off, int64_t i_off, int staged, void* stream) {
  return dispatch<false>(src, iystar_c, ix_c, iy_c, out, batch, src_h, src_w, ncj, ncc, nci,
                         out_h, out_w, step, n_samples, method, fill, src_h_g, src_w_g, j_off,
                         i_off, src_h, 0, 0, staged, stream);
}

// The band form: ext is the band's extension (batch, ext_h, src_w), its
// row 0 at global source row off; out_h output rows from global target
// row row0; src_h the source's true height; staged as K13's (a tile of
// fewer than kBandStageRows rows never stages).
extern "C" int xrt_esw_gather_band_f32(const float* ext, const float* iystar_c,
                                       const float* ix_c, const float* iy_c, float* out,
                                       int64_t batch, int64_t ext_h, int64_t src_w, int64_t ncj,
                                       int64_t ncc, int64_t nci, int64_t out_h, int64_t out_w,
                                       int step, int n_samples, int method, float fill,
                                       int64_t row0, int64_t off, int64_t src_h, int staged,
                                       void* stream) {
  return dispatch<true>(ext, iystar_c, ix_c, iy_c, out, batch, ext_h, src_w, ncj, ncc, nci, out_h,
                        out_w, step, n_samples, method, fill, src_h, src_w, 0, 0, src_h, off,
                        row0, staged, stream);
}
