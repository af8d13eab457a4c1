// K13's per-pixel function, the exact separable warp of one target pixel,
// shared by K13 and its band form (esw_gather.cu) and by K16's ESW pieces
// (esw_mosaic.cu), so that the three cannot drift apart; and the staged
// tile (below) that K13 and K16 run, which computes the same function with
// each tile's anchors staged in shared memory.
//
// It computes the function of the JAX package's ESW kernel
// (xcube_resampling_tpu/ops/esw.py: precompute :616-651 and kernel
// :653-876 of _get_impls) from the coarse fields; esw_gather.cu's note
// gives the steps.  Every lerp is a fused multiply-add where XLA's CPU
// backend contracts it (the library is built with -fmad=false, so nothing
// else is contracted).
//
// The plane read may be a window of a larger source: its rows lie `pitch`
// floats apart and its bands `src_plane` floats apart; the output rows
// `out_pitch` floats apart and its bands `out_plane` floats apart.  Offsets
// inside a plane are 32-bit and unsigned (the wrappers refuse planes of
// 2^31 elements or more).
#pragma once

#include "gather_taps.h"

namespace xrt {
namespace esw {

constexpr int kVec = 4;  // output columns of a thread

struct Args {
  const float* src;     // the plane's first pixel (band 0)
  const float* iystar;  // (ncj, ncc), window columns
  float* out;           // output row 0, column 0 (band 0)
  CoarseFields<2> field;  // ix_c, iy_c (ncj, nci), global indices
  int ncc;
  int64_t batch;
  int src_h, src_w;   // the plane read: the window, or the band's extension
  int pitch;          // floats between the plane's rows
  int64_t src_plane;  // floats between the plane's bands
  // the global source's bounds and clamp limits (validity, positions)
  float x_hi, y_hi, x_max, y_max;
  float half;   // (S - 2) / 2
  float s_max;  // S - 2, or S - 1 for nearest
  float j_off;  // the window's origin (0 for the band form)
  int i_off;
  int clip_h;   // rows clip to [0, clip_h): the window's or the source's height
  int row_off;  // then read row_off rows up (the band's offset)
  int out_h, out_w;
  int out_pitch;      // floats between output rows
  int64_t out_plane;  // floats between output bands
  float fill;
  int tile_rows;    // rows a tile of the band form (kTileRows; fewer in a small band)
  int n_row_tiles;
  bool vec4;  // kVec-column stores are 16-byte aligned
  int row0;   // the global target row of output row 0
};

// The taps of one pixel: the offsets of its two tap columns' upper rows,
// the steps down to their lower rows (0 where the clip folds them), the
// fractions and the mask.
struct Taps {
  unsigned o0, o1, d0, d1;
  float fx, fy;
  bool ok;
};

// The row cell of a target row in the coarse fields, as _interp_field
// takes it: the clamped cell and the unclamped fraction.
struct RowCell {
  int j;
  float fj;
};

__device__ __forceinline__ RowCell row_cell(const Args& a, float row) {
  const float cj = row * a.field.inv;
  const float j0f = floorf(cj);
  return {static_cast<int>(clamp_index(static_cast<int>(j0f), a.field.ncj - 1)), cj - j0f};
}

// The coarse cell of window column c in iystar_c (clamped) and its
// fraction, as _interp_field takes them.
struct ColCell {
  int i;
  float fi;
};

__device__ __forceinline__ ColCell col_cell(const Args& a, int c) {
  const float ci = static_cast<float>(c) * a.field.inv;
  const float i0f = floorf(ci);
  return {static_cast<int>(clamp_index(static_cast<int>(i0f), a.ncc - 1)), ci - i0f};
}

// The four samples of iystar_c around a cell, in the row cell rc.
struct Corners {
  float f00, f01, f10, f11;
};

__device__ __forceinline__ Corners corners(const Args& a, RowCell rc, int i) {
  const float* q = a.iystar + rc.j * a.ncc + i;
  return {__ldg(q), __ldg(q + 1), __ldg(q + a.ncc), __ldg(q + a.ncc + 1)};
}

// A pixel's position: the mask, y0 in window rows, its first tap column
// i0 (window space, not yet clamped to the plane) and the fractions.
struct Pos {
  float y0w, fx, fy;
  int i0;
  bool ok;
};

template <int M>
__device__ __forceinline__ Pos position(const Args& a, float ix, float iy) {
  Pos p;
  p.ok = ix > -0.5f && ix < a.x_hi && iy > -0.5f && iy < a.y_hi;
  ix = fminf(fmaxf(ix, 0.0f), a.x_max);
  iy = fminf(fmaxf(iy, 0.0f), a.y_max);
  float y0;
  if (M == kNearest) {
    y0 = rintf(iy);
    p.i0 = static_cast<int>(rintf(ix)) - a.i_off;
    p.fx = p.fy = 0.0f;
  } else {
    y0 = floorf(iy);
    p.fy = iy - y0;
    const float x0 = floorf(ix);
    p.fx = ix - x0;
    p.i0 = static_cast<int>(x0) - a.i_off;
  }
  p.y0w = y0 - a.j_off;
  return p;
}

// A tap column clamped to the plane.
__device__ __forceinline__ int tap_col(const Args& a, int i) {
  return min(max(i, 0), a.src_w - 1);
}

// The anchor m = floor(iy*(r, c) - (S - 2) / 2) of a column from its cell's
// corners k and fraction fi, in the row cell rc.
__device__ __forceinline__ float anchor(const Args& a, const Corners& k, float fi, RowCell rc) {
  return floorf(lerp(lerp(k.f00, k.f01, fi), lerp(k.f10, k.f11, fi), rc.fj) - a.half);
}

// How a tap's rows clip: to the plane itself (K13's window, K16's pieces:
// clip_h == src_h, no row offset), or as in the band form (to the true
// source's clip_h rows, then row_off rows up, then to the band's
// extension, halo.py:700-701).  A template parameter, so that no flag
// reaches a kernel's hot loop.
enum class Clip { kPlane, kBand };

// Row r clipped as C says, in 32-bit ints.  kBand's three clamps select
// the rows of clamp(clamp(r, clip_h) - row_off, src_h) as long as
// clip_h - 1 - row_off and -row_off fit an int, which the C entry
// guarantees (esw_gather.cu's dispatch refuses row_off < clip_h - 1 -
// (2^31 - 1) and row_off > 2^31 - 1).
template <Clip C>
__device__ __forceinline__ int clip_row(const Args& a, int r) {
  if constexpr (C == Clip::kBand) r = min(max(r, 0), a.clip_h - 1) - a.row_off;
  return min(max(r, 0), a.src_h - 1);
}

// The selection at tap column c from its anchor m: the offsets of rows
// m + s0 and m + s0 + 1, clipped as C says.
template <Clip C>
__device__ __forceinline__ void select_rows(const Args& a, int c, float m, float y0w,
                                            unsigned& off, unsigned& down) {
  const float s0 = fminf(fmaxf(y0w - m, 0.0f), a.s_max);
  const int r = static_cast<int>(m) + static_cast<int>(s0);
  const int ra = clip_row<C>(a, r);
  const int rb = clip_row<C>(a, r + 1);
  off = static_cast<unsigned>(ra) * static_cast<unsigned>(a.pitch) + static_cast<unsigned>(c);
  down = static_cast<unsigned>(rb - ra) * static_cast<unsigned>(a.pitch);
}

// The taps of one pixel, its anchors computed here (the per-pixel body),
// its rows clipped as C says.
template <int M, Clip C>
__device__ __forceinline__ Taps pixel_taps(const Args& a, float ix, float iy, RowCell rc) {
  const Pos p = position<M>(a, ix, iy);
  Taps t;
  t.ok = p.ok;
  t.fx = p.fx;
  t.fy = p.fy;
  const int c0 = tap_col(a, p.i0);
  const ColCell e0 = col_cell(a, c0);
  const Corners k0 = corners(a, rc, e0.i);
  const float m0 = anchor(a, k0, e0.fi, rc);
  select_rows<C>(a, c0, m0, p.y0w, t.o0, t.d0);
  if (M == kNearest) {
    t.o1 = t.d1 = 0u;
  } else {
    // the second column mostly lies in the first's cell: its corners are
    // the same values then
    const int c1 = tap_col(a, p.i0 + 1);
    const ColCell e1 = col_cell(a, c1);
    const Corners k1 = e1.i == e0.i ? k0 : corners(a, rc, e1.i);
    const float m1 = anchor(a, k1, e1.fi, rc);
    select_rows<C>(a, c1, m1, p.y0w, t.o1, t.d1);
  }
  return t;
}

// The taps of one pixel from the anchors its block staged: *stage* holds
// the pixel's row at window columns from lo.  A pixel off the source (or
// past the output's edge: ok false) reads no anchor of its own, and its
// taps are never read.  The rows clip as C says.
template <int M, Clip C>
__device__ __forceinline__ Taps staged_taps(const Args& a, const Pos& p, const float* stage,
                                            int lo) {
  Taps t;
  t.ok = p.ok;
  t.fx = p.fx;
  t.fy = p.fy;
  const int c0 = tap_col(a, p.i0);
  select_rows<C>(a, c0, stage[p.ok ? c0 - lo : 0], p.y0w, t.o0, t.d0);
  if (M == kNearest) {
    t.o1 = t.d1 = 0u;
  } else {
    const int c1 = tap_col(a, p.i0 + 1);
    select_rows<C>(a, c1, stage[p.ok ? c1 - lo : 0], p.y0w, t.o1, t.d1);
  }
  return t;
}

// The taps' value on a plane: the vertical lerps first.
template <int M>
__device__ __forceinline__ float value(const float* __restrict__ p, const Taps& t) {
  const float v00 = __ldg(p + t.o0);
  if (M == kNearest) return v00;
  const float v10 = __ldg(p + t.o0 + t.d0);
  const float v01 = __ldg(p + t.o1);
  const float v11 = __ldg(p + t.o1 + t.d1);
  if (M == kTriangular) {
    const float v_near = fmaf(t.fy, v10 - v00, lerp(v00, v01, t.fx));
    const float v_far = fmaf(1.0f - t.fy, v01 - v11, lerp(v11, v10, 1.0f - t.fx));
    return t.fx + t.fy < 1.0f ? v_near : v_far;
  }
  return lerp(lerp(v00, v10, t.fy), lerp(v01, v11, t.fy), t.fx);
}

// Output row j at kVec columns from i (n of them inside the output), its
// taps t: every band.
template <int M>
__device__ __forceinline__ void write_row(const Args& a, const Taps (&t)[kVec], int j, int i,
                                          int n) {
  for (int64_t b = 0; b < a.batch; ++b) {
    const float* p = a.src + b * a.src_plane;
    float v[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) v[c] = t[c].ok ? value<M>(p, t[c]) : a.fill;
    float* o = a.out + b * a.out_plane + static_cast<int64_t>(j) * a.out_pitch + i;
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

// Output row j (global target row a.row0 + j) at kVec columns from i (n of
// them inside the output), the per-pixel body: the taps once, then every
// band, the rows clipped as C says.
template <int M, Clip C>
__device__ __forceinline__ void one_row(const Args& a, FieldCols<2, kVec>& field, int j, int i,
                                        int n) {
  const float row = static_cast<float>(a.row0 + j);
  float f[2][kVec];  // ix, iy
  field.at(a.field, row, f);
  const RowCell rc = row_cell(a, row);
  Taps t[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) t[c] = pixel_taps<M, C>(a, f[0][c], f[1][c], rc);
  write_row<M>(a, t, j, i, n);
}

// -- the staged tile ---------------------------------------------------------
//
// A block of kWarpCols x L threads owns a tile of kTileRows target rows
// and kWarpCols * kVec columns; warp w is the threads of threadIdx.y == w.
// The anchor m(r, c) depends only on the target row and the window column,
// and a tile's valid pixels tap a narrow span of columns, so the block
// computes each (row, column) anchor of the span once, into shared memory,
// and every pixel reads its two from there:
//   1. each warp bounds the span [lo, hi] of window columns from the corners
//      of ix_c around the tile's coarse cells (coarse_span; the bound is
//      wider than the valid pixels' exact span by a few columns, and needs
//      no pass over the pixels and no barrier);
//   2. if the span fits the stage (stage_limit<M>() columns), each column
//      of the span is a thread's: its coarse cell once, the column lerps of
//      iystar_c once a coarse row cell (FieldCols' hoisting, across
//      columns), then the row lerp and the floor once a tile row; a
//      barrier;
//   3. each pixel takes its position, reads its anchors and goes straight
//      to its selection and taps.
// A tile whose span exceeds the stage runs the per-pixel body, as every tile
// does when the launch asks for no stage (staged false).  Both compute
// lerp(lerp(f00, f01, fi), lerp(f10, f11, fi), fj) with the same fused
// multiply-adds, so they give the same bits.

constexpr int kTileRows = 16;  // target rows of a tile
// window columns of anchors a tile row stages (ops/esw.py's STAGE_COLS):
// 8 KB of shared memory a block
constexpr int kStageCols = 128;

// The widest span a tile of method M stages (ops/esw.py's stage_cols): its
// stage's anchors at most three quarters of those its pixels would take one
// by one (one a pixel for nearest, two for the others), and the stage's
// width.  Nearest's tiles of 115-128 columns ran 14% slower staged than per
// pixel on an H100 (tools/tune_esw.py's sheared target).
template <int M>
__host__ __device__ constexpr int stage_limit() {
  return M == kNearest ? kStageCols * 3 / 4 : kStageCols;
}

// The window columns [lo, hi] (lo > hi: none) that the valid pixels of
// target rows [j0, j1) and output columns [i_first, i_last] may tap, taken
// by each warp alone from ix_c: a valid pixel's ix interpolates one coarse
// cell's four corners, all finite (a lerp with a NaN or infinite corner is
// not finite, so not valid), in the cells of rows floor(row / step) and
// columns floor(col / step), clamped as FieldCols clamps them.  Two nested
// lerps as fused multiply-adds stay within 6 float32 ulp of the corners'
// hull, far inside the margin 1 + |x| 2^-20; clamping, floor and rint are
// monotone, and rint(x) <= floor(x) + 1.
template <int M>
__device__ __forceinline__ void coarse_span(const Args& a, int j0, int j1, int i_first,
                                            int i_last, int& lo, int& hi) {
  const CoarseFields<2>& g = a.field;
  const auto cell = [&](int v, int n) {  // the cell in [0, n - 2]
    return static_cast<int>(
        clamp_index(static_cast<int>(floorf(static_cast<float>(v) * g.inv)), n - 1));
  };
  const int r0 = cell(a.row0 + j0, g.ncj);
  const int q0 = cell(i_first, g.nci);
  const int wq = cell(i_last, g.nci) - q0 + 2;  // corner columns
  const int n = (cell(a.row0 + j1 - 1, g.ncj) - r0 + 2) * wq;
  float x_lo = INFINITY, x_hi = -INFINITY;
  for (int e = static_cast<int>(threadIdx.x); e < n; e += 32) {
    const int q = e / wq;
    const float v = __ldg(g.f[0] + (r0 + q) * g.nci + q0 + (e - q * wq));
    if (isfinite(v)) {
      x_lo = fminf(x_lo, v);
      x_hi = fmaxf(x_hi, v);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    x_lo = fminf(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, d));
    x_hi = fmaxf(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, d));
  }
  if (x_lo > x_hi) {  // no finite corner: no valid pixel
    lo = 1;
    hi = 0;
    return;
  }
  const float margin = 1.0f + fmaxf(fabsf(x_lo), fabsf(x_hi)) * 0x1p-20f;
  x_lo = fminf(fmaxf(x_lo - margin, 0.0f), a.x_max);
  x_hi = fminf(fmaxf(x_hi + margin, 0.0f), a.x_max);
  lo = tap_col(a, static_cast<int>(floorf(x_lo)) - a.i_off);
  hi = tap_col(a, static_cast<int>(floorf(x_hi)) + 1 + (M == kNearest ? 0 : 1) - a.i_off);
}

// The anchors of tile rows [j0, j1) (at most kTileRows) at window columns
// [lo, lo + span), row r's at stage[(r - j0) * span + c - lo].  Where the
// rows lie in at most two coarse row cells (a step of at least kTileRows)
// each thread's rows are unrolled, each reading its cell's column lerps by
// a select, and lane r of each warp takes row r's cell once for the warp
// (a shuffle hands it on: every lane of a warp runs the same iterations).
__device__ __forceinline__ void stage_anchors(const Args& a, int j0, int j1, int lo, int span,
                                              float* stage) {
  const int threads = static_cast<int>(blockDim.x * blockDim.y);
  const int tid = static_cast<int>(threadIdx.y * blockDim.x + threadIdx.x);
  const RowCell first = row_cell(a, static_cast<float>(a.row0 + j0));
  const RowCell last = row_cell(a, static_cast<float>(a.row0 + j1 - 1));
  if (last.j - first.j <= 1) {
    const int lane = static_cast<int>(threadIdx.x);
    float fj_lane = 0.0f;
    int second_lane = 0;
    if (lane < kTileRows && j0 + lane < j1) {
      const RowCell rc = row_cell(a, static_cast<float>(a.row0 + j0 + lane));
      fj_lane = rc.fj;
      second_lane = rc.j != first.j;
    }
    for (int base = 0; base < span; base += threads) {
      const int e = base + tid;
      const ColCell cc = col_cell(a, lo + min(e, span - 1));
      const Corners k = corners(a, first, cc.i);
      const Corners k2 = corners(a, last, cc.i);
      const float a0 = lerp(k.f00, k.f01, cc.fi), a1 = lerp(k.f10, k.f11, cc.fi);
      const float b0 = lerp(k2.f00, k2.f01, cc.fi), b1 = lerp(k2.f10, k2.f11, cc.fi);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float fj = __shfl_sync(0xffffffffu, fj_lane, r);
        const int second = __shfl_sync(0xffffffffu, second_lane, r);
        if (e < span && j0 + r < j1) {
          stage[r * span + e] = floorf(lerp(second ? b0 : a0, second ? b1 : a1, fj) - a.half);
        }
      }
    }
    return;
  }
  for (int e = tid; e < span; e += threads) {
    const ColCell cc = col_cell(a, lo + e);
    int jc = -1;
    float a0 = 0.0f, a1 = 0.0f;
    for (int j = j0; j < j1; ++j) {
      const RowCell rc = row_cell(a, static_cast<float>(a.row0 + j));
      if (rc.j != jc) {
        jc = rc.j;
        const Corners k = corners(a, rc, cc.i);
        a0 = lerp(k.f00, k.f01, cc.fi);
        a1 = lerp(k.f10, k.f11, cc.fi);
      }
      stage[(j - j0) * span + e] = floorf(lerp(a0, a1, rc.fj) - a.half);
    }
  }
}

// Tile rows [j0, j1) (at most kTileRows) at kVec columns from i (n of
// them inside the output; n <= 0 past its right edge, where the thread
// still takes part in the barrier), the tile's output columns ending at
// i_last; the rows clip as C says (kPlane: a.clip_h == a.src_h, a.row_off
// == 0).  Every thread of the block calls it with the same tile;
// *stage* holds kTileRows * kStageCols floats; *staged* false: the tile
// runs the per-pixel body whatever its span; *again*: a tile before this
// one may still be reading the stage.
template <int M, int L, Clip C>
__device__ __forceinline__ void staged_tile(const Args& a, FieldCols<2, kVec>& field, int j0,
                                            int j1, int i, int n, int i_last, float* stage,
                                            bool staged, bool again) {
  int lo, hi;
  coarse_span<M>(a, j0, j1, i - static_cast<int>(threadIdx.x) * kVec, i_last, lo, hi);
  const int span = lo <= hi ? hi - lo + 1 : 0;
  if (!staged || span > stage_limit<M>()) {  // the block's choice: the per-pixel body
    for (int j = j0 + static_cast<int>(threadIdx.y); j < j1 && n > 0; j += L) {
      one_row<M, C>(a, field, j, i, n);
    }
    return;
  }
  if (again) __syncthreads();
  stage_anchors(a, j0, j1, lo, span, stage);
  __syncthreads();
  for (int j = j0 + static_cast<int>(threadIdx.y); j < j1 && n > 0; j += L) {
    float f[2][kVec];
    field.at(a.field, static_cast<float>(a.row0 + j), f);
    const float* s = stage + (j - j0) * span;
    Taps t[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      Pos p = position<M>(a, f[0][c], f[1][c]);
      p.ok = p.ok && c < n;
      t[c] = staged_taps<M, C>(a, p, s, lo);
    }
    write_row<M>(a, t, j, i, n);
  }
}

}  // namespace esw
}  // namespace xrt
