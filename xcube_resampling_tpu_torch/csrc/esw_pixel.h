// K13's per-pixel function, the exact separable warp of one target pixel,
// shared by K13 and its band form (esw_gather.cu) and by K16's ESW pieces
// (esw_mosaic.cu), so that the three cannot drift apart.
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

// One tap column (its cell's corners k, fraction fi): the anchor, the
// selection, and the offsets of rows m + s0 and m + s0 + 1 at column c.
__device__ __forceinline__ void tap_column(const Args& a, int c, const Corners& k, float fi,
                                           float y0w, RowCell rc, unsigned& off,
                                           unsigned& down) {
  const float pos = lerp(lerp(k.f00, k.f01, fi), lerp(k.f10, k.f11, fi), rc.fj);
  const float m = floorf(pos - a.half);
  const float s0 = fminf(fmaxf(y0w - m, 0.0f), a.s_max);
  const int r = static_cast<int>(m) + static_cast<int>(s0);
  const int ra =
      static_cast<int>(clamp_index(clamp_index(r, a.clip_h) - a.row_off, a.src_h));
  const int rb =
      static_cast<int>(clamp_index(clamp_index(r + 1, a.clip_h) - a.row_off, a.src_h));
  off = static_cast<unsigned>(ra) * static_cast<unsigned>(a.pitch) + static_cast<unsigned>(c);
  down = static_cast<unsigned>(rb - ra) * static_cast<unsigned>(a.pitch);
}

template <int M>
__device__ __forceinline__ Taps pixel_taps(const Args& a, float ix, float iy, RowCell rc) {
  Taps t;
  t.ok = ix > -0.5f && ix < a.x_hi && iy > -0.5f && iy < a.y_hi;
  ix = fminf(fmaxf(ix, 0.0f), a.x_max);
  iy = fminf(fmaxf(iy, 0.0f), a.y_max);
  float y0;
  int i0;
  if (M == kNearest) {
    y0 = rintf(iy);
    i0 = static_cast<int>(rintf(ix)) - a.i_off;
    t.fx = t.fy = 0.0f;
  } else {
    y0 = floorf(iy);
    t.fy = iy - y0;
    const float x0 = floorf(ix);
    t.fx = ix - x0;
    i0 = static_cast<int>(x0) - a.i_off;
  }
  const float y0w = y0 - a.j_off;
  const int last = a.src_w - 1;
  const int c0 = min(max(i0, 0), last);
  const ColCell e0 = col_cell(a, c0);
  const Corners k0 = corners(a, rc, e0.i);
  tap_column(a, c0, k0, e0.fi, y0w, rc, t.o0, t.d0);
  if (M == kNearest) {
    t.o1 = t.d1 = 0u;
  } else {
    // the second column mostly lies in the first's cell: its corners are
    // the same values then
    const int c1 = min(max(i0 + 1, 0), last);
    const ColCell e1 = col_cell(a, c1);
    const Corners k1 = e1.i == e0.i ? k0 : corners(a, rc, e1.i);
    tap_column(a, c1, k1, e1.fi, y0w, rc, t.o1, t.d1);
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

// Output row j (global target row a.row0 + j) at kVec columns from i (n of
// them inside the output): the taps once, then every band.
template <int M>
__device__ __forceinline__ void one_row(const Args& a, FieldCols<2, kVec>& field, int j, int i,
                                        int n) {
  const float row = static_cast<float>(a.row0 + j);
  float f[2][kVec];  // ix, iy
  field.at(a.field, row, f);
  const RowCell rc = row_cell(a, row);
  Taps t[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) t[c] = pixel_taps<M>(a, f[0][c], f[1][c], rc);
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

}  // namespace esw
}  // namespace xrt
