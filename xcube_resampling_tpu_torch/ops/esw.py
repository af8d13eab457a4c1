"""K13: the exact separable warp (ESW) on PyTorch tensors.

Port of ``xcube_resampling_tpu/ops/esw.py``.  The ESW reproduces the
direct gather built on the same grid mappings (bit-exact nearest, within 2
float32 ulp bilinear: it lerps vertically first, the gather horizontally
first) for warps past the two-pass SRW's fidelity gate, up to local
rotation slopes of about (S - 2) / 2 source pixels a pixel.

The numpy planners are copies of the JAX package's: ``ESWPlan`` (:61-109),
``_max_row_deviation`` (:112-154), ``_static_cover`` (:157-216),
``plan_esw`` (:231-547), ``_slice_raw`` (:1095-1106) and
``_offset_fields`` (:1109-1125), with ``_interp_field_np``, the numpy
branch of ``reproject_ops._interp_field``.  ``plan_esw``'s accept or
refuse decision is what makes the port choose the JAX package's tier; the
tap layout it plans (bases, tap counts, shifts, tiles) decides that
refusal, and otherwise serves the TPU's gather-free formulation, which
selects S rows per (output row, source column) into S full-size fields
because the TPU serialises dynamic gathers.  Its tile layouts take each
tile's extrema over contiguous rows (``_row_range_extrema``) where the JAX
package reduces strided ones, and an unforced plan refuses first, before
the row deviation and any layout, where the coarse nodes' own span already
bounds every tiling's tap count past ``max_taps`` (a singular warp such as
BASELINE #3's): the same plans and refusals in a fraction of the host's
time.  ``force`` pins the layout of an exact region mosaic's group
(``ops/esw_mosaic.py``): the sample count S (the group's), one column and
one row tile, the shift alignment on either axis, and a limit of
``2 * max_taps`` on the fixed tiles' counts; it takes no shortcut.  The
static-cover pass gives the cover's slice counts ``jv``, ``jh`` (and per
tile ``jv_t``, ``jh_t``) under the JAX package's default gates: they lay
out the TPU's taps, and the mosaic's cost estimate reads them to decide
which pieces it demotes to the direct gather.  Not kept: the cover
sequences themselves, the gates' switches ``XRTPU_ESW_STATIC``,
``XRTPU_ESW_STATIC_RV`` and ``XRTPU_ESW_STATIC_RH`` (no path of the port
sets them), and ``force``'s row-tile sweep (``XRTPU_MOSAIC_ROW_TILE``,
which the JAX package marks as measurement-only).

On the card each output pixel reads its taps directly: K13
(``esw_gather``, ``csrc/esw_gather.cu``) computes the function of the JAX
package's ``precompute`` and ``kernel`` (:616-876) per pixel from the
coarse fields, with no per-pixel statics:

* the float32 positions, validity and clamps of the direct gather, in
  global source indices;
* ``floor`` (``rint`` for nearest), then the window offsets ``i_off`` and
  ``j_off`` subtracted after rounding;
* at each of the two tap columns ``c = i0`` and ``min(i0 + 1, W - 1)``
  (window space) the anchor ``m = floor(iy*(r, c) - (S - 2) / 2)`` and the
  JAX package's selection clamp ``s0 = clip(y0 - j_off - m, 0, S - 2)``
  (``S - 1`` for nearest);
* rows ``m + s0`` and ``m + s0 + 1``, clipped to the window, read at
  column ``c``;
* the vertical lerp first, then the horizontal one (for triangular the
  four taps and ``gather.grid_sample``'s two-triangle split), as fused
  multiply-adds where XLA contracts them; the fill where the pixel is not
  valid.

The TPU layout's shift alignment moves values, not positions: the shifted source and anchors are value-equal to the
unshifted ones, so the per-pixel form needs none of them.  Nor does it
need ``XRTPU_ESW_PERTILE``, a TPU tiling knob whose outputs are bit-equal
(``tests/test_esw.py:206``).

The anchor depends only on the target row and the window column, so K13
stages it: a block of its kernel owns a tile of ``STAGE_TILE`` target
pixels, bounds the window columns its valid pixels tap from the coarse
field ``ix_c`` (``tile_spans``), computes the anchor of every (tile row,
column of the span) once into shared memory (``stage_cols`` columns) and
each pixel reads its two from there; a tile whose span exceeds the
stage, and every tile of a launch with ``staged=False``, compute each
pixel's anchors themselves.  Both take the same fused multiply-adds, so
they give the same bits.

``esw_gather_band`` is K13's band form, the sharded ESW step's band
kernel (``xcube_resampling_tpu/parallel/halo.py:650-791``): K13 at the
band's global target rows from ``row0``, on the band's source rows
extended by the halo, global source row ``off`` first (no window).  Each
wrapper runs its plain version (``esw_gather_plain``,
``esw_gather_band_plain``) for CPU tensors and launches its kernel for
CUDA tensors, or raises, and counts its launches under its own name.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .._device import as_float32, count_launch, on_cpu, require_cuda
from ..gridmapping import GridMapping
from .reproject_ops import (
    METHODS,
    interp_field,
    interp_taps_f32,
    lerp,
    method_code,
    require_int32_planes,
)
from .srw import (
    _coarse_geometry,
    _Fields,
    _interp_cols,
    _interp_rows,
    _source_window_gm,
)

_F32 = torch.float32


# ---------------------------------------------------------------------------
# host-side planning (copies of the JAX package's numpy planners)
# ---------------------------------------------------------------------------


def _interp_field_np(field, rows, cols, step):
    """The numpy branch of ``reproject_ops._interp_field``: bilinear
    interpolation of a coarse (ncj, nci) field at target rows and cols."""
    inv = 1.0 / step
    cj = rows * inv
    ci = cols * inv
    j0 = np.floor(cj).astype(np.int32)
    i0 = np.floor(ci).astype(np.int32)
    fj = cj - j0
    fi = ci - i0
    j0 = np.clip(j0, 0, field.shape[0] - 2)
    i0 = np.clip(i0, 0, field.shape[1] - 2)
    f00 = field[j0, i0]
    f01 = field[j0, i0 + 1]
    f10 = field[j0 + 1, i0]
    f11 = field[j0 + 1, i0 + 1]
    f0 = f00 + fi * (f01 - f00)
    f1 = f10 + fi * (f11 - f10)
    return f0 + fj * (f1 - f0)


@dataclass
class ESWPlan:
    """Tiled exact-warp plan (see module docstring).

    ``ix_c``/``iy_c`` hold GLOBAL source indices (float32 casts of the same
    float64 fields the gather kernel uses) even when the kernel runs on a
    cropped source window; ``iystar_c`` and the tap bases are window-
    relative."""

    iystar_c: np.ndarray  # (ncj, ncc) float32 coarse reparametrized rows
    ix_c: np.ndarray  # (ncj, nci) float32 coarse source-col field (global)
    iy_c: np.ndarray  # (ncj, nci) float32 coarse source-row field (global)
    step: int
    n_samples: int  # S: consecutive source rows kept per (r, c)
    base_v: np.ndarray  # (out_h, n_col_tiles) int32 vertical tap bases
    d_v: int
    col_tile: int
    base_h: np.ndarray  # (n_row_tiles, out_w) int32 horizontal tap bases
    d_h: int
    row_tile: int
    # optional shift alignment (rotation-heavy warps): log2 roll passes
    # remove the mean coordinate trend so the per-tile tap spans stay
    # small; bases/selection then live in the shifted (residual) space
    s_v: np.ndarray | None  # (src_w,) int32 >= 0 upward shift per src col
    bits_v: int
    s_h: np.ndarray | None  # (out_h,) int32 >= 0 left shift per out row
    bits_h: int
    src_h: int  # window dims (== global when not cropped)
    src_w: int
    out_h: int
    out_w: int
    src_h_g: int  # global source dims (validity/clamping space)
    src_w_g: int
    j_off: int  # window origin in global source indices
    i_off: int
    # per-tile tap counts (maxima of the scalars above): the JAX kernel
    # unrolls its tile loops in Python, so each tile can stop at its OWN
    # count — mild interior tiles stop paying the worst tile's diversity
    d_v_t: tuple | None = None  # len n_col_tiles
    d_h_t: tuple | None = None  # len n_row_tiles
    # the static-cover formulation's slice counts (0 and None where the
    # cover does not exist or its gate refuses it; see _static_cover)
    jv: int = 0
    jh: int = 0
    jv_t: tuple | None = None  # len n_col_tiles
    jh_t: tuple | None = None  # len n_row_tiles


def _max_row_deviation(fields: _Fields, refine: int = 2) -> float:
    """Max over valid sample points of |iy_cl(r,x) - iy*(r, c_tap)| for both
    column taps c_tap in {floor(ix_cl), floor(ix_cl)+1}.

    Evaluated on a ``refine``-times refined coarse grid (O(ncj*nci), not
    O(out*src) — the planner runs on a single host core): between nodes all
    fields interpolate (bi)linearly, so the composition's interior extrema
    are quadratic-ish in the cell and half-step sampling bounds them to
    within a fraction the caller's sample margin absorbs."""
    step = fields.step
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    iystar = fields.iystar64

    fine = step / refine
    rows = np.arange(0, out_h, fine, dtype=np.float64)[:, None]
    cols = np.arange(0, out_w, fine, dtype=np.float64)[None, :]
    ix = _interp_field_np(fields.ix64, rows, cols, step)
    iy = _interp_field_np(fields.iy64, rows, cols, step)

    valid = (ix > -0.5) & (ix < src_w - 0.5) & (iy > -0.5) & (iy < src_h - 0.5)
    if not valid.any():
        return 0.0
    ix_cl = np.clip(ix, 0, src_w - 1)
    iy_cl = np.clip(iy, 0, src_h - 1)

    # iy* interpolated to the refined output rows
    rr = rows[:, 0] / step
    j0 = np.clip(rr.astype(np.int64), 0, iystar.shape[0] - 2)
    fj = (rr - j0)[:, None]
    p_rows = iystar[j0, :] * (1 - fj) + iystar[j0 + 1, :] * fj

    ncc = iystar.shape[1]
    dev = np.zeros_like(ix_cl)
    for c_tap in (np.floor(ix_cl), np.floor(ix_cl) + 1):
        c_tap = np.minimum(c_tap, src_w - 1)
        k0 = np.clip((c_tap / step).astype(np.int64), 0, ncc - 2)
        frac = c_tap / step - k0
        pa = np.take_along_axis(p_rows, k0, axis=1)
        pb = np.take_along_axis(p_rows, k0 + 1, axis=1)
        p = pa + frac * (pb - pa)
        dev = np.maximum(dev, np.abs(iy_cl - p))
    return float(dev[valid].max())


def _static_cover(base: np.ndarray, d, axis: int):
    """Monotone unit-increment cover sequences for the JAX package's
    static-slice tap formulation (``esw.py:157-216``).

    For each 1-D lane of ``base`` (per column when ``axis=0``, per row when
    ``axis=1``) build ``cov`` of length ``n + J`` with increments in {0, 1}
    such that for every position r the window ``cov[r : r + J]`` contains
    every integer in ``[base[r], base[r] + d)``; ``d`` may be a scalar or a
    per-lane array.  Returns ``(cov, J_t)`` with ``J_t`` the per-lane slice
    counts, or ``(None, None)`` when no cover exists (the base advances
    faster than one source index per output index somewhere)."""
    b = base if axis == 0 else base.T  # (n, lanes)
    n, lanes = b.shape
    b64 = b.astype(np.int64)
    # largest valid cover: backward running min (nondecreasing, <= base)
    cov = np.minimum.accumulate(b64[::-1], axis=0)[::-1]
    if n > 1 and (np.diff(cov, axis=0) > 1).any():
        return None, None
    d_lane = np.broadcast_to(np.asarray(d, dtype=np.int64), (lanes,))
    targets = b64 + d_lane[None, :] - 1
    tail = int(max(0, targets.max() - cov[-1].min()))
    cov_ext = np.concatenate(
        [cov, cov[-1][None, :] + 1 + np.arange(tail, dtype=np.int64)[:, None]]
    )
    # first k >= r with cov_ext[k] >= target[r], per lane
    J_t = np.ones(lanes, dtype=np.int64)
    for c in range(lanes):
        k = np.searchsorted(cov_ext[:, c], targets[:, c], side="left")
        J_t[c] = max(1, int((k - np.arange(n)).max()) + 1)
    J = int(J_t.max())
    out = cov_ext[: n + J]
    if out.shape[0] < n + J:  # tail too short (all-flat targets edge case)
        extra = n + J - out.shape[0]
        out = np.concatenate(
            [out, out[-1][None, :] + 1 + np.arange(extra, dtype=np.int64)[:, None]]
        )
    out = out.astype(np.int32)
    return (out if axis == 0 else out.T), J_t


# static-cover cost gates, per axis (J <= ratio * d engages the static
# formulation): the JAX package's (esw.py:219-228)
_STATIC_J_RATIO_V = 3.0
_STATIC_J_RATIO_H = 3.5


def _cover_counts(base_v, dv_t, base_h, dh_t):
    """The static-cover pass of ``plan_esw`` (``esw.py:487-510``) with its
    defaults: the slice counts ``(jv, jv_t, jh, jh_t)`` of the covers that
    exist and pass their ratio gates, ``(0, None)`` on an axis where none
    does."""
    jv = jh = 0
    jv_t = jh_t = None
    cv_, jvt_ = _static_cover(base_v, dv_t, axis=0)
    if cv_ is not None and float(jvt_.mean()) <= _STATIC_J_RATIO_V * float(dv_t.mean()):
        jv, jv_t = int(jvt_.max()), tuple(int(x) for x in jvt_)
    ch_, jht_ = _static_cover(base_h, dh_t, axis=1)
    if ch_ is not None and float(jht_.mean()) <= _STATIC_J_RATIO_H * float(dh_t.mean()):
        jh, jh_t = int(jht_.max()), tuple(int(x) for x in jht_)
    return jv, jv_t, jh, jh_t


def _row_range_extrema(a: np.ndarray, k0: np.ndarray, k1: np.ndarray):
    """Min and max of the C-contiguous 2D *a* over its rows ``[k0[t],
    k1[t])``, one (n_t, a.shape[1]) pair (ranges may overlap): contiguous
    row blocks, where a tile's columns of a wide array are strided."""
    lo = np.empty((len(k0), a.shape[1]), dtype=a.dtype)
    hi = np.empty_like(lo)
    for t, (r0, r1) in enumerate(zip(k0, k1)):
        np.minimum.reduce(a[r0:r1], axis=0, out=lo[t])
        np.maximum.reduce(a[r0:r1], axis=0, out=hi[t])
    return lo, hi


def plan_esw(
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
    max_taps: int = 40,
    max_samples: int = 10,
    fields: _Fields | None = None,
    fields_global: _Fields | None = None,
    win: tuple[int, int, int, int] | None = None,
    force: dict | None = None,
) -> ESWPlan | None:
    """Build an exact-warp plan, or None when the mapping is unsuitable
    (non-monotone rows near a projection singularity, a row deviation that
    would need more than ``max_samples`` kept rows, or tap counts beyond
    ``max_taps`` at every tile size).

    For a cropped source window, pass the window-relative ``fields`` (the
    tap machinery plans in window space), the uncropped ``fields_global``
    and the window ``win`` = (j0, j1, i0, i1): the plan then stores the
    global coordinate fields for bit-exact positions.

    ``force`` (the mosaic's) pins the layout decisions, keys
    ``n_samples``, ``col_tile``, ``row_tile``, ``use_shift_v`` and
    ``use_shift_h``, so that all pieces of a mosaic group share them; the
    per-piece tap counts and bases still come from the piece's own
    geometry.  A forced plan is refused where the piece needs more samples
    than the group's or a fixed tile more than ``2 * max_taps`` taps."""
    if fields is None:
        fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    if fields_global is None:
        fields_global = fields
    j_off, i_off = (win[0], win[2]) if win is not None else (0, 0)

    iystar = fields.iystar64
    ix64 = fields.ix64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    step = fields.step

    # ---- vertical tap layout: per-(output row, source col tile) bases,
    # optionally in shift-aligned residual space (derivative-midrange
    # integer shift per source column removes the mean rotation trend)
    ncc = iystar.shape[1]
    cs = np.arange(ncc, dtype=np.float64) * step

    tiles_v = (512, 256, 128, 64, 32, 16)

    def _col_tiles(res_rows_t, col_tile):
        # each column tile's extrema of res_rows_t: (ncc, rows), the rows'
        # field transposed
        c0 = np.arange(0, src_w, col_tile)
        c1 = np.minimum(c0 + col_tile, src_w)
        k0 = np.maximum(0, c0 // step - 1)
        k1 = np.minimum(ncc, -(-c1 // step) + 1)
        return _row_range_extrema(res_rows_t, k0, k1)

    def _v_layout(res_rows_t, col_tile):
        m, top = _col_tiles(res_rows_t, col_tile)
        base = np.ascontiguousarray((np.floor(m - half).astype(np.int32) - 2).T)
        # taps must cover the whole window [m, m+S-1] for every column
        # of the tile: tile span + S samples + float/interp safety
        d_t = np.ceil((top - m).max(axis=1)).astype(np.int64) + n_samples + 4
        return base, d_t

    def _rows_t(field):  # C order: a tile's coarse columns are rows
        return np.ascontiguousarray(_interp_rows(field, out_h, step).T)

    def _best_tiling(layout_fn, res, candidates):
        best = None
        for cand in candidates:
            base, d_t = layout_fn(res, cand)
            # per-tile counts: cost follows the MEAN tap count (the kernel
            # stops each tile at its own diversity), feasibility the max
            d = int(d_t.max())
            eff = float(d_t.mean()) * max(1.0, 96.0 / cand)
            if d <= max_taps and (best is None or eff < best[0]):
                best = (eff, cand, base, d_t)
        return best

    def _sv_full():
        dv_ = np.diff(iystar, axis=1)
        mid_slope_v = 0.5 * (dv_.max(axis=0) + dv_.min(axis=0))
        s_v_coarse = np.round(np.concatenate([[0.0], np.cumsum(mid_slope_v)]))
        s_v0 = np.round(
            np.interp(np.arange(src_w, dtype=np.float64), cs, s_v_coarse)
        ).astype(np.int64)
        s_v0_at_cs = s_v0[np.clip(cs.astype(np.int64), 0, src_w - 1)]
        return (
            (s_v0 - s_v0.min()).astype(np.int32),
            iystar - (s_v0_at_cs - s_v0.min())[None, :],
        )

    # a refusal that needs neither S nor the tap layout: the coarse nodes'
    # rows are output rows of the interpolated field, and the smallest
    # tile's columns lie inside every larger tile's, so their span there
    # bounds every tiling's tap count from below (S >= 3).  Where it
    # exceeds max_taps in plain and in shifted space, no tiling fits.  A
    # forced plan has one tile and another limit: it takes no shortcut.
    s_v_full, res_v = _sv_full()
    n_nodes = min(iystar.shape[0] - 1, (out_h - 1) // step + 1)
    if force is None and all(
        np.ceil((top - m).max()) + 3 + 4 > max_taps
        for m, top in (
            _col_tiles(np.ascontiguousarray(r[:n_nodes].T), min(tiles_v))
            for r in (iystar, res_v)
        )
    ):
        return None

    # sample count: window [m, m+S-1] covers [y0, y0+1] whenever
    # |iy - iy*| <= (S-2)/2; the deviation is measured on a refined coarse
    # grid, the margin covers interior curvature + float32 interp noise
    margin = 0.35
    dev = _max_row_deviation(fields)
    n_samples = int(np.ceil(2.0 * (dev + margin))) + 2
    n_samples = max(3, n_samples)
    if force is not None:
        if n_samples > force["n_samples"]:
            return None
        n_samples = force["n_samples"]
    if n_samples > max_samples:
        return None
    half = (n_samples - 2) / 2.0

    if force is not None:
        use_shift_v = force["use_shift_v"]
        col_tile = force["col_tile"]
        base_v, dv_t = _v_layout(_rows_t(res_v if use_shift_v else iystar), col_tile)
        s_v = s_v_full if use_shift_v else None
        bits_v = int(s_v_full.max()).bit_length() if use_shift_v else 0
        if int(dv_t.max()) > 2 * max_taps:
            return None
    else:
        plain_v = _best_tiling(_v_layout, _rows_t(iystar), tiles_v)

        # shifted-space candidate (skipped when plain span already tiny)
        shifted_v = None
        if s_v_full.max() > 0 and (
            plain_v is None or int(plain_v[3].max()) > n_samples + 8
        ):
            shifted_v = _best_tiling(_v_layout, _rows_t(res_v), tiles_v)

        bits_v = int(s_v_full.max()).bit_length()
        # vertical taps touch (out_h, src_w)-sized streams (1 take + S
        # selects each); roll passes touch the (src_h, src_w) source once
        # per bit — weight them by the array-size ratio.  Costs compare
        # MEAN per-tile counts (the kernel stops each tile at its own)
        roll_w_v = src_h / max(1, out_h * (1 + n_samples))
        use_shift_v = shifted_v is not None and (
            plain_v is None
            or float(shifted_v[3].mean()) + roll_w_v * bits_v
            < float(plain_v[3].mean())
        )
        chosen_v = shifted_v if use_shift_v else plain_v
        if chosen_v is None:
            return None
        _, col_tile, base_v, dv_t = chosen_v
        s_v = s_v_full if use_shift_v else None
        if not use_shift_v:
            bits_v = 0
    d_v = int(dv_t.max())

    # ---- horizontal tap layout: per-(row tile, output col) bases,
    # optionally shift-aligned per output row
    ncj = ix64.shape[0]
    sample_rows = np.arange(ncj) * step

    def _h_layout(res_cols, row_tile):
        r0 = np.arange(0, out_h, row_tile)
        r1 = np.minimum(r0 + row_tile, out_h)
        k0 = np.maximum(0, np.searchsorted(sample_rows, r0) - 1)
        k1 = np.minimum(ncj, np.searchsorted(sample_rows, r1) + 2)
        m, top = _row_range_extrema(res_cols, k0, k1)
        base = np.floor(m).astype(np.int32) - 2
        # +1 for the right column tap, + float/interp safety
        d_t = np.ceil((top - m).max(axis=1)).astype(np.int64) + 5
        return base, d_t

    def _cols(field):  # C order (the interpolation gives F order)
        return np.ascontiguousarray(_interp_cols(field, out_w, step))

    def _sh_full():
        dh_ = np.diff(ix64, axis=0)
        mid_slope_h = 0.5 * (dh_.max(axis=1) + dh_.min(axis=1))
        s_h_coarse = np.round(np.concatenate([[0.0], np.cumsum(mid_slope_h)]))
        rows_grid = np.arange(ncj, dtype=np.float64) * step
        s_h0 = np.round(
            np.interp(
                np.arange(out_h, dtype=np.float64), rows_grid, s_h_coarse
            )
        ).astype(np.int64)
        s_h0_at_rows = s_h0[np.clip(rows_grid.astype(np.int64), 0, out_h - 1)]
        return (
            (s_h0 - s_h0.min()).astype(np.int32),
            ix64 - (s_h0_at_rows - s_h0.min())[:, None],
        )

    s_h_full, res_h = _sh_full()
    if force is not None:
        use_shift_h = force["use_shift_h"]
        row_tile = force["row_tile"]
        base_h, dh_t = _h_layout(_cols(res_h if use_shift_h else ix64), row_tile)
        s_h = s_h_full if use_shift_h else None
        bits_h = int(s_h_full.max()).bit_length() if use_shift_h else 0
        if int(dh_t.max()) > 2 * max_taps:
            return None
    else:
        tiles_h = (512, 256, 128, 64, 32, 16)
        plain_h = _best_tiling(_h_layout, _cols(ix64), tiles_h)

        shifted_h = None
        if s_h_full.max() > 0 and (
            plain_h is None or int(plain_h[3].max()) > 10
        ):
            shifted_h = _best_tiling(_h_layout, _cols(res_h), tiles_h)

        bits_h = int(s_h_full.max()).bit_length()
        # horizontal taps read S+1 (rt, out_w)-sized streams each; rolls
        # move the S (out_h, src_w) sample fields once per bit
        roll_w_h = (n_samples * src_w) / max(1, (1 + n_samples) * out_w)
        use_shift_h = shifted_h is not None and (
            plain_h is None
            or float(shifted_h[3].mean()) + roll_w_h * bits_h
            < float(plain_h[3].mean())
        )
        chosen_h = shifted_h if use_shift_h else plain_h
        if chosen_h is None:
            return None
        _, row_tile, base_h, dh_t = chosen_h
        s_h = s_h_full if use_shift_h else None
        if not use_shift_h:
            bits_h = 0
    d_h = int(dh_t.max())

    jv, jv_t, jh, jh_t = _cover_counts(base_v, dv_t, base_h, dh_t)
    return ESWPlan(
        iystar_c=iystar.astype(np.float32),
        ix_c=fields_global.ix64.astype(np.float32),
        iy_c=fields_global.iy64.astype(np.float32),
        step=step,
        n_samples=n_samples,
        base_v=base_v,
        d_v=d_v,
        col_tile=col_tile,
        base_h=base_h,
        d_h=d_h,
        row_tile=row_tile,
        s_v=s_v,
        bits_v=bits_v,
        s_h=s_h,
        bits_h=bits_h,
        src_h=src_h,
        src_w=src_w,
        out_h=out_h,
        out_w=out_w,
        src_h_g=fields_global.src_h,
        src_w_g=fields_global.src_w,
        j_off=j_off,
        i_off=i_off,
        d_v_t=tuple(int(x) for x in dv_t),
        d_h_t=tuple(int(x) for x in dh_t),
        jv=jv,
        jh=jh,
        jv_t=jv_t,
        jh_t=jh_t,
    )


def _slice_raw(ix64, iy64, step, r0, r1, c0, c1):
    """Slice the whole-target raw coarse fields to the target sub-window
    [r0:r1) x [c0:c1) (r0/c0 step-aligned by construction of the quadtree):
    the slice keeps the parent's float64 values bit for bit, so every piece
    sees exactly the coordinate field the whole-target gather sees."""
    jr0, ji0 = r0 // step, c0 // step
    njr = (r1 - r0 - 1) // step + 2
    nji = (c1 - c0 - 1) // step + 2
    return (
        ix64[jr0 : jr0 + njr, ji0 : ji0 + nji],
        iy64[jr0 : jr0 + njr, ji0 : ji0 + nji],
    )


def _offset_fields(fields: _Fields, j0: int, j1: int, i0: int, i1: int):
    """Re-express coarse fields relative to the source window
    [j0:j1) x [i0:i1); j0 and i0 must be aligned to the coarse step (as
    produced by _source_window_gm)."""
    step = fields.step
    k0 = i0 // step
    ncc = (i1 - i0 - 1) // step + 2
    return _Fields(
        fields.ix64 - i0,
        fields.iy64 - j0,
        fields.iystar64[:, k0 : k0 + ncc] - j0,
        step,
        j1 - j0,
        i1 - i0,
        fields.out_h,
        fields.out_w,
    )


# ---------------------------------------------------------------------------
# K13 and its band form
# ---------------------------------------------------------------------------


# the staged kernels' tile (target rows, columns) and stage (window
# columns of anchors a tile row): csrc/esw_pixel.h's kTileRows, the
# kernels' kTileCols and kStageCols
STAGE_TILE = (16, 128)
STAGE_COLS = 128
# the band kernel's blocks an SM and the fewest rows its tiles stage in
# (csrc/esw_gather.cu's kBandBlocks, kBandStageRows)
BAND_BLOCKS = 12
BAND_STAGE_ROWS = 8


def stage_cols(interp_method):
    """The widest span a tile stages (``csrc/esw_pixel.h``'s
    ``stage_limit``): ``STAGE_COLS``, three quarters of it for nearest,
    whose pixels take one anchor each, not two."""
    return STAGE_COLS * 3 // 4 if interp_method == "nearest" else STAGE_COLS


def band_tile_rows(out_h, out_w, sms):
    """Rows a tile of K13's band form on a card of *sms* SMs
    (``csrc/esw_gather.cu``'s ``band_tile_rows``): ``STAGE_TILE``'s 16, or,
    where the band's tiles would fill less than one wave of
    ``BAND_BLOCKS`` blocks an SM, as few as spread its rows over that
    wave, at least 2 (a row for each of a block's two warps).  Tiles of
    fewer than ``BAND_STAGE_ROWS`` rows compute every anchor per pixel."""
    th, tw = STAGE_TILE
    cols = -(-out_w // tw)
    slots = sms * BAND_BLOCKS
    if cols * -(-out_h // th) >= slots:
        return th
    return max(2, -(-out_h * cols // slots))


def tile_spans(ix_c, step, out_h, out_w, bound_w, i_off, width, interp_method, row0=0,
               tile_rows=STAGE_TILE[0]):
    """The span of window columns (0: none) that a staged kernel stages
    for each tile of *tile_rows* by ``STAGE_TILE``'s 128 columns of an
    (out_h, out_w) target whose row 0 lies at global target row *row0*
    (K13's band form, its tiles of :func:`band_tile_rows`; 0 elsewhere): the
    bound each warp takes from the finite corners of the coarse field
    *ix_c* around the tile's coarse cells (``csrc/esw_pixel.h``'s
    ``coarse_span``), for a source *bound_w* columns wide read through a
    window of *width* columns from column *i_off*.  A (tiles down, tiles
    across) int64 tensor; a tile whose span exceeds
    ``stage_cols(interp_method)`` computes its anchors per pixel."""
    th, tw = tile_rows, STAGE_TILE[1]
    dev = ix_c.device
    ncj, nci = ix_c.shape
    inv = torch.tensor(1.0 / step, dtype=_F32, device=dev)

    def cells(first, last, n):  # the coarse cells of each tile's first and last index
        def cell(v):
            return torch.floor(v.to(_F32) * inv).long().clamp(0, n - 2)

        return cell(first), cell(last)

    r0 = torch.arange(0, out_h, th, device=dev)
    q0 = torch.arange(0, out_w, tw, device=dev)
    ra, rb = cells(row0 + r0, row0 + (r0 + th - 1).clamp(max=out_h - 1), ncj)
    qa, qb = cells(q0, (q0 + tw - 1).clamp(max=out_w - 1), nci)
    inf = torch.tensor(float("inf"), dtype=_F32, device=dev)
    lo = inf.expand(len(r0), len(q0))
    hi = -lo
    for dr in range(int((rb - ra).max()) + 2):
        r = torch.minimum(ra + dr, rb + 1)[:, None]
        for dq in range(int((qb - qa).max()) + 2):
            v = ix_c[r, torch.minimum(qa + dq, qb + 1)[None, :]]
            finite = torch.isfinite(v)
            lo = torch.where(finite, torch.minimum(lo, v), lo)
            hi = torch.where(finite, torch.maximum(hi, v), hi)
    none = lo > hi
    lo, hi = torch.where(none, 0.0, lo), torch.where(none, 0.0, hi)
    margin = 1.0 + torch.maximum(lo.abs(), hi.abs()) * 2.0**-20
    x_max = float(np.float32(bound_w - 1))
    c_lo = torch.floor((lo - margin).clamp(0, x_max)).long() - i_off
    c_hi = torch.floor((hi + margin).clamp(0, x_max)).long() - i_off
    c_hi = c_hi + (1 if interp_method == "nearest" else 2)
    span = c_hi.clamp(0, width - 1) - c_lo.clamp(0, width - 1) + 1
    return torch.where(none, 0, span)


def _column_taps(iystar_c, step, half, rows, col, y0w, s_max, ext_h, width, clip_h,
                 row_off):
    """One tap column: window column ``col`` clipped to the plane, its
    anchor ``m``, the selection ``s0 = clip(y0w - m, 0, s_max)``, and rows
    ``m + s0`` and ``m + s0 + 1``, each clipped to ``[0, clip_h)`` and then
    taken ``row_off`` rows up (inside the plane's *ext_h* rows)."""
    c = col.clamp(0, width - 1)
    m = torch.floor(interp_field(iystar_c, rows, c.to(_F32), step) - half)
    s0 = (y0w - m).clamp(0, s_max)
    r = (m + s0).long()
    ra = (r.clamp(0, clip_h - 1) - row_off).clamp(0, ext_h - 1)
    rb = ((r + 1).clamp(0, clip_h - 1) - row_off).clamp(0, ext_h - 1)
    return ra, rb, c


def esw_taps(plane, iystar_c, ix_c, iy_c, step, n_samples, interp_method, row0,
             out_h, out_w, bound_h, bound_w, j_off, i_off, clip_h, row_off):
    """K13's taps on a plane of ``plane`` = (H, W): target rows from
    *row0*, the validity and clamps against a source of *bound_h* x
    *bound_w*, the window offsets *j_off*, *i_off*, the taps' rows clipped
    to *clip_h* and read *row_off* rows up.  Returns ``(valid, fx, fy,
    columns)``: ``columns`` holds ``(ra, rb, c)`` (rows and column of the
    upper and lower tap) for column ``i0``, and for ``i0 + 1`` unless
    nearest; fx, fy are None for nearest."""
    method_code(interp_method)
    dev = ix_c.device
    ext_h, width = plane
    rows = torch.arange(row0, row0 + out_h, dtype=_F32, device=dev)[:, None]
    cols = torch.arange(out_w, dtype=_F32, device=dev)[None, :]
    ix = interp_field(ix_c, rows, cols, step)
    iy = interp_field(iy_c, rows, cols, step)
    valid = (ix > -0.5) & (ix < bound_w - 0.5) & (iy > -0.5) & (iy < bound_h - 0.5)
    ix = ix.clamp(0, bound_w - 1)
    iy = iy.clamp(0, bound_h - 1)
    nearest = interp_method == "nearest"
    fx = fy = None
    if nearest:
        y0 = torch.round(iy)
        i0 = torch.round(ix).long() - i_off
    else:
        y0 = torch.floor(iy)
        fy = iy - y0
        x0 = torch.floor(ix)
        fx = ix - x0
        i0 = x0.long() - i_off
    y0w = y0 - j_off
    half = (n_samples - 2) / 2.0
    s_max = n_samples - 1 if nearest else n_samples - 2
    columns = [
        _column_taps(iystar_c, step, half, rows, col, y0w, s_max, ext_h, width, clip_h,
                     row_off)
        for col in ((i0,) if nearest else (i0, i0 + 1))
    ]
    return valid, fx, fy, columns


def _esw_plain(src, iystar_c, ix_c, iy_c, step, n_samples, interp_method,
               fill_value, row0, out_h, out_w, bound_h, bound_w, j_off, i_off,
               clip_h, row_off):
    """K13's function on (B, H, W) *src* (:func:`esw_taps`)."""
    src = src.to(_F32)
    valid, fx, fy, columns = esw_taps(
        src.shape[-2:], iystar_c, ix_c, iy_c, step, n_samples, interp_method, row0,
        out_h, out_w, bound_h, bound_w, j_off, i_off, clip_h, row_off,
    )
    (ra0, rb0, c0), *rest = columns
    v00, v10 = src[..., ra0, c0], src[..., rb0, c0]
    if not rest:
        out = v00
    else:
        ((ra1, rb1, c1),) = rest
        v01, v11 = src[..., ra1, c1], src[..., rb1, c1]
        if interp_method == "triangular":
            out = interp_taps_f32(v00, v01, v10, v11, fx, fy, interp_method)
        else:
            out = lerp(lerp(v00, v10, fy), lerp(v01, v11, fy), fx)
    fill = torch.tensor(float(np.float32(fill_value)), dtype=_F32, device=src.device)
    return torch.where(valid, out, fill)


def esw_gather_plain(src, iystar_c, ix_c, iy_c, step, n_samples, out_h, out_w,
                     src_h_g, src_w_g, j_off, i_off, interp_method, fill_value):
    """Plain PyTorch version of K13: (B, out_h, out_w) from the (B, H, W)
    source window whose row 0 and column 0 lie at global source row
    *j_off* and column *i_off* of a source *src_h_g* x *src_w_g*."""
    return _esw_plain(
        src, iystar_c, ix_c, iy_c, step, n_samples, interp_method, fill_value,
        0, out_h, out_w, src_h_g, src_w_g, j_off, i_off, src.shape[-2], 0,
    )


def esw_gather_band_plain(ext, iystar_c, ix_c, iy_c, step, n_samples, out_h,
                          out_w, interp_method, fill_value, row0, off, src_h):
    """Plain PyTorch version of K13's band form: the band's (B, out_h,
    out_w) from global target row *row0*, ``ext`` (B, ext_h, W) holding
    global source rows from *off* of a source *src_h* rows high."""
    return _esw_plain(
        ext, iystar_c, ix_c, iy_c, step, n_samples, interp_method, fill_value,
        row0, out_h, out_w, src_h, ext.shape[-1], 0, 0, src_h, off,
    )


def esw_gather(src, iystar_c, ix_c, iy_c, step, n_samples, out_h, out_w,
               src_h_g, src_w_g, j_off, i_off, interp_method, fill_value,
               staged=True):
    """K13: the exact separable warp, (B, out_h, out_w) from the (B, H, W)
    source window (:func:`esw_gather_plain`), each tile's anchors staged
    where its span fits the stage (*staged* False: computed per pixel in
    every tile; the same bits)."""
    if on_cpu(src, iystar_c, ix_c, iy_c):
        return esw_gather_plain(
            src, iystar_c, ix_c, iy_c, step, n_samples, out_h, out_w, src_h_g,
            src_w_g, j_off, i_off, interp_method, fill_value,
        )
    return _launch_esw(
        src, iystar_c, ix_c, iy_c, step, n_samples, out_h, out_w,
        interp_method, fill_value, (src_h_g, src_w_g, j_off, i_off, int(staged)), None,
    )


def esw_gather_band(ext, iystar_c, ix_c, iy_c, step, n_samples, out_h, out_w,
                    interp_method, fill_value, row0, off, src_h, staged=True):
    """K13's band form: one mesh band's (B, out_h, out_w) from global
    target row *row0*; ``ext`` holds global source rows from *off*
    (:func:`esw_gather_band_plain`).  Its tiles stage their anchors as
    K13's do, in tiles of :func:`band_tile_rows` rows, from
    ``BAND_STAGE_ROWS`` rows up (*staged* False: computed per pixel in
    every tile; the same bits)."""
    if on_cpu(ext, iystar_c, ix_c, iy_c):
        return esw_gather_band_plain(
            ext, iystar_c, ix_c, iy_c, step, n_samples, out_h, out_w,
            interp_method, fill_value, row0, off, src_h,
        )
    if row0 < 0 or src_h < 1:
        raise ValueError(f"K13 band: first row {row0}, source height {src_h}")
    return _launch_esw(
        ext, iystar_c, ix_c, iy_c, step, n_samples, out_h, out_w,
        interp_method, fill_value, None, (row0, off, src_h, int(staged)),
    )


def _launch_esw(src, iystar_c, ix_c, iy_c, step, n_samples, out_h, out_w,
                interp_method, fill_value, window, band):
    """K13 on CUDA tensors: *window* ``(src_h_g, src_w_g, j_off, i_off,
    staged)`` for the single-card form, or *band* ``(row0, off, src_h,
    staged)`` for the band form."""
    method = method_code(interp_method)
    batch, src_h, src_w = src.shape
    ncj, nci = ix_c.shape
    ncc = iystar_c.shape[1]
    if ncj < 2 or nci < 2 or ncc < 2 or iystar_c.shape[0] != ncj or step < 1:
        raise ValueError(
            f"K13 needs coarse fields of 2x2 samples or more on one row grid and "
            f"step >= 1: {tuple(iystar_c.shape)}, {tuple(ix_c.shape)}, {step}"
        )
    if not 3 <= n_samples <= 64:
        raise ValueError(f"K13 keeps 3 to 64 rows a column, got {n_samples}")
    require_int32_planes(src_h, src_w, out_h, out_w)
    require_cuda(src, "src", _F32, (batch, src_h, src_w))
    require_cuda(iystar_c, "iystar_c", _F32, (ncj, ncc))
    require_cuda(ix_c, "ix_c", _F32, (ncj, nci))
    require_cuda(iy_c, "iy_c", _F32, (ncj, nci))
    out = torch.empty((batch, out_h, out_w), dtype=_F32, device=src.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    args = (
        src.data_ptr(), iystar_c.data_ptr(), ix_c.data_ptr(), iy_c.data_ptr(),
        out.data_ptr(), batch, src_h, src_w, ncj, ncc, nci, out_h, out_w, step,
        n_samples, method, float(fill_value),
    )
    name = "esw_gather" if band is None else "esw_gather_band"
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        if band is None:
            rc = lib.xrt_esw_gather_f32(*args, *window, stream)
        else:
            rc = lib.xrt_esw_gather_band_f32(*args, *band, stream)
    _build.check(lib, rc, name)
    count_launch(name)
    return out


# ---------------------------------------------------------------------------
# the tier
# ---------------------------------------------------------------------------


class ESWReprojectFn:
    """``fn(src) -> target`` through K13; ``fn.plain(src)`` through its
    plain version.  ``src`` is (..., H, W) of a data dtype, cast to float32
    as the JAX package's ESW casts it (``esw.py:666``): the plan's source
    window, or, where ``window`` (j0, j1, i0, i1) is set, the whole
    source, cropped to it first."""

    def __init__(self, plan: ESWPlan, interp_method: str, fill_value, device):
        method_code(interp_method)

        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

        self.iystar_c, self.ix_c, self.iy_c = f32(plan.iystar_c), f32(plan.ix_c), f32(plan.iy_c)
        self.step, self.n_samples = int(plan.step), int(plan.n_samples)
        self.src_h, self.src_w = int(plan.src_h), int(plan.src_w)
        self.out_h, self.out_w = int(plan.out_h), int(plan.out_w)
        self.src_h_g, self.src_w_g = int(plan.src_h_g), int(plan.src_w_g)
        self.j_off, self.i_off = int(plan.j_off), int(plan.i_off)
        self.interp_method, self.fill_value = interp_method, float(fill_value)
        self.window = None

    def crop(self, src):
        """The (B, src_h, src_w) contiguous float32 window the kernel reads."""
        if self.window is not None:
            j0, j1, i0, i1 = self.window
            src = src[..., j0:j1, i0:i1]
        if tuple(src.shape[-2:]) != (self.src_h, self.src_w):
            raise ValueError(
                f"source window {tuple(src.shape[-2:])} is not the planned "
                f"{(self.src_h, self.src_w)}"
            )
        return as_float32(src.reshape(-1, self.src_h, self.src_w)).contiguous()

    def args(self, src):
        """K13's arguments for the cropped (B, src_h, src_w) *src*."""
        return (
            src, self.iystar_c, self.ix_c, self.iy_c, self.step, self.n_samples,
            self.out_h, self.out_w, self.src_h_g, self.src_w_g, self.j_off,
            self.i_off, self.interp_method, self.fill_value,
        )

    def _run(self, kernel, src):
        out = kernel(*self.args(self.crop(src)))
        return out.reshape(src.shape[:-2] + out.shape[-2:])

    def __call__(self, src):
        return self._run(esw_gather, src)

    def plain(self, src):
        return self._run(esw_gather_plain, src)


def make_esw_fn(
    plan: ESWPlan, interp_method: str = "bilinear", fill_value=np.nan,
    device="cuda",
) -> ESWReprojectFn:
    """The exact separable warp of *plan* with its coarse fields on
    *device* (``esw.py:879-1045`` without the mosaic's options)."""
    if interp_method not in METHODS:
        raise ValueError(
            "ESW supports 'bilinear', 'nearest' and 'triangular' only"
        )
    return ESWReprojectFn(plan, interp_method, fill_value, device)


def make_esw_reproject_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    step: int = 16,
    device="cuda",
    **plan_kwargs,
) -> ESWReprojectFn | None:
    """Plan the exact separable warp with source-window cropping, or None
    where the mapping is unsuitable (``esw.py:1048-1092``).  The plan keeps
    the global coordinate fields, so cropping does not change a single
    output bit."""
    if interp_method not in METHODS:
        return None
    fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    win = None
    f_plan = fields
    w = _source_window_gm(source_gm, fields, margin=8 + 48)
    if w is not None:
        _, win = w
        f_plan = _offset_fields(fields, *win)
    plan = plan_esw(
        source_gm,
        target_gm,
        step=step,
        fields=f_plan,
        fields_global=fields,
        win=win,
        **plan_kwargs,
    )
    if plan is None:
        return None
    fn = make_esw_fn(plan, interp_method, fill_value, device)
    fn.window = win
    return fn
