"""The separable-residual warp (SRW) tier on PyTorch tensors.

Port of ``xcube_resampling_tpu/ops/srw.py``: ``make_srw_fn`` (:570-753),
``make_srw_aligned_fn`` (:1049-1163), ``make_srw_hybrid_fn`` (:1343-1542),
``make_srw_reproject_fn`` (:1550-1685) and ``make_region_reproject_fn``
(:1730-1865).  The numpy planners are copies of the JAX package's
(``_Fields`` to ``_fields_interp_err``, :48-204; ``_fill_lattice_rows`` and
``fields_from_lattice``, :338-448; ``SRWPlan`` to ``plan_srw``, :450-567;
``SRWAlignedPlan`` and ``plan_srw_aligned``, :953-1046; ``SRWHybridPlan``
and ``plan_srw_hybrid``, :1165-1340; ``_source_window_gm``, :1693).

:func:`make_srw_reproject_fn` crops, gates and plans as the JAX package's
does and picks its variant by the same cost model and tie-break: the tiled
plan at ``d_v + d_h``, the aligned plan (bilinear and nearest, at most 24
taps a pass) at ``bits_v + bits_h + d_v + d_h``, and, where the hybrid is
allowed (``allow_hybrid``, which the reproject engine sets under
``XRTPU_FAST_EXTREME_WARP=1``; never for triangular; the two-pass
fidelity gate is then skipped), the hybrid plan at
``bits_v + bits_h + d_v + d_h + 4``, the first on a tie; a tiled pick
becomes the batched one where its per-tile loops would emit more than 128
tap operations on fewer than 64 M source and target elements.  Every
returned fn names its variant in ``kind``:

* ``"tiled"`` and ``"batched"``: :class:`SRWFn`, one launch of K1
  (vertical pass, all column tiles) and one of K2 (horizontal pass,
  per-pixel geometry, triangular correction, fill select).
  ``make_srw_fn_batched`` computes ``make_srw_fn``'s function bit for bit
  (its tap loops run over a tile axis only to keep XLA's compile small),
  so K1 and K2 serve both; :func:`plan_to_device` carries the plan onto
  the device with their staged windows.
* ``"aligned"``: :class:`AlignedSRWFn`, one launch of K14 and one of K15
  (``ops/srw_aligned.py``), the aligned SRW's passes with their shifts
  folded into the tap index (:func:`aligned_plan_to_device`).
* ``"hybrid"``: :class:`HybridSRWFn`, one launch of K17 and one of K18
  (``ops/srw_hybrid.py``): K14's and K15's kernels with a base a tile
  (:func:`hybrid_plan_to_device`).

Each kernel interpolates the coarse fields itself, so no per-pixel tensor
is kept per geometry.  :func:`make_region_reproject_fn` gives the exact
region mosaic (``ops/esw_mosaic.py``) with ``exact=True`` and otherwise the
two-pass mosaic, :class:`RegionSRWFn`: the SRW on each quadtree piece of
the target, planned on its own source window, K3 where a piece refuses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import as_float32
from ..crs import Transformer
from ..gridmapping import GridMapping
from .reproject_ops import (
    METHODS,
    STEP,
    FusedReprojectFn,
    make_fused_reproject_fn,
    method_code,
)
from .srw_aligned import (
    ALIGNED_METHODS,
    MAX_TAPS,
    VerticalPlan,
    plan_vertical,
    srw_aligned_horizontal,
    srw_aligned_horizontal_plain,
    srw_aligned_vertical,
    srw_aligned_vertical_plain,
)
from .srw_hybrid import (
    srw_hybrid_horizontal,
    srw_hybrid_horizontal_plain,
    srw_hybrid_vertical,
    srw_hybrid_vertical_plain,
)
from .srw_kernels import (
    Windows,
    plan_horizontal_windows,
    plan_vertical_windows,
    srw_horizontal,
    srw_horizontal_plain,
    srw_vertical,
    srw_vertical_plain,
)


# ---------------------------------------------------------------------------
# host-side geometry (copies of the JAX package's numpy planners)
# ---------------------------------------------------------------------------


@dataclass
class _Fields:
    """Float64 coarse coordinate fields shared by both planners."""

    ix64: np.ndarray  # (ncj, nci): source col per (out row, out col)
    iy64: np.ndarray  # (ncj, nci): source row per (out row, out col)
    iystar64: np.ndarray  # (ncj, ncc): source row per (out row, src col)
    step: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def _raw_coarse_fields(
    source_gm: GridMapping, target_gm: GridMapping, step: int
) -> tuple[np.ndarray, np.ndarray]:
    """Float64 coarse ix/iy fields of the inverse transform, unvalidated
    (may contain non-finite values near projection singularities).  Bit-for-
    bit the same evaluation as reproject_ops.coarse_coord_field — float32
    casts of these ARE the gather kernel's coordinate fields, which is what
    makes the exact-warp kernels (ops/esw.py) reproduce it exactly."""
    transformer = Transformer.from_crs(target_gm.crs, source_gm.crs)

    out_h, out_w = target_gm.height, target_gm.width

    ncj = (out_h - 1) // step + 2
    nci = (out_w - 1) // step + 2

    tgt_x = np.asarray(target_gm.x_coords.data, dtype=np.float64)
    tgt_y = np.asarray(target_gm.y_coords.data, dtype=np.float64)
    tgt_x0, tgt_dx = float(tgt_x[0]), float(tgt_x[1] - tgt_x[0])
    tgt_y0, tgt_dy = float(tgt_y[0]), float(tgt_y[1] - tgt_y[0])
    xs = tgt_x0 + tgt_dx * (np.arange(nci, dtype=np.float64) * step)
    ys = tgt_y0 + tgt_dy * (np.arange(ncj, dtype=np.float64) * step)
    xx, yy = np.meshgrid(xs, ys)
    sx, sy = transformer.transform(xx, yy)

    src_x0 = float(np.asarray(source_gm.x_coords.data)[0])
    y_vals = np.asarray(source_gm.y_coords.data)
    src_y0 = float(y_vals[0])
    src_yres_signed = float(y_vals[1] - y_vals[0])
    ix64 = (np.asarray(sx) - src_x0) / float(source_gm.x_res)
    iy64 = (np.asarray(sy) - src_y0) / src_yres_signed
    return ix64, iy64


def _coarse_geometry(
    source_gm: GridMapping, target_gm: GridMapping, step: int
) -> _Fields | None:
    out_h, out_w = target_gm.height, target_gm.width
    src_h, src_w = source_gm.height, source_gm.width

    ix64, iy64 = _raw_coarse_fields(source_gm, target_gm, step)

    if not np.isfinite(ix64).all() or not np.isfinite(iy64).all():
        return None

    iystar = _iystar_from_fields(ix64, iy64, src_w, step)
    if iystar is None:
        return None

    return _Fields(ix64, iy64, iystar, step, src_h, src_w, out_h, out_w)


def _iystar_from_fields(
    ix64: np.ndarray, iy64: np.ndarray, src_w: int, step: int
) -> np.ndarray | None:
    """Reparametrized row field iy*(out row, source col) from the coarse
    coordinate fields, or None when rows are not monotone in ix (no valid
    reparametrization exists there)."""
    # monotone ix along output rows is required for the reparametrization
    dx_row = np.diff(ix64, axis=1)
    if np.all(dx_row > 0):
        ascending = True
    elif np.all(dx_row < 0):
        ascending = False
    else:
        return None

    ncj = ix64.shape[0]
    ncc = (src_w - 1) // step + 2
    cs = np.arange(ncc, dtype=np.float64) * step
    iystar = np.empty((ncj, ncc), dtype=np.float64)
    for r in range(ncj):
        xp_row = ix64[r] if ascending else ix64[r, ::-1]
        fp_row = iy64[r] if ascending else iy64[r, ::-1]
        vals = np.interp(cs, xp_row, fp_row)
        # np.interp clamps flat outside the row's ix range; extrapolate
        # linearly so edge taps see consistent positions
        left = cs < xp_row[0]
        if left.any():
            slope = (fp_row[1] - fp_row[0]) / (xp_row[1] - xp_row[0])
            vals[left] = fp_row[0] + (cs[left] - xp_row[0]) * slope
        right = cs > xp_row[-1]
        if right.any():
            slope = (fp_row[-1] - fp_row[-2]) / (xp_row[-1] - xp_row[-2])
            vals[right] = fp_row[-1] + (cs[right] - xp_row[-1]) * slope
        iystar[r] = vals

    return iystar


def _interp_rows(field: np.ndarray, n_rows: int, step: int) -> np.ndarray:
    """Linearly interpolate a coarse field to every output row (matching
    the device's row interpolation)."""
    rows_full = np.arange(n_rows, dtype=np.float64) / step
    jr0 = np.clip(rows_full.astype(np.int64), 0, field.shape[0] - 2)
    frr = rows_full - jr0
    return field[jr0, :] * (1 - frr[:, None]) + field[jr0 + 1, :] * frr[:, None]


def _interp_cols(field: np.ndarray, n_cols: int, step: int) -> np.ndarray:
    cols_full = np.arange(n_cols, dtype=np.float64) / step
    ic0 = np.clip(cols_full.astype(np.int64), 0, field.shape[1] - 2)
    fcc = cols_full - ic0
    return field[:, ic0] * (1 - fcc[None, :]) + field[:, ic0 + 1] * fcc[None, :]


def _twopass_slope(fields: _Fields) -> float:
    """Worst per-pixel variation of the separable warp's fields: the
    two-pass filter deviates from direct bilinear by about a quarter of
    this value on worst-case data.  iy* is measured only on the columns
    the horizontal taps can reach."""
    ix64, iystar, step = fields.ix64, fields.iystar64, fields.step
    k0 = max(0, int(np.floor(np.nanmin(ix64) / step)) - 1)
    k1 = min(iystar.shape[1], int(np.ceil(np.nanmax(ix64) / step)) + 2)
    used = iystar[:, k0:k1] if k1 - k0 >= 2 else iystar
    s_v = float(np.nanmax(np.abs(np.diff(used, axis=1)))) / step
    s_h = float(np.nanmax(np.abs(np.diff(ix64, axis=0)))) / step
    return max(s_v, s_h)


def _fields_interp_err(fields: _Fields) -> float:
    """Estimated worst-case position error (pixels) of linearly
    interpolating the coarse fields: |second difference| / 8.  iy* is
    evaluated only on the columns reachable by the horizontal taps; its
    extrapolated tail (outside every row's ix range) never reaches an
    output pixel."""

    def second_diff_err(f):
        e = 0.0
        if f.shape[1] >= 3:
            e = max(e, float(np.nanmax(np.abs(np.diff(f, 2, axis=1)))) / 8)
        if f.shape[0] >= 3:
            e = max(e, float(np.nanmax(np.abs(np.diff(f, 2, axis=0)))) / 8)
        return e

    ix64, iystar, step = fields.ix64, fields.iystar64, fields.step
    k0 = max(0, int(np.floor(np.nanmin(ix64) / step)) - 1)
    k1 = min(iystar.shape[1], int(np.ceil(np.nanmax(ix64) / step)) + 2)
    used = iystar[:, k0:k1] if k1 - k0 >= 3 else iystar
    return max(
        second_diff_err(used),
        second_diff_err(ix64),
        second_diff_err(fields.iy64),
    )


def fields_from_ij_map(
    ij_map: np.ndarray,
    src_h: int,
    src_w: int,
    step: int = 16,
    pos_tol: float = 0.05,
    gate_mask: np.ndarray | None = None,
) -> _Fields | None:
    """Build SRW coarse fields from a full-resolution fractional (i, j)
    map (rectify Phase A's output), or None where the coarse fields miss
    the map by more than *pos_tol* source pixels over *gate_mask* (default:
    the map's finite pixels).  NaN entries are filled per row by linear
    interpolation/extrapolation from the valid samples.  Copy of
    ``xcube_resampling_tpu/ops/srw.py:fields_from_ij_map``."""
    ix_full = np.asarray(ij_map[0], dtype=np.float64)
    iy_full = np.asarray(ij_map[1], dtype=np.float64)
    out_h, out_w = ix_full.shape
    if out_h < 2 * step or out_w < 2 * step:
        return None

    def _fill_rows(f):
        filled = f.copy()
        cols = np.arange(out_w, dtype=np.float64)
        last_good = None
        for r in range(out_h):
            row = filled[r]
            good = np.isfinite(row)
            n_good = int(good.sum())
            if n_good == out_w:
                last_good = filled[r]
                continue
            if n_good >= 2:
                xg = cols[good]
                yg = row[good]
                vals = np.interp(cols, xg, yg)
                lo = cols < xg[0]
                if lo.any():
                    s = (yg[1] - yg[0]) / (xg[1] - xg[0])
                    vals[lo] = yg[0] + (cols[lo] - xg[0]) * s
                hi = cols > xg[-1]
                if hi.any():
                    s = (yg[-1] - yg[-2]) / (xg[-1] - xg[-2])
                    vals[hi] = yg[-1] + (cols[hi] - xg[-1]) * s
                filled[r] = vals
                last_good = vals
            elif last_good is not None:
                filled[r] = last_good
            # else: leading sparse/all-NaN rows — back-filled below
        if not np.isfinite(filled).all():
            finite_rows = np.where(np.isfinite(filled).all(axis=1))[0]
            if finite_rows.size == 0:
                return None
            filled[: finite_rows[0]] = filled[finite_rows[0]]
        return filled

    ix_f = _fill_rows(ix_full)
    iy_f = _fill_rows(iy_full)
    if ix_f is None or iy_f is None:
        return None

    # coarse subsample, the last sample clamped to the final pixel
    ncj = (out_h - 1) // step + 2
    nci = (out_w - 1) // step + 2
    rsel = np.minimum(np.arange(ncj) * step, out_h - 1)
    csel = np.minimum(np.arange(nci) * step, out_w - 1)
    ix64 = ix_f[np.ix_(rsel, csel)]
    iy64 = iy_f[np.ix_(rsel, csel)]

    # measured accuracy gate against the true per-pixel field
    valid = gate_mask if gate_mask is not None else np.isfinite(ix_full)
    if valid.any():
        ix_approx = _interp_rows(_interp_cols(ix64, out_w, step), out_h, step)
        iy_approx = _interp_rows(_interp_cols(iy64, out_w, step), out_h, step)
        err = max(
            float(np.max(np.abs(ix_approx[valid] - ix_full[valid]))),
            float(np.max(np.abs(iy_approx[valid] - iy_full[valid]))),
        )
        if err > pos_tol:
            return None

    return _finish_fields(ix64, iy64, step, src_h, src_w, out_h, out_w)


def _finish_fields(
    ix64: np.ndarray,
    iy64: np.ndarray,
    step: int,
    src_h: int,
    src_w: int,
    out_h: int,
    out_w: int,
) -> _Fields | None:
    """Require monotone columns and resample iy onto the source-column
    lattice (iy*)."""
    iystar = _iystar_from_fields(ix64, iy64, src_w, step)
    if iystar is None:
        return None
    return _Fields(ix64, iy64, iystar, step, src_h, src_w, out_h, out_w)


def _fill_lattice_rows(f: np.ndarray) -> np.ndarray | None:
    """Row-wise linear fill/extrapolation of NaN lattice entries (the
    lattice-resolution analogue of the full-map fill above)."""
    filled = f.copy()
    n_rows, n_cols = filled.shape
    cols = np.arange(n_cols, dtype=np.float64)
    last_good = None
    for r in range(n_rows):
        row = filled[r]
        good = np.isfinite(row)
        n_good = int(good.sum())
        if n_good == n_cols:
            last_good = row
            continue
        if n_good >= 2:
            xg, yg = cols[good], row[good]
            vals = np.interp(cols, xg, yg)
            lo = cols < xg[0]
            if lo.any():
                s = (yg[1] - yg[0]) / (xg[1] - xg[0])
                vals[lo] = yg[0] + (cols[lo] - xg[0]) * s
            hi = cols > xg[-1]
            if hi.any():
                s = (yg[-1] - yg[-2]) / (xg[-1] - xg[-2])
                vals[hi] = yg[-1] + (cols[hi] - xg[-1]) * s
            filled[r] = vals
            last_good = vals
        elif last_good is not None:
            filled[r] = last_good
    if not np.isfinite(filled).all():
        finite_rows = np.where(np.isfinite(filled).all(axis=1))[0]
        if finite_rows.size == 0:
            return None
        filled[: finite_rows[0]] = filled[finite_rows[0]]
    return filled


def fields_from_lattice(
    ix_lat: np.ndarray,
    iy_lat: np.ndarray,
    probe_ix: np.ndarray,
    probe_iy: np.ndarray,
    probe_valid: np.ndarray,
    probe_rc: tuple[np.ndarray, np.ndarray],
    step: int,
    src_h: int,
    src_w: int,
    out_h: int,
    out_w: int,
    pos_tol: float = 0.05,
) -> _Fields | None:
    """SRW coarse fields from step-lattice samples of a fractional (i, j)
    map — the device-resident analogue of :func:`fields_from_ij_map` for
    callers that cannot afford fetching the full map to the host (rectify
    Phase B over a :class:`~.rectify_ops.DeviceIJMap`).

    The accuracy gate cannot measure against every pixel; instead it
    checks the half-offset probe lattice (*probe_rc* positions, true map
    values in *probe_ix*/*probe_iy*), where the piecewise-linear
    reconstruction error of a smooth field peaks.  Probes outside the
    coverage (*probe_valid* False) are ignored, like NaN pixels in the
    full-map gate."""
    ix_lat = np.asarray(ix_lat, dtype=np.float64)
    iy_lat = np.asarray(iy_lat, dtype=np.float64)
    lat_valid = np.isfinite(ix_lat) & np.isfinite(iy_lat)
    ix64 = _fill_lattice_rows(ix_lat.copy())
    iy64 = _fill_lattice_rows(iy_lat.copy())
    if ix64 is None or iy64 is None:
        return None

    prow, pcol = probe_rc
    ncj, nci = ix64.shape
    rf = np.asarray(prow, dtype=np.float64) / step
    cf = np.asarray(pcol, dtype=np.float64) / step
    r0 = np.clip(rf.astype(np.int64), 0, ncj - 2)
    c0 = np.clip(cf.astype(np.int64), 0, nci - 2)
    fr = (rf - r0)[:, None]
    fc = (cf - c0)[None, :]
    # gate only where the reconstruction rests on measured (not filled)
    # lattice samples: SRW output is consumed on the interior eroded by
    # step+2 pixels, whose entire lattice support is valid by
    # construction — boundary probes reconstruct from extrapolated
    # samples and are resolved by the caller's exact edge gather instead
    supported = (
        lat_valid[r0[:, None], c0[None, :]]
        & lat_valid[r0[:, None], c0[None, :] + 1]
        & lat_valid[r0[:, None] + 1, c0[None, :]]
        & lat_valid[r0[:, None] + 1, c0[None, :] + 1]
    )
    gate = np.asarray(probe_valid, dtype=bool) & supported
    if gate.any():
        err = 0.0
        for field, true_vals in ((ix64, probe_ix), (iy64, probe_iy)):
            approx = (
                field[r0[:, None], c0[None, :]] * (1 - fr) * (1 - fc)
                + field[r0[:, None], c0[None, :] + 1] * (1 - fr) * fc
                + field[r0[:, None] + 1, c0[None, :]] * fr * (1 - fc)
                + field[r0[:, None] + 1, c0[None, :] + 1] * fr * fc
            )
            diff = np.abs(approx - np.asarray(true_vals, dtype=np.float64))
            err = max(err, float(np.max(diff[gate])))
        if err > pos_tol:
            return None

    return _finish_fields(ix64, iy64, step, src_h, src_w, out_h, out_w)


# ---------------------------------------------------------------------------
# tiled plan (mild warp)
# ---------------------------------------------------------------------------


@dataclass
class SRWPlan:
    """Tiled-strategy plan: coarse fields, per-tile bases, tap counts."""

    iystar_c: np.ndarray
    step_vr: int
    step_vc: int
    base_v: np.ndarray  # (out_h, n_col_tiles) int32
    d_v: int
    col_tile: int
    ix_c: np.ndarray
    iy_c: np.ndarray
    step: int
    base_h: np.ndarray  # (n_row_tiles, out_w) int32
    d_h: int
    row_tile: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def _pick_tile(slope: float, tap_budget: int) -> int:
    """Largest power-of-two tile in [64, 1024] whose in-tile span stays
    around *tap_budget* positions."""
    if not np.isfinite(slope) or slope <= 0:
        return 1024
    tile = tap_budget / slope
    for cand in (1024, 512, 256, 128, 64):
        if tile >= cand:
            return cand
    return 64


def plan_srw(
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
    col_tile: int | None = None,
    row_tile: int | None = None,
    max_taps: int = 48,
    tap_budget: int = 12,
    fields: _Fields | None = None,
) -> SRWPlan | None:
    """Build the tiled plan, or None when the mapping is unsuitable."""
    if fields is None:
        fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    ix64, iy64, iystar = fields.ix64, fields.iy64, fields.iystar64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    step = fields.step
    ncj = ix64.shape[0]

    if col_tile is None:
        slope_v = float(np.nanmax(np.abs(np.diff(iystar, axis=1))) / step)
        col_tile = _pick_tile(slope_v, tap_budget)
    if row_tile is None:
        slope_h = float(np.nanmax(np.abs(np.diff(ix64, axis=0))) / step)
        row_tile = _pick_tile(slope_h, tap_budget)

    # vertical: per-(out row, col tile) base
    ncc = iystar.shape[1]
    n_col_tiles = -(-src_w // col_tile)
    iystar_rows = _interp_rows(iystar, out_h, step)
    base_v = np.zeros((out_h, n_col_tiles), dtype=np.int32)
    span_max = 0.0
    for t in range(n_col_tiles):
        c0 = t * col_tile
        c1 = min((t + 1) * col_tile, src_w)
        k0 = max(0, c0 // step - 1)
        k1 = min(ncc, -(-c1 // step) + 1)
        seg = iystar_rows[:, k0:k1]
        m = seg.min(axis=1)
        base_v[:, t] = np.floor(m).astype(np.int32) - 1
        span_max = max(span_max, float((seg.max(axis=1) - m).max()))
    d_v = int(np.ceil(span_max)) + 4
    if d_v > max_taps:
        return None

    # horizontal: per-(row tile, out col) base
    n_row_tiles = -(-out_h // row_tile)
    ix_cols = _interp_cols(ix64, out_w, step)
    base_h = np.zeros((n_row_tiles, out_w), dtype=np.int32)
    span_max_h = 0.0
    sample_rows = np.arange(ncj) * step
    for t in range(n_row_tiles):
        r0 = t * row_tile
        r1 = min((t + 1) * row_tile, out_h)
        k0 = max(0, int(np.searchsorted(sample_rows, r0)) - 1)
        k1 = min(ncj, int(np.searchsorted(sample_rows, r1)) + 2)
        seg = ix_cols[k0:k1, :]
        m = seg.min(axis=0)
        base_h[t, :] = np.floor(m).astype(np.int32) - 1
        span_max_h = max(span_max_h, float((seg.max(axis=0) - m).max()))
    d_h = int(np.ceil(span_max_h)) + 4
    if d_h > max_taps:
        return None

    return SRWPlan(
        iystar_c=iystar.astype(np.float32),
        step_vr=step,
        step_vc=step,
        base_v=base_v,
        d_v=d_v,
        col_tile=col_tile,
        ix_c=ix64.astype(np.float32),
        iy_c=iy64.astype(np.float32),
        step=step,
        base_h=base_h,
        d_h=d_h,
        row_tile=row_tile,
        src_h=src_h,
        src_w=src_w,
        out_h=out_h,
        out_w=out_w,
    )


# ---------------------------------------------------------------------------
# aligned plan (severe warp)
# ---------------------------------------------------------------------------


@dataclass
class SRWAlignedPlan:
    """Aligned-strategy plan: integer shift vectors + per-row/col bases."""

    iystar_c: np.ndarray
    ix_c: np.ndarray
    iy_c: np.ndarray
    step: int
    s_v: np.ndarray  # (src_w,) int32 per-source-column upward shift, >= 0
    bits_v: int
    base_v: np.ndarray  # (out_h,) int32 in shifted row space
    d_v: int
    s_h: np.ndarray  # (out_h,) int32 per-output-row left shift, >= 0
    bits_h: int
    base_h: np.ndarray  # (out_w,) int32 in shifted column space
    d_h: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def plan_srw_aligned(
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
    max_taps: int = 16,
    fields: _Fields | None = None,
) -> SRWAlignedPlan | None:
    if fields is None:
        fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    ix64, iy64, iystar = fields.ix64, fields.iy64, fields.iystar64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    step = fields.step

    # vertical alignment: shift each source column by the mid-row value of
    # iy*; the residual then varies along columns only through curvature
    mid = iystar.shape[0] // 2
    cs = np.arange(iystar.shape[1], dtype=np.float64) * step
    s_v_f = np.interp(np.arange(src_w, dtype=np.float64), cs, iystar[mid])
    s_v0 = np.round(s_v_f).astype(np.int64)
    s_v = s_v0 - s_v0.min()
    bits_v = max(1, int(s_v.max()).bit_length())

    # residual position field in shifted space, per output row
    s_v0_coarse = s_v0[np.clip(cs.astype(np.int64), 0, src_w - 1)]
    res_v = iystar - s_v0_coarse[None, :] + s_v0.min()  # == iystar - s_v(c)
    res_rows = _interp_rows(res_v, out_h, step)
    m = np.nanmin(res_rows, axis=1)
    base_v = np.floor(m).astype(np.int32) - 1
    d_v = int(np.ceil(np.nanmax(np.nanmax(res_rows, axis=1) - m))) + 4
    if d_v > max_taps:
        return None

    # horizontal alignment: shift each output row by the mid-column ix
    midc = ix64.shape[1] // 2
    rows_grid = np.arange(ix64.shape[0], dtype=np.float64) * step
    s_h_f = np.interp(np.arange(out_h, dtype=np.float64), rows_grid, ix64[:, midc])
    s_h0 = np.round(s_h_f).astype(np.int64)
    s_h = s_h0 - s_h0.min()
    bits_h = max(1, int(s_h.max()).bit_length())

    s_h0_coarse = s_h0[
        np.clip((rows_grid).astype(np.int64), 0, out_h - 1)
    ]
    res_h = ix64 - s_h0_coarse[:, None] + s_h0.min()
    res_cols = _interp_cols(res_h, out_w, step)
    mh = np.nanmin(res_cols, axis=0)
    base_h = np.floor(mh).astype(np.int32) - 1
    d_h = int(np.ceil(np.nanmax(np.nanmax(res_cols, axis=0) - mh))) + 4
    if d_h > max_taps:
        return None

    return SRWAlignedPlan(
        iystar_c=iystar.astype(np.float32),
        ix_c=ix64.astype(np.float32),
        iy_c=iy64.astype(np.float32),
        step=step,
        s_v=s_v.astype(np.int32),
        bits_v=bits_v,
        base_v=base_v,
        d_v=d_v,
        s_h=s_h.astype(np.int32),
        bits_h=bits_h,
        base_h=base_h,
        d_h=d_h,
        src_h=src_h,
        src_w=src_w,
        out_h=out_h,
        out_w=out_w,
    )


# ---------------------------------------------------------------------------
# hybrid plan (severe, spatially varying warp)
# ---------------------------------------------------------------------------


@dataclass
class SRWHybridPlan:
    """Hybrid strategy: align shifts (as in the aligned plan) collapse the
    bulk rotation, *tiled* residual bases absorb the row/column dependence
    that sinks the pure aligned plan on domain-scale warps (where the local
    rotation/scale varies by tens of degrees, e.g. full-plane 4326->3035).

    Residual structure: with ``s_v(c)`` the per-column shift, the vertical
    tap base may depend on (output row, column tile), so the only quantity
    that must stay small is the *in-tile column spread at fixed row* of
    ``iy*(j,c) - s_v(c)`` — a mixed-derivative term, orders of magnitude
    smaller than the raw rotation slope that bounds the tiled plan.
    """

    iystar_c: np.ndarray
    ix_c: np.ndarray
    iy_c: np.ndarray
    step: int
    s_v: np.ndarray  # (src_w,) int32 >= 0 upward shift per source column
    bits_v: int
    base_v: np.ndarray  # (out_h, n_col_tiles) int32, residual space
    d_v: int
    col_tile: int
    s_h: np.ndarray  # (out_h,) int32 >= 0 left shift per output row
    bits_h: int
    base_h: np.ndarray  # (n_row_tiles, out_w) int32, residual space
    d_h: int
    row_tile: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


# The curvature gate's limit on the estimated position interpolation
# error, in source pixels: the default of the JAX package's
# make_srw_reproject_fn (srw.py:1557).
POS_TOL = 0.5


def plan_srw_hybrid(
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
    max_taps: int = 32,
    fields: _Fields | None = None,
) -> SRWHybridPlan | None:
    if fields is None:
        fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    ix64, iy64, iystar = fields.ix64, fields.iy64, fields.iystar64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    step = fields.step

    # curvature gate: the kernel linearly interpolates the coarse iy*/ix
    # fields; near projection singularities their curvature makes that
    # interpolation itself wrong by ~|second difference|/8 pixels.  Reject
    # when the estimated position error exceeds POS_TOL (callers can retry
    # with a finer coarse step — the error scales with step^2).
    if _fields_interp_err(fields) > POS_TOL:
        return None

    # ---- vertical: derivative-midrange shift — s_v'(c) is the midrange
    # over output rows of d iy*/dc, which minimizes the worst-case in-tile
    # residual slope at any row (the base absorbs all row dependence)
    cs = np.arange(iystar.shape[1], dtype=np.float64) * step
    dv = np.diff(iystar, axis=1)
    mid_slope_v = 0.5 * (dv.max(axis=0) + dv.min(axis=0))
    s_v_coarse = np.concatenate([[0.0], np.cumsum(mid_slope_v)])
    s_v_coarse = np.round(s_v_coarse)
    s_v0 = np.round(
        np.interp(np.arange(src_w, dtype=np.float64), cs, s_v_coarse)
    ).astype(np.int64)
    s_v = s_v0 - s_v0.min()
    bits_v = max(1, int(s_v.max()).bit_length())

    # residual at the coarse grid, using the exact per-pixel shift values
    s_v0_at_cs = s_v0[np.clip(cs.astype(np.int64), 0, src_w - 1)]
    res_v = iystar - (s_v0_at_cs - s_v0.min())[None, :]
    res_rows = _interp_rows(res_v, out_h, step)  # (out_h, ncc)
    ncc = res_v.shape[1]

    def _v_layout(col_tile):
        n_col_tiles = -(-src_w // col_tile)
        base = np.zeros((out_h, n_col_tiles), dtype=np.int32)
        span_max = 0.0
        for t in range(n_col_tiles):
            c0 = t * col_tile
            c1 = min((t + 1) * col_tile, src_w)
            k0 = max(0, c0 // step - 1)
            k1 = min(ncc, -(-c1 // step) + 1)
            seg = res_rows[:, k0:k1]
            m = seg.min(axis=1)
            base[:, t] = np.floor(m).astype(np.int32) - 1
            span_max = max(span_max, float((seg.max(axis=1) - m).max()))
        return base, int(np.ceil(span_max)) + 4

    # the vertical take's lane dimension is col_tile: tiles below 128
    # waste lanes, so weight the tap count by the wasted fraction
    best_v = None
    for cand in (512, 256, 128, 64, 32):
        base, d = _v_layout(cand)
        eff = d * max(1.0, 128.0 / cand)
        if d <= max_taps and (best_v is None or eff < best_v[0]):
            best_v = (eff, cand, base, d)
    if best_v is None:
        return None
    _, col_tile, base_v, d_v = best_v

    # ---- horizontal: derivative-midrange shift over rows; residual
    # i-dependence is absorbed by the per-column base within each row tile
    rows_grid = np.arange(ix64.shape[0], dtype=np.float64) * step
    dh = np.diff(ix64, axis=0)
    mid_slope_h = 0.5 * (dh.max(axis=1) + dh.min(axis=1))
    s_h_coarse = np.concatenate([[0.0], np.cumsum(mid_slope_h)])
    s_h_coarse = np.round(s_h_coarse)
    s_h0 = np.round(
        np.interp(np.arange(out_h, dtype=np.float64), rows_grid, s_h_coarse)
    ).astype(np.int64)
    s_h = s_h0 - s_h0.min()
    bits_h = max(1, int(s_h.max()).bit_length())

    s_h0_at_rows = s_h0[
        np.clip(rows_grid.astype(np.int64), 0, out_h - 1)
    ]
    res_h = ix64 - (s_h0_at_rows - s_h0.min())[:, None]
    res_cols = _interp_cols(res_h, out_w, step)  # (ncj, out_w)
    ncj = ix64.shape[0]
    sample_rows = np.arange(ncj) * step

    def _h_layout(row_tile):
        n_row_tiles = -(-out_h // row_tile)
        base = np.zeros((n_row_tiles, out_w), dtype=np.int32)
        span_max_h = 0.0
        for t in range(n_row_tiles):
            r0 = t * row_tile
            r1 = min((t + 1) * row_tile, out_h)
            k0 = max(0, int(np.searchsorted(sample_rows, r0)) - 1)
            k1 = min(ncj, int(np.searchsorted(sample_rows, r1)) + 2)
            seg = res_cols[k0:k1, :]
            m = seg.min(axis=0)
            base[t, :] = np.floor(m).astype(np.int32) - 1
            span_max_h = max(span_max_h, float((seg.max(axis=0) - m).max()))
        return base, int(np.ceil(span_max_h)) + 4

    # after the kernel's per-tile transpose, row_tile is the lane
    # dimension of the horizontal take: weight the tap count by wasted
    # lanes below 128
    best_h = None
    for cand in (512, 256, 128, 64, 32, 16):
        base, d = _h_layout(cand)
        eff = d * max(1.0, 128.0 / cand)
        if d <= max_taps and (best_h is None or eff < best_h[0]):
            best_h = (eff, d, cand, base)
    if best_h is None:
        return None
    _, d_h, row_tile, base_h = best_h

    return SRWHybridPlan(
        iystar_c=iystar.astype(np.float32),
        ix_c=ix64.astype(np.float32),
        iy_c=iy64.astype(np.float32),
        step=step,
        s_v=s_v.astype(np.int32),
        bits_v=bits_v,
        base_v=base_v,
        d_v=d_v,
        col_tile=col_tile,
        s_h=s_h.astype(np.int32),
        bits_h=bits_h,
        base_h=base_h,
        d_h=d_h,
        row_tile=row_tile,
        src_h=src_h,
        src_w=src_w,
        out_h=out_h,
        out_w=out_w,
    )


def _source_window_gm(source_gm: GridMapping, fields: _Fields, margin: int):
    """Crop the source to the rows/columns a region actually taps,
    returning (window_gm, (j0, j1, i0, i1)) or None for full coverage.

    Offsets are aligned down to the coarse-field step so the window's
    iy*-reparametrization samples the same source-column phase as the
    uncropped grid — the cropped kernels then see identical (shifted)
    coordinate fields, not a different piecewise-linear approximation."""
    ix, iy = fields.ix64, fields.iy64
    finite = np.isfinite(ix) & np.isfinite(iy)
    if not finite.any():
        return None
    step = fields.step
    i0 = max(0, int(np.floor(ix[finite].min())) - margin) // step * step
    i1 = min(fields.src_w, int(np.ceil(ix[finite].max())) + margin + 1)
    j0 = max(0, int(np.floor(iy[finite].min())) - margin) // step * step
    j1 = min(fields.src_h, int(np.ceil(iy[finite].max())) + margin + 1)
    if i1 - i0 < 8 or j1 - j0 < 8:
        return None
    if (i1 - i0) * (j1 - j0) > 0.8 * fields.src_w * fields.src_h:
        return None  # not worth cropping
    x_res = float(source_gm.x_res)
    y_res = float(source_gm.y_res)
    if bool(source_gm.is_j_axis_up):
        y_min = float(source_gm.y_min) + j0 * y_res
    else:
        y_min = float(source_gm.y_max) - j1 * y_res
    win_gm = GridMapping.regular(
        size=(i1 - i0, j1 - j0),
        xy_min=(float(source_gm.x_min) + i0 * x_res, y_min),
        xy_res=(x_res, y_res),
        crs=source_gm.crs,
        is_j_axis_up=bool(source_gm.is_j_axis_up),
    )
    return win_gm, (j0, j1, i0, i1)


# ---------------------------------------------------------------------------
# the tier on the device
# ---------------------------------------------------------------------------


@dataclass
class SRWState:
    """A tiled :class:`SRWPlan` on the device: coarse fields (float32),
    per-tile tap bases (int32) and the kernels' staged windows as
    tensors, plus the plan's scalars."""

    iystar_c: torch.Tensor  # (ncj, ncc)
    ix_c: torch.Tensor  # (ncj, nci)
    iy_c: torch.Tensor  # (ncj, nci)
    base_v: torch.Tensor  # (out_h, n_col_tiles)
    base_h: torch.Tensor  # (n_row_tiles, out_w)
    win_v: Windows
    win_h: Windows
    d_v: int
    col_tile: int
    d_h: int
    row_tile: int
    step: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def plan_to_device(plan: SRWPlan, device) -> SRWState:
    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    win_v = plan_vertical_windows(plan.base_v, plan.col_tile, plan.d_v)
    win_h = plan_horizontal_windows(plan.base_h, plan.row_tile, plan.d_h)
    return SRWState(
        iystar_c=f32(plan.iystar_c),
        ix_c=f32(plan.ix_c),
        iy_c=f32(plan.iy_c),
        base_v=i32(plan.base_v),
        base_h=i32(plan.base_h),
        win_v=win_v.to(device),
        win_h=win_h.to(device),
        d_v=int(plan.d_v),
        col_tile=int(plan.col_tile),
        d_h=int(plan.d_h),
        row_tile=int(plan.row_tile),
        step=int(plan.step),
        src_h=int(plan.src_h),
        src_w=int(plan.src_w),
        out_h=int(plan.out_h),
        out_w=int(plan.out_w),
    )


class SRWFn:
    """``fn(src) -> target`` through K1 then K2; ``fn.plain(src)`` through
    their plain versions.  ``src`` is (..., H, W) of a data dtype on the
    state's device; ``window`` (j0, j1, i0, i1), when set, crops it first.
    ``kind`` is the variant of the JAX package's dispatch it stands for:
    ``"tiled"`` (``make_srw_fn``) or ``"batched"`` (``make_srw_fn_batched``,
    the same function but for float64).  The tiled SRW reads the source in
    its dtype and returns jnp's promotion of a float32 weight times it
    (float64 for float64, else float32); the batched one casts the source
    to float32 first (``srw.py:849``), which for the other dtypes is the
    conversion K1 makes in registers, so only float64 is cast."""

    def __init__(self, state: SRWState, interp_method: str, fill_value, kind="tiled"):
        method_code(interp_method)
        self.state = state
        self.interp_method = interp_method
        self.fill_value = float(fill_value)
        self.window = None
        self.kind = kind

    def crop(self, src):
        """The (B, src_h, src_w) contiguous source the kernels read (float32
        for the batched SRW on float64)."""
        src = _crop(src, self.window, self.state)
        return as_float32(src) if self.kind == "batched" and src.dtype == torch.float64 else src

    def vertical_args(self, src):
        """K1's arguments for the cropped (B, src_h, src_w) *src*."""
        st = self.state
        return (
            src, st.iystar_c, st.step, st.base_v, st.col_tile, st.d_v,
            st.win_v, self.interp_method,
        )

    def horizontal_args(self, v):
        """K2's arguments for K1's output *v* (``vd`` is passed apart)."""
        st = self.state
        return (
            v, st.ix_c, st.iy_c, st.step, st.base_h, st.row_tile, st.d_h,
            st.src_h, st.win_h, self.interp_method, self.fill_value,
        )

    def _run(self, src, vertical, horizontal):
        v, vd = vertical(*self.vertical_args(self.crop(src)))
        out = horizontal(*self.horizontal_args(v), vd)
        return out.reshape(src.shape[:-2] + out.shape[-2:])

    def __call__(self, src):
        return self._run(src, srw_vertical, srw_horizontal)

    def plain(self, src):
        return self._run(src, srw_vertical_plain, srw_horizontal_plain)


def _crop(src, window, st):
    """*src* cropped to *window* (None: as it is), checked against the
    planned (st.src_h, st.src_w), as a contiguous (B, src_h, src_w)."""
    if window is not None:
        j0, j1, i0, i1 = window
        src = src[..., j0:j1, i0:i1]
    if tuple(src.shape[-2:]) != (st.src_h, st.src_w):
        raise ValueError(
            f"source window {tuple(src.shape[-2:])} is not the planned "
            f"{(st.src_h, st.src_w)}"
        )
    return src.reshape(-1, st.src_h, st.src_w).contiguous()


def make_srw_fn(
    plan: SRWPlan, interp_method: str = "bilinear", fill_value=np.nan,
    device="cuda",
) -> SRWFn:
    """The tiled SRW reprojection of *plan* with its statics on *device*."""
    return SRWFn(plan_to_device(plan, device), interp_method, fill_value)


@dataclass
class AlignedSRWState:
    """An :class:`SRWAlignedPlan` on the device: coarse fields (float32),
    shifts and tap bases (int32), the plan's scalars, and the vertical
    kernel's launch for these bases (``srw_aligned.plan_vertical``)."""

    iystar_c: torch.Tensor  # (ncj, ncc)
    ix_c: torch.Tensor  # (ncj, nci)
    iy_c: torch.Tensor  # (ncj, nci)
    s_v: torch.Tensor  # (src_w,)
    base_v: torch.Tensor  # (out_h,)
    s_h: torch.Tensor  # (out_h,)
    base_h: torch.Tensor  # (out_w,)
    d_v: int
    d_h: int
    step: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int
    win_v: VerticalPlan


def aligned_plan_to_device(plan: SRWAlignedPlan, device, col_tile=None) -> AlignedSRWState:
    """*plan* on *device*; the vertical launch planned for a base every
    *col_tile* source columns (None: one for every column)."""
    base_v = np.asarray(plan.base_v).reshape(int(plan.out_h), -1)
    win_v = plan_vertical(base_v, int(col_tile or max(1, plan.src_w)), int(plan.d_v),
                          int(plan.src_w))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return AlignedSRWState(
        iystar_c=f32(plan.iystar_c),
        ix_c=f32(plan.ix_c),
        iy_c=f32(plan.iy_c),
        s_v=i32(plan.s_v),
        base_v=i32(plan.base_v),
        s_h=i32(plan.s_h),
        base_h=i32(plan.base_h),
        d_v=int(plan.d_v),
        d_h=int(plan.d_h),
        step=int(plan.step),
        src_h=int(plan.src_h),
        src_w=int(plan.src_w),
        out_h=int(plan.out_h),
        out_w=int(plan.out_w),
        win_v=win_v.to(device),
    )


class AlignedSRWFn:
    """``fn(src) -> target`` through K14 then K15; ``fn.plain(src)``
    through their plain versions.  ``src`` is (..., H, W) of a data dtype
    on the state's device, cast to float32 as the JAX package casts it
    (``srw.py:1087``, ``:1431``); ``window`` (j0, j1, i0, i1), when set,
    crops it first.  ``kind`` is ``"aligned"`` (``make_srw_aligned_fn``)."""

    kind = "aligned"

    def __init__(self, state: AlignedSRWState, interp_method: str, fill_value):
        if interp_method not in ALIGNED_METHODS:
            raise ValueError("SRW supports 'bilinear' and 'nearest' only")
        self.state = state
        self.interp_method = interp_method
        self.fill_value = float(fill_value)
        self.window = None

    def crop(self, src):
        """The (B, src_h, src_w) contiguous float32 source the kernels read."""
        return as_float32(_crop(src, self.window, self.state))

    def vertical_args(self, src):
        """K14's arguments for the cropped (B, src_h, src_w) *src*."""
        st = self.state
        return src, st.iystar_c, st.step, st.s_v, st.base_v, st.d_v, self.interp_method

    def horizontal_args(self, v):
        """K15's arguments for K14's output *v*."""
        st = self.state
        return (
            v, st.ix_c, st.iy_c, st.step, st.s_h, st.base_h, st.d_h, st.src_h,
            self.interp_method, self.fill_value,
        )

    # the kernels' wrappers
    _vertical = staticmethod(srw_aligned_vertical)
    _horizontal = staticmethod(srw_aligned_horizontal)

    def vertical(self, src):
        """The vertical kernel on the cropped *src* as the state plans it:
        ``(v, flags)``, its flags of v for :meth:`horizontal`."""
        return self._vertical(*self.vertical_args(src), win_v=self.state.win_v,
                              with_flags=True)

    def horizontal(self, v, flags):
        """The horizontal kernel on :meth:`vertical`'s output."""
        return self._horizontal(*self.horizontal_args(v), flags=flags)

    def _run(self, src, vertical, horizontal):
        v = vertical(*self.vertical_args(self.crop(src)))
        out = horizontal(*self.horizontal_args(v))
        return out.reshape(src.shape[:-2] + out.shape[-2:])

    def __call__(self, src):
        out = self.horizontal(*self.vertical(self.crop(src)))
        return out.reshape(src.shape[:-2] + out.shape[-2:])

    def plain(self, src):
        return self._run(src, srw_aligned_vertical_plain, srw_aligned_horizontal_plain)


def make_srw_aligned_fn(
    plan: SRWAlignedPlan, interp_method: str = "bilinear", fill_value=np.nan,
    device="cuda",
) -> AlignedSRWFn:
    """The aligned SRW reprojection of *plan* with its statics on *device*;
    bilinear and nearest only (``srw.py:1056-1057``)."""
    if interp_method not in ALIGNED_METHODS:
        raise ValueError("SRW supports 'bilinear' and 'nearest' only")
    return AlignedSRWFn(aligned_plan_to_device(plan, device), interp_method, fill_value)


@dataclass
class HybridSRWState(AlignedSRWState):
    """An :class:`SRWHybridPlan` on the device: the aligned state's fields,
    with ``base_v`` (out_h, n_col_tiles) and ``base_h`` (n_row_tiles,
    out_w) a base a tile, and the tiles' sizes."""

    col_tile: int
    row_tile: int


def hybrid_plan_to_device(plan: SRWHybridPlan, device) -> HybridSRWState:
    st = aligned_plan_to_device(plan, device, col_tile=plan.col_tile)
    return HybridSRWState(**vars(st), col_tile=int(plan.col_tile), row_tile=int(plan.row_tile))


class HybridSRWFn(AlignedSRWFn):
    """``fn(src) -> target`` through K17 then K18; ``fn.plain(src)``
    through their plain versions.  ``src`` is (..., H, W) float32 on the
    state's device; ``window`` (j0, j1, i0, i1), when set, crops it
    first.  ``kind`` is ``"hybrid"`` (``make_srw_hybrid_fn``)."""

    kind = "hybrid"

    def vertical_args(self, src):
        """K17's arguments for the cropped (B, src_h, src_w) *src*."""
        st = self.state
        return (
            src, st.iystar_c, st.step, st.s_v, st.base_v, st.col_tile, st.d_v,
            self.interp_method,
        )

    def horizontal_args(self, v):
        """K18's arguments for K17's output *v*."""
        st = self.state
        return (
            v, st.ix_c, st.iy_c, st.step, st.s_h, st.base_h, st.row_tile, st.d_h,
            st.src_h, self.interp_method, self.fill_value,
        )

    _vertical = staticmethod(srw_hybrid_vertical)
    _horizontal = staticmethod(srw_hybrid_horizontal)

    def plain(self, src):
        return self._run(src, srw_hybrid_vertical_plain, srw_hybrid_horizontal_plain)


def make_srw_hybrid_fn(
    plan: SRWHybridPlan, interp_method: str = "bilinear", fill_value=np.nan,
    device="cuda",
) -> HybridSRWFn:
    """The hybrid SRW reprojection of *plan* with its statics on *device*;
    bilinear and nearest only (``srw.py:1355-1356``)."""
    if interp_method not in ALIGNED_METHODS:
        raise ValueError("SRW supports 'bilinear' and 'nearest' only")
    return HybridSRWFn(hybrid_plan_to_device(plan, device), interp_method, fill_value)


# The batched formulation's thresholds (srw.py:1676-1680): JAX takes it
# where the tiled plan's per-tile loops would emit more than BATCHED_OPS
# operations and the source and target hold fewer than BATCHED_ELEMS
# elements together.
BATCHED_OPS = 128
BATCHED_ELEMS = 64_000_000


def make_srw_reproject_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    device="cuda",
    step: int = STEP,
    allow_hybrid: bool = False,
    **plan_kwargs,
) -> SRWFn | AlignedSRWFn | HybridSRWFn | None:
    """Crop, gate, plan and pick the SRW variant as the JAX package's
    ``make_srw_reproject_fn`` does (:1550-1685), or None where its gates
    refuse every plan (callers then try the ESW).  ``allow_hybrid`` (the
    JAX package's ``XRTPU_FAST_EXTREME_WARP=1``, which the reproject
    engine's ladder reads and passes here; never for triangular) skips the
    two-pass fidelity gate and admits the hybrid plan.  *plan_kwargs* go to
    :func:`plan_srw` only, as there."""
    if interp_method not in METHODS:
        return None
    if interp_method == "triangular":
        allow_hybrid = False
    fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    # crop the source to the window the target taps (srw.py:1585-1611)
    w = _source_window_gm(source_gm, fields, margin=8 + 48)
    if w is not None:
        win_gm, (j0, j1, i0, i1) = w
        inner = make_srw_reproject_fn(
            win_gm, target_gm, interp_method, fill_value, device, step=step,
            allow_hybrid=allow_hybrid, **plan_kwargs,
        )
        if inner is not None:
            if inner.window is None:
                inner.window = (j0, j1, i0, i1)
            else:
                a0, a1, b0, b1 = inner.window
                inner.window = (j0 + a0, j0 + a1, i0 + b0, i0 + b1)
        return inner
    # the curvature gate and, unless the hybrid is allowed, the two-pass
    # fidelity gate (srw.py:1614-1629)
    if _fields_interp_err(fields) > POS_TOL:
        return None
    if not allow_hybrid and _twopass_slope(fields) > 0.2:
        return None
    tiled = plan_srw(source_gm, target_gm, step=step, fields=fields, **plan_kwargs)
    aligned = (
        plan_srw_aligned(source_gm, target_gm, step=step, fields=fields, max_taps=MAX_TAPS)
        if interp_method in ALIGNED_METHODS
        else None
    )
    hybrid = (
        plan_srw_hybrid(source_gm, target_gm, step=step, fields=fields)
        if allow_hybrid
        else None
    )
    # the cost model (srw.py:1645-1668): a full-array stream per tap and
    # per shift pass, four more for the hybrid's reshuffles; min keeps the
    # first candidate on a tie (tiled, aligned, hybrid)
    candidates = []
    if tiled is not None:
        candidates.append((tiled.d_v + tiled.d_h, "tiled", tiled))
    if aligned is not None:
        cost = aligned.bits_v + aligned.bits_h + aligned.d_v + aligned.d_h
        candidates.append((cost, "aligned", aligned))
    if hybrid is not None:
        cost = hybrid.bits_v + hybrid.bits_h + hybrid.d_v + hybrid.d_h + 4
        candidates.append((cost, "hybrid", hybrid))
    if not candidates:
        return None
    _, kind, best = min(candidates, key=lambda c: c[0])
    if kind == "aligned":
        return make_srw_aligned_fn(best, interp_method, fill_value, device)
    if kind == "hybrid":
        return make_srw_hybrid_fn(best, interp_method, fill_value, device)
    return make_srw_fn_picked(best, interp_method, fill_value, device)


def make_srw_fn_picked(
    plan: SRWPlan, interp_method: str = "bilinear", fill_value=np.nan, device="cuda",
) -> SRWFn:
    """:func:`make_srw_fn`, its ``kind`` the JAX package's pick between
    ``make_srw_fn`` and ``make_srw_fn_batched`` (srw.py:1676-1680; the
    rectify Phase B's, rectify_ops.py:2611-2616, the same): batched where
    the tiled loops would emit more than :data:`BATCHED_OPS` operations
    and the source and target hold fewer than :data:`BATCHED_ELEMS`
    elements together."""
    n_ops = plan.base_v.shape[1] * plan.d_v + plan.base_h.shape[0] * plan.d_h
    n_elems = plan.src_h * plan.src_w + plan.out_h * plan.out_w
    fn = make_srw_fn(plan, interp_method, fill_value, device)
    if n_ops > BATCHED_OPS and n_elems < BATCHED_ELEMS:
        fn.kind = "batched"
    return fn


# ---------------------------------------------------------------------------
# the two-pass region mosaic (domain-scale warps beyond any single plan)
# ---------------------------------------------------------------------------


@dataclass
class RegionPiece:
    """Target rows [r0, r1) and columns [c0, c1) of the two-pass mosaic,
    computed by *fn* from the source window ``window`` (j0, j1, i0, i1; None
    for the whole source), planned at the coarse ``step`` (None for a
    direct-gather piece)."""

    r0: int
    r1: int
    c0: int
    c1: int
    window: tuple[int, int, int, int] | None
    step: int | None
    fn: SRWFn | AlignedSRWFn | HybridSRWFn | FusedReprojectFn

    @property
    def kind(self) -> str:
        """The piece's SRW variant (``fn.kind``), or ``"gather"`` (K3)."""
        return getattr(self.fn, "kind", "gather")


class RegionSRWFn:
    """``fn(src) -> target``: the two-pass region mosaic, each piece through
    its own kernels (K17 + K18, K14 + K15, K1 + K2 or K3) on the source in
    its dtype, into its rectangle of the float32 canvas; ``fn.plain(src)``
    through their plain versions.  The
    canvas is filled first only where the pieces do not cover the target
    (``covered``); the quadtree always covers it."""

    def __init__(self, pieces, out_h, out_w, fill_value):
        self.pieces = pieces
        self.out_h, self.out_w = out_h, out_w
        self.fill_value = float(fill_value)
        area = sum((p.r1 - p.r0) * (p.c1 - p.c0) for p in pieces)
        self.covered = area == out_h * out_w

    def _run(self, src, plain):
        # each piece takes the source in its dtype (its own variant's
        # rule); the float32 canvas casts what it returns, as the JAX
        # package's ``out.at[...].set``
        shape = src.shape[:-2] + (self.out_h, self.out_w)
        if self.covered:
            out = torch.empty(shape, dtype=torch.float32, device=src.device)
        else:
            out = torch.full(shape, self.fill_value, dtype=torch.float32, device=src.device)
        for p in self.pieces:
            piece_src = src
            if p.window is not None:
                j0, j1, i0, i1 = p.window
                piece_src = src[..., j0:j1, i0:i1]
            run = p.fn.plain if plain else p.fn
            out[..., p.r0 : p.r1, p.c0 : p.c1] = run(piece_src)
        return out

    def __call__(self, src):
        return self._run(src, plain=False)

    def plain(self, src):
        return self._run(src, plain=True)


def make_region_reproject_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    step: int = STEP,
    base_split: int = 4,
    max_depth: int = 3,
    exact: bool = False,
    device="cuda",
):
    """The region mosaic for warps too severe for any single SRW plan, as
    the JAX package's ``make_region_reproject_fn`` (:1730-1865).  With
    ``exact=True`` the exact region mosaic
    (:func:`.esw_mosaic.make_esw_region_fn`: the ESW on each quadtree
    piece, the direct gather where a piece refuses).  Otherwise the
    two-pass mosaic (:class:`RegionSRWFn`; bilinear and nearest, None for
    other methods): the target split *base_split* ways an axis and then by
    a quadtree up to *max_depth*, each region planned by
    :func:`make_srw_reproject_fn` on its own cropped source window at
    *step* and then at 4, split where both refuse (while it is at least
    128 pixels a side) and otherwise through K3.  None where no region
    plans."""
    if exact:
        from .esw_mosaic import make_esw_region_fn

        return make_esw_region_fn(
            source_gm, target_gm, interp_method, fill_value, step=step, device=device
        )
    if interp_method not in ALIGNED_METHODS:
        return None

    out_h, out_w = target_gm.height, target_gm.width
    x_res = float(target_gm.x_res)
    y_res = float(target_gm.y_res)
    j_up = bool(target_gm.is_j_axis_up)

    def region_gm(r0, r1, c0, c1):
        if j_up:
            y_min = float(target_gm.y_min) + r0 * y_res
        else:
            y_min = float(target_gm.y_max) - r1 * y_res
        return GridMapping.regular(
            size=(c1 - c0, r1 - r0),
            xy_min=(float(target_gm.x_min) + c0 * x_res, y_min),
            xy_res=(x_res, y_res),
            crs=target_gm.crs,
            is_j_axis_up=j_up,
        )

    pieces: list[RegionPiece] = []

    def build(r0, r1, c0, c1, depth):
        gm = region_gm(r0, r1, c0, c1)
        fields = _coarse_geometry(source_gm, gm, step)
        win = None
        src_gm_here = source_gm
        if fields is not None:
            w = _source_window_gm(source_gm, fields, margin=8 + 48)
            if w is not None:
                src_gm_here, win = w
        # a finer coarse step rescues high-curvature regions (srw.py:1809)
        for step_try in (step, 4):
            fn = make_srw_reproject_fn(
                src_gm_here, gm, interp_method, fill_value, device, step=step_try,
                allow_hybrid=True,
            )
            if fn is not None:
                pieces.append(RegionPiece(r0, r1, c0, c1, win, step_try, fn))
                return
        if depth < max_depth and (r1 - r0) >= 128 and (c1 - c0) >= 128:
            rm = (r0 + r1) // 2
            cm = (c0 + c1) // 2
            build(r0, rm, c0, cm, depth + 1)
            build(r0, rm, cm, c1, depth + 1)
            build(rm, r1, c0, cm, depth + 1)
            build(rm, r1, cm, c1, depth + 1)
            return
        gfn = make_fused_reproject_fn(src_gm_here, gm, interp_method, fill_value, device)
        pieces.append(RegionPiece(r0, r1, c0, c1, win, None, gfn))

    rb = -(-out_h // base_split)
    cb = -(-out_w // base_split)
    for bj in range(base_split):
        for bi in range(base_split):
            r0, r1 = bj * rb, min((bj + 1) * rb, out_h)
            c0, c1 = bi * cb, min((bi + 1) * cb, out_w)
            if r1 > r0 and c1 > c0:
                build(r0, r1, c0, c1, 0)

    if all(p.step is None for p in pieces):
        return None  # nothing planned: the plain gather on the full grid wins
    return RegionSRWFn(pieces, out_h, out_w, fill_value)
