"""Sharded regridding with halo exchange over a mesh of devices.

Port of ``xcube_resampling_tpu/parallel/halo.py``: the source raster is
cut in row bands, one a mesh entry; each band is extended by ``halo`` rows
of its neighbours (:func:`_exchange_halo`, copies of row slices between
the band tensors, where JAX's ``shard_map`` runs ``lax.ppermute``; every
band's halo is queued before any band's kernels, so that no copy waits
on another device's kernels) and then runs the band forms of the port's
kernels on its own target rows.
One process drives every device of the mesh, as JAX's single-controller
``shard_map`` does, so a step is one call.

* :func:`make_sharded_srw_step`: the tiled SRW on bands, K1's and K2's
  band forms (``srw_vertical_band``, ``srw_horizontal_band``), planned on
  the host by :func:`plan_sharded_srw` (``halo.py:262-349``);
* :func:`make_sharded_esw_step`: the exact separable warp on bands, K13's
  band form (``esw_gather_band``), planned on the host by
  :func:`plan_sharded_esw` (``halo.py:555-643``), its halo from the plan's
  vertical taps;
* :func:`make_sharded_regrid_step`: the direct gather on bands, K3's band
  form (``fused_reproject_band``);
* :func:`sharded_reproject`: the source crop, then JAX's ladder: the SRW
  where its gates admit the mapping, the ESW beyond them where its plan
  admits it, else the regrid;
* :func:`make_sharded_rectify_step`: rectify's Phase B on bands, K7's band
  form (``ij_gather_band``) through the rows of the Phase A map that fall
  to the band's target rows;
* :func:`sharded_phase_a`: rectify's Phase A banded over the mesh, the
  hybrid seed and dense kernels (K11, K12) on each band's target rows;
* :func:`sharded_rectify`: both phases.

Each step returns a :class:`.tiling.Sharded`: one band of target rows a
mesh entry, on that entry's device.  The source may be of any data dtype
(``_device.DATA_DTYPES``), each step applying its single-chip tier's rule
as the JAX package's steps do: the SRW step the tiled SRW's promotion
(float64 stays float64, the rest float32), the ESW step a cast to
float32, the regrid and rectify steps ``gather_interp``'s (nearest keeps
the dtype; bool bilinear raises ``TypeError``).  The step objects also
run the plain versions of the band kernels (``step.plain(src)``), on the
same devices.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from .._device import as_float32, require_data_dtype
from ..constants import UV_DELTA
from ..gridmapping import GridMapping
from ..ops.rectify_ops import (
    DeviceIJMap,
    hybrid_dense,
    hybrid_seed,
    hybrid_window,
    ij_gather_band,
    ij_gather_band_plain,
)
from ..ops.esw import _max_row_deviation, esw_gather_band, esw_gather_band_plain
from ..ops.reproject_ops import (
    METHODS,
    coarse_coord_field,
    fused_reproject_band,
    fused_reproject_band_plain,
    method_code,
)
from ..ops.srw import (
    _coarse_geometry,
    _interp_cols,
    _interp_rows,
    _pick_tile,
    _source_window_gm,
    _twopass_slope,
)
from ..ops.srw_kernels import (
    Windows,
    plan_horizontal_windows,
    plan_vertical_windows,
    srw_horizontal_band,
    srw_horizontal_band_plain,
    srw_vertical_band,
    srw_vertical_band_plain,
)
from .tiling import Sharded, pad_rows

LOG = logging.getLogger("xcube.resampling")

_F32 = torch.float32


def _exchange_halo(
    bands: list[torch.Tensor], halo: int, band_h: int
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Every band's halo from its neighbours: for band ``k`` the *halo*
    rows above it and below it, (B, halo, W) each on band ``k``'s device
    (global rows ``k * band_h - halo`` on and ``(k + 1) * band_h`` on).
    Hop ``h`` copies rows of the ``h``-th neighbour's band, so halos larger
    than one band still resolve; rows past the mesh's edge are zeros, as
    ``ppermute`` leaves them.  Across devices the copies are peer copies,
    ordered after the work queued on both devices: called before any
    band's kernels are queued, no copy waits on them."""
    n = len(bands)
    out = []
    for k, own in enumerate(bands):
        batch, _, width = own.shape
        pair = []
        for first in (k * band_h - halo, (k + 1) * band_h):
            rows = torch.empty((batch, halo, width), dtype=own.dtype, device=own.device)
            for j in range(first // band_h, -(-(first + halo) // band_h)):
                lo, hi = max(j * band_h, first), min((j + 1) * band_h, first + halo)
                dst = rows[:, lo - first : hi - first]
                if 0 <= j < n:
                    dst.copy_(bands[j][:, lo - j * band_h : hi - j * band_h],
                              non_blocking=True)
                else:
                    dst.zero_()
            pair.append(rows)
        out.append(tuple(pair))
    return out


def _extend(band: torch.Tensor, halos) -> torch.Tensor:
    """*band* (B, band_h, W) with its halo rows from :func:`_exchange_halo`
    above and below: (B, band_h + 2 * halo, W), as ``halo.py:81-82`` trims
    JAX's extension; the band itself where there is no halo (None)."""
    if halos is None:
        return band.contiguous()
    top, bottom = halos
    batch, band_h, width = band.shape
    halo = top.shape[1]
    ext = torch.empty((batch, band_h + 2 * halo, width), dtype=band.dtype, device=band.device)
    ext[:, :halo].copy_(top)
    ext[:, halo : halo + band_h].copy_(band)
    ext[:, halo + band_h :].copy_(bottom)
    return ext


def required_halo(
    source_gm: GridMapping,
    target_gm: GridMapping,
    n_bands: int,
    coord_fields=None,
) -> int:
    """Worst-case extra source rows a device needs beyond its proportional
    band, measured from the actual inverse coordinate mapping.  Copy of
    ``xcube_resampling_tpu/parallel/halo.py:required_halo``."""
    if coord_fields is None:
        coord_fields = coarse_coord_field(source_gm, target_gm)
    _, iy_c, step = coord_fields
    band_h = -(-source_gm.height // n_bands)
    out_band_h = -(-target_gm.height // n_bands)
    # evaluate the row mapping at every band's first and last target row
    # (linear interpolation of the coarse field — the same approximation
    # the device kernel uses), vectorized over bands x columns
    ks = np.arange(n_bands)
    r0s = ks * out_band_h
    r1s = np.minimum((ks + 1) * out_band_h - 1, target_gm.height - 1)
    rows = np.concatenate([r0s, r1s]).astype(np.float64)
    band_starts = np.concatenate([ks, ks]).astype(np.float64) * band_h
    rr = rows / step
    j0 = np.clip(rr.astype(np.int64), 0, iy_c.shape[0] - 2)
    fj = (rr - j0)[:, None]
    iy_rows = iy_c[j0, :] * (1 - fj) + iy_c[j0 + 1, :] * fj  # (2n, ncols)
    with np.errstate(invalid="ignore"):
        above = np.nanmax(band_starts[:, None] - iy_rows, axis=1)
        below = np.nanmax(
            iy_rows - (band_starts + band_h - 1)[:, None], axis=1
        )
    edges = np.concatenate([above, below])
    edges = edges[np.isfinite(edges)]
    dev = float(edges.max()) if edges.size else 0.0
    return int(np.ceil(max(0.0, dev))) + 2


def _axis_devices(mesh, axis_name: str) -> tuple[torch.device, ...]:
    """The devices along *axis_name*; the mesh's other axes must be 1."""
    n = mesh.shape[axis_name]
    if n != len(mesh.devices):
        raise ValueError(
            f"the port shards over a mesh of one axis: {axis_name!r} has {n} of "
            f"{len(mesh.devices)} devices"
        )
    return mesh.devices


def _place_bands(src, devices, band_h: int, src_batch_dims: int):
    """The padded global source (…, n * band_h, W) as (B, band_h, W) row
    bands, band ``k`` on ``devices[k]`` (a view where it lies there), and
    the leading dims.  A :class:`.tiling.Sharded` source already holds its
    bands on their devices (as a sharded ``jax.Array`` does): they are
    taken as they are."""
    n = len(devices)
    if isinstance(src, Sharded):
        if len(src.bands) != n:
            raise ValueError(f"{len(src.bands)} source bands for {n} devices")
        for k, (band, dev) in enumerate(zip(src.bands, devices)):
            require_data_dtype(band.dtype, f"source band {k}")
            if band.ndim != 2 + src_batch_dims or band.shape[-2] != band_h:
                raise ValueError(f"source band {k} of shape {tuple(band.shape)}, expected "
                                 f"{2 + src_batch_dims} dims and {band_h} rows")
            if band.device != torch.device(dev):
                raise ValueError(f"source band {k} lies on {band.device}, not {dev}")
        lead = tuple(src.bands[0].shape[:-2])
        return [b.reshape((-1,) + tuple(b.shape[-2:])) for b in src.bands], lead
    require_data_dtype(src.dtype, "the source")
    if src.ndim != 2 + src_batch_dims:
        raise ValueError(f"source of {src.ndim} dims, expected {2 + src_batch_dims}")
    lead = tuple(src.shape[:-2])
    h, w = src.shape[-2:]
    if h != n * band_h:
        raise ValueError(f"padded source of {h} rows, expected {n} bands of {band_h}")
    flat = src.reshape((-1, h, w))
    return [
        flat[:, k * band_h : (k + 1) * band_h].to(dev) for k, dev in enumerate(devices)
    ], lead


class _Statics:
    """Per-device copies of a step's replicated tensors, made once."""

    def __init__(self, **arrays: np.ndarray):
        self._host = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()}
        self._on: dict[torch.device, dict[str, torch.Tensor]] = {}

    def on(self, device: torch.device) -> dict[str, torch.Tensor]:
        if device not in self._on:
            self._on[device] = {k: t.to(device) for k, t in self._host.items()}
        return self._on[device]


# ---------------------------------------------------------------------------
# the sharded SRW
# ---------------------------------------------------------------------------


@dataclass
class ShardedSRWPlan:
    """The sharded tiled-SRW plan of ``halo.py:262-349`` on the host: the
    coarse fields (float32), the vertical bases of every padded target row
    (``base_v``, per column tile) and the horizontal bases of every band's
    row tiles (``base_h``, ``tiles_per_band`` a band, the last tile of a
    band overlapping its predecessor), the tap counts, the halo, and per
    band the staged windows of K1 and K2."""

    iystar_c: np.ndarray  # (ncj, ncc)
    ix_c: np.ndarray  # (ncj, nci)
    iy_c: np.ndarray  # (ncj, nci)
    step: int
    base_v: np.ndarray  # (n * out_band_h, n_col_tiles) int32
    col_tile: int
    d_v: int
    base_h: np.ndarray  # (n * tiles_per_band, out_w) int32
    row_tile: int
    tiles_per_band: int
    d_h: int
    halo: int
    n: int
    band_h: int
    src_pad_h: int
    out_band_h: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int
    win_v: list[Windows]
    win_h: list[Windows]

    @property
    def use_halo(self) -> bool:
        return self.n > 1 and self.halo > 0

    def offset(self, k: int) -> int:
        """The global source row of band *k*'s extended row 0."""
        return k * self.band_h - (self.halo if self.use_halo else 0)


def plan_sharded_srw(
    source_gm: GridMapping,
    target_gm: GridMapping,
    n: int,
    step: int = 16,
    max_taps: int = 48,
    tap_budget: int = 12,
) -> ShardedSRWPlan | None:
    """The sharded SRW's plan over *n* bands, or None where the mapping is
    unsuitable: the same gates and arithmetic as
    ``xcube_resampling_tpu/parallel/halo.py:262-349``."""
    fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    # same two-pass fidelity gate as the single-chip default path
    if _twopass_slope(fields) > 0.2:
        return None
    ix64, iystar = fields.ix64, fields.iystar64
    iy64 = fields.iy64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w

    band_h = -(-src_h // n)
    src_pad_h = band_h * n - src_h
    out_band_h = -(-out_h // n)  # exact: bands stay proportionally aligned
    out_h_pad = out_band_h * n

    # ---- vertical plan: per-(output row, column tile) integer base
    slope_v = float(np.nanmax(np.abs(np.diff(iystar, axis=1))) / step)
    col_tile = _pick_tile(slope_v, tap_budget)
    ncc = iystar.shape[1]
    n_col_tiles = -(-src_w // col_tile)
    iystar_rows = _interp_rows(iystar, out_h, step)
    if out_h_pad > out_h:  # padded rows replicate the last real row
        iystar_rows = np.concatenate(
            [iystar_rows, np.repeat(iystar_rows[-1:], out_h_pad - out_h, 0)]
        )
    base_v = np.zeros((out_h_pad, n_col_tiles), dtype=np.int32)
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

    # ---- horizontal plan: per-(band, row tile) base with an overlapping
    # last tile (tiles never straddle band boundaries)
    slope_h = float(np.nanmax(np.abs(np.diff(ix64, axis=0))) / step)
    row_tile = min(_pick_tile(slope_h, tap_budget), out_band_h)
    tiles_per_band = -(-out_band_h // row_tile)
    tile_starts = [t * row_tile for t in range(tiles_per_band - 1)]
    tile_starts.append(out_band_h - row_tile)
    ix_cols = _interp_cols(ix64, out_w, step)
    ncj = ix64.shape[0]
    sample_rows = np.arange(ncj) * step
    base_h = np.zeros((n * tiles_per_band, out_w), dtype=np.int32)
    span_max_h = 0.0
    for k in range(n):
        for t, s0 in enumerate(tile_starts):
            r0 = min(k * out_band_h + s0, out_h - 1)
            r1 = min(r0 + row_tile, out_h)
            k0 = max(0, int(np.searchsorted(sample_rows, r0)) - 1)
            k1 = min(ncj, int(np.searchsorted(sample_rows, r1)) + 2)
            seg = ix_cols[k0:k1, :]
            m = seg.min(axis=0)
            base_h[k * tiles_per_band + t, :] = (
                np.floor(m).astype(np.int32) - 1
            )
            span_max_h = max(span_max_h, float((seg.max(axis=0) - m).max()))
    d_h = int(np.ceil(span_max_h)) + 4
    if d_h > max_taps:
        return None

    # ---- halo: worst-case deviation of any band's (globally clamped)
    # vertical taps from its proportional source band
    lo_tap = np.clip(base_v.min(axis=1), 0, src_h - 1)
    hi_tap = np.clip(base_v.max(axis=1) + d_v - 1, 0, src_h - 1)
    halo = 0
    for k in range(n):
        r0, r1 = k * out_band_h, (k + 1) * out_band_h
        off = k * band_h
        halo = max(
            halo,
            int(off - lo_tap[r0:r1].min()),
            int(hi_tap[r0:r1].max() - (off + band_h - 1)),
        )
    halo = max(halo, 0)
    halo = min(halo, (n - 1) * band_h)

    tpb = tiles_per_band
    return ShardedSRWPlan(
        iystar_c=iystar.astype(np.float32),
        ix_c=ix64.astype(np.float32),
        iy_c=iy64.astype(np.float32),
        step=step, base_v=base_v, col_tile=col_tile, d_v=d_v, base_h=base_h,
        row_tile=row_tile, tiles_per_band=tpb, d_h=d_h, halo=halo, n=n,
        band_h=band_h, src_pad_h=src_pad_h, out_band_h=out_band_h,
        src_h=src_h, src_w=src_w, out_h=out_h, out_w=out_w,
        win_v=[
            plan_vertical_windows(
                base_v[k * out_band_h : (k + 1) * out_band_h], col_tile, d_v
            )
            for k in range(n)
        ],
        win_h=[
            plan_horizontal_windows(base_h[k * tpb : (k + 1) * tpb], row_tile, d_h)
            for k in range(n)
        ],
    )


class ShardedSRWStep:
    """``step(src) -> Sharded``: K1's and K2's band forms on each band of
    the padded global source (…, n * band_h, W), or of a ``Sharded`` of
    its bands, after the halo exchange; ``step.plain(src)`` runs their
    plain versions on the same devices."""

    def __init__(self, devices, plan: ShardedSRWPlan, interp_method, fill_value,
                 src_batch_dims):
        method_code(interp_method)
        self.devices = tuple(devices)
        self.plan = plan
        self.interp_method = interp_method
        self.fill_value = float(fill_value)
        self.src_batch_dims = src_batch_dims
        self._fields = _Statics(iystar_c=plan.iystar_c, ix_c=plan.ix_c, iy_c=plan.iy_c)
        p = plan
        self._bands = []
        for k, dev in enumerate(self.devices):
            base_v = p.base_v[k * p.out_band_h : (k + 1) * p.out_band_h]
            base_h = p.base_h[k * p.tiles_per_band : (k + 1) * p.tiles_per_band]
            self._bands.append((
                torch.from_numpy(np.ascontiguousarray(base_v)).to(dev),
                torch.from_numpy(np.ascontiguousarray(base_h)).to(dev),
                p.win_v[k].to(dev),
                p.win_h[k].to(dev),
            ))

    def bands(self, src):
        """The padded global source as (B, band_h, W) bands on the mesh's
        devices, and its leading dims."""
        return _place_bands(src, self.devices, self.plan.band_h, self.src_batch_dims)

    def exchange(self, bands):
        """Every band's halo (:func:`_exchange_halo`), None per band where
        the step needs none."""
        p = self.plan
        if not p.use_halo:
            return [None] * len(bands)
        return _exchange_halo(bands, p.halo, p.band_h)

    def vertical_args(self, bands, halos, k):
        """K1's band-form arguments for band *k* of *bands*: its
        extension by its halo from :meth:`exchange` first."""
        p = self.plan
        ext = _extend(bands[k], halos[k])
        base_v, _, win_v, _ = self._bands[k]
        return (
            ext, self._fields.on(self.devices[k])["iystar_c"], p.step, base_v,
            p.col_tile, p.d_v, win_v, self.interp_method, k * p.out_band_h,
            p.offset(k), p.src_h,
        )

    def horizontal_args(self, v, vd, k):
        """K2's band-form arguments for band *k*'s vertical pass *v*
        (*vd* for triangular)."""
        p = self.plan
        f = self._fields.on(self.devices[k])
        _, base_h, _, win_h = self._bands[k]
        return (
            v, f["ix_c"], f["iy_c"], p.step, base_h, p.row_tile, p.d_h, p.src_h,
            win_h, self.interp_method, self.fill_value,
            vd if self.interp_method == "triangular" else None, k * p.out_band_h,
        )

    def _run(self, src, vertical, horizontal) -> Sharded:
        bands, lead = self.bands(src)
        halos = self.exchange(bands)
        out = []
        for k in range(len(self.devices)):
            v, vd = vertical(*self.vertical_args(bands, halos, k))
            o = horizontal(*self.horizontal_args(v, vd, k))
            del v, vd
            out.append(o.reshape(lead + tuple(o.shape[-2:])))
        return Sharded(out, self.plan.out_h)

    def __call__(self, src) -> Sharded:
        return self._run(src, srw_vertical_band, srw_horizontal_band)

    def plain(self, src) -> Sharded:
        return self._run(src, srw_vertical_band_plain, srw_horizontal_band_plain)


def make_sharded_srw_step(
    mesh,
    source_gm: GridMapping,
    target_gm: GridMapping,
    axis_name: str = "bands",
    interp_method: str = "bilinear",
    fill_value: float = np.nan,
    src_batch_dims: int = 0,
    step: int = 16,
    max_taps: int = 48,
    tap_budget: int = 12,
):
    """The sharded tiled SRW over ``mesh[axis_name]``: halo exchange, then
    K1's and K2's band forms on each band.

    Returns ``(step_fn, (src_pad_h, out_h))`` or None where the mapping is
    unsuitable (callers then use :func:`make_sharded_regrid_step`).
    ``step_fn(src)`` takes the source padded by ``src_pad_h`` rows and
    returns a :class:`.tiling.Sharded` of ``out_h`` target rows."""
    if interp_method not in ("bilinear", "nearest", "triangular"):
        return None
    devices = _axis_devices(mesh, axis_name)
    plan = plan_sharded_srw(
        source_gm, target_gm, len(devices), step, max_taps, tap_budget
    )
    if plan is None:
        return None
    step_fn = ShardedSRWStep(devices, plan, interp_method, fill_value, src_batch_dims)
    return step_fn, (plan.src_pad_h, plan.out_h)


# ---------------------------------------------------------------------------
# the sharded regrid (direct gather)
# ---------------------------------------------------------------------------


class _BandGatherStep:
    """A one-pass band step: the halo exchange, then one kernel per band
    (``_kernels``: the kernel and its plain version) on the band's
    extension, with the arguments of :meth:`gather_args`.  ``step(src) ->
    Sharded`` runs the kernel on each band of the padded global source
    (…, n * band_h, W), or of a ``Sharded`` of its bands;
    ``step.plain(src)`` runs its plain version on the same devices."""

    _kernels: tuple

    def __init__(self, devices, halo, band_h, out_h, interp_method, fill_value,
                 src_batch_dims):
        method_code(interp_method)
        self.devices = tuple(devices)
        self.halo, self.band_h, self.out_h = halo, band_h, out_h
        self.interp_method = interp_method
        self.fill_value = float(fill_value)
        self.src_batch_dims = src_batch_dims

    @property
    def use_halo(self) -> bool:
        return len(self.devices) > 1 and self.halo > 0

    def bands(self, src):
        """The padded global source as (B, band_h, W) bands on the mesh's
        devices, and its leading dims."""
        return _place_bands(src, self.devices, self.band_h, self.src_batch_dims)

    def exchange(self, bands):
        """Every band's halo (:func:`_exchange_halo`), None per band where
        the step needs none."""
        if not self.use_halo:
            return [None] * len(bands)
        return _exchange_halo(bands, self.halo, self.band_h)

    def extension(self, bands, halos, k):
        """Band *k* extended by its halo, and the global source row of its
        first row."""
        off = k * self.band_h - (self.halo if halos[k] is not None else 0)
        return _extend(bands[k], halos[k]), off

    def gather_args(self, bands, halos, k):
        raise NotImplementedError

    def _run(self, src, gather) -> Sharded:
        bands, lead = self.bands(src)
        halos = self.exchange(bands)
        out = []
        for k in range(len(self.devices)):
            o = gather(*self.gather_args(bands, halos, k))
            out.append(o.reshape(lead + tuple(o.shape[-2:])))
        return Sharded(out, self.out_h)

    def __call__(self, src) -> Sharded:
        return self._run(src, self._kernels[0])

    def plain(self, src) -> Sharded:
        return self._run(src, self._kernels[1])


class ShardedRegridStep(_BandGatherStep):
    """``step(src) -> Sharded``: K3's band form on each band after the
    halo exchange (:class:`_BandGatherStep`)."""

    _kernels = (fused_reproject_band, fused_reproject_band_plain)

    def __init__(self, devices, ix_c, iy_c, step, halo, band_h, src_h, src_w,
                 out_h, out_w, interp_method, fill_value, src_batch_dims):
        super().__init__(devices, halo, band_h, out_h, interp_method, fill_value,
                         src_batch_dims)
        self._fields = _Statics(ix_c=ix_c, iy_c=iy_c)
        self.step = step
        self.src_h, self.src_w, self.out_w = src_h, src_w, out_w
        self.out_band_h = -(-out_h // len(self.devices))

    def gather_args(self, bands, halos, k):
        """K3's band-form arguments for band *k* of *bands*: its extension
        by its halo from :meth:`exchange` first."""
        ext, off = self.extension(bands, halos, k)
        f = self._fields.on(self.devices[k])
        return (
            ext, f["ix_c"], f["iy_c"], self.step, self.out_band_h, self.out_w,
            self.interp_method, self.fill_value, k * self.out_band_h, off,
            self.src_h,
        )


def make_sharded_regrid_step(
    mesh,
    source_gm: GridMapping,
    target_gm: GridMapping,
    axis_name: str = "bands",
    halo: int | None = None,
    interp_method: str = "bilinear",
    fill_value: float = np.nan,
    src_batch_dims: int = 0,
    step: int = 16,
):
    """The sharded direct gather over ``mesh[axis_name]``: halo exchange,
    then K3's band form on each band.

    Returns ``(step_fn, (src_pad_h, out_h))``; ``step_fn(src)`` takes the
    source padded by ``src_pad_h`` rows and returns a
    :class:`.tiling.Sharded` of ``out_h`` target rows.  A *halo* below
    what the row mapping needs warns: pixels whose source rows fall
    outside the exchanged band resolve to the fill value."""
    devices = _axis_devices(mesh, axis_name)
    n = len(devices)
    src_h, src_w = source_gm.height, source_gm.width
    out_h, out_w = target_gm.height, target_gm.width
    band_h = -(-src_h // n)
    src_pad_h = band_h * n - src_h

    fields = coarse_coord_field(source_gm, target_gm, step)
    need = required_halo(source_gm, target_gm, n, fields)
    if halo is None:
        halo = need
    elif halo < min(need, (n - 1) * band_h):
        LOG.warning(
            "sharded regrid halo=%d is smaller than the %d rows the "
            "row mapping requires: pixels whose source rows fall outside "
            "the exchanged band resolve to the fill value",
            halo,
            need,
        )
    halo = min(halo, (n - 1) * band_h)
    step_fn = ShardedRegridStep(
        devices, fields[0], fields[1], step, halo, band_h, src_h, src_w, out_h,
        out_w, interp_method, fill_value, src_batch_dims,
    )
    return step_fn, (src_pad_h, out_h)


# ---------------------------------------------------------------------------
# the sharded exact separable warp (ESW)
# ---------------------------------------------------------------------------


@dataclass
class ShardedESWPlan:
    """The sharded ESW plan of ``halo.py:555-643`` on the host: the coarse
    fields (float32), the sample count S, the band layout, the tap counts
    that decide the refusals, and the halo from the clamped vertical taps.
    K13's band form reads each pixel's taps directly, so the tap bases
    the JAX step plans serve the refusals and the halo only."""

    iystar_c: np.ndarray  # (ncj, ncc)
    ix_c: np.ndarray  # (ncj, nci)
    iy_c: np.ndarray  # (ncj, nci)
    step: int
    n_samples: int
    d_v: int
    d_h: int
    halo: int
    n: int
    band_h: int
    src_pad_h: int
    out_band_h: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def plan_sharded_esw(
    n: int,
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
    max_taps: int = 48,
    tap_budget: int = 16,
    max_samples: int = 10,
) -> ShardedESWPlan | None:
    """Plan the sharded ESW over *n* bands, or None where the mapping is
    unsuitable (non-monotone rows, or tap or sample counts out of budget).
    Copy of ``halo.py:555-643``."""
    fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    ix64, iy64, iystar = fields.ix64, fields.iy64, fields.iystar64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w

    margin = 0.35
    dev = _max_row_deviation(fields)
    S = max(3, int(np.ceil(2.0 * (dev + margin))) + 2)
    if S > max_samples:
        return None
    half = (S - 2) / 2.0

    band_h = -(-src_h // n)
    src_pad_h = band_h * n - src_h
    out_band_h = -(-out_h // n)
    out_h_pad = out_band_h * n

    # ---- vertical plan: per-(padded output row, column tile) bases with
    # the S-sample margin
    slope_v = float(np.nanmax(np.abs(np.diff(iystar, axis=1))) / step)
    col_tile = _pick_tile(slope_v, tap_budget)
    ncc = iystar.shape[1]
    n_col_tiles = -(-src_w // col_tile)
    iystar_rows = _interp_rows(iystar, out_h, step)
    if out_h_pad > out_h:
        iystar_rows = np.concatenate(
            [iystar_rows, np.repeat(iystar_rows[-1:], out_h_pad - out_h, 0)]
        )
    base_v = np.zeros((out_h_pad, n_col_tiles), dtype=np.int32)
    span_max = 0.0
    for t in range(n_col_tiles):
        c0 = t * col_tile
        c1 = min((t + 1) * col_tile, src_w)
        k0 = max(0, c0 // step - 1)
        k1 = min(ncc, -(-c1 // step) + 1)
        seg = iystar_rows[:, k0:k1]
        m = seg.min(axis=1)
        base_v[:, t] = np.floor(m - half).astype(np.int32) - 2
        span_max = max(span_max, float((seg.max(axis=1) - m).max()))
    d_v = int(np.ceil(span_max)) + S + 4
    if d_v > max_taps:
        return None

    # ---- horizontal plan: per-(band, row tile) base, overlapping last
    # tile so tiles never straddle bands
    slope_h = float(np.nanmax(np.abs(np.diff(ix64, axis=0))) / step)
    row_tile = min(_pick_tile(slope_h, tap_budget), out_band_h)
    tiles_per_band = -(-out_band_h // row_tile)
    tile_starts = [t * row_tile for t in range(tiles_per_band - 1)]
    tile_starts.append(out_band_h - row_tile)
    ix_cols = _interp_cols(ix64, out_w, step)
    ncj = ix64.shape[0]
    sample_rows = np.arange(ncj) * step
    base_h = np.zeros((n * tiles_per_band, out_w), dtype=np.int32)
    span_max_h = 0.0
    for k in range(n):
        for t, s0 in enumerate(tile_starts):
            r0 = min(k * out_band_h + s0, out_h - 1)
            r1 = min(r0 + row_tile, out_h)
            k0 = max(0, int(np.searchsorted(sample_rows, r0)) - 1)
            k1 = min(ncj, int(np.searchsorted(sample_rows, r1)) + 2)
            seg = ix_cols[k0:k1, :]
            m = seg.min(axis=0)
            base_h[k * tiles_per_band + t, :] = (
                np.floor(m).astype(np.int32) - 2
            )
            span_max_h = max(span_max_h, float((seg.max(axis=0) - m).max()))
    d_h = int(np.ceil(span_max_h)) + 5
    if d_h > max_taps:
        return None

    # ---- halo: worst-case deviation of any band's (globally clamped)
    # vertical taps from its proportional source band
    lo_tap = np.clip(base_v.min(axis=1), 0, src_h - 1)
    hi_tap = np.clip(base_v.max(axis=1) + d_v - 1, 0, src_h - 1)
    halo = 0
    for k in range(n):
        r0, r1 = k * out_band_h, (k + 1) * out_band_h
        off = k * band_h
        halo = max(
            halo,
            int(off - lo_tap[r0:r1].min()),
            int(hi_tap[r0:r1].max() - (off + band_h - 1)),
        )
    halo = max(halo, 0)
    halo = min(halo, (n - 1) * band_h)

    return ShardedESWPlan(
        iystar_c=iystar.astype(np.float32),
        ix_c=ix64.astype(np.float32),
        iy_c=iy64.astype(np.float32),
        step=step,
        n_samples=S,
        d_v=d_v,
        d_h=d_h,
        halo=halo,
        n=n,
        band_h=band_h,
        src_pad_h=src_pad_h,
        out_band_h=out_band_h,
        src_h=src_h,
        src_w=src_w,
        out_h=out_h,
        out_w=out_w,
    )


class ShardedESWStep(_BandGatherStep):
    """``step(src) -> Sharded``: K13's band form (``esw_gather_band``) on
    each band after the halo exchange (:class:`_BandGatherStep`), the
    halo from the plan's vertical taps."""

    _kernels = (esw_gather_band, esw_gather_band_plain)

    def __init__(self, devices, plan: ShardedESWPlan, interp_method, fill_value,
                 src_batch_dims):
        super().__init__(devices, plan.halo, plan.band_h, plan.out_h, interp_method,
                         fill_value, src_batch_dims)
        self.plan = plan
        self._fields = _Statics(iystar_c=plan.iystar_c, ix_c=plan.ix_c, iy_c=plan.iy_c)

    def gather_args(self, bands, halos, k):
        """K13's band-form arguments for band *k* of *bands*: its extension
        by its halo from :meth:`exchange` first."""
        ext, off = self.extension(bands, halos, k)
        f = self._fields.on(self.devices[k])
        p = self.plan
        return (
            as_float32(ext), f["iystar_c"], f["ix_c"], f["iy_c"], p.step, p.n_samples, p.out_band_h,
            p.out_w, self.interp_method, self.fill_value, k * p.out_band_h, off, p.src_h,
        )


def make_sharded_esw_step(
    mesh,
    source_gm: GridMapping,
    target_gm: GridMapping,
    axis_name: str = "bands",
    interp_method: str = "bilinear",
    fill_value: float = np.nan,
    src_batch_dims: int = 0,
    step: int = 16,
    max_taps: int = 48,
    tap_budget: int = 16,
    max_samples: int = 10,
):
    """The sharded exact separable warp over ``mesh[axis_name]``: halo
    exchange, then K13's band form on each band.  It reproduces the direct
    gather built on the same grid mappings (bit-exact nearest, within 2
    float32 ulp bilinear) with no two-pass fidelity gate.

    Returns ``(step_fn, (src_pad_h, out_h))`` as
    :func:`make_sharded_regrid_step` does, or None where the mapping is
    unsuitable (non-monotone rows, or tap or sample counts out of budget)."""
    if interp_method not in METHODS:
        return None
    devices = _axis_devices(mesh, axis_name)
    plan = plan_sharded_esw(
        len(devices), source_gm, target_gm, step, max_taps, tap_budget, max_samples
    )
    if plan is None:
        return None
    step_fn = ShardedESWStep(devices, plan, interp_method, fill_value, src_batch_dims)
    return step_fn, (plan.src_pad_h, plan.out_h)


def crop_source(src, source_gm: GridMapping, target_gm: GridMapping):
    """*src* and *source_gm* cropped to the window *target_gm* taps, as
    ``sharded_reproject`` crops them (a view of *src*)."""
    # crop the source to the tapped window before banding: a target
    # covering a subset of a global source would otherwise (a) stream
    # every column on every tap and (b) break the proportional
    # band<->band row correspondence the halo model assumes (all target
    # rows would map into one device's band)
    fields = _coarse_geometry(source_gm, target_gm, 16)
    if fields is not None:
        w = _source_window_gm(source_gm, fields, margin=8 + 48)
        if w is not None:
            source_gm, (j0, j1, i0, i1) = w
            src = src[..., j0:j1, i0:i1]
    return src, source_gm


def sharded_reproject(
    src,
    source_gm: GridMapping,
    target_gm: GridMapping,
    mesh,
    axis_name: str = "bands",
    halo: int | None = None,
    interp_method: str = "bilinear",
    fill_value: float = np.nan,
    use_srw: bool = True,
) -> Sharded:
    """Reproject the tensor *src* (…, H, W) of any data dtype with its rows
    sharded over ``mesh[axis_name]``; returns the target raster, in the
    tier's output dtype (the module docstring), as a
    :class:`.tiling.Sharded` (``.full()`` gathers it on one device).

    The tiers mirror the single-chip dispatch (``halo.py:1219-1249``): the
    sharded SRW where its fidelity gate admits the mapping, the sharded
    ESW (K13's band form) for rotation-heavy warps beyond the gate, and
    the sharded regrid (K3's band form) where the ESW refuses."""
    src, source_gm = crop_source(src, source_gm, target_gm)
    built = None
    if use_srw:
        built = make_sharded_srw_step(
            mesh,
            source_gm,
            target_gm,
            axis_name=axis_name,
            interp_method=interp_method,
            fill_value=fill_value,
            src_batch_dims=src.ndim - 2,
        )
    if built is None:
        built = make_sharded_esw_step(
            mesh,
            source_gm,
            target_gm,
            axis_name=axis_name,
            interp_method=interp_method,
            fill_value=fill_value,
            src_batch_dims=src.ndim - 2,
        )
    if built is None:
        built = make_sharded_regrid_step(
            mesh,
            source_gm,
            target_gm,
            axis_name=axis_name,
            halo=halo,
            interp_method=interp_method,
            fill_value=fill_value,
            src_batch_dims=src.ndim - 2,
        )
    step_fn, (src_pad_h, out_h) = built
    if src_pad_h:
        src = pad_rows(src, src_pad_h, fill_value)
    return step_fn(src)


# ---------------------------------------------------------------------------
# the sharded rectify: Phase A banded over the mesh, Phase B through K7's
# band form
# ---------------------------------------------------------------------------


def _map_rows(ij_map):
    """The map's row reader, height and width: ``rows(lo, hi)`` gives the
    (2, r, W) pieces of global rows [lo, hi) where they lie (one piece of a
    numpy array, a tensor or a :class:`~..ops.rectify_ops.DeviceIJMap`'s
    map; one or two bands of a :class:`.tiling.Sharded` map)."""
    if isinstance(ij_map, DeviceIJMap):
        ij_map = ij_map.device_map()
    if isinstance(ij_map, Sharded):
        bands = ij_map.bands
        band = bands[0].shape[-2]

        def rows(lo, hi):
            return [
                bands[j][:, max(lo, j * band) - j * band : min(hi, (j + 1) * band) - j * band]
                for j in range(lo // band, -(-hi // band))
            ]

        return rows, ij_map.out_h, bands[0].shape[-1]
    if not isinstance(ij_map, torch.Tensor):
        ij_map = torch.from_numpy(np.ascontiguousarray(ij_map))
    return (lambda lo, hi: [ij_map[:, lo:hi]]), ij_map.shape[-2], ij_map.shape[-1]


class ShardedRectifyStep(_BandGatherStep):
    """``step(src) -> Sharded``: K7's band form on each band after the
    halo exchange (:class:`_BandGatherStep`), through the float32 map rows
    of the band's target rows (*maps*, (2, out_band_h, out_w) on the
    band's device)."""

    _kernels = (ij_gather_band, ij_gather_band_plain)

    def __init__(self, devices, maps, halo, band_h, src_h, src_w, out_h, interp_method,
                 fill_value, src_batch_dims):
        super().__init__(devices, halo, band_h, out_h, interp_method, fill_value,
                         src_batch_dims)
        self.maps = maps
        self.src_h, self.src_w = src_h, src_w

    def gather_args(self, bands, halos, k):
        """K7's band-form arguments for band *k* of *bands*: its extension
        by its halo from :meth:`exchange` first."""
        ext, off = self.extension(bands, halos, k)
        if ext.shape[-1] != self.src_w:
            raise ValueError(f"source of width {ext.shape[-1]}, the map's source has {self.src_w}")
        return ext, self.maps[k], self.interp_method, self.fill_value, off, self.src_h


def make_sharded_rectify_step(
    mesh,
    ij_map,
    src_shape: tuple[int, int],
    axis_name: str = "bands",
    interp_method: str = "nearest",
    fill_value: float = np.nan,
    src_batch_dims: int = 0,
):
    """The sharded rectify Phase B over ``mesh[axis_name]``
    (``halo.py:make_sharded_rectify_step``): the source in proportional row
    bands, each extended by a halo sized from the map, then K7's band form
    through the map's rows of the band's target rows.

    *ij_map* (2, out_h, out_w), the Phase A map in global source indices:
    a numpy array, a tensor, a :class:`~..ops.rectify_ops.DeviceIJMap` or
    a :class:`.tiling.Sharded` (:func:`sharded_phase_a`'s).  Each band's
    rows go to its device as float32 (peer copies of the bands they lie in,
    never through the host); the halo is the largest distance of a band's
    source rows (nanmin, nanmax + 1 of the map's j on the band's rows,
    reduced where the rows lie, 2n values fetched) from its proportional
    source band, plus one row.  Returns ``(step_fn, (src_pad_h, out_h))``;
    ``step_fn(src)`` takes the source padded by ``src_pad_h`` rows
    and returns a :class:`.tiling.Sharded` of ``out_h`` target rows."""
    devices = _axis_devices(mesh, axis_name)
    n = len(devices)
    src_h, src_w = src_shape
    rows, out_h, out_w = _map_rows(ij_map)
    band_h = -(-src_h // n)
    out_band_h = -(-out_h // n)
    src_pad_h = band_h * n - src_h

    inf = float("inf")
    maps, ends = [], []
    for k, dev in enumerate(devices):
        pieces = [p for p in rows(k * out_band_h, min((k + 1) * out_band_h, out_h)) if p.shape[1]]
        for p in pieces:
            nan = torch.isnan(p[1])
            ends.append((k, torch.where(nan, inf, p[1]).amin().to(devices[0]),
                         torch.where(nan, -inf, p[1]).amax().to(devices[0])))
        m = torch.full((2, out_band_h, out_w), np.nan, dtype=_F32, device=dev)
        r = 0
        for p in pieces:
            m[:, r : r + p.shape[1]].copy_(p.to(_F32), non_blocking=True)
            r += p.shape[1]
        maps.append(m)
    lo_hi = torch.stack([torch.stack([lo, hi]) for _, lo, hi in ends]).cpu().tolist() if ends else []
    band_lo: dict[int, float] = {}
    band_hi: dict[int, float] = {}
    for (k, _, _), (lo, hi) in zip(ends, lo_hi):
        band_lo[k] = min(band_lo.get(k, inf), lo)
        band_hi[k] = max(band_hi.get(k, -inf), hi)
    need = 0.0
    for k, lo in band_lo.items():
        if not np.isfinite(lo):
            continue
        hi = band_hi[k] + 1.0
        need = max(need, k * band_h - lo, hi - (k * band_h + band_h - 1))
    halo = min(int(np.ceil(max(0.0, need))) + 1, (n - 1) * band_h)
    step_fn = ShardedRectifyStep(devices, maps, halo, band_h, src_h, src_w, out_h,
                                 interp_method, fill_value, src_batch_dims)
    return step_fn, (src_pad_h, out_h)


def sharded_phase_a(
    mesh,
    source_gm: GridMapping,
    target_gm: GridMapping,
    axis_name: str = "bands",
    uv_delta: float | None = None,
    tile: int = 16,
    margin: int = 2,
) -> Sharded | None:
    """Rectify Phase A banded over ``mesh[axis_name]``
    (``halo.py:sharded_phase_a``): band ``k`` is the target rows from
    ``k * band`` (``band``: the rows a band takes, rounded up to *tile*),
    whose map is the whole target's with the row origin at ``r0 = k *
    band``: K11 and K12 on the swath's normalised coordinates with ``gy -
    r0``.  The coordinates are normalised on the first device and copied to
    each other distinct device once.  K11 runs on
    every band and the (n, 3) metas come back in one fetch; one window
    bucket (from the bands' largest needs, the single chip's) serves
    every band's K12.  Returns the (2, dst_h, dst_w) float64 map as a
    :class:`.tiling.Sharded` of (2, band, dst_w) bands, or None where the
    geometry is outside the hybrid's envelope."""
    if uv_delta is None:
        uv_delta = UV_DELTA
    devices = _axis_devices(mesh, axis_name)
    n = len(devices)
    dst_h, dst_w = target_gm.height, target_gm.width
    src_h, src_w = source_gm.height, source_gm.width
    if src_h < 2 or src_w < 2 or dst_h < 4 * n or dst_w < 4:
        return None
    band = -(-(-(-dst_h // n)) // tile) * tile
    x1, y1, x2, y2 = target_gm.xy_bbox
    x_res, y_res = target_gm.xy_res
    j_up = target_gm.is_j_axis_up
    # normalised on the first device, then copied device to device
    sw = torch.from_numpy(
        np.ascontiguousarray(np.asarray(source_gm.xy_coords.data), dtype=np.float64)
    ).to(devices[0])
    first = ((sw[0] - x1) / x_res, (sw[1] - (y1 if j_up else y2)) / (y_res if j_up else -y_res))
    del sw
    coords = {dev: tuple(c.to(dev) for c in first) for dev in dict.fromkeys(devices)}
    max_edge = float(max(dst_h, dst_w))
    seeds = [
        hybrid_seed(*coords[dev], (band, dst_w), tile, max_edge, margin, r0=float(k * band))
        for k, dev in enumerate(devices)
    ]
    metas = torch.stack([meta.to(devices[0]) for _, _, meta in seeds]).cpu()
    if not bool(metas[:, 0].all()):
        return None
    win_j = hybrid_window(int(metas[:, 1].max()), src_h)
    win_i = hybrid_window(int(metas[:, 2].max()), src_w)
    if win_j is None or win_i is None:
        return None
    return Sharded([
        hybrid_dense(*coords[dev], cqj, cqi, (band, dst_w), uv_delta, tile, win_j, win_i,
                     margin, r0=float(k * band))
        for k, (dev, (cqj, cqi, _)) in enumerate(zip(devices, seeds))
    ], dst_h)


def sharded_rectify(
    src,
    source_gm: GridMapping,
    target_gm: GridMapping,
    mesh,
    axis_name: str = "bands",
    interp_method: str = "nearest",
    fill_value: float = np.nan,
    ij_map=None,
) -> Sharded:
    """Rectify the band stack *src* (…, H, W) of an irregular swath, of any
    data dtype, onto *target_gm* over ``mesh[axis_name]``
    (``halo.py:sharded_rectify``):
    Phase A by :func:`sharded_phase_a` unless *ij_map* is given, or where
    the hybrid's envelope refuses the geometry the port's single-device
    Phase A on the mesh's first device (``rectify._inverse_ij_map``: on a
    CUDA device JAX's ladder, the walk or the tiled stencil, else K10 and
    K8; on the CPU the host tier's K8);
    then Phase B through :func:`make_sharded_rectify_step`.  Returns the
    target raster as a :class:`.tiling.Sharded`."""
    if ij_map is None:
        ij_map = sharded_phase_a(mesh, source_gm, target_gm, axis_name)
    if ij_map is None:
        from ..rectify import _inverse_ij_map

        ij_map = _inverse_ij_map(source_gm, target_gm, UV_DELTA, mesh.devices[0])
    step_fn, (src_pad_h, _) = make_sharded_rectify_step(
        mesh,
        ij_map,
        (source_gm.height, source_gm.width),
        axis_name=axis_name,
        interp_method=interp_method,
        fill_value=fill_value,
        src_batch_dims=src.ndim - 2,
    )
    if src_pad_h:
        src = pad_rows(src, src_pad_h, fill_value)
    return step_fn(src)
