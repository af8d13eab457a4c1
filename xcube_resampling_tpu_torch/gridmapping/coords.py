"""Grid mappings from coordinate variables + CF coordinate generation.

Semantics track reference ``gridmapping/coords.py:49-472`` (see NOTICE):
regularity is detected by comparing coordinate diffs against a tolerance,
geographic x-coordinates that cross the antimeridian are normalized to the
lon-360 convention, irregular 2D swaths get an area-based resolution
estimate (``0.7*min + 0.3*max`` cell-edge heuristic, coords.py:226-264),
the j-axis orientation is read off the y-coordinate ordering, and
:func:`grid_mapping_to_coords` emits CF-compliant axis + cell-bounds
variables for regular mappings.

The implementation is organized around a :class:`_CoordsProfile` record
filled by dimension-specific analyzers (:func:`_profile_1d`,
:func:`_profile_2d`) instead of the reference's single long function, and
the CF variable generation walks a per-axis descriptor table.
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass

import numpy as np

from ..constants import FloatInt
from ..crs import CRS
from ..xrlite import DataArray
from .assertions import assert_instance, assert_true
from .base import DEFAULT_TOLERANCE, GridMapping
from .helpers import (
    _assert_valid_xy_names,
    _default_xy_var_names,
    _normalize_crs,
    _normalize_int_pair,
    _normalize_number_pair,
    _to_int_or_float,
    from_lon_360,
    round_to_fraction,
    to_lon_360,
)

#: Mean Earth radius [m] used to convert degrees to meters in the
#: resolution estimation heuristic (reference coords.py:46)
_ER = 6371000

#: |x| <= atol is np.isclose(x, 0)'s default criterion
_ZERO_ATOL = 1.0e-8


class CoordsGridMapping(GridMapping, abc.ABC):
    """Grid mapping constructed from 1D/2D coordinate variables and a CRS."""

    @property
    def x_coords(self):
        assert isinstance(self._x_coords, DataArray)
        return self._x_coords

    @property
    def y_coords(self):
        assert isinstance(self._y_coords, DataArray)
        return self._y_coords

    def _new_x_coords(self) -> DataArray:
        # Should never come here
        return self._x_coords

    def _new_y_coords(self) -> DataArray:
        # Should never come here
        return self._y_coords

    def _stacked_xy(self, x2: np.ndarray, y2: np.ndarray, dims) -> DataArray:
        xy = DataArray(np.stack([x2, y2]), dims=("coord",) + tuple(dims),
                       name="xy_coords")
        chunking = dict(zip(xy.dims, self.xy_coords_chunks))
        return xy.chunk(chunking)


class Coords1DGridMapping(CoordsGridMapping):
    """Grid mapping constructed from 1D coordinate variables and a CRS."""

    def _new_xy_coords(self) -> DataArray:
        x = np.asarray(self._x_coords.data)
        y = np.asarray(self._y_coords.data)
        y2, x2 = np.broadcast_arrays(y[:, np.newaxis], x[np.newaxis, :])
        dims = (self._y_coords.dims[0], self._x_coords.dims[0])
        return self._stacked_xy(x2, y2, dims)


class Coords2DGridMapping(CoordsGridMapping):
    """Grid mapping constructed from 2D coordinate variables and a CRS."""

    def _new_xy_coords(self) -> DataArray:
        return self._stacked_xy(
            np.asarray(self._x_coords.data),
            np.asarray(self._y_coords.data),
            self._x_coords.dims,
        )


def _diffs_dropping_zeros(values: np.ndarray) -> np.ndarray:
    """|diff| with near-zero steps masked to NaN (reference's duplicate-
    coordinate guard)."""
    steps = np.fabs(np.diff(np.asarray(values)))
    return np.where(steps <= _ZERO_ATOL, np.nan, steps)


def _magnitude_or_zero(deltas) -> np.ndarray:
    """|deltas| with NaNs and near-zeros flattened to 0 (swath edges)."""
    mags = np.fabs(np.asarray(deltas))
    bad = np.logical_or(np.isnan(mags), mags <= _ZERO_ATOL)
    return np.where(bad, 0, mags)


@dataclass
class _CoordsProfile:
    """Everything :func:`new_grid_mapping_from_coords` needs to build the
    mapping, as produced by the 1D/2D analyzers."""

    cls: type
    x_coords: DataArray
    y_coords: DataArray
    size: tuple[int, int]
    dim_names: tuple[str, str]  # (x, y)
    xy_res: tuple[float, float]
    tile_size: tuple[int, int] | None
    is_regular: bool | None
    is_lon_360: bool | None
    is_j_axis_up: bool


def _profile_1d(
    x_coords: DataArray,
    y_coords: DataArray,
    crs: CRS,
    xy_res,
    tile_size,
    tolerance: float,
    is_lon_360: bool | None,
) -> _CoordsProfile:
    assert_true(
        x_coords.size >= 2 and y_coords.size >= 2,
        "sizes of x_coords and y_coords 1D arrays must be >= 2",
    )

    x_steps = _diffs_dropping_zeros(x_coords.data)
    y_steps = _diffs_dropping_zeros(y_coords.data)

    # A >180-degree jump in ascending longitudes means the sequence wraps
    # the antimeridian: renormalize to [0, 360) so it is monotone again.
    if crs.is_geographic and not is_lon_360 and np.any(np.nanmax(x_steps) > 180):
        x_coords = DataArray(
            to_lon_360(x_coords), dims=x_coords.dims, name=x_coords.name
        )
        x_steps = _diffs_dropping_zeros(x_coords.data)
        is_lon_360 = True

    if xy_res is not None:
        res = _normalize_number_pair(xy_res)
        is_regular = True
    else:
        res = float(x_steps[0]), float(y_steps[0])
        is_regular = bool(
            np.allclose(x_steps, res[0], atol=tolerance)
            and np.allclose(y_steps, res[1], atol=tolerance)
        )
        if is_regular:
            res = tuple(round_to_fraction(r, 5, 0.25) for r in res)
        else:
            res = tuple(
                round_to_fraction(float(np.nanmedian(s, axis=0)), 2, 0.5)
                for s in (x_steps, y_steps)
            )

    if tile_size is None and x_coords.chunks is not None and y_coords.chunks is not None:
        tile_size = (max(0, *x_coords.chunks[0]), max(0, *y_coords.chunks[0]))

    y_values = np.asarray(y_coords.data)
    return _CoordsProfile(
        cls=Coords1DGridMapping,
        x_coords=x_coords,
        y_coords=y_coords,
        size=(x_coords.size, y_coords.size),
        dim_names=(str(x_coords.dims[0]), str(y_coords.dims[0])),
        xy_res=res,
        tile_size=tile_size,
        is_regular=is_regular,
        is_lon_360=is_lon_360,
        is_j_axis_up=bool(y_values[0] < y_values[-1]),
    )


def _swath_res_estimate(x: np.ndarray, y: np.ndarray, geographic: bool) -> float:
    """Area-based resolution estimate for an irregular 2D swath
    (reference coords.py:226-264): per-pixel cell area from the local x/y
    gradients, min/max areas blended 0.7/0.3 as edge lengths, rounded to
    one significant digit.

    The estimate is rounded to 1 significant digit, so float32 is ample;
    above ~0.25 Mpix the scan samples a strided grid of ADJACENT pixel
    pairs (local diffs are preserved exactly; only the min/max search is
    subsampled, far inside the rounding granularity of the estimate).
    """
    height, width = x.shape
    stride = max(1, round(math.sqrt(height * width / 262144.0)))
    x32, y32 = x.astype(np.float32), y.astype(np.float32)

    if stride > 1:
        ii = np.arange(0, height - 1, stride)
        jj = np.arange(0, width - 1, stride)
        base = np.ix_(ii, jj)
        right = np.ix_(ii, jj + 1)
        below = np.ix_(ii + 1, jj)
        dx_i = _magnitude_or_zero(x32[right] - x32[base])
        dx_j = _magnitude_or_zero(x32[below] - x32[base])
        dy_i = _magnitude_or_zero(y32[right] - y32[base])
        dy_j = _magnitude_or_zero(y32[below] - y32[base])
    else:
        # Pad the trailing row/column so the diff grids keep the original
        # shape (the reference doubles the last rows/cols).
        def _pad_last(arr: np.ndarray, axis: int) -> np.ndarray:
            tail = arr[:, -1:] if axis == 1 else arr[-1:, :]
            return np.concatenate([arr, tail], axis=axis)

        dx_i = _pad_last(_magnitude_or_zero(np.diff(x32, axis=1)), 1)
        dy_i = _pad_last(_magnitude_or_zero(np.diff(y32, axis=1)), 1)
        dx_j = _pad_last(_magnitude_or_zero(np.diff(x32, axis=0)), 0)
        dy_j = _pad_last(_magnitude_or_zero(np.diff(y32, axis=0)), 0)

    x_extent = np.sqrt(np.square(dx_i) + np.square(dx_j))
    y_extent = np.sqrt(np.square(dy_i) + np.square(dy_j))
    if geographic:
        # Degrees -> meters on the mean-radius sphere
        x_rad, y_rad = np.radians(x_extent), np.radians(y_extent)
        x_extent = _ER * np.cos(x_rad) * y_rad
        y_extent = _ER * y_rad

    areas = (x_extent * y_extent).flatten()
    areas = np.where(areas > 0, areas, np.nan)
    edge_min = math.sqrt(areas[np.nanargmin(areas)])
    edge_max = math.sqrt(areas[np.nanargmax(areas)])
    # Empirically weight min more than max
    estimate = 0.7 * edge_min + 0.3 * edge_max
    if geographic:
        estimate = math.degrees(estimate / _ER)
    # Because this is an estimation, round to a nice number
    return round_to_fraction(estimate, digits=1, resolution=0.5)


def _profile_2d(
    x_coords: DataArray,
    y_coords: DataArray,
    crs: CRS,
    xy_res,
    tile_size,
    tolerance: float,
    is_lon_360: bool | None,
) -> _CoordsProfile:
    assert_true(
        x_coords.shape == y_coords.shape,
        "shapes of x_coords and y_coords 2D arrays must be equal",
    )
    assert_true(
        x_coords.dims == y_coords.dims,
        "dimensions of x_coords and y_coords 2D arrays must be equal",
    )

    height, width = x_coords.shape
    x = np.asarray(x_coords.data)
    y = np.asarray(y_coords.data)

    # Regularity probes run on first-chunk extents only (the full array
    # when unchunked); the row-0/col-0 slice lengths below — including the
    # swapped ch/cw pair on the y probes — mirror the reference verbatim.
    if x_coords.chunks is not None:
        ch, cw = x_coords.chunks[0][0], x_coords.chunks[1][0]
    else:
        ch, cw = height, width

    x_along_i = _magnitude_or_zero(np.diff(x[0, :cw]))
    x_along_j = _magnitude_or_zero(np.diff(x[:ch, 0]))
    y_along_i = _magnitude_or_zero(np.diff(y[0, :ch]))
    y_along_j = _magnitude_or_zero(np.diff(y[:cw, 0]))

    if crs.is_geographic and not is_lon_360:
        wraps = np.any(np.max(x_along_i) > 180) or np.any(np.max(x_along_j) > 180)
        if wraps:
            x_coords = DataArray(
                to_lon_360(x_coords), dims=x_coords.dims, name=x_coords.name
            )
            x = np.asarray(x_coords.data)
            x_along_i = _magnitude_or_zero(np.diff(x[0, :]))
            x_along_j = _magnitude_or_zero(np.diff(x[:, 0]))
            is_lon_360 = True

    if xy_res is not None:
        res = _normalize_number_pair(xy_res)
    else:
        res = float(x_along_i[0]), float(y_along_j[0])

    is_regular = bool(
        np.allclose(x_along_i, res[0], atol=tolerance)
        and np.allclose(y_along_j, res[1], atol=tolerance)
        and np.allclose(x_along_j, 0, atol=tolerance)
        and np.allclose(y_along_i, 0, atol=tolerance)
    )

    if not is_regular and xy_res is None:
        est = _swath_res_estimate(x, y, crs.is_geographic)
        res = float(est), float(est)

    if tile_size is None and x_coords.chunks is not None:
        j_chunks, i_chunks = x_coords.chunks
        tile_size = max(0, *i_chunks), max(0, *j_chunks)

    if tile_size is not None:
        tile_w, tile_h = tile_size
        spatial = {x_coords.dims[0]: tile_h, x_coords.dims[1]: tile_w}
        x_coords = x_coords.chunk(spatial)
        y_coords = y_coords.chunk(spatial)

    probe_w = y_coords.chunks[1][0] if y_coords.chunks is not None else width
    y_now = np.asarray(y_coords.data)
    is_j_axis_up = bool(np.all(y_now[0, :probe_w] < y_now[-1, :probe_w]))

    y_dim, x_dim = x_coords.dims
    return _CoordsProfile(
        cls=Coords2DGridMapping,
        x_coords=x_coords,
        y_coords=y_coords,
        size=(width, height),
        dim_names=(str(x_dim), str(y_dim)),
        xy_res=res,
        tile_size=tile_size,
        is_regular=is_regular,
        is_lon_360=is_lon_360,
        is_j_axis_up=is_j_axis_up,
    )


def _default_bbox(profile: _CoordsProfile) -> tuple:
    """Pixel-edge bbox from the coordinate centers +- res/2.

    2D coordinate images get a NaN-skipping full-image scan: real swaths
    (OLCI/SLSTR L2) routinely carry non-finite edge pixels, and strongly
    bowed swaths place the coordinate extremes mid-edge of interior
    rows/columns — an edge-only scan under-covers both.  The reference
    survives NaN edges because its reductions are xarray ``skipna`` /
    NaN-false comparisons (reference gridmapping/bboxes.py:143-166,
    coords.py:297-307); a full scan additionally guarantees
    ``bbox ⊇ hull(finite coords)``.
    """
    (x_res, y_res) = profile.xy_res
    x_data = np.asarray(profile.x_coords.data)
    y_data = np.asarray(profile.y_coords.data)
    with np.errstate(all="ignore"):
        if x_data.ndim == 2:
            x_lo_c, x_hi_c = np.nanmin(x_data), np.nanmax(x_data)
            y_lo_c, y_hi_c = np.nanmin(y_data), np.nanmax(y_data)
        else:
            x_lo_c, x_hi_c = np.nanmin(x_data[..., 0]), np.nanmax(x_data[..., -1])
            first, last = y_data[0, ...], y_data[-1, ...]
            lo_edge, hi_edge = (
                (first, last) if profile.is_j_axis_up else (last, first)
            )
            y_lo_c, y_hi_c = np.nanmin(lo_edge), np.nanmax(hi_edge)
    if not (np.isfinite(x_lo_c) and np.isfinite(y_lo_c)):
        raise ValueError(
            "cannot determine xy_bbox: x_coords/y_coords contain no"
            " finite values"
        )
    x_lo = _to_int_or_float(float(x_lo_c) - x_res / 2)
    x_hi = _to_int_or_float(float(x_hi_c) + x_res / 2)
    y_lo = _to_int_or_float(float(y_lo_c) - y_res / 2)
    y_hi = _to_int_or_float(float(y_hi_c) + y_res / 2)
    return (x_lo, y_lo, x_hi, y_hi)


def new_grid_mapping_from_coords(
    x_coords: DataArray,
    y_coords: DataArray,
    crs: str | CRS,
    *,
    xy_res: FloatInt | tuple[FloatInt, FloatInt] = None,
    xy_bbox: tuple[FloatInt, FloatInt, FloatInt, FloatInt] = None,
    tile_size: int | tuple[int, int] = None,
    tolerance: float = DEFAULT_TOLERANCE,
) -> GridMapping:
    crs = _normalize_crs(crs)
    assert_instance(x_coords, DataArray, name="x_coords")
    assert_instance(y_coords, DataArray, name="y_coords")
    assert_true(
        x_coords.ndim in (1, 2), "x_coords and y_coords must be either 1D or 2D arrays"
    )
    assert_instance(tolerance, float, name="tolerance")
    assert_true(tolerance > 0.0, "tolerance must be greater zero")

    if x_coords.name and y_coords.name:
        xy_var_names = str(x_coords.name), str(y_coords.name)
    else:
        xy_var_names = _default_xy_var_names(crs)

    tile_size = _normalize_int_pair(tile_size, default=None)
    is_lon_360 = None  # None means "not yet known"
    if crs.is_geographic:
        is_lon_360 = bool(np.any(np.asarray(x_coords.data) > 180))

    analyze = _profile_1d if x_coords.ndim == 1 else _profile_2d
    profile = analyze(
        x_coords, y_coords, crs, xy_res, tile_size, tolerance, is_lon_360
    )

    x_res, y_res = profile.xy_res
    assert_true(
        x_res > 0 and y_res > 0,
        "internal error: x_res and y_res could not be determined",
        exception_type=RuntimeError,
    )
    profile.xy_res = _to_int_or_float(x_res), _to_int_or_float(y_res)

    if xy_bbox is None:
        xy_bbox = _default_bbox(profile)

    cls = profile.cls
    if cls is Coords1DGridMapping and profile.is_regular:
        from .regular import RegularGridMapping

        cls = RegularGridMapping

    return cls(
        x_coords=profile.x_coords,
        y_coords=profile.y_coords,
        crs=crs,
        size=profile.size,
        tile_size=profile.tile_size,
        xy_bbox=xy_bbox,
        xy_res=profile.xy_res,
        xy_var_names=xy_var_names,
        xy_dim_names=profile.dim_names,
        is_regular=profile.is_regular,
        is_lon_360=profile.is_lon_360,
        is_j_axis_up=profile.is_j_axis_up,
    )


# --- CF coordinate/bounds generation ---------------------------------------

_GEOGRAPHIC_ATTRS = (
    dict(
        long_name="longitude coordinate",
        standard_name="longitude",
        units="degrees_east",
    ),
    dict(
        long_name="latitude coordinate",
        standard_name="latitude",
        units="degrees_north",
    ),
)

_PROJECTED_ATTRS = (
    dict(
        long_name="x coordinate of projection",
        standard_name="projection_x_coordinate",
    ),
    dict(
        long_name="y coordinate of projection",
        standard_name="projection_y_coordinate",
    ),
)


@dataclass
class _AxisSpec:
    """One spatial axis of a regular grid: everything needed to lay out
    its center and bounds coordinates."""

    var_name: str
    dim_name: str
    count: int
    lo: float  # bbox edge at index 0's side (pre-flip)
    hi: float
    res: float
    attrs: dict
    descending: bool  # j-axis-down y
    wrap_lon: bool  # map [0,360) back to [-180,180)

    def _line(self, start: float, stop: float) -> np.ndarray:
        values = np.linspace(start, stop, self.count, dtype=np.float64)
        if self.wrap_lon:
            values = from_lon_360(values)
        return values

    def centers(self) -> np.ndarray:
        half = self.res / 2
        if self.descending:
            return self._line(self.hi - half, self.lo + half)
        return self._line(self.lo + half, self.hi - half)

    def bounds(self) -> np.ndarray:
        if self.descending:
            lower = self._line(self.hi, self.lo + self.res)
            upper = self._line(self.hi - self.res, self.lo)
        else:
            lower = self._line(self.lo, self.hi - self.res)
            upper = self._line(self.lo + self.res, self.hi)
        return np.stack([lower, upper], axis=-1)


def grid_mapping_to_coords(
    grid_mapping: GridMapping,
    xy_var_names: tuple[str, str] = None,
    xy_dim_names: tuple[str, str] = None,
    reuse_coords: bool = False,
    exclude_bounds: bool = False,
) -> dict[str, DataArray]:
    """Get CF-compliant axis coordinate variables and cell boundary
    coordinate variables for a regular grid mapping
    (reference coords.py:340-472)."""

    if xy_var_names:
        _assert_valid_xy_names(xy_var_names, name="xy_var_names")
    if xy_dim_names:
        _assert_valid_xy_names(xy_dim_names, name="xy_dim_names")

    if reuse_coords:
        reused = _reused_1d_coords(grid_mapping, xy_var_names, xy_dim_names)
        if reused is not None:
            return reused

    names = xy_var_names or grid_mapping.xy_var_names
    dims = xy_dim_names or grid_mapping.xy_dim_names
    x1, y1, x2, y2 = grid_mapping.xy_bbox
    attrs_pair = (
        _GEOGRAPHIC_ATTRS if grid_mapping.crs.is_geographic else _PROJECTED_ATTRS
    )

    axes = (
        _AxisSpec(
            var_name=names[0],
            dim_name=dims[0],
            count=grid_mapping.width,
            lo=x1,
            hi=x2,
            res=grid_mapping.xy_res[0],
            attrs=dict(attrs_pair[0]),
            descending=False,
            wrap_lon=bool(grid_mapping.is_lon_360),
        ),
        _AxisSpec(
            var_name=names[1],
            dim_name=dims[1],
            count=grid_mapping.height,
            lo=y1,
            hi=y2,
            res=grid_mapping.xy_res[1],
            attrs=dict(attrs_pair[1]),
            descending=not grid_mapping.is_j_axis_up,
            wrap_lon=False,
        ),
    )

    coords: dict[str, DataArray] = {}
    bounds: dict[str, DataArray] = {}
    for axis in axes:
        center_var = DataArray(axis.centers(), dims=axis.dim_name, attrs=axis.attrs)
        coords[axis.var_name] = center_var
        if not exclude_bounds:
            # Per CF, bounds variables need no attributes of their own.
            bnds_name = f"{axis.var_name}_bnds"
            bounds[bnds_name] = DataArray(
                axis.bounds(), dims=(axis.dim_name, "bnds")
            )
            center_var.attrs.update(bounds=bnds_name)
    coords.update(bounds)
    return coords


def _reused_1d_coords(
    grid_mapping: GridMapping,
    xy_var_names: tuple[str, str],
    xy_dim_names: tuple[str, str],
) -> dict[str, DataArray] | None:
    """Hand back the mapping's own 1D coordinates when they already have
    the requested shape (reference coords.py:365-383)."""
    try:
        x, y = grid_mapping.x_coords, grid_mapping.y_coords
    except AttributeError:
        return None
    ok = (
        isinstance(x, DataArray)
        and isinstance(y, DataArray)
        and x.ndim == 1
        and y.ndim == 1
        and x.size == grid_mapping.width
        and y.size == grid_mapping.height
    )
    if not ok:
        return None
    return {
        name: DataArray(coord.values, dims=dim, attrs=coord.attrs)
        for name, dim, coord in zip(xy_var_names, xy_dim_names, (x, y))
    }
