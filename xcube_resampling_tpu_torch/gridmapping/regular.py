"""Regular grid mappings.

Behavioral parity: reference gridmapping/regular.py:38-166.  Coordinate
arrays are eager numpy linspaces carried as xrlite DataArrays with chunk
metadata derived from the tile size (the reference's dask-linspace
becomes a plain array; tiling happens in the executor, not the array
layer).
"""

from __future__ import annotations

import numpy as np

from ..crs import CRS
from ..xrlite import DataArray
from .assertions import assert_true
from .base import GridMapping
from .helpers import (
    _default_xy_dim_names,
    _default_xy_var_names,
    _normalize_crs,
    _normalize_int_pair,
    _normalize_number_pair,
    _to_int_or_float,
)


def _even_chunks(size: int, chunk: int) -> tuple[int, ...]:
    full, rest = divmod(size, chunk)
    return (chunk,) * full + ((rest,) if rest else ())


class RegularGridMapping(GridMapping):
    """A grid mapping whose cells are an axis-aligned uniform lattice;
    1D/2D coordinate arrays are synthesized on demand from the bbox."""

    def __init__(self, **kwargs):
        kwargs.pop("is_regular", None)
        super().__init__(is_regular=True, **kwargs)
        self._xy_coords = None

    def _axis(self, *, lo, hi, res, n, dim, tile, descending=False) -> DataArray:
        """Cell-center linspace along one axis with tile-chunk metadata."""
        first, last = lo + res / 2, hi - res / 2
        if descending:
            first, last = last, first
        return DataArray(
            np.linspace(first, last, n),
            dims=dim,
            chunks=(_even_chunks(n, tile),),
        )

    def _new_x_coords(self) -> DataArray:
        self._assert_regular()
        return self._axis(
            lo=self.x_min,
            hi=self.x_max,
            res=self.x_res,
            n=self.width,
            dim=self.xy_dim_names[0],
            tile=self.tile_width,
        )

    def _new_y_coords(self) -> DataArray:
        self._assert_regular()
        return self._axis(
            lo=self.y_min,
            hi=self.y_max,
            res=self.y_res,
            n=self.height,
            dim=self.xy_dim_names[1],
            tile=self.tile_height,
            descending=not self.is_j_axis_up,
        )

    def _new_xy_coords(self) -> DataArray:
        self._assert_regular()
        y2, x2 = np.broadcast_arrays(
            np.asarray(self.y_coords.data)[:, None],
            np.asarray(self.x_coords.data)[None, :],
        )
        da = DataArray(
            np.stack([x2, y2]),
            dims=("coord", self.y_coords.dims[0], self.x_coords.dims[0]),
            name="xy_coords",
        )
        return da.chunk(dict(zip(da.dims, self.xy_coords_chunks)))


def new_regular_grid_mapping(
    size: int | tuple[int, int],
    xy_min: tuple[float, float],
    xy_res: float | tuple[float, float],
    crs: str | CRS,
    *,
    tile_size: int | tuple[int, int] = None,
    is_j_axis_up: bool = False,
) -> GridMapping:
    w, h = _normalize_int_pair(size, name="size")
    assert_true(w > 1 and h > 1, "invalid size")
    rx, ry = _normalize_number_pair(xy_res, name="xy_res")
    assert_true(rx > 0 and ry > 0, "invalid xy_res")
    crs = _normalize_crs(crs)

    x0, y0 = _normalize_number_pair(xy_min, name="xy_min")
    bbox = tuple(
        _to_int_or_float(v) for v in (x0, y0, x0 + rx * w, y0 + ry * h)
    )

    if crs.is_geographic:
        # latitude must stay on the sphere
        if bbox[1] < -90:
            raise ValueError("invalid y_min")
        if bbox[3] > 90:
            raise ValueError("invalid size, y_min combination")

    return RegularGridMapping(
        crs=crs,
        size=(w, h),
        tile_size=tile_size or (w, h),
        xy_bbox=bbox,
        xy_res=(rx, ry),
        xy_var_names=_default_xy_var_names(crs),
        xy_dim_names=_default_xy_dim_names(crs),
        is_lon_360=crs.is_geographic and bbox[2] > 180,
        is_j_axis_up=is_j_axis_up,
    )


def to_regular_grid_mapping(
    grid_mapping: GridMapping,
    *,
    tile_size: int | tuple[int, int] = None,
    is_j_axis_up: bool = False,
) -> GridMapping:
    """Regular cover of an irregular grid mapping: square pixels at the
    finer of the two estimated resolutions, sized to span the bbox plus
    one pixel (reference regular.py:132-166)."""
    if grid_mapping.is_regular:
        if tile_size is None and is_j_axis_up == grid_mapping.is_j_axis_up:
            return grid_mapping
        return grid_mapping.derive(tile_size=tile_size, is_j_axis_up=is_j_axis_up)

    x_min, y_min, x_max, y_max = grid_mapping.xy_bbox
    res = min(*grid_mapping.xy_res) or max(*grid_mapping.xy_res)
    size = tuple(
        max(2, round((span + res) / res))
        for span in (x_max - x_min, y_max - y_min)
    )

    return new_regular_grid_mapping(
        size=size,
        xy_min=(x_min, y_min),
        xy_res=res,
        crs=grid_mapping.crs,
        tile_size=grid_mapping.tile_size if tile_size is None else tile_size,
        is_j_axis_up=is_j_axis_up,
    )
