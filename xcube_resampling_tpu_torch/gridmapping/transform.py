"""Whole-grid-mapping CRS transformation.

Behavioral parity: reference gridmapping/transform.py:57-125.  The
reference pushes the (2, H, W) coordinate image through pyproj inside a
dask ``apply_ufunc``; here the native :class:`~..crs.Transformer` runs
the float64 math directly on host, and the result is classified by
the coords factory into a 2D-coords irregular grid mapping.
"""

from __future__ import annotations

import numpy as np

from ..constants import FloatInt
from ..crs import CRS, Transformer
from ..xrlite import DataArray
from .base import DEFAULT_TOLERANCE, GridMapping
from .coords import new_grid_mapping_from_coords
from .helpers import (
    _assert_valid_xy_names,
    _normalize_crs,
    _normalize_number_pair,
)


def _padded_target_bbox(gm: GridMapping, tf: Transformer, xy_res) -> tuple:
    """Target-CRS bbox of *gm*, grown by half a target pixel on each side
    so the regularized grid covers the source footprint entirely."""
    rx, ry = _normalize_number_pair(xy_res)
    x0, y0, x1, y1 = tf.transform_bounds(*gm.xy_bbox, densify_pts=101)
    return (x0 - rx / 2, y0 - ry / 2, x1 + rx / 2, y1 + ry / 2)


def transform_grid_mapping(
    grid_mapping: GridMapping,
    crs: str | CRS,
    *,
    xy_res: FloatInt | tuple[FloatInt, FloatInt] = None,
    tile_size: int | tuple[int, int] = None,
    xy_var_names: tuple[str, str] = None,
    tolerance: float = DEFAULT_TOLERANCE,
) -> GridMapping:
    if xy_var_names:
        _assert_valid_xy_names(xy_var_names, name="xy_var_names")
    target_crs = _normalize_crs(crs)

    # no CRS change: at most re-derive with new tiling / names
    if grid_mapping.crs == target_crs:
        if tile_size is None and xy_var_names is None:
            return grid_mapping
        return grid_mapping.derive(tile_size=tile_size, xy_var_names=xy_var_names)

    tf = Transformer.from_crs(grid_mapping.crs, target_crs, always_xy=True)
    src_xy = np.asarray(grid_mapping.xy_coords.data, dtype=np.float64)
    tx, ty = tf.transform(src_xy[0], src_xy[1])

    dims = grid_mapping.xy_coords.dims[1:]
    names = xy_var_names or ("transformed_x", "transformed_y")
    return new_grid_mapping_from_coords(
        x_coords=DataArray(tx, dims=dims, name=names[0]),
        y_coords=DataArray(ty, dims=dims, name=names[1]),
        crs=target_crs,
        xy_res=xy_res,
        xy_bbox=(
            _padded_target_bbox(grid_mapping, tf, xy_res)
            if xy_res is not None
            else None
        ),
        tile_size=grid_mapping.tile_size if tile_size is None else tile_size,
        tolerance=tolerance,
    )
