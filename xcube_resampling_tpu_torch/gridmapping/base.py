"""GridMapping — the image-grid <-> Earth-coordinate model.

API and semantics track the reference's ``GridMapping``
(xcube_resampling/gridmapping/base.py:59-913, see NOTICE),
re-expressed for this framework: all scalar grid state lives in one
immutable :class:`_GridSpec` record, coordinates are eager numpy-backed
xrlite DataArrays carrying chunk *metadata* (no dask), tile bboxes are
computed by vectorized numpy (no per-block Python loop), and the per-tile
coordinate-image scan is the vectorized masked reduction in
:mod:`.bboxes` (replacing the reference's numba prange kernel).

No locking: unlike the reference, whose dask graphs touch grid mappings
from worker threads, nothing here computes grid-mapping attributes
concurrently.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import numpy as np

from ..constants import AffineTransformMatrix, FloatInt
from ..crs import CRS, CRS_CRS84, CRS_WGS84
from ..xrlite import DataArray
from .assertions import assert_given, assert_instance, assert_true
from .helpers import (
    _assert_valid_xy_coords,
    _assert_valid_xy_names,
    _from_affine,
    _normalize_int_pair,
    _normalize_number_pair,
    _to_affine,
    scale_xy_res_and_size,
)

#: String id of the OGC CRS84 coordinate reference system
CRS84 = "OGC:CRS84"

# Default tolerance for all operations that accept a "tolerance" kwarg
DEFAULT_TOLERANCE = 1.0e-5


@dataclasses.dataclass(frozen=True)
class _GridSpec:
    """The scalar state of a grid mapping, validated once at construction."""

    size: tuple[int, int]
    tile_size: tuple[int, int]
    xy_bbox: tuple[FloatInt, FloatInt, FloatInt, FloatInt]
    xy_res: tuple[FloatInt, FloatInt]
    crs: CRS
    xy_var_names: tuple[str, str]
    xy_dim_names: tuple[str, str]
    is_regular: bool | None
    is_lon_360: bool | None
    is_j_axis_up: bool | None


def _tile_starts_stops(total: int, step: int) -> tuple[np.ndarray, np.ndarray]:
    starts = np.arange(0, total, step, dtype=np.int64)
    return starts, np.minimum(starts + step, total)


class GridMapping(abc.ABC):
    """Defines an image grid and the mapping from pixel coordinates to
    spatial Earth coordinates in a well-known CRS.

    Construct through the factory classmethods :meth:`regular`,
    :meth:`from_dataset`, :meth:`from_coords`; derive new instances with
    :meth:`derive`, :meth:`scale`, :meth:`transform`, :meth:`to_regular`.
    """

    def __init__(
        self,
        /,
        size: int | tuple[int, int],
        tile_size: int | tuple[int, int] | None,
        xy_bbox: tuple[FloatInt, FloatInt, FloatInt, FloatInt],
        xy_res: FloatInt | tuple[FloatInt, FloatInt],
        crs: CRS,
        xy_var_names: tuple[str, str],
        xy_dim_names: tuple[str, str],
        is_regular: bool | None = None,
        is_lon_360: bool | None = None,
        is_j_axis_up: bool | None = None,
        x_coords: DataArray | None = None,
        y_coords: DataArray | None = None,
    ):
        wh = _normalize_int_pair(size, name="size")
        assert_true(min(wh) > 1, "invalid size")
        tiles = _normalize_int_pair(tile_size, default=wh)
        assert_true(min(tiles) > 1, "invalid tile_size")

        assert_given(xy_bbox, name="xy_bbox")
        assert_given(xy_res, name="xy_res")
        _assert_valid_xy_names(xy_var_names, name="xy_var_names")
        _assert_valid_xy_names(xy_dim_names, name="xy_dim_names")
        assert_instance(crs, CRS, name="crs")
        res = _normalize_number_pair(xy_res, name="xy_res")
        assert_true(min(res) > 0, "invalid xy_res")

        for label, arr in (("x_coords", x_coords), ("y_coords", y_coords)):
            if arr is not None:
                assert_instance(arr, DataArray, name=label)
                assert_true(
                    arr.ndim in (1, 2),
                    message=f"{label}.ndim must be 1 or 2, was {arr.ndim}",
                )

        self._spec = _GridSpec(
            size=wh,
            tile_size=tiles,
            xy_bbox=tuple(xy_bbox),
            xy_res=res,
            crs=crs,
            xy_var_names=tuple(xy_var_names),
            xy_dim_names=tuple(xy_dim_names),
            is_regular=is_regular,
            is_lon_360=is_lon_360,
            is_j_axis_up=is_j_axis_up,
        )
        # coordinate caches, filled lazily; subclasses read these directly
        self._x_coords = x_coords
        self._y_coords = y_coords
        self._xy_coords = None

    def _replace_spec(self, **changes) -> None:
        self._spec = dataclasses.replace(self._spec, **changes)

    # -- derivation ---------------------------------------------------------

    def derive(
        self,
        /,
        xy_var_names: tuple[str, str] = None,
        xy_dim_names: tuple[str, str] = None,
        tile_size: int | tuple[int, int] = None,
        is_j_axis_up: bool = None,
    ) -> "GridMapping":
        """A copy of this grid mapping with new coordinate names, tile
        size, and/or j-axis orientation."""
        changes = {}
        for key, names in (
            ("xy_var_names", xy_var_names),
            ("xy_dim_names", xy_dim_names),
        ):
            if names is not None:
                _assert_valid_xy_names(names, name=key)
                changes[key] = tuple(names)

        retile = None
        if tile_size is not None:
            retile = _normalize_int_pair(tile_size, name="tile_size")
            assert_true(min(retile) > 1, "invalid tile_size")
            if retile != self.tile_size:
                changes["tile_size"] = retile
            else:
                retile = None

        flip = is_j_axis_up is not None and is_j_axis_up != self.is_j_axis_up
        if flip:
            changes["is_j_axis_up"] = is_j_axis_up

        other = copy.copy(self)
        if changes:
            other._replace_spec(**changes)
        if retile:
            # materialize + re-chunk the coordinate image metadata
            other._xy_coords = other._rechunked_xy(self.xy_coords)
        if flip:
            # flipping the j axis reverses the row order of cached coords
            if other._y_coords is not None:
                other._y_coords = other._y_coords[::-1]
            if other._xy_coords is not None:
                other._xy_coords = other._rechunked_xy(
                    other._xy_coords[:, ::-1, :]
                )
        return other

    def _rechunked_xy(self, xy: DataArray) -> DataArray:
        return xy.chunk(dict(zip(xy.dims, self.xy_coords_chunks)))

    def scale(
        self,
        xy_scale: FloatInt | tuple[FloatInt, FloatInt],
        tile_size: int | tuple[int, int] | None = None,
    ) -> "GridMapping":
        """A regular grid mapping over the same origin with the pixel
        count scaled by *xy_scale* (> 1 = finer pixels)."""
        self._assert_regular()
        scales = _normalize_number_pair(xy_scale)
        new_xy_res, new_size = scale_xy_res_and_size(
            self.xy_res, self.size, scales
        )
        if tile_size is not None:
            tile_w, tile_h = _normalize_int_pair(tile_size, name="tile_size")
        else:
            tile_w, tile_h = self.tile_size
        return self.regular(
            new_size,
            (self.x_min, self.y_min),
            new_xy_res,
            self.crs,
            tile_size=(min(new_size[0], tile_w), min(new_size[1], tile_h)),
            is_j_axis_up=self.is_j_axis_up,
        ).derive(
            xy_dim_names=self.xy_dim_names, xy_var_names=self.xy_var_names
        )

    # -- scalar properties --------------------------------------------------
    # All scalar state is a projection of the immutable _GridSpec; the
    # accessors are generated below the class body (_install_spec_accessors)
    # so the spec record stays the single source of truth.

    @property
    def is_tiled(self) -> bool:
        """True when tiles are smaller than the image."""
        return self._spec.size != self._spec.tile_size

    @property
    def spatial_unit_name(self) -> str:
        return self._spec.crs.axis_info[0].unit_name

    # -- coordinate arrays --------------------------------------------------

    @property
    def x_coords(self) -> DataArray:
        """x coordinates: shape (width,) or (height, width)."""
        if self._x_coords is None:
            self._x_coords = self._new_x_coords()
        return self._x_coords

    @abc.abstractmethod
    def _new_x_coords(self) -> DataArray:
        """Build the x-coordinate array."""

    @property
    def y_coords(self) -> DataArray:
        """y coordinates: shape (height,) or (height, width)."""
        if self._y_coords is None:
            self._y_coords = self._new_y_coords()
        return self._y_coords

    @abc.abstractmethod
    def _new_y_coords(self) -> DataArray:
        """Build the y-coordinate array."""

    @property
    def xy_coords(self) -> DataArray:
        """The coordinate image of shape (2, height, width) in CRS units."""
        if self._xy_coords is None:
            self._xy_coords = self._new_xy_coords()
        _assert_valid_xy_coords(self._xy_coords)
        return self._xy_coords

    @property
    def xy_coords_chunks(self) -> tuple[int, int, int]:
        """Chunk sizes of the coordinate image."""
        return 2, self.tile_height, self.tile_width

    @abc.abstractmethod
    def _new_xy_coords(self) -> DataArray:
        """Build the (2, height, width) coordinate image."""

    # -- affine transforms (regular grids) ----------------------------------

    @property
    def ij_to_xy_transform(self) -> AffineTransformMatrix:
        """2x3 affine matrix from pixel to CRS coordinates (regular grids
        only)."""
        self._assert_regular()
        if self.is_j_axis_up:
            y_row = (0.0, self.y_res, self.y_min)
        else:
            y_row = (0.0, -self.y_res, self.y_max)
        return (self.x_res, 0.0, self.x_min), y_row

    @property
    def xy_to_ij_transform(self) -> AffineTransformMatrix:
        """2x3 affine matrix from CRS to pixel coordinates (regular grids
        only)."""
        self._assert_regular()
        return _from_affine(~_to_affine(self.ij_to_xy_transform))

    def ij_transform_to(self, other: "GridMapping") -> AffineTransformMatrix:
        """Affine matrix mapping *other*'s pixel coordinates into this
        grid's pixel coordinates."""
        self._assert_regular()
        self.assert_regular(other, name="other")
        own = _to_affine(self.ij_to_xy_transform)
        into_other = _to_affine(other.xy_to_ij_transform)
        return _from_affine(into_other * own)

    def ij_transform_from(self, other: "GridMapping") -> AffineTransformMatrix:
        """Affine matrix mapping this grid's pixel coordinates into
        *other*'s pixel coordinates."""
        self._assert_regular()
        self.assert_regular(other, name="other")
        return _from_affine(~_to_affine(self.ij_transform_to(other)))

    # -- tile bbox math ------------------------------------------------------

    @property
    def ij_bbox(self) -> tuple[int, int, int, int]:
        """The full image extent as (0, 0, width, height)."""
        return 0, 0, self.width, self.height

    @property
    def ij_bboxes(self) -> np.ndarray:
        """Per-tile pixel bboxes [[i0, j0, i1, j1], ...], row-major over
        tiles (stops exclusive)."""
        i0, i1 = _tile_starts_stops(self.width, self.tile_width)
        j0, j1 = _tile_starts_stops(self.height, self.tile_height)
        n_i = len(i0)
        n_j = len(j0)
        out = np.empty((n_j * n_i, 4), dtype=np.int64)
        out[:, 0] = np.tile(i0, n_j)
        out[:, 1] = np.repeat(j0, n_i)
        out[:, 2] = np.tile(i1, n_j)
        out[:, 3] = np.repeat(j1, n_i)
        return out

    @property
    def xy_bboxes(self) -> np.ndarray:
        """Per-tile CRS bboxes [[x_min, y_min, x_max, y_max], ...] in the
        same tile order as :attr:`ij_bboxes`."""
        ij = self.ij_bboxes
        out = np.empty(ij.shape, dtype=np.float64)
        out[:, 0] = self.x_min + self.x_res * ij[:, 0]
        out[:, 2] = self.x_min + self.x_res * ij[:, 2]
        if self.is_j_axis_up:
            out[:, 1] = self.y_min + self.y_res * ij[:, 1]
            out[:, 3] = self.y_min + self.y_res * ij[:, 3]
        else:
            out[:, 1] = self.y_max - self.y_res * ij[:, 3]
            out[:, 3] = self.y_max - self.y_res * ij[:, 1]
        return out

    def ij_bbox_from_xy_bbox(
        self,
        xy_bbox: tuple[float, float, float, float],
        xy_border: float = 0.0,
        ij_border: int = 0,
    ) -> tuple[int, int, int, int]:
        """The (i_min, j_min, i_max, j_max) pixel bbox covering *xy_bbox*,
        or (-1, -1, -1, -1) when nothing intersects."""
        result = self.ij_bboxes_from_xy_bboxes(
            np.array([xy_bbox], dtype=np.float64),
            xy_border=xy_border,
            ij_border=ij_border,
        )
        # noinspection PyTypeChecker
        return tuple(map(int, result[0]))

    def ij_bboxes_from_xy_bboxes(
        self,
        xy_bboxes: np.ndarray,
        xy_border: float = 0.0,
        ij_border: int = 0,
        ij_bboxes: np.ndarray = None,
    ) -> np.ndarray:
        """Pixel bboxes [[i_min, j_min, i_max, j_max], ...] covering the
        given CRS bboxes (stops exclusive, usable as slices; -1 rows mean
        no intersection).

        This is rectify's halo/overlap discovery — a vectorized masked
        min/max reduction over the coordinate image (:mod:`.bboxes`),
        replacing the reference's numba prange scan (bboxes.py:28-106)."""
        if ij_bboxes is None:
            ij_bboxes = np.full_like(xy_bboxes, -1, dtype=np.int64)
        else:
            ij_bboxes[:, :] = -1
        from .bboxes import compute_ij_bboxes

        xy = self.xy_coords
        compute_ij_bboxes(
            np.asarray(xy.data[0]),
            np.asarray(xy.data[1]),
            np.asarray(xy_bboxes, dtype=np.float64),
            xy_border,
            ij_border,
            ij_bboxes,
        )
        return ij_bboxes

    # -- factories & conversion ---------------------------------------------

    def to_coords(
        self,
        xy_var_names: tuple[str, str] = None,
        xy_dim_names: tuple[str, str] = None,
        exclude_bounds: bool = False,
        reuse_coords: bool = False,
    ) -> Mapping[str, DataArray]:
        """CF axis coordinate variables (+ cell bounds) for this regular
        grid mapping."""
        self._assert_regular()
        from .coords import grid_mapping_to_coords

        return grid_mapping_to_coords(
            self,
            xy_var_names=xy_var_names,
            xy_dim_names=xy_dim_names,
            exclude_bounds=exclude_bounds,
            reuse_coords=reuse_coords,
        )

    # the remaining factories/derivations delegate to sibling modules
    # (lazy imports break the module cycle); signatures live there

    def transform(self, crs: str | CRS, **kwargs) -> "GridMapping":
        """This grid mapping re-expressed in another *crs* (an irregular
        2D-coords grid mapping).  Keywords: ``xy_res``, ``tile_size``,
        ``xy_var_names``, ``tolerance`` — see
        :func:`.transform.transform_grid_mapping`."""
        from .transform import transform_grid_mapping

        return transform_grid_mapping(self, crs, **kwargs)

    @classmethod
    def regular(cls, size, xy_min, xy_res, crs, **kwargs) -> "GridMapping":
        """A new regular grid mapping.  Keywords: ``tile_size``,
        ``is_j_axis_up`` — see :func:`.regular.new_regular_grid_mapping`."""
        from .regular import new_regular_grid_mapping

        return new_regular_grid_mapping(size, xy_min, xy_res, crs, **kwargs)

    def to_regular(self, tile_size=None, is_j_axis_up: bool = False) -> "GridMapping":
        """The regular grid mapping covering this (possibly irregular)
        one — see :func:`.regular.to_regular_grid_mapping`."""
        from .regular import to_regular_grid_mapping

        return to_regular_grid_mapping(
            self, tile_size=tile_size, is_j_axis_up=is_j_axis_up
        )

    @classmethod
    def from_dataset(cls, dataset, **kwargs) -> "GridMapping":
        """Infer a grid mapping from a dataset's CF metadata.  Keywords:
        ``crs``, ``tile_size``, ``prefer_is_regular``, ``prefer_crs``,
        ``emit_warnings``, ``tolerance`` — see
        :func:`.dataset.new_grid_mapping_from_dataset`."""
        from .dataset import new_grid_mapping_from_dataset

        kwargs.setdefault("prefer_is_regular", True)
        return new_grid_mapping_from_dataset(dataset=dataset, **kwargs)

    @classmethod
    def from_coords(cls, x_coords, y_coords, crs, **kwargs) -> "GridMapping":
        """A grid mapping built from x/y coordinate variables and a CRS.
        Keywords: ``tile_size``, ``tolerance`` — see
        :func:`.coords.new_grid_mapping_from_coords`."""
        from .coords import new_grid_mapping_from_coords

        return new_grid_mapping_from_coords(
            x_coords=x_coords, y_coords=y_coords, crs=crs, **kwargs
        )

    # -- comparison & assertions ---------------------------------------------

    def is_close(
        self, other: "GridMapping", tolerance: float = DEFAULT_TOLERANCE
    ) -> bool:
        """Whether *other* describes the same grid up to *tolerance* in
        resolution and bbox (flags, size, tiling and CRS must match
        exactly)."""
        if self is other:
            return True
        discrete_equal = (
            self.is_j_axis_up,
            self.is_lon_360,
            self.is_regular,
            self.size,
            self.tile_size,
        ) == (
            other.is_j_axis_up,
            other.is_lon_360,
            other.is_regular,
            other.size,
            other.tile_size,
        )
        if not discrete_equal or self.crs != other.crs:
            return False
        mine = (*self.xy_res, *self.xy_bbox)
        theirs = (*other.xy_res, *other.xy_bbox)
        return all(
            math.isclose(a, b, abs_tol=tolerance)
            for a, b in zip(mine, theirs)
        )

    @classmethod
    def assert_regular(cls, value: Any, name: str = None):
        assert_instance(value, GridMapping, name=name)
        if not value.is_regular:
            raise ValueError(
                f"{name or 'value'} must be a regular grid mapping"
            )

    def _assert_regular(self):
        if not self.is_regular:
            raise NotImplementedError(
                "Operation not implemented for non-regular grid mappings"
            )

    def _repr_markdown_(self) -> str:
        """IPython notebook Markdown representation."""

        def show(flag):
            return "_unknown_" if flag is None else flag

        xy_res = repr(self.xy_res) + (
            "" if self.is_regular else "  _estimated_"
        )
        lines = [
            f"class: **{self.__class__.__name__}**",
            f"* is_regular: {show(self.is_regular)}",
            f"* is_j_axis_up: {show(self.is_j_axis_up)}",
            f"* is_lon_360: {show(self.is_lon_360)}",
            f"* crs: {self.crs}",
            f"* xy_res: {xy_res}",
            f"* xy_bbox: {self.xy_bbox}",
            f"* ij_bbox: {self.ij_bbox}",
            f"* xy_dim_names: {self.xy_dim_names}",
            f"* xy_var_names: {self.xy_var_names}",
            f"* size: {self.size}",
            f"* tile_size: {self.tile_size}",
        ]
        return "\n".join(lines)


def _install_spec_accessors(cls):
    """Attach read-only properties projecting :class:`_GridSpec` fields
    (and their tuple components) onto the GridMapping class."""
    specs = {
        "size": "(width, height) in pixels.",
        "tile_size": "(tile_width, tile_height) in pixels.",
        "xy_bbox": "(x_min, y_min, x_max, y_max) in CRS units.",
        "xy_res": "(x_res, y_res) pixel sizes in CRS units.",
        "crs": "The coordinate reference system.",
        "xy_var_names": "(x, y) coordinate variable names.",
        "xy_dim_names": "(x, y) dimension names.",
        "is_regular": (
            "True when pixel deltas are constant along both axes; "
            "None if undetermined."
        ),
        "is_lon_360": (
            "True when x_max crosses the antimeridian (> 180 deg); "
            "geographic CRSs only; None if undetermined."
        ),
        "is_j_axis_up": (
            "True when increasing image row index means increasing y "
            "coordinate (default is j-down); None if undetermined."
        ),
    }
    components = {
        "width": ("size", 0, "Pixels along the x axis."),
        "height": ("size", 1, "Pixels along the y axis."),
        "tile_width": ("tile_size", 0, "Tile extent along the x axis."),
        "tile_height": ("tile_size", 1, "Tile extent along the y axis."),
        "x_min": ("xy_bbox", 0, "West bbox edge."),
        "y_min": ("xy_bbox", 1, "South bbox edge."),
        "x_max": ("xy_bbox", 2, "East bbox edge."),
        "y_max": ("xy_bbox", 3, "North bbox edge."),
        "x_res": ("xy_res", 0, "Pixel size along x."),
        "y_res": ("xy_res", 1, "Pixel size along y."),
    }

    def field_getter(field):
        return lambda self: getattr(self._spec, field)

    def item_getter(field, idx):
        return lambda self: getattr(self._spec, field)[idx]

    for field, doc in specs.items():
        setattr(cls, field, property(field_getter(field), doc=doc))
    for name, (field, idx, doc) in components.items():
        setattr(cls, name, property(item_getter(field, idx), doc=doc))
    return cls


_install_spec_accessors(GridMapping)
