"""CF-convention grid-mapping discovery in datasets.

Semantics track reference ``gridmapping/cfconv.py:37-317`` (see NOTICE):
grid-mapping variables are located via the CF ``grid_mapping`` attribute,
with fallbacks to CRS attributes on any variable and then on the dataset
itself; coordinate variables are matched by CF ``standard_name`` first and
by naming convention second; bounds variables are excluded; the tile size
comes from the dataset's most common chunking.

The implementation is organized around a table of the three CF coordinate
flavors (:data:`_COORD_FLAVORS`) — geographic, rotated-pole, projected —
instead of the reference's three parallel code paths.  Copy of
``xcube_resampling_tpu/gridmapping/cfconv.py`` without the zarr store
helper ``add_spatial_ref``: the port has no zarr store yet.
"""

from __future__ import annotations

import warnings
from collections.abc import Hashable
from dataclasses import dataclass, field
from typing import Any

from ..crs import CRS, CRSError, CRS_WGS84
from ..xrlite import DataArray, Dataset
from .helpers import get_dataset_chunks


@dataclass
class GridCoords:
    """A pair of x/y coordinate variables (either may be missing)."""

    x: DataArray | None = None
    y: DataArray | None = None


@dataclass
class GridMappingProxy:
    """A discovered-but-unvalidated grid mapping: CRS, the CF
    ``grid_mapping_name`` (when present), coordinates, and spatial chunk
    sizes."""

    crs: CRS | None = None
    name: str | None = None
    coords: GridCoords | None = None
    tile_size: tuple[int, int] | None = None


@dataclass
class _CoordFlavor:
    """One CF horizontal-coordinate flavor and how to recognize it."""

    grid_mapping_name: str | None  # None = matches any proxy
    standard_names: tuple[str, str]  # (x, y)
    var_names: tuple[tuple[str, ...], tuple[str, ...]]  # (x aliases, y aliases)
    found: GridCoords = field(default_factory=GridCoords)


def _coord_flavors() -> tuple[_CoordFlavor, _CoordFlavor, _CoordFlavor]:
    """Fresh per-call flavor records: geographic, rotated-pole, projected
    (reference cfconv.py:126-156)."""
    return (
        _CoordFlavor(
            "latitude_longitude",
            ("longitude", "latitude"),
            (("lon", "longitude"), ("lat", "latitude")),
        ),
        _CoordFlavor(
            "rotated_latitude_longitude",
            ("grid_longitude", "grid_latitude"),
            (("rlon", "rlongitude"), ("rlat", "rlatitude")),
        ),
        _CoordFlavor(
            None,  # projected: matches any proxy regardless of name
            ("projection_x_coordinate", "projection_y_coordinate"),
            (("x", "xc", "transformed_x"), ("y", "yc", "transformed_y")),
        ),
    )


def get_dataset_grid_mapping_proxies(
    dataset: Dataset,
    *,
    missing_latitude_longitude_crs: CRS = None,
    missing_rotated_latitude_longitude_crs: CRS = None,
    missing_projected_crs: CRS = None,
    emit_warnings: bool = False,
) -> dict[Hashable | None, GridMappingProxy]:
    """Find grid mappings encoded per the CF conventions chapter on
    Horizontal Coordinate Reference Systems, Grid Mappings, and
    Projections."""
    proxies = _discover_crs_proxies(dataset)

    geographic, rotated, projected = flavors = _coord_flavors()
    _match_coord_vars(dataset, flavors)

    # Attach each flavor's coordinates to the proxies of its kind; proxies
    # without a recognized grid_mapping_name count as projected.
    by_name = {f.grid_mapping_name: f for f in (geographic, rotated)}
    for proxy in proxies.values():
        proxy.coords = by_name.get(proxy.name, projected).found

    # Coordinates found without a matching proxy create one from the
    # caller-supplied fallback CRS; plain lat/lon datasets always get a
    # WGS84 proxy this way.  The per-field fill covers the GeoTIFF edge
    # case of a geographic CRS with 1D coordinates named "x"/"y".
    fallback_crs = (
        missing_latitude_longitude_crs or CRS_WGS84,
        missing_rotated_latitude_longitude_crs,
        missing_projected_crs,
    )
    for flavor, missing_crs in zip(flavors, fallback_crs):
        _adopt_flavor_coords(flavor, missing_crs, proxies)

    return _validate_and_finish(dataset, proxies, emit_warnings)


def _discover_crs_proxies(
    dataset: Dataset,
) -> dict[Hashable | None, GridMappingProxy]:
    """CRS discovery cascade: CF ``grid_mapping`` attributes first, then
    CRS attributes on any single variable, then dataset attributes."""
    proxies: dict[Hashable | None, GridMappingProxy] = {}
    for var in dataset.variables.values():
        target = var.attrs.get("grid_mapping")
        if target and target not in proxies and target in dataset:
            proxy = _parse_crs_from_attrs(dataset[target].attrs)
            proxies[target] = proxy
    if proxies:
        return proxies

    for var_name, var in dataset.variables.items():
        proxy = _parse_crs_from_attrs(var.attrs)
        if proxy is not None:
            return {var_name: proxy}

    proxy = _parse_crs_from_attrs(dataset.attrs)
    return {None: proxy} if proxy is not None else {}


def _parse_crs_from_attrs(
    attrs: dict[Hashable, Any],
) -> GridMappingProxy | None:
    try:
        crs = CRS.from_cf(attrs)
    except CRSError:
        return None
    return GridMappingProxy(crs=crs, name=attrs.get("grid_mapping_name"))


def _match_coord_vars(dataset: Dataset, flavors) -> None:
    """Fill each flavor's coordinates from the dataset's candidate
    variables: every standard_name match beats every naming-convention
    match, and the first hit per slot wins."""
    candidates = _find_potential_coord_vars(dataset)

    for by_standard_name in (True, False):
        for var_name in candidates:
            var = dataset[var_name]
            std = var.attrs.get("standard_name")
            for flavor in flavors:
                if by_standard_name:
                    x_hit = std == flavor.standard_names[0]
                    y_hit = std == flavor.standard_names[1]
                else:
                    x_hit = var_name in flavor.var_names[0]
                    y_hit = var_name in flavor.var_names[1]
                if flavor.found.x is None and x_hit:
                    flavor.found.x = var
                if flavor.found.y is None and y_hit:
                    flavor.found.y = var


def _adopt_flavor_coords(
    flavor: _CoordFlavor,
    missing_crs: CRS | None,
    proxies: dict[Hashable | None, GridMappingProxy],
) -> None:
    """Ensure coordinates found for *flavor* belong to some proxy,
    creating one from *missing_crs* when no proxy of that kind exists
    (reference cfconv.py:193-220)."""
    found = flavor.found
    if found.x is None and found.y is None:
        return
    want = flavor.grid_mapping_name
    proxy = next(
        (p for p in proxies.values() if want is None or want == p.name),
        None,
    )
    if proxy is None and missing_crs is not None:
        proxy = GridMappingProxy(crs=missing_crs, name=want)
        proxies[None] = proxy
    if proxy is None:
        return
    if proxy.coords is None:
        proxy.coords = found
    if proxy.coords.x is None:
        proxy.coords.x = found.x
    if proxy.coords.y is None:
        proxy.coords.y = found.y


def _validate_and_finish(
    dataset: Dataset,
    proxies: dict[Hashable | None, GridMappingProxy],
    emit_warnings: bool,
) -> dict[Hashable | None, GridMappingProxy]:
    """Keep proxies whose coordinates form a usable pair — both present,
    at least 2 samples each, equal rank, and (for 2D) identical dims —
    and stamp their tile size from the dataset chunking."""
    complete: dict[Hashable | None, GridMappingProxy] = {}
    for key, proxy in proxies.items():
        c = proxy.coords
        usable = (
            c is not None
            and c.x is not None
            and c.y is not None
            and c.x.size >= 2
            and c.y.size >= 2
            and c.x.ndim == c.y.ndim
        )
        if usable and c.x.ndim == 1:
            dims = (c.x.dims[0], c.y.dims[0])
        elif usable and c.x.ndim == 2 and c.x.dims == c.y.dims:
            dims = (c.x.dims[1], c.x.dims[0])
        else:
            if not usable and emit_warnings:
                warnings.warn(
                    f'CRS "{proxy.name}": '
                    f"missing x- and/or y-coordinates "
                    f'(grid mapping variable "{key}": '
                    f'grid_mapping_name="{proxy.name}")'
                )
            continue
        proxy.tile_size = _find_dataset_tile_size(dataset, *dims)
        complete[key] = proxy
    return complete


def _find_potential_coord_vars(dataset: Dataset) -> list[Hashable]:
    """Candidate coordinate variables: every 1D/2D variable that is not a
    bounds variable (2D coordinate arrays are often not marked as coords),
    with any names from the CF global ``coordinates`` attribute listed
    first."""
    bounds_vars = _find_bounds_vars(dataset)

    def is_candidate(name: Hashable) -> bool:
        if name not in dataset or name in bounds_vars:
            return False
        return dataset[name].ndim in (1, 2)

    ordered: list[Hashable] = []
    declared = dataset.attrs.get("coordinates")
    if declared is not None:
        ordered += [n for n in declared.split() if is_candidate(n)]
    ordered += [
        n for n in dataset.variables if n not in ordered and is_candidate(n)
    ]
    return ordered


def _find_bounds_vars(dataset: Dataset) -> set:
    """Bounds variables, by CF ``bounds`` attribute or by the ``_bnds`` /
    ``_bounds`` suffix convention."""
    bounds_vars = set()
    for name in dataset.variables:
        declared = dataset[name].attrs.get("bounds")
        if declared is not None and declared in dataset:
            bounds_vars.add(declared)
        base, _, suffix = str(name).rpartition("_")
        if suffix in ("bnds", "bounds") and base in dataset:
            bounds_vars.add(name)
    return bounds_vars


def _find_dataset_tile_size(
    dataset: Dataset, x_dim_name: Hashable, y_dim_name: Hashable
) -> tuple[int, int] | None:
    """The dataset's most common spatial chunking, when both dims have one."""
    chunks = get_dataset_chunks(dataset)
    tile_width = chunks.get(x_dim_name)
    tile_height = chunks.get(y_dim_name)
    if tile_width is not None and tile_height is not None:
        return tile_width, tile_height
    return None


def add_spatial_ref(
    dataset_store,
    crs: CRS,
    crs_var_name: str = "spatial_ref",
    xy_dim_names: tuple[str, str] | None = None,
):
    """Add a spatial reference to an existing zarr store
    (see :func:`xcube_resampling_tpu_torch.zarrlite.add_spatial_ref`)."""
    from ..zarrlite import add_spatial_ref as _add_spatial_ref

    return _add_spatial_ref(
        dataset_store, crs, crs_var_name=crs_var_name, xy_dim_names=xy_dim_names
    )
