"""Grid-mapping inference from datasets.

Semantics track the reference's ``gridmapping/dataset.py:31-102`` (see
NOTICE): every CF grid-mapping proxy found in the dataset becomes a
candidate ``GridMapping``, and the caller's preferences select among
them.  The preference cascade is expressed here as a single ranking
function rather than the reference's sequence of loops:

    crs+regularity match > geographic+regularity > crs match >
    geographic match > regularity match > first candidate found
"""

from __future__ import annotations

from ..constants import LOG
from ..crs import CRS
from ..xrlite import Dataset
from .base import DEFAULT_TOLERANCE, GridMapping
from .cfconv import get_dataset_grid_mapping_proxies
from .coords import new_grid_mapping_from_coords
from .helpers import _normalize_crs


def _preference_rank(
    gm: GridMapping, want_crs: CRS | None, want_regular: bool | None
) -> int:
    """Rank a candidate against the caller's preferences (higher wins).

    Mirrors the reference's loop cascade exactly: an exact-CRS +
    regularity match outranks a both-geographic + regularity match,
    which outranks CRS-only, geographic-only, and regularity-only
    matches, in that order.
    """
    crs_hit = want_crs is not None and gm.crs == want_crs
    geo_hit = (
        want_crs is not None
        and gm.crs.is_geographic
        and want_crs.is_geographic
    )
    reg_hit = (
        want_regular is not None and bool(gm.is_regular) == want_regular
    )
    if want_regular is not None and want_crs is not None:
        if crs_hit and reg_hit:
            return 5
        if geo_hit and reg_hit:
            return 4
    if crs_hit:
        return 3
    if geo_hit:
        return 2
    if reg_hit:
        return 1
    return 0


def new_grid_mapping_from_dataset(
    dataset: Dataset,
    *,
    crs: str | CRS = None,
    tile_size: int | tuple[str, str] = None,
    prefer_crs: str | CRS = None,
    prefer_is_regular: bool = None,
    emit_warnings: bool = False,
    tolerance: float = DEFAULT_TOLERANCE,
) -> GridMapping:
    # ``crs`` supplies a CRS for proxies that lack one; ``prefer_crs``
    # breaks ties between multiple discovered CRSs and defaults to ``crs``.
    forced_crs = _normalize_crs(crs) if crs is not None else None
    want_crs = (
        _normalize_crs(prefer_crs) if prefer_crs is not None else forced_crs
    )

    proxies = get_dataset_grid_mapping_proxies(
        dataset,
        emit_warnings=emit_warnings,
        missing_projected_crs=forced_crs,
        missing_rotated_latitude_longitude_crs=forced_crs,
        missing_latitude_longitude_crs=forced_crs,
    )

    # A broken proxy (e.g. an all-NaN 2D lat/lon image produced by
    # resampling near a swath edge) must not take down inference when a
    # healthy sibling proxy exists — the reference gets this tolerance
    # for free from lazy dask bboxes (reference gridmapping/dataset.py:
    # 72-100 never computes a candidate's bbox unless it is selected).
    candidates = []
    errors: list[Exception] = []
    for proxy in proxies.values():
        try:
            candidates.append(
                new_grid_mapping_from_coords(
                    x_coords=proxy.coords.x,
                    y_coords=proxy.coords.y,
                    crs=proxy.crs,
                    tile_size=tile_size or proxy.tile_size,
                    tolerance=tolerance,
                )
            )
        except (ValueError, RuntimeError) as error:
            LOG.warning(
                "ignoring unusable grid mapping candidate "
                f"({proxy.crs}): {error}"
            )
            errors.append(error)
    if not candidates:
        if errors:
            raise errors[0]
        raise ValueError("cannot find any grid mapping in dataset")

    # max() keeps the earliest candidate on rank ties, so a dataset with
    # a single proxy (or no preferences) yields the first one found.
    return max(
        candidates,
        key=lambda gm: _preference_rank(gm, want_crs, prefer_is_regular),
    )
