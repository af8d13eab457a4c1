"""Gateway: route a dataset to the port's engines.

Port of ``xcube_resampling_tpu/spatial.py``; :func:`choose_route` is a
copy of its route decision.  The rectify, affine and reproject routes are
ported.
"""

from __future__ import annotations

from collections.abc import Iterable

from .affine import affine_transform_dataset
from .constants import (
    LOG,
    AggMethods,
    FillValues,
    InterpMethods,
    RecoverNans,
)
from .gridmapping import GridMapping
from .rectify import rectify_dataset
from .reproject import reproject_dataset
from .utils import _can_apply_affine_transform
from .xrlite import Dataset


def choose_route(source_gm: GridMapping, target_gm: GridMapping | None) -> str:
    """Pick the resampling route for a (source, target) grid-mapping pair.

    Returns one of ``"rectify"``, ``"warn-identity"``, ``"identity"``,
    ``"affine"``, ``"reproject"``.  Raises if *target_gm* is irregular
    (only regular targets can be resampled to).
    """
    if not source_gm.is_regular:
        return "rectify"
    if target_gm is None:
        return "warn-identity"
    GridMapping.assert_regular(target_gm, name="target_gm")
    if source_gm.is_close(target_gm):
        return "identity"
    if _can_apply_affine_transform(source_gm, target_gm):
        return "affine"
    return "reproject"


def resample_in_space(
    source_ds: Dataset,
    target_gm: GridMapping | None = None,
    source_gm: GridMapping | None = None,
    variables: str | Iterable[str] | None = None,
    interp_methods: InterpMethods | None = None,
    agg_methods: AggMethods | None = None,
    recover_nans: RecoverNans = False,
    fill_values: FillValues | None = None,
    tile_size: int | tuple[int, int] | None = None,
    device="cuda",
) -> Dataset:
    """Resample the spatial dimensions of a dataset to a target grid
    mapping; arguments as ``xcube_resampling_tpu.resample_in_space``, plus
    *device*: where numpy-backed variables are placed, in their own dtype.
    Tensor variables stay on their own device."""
    if source_gm is None:
        source_gm = GridMapping.from_dataset(source_ds)
    route = choose_route(source_gm, target_gm)
    if route == "warn-identity":
        LOG.warning(
            "If source grid mapping is regular `target_gm` must be given. "
            "Source dataset is returned."
        )
        return source_ds
    if route == "identity":
        return source_ds
    engine_kwargs = dict(
        source_gm=source_gm,
        variables=variables,
        interp_methods=interp_methods,
        agg_methods=agg_methods,
        recover_nans=recover_nans,
        fill_values=fill_values,
        device=device,
    )
    if route == "rectify":
        return rectify_dataset(
            source_ds, target_gm=target_gm, tile_size=tile_size, **engine_kwargs
        )
    engine = affine_transform_dataset if route == "affine" else reproject_dataset
    return engine(source_ds, target_gm, **engine_kwargs)
