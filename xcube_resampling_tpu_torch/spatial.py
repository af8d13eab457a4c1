"""Gateway: route a dataset of torch tensors to the port's engines.

Port of ``xcube_resampling_tpu/spatial.py:resample_in_space``; the route
decision is the JAX package's own :func:`choose_route`.  Only the
reproject route is ported so far: the affine and rectify routes raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from collections.abc import Iterable

from xcube_resampling_tpu.constants import (
    LOG,
    AggMethods,
    FillValues,
    InterpMethods,
    RecoverNans,
)
from xcube_resampling_tpu.gridmapping import GridMapping
from xcube_resampling_tpu.spatial import choose_route
from xcube_resampling_tpu.xrlite import Dataset

from .reproject import reproject_dataset

_NOT_PORTED = {
    "affine": "ROADMAP queue 1 item 5",
    "rectify": "ROADMAP queue 1 items 7-8",
}


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
) -> Dataset:
    """Resample the spatial dimensions of a dataset to a target grid
    mapping; arguments as ``xcube_resampling_tpu.resample_in_space``.
    Variables that are torch tensors stay on their device."""
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
    if route in _NOT_PORTED:
        raise NotImplementedError(
            f"the {route} route is not ported yet: {_NOT_PORTED[route]}"
        )
    return reproject_dataset(
        source_ds,
        target_gm,
        source_gm=source_gm,
        variables=variables,
        interp_methods=interp_methods,
        agg_methods=agg_methods,
        recover_nans=recover_nans,
        fill_values=fill_values,
    )
