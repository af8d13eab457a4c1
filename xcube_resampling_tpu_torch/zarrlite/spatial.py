"""Store-level CRS patcher (reference gridmapping/cfconv.py:320-358 parity)."""

from __future__ import annotations

from collections.abc import MutableMapping

import numpy as np

from ..crs import CRS
from ..gridmapping.assertions import assert_instance
from .core import consolidate_metadata, open as zarr_open


def add_spatial_ref(
    dataset_store,
    crs: CRS,
    crs_var_name: str = "spatial_ref",
    xy_dim_names: tuple[str, str] | None = None,
):
    """Add a spatial reference to an existing zarr store.

    Args:
        dataset_store: The dataset's existing store (mapping or path).
        crs: The spatial coordinate reference system.
        crs_var_name: Name of the variable holding the spatial reference.
        xy_dim_names: Names of the x and y dimensions; default ("x", "y").
    """
    from pathlib import Path

    assert_instance(dataset_store, (MutableMapping, str, Path), name="group_store")
    assert_instance(crs_var_name, str, name="crs_var_name")
    x_dim_name, y_dim_name = xy_dim_names or ("x", "y")

    spatial_attrs = crs.to_cf()
    spatial_attrs["_ARRAY_DIMENSIONS"] = []  # Required by xarray
    group = zarr_open(dataset_store, mode="r+")
    spatial_ref = group.array(crs_var_name, 0, shape=(), dtype=np.uint8, fill_value=0)
    spatial_ref.attrs.update(**spatial_attrs)

    for item_name, item in group.items():
        if item_name != crs_var_name:
            dims = item.attrs.get("_ARRAY_DIMENSIONS")
            if (
                dims
                and len(dims) >= 2
                and dims[-2] == y_dim_name
                and dims[-1] == x_dim_name
            ):
                item.attrs["grid_mapping"] = crs_var_name

    consolidate_metadata(dataset_store)
