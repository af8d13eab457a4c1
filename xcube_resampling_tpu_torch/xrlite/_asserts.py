"""Assertion helpers for xrlite objects (xarray.testing equivalent)."""

from __future__ import annotations

import numpy as np

from .dataarray import DataArray
from .dataset import Dataset


def assert_equal(actual, expected):
    if isinstance(expected, Dataset):
        assert isinstance(actual, Dataset), f"expected Dataset, got {type(actual)}"
        assert set(actual.data_vars) == set(expected.data_vars), (
            f"data_vars differ: {set(actual.data_vars)} != {set(expected.data_vars)}"
        )
        assert set(actual.coords) == set(expected.coords), (
            f"coords differ: {set(actual.coords)} != {set(expected.coords)}"
        )
        for name in expected.variables:
            assert_equal(actual.variables[name], expected.variables[name])
    elif isinstance(expected, DataArray):
        assert isinstance(actual, DataArray), f"expected DataArray, got {type(actual)}"
        assert actual.dims == expected.dims, (
            f"dims differ: {actual.dims} != {expected.dims}"
        )
        np.testing.assert_array_equal(actual.values, expected.values)
    else:
        np.testing.assert_array_equal(np.asarray(actual), np.asarray(expected))


def assert_allclose(actual, expected, rtol=1e-05, atol=1e-08):
    if isinstance(expected, (Dataset,)):
        for name in expected.variables:
            assert_allclose(actual.variables[name], expected.variables[name], rtol, atol)
    else:
        np.testing.assert_allclose(
            np.asarray(actual), np.asarray(expected), rtol=rtol, atol=atol
        )
