"""Per-variable option resolution for torch-backed variables.

The JAX package's resolvers (``xcube_resampling_tpu/utils.py:162-303``)
key defaults and mappings on ``var.dtype`` as a numpy dtype, which a
torch-backed ``DataArray`` cannot give.  These wrappers hand them a
data-less stand-in carrying the mapped numpy dtype.
"""

from __future__ import annotations

from collections.abc import Hashable

import numpy as np
import torch

from xcube_resampling_tpu import utils as _utils
from xcube_resampling_tpu.xrlite import DataArray

from ._device import numpy_dtype


def _typed(var: DataArray) -> DataArray:
    """*var* itself, or for torch data an empty numpy stand-in of the
    mapped dtype with the same dims."""
    if not isinstance(var.data, torch.Tensor):
        return var
    empty = np.empty((0,) * var.ndim, dtype=numpy_dtype(var.data.dtype))
    return DataArray(empty, dims=var.dims, name=var.name)


def _get_fill_value(fill_values, key: Hashable, var: DataArray):
    return _utils._get_fill_value(fill_values, key, _typed(var))


def _get_interp_method_str(interp_methods, key: Hashable, var: DataArray) -> str:
    return _utils._get_interp_method_str(interp_methods, key, _typed(var))
