"""xcube_resampling_tpu_torch — the PyTorch/CUDA port of xcube_resampling_tpu.

Datasets resample on an NVIDIA Hopper GPU through CUDA kernels written for
it (``csrc/``, built with ``nvcc`` at first use); tensors on the CPU go
through the kernels' plain PyTorch versions.  The host layers (CRS engine,
grid mappings, the ``xrlite`` data model, the numpy planners) are copies
of the JAX package's, under the same module names; this package imports
neither JAX nor the JAX package.
"""

from .version import version

__version__ = version

from .affine import affine_transform_dataset, resample_dataset
from .crs import CRS, CRS_CRS84, CRS_WGS84, Transformer
from .gridmapping import GridMapping
from .rectify import rectify_dataset
from .reproject import reproject_dataset
from .spatial import resample_in_space
from .xrlite import DataArray, Dataset

__all__ = [
    "CRS",
    "CRS_CRS84",
    "CRS_WGS84",
    "DataArray",
    "Dataset",
    "GridMapping",
    "Transformer",
    "affine_transform_dataset",
    "rectify_dataset",
    "reproject_dataset",
    "resample_dataset",
    "resample_in_space",
    "version",
]
