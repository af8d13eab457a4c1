"""xcube_resampling_tpu_torch — the PyTorch/CUDA port of xcube_resampling_tpu.

Datasets whose variables are ``torch.Tensor``s resample on the tensors'
device: on an NVIDIA Hopper GPU through CUDA kernels written for it
(``csrc/``, built with ``nvcc`` at first use), on the CPU through their
plain PyTorch versions.  The host layers (CRS engine, grid mappings, the
``xrlite`` data model, the numpy planners) are the JAX package's own; this
package never imports JAX.
"""

from xcube_resampling_tpu.crs import CRS
from xcube_resampling_tpu.gridmapping import GridMapping
from xcube_resampling_tpu.xrlite import DataArray, Dataset

from .spatial import resample_in_space

__all__ = ["CRS", "DataArray", "Dataset", "GridMapping", "resample_in_space"]
