"""Multi-device and out-of-core execution: device meshes, tile batches,
row bands with halo exchange, and the tile stream into a zarr store.

Port of ``xcube_resampling_tpu/parallel``: :func:`sharded_reproject` runs
the band forms of K1 and K2 (the sharded SRW), of K13 (the sharded exact
separable warp, :func:`make_sharded_esw_step`) past the two-pass gate, or
of K3 (the sharded regrid) where the ESW refuses, on the row bands of a
:class:`.mesh.Mesh` (``make_mesh(devices=[torch.device("cpu")] * n)`` on
the CPU, every CUDA device by default); :func:`sharded_rectify` runs
rectify's Phase A banded over the mesh (:func:`sharded_phase_a`: the hybrid
seed and dense kernels, K11 and K12) and its Phase B through K7's band form
(:func:`make_sharded_rectify_step`); :func:`resample_to_store` resamples
tile by tile into a resumable zarr store.
"""

from .halo import (
    make_sharded_esw_step,
    make_sharded_rectify_step,
    make_sharded_regrid_step,
    make_sharded_srw_step,
    sharded_phase_a,
    sharded_rectify,
    sharded_reproject,
)
from .mesh import Mesh, make_mesh
from .stream import resample_to_store
from .tiling import Sharded, TileBatch, batch_tiles, untile

__all__ = [
    "Mesh",
    "Sharded",
    "TileBatch",
    "batch_tiles",
    "make_mesh",
    "make_sharded_esw_step",
    "make_sharded_rectify_step",
    "make_sharded_regrid_step",
    "make_sharded_srw_step",
    "resample_to_store",
    "sharded_phase_a",
    "sharded_rectify",
    "sharded_reproject",
    "untile",
]
