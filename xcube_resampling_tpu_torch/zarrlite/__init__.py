"""zarrlite — minimal zarr v2 storage layer.

Copy of ``xcube_resampling_tpu/zarrlite`` (numpy and zlib only), so that
the port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds it equal to its original.

Replaces the reference's `zarr` dependency for the store-level helper
``add_spatial_ref`` (reference gridmapping/cfconv.py:320-358) and gives the
framework tile-granular persistence: every chunk is an independent object in
the store, so interrupted jobs resume by recomputing only missing tiles
(the rebuild's checkpoint/resume story — SURVEY.md §5).

Supported: zarr v2 layout (.zgroup/.zarray/.zattrs/.zmetadata JSON docs,
C-order chunks); chunk compression raw, zlib, gzip, zstd, lz4 and blosc
(lz4/lz4hc/zstd/zlib inner codecs with byte-shuffle — the numcodecs
default — via the dependency-free decoder in .codecs); directory,
in-memory dict and read-only zip stores.
"""

from .core import (
    Array,
    DirectoryStore,
    ZipStore,
    Group,
    MemoryStore,
    consolidate_metadata,
    group,
    open as open,  # noqa: A001
    open_dataset,
    write_dataset,
)
from .lazy import LazyArray
from .spatial import add_spatial_ref

__all__ = [
    "Array",
    "DirectoryStore",
    "Group",
    "LazyArray",
    "MemoryStore",
    "ZipStore",
    "add_spatial_ref",
    "consolidate_metadata",
    "group",
    "open",
    "open_dataset",
    "write_dataset",
]
