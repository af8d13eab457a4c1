"""Native CRS engine: CRS model, projections, transformers.

Replaces the reference's pyproj dependency with pure array math in float64
numpy on the host.  Copy of ``xcube_resampling_tpu/crs`` without the
``jax.numpy`` dispatch.
"""

from .core import CRS, CRSError, CRS_CRS84, CRS_WGS84
from .datum import Ellipsoid, GRS80, SPHERE, WGS84
from .transformer import Transformer

__all__ = [
    "CRS",
    "CRSError",
    "CRS_CRS84",
    "CRS_WGS84",
    "Ellipsoid",
    "GRS80",
    "SPHERE",
    "WGS84",
    "Transformer",
]
