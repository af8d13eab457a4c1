"""Grid-mapping layer: CRS + image-grid geometry model.

Public surface mirrors the reference package
(xcube_resampling/gridmapping/__init__.py:22-24).
"""

from ..crs import CRS_CRS84 as CRS_CRS84
from ..crs import CRS_WGS84 as CRS_WGS84
from .base import GridMapping as GridMapping
from .base import CRS84 as CRS84
from .base import DEFAULT_TOLERANCE as DEFAULT_TOLERANCE
