"""Coordinate transformer between two CRSs (pyproj.Transformer parity).

Unlike the reference, whose transforms are opaque C-library calls confined to
the host (reference: xcube_resampling/reproject.py:124-126,
472-496, rectify.py:196-213), a :class:`Transformer` here is a pure array
function pipeline — source inverse projection to the geographic (lon, lat)
hub, then target forward projection.  It runs on float64 numpy on the host
for golden-accurate index math.
"""

from __future__ import annotations

import logging

import numpy as np

from .core import CRS
from .datum import (
    geocentric_to_geodetic,
    geodetic_to_geocentric,
    helmert7,
    normalize_datum_name,
    towgs84_for_datum,
)

LOG = logging.getLogger("xcube.resampling")

_WARNED_DATUM_PAIRS: set[tuple[str, str]] = set()


def _effective_towgs84(crs: CRS):
    if crs.towgs84 is not None:
        return crs.towgs84
    return towgs84_for_datum(crs.datum_name)


def _make_datum_shift(src: CRS, dst: CRS):
    """Geographic-hub datum step (lon, lat, xp) -> (lon, lat), or None when
    the datums are coincident / treated as coincident.

    Known datums (explicit towgs84 or the registry in crs.datum) get the
    7-parameter Helmert pipeline through geocentric space; unknown datum
    pairs warn once and fall back to coincident — the reference's PROJ
    backend does the equivalent "ballpark" transformation, also with a
    warning."""
    if normalize_datum_name(src.datum_name) == normalize_datum_name(
        dst.datum_name
    ) and src.towgs84 == dst.towgs84:
        return None
    src_t = _effective_towgs84(src)
    dst_t = _effective_towgs84(dst)
    if src_t is None or dst_t is None:
        pair = (src.datum_name, dst.datum_name)
        if pair not in _WARNED_DATUM_PAIRS:
            _WARNED_DATUM_PAIRS.add(pair)
            LOG.warning(
                "no datum transform known between %r and %r: treating the "
                "datums as coincident (positions may be offset by the "
                "datum difference)",
                src.datum_name,
                dst.datum_name,
            )
        return None
    same_transform = tuple(src_t) == tuple(dst_t)
    same_ellipsoid = (
        abs(src.ellipsoid.a - dst.ellipsoid.a) < 1e-6
        and abs(src.ellipsoid.inverse_flattening - dst.ellipsoid.inverse_flattening)
        < 1e-6
    )
    if same_transform and (same_ellipsoid or not any(src_t)):
        # coincident realizations of the same frame (e.g. WGS84/ETRS89/
        # NAD83): sub-metre, treated as identical by design
        return None
    src_ell, dst_ell = src.ellipsoid, dst.ellipsoid

    def shift(lon, lat, xp):
        x, y, z = geodetic_to_geocentric(lon, lat, src_ell, xp)
        if any(src_t):
            x, y, z = helmert7(x, y, z, src_t, xp)
        if any(dst_t):
            x, y, z = helmert7(x, y, z, dst_t, xp, inverse=True)
        return geocentric_to_geodetic(x, y, z, dst_ell, xp)

    return shift


class Transformer:
    """Transforms (x, y) coordinates from *src* CRS to *dst* CRS.

    Always operates in xy (easting/longitude first) order, matching the
    reference's universal use of ``always_xy=True``.  Cross-datum pairs
    with known 7-parameter transforms route through a Helmert geocentric
    step; unknown pairs warn and are treated as coincident.
    """

    def __init__(self, src: CRS, dst: CRS):
        self.src = src
        self.dst = dst
        self._datum_shift = None if src == dst else _make_datum_shift(src, dst)
        # plain (non-derived) geographic <-> geographic on a shared datum
        # is an identity
        self._identity = self._datum_shift is None and (
            (src.proj_name is None and dst.proj_name is None) or src == dst
        )
        _, self._src_inv = src.projection()
        self._dst_fwd, _ = dst.projection()

    @classmethod
    def from_crs(cls, src, dst, always_xy: bool = True) -> "Transformer":
        return cls(CRS.from_user_input(src), CRS.from_user_input(dst))

    @property
    def is_identity(self) -> bool:
        return self._identity

    def transform(self, x, y, xp=None):
        """Transform arrays (or scalars) of x, y coordinates."""
        scalar = np.isscalar(x) or (hasattr(x, "ndim") and x.ndim == 0)
        if xp is None:
            xp = np
        if xp is np:
            x = np.asarray(x, dtype=np.float64)
            y = np.asarray(y, dtype=np.float64)
        if self._identity:
            out = x, y
        else:
            lon, lat = self._src_inv(x, y, xp)
            if self._datum_shift is not None:
                lon, lat = self._datum_shift(lon, lat, xp)
            out = self._dst_fwd(lon, lat, xp)
        if scalar and xp is np:
            return float(out[0]), float(out[1])
        return out

    def transform_fn(self):
        """Return a pure ``(x, y, xp) -> (x2, y2)`` array function."""
        if self._identity:
            return lambda x, y, xp: (x, y)
        src_inv, dst_fwd = self._src_inv, self._dst_fwd
        datum_shift = self._datum_shift

        def fn(x, y, xp):
            lon, lat = src_inv(x, y, xp)
            if datum_shift is not None:
                lon, lat = datum_shift(lon, lat, xp)
            return dst_fwd(lon, lat, xp)

        return fn

    def transform_bounds(
        self,
        left: float,
        bottom: float,
        right: float,
        top: float,
        densify_pts: int = 21,
    ) -> tuple[float, float, float, float]:
        """Transform a bounding box by densifying its edges
        (pyproj.Transformer.transform_bounds parity; used at reference
        reproject.py:347, 398 and transform.py:91)."""
        n = max(2, int(densify_pts))
        xs = np.linspace(left, right, n)
        ys = np.linspace(bottom, top, n)
        edge_x = np.concatenate(
            [xs, xs, np.full(n, left), np.full(n, right)]
        )
        edge_y = np.concatenate(
            [np.full(n, bottom), np.full(n, top), ys, ys]
        )
        tx, ty = self.transform(edge_x, edge_y)
        tx = np.asarray(tx, dtype=np.float64)
        ty = np.asarray(ty, dtype=np.float64)
        return (
            float(np.nanmin(tx)),
            float(np.nanmin(ty)),
            float(np.nanmax(tx)),
            float(np.nanmax(ty)),
        )
