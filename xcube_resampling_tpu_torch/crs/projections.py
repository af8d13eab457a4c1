"""Map-projection forward/inverse formulas as dtype-generic array functions.

Every projection is exposed as ``make_<name>(params, ellipsoid)`` returning a
``(forward, inverse)`` pair of closures::

    x, y = forward(lon_deg, lat_deg, xp)   # xp is numpy
    lon, lat = inverse(x, y, xp)

All derived constants (series coefficients, origin offsets) are precomputed
as Python floats at construction time, so the closures are plain element-wise
code, evaluated in float64 numpy on the host for golden-accurate index math.

Formulas follow Karney (2011) for the transverse Mercator (6th-order Krüger
series, sub-nanometer accuracy) and Snyder (1987) / the EPSG guidance notes
for the others.  This module replaces the reference's dependency on the PROJ
C library (reference: xcube_resampling/reproject.py:124-126,
rectify.py:196-198 use pyproj.Transformer).
"""

from __future__ import annotations

import math

from .datum import Ellipsoid

__all__ = ["make_projection", "PROJECTION_FACTORIES"]


def _d2r(xp, deg):
    return deg * (math.pi / 180.0)


def _r2d(xp, rad):
    return rad * (180.0 / math.pi)


def _authalic_to_geodetic(beta, e2: float, xp):
    """Geodetic latitude from authalic latitude via the standard series
    (Snyder 3-18): three sine terms, ~1e-10 rad for earth ellipsoids —
    replaces per-element Newton iterations whose log/sin per step made
    host inverse transforms ~4x the forward cost."""
    if e2 == 0:
        return beta
    e4 = e2 * e2
    e6 = e4 * e2
    c2 = e2 / 3.0 + 31.0 * e4 / 180.0 + 517.0 * e6 / 5040.0
    c4 = 23.0 * e4 / 360.0 + 251.0 * e6 / 3780.0
    c6 = 761.0 * e6 / 45360.0
    return (
        beta
        + c2 * xp.sin(2.0 * beta)
        + c4 * xp.sin(4.0 * beta)
        + c6 * xp.sin(6.0 * beta)
    )


def _conformal_to_geodetic(chi, e2: float, xp):
    """Geodetic latitude from conformal latitude via the standard series
    (Snyder 3-5), ~1e-10 rad for earth ellipsoids."""
    if e2 == 0:
        return chi
    e4 = e2 * e2
    e6 = e4 * e2
    e8 = e6 * e2
    c2 = e2 / 2.0 + 5.0 * e4 / 24.0 + e6 / 12.0 + 13.0 * e8 / 360.0
    c4 = 7.0 * e4 / 48.0 + 29.0 * e6 / 240.0 + 811.0 * e8 / 11520.0
    c6 = 7.0 * e6 / 120.0 + 81.0 * e8 / 1120.0
    c8 = 4279.0 * e8 / 161280.0
    return (
        chi
        + c2 * xp.sin(2.0 * chi)
        + c4 * xp.sin(4.0 * chi)
        + c6 * xp.sin(6.0 * chi)
        + c8 * xp.sin(8.0 * chi)
    )


# ---------------------------------------------------------------------------
# Transverse Mercator (Karney / Krüger series)
# ---------------------------------------------------------------------------


def _tm_alpha_beta(n: float) -> tuple[list[float], list[float]]:
    n2, n3, n4, n5, n6 = n * n, n**3, n**4, n**5, n**6
    alpha = [
        n / 2 - 2 * n2 / 3 + 5 * n3 / 16 + 41 * n4 / 180 - 127 * n5 / 288
        + 7891 * n6 / 37800,
        13 * n2 / 48 - 3 * n3 / 5 + 557 * n4 / 1440 + 281 * n5 / 630
        - 1983433 * n6 / 1935360,
        61 * n3 / 240 - 103 * n4 / 140 + 15061 * n5 / 26880 + 167603 * n6 / 181440,
        49561 * n4 / 161280 - 179 * n5 / 168 + 6601661 * n6 / 7257600,
        34729 * n5 / 80640 - 3418889 * n6 / 1995840,
        212378941 * n6 / 319334400,
    ]
    beta = [
        n / 2 - 2 * n2 / 3 + 37 * n3 / 96 - n4 / 360 - 81 * n5 / 512
        + 96199 * n6 / 604800,
        n2 / 48 + n3 / 15 - 437 * n4 / 1440 + 46 * n5 / 105 - 1118711 * n6 / 3870720,
        17 * n3 / 480 - 37 * n4 / 840 - 209 * n5 / 4480 + 5569 * n6 / 90720,
        4397 * n4 / 161280 - 11 * n5 / 504 - 830251 * n6 / 7257600,
        4583 * n5 / 161280 - 108847 * n6 / 3991680,
        20648693 * n6 / 638668800,
    ]
    return alpha, beta


def make_transverse_mercator(params: dict, ell: Ellipsoid):
    k0 = float(params.get("scale_factor_at_central_meridian", 1.0))
    lon0 = float(
        params.get(
            "longitude_of_central_meridian",
            params.get("longitude_of_projection_origin", 0.0),
        )
    )
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, f = ell.a, ell.f
    e = ell.e
    n = ell.n
    big_a = a / (1 + n) * (1 + n * n / 4 + n**4 / 64 + n**6 / 256)
    alpha, beta = _tm_alpha_beta(n)
    lon0_rad = math.radians(lon0)

    def _xi_eta(lon_rad, lat_rad, xp):
        sphi = xp.sin(lat_rad)
        if e > 0:
            t = xp.sinh(
                xp.arcsinh(xp.tan(lat_rad)) - e * xp.arctanh(e * sphi)
            )
        else:
            t = xp.tan(lat_rad)
        dlam = lon_rad - lon0_rad
        # wrap to [-pi, pi]
        dlam = (dlam + math.pi) % (2 * math.pi) - math.pi
        cos_l = xp.cos(dlam)
        xi_p = xp.arctan2(t, cos_l)
        eta_p = xp.arcsinh(xp.sin(dlam) / xp.sqrt(t * t + cos_l * cos_l))
        xi = xi_p
        eta = eta_p
        for j, aj in enumerate(alpha, start=1):
            xi = xi + aj * xp.sin(2 * j * xi_p) * xp.cosh(2 * j * eta_p)
            eta = eta + aj * xp.cos(2 * j * xi_p) * xp.sinh(2 * j * eta_p)
        return xi, eta

    # northing offset so that lat0 maps to northing fn
    if lat0 != 0.0:
        import numpy as _np

        xi0, _ = _xi_eta(_np.array(lon0_rad), _np.array(math.radians(lat0)), _np)
        m0 = k0 * big_a * float(xi0)
    else:
        m0 = 0.0

    def forward(lon, lat, xp):
        lon_rad = _d2r(xp, lon)
        lat_rad = _d2r(xp, lat)
        xi, eta = _xi_eta(lon_rad, lat_rad, xp)
        x = fe + k0 * big_a * eta
        y = fn - m0 + k0 * big_a * xi
        return x, y

    def inverse(x, y, xp):
        eta = (x - fe) / (k0 * big_a)
        xi = (y - fn + m0) / (k0 * big_a)
        xi_p = xi
        eta_p = eta
        for j, bj in enumerate(beta, start=1):
            xi_p = xi_p - bj * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
            eta_p = eta_p - bj * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)
        sinh_eta = xp.sinh(eta_p)
        cos_xi = xp.cos(xi_p)
        tau_p = xp.sin(xi_p) / xp.sqrt(sinh_eta * sinh_eta + cos_xi * cos_xi)
        lam = xp.arctan2(sinh_eta, cos_xi)
        # invert the conformal latitude by the standard series
        phi = _conformal_to_geodetic(xp.arctan(tau_p), e * e, xp)
        lon = _r2d(xp, lam + lon0_rad)
        lat = _r2d(xp, phi)
        return lon, lat

    return forward, inverse


# ---------------------------------------------------------------------------
# Lambert Azimuthal Equal Area (ellipsoidal, Snyder 1987 §24 / EPSG 9820)
# ---------------------------------------------------------------------------


def make_lambert_azimuthal_equal_area(params: dict, ell: Ellipsoid):
    lon0 = float(params.get("longitude_of_projection_origin", 0.0))
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e, e2 = ell.a, ell.e, ell.e2
    lam0 = math.radians(lon0)
    phi0 = math.radians(lat0)

    def _q_scalar(phi: float) -> float:
        s = math.sin(phi)
        if e == 0:
            return 2.0 * s
        return (1 - e2) * (
            s / (1 - e2 * s * s) - (1 / (2 * e)) * math.log((1 - e * s) / (1 + e * s))
        )

    qp = _q_scalar(math.pi / 2)
    q0 = _q_scalar(phi0)
    beta0 = math.asin(min(1.0, max(-1.0, q0 / qp)))
    rq = a * math.sqrt(qp / 2.0)
    d = (
        a
        * math.cos(phi0)
        / math.sqrt(1 - e2 * math.sin(phi0) ** 2)
        / (rq * math.cos(beta0))
        if abs(math.cos(beta0)) > 1e-12
        else 1.0
    )
    sin_b0, cos_b0 = math.sin(beta0), math.cos(beta0)

    def _q(phi, xp):
        s = xp.sin(phi)
        if e == 0:
            return 2.0 * s
        return (1 - e2) * (
            s / (1 - e2 * s * s) - (1 / (2 * e)) * xp.log((1 - e * s) / (1 + e * s))
        )

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        q = _q(phi, xp)
        beta = xp.arcsin(xp.clip(q / qp, -1.0, 1.0))
        sin_b, cos_b = xp.sin(beta), xp.cos(beta)
        dlam = lam - lam0
        dlam = (dlam + math.pi) % (2 * math.pi) - math.pi
        cos_dl, sin_dl = xp.cos(dlam), xp.sin(dlam)
        denom = 1.0 + sin_b0 * sin_b + cos_b0 * cos_b * cos_dl
        b = rq * xp.sqrt(2.0 / denom)
        x = fe + b * d * cos_b * sin_dl
        y = fn + (b / d) * (cos_b0 * sin_b - sin_b0 * cos_b * cos_dl)
        return x, y

    def inverse(x, y, xp):
        xr = (x - fe) / d
        yr = d * (y - fn)
        rho = xp.sqrt(xr * xr + yr * yr)
        rho_safe = xp.where(rho == 0, 1.0, rho)
        c = 2.0 * xp.arcsin(xp.clip(rho / (2.0 * rq), -1.0, 1.0))
        sin_c, cos_c = xp.sin(c), xp.cos(c)
        beta = xp.where(
            rho == 0,
            beta0,
            xp.arcsin(
                xp.clip(cos_c * sin_b0 + yr * sin_c * cos_b0 / rho_safe, -1.0, 1.0)
            ),
        )
        lam = lam0 + xp.arctan2(
            xr * sin_c, rho_safe * cos_b0 * cos_c - yr * sin_b0 * sin_c
        )
        lam = xp.where(rho == 0, lam0, lam)
        # latitude from authalic latitude by the standard series
        # (Snyder 3-18): three sine terms, ~1e-10 rad for earth
        # ellipsoids — replaces a 6-step Newton iteration whose per-step
        # log/sin made the host inverse ~4x the forward's cost
        if e > 0:
            e4 = e2 * e2
            e6 = e4 * e2
            c2 = e2 / 3.0 + 31.0 * e4 / 180.0 + 517.0 * e6 / 5040.0
            c4 = 23.0 * e4 / 360.0 + 251.0 * e6 / 3780.0
            c6 = 761.0 * e6 / 45360.0
            phi = (
                beta
                + c2 * xp.sin(2.0 * beta)
                + c4 * xp.sin(4.0 * beta)
                + c6 * xp.sin(6.0 * beta)
            )
        else:
            phi = beta
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Mercator (spherical variant used by EPSG:3857, ellipsoidal by EPSG:3395)
# ---------------------------------------------------------------------------


def make_mercator(params: dict, ell: Ellipsoid):
    lon0 = float(params.get("longitude_of_projection_origin", 0.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    spherical = bool(params.get("_spherical", False))
    a, e = ell.a, ell.e
    lam0 = math.radians(lon0)

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        x = fe + a * (lam - lam0)
        if spherical or e == 0:
            y = fn + a * xp.log(xp.tan(math.pi / 4 + phi / 2))
        else:
            es = e * xp.sin(phi)
            y = fn + a * xp.log(
                xp.tan(math.pi / 4 + phi / 2) * ((1 - es) / (1 + es)) ** (e / 2)
            )
        return x, y

    def inverse(x, y, xp):
        lam = lam0 + (x - fe) / a
        t = xp.exp(-(y - fn) / a)
        phi = math.pi / 2 - 2 * xp.arctan(t)
        if not (spherical or e == 0):
            phi = _conformal_to_geodetic(phi, e * e, xp)
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Rotated lat/lon (CF rotated_latitude_longitude) — spherical rotation
# ---------------------------------------------------------------------------


def make_rotated_latitude_longitude(params: dict, ell: Ellipsoid):
    pole_lat = math.radians(float(params.get("grid_north_pole_latitude", 90.0)))
    pole_lon = math.radians(float(params.get("grid_north_pole_longitude", 0.0)))
    # angle of rotation about the new pole
    lon_rot = math.radians(float(params.get("north_pole_grid_longitude", 0.0)))

    theta = math.pi / 2 - pole_lat  # rotation about y-axis
    sin_t, cos_t = math.sin(theta), math.cos(theta)

    def inverse(x, y, xp):
        # rotated (grid) coords -> true lon/lat, degrees in, degrees out
        lam = _d2r(xp, x) - lon_rot
        phi = _d2r(xp, y)
        cos_p = xp.cos(phi)
        xx = xp.cos(lam) * cos_p
        yy = xp.sin(lam) * cos_p
        zz = xp.sin(phi)
        x2 = cos_t * xx + sin_t * zz
        y2 = yy
        z2 = -sin_t * xx + cos_t * zz
        lat = xp.arcsin(xp.clip(z2, -1.0, 1.0))
        lon = xp.arctan2(y2, x2) + pole_lon + math.pi
        lon = (lon + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, lon), _r2d(xp, lat)

    def forward(lon, lat, xp):
        # true lon/lat -> rotated coords
        lam = _d2r(xp, lon) - pole_lon - math.pi
        phi = _d2r(xp, lat)
        cos_p = xp.cos(phi)
        xx = xp.cos(lam) * cos_p
        yy = xp.sin(lam) * cos_p
        zz = xp.sin(phi)
        x2 = cos_t * xx - sin_t * zz
        y2 = yy
        z2 = sin_t * xx + cos_t * zz
        rlat = xp.arcsin(xp.clip(z2, -1.0, 1.0))
        rlon = xp.arctan2(y2, x2) + lon_rot
        rlon = (rlon + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, rlon), _r2d(xp, rlat)

    return forward, inverse


# ---------------------------------------------------------------------------
# Lambert Conformal Conic (2SP, Snyder §15 / EPSG 9802)
# ---------------------------------------------------------------------------


def make_lambert_conformal_conic(params: dict, ell: Ellipsoid):
    sp = params.get("standard_parallel", params.get("latitude_of_projection_origin", 0.0))
    if isinstance(sp, (list, tuple)):
        sp1, sp2 = float(sp[0]), float(sp[-1])
    else:
        sp1 = sp2 = float(sp)
    lat0 = float(params.get("latitude_of_projection_origin", sp1))
    lon0 = float(params.get("longitude_of_central_meridian",
                            params.get("longitude_of_projection_origin", 0.0)))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e = ell.a, ell.e
    lam0 = math.radians(lon0)

    def _m(phi: float) -> float:
        return math.cos(phi) / math.sqrt(1 - (e * math.sin(phi)) ** 2)

    def _t_scalar(phi: float) -> float:
        es = e * math.sin(phi)
        return math.tan(math.pi / 4 - phi / 2) / ((1 - es) / (1 + es)) ** (e / 2)

    p1, p2, p0 = map(math.radians, (sp1, sp2, lat0))
    m1, m2 = _m(p1), _m(p2)
    t1, t2, t0 = _t_scalar(p1), _t_scalar(p2), _t_scalar(p0)
    if abs(p1 - p2) > 1e-10:
        n_c = (math.log(m1) - math.log(m2)) / (math.log(t1) - math.log(t2))
    else:
        n_c = math.sin(p1)
    big_f = m1 / (n_c * t1**n_c)
    rho0 = a * big_f * t0**n_c

    def _t(phi, xp):
        es = e * xp.sin(phi)
        return xp.tan(math.pi / 4 - phi / 2) / ((1 - es) / (1 + es)) ** (e / 2)

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        rho = a * big_f * _t(phi, xp) ** n_c
        gamma = n_c * ((lam - lam0 + math.pi) % (2 * math.pi) - math.pi)
        x = fe + rho * xp.sin(gamma)
        y = fn + rho0 - rho * xp.cos(gamma)
        return x, y

    def inverse(x, y, xp):
        xr = x - fe
        yr = rho0 - (y - fn)
        rho = xp.sqrt(xr * xr + yr * yr) * (1 if n_c >= 0 else -1)
        t = (rho / (a * big_f)) ** (1.0 / n_c)
        gamma = xp.arctan2(xr, yr)
        lam = gamma / n_c + lam0
        phi = _conformal_to_geodetic(math.pi / 2 - 2 * xp.arctan(t), e * e, xp)
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Albers Equal Area (Snyder §14 / EPSG 9822)
# ---------------------------------------------------------------------------


def make_albers_conical_equal_area(params: dict, ell: Ellipsoid):
    sp = params.get("standard_parallel", 0.0)
    if isinstance(sp, (list, tuple)):
        sp1, sp2 = float(sp[0]), float(sp[-1])
    else:
        sp1 = sp2 = float(sp)
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    lon0 = float(params.get("longitude_of_central_meridian",
                            params.get("longitude_of_projection_origin", 0.0)))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e, e2 = ell.a, ell.e, ell.e2
    lam0 = math.radians(lon0)

    def _q_scalar(phi: float) -> float:
        s = math.sin(phi)
        if e == 0:
            return 2.0 * s
        return (1 - e2) * (
            s / (1 - e2 * s * s) - (1 / (2 * e)) * math.log((1 - e * s) / (1 + e * s))
        )

    def _m(phi: float) -> float:
        return math.cos(phi) / math.sqrt(1 - (e * math.sin(phi)) ** 2)

    p1, p2, p0 = map(math.radians, (sp1, sp2, lat0))
    m1, m2 = _m(p1), _m(p2)
    q1, q2, q0 = _q_scalar(p1), _q_scalar(p2), _q_scalar(p0)
    if abs(p1 - p2) > 1e-10:
        n_c = (m1 * m1 - m2 * m2) / (q2 - q1)
    else:
        n_c = math.sin(p1)
    big_c = m1 * m1 + n_c * q1
    rho0 = a * math.sqrt(big_c - n_c * q0) / n_c

    def _q(phi, xp):
        s = xp.sin(phi)
        if e == 0:
            return 2.0 * s
        return (1 - e2) * (
            s / (1 - e2 * s * s) - (1 / (2 * e)) * xp.log((1 - e * s) / (1 + e * s))
        )

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        q = _q(phi, xp)
        rho = a * xp.sqrt(big_c - n_c * q) / n_c
        theta = n_c * ((lam - lam0 + math.pi) % (2 * math.pi) - math.pi)
        return fe + rho * xp.sin(theta), fn + rho0 - rho * xp.cos(theta)

    def inverse(x, y, xp):
        xr = x - fe
        yr = rho0 - (y - fn)
        rho = xp.sqrt(xr * xr + yr * yr)
        theta = xp.arctan2(xr, yr)
        q = (big_c - (rho * n_c / a) ** 2) / n_c
        lam = lam0 + theta / n_c
        if e > 0:
            qp = (1 - e2) * (
                1.0 / (1 - e2)
                - (1.0 / (2 * e)) * math.log((1 - e) / (1 + e))
            )
            beta = xp.arcsin(xp.clip(q / qp, -1.0, 1.0))
            phi = _authalic_to_geodetic(beta, e2, xp)
        else:
            phi = xp.arcsin(xp.clip(q / 2.0, -1.0, 1.0))
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Polar Stereographic (variant B, Snyder §21 / EPSG 9829)
# ---------------------------------------------------------------------------


def make_polar_stereographic(params: dict, ell: Ellipsoid):
    lat_ts = float(
        params.get(
            "standard_parallel", params.get("latitude_of_projection_origin", 90.0)
        )
    )
    lat0 = float(params.get("latitude_of_projection_origin", 90.0 if lat_ts > 0 else -90.0))
    lon0 = float(
        params.get(
            "straight_vertical_longitude_from_pole",
            params.get("longitude_of_projection_origin", 0.0),
        )
    )
    k0 = float(params.get("scale_factor_at_projection_origin", 1.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e = ell.a, ell.e
    south = lat0 < 0
    lam0 = math.radians(lon0)

    def _t_scalar(phi: float) -> float:
        es = e * math.sin(phi)
        return math.tan(math.pi / 4 - phi / 2) / ((1 - es) / (1 + es)) ** (e / 2)

    if abs(lat_ts) < 89.999:
        pts = math.radians(abs(lat_ts))
        m_ts = math.cos(pts) / math.sqrt(1 - (e * math.sin(pts)) ** 2)
        t_ts = _t_scalar(pts)
        scale = a * m_ts / t_ts
    else:
        scale = (
            2 * a * k0 / math.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e))
        )

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        if south:
            lam = -lam
            phi = -phi
            lam_off = -lam0
        else:
            lam_off = lam0
        es = e * xp.sin(phi)
        t = xp.tan(math.pi / 4 - phi / 2) / ((1 - es) / (1 + es)) ** (e / 2)
        rho = scale * t
        dlam = lam - lam_off
        x = rho * xp.sin(dlam)
        y = -rho * xp.cos(dlam)
        if south:
            x, y = -x, -y
        return fe + x, fn + y

    def inverse(x, y, xp):
        xr = x - fe
        yr = y - fn
        if south:
            xr, yr = -xr, -yr
        rho = xp.sqrt(xr * xr + yr * yr)
        t = rho / scale
        phi = _conformal_to_geodetic(math.pi / 2 - 2 * xp.arctan(t), e * e, xp)
        lam = (lam0 if not south else -lam0) + xp.arctan2(xr, -yr)
        if south:
            lam, phi = -lam, -phi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


def make_lambert_cylindrical_equal_area(params: dict, ell: Ellipsoid):
    """Lambert cylindrical equal-area, ellipsoidal (Snyder §10; the
    projection of the EASE-Grid 2.0 family, EPSG:6933).

    ``x = a k0 (lam - lam0)``, ``y = a q(phi) / (2 k0)`` with
    ``k0 = cos(phi_ts)/sqrt(1 - e^2 sin^2 phi_ts)``; the inverse recovers
    the geodetic latitude from the authalic ``q`` by the same Newton
    iteration as the other equal-area projections here."""
    lat_ts = float(
        params.get(
            "standard_parallel", params.get("latitude_of_true_scale", 0.0)
        )
    )
    lon0 = float(
        params.get(
            "longitude_of_central_meridian",
            params.get("longitude_of_projection_origin", 0.0),
        )
    )
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e, e2 = ell.a, ell.e, ell.e2
    lam0 = math.radians(lon0)
    pts = math.radians(lat_ts)
    k0 = math.cos(pts) / math.sqrt(1 - e2 * math.sin(pts) ** 2)

    def _q(phi, xp):
        s = xp.sin(phi)
        if e == 0:
            return 2.0 * s
        return (1 - e2) * (
            s / (1 - e2 * s * s)
            + (1 / (2 * e)) * xp.log((1 + e * s) / (1 - e * s))
        )

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        return fe + a * k0 * dlam, fn + a * _q(phi, xp) / (2.0 * k0)

    if e > 0:
        qp = (1 - e2) * (
            1.0 / (1 - e2) + (1 / (2 * e)) * math.log((1 + e) / (1 - e))
        )
    else:
        qp = 2.0

    def inverse(x, y, xp):
        lam = lam0 + (x - fe) / (a * k0)
        q = 2.0 * k0 * (y - fn) / a
        if e == 0:
            phi = xp.arcsin(xp.clip(q / 2.0, -1.0, 1.0))
        else:
            beta = xp.arcsin(xp.clip(q / qp, -1.0, 1.0))
            phi = _authalic_to_geodetic(beta, e2, xp)
        lam = (lam + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


def make_sinusoidal(params: dict, ell: Ellipsoid):
    """Sinusoidal (Sanson-Flamsteed) projection, ellipsoidal (Snyder
    SS30) — the projection of the MODIS land grid
    (``+proj=sinu +R=6371007.181``).

    ``x = a dlam cos(phi)/sqrt(1 - e^2 sin^2 phi)``, ``y = M(phi)`` the
    meridional arc; the inverse recovers ``phi`` from the rectifying
    latitude by the standard Snyder series (exact for the sphere, where
    ``y = a phi``)."""
    lon0 = float(
        params.get(
            "longitude_of_projection_origin",
            params.get("longitude_of_central_meridian", 0.0),
        )
    )
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e2 = ell.a, ell.e2
    e4, e6 = e2 * e2, e2 ** 3
    lam0 = math.radians(lon0)
    m0 = 1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256
    m2 = 3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024
    m4 = 15 * e4 / 256 + 45 * e6 / 1024
    m6 = 35 * e6 / 3072

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        x = a * dlam * xp.cos(phi) / xp.sqrt(1 - e2 * xp.sin(phi) ** 2)
        y = a * (
            m0 * phi
            - m2 * xp.sin(2 * phi)
            + m4 * xp.sin(4 * phi)
            - m6 * xp.sin(6 * phi)
        )
        return fe + x, fn + y

    sqrt1me2 = math.sqrt(1 - e2)
    e1 = (1 - sqrt1me2) / (1 + sqrt1me2)
    e1_2, e1_3, e1_4 = e1 * e1, e1 ** 3, e1 ** 4
    p2 = 3 * e1 / 2 - 27 * e1_3 / 32
    p4 = 21 * e1_2 / 16 - 55 * e1_4 / 32
    p6 = 151 * e1_3 / 96
    p8 = 1097 * e1_4 / 512

    def inverse(x, y, xp):
        mu = (y - fn) / (a * m0)
        phi = (
            mu
            + p2 * xp.sin(2 * mu)
            + p4 * xp.sin(4 * mu)
            + p6 * xp.sin(6 * mu)
            + p8 * xp.sin(8 * mu)
        )
        cosphi = xp.cos(phi)
        # meridians converge at the poles: dlam is indeterminate there
        polar = xp.abs(cosphi) < 1e-12
        denom = a * xp.where(polar, 1.0, cosphi) / xp.sqrt(
            1 - e2 * xp.sin(phi) ** 2
        )
        dlam = xp.where(polar, 0.0, (x - fe) / denom)
        lam = (lam0 + dlam + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Stereographic, oblique / equatorial (Snyder SS21, ellipsoidal)
# ---------------------------------------------------------------------------


def make_stereographic(params: dict, ell: Ellipsoid):
    """General stereographic: polar centers delegate to the polar variant;
    oblique/equatorial centers use Snyder's conformal-latitude formulation
    (Snyder 21-27..21-39) — PROJ's ``+proj=stere`` semantics.

    The reference accepts these through PROJ
    (xcube_resampling/reproject.py:124-126)."""
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    if abs(lat0) >= 89.999:
        return make_polar_stereographic(params, ell)
    lon0 = float(params.get("longitude_of_projection_origin", 0.0))
    k0 = float(params.get("scale_factor_at_projection_origin", 1.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e, e2 = ell.a, ell.e, ell.e2
    lam0 = math.radians(lon0)
    phi1 = math.radians(lat0)

    def _chi_scalar(phi: float) -> float:
        es = e * math.sin(phi)
        return (
            2.0
            * math.atan(
                math.tan(math.pi / 4 + phi / 2)
                * ((1 - es) / (1 + es)) ** (e / 2)
            )
            - math.pi / 2
        )

    chi1 = _chi_scalar(phi1)
    sin_chi1, cos_chi1 = math.sin(chi1), math.cos(chi1)
    m1 = math.cos(phi1) / math.sqrt(1 - e2 * math.sin(phi1) ** 2)
    ak = 2.0 * a * k0 * m1

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        es = e * xp.sin(phi)
        chi = (
            2.0
            * xp.arctan(
                xp.tan(math.pi / 4 + phi / 2)
                * ((1 - es) / (1 + es)) ** (e / 2)
            )
            - math.pi / 2
        )
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        s, c = xp.sin(chi), xp.cos(chi)
        big_a = ak / (
            cos_chi1 * (1 + sin_chi1 * s + cos_chi1 * c * xp.cos(dlam))
        )
        x = big_a * c * xp.sin(dlam)
        y = big_a * (cos_chi1 * s - sin_chi1 * c * xp.cos(dlam))
        return fe + x, fn + y

    def inverse(x, y, xp):
        xr = x - fe
        yr = y - fn
        rho = xp.sqrt(xr * xr + yr * yr)
        ce = 2.0 * xp.arctan2(rho * cos_chi1, ak)
        s_ce, c_ce = xp.sin(ce), xp.cos(ce)
        origin = rho < 1e-12
        rho_s = xp.where(origin, 1.0, rho)
        chi = xp.arcsin(
            xp.clip(
                c_ce * sin_chi1 + yr * s_ce * cos_chi1 / rho_s, -1.0, 1.0
            )
        )
        chi = xp.where(origin, chi1, chi)
        phi = _conformal_to_geodetic(chi, e2, xp)
        dlam = xp.arctan2(
            xr * s_ce, rho_s * cos_chi1 * c_ce - yr * sin_chi1 * s_ce
        )
        lam = lam0 + xp.where(origin, 0.0, dlam)
        lam = (lam + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Oblique (double) Stereographic — EPSG 9809 / PROJ sterea (RD New et al.)
# ---------------------------------------------------------------------------


def make_oblique_stereographic(params: dict, ell: Ellipsoid):
    """EPSG method 9809: stereographic projection of a conformal sphere
    (Roussilhe / 'double stereographic'); the method of Amersfoort / RD
    New (EPSG:28992) and other national grids.  Constants follow EPSG
    Guidance Note 7-2; the inverse recovers geodetic latitude from the
    isometric latitude with a fixed-count contraction (converges to f64
    machine precision in <=5 steps for earth ellipsoids)."""
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    lon0 = float(params.get("longitude_of_projection_origin", 0.0))
    k0 = float(params.get("scale_factor_at_projection_origin", 1.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e, e2 = ell.a, ell.e, ell.e2
    phi0 = math.radians(lat0)
    lam0 = math.radians(lon0)

    s0, c0 = math.sin(phi0), math.cos(phi0)
    rho0 = a * (1 - e2) / (1 - e2 * s0 * s0) ** 1.5
    nu0 = a / math.sqrt(1 - e2 * s0 * s0)
    r_sph = math.sqrt(rho0 * nu0)
    n_c = math.sqrt(1 + e2 * c0**4 / (1 - e2))
    s1 = (1 + s0) / (1 - s0)
    s2 = (1 - e * s0) / (1 + e * s0)
    w1 = (s1 * s2**e) ** n_c
    sin_chi00 = (w1 - 1) / (w1 + 1)
    c_c = (n_c + s0) * (1 - sin_chi00) / ((n_c - s0) * (1 + sin_chi00))
    w2 = c_c * w1
    chi0 = math.asin((w2 - 1) / (w2 + 1))
    sin_chi0, cos_chi0 = math.sin(chi0), math.cos(chi0)
    two_rk = 2.0 * r_sph * k0

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        big_lam = n_c * dlam
        es = e * xp.sin(phi)
        sa = (1 + xp.sin(phi)) / (1 - xp.sin(phi))
        sb = (1 - es) / (1 + es)
        w = c_c * (sa * sb**e) ** n_c
        sin_chi = (w - 1) / (w + 1)
        cos_chi = xp.sqrt(xp.clip(1.0 - sin_chi * sin_chi, 0.0, 1.0))
        b = 1 + sin_chi * sin_chi0 + cos_chi * cos_chi0 * xp.cos(big_lam)
        x = two_rk * cos_chi * xp.sin(big_lam) / b
        y = two_rk * (
            sin_chi * cos_chi0 - cos_chi * sin_chi0 * xp.cos(big_lam)
        ) / b
        return fe + x, fn + y

    g_c = two_rk * math.tan(math.pi / 4 - chi0 / 2)
    h_c = 2.0 * two_rk * math.tan(chi0) + g_c

    def inverse(x, y, xp):
        xr = x - fe
        yr = y - fn
        i_c = xp.arctan2(xr, h_c + yr)
        j_c = xp.arctan2(xr, g_c - yr) - i_c
        chi = chi0 + 2.0 * xp.arctan(
            (yr - xr * xp.tan(j_c / 2.0)) / two_rk
        )
        big_lam = j_c + 2.0 * i_c
        lam = big_lam / n_c + lam0
        # isometric latitude on the ellipsoid from the conformal sphere
        psi = (
            xp.log((1 + xp.sin(chi)) / (c_c * (1 - xp.sin(chi)))) / (2.0 * n_c)
        )
        phi = 2.0 * xp.arctan(xp.exp(psi)) - math.pi / 2
        for _ in range(6):
            es = e * xp.sin(phi)
            psi_i = xp.log(
                xp.tan(phi / 2 + math.pi / 4) * ((1 - es) / (1 + es)) ** (e / 2)
            )
            phi = phi + (psi - psi_i) * xp.cos(phi) * (1 - es * es) / (1 - e2)
        lam = (lam + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Orthographic — EPSG 9840 (ellipsoidal), analytic-Jacobian Newton inverse
# ---------------------------------------------------------------------------


def make_orthographic(params: dict, ell: Ellipsoid):
    """Ellipsoidal orthographic (EPSG 9840).  The forward is closed-form;
    the inverse seeds with the spherical closed form and refines with a
    fixed-count Newton solve whose Jacobian is ANALYTIC (no finite
    differences, so the loop is float32-safe on device and converges to
    machine precision inside the limb)."""
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    lon0 = float(params.get("longitude_of_projection_origin", 0.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e2 = ell.a, ell.e2
    phi0 = math.radians(lat0)
    lam0 = math.radians(lon0)
    s0, c0 = math.sin(phi0), math.cos(phi0)
    nu0 = a / math.sqrt(1 - e2 * s0 * s0)

    def _fwd_rad(lam, phi, xp):
        s, c = xp.sin(phi), xp.cos(phi)
        nu = a / xp.sqrt(1 - e2 * s * s)
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        x = nu * c * xp.sin(dlam)
        y = nu * (s * c0 - c * s0 * xp.cos(dlam)) + e2 * (
            nu0 * s0 - nu * s
        ) * c0
        return x, y

    def forward(lon, lat, xp):
        x, y = _fwd_rad(_d2r(xp, lon), _d2r(xp, lat), xp)
        return fe + x, fn + y

    def inverse(x, y, xp):
        xr = x - fe
        yr = y - fn
        # spherical seed (Snyder 20-14..20-17)
        rho = xp.sqrt(xr * xr + yr * yr)
        rho_c = xp.clip(rho, 0.0, a * (1 - 1e-12))
        cc = xp.arcsin(rho_c / a)
        s_c, c_cos = xp.sin(cc), xp.cos(cc)
        rho_s = xp.where(rho < 1e-9, 1.0, rho)
        phi = xp.arcsin(
            xp.clip(c_cos * s0 + yr * s_c * c0 / rho_s, -1.0, 1.0)
        )
        lam = lam0 + xp.arctan2(
            xr * s_c, rho_s * c_cos * c0 - yr * s_c * s0
        )
        phi = xp.where(rho < 1e-9, phi0, phi)
        lam = xp.where(rho < 1e-9, lam0, lam)
        # Newton refinement with the exact Jacobian of the ellipsoidal
        # forward: d(nu)/dphi = a e2 s c W^-3
        for _ in range(6):
            s, c = xp.sin(phi), xp.cos(phi)
            w2 = 1 - e2 * s * s
            nu = a / xp.sqrt(w2)
            dnu = a * e2 * s * c / w2**1.5
            dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
            sl, cl = xp.sin(dlam), xp.cos(dlam)
            fx = nu * c * sl - xr
            fy = nu * (s * c0 - c * s0 * cl) + e2 * (nu0 * s0 - nu * s) * c0 - yr
            j11 = nu * c * cl  # dE/dlam
            j12 = (dnu * c - nu * s) * sl  # dE/dphi
            j21 = nu * c * s0 * sl  # dN/dlam
            j22 = (
                (dnu * s + nu * c) * c0 * (1 - e2)
                - (dnu * c - nu * s) * s0 * cl
            )  # dN/dphi
            det = j11 * j22 - j12 * j21
            det = xp.where(xp.abs(det) < 1e-30, 1e-30, det)
            lam = lam - xp.clip((fx * j22 - fy * j12) / det, -0.1, 0.1)
            phi = phi - xp.clip((fy * j11 - fx * j21) / det, -0.1, 0.1)
        lam = (lam + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Geostationary satellite view — PROJ geos (SEVIRI / GOES grids)
# ---------------------------------------------------------------------------


def make_geostationary(params: dict, ell: Ellipsoid):
    """Geostationary satellite projection (CGMS LRIT/HRIT normalized
    geostationary; CF ``geostationary``).  Scan-angle coordinates times
    satellite height, sweep axis ``x`` (GOES-R) or ``y`` (MSG SEVIRI);
    both forward and inverse are closed-form (the inverse solves the
    view-ray/ellipsoid intersection quadratic), so the pair runs fused on
    device like every other family here."""
    h = float(
        params.get(
            "perspective_point_height", params.get("satellite_height", 35785831.0)
        )
    )
    lon0 = float(params.get("longitude_of_projection_origin", 0.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    sweep = str(params.get("sweep_angle_axis", "y")).lower()
    if "fixed_angle_axis" in params and "sweep_angle_axis" not in params:
        # CF alternative spelling: fixed x <=> sweep y and vice versa
        sweep = "y" if str(params["fixed_angle_axis"]).lower() == "x" else "x"
    if sweep not in ("x", "y"):
        raise ValueError(f"geostationary: invalid sweep_angle_axis {sweep!r}")
    a, e2 = ell.a, ell.e2
    lam0 = math.radians(lon0)
    radius_g_1 = h / a
    radius_g = 1.0 + radius_g_1
    radius_p = ell.b / a
    radius_p2 = radius_p * radius_p
    radius_p_inv2 = 1.0 / radius_p2
    big_c = radius_g * radius_g - 1.0

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        # geocentric latitude and radius of the surface point
        phi_c = xp.arctan(radius_p2 * xp.tan(phi))
        s_c, c_c = xp.sin(phi_c), xp.cos(phi_c)
        r = radius_p / xp.sqrt(
            radius_p2 * c_c * c_c + s_c * s_c
        )
        vx = r * xp.cos(dlam) * c_c
        vy = r * xp.sin(dlam) * c_c
        vz = r * s_c
        # points hidden behind the limb are not visible from the satellite
        visible = (
            (radius_g - vx) * vx - vy * vy - vz * vz * radius_p_inv2
        ) >= 0.0
        tmp = radius_g - vx
        if sweep == "x":
            x = radius_g_1 * xp.arctan(vy / xp.sqrt(vz * vz + tmp * tmp))
            y = radius_g_1 * xp.arctan(vz / tmp)
        else:
            x = radius_g_1 * xp.arctan(vy / tmp)
            y = radius_g_1 * xp.arctan(vz / xp.sqrt(vy * vy + tmp * tmp))
        nan = float("nan")
        x = xp.where(visible, x, nan)
        y = xp.where(visible, y, nan)
        return fe + a * x, fn + a * y

    def inverse(x, y, xp):
        xs = (x - fe) / (a * radius_g_1)
        ys = (y - fn) / (a * radius_g_1)
        # unit view vector from the satellite
        if sweep == "x":
            vz = xp.tan(ys)
            vy = xp.tan(xs) * xp.sqrt(1.0 + vz * vz)
        else:
            vy = xp.tan(xs)
            vz = xp.tan(ys) * xp.sqrt(1.0 + vy * vy)
        # ray/ellipsoid intersection: nearest root of the quadratic
        az = vz * vz * radius_p_inv2 + vy * vy + 1.0
        bz = 2.0 * radius_g
        det = bz * bz - 4.0 * az * big_c
        hit = det >= 0.0
        det = xp.where(hit, det, 0.0)
        k = (bz - xp.sqrt(det)) / (2.0 * az)
        vx = radius_g - k
        vy = vy * k
        vz = vz * k
        dlam = xp.arctan2(vy, vx)
        phi = xp.arctan(vz * xp.cos(dlam) / vx)
        phi = xp.arctan(radius_p_inv2 * xp.tan(phi))
        nan = float("nan")
        lam = (lam0 + dlam + math.pi) % (2 * math.pi) - math.pi
        return (
            _r2d(xp, xp.where(hit, lam, nan)),
            _r2d(xp, xp.where(hit, phi, nan)),
        )

    return forward, inverse


# ---------------------------------------------------------------------------
# Transverse Mercator (South Orientated) — EPSG 9808 (South African LO)
# ---------------------------------------------------------------------------


def make_transverse_mercator_south_orientated(params: dict, ell: Ellipsoid):
    """EPSG 9808: the South African coordinate system — a transverse
    Mercator whose axes point WEST (westings) and SOUTH (southings).
    Implemented as the sign-flipped Krüger-series TM, so it inherits the
    sub-nanometer series accuracy."""
    inner = dict(params)
    fe = float(inner.pop("false_easting", 0.0))
    fn = float(inner.pop("false_northing", 0.0))
    inner["false_easting"] = 0.0
    inner["false_northing"] = 0.0
    tm_fwd, tm_inv = make_transverse_mercator(inner, ell)

    def forward(lon, lat, xp):
        x, y = tm_fwd(lon, lat, xp)
        return fe - x, fn - y

    def inverse(x, y, xp):
        return tm_inv(fe - x, fn - y, xp)

    return forward, inverse


# ---------------------------------------------------------------------------
# Shared meridian-arc series (Snyder 3-21 forward, 3-26 inverse)
# ---------------------------------------------------------------------------


def _meridian_arc_coeffs(e2: float):
    """(m0, m2, m4, m6, m8) with M(phi) = a (m0 phi - m2 sin2phi
    + m4 sin4phi - m6 sin6phi + m8 sin8phi); the e^8 term keeps the arc
    micrometer-exact for earth ellipsoids."""
    e4, e6, e8 = e2 * e2, e2 ** 3, e2 ** 4
    return (
        1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256 - 175 * e8 / 16384,
        3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024 + 105 * e8 / 4096,
        15 * e4 / 256 + 45 * e6 / 1024 + 525 * e8 / 16384,
        35 * e6 / 3072 + 175 * e8 / 12288,
        315 * e8 / 131072,
    )


def _inv_rectifying_coeffs(e2: float):
    """(p2, p4, p6, p8) with phi = mu + p2 sin2mu + p4 sin4mu + ..."""
    sqrt1me2 = math.sqrt(1 - e2)
    e1 = (1 - sqrt1me2) / (1 + sqrt1me2)
    e1_2, e1_3, e1_4 = e1 * e1, e1 ** 3, e1 ** 4
    return (
        3 * e1 / 2 - 27 * e1_3 / 32,
        21 * e1_2 / 16 - 55 * e1_4 / 32,
        151 * e1_3 / 96,
        1097 * e1_4 / 512,
    )


def _merid_arc(phi, a: float, mc, xp):
    m0, m2, m4, m6, m8 = mc
    return a * (
        m0 * phi - m2 * xp.sin(2 * phi) + m4 * xp.sin(4 * phi)
        - m6 * xp.sin(6 * phi) + m8 * xp.sin(8 * phi)
    )


def _inv_merid_arc(m, a: float, m0: float, pc, xp):
    p2, p4, p6, p8 = pc
    mu = m / (a * m0)
    return (
        mu + p2 * xp.sin(2 * mu) + p4 * xp.sin(4 * mu)
        + p6 * xp.sin(6 * mu) + p8 * xp.sin(8 * mu)
    )


# ---------------------------------------------------------------------------
# Equidistant Cylindrical / Equirectangular — EPSG 1028 (ellipsoidal)
# ---------------------------------------------------------------------------


def make_equirectangular(params: dict, ell: Ellipsoid):
    """Equidistant cylindrical (EPSG 1028; ``+proj=eqc``; Plate Carrée when
    the standard parallel is 0).  ``x = nu1 cos(phi1) dlam``,
    ``y = M(phi) - M(phi0)`` with the meridian arc series — matching
    PROJ's ellipsoidal eqc and EPSG:4087."""
    sp = params.get("standard_parallel", 0.0)
    if isinstance(sp, (list, tuple)):
        sp = sp[0]
    phi1 = math.radians(float(sp))
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    lon0 = float(
        params.get(
            "longitude_of_central_meridian",
            params.get("longitude_of_projection_origin", 0.0),
        )
    )
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e2 = ell.a, ell.e2
    lam0 = math.radians(lon0)
    s1 = math.sin(phi1)
    nu1_cos = a * math.cos(phi1) / math.sqrt(1 - e2 * s1 * s1)
    mc = _meridian_arc_coeffs(e2)
    pc = _inv_rectifying_coeffs(e2)
    m_origin = float(_merid_arc(math.radians(lat0), a, mc, math))

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        x = nu1_cos * dlam
        y = _merid_arc(phi, a, mc, xp) - m_origin
        return fe + x, fn + y

    def inverse(x, y, xp):
        phi = _inv_merid_arc((y - fn) + m_origin, a, mc[0], pc, xp)
        lam = (
            lam0 + (x - fe) / nu1_cos + math.pi
        ) % (2 * math.pi) - math.pi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Mollweide — PROJ moll (spherical formulation on the semi-major axis)
# ---------------------------------------------------------------------------


def make_mollweide(params: dict, ell: Ellipsoid):
    """Mollweide pseudocylindrical equal-area (``+proj=moll``).  PROJ's
    implementation is spherical on radius ``a`` even for ellipsoidal
    datums; this matches it.  The parametric angle solves
    ``2 theta + sin 2theta = pi sin phi`` by a fixed-count Newton loop
    (quadratic convergence; 10 steps reach float64 machine precision)."""
    lon0 = float(
        params.get(
            "longitude_of_projection_origin",
            params.get("longitude_of_central_meridian", 0.0),
        )
    )
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    r = ell.a
    lam0 = math.radians(lon0)
    cx = 2.0 * math.sqrt(2.0) / math.pi * r
    cy = math.sqrt(2.0) * r

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        rhs = math.pi * xp.sin(phi)
        theta = phi
        for _ in range(10):
            f = 2.0 * theta + xp.sin(2.0 * theta) - rhs
            fp = 2.0 + 2.0 * xp.cos(2.0 * theta)
            # the derivative vanishes at the poles where theta = phi is
            # already exact; a floored divisor keeps the step finite
            theta = theta - f / xp.where(fp < 1e-9, 1e-9, fp)
        near_pole = xp.abs(xp.sin(phi)) > 1.0 - 1e-12
        theta = xp.where(near_pole, xp.sign(phi) * (math.pi / 2), theta)
        x = cx * dlam * xp.cos(theta)
        y = cy * xp.sin(theta)
        return fe + x, fn + y

    def inverse(x, y, xp):
        st = xp.clip((y - fn) / cy, -1.0, 1.0)
        theta = xp.arcsin(st)
        phi = xp.arcsin(
            xp.clip((2.0 * theta + xp.sin(2.0 * theta)) / math.pi, -1.0, 1.0)
        )
        ct = xp.cos(theta)
        polar = ct < 1e-12
        dlam = xp.where(polar, 0.0, (x - fe) / (cx * xp.where(polar, 1.0, ct)))
        lam = (lam0 + dlam + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Azimuthal equidistant — CF azimuthal_equidistant, +proj=aeqd
# ---------------------------------------------------------------------------


def _vincenty_inverse(phi1: float, lam1: float, phi2, lam2, ell, xp):
    """Geodesic distance + forward azimuth from a FIXED point (phi1, lam1)
    to array points, by Vincenty's inverse formulas with a fixed iteration
    count (12 steps: convergence is geometric at rate f/4 except within
    ~0.1 deg of the antipode, which callers mask).  Returns (s, alpha1)."""
    a = ell.a
    f = ell.f
    b = a * (1.0 - f)
    u1 = math.atan((1 - f) * math.tan(phi1))
    su1, cu1 = math.sin(u1), math.cos(u1)
    u2 = xp.arctan((1 - f) * xp.tan(phi2))
    su2, cu2 = xp.sin(u2), xp.cos(u2)
    ell_l = (lam2 - lam1 + math.pi) % (2 * math.pi) - math.pi
    lam = ell_l
    for _ in range(12):
        sl, cl = xp.sin(lam), xp.cos(lam)
        s_sig = xp.sqrt(
            (cu2 * sl) ** 2 + (cu1 * su2 - su1 * cu2 * cl) ** 2
        )
        c_sig = su1 * su2 + cu1 * cu2 * cl
        sig = xp.arctan2(s_sig, c_sig)
        s_safe = xp.where(s_sig < 1e-15, 1.0, s_sig)
        sin_alpha = cu1 * cu2 * sl / s_safe
        cos2_alpha = 1.0 - sin_alpha * sin_alpha
        ca_safe = xp.where(cos2_alpha < 1e-15, 1.0, cos2_alpha)
        cos_2sigm = xp.where(
            cos2_alpha < 1e-15, 0.0, c_sig - 2.0 * su1 * su2 / ca_safe
        )
        big_c = f / 16.0 * cos2_alpha * (4.0 + f * (4.0 - 3.0 * cos2_alpha))
        lam = ell_l + (1.0 - big_c) * f * sin_alpha * (
            sig + big_c * s_sig * (
                cos_2sigm
                + big_c * c_sig * (-1.0 + 2.0 * cos_2sigm * cos_2sigm)
            )
        )
    sl, cl = xp.sin(lam), xp.cos(lam)
    s_sig = xp.sqrt((cu2 * sl) ** 2 + (cu1 * su2 - su1 * cu2 * cl) ** 2)
    c_sig = su1 * su2 + cu1 * cu2 * cl
    sig = xp.arctan2(s_sig, c_sig)
    s_safe = xp.where(s_sig < 1e-15, 1.0, s_sig)
    sin_alpha = cu1 * cu2 * sl / s_safe
    cos2_alpha = 1.0 - sin_alpha * sin_alpha
    ca_safe = xp.where(cos2_alpha < 1e-15, 1.0, cos2_alpha)
    cos_2sigm = xp.where(
        cos2_alpha < 1e-15, 0.0, c_sig - 2.0 * su1 * su2 / ca_safe
    )
    u_sq = cos2_alpha * (a * a - b * b) / (b * b)
    big_a = 1.0 + u_sq / 16384.0 * (
        4096.0 + u_sq * (-768.0 + u_sq * (320.0 - 175.0 * u_sq))
    )
    big_b = u_sq / 1024.0 * (
        256.0 + u_sq * (-128.0 + u_sq * (74.0 - 47.0 * u_sq))
    )
    d_sig = big_b * s_sig * (
        cos_2sigm
        + big_b / 4.0 * (
            c_sig * (-1.0 + 2.0 * cos_2sigm ** 2)
            - big_b / 6.0 * cos_2sigm
            * (-3.0 + 4.0 * s_sig ** 2) * (-3.0 + 4.0 * cos_2sigm ** 2)
        )
    )
    s = b * big_a * (sig - d_sig)
    alpha1 = xp.arctan2(cu2 * sl, cu1 * su2 - su1 * cu2 * cl)
    return s, alpha1


def _vincenty_direct(phi1: float, lam1: float, s, alpha1, ell, xp):
    """Geodesic direct problem from a FIXED point: destination (phi2,
    lam2) at distance ``s`` along initial azimuth ``alpha1``.  Fixed
    8-step sigma iteration (converges in 3-4 for earth flattening)."""
    a = ell.a
    f = ell.f
    b = a * (1.0 - f)
    u1 = math.atan((1 - f) * math.tan(phi1))
    su1, cu1 = math.sin(u1), math.cos(u1)
    sa, ca = xp.sin(alpha1), xp.cos(alpha1)
    sigma1 = xp.arctan2(math.tan(u1), ca)
    sin_alpha = cu1 * sa
    cos2_alpha = 1.0 - sin_alpha * sin_alpha
    u_sq = cos2_alpha * (a * a - b * b) / (b * b)
    big_a = 1.0 + u_sq / 16384.0 * (
        4096.0 + u_sq * (-768.0 + u_sq * (320.0 - 175.0 * u_sq))
    )
    big_b = u_sq / 1024.0 * (
        256.0 + u_sq * (-128.0 + u_sq * (74.0 - 47.0 * u_sq))
    )
    sigma = s / (b * big_a)
    for _ in range(8):
        cos_2sigm = xp.cos(2.0 * sigma1 + sigma)
        s_sig, c_sig = xp.sin(sigma), xp.cos(sigma)
        d_sig = big_b * s_sig * (
            cos_2sigm
            + big_b / 4.0 * (
                c_sig * (-1.0 + 2.0 * cos_2sigm ** 2)
                - big_b / 6.0 * cos_2sigm
                * (-3.0 + 4.0 * s_sig ** 2)
                * (-3.0 + 4.0 * cos_2sigm ** 2)
            )
        )
        sigma = s / (b * big_a) + d_sig
    s_sig, c_sig = xp.sin(sigma), xp.cos(sigma)
    cos_2sigm = xp.cos(2.0 * sigma1 + sigma)
    phi2 = xp.arctan2(
        su1 * c_sig + cu1 * s_sig * ca,
        (1 - f) * xp.sqrt(
            sin_alpha ** 2 + (su1 * s_sig - cu1 * c_sig * ca) ** 2
        ),
    )
    lam = xp.arctan2(s_sig * sa, cu1 * c_sig - su1 * s_sig * ca)
    big_c = f / 16.0 * cos2_alpha * (4.0 + f * (4.0 - 3.0 * cos2_alpha))
    ell_l = lam - (1.0 - big_c) * f * sin_alpha * (
        sigma + big_c * s_sig * (
            cos_2sigm
            + big_c * c_sig * (-1.0 + 2.0 * cos_2sigm ** 2)
        )
    )
    lam2 = lam1 + ell_l
    return phi2, lam2


def make_azimuthal_equidistant(params: dict, ell: Ellipsoid):
    """Azimuthal equidistant (CF ``azimuthal_equidistant``;
    ``+proj=aeqd``).  Spherical datums use the exact closed form; on
    ellipsoids the projection IS the geodesic polar coordinate map, so
    the forward runs Vincenty's inverse problem against the projection
    centre and the inverse runs the direct problem — matching PROJ's
    geodesic-based aeqd to sub-mm except within ~0.2 deg of the antipode
    (where Vincenty's lambda iteration stalls and points land slightly
    short; PROJ's Karney geodesics converge there)."""
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    lon0 = float(params.get("longitude_of_projection_origin", 0.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e2 = ell.a, ell.e2
    phi0 = math.radians(lat0)
    lam0 = math.radians(lon0)

    if e2 == 0.0:
        s0, c0 = math.sin(phi0), math.cos(phi0)

        def forward(lon, lat, xp):
            lam = _d2r(xp, lon)
            phi = _d2r(xp, lat)
            dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
            s, c = xp.sin(phi), xp.cos(phi)
            cos_c = xp.clip(s0 * s + c0 * c * xp.cos(dlam), -1.0, 1.0)
            cang = xp.arccos(cos_c)
            sin_c = xp.sin(cang)
            k = xp.where(sin_c < 1e-12, 1.0, cang / xp.where(
                sin_c < 1e-12, 1.0, sin_c
            ))
            x = a * k * c * xp.sin(dlam)
            y = a * k * (c0 * s - s0 * c * xp.cos(dlam))
            return fe + x, fn + y

        def inverse(x, y, xp):
            xr = (x - fe) / a
            yr = (y - fn) / a
            rho = xp.sqrt(xr * xr + yr * yr)
            cang = xp.clip(rho, 0.0, math.pi)
            s_c, c_c = xp.sin(cang), xp.cos(cang)
            rho_s = xp.where(rho < 1e-12, 1.0, rho)
            phi = xp.arcsin(
                xp.clip(c_c * s0 + yr * s_c * c0 / rho_s, -1.0, 1.0)
            )
            lam = lam0 + xp.arctan2(
                xr * s_c, rho_s * c_c * c0 - yr * s_c * s0
            )
            phi = xp.where(rho < 1e-12, phi0, phi)
            lam = xp.where(rho < 1e-12, lam0, lam)
            lam = (lam + math.pi) % (2 * math.pi) - math.pi
            return _r2d(xp, lam), _r2d(xp, phi)

        return forward, inverse

    if abs(lat0) >= 89.999:
        # polar aspect: rho is the meridian arc to the pole (Snyder 25-16)
        north = lat0 > 0
        mc = _meridian_arc_coeffs(e2)
        pc = _inv_rectifying_coeffs(e2)
        m_pole = float(_merid_arc(math.pi / 2, a, mc, math))

        def forward(lon, lat, xp):
            lam = _d2r(xp, lon)
            phi = _d2r(xp, lat)
            dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
            m = _merid_arc(phi, a, mc, xp)
            rho = (m_pole - m) if north else (m_pole + m)
            x = rho * xp.sin(dlam)
            y = (-rho if north else rho) * xp.cos(dlam)
            return fe + x, fn + y

        def inverse(x, y, xp):
            xr = x - fe
            yr = y - fn
            rho = xp.sqrt(xr * xr + yr * yr)
            m = (m_pole - rho) if north else (rho - m_pole)
            phi = _inv_merid_arc(m, a, mc[0], pc, xp)
            dlam = xp.arctan2(xr, -yr if north else yr)
            at_pole = rho < 1e-9
            phi = xp.where(at_pole, phi0, phi)
            dlam = xp.where(at_pole, 0.0, dlam)
            lam = (lam0 + dlam + math.pi) % (2 * math.pi) - math.pi
            return _r2d(xp, lam), _r2d(xp, phi)

        return forward, inverse

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        s, alpha1 = _vincenty_inverse(phi0, lam0, phi, lam, ell, xp)
        at_centre = s < 1e-9
        x = xp.where(at_centre, 0.0, s * xp.sin(alpha1))
        y = xp.where(at_centre, 0.0, s * xp.cos(alpha1))
        return fe + x, fn + y

    def inverse(x, y, xp):
        xr = x - fe
        yr = y - fn
        s = xp.sqrt(xr * xr + yr * yr)
        alpha1 = xp.arctan2(xr, yr)
        phi, lam = _vincenty_direct(phi0, lam0, s, alpha1, ell, xp)
        at_centre = s < 1e-9
        phi = xp.where(at_centre, phi0, phi)
        lam = xp.where(at_centre, lam0, lam)
        lam = (lam + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Hotine oblique Mercator — EPSG 9812 (variant A) / 9815 (variant B)
# ---------------------------------------------------------------------------


def make_oblique_mercator(params: dict, ell: Ellipsoid):
    """Hotine oblique Mercator (CF ``oblique_mercator``; ``+proj=omerc``).
    EPSG guidance note 7-2 formulas.  Default is variant B (EPSG 9815,
    coordinates offset to the projection centre, matching PROJ's omerc
    default); ``_no_uoff`` selects variant A (EPSG 9812 / ``+no_uoff``).
    The inverse recovers geodetic latitude from the conformal latitude by
    the shared Snyder series."""
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    lonc = float(
        params.get(
            "longitude_of_projection_origin",
            params.get("longitude_of_central_meridian", 0.0),
        )
    )
    alpha_c = float(params.get("azimuth_of_central_line", 90.0))
    gamma_c = float(params.get("rectified_grid_angle", alpha_c))
    k_c = float(params.get("scale_factor_at_projection_origin", 1.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    no_uoff = bool(params.get("_no_uoff", False))
    a, e2 = ell.a, ell.e2
    e = math.sqrt(e2)
    phi0 = math.radians(lat0)
    lamc = math.radians(lonc)
    al = math.radians(alpha_c)
    ga = math.radians(gamma_c)
    s0, c0 = math.sin(phi0), math.cos(phi0)

    big_b = math.sqrt(1.0 + e2 * c0 ** 4 / (1.0 - e2))
    w0 = math.sqrt(1.0 - e2 * s0 * s0)
    big_a = a * big_b * k_c * math.sqrt(1.0 - e2) / (w0 * w0)
    t0 = math.tan(math.pi / 4 - phi0 / 2) / (
        (1.0 - e * s0) / (1.0 + e * s0)
    ) ** (e / 2)
    big_d = max(big_b * math.sqrt(1.0 - e2) / (c0 * w0), 1.0)
    sign0 = -1.0 if phi0 < 0 else 1.0
    big_f = big_d + math.sqrt(big_d * big_d - 1.0) * sign0
    big_h = big_f * t0 ** big_b
    big_g = (big_f - 1.0 / big_f) / 2.0
    gamma0 = math.asin(min(max(math.sin(al) / big_d, -1.0), 1.0))
    lam0 = lamc - math.asin(
        min(max(big_g * math.tan(gamma0), -1.0), 1.0)
    ) / big_b
    sg0, cg0 = math.sin(gamma0), math.cos(gamma0)
    if no_uoff:
        u_c = 0.0
    elif abs(alpha_c - 90.0) < 1e-12:
        u_c = big_a * (lamc - lam0)
    else:
        u_c = (big_a / big_b) * math.atan2(
            math.sqrt(big_d * big_d - 1.0), math.cos(al)
        ) * sign0
    sgc, cgc = math.sin(ga), math.cos(ga)

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        phi_c = xp.clip(phi, -math.pi / 2 + 1e-9, math.pi / 2 - 1e-9)
        s = xp.sin(phi_c)
        t = xp.tan(math.pi / 4 - phi_c / 2) / (
            (1.0 - e * s) / (1.0 + e * s)
        ) ** (e / 2)
        big_q = big_h / t ** big_b
        big_s = (big_q - 1.0 / big_q) / 2.0
        big_t = (big_q + 1.0 / big_q) / 2.0
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        big_v = xp.sin(big_b * dlam)
        big_u = (-big_v * cg0 + big_s * sg0) / big_t
        v = big_a * xp.log((1.0 - big_u) / (1.0 + big_u)) / (2.0 * big_b)
        u = big_a * xp.arctan2(
            big_s * cg0 + big_v * sg0, xp.cos(big_b * dlam)
        ) / big_b - u_c
        x = v * cgc + u * sgc
        y = u * cgc - v * sgc
        return fe + x, fn + y

    def inverse(x, y, xp):
        xr = x - fe
        yr = y - fn
        v = xr * cgc - yr * sgc
        u = yr * cgc + xr * sgc + u_c
        big_qp = xp.exp(-big_b * v / big_a)
        big_sp = (big_qp - 1.0 / big_qp) / 2.0
        big_tp = (big_qp + 1.0 / big_qp) / 2.0
        big_vp = xp.sin(big_b * u / big_a)
        big_up = xp.clip(
            (big_vp * cg0 + big_sp * sg0) / big_tp, -1.0, 1.0
        )
        tp = (
            big_h / xp.sqrt((1.0 + big_up) / (1.0 - big_up))
        ) ** (1.0 / big_b)
        chi = math.pi / 2 - 2.0 * xp.arctan(tp)
        phi = _conformal_to_geodetic(chi, e2, xp)
        dlam = -xp.arctan2(
            big_sp * cg0 - big_vp * sg0, xp.cos(big_b * u / big_a)
        ) / big_b
        lam = (lam0 + dlam + math.pi) % (2 * math.pi) - math.pi
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Swiss oblique Mercator — EPSG 9814 (CH1903 / LV03, CH1903+ / LV95)
# ---------------------------------------------------------------------------


def make_swiss_oblique_mercator(params: dict, ell: Ellipsoid):
    """Swiss oblique cylindrical (EPSG 9814; ``+proj=somerc``): double
    projection ellipsoid -> conformal sphere -> oblique equatorial
    Mercator.  The inverse solves the conformal-sphere latitude back to
    geodetic with a fixed 8-step contraction (rate ~e^2/2, float64-exact
    for earth ellipsoids)."""
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    lon0 = float(params.get("longitude_of_projection_origin", 0.0))
    k0 = float(params.get("scale_factor_at_projection_origin", 1.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    a, e2 = ell.a, ell.e2
    e = math.sqrt(e2)
    phi0 = math.radians(lat0)
    lam0 = math.radians(lon0)
    s0, c0 = math.sin(phi0), math.cos(phi0)
    alpha = math.sqrt(1.0 + e2 / (1.0 - e2) * c0 ** 4)
    r_sph = a * k0 * math.sqrt(1.0 - e2) / (1.0 - e2 * s0 * s0)
    b0 = math.asin(s0 / alpha)
    big_k = (
        math.log(math.tan(math.pi / 4 + b0 / 2))
        - alpha * math.log(math.tan(math.pi / 4 + phi0 / 2))
        + alpha * e / 2 * math.log(
            (1.0 + e * s0) / (1.0 - e * s0)
        )
    )
    sb0, cb0 = math.sin(b0), math.cos(b0)

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        phi_c = xp.clip(phi, -math.pi / 2 + 1e-9, math.pi / 2 - 1e-9)
        s = xp.sin(phi_c)
        big_s = (
            alpha * xp.log(xp.tan(math.pi / 4 + phi_c / 2))
            - alpha * e / 2 * xp.log((1.0 + e * s) / (1.0 - e * s))
            + big_k
        )
        b = 2.0 * (xp.arctan(xp.exp(big_s)) - math.pi / 4)
        ell_l = alpha * (
            (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        )
        sb, cb = xp.sin(b), xp.cos(b)
        sl, cl = xp.sin(ell_l), xp.cos(ell_l)
        b_bar = xp.arcsin(xp.clip(cb0 * sb - sb0 * cb * cl, -1.0, 1.0))
        l_bar = xp.arctan2(cb * sl, sb0 * sb + cb0 * cb * cl)
        y = r_sph * l_bar
        x = r_sph / 2.0 * xp.log(
            (1.0 + xp.sin(b_bar)) / (1.0 - xp.sin(b_bar))
        )
        return fe + y, fn + x

    def inverse(x, y, xp):
        l_bar = (x - fe) / r_sph
        b_bar = 2.0 * (xp.arctan(xp.exp((y - fn) / r_sph)) - math.pi / 4)
        sbb, cbb = xp.sin(b_bar), xp.cos(b_bar)
        slb, clb = xp.sin(l_bar), xp.cos(l_bar)
        b = xp.arcsin(xp.clip(cb0 * sbb + sb0 * cbb * clb, -1.0, 1.0))
        ell_l = xp.arctan2(cbb * slb, cb0 * cbb * clb - sb0 * sbb)
        lam = (
            lam0 + ell_l / alpha + math.pi
        ) % (2 * math.pi) - math.pi
        # invert S(phi): contraction phi <- g(phi) with |g'| ~ e^2/2
        target = (
            xp.log(xp.tan(math.pi / 4 + b / 2)) - big_k
        ) / alpha
        phi = b
        for _ in range(8):
            s = xp.sin(phi)
            phi = 2.0 * (
                xp.arctan(
                    xp.exp(
                        target
                        + e / 2 * xp.log((1.0 + e * s) / (1.0 - e * s))
                    )
                )
                - math.pi / 4
            )
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# Vertical perspective — CF vertical_perspective, +proj=nsper (spherical)
# ---------------------------------------------------------------------------


def make_vertical_perspective(params: dict, ell: Ellipsoid):
    """Near-sided general vertical perspective (CF ``vertical_perspective``;
    ``+proj=nsper``).  Spherical formulation on the semi-major axis
    (Snyder SS23), matching PROJ's nsper; the inverse picks the
    viewer-side root of the ray/sphere quadratic."""
    h = float(
        params.get(
            "perspective_point_height", params.get("satellite_height", 0.0)
        )
    )
    if h <= 0:
        raise ValueError(
            "vertical_perspective needs perspective_point_height > 0"
        )
    lat0 = float(params.get("latitude_of_projection_origin", 0.0))
    lon0 = float(params.get("longitude_of_projection_origin", 0.0))
    fe = float(params.get("false_easting", 0.0))
    fn = float(params.get("false_northing", 0.0))
    r = ell.a
    big_p = 1.0 + h / r
    phi0 = math.radians(lat0)
    lam0 = math.radians(lon0)
    s0, c0 = math.sin(phi0), math.cos(phi0)

    def forward(lon, lat, xp):
        lam = _d2r(xp, lon)
        phi = _d2r(xp, lat)
        dlam = (lam - lam0 + math.pi) % (2 * math.pi) - math.pi
        s, c = xp.sin(phi), xp.cos(phi)
        cos_c = s0 * s + c0 * c * xp.cos(dlam)
        visible = cos_c >= 1.0 / big_p
        k = (big_p - 1.0) / (big_p - cos_c)
        x = r * k * c * xp.sin(dlam)
        y = r * k * (c0 * s - s0 * c * xp.cos(dlam))
        nan = float("nan")
        return (
            fe + xp.where(visible, x, nan),
            fn + xp.where(visible, y, nan),
        )

    def inverse(x, y, xp):
        xr = x - fe
        yr = y - fn
        rho2 = xr * xr + yr * yr
        rho = xp.sqrt(rho2)
        rp2 = (r * (big_p - 1.0)) ** 2
        # cos(c) from rho (P - cos c) = R (P-1) sin c: viewer-side root
        aa = rho2 + rp2
        bb = 2.0 * rho2 * big_p
        cc = rho2 * big_p * big_p - rp2
        det = bb * bb - 4.0 * aa * cc
        hit = det >= 0.0
        det = xp.where(hit, det, 0.0)
        cos_c = xp.clip((bb + xp.sqrt(det)) / (2.0 * aa), -1.0, 1.0)
        sin_c = xp.sqrt(xp.clip(1.0 - cos_c * cos_c, 0.0, 1.0))
        rho_s = xp.where(rho < 1e-9, 1.0, rho)
        phi = xp.arcsin(
            xp.clip(cos_c * s0 + yr * sin_c * c0 / rho_s, -1.0, 1.0)
        )
        lam = lam0 + xp.arctan2(
            xr * sin_c, rho_s * cos_c * c0 - yr * sin_c * s0
        )
        phi = xp.where(rho < 1e-9, phi0, phi)
        lam = xp.where(rho < 1e-9, lam0, lam)
        nan = float("nan")
        phi = xp.where(hit, phi, nan)
        lam = xp.where(hit, (lam + math.pi) % (2 * math.pi) - math.pi, nan)
        return _r2d(xp, lam), _r2d(xp, phi)

    return forward, inverse


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

PROJECTION_FACTORIES = {
    "transverse_mercator": make_transverse_mercator,
    "lambert_azimuthal_equal_area": make_lambert_azimuthal_equal_area,
    "mercator": make_mercator,
    "rotated_latitude_longitude": make_rotated_latitude_longitude,
    "lambert_conformal_conic": make_lambert_conformal_conic,
    "albers_conical_equal_area": make_albers_conical_equal_area,
    "polar_stereographic": make_polar_stereographic,
    "lambert_cylindrical_equal_area": make_lambert_cylindrical_equal_area,
    "sinusoidal": make_sinusoidal,
    "stereographic": make_stereographic,
    "oblique_stereographic": make_oblique_stereographic,
    "orthographic": make_orthographic,
    "geostationary": make_geostationary,
    "transverse_mercator_south_orientated": (
        make_transverse_mercator_south_orientated
    ),
    "equirectangular": make_equirectangular,
    "mollweide": make_mollweide,
    "azimuthal_equidistant": make_azimuthal_equidistant,
    "oblique_mercator": make_oblique_mercator,
    "swiss_oblique_mercator": make_swiss_oblique_mercator,
    "vertical_perspective": make_vertical_perspective,
}


def make_projection(name: str, params: dict, ell: Ellipsoid):
    try:
        factory = PROJECTION_FACTORIES[name]
    except KeyError:
        raise ValueError(f"unsupported projection {name!r}") from None
    return factory(params, ell)
