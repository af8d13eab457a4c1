"""PROJ.4 string parsing for the native CRS engine.

The reference accepts proj4 strings through ``pyproj.CRS.from_user_input``
(reference gridmapping/base.py:49-52).  This parser covers the projection
families the engine implements (see :mod:`.projections`) plus +ellps /
+datum / +a +b +rf / +towgs84 datum handling, sharing the generic-parameter
normalization layer with the WKT parser (:mod:`.wkt`)."""

from __future__ import annotations

from .datum import (
    AIRY1830,
    BESSEL1841,
    CLARKE1866,
    GRS80,
    INTL1924,
    KRASSOWSKY1940,
    WGS72,
    WGS84,
    Ellipsoid,
    towgs84_for_datum,
)
from .wkt import build_projected_params

_ELLPS = {
    "WGS84": WGS84,
    "GRS80": GRS80,
    "intl": INTL1924,
    "clrk66": CLARKE1866,
    "bessel": BESSEL1841,
    "airy": AIRY1830,
    "krass": KRASSOWSKY1940,
    "WGS72": WGS72,
    "sphere": Ellipsoid("Normal Sphere", 6370997.0, 0.0),
}

#: +datum= -> (ellipsoid, datum name); towgs84 resolves via the registry
_DATUMS = {
    "WGS84": (WGS84, "World Geodetic System 1984"),
    "NAD83": (GRS80, "North American Datum 1983"),
    "NAD27": (CLARKE1866, "North American Datum 1927"),
    "potsdam": (BESSEL1841, "Deutsches Hauptdreiecksnetz"),
    "OSGB36": (AIRY1830, "OSGB 1936"),
    "OSGB_1936": (AIRY1830, "OSGB 1936"),
}

#: +proj= -> projection family (build_projected_params vocabulary)
_PROJ = {
    "tmerc": "transverse_mercator",
    "utm": "transverse_mercator",
    "laea": "lambert_azimuthal_equal_area",
    "merc": "mercator",
    "webmerc": "pseudo_mercator",
    "lcc": "lambert_conformal_conic",
    "aea": "albers_conical_equal_area",
    "stere": "stereographic",
    "sterea": "oblique_stereographic",
    "ortho": "orthographic",
    "geos": "geostationary",
    "cea": "lambert_cylindrical_equal_area",
    "sinu": "sinusoidal",
    "ob_tran": "rotated_latitude_longitude",
    "eqc": "equirectangular",
    "moll": "mollweide",
    "aeqd": "azimuthal_equidistant",
    "omerc": "oblique_mercator",
    "somerc": "swiss_oblique_mercator",
    "nsper": "vertical_perspective",
}


def _parse_kv(text: str) -> dict:
    kv: dict[str, str | bool] = {}
    for tok in text.split():
        tok = tok.lstrip("+")
        if not tok or tok == "no_defs":
            continue
        if "=" in tok:
            k, v = tok.split("=", 1)
            kv[k] = v
        else:
            kv[tok] = True
    return kv


def crs_from_proj4(text: str):
    """Parse a proj4 string into a :class:`~.core.CRS`.  Raises
    ``ValueError`` on unsupported projections or parameters (callers wrap
    into CRSError)."""
    from .core import CRS

    kv = _parse_kv(text)
    if "init" in kv:
        init = str(kv["init"])
        if init.lower().startswith("epsg:"):
            return CRS.from_epsg(int(init.split(":", 1)[1]))
        raise ValueError(f"unsupported +init={init}")

    proj = kv.get("proj")
    if proj is None:
        raise ValueError("missing +proj")

    # --- datum / ellipsoid
    datum_name = "World Geodetic System 1984"
    ell = None
    if "datum" in kv:
        entry = _DATUMS.get(str(kv["datum"]))
        if entry is None:
            raise ValueError(f"unsupported +datum={kv['datum']}")
        ell, datum_name = entry
    if ell is None and "ellps" in kv:
        ell = _ELLPS.get(str(kv["ellps"]))
        if ell is None:
            raise ValueError(f"unsupported +ellps={kv['ellps']}")
        if "datum" not in kv:
            datum_name = f"Unknown based on {ell.name}"
    if ell is None and "a" in kv:
        a = float(kv["a"])
        if "rf" in kv:
            rf = float(kv["rf"])
        elif "b" in kv:
            b = float(kv["b"])
            rf = a / (a - b) if a != b else 0.0
        else:
            rf = 0.0
        ell = Ellipsoid("unnamed", a, rf)
        datum_name = "unknown"
    if ell is None:
        ell = WGS84
    if kv.get("R"):
        ell = Ellipsoid("Normal Sphere", float(kv["R"]), 0.0)
        datum_name = "unknown"

    towgs84 = None
    if "towgs84" in kv:
        vals = [float(v) for v in str(kv["towgs84"]).split(",")]
        while len(vals) < 7:
            vals.append(0.0)
        towgs84 = tuple(vals[:7])
    elif "datum" in kv:
        towgs84 = towgs84_for_datum(datum_name)

    if proj in ("longlat", "latlong", "latlon", "lonlat"):
        return CRS(
            kind="geographic",
            ellipsoid=ell,
            name=f"unknown ({datum_name})",
            datum_name=datum_name,
            axis_lat_lon=proj in ("latlong", "latlon"),
            towgs84=towgs84,
        )

    family = _PROJ.get(str(proj))
    if family is None:
        raise ValueError(f"unsupported +proj={proj}")

    generic: dict = {}
    if proj == "utm":
        zone = int(kv.get("zone", 0))
        if not 1 <= zone <= 60:
            raise ValueError(f"invalid UTM +zone={kv.get('zone')}")
        generic = {
            "k_0": 0.9996,
            "lon_0": float(zone * 6 - 183),
            "lat_0": 0.0,
            "x_0": 500000.0,
            "y_0": 10000000.0 if kv.get("south") else 0.0,
        }
    else:
        mapping = {
            "lat_0": "lat_0",
            "lon_0": "lon_0",
            "lonc": "lon_0",
            "k": "k_0",
            "k_0": "k_0",
            "x_0": "x_0",
            "y_0": "y_0",
            "lat_1": "sp1",
            "lat_ts": "sp1",
            "lat_2": "sp2",
            "o_lat_p": "pole_lat",
            "o_lon_p": "pole_rot",
            "alpha": "az",
            "gamma": "gamma",
        }
        for src_key, dst_key in mapping.items():
            if src_key in kv:
                generic[dst_key] = float(kv[src_key])
        if proj == "geos":
            if "h" not in kv:
                raise ValueError("+proj=geos needs +h=<satellite height>")
            generic["h"] = float(kv["h"])
            generic["sweep"] = str(kv.get("sweep", "y"))
        if proj == "nsper":
            if "h" not in kv:
                raise ValueError("+proj=nsper needs +h=<viewpoint height>")
            generic["h"] = float(kv["h"])
        if proj == "omerc" and (kv.get("no_uoff") or kv.get("no_off")):
            generic["no_uoff"] = True
        if proj == "tmerc" and str(kv.get("axis", "enu")) == "wsu":
            # the South African LO convention (+axis=wsu): westings and
            # southings -> the EPSG 9808 south-orientated TM family
            family = "transverse_mercator_south_orientated"
        if proj == "ob_tran":
            # rotated lon/lat: +o_proj=longlat +o_lat_p +o_lon_p +lon_0
            if str(kv.get("o_proj", "longlat")) not in (
                "longlat", "latlong", "lonlat",
            ):
                raise ValueError("+proj=ob_tran only supports o_proj=longlat")
            # PROJ convention: lon_0 = 180 + grid_north_pole_longitude,
            # so the CF pole longitude is lon_0 - 180 (not 180 - lon_0)
            generic["pole_lon"] = float(kv.get("lon_0", 0.0)) - 180.0
            generic.pop("lon_0", None)

    proj_name, params = build_projected_params(family, generic)
    crs = CRS(
        kind="projected",
        ellipsoid=ell,
        proj_name=proj_name,
        params=params,
        name=f"unknown ({proj})",
        datum_name=datum_name,
        towgs84=towgs84,
    )
    crs.projection()  # validate -> ValueError surfaces to the caller
    from .core import _EPSG_CACHE, _match_epsg

    epsg = _match_epsg(crs)
    if epsg and crs.towgs84 is None:
        return _EPSG_CACHE.get(epsg, crs)
    return crs
