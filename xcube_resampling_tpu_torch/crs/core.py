"""CRS model: coordinate reference systems with CF round-tripping.

This is the rebuild's replacement for ``pyproj.crs.CRS`` (the reference uses
it as its CRS currency, e.g. xcube_resampling/gridmapping/
base.py:49-52, cfconv.py:215-221).  A CRS here is a lightweight immutable
description: geographic vs projected, ellipsoid, projection name + CF
parameters, axis order.  Projected CRSs expose array-generic forward /
inverse closures via :mod:`.projections`.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

from .datum import Ellipsoid, GRS80, WGS84, ellipsoid_from_params
from .projections import make_projection


class CRSError(ValueError):
    """Raised when a CRS cannot be constructed (pyproj.crs.CRSError parity)."""


class _AxisInfo:
    def __init__(self, name: str, unit_name: str):
        self.name = name
        self.unit_name = unit_name

    def __repr__(self):
        return f"AxisInfo({self.name!r}, unit={self.unit_name!r})"


_GEO_PARAM_KEYS = (
    "semi_major_axis",
    "semi_minor_axis",
    "inverse_flattening",
    "reference_ellipsoid_name",
    "longitude_of_prime_meridian",
    "prime_meridian_name",
    "geographic_crs_name",
    "horizontal_datum_name",
    "projected_crs_name",
    "grid_mapping_name",
    "crs_wkt",
    "spatial_ref",
    "_spherical",
)


class CRS:
    """Immutable coordinate reference system."""

    def __init__(
        self,
        *,
        kind: str,
        ellipsoid: Ellipsoid,
        proj_name: str | None = None,
        params: Mapping[str, Any] | None = None,
        name: str = "unnamed",
        datum_name: str = "World Geodetic System 1984",
        axis_lat_lon: bool = False,
        epsg: int | None = None,
        towgs84: tuple | None = None,
    ):
        assert kind in ("geographic", "projected")
        self._kind = kind
        self._ellipsoid = ellipsoid
        self._proj_name = proj_name
        self._params = dict(params or {})
        self._name = name
        self._datum_name = datum_name
        self._axis_lat_lon = axis_lat_lon
        self._epsg = epsg
        # normalize away explicit transforms the datum registry implies
        # anyway (all-zero = WGS84-coincident; or equal to the registry's
        # parameters for this datum name): keeps equality/EPSG matching
        # independent of whether towgs84 was spelled out
        if towgs84 is not None:
            towgs84 = tuple(float(v) for v in towgs84)
            from .datum import towgs84_for_datum

            if not any(towgs84) or towgs84 == towgs84_for_datum(datum_name):
                towgs84 = None
        self._towgs84 = towgs84
        self._fwd_inv = None

    # -- identity ----------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def is_geographic(self) -> bool:
        # pyproj parity: rotated-pole CRSs are derived geographic CRSs
        return (
            self._kind == "geographic"
            or self._proj_name == "rotated_latitude_longitude"
        )

    @property
    def is_projected(self) -> bool:
        return self._kind == "projected" and not self.is_geographic

    @property
    def type_name(self) -> str:
        if self._proj_name == "rotated_latitude_longitude":
            return "Derived Geographic 2D CRS"
        if self._kind == "geographic":
            return "Geographic 2D CRS"
        return "Projected CRS"

    @property
    def ellipsoid(self) -> Ellipsoid:
        return self._ellipsoid

    @property
    def datum_name(self) -> str:
        return self._datum_name

    @property
    def towgs84(self) -> tuple | None:
        """Explicit 7-parameter Helmert transform to WGS84 (from a WKT
        TOWGS84/BOUNDCRS node or a proj4 ``+towgs84``), or None when the
        datum-name registry decides (see crs.datum.towgs84_for_datum)."""
        return self._towgs84

    @property
    def proj_name(self) -> str | None:
        return self._proj_name

    @property
    def params(self) -> dict:
        return dict(self._params)

    @property
    def srs(self) -> str:
        if self._epsg:
            return f"EPSG:{self._epsg}"
        return self.to_wkt()

    @property
    def axis_info(self) -> list[_AxisInfo]:
        if self.is_geographic:
            if self._axis_lat_lon:
                return [
                    _AxisInfo("Geodetic latitude", "degree"),
                    _AxisInfo("Geodetic longitude", "degree"),
                ]
            return [
                _AxisInfo("Geodetic longitude", "degree"),
                _AxisInfo("Geodetic latitude", "degree"),
            ]
        return [_AxisInfo("Easting", "metre"), _AxisInfo("Northing", "metre")]

    def to_epsg(self) -> int | None:
        return self._epsg

    def to_string(self) -> str:
        return self.srs

    # -- equality ----------------------------------------------------------

    def _key(self, with_datum: bool = True):
        from .datum import canonical_datum_key

        params = tuple(
            sorted(
                (k, tuple(v) if isinstance(v, (list, tuple)) else round(float(v), 9))
                for k, v in self._params.items()
                if isinstance(v, (int, float, list, tuple))
            )
        )
        return (
            self._kind,
            self._proj_name,
            params,
            round(self._ellipsoid.a, 6),
            round(self._ellipsoid.inverse_flattening, 9),
            canonical_datum_key(self._datum_name) if with_datum else None,
            self._axis_lat_lon,
            self._towgs84,
        )

    def equals(self, other: "CRS") -> bool:
        if not isinstance(other, CRS):
            try:
                other = CRS.from_user_input(other)
            except CRSError:
                return False
        return self._key() == other._key()

    def __eq__(self, other):
        if not isinstance(other, CRS):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"<CRS {self.srs}: {self._name}>"

    def __str__(self):
        # pyproj parity: str(CRS(4326)) == "EPSG:4326"
        return f"EPSG:{self._epsg}" if self._epsg else self._name

    # -- projection closures -----------------------------------------------

    def projection(self):
        """Return (forward, inverse) closures mapping lon/lat degrees <->
        projected metres.  Geographic CRSs return identity."""
        if self._fwd_inv is None:
            if self._proj_name is None:
                ident = (lambda x, y, xp: (x, y))
                self._fwd_inv = (ident, ident)
            else:
                self._fwd_inv = make_projection(
                    self._proj_name, self._params, self._ellipsoid
                )
        return self._fwd_inv

    # -- CF conventions ----------------------------------------------------

    def to_cf(self) -> dict:
        """Export as CF grid-mapping attributes
        (pyproj.CRS.to_cf parity; reference cfconv.py:341, utils.py:147)."""
        ell = self._ellipsoid
        attrs: dict[str, Any] = {
            "semi_major_axis": ell.a,
            "semi_minor_axis": ell.b,
            "inverse_flattening": ell.inverse_flattening,
            "reference_ellipsoid_name": ell.name,
            "longitude_of_prime_meridian": 0.0,
            "prime_meridian_name": "Greenwich",
            "geographic_crs_name": (
                self._name if self.is_geographic else self._datum_name
            ),
            "horizontal_datum_name": self._datum_name,
        }
        if self._proj_name is None:
            attrs["grid_mapping_name"] = "latitude_longitude"
        else:
            if not self.is_geographic:
                attrs["projected_crs_name"] = self._name
            attrs["grid_mapping_name"] = self._proj_name
            for k, v in self._params.items():
                if not k.startswith("_"):
                    attrs[k] = v
        attrs["crs_wkt"] = self.to_wkt()
        return attrs

    @classmethod
    def from_cf(cls, attrs: Mapping[str, Any]) -> "CRS":
        """Build a CRS from CF grid-mapping attributes
        (pyproj.CRS.from_cf parity; reference cfconv.py:215-221)."""
        attrs = dict(attrs)
        wkt = attrs.get("crs_wkt") or attrs.get("spatial_ref")
        if isinstance(wkt, str) and wkt.strip():
            try:
                return cls.from_wkt(wkt)
            except CRSError:
                # fall through to the CF grid-mapping attributes
                pass
        gm_name = attrs.get("grid_mapping_name")
        if not gm_name:
            raise CRSError(f"cannot build CRS from attributes: {list(attrs)[:8]}")
        ell = ellipsoid_from_params(
            attrs.get("semi_major_axis"),
            attrs.get("inverse_flattening"),
            attrs.get("semi_minor_axis"),
            attrs.get("reference_ellipsoid_name"),
        )
        if gm_name == "latitude_longitude":
            crs = cls(
                kind="geographic",
                ellipsoid=ell,
                name=attrs.get("geographic_crs_name", "undefined geographic CRS"),
                datum_name=attrs.get(
                    "horizontal_datum_name", "World Geodetic System 1984"
                ),
                axis_lat_lon=True,
            )
            epsg = _match_epsg(crs)
            return _EPSG_CACHE.get(epsg, crs) if epsg else crs
        if gm_name == "rotated_latitude_longitude":
            params = {
                k: attrs[k]
                for k in (
                    "grid_north_pole_latitude",
                    "grid_north_pole_longitude",
                    "north_pole_grid_longitude",
                )
                if k in attrs
            }
            if "grid_north_pole_latitude" not in params:
                raise CRSError("rotated_latitude_longitude needs pole attributes")
            return cls(
                kind="projected",
                ellipsoid=ell,
                proj_name=gm_name,
                params=params,
                name=attrs.get("projected_crs_name", "undefined rotated CRS"),
                datum_name=attrs.get(
                    "horizontal_datum_name", "World Geodetic System 1984"
                ),
            )
        # generic projected CRS: collect numeric projection parameters
        # (plus the two CF *string* parameters of the geostationary family)
        params = {
            k: v
            for k, v in attrs.items()
            if k not in _GEO_PARAM_KEYS and isinstance(v, (int, float, list, tuple))
        }
        for k in ("sweep_angle_axis", "fixed_angle_axis"):
            if isinstance(attrs.get(k), str):
                params[k] = attrs[k]
        crs = cls(
            kind="projected",
            ellipsoid=ell,
            proj_name=str(gm_name),
            params=params,
            name=attrs.get("projected_crs_name", "undefined projected CRS"),
            datum_name=attrs.get("horizontal_datum_name", "World Geodetic System 1984"),
        )
        # validate projection is supported
        try:
            crs.projection()
        except ValueError as e:
            raise CRSError(str(e)) from None
        epsg = _match_epsg(crs)
        return _EPSG_CACHE.get(epsg, crs) if epsg else crs

    # -- WKT (compact WKT2-style, self-describing) --------------------------

    def to_wkt(self) -> str:
        ell = self._ellipsoid
        ell_wkt = (
            f'ELLIPSOID["{ell.name}",{ell.a},{ell.inverse_flattening},'
            f'LENGTHUNIT["metre",1]]'
        )
        tw = (
            f',TOWGS84[{",".join(str(v) for v in self._towgs84)}]'
            if self._towgs84
            else ""
        )
        datum = f'DATUM["{self._datum_name}",{ell_wkt}{tw}]'
        if self.is_geographic:
            body = (
                f'GEOGCRS["{self._name}",{datum},'
                f'CS[ellipsoidal,2],AXIS["{"latitude" if self._axis_lat_lon else "longitude"}",'
                f'{"north" if self._axis_lat_lon else "east"}],'
                f'AXIS["{"longitude" if self._axis_lat_lon else "latitude"}",'
                f'{"east" if self._axis_lat_lon else "north"}],'
                f'ANGLEUNIT["degree",0.0174532925199433]'
            )
        else:
            params = ",".join(
                f'PARAMETER["{k}",{v}]'
                for k, v in sorted(self._params.items())
                if isinstance(v, (int, float))
            )
            # WKT PARAMETER values are numeric, so the geostationary sweep
            # axis rides in the method name (PROJ spells it the same way)
            method = self._proj_name
            if method == "geostationary":
                sweep = str(self._params.get("sweep_angle_axis", "y"))
                method = f"geostationary_sweep_{sweep}"
            # variant A (natural-origin u,v axes) rides in the method name
            # the same way; PARAMETER values are numeric-only
            if method == "oblique_mercator" and self._params.get("_no_uoff"):
                method = "hotine_oblique_mercator_variant_a"
            body = (
                f'PROJCRS["{self._name}",BASEGEOGCRS["{self._datum_name}",{datum}],'
                f'CONVERSION["{self._proj_name}",METHOD["{method}"],{params}],'
                f'CS[Cartesian,2],AXIS["easting",east],AXIS["northing",north],'
                f'LENGTHUNIT["metre",1]'
            )
        if self._epsg:
            return f'{body},ID["EPSG",{self._epsg}]]'
        return body + "]"

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_epsg(cls, code: int | str) -> "CRS":
        try:
            code = int(code)
        except (TypeError, ValueError):
            raise CRSError(f"invalid EPSG code {code!r}") from None
        crs = _epsg(code)
        if crs is None:
            raise CRSError(
                f"unsupported EPSG code {code}. Registered: geographic "
                f"(4326/4258/4269/4230/4277/4301/4267), UTM "
                f"(326xx/327xx WGS 84, 258xx ETRS89, 230xx ED50), "
                f"UPS (5041/5042/32661/32761), 3035, 3857, 3395, 3031, "
                f"3413, 3034, 4087, 6933, 2154, 5243, 2046-2055, 2056, "
                f"21781, 27700, 28992, 31370; any other CRS can be given "
                f"as WKT, proj4, or CF grid-mapping attributes covering "
                f"these projection families: "
                f"{', '.join(sorted(_supported_projections()))}"
            )
        return crs

    @classmethod
    def from_esri(cls, code: int | str) -> "CRS":
        try:
            code = int(code)
        except (TypeError, ValueError):
            raise CRSError(f"invalid ESRI code {code!r}") from None
        crs = _esri(code)
        if crs is None:
            raise CRSError(
                f"unsupported ESRI code {code}. Registered: "
                f"{', '.join(f'ESRI:{c}' for c in sorted(_ESRI_WORLD))}; "
                f"any other CRS can be given as WKT, proj4, or CF "
                f"grid-mapping attributes"
            )
        return crs

    @classmethod
    def from_authority(cls, auth_name: str, code) -> "CRS":
        """pyproj-compatible authority lookup (EPSG, ESRI, OGC)."""
        auth = str(auth_name).strip().upper()
        if auth == "EPSG":
            return cls.from_epsg(code)
        if auth == "ESRI":
            return cls.from_esri(code)
        if auth == "OGC" and str(code).strip().upper() == "CRS84":
            return CRS_CRS84
        raise CRSError(
            f"unsupported authority {auth_name!r} (EPSG, ESRI, OGC:CRS84)"
        )

    @classmethod
    def from_string(cls, text: str) -> "CRS":
        if not isinstance(text, str):
            raise CRSError(f"expected string, got {type(text)}")
        s = text.strip()
        su = s.upper()
        if su in ("OGC:CRS84", "CRS84", "URN:OGC:DEF:CRS:OGC:1.3:CRS84"):
            return CRS_CRS84
        if su in ("WGS84", "WGS 84"):
            return cls.from_epsg(4326)
        m = re.match(r"^(?:EPSG|epsg)\s*:\s*(\d+)$", s)
        if m:
            return cls.from_epsg(int(m.group(1)))
        m = re.match(r"^ESRI\s*:\s*(\d+)$", s, re.IGNORECASE)
        if m:
            return cls.from_esri(int(m.group(1)))
        m = re.match(r"^urn:ogc:def:crs:EPSG:[^:]*:(\d+)$", s, re.IGNORECASE)
        if m:
            return cls.from_epsg(int(m.group(1)))
        if s.startswith("+") or re.match(r"^proj=", s):
            from .proj4 import crs_from_proj4

            try:
                return crs_from_proj4(s)
            except ValueError as e:
                raise CRSError(f"cannot parse proj4 string: {e}") from None
        if re.match(r"^[A-Za-z_][A-Za-z0-9_]*\s*[\[(]", s):
            from .wkt import crs_from_wkt

            try:
                return crs_from_wkt(s)
            except ValueError as e:
                raise CRSError(f"cannot parse WKT: {e}") from None
        raise CRSError(f"cannot parse CRS from {text!r}")

    @classmethod
    def from_user_input(cls, value) -> "CRS":
        if isinstance(value, CRS):
            return value
        if isinstance(value, int):
            return cls.from_epsg(value)
        if isinstance(value, str):
            return cls.from_string(value)
        if isinstance(value, Mapping):
            return cls.from_cf(value)
        raise CRSError(f"cannot create CRS from {value!r}")

    # pyproj-compatible alias
    @classmethod
    def from_wkt(cls, wkt: str) -> "CRS":
        from .wkt import crs_from_wkt

        try:
            return crs_from_wkt(wkt)
        except ValueError as e:
            raise CRSError(f"cannot parse WKT: {e}") from None

    @classmethod
    def from_proj4(cls, text: str) -> "CRS":
        from .proj4 import crs_from_proj4

        try:
            return crs_from_proj4(text)
        except ValueError as e:
            raise CRSError(f"cannot parse proj4 string: {e}") from None


def _utm_params(zone: int) -> dict:
    return {
        "scale_factor_at_central_meridian": 0.9996,
        "longitude_of_central_meridian": float(zone * 6 - 183),
        "latitude_of_projection_origin": 0.0,
        "false_easting": 500000.0,
        "false_northing": 0.0,
    }


_EPSG_CACHE: dict[int, CRS] = {}


def _epsg(code: int) -> CRS | None:
    if code in _EPSG_CACHE:
        return _EPSG_CACHE[code]
    crs: CRS | None = None
    if code == 4326:
        crs = CRS(
            kind="geographic",
            ellipsoid=WGS84,
            name="WGS 84",
            datum_name="World Geodetic System 1984",
            axis_lat_lon=True,
            epsg=4326,
        )
    elif code == 4258:
        crs = CRS(
            kind="geographic",
            ellipsoid=GRS80,
            name="ETRS89",
            datum_name="European Terrestrial Reference System 1989",
            axis_lat_lon=True,
            epsg=4258,
        )
    elif code == 4269:
        crs = CRS(
            kind="geographic",
            ellipsoid=GRS80,
            name="NAD83",
            datum_name="North American Datum 1983",
            axis_lat_lon=True,
            epsg=4269,
        )
    elif code == 4230:
        from .datum import INTL1924

        crs = CRS(
            kind="geographic",
            ellipsoid=INTL1924,
            name="ED50",
            datum_name="European Datum 1950",
            axis_lat_lon=True,
            epsg=4230,
        )
    elif code == 4277:
        from .datum import AIRY1830

        crs = CRS(
            kind="geographic",
            ellipsoid=AIRY1830,
            name="OSGB36",
            datum_name="OSGB 1936",
            axis_lat_lon=True,
            epsg=4277,
        )
    elif code == 4301:
        from .datum import BESSEL1841

        crs = CRS(
            kind="geographic",
            ellipsoid=BESSEL1841,
            name="Tokyo",
            datum_name="Tokyo",
            axis_lat_lon=True,
            epsg=4301,
        )
    elif code == 4267:
        from .datum import CLARKE1866

        crs = CRS(
            kind="geographic",
            ellipsoid=CLARKE1866,
            name="NAD27",
            datum_name="North American Datum 1927",
            axis_lat_lon=True,
            epsg=4267,
        )
    elif code == 27700:
        from .datum import AIRY1830

        crs = CRS(
            kind="projected",
            ellipsoid=AIRY1830,
            proj_name="transverse_mercator",
            params={
                "scale_factor_at_central_meridian": 0.9996012717,
                "longitude_of_central_meridian": -2.0,
                "latitude_of_projection_origin": 49.0,
                "false_easting": 400000.0,
                "false_northing": -100000.0,
            },
            name="OSGB36 / British National Grid",
            datum_name="OSGB 1936",
            epsg=27700,
        )
    elif code == 6933:
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="lambert_cylindrical_equal_area",
            params={
                "standard_parallel": 30.0,
                "longitude_of_central_meridian": 0.0,
                "false_easting": 0.0,
                "false_northing": 0.0,
            },
            name="WGS 84 / NSIDC EASE-Grid 2.0 Global",
            datum_name="World Geodetic System 1984",
            epsg=6933,
        )
    elif code == 3034:
        crs = CRS(
            kind="projected",
            ellipsoid=GRS80,
            proj_name="lambert_conformal_conic",
            params={
                "standard_parallel": [35.0, 65.0],
                "latitude_of_projection_origin": 52.0,
                "longitude_of_central_meridian": 10.0,
                "false_easting": 4000000.0,
                "false_northing": 2800000.0,
            },
            name="ETRS89-extended / LCC Europe",
            datum_name="European Terrestrial Reference System 1989",
            epsg=3034,
        )
    elif code == 3035:
        crs = CRS(
            kind="projected",
            ellipsoid=GRS80,
            proj_name="lambert_azimuthal_equal_area",
            params={
                "latitude_of_projection_origin": 52.0,
                "longitude_of_projection_origin": 10.0,
                "false_easting": 4321000.0,
                "false_northing": 3210000.0,
            },
            name="ETRS89-extended / LAEA Europe",
            datum_name="European Terrestrial Reference System 1989",
            epsg=3035,
        )
    elif code == 3857:
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="mercator",
            params={
                "longitude_of_projection_origin": 0.0,
                "false_easting": 0.0,
                "false_northing": 0.0,
                "_spherical": True,
            },
            name="WGS 84 / Pseudo-Mercator",
            epsg=3857,
        )
    elif code == 3395:
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="mercator",
            params={
                "longitude_of_projection_origin": 0.0,
                "false_easting": 0.0,
                "false_northing": 0.0,
            },
            name="WGS 84 / World Mercator",
            epsg=3395,
        )
    elif code == 3031:
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="polar_stereographic",
            params={
                "latitude_of_projection_origin": -90.0,
                "standard_parallel": -71.0,
                "straight_vertical_longitude_from_pole": 0.0,
                "false_easting": 0.0,
                "false_northing": 0.0,
            },
            name="WGS 84 / Antarctic Polar Stereographic",
            epsg=3031,
        )
    elif code == 3413:
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="polar_stereographic",
            params={
                "latitude_of_projection_origin": 90.0,
                "standard_parallel": 70.0,
                "straight_vertical_longitude_from_pole": -45.0,
                "false_easting": 0.0,
                "false_northing": 0.0,
            },
            name="WGS 84 / NSIDC Sea Ice Polar Stereographic North",
            epsg=3413,
        )
    elif code == 5243:
        crs = CRS(
            kind="projected",
            ellipsoid=GRS80,
            proj_name="lambert_conformal_conic",
            params={
                "standard_parallel": [48.666666666666664, 53.666666666666664],
                "latitude_of_projection_origin": 51.0,
                "longitude_of_central_meridian": 10.5,
                "false_easting": 0.0,
                "false_northing": 0.0,
            },
            name="ETRS89 / LCC Germany (E-N)",
            datum_name="European Terrestrial Reference System 1989",
            epsg=5243,
        )
    elif code == 2154:
        crs = CRS(
            kind="projected",
            ellipsoid=GRS80,
            proj_name="lambert_conformal_conic",
            params={
                "standard_parallel": [49.0, 44.0],
                "latitude_of_projection_origin": 46.5,
                "longitude_of_central_meridian": 3.0,
                "false_easting": 700000.0,
                "false_northing": 6600000.0,
            },
            name="RGF93 v1 / Lambert-93",
            datum_name="Reseau Geodesique Francais 1993 v1",
            epsg=2154,
        )
    elif 32601 <= code <= 32660:
        zone = code - 32600
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="transverse_mercator",
            params=_utm_params(zone),
            name=f"WGS 84 / UTM zone {zone}N",
            epsg=code,
        )
    elif 32701 <= code <= 32760:
        zone = code - 32700
        params = _utm_params(zone)
        params["false_northing"] = 10000000.0
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="transverse_mercator",
            params=params,
            name=f"WGS 84 / UTM zone {zone}S",
            epsg=code,
        )
    elif 25828 <= code <= 25838:
        zone = code - 25800
        crs = CRS(
            kind="projected",
            ellipsoid=GRS80,
            proj_name="transverse_mercator",
            params=_utm_params(zone),
            name=f"ETRS89 / UTM zone {zone}N",
            datum_name="European Terrestrial Reference System 1989",
            epsg=code,
        )
    elif 23028 <= code <= 23038:
        from .datum import INTL1924

        zone = code - 23000
        crs = CRS(
            kind="projected",
            ellipsoid=INTL1924,
            proj_name="transverse_mercator",
            params=_utm_params(zone),
            name=f"ED50 / UTM zone {zone}N",
            datum_name="European Datum 1950",
            epsg=code,
        )
    elif code == 28992:
        from .datum import BESSEL1841

        crs = CRS(
            kind="projected",
            ellipsoid=BESSEL1841,
            proj_name="oblique_stereographic",
            params={
                "latitude_of_projection_origin": 52.15616055555555,
                "longitude_of_projection_origin": 5.38763888888889,
                "scale_factor_at_projection_origin": 0.9999079,
                "false_easting": 155000.0,
                "false_northing": 463000.0,
            },
            name="Amersfoort / RD New",
            datum_name="Amersfoort",
            epsg=28992,
        )
    elif code in (2056, 21781):
        from .datum import BESSEL1841

        lv95 = code == 2056
        crs = CRS(
            kind="projected",
            ellipsoid=BESSEL1841,
            proj_name="swiss_oblique_mercator",
            params={
                "latitude_of_projection_origin": 46.952405555555565,
                "longitude_of_projection_origin": 7.439583333333333,
                "scale_factor_at_projection_origin": 1.0,
                "false_easting": 2600000.0 if lv95 else 600000.0,
                "false_northing": 1200000.0 if lv95 else 200000.0,
            },
            name="CH1903+ / LV95" if lv95 else "CH1903 / LV03",
            datum_name="CH1903+" if lv95 else "CH1903",
            towgs84=(
                (674.374, 15.056, 405.346, 0.0, 0.0, 0.0, 0.0)
                if lv95
                else (674.4, 15.1, 405.3, 0.0, 0.0, 0.0, 0.0)
            ),
            epsg=code,
        )
    elif code == 4087:
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="equirectangular",
            params={
                "standard_parallel": 0.0,
                "latitude_of_projection_origin": 0.0,
                "longitude_of_central_meridian": 0.0,
                "false_easting": 0.0,
                "false_northing": 0.0,
            },
            name="WGS 84 / World Equidistant Cylindrical",
            epsg=4087,
        )
    elif 2046 <= code <= 2055:
        # Hartebeesthoek94 / Lo15 .. Lo33 (odd central meridians, 2 deg
        # apart), the South African south-orientated TM belt
        lo = 15 + 2 * (code - 2046)
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="transverse_mercator_south_orientated",
            params={
                "scale_factor_at_central_meridian": 1.0,
                "longitude_of_central_meridian": float(lo),
                "latitude_of_projection_origin": 0.0,
                "false_easting": 0.0,
                "false_northing": 0.0,
            },
            name=f"Hartebeesthoek94 / Lo{lo}",
            datum_name="Hartebeesthoek94",
            epsg=code,
        )
    elif code in (5041, 32661):
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="polar_stereographic",
            params=_ups_params(north=True),
            name=(
                "WGS 84 / UPS North (E,N)"
                if code == 5041
                else "WGS 84 / UPS North (N,E)"
            ),
            epsg=code,
        )
    elif code in (5042, 32761):
        crs = CRS(
            kind="projected",
            ellipsoid=WGS84,
            proj_name="polar_stereographic",
            params=_ups_params(north=False),
            name=(
                "WGS 84 / UPS South (E,N)"
                if code == 5042
                else "WGS 84 / UPS South (N,E)"
            ),
            epsg=code,
        )
    elif code == 31370:
        from .datum import INTL1924

        crs = CRS(
            kind="projected",
            ellipsoid=INTL1924,
            proj_name="lambert_conformal_conic",
            params={
                "standard_parallel": [51.16666723333333, 49.8333339],
                "latitude_of_projection_origin": 90.0,
                "longitude_of_central_meridian": 4.367486666666666,
                "false_easting": 150000.013,
                "false_northing": 5400088.438,
            },
            name="BD72 / Belgian Lambert 72",
            datum_name="Reseau National Belge 1972",
            epsg=31370,
        )
    if crs is not None:
        _EPSG_CACHE[code] = crs
    return crs


def _ups_params(north: bool) -> dict:
    """Universal Polar Stereographic (EPSG method 9810 variant A):
    scale factor 0.994 at the pole, 2000 km false origin offsets."""
    return {
        "latitude_of_projection_origin": 90.0 if north else -90.0,
        "straight_vertical_longitude_from_pole": 0.0,
        "scale_factor_at_projection_origin": 0.994,
        "false_easting": 2000000.0,
        "false_northing": 2000000.0,
    }


def _supported_projections():
    from .projections import PROJECTION_FACTORIES

    return PROJECTION_FACTORIES.keys()


_ESRI_CACHE: dict[int, CRS] = {}

#: ESRI:54xxx world projections on the WGS 84 datum that map onto the
#: engine's projection families (the reference accepts these through
#: pyproj, xcube_resampling/reproject.py:124-126)
_ESRI_WORLD = {
    54004: ("World_Mercator", "mercator", {}),
    54008: ("World_Sinusoidal", "sinusoidal", {}),
    54009: ("World_Mollweide", "mollweide", {}),
    54032: ("World_Azimuthal_Equidistant", "azimuthal_equidistant", {}),
    54034: (
        "World_Cylindrical_Equal_Area",
        "lambert_cylindrical_equal_area",
        {"standard_parallel": 0.0},
    ),
}


def _esri(code: int) -> CRS | None:
    if code in _ESRI_CACHE:
        return _ESRI_CACHE[code]
    entry = _ESRI_WORLD.get(code)
    if entry is None:
        return None
    name, proj_name, extra = entry
    params = {
        "longitude_of_central_meridian": 0.0,
        "latitude_of_projection_origin": 0.0,
        "false_easting": 0.0,
        "false_northing": 0.0,
    }
    params.update(extra)
    crs = CRS(
        kind="projected",
        ellipsoid=WGS84,
        proj_name=proj_name,
        params=params,
        name=name,
    )
    _ESRI_CACHE[code] = crs
    return crs


def _match_epsg(crs: CRS) -> int | None:
    """Try to identify a CRS built from raw parameters with a known EPSG
    entry (so e.g. a CF transverse_mercator with UTM-32 parameters compares
    equal to CRS.from_epsg(32632))."""
    candidates: list[int] = [
        4326, 4258, 4269, 4230, 4277, 4301, 4267, 3035, 3857, 3395, 3031,
        3413, 2154, 6933, 3034, 27700, 28992, 31370, 5041, 5042,
    ]
    if crs.is_projected and crs.proj_name == "transverse_mercator":
        lon0 = crs._params.get("longitude_of_central_meridian")
        if lon0 is not None and (float(lon0) + 183.0) % 6 == 0:
            zone = int(round((float(lon0) + 183.0) / 6))
            if 1 <= zone <= 60:
                candidates += [
                    32600 + zone, 32700 + zone, 25800 + zone, 23000 + zone,
                ]
    # datum names carried by proj4 strings / partial CF attrs are often
    # placeholders ("unknown based on GRS 1980"): the ellipsoid in the key
    # still pins the frame family, so match without the datum name then
    from .datum import canonical_datum_key

    anonymous = canonical_datum_key(crs._datum_name).startswith("unknown")
    for code in candidates:
        known = _epsg(code)
        if known is None:
            continue
        if anonymous:
            # a datum-less CRS is an unshifted "ballpark" frame (PROJ
            # semantics): only promote it to registry entries whose datum
            # carries no Helmert shift, so the match can never introduce
            # an implicit datum transform the input never asked for
            from .datum import towgs84_for_datum

            shift = towgs84_for_datum(known._datum_name)
            if shift is not None and any(shift):
                continue
        if known._key(with_datum=not anonymous) == crs._key(
            with_datum=not anonymous
        ):
            return code
    return None


#: WGS84 geographic CRS with (lat, lon) axis order — pyproj CRS(4326) parity
CRS_WGS84 = CRS.from_epsg(4326)

#: WGS84 geographic CRS with (lon, lat) axis order — OGC:CRS84 parity
CRS_CRS84 = CRS(
    kind="geographic",
    ellipsoid=WGS84,
    name="WGS 84 (CRS84)",
    datum_name="World Geodetic System 1984",
    axis_lat_lon=False,
)
