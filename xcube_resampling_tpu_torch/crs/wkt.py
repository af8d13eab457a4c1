"""WKT 1 / WKT 2 parsing for the native CRS engine.

The reference accepts any WKT via ``pyproj.CRS.from_user_input`` (reference
gridmapping/cfconv.py:215-252, base.py:49-52).  This module gives the
from-scratch rebuild the same front door for the projection families the
engine implements: a tolerant recursive-descent WKT parser (both the 2001
"WKT1" and ISO 19162 "WKT2" grammars, including BOUNDCRS/TOWGS84 datum
transforms), a normalized generic-parameter layer shared with the proj4
parser (:mod:`.proj4`), and EPSG-id short-circuiting into the registry.

Unknown nodes (USAGE, SCOPE, AREA, BBOX, REMARK, DYNAMIC, ...) are ignored;
unsupported projection methods raise :class:`~.core.CRSError` with the
method name.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

from .datum import Ellipsoid, ellipsoid_from_params

_DEG = math.pi / 180.0


# ---------------------------------------------------------------------------
# generic tree
# ---------------------------------------------------------------------------


@dataclass
class Node:
    keyword: str  # upper-cased
    items: list = field(default_factory=list)  # str | float | Node

    def strings(self):
        return [i for i in self.items if isinstance(i, str)]

    def numbers(self):
        return [i for i in self.items if isinstance(i, float)]

    def children(self, *keywords):
        kws = {k.upper() for k in keywords}
        return [i for i in self.items if isinstance(i, Node) and i.keyword in kws]

    def child(self, *keywords):
        c = self.children(*keywords)
        return c[0] if c else None


_TOKEN = re.compile(
    r"""\s*(?:
        (?P<quoted>"(?:[^"]|"")*")          # quoted string ("" = escaped ")
      | (?P<num>[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)
      | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<punct>[\[\](),])
    )""",
    re.VERBOSE,
)


def _tokens(text: str):
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip():
                raise ValueError(f"WKT: cannot tokenize at {text[pos:pos+20]!r}")
            return
        pos = m.end()
        if m.lastgroup == "quoted":
            yield ("str", m.group("quoted")[1:-1].replace('""', '"'))
        elif m.lastgroup == "num":
            yield ("num", float(m.group("num")))
        elif m.lastgroup == "word":
            yield ("word", m.group("word"))
        else:
            yield ("punct", m.group("punct"))


def parse_wkt_tree(text: str) -> Node:
    """Parse WKT text into a generic keyword tree (grammar-agnostic)."""
    toks = list(_tokens(text))
    pos = 0

    def parse_node():
        nonlocal pos
        kind, kw = toks[pos]
        if kind != "word":
            raise ValueError(f"WKT: expected keyword, got {kw!r}")
        pos += 1
        node = Node(kw.upper())
        if pos >= len(toks) or toks[pos] != ("punct", "[") and toks[pos] != (
            "punct",
            "(",
        ):
            return node
        closer = "]" if toks[pos] == ("punct", "[") else ")"
        pos += 1
        while True:
            if pos >= len(toks):
                raise ValueError("WKT: premature end of input")
            kind, val = toks[pos]
            if kind == "punct" and val == closer:
                pos += 1
                return node
            if kind == "punct" and val == ",":
                pos += 1
                continue
            if kind == "str":
                node.items.append(val)
                pos += 1
            elif kind == "num":
                node.items.append(val)
                pos += 1
            elif kind == "word":
                # bare enum (axis direction, "north") or a nested node
                if pos + 1 < len(toks) and toks[pos + 1] in (
                    ("punct", "["),
                    ("punct", "("),
                ):
                    node.items.append(parse_node())
                else:
                    node.items.append(val)
                    pos += 1
            else:
                raise ValueError(f"WKT: unexpected token {val!r}")

    if not toks:
        raise ValueError("WKT: empty input")
    node = parse_node()
    return node


# ---------------------------------------------------------------------------
# unit handling
# ---------------------------------------------------------------------------


def _unit_factor(node: Node | None, default: float) -> float:
    """Conversion factor to radians (angle units) or metres (length units)
    from a UNIT/ANGLEUNIT/LENGTHUNIT node."""
    if node is None:
        return default
    nums = node.numbers()
    return nums[0] if nums else default


def _param_value(p: Node, angle: bool) -> float:
    """PARAMETER value normalized to degrees (angles) or metres (lengths)."""
    nums = p.numbers()
    if not nums:
        raise ValueError(f"WKT: PARAMETER {p.strings()[:1]} has no value")
    value = nums[0]
    unit = p.child("ANGLEUNIT", "LENGTHUNIT", "UNIT", "SCALEUNIT")
    if unit is None:
        return value
    factor = _unit_factor(unit, _DEG if angle else 1.0)
    if angle:
        return value * factor / _DEG
    if unit.keyword == "SCALEUNIT":
        return value * factor
    return value * factor


# ---------------------------------------------------------------------------
# method / parameter normalization (shared with the proj4 parser)
# ---------------------------------------------------------------------------


def _norm(name: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")


#: EPSG/ESRI/legacy method name -> engine projection family
_METHODS = {
    "transverse_mercator": "transverse_mercator",
    "gauss_kruger": "transverse_mercator",
    "lambert_azimuthal_equal_area": "lambert_azimuthal_equal_area",
    "mercator_variant_a": "mercator",
    "mercator_variant_b": "mercator",
    "mercator_1sp": "mercator",
    "mercator_2sp": "mercator",
    "mercator": "mercator",
    "popular_visualisation_pseudo_mercator": "pseudo_mercator",
    "mercator_auxiliary_sphere": "pseudo_mercator",
    "pseudo_mercator": "pseudo_mercator",
    "lambert_conic_conformal_2sp": "lambert_conformal_conic",
    "lambert_conic_conformal_1sp": "lambert_conformal_conic",
    "lambert_conformal_conic_2sp": "lambert_conformal_conic",
    "lambert_conformal_conic_1sp": "lambert_conformal_conic",
    "lambert_conformal_conic": "lambert_conformal_conic",
    "albers_equal_area": "albers_conical_equal_area",
    "albers_conic_equal_area": "albers_conical_equal_area",
    "albers_conical_equal_area": "albers_conical_equal_area",
    "polar_stereographic_variant_a": "polar_stereographic",
    "polar_stereographic_variant_b": "polar_stereographic",
    "polar_stereographic": "polar_stereographic",
    "lambert_cylindrical_equal_area": "lambert_cylindrical_equal_area",
    "lambert_cylindrical_equal_area_spherical": "lambert_cylindrical_equal_area",
    "cylindrical_equal_area": "lambert_cylindrical_equal_area",
    "sinusoidal": "sinusoidal",
    "rotated_latitude_longitude": "rotated_latitude_longitude",
    "stereographic": "stereographic",
    "oblique_stereographic": "oblique_stereographic",
    "double_stereographic": "oblique_stereographic",
    "roussilhe": "oblique_stereographic",
    "orthographic": "orthographic",
    "orthographic_geocentric": "orthographic",
    "geostationary": "geostationary",
    "geostationary_satellite": "geostationary",
    "geostationary_satellite_sweep_x": "geostationary_sweep_x",
    "geostationary_sweep_x": "geostationary_sweep_x",
    "geostationary_satellite_sweep_y": "geostationary_sweep_y",
    "geostationary_sweep_y": "geostationary_sweep_y",
    "transverse_mercator_south_orientated": (
        "transverse_mercator_south_orientated"
    ),
    "transverse_mercator_south_oriented": (
        "transverse_mercator_south_orientated"
    ),
    "gauss_conform_south_orientated": "transverse_mercator_south_orientated",
    "equidistant_cylindrical": "equirectangular",
    "equidistant_cylindrical_spherical": "equirectangular",
    "equirectangular": "equirectangular",
    "plate_carree": "equirectangular",
    "mollweide": "mollweide",
    "azimuthal_equidistant": "azimuthal_equidistant",
    "modified_azimuthal_equidistant": "azimuthal_equidistant",
    "oblique_mercator": "oblique_mercator",
    "hotine_oblique_mercator_variant_b": "oblique_mercator",
    "hotine_oblique_mercator_azimuth_center": "oblique_mercator",
    "rectified_skew_orthomorphic_center": "oblique_mercator",
    # WKT1/GDAL "Hotine_Oblique_Mercator" and EPSG variant A keep the
    # natural-origin (u, v) axes: +no_uoff
    "hotine_oblique_mercator": "oblique_mercator_variant_a",
    "hotine_oblique_mercator_variant_a": "oblique_mercator_variant_a",
    "rectified_skew_orthomorphic_natural_origin": (
        "oblique_mercator_variant_a"
    ),
    "swiss_oblique_cylindrical": "swiss_oblique_mercator",
    "swiss_oblique_mercator": "swiss_oblique_mercator",
    "vertical_perspective": "vertical_perspective",
    "general_vertical_near_sided_perspective": "vertical_perspective",
    "near_sided_perspective": "vertical_perspective",
}

#: EPSG/WKT1/proj parameter name -> generic key
_PARAMS = {
    # angles
    "latitude_of_natural_origin": ("lat_0", True),
    "latitude_of_origin": ("lat_0", True),
    "latitude_of_projection_origin": ("lat_0", True),
    "latitude_of_false_origin": ("lat_0", True),
    "latitude_of_center": ("lat_0", True),
    "latitude_of_centre": ("lat_0", True),
    "longitude_of_natural_origin": ("lon_0", True),
    "central_meridian": ("lon_0", True),
    "longitude_of_projection_origin": ("lon_0", True),
    "longitude_of_central_meridian": ("lon_0", True),
    "longitude_of_false_origin": ("lon_0", True),
    "longitude_of_center": ("lon_0", True),
    "longitude_of_centre": ("lon_0", True),
    "longitude_of_origin": ("lon_0", True),
    "straight_vertical_longitude_from_pole": ("lon_0", True),
    "latitude_of_1st_standard_parallel": ("sp1", True),
    "standard_parallel_1": ("sp1", True),
    "standard_parallel": ("sp1", True),
    "latitude_of_standard_parallel": ("sp1", True),
    "latitude_of_true_scale": ("sp1", True),
    "latitude_of_2nd_standard_parallel": ("sp2", True),
    "standard_parallel_2": ("sp2", True),
    "latitude_of_north_pole": ("pole_lat", True),
    "grid_north_pole_latitude": ("pole_lat", True),
    "longitude_of_north_pole": ("pole_lon", True),
    "grid_north_pole_longitude": ("pole_lon", True),
    "north_pole_grid_longitude": ("pole_rot", True),
    "azimuth": ("az", True),
    "azimuth_of_initial_line": ("az", True),
    "azimuth_at_projection_centre": ("az", True),
    "azimuth_of_central_line": ("az", True),
    "angle_from_rectified_to_skew_grid": ("gamma", True),
    "rectified_grid_angle": ("gamma", True),
    # scales
    "scale_factor_at_natural_origin": ("k_0", False),
    "scale_factor": ("k_0", False),
    "scale_factor_at_projection_origin": ("k_0", False),
    "scale_factor_on_initial_line": ("k_0", False),
    "scale_factor_at_center": ("k_0", False),
    "scale_factor_at_centre": ("k_0", False),
    # lengths
    "false_easting": ("x_0", False),
    "easting_at_false_origin": ("x_0", False),
    "easting_at_projection_centre": ("x_0", False),
    "false_northing": ("y_0", False),
    "northing_at_false_origin": ("y_0", False),
    "northing_at_projection_centre": ("y_0", False),
    "satellite_height": ("h", False),
    "perspective_point_height": ("h", False),
    "height": ("h", False),
}


def build_projected_params(family: str, g: dict) -> tuple[str, dict]:
    """Map a projection family + generic parameters (lat_0/lon_0/k_0/x_0/
    y_0/sp1/sp2/pole_*) to the engine's CF-style parameter dict.  Raises
    ValueError for parameter combinations the engine does not implement."""
    x_0 = float(g.get("x_0", 0.0))
    y_0 = float(g.get("y_0", 0.0))
    lat_0 = float(g.get("lat_0", 0.0))
    lon_0 = float(g.get("lon_0", 0.0))
    k_0 = float(g.get("k_0", 1.0))
    sp1 = g.get("sp1")
    sp2 = g.get("sp2")

    if family == "transverse_mercator":
        return "transverse_mercator", {
            "scale_factor_at_central_meridian": k_0,
            "longitude_of_central_meridian": lon_0,
            "latitude_of_projection_origin": lat_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "lambert_azimuthal_equal_area":
        return "lambert_azimuthal_equal_area", {
            "latitude_of_projection_origin": lat_0,
            "longitude_of_projection_origin": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family in ("mercator", "pseudo_mercator"):
        if sp1 not in (None, 0.0) or k_0 != 1.0:
            raise ValueError(
                "mercator with standard parallel / scale factor "
                "is not supported (variant A k0=1 or spherical only)"
            )
        params = {
            "longitude_of_projection_origin": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
        if family == "pseudo_mercator":
            params["_spherical"] = True
        return "mercator", params
    if family == "lambert_conformal_conic":
        if sp1 is None:
            sp1 = lat_0  # 1SP form
        if k_0 != 1.0:
            raise ValueError(
                "Lambert conformal conic with scale factor != 1 is not supported"
            )
        sp = [float(sp1), float(sp2)] if sp2 is not None else float(sp1)
        return "lambert_conformal_conic", {
            "standard_parallel": sp,
            "latitude_of_projection_origin": lat_0,
            "longitude_of_central_meridian": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "albers_conical_equal_area":
        sp = (
            [float(sp1), float(sp2)]
            if sp2 is not None
            else float(sp1 if sp1 is not None else lat_0)
        )
        return "albers_conical_equal_area", {
            "standard_parallel": sp,
            "latitude_of_projection_origin": lat_0,
            "longitude_of_central_meridian": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "polar_stereographic":
        # variant B: standard parallel; variant A: scale factor at the pole
        params = {
            "latitude_of_projection_origin": lat_0 if lat_0 else (
                90.0 if (sp1 or 90.0) > 0 else -90.0
            ),
            "straight_vertical_longitude_from_pole": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
        if sp1 is not None:
            params["standard_parallel"] = float(sp1)
        if k_0 != 1.0:
            params["scale_factor_at_projection_origin"] = k_0
        return "polar_stereographic", params
    if family == "lambert_cylindrical_equal_area":
        return "lambert_cylindrical_equal_area", {
            "standard_parallel": float(sp1 if sp1 is not None else 0.0),
            "longitude_of_central_meridian": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "sinusoidal":
        return "sinusoidal", {
            "longitude_of_projection_origin": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "stereographic":
        if abs(lat_0) >= 89.999:
            # polar center: same CRS identity as the polar_stereographic
            # method so EPSG matching (3031/3413/...) keeps working
            return build_projected_params("polar_stereographic", g)
        return "stereographic", {
            "latitude_of_projection_origin": lat_0,
            "longitude_of_projection_origin": lon_0,
            "scale_factor_at_projection_origin": k_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "oblique_stereographic":
        return "oblique_stereographic", {
            "latitude_of_projection_origin": lat_0,
            "longitude_of_projection_origin": lon_0,
            "scale_factor_at_projection_origin": k_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "orthographic":
        return "orthographic", {
            "latitude_of_projection_origin": lat_0,
            "longitude_of_projection_origin": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family in (
        "geostationary", "geostationary_sweep_x", "geostationary_sweep_y"
    ):
        if "h" not in g:
            raise ValueError(
                "geostationary needs a satellite height parameter"
            )
        sweep = "x" if family.endswith("_x") else (
            "y" if family.endswith("_y") else str(g.get("sweep", "y"))
        )
        return "geostationary", {
            "perspective_point_height": float(g["h"]),
            "longitude_of_projection_origin": lon_0,
            "sweep_angle_axis": sweep,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "transverse_mercator_south_orientated":
        return "transverse_mercator_south_orientated", {
            "scale_factor_at_central_meridian": k_0,
            "longitude_of_central_meridian": lon_0,
            "latitude_of_projection_origin": lat_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "equirectangular":
        return "equirectangular", {
            "standard_parallel": float(sp1 if sp1 is not None else 0.0),
            "latitude_of_projection_origin": lat_0,
            "longitude_of_central_meridian": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "mollweide":
        return "mollweide", {
            "longitude_of_projection_origin": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "azimuthal_equidistant":
        return "azimuthal_equidistant", {
            "latitude_of_projection_origin": lat_0,
            "longitude_of_projection_origin": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family in ("oblique_mercator", "oblique_mercator_variant_a"):
        az = float(g.get("az", 90.0))
        params = {
            "latitude_of_projection_origin": lat_0,
            "longitude_of_projection_origin": lon_0,
            "azimuth_of_central_line": az,
            "rectified_grid_angle": float(g.get("gamma", az)),
            "scale_factor_at_projection_origin": k_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
        if family.endswith("_variant_a") or g.get("no_uoff"):
            params["_no_uoff"] = True
        return "oblique_mercator", params
    if family == "swiss_oblique_mercator":
        return "swiss_oblique_mercator", {
            "latitude_of_projection_origin": lat_0,
            "longitude_of_projection_origin": lon_0,
            "scale_factor_at_projection_origin": k_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "vertical_perspective":
        if "h" not in g:
            raise ValueError(
                "vertical_perspective needs a perspective height parameter"
            )
        return "vertical_perspective", {
            "perspective_point_height": float(g["h"]),
            "latitude_of_projection_origin": lat_0,
            "longitude_of_projection_origin": lon_0,
            "false_easting": x_0,
            "false_northing": y_0,
        }
    if family == "rotated_latitude_longitude":
        params = {
            "grid_north_pole_latitude": float(g.get("pole_lat", 90.0)),
            "grid_north_pole_longitude": float(g.get("pole_lon", 0.0)),
        }
        if "pole_rot" in g:
            params["north_pole_grid_longitude"] = float(g["pole_rot"])
        return "rotated_latitude_longitude", params
    raise ValueError(f"unsupported projection method {family!r}")


# ---------------------------------------------------------------------------
# WKT -> CRS
# ---------------------------------------------------------------------------


def _node_epsg(node: Node) -> int | None:
    """EPSG code from an ID["EPSG",n] (WKT2) or AUTHORITY["EPSG","n"]
    (WKT1) child."""
    for ident in node.children("ID", "AUTHORITY"):
        strs = ident.strings()
        if strs and strs[0].upper() == "EPSG":
            if len(strs) > 1 and strs[1].isdigit():
                return int(strs[1])
            nums = ident.numbers()
            if nums:
                return int(nums[0])
    return None


def _parse_ellipsoid(datum: Node) -> tuple[Ellipsoid, str]:
    ell_node = datum.child("ELLIPSOID", "SPHEROID")
    datum_name = (datum.strings() or ["unknown"])[0]
    if ell_node is None:
        raise ValueError(f"WKT: datum {datum_name!r} has no ellipsoid")
    nums = ell_node.numbers()
    if len(nums) < 2:
        raise ValueError("WKT: ellipsoid needs semi-major axis + 1/f")
    a, rf = nums[0], nums[1]
    unit = ell_node.child("LENGTHUNIT", "UNIT")
    a *= _unit_factor(unit, 1.0)
    name = (ell_node.strings() or ["unnamed"])[0]
    ell = ellipsoid_from_params(a, rf if rf else None, None, name)
    return ell, datum_name


def _parse_towgs84(datum: Node) -> tuple | None:
    t = datum.child("TOWGS84")
    if t is None:
        return None
    nums = list(t.numbers())
    while len(nums) < 7:
        nums.append(0.0)
    return tuple(nums[:7])


def _find_datum(crs_node: Node) -> Node:
    d = crs_node.child("DATUM", "TRF", "GEODETICDATUM", "ENSEMBLE")
    if d is None:
        raise ValueError("WKT: no datum node found")
    return d


def _geographic_axis_lat_first(crs_node: Node) -> bool:
    axes = crs_node.children("AXIS")
    if not axes:
        return True  # EPSG geographic CRSs default to (lat, lon)
    label = " ".join(axes[0].strings()).lower()
    return "lat" in label or "north" in label


def crs_from_wkt(text: str):
    """Parse a WKT1/WKT2 CRS string into a :class:`~.core.CRS`.

    EPSG ids found in the WKT short-circuit into the registry (canonical
    parameters and names); otherwise the CRS is built from the parsed
    datum/method/parameters.  Raises ``ValueError`` on unsupported content
    (callers wrap into CRSError)."""
    from .core import CRS, _epsg

    root = parse_wkt_tree(text)

    towgs84 = None
    if root.keyword == "BOUNDCRS":
        src = root.child("SOURCECRS")
        if src is None:
            raise ValueError("WKT: BOUNDCRS without SOURCECRS")
        inner = [i for i in src.items if isinstance(i, Node)]
        if not inner:
            raise ValueError("WKT: empty SOURCECRS")
        tf = root.child("ABRIDGEDTRANSFORMATION")
        if tf is not None:
            vals = {}
            for p in tf.children("PARAMETER"):
                strs = p.strings()
                nums = p.numbers()
                if strs and nums:
                    vals[_norm(strs[0])] = nums[0]
            order = (
                "x_axis_translation",
                "y_axis_translation",
                "z_axis_translation",
                "x_axis_rotation",
                "y_axis_rotation",
                "z_axis_rotation",
                "scale_difference",
            )
            if vals:
                t = [float(vals.get(k, 0.0)) for k in order]
                # WKT2 abridged form carries the scale difference as the
                # ratio 1 + ds*1e-6 (e.g. 0.999979511 for -20.489 ppm);
                # convert back to ppm for the towgs84 slot
                if "scale_difference" in vals:
                    t[6] = (float(vals["scale_difference"]) - 1.0) * 1e6
                towgs84 = tuple(t)
        root = inner[0]

    kw = root.keyword
    if kw in ("GEOGCRS", "GEOGCS", "GEODCRS", "GEODETICCRS"):
        return _geographic_from_node(root, towgs84)
    if kw in ("PROJCRS", "PROJCS", "PROJECTEDCRS"):
        return _projected_from_node(root, towgs84)
    if kw in ("COMPOUNDCRS", "COMPD_CS"):
        for item in root.items:
            if isinstance(item, Node) and item.keyword in (
                "PROJCRS", "PROJCS", "GEOGCRS", "GEOGCS",
            ):
                return crs_from_wkt_node(item, towgs84)
        raise ValueError("WKT: compound CRS without horizontal member")
    raise ValueError(f"WKT: unsupported CRS type {kw!r}")


def crs_from_wkt_node(node: Node, towgs84=None):
    if node.keyword in ("GEOGCRS", "GEOGCS", "GEODCRS", "GEODETICCRS"):
        return _geographic_from_node(node, towgs84)
    return _projected_from_node(node, towgs84)


def _registry_hit(node: Node):
    from .core import _epsg

    code = _node_epsg(node)
    if code is not None:
        crs = _epsg(code)
        if crs is not None:
            return crs
    return None


def _geographic_from_node(node: Node, towgs84=None):
    from .core import CRS

    hit = _registry_hit(node)
    if hit is not None and towgs84 is None:
        return hit
    datum = _find_datum(node)
    ell, datum_name = _parse_ellipsoid(datum)
    if towgs84 is None:
        towgs84 = _parse_towgs84(datum)
    name = (node.strings() or ["unnamed"])[0]
    crs = CRS(
        kind="geographic",
        ellipsoid=ell,
        name=name,
        datum_name=datum_name,
        axis_lat_lon=_geographic_axis_lat_first(node),
        epsg=_node_epsg(node),
        towgs84=towgs84,
    )
    return _into_registry(crs)


def _projected_from_node(node: Node, towgs84=None):
    from .core import CRS

    hit = _registry_hit(node)
    if hit is not None and towgs84 is None:
        return hit

    base = node.child("BASEGEOGCRS", "GEOGCS", "BASEGEODCRS")
    if base is None:
        raise ValueError("WKT: projected CRS without base geographic CRS")
    datum = _find_datum(base)
    ell, datum_name = _parse_ellipsoid(datum)
    if towgs84 is None:
        towgs84 = _parse_towgs84(datum)

    # WKT2: CONVERSION[name, METHOD[...], PARAMETER...]
    # WKT1: PROJECTION[name] + PARAMETER... directly under PROJCS
    conv = node.child("CONVERSION")
    if conv is not None:
        method = conv.child("METHOD", "PROJECTION")
        if method is None:
            raise ValueError("WKT: CONVERSION without METHOD")
        method_name = (method.strings() or ["?"])[0]
        param_nodes = conv.children("PARAMETER")
    else:
        proj = node.child("PROJECTION")
        if proj is None:
            raise ValueError("WKT: projected CRS without projection method")
        method_name = (proj.strings() or ["?"])[0]
        param_nodes = node.children("PARAMETER")

    family = _METHODS.get(_norm(method_name))
    if family is None:
        raise ValueError(f"unsupported projection method {method_name!r}")

    generic: dict = {}
    for p in param_nodes:
        strs = p.strings()
        if not strs:
            continue
        key = _PARAMS.get(_norm(strs[0]))
        if key is None:
            continue
        gkey, is_angle = key
        generic[gkey] = _param_value(p, is_angle)

    # WKT1 projected length unit scales false easting/northing
    unit = node.child("LENGTHUNIT") or node.child("UNIT")
    if unit is not None:
        f = _unit_factor(unit, 1.0)
        if f != 1.0:
            generic["x_0"] = generic.get("x_0", 0.0) * f
            generic["y_0"] = generic.get("y_0", 0.0) * f

    proj_name, params = build_projected_params(family, generic)
    name = (node.strings() or ["unnamed"])[0]
    crs = CRS(
        kind="projected",
        ellipsoid=ell,
        proj_name=proj_name,
        params=params,
        name=name,
        datum_name=datum_name,
        epsg=_node_epsg(node),
        towgs84=towgs84,
    )
    crs.projection()  # validate now -> ValueError surfaces to the caller
    return _into_registry(crs)


def _into_registry(crs):
    """Swap a parsed CRS for its registry twin when one exists (canonical
    names, cached projection closures)."""
    from .core import _EPSG_CACHE, _match_epsg

    if crs.towgs84 is not None:
        return crs
    code = crs.to_epsg() or _match_epsg(crs)
    known = _EPSG_CACHE.get(code) if code else None
    return known if known is not None and known == crs else crs
