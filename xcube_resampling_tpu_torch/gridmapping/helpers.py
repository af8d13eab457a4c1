"""Numeric and naming helpers for grid mappings.

Port of the reference's gridmapping/helpers.py semantics
(xcube_resampling/gridmapping/helpers.py:39-255) minus the
``affine``/dask/xarray dependencies: 2x3 affine matrix algebra is implemented
natively in :class:`Affine`, lon-360 wrapping works on numpy arrays and
xrlite DataArrays.
"""

from __future__ import annotations

import math
from collections.abc import Hashable
from fractions import Fraction
from typing import Any

import numpy as np

from ..constants import AffineTransformMatrix, FloatInt
from ..crs import CRS
from ..xrlite import DataArray, Dataset
from .assertions import assert_given, assert_instance, assert_true
from .undefined import UNDEFINED


class Affine:
    """Minimal 2x3 affine transform (a, b, c, d, e, f):

        x' = a * x + b * y + c
        y' = d * x + e * y + f

    Replacement for the external ``affine.Affine`` dependency
    (reference helpers.py:51-56)."""

    __slots__ = ("a", "b", "c", "d", "e", "f")

    def __init__(self, a, b, c, d, e, f):
        self.a, self.b, self.c, self.d, self.e, self.f = a, b, c, d, e, f

    def __mul__(self, other):
        if isinstance(other, Affine):
            # composition: self âˆ˜ other (apply other first)
            a1, b1, c1, d1, e1, f1 = self.a, self.b, self.c, self.d, self.e, self.f
            a2, b2, c2, d2, e2, f2 = (
                other.a,
                other.b,
                other.c,
                other.d,
                other.e,
                other.f,
            )
            return Affine(
                a1 * a2 + b1 * d2,
                a1 * b2 + b1 * e2,
                a1 * c2 + b1 * f2 + c1,
                d1 * a2 + e1 * d2,
                d1 * b2 + e1 * e2,
                d1 * c2 + e1 * f2 + f1,
            )
        x, y = other
        return (
            self.a * x + self.b * y + self.c,
            self.d * x + self.e * y + self.f,
        )

    def __invert__(self) -> "Affine":
        # reciprocal-determinant formulation (bit-compatible with the
        # `affine` package used by the reference)
        det = self.a * self.e - self.b * self.d
        if det == 0:
            raise ValueError("affine matrix is not invertible")
        idet = 1.0 / det
        ra = self.e * idet
        rb = -self.b * idet
        rd = -self.d * idet
        re = self.a * idet
        return Affine(
            ra,
            rb,
            -self.c * ra - self.f * rb,
            rd,
            re,
            -self.c * rd - self.f * re,
        )

    def __eq__(self, other):
        if not isinstance(other, Affine):
            return NotImplemented
        return (self.a, self.b, self.c, self.d, self.e, self.f) == (
            other.a,
            other.b,
            other.c,
            other.d,
            other.e,
            other.f,
        )

    def __repr__(self):
        return f"Affine({self.a}, {self.b}, {self.c}, {self.d}, {self.e}, {self.f})"


def _to_int_or_float(x: FloatInt) -> FloatInt:
    """If x is an int or close to an int return it as int, else float —
    guards against floating point drift in grid geometry
    (reference helpers.py:39-48)."""
    if isinstance(x, int):
        return x
    xf = float(x)
    if math.isnan(xf):
        raise ValueError(
            "grid geometry value is NaN — the coordinate arrays likely"
            " contain only non-finite values where a finite extent or"
            " resolution was required"
        )
    xi = round(xf)
    return xi if math.isclose(xi, xf, rel_tol=1e-5) else xf


def _from_affine(matrix: Affine) -> AffineTransformMatrix:
    return (matrix.a, matrix.b, matrix.c), (matrix.d, matrix.e, matrix.f)


def _to_affine(matrix: AffineTransformMatrix) -> Affine:
    return Affine(*matrix[0], *matrix[1])


def _normalize_crs(crs: str | CRS) -> CRS:
    if isinstance(crs, CRS):
        return crs
    assert_instance(crs, str, "crs")
    return CRS.from_string(crs)


def _normalize_pair(value, name, default, scalar_types, cast, kind):
    """Shared body of the int/number pair normalizers: scalars duplicate
    into both slots, 2-sequences map through *cast*, None falls back to
    *default* (UNDEFINED default = the argument was required)."""
    if isinstance(value, scalar_types):
        return cast(value), cast(value)
    if value is not None:
        x, y = value
        return cast(x), cast(y)
    if default != UNDEFINED:
        return default
    assert_given(name, "name")
    raise ValueError(f"{name} must be {kind}")


def _normalize_int_pair(
    value: Any, name: str = None, default: tuple[int, int] | None = UNDEFINED
) -> tuple[int, int]:
    return _normalize_pair(
        value, name, default, int, int, "an int or a sequence of two ints"
    )


def _normalize_number_pair(
    value: Any, name: str = None, default: tuple[FloatInt, FloatInt] | None = UNDEFINED
) -> tuple[FloatInt, FloatInt]:
    return _normalize_pair(
        value,
        name,
        default,
        (float, int),
        _to_int_or_float,
        "a number or a sequence of two numbers",
    )


def _shift_lon(lon_var, keep_if, shift):
    """Shift longitudes by *shift* wherever ``keep_if`` is False."""
    if isinstance(lon_var, DataArray):
        return lon_var.where(keep_if(np.asarray(lon_var.data)), lon_var + shift)
    arr = np.asarray(lon_var)
    return np.where(keep_if(arr), arr, arr + shift)


def to_lon_360(lon_var):
    """Wrap longitudes into [0, 360) (reference helpers.py:97-102)."""
    return _shift_lon(lon_var, lambda a: a >= 0.0, 360.0)


def from_lon_360(lon_var):
    """Unwrap longitudes into (-180, 180] (reference helpers.py:105-110)."""
    return _shift_lon(lon_var, lambda a: a <= 180.0, -360.0)


def get_dataset_chunks(dataset: Dataset) -> dict[Hashable, int]:
    """Most common max-chunk size per chunked dimension across the data
    variables of *dataset* (reference helpers.py:113-161)."""
    from collections import Counter

    votes: dict[Hashable, Counter] = {}
    for var in dataset.data_vars.values():
        if not var.chunks:
            continue
        for dim, sizes in zip(var.dims, var.chunks):
            votes.setdefault(dim, Counter())[max(0, *sizes)] += 1
    return {
        dim: counter.most_common(1)[0][0] for dim, counter in votes.items()
    }


def _default_xy_var_names(crs: CRS) -> tuple[str, str]:
    return ("lon", "lat") if crs.is_geographic else ("x", "y")


def _default_xy_dim_names(crs: CRS) -> tuple[str, str]:
    return _default_xy_var_names(crs)


def _assert_valid_xy_names(value: Any, name: str = None):
    assert_instance(value, tuple, name=name)
    assert_true(
        len(value) == 2 and all(value) and value[0] != value[1],
        f"invalid {name or 'value'}",
    )


def _assert_valid_xy_coords(xy_coords: Any):
    assert_instance(xy_coords, DataArray, name="xy_coords")
    assert_true(
        xy_coords.ndim == 3
        and xy_coords.shape[0] == 2
        and xy_coords.shape[1] >= 2
        and xy_coords.shape[2] >= 2,
        "xy_coords must have dimensions"
        " (2, height, width) with height >= 2 and width >= 2",
    )


_RESOLUTIONS = {
    10: (1, 0),
    20: (2, 0),
    25: (25, 1),
    50: (5, 0),
    100: (1, -1),
}

_RESOLUTION_SET = {k / 100 for k in _RESOLUTIONS.keys()}


def round_to_fraction(value: float, digits: int = 2, resolution: float = 1) -> Fraction:
    """Round *value* at the position given by significant *digits* and return
    the result as an exact fraction (reference helpers.py:203-239).

    Args:
        value: The value.
        digits: Number of significant digits, integer >= 1. Default 2.
        resolution: Rounding resolution for the least significant digit,
            one of (0.1, 0.2, 0.25, 0.5, 1). Default 1.
    """
    if digits < 1:
        raise ValueError("digits must be a positive integer")
    key = round(100 * resolution)
    if key not in _RESOLUTIONS or not math.isclose(100 * resolution, key):
        raise ValueError(f"resolution must be one of {_RESOLUTION_SET}")
    if value == 0:
        return Fraction(0, 1)

    sign, mag = (1, value) if value >= 0 else (-1, -value)
    step, extra_digits = _RESOLUTIONS[key]
    # place value of the least significant retained digit
    exponent = math.floor(math.log10(mag)) - digits - extra_digits
    unit = Fraction(10) ** exponent
    snapped = step * round(mag / unit / step)
    return sign * snapped * unit


def scale_xy_res_and_size(
    xy_res: tuple[float, float], size: tuple[int, int], xy_scale: tuple[float, float]
) -> tuple[tuple[float, float], tuple[int, int]]:
    """Scale *xy_res* and *size* by *xy_scale*, keeping size >= 2
    (reference helpers.py:242-255)."""
    res = tuple(r / s for r, s in zip(xy_res, xy_scale))
    size = tuple(max(2, round(s * n)) for s, n in zip(xy_scale, size))
    return res, size
