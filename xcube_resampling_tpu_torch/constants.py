"""Shared types, registries and tuning constants.

Parity with the reference's constants module
(xcube_resampling/constants.py:30-82): same aggregation
registry keys, interpolation method mapping, dtype-derived fill-value
defaults, and the two algorithm tuning constants ``SCALE_LIMIT`` (downscale-
first trigger) and ``UV_DELTA`` (rectify triangle-test tolerance).
"""

from __future__ import annotations

import logging
from collections.abc import Callable, Hashable, Mapping
from typing import Literal, TypeAlias

import numpy as np

from .coarsen import center, first, last, mean, median, mode, std, var

FloatInt = int | float
AffineTransformMatrix = tuple[
    tuple[FloatInt, FloatInt, FloatInt], tuple[FloatInt, FloatInt, FloatInt]
]
AggMethod: TypeAlias = Literal[
    "center",
    "count",
    "first",
    "last",
    "max",
    "mean",
    "median",
    "mode",
    "min",
    "prod",
    "std",
    "sum",
    "var",
]
AggMethods: TypeAlias = AggMethod | Mapping[np.dtype | str, AggMethod]
AggFunction: TypeAlias = Callable[[np.ndarray, tuple[int, ...] | None], np.ndarray]
AGG_METHODS: dict[AggMethod, AggFunction] = {
    "center": center,
    "count": np.count_nonzero,
    "first": first,
    "last": last,
    "prod": np.nanprod,
    "max": np.nanmax,
    "mean": mean,
    "median": median,
    "min": np.nanmin,
    "mode": mode,
    "std": std,
    "sum": np.nansum,
    "var": var,
}
InterpMethodInt = Literal[0, 1]
InterpMethodStr = Literal["nearest", "triangular", "bilinear"]
InterpMethod = InterpMethodInt | InterpMethodStr
InterpMethods: TypeAlias = InterpMethod | Mapping[np.dtype | Hashable, InterpMethod]
INTERP_METHOD_MAPPING = {0: "nearest", 1: "bilinear", "nearest": 0, "bilinear": 1}
RecoverNans: TypeAlias = bool | Mapping[np.dtype | str, bool]
FillValues: TypeAlias = FloatInt | Mapping[np.dtype | str, FloatInt]

FILLVALUE_UINT8 = 255
FILLVALUE_UINT16 = 65535
FILLVALUE_INT = -1
FILLVALUE_FLOAT = np.nan

#: If source/target resolution ratio drops below this, downscale first
SCALE_LIMIT = 0.95
#: Tolerance of the rectify triangle containment test (in uv units)
UV_DELTA = 1e-3

LOG = logging.getLogger("xcube.resampling")
