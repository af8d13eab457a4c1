"""Shared inputs and comparisons of ``tests/test_torch_dtypes*.py``: the port on
every data dtype the JAX package takes, against it, on the CPU.

The thirteen dtypes (``_device.DATA_DTYPES``): float16, bfloat16, float32,
float64, the signed and unsigned integers of 8 to 64 bits and bool.  Each
route is held to the JAX package on inputs made from a numpy seed
(bfloat16 built in float32, where the conversion is exact, and converted on
each side); JAX is fed ``jnp`` arrays (its device path, under the suite's
x64) or numpy arrays (its host paths), the port CPU tensors or numpy
arrays, so its kernel wrappers run their plain versions.

Tolerance classes: integer and bool outputs equal; float outputs equal,
but the statistics of window reductions, which the port accumulates in
float64 and rounds once: the float ``mean``, ``sum``, ``std``, ``var``,
``prod`` within the rounding of JAX's sums in the data's own precision
(XLA sums float32 in float32, ``jnp.nansum`` of a half dtype rounds each
partial sum to it): ``taps * u * max(|result|, 10)`` for the dtype's unit
roundoff ``u`` and data of at most 10 in magnitude; the ``mean``,
``std`` and ``var`` of integers up to 32 bits within 1, as JAX takes them
in float32 before ``rint`` (64-bit integers: float64, equal; bool: equal,
as a statistic of 0s and 1s is 0 in float32 exactly where it is in
float64).
Dtypes and NaN masks are always equal.  Where JAX raises, the port raises
the same exception type.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

import xcube_resampling_tpu as xrt
import xcube_resampling_tpu_torch as port
from xcube_resampling_tpu_torch._device import DATA_DTYPES, from_numpy, to_numpy

from .sampledata import create_olci_like_swath

DTYPES = [str(d).removeprefix("torch.") for d in DATA_DTYPES]
HALF = ("float16", "bfloat16")
FLOATS = ("float16", "bfloat16", "float32", "float64")
STATS = ("mean", "sum", "std", "var", "prod")
INT_STATS = ("mean", "std", "var")
# the unit roundoff of each float dtype
EPS = {"float16": 2.0**-11, "bfloat16": 2.0**-8, "float32": 2.0**-24, "float64": 2.0**-53}
AGGS = ["mean", "sum", "std", "var", "median", "min", "max", "prod", "count",
        "first", "last", "center", "mode"]
# a dtype of each kind, for the cases that run every method
KINDS = ("uint16", "int64", "float16", "float64")

# the 96^2 UTM32N -> 80^2 EPSG:3035 case of tests/test_srw.py
UTM_LAEA = (
    dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"),
    dict(size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035"),
)


def data(name, shape, seed=0, nan=True):
    """Seeded data of dtype *name*: floats on a grid of quarters within
    +-10 with NaNs (one in ten, or with *nan* "row" one row of the last
    band, for the warps, whose taps spread a NaN); integers spread over
    +-1000 (or 0..1000 unsigned), bool a coin."""
    rng = np.random.default_rng(seed)
    if name == "bool":
        return rng.random(shape) < 0.4
    if name in FLOATS:
        x = (rng.integers(-40, 40, shape) / 4.0).astype(np.float32)
        if nan == "row":
            x[..., shape[-2] // 3, :] = np.nan
        elif nan:
            x[rng.random(shape) < 0.1] = np.nan
        return x.astype(ml_dtypes.bfloat16 if name == "bfloat16" else name)
    info = np.iinfo(name)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), shape).astype(name)


def np_of(t):
    return to_numpy(t)


def as_float(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind in "fV" else a


def match(got, ref, stat=None, taps=0):
    """Equal dtypes, shapes and NaN masks; equal values, but the statistic
    *stat* of windows of *taps* taps (see the module docstring)."""
    got, ref = np_of(got) if isinstance(got, torch.Tensor) else np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype)
    g, r = as_float(got), as_float(ref)
    if g.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    if stat in STATS and g.dtype.kind == "f":
        eps = EPS[got.dtype.name]
        scale = max(np.nanmax(np.abs(r)) if np.isfinite(r).any() else 0.0, 10.0)
        np.testing.assert_allclose(g, r, atol=taps * eps * scale, rtol=0, equal_nan=True)
    elif stat in INT_STATS and got.dtype.itemsize <= 4 and g.dtype.kind in "iu":
        # JAX computes them in float32, the port in float64: rint may part
        np.testing.assert_allclose(g.astype(np.int64), r.astype(np.int64), atol=1, rtol=0)
    else:
        np.testing.assert_array_equal(g, r)


def gms(pkg, target=None):
    src, tgt = UTM_LAEA
    return pkg.GridMapping.regular(**src), pkg.GridMapping.regular(**(target or tgt))


JAX_FNS = {}


def jax_fn(key, make):
    """JAX's tier functions, built once a module (their jit caches keep one
    compilation a dtype)."""
    if key not in JAX_FNS:
        JAX_FNS[key] = make()
    return JAX_FNS[key]


def swath_datasets(names, path, fill_ints=True):
    """A small OLCI-like swath holding a variable of each dtype in *names*,
    for both packages: numpy variables (``path`` "host": the host Phase
    B) or ``jnp`` arrays and CPU tensors (``path`` "device": the device
    Phase B).  Integers take the fill 0 with *fill_ints*."""
    ds = create_olci_like_swath(width=48, height=64, tile_size=16)
    shape = np.asarray(ds.rad.data).shape
    values = {name: data(name, shape, seed=i, nan=False) for i, name in enumerate(names)}
    dims, chunks = ds.rad.dims, ds.rad.chunks
    jds = xrt.Dataset(
        {n: xrt.DataArray(jnp.asarray(x) if path == "device" else x, dims=dims, chunks=chunks)
         for n, x in values.items()},
        coords={n: c for n, c in ds.coords.items()},
    )
    pds = port.Dataset(
        {n: port.DataArray(from_numpy(x) if path == "device" else x, dims=dims, chunks=chunks)
         for n, x in values.items()},
        coords={n: port.DataArray(np.asarray(c.data), dims=c.dims, attrs=dict(c.attrs),
                                  chunks=c.chunks)
                for n, c in ds.coords.items()},
    )
    fills = {n: 0 for n in names if fill_ints and n not in FLOATS and n != "bool"}
    return jds, pds, dict(fill_values=fills) if fills else {}


