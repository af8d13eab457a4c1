"""The port's affine engine and window reductions against the JAX package.

K4's plain version (``ops/gather.py``) against ``gather.affine_gather``
given ``jnp`` arrays, K5's and K6's (``ops/coarsen_ops.py``) against
``coarsen_jax``, K4's downscale form (``affine_gather_reduce``) against
``affine._resample_array``, then ``affine_transform_dataset``, the affine
route of ``resample_in_space`` and the reproject pre-downscale end to end.  JAX is
fed ``jnp`` arrays, so it takes its device path (under the suite's x64);
the port is fed CPU tensors, so its kernel wrappers run their plain
versions.  Inputs come from a numpy seed; each comparison states its
tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu import affine as jx_affine  # noqa: E402
from xcube_resampling_tpu.constants import AGG_METHODS as JX_AGG_METHODS  # noqa: E402
from xcube_resampling_tpu.crs import CRS_CRS84  # noqa: E402
from xcube_resampling_tpu.ops import coarsen_ops as jx_coarsen  # noqa: E402
from xcube_resampling_tpu.ops import gather as jx_gather  # noqa: E402
from xcube_resampling_tpu_torch import affine as pt_affine  # noqa: E402
from xcube_resampling_tpu_torch import reproject as pt_reproject  # noqa: E402
from xcube_resampling_tpu_torch._device import LAUNCHES  # noqa: E402
from xcube_resampling_tpu_torch.constants import AGG_METHODS  # noqa: E402
from xcube_resampling_tpu_torch.ops import coarsen_ops  # noqa: E402
from xcube_resampling_tpu_torch.ops.gather import (  # noqa: E402
    affine_gather_plain,
    affine_gather_reduce,
)

from .sampledata import (  # noqa: E402
    create_2x8x6_dataset_with_regular_coords,
    create_8x6_dataset_with_regular_coords,
)

AGGS = [
    "mean", "sum", "std", "var", "median", "min", "max", "prod", "count",
    "first", "last", "center", "mode",
]
# float results compared within rtol (NaN masks equal): JAX sums float32
# in float32 in XLA's order, the port in float64 rounded once
FLOAT_STATS = {"mean": 1e-6, "sum": 1e-6, "prod": 1e-6, "std": 1e-5, "var": 1e-5}


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    yield
    pt_reproject._DEVICE_FN_CACHE.clear()


def _as_dtype(ref, dtype):
    """JAX's float64 gather result rounded to *dtype* as
    ``affine._gather_resample`` rounds it on the device path (``jnp.rint``
    first for integers, then JAX's saturating cast)."""
    if ref.dtype != dtype:
        if np.dtype(dtype).kind in "ui":
            ref = jnp.rint(ref)
        ref = ref.astype(dtype)
    return np.asarray(ref)


def _assert_match(got, ref, rtol=0.0):
    """Equal dtypes and NaN masks; equal values where *rtol* is 0."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.dtype, ref.dtype)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    if rtol == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, equal_nan=True)


def _data(dtype, shape, seed=42):
    """Seeded data: floats in [0, 1) with a NaN cell, integers in [0, 200)."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        data = rng.random(shape).astype(dtype)
        data[..., 2, 3] = np.nan
        return data
    return rng.integers(0, 200, shape).astype(dtype)


# (j_scale, i_scale, j_off, i_off): tests/test_ops_parity.py's, identity,
# a 2.5 x 2 downscale and negative (flipped) scales
SCALES = [
    (0.7, 1.3, -0.4, 0.2),
    (1.0, 1.0, 0.0, 0.0),
    (2.5, 2.0, 0.25, -0.5),
    (-0.7, 1.3, 9.4, 0.2),
    (1.1, -1.6, -0.3, 11.7),
]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8, np.int32])
@pytest.mark.parametrize("scales", SCALES)
def test_affine_gather_plain_matches_jax(order, dtype, scales):
    """K4's plain version against ``gather.affine_gather(xp=jnp)``, rounded
    to the input dtype as ``_gather_resample`` rounds it: equal (the same
    float64 operations, unfused on both sides), NaN masks included."""
    data = _data(dtype, (2, 10, 12))
    fill = np.nan if np.dtype(dtype).kind == "f" else 7
    args = (*scales, 16, 9, order, fill)
    ref = jx_gather.affine_gather(jnp.asarray(data), *args, xp=jnp)
    got = affine_gather_plain(torch.from_numpy(data), *args)
    _assert_match(got.numpy(), _as_dtype(ref, dtype))
    if order == 1:
        # kept in float64, as the NaN recovery divides it
        got64 = affine_gather_plain(torch.from_numpy(data), *args, out_dtype=torch.float64)
        _assert_match(got64.numpy(), np.asarray(ref).astype(np.float64))


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("fill", [-9, 2.5, 300, np.nan])
def test_affine_gather_plain_fill_casts_like_jax(order, fill):
    """Numeric and NaN fills cast to uint8, float32 and float64 as JAX
    casts them: integer fills wrap, float fills truncate and saturate (NaN
    to 0)."""
    for dtype in (np.uint8, np.float32, np.float64):
        data = _data(dtype, (9, 11), seed=3)
        args = (1.3, 0.9, -2.2, -1.6, 12, 14, order, fill)
        ref = jx_gather.affine_gather(jnp.asarray(data), *args, xp=jnp)
        got = affine_gather_plain(torch.from_numpy(data), *args)
        _assert_match(got.numpy(), _as_dtype(ref, dtype))


def _coarsen_case(dtype, shape=(2, 12, 16), seed=42):
    """Floats with a NaN cell and an all-NaN window (both (3, 4) and
    (2, 2) windows hold one); integers in [0, 7)."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        data = rng.random(shape).astype(dtype)
        data[0, 3, 5] = np.nan
        data[1, 0:6, 0:4] = np.nan
        return data
    return rng.integers(0, 7, shape).astype(dtype)


def _assert_coarsen_match(got, ref, agg, dtype):
    rtol = FLOAT_STATS.get(agg, 0.0) if np.dtype(dtype).kind == "f" else 0.0
    _assert_match(got, ref, rtol)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.uint8])
@pytest.mark.parametrize("window", [(3, 4), (2, 2)])
def test_coarsen_plain_matches_jax(agg, dtype, window):
    """Every aggregation's plain version against ``coarsen_jax``: dtypes
    equal (int64/uint64 sums, products and counts under x64); picks,
    min, max, count, mode, median and integer results equal; float
    statistics within FLOAT_STATS's rtol, NaN masks equal (all-NaN
    windows: NaN, sum 0, prod 1, count of the NaN taps)."""
    data = _coarsen_case(dtype)
    ref = jx_coarsen.coarsen_jax(jnp.asarray(data), *window, agg)
    got = coarsen_ops.coarsen(torch.from_numpy(data), *window, agg)
    _assert_coarsen_match(got.numpy(), np.asarray(ref), agg, dtype)


@pytest.mark.parametrize("agg", ["mode", "median"])
@pytest.mark.parametrize("window", [(8, 8), (9, 9)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_rank_reducers_at_64_and_81_taps(agg, window, dtype):
    """Mode and median at 64 taps (JAX's pairwise mode) and 81 taps (its
    sort and run-length mode): equal, NaN masks included; float windows
    hold ties, NaN taps and an all-NaN window."""
    rng = np.random.default_rng(8)
    n = 72
    if dtype == np.int32:
        data = rng.integers(0, 5, (2, n, n)).astype(dtype)
    else:
        data = (np.round(rng.random((2, n, n)) * 4) / 4).astype(dtype)
        data[rng.random(data.shape) < 0.3] = np.nan
        data[0, :9, :9] = np.nan
    ref = jx_coarsen.coarsen_jax(jnp.asarray(data), *window, agg)
    got = coarsen_ops.coarsen(torch.from_numpy(data), *window, agg)
    _assert_match(got.numpy(), np.asarray(ref))


def test_coarsen_takes_agg_callables_and_unit_windows():
    """``AGG_METHODS`` callables map to their names; (1, 1) windows return
    the input itself, as in the JAX package."""
    data = torch.from_numpy(_coarsen_case(np.float32))
    assert coarsen_ops.agg_name(AGG_METHODS["mode"]) == "mode"
    assert coarsen_ops.coarsen(data, 1, 1, "mean") is data
    with pytest.raises(ValueError, match="unsupported aggregation"):
        coarsen_ops.coarsen(data, 2, 2, "mean_of_means")
    with pytest.raises(ValueError, match="exact multiples"):
        coarsen_ops.coarsen(data, 5, 2, "mean")


def test_integer_mean_goes_through_float64_not_float32():
    """A known difference from JAX, pinned (ROADMAP section 3): JAX's
    ``jnp.mean`` of int32 under x64 is float32, the port accumulates in
    float64.  The window [100000001, 100000002, 100000004, 100000007]
    (mean 100000003.5) gives JAX 100000000 and the port 100000004, one
    float32 ulp (8 at 1e8) apart."""
    data = np.array([[[100000001, 100000002], [100000004, 100000007]]], np.int32)
    ref = np.asarray(jx_coarsen.coarsen_jax(jnp.asarray(data), 2, 2, "mean"))
    got = coarsen_ops.coarsen(torch.from_numpy(data), 2, 2, "mean").numpy()
    assert ref.dtype == got.dtype == np.int32
    assert int(ref[0, 0, 0]) == 100000000 and int(got[0, 0, 0]) == 100000004
    assert abs(int(got[0, 0, 0]) - int(ref[0, 0, 0])) <= np.spacing(np.float32(1e8))


# -- K4's downscale form -------------------------------------------------------

K5_AGGS = [agg for agg in AGGS if agg not in ("mode", "median")]
# affine matrices ((i_scale, 0, i_off), (0, j_scale, j_off)) of downscales
# and their coarse (out_h, out_w): 2 x 2 windows whose target reaches past
# the source (fill), 3 x 4 windows with the i axis flipped, 5 x 5 windows
DOWNSCALES = [
    (((1.9, 0.0, -1.5), (0.0, 2.0, 1.0)), (6, 7)),
    (((-3.7, 0.0, 15.5), (0.0, 2.6, 0.3)), (4, 4)),
    (((4.6, 0.0, 0.2), (0.0, 4.3, -0.4)), (3, 3)),
]


def _downscale_source(dtype, seed=11):
    """(2, 14, 17): floats in [0, 1) with a NaN cell, integers in [0, 7)
    (small, so that JAX's float32 integer statistics are exact)."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        data = rng.random((2, 14, 17)).astype(dtype)
        data[1, 5, 6] = np.nan
        return data
    return rng.integers(0, 7, (2, 14, 17)).astype(dtype)


@pytest.mark.parametrize("agg", K5_AGGS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16, np.uint8, np.int32])
def test_affine_gather_reduce_matches_jax(agg, dtype):
    """The fused downscale on CPU tensors against JAX's
    ``affine._resample_array`` (bilinear, no NaN recovery) on jnp arrays,
    at 2 x 2 windows reaching past the source, 3 x 4 windows on a flipped
    axis and 5 x 5 windows: picks, min, max, count and integer results
    equal; float statistics within FLOAT_STATS's rtol; NaN masks equal (the
    NaN fill is skipped by the NaN-aware reducers, as in the chain)."""
    data = _downscale_source(dtype)
    fill = np.nan if np.dtype(dtype).kind == "f" else 3
    for matrix, (out_h, out_w) in DOWNSCALES:
        shape = (2, out_h, out_w)
        ref = jx_affine._resample_array(
            jnp.asarray(data), matrix, shape, 1, JX_AGG_METHODS[agg], False, fill
        )
        (j_div, i_div), ((i_s, _, i_o), (_, j_s, j_o)) = pt_affine._scale_split(matrix)
        got = affine_gather_reduce(
            torch.from_numpy(data), j_s, i_s, j_o, i_o, out_h, out_w, j_div, i_div, agg, fill
        )
        _assert_coarsen_match(got.numpy(), np.asarray(ref), agg, dtype)


@pytest.mark.parametrize("agg", AGGS + ["mean_recover_nans"])
def test_downscale_takes_the_fused_form_for_k5_reducers(monkeypatch, agg):
    """``_resample_array`` sends a bilinear downscale reduced by one of
    K5's reducers, without NaN recovery, through ``affine_gather_reduce``
    and gathers no inflated image; ``mode``, ``median`` and the two-pass
    NaN recovery keep the chain (K4 at the inflated size, then K5 or K6).
    Both give what JAX gives."""
    calls = []
    for name in ("affine_gather", "affine_gather_reduce"):
        orig = getattr(pt_affine, name)
        monkeypatch.setattr(
            pt_affine, name,
            lambda *a, _orig=orig, _name=name, **k: calls.append(_name) or _orig(*a, **k),
        )
    recover = agg == "mean_recover_nans"
    agg = agg.removesuffix("_recover_nans")
    data = _downscale_source(np.float32)
    matrix, (out_h, out_w) = DOWNSCALES[2]
    got = pt_affine._resample_array(
        torch.from_numpy(data), matrix, (2, out_h, out_w), 1, agg, recover, np.nan
    )
    fused = agg in K5_AGGS and not recover
    assert calls == (["affine_gather_reduce"] if fused else
                     ["affine_gather"] * (2 if recover else 1))
    ref = jx_affine._resample_array(
        jnp.asarray(data), matrix, (2, out_h, out_w), 1, JX_AGG_METHODS[agg], recover, np.nan
    )
    _assert_coarsen_match(got.numpy(), np.asarray(ref), agg, np.float32)


# -- the affine engine end to end -------------------------------------------


def _cast(data, dtype):
    """*data* as *dtype*; NaN becomes 0 in an integer dtype."""
    data = np.asarray(data)
    if dtype is None:
        return data
    if np.dtype(dtype).kind != "f":
        data = np.nan_to_num(data)
    return data.astype(dtype)


def _to_port(ds, dtype=None):
    """A JAX-package dataset rebuilt with the port's classes, its data
    variables as CPU tensors (cast to *dtype* if given)."""
    def copy(da, tensor):
        data = np.asarray(da.data)
        if tensor:
            data = torch.from_numpy(_cast(data, dtype))
        return pt.DataArray(data, dims=da.dims, attrs=dict(da.attrs))

    return pt.Dataset(
        {name: copy(v, True) for name, v in ds.data_vars.items()},
        coords={name: copy(c, False) for name, c in ds.coords.items()},
        attrs=dict(ds.attrs),
    )


def _to_jnp(ds, dtype=None):
    """The same dataset with its data variables as jnp arrays."""
    out = ds.copy()
    for name, v in ds.data_vars.items():
        out[name] = jx.DataArray(
            jnp.asarray(_cast(v.data, dtype)), dims=v.dims, attrs=dict(v.attrs)
        )
    return out


def _j_up_8x8():
    """tests/test_affine.py's j-axis-up 8x8 dataset."""
    res = 0.1
    data = (8.0 * np.arange(8)[:, None] + np.arange(8)[None, :]).astype(np.float64)
    return jx.Dataset(
        data_vars=dict(band=jx.DataArray(data, dims=("lat", "lon"))),
        coords=dict(
            lon=jx.DataArray(50.0 + res * np.arange(8) + 0.5 * res, dims="lon"),
            lat=jx.DataArray(10.0 + res * np.arange(8) + 0.5 * res, dims="lat"),
        ),
    )


# the tests/test_affine.py geometries: (dataset, GridMapping.regular
# arguments of the target, options)
RES = 0.1
CASES = {
    "subset": ("2d", ((3, 3), (50.0, 10.0), RES), dict(interp_methods=1)),
    "subset_shift": ("2d", ((3, 3), (50.1, 10.1), RES), dict(interp_methods=1)),
    "subset_half": ("2d", ((3, 3), (50.05, 10.05), RES), dict(interp_methods=1)),
    "subset_recover_nans": (
        "2d", ((3, 3), (50.05, 10.05), RES), dict(interp_methods=1, recover_nans=True),
    ),
    "subset_3d": ("3d", ((3, 3), (50.0, 10.0), RES), dict(interp_methods=1)),
    "subset_nearest": ("2d", ((3, 3), (50.05, 10.05), RES), dict(interp_methods=0)),
    "downscale_x2": ("2d", ((8, 6), (50, 10), 2 * RES), dict(interp_methods=1)),
    "downscale_x2_shift": ("2d", ((8, 6), (49.8, 9.8), 2 * RES), dict(interp_methods=1)),
    "downscale_x2_max": (
        "2d", ((8, 6), (50, 10), 2 * RES), dict(interp_methods=1, agg_methods="max"),
    ),
    "upscale_x2": ("2d", ((8, 6), (50, 10), RES / 2), dict(interp_methods=1)),
    "upscale_x2_shift": ("2d", ((8, 6), (49.9, 9.95), RES / 2), dict(interp_methods=1)),
    "shift": ("2d", ((8, 6), (50.2, 10.1), RES), dict(interp_methods=1)),
    "j_up_source": ("j_up", ((8, 8), (50.0, 10.0), RES), dict(interp_methods=1)),
    "j_up_source_downscale_mean": (
        "j_up", ((4, 4), (50.0, 10.0), 2 * RES), dict(interp_methods=1, agg_methods="mean"),
    ),
    "j_up_target": (
        "2d", ((8, 6), (50.0, 10.0), RES, dict(is_j_axis_up=True)), dict(interp_methods=0),
    ),
}


def _source(kind):
    return {
        "2d": create_8x6_dataset_with_regular_coords,
        "3d": create_2x8x6_dataset_with_regular_coords,
        "j_up": _j_up_8x8,
    }[kind]()


def _target(pkg, args, crs):
    size, xy_min, res, *kwargs = args
    return pkg.GridMapping.regular(size, xy_min, res, crs, **(kwargs[0] if kwargs else {}))


def _run_affine(case, dtype=None, entry="affine"):
    kind, target_args, options = CASES[case]
    ds = _source(kind)
    crs = jx.GridMapping.from_dataset(ds).crs
    ref = jx.affine_transform_dataset(
        _to_jnp(ds, dtype), _target(jx, target_args, crs), **options
    )
    port_ds = _to_port(ds, dtype)
    target = _target(pt, target_args, pt.GridMapping.from_dataset(port_ds).crs)
    if entry == "affine":
        got = pt.affine_transform_dataset(port_ds, target, **options)
    else:
        got = pt.resample_in_space(port_ds, target_gm=target, **options)
    return ref, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_affine_transform_dataset_matches_jax(case):
    """``affine_transform_dataset`` on CPU tensors against JAX's on jnp
    arrays, every tests/test_affine.py geometry: the same variables and
    coordinates, results equal (the float64 data's means are exact), NaN
    masks included."""
    ref, got = _run_affine(case)
    assert sorted(got.variables) == sorted(ref.variables)
    data = got["refl" if "refl" in got else "band"]
    assert isinstance(data.data, torch.Tensor) and data.data.device.type == "cpu"
    name = data.name
    assert got[name].dims == ref[name].dims
    _assert_match(got[name].data.numpy(), np.asarray(ref[name].data))
    for axis in ("lon", "lat"):
        np.testing.assert_array_equal(got[axis].data, np.asarray(ref[axis].data))


@pytest.mark.parametrize("case", ["subset_half", "downscale_x2_shift", "upscale_x2_shift"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint16, np.int8])
def test_resample_in_space_affine_route_matches_jax(case, dtype):
    """The affine route of ``resample_in_space`` for other dtypes: the
    output keeps the input dtype and equals JAX's (float32 means within
    1e-6; integers take the JAX fixture's NaN as 0, then round back)."""
    ref, got = _run_affine(case, dtype, entry="resample_in_space")
    out = got["refl"].data
    assert isinstance(out, torch.Tensor) and out.dtype == torch.from_numpy(
        np.zeros(1, dtype)
    ).dtype
    rtol = 1e-6 if dtype == np.float32 and "downscale" in case else 0.0
    _assert_match(out.numpy(), np.asarray(ref["refl"].data), rtol)


def test_numpy_variables_keep_their_dtype_on_the_device():
    """Numpy-backed variables go to *device* as tensors of their own dtype
    and equal the same data passed as tensors."""
    ds = create_8x6_dataset_with_regular_coords()
    for dtype in (np.float64, np.uint8):
        port_ds = _to_port(ds)
        refl = _cast(ds["refl"].data, dtype)
        port_ds["refl"] = pt.DataArray(refl, dims=("lat", "lon"))
        port_ds["t"] = pt.DataArray(torch.from_numpy(refl), dims=("lat", "lon"))
        target = _target(pt, ((3, 3), (50.05, 10.05), RES),
                         pt.GridMapping.from_dataset(port_ds).crs)
        got = pt.resample_in_space(port_ds, target_gm=target, device="cpu")
        for name in ("refl", "t"):
            assert isinstance(got[name].data, torch.Tensor)
            assert got[name].data.numpy().dtype == dtype
        _assert_match(got["refl"].data.numpy(), got["t"].data.numpy())


def test_recover_nans_runs_two_passes_for_tensors():
    """The two-pass NaN recovery follows the JAX device path: for tensors
    it always runs (``host_has_nans`` is true for any non-numpy array),
    with a float64 weight image (``1.0 - mask`` under x64).  A float
    variable with an explicit numeric fill and no NaN tells the two JAX
    paths apart: the host path runs one pass (the fill outside), the
    device path two (fill / fill = 1 outside); the port equals the
    device path."""
    ds = create_8x6_dataset_with_regular_coords()
    ds["refl"] = jx.DataArray(
        np.nan_to_num(np.asarray(ds["refl"].data)).astype(np.float32) + 0.1,
        dims=("lat", "lon"),
    )
    crs = jx.GridMapping.from_dataset(ds).crs
    options = dict(interp_methods=1, recover_nans=True, fill_values=-9.0)
    target_args = ((3, 3), (50.65, 10.05), RES)  # its last column lies outside
    host = jx.affine_transform_dataset(ds, _target(jx, target_args, crs), **options)
    device = jx.affine_transform_dataset(_to_jnp(ds), _target(jx, target_args, crs), **options)
    port_ds = _to_port(ds)
    got = pt.affine_transform_dataset(
        port_ds, _target(pt, target_args, pt.GridMapping.from_dataset(port_ds).crs), **options
    )
    host, device = np.asarray(host["refl"].data), np.asarray(device["refl"].data)
    outside = host == -9.0
    assert outside[:, 2].all() and (device[outside] == 1.0).all()
    _assert_match(got["refl"].data.numpy(), device)


def test_affine_engine_refuses_other_dtypes():
    """An int64 variable, which the port refused before it took the JAX
    package's thirteen dtypes, equals JAX's (bilinear, rint back to int64);
    a dtype outside the thirteen (complex64) still raises."""
    jds = create_8x6_dataset_with_regular_coords()
    values = (np.nan_to_num(np.asarray(jds["refl"].data)) * 1000).astype(np.int64)
    jds["refl"] = jx.DataArray(values, dims=("lat", "lon"))
    crs = jx.GridMapping.from_dataset(jds).crs
    target_args = ((3, 3), (50.05, 10.05), RES)
    ref = jx.affine_transform_dataset(_to_jnp(jds), _target(jx, target_args, crs),
                                      interp_methods=1)
    ds = _to_port(jds)
    gm = pt.GridMapping.from_dataset(ds)
    got = pt.affine_transform_dataset(ds, _target(pt, target_args, gm.crs), interp_methods=1,
                                      device="cpu")
    _assert_match(got["refl"].data.numpy(), np.asarray(ref["refl"].data))
    ds["refl"] = pt.DataArray(torch.zeros((6, 8), dtype=torch.complex64), dims=("lat", "lon"))
    target = pt.GridMapping.regular((3, 3), (50.0, 10.0), RES, gm.crs)
    with pytest.raises(NotImplementedError, match="the port's kernels take"):
        pt.affine_transform_dataset(ds, target, device="cpu")


def test_different_geographic_crses_take_the_affine_route():
    """A CRS84 target of a WGS84 source: two geographic CRSs that are not
    equal take the affine route in both packages."""
    ds = create_8x6_dataset_with_regular_coords()
    target_args = ((3, 3), (50.05, 10.05), RES)
    ref = jx.resample_in_space(_to_jnp(ds), target_gm=_target(jx, target_args, CRS_CRS84),
                               interp_methods=1)
    got = pt.resample_in_space(
        _to_port(ds), target_gm=_target(pt, target_args, pt.crs.CRS_CRS84), interp_methods=1,
    )
    assert not jx.GridMapping.from_dataset(ds).crs.equals(CRS_CRS84)
    _assert_match(got["refl"].data.numpy(), np.asarray(ref["refl"].data))


# -- the reproject pre-downscale ---------------------------------------------

UTM = dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632")
# tests/test_torch_slice.py's utm_laea target at 400 m: scale 0.25
LAEA_400 = dict(size=(20, 20), xy_min=(4320500, 3379500), xy_res=400, crs="epsg:3035")


def _downscale_dataset(pkg, gm, a, b):
    coords = dict(gm.to_coords(exclude_bounds=True))
    coords["spatial_ref"] = pkg.DataArray(np.array(0), dims=(), attrs=gm.crs.to_cf())
    x_dim, y_dim = gm.xy_dim_names
    return pkg.Dataset(
        {
            "a": pkg.DataArray(a, dims=(y_dim, x_dim), attrs=dict(grid_mapping="spatial_ref")),
            "b": pkg.DataArray(b, dims=("band", y_dim, x_dim),
                               attrs=dict(grid_mapping="spatial_ref")),
        },
        coords=coords,
    )


@pytest.mark.parametrize("interp", ["bilinear", "nearest", "triangular"])
@pytest.mark.parametrize("agg", ["mean", "max"])
def test_reproject_pre_downscale_matches_jax(monkeypatch, interp, agg):
    """A reproject to a 4x coarser grid: both packages clip the source,
    downscale it through the affine engine (K4 at the inflated size, then
    K5; nearest gathers at the coarse size directly) and reproject the
    coarse image.  Equal for ``max`` and nearest, within rtol 1e-6 for a
    float ``mean`` (NaN masks equal)."""
    calls = []
    orig = pt_reproject.affine_transform_dataset

    def spy(*args, **kwargs):
        calls.append(args[1].size)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pt_reproject, "affine_transform_dataset", spy)
    rng = np.random.default_rng(0)
    a = rng.random((96, 96), dtype=np.float32)
    b = rng.random((2, 96, 96), dtype=np.float32)
    b[1, 40] = np.nan
    ref = jx.resample_in_space(
        _downscale_dataset(jx, jx.GridMapping.regular(**UTM), jnp.asarray(a), jnp.asarray(b)),
        target_gm=jx.GridMapping.regular(**LAEA_400), interp_methods=interp, agg_methods=agg,
    )
    got = pt.resample_in_space(
        _downscale_dataset(pt, pt.GridMapping.regular(**UTM), torch.from_numpy(a),
                           torch.from_numpy(b)),
        target_gm=pt.GridMapping.regular(**LAEA_400), interp_methods=interp, agg_methods=agg,
    )
    assert len(calls) == 1 and max(calls[0]) < 96
    rtol = 1e-6 if agg == "mean" and interp != "nearest" else 0.0
    for name in ("a", "b"):
        assert got[name].dims == ref[name].dims
        _assert_match(got[name].data.numpy(), np.asarray(ref[name].data), rtol)
    assert np.isfinite(got["a"].data.numpy()).mean() > 0.5


def test_cpu_tensors_launch_no_kernel():
    """The affine route and the pre-downscale on CPU tensors run the plain
    versions of K4-K6 and of K4's downscale form and launch nothing."""
    before = dict(LAUNCHES)
    _run_affine("downscale_x2")
    _run_affine("j_up_source_downscale_mean")
    _run_affine("subset_recover_nans")
    data = torch.from_numpy(_coarsen_case(np.int32))
    for agg in ("mode", "median", "mean", "first"):
        coarsen_ops.coarsen(data, 2, 2, agg)
    assert dict(LAUNCHES) == before
