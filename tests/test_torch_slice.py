"""The port's ``resample_in_space`` end to end against the JAX package.

JAX is fed ``jnp`` arrays, so it takes its device path (not the numpy
golden path); the port is fed CPU tensors, so its kernel wrappers run
their plain versions.  Each side's datasets and grid mappings are built
from its own package's classes.  Inputs come from a numpy seed; each
comparison states its tolerance.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as xrt  # noqa: E402
import xcube_resampling_tpu_torch as port  # noqa: E402
from xcube_resampling_tpu.ops import esw as jax_esw  # noqa: E402
from xcube_resampling_tpu.ops import reproject_ops as jax_reproject_ops  # noqa: E402
from xcube_resampling_tpu.ops import srw as jax_srw  # noqa: E402
from xcube_resampling_tpu_torch import reproject as port_reproject  # noqa: E402
from xcube_resampling_tpu_torch import utils as port_utils  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw as port_esw  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw_mosaic as port_esw_mosaic  # noqa: E402
from xcube_resampling_tpu_torch.ops import reproject_ops as port_reproject_ops  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as port_srw  # noqa: E402

METHODS = ["bilinear", "nearest", "triangular"]


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    yield
    port_reproject._DEVICE_FN_CACHE.clear()


# (source, target) arguments of GridMapping.regular: the 96^2 UTM32N ->
# 80^2 EPSG:3035 case of tests/test_srw.py, and the 4326 -> UTM32N
# benchmark geometry cut down (a 0.05 deg regional source whose tapped
# window is cropped, onto a 256^2 UTM grid at 2400 m, above SCALE_LIMIT)
GEOMETRIES = {
    "utm_laea": (
        dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"),
        dict(size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035"),
    ),
    "geo_utm": (
        dict(size=(800, 600), xy_min=(-10.0, 35.0), xy_res=0.05, crs="epsg:4326"),
        dict(size=(256, 256), xy_min=(250000.0, 5200000.0), xy_res=2400.0, crs="epsg:32632"),
    ),
    # BASELINE #3 (global 0.05 deg EPSG:4326 7200x3600 -> EPSG:3035 4096^2
    # at 1500 m) cut to 720x360 at 0.5 deg and 384^2 at 16 km over the same
    # extents, keeping its scale (a smaller target would ask for the
    # pre-downscale): the target reaches 87.6 N, a singular warp
    "global_laea": (
        dict(size=(720, 360), xy_min=(-180.0, -90.0), xy_res=0.5, crs="epsg:4326"),
        dict(size=(384, 384), xy_min=(2000000.0, 1000000.0), xy_res=16000.0, crs="epsg:3035"),
    ),
}


def _geometry(name, pkg=port, **source_kwargs):
    src, tgt = GEOMETRIES[name]
    return (
        pkg.GridMapping.regular(**src, **source_kwargs),
        pkg.GridMapping.regular(**tgt),
    )


def _dataset(gm, pkg=port, **variables):
    """A dataset of *pkg*'s classes on *gm* holding (y, x) or (band, y, x)
    variables."""
    coords = dict(gm.to_coords(exclude_bounds=True))
    coords["spatial_ref"] = pkg.DataArray(np.array(0), dims=(), attrs=gm.crs.to_cf())
    x_dim, y_dim = gm.xy_dim_names
    data_vars = {
        name: pkg.DataArray(
            data,
            dims=(y_dim, x_dim) if data.ndim == 2 else ("band", y_dim, x_dim),
            attrs=dict(grid_mapping="spatial_ref"),
        )
        for name, data in variables.items()
    }
    return pkg.Dataset(data_vars, coords=coords)


def _inputs(gm, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((gm.height, gm.width), dtype=np.float32)
    b = rng.random((2, gm.height, gm.width), dtype=np.float32)
    b[1, gm.height // 3] = np.nan
    return a, b


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _assert_match(got, ref, atol=0.0):
    """Equal NaN masks; equal values where *atol* is 0, else within it."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    if atol == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=atol, equal_nan=True)


def _run_both(geometry, interp, j_axis_up=False):
    kwargs = dict(is_j_axis_up=True) if j_axis_up else {}
    jax_source, jax_target = _geometry(geometry, xrt, **kwargs)
    source_gm, target_gm = _geometry(geometry, port, **kwargs)
    a, b = _inputs(source_gm)
    if j_axis_up:
        a, b = a[::-1].copy(), b[:, ::-1].copy()
    jax_ds = _dataset(jax_source, xrt, a=jnp.asarray(a), b=jnp.asarray(b))
    port_ds = _dataset(source_gm, a=torch.from_numpy(a), b=torch.from_numpy(b))
    ref = xrt.resample_in_space(jax_ds, target_gm=jax_target, interp_methods=interp)
    got = port.resample_in_space(port_ds, target_gm=target_gm, interp_methods=interp)
    for name in ("a", "b"):
        data = got[name].data
        assert isinstance(data, torch.Tensor) and data.device.type == "cpu"
        assert got[name].dims == ref[name].dims
    return ref, got


@pytest.mark.parametrize("geometry", ["utm_laea", "geo_utm"])
@pytest.mark.parametrize("interp", METHODS)
def test_resample_in_space_matches_jax_tiled(monkeypatch, geometry, interp):
    """Both packages run the tiled SRW tier on the same plan with the same
    rounding: equal for every method, NaN masks included."""
    jax_calls = _spy(monkeypatch, jax_srw, "make_srw_fn")
    port_calls = _spy(monkeypatch, port_srw, "make_srw_fn")
    ref, got = _run_both(geometry, interp)
    assert jax_calls and port_calls
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    # the regional source is cropped to the window the target taps
    assert (fn.window is not None) == (geometry == "geo_utm")
    for name in ("a", "b"):
        _assert_match(got[name].data.numpy(), ref[name].data)
    assert np.isfinite(np.asarray(ref["a"].data)).mean() > 0.5


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_resample_in_space_exact_matches_jax_esw(monkeypatch, interp):
    """XRTPU_EXACT=1: both packages run their exact separable warp (ESW),
    with no SRW and no K3, and agree bit for bit (NaN masks included)."""
    monkeypatch.setenv("XRTPU_EXACT", "1")
    esw_calls = _spy(monkeypatch, jax_esw, "make_esw_reproject_fn")
    port_esw_calls = _spy(monkeypatch, port_reproject, "make_esw_reproject_fn")
    k3_calls = _spy(monkeypatch, port_reproject, "make_fused_reproject_fn")
    srw_calls = _spy(monkeypatch, port_srw, "make_srw_fn")
    ref, got = _run_both("utm_laea", interp)
    assert esw_calls and port_esw_calls and not k3_calls and not srw_calls
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    assert isinstance(fn, port_esw.ESWReprojectFn)
    for name in ("a", "b"):
        _assert_match(got[name].data.numpy(), ref[name].data, 0.0)


@pytest.mark.parametrize("interp", METHODS)
def test_singular_warp_default_dispatch_runs_k3(monkeypatch, interp):
    """The reduced BASELINE #3 under ``XRTPU_NO_EXACT_MOSAIC=1``: the port's
    planner refuses the tiled SRW plan (``make_srw_reproject_fn`` returns
    None), the switch skips the exact region mosaic, and the dispatch runs
    K3, equal to JAX ``make_fused_reproject_fn`` on ``jnp`` arrays, NaN
    masks included; JAX's dispatch takes its XLA gather there too.

    With no switch set both packages run their exact region mosaic (the
    next test, and ``tests/test_torch_esw_mosaic.py``)."""
    monkeypatch.delenv("XRTPU_EXACT", raising=False)
    monkeypatch.setenv("XRTPU_NO_EXACT_MOSAIC", "1")
    srw_plans = []
    orig = port_reproject.make_srw_reproject_fn

    def spy_srw(*args, **kwargs):
        fn = orig(*args, **kwargs)
        srw_plans.append(fn)
        return fn

    monkeypatch.setattr(port_reproject, "make_srw_reproject_fn", spy_srw)
    k3_calls = _spy(monkeypatch, port_reproject, "make_fused_reproject_fn")
    mosaic_calls = _spy(monkeypatch, port_reproject, "make_region_reproject_fn")
    jax_source, jax_target = _geometry("global_laea", xrt)
    source_gm, target_gm = _geometry("global_laea")
    a, b = _inputs(source_gm)
    got = port.resample_in_space(
        _dataset(source_gm, a=torch.from_numpy(a), b=torch.from_numpy(b)),
        target_gm=target_gm, interp_methods=interp,
    )
    assert srw_plans == [None] and k3_calls and not mosaic_calls
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    assert isinstance(fn, port_reproject_ops.FusedReprojectFn)
    k3 = jax_reproject_ops.make_fused_reproject_fn(
        jax_source, jax_target, interp, np.nan
    )
    for name, data in (("a", a), ("b", b)):
        ref = np.asarray(k3(jnp.asarray(data)))
        _assert_match(got[name].data.numpy(), ref)
    assert np.isfinite(got["a"].data.numpy()).mean() > 0.5


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_singular_warp_matches_jax_exact_mosaic_without_x64(monkeypatch, interp):
    """The reduced BASELINE #3 through both packages' default dispatch,
    JAX with x64 off (under the suite's x64 its mosaic raises ``TypeError``
    in ``ops/esw.py:1745``, mixed int64/int32 ``dynamic_slice`` indices, a
    fault of the reference's): both run their exact region mosaic (the
    port's ``ESWMosaicFn``, K16's plain version here, and no K3) and agree
    bit for bit, NaN masks included."""
    monkeypatch.delenv("XRTPU_EXACT", raising=False)
    mosaic_calls = _spy(monkeypatch, jax_srw, "make_region_reproject_fn")
    port_mosaic_calls = _spy(monkeypatch, port_reproject, "make_region_reproject_fn")
    k3_calls = _spy(monkeypatch, port_reproject, "make_fused_reproject_fn")
    with jax.enable_x64(False):
        ref, got = _run_both("global_laea", interp)
    assert mosaic_calls and port_mosaic_calls and not k3_calls
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    assert isinstance(fn, port_esw_mosaic.ESWMosaicFn)
    for name in ("a", "b"):
        _assert_match(got[name].data.numpy(), ref[name].data)


def test_resample_in_space_j_axis_up_source():
    """A j-axis-up torch source is flipped with torch.flip (torch has no
    negative slice steps) and equals JAX on the same jnp source."""
    ref, got = _run_both("utm_laea", "bilinear", j_axis_up=True)
    for name in ("a", "b"):
        _assert_match(got[name].data.numpy(), ref[name].data)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint16])
def test_numpy_variables_come_back_as_tensors_on_the_device(dtype):
    """A numpy-backed variable takes the JAX package's host path (float64
    target centres, per-tile windows, K9's window mode) on the *device*
    argument's device: it comes back as a tensor of its own dtype there,
    equal to JAX's result on the same numpy data (integers rounded with
    rint), while the tensor variable beside it takes the device tiers and
    equals JAX on jnp data."""
    source_gm, target_gm = _geometry("utm_laea")
    a, b = _inputs(source_gm)
    if dtype == np.uint16:
        data = (a * 60000).astype(dtype)
        stack = (np.nan_to_num(b) * 60000).astype(dtype)
    else:
        data, stack = a.astype(dtype), b.astype(dtype)
    ds = _dataset(source_gm, a=data, b=stack, t=torch.from_numpy(a))
    got = port.resample_in_space(ds, target_gm=target_gm, device="cpu")
    for name in ("a", "b", "t"):
        assert isinstance(got[name].data, torch.Tensor)
        assert got[name].data.device.type == "cpu"
    jax_source, jax_target = _geometry("utm_laea", xrt)
    ref = xrt.resample_in_space(
        _dataset(jax_source, xrt, a=data, b=stack, t=jnp.asarray(a)), target_gm=jax_target
    )
    for name in ("a", "b"):
        assert got[name].data.dtype == torch.from_numpy(data).dtype
        assert np.asarray(ref[name].data).dtype == data.dtype
        _assert_match(got[name].data.numpy(), np.asarray(ref[name].data))
    assert got["t"].data.dtype == torch.float32
    _assert_match(got["t"].data.numpy(), ref["t"].data)


def test_entry_points_default_to_the_card():
    """Every entry point that places data defaults to the card; there is
    no CPU fallback: without a card a numpy variable raises."""
    for fn in (
        port.resample_in_space, port_reproject.reproject_dataset,
        port.affine_transform_dataset, port.resample_dataset,
        port_srw.make_srw_fn, port_srw.make_srw_reproject_fn,
        port_reproject_ops.make_fused_reproject_fn,
    ):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    source_gm, target_gm = _geometry("utm_laea")
    ds = _dataset(source_gm, a=_inputs(source_gm)[0])
    affine_gm = port.GridMapping.regular(
        size=(40, 40), xy_min=(565000.0, 5930000.0), xy_res=200.0, crs="epsg:32632"
    )
    for target in (target_gm, affine_gm):
        if torch.cuda.is_available():
            got = port.resample_in_space(ds, target_gm=target)
            assert got["a"].data.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                port.resample_in_space(ds, target_gm=target)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            port.affine_transform_dataset(ds, affine_gm)


def test_grid_variables_on_several_devices_raise():
    """A numpy variable placed on *device* beside a tensor on another
    device: mixing devices raises instead of moving data."""
    source_gm, target_gm = _geometry("utm_laea")
    a, b = _inputs(source_gm)
    ds = _dataset(source_gm, a=a, b=torch.from_numpy(b))
    with pytest.raises(ValueError, match="several devices"):
        port.resample_in_space(ds, target_gm=target_gm, device="meta")


@pytest.mark.parametrize(
    "dtype, fill, interp",
    [
        (torch.float32, np.nan, "bilinear"),
        (torch.float64, np.nan, "bilinear"),
        (torch.uint8, 255, "nearest"),
        (torch.uint16, 65535, "nearest"),
        (torch.int32, -1, "nearest"),
    ],
)
def test_option_defaults_for_torch_dtypes(dtype, fill, interp):
    """The port's resolvers key on torch dtypes: the same defaults per
    dtype as the JAX package's on numpy dtypes, and mappings keyed by
    variable name or torch dtype."""
    var = port.DataArray(torch.zeros((1, 3, 3), dtype=dtype), dims=("b", "y", "x"))
    got_fill = port_utils._get_fill_value(None, "v", var)
    if np.isnan(fill):
        assert np.isnan(got_fill)
    else:
        assert got_fill == fill
    assert port_utils._get_interp_method_str(None, "v", var) == interp
    assert port_utils._get_fill_value({dtype: 7}, "v", var) == 7
    assert port_utils._get_interp_method_str({"v": 0}, "v", var) == "nearest"


def _to_port(ds):
    """A JAX-package xrlite dataset rebuilt with the port's classes."""
    def copy(da):
        return port.DataArray(np.asarray(da.data), dims=da.dims, attrs=dict(da.attrs))

    return port.Dataset(
        {name: copy(v) for name, v in ds.data_vars.items()},
        coords={name: copy(c) for name, c in ds.coords.items()},
        attrs=dict(ds.attrs),
    )


def _route_case(monkeypatch, case, pkg=port, tensor=torch.from_numpy, interp=None):
    """``resample_in_space`` on the utm_laea source with *case*'s target or
    option, run with *pkg*'s classes on the data made by *tensor*, with
    *interp* where given."""
    source_gm, target_gm = _geometry("utm_laea", pkg)
    data = tensor(_inputs(source_gm)[0])
    kwargs = {} if interp is None else dict(interp_methods=interp)
    if case == "affine":
        target_gm = pkg.GridMapping.regular(
            size=(40, 40), xy_min=(565000.0, 5930000.0), xy_res=200.0,
            crs="epsg:32632",
        )
    elif case == "rectify":
        from .sampledata import create_olci_like_swath

        swath = create_olci_like_swath(width=48, height=64, tile_size=16)
        if pkg is port:
            return port.resample_in_space(_to_port(swath), device="cpu")
        return xrt.resample_in_space(swath)
    elif case == "downscale":
        target_gm = pkg.GridMapping.regular(
            size=(20, 20), xy_min=(4320500, 3379500), xy_res=400,
            crs="epsg:3035",
        )
    elif case == "extreme_warp":
        monkeypatch.setenv("XRTPU_FAST_EXTREME_WARP", "1")
    elif case == "float64":
        data = data.double() if isinstance(data, torch.Tensor) else data.astype(np.float64)
    elif case == "cubic":
        kwargs["interp_methods"] = "cubic"
    elif case == "int_numpy":
        data = (np.asarray(data) * 200).astype(np.uint8)
    ds = _dataset(source_gm, pkg, a=data)
    if pkg is port:
        kwargs["device"] = "cpu"
    return pkg.resample_in_space(ds, target_gm=target_gm, **kwargs)


@pytest.mark.parametrize("case, match", [("cubic", "interp_methods must be one of")])
def test_routes_outside_the_slice_raise(monkeypatch, case, match):
    with pytest.raises(NotImplementedError, match=match):
        _route_case(monkeypatch, case)


def test_float64_route_matches_jax(monkeypatch):
    """A float64 tensor, which raised before the port took every dtype:
    both packages pick the tiled SRW, which computes and returns float64
    (jnp promotes float32 weights times float64), equal bit for bit."""
    ref = _route_case(monkeypatch, "float64", xrt, jnp.asarray)
    got = _route_case(monkeypatch, "float64")
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    assert isinstance(fn, port_srw.SRWFn) and fn.kind == "tiled"
    data = got["a"].data
    assert data.dtype == torch.float64 and np.asarray(ref["a"].data).dtype == np.float64
    _assert_match(data.numpy(), np.asarray(ref["a"].data))
    assert np.isfinite(np.asarray(ref["a"].data)).mean() > 0.5


@pytest.mark.parametrize("interp", METHODS)
def test_fast_extreme_warp_route_matches_jax(monkeypatch, interp):
    """``XRTPU_FAST_EXTREME_WARP=1``, which raised before the port had the
    hybrid SRW: on the mild utm_laea warp both packages' dispatch skip the
    two-pass fidelity gate, admit the hybrid (not for triangular) and still
    pick the tiled SRW; the outputs are equal bit for bit."""
    ref = _route_case(monkeypatch, "extreme_warp", xrt, jnp.asarray, interp)
    got = _route_case(monkeypatch, "extreme_warp", interp=interp)
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    assert isinstance(fn, port_srw.SRWFn) and fn.kind == "tiled"
    _assert_match(got["a"].data.numpy(), np.asarray(ref["a"].data))
    assert np.isfinite(np.asarray(ref["a"].data)).mean() > 0.5


@pytest.mark.parametrize("case", ["rectify", "int_numpy"])
def test_rectify_and_integer_numpy_routes_match_jax(monkeypatch, case):
    """Routes that raised before the port had them: an irregular swath
    (the rectify route, numpy variable, host Phase B) and a uint8 numpy
    variable on the reproject route (the host path, rint), each equal to
    JAX on the same numpy data, dtype kept."""
    ref = _route_case(monkeypatch, case, xrt, np.asarray)
    got = _route_case(monkeypatch, case, tensor=np.asarray)
    name = "rad" if case == "rectify" else "a"
    data = got[name].data
    ref_data = np.asarray(ref[name].data)
    assert isinstance(data, torch.Tensor) and data.device.type == "cpu"
    assert data.numpy().dtype == ref_data.dtype
    _assert_match(data.numpy(), ref_data)
    if ref_data.dtype.kind == "f":
        assert np.isfinite(ref_data).mean() > 0.5


@pytest.mark.parametrize("case", ["affine", "downscale"])
def test_affine_and_downscale_routes_match_jax(monkeypatch, case):
    """The affine route (a 2x downscale within UTM32N: K4, then K5's mean)
    and a reproject to a 4x coarser EPSG:3035 grid (the pre-downscale,
    then the tiled SRW), each against JAX on jnp arrays: float32 means
    within rtol 1e-6, NaN masks equal."""
    ref = _route_case(monkeypatch, case, xrt, jnp.asarray)
    got = _route_case(monkeypatch, case)
    data = got["a"].data
    assert isinstance(data, torch.Tensor) and data.dtype == torch.float32
    assert data.shape == ((40, 40) if case == "affine" else (20, 20))
    ref = np.asarray(ref["a"].data)
    np.testing.assert_array_equal(np.isnan(data.numpy()), np.isnan(ref))
    np.testing.assert_allclose(data.numpy(), ref, rtol=1e-6, equal_nan=True)
    assert np.isfinite(ref).mean() > 0.5


def test_port_never_imports_jax():
    """In a fresh process, importing the port and driving resample_in_space
    on CPU tensors (tiled SRW, K3, each also under
    ``XRTPU_FAST_EXTREME_WARP=1``, the affine route, the reproject
    pre-downscale, and the rectify route with a tensor and a numpy
    variable under both Phase A tiers, K10's tile plan and the resident
    Phase B among them), and driving sharded_reproject on a mesh of CPU
    devices (the band forms of K1, K2 and K3), resample_to_store into
    a zarr store and the dry run of every sharded path (the sharded
    rectify: K11, K12 and K7's band form) loads no module of JAX or of the
    JAX package."""
    code = (
        "import os, sys\n"
        "import numpy as np, torch\n"
        "import xcube_resampling_tpu_torch as port\n"
        "import xcube_resampling_tpu_torch._build, xcube_resampling_tpu_torch.ops.srw\n"
        "s = port.GridMapping.regular(size=(96, 96), xy_min=(565000.0, 5930000.0),"
        " xy_res=100.0, crs='epsg:32632')\n"
        "t = port.GridMapping.regular(size=(80, 80), xy_min=(4320500, 3379500),"
        " xy_res=100, crs='epsg:3035')\n"
        "coords = dict(s.to_coords(exclude_bounds=True))\n"
        "coords['spatial_ref'] = port.DataArray(np.array(0), dims=(), attrs=s.crs.to_cf())\n"
        "v = port.DataArray(torch.rand(96, 96), dims=('y', 'x'),"
        " attrs=dict(grid_mapping='spatial_ref'))\n"
        "ds = port.Dataset({'v': v}, coords=coords)\n"
        "for exact in ('', '1'):\n"
        "    for fast in ('', '1'):\n"
        "        os.environ['XRTPU_EXACT'] = exact\n"
        "        os.environ['XRTPU_FAST_EXTREME_WARP'] = fast\n"
        "        out = port.resample_in_space(ds, target_gm=t, device='cpu')\n"
        "        assert out['v'].data.shape == (80, 80)\n"
        "os.environ['XRTPU_FAST_EXTREME_WARP'] = ''\n"
        "a = port.GridMapping.regular(size=(40, 40), xy_min=(565000.0, 5930000.0),"
        " xy_res=200.0, crs='epsg:32632')\n"
        "d = port.GridMapping.regular(size=(20, 20), xy_min=(4320500, 3379500),"
        " xy_res=400, crs='epsg:3035')\n"
        "for tgt, shape in ((a, (40, 40)), (d, (20, 20))):\n"
        "    out = port.resample_in_space(ds, target_gm=tgt, agg_methods='mode',"
        " device='cpu')\n"
        "    assert out['v'].data.shape == shape\n"
        "j, i = np.mgrid[0:60, 0:48].astype(float)\n"
        "sw = port.Dataset({'r': port.DataArray(np.random.rand(60, 48).astype('float32'),"
        " dims=('y', 'x'))}, coords={'lon': port.DataArray(4 + 0.0025 * (i + 0.12 * j),"
        " dims=('y', 'x')), 'lat': port.DataArray(62 - 0.0025 * (j - 0.08 * i),"
        " dims=('y', 'x'))})\n"
        "sw['t'] = port.DataArray(torch.from_numpy(sw['r'].data.copy()), dims=('y', 'x'))\n"
        "for tier in ('auto', 'device'):\n"
        "    os.environ['XRTPU_PHASEA'] = tier\n"
        "    for m in ('nearest', 'bilinear'):\n"
        "        out = port.resample_in_space(sw, interp_methods=m, device='cpu')\n"
        "        assert out['r'].data.dtype == out['t'].data.dtype == torch.float32\n"
        "assert 'xcube_resampling_tpu_torch.ops.bbox_ops' in sys.modules\n"
        "from xcube_resampling_tpu_torch import parallel, zarrlite\n"
        "mesh = parallel.make_mesh(devices=[torch.device('cpu')] * 3)\n"
        "for srw in (True, False):\n"
        "    out = parallel.sharded_reproject(torch.rand(2, 96, 96), s, t, mesh,"
        " use_srw=srw)\n"
        "    assert out.full().shape == (2, 80, 80) and len(out.bands) == 3\n"
        "v = port.DataArray(np.random.rand(96, 96).astype('float32'), dims=('y', 'x'),"
        " attrs=dict(grid_mapping='spatial_ref'))\n"
        "store = zarrlite.MemoryStore()\n"
        "n = parallel.resample_to_store(port.Dataset({'v': v}, coords=coords),"
        " t.derive(tile_size=40), store, device='cpu')\n"
        "assert n == 4 and zarrlite.open_dataset(store)['v'].shape == (80, 80)\n"
        "from xcube_resampling_tpu_torch import entry\n"
        "entry.dryrun_multichip(2, devices=[torch.device('cpu')] * 2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'xcube_resampling_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
