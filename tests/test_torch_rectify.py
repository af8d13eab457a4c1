"""The port's rectify route against the JAX package, on the CPU.

Both packages get the same numpy inputs (the JAX package's sample swaths,
rebuilt with the port's classes); the port runs its kernels' plain
versions on CPU tensors.  Tolerance classes:

* Phase A: the port's map (K8's plain version over the host tier's tile
  table) equals the JAX package's host tier (``rectify._inverse_ij_map``
  on the CPU) bit for bit, NaN coverage included;
* tensor variables against ``jnp`` variables (the device Phase B): equal,
  NaN masks included, whether JAX takes its tiled SRW (``make_srw_fn``),
  its batched SRW (``make_srw_fn_batched``, the same function, which the
  port runs on K1 and K2 too) or its gather;
* numpy variables against numpy variables (the host Phase B): dtype kept,
  equal;
* the reference goldens of ``tests/test_rectify.py``, numpy variables:
  equal to the JAX package's output (and so to its goldens).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as xrt  # noqa: E402
import xcube_resampling_tpu_torch as port  # noqa: E402
from xcube_resampling_tpu import rectify as jax_rectify  # noqa: E402
from xcube_resampling_tpu.constants import UV_DELTA  # noqa: E402
from xcube_resampling_tpu.gridmapping import CRS_WGS84  # noqa: E402
from xcube_resampling_tpu.ops import rectify_ops as jax_rectify_ops  # noqa: E402
from xcube_resampling_tpu.ops import srw as jax_srw  # noqa: E402
from xcube_resampling_tpu_torch import rectify as port_rectify  # noqa: E402

from .sampledata import (  # noqa: E402
    create_2x2_dataset_with_irregular_coords,
    create_2x2_dataset_with_irregular_coords_antimeridian,
    create_2x2x2_dataset_with_irregular_coords,
    create_4x4_dataset_with_irregular_coords,
    create_olci_like_swath,
)
from .test_rectify import expected_rad_13x13  # noqa: E402

METHODS = ["nearest", "bilinear", "triangular"]

# (width, height, tile size) of create_olci_like_swath: the JAX package's
# device Phase B takes its tiled SRW on the first (n_ops 126), its batched
# SRW on the second (n_ops 167) and, where the map's coarse fields miss it
# by more than 0.05 px, its plain gather on the third
SWATHS = {
    "tiled": (233, 307, 128),
    "batched": (300, 420, 64),
    "gather": (400, 500, 128),
}


@pytest.fixture(autouse=True)
def _host_tier(monkeypatch):
    monkeypatch.delenv("XRTPU_PHASEA", raising=False)
    monkeypatch.delenv("XRTPU_PHASEB_SRW", raising=False)


def _to_port(ds, tensors=()):
    """A JAX-package dataset rebuilt with the port's classes; the variables
    named in *tensors* as CPU tensors."""
    def copy(name, da):
        data = np.asarray(da.data)
        if name in tensors:
            data = torch.from_numpy(data.copy())
        return port.DataArray(data, dims=da.dims, attrs=dict(da.attrs), chunks=da.chunks)

    return port.Dataset(
        {name: copy(name, v) for name, v in ds.data_vars.items()},
        coords={name: copy(name, c) for name, c in ds.coords.items()},
        attrs=dict(ds.attrs),
    )


def _with_jnp(ds, names):
    out = ds.copy()
    for name in names:
        v = ds[name]
        out[name] = xrt.DataArray(jnp.asarray(np.asarray(v.data)), dims=v.dims,
                                  attrs=dict(v.attrs))
    return out


def _swath(width, height, tile_size, nan_rows=()):
    ds = create_olci_like_swath(width=width, height=height, tile_size=tile_size)
    if nan_rows:
        for name in ("lon", "lat"):
            data = np.array(ds[name].data)
            data[list(nan_rows)] = np.nan
            ds = ds.assign_coords({name: xrt.DataArray(data, dims=ds[name].dims)})
    return ds


def _assert_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize(
    "width, height, tile_size, nan_rows",
    [
        (233, 307, 128, ()),
        (233, 307, 64, (40, 41, 200)),
        (120, 160, 32, (0, 159)),
    ],
)
def test_phase_a_map_equals_the_host_tier(width, height, tile_size, nan_rows):
    """K8's plain version over the host tier's tile table equals the JAX
    package's host tier bit for bit, NaN coverage included (NaN rows in the
    swath's coordinates leave holes; the tile table keeps each tile's window
    and origin)."""
    ds = _swath(width, height, tile_size, nan_rows)
    jax_gm = xrt.GridMapping.from_dataset(ds)
    port_gm = port.GridMapping.from_dataset(_to_port(ds))
    ref = jax_rectify._inverse_ij_map(jax_gm, jax_gm.to_regular(tile_size=tile_size), UV_DELTA)
    assert isinstance(ref, np.ndarray)
    got = port_rectify._inverse_ij_map(
        port_gm, port_gm.to_regular(tile_size=tile_size), UV_DELTA, "cpu"
    )
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isnan(ref).any() and np.isfinite(ref).mean() > 0.5


def test_phase_a_tile_table_has_empty_windows():
    """A target reaching past the swath has tiles no quad can land in: the
    table gives them empty windows and their pixels stay NaN, as the host
    tier's tiles with an i_lo of -1 do."""
    ds = _swath(120, 160, 32)
    jax_gm = xrt.GridMapping.from_dataset(ds)
    port_gm = port.GridMapping.from_dataset(_to_port(ds))
    kwargs = dict(size=(96, 80), xy_min=(3.9, 61.4), xy_res=0.005, tile_size=16)
    jax_t = xrt.GridMapping.regular(crs=CRS_WGS84, **kwargs)
    port_t = port.GridMapping.regular(crs="EPSG:4326", **kwargs)
    tiles = port_rectify._phase_a_tiles(port_gm, port_t)
    empty = (tiles.ints[:, 6] == 0) & (tiles.ints[:, 7] == 0)
    assert empty.any() and not empty.all()
    ref = jax_rectify._inverse_ij_map(jax_gm, jax_t, UV_DELTA)
    got = port_rectify._inverse_ij_map(port_gm, port_t, UV_DELTA, "cpu").numpy()
    np.testing.assert_array_equal(got, ref)


SMALL_WINDOWS = {
    "2x2": (create_2x2_dataset_with_irregular_coords, None),
    "2x2 antimeridian": (create_2x2_dataset_with_irregular_coords_antimeridian, None),
    "4x4": (create_4x4_dataset_with_irregular_coords, None),
    "71x45 NaN rows 8, 16, 17": (lambda: _swath(71, 45, 24, (8, 16, 17)), 24),
    "97x11": (lambda: _swath(97, 11, 16), 16),
}


@pytest.mark.parametrize("case", sorted(SMALL_WINDOWS))
def test_phase_a_small_windows_equal_the_host_tier(case):
    """K8's plain version over the host tier's tile table on swaths whose
    tile windows hold one quad (the 2x2 sources), a few, or quad counts
    that are no multiple of K8's patch (NaN swath rows on the patch rows'
    boundaries; a swath of ten quad rows): equal to the JAX package's host
    tier bit for bit."""
    make, tile_size = SMALL_WINDOWS[case]
    ds = make()
    jax_gm = xrt.GridMapping.from_dataset(ds)
    port_gm = port.GridMapping.from_dataset(_to_port(ds))
    kw = dict(tile_size=tile_size) if tile_size else {}
    ref = jax_rectify._inverse_ij_map(jax_gm, jax_gm.to_regular(**kw), UV_DELTA)
    got = port_rectify._inverse_ij_map(port_gm, port_gm.to_regular(**kw), UV_DELTA, "cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isfinite(ref).any()


def _device_phase_b_case(monkeypatch, swath, interp):
    width, height, tile_size = SWATHS[swath]
    ds = _swath(width, height, tile_size)
    rad = np.asarray(ds.rad.data)
    rad[height // 3, : width // 2] = np.nan
    ds["rad"] = xrt.DataArray(rad, dims=ds.rad.dims)
    ds["stack"] = xrt.DataArray(np.stack([rad, 2 * rad + 1]), dims=("band",) + ds.rad.dims)
    picked = []
    for name in ("make_srw_fn", "make_srw_fn_batched"):
        orig = getattr(jax_srw, name)

        def spy(*args, _orig=orig, _name=name, **kwargs):
            picked.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(jax_srw, name, spy)
    ref = xrt.rectify_dataset(_with_jnp(ds, ("rad", "stack")), interp_methods=interp)
    got = port.rectify_dataset(_to_port(ds, ("rad", "stack")), interp_methods=interp,
                               device="cpu")
    return ref, got, picked


@pytest.mark.parametrize("swath", sorted(SWATHS))
@pytest.mark.parametrize("interp", METHODS)
def test_tensor_variables_match_jax_device_phase_b(monkeypatch, swath, interp):
    """Tensor variables against jnp variables (2D and a 2-band stack, NaN
    taps): equal for every method, whether JAX takes its tiled SRW, its
    batched SRW (which K1 and K2 compute bit for bit) or its gather.  The
    spies pin which of JAX's kernels each case exercises."""
    ref, got, picked = _device_phase_b_case(monkeypatch, swath, interp)
    srw = interp != "nearest" and swath != "gather"
    expect = {"tiled": ["make_srw_fn"], "batched": ["make_srw_fn_batched"]}
    assert picked[:1] == (expect[swath] if srw else [])
    for name in ("rad", "stack"):
        g = got[name].data
        r = np.asarray(ref[name].data)
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert got[name].dims == ref[name].dims
        g = g.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_array_equal(g, r)
        assert np.isfinite(r).mean() > 0.5


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint16", "int16"])
@pytest.mark.parametrize("interp", METHODS)
def test_numpy_variables_match_jax_host_phase_b(dtype, interp):
    """Numpy variables against numpy variables: the host Phase B (K9's
    ij_map mode) keeps the dtype (integers rounded with rint) and equals
    the JAX package's host gather."""
    ds = _swath(233, 307, 128)
    rad = np.asarray(ds.rad.data)
    if dtype.startswith("float"):
        data = rad.astype(dtype)
        data[100, 40:90] = np.nan
    else:
        data = (rad * (300 if dtype == "uint16" else -100)).astype(dtype)
    ds["rad"] = xrt.DataArray(data, dims=ds.rad.dims)
    ref = xrt.rectify_dataset(ds, interp_methods=interp)
    got = port.rectify_dataset(_to_port(ds), interp_methods=interp, device="cpu")
    g = got["rad"].data
    assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
    _assert_equal(g.numpy(), np.asarray(ref["rad"].data))


def _golden_cases():
    seven = dict(size=(7, 7), xy_min=(-0.5, 49.5), xy_res=1.0)
    thirteen = dict(size=(13, 13), xy_min=(-0.25, 49.75), xy_res=0.5)
    return {
        "2x2_to_default": (create_2x2_dataset_with_irregular_coords, dict(
            size=(4, 4), xy_min=(-1, 49), xy_res=2), 0, False),
        "2x2_to_regular": (create_2x2_dataset_with_irregular_coords, None, 0, False),
        "2x2x2_to_default": (create_2x2x2_dataset_with_irregular_coords, dict(
            size=(4, 4), xy_min=(-1, 49), xy_res=2), 0, False),
        "2x2_to_7x7": (create_2x2_dataset_with_irregular_coords, seven, 0, True),
        "2x2_to_7x7_triangular": (create_2x2_dataset_with_irregular_coords, seven,
                                  "triangular", True),
        "2x2_to_7x7_bilinear": (create_2x2_dataset_with_irregular_coords, seven,
                                "bilinear", True),
        "2x2_to_7x7_subset": (create_2x2_dataset_with_irregular_coords, dict(
            size=(7, 7), xy_min=(1.5, 50.5), xy_res=1.0), "nearest", False),
        "2x2_to_13x13": (create_2x2_dataset_with_irregular_coords, thirteen, 0, False),
        "2x2_to_13x13_j_axis_up": (create_2x2_dataset_with_irregular_coords, dict(
            thirteen, is_j_axis_up=True), 0, False),
        "2x2_to_13x13_j_axis_up_tiles_5x5": (create_2x2_dataset_with_irregular_coords, dict(
            thirteen, is_j_axis_up=True, tile_size=5), 0, False),
        "2x2_to_13x13_tiles_7": (create_2x2_dataset_with_irregular_coords, dict(
            thirteen, tile_size=7), 0, False),
        "2x2_to_13x13_tiles_3x13": (create_2x2_dataset_with_irregular_coords, dict(
            thirteen, tile_size=(3, 13)), 0, False),
        "2x2_to_13x13_antimeridian": (create_2x2_dataset_with_irregular_coords_antimeridian,
                                      dict(size=(13, 13), xy_min=(177.75, 49.75),
                                           xy_res=0.5), 0, False),
        "2x2_to_13x13_none": (create_2x2_dataset_with_irregular_coords, dict(
            size=(13, 13), xy_min=(10.0, 50.0), xy_res=0.5), 0, False),
        "different_crs": (create_4x4_dataset_with_irregular_coords, dict(
            size=(3, 3), xy_min=(3600000, 3200000), xy_res=100000, crs="epsg:3035"),
            0, False),
    }


GOLDENS = _golden_cases()


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_reference_goldens(case):
    """The reference goldens of tests/test_rectify.py through the port
    (numpy variables, the host Phase B): equal to the JAX package's output,
    dims and chunks included; the 13x13 cases also to the golden image."""
    make, target, interp, offset = GOLDENS[case]
    ds = make()
    if offset:
        ds["rad"] = ds.rad + xrt.DataArray(np.array([[0.0, 0.0], [0.0, 1.0]]), dims=("y", "x"))
    if target is None:
        jax_t = port_t = None
    else:
        kwargs = dict(target)
        crs = kwargs.pop("crs", None)
        jax_t = xrt.GridMapping.regular(crs=crs or CRS_WGS84, **kwargs)
        port_t = port.GridMapping.regular(crs=crs or "EPSG:4326", **kwargs)
    ref = xrt.rectify_dataset(ds, target_gm=jax_t, interp_methods=interp)
    got = port.rectify_dataset(_to_port(ds), target_gm=port_t, interp_methods=interp,
                               device="cpu")
    assert set(got.variables) == set(ref.variables)
    for name in ref.variables:
        r, g = ref[name], got[name]
        assert g.dims == r.dims and g.chunks == r.chunks, name
        data = g.data.numpy() if isinstance(g.data, torch.Tensor) else np.asarray(g.data)
        _assert_equal(data, np.asarray(r.data))
    if case.startswith("2x2_to_13x13") and not case.endswith("none"):
        expected = expected_rad_13x13(got["rad"].data.numpy().dtype)
        if "j_axis_up" in case:
            expected = expected[::-1]
        np.testing.assert_almost_equal(got["rad"].data.numpy(), expected)


def test_invalid_interp_raises():
    ds = _to_port(create_2x2_dataset_with_irregular_coords())
    target = port.GridMapping.regular(size=(7, 7), xy_min=(-0.5, 49.5), xy_res=1.0,
                                      crs="EPSG:4326")
    with pytest.raises(NotImplementedError, match="interp_methods must be one of"):
        port.rectify_dataset(ds, target_gm=target, interp_methods="cubic", device="cpu")
    with pytest.raises(NotImplementedError, match="interp_methods must be one of"):
        port.rectify_dataset(_to_port(create_2x2_dataset_with_irregular_coords(), ("rad",)),
                             target_gm=target, interp_methods="cubic", device="cpu")


def test_resample_in_space_routes_irregular_sources_to_rectify(monkeypatch):
    """The gateway sends an irregular source to rectify_dataset with its
    device; the result equals JAX's resample_in_space on the same swath."""
    calls = []
    orig = port_rectify.rectify_dataset

    def spy(*args, **kwargs):
        calls.append(kwargs.get("device"))
        return orig(*args, **kwargs)

    monkeypatch.setattr("xcube_resampling_tpu_torch.spatial.rectify_dataset", spy)
    ds = _swath(120, 160, 32)
    ref = xrt.resample_in_space(ds, interp_methods=0)
    got = port.resample_in_space(_to_port(ds), interp_methods=0, device="cpu")
    assert calls == ["cpu"]
    _assert_equal(got["rad"].data.numpy(), np.asarray(ref["rad"].data))


def test_plain_inverse_ij_map_matches_jax_per_window():
    """The float64 torch port of inverse_ij_map against the JAX package's
    on one window with a destination offset, a negative y scale and NaN
    corners: bit for bit."""
    ds = _swath(90, 70, 32, nan_rows=(33,))
    xy = np.stack([np.asarray(ds.lon.data), np.asarray(ds.lat.data)])
    window = xy[:, 10:60, 5:80]
    args = (7, 12, (40, 50), 4.02, 61.98, 0.0031, -0.0027, UV_DELTA)
    ref = jax_rectify_ops.inverse_ij_map(window[0], window[1], *args)
    from xcube_resampling_tpu_torch.ops import rectify_ops as port_rectify_ops

    got = port_rectify_ops.inverse_ij_map(
        torch.from_numpy(window[0].copy()), torch.from_numpy(window[1].copy()), *args
    )
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isnan(ref).any() and np.isfinite(ref).any()


# -- the device tier: K10's tile plan and the resident Phase B ---------------


def _jax_resident(m):
    """The JAX package's DeviceIJMap over a host map, as
    tests/test_parallel.py builds one."""
    plan = jax_rectify_ops.PhaseAPlan(dst_h=m.shape[1], dst_w=m.shape[2], src_i_min=0,
                                      src_j_min=0, dtype=jnp.float64)
    return jax_rectify_ops.DeviceIJMap(plan, jnp.asarray(m))


def _spy_srw(monkeypatch):
    picked = []
    for name in ("make_srw_fn", "make_srw_fn_batched"):
        orig = getattr(jax_srw, name)

        def spy(*args, _orig=orig, _name=name, **kwargs):
            picked.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(jax_srw, name, spy)
    return picked


def _assert_phase_b(got, ref):
    """NaN coverage equal; values equal."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize(
    "width, height, tile_size, nan_rows",
    [
        (233, 307, 128, ()),
        (233, 307, 64, (40, 41, 200)),
        (120, 160, 32, (0, 159)),
    ],
)
def test_device_tier_map_equals_the_host_tier(width, height, tile_size, nan_rows):
    """The device tier's fallback, where JAX's ladder refuses the geometry
    (``_inverse_ij_map_from_tiles``): K10's plain version plans the tiles on
    the swath tensor, the same tile table as the host scan, so K8's map
    (held in a DeviceIJMap) equals the host tier's, and the JAX host
    tier's, bit for bit."""
    ds = _swath(width, height, tile_size, nan_rows)
    jax_gm = xrt.GridMapping.from_dataset(ds)
    port_gm = port.GridMapping.from_dataset(_to_port(ds))
    target = port_gm.to_regular(tile_size=tile_size)
    swath = torch.from_numpy(np.stack([np.asarray(port_gm.xy_coords.data[0]),
                                       np.asarray(port_gm.xy_coords.data[1])]))
    np.testing.assert_array_equal(port_rectify._phase_a_tiles(port_gm, target, swath).ints,
                                  port_rectify._phase_a_tiles(port_gm, target).ints)
    got = port_rectify._inverse_ij_map_from_tiles(port_gm, target, UV_DELTA, swath)
    assert isinstance(got, port_rectify.rectify_ops.DeviceIJMap)
    ref = jax_rectify._inverse_ij_map(jax_gm, jax_gm.to_regular(tile_size=tile_size), UV_DELTA)
    np.testing.assert_array_equal(got.device_map().numpy(), ref)
    np.testing.assert_array_equal(got.as_numpy(), ref)


@pytest.mark.parametrize("swath", sorted(SWATHS))
@pytest.mark.parametrize("interp", METHODS)
def test_resident_phase_b_matches_jax(monkeypatch, swath, interp):
    """rectify_dataset under XRTPU_PHASEA=device on CPU tensors (2D and a
    2-band stack, NaN taps) against JAX's resident Phase B
    (make_device_var_image_fn_resident over the DeviceIJMap of JAX's
    device tier, whose ladder the port's takes to the same map): equal for
    every method, NaN coverage included, whether JAX takes make_srw_fn or
    make_srw_fn_batched (the same function; the port runs K1 and K2 for
    both).  The lattice gate takes the SRW interior on all three swaths;
    the port never plans from the whole map."""
    width, height, tile_size = SWATHS[swath]
    ds = _swath(width, height, tile_size)
    rad = np.asarray(ds.rad.data)
    rad[height // 3, : width // 2] = np.nan
    stack = np.stack([rad, 2 * rad + 1])
    ds["rad"] = xrt.DataArray(rad, dims=ds.rad.dims)
    ds["stack"] = xrt.DataArray(stack, dims=("band",) + ds.rad.dims)
    jax_gm = xrt.GridMapping.from_dataset(ds)
    monkeypatch.setenv("XRTPU_PHASEA", "device")
    m = jax_rectify._inverse_ij_map(jax_gm, jax_gm.to_regular(tile_size=tile_size), UV_DELTA)
    assert isinstance(m, jax_rectify_ops.DeviceIJMap)
    picked = _spy_srw(monkeypatch)
    fn = jax_rectify_ops.make_device_var_image_fn_resident(m, np.nan, interp)
    refs = {"rad": np.asarray(fn(jnp.asarray(rad[None])))[0],
            "stack": np.asarray(fn(jnp.asarray(stack)))}
    full_map = []
    monkeypatch.setattr(port_rectify.rectify_ops, "make_device_var_image_fn",
                        lambda *a, **k: full_map.append(a))
    got = port.rectify_dataset(_to_port(ds, ("rad", "stack")), interp_methods=interp,
                               device="cpu")
    assert not full_map
    expect = {"tiled": "make_srw_fn"}.get(swath, "make_srw_fn_batched")
    assert picked[:1] == ([] if interp == "nearest" else [expect])
    for name, ref in refs.items():
        g = got[name].data
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert got[name].dims == ds[name].dims[:-2] + ("lat", "lon")
        _assert_phase_b(g.numpy(), ref)
        assert np.isfinite(ref).mean() > 0.5


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("env", ["0", "1"])
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_phase_b_srw_switch_matches_jax(monkeypatch, resident, env, interp):
    """XRTPU_PHASEB_SRW forces K7's map form (0) or the SRW try for every
    method (1) in both Phase B forms, as in the JAX package: equal to
    JAX's make_device_var_image_fn (host map) and
    make_device_var_image_fn_resident (device map) on the same map."""
    ds = _swath(233, 307, 128)
    rad = np.asarray(ds.rad.data)[None]
    jax_gm = xrt.GridMapping.from_dataset(ds)
    m = jax_rectify._inverse_ij_map(jax_gm, jax_gm.to_regular(tile_size=128), UV_DELTA)
    monkeypatch.setenv("XRTPU_PHASEB_SRW", env)
    picked = _spy_srw(monkeypatch)
    if resident:
        ref = jax_rectify_ops.make_device_var_image_fn_resident(_jax_resident(m), np.nan,
                                                                interp)(jnp.asarray(rad))
        fn = port_rectify.rectify_ops.make_device_var_image_fn_resident(
            port_rectify.rectify_ops.DeviceIJMap(torch.from_numpy(m.copy())), np.nan, interp)
        form = type(fn.impl(rad.shape[-2:])).__name__
    else:
        ref = jax_rectify_ops.make_device_var_image_fn(m, rad.shape[-2:], np.nan,
                                                       interp)(jnp.asarray(rad))
        fn = port_rectify.rectify_ops.make_device_var_image_fn(m, rad.shape[-2:], np.nan,
                                                               interp, device="cpu")
        form = type(fn).__name__
    assert picked[:1] == ([] if env == "0" else ["make_srw_fn"])
    assert form == ("GatherPhaseB" if env == "0" else "SRWPhaseB")
    got = fn(torch.from_numpy(rad.copy())).numpy()
    assert got.dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("shape, radius, density", [
    ((50, 61), 18, 0.999), ((40, 37), 18, 1.0), ((90, 120), 18, 0.9995), ((23, 30), 2, 0.97),
])
def test_square_interior_equals_minimum_filter(shape, radius, density):
    """The resident Phase B's interior (two max-pools of the invalid mask,
    padded with invalid) equals scipy's square minimum_filter with cval 0,
    as JAX computes it on the host, bit for bit; also on the validity of a
    Phase A map with NaN rows."""
    from scipy.ndimage import minimum_filter

    from xcube_resampling_tpu_torch.ops.rectify_ops import square_interior

    valid = np.random.default_rng(radius + shape[0]).random(shape) < density
    ds = _swath(120, 160, 32, (0, 80, 159))
    gm = xrt.GridMapping.from_dataset(ds)
    m = jax_rectify._inverse_ij_map(gm, gm.to_regular(tile_size=32), UV_DELTA)
    for v in (valid, np.isfinite(m[0]) & np.isfinite(m[1])):
        ref = minimum_filter(v.astype(np.uint8), size=2 * radius + 1, mode="constant", cval=0) > 0
        got = square_interior(torch.from_numpy(v), radius).numpy()
        np.testing.assert_array_equal(got, ref)
    assert ref.any() and not ref.all()


@pytest.mark.parametrize("interp", METHODS)
def test_numpy_uint16_under_the_device_tier_matches_jax_resident(monkeypatch, interp):
    """Under the device tier a numpy uint16 variable goes to the device and
    through the resident Phase B, as JAX's resident branch takes it
    (jnp's gather_interp: integer tap differences wrap in the source
    type), not K9's float64 host gather: equal to JAX's resident gather of
    it over its device tier's map, dtype included."""
    ds = _swath(233, 307, 128)
    data = (np.asarray(ds.rad.data) * 300).astype(np.uint16)
    ds["rad"] = xrt.DataArray(data, dims=ds.rad.dims)
    gm = xrt.GridMapping.from_dataset(ds)
    monkeypatch.setenv("XRTPU_PHASEA", "device")
    m = jax_rectify._inverse_ij_map(gm, gm.to_regular(tile_size=128), UV_DELTA)
    assert isinstance(m, jax_rectify_ops.DeviceIJMap)
    ref = np.asarray(jax_rectify_ops.make_device_var_image_fn_resident(
        m, 65535, interp)(jnp.asarray(data[None])))[0]
    got = port.rectify_dataset(_to_port(ds), interp_methods=interp, device="cpu")["rad"].data
    assert isinstance(got, torch.Tensor)
    _assert_equal(got.numpy(), ref)


def test_cpu_tensors_take_the_host_pipeline_by_default(monkeypatch):
    """With XRTPU_PHASEA unset (auto), rectify_dataset on CPU tensors takes
    the host tier: the host's bbox scan, a map tensor, the device Phase B
    planned from the whole map; auto picks the device tier on a CUDA
    device; XRTPU_PHASEA overrides either, any other value than device
    meaning the host tier, as in the JAX package."""
    rops = port_rectify.rectify_ops
    calls = []
    for name in ("make_device_var_image_fn", "make_device_var_image_fn_resident"):
        orig = getattr(rops, name)

        def spy(*args, _orig=orig, _name=name, **kwargs):
            calls.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(rops, name, spy)
    monkeypatch.setattr(port_rectify.bbox_ops, "compute_ij_bboxes",
                        lambda *a, **k: calls.append("k10"))
    ds = _swath(120, 160, 32)
    got = port.rectify_dataset(_to_port(ds, ("rad",)), interp_methods="bilinear", device="cpu")
    assert calls == ["make_device_var_image_fn"]
    assert torch.isfinite(got["rad"].data).float().mean() > 0.5
    assert port_rectify._phase_a_tier("cpu") == "host"
    assert port_rectify._phase_a_tier(torch.device("cuda", 0)) == "device"
    for env, tier in (("device", "device"), ("host", "host"), ("hybrid", "host")):
        monkeypatch.setenv("XRTPU_PHASEA", env)
        assert port_rectify._phase_a_tier("cpu") == port_rectify._phase_a_tier("cuda") == tier
