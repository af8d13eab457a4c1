"""The port's sharded reproject against the JAX package's, on the CPU.

JAX shards over its virtual 8-device CPU mesh (``tests/conftest.py``), the
port over a mesh of CPU devices (``make_mesh(devices=[cpu] * n)``), on the
same numpy inputs from a seed, float32.  The port's band kernels run their
plain versions on CPU tensors.  Expected: the sharded SRW and the sharded
regrid equal JAX's steps bit for bit.  Beyond the two-pass gate the port
runs the sharded regrid where JAX runs its sharded ESW; it is held to the
single-chip gather there at the bounds of ``tests/test_parallel.py``'s
cropped case (ROADMAP queue 3).
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu import parallel as jpar  # noqa: E402
from xcube_resampling_tpu.ops.reproject_ops import (  # noqa: E402
    make_fused_reproject_fn as jax_fused,
)
from xcube_resampling_tpu.parallel.halo import required_halo as jax_required_halo  # noqa: E402
from xcube_resampling_tpu_torch import parallel as ppar  # noqa: E402
from xcube_resampling_tpu_torch.ops import reproject_ops, srw_kernels  # noqa: E402
from xcube_resampling_tpu_torch.ops.srw import make_srw_reproject_fn, plan_srw  # noqa: E402
from xcube_resampling_tpu_torch.parallel.halo import (  # noqa: E402
    _exchange_halo,
    _extend,
    plan_sharded_srw,
    required_halo,
)

METHODS = ("bilinear", "nearest", "triangular")
CPU = torch.device("cpu")

UTM = dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632")
LAEA = dict(size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035")
# (source, target) arguments of GridMapping.regular
CASES = {
    "utm": (UTM, LAEA),
    # 90 source rows: no divisor of 4 or 8, so the last band is padded
    "ragged": (dict(UTM, size=(96, 90)), dict(LAEA, size=(80, 75))),
    # a target over the source's upper half: every band's rows map into the
    # upper bands, a halo of several bands at n = 8
    "upper": (UTM, dict(LAEA, size=(80, 40), xy_min=(4320500, 3383500))),
    # a global grid onto EPSG:3035, past the two-pass gate
    # (tests/test_parallel.py:_severe_sharded_case)
    "severe": (
        dict(size=(720, 360), xy_min=(-180.0, -90.0), xy_res=0.5, crs="epsg:4326"),
        dict(size=(256, 256), xy_min=(2500000.0, 1400000.0), xy_res=15000.0,
             crs="epsg:3035"),
    ),
}


def _gms(case):
    src, tgt = CASES[case]
    return (
        (jx.GridMapping.regular(**src), jx.GridMapping.regular(**tgt)),
        (pt.GridMapping.regular(**src), pt.GridMapping.regular(**tgt)),
    )


def _data(case, batch=None, seed=7):
    h, w = CASES[case][0]["size"][::-1]
    shape = (h, w) if batch is None else (batch, h, w)
    rng = np.random.default_rng(seed)
    # a rough surface: neighbouring pixels differ, so any tap or weight
    # difference shows
    return (rng.normal(size=shape).cumsum(-1).cumsum(-2) / 40).astype(np.float32)


def _jax_mesh(n):
    return jpar.make_mesh(("bands",), devices=jax.devices()[:n])


def _port_mesh(n):
    return ppar.make_mesh(devices=[CPU] * n)


def _run_jax(built, data):
    step_fn, (pad, out_h) = built
    src = jnp.asarray(data)
    if pad:
        widths = [(0, 0)] * (src.ndim - 2) + [(0, pad), (0, 0)]
        src = jnp.pad(src, widths, constant_values=np.nan)
    return np.asarray(step_fn(src))[..., :out_h, :]


def _run_port(built, data):
    step_fn, (pad, out_h) = built
    src = torch.from_numpy(data)
    if pad:
        src = torch.nn.functional.pad(src, (0, 0, 0, pad), value=float("nan"))
    sharded = step_fn(src)
    assert sharded.out_h == out_h
    assert all(b.device == CPU for b in sharded.bands)
    return sharded.full().numpy()


def _equal(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(ref).mean() > 0.3


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize(
    "case, n, batch",
    [("utm", 2, 2), ("utm", 3, 2), ("utm", 8, 2), ("utm", 2, None), ("utm", 3, None),
     ("utm", 8, None), ("ragged", 8, 2), ("upper", 8, None)],
)
def test_sharded_srw_matches_jax(case, n, batch, method):
    """make_sharded_srw_step (K1's and K2's band forms after the halo
    exchange) equals JAX's sharded SRW step bit for bit: batched and not,
    n = 2, 3 and 8, a source height no n divides (padded bands), and a
    halo of several bands."""
    (jsrc, jtgt), (psrc, ptgt) = _gms(case)
    data = _data(case, batch)
    dims = 0 if batch is None else 1
    jb = jpar.make_sharded_srw_step(
        _jax_mesh(n), jsrc, jtgt, interp_method=method, src_batch_dims=dims
    )
    pb = ppar.make_sharded_srw_step(
        _port_mesh(n), psrc, ptgt, interp_method=method, src_batch_dims=dims
    )
    assert jb is not None and pb is not None
    assert pb[1] == jb[1]
    plan = pb[0].plan
    if case == "ragged":
        assert pb[1][0] > 0
    if case == "upper":
        assert plan.halo > plan.band_h
    _equal(_run_port(pb, data), _run_jax(jb, data))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case, n", [("utm", 2), ("utm", 3), ("utm", 8), ("severe", 8)])
def test_sharded_regrid_matches_jax(case, n, method):
    """make_sharded_regrid_step (K3's band form after the halo exchange)
    equals JAX's sharded regrid step bit for bit, with the same halo."""
    (jsrc, jtgt), (psrc, ptgt) = _gms(case)
    data = _data(case)
    jb = jpar.make_sharded_regrid_step(_jax_mesh(n), jsrc, jtgt, interp_method=method)
    pb = ppar.make_sharded_regrid_step(_port_mesh(n), psrc, ptgt, interp_method=method)
    assert pb[1] == jb[1]
    _equal(_run_port(pb, data), _run_jax(jb, data))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [2, 3, 8])
def test_required_halo_matches_jax(case, n):
    (jsrc, jtgt), (psrc, ptgt) = _gms(case)
    assert required_halo(psrc, ptgt, n) == jax_required_halo(jsrc, jtgt, n)


@pytest.mark.parametrize("method", METHODS)
def test_sharded_reproject_beyond_the_gate(method):
    """Past the two-pass gate, sharded_reproject crops the source and runs
    the sharded regrid, where JAX runs its sharded ESW.  Against the
    single-chip gather on the whole source (JAX make_fused_reproject_fn):
    NaN masks equal; bilinear and triangular within 2e-4 (the crop's
    window-relative float32 fields, tests/test_parallel.py:367); nearest
    equal but where the band's float32 rebase of iy moves rint, at most
    1e-4 of the pixels."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("severe")
    data = _data("severe")
    assert ppar.make_sharded_srw_step(_port_mesh(8), psrc, ptgt) is None
    got = ppar.sharded_reproject(torch.from_numpy(data), psrc, ptgt, _port_mesh(8),
                                 interp_method=method).full().numpy()
    ref = np.asarray(jax_fused(jsrc, jtgt, method, np.nan)(jnp.asarray(data)))
    assert got.shape == ref.shape == (256, 256)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    valid = ~np.isnan(ref)
    assert valid.mean() > 0.9
    if method == "nearest":
        assert (got[valid] != ref[valid]).mean() <= 1e-4
    else:
        np.testing.assert_allclose(got[valid], ref[valid], rtol=0, atol=2e-4)


def test_undersized_halo_warns(caplog):
    """An explicitly undersized halo warns in both packages; the pixels it
    cuts off resolve to the fill value, equal in both."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("utm")
    with caplog.at_level(logging.WARNING, logger="xcube.resampling"):
        jb = jpar.make_sharded_regrid_step(_jax_mesh(8), jsrc, jtgt, halo=1)
    jax_warned = [r for r in caplog.records if "halo" in r.message]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="xcube.resampling"):
        pb = ppar.make_sharded_regrid_step(_port_mesh(8), psrc, ptgt, halo=1)
    port_warned = [r for r in caplog.records if "halo" in r.message]
    assert jax_warned and port_warned
    assert port_warned[0].getMessage() == jax_warned[0].getMessage()
    data = _data("utm")
    got = _run_port(pb, data)
    _equal(got, _run_jax(jb, data))
    full = _run_port(ppar.make_sharded_regrid_step(_port_mesh(8), psrc, ptgt), data)
    assert np.isnan(got).sum() > np.isnan(full).sum()


@pytest.mark.parametrize("method", METHODS)
def test_mesh_size_invariance(method):
    """sharded_reproject gives the same raster, bit for bit, on meshes of
    1 to 8 devices, and equals the single-chip tiled SRW (finite data:
    the bands' bases differ only by zero-weight taps)."""
    _, (psrc, ptgt) = _gms("utm")
    x = torch.from_numpy(_data("utm", 2))
    outs = [
        ppar.sharded_reproject(x, psrc, ptgt, _port_mesh(n), interp_method=method).full()
        for n in (1, 2, 3, 5, 8)
    ]
    single = make_srw_reproject_fn(psrc, ptgt, method, np.nan, device="cpu")(x)
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), single.numpy())


def test_band_plain_versions_on_a_band_equal_the_single_chip_rows():
    """The band forms' plain versions on a band of rows (its rows from
    row0, the source rows from off > 0 that its taps reach) equal the
    single-chip plain versions' rows; at row0 = off = 0 on the whole
    source they are the single-chip plain versions."""
    _, (psrc, ptgt) = _gms("utm")
    plan = plan_srw(psrc, ptgt, col_tile=64, row_tile=64)
    x = torch.from_numpy(_data("utm", 2))
    f32 = torch.from_numpy
    iystar, ix_c, iy_c = f32(plan.iystar_c), f32(plan.ix_c), f32(plan.iy_c)
    base_v, base_h = f32(plan.base_v), f32(plan.base_h)
    win_v = srw_kernels.plan_vertical_windows(plan.base_v, plan.col_tile, plan.d_v)
    win_h = srw_kernels.plan_horizontal_windows(plan.base_h, plan.row_tile, plan.d_h)
    for method in METHODS:
        v_args = (iystar, plan.step, base_v, plan.col_tile, plan.d_v, win_v, method)
        v, vd = srw_kernels.srw_vertical_plain(x, *v_args)
        v0, vd0 = srw_kernels.srw_vertical_band(x, *v_args, 0, 0, plan.src_h)
        torch.testing.assert_close(v0, v, rtol=0, atol=0)
        # rows 24..63 of the target from source rows off..: every tap inside
        row0, rows = 24, 40
        lo = int(np.clip(plan.base_v[row0 : row0 + rows], 0, plan.src_h - 1).min())
        hi = int(np.clip(plan.base_v[row0 : row0 + rows] + plan.d_v - 1, 0,
                         plan.src_h - 1).max())
        ext = x[:, lo : hi + 1]
        band_win = srw_kernels.plan_vertical_windows(
            plan.base_v[row0 : row0 + rows], plan.col_tile, plan.d_v)
        vb, vdb = srw_kernels.srw_vertical_band(
            ext, iystar, plan.step, base_v[row0 : row0 + rows], plan.col_tile,
            plan.d_v, band_win, method, row0, lo, plan.src_h)
        torch.testing.assert_close(vb, v[:, row0 : row0 + rows], rtol=0, atol=0)
        h_args = (ix_c, iy_c, plan.step, base_h, plan.row_tile, plan.d_h, plan.src_h,
                  win_h, method, np.nan)
        out = srw_kernels.srw_horizontal_plain(v, *h_args, vd)
        out0 = srw_kernels.srw_horizontal_band(v, *h_args, vd, 0)
        torch.testing.assert_close(out0, out, rtol=0, atol=0, equal_nan=True)
        # the second row tile as a band of its own
        rt = plan.row_tile
        band_h_win = srw_kernels.plan_horizontal_windows(plan.base_h[1:2], rt, plan.d_h)
        ob = srw_kernels.srw_horizontal_band(
            v[:, rt : 2 * rt], ix_c, iy_c, plan.step, base_h[1:2], rt, plan.d_h,
            plan.src_h, band_h_win, method, np.nan,
            None if vd is None else vd[:, rt : 2 * rt], rt)
        torch.testing.assert_close(ob, out[:, rt : 2 * rt], rtol=0, atol=0, equal_nan=True)
        # K3: target rows 16..47 from source rows 8..: the single-chip rows
        k3 = (ix_c, iy_c, plan.step)
        full = reproject_ops.fused_reproject_plain(x, *k3, plan.out_h, plan.out_w, method, np.nan)
        band0 = reproject_ops.fused_reproject_band(
            x, *k3, plan.out_h, plan.out_w, method, np.nan, 0, 0, plan.src_h)
        torch.testing.assert_close(band0, full, rtol=0, atol=0, equal_nan=True)
        part = reproject_ops.fused_reproject_band(
            x[:, 8:], *k3, 32, plan.out_w, method, np.nan, 16, 8, plan.src_h)
        ref = full[:, 16:48]
        iy = reproject_ops.interp_field(
            iy_c, torch.arange(16, 48, dtype=torch.float32)[:, None],
            torch.arange(plan.out_w, dtype=torch.float32)[None, :], plan.step)
        inside = iy.clamp(0, plan.src_h - 1) > 8.5  # the band's taps
        assert inside.float().mean() > 0.5
        torch.testing.assert_close(part[:, inside], ref[:, inside], rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.isnan(part[:, (iy <= 7.5) & (iy > -0.5)]).all()


def test_exchange_halo_rows_and_zeros_past_the_edge():
    """Band k's extension holds global rows k * band_h - halo on, from
    neighbours up to two hops away here (halo 7 > band 4), zeros past the
    mesh's edge."""
    n, band_h, halo = 4, 4, 7
    src = torch.arange(2 * n * band_h * 3, dtype=torch.float32).reshape(2, n * band_h, 3)
    bands = [src[:, k * band_h : (k + 1) * band_h] for k in range(n)]
    padded = torch.nn.functional.pad(src, (0, 0, halo, halo))
    halos = _exchange_halo(bands, halo, band_h)
    for k in range(n):
        ext = _extend(bands[k], halos[k])
        torch.testing.assert_close(ext, padded[:, k * band_h : k * band_h + band_h + 2 * halo],
                                   rtol=0, atol=0)
    torch.testing.assert_close(_extend(bands[1], None), bands[1], rtol=0, atol=0)


def test_sharded_srw_plan_windows_cover_each_band():
    """plan_sharded_srw's per-band K1 windows lie inside each band's
    extension once clamped, and K2's tiles are the band's."""
    _, (psrc, ptgt) = _gms("upper")
    plan = plan_sharded_srw(psrc, ptgt, 8)
    ext_h = plan.band_h + 2 * plan.halo
    for k in range(8):
        lo, hi = plan.win_v[k].span
        off = plan.offset(k)
        assert 0 <= min(max(lo, 0), plan.src_h - 1) - off
        assert min(max(hi - 1, 0), plan.src_h - 1) - off < ext_h
        assert plan.win_h[k].lohi.shape[0] == plan.tiles_per_band
        lohi = plan.win_h[k].lohi
        assert plan.win_h[k].span == (int(lohi[..., 0].min()), int(lohi[..., 1].max()))
    with pytest.raises(TypeError):
        srw_kernels.Windows(plan.win_v[0].lohi, 1, 1, 1)  # no span


@pytest.mark.parametrize("kind", ["srw", "regrid"])
def test_step_takes_bands_already_placed(kind):
    """A step given a Sharded of the padded source's bands (already on
    their devices) returns what it returns for the global tensor; bands of
    another count, height or device are refused."""
    _, (psrc, ptgt) = _gms("ragged")
    make = ppar.make_sharded_srw_step if kind == "srw" else ppar.make_sharded_regrid_step
    step, (pad, _) = make(_port_mesh(4), psrc, ptgt, src_batch_dims=1)
    src = torch.nn.functional.pad(torch.from_numpy(_data("ragged", 2)), (0, 0, 0, pad),
                                  value=float("nan"))
    band_h = src.shape[-2] // 4
    placed = ppar.Sharded([src[:, k * band_h : (k + 1) * band_h] for k in range(4)],
                          src.shape[-2])
    ref = step(src)
    got = step(placed)
    for a, b in zip(got.bands, ref.bands):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="bands for 4 devices"):
        step(ppar.Sharded(placed.bands[:3], src.shape[-2]))
    with pytest.raises(ValueError, match="rows"):
        step(ppar.Sharded([b[:, 1:] for b in placed.bands], src.shape[-2]))
    with pytest.raises(ValueError, match="lies on"):
        step(ppar.Sharded([b.to("meta") for b in placed.bands], src.shape[-2]))


def test_make_mesh():
    """make_mesh: axis sizes as JAX's Mesh.shape, repeated devices, and no
    default mesh without a CUDA device."""
    mesh = ppar.make_mesh(("bands",), devices=[CPU] * 3)
    assert mesh.shape["bands"] == 3 and mesh.devices == (CPU,) * 3
    mesh2 = ppar.make_mesh(("x", "bands"), shape=(1, 4), devices=[CPU] * 4)
    assert mesh2.shape == {"x": 1, "bands": 4}
    with pytest.raises(ValueError):
        ppar.make_mesh(("bands",), shape=(3,), devices=[CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ppar.make_mesh()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_tile_batch_roundtrip_matches_jax(as_tensor):
    """batch_tiles and untile on numpy arrays and tensors equal JAX's
    numpy tiles, padding included; shard_tile_axis places the blocks."""
    arr = np.arange(2 * 13 * 17, dtype=np.float32).reshape(2, 13, 17)
    ref = jpar.batch_tiles(arr, 5, 8, fill=-1)
    tb = ppar.batch_tiles(torch.from_numpy(arr) if as_tensor else arr, 5, 8, fill=-1)
    assert (tb.grid, tb.tile_shape, tb.out_shape) == (ref.grid, ref.tile_shape, ref.out_shape)
    np.testing.assert_array_equal(np.asarray(tb.tiles), ref.tiles)
    np.testing.assert_array_equal(np.asarray(ppar.untile(tb)), arr)
    from xcube_resampling_tpu_torch.parallel.tiling import shard_tile_axis

    parts = shard_tile_axis(tb.tiles, _port_mesh(3), "bands")
    assert [len(p) for p in parts] == [3, 3, 3]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), ref.tiles)


def test_sharded_rejects_other_dtypes():
    _, (psrc, ptgt) = _gms("utm")
    with pytest.raises(TypeError, match="float32"):
        ppar.sharded_reproject(torch.zeros(96, 96, dtype=torch.float64), psrc, ptgt,
                               _port_mesh(2))
