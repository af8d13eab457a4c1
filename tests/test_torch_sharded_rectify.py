"""The port's sharded rectify and hybrid Phase A against the JAX package's,
on the CPU.

JAX shards over its virtual 8-device CPU mesh (``tests/conftest.py``), the
port over a mesh of CPU devices (``make_mesh(devices=[cpu] * n)``), on the
same numpy inputs from seeds; the port's kernels run their plain versions
on CPU tensors: K7's band form (``ij_gather_band``), K11 (``hybrid_seed``)
and K12 (``hybrid_dense``).  Expected, and asserted:

* Phase B: the sharded raster equals JAX's bit for bit for every method
  (the lerps round as XLA contracts them in both packages), and K7's band
  form equals K7's map form on the whole source bit for bit;
* Phase A: K11's meta and corner quads equal JAX's seed kernel; the hybrid
  map equals JAX's float64 hybrid bit for bit (its triangle formulas carry
  XLA's fused multiply-adds, emulated in float64) and the host kernel's
  within rtol = atol = 1e-9 with identical NaN coverage;
* the sharded Phase A equals JAX's and the port's single-chip hybrid bit
  for bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu import parallel as jpar  # noqa: E402
from xcube_resampling_tpu.constants import UV_DELTA  # noqa: E402
from xcube_resampling_tpu.ops import rectify_ops as jro  # noqa: E402
from xcube_resampling_tpu.rectify import _compute_target_source_ij  # noqa: E402
from xcube_resampling_tpu_torch import entry as pentry  # noqa: E402
from xcube_resampling_tpu_torch import parallel as ppar  # noqa: E402
from xcube_resampling_tpu_torch.ops import rectify_ops as pro  # noqa: E402

from tests.sampledata import create_olci_like_swath  # noqa: E402

METHODS = ("nearest", "bilinear", "triangular")
CPU = torch.device("cpu")


def _rand_swath(rng):
    """A smooth, fold-free random swath (``tests/test_fuzz_walk.py``)."""
    h = int(rng.integers(40, 160))
    w = int(rng.integers(40, 160))
    jj, ii = np.meshgrid(
        np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij"
    )
    ang = rng.uniform(0, 2 * np.pi)
    sx = rng.uniform(0.5, 2.0)
    sy = rng.uniform(0.5, 2.0)
    shear = rng.uniform(-0.4, 0.4)
    ca, sa = np.cos(ang), np.sin(ang)
    x = sx * (ii + shear * jj)
    y = sy * jj
    lon = ca * x - sa * y
    lat = sa * x + ca * y
    lon = lon + rng.uniform(-1, 1) * 3e-3 * (jj - h / 2) ** 2 / h
    lat = lat + rng.uniform(-1, 1) * 3e-3 * (ii - w / 2) ** 2 / w
    lon = lon + 0.02 * rng.standard_normal((h, w))
    lat = lat + 0.02 * rng.standard_normal((h, w))
    return lon, lat


def _fuzz_cases(n):
    """*n* random swaths with their hybrid arguments (as
    ``test_fuzz_walk.test_fuzz_hybrid_parity`` draws them)."""
    rng = np.random.default_rng(20260818)
    for _ in range(n):
        src_x, src_y = _rand_swath(rng)
        x0 = float(np.nanmin(src_x)) + rng.uniform(-5, 20)
        y1 = float(np.nanmax(src_y)) - rng.uniform(-5, 20)
        res = rng.uniform(0.4, 2.5)
        dst_w = int(rng.integers(30, 160))
        dst_h = int(rng.integers(30, 160))
        yield src_x, src_y, (0, 0, (dst_h, dst_w), x0, y1, res, -res, UV_DELTA)


def _gate_swath(h=16, w=17):
    """The small clean swath of ``tests/test_ops_parity.py:_swath``."""
    jj, ii = np.mgrid[0:h, 0:w].astype(np.float64)
    return ii + 0.1 * jj, 50.0 - jj + 0.05 * ii


def _swath_case(width=96, height=120, n_bands=3):
    """``tests/test_parallel.py:_swath_case``: the OLCI-like swath onto its
    default grid, the JAX host map, float32 bands from a seed; the port's
    grid mappings of the same swath."""
    ds = create_olci_like_swath(width=width, height=height, tile_size=48)
    source_gm = jx.GridMapping.from_dataset(ds)
    target_gm = source_gm.to_regular(tile_size=48)
    ij_map = _compute_target_source_ij(source_gm, target_gm, UV_DELTA)
    if hasattr(ij_map, "as_numpy"):
        ij_map = ij_map.as_numpy()
    bands = np.random.default_rng(7).random((n_bands, height, width), dtype=np.float32)
    pds = pentry.create_olci_like_swath(width=width, height=height, tile_size=48)
    psource = pt.GridMapping.from_dataset(pds)
    return (source_gm, target_gm), (psource, psource.to_regular(tile_size=48)), \
        np.asarray(ij_map), bands


_CASE = {}


def _case():
    if not _CASE:
        _CASE["v"] = _swath_case()
    return _CASE["v"]


def _jax_mesh(n):
    return jpar.make_mesh(("bands",), devices=jax.devices()[:n])


def _port_mesh(n):
    return ppar.make_mesh(devices=[CPU] * n)


def _port_rectify(n, bands, method, ij_map=None):
    _, (psrc, ptgt), _, _ = _case()
    out = ppar.sharded_rectify(torch.from_numpy(bands), psrc, ptgt, _port_mesh(n),
                               interp_method=method, ij_map=ij_map)
    assert len(out.bands) == n and all(b.device == CPU for b in out.bands)
    return out.full().numpy()


def _norm(sx, sy, args):
    _, _, _, x_off, y_off, x_scale, y_scale, _ = args
    return (sx - x_off) / x_scale, (sy - y_off) / y_scale


# ---------------------------------------------------------------------------
# the package's names
# ---------------------------------------------------------------------------


def test_top_level_names_cover_jax():
    """The port exports every top-level name of the JAX package
    (Transformer, CRS_CRS84, CRS_WGS84, version, ...), and ``__version__``."""
    assert set(jx.__all__) <= set(pt.__all__)
    from xcube_resampling_tpu_torch import CRS_CRS84, CRS_WGS84, Transformer, version

    assert version == jx.version == pt.__version__
    assert CRS_CRS84 == pt.crs.CRS_CRS84 and CRS_WGS84 == pt.crs.CRS_WGS84
    assert Transformer is pt.crs.Transformer


def test_parallel_names_cover_jax():
    assert set(jpar.__all__) <= set(ppar.__all__)
    assert ppar.make_sharded_esw_step is ppar.halo.make_sharded_esw_step


# ---------------------------------------------------------------------------
# Phase B: K7's band form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("method", METHODS)
def test_band_form_equals_the_map_form(method, n):
    """K7's band form (plain) on every band equals K7's map form (plain)
    on the whole source, bit for bit: band 0 from a negative offset, a
    ragged last band (120 rows over 8), NaN map cells."""
    _, (psrc, _), ij_map, bands = _case()
    m = torch.from_numpy(ij_map).float()
    src = torch.from_numpy(bands)
    step, (pad, out_h) = ppar.make_sharded_rectify_step(
        _port_mesh(n), ij_map, (psrc.height, psrc.width), interp_method=method,
        src_batch_dims=1)
    padded = torch.nn.functional.pad(src, (0, 0, 0, pad), value=float("nan"))
    sharded = step(padded)
    assert step.use_halo and sharded.out_h == out_h
    valid = torch.isfinite(m[0]) & torch.isfinite(m[1])
    assert 0.3 < valid.float().mean() < 1.0
    ref = pro.ij_gather_plain(src, torch.nan_to_num(m[0], nan=0.0),
                              torch.nan_to_num(m[1], nan=0.0), valid, method, np.nan)
    np.testing.assert_array_equal(sharded.full().numpy(), ref.numpy())
    # the wrapper runs the plain version on CPU tensors
    bands_k, _ = step.bands(padded)
    halos = step.exchange(bands_k)
    args = step.gather_args(bands_k, halos, 0)
    assert args[4] < 0
    torch.testing.assert_close(pro.ij_gather_band(*args), pro.ij_gather_band_plain(*args),
                               rtol=0, atol=0, equal_nan=True)


_JAX_RECTIFY = {}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("method", METHODS)
def test_sharded_rectify_matches_jax(method, n):
    """sharded_rectify with the same host map equals JAX's bit for bit
    for every method (JAX's own test allows 1e-6 against its single-chip
    gather; the two sharded steps round alike)."""
    (jsrc, jtgt), _, ij_map, bands = _case()
    ref = np.asarray(jpar.sharded_rectify(jnp.asarray(bands), jsrc, jtgt, _jax_mesh(n),
                                          interp_method=method, ij_map=ij_map))
    got = _port_rectify(n, bands, method, ij_map)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(ref).mean() > 0.3


def test_sharded_rectify_mesh_size_invariance():
    """n = 2 and n = 8 give the same raster."""
    _, _, ij_map, bands = _case()
    np.testing.assert_array_equal(_port_rectify(2, bands, "bilinear", ij_map),
                                  _port_rectify(8, bands, "bilinear", ij_map))


def test_sharded_rectify_map_forms():
    """A numpy map, a tensor, a DeviceIJMap and a Sharded map (bands of
    another height than the step's) give the same raster."""
    _, _, ij_map, bands = _case()
    t = torch.from_numpy(ij_map)
    forms = [t, pro.DeviceIJMap(t),
             ppar.Sharded([t[:, k : k + 32] for k in range(0, t.shape[1], 32)], t.shape[1])]
    ref = _port_rectify(4, bands, "triangular", ij_map)
    for form in forms:
        np.testing.assert_array_equal(_port_rectify(4, bands, "triangular", form), ref)


# ---------------------------------------------------------------------------
# Phase A: K11, K12 and the hybrid
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_seed_kernel(src_shape, dst, tile, margin=2):
    return jro._build_hybrid_seed_kernel(src_shape, dst, jnp.float64, tile, 24, 6,
                                         float(max(dst)), margin)


def _jax_seed(gx, gy, dst, tile, r0=0.0):
    return [np.asarray(a) for a in _jax_seed_kernel(gx.shape, dst, tile)(gx, gy - r0)]


@pytest.mark.parametrize("r0", [0.0, 64.0])
def test_seed_matches_jax(r0):
    """K11 (plain) gives JAX's seed kernel's meta and corner quads for the
    same band origin r0: the OLCI-like swath, the 16 x 17 gate swath and
    random swaths, tiles 16 and 4."""
    (jsrc, jtgt), _, _, _ = _case()
    swath = np.asarray(jsrc.xy_coords.data, dtype=np.float64)
    x1, _, _, y2 = jtgt.xy_bbox
    args = (0, 0, (jtgt.height, jtgt.width), x1, y2, jtgt.x_res, -jtgt.y_res, UV_DELTA)
    gsx, gsy = _gate_swath()
    cases = [(swath[0], swath[1], args), (gsx, gsy, (0, 0, (40, 44), -3.0, 57.0, 0.5, -0.5,
                                                    UV_DELTA))]
    cases += list(_fuzz_cases(2))
    for sx, sy, a in cases:
        gx, gy = _norm(sx, sy, a)
        for tile in (16, 4):
            ref = _jax_seed(gx, gy, a[2], tile, r0)
            got = pro.hybrid_seed(torch.from_numpy(gx), torch.from_numpy(gy), a[2], tile,
                                  float(max(a[2])), 2, r0=r0)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("shape", [(37, 53), (2, 41), (41, 2), (3, 3)])
@pytest.mark.parametrize("r0", [0.0, 24.0])
def test_seed_matches_jax_on_odd_and_thin_swaths(shape, r0):
    """K11 (plain) gives JAX's seed kernel's meta and corner quads on a
    swath of odd width and height, on 2 x N and N x 2 swaths (one quad row
    or column) and on a 3 x 3 one, rotated and sheared, at tiles 16, 8 and
    4 onto a target that reaches past the swath."""
    h, w = shape
    jj, ii = np.mgrid[0:h, 0:w].astype(np.float64)
    gx = 3.0 + 1.1 * ii * np.cos(0.3) - 0.9 * jj * np.sin(0.3)
    gy = 2.0 + 1.1 * ii * np.sin(0.3) + 0.9 * jj * np.cos(0.3) + 0.02 * ii * jj
    dst = (max(2 * h, 24), max(2 * w, 20))
    for tile in (16, 8, 4):
        ref = _jax_seed(gx, gy, dst, tile, r0)
        got = pro.hybrid_seed(torch.from_numpy(gx), torch.from_numpy(gy), dst, tile,
                              float(max(dst)), 2, r0=r0)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r)


def test_gate_refuses_folded_and_nan_swaths():
    """Both packages' hybrids refuse a folded and a NaN swath, and serve
    the clean one (``tests/test_ops_parity.py:154-168``)."""
    src_x, src_y = _gate_swath()
    args = (0, 0, (40, 44), -3.0, 57.0, 0.5, -0.5, UV_DELTA)
    folded_x = src_x.copy()
    folded_x[8, 8] = src_x[8, 8] - 18.0
    nan_x = src_x.copy()
    nan_x[2, 2] = np.nan
    for sx, served in ((src_x, True), (folded_x, False), (nan_x, False)):
        j = jro.inverse_ij_map_hybrid(sx, src_y, *args)
        p = pro.inverse_ij_map_hybrid(sx, src_y, *args, device="cpu")
        assert (j is not None) == (p is not None) == served


def _hybrid_pair(sx, sy, args):
    jro._HYBRID_LAST_WIN.clear()
    pro._HYBRID_LAST_WIN.clear()
    j = jro.inverse_ij_map_hybrid(sx, sy, *args)
    p = pro.inverse_ij_map_hybrid(sx, sy, *args, device="cpu")
    assert (j is None) == (p is None)
    if j is None:
        return None
    assert list(jro._HYBRID_LAST_WIN.values()) == list(pro._HYBRID_LAST_WIN.values())
    return j.as_numpy(), p.as_numpy()


def test_hybrid_matches_jax_and_the_host_kernel():
    """inverse_ij_map_hybrid equals JAX's (float64) bit for bit with the
    same (tile, win_j, win_i), and the host kernel within rtol = atol =
    1e-9 with identical NaN coverage: the OLCI-like swath and random
    swaths (some through the tile cascade)."""
    ds = create_olci_like_swath(width=233, height=307, tile_size=128)
    gm = jx.GridMapping.from_dataset(ds)
    tgm = gm.to_regular(tile_size=128)
    xy = np.asarray(gm.xy_coords.data, dtype=np.float64)
    x1, _, _, y2 = tgm.xy_bbox
    cases = [(xy[0], xy[1], (0, 0, (tgm.height, tgm.width), x1, y2, tgm.x_res, -tgm.y_res,
                             UV_DELTA))]
    cases += list(_fuzz_cases(6))
    engaged = 0
    for sx, sy, args in cases:
        pair = _hybrid_pair(sx, sy, args)
        if pair is None:
            continue
        engaged += 1
        jm, pm = pair
        np.testing.assert_array_equal(pm, jm)
        host = jro.inverse_ij_map(sx, sy, *args)
        assert np.array_equal(np.isnan(pm), np.isnan(host))
        np.testing.assert_allclose(pm, host, rtol=1e-9, atol=1e-9, equal_nan=True)
    assert engaged >= 4


def test_hybrid_optimistic_window_reuse():
    """A repeated geometry reuses the last window; a same-shaped coarser
    one whose need exceeds it falls back to the right size
    (``tests/test_ops_parity.py:179-205``); both equal the host kernel
    within 1e-9, and the port's map equals JAX's."""
    jj, ii = np.mgrid[0:40, 0:44].astype(np.float64)
    src_x, src_y = ii + 0.1 * jj, 50.0 - jj + 0.05 * ii
    pro._HYBRID_LAST_WIN.clear()
    jro._HYBRID_LAST_WIN.clear()
    fine = (0, 0, (64, 64), -3.0, 57.0, 0.35, -0.35, UV_DELTA)
    coarse = (0, 0, (64, 64), -3.0, 57.0, 1.2, -1.2, UV_DELTA)
    wins = []
    for args in (fine, fine, coarse):
        p = pro.inverse_ij_map_hybrid(src_x, src_y, *args, device="cpu")
        j = jro.inverse_ij_map_hybrid(src_x, src_y, *args)
        assert p is not None and j is not None
        np.testing.assert_array_equal(p.as_numpy(), j.as_numpy())
        np.testing.assert_allclose(p.as_numpy(), jro.inverse_ij_map(src_x, src_y, *args),
                                   rtol=1e-9, atol=1e-9, equal_nan=True)
        wins.append(list(pro._HYBRID_LAST_WIN.values()))
        assert wins[-1] == list(jro._HYBRID_LAST_WIN.values())
    assert wins[0] == wins[1] != wins[2]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_phase_a_matches_jax(n):
    """sharded_phase_a: per band K11's meta equals JAX's seed kernel at
    the band's r0; the map equals JAX's sharded_phase_a and the port's
    single-chip hybrid bit for bit."""
    (jsrc, jtgt), (psrc, ptgt), _, _ = _case()
    got = ppar.sharded_phase_a(_port_mesh(n), psrc, ptgt)
    ref = jpar.sharded_phase_a(_jax_mesh(n), jsrc, jtgt)
    assert got is not None and ref is not None and len(got.bands) == n
    band = got.bands[0].shape[1]
    assert band % 16 == 0 and band * n >= ptgt.height
    np.testing.assert_array_equal(got.full().numpy(), np.asarray(ref))
    x1, _, _, y2 = ptgt.xy_bbox
    swath = np.asarray(psrc.xy_coords.data, dtype=np.float64)
    args = (0, 0, (ptgt.height, ptgt.width), x1, y2, ptgt.x_res, -ptgt.y_res, UV_DELTA)
    single = pro.inverse_ij_map_hybrid(swath[0], swath[1], *args, device="cpu")
    np.testing.assert_array_equal(got.full().numpy(), single.as_numpy())
    gx, gy = _norm(swath[0], swath[1], args)
    for k in range(n):
        _, _, meta = pro.hybrid_seed_plain(torch.from_numpy(gx), torch.from_numpy(gy),
                                           (band, ptgt.width), 16, float(max(args[2])), 2,
                                           r0=float(k * band))
        np.testing.assert_array_equal(
            meta.numpy(), _jax_seed(gx, gy, (band, ptgt.width), 16, float(k * band))[2])


def test_sharded_rectify_without_a_map():
    """Without a map both packages run the sharded Phase A (the same
    tier): the port's raster equals JAX's bit for bit, and against the
    host-map raster the NaN masks and the values differ on fewer than
    1e-3 of the pixels (``tests/test_parallel.py:625-654``)."""
    (jsrc, jtgt), _, ij_map, bands = _case()
    ref = np.asarray(jpar.sharded_rectify(jnp.asarray(bands), jsrc, jtgt, _jax_mesh(4),
                                          interp_method="nearest"))
    auto = _port_rectify(4, bands, "nearest")
    np.testing.assert_array_equal(auto, ref)
    with_map = _port_rectify(4, bands, "nearest", ij_map)
    nan_a, nan_b = np.isnan(auto), np.isnan(with_map)
    assert (nan_a != nan_b).mean() < 1e-3
    both = ~nan_a & ~nan_b
    assert (auto[both] != with_map[both]).mean() < 1e-3


def test_sharded_rectify_falls_back_to_the_device_phase_a(monkeypatch):
    """Where the hybrid refuses the geometry, sharded_rectify takes the
    port's single-device Phase A (K8's map, the host tier on the CPU):
    the raster equals the one through that map."""
    _, (psrc, ptgt), _, bands = _case()
    monkeypatch.setattr("xcube_resampling_tpu_torch.parallel.halo.sharded_phase_a",
                        lambda *a, **k: None)
    from xcube_resampling_tpu_torch.rectify import _inverse_ij_map

    m = _inverse_ij_map(psrc, ptgt, UV_DELTA, CPU)
    np.testing.assert_array_equal(_port_rectify(2, bands, "bilinear"),
                                  _port_rectify(2, bands, "bilinear", m))


def test_dryrun_multichip_on_the_cpu():
    pentry.dryrun_multichip(2, devices=[CPU] * 2)
