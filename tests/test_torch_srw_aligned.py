"""The port's SRW dispatch and its aligned SRW (K14, K15) against the JAX
package, on the CPU.

The port's ``make_srw_reproject_fn`` picks among the tiled, batched and
aligned SRW by the JAX package's cost model (``srw.py:1630-1685``; the
hybrid stays behind ``XRTPU_FAST_EXTREME_WARP=1``).  The batched choice
runs K1 + K2, which compute ``make_srw_fn_batched``'s function; the
aligned one runs K14 + K15.  The port's kernels run their plain versions
on CPU tensors; inputs come from a numpy seed, float32 pinned, and every
comparison is bit for bit, NaN masks included, unless a test states
otherwise.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as jax_entry  # noqa: E402
import xcube_resampling_tpu as xrt  # noqa: E402
import xcube_resampling_tpu_torch as port  # noqa: E402
from xcube_resampling_tpu.ops import srw as jax_srw  # noqa: E402
from xcube_resampling_tpu_torch import entry as port_entry  # noqa: E402
from xcube_resampling_tpu_torch import reproject as port_reproject  # noqa: E402
from xcube_resampling_tpu_torch._device import LAUNCHES  # noqa: E402
from xcube_resampling_tpu_torch.crs import Transformer  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as port_srw  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw_aligned  # noqa: E402

METHODS = ["bilinear", "nearest", "triangular"]
JAX_MAKERS = ("make_srw_fn", "make_srw_fn_batched", "make_srw_aligned_fn")


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    yield
    port_reproject._DEVICE_FN_CACHE.clear()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions on one thread: the suite runs files side by side
    in several processes, and these megapixel cases would otherwise take
    every core from the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy_jax(monkeypatch, stub=False):
    """Record which of JAX's SRW constructors its dispatch calls; with *stub*
    they build nothing."""
    picked = []
    for name in JAX_MAKERS:
        orig = getattr(jax_srw, name)

        def spy(*args, _orig=orig, _name=name, **kwargs):
            picked.append(_name)
            return _name if stub else _orig(*args, **kwargs)

        monkeypatch.setattr(jax_srw, name, spy)
    return picked


def _flagships(size):
    return jax_entry._flagship_gms(size, size), port_entry.flagship_gms(size, size)


def _inputs(size, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((size, size), dtype=np.float32)
    b = rng.random((2, size, size), dtype=np.float32)
    b[1, size // 3] = np.nan
    return a, b


def _assert_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got, ref)


def _expected_kind(interp):
    # JAX plans no aligned SRW for triangular (srw.py:1631-1637)
    return "tiled" if interp == "triangular" else "aligned"


@pytest.mark.parametrize("size", [512, 1024])
@pytest.mark.parametrize("interp", METHODS)
def test_default_dispatch_matches_jax_on_the_flagship(monkeypatch, size, interp):
    """F1: both packages' default SRW dispatch on the flagship geometry
    (UTM32N 100 m onto EPSG:3035 110 m, ``entry.flagship_gms``): JAX takes
    its aligned SRW for bilinear and nearest and its tiled one for
    triangular, the port the same variant, and the outputs are equal bit
    for bit on 1 and 2 bands with a NaN row."""
    (js, jt), (ps, pt) = _flagships(size)
    picked = _spy_jax(monkeypatch)
    jfn = jax_srw.make_srw_reproject_fn(js, jt, interp, np.nan)
    pfn = port_srw.make_srw_reproject_fn(ps, pt, interp, np.nan, device="cpu")
    kind = _expected_kind(interp)
    assert picked == [{"aligned": "make_srw_aligned_fn", "tiled": "make_srw_fn"}[kind]]
    assert pfn.kind == kind and pfn.window is None
    assert isinstance(pfn, port_srw.AlignedSRWFn if kind == "aligned" else port_srw.SRWFn)
    LAUNCHES.clear()
    for data in _inputs(size):
        _assert_equal(pfn(torch.from_numpy(data)).numpy(), jfn(jnp.asarray(data)))
    assert not LAUNCHES  # CPU tensors: the plain versions


def _dataset(pkg, gm, **variables):
    coords = dict(gm.to_coords(exclude_bounds=True))
    coords["spatial_ref"] = pkg.DataArray(np.array(0), dims=(), attrs=gm.crs.to_cf())
    x_dim, y_dim = gm.xy_dim_names
    return pkg.Dataset(
        {
            name: pkg.DataArray(
                data,
                dims=(y_dim, x_dim) if data.ndim == 2 else ("band", y_dim, x_dim),
                attrs=dict(grid_mapping="spatial_ref"),
            )
            for name, data in variables.items()
        },
        coords=coords,
    )


@pytest.mark.parametrize("agg", ["max", None], ids=["max", "mean"])
@pytest.mark.parametrize("interp", METHODS)
def test_resample_in_space_flagship_takes_jax_variant(monkeypatch, agg, interp):
    """F1 end to end: ``resample_in_space`` on the flagship in both
    packages.  Its 110 m target is coarser than the 100 m source (scale
    0.91, under SCALE_LIMIT), so both pre-downscale the source (2 x 2
    windows of a bilinear gather; a nearest gather for nearest) and then
    reproject the coarse image, both through the aligned
    SRW (bilinear, nearest; JAX's spy and the port's ``kind``) or the
    tiled one (triangular).  With ``agg_methods="max"`` the pre-downscale
    is exact in both, and the outputs are equal bit for bit; with the
    default ``mean`` the pre-downscale's float32 statistics differ within
    rtol 1e-6 (``tests/test_torch_affine.py``'s class), nearest equal.
    512^2: the previous test holds the SRW itself at 1024^2 too."""
    (js, jt), (ps, pt) = _flagships(512)
    a, b = _inputs(512)
    picked = _spy_jax(monkeypatch)
    kwargs = {} if agg is None else dict(agg_methods=agg)
    ref = xrt.resample_in_space(_dataset(xrt, js, a=jnp.asarray(a), b=jnp.asarray(b)),
                                target_gm=jt, interp_methods=interp, **kwargs)
    got = port.resample_in_space(_dataset(port, ps, a=torch.from_numpy(a), b=torch.from_numpy(b)),
                                 target_gm=pt, interp_methods=interp, device="cpu", **kwargs)
    kind = _expected_kind(interp)
    assert set(picked) == {{"aligned": "make_srw_aligned_fn", "tiled": "make_srw_fn"}[kind]}
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    assert fn.kind == kind
    for name in ("a", "b"):
        g, r = got[name].data.numpy(), np.asarray(ref[name].data)
        if agg is None and interp != "nearest":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=0, equal_nan=True)
        else:
            _assert_equal(g, r)
        assert np.isfinite(r).mean() > 0.5


def _utm30_4096():
    """A 4096^2 UTM32N 30 m source and an EPSG:3035 30 m target of 4096^2
    centred on it (numpy plans only)."""
    def gms(pkg, transformer):
        src = pkg.GridMapping.regular(
            size=(4096, 4096), xy_min=(500000.0, 5880000.0), xy_res=30.0, crs="epsg:32632"
        )
        cx, cy = 500000.0 + 4096 * 15.0, 5880000.0 + 4096 * 15.0
        tcx, tcy = transformer.from_crs(src.crs, "epsg:3035").transform(cx, cy)
        tgt = pkg.GridMapping.regular(
            size=(4096, 4096), xy_min=(tcx - 4096 * 15.0, tcy - 4096 * 15.0), xy_res=30.0,
            crs="epsg:3035",
        )
        return src, tgt

    return gms(xrt, xrt.crs.Transformer), gms(port, Transformer)


def _geo_utm_4096():
    """chip_smoke.py's EPSG:4326 0.05 deg -> UTM32N 4096^2 at 150 m."""
    def gms(pkg):
        return (
            pkg.GridMapping.regular(size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05,
                                    crs="epsg:4326"),
            pkg.GridMapping.regular(size=(4096, 4096), xy_min=(250000.0, 5200000.0),
                                    xy_res=150.0, crs="epsg:32632"),
        )

    return gms(xrt), gms(port)


# geometry -> (its grid mappings in both packages, JAX's pick): aligned
# for the flagship up to 2048^2, a cost tie at 3072^2 that goes to the
# tiled plan and then, past 128 tap operations, to the batched one; the
# batched one at 30 m; the tiled one for 4326 -> UTM (48 tap operations)
DISPATCH = {
    "flagship-512": (lambda: _flagships(512), "aligned"),
    "flagship-2048": (lambda: _flagships(2048), "aligned"),
    "flagship-3072": (lambda: _flagships(3072), "batched"),
    "utm30-4096": (_utm30_4096, "batched"),
    "geo-utm-4096": (_geo_utm_4096, "tiled"),
}


@pytest.mark.parametrize("geometry", sorted(DISPATCH))
def test_dispatch_picks_jax_variant(monkeypatch, geometry):
    """With every SRW constructor stubbed (nothing compiles, nothing lands on a
    device), the port's dispatch names the variant JAX's cost model picks
    on each geometry, the 3072^2 flagship's tie included."""
    make, expect = DISPATCH[geometry]
    (js, jt), (ps, pt) = make()
    picked = _spy_jax(monkeypatch, stub=True)
    monkeypatch.setattr(port_srw, "make_srw_fn",
                        lambda *a, **k: SimpleNamespace(kind="tiled", window=None))
    monkeypatch.setattr(port_srw, "make_srw_aligned_fn",
                        lambda *a, **k: SimpleNamespace(kind="aligned", window=None))
    assert jax_srw.make_srw_reproject_fn(js, jt, "bilinear", np.nan) is not None
    fn = port_srw.make_srw_reproject_fn(ps, pt, "bilinear", np.nan, device="cpu")
    names = {"tiled": "make_srw_fn", "batched": "make_srw_fn_batched",
             "aligned": "make_srw_aligned_fn"}
    assert picked == [names[expect]]
    assert fn.kind == expect


# tests/test_srw.py's 96^2 UTM32N source and an 80^2 EPSG:3035 target
UTM_LAEA = (
    dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"),
    dict(size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035"),
)


@pytest.mark.parametrize("interp", METHODS)
def test_batched_choice_runs_k1_k2_equal_to_jax_batched(monkeypatch, interp):
    """Tiles of 4 columns and 4 rows (``plan_srw``'s keywords, passed
    through by both dispatches) make the tiled plan's loops 176 tap
    operations or more, so JAX builds ``make_srw_fn_batched``: the port's
    dispatch returns K1 + K2 with ``kind == "batched"``, equal to JAX's
    batched output bit for bit."""
    js, jt = (xrt.GridMapping.regular(**g) for g in UTM_LAEA)
    ps, pt = (port.GridMapping.regular(**g) for g in UTM_LAEA)
    picked = _spy_jax(monkeypatch)
    jfn = jax_srw.make_srw_reproject_fn(js, jt, interp, np.nan, col_tile=4, row_tile=4)
    pfn = port_srw.make_srw_reproject_fn(ps, pt, interp, np.nan, device="cpu", col_tile=4,
                                         row_tile=4)
    assert picked == ["make_srw_fn_batched"]
    assert isinstance(pfn, port_srw.SRWFn) and pfn.kind == "batched"
    assert pfn.state.col_tile == 4 and pfn.state.row_tile == 4
    for data in _inputs(96):
        _assert_equal(pfn(torch.from_numpy(data)).numpy(), jfn(jnp.asarray(data)))


# a 112^2 EPSG:3035 target at 100 m centred on UTM_LAEA's source and
# larger than it: the aligned plan's taps reach past all four source edges
# (r_lo, r_hi, c_lo, c_hi of srw.py:1079-1082 nonzero)
EDGE_TARGET = dict(size=(112, 112), xy_min=(4318960, 3377708), xy_res=100, crs="epsg:3035")


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("fill", [np.nan, -9.5])
def test_aligned_plain_versions_match_jax_past_every_edge(interp, fill):
    """K14's and K15's plain versions (``make_srw_aligned_fn`` on the CPU)
    against JAX's ``make_srw_aligned_fn`` on the same plan, its taps past
    every source edge, on data with NaN and +-inf rows and columns: equal
    bit for bit, NaN masks included."""
    src = UTM_LAEA[0]
    jplan = jax_srw.plan_srw_aligned(xrt.GridMapping.regular(**src),
                                     xrt.GridMapping.regular(**EDGE_TARGET), max_taps=24)
    plan = port_srw.plan_srw_aligned(port.GridMapping.regular(**src),
                                     port.GridMapping.regular(**EDGE_TARGET), max_taps=24)
    assert min(plan.base_v) < 0 and max(plan.base_v) + plan.d_v > plan.src_h
    assert min(plan.base_h) < 0 and max(plan.base_h) + plan.d_h > plan.src_w
    rng = np.random.default_rng(3)
    data = rng.random((3, 96, 96), dtype=np.float32)
    data[0, 0], data[0, :, -1] = np.nan, np.inf
    data[1, -1], data[1, :, 0] = -np.inf, np.nan
    data[2, 50] = np.nan
    ref = np.asarray(jax_srw.make_srw_aligned_fn(jplan, interp, fill)(jnp.asarray(data)))
    fn = port_srw.make_srw_aligned_fn(plan, interp, fill, device="cpu")
    got = fn(torch.from_numpy(data))
    _assert_equal(got.numpy(), ref)
    _assert_equal(fn.plain(torch.from_numpy(data)).numpy(), ref)
    assert np.isfinite(ref[2]).mean() > 0.5
    if fill == -9.5:
        assert (ref == np.float32(-9.5)).any()


def test_aligned_takes_bilinear_and_nearest_only():
    """As JAX's ``make_srw_aligned_fn`` (:1056-1057), the port's raises for
    triangular, and so do K14's and K15's wrappers."""
    ps, pt = port_entry.flagship_gms(512, 512)
    plan = port_srw.plan_srw_aligned(ps, pt, max_taps=24)
    with pytest.raises(ValueError):
        port_srw.make_srw_aligned_fn(plan, "triangular", np.nan, device="cpu")
    fn = port_srw.make_srw_aligned_fn(plan, "bilinear", np.nan, device="cpu")
    src = torch.zeros((1, plan.src_h, plan.src_w))
    args = list(fn.vertical_args(src))
    args[-1] = "triangular"
    with pytest.raises(ValueError):
        srw_aligned.srw_aligned_vertical(*args)


def test_fma_exact_rounds_once():
    """``fma_exact`` rounds ``a * b + c`` once: on sums that rounding to
    float64 first would round twice (``a * b = 2^-24 - 2^-60`` below ``c
    = 1 + k 2^-23``, k odd: the float64 sum is the float32 midpoint, which
    ties to even upwards, while the exact sum lies below it) and on random
    ones, each against the exact rational's nearest float32 (ties to
    even)."""
    from fractions import Fraction

    rng = np.random.default_rng(7)
    n = 1000
    k = 2 * rng.integers(0, 2**21, n) + 1
    a = np.concatenate([np.full(n, 1 - 2.0**-18), rng.random(n)]).astype(np.float32)
    b = np.concatenate([np.full(n, 2.0**-24 * (1 + 2.0**-18)),
                        rng.random(n) * 2.0**-20]).astype(np.float32)
    c = np.concatenate([1 + k * 2.0**-23, 1 + rng.random(n)]).astype(np.float32)
    got = srw_aligned.fma_exact(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive[:n] != got[:n]).all()  # the float64 detour rounds these wrong
    for i in range(2 * n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        x = np.float32(float(exact))
        near = [x, np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))]
        best = min(near, key=lambda y: (abs(Fraction(float(y)) - exact),
                                        int(np.float32(y).view(np.int32)) & 1))
        assert got[i] == best, i


def test_aligned_entry_points_default_to_the_card(monkeypatch):
    """``make_srw_aligned_fn`` places its plan on the card unless asked
    otherwise, as ``make_srw_fn`` does; K14 and K15 refuse planes of 2^31
    elements or more before the kernel library is loaded."""
    import inspect

    from xcube_resampling_tpu_torch import _build

    for fn in (port_srw.make_srw_aligned_fn, port_srw.make_srw_reproject_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(srw_aligned, "on_cpu", lambda *tensors: False)

    def no_launch():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", no_launch)
    field = torch.zeros((2, 2))
    big = torch.zeros((1, 1, 1)).expand((1, 2**16, 2**15))
    with pytest.raises(ValueError, match="fewer than 2\\^31 elements"):
        srw_aligned.srw_aligned_vertical(big, field, 16, torch.zeros(2**15, dtype=torch.int32),
                                         torch.zeros(8, dtype=torch.int32), 4, "bilinear")
    with pytest.raises(ValueError, match="fewer than 2\\^31 elements"):
        srw_aligned.srw_aligned_horizontal(big, field, field, 16,
                                           torch.zeros(2**16, dtype=torch.int32),
                                           torch.zeros(8, dtype=torch.int32), 4, 8,
                                           "bilinear", np.nan)
