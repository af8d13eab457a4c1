"""The reproject engine's tiers on the JAX package's thirteen data dtypes,
each tier's dtype rule held to the JAX package's on the CPU: the tiled
SRW (K1 + K2), the batched pick, the direct gather (K3), the tiers that
cast to float32 (the ESW, the aligned SRW), the exact region mosaic's
pieces and ``resample_in_space`` end to end.  Inputs and tolerance
classes: ``tests/dtype_cases.py``."""

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
from xcube_resampling_tpu_torch._device import from_numpy  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw as port_esw  # noqa: E402
from xcube_resampling_tpu_torch.ops import reproject_ops as port_reproject_ops  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as port_srw  # noqa: E402

from .dtype_cases import DTYPES, FLOATS, KINDS, as_float, data, gms, jax_fn, match  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    yield
    port_reproject._DEVICE_FN_CACHE.clear()


# -- the reproject engine's tiers -------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_srw_matches_jax(dtype):
    """The tiled SRW (K1 + K2's plain versions) against ``make_srw_fn`` on
    the same plan: bilinear for every dtype, every method for a dtype of
    each kind; integer, bool and half sources promote to float32, float64
    stays float64 (jnp's float32 weight times the value), bit for bit."""
    jplan = jax_srw.plan_srw(*gms(xrt))
    plan = port_srw.plan_srw(*gms(port))
    x = data(dtype, (2, 96, 96), nan="row")
    for interp in ("bilinear", "nearest", "triangular") if dtype in KINDS else ("bilinear",):
        jfn = jax_fn(("tiled", interp), lambda: jax_srw.make_srw_fn(jplan, interp, np.nan))
        ref = jfn(jnp.asarray(x))
        assert ref.dtype == (np.float64 if dtype == "float64" else np.float32)
        got = port_srw.make_srw_fn(plan, interp, np.nan, device="cpu")(from_numpy(x))
        match(got, ref)
        if dtype in FLOATS:
            assert np.isfinite(as_float(ref)).mean() > 0.3


@pytest.mark.parametrize("dtype", ["float64", "uint16"])
def test_batched_pick_matches_jax(monkeypatch, dtype):
    """Column and row tiles of 4 make both dispatches pick the batched SRW
    (``make_srw_fn_batched``), which casts the source to float32 first:
    float64 no longer stays float64 there.  The port's batched SRWFn equals
    JAX's output, dtype included."""
    picked = []
    orig = jax_srw.make_srw_fn_batched
    monkeypatch.setattr(jax_srw, "make_srw_fn_batched",
                        lambda *a, **k: picked.append(1) or orig(*a, **k))
    jfn = jax_srw.make_srw_reproject_fn(*gms(xrt), "bilinear", np.nan, col_tile=4, row_tile=4)
    fn = port_srw.make_srw_reproject_fn(*gms(port), "bilinear", np.nan, device="cpu",
                                        col_tile=4, row_tile=4)
    assert picked and fn.kind == "batched"
    x = data(dtype, (96, 96), nan="row")
    ref = jfn(jnp.asarray(x))
    assert ref.dtype == np.float32
    match(fn(from_numpy(x)), ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_direct_gather_matches_jax(dtype):
    """K3's plain version (``FusedReprojectFn.plain``) against
    ``make_fused_reproject_fn``: nearest keeps the dtype, bilinear and
    triangular lerp tap differences taken in the source dtype (integers
    wrap, half types round) in float32, float64 in float64; bool bilinear
    raises ``TypeError`` in both (jnp's boolean subtract).  Bilinear for
    every dtype, nearest (fill 0, which every dtype holds) for every
    dtype, triangular for a dtype of each kind."""
    x = data(dtype, (2, 96, 96))
    for interp in ("bilinear", "nearest", "triangular"):
        if interp == "triangular" and dtype not in KINDS:
            continue
        fill = 0 if interp == "nearest" else np.nan
        jfn = jax_fn(("k3", interp), lambda: jax_reproject_ops.make_fused_reproject_fn(
            *gms(xrt), interp, fill))
        fn = port_reproject_ops.make_fused_reproject_fn(*gms(port), interp, fill, device="cpu")
        if dtype == "bool" and interp != "nearest":
            with pytest.raises(TypeError):
                jfn(jnp.asarray(x))
            with pytest.raises(TypeError):
                fn(from_numpy(x))
            continue
        match(fn(from_numpy(x)), jfn(jnp.asarray(x)))


def test_direct_gather_fill_refusals_match_jax():
    """A NaN fill of an integer nearest gather raises ``ValueError`` in
    both packages, a fill outside the dtype's range ``OverflowError``
    (``jnp.asarray(fill, dtype)``)."""
    x = data("uint16", (96, 96))
    for fill, error in ((np.nan, ValueError), (-1, OverflowError)):
        jfn = jax_reproject_ops.make_fused_reproject_fn(*gms(xrt), "nearest", fill)
        fn = port_reproject_ops.make_fused_reproject_fn(*gms(port), "nearest", fill,
                                                        device="cpu")
        with pytest.raises(error):
            jfn(jnp.asarray(x))
        with pytest.raises(error):
            fn(from_numpy(x))


@pytest.mark.parametrize("dtype", ["uint16", "float64", "bool"])
def test_float32_tiers_match_jax(dtype):
    """The tiers that cast the source to float32, as JAX casts it: the ESW
    (``make_esw_reproject_fn``) and the aligned SRW
    (``make_srw_aligned_fn``), float32 out, bit for bit."""
    x = data(dtype, (2, 96, 96), nan="row")
    for interp in ("bilinear", "nearest"):
        jfn = jax_fn(("esw", interp), lambda: jax_esw.make_esw_reproject_fn(
            *gms(xrt), interp, np.nan))
        fn = port_esw.make_esw_reproject_fn(*gms(port), interp, np.nan, device="cpu")
        assert isinstance(fn, port_esw.ESWReprojectFn)
        match(fn(from_numpy(x)), jfn(jnp.asarray(x)))
    jplan = jax_srw.plan_srw_aligned(*gms(xrt), max_taps=24)
    plan = port_srw.plan_srw_aligned(*gms(port), max_taps=24)
    jfn = jax_fn("aligned", lambda: jax_srw.make_srw_aligned_fn(jplan, "bilinear", np.nan))
    fn = port_srw.make_srw_aligned_fn(plan, "bilinear", np.nan, device="cpu")
    match(fn(from_numpy(x)), jfn(jnp.asarray(x)))


def test_exact_mosaic_pieces_follow_jax_rules(monkeypatch):
    """The exact region mosaic of the reduced BASELINE #3 (``ESWMosaicFn``,
    K16's plain version) on an int16 source: its ESW pieces equal the
    float32 mosaic (JAX's ESW kernels cast), its gather pieces JAX's
    ``make_gather_piece_fn`` on the int16 window (its rule: tap
    differences in int16), float32 out.  Nearest, and float64, would put
    another dtype than float32 into JAX's canvas: ``TypeError``, as JAX's
    ``dynamic_update_slice``."""
    src = dict(size=(720, 360), xy_min=(-180.0, -90.0), xy_res=0.5, crs="epsg:4326")
    tgt = dict(size=(384, 384), xy_min=(2000000.0, 1000000.0), xy_res=16000.0,
               crs="epsg:3035")
    sg, tg = port.GridMapping.regular(**src), port.GridMapping.regular(**tgt)
    fn = port_srw.make_region_reproject_fn(sg, tg, "bilinear", np.nan, exact=True,
                                           device="cpu")
    assert fn.gathers
    x = data("int16", (360, 720))
    got = fn(from_numpy(x))
    f32 = fn(torch.from_numpy(x.astype(np.float32)))
    assert got.dtype == torch.float32
    gathered = torch.zeros(got.shape, dtype=torch.bool)
    plan = {(p[1], p[3]): p for p in fn.pieces}
    for r0, c0, h, w, ix_c, iy_c in fn.gathers:
        _, _, r1, _, c1, (j0, j1, i0, i1), _ = plan[(r0, c0)]
        jfn = jax_reproject_ops.make_gather_piece_fn(
            ix_c.numpy(), iy_c.numpy(), fn.step, h, w, 360, 720, j0, i0, "bilinear", np.nan)
        match(got[r0:r1, c0:c1], jfn(jnp.asarray(x[j0:j1, i0:i1])))
        gathered[r0:r1, c0:c1] = True
    match(got[~gathered], f32[~gathered])
    for dtype, interp in (("int16", "nearest"), ("float64", "bilinear")):
        other = port_srw.make_region_reproject_fn(sg, tg, interp, np.nan, exact=True,
                                                  device="cpu")
        with pytest.raises(TypeError):
            other(from_numpy(data(dtype, (360, 720))))


@pytest.mark.parametrize("dtype", ["uint16", "float64", "bfloat16"])
def test_resample_in_space_picks_jax_tier(monkeypatch, dtype):
    """``resample_in_space`` end to end: the default dispatch (tiled SRW)
    and ``XRTPU_NO_EXACT_MOSAIC=1`` with ``XRTPU_EXACT=1`` (the ESW, here
    no SRW), each equal to JAX's on ``jnp`` data, dtypes included."""
    x = data(dtype, (96, 96), nan="row")

    def run(pkg, wrap):
        sg, tg = gms(pkg)
        coords = dict(sg.to_coords(exclude_bounds=True))
        coords["spatial_ref"] = pkg.DataArray(np.array(0), dims=(), attrs=sg.crs.to_cf())
        ds = pkg.Dataset({"a": pkg.DataArray(wrap(x), dims=("y", "x"),
                                             attrs=dict(grid_mapping="spatial_ref"))},
                         coords=coords)
        kwargs = {} if pkg is xrt else dict(device="cpu")
        return pkg.resample_in_space(ds, target_gm=tg, **kwargs)["a"].data

    match(run(port, from_numpy), run(xrt, jnp.asarray))
    monkeypatch.setenv("XRTPU_EXACT", "1")
    match(run(port, from_numpy), run(xrt, jnp.asarray))


