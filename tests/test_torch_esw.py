"""The port's exact separable warp (K13, ``ops/esw.py``) against the JAX
package's, on the CPU.

The planner copies are held to the originals field by field; the port's
ESW (K13's plain version on CPU tensors) is held to JAX's
``make_esw_reproject_fn`` on ``jnp`` arrays bit for bit, NaN masks
included, for every method: on a mild warp without a window, on windowed
warps past the two-pass gate with shift alignment (``bits_v > 0`` and
``bits_h > 0``), on a target over the
source's last row and column, with NaN and +-inf in the sources' edge rows
and columns, and on a batch of 3 bands (``tests/test_torch_esw_fuzz.py``
adds a deterministic subset of ``tests/test_fuzz_esw.py``'s CRS pairs, and
``tests/test_torch_esw_sharded.py`` the sharded step); and
``resample_in_space`` runs the ESW in both packages past the gate.  Inputs come from a numpy seed,
float32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu.ops import esw as jesw  # noqa: E402
from xcube_resampling_tpu.ops import srw as jsrw  # noqa: E402
from xcube_resampling_tpu_torch import reproject as port_reproject  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw as pesw  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as psrw  # noqa: E402
from tests.test_torch_slice import _dataset, _spy  # noqa: E402

METHODS = ("bilinear", "nearest", "triangular")
UTM = dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632")
GLOBAL = dict(size=(720, 360), xy_min=(-180.0, -90.0), xy_res=0.5, crs="epsg:4326")
# (source, target) arguments of GridMapping.regular
CASES = {
    # a mild warp, no window (tests/test_esw.py:_utm_case): S = 3
    "utm": (UTM, dict(size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035")),
    # past the two-pass gate (tests/test_esw.py:_severe_case): a window,
    # S = 4, shift alignment on both axes (bits_v 6, bits_h 3)
    "severe": (GLOBAL, dict(size=(512, 256), xy_min=(900000.0, 900000.0), xy_res=7000.0,
                            crs="epsg:3035")),
    # tests/test_parallel.py:_severe_sharded_case single-chip: a window,
    # bits_v 5, JAX's static horizontal cover (jh > 0)
    "cover": (GLOBAL, dict(size=(256, 256), xy_min=(2500000.0, 1400000.0), xy_res=15000.0,
                           crs="epsg:3035")),
    # the mild warp with the target 4 km right of and below it: its valid
    # pixels tap the source's last row and column
    "edges": (UTM, dict(size=(80, 80), xy_min=(4324500, 3375500), xy_res=100,
                        crs="epsg:3035")),
    # the reduced BASELINE #3 (tests/test_torch_slice.py): a singular warp
    # that both planners refuse
    "refused": (GLOBAL, dict(size=(384, 384), xy_min=(2000000.0, 1000000.0), xy_res=16000.0,
                             crs="epsg:3035")),
}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    yield
    port_reproject._DEVICE_FN_CACHE.clear()


def _gms(case):
    src, tgt = CASES[case]
    return (
        (jx.GridMapping.regular(**src), jx.GridMapping.regular(**tgt)),
        (pt.GridMapping.regular(**src), pt.GridMapping.regular(**tgt)),
    )


def _data(case, window=None, seed=3):
    """3 bands in [0, 1): band 1 with NaN and +-inf on the source's edge
    rows and columns, band 2 on the window's (and NaN and +inf lines
    inside it)."""
    w, h = CASES[case][0]["size"]
    x = np.random.default_rng(seed).random((3, h, w), dtype=np.float32)
    x[1, 0], x[1, -1], x[1, :, 0], x[1, :, -1] = np.inf, -np.inf, np.nan, np.inf
    j0, j1, i0, i1 = window or (0, h, 0, w)
    x[2, j0], x[2, j1 - 1], x[2, :, i0], x[2, :, i1 - 1] = np.nan, np.inf, -np.inf, np.nan
    x[2, (j0 + j1) // 2, i0 : (i0 + i1) // 2] = np.inf
    x[2, j0 : (j0 + j1) // 2, (i0 + i1) // 3] = np.nan
    return x


def _planned(pkg_esw, pkg_srw, src, tgt, **kwargs):
    """``plan_esw`` as ``make_esw_reproject_fn`` calls it, with the
    package's own copies."""
    fields = pkg_srw._coarse_geometry(src, tgt, 16)
    if fields is None:
        return None
    w = pkg_srw._source_window_gm(src, fields, margin=8 + 48)
    win = w[1] if w is not None else None
    f_plan = pkg_esw._offset_fields(fields, *win) if win is not None else fields
    return pkg_esw.plan_esw(src, tgt, fields=f_plan, fields_global=fields, win=win, **kwargs)


def _assert_plans_equal(got, ref):
    """Every field of the port's plan equals JAX's (the port leaves out
    JAX's cover sequences, which only lay out the TPU's taps, and keeps
    their slice counts)."""
    assert (got is None) == (ref is None)
    if ref is None:
        return
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# the host planners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_esw_matches_jax(case):
    """plan_esw (and _max_row_deviation, _offset_fields under it) equals
    JAX's field by field, or refuses where JAX's does."""
    (jsrc, jtgt), (psrc, ptgt) = _gms(case)
    ref = _planned(jesw, jsrw, jsrc, jtgt)
    got = _planned(pesw, psrw, psrc, ptgt)
    _assert_plans_equal(got, ref)
    expect = {
        "utm": lambda p: p.n_samples == 3 and p.bits_v == p.bits_h == 0,
        "severe": lambda p: p.j_off > 0 and p.bits_v > 0 and p.bits_h > 0,
        "cover": lambda p: p.i_off > 0 and p.bits_v > 0 and ref.jh > 0,
        "edges": lambda p: p.j_off == p.i_off == 0,
        "refused": lambda p: p is None,
    }[case]
    assert expect(got)


@pytest.mark.parametrize(
    "shape, k0, k1",
    [
        ((12, 5), [0, 3, 5], [5, 9, 12]),  # overlapping, the last reaching the end
        ((12, 5), [0, 4, 8], [4, 8, 12]),  # abutting
        ((12, 1), [2, 2, 11], [3, 6, 12]),  # one row, one column, repeated starts
    ],
)
def test_row_range_extrema_matches_a_loop(shape, k0, k1):
    """The tile layouts' row-range extrema equal numpy's per-range min and
    max, NaN included."""
    a = np.random.default_rng(5).random(shape)
    a[7, 0] = np.nan
    lo, hi = pesw._row_range_extrema(a, np.array(k0), np.array(k1))
    np.testing.assert_array_equal(lo, [a[x:y].min(axis=0) for x, y in zip(k0, k1)])
    np.testing.assert_array_equal(hi, [a[x:y].max(axis=0) for x, y in zip(k0, k1)])


# ---------------------------------------------------------------------------
# the single-card ESW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "case, method",
    [(c, m) for c in ("utm", "severe", "edges") for m in METHODS] + [("cover", "bilinear")],
)
def test_esw_matches_jax(case, method):
    """The port's make_esw_reproject_fn (K13's plain version) equals JAX's
    on 3 bands with NaN and +-inf edge rows and columns, bit for bit; the
    wrapper and the plain version agree on CPU tensors.  (JAX's static
    cover is a layout of its own; the port's kernel is the same for it.)"""
    (jsrc, jtgt), (psrc, ptgt) = _gms(case)
    fn = pesw.make_esw_reproject_fn(psrc, ptgt, method, np.nan, device=CPU)
    jfn = jesw.make_esw_reproject_fn(jsrc, jtgt, method, np.nan)
    assert fn is not None and jfn is not None
    data = _data(case, fn.window)
    ref = np.asarray(jfn(jnp.asarray(data)))
    got = fn(torch.from_numpy(data))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(fn.plain(torch.from_numpy(data)).numpy(), ref)
    assert np.isfinite(ref).mean() > 0.2
    if case == "edges":
        # the valid pixels' taps reach the source's last row and column
        valid, _, _, columns = pesw.esw_taps(
            (96, 96), fn.iystar_c, fn.ix_c, fn.iy_c, fn.step, fn.n_samples, method, 0,
            fn.out_h, fn.out_w, 96, 96, 0, 0, 96, 0)
        assert max(int(c[valid].max()) for _, _, c in columns) == 95
        assert max(int(rb[valid].max()) for _, rb, _ in columns) == 95


@pytest.mark.parametrize("method", ["nearest", "triangular"])
def test_esw_numeric_fill_and_2d_source_match_jax(method):
    """A numeric fill value on a target partly off the source, a 2D
    source with +-inf and NaN edge rows and columns."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("edges")
    fn = pesw.make_esw_reproject_fn(psrc, ptgt, method, -9999.0, device=CPU)
    data = _data("edges")[1]
    ref = np.asarray(jesw.make_esw_reproject_fn(jsrc, jtgt, method, -9999.0)(
        jnp.asarray(data)))
    got = fn(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (80, 80) and 0.2 < (got == -9999.0).mean() < 0.8


def test_esw_gather_plain_is_the_tier():
    """esw_gather_plain on the cropped window is the tier's output, and
    the band form at row 0 on the whole source, with no window, is K13."""
    (_, _), (psrc, ptgt) = _gms("utm")
    fn = pesw.make_esw_reproject_fn(psrc, ptgt, "bilinear", np.nan, device=CPU)
    x = torch.from_numpy(_data("utm"))
    out = pesw.esw_gather_plain(*fn.args(fn.crop(x)))
    assert torch.equal(out.isnan(), fn(x).isnan())
    assert torch.equal(out.nan_to_num(), fn(x).nan_to_num())
    band = pesw.esw_gather_band(x, fn.iystar_c, fn.ix_c, fn.iy_c, fn.step, fn.n_samples,
                                fn.out_h, fn.out_w, "bilinear", np.nan, 0, 0, 96)
    assert torch.equal(band.nan_to_num(), out.nan_to_num())


def test_esw_refuses_where_jax_does():
    """The singular warp and an unknown method: None in both packages."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("refused")
    assert jesw.make_esw_reproject_fn(jsrc, jtgt) is None
    assert pesw.make_esw_reproject_fn(psrc, ptgt, device=CPU) is None
    (jsrc, jtgt), (psrc, ptgt) = _gms("utm")
    assert jesw.make_esw_reproject_fn(jsrc, jtgt, "cubic") is None
    assert pesw.make_esw_reproject_fn(psrc, ptgt, "cubic", device=CPU) is None
    plan = pesw.plan_esw(psrc, ptgt)
    with pytest.raises(ValueError):
        pesw.make_esw_fn(plan, "cubic", device=CPU)


# ---------------------------------------------------------------------------
# resample_in_space: the tier the ladder picks
# ---------------------------------------------------------------------------


def _resample_both(monkeypatch, case, interp):
    (jsrc, jtgt), (psrc, ptgt) = _gms(case)
    jax_esw_fns = []
    orig = jesw.make_esw_reproject_fn

    def jax_spy(*args, **kwargs):
        fn = orig(*args, **kwargs)
        jax_esw_fns.append(fn)
        return fn

    monkeypatch.setattr(jesw, "make_esw_reproject_fn", jax_spy)
    k3_calls = _spy(monkeypatch, port_reproject, "make_fused_reproject_fn")
    data = _data(case)
    a, b = data[0], data[1:]
    ref = jx.resample_in_space(_dataset(jsrc, jx, a=jnp.asarray(a), b=jnp.asarray(b)),
                               target_gm=jtgt, interp_methods=interp)
    got = pt.resample_in_space(_dataset(psrc, a=torch.from_numpy(a), b=torch.from_numpy(b)),
                               target_gm=ptgt, interp_methods=interp, device=CPU)
    assert jax_esw_fns and all(f is not None for f in jax_esw_fns)
    assert not k3_calls
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    assert isinstance(fn, pesw.ESWReprojectFn)
    for name in ("a", "b"):
        assert got[name].dims == ref[name].dims
        np.testing.assert_array_equal(got[name].data.numpy(), np.asarray(ref[name].data))
    return fn


@pytest.mark.parametrize("method", METHODS)
def test_resample_in_space_past_the_gate_runs_esw(monkeypatch, method):
    """With no flag, past the two-pass gate: both packages refuse the SRW
    and run the ESW (JAX's tier 2), equal bit for bit."""
    monkeypatch.delenv("XRTPU_EXACT", raising=False)
    srw_fns = []
    orig = port_reproject.make_srw_reproject_fn

    def srw_spy(*args, **kwargs):
        fn = orig(*args, **kwargs)
        srw_fns.append(fn)
        return fn

    monkeypatch.setattr(port_reproject, "make_srw_reproject_fn", srw_spy)
    fn = _resample_both(monkeypatch, "severe", method)
    assert srw_fns == [None]
    assert fn.window is not None


def test_resample_in_space_exact_flag_runs_esw(monkeypatch):
    """XRTPU_EXACT=1 on a mild warp: the ESW in both packages, no SRW."""
    monkeypatch.setenv("XRTPU_EXACT", "1")
    srw_calls = _spy(monkeypatch, psrw, "make_srw_fn")
    _resample_both(monkeypatch, "utm", "bilinear")
    assert not srw_calls
