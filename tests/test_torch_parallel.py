"""The port's sharded reproject against the JAX package's, on the CPU.

JAX shards over its virtual 8-device CPU mesh (``tests/conftest.py``), the
port over a mesh of CPU devices (``make_mesh(devices=[cpu] * n)``), on the
same numpy inputs from a seed, float32.  The port's band kernels run their
plain versions on CPU tensors.  Expected: the sharded SRW and the sharded
regrid equal JAX's steps bit for bit.  Beyond the two-pass gate both
packages run the sharded ESW (``tests/test_torch_esw_sharded.py`` holds the
two equal); here the port's is held to the single-chip gather at the
bounds of ``tests/test_parallel.py``'s cropped case.
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
    # a source width no 4 divides (no 16-byte copies) onto a target whose
    # width no 64 divides; planned with tap_budget=1 (row tiles of 64), the
    # last row tile of each band overlaps its predecessor
    "tiles": (dict(UTM, size=(95, 96)), dict(LAEA, size=(150, 290), xy_res=30)),
    # an 8x downscale in one CRS: K2's windows some 1000 source columns a
    # 128-column segment, wider than its ring holds at 4 bands an item
    "down8": (dict(UTM, size=(2048, 128)), dict(UTM, size=(256, 16), xy_min=(565000.0,
                                                                             5930000.0 + 3200.0),
                                                xy_res=800.0)),
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
def test_sharded_reproject_beyond_the_gate(monkeypatch, method):
    """Past the two-pass gate, sharded_reproject crops the source and runs
    the sharded ESW (K13's band form), as JAX does; no regrid.  Against
    the single-chip gather on the whole source (JAX
    make_fused_reproject_fn): NaN masks equal; bilinear and triangular
    within 2e-4 (the crop's window-relative float32 fields,
    tests/test_parallel.py:367); nearest equal but where the window's
    float32 fields move rint, at most 1e-4 of the pixels."""
    from xcube_resampling_tpu_torch.parallel import halo as phalo

    (jsrc, jtgt), (psrc, ptgt) = _gms("severe")
    data = _data("severe")
    assert ppar.make_sharded_srw_step(_port_mesh(8), psrc, ptgt) is None
    steps = []
    orig = phalo.make_sharded_esw_step

    def spy(*args, **kwargs):
        built = orig(*args, **kwargs)
        steps.append(built)
        return built

    monkeypatch.setattr(phalo, "make_sharded_esw_step", spy)
    regrid = []
    monkeypatch.setattr(phalo, "make_sharded_regrid_step", lambda *a, **k: regrid.append(1))
    got = ppar.sharded_reproject(torch.from_numpy(data), psrc, ptgt, _port_mesh(8),
                                 interp_method=method).full().numpy()
    assert len(steps) == 1 and isinstance(steps[0][0], phalo.ShardedESWStep) and not regrid
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


def _band_taps(window, pos, t0, b0, d_h, finite, method):
    """K2's tap sums (``srw_common.h:tap_sums``) of one row's outputs at
    positions *pos* from their staged window row, each output's taps from
    window column *t0* on (tap index *b0*): the two-tap shortcut where the
    row is *finite*, every tap otherwise; (acc, acc_d)."""
    fma = reproject_ops.fma
    zero = torch.zeros_like(pos)
    fp = torch.floor(pos)
    if finite:
        if method == "nearest":
            t = torch.round(pos).long() - b0
            inside = (t >= 0) & (t < d_h)
            s = window[(t0 + t.clamp(0, d_h - 1))]
            return torch.where(inside, fma(torch.ones_like(s), s, zero), zero), zero
        t = fp.long() - b0
        acc, acc_d = zero, zero
        for d, sign in ((0, 1.0), (1, -1.0)):
            inside = (t + d >= 0) & (t + d < d_h)
            s = window[t0 + (t + d).clamp(0, d_h - 1)]
            w = torch.clamp_min(1.0 - torch.abs(pos - (fp + d)), 0.0)
            acc = torch.where(inside, fma(w, s, acc), acc)
            acc_d = torch.where(inside, fma(torch.full_like(s, sign), s, acc_d), acc_d)
        return acc, acc_d
    acc, acc_d = zero, zero
    for d in range(d_h):
        k = (b0 + d).to(torch.float32)
        s = window[t0 + d]
        if method == "nearest":
            w = (torch.round(pos) == k).to(torch.float32)
        else:
            w = torch.clamp_min(1.0 - torch.abs(pos - k), 0.0)
        acc = fma(w, s, acc)
        dw = (fp == k).to(torch.float32) - (fp + 1.0 == k).to(torch.float32)
        acc_d = fma(dw, s, acc_d)
    return acc, acc_d


def _band_form_emulated(v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, win, method, fill,
                        vd, row0):
    """K2's band form as its kernel takes it apart (``csrc/srw_horizontal.cu``,
    ``srw_horizontal_band_kernel``): a warp a task of 16 rows by one
    ``BAND_COLS``-column segment; for each (row, band) the window of the
    row's tile and the segment (the host's ``lohi``) staged with every
    column clamped into the row, the row's finiteness deciding the two-tap
    shortcut; asserts that every output's taps lie in its window."""
    batch, out_h, src_w = v.shape
    out_w = base_h.shape[1]
    seg = srw_kernels.BAND_COLS
    tri = method == "triangular"
    assert win.cols == seg
    pos, valid, corr = srw_kernels._horizontal_geometry(
        ix_c, iy_c, step, out_h, out_w, src_h, src_w, tri, row0)
    out = torch.full((batch, out_h, out_w), -7.0)
    for cb in range(-(-out_w // seg)):
        cols = torch.arange(cb * seg, min(cb * seg + seg, out_w))
        for j in range(out_h):
            t = j // row_tile
            lo, hi = (int(x) for x in win.lohi[t, cb])
            assert lo % 4 == 0 and hi % 4 == 0 and hi - lo <= win.extent
            b0 = base_h[t, cols].long()
            assert (b0 >= lo).all() and (b0 + d_h <= hi).all()
            idx = torch.arange(lo, hi).clamp(0, src_w - 1)
            for b in range(batch):
                rows = [v[b, j, idx]] + ([vd[b, j, idx]] if tri else [])
                finite = all(bool(torch.isfinite(r).all()) for r in rows)
                acc, _ = _band_taps(rows[0], pos[j, cols], b0 - lo, b0, d_h, finite, method)
                if tri:
                    _, acc_dd = _band_taps(rows[1], pos[j, cols], b0 - lo, b0, d_h, finite,
                                           method)
                    acc = reproject_ops.fma(-corr[j, cols], acc_dd, acc)
                out[b, j, cols] = torch.where(valid[j, cols], acc, torch.tensor(fill))
    return out


@pytest.mark.parametrize("method", METHODS)
def test_band_form_plan_covers_its_taps_and_equals_jax(method):
    """K2's band form's windows and launch plan, emulated task by task as
    its kernel runs them, on bands whose last row tile overlaps its
    predecessor, a target width no 64 divides and a source width no 4
    divides, clean and with NaN rows: every output's taps lie in its
    staged window, and the emulation equals the band form's plain version
    bit for bit; the sharded step equals JAX's."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("tiles")
    n = 2
    data = _data("tiles", 2)
    nan_rows = data.copy()
    nan_rows[:, 40:42] = np.nan
    nan_rows[:, 70] = np.nan
    jb = jpar.make_sharded_srw_step(_jax_mesh(n), jsrc, jtgt, interp_method=method,
                                    src_batch_dims=1, tap_budget=1)
    pb = ppar.make_sharded_srw_step(_port_mesh(n), psrc, ptgt, interp_method=method,
                                    src_batch_dims=1, tap_budget=1)
    step = pb[0]
    p = step.plan
    assert p.tiles_per_band * p.row_tile > p.out_band_h  # the overlapping last tile
    assert p.out_w % srw_kernels.BAND_COLS and p.src_w % 4
    for x in (data, nan_rows):
        _equal(_run_port(pb, x), _run_jax(jb, x))
        bands, _ = step.bands(torch.from_numpy(x))
        halos = step.exchange(bands)
        for k in range(n):
            v, vd = srw_kernels.srw_vertical_band_plain(*step.vertical_args(bands, halos, k))
            h_args = step.horizontal_args(v, vd, k)
            ref = srw_kernels.srw_horizontal_band_plain(*h_args)
            torch.testing.assert_close(_band_form_emulated(*h_args), ref, rtol=0, atol=0,
                                       equal_nan=True)


@pytest.mark.parametrize("method", METHODS)
def test_band_form_downscale_plan_covers_its_taps_and_equals_jax(method):
    """An 8x downscale through the sharded SRW, whose windows (some 1000
    columns a segment) do not fit K2's ring at 4 bands an item: the launch
    plan fits them at every batch, the emulated kernel equals the band
    form's plain version bit for bit on every band, and the step equals
    JAX's."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("down8")
    n = 2
    data = _data("down8", 4)
    jb = jpar.make_sharded_srw_step(_jax_mesh(n), jsrc, jtgt, interp_method=method,
                                    src_batch_dims=1)
    pb = ppar.make_sharded_srw_step(_port_mesh(n), psrc, ptgt, interp_method=method,
                                    src_batch_dims=1)
    _equal(_run_port(pb, data), _run_jax(jb, data))
    step = pb[0]
    tri = method == "triangular"
    extent = max(w.extent for w in step.plan.win_h)
    assert extent > 7 * srw_kernels.BAND_COLS
    wide = srw_kernels.plan_band_launch(4, extent, tri, group=4)
    assert wide.group < 4  # the default ring would not fit
    for batch in (1, 2, 3, 4):
        launch = srw_kernels.plan_band_launch(batch, extent, tri)
        assert launch.smem <= srw_kernels.SMEM_BLOCK_MAX
    bands, _ = step.bands(torch.from_numpy(data))
    halos = step.exchange(bands)
    for k in range(n):
        v, vd = srw_kernels.srw_vertical_band_plain(*step.vertical_args(bands, halos, k))
        h_args = step.horizontal_args(v, vd, k)
        torch.testing.assert_close(_band_form_emulated(*h_args),
                                   srw_kernels.srw_horizontal_band_plain(*h_args),
                                   rtol=0, atol=0, equal_nan=True)


# (batch, extent, triangular) -> (bands an item, stages, warps a block)
_LAUNCHES = [
    ((4, 84, False), (4, 3, 4)),  # BASELINE #5's band: 3 stages of 4 bands
    ((3, 84, False), (2, 3, 4)),  # items of 2 bands and 1
    ((1, 84, False), (1, 3, 4)),  # the ring sized for one band
    ((2, 84, True), (2, 3, 4)),
    ((4, 1040, False), (1, 3, 4)),  # 8x downscale: fewer bands an item
    ((4, 1040, True), (1, 3, 4)),
    ((1, 20000, False), (1, 1, 2)),  # past the block's most: 1 stage, fewer warps
    ((1, 40000, False), (1, 1, 1)),
    ((1, 60000, False), None),  # one window row does not fit
    ((1, 30000, True), None),
]


@pytest.mark.parametrize("case, want", _LAUNCHES)
def test_band_launch_sizes_the_ring_to_the_batch_and_the_window(case, want):
    """K2's launch plan: the most of 4, 2 and 1 bands an item up to the
    batch, 3 stages, 4 warps; fewer bands an item while the block's shared
    memory leaves the SM too little for the blocks its registers allow (5,
    triangular 2); one stage, then fewer warps while it does not fit a
    block; ValueError where one window row does not fit; always a pair the
    kernel instantiates."""
    batch, extent, tri = case
    if want is None:
        with pytest.raises(ValueError, match="does not fit"):
            srw_kernels.plan_band_launch(batch, extent, tri)
        return
    launch = srw_kernels.plan_band_launch(batch, extent, tri)
    assert (launch.group, launch.stages, launch.warps) == want
    row_bytes = 4 * extent * (2 if tri else 1)
    assert launch.smem == launch.warps * launch.stages * launch.group * row_bytes
    assert launch.smem <= srw_kernels.SMEM_BLOCK_MAX
    per_sm = srw_kernels.SMEM_SM // srw_kernels.BAND_MIN_BLOCKS[tri] - srw_kernels.SMEM_RESERVED
    assert launch.smem <= per_sm or launch.group == 1
    assert (launch.group, launch.stages) in srw_kernels.BAND_ITEMS


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
    """A float64 source, which the sharded steps refused before they took
    the JAX package's thirteen dtypes: the sharded SRW step keeps float64
    (the tiled SRW's promotion) and equals JAX's bit for bit; a dtype
    outside the thirteen (complex64) raises."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("utm")
    data = _data("utm", 2).astype(np.float64)
    jb = jpar.make_sharded_srw_step(_jax_mesh(3), jsrc, jtgt, src_batch_dims=1)
    pb = ppar.make_sharded_srw_step(_port_mesh(3), psrc, ptgt, src_batch_dims=1)
    got, ref = _run_port(pb, data), _run_jax(jb, data)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(ref).mean() > 0.3
    with pytest.raises(NotImplementedError, match="the port's kernels take"):
        ppar.sharded_reproject(torch.zeros(96, 96, dtype=torch.complex64), psrc, ptgt,
                               _port_mesh(2))
