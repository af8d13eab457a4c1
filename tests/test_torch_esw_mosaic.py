"""The port's exact region mosaic (K16, ``ops/esw_mosaic.py``) against the
JAX package's ``make_esw_region_fn``, on the CPU.

JAX's mosaic runs with x64 off: under the suite's x64 it raises
``TypeError`` in ``ops/esw.py:1745`` (mixed int64/int32 ``dynamic_slice``
indices), a fault of the reference's.  Its pieces are recorded by
wrapping ``esw.make_esw_fn``, ``reproject_ops.make_gather_piece_fn`` and
``reproject_ops.make_gather_piece_kernel_dyn`` (a ``jax.debug.callback``
reads the offsets each vmapped gather piece gets at run time); each
piece's target origin is found by matching its float32 coarse field in
the whole target's.  ``plan_esw`` calls are recorded too and replayed on
the port's copy.  Each JAX mosaic is built and run once per module on 3
bands; the port's 1-band output is held to JAX's first band (the bands
are independent), its 3-band output to all three.  Inputs come from a
numpy seed; every comparison is bit for bit, NaN masks included.
"""

import dataclasses
import inspect
import os
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu.ops import esw as jesw  # noqa: E402
from xcube_resampling_tpu.ops import reproject_ops as jro  # noqa: E402
from xcube_resampling_tpu.ops import srw as jsrw  # noqa: E402
from xcube_resampling_tpu_torch import _build  # noqa: E402
from xcube_resampling_tpu_torch import reproject as port_reproject  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw as pesw  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw_mosaic as pmos  # noqa: E402
from xcube_resampling_tpu_torch.ops import reproject_ops as pro  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as psrw  # noqa: E402
from tests.test_torch_slice import _dataset  # noqa: E402

STEP = 16
GLOBAL = dict(size=(720, 360), xy_min=(-180.0, -90.0), xy_res=0.5, crs="epsg:4326")
# (source, target) arguments of GridMapping.regular
CASES = {
    # the reduced BASELINE #3 (tests/test_torch_slice.py): 2 ESW pieces of
    # 192^2 (S 4 and 5) and a group of 2 gather pieces
    "b3": (GLOBAL, dict(size=(384, 384), xy_min=(2000000.0, 1000000.0), xy_res=16000.0,
                        crs="epsg:3035")),
    # tests/test_esw.py:_extreme_case: 4 ESW pieces of 256^2
    "extreme": (GLOBAL, dict(size=(512, 512), xy_min=(900000.0, 900000.0), xy_res=10000.0,
                             crs="EPSG:3035")),
    # the reduced BASELINE #3's target from a regional source (40 W-60 E,
    # 30-90 N): 3 ESW pieces and a single gather piece, a fifth of the
    # target off the source
    "regional": (dict(size=(200, 120), xy_min=(-40.0, 30.0), xy_res=0.5, crs="epsg:4326"),
                 dict(size=(384, 384), xy_min=(2000000.0, 1000000.0), xy_res=16000.0,
                      crs="epsg:3035")),
    # BASELINE #3 at full size (planned, not run): 63 ESW pieces in 29
    # groups, 7 gather pieces of 128^2 in one
    "b3_full": (dict(size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05, crs="epsg:4326"),
                dict(size=(4096, 4096), xy_min=(2000000.0, 1000000.0), xy_res=1500.0,
                     crs="epsg:3035")),
}
RUNS = [("b3", "bilinear"), ("b3", "nearest"), ("b3", "triangular"),
        ("extreme", "bilinear"), ("extreme", "nearest")]
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


def _data(case="b3", seed=7):
    """3 bands in [0, 1) on *case*'s source; band 1 with a NaN row and a
    +inf column."""
    w, h = CASES[case][0]["size"]
    x = np.random.default_rng(seed).random((3, h, w), dtype=np.float32)
    x[1, h // 4] = np.nan
    x[1, :, w // 3] = np.inf
    return x


def _locate(ix_c, raw32):
    """The target origin (r0, c0) of a piece from its float32 coarse field:
    the step-aligned slice of the whole target's field that equals it."""
    njr, nji = ix_c.shape
    a, b = np.argwhere(np.isfinite(ix_c))[0]
    hits = [
        (jr * STEP, ji * STEP)
        for jr, ji in np.argwhere(raw32 == ix_c[a, b]) - (a, b)
        if jr >= 0 and ji >= 0 and np.array_equal(
            raw32[jr : jr + njr, ji : ji + nji], ix_c, equal_nan=True
        )
    ]
    assert len(hits) == 1, hits
    return hits[0]


class _Recorder:
    """JAX's pieces and ``plan_esw`` calls while a mosaic is built and run."""

    def __init__(self, mp, raw32):
        self.raw32 = raw32
        self.pieces = set()
        self.plans = []  # (kwargs, result)
        self._singles = []
        make_esw_fn, plan_esw = jesw.make_esw_fn, jesw.plan_esw
        make_piece, make_dyn = jro.make_gather_piece_fn, jro.make_gather_piece_kernel_dyn

        def esw_fn(plan, *args, **kwargs):
            r0, c0 = _locate(plan.ix_c, raw32)
            window = (plan.j_off, plan.j_off + plan.src_h, plan.i_off, plan.i_off + plan.src_w)
            self.pieces.add(("esw", r0, r0 + plan.out_h, c0, c0 + plan.out_w, window,
                             plan.n_samples))
            return make_esw_fn(plan, *args, **kwargs)

        def plan(*args, **kwargs):
            out = plan_esw(*args, **kwargs)
            self.plans.append((kwargs, out))
            return out

        def piece(ix_c, iy_c, step, out_h, out_w, src_h_g, src_w_g, j_off, i_off, *args,
                  **kwargs):
            kernel, statics = make_piece(ix_c, iy_c, step, out_h, out_w, src_h_g, src_w_g,
                                         j_off, i_off, *args, **kwargs)
            r0, c0 = _locate(ix_c, raw32)

            def traced(src, *a):
                wh, ww = src.shape[-2:]
                self._singles.append(("gather", r0, r0 + out_h, c0, c0 + out_w,
                                      (j_off, j_off + wh, i_off, i_off + ww), 0))
                return kernel(src, *a)

            return traced, statics

        def dyn(step, out_h, out_w, *args, **kwargs):
            kernel = make_dyn(step, out_h, out_w, *args, **kwargs)

            def record(ix_c, j_off, i_off, wh, ww):
                r0, c0 = _locate(np.asarray(ix_c), raw32)
                j, i = int(j_off), int(i_off)
                self.pieces.add(("gather", r0, r0 + out_h, c0, c0 + out_w,
                                 (j, j + wh, i, i + ww), 0))

            def traced(src, ix_c, iy_c, j_off, i_off):
                wh, ww = src.shape[-2:]
                jax.debug.callback(
                    lambda a, j, i: record(a, j, i, wh, ww), ix_c, j_off, i_off
                )
                return kernel(src, ix_c, iy_c, j_off, i_off)

            return traced

        mp.setattr(jesw, "make_esw_fn", esw_fn)
        mp.setattr(jesw, "plan_esw", plan)
        mp.setattr(jro, "make_gather_piece_fn", piece)
        mp.setattr(jro, "make_gather_piece_kernel_dyn", dyn)

    def all_pieces(self):
        return self.pieces | set(self._singles)


def _jax_mosaic(case, interp, run=True):
    """JAX's mosaic of *case* (x64 off): its output on ``_data()`` (None
    unless *run*), its program tags and the recorder."""
    (jsrc, jtgt), _ = _gms(case)
    raw32 = jsrw._raw_coarse_fields(jsrc, jtgt, STEP)[0].astype(np.float32)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        rec = _Recorder(mp, raw32)
        fn = jesw.make_esw_region_fn(jsrc, jtgt, interp, np.nan)
        if fn is None:
            return None, None, rec
        out = np.asarray(fn(jnp.asarray(_data(case)))) if run else None
    tags = [meta for bucket in fn._buckets for meta in bucket._meta]
    return out, tags, rec


@pytest.fixture(scope="module")
def jax_runs():
    """Each (case, method) of RUNS through JAX once, on first use."""
    cache = {}

    def get(case, interp):
        if (case, interp) not in cache:
            cache[case, interp] = _jax_mosaic(case, interp)
        return cache[case, interp]

    return get


def _port_fn(case, interp, fill=np.nan):
    _, (psrc, ptgt) = _gms(case)
    return pmos.make_esw_region_fn(psrc, ptgt, interp, fill, device=CPU)


def _assert_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got, ref)


def _assert_plans_equal(got, ref):
    """Every field of the port's plan equals JAX's (the port leaves out
    JAX's cover sequences, keeping their slice counts)."""
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


def _norm(tags):
    return Counter(repr(t) for t in tags)


# ---------------------------------------------------------------------------
# the planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["b3", "extreme"])
def test_groups_and_pieces_match_jax(jax_runs, case):
    """The port's program tags equal JAX's buckets' ``_meta`` as a
    multiset, and its pieces (kind, target rows and columns, window, S)
    equal those JAX built and ran."""
    _, tags, rec = jax_runs(case, "bilinear")
    fn = _port_fn(case, "bilinear")
    assert _norm(fn.groups) == _norm(tags)
    assert len(set(fn.pieces)) == len(fn.pieces)
    assert set(fn.pieces) == rec.all_pieces()
    kinds = Counter(p[0] for p in fn.pieces)
    assert kinds == {"b3": {"esw": 2, "gather": 2}, "extreme": {"esw": 4}}[case]


@pytest.mark.parametrize(
    "case,budget",
    [("b3", "1500"), ("extreme", "4000"), ("extreme", "800"), ("regional", "7000"),
     ("b3_full", "7000")],
)
def test_planning_matches_jax(monkeypatch, case, budget):
    """At full BASELINE #3, from a regional source (a single gather
    piece), and under other ``XRTPU_ESW_OPBUDGET`` values (deeper splits,
    demotions, a single gather piece, no plan at all), the
    port's tags equal JAX's (a single piece's tag holds its target rows,
    columns and window), and its ESW pieces equal those JAX builds (JAX
    planned, not run: no compile)."""
    monkeypatch.setenv("XRTPU_ESW_OPBUDGET", budget)
    _, tags, rec = _jax_mosaic(case, "bilinear", run=False)
    fn = _port_fn(case, "bilinear")
    if tags is None:
        assert fn is None and case == "b3"
        return
    assert _norm(fn.groups) == _norm(tags)
    assert {p for p in fn.pieces if p[0] == "esw"} == rec.pieces


@pytest.mark.parametrize("case", ["b3", "extreme"])
def test_plan_esw_calls_match_jax(jax_runs, case):
    """Every ``plan_esw`` call of JAX's mosaic (the quadtree's probe plans
    and the groups' forced replans) replayed on the port's copy gives the
    same plan field by field, or the same refusal; ``_static_cover`` on
    each plan's bases equals JAX's."""
    _, _, rec = jax_runs(case, "bilinear")
    (jsrc, jtgt), (psrc, ptgt) = _gms(case)
    forced = accepted = 0
    for kwargs, ref in rec.plans:
        kw = dict(kwargs)
        for name in ("fields", "fields_global"):
            f = kw[name]
            kw[name] = psrw._Fields(f.ix64, f.iy64, f.iystar64, f.step, f.src_h, f.src_w,
                                    f.out_h, f.out_w)
        got = pesw.plan_esw(psrc, ptgt, **kw)
        _assert_plans_equal(got, ref)
        forced += kwargs.get("force") is not None
        if ref is None:
            continue
        accepted += 1
        _assert_plans_equal(got, ref)
        for base, d, axis in ((ref.base_v, np.asarray(ref.d_v_t), 0),
                              (ref.base_h, np.asarray(ref.d_h_t), 1)):
            cov_p, j_p = pesw._static_cover(base, d, axis)
            cov_j, j_j = jesw._static_cover(base, d, axis)
            assert (cov_p is None) == (cov_j is None)
            if cov_j is not None:
                np.testing.assert_array_equal(cov_p, cov_j)
                np.testing.assert_array_equal(j_p, j_j)
    assert forced >= {"b3": 2, "extreme": 4}[case] and accepted >= forced


def test_forced_plan_takes_no_early_refusal():
    """A forced plan is held to one tile and ``2 * max_taps``, with no
    shortcut: on the reduced BASELINE #3's right ESW piece (its group's
    window and S) it equals JAX's field by field at every ``max_taps``,
    and is accepted at 8, where the unforced plan refuses."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("b3")
    ix, iy = psrw._raw_coarse_fields(psrc, ptgt, STEP)
    ixs, iys = pesw._slice_raw(ix, iy, STEP, 192, 384, 192, 384)
    ys = psrw._iystar_from_fields(ixs, iys, 720, STEP)
    fields = psrw._Fields(ixs, iys, ys, STEP, 360, 720, 192, 192)
    jfields = jsrw._Fields(ixs, iys, ys, STEP, 360, 720, 192, 192)
    win = (0, 192, 336, 560)
    force = dict(n_samples=5, col_tile=128, row_tile=128, use_shift_v=True, use_shift_h=True)
    for max_taps in (6, 8, 12, 20, 40):
        got = pesw.plan_esw(psrc, ptgt, fields=pesw._offset_fields(fields, *win),
                            fields_global=fields, win=win, force=force, max_taps=max_taps)
        ref = jesw.plan_esw(jsrc, jtgt, fields=jesw._offset_fields(jfields, *win),
                            fields_global=jfields, win=win, force=force, max_taps=max_taps)
        _assert_plans_equal(got, ref)
        assert (got is None) == (max_taps == 6)
    unforced = pesw.plan_esw(psrc, ptgt, fields=pesw._offset_fields(fields, *win),
                             fields_global=fields, win=win, max_taps=8)
    assert unforced is None


def test_gather_window_must_hold_the_taps():
    """The planner refuses a gather window that misses a tap."""
    ix = np.array([[10.0, 20.0], [10.5, 20.5]])
    iy = np.array([[5.0, 5.0], [15.0, 15.0]])
    piece = pmos._gather_piece(0, 16, 0, 16, ix, iy, (4, 18, 9, 23), 100, 100)
    assert piece.kind == "gather" and piece.window == (4, 18, 9, 23)
    for window in ((5, 18, 9, 23), (4, 17, 9, 23), (4, 18, 10, 23), (4, 18, 9, 22)):
        with pytest.raises(RuntimeError, match="does not hold"):
            pmos._gather_piece(0, 16, 0, 16, ix, iy, window, 100, 100)


# ---------------------------------------------------------------------------
# the pieces' functions and the whole mosaic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("interp", ["bilinear", "nearest", "triangular"])
def test_gather_piece_plain_matches_jax(interp):
    """``gather_piece_plain`` on each gather piece of the reduced BASELINE #3
    equals JAX's ``make_gather_piece_fn`` on the same window, 3 bands."""
    fn = _port_fn("b3", interp)
    x = _data()
    rows = [r for r in fn.table.tolist() if r[pmos.KIND] == pmos.GATHER]
    assert len(rows) == 2
    for row in rows:
        ix_c, iy_c, _ = pmos._piece_fields(fn.fields, row)
        j0, i0, h, w = row[pmos.J_OFF], row[pmos.I_OFF], row[pmos.H], row[pmos.W]
        win = x[:, j0 : j0 + row[pmos.WH], i0 : i0 + row[pmos.WW]]
        got = pro.gather_piece_plain(torch.from_numpy(win), ix_c, iy_c, STEP, h, w, 360, 720,
                                     j0, i0, interp, np.nan)
        with jax.enable_x64(False):
            ref = jro.make_gather_piece_fn(ix_c.numpy(), iy_c.numpy(), STEP, h, w, 360, 720,
                                           j0, i0, interp, np.nan)(jnp.asarray(win))
        _assert_equal(got.numpy(), ref)
        assert np.isfinite(np.asarray(ref)).any()


@pytest.mark.parametrize("case,interp", RUNS)
def test_mosaic_matches_jax(jax_runs, case, interp):
    """The port's mosaic through its plain path equals JAX's mosaic bit for
    bit, NaN masks included, on 1 and 3 bands."""
    ref, _, _ = jax_runs(case, interp)
    fn = _port_fn(case, interp)
    x = torch.from_numpy(_data(case))
    got3 = fn(x)
    got1 = fn(x[0])
    assert got3.shape == (3,) + ref.shape[1:] and got1.shape == ref.shape[1:]
    _assert_equal(got3.numpy(), ref)
    _assert_equal(got1.numpy(), ref[0])
    _assert_equal(fn.plain(x).numpy(), ref)
    assert np.isfinite(ref[0]).mean() > 0.5


def test_mosaic_numeric_fill_and_tile_prefix():
    """A numeric fill lands where the NaN fill does: on the target pixels
    no piece covers and on each piece's invalid pixels (a clean band of
    the regional source); the tile prefix counts each piece's 16 x 128
    tiles."""
    x = torch.from_numpy(_data("regional")[0])
    ref = _port_fn("regional", "bilinear")(x)
    fn = _port_fn("regional", "bilinear", fill=-2.5)
    got = fn(x)
    assert torch.isnan(ref).float().mean() > 0.1
    _assert_equal(got.numpy(), torch.where(torch.isnan(ref), -2.5, ref).numpy())
    tiles = fn.tile_start.tolist()
    sizes = [-(-(r[pmos.H]) // pmos.TILE_ROWS) * -(-(r[pmos.W]) // pmos.TILE_COLS)
             for r in fn.table.tolist()]
    assert tiles == list(np.cumsum([0] + sizes)) and fn.n_tiles == tiles[-1]


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("case", ["b3", "extreme", "regional"])
def test_covered_canvas_is_not_filled_first(case, drop):
    """The pieces are disjoint, and ``fn.covered`` says whether they tile
    the target (here they do, unless a piece is dropped from the plan); the
    mosaic equals the one on a canvas filled first, which keeps the fill
    where no piece lies."""
    _, (psrc, ptgt) = _gms(case)
    plan = pmos.plan_esw_region(psrc, ptgt, STEP)
    if drop:
        plan.pieces = plan.pieces[1:]
    fn = pmos.ESWMosaicFn(plan, "bilinear", np.nan, CPU)
    hits = np.zeros((fn.out_h, fn.out_w), dtype=np.int64)
    for _, r0, r1, c0, c1, _, _ in fn.pieces:
        hits[r0:r1, c0:c1] += 1
    assert hits.max() == 1 and fn.covered == (not drop) == bool(hits.all())
    x = torch.from_numpy(_data(case))
    got = fn(x)
    _assert_equal(got.numpy(), pmos.esw_mosaic_plain(*fn.args(x)[:-1], False).numpy())
    assert torch.isnan(got[:, torch.from_numpy(hits == 0)]).all()


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------


def test_resample_in_space_runs_the_mosaic():
    """With no switch set, ``resample_in_space`` on the reduced BASELINE #3
    runs the exact region mosaic in both packages (JAX with x64 off), and
    the two agree bit for bit (triangular, 3 bands)."""
    for name in ("XRTPU_EXACT", "XRTPU_NO_EXACT_MOSAIC", "XRTPU_FAST_EXTREME_WARP"):
        assert name not in os.environ
    (jsrc, jtgt), (psrc, ptgt) = _gms("b3")
    x = _data(seed=11)
    got = pt.resample_in_space(_dataset(psrc, b=torch.from_numpy(x)), target_gm=ptgt,
                               interp_methods="triangular")
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    assert isinstance(fn, pmos.ESWMosaicFn)
    with jax.enable_x64(False):
        ref = jx.resample_in_space(_dataset(jsrc, jx, b=jnp.asarray(x)), target_gm=jtgt,
                                   interp_methods="triangular")
    _assert_equal(got["b"].data.numpy(), ref["b"].data)


def test_memo_key_separates_the_mosaic_switch(monkeypatch):
    """``XRTPU_NO_EXACT_MOSAIC`` is part of the plan memo's key: toggled
    between two calls on one geometry, the second builds K3's fn and does
    not reuse the cached mosaic (and back again).  So is
    ``XRTPU_FAST_EXTREME_WARP``: set, it builds the two-pass mosaic."""
    _, (psrc, ptgt) = _gms("b3")
    x = torch.from_numpy(_data()[0])
    fns = []
    for flag in ("", "1", ""):
        monkeypatch.setenv("XRTPU_NO_EXACT_MOSAIC", flag)
        fns.append(port_reproject.device_reproject_fn(psrc, ptgt, "bilinear", np.nan, CPU))
    assert isinstance(fns[0], pmos.ESWMosaicFn)
    assert isinstance(fns[1], pro.FusedReprojectFn)
    assert fns[2] is fns[0]
    # the mosaic reproduces the direct gather: nearest bit for bit
    monkeypatch.setenv("XRTPU_NO_EXACT_MOSAIC", "")
    mos = port_reproject.device_reproject_fn(psrc, ptgt, "nearest", np.nan, CPU)
    monkeypatch.setenv("XRTPU_NO_EXACT_MOSAIC", "1")
    k3 = port_reproject.device_reproject_fn(psrc, ptgt, "nearest", np.nan, CPU)
    _assert_equal(mos(x).numpy(), k3(x).numpy())
    monkeypatch.setenv("XRTPU_FAST_EXTREME_WARP", "1")
    fast = port_reproject.device_reproject_fn(psrc, ptgt, "nearest", np.nan, CPU)
    assert isinstance(fast, psrw.RegionSRWFn) and fast is not mos


def test_region_reproject_fn_exact_only():
    """``make_region_reproject_fn`` gives the mosaic with ``exact=True``,
    and with ``exact=False`` the two-pass mosaic (``RegionSRWFn``; None for
    triangular, as JAX's); both entry points default to the card."""
    _, (psrc, ptgt) = _gms("b3")
    fn = psrw.make_region_reproject_fn(psrc, ptgt, "nearest", exact=True, device=CPU)
    assert isinstance(fn, pmos.ESWMosaicFn) and fn.interp_method == "nearest"
    fast = psrw.make_region_reproject_fn(psrc, ptgt, "nearest", device=CPU)
    assert isinstance(fast, psrw.RegionSRWFn) and fast.covered
    assert psrw.make_region_reproject_fn(psrc, ptgt, "triangular", device=CPU) is None
    assert pmos.make_esw_region_fn(psrc, ptgt, "cubic", device=CPU) is None
    for entry in (psrw.make_region_reproject_fn, pmos.make_esw_region_fn):
        assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_k16_entry_point_is_declared():
    """K16's C entry is bound with its argument types, and its source and
    the per-pixel header it shares with K13 are in the build."""
    assert len(_build._SIGNATURES["xrt_esw_mosaic_f32"]) == 19
    names = {p.name for p in _build.CSRC.iterdir()}
    assert {"esw_mosaic.cu", "esw_pixel.h", "esw_gather.cu"} <= names
    for source in ("esw_mosaic.cu", "esw_gather.cu"):
        assert '#include "esw_pixel.h"' in (_build.CSRC / source).read_text()
