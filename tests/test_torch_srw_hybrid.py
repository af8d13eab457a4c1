"""The port's fast extreme-warp mode (``XRTPU_FAST_EXTREME_WARP=1``) against
the JAX package, on the CPU: the hybrid SRW (K17, K18, ``ops/srw_hybrid.py``),
its planner, the SRW dispatch with the hybrid admitted and the two-pass
region mosaic.

The port's kernels run their plain versions on CPU tensors.  JAX's mosaic
pieces are read from its jitted fn's closure (``pieces``) and its variants
from spies on its SRW constructors; its planner calls inside a mosaic are
recorded and replayed on the port's copy.  Inputs come from a numpy seed,
with a NaN row and an ``inf`` column in one band; every comparison is bit
for bit, NaN masks included.  JAX's reduced BASELINE #3 runs once a method
a module (about 10 s each).
"""

import dataclasses
import inspect
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu import reproject as jax_reproject  # noqa: E402
from xcube_resampling_tpu.ops import reproject_ops as jro  # noqa: E402
from xcube_resampling_tpu.ops import srw as jsrw  # noqa: E402
from xcube_resampling_tpu_torch import _build  # noqa: E402
from xcube_resampling_tpu_torch import reproject as port_reproject  # noqa: E402
from xcube_resampling_tpu_torch._device import LAUNCHES  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as psrw  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw_hybrid  # noqa: E402
from xcube_resampling_tpu_torch.ops.reproject_ops import interp_field  # noqa: E402
from tests.test_torch_slice import _dataset  # noqa: E402

SWITCH = "XRTPU_FAST_EXTREME_WARP"
GLOBAL = dict(size=(720, 360), xy_min=(-180.0, -90.0), xy_res=0.5, crs="EPSG:4326")
# (source, target) arguments of GridMapping.regular
CASES = {
    # tests/test_srw.py:_extreme_case: the whole-domain dispatch takes the
    # hybrid; the mosaic (base_split=2, max_depth=1) 2 hybrid, 1 aligned
    # and 1 tiled piece
    "extreme": (GLOBAL, dict(size=(512, 512), xy_min=(900000.0, 900000.0), xy_res=10000.0,
                             crs="EPSG:3035")),
    # tests/test_srw.py:_moderate_hybrid_case: plan_srw_hybrid plans the
    # whole domain; the dispatch crops and takes the aligned SRW
    "moderate": (GLOBAL, dict(size=(512, 256), xy_min=(900000.0, 900000.0), xy_res=7000.0,
                              crs="EPSG:3035")),
    # the reduced BASELINE #3 (tests/test_torch_esw_mosaic.py): no whole
    # plan; the mosaic 3 hybrid (2 at step 4), 10 aligned, 1 tiled and 2
    # gather pieces
    "b3": (GLOBAL, dict(size=(384, 384), xy_min=(2000000.0, 1000000.0), xy_res=16000.0,
                        crs="epsg:3035")),
    # tests/test_srw.py:_case: a mild warp, the tiled SRW still wins
    "mild": (dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"),
             dict(size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035")),
    # a 96^2 UTM32N source under a 112^2 EPSG:3035 target that hangs over
    # it on every side: the hybrid plan's taps pass all four source edges
    "edges": (dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"),
              dict(size=(112, 112), xy_min=(4318960, 3377708), xy_res=100, crs="epsg:3035")),
}
JAX_MAKERS = {
    "make_srw_fn": "tiled", "make_srw_fn_batched": "batched",
    "make_srw_aligned_fn": "aligned", "make_srw_hybrid_fn": "hybrid",
}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    yield
    port_reproject._DEVICE_FN_CACHE.clear()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gms(case):
    src, tgt = CASES[case]
    return (
        (jx.GridMapping.regular(**src), jx.GridMapping.regular(**tgt)),
        (pt.GridMapping.regular(**src), pt.GridMapping.regular(**tgt)),
    )


def _data(case, seed=7, bands=3):
    """*bands* bands in [0, 1) on *case*'s source; band 1 (the only band
    when there is one) with a NaN row and a +inf column."""
    w, h = CASES[case][0]["size"]
    x = np.random.default_rng(seed).random((bands, h, w), dtype=np.float32)
    k = min(1, bands - 1)
    x[k, h // 4] = np.nan
    x[k, :, w // 3] = np.inf
    return x


def _assert_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got, ref)
    finite = ~np.isnan(ref)
    np.testing.assert_array_equal(np.signbit(got)[finite], np.signbit(ref)[finite])


def _spy_jax(monkeypatch):
    """Spies on JAX's SRW constructors, its dispatch and its direct gather:
    returns the list that each outermost ``make_srw_reproject_fn`` call
    appends (target gm, step, kind or None) to, and each
    ``make_fused_reproject_fn`` call (target gm, None, "gather")."""
    calls, kinds, depth = [], [], [0]
    for name, kind in JAX_MAKERS.items():
        orig = getattr(jsrw, name)

        def spy(*args, _orig=orig, _kind=kind, **kwargs):
            kinds.append(_kind)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(jsrw, name, spy)
    dispatch = jsrw.make_srw_reproject_fn

    def spy_dispatch(source_gm, target_gm, *args, **kwargs):
        depth[0] += 1
        try:
            fn = dispatch(source_gm, target_gm, *args, **kwargs)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            calls.append((target_gm, kwargs.get("step", 16), kinds[-1] if fn else None))
            kinds.clear()
        return fn

    monkeypatch.setattr(jsrw, "make_srw_reproject_fn", spy_dispatch)
    gather = jro.make_fused_reproject_fn

    def spy_gather(source_gm, target_gm, *args, **kwargs):
        calls.append((target_gm, None, "gather"))
        return gather(source_gm, target_gm, *args, **kwargs)

    monkeypatch.setattr(jro, "make_fused_reproject_fn", spy_gather)
    return calls


def _jax_pieces(jfn, calls, target_gm):
    """JAX's mosaic pieces as (r0, r1, c0, c1, window, step, kind): the
    rectangles and windows from the jitted fn's closure, each piece's step
    and variant from the spies' last call on its region."""
    inner = jfn.__wrapped__
    closure = dict(zip(inner.__code__.co_freevars, (c.cell_contents for c in inner.__closure__)))
    res = float(target_gm.x_res)
    by_rect = {}
    for gm, step, kind in calls:
        r0 = round((float(target_gm.y_max) - float(gm.y_max)) / res)
        c0 = round((float(gm.x_min) - float(target_gm.x_min)) / res)
        if kind is not None:
            by_rect[(r0, r0 + gm.height, c0, c0 + gm.width)] = (step, kind)
    return [
        (r0, r1, c0, c1, win) + by_rect[(r0, r1, c0, c1)]
        for r0, r1, c0, c1, win, _ in closure["pieces"]
    ]


def _port_pieces(fn):
    return [(p.r0, p.r1, p.c0, p.c1, p.window, p.step, p.kind) for p in fn.pieces]


_JAX_B3: dict = {}


def _jax_b3(monkeypatch, interp):
    """JAX's ``resample_in_space`` on the reduced BASELINE #3 with the
    switch on (3 bands): its output and its mosaic's pieces, computed once
    a method a module."""
    if interp not in _JAX_B3:
        (jsrc, jtgt), _ = _gms("b3")
        with monkeypatch.context() as m:
            m.setenv(SWITCH, "1")
            calls = _spy_jax(m)
            ref = jx.resample_in_space(_dataset(jsrc, jx, b=jnp.asarray(_data("b3"))),
                                       target_gm=jtgt, interp_methods=interp)
            (jfn,) = jax_reproject._DEVICE_FN_CACHE.values()
            jax_reproject._DEVICE_FN_CACHE.clear()
        _JAX_B3[interp] = (np.asarray(ref["b"].data), _jax_pieces(jfn, calls, jtgt))
    return _JAX_B3[interp]


def _replay_hybrid_plans(monkeypatch, jsrc, jtgt, interp):
    """Every ``plan_srw_hybrid`` call JAX's two-pass mosaic makes (planning
    only), as (source, target, step, plan)."""
    seen = []
    orig = jsrw.plan_srw_hybrid

    def spy(source_gm, target_gm, step=16, **kwargs):
        plan = orig(source_gm, target_gm, step=step, **kwargs)
        seen.append((source_gm, target_gm, step, plan))
        return plan

    monkeypatch.setattr(jsrw, "plan_srw_hybrid", spy)
    jsrw.make_region_reproject_fn(jsrc, jtgt, interp, np.nan)
    return seen


def _to_port_gm(gm):
    return pt.GridMapping.regular(
        size=tuple(gm.size), xy_min=(float(gm.x_min), float(gm.y_min)),
        xy_res=tuple(float(r) for r in gm.xy_res), crs=str(gm.crs),
        is_j_axis_up=bool(gm.is_j_axis_up),
    )


def _assert_plans_equal(jp, pp):
    assert (jp is None) == (pp is None)
    if jp is None:
        return
    for field in dataclasses.fields(jp):
        a, b = getattr(jp, field.name), getattr(pp, field.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


@pytest.mark.parametrize("case", ["extreme", "moderate", "edges", "b3_mosaic"])
def test_plan_srw_hybrid_copy_matches_jax(monkeypatch, case):
    """The port's ``plan_srw_hybrid`` equals JAX's on every field: on the
    whole domain of the extreme, moderate and edge cases, and on every
    call JAX's two-pass mosaic of the reduced BASELINE #3 makes (pieces at
    step 16 and, where those refuse, at step 4)."""
    if case != "b3_mosaic":
        (jsrc, jtgt), (psrc, ptgt) = _gms(case)
        jp = jsrw.plan_srw_hybrid(jsrc, jtgt)
        assert jp is not None
        _assert_plans_equal(jp, psrw.plan_srw_hybrid(psrc, ptgt))
        return
    (jsrc, jtgt), _ = _gms("b3")
    seen = _replay_hybrid_plans(monkeypatch, jsrc, jtgt, "bilinear")
    planned = Counter(step for *_, step, plan in seen if plan is not None)
    assert planned[4] >= 2 and planned[16] >= 1, planned
    for src, tgt, step, jp in seen:
        _assert_plans_equal(jp, psrw.plan_srw_hybrid(_to_port_gm(src), _to_port_gm(tgt), step=step))


@pytest.mark.parametrize("bands", [1, 3])
@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("case", ["moderate", "edges"])
def test_hybrid_plain_versions_match_jax(case, interp, bands):
    """K17 and K18's plain versions (``make_srw_hybrid_fn`` on CPU tensors)
    equal JAX's ``make_srw_hybrid_fn``, whose source padding, log2 shift
    passes and clipped takes they fold into one clamped tap index: on the
    moderate case's whole-domain plan and on a plan whose taps pass all
    four source edges (a numeric fill there), 1 and 3 bands."""
    (jsrc, jtgt), (psrc, ptgt) = _gms(case)
    jp, pp = jsrw.plan_srw_hybrid(jsrc, jtgt), psrw.plan_srw_hybrid(psrc, ptgt)
    if case == "edges":
        assert pp.base_v.min() < 0 and pp.base_v.max() + pp.d_v > pp.src_h
        assert pp.base_h.min() < 0 and pp.base_h.max() + pp.d_h > pp.src_w
    fill = -9999.0 if case == "edges" else np.nan
    x = _data(case, bands=bands)
    ref = jsrw.make_srw_hybrid_fn(jp, interp, fill)(jnp.asarray(x))
    fn = psrw.make_srw_hybrid_fn(pp, interp, fill, device=CPU)
    assert isinstance(fn, psrw.HybridSRWFn) and fn.kind == "hybrid"
    LAUNCHES.clear()
    _assert_equal(fn(torch.from_numpy(x)).numpy(), ref)
    assert not LAUNCHES  # CPU tensors: the plain versions
    v = srw_hybrid.srw_hybrid_vertical(*fn.vertical_args(torch.from_numpy(x)))
    assert v.shape == (bands, pp.out_h, pp.src_w)


@pytest.mark.parametrize("interp", ["bilinear", "nearest", "triangular"])
@pytest.mark.parametrize("case", ["extreme", "moderate", "b3", "mild"])
def test_dispatch_under_the_switch_takes_jax_kind(monkeypatch, case, interp):
    """With ``XRTPU_FAST_EXTREME_WARP=1`` (JAX) and ``allow_hybrid=True``
    (the port, as its reproject ladder passes it under the switch) both
    packages' SRW dispatch admit the hybrid (never for triangular) and skip
    the two-pass fidelity gate; the port builds JAX's variant, or None
    where JAX does: the hybrid on the extreme case, the aligned SRW on the
    moderate one, nothing on the reduced BASELINE #3, the tiled SRW on the
    mild case.  Outputs equal bit for bit on 3 bands."""
    monkeypatch.setenv(SWITCH, "1")
    (jsrc, jtgt), (psrc, ptgt) = _gms(case)
    calls = _spy_jax(monkeypatch)
    jfn = jsrw.make_srw_reproject_fn(jsrc, jtgt, interp, np.nan)
    pfn = psrw.make_srw_reproject_fn(psrc, ptgt, interp, np.nan, device=CPU, allow_hybrid=True)
    ((_, _, kind),) = calls
    expected = {"extreme": "hybrid", "moderate": "aligned", "b3": None, "mild": "tiled"}[case]
    if interp == "triangular" and case != "mild":
        expected = None
    assert kind == expected
    if kind is None:
        assert jfn is None and pfn is None
        return
    assert pfn.kind == kind
    x = _data(case)
    _assert_equal(pfn(torch.from_numpy(x)).numpy(), jfn(jnp.asarray(x)))


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_two_pass_mosaic_matches_jax_on_the_extreme_case(monkeypatch, interp):
    """``make_region_reproject_fn`` (two-pass, ``base_split=2``,
    ``max_depth=1``) on the extreme case: the same pieces as JAX's
    (rectangles, source windows, steps and variants: 2 hybrid, 1 aligned,
    1 tiled) covering the target, and, bilinear, an equal output on 3 bands
    (the reduced BASELINE #3 below runs both methods)."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("extreme")
    calls = _spy_jax(monkeypatch)
    jfn = jsrw.make_region_reproject_fn(jsrc, jtgt, interp, np.nan, base_split=2, max_depth=1)
    pfn = psrw.make_region_reproject_fn(psrc, ptgt, interp, np.nan, base_split=2, max_depth=1,
                                        device=CPU)
    assert isinstance(pfn, psrw.RegionSRWFn) and pfn.covered
    assert _port_pieces(pfn) == _jax_pieces(jfn, calls, jtgt)
    assert Counter(p.kind for p in pfn.pieces) == {"hybrid": 2, "aligned": 1, "tiled": 1}
    if interp == "nearest":
        return  # JAX's compile of the mosaic takes 5 s a method
    x = _data("extreme")
    _assert_equal(pfn(torch.from_numpy(x)).numpy(), jfn(jnp.asarray(x)))


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_two_pass_mosaic_matches_jax_on_the_reduced_b3(monkeypatch, interp):
    """The two-pass mosaic on the reduced BASELINE #3 (``base_split=4``,
    ``max_depth=3``): the pieces of JAX's mosaic as its ``resample_in_space``
    builds it under the switch (3 hybrid, 2 of them planned at step 4, 10
    aligned, 1 tiled and 2 K3 pieces), and JAX's output, bit for bit."""
    ref, jax_pieces = _jax_b3(monkeypatch, interp)
    _, (psrc, ptgt) = _gms("b3")
    pfn = psrw.make_region_reproject_fn(psrc, ptgt, interp, np.nan, device=CPU)
    assert _port_pieces(pfn) == jax_pieces
    kinds = Counter((p.kind, p.step) for p in pfn.pieces)
    assert kinds == {("hybrid", 4): 2, ("hybrid", 16): 1, ("aligned", 16): 10,
                     ("tiled", 16): 1, ("gather", None): 2}
    _assert_equal(pfn(torch.from_numpy(_data("b3"))).numpy(), ref)
    _assert_equal(pfn.plain(torch.from_numpy(_data("b3"))).numpy(), ref)


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_resample_in_space_under_the_switch_matches_jax(monkeypatch, interp):
    """``resample_in_space`` with ``XRTPU_FAST_EXTREME_WARP=1`` on the
    reduced BASELINE #3: no longer raises; the ladder's SRW tier refuses,
    the two-pass mosaic runs (a ``RegionSRWFn``, memoised under the
    switch's key) and equals JAX's output bit for bit, NaN masks included."""
    ref, _ = _jax_b3(monkeypatch, interp)
    monkeypatch.setenv(SWITCH, "1")
    _, (psrc, ptgt) = _gms("b3")
    got = pt.resample_in_space(_dataset(psrc, b=torch.from_numpy(_data("b3"))), target_gm=ptgt,
                               interp_methods=interp)
    (fn,) = port_reproject._DEVICE_FN_CACHE.values()
    assert isinstance(fn, psrw.RegionSRWFn)
    _assert_equal(got["b"].data.numpy(), ref)


def test_b3_piece_with_taps_short_of_its_positions_matches_jax():
    """One piece of the full BASELINE #3's two-pass mosaic (target rows
    256-511, columns 1024-1279, planned on its own source window at step 16:
    the hybrid, 25 horizontal taps): JAX's hybrid planner leaves 11
    horizontal positions of its last row tile outside their tap window,
    where JAX's output misses the direct bilinear by up to 0.18 on a smooth
    field.  The port reproduces the plan and the output bit for bit (the
    card's sanity line against the exact mosaic leaves those pixels out,
    ``chip_smoke.py``'s ``hybrid_tap_misses``)."""
    geo = dict(size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05, crs="epsg:4326")
    r0, r1, c0, c1 = 256, 512, 1024, 1280

    def piece(pkg):
        src = pkg.GridMapping.regular(**geo)
        tgt = pkg.GridMapping.regular(size=(r1 - r0, c1 - c0), xy_min=(
            2000000.0 + c0 * 1500.0, 1000000.0 + (4096 - r1) * 1500.0), xy_res=1500.0,
            crs="epsg:3035")
        return src, tgt

    (jsrc, jtgt), (psrc, ptgt) = piece(jx), piece(pt)
    jwin = jsrw._source_window_gm(jsrc, jsrw._coarse_geometry(jsrc, jtgt, 16), 8 + 48)
    pwin = psrw._source_window_gm(psrc, psrw._coarse_geometry(psrc, ptgt, 16), 8 + 48)
    assert jwin[1] == pwin[1] == (64, 285, 2720, 3444)
    jp = jsrw.plan_srw_hybrid(jwin[0], jtgt)
    pp = psrw.plan_srw_hybrid(pwin[0], ptgt)
    _assert_plans_equal(jp, pp)
    fn = psrw.make_srw_reproject_fn(pwin[0], ptgt, "bilinear", np.nan, device=CPU,
                                    allow_hybrid=True)
    assert fn.kind == "hybrid" and fn.window is None
    st = fn.state
    rows = torch.arange(st.out_h, dtype=torch.float32)[:, None]
    cols = torch.arange(st.out_w, dtype=torch.float32)[None, :]
    q = interp_field(st.ix_c, rows, cols, st.step) - st.s_h[:, None].float()
    k0 = st.base_h[torch.arange(st.out_h) // st.row_tile].float()
    assert int(((q < k0) | (q > k0 + st.d_h - 1)).sum()) == 11
    j0, j1, i0, i1 = pwin[1]
    yy, xx = np.mgrid[j0:j1, i0:i1].astype(np.float64)
    x = (np.sin(xx / 40) * np.cos(yy / 30)).astype(np.float32)
    ref = jsrw.make_srw_hybrid_fn(jp, "bilinear", np.nan)(jnp.asarray(x))
    _assert_equal(fn(torch.from_numpy(x)).numpy(), ref)


def test_region_fn_refuses_what_jax_refuses():
    """The two-pass mosaic takes bilinear and nearest only (None for
    triangular, as JAX); ``make_srw_hybrid_fn`` raises for triangular; both
    entry points default to the card."""
    (jsrc, jtgt), (psrc, ptgt) = _gms("b3")
    assert jsrw.make_region_reproject_fn(jsrc, jtgt, "triangular") is None
    assert psrw.make_region_reproject_fn(psrc, ptgt, "triangular", device=CPU) is None
    with pytest.raises(ValueError, match="bilinear"):
        psrw.make_srw_hybrid_fn(psrw.plan_srw_hybrid(*_gms("moderate")[1]), "triangular",
                                device=CPU)
    for entry in (psrw.make_region_reproject_fn, psrw.make_srw_hybrid_fn,
                  psrw.make_srw_reproject_fn):
        assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_k17_k18_entry_points_are_declared():
    """K17 and K18 launch K14's and K15's kernels, whose C entries take the
    tiles (a column tile, a row tile) with their argument types; K17 and
    K18 take up to ``plan_srw_hybrid``'s 32 taps a pass."""
    assert len(_build._SIGNATURES["xrt_srw_aligned_vertical_f32"]) == 17
    assert len(_build._SIGNATURES["xrt_srw_aligned_horizontal_f32"]) == 19
    assert not any("srw_hybrid" in name for name in _build._SIGNATURES)
    assert "srw_aligned.cu" in {p.name for p in _build.CSRC.iterdir()}
    assert srw_hybrid.MAX_TAPS == inspect.signature(jsrw.plan_srw_hybrid).parameters[
        "max_taps"].default
