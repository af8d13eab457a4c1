"""The staged tap passes of the aligned and hybrid SRW (K14/K17 and K15/K18,
``csrc/srw_aligned.cu``) on the CPU: their launch planners and a plain
PyTorch emulation of their arithmetic (``ops/srw_aligned.py``:
``vertical_emulation``, ``horizontal_emulation``: the taps
staged in shifted space, the exact two-tap shortcut where a window is
finite, every tap where it is not) held to the plain versions bit for bit,
NaN masks and the signs of zeros included.

Synthetic cases place each output's first weighing tap at -1, 0, 1, the
middle, d - 2, d - 1 and past the taps, at integer positions and nearest's
half ties, with NaN, +-inf and signed zeros at weighted and zero-weight
taps; the real plans are the hybrid's "extreme", "moderate" and "edges"
geometries of ``tests/test_torch_srw_hybrid.py``, a hybrid piece of the
reduced BASELINE #3's two-pass mosaic and the 512^2 flagship's aligned
plan.  Inputs come from a numpy seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xcube_resampling_tpu_torch import GridMapping  # noqa: E402
from xcube_resampling_tpu_torch import entry as port_entry  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as psrw  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw_aligned as sa  # noqa: E402

CPU = torch.device("cpu")
GLOBAL = dict(size=(720, 360), xy_min=(-180.0, -90.0), xy_res=0.5, crs="EPSG:4326")
UTM96 = dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632")
TARGETS = {
    "extreme": dict(size=(512, 512), xy_min=(900000.0, 900000.0), xy_res=10000.0,
                    crs="EPSG:3035"),
    "moderate": dict(size=(512, 256), xy_min=(900000.0, 900000.0), xy_res=7000.0,
                     crs="EPSG:3035"),
    "edges": dict(size=(112, 112), xy_min=(4318960, 3377708), xy_res=100, crs="epsg:3035"),
    "b3": dict(size=(384, 384), xy_min=(2000000.0, 1000000.0), xy_res=16000.0, crs="epsg:3035"),
}
METHODS = ("bilinear", "nearest")
_PLANS = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(got, ref):
    """Bit for bit: values, NaN masks and the signs of zeros."""
    got, ref = got.numpy(), ref.numpy()
    np.testing.assert_array_equal(got, ref)
    finite = ~np.isnan(ref)
    np.testing.assert_array_equal(np.signbit(got[finite]), np.signbit(ref[finite]))


def hybrid_plan(case):
    """The hybrid plan of a real geometry (state on the CPU)."""
    if case not in _PLANS:
        if case == "b3":
            fn = psrw.make_region_reproject_fn(GridMapping.regular(**GLOBAL),
                                               GridMapping.regular(**TARGETS["b3"]),
                                               "bilinear", np.nan, device=CPU)
            piece = next(p for p in fn.pieces if p.kind == "hybrid" and p.step == 4)
            _PLANS[case] = piece.fn.state
        else:
            src = GridMapping.regular(**(UTM96 if case == "edges" else GLOBAL))
            plan = psrw.plan_srw_hybrid(src, GridMapping.regular(**TARGETS[case]))
            _PLANS[case] = psrw.hybrid_plan_to_device(plan, CPU)
    return _PLANS[case]


def aligned_plan():
    if "aligned" not in _PLANS:
        plan = psrw.plan_srw_aligned(*port_entry.flagship_gms(512, 512), max_taps=24)
        _PLANS["aligned"] = psrw.aligned_plan_to_device(plan, CPU)
    return _PLANS["aligned"]


def data(shape, seed, special=True):
    """Values in [-1, 1) with exact zeros of both signs; with *special* a
    NaN row and a +inf column in the first band, a -inf row in the last."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = 0.0
    x[rng.random(shape) < 0.05] = -0.0
    if special:
        h, w = shape[-2:]
        x[0, h // 3] = np.nan
        x[0, :, w // 2] = np.inf
        x[-1, (2 * h) // 3] = -np.inf
    return torch.from_numpy(x)


def state_args(st):
    base_v = st.base_v.reshape(st.out_h, -1)
    base_h = st.base_h.reshape(-1, st.out_w)
    col_tile = getattr(st, "col_tile", st.src_w)
    row_tile = getattr(st, "row_tile", st.out_h)
    return base_v, base_h, col_tile, row_tile


def vertical_pair(st, src, interp):
    base_v, _, col_tile, _ = state_args(st)
    plan = sa.plan_vertical(base_v.numpy(), col_tile, st.d_v, st.src_w)
    assert not plan.direct
    tile = torch.arange(st.src_w) // col_tile
    ref = sa.vertical_plain(src, st.iystar_c, st.step, st.s_v, base_v.long()[:, tile], st.d_v,
                            interp)
    got = sa.vertical_emulation(src, st.iystar_c, st.step, st.s_v, base_v, col_tile,
                                       st.d_v, interp, plan)
    return got, ref


def horizontal_pair(st, v, interp, fill, words):
    _, base_h, _, row_tile = state_args(st)
    tile = torch.arange(st.out_h) // row_tile
    ref = sa.horizontal_plain(v, st.ix_c, st.iy_c, st.step, st.s_h, base_h.long()[tile, :],
                              st.d_h, st.src_h, interp, fill)
    got = sa.horizontal_emulation(v, st.ix_c, st.iy_c, st.step, st.s_h, base_h,
                                         row_tile, st.d_h, st.src_h, interp, fill, words)
    return got, ref


# -- the shortcut's cases, built tap by tap -----------------------------------

D = 6
# first weighing tap a (relative to the base) of each output column, and
# its fraction: -1, 0, 1, the middle, d - 2, d - 1, past the end, before the
# start; integer positions; nearest's half ties
OFFSETS = [-1, 0, 1, D // 2, D - 2, D - 1, D, -2]
FRACTIONS = [0.0, 0.25, 0.5, 0.75, 0.999]


def synthetic(seed, bands, special):
    """A vertical pass over out_h = 40 rows and src_w = 40 columns (two
    column tiles of 32 and 8), step 1 (each position is its coarse
    value), with every (offset, fraction) pair; taps read a source whose
    values are signed zeros, NaN and +-inf at chosen rows."""
    rng = np.random.default_rng(seed)
    out_h, src_w, src_h = 40, 40, 60
    base = rng.integers(-2, src_h - D + 2, size=(out_h, 2)).astype(np.int32)
    s_v = rng.integers(0, 5, size=src_w).astype(np.int32)
    col_tile = 32
    tile = np.arange(src_w) // col_tile
    a = np.array(OFFSETS)[rng.integers(0, len(OFFSETS), size=(out_h, src_w))]
    frac = np.array(FRACTIONS)[rng.integers(0, len(FRACTIONS), size=(out_h, src_w))]
    pos = base[:, tile] + a + frac  # in shifted space
    field = np.zeros((out_h + 1, src_w + 1), np.float32)
    field[:out_h, :src_w] = pos + s_v[None, :]
    src = data((bands, src_h, src_w), seed + 1, special)
    return src, torch.from_numpy(field), torch.from_numpy(s_v), torch.from_numpy(base), col_tile


@pytest.mark.parametrize("bands", [1, 3])
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("interp", METHODS)
def test_vertical_shortcut_cases(interp, special, bands):
    src, field, s_v, base, col_tile = synthetic(11 + bands, bands, special)
    plan = sa.plan_vertical(base.numpy(), col_tile, D, src.shape[-1])
    assert plan.rows == 8 and not plan.direct  # a small launch: the fewest rows
    tile = torch.arange(src.shape[-1]) // col_tile
    ref = sa.vertical_plain(src, field, 1, s_v, base.long()[:, tile], D, interp)
    got = sa.vertical_emulation(src, field, 1, s_v, base, col_tile, D, interp, plan)
    same(got, ref)
    # the zeros: outputs whose weighted taps sum to +-0 take every tap
    assert (ref == 0).any()


@pytest.mark.parametrize("fill", [np.nan, -9.5])
@pytest.mark.parametrize("bands", [1, 3])
@pytest.mark.parametrize("interp", METHODS)
def test_horizontal_shortcut_cases(interp, bands, fill):
    """The horizontal pass on the same construction transposed: out_h = 24
    rows (row tiles of 8) by out_w = 200 columns (7 warps' spans, the last
    ragged), shifts a row, positions from the coarse ix at step 1, iy
    inside the source but on some columns, which take the fill."""
    rng = np.random.default_rng(5 + bands)
    out_h, out_w, src_w, src_h, row_tile = 24, 200, 90, 30, 8
    base = rng.integers(-2, src_w - D + 2, size=(out_h // row_tile, out_w)).astype(np.int32)
    s_h = rng.integers(0, 7, size=out_h).astype(np.int32)
    a = np.array(OFFSETS)[rng.integers(0, len(OFFSETS), size=(out_h, out_w))]
    frac = np.array(FRACTIONS)[rng.integers(0, len(FRACTIONS), size=(out_h, out_w))]
    pos = base[np.arange(out_h) // row_tile] + a + frac
    ix = np.zeros((out_h + 1, out_w + 1), np.float32)
    ix[:out_h, :out_w] = pos + s_h[:, None]
    iy = np.full_like(ix, 3.0)
    iy[:, ::17] = -1.0  # outside the source: the fill
    v = data((bands, out_h, src_w), 21 + bands)
    base_t = torch.from_numpy(base)
    ref = sa.horizontal_plain(v, torch.from_numpy(ix), torch.from_numpy(iy), 1,
                              torch.from_numpy(s_h), base_t.long()[np.arange(out_h) // row_tile],
                              D, src_h, interp, fill)
    for words in (False, True):
        got = sa.horizontal_emulation(v, torch.from_numpy(ix), torch.from_numpy(iy), 1,
                                             torch.from_numpy(s_h), base_t, row_tile, D, src_h,
                                             interp, fill, words)
        same(got, ref)


def test_shortcut_signed_zeros():
    """Where the weighted taps sum to -0, a later zero-weight tap of a
    positive value makes the full sum +0 (no initial zero); the shortcut
    alone would keep -0, so such outputs take every tap."""
    src = torch.tensor([[[-0.0], [-0.0], [1.0], [-2.0]]])  # one column, 4 rows
    field = torch.zeros((3, 3))
    base = torch.zeros((2, 1), dtype=torch.int32)
    s_v = torch.zeros(1, dtype=torch.int32)
    for interp in METHODS:
        plan = sa.plan_vertical(base.numpy(), 1, 4, 1)
        got = sa.vertical_emulation(src, field, 1, s_v, base, 1, 4, interp, plan)
        ref = sa.vertical_plain(src, field, 1, s_v, base.long(), 4, interp)
        assert not np.signbit(ref.numpy()).any() and (ref == 0).all()
        same(got, ref)


# -- the real plans -----------------------------------------------------------


@pytest.mark.parametrize("interp", METHODS)
@pytest.mark.parametrize("case", ["extreme", "moderate", "edges", "b3", "aligned"])
def test_emulation_matches_plain_on_real_plans(case, interp):
    st = aligned_plan() if case == "aligned" else hybrid_plan(case)
    bands = 3 if case in ("edges", "b3") else 1
    src = data((bands, st.src_h, st.src_w), 7)
    got_v, ref_v = vertical_pair(st, src, interp)
    same(got_v, ref_v)
    for fill, words in ((np.nan, False), (-9999.0, True)):
        same(*horizontal_pair(st, ref_v, interp, fill, words))
    # NaN-free data: the finite windows take the shortcut throughout
    clean = data((1, st.src_h, st.src_w), 8, special=False)
    same(*vertical_pair(st, clean, interp))


# -- the launch planners ------------------------------------------------------


def _vertical_spans(base_v, rows, d_v):
    """(n_rb, n_tiles, 2) by a scan of each block's rows."""
    out_h, n_tiles = base_v.shape
    n_rb = -(-out_h // rows)
    out = np.zeros((n_rb, n_tiles, 2), np.int64)
    for rb in range(n_rb):
        for t in range(n_tiles):
            b = base_v[rb * rows:(rb + 1) * rows, t].astype(np.int64)
            out[rb, t] = b.min(), b.max() + d_v
    return out


@pytest.mark.parametrize("case", ["extreme", "moderate", "edges", "b3", "aligned"])
def test_planned_spans_hold_every_tap(case):
    """Each span equals a scan of its block's bases; every tap a block reads
    (its staged row or column, from the shifted span's first) lies inside
    the span, and each span inside the planned extent."""
    st = aligned_plan() if case == "aligned" else hybrid_plan(case)
    base_v, base_h, col_tile, row_tile = state_args(st)
    bv, bh = base_v.numpy(), base_h.numpy()
    pv = sa.plan_vertical(bv, col_tile, st.d_v, st.src_w)
    spans = pv.lohi.numpy()
    np.testing.assert_array_equal(spans, _vertical_spans(bv, pv.rows, st.d_v))
    assert (spans[..., 1] - spans[..., 0]).max() == pv.extent
    tile = np.arange(st.src_w) // col_tile if bv.shape[1] > 1 else np.zeros(st.src_w, int)
    rb = np.arange(st.out_h) // pv.rows
    first = bv[:, tile] - spans[rb][:, tile, 0]
    assert first.min() >= 0
    assert (first + st.d_v <= (spans[..., 1] - spans[..., 0])[rb][:, tile]).all()
    # the horizontal warps' spans in v's columns: a scan of each warp's
    # bases plus the row's shift, every tap's column inside its span
    spans = sa.horizontal_spans(bh, st.d_h)
    s_h = st.s_h.numpy().astype(np.int64)
    u = np.minimum(np.arange(st.out_h) // row_tile, bh.shape[0] - 1)
    w = sa.HORI_SPAN_COLS
    for k in range(-(-st.out_w // w)):
        seg = bh[:, k * w:(k + 1) * w].astype(np.int64)
        lo = seg.min(axis=1)[u] + s_h
        hi = seg.max(axis=1)[u] + st.d_h + s_h
        np.testing.assert_array_equal(spans[u, k] + s_h[:, None], np.stack([lo, hi], axis=-1))
        taps = seg[u] + s_h[:, None]  # each column's tap 0 in v
        assert (taps >= lo[:, None]).all() and (taps + st.d_h <= hi[:, None]).all()


def test_planner_alternatives():
    """Fewer rows a block where 64 do not fit, the direct kernel where 8 do
    not or the column tiles are not whole blocks."""
    rng = np.random.default_rng(3)
    gentle = np.cumsum(rng.integers(0, 2, size=(256, 1)), axis=0).astype(np.int32)
    assert sa.plan_vertical(gentle, 32, 8, 4096).rows == 64
    assert sa.plan_vertical(gentle, 32, 8, 64).rows == 8  # 2 column blocks: spread
    steep = (np.arange(256)[:, None] * 12).astype(np.int32)  # 12 rows an output row
    p = sa.plan_vertical(steep, 32, 8, 4096)
    assert not p.direct and p.rows == 16 and p.extent == 15 * 12 + 8
    cliff = (np.arange(64)[:, None] * 250).astype(np.int32)
    assert sa.plan_vertical(cliff, 32, 8, 4096).direct
    assert sa.plan_vertical(np.zeros((8, 3), np.int32), 48, 4, 144).direct
    assert not sa.plan_vertical(np.zeros((8, 1), np.int32), 48, 4, 48).direct
    # the horizontal kernel's rows a group: 8, fewer for small launches
    assert sa.horizontal_rows(2048, 2048) == 8 and sa.horizontal_rows(4096, 4096) == 8
    assert sa.horizontal_rows(512, 512) == 4 and sa.horizontal_rows(256, 256) == 1


@pytest.mark.parametrize("case", ["extreme", "moderate", "edges", "b3", "aligned"])
def test_states_carry_the_vertical_plan(case):
    """Each state holds the vertical launch planned once for its bases
    (``win_v``), as the wrappers would plan it; on the CPU the wrappers
    asked for flags give ``(v, None)``, and the fn through them equals its
    plain version."""
    st = aligned_plan() if case == "aligned" else hybrid_plan(case)
    base_v, _, col_tile, _ = state_args(st)
    want = sa.plan_vertical(base_v.numpy(), col_tile, st.d_v, st.src_w)
    assert (st.win_v.rows, st.win_v.extent) == (want.rows, want.extent)
    np.testing.assert_array_equal(st.win_v.lohi.numpy(), want.lohi.numpy())
    assert st.win_v.lohi.device == st.base_v.device
    fn = (psrw.AlignedSRWFn if case == "aligned" else psrw.HybridSRWFn)(st, "bilinear", np.nan)
    src = data((1, st.src_h, st.src_w), 9, special=False)
    v, flags = fn.vertical(src)
    assert flags is None
    same(v, fn._vertical(*fn.vertical_args(src)))
    same(fn(src), fn.plain(src))


def test_host_mirrors_the_kernels_constants():
    """The planner's and the emulation's constants are the kernels':
    the vertical block's columns (also the flag words' width), the
    horizontal block's columns and rows a group, the blocks a launch
    spreads to."""
    import re

    from xcube_resampling_tpu_torch import _build

    text = (_build.CSRC / "srw_aligned.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert sa.VERT_COLS == constant("kVCols") == sa.HORI_SPAN_COLS
    assert sa.HORI_ROWS == constant("kHRows") and sa.HORI_COLS == constant("kHThreads")
    assert sa.SPREAD_BLOCKS == constant("kSpreadBlocks")
    assert "constexpr int kHWord = kVCols;" in text
