"""K13's and K16's staged anchors (``csrc/esw_pixel.h``'s ``staged_tile``)
in a plain emulation of the kernels' tile walk, on the CPU.

A block of either kernel owns a tile of ``STAGE_TILE`` (16 x 128) target
pixels.  It bounds the window columns the tile's valid pixels tap from the
finite corners of ``ix_c`` around the tile's coarse cells (``_coarse_span``
repeats the bound in float32 and checks that it holds every valid pixel's
tap columns); where the span fits the stage (``stage_cols``: 128 columns,
96 for nearest; the emulation takes any capacity, so that small shapes
split their tiles between the two bodies, 0 for the per-pixel launch) it
computes the anchor ``m(r, c) = floor(iy*(r, c) - (S - 2) / 2)`` once for
every tile row and column of the span, the column lerps of ``iystar_c``
once a coarse row cell, and each pixel reads its anchors from there; a
wider span takes the per-pixel body.  ``_staged_esw`` walks the tiles the
same way in PyTorch, and is held bit for bit, NaN masks included, to
``esw_gather_plain``, to ``esw_mosaic_plain`` (each ESW piece of the mosaic
walked in its own tiles) and to the JAX package's ESW and region mosaic
(the mosaic with x64 off, as ``tests/test_torch_esw_mosaic.py`` runs it):
every method, a window with offsets, tiles straddling two coarse row cells
(step 12), ``c1`` clamped at the window's last column, nearest's selection
reaching ``S - 1``, NaN and +-inf rows and columns, and sheared tiles that
take the per-pixel body.  K13's band form walks the same tiles at global
target rows from its band's first row, its taps' rows clipped to the
source and read the band's offset up: the walk is held bit for bit to
``esw_gather_band_plain`` (itself held to JAX's sharded ESW by
``tests/test_torch_esw_sharded.py``) on every band of
``make_sharded_esw_step``'s bands, band 0 from its negative offset, a
ragged last band, bands of 12, 24 and 86 rows (tiles straddling band and
coarse-cell boundaries) and sheared tiles that fall back.  Inputs come
from a numpy seed, float32.  Plans, inputs and walks are cached across the
tests, and each test runs on one torch thread.
"""

import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu_torch import _build  # noqa: E402
from xcube_resampling_tpu_torch import parallel as ppar  # noqa: E402
from xcube_resampling_tpu.ops import esw as jesw  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw as pesw  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw_mosaic as pmos  # noqa: E402
from xcube_resampling_tpu_torch.ops.reproject_ops import (  # noqa: E402
    gather_piece_plain,
    interp_field,
    interp_taps_f32,
    lerp,
)
from xcube_resampling_tpu_torch.parallel.halo import crop_source  # noqa: E402
from tests.test_torch_esw import _data  # noqa: E402
from tests.test_torch_esw_mosaic import _data as _mosaic_data  # noqa: E402
from tests.test_torch_esw_sharded import SOURCE as GREENLAND  # noqa: E402
from tests.test_torch_esw_sharded import TARGET as GREENLAND_TARGET  # noqa: E402
from tests.test_torch_esw_sharded import _data as _greenland_data  # noqa: E402

F32 = torch.float32
CPU = torch.device("cpu")
METHODS = ("bilinear", "nearest", "triangular")
GLOBAL = dict(size=(720, 360), xy_min=(-180.0, -90.0), xy_res=0.5, crs="epsg:4326")
UTM = dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632")
# (source, target, step): tests/test_torch_esw.py's cases
CASES = {
    # past the gate: a window with offsets, S = 4
    "severe": (GLOBAL, dict(size=(512, 256), xy_min=(900000.0, 900000.0), xy_res=7000.0,
                            crs="epsg:3035"), 16),
    # the same at step 12: tiles of 16 rows straddle two coarse row cells
    "step12": (GLOBAL, dict(size=(512, 256), xy_min=(900000.0, 900000.0), xy_res=7000.0,
                            crs="epsg:3035"), 12),
    # the valid pixels tap the source's last row and column (c1 clamped)
    "edges": (UTM, dict(size=(80, 80), xy_min=(4324500, 3375500), xy_res=100,
                        crs="epsg:3035"), 16),
    # a target at 60 km, coarser than the source: the first column of
    # tiles spans more window columns than the stage holds, the second not
    "sheared": (GLOBAL, dict(size=(160, 32), xy_min=(900000.0, 900000.0), xy_res=60000.0,
                             crs="epsg:3035"), 16),
}
# the region mosaic: BASELINE #3's target at 24 km, 256^2 (2 ESW pieces of
# 128^2, S 4 and 5, and a group of 2 gather pieces)
MOSAIC = (GLOBAL, dict(size=(256, 256), xy_min=(2000000.0, 1000000.0), xy_res=24000.0,
                       crs="epsg:3035"))
# the cases held to JAX's ESW besides esw_gather_plain (each JAX function
# compiles for 1-5 s; esw_gather_plain is held to JAX's ESW on every case
# by tests/test_torch_esw.py): every method at the edges, the cheapest
JAX_RUNS = {("edges", "bilinear"), ("edges", "nearest"), ("edges", "triangular")}
# K13's band form: (source, target) of make_sharded_esw_step's steps,
# walked band by band
BAND_CASES = {
    # tests/test_torch_esw_sharded.py's: bands of 24 (n = 2) and 12 (n = 4)
    # target rows, halos of 8 and 14 source rows
    "greenland": (GREENLAND, GREENLAND_TARGET),
    # "severe" over 3 bands of 86 target rows: tiles straddle band and
    # coarse-cell boundaries; band 2's rows run past the target's 256
    "severe": CASES["severe"][:2],
    # "sheared" at 40 km and 64 rows, which the sharded ESW admits: tile
    # spans of 34 to 147 columns, so some tiles of each band fall back
    "sheared": (GLOBAL, dict(size=(160, 64), xy_min=(900000.0, 900000.0), xy_res=40000.0,
                             crs="epsg:3035")),
    # "edges" over 7 bands of 12 rows: band 4's valid pixels tap the
    # source's last row beside the 2 NaN rows that pad it to 7 bands of 14,
    # so its rows must clip to the source, not to the extension
    "edges": CASES["edges"][:2],
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _fn(case, method, fill=np.nan):
    src, tgt, step = CASES[case]
    fn = pesw.make_esw_reproject_fn(pt.GridMapping.regular(**src),
                                    pt.GridMapping.regular(**tgt), method, fill, step=step,
                                    device=CPU)
    assert fn is not None
    return fn


def _coarse_span(ix_c, step, rows, cols, bound_w, i_off, w, nearest):
    """The window columns [lo, hi] (lo > hi: none) that a tile of target
    rows and output columns (inclusive (first, last) pairs) may tap, as
    ``coarse_span`` bounds them: the finite corners of ix_c around the
    tile's coarse cells, a margin of 1 + |x| 2^-20, the clamp, floor (+1
    for rint), the second tap column, all in float32."""
    f32 = np.float32
    inv = f32(1.0 / step)
    ncj, nci = ix_c.shape

    def cell(v, n):
        return int(min(max(np.floor(f32(v) * inv), 0), n - 2))

    corners = ix_c.numpy()[cell(rows[0], ncj) : cell(rows[1], ncj) + 2,
                           cell(cols[0], nci) : cell(cols[1], nci) + 2]
    finite = corners[np.isfinite(corners)]
    if finite.size == 0:
        return 1, 0
    x_lo, x_hi = finite.min(), finite.max()
    margin = f32(1.0) + max(abs(x_lo), abs(x_hi)) * f32(2.0 ** -20)
    x_max = f32(bound_w - 1)
    x_lo = min(max(x_lo - margin, f32(0)), x_max)
    x_hi = min(max(x_hi + margin, f32(0)), x_max)
    lo = min(max(int(np.floor(x_lo)) - i_off, 0), w - 1)
    hi = min(max(int(np.floor(x_hi)) + (1 if nearest else 2) - i_off, 0), w - 1)
    return lo, hi


def _staged_esw(src, iystar_c, ix_c, iy_c, step, n_samples, out_h, out_w, bound_h, bound_w,
                j_off, i_off, interp, fill, capacity, row0=0, clip_h=None, row_off=0,
                tile_rows=16):
    """K13's staged kernel on the (B, H, W) window *src*, as its blocks walk
    the tiles; with *row0*, *clip_h* and *row_off* its band form's: output
    row 0 at global target row *row0*, the taps' rows clipped to [0,
    clip_h) (default: H), then read *row_off* rows up and clipped to the
    plane, in tiles of *tile_rows* rows.  Returns the output, (span,
    staged) per tile and the greatest selection s0 of a valid pixel's first
    tap column."""
    src = src.to(F32)
    h, w = src.shape[-2:]
    clip_h = h if clip_h is None else clip_h
    rows = torch.arange(row0, row0 + out_h, dtype=F32)[:, None]
    cols = torch.arange(out_w, dtype=F32)[None, :]
    ix = interp_field(ix_c, rows, cols, step)
    iy = interp_field(iy_c, rows, cols, step)
    valid = (ix > -0.5) & (ix < bound_w - 0.5) & (iy > -0.5) & (iy < bound_h - 0.5)
    ix = ix.clamp(0, bound_w - 1)
    iy = iy.clamp(0, bound_h - 1)
    nearest = interp == "nearest"
    if nearest:
        y0, i0 = torch.round(iy), torch.round(ix).long() - i_off
    else:
        y0 = torch.floor(iy)
        fy = iy - y0
        x0 = torch.floor(ix)
        fx = ix - x0
        i0 = x0.long() - i_off
    y0w = y0 - j_off
    half = (n_samples - 2) / 2.0
    s_max = n_samples - 1 if nearest else n_samples - 2
    taps = [i0.clamp(0, w - 1)] + ([] if nearest else [(i0 + 1).clamp(0, w - 1)])
    anchors = [torch.zeros((out_h, out_w), dtype=F32) for _ in taps]
    inv = 1.0 / step
    ncj, ncc = iystar_c.shape
    th, tw = tile_rows, pesw.STAGE_TILE[1]
    tiles = {}
    for r0 in range(0, out_h, th):
        for q0 in range(0, out_w, tw):
            tile = (slice(r0, r0 + th), slice(q0, q0 + tw))
            v = valid[tile]
            lo, hi = _coarse_span(ix_c, step, (row0 + r0, row0 + min(r0 + th, out_h) - 1),
                                  (q0, min(q0 + tw, out_w) - 1), bound_w, i_off, w, nearest)
            span = max(hi - lo + 1, 0)
            staged = span <= capacity and capacity > 0
            tiles[r0 // th, q0 // tw] = (span, staged)
            rr = rows[tile[0]]
            if v.any():  # the bound holds every valid pixel's tap columns
                assert lo <= int(taps[0][tile][v].min())
                assert int(taps[-1][tile][v].max()) <= hi
            else:  # no valid pixel: no anchor is read
                continue
            if not staged:  # the per-pixel body
                for m, c in zip(anchors, taps):
                    m[tile] = torch.floor(interp_field(iystar_c, rr, c[tile].to(F32), step)
                                          - half)
                continue
            # each column of the span: its cell once, its column lerps once
            # a coarse row cell, then the row lerp and the floor a tile row
            c = torch.arange(lo, lo + span, dtype=F32)[None, :]
            ci = c * inv
            ic = torch.floor(ci).to(torch.int64)
            fi = ci - ic
            ic = ic.clamp(0, ncc - 2)
            cj = rr * inv
            jc = torch.floor(cj).to(torch.int64)
            fj = cj - jc
            jc = jc.clamp(0, ncj - 2)
            cells, at = torch.unique(jc[:, 0], return_inverse=True)
            a0 = lerp(iystar_c[cells[:, None], ic], iystar_c[cells[:, None], ic + 1], fi)
            a1 = lerp(iystar_c[cells[:, None] + 1, ic], iystar_c[cells[:, None] + 1, ic + 1], fi)
            stage = torch.floor(lerp(a0[at], a1[at], fj) - half)  # (tile rows, span)
            for m, t in zip(anchors, taps):
                m[tile] = stage.gather(1, torch.where(v, t[tile] - lo, 0))
    def clip(r):
        return (r.clamp(0, clip_h - 1) - row_off).clamp(0, h - 1)

    rows_at = []
    for m in anchors:
        s0 = (y0w - m).clamp(0, s_max)
        r = (m + s0).long()
        rows_at.append((clip(r), clip(r + 1), s0))
    (ra0, rb0, s00), *rest = rows_at
    v00, v10 = src[..., ra0, taps[0]], src[..., rb0, taps[0]]
    if nearest:
        out = v00
    else:
        ((ra1, rb1, _),) = rest
        v01, v11 = src[..., ra1, taps[1]], src[..., rb1, taps[1]]
        if interp == "triangular":
            out = interp_taps_f32(v00, v01, v10, v11, fx, fy, interp)
        else:
            out = lerp(lerp(v00, v10, fy), lerp(v01, v11, fy), fx)
    out = torch.where(valid, out, torch.tensor(float(np.float32(fill)), dtype=F32))
    return out, tiles, float(s00[valid].max()) if valid.any() else None


@functools.lru_cache(maxsize=None)
def _inputs(case, method, fill=np.nan):
    """The case's fn, its 3-band numpy input (NaN and +-inf rows and
    columns), K13's wrapper arguments on it and esw_gather_plain's output."""
    fn = _fn(case, method, fill)
    data = _data("edges" if case == "edges" else "severe", fn.window)
    a = fn.args(fn.crop(torch.from_numpy(data)))
    return fn, data, a, pesw.esw_gather_plain(*a)


@functools.lru_cache(maxsize=None)
def _walk(case, method, fill=np.nan, capacity=None):
    """``_staged_esw`` of the case's fn on its input (:func:`_inputs`), its
    stage *capacity* columns (None: the kernels', ``stage_cols``)."""
    a = _inputs(case, method, fill)[2]
    capacity = pesw.stage_cols(method) if capacity is None else capacity
    return _staged_esw(*a[:12], a[12], a[13], capacity)


def _assert_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got, ref)


def _jax_esw(case, method, data):
    src, tgt, step = CASES[case]
    fn = jesw.make_esw_reproject_fn(jx.GridMapping.regular(**src),
                                    jx.GridMapping.regular(**tgt), method, np.nan, step=step)
    return np.asarray(fn(jnp.asarray(data)))


@pytest.mark.parametrize("case", ["severe", "step12", "edges"])
@pytest.mark.parametrize("method", METHODS)
def test_staged_esw_matches_plain_and_jax(case, method):
    """Every tile staged at the default capacity: the emulation equals
    esw_gather_plain (and, in ``JAX_RUNS``, JAX's ESW) on 3 bands with NaN
    and +-inf rows and columns, bit for bit."""
    fn, data, a, ref = _inputs(case, method)
    got, tiles, s0_max = _walk(case, method)
    assert all(staged for _, staged in tiles.values())
    assert max(span for span, _ in tiles.values()) > 1
    _assert_equal(got, ref)
    if (case, method) in JAX_RUNS:
        _assert_equal(got, _jax_esw(case, method, data))
    assert np.isfinite(got.numpy()).mean() > 0.2
    if case == "severe":  # a window with offsets
        assert fn.j_off > 0 and fn.i_off > 0
    if case == "step12":  # rows of a tile in two coarse row cells
        assert fn.step == 12 and fn.window is not None
    if case == "edges":
        # the valid pixels' second tap column clamped at the window's last
        valid, _, _, columns = pesw.esw_taps(tuple(a[0].shape[-2:]), *a[1:6], method, 0,
                                             *a[6:12], a[0].shape[-2], 0)
        assert int(columns[-1][2][valid].max()) == a[0].shape[-1] - 1
        if method == "nearest":  # the selection reaches S - 1
            assert s0_max == fn.n_samples - 1


@pytest.mark.parametrize("capacity", [0, 25, pesw.STAGE_COLS, 512])
@pytest.mark.parametrize("method", METHODS)
def test_staged_capacity_matches_plain(capacity, method):
    """Any capacity, from per pixel throughout (0, the launch with no
    stage) through tiles split between the two bodies to every tile staged,
    gives esw_gather_plain's bits, a numeric fill included."""
    got, tiles, _ = _walk("severe", method, -9999.0, capacity)
    _assert_equal(got, _inputs("severe", method, -9999.0)[3])
    staged = [s for _, s in tiles.values()]
    if capacity == 25:  # spans of 22 to 28 columns
        assert any(staged) and not all(staged)
    assert any(staged) == (capacity > 0)


@pytest.mark.parametrize("method", METHODS)
def test_sheared_tiles_fall_back(method):
    """A coarse, rotated target: some of its tiles span more window columns
    than the default stage holds and take the per-pixel body, the others
    stage; the output equals esw_gather_plain's."""
    got, tiles, _ = _walk("sheared", method)
    assert any(staged for _, staged in tiles.values())
    assert any(span > pesw.STAGE_COLS and not staged for span, staged in tiles.values())
    _assert_equal(got, _inputs("sheared", method)[3])


@pytest.mark.parametrize("case", ["severe", "step12", "edges", "sheared"])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_tile_spans_match_the_walk(case, method):
    """ops.esw.tile_spans gives the walk's span of every tile."""
    fn, _, a, _ = _inputs(case, method)
    _, tiles, _ = _walk(case, method)
    spans = pesw.tile_spans(a[2], fn.step, fn.out_h, fn.out_w, fn.src_w_g, fn.i_off,
                            a[0].shape[-1], method)
    assert {k: int(s) for k, s in np.ndenumerate(spans.numpy())} == {
        k: span for k, (span, _) in tiles.items()}


def _staged_mosaic(fn, x, capacity):
    """K16 on the whole (B, H, W) *x*: each ESW piece walked in its own
    tiles (``_staged_esw``), each gather piece as its plain version."""
    out = torch.full((x.shape[0], fn.out_h, fn.out_w), np.nan, dtype=F32)
    tiles = []
    for row in fn.table.tolist():
        ix_c, iy_c, ys = pmos._piece_fields(fn.fields, row)
        r0, c0, h, w = row[pmos.R0], row[pmos.C0], row[pmos.H], row[pmos.W]
        j0, i0 = row[pmos.J_OFF], row[pmos.I_OFF]
        window = x[..., j0 : j0 + row[pmos.WH], i0 : i0 + row[pmos.WW]]
        if row[pmos.KIND] == pmos.ESW:
            piece, t, _ = _staged_esw(window, ys, ix_c, iy_c, fn.step, row[pmos.SAMPLES], h, w,
                                      fn.src_h, fn.src_w, j0, i0, fn.interp_method,
                                      fn.fill_value, capacity)
            tiles += t.values()
        else:
            piece = gather_piece_plain(window, ix_c, iy_c, fn.step, h, w, fn.src_h, fn.src_w,
                                       j0, i0, fn.interp_method, fn.fill_value)
        out[..., r0 : r0 + h, c0 : c0 + w] = piece
    return out, tiles


@functools.lru_cache(maxsize=None)
def _port_mosaic(method):
    fn = pmos.make_esw_region_fn(*(pt.GridMapping.regular(**g) for g in MOSAIC), method,
                                 np.nan, device=CPU)
    assert fn is not None and fn.covered
    return fn


@functools.lru_cache(maxsize=None)
def _mosaic_walk(method, capacity):
    """``_staged_mosaic`` of the port's mosaic on the 3-band b3 input."""
    return _staged_mosaic(_port_mosaic(method), torch.from_numpy(_mosaic_data("b3")), capacity)


@pytest.mark.parametrize("method", METHODS)
def test_staged_mosaic_matches_plain(method):
    """The mosaic with its ESW pieces staged equals esw_mosaic_plain bit for
    bit, at 128 columns (every tile staged), at the kernels' width for the
    method (``stage_cols``) and at one that sends some tiles to the
    per-pixel body."""
    fn = _port_mosaic(method)
    assert sorted(kind for kind, *_ in fn.pieces) == ["esw", "esw", "gather", "gather"]
    x = torch.from_numpy(_mosaic_data("b3"))
    ref = fn.plain(x)
    # spans of 68 to 106
    for capacity, every in ((128, True), (pesw.stage_cols(method), method != "nearest"),
                            (80, False)):
        got, tiles = _mosaic_walk(method, capacity)
        assert all(s for _, s in tiles) == every and any(s for _, s in tiles)
        _assert_equal(got, ref)


def test_staged_mosaic_matches_jax():
    """The staged mosaic equals JAX's region mosaic (x64 off) on 3 bands."""
    x = _mosaic_data("b3")
    with jax.enable_x64(False):
        jfn = jesw.make_esw_region_fn(*(jx.GridMapping.regular(**g) for g in MOSAIC),
                                      "bilinear", np.nan)
        ref = np.asarray(jfn(jnp.asarray(x)))
    _assert_equal(_mosaic_walk("bilinear", 128)[0], ref)


# -- K13's band form -----------------------------------------------------------


def _band_source(case):
    """The case's source window as the sharded step takes it (``crop_source``)
    and its grid mappings: 2 or 3 bands in [0, 1) with NaN and +-inf rows
    and columns, also on the window's edges and its middle row."""
    src, tgt = (pt.GridMapping.regular(**g) for g in BAND_CASES[case])
    if case == "greenland":
        return torch.from_numpy(_greenland_data()), src, tgt
    x, src_c = crop_source(torch.from_numpy(_data("edges" if case == "edges" else "severe")),
                           src, tgt)
    x = x.clone()
    h, w = x.shape[-2:]
    x[2, 0], x[2, -1], x[2, :, 0], x[2, :, -1] = np.nan, np.inf, -np.inf, np.nan
    x[2, h // 2], x[2, : h // 3, w // 3] = np.inf, np.nan
    return x, src_c, tgt


@functools.lru_cache(maxsize=None)
def _bands(case, n, method, fill=np.nan):
    """K13's band-form arguments for every band of the case's sharded step
    over *n* CPU devices, the last band also ragged (5 rows short), each
    with esw_gather_band_plain's output."""
    x, src, tgt = _band_source(case)
    step, (pad, _) = ppar.make_sharded_esw_step(ppar.make_mesh(devices=[CPU] * n), src, tgt,
                                                interp_method=method, fill_value=fill,
                                                src_batch_dims=1)
    bands, _ = step.bands(torch.nn.functional.pad(x, (0, 0, 0, pad), value=np.nan))
    halos = step.exchange(bands)
    args = [step.gather_args(bands, halos, k) for k in range(n)]
    ragged = list(args[-1])
    ragged[6] -= 5
    args.append(tuple(ragged))
    return step, tuple((a, pesw.esw_gather_band_plain(*a)) for a in args)


def _band_walk_args(a):
    """``_staged_esw``'s arguments from K13's band-form arguments *a*
    (capacity last, to be appended)."""
    ext, iystar_c, ix_c, iy_c, step, s, out_h, out_w, interp, fill, row0, off, src_h = a
    return ((ext, iystar_c, ix_c, iy_c, step, s, out_h, out_w, src_h, ext.shape[-1], 0, 0,
             interp, fill), dict(row0=row0, clip_h=src_h, row_off=off))


@functools.lru_cache(maxsize=None)
def _band_walk(case, n, method, fill=np.nan, capacity=None, tile_rows=16):
    """``_staged_esw`` of each band of :func:`_bands` (the kernels' stage
    width for the method unless *capacity*) in tiles of *tile_rows* rows:
    (output, tiles) per band."""
    capacity = pesw.stage_cols(method) if capacity is None else capacity
    walks = []
    for a, _ in _bands(case, n, method, fill)[1]:
        pos, kw = _band_walk_args(a)
        got, tiles, _ = _staged_esw(*pos, capacity, **kw, tile_rows=tile_rows)
        walks.append((got, tiles))
    return walks


BAND_RUNS = [("greenland", 2), ("greenland", 4), ("severe", 3), ("sheared", 2), ("edges", 7)]


@pytest.mark.parametrize("case, n", BAND_RUNS)
@pytest.mark.parametrize("method", METHODS)
def test_band_walk_matches_plain(case, n, method):
    """The band form's walk at the kernels' stage width equals
    esw_gather_band_plain bit for bit, NaN masks included, on every band
    and a ragged last band: band 0 read from its negative offset, bands
    whose height is no multiple of the tile's 16 rows, rows clipped to the
    source's last row (edges), and tiles that take the per-pixel body
    (sheared); the wrapper with no stage gives the same bits."""
    step, bands = _bands(case, n, method)
    walks = _band_walk(case, n, method)
    clipped = False
    for (a, ref), (got, tiles) in zip(bands, walks):
        _assert_equal(got, ref)
        _assert_equal(pesw.esw_gather_band(*a, staged=False), ref)
        # the clip to the source's height gives other values than the
        # extension's own clip would
        unclipped = pesw._esw_plain(a[0], *a[1:6], method, a[9], a[10], a[6], a[7], a[12],
                                    a[0].shape[-1], 0, 0, 2**20, a[11])
        clipped |= not torch.equal(unclipped.isnan(), ref.isnan())
    assert np.isfinite(torch.cat([ref for _, ref in bands[:-1]], -2).numpy()).mean() > 0.2
    assert bands[0][0][11] < 0 and step.use_halo  # band 0 from its negative offset
    assert bands[-1][0][6] % 16  # the ragged last band
    assert clipped == (case == "edges" and method != "nearest")
    staged = [[s for _, s in t.values()] for _, t in walks]
    if case == "sheared":  # band 0's tiles partly fall back, the others stage
        assert not all(staged[0]) and all(map(any, staged))
    else:
        assert all(map(all, staged))
    if case == "severe":  # tiles straddle band and coarse-cell boundaries
        assert step.plan.out_band_h % 16 and step.plan.out_band_h % step.plan.step


@pytest.mark.parametrize("method", METHODS)
def test_band_capacity_splits_tiles(method):
    """At a stage of 25 columns the 86-row bands of "severe" (spans of 21
    to 28) split their tiles between the two bodies, and at 0 every tile
    takes the per-pixel body; with a numeric fill both give
    esw_gather_band_plain's bits on every band."""
    bands = _bands("severe", 3, method, -9999.0)[1]
    for capacity in (25, 0):
        walks = _band_walk("severe", 3, method, -9999.0, capacity)
        staged = [s for _, t in walks for _, s in t.values()]
        assert any(staged) == (capacity > 0) and not all(staged)
        for (_, ref), (got, _) in zip(bands, walks):
            _assert_equal(got, ref)


@pytest.mark.parametrize("case, n", BAND_RUNS)
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("tile_rows", [pesw.BAND_STAGE_ROWS, 11])
def test_band_walk_in_small_tiles_matches_plain(case, n, method, tile_rows):
    """Tiles of fewer rows that still stage, as a band too small to fill
    the card in 16-row tiles runs them (``ops.esw.band_tile_rows``): the
    walk still gives esw_gather_band_plain's bits on every band, its tiles
    straddling band and coarse-cell boundaries."""
    for (_, ref), (got, tiles) in zip(_bands(case, n, method)[1],
                                      _band_walk(case, n, method, tile_rows=tile_rows)):
        _assert_equal(got, ref)
        assert len(tiles) == -(-ref.shape[-2] // tile_rows) * -(-ref.shape[-1] // 128)


def test_band_tile_rows():
    """The band form's rows a tile on a card of 132 SMs: 16 where the
    band's 16-row tiles fill one wave of 12 blocks an SM, else as few as
    spread its rows over that wave, at least 2; tiles of 8 rows or more
    stage."""
    assert pesw.BAND_STAGE_ROWS == 8
    assert pesw.band_tile_rows(1024, 4096, 132) == 16  # the ESW cell's bands
    assert pesw.band_tile_rows(792, 4096, 132) == 16  # 50 x 32 tiles: one wave
    assert pesw.band_tile_rows(776, 4096, 132) == 16  # 49 x 32 tiles, just short: 16 all the same
    assert pesw.band_tile_rows(512, 4096, 132) == 11  # 1024 tiles: 47 x 32 of 11 rows
    assert pesw.band_tile_rows(128, 512, 132) == 2  # the sheared 512^2 target's bands
    assert pesw.band_tile_rows(1, 40, 132) == 2


@pytest.mark.parametrize("case, n", BAND_RUNS)
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("tile_rows", [16, 11])
def test_tile_spans_match_the_band_walk(case, n, method, tile_rows):
    """ops.esw.tile_spans with the band's first row and tile height gives
    the band walk's span of every tile."""
    for (a, _), (_, tiles) in zip(_bands(case, n, method)[1],
                                  _band_walk(case, n, method, tile_rows=tile_rows)):
        width = a[0].shape[-1]
        spans = pesw.tile_spans(a[2], a[4], a[6], a[7], width, 0, width, method, row0=a[10],
                                tile_rows=tile_rows)
        assert {k: int(s) for k, s in np.ndenumerate(spans.numpy())} == {
            k: span for k, (span, _) in tiles.items()}


def test_band_entry_takes_the_staged_flag():
    """The band form's C entry takes *staged* before the stream, as K13's
    does; the wrapper stages by default."""
    assert len(_build._SIGNATURES["xrt_esw_gather_band_f32"]) == 22
    assert len(_build._SIGNATURES["xrt_esw_gather_f32"]) == 23
    assert inspect.signature(pesw.esw_gather_band).parameters["staged"].default is True
    source = (_build.CSRC / "esw_gather.cu").read_text()
    assert "int64_t row0, int64_t off, int64_t src_h, int staged," in source
