"""K12's cull rule on the CPU: the triangle boxes and candidate pairs of
``xcube_resampling_tpu_torch/csrc/hybrid_phase_a.cu``, mirrored in
``ops.rectify_ops`` (``hybrid_tri_boxes``, ``hybrid_dense_pairs``,
``hybrid_dense_plain(cull=True)``), against the plain dense scan and the
JAX package's float64 hybrid dense kernel.

K12 solves only the (pixel, triangle) pairs whose pixel centre lies in
the triangle's box; its map equals the scan over every window quad only if
no pair that accepts lies outside its box.  Expected, and asserted, on the
OLCI-like swath at a small size, on rotated and sheared lattices, on
near-collinear slivers, folded rows and NaN nodes, at tiles 16 and 8:

* every pair that accepts under the plain version's own arithmetic (its
  emulated fused multiply-adds) is a candidate, so every quad that accepts
  a pixel is in the candidate list of the pixel's warp;
* the scan over the candidates alone gives the plain version's map and
  ``tested`` bit for bit, and JAX's dense map bit for bit;
* ``solved`` counts at least the winner's pair where there is one.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
from xcube_resampling_tpu.constants import UV_DELTA  # noqa: E402
from xcube_resampling_tpu.ops import rectify_ops as jro  # noqa: E402
from xcube_resampling_tpu_torch.ops import rectify_ops as pro  # noqa: E402

from tests.sampledata import create_olci_like_swath  # noqa: E402

MARGIN = 2


def _olci_small():
    """R1's geometry at a small size: the OLCI-like swath onto its default
    grid, in the target's pixel units."""
    ds = create_olci_like_swath(width=64, height=80, tile_size=32)
    gm = jx.GridMapping.from_dataset(ds)
    tgt = gm.to_regular(tile_size=32)
    xy = np.asarray(gm.xy_coords.data, dtype=np.float64)
    x1, _, _, y2 = tgt.xy_bbox
    return (xy[0] - x1) / tgt.x_res, (xy[1] - y2) / -tgt.y_res, (tgt.height, tgt.width)


def _lattices():
    """The hard lattices (``chip_smoke.hard_lattices`` holds K12 to the
    plain version on the same kinds on the card)."""
    jj, ii = np.mgrid[0:30, 0:34].astype(np.float64)
    a = 0.6
    rotated = (20 + 0.9 * (np.cos(a) * ii - np.sin(a) * jj),
               2 + 0.9 * (np.sin(a) * ii + np.cos(a) * jj))
    sheared = (3 + 1.1 * ii + 0.7 * jj, 2 + 0.3 * ii + 0.95 * jj)
    # column pairs 1e-12 and 1e-14 of an edge apart (the latter past the
    # box's derived range: boxes over every pixel), a row pair 1e-9
    sx, sy = (c.copy() for c in sheared)
    for col, gap in ((13, 1e-12), (26, 1e-14)):
        sx[:, col + 1] = sx[:, col] + gap * 1.1
        sy[:, col + 1] = sy[:, col] + gap * 0.3
    sx[21] = sx[20] + 1e-9 * 0.7
    sy[21] = sy[20] + 1e-9 * 0.95
    fold_y = sheared[1].copy()
    fold_y[15:] = fold_y[14] - 0.8 * (fold_y[15:] - fold_y[14])
    # a NaN node is corner p0 of the quad below right of it and p3 of the
    # quad above left; the first node is p0 alone, the last p3 alone
    p0x, p0y = (c.copy() for c in rotated)
    p0x[0, 0] = np.nan
    p0x[8, 9] = np.nan
    p3x, p3y = (c.copy() for c in rotated)
    p3y[-1, -1] = np.nan
    p3y[16, 12] = np.nan
    dst = (44, 52)
    return {
        "rotated": (*rotated, (36, 44)), "sheared": (*sheared, dst), "slivers": (sx, sy, dst),
        "folded": (sheared[0], fold_y, dst), "NaN p0": (p0x, p0y, (36, 44)),
        "NaN p3": (p3x, p3y, (36, 44)),
    }


@functools.lru_cache(maxsize=None)
def _case(name):
    if name == "R1 small":
        return _olci_small()
    return _lattices()[name]


CASES = ["R1 small", "rotated", "sheared", "slivers", "folded", "NaN p0", "NaN p3"]


def _seeded(gx, gy, dst, tile):
    """K11's seed (plain) and the dense kernel's arguments: the window is
    the seed's needs' bucket, or the swath's first 48 nodes where none
    covers them (the gate refuses folded and NaN swaths; K12 runs on them
    all the same)."""
    gx, gy = torch.from_numpy(gx), torch.from_numpy(gy)
    cqj, cqi, meta = pro.hybrid_seed_plain(gx, gy, dst, tile, float(max(dst)), MARGIN)
    _, need_j, need_i = meta.tolist()
    win_j = pro.hybrid_window(need_j, gx.shape[0]) or min(48, gx.shape[0])
    win_i = pro.hybrid_window(need_i, gx.shape[1]) or min(48, gx.shape[1])
    return gx, gy, cqj, cqi, dst, UV_DELTA, tile, win_j, win_i, MARGIN


@functools.lru_cache(maxsize=None)
def _dense_args(name, tile):
    return _seeded(*_case(name), tile)


@functools.lru_cache(maxsize=None)
def _plain(name, tile):
    """The plain version's map and tested (the scan over every quad)."""
    args = _dense_args(name, tile)
    tested = torch.empty(args[4], dtype=torch.int32)
    return pro.hybrid_dense_plain(*args, tested=tested), tested


def _assert_candidates(args):
    """Every accepting pair is a candidate; returns the pairs that accept
    and the candidates."""
    accepted = candidates = 0
    for c in pro.hybrid_dense_pairs(*args, boxes=True):
        assert not (c.ok_a & ~c.cand_a).any()
        assert not (c.ok_b & ~c.cand_b).any()
        accepted += int(c.ok_a.sum() + c.ok_b.sum())
        candidates += int(c.cand_a.sum() + c.cand_b.sum())
    return accepted, candidates


def _assert_scan_equal(args, plain=None):
    """The scan over the candidates alone equals the plain scan (map and
    tested, bit for bit); returns its map, tested and solved."""
    dst = args[4]
    if plain is None:
        tested = torch.empty(dst, dtype=torch.int32)
        ref = pro.hybrid_dense_plain(*args, tested=tested)
    else:
        ref, tested = plain
    t_cull, solved = torch.empty_like(tested), torch.empty_like(tested)
    got = pro.hybrid_dense_plain(*args, tested=t_cull, solved=solved, cull=True)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(t_cull.numpy(), tested.numpy())
    return got, tested, solved


@pytest.mark.parametrize("tile", [16, 8])
@pytest.mark.parametrize("name", CASES)
def test_accepting_pairs_are_candidates(name, tile):
    """No pair that accepts lies outside its triangle's box, so each quad
    that accepts a pixel is in its warp's candidate list; the boxes cull
    most pairs."""
    accepted, candidates = _assert_candidates(_dense_args(name, tile))
    assert accepted > 0
    gx, _, dst = _case(name)
    pairs = dst[0] * dst[1] * 2 * (gx.shape[0] - 1) * (gx.shape[1] - 1)
    assert candidates < pairs / 20


@pytest.mark.parametrize("tile", [16, 8])
@pytest.mark.parametrize("name", CASES)
def test_candidate_scan_equals_the_plain_version(name, tile):
    """The scan over the candidates alone gives the plain version's map
    and tested bit for bit; solved counts the winner's pair at least."""
    args = _dense_args(name, tile)
    got, tested, solved = _assert_scan_equal(args, _plain(name, tile))
    found = ~torch.isnan(got[0])
    assert found.any()
    assert bool((solved[found] >= 1).all())
    n_q = (args[7] - 1) * (args[8] - 1)
    assert bool((tested[~found] == n_q).all()) and bool((tested[found] <= n_q).all())


@functools.lru_cache(maxsize=None)
def _jax_dense(src_shape, dst, tile, win_j, win_i):
    return jro._build_hybrid_dense_kernel(src_shape, dst, jnp.float64, UV_DELTA, tile, win_j,
                                          win_i, MARGIN)


@pytest.mark.parametrize("name", CASES)
def test_candidate_scan_matches_jax(name):
    """The scan over the candidates alone equals JAX's float64 hybrid dense
    kernel bit for bit on the same seed and window (tile 16)."""
    args = _dense_args(name, 16)
    gx, gy, cqj, cqi, dst, _, tile, win_j, win_i, _ = args
    ref = np.asarray(_jax_dense(tuple(gx.shape), dst, tile, win_j, win_i)(
        gx.numpy(), gy.numpy(), cqj.numpy(), cqi.numpy()))
    np.testing.assert_array_equal(_plain(name, 16)[0].numpy(), ref)
    np.testing.assert_array_equal(pro.hybrid_dense_plain(*args, cull=True).numpy(), ref)


def test_triangle_boxes():
    """The box rule on single triangles: a zero determinant gives an empty
    box, a sliver past the derived range (det 1e-14 of the edge product) a
    box over every pixel, a unit right triangle its own box grown by about
    3 uv_delta of its edges."""
    t = functools.partial(torch.tensor, dtype=torch.float64)

    def box(q0, q1, q2):
        (q0x, q0y), (q1x, q1y), (q2x, q2y) = (map(t, q) for q in (q0, q1, q2))
        det = torch.nan_to_num(pro._fdet_x(q0x, q0y, q1x, q1y, q2x, q2y), nan=0.0)
        return [float(b) for b in pro.hybrid_tri_boxes(q0x, q0y, q1x, q1y, q2x, q2y, det,
                                                        UV_DELTA)]

    inf = float("inf")
    assert box((0, 0), (1, 0), (2, 0)) == [inf, -inf, inf, -inf]
    assert box((0, 0), (float("nan"), 0), (0, 1)) == [inf, -inf, inf, -inf]
    assert box((0, 0), (1, 1), (2, 2 + 1e-14)) == [-inf, inf, -inf, inf]
    # a triangle flat along an axis is well conditioned: its box is flat
    flat = box((0, 0), (1, 1e-14), (2, 0))
    assert -2.01 < flat[0] < 0 and 2 < flat[1] < 2.01 and -1e-11 < flat[2] < 0 < flat[3] < 1e-11
    x_lo, x_hi, y_lo, y_hi = box((10, 20), (11, 20), (10, 21))
    pad = 3 * UV_DELTA
    assert 10 - 1.01 * pad <= x_lo <= 10 - pad and 11 + pad <= x_hi <= 11 + 1.01 * pad
    assert 20 - 1.01 * pad <= y_lo <= 20 - pad and 21 + pad <= y_hi <= 21 + 1.01 * pad


def _random_swath(seed):
    """A rotated, sheared, scaled, curved and noisy swath in pixel units,
    and a target partly off it."""
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(12, 40, 2))
    jj, ii = np.mgrid[0:h, 0:w].astype(np.float64)
    ang = rng.uniform(0, 2 * np.pi)
    sx, sy = rng.uniform(0.5, 2.0, 2)
    shear = rng.uniform(-0.6, 0.6)
    x, y = sx * (ii + shear * jj), sy * jj
    gx = np.cos(ang) * x - np.sin(ang) * y
    gy = np.sin(ang) * x + np.cos(ang) * y
    gx += rng.uniform(-1, 1) * 3e-2 * (jj - h / 2) ** 2 / h + 0.05 * rng.standard_normal((h, w))
    gy += rng.uniform(-1, 1) * 3e-2 * (ii - w / 2) ** 2 / w + 0.05 * rng.standard_normal((h, w))
    gx -= gx.min() - rng.uniform(-4, 4)
    gy -= gy.min() - rng.uniform(-4, 4)
    dst = tuple(int(v) for v in rng.integers(8, 48, 2))
    return gx, gy, dst


@settings(max_examples=8, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), tile=st.sampled_from([16, 12, 8, 4]))
def test_cull_over_random_swaths(seed, tile):
    """Random swaths and tiles: every accepting pair is a candidate and the
    scan over the candidates equals the plain version."""
    gx, gy, dst = _random_swath(seed)
    if min(dst) < tile:
        tile = 4
    args = _seeded(gx, gy, dst, tile)
    _assert_candidates(args)
    _assert_scan_equal(args)
