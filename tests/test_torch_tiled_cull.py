"""K20's cull on the CPU: the pairs ``xcube_resampling_tpu_torch/csrc/
phase_a_tiled.cu`` solves, mirrored in ``ops.phase_a``
(``phase_a_tiled_pairs``, ``phase_a_tiled_plain(cull=True)``) with K12's
triangle boxes (``ops.rectify_ops.hybrid_tri_boxes``), against the plain
scan over every window quad and the JAX package's float64
``_phase_a_tiled``.

K20 solves only the (pixel, triangle) pairs whose pixel centre lies in the
triangle's box, among the quads its first pass lists; its map equals the
scan over every window quad only if no pair that accepts lies outside its
box.  Expected, and asserted, on the small OLCI-like swath (clean, with a
NaN row, with NaN edge rows) at the tiled planner's interior and band
classes, on windows reaching past the swath, and on rotated, sheared,
sliver, folded and NaN-node lattices at windows of the interior class's
20 nodes and the band class's 40:

* every pair that accepts under the plain version's own arithmetic (true
  divisions, emulated fused multiply-adds) lies inside its box, and every
  quad holding a pair inside a box is listed by the first pass;
* the culled plain map equals the unculled one bit for bit, and equals
  JAX's ``_phase_a_tiled`` in float64 bit for bit.
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
from xcube_resampling_tpu_torch.ops import phase_a  # noqa: E402

from tests.sampledata import create_olci_like_swath  # noqa: E402
from tests.test_torch_hybrid_cull import _lattices, _random_swath  # noqa: E402

TILE = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite's parallel workers, each with a thread a
    core, otherwise contend for the cores through the dense reference's
    many float64 operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _olci_plan(kind):
    """The tiled planner's plan of the small OLCI-like swath onto its
    default grid: clean, with a NaN row, or with NaN edge rows."""
    ds = create_olci_like_swath(width=96, height=128, tile_size=32)
    gm = jx.GridMapping.from_dataset(ds)
    tgt = gm.to_regular(tile_size=32)
    xy = np.array(gm.xy_coords.data, dtype=np.float64)
    if kind == "NaN row":
        xy[:, 60] = np.nan
    elif kind == "NaN edges":
        xy[:, :2] = np.nan
        xy[:, -2:] = np.nan
    x1, _, _, y2 = tgt.xy_bbox
    plan = phase_a.plan_phase_a_device(xy[0], xy[1], 0, 0, (tgt.height, tgt.width), x1, y2,
                                       tgt.x_res, -tgt.y_res, UV_DELTA, device="cpu")
    assert isinstance(plan, phase_a.PhaseAPlan) and plan.cls_band is not None
    return plan


def _olci_class(kind, band):
    """K20's arguments for one class of :func:`_olci_plan`: (g, tiles, bjs,
    bis, win, tile, n_ti, dst)."""
    plan = _olci_plan(kind)
    c = plan.cls_band if band else plan.cls_all
    return (plan.g, c["sel"] if band else None, c["bjs"], c["bis"], c["win"], plan.tile,
            plan.n_ti, (plan.dst_h, plan.dst_w))


def _random_windows(gx, gy, dst, win, seed):
    """K20's arguments on a lattice: every tile of *dst*, each at a window of
    *win* nodes from a random origin, some reaching past the swath (its
    nodes NaN there, as JAX's padding makes them)."""
    rng = np.random.default_rng(seed)
    h, w = gx.shape
    n_tj, n_ti = -(-dst[0] // TILE), -(-dst[1] // TILE)
    n = n_tj * n_ti
    bjs = rng.integers(0, max(1, h - win // 2), n).astype(np.int32)
    bis = rng.integers(0, max(1, w - win // 2), n).astype(np.int32)
    g = torch.from_numpy(np.stack([gx, gy]))
    return g, None, torch.from_numpy(bjs), torch.from_numpy(bis), win, TILE, n_ti, dst


@functools.lru_cache(maxsize=None)
def _case(name, win_class):
    """A named case at the interior ("interior") or the band ("band")
    class: the OLCI swath's plan classes, or a lattice at windows of 20 or
    40 nodes from random origins."""
    band = win_class == "band"
    if name.startswith("OLCI"):
        return _olci_class(name.removeprefix("OLCI ") or "clean", band)
    gx, gy, dst = _lattices()[name]
    return _random_windows(gx, gy, dst, 40 if band else 20, seed=len(name) + band)


CASES = ["OLCI ", "OLCI NaN row", "OLCI NaN edges", "rotated", "sheared", "slivers", "folded",
         "NaN p0", "NaN p3"]


def _map(args, cull):
    g, tiles, bjs, bis, win, tile, n_ti, dst = args
    out = torch.full((2,) + dst, -1.0, dtype=torch.float64)
    return phase_a.phase_a_tiled_plain(g, tiles, bjs, bis, win, tile, n_ti, UV_DELTA, out,
                                       cull=cull)


# JAX's source padded with NaN to a multiple of this many nodes each way,
# and its tile list to a power of two (repeats of its first tile), so that
# the cases share compilations
_JAX_PAD = 160


def _jax_map(args):
    """JAX's float64 ``_phase_a_tiled`` on the same tiles and windows, its
    source padded with NaN past where the windows reach, written into a map
    as K20 writes it."""
    g, tiles, bjs, bis, win, tile, n_ti, dst = args
    n = len(bjs)
    t = np.arange(n) if tiles is None else tiles.numpy().astype(np.int64)
    bj, bi = bjs.numpy().astype(np.int64), bis.numpy().astype(np.int64)
    _, h, w = g.shape
    hp, wp = (-(-max(x, int(b.max()) + win) // _JAX_PAD) * _JAX_PAD
              for x, b in ((h, bj), (w, bi)))
    gp = np.full((2, hp, wp), np.nan)
    gp[:, :h, :w] = g.numpy()
    extra = np.zeros(1 << (n - 1).bit_length(), dtype=np.int64)[n:]
    tt, bjt, bit = (np.concatenate([x, extra + x[0]]) for x in (t, bj, bi))
    o_i, o_j = jro._phase_a_tiled_jit()(
        jnp.asarray(gp[0]), jnp.asarray(gp[1]), jnp.asarray(tt // n_ti, dtype=jnp.int32),
        jnp.asarray(tt % n_ti, dtype=jnp.int32), jnp.asarray(bjt, dtype=jnp.int32),
        jnp.asarray(bit, dtype=jnp.int32), jnp.float64(UV_DELTA), tile=tile, win=win, nqi=wp - 1)
    o_i, o_j = np.asarray(o_i)[:n], np.asarray(o_j)[:n]
    out = np.full((2,) + dst, -1.0)
    rows = (t // n_ti)[:, None, None] * tile + np.arange(tile)[:, None]
    cols = (t % n_ti)[:, None, None] * tile + np.arange(tile)
    rows, cols = np.broadcast_arrays(rows, cols)
    keep = (rows < dst[0]) & (cols < dst[1])
    for k, o in enumerate((o_i, o_j)):
        out[k, rows[keep], cols[keep]] = np.asarray(o)[keep]
    return out


def _assert_pairs(args):
    """Every accepting pair lies in its box, and every quad with a pair in a
    box is listed by the first pass; returns (pairs accepted, candidates,
    all pairs)."""
    g, tiles, bjs, bis, win, tile, n_ti, dst = args
    accepted = candidates = pairs = 0
    for c in phase_a.phase_a_tiled_pairs(g, tiles, bjs, bis, win, tile, n_ti, UV_DELTA, dst):
        inside = ((c.rows < dst[0]) & (c.cols < dst[1]))[:, :, None]
        ok_a, ok_b = c.ok_a & inside, c.ok_b & inside
        assert not (ok_a & ~c.cand_a).any()
        assert not (ok_b & ~c.cand_b).any()
        assert not ((c.cand_a | c.cand_b) & ~c.listed).any()
        accepted += int(ok_a.sum() + ok_b.sum())
        candidates += int(c.cand_a.sum() + c.cand_b.sum())
        pairs += 2 * int(inside.sum()) * c.det_a.shape[-1]
    return accepted, candidates, pairs


@pytest.mark.parametrize("win_class", ["interior", "band"])
@pytest.mark.parametrize("name", CASES)
def test_accepting_pairs_lie_in_their_boxes(name, win_class):
    """No pair that accepts lies outside its triangle's box, none in a box is
    dropped by the first pass, and the boxes cull most pairs."""
    accepted, candidates, pairs = _assert_pairs(_case(name, win_class))
    assert accepted > 0
    assert candidates < pairs / 10


@pytest.mark.parametrize("win_class", ["interior", "band"])
@pytest.mark.parametrize("name", CASES)
def test_culled_map_equals_the_scan_and_jax(name, win_class):
    """The culled plain map equals the scan over every window quad and JAX's
    float64 ``_phase_a_tiled``, bit for bit, NaN positions included."""
    args = _case(name, win_class)
    got = _map(args, cull=True).numpy()
    np.testing.assert_array_equal(got, _map(args, cull=False).numpy())
    np.testing.assert_array_equal(got, _jax_map(args))
    assert np.isfinite(got).any()


@settings(max_examples=4, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), win=st.sampled_from([8, 20, 40]))
def test_cull_over_random_swaths(seed, win):
    """Random rotated, sheared, curved and noisy swaths at random windows:
    every accepting pair lies in its box and is listed, and the culled map
    equals the scan."""
    gx, gy, dst = _random_swath(seed)
    args = _random_windows(gx, gy, dst, win, seed)
    _assert_pairs(args)
    np.testing.assert_array_equal(_map(args, cull=True).numpy(),
                                  _map(args, cull=False).numpy())
