"""K4's downscale form: the choice of its kernel, and the plain version
against the JAX package on the cached kernel's hard windows.

The cached kernel (``csrc/affine_gather_reduce.cu``) keeps a window's tap
columns in registers and loads the ``i_div + 1`` source columns from the
first its taps reach, so it takes windows whose left tap columns step by at
most one column from tap to tap; ``ops/gather.py`` ``plan_gather_reduce``
sends it the windows of up to 8 columns reduced by one of K5's reducers,
and the direct kernel the positional picks and the rest.  Those choices
are pinned here against a brute-force count over every tap (the card is
not needed).  The plain version, which both kernels equal bit for bit on
the card (``chip_smoke.py``), is held to ``affine._resample_array`` of the
JAX package (bilinear, no NaN recovery, on ``jnp`` arrays) at window
widths 1-9, flipped axes, residual scales of exactly 1 and a source one
column wide.  Inputs come from a numpy seed; each comparison states its
tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from xcube_resampling_tpu import affine as jx_affine  # noqa: E402
from xcube_resampling_tpu.constants import AGG_METHODS as JX_AGG_METHODS  # noqa: E402
from xcube_resampling_tpu_torch import affine as pt_affine  # noqa: E402
from xcube_resampling_tpu_torch.ops import gather  # noqa: E402
from xcube_resampling_tpu_torch.ops.coarsen_ops import REDUCERS  # noqa: E402

# float results within rtol (NaN masks equal): JAX sums float32 in float32
# in XLA's order, the port in float64 rounded once
FLOAT_STATS = {"mean": 1e-6, "sum": 1e-6, "prod": 1e-6, "std": 1e-5, "var": 1e-5}
K5_REDUCERS = [agg for agg in REDUCERS if agg not in gather.PICKS]


def _window_steps(out_w, i_div, i_scale, i_off, src_w):
    """By brute force: the largest step of a window's clipped left tap
    column from one tap to the next, and the most source columns a window's
    taps reach (their left and right columns)."""
    p = np.arange(out_w * i_div) * i_scale + i_off
    t0 = np.clip(np.floor(p), 0, src_w - 1).astype(int).reshape(out_w, i_div)
    t1 = np.minimum(t0 + 1, src_w - 1)
    step = np.abs(np.diff(t0, axis=1)).max() if i_div > 1 else 0
    reach = (np.maximum(t1.max(1), t0.max(1)) - np.minimum(t0.min(1), t1.min(1)) + 1).max()
    return step, reach


# (src_w, residual i_scale, i_off): a scale that does not divide, one of
# exactly 1, flipped, near 1 (where the steps are counted), a window past
# the source's edges
SCALES = [
    (900, 0.8104, 0.3), (900, 1.0, 0.0), (900, -0.93, 897.0),
    (900, 1.0 - 2.0**-30, 0.49), (900, 0.67, -40.0),
]


@pytest.mark.parametrize("agg", ["mean", "std", "count"])
@pytest.mark.parametrize("scales", SCALES)
@pytest.mark.parametrize("width", range(1, 9))
def test_narrow_windows_take_the_cached_kernel(width, scales, agg):
    """Windows of 1-8 columns reduced by K5's reducers take the cached
    kernel: by brute force over every tap, their left columns step by at
    most one and a window's taps reach at most ``width + 1`` columns, the
    ones it loads."""
    src_w, i_scale, i_off = scales
    out_w = int((src_w - 2) / (width * abs(i_scale)))
    step, reach = _window_steps(out_w, width, i_scale, i_off, src_w)
    assert step <= 1 and reach <= width + 1
    assert gather.taps_step_once(out_w, width, i_scale, i_off, src_w)
    assert gather.plan_gather_reduce(out_w, width, i_scale, i_off, src_w, agg) == "cached"


@pytest.mark.parametrize("agg", K5_REDUCERS)
def test_every_k5_reducer_takes_the_cached_kernel(agg):
    """Each of K5's reducers (not a pick) has cached instantiations."""
    assert gather.plan_gather_reduce(100, 5, 0.81, 0.3, 500, agg) == "cached"


@pytest.mark.parametrize("agg", ["first", "last", "center"])
def test_picks_take_the_direct_kernel(agg):
    """A positional pick needs one tap a window: the direct kernel."""
    assert gather.plan_gather_reduce(100, 5, 0.81, 0.3, 500, agg) == "direct"
    assert gather.ROUTES["direct"] == 0 and gather.ROUTES["cached"] == 1


@pytest.mark.parametrize("width", [9, 12, 64])
def test_wide_windows_take_the_direct_kernel(width):
    """Windows wider than :data:`CACHED_MAX_WIDTH` columns take the direct
    kernel (the cached kernel is a template on the width)."""
    assert width > gather.CACHED_MAX_WIDTH
    assert gather.plan_gather_reduce(50, width, 0.9, 0.1, 4096, "mean") == "direct"


@pytest.mark.parametrize("i_scale", [1.5, -1.25, 2.0])
def test_windows_stepping_over_a_column_take_the_direct_kernel(i_scale):
    """Where the taps step over a column (a scale past 1, as rounding can
    make a step of two near 1), ``taps_step_once`` says so, as the brute
    force count does, and the plan takes the direct kernel."""
    step, _ = _window_steps(40, 4, i_scale, 200.3, 400)
    assert step == 2
    assert not gather.taps_step_once(40, 4, i_scale, 200.3, 400)
    assert gather.plan_gather_reduce(40, 4, i_scale, 200.3, 400, "mean") == "direct"


def _hard_cases():
    """(name, source shape, matrix, (out_h, out_w)): window widths 1-9 at a
    residual scale that does not divide, on a flipped i axis and at a
    residual of exactly 1; a source one column wide."""
    cases = []
    for w in range(1, 10):
        i_scale = w * 0.87 if w > 1 else 0.87
        cases.append((f"w{w}", (2, 31, 40), ((i_scale, 0.0, 0.4), (0.0, 2.6, 0.3)),
                      (11, max(1, int(39 / max(i_scale, 1.0))))))
        cases.append((f"w{w} flipped", (2, 31, 40), ((-i_scale, 0.0, 38.7), (0.0, 2.6, 0.3)),
                      (11, max(1, int(39 / max(i_scale, 1.0))))))
        if w > 1:
            cases.append((f"w{w} residual 1", (2, 31, 40), ((float(w), 0.0, 0.0),
                                                             (0.0, 3.0, 0.0)),
                          (10, 40 // w)))
    cases.append(("one column", (2, 31, 1), ((0.6, 0.0, 0.0), (0.0, -3.5, 30.0)), (8, 2)))
    return cases


@pytest.mark.parametrize("agg", ["mean", "std", "max", "count", "center"])
@pytest.mark.parametrize("case", _hard_cases(), ids=lambda c: c[0])
def test_plain_downscale_matches_jax_on_hard_windows(case, agg):
    """The downscale form on CPU tensors (its plain version: K4 -> K5)
    against JAX's ``affine._resample_array`` on the staged kernel's hard
    windows, float32 with a NaN cell and a fill edge: max, count and the
    pick equal; float statistics within FLOAT_STATS's rtol; NaN masks
    equal."""
    _, shape, matrix, (out_h, out_w) = case
    rng = np.random.default_rng(17)
    data = rng.random(shape).astype(np.float32)
    data[1, 4, 0] = np.nan
    ref = jx_affine._resample_array(
        jnp.asarray(data), matrix, (shape[0], out_h, out_w), 1, JX_AGG_METHODS[agg], False,
        np.nan,
    )
    (j_div, i_div), ((i_s, _, i_o), (_, j_s, j_o)) = pt_affine._scale_split(matrix)
    assert agg in REDUCERS
    got = gather.affine_gather_reduce(
        torch.from_numpy(data), j_s, i_s, j_o, i_o, out_h, out_w, j_div, i_div, agg, np.nan
    ).numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    rtol = FLOAT_STATS.get(agg, 0.0)
    if rtol:
        np.testing.assert_allclose(got, ref, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, ref)
