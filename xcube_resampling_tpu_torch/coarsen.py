"""Window reducer functions for coarsening (downsampling aggregation).

Semantics match the reference's reducer set (reference
coarsen.py:50-155): NaN-aware statistics for float dtypes, rounded
int round-trips for integer dtypes, positional first/last/center, and
categorical mode.  Structurally this module is a pair of factories — one
for positional picks, one for statistics — instead of hand-written
per-reducer functions; the reference's numba histogram kernel for mode
becomes a vectorized offset-bincount.  Host numpy reducers, copied from
``xcube_resampling_tpu/coarsen.py`` for :data:`.constants.AGG_METHODS`.

A reducer is called with a window-expanded block of shape e.g.
``(reduced_height, window_y, reduced_width, window_x)`` and the tuple of
window axes, and returns the reduced array.  ``axis=None`` means an edge
pass-through block.
"""

from __future__ import annotations

import warnings

import numpy as np

_DOC = """Computes the {property} of the windows in `block`.

Args:
    block: Array block reshaped into windows to be reduced to size one.
        For spatial images, its shape will be
        `(reduced_height, window_size_y, reduced_width, window_size_x)`.
    axis: A tuple providing the indexes of the window dimensions in the
        shape of `block`. For spatial images, this will be `(1, 3)`.

Returns:
    The reduced array containing the {property} of the windows from
    `block`. For spatial images, its shape will be
    `(reduced_height, reduced_width)`.
"""


def _positional(pick, prop, fname):
    """Build a reducer that takes one position out of each window."""

    def reducer(block: np.ndarray, axis: tuple[int, ...] | None = None):
        if axis is None:
            return block  # edge block, pass through
        window_axes = set(axis)
        sel = tuple(
            pick(block.shape[i]) if i in window_axes else slice(None)
            for i in range(block.ndim)
        )
        return block[sel]

    reducer.__doc__ = _DOC.format(property=prop)
    reducer.__name__ = reducer.__qualname__ = fname
    return reducer


first = _positional(lambda n: 0, "first value", "first")
last = _positional(lambda n: -1, "last value", "last")
center = _positional(lambda n: n // 2, "center value", "center")


def _statistic(name, prop):
    """Build a reducer around numpy's `name`/`nan{name}` pair.

    Float blocks use the NaN-aware variant (all-NaN windows keep their
    NaN, with the RuntimeWarning muted); integer/bool blocks use the
    plain variant and, when numpy promoted to float (mean/median/...),
    round back into the input dtype.
    """
    plain, nan_aware = getattr(np, name), getattr(np, "nan" + name)

    def reducer(block: np.ndarray, axis: tuple[int, ...] | None = None):
        if axis is None:
            return block  # edge block, pass through
        if np.issubdtype(block.dtype, np.floating):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", category=RuntimeWarning)
                return nan_aware(block, axis)
        out = plain(block, axis)
        if np.issubdtype(out.dtype, np.floating):
            out = np.rint(out).astype(block.dtype)
        return out

    reducer.__doc__ = _DOC.format(property=prop)
    reducer.__name__ = reducer.__qualname__ = name
    return reducer


mean = _statistic("mean", "mean")
median = _statistic("median", "median")
std = _statistic("std", "standard deviation")
sum = _statistic("sum", "sum")  # noqa: A001 - name fixed by the registry
var = _statistic("var", "variance")


def mode(block: np.ndarray, axis: tuple[int, ...] | None = None) -> np.ndarray:
    if axis is None:
        return block  # edge block, pass through

    # flatten every window into a row
    ndim = len(axis)
    windows = np.moveaxis(block, axis, range(-ndim, 0))
    rows = windows.reshape(-1, int(np.prod(windows.shape[-ndim:])))

    # one global bincount over per-row offset-shifted values, then argmax
    # per row; argmax returns the FIRST maximum, so ties resolve to the
    # smallest value — same contract as the reference's sequential
    # histogram scan (reference coarsen.py:138-155)
    lo = int(rows.min())
    spread = int(rows.max()) - lo + 1
    shifted = (rows - lo).astype(np.int64)
    shifted += np.arange(rows.shape[0], dtype=np.int64)[:, None] * spread
    hist = np.bincount(shifted.ravel(), minlength=rows.shape[0] * spread)
    winners = hist.reshape(rows.shape[0], spread).argmax(axis=1) + lo
    return winners.reshape(windows.shape[:-ndim])


mode.__doc__ = (
    "Most frequent value per window.  Assumes categorical (integer-"
    "valued) data; ties resolve to the smallest value.\n\n"
    + _DOC.format(property="mode")
)
