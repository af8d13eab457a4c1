"""Pixel-bbox discovery kernels over 2D coordinate images.

These are the halo/overlap discovery kernels of rectify.  The reference
implements them as numba ``prange`` loops
(xcube_resampling/gridmapping/bboxes.py:28-166); here they
are vectorized masked min/max reductions in numpy on the host.  The JAX
package's native C++ scan, fuzzed bit-identical to this loop, is not
copied.  Semantics match the reference exactly: a pixel is included when its
coordinate value lies inside the (border-grown) xy bbox; i_max/j_max are
exclusive; ij_border grows the result clipped to the image.
"""

from __future__ import annotations

import numpy as np

from ..xrlite import DataArray


def compute_ij_bboxes(
    x_image: np.ndarray,
    y_image: np.ndarray,
    xy_boxes: np.ndarray,
    xy_border: float,
    ij_border: int,
    ij_boxes: np.ndarray,
) -> np.ndarray:
    """Compute pixel-index bounding boxes covering xy bounding boxes.

    Args:
        x_image: 2D array (height, width) of x coordinates.
        y_image: 2D array (height, width) of y coordinates.
        xy_boxes: Array (n, 4) of [x_min, y_min, x_max, y_max].
        xy_border: Border added to the xy boxes before comparison.
        ij_border: Border added to resulting ij boxes, clipped to image.
        ij_boxes: Pre-allocated (n, 4) int array initialised to -1;
            filled in place and returned.
    """
    h, w = x_image.shape
    n = xy_boxes.shape[0]
    for k in range(n):
        x_min = xy_boxes[k, 0] - xy_border
        y_min = xy_boxes[k, 1] - xy_border
        x_max = xy_boxes[k, 2] + xy_border
        y_max = xy_boxes[k, 3] + xy_border
        mask = (
            (x_image >= x_min)
            & (x_image <= x_max)
            & (y_image >= y_min)
            & (y_image <= y_max)
        )
        # row/col extents via any()+argmax — avoids materializing the
        # index arrays of np.nonzero (the dominant cost at swath sizes)
        rows = mask.any(axis=1)
        if not rows.any():
            continue
        cols = mask.any(axis=0)
        j0 = int(rows.argmax())
        j1 = h - int(rows[::-1].argmax())
        i0 = int(cols.argmax())
        i1 = w - int(cols[::-1].argmax())
        if ij_border != 0:
            i0 = max(0, i0 - ij_border)
            j0 = max(0, j0 - ij_border)
            i1 = min(w, i1 + ij_border)
            j1 = min(h, j1 + ij_border)
        ij_boxes[k, 0] = i0
        ij_boxes[k, 1] = j0
        ij_boxes[k, 2] = i1
        ij_boxes[k, 3] = j1
    return ij_boxes


def compute_xy_bbox(xy_coords) -> tuple[float, float, float, float]:
    """Min/max bbox of a (2, height, width) coordinate image, NaN-aware
    (reference bboxes.py:109-166 tree reduction collapses to one pass)."""
    if isinstance(xy_coords, DataArray):
        xy_coords = xy_coords.data
    xy = np.asarray(xy_coords)
    with np.errstate(all="ignore"):
        x_min = np.nanmin(xy[0])
        x_max = np.nanmax(xy[0])
        y_min = np.nanmin(xy[1])
        y_max = np.nanmax(xy[1])
    return float(x_min), float(y_min), float(x_max), float(y_max)
