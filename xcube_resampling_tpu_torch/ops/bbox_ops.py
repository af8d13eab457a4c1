"""The tile plan's bbox scan on PyTorch tensors (K10).

Port of ``xcube_resampling_tpu/ops/bbox_ops.py``: ``compute_ij_bboxes_jax``
(:16-58), the device variant of the host scan of
``gridmapping/bboxes.py:compute_ij_bboxes``.  :func:`compute_ij_bboxes`
takes a swath's coordinate images as tensors and the tiles' xy bboxes, and
gives the pixel bboxes ``[i0, j0, i1, j1]`` of the swath pixels inside each
box: stops exclusive, grown by ``ij_border`` and clipped to the image, a
row of -1 where nothing intersects.  It holds to the host scan: the boxes
are grown by ``xy_border`` in float64 as the host grows them and compared
in float64 (the JAX variant casts them to the image's dtype, which on
float32 images is another function).

:func:`compute_ij_bboxes_plain` is the masked min/max per box and runs for
CPU tensors; for CUDA tensors the wrapper launches K10
(``csrc/ij_bboxes.cu``) or raises.  K10 takes the tiles of a regular grid
(each tile's x bounds its column's, its y bounds its row's, as
``GridMapping.xy_bboxes`` gives them) and float64 images; it scans
lattices of more than 1024 tiles in sub-lattices, one pass each, all in
one launch.

A warm call queues one device operation, the launch, and does not wait
for the card: the lattice (:func:`lattice_buffer`) is uploaded once per
geometry, device and stream, from pinned memory without waiting, and
memoised; the kernel's table (:func:`scratch_table`) persists per device,
stream and tile count, initialised once, and every launch leaves it as it
found it.  :data:`last_queued` holds the device operations the last call
on a CUDA device queued (uploads, table initialisations and launches).
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

import numpy as np
import torch

from .. import _build
from .._device import count_launch, on_cpu, require_cuda


def _grown(xy_bboxes, xy_border: float) -> np.ndarray:
    """The (n, 4) float64 boxes grown by *xy_border*, each bound rounded
    as the host scan rounds ``xy_boxes[k, 0] - xy_border``."""
    b = np.asarray(xy_bboxes, dtype=np.float64).reshape(-1, 4)
    return np.stack(
        [b[:, 0] - xy_border, b[:, 1] - xy_border, b[:, 2] + xy_border, b[:, 3] + xy_border],
        axis=1,
    )


def compute_ij_bboxes_plain(
    x_image: torch.Tensor,
    y_image: torch.Tensor,
    xy_bboxes,
    xy_border: float = 0.0,
    ij_border: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K10: one masked min/max per box over the
    (h, w) coordinate images, compared in float64; (n, 4) int64 on the
    images' device."""
    h, w = x_image.shape
    x, y = x_image.double(), y_image.double()
    boxes = _grown(xy_bboxes, xy_border)
    out = torch.full((len(boxes), 4), -1, dtype=torch.int64)
    for k, (x_min, y_min, x_max, y_max) in enumerate(boxes.tolist()):
        mask = (x >= x_min) & (x <= x_max) & (y >= y_min) & (y <= y_max)
        rows = torch.nonzero(mask.any(dim=1))
        if rows.numel() == 0:
            continue
        cols = torch.nonzero(mask.any(dim=0))
        i0, j0 = int(cols[0]), int(rows[0])
        i1, j1 = int(cols[-1]) + 1, int(rows[-1]) + 1
        out[k] = torch.tensor([
            max(0, i0 - ij_border), max(0, j0 - ij_border),
            min(w, i1 + ij_border), min(h, j1 + ij_border),
        ])
    return out.to(x_image.device)


def _axis(lo: np.ndarray, hi: np.ndarray, what: str) -> tuple[np.ndarray, np.ndarray]:
    """One axis of the lattice: its bounds sorted so that both ascend, and
    the order (sorted position -> column or row)."""
    order = np.lexsort((hi, lo))
    lo, hi = lo[order], hi[order]
    if not (np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)):
        raise ValueError(f"K10 takes tiles whose {what} bounds ascend together")
    return np.concatenate([lo, hi]), order


def lattice(boxes: np.ndarray) -> tuple[np.ndarray, np.ndarray, int, int]:
    """The row-major lattice of the grown (n, 4) *boxes*: the columns' and
    the rows' bounds, each sorted so that low and high bounds ascend
    (float64: col_lo, col_hi, row_lo, row_hi), their orders (int32), and
    the numbers of columns and rows; ``ValueError`` where the boxes are
    not the tiles of a regular grid."""
    n = len(boxes)
    same_row = (boxes[:, 1] == boxes[0, 1]) & (boxes[:, 3] == boxes[0, 3])
    nc = int(np.argmin(same_row)) if not same_row.all() else n
    if n == 0 or n % nc:
        raise ValueError(f"K10 takes the tiles of a regular grid: {n} boxes")
    grid = boxes.reshape(n // nc, nc, 4)
    xs, ys = grid[:, :, [0, 2]], grid[:, :, [1, 3]]
    if not (np.array_equal(xs, np.broadcast_to(xs[:1], xs.shape))
            and np.array_equal(ys, np.broadcast_to(ys[:, :1], ys.shape))):
        raise ValueError("K10 takes the tiles of a regular grid: the boxes are no lattice")
    cols, col_order = _axis(grid[0, :, 0], grid[0, :, 2], "x")
    rows, row_order = _axis(grid[:, 0, 1], grid[:, 0, 3], "y")
    return (np.concatenate([cols, rows]), np.concatenate([col_order, row_order]).astype(np.int32),
            nc, n // nc)


# The memos of lattice_buffer and scratch_table: a few geometries and
# tile counts, as the reproject plan memo keeps a few plans.
_LATTICE_MEMO: OrderedDict = OrderedDict()
_SCRATCH_MEMO: OrderedDict = OrderedDict()
_MEMO_MAX = 8
# The kernel's table: (min i, min j, max i, max j) a tile as it starts, and
# a last row holding the ticket (0)
_EMPTY_CELL = (0x7FFFFFFF, 0x7FFFFFFF, -1, -1)

last_queued = 0


def _stream_key(device: torch.device) -> int:
    """The current stream of a CUDA *device*; 0 for another device."""
    return torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """*array* on *device*: to a CUDA device from pinned memory, queued on
    the current stream without the host waiting for the card (a pageable
    upload would)."""
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _memo(memo: OrderedDict, key, make):
    """(*memo*[key], 0), or (make(), 1) remembered as the newest entry of
    at most _MEMO_MAX."""
    value = memo.pop(key, None)
    made = value is None
    if made:
        value = make()
    memo[key] = value
    while len(memo) > _MEMO_MAX:
        memo.popitem(last=False)
    return value, int(made)


def pack_lattice(lat: np.ndarray, order: np.ndarray, nc: int) -> np.ndarray:
    """The kernel's lattice buffer (bytes) from :func:`lattice`'s sorted
    bounds (*nc* columns) and orders: for the columns, then the rows, four
    float64 arrays: the low and the high bounds, each low bound's next
    float64 below and each high bound's next above (NaN for an infinite
    bound: no value lies beyond it); then the orders as int32 (col_of,
    row_of)."""
    axes = []
    for lo, hi in (lat[:2 * nc].reshape(2, nc), lat[2 * nc:].reshape(2, -1)):
        below = np.where(lo == -np.inf, np.nan, np.nextafter(lo, -np.inf))
        above = np.where(hi == np.inf, np.nan, np.nextafter(hi, np.inf))
        axes += [lo, hi, below, above]
    return np.concatenate([np.concatenate(axes).view(np.uint8),
                           np.ascontiguousarray(order, np.int32).view(np.uint8)])


def lattice_buffer(boxes: np.ndarray, device) -> tuple[torch.Tensor, int, int, int]:
    """The packed lattice (:func:`pack_lattice`) of the grown (n, 4)
    *boxes* on *device*, its numbers of columns and rows, and the uploads
    queued (0 or 1).  Memoised on the boxes' bytes, the device and its
    current stream: a repeated geometry uploads nothing, and a stream
    never reads a buffer whose upload another stream queued."""
    device = torch.device(device)
    boxes = np.ascontiguousarray(boxes, np.float64)
    key = (boxes.shape, boxes.tobytes(), str(device), _stream_key(device))

    def make():
        lat, order, nc, nr = lattice(boxes)
        return _upload(pack_lattice(lat, order, nc), device), nc, nr

    (buf, nc, nr), made = _memo(_LATTICE_MEMO, key, make)
    return buf, nc, nr, made


def scratch_table(n_tiles: int, device) -> tuple[torch.Tensor, int]:
    """K10's (n_tiles + 1, 4) int32 table on *device* and the uploads
    queued (0 or 1): a row (0x7FFFFFFF, 0x7FFFFFFF, -1, -1) a tile and a
    row of 0 (the ticket), as every launch leaves it.  One per device,
    current stream and tile count, initialised once: the launches of one
    stream run in order, so none finds another's table half merged."""
    device = torch.device(device)

    def make():
        init = np.tile(np.array(_EMPTY_CELL, np.int32), (n_tiles + 1, 1))
        init[n_tiles] = 0
        return _upload(init, device)

    return _memo(_SCRATCH_MEMO, (str(device), _stream_key(device), int(n_tiles)), make)


def compute_ij_bboxes(
    x_image: torch.Tensor,
    y_image: torch.Tensor,
    xy_bboxes,
    xy_border: float = 0.0,
    ij_border: int = 0,
) -> torch.Tensor:
    """K10: the (n, 4) int64 pixel bboxes ``[i0, j0, i1, j1]`` of the
    (h, w) float64 coordinate images *x_image*, *y_image* inside each of
    the (n, 4) xy bboxes (array-like) ``[x_min, y_min, x_max, y_max]`` grown by
    *xy_border* (the host scan's semantics, see the module); on the
    images' device."""
    global last_queued
    if on_cpu(x_image, y_image):
        return compute_ij_bboxes_plain(x_image, y_image, xy_bboxes, xy_border, ij_border)
    h, w = x_image.shape
    require_cuda(x_image, "x_image", torch.float64, (h, w))
    require_cuda(y_image, "y_image", torch.float64, (h, w))
    dev = x_image.device
    lib = _build.load()
    queued = ctypes.c_int(0)
    with torch.cuda.device(dev):
        lat, nc, nr, uploads = lattice_buffer(_grown(xy_bboxes, xy_border), dev)
        table, inits = scratch_table(nc * nr, dev)
        out = torch.empty((nc * nr, 4), dtype=torch.int64, device=dev)
        rc = lib.xrt_ij_bboxes(
            x_image.data_ptr(), y_image.data_ptr(), h, w, lat.data_ptr(), nc, nr,
            int(ij_border), table.data_ptr(), out.data_ptr(), ctypes.byref(queued),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "ij_bboxes")
    count_launch("ij_bboxes")
    last_queued = uploads + inits + queued.value
    return out
