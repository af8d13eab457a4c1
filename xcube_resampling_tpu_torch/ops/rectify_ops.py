"""Rectify kernels on PyTorch tensors: Phase A (K8, K11, K12) and Phase B
(K7, K9).

Port of ``xcube_resampling_tpu/ops/rectify_ops.py``:

* :func:`inverse_ij_map` with :func:`_accept_quad` is a float64 torch port
  of the JAX package's numpy Phase A (:44-300): per source quad the
  destination pixel rectangle from its floored corners, the two
  barycentric triangle solves with ``uv_delta``, and a scatter-min of the
  quads' row-major ranks, so that the first writer of the reference's
  sequential loop wins each pixel.  :func:`rectify_phase_a_plain` runs it
  once per destination tile of a :class:`PhaseATiles` table, as the JAX
  host tier does (``rectify._inverse_ij_map_tile``), and is the plain
  version of K8, :func:`rectify_phase_a` (``csrc/rectify_phase_a.cu``),
  which does every tile's work in one launch and equals it bit for bit.
* :func:`inverse_ij_map_hybrid` (:2200-2394) is the hybrid Phase A on the
  swath's normalised coordinates: K11 (:func:`hybrid_seed`,
  ``csrc/hybrid_phase_a.cu``) gates the swath and walks the tile-corner
  lattice to quad guesses and per-axis window needs; K12
  (:func:`hybrid_dense`) tests every window quad for every pixel of a tile
  and keeps the lowest-ranked that accepts, the host kernel's winner.
  They run in float64; their plain versions carry XLA's fused
  multiply-adds, so the map equals the JAX package's float64 hybrid bit
  for bit.  The sharded Phase A runs them band by band
  (``parallel.halo.sharded_phase_a``).
* :func:`make_device_var_image_fn` (:2648-2764) is the device Phase B of
  tensor variables over a map the host holds: K7 (``csrc/ij_gather.cu``,
  :func:`ij_gather`) through the map's float32 positions with the map's
  mask, or, for bilinear and triangular where the coarse fields of the map
  hold, the SRW interior on K1/K2 and the edge band through K7's list form
  (:func:`ij_gather_list`).  K7's band form (:func:`ij_gather_band`) is
  the sharded rectify's gather on one mesh band
  (``parallel/halo.py:923-977``).
* :class:`DeviceIJMap` and :func:`make_device_var_image_fn_resident`
  (:1319, :2452-2647) are the resident Phase B over a map that stays on
  the device: the same two forms, the SRW plan from a step lattice of the
  map and its half-offset probes (the only samples that reach the host),
  the coverage interior a square erosion of the map's validity on the
  device.
* :func:`var_image_from_ij_map` (:2767-2855) is the host Phase B of numpy
  variables: K9's ij_map mode (:mod:`.exact_gather`).
* The rest of the device Phase A, the walk (K19), the tiled stencil (K20),
  the scatter-min scan (K21) and JAX's ladder among them and the hybrid
  (:func:`inverse_ij_map_device`, :2396), live in :mod:`.phase_a`, which
  imports this module; their names are looked up there (``__getattr__``).

The wrappers run the plain versions for CPU tensors and launch the kernels
for CUDA tensors, or raise; they never fall back.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .._device import (
    DTYPE_CODES,
    count_launch,
    launch_name,
    narrow,
    on_cpu,
    require_cuda,
    require_data_dtype,
    widen,
)
from .exact_gather import exact_gather_ij, unsupported
from .reproject_ops import (
    MAX_PLANE,
    METHODS,
    check_taps_dtype,
    fill_bits,
    fill_scalar,
    fma64,
    gather_dtype,
    gather_fill,
    gather_interp,
    interp_taps,
    method_code,
)
from .srw import fields_from_ij_map, fields_from_lattice, make_srw_fn_picked, plan_srw

_F32 = torch.float32
_F64 = torch.float64

# The device Phase B's SRW coarse-field step; the coverage interior is the
# map's valid pixels eroded PHASE_B_STEP + 2 times (rectify_ops.py:2693),
# or, over a resident map, within a square of that radius (:2600-2607).
# Where JAX picks its batched or its tiled SRW (:2707-2718, :2612-2618),
# the port runs the same two kernels, K1 and K2: the batched SRW computes
# the tiled one's function bit for bit, its tap loops batched over the
# tiles only to keep XLA's compile small.
PHASE_B_STEP = 16
_NAN = float("nan")


# ---------------------------------------------------------------------------
# Phase A: the plain float64 version
# ---------------------------------------------------------------------------


def _fdet(px0, py0, px1, py1, px2, py2):
    return (px0 - px1) * (py0 - py2) - (px0 - px2) * (py0 - py1)


def _fu(px, py, px0, py0, px2, py2):
    return (px0 - px) * (py0 - py2) - (py0 - py) * (px0 - px2)


def _fv(px, py, px0, py0, px1, py1):
    return (py0 - py) * (px0 - px1) - (px0 - px) * (py0 - py1)


def _accept_quad(
    q, qi, qj, pixel_i, pixel_j, dst_x_offset, dst_y_offset, dst_x_scale,
    dst_y_scale, u_min, v_min, uv_max,
):
    """The reference's two-triangle containment test for candidate (quad,
    pixel) pairs: (accept, fractional src_i, src_j) relative to the window.
    The second triangle's result is taken only where the first rejects."""
    # (an integer tensor plus a Python float would promote to float32)
    dst_x = dst_x_offset + (pixel_i.to(_F64) + 0.5) * dst_x_scale
    dst_y = dst_y_offset + (pixel_j.to(_F64) + 0.5) * dst_y_scale
    det_a, det_b = q["det_a"], q["det_b"]
    p0x, p0y = q["p0x"], q["p0y"]
    p1x, p1y = q["p1x"], q["p1y"]
    p2x, p2y = q["p2x"], q["p2y"]
    p3x, p3y = q["p3x"], q["p3y"]

    safe_a = torch.where(det_a == 0.0, 1.0, det_a)
    ua = _fu(dst_x, dst_y, p0x, p0y, p2x, p2y) / safe_a
    va = _fv(dst_x, dst_y, p0x, p0y, p1x, p1y) / safe_a
    ok_a = (det_a != 0.0) & (ua >= u_min) & (va >= v_min) & (ua + va <= uv_max)

    safe_b = torch.where(det_b == 0.0, 1.0, det_b)
    ub = _fu(dst_x, dst_y, p3x, p3y, p1x, p1y) / safe_b
    vb = _fv(dst_x, dst_y, p3x, p3y, p2x, p2y) / safe_b
    ok_b = (det_b != 0.0) & (ub >= u_min) & (vb >= v_min) & (ub + vb <= uv_max)

    use_b = ~ok_a & ok_b
    src_if = torch.where(use_b, (qi + 1) - ub.clamp(0.0, 1.0), qi + ua.clamp(0.0, 1.0))
    src_jf = torch.where(use_b, (qj + 1) - vb.clamp(0.0, 1.0), qj + va.clamp(0.0, 1.0))
    return ok_a | ok_b, src_if, src_jf


def inverse_ij_map(
    src_x: torch.Tensor,
    src_y: torch.Tensor,
    src_i_min: int,
    src_j_min: int,
    dst_shape: tuple[int, int],
    dst_x_offset: float,
    dst_y_offset: float,
    dst_x_scale: float,
    dst_y_scale: float,
    uv_delta: float,
) -> torch.Tensor:
    """The (2, dst_h, dst_w) float64 fractional source (i, j) map of one
    destination block from (h, w) float64 source coordinate images
    (``rectify_ops.inverse_ij_map``)."""
    dst_h, dst_w = dst_shape
    out = torch.full((2, dst_h, dst_w), _NAN, dtype=_F64, device=src_x.device)
    src_h, src_w = src_x.shape
    if src_h < 2 or src_w < 2:
        return out

    p0x, p1x = src_x[:-1, :-1], src_x[:-1, 1:]
    p2x, p3x = src_x[1:, :-1], src_x[1:, 1:]
    p0y, p1y = src_y[:-1, :-1], src_y[:-1, 1:]
    p2y, p3y = src_y[1:, :-1], src_y[1:, 1:]

    # destination pixel rect per quad: floor((corner - offset) / scale)
    cx_min = torch.minimum(torch.minimum(p0x, p1x), torch.minimum(p2x, p3x))
    cx_max = torch.maximum(torch.maximum(p0x, p1x), torch.maximum(p2x, p3x))
    cy_min = torch.minimum(torch.minimum(p0y, p1y), torch.minimum(p2y, p3y))
    cy_max = torch.maximum(torch.maximum(p0y, p1y), torch.maximum(p2y, p3y))
    if dst_x_scale >= 0:
        i_lo = torch.floor((cx_min - dst_x_offset) / dst_x_scale)
        i_hi = torch.floor((cx_max - dst_x_offset) / dst_x_scale)
    else:
        i_lo = torch.floor((cx_max - dst_x_offset) / dst_x_scale)
        i_hi = torch.floor((cx_min - dst_x_offset) / dst_x_scale)
    if dst_y_scale >= 0:
        j_lo = torch.floor((cy_min - dst_y_offset) / dst_y_scale)
        j_hi = torch.floor((cy_max - dst_y_offset) / dst_y_scale)
    else:
        j_lo = torch.floor((cy_max - dst_y_offset) / dst_y_scale)
        j_hi = torch.floor((cy_min - dst_y_offset) / dst_y_scale)
    nan_rect = torch.isnan(i_lo) | torch.isnan(j_lo)
    i_lo, i_hi, j_lo, j_hi = (torch.nan_to_num(t, nan=-1e9) for t in (i_lo, i_hi, j_lo, j_hi))
    alive = ~nan_rect & (i_hi >= 0) & (j_hi >= 0) & (i_lo < dst_w) & (j_lo < dst_h)

    # triangle determinants (NaN -> 0, both-zero quads dropped)
    det_a = torch.nan_to_num(_fdet(p0x, p0y, p1x, p1y, p2x, p2y), nan=0.0)
    det_b = torch.nan_to_num(_fdet(p3x, p3y, p2x, p2y, p1x, p1y), nan=0.0)
    alive &= (det_a != 0.0) | (det_b != 0.0)
    if not bool(alive.any()):
        return out

    nqj, nqi = src_h - 1, src_w - 1
    alive_f = alive.reshape(-1)
    corners = {
        "p0x": p0x, "p0y": p0y, "p1x": p1x, "p1y": p1y, "p2x": p2x,
        "p2y": p2y, "p3x": p3x, "p3y": p3y, "det_a": det_a, "det_b": det_b,
    }
    corners = {k: v.reshape(-1) for k, v in corners.items()}
    dev = src_x.device
    qi_f = torch.arange(nqi, dtype=torch.int64, device=dev).repeat(nqj)
    qj_f = torch.arange(nqj, dtype=torch.int64, device=dev).repeat_interleave(nqi)
    i_lo_q = i_lo.reshape(-1).clamp(0, dst_w - 1).long()
    i_hi_q = i_hi.reshape(-1).clamp(0, dst_w - 1).long()
    j_lo_q = j_lo.reshape(-1).clamp(0, dst_h - 1).long()
    j_hi_q = j_hi.reshape(-1).clamp(0, dst_h - 1).long()
    r_i = int((i_hi_q[alive_f] - i_lo_q[alive_f]).max()) + 1
    r_j = int((j_hi_q[alive_f] - j_lo_q[alive_f]).max()) + 1

    u_min = v_min = -uv_delta
    uv_max = 1.0 + 2 * uv_delta
    # winner-rank map: the quad's row-major rank is the reference's write order
    rank = qj_f * nqi + qi_f
    claim = torch.full((dst_h * dst_w,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                       device=dev)
    accepted = []
    for dj in range(r_j):
        for di in range(r_i):
            pixel_j = j_lo_q + dj
            pixel_i = i_lo_q + di
            sel = torch.nonzero(alive_f & (pixel_j <= j_hi_q) & (pixel_i <= i_hi_q))[:, 0]
            if sel.numel() == 0:
                continue
            accept, src_if, src_jf = _accept_quad(
                {k: v[sel] for k, v in corners.items()}, qi_f[sel], qj_f[sel],
                pixel_i[sel], pixel_j[sel], dst_x_offset, dst_y_offset,
                dst_x_scale, dst_y_scale, u_min, v_min, uv_max,
            )
            acc = sel[accept]
            flat = pixel_j[acc] * dst_w + pixel_i[acc]
            accepted.append((acc, flat, src_if[accept], src_jf[accept]))
            claim.scatter_reduce_(0, flat, rank[acc], reduce="amin")

    # the winners' fractional source coordinates, offset by the window's
    out_i = out[0].view(-1)
    out_j = out[1].view(-1)
    for acc, flat, src_if, src_jf in accepted:
        win = claim[flat] == rank[acc]
        out_i[flat[win]] = src_i_min + src_if[win]
        out_j[flat[win]] = src_j_min + src_jf[win]
    return out


# ---------------------------------------------------------------------------
# K8: every destination tile of Phase A in one launch
# ---------------------------------------------------------------------------


@dataclass
class PhaseATiles:
    """K8's tile table: per destination tile (row-major over the target's
    tiles) ``ints`` (n, 8) int64 = row0, col0, tile rows, tile columns, the
    window's first source column and row, its width and height (0 where no
    source quad can land in the tile), and ``origins`` (n, 2) float64 = the
    tile's destination x and y origin; the destination's scales (y negative
    for a j-axis-down target) and tiling."""

    ints: np.ndarray
    origins: np.ndarray
    x_scale: float
    y_scale: float
    tile_h: int
    tile_w: int
    n_tiles_x: int
    out_h: int
    out_w: int


def rectify_phase_a_plain(swath_xy: torch.Tensor, tiles: PhaseATiles, uv_delta: float):
    """Plain PyTorch version of K8: :func:`inverse_ij_map` once per tile of
    *tiles* on its window of the (2, H, W) float64 *swath_xy*."""
    out = torch.full((2, tiles.out_h, tiles.out_w), _NAN, dtype=_F64, device=swath_xy.device)
    for (row0, col0, th, tw, i_lo, j_lo, win_w, win_h), (x_off, y_off) in zip(
        tiles.ints.tolist(), tiles.origins.tolist()
    ):
        if win_w < 1 or win_h < 1:
            continue
        window = swath_xy[:, j_lo:j_lo + win_h, i_lo:i_lo + win_w]
        out[:, row0:row0 + th, col0:col0 + tw] = inverse_ij_map(
            window[0], window[1], i_lo, j_lo, (th, tw), x_off, y_off,
            tiles.x_scale, tiles.y_scale, uv_delta,
        )
    return out


# K8's claims start at 0x7F7F7F7F (a byte fill): window-local quad ranks
# must stay below it
_MAX_QUADS = 0x7F7F7F7F
# K8's work item: a patch of PATCH_W x PATCH_H quads of one tile's window
# (csrc/rectify_phase_a.cu's kPatchW, kPatchH)
PATCH_W = 32
PATCH_H = 8
_MAX_INDEX = 2**31 - 1


def phase_a_patches(tiles: PhaseATiles) -> tuple[np.ndarray, int]:
    """K8's work table: per tile of *tiles* (n, 2) int32 = its first work
    item and its PATCH_W x PATCH_H patches of window quads across (the
    items run tile by tile, row-major over each tile's patches; a window
    without a quad has none, and its first item is the next tile's), and
    the number of work items."""
    quads_w = np.maximum(tiles.ints[:, 6] - 1, 0)
    quads_h = np.maximum(tiles.ints[:, 7] - 1, 0)
    across = -(-quads_w // PATCH_W)
    count = across * -(-quads_h // PATCH_H)
    first = np.cumsum(count) - count
    return np.stack([first, across], 1).astype(np.int32), int(count.sum())


def phase_a_table(tiles: PhaseATiles) -> tuple[np.ndarray, int]:
    """K8's tables in one int64 array, uploaded at once: the tiles' ints
    (n x 8), their origins (n x 2 float64) and :func:`phase_a_patches`'
    work table (n x 2 int32), at byte offsets 0, 64 n and 80 n; and the
    number of work items."""
    patches, n_items = phase_a_patches(tiles)
    if n_items > _MAX_INDEX:
        raise ValueError(f"K8 takes fewer than 2^31 patches of quads: {n_items}")
    return np.concatenate([
        np.ascontiguousarray(tiles.ints, np.int64).ravel(),
        np.ascontiguousarray(tiles.origins, np.float64).ravel().view(np.int64),
        patches.ravel().view(np.int64),
    ]), n_items


def rectify_phase_a(swath_xy: torch.Tensor, tiles: PhaseATiles, uv_delta: float):
    """K8: the (2, out_h, out_w) float64 Phase A map of the (2, H, W)
    float64 swath coordinates (in the target CRS) over the tiles of
    *tiles*, equal to the JAX package's host tier bit for bit."""
    if on_cpu(swath_xy):
        return rectify_phase_a_plain(swath_xy, tiles, uv_delta)
    _, src_h, src_w = swath_xy.shape
    require_cuda(swath_xy, "swath_xy", _F64, (2, src_h, src_w))
    n = len(tiles.ints)
    quads = np.maximum(tiles.ints[:, 6] - 1, 0) * np.maximum(tiles.ints[:, 7] - 1, 0)
    max_quads = int(quads.max()) if n else 0
    if not 0 < n <= _MAX_INDEX or max_quads >= _MAX_QUADS:
        raise ValueError(f"K8 takes tiles of fewer than {_MAX_QUADS} quads: "
                         f"{n} tiles, up to {max_quads} quads")
    # (32-bit pixel indices; the last block of 256 threads runs past the map)
    if src_h * src_w > _MAX_INDEX or tiles.out_h * tiles.out_w > _MAX_INDEX - 256:
        raise ValueError(f"K8 takes swaths and maps of fewer than 2^31 pixels: swath "
                         f"{src_h}x{src_w}, map {tiles.out_h}x{tiles.out_w}")
    table, n_items = phase_a_table(tiles)
    dev = swath_xy.device
    # from pinned memory, queued on the stream: the host does not wait for
    # the card (a pageable upload would)
    table = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)
    claim = torch.empty(tiles.out_h * tiles.out_w, dtype=torch.int32, device=dev)
    out = torch.empty((2, tiles.out_h, tiles.out_w), dtype=_F64, device=dev)
    base = table.data_ptr()
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.xrt_rectify_phase_a(
            swath_xy[0].data_ptr(), swath_xy[1].data_ptr(), src_h, src_w,
            base, base + 64 * n, n, base + 80 * n, n_items, PATCH_W, PATCH_H,
            tiles.tile_h, tiles.tile_w, tiles.n_tiles_x, tiles.out_h, tiles.out_w,
            float(tiles.x_scale), float(tiles.y_scale), float(uv_delta),
            claim.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "rectify_phase_a")
    count_launch("rectify_phase_a")
    return out


# ---------------------------------------------------------------------------
# the hybrid Phase A: K11 (seed) and K12 (dense)
# ---------------------------------------------------------------------------

#: the dense kernel's static window-node buckets (rectify_ops.py:1730)
_HYBRID_WINS = (8, 12, 16, 20, 24, 28, 32, 36, 40, 48)
#: (shapes and parameters) -> (tile, win_j, win_i) of the last call with
#: them, for the optimistic dense dispatch (rectify_ops.py:2306-2385)
_HYBRID_LAST_WIN: dict = {}
#: the seed's coarse lattice: every _HYBRID_CS-th tile corner
_HYBRID_CS = 8
# (pixel, quad) pairs a chunk of the plain dense version holds
_DENSE_CHUNK = 1 << 21
_INT32_MAX = 2**31 - 1
# K12's cull bound (csrc/hybrid_phase_a.cu, tri_box): the unit roundoff,
# the conditioning and size range where the box is derived, its own slack
_EPS = 2.0**-53
_CULL_KMAX = 1e-4 / _EPS
_CULL_PMIN = 2.0**-500
_CULL_PMAX = 2.0**500
_CULL_SLACK = 2.0**-40
# a quad's reach past its nodes' box in the kernels' first pass (kCullReach)
_CULL_REACH = 2.0**-30


# The hybrid's triangle formulas as XLA's CPU backend contracts them in
# the JAX package's float64 kernels: ``a * b - c * d`` is
# ``fma(a, b, -(c * d))`` (the JAX map equals this bit for bit, not the
# plain formulas of _fdet, _fu and _fv above; tests/test_torch_sharded_rectify.py),
# the single rounding emulated in float64 (reproject_ops.fma64).


def _fdet_x(px0, py0, px1, py1, px2, py2):
    return fma64(px0 - px1, py0 - py2, -((px0 - px2) * (py0 - py1)))


def _fu_x(px, py, px0, py0, px2, py2):
    return fma64(px0 - px, py0 - py2, -((py0 - py) * (px0 - px2)))


def _fv_x(px, py, px0, py0, px1, py1):
    return fma64(py0 - py, px0 - px1, -((px0 - px) * (py0 - py1)))


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """Finite float64 *x* truncated toward zero to int32 values, saturating
    as XLA's conversion does (as int64)."""
    return x.clamp(-(2**31), _INT32_MAX).to(torch.int64)


def _tri_solve_flat(gxf, gyf, w_row, qj, qi, px, py):
    """Both triangle systems of quad (qj, qi), its corners gathered from
    the flat coordinate images (``rectify_ops._tri_solve_flat``)."""
    idx0 = qj * w_row + qi
    p0x, p1x, p2x, p3x = (gxf[idx0 + d] for d in (0, 1, w_row, w_row + 1))
    p0y, p1y, p2y, p3y = (gyf[idx0 + d] for d in (0, 1, w_row, w_row + 1))
    det_a = torch.nan_to_num(_fdet_x(p0x, p0y, p1x, p1y, p2x, p2y), nan=0.0)
    det_b = torch.nan_to_num(_fdet_x(p3x, p3y, p2x, p2y, p1x, p1y), nan=0.0)
    safe_a = torch.where(det_a == 0.0, 1.0, det_a)
    safe_b = torch.where(det_b == 0.0, 1.0, det_b)
    ua = _fu_x(px, py, p0x, p0y, p2x, p2y) / safe_a
    va = _fv_x(px, py, p0x, p0y, p1x, p1y) / safe_a
    ub = _fu_x(px, py, p3x, p3y, p1x, p1y) / safe_b
    vb = _fv_x(px, py, p3x, p3y, p2x, p2y) / safe_b
    return det_a, ua, va, det_b, ub, vb


def _walk_steps_flat(gxf, gyf, w_row, nqj, nqi, qj, qi, px, py, n_iters):
    """*n_iters* steps of the quad walk (``rectify_ops._walk_steps_flat``):
    each solves the current quad's triangle A (triangle B from the far
    corner where A is degenerate) and jumps floor(u), floor(v) quads."""
    for _ in range(n_iters):
        det_a, ua, va, _, ub, vb = _tri_solve_flat(gxf, gyf, w_row, qj, qi, px, py)
        di = torch.where(det_a != 0.0, torch.floor(ua), torch.floor(1.0 - ub))
        dj = torch.where(det_a != 0.0, torch.floor(va), torch.floor(1.0 - vb))
        di = torch.nan_to_num(di, nan=0.0, posinf=0.0, neginf=0.0)
        dj = torch.nan_to_num(dj, nan=0.0, posinf=0.0, neginf=0.0)
        qi = (qi + _to_int32(di)).clamp(0, nqi - 1)
        qj = (qj + _to_int32(dj)).clamp(0, nqj - 1)
    return qj, qi


def _affine_seed(gxf, gyf, src_h, src_w):
    """The least-squares affine fit (i, j) ~ (gx, gy) over the swath's
    nodes, centred (``rectify_ops._affine_seed``): (xm, ym, im, jm, ai,
    bi, aj, bj) with i ~ im + ai (x - xm) + bi (y - ym) and j likewise."""
    n = src_h * src_w
    dev = gxf.device
    ii = torch.arange(src_w, dtype=_F64, device=dev).repeat(src_h)
    jj = torch.arange(src_h, dtype=_F64, device=dev).repeat_interleave(src_w)
    xm = gxf.mean()
    ym = gyf.mean()
    im = (src_w - 1) / 2.0
    jm = (src_h - 1) / 2.0
    xc = gxf - xm
    yc = gyf - ym
    sxx = torch.dot(xc, xc) / n
    sxy = torch.dot(xc, yc) / n
    syy = torch.dot(yc, yc) / n
    det_m = fma64(sxx, syy, -(sxy * sxy))
    det_m = torch.where(det_m.abs() < 1e-30, 1e-30, det_m)
    rix = torch.dot(xc, ii - im) / n
    riy = torch.dot(yc, ii - im) / n
    rjx = torch.dot(xc, jj - jm) / n
    rjy = torch.dot(yc, jj - jm) / n
    ai = fma64(rix, syy, -(riy * sxy)) / det_m
    bi = fma64(riy, sxx, -(rix * sxy)) / det_m
    aj = fma64(rjx, syy, -(rjy * sxy)) / det_m
    bj = fma64(rjy, sxx, -(rjx * sxy)) / det_m
    return xm, ym, im, jm, ai, bi, aj, bj


def _hybrid_lattice(dst_shape, tile):
    """The tile grid (n_tj, n_ti) of a (dst_h, dst_w) target and the
    coarse lattice (n_cj, n_ci) of every _HYBRID_CS-th tile corner."""
    n_tj = -(-dst_shape[0] // tile)
    n_ti = -(-dst_shape[1] // tile)
    return n_tj, n_ti, n_tj // _HYBRID_CS + 2, n_ti // _HYBRID_CS + 2


def _hybrid_corner_walk(gx, gy, dst_shape, tile, coarse_iters, refine_iters):
    """The affine seed and the two-level walk on the tile-corner lattice
    (``rectify_ops._hybrid_corner_walk``): quad guesses (qj, qi), int64
    (n_tj + 1, n_ti + 1), for every corner of the target's tiles."""
    src_h, src_w = gx.shape
    nqj, nqi = src_h - 1, src_w - 1
    n_tj, n_ti, n_cj, n_ci = _hybrid_lattice(dst_shape, tile)
    cs = _HYBRID_CS
    dev = gx.device
    gxf = gx.reshape(-1)
    gyf = gy.reshape(-1)
    xm, ym, im, jm, ai, bi, aj, bj = _affine_seed(gxf, gyf, src_h, src_w)
    pxc = (torch.arange(n_ci, dtype=_F64, device=dev) * (cs * tile))[None, :].expand(n_cj, n_ci)
    pyc = (torch.arange(n_cj, dtype=_F64, device=dev) * (cs * tile))[:, None].expand(n_cj, n_ci)
    dx, dy = pxc - xm, pyc - ym
    qi0 = _to_int32(torch.nan_to_num(fma64(bi, dy, fma64(ai, dx, im)), nan=im))
    qj0 = _to_int32(torch.nan_to_num(fma64(bj, dy, fma64(aj, dx, jm)), nan=jm))
    qj_c, qi_c = _walk_steps_flat(
        gxf, gyf, src_w, nqj, nqi, qj0.clamp(0, nqj - 1), qi0.clamp(0, nqi - 1), pxc, pyc,
        coarse_iters,
    )
    qj_f = qj_c.repeat_interleave(cs, 0).repeat_interleave(cs, 1)[: n_tj + 1, : n_ti + 1]
    qi_f = qi_c.repeat_interleave(cs, 0).repeat_interleave(cs, 1)[: n_tj + 1, : n_ti + 1]
    pxf = (torch.arange(n_ti + 1, dtype=_F64, device=dev) * tile)[None, :].expand(n_tj + 1, -1)
    pyf = (torch.arange(n_tj + 1, dtype=_F64, device=dev) * tile)[:, None].expand(-1, n_ti + 1)
    return _walk_steps_flat(gxf, gyf, src_w, nqj, nqi, qj_f, qi_f, pxf, pyf, refine_iters)


def _hybrid_corner_minmax(c):
    """Per-tile min and max of the four surrounding corner values."""
    lo = torch.minimum(torch.minimum(c[:-1, :-1], c[:-1, 1:]), torch.minimum(c[1:, :-1], c[1:, 1:]))
    hi = torch.maximum(torch.maximum(c[:-1, :-1], c[:-1, 1:]), torch.maximum(c[1:, :-1], c[1:, 1:]))
    return lo, hi


def hybrid_seed_plain(gx, gy, dst_shape, tile, max_edge, margin, r0=0.0, coarse_iters=24,
                      refine_iters=6):
    """Plain PyTorch version of K11 (``rectify_ops._build_hybrid_seed_kernel``)
    on the (h, w) float64 normalised swath coordinates *gx*, *gy* (*gy*
    shifted by the band origin *r0*, one subtraction): the corner-lattice
    quad guesses *cqj*, *cqi* (int32, (n_tj + 1, n_ti + 1)) and *meta*
    (int32, [gate, need_j, need_i]): the gate (finite coordinates, one
    orientation for every quad's two triangles, no quad edge above
    *max_edge*) and the window nodes each axis needs to cover every tile's
    quad range with *margin*, clamped at the swath's bounds."""
    if r0:
        gy = gy - r0
    src_h, src_w = gx.shape
    p0x, p1x, p2x, p3x = gx[:-1, :-1], gx[:-1, 1:], gx[1:, :-1], gx[1:, 1:]
    p0y, p1y, p2y, p3y = gy[:-1, :-1], gy[:-1, 1:], gy[1:, :-1], gy[1:, 1:]
    det_a = _fdet_x(p0x, p0y, p1x, p1y, p2x, p2y)
    det_b = _fdet_x(p3x, p3y, p2x, p2y, p1x, p1y)
    finite_ok = torch.isfinite(gx).all() & torch.isfinite(gy).all()
    orient_a = (det_a.max() < 0) | (det_a.min() > 0)
    orient_b = (det_b.max() < 0) | (det_b.min() > 0)
    edge = torch.stack([(p1x - p0x).abs().max(), (p2x - p0x).abs().max(),
                        (p1y - p0y).abs().max(), (p2y - p0y).abs().max()]).max()
    gate_ok = finite_ok & orient_a & orient_b & (edge <= max_edge)
    cqj, cqi = _hybrid_corner_walk(gx, gy, dst_shape, tile, coarse_iters, refine_iters)
    qj_lo, qj_hi = _hybrid_corner_minmax(cqj)
    qi_lo, qi_hi = _hybrid_corner_minmax(cqi)
    need_j = ((qj_hi + margin).clamp(max=src_h - 2) - (qj_lo - margin).clamp(min=0)).max() + 2
    need_i = ((qi_hi + margin).clamp(max=src_w - 2) - (qi_lo - margin).clamp(min=0)).max() + 2
    meta = torch.stack([gate_ok.to(torch.int64), need_j, need_i]).to(torch.int32)
    return cqj.to(torch.int32), cqi.to(torch.int32), meta


def hybrid_tri_boxes(q0x, q0y, q1x, q1y, q2x, q2y, det, uv_delta):
    """Plain mirror of K12's and K20's triangle box (``csrc/phase_a_common.h``,
    ``tri_box``, where the bound is derived): for triangle (q0, q1, q2) with
    determinant *det* (after ``nan_to_num``), the box in pixel-centre
    coordinates outside which K12's rounded barycentric test (and this
    module's emulation of it) cannot accept: (x_lo, x_hi, y_lo, y_hi),
    float64, in K12's operations and order.  Empty where *det* is 0;
    every pixel where the triangle is too ill-conditioned (or too large or
    small) for the bound.  Only the tests, ``hybrid_dense_plain``'s
    ``cull`` and ``solved`` and ``phase_a.phase_a_tiled_plain``'s ``cull``
    use it."""
    u_min = -uv_delta
    uv_max = 1.0 + 2 * uv_delta
    d = -u_min
    c = _EPS * (1 + 3 * d)
    c1, c0, base = c * 51, c * 8, d + (uv_max - 1) + 4 * _EPS
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    e1x, e1y, e2x, e2y = q1x - q0x, q1y - q0y, q2x - q0x, q2y - q0y
    sx = e1x.abs() + e2x.abs()
    sy = e1y.abs() + e2y.abs()
    p = sx * sy
    k = p * inv.abs()
    good = (k <= _CULL_KMAX) & (p >= _CULL_PMIN) & (p <= _CULL_PMAX)
    m = base + 3.0 * (c1 * k + c0)
    mx, my = m * sx, m * sy
    xlo = torch.minimum(q0x, torch.minimum(q1x, q2x))
    xhi = torch.maximum(q0x, torch.maximum(q1x, q2x))
    ylo = torch.minimum(q0y, torch.minimum(q1y, q2y))
    yhi = torch.maximum(q0y, torch.maximum(q1y, q2y))
    box = (
        (xlo - mx) - _CULL_SLACK * ((1.0 + xlo.abs()) + mx),
        (xhi + mx) + _CULL_SLACK * ((1.0 + xhi.abs()) + mx),
        (ylo - my) - _CULL_SLACK * ((1.0 + ylo.abs()) + my),
        (yhi + my) + _CULL_SLACK * ((1.0 + yhi.abs()) + my),
    )
    # (lower bounds at even positions: +inf where empty, -inf where every pixel)
    inf = float("inf")
    return tuple(
        torch.where(det == 0.0, inf * sign, torch.where(good, b, -inf * sign))
        for b, sign in zip(box, (1, -1, 1, -1))
    )


def _in_box(box, col, row):
    """Pixels (*col*, *row*, float64 integers) whose centre lies in *box*,
    as K12 clips a box to its tile's pixels (``clip_box``)."""
    x_lo, x_hi, y_lo, y_hi = box
    return ((torch.ceil(x_lo - 0.5) <= col) & (col <= torch.floor(x_hi - 0.5))
            & (torch.ceil(y_lo - 0.5) <= row) & (row <= torch.floor(y_hi - 0.5)))


def _dense_chunks(gx, gy, cqj, cqi, dst_shape, tile, win_j, win_i, margin, r0, per_pixel=True):
    """K12's tiles, chunk by chunk (about _DENSE_CHUNK (pixel, window quad)
    pairs a chunk, or with *per_pixel* False _DENSE_CHUNK window quads),
    each a namespace: ``t`` (the chunk's tiles), ``rank``
    (T, 1, n_q: every window quad's row-major rank in the swath), its
    corners ``p0x`` ... ``p3y``, its triangles' determinants ``det_a``,
    ``det_b`` (NaN to 0) and their reciprocals ``inv_a``, ``inv_b`` (T, 1,
    n_q), and the pixel centres ``px``, ``py`` (T, n_p, 1, row-major over
    the tile)."""
    if r0:
        gy = gy - r0
    src_h, src_w = gx.shape
    nqi = src_w - 1
    n_tj, n_ti, _, _ = _hybrid_lattice(dst_shape, tile)
    dev = gx.device
    qj_lo, _ = _hybrid_corner_minmax(cqj.to(torch.int64))
    qi_lo, _ = _hybrid_corner_minmax(cqi.to(torch.int64))
    base_j = (qj_lo - margin).clamp(0, src_h - win_j).reshape(-1)
    base_i = (qi_lo - margin).clamp(0, src_w - win_i).reshape(-1)
    n_q = (win_j - 1) * (win_i - 1)
    n_p = tile * tile
    iota = torch.arange(tile, device=dev)
    wj = torch.arange(win_j, device=dev)
    wi = torch.arange(win_i, device=dev)
    step = max(1, _DENSE_CHUNK // ((n_p if per_pixel else 1) * n_q))
    for t0 in range(0, n_tj * n_ti, step):
        t = torch.arange(t0, min(t0 + step, n_tj * n_ti), device=dev)
        bj, bi = base_j[t], base_i[t]
        rows = (bj[:, None] + wj)[:, :, None]
        cols = (bi[:, None] + wi)[:, None, :]
        wx, wy = gx[rows, cols], gy[rows, cols]

        def corner(w, dj, di):  # (T, 1, n_q): one quad corner of every window quad
            return w[:, dj : dj + win_j - 1, di : di + win_i - 1].reshape(len(t), 1, n_q)

        c = SimpleNamespace(t=t)
        c.p0x, c.p1x, c.p2x, c.p3x = (corner(wx, dj, di)
                                      for dj, di in ((0, 0), (0, 1), (1, 0), (1, 1)))
        c.p0y, c.p1y, c.p2y, c.p3y = (corner(wy, dj, di)
                                      for dj, di in ((0, 0), (0, 1), (1, 0), (1, 1)))
        c.det_a = torch.nan_to_num(_fdet_x(c.p0x, c.p0y, c.p1x, c.p1y, c.p2x, c.p2y), nan=0.0)
        c.det_b = torch.nan_to_num(_fdet_x(c.p3x, c.p3y, c.p2x, c.p2y, c.p1x, c.p1y), nan=0.0)
        c.inv_a = 1.0 / torch.where(c.det_a == 0.0, 1.0, c.det_a)
        c.inv_b = 1.0 / torch.where(c.det_b == 0.0, 1.0, c.det_b)
        qj_g = (bj[:, None, None] + wj[None, :-1, None]).expand(-1, -1, win_i - 1)
        qi_g = (bi[:, None, None] + wi[None, None, :-1]).expand(-1, win_j - 1, -1)
        c.rank = (qj_g * nqi + qi_g).reshape(len(t), 1, n_q)
        px = ((t % n_ti)[:, None] * tile + iota.repeat(tile)[None, :]).to(_F64) + 0.5
        py = ((t // n_ti)[:, None] * tile + iota.repeat_interleave(tile)[None, :]).to(_F64) + 0.5
        c.px, c.py = px[:, :, None], py[:, :, None]
        yield c


def _triangles(c):
    """A chunk's two triangles of every window quad: (side, q0x, q0y, q1x,
    q1y, q2x, q2y, det, inv), triangle A (p0, p1, p2) then B (p3, p2, p1)."""
    return ((0, c.p0x, c.p0y, c.p1x, c.p1y, c.p2x, c.p2y, c.det_a, c.inv_a),
            (1, c.p3x, c.p3y, c.p2x, c.p2y, c.p1x, c.p1y, c.det_b, c.inv_b))


def _tri_test(px, py, q0x, q0y, q1x, q1y, q2x, q2y, det, inv, uv_delta):
    """Triangle (q0, q1, q2)'s solve at (px, py) as K12 rounds it: (u, v,
    whether it accepts)."""
    u = _fu_x(px, py, q0x, q0y, q2x, q2y) * inv
    v = _fv_x(px, py, q0x, q0y, q1x, q1y) * inv
    return u, v, (det != 0.0) & (u >= -uv_delta) & (v >= -uv_delta) & (u + v <= 1.0 + 2 * uv_delta)


def hybrid_dense_pairs(gx, gy, cqj, cqi, dst_shape, uv_delta, tile, win_j, win_i, margin,
                       r0=0.0, boxes=False):
    """K12's (pixel, window quad) pairs, chunk by chunk of tiles (about
    _DENSE_CHUNK pairs a chunk), each a namespace of (tiles, n_p, n_q)
    tensors: ``t`` (the chunk's tiles), ``rank`` (every quad's row-major
    rank in the swath), ``ok_a``, ``ok_b`` (whether triangle A, B accepts
    the pixel centre ``px``, ``py``; K12's own rounding), ``ua``, ``va``,
    ``ub``, ``vb``; with *boxes*, also ``cand_a``, ``cand_b``: whether the
    pixel lies in the triangle's :func:`hybrid_tri_boxes` box (the pairs
    K12 solves)."""
    for c in _dense_chunks(gx, gy, cqj, cqi, dst_shape, tile, win_j, win_i, margin, r0):
        (_, *tri_a), (_, *tri_b) = _triangles(c)
        c.ua, c.va, c.ok_a = _tri_test(c.px, c.py, *tri_a, uv_delta)
        c.ub, c.vb, c.ok_b = _tri_test(c.px, c.py, *tri_b, uv_delta)
        if boxes:
            col, row = c.px - 0.5, c.py - 0.5
            c.cand_a = _in_box(hybrid_tri_boxes(*tri_a[:7], uv_delta), col, row)
            c.cand_b = _in_box(hybrid_tri_boxes(*tri_b[:7], uv_delta), col, row)
        yield c


def _dense_winners(c, n_q, uv_delta, count):
    """Every pixel's winner in chunk *c* over all its window's pairs: (its
    window position (n_q where none wins), whether triangle A accepts it,
    the winning triangle's u and v), each (T, n_p); and with *count*, the
    pairs in the triangles' boxes a pixel."""
    (_, *tri_a), (_, *tri_b) = _triangles(c)
    ua, va, ok_a = _tri_test(c.px, c.py, *tri_a, uv_delta)
    ub, vb, ok_b = _tri_test(c.px, c.py, *tri_b, uv_delta)
    local = torch.arange(n_q, device=c.px.device)
    arg = torch.where(ok_a | ok_b, local, n_q).min(dim=-1, keepdim=True)[0]
    at_arg = arg.clamp(max=n_q - 1)

    def at(x):
        return x.expand(-1, -1, n_q).gather(-1, at_arg)[..., 0]

    take_a = at(ok_a)
    u = torch.where(take_a, at(ua), at(ub))
    v = torch.where(take_a, at(va), at(vb))
    solved = None
    if count:
        col, row = c.px - 0.5, c.py - 0.5
        solved = (_in_box(hybrid_tri_boxes(*tri_a[:7], uv_delta), col, row).sum(-1)
                  + _in_box(hybrid_tri_boxes(*tri_b[:7], uv_delta), col, row).sum(-1))
    return arg[..., 0], take_a, u, v, solved


def _box_pairs(box, x0, y0, tile):
    """The (tile, quad, pixel) pairs whose pixel centre lies in its quad's
    triangle *box* (T, 1, n_q each side), as :func:`_in_box` selects them
    and K12 clips a box to its tile's pixels (``clip_box``): per tile and
    quad the rectangle of pixels inside, enumerated.  *x0*, *y0* (T,) are
    each tile's first pixel column and row.  Returns index tensors (tile,
    quad, pixel within the tile)."""
    x_lo, x_hi, y_lo, y_hi = (b[:, 0] for b in box)
    c_lo = (torch.ceil(x_lo - 0.5) - x0[:, None]).clamp(min=0)
    c_hi = (torch.floor(x_hi - 0.5) - x0[:, None]).clamp(max=tile - 1)
    r_lo = (torch.ceil(y_lo - 0.5) - y0[:, None]).clamp(min=0)
    r_hi = (torch.floor(y_hi - 0.5) - y0[:, None]).clamp(max=tile - 1)
    n_c = (c_hi - c_lo + 1).clamp(min=0)
    n = (n_c * (r_hi - r_lo + 1).clamp(min=0)).reshape(-1)
    some = n > 0
    entry = torch.nonzero(some)[:, 0]
    n = n[some].long()
    c_lo, r_lo, n_c = (x.reshape(-1)[some].long() for x in (c_lo, r_lo, n_c))
    k = torch.arange(int(n.sum()), device=n.device) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    pick = torch.repeat_interleave(torch.arange(len(n), device=n.device), n)
    n_q = x_lo.shape[1]
    pixel = (r_lo[pick] + k // n_c[pick]) * tile + c_lo[pick] + k % n_c[pick]
    return entry[pick] // n_q, entry[pick] % n_q, pixel


def _culled_winners(c, n_q, uv_delta, count):
    """:func:`_dense_winners` over the pairs inside the triangles' boxes
    only (:func:`hybrid_tri_boxes`, enumerated by :func:`_box_pairs`), as
    K12 tests them: each triangle's solve taken at those pairs alone, the
    least key 2 * position + side a pixel kept (K12's shared atomicMin)."""
    n_t, n_p = c.px.shape[:2]
    tile = math.isqrt(n_p)
    x0, y0 = c.px[:, 0, 0] - 0.5, c.py[:, 0, 0] - 0.5
    dev = c.px.device
    pix, key, us, vs = [], [], [], []
    solved = torch.zeros(n_t * n_p, dtype=torch.int64, device=dev)
    for side, *tri in _triangles(c):
        ti, qi, pi = _box_pairs(hybrid_tri_boxes(*tri[:7], uv_delta), x0, y0, tile)
        if count:
            solved += torch.bincount(ti * n_p + pi, minlength=n_t * n_p)
        u, v, ok = _tri_test(c.px[ti, pi, 0], c.py[ti, pi, 0],
                             *(x[ti, 0, qi] for x in tri), uv_delta)
        pix.append((ti * n_p + pi)[ok])
        key.append((2 * qi + side)[ok])
        us.append(u[ok])
        vs.append(v[ok])
    pix, key, u, v = (torch.cat(x) for x in (pix, key, us, vs))
    best = torch.full((n_t * n_p,), 2 * n_q, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, pix, key, reduce="amin")
    win = key == best[pix]
    u_w = torch.full((n_t * n_p,), _NAN, dtype=_F64, device=dev)
    v_w = u_w.clone()
    u_w[pix[win]] = u[win]
    v_w[pix[win]] = v[win]
    best = best.view(n_t, n_p)
    return (best // 2, best % 2 == 0, u_w.view(n_t, n_p), v_w.view(n_t, n_p),
            solved.view(n_t, n_p) if count else None)


def hybrid_dense_plain(gx, gy, cqj, cqi, dst_shape, uv_delta, tile, win_j, win_i, margin,
                       r0=0.0, tested=None, solved=None, cull=False):
    """Plain PyTorch version of K12 (``rectify_ops._build_hybrid_dense_kernel``):
    the (2, dst_h, dst_w) float64 map.  Per tile a (win_j x win_i) node
    window at the corner guesses' minimum less *margin*, clamped into the
    swath; every pixel centre takes the window's lowest-ranked quad whose
    triangle A or B accepts it (each triangle's solve a product with the
    reciprocal of its determinant), NaN where none does; *tested*, an int32
    (dst_h, dst_w) tensor or None, takes the winner's position in the
    window's rank order plus one (the window's quads where none wins).
    *solved*, likewise, takes the (pixel, triangle) pairs K12 solves: the
    window's triangles whose box (:func:`hybrid_tri_boxes`) holds the
    pixel centre.  With *cull*, only those pairs are tested, as K12 tests
    them (and only they are solved: the fast form on the CPU)."""
    dst_h, dst_w = dst_shape
    n_tj, n_ti, _, _ = _hybrid_lattice(dst_shape, tile)
    nqi = gx.shape[1] - 1
    n_q = (win_j - 1) * (win_i - 1)
    n_p = tile * tile
    dev = gx.device
    out = torch.empty((4, n_tj * n_ti, n_p), dtype=_F64, device=dev)
    winners = _culled_winners if cull else _dense_winners
    for c in _dense_chunks(gx, gy, cqj, cqi, dst_shape, tile, win_j, win_i, margin, r0,
                           per_pixel=not cull):
        arg, take_a, u, v, count = winners(c, n_q, uv_delta, solved is not None)
        found = arg < n_q
        best = c.rank[:, 0].gather(-1, arg.clamp(max=n_q - 1))
        gi = (best % nqi).to(_F64)
        gj = (best // nqi).to(_F64)
        src_if = torch.where(take_a, gi + u.clamp(0.0, 1.0), (gi + 1) - u.clamp(0.0, 1.0))
        src_jf = torch.where(take_a, gj + v.clamp(0.0, 1.0), (gj + 1) - v.clamp(0.0, 1.0))
        out[0, c.t] = torch.where(found, src_if, _NAN)
        out[1, c.t] = torch.where(found, src_jf, _NAN)
        out[2, c.t] = torch.where(found, arg + 1, n_q).to(_F64)
        if count is not None:
            out[3, c.t] = count.to(_F64)
    out = out.reshape(4, n_tj, n_ti, tile, tile).permute(0, 1, 3, 2, 4)
    out = out.reshape(4, n_tj * tile, n_ti * tile)[:, :dst_h, :dst_w]
    if tested is not None:
        tested.copy_(out[2])
    if solved is not None:
        solved.copy_(out[3])
    return out[:2].contiguous()


# (csrc/hybrid_phase_a.cu's kPassBlocks * kStats float64 partial sums)
_SEED_SCRATCH = 396 * 10
_DENSE_TILES = (16, 12, 8, 4)


def hybrid_seed(gx, gy, dst_shape, tile, max_edge, margin, r0=0.0, coarse_iters=24,
                refine_iters=6):
    """K11: (cqj, cqi, meta) of :func:`hybrid_seed_plain` from (h, w)
    float64 *gx*, *gy* on the card, *gy* shifted by *r0* as it is read;
    *meta* stays on the card (the caller fetches its three values)."""
    if on_cpu(gx, gy):
        return hybrid_seed_plain(gx, gy, dst_shape, tile, max_edge, margin, r0, coarse_iters,
                                 refine_iters)
    src_h, src_w = gx.shape
    require_cuda(gx, "gx", _F64, (src_h, src_w))
    require_cuda(gy, "gy", _F64, (src_h, src_w))
    if src_h < 2 or src_w < 2 or src_h * src_w > _MAX_INDEX:
        raise ValueError(f"K11 takes swaths of 2 x 2 to 2^31 nodes: {src_h}x{src_w}")
    n_tj, n_ti, _, _ = _hybrid_lattice(dst_shape, tile)
    dev = gx.device
    scratch = torch.empty(_SEED_SCRATCH, dtype=_F64, device=dev)
    cqj = torch.empty((n_tj + 1, n_ti + 1), dtype=torch.int32, device=dev)
    cqi = torch.empty_like(cqj)
    meta = torch.empty(3, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.xrt_hybrid_seed(
            gx.data_ptr(), gy.data_ptr(), src_h, src_w, float(r0), dst_shape[0], dst_shape[1],
            tile, coarse_iters, refine_iters, float(max_edge), margin, scratch.data_ptr(),
            cqj.data_ptr(), cqi.data_ptr(), meta.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "hybrid_seed")
    count_launch("hybrid_seed")
    return cqj, cqi, meta


def hybrid_dense(gx, gy, cqj, cqi, dst_shape, uv_delta, tile, win_j, win_i, margin, r0=0.0,
                 tested=None, solved=None):
    """K12: the (2, dst_h, dst_w) float64 map of :func:`hybrid_dense_plain`
    on the card; *tested* and *solved*, int32 (dst_h, dst_w) tensors or
    None, take the winner's position in the window's rank order plus one
    and the (pixel, triangle) pairs solved a pixel."""
    if on_cpu(gx, gy, cqj, cqi):
        # (the culled form: the same map, the pairs no box holds left unsolved)
        return hybrid_dense_plain(gx, gy, cqj, cqi, dst_shape, uv_delta, tile, win_j, win_i,
                                  margin, r0, tested, solved, cull=True)
    src_h, src_w = gx.shape
    dst_h, dst_w = dst_shape
    n_tj, n_ti, _, _ = _hybrid_lattice(dst_shape, tile)
    require_cuda(gx, "gx", _F64, (src_h, src_w))
    require_cuda(gy, "gy", _F64, (src_h, src_w))
    require_cuda(cqj, "cqj", torch.int32, (n_tj + 1, n_ti + 1))
    require_cuda(cqi, "cqi", torch.int32, (n_tj + 1, n_ti + 1))
    for t, name in ((tested, "tested"), (solved, "solved")):
        if t is not None:
            require_cuda(t, name, torch.int32, (dst_h, dst_w))
    if tile not in _DENSE_TILES or not (2 <= win_j <= src_h and 2 <= win_i <= src_w):
        raise ValueError(f"K12 takes tiles {_DENSE_TILES} and windows inside the swath: "
                         f"tile {tile}, window {win_j}x{win_i} of {src_h}x{src_w}")
    out = torch.empty((2, dst_h, dst_w), dtype=_F64, device=gx.device)
    lib = _build.load()
    with torch.cuda.device(gx.device):
        rc = lib.xrt_hybrid_dense(
            gx.data_ptr(), gy.data_ptr(), src_h, src_w, float(r0), cqj.data_ptr(),
            cqi.data_ptr(), dst_h, dst_w, tile, win_j, win_i, margin, float(uv_delta),
            out.data_ptr(), None if tested is None else tested.data_ptr(),
            None if solved is None else solved.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "hybrid_dense")
    count_launch("hybrid_dense")
    return out


def hybrid_window(need: int, src_dim: int) -> int | None:
    """The smallest window bucket covering *need* nodes of a swath axis of
    *src_dim* nodes, or None (``inverse_ij_map_hybrid.pick``)."""
    for bucket in _HYBRID_WINS:
        if min(bucket, src_dim) >= need:
            return min(bucket, src_dim)
    return None


def inverse_ij_map_hybrid(
    src_x,
    src_y,
    src_i_min: int,
    src_j_min: int,
    dst_shape: tuple[int, int],
    dst_x_offset: float,
    dst_y_offset: float,
    dst_x_scale: float,
    dst_y_scale: float,
    uv_delta: float,
    tile: int = 16,
    margin: int = 2,
    coarse_iters: int = 24,
    refine_iters: int = 6,
    device="cuda",
):
    """The hybrid Phase A (``rectify_ops.inverse_ij_map_hybrid``): K11 seeds
    the tile corners and K12 resolves every pixel, on the swath's
    coordinates *src_x*, *src_y* (numpy arrays, or tensors on their own
    device; else on *device*) normalised as ``(x - offset) / scale`` in
    float64.  Returns a :class:`DeviceIJMap`, or None where the geometry is
    outside the hybrid's envelope (the gate refuses it, or no window
    bucket covers it at any tile of the cascade 16, 12, 8, 4).  The last
    call of the same shapes lends its window to the first dense launch,
    which stands where the seed's needs show it covers them."""
    dst_h, dst_w = dst_shape
    src_h, src_w = src_x.shape
    if src_h < 2 or src_w < 2 or dst_h < 4 or dst_w < 4 or src_h * src_w > 2**30:
        return None
    if isinstance(src_x, torch.Tensor):
        device = src_x.device
    sx = torch.as_tensor(src_x, dtype=_F64).to(device)
    sy = torch.as_tensor(src_y, dtype=_F64).to(device)
    gx = (sx - dst_x_offset) / dst_x_scale
    gy = (sy - dst_y_offset) / dst_y_scale
    del sx, sy
    max_edge = float(max(dst_h, dst_w))
    cap = _HYBRID_WINS[-1]
    family = ((src_h, src_w), (dst_h, dst_w), float(uv_delta), tile, margin, coarse_iters,
              refine_iters)
    guess = _HYBRID_LAST_WIN.get(family)
    tiles = list(_DENSE_TILES)
    if guess is not None and guess[0] in tiles:
        tiles.remove(guess[0])
        tiles.insert(0, guess[0])
    rate = None
    chosen = out = None
    for t in tiles:
        if t > tile or dst_h < t or dst_w < t:
            continue
        if rate is not None and t != 4 and rate * t + 2 * margin + 4 > cap:
            continue
        cqj, cqi, meta = hybrid_seed(gx, gy, dst_shape, t, max_edge, margin,
                                     coarse_iters=coarse_iters, refine_iters=refine_iters)
        optimistic = None
        if guess is not None and guess[0] == t:
            optimistic = hybrid_dense(gx, gy, cqj, cqi, dst_shape, uv_delta, t, guess[1],
                                      guess[2], margin)
        gate_ok, need_j, need_i = meta.tolist()
        if not gate_ok:
            return None
        if optimistic is not None and (guess[1] >= need_j or guess[1] >= src_h) and (
            guess[2] >= need_i or guess[2] >= src_w
        ):
            chosen, out = guess, optimistic
            break
        win_j, win_i = hybrid_window(need_j, src_h), hybrid_window(need_i, src_w)
        if win_j is not None and win_i is not None:
            chosen = (t, win_j, win_i)
            out = hybrid_dense(gx, gy, cqj, cqi, dst_shape, uv_delta, t, win_j, win_i, margin)
            break
        rate = max(need_j, need_i, 2 * margin + 5) / t
    if chosen is None:
        return None
    _HYBRID_LAST_WIN[family] = chosen
    if src_i_min or src_j_min:
        out = out + torch.tensor([src_i_min, src_j_min], dtype=_F64, device=out.device)[:, None, None]
    return DeviceIJMap(out)


# ---------------------------------------------------------------------------
# K7: the device Phase B gather
# ---------------------------------------------------------------------------


def _check_gather(src, interp_method):
    require_data_dtype(src.dtype, "the source")
    method_code(interp_method)
    if src.dim() != 3:
        raise ValueError(f"expected a (B, H, W) source, got {tuple(src.shape)}")
    if src.shape[-2] * src.shape[-1] >= MAX_PLANE:
        raise ValueError(f"K7 takes source planes of fewer than 2^31 elements: {tuple(src.shape)}")


def ij_gather_plain(src, ix, iy, valid, interp_method, fill_value):
    """Plain PyTorch version of K7's map form: ``gather_interp`` of (B, H,
    W) *src* at float32 positions (h, w), masked by *valid*."""
    _check_gather(src, interp_method)
    return gather_interp(src, ix, iy, interp_method, fill_value, valid=valid)


def ij_gather(src, ix, iy, valid, interp_method, fill_value):
    """K7's map form: (B, h, w) of :func:`.reproject_ops.gather_dtype`
    from (B, H, W) *src*, float32 positions *ix*, *iy* (h, w) and the
    map's mask *valid* (h, w, bool)."""
    if on_cpu(src, ix, iy, valid):
        return ij_gather_plain(src, ix, iy, valid, interp_method, fill_value)
    _check_gather(src, interp_method)
    batch, src_h, src_w = src.shape
    out_h, out_w = ix.shape
    require_cuda(src, "src", src.dtype, (batch, src_h, src_w))
    require_cuda(ix, "ix", _F32, (out_h, out_w))
    require_cuda(iy, "iy", _F32, (out_h, out_w))
    require_cuda(valid, "valid", torch.bool, (out_h, out_w))
    out_dtype = gather_dtype(src.dtype, interp_method)
    out = torch.empty((batch, out_h, out_w), dtype=out_dtype, device=src.device)
    if out.numel() == 0:
        return out
    _launch_ij_gather(src, ix, iy, valid, None, None, out, out_w, interp_method, fill_value)
    return out


def ij_gather_list_plain(out, src, ix, iy, rows, cols, interp_method, fill_value):
    """Plain PyTorch version of K7's list form: writes ``gather_interp``
    (bounds-valid) of *src* at float32 positions (n) into
    ``out[:, rows, cols]``; returns *out*."""
    _check_gather(src, interp_method)
    vals = gather_interp(src, ix, iy, interp_method, fill_value).to(out.dtype)
    # (the unsigned 16- to 64-bit dtypes have no index_put on the CPU:
    # written through their signed bits)
    view = {torch.uint16: torch.int16, torch.uint32: torch.int32,
            torch.uint64: torch.int64}.get(out.dtype, out.dtype)
    out.view(view)[:, rows.long(), cols.long()] = vals.view(view)
    return out


def ij_gather_list(out, src, ix, iy, rows, cols, interp_method, fill_value):
    """K7's list form: ``gather_interp`` of (B, H, W) *src* at the float32
    positions *ix*, *iy* (n), valid inside the source's bounds, written in
    place at (*rows*, *cols*) (int32, n) of (B, h, w) *out*, whose dtype
    must be :func:`.reproject_ops.gather_dtype`'s; returns *out*."""
    if on_cpu(out, src, ix, iy, rows, cols):
        return ij_gather_list_plain(out, src, ix, iy, rows, cols, interp_method, fill_value)
    _check_gather(src, interp_method)
    batch, src_h, src_w = src.shape
    (n,) = ix.shape
    require_cuda(src, "src", src.dtype, (batch, src_h, src_w))
    require_cuda(out, "out", gather_dtype(src.dtype, interp_method),
                 (batch,) + tuple(out.shape[1:]))
    for t, name, dtype in ((ix, "ix", _F32), (iy, "iy", _F32), (rows, "rows", torch.int32),
                           (cols, "cols", torch.int32)):
        require_cuda(t, name, dtype, (n,))
    if n:
        _launch_ij_gather(src, ix, iy, None, rows, cols, out, out.shape[-1], interp_method,
                          fill_value)
    return out


def _launch_ij_gather(src, ix, iy, valid, rows, cols, out, out_w, interp_method, fill_value):
    batch, src_h, src_w = src.shape
    fill = gather_fill(fill_value, out.dtype)
    check_taps_dtype(src.dtype, interp_method)
    lib = _build.load()
    with torch.cuda.device(src.device):
        rc = lib.xrt_ij_gather(
            src.data_ptr(), ix.data_ptr(), iy.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if rows is None else rows.data_ptr(),
            None if cols is None else cols.data_ptr(),
            out.data_ptr(), ix.numel(), batch, src_h, src_w, out_w,
            out.shape[-2] * out.shape[-1], method_code(interp_method), float(fill),
            fill_bits(fill, out.dtype), DTYPE_CODES[src.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "ij_gather")
    count_launch(launch_name("ij_gather", src.dtype))


def ij_gather_band_plain(ext, m, interp_method, fill_value, off, src_h):
    """Plain PyTorch version of K7's band form
    (``make_sharded_rectify_step.band_step``): (B, h, w) of
    :func:`.reproject_ops.gather_dtype` of the band's float32 map *m* (2,
    h, w) from ``ext`` (B, ext_h, W), which holds the global source rows
    from *off* of a source *src_h* rows high."""
    method_code(interp_method)
    dtype = ext.dtype
    check_taps_dtype(dtype, interp_method)
    ext_h, src_w = ext.shape[-2], ext.shape[-1]
    ext = widen(ext)
    valid = torch.isfinite(m[0]) & torch.isfinite(m[1])
    ix = torch.nan_to_num(m[0], nan=0.0).clamp(0, src_w - 1)
    iy = torch.nan_to_num(m[1], nan=0.0).clamp(0, src_h - 1)
    if interp_method == "nearest":
        jx = torch.round(ix).long()
        jy = torch.round(iy).long()
        vals = ext[..., (jy - off).clamp(0, ext_h - 1), jx]
        in_band = (jy >= off) & (jy < off + ext_h)
    else:
        x0f = torch.floor(ix)
        y0f = torch.floor(iy)
        x0, y0 = x0f.long(), y0f.long()
        x1 = (x0 + 1).clamp(0, src_w - 1)
        y1 = (y0 + 1).clamp(0, src_h - 1)
        y0_l = (y0 - off).clamp(0, ext_h - 1)
        y1_l = (y1 - off).clamp(0, ext_h - 1)
        vals = interp_taps(ext[..., y0_l, x0], ext[..., y0_l, x1], ext[..., y1_l, x0],
                           ext[..., y1_l, x1], ix - x0f, iy - y0f, interp_method, dtype)
        in_band = (y0 >= off) & (y1 < off + ext_h)
    out_dtype = gather_dtype(dtype, interp_method)
    fill = fill_scalar(gather_fill(fill_value, out_dtype), out_dtype, ext.device)
    return narrow(torch.where(valid & in_band, vals, fill), out_dtype)


def ij_gather_band(ext, m, interp_method, fill_value, off, src_h):
    """K7's band form: one mesh band's (B, h, w) of
    :func:`.reproject_ops.gather_dtype` rectified through its float32 map
    rows *m* (2, h, w); ``ext`` (B, ext_h, W) of a data dtype holds the
    global source rows from *off* of a source *src_h* rows high."""
    if on_cpu(ext, m):
        return ij_gather_band_plain(ext, m, interp_method, fill_value, off, src_h)
    require_data_dtype(ext.dtype, "the source")
    check_taps_dtype(ext.dtype, interp_method)
    batch, ext_h, src_w = ext.shape
    _, out_h, out_w = m.shape
    require_cuda(ext, "ext", ext.dtype, (batch, ext_h, src_w))
    require_cuda(m, "m", _F32, (2, out_h, out_w))
    if not -ext_h < off < src_h or ext_h * src_w >= MAX_PLANE or src_h * src_w >= MAX_PLANE:
        raise ValueError(f"K7 band: ext {tuple(ext.shape)} from row {off} of {src_h}")
    out_dtype = gather_dtype(ext.dtype, interp_method)
    out = torch.empty((batch, out_h, out_w), dtype=out_dtype, device=ext.device)
    if out.numel() == 0:
        return out
    fill = gather_fill(fill_value, out_dtype)
    lib = _build.load()
    with torch.cuda.device(ext.device):
        rc = lib.xrt_ij_gather_band(
            ext.data_ptr(), m.data_ptr(), out.data_ptr(), batch, ext_h, src_w, out_h, out_w,
            off, src_h, method_code(interp_method), float(fill), fill_bits(fill, out_dtype),
            DTYPE_CODES[ext.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "ij_gather_band")
    count_launch(launch_name("ij_gather_band", ext.dtype, (_F32,)))
    return out


# ---------------------------------------------------------------------------
# Phase B of tensor variables: make_device_var_image_fn
# ---------------------------------------------------------------------------


class GatherPhaseB:
    """``fn(src) -> (B, h, w)`` through K7's map form; ``fn.plain(src)``
    through its plain version.  *src* is (B, H, W) on the map's device."""

    def __init__(self, ix, iy, valid, interp_method, fill_value):
        self.ix, self.iy, self.valid = ix, iy, valid
        self.interp_method, self.fill_value = interp_method, fill_value

    def _run(self, gather, src):
        return gather(src, self.ix, self.iy, self.valid, self.interp_method, self.fill_value)

    def __call__(self, src):
        return self._run(ij_gather, src)

    def plain(self, src):
        return self._run(ij_gather_plain, src)


class SRWPhaseB:
    """``fn(src) -> (B, h, w)``: the coverage interior through the SRW (K1,
    K2; tiled or batched as the JAX package picks it) on the map's coarse
    fields, the float32 fill outside it, and the edge band through K7's
    list form; ``fn.plain(src)`` through their plain versions.  The output
    is the SRW's dtype (``rectify_ops.py:2628-2639``: float64 for float64
    sources through the tiled SRW, else float32), the edge values cast to
    it."""

    def __init__(self, srw, interior, rows, cols, ix_e, iy_e, interp_method, fill_value):
        self.srw, self.interior = srw, interior
        self.rows, self.cols, self.ix_e, self.iy_e = rows, cols, ix_e, iy_e
        self.interp_method, self.fill_value = interp_method, fill_value

    def _run(self, src, srw, gather_list):
        out = srw(src)
        out.masked_fill_(~self.interior, float(np.float32(self.fill_value)))
        edge_dtype = gather_dtype(src.dtype, self.interp_method)
        if edge_dtype == out.dtype:
            return gather_list(out, src, self.ix_e, self.iy_e, self.rows, self.cols,
                               self.interp_method, self.fill_value)
        # the edge values in their own dtype, then cast into the output's
        edge = gather_list(torch.empty(out.shape, dtype=edge_dtype, device=out.device), src,
                           self.ix_e, self.iy_e, self.rows, self.cols, self.interp_method,
                           self.fill_value)
        rows, cols = self.rows.long(), self.cols.long()
        out[:, rows, cols] = edge[:, rows, cols].to(out.dtype)
        return out

    def __call__(self, src):
        return self._run(src, self.srw, ij_gather_list)

    def plain(self, src):
        return self._run(src, self.srw.plain, ij_gather_list_plain)


def make_device_var_image_fn(
    ij_map,
    src_shape: tuple[int, int],
    fill_value,
    interp_method: str,
    src_dtype: torch.dtype = _F32,
    device="cuda",
):
    """The device Phase B of a fixed (2, h, w) float64 map (numpy array or
    tensor) for (B, *src_shape*) sources of *src_dtype*, with its statics
    on *device* (``rectify_ops.make_device_var_image_fn``).

    Bilinear and triangular resolve the interior of the coverage, the
    map's valid pixels eroded 18 times, through the tiled SRW where the
    map's coarse fields hold within 0.05 source pixels there; the edge band
    through K7's list form.  Else, and for nearest, every pixel through
    K7's map form.  ``XRTPU_PHASEB_SRW=1`` or ``0`` forces the SRW try (for
    every method) or K7, as in the JAX package."""
    if interp_method not in METHODS:
        raise unsupported(interp_method)
    require_data_dtype(src_dtype, "the source")
    src_h, src_w = src_shape
    if _want_srw(interp_method):
        from scipy.ndimage import binary_erosion

        ij_np = ij_map.cpu().numpy() if isinstance(ij_map, torch.Tensor) else np.asarray(
            ij_map, dtype=np.float64)
        valid_np = ~np.isnan(ij_np[0]) & ~np.isnan(ij_np[1])
        interior = binary_erosion(valid_np, iterations=PHASE_B_STEP + 2)
        fields = fields_from_ij_map(
            ij_np, src_h, src_w, step=PHASE_B_STEP, gate_mask=interior
        )
        plan = plan_srw(None, None, fields=fields) if fields is not None else None
        if plan is not None and interior.any():
            edge_rows, edge_cols = np.nonzero(valid_np & ~interior)

            def put(a, dtype=None):
                return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

            return SRWPhaseB(
                make_srw_fn_picked(plan, interp_method, fill_value, device),
                put(interior),
                put(edge_rows, np.int32),
                put(edge_cols, np.int32),
                put(ij_np[0][edge_rows, edge_cols], np.float32),
                put(ij_np[1][edge_rows, edge_cols], np.float32),
                interp_method,
                fill_value,
            )
    m = torch.as_tensor(ij_map, dtype=_F64).to(device)
    valid = ~(torch.isnan(m[0]) | torch.isnan(m[1]))
    return GatherPhaseB(
        torch.nan_to_num(m[0], nan=0.0).float(),
        torch.nan_to_num(m[1], nan=0.0).float(),
        valid,
        interp_method,
        fill_value,
    )


def _want_srw(interp_method: str) -> bool:
    """Whether Phase B tries the SRW interior: ``XRTPU_PHASEB_SRW=1`` or
    ``0`` forces it, else bilinear and triangular (rectify_ops.py:2500,
    :2677)."""
    env = os.environ.get("XRTPU_PHASEB_SRW", "")
    return interp_method in ("bilinear", "triangular") if env == "" else env == "1"


# ---------------------------------------------------------------------------
# the resident Phase B: over a map that stays on the device
# ---------------------------------------------------------------------------


class DeviceIJMap:
    """A Phase A map that lives on the device (``rectify_ops.DeviceIJMap``):
    the (2, h, w) float64 tensor K8 wrote.  Phase B gathers straight
    through it (:func:`make_device_var_image_fn_resident`, memoised here
    per method and fill); :meth:`as_numpy` fetches it once, for host
    consumers."""

    def __init__(self, m: torch.Tensor):
        self._m = m
        self._np = None
        self.phase_b_fns: dict = {}

    def device_map(self) -> torch.Tensor:
        return self._m

    def as_numpy(self) -> np.ndarray:
        if self._np is None:
            self._np = self._m.cpu().numpy()
        return self._np


def square_interior(valid: torch.Tensor, radius: int) -> torch.Tensor:
    """The pixels of the (h, w) bool *valid* whose square of *radius*
    holds only valid pixels, outside the image counting as invalid:
    ``scipy.ndimage.minimum_filter(valid, size=2 * radius + 1,
    mode="constant", cval=0) > 0``, as two 1D max-pools of the invalid
    mask padded with invalid (max_pool2d's own padding is -inf)."""
    invalid = (~valid).to(_F32)[None, None]
    size = 2 * radius + 1
    rows = F.max_pool2d(F.pad(invalid, (radius, radius, 0, 0), value=1.0), (1, size), stride=1)
    both = F.max_pool2d(F.pad(rows, (0, 0, radius, radius), value=1.0), (size, 1), stride=1)
    return both[0, 0] == 0


class ResidentPhaseB:
    """``fn(src) -> (B, h, w)`` over the map *m* of a :class:`DeviceIJMap`;
    ``fn.plain(src)`` through the plain versions.  K7's map form, or where
    *srw* asks for the SRW interior, the form
    :func:`_build_resident_srw_phase_b` plans for the source's extent at
    its first call (K7's map form where the geometry rejects it).  K7's
    positions and mask are made at the first call that needs them."""

    def __init__(self, m: torch.Tensor, interp_method: str, fill_value, srw: bool):
        self.m, self.interp_method, self.fill_value, self.srw = m, interp_method, fill_value, srw
        self.impls: dict = {}

    def _gather(self) -> GatherPhaseB:
        if "gather" not in self.impls:
            m = self.m
            self.impls["gather"] = GatherPhaseB(
                torch.nan_to_num(m[0], nan=0.0).float(),
                torch.nan_to_num(m[1], nan=0.0).float(),
                torch.isfinite(m[0]) & torch.isfinite(m[1]),
                self.interp_method,
                self.fill_value,
            )
        return self.impls["gather"]

    def impl(self, src_hw: tuple[int, int]):
        """The form that runs (B, *src_hw*) sources."""
        if not self.srw:
            return self._gather()
        if src_hw not in self.impls:
            self.impls[src_hw] = _build_resident_srw_phase_b(
                self.m, src_hw, self.fill_value, self.interp_method)
        return self.impls[src_hw] or self._gather()

    def __call__(self, src):
        return self.impl(tuple(src.shape[-2:]))(src)

    def plain(self, src):
        return self.impl(tuple(src.shape[-2:])).plain(src)


def make_device_var_image_fn_resident(ij_map: DeviceIJMap, fill_value, interp_method: str):
    """The resident Phase B of a :class:`DeviceIJMap` for one method and
    fill (``rectify_ops.make_device_var_image_fn_resident``), memoised on
    the map: (B, H, W) sources of the data dtypes on the map's
    device.  Nearest, and every method where ``XRTPU_PHASEB_SRW=0``, go
    through K7's map form; bilinear and triangular (every method under
    ``XRTPU_PHASEB_SRW=1``) try the SRW interior first."""
    if interp_method not in METHODS:
        raise unsupported(interp_method)
    key = (interp_method, repr(float(fill_value)))
    if key not in ij_map.phase_b_fns:
        ij_map.phase_b_fns[key] = ResidentPhaseB(
            ij_map.device_map(), interp_method, fill_value, _want_srw(interp_method))
    return ij_map.phase_b_fns[key]


def _build_resident_srw_phase_b(m: torch.Tensor, src_hw, fill_value, interp_method):
    """The SRW interior and gathered edge over the (2, h, w) float64 map
    *m* on the device (``rectify_ops._build_resident_srw_phase_b``), or
    None where the geometry rejects the plan.  Only the step lattice, the
    half-offset probes and the probes' validity reach the host (for
    ``fields_from_lattice`` and ``plan_srw``); the interior (a square
    erosion of the map's validity by 18) and the edge list are made on the
    device."""
    step = PHASE_B_STEP
    out_h, out_w = int(m.shape[-2]), int(m.shape[-1])
    if out_h < 2 * step or out_w < 2 * step:
        return None
    src_h, src_w = src_hw
    ncj = (out_h - 1) // step + 2
    nci = (out_w - 1) // step + 2
    rsel = np.minimum(np.arange(ncj) * step, out_h - 1)
    csel = np.minimum(np.arange(nci) * step, out_w - 1)
    prow = np.minimum(rsel + step // 2, out_h - 1)
    pcol = np.minimum(csel + step // 2, out_w - 1)

    dev = m.device
    valid = torch.isfinite(m[0]) & torch.isfinite(m[1])
    if not bool(valid.any()):
        return None
    rs, cs, pr, pc = (torch.from_numpy(a).to(dev) for a in (rsel, csel, prow, pcol))
    lat = m[:, rs[:, None], cs[None, :]].cpu().numpy()
    prb = m[:, pr[:, None], pc[None, :]].cpu().numpy()
    probe_valid = valid[pr[:, None], pc[None, :]].cpu().numpy()
    fields = fields_from_lattice(
        lat[0], lat[1], prb[0], prb[1], probe_valid, (prow, pcol),
        step, src_h, src_w, out_h, out_w,
    )
    if fields is None:
        return None
    plan = plan_srw(None, None, fields=fields)
    if plan is None:
        return None
    interior = square_interior(valid, step + 2)
    if not bool(interior.any()):
        return None
    edge = torch.nonzero(valid & ~interior)
    rows, cols = edge[:, 0], edge[:, 1]
    return SRWPhaseB(
        make_srw_fn_picked(plan, interp_method, fill_value, dev),
        interior,
        rows.to(torch.int32),
        cols.to(torch.int32),
        m[0][rows, cols].float(),
        m[1][rows, cols].float(),
        interp_method,
        fill_value,
    )


# ---------------------------------------------------------------------------
# Phase B of numpy variables: the host gather (K9)
# ---------------------------------------------------------------------------


def var_image_from_ij_map(src_var, ij_map, fill_value, interp_method):
    """The host Phase B of (..., H, W) *src_var* through the (2, h, w)
    float64 map, (..., h, w) of *src_var*'s dtype
    (``rectify_ops.var_image_from_ij_map``): K9's ij_map mode on the map's
    device."""
    lead = tuple(src_var.shape[:-2])
    src = src_var.reshape((-1,) + tuple(src_var.shape[-2:])).contiguous()
    out = exact_gather_ij(src, ij_map, fill_value, interp_method)
    return out.reshape(lead + tuple(out.shape[-2:]))


def __getattr__(name: str):
    """The names of :mod:`.phase_a` (``__all__``), as the JAX package's
    ``rectify_ops`` holds them: looked up there on first use, since
    :mod:`.phase_a` imports this module."""
    from . import phase_a

    if name in phase_a.__all__:
        return getattr(phase_a, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
