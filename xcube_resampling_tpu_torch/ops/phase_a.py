"""Rectify's device Phase A ladder on PyTorch tensors: the walk (K19), the
tiled stencil (K20), the scatter-min scan (K21) and the dispatch among them
and the hybrid (K11, K12).

Port of ``xcube_resampling_tpu/ops/rectify_ops.py``:

* :func:`inverse_ij_map_walk` (:1622) gates the swath on the host
  (:func:`_walk_gate`, a copy of :1358) and runs K19 (:func:`phase_a_walk`,
  ``csrc/phase_a_walk.cu``; ``_build_walk_kernel`` :1482-1621): a global
  affine seed, a coarse walk of one sample an 8 x 8 block, a fine walk a
  pixel, the exact 3 x 3 min-rank acceptance.
* :func:`plan_phase_a_device` (a copy of :992-1317, with :func:`_dilate1`
  and :func:`_fill_nan_extrapolate`) plans the tiled stencil's window
  origins from an exact coarse solve on the tile corners and solves its
  host-exception tiles exactly; both are ``inverse_ij_map`` calls there and
  K8 launches here (a tile table on the card, equal to the host kernel bit
  for bit, so the plan equals JAX's).  :meth:`PhaseAPlan.apply` runs K20
  (:func:`phase_a_tiled`, ``csrc/phase_a_tiled.cu``; ``_phase_a_tiled``
  :621-767 and ``_build_phase_a_apply`` :783-838) over the interior class
  and the band class and copies the host blocks in; K20 solves only the
  (pixel, triangle) pairs inside each triangle's box, K12's cull
  (:func:`phase_a_tiled_plain` with ``cull``, :func:`phase_a_tiled_pairs`).  The plan keeps JAX's
  window origins, clipped to its padded source (nodes past the swath are
  NaN in the kernel, as JAX's NaN padding makes them), but pads neither the
  source nor the tile lists: only the order of the quads' ranks matters.
* :func:`inverse_ij_map_jax` (:459) and :func:`_inverse_ij_map_device_scatter`
  (:502, with :func:`_ceil_pow2`) run K21 (:func:`phase_a_scan`,
  ``csrc/phase_a_scan.cu``; ``_phase_a_scan`` :303-456), the quad-parallel
  rasterise: a thread a quad, an ``atomicMin`` of its rank into each
  accepting candidate pixel's claim, then the winners' fractions.
  ``_inverse_ij_map_device_scatter`` keeps JAX's 128 padding in its host
  sweep, its ``max_span`` and memory guards, so it returns None where JAX
  does; the kernel then runs on the unpadded shapes (the padding changes no
  pixel of the cropped map).
* :func:`inverse_ij_map_device` (:2396) is JAX's ladder: the hybrid unless
  ``XRTPU_PHASEA_HYBRID=0``, the walk unless ``XRTPU_PHASEA_WALK=0``, then
  the tiled stencil; a :class:`~.rectify_ops.DeviceIJMap`, a ready map for
  degenerate geometries, or None.

The kernels run in float64 (JAX runs these tiers in float32 on an
accelerator and in float64 on the CPU under x64); their plain versions
carry the fused multiply-adds where XLA's CPU backend contracts JAX's
float64 formulas (``_fdet_x``, ``_fu_x``, ``_fv_x``; true divisions, where
the hybrid multiplies by a reciprocal), so each map equals JAX's float64
map bit for bit.  The wrappers run the plain versions for CPU tensors and
launch the kernels for CUDA tensors, or raise; they never fall back.
:mod:`.rectify_ops` looks these names up here.
"""

from __future__ import annotations

import functools
import math
import os
from types import SimpleNamespace

import numpy as np
import torch

from .. import _build
from .._device import count_launch, on_cpu, require_cuda
from .reproject_ops import fma64
from .rectify_ops import (
    _CULL_KMAX,
    _CULL_PMAX,
    _CULL_PMIN,
    _CULL_REACH,
    _DENSE_CHUNK,
    _EPS,
    _F64,
    _INT32_MAX,
    _MAX_QUADS,
    _NAN,
    _SEED_SCRATCH,
    DeviceIJMap,
    PhaseATiles,
    _affine_seed,
    _box_pairs,
    _fdet_x,
    _fu_x,
    _fv_x,
    _in_box,
    _to_int32,
    _tri_solve_flat,
    _walk_steps_flat,
    hybrid_tri_boxes,
    inverse_ij_map_hybrid,
    rectify_phase_a,
)

__all__ = [
    "PhaseAPlan",
    "_ceil_pow2",
    "_dilate1",
    "_fill_nan_extrapolate",
    "_inverse_ij_map_device_scatter",
    "_walk_gate",
    "inverse_ij_map_device",
    "inverse_ij_map_jax",
    "inverse_ij_map_walk",
    "phase_a_scan",
    "phase_a_scan_plain",
    "phase_a_tiled",
    "phase_a_tiled_pairs",
    "phase_a_tiled_plain",
    "phase_a_walk",
    "phase_a_walk_plain",
    "plan_phase_a_device",
]

# ---------------------------------------------------------------------------
# shared by the tiers
# ---------------------------------------------------------------------------


def _normalised(src_x, src_y, dst_x_offset, dst_y_offset, dst_x_scale, dst_y_scale, device):
    """The swath's coordinates in the target's pixel units, float64 numpy
    arrays normalised on the host as the JAX package does (``(x - offset) /
    scale``), and the device to work on: the tensors' own, else
    *device*."""
    if isinstance(src_x, torch.Tensor):
        device = src_x.device
        src_x, src_y = src_x.detach().cpu().numpy(), src_y.detach().cpu().numpy()
    gx = (np.asarray(src_x, dtype=np.float64) - dst_x_offset) / dst_x_scale
    gy = (np.asarray(src_y, dtype=np.float64) - dst_y_offset) / dst_y_scale
    return gx, gy, device


def _upload(gx: np.ndarray, gy: np.ndarray, device) -> torch.Tensor:
    """The (2, h, w) float64 tensor of *gx*, *gy* on *device*."""
    return torch.from_numpy(np.stack([gx, gy])).to(device)


def _offset(m: torch.Tensor, src_i_min: int, src_j_min: int) -> torch.Tensor:
    """The map *m* with the window's origin added to its indices."""
    if src_i_min or src_j_min:
        m = m + torch.tensor([src_i_min, src_j_min], dtype=_F64, device=m.device)[:, None, None]
    return m


def _tri_accept(det, u, v, u_min, uv_max):
    return (det != 0.0) & (u >= u_min) & (v >= u_min) & (u + v <= uv_max)


# ---------------------------------------------------------------------------
# K19: the walk
# ---------------------------------------------------------------------------


def _walk_gate(gx32: np.ndarray, gy32: np.ndarray, max_edge: float) -> bool:
    """Host gate for the Newton-walk Phase A (``rectify_ops._walk_gate``, a
    copy): every coordinate finite, every quad's two triangle determinants
    nonzero with one orientation sign across the image, no quad edge longer
    than ``max_edge`` grid units.  One vectorized float32 pass."""
    if not (np.isfinite(gx32).all() and np.isfinite(gy32).all()):
        return False
    p0x = gx32[:-1, :-1]
    p1x = gx32[:-1, 1:]
    p2x = gx32[1:, :-1]
    p3x = gx32[1:, 1:]
    p0y = gy32[:-1, :-1]
    p1y = gy32[:-1, 1:]
    p2y = gy32[1:, :-1]
    p3y = gy32[1:, 1:]
    det_a = (p1x - p0x) * (p2y - p0y) - (p2x - p0x) * (p1y - p0y)
    if det_a.max() >= 0 and det_a.min() <= 0:
        return False
    det_b = (p2x - p3x) * (p1y - p3y) - (p1x - p3x) * (p2y - p3y)
    if det_b.max() >= 0 and det_b.min() <= 0:
        return False
    edge = max(
        float(np.abs(p1x - p0x).max()),
        float(np.abs(p2x - p0x).max()),
        float(np.abs(p1y - p0y).max()),
        float(np.abs(p2y - p0y).max()),
    )
    return edge <= max_edge


def phase_a_walk_plain(g, dst_shape, uv_delta, coarse_stride=8, coarse_iters=24, fine_iters=4):
    """Plain PyTorch version of K19 (``rectify_ops._build_walk_kernel``):
    the (2, dst_h, dst_w) float64 map of the (2, h, w) float64 normalised
    swath coordinates *g*, composed as JAX composes it."""
    dst_h, dst_w = dst_shape
    _, src_h, src_w = g.shape
    nqj, nqi = src_h - 1, src_w - 1
    gxf, gyf = g[0].reshape(-1), g[1].reshape(-1)
    dev = g.device
    xm, ym, im, jm, ai, bi, aj, bj = _affine_seed(gxf, gyf, src_h, src_w)
    cs = coarse_stride
    ch, cw = -(-dst_h // cs), -(-dst_w // cs)
    pxc = (torch.arange(cw, dtype=_F64, device=dev) * cs + 0.5)[None, :].expand(ch, cw)
    pyc = (torch.arange(ch, dtype=_F64, device=dev) * cs + 0.5)[:, None].expand(ch, cw)
    qi0 = _to_int32(torch.nan_to_num(fma64(bi, pyc - ym, fma64(ai, pxc - xm, im)), nan=im))
    qj0 = _to_int32(torch.nan_to_num(fma64(bj, pyc - ym, fma64(aj, pxc - xm, jm)), nan=jm))
    qj_c, qi_c = _walk_steps_flat(gxf, gyf, src_w, nqj, nqi, qj0.clamp(0, nqj - 1),
                                  qi0.clamp(0, nqi - 1), pxc, pyc, coarse_iters)
    # the nearest upsample, then the fine walk from it
    qj = qj_c.repeat_interleave(cs, 0).repeat_interleave(cs, 1)[:dst_h, :dst_w]
    qi = qi_c.repeat_interleave(cs, 0).repeat_interleave(cs, 1)[:dst_h, :dst_w]
    px = (torch.arange(dst_w, dtype=_F64, device=dev) + 0.5)[None, :].expand(dst_h, dst_w)
    py = (torch.arange(dst_h, dtype=_F64, device=dev) + 0.5)[:, None].expand(dst_h, dst_w)
    qj, qi = _walk_steps_flat(gxf, gyf, src_w, nqj, nqi, qj, qi, px, py, fine_iters)
    # the 3 x 3 min-rank acceptance around the walk's quad
    u_min, uv_max = -uv_delta, 1.0 + 2 * uv_delta
    best = torch.full((dst_h, dst_w), _INT32_MAX, dtype=torch.int64, device=dev)
    out_i = torch.full((dst_h, dst_w), _NAN, dtype=_F64, device=dev)
    out_j = out_i.clone()
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            cj = (qj + dj).clamp(0, nqj - 1)
            ci = (qi + di).clamp(0, nqi - 1)
            det_a, ua, va, det_b, ub, vb = _tri_solve_flat(gxf, gyf, src_w, cj, ci, px, py)
            ok_a = _tri_accept(det_a, ua, va, u_min, uv_max)
            ok_b = _tri_accept(det_b, ub, vb, u_min, uv_max)
            rank = cj * nqi + ci
            gi, gj = ci.to(_F64), cj.to(_F64)
            src_if = torch.where(ok_a, gi + ua.clamp(0.0, 1.0), (gi + 1) - ub.clamp(0.0, 1.0))
            src_jf = torch.where(ok_a, gj + va.clamp(0.0, 1.0), (gj + 1) - vb.clamp(0.0, 1.0))
            better = (ok_a | ok_b) & (rank < best)
            best = torch.where(better, rank, best)
            out_i = torch.where(better, src_if, out_i)
            out_j = torch.where(better, src_jf, out_j)
    return torch.stack([out_i, out_j])


def phase_a_walk(g, dst_shape, uv_delta, coarse_stride=8, coarse_iters=24, fine_iters=4):
    """K19: the (2, dst_h, dst_w) float64 map of :func:`phase_a_walk_plain`
    on the card, from (2, h, w) float64 *g* (three launches: K11's pass for
    the seed's sums, the coarse walk, the fine walk with the acceptance)."""
    if on_cpu(g):
        return phase_a_walk_plain(g, dst_shape, uv_delta, coarse_stride, coarse_iters,
                                  fine_iters)
    _, src_h, src_w = g.shape
    require_cuda(g, "g", _F64, (2, src_h, src_w))
    dst_h, dst_w = dst_shape
    if src_h < 2 or src_w < 2 or src_h * src_w > 2**30 or dst_h < 1 or dst_w < 1:
        raise ValueError(f"K19 takes swaths of 2 x 2 to 2^30 nodes and a target: "
                         f"{src_h}x{src_w} onto {dst_h}x{dst_w}")
    ch, cw = -(-dst_h // coarse_stride), -(-dst_w // coarse_stride)
    dev = g.device
    scratch = torch.empty(_SEED_SCRATCH, dtype=_F64, device=dev)
    cq = torch.empty(2 * ch * cw, dtype=torch.int32, device=dev)
    out = torch.empty((2, dst_h, dst_w), dtype=_F64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.xrt_phase_a_walk(
            g[0].data_ptr(), g[1].data_ptr(), src_h, src_w, dst_h, dst_w, coarse_stride,
            coarse_iters, fine_iters, float(uv_delta), scratch.data_ptr(), cq.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "phase_a_walk")
    count_launch("phase_a_walk")
    return out


def inverse_ij_map_walk(
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
    coarse_stride: int = 8,
    coarse_iters: int = 24,
    fine_iters: int = 4,
    device="cuda",
) -> DeviceIJMap | None:
    """The Newton-walk Phase A (``rectify_ops.inverse_ij_map_walk``): K19 on
    the swath's coordinates *src_x*, *src_y* (numpy arrays, or tensors on
    their own device; else on *device*), or None where :func:`_walk_gate`
    refuses the swath (NaN, folds, an edge past the target's extent) or its
    shape is outside the walk's."""
    dst_h, dst_w = dst_shape
    src_h, src_w = src_x.shape
    if src_h < 2 or src_w < 2 or dst_h < 1 or dst_w < 1 or src_h * src_w > 2**30:
        return None
    gx, gy, device = _normalised(src_x, src_y, dst_x_offset, dst_y_offset, dst_x_scale,
                                 dst_y_scale, device)
    if not _walk_gate(gx.astype(np.float32), gy.astype(np.float32),
                      max_edge=float(max(dst_h, dst_w))):
        return None
    out = phase_a_walk(_upload(gx, gy, device), dst_shape, uv_delta, coarse_stride,
                       coarse_iters, fine_iters)
    return DeviceIJMap(_offset(out, src_i_min, src_j_min))


# ---------------------------------------------------------------------------
# K20: the tiled stencil and its planner
# ---------------------------------------------------------------------------


def _dilate1(m: np.ndarray) -> np.ndarray:
    """8-connected binary dilation by one cell (``rectify_ops._dilate1``)."""
    out = m.copy()
    out[1:, :] |= m[:-1, :]
    out[:-1, :] |= m[1:, :]
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    out[1:, 1:] |= m[:-1, :-1]
    out[1:, :-1] |= m[:-1, 1:]
    out[:-1, 1:] |= m[1:, :-1]
    out[:-1, :-1] |= m[1:, 1:]
    return out


def _fill_nan_extrapolate(a: np.ndarray, max_iters: int = 8) -> np.ndarray:
    """Fill NaN cells of a (2, h, w) field by linear extrapolation from
    valid neighbours (``rectify_ops._fill_nan_extrapolate``, a copy): 2 v1
    - v2 along each axis direction, averaged over the available directions,
    the nearest copy where only one neighbour exists; cells farther than
    *max_iters* from the footprint take the nearest valid value."""
    a = a.copy()
    for _ in range(max_iters):
        nan = np.isnan(a[0])
        if not nan.any():
            break
        est = np.zeros_like(a)
        cnt = np.zeros(a.shape[1:], dtype=np.int32)
        for axis, sign in ((1, 1), (1, -1), (2, 1), (2, -1)):
            v1 = np.roll(a, sign, axis=axis)
            v2 = np.roll(a, 2 * sign, axis=axis)
            # roll wraps: kill the wrapped border band
            ax = axis - 1
            v1_ok = ~np.isnan(v1[0])
            v2_ok = ~np.isnan(v2[0])
            border = np.zeros_like(v1_ok)
            idx = [slice(None)] * 2
            idx[ax] = slice(0, sign) if sign > 0 else slice(sign, None)
            border[tuple(idx)] = True
            v1_ok &= ~border
            idx[ax] = slice(0, 2 * sign) if sign > 0 else slice(2 * sign, None)
            border2 = np.zeros_like(v1_ok)
            border2[tuple(idx)] = True
            v2_ok &= ~border2
            take = nan & v1_ok
            lin = take & v2_ok
            contrib = np.where(lin, 2 * v1 - v2, v1)
            est[:, take] += contrib[:, take]
            cnt[take] += 1
        filled = nan & (cnt > 0)
        a[:, filled] = est[:, filled] / cnt[filled]
    nan = np.isnan(a[0])
    if nan.any():
        from scipy.ndimage import distance_transform_edt

        _, (jj, ii) = distance_transform_edt(nan, return_indices=True)
        a[:, nan] = a[:, jj[nan], ii[nan]]
    return a


def _tiled_chunks(g, tiles, bjs, bis, win, tile, n_ti, per_pixel=True):
    """K20's listed tiles, chunk by chunk (about _DENSE_CHUNK (pixel, window
    quad) pairs a chunk, or with *per_pixel* False _DENSE_CHUNK window
    quads), each a namespace: ``t``, ``bj``, ``bi`` (the chunk's tiles and
    window origins), every window quad's corners ``p0x`` ... ``p3y`` and its
    triangles' determinants ``det_a``, ``det_b`` (NaN to 0) (T, 1, nq; nodes
    past the swath NaN), the pixel centres ``px``, ``py`` (T, n_p, 1,
    row-major over the tile) and their ``rows``, ``cols`` (T, n_p)."""
    _, src_h, src_w = g.shape
    dev = g.device
    n = len(bjs)
    tiles = torch.arange(n, device=dev) if tiles is None else tiles.long()
    bjs, bis = bjs.long(), bis.long()
    pad_h = max(src_h, int(bjs.max()) + win)
    pad_w = max(src_w, int(bis.max()) + win)
    gp = torch.full((2, pad_h, pad_w), _NAN, dtype=_F64, device=dev)
    gp[:, :src_h, :src_w] = g
    wq = win - 1
    nq = wq * wq
    q_dj = torch.arange(wq, device=dev).repeat_interleave(wq)
    q_di = torch.arange(wq, device=dev).repeat(wq)
    iota = torch.arange(tile, device=dev)
    step = max(1, _DENSE_CHUNK // ((tile * tile if per_pixel else 1) * nq))
    for t0 in range(0, n, step):
        c = SimpleNamespace(t=tiles[t0:t0 + step], bj=bjs[t0:t0 + step], bi=bis[t0:t0 + step])
        qj = c.bj[:, None] + q_dj
        qi = c.bi[:, None] + q_di
        c.p0x, c.p1x, c.p2x, c.p3x = (gp[0, qj + a, qi + b][:, None, :]
                                      for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)))
        c.p0y, c.p1y, c.p2y, c.p3y = (gp[1, qj + a, qi + b][:, None, :]
                                      for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)))
        c.det_a = torch.nan_to_num(_fdet_x(c.p0x, c.p0y, c.p1x, c.p1y, c.p2x, c.p2y), nan=0.0)
        c.det_b = torch.nan_to_num(_fdet_x(c.p3x, c.p3y, c.p2x, c.p2y, c.p1x, c.p1y), nan=0.0)
        c.rows = (c.t // n_ti)[:, None] * tile + iota.repeat_interleave(tile)
        c.cols = (c.t % n_ti)[:, None] * tile + iota.repeat(tile)
        c.px = (c.cols.to(_F64) + 0.5)[:, :, None]
        c.py = (c.rows.to(_F64) + 0.5)[:, :, None]
        yield c


def _tiled_triangles(c):
    """A chunk's two triangles of every window quad: (side, q0x, q0y, q1x,
    q1y, q2x, q2y, det), triangle A (p0, p1, p2) then B (p3, p2, p1)."""
    return ((0, c.p0x, c.p0y, c.p1x, c.p1y, c.p2x, c.p2y, c.det_a),
            (1, c.p3x, c.p3y, c.p2x, c.p2y, c.p1x, c.p1y, c.det_b))


def _tiled_solve(px, py, q0x, q0y, q1x, q1y, q2x, q2y, det, uv_delta):
    """Triangle (q0, q1, q2)'s solve at (px, py) as K20 rounds it (true
    divisions, ``tri_accepts``): (u, v, whether it accepts)."""
    safe = torch.where(det == 0.0, 1.0, det)
    u = _fu_x(px, py, q0x, q0y, q2x, q2y) / safe
    v = _fv_x(px, py, q0x, q0y, q1x, q1y) / safe
    return u, v, _tri_accept(det, u, v, -uv_delta, 1.0 + 2 * uv_delta)


def _dense_tiled_winners(c, nq, uv_delta):
    """Every pixel's winner in chunk *c* over all its window's pairs: (its
    window position, nq where none wins; whether triangle A accepts it; the
    winning triangle's u and v), each (T, n_p)."""
    (_, *tri_a), (_, *tri_b) = _tiled_triangles(c)
    ua, va, ok_a = _tiled_solve(c.px, c.py, *tri_a, uv_delta)
    ub, vb, ok_b = _tiled_solve(c.px, c.py, *tri_b, uv_delta)
    # (a window quad's local row-major index orders it as its global rank)
    rank = torch.arange(nq, device=c.px.device)
    best, arg = torch.where(ok_a | ok_b, rank, nq).min(dim=-1, keepdim=True)

    # the winner solved again: the same operations on the same operands
    def at(x):
        return x.gather(-1, arg)[..., 0]

    take_a = at(ok_a)
    return (best[..., 0], take_a, torch.where(take_a, at(ua), at(ub)),
            torch.where(take_a, at(va), at(vb)))


def _culled_tiled_winners(c, nq, uv_delta):
    """:func:`_dense_tiled_winners` over the pairs inside the triangles'
    boxes only (``rectify_ops.hybrid_tri_boxes``, enumerated as K20 clips
    them), as K20 tests them: each triangle's solve at those pairs alone,
    the least key 2 * position + side a pixel kept (K20's shared
    atomicMin)."""
    n_t, n_p = c.px.shape[:2]
    tile = math.isqrt(n_p)
    x0, y0 = c.px[:, 0, 0] - 0.5, c.py[:, 0, 0] - 0.5
    dev = c.px.device
    pix, key, us, vs = [], [], [], []
    for side, *tri in _tiled_triangles(c):
        ti, qi, pi = _box_pairs(hybrid_tri_boxes(*tri, uv_delta), x0, y0, tile)
        u, v, ok = _tiled_solve(c.px[ti, pi, 0], c.py[ti, pi, 0],
                                *(x[ti, 0, qi] for x in tri), uv_delta)
        pix.append((ti * n_p + pi)[ok])
        key.append((2 * qi + side)[ok])
        us.append(u[ok])
        vs.append(v[ok])
    pix, key, u, v = (torch.cat(x) for x in (pix, key, us, vs))
    best = torch.full((n_t * n_p,), 2 * nq, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, pix, key, reduce="amin")
    win = key == best[pix]
    u_w = torch.full((n_t * n_p,), _NAN, dtype=_F64, device=dev)
    v_w = u_w.clone()
    u_w[pix[win]] = u[win]
    v_w[pix[win]] = v[win]
    best = best.view(n_t, n_p)
    return best // 2, best % 2 == 0, u_w.view(n_t, n_p), v_w.view(n_t, n_p)


def phase_a_tiled_plain(g, tiles, bjs, bis, win, tile, n_ti, uv_delta, out, cull=False):
    """Plain PyTorch version of K20 (``rectify_ops._phase_a_tiled``'s
    broadcast, a chunk of tiles at a time): the listed tiles (*tiles*, or
    all n = len(*bjs*) from 0) of (2, h, w) float64 *g*, each testing the
    quads of its *win* x *win* window at (*bjs*, *bis*) (nodes past the
    swath NaN), written into the (2, dst_h, dst_w) *out*; returns *out*.
    With *cull*, only the (pixel, triangle) pairs inside the triangles'
    boxes are solved, as K20 solves them (the same map: the fast form on
    the CPU)."""
    dst_h, dst_w = out.shape[-2:]
    if len(bjs) == 0:
        return out
    wq = win - 1
    nq = wq * wq
    winners = _culled_tiled_winners if cull else _dense_tiled_winners
    for c in _tiled_chunks(g, tiles, bjs, bis, win, tile, n_ti, per_pixel=not cull):
        arg, take_a, u, v = winners(c, nq, uv_delta)
        found = arg < nq
        w = arg.clamp(max=nq - 1)
        gi = (c.bi[:, None] + w % wq).to(_F64)
        gj = (c.bj[:, None] + w // wq).to(_F64)
        src_if = torch.where(take_a, gi + u.clamp(0.0, 1.0), (gi + 1) - u.clamp(0.0, 1.0))
        src_jf = torch.where(take_a, gj + v.clamp(0.0, 1.0), (gj + 1) - v.clamp(0.0, 1.0))
        keep = (c.rows < dst_h) & (c.cols < dst_w)
        rows, cols = c.rows[keep], c.cols[keep]
        out[0, rows, cols] = torch.where(found, src_if, _NAN)[keep]
        out[1, rows, cols] = torch.where(found, src_jf, _NAN)[keep]
    return out


def phase_a_tiled_pairs(g, tiles, bjs, bis, win, tile, n_ti, uv_delta, dst_shape):
    """K20's (pixel, window quad) pairs, chunk by chunk of tiles, for the
    tests: each chunk of :func:`_tiled_chunks` with ``ok_a``, ``ok_b``
    (T, n_p, nq: whether triangle A, B accepts the pixel, K20's own
    rounding), ``cand_a``, ``cand_b`` (the pixel lies in the triangle's
    box, clipped to the tile's pixels inside the target: the pairs K20
    solves) and ``listed`` (T, 1, nq: the quads K20's first pass keeps)."""
    dst_h, dst_w = dst_shape
    pad_max = _cull_pad_max(uv_delta)
    for c in _tiled_chunks(g, tiles, bjs, bis, win, tile, n_ti):
        (_, *tri_a), (_, *tri_b) = _tiled_triangles(c)
        _, _, c.ok_a = _tiled_solve(c.px, c.py, *tri_a, uv_delta)
        _, _, c.ok_b = _tiled_solve(c.px, c.py, *tri_b, uv_delta)
        inside = ((c.rows < dst_h) & (c.cols < dst_w))[:, :, None]
        col, row = c.px - 0.5, c.py - 0.5
        c.cand_a = _in_box(hybrid_tri_boxes(*tri_a, uv_delta), col, row) & inside
        c.cand_b = _in_box(hybrid_tri_boxes(*tri_b, uv_delta), col, row) & inside
        # pass 1: the nodes' box grown as far as the triangles' boxes can
        # grow, against the tile's pixel centres inside the target
        x0, y0 = c.px[:, :1] - 0.5, c.py[:, :1] - 0.5
        n_cols = (dst_w - x0).clamp(max=tile)
        n_rows = (dst_h - y0).clamp(max=tile)
        xs, ys = (c.p0x, c.p1x, c.p2x, c.p3x), (c.p0y, c.p1y, c.p2y, c.p3y)
        xl, xh, yl, yh = (functools.reduce(f, v) for f, v in (
            (torch.fmin, xs), (torch.fmax, xs), (torch.fmin, ys), (torch.fmax, ys)))
        rx = (2 * pad_max) * (xh - xl) + _CULL_REACH * ((1 + xl.abs()) + xh.abs())
        ry = (2 * pad_max) * (yh - yl) + _CULL_REACH * ((1 + yl.abs()) + yh.abs())
        meets = ((xl - rx <= x0 + (n_cols - 0.5)) & (xh + rx >= x0 + 0.5)
                 & (yl - ry <= y0 + (n_rows - 0.5)) & (yh + ry >= y0 + 0.5))
        c.listed = meets | ~(_cull_sure(*tri_a) & _cull_sure(*tri_b))
        yield c


def _cull_pad_max(uv_delta):
    """The cull's pad_max (``phase_a_common.h``, ``cull_of``): the largest
    barycentric growth of a triangle's box where its bound is derived."""
    uv_max = 1.0 + 2 * uv_delta
    c = _EPS * (1 + 3 * uv_delta)
    base = uv_delta + (uv_max - 1) + 4 * _EPS
    return base + 3.0 * (c * 51 * _CULL_KMAX + c * 8)


def _cull_sure(q0x, q0y, q1x, q1y, q2x, q2y, det):
    """``phase_a_common.h``'s ``sure``: the triangle is dropped (*det*, NaN
    to 0, is 0) or well inside the box's derived range."""
    p = (((q1x - q0x).abs() + (q2x - q0x).abs())
         * ((q1y - q0y).abs() + (q2y - q0y).abs()))
    return (det == 0) | ((p <= (_CULL_KMAX / 2) * det.abs()) & (p >= _CULL_PMIN)
                         & (p <= _CULL_PMAX))


def _tiled_smem(win: int, tile: int) -> int:
    """K20's shared memory a block (``csrc/phase_a_tiled.cu``): the window's
    nodes, the pixels' keys and the list of quads."""
    return 16 * win * win + 4 * tile * tile + 4 * (win - 1) ** 2


# the shared memory a K20 block may take (227 KB, less its list's count)
_TILED_SMEM_MAX = 232448 - 16


def phase_a_tiled(g, tiles, bjs, bis, win, tile, n_ti, uv_delta, out):
    """K20: :func:`phase_a_tiled_plain` on the card, one launch: *tiles*
    (int32, n) or None for tiles 0 .. n - 1, *bjs*, *bis* (int32, n), *out*
    (2, dst_h, dst_w) float64 written in place and returned.  On CPU
    tensors the culled plain form, K20's pairs (the same map)."""
    if on_cpu(g, bjs, bis, out):
        return phase_a_tiled_plain(g, tiles, bjs, bis, win, tile, n_ti, uv_delta, out,
                                   cull=True)
    _, src_h, src_w = g.shape
    (n,) = bjs.shape
    require_cuda(g, "g", _F64, (2, src_h, src_w))
    require_cuda(bjs, "bjs", torch.int32, (n,))
    require_cuda(bis, "bis", torch.int32, (n,))
    if tiles is not None:
        require_cuda(tiles, "tiles", torch.int32, (n,))
    require_cuda(out, "out", _F64, (2,) + tuple(out.shape[1:]))
    if not (2 <= win and 1 <= tile <= 32 and _tiled_smem(win, tile) <= _TILED_SMEM_MAX):
        raise ValueError(f"K20 takes tiles of 1 to 32 pixels and windows of 2 nodes up to "
                         f"its block's {_TILED_SMEM_MAX} bytes of shared memory (107 at tile "
                         f"8): window {win}, tile {tile}")
    lib = _build.load()
    with torch.cuda.device(g.device):
        rc = lib.xrt_phase_a_tiled(
            g[0].data_ptr(), g[1].data_ptr(), src_h, src_w,
            None if tiles is None else tiles.data_ptr(), bjs.data_ptr(), bis.data_ptr(), n, win,
            tile, n_ti, out.shape[1], out.shape[2], float(uv_delta), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "phase_a_tiled")
    count_launch("phase_a_tiled")
    return out


class PhaseAPlan:
    """The host plan of the tiled device Phase A (``rectify_ops.PhaseAPlan``,
    made by :func:`plan_phase_a_device`): the normalised swath ``g`` on the
    card ((2, h, w) float64, not padded), the target's tiling (``tile``,
    ``n_tj``, ``n_ti``, ``dst_h``, ``dst_w``), JAX's padded source extent
    (``src_h_p``, ``src_w_p``; ``nqi`` = ``src_w_p`` - 1), the window's
    origin (``src_i_min``, ``src_j_min``), the interior class ``cls_all``
    (every tile: ``win``, ``n_real``, ``bjs``, ``bis``), the band class
    ``cls_band`` (``sel``, ``tjs``, ``tis``, ``bjs``, ``bis``, ``win``,
    ``n_real``; None where it has no tile) and the host blocks
    ``host_blocks`` ((tile ids, (2, n, tile, tile) maps solved by K8) or
    None); index lists are int32 tensors on the card, not padded."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def apply(self) -> torch.Tensor:
        """The (2, dst_h, dst_w) float64 map (window-relative indices): K20
        over every tile at the interior window, over the band class's tiles
        at its window, then the host blocks copied in."""
        return self._run(phase_a_tiled)

    def plain(self) -> torch.Tensor:
        """:meth:`apply` through K20's plain version."""
        return self._run(phase_a_tiled_plain)

    def _run(self, tiled) -> torch.Tensor:
        dev = self.g.device
        out = torch.empty((2, self.dst_h, self.dst_w), dtype=_F64, device=dev)
        c = self.cls_all
        tiled(self.g, None, c["bjs"], c["bis"], c["win"], self.tile, self.n_ti, self.uv_delta,
              out)
        if self.cls_band is not None:
            c = self.cls_band
            tiled(self.g, c["sel"], c["bjs"], c["bis"], c["win"], self.tile, self.n_ti,
                  self.uv_delta, out)
        if self.host_blocks is not None:
            sel, blocks = self.host_blocks
            sel = sel.long()
            ar = torch.arange(self.tile, device=dev)
            rows = ((sel // self.n_ti)[:, None, None] * self.tile + ar[:, None]).expand(
                -1, self.tile, self.tile)
            cols = ((sel % self.n_ti)[:, None, None] * self.tile + ar).expand(
                -1, self.tile, self.tile)
            keep = (rows < self.dst_h) & (cols < self.dst_w)
            out[:, rows[keep], cols[keep]] = blocks[:, keep]
        return out


def _one_tile(ch: int, cw: int, src_h: int, src_w: int, origin: float, scale: float):
    """K8's table of one (ch x cw) tile over the whole swath, at *origin*
    and *scale* on both axes: ``inverse_ij_map`` of the whole image."""
    return PhaseATiles(
        ints=np.array([[0, 0, ch, cw, 0, 0, src_w, src_h]], dtype=np.int64),
        origins=np.array([[origin, origin]], dtype=np.float64),
        x_scale=scale, y_scale=scale, tile_h=ch, tile_w=cw, n_tiles_x=1, out_h=ch, out_w=cw,
    )


def plan_phase_a_device(
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
    tile: int = 8,
    max_win: int = 48,
    device="cuda",
):
    """Host planning of the tiled device Phase A (``rectify_ops.plan_phase_a_device``,
    a copy but for its two ``inverse_ij_map`` calls, which run on K8): an
    exact coarse solve on the destination tile corners, the seed field
    extended past the footprint, and per tile a window origin in three
    classes (interior, boundary band, host exception, solved exactly).
    Returns a :class:`PhaseAPlan`, a ready (2, dst_h, dst_w) float64 map
    (degenerate geometries), or None outside the device envelope (an edge
    past 8 tiles, an interior window past *max_win*, more than 1024 host
    tiles)."""
    from scipy.ndimage import distance_transform_edt

    dst_h, dst_w = dst_shape
    gx, gy, device = _normalised(src_x, src_y, dst_x_offset, dst_y_offset, dst_x_scale,
                                 dst_y_scale, device)
    src_h, src_w = gx.shape
    if src_h < 2 or src_w < 2:
        return np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)

    n_tj = -(-dst_h // tile)
    n_ti = -(-dst_w // tile)
    # coarse samples on tile corners: sample (cj, ci) at fine pixel
    # (tile*cj, tile*ci), i.e. grid-unit position tile*cj + 0.5
    ch, cw = n_tj + 1, n_ti + 1
    off = 0.5 - 0.5 * tile
    g = _upload(gx, gy, device)
    seed = rectify_phase_a(g, _one_tile(ch, cw, src_h, src_w, off, float(tile)),
                           uv_delta).cpu().numpy()
    valid = np.isfinite(seed[0])

    # forward node presence: every destination tile that a source grid node
    # lands in, dilated by the largest quad edge length (float32 suffices:
    # the dilation rounds the edge up)
    n_t = n_tj * n_ti
    gx32 = gx.astype(np.float32)
    gy32 = gy.astype(np.float32)
    with np.errstate(invalid="ignore"):
        edge_len = 0.0
        for arr in (gx32, gy32):
            for a, b in ((arr[1:], arr[:-1]), (arr[:, 1:], arr[:, :-1])):
                buf = np.abs(a - b)
                if np.isfinite(buf).any():
                    edge_len = max(edge_len, float(np.nanmax(buf)))
        node_i = np.floor(gx32)
        node_j = np.floor(gy32)
        inb = (
            (node_i >= 0) & (node_i < n_ti * tile)
            & (node_j >= 0) & (node_j < n_tj * tile)
        )
    presence = np.zeros(n_t, dtype=bool)
    if inb.any():
        t_ids = (
            (node_j[inb].astype(np.int64) // tile) * n_ti
            + node_i[inb].astype(np.int64) // tile
        )
        presence[:] = np.bincount(t_ids, minlength=n_t) > 0
    presence = presence.reshape(n_tj, n_ti)
    dil = int(np.ceil(edge_len / tile)) + 1
    if dil > 8:
        return None
    needed = presence
    for _ in range(dil):
        needed = _dilate1(needed)

    if not valid.any():
        if presence.any():
            return None
        return np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)

    # seed-field roughness: max |difference| between adjacent coarse
    # samples (quads per tile step) decides the extrapolation margins
    with np.errstate(invalid="ignore"):
        dji = np.abs(np.diff(seed, axis=2))
        djj = np.abs(np.diff(seed, axis=1))
    rough = max(
        float(np.nanmax(dji)) if np.isfinite(dji).any() else 1.0,
        float(np.nanmax(djj)) if np.isfinite(djj).any() else 1.0,
    )
    margin = 2
    seed_f = _fill_nan_extrapolate(seed)
    if np.isnan(seed_f[0]).any():
        return None

    # per-tile window: origin = floor(min corner seed) - margins,
    # extent = corner-seed spread + margins
    c_i = seed_f[0]
    c_j = seed_f[1]
    t_i_min = np.minimum(
        np.minimum(c_i[:-1, :-1], c_i[:-1, 1:]),
        np.minimum(c_i[1:, :-1], c_i[1:, 1:]),
    )
    t_i_max = np.maximum(
        np.maximum(c_i[:-1, :-1], c_i[:-1, 1:]),
        np.maximum(c_i[1:, :-1], c_i[1:, 1:]),
    )
    t_j_min = np.minimum(
        np.minimum(c_j[:-1, :-1], c_j[:-1, 1:]),
        np.minimum(c_j[1:, :-1], c_j[1:, 1:]),
    )
    t_j_max = np.maximum(
        np.maximum(c_j[:-1, :-1], c_j[:-1, 1:]),
        np.maximum(c_j[1:, :-1], c_j[1:, 1:]),
    )
    v4 = (
        valid[:-1, :-1] & valid[:-1, 1:] & valid[1:, :-1] & valid[1:, 1:]
    )
    # extrapolated seeds' error: second order (curvature * d^2) within the
    # extrapolation range, first order (roughness * d) beyond it
    with np.errstate(invalid="ignore"):
        curv = 1e-3
        for dd in (np.diff(seed, 2, axis=2), np.diff(seed, 2, axis=1)):
            if np.isfinite(dd).any():
                curv = max(curv, float(np.nanmax(np.abs(dd))))
    dist_c = distance_transform_edt(~valid)
    d4 = np.maximum(
        np.maximum(dist_c[:-1, :-1], dist_c[:-1, 1:]),
        np.maximum(dist_c[1:, :-1], dist_c[1:, 1:]),
    )
    extrapolated = d4 <= 8.0  # _fill_nan_extrapolate max_iters
    err = np.where(
        extrapolated,
        curv * (d4 + 1.0) ** 2,
        max(rough, 1.0) * (d4 + 1.0),
    )
    extra = np.where(v4, 0.0, np.ceil(err) + 3.0)
    spread = np.maximum(t_i_max - t_i_min, t_j_max - t_j_min) + 2 * extra

    band = (_dilate1(mixed := (valid[:-1, :-1] | valid[:-1, 1:]
                               | valid[1:, :-1] | valid[1:, 1:]) & ~v4)
            | mixed | (needed & ~v4))

    base_i_all = (np.floor(t_i_min - extra) - margin).reshape(-1)
    base_j_all = (np.floor(t_j_min - extra) - margin).reshape(-1)
    req = np.ceil(spread).astype(np.int64).reshape(-1) + 2 * margin + 3

    def _win_of(req_max: int) -> int:
        return -(-max(int(req_max), 4) // 4) * 4

    flat_v4 = v4.reshape(-1)
    flat_band = (band & ~v4).reshape(-1)
    win_int = _win_of(req[flat_v4].max()) if flat_v4.any() else 4
    if win_int > max_win:
        return None

    # JAX's padded source extent, which bounds the window origins
    pad = 64
    src_h_p = -(-max(src_h, 2 * max_win) // pad) * pad
    src_w_p = -(-max(src_w, 2 * max_win) // pad) * pad

    tj_grid = np.repeat(np.arange(n_tj, dtype=np.int32), n_ti)
    ti_grid = np.tile(np.arange(n_ti, dtype=np.int32), n_tj)

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    def make_class(sel, win):
        return dict(
            sel=ints(sel), n_real=len(sel), win=win, tjs=ints(tj_grid[sel]),
            tis=ints(ti_grid[sel]),
            bjs=ints(np.clip(base_j_all[sel], 0, src_h_p - win)),
            bis=ints(np.clip(base_i_all[sel], 0, src_w_p - win)),
        )

    # class 1 runs every tile at the interior window
    cls_all = dict(
        sel=None, n_real=n_t, win=win_int,
        bjs=ints(np.clip(base_j_all, 0, src_h_p - win_int)),
        bis=ints(np.clip(base_i_all, 0, src_w_p - win_int)),
    )

    cls_band = None
    host_blocks = None
    sel_band = np.nonzero(flat_band)[0]
    if len(sel_band):
        win_band = _win_of(req[sel_band].max())
        host_tiles = np.array([], dtype=np.int64)
        if win_band > 2 * max_win:
            over = req[sel_band] > 2 * max_win
            host_tiles = sel_band[over]
            sel_band = sel_band[~over]
            win_band = (
                _win_of(req[sel_band].max()) if len(sel_band) else 0
            )
        if len(sel_band) and win_band > win_int:
            cls_band = make_class(sel_band, win_band)
        if len(host_tiles) > 1024:
            return None
        if len(host_tiles):
            # each host tile's exact solve on its own window: one K8 tile a
            # host tile, stacked in a (n * tile, tile) map
            table_ints, table_origins = [], []
            for k, t in enumerate(host_tiles):
                tj, ti = divmod(int(t), n_ti)
                w = int(min(req[t], 8 * max_win))
                bj = int(np.clip(base_j_all[t], 0, max(src_h - 2, 0)))
                bi = int(np.clip(base_i_all[t], 0, max(src_w - 2, 0)))
                j1 = min(bj + w, src_h)
                i1 = min(bi + w, src_w)
                table_ints.append((k * tile, 0, tile, tile, bi, bj, i1 - bi, j1 - bj))
                table_origins.append((float(ti * tile), float(tj * tile)))
            n_h = len(host_tiles)
            blocks = rectify_phase_a(g, PhaseATiles(
                ints=np.asarray(table_ints, dtype=np.int64),
                origins=np.asarray(table_origins, dtype=np.float64),
                x_scale=1.0, y_scale=1.0, tile_h=tile, tile_w=tile, n_tiles_x=1,
                out_h=n_h * tile, out_w=tile,
            ), uv_delta)
            host_blocks = (ints(host_tiles), blocks.view(2, n_h, tile, tile))

    return PhaseAPlan(
        g=g,
        uv_delta=uv_delta,
        tile=tile,
        nqi=src_w_p - 1,
        src_h_p=src_h_p,
        src_w_p=src_w_p,
        n_tj=n_tj,
        n_ti=n_ti,
        dst_h=dst_h,
        dst_w=dst_w,
        src_i_min=src_i_min,
        src_j_min=src_j_min,
        cls_all=cls_all,
        cls_band=cls_band,
        host_blocks=host_blocks,
    )


# ---------------------------------------------------------------------------
# K21: the scatter-min scan
# ---------------------------------------------------------------------------


def phase_a_scan_plain(g, dst_shape, r_i, r_j, uv_delta):
    """Plain PyTorch version of K21 (``rectify_ops._phase_a_scan``, its two
    passes over the r_j x r_i candidate offsets with ``scatter_reduce``'s
    ``amin``): the (2, dst_h, dst_w) float64 map of (2, h, w) float64 *g*."""
    dst_h, dst_w = dst_shape
    _, src_h, src_w = g.shape
    gx, gy = g[0], g[1]
    nqi = src_w - 1
    size = dst_h * dst_w
    dev = g.device
    p0x, p1x = gx[:-1, :-1].reshape(-1), gx[:-1, 1:].reshape(-1)
    p2x, p3x = gx[1:, :-1].reshape(-1), gx[1:, 1:].reshape(-1)
    p0y, p1y = gy[:-1, :-1].reshape(-1), gy[:-1, 1:].reshape(-1)
    p2y, p3y = gy[1:, :-1].reshape(-1), gy[1:, 1:].reshape(-1)
    fi = torch.floor(torch.stack([p0x, p1x, p2x, p3x]))
    fj = torch.floor(torch.stack([p0y, p1y, p2y, p3y]))
    nan_rect = torch.isnan(fi).any(0) | torch.isnan(fj).any(0)
    fi = torch.nan_to_num(fi, nan=-1e9)
    fj = torch.nan_to_num(fj, nan=-1e9)
    i_lo, i_hi = fi.amin(0), fi.amax(0)
    j_lo, j_hi = fj.amin(0), fj.amax(0)
    det_a = torch.nan_to_num(_fdet_x(p0x, p0y, p1x, p1y, p2x, p2y), nan=0.0)
    det_b = torch.nan_to_num(_fdet_x(p3x, p3y, p2x, p2y, p1x, p1y), nan=0.0)
    alive = (~nan_rect & (i_hi >= 0) & (j_hi >= 0) & (i_lo < dst_w) & (j_lo < dst_h)
             & ((det_a != 0.0) | (det_b != 0.0)))
    i_lo_q, i_hi_q = i_lo.clamp(0, dst_w - 1).long(), i_hi.clamp(0, dst_w - 1).long()
    j_lo_q, j_hi_q = j_lo.clamp(0, dst_h - 1).long(), j_hi.clamp(0, dst_h - 1).long()
    q = torch.arange(nqi * (src_h - 1), device=dev)
    qif, qjf = (q % nqi).to(_F64), (q // nqi).to(_F64)
    rank = torch.where(alive, q, _INT32_MAX)
    u_min, uv_max = -uv_delta, 1.0 + 2 * uv_delta
    safe_a = torch.where(det_a == 0.0, 1.0, det_a)
    safe_b = torch.where(det_b == 0.0, 1.0, det_b)

    def candidates(k):
        pixel_j = j_lo_q + k // r_i
        pixel_i = i_lo_q + k % r_i
        in_rect = (pixel_j <= j_hi_q) & (pixel_i <= i_hi_q)
        dst_x = pixel_i.to(_F64) + 0.5
        dst_y = pixel_j.to(_F64) + 0.5
        ua = _fu_x(dst_x, dst_y, p0x, p0y, p2x, p2y) / safe_a
        va = _fv_x(dst_x, dst_y, p0x, p0y, p1x, p1y) / safe_a
        ok_a = _tri_accept(det_a, ua, va, u_min, uv_max)
        ub = _fu_x(dst_x, dst_y, p3x, p3y, p1x, p1y) / safe_b
        vb = _fv_x(dst_x, dst_y, p3x, p3y, p2x, p2y) / safe_b
        ok_b = _tri_accept(det_b, ub, vb, u_min, uv_max)
        use_b = ~ok_a & ok_b
        src_if = torch.where(use_b, (qif + 1) - ub.clamp(0.0, 1.0), qif + ua.clamp(0.0, 1.0))
        src_jf = torch.where(use_b, (qjf + 1) - vb.clamp(0.0, 1.0), qjf + va.clamp(0.0, 1.0))
        ok = (ok_a | ok_b) & in_rect & alive
        return ok, torch.where(ok, pixel_j * dst_w + pixel_i, size), src_if, src_jf

    claim = torch.full((size + 1,), _INT32_MAX, dtype=torch.int64, device=dev)
    for k in range(r_i * r_j):
        ok, flat, _, _ = candidates(k)
        claim.scatter_reduce_(0, flat, torch.where(ok, rank, _INT32_MAX), reduce="amin")
    out = torch.full((2, size), _NAN, dtype=_F64, device=dev)
    for k in range(r_i * r_j):
        ok, flat, src_if, src_jf = candidates(k)
        # (one winner a pixel: ranks are unique)
        win = ok & (claim[flat] == rank)
        out[0, flat[win]] = src_if[win]
        out[1, flat[win]] = src_jf[win]
    return out.view(2, dst_h, dst_w)


def phase_a_scan(g, dst_shape, r_i, r_j, uv_delta):
    """K21: the (2, dst_h, dst_w) float64 map of :func:`phase_a_scan_plain`
    on the card (a claim pass and a write pass, a thread a quad)."""
    if on_cpu(g):
        return phase_a_scan_plain(g, dst_shape, r_i, r_j, uv_delta)
    _, src_h, src_w = g.shape
    dst_h, dst_w = dst_shape
    require_cuda(g, "g", _F64, (2, src_h, src_w))
    # (K21's claims start at K8's byte fill: quad ranks stay below it)
    if (src_h < 2 or src_w < 2 or (src_h - 1) * (src_w - 1) >= _MAX_QUADS or dst_h < 1
            or dst_w < 1 or r_i < 1 or r_j < 1):
        raise ValueError(f"K21 takes swaths of 2 x 2 nodes to 2^31 quads, a target and r_i, "
                         f"r_j >= 1: {src_h}x{src_w} onto {dst_h}x{dst_w}, {r_j}x{r_i}")
    dev = g.device
    claim = torch.empty(dst_h * dst_w, dtype=torch.int32, device=dev)
    out = torch.empty((2, dst_h, dst_w), dtype=_F64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.xrt_phase_a_scan(
            g[0].data_ptr(), g[1].data_ptr(), src_h, src_w, dst_h, dst_w, r_i, r_j,
            float(uv_delta), claim.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "phase_a_scan")
    count_launch("phase_a_scan")
    return out


def inverse_ij_map_jax(
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
    r_i: int = 4,
    r_j: int = 4,
    device="cuda",
) -> torch.Tensor:
    """The whole-image scatter-min Phase A (``rectify_ops.inverse_ij_map_jax``):
    K21 over the (r_j x r_i) candidates of every quad, the coordinates
    normalised on their device (tensors on their own, numpy arrays on
    *device*); a (2, dst_h, dst_w) float64 tensor."""
    if isinstance(src_x, torch.Tensor):
        device = src_x.device
    sx = torch.as_tensor(src_x, dtype=_F64).to(device)
    sy = torch.as_tensor(src_y, dtype=_F64).to(device)
    src_h, src_w = sx.shape
    if src_h < 2 or src_w < 2:
        return torch.full((2,) + tuple(dst_shape), _NAN, dtype=_F64, device=device)
    g = torch.stack([(sx - dst_x_offset) / dst_x_scale, (sy - dst_y_offset) / dst_y_scale])
    return _offset(phase_a_scan(g, dst_shape, r_i, r_j, uv_delta), src_i_min, src_j_min)


def _ceil_pow2(n: int, cap: int) -> int:
    r = 1
    while r < n and r < cap:
        r *= 2
    return r


def _inverse_ij_map_device_scatter(
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
    max_span: int = 16,
    pad_multiple: int = 128,
    device="cuda",
) -> np.ndarray | None:
    """The whole-image device Phase A of JAX's production TPU tier
    (``rectify_ops._inverse_ij_map_device_scatter``): the host normalises
    the swath and sizes the candidate rectangle from a corner sweep over
    the shapes padded to *pad_multiple*, then K21 solves every candidate.
    Returns the (2, dst_h, dst_w) float64 map as numpy, or None outside the
    envelope (a quad spanning more than *max_span* pixels, more than 32 M
    padded quads or 64 M padded pixels)."""
    dst_h, dst_w = dst_shape
    gx, gy, device = _normalised(src_x, src_y, dst_x_offset, dst_y_offset, dst_x_scale,
                                 dst_y_scale, device)
    src_h, src_w = gx.shape
    if src_h < 2 or src_w < 2:
        return np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)

    pad = pad_multiple
    dst_h_p = -(-dst_h // pad) * pad
    dst_w_p = -(-dst_w // pad) * pad

    # corner min/max sweep (cheap, vectorized) sizes the candidate rect
    with np.errstate(invalid="ignore"):
        ci = np.floor(gx)
        cj = np.floor(gy)
        i_lo = np.minimum(
            np.minimum(ci[:-1, :-1], ci[:-1, 1:]),
            np.minimum(ci[1:, :-1], ci[1:, 1:]),
        )
        i_hi = np.maximum(
            np.maximum(ci[:-1, :-1], ci[:-1, 1:]),
            np.maximum(ci[1:, :-1], ci[1:, 1:]),
        )
        j_lo = np.minimum(
            np.minimum(cj[:-1, :-1], cj[:-1, 1:]),
            np.minimum(cj[1:, :-1], cj[1:, 1:]),
        )
        j_hi = np.maximum(
            np.maximum(cj[:-1, :-1], cj[:-1, 1:]),
            np.maximum(cj[1:, :-1], cj[1:, 1:]),
        )
        alive = (
            np.isfinite(i_lo) & np.isfinite(j_lo)
            & (i_hi >= 0) & (j_hi >= 0)
            & (i_lo < dst_w_p) & (j_lo < dst_h_p)
        )
    if not alive.any():
        return np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)
    span_i = (
        np.clip(i_hi[alive], 0, dst_w_p - 1)
        - np.clip(i_lo[alive], 0, dst_w_p - 1)
    )
    span_j = (
        np.clip(j_hi[alive], 0, dst_h_p - 1)
        - np.clip(j_lo[alive], 0, dst_h_p - 1)
    )
    r_i = int(span_i.max()) + 1
    r_j = int(span_j.max()) + 1
    if r_i > max_span or r_j > max_span:
        return None
    r_i = _ceil_pow2(r_i, max_span)
    r_j = _ceil_pow2(r_j, max_span)

    # memory guards (JAX's, on the padded shapes)
    src_h_p = -(-src_h // pad) * pad
    src_w_p = -(-src_w // pad) * pad
    if (src_h_p - 1) * (src_w_p - 1) > 32_000_000 or dst_h_p * dst_w_p > 64_000_000:
        return None

    out = phase_a_scan(_upload(gx, gy, device), (dst_h, dst_w), r_i, r_j, uv_delta)
    out_np = out.cpu().numpy()
    if src_i_min or src_j_min:
        out_np[0] += src_i_min
        out_np[1] += src_j_min
    return out_np


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------


def inverse_ij_map_device(
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
    tile: int = 8,
    max_win: int = 48,
    device="cuda",
) -> DeviceIJMap | np.ndarray | None:
    """The device Phase A (``rectify_ops.inverse_ij_map_device``), JAX's
    ladder: the hybrid (K11, K12; ``XRTPU_PHASEA_HYBRID=0`` skips it), the
    walk on clean fold-free swaths (K19; ``XRTPU_PHASEA_WALK=0`` skips it),
    then the host-planned tiled stencil (K20).  Returns a
    :class:`~.rectify_ops.DeviceIJMap`, a ready numpy map for degenerate
    geometries, or None outside the device envelope."""
    args = (src_x, src_y, src_i_min, src_j_min, dst_shape, dst_x_offset, dst_y_offset,
            dst_x_scale, dst_y_scale, uv_delta)
    if os.environ.get("XRTPU_PHASEA_HYBRID", "") != "0":
        hybrid = inverse_ij_map_hybrid(*args, device=device)
        if hybrid is not None:
            return hybrid
    if os.environ.get("XRTPU_PHASEA_WALK", "") != "0":
        walked = inverse_ij_map_walk(*args, device=device)
        if walked is not None:
            return walked
    plan = plan_phase_a_device(*args, tile=tile, max_win=max_win, device=device)
    if plan is None or isinstance(plan, np.ndarray):
        return plan
    return DeviceIJMap(_offset(plan.apply(), src_i_min, src_j_min))
