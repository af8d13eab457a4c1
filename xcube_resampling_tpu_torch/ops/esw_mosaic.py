"""K16: the exact region mosaic (``esw_mosaic``) on PyTorch tensors.

Port of ``xcube_resampling_tpu/ops/esw.py:make_esw_region_fn``
(:1128-1922), the JAX package's tier 3: exact reprojection for
domain-scale warps that no single ESW plan covers (a projection
singularity inside the target, as at BASELINE #3).  The target is split
by a quadtree; each region is planned against its own cropped source
window with the exact separable warp, and the regions that still refuse
(or whose taps would be too diverse) take the direct gather.  Every piece
computes its positions from the float32 casts of the same float64 coarse
fields as the whole-target gather (K3), so the mosaic is seamless and
reproduces the direct gather as the ESW does (bit-exact nearest, within 2
float32 ulp bilinear).

:func:`plan_esw_region` copies the JAX package's planning exactly: the
quadtree ``build`` (:1180-1252) with the ``XRTPU_ESW_OPBUDGET`` budget
(default 7000, :1171) and its cost estimate from the plans' tap and cover
slice counts; the groups by piece shape and tap-diversity octave
(:1275-1286); the forced replans on the group's window (:1293-1337); the
demotions of the most diverse members to the gather (:1389-1416); the
fallback of a member whose forced plan fails to its own probe plan
(:1482-1488); the gather pieces' windows (:1574-1623).  Its result lists
the pieces (``MosaicPiece``) and tags each program the JAX package would
run as its buckets' ``_meta`` do: ``("esw", gh, gw, wh, ww, n, S, d_v,
d_h)`` for a group of ESW pieces, ``("gather", gh, gw, wh, ww, n)`` for a
group of same-shaped gather pieces, ``("piece", r0, r1, c0, c1, (wh, ww)
or None)`` for a single one.  Left out, because they only shape the TPU's
programs and JAX's own tests show them bit-equal (``tests/test_esw.py:
340-375``): the uniform tap layout of a group (``uniform``, the per-piece
``_KernelCfg``), the buckets and the switches ``XRTPU_MOSAIC_PERPIECE``,
``XRTPU_MOSAIC_PERTILE``, ``XRTPU_MOSAIC_VMAP`` and ``XRTPU_MOSAIC_PROGS``,
and the measurement-only row-tile sweep ``XRTPU_MOSAIC_ROW_TILE``.

On the card one launch of K16 (``csrc/esw_mosaic.cu``) covers every
piece, on a canvas that is filled first where the pieces leave
target pixels uncovered (``fn.covered``): a piece table gives each piece its
kind, target origin and size, source window, S and the offsets of its
coarse fields in one packed float32 buffer, and a prefix sum of the
pieces' tile counts maps each block to a piece and a tile.  An ESW piece
runs K13's per-pixel function (``csrc/esw_pixel.h``) on the whole source
read in place through its window; a gather piece runs K3's taps
(``csrc/gather_taps.h``) in global source indices, which reads what the
JAX package's gather piece reads on its window (the planner asserts that
the window holds every tap of a valid pixel).  :func:`esw_mosaic_plain`
is its plain version: the pieces one by one through
:func:`.esw.esw_gather_plain` and :func:`.reproject_ops.gather_piece_plain`
on cropped windows.  The wrapper runs it for CPU tensors and launches K16
for CUDA tensors, or raises, and counts its launches as ``esw_mosaic``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .._device import as_float32, count_launch, on_cpu, require_cuda
from ..gridmapping import GridMapping
from .esw import STAGE_TILE, _offset_fields, _slice_raw, esw_gather_plain, plan_esw
from .reproject_ops import (
    METHODS,
    check_taps_dtype,
    fused_reproject,
    fused_reproject_plain,
    gather_dtype,
    gather_piece_plain,
    method_code,
    require_int32_planes,
)
from .srw import _Fields, _iystar_from_fields, _raw_coarse_fields, _source_window_gm

_F32 = torch.float32

# the kinds of piece, and the columns of the piece table (int32), as
# csrc/esw_mosaic.cu reads them
ESW, GATHER = 0, 1
(KIND, R0, C0, H, W, J_OFF, I_OFF, WH, WW, SAMPLES, NCJ, NCI, NCC, OFF_IX, OFF_IY,
 OFF_YS) = range(16)
N_COLS = 16
# a block's tile of a piece: target rows by columns (csrc/esw_mosaic.cu's
# kTileRows, kTileCols; the C entry refuses others)
TILE_ROWS, TILE_COLS = STAGE_TILE
# the quadtree's base split per axis and its depth: the JAX package's
# defaults (esw.py:1134-1135)
_BASE_SPLIT, _MAX_DEPTH = 2, 4


@dataclass
class MosaicPiece:
    """One piece of the mosaic: target rows [r0, r1) and columns [c0, c1)
    from the source window ``window`` = (j0, j1, i0, i1), through the ESW
    with ``n_samples`` kept rows (``kind`` "esw") or the direct gather
    ("gather", ``n_samples`` 0).  ``ix_c``, ``iy_c`` are the piece's float32
    coarse fields in global source indices, ``iystar_c`` its ESW plan's
    window-relative anchor field (None for a gather piece)."""

    kind: str
    r0: int
    r1: int
    c0: int
    c1: int
    window: tuple[int, int, int, int]
    n_samples: int
    ix_c: np.ndarray
    iy_c: np.ndarray
    iystar_c: np.ndarray | None = None

    def key(self) -> tuple:
        return (self.kind, self.r0, self.r1, self.c0, self.c1, self.window, self.n_samples)


@dataclass
class MosaicPlan:
    pieces: list[MosaicPiece]
    groups: list[tuple]  # the JAX package's program tags (module docstring)
    step: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def _esw_piece(r0, r1, c0, c1, plan) -> MosaicPiece:
    window = (plan.j_off, plan.j_off + plan.src_h, plan.i_off, plan.i_off + plan.src_w)
    return MosaicPiece("esw", r0, r1, c0, c1, window, int(plan.n_samples),
                       plan.ix_c, plan.iy_c, plan.iystar_c)


def _gather_piece(r0, r1, c0, c1, ixs, iys, window, src_h, src_w) -> MosaicPiece:
    """A gather piece on *window*, which must hold every tap of the
    piece's valid pixels.  A valid pixel interpolates four finite nodes,
    so its position lies within the finite nodes' float32 range up to
    rounding, and its taps (clamped to the source) from one below that
    range's floor to two above it."""
    ix_c, iy_c = ixs.astype(np.float32), iys.astype(np.float32)
    finite = np.isfinite(ix_c) & np.isfinite(iy_c)
    j0, j1, i0, i1 = window
    for lo, hi, a, n in ((i0, i1, ix_c, src_w), (j0, j1, iy_c, src_h)):
        first = max(int(np.floor(a[finite].min())) - 1, 0)
        last = min(int(np.floor(a[finite].max())) + 2, n - 1)
        if not (lo <= first and last < hi):
            raise RuntimeError(
                f"the mosaic's gather window {window} does not hold the taps "
                f"[{first}, {last}] of piece {(r0, r1, c0, c1)}"
            )
    return MosaicPiece("gather", r0, r1, c0, c1, window, 0, ix_c, iy_c)


def plan_esw_region(
    source_gm: GridMapping, target_gm: GridMapping, step: int = 16
) -> MosaicPlan | None:
    """The JAX package's mosaic planning (module docstring) with its
    defaults, a 2 x 2 base split and a depth of 4, or None where no region
    plans (the caller then takes the direct gather)."""
    op_budget = int(os.environ.get("XRTPU_ESW_OPBUDGET", "7000"))

    out_h, out_w = target_gm.height, target_gm.width
    src_h_g, src_w_g = source_gm.height, source_gm.width
    ix_r, iy_r = _raw_coarse_fields(source_gm, target_gm, step)

    esw_desc = []  # (r0, r1, c0, c1, f, win, probe_plan)
    gather_desc = []  # (r0, r1, c0, c1, ixs, iys)

    def build(r0, r1, c0, c1, depth):
        ixs, iys = _slice_raw(ix_r, iy_r, step, r0, r1, c0, c1)
        finite = np.isfinite(ixs) & np.isfinite(iys)
        plan = None
        win = None
        f = None
        if finite.all():
            iystar_s = _iystar_from_fields(ixs, iys, src_w_g, step)
            if iystar_s is not None:
                f = _Fields(ixs, iys, iystar_s, step, src_h_g, src_w_g, r1 - r0, c1 - c0)
                f_plan = f
                w = _source_window_gm(source_gm, f, margin=8 + 48)
                if w is not None:
                    _, win = w
                    f_plan = _offset_fields(f, *win)
                plan = plan_esw(
                    source_gm, target_gm, step=step, fields=f_plan, fields_global=f,
                    win=win,
                )
        if plan is not None:
            # the JAX package's trace-size estimate (its tap loops unroll):
            # pieces past the budget split, or take the gather
            eff_v = plan.jv if plan.jv else plan.d_v
            eff_h = plan.jh if plan.jh else plan.d_h
            est_ops = (
                -(-plan.src_w // plan.col_tile) * eff_v * (1 + plan.n_samples)
                + -(-plan.out_h // plan.row_tile) * eff_h * (2 * plan.n_samples + 6)
            )
            if est_ops <= op_budget:
                esw_desc.append((r0, r1, c0, c1, f, win, plan))
                return
        half_r = (r1 - r0) // 2 // step * step
        half_c = (c1 - c0) // 2 // step * step
        if depth < _MAX_DEPTH and half_r >= 128 and half_c >= 128:
            rm, cm = r0 + half_r, c0 + half_c
            build(r0, rm, c0, cm, depth + 1)
            build(r0, rm, cm, c1, depth + 1)
            build(rm, r1, c0, cm, depth + 1)
            build(rm, r1, cm, c1, depth + 1)
            return
        if not finite.any():
            # no coarse node inside the transform's domain: the whole-target
            # gather gives the fill here, which the canvas holds
            return
        gather_desc.append((r0, r1, c0, c1, ixs, iys))

    rb = (-(-out_h // _BASE_SPLIT) + step - 1) // step * step
    cb = (-(-out_w // _BASE_SPLIT) + step - 1) // step * step
    for bj in range(_BASE_SPLIT):
        for bi in range(_BASE_SPLIT):
            r0, r1 = bj * rb, min((bj + 1) * rb, out_h)
            c0, c1 = bi * cb, min((bi + 1) * cb, out_w)
            if r1 > r0 and c1 > c0:
                build(r0, r1, c0, c1, 0)

    if not esw_desc:
        return None

    pieces: list[MosaicPiece] = []
    groups: list[tuple] = []

    def _win_or_full(win):
        return win if win is not None else (0, src_h_g, 0, src_w_g)

    # groups by piece shape and tap-diversity octave (the group maxima set
    # every member's cost on the TPU)
    by_key: dict = {}
    for desc in esw_desc:
        p = desc[6]
        est_v = p.d_v * max(1, 128 // max(p.col_tile, 1))
        est_h = p.d_h * max(1, 128 // max(p.row_tile, 1))
        key = (
            desc[1] - desc[0],
            desc[3] - desc[2],
            max(int(est_v), 1).bit_length(),
            max(int(est_h), 1).bit_length(),
        )
        by_key.setdefault(key, []).append(desc)

    def _demote_to_gather(desc):
        r0, r1, c0, c1 = desc[:4]
        ixs, iys = _slice_raw(ix_r, iy_r, step, r0, r1, c0, c1)
        gather_desc.append((r0, r1, c0, c1, ixs, iys))

    for (gh, gw, *_band), descs in by_key.items():
        g_S = max(d[6].n_samples for d in descs)
        force = {
            "n_samples": g_S,
            "col_tile": 128,
            "row_tile": min(128, gh),
            "use_shift_v": any(d[6].s_v is not None for d in descs),
            "use_shift_h": any(d[6].s_h is not None for d in descs),
        }
        wins = [_win_or_full(d[5]) for d in descs]
        wh = min(src_h_g, -(-max(w[1] - w[0] for w in wins) // step) * step)
        ww = min(src_w_g, -(-max(w[3] - w[2] for w in wins) // step) * step)
        replans = []
        for desc, w0 in zip(descs, wins):
            r0, r1, c0, c1, f, _, probe = desc
            j0 = max(0, min(w0[0], src_h_g - wh)) // step * step
            i0 = max(0, min(w0[2], src_w_g - ww)) // step * step
            win2 = (j0, j0 + wh, i0, i0 + ww)
            plan2 = plan_esw(
                source_gm, target_gm, step=step, fields=_offset_fields(f, *win2),
                fields_global=f, win=win2, force=force,
            )
            replans.append((desc, win2, plan2))

        # the group's tap counts are maxima: demote the most diverse members
        # to the gather until the group's estimate fits the budget
        def group_est(rps):
            d_v = max(rp[2].d_v for rp in rps)
            d_h = max(rp[2].d_h for rp in rps)
            if all(rp[2].jv for rp in rps):
                d_v = max(rp[2].jv for rp in rps)
            if all(rp[2].jh for rp in rps):
                d_h = max(rp[2].jh for rp in rps)
            return (
                -(-ww // force["col_tile"]) * d_v * (1 + g_S)
                + -(-gh // force["row_tile"]) * d_h * (2 * g_S + 6)
            )

        ok = [rp for rp in replans if rp[2] is not None]
        ok.sort(key=lambda rp: rp[2].d_v + rp[2].d_h)
        while len(ok) > 1 and group_est(ok) > 2 * op_budget:
            _demote_to_gather(ok.pop()[0])
        if len(ok) == 1 and group_est(ok) > 3 * op_budget:
            _demote_to_gather(ok.pop()[0])
        kept = {id(rp[0]) for rp in ok}
        n_members = 0
        for desc, _, plan2 in replans:
            r0, r1, c0, c1 = desc[:4]
            if plan2 is not None and id(desc) in kept:
                pieces.append(_esw_piece(r0, r1, c0, c1, plan2))
                n_members += 1
            elif plan2 is None:
                # the forced layout does not fit this piece: its own probe
                # plan on its own window
                pieces.append(_esw_piece(r0, r1, c0, c1, desc[6]))
                win = desc[5]
                groups.append(("piece", r0, r1, c0, c1,
                               None if win is None else (win[1] - win[0], win[3] - win[2])))
        if n_members:
            groups.append((
                "esw", gh, gw, wh, ww, n_members, force["n_samples"],
                max(rp[2].d_v for rp in ok), max(rp[2].d_h for rp in ok),
            ))

    # gather pieces, grouped by shape: a group shares the largest window,
    # each member's placed to hold its own; a single piece keeps its own
    g_by_shape: dict = {}
    for d in gather_desc:
        g_by_shape.setdefault((d[1] - d[0], d[3] - d[2]), []).append(d)
    full = (0, src_h_g, 0, src_w_g)
    for (gh, gw), ds_ in g_by_shape.items():
        wins = []
        for r0, r1, c0, c1, ixs, iys in ds_:
            fr = _Fields(ixs, iys, None, step, src_h_g, src_w_g, r1 - r0, c1 - c0)
            w = _source_window_gm(source_gm, fr, margin=8)
            wins.append(w[1] if w is not None else full)
        if len(ds_) == 1:
            (r0, r1, c0, c1, ixs, iys), w0 = ds_[0], wins[0]
            pieces.append(_gather_piece(r0, r1, c0, c1, ixs, iys, w0, src_h_g, src_w_g))
            groups.append(("piece", r0, r1, c0, c1,
                           None if w0 == full else (w0[1] - w0[0], w0[3] - w0[2])))
            continue
        wh = min(src_h_g, max(w[1] - w[0] for w in wins))
        ww = min(src_w_g, max(w[3] - w[2] for w in wins))
        for (r0, r1, c0, c1, ixs, iys), w0 in zip(ds_, wins):
            j0 = max(0, min(w0[0], src_h_g - wh))
            i0 = max(0, min(w0[2], src_w_g - ww))
            pieces.append(_gather_piece(r0, r1, c0, c1, ixs, iys, (j0, j0 + wh, i0, i0 + ww),
                                        src_h_g, src_w_g))
        groups.append(("gather", gh, gw, wh, ww, len(ds_)))

    return MosaicPlan(pieces, groups, step, src_h_g, src_w_g, out_h, out_w)


def covers_target(pieces: list[MosaicPiece], out_h: int, out_w: int) -> bool:
    """Whether *pieces*, which the quadtree makes disjoint, tile the whole
    (out_h, out_w) target, so that no pixel keeps the canvas's fill."""
    return sum((p.r1 - p.r0) * (p.c1 - p.c0) for p in pieces) == out_h * out_w


def pack_pieces(pieces: list[MosaicPiece]):
    """The piece table (n, N_COLS) int32, the packed float32 coarse fields
    and the tile prefix (n + 1,) int32 of K16, as numpy arrays."""
    table = np.zeros((len(pieces), N_COLS), dtype=np.int32)
    chunks, used = [], 0
    tiles = [0]
    for k, p in enumerate(pieces):
        j0, j1, i0, i1 = p.window
        h, w = p.r1 - p.r0, p.c1 - p.c0
        ncj, nci = p.ix_c.shape
        ncc = p.iystar_c.shape[1] if p.iystar_c is not None else 0
        table[k, [KIND, R0, C0, H, W, J_OFF, I_OFF, WH, WW, SAMPLES, NCJ, NCI, NCC]] = (
            ESW if p.kind == "esw" else GATHER, p.r0, p.c0, h, w, j0, i0, j1 - j0, i1 - i0,
            p.n_samples, ncj, nci, ncc,
        )
        for col, a in ((OFF_IX, p.ix_c), (OFF_IY, p.iy_c), (OFF_YS, p.iystar_c)):
            if a is not None:
                table[k, col] = used
                chunks.append(np.ascontiguousarray(a, np.float32).ravel())
                used += a.size
        tiles.append(tiles[-1] + -(-h // TILE_ROWS) * -(-w // TILE_COLS))
    if used >= 2**31 or tiles[-1] >= 2**31:
        raise ValueError(f"the mosaic's fields ({used}) or tiles ({tiles[-1]}) pass 2^31")
    return table, np.concatenate(chunks), np.asarray(tiles, dtype=np.int32)


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------


def _piece_fields(fields, row):
    """A piece's coarse fields (ix_c, iy_c, iystar_c or None): views of
    the packed buffer, from its table *row*."""
    ncj, nci, ncc = row[NCJ], row[NCI], row[NCC]

    def view(off, n):
        return fields[off : off + ncj * n].view(ncj, n)

    ys = view(row[OFF_YS], ncc) if row[KIND] == ESW else None
    return view(row[OFF_IX], nci), view(row[OFF_IY], nci), ys


def _canvas(src, out_h, out_w, fill_value, covered):
    """The (B, out_h, out_w) canvas: left unwritten where the pieces cover
    the target (*covered*), else filled with *fill_value*."""
    shape = (src.shape[0], out_h, out_w)
    if covered:
        return torch.empty(shape, dtype=_F32, device=src.device)
    return torch.full(shape, float(np.float32(fill_value)), dtype=_F32, device=src.device)


def esw_mosaic_plain(src, fields, table, tile_start, n_tiles, step, out_h, out_w,
                     interp_method, fill_value, covered=False):
    """Plain PyTorch version of K16: the (B, out_h, out_w) canvas with
    every piece of *table* written into it, each from its cropped window of
    the whole (B, H, W) source *src* (*tile_start* and *n_tiles* only lay
    out K16's blocks).  The canvas holds *fill_value* unless *covered* says
    that the pieces tile the target (:func:`covers_target`)."""
    method_code(interp_method)
    src_h, src_w = src.shape[-2:]
    out = _canvas(src, out_h, out_w, fill_value, covered)
    for row in table.tolist():
        ix_c, iy_c, ys = _piece_fields(fields, row)
        r0, c0, h, w = row[R0], row[C0], row[H], row[W]
        j0, i0 = row[J_OFF], row[I_OFF]
        window = src[..., j0 : j0 + row[WH], i0 : i0 + row[WW]]
        if row[KIND] == ESW:
            piece = esw_gather_plain(
                window, ys, ix_c, iy_c, step, row[SAMPLES], h, w, src_h, src_w, j0, i0,
                interp_method, fill_value,
            )
        else:
            piece = gather_piece_plain(
                window, ix_c, iy_c, step, h, w, src_h, src_w, j0, i0, interp_method, fill_value,
            )
        out[..., r0 : r0 + h, c0 : c0 + w] = piece
    return out


def esw_mosaic(src, fields, table, tile_start, n_tiles, step, out_h, out_w, interp_method,
               fill_value, covered=False, staged=True):
    """K16: the exact region mosaic of (B, H, W) *src* in one launch of
    *n_tiles* blocks over the canvas (:func:`esw_mosaic_plain`), each ESW
    tile's anchors staged where its span fits the stage (*staged* False:
    computed per pixel in every tile; the same bits; ``ops/esw.py``'s
    ``tile_spans``)."""
    if on_cpu(src, fields, table, tile_start):
        return esw_mosaic_plain(
            src, fields, table, tile_start, n_tiles, step, out_h, out_w, interp_method,
            fill_value, covered,
        )
    method = method_code(interp_method)
    batch, src_h, src_w = src.shape
    n = table.shape[0]
    if step < 1 or n < 1 or n_tiles < 1:
        raise ValueError(f"K16 needs step >= 1, a piece and a tile: {step}, {n}, {n_tiles}")
    require_int32_planes(src_h, src_w, out_h, out_w)
    require_cuda(src, "src", _F32, (batch, src_h, src_w))
    require_cuda(table, "table", torch.int32, (n, N_COLS))
    require_cuda(tile_start, "tile_start", torch.int32, (n + 1,))
    require_cuda(fields, "fields", _F32, (fields.numel(),))
    fill = float(np.float32(fill_value))
    out = _canvas(src, out_h, out_w, fill, covered)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xrt_esw_mosaic_f32(
            src.data_ptr(), table.data_ptr(), tile_start.data_ptr(), fields.data_ptr(),
            out.data_ptr(), n, n_tiles, batch, src_h, src_w, out_h, out_w, step, method,
            fill, TILE_ROWS, TILE_COLS, int(staged), stream,
        )
    _build.check(lib, rc, "esw_mosaic")
    count_launch("esw_mosaic")
    return out


# ---------------------------------------------------------------------------
# the tier
# ---------------------------------------------------------------------------


class ESWMosaicFn:
    """``fn(src) -> target`` through K16; ``fn.plain(src)`` through its
    plain version.  ``src`` is (..., H, W) of a data dtype, the whole
    source, cast to float32 as the JAX package's mosaic casts it.
    ``fn.pieces`` lists the pieces as ``(kind, r0, r1, c0, c1, window,
    n_samples)``, ``fn.groups`` the JAX package's program tags,
    ``fn.covered`` whether the pieces tile the target (then K16 writes
    every pixel and the canvas is not filled first); the piece table, the
    packed coarse fields and the tile prefix lie on *device*."""

    def __init__(self, plan: MosaicPlan, interp_method: str, fill_value, device):
        method_code(interp_method)
        table, fields, tile_start = pack_pieces(plan.pieces)
        self.table = torch.from_numpy(table).to(device)
        self.fields = torch.from_numpy(fields).to(device)
        self.tile_start = torch.from_numpy(tile_start).to(device)
        self.n_tiles = int(tile_start[-1])
        self.pieces = [p.key() for p in plan.pieces]
        self.groups = list(plan.groups)
        self.step = plan.step
        self.src_h, self.src_w = plan.src_h, plan.src_w
        self.out_h, self.out_w = plan.out_h, plan.out_w
        self.interp_method, self.fill_value = interp_method, float(fill_value)
        self.covered = covers_target(plan.pieces, plan.out_h, plan.out_w)
        # the gather pieces' fields, for sources of the other dtypes
        self.gathers = [
            (p.r0, p.c0, p.r1 - p.r0, p.c1 - p.c0,
             torch.from_numpy(np.ascontiguousarray(p.ix_c, np.float32)).to(device),
             torch.from_numpy(np.ascontiguousarray(p.iy_c, np.float32)).to(device))
            for p in plan.pieces if p.kind == "gather"
        ]

    def args(self, src):
        """K16's arguments for the (B, H, W) *src*."""
        return (
            src, self.fields, self.table, self.tile_start, self.n_tiles, self.step,
            self.out_h, self.out_w, self.interp_method, self.fill_value, self.covered,
        )

    def _run(self, kernel, src):
        if tuple(src.shape[-2:]) != (self.src_h, self.src_w):
            raise ValueError(
                f"source shape {tuple(src.shape)} does not end in {(self.src_h, self.src_w)}"
            )
        x = src.reshape(-1, self.src_h, self.src_w).contiguous()
        typed = x.dtype != torch.float32 and self.gathers
        if typed:
            check_gather_dtype(x.dtype, self.interp_method)
        out = kernel(*self.args(as_float32(x)))
        if typed:
            gather = fused_reproject if kernel is esw_mosaic else fused_reproject_plain
            for r0, c0, h, w, ix_c, iy_c in self.gathers:
                out[:, r0 : r0 + h, c0 : c0 + w] = gather(
                    x, ix_c, iy_c, self.step, h, w, self.interp_method, self.fill_value)
        return out.reshape(src.shape[:-2] + out.shape[-2:])

    def __call__(self, src):
        return self._run(esw_mosaic, src)

    def plain(self, src):
        return self._run(esw_mosaic_plain, src)


def check_gather_dtype(dtype: torch.dtype, interp_method: str) -> None:
    """The JAX package's refusals for a source of *dtype* (not float32) in
    a mosaic with gather pieces: jnp's boolean subtract, and the float32
    canvas's ``dynamic_update_slice``, which takes no other dtype than its
    own (nearest keeps the source's, float64 lerps stay float64)."""
    check_taps_dtype(dtype, interp_method)
    if interp_method == "nearest" or dtype == torch.float64:
        out = gather_dtype(dtype, interp_method)
        raise TypeError(
            f"the exact region mosaic's gather pieces return {out}: "
            "dynamic_update_slice of a float32 canvas takes float32 updates only"
        )


def make_esw_region_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    step: int = 16,
    device="cuda",
) -> ESWMosaicFn | None:
    """The exact region mosaic of ``source_gm`` onto ``target_gm`` with
    its tables on *device* (``esw.py:1128-1922``), or None where the
    method is not one of the ESW's or no region plans."""
    if interp_method not in METHODS:
        return None
    plan = plan_esw_region(source_gm, target_gm, step=step)
    if plan is None:
        return None
    return ESWMosaicFn(plan, interp_method, fill_value, device)
