"""K14 and K15: the aligned separable-residual warp's tap passes.

``srw_aligned_vertical`` (K14) and ``srw_aligned_horizontal`` (K15), the
kernels of ``csrc/srw_aligned.cu`` with one tile (the hybrid SRW's K17
and K18, ``ops/srw_hybrid.py``, launch them with a base a tile), replace
the XLA kernel of ``xcube_resampling_tpu/ops/srw.py:make_srw_aligned_fn``
(:1084-1152).
That kernel shifts each source column up by ``s_v[c]`` rows and each row
of the vertical pass's output left by ``s_h[r]`` columns, by log2 roll and
select passes with edge repeat, and then sums taps in the shifted space
from one base a row (vertical) or a column (horizontal).  The shift passes
compose to a clamped shift of the tap index, so each pass here reads its
taps directly:

* K14: ``pos = P(r, c) - s_v[c]`` with ``P`` the coarse field ``iystar_c``
  interpolated at (r, c), and ``v[b, r, c] = sum_d w(pos, base_v[r] + d)
  * src[b, clamp(base_v[r] + d + s_v[c], 0, src_h - 1), c]``;
* K15: ``pos = Q(r, c) - s_h[r]`` with ``Q`` the interpolated ``ix_c``,
  the taps ``v[b, r, clamp(base_h[c] + d + s_h[r], 0, src_w - 1)]``, and
  the fill where the tiled SRW's validity test on the unshifted ``ix``
  and ``iy`` fails (``srw.py:931-945``).

The weights are the hat ``max(0, 1 - |pos - k|)`` (bilinear) or ``rint(pos)
== k`` (nearest), zero-weight taps included, so a NaN tap reaches the
outputs whose taps read it.  The sums round as XLA's CPU backend compiles
the JAX kernel: the first two taps as ``fma(w0, t0, w1 * t1)`` (the
product ``w1 * t1`` rounded on its own), every later tap as ``fma(w_d,
t_d, acc)``.  The plain versions emulate each fused multiply-add exactly
(:func:`fma_exact`), so the kernels equal them bit for bit.

The kernels sum only the taps that can weigh where a
window of taps is all finite, an exact shortcut (the header of
``csrc/srw_aligned.cu`` works it out).  The vertical kernel stages its
taps in shared memory, its launch planned on the host
(:func:`plan_vertical`: each block's span of bases in shifted row space,
the rows a block that fit its shared memory), once a geometry: the
states of ``ops/srw.py`` carry the plan (``win_v``) and pass it to the
wrapper.  Where no span fits, the direct kernel (a thread an output,
every tap from global memory) runs instead, counted in
:data:`DIRECT_LAUNCHES`.  Asked for them (``with_flags``), the staged
kernel also writes a flag a row and word of :data:`VERT_COLS` v columns
where a value is not finite, and the wrapper returns them beside v.  The
horizontal kernel reads its taps through L1; each warp decides whether
the spans of v its columns read are finite (:func:`horizontal_spans`)
from those flags where the caller passes them, else from v's values.  :func:`vertical_emulation` and
:func:`horizontal_emulation` repeat the kernels' arithmetic in plain
PyTorch for the tests.  Times on an NVIDIA H100 80GB HBM3 at 700 W:
``PERF.md`` §6.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises, and counts its launches under its own
name.  Layouts: ``src`` (B, src_h, src_w); ``iystar_c`` (ncj, ncc),
``ix_c`` and ``iy_c`` (ncj, nci) sampled every ``step`` target pixels;
``s_v`` (src_w,), ``base_v`` (out_h,), ``s_h`` (out_h,), ``base_h``
(out_w,), all int32; ``v`` (B, out_h, src_w).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .._device import count_launch, on_cpu, require_cuda
from .reproject_ops import fma_exact, interp_field, method_code, require_int32_planes
from .srw_kernels import SMEM_BUDGET, _grid, _walkers, _weight

_F32 = torch.float32
# the JAX package's aligned SRW takes these two methods only (srw.py:1056)
ALIGNED_METHODS = ("bilinear", "nearest")
# the most taps a pass sums: make_srw_reproject_fn plans the aligned SRW
# with max_taps=24 (srw.py:1633)
MAX_TAPS = 24
# csrc/srw_aligned.cu's kernels (their constants mirrored here): the staged
# vertical kernel's source columns a block (kVCols) and its output rows a
# block, the most first; the horizontal kernel's output columns a block
# (kHThreads) and a span (a warp's)
VERT_COLS = 32
VERT_ROWS = (64, 32, 16, 8)
HORI_COLS = 128
HORI_SPAN_COLS = 32
# the horizontal kernel's rows a row group at most (kHRows): a warp tests
# its spans once a run of a group's rows inside one row tile, and a band
HORI_ROWS = 8
# the blocks a launch should have where fewer rows a block give them: two
# an SM of the H100's 132 (kSpreadBlocks)
SPREAD_BLOCKS = 264
# launches of the direct vertical kernel (the planner's alternative), by
# wrapper
DIRECT_LAUNCHES: Counter = Counter()


@dataclass(frozen=True)
class VerticalPlan:
    """The staged vertical kernel's launch (``csrc/srw_aligned.cu``):
    blocks of :data:`VERT_COLS` source columns inside one column tile by
    ``rows`` output rows; ``lohi[rb, t]`` (int32) the span ``[lo, hi)`` of
    the bases of row block ``rb`` in column tile ``t`` in shifted row
    space, from the least base to the greatest plus ``d_v``; ``extent``
    the widest span.  ``lohi`` None: the direct kernel."""

    lohi: torch.Tensor | None  # (n_row_blocks, n_col_tiles, 2)
    rows: int
    extent: int

    @property
    def direct(self) -> bool:
        return self.lohi is None

    def to(self, device) -> VerticalPlan:
        """This plan with its spans on *device*."""
        return self if self.direct else replace(self, lohi=self.lohi.to(device))


def plan_vertical(base_v: np.ndarray, col_tile: int, d_v: int, src_w: int) -> VerticalPlan:
    """The vertical pass's launch for the (out_h, n_col_tiles) bases
    *base_v* of *src_w* source columns: the most rows of :data:`VERT_ROWS`
    whose two window buffers, positions and bases fit ``SMEM_BUDGET`` and
    that leave the launch :data:`SPREAD_BLOCKS` blocks, else the fewest
    that fit (a two-pass mosaic's small pieces); the direct kernel where
    none fits (bases that climb more than some 1500 rows over 8 output
    rows) or where the column tiles are not whole blocks."""
    out_h, n_tiles = base_v.shape
    if n_tiles > 1 and col_tile % VERT_COLS:
        return VerticalPlan(None, 0, 0)
    n_cb = -(-src_w // VERT_COLS)
    plan = VerticalPlan(None, 0, 0)
    for rows in VERT_ROWS:
        n_rb = -(-out_h // rows)
        padded = np.pad(base_v, ((0, n_rb * rows - out_h), (0, 0)), mode="edge")
        blocks = padded.reshape(n_rb, rows, n_tiles).astype(np.int64)
        lo, hi = blocks.min(axis=1), blocks.max(axis=1) + d_v
        extent = int((hi - lo).max())
        if 4 * (2 * extent * VERT_COLS + rows * VERT_COLS + rows) <= SMEM_BUDGET:
            lohi = torch.from_numpy(np.stack([lo, hi], axis=-1).astype(np.int32))
            plan = VerticalPlan(lohi, rows, extent)
            if n_cb * n_rb >= SPREAD_BLOCKS:
                break
    return plan


def horizontal_rows(out_h: int, out_w: int) -> int:
    """The horizontal kernel's rows a row group (``group_rows``): the most
    of :data:`HORI_ROWS`, half that, ..., 1 that leave its launch
    :data:`SPREAD_BLOCKS` blocks of :data:`HORI_COLS` columns, else 1."""
    n_cb = -(-out_w // HORI_COLS)
    rows = HORI_ROWS
    while rows > 1 and n_cb * -(-out_h // rows) < SPREAD_BLOCKS:
        rows //= 2
    return rows


def horizontal_spans(base_h: np.ndarray, d_h: int) -> np.ndarray:
    """The spans the horizontal kernel's warps test: ``[lo, hi)`` (int64,
    (n_row_tiles, n_spans, 2)) of each row tile and :data:`HORI_SPAN_COLS`
    output columns, the least base of the columns to the greatest plus
    *d_h*, in shifted column space (row ``r`` reads v's columns ``[lo, hi)
    + s_h[r]``), as the kernel's warp reductions take them."""
    n_rt, out_w = base_h.shape
    n = -(-out_w // HORI_SPAN_COLS)
    b = base_h.astype(np.int64)
    lo = np.pad(b, ((0, 0), (0, n * HORI_SPAN_COLS - out_w)), constant_values=b.max())
    hi = np.pad(b, ((0, 0), (0, n * HORI_SPAN_COLS - out_w)), constant_values=b.min())
    return np.stack([lo.reshape(n_rt, n, -1).min(axis=2),
                     hi.reshape(n_rt, n, -1).max(axis=2) + d_h], axis=-1)


def _check_method(interp_method: str) -> None:
    if interp_method not in ALIGNED_METHODS:
        raise ValueError(
            f"the aligned SRW supports 'bilinear' and 'nearest' only, got {interp_method!r}"
        )


def _tap_sum(taps, interp_method):
    """The tap sum of (position, tap index, value) triples in XLA's order:
    ``fma(w0, t0, w1 * t1)``, then ``fma(w_d, t_d, acc)``."""
    acc = None
    first = None
    for d, (pos, k, t) in enumerate(taps):
        w = _weight(pos, k, interp_method)
        if d == 0:
            first = (w, t)
            acc = w * t
        elif d == 1:
            acc = fma_exact(first[0], first[1], w * t)
        else:
            acc = fma_exact(w, t, acc)
    return acc


def vertical_plain(src, iystar_c, step, s_v, base, d_v, interp_method):
    """The vertical pass of the aligned and hybrid SRW (K14, K17) in plain
    PyTorch: ``v`` (B, out_h, src_w) from the int64 tap bases *base*, an
    (out_h, 1) or (out_h, src_w) tensor in shifted row space."""
    _check_method(interp_method)
    batch, src_h, src_w = src.shape
    out_h = base.shape[0]
    shift = s_v.to(torch.int64)[None, :]
    pos = interp_field(iystar_c, *_grid(out_h, src_w, src.device), step) - shift.to(_F32)

    def taps():
        for d in range(d_v):
            idx = (base + d + shift).clamp(0, src_h - 1).expand(batch, out_h, src_w)
            yield pos, (base + d).to(_F32), torch.gather(src, 1, idx)

    return _tap_sum(taps(), interp_method)


def horizontal_plain(v, ix_c, iy_c, step, s_h, base, d_h, src_h, interp_method, fill_value):
    """The horizontal pass and fill select of the aligned and hybrid SRW
    (K15, K18) in plain PyTorch: (B, out_h, out_w) from the int64 tap bases
    *base*, a (1, out_w) or (out_h, out_w) tensor in shifted column space."""
    _check_method(interp_method)
    batch, out_h, src_w = v.shape
    out_w = base.shape[1]
    rows, cols = _grid(out_h, out_w, v.device)
    ix = interp_field(ix_c, rows, cols, step)
    iy = interp_field(iy_c, rows, cols, step)
    valid = (ix > -0.5) & (ix < src_w - 0.5) & (iy > -0.5) & (iy < src_h - 0.5)
    shift = s_h.to(torch.int64)[:, None]
    pos = ix - shift.to(_F32)

    def taps():
        for d in range(d_h):
            idx = (base + d + shift).clamp(0, src_w - 1).expand(batch, out_h, out_w)
            yield pos, (base + d).to(_F32), torch.gather(v, 2, idx)

    out = _tap_sum(taps(), interp_method)
    return torch.where(valid, out, torch.tensor(fill_value, dtype=_F32, device=v.device))


def srw_aligned_vertical_plain(src, iystar_c, step, s_v, base_v, d_v, interp_method):
    """Plain PyTorch version of K14: ``v`` (B, out_h, src_w)."""
    base = base_v.to(torch.int64)[:, None]
    return vertical_plain(src, iystar_c, step, s_v, base, d_v, interp_method)


def srw_aligned_horizontal_plain(
    v, ix_c, iy_c, step, s_h, base_h, d_h, src_h, interp_method, fill_value
):
    """Plain PyTorch version of K15: (B, out_h, out_w)."""
    base = base_h.to(torch.int64)[None, :]
    return horizontal_plain(
        v, ix_c, iy_c, step, s_h, base, d_h, src_h, interp_method, fill_value
    )


def _pair(pos, k0, n, interp_method):
    """The two-tap shortcut of ``csrc/srw_aligned.cu`` (``pair_for``) for
    positions *pos* and first taps *k0* of *n* taps: the taps ``x``, ``y``
    (from ``k0``) and weights ``wx``, ``wy`` of ``fma(wx, t_x, wy * t_y)``,
    and whether it decides (a tap weighs, the position is a number)."""
    nearest = interp_method == "nearest"
    fa = (torch.round(pos) if nearest else torch.floor(pos)) - k0.to(_F32)
    ok = (fa >= (0.0 if nearest else -1.0)) & (fa < n)
    a = torch.where(ok, fa, torch.zeros_like(fa)).to(torch.int64)
    if nearest:
        return a, a, torch.zeros_like(pos), torch.ones_like(pos), ok
    wa = _weight(pos, (k0 + a.clamp(min=0)).to(_F32), interp_method)
    wb = _weight(pos, (k0 + a + 1).to(_F32), interp_method)
    zero = torch.zeros_like(pos)
    lone_first = a < 0  # tap 0 alone: the weight of k0
    lone_last = ~lone_first & (a == n - 1)
    first = ~lone_first & ~lone_last & (a == 0)
    x = torch.where(lone_first, 0, torch.where(lone_last | first, a, a + 1))
    y = torch.where(lone_first, 0, torch.where(first, 1, a))
    wx = torch.where(lone_first | lone_last, zero, torch.where(first, wa, wb))
    wy = torch.where(lone_first | first, wb, wa)
    return x, y, wx, wy, ok


def _shortcut(taps, pos, k0, finite, interp_method):
    """The staged kernels' sum of the (d, ...) tap values *taps*: the
    two-tap shortcut where *finite* and it decides and is not +-0, else
    every tap in XLA's order."""
    n = taps.shape[0]
    full = _tap_sum(((pos, (k0 + d).to(_F32), taps[d]) for d in range(n)), interp_method)
    x, y, wx, wy, ok = _pair(pos, k0, n, interp_method)
    shape = taps.shape[1:]
    tx = torch.gather(taps, 0, x.clamp(0, n - 1).expand(shape)[None])[0]
    ty = torch.gather(taps, 0, y.clamp(0, n - 1).expand(shape)[None])[0]
    short = fma_exact(wx.expand(shape), tx, wy * ty)
    return torch.where(finite & ok & (short != 0), short, full)


def vertical_emulation(src, iystar_c, step, s_v, base_v, col_tile, d_v, interp_method,
                              plan):
    """The staged vertical kernel's arithmetic (K14's with one column tile,
    K17's) in plain PyTorch, for the tests: each block's window staged in
    shifted row space (row ``i`` of column ``c`` holds ``src[b, clamp(lo +
    i + s_v[c]), c]``, ``[lo, hi)`` the *plan*'s span), its taps read at
    staged rows ``base - lo + d``, one finiteness test a window of
    :data:`VERT_COLS` columns, the two-tap shortcut where it passes,
    every tap where not.  ``v`` (B, out_h, src_w)."""
    _check_method(interp_method)
    batch, src_h, src_w = src.shape
    out_h, n_tiles = base_v.shape
    lohi = plan.lohi.to(torch.int64)
    cols = torch.arange(src_w, device=src.device)
    tile = cols // col_tile if n_tiles > 1 else torch.zeros_like(cols)
    rb = torch.arange(out_h, device=src.device) // plan.rows
    shift = s_v.to(torch.int64)
    wlo, whi = lohi[:, tile, 0], lohi[:, tile, 1]  # (n_rb, src_w)
    i = torch.arange(plan.extent, device=src.device)[None, :, None]
    staged = src[:, (wlo[:, None, :] + i + shift).clamp(0, src_h - 1), cols]
    bad = (~torch.isfinite(staged) & (i < (whi - wlo)[:, None, :])).any(dim=2)
    n_cb = -(-src_w // VERT_COLS)
    bad = F.pad(bad, (0, n_cb * VERT_COLS - src_w)).reshape(batch, -1, n_cb, VERT_COLS).any(-1)
    finite = ~bad.repeat_interleave(VERT_COLS, dim=-1)[:, rb, :src_w]
    k0 = base_v.to(torch.int64)[:, tile]
    first = k0 - wlo[rb]  # tap 0's staged row
    taps = torch.stack([staged[:, rb[:, None], first + d, cols] for d in range(d_v)])
    pos = interp_field(iystar_c, *_grid(out_h, src_w, src.device), step) - shift.to(_F32)
    return _shortcut(taps, pos, k0, finite, interp_method)


def horizontal_emulation(v, ix_c, iy_c, step, s_h, base_h, row_tile, d_h, src_h,
                                interp_method, fill_value, words=False):
    """The horizontal kernel's arithmetic (K15's with one row tile, K18's)
    in plain PyTorch, for the tests: each warp's :data:`HORI_SPAN_COLS`
    columns test, once a band and run of rows (the rows of a group of
    :func:`horizontal_rows` inside one row tile), the spans of v's columns
    ``[lo, hi) + s_h[r]`` of the run's rows (:func:`horizontal_spans`, each
    column clamped to the row), and each output takes the two-tap shortcut
    where they are all finite, every tap where not, and the fill where the
    validity test fails.  With *words*, the test reads, as the kernel does
    on the staged vertical kernel's output, the flags of the words of
    :data:`VERT_COLS` columns that the clamped spans touch.  (B, out_h,
    out_w)."""
    _check_method(interp_method)
    batch, out_h, src_w = v.shape
    n_rt, out_w = base_h.shape
    dev = v.device
    rows, cols = _grid(out_h, out_w, dev)
    ix = interp_field(ix_c, rows, cols, step)
    iy = interp_field(iy_c, rows, cols, step)
    valid = (ix > -0.5) & (ix < src_w - 0.5) & (iy > -0.5) & (iy < src_h - 0.5)
    r = torch.arange(out_h, device=dev)
    u = torch.clamp(r // row_tile, max=n_rt - 1)
    spans = torch.from_numpy(horizontal_spans(base_h.cpu().numpy(), d_h)).to(dev)[u]
    sh = s_h.to(torch.int64)[:, None]
    lo = spans[..., 0] + sh  # each row's spans, in v's columns: (out_h, n_spans)
    if words:
        # bad[b, r, w]: word w of v's row not all finite; its running count
        n_words = -(-src_w // VERT_COLS)
        flag = F.pad(~torch.isfinite(v), (0, n_words * VERT_COLS - src_w))
        flag = flag.reshape(batch, out_h, n_words, VERT_COLS).any(-1).to(torch.int64)
        count = F.pad(flag.cumsum(-1), (1, 0))
        first = lo.clamp(0, src_w - 1) // VERT_COLS
        last = (spans[..., 1] - 1 + sh).clamp(0, src_w - 1) // VERT_COLS
        bad = (torch.gather(count, 2, (last + 1).expand(batch, -1, -1))
               - torch.gather(count, 2, first.expand(batch, -1, -1))) > 0
    else:
        t = torch.arange(int((spans[..., 1] - spans[..., 0]).max()), device=dev)
        seen = torch.gather(v[:, :, None, :].expand(batch, out_h, lo.shape[1], src_w), 3,
                            (lo[..., None] + t).clamp(0, src_w - 1).expand(batch, -1, -1, -1))
        live = t < (spans[..., 1] - spans[..., 0])[..., None]
        bad = (~torch.isfinite(seen) & live).any(dim=-1)  # (B, out_h, n_spans)
    # one test a run: a group's rows inside one row tile
    group = r // horizontal_rows(out_h, out_w)
    run = torch.unique_consecutive(group * n_rt + u, return_inverse=True)[1]
    bad = torch.zeros((batch, int(run.max()) + 1, bad.shape[-1]), device=dev).index_add_(
        1, run, bad.to(_F32)) > 0
    span = torch.arange(out_w, device=dev) // HORI_SPAN_COLS
    finite = ~bad[:, run][:, :, span]
    k0 = base_h.to(torch.int64)[u]
    taps = torch.stack([torch.gather(v, 2, (k0 + d + sh).clamp(0, src_w - 1).expand(batch, -1, -1))
                        for d in range(d_h)])
    out = _shortcut(taps, ix - sh.to(_F32), k0, finite, interp_method)
    return torch.where(valid, out, torch.tensor(fill_value, dtype=_F32, device=dev))


def launch_vertical(name, src, iystar_c, step, s_v, base_v, col_tile, d_v, interp_method,
                    max_taps, win_v=None, with_flags=False):
    """Launch the vertical pass's kernel (K14 with one column tile, K17)
    with the (out_h, n_col_tiles) int32 bases *base_v*, a base every
    *col_tile* source columns, and count the launch under *name*: the
    staged kernel as the plan *win_v* (:func:`plan_vertical` of these
    bases; None: planned here, a copy of the bases to the host) says, or
    the direct kernel, counted also in :data:`DIRECT_LAUNCHES`.  Returns
    ``v``, or with *with_flags* ``(v, flags)``: the staged kernel's (B,
    ceil(src_w / VERT_COLS), out_h) uint8 flags, 1 where a word of
    :data:`VERT_COLS` columns of a v row is not all finite; None from the
    direct kernel."""
    _check_method(interp_method)
    batch, src_h, src_w = src.shape
    out_h, n_col_tiles = base_v.shape
    ncj, ncc = iystar_c.shape
    if (not 1 <= d_v <= max_taps or step < 1 or ncj < 2 or ncc < 2 or col_tile < 1
            or n_col_tiles != max(1, -(-src_w // col_tile))):
        raise ValueError(
            f"{name}: d_v {d_v} (1..{max_taps}), step {step}, iystar_c {(ncj, ncc)}, "
            f"{n_col_tiles} column tiles of {col_tile} for width {src_w}"
        )
    require_int32_planes(src_h, src_w, out_h, src_w)
    require_cuda(src, "src", _F32, (batch, src_h, src_w))
    require_cuda(iystar_c, "iystar_c", _F32, (ncj, ncc))
    require_cuda(s_v, "s_v", torch.int32, (src_w,))
    require_cuda(base_v, "base_v", torch.int32, (out_h, n_col_tiles))
    if win_v is None:
        win_v = plan_vertical(base_v.cpu().numpy(), col_tile, d_v, src_w).to(src.device)
    elif not win_v.direct:
        require_cuda(win_v.lohi, "win_v.lohi", torch.int32,
                     (-(-out_h // win_v.rows), n_col_tiles, 2))
    n_words = -(-src_w // VERT_COLS)
    v = torch.empty((batch, out_h, src_w), dtype=_F32, device=src.device)
    # a tensor of its own: carving v and the flags out of one allocation
    # (slices, dtype views) cost the host more (PERF.md §6)
    flags = (torch.empty((batch, n_words, out_h), dtype=torch.uint8, device=src.device)
             if with_flags and not win_v.direct else None)
    if v.numel() == 0:
        return (v, flags) if with_flags else v
    lib = _build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (src.data_ptr(), iystar_c.data_ptr(), s_v.data_ptr(), base_v.data_ptr())
        dims = (batch, src_h, src_w, out_h, ncj, ncc, step, n_col_tiles, col_tile, d_v,
                method_code(interp_method))
        if win_v.direct:
            rc = lib.xrt_srw_aligned_vertical_f32(*args, v.data_ptr(), *dims, stream)
        else:
            rc = lib.xrt_srw_aligned_vertical_staged_f32(
                *args, win_v.lohi.data_ptr(), v.data_ptr(),
                0 if flags is None else flags.data_ptr(), *dims, win_v.rows, win_v.extent,
                _walkers(n_words, win_v.lohi.shape[0]), stream,
            )
    _build.check(lib, rc, name)
    count_launch(name)
    if win_v.direct:
        DIRECT_LAUNCHES[name] += 1
    return (v, flags) if with_flags else v


def launch_horizontal(name, v, ix_c, iy_c, step, s_h, base_h, row_tile, d_h, src_h,
                      interp_method, fill_value, max_taps, flags=None):
    """Launch the horizontal pass's kernel (K15 with one row tile, K18)
    with the (n_row_tiles, out_w) int32 bases *base_h*, a base every
    *row_tile* output rows, and count the launch under *name*.  With the
    staged vertical kernel's *flags* of v (:func:`launch_vertical`) the
    kernel reads them; without, it tests v's values."""
    _check_method(interp_method)
    batch, out_h, src_w = v.shape
    n_row_tiles, out_w = base_h.shape
    ncj, nci = ix_c.shape
    if (not 1 <= d_h <= max_taps or step < 1 or ncj < 2 or nci < 2 or row_tile < 1
            or n_row_tiles != max(1, -(-out_h // row_tile))):
        raise ValueError(
            f"{name}: d_h {d_h} (1..{max_taps}), step {step}, ix_c {(ncj, nci)}, "
            f"{n_row_tiles} row tiles of {row_tile} for height {out_h}"
        )
    require_int32_planes(out_h, src_w, out_h, out_w)
    require_cuda(v, "v", _F32, (batch, out_h, src_w))
    require_cuda(ix_c, "ix_c", _F32, (ncj, nci))
    require_cuda(iy_c, "iy_c", _F32, (ncj, nci))
    require_cuda(s_h, "s_h", torch.int32, (out_h,))
    require_cuda(base_h, "base_h", torch.int32, (n_row_tiles, out_w))
    if flags is not None:
        require_cuda(flags, "flags", torch.uint8, (batch, -(-src_w // VERT_COLS), out_h))
    out = torch.empty((batch, out_h, out_w), dtype=_F32, device=v.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(v.device):
        args = (ix_c.data_ptr(), iy_c.data_ptr(), s_h.data_ptr(), base_h.data_ptr(),
                out.data_ptr(), batch, out_h, src_w, out_w, src_h, ncj, nci, step, row_tile,
                d_h, method_code(interp_method), float(fill_value),
                torch.cuda.current_stream().cuda_stream)
        if flags is None:
            rc = lib.xrt_srw_aligned_horizontal_f32(v.data_ptr(), *args)
        else:
            rc = lib.xrt_srw_aligned_horizontal_flagged_f32(v.data_ptr(), flags.data_ptr(), *args)
    _build.check(lib, rc, name)
    count_launch(name)
    return out


def srw_aligned_vertical(src, iystar_c, step, s_v, base_v, d_v, interp_method, win_v=None,
                         with_flags=False):
    """K14: the aligned vertical pass, ``v``, or with *with_flags* ``(v,
    flags)`` (flags None on the CPU); *win_v* the state's plan
    (:func:`launch_vertical`); see the module docstring."""
    if on_cpu(src, iystar_c, s_v, base_v):
        v = srw_aligned_vertical_plain(src, iystar_c, step, s_v, base_v, d_v, interp_method)
        return (v, None) if with_flags else v
    return launch_vertical(
        "srw_aligned_vertical", src, iystar_c, step, s_v, base_v.reshape(-1, 1),
        max(1, src.shape[-1]), d_v, interp_method, MAX_TAPS, win_v, with_flags,
    )


def srw_aligned_horizontal(
    v, ix_c, iy_c, step, s_h, base_h, d_h, src_h, interp_method, fill_value, flags=None
):
    """K15: the aligned horizontal pass and the fill select, (B, out_h,
    out_w); *src_h* is the source's height, for the validity test;
    *flags* K14's flags of *v*, where it wrote them."""
    if on_cpu(v, ix_c, iy_c, s_h, base_h):
        return srw_aligned_horizontal_plain(
            v, ix_c, iy_c, step, s_h, base_h, d_h, src_h, interp_method, fill_value
        )
    return launch_horizontal(
        "srw_aligned_horizontal", v, ix_c, iy_c, step, s_h, base_h.reshape(1, -1),
        max(1, v.shape[-2]), d_h, src_h, interp_method, fill_value, MAX_TAPS, flags,
    )
