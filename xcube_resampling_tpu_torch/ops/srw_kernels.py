"""K1 and K2: the separable-residual warp (SRW) tap passes.

``srw_vertical`` (K1, ``csrc/srw_vertical.cu``) replaces the Pallas kernel
``xcube_resampling_tpu/ops/pallas_kernels.py:srw_vertical_pallas`` and the
XLA vertical taps of ``ops/srw.py:make_srw_fn``; ``srw_horizontal`` (K2,
``csrc/srw_horizontal.cu``) replaces that function's XLA horizontal pass
and its per-pixel precompute.  Each wrapper runs the plain PyTorch version
beside it for CPU tensors and launches its CUDA kernel for CUDA tensors,
or raises; it never falls back.  The plain versions state the semantics:
tap positions interpolated from the coarse fields as
:func:`.reproject_ops.interp_field` does, exactly ``d`` taps from the
tile's base, clamp-to-edge reads at true-position weights, zero-weight
taps included (so NaN reach matches the JAX package's XLA path), and the
tap sums rounded as fused multiply-adds, as XLA compiles them.

Layouts: ``src`` (B, src_h, src_w); ``iystar_c`` (ncj, ncc) and ``ix_c``,
``iy_c`` (ncj, nci) coarse fields sampled every ``step`` pixels;
``base_v`` (out_h, n_col_tiles) with tile ``c // col_tile``; ``v`` and
``vd`` (B, out_h, src_w); ``base_h`` (n_row_tiles, out_w) with tile
``j // row_tile``.

:class:`Windows` are planned once per geometry on the host
(:func:`plan_vertical_windows`, :func:`plan_horizontal_windows`): the
blocks of outputs (K1's kernel blocks; K2's row tiles by its warps'
column segments) and, per block, the range of tap indices (source rows
for K1, ``v`` columns for K2) from its least base to its greatest base
plus the tap count.  The kernel stages that window in shared memory,
clamping each index to the source as it copies, so its tap loop needs no
clamp.  Windows steer the kernels only; the plain versions take them and
do not need them.

The band forms ``srw_vertical_band`` and ``srw_horizontal_band`` are the
passes of the sharded SRW (``xcube_resampling_tpu/parallel/halo.py:
423-481``) on one row band of a mesh: output row ``j`` lies at global
target row ``row0 + j``, where its positions and geometry are
interpolated; K1's source is the band extended by its halo (``ext``, its
row 0 at global source row ``off``), and tap ``k`` reads its row
``clamp(k, 0, src_h - 1) - off`` of the true source height ``src_h``.
At ``row0 = off = 0`` on the whole source they are K1 and K2, and the
single-chip plain versions are the band plain versions there.  Each band
form counts its launches under its own name.  K2 and its band form run
one kernel (``srw_horizontal_kernel``, K2 at ``row0 = 0``): a warp a
:data:`BAND_COLS`-column segment, its windows planned in column blocks of
that width, its launch sized by :func:`plan_band_launch`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .._device import (
    DTYPE_CODES,
    count_launch,
    launch_name,
    on_cpu,
    require_cuda,
    require_data_dtype,
    widen,
)
from .reproject_ops import _as_arith, fma, fma64, fma_exact, interp_field, method_code

_F32 = torch.float32
_F64 = torch.float64


def value_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of ``v`` and of the output of the tap passes for a source
    of *dtype*, as jnp promotes a float32 weight times it: float64 for
    float64, float32 for every other data dtype."""
    return _F64 if dtype == _F64 else _F32

# Shared memory a K1 block may stage (bytes): two window buffers and the
# block's positions.  Under half the H100's 227 KB per block, so that two
# or more blocks share an SM.
SMEM_BUDGET = 96 * 1024
# Output columns of a K1 block, at most: 64 columns x 4 row groups = 256
# threads, and a warp reads 32 neighbouring columns of shared memory.
MAX_BLOCK_COLS = 64
# Output rows of a K1 block, at most: the fastest at the 20480^2 headline
# among the shapes tools/tune_srw.py times
K1_MAX_ROWS = 64
# K2's kernel (csrc/srw_horizontal.cu, its limits mirrored here): the
# output columns of a warp's segment (kBandCols), in whose column blocks
# its windows are planned; warps a block (kBandWarps), at most; its
# instantiations' (bands of a row an item stages, stages of a warp's ring);
# the blocks an SM its registers are capped for (bilinear and nearest,
# triangular), on float32 values and on float64 (K2's float64 form)
BAND_COLS = 128
BAND_WARPS = 4
BAND_ITEMS = ((4, 3), (2, 3), (1, 3), (1, 1))
BAND_MIN_BLOCKS = (5, 2)
BAND_MIN_BLOCKS_F64 = (4, 2)
# the H100's shared memory an SM and a block's most (bytes), and what the
# runtime keeps of an SM's for each block
SMEM_SM = 228 * 1024
SMEM_BLOCK_MAX = 227 * 1024
SMEM_RESERVED = 1024


@dataclass(frozen=True)
class Windows:
    """The staged windows of one pass over blocks of ``rows`` x ``cols``
    outputs (K1's kernel blocks; K2's row tiles by its warps' segments);
    ``lohi[rb, cb]`` (int32) is the half-open range of tap indices
    ``base + d`` of row block ``rb`` and column block ``cb``, not clipped
    to the source (the kernel clamps as it copies); ``extent`` is the
    widest range (the shared memory a window buffer holds per row or
    column)."""

    lohi: torch.Tensor  # (n_row_blocks, n_col_blocks, 2)
    rows: int
    cols: int
    extent: int
    # the least and the greatest tap index of every window, half-open
    span: tuple[int, int]

    def to(self, device) -> "Windows":
        return Windows(self.lohi.to(device), self.rows, self.cols, self.extent, self.span)


def _pow2_divisor(n: int, cap: int) -> int:
    """The largest power of two up to *cap* (a power of two) dividing *n*."""
    d = cap
    while n % d:
        d //= 2
    return d


def plan_vertical_windows(base_v: np.ndarray, col_tile: int, d_v: int) -> Windows:
    """K1's blocks: ``cols`` source columns inside one column tile (so one
    base per output row) by ``rows`` output rows, the most rows (a power
    of two up to :data:`K1_MAX_ROWS`) whose two source-row windows and
    positions fit :data:`SMEM_BUDGET`."""
    out_h, n_tiles = base_v.shape
    cols = _pow2_divisor(col_tile, MAX_BLOCK_COLS)
    for rows in (r for r in (128, 64, 32, 16, 8, 4, 2, 1) if r <= K1_MAX_ROWS):
        n_rb = -(-out_h // rows)
        padded = np.pad(base_v, ((0, n_rb * rows - out_h), (0, 0)), mode="edge")
        blocks = padded.reshape(n_rb, rows, n_tiles).astype(np.int64)
        lo, hi = blocks.min(axis=1), blocks.max(axis=1) + d_v
        extent = int((hi - lo).max())
        smem = 4 * (2 * extent * cols + rows * cols + rows)
        if smem <= SMEM_BUDGET:
            break
    lohi = torch.from_numpy(np.stack([lo, hi], axis=-1).astype(np.int32))
    return Windows(lohi, rows, cols, extent, (int(lo.min()), int(hi.max())))


def plan_horizontal_windows(base_h: np.ndarray, row_tile: int, d_h: int) -> Windows:
    """K2's windows: one a row tile (``rows`` = *row_tile*) and
    :data:`BAND_COLS`-column segment (its kernel's warps' segments), from
    the segment's least base to its greatest base plus *d_h*, the ends
    rounded out to multiples of 4 columns, for 16-byte copies.  The kernel
    stages them as :func:`plan_band_launch` sizes its launch; one window
    row of ``extent`` columns must fit its block's shared memory (a
    downscale by less than some 450x, 225x for triangular), or the launch
    raises ``ValueError``; the plain versions take any."""
    n_rt, out_w = base_h.shape
    cols = BAND_COLS
    n_cb = -(-out_w // cols)
    padded = np.pad(base_h, ((0, 0), (0, n_cb * cols - out_w)), mode="edge")
    blocks = padded.reshape(n_rt, n_cb, cols).astype(np.int64)
    lo = blocks.min(axis=2) // 4 * 4
    hi = -(-(blocks.max(axis=2) + d_h) // 4) * 4
    extent = int((hi - lo).max())
    lohi = torch.from_numpy(np.stack([lo, hi], axis=-1).astype(np.int32))
    return Windows(lohi, row_tile, cols, extent, (int(lo.min()), int(hi.max())))


@dataclass(frozen=True)
class BandLaunch:
    """K2's launch (``csrc/srw_horizontal.cu``): the bands of a row an item
    stages, the stages of a warp's ring, warps a block, and the block's
    shared memory in bytes."""

    group: int
    stages: int
    warps: int
    smem: int


def plan_band_launch(
    batch: int, extent: int, triangular: bool, group: int = 4, warps: int = BAND_WARPS,
    word: int = 4,
) -> BandLaunch:
    """K2's launch for *batch* bands of windows *extent* columns wide, of
    *word*-byte values (4: float32; 8: K2's float64 form): the most bands
    an item of 4, 2 and 1 up to *batch* and *group*, 3 stages of a warp's
    ring, *warps* warps a block; then fewer bands an item while the block's
    ring leaves its SM too little shared memory for the blocks its
    registers allow (:data:`BAND_MIN_BLOCKS`, :data:`BAND_MIN_BLOCKS_F64`),
    and one stage, then fewer warps, while it does not fit a block at all
    (the pairs of :data:`BAND_ITEMS`).  ``ValueError`` where one band, one
    stage and one warp do not fit."""
    if (batch < 1 or extent < 1 or group not in (4, 2, 1) or not 1 <= warps <= BAND_WARPS
            or word not in (4, 8)):
        raise ValueError(f"K2: batch {batch}, extent {extent}, group {group}, warps {warps}, "
                         f"{word}-byte words")
    row_bytes = word * extent * (2 if triangular else 1)  # one band's window row (and vd's)
    min_blocks = BAND_MIN_BLOCKS if word == 4 else BAND_MIN_BLOCKS_F64
    target = SMEM_SM // min_blocks[triangular] - SMEM_RESERVED
    g = group
    while g > batch:
        g //= 2
    s = 3

    def smem():
        return warps * s * g * row_bytes

    while smem() > target and g > 1:
        g //= 2
    if smem() > SMEM_BLOCK_MAX:
        s = 1
    while smem() > SMEM_BLOCK_MAX and warps > 1:
        warps //= 2
    if smem() > SMEM_BLOCK_MAX:
        raise ValueError(
            f"K2: a window row of {extent} {word}-byte columns{' (and vd)' if triangular else ''} "
            f"does not fit the kernel's {SMEM_BLOCK_MAX} bytes of shared memory"
        )
    return BandLaunch(g, s, warps, smem())


def _weight(pos, k, interp_method):
    if interp_method == "nearest":
        # torch.round rounds half to even, like jnp.round
        return (torch.round(pos) == k).to(_F32)
    return torch.clamp_min(1.0 - torch.abs(pos - k), 0.0)


def _dweight(pos, k):
    # the (1, -1) mixed-difference taps of the triangular correction:
    # +1 at floor(pos), -1 at floor(pos) + 1
    f = torch.floor(pos)
    return (f == k).to(_F32) - (f + 1.0 == k).to(_F32)


def _grid(n_rows, n_cols, device, row0=0):
    """Rows ``row0 ..`` (H, 1) and columns (1, W), float32."""
    rows = torch.arange(row0, row0 + n_rows, dtype=_F32, device=device)[:, None]
    cols = torch.arange(n_cols, dtype=_F32, device=device)[None, :]
    return rows, cols


def srw_vertical_plain(
    src, iystar_c, step, base_v, col_tile, d_v, windows, interp_method
):
    """Plain PyTorch version of K1: ``(v, vd)``, ``vd`` None unless
    triangular."""
    return srw_vertical_band_plain(
        src, iystar_c, step, base_v, col_tile, d_v, windows, interp_method,
        0, 0, src.shape[1],
    )


def _row_chunks(n_rows: int, per_row: int):
    """Row ranges of at most ``PLAIN_CHUNK`` elements (at least one row):
    the plain tap passes run on these in turn, so that their float64
    temporaries stay small at the headline's 20480^2; every output is
    computed alone, so the chunking does not change it."""
    step = max(1, PLAIN_CHUNK // max(per_row, 1))
    return [(r, min(r + step, n_rows)) for r in range(0, n_rows, step)]


# elements a plain tap pass computes at once (its row chunks)
PLAIN_CHUNK = 1 << 24


def srw_vertical_band_plain(
    ext, iystar_c, step, base_v, col_tile, d_v, windows, interp_method,
    row0, off, src_h,
):
    """Plain PyTorch version of K1's band form: ``(v, vd)`` of the band's
    output rows from global row *row0*, ``ext`` (B, ext_h, src_w) holding
    global source rows from *off*."""
    method_code(interp_method)
    batch, _, src_w = ext.shape
    out_h = base_v.shape[0]
    tri = interp_method == "triangular"
    dtype = ext.dtype
    vt = value_dtype(dtype)
    # float32 sources keep K1's emulation; the others' values (64-bit
    # integers) may lie far from the sums they join: rounded once
    f = fma64 if vt == _F64 else fma if dtype == _F32 else fma_exact
    wide = widen(ext)
    v = torch.empty((batch, out_h, src_w), dtype=vt, device=ext.device)
    vd = torch.empty_like(v) if tri else None
    for r0, r1 in _row_chunks(out_h, batch * src_w):
        n = r1 - r0
        pos_v = interp_field(iystar_c, *_grid(n, src_w, ext.device, row0 + r0), step)
        base = base_v[r0:r1].repeat_interleave(col_tile, dim=1)[:, :src_w].to(torch.int64)
        acc = torch.zeros((batch, n, src_w), dtype=vt, device=ext.device)
        acc_d = torch.zeros_like(acc) if tri else None
        for d in range(d_v):
            kk = base + d
            k = kk.to(_F32)
            idx = (kk.clamp(0, src_h - 1) - off).expand(batch, n, src_w)
            # the value in the sums' dtype, rounded once (jnp's promotion)
            taken = _as_arith(torch.gather(wide, 1, idx), dtype, vt)
            acc = f(_weight(pos_v, k, interp_method).to(vt), taken, acc)
            if tri:
                acc_d = f(_dweight(pos_v, k).to(vt), taken, acc_d)
        v[:, r0:r1] = acc
        if tri:
            vd[:, r0:r1] = acc_d
    return v, vd


def _horizontal_geometry(
    ix_c, iy_c, step, out_h, out_w, src_h, src_w, triangular, row0=0
):
    """K2's per-pixel geometry at rows from *row0*, as ``srw.py:609-632``
    computes it: the horizontal tap positions, the validity mask and, for
    triangular, the correction weight ``s = min(u v, (1 - u)(1 - v))``
    (else None)."""
    rows, cols = _grid(out_h, out_w, ix_c.device, row0)
    pos_h = interp_field(ix_c, rows, cols, step)
    iy = interp_field(iy_c, rows, cols, step)
    valid = (pos_h > -0.5) & (pos_h < src_w - 0.5) & (iy > -0.5) & (iy < src_h - 0.5)
    if not triangular:
        return pos_h, valid, None
    u = pos_h - torch.floor(pos_h)
    vf = iy - torch.floor(iy)
    return pos_h, valid, torch.minimum(u * vf, (1.0 - u) * (1.0 - vf))


def srw_horizontal_plain(
    v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
    interp_method, fill_value, vd=None,
):
    """Plain PyTorch version of K2: (B, out_h, out_w)."""
    return srw_horizontal_band_plain(
        v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
        interp_method, fill_value, vd, 0,
    )


def srw_horizontal_band_plain(
    v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
    interp_method, fill_value, vd=None, row0=0,
):
    """Plain PyTorch version of K2's band form: (B, out_h, out_w), ``v``
    holding the band's rows from global row *row0*."""
    method_code(interp_method)
    batch, out_h, src_w = v.shape
    out_w = base_h.shape[1]
    tri = interp_method == "triangular"
    vt = v.dtype
    f = fma64 if vt == _F64 else fma
    base_all = base_h.repeat_interleave(row_tile, dim=0)[:out_h]
    fill = torch.tensor(fill_value, dtype=vt, device=v.device)
    out = torch.empty((batch, out_h, out_w), dtype=vt, device=v.device)
    for r0, r1 in _row_chunks(out_h, batch * out_w):
        n = r1 - r0
        pos_h, valid, s = _horizontal_geometry(
            ix_c, iy_c, step, n, out_w, src_h, src_w, tri, row0 + r0
        )
        base = base_all[r0:r1].to(torch.int64)
        vr = v[:, r0:r1]
        acc = torch.zeros((batch, n, out_w), dtype=vt, device=v.device)
        acc_d = torch.zeros_like(acc) if tri else None
        for d in range(d_h):
            kk = base + d
            k = kk.to(_F32)
            idx = kk.clamp(0, src_w - 1).expand(batch, n, out_w)
            acc = f(_weight(pos_h, k, interp_method).to(vt), torch.gather(vr, 2, idx), acc)
            if tri:
                acc_d = f(_dweight(pos_h, k).to(vt), torch.gather(vd[:, r0:r1], 2, idx),
                          acc_d)
        if tri:
            acc = f((-s).to(vt), acc_d, acc)
        out[:, r0:r1] = torch.where(valid, acc, fill)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


# Row blocks a kernel block walks, at most (its next window loads while it
# sums the current one)
WALK = 8


def _walkers(n_col_blocks: int, n_row_blocks: int) -> int:
    """Blocks along the row-block axis: each walks up to :data:`WALK` row
    blocks while the grid keeps about eight blocks per SM of a 132-SM
    card."""
    per_block = max(1, min(WALK, n_col_blocks * n_row_blocks // 1056))
    return min(65535, -(-n_row_blocks // per_block))


def srw_vertical(src, iystar_c, step, base_v, col_tile, d_v, windows, interp_method):
    """K1: the vertical tap pass, ``(v, vd)``; see the module docstring."""
    if on_cpu(src, iystar_c, base_v, windows.lohi):
        return srw_vertical_plain(
            src, iystar_c, step, base_v, col_tile, d_v, windows, interp_method
        )
    return _launch_vertical(
        src, iystar_c, step, base_v, col_tile, d_v, windows, interp_method, None
    )


def srw_vertical_band(
    ext, iystar_c, step, base_v, col_tile, d_v, windows, interp_method,
    row0, off, src_h,
):
    """K1's band form, ``(v, vd)`` of one mesh band; see the module
    docstring.  Every window's taps must lie in ``ext`` once clamped to
    the source and rebased by *off* (else ``ValueError``)."""
    if on_cpu(ext, iystar_c, base_v, windows.lohi):
        return srw_vertical_band_plain(
            ext, iystar_c, step, base_v, col_tile, d_v, windows, interp_method,
            row0, off, src_h,
        )
    lo, hi = windows.span
    first = min(max(lo, 0), src_h - 1) - off
    last = min(max(hi - 1, 0), src_h - 1) - off
    if first < 0 or last >= ext.shape[1] or row0 < 0:
        raise ValueError(
            f"K1 band: taps of rows {lo}..{hi - 1} (source height {src_h}) fall "
            f"outside the band's {ext.shape[1]} rows from {off}"
        )
    return _launch_vertical(
        ext, iystar_c, step, base_v, col_tile, d_v, windows, interp_method,
        (row0, off, src_h),
    )


def _launch_vertical(
    src, iystar_c, step, base_v, col_tile, d_v, windows, interp_method, band
):
    """K1 on CUDA tensors; *band* None, or ``(row0, off, src_h)`` for
    the band form."""
    method = method_code(interp_method)
    if col_tile < 1 or d_v < 1 or step < 1:
        raise ValueError(f"col_tile, d_v and step must be positive: {col_tile}, {d_v}, {step}")
    batch, src_h, src_w = src.shape
    out_h, n_col_tiles = base_v.shape
    ncj, ncc = iystar_c.shape
    w = windows
    n_rb = -(-out_h // w.rows)
    if n_col_tiles != -(-src_w // col_tile) or col_tile % w.cols or ncj < 2 or ncc < 2:
        raise ValueError(
            f"inconsistent K1 plan: base_v {tuple(base_v.shape)}, src_w {src_w}, "
            f"col_tile {col_tile}, block cols {w.cols}, iystar_c {tuple(iystar_c.shape)}"
        )
    require_data_dtype(src.dtype, "the source")
    require_cuda(src, "src", src.dtype, (batch, src_h, src_w))
    require_cuda(iystar_c, "iystar_c", _F32, (ncj, ncc))
    require_cuda(base_v, "base_v", torch.int32, (out_h, n_col_tiles))
    require_cuda(w.lohi, "windows", torch.int32, (n_rb, n_col_tiles, 2))
    v = torch.empty((batch, out_h, src_w), dtype=value_dtype(src.dtype), device=src.device)
    vd = torch.empty_like(v) if interp_method == "triangular" else None
    if v.numel() == 0:
        return v, vd
    vec4 = src_w % 4 == 0 and w.cols % 4 == 0 and src.data_ptr() % 16 == 0
    n_cb = -(-src_w // w.cols)
    lib = _build.load()
    args = (
        src.data_ptr(), iystar_c.data_ptr(), base_v.data_ptr(),
        w.lohi.data_ptr(), v.data_ptr(), _ptr(vd), batch, src_h, src_w,
        out_h, ncj, ncc, step, n_col_tiles, col_tile, d_v, method,
        w.rows, w.cols, w.extent, n_cb, _walkers(n_cb, n_rb), int(vec4),
    )
    name = "srw_vertical" if band is None else "srw_vertical_band"
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = DTYPE_CODES[src.dtype]
        if band is None:
            rc = lib.xrt_srw_vertical(*args, code, stream)
        else:
            rc = lib.xrt_srw_vertical_band(*args, *band, code, stream)
    _build.check(lib, rc, name)
    count_launch(launch_name(name, src.dtype, (_F32,)))
    return v, vd


def srw_horizontal(
    v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
    interp_method, fill_value, vd=None,
):
    """K2: the horizontal tap pass, the per-pixel geometry, the triangular
    correction and the fill select, (B, out_h, out_w); ``vd`` is required
    for triangular."""
    tri = interp_method == "triangular"
    if tri and vd is None:
        raise ValueError("triangular needs vd")
    extra = (vd,) if tri else ()
    if on_cpu(v, ix_c, iy_c, base_h, windows.lohi, *extra):
        return srw_horizontal_plain(
            v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
            interp_method, fill_value, vd,
        )
    return _launch_horizontal(
        v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
        interp_method, fill_value, vd, 0, "srw_horizontal",
    )


def srw_horizontal_band(
    v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
    interp_method, fill_value, vd=None, row0=0,
):
    """K2's band form: the horizontal pass of one mesh band, ``v``
    holding its rows from global target row *row0*, (B, band rows, out_w)."""
    tri = interp_method == "triangular"
    if tri and vd is None:
        raise ValueError("triangular needs vd")
    extra = (vd,) if tri else ()
    if on_cpu(v, ix_c, iy_c, base_h, windows.lohi, *extra):
        return srw_horizontal_band_plain(
            v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
            interp_method, fill_value, vd, row0,
        )
    if row0 < 0:
        raise ValueError(f"K2 band: negative first row {row0}")
    return _launch_horizontal(
        v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
        interp_method, fill_value, vd, row0, "srw_horizontal_band",
    )


def horizontal_c_args(
    v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
    interp_method, fill_value, vd, row0, out, launch=None,
):
    """K2's C arguments (``xrt_srw_horizontal_f32``, or ``_f64`` for float64
    *v*, but the stream) into *out*, checked against its plan: a warp for
    each :data:`BAND_COLS`-column segment of 16 rows, staged as *launch* (a
    :class:`BandLaunch`; default :func:`plan_band_launch`'s for *v*'s
    word) says."""
    tri = interp_method == "triangular"
    vd = vd if tri else None
    batch, out_h, src_w = v.shape
    n_row_tiles, out_w = base_h.shape
    w = windows
    ncj, nci = ix_c.shape
    vt = v.dtype
    if (row_tile < 1 or n_row_tiles != -(-out_h // row_tile) or w.extent % 4
            or w.cols != BAND_COLS or d_h < 1 or step < 1 or ncj < 2 or nci < 2
            or vt not in (_F32, _F64)):
        raise ValueError(
            f"inconsistent K2 plan: base_h {tuple(base_h.shape)}, out_h {out_h}, row_tile "
            f"{row_tile}, windows of {w.cols} columns (the kernel's segments are {BAND_COLS}), "
            f"extent {w.extent}, d_h {d_h}, step {step}, coarse fields {tuple(ix_c.shape)}, "
            f"v {vt}"
        )
    require_cuda(v, "v", vt, (batch, out_h, src_w))
    require_cuda(base_h, "base_h", torch.int32, (n_row_tiles, out_w))
    require_cuda(w.lohi, "windows", torch.int32, (n_row_tiles, -(-out_w // w.cols), 2))
    require_cuda(ix_c, "ix_c", _F32, (ncj, nci))
    require_cuda(iy_c, "iy_c", _F32, (ncj, nci))
    require_cuda(out, "out", vt, (batch, out_h, out_w))
    if tri:
        require_cuda(vd, "vd", vt, (batch, out_h, src_w))
    vec4 = (
        src_w % 4 == 0 and v.data_ptr() % 16 == 0
        and (vd is None or vd.data_ptr() % 16 == 0)
    )
    launch = launch or plan_band_launch(max(batch, 1), w.extent, tri, word=v.element_size())
    return (
        v.data_ptr(), _ptr(vd), ix_c.data_ptr(), iy_c.data_ptr(), base_h.data_ptr(),
        w.lohi.data_ptr(), out.data_ptr(), batch, out_h, out_w, src_h, src_w, ncj, nci,
        step, row_tile, d_h, method_code(interp_method), float(fill_value), w.cols,
        w.extent, -(-out_w // w.cols), launch.group, launch.stages, launch.warps,
        int(vec4), row0,
    )


def _launch_horizontal(
    v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
    interp_method, fill_value, vd, row0, name,
):
    """K2's kernel on CUDA tensors (its float64 instantiation on float64
    ``v``), its launch counted under *name* and, for float64, the dtype."""
    out = torch.empty((v.shape[0], v.shape[1], base_h.shape[1]), dtype=v.dtype,
                      device=v.device)
    args = horizontal_c_args(
        v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, windows,
        interp_method, fill_value, vd, row0, out,
    )
    if out.numel() == 0:
        return out
    lib = _build.load()
    entry = lib.xrt_srw_horizontal_f64 if v.dtype == _F64 else lib.xrt_srw_horizontal_f32
    with torch.cuda.device(v.device):
        rc = entry(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, name)
    count_launch(launch_name(name, v.dtype, (_F32,)))
    return out
