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

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises, and counts its launches under its own
name.  Layouts: ``src`` (B, src_h, src_w); ``iystar_c`` (ncj, ncc),
``ix_c`` and ``iy_c`` (ncj, nci) sampled every ``step`` target pixels;
``s_v`` (src_w,), ``base_v`` (out_h,), ``s_h`` (out_h,), ``base_h``
(out_w,), all int32; ``v`` (B, out_h, src_w).
"""

from __future__ import annotations

import torch

from .. import _build
from .._device import count_launch, on_cpu, require_cuda
from .reproject_ops import interp_field, method_code, require_int32_planes
from .srw_kernels import _grid, _weight

_F32 = torch.float32
# the JAX package's aligned SRW takes these two methods only (srw.py:1056)
ALIGNED_METHODS = ("bilinear", "nearest")
# the most taps a pass sums: make_srw_reproject_fn plans the aligned SRW
# with max_taps=24 (srw.py:1633)
MAX_TAPS = 24


def fma_exact(a, b, c):
    """``a * b + c`` of float32 tensors rounded once to float32, as a fused
    multiply-add: the product is exact in float64, the sum is rounded to
    odd there (the float64 sum corrected by its exact error, Knuth's
    two-sum), and a value rounded to odd at 53 bits rounds to 24 bits as
    the exact value would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    e = (p - (s - z)) + (c - z)
    even = (s.view(torch.int64) & 1) == 0
    step = (e != 0) & torch.isfinite(e) & even
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(step, torch.nextafter(s, toward), s).float()


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


def launch_vertical(name, src, iystar_c, step, s_v, base_v, col_tile, d_v, interp_method,
                    max_taps):
    """Launch the vertical pass's kernel (K14 with one column tile, K17)
    with the (out_h, n_col_tiles) int32 bases *base_v*, a base every
    *col_tile* source columns, and count the launch under *name*."""
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
    v = torch.empty((batch, out_h, src_w), dtype=_F32, device=src.device)
    if v.numel() == 0:
        return v
    lib = _build.load()
    with torch.cuda.device(src.device):
        rc = lib.xrt_srw_aligned_vertical_f32(
            src.data_ptr(), iystar_c.data_ptr(), s_v.data_ptr(), base_v.data_ptr(),
            v.data_ptr(), batch, src_h, src_w, out_h, ncj, ncc, step, n_col_tiles, col_tile,
            d_v, method_code(interp_method), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, name)
    count_launch(name)
    return v


def launch_horizontal(name, v, ix_c, iy_c, step, s_h, base_h, row_tile, d_h, src_h,
                      interp_method, fill_value, max_taps):
    """Launch the horizontal pass's kernel (K15 with one row tile, K18)
    with the (n_row_tiles, out_w) int32 bases *base_h*, a base every
    *row_tile* output rows, and count the launch under *name*."""
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
    out = torch.empty((batch, out_h, out_w), dtype=_F32, device=v.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(v.device):
        rc = lib.xrt_srw_aligned_horizontal_f32(
            v.data_ptr(), ix_c.data_ptr(), iy_c.data_ptr(), s_h.data_ptr(),
            base_h.data_ptr(), out.data_ptr(), batch, out_h, src_w, out_w, src_h, ncj,
            nci, step, row_tile, d_h, method_code(interp_method), float(fill_value),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, name)
    count_launch(name)
    return out


def srw_aligned_vertical(src, iystar_c, step, s_v, base_v, d_v, interp_method):
    """K14: the aligned vertical pass, ``v``; see the module docstring."""
    if on_cpu(src, iystar_c, s_v, base_v):
        return srw_aligned_vertical_plain(src, iystar_c, step, s_v, base_v, d_v, interp_method)
    return launch_vertical(
        "srw_aligned_vertical", src, iystar_c, step, s_v, base_v.reshape(-1, 1),
        max(1, src.shape[-1]), d_v, interp_method, MAX_TAPS,
    )


def srw_aligned_horizontal(
    v, ix_c, iy_c, step, s_h, base_h, d_h, src_h, interp_method, fill_value
):
    """K15: the aligned horizontal pass and the fill select, (B, out_h,
    out_w); *src_h* is the source's height, for the validity test."""
    if on_cpu(v, ix_c, iy_c, s_h, base_h):
        return srw_aligned_horizontal_plain(
            v, ix_c, iy_c, step, s_h, base_h, d_h, src_h, interp_method, fill_value
        )
    return launch_horizontal(
        "srw_aligned_horizontal", v, ix_c, iy_c, step, s_h, base_h.reshape(1, -1),
        max(1, v.shape[-2]), d_h, src_h, interp_method, fill_value, MAX_TAPS,
    )
