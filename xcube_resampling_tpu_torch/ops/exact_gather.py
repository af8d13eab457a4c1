"""K9: the JAX package's host gathers, in float64, on the card.

Numpy-backed variables take the JAX package's host semantics in the port,
computed on the card (``csrc/exact_gather.cu``) and rounded once to the
variable's own dtype.  Two modes:

* :func:`exact_gather_ij` replaces rectify Phase B's host gather
  (``xcube_resampling_tpu/ops/rectify_ops.py:var_image_from_ij_map``,
  :2767-2855, and ``native/phase_b.cpp``): the map's index truncated, its
  fraction in float64, nearest taking the next pixel where the fraction
  exceeds 0.5, taps clipped to the source, float64 tap differences, NaN
  map cells to the fill;
* :func:`exact_gather_windows` replaces the reproject host path
  (``xcube_resampling_tpu/reproject.py:_gather_through_windows``, :166-206,
  through ``ops/gather.py:grid_sample``, :162-217): per target tile, the
  positions in its source window from the float64 target centres and the
  float32-quantised window origin, the source padded with the fill,
  rint-and-clip nearest, floor/ceil bilinear and triangular taps whose
  differences are taken in the source dtype (integers wrap, float32
  rounds), the rest in float64.

Integer results take ``rint``, then numpy's float64 -> integer conversion
on x86: through int32, ``INT32_MIN`` out of its range or for NaN, then
the low bits.  The wrappers run the plain PyTorch versions for CPU
tensors and launch the kernel for CUDA tensors, or raise.
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
    narrow,
    on_cpu,
    require_cuda,
    require_data_dtype,
    round_to,
    to_f64,
    widen,
    wrap_int,
)
from .gather import fill_as
from .reproject_ops import fill_bits, fill_scalar, method_code

_F64 = torch.float64
_I32_MIN = -(2**31)


def unsupported(interp_method: str) -> NotImplementedError:
    """The JAX package's error for an interpolation method it lacks."""
    return NotImplementedError(
        f"interp_methods must be one of 0, 1, 'nearest', 'bilinear', "
        f"'triangular', was '{interp_method}'."
    )


def _check(src, interp_method):
    require_data_dtype(src.dtype, "the source")
    if interp_method not in ("nearest", "bilinear", "triangular"):
        raise unsupported(interp_method)
    if src.dim() != 3 or src.shape[-2] < 1 or src.shape[-1] < 1:
        raise ValueError(f"expected a (B, H, W) source, got {tuple(src.shape)}")


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """numpy's float64 -> int32 conversion on x86, as int64: truncation,
    ``INT32_MIN`` out of range and for NaN."""
    inside = (x >= -(2.0**31)) & (x < 2.0**31)
    return torch.where(inside, x, torch.full_like(x, _I32_MIN)).long()


def host_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float64 *x* rounded once to *dtype* as numpy rounds it, widened
    (``_device.widen``): a cast for floats (float16 once, bfloat16 through
    float32, as ``ml_dtypes``) and bool (``x != 0``); ``rint`` and the x86
    conversion for
    integers: through int32 up to 32 bits, int64 ``INT64_MIN`` outside its
    range, uint64 modulo 2^64 (0 at 2^64)."""
    if dtype.is_floating_point or dtype == torch.bool:
        return round_to(x, dtype)
    r = torch.round(x)
    if dtype == torch.int64:
        inside = (r >= -(2.0**63)) & (r < 2.0**63)
        return torch.where(inside, r, torch.full_like(r, -(2.0**63))).long()
    if dtype == torch.uint64:
        r = torch.where(r >= 2.0**63, r - 2.0**64, r)
        inside = (r >= -(2.0**63)) & (r < 2.0**63)
        return torch.where(inside, r, torch.full_like(r, -(2.0**63))).long()
    if dtype == torch.uint32:
        # through int64 (NaN to 0), modulo 2^32
        return wrap_int(torch.nan_to_num(r).clamp(-(2.0**62), 2.0**62).long(), dtype)
    return wrap_int(to_i32(r), dtype)


def host_diff(b: torch.Tensor, a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``b - a`` in *dtype* (float32, float16 and bfloat16 rounding,
    integer wraparound), as float64; *b* and *a* hold *dtype*'s values
    (integers widened); numpy's ``TypeError`` for bool."""
    if dtype == torch.bool:
        raise TypeError("numpy boolean subtract, the `-` operator, is not supported")
    if dtype.is_floating_point:
        return (b - a).to(_F64)
    return to_f64(wrap_int(b.long() - a.long(), dtype), dtype)


# ---------------------------------------------------------------------------
# ij_map mode: rectify Phase B's host gather
# ---------------------------------------------------------------------------


def exact_gather_ij_plain(src, ij_map, fill_value, interp_method):
    """Plain PyTorch version of K9's ij_map mode: (B, h, w) of *src*'s
    dtype from (B, H, W) *src* and the (2, h, w) float64 map."""
    _check(src, interp_method)
    dtype = src.dtype
    src_h, src_w = src.shape[-2], src.shape[-1]
    a = widen(src)
    mi, mj = ij_map[0], ij_map[1]
    valid = ~(torch.isnan(mi) | torch.isnan(mj))
    mi = torch.nan_to_num(mi, nan=0.0)
    mj = torch.nan_to_num(mj, nan=0.0)
    i0 = mi.long()  # truncation
    j0 = mj.long()
    u = mi - i0
    v = mj - j0
    if interp_method == "nearest":
        i_sel = torch.where(u > 0.5, i0 + 1, i0).clamp(0, src_w - 1)
        j_sel = torch.where(v > 0.5, j0 + 1, j0).clamp(0, src_h - 1)
        values = a[:, j_sel, i_sel]
    else:
        i0c = i0.clamp(0, src_w - 1)
        j0c = j0.clamp(0, src_h - 1)
        i1 = (i0c + 1).clamp(max=src_w - 1)
        j1 = (j0c + 1).clamp(max=src_h - 1)
        # the taps in float64, as the JAX package upcasts them (bool too)
        v00 = to_f64(a[:, j0c, i0c], dtype)
        v01 = to_f64(a[:, j0c, i1], dtype)
        v10 = to_f64(a[:, j1, i0c], dtype)
        v11 = to_f64(a[:, j1, i1], dtype)
        if interp_method == "triangular":
            near = v00 + u * (v01 - v00) + v * (v10 - v00)
            far = v11 + (1.0 - u) * (v10 - v11) + (1.0 - v) * (v01 - v11)
            values = torch.where(u + v < 1.0, near, far)
        else:
            vu0 = v00 + u * (v01 - v00)
            vu1 = v10 + u * (v11 - v10)
            values = vu0 + v * (vu1 - vu0)
        values = host_round(values, dtype).to(a.dtype)
    fill = fill_scalar(fill_as(fill_value, dtype), dtype, src.device)
    # the select on the widened dtype: CUDA has no uint16 where
    return narrow(torch.where(valid, values, fill), dtype)


def exact_gather_ij(src, ij_map, fill_value, interp_method):
    """K9's ij_map mode: rectify Phase B's host gather of (B, H, W) *src*
    through the (2, h, w) float64 map, (B, h, w) of *src*'s dtype."""
    if on_cpu(src, ij_map):
        return exact_gather_ij_plain(src, ij_map, fill_value, interp_method)
    _check(src, interp_method)
    batch, src_h, src_w = src.shape
    out_h, out_w = ij_map.shape[-2], ij_map.shape[-1]
    require_cuda(src, "src", src.dtype, (batch, src_h, src_w))
    require_cuda(ij_map, "ij_map", _F64, (2, out_h, out_w))
    out = torch.empty((batch, out_h, out_w), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    fill = fill_as(fill_value, src.dtype)
    lib = _build.load()
    with torch.cuda.device(src.device):
        rc = lib.xrt_exact_gather_ij(
            src.data_ptr(), ij_map.data_ptr(), out.data_ptr(), batch, src_h, src_w,
            out_h, out_w, method_code(interp_method), float(fill),
            fill_bits(fill, src.dtype), DTYPE_CODES[src.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "exact_gather")
    count_launch(launch_name("exact_gather", src.dtype))
    return out


# ---------------------------------------------------------------------------
# window mode: the reproject host path
# ---------------------------------------------------------------------------


@dataclass
class WindowTiles:
    """Per-target-tile source windows of the reproject host path, from
    ``reproject._plan_source_windows``: each tile's window start in the
    padded source (``ij``, (n, 2) int64: i0, j0) and origin (``xy``,
    (n, 2) float64: the float32 x and y stacks' first entries), row-major
    over the target's tiles."""

    ij: np.ndarray
    xy: np.ndarray
    tile_h: int
    tile_w: int
    n_tiles_x: int
    win_h: int
    win_w: int
    pad_top: int
    pad_left: int
    x_res: float
    neg_y_res: float


def _grid_sample(window, ix, iy, interp_method, dtype):
    """``ops/gather.py:grid_sample`` of a (B, wh, ww) window at float64
    positions (h, w): the window's dtype for nearest, else float64."""
    win_h, win_w = window.shape[-2], window.shape[-1]
    if interp_method == "nearest":
        jy = to_i32(torch.round(iy)).clamp(0, win_h - 1)
        jx = to_i32(torch.round(ix)).clamp(0, win_w - 1)
        return window[:, jy, jx]
    ix_floor = torch.floor(ix)
    iy_floor = torch.floor(iy)
    dx = ix - ix_floor
    dy = iy - iy_floor
    x0 = to_i32(ix_floor).clamp(0, win_w - 1)
    y0 = to_i32(iy_floor).clamp(0, win_h - 1)
    x1 = to_i32(torch.ceil(ix)).clamp(0, win_w - 1)
    y1 = to_i32(torch.ceil(iy)).clamp(0, win_h - 1)
    v00 = window[:, y0, x0]
    v01 = window[:, y0, x1]
    v10 = window[:, y1, x0]
    v11 = window[:, y1, x1]
    if interp_method == "triangular":
        near = to_f64(v00, dtype) + dx * host_diff(v01, v00, dtype) + dy * host_diff(
            v10, v00, dtype)
        far = (
            to_f64(v11, dtype)
            + (1.0 - dx) * host_diff(v10, v11, dtype)
            + (1.0 - dy) * host_diff(v01, v11, dtype)
        )
        return torch.where(dx + dy < 1.0, near, far)
    u0 = to_f64(v00, dtype) + dx * host_diff(v01, v00, dtype)
    u1 = to_f64(v10, dtype) + dx * host_diff(v11, v10, dtype)
    return u0 + dy * (u1 - u0)


def exact_gather_windows_plain(src, xx, yy, tiles: WindowTiles, fill_value, interp_method):
    """Plain PyTorch version of K9's window mode: (B, h, w) of *src*'s
    dtype from (B, H, W) *src* and the (h, w) float64 target centres in
    the source CRS."""
    _check(src, interp_method)
    dtype = src.dtype
    batch, src_h, src_w = src.shape
    out_h, out_w = xx.shape
    fill = fill_scalar(fill_as(fill_value, dtype), dtype, src.device)
    a = widen(src)
    n_y = len(tiles.ij) // tiles.n_tiles_x
    pad_h = max(int(tiles.ij[:, 1].max()) + tiles.win_h, tiles.pad_top + src_h)
    pad_w = max(int(tiles.ij[:, 0].max()) + tiles.win_w, tiles.pad_left + src_w)
    padded = torch.full((batch, pad_h, pad_w), 0, dtype=a.dtype, device=src.device)
    padded[...] = fill.to(a.dtype)
    padded[:, tiles.pad_top:tiles.pad_top + src_h, tiles.pad_left:tiles.pad_left + src_w] = a
    out = torch.empty((batch, out_h, out_w), dtype=a.dtype, device=src.device)
    for tj in range(n_y):
        rows = slice(tj * tiles.tile_h, min((tj + 1) * tiles.tile_h, out_h))
        for ti in range(tiles.n_tiles_x):
            k = tj * tiles.n_tiles_x + ti
            cols = slice(ti * tiles.tile_w, min((ti + 1) * tiles.tile_w, out_w))
            i0, j0 = (int(v) for v in tiles.ij[k])
            window = padded[:, j0:j0 + tiles.win_h, i0:i0 + tiles.win_w]
            ix = (xx[rows, cols] - float(tiles.xy[k, 0])) / tiles.x_res
            iy = (yy[rows, cols] - float(tiles.xy[k, 1])) / tiles.neg_y_res
            sampled = _grid_sample(window, ix, iy, interp_method, dtype)
            out[:, rows, cols] = (
                sampled if interp_method == "nearest" else host_round(sampled, dtype)
            )
    return narrow(out, dtype)


def exact_gather_windows(src, xx, yy, tiles: WindowTiles, fill_value, interp_method):
    """K9's window mode: the reproject host path's gather of (B, H, W)
    *src* at the (h, w) float64 target centres *xx*, *yy* (source CRS),
    (B, h, w) of *src*'s dtype."""
    if on_cpu(src, xx, yy):
        return exact_gather_windows_plain(src, xx, yy, tiles, fill_value, interp_method)
    _check(src, interp_method)
    batch, src_h, src_w = src.shape
    out_h, out_w = xx.shape
    require_cuda(src, "src", src.dtype, (batch, src_h, src_w))
    require_cuda(xx, "xx", _F64, (out_h, out_w))
    require_cuda(yy, "yy", _F64, (out_h, out_w))
    n_y = -(-out_h // tiles.tile_h)
    if tiles.ij.shape != (n_y * tiles.n_tiles_x, 2) or tiles.xy.shape != tiles.ij.shape:
        raise ValueError(f"tile tables {tiles.ij.shape}, {tiles.xy.shape} do not cover the target")
    if src.dtype == torch.bool and interp_method != "nearest":
        host_diff(src, src, src.dtype)  # numpy's TypeError
    itab = torch.from_numpy(np.ascontiguousarray(tiles.ij, np.int64)).to(src.device)
    dtab = torch.from_numpy(np.ascontiguousarray(tiles.xy, np.float64)).to(src.device)
    out = torch.empty((batch, out_h, out_w), dtype=src.dtype, device=src.device)
    fill = fill_as(fill_value, src.dtype)
    lib = _build.load()
    with torch.cuda.device(src.device):
        rc = lib.xrt_exact_gather_windows(
            src.data_ptr(), xx.data_ptr(), yy.data_ptr(), itab.data_ptr(), dtab.data_ptr(),
            out.data_ptr(), batch, src_h, src_w, out_h, out_w, tiles.tile_h,
            tiles.tile_w, tiles.n_tiles_x, tiles.win_h, tiles.win_w, tiles.pad_top,
            tiles.pad_left, float(tiles.x_res), float(tiles.neg_y_res),
            method_code(interp_method), float(fill), fill_bits(fill, src.dtype),
            DTYPE_CODES[src.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "exact_gather")
    count_launch(launch_name("exact_gather", src.dtype))
    return out
