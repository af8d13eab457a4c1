"""K3: the fused direct reprojection gather, and its field interpolation.

``fused_reproject`` (``csrc/fused_reproject.cu``) replaces the XLA kernel
of ``xcube_resampling_tpu/ops/reproject_ops.py:make_fused_reproject_fn``:
bilinear interpolation of the coarse fractional source-index fields, the
validity mask, clamp, the nearest/bilinear/triangular 4-tap gather and the
fill select, fused per target pixel.  The wrapper runs the plain PyTorch
version (``fused_reproject_plain``, built from :func:`interp_field` and
:func:`gather_interp`) for CPU tensors and launches the kernel for CUDA
tensors, or raises.

The coarse fields come from :func:`coarse_coord_field`, a copy of the
JAX package's numpy planner, evaluated once per geometry on the host.

On dtypes other than float32 both run ``csrc/fused_reproject_typed.cu``
(:func:`gather_interp`'s rule per dtype) and count their launches under
``fused_reproject.<dtype>`` and ``fused_reproject_band.<dtype>``.

``fused_reproject_band`` is K3's band form, the gather of the sharded
regrid (``xcube_resampling_tpu/parallel/halo.py:169-205``) on one row band
of a mesh: output row ``j`` lies at global target row ``row0 + j``, the
mask is the true source's bounds and the band's, and ``iy`` is clamped to
the true source, then rebased by the band's offset ``off`` in float32.  At
``row0 = off = 0`` on the whole source it is K3.  It counts its launches
under its own name.
"""

from __future__ import annotations

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
    widen,
    wrap_int,
)
from ..crs import Transformer
from ..gridmapping import GridMapping

_F32 = torch.float32

# The kernels' codes of the interpolation methods (csrc/srw_common.h)
METHODS = {"bilinear": 0, "nearest": 1, "triangular": 2}

# Target pixels between samples of the coarse coordinate fields: the
# default of the JAX package's make_fused_reproject_fn (reproject_ops.py:155)
# and make_srw_reproject_fn (srw.py:1555).
STEP = 16

# K3 indexes inside a plane with 32-bit offsets
MAX_PLANE = 2**31


def coarse_coord_field(
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side float64 evaluation of the inverse coordinate transform on
    every ``step``-th target pixel, returned as float32 fractional source
    index fields (ix, iy) of shape (ceil((h-1)/step)+1, ceil((w-1)/step)+1).
    Copy of ``xcube_resampling_tpu/ops/reproject_ops.py:coarse_coord_field``.
    """
    transformer = Transformer.from_crs(target_gm.crs, source_gm.crs)

    out_h, out_w = target_gm.height, target_gm.width
    ncj = (out_h - 1) // step + 2
    nci = (out_w - 1) // step + 2

    tgt_x = np.asarray(target_gm.x_coords.data, dtype=np.float64)
    tgt_y = np.asarray(target_gm.y_coords.data, dtype=np.float64)
    tgt_x0, tgt_dx = float(tgt_x[0]), float(tgt_x[1] - tgt_x[0])
    tgt_y0, tgt_dy = float(tgt_y[0]), float(tgt_y[1] - tgt_y[0])

    xs = tgt_x0 + tgt_dx * (np.arange(nci, dtype=np.float64) * step)
    ys = tgt_y0 + tgt_dy * (np.arange(ncj, dtype=np.float64) * step)
    xx, yy = np.meshgrid(xs, ys)
    sx, sy = transformer.transform(xx, yy)

    src_x0 = float(np.asarray(source_gm.x_coords.data)[0])
    y_vals = np.asarray(source_gm.y_coords.data)
    src_y0 = float(y_vals[0])
    src_yres_signed = float(y_vals[1] - y_vals[0])

    ix = (np.asarray(sx) - src_x0) / float(source_gm.x_res)
    iy = (np.asarray(sy) - src_y0) / src_yres_signed
    return ix.astype(np.float32), iy.astype(np.float32), step


def method_code(interp_method: str) -> int:
    """The kernels' code for an interpolation method; raises for others."""
    try:
        return METHODS[interp_method]
    except KeyError:
        raise ValueError(
            f"the kernels support {sorted(METHODS)}, got {interp_method!r}"
        ) from None


def fma(a, b, c):
    """``a * b + c`` in float32 with one rounding, as a fused multiply-add
    (the product of two float32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


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


def lerp(a, b, t):
    """``a + t * (b - a)`` rounded as XLA's contracted lerp."""
    return fma(t, b - a, a)


def interp_field(field, rows, cols, step):
    """Bilinear interpolation of a coarse (ncj, nci) field at target rows
    (H, 1) and columns (1, W), as ``reproject_ops._interp_field`` (its
    lerps rounded as XLA's fused multiply-adds)."""
    inv = 1.0 / step
    cj = rows * inv
    ci = cols * inv
    j0 = torch.floor(cj).to(torch.int64)
    i0 = torch.floor(ci).to(torch.int64)
    fj = cj - j0
    fi = ci - i0
    j0 = j0.clamp(0, field.shape[0] - 2)
    i0 = i0.clamp(0, field.shape[1] - 2)
    f00 = field[j0, i0]
    f01 = field[j0, i0 + 1]
    f10 = field[j0 + 1, i0]
    f11 = field[j0 + 1, i0 + 1]
    return lerp(lerp(f00, f01, fi), lerp(f10, f11, fi), fj)


def fma64(a, b, c):
    """``a * b + c`` in float64 with one rounding, emulated (Dekker's exact
    product, Knuth's exact sum): it may differ from a fused multiply-add
    by one float64 ulp where the error terms round at a tie."""
    p = a * b
    t = 134217729.0 * a  # 2^27 + 1: split each factor into 26-bit halves
    ah = t - (t - a)
    al = a - ah
    t = 134217729.0 * b
    bh = t - (t - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    z = s - p
    return s + (((p - (s - z)) + (c - z)) + e)


def gather_dtype(dtype: torch.dtype, interp_method: str) -> torch.dtype:
    """``gather_interp``'s output dtype for a source of *dtype*, as jnp
    promotes it: the source's for nearest, float64 for float64, float32
    otherwise."""
    if interp_method == "nearest":
        return dtype
    return torch.float64 if dtype == torch.float64 else torch.float32


def gather_fill(fill_value, dtype: torch.dtype):
    """*fill_value* in *dtype*, as ``jnp.asarray(fill_value, dtype)``: a
    float cast (float16 and bfloat16 as ``_device.round_to``), ``fill !=
    0`` for bool, or the integer (floats truncated) that *dtype* holds,
    as a Python int; ``ValueError`` for a NaN or infinite integer fill,
    ``OverflowError`` out of *dtype*'s range."""
    if dtype.is_floating_point:
        if dtype == torch.float64:
            return float(fill_value)
        return float(round_to(torch.tensor(float(fill_value), dtype=torch.float64), dtype))
    if dtype == torch.bool:
        return int(float(fill_value) != 0)
    if not isinstance(fill_value, (int, np.integer)):
        f = float(fill_value)
        if not np.isfinite(f):
            raise ValueError(f"cannot convert fill value {fill_value!r} to {dtype}")
        fill_value = int(f)
    info = torch.iinfo(dtype)
    if not info.min <= int(fill_value) <= info.max:
        raise OverflowError(f"fill value {fill_value!r} out of bounds for {dtype}")
    return int(fill_value)


def fill_bits(fill, dtype: torch.dtype) -> int:
    """A fill (:func:`gather_fill`'s or ``gather.fill_as``'s) as the kernels
    take it exactly: its bits in *dtype* as a signed int64 (integers their
    two's complement, exact past 2^53; the word K3's typed nearest kernels
    store)."""
    if not dtype.is_floating_point:
        return int(fill) - 2**64 if int(fill) >= 2**63 else int(fill)
    t = torch.tensor(fill, dtype=torch.float64).to(dtype)
    word = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return int(t.view(word))


def fill_scalar(fill, dtype: torch.dtype, device) -> torch.Tensor:
    """The scalar tensor of *fill* (:func:`gather_fill`'s or
    ``gather.fill_as``'s: a float, or an exact int) in widened *dtype*
    (``_device.widen``)."""
    if dtype.is_floating_point:
        return torch.tensor(fill, dtype=torch.float64, device=device).to(dtype)
    if dtype == torch.bool:
        return torch.tensor(bool(fill), device=device)
    return widen(narrow(torch.tensor(fill_bits(fill, dtype), device=device), dtype))


def _as_arith(t, dtype, arith):
    """Widened taps of *dtype* in the arithmetic dtype *arith*, rounded
    once (uint64 from its bits)."""
    if dtype == torch.uint64 and t.dtype == torch.int64:
        return t.view(torch.uint64).to(arith)
    return t.to(arith)


def _tap_diff(b, a, dtype):
    """``b - a`` in the source *dtype* (integers wrap, as jnp's do; float16
    and bfloat16 round, as their arithmetic does), in the lerps' arithmetic
    dtype."""
    if dtype.is_floating_point:
        d = b - a
        return d.float() if dtype in (torch.float16, torch.bfloat16) else d
    d = wrap_int(b.long() - a.long(), dtype)
    return _as_arith(d, dtype, torch.float32)


def interp_taps_f32(v00, v01, v10, v11, fx, fy, interp_method):
    """The bilinear or triangular value of four float32 taps at fractions
    *fx*, *fy*, its lerps rounded as XLA's fused multiply-adds."""
    if interp_method == "triangular":
        near = fma(fy, v10 - v00, lerp(v00, v01, fx))
        far = fma(1.0 - fy, v01 - v11, lerp(v11, v10, 1.0 - fx))
        return torch.where(fx + fy < 1.0, near, far)
    return lerp(lerp(v00, v01, fx), lerp(v10, v11, fx), fy)


def check_taps_dtype(dtype: torch.dtype, interp_method: str) -> None:
    """jnp's ``TypeError`` for the tap differences of a bool source."""
    if dtype == torch.bool and interp_method != "nearest":
        raise TypeError(
            "jnp.subtract is not supported for boolean inputs: the tap "
            f"differences of {interp_method} take the source dtype"
        )


def interp_taps(v00, v01, v10, v11, fx, fy, interp_method, dtype):
    """The bilinear or triangular value of four widened taps of a source of
    *dtype* (``_device.widen``) at float32 fractions, as
    ``gather_interp`` rounds it: float32 through :func:`interp_taps_f32`;
    the others' tap differences in *dtype*, the lerps fused multiply-adds
    in :func:`gather_dtype` (:func:`fma_exact`; float64 :func:`fma64`), as
    their taps' exponents may lie far apart (64-bit integers)."""
    if dtype == _F32:
        return interp_taps_f32(v00, v01, v10, v11, fx, fy, interp_method)
    check_taps_dtype(dtype, interp_method)
    arith = gather_dtype(dtype, interp_method)
    f = fma64 if arith == torch.float64 else fma_exact

    def d(b, a):
        return _tap_diff(b, a, dtype)

    def w(t):
        return _as_arith(t, dtype, arith)

    if interp_method == "triangular":
        near = f(w(fy), d(v10, v00), f(w(fx), d(v01, v00), w(v00)))
        far = f(w(1.0 - fy), d(v01, v11), f(w(1.0 - fx), d(v10, v11), w(v11)))
        return torch.where(fx + fy < 1.0, near, far)
    a = f(w(fx), d(v01, v00), w(v00))
    b = f(w(fx), d(v11, v10), w(v10))
    return f(w(fy), b - a, a)


def gather_interp(src, ix, iy, interp_method, fill_value, valid=None):
    """Clamp-to-edge gather of ``src`` (..., H, W) at float32 fractional
    source indices, as ``reproject_ops.gather_interp``: masked by *valid*,
    or where None by the bounds (-0.5, n - 0.5).  Lerps as XLA contracts
    them (:func:`interp_taps`): fused multiply-adds in float32 for
    float32, half, integer and bool sources (tap differences taken in the
    source dtype: integers wrap, half types round; bool's raise
    ``TypeError``), in float64 for float64 sources; output dtype
    :func:`gather_dtype`."""
    src_h, src_w = src.shape[-2], src.shape[-1]
    if valid is None:
        valid = (ix > -0.5) & (ix < src_w - 0.5) & (iy > -0.5) & (iy < src_h - 0.5)
    ix = ix.clamp(0, src_w - 1)
    iy = iy.clamp(0, src_h - 1)
    dtype = src.dtype
    check_taps_dtype(dtype, interp_method)
    taps = widen(src)
    if interp_method == "nearest":
        vals = taps[..., torch.round(iy).long(), torch.round(ix).long()]
    else:
        x0f = torch.floor(ix)
        y0f = torch.floor(iy)
        fx = ix - x0f
        fy = iy - y0f
        x0 = x0f.long()
        y0 = y0f.long()
        x1 = (x0 + 1).clamp(0, src_w - 1)
        y1 = (y0 + 1).clamp(0, src_h - 1)
        vals = interp_taps(taps[..., y0, x0], taps[..., y0, x1], taps[..., y1, x0],
                           taps[..., y1, x1], fx, fy, interp_method, dtype)
    out_dtype = gather_dtype(dtype, interp_method)
    fill = fill_scalar(gather_fill(fill_value, out_dtype), out_dtype, vals.device)
    return narrow(torch.where(valid, vals, fill), out_dtype)


def fused_reproject_plain(
    src, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value
):
    """Plain PyTorch version of K3: (B, out_h, out_w) from (B, H, W)."""
    return fused_reproject_band_plain(
        src, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value,
        0, 0, src.shape[-2],
    )


def fused_reproject_band_plain(
    ext, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value,
    row0, off, src_h,
):
    """Plain PyTorch version of K3's band form: the band's (B, out_h,
    out_w) from global target row *row0*, ``ext`` (B, ext_h, W) holding
    global source rows from *off* of a source *src_h* rows high."""
    method_code(interp_method)
    ext_h, src_w = ext.shape[-2], ext.shape[-1]
    rows = torch.arange(row0, row0 + out_h, dtype=_F32, device=ext.device)[:, None]
    cols = torch.arange(out_w, dtype=_F32, device=ext.device)[None, :]
    ix = interp_field(ix_c, rows, cols, step)
    iy = interp_field(iy_c, rows, cols, step)
    in_src = (ix > -0.5) & (ix < src_w - 0.5) & (iy > -0.5) & (iy < src_h - 0.5)
    iy_l = iy.clamp(0, src_h - 1) - torch.tensor(off, dtype=_F32, device=ext.device)
    in_band = (iy_l > -0.5) & (iy_l < ext_h - 0.5)
    return gather_interp(
        ext, ix, iy_l.clamp(0, ext_h - 1), interp_method, fill_value,
        valid=in_src & in_band,
    )


def gather_piece_plain(
    src, ix_c, iy_c, step, out_h, out_w, src_h_g, src_w_g, j_off, i_off,
    interp_method, fill_value,
):
    """The gather of one exact-mosaic piece, the function of the JAX
    package's ``make_gather_piece_fn`` and ``make_gather_piece_kernel_dyn``
    (``reproject_ops.py:184-325``): (B, out_h, out_w) from the (B, wh, ww)
    source window *src* whose origin lies at global source row *j_off* and
    column *i_off* of a source *src_h_g* x *src_w_g*.  Positions, validity,
    clamps, floors and rints in global source indices (float32 coarse
    fields in global index space); the window offset is taken off the
    integer taps after rounding.  The mosaic's planner asserts that its
    windows hold every tap of a valid pixel, so the taps' clamp to the
    window below changes only pixels that take the fill."""
    method_code(interp_method)
    dev = src.device
    wh, ww = src.shape[-2:]
    rows = torch.arange(out_h, dtype=_F32, device=dev)[:, None]
    cols = torch.arange(out_w, dtype=_F32, device=dev)[None, :]
    ix = interp_field(ix_c, rows, cols, step)
    iy = interp_field(iy_c, rows, cols, step)
    valid = (ix > -0.5) & (ix < src_w_g - 0.5) & (iy > -0.5) & (iy < src_h_g - 0.5)
    ix = ix.clamp(0, src_w_g - 1)
    iy = iy.clamp(0, src_h_g - 1)

    def col(x):
        return (x - i_off).clamp(0, ww - 1)

    def row(y):
        return (y - j_off).clamp(0, wh - 1)

    src = src.to(_F32)
    if interp_method == "nearest":
        vals = src[..., row(torch.round(iy).long()), col(torch.round(ix).long())]
    else:
        x0f = torch.floor(ix)
        y0f = torch.floor(iy)
        x0g = x0f.long()
        y0g = y0f.long()
        x0, x1 = col(x0g), col((x0g + 1).clamp(0, src_w_g - 1))
        y0, y1 = row(y0g), row((y0g + 1).clamp(0, src_h_g - 1))
        vals = interp_taps_f32(
            src[..., y0, x0], src[..., y0, x1], src[..., y1, x0], src[..., y1, x1],
            ix - x0f, iy - y0f, interp_method,
        )
    fill = torch.tensor(float(np.float32(fill_value)), dtype=_F32, device=dev)
    return torch.where(valid, vals, fill)


def require_int32_planes(src_h, src_w, out_h, out_w) -> None:
    """Raise ``ValueError`` where a source or target plane holds 2^31
    elements or more: K3, K13, K14 and K15 index inside a plane with 32-bit
    offsets."""
    for what, h, w in (("source", src_h, src_w), ("target", out_h, out_w)):
        if h * w >= MAX_PLANE:
            raise ValueError(
                f"the kernel takes planes of fewer than 2^31 elements: the "
                f"{what} plane is {h} x {w}"
            )


def fused_reproject(src, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value):
    """K3: the fused direct gather, (B, out_h, out_w) from (B, H, W)."""
    if on_cpu(src, ix_c, iy_c):
        return fused_reproject_plain(
            src, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value
        )
    return _launch_fused(
        src, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value, None
    )


def fused_reproject_band(
    ext, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value,
    row0, off, src_h,
):
    """K3's band form: one mesh band's (B, out_h, out_w) from global
    target row *row0*; ``ext`` holds global source rows from *off*."""
    if on_cpu(ext, ix_c, iy_c):
        return fused_reproject_band_plain(
            ext, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value,
            row0, off, src_h,
        )
    if row0 < 0 or src_h < 1:
        raise ValueError(f"K3 band: first row {row0}, source height {src_h}")
    return _launch_fused(
        ext, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value,
        (row0, off, src_h),
    )


def _launch_fused(src, ix_c, iy_c, step, out_h, out_w, interp_method, fill_value, band):
    """K3 on CUDA tensors; *band* None, or ``(row0, off, src_h)`` for
    the band form."""
    method = method_code(interp_method)
    batch, src_h, src_w = src.shape
    ncj, nci = ix_c.shape
    if ncj < 2 or nci < 2 or step < 1:
        raise ValueError(f"coarse fields need 2x2 samples and step >= 1: {ix_c.shape}, {step}")
    require_int32_planes(src_h, src_w, out_h, out_w)
    require_data_dtype(src.dtype, "the source")
    check_taps_dtype(src.dtype, interp_method)
    require_cuda(src, "src", src.dtype, (batch, src_h, src_w))
    require_cuda(ix_c, "ix_c", _F32, (ncj, nci))
    require_cuda(iy_c, "iy_c", _F32, (ncj, nci))
    out_dtype = gather_dtype(src.dtype, interp_method)
    out = torch.empty((batch, out_h, out_w), dtype=out_dtype, device=src.device)
    if out.numel() == 0:
        return out
    name = "fused_reproject" if band is None else "fused_reproject_band"
    lib = _build.load()
    if src.dtype != _F32:
        fill = gather_fill(fill_value, out_dtype)
        row0, off, true_h = band if band is not None else (0, 0, src_h)
        with torch.cuda.device(src.device):
            rc = lib.xrt_fused_reproject_typed(
                src.data_ptr(), ix_c.data_ptr(), iy_c.data_ptr(), out.data_ptr(), batch,
                src_h, src_w, ncj, nci, out_h, out_w, step, method, float(fill),
                fill_bits(fill, out_dtype), row0, off, true_h, int(band is not None),
                DTYPE_CODES[src.dtype], torch.cuda.current_stream().cuda_stream,
            )
        _build.check(lib, rc, name)
        count_launch(launch_name(name, src.dtype, (_F32,)))
        return out
    args = (
        src.data_ptr(), ix_c.data_ptr(), iy_c.data_ptr(), out.data_ptr(),
        batch, src_h, src_w, ncj, nci, out_h, out_w, step, method,
        float(fill_value),
    )
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        if band is None:
            rc = lib.xrt_fused_reproject_f32(*args, stream)
        else:
            rc = lib.xrt_fused_reproject_band_f32(*args, *band, stream)
    _build.check(lib, rc, name)
    count_launch(name)
    return out


class FusedReprojectFn:
    """``fn(src) -> target`` through K3; ``fn.plain(src)`` through its
    plain version.  ``src`` is (..., src_h, src_w) of a data dtype (the
    output's: :func:`gather_dtype`)."""

    def __init__(self, ix_c, iy_c, step, src_h, src_w, out_h, out_w,
                 interp_method, fill_value):
        method_code(interp_method)
        self.ix_c, self.iy_c, self.step = ix_c, iy_c, step
        self.src_h, self.src_w = src_h, src_w
        self.out_h, self.out_w = out_h, out_w
        self.interp_method, self.fill_value = interp_method, fill_value

    def _run(self, kernel, src):
        if tuple(src.shape[-2:]) != (self.src_h, self.src_w):
            raise ValueError(
                f"source shape {tuple(src.shape)} does not end in "
                f"{(self.src_h, self.src_w)}"
            )
        lead = src.shape[:-2]
        x = src.reshape(-1, self.src_h, self.src_w).contiguous()
        out = kernel(
            x, self.ix_c, self.iy_c, self.step, self.out_h, self.out_w,
            self.interp_method, self.fill_value,
        )
        return out.reshape(lead + out.shape[-2:])

    def __call__(self, src):
        return self._run(fused_reproject, src)

    def plain(self, src):
        return self._run(fused_reproject_plain, src)


def make_fused_reproject_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value: float = np.nan,
    device="cuda",
) -> FusedReprojectFn:
    """The fused direct reprojection of ``source_gm`` onto ``target_gm``,
    with its coarse coordinate fields on *device*."""
    method_code(interp_method)
    ix_c, iy_c, step = coarse_coord_field(source_gm, target_gm, STEP)
    return FusedReprojectFn(
        torch.from_numpy(ix_c).to(device),
        torch.from_numpy(iy_c).to(device),
        step, source_gm.height, source_gm.width,
        target_gm.height, target_gm.width, interp_method, fill_value,
    )
