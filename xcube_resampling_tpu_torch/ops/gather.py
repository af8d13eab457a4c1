"""K4: the separable affine gather, and its downscale form.

``affine_gather`` (``csrc/affine_gather.cu``) replaces the XLA device path
of ``xcube_resampling_tpu/ops/gather.py:affine_gather`` and its separable
branches of ``grid_gather_separable`` (:29-143): every output pixel
``(j, i)`` samples the source at ``y = j * j_scale + j_off``,
``x = i * i_scale + i_off``, nearest or bilinear, with scipy's constant
mode validity.  The wrapper runs the plain PyTorch version
(:func:`affine_gather_plain`) for CPU tensors and launches the kernel for
CUDA tensors, or raises; it never falls back.

Semantics, as the JAX package computes them under x64 (``tests/conftest.py``):

* positions in float64 (``j`` times the scale, plus the offset, two
  roundings);
* nearest: ``floor(y + 0.5)`` clipped to the source, valid on
  ``[-0.5, n - 0.5]`` inclusive; the values keep their dtype;
* bilinear: ``floor`` and fraction, two taps per axis clipped to the
  source and always summed (a NaN neighbour reaches the output, zero
  weight or not), valid on ``[0, n - 1]`` inclusive; rows first,
  ``r0 * (1 - fy) + r1 * fy``, then columns, every operation rounded in
  float64 (JAX's eager ``jnp`` operations are not fused);
* outside: the fill, cast to the source dtype (nearest) or to its float
  dtype (bilinear: float32 for float32, float64 otherwise) before the
  select (``_where_fill``);
* the bilinear result is rounded once to the output dtype (``rint`` and
  saturation for integers), as ``affine._gather_resample`` rounds JAX's
  float64 result; ``out_dtype=torch.float64`` keeps it in float64, which
  the two-pass NaN recovery divides.

The unsigned 16- to 64-bit dtypes are widened in the plain version
(torch has few of their operations, ``_device.widen``) and narrowed back.
Every dtype of ``_device.DATA_DTYPES`` is taken: float16 computes in
float64 from a float16 fill as ``gather._float_dtype`` keeps numpy's
``kind == "f"``; bfloat16 (numpy kind ``"V"``), integers and bool in
float64; the result rounded as ``_device.round_to`` (bool: ``!= 0``).

``affine_gather_reduce`` (``csrc/affine_gather_reduce.cu``) is K4's
downscale form: the bilinear gather at the inflated size reduced in
``j_div x i_div`` windows by one of K5's reducers, without the inflated
image.  Its plain version (:func:`affine_gather_reduce_plain`) is the
chain's: :func:`affine_gather_plain`, then
:func:`.coarsen_ops.coarsen_plain`; the kernel equals it bit for bit.
:func:`plan_gather_reduce` picks its kernel on the host: the cached
kernel (a thread a window, a template on the width) or the direct kernel
(the positional picks, and the windows the cached kernel cannot take).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .._device import (
    DTYPE_CODES,
    SEVEN_DTYPES,
    count_launch,
    launch_name,
    narrow,
    on_cpu,
    require_data_dtype,
    round_to,
    to_f64,
    widen,
)
from .coarsen_ops import REDUCERS, coarsen_plain, pick_tap
from .reproject_ops import fill_bits, fill_scalar
from .coarsen_ops import out_dtype as reduce_dtype

_F64 = torch.float64


def float_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a bilinear gather computes its fill in: the dtypes of
    numpy kind ``"f"`` keep theirs, the others (integers, bool, bfloat16)
    take float64 (``gather._float_dtype``)."""
    return dtype if dtype.is_floating_point and dtype != torch.bfloat16 else _F64


def fill_as(fill_value, dtype: torch.dtype):
    """*fill_value* cast to *dtype*, as ``jnp.asarray(fill).astype(dtype)``
    does on the JAX device path: integer fills wrap, float fills of an
    integer dtype truncate and saturate (NaN to 0), float16 rounds once,
    bfloat16 through float32, bool is ``fill != 0``.  A float for float
    dtypes, an exact Python int for the others."""
    if dtype.is_floating_point:
        f = torch.tensor(float(fill_value), dtype=_F64)
        return float(round_to(f, dtype).to(_F64))
    if dtype == torch.bool:
        return int(float(fill_value) != 0)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    if isinstance(fill_value, (int, np.integer)):
        return int(np.asarray(int(fill_value), dtype=np.int64).astype(np_dtype))
    f = float(fill_value)
    if np.isnan(f):
        return 0
    info = torch.iinfo(dtype)
    return int(min(max(np.trunc(f), info.min), info.max))


def _check(array, order, out_dtype):
    require_data_dtype(array.dtype, "the source")
    if order not in (0, 1):
        raise ValueError(f"order must be 0 (nearest) or 1 (bilinear), got {order!r}")
    if out_dtype not in (None, array.dtype) and (order == 0 or out_dtype != _F64):
        raise ValueError(
            f"out_dtype {out_dtype}: a nearest gather keeps the source dtype, "
            "a bilinear one takes it or float64"
        )
    if array.shape[-2] < 1 or array.shape[-1] < 1:
        raise ValueError(f"empty source of shape {tuple(array.shape)}")


def _positions(n: int, scale: float, off: float, device) -> torch.Tensor:
    return torch.arange(n, dtype=_F64, device=device) * scale + off


def affine_gather_plain(
    array, j_scale, i_scale, j_off, i_off, out_h, out_w, order, fill_value,
    out_dtype=None,
):
    """Plain PyTorch version of K4: (..., out_h, out_w) from (..., H, W)."""
    _check(array, order, out_dtype)
    dtype = array.dtype
    src_h, src_w = array.shape[-2], array.shape[-1]
    a = widen(array)
    yy = _positions(out_h, j_scale, j_off, array.device)
    xx = _positions(out_w, i_scale, i_off, array.device)

    if order == 0:
        valid = (
            ((yy >= -0.5) & (yy <= src_h - 0.5))[:, None]
            & ((xx >= -0.5) & (xx <= src_w - 0.5))[None, :]
        )
        iy = torch.floor(yy + 0.5).clamp(0, src_h - 1).long()
        ix = torch.floor(xx + 0.5).clamp(0, src_w - 1).long()
        vals = a.index_select(-2, iy).index_select(-1, ix)
        fill = fill_scalar(fill_as(fill_value, dtype), dtype, array.device)
        return narrow(torch.where(valid, vals, fill), dtype)

    valid = (
        ((yy >= 0) & (yy <= src_h - 1))[:, None]
        & ((xx >= 0) & (xx <= src_w - 1))[None, :]
    )
    y0f, x0f = torch.floor(yy), torch.floor(xx)
    fy, fx = (yy - y0f)[:, None], xx - x0f
    y0 = y0f.clamp(0, src_h - 1).long()
    x0 = x0f.clamp(0, src_w - 1).long()
    y1 = (y0 + 1).clamp(max=src_h - 1)
    x1 = (x0 + 1).clamp(max=src_w - 1)
    r0 = to_f64(a.index_select(-2, y0), dtype)
    r1 = to_f64(a.index_select(-2, y1), dtype)
    ry0 = r0 * (1 - fy) + r1 * fy
    c0 = ry0.index_select(-1, x0)
    c1 = ry0.index_select(-1, x1)
    result = c0 * (1 - fx) + c1 * fx
    fill = float(fill_as(fill_value, float_dtype(dtype)))
    result = torch.where(valid, result, torch.tensor(fill, dtype=_F64, device=array.device))
    return result if out_dtype == _F64 else round_to(result, dtype)


def affine_gather(
    array, j_scale, i_scale, j_off, i_off, out_h, out_w, order, fill_value,
    out_dtype=None,
):
    """K4: the separable affine gather of the trailing (H, W) dims of
    *array*, (..., out_h, out_w) in *out_dtype* (default: the source's;
    float64 only for bilinear).  The source may be strided; its last
    dimension is made contiguous if it is not."""
    if on_cpu(array):
        return affine_gather_plain(
            array, j_scale, i_scale, j_off, i_off, out_h, out_w, order,
            fill_value, out_dtype,
        )
    _check(array, order, out_dtype)
    dtype = array.dtype
    out_dtype = out_dtype or dtype
    lead = tuple(array.shape[:-2])
    src_h, src_w = array.shape[-2], array.shape[-1]
    x = array.reshape((-1, src_h, src_w))
    if x.stride(2) != 1:
        x = x.contiguous()
    out = torch.empty((x.shape[0], out_h, out_w), dtype=out_dtype, device=array.device)
    if out.numel() == 0:
        return out.reshape(lead + (out_h, out_w))
    fill_dtype = dtype if order == 0 else float_dtype(dtype)
    fill = fill_as(fill_value, fill_dtype)
    lib = _build.load()
    with torch.cuda.device(array.device):
        rc = lib.xrt_affine_gather(
            x.data_ptr(), out.data_ptr(), x.shape[0], src_h, src_w,
            x.stride(0), x.stride(1), out_h, out_w, float(j_scale),
            float(i_scale), float(j_off), float(i_off), int(order), float(fill),
            fill_bits(fill, fill_dtype), DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "affine_gather")
    count_launch(launch_name("affine_gather", dtype))
    return out.reshape(lead + (out_h, out_w))


def _check_reduce(array, j_scale, i_scale, j_div, i_div, agg):
    if agg not in REDUCERS:
        raise ValueError(f"the downscale form reduces {sorted(REDUCERS)}, not {agg!r}")
    if j_div < 1 or i_div < 1:
        raise ValueError(f"window divisors must be positive: {j_div}, {i_div}")
    if not (abs(j_scale) <= 1 and abs(i_scale) <= 1):
        raise ValueError(
            f"the downscale form takes residual scales of at most 1: {j_scale}, {i_scale}"
        )
    _check(array, 1, None)


# The downscale form's kernels (csrc/affine_gather_reduce.cu): the cached
# kernel takes windows of up to CACHED_MAX_WIDTH columns (a template on the
# width), the direct kernel the rest and the positional picks.
CACHED_MAX_WIDTH = 8
PICKS = ("first", "last", "center")
ROUTES = {"direct": 0, "cached": 1}


@functools.lru_cache(maxsize=64)
def taps_step_once(out_w: int, i_div: int, i_scale: float, i_off: float, src_w: int) -> bool:
    """Whether each window's clipped left tap columns step by at most one
    column from tap to tap, as the kernels take the positions (float64
    ``k * i_scale + i_off``): the cached kernel loads the ``i_div + 1``
    columns from a window's first.  Rounding can make a step of two only
    where ``|i_scale|`` is within 2^-21 of 1 or above (columns stay below
    2^31, whose spacing is at most 2^-22), so only there are the positions
    counted."""
    if i_div < 2 or abs(i_scale) <= 1 - 2.0**-21:
        return True
    p = np.arange(out_w * i_div, dtype=np.float64) * i_scale + i_off
    t0 = np.clip(np.floor(p), 0, src_w - 1).reshape(out_w, i_div)
    return bool(np.abs(np.diff(t0, axis=1)).max() <= 1)


def plan_gather_reduce(out_w, i_div, i_scale, i_off, src_w, agg, dtype=torch.float32) -> str:
    """The downscale form's kernel: "cached" for windows of up to
    :data:`CACHED_MAX_WIDTH` columns whose taps step once
    (:func:`taps_step_once`), reduced by one of K5's reducers, on the
    seven dtypes the cached kernel is built for; "direct" for the
    positional picks (one tap a window), the other windows and dtypes."""
    if agg in PICKS or i_div > CACHED_MAX_WIDTH or dtype not in SEVEN_DTYPES:
        return "direct"
    if not taps_step_once(out_w, i_div, float(i_scale), float(i_off), src_w):
        return "direct"
    return "cached"


def affine_gather_reduce_plain(
    array, j_scale, i_scale, j_off, i_off, out_h, out_w, j_div, i_div, agg,
    fill_value,
):
    """Plain PyTorch version of K4's downscale form: the bilinear gather
    at ``(out_h * j_div, out_w * i_div)``, then the window reduction
    *agg*; (..., out_h, out_w)."""
    _check_reduce(array, j_scale, i_scale, j_div, i_div, agg)
    inflated = affine_gather_plain(
        array, j_scale, i_scale, j_off, i_off, out_h * j_div, out_w * i_div, 1,
        fill_value,
    )
    return coarsen_plain(inflated, j_div, i_div, agg)


def affine_gather_reduce(
    array, j_scale, i_scale, j_off, i_off, out_h, out_w, j_div, i_div, agg,
    fill_value,
):
    """K4's downscale form: every output pixel is the *agg* (one of K5's
    reducers) of its ``j_div x i_div`` window of the bilinear gather at
    the residual scales (at most 1 in magnitude, as ``_scale_split``
    leaves them); (..., out_h, out_w) in *agg*'s result dtype.  The
    source may be strided; its last dimension is made contiguous if it is
    not."""
    if on_cpu(array):
        return affine_gather_reduce_plain(
            array, j_scale, i_scale, j_off, i_off, out_h, out_w, j_div, i_div,
            agg, fill_value,
        )
    _check_reduce(array, j_scale, i_scale, j_div, i_div, agg)
    dtype = array.dtype
    lead = tuple(array.shape[:-2])
    src_h, src_w = array.shape[-2], array.shape[-1]
    x = array.reshape((-1, src_h, src_w))
    if x.stride(2) != 1:
        x = x.contiguous()
    out = torch.empty(
        (x.shape[0], out_h, out_w), dtype=reduce_dtype(dtype, agg), device=array.device
    )
    if out.numel() == 0:
        return out.reshape(lead + (out_h, out_w))
    pa, pb = pick_tap(agg, j_div, i_div)
    route = plan_gather_reduce(out_w, i_div, i_scale, i_off, src_w, agg, dtype)
    lib = _build.load()
    with torch.cuda.device(array.device):
        rc = lib.xrt_affine_gather_reduce(
            x.data_ptr(), out.data_ptr(), x.shape[0], src_h, src_w, x.stride(0),
            x.stride(1), out_h, out_w, j_div, i_div, float(j_scale), float(i_scale),
            float(j_off), float(i_off), float(fill_as(fill_value, float_dtype(dtype))),
            REDUCERS[agg], pa, pb, DTYPE_CODES[dtype], ROUTES[route],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "affine_gather_reduce")
    count_launch(launch_name("affine_gather_reduce", dtype))
    return out.reshape(lead + (out_h, out_w))
