"""Reprojection engine for datasets whose variables are torch tensors.

Port of ``xcube_resampling_tpu/reproject.py:52-298``, with the JAX
package's two semantics kept apart:

* tensor variables of the thirteen data dtypes stay on their device and
  go through the device tiers, the JAX package's ladder: the SRW
  (:func:`.ops.srw.make_srw_reproject_fn`: crop, gates, its variant by
  JAX's cost model), unless ``XRTPU_EXACT=1``; then, under
  ``XRTPU_FAST_EXTREME_WARP=1`` (which also admits the hybrid SRW, K17 +
  K18, in the tier before), the two-pass region mosaic
  (:func:`.ops.srw.make_region_reproject_fn`: the SRW on each quadtree
  piece, K3 where a piece refuses); then the exact separable warp
  (:func:`.ops.esw.make_esw_reproject_fn`: crop, ``plan_esw``, K13), where
  its plan admits the mapping; then the exact region mosaic
  (:func:`.ops.srw.make_region_reproject_fn` with ``exact=True``: the ESW
  on each quadtree piece of a domain-scale warp, the direct gather on the
  pieces that refuse, one launch of K16 over all of them), unless
  ``XRTPU_NO_EXACT_MOSAIC=1``; otherwise K3, the fused direct gather.  The
  ESW and the mosaic reproduce the direct gather: bit-exact for nearest,
  within 2 ulp for bilinear.  Each tier applies the JAX package's dtype
  rule: the tiled SRW reads the source in its dtype and returns float64
  for float64, float32 otherwise; the batched SRW casts float64 to
  float32; the aligned and hybrid SRW and the ESW cast to float32; the
  direct gather (K3) keeps the dtype for nearest and lerps the others'
  tap differences in it (float64 stays float64, bool bilinear raises
  ``TypeError``); the two-pass mosaic writes its pieces' results into a
  float32 canvas; the exact mosaic casts to float32 but for its gather
  pieces, which take K3's rule (``TypeError`` where they would return
  another dtype than float32);
* numpy variables take the JAX package's host golden path on the card of
  the *device* argument (default ``"cuda"``): per-pixel float64 target
  centres in the source CRS (:func:`_target_centers_in_source`), the
  per-tile source windows of :func:`_plan_source_windows`, and
  :func:`_gather_through_windows` through K9's window mode; their dtype is
  kept (integers take ``rint``), and they come back as tensors.

Where the target is coarser than the source (scale below
``SCALE_LIMIT``), :func:`_maybe_downscale` first clips the source to the
target's span and downscales it through the affine engine (K4's downscale
form ``affine_gather_reduce``, or K4 then K6 for mode and median), on the
device tensors.  Grid variables on more than one device raise
``ValueError``; dtypes outside ``_device.DATA_DTYPES`` raise
``NotImplementedError``.
``_gm_fingerprint``, ``_as_target_array``, ``_maybe_downscale``,
``_assert_target_overlaps_source``, ``_WindowPlan``,
``_plan_source_windows`` and ``_target_centers_in_source`` are copies of
the JAX package's.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from collections.abc import Iterable
from dataclasses import dataclass

import numpy as np
import torch

from . import affine
from .affine import affine_transform_dataset
from .constants import (
    SCALE_LIMIT,
    AggMethods,
    FillValues,
    InterpMethods,
    RecoverNans,
)
from .crs import Transformer
from .gridmapping import GridMapping
from .ops.esw import make_esw_reproject_fn
from .ops.exact_gather import WindowTiles, exact_gather_windows
from .ops.reproject_ops import METHODS, make_fused_reproject_fn
from .ops.srw import make_region_reproject_fn, make_srw_reproject_fn
from .utils import (
    _flip_rows,
    _get_fill_value,
    _get_interp_method_str,
    _prep_interp_methods_downscale,
    _select_variables,
    assemble_target_shell,
    clip_dataset_by_bbox,
    normalize_grid_mapping,
)
from .xrlite import DataArray, Dataset


def reproject_dataset(
    source_ds: Dataset,
    target_gm: GridMapping,
    source_gm: GridMapping | None = None,
    variables: str | Iterable[str] | None = None,
    interp_methods: InterpMethods | None = None,
    agg_methods: AggMethods | None = None,
    recover_nans: RecoverNans = False,
    fill_values: FillValues | None = None,
    device="cuda",
) -> Dataset:
    """Reproject a dataset's 2D spatial variables into the CRS and grid of
    *target_gm* (``xcube_resampling_tpu.reproject.reproject_dataset``).
    Numpy-backed variables are placed on *device* in their own dtype before
    the pre-downscale, which *agg_methods* and *recover_nans* steer, and
    take the host path's semantics."""
    if source_gm is None:
        source_gm = GridMapping.from_dataset(source_ds)
    if source_gm.is_j_axis_up:
        # the host plan math assumes j-axis-down sources: flip rows once
        source_ds = _flip_rows(source_ds, source_gm.xy_dim_names[1])
        source_gm = GridMapping.from_dataset(source_ds)
    source_ds = normalize_grid_mapping(source_ds, source_gm)
    source_ds = _select_variables(source_ds, variables)
    inv = Transformer.from_crs(target_gm.crs, source_gm.crs, always_xy=True)

    grid_dims = (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0])
    grid_names, host = [], set()
    for name, var in list(source_ds.items()):
        if var.dims[-2:] == grid_dims:
            if len(var.dims) not in (2, 3):
                raise ValueError(f"Data variable {name} has {len(var.dims)} dimensions.")
            if not isinstance(var.data, torch.Tensor):
                host.add(name)
            source_ds[name] = affine._as_tensor_variable(var, name, device)
            grid_names.append(name)
    devices = {source_ds[name].data.device for name in grid_names}
    if len(devices) > 1:
        raise ValueError(
            f"grid variables lie on several devices: {sorted(map(str, devices))}"
        )
    source_ds, source_gm = _maybe_downscale(
        source_ds, source_gm, target_gm, inv,
        interp_methods, agg_methods, recover_nans, device,
    )

    target_ds = assemble_target_shell(
        source_ds,
        source_gm,
        target_gm,
        dict(zip(target_gm.xy_var_names, (target_gm.x_coords, target_gm.y_coords))),
    )
    windows = None
    if host:
        # the host path's plan: per-tile windows and float64 target centres
        plan = _plan_source_windows(inv, source_gm, target_gm)
        centers = _target_centers_in_source(inv, target_gm)
        windows = (plan, centers)
    for name, var in source_ds.items():
        if var.dims[-2:] == grid_dims:
            target_ds[name] = _reproject_variable(
                var, name, source_gm, target_gm, interp_methods, fill_values,
                windows if name in host else None,
            )
        elif not set(grid_dims) & set(var.dims):
            target_ds[name] = var
    return target_ds


def _maybe_downscale(
    source_ds: Dataset,
    source_gm: GridMapping,
    target_gm: GridMapping,
    inv: Transformer,
    interp_methods: InterpMethods | None,
    agg_methods: AggMethods | None,
    recover_nans: RecoverNans,
    device,
) -> tuple[Dataset, GridMapping]:
    """Clip + affine-downscale the source when its resolution is finer than
    the target's (``reproject._maybe_downscale``; SCALE_LIMIT gate).  The
    clip is a view of the source tensors, which K4 reads in place."""
    span = inv.transform_bounds(*target_gm.xy_bbox)
    _assert_target_overlaps_source(span, source_gm, target_gm)
    res_in_source = (
        (span[2] - span[0]) / target_gm.width,
        (span[3] - span[1]) / target_gm.height,
    )
    x_scale = source_gm.x_res / res_in_source[0]
    y_scale = source_gm.y_res / res_in_source[1]
    if x_scale >= SCALE_LIMIT and y_scale >= SCALE_LIMIT:
        return source_ds, source_gm

    margin_x, margin_y = 2 * source_gm.x_res, 2 * source_gm.y_res
    clip_bbox = (
        span[0] - margin_x,
        span[1] - margin_y,
        span[2] + margin_x,
        span[3] + margin_y,
    )
    source_ds = clip_dataset_by_bbox(source_ds, clip_bbox, source_gm.xy_dim_names)
    source_gm = GridMapping.from_dataset(source_ds)

    new_size = tuple(
        max(2, round(scale * extent))
        for scale, extent in (
            (x_scale, source_gm.width),
            (y_scale, source_gm.height),
        )
    )
    coarse_gm = GridMapping.regular(
        size=new_size,
        xy_min=(source_gm.xy_bbox[0], source_gm.xy_bbox[1]),
        xy_res=res_in_source,
        crs=source_gm.crs,
        tile_size=source_gm.tile_size,
    )
    old_names = source_gm.xy_var_names
    old_dims = source_gm.xy_dim_names
    source_ds = affine_transform_dataset(
        source_ds,
        coarse_gm,
        source_gm=source_gm,
        interp_methods=_prep_interp_methods_downscale(interp_methods),
        agg_methods=agg_methods,
        recover_nans=recover_nans,
        device=device,
    )
    # the affine engine assigns coords under the downscale grid mapping's
    # default names: re-assign them under the source's
    if coarse_gm.xy_var_names != old_names:
        stale = [
            n for n in coarse_gm.xy_var_names if n in source_ds.variables
        ]
        source_ds = source_ds.drop_vars(stale).assign_coords(
            {
                old_names[0]: DataArray(
                    np.asarray(coarse_gm.x_coords.data), dims=(old_dims[0],)
                ),
                old_names[1]: DataArray(
                    np.asarray(coarse_gm.y_coords.data), dims=(old_dims[1],)
                ),
            }
        )
    return source_ds, GridMapping.from_dataset(source_ds)


def _reproject_variable(
    var: DataArray, name, source_gm, target_gm, interp_methods, fill_values,
    windows=None,
) -> DataArray:
    """One variable through the device tiers, or, where *windows* (the
    host path's plan and target centres) is given, through
    :func:`_gather_through_windows`."""
    had_band_axis = len(var.dims) == 3
    if not had_band_axis:
        var = var.expand_dims({"dummy": 1})
    fill_value = _get_fill_value(fill_values, name, var)
    interp = _get_interp_method_str(interp_methods, name, var)
    if interp not in METHODS:
        raise NotImplementedError(
            f"interp_methods must be one of 0, 1, 'nearest', 'bilinear', "
            f"'triangular', was '{interp}'."
        )
    if windows is None:
        image = _reproject_on_device(var.data, source_gm, target_gm, interp, fill_value)
    else:
        plan, (src_xx, src_yy) = windows
        image = _gather_through_windows(
            var.data, source_gm, target_gm, src_xx, src_yy, plan, interp, fill_value
        )
    return _as_target_array(var, image, target_gm, had_band_axis)


# Plan memo: the tier function and its device statics (coarse fields,
# tap bases and windows: about 30 MB for a 20480^2 geometry) per geometry
# pair, method, fill, the tier switches (XRTPU_EXACT,
# XRTPU_FAST_EXTREME_WARP, XRTPU_NO_EXACT_MOSAIC) and device; the JAX
# package's key and bound.
_DEVICE_FN_CACHE: OrderedDict = OrderedDict()
_DEVICE_FN_CACHE_MAX = 4


def _gm_fingerprint(gm) -> tuple:
    return (
        str(gm.crs), tuple(gm.size), tuple(gm.xy_res), tuple(gm.xy_bbox),
        bool(gm.is_j_axis_up),
    )


def device_reproject_fn(source_gm, target_gm, interp_method, fill_value, device):
    """The memoised tier function for a geometry on *device* (built on
    first use)."""
    key = (
        _gm_fingerprint(source_gm), _gm_fingerprint(target_gm),
        interp_method, repr(float(fill_value)),
        os.environ.get("XRTPU_EXACT", ""),
        os.environ.get("XRTPU_FAST_EXTREME_WARP", ""),
        os.environ.get("XRTPU_NO_EXACT_MOSAIC", ""),
        str(torch.device(device)),
    )
    fn = _DEVICE_FN_CACHE.pop(key, None)
    if fn is None:
        fn = _build_device_reproject_fn(
            source_gm, target_gm, interp_method, fill_value, device
        )
    _DEVICE_FN_CACHE[key] = fn  # (re-)insert as the newest entry
    while len(_DEVICE_FN_CACHE) > _DEVICE_FN_CACHE_MAX:
        _DEVICE_FN_CACHE.popitem(last=False)
    return fn


def _reproject_on_device(data, source_gm, target_gm, interp_method, fill_value):
    fn = device_reproject_fn(
        source_gm, target_gm, interp_method, fill_value, data.device
    )
    return fn(data)


def _build_device_reproject_fn(
    source_gm, target_gm, interp_method, fill_value, device
):
    # the JAX package's ladder (reproject.py:272-297): the SRW unless
    # XRTPU_EXACT=1 (the hybrid admitted under XRTPU_FAST_EXTREME_WARP=1),
    # then under that switch the two-pass region mosaic, the exact
    # separable warp, the exact region mosaic unless
    # XRTPU_NO_EXACT_MOSAIC=1 (K16), then the direct gather (K3)
    fn = None
    fast = os.environ.get("XRTPU_FAST_EXTREME_WARP", "") == "1"
    if os.environ.get("XRTPU_EXACT", "") != "1":
        fn = make_srw_reproject_fn(
            source_gm, target_gm, interp_method, fill_value, device,
            allow_hybrid=fast,
        )
    if fn is None and fast:
        fn = make_region_reproject_fn(
            source_gm, target_gm, interp_method, fill_value, device=device
        )
    if fn is None:
        fn = make_esw_reproject_fn(
            source_gm, target_gm, interp_method, fill_value, device=device
        )
    if fn is None and os.environ.get("XRTPU_NO_EXACT_MOSAIC", "") != "1":
        fn = make_region_reproject_fn(
            source_gm, target_gm, interp_method, fill_value, exact=True,
            device=device,
        )
    if fn is None:
        fn = make_fused_reproject_fn(
            source_gm, target_gm, interp_method, fill_value, device
        )
    return fn


def _as_target_array(var, image, target_gm, had_band_axis) -> DataArray:
    tile_hw = (target_gm.tile_height, target_gm.tile_width)
    chunks = None
    if var.chunks is not None:
        chunks = tuple(c[0] for c in var.chunks[:-2]) + tile_hw

    grid_dims = (target_gm.xy_dim_names[1], target_gm.xy_dim_names[0])
    if had_band_axis:
        dims = (var.dims[0],) + grid_dims
    else:
        image = image[0, :, :]
        dims = grid_dims
        if chunks is not None:
            chunks = chunks[1:]
    return DataArray(data=image, dims=dims, attrs=dict(var.attrs), chunks=chunks)


def _assert_target_overlaps_source(
    span: tuple[float, float, float, float],
    source_gm: GridMapping,
    target_gm: GridMapping,
) -> None:
    """Raise early when the target grid, transformed into the source CRS,
    is disjoint from the source extent.  Conservative on purpose: only
    raises when the transformed bounds are finite and non-wrapping and
    still clearly disjoint."""
    if not all(math.isfinite(v) for v in span):
        return
    if span[0] > span[2] or span[1] > span[3]:
        # wrapped/degenerate transform (e.g. antimeridian) — let the
        # regular pipeline handle it
        return
    sx0, sy0, sx1, sy1 = source_gm.xy_bbox
    if span[2] < sx0 or span[0] > sx1 or span[3] < sy0 or span[1] > sy1:
        raise ValueError(
            "target grid does not overlap the source extent: target bbox"
            f" {tuple(target_gm.xy_bbox)} ({target_gm.crs}) maps to"
            f" {tuple(span)} in the source CRS, but the source bbox is"
            f" {(sx0, sy0, sx1, sy1)} ({source_gm.crs})"
        )


@dataclass
class _WindowPlan:
    """Per-target-tile uniform source windows: int32 bboxes ``(4, ny, nx)``
    in padded-source pixel space, float32 window-origin coordinate stacks,
    and the padding that embeds out-of-extent windows."""

    bboxes: np.ndarray  # (4, ny, nx): i0, j0, i1, j1
    x_stack: np.ndarray  # (win_w, ny, nx)
    y_stack: np.ndarray  # (win_h, ny, nx)
    pad_width: tuple


def _gather_through_windows(
    array: torch.Tensor,
    source_gm: GridMapping,
    target_gm: GridMapping,
    src_xx: np.ndarray,
    src_yy: np.ndarray,
    plan: _WindowPlan,
    interp: str,
    fill_value,
) -> torch.Tensor:
    """The host golden path (``reproject._gather_through_windows``): every
    target tile gathered through its planned window of the fill-padded
    source, in one launch of K9's window mode on *array*'s device."""
    tiles = WindowTiles(
        ij=np.stack([plan.bboxes[0].reshape(-1), plan.bboxes[1].reshape(-1)], axis=1)
        .astype(np.int64),
        xy=np.stack(
            [plan.x_stack[0].reshape(-1), plan.y_stack[0].reshape(-1)], axis=1
        ).astype(np.float64),
        tile_h=int(target_gm.tile_height),
        tile_w=int(target_gm.tile_width),
        n_tiles_x=int(plan.bboxes.shape[2]),
        win_h=int(plan.y_stack.shape[0]),
        win_w=int(plan.x_stack.shape[0]),
        pad_top=int(plan.pad_width[1][0]),
        pad_left=int(plan.pad_width[2][0]),
        x_res=float(source_gm.x_res),
        neg_y_res=float(-source_gm.y_res),
    )

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(array.device)

    lead = tuple(array.shape[:-2])
    src = array.reshape((-1,) + tuple(array.shape[-2:])).contiguous()
    out = exact_gather_windows(src, put(src_xx), put(src_yy), tiles, fill_value, interp)
    return out.reshape(lead + tuple(out.shape[-2:]))


def _plan_source_windows(
    inv: Transformer,
    source_gm: GridMapping,
    target_gm: GridMapping,
) -> _WindowPlan:
    """Per-target-tile source pixel windows, uniformized to the largest
    window, plus per-tile window-origin coordinate stacks and the source
    padding needed where windows exceed the source extent
    (``reproject._plan_source_windows``)."""
    ny = math.ceil(target_gm.height / target_gm.tile_height)
    nx = math.ceil(target_gm.width / target_gm.tile_width)
    x_res, y_res = source_gm.x_res, source_gm.y_res
    x0 = float(np.asarray(source_gm.x_coords.data)[0])
    y_vals = np.asarray(source_gm.y_coords.data)
    y0 = float(y_vals[0])

    # analytic per-tile source bboxes via densified bounds transform
    spans = np.asarray(
        [inv.transform_bounds(*xy_bbox) for xy_bbox in target_gm.xy_bboxes]
    )  # (ny*nx, 4): x_lo, y_lo, x_hi, y_hi in source coords
    i_lo = np.floor((spans[:, 0] - x0) / x_res).astype(np.int64)
    i_hi = np.ceil((spans[:, 2] - x0) / x_res).astype(np.int64)
    j_lo = np.floor((y0 - spans[:, 3]) / y_res).astype(np.int64)
    j_hi = np.ceil((y0 - spans[:, 1]) / y_res).astype(np.int64)

    # uniformize: grow every window (centered) to the largest extent
    win_w = int(np.max(i_hi - i_lo)) + 1
    win_h = int(np.max(j_hi - j_lo)) + 1
    i_start = i_lo - (win_w - (i_hi - i_lo)) // 2
    j_start = j_lo - (win_h - (j_hi - j_lo)) // 2

    i_min, i_max = int(i_start.min()), int(i_start.max()) + win_w
    j_min, j_max = int(j_start.min()), int(j_start.max()) + win_h

    # window-origin coordinate stacks, float32 like the reference: the
    # goldens encode this quantization of the window origin
    x_line = x0 + (i_min + np.arange(i_max - i_min)) * x_res
    y_step = float(y_vals[1] - y_vals[0])
    y_line = y0 + (j_min + np.arange(j_max - j_min)) * y_step
    taps_w = np.arange(win_w)[:, None]
    taps_h = np.arange(win_h)[:, None]
    x_stack = (
        x_line[(i_start - i_min)[None, :] + taps_w]
        .astype(np.float32)
        .reshape(win_w, ny, nx)
    )
    y_stack = (
        y_line[(j_start - j_min)[None, :] + taps_h]
        .astype(np.float32)
        .reshape(win_h, ny, nx)
    )

    pad_width = (
        (0, 0),
        (-min(0, j_min), max(0, j_max - source_gm.height)),
        (-min(0, i_min), max(0, i_max - source_gm.width)),
    )
    bboxes = np.stack(
        [
            i_start + pad_width[2][0],
            j_start + pad_width[1][0],
            i_start + pad_width[2][0] + win_w,
            j_start + pad_width[1][0] + win_h,
        ]
    ).astype(np.int32)

    return _WindowPlan(
        bboxes=bboxes.reshape(4, ny, nx),
        x_stack=x_stack,
        y_stack=y_stack,
        pad_width=pad_width,
    )


def _target_centers_in_source(
    inv: Transformer, target_gm: GridMapping
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse-transform all target pixel centers into source CRS
    coordinates (``reproject._target_centers_in_source``)."""
    centers_x = np.asarray(target_gm.x_coords.data, dtype=np.float64)
    centers_y = np.asarray(target_gm.y_coords.data, dtype=np.float64)
    grid_xx, grid_yy = np.meshgrid(centers_x, centers_y)
    out_xx, out_yy = inv.transform(grid_xx, grid_yy)
    return np.asarray(out_xx), np.asarray(out_yy)
