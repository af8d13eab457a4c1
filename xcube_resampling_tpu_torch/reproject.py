"""Reprojection engine for datasets whose variables are torch tensors.

Port of ``xcube_resampling_tpu/reproject.py:52-298``.  Variables backed by
torch tensors stay on their device and go through the device tiers:

1. the tiled SRW plan (:func:`.ops.srw.make_srw_reproject_fn`: crop,
   gates, K1 + K2), unless ``XRTPU_EXACT=1``;
2. otherwise K3, the fused direct gather, which the JAX package's exact
   tiers (ESW, exact region mosaic) reproduce: bit-exact for nearest,
   within 2 ulp for bilinear.

Variables backed by numpy arrays take the JAX package's numpy host path
(``_gather_through_windows``), as there.  A reproject that would need the
pre-downscale (scale below ``SCALE_LIMIT``) raises ``NotImplementedError``,
as do ``XRTPU_FAST_EXTREME_WARP=1`` and torch dtypes other than float32.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from collections.abc import Iterable

import torch

from xcube_resampling_tpu.constants import (
    SCALE_LIMIT,
    FillValues,
    InterpMethods,
    RecoverNans,
)
from xcube_resampling_tpu.crs import Transformer
from xcube_resampling_tpu.gridmapping import GridMapping
from xcube_resampling_tpu.reproject import (
    _as_target_array,
    _assert_target_overlaps_source,
    _gm_fingerprint,
    _plan_source_windows,
    _reproject_variable as _reproject_host_variable,
    _target_centers_in_source,
)
from xcube_resampling_tpu.utils import (
    _select_variables,
    assemble_target_shell,
    normalize_grid_mapping,
)
from xcube_resampling_tpu.xrlite import DataArray, Dataset

from .ops.reproject_ops import make_fused_reproject_fn
from .ops.srw import make_srw_reproject_fn
from .ops.srw_kernels import METHODS
from .utils import _get_fill_value, _get_interp_method_str


def reproject_dataset(
    source_ds: Dataset,
    target_gm: GridMapping,
    source_gm: GridMapping | None = None,
    variables: str | Iterable[str] | None = None,
    interp_methods: InterpMethods | None = None,
    agg_methods=None,
    recover_nans: RecoverNans = False,
    fill_values: FillValues | None = None,
) -> Dataset:
    """Reproject a dataset's 2D spatial variables into the CRS and grid of
    *target_gm* (``xcube_resampling_tpu.reproject.reproject_dataset``).
    *agg_methods* and *recover_nans* only act in the pre-downscale, which
    is not ported yet."""
    if source_gm is None:
        source_gm = GridMapping.from_dataset(source_ds)
    if source_gm.is_j_axis_up:
        # the host plan math assumes j-axis-down sources: flip rows once
        source_ds = _flip_rows(source_ds, source_gm.xy_dim_names[1])
        source_gm = GridMapping.from_dataset(source_ds)
    source_ds = normalize_grid_mapping(source_ds, source_gm)
    source_ds = _select_variables(source_ds, variables)
    inv = Transformer.from_crs(target_gm.crs, source_gm.crs, always_xy=True)
    _require_no_downscale(inv, source_gm, target_gm)

    target_ds = assemble_target_shell(
        source_ds,
        source_gm,
        target_gm,
        dict(zip(target_gm.xy_var_names, (target_gm.x_coords, target_gm.y_coords))),
    )
    host_plan = None  # the numpy path's window plan, made when first needed
    grid_dims = (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0])
    for name, var in source_ds.items():
        if var.dims[-2:] == grid_dims:
            if len(var.dims) not in (2, 3):
                raise ValueError(f"Data variable {name} has {len(var.dims)} dimensions.")
            if isinstance(var.data, torch.Tensor):
                target_ds[name] = _reproject_variable(
                    var, name, source_gm, target_gm, interp_methods, fill_values
                )
                continue
            if host_plan is None:
                host_plan = (
                    *_target_centers_in_source(inv, target_gm),
                    _plan_source_windows(inv, source_gm, target_gm),
                )
            target_ds[name] = _reproject_host_variable(
                var, name, source_gm, target_gm, *host_plan,
                interp_methods, fill_values,
            )
        elif not set(grid_dims) & set(var.dims):
            target_ds[name] = var
    return target_ds


def _flip_rows(ds: Dataset, row_dim: str) -> Dataset:
    """*ds* with its rows reversed along *row_dim*: ``torch.flip`` for
    tensors (torch has no negative slice steps), ``isel`` otherwise."""
    flip = {row_dim: slice(None, None, -1)}
    out = ds.assign_coords(
        {n: c.isel(flip) for n, c in ds.coords.items() if row_dim in c.dims}
    )
    for name, var in ds.data_vars.items():
        if row_dim not in var.dims:
            continue
        if isinstance(var.data, torch.Tensor):
            out[name] = DataArray(
                torch.flip(var.data, (var.dims.index(row_dim),)),
                dims=var.dims, attrs=dict(var.attrs), chunks=var.chunks,
            )
        else:
            out[name] = var.isel(flip)
    return out


def _require_no_downscale(inv, source_gm: GridMapping, target_gm: GridMapping):
    """Raise where the JAX engine would pre-downscale the source
    (``reproject._maybe_downscale``: scale below ``SCALE_LIMIT``)."""
    span = inv.transform_bounds(*target_gm.xy_bbox)
    _assert_target_overlaps_source(span, source_gm, target_gm)
    x_scale = source_gm.x_res / ((span[2] - span[0]) / target_gm.width)
    y_scale = source_gm.y_res / ((span[3] - span[1]) / target_gm.height)
    if x_scale < SCALE_LIMIT or y_scale < SCALE_LIMIT:
        raise NotImplementedError(
            f"the target is coarser than the source (scale {x_scale:.3g}, "
            f"{y_scale:.3g} < {SCALE_LIMIT}): the pre-downscale (affine and "
            "coarsen) is not ported yet: ROADMAP queue 1 item 5"
        )


def _reproject_variable(
    var: DataArray, name, source_gm, target_gm, interp_methods, fill_values
) -> DataArray:
    had_band_axis = len(var.dims) == 3
    if not had_band_axis:
        var = var.expand_dims({"dummy": 1})
    if var.data.dtype != torch.float32:
        raise NotImplementedError(
            f"variable {name!r} is {var.data.dtype}: the port reprojects "
            "float32 tensors only so far (ROADMAP queue 1 item 5)"
        )
    fill_value = _get_fill_value(fill_values, name, var)
    interp = _get_interp_method_str(interp_methods, name, var)
    if interp not in METHODS:
        raise NotImplementedError(
            f"interp_methods must be one of 0, 1, 'nearest', 'bilinear', "
            f"'triangular', was '{interp}'."
        )
    image = _reproject_on_device(var.data, source_gm, target_gm, interp, fill_value)
    return _as_target_array(var, image, target_gm, had_band_axis)


# Plan memo: the tier function and its device statics per geometry pair,
# method, fill, tier flag and device.  Two entries at most: the statics
# of one 20480^2 geometry take about 3.8 GB of device memory (float32 pos_v
# and pos_h, the bool mask; about 5.5 GB with the triangular weight s), so
# the bound keeps the memo under 11 GB.
_DEVICE_FN_CACHE: OrderedDict = OrderedDict()
_DEVICE_FN_CACHE_MAX = 2


def device_reproject_fn(source_gm, target_gm, interp_method, fill_value, device):
    """The memoised tier function for a geometry on *device* (built on
    first use)."""
    if os.environ.get("XRTPU_FAST_EXTREME_WARP", "") == "1":
        raise NotImplementedError(
            "XRTPU_FAST_EXTREME_WARP=1 (hybrid and region SRW) is not ported "
            "yet: ROADMAP queue 1 item 6"
        )
    key = (
        _gm_fingerprint(source_gm), _gm_fingerprint(target_gm),
        interp_method, repr(float(fill_value)),
        os.environ.get("XRTPU_EXACT", ""),
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
    fn = None
    if os.environ.get("XRTPU_EXACT", "") != "1":
        fn = make_srw_reproject_fn(
            source_gm, target_gm, interp_method, fill_value, device
        )
    if fn is None:
        fn = make_fused_reproject_fn(
            source_gm, target_gm, interp_method, fill_value, device
        )
    return fn
