"""Rectification engine on PyTorch tensors (irregular 2D-coords swath ->
regular grid).

Port of ``xcube_resampling_tpu/rectify.py`` (``rectify_dataset``,
``_reproject_swath_coords``, ``_maybe_downscale``, ``_tile_search_border``,
``_phase_a_tier``, ``_inverse_ij_map``, ``_gather_variable``,
``_gather_host_tiled``):

* Phase A: ``XRTPU_PHASEA`` picks the tier as in the JAX package
  (:func:`_phase_a_tier`).  ``device`` (the default on a CUDA device) runs
  JAX's ladder (``rectify_ops.inverse_ij_map_device``): the hybrid (K11,
  K12), the walk (K19), the tiled stencil (K20), with the switches
  ``XRTPU_PHASEA_HYBRID=0`` and ``XRTPU_PHASEA_WALK=0``, and keeps the map
  on the device (a :class:`~.ops.rectify_ops.DeviceIJMap`); where the
  ladder refuses the geometry, K10 scans the tiles' windows on the swath's
  coordinates and K8 solves each tile (:func:`_inverse_ij_map_from_tiles`).
  ``host`` (the default on the CPU) scans them on the host
  (``GridMapping.ij_bboxes_from_xy_bboxes``) and K8 over the tile table
  (:func:`_phase_a_tiles`: per destination tile the source window of the
  JAX package's host tier and its own origin) gives the host tier's map
  bit for bit.  The JAX package's ``auto`` also models the TPU's link; that
  model is not ported.
* Phase B over a device map (the device tier) gathers every variable,
  tensor or numpy, through the resident Phase B
  (``rectify_ops.make_device_var_image_fn_resident``: K7, and for bilinear
  and triangular the SRW interior planned from a step lattice of the map,
  on K1/K2, with the edge band through K7), as the JAX package does.
  Under the host tier Phase B keeps the JAX package's two semantics apart:
  tensor variables take its device Phase B
  (``rectify_ops.make_device_var_image_fn``, the same kernels, planned
  from the whole map), built once per call for each source shape, dtype,
  method and fill; numpy variables take its host gather (K9's ij_map
  mode): their dtype kept, integers rounded with ``rint``; they come back
  as tensors on the device.

Tensor variables stay on their device (all on one); numpy variables are
placed on *device*.  Dtypes outside ``_device.DATA_DTYPES`` (the JAX
package's thirteen) raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from collections.abc import Hashable, Iterable

import numpy as np
import torch

from .affine import _as_tensor_variable, resample_dataset
from .chunk import iter_tiles
from .constants import (
    SCALE_LIMIT,
    UV_DELTA,
    AggMethods,
    FillValues,
    InterpMethods,
    RecoverNans,
)
from .crs import Transformer
from .gridmapping import GridMapping
from .ops import bbox_ops, rectify_ops
from .utils import (
    _get_fill_value,
    _get_interp_method_str,
    _is_equal_crs,
    _prep_interp_methods_downscale,
    _select_variables,
    assemble_target_shell,
    normalize_grid_mapping,
)
from .xrlite import DataArray, Dataset


def rectify_dataset(
    source_ds: Dataset,
    target_gm: GridMapping | None = None,
    source_gm: GridMapping | None = None,
    variables: str | Iterable[str] | None = None,
    interp_methods: InterpMethods | None = None,
    agg_methods: AggMethods | None = None,
    recover_nans: RecoverNans = False,
    fill_values: FillValues | None = None,
    tile_size: int | tuple[int, int] | None = None,
    device="cuda",
) -> Dataset:
    """Rectify a dataset with non-regular (2D) spatial coordinates to a
    regular target grid (``xcube_resampling_tpu.rectify.rectify_dataset``),
    on the device of its tensor variables, or on *device*."""
    if source_gm is None:
        source_gm = GridMapping.from_dataset(source_ds)
    source_ds = normalize_grid_mapping(source_ds, source_gm)
    if target_gm is None:
        target_gm = source_gm.to_regular(tile_size=tile_size)

    # swath coordinates must live in the target CRS before inversion
    if not _is_equal_crs(source_gm, target_gm):
        source_ds = _reproject_swath_coords(source_ds, source_gm, target_gm)
        source_gm = GridMapping.from_dataset(source_ds)

    source_ds = _select_variables(source_ds, variables)
    swath_dims = (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0])
    names = [n for n, v in source_ds.data_vars.items() if v.dims[-2:] == swath_dims]
    host = {n for n in names if not isinstance(source_ds[n].data, torch.Tensor)}
    devices = {source_ds[n].data.device for n in names if n not in host}
    if len(devices) > 1:
        raise ValueError(f"grid variables lie on several devices: {sorted(map(str, devices))}")
    if devices:
        (device,) = devices
    for name in names:
        if len(source_ds[name].dims) not in (2, 3):
            raise ValueError(f"Data variable {name} has {len(source_ds[name].dims)} dimensions.")
        source_ds[name] = _as_tensor_variable(source_ds[name], name, device)

    source_ds, source_gm = _maybe_downscale(
        source_ds, source_gm, target_gm, interp_methods, agg_methods, recover_nans, device,
    )

    # PHASE A: per-target-pixel fractional source indices
    ij_map = _inverse_ij_map(source_gm, target_gm, UV_DELTA, device)

    target_ds = assemble_target_shell(source_ds, source_gm, target_gm, target_gm.to_coords())
    phase_b = {}
    for name, var in source_ds.data_vars.items():
        if var.dims[-2:] == swath_dims:
            target_ds[name] = _gather_variable(
                var, name, target_gm, ij_map, interp_methods, fill_values,
                name in host, phase_b,
            )
        elif not set(swath_dims) & set(var.dims):
            # non-spatial variables ride along unchanged
            target_ds[name] = var
    return target_ds


def _reproject_swath_coords(
    source_ds: Dataset,
    source_gm: GridMapping,
    target_gm: GridMapping,
) -> Dataset:
    """Forward-transform the source's 2D coordinate images into the target
    CRS (``rectify._reproject_swath_coords``)."""
    fwd = Transformer.from_crs(source_gm.crs, target_gm.crs, always_xy=True)
    new_xx, new_yy = fwd.transform(
        np.asarray(source_gm.x_coords.data, dtype=np.float64),
        np.asarray(source_gm.y_coords.data, dtype=np.float64),
    )
    swath_dims = (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0])
    if target_gm.crs.is_geographic:
        new_names = ("lon", "lat")
    else:
        new_names = ("transformed_x", "transformed_y")
    return source_ds.drop_vars(source_gm.xy_var_names).assign_coords(
        {
            "spatial_ref": DataArray(np.array(0), dims=(), attrs=target_gm.crs.to_cf()),
            new_names[0]: (swath_dims, np.asarray(new_xx)),
            new_names[1]: (swath_dims, np.asarray(new_yy)),
        }
    )


def _maybe_downscale(
    source_ds: Dataset,
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_methods: InterpMethods | None,
    agg_methods: AggMethods | None,
    recover_nans: RecoverNans,
    device,
) -> tuple[Dataset, GridMapping]:
    """Pre-downscale when the source resolution is finer than the target's
    (``rectify._maybe_downscale``), through the affine engine on the
    device: the variables and the swath's coordinate images, which come
    back to the host for the grid mapping."""
    x_scale = source_gm.x_res / target_gm.x_res
    y_scale = source_gm.y_res / target_gm.y_res
    if x_scale >= SCALE_LIMIT and y_scale >= SCALE_LIMIT:
        return source_ds, source_gm

    new_size = tuple(
        max(2, round(scale * extent))
        for scale, extent in ((x_scale, source_gm.width), (y_scale, source_gm.height))
    )
    source_ds = resample_dataset(
        source_ds,
        ((1 / x_scale, 0, 0), (0, 1 / y_scale, 0)),
        (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0]),
        new_size,
        source_gm.tile_size,
        _prep_interp_methods_downscale(interp_methods),
        agg_methods,
        recover_nans,
        device=device,
    )
    coords = {}
    for name in source_gm.xy_var_names:
        c = source_ds[name]
        coords[name] = DataArray(c.data.cpu().numpy(), dims=c.dims, attrs=dict(c.attrs))
    source_ds = source_ds.assign_coords(coords)
    return source_ds, GridMapping.from_dataset(source_ds)


def _tile_search_border(target_gm: GridMapping) -> float:
    """Empirical xy_border growing per-tile search windows: more tiles
    means smaller destination bboxes and a higher risk of missing source
    quads near tile edges (``rectify._tile_search_border``)."""
    x1, y1, x2, y2 = target_gm.xy_bbox
    per_axis = min(
        2 * (target_gm.width / target_gm.tile_width) * target_gm.x_res,
        2 * (target_gm.height / target_gm.tile_height) * target_gm.y_res,
    )
    return min(per_axis, min(0.5 * (x2 - x1), 0.5 * (y2 - y1)))


def _phase_a_tier(device) -> str:
    """``'device'`` or ``'host'`` (``rectify._phase_a_tier``): under
    ``XRTPU_PHASEA=auto`` (the default) the device tier on a CUDA device
    and the host tier on the CPU; else the device tier where it is
    ``device``, the host tier for any other value, as in the JAX package."""
    mode = os.environ.get("XRTPU_PHASEA", "auto")
    if mode == "auto":
        return "device" if torch.device(device).type == "cuda" else "host"
    return "device" if mode == "device" else "host"


def _phase_a_tiles(
    source_gm: GridMapping,
    target_gm: GridMapping,
    swath: torch.Tensor | None = None,
) -> rectify_ops.PhaseATiles:
    """K8's tile table: the JAX host tier's per-tile plan
    (``rectify._inverse_ij_map`` and ``_inverse_ij_map_tile``): each
    destination tile's source window from the bbox scan (the window slice
    ``[j_lo, j_hi + 1) x [i_lo, i_hi + 1)`` clipped to the swath, empty where
    no quad can land) and its origin.  The scan runs on the host, or with
    K10 on *swath*, the (2, H, W) float64 coordinates on the device, of
    which only the (n, 4) table comes back; both give the same windows."""
    x1, y1, x2, y2 = target_gm.xy_bbox
    x_res, y_res = target_gm.xy_res
    j_up = target_gm.is_j_axis_up
    shape_hw = (target_gm.height, target_gm.width)
    tile_hw = (target_gm.tile_height, target_gm.tile_width)
    border = _tile_search_border(target_gm)
    if swath is None:
        window_bboxes = source_gm.ij_bboxes_from_xy_bboxes(
            target_gm.xy_bboxes, xy_border=border, ij_border=1,
        )
    else:
        window_bboxes = bbox_ops.compute_ij_bboxes(
            swath[0], swath[1], target_gm.xy_bboxes, border, 1,
        ).cpu().numpy()
    src_h, src_w = source_gm.height, source_gm.width
    ints, origins = [], []
    for block_id, tile in enumerate(iter_tiles(shape_hw, tile_hw)):
        (row0, row1), (col0, col1) = tile.bounds
        i_lo, j_lo, i_hi, j_hi = (int(v) for v in window_bboxes[block_id])
        if i_lo == -1:
            window = (0, 0, 0, 0)
        else:
            window = (i_lo, j_lo, min(i_hi + 1, src_w) - i_lo, min(j_hi + 1, src_h) - j_lo)
        ints.append((row0, col0, row1 - row0, col1 - col0) + window)
        x_origin = x1 + col0 * x_res
        y_origin = (y1 + row0 * y_res) if j_up else (y2 - row0 * y_res)
        origins.append((x_origin, y_origin))
    return rectify_ops.PhaseATiles(
        ints=np.asarray(ints, dtype=np.int64).reshape(-1, 8),
        origins=np.asarray(origins, dtype=np.float64).reshape(-1, 2),
        x_scale=float(x_res),
        y_scale=float(y_res if j_up else -y_res),
        tile_h=int(tile_hw[0]),
        tile_w=int(tile_hw[1]),
        n_tiles_x=-(-shape_hw[1] // tile_hw[1]),
        out_h=int(shape_hw[0]),
        out_w=int(shape_hw[1]),
    )


def _inverse_ij_map(
    source_gm: GridMapping,
    target_gm: GridMapping,
    uv_delta: float,
    device,
    tier: str | None = None,
) -> torch.Tensor | rectify_ops.DeviceIJMap:
    """PHASE A: the (2, height, width) float64 fractional source-index map
    on *device*.  Under the device tier (*tier*, by default
    :func:`_phase_a_tier`'s) JAX's ladder (``rectify_ops.inverse_ij_map_device``:
    the hybrid, the walk, the tiled stencil) gives a
    :class:`~.ops.rectify_ops.DeviceIJMap`; where it refuses the geometry
    or solves a degenerate one on the host, :func:`_inverse_ij_map_from_tiles`
    (K10's tile plan, then K8), where the JAX package takes its host tiles.
    Under the host tier the host scans the tiles and K8 gives a tensor.  The
    swath's coordinates go to the device once a tier."""
    tier = tier or _phase_a_tier(device)
    xy = np.ascontiguousarray(np.asarray(source_gm.xy_coords.data), dtype=np.float64)
    if tier == "device":
        x1, y1, x2, y2 = target_gm.xy_bbox
        x_res, y_res = target_gm.xy_res
        j_up = target_gm.is_j_axis_up
        on_device = rectify_ops.inverse_ij_map_device(
            xy[0], xy[1], 0, 0, (target_gm.height, target_gm.width), x1,
            y1 if j_up else y2, x_res, y_res if j_up else -y_res, uv_delta, device=device,
        )
        if isinstance(on_device, rectify_ops.DeviceIJMap):
            return on_device
    swath = torch.from_numpy(xy).to(device)
    if tier == "host":
        return rectify_ops.rectify_phase_a(swath, _phase_a_tiles(source_gm, target_gm), uv_delta)
    return _inverse_ij_map_from_tiles(source_gm, target_gm, uv_delta, swath)


def _inverse_ij_map_from_tiles(
    source_gm: GridMapping,
    target_gm: GridMapping,
    uv_delta: float,
    swath: torch.Tensor,
) -> rectify_ops.DeviceIJMap:
    """The device tier's map where the ladder refuses the geometry: K10
    scans the tile windows on *swath* (the (2, H, W) float64 coordinates on
    the device) and K8 solves every tile, the host tier's map bit for bit,
    kept on the device."""
    tiles = _phase_a_tiles(source_gm, target_gm, swath)
    return rectify_ops.DeviceIJMap(rectify_ops.rectify_phase_a(swath, tiles, uv_delta))


def _gather_variable(
    var: DataArray,
    name: Hashable,
    target_gm: GridMapping,
    ij_map: torch.Tensor | rectify_ops.DeviceIJMap,
    interp_methods: InterpMethods | None,
    fill_values: FillValues | None,
    host: bool,
    phase_b: dict,
) -> DataArray:
    """PHASE B: gather a variable through the source-index map
    (``rectify._gather_variable``): over a device map every variable
    through the resident Phase B (memoised on the map); else numpy-backed
    ones (*host*) through the host gather and tensors through the device
    Phase B (memoised in *phase_b* for the variables of one call)."""
    had_band_axis = len(var.dims) == 3
    if not had_band_axis:
        var = var.expand_dims({"dummy": 1})
    fill_value = _get_fill_value(fill_values, name, var)
    interp = _get_interp_method_str(interp_methods, name, var)
    data = var.data
    resident = isinstance(ij_map, rectify_ops.DeviceIJMap)
    if host and not resident:
        image = _gather_host_tiled(data, ij_map, fill_value, interp, target_gm)
    else:
        src_hw = tuple(data.shape[-2:])
        if resident:
            gather = rectify_ops.make_device_var_image_fn_resident(ij_map, fill_value, interp)
        else:
            key = (src_hw, data.dtype, interp, repr(fill_value))
            if key not in phase_b:
                phase_b[key] = rectify_ops.make_device_var_image_fn(
                    ij_map, src_hw, fill_value, interp, data.dtype, device=data.device,
                )
            gather = phase_b[key]
        image = gather(data.reshape((-1,) + src_hw).contiguous())
        image = image.reshape(tuple(data.shape[:-2]) + tuple(image.shape[-2:]))

    tile_hw = (target_gm.tile_height, target_gm.tile_width)
    grid_dims = (target_gm.xy_dim_names[1], target_gm.xy_dim_names[0])
    if had_band_axis:
        lead = var.chunks[0][0] if var.chunks is not None else var.shape[0]
        dims = (var.dims[0],) + grid_dims
        chunks = (lead,) + tile_hw
    else:
        image = image[0, :, :]
        dims = grid_dims
        chunks = tile_hw if target_gm.is_tiled else None
    return DataArray(data=image, dims=dims, attrs=dict(var.attrs), chunks=chunks)


def _gather_host_tiled(src_var, ij_map, fill_value, interp_method, target_gm):
    """The host Phase B of a numpy variable (``rectify._gather_host_tiled``):
    K9 over the whole map, which the JAX package's native gather also takes
    in one call (its tile loop only serves its numpy fallback)."""
    return rectify_ops.var_image_from_ij_map(src_var, ij_map, fill_value, interp_method)
