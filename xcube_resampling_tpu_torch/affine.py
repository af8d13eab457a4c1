"""Affine resampling engine (same-CRS regular -> regular grids).

Port of ``xcube_resampling_tpu/affine.py:57-268``.  Each spatial variable
flows through ``_scale_split`` (integral window + residual matrix) ->
``_gather_resample`` (K4, :func:`.ops.gather.affine_gather`, with the
two-pass NaN recovery) -> :func:`.ops.coarsen_ops.coarsen` (K5 or K6) for
the integral part of a downscale.  A bilinear downscale reduced by one of
K5's reducers without the NaN recovery runs both in one kernel, K4's
downscale form (:func:`.ops.gather.affine_gather_reduce`), and never
writes the inflated image.

Spatial variables backed by torch tensors stay on their device;
numpy-backed ones are placed on the *device* argument (default
``"cuda"``) in their own dtype.  The output keeps the input dtype.  The
dtypes are the JAX package's thirteen (``_device.DATA_DTYPES``): float16
to float64, bfloat16, the integers of 8 to 64 bits and bool; others raise
``NotImplementedError``.  Where the JAX package's numpy host path
runs the NaN recovery only when the data holds a NaN, the port always
runs both passes, as the JAX device path does for any non-numpy array.
"""

from __future__ import annotations

import math
from collections.abc import Iterable, Sequence

import torch

from ._device import from_numpy, require_data_dtype, round_to, to_f64
from .constants import (
    AffineTransformMatrix,
    AggMethod,
    AggMethods,
    FillValues,
    FloatInt,
    InterpMethodInt,
    InterpMethods,
    RecoverNans,
)
from .gridmapping import GridMapping
from .ops import coarsen_ops
from .ops.gather import affine_gather, affine_gather_reduce
from .utils import (
    _can_apply_affine_transform,
    _flip_rows,
    _get_agg_method,
    _get_fill_value,
    _get_interp_method_int,
    _get_recover_nan,
    _select_variables,
    normalize_grid_mapping,
)
from .xrlite import DataArray, Dataset

_HIGH_ORDER_MSG = (
    "interp_methods must be one of 0, 1, 'nearest', 'bilinear'. "
    "Higher order is not supported for 3D arrays in affine transforms, "
    "as it causes unintended blending across the non-spatial (e.g., time) "
    "dimension."
)


def affine_transform_dataset(
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
    """Resample *source_ds* from *source_gm* to *target_gm* via the affine
    image-to-image transform (both regular, equal/compatible CRS), as
    ``xcube_resampling_tpu.affine.affine_transform_dataset``; numpy-backed
    spatial variables are placed on *device*."""
    if source_gm is None:
        source_gm = GridMapping.from_dataset(source_ds)
    if source_gm.is_j_axis_up:
        # the corner-composed pixel matrix is an index-space map only for a
        # j-down source: flip rows once (pixel centers are identical)
        source_ds = _flip_rows(source_ds, source_gm.xy_dim_names[1])
        source_gm = source_gm.derive(is_j_axis_up=False)
    source_ds = normalize_grid_mapping(source_ds, source_gm)

    assert _can_apply_affine_transform(source_gm, target_gm), (
        f"Affine transformation cannot be applied to source CRS "
        f"{source_gm.crs.name!r} and target CRS {target_gm.crs.name!r}"
    )

    # a j-up target: compute on its j-down twin, then reverse output rows
    flip_output = target_gm.is_j_axis_up
    compute_gm = (
        target_gm.derive(is_j_axis_up=False) if flip_output else target_gm
    )

    out = resample_dataset(
        _select_variables(source_ds, variables),
        compute_gm.ij_transform_to(source_gm),
        (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0]),
        target_gm.size,
        target_gm.tile_size,
        interp_methods,
        agg_methods,
        recover_nans,
        fill_values,
        device,
    )
    if flip_output:
        out = _flip_rows(out, source_gm.xy_dim_names[1])
    x_name, y_name = target_gm.xy_var_names
    return out.assign_coords(
        {x_name: target_gm.x_coords, y_name: target_gm.y_coords}
    )


def resample_dataset(
    dataset: Dataset,
    affine_matrix: AffineTransformMatrix,
    yx_dims: tuple[str, str],
    target_size: tuple[int, int],
    target_tile_size: tuple[int, int],
    interp_methods: InterpMethods | None = None,
    agg_methods: AggMethods | None = None,
    recover_nans: RecoverNans = False,
    fill_values: FillValues | None = None,
    device="cuda",
) -> Dataset:
    """Resample every variable whose trailing dims are *yx_dims* through
    the affine matrix.  Non-spatial variables are copied; variables that
    use only one of the two spatial dims (1D coords etc.) are dropped."""
    out_w, out_h = target_size
    buckets = {"coords": {}, "data_vars": {}}

    for name, var in dataset.variables.items():
        if var.dims[-2:] == tuple(yx_dims):
            var = _as_tensor_variable(var, name, device)
            shape = var.shape[:-2] + (out_h, out_w)
            data = _resample_array(
                var.data,
                affine_matrix,
                shape,
                _get_interp_method_int(interp_methods, name, var),
                _get_agg_method(agg_methods, name, var),
                _get_recover_nan(recover_nans, name, var),
                _get_fill_value(fill_values, name, var),
            )
            replacement = DataArray(
                data=data,
                dims=var.dims,
                attrs=dict(var.attrs),
                chunks=_output_chunks(var, shape, target_tile_size),
            )
        elif yx_dims[0] in var.dims or yx_dims[1] in var.dims:
            continue  # partial spatial dependence: drop
        else:
            replacement = var

        kind = "coords" if name in dataset.coords else "data_vars"
        if kind == "data_vars" and name not in dataset.data_vars:
            continue
        buckets[kind][name] = replacement

    return Dataset(
        data_vars=buckets["data_vars"],
        coords=buckets["coords"],
        attrs=dict(dataset.attrs),
    )


def _as_tensor_variable(var: DataArray, name, device) -> DataArray:
    """*var* with its data as a tensor of a supported dtype: tensors stay
    where they are, numpy data goes to *device* in its own dtype."""
    data = var.data
    if not isinstance(data, torch.Tensor):
        data = from_numpy(data, device)
    require_data_dtype(data.dtype, f"variable {name!r}")
    return DataArray(data, dims=var.dims, attrs=dict(var.attrs), chunks=var.chunks)


def _output_chunks(var, output_shape, target_tile_size):
    """Chunk metadata for a resampled variable: leading dims keep their
    first chunk size, spatial dims take the target tile size."""
    if var.chunks is not None:
        lead = tuple(c[0] for c in var.chunks[:-2])
    else:
        lead = tuple(output_shape[:-2])
    return lead + (target_tile_size[1], target_tile_size[0])


def _scale_split(affine_matrix: AffineTransformMatrix):
    """Split a downscaling matrix into integral window divisors and the
    residual (<=1 per axis) matrix (reference affine.py:287-307)."""
    (i_scale, sh_x, i_off), (sh_y, j_scale, j_off) = affine_matrix
    i_div, j_div = math.ceil(abs(i_scale)), math.ceil(abs(j_scale))
    residual = (
        (i_scale / i_div, sh_x, i_off),
        (sh_y, j_scale / j_div, j_off),
    )
    return (j_div, i_div), residual


def _resample_array(
    array: torch.Tensor,
    affine_matrix: AffineTransformMatrix,
    output_shape: Sequence[int],
    interp_method: InterpMethodInt,
    agg_method: AggMethod,
    recover_nan: bool,
    fill_value: FloatInt,
) -> torch.Tensor:
    i_scale, j_scale = affine_matrix[0][0], affine_matrix[1][1]
    # abs(): a flipped axis (negative scale) must still aggregate when it
    # downscales
    downscaling = (abs(i_scale) > 1 or abs(j_scale) > 1) and interp_method != 0
    if not downscaling:
        return _gather_resample(
            array, affine_matrix, output_shape, interp_method,
            recover_nan, fill_value,
        )

    # downscale = residual gather at an inflated size, then an integral
    # window aggregation back to the requested size: in one pass (K4's
    # downscale form) for K5's reducers without the two-pass NaN recovery,
    # else K4, then K5 or K6
    (j_div, i_div), residual = _scale_split(affine_matrix)
    agg_name = coarsen_ops.agg_name(agg_method)
    if interp_method == 1 and not recover_nan and agg_name in coarsen_ops.REDUCERS:
        (i_s, _, i_o), (_, j_s, j_o) = residual
        return affine_gather_reduce(
            array, j_s, i_s, j_o, i_o, output_shape[-2], output_shape[-1],
            j_div, i_div, agg_name, fill_value,
        )
    inflated = tuple(output_shape[:-2]) + (
        output_shape[-2] * j_div,
        output_shape[-1] * i_div,
    )
    stretched = _gather_resample(
        array, residual, inflated, interp_method, recover_nan, fill_value
    )
    return coarsen_ops.coarsen(stretched, j_div, i_div, agg_method)


def _gather_resample(
    array: torch.Tensor,
    affine_matrix: AffineTransformMatrix,
    output_shape: Sequence[int],
    interp_method: InterpMethodInt,
    recover_nan: bool,
    fill_value: FloatInt,
) -> torch.Tensor:
    """One K4 gather through the affine map, in the input dtype; with
    *recover_nan* (bilinear) the two-pass NaN recovery of the JAX device
    path: the zero-filled image and the valid-mask weight are gathered in
    float64, divided, and rounded once."""
    if interp_method > 1:
        raise ValueError(_HIGH_ORDER_MSG)

    (i_scale, _, i_off), (_, j_scale, j_off) = affine_matrix
    out_h, out_w = output_shape[-2], output_shape[-1]

    def transform(a, out_dtype=None):
        return affine_gather(
            a, j_scale, i_scale, j_off, i_off, out_h, out_w,
            interp_method, fill_value, out_dtype,
        )

    if not (recover_nan and interp_method > 0):
        return transform(array)
    # jnp.where(nan, 0.0, a) keeps a float dtype and promotes integers to
    # float64; 1.0 - mask is float64 under x64
    if array.dtype.is_floating_point:
        nan_mask = torch.isnan(array)
        zeroed = torch.where(nan_mask, 0.0, array)
    else:
        nan_mask = torch.zeros(array.shape, dtype=torch.bool, device=array.device)
        zeroed = to_f64(array)
    numerator = transform(zeroed, torch.float64)
    weight = transform(1.0 - nan_mask.to(torch.float64))
    result = torch.where(torch.isclose(weight, torch.zeros_like(weight)),
                         torch.nan, numerator / weight)
    return round_to(result, array.dtype)
