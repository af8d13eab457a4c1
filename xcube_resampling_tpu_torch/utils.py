"""Dataset helpers and per-variable option resolution.

Copies of ``xcube_resampling_tpu/utils.py``: spatial-dim detection, bbox
clipping, grid-mapping normalization to a ``spatial_ref`` coordinate, the
output-dataset shell, variable selection, the affine-route test of
:func:`.spatial.choose_route`, and the interpolation, aggregation,
NaN-recovery and fill-value resolvers.  The resolvers key on
``torch.dtype`` (the ``DataArray.dtype`` of a tensor) where the JAX
package keys on numpy dtypes; the defaults are the same per dtype.
:func:`_get_agg_method` returns the aggregation's name, which the device
reducers of :mod:`.ops.coarsen_ops` take, where the JAX package returns
the numpy reducer.  :func:`_flip_rows` is the port's own: torch has no
negative slice steps.
"""

from __future__ import annotations

from collections.abc import Callable, Hashable, Iterable, Mapping, Sequence

import numpy as np
import torch

from .constants import (
    AGG_METHODS,
    FILLVALUE_FLOAT,
    FILLVALUE_INT,
    FILLVALUE_UINT8,
    FILLVALUE_UINT16,
    INTERP_METHOD_MAPPING,
    LOG,
    AggMethod,
    AggMethods,
    FloatInt,
    InterpMethod,
    InterpMethodInt,
    InterpMethods,
    InterpMethodStr,
    RecoverNans,
)
from .gridmapping import GridMapping
from .xrlite import DataArray, Dataset


def get_spatial_dims(ds: Dataset) -> tuple[str, str]:
    """The horizontal dimension names of *ds* as ``(x_dim, y_dim)`` —
    either ``("lon", "lat")`` or ``("x", "y")``."""
    for x_dim, y_dim in (("lon", "lat"), ("x", "y")):
        if x_dim in ds and y_dim in ds:
            return x_dim, y_dim
    raise KeyError(
        f"No standard spatial dimensions found in dataset. "
        f"Expected pairs ('lon', 'lat') or ('x', 'y'), "
        f"but found: {list(ds.dims)}."
    )


def clip_dataset_by_bbox(
    ds: Dataset,
    bbox: Sequence[FloatInt],
    spatial_dims: tuple[str, str] | None = None,
) -> Dataset:
    """Clip *ds* to ``(min_x, min_y, max_x, max_y)``.  The y slice follows
    the coordinate's storage direction, so both axis orientations work.
    Tensor variables become views of their source."""
    if len(bbox) != 4:
        raise ValueError(f"Expected bbox of length 4, got: {bbox}")
    x_min, y_min, x_max, y_max = bbox

    x_dim, y_dim = spatial_dims or get_spatial_dims(ds)
    y_vals = np.asarray(ds[y_dim].data)
    y_descending = y_vals[-1] < y_vals[0]
    y_slice = slice(y_max, y_min) if y_descending else slice(y_min, y_max)
    ds = ds.sel({x_dim: slice(x_min, x_max), y_dim: y_slice})

    if any(size == 0 for size in ds.sizes.values()):
        LOG.warning(
            "Clipped dataset contains at least one zero-sized dimension. "
            f"Check if the bounding box {bbox} overlaps with the dataset "
            "extent."
        )
    return ds


def _flip_rows(ds: Dataset, row_dim: str) -> Dataset:
    """*ds* with its rows reversed along *row_dim*: ``torch.flip`` for
    tensors (torch has no negative slice steps), ``isel`` otherwise."""
    def flipped(var: DataArray) -> DataArray:
        if isinstance(var.data, torch.Tensor):
            return DataArray(
                torch.flip(var.data, (var.dims.index(row_dim),)),
                dims=var.dims, attrs=dict(var.attrs), chunks=var.chunks,
            )
        return var.isel({row_dim: slice(None, None, -1)})

    out = ds.assign_coords(
        {n: flipped(c) for n, c in ds.coords.items() if row_dim in c.dims}
    )
    for name, var in ds.data_vars.items():
        if row_dim in var.dims:
            out[name] = flipped(var)
    return out


def normalize_grid_mapping(ds: Dataset, gm: GridMapping) -> Dataset:
    """Replace any existing grid-mapping variable with a canonical
    ``spatial_ref`` scalar coordinate carrying *gm*'s CF CRS attributes,
    and point every data variable's ``grid_mapping`` attribute at it."""
    gm_name = _get_grid_mapping_name(ds)
    if gm_name is not None:
        ds = ds.drop_vars(gm_name)
    ds = ds.assign_coords(
        spatial_ref=DataArray(np.array(0), dims=(), attrs=gm.crs.to_cf())
    )
    out = ds.copy()
    for var_name in list(out.data_vars):
        var = out.data_vars[var_name].copy()
        var.attrs["grid_mapping"] = "spatial_ref"
        out.data_vars[var_name] = var
    return out


def assemble_target_shell(
    source_ds: Dataset,
    source_gm: GridMapping,
    target_gm: GridMapping,
    axis_coords: Mapping[str, DataArray],
) -> Dataset:
    """The output-dataset shell: the source's non-spatial coordinates, the
    target grid's axis coordinates (*axis_coords*, keyed by the target's xy
    var names), and a CF ``spatial_ref`` scalar."""
    carried = source_ds.coords.to_dataset().drop_vars(source_gm.xy_var_names)
    coords = dict(carried.coords)
    for axis in target_gm.xy_var_names:
        coords[axis] = axis_coords[axis]
    coords["spatial_ref"] = DataArray(
        np.array(0), dims=(), attrs=target_gm.crs.to_cf()
    )
    return Dataset(coords=coords, attrs=dict(source_ds.attrs))


def _select_variables(
    ds: Dataset, variables: str | Iterable[str] | None = None
) -> Dataset:
    if variables is None:
        return ds
    names = [variables] if isinstance(variables, str) else list(variables)
    return ds[names]


def _get_grid_mapping_name(ds: Dataset) -> str | None:
    """The single grid-mapping variable name referenced by *ds*, if any:
    collected from data-variable ``grid_mapping`` attributes plus the
    conventional ``crs`` / ``spatial_ref`` names."""
    names = {
        str(var.attrs["grid_mapping"])
        for var in ds.data_vars.values()
        if "grid_mapping" in var.attrs
    }
    if "crs" in ds:
        names.add("crs")
    if "spatial_ref" in ds.coords:
        names.add("spatial_ref")
    assert len(names) <= 1, "Multiple grid mapping names found."
    return next(iter(names), None)


def _can_apply_affine_transform(
    source_gm: GridMapping, target_gm: GridMapping
) -> bool:
    GridMapping.assert_regular(source_gm, name="source_gm")
    GridMapping.assert_regular(target_gm, name="target_gm")
    return _is_equal_crs(source_gm, target_gm)


def _is_equal_crs(source_gm: GridMapping, target_gm: GridMapping) -> bool:
    if source_gm.crs.is_geographic and target_gm.crs.is_geographic:
        return True
    return source_gm.crs.equals(target_gm.crs)


# ---------------------------------------------------------------------------
# Per-variable option resolution


def _resolve_per_var_option(
    options,
    key: Hashable,
    var: DataArray,
    *,
    scalar_types,
    default_of: Callable[[torch.dtype], object],
    what: str,
    option_name: str,
):
    """Resolve one option for variable *key*: mappings are looked up by
    variable name first, then by ``torch.dtype``, warning and falling back
    to the dtype default when neither hits; bare values of *scalar_types*
    apply to every variable; anything else yields the dtype default."""
    if isinstance(options, Mapping):
        value = options.get(str(key), options.get(var.dtype))
        if value is None:
            LOG.warning(
                f"{what} could not be derived from the mapping "
                f"`{option_name}` for data variable {key!r} with data type "
                f"{var.dtype!r}. Defaults are assigned."
            )
            value = default_of(var.dtype)
        return value
    if scalar_types is not None and isinstance(options, scalar_types):
        return options
    if scalar_types is None and options is not None:
        return options
    return default_of(var.dtype)


def _is_integer(dtype: torch.dtype) -> bool:
    """``np.issubdtype(dtype, np.integer)`` for a torch dtype: bool is not
    an integer type."""
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def _default_interp(dtype: torch.dtype) -> InterpMethodInt:
    # integers resample as nearest (0), everything else bilinear (1)
    return 0 if _is_integer(dtype) else 1


def _get_interp_method(
    interp_methods: InterpMethods | None,
    key: Hashable,
    var: DataArray,
) -> InterpMethod:
    return _resolve_per_var_option(
        interp_methods,
        key,
        var,
        scalar_types=(int, str),
        default_of=_default_interp,
        what="Interpolation method",
        option_name="interp_methods",
    )


def _get_interp_method_int(
    interp_methods: InterpMethods | None,
    key: Hashable,
    var: DataArray,
) -> InterpMethodInt:
    method = _get_interp_method(interp_methods, key, var)
    return INTERP_METHOD_MAPPING[method] if isinstance(method, str) else method


def _get_interp_method_str(
    interp_methods: InterpMethods | None,
    key: Hashable,
    var: DataArray,
) -> InterpMethodStr:
    method = _get_interp_method(interp_methods, key, var)
    return INTERP_METHOD_MAPPING[method] if isinstance(method, int) else method


def _prep_interp_methods_downscale(
    interp_methods: InterpMethods | None,
) -> InterpMethods | None:
    """Triangular interpolation degrades to bilinear for the pre-downscale
    pass (the reference does the same: utils.py:239)."""
    downgrade = lambda m: "bilinear" if m == "triangular" else m  # noqa: E731
    if isinstance(interp_methods, Mapping):
        if "triangular" in interp_methods.values():
            return {k: downgrade(v) for k, v in interp_methods.items()}
        return interp_methods
    return downgrade(interp_methods)


def _get_agg_method(
    agg_methods: AggMethods | None,
    key: Hashable,
    var: DataArray,
) -> AggMethod:
    """The aggregation's name (a key of ``AGG_METHODS``; others raise
    ``KeyError``, as the JAX package's lookup does)."""
    name = _resolve_per_var_option(
        agg_methods,
        key,
        var,
        scalar_types=str,
        default_of=lambda dt: "center" if _is_integer(dt) else "mean",
        what="Aggregation method",
        option_name="agg_methods",
    )
    if name not in AGG_METHODS:
        raise KeyError(name)
    return name


def _get_recover_nan(
    recover_nans: RecoverNans | None,
    key: Hashable,
    var: DataArray,
) -> bool:
    return _resolve_per_var_option(
        recover_nans,
        key,
        var,
        scalar_types=bool,
        default_of=lambda dt: False,
        what="The method to recover nan",
        option_name="recover_nans",
    )


def _default_fill_value(dtype: torch.dtype) -> FloatInt:
    if dtype == torch.uint8:
        return FILLVALUE_UINT8
    if dtype == torch.uint16:
        return FILLVALUE_UINT16
    if _is_integer(dtype):
        return FILLVALUE_INT
    return FILLVALUE_FLOAT


def _get_fill_value(
    fill_values: FloatInt | Mapping[torch.dtype | str, FloatInt] | None,
    key: Hashable,
    var: DataArray,
) -> FloatInt:
    return _resolve_per_var_option(
        fill_values,
        key,
        var,
        scalar_types=None,  # any non-None scalar applies to all variables
        default_of=_default_fill_value,
        what="Fill value",
        option_name="fill_values",
    )
