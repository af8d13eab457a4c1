"""Dataset helpers and per-variable option resolution.

Copies of ``xcube_resampling_tpu/utils.py``: grid-mapping normalization to
a ``spatial_ref`` coordinate, the output-dataset shell, variable selection,
the affine-route test of :func:`.spatial.choose_route`, and the
interpolation-method and fill-value resolvers.  The resolvers key on
``torch.dtype`` (the ``DataArray.dtype`` of a tensor) where the JAX
package keys on numpy dtypes; the defaults are the same per dtype.
"""

from __future__ import annotations

from collections.abc import Callable, Hashable, Iterable, Mapping

import numpy as np
import torch

from .constants import (
    FILLVALUE_FLOAT,
    FILLVALUE_INT,
    FILLVALUE_UINT8,
    FILLVALUE_UINT16,
    INTERP_METHOD_MAPPING,
    LOG,
    FloatInt,
    InterpMethod,
    InterpMethodInt,
    InterpMethods,
    InterpMethodStr,
)
from .gridmapping import GridMapping
from .xrlite import DataArray, Dataset


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


def _get_interp_method_str(
    interp_methods: InterpMethods | None,
    key: Hashable,
    var: DataArray,
) -> InterpMethodStr:
    method: InterpMethod = _resolve_per_var_option(
        interp_methods,
        key,
        var,
        scalar_types=(int, str),
        default_of=_default_interp,
        what="Interpolation method",
        option_name="interp_methods",
    )
    return INTERP_METHOD_MAPPING[method] if isinstance(method, int) else method


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
