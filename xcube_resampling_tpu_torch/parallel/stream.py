"""Out-of-core streaming execution: resample tile-by-tile into a store.

Port of ``xcube_resampling_tpu/parallel/stream.py``: each target tile goes
through the port's ``resample_in_space`` on *device* (numpy and
:class:`..zarrlite.LazyArray` variables take its numpy route, tensors its
device tiers) and comes back to the host to be written.

The reference relies on dask laziness for out-of-core work and on the
caller writing zarr (SURVEY.md §2.3/§5).  Here the loop is explicit and
*resumable*: each target tile is computed independently (one static-shape
kernel invocation) and written as one zarr chunk; tiles already present in
the store are skipped, so an interrupted job restarted with the same
arguments finishes the remaining tiles only.  Device memory holds a single
tile's working set at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import zarrlite
from .._device import to_numpy
from ..crs import Transformer
from ..gridmapping import GridMapping
from ..spatial import resample_in_space
from ..xrlite import Dataset


def _subset_source(source_ds, source_gm, tile_gm, margin: int):
    """Slice *source_ds* down to the window a target tile actually needs
    (stencil + aggregation margin included).  With chunk-lazy variables
    (:class:`..zarrlite.LazyArray`) this is what keeps the streaming loop
    out-of-core: only the window's chunks are read from the store.

    Returns the subset dataset, or None when a safe window can't be
    determined (caller then uses the full source)."""
    try:
        t = Transformer.from_crs(tile_gm.crs, source_gm.crs)
        x0, y0, x1, y1 = t.transform_bounds(
            tile_gm.x_min, tile_gm.y_min, tile_gm.x_max, tile_gm.y_max
        )
    except Exception:  # noqa: BLE001 - fall back to the full source
        return None
    if not np.all(np.isfinite([x0, y0, x1, y1])):
        return None
    xs = np.asarray(source_gm.x_coords.data, dtype=np.float64)
    ys = np.asarray(source_gm.y_coords.data, dtype=np.float64)
    if xs.ndim != 1 or ys.ndim != 1 or xs.size < 2 or ys.size < 2:
        return None
    dx = xs[1] - xs[0]
    dy = ys[1] - ys[0]
    fi = sorted(((x0 - xs[0]) / dx, (x1 - xs[0]) / dx))
    fj = sorted(((y0 - ys[0]) / dy, (y1 - ys[0]) / dy))
    i0 = max(0, int(np.floor(fi[0])) - margin)
    i1 = min(xs.size, int(np.ceil(fi[1])) + margin + 1)
    j0 = max(0, int(np.floor(fj[0])) - margin)
    j1 = min(ys.size, int(np.ceil(fj[1])) + margin + 1)
    if i1 - i0 < 2 or j1 - j0 < 2:
        return None
    x_dim, y_dim = source_gm.xy_dim_names
    return source_ds.isel({x_dim: slice(i0, i1), y_dim: slice(j0, j1)})


def resample_to_store(
    source_ds: Dataset,
    target_gm: GridMapping,
    store,
    variables=None,
    interp_methods=None,
    agg_methods=None,
    recover_nans=False,
    fill_values=None,
    compressor: str | None = None,
    progress=None,
    window_sources: bool = True,
    device="cuda",
) -> int:
    """Resample *source_ds* to *target_gm* tile by tile into a zarr store.

    With ``window_sources`` (default), each tile slices the source down to
    the window it needs before resampling, so chunk-lazy sources
    (``zarrlite.open_dataset(..., lazy=True)``) never materialize fully —
    the out-of-core read path.  Each tile resamples on *device*.  Returns
    the number of tiles computed in this call (0 when the store was
    already complete — the resume case)."""
    g = zarrlite.group(store)

    source_gm = None
    if window_sources:
        try:
            source_gm = GridMapping.from_dataset(source_ds)
        except Exception:  # noqa: BLE001 - irregular/unknown: use full source
            source_gm = None
        if source_gm is not None and (
            np.asarray(source_gm.x_coords.data).ndim != 1
        ):
            source_gm = None

    tile_w, tile_h = target_gm.tile_width, target_gm.tile_height
    out_w, out_h = target_gm.width, target_gm.height
    x_dim, y_dim = target_gm.xy_dim_names

    # target coordinate/metadata setup (idempotent)
    coords = target_gm.to_coords(exclude_bounds=True)
    for name, coord in coords.items():
        if name not in g:
            arr = g.create_array(
                name,
                coord.shape,
                coord.dtype,
                fill_value=None,
                compressor=compressor,
                attrs=coord.attrs,
                dims=coord.dims,
            )
            arr.write(np.asarray(coord.data))
    if "spatial_ref" not in g:
        sr = g.create_array("spatial_ref", (), np.uint8, fill_value=0)
        attrs = target_gm.crs.to_cf()
        attrs["_ARRAY_DIMENSIONS"] = []
        sr.attrs.update(**attrs)

    # data variable setup
    if variables is None:
        var_names = [
            n
            for n, v in source_ds.data_vars.items()
            if v.dims[-2:]
            == (source_ds[n].dims[-2], source_ds[n].dims[-1])
            and v.ndim in (2, 3)
        ]
    elif isinstance(variables, str):
        var_names = [variables]
    else:
        var_names = list(variables)

    arrays = {}
    for name in var_names:
        var = source_ds.data_vars[name]
        shape = var.shape[:-2] + (out_h, out_w)
        chunks = tuple(var.shape[:-2]) + (tile_h, tile_w)
        if name not in g:
            attrs = dict(var.attrs)
            attrs["grid_mapping"] = "spatial_ref"
            dims = var.dims[:-2] + (y_dim, x_dim)
            g.create_array(
                name,
                shape,
                _numpy_dtype(var.dtype),
                chunks=chunks,
                fill_value=None,
                compressor=compressor,
                attrs=attrs,
                dims=dims,
            )
        arrays[name] = g[name]

    n_tiles_x = -(-out_w // tile_w)
    n_tiles_y = -(-out_h // tile_h)
    computed = 0
    for tj in range(n_tiles_y):
        for ti in range(n_tiles_x):
            lead_index = tuple(
                0 for _ in range(arrays[var_names[0]].ndim - 2)
            )
            if all(
                arrays[n].has_tile(lead_index + (tj, ti)) for n in var_names
            ):
                continue  # resume: tile already done
            w = min(tile_w, out_w - ti * tile_w)
            h = min(tile_h, out_h - tj * tile_h)
            tile_gm = GridMapping.regular(
                size=(max(w, 2), max(h, 2)),
                xy_min=(
                    target_gm.x_min + ti * tile_w * target_gm.x_res,
                    (
                        target_gm.y_min + tj * tile_h * target_gm.y_res
                        if target_gm.is_j_axis_up
                        else target_gm.y_max - (tj * tile_h + h) * target_gm.y_res
                    ),
                ),
                xy_res=target_gm.xy_res,
                crs=target_gm.crs,
                is_j_axis_up=bool(target_gm.is_j_axis_up),
            )
            tile_source = source_ds
            if source_gm is not None:
                sub = _subset_source(source_ds, source_gm, tile_gm, margin=16)
                if sub is not None:
                    tile_source = sub
            tile_ds = resample_in_space(
                tile_source,
                target_gm=tile_gm,
                variables=var_names,
                interp_methods=interp_methods,
                agg_methods=agg_methods,
                recover_nans=recover_nans,
                fill_values=fill_values,
                device=device,
            )
            for name in var_names:
                data = _to_numpy(tile_ds.data_vars[name].data)[..., :h, :w]
                arrays[name].write_tile(data, lead_index + (tj, ti))
            computed += 1
            if progress is not None:
                progress(tj * n_tiles_x + ti + 1, n_tiles_y * n_tiles_x)

    zarrlite.consolidate_metadata(g.store)
    return computed


def _numpy_dtype(dtype) -> np.dtype:
    """A numpy dtype, or a ``torch.dtype``'s numpy counterpart."""
    if isinstance(dtype, torch.dtype):
        return to_numpy(torch.empty(0, dtype=dtype)).dtype
    return np.dtype(dtype)


def _to_numpy(data) -> np.ndarray:
    """A tile's data on the host."""
    if isinstance(data, torch.Tensor):
        return to_numpy(data)
    return np.asarray(data)
