"""A dict of named DataArrays sharing dimensions — xarray.Dataset equivalent.

Covers the Dataset surface the reference engine relies on
(reference: xcube_resampling/utils.py:47-178,
reproject.py:112-186, rectify.py:119-179): variable/coord bookkeeping,
``isel``/``sel`` slicing, bbox clipping via ``sel`` with slices,
chunk metadata, and variable selection.
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping
from typing import Any

import numpy as np

from .dataarray import DataArray, _coerce_coord


def _coerce_var(name: str, value: Any) -> DataArray:
    if isinstance(value, DataArray):
        out = value.copy()
        out.name = name
        return out
    if isinstance(value, tuple) and len(value) in (2, 3):
        dims, data = value[0], value[1]
        attrs = value[2] if len(value) == 3 else None
        if isinstance(dims, str):
            dims = (dims,)
        return DataArray(data, dims=dims, attrs=attrs, name=name)
    arr = np.asarray(value)
    if arr.ndim == 0:
        return DataArray(arr, dims=(), name=name)
    if arr.ndim == 1:
        return DataArray(arr, dims=(name,), name=name)
    raise ValueError(f"cannot coerce variable {name!r} from {type(value)}")


class _CoordsView(Mapping):
    """Mapping view over a Dataset's coordinate variables."""

    def __init__(self, ds: "Dataset"):
        self._ds = ds

    def __getitem__(self, key):
        return self._ds._coords[key]

    def __iter__(self):
        return iter(self._ds._coords)

    def __len__(self):
        return len(self._ds._coords)

    def __contains__(self, key):
        return key in self._ds._coords

    def to_dataset(self) -> "Dataset":
        out = Dataset(attrs={})
        out._coords = dict(self._ds._coords)
        return out


class Dataset:
    """Collection of data variables + coordinate variables + attributes."""

    def __init__(
        self,
        data_vars: Mapping[str, Any] | None = None,
        coords: Mapping[str, Any] | None = None,
        attrs: Mapping[str, Any] | None = None,
    ):
        self._data_vars: dict[str, DataArray] = {}
        self._coords: dict[str, DataArray] = {}
        self._attrs: dict = dict(attrs) if attrs else {}
        if coords:
            for name, val in coords.items():
                self._coords[name] = _coerce_coord_nd(name, val)
        if data_vars:
            for name, val in data_vars.items():
                self._data_vars[name] = _coerce_var(name, val)

    # -- mapping-ish access ---------------------------------------------------

    @property
    def data_vars(self) -> dict[str, DataArray]:
        return self._data_vars

    @property
    def coords(self) -> _CoordsView:
        return _CoordsView(self)

    @property
    def variables(self) -> dict[str, DataArray]:
        out = dict(self._coords)
        out.update(self._data_vars)
        return out

    @property
    def attrs(self) -> dict:
        return self._attrs

    @attrs.setter
    def attrs(self, value):
        self._attrs = dict(value)

    @property
    def dims(self) -> dict[str, int]:
        return self.sizes

    @property
    def sizes(self) -> dict[str, int]:
        sizes: dict[str, int] = {}
        for var in self.variables.values():
            for d, s in var.sizes.items():
                sizes[d] = s
        return sizes

    def __contains__(self, key) -> bool:
        return key in self._data_vars or key in self._coords

    def __iter__(self):
        return iter(self._data_vars)

    def items(self):
        return self._data_vars.items()

    def __getitem__(self, key):
        if isinstance(key, str):
            var = self._data_vars.get(key)
            if var is None:
                var = self._coords.get(key)
            if var is None:
                raise KeyError(key)
            # return a view sharing data and attrs with the stored variable
            # (xarray parity: mutating ds[name].attrs persists), with the
            # relevant coords attached
            view = DataArray(var.data, dims=var.dims, name=var.name)
            view._attrs = var._attrs
            view._chunks = var._chunks
            view._coords = {
                cname: cvar
                for cname, cvar in self._coords.items()
                if set(cvar.dims) <= set(var.dims) or cvar.ndim == 0
            }
            return view
        if isinstance(key, (list, tuple)):
            out = Dataset(attrs=dict(self._attrs))
            for name in key:
                if name not in self._data_vars:
                    raise KeyError(name)
                out._data_vars[name] = self._data_vars[name]
            out._coords = dict(self._coords)
            return out
        raise TypeError(f"invalid key type {type(key)}")

    def __setitem__(self, key: str, value):
        var = _coerce_var(key, value)
        if key in self._coords:
            self._coords[key] = var
        else:
            self._data_vars[key] = var

    def __getattr__(self, name):
        # attribute-style access to variables (ds.rad)
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    # -- manipulation ---------------------------------------------------------

    def copy(self) -> "Dataset":
        """Shallow copy (xarray parity): data is shared, but every variable
        gets an independent wrapper and attrs container, so mutating the
        copy's metadata never leaks into the original."""
        out = Dataset(attrs=dict(self._attrs))
        out._data_vars = {
            k: DataArray(
                v.data, dims=v.dims, attrs=dict(v.attrs), name=v.name,
                chunks=v.chunks,
            )
            for k, v in self._data_vars.items()
        }
        out._coords = {
            k: DataArray(
                v.data, dims=v.dims, attrs=dict(v.attrs), name=v.name,
                chunks=v.chunks,
            )
            for k, v in self._coords.items()
        }
        return out

    def drop_vars(self, names: str | Iterable[str], errors: str = "raise") -> "Dataset":
        if isinstance(names, str):
            names = [names]
        out = self.copy()
        for name in names:
            if name in out._data_vars:
                del out._data_vars[name]
            elif name in out._coords:
                del out._coords[name]
            elif errors == "raise":
                raise KeyError(name)
        return out

    def assign_coords(
        self, coords: Mapping[str, Any] | None = None, **kwargs
    ) -> "Dataset":
        coords = dict(coords or {})
        coords.update(kwargs)
        out = self.copy()
        for name, val in coords.items():
            coord = _coerce_coord_nd(name, val)
            if name in out._data_vars:
                del out._data_vars[name]
            out._coords[name] = coord
        return out

    def set_coords(self, names: str | Iterable[str]) -> "Dataset":
        if isinstance(names, str):
            names = [names]
        out = self.copy()
        for name in names:
            if name in out._data_vars:
                out._coords[name] = out._data_vars.pop(name)
        return out

    def rename(self, mapping: Mapping[str, str]) -> "Dataset":
        out = Dataset(attrs=dict(self._attrs))
        for name, var in self._data_vars.items():
            out._data_vars[mapping.get(name, name)] = var.rename(
                mapping.get(name, name)
            )
        for name, var in self._coords.items():
            out._coords[mapping.get(name, name)] = var.rename(mapping.get(name, name))
        return out

    # -- indexing -------------------------------------------------------------

    def isel(self, indexers: Mapping[str, Any] | None = None, **kwargs) -> "Dataset":
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        out = Dataset(attrs=dict(self._attrs))
        for name, var in self._data_vars.items():
            sub = {d: k for d, k in indexers.items() if d in var.dims}
            out._data_vars[name] = var.isel(sub) if sub else var
        for name, var in self._coords.items():
            sub = {d: k for d, k in indexers.items() if d in var.dims}
            out._coords[name] = var.isel(sub) if sub else var
        return out

    def sel(self, indexers: Mapping[str, Any] | None = None, **kwargs) -> "Dataset":
        """Label-based selection. Supports slice selection on 1D coords whose
        name equals their dimension (sufficient for bbox clipping,
        reference utils.py:77-124)."""
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        iindexers: dict[str, Any] = {}
        for dim, sel in indexers.items():
            coord = self._coords.get(dim)
            if coord is None or coord.ndim != 1:
                raise KeyError(f"no 1D index coordinate for dim {dim!r}")
            cvals = np.asarray(coord.data)
            if isinstance(sel, slice):
                iindexers[dim] = _slice_by_labels(cvals, sel)
            else:
                sel_arr = np.asarray(sel)
                if sel_arr.ndim == 0:
                    iindexers[dim] = int(np.argmin(np.abs(cvals - sel_arr)))
                else:
                    iindexers[dim] = np.array(
                        [int(np.argmin(np.abs(cvals - s))) for s in sel_arr]
                    )
        return self.isel(iindexers)

    # -- chunking metadata ----------------------------------------------------

    def chunk(self, chunks: Mapping[str, int] | int | None = None) -> "Dataset":
        out = Dataset(attrs=dict(self._attrs))
        for name, var in self._data_vars.items():
            if isinstance(chunks, Mapping):
                sub = {d: s for d, s in chunks.items() if d in var.dims}
                out._data_vars[name] = var.chunk(sub) if sub else var.chunk({})
            else:
                out._data_vars[name] = var.chunk(chunks)
        for name, var in self._coords.items():
            if isinstance(chunks, Mapping):
                sub = {d: s for d, s in chunks.items() if d in var.dims}
                out._coords[name] = var.chunk(sub) if sub else var
            else:
                out._coords[name] = var
        return out

    def __repr__(self):
        lines = ["<xrlite.Dataset>"]
        lines.append(f"Dimensions: {self.sizes}")
        lines.append("Coordinates:")
        for name, var in self._coords.items():
            lines.append(f"    {name} {var.dims} {var.dtype}")
        lines.append("Data variables:")
        for name, var in self._data_vars.items():
            lines.append(f"    {name} {var.dims} {var.dtype}")
        return "\n".join(lines)


def _coerce_coord_nd(name: str, value: Any) -> DataArray:
    """Coerce a coordinate allowing 2D (dims, data) tuples and DataArrays."""
    if isinstance(value, DataArray):
        out = value.copy()
        out.name = name
        return out
    if isinstance(value, tuple) and len(value) in (2, 3):
        dims, data = value[0], value[1]
        attrs = value[2] if len(value) == 3 else None
        if isinstance(dims, str):
            dims = (dims,)
        return DataArray(data, dims=dims, attrs=attrs, name=name)
    return _coerce_coord(name, value)


def _slice_by_labels(cvals: np.ndarray, sel: slice) -> slice:
    """Translate a label slice into a positional slice, handling both
    ascending and descending 1D coordinates (pandas-like inclusive stop)."""
    start, stop = sel.start, sel.stop
    n = cvals.size
    if n > 1 and cvals[1] < cvals[0]:
        # descending
        i0 = 0 if start is None else int(np.searchsorted(-cvals, -start, side="left"))
        i1 = n if stop is None else int(np.searchsorted(-cvals, -stop, side="right"))
    else:
        i0 = 0 if start is None else int(np.searchsorted(cvals, start, side="left"))
        i1 = n if stop is None else int(np.searchsorted(cvals, stop, side="right"))
    return slice(i0, i1)
