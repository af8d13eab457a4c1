"""A named-dimension array with coordinates, attributes and chunk metadata.

Mirrors the subset of ``xarray.DataArray`` behaviour exercised by the
reference library (see xcube_resampling/affine.py:199-240,
rectify.py:263-309, reproject.py:189-265 for the operations the engine
needs).  Data is held eagerly as a numpy array or torch tensor; ``chunks``
is pure metadata.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any

import numpy as np
import torch


def _as_array(data: Any) -> Any:
    """Return *data* as a numpy array unless it is already an ndarray-like
    (numpy or torch) carrying dtype/shape."""
    if hasattr(data, "dtype") and hasattr(data, "shape"):
        return data
    return np.asarray(data)


def _default_dims(ndim: int) -> tuple[str, ...]:
    return tuple(f"dim_{i}" for i in range(ndim))


def _normalize_chunks(
    chunks: Mapping[str, int] | Sequence | None,
    dims: tuple[str, ...],
    shape: tuple[int, ...],
) -> tuple[tuple[int, ...], ...] | None:
    """Normalize a chunks spec to a tuple of per-dimension chunk-size tuples,
    dask-style: e.g. shape (13,) chunked by 5 -> (5, 5, 3)."""
    if chunks is None:
        return None
    per_dim: list[tuple[int, ...]] = []
    if isinstance(chunks, Mapping):
        for dim, size in zip(dims, shape):
            c = chunks.get(dim, -1)
            per_dim.append(_chunk_tuple(size, c))
    else:
        chunks = tuple(chunks)
        assert len(chunks) == len(shape), "chunks must match number of dims"
        for size, c in zip(shape, chunks):
            if isinstance(c, tuple):
                assert sum(c) == size, f"chunk sizes {c} do not sum to {size}"
                per_dim.append(c)
            else:
                per_dim.append(_chunk_tuple(size, c))
    return tuple(per_dim)


def _chunk_tuple(size: int, chunk: int) -> tuple[int, ...]:
    if chunk is None or chunk == -1 or chunk >= size:
        return (size,)
    n = size // chunk
    rest = size - n * chunk
    return (chunk,) * n + ((rest,) if rest else ())


class DataArray:
    """Named-dimension array.

    Args:
        data: numpy array / torch tensor, or anything ``np.asarray`` accepts.
        dims: Dimension names; defaults to ``dim_0``, ``dim_1``, ...
            A single string is accepted for 1D data.
        coords: Optional mapping of coordinate name to DataArray /
            (dims, data) tuple / 1D array.
        attrs: Optional attribute dict.
        name: Optional variable name.
    """

    __slots__ = ("_data", "_dims", "_coords", "_attrs", "name", "_chunks")

    def __init__(
        self,
        data: Any,
        dims: str | Sequence[str] | None = None,
        coords: Mapping[str, Any] | None = None,
        attrs: Mapping[str, Any] | None = None,
        name: str | None = None,
        chunks: Any = None,
    ):
        if isinstance(data, DataArray):
            if dims is None:
                dims = data.dims
            if attrs is None:
                attrs = dict(data.attrs)
            if coords is None and data._coords:
                coords = dict(data._coords)
            if name is None:
                name = data.name
            if chunks is None:
                chunks = data.chunks
            data = data._data
        self._data = _as_array(data)
        if isinstance(dims, str):
            dims = (dims,)
        self._dims = tuple(dims) if dims is not None else _default_dims(self._data.ndim)
        if len(self._dims) != self._data.ndim:
            raise ValueError(
                f"number of dims {self._dims} does not match data rank {self._data.ndim}"
            )
        self._attrs = dict(attrs) if attrs else {}
        self.name = name
        self._chunks = _normalize_chunks(chunks, self._dims, self.shape)
        self._coords: dict[str, DataArray] = {}
        if coords:
            for cname, cval in coords.items():
                self._coords[cname] = _coerce_coord(cname, cval)

    # -- basic properties ---------------------------------------------------

    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, value):
        self._data = _as_array(value)

    @property
    def values(self) -> np.ndarray:
        return np.asarray(self._data)

    @property
    def dims(self) -> tuple[str, ...]:
        return self._dims

    @property
    def attrs(self) -> dict:
        return self._attrs

    @attrs.setter
    def attrs(self, value):
        self._attrs = dict(value)

    @property
    def coords(self) -> dict[str, "DataArray"]:
        return self._coords

    @property
    def dtype(self):
        """The numpy dtype, or for a tensor its ``torch.dtype``."""
        if isinstance(self._data, torch.Tensor):
            return self._data.dtype
        return np.dtype(self._data.dtype)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self._dims, self.shape))

    # -- chunk metadata -----------------------------------------------------

    @property
    def chunks(self) -> tuple[tuple[int, ...], ...] | None:
        return self._chunks

    @property
    def chunksizes(self) -> dict[str, tuple[int, ...]]:
        if self._chunks is None:
            return {}
        return dict(zip(self._dims, self._chunks))

    def chunk(self, chunks: Mapping[str, int] | int | None = None) -> "DataArray":
        if isinstance(chunks, int) or chunks is None:
            chunks = {d: (chunks if chunks else -1) for d in self._dims}
        out = self.copy()
        out._chunks = _normalize_chunks(chunks, self._dims, self.shape)
        return out

    # -- construction helpers ----------------------------------------------

    def copy(self, deep: bool = False) -> "DataArray":
        data = np.array(self._data) if deep else self._data
        out = DataArray(
            data, dims=self._dims, attrs=dict(self._attrs), name=self.name
        )
        out._chunks = self._chunks
        out._coords = dict(self._coords)
        return out

    def rename(self, name: str) -> "DataArray":
        out = self.copy()
        out.name = name
        return out

    # -- indexing -----------------------------------------------------------

    def __getitem__(self, key) -> "DataArray":
        if not isinstance(key, tuple):
            key = (key,)
        # figure out resulting dims: dropped for int indices
        data = self._data[key]
        new_dims = []
        ki = 0
        for dim in self._dims:
            if ki < len(key):
                k = key[ki]
                ki += 1
                if isinstance(k, (int, np.integer)):
                    continue
            new_dims.append(dim)
        if hasattr(data, "ndim") and data.ndim != len(new_dims):
            # boolean/fancy indexing not dim-preserving; fall back
            new_dims = _default_dims(data.ndim)
        out = DataArray(data, dims=tuple(new_dims), attrs=dict(self._attrs), name=self.name)
        if self._chunks is not None and len(new_dims) and all(
            d in self._dims for d in new_dims
        ):
            # preserve chunking metadata through slicing: keep each surviving
            # dimension's leading chunk size, re-tiled to the new extent
            out._chunks = tuple(
                _chunk_tuple(
                    out.shape[ax], self._chunks[self._dims.index(d)][0]
                )
                for ax, d in enumerate(new_dims)
            )
        return out

    def isel(self, indexers: Mapping[str, Any] | None = None, **kwargs) -> "DataArray":
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        key = tuple(indexers.get(dim, slice(None)) for dim in self._dims)
        out = self[key]
        # also slice coords sharing dims
        new_coords = {}
        for cname, cvar in self._coords.items():
            sub = {d: indexers[d] for d in cvar.dims if d in indexers}
            new_coords[cname] = cvar.isel(sub) if sub else cvar
        out._coords = new_coords
        return out

    def expand_dims(self, dims: Mapping[str, int] | str) -> "DataArray":
        if isinstance(dims, str):
            dims = {dims: 1}
        data = self._data
        new_dims = list(self._dims)
        for dim, n in dims.items():
            if n != 1:
                data = np.broadcast_to(
                    np.asarray(data)[np.newaxis, ...], (n,) + tuple(data.shape)
                ).copy()
            else:
                # plain newaxis indexing keeps device tensors on their device
                data = data[np.newaxis, ...]
            new_dims.insert(0, dim)
        out = DataArray(data, dims=tuple(new_dims), attrs=dict(self._attrs), name=self.name)
        out._coords = dict(self._coords)
        return out

    def transpose(self, *dims: str) -> "DataArray":
        if not dims:
            dims = tuple(reversed(self._dims))
        axes = [self._dims.index(d) for d in dims]
        return DataArray(
            np.transpose(np.asarray(self._data), axes),
            dims=dims,
            attrs=dict(self._attrs),
            name=self.name,
        )

    # -- math (numpy semantics, used by tests and helpers) -------------------

    def _binop(self, other, op) -> "DataArray":
        if isinstance(other, DataArray):
            # align by broadcasting over union of dims (simple suffix match)
            self_np, other_np, dims = _broadcast_pair(self, other)
            data = op(self_np, other_np)
            return DataArray(data, dims=dims, name=self.name)
        return DataArray(
            op(np.asarray(self._data), other),
            dims=self._dims,
            attrs=dict(self._attrs),
            name=self.name,
        )

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._binop(other, lambda a, b: b + a)

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binop(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b)

    def __lt__(self, other):
        return self._binop(other, lambda a, b: a < b)

    def __le__(self, other):
        return self._binop(other, lambda a, b: a <= b)

    def __gt__(self, other):
        return self._binop(other, lambda a, b: a > b)

    def __ge__(self, other):
        return self._binop(other, lambda a, b: a >= b)

    def __neg__(self):
        return DataArray(-np.asarray(self._data), dims=self._dims, name=self.name)

    def __float__(self):
        return float(np.asarray(self._data))

    def __int__(self):
        return int(np.asarray(self._data))

    def __bool__(self):
        return bool(np.asarray(self._data))

    def __array__(self, dtype=None):
        arr = np.asarray(self._data)
        return arr.astype(dtype) if dtype is not None else arr

    # -- reductions ----------------------------------------------------------

    def min(self):
        return DataArray(np.min(np.asarray(self._data)))

    def max(self):
        return DataArray(np.max(np.asarray(self._data)))

    def mean(self):
        return DataArray(np.mean(np.asarray(self._data)))

    def diff(self, dim: str) -> "DataArray":
        axis = self._dims.index(dim)
        return DataArray(
            np.diff(np.asarray(self._data), axis=axis), dims=self._dims, name=self.name
        )

    def where(self, cond, other=np.nan) -> "DataArray":
        cond_np = np.asarray(cond)
        return DataArray(
            np.where(cond_np, np.asarray(self._data), other),
            dims=self._dims,
            attrs=dict(self._attrs),
            name=self.name,
        )

    def astype(self, dtype) -> "DataArray":
        return DataArray(
            np.asarray(self._data).astype(dtype),
            dims=self._dims,
            attrs=dict(self._attrs),
            name=self.name,
        )

    def __repr__(self):
        return (
            f"<xrlite.DataArray {self.name or ''!r} {tuple(zip(self._dims, self.shape))}"
            f" dtype={self.dtype}>"
        )


def _coerce_coord(name: str, value: Any) -> DataArray:
    if isinstance(value, DataArray):
        if value.name is None:
            value = value.rename(name)
        return value
    if isinstance(value, tuple) and len(value) in (2, 3):
        dims, data = value[0], value[1]
        attrs = value[2] if len(value) == 3 else None
        return DataArray(data, dims=dims, attrs=attrs, name=name)
    arr = _as_array(value)
    if arr.ndim == 0:
        return DataArray(arr, dims=(), name=name)
    if arr.ndim == 1:
        return DataArray(arr, dims=(name,), name=name)
    raise ValueError(
        f"coordinate {name!r} must be a DataArray, (dims, data) tuple, or <=1D array"
    )


def _broadcast_pair(a: DataArray, b: DataArray):
    """Broadcast two DataArrays over the union of their dims (xarray-style
    outer alignment by dimension name, sizes must match for shared dims)."""
    dims = list(a.dims)
    for d in b.dims:
        if d not in dims:
            dims.append(d)
    sizes = {}
    for da in (a, b):
        for d, s in da.sizes.items():
            if d in sizes and sizes[d] != s:
                raise ValueError(f"conflicting sizes for dim {d!r}")
            sizes[d] = s
    shape = tuple(sizes[d] for d in dims)

    def expand(da: DataArray):
        arr = np.asarray(da.data)
        idx = [dims.index(d) for d in da.dims]
        reshape = [1] * len(dims)
        for ax, d in enumerate(da.dims):
            reshape[dims.index(d)] = da.shape[ax]
        # need axes of arr ordered by target positions
        order = np.argsort(idx, kind="stable")
        arr = np.transpose(arr, order)
        arr = arr.reshape(reshape)
        return np.broadcast_to(arr, shape)

    return expand(a), expand(b), tuple(dims)


def broadcast(*arrays: DataArray) -> tuple[DataArray, ...]:
    """Broadcast DataArrays against each other over named dims
    (xarray.broadcast equivalent, used to build 2D coordinate meshes)."""
    dims: list[str] = []
    sizes: dict[str, int] = {}
    for da in arrays:
        for d, s in da.sizes.items():
            if d not in dims:
                dims.append(d)
            sizes[d] = s
    shape = tuple(sizes[d] for d in dims)
    out = []
    for da in arrays:
        reshape = [1] * len(dims)
        for ax, d in enumerate(da.dims):
            reshape[dims.index(d)] = da.shape[ax]
        idx = [dims.index(d) for d in da.dims]
        order = np.argsort(idx, kind="stable")
        arr = np.transpose(np.asarray(da.data), order).reshape(reshape)
        out.append(
            DataArray(np.broadcast_to(arr, shape), dims=tuple(dims), name=da.name)
        )
    return tuple(out)


def concat(arrays: Sequence[DataArray], dim: str) -> DataArray:
    """Concatenate along a (possibly new) named dimension."""
    first = arrays[0]
    if dim in first.dims:
        axis = first.dims.index(dim)
        data = np.concatenate([np.asarray(a.data) for a in arrays], axis=axis)
        return DataArray(data, dims=first.dims, attrs=dict(first.attrs))
    data = np.stack([np.asarray(a.data) for a in arrays], axis=0)
    return DataArray(data, dims=(dim,) + first.dims, attrs=dict(first.attrs))
