"""Minimal zarr v2 store, group and array implementation."""

from __future__ import annotations

import json
import math
import os
import zlib
from collections.abc import MutableMapping
from pathlib import Path
from typing import Any

import numpy as np

from ..xrlite import DataArray, Dataset


class MemoryStore(dict):
    """In-memory store: mapping from key (e.g. 'var/.zarray') to bytes."""


class DirectoryStore(MutableMapping):
    """Filesystem-backed store; keys map to file paths under *root*."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.root / key

    def __getitem__(self, key: str) -> bytes:
        p = self._path(key)
        if not p.is_file():
            raise KeyError(key)
        return p.read_bytes()

    def __setitem__(self, key: str, value: bytes):
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(value)

    def __delitem__(self, key: str):
        p = self._path(key)
        if not p.is_file():
            raise KeyError(key)
        p.unlink()

    def __iter__(self):
        for path in self.root.rglob("*"):
            if path.is_file():
                yield str(path.relative_to(self.root)).replace(os.sep, "/")

    def __len__(self):
        return sum(1 for _ in self)


class ZipStore(MutableMapping):
    """Read-only store over a zip archive (zarr's common shipping format,
    e.g. the reference's S3-OLCI-L2A.zarr.zip example data).

    If the archive wraps everything in a single top-level directory that
    holds the root .zgroup/.zarray (``foo.zarr.zip`` containing
    ``foo.zarr/...``), that prefix is stripped automatically."""

    def __init__(self, path: str | Path):
        import zipfile

        self._zf = zipfile.ZipFile(path, mode="r")
        names = [n for n in self._zf.namelist() if not n.endswith("/")]
        self._prefix = ""
        if names and not any(
            n in (".zgroup", ".zarray", ".zmetadata") for n in names
        ):
            tops = {n.split("/", 1)[0] for n in names if "/" in n}
            if len(tops) == 1:
                top = next(iter(tops))
                if any(
                    n == f"{top}/.zgroup" or n == f"{top}/.zmetadata"
                    for n in names
                ):
                    self._prefix = top + "/"
        self._keys = [
            n[len(self._prefix) :] for n in names if n.startswith(self._prefix)
        ]

    def __getitem__(self, key: str) -> bytes:
        try:
            return self._zf.read(self._prefix + key)
        except KeyError:
            raise KeyError(key) from None

    def __setitem__(self, key: str, value: bytes):
        raise OSError("ZipStore is read-only")

    def __delitem__(self, key: str):
        raise OSError("ZipStore is read-only")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def close(self):
        self._zf.close()


def _as_store(store) -> MutableMapping:
    if isinstance(store, MutableMapping):
        return store
    if isinstance(store, (str, Path)):
        if str(store).endswith(".zip") and Path(store).is_file():
            return ZipStore(store)
        return DirectoryStore(store)
    raise TypeError(f"unsupported store type {type(store)}")


def _dtype_to_str(dtype: np.dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype.kind == "M":  # datetime64 stored as int64
        return dtype.str
    return dtype.str


class _PersistentAttrs(MutableMapping):
    """Dict-like attrs view that writes through to the store's .zattrs."""

    def __init__(self, store: MutableMapping, prefix: str):
        self._store = store
        self._key = f"{prefix}.zattrs" if prefix else ".zattrs"

    def _load(self) -> dict:
        raw = self._store.get(self._key)
        return json.loads(raw.decode()) if raw else {}

    def _save(self, data: dict):
        self._store[self._key] = json.dumps(data, indent=0, default=_json_default).encode()

    def __getitem__(self, key):
        return self._load()[key]

    def __setitem__(self, key, value):
        data = self._load()
        data[key] = value
        self._save(data)

    def __delitem__(self, key):
        data = self._load()
        del data[key]
        self._save(data)

    def __iter__(self):
        return iter(self._load())

    def __len__(self):
        return len(self._load())

    def __bool__(self):
        return bool(self._load())

    def asdict(self) -> dict:
        return self._load()


def _json_default(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        v = float(obj)
        return None if math.isnan(v) else v
    if isinstance(obj, float) and math.isnan(obj):
        return None
    return str(obj)


class Array:
    """A zarr v2 array bound to a store."""

    def __init__(self, store: MutableMapping, name: str):
        self._store = store
        self.name = name
        meta = json.loads(store[f"{name}/.zarray"].decode())
        self._meta = meta
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"]) if meta["chunks"] else self.shape
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value")
        comp = meta.get("compressor")
        self.compressor = comp["id"] if isinstance(comp, dict) else None

    @property
    def attrs(self) -> _PersistentAttrs:
        return _PersistentAttrs(self._store, f"{self.name}/")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _chunk_key(self, index: tuple[int, ...]) -> str:
        if not index:
            return f"{self.name}/0"
        return f"{self.name}/" + ".".join(str(i) for i in index)

    def _decode(self, raw: bytes) -> bytes:
        if self.compressor == "zlib":
            return zlib.decompress(raw)
        if self.compressor is None:
            return raw
        if self.compressor == "blosc":
            from .codecs import blosc_decompress

            return blosc_decompress(raw)
        if self.compressor == "gzip":
            return zlib.decompress(raw, 16 + zlib.MAX_WBITS)
        if self.compressor == "zstd":
            import zstandard

            return zstandard.ZstdDecompressor().decompress(raw)
        if self.compressor == "lz4":
            # numcodecs.LZ4: uint32-le decompressed size + raw lz4 block
            from .codecs import lz4_block_decompress

            (n,) = __import__("struct").unpack_from("<I", raw, 0)
            return bytes(lz4_block_decompress(raw[4:], n))
        raise ValueError(f"unsupported compressor {self.compressor!r}")

    def _encode(self, raw: bytes) -> bytes:
        if self.compressor == "zlib":
            return zlib.compress(raw, 1)
        return raw

    def __getitem__(self, key) -> np.ndarray:
        return self.read()[key] if self.shape else self.read()

    def read(self) -> np.ndarray:
        """Materialize the full array."""
        if not self.shape:
            raw = self._store.get(self._chunk_key(()))
            if raw is None:
                return np.asarray(self.fill_value, dtype=self.dtype)
            return np.frombuffer(self._decode(raw), dtype=self.dtype).reshape(())
        out = np.full(
            self.shape,
            self.fill_value if self.fill_value is not None else 0,
            dtype=self.dtype,
        )
        counts = [
            (s + c - 1) // c for s, c in zip(self.shape, self.chunks)
        ]
        for index in np.ndindex(*counts):
            raw = self._store.get(self._chunk_key(index))
            if raw is None:
                continue
            chunk = np.frombuffer(self._decode(raw), dtype=self.dtype).reshape(
                self.chunks
            )
            slices = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(index, self.chunks, self.shape)
            )
            trims = tuple(slice(0, sl.stop - sl.start) for sl in slices)
            out[slices] = chunk[trims]
        return out

    def read_window(self, slices: tuple) -> np.ndarray:
        """Materialize only the chunks overlapping *slices* (one
        ``slice`` with step 1 per dimension) — the unit of lazy reading."""
        if not self.shape:
            return self.read()
        bounds = []
        for sl, s in zip(slices, self.shape):
            start, stop, stride = sl.indices(s)
            if stride != 1:
                raise IndexError("read_window requires unit-stride slices")
            bounds.append((start, max(stop, start)))
        out = np.full(
            tuple(b1 - b0 for b0, b1 in bounds),
            self.fill_value if self.fill_value is not None else 0,
            dtype=self.dtype,
        )
        ranges = [
            range(b0 // c, -(-b1 // c) if b1 > b0 else b0 // c)
            for (b0, b1), c in zip(bounds, self.chunks)
        ]
        import itertools

        for index in itertools.product(*ranges):
            raw = self._store.get(self._chunk_key(index))
            if raw is None:
                continue
            chunk = np.frombuffer(self._decode(raw), dtype=self.dtype).reshape(
                self.chunks
            )
            sel_chunk, sel_out = [], []
            for i, c, (b0, b1), s in zip(
                index, self.chunks, bounds, self.shape
            ):
                c0, c1 = i * c, min((i + 1) * c, s)
                lo, hi = max(c0, b0), min(c1, b1)
                sel_chunk.append(slice(lo - c0, hi - c0))
                sel_out.append(slice(lo - b0, hi - b0))
            out[tuple(sel_out)] = chunk[tuple(sel_chunk)]
        return out

    def write(self, data: np.ndarray):
        """Write the full array chunk by chunk."""
        data = np.ascontiguousarray(np.asarray(data, dtype=self.dtype))
        if not self.shape:
            self._store[self._chunk_key(())] = self._encode(data.tobytes())
            return
        counts = [(s + c - 1) // c for s, c in zip(self.shape, self.chunks)]
        for index in np.ndindex(*counts):
            slices = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(index, self.chunks, self.shape)
            )
            chunk = data[slices]
            if chunk.shape != self.chunks:
                full = np.full(
                    self.chunks,
                    self.fill_value if self.fill_value is not None else 0,
                    dtype=self.dtype,
                )
                full[tuple(slice(0, s) for s in chunk.shape)] = chunk
                chunk = full
            self._store[self._chunk_key(index)] = self._encode(
                np.ascontiguousarray(chunk).tobytes()
            )

    def write_tile(self, data: np.ndarray, chunk_index: tuple[int, ...]):
        """Write one aligned chunk — the unit of resumable computation."""
        data = np.ascontiguousarray(np.asarray(data, dtype=self.dtype))
        if data.shape != self.chunks:
            full = np.full(
                self.chunks,
                self.fill_value if self.fill_value is not None else 0,
                dtype=self.dtype,
            )
            full[tuple(slice(0, s) for s in data.shape)] = data
            data = full
        self._store[self._chunk_key(chunk_index)] = self._encode(data.tobytes())

    def has_tile(self, chunk_index: tuple[int, ...]) -> bool:
        return self._chunk_key(chunk_index) in self._store


class Group:
    """A zarr v2 group bound to a store."""

    def __init__(self, store: MutableMapping):
        self._store = _as_store(store)
        if ".zgroup" not in self._store:
            self._store[".zgroup"] = json.dumps({"zarr_format": 2}).encode()

    @property
    def store(self) -> MutableMapping:
        return self._store

    @property
    def attrs(self) -> _PersistentAttrs:
        return _PersistentAttrs(self._store, "")

    def array_keys(self) -> list[str]:
        names = set()
        for key in list(self._store):
            if key.endswith("/.zarray"):
                names.add(key[: -len("/.zarray")])
        return sorted(names)

    def items(self):
        return [(name, self[name]) for name in self.array_keys()]

    def __contains__(self, name: str) -> bool:
        return f"{name}/.zarray" in self._store

    def __getitem__(self, name: str) -> Array:
        return Array(self._store, name)

    def create_array(
        self,
        name: str,
        shape: tuple[int, ...],
        dtype,
        chunks: tuple[int, ...] | None = None,
        fill_value=0,
        compressor: str | None = None,
        attrs: dict | None = None,
        dims: tuple[str, ...] | None = None,
    ) -> Array:
        chunks = tuple(chunks) if chunks else tuple(shape)
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(chunks) if chunks else list(shape),
            "dtype": _dtype_to_str(np.dtype(dtype)),
            "compressor": {"id": compressor} if compressor else None,
            "fill_value": _json_default(fill_value)
            if isinstance(fill_value, (np.generic, float))
            else fill_value,
            "order": "C",
            "filters": None,
        }
        self._store[f"{name}/.zarray"] = json.dumps(meta, indent=0).encode()
        arr = Array(self._store, name)
        all_attrs = dict(attrs or {})
        if dims is not None:
            all_attrs["_ARRAY_DIMENSIONS"] = list(dims)
        if all_attrs:
            arr.attrs.update(**all_attrs)
        return arr

    def array(self, name: str, data, shape=None, dtype=None, fill_value=0) -> Array:
        """Create an array from data (zarr.Group.array parity)."""
        data = np.asarray(data, dtype=dtype)
        shape = tuple(shape) if shape is not None else data.shape
        arr = self.create_array(name, shape, data.dtype, fill_value=fill_value)
        arr.write(np.broadcast_to(data, shape))
        return arr

    def zeros(self, name: str, shape, chunks=None, dtype=np.float64) -> Array:
        arr = self.create_array(name, tuple(shape), dtype, chunks=chunks, fill_value=0)
        arr.write(np.zeros(shape, dtype=dtype))
        return arr


def group(store=None, overwrite: bool = False) -> Group:
    if store is None:
        store = MemoryStore()
    store = _as_store(store)
    if overwrite:
        for key in list(store):
            del store[key]
    return Group(store)


def open(store, mode: str = "r") -> Group:  # noqa: A001
    store = _as_store(store)
    if ".zgroup" not in store and mode == "r":
        raise FileNotFoundError("not a zarr group")
    return Group(store)


def consolidate_metadata(store) -> None:
    """Collect all metadata documents into .zmetadata."""
    store = _as_store(store)
    metadata: dict[str, Any] = {}
    for key in list(store):
        if key.rsplit("/", 1)[-1] in (".zarray", ".zattrs", ".zgroup"):
            metadata[key] = json.loads(store[key].decode())
    store[".zmetadata"] = json.dumps(
        {"zarr_consolidated_format": 1, "metadata": metadata}, indent=0
    ).encode()


# -- xrlite Dataset <-> zarr -------------------------------------------------


def write_dataset(ds: Dataset, store, compressor: str | None = None) -> None:
    """Persist an xrlite Dataset in zarr v2 layout (xarray-compatible:
    ``_ARRAY_DIMENSIONS`` attributes are written, and non-dimension
    coordinates are recorded in each data variable's CF ``coordinates``
    attribute the way xarray's encoder does, so 2-D lon/lat coords keep
    their coordinate status through a store round trip)."""
    g = group(store, overwrite=False)
    if ds.attrs:
        g.attrs.update(**ds.attrs)
    # non-dimension coordinates (e.g. 2-D lon/lat): 1-D coords named like
    # their dimension re-promote by naming convention alone
    aux_coords = [
        n
        for n, v in ds.coords.items()
        if not (v.ndim == 1 and v.dims == (n,))
    ]
    for name, var in ds.variables.items():
        data = np.asarray(var.data)
        chunks = (
            tuple(c[0] for c in var.chunks) if var.chunks else None
        )
        attrs = dict(var.attrs)
        if name in ds.data_vars and "coordinates" not in attrs:
            applicable = [
                c
                for c in aux_coords
                if c != name
                and set(ds.coords[c].dims) <= set(var.dims)
            ]
            if applicable:
                attrs["coordinates"] = " ".join(applicable)
        arr = g.create_array(
            name,
            data.shape,
            data.dtype,
            chunks=chunks,
            fill_value=None,
            compressor=compressor,
            attrs=attrs,
            dims=var.dims,
        )
        arr.write(data)
    consolidate_metadata(g.store)


def open_dataset(store, lazy: bool = False) -> Dataset:
    """Load a zarr v2 group written by :func:`write_dataset` (or xarray)
    into an xrlite Dataset.

    With ``lazy=True``, multi-dimensional data variables are backed by
    :class:`.lazy.LazyArray` — their chunks stay on disk until sliced
    (coordinates and scalars load eagerly; they are small and indexed
    constantly)."""
    from .lazy import LazyArray

    g = open(store)
    ds = Dataset(attrs=g.attrs.asdict())
    coord_names = set()
    arrays = {}
    for name in g.array_keys():
        arr = g[name]
        attrs = arr.attrs.asdict()
        dims = tuple(attrs.pop("_ARRAY_DIMENSIONS", ())) or tuple(
            f"dim_{i}" for i in range(arr.ndim)
        )
        # CF decoding: names listed in a variable's ``coordinates``
        # attribute are coordinates of the dataset (how 2-D lon/lat
        # keep coordinate status; xarray decode_cf parity)
        listed = attrs.pop("coordinates", "")
        if isinstance(listed, str):
            coord_names.update(listed.split())
        data = LazyArray(arr) if lazy and arr.ndim >= 2 else arr.read()
        arrays[name] = DataArray(
            data,
            dims=dims,
            attrs=attrs,
            name=name,
            chunks=arr.chunks if arr.shape else None,
        )
        if (arr.ndim == 1 and dims == (name,)) or name in ("spatial_ref", "crs"):
            coord_names.add(name)
    for name, var in arrays.items():
        ds[name] = var
    ds = ds.set_coords([n for n in coord_names if n in ds.data_vars])
    return ds
