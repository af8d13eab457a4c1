"""The port's out-of-core tile stream (``resample_to_store``) against the
JAX package's, on the CPU: the cases of ``tests/test_stream.py`` through
both packages into ``MemoryStore`` s.  The stores must hold the same keys
with the same bytes (chunks, ``.zarray``, ``.zattrs``, consolidated
metadata); the resume counts are 4, 0 and 1; a chunk-lazy source with a
corner target reads a fraction of its chunks, and no more than JAX's
stream reads.

The 5x5 golden's data is int64 in ``tests/sampledata.py``: it streams as
int64, and as int32 beside it.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu import zarrlite as jz  # noqa: E402
from xcube_resampling_tpu.parallel.stream import (  # noqa: E402
    resample_to_store as jax_resample_to_store,
)
from xcube_resampling_tpu_torch import zarrlite as pz  # noqa: E402
from xcube_resampling_tpu_torch.parallel import resample_to_store  # noqa: E402

from .sampledata import create_5x5_dataset_regular_utm  # noqa: E402

TARGET = dict(size=(6, 6), xy_min=(4320040, 3382440), xy_res=80, crs="epsg:3035",
              tile_size=4)


def _golden_case(dtype=np.int32):
    ds = create_5x5_dataset_regular_utm()
    band = ds.band_1
    ds["band_1"] = jx.DataArray(
        np.asarray(band.data).astype(dtype), dims=band.dims, attrs=dict(band.attrs)
    )
    return ds


def _to_port(ds, tensors=False):
    """A JAX-package dataset rebuilt with the port's classes (data
    variables as CPU tensors with *tensors*)."""
    def copy(da, tensor):
        data = np.asarray(da.data)
        if tensor:
            data = torch.from_numpy(data.copy())
        return pt.DataArray(data, dims=da.dims, attrs=dict(da.attrs), chunks=da.chunks)

    return pt.Dataset(
        {n: copy(v, tensors) for n, v in ds.data_vars.items()},
        coords={n: copy(c, False) for n, c in ds.coords.items()},
        attrs=dict(ds.attrs),
    )


def _assert_same_store(got, ref):
    """Equal keys and bytes; the JSON documents also decoded."""
    assert sorted(got) == sorted(ref)
    for key in ref:
        if key.rsplit("/", 1)[-1] in (".zarray", ".zattrs", ".zgroup", ".zmetadata"):
            assert json.loads(got[key]) == json.loads(ref[key]), key
        assert got[key] == ref[key], key


def test_stream_matches_jax():
    """tests/test_stream.py:27: 2x2 tiles, nearest; the stores equal."""
    ds = _golden_case()
    ref_store, store = jz.MemoryStore(), pz.MemoryStore()
    assert jax_resample_to_store(ds, jx.GridMapping.regular(**TARGET), ref_store,
                                 interp_methods=0) == 4
    assert resample_to_store(_to_port(ds), pt.GridMapping.regular(**TARGET), store,
                             interp_methods=0, device="cpu") == 4
    _assert_same_store(store, ref_store)
    back, ref = pz.open_dataset(store), jz.open_dataset(ref_store)
    np.testing.assert_array_equal(back.band_1.values, ref.band_1.values)
    assert back["band_1"].attrs.get("grid_mapping") == "spatial_ref"
    assert "x" in back.coords and "y" in back.coords


def test_stream_int64_golden_matches_jax():
    """The 5x5 golden in its own dtype, int64, which the port refused
    before it took the JAX package's thirteen dtypes: 2x2 tiles, nearest;
    the stores equal, the chunks int64."""
    ds = _golden_case(np.int64)
    assert np.asarray(ds.band_1.data).dtype == np.int64
    ref_store, store = jz.MemoryStore(), pz.MemoryStore()
    assert jax_resample_to_store(ds, jx.GridMapping.regular(**TARGET), ref_store,
                                 interp_methods=0) == 4
    assert resample_to_store(_to_port(ds), pt.GridMapping.regular(**TARGET), store,
                             interp_methods=0, device="cpu") == 4
    _assert_same_store(store, ref_store)
    back = pz.open_dataset(store)
    assert np.asarray(back.band_1.values).dtype == np.int64


def test_stream_resume_skips_done_tiles():
    """tests/test_stream.py:42: 4 tiles, then 0, then 1 after deleting a
    chunk; the store ends equal to JAX's."""
    ds = _to_port(_golden_case())
    gm = pt.GridMapping.regular(**TARGET)
    store = pz.MemoryStore()
    counts = [resample_to_store(ds, gm, store, interp_methods=0, device="cpu")]
    counts.append(resample_to_store(ds, gm, store, interp_methods=0, device="cpu"))
    key = [k for k in store if k.startswith("band_1/") and ".z" not in k][0]
    del store[key]
    counts.append(resample_to_store(ds, gm, store, interp_methods=0, device="cpu"))
    assert counts == [4, 0, 1]
    ref_store = jz.MemoryStore()
    jax_resample_to_store(_golden_case(), jx.GridMapping.regular(**TARGET), ref_store,
                          interp_methods=0)
    _assert_same_store(store, ref_store)


def _lazy_case(zarrlite, pkg):
    rng = np.random.default_rng(3)
    h = w = 256
    data = rng.random((h, w)).astype(np.float32)
    source_gm = pkg.GridMapping.regular(
        size=(w, h), xy_min=(500000.0, 5000000.0), xy_res=100.0, crs="epsg:32632",
    )
    eager = pkg.Dataset(
        dict(band=pkg.DataArray(data, dims=("y", "x"), chunks=(32, 32))),
        coords=dict(
            x=np.asarray(source_gm.x_coords.data),
            y=np.asarray(source_gm.y_coords.data),
            spatial_ref=pkg.DataArray(np.array(0), dims=(), attrs=source_gm.crs.to_cf()),
        ),
    )
    eager.data_vars["band"].attrs["grid_mapping"] = "spatial_ref"
    src_store = zarrlite.MemoryStore()
    zarrlite.write_dataset(eager, src_store)

    class CountingStore(zarrlite.MemoryStore):
        def __init__(self, base):
            super().__init__(base)
            self.read_keys = []

        def get(self, key, default=None):
            if key in self:
                self.read_keys.append(key)
            return super().get(key, default)

    counting = CountingStore(src_store)
    lazy = zarrlite.open_dataset(counting, lazy=True)
    counting.read_keys.clear()
    target_gm = pkg.GridMapping.regular(
        size=(32, 32), xy_min=(500100.0, 5000100.0), xy_res=100.0,
        crs="epsg:32632", tile_size=16,
    )
    return src_store, counting, lazy, target_gm


def test_stream_lazy_source_reads_a_fraction_of_the_chunks():
    """tests/test_stream.py:58: a chunk-lazy source (zarrlite.LazyArray
    variables, the port's numpy route) and a corner target: fewer than 16
    of the 64 source chunks read, no more than JAX's stream reads, the
    stores equal JAX's."""
    ref_src, ref_counting, ref_lazy, ref_gm = _lazy_case(jz, jx)
    src, counting, lazy, gm = _lazy_case(pz, pt)
    assert sorted(src) == sorted(ref_src) and all(src[k] == ref_src[k] for k in src)
    assert isinstance(lazy["band"].data, pz.LazyArray)
    ref_store, store = jz.MemoryStore(), pz.MemoryStore()
    assert jax_resample_to_store(ref_lazy, ref_gm, ref_store, interp_methods=1) == 4
    assert resample_to_store(lazy, gm, store, interp_methods=1, device="cpu") == 4

    def chunks(keys):
        return {k for k in keys if k.startswith("band/") and ".z" not in k}

    read = chunks(counting.read_keys)
    assert 0 < len(read) < 16, f"the stream read {len(read)}/64 source chunks"
    assert read <= chunks(ref_counting.read_keys)
    _assert_same_store(store, ref_store)


def test_stream_tensor_variables_take_the_device_tiers():
    """A tensor source streams through the port's device tiers (K1/K2 or
    K3 on CPU tensors here): every tile written, float32, finite where
    the target covers the source."""
    ds = _to_port(_golden_case(), tensors=True)
    ds["band_1"] = pt.DataArray(ds.band_1.data.float(), dims=ds.band_1.dims,
                                attrs=dict(ds.band_1.attrs))
    store = pz.MemoryStore()
    assert resample_to_store(ds, pt.GridMapping.regular(**TARGET), store,
                             interp_methods=0, device="cpu") == 4
    back = pz.open_dataset(store)
    assert back.band_1.values.dtype == np.float32
    assert np.isfinite(back.band_1.values).any()
