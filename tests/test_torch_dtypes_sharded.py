"""The sharded steps on the JAX package's data dtypes, against its steps
on its 8-device CPU mesh: the SRW and regrid steps, ``sharded_rectify``,
``sharded_reproject`` and the ESW step.  Inputs and tolerance classes:
``tests/dtype_cases.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as xrt  # noqa: E402
import xcube_resampling_tpu_torch as port  # noqa: E402
from xcube_resampling_tpu.parallel import halo as jax_halo  # noqa: E402
from xcube_resampling_tpu_torch import parallel as ppar  # noqa: E402
from xcube_resampling_tpu_torch._device import from_numpy  # noqa: E402

from .dtype_cases import data, gms, match  # noqa: E402
from .sampledata import create_olci_like_swath  # noqa: E402


@pytest.mark.parametrize("dtype", ["uint32", "uint64", "int16", "float16"])
def test_sharded_srw_and_regrid_steps_match_jax(dtype):
    """The sharded SRW step (K1's and K2's band forms: the tiled SRW's
    promotion) and the sharded regrid step (K3's band form: gather_interp's
    rule, nearest keeping the dtype) over 3 mesh entries, against JAX's
    steps on its 8-device CPU mesh, bit for bit."""
    jsg, jtg = gms(xrt)
    psg, ptg = gms(port)
    x = data(dtype, (2, 96, 96), nan=False)
    jmesh = xrt.parallel.make_mesh(("bands",), devices=jax.devices()[:3])
    pmesh = ppar.make_mesh(devices=[torch.device("cpu")] * 3)
    for make, interp in ((ppar.make_sharded_srw_step, "bilinear"),
                         (ppar.make_sharded_regrid_step, "nearest")):
        jmake = getattr(jax_halo, make.__name__)
        jb = jmake(jmesh, jsg, jtg, interp_method=interp, src_batch_dims=1, fill_value=0)
        pb = make(pmesh, psg, ptg, interp_method=interp, src_batch_dims=1, fill_value=0)
        assert jb[1] == pb[1]
        (pad, out_h) = pb[1]
        jsrc = jnp.pad(jnp.asarray(x), ((0, 0), (0, pad), (0, 0)))
        ref = np.asarray(jb[0](jsrc))[..., :out_h, :]
        src = torch.cat([from_numpy(x), torch.zeros((2, pad, 96), dtype=from_numpy(x).dtype)],
                        dim=1)
        got = pb[0](src).full()
        match(got, ref)


def _swath_map():
    """The OLCI-like swath of ``tests/test_torch_sharded_rectify.py``
    onto its default grid, and JAX's host map: both packages' grid
    mappings."""
    from xcube_resampling_tpu.constants import UV_DELTA
    from xcube_resampling_tpu.rectify import _compute_target_source_ij
    from xcube_resampling_tpu_torch import entry as pentry

    ds = create_olci_like_swath(width=96, height=120, tile_size=48)
    jsrc = xrt.GridMapping.from_dataset(ds)
    jtgt = jsrc.to_regular(tile_size=48)
    ij_map = _compute_target_source_ij(jsrc, jtgt, UV_DELTA)
    if hasattr(ij_map, "as_numpy"):
        ij_map = ij_map.as_numpy()
    psrc = port.GridMapping.from_dataset(
        pentry.create_olci_like_swath(width=96, height=120, tile_size=48))
    return (jsrc, jtgt), (psrc, psrc.to_regular(tile_size=48)), np.asarray(ij_map)


@pytest.mark.parametrize("dtype, method", [("uint32", "nearest"), ("uint64", "nearest"),
                                           ("float16", "bilinear"), ("int64", "bilinear"),
                                           ("float64", "triangular")])
def test_sharded_rectify_matches_jax(dtype, method):
    """``sharded_rectify`` (K7's band form on each band after the halo
    exchange) with the same host map over 4 mesh entries: JAX's
    ``gather_interp`` rule per dtype (nearest keeps it; integer tap
    differences wrap, float16's round; float64 stays float64), equal to
    JAX's bit for bit; integers take the fill 0."""
    (jsrc, jtgt), (psrc, ptgt), ij_map = _swath_map()
    x = data(dtype, (2, 120, 96), nan=False)
    fill = np.nan if dtype.startswith("float") else 0
    ref = np.asarray(xrt.parallel.sharded_rectify(
        jnp.asarray(x), jsrc, jtgt, xrt.parallel.make_mesh(("bands",), devices=jax.devices()[:4]),
        interp_method=method, ij_map=ij_map, fill_value=fill))
    got = ppar.sharded_rectify(from_numpy(x), psrc, ptgt,
                               ppar.make_mesh(devices=[torch.device("cpu")] * 4),
                               interp_method=method, ij_map=ij_map, fill_value=fill).full()
    match(got, ref)


@pytest.mark.parametrize("dtype", ["uint16", "bool"])
def test_sharded_reproject_matches_jax(dtype):
    """``sharded_reproject`` end to end (the crop, the padding with the
    fill cast as ``jnp.pad`` casts it, the sharded SRW) over 4 mesh
    entries, nearest: equal to JAX's, float32 out (the tiled SRW's
    promotion)."""
    jsg, jtg = gms(xrt)
    psg, ptg = gms(port)
    x = data(dtype, (2, 96, 96), nan=False)
    ref = np.asarray(xrt.parallel.sharded_reproject(
        jnp.asarray(x), jsg, jtg, xrt.parallel.make_mesh(("bands",), devices=jax.devices()[:4]),
        interp_method="nearest"))
    got = ppar.sharded_reproject(from_numpy(x), psg, ptg,
                                 ppar.make_mesh(devices=[torch.device("cpu")] * 4),
                                 interp_method="nearest").full()
    match(got, ref)


@pytest.mark.parametrize("dtype", ["int16", "float64"])
def test_sharded_esw_step_matches_jax(dtype):
    """The sharded ESW step (K13's band form) past the two-pass gate on
    ``tests/test_torch_esw_sharded.py``'s geometry over 2 mesh entries:
    the band cast to float32 as JAX's step casts it, float32 out, equal
    to JAX's bit for bit."""
    src = dict(size=(64, 48), xy_min=(-70.0, 60.0), xy_res=0.5, crs="epsg:4326")
    tgt = dict(size=(48, 48), xy_min=(-1027500.0, -2661000.0), xy_res=30000.0,
               crs="epsg:3413")
    jb = jax_halo.make_sharded_esw_step(
        xrt.parallel.make_mesh(("bands",), devices=jax.devices()[:2]),
        xrt.GridMapping.regular(**src), xrt.GridMapping.regular(**tgt), src_batch_dims=1)
    pb = ppar.make_sharded_esw_step(
        ppar.make_mesh(devices=[torch.device("cpu")] * 2), port.GridMapping.regular(**src),
        port.GridMapping.regular(**tgt), src_batch_dims=1)
    (pad, out_h) = pb[1]
    assert jb[1] == pb[1]
    x = data(dtype, (2, 48, 64), nan=False)
    ref = np.asarray(jb[0](jnp.pad(jnp.asarray(x), ((0, 0), (0, pad), (0, 0)))))[..., :out_h, :]
    got = pb[0](from_numpy(np.pad(x, ((0, 0), (0, pad), (0, 0))))).full()
    match(got, ref)
