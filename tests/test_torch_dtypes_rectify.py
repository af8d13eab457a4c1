"""``affine_transform_dataset`` and rectify's device and host tiers on the
JAX package's thirteen data dtypes, against it on the CPU.  Inputs and
tolerance classes: ``tests/dtype_cases.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as xrt  # noqa: E402
import xcube_resampling_tpu_torch as port  # noqa: E402
from xcube_resampling_tpu_torch._device import from_numpy  # noqa: E402

from .dtype_cases import DTYPES, data, match, swath_datasets  # noqa: E402


def test_affine_transform_dataset_upscale_keeps_dtypes():
    """``affine_transform_dataset`` (a 2x bilinear upscale, NaN recovery) on
    a variable of each dtype at once: JAX's output dtypes and values."""
    x = {name: data(name, (8, 12), seed=i) for i, name in enumerate(DTYPES)}
    coords = dict(lon=50.0 + 0.1 * np.arange(12) + 0.05, lat=10.0 + 0.1 * np.arange(8) + 0.05)

    def dataset(pkg, wrap):
        return pkg.Dataset(
            {n: pkg.DataArray(wrap(a), dims=("lat", "lon")) for n, a in x.items()},
            coords={k: pkg.DataArray(v, dims=k) for k, v in coords.items()},
        )

    target = dict(size=(24, 16), xy_min=(50.0, 10.0), xy_res=0.05)
    jds, pds = dataset(xrt, jnp.asarray), dataset(port, from_numpy)
    ref = xrt.affine_transform_dataset(
        jds, xrt.GridMapping.regular(**target, crs=xrt.GridMapping.from_dataset(jds).crs),
        interp_methods=1, recover_nans=True)
    got = port.affine_transform_dataset(
        pds, port.GridMapping.regular(**target, crs=port.GridMapping.from_dataset(pds).crs),
        interp_methods=1, recover_nans=True, device="cpu")
    for name in DTYPES:
        match(got[name].data, ref[name].data)


# -- rectify, the numpy-variable gather, the sharded steps -----------------


@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_rectify_tiers_match_jax(path, interp):
    """``rectify_dataset`` on a small OLCI-like swath with a variable of
    every dtype: numpy variables take the host Phase B (K9's ij_map mode:
    taps in float64, bool's too, the dtype kept, integers ``rint``),
    tensors the device Phase B (K7, and the SRW interior for bilinear: its
    dtype rule and the edge values cast into it; bool bilinear raises,
    below), equal to JAX's host and device Phase B on the same data."""
    names = [n for n in DTYPES
             if not (n == "bool" and interp == "bilinear" and path == "device")]
    jds, pds, fill = swath_datasets(names, path)
    ref = xrt.rectify_dataset(jds, interp_methods=interp, **fill)
    got = port.rectify_dataset(pds, interp_methods=interp, device="cpu", **fill)
    for name in names:
        assert isinstance(got[name].data, torch.Tensor)
        match(got[name].data, ref[name].data)


def test_rectify_refusals_match_jax():
    """Where JAX's device Phase B raises, the port raises the same type: a
    bool bilinear gather (jnp's boolean subtract, ``TypeError``) and the
    default integer fill -1 for uint32 and uint64 nearest
    (``jnp.asarray(-1, uint32)``, ``OverflowError``)."""
    jds, pds, _ = swath_datasets(["bool"], "device")
    with pytest.raises(TypeError):
        xrt.rectify_dataset(jds, interp_methods="bilinear")
    with pytest.raises(TypeError):
        port.rectify_dataset(pds, interp_methods="bilinear", device="cpu")
    jds, pds, _ = swath_datasets(["uint32", "uint64"], "device", fill_ints=False)
    with pytest.raises(OverflowError):
        xrt.rectify_dataset(jds, interp_methods="nearest")
    with pytest.raises(OverflowError):
        port.rectify_dataset(pds, interp_methods="nearest", device="cpu")


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_rectify_device_tier_matches_jax_resident(monkeypatch, interp):
    """``rectify_dataset`` under ``XRTPU_PHASEA=device`` (the resident
    Phase B over the device map) with tensors of five dtypes, against
    JAX's resident Phase B (``make_device_var_image_fn_resident``) on the
    map of JAX's device tier, which the port's ladder equals: each dtype's
    rule, bit for bit; integers take the fill 0."""
    from xcube_resampling_tpu import rectify as jax_rectify
    from xcube_resampling_tpu.constants import UV_DELTA
    from xcube_resampling_tpu.ops import rectify_ops as jax_rectify_ops

    names = ["uint16", "int64", "float16", "float64", "uint32"]
    jds, pds, fill = swath_datasets(names, "device")
    jgm = xrt.GridMapping.from_dataset(jds)
    monkeypatch.setenv("XRTPU_PHASEA", "device")
    m = jax_rectify._inverse_ij_map(jgm, jgm.to_regular(tile_size=16), UV_DELTA)
    assert isinstance(m, jax_rectify_ops.DeviceIJMap)
    got = port.rectify_dataset(pds, interp_methods=interp, device="cpu", **fill)
    for name in names:
        fill_value = fill.get("fill_values", {}).get(name, np.nan)
        fn = jax_rectify_ops.make_device_var_image_fn_resident(m, fill_value, interp)
        ref = np.asarray(fn(jds[name].data[None]))[0]
        match(got[name].data, ref)
