"""The multi-device dry run: every sharded step of the port once, at tiny
shapes, over a mesh of n entries.

Counterpart of ``__graft_entry__.dryrun_multichip``: the sharded SRW
(bilinear and triangular), the sharded exact separable warp
(``make_sharded_esw_step``) past the two-pass gate, the sharded regrid,
then rectify with both phases on the mesh
(:func:`.parallel.sharded_phase_a`, then :func:`.parallel.sharded_rectify`
through its map) on a small OLCI-like swath.  It runs on the card by
default: ``python -c "from xcube_resampling_tpu_torch.entry import
dryrun_multichip; dryrun_multichip(4)"``; pass
``devices=[torch.device("cpu")] * n`` to run it on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .crs import Transformer
from .gridmapping import GridMapping
from .xrlite import DataArray, Dataset


def flagship_gms(size: int = 512, out: int = 512) -> tuple[GridMapping, GridMapping]:
    """A UTM32N 100 m source of size^2 and an EPSG:3035 110 m target of
    out^2 centred on it (``__graft_entry__._flagship_gms``)."""
    source_gm = GridMapping.regular(
        size=(size, size), xy_min=(500000.0, 5880000.0), xy_res=100.0, crs="epsg:32632"
    )
    cx = 500000.0 + size * 100.0 / 2
    cy = 5880000.0 + size * 100.0 / 2
    tcx, tcy = Transformer.from_crs(source_gm.crs, "epsg:3035").transform(cx, cy)
    res = 110.0
    target_gm = GridMapping.regular(
        size=(out, out), xy_min=(tcx - out * res / 2, tcy - out * res / 2), xy_res=res,
        crs="epsg:3035",
    )
    return source_gm, target_gm


def create_olci_like_swath(width=1189, height=1890, tile_size=512, dtype=np.float32) -> Dataset:
    """A synthetic Sentinel-3 OLCI-like swath: 2D lon/lat with along- and
    across-track curvature at about 0.0025 deg, and one radiance variable
    (a copy of ``tests/sampledata.py:create_olci_like_swath``)."""
    j = np.arange(height, dtype=np.float64)[:, np.newaxis]
    i = np.arange(width, dtype=np.float64)[np.newaxis, :]
    res = 0.0025
    lon = 4.0 + res * (i + 0.12 * j + 2e-5 * j * i)
    lat = 62.0 - res * (j - 0.08 * i + 1.2e-5 * (i - width / 2) ** 2)
    rad = (np.sin(0.01 * i) * np.cos(0.013 * j) * 50 + 100).astype(dtype)
    ds = Dataset(
        dict(rad=DataArray(rad, dims=("y", "x"))),
        coords=dict(
            lon=DataArray(lon.astype(np.float64), dims=("y", "x")),
            lat=DataArray(lat.astype(np.float64), dims=("y", "x")),
        ),
    )
    return ds.chunk({"y": tile_size, "x": tile_size})


def _default_devices(n: int) -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dryrun_multichip: no CUDA device is visible; pass devices= "
            "(e.g. [torch.device('cpu')] * n) to run it elsewhere"
        )
    count = torch.cuda.device_count()
    if count >= n:
        return [torch.device("cuda", k) for k in range(n)]
    return [torch.device("cuda", 0)] * n


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One step of each sharded path over a mesh of *n_devices* entries:
    *devices*, by default the first n CUDA devices, or the first CUDA
    device n times where there are fewer.  Raises where a step fails or
    gives no finite output."""
    from .parallel import (
        make_mesh,
        make_sharded_esw_step,
        make_sharded_regrid_step,
        sharded_phase_a,
        sharded_rectify,
        sharded_reproject,
    )

    devices = _default_devices(n_devices) if devices is None else list(devices)
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for a mesh of {n_devices}")
    mesh = make_mesh(("bands",), devices=devices)
    dev = mesh.devices[0]

    source_gm, target_gm = flagship_gms(size=16 * n_devices, out=16 * n_devices)
    rng = np.random.default_rng(0)
    src = torch.from_numpy(
        rng.random((2, source_gm.height, source_gm.width), dtype=np.float32)
    ).to(dev)
    for method in ("bilinear", "triangular"):
        out = sharded_reproject(src, source_gm, target_gm, mesh, interp_method=method).full()
        _check(out, (2, target_gm.height, target_gm.width), f"sharded_reproject {method}")

    step_fn, (src_pad_h, out_h) = make_sharded_regrid_step(mesh, source_gm, target_gm)
    src1 = torch.nn.functional.pad(src[0], (0, 0, 0, src_pad_h), value=float("nan"))
    _check(step_fn(src1).full(), (out_h, target_gm.width), "the sharded regrid")

    # past the two-pass gate: a geographic grid over Greenland onto a
    # polar stereographic grid, through the sharded ESW
    geo_gm = GridMapping.regular(
        size=(8 * n_devices, 6 * n_devices), xy_min=(-70.0, 60.0), xy_res=4.0 / n_devices,
        crs="epsg:4326",
    )
    cx, cy = Transformer.from_crs("epsg:4326", "epsg:3413").transform(-54.0, 72.0)
    polar_gm = GridMapping.regular(
        size=(6 * n_devices, 6 * n_devices), xy_min=(cx - 720000.0, cy - 720000.0),
        xy_res=240000.0 / n_devices, crs="epsg:3413",
    )
    built = make_sharded_esw_step(mesh, geo_gm, polar_gm, src_batch_dims=1)
    if built is None:
        raise RuntimeError("dryrun_multichip: the sharded ESW refused its geometry")
    esw_fn, (esw_pad, esw_h) = built
    geo_src = torch.from_numpy(
        rng.random((2, geo_gm.height + esw_pad, geo_gm.width), dtype=np.float32)
    ).to(dev)
    _check(esw_fn(geo_src).full(), (2, esw_h, polar_gm.width), "the sharded ESW")

    swath = create_olci_like_swath(
        width=8 * n_devices, height=8 * n_devices, tile_size=8 * n_devices
    )
    swath_gm = GridMapping.from_dataset(swath)
    swath_target = swath_gm.to_regular()
    bands = torch.from_numpy(
        np.random.default_rng(1).random((2, swath_gm.height, swath_gm.width), dtype=np.float32)
    ).to(dev)
    ij_map = sharded_phase_a(mesh, swath_gm, swath_target)
    if ij_map is None:
        raise RuntimeError("dryrun_multichip: the sharded Phase A refused the swath")
    out3 = sharded_rectify(
        bands, swath_gm, swath_target, mesh, interp_method="bilinear", ij_map=ij_map
    ).full()
    _check(out3, (2, swath_target.height, swath_target.width), "sharded_rectify")


def _check(out: torch.Tensor, shape: tuple[int, ...], what: str) -> None:
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).any()):
        raise RuntimeError(f"dryrun_multichip: {what} gave {tuple(out.shape)}, expected "
                           f"{shape} with finite values")
