#!/usr/bin/env python3
"""Profile the port's headline reprojection and the BASELINE cells on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/profile_headline.py``.  It prints

1. for the 20480^2 UTM32N -> EPSG:3035 bilinear reproject that
   ``chip_smoke.py`` drives, the first call's host planning, phase by
   phase (coarse geometry, source window, the two gates, ``plan_srw``,
   and ``plan_to_device`` with the kernels' window tables), each timed
   alone with ``time.perf_counter``;

then for that reproject, for the same source onto a 5120^2 EPSG:3035
grid at 120 m (the pre-downscale: K4's downscale form, then K1 and K2), for
BASELINE #3 (the global 0.05 deg EPSG:4326 7200x3600 -> EPSG:3035 4096^2
at 1500 m, a singular warp that runs the exact region mosaic, K16;
bilinear and nearest, and bilinear under ``XRTPU_NO_EXACT_MOSAIC=1``,
K3), and for
the affine route's BASELINE #1 (a 16-band 1024^2 float32 2x bilinear
downscale with mean: K4's downscale form) and BASELINE #2 (a 4-band
4096^2 raster coarsened 4x through an exact affine downscale, mean, first
and mode: the downscale form for mean and first, K4 and K6 for mode), and
for the rectify route's R1 (BASELINE #4: the 1189 x 1890 OLCI-like swath
onto its default grid, nearest: K10, K8, K7), R2 (that swath onto
EPSG:32631 at 250 m, bilinear) and R3 (a 4865 x 4091 granule with 21
float32 bands, bilinear; 3 warm calls and 2 profiled), each under the
default device tier and under ``XRTPU_PHASEA=host`` (at most 5 warm calls
and 2 profiled), as ``chip_smoke.py`` drives them:

2. the first call's time and the wall time of 10 warm
   ``resample_in_space`` calls (median, min, max) and their host time
   (the call returning before the kernels end);
3. the device time per kernel over 5 warm calls from ``torch.profiler``
   (``key_averages``), and the device idle share of a warm call:
   1 - device time / median wall time;
4. the top host functions of 5 warm calls by ``cProfile`` cumulative time;

for R1-R3 under each tier also the warm call's phases one by one
(grid-mapping inference, the target grid, R2's coordinate transform and
pre-downscale, the swath's upload, the tile plan: K10 on the card or the
host's bbox scan, K8, the Phase B plan: from a step lattice of the map
on the card or from the whole map on the host, Phase B on the card), each
synchronised and timed alone; and last, one JSON object with the numbers
above.

Every line carries the card's name and power limit.  It imports nothing
of JAX or of the JAX package and exits nonzero when no CUDA device is
visible.
"""

from __future__ import annotations

import cProfile
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N = 20480
WARM = 10
PROFILED = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _device_us(evt) -> float:
    """A device activity's own time in us (a kernel, copy or memset), under
    either profiler API name.  Host-side operators (``aten::copy_``,
    ``aten::masked_fill_``) report the time of the activities they launch,
    which are counted themselves, and the profiler's own buffer requests
    are no work of the call: both count 0."""
    if str(getattr(evt, "device_type", "")).endswith("CPU") or evt.key == "Activity Buffer Request":
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_headline: no CUDA device is visible", file=sys.stderr)
        return 2

    from xcube_resampling_tpu_torch import (
        DataArray,
        Dataset,
        GridMapping,
        _build,
        resample_in_space,
    )
    from xcube_resampling_tpu_torch.ops.reproject_ops import STEP
    from xcube_resampling_tpu_torch.ops.srw import (
        _coarse_geometry,
        _fields_interp_err,
        _source_window_gm,
        _twopass_slope,
        plan_srw,
        plan_to_device,
    )

    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    print(card)
    _build.load()

    def dataset(gm, data=None, band=False, **variables):
        """A dataset on *gm* holding *data* as ``v``, or *variables*;
        (band, y, x) variables where *band*."""
        coords = dict(gm.to_coords(exclude_bounds=True))
        coords["spatial_ref"] = DataArray(np.array(0), dims=(), attrs=gm.crs.to_cf())
        x_dim, y_dim = gm.xy_dim_names
        dims = ("band", y_dim, x_dim) if band else (y_dim, x_dim)
        if data is not None:
            variables = {"v": data}
        return Dataset(
            {
                name: DataArray(x, dims=dims, attrs=dict(grid_mapping="spatial_ref"))
                for name, x in variables.items()
            },
            coords=coords,
        )

    utm_gm = GridMapping.regular(
        size=(N, N), xy_min=(300000.0, 5200000.0), xy_res=30.0, crs="epsg:32632"
    )
    laea_gm = GridMapping.regular(
        size=(N, N), xy_min=(4050000.0, 2650000.0), xy_res=30.0, crs="epsg:3035"
    )
    src = torch.from_numpy(
        np.random.default_rng(0).random((N, N), dtype=np.float32)
    ).to(dev)
    ds = dataset(utm_gm, src)
    src_gm = GridMapping.from_dataset(ds)

    # -- 1. the first call's planning, phase by phase ------------------------
    phases = {}
    t = time.perf_counter()
    fields = _coarse_geometry(src_gm, laea_gm, STEP)
    phases["coarse_geometry"] = time.perf_counter() - t
    t = time.perf_counter()
    window = _source_window_gm(src_gm, fields, margin=8 + 48)
    phases["source_window"] = time.perf_counter() - t
    t = time.perf_counter()
    gates = (_fields_interp_err(fields), _twopass_slope(fields))
    phases["gates"] = time.perf_counter() - t
    t = time.perf_counter()
    plan = plan_srw(src_gm, laea_gm, step=STEP, fields=fields)
    phases["plan_srw"] = time.perf_counter() - t
    t = time.perf_counter()
    state = plan_to_device(plan, dev)
    torch.cuda.synchronize()
    phases["plan_to_device"] = time.perf_counter() - t
    del state
    print(
        f"{tag} planning phases (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f"; window {None if window is None else window[1]}; "
        f"gates {gates[0]:.4f} px, slope {gates[1]:.4f}"
    )

    def profile_call(what, ds, target_gm, interp, warm=WARM, profiled=PROFILED, **kwargs):
        """Sections 2-4 for one ``resample_in_space`` call; returns their
        numbers."""
        def call():
            return resample_in_space(ds, target_gm=target_gm, interp_methods=interp, **kwargs)

        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        print(f"{tag} {what}: first call {first:.3f} s (planning included)")

        # -- 2. warm wall and host time --------------------------------------
        wall, host = [], []
        for _ in range(warm):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = call()
            host.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
            del out
        wall_ms = [x * 1e3 for x in wall]
        host_ms = [x * 1e3 for x in host]
        med = statistics.median(wall_ms)
        n_pix = (target_gm or GridMapping.from_dataset(ds).to_regular()).size
        n_pix = n_pix[0] * n_pix[1]
        print(
            f"{tag} {what}: warm wall ms over {warm} calls: median {med:.3f}, min "
            f"{min(wall_ms):.3f}, max {max(wall_ms):.3f}; host ms (call returns): "
            f"median {statistics.median(host_ms):.3f}; {n_pix / 1e3 / med:.1f} Mpix/s"
        )

        # -- 3. device time per kernel ---------------------------------------
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                call()
            torch.cuda.synchronize()
        kernels = {}
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0:
                kernels[evt.key] = us / 1e3 / profiled
        device_ms = sum(kernels.values())
        idle = 1.0 - device_ms / med if device_ms else None
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1]):
            print(f"{tag} {what}: device ms per call: {ms:.4f}  {name}")
        print(
            f"{tag} {what}: device ms per call, all kernels: {device_ms:.4f}; idle "
            f"share of the median warm call: "
            + ("not measured (no device time)" if idle is None else f"{idle:.4f}")
        )

        # -- 4. host functions -----------------------------------------------
        pr = cProfile.Profile()
        pr.enable()
        for _ in range(profiled):
            call()
        pr.disable()
        torch.cuda.synchronize()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(15)
        print(f"{tag} {what}: cProfile of {profiled} warm calls, top 15 by cumulative time:")
        print(buf.getvalue().strip())
        return {
            "first_call_s": first,
            "warm_wall_ms": {"median": med, "min": min(wall_ms), "max": max(wall_ms)},
            "warm_host_ms_median": statistics.median(host_ms),
            "device_ms_per_call": kernels,
            "device_idle_share": idle,
        }

    from torch.profiler import ProfilerActivity, profile

    results = {"headline": profile_call("20480^2 UTM32N->EPSG:3035 bilinear", ds, laea_gm,
                                        "bilinear")}
    laea120_gm = GridMapping.regular(
        size=(5120, 5120), xy_min=(4050000.0, 2650000.0), xy_res=120.0, crs="epsg:3035"
    )
    results["predownscale"] = profile_call(
        "20480^2 UTM32N->EPSG:3035 5120^2 at 120 m (pre-downscale) bilinear mean",
        ds, laea120_gm, "bilinear", agg_methods="mean",
    )
    del ds, src
    torch.cuda.empty_cache()
    geo_gm = GridMapping.regular(
        size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05, crs="epsg:4326"
    )
    laea4k_gm = GridMapping.regular(
        size=(4096, 4096), xy_min=(2000000.0, 1000000.0), xy_res=1500.0, crs="epsg:3035"
    )
    geo = torch.from_numpy(
        np.random.default_rng(0).random((3600, 7200), dtype=np.float32)
    ).to(dev)
    ds3 = dataset(geo_gm, geo)
    for interp in ("bilinear", "nearest"):
        results[f"baseline3/{interp}"] = profile_call(
            f"BASELINE #3 4326->EPSG:3035 4096^2 {interp}", ds3, laea4k_gm, interp
        )
    os.environ["XRTPU_NO_EXACT_MOSAIC"] = "1"
    try:
        results["baseline3/bilinear/k3"] = profile_call(
            "BASELINE #3 4326->EPSG:3035 4096^2 bilinear, XRTPU_NO_EXACT_MOSAIC=1 (K3)",
            ds3, laea4k_gm, "bilinear",
        )
    finally:
        del os.environ["XRTPU_NO_EXACT_MOSAIC"]
    del ds3, geo

    def utm(size, res):
        return GridMapping.regular(
            size=(size, size), xy_min=(300000.0, 5200000.0), xy_res=res, crs="epsg:32632"
        )

    gen = torch.Generator(device=dev).manual_seed(0)
    b1 = torch.rand((16, 1024, 1024), generator=gen, device=dev)
    results["baseline1"] = profile_call(
        "BASELINE #1 affine 16x1024^2 -> 16x512^2 bilinear mean",
        dataset(utm(1024, 30.0), b1, band=True), utm(512, 60.0), "bilinear",
        agg_methods="mean",
    )
    del b1
    b2 = {
        "a": torch.rand((4, 4096, 4096), generator=gen, device=dev),
        "b": torch.rand((4, 4096, 4096), generator=gen, device=dev),
        "c": torch.randint(0, 16, (4, 4096, 4096), generator=gen, device=dev,
                           dtype=torch.int32),
    }
    results["baseline2"] = profile_call(
        "BASELINE #2 affine exact 4x of 3 x 4x4096^2: a mean, b first, c mode",
        dataset(utm(4096, 30.0), band=True, **b2), utm(1024, 120.0), {"c": 1},
        agg_methods={"a": "mean", "b": "first", "c": "mode"},
    )

    del b2
    torch.cuda.empty_cache()

    # -- the rectify route ---------------------------------------------------
    from xcube_resampling_tpu_torch import rectify as port_rectify
    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.crs import Transformer
    from xcube_resampling_tpu_torch.ops import rectify_ops
    from xcube_resampling_tpu_torch.utils import _is_equal_crs, normalize_grid_mapping

    def olci_swath(width, height, bands, tile_size=512):
        """chip_smoke.py's OLCI-like swath (tests/sampledata.py's formula),
        its bands made on the card."""
        j = np.arange(height, dtype=np.float64)[:, None]
        i = np.arange(width, dtype=np.float64)[None, :]
        res = 0.0025
        lon = 4.0 + res * (i + 0.12 * j + 2e-5 * j * i)
        lat = 62.0 - res * (j - 0.08 * i + 1.2e-5 * (i - width / 2) ** 2)
        jj = torch.arange(height, dtype=torch.float64, device=dev)[:, None]
        ii = torch.arange(width, dtype=torch.float64, device=dev)[None, :]
        rad = (torch.sin(0.01 * ii) * torch.cos(0.013 * jj) * 50 + 100).float()
        return Dataset(
            {name: DataArray(rad + k if k else rad, dims=("y", "x"))
             for k, name in enumerate(bands)},
            coords={"lon": DataArray(lon, dims=("y", "x")),
                    "lat": DataArray(lat, dims=("y", "x"))},
        ).chunk({"y": tile_size, "x": tile_size})

    class phase_a_tier:
        """XRTPU_PHASEA set to *tier* inside the block."""

        def __init__(self, tier):
            self.tier = tier

        def __enter__(self):
            os.environ["XRTPU_PHASEA"] = self.tier

        def __exit__(self, *exc):
            os.environ.pop("XRTPU_PHASEA", None)

    def rectify_phases(what, ds, target_gm, interp, tier):
        """A warm call's phases under *tier* one by one, each synchronised,
        median of 3: the grid mapping, the swath's coordinates into the
        target CRS and the pre-downscale where the call takes them, the
        swath's upload, the tile plan (K10 on the card, or the host's bbox
        scan), K8, under the device tier its Phase A (JAX's ladder, whose
        map Phase B takes; K10 and K8 are its fallback), the Phase B plan
        (the resident form's from a step lattice of the map, or the host
        map's from the whole map) and Phase B for every band."""
        spans = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            spans.setdefault(name, []).append(time.perf_counter() - t)
            return out

        nan = float("nan")
        for _ in range(3):
            gm = timed("grid_mapping", lambda: GridMapping.from_dataset(ds))
            src = timed("normalize", lambda: normalize_grid_mapping(ds, gm))
            tgt = timed("target_grid", lambda: target_gm or gm.to_regular())
            if not _is_equal_crs(gm, tgt):
                src = timed("crs_transform", lambda: port_rectify._reproject_swath_coords(
                    src, gm, tgt))
                gm = timed("grid_mapping_transformed", lambda: GridMapping.from_dataset(src))
            src, gm = timed("pre_downscale", lambda: port_rectify._maybe_downscale(
                src, gm, tgt, interp, None, False, dev))
            sw = timed("swath_upload", lambda: torch.from_numpy(np.ascontiguousarray(
                np.asarray(gm.xy_coords.data), dtype=np.float64)).to(dev))
            if tier == "device":
                tiles = timed("tile_plan_k10", lambda: port_rectify._phase_a_tiles(gm, tgt, sw))
            else:
                tiles = timed("tile_plan_bbox_scan", lambda: port_rectify._phase_a_tiles(gm, tgt))
            m = timed("k8", lambda: rectify_ops.rectify_phase_a(sw, tiles, UV_DELTA))
            names = [n for n in src.data_vars]
            x = src[names[0]].data
            if tier == "device":
                # the device tier's Phase A itself: JAX's ladder (its own
                # upload; K10 and K8 above are its fallback, timed beside it)
                resident = timed("phase_a_ladder", lambda: port_rectify._inverse_ij_map(
                    gm, tgt, UV_DELTA, dev))

                def lattice_plan():
                    fn = rectify_ops.make_device_var_image_fn_resident(resident, nan, interp)
                    fn.impl(tuple(x.shape))
                    return fn

                fn = timed("phase_b_plan_lattice", lattice_plan)
                form = type(fn.impl(tuple(x.shape))).__name__
            else:
                fn = timed("phase_b_plan_full_map", lambda: rectify_ops.make_device_var_image_fn(
                    m, tuple(x.shape), nan, interp, device=dev))
                form = type(fn).__name__
            timed("phase_b_all_bands", lambda: [fn(src[n].data[None]) for n in names])
        med = {k: statistics.median(v) * 1e3 for k, v in spans.items()}
        print(f"{tag} {what}, XRTPU_PHASEA={tier}: warm phases (ms, median of 3; Phase B "
              f"{form}): " + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
        return med

    ds_r1 = olci_swath(1189, 1890, ("rad",))
    fwd = Transformer.from_crs("EPSG:4326", "EPSG:32631", always_xy=True)
    tx, ty = fwd.transform(np.asarray(ds_r1["lon"].data), np.asarray(ds_r1["lat"].data))
    x0, y0 = float(np.floor(tx.min() / 250) * 250), float(np.floor(ty.min() / 250) * 250)
    r2_tgt = GridMapping.regular(
        size=(int(np.ceil((tx.max() - x0) / 250)) + 1, int(np.ceil((ty.max() - y0) / 250)) + 1),
        xy_min=(x0, y0), xy_res=250.0, crs="EPSG:32631", tile_size=512,
    )
    ds_r3 = olci_swath(4865, 4091, tuple(f"Oa{k + 1:02d}_radiance" for k in range(21)))
    r3_tgt = GridMapping.from_dataset(ds_r3).to_regular(tile_size=1024)
    cells = (
        ("r1", "R1 (BASELINE #4) rectify 1189x1890 swath nearest", ds_r1, None, "nearest", 0,
         WARM, PROFILED),
        ("r2", "R2 rectify the R1 swath -> EPSG:32631 250 m bilinear", ds_r1, r2_tgt,
         "bilinear", "bilinear", WARM, PROFILED),
        ("r3", "R3 rectify 4865x4091 granule, 21 bands, bilinear", ds_r3, r3_tgt, "bilinear",
         "bilinear", 3, 2),
    )
    for tier in ("device", "host"):
        with phase_a_tier(tier):
            for key, what, ds_c, tgt_c, interp, interp_arg, warm, profiled in cells:
                if tier == "host":
                    key, warm, profiled = f"{key}/host", min(warm, 5), min(profiled, 2)
                results[key] = profile_call(f"{what}, XRTPU_PHASEA={tier}", ds_c, tgt_c,
                                            interp_arg, warm=warm, profiled=profiled)
                results[key]["phases_ms"] = rectify_phases(what, ds_c, tgt_c, interp, tier)

    print(
        json.dumps(
            {
                "card": card,
                "planning_s": phases,
                **results,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
