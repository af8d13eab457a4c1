#!/usr/bin/env python3
"""Time K3 (the fused direct gather) at the shapes ``chip_smoke.py`` drives.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_fused.py``.  On the EPSG:4326 0.05
deg global source (7200 x 3600) it times ``fused_reproject`` (K3) onto
UTM32N 4096^2 at 150 m and onto EPSG:3035 4096^2 at 1500 m (the global
reproject, a singular warp), nearest and bilinear, three ways: the mean
of 10 warm launches queued behind a sleep on the card (device time; the
host's enqueue is not counted), the median of one launch between two
CUDA events on an idle card (device time and the wrapper's enqueue), and
the kernel's own device time from ``torch.profiler``.  Every output is
checked equal to the plain version's.  Two floors close it: K3 with every
pixel outside the source (its arithmetic and stores, every tap on one
cached source pixel) and a 4096^2 ``Tensor.fill_``.  A copy of this file
in another checkout (``python3 <tree>/tools/tune_fused.py``) times that
checkout's K3, so two trees compare in one call.  Every line carries the
card's name and power limit; the last line is one JSON object with the
times.  It exits nonzero when no CUDA device is visible.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def device_ms(torch, fn, iters=10):
    """Device ms of one warm call: CUDA events around *iters* calls queued
    behind a sleep on the card that outlasts their enqueueing (as
    ``chip_smoke.py`` times), so the host's enqueue time is not counted."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * min(2 * iters * host_s, 1.0)))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def single_ms(torch, fn, iters=10):
    """Median ms between CUDA events around one call, the card idle before
    it: the host's enqueue time of the call is counted."""
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled_ms(torch, fn, iters=10):
    """The K3 kernel's own device ms a call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if "fused_reproject" in evt.key:
            for attr in ("self_device_time_total", "self_cuda_time_total"):
                value = getattr(evt, attr, None)
                if value:
                    us += float(value)
                    break
    return us / 1e3 / iters if us else None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_fused: no CUDA device is visible", file=sys.stderr)
        return 2

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch.ops import reproject_ops as ro

    dev = torch.device("cuda", 0)
    tag = f"[{card_line()}]"
    geo_gm = GridMapping.regular(
        size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05, crs="epsg:4326"
    )
    targets = {
        "utm32n_4096": GridMapping.regular(
            size=(4096, 4096), xy_min=(250000.0, 5200000.0), xy_res=150.0,
            crs="epsg:32632",
        ),
        "global_3035_4096": GridMapping.regular(
            size=(4096, 4096), xy_min=(2000000.0, 1000000.0), xy_res=1500.0,
            crs="epsg:3035",
        ),
    }
    src = torch.from_numpy(
        np.random.default_rng(0).random((1, 3600, 7200), dtype=np.float32)
    ).to(dev)
    results = {}
    for name, tgt in targets.items():
        for interp in ("nearest", "bilinear"):
            fn = ro.make_fused_reproject_fn(geo_gm, tgt, interp, np.nan, dev)
            ref = fn.plain(src)
            got = fn(src)
            if not torch.equal(torch.isnan(got), torch.isnan(ref)) or not torch.equal(
                torch.nan_to_num(got), torch.nan_to_num(ref)
            ):
                raise AssertionError(f"K3 {name} {interp} differs from plain")
            key = f"{name}/{interp}"
            results[key] = device_ms(torch, lambda: fn(src))
            results[f"{key}/single_launch"] = single_ms(torch, lambda: fn(src))
            results[f"{key}/profiler"] = profiled_ms(torch, lambda: fn(src))
            print(
                f"{tag} K3 {name} {interp}: queued {results[key]:.4f} ms; one launch "
                f"between events {results[f'{key}/single_launch']:.4f} ms; profiler "
                f"device time {results[f'{key}/profiler']} ms"
            )
    # floors at 4096^2: K3 with every pixel outside the source (its
    # arithmetic and stores; every tap clamps onto one cached source pixel),
    # and a 4096^2 float32 fill
    fn = ro.make_fused_reproject_fn(geo_gm, targets["utm32n_4096"], "bilinear", np.nan, dev)
    fn.ix_c = torch.full_like(fn.ix_c, -10.0)
    if not torch.isnan(fn(src)).all():
        raise AssertionError("K3 with every pixel outside the source wrote a value")
    results["floor/k3_all_outside"] = device_ms(torch, lambda: fn(src))
    out = torch.empty((4096, 4096), device=dev)
    results["floor/torch_fill"] = device_ms(torch, lambda: out.fill_(1.0))
    print(f"{tag} floors at 4096^2: K3 with every pixel outside the source "
          f"{results['floor/k3_all_outside']:.4f} ms; Tensor.fill_ "
          f"{results['floor/torch_fill']:.4f} ms")
    print(json.dumps({"card": tag[1:-1], "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
