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
cached source pixel) and a 4096^2 ``Tensor.fill_``.  With ``--against
TREE`` it builds TREE's ``csrc/fused_reproject.cu`` (e.g. an unpacked
parent) into a library of its own under ``build/tune_fused/`` and times
its K3 through its C entry beside this tree's, each output checked equal.

``--band`` times K3's band form instead, at BASELINE #5's gate: the
global source onto EPSG:3035 4096^2 through the sharded regrid over a
mesh of four entries on the card; band 1 (ext 1103 x 3811 -> 1024 x 4096)
and band 0 (its offset negative), for every method: this tree's wrapper,
its kernel built once per entry of ``BAND_BUILDS`` (the band kernel's
threads down a block and its blocks an SM), TREE's band form (``--against``)
and, for bilinear and nearest, one ``F.grid_sample`` at the same
positions (border padding, corners aligned: no mask, no fill), with the
registers ptxas gave each build; every output is checked equal to the
plain version's.  Every line carries the card's name and power limit; the
last line is one JSON object with the times.  It exits nonzero when no
CUDA device is visible.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the band kernel's constants (csrc/fused_reproject.cu); the first is the
# source as it stands
BAND_BUILDS = (
    ("lanes1 blocks16", {}),
    ("lanes1 blocks24", {"kBandBlocks": 24}),
    ("lanes1 blocks12", {"kBandBlocks": 12}),
    ("lanes2 blocks12", {"kBandLanes": 2, "kBandBlocks": 12}),
)


def build_libs(jobs, out_dir: Path):
    """(name, library, ptxas log) of each (name, source text or path,
    include dir) in *jobs*, every nvcc started together."""
    from xcube_resampling_tpu_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, source, include in jobs:
        stem = re.sub(r"[^A-Za-z0-9]+", "_", name)
        if isinstance(source, str):
            cu = out_dir / f"{stem}.cu"
            cu.write_text(source)
        else:
            cu = source
        lib = out_dir / f"{stem}.so"
        procs.append((name, lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{include}", "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for name, lib, proc in procs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-20000:]}")
        library = ctypes.CDLL(str(lib))
        for entry in ("xrt_fused_reproject_f32", "xrt_fused_reproject_band_f32"):
            getattr(library, entry).argtypes = _build._SIGNATURES[entry]
        out.append((name, library, log))
    return out


def registers(log: str, pattern: str) -> str:
    """Registers and spills of the kernels whose mangled name holds
    *pattern*, from a ptxas report."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        if pattern in name:
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            m = re.search(r"ILi(\d)E", name)
            out.append(f"method {m.group(1) if m else '?'}: {regs.group(1) if regs else '?'} "
                       f"regs, {spill.group(1) if spill else 0} B spilled")
    return "; ".join(out)


def equal(a, b) -> bool:
    import torch

    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


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


def band_main(torch, dev, tag, against) -> dict:
    """--band: K3's band form at BASELINE #5's gate, band 1 and band 0."""
    import torch.nn.functional as F

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch import _build
    from xcube_resampling_tpu_torch.ops import reproject_ops as ro
    from xcube_resampling_tpu_torch.parallel import make_mesh, make_sharded_regrid_step
    from xcube_resampling_tpu_torch.parallel.halo import crop_source

    text = (_build.CSRC / "fused_reproject.cu").read_text()
    jobs = []
    for name, constants in BAND_BUILDS:
        t = text
        for const, value in constants.items():
            t, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};", t)
            if n != 1:
                raise ValueError(f"fused_reproject.cu defines no {const}")
        jobs.append((name, t, _build.CSRC))
    if against is not None:
        csrc = against / "xcube_resampling_tpu_torch" / "csrc"
        jobs.append((f"against {against.name}", csrc / "fused_reproject.cu", csrc))
    t0 = time.perf_counter()
    libs = build_libs(jobs, ROOT / "build" / "tune_fused")
    print(f"{tag} {len(libs)} builds in {time.perf_counter() - t0:.1f} s")
    for name, _, log in libs:
        print(f"{tag} {name}: {registers(log, 'fused_reproject_band_kernel')}")
    geo = GridMapping.regular(size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05,
                              crs="epsg:4326")
    laea = GridMapping.regular(size=(4096, 4096), xy_min=(2000000.0, 1000000.0),
                               xy_res=1500.0, crs="epsg:3035")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((3600, 7200), generator=gen, device=dev)
    xc, geo_c = crop_source(x, geo, laea)
    step, (pad, _) = make_sharded_regrid_step(make_mesh(devices=[dev] * 4), geo_c, laea)
    bands, _ = step.bands(F.pad(xc, (0, 0, 0, pad), value=float("nan")))
    halos = step.exchange(bands)
    results = {}
    for k in (1, 0):
        g = list(step.gather_args(bands, halos, k))
        ext = g[0].reshape((-1,) + tuple(g[0].shape[-2:]))
        g[0] = ext
        batch, ext_h, src_w = ext.shape
        ix_c, iy_c, st, out_h, out_w = g[1], g[2], g[3], g[4], g[5]
        row0, off, src_h = g[8], g[9], g[10]
        for method in ("bilinear", "nearest", "triangular"):
            g[6] = method
            ref = ro.fused_reproject_band_plain(*g)
            got = ro.fused_reproject_band(*g)
            if not equal(got, ref):
                raise AssertionError(f"K3's band form differs from plain at band {k} {method}")
            what = f"band {k} (ext {tuple(ext.shape)} -> {tuple(ref.shape)}, off {off}) {method}"
            key = f"band{k}/{method}"
            results[key] = device_ms(torch, lambda: ro.fused_reproject_band(*g))
            line = [f"wrapper {results[key]:.4f}"]
            out = torch.empty_like(ref)
            for name, lib, _ in libs:
                def call(lib=lib, name=name):
                    rc = lib.xrt_fused_reproject_band_f32(
                        ext.data_ptr(), ix_c.data_ptr(), iy_c.data_ptr(), out.data_ptr(), batch,
                        ext_h, src_w, ix_c.shape[0], ix_c.shape[1], out_h, out_w, st,
                        ro.METHODS[method], float("nan"), row0, off, src_h,
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed ({rc})")

                out.fill_(-7.0)
                call()
                torch.cuda.synchronize()
                if not equal(out, ref):
                    raise AssertionError(f"{name} differs from plain at {what}")
                results[f"{key}/{name}"] = device_ms(torch, call)
                line.append(f"{name} {results[f'{key}/{name}']:.4f}")
            if method != "triangular" and k == 1:
                rows = torch.arange(row0, row0 + out_h, dtype=torch.float32, device=dev)[:, None]
                cols = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
                ix = ro.interp_field(ix_c, rows, cols, st)
                iy = ro.interp_field(iy_c, rows, cols, st).clamp(0, src_h - 1) - off
                grid = torch.stack((ix / (src_w - 1) * 2 - 1, iy / (ext_h - 1) * 2 - 1),
                                   dim=-1)[None]
                del ix, iy

                def lib_call():
                    return F.grid_sample(ext[None], grid, mode=method, padding_mode="border",
                                         align_corners=True)

                results[f"{key}/grid_sample"] = device_ms(torch, lib_call)
                line.append(f"F.grid_sample {results[f'{key}/grid_sample']:.4f}")
            print(f"{tag} K3's band form {what}: device ms " + ", ".join(line))
    return results


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--band", action="store_true", help="time K3's band form")
    parser.add_argument("--against", type=Path, default=None,
                        help="another checkout whose K3 is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_fused: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.band:
        dev = torch.device("cuda", 0)
        tag = f"[{card_line()}]"
        print(json.dumps({"card": tag[1:-1], "ms": band_main(torch, dev, tag, args.against)}))
        return 0
    other = None
    if args.against is not None:
        csrc = args.against / "xcube_resampling_tpu_torch" / "csrc"
        other = build_libs([(f"against {args.against.name}", csrc / "fused_reproject.cu", csrc)],
                           ROOT / "build" / "tune_fused")[0][1]

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
            if other is not None:
                out = torch.empty_like(got)

                def call():
                    rc = other.xrt_fused_reproject_f32(
                        src.data_ptr(), fn.ix_c.data_ptr(), fn.iy_c.data_ptr(), out.data_ptr(),
                        1, 3600, 7200, fn.ix_c.shape[0], fn.ix_c.shape[1], fn.out_h, fn.out_w,
                        fn.step, ro.METHODS[interp], float("nan"),
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"the other tree's K3 failed ({rc})")

                call()
                torch.cuda.synchronize()
                if not equal(out, got):
                    raise AssertionError(f"the other tree's K3 differs at {name} {interp}")
                results[f"{key}/against"] = device_ms(torch, call)
                print(f"{tag} K3 {name} {interp}: {args.against.name}'s K3 queued "
                      f"{results[f'{key}/against']:.4f} ms (this tree's {results[key]:.4f})")
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
