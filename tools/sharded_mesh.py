#!/usr/bin/env python3
"""Time BASELINE #5's sharded reproject and the sharded rectify over every
card against one card.

Run from the repository root on a machine with several CUDA devices:
``python3 tools/sharded_mesh.py [reproject] [rectify]`` (both by default).
``reproject`` builds ``make_sharded_srw_step`` for
the headline's geometry (20480^2 UTM32N 30 m -> EPSG:3035 30 m, bilinear,
4 float32 bands made on card 0 from a seed) over two meshes of as many
entries as there are cards: (a) one entry a card, (b) every entry on
card 0.  For each it prints the first call of ``sharded_reproject``
(planning included), the planned step's warm calls (median of 5) from the
global source on card 0 (on (a) the bands' copies to their cards count)
and from a ``Sharded`` of the bands already on their cards (the halo
exchange and the band kernels alone), and the peak device memory of a
step call on each card, and it holds (a) to (b) bit for bit.
``rectify`` does the same for ``sharded_rectify`` at R3 (the 4865 x 4091
OLCI-like granule onto its 1024-tiled grid, 21 float32 bands made on card
0, bilinear): the first call and the warm calls of ``sharded_rectify``
without a map (the sharded Phase A, K11 and K12 on every band, then K7's
band form), and of the step alone over the sharded Phase A's map; it
holds (a)'s raster and map to (b)'s bit for bit.  It then traces one warm
``sharded_rectify`` on each mesh with ``torch.profiler`` and prints where
its time goes: the call's wall, each card's busy time, the device time of
the hybrid seed (K11), the dense kernel (K12), K7's band form, host to
card copies, card to card copies, card to host copies and the other device
work, and cProfile's host functions of the same call.  It prints the
cards' names and power limits first and exits nonzero where a check
fails.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N = 20480
BANDS = 4
# R3: the OLCI EFR-sized granule (width, height), its bands, its tiles
R3 = (4865, 4091)
R3_BANDS = 21
R3_TILE = 1024


def main() -> int:
    import torch

    parts = sys.argv[1:] or ["reproject", "rectify"]
    if set(parts) - {"reproject", "rectify"}:
        print(f"sharded_mesh: unknown parts {parts}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sharded_mesh: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    cards = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def median_ms(call):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = call()
            sync()
            times.append(time.perf_counter() - t0)
            del out
        return statistics.median(times) * 1e3

    if "reproject" in parts:
        reproject(cards, sync, median_ms)
    if "rectify" in parts:
        rectify(cards, sync, median_ms)
    return 0


def meshes(cards):
    """(label, devices) of the two meshes: one entry a card, and as many
    entries on card 0."""
    home = cards[0]
    return (("one entry a card", cards), (f"every entry on {home}", [home] * len(cards)))


def equal(a, b, what):
    import torch

    for k, (p, q) in enumerate(zip(a, b)):
        if not torch.equal(torch.isnan(p), torch.isnan(q)) or not torch.equal(
                p.nan_to_num(0.0), q.nan_to_num(0.0)):
            raise SystemExit(f"{what}: band {k} differs between the two meshes")
    print(f"{what}: the two meshes' bands equal bit for bit ({len(a)} bands)")


def reproject(cards, sync, median_ms):
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch._device import LAUNCHES
    from xcube_resampling_tpu_torch.parallel import (
        Sharded,
        make_mesh,
        make_sharded_srw_step,
        sharded_reproject,
    )

    home = cards[0]
    utm = GridMapping.regular(size=(N, N), xy_min=(300000.0, 5200000.0), xy_res=30.0,
                              crs="epsg:32632")
    laea = GridMapping.regular(size=(N, N), xy_min=(4050000.0, 2650000.0), xy_res=30.0,
                               crs="epsg:3035")
    gen = torch.Generator(device=home).manual_seed(0)
    x = torch.rand((BANDS, N, N), generator=gen, device=home)
    results = {}
    for label, devices in meshes(cards):
        mesh = make_mesh(devices=devices)
        t0 = time.perf_counter()
        out = sharded_reproject(x, utm, laea, mesh)
        sync()
        first = time.perf_counter() - t0
        del out
        step, (pad, _) = make_sharded_srw_step(mesh, utm, laea, src_batch_dims=1)
        if pad:
            raise SystemExit(f"{N} rows do not divide into {mesh.size} bands")
        warm = median_ms(lambda: step(x))
        bands, _ = step.bands(x)
        placed = Sharded(bands, N)
        sync()
        warm_placed = median_ms(lambda: step(placed))
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)
        LAUNCHES.clear()
        out = step(x)
        sync()
        peaks = {str(d): round(torch.cuda.max_memory_allocated(d) / 2**30, 3)
                 for d in set(devices)}
        launches = dict(LAUNCHES)
        results[label] = [b.to(home) for b in out.bands]
        del out, bands, placed, step
        mpix = BANDS * N * N / 1e6
        print(f"{N}^2 x {BANDS} bands over {mesh.size} entries, {label}: sharded_reproject "
              f"first call {first:.3f} s; the planned step warm, median of 5: from the "
              f"source on {home} {warm:.2f} ms = {mpix / warm * 1e3:.1f} Mpix/s, from "
              f"the bands already placed {warm_placed:.2f} ms = "
              f"{mpix / warm_placed * 1e3:.1f} Mpix/s; peak device memory of a step call "
              f"(GiB) {peaks}; launches {launches}")
    equal(*results.values(), "sharded_reproject")


# the device activities of a sharded_rectify call, by what they do
TRACE_GROUPS = (
    ("K11 hybrid_seed", ("seed_",)),
    ("K12 hybrid_dense", ("hybrid_dense",)),
    ("K7 ij_gather_band", ("ij_gather",)),
    ("host to card copies", ("Memcpy HtoD",)),
    ("card to card copies", ("Memcpy PtoP", "Memcpy DtoD")),
    ("card to host copies", ("Memcpy DtoH",)),
)


def trace(label, call, sync):
    """One warm *call* under ``torch.profiler`` (and, apart, cProfile):
    its wall, each card's busy time and the device time by
    :data:`TRACE_GROUPS`."""
    import cProfile
    import io
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = call()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    del out
    groups: dict[str, float] = {}
    busy: dict[int, float] = {}
    names: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        busy[evt.device_index] = busy.get(evt.device_index, 0.0) + ms
        names[evt.name] = names.get(evt.name, 0.0) + ms
        group = next((g for g, keys in TRACE_GROUPS if any(k in evt.name for k in keys)),
                     "other device work")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"trace, {label}: one warm sharded_rectify, wall under the profiler {wall:.2f} ms; "
          f"busy ms per card {({k: round(v, 3) for k, v in sorted(busy.items())})}")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"trace, {label}: {group}: {ms:.3f} ms of device time, all cards")
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"trace, {label}: device ms {ms:.3f}  {name[:100]}")
    pr = cProfile.Profile()
    pr.enable()
    out = call()
    sync()
    pr.disable()
    del out
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(18)
    print(f"trace, {label}: cProfile of one warm call, top 18 by cumulative time:")
    print(buf.getvalue().strip())


def rectify(cards, sync, median_ms):
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch._device import LAUNCHES
    from xcube_resampling_tpu_torch.entry import create_olci_like_swath
    from xcube_resampling_tpu_torch.parallel import (
        make_mesh,
        make_sharded_rectify_step,
        sharded_phase_a,
        sharded_rectify,
    )

    home = cards[0]
    width, height = R3
    ds = create_olci_like_swath(width, height, tile_size=R3_TILE)
    gm = GridMapping.from_dataset(ds)
    tgt = gm.to_regular(tile_size=R3_TILE)
    # the swath's radiance formula, made on card 0, band k offset by k
    jj = torch.arange(height, dtype=torch.float64, device=home)[:, None]
    ii = torch.arange(width, dtype=torch.float64, device=home)[None, :]
    rad = (torch.sin(0.01 * ii) * torch.cos(0.013 * jj) * 50 + 100).float()
    x = torch.stack([rad + k for k in range(R3_BANDS)])
    del ds, jj, ii, rad
    rasters, maps = {}, {}
    for label, devices in meshes(cards):
        mesh = make_mesh(devices=devices)
        t0 = time.perf_counter()
        out = sharded_rectify(x, gm, tgt, mesh, interp_method="bilinear")
        sync()
        first = time.perf_counter() - t0
        del out
        warm = median_ms(lambda: sharded_rectify(x, gm, tgt, mesh, interp_method="bilinear"))
        phase_a = median_ms(lambda: sharded_phase_a(mesh, gm, tgt))
        ij_map = sharded_phase_a(mesh, gm, tgt)
        step, (pad, _) = make_sharded_rectify_step(mesh, ij_map, (height, width),
                                                   interp_method="bilinear", src_batch_dims=1)
        xp = torch.nn.functional.pad(x, (0, 0, 0, pad), value=float("nan"))
        step_ms = median_ms(lambda: step(xp))
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)
        LAUNCHES.clear()
        out = sharded_rectify(x, gm, tgt, mesh, interp_method="bilinear")
        sync()
        peaks = {str(d): round(torch.cuda.max_memory_allocated(d) / 2**30, 3)
                 for d in set(devices)}
        launches = dict(LAUNCHES)
        rasters[label] = [b.to(home) for b in out.bands]
        maps[label] = [b.to(home) for b in ij_map.bands]
        del out, ij_map, step, xp
        mpix = R3_BANDS * tgt.width * tgt.height / 1e6
        print(f"R3 sharded_rectify ({width}x{height}, {R3_BANDS} bands -> {tgt.width}x"
              f"{tgt.height}, bilinear) over {mesh.size} entries, {label}: first call "
              f"{first:.3f} s; warm, median of 5: sharded_rectify {warm:.2f} ms = "
              f"{mpix / warm * 1e3:.1f} Mpix/s, sharded_phase_a alone {phase_a:.2f} ms, the "
              f"step alone over its map {step_ms:.2f} ms; peak device memory of a call (GiB) "
              f"{peaks}; launches {launches}")
        trace(label, lambda: sharded_rectify(x, gm, tgt, mesh, interp_method="bilinear"), sync)
    equal(*rasters.values(), "sharded_rectify")
    equal(*maps.values(), "sharded_phase_a")


if __name__ == "__main__":
    sys.exit(main())
