#!/usr/bin/env python3
"""Time BASELINE #5's sharded reproject over every card against one card.

Run from the repository root on a machine with several CUDA devices:
``python3 tools/sharded_mesh.py``.  It builds ``make_sharded_srw_step`` for
the headline's geometry (20480^2 UTM32N 30 m -> EPSG:3035 30 m, bilinear,
4 float32 bands made on card 0 from a seed) over two meshes of as many
entries as there are cards: (a) one entry a card, (b) every entry on
card 0.  For each it prints the first call of ``sharded_reproject``
(planning included), the planned step's warm calls (median of 5) from the
global source on card 0 (on (a) the bands' copies to their cards count)
and from a ``Sharded`` of the bands already on their cards (the halo
exchange and the band kernels alone), and the peak device memory of a
step call on each card, and it holds (a) to (b) bit for bit.  It prints
the cards' names and power limits first and exits nonzero where a check
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


def main() -> int:
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch._device import LAUNCHES
    from xcube_resampling_tpu_torch.parallel import (
        Sharded,
        make_mesh,
        make_sharded_srw_step,
        sharded_reproject,
    )

    if not torch.cuda.is_available():
        print("sharded_mesh: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    cards = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    home = cards[0]

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

    utm = GridMapping.regular(size=(N, N), xy_min=(300000.0, 5200000.0), xy_res=30.0,
                              crs="epsg:32632")
    laea = GridMapping.regular(size=(N, N), xy_min=(4050000.0, 2650000.0), xy_res=30.0,
                               crs="epsg:3035")
    gen = torch.Generator(device=home).manual_seed(0)
    x = torch.rand((BANDS, N, N), generator=gen, device=home)
    results = {}
    for label, devices in (("one entry a card", cards),
                           (f"every entry on {home}", [home] * len(cards))):
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
    (a, b) = results.values()
    for k, (p, q) in enumerate(zip(a, b)):
        if not torch.equal(torch.isnan(p), torch.isnan(q)) or not torch.equal(
                p.nan_to_num(0.0), q.nan_to_num(0.0)):
            raise SystemExit(f"band {k} differs between the two meshes")
    print(f"the two meshes' bands equal bit for bit ({len(a)} bands)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
