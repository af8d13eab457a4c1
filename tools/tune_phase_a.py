#!/usr/bin/env python3
"""Time K8 (``rectify_phase_a``, the rectify Phase A map) over its
constants.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_phase_a.py``.  It
builds ``csrc/rectify_phase_a.cu`` once per variant of its constants (the
``constexpr int`` values named in ``VARIANTS``: the blocks an SM must hold,
which caps the registers),
each into a library of its own under ``build/tune_phase_a/`` (all
``nvcc`` processes started together), prints each variant's registers and
spills, and times each at R1 = BASELINE #4 (the 1189 x 1890 OLCI-like
swath onto its default 512-tiled grid) and R3 (a 4865 x 4091 swath onto
its default 1024-tiled grid), the tiles planned by the port with K10,
the tables uploaded once beforehand.  Each time
is the mean of 10 calls queued behind a sleep on the card (device time
alone), in two passes over the variants (forward, then backward), the
lesser printed beside both; every variant's map is checked equal to the
first one's, bit for bit.  Every line carries the card's name and power
limit.  It exits nonzero when no CUDA device is visible.
"""

from __future__ import annotations

import ctypes
import re
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from tune_ij_gather import build_variants, card_line, device_ms, olci_swath, spills  # noqa: E402

# (name, constants); the first variant is the source as it stands: "mN"
# at least N blocks an SM in both passes (registers capped at 65536 / (256
# N)), "m1" no cap
VARIANTS = (
    ("m4", {}),
    ("m1", {"kMinBlocks": 1}),
    ("m5", {"kMinBlocks": 5}),
    ("m6", {"kMinBlocks": 6}),
)


def cells(dev):
    """(name, (2, H, W) float64 swath on the card, tiles) of R1 and R3."""
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch import rectify as port_rectify

    out = []
    for name, (w, h, tile) in (("R1", (1189, 1890, 512)), ("R3", (4865, 4091, 1024))):
        ds = olci_swath(w, h)
        gm = GridMapping.from_dataset(ds)
        sw = torch.from_numpy(np.stack([np.asarray(ds["lon"].data),
                                        np.asarray(ds["lat"].data)])).to(dev)
        out.append((name, sw, port_rectify._phase_a_tiles(gm, gm.to_regular(tile_size=tile), sw)))
    return out


def main() -> int:
    import torch

    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.ops import rectify_ops

    if not torch.cuda.is_available():
        print("tune_phase_a: no CUDA device is visible", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = build_variants(ROOT / "build" / "tune_phase_a", "rectify_phase_a.cu", VARIANTS,
                           None)
    print(f"[{card}] {len(built)} variants of K8 built in {time.perf_counter() - t0:.1f} s")
    for name, _, log in built:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        print(f"[{card}] K8 {name}: registers {regs}; spills: {spills(log)}")
    for cell, sw, tiles in cells(dev):
        table, n_items = rectify_ops.phase_a_table(tiles)
        table = torch.from_numpy(table).to(dev)
        base = table.data_ptr()
        n = len(tiles.ints)
        claim = torch.empty(tiles.out_h * tiles.out_w, dtype=torch.int32, device=dev)
        out = torch.empty((2, tiles.out_h, tiles.out_w), dtype=torch.float64, device=dev)
        first, times = None, {}
        print(f"[{card}] {cell}: {sw.shape[2]}x{sw.shape[1]} swath -> {tiles.out_w}x"
              f"{tiles.out_h}, {n} tiles, {n_items} work items")
        for name, lib, _ in built + built[::-1]:
            def call(lib=lib, name=name):
                rc = lib.xrt_rectify_phase_a(
                    ctypes.c_void_p(sw[0].data_ptr()), ctypes.c_void_p(sw[1].data_ptr()),
                    ctypes.c_int64(sw.shape[1]), ctypes.c_int64(sw.shape[2]),
                    ctypes.c_void_p(base), ctypes.c_void_p(base + 64 * n), ctypes.c_int64(n),
                    ctypes.c_void_p(base + 80 * n), ctypes.c_int64(n_items),
                    ctypes.c_int64(rectify_ops.PATCH_W), ctypes.c_int64(rectify_ops.PATCH_H),
                    ctypes.c_int64(tiles.tile_h), ctypes.c_int64(tiles.tile_w),
                    ctypes.c_int64(tiles.n_tiles_x), ctypes.c_int64(tiles.out_h),
                    ctypes.c_int64(tiles.out_w), ctypes.c_double(tiles.x_scale),
                    ctypes.c_double(tiles.y_scale), ctypes.c_double(UV_DELTA),
                    ctypes.c_void_p(claim.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if rc:
                    raise RuntimeError(f"K8 {name}: launch failed ({rc})")

            call()
            torch.cuda.synchronize()
            if first is None:
                first = out.clone()
            elif not torch.equal(out.nan_to_num(-1e300), first.nan_to_num(-1e300)):
                raise AssertionError(f"K8 {name} differs from the first variant at {cell}")
            times.setdefault(name, []).append(device_ms(call))
        for name, (t1, t2) in times.items():
            print(f"[{card}] K8 {name:4s} at {cell}: {min(t1, t2):.4f} ms device "
                  f"(passes {t1:.4f}, {t2:.4f})")
        del claim, out, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
