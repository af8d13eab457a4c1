#!/usr/bin/env python3
"""Time K11 (``hybrid_seed``, the hybrid Phase A's seed) launch by launch,
beside a ``torch.sum`` of the same bytes and another tree's K11.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_hybrid_seed.py [--against TREE]``.
At R1 (the 1189 x 1890 OLCI-like swath onto its default 512-tiled grid)
and R3 (the 4865 x 4091 granule onto its 1024-tiled grid), tile 16, band
origin 0, it holds this tree's K11 to its plain version (the corner
quads and the meta), and times, each as the mean of 10 calls queued
behind a sleep on the card (device time alone, the ruler of
``chip_smoke.py``'s ``device_ms``):

* this tree's K11 through its wrapper, and each of its launches from
  ``torch.profiler`` over 10 calls (device time a launch, by kernel);
* this tree's ``csrc/hybrid_phase_a.cu`` built once per entry of
  ``VARIANTS`` (its pass's constants), each held to the plain version;
* two ``torch.sum`` calls over the two float64 coordinate images, a
  yardstick of reading the same bytes once (not K11's function);
* with ``--against``, TREE's K11 as it stands (an unpacked parent commit,
  say; its C entry as the seven-launch design had it, with the coarse
  lattice's buffer),
  held equal to this tree's, and its launches from the profiler.

Every line carries the card's name and power limit.  It exits nonzero when
no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

CELLS = (("R1", (1189, 1890, 512)), ("R3", (4865, 4091, 1024)))
# (name, constants of the pass): "rowsN" N rows a tile, "aheadN" N rows
# loaded ahead, "blocksN" N blocks (and partial sums)
VARIANTS = (
    ("as it stands", {}),
    ("rows 64", {"kPassRows": 64}),
    ("rows 16", {"kPassRows": 16}),
    ("ahead 8", {"kPassAhead": 8}),
    ("ahead 2", {"kPassAhead": 2}),
    ("blocks 264", {"kPassBlocks": 264}),
)
# the scratch every variant's partial sums fit in
_SCRATCH = 1056 * 16


def cell(dev, width, height, tile_size):
    """The normalised swath coordinates (float64, on *dev*) and the target
    shape of a rectify cell."""
    import torch

    from tune_ij_gather import olci_swath
    from xcube_resampling_tpu_torch import GridMapping

    gm = GridMapping.from_dataset(olci_swath(width, height, tile_size))
    tgt = gm.to_regular(tile_size=tile_size)
    sw = torch.from_numpy(np.ascontiguousarray(np.asarray(gm.xy_coords.data),
                                               dtype=np.float64)).to(dev)
    x1, y1, _, y2 = tgt.xy_bbox
    x_res, y_res = tgt.xy_res
    j_up = tgt.is_j_axis_up
    gx = (sw[0] - x1) / x_res
    gy = (sw[1] - (y1 if j_up else y2)) / (y_res if j_up else -y_res)
    return gx.contiguous(), gy.contiguous(), (tgt.height, tgt.width)


def profile_launches(call, n=10) -> list[tuple[str, float, int]]:
    """(kernel, mean device ms a launch, launches a call) of *n* calls of
    *call* under ``torch.profiler``; empty where it records no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0.0)
        if total and e.count:
            name = re.search(r"(\w+)(?:<[^>]*>)?\(", e.key)
            out.append((name.group(1) if name else e.key[:60], total / e.count / 1e3,
                        e.count // n))
    return out


def main() -> int:
    import torch

    from chip_smoke import ptxas_kernels
    from tune_ij_gather import build_variants, card_line, device_ms
    from xcube_resampling_tpu_torch import _build
    from xcube_resampling_tpu_torch.ops import rectify_ops as ro

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a tree whose csrc/hybrid_phase_a.cu is built and timed as well")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_hybrid_seed: no CUDA device is visible", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = build_variants(ROOT / "build" / "tune_hybrid_seed", "hybrid_phase_a.cu", VARIANTS,
                           args.against)
    tree = built.pop()[1] if args.against is not None else None
    p, i64, d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    for name, lib, log in built:
        lib.xrt_hybrid_seed.argtypes = _build._SIGNATURES["xrt_hybrid_seed"]
        lib.xrt_hybrid_seed.restype = ctypes.c_int
        for pattern in ("seed_pass", "seed_walk"):
            for _, regs, spill, stack in ptxas_kernels(log, pattern):
                print(f"[{card}] {name} {pattern}: {regs} registers, {spill} bytes spilled, "
                      f"{stack} bytes of stack frame")
    if tree is not None:
        # (TREE's C entry as the seven-launch design had it: the coarse
        # lattice's buffer besides)
        tree.xrt_hybrid_seed.argtypes = [p, p, i64, i64, d, i64, i64, i64, i64, i64, d, i64,
                                         p, p, p, p, p, p]
        tree.xrt_hybrid_seed.restype = ctypes.c_int
    print(f"[{card}] {len(built) + (tree is not None)} builds of K11 in "
          f"{time.perf_counter() - t0:.1f} s")
    for name_c, shape in CELLS:
        gx, gy, dst = cell(dev, *shape)
        seed = (gx, gy, dst, 16, float(max(dst)), 2)
        got = ro.hybrid_seed(*seed)
        ref = ro.hybrid_seed_plain(*seed)
        for a, b, part in zip(got, ref, ("cqj", "cqi", "meta")):
            if not torch.equal(a, b):
                raise AssertionError(f"{name_c}: K11's {part} differs from its plain version")
        print(f"[{card}] {name_c}: swath {gx.shape[0]}x{gx.shape[1]} float64 -> "
              f"{dst[0]}x{dst[1]}, tile 16, meta {got[2].tolist()}; equal to its plain version")
        calls = [("K11", lambda: ro.hybrid_seed(*seed)),
                 ("torch.sum x2", lambda: (gx.sum(), gy.sum()))]
        scratch = torch.empty(_SCRATCH, dtype=torch.float64, device=dev)
        v_out = [torch.empty_like(got[0]), torch.empty_like(got[1]), torch.empty_like(got[2])]
        for name, lib, _ in built:
            def v_call(lib=lib, name=name):
                rc = lib.xrt_hybrid_seed(
                    gx.data_ptr(), gy.data_ptr(), gx.shape[0], gx.shape[1], 0.0, dst[0], dst[1],
                    16, 24, 6, float(max(dst)), 2, scratch.data_ptr(),
                    *(t.data_ptr() for t in v_out), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"K11 {name}: launch failed ({rc})")

            v_call()
            torch.cuda.synchronize()
            for a, b, part in zip(v_out, got, ("cqj", "cqi", "meta")):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name_c}: K11 {name}'s {part} differs")
            calls.append((f"K11 {name}", v_call))
        if tree is not None:
            n_tj, n_ti, n_cj, n_ci = ro._hybrid_lattice(dst, 16)
            t_scratch = torch.empty(264 * 8 + 8, dtype=torch.float64, device=dev)
            qc = torch.empty(2 * n_cj * n_ci, dtype=torch.int32, device=dev)
            t_out = [torch.empty((n_tj + 1, n_ti + 1), dtype=torch.int32, device=dev)
                     for _ in range(2)] + [torch.empty(3, dtype=torch.int32, device=dev)]

            def tree_call():
                rc = tree.xrt_hybrid_seed(
                    gx.data_ptr(), gy.data_ptr(), gx.shape[0], gx.shape[1], 0.0, dst[0], dst[1],
                    16, 24, 6, float(max(dst)), 2, t_scratch.data_ptr(), qc.data_ptr(),
                    *(t.data_ptr() for t in t_out), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"TREE's K11: launch failed ({rc})")

            tree_call()
            torch.cuda.synchronize()
            for a, b, part in zip(t_out, got, ("cqj", "cqi", "meta")):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name_c}: TREE's K11 {part} differs from this tree's")
            calls.append((f"TREE {args.against.name}", tree_call))
        n_bytes = 2 * gx.numel() * 8
        for name, call in calls + calls[::-1][1:]:
            ms = device_ms(call)
            print(f"[{card}] {name_c} {name:20s}: {ms:.4f} ms device "
                  f"({n_bytes / ms / 1e6:.0f} GB/s over the two images)")
        for name, call in calls[:1] + calls[-1:] if tree is not None else calls[:1]:
            launches = profile_launches(call)
            if not launches:
                print(f"[{card}] {name_c} {name}: the profiler recorded no device time")
            for kernel, ms, n in launches:
                print(f"[{card}] {name_c} {name} profile: {kernel} {ms:.4f} ms device a launch, "
                      f"{n} a call")
        del gx, gy, got, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
