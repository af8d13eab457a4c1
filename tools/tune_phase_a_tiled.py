#!/usr/bin/env python3
"""Time K20 (``phase_a_tiled``, the tiled stencil's Phase A kernel) over the
threads of its blocks, beside another tree's K20.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_phase_a_tiled.py [--against TREE]``.
It builds ``csrc/phase_a_tiled.cu`` once per entry of ``VARIANTS`` (its
threads a block for the interior class's windows, ``kSmallThreads``, and
for the band class's, ``kLargeThreads``), each into a library of its own
under ``build/tune_phase_a_tiled/`` (all ``nvcc`` processes started
together), and with ``--against`` TREE's source as it stands (an unpacked
parent commit, say: the same C entry), and prints the registers, spills
and stack frame ptxas gave each kernel.  At R1 (the 1189 x 1890 OLCI-like
swath onto its default 512-tiled grid) and R3 (the 4865 x 4091 granule onto
its 1024-tiled grid), with the tiled planner's plan (``plan_phase_a_device``),
it launches each class (the interior class over every tile, the band class
over its tiles) through this tree's wrapper, every variant and TREE; holds
the wrapper to the plain version bit for bit (R1 in full; R3 on the first
``CROP`` tiles of each class) and every variant and TREE to the wrapper's
map bit for bit (each into a map of -7, so that a pixel left unwritten
shows); and times each: the mean of 10 launches queued behind a
sleep on the card (device time alone, the ruler of ``chip_smoke.py``'s
``device_ms``), in two passes (forward, then backward), the lesser
printed beside both.  Every line carries the card's name and power limit;
the last line is one JSON object with the times.  It exits nonzero when
no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

# (name, constants): threads a block for the interior class's windows (up
# to kSmallWin nodes) and for the band class's; the register cap (for
# kSmThreads threads an SM: 512 gives 128 registers a thread, 1024 64);
# pass 2's test as tri_accepts makes it
VARIANTS = (
    ("as it stands", {}),
    ("small 64", {"kSmallThreads": 64}),
    ("small 128", {"kSmallThreads": 128}),
    ("large 64", {"kLargeThreads": 64}),
    ("large 256", {"kLargeThreads": 256}),
    ("cap 512", {"kSmThreads": 512}),
    ("cap 704", {"kSmThreads": 704}),
    ("cap 768", {"kSmThreads": 768}),
    ("cap 1024", {"kSmThreads": 1024}),
    # pass 2 solving v also where u already refuses (tri_accepts)
    ("both solves", {"replace": [(
        "          if (!(u >= u_min)) continue;\n"
        "          const double v = fv(px, py, q0x, q0y, q1x, q1y) / det;\n"
        "          if (v >= u_min && u + v <= uv_max)",
        "          const double v = fv(px, py, q0x, q0y, q1x, q1y) / det;\n"
        "          if (u >= u_min && v >= u_min && u + v <= uv_max)")]}),
)
# (cell, swath width, height, target tile)
CELLS = (("R1", 1189, 1890, 512), ("R3", 4865, 4091, 1024))
# R3's crop for the plain version: the first tiles of each class
CROP = 3000


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_phase_a_tiled: no CUDA device is visible", file=sys.stderr)
        return 2
    from chip_smoke import ptxas_kernels
    from tune_ij_gather import build_variants, card_line, device_ms, olci_swath
    from xcube_resampling_tpu_torch import GridMapping, _build
    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.ops import phase_a as pa

    parser = argparse.ArgumentParser()
    parser.add_argument("--against", type=Path, default=None)
    args = parser.parse_args()
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build_variants(ROOT / "build" / "tune_phase_a_tiled", "phase_a_tiled.cu", VARIANTS,
                          args.against)
    print(f"[{card}] {len(libs)} builds of K20 in {time.perf_counter() - t0:.1f} s")
    for name, lib, log in libs:
        lib.xrt_phase_a_tiled.argtypes = _build._SIGNATURES["xrt_phase_a_tiled"]
        for kernel, regs, spill, stack in ptxas_kernels(log, "tiled_kernel"):
            print(f"[{card}] {name} {kernel}: {regs} registers, {spill} bytes spilled, "
                  f"{stack} bytes of stack frame")
    results = {}
    for cell, width, height, tile in CELLS:
        ds = olci_swath(width, height, tile)
        gm = GridMapping.from_dataset(ds)
        tgt = gm.to_regular(tile_size=tile)
        xy = np.stack([np.asarray(ds["lon"].data), np.asarray(ds["lat"].data)])
        x1, y1, x2, y2 = tgt.xy_bbox
        x_res, y_res = tgt.xy_res
        up = tgt.is_j_axis_up
        plan = pa.plan_phase_a_device(xy[0], xy[1], 0, 0, (tgt.height, tgt.width), x1,
                                      y1 if up else y2, x_res, y_res if up else -y_res,
                                      UV_DELTA, device=dev)
        if not isinstance(plan, pa.PhaseAPlan) or plan.cls_band is None:
            raise AssertionError(f"{cell}: the tiled planner gave {plan!r}, no band class")
        for cls_name, c in (("interior", plan.cls_all), ("band", plan.cls_band)):
            sel = c["sel"] if cls_name == "band" else None
            k_args = (plan.g, sel, c["bjs"], c["bis"], c["win"], plan.tile, plan.n_ti, UV_DELTA)
            out = torch.full((2, plan.dst_h, plan.dst_w), float("nan"), dtype=torch.float64,
                             device=dev)
            # (-7 where the class writes nothing, as in the timed calls below)
            ref = pa.phase_a_tiled(*k_args, torch.full_like(out, -7.0))
            n = len(c["bjs"]) if cell == "R1" else min(CROP, len(c["bjs"]))
            crop = (plan.g, None if sel is None else sel[:n], c["bjs"][:n], c["bis"][:n],
                    *k_args[4:])
            plain = pa.phase_a_tiled_plain(*crop, out.clone())
            if not same(torch, pa.phase_a_tiled(*crop, out.clone()), plain):
                raise AssertionError(f"{cell} {cls_name}: K20 differs from its plain version")

            def entry(lib):
                g, s, bjs, bis, win, t, n_ti, uvd = k_args
                c_args = (g[0].data_ptr(), g[1].data_ptr(), g.shape[1], g.shape[2],
                          None if s is None else s.data_ptr(), bjs.data_ptr(), bis.data_ptr(),
                          len(bjs), win, t, n_ti, plan.dst_h, plan.dst_w, uvd, out.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)

                def call():
                    rc = lib.xrt_phase_a_tiled(*c_args)
                    if rc:
                        raise RuntimeError(f"K20 of a built library: CUDA error {rc}")
                    return out
                return call

            calls = [("its wrapper", lambda: pa.phase_a_tiled(*k_args, out))]
            calls += [(name, entry(lib)) for name, lib, _ in libs]
            times = {}
            for name, call in calls + calls[::-1]:
                out.fill_(-7.0)
                got = call()
                torch.cuda.synchronize()
                if not same(torch, got, ref):
                    raise AssertionError(f"{cell} {cls_name}: {name} differs from the wrapper")
                times.setdefault(name, []).append(device_ms(call))
            key = f"{cell} {cls_name}"
            results[key] = {}
            print(f"[{card}] {key}: {len(c['bjs'])} tiles of {plan.tile}^2, window "
                  f"{c['win']}; held to the plain version on {n} tiles")
            for name, (t1, t2) in times.items():
                results[key][name] = min(t1, t2)
                print(f"[{card}] {key} {name:16s}: {min(t1, t2):.4f} ms device (passes "
                      f"{t1:.4f}, {t2:.4f})")
            del out, ref, plain
        del plan
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "device_ms": results}))
    return 0


def same(torch, a, b) -> bool:
    """Equal bit for bit, NaN positions included."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


if __name__ == "__main__":
    sys.exit(main())
