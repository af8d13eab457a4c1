#!/usr/bin/env python3
"""Time K10 (``ij_bboxes``, the rectify tile plan's bbox scan) over its
constants, and another tree's K10 beside it.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_ij_bboxes.py [--against TREE]``.
It builds ``csrc/ij_bboxes.cu`` once per variant of its constants (the
``constexpr int`` values named in ``VARIANTS``: the stages of a warp's
copies, the blocks an SM that cap the registers), each
into a library of its own under ``build/tune_ij_bboxes/`` (all ``nvcc``
processes started together), and, with ``--against``, TREE's
``ij_bboxes.cu`` as it stands, with the earlier entry point (lattice and
order uploaded apart, two scratch tables; e.g. a parent commit unpacked
with ``git archive``).  It prints each variant's registers and spills and times each
at R1 = BASELINE #4 (the 1189 x 1890 OLCI-like swath onto its default
512-tiled grid) and R3 (a 4865 x 4091 swath onto its default 1024-tiled
grid; its y image starts 8 bytes off a 16-byte boundary, as in the (2, H,
W) swath the rectify route hands K10), and at R3 with y copied to an
aligned buffer.  The variants run with the lattice and table made once;
TREE's K10 twice: as its wrapper runs it (lattice and order uploaded from
pageable memory each call) and with them uploaded once (its launches
alone).  Each time is the mean of 10 calls queued behind a sleep on the
card, in two passes (forward, then backward), the lesser printed beside
both; every result is checked equal to the plain version's, bit for bit.
The ablations in ``ABLATIONS`` (the source with a part taken out or
changed: the per-pixel logic, the last block's finish, the cache path of
the 16-byte copies) are timed beside them to show what each part costs;
their boxes are not checked.  The ablations'
table is restored by no launch: each runs on a table of its own.
Beside them, two ``torch.sum`` calls that read the two images once (a
yardstick of the read alone, not K10's function).
Every line carries the card's name and power limit.  It exits nonzero
when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from tune_ij_gather import build_variants, card_line, device_ms, olci_swath, spills  # noqa: E402

# (name, constants); the first variant is the source as it stands
VARIANTS = (
    ("s2 m4", {}),
    ("s3 m4", {"kStages": 3}),
    ("s2 m3", {"kMinBlocks": 3}),
)
# Ablations: the source with a part taken out or changed (text replaced),
# timed to see what that part costs; their boxes are not checked (wrong by
# design where a part is taken out)
ABLATIONS = {
    "loads only": (
        """        visit(s, r, xv.x, yv.x, i, j, lane);
        const bool wraps = i + 1 == a.w;
        visit(s, r, xv.y, yv.y, wraps ? 0 : i + 1, wraps ? j + 1 : j, lane);""",
        """        if (xv.x + yv.x + xv.y + yv.y > 1e300) r.i0 = 0;""",
    ),
    "no finish": ("  if (!last) return;", "  return;"),
    "16-byte copies through L2 only (.cg)": ("cp.async.ca.shared.global [%0], [%1], 16;",
                                             "cp.async.cg.shared.global [%0], [%1], 16;"),
}


def build_ablations(out_dir: Path):
    """[(name, library)] of ``csrc/ij_bboxes.cu`` with each ablation's
    text replaced, built together."""
    from xcube_resampling_tpu_torch import _build

    text0 = (_build.CSRC / "ij_bboxes.cu").read_text()
    procs = []
    for name, (old, new) in ABLATIONS.items():
        if text0.count(old) != 1:
            raise ValueError(f"ij_bboxes.cu: the ablation {name!r} matches "
                             f"{text0.count(old)} times")
        src = out_dir / f"ij_bboxes.ablation_{re.sub(r'[^a-z0-9]+', '_', name)}.cu"
        src.write_text(text0.replace(old, new))
        lib = src.with_suffix(".so")
        procs.append((name, lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for name, lib, proc in procs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the ablation {name}:\n{log}")
        built.append((name, ctypes.CDLL(str(lib))))
    return built


def cells(dev):
    """(name, x, y, xy boxes, xy border) of R1, R3 and R3 with an aligned y."""
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch import rectify as port_rectify

    out = []
    for name, (w, h, tile) in (("R1", (1189, 1890, 512)), ("R3", (4865, 4091, 1024))):
        ds = olci_swath(w, h)
        gm = GridMapping.from_dataset(ds)
        tgt = gm.to_regular(tile_size=tile)
        sw = torch.from_numpy(np.stack([np.asarray(ds["lon"].data),
                                        np.asarray(ds["lat"].data)])).to(dev)
        border = port_rectify._tile_search_border(tgt)
        out.append((name, sw[0], sw[1], tgt.xy_bboxes, border))
        if name == "R3":
            out.append(("R3 y aligned", sw[0], sw[1].clone(), tgt.xy_bboxes, border))
    return out


def main() -> int:
    import torch

    from xcube_resampling_tpu_torch.ops import bbox_ops

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, help="another tree's K10 to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_ij_bboxes: no CUDA device is visible", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = build_variants(ROOT / "build" / "tune_ij_bboxes", "ij_bboxes.cu", VARIANTS,
                           args.against)
    print(f"[{card}] {len(built)} builds of K10 in {time.perf_counter() - t0:.1f} s")
    for name, _, log in built:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        print(f"[{card}] K10 {name}: registers {regs}; spills: {spills(log)}")
    against = built.pop() if args.against else None
    ablations = build_ablations(ROOT / "build" / "tune_ij_bboxes")
    for cell, x, y, xy_boxes, border in cells(dev):
        h, w = x.shape
        stream = torch.cuda.current_stream().cuda_stream
        lat, nc, nr, _ = bbox_ops.lattice_buffer(bbox_ops._grown(xy_boxes, border), dev)
        table, _ = bbox_ops.scratch_table(nc * nr, dev)
        out = torch.empty((nc * nr, 4), dtype=torch.int64, device=dev)
        ref = bbox_ops.compute_ij_bboxes_plain(x, y, xy_boxes, border, 1)
        print(f"[{card}] {cell}: {w}x{h} swath, {nc * nr} tiles, x {x.data_ptr() % 16} and y "
              f"{y.data_ptr() % 16} bytes past 16")
        calls = {}
        for name, lib in [(name, lib) for name, lib, _ in built] + [
                (f"ablation: {name}", lib) for name, lib in ablations]:
            fn = lib.xrt_ij_bboxes
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] + \
                [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int),
                                                                ctypes.c_void_p]

            own = table.clone() if name.startswith("ablation") else table

            def call(fn=fn, name=name, own=own):
                queued = ctypes.c_int(0)
                rc = fn(x.data_ptr(), y.data_ptr(), h, w, lat.data_ptr(), nc, nr, 1,
                        own.data_ptr(), out.data_ptr(), ctypes.byref(queued), stream)
                if rc or queued.value != 1:
                    raise RuntimeError(f"K10 {name}: launch failed ({rc})")

            calls[name] = call
        if against is not None:
            name, lib, _ = against
            fn = lib.xrt_ij_bboxes
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + \
                [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 4
            gmin = torch.empty((nc * nr, 2), dtype=torch.int32, device=dev)
            gmax = torch.empty_like(gmin)
            lat_once = None

            def call_against(fn=fn, once=False):
                nonlocal lat_once
                if lat_once is None or not once:
                    # as its wrapper did: the lattice and the order from pageable memory
                    lat_np, perm, _, _ = bbox_ops.lattice(bbox_ops._grown(xy_boxes, border))
                    lat_once = (torch.from_numpy(lat_np).to(dev), torch.from_numpy(perm).to(dev))
                rc = fn(x.data_ptr(), y.data_ptr(), h, w, lat_once[0].data_ptr(),
                        lat_once[1].data_ptr(), nc, nr, 1, gmin.data_ptr(), gmax.data_ptr(),
                        out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"K10 of {name}: launch failed ({rc})")

            calls[f"{name} (its wrapper)"] = call_against
            calls[f"{name} (launches alone)"] = lambda: call_against(once=True)
        times = {}
        for name, call in list(calls.items()) + list(calls.items())[::-1]:
            out.fill_(-7)
            call()
            torch.cuda.synchronize()
            if not name.startswith("ablation") and not torch.equal(out, ref):
                raise AssertionError(f"K10 {name} differs from the plain version at {cell}")
            times.setdefault(name, []).append(device_ms(call))
        # a yardstick: one PyTorch reduction that reads both images once
        times["torch.sum of x and y"] = [device_ms(lambda: (x.sum(), y.sum()))] * 2
        bound = (2 * x.numel() * 8 + nc * nr * 64) / 3.35e12 * 1e3
        for name, (t1, t2) in times.items():
            print(f"[{card}] K10 {name:28s} at {cell}: {min(t1, t2):.4f} ms device "
                  f"(passes {t1:.4f}, {t2:.4f}); bound {bound:.4f} ms (bytes)")
        del out, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
