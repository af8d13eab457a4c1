#!/usr/bin/env python3
"""Time the aligned and hybrid SRW's tap passes (K14/K17 vertical, K15/K18
horizontal, ``csrc/srw_aligned.cu``) at the shapes ``chip_smoke.py`` drives.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_aligned.py [--against TREE
[--walls]]``.  Two cells:

* the ESW cell under ``XRTPU_FAST_EXTREME_WARP=1``: the EPSG:4326 0.05 deg
  global source (7200 x 3600) onto EPSG:3035 4096^2 at 937.5 m from
  (2.5e6, 1.4e6), the whole-domain hybrid SRW (K17 + K18), bilinear and
  nearest, 1 and 4 bands;
* the 2048^2 flagship's aligned SRW (K14 + K15) on its pre-downscaled
  1836 x 1837 coarse image, bilinear and nearest, 1 and 4 bands.

Each kernel's device ms is the mean of 10 warm launches queued behind a
sleep on the card (``chip_smoke.py``'s ruler).  This tree's kernels run
as the main path calls them (the state's vertical plan, the horizontal
kernel on the vertical kernel's flags), and the horizontal kernel also
testing v's values.  With ``--against TREE`` (e.g. the parent unpacked
with ``git archive``) TREE's ``csrc/srw_aligned.cu`` is built into a
library of its own and called through its C entries
(``chip_smoke.build_tree_library``, ``tree_calls``), in turns with this
tree's (tree, this, this, tree).  ``--walls`` adds, in the same turns,
one process a turn with TREE's or this tree's package: the warm walls of
``resample_in_space`` at the flagship (bilinear, 1 and 4 bands) and at
BASELINE #3 under the switch (the two-pass mosaic, bilinear), and the
host ms of one call of the flagship's aligned SRW fn and of B3's mosaic
fn, enqueued behind a sleep on the card.  Every output is held to the
plain version's, bit for bit.  Every line carries the card's name and
power limit; the last line is one JSON object with the times.  It exits
nonzero when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ESW_TARGET = dict(size=(4096, 4096), xy_min=(2500000.0, 1400000.0), xy_res=937.5,
                  crs="epsg:3035")
FLAGSHIP = 2048
# BASELINE #3's target (chip_smoke.HYBRID_B3)
B3_TARGET = dict(size=(4096, 4096), xy_min=(2000000.0, 1000000.0), xy_res=1500.0,
                 crs="epsg:3035")
# warm calls a wall's median takes, and calls a host reading's mean
WALL_CALLS = {"flagship": 21, "b3": 11}
HOST_CALLS = 20
# rounds of (tree, this, this, tree) processes that --walls runs
WALL_ROUNDS = 2


def registers(log: str) -> str:
    """Registers and spills of the aligned kernels, from a ptxas report."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        if "srw_aligned" in name:
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            kind = "v" if "vertical" in name else "h"
            out.append(f"{kind}{re.sub(r'[^0-9]', '', name.split('srw_aligned')[1])[:4]}:"
                       f"{regs.group(1) if regs else '?'}r/{spill.group(1) if spill else 0}s")
    return " ".join(out)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def device_ms(torch, fn, iters=10):
    """Device ms of one warm call: CUDA events around *iters* calls queued
    behind a sleep on the card that outlasts their enqueueing."""
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


def host_ms(torch, fn, iters=HOST_CALLS):
    """Host ms of one warm call's enqueue: *iters* calls behind a sleep on
    the card that outlasts them, so none waits on the card (a call that
    synchronises reads as its wall)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    torch.cuda._sleep(int(2e9 * min(4 * iters * one, 2.0)))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / iters


def event_ms(torch, fn, iters=10):
    """Median ms between two CUDA events around one warm call of *fn* on
    an idle card (``chip_smoke.py``'s one-launch ruler): its device time
    and the host's enqueue of the call."""
    fn()
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


def equal(torch, a, b) -> bool:
    """Bit for bit, NaN masks and signs of zeros included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32)) or (
        torch.equal(torch.isnan(a), torch.isnan(b))
        and torch.equal(torch.where(torch.isnan(a), 0, a.view(torch.int32)),
                        torch.where(torch.isnan(b), 0, b.view(torch.int32))))


def dataset(gm, data):
    """A one-variable dataset of *data* on the grid *gm*, from the package
    first on ``sys.path``."""
    from xcube_resampling_tpu_torch.xrlite import DataArray, Dataset

    coords = dict(gm.to_coords(exclude_bounds=True))
    coords["spatial_ref"] = DataArray(np.array(0), dims=(), attrs=gm.crs.to_cf())
    x_dim, y_dim = gm.xy_dim_names
    dims = (y_dim, x_dim) if data.ndim == 2 else ("band", y_dim, x_dim)
    return Dataset({"v": DataArray(data, dims=dims, attrs=dict(grid_mapping="spatial_ref"))},
                   coords=coords)


def flagship_coarse(torch, x, dev):
    """The flagship's pre-downscaled coarse image of *x* and its grid,
    seen by a spy on the engine's affine call."""
    from xcube_resampling_tpu_torch import GridMapping, resample_in_space
    from xcube_resampling_tpu_torch import reproject as port_reproject
    from xcube_resampling_tpu_torch.entry import flagship_gms

    src_gm, tgt = flagship_gms(FLAGSHIP, FLAGSHIP)
    seen = []
    engine_affine = port_reproject.affine_transform_dataset

    def spy(*a, **k):
        out = engine_affine(*a, **k)
        seen.append(out)
        return out

    port_reproject.affine_transform_dataset = spy
    try:
        resample_in_space(dataset(src_gm, x), target_gm=tgt, interp_methods="bilinear")
    finally:
        port_reproject.affine_transform_dataset = engine_affine
    return seen[0]["v"].data, GridMapping.from_dataset(seen[0]), tgt


def walls_of(tree: Path) -> dict:
    """The walls and host readings of ``--walls`` with the package of
    *tree* (run in a process of its own)."""
    sys.path.insert(0, str(tree))
    import torch

    import xcube_resampling_tpu_torch as pkg
    from xcube_resampling_tpu_torch import GridMapping, _build, resample_in_space
    from xcube_resampling_tpu_torch import reproject as port_reproject
    from xcube_resampling_tpu_torch.entry import flagship_gms

    if not Path(pkg.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {pkg.__file__}, not {tree}'s package")
    _build.build()
    dev = torch.device("cuda", 0)
    nan = float("nan")
    rng = np.random.default_rng(16)
    out = {}

    def wall(ds, tgt, n):
        times = []
        for _ in range(n + 1):  # the first call plans
            t0 = time.perf_counter()
            resample_in_space(ds, target_gm=tgt, interp_methods="bilinear")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[1:]) * 1e3

    src_gm, tgt = flagship_gms(FLAGSHIP, FLAGSHIP)
    x1 = torch.from_numpy(rng.random((FLAGSHIP, FLAGSHIP), dtype=np.float32)).to(dev)
    x4 = torch.from_numpy(rng.random((4, FLAGSHIP, FLAGSHIP), dtype=np.float32)).to(dev)
    out["flagship_wall_ms"] = wall(dataset(src_gm, x1), tgt, WALL_CALLS["flagship"])
    out["flagship_4_wall_ms"] = wall(dataset(src_gm, x4), tgt, WALL_CALLS["flagship"])
    coarse, coarse_gm, _ = flagship_coarse(torch, x1, dev)
    fn = port_reproject.device_reproject_fn(coarse_gm, tgt, "bilinear", nan, dev)
    if getattr(fn, "kind", None) != "aligned":
        raise AssertionError(f"the flagship planned {type(fn).__name__}, not the aligned SRW")
    out["flagship_fn_host_ms"] = host_ms(torch, lambda: fn(coarse))
    # each pass as the tree's fn calls it (this tree: the state's plan and
    # the flags), and where the fn's host time goes
    x = fn.crop(coarse[None])
    if hasattr(fn, "vertical"):
        v, flags = fn.vertical(x)
        passes = (lambda: fn.vertical(x), lambda: fn.horizontal(v, flags))
    else:
        from xcube_resampling_tpu_torch.ops import srw_aligned as sa

        v = sa.srw_aligned_vertical(*fn.vertical_args(x))
        passes = (lambda: sa.srw_aligned_vertical(*fn.vertical_args(x)),
                  lambda: sa.srw_aligned_horizontal(*fn.horizontal_args(v)))
    for name, f in zip(("vertical", "horizontal"), passes):
        out[f"flagship_{name}_host_ms"] = host_ms(torch, f)
        out[f"flagship_{name}_event_ms"] = event_ms(torch, f)
    out["flagship_fn_profile"] = host_profile(torch, lambda: fn(coarse))
    del x1, x4, coarse, fn, x, v, passes

    os.environ["XRTPU_FAST_EXTREME_WARP"] = "1"
    geo_gm = GridMapping.regular(size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05,
                                 crs="epsg:4326")
    geo = torch.from_numpy(rng.random((3600, 7200), dtype=np.float32)).to(dev)
    b3 = GridMapping.regular(**B3_TARGET)
    out["b3_switch_wall_ms"] = wall(dataset(geo_gm, geo), b3, WALL_CALLS["b3"])
    fn = port_reproject.device_reproject_fn(geo_gm, b3, "bilinear", nan, dev)
    if type(fn).__name__ != "RegionSRWFn":
        raise AssertionError(f"B3 under the switch planned {type(fn).__name__}")
    # 4 calls of some 140 device operations each fit the launch queue
    # behind the sleep; 10 (chip_smoke.py's ruler before) may not
    out["b3_switch_fn_host_ms"] = host_ms(torch, lambda: fn(geo), iters=4)
    out["b3_switch_fn_device_ms"] = device_ms(torch, lambda: fn(geo), iters=4)
    out["b3_switch_fn_device_ms_10"] = device_ms(torch, lambda: fn(geo), iters=10)
    return out


def host_profile(torch, fn, iters=200, top=12) -> str:
    """cProfile's *top* functions by their own time over *iters* calls of
    *fn*, in microseconds a call."""
    import cProfile
    import pstats

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(iters):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    total = sum(v[2] for v in stats.values())
    return f"{total * 1e6 / iters:.1f} us a call: " + "; ".join(
        f"{Path(f).name}:{line}({name}) {v[2] * 1e6 / iters:.1f}" for (f, line, name), v in rows)


def walls_in_turns(tree: Path, tag: str) -> dict:
    """``--walls``: one process a turn, :data:`WALL_ROUNDS` rounds of
    (tree, this, this, tree), each reading :func:`walls_of` its package;
    per reading each side's median of its turns and every turn."""
    runs = []
    for side in ("tree", "this", "this", "tree") * WALL_ROUNDS:
        root = (tree if side == "tree" else ROOT).resolve()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--walls-of",
                               str(root)], capture_output=True, text=True, timeout=900,
                              cwd=str(root))
        if proc.returncode:
            raise RuntimeError(f"--walls-of {root} failed:\n{proc.stdout[-4000:]}"
                               f"{proc.stderr[-8000:]}")
        runs.append((side, json.loads(proc.stdout.strip().splitlines()[-1])))
    out = {}
    for key in runs[0][1]:
        if isinstance(runs[0][1][key], str):
            for side, r in runs[:2]:
                print(f"{tag} {key}, {side}: {r[key]}")
            continue
        this = [r[key] for s, r in runs if s == "this"]
        parent = [r[key] for s, r in runs if s == "tree"]
        out[key] = dict(this=statistics.median(this), tree=statistics.median(parent),
                        turns=[round(r[key], 4) for _, r in runs])
        print(f"{tag} {key}: this {out[key]['this']:.4f}, tree {out[key]['tree']:.4f} "
              f"(turns tree, this, this, tree, ...: {out[key]['turns']})")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a tree whose srw_aligned.cu to time beside this one's")
    parser.add_argument("--walls", action="store_true",
                        help="also the flagship's and B3's walls beside TREE's, in turns")
    parser.add_argument("--walls-of", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.walls and args.against is None:
        parser.error("--walls needs --against TREE")

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.walls_of is not None:
        print(json.dumps(walls_of(args.walls_of)))
        return 0
    sys.path.insert(0, str(ROOT))
    from chip_smoke import build_tree_library, tree_calls
    from xcube_resampling_tpu_torch import GridMapping, _build
    from xcube_resampling_tpu_torch import reproject as port_reproject
    from xcube_resampling_tpu_torch.ops import srw as port_srw
    from xcube_resampling_tpu_torch.ops import srw_aligned as sa

    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{torch.cuda.get_device_name(0)}, {card}]"
    t0 = time.perf_counter()
    tree_build = None
    if args.walls:  # TREE's own library, for its processes, built meanwhile
        tree_build = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "from xcube_resampling_tpu_torch import _build; _build.build()",
             str(args.against)], cwd=str(args.against), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
    built = _build.build()
    print(f"{tag} this tree's library built in {built.seconds:.1f} s; {registers(built.log)}")
    lib = None
    if args.against is not None:
        lib, log = build_tree_library(args.against, ROOT / "build" / "tune_aligned")
        print(f"{tag} tree: {registers(log)}")
    print(f"{tag} builds done in {time.perf_counter() - t0:.1f} s")

    # -- the cells' plans ---------------------------------------------------
    nan = float("nan")
    rng = np.random.default_rng(0)
    geo_gm = GridMapping.regular(size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05,
                                 crs="epsg:4326")
    geo = torch.from_numpy(rng.random((4, 3600, 7200), dtype=np.float32)).to(dev)
    cell = GridMapping.regular(**ESW_TARGET)
    cases = []
    for interp in ("bilinear", "nearest"):
        fn = port_srw.make_srw_reproject_fn(geo_gm, cell, interp, nan, dev, allow_hybrid=True)
        if not isinstance(fn, port_srw.HybridSRWFn):
            raise AssertionError(f"the ESW cell planned {type(fn).__name__}, not the hybrid")
        for bands in (1, 4):
            cases.append((f"esw {interp} {bands}b", fn, fn.crop(geo[:bands])))
    st = cases[0][1].state
    print(f"{tag} ESW cell hybrid plan: window {cases[0][1].window}, d_v {st.d_v}, d_h {st.d_h}, "
          f"col_tile {st.col_tile}, row_tile {st.row_tile}, out {st.out_h}x{st.out_w}")

    x4 = torch.from_numpy(rng.random((4, FLAGSHIP, FLAGSHIP), dtype=np.float32)).to(dev)
    coarse, coarse_gm, tgt = flagship_coarse(torch, x4, dev)
    for interp in ("bilinear", "nearest"):
        fn = port_reproject.device_reproject_fn(coarse_gm, tgt, interp, nan, dev)
        if not isinstance(fn, port_srw.AlignedSRWFn) or fn.kind != "aligned":
            raise AssertionError(f"the flagship planned {type(fn).__name__}, not the aligned SRW")
        for bands in (1, 4):
            cases.append((f"flagship {interp} {bands}b", fn, fn.crop(coarse[:bands])))
    st = cases[-1][1].state
    print(f"{tag} flagship aligned plan: coarse {tuple(coarse.shape[-2:])}, d_v {st.d_v}, "
          f"d_h {st.d_h}, out {st.out_h}x{st.out_w}")

    # -- timings ------------------------------------------------------------
    results = {}
    for what, fn, x in cases:
        hybrid = fn.kind == "hybrid"
        ref_v = (sa.srw_aligned_vertical_plain if not hybrid
                 else port_srw.srw_hybrid_vertical_plain)(*fn.vertical_args(x))
        ha = fn.horizontal_args(ref_v)
        ref_o = (sa.srw_aligned_horizontal_plain if not hybrid
                 else port_srw.srw_hybrid_horizontal_plain)(*ha)
        horiz = sa.srw_aligned_horizontal if not hybrid else port_srw.srw_hybrid_horizontal
        # the main path's pair: K15/K18 on K14/K17's own output (its flags)
        v_this, flags = fn.vertical(x)
        runs = {"this": (lambda: fn.vertical(x)[0], lambda: fn.horizontal(v_this, flags)),
                "this (value test)": (lambda: fn.vertical(x)[0], lambda: horiz(*ha))}
        if lib is not None:
            runs["tree"] = tree_calls(lib, fn, x)
        row = {}
        for name, (fv, fh) in runs.items():
            ok_v = equal(torch, fv(), ref_v)
            if name == "tree":
                fv().copy_(ref_v)  # TREE's horizontal reads its own v buffer
            row[name] = dict(ok_v=ok_v, ok_h=equal(torch, fh(), ref_o))
        order = ["tree", "this", "this", "tree"] if lib is not None else ["this"]
        times = {n: {"v": [], "h": []} for n in runs}
        for name in order + ["this (value test)"]:
            fv, fh = runs[name]
            if name == "tree":
                fv().copy_(ref_v)
            times[name]["v"].append(device_ms(torch, fv))
            times[name]["h"].append(device_ms(torch, fh))
        for name in runs:
            row[name]["v_ms"] = statistics.median(times[name]["v"])
            row[name]["h_ms"] = statistics.median(times[name]["h"])
        results[what] = row
        print(f"{tag} {what}: " + "; ".join(
            f"{n} v {r['v_ms']:.4f} h {r['h_ms']:.4f} ms"
            + ("" if r["ok_v"] and r["ok_h"] else f" (NOT EQUAL: v {r['ok_v']} h {r['ok_h']})")
            for n, r in row.items()))
        del ref_v, ref_o, v_this, flags
        torch.cuda.empty_cache()
    print(f"{tag} this tree's direct-kernel launches (the planner's alternative): "
          f"{dict(sa.DIRECT_LAUNCHES)}")
    walls = None
    if args.walls:
        del geo, x4, coarse, cases
        torch.cuda.empty_cache()
        _, err = tree_build.communicate(timeout=900)
        if tree_build.returncode:
            raise RuntimeError(f"TREE's library did not build:\n{err[-8000:]}")
        walls = walls_in_turns(args.against, tag)
    print(f"{tag} done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "results": results, "walls": walls}))
    return 0 if all(r["ok_v"] and r["ok_h"] for row in results.values()
                    for r in row.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
