#!/usr/bin/env python3
"""Time the exact separable warp's kernels, K13 ``esw_gather``, its band
form ``esw_gather_band`` and K16 ``esw_mosaic`` (``csrc/esw_gather.cu``,
``csrc/esw_mosaic.cu``, their per-pixel body and staged tile in
``csrc/esw_pixel.h``), at the shapes ``chip_smoke.py`` drives.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_esw.py [--against TREE]``.  The
cells:

* the ESW cell: the EPSG:4326 0.05 deg global source (7200 x 3600) onto
  EPSG:3035 4096^2 at 937.5 m from (2.5e6, 1.4e6), K13 on its 860 x 1841
  window, every method, 1 and 4 bands;
* the sheared target: the same source onto EPSG:3035 512^2 at 4 km from
  the same origin (``chip_smoke.ESW_SHEARED``), where most tiles span more
  window columns than the stage holds and take the per-pixel body, K13
  every method at 1 band;
* BASELINE #3: the same source onto EPSG:3035 4096^2 at 1500 m from (2e6,
  1e6), K16 over the exact region mosaic's 63 ESW and 7 gather pieces,
  every method at 1 band and bilinear at 4;
* the band cells: band 1 of the ESW cell's sharded step over a mesh of 4
  entries on the card (extension 603 x 1841 from source row 21, output
  rows 1024-2047 of the 4096^2 target), K13's band form, every method at
  1 band and bilinear at 4; band 1 of the same over 8 entries (512 rows:
  tiles of 11 rows, ``ops.esw.band_tile_rows``), bilinear; and bands 1
  and 2 of the sheared target's step over 4 entries (128 rows: tiles of
  2 rows, every anchor per pixel), every method at 1 band.

This tree's two sources are built into a library of their own (and with
``--against TREE``, e.g. the parent unpacked with ``git archive``, TREE's
too), and ``esw_gather.cu`` once more for each entry of ``BAND_BUILDS``
(the band kernel's launch bounds), every nvcc started together; all
are called through their C entries: this tree's staged (``this``) and
with no stage (``per pixel``: every tile through the per-pixel body),
TREE's (its band form takes no flag), and, on the band cell, each build of
``BAND_BUILDS`` staged, in turns (the order and then the order reversed:
tree, this, per pixel, builds..., builds..., per pixel, this, tree).  Each
kernel's device ms is the mean of 10 warm launches queued behind a sleep
on the card (``chip_smoke.py``'s ruler), the median of its turns; every
output is held to the plain version's bit for bit.  The share of tiles
staged is printed per cell as ``ops.esw.tile_spans`` models it from the
inputs.
Every line carries the card's name and power limit; the last line is one
JSON object with the times.  It exits nonzero when no CUDA device is
visible or an output differs.
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
ESW_TARGET = dict(size=(4096, 4096), xy_min=(2500000.0, 1400000.0), xy_res=937.5,
                  crs="epsg:3035")
B3_TARGET = dict(size=(4096, 4096), xy_min=(2000000.0, 1000000.0), xy_res=1500.0,
                 crs="epsg:3035")
SOURCES = ("esw_gather.cu", "esw_mosaic.cu")
METHODS = ("bilinear", "nearest", "triangular")
# the band kernel's constants (csrc/esw_gather.cu), each built beside the
# source as it stands: its launch bounds at 14 blocks an SM (72 registers,
# as K13; 12 as it stands), and the fewest rows a tile stages in (8 as it
# stands) at 16 and 2
BAND_BUILDS = (
    ("blocks14", {"kBandBlocks": 14}),
    ("stage16", {"kBandStageRows": 16}),
    ("stage2", {"kBandStageRows": 2}),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def build_all(trees: dict[str, Path], out_dir: Path) -> dict:
    """{name: (library, ptxas report)}: the two sources of each csrc
    directory built into one library, its C entries typed (TREE's as
    ``chip_smoke.TREE_ESW_SIGNATURES``), and this tree's ``esw_gather.cu``
    once for each entry of ``BAND_BUILDS``, its constants replaced; every
    nvcc started together."""
    from chip_smoke import TREE_ESW_SIGNATURES
    from xcube_resampling_tpu_torch import _build

    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: (csrc, [csrc / f for f in SOURCES]) for name, csrc in trees.items()}
    text = (_build.CSRC / "esw_gather.cu").read_text()
    for name, constants in BAND_BUILDS:
        t = text
        for const, value in constants.items():
            t, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};", t)
            if n != 1:
                raise ValueError(f"esw_gather.cu defines no {const}")
        cu = out_dir / f"{name}.cu"
        cu.write_text(t)
        jobs[name] = (_build.CSRC, [cu])
    procs = {}
    for name, (include, sources) in jobs.items():
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{include}", "-o", str(lib),
             *map(str, sources)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    types = {"p": ctypes.c_void_p, "q": ctypes.c_int64, "i": ctypes.c_int, "f": ctypes.c_float}
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-20000:]}")
        library = ctypes.CDLL(str(lib))
        for entry, tree_types in TREE_ESW_SIGNATURES.items():
            if hasattr(library, entry):
                getattr(library, entry).argtypes = (
                    [types[t] for t in tree_types] if name == "tree"
                    else _build._SIGNATURES[entry])
        built[name] = (library, log)
    return built


def registers(log: str) -> str:
    """Registers and spill bytes of each K13 and K16 kernel in a ptxas
    report, by kernel and method code."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        kind = next((k for k in ("band", "gather", "mosaic") if k in name), None)
        if kind is None or "esw" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        method = re.search(r"ILi(\d)E", name)
        out.append(f"{kind}{method.group(1) if method else ''}:"
                   f"{regs.group(1) if regs else '?'}r/{spill.group(1) if spill else 0}s")
    return " ".join(out)


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


def equal(torch, a, b) -> bool:
    """Bit for bit, NaN masks included."""
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.where(torch.isnan(a), 0, a.view(torch.int32)),
                                torch.where(torch.isnan(b), 0, b.view(torch.int32))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a tree whose K13 and K16 to time beside this one's")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        ESW_SHEARED,
        esw_band_entry_call,
        esw_bound,
        esw_entry_call,
        esw_spans,
        mosaic_bound,
        mosaic_entry_call,
        mosaic_spans,
        staged_share,
    )
    from xcube_resampling_tpu_torch import GridMapping, _build
    from xcube_resampling_tpu_torch.ops.esw import (
        BAND_STAGE_ROWS,
        band_tile_rows,
        esw_gather_band_plain,
        esw_gather_plain,
        make_esw_reproject_fn,
        tile_spans,
    )
    from xcube_resampling_tpu_torch.ops.esw_mosaic import esw_mosaic_plain, make_esw_region_fn
    from xcube_resampling_tpu_torch.parallel import make_mesh, make_sharded_esw_step
    from xcube_resampling_tpu_torch.parallel.halo import crop_source

    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    t0 = time.perf_counter()
    trees = {"this": _build.CSRC}
    if args.against is not None:
        trees["tree"] = args.against / "xcube_resampling_tpu_torch" / "csrc"
    built = build_all(trees, ROOT / "build" / "tune_esw")
    lib = {name: library for name, (library, _) in built.items()}
    print(f"{tag} {len(lib)} builds in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        print(f"{tag} {name}: {registers(log)}")

    nan = float("nan")
    rng = np.random.default_rng(20)
    geo_gm = GridMapping.regular(size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05,
                                 crs="epsg:4326")
    geo = torch.from_numpy(rng.random((4, 3600, 7200), dtype=np.float32)).to(dev)
    results, shares, failed = {}, {}, []

    def timed(what, runs, ref):
        """Device ms of each run in turns (tree, this, per pixel, the
        builds, then the same reversed), each output held to *ref* bit for
        bit."""
        order = [n for n in ("tree", "this", "per pixel") if n in runs]
        order += [n for n in runs if n not in order]
        order += order[::-1]
        row = {}
        for name, run in runs.items():
            got = run()
            ok = equal(torch, got, ref)
            row[name] = dict(ok=ok, max_abs=float((got - ref).abs().nan_to_num(0.0).max()),
                             ms=[])
            if not ok:
                failed.append(f"{what} {name}")
        for name in order:
            row[name]["ms"].append(device_ms(torch, runs[name]))
        for r in row.values():
            r["ms"] = statistics.median(r["ms"])
        results[what] = row
        print(f"{tag} {what}: " + "; ".join(
            f"{n} {r['ms']:.4f}" + ("" if r["ok"] else f" (differs: {r['max_abs']:.3g})")
            for n, r in row.items()))

    # -- K13: the ESW cell and the sheared target ------------------------------
    cells = (("esw", GridMapping.regular(**ESW_TARGET), (1, 4)),
             ("sheared", GridMapping.regular(**ESW_SHEARED), (1,)))
    for where, target, band_counts in cells:
        for interp in METHODS:
            fn = make_esw_reproject_fn(geo_gm, target, interp, nan, device=dev)
            if fn is None or fn.window is None:
                raise AssertionError(f"plan_esw refused the {where} cell")
            for bands in band_counts:
                a = fn.args(fn.crop(geo[:bands]))
                runs = {"this": esw_entry_call(lib["this"], a, True),
                        "per pixel": esw_entry_call(lib["this"], a, False)}
                if "tree" in lib:
                    runs["tree"] = esw_entry_call(lib["tree"], a, True)
                what = f"K13 {where} {interp} {bands}b"
                timed(what, runs, esw_gather_plain(*a))
                results[what]["bound_ms"] = esw_bound(a)
                if bands == 1:
                    shares[what] = staged_share(esw_spans(a), interp)
                print(f"{tag} {what}: bound {results[what]['bound_ms'][0]:.4f} ms "
                      f"({results[what]['bound_ms'][1]}); tiles staged (modelled) "
                      f"{shares[f'K13 {where} {interp} 1b']:.4f}")
                del runs
            torch.cuda.empty_cache()

    # -- BASELINE #3: K16 ----------------------------------------------------------
    b3 = GridMapping.regular(**B3_TARGET)
    for interp, bands in (("bilinear", 1), ("nearest", 1), ("triangular", 1), ("bilinear", 4)):
        fn = make_esw_region_fn(geo_gm, b3, interp, nan, device=dev)
        if fn is None:
            raise AssertionError("BASELINE #3 planned no mosaic")
        x = geo[:bands].contiguous()
        runs = {"this": mosaic_entry_call(lib["this"], fn, x, True),
                "per pixel": mosaic_entry_call(lib["this"], fn, x, False)}
        if "tree" in lib:
            runs["tree"] = mosaic_entry_call(lib["tree"], fn, x, True)
        what = f"K16 b3 {interp} {bands}b"
        timed(what, runs, esw_mosaic_plain(*fn.args(x)))
        if bands == 1:
            b_ms, basis, _ = mosaic_bound(fn, interp)
            results[what]["bound_ms"] = (b_ms, basis)
            shares[what] = staged_share(mosaic_spans(fn, interp), interp)
            print(f"{tag} {what}: bound {b_ms:.4f} ms ({basis}); tiles staged (modelled) "
                  f"{shares[what]:.4f}")
        del runs
        torch.cuda.empty_cache()
    # -- the band cells: K13's band form at the ESW cell's band 1 over 4 and
    # 8 bands, and at bands 1 and 2 of the sheared target ------------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cells = [("band", ESW_TARGET, m, 1, 1, 4) for m in METHODS]
    cells += [("band", ESW_TARGET, "bilinear", 4, 1, 4),
              ("8-band", ESW_TARGET, "bilinear", 1, 1, 8)]
    cells += [("sheared band", ESW_SHEARED, m, 1, k, 4) for m in METHODS for k in (1, 2)]
    for where, target, interp, bands, k, n in cells:
        target = GridMapping.regular(**target)
        xc, geo_c = crop_source(geo[:bands], geo_gm, target)
        step, (pad, _) = make_sharded_esw_step(make_mesh(devices=[dev] * n), geo_c, target,
                                               interp_method=interp, src_batch_dims=1)
        parts, _ = step.bands(torch.nn.functional.pad(xc, (0, 0, 0, pad), value=nan))
        a = step.gather_args(parts, step.exchange(parts), k)
        runs = {"this": esw_band_entry_call(lib["this"], a, True),
                "per pixel": esw_band_entry_call(lib["this"], a, False)}
        if "tree" in lib:
            runs["tree"] = esw_band_entry_call(lib["tree"], a, True)
        for name, _ in BAND_BUILDS:
            runs[name] = esw_band_entry_call(lib[name], a, True)
        what = f"K13 {where} {k} {interp} {bands}b"
        timed(what, runs, esw_gather_band_plain(*a))
        results[what]["bound_ms"] = esw_bound(a, band=True)
        width = a[0].shape[-1]
        rows = band_tile_rows(a[6], a[7], sms)
        shares[what] = staged_share(tile_spans(a[2], a[4], a[6], a[7], width, 0, width, interp,
                                               row0=a[10], tile_rows=rows), interp) if (
            rows >= BAND_STAGE_ROWS) else 0.0
        print(f"{tag} {what} (ext {tuple(a[0].shape)} from row {a[11]}, rows {a[10]}-"
              f"{a[10] + a[6] - 1}, tiles of {rows} rows): bound "
              f"{results[what]['bound_ms'][0]:.4f} ms ({results[what]['bound_ms'][1]}); tiles "
              f"staged (modelled) {shares[what]:.4f}")
        del runs, parts, a, step
        torch.cuda.empty_cache()
    print(f"{tag} done in {time.perf_counter() - t0:.1f} s; outputs differing: "
          f"{failed or 'none'}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "results": results, "modelled_staged_share": shares}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
