#!/usr/bin/env python3
"""Time K7 (``ij_gather``, the rectify Phase B gather) over its launch
constants, beside ``F.grid_sample`` and, optionally, another tree's K7.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_ij_gather.py [--band] [--against
TREE]``.  It builds ``csrc/ij_gather.cu`` once per variant of its launch
constants (the ``constexpr int`` values named in ``VARIANTS``, or with
``--band`` in ``BAND_VARIANTS``), each into a library of its own under
``build/tune_ij_gather/`` (all ``nvcc`` processes started together), and
with ``--against`` also TREE's ``csrc/ij_gather.cu`` as it stands (an
unpacked parent commit, say: its C interface must be this one's).  It
prints the registers and spills ptxas gave each variant's kernels.

Without ``--band`` it times the map form (threads a block, bands a thread
at a time, blocks an SM) at R1 = BASELINE #4's shapes (the 1189 x 1890
OLCI-like swath's map onto its default 512-tiled grid, 1986 x 1462,
planned by the port; 16 float32 bands) for nearest, bilinear and
triangular, with ``F.grid_sample`` at the same positions for nearest and
bilinear.  With ``--band`` it times the band form (``kBand*``: pixels a
thread, bands a thread at a time, the register cap, threads a block) at
the sharded rectify's band 1 over a mesh of 4: R1's
(16 bands, nearest) and R3's (the 4865 x 4091 granule onto its 1024-tiled
grid, 21 bands, bilinear), each through K8's map, with ``F.grid_sample``
at the band's positions.  Each time is the mean of 10 launches queued
behind a sleep on the card (device time alone), the ruler of
``chip_smoke.py``'s ``device_ms``, taken in two passes over the variants
(forward, then backward), the lesser printed beside both; each variant's
output is checked equal to the first one's.  Every line carries the
card's name and power limit.  It exits nonzero when no CUDA device is
visible.
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

# (name, constants); the first variant is the source as it stands: "tN"
# blocks of N threads, "bN" N bands a thread at a time, "mN" at least N
# blocks an SM for float32 (registers capped at 65536 / (threads * N)),
# "m1" no cap
VARIANTS = (
    ("t256 b2 m8", {}),
    ("t256 b1 m8", {"kBands": 1}),
    ("t256 b4 m8", {"kBands": 4}),
    ("t256 b2 m1", {"kMinBlocks": 1}),
    ("t256 b4 m1", {"kBands": 4, "kMinBlocks": 1}),
    ("t128 b2 m16", {"kThreads": 128, "kMinBlocks": 16}),
    ("t512 b2 m4", {"kThreads": 512, "kMinBlocks": 4}),
)
# the band form's: "pN" N consecutive pixels a thread (bilinear and
# triangular; nearest: "nN"), "sN" N bands a thread at a time, "mN" at
# least N blocks an SM (m8: 32 registers, the map form's float32 cap,
# under which the band form first ran; m1: no cap), "tN" N threads a
# block, "start 0" the band loop from a constant start
BAND_VARIANTS = (
    ("p2 s2 m4", {}),
    ("p2 s2 m8", {"kBandMinBlocks": 8}),
    ("p2 s2 m6", {"kBandMinBlocks": 6}),
    ("p2 s2 m1", {"kBandMinBlocks": 1}),
    ("p2 s1 m4", {"kBandStep": 1}),
    ("p2 s4 m4", {"kBandStep": 4}),
    ("p1 s2 m4", {"kBandPixels": 1}),
    ("p4 s1 m4", {"kBandPixels": 4, "kBandStep": 1}),
    ("p2 n2 s2 m4", {"kBandPixelsNearest": 2}),
    ("p2 s2 m8 t128", {"kBandThreads": 128, "kBandMinBlocks": 8}),
    # the band loop from a constant 0 (the kernel reads its start from
    # blockIdx.y: see its note)
    ("p2 s2 m4 start 0", {"replace": [("  const int b_lo = blockIdx.y * a.batch;\n", ""),
                                      ("int b0 = b_lo;", "int b0 = 0;")]}),
)
METHODS = {"bilinear": 0, "nearest": 1, "triangular": 2}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def build_variants(out_dir: Path, source: str, variants, against: Path | None,
                   csrc: Path | None = None):
    """[(name, library, ptxas report)] of *source* (a file of *csrc*, by
    default this tree's ``csrc``) built once per variant of its
    ``constexpr int`` constants (a variant's ``"replace"`` entry, pairs of
    texts, each of which must occur once, edits the source besides); TREE's
    *source* as it stands last."""
    from xcube_resampling_tpu_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    csrc = csrc or _build.CSRC
    text0 = (csrc / source).read_text()
    stem0 = Path(source).stem
    sources = []
    for name, constants in variants:
        text = text0
        for const, value in constants.items():
            if const == "replace":
                for old, new in value:
                    if text.count(old) != 1:
                        raise ValueError(f"{source}: {old!r} does not occur once")
                    text = text.replace(old, new)
                continue
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if n != 1:
                raise ValueError(f"{source} defines no {const}")
        stem = f"{stem0}.{name.replace(' ', '_')}"
        (out_dir / f"{stem}.cu").write_text(text)
        sources.append((name, out_dir / f"{stem}.cu", csrc, out_dir / f"{stem}.so"))
    if against is not None:
        csrc = against / "xcube_resampling_tpu_torch" / "csrc"
        sources.append((f"{against.name}", csrc / source, csrc,
                        out_dir / f"{stem0}.against.so"))
    procs = [
        (name, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{inc}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, src, inc, lib in sources
    ]
    built = []
    for name, lib, proc in procs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n{log}")
        built.append((name, ctypes.CDLL(str(lib)), log))
    return built


def spills(log: str) -> str:
    """The kernels of a ptxas report that spill: their template arguments
    (method code, data type) and spill bytes."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        spill = re.search(r"(\d+) bytes spill stores", entry)
        if spill and int(spill.group(1)):
            args = re.search(r"ILi(\d)E(\w+?)E", entry.split("'", 1)[0])
            out.append(f"{args.group(1)}/{args.group(2)} {spill.group(1)} B" if args
                       else f"{spill.group(1)} B")
    return ", ".join(out) or "none"


def band_registers(log: str) -> str:
    """Registers, spill bytes and stack frame of the band-form kernels of
    a ptxas report, by method code."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        kernel = re.search(r"ij_gather_band_kernelILi(\d)E", entry.split("'", 1)[0])
        if kernel:
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            stack = re.search(r"(\d+) bytes stack frame", entry)
            out.append(f"method {kernel.group(1)}: {regs.group(1) if regs else '?'} regs, "
                       f"{spill.group(1) if spill else 0} B spilled, "
                       f"{stack.group(1) if stack else 0} B stack")
    return "; ".join(out) or "no band kernel (the tree's shares the map form's)"


def float_registers(log: str) -> str:
    """Registers of the float32 kernels of a ptxas report, and the spills."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        kernel = re.search(r"_kernelILi(\d)EfE", entry.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", entry)
        if kernel:
            out.append(f"method {kernel.group(1)}: {regs.group(1) if regs else '?'} regs")
    return "; ".join(out) + f"; spills: {spills(log)}"


def device_ms(call) -> float:
    """Mean device ms of *call* over 10 calls queued behind a sleep on the
    card that outlasts their enqueueing."""
    import torch

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * min(20 * host_s, 1.0)))
    a.record()
    for _ in range(10):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 10


def olci_swath(width, height, tile_size=512):
    """The OLCI-like swath of tests/sampledata.py (create_olci_like_swath):
    2D lon/lat at about 0.0025 deg and a float32 radiance band, a port
    Dataset in *tile_size*-pixel chunks."""
    from xcube_resampling_tpu_torch import DataArray, Dataset

    j = np.arange(height, dtype=np.float64)[:, None]
    i = np.arange(width, dtype=np.float64)[None, :]
    res = 0.0025
    lon = 4.0 + res * (i + 0.12 * j + 2e-5 * j * i)
    lat = 62.0 - res * (j - 0.08 * i + 1.2e-5 * (i - width / 2) ** 2)
    rad = (np.sin(0.01 * i) * np.cos(0.013 * j) * 50 + 100).astype(np.float32)
    return Dataset({"rad": DataArray(rad, dims=("y", "x"))}, coords={
        "lon": DataArray(lon, dims=("y", "x")), "lat": DataArray(lat, dims=("y", "x")),
    }).chunk({"y": tile_size, "x": tile_size})


def r1_positions(dev):
    """R1's Phase B positions: the port's map of the 1189 x 1890 OLCI-like
    swath onto its default 512-tiled grid, cast as the map form takes it,
    and the swath's radiance band."""
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch import rectify as port_rectify
    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.ops import rectify_ops

    ds = olci_swath(1189, 1890)
    gm = GridMapping.from_dataset(ds)
    m = port_rectify._inverse_ij_map(gm, gm.to_regular(tile_size=512), UV_DELTA, dev,
                                     tier="host")
    rad = np.asarray(ds["rad"].data)
    fn = rectify_ops.make_device_var_image_fn(m, rad.shape, float("nan"), "nearest",
                                              device=dev)
    return fn.ix, fn.iy, fn.valid, torch.from_numpy(rad).to(dev)


def band_cell(dev, width, height, tile_size, n_bands, method, mesh_n=4):
    """Band 1's K7 band-form arguments of the sharded rectify over a mesh of
    *mesh_n* entries on *dev*, through K8's map, as ``chip_smoke.py`` takes
    them, and an ``F.grid_sample`` call at the band's positions."""
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch import rectify as port_rectify
    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.parallel import make_mesh, make_sharded_rectify_step

    ds = olci_swath(width, height, tile_size)
    gm = GridMapping.from_dataset(ds)
    tgt = gm.to_regular(tile_size=tile_size)
    m = port_rectify._inverse_ij_map(gm, tgt, UV_DELTA, dev, tier="device").device_map()
    rad = torch.from_numpy(np.asarray(ds["rad"].data)).to(dev)
    x = torch.stack([rad + k for k in range(n_bands)])
    step, (pad, _) = make_sharded_rectify_step(make_mesh(devices=[dev] * mesh_n), m,
                                               (gm.height, gm.width), interp_method=method,
                                               src_batch_dims=1)
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad), value=float("nan"))
    bands, _ = step.bands(xp)
    g_args = step.gather_args(bands, step.exchange(bands), 1)
    ext, mb, off = g_args[0], g_args[1].nan_to_num(0.0), g_args[4]
    grid = torch.stack((mb[0].clamp(0, gm.width - 1) / (gm.width - 1) * 2 - 1,
                        (mb[1].clamp(0, gm.height - 1) - off) / (ext.shape[-2] - 1) * 2 - 1),
                       dim=-1)[None]

    def lib_call():
        return torch.nn.functional.grid_sample(ext[None], grid, mode=method,
                                               padding_mode="border", align_corners=True)

    return g_args, lib_call


def tune_band(card, dev, built) -> None:
    """Time each variant's band form at R1's and R3's band 1."""
    import torch

    for cell, shape in (("R1", (1189, 1890, 512, 16, "nearest")),
                        ("R3", (4865, 4091, 1024, 21, "bilinear"))):
        (ext, m, method, fill, off, src_h), lib_call = band_cell(dev, *shape)
        batch, ext_h, src_w = ext.shape
        out_h, out_w = m.shape[-2:]
        out = torch.empty((batch, out_h, out_w), dtype=torch.float32, device=dev)
        print(f"[{card}] {cell} band 1: {batch} x ext {ext_h}x{src_w} from row {off} -> "
              f"{out_h}x{out_w}, {method}")
        first = None
        times = {}
        for name, lib, _ in built + built[::-1]:
            def call(lib=lib, name=name):
                rc = lib.xrt_ij_gather_band(
                    ctypes.c_void_p(ext.data_ptr()), ctypes.c_void_p(m.data_ptr()),
                    ctypes.c_void_p(out.data_ptr()), ctypes.c_int64(batch),
                    ctypes.c_int64(ext_h), ctypes.c_int64(src_w), ctypes.c_int64(out_h),
                    ctypes.c_int64(out_w), ctypes.c_int64(off), ctypes.c_int64(src_h),
                    ctypes.c_int(METHODS[method]), ctypes.c_double(fill), ctypes.c_int64(0),
                    ctypes.c_int(0),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if rc:
                    raise RuntimeError(f"K7 band {name}: launch failed ({rc})")

            call()
            torch.cuda.synchronize()
            if first is None:
                first = out.clone()
            elif not torch.equal(out.nan_to_num(-1e30), first.nan_to_num(-1e30)):
                raise AssertionError(f"K7 band {name} differs from the first variant ({cell})")
            times.setdefault(name, []).append(device_ms(call))
        for name, (t1, t2) in times.items():
            print(f"[{card}] K7 band {name:12s} {cell} {method:9s}: {min(t1, t2):.4f} ms device "
                  f"(passes {t1:.4f}, {t2:.4f})")
        print(f"[{card}] F.grid_sample {cell} {method}: {device_ms(lib_call):.4f} ms device")
        del ext, m, out, first


def main() -> int:
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a tree whose csrc/ij_gather.cu is built and timed as well")
    parser.add_argument("--band", action="store_true",
                        help="tune the band form at the sharded rectify's band shapes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_ij_gather: no CUDA device is visible", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = build_variants(ROOT / "build" / "tune_ij_gather", "ij_gather.cu",
                           BAND_VARIANTS if args.band else VARIANTS, args.against)
    if args.band:
        print(f"[{card}] {len(built)} variants of K7's band form built in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, _, log in built:
            print(f"[{card}] K7 band {name}: {band_registers(log)}")
        tune_band(card, dev, built)
        return 0
    print(f"[{card}] {len(built)} variants of K7 built in {time.perf_counter() - t0:.1f} s")
    for name, _, log in built:
        print(f"[{card}] K7 {name}: {float_registers(log)}")
    ix, iy, valid, rad = r1_positions(dev)
    bands = rad[None].expand(16, -1, -1).contiguous()
    batch, src_h, src_w = bands.shape
    out_h, out_w = ix.shape
    out = torch.empty((batch, out_h, out_w), dtype=torch.float32, device=dev)
    print(f"[{card}] R1: 16 x {src_h}x{src_w} float32 -> {out_h}x{out_w}, "
          f"{valid.float().mean().item():.4f} of the map valid")
    grid = torch.stack((ix / (src_w - 1) * 2 - 1, iy / (src_h - 1) * 2 - 1), dim=-1)[None]
    for method, code in METHODS.items():
        first = None
        times = {}
        for name, lib, _ in built + built[::-1]:
            def call(lib=lib, name=name):
                rc = lib.xrt_ij_gather(
                    ctypes.c_void_p(bands.data_ptr()), ctypes.c_void_p(ix.data_ptr()),
                    ctypes.c_void_p(iy.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
                    None, None, ctypes.c_void_p(out.data_ptr()), ctypes.c_int64(ix.numel()),
                    ctypes.c_int64(batch), ctypes.c_int64(src_h), ctypes.c_int64(src_w),
                    ctypes.c_int64(out_w), ctypes.c_int64(ix.numel()), ctypes.c_int(code),
                    ctypes.c_double(float("nan")), ctypes.c_int64(0), ctypes.c_int(0),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if rc:
                    raise RuntimeError(f"K7 {name}: launch failed ({rc})")

            call()
            torch.cuda.synchronize()
            if first is None:
                first = out.clone()
            elif not torch.equal(out.nan_to_num(-1e30), first.nan_to_num(-1e30)):
                raise AssertionError(f"K7 {name} differs from the first variant ({method})")
            times.setdefault(name, []).append(device_ms(call))
        for name, (t1, t2) in times.items():
            print(f"[{card}] K7 {name:12s} {method:10s} at R1: {min(t1, t2):.4f} ms device "
                  f"(passes {t1:.4f}, {t2:.4f})")
        if method != "triangular":
            def lib_call(mode=method):
                return F.grid_sample(bands[None], grid, mode=mode, padding_mode="border",
                                     align_corners=True)

            print(f"[{card}] F.grid_sample {method:10s} at R1: {device_ms(lib_call):.4f} ms "
                  f"device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
