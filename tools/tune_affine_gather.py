#!/usr/bin/env python3
"""Time K4's downscale form over its builds and kernels, beside K4 and
another tree's downscale form.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_affine_gather.py [--against TREE]``.
It builds ``csrc/affine_gather_reduce.cu`` once per entry of ``BUILDS``
(its ``constexpr int`` constants replaced: the taps not rounded to the
source type, a ceiling whose output is not checked) and
``csrc/affine_gather.cu`` once per entry of ``K4_BUILDS``, each into a
library of its own under ``build/tune_affine_gather/`` (all ``nvcc``
processes started together), and with ``--against`` TREE's
``csrc/affine_gather_reduce.cu`` as it stands (e.g. an unpacked parent,
called through its own C entry, the one without the route argument: the
parent's kernel reads each tap's column and fraction from shared memory,
this tree's keeps them in registers).  It prints the registers, spills and
stack ptxas gave each build's float32 cached kernels, then times the
downscale form at the pre-downscale (20480^2 float32 -> 5050 x 5054, 5 x 5
windows at the residual scales 0.8111 and 0.8104), BASELINE #1 (16 x
1024^2 -> 512^2, 2 x 2), BASELINE #2 (4 x 4096^2 -> 1024^2, 4 x 4: mean,
std, first) and a wide window (4 x 4096^2 -> 379^2, 12 x 12 at 0.9): every
build through the kernel ``ops/gather.py`` plans, the default build also
through the direct kernel, beside TREE's.  Each time is the mean of 10
launches queued behind a sleep on the card (device time alone,
``chip_smoke.py``'s ``device_ms``); every output but the ceiling's is
checked equal to the default build's, TREE's too.  K4's builds are timed
at BASELINE #2's ``c``, BASELINE #1 and the pre-downscale's inflated
image.  Every line carries the card's name and power limit.  It exits
nonzero when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> constants of csrc/affine_gather_reduce.cu; the first is the source
# as it stands
BUILDS = (
    ("default", {}),
    ("not rounded (ceiling)", {"kRound": 0}),
)
K4_BUILDS = (
    ("rows8 t128", {}),
    ("rows4 t128", {"kTileRows": 4}),
    ("rows8 t256", {"kThreads": 256}),
)
_I64, _I, _D, _P = ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_void_p
# the downscale form's C entry without the route argument (the parent's)
OLD_SIGNATURE = [_P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _D, _D, _D,
                 _D, _D, _I, _I64, _I64, _I, _P]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def build_all(out_dir: Path, against: Path | None):
    """(source, name, library, ptxas log) of every build."""
    from xcube_resampling_tpu_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = []
    for source, builds in (("affine_gather_reduce.cu", BUILDS), ("affine_gather.cu", K4_BUILDS)):
        text0 = (_build.CSRC / source).read_text()
        for name, constants in builds:
            text = text0
            for const, value in constants.items():
                text, n = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
                if n != 1:
                    raise ValueError(f"{source} defines no {const}")
            stem = f"{Path(source).stem}.{re.sub(r'[^A-Za-z0-9]+', '_', name)}"
            (out_dir / f"{stem}.cu").write_text(text)
            jobs.append((source, name, out_dir / f"{stem}.cu", _build.CSRC))
    if against is not None:
        csrc = against / "xcube_resampling_tpu_torch" / "csrc"
        jobs.append(("against", against.name, csrc / "affine_gather_reduce.cu", csrc))
    procs = []
    for source, name, cu, include in jobs:
        lib = out_dir / f"{cu.stem}{'.against' if source == 'against' else ''}.so"
        procs.append((source, name, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{include}", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for source, name, lib, proc in procs:
        log, _ = proc.communicate(timeout=1200)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n{log[-20000:]}")
        built.append((source, name, ctypes.CDLL(str(lib)), log))
    return built


def cached_registers(log: str) -> str:
    """Registers, spill and stack bytes of the float32 cached kernels (mean
    and std, each width), from a ptxas report."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        mangled = entry.split("'", 1)[0]
        m = re.search(r"affine_gather_reduce_cached_f32ILi(\d)ELi(\d+)E", mangled)
        if not m or m.group(1) not in ("0", "2"):
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        stack = re.search(r"(\d+) bytes stack frame", entry)
        agg = {"0": "mean", "2": "std"}[m.group(1)]
        out.append(f"{agg}/{m.group(2)}: {regs.group(1) if regs else '?'} regs "
                   f"{spill.group(1) if spill else 0} B spilled "
                   f"{stack.group(1) if stack else 0} B stack")
    return "; ".join(out)


def main() -> int:
    import torch

    from xcube_resampling_tpu_torch.ops import gather as G
    from xcube_resampling_tpu_torch.ops.coarsen_ops import REDUCERS, pick_tap
    from xcube_resampling_tpu_torch.ops.coarsen_ops import out_dtype as reduce_dtype
    from xcube_resampling_tpu_torch._build import _SIGNATURES

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="another checkout whose downscale form is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_affine_gather: no CUDA device is visible", file=sys.stderr)
        return 2
    card = card_line()
    tag = f"[{card}]"
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = build_all(ROOT / "build" / "tune_affine_gather", args.against)
    print(f"{tag} {len(built)} builds in {time.perf_counter() - t0:.1f} s")
    for source, name, lib, log in built:
        if source == "affine_gather_reduce.cu":
            print(f"{tag} {name}: {cached_registers(log)}")
            lib.xrt_affine_gather_reduce.argtypes = _SIGNATURES["xrt_affine_gather_reduce"]
        elif source == "against":
            lib.xrt_affine_gather_reduce.argtypes = OLD_SIGNATURE
        else:
            lib.xrt_affine_gather.argtypes = _SIGNATURES["xrt_affine_gather"]

    def device_ms(call) -> float:
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

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    gen = torch.Generator(device=dev).manual_seed(0)
    big = torch.rand((1, 20480, 20480), generator=gen, device=dev)
    b1 = torch.rand((16, 1024, 1024), generator=gen, device=dev)
    b2 = torch.rand((4, 4096, 4096), generator=gen, device=dev)
    b2c = torch.randint(0, 16, (4, 4096, 4096), generator=gen, device=dev, dtype=torch.int32)
    nan = float("nan")
    # (what, source, (out_h, out_w, j_div, i_div, j_scale, i_scale, j_off, i_off), agg)
    cases = (
        ("pre-downscale mean 5x5 20480^2 -> 5050x5054", big,
         (5050, 5054, 5, 5, 0.8111, 0.8104, 0.2, 0.3), "mean"),
        ("B1 mean 2x2 16x1024^2 -> 512^2", b1, (512, 512, 2, 2, 1.0, 1.0, 0.0, 0.0), "mean"),
        ("B2 mean 4x4 4x4096^2 -> 1024^2", b2, (1024, 1024, 4, 4, 1.0, 1.0, 0.0, 0.0), "mean"),
        ("B2 std 4x4 4x4096^2 -> 1024^2", b2, (1024, 1024, 4, 4, 1.0, 1.0, 0.0, 0.0), "std"),
        ("B2 first 4x4 4x4096^2 -> 1024^2", b2, (1024, 1024, 4, 4, 1.0, 1.0, 0.0, 0.0), "first"),
        ("wide mean 12x12 at 0.9 4x4096^2 -> 379^2", b2,
         (379, 379, 12, 12, 0.9, 0.9, 0.1, 0.1), "mean"),
    )
    default = next(lib for s, n, lib, _ in built if s == "affine_gather_reduce.cu")
    for what, src, case, agg in cases:
        oh, ow, jd, idv, js, is_, jo, io = case
        batch, h, w = src.shape
        out = torch.empty((batch, oh, ow), dtype=reduce_dtype(src.dtype, agg), device=dev)
        pa, pb = pick_tap(agg, jd, idv)
        head = (ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(out.data_ptr()), batch, h, w,
                h * w, w, oh, ow, jd, idv, js, is_, jo, io, nan, REDUCERS[agg], pa, pb, 0)
        route = G.plan_gather_reduce(ow, idv, is_, io, w, agg)
        print(f"{tag} {what}: planned the {route} kernel")
        runs = [(name, lib, route) for source, name, lib, _ in built
                if source == "affine_gather_reduce.cu"]
        if route != "direct":
            runs.append(("default, direct kernel", default, "direct"))
        runs += [(f"against {name}", lib, None) for source, name, lib, _ in built
                 if source == "against"]
        ref = None
        for name, lib, p in runs:
            def call(lib=lib, p=p, name=name):
                if p is None:
                    rc = lib.xrt_affine_gather_reduce(*head, stream())
                else:
                    rc = lib.xrt_affine_gather_reduce(*head, G.ROUTES[p], stream())
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

            call()
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone()
                check = "the reference"
            elif "ceiling" in name or "ablation" in name:
                check = "not checked"
            elif torch.equal(torch.nan_to_num(out, 7.0), torch.nan_to_num(ref, 7.0)) and \
                    torch.equal(torch.isnan(out), torch.isnan(ref)):
                check = "equal"
            else:
                raise AssertionError(f"{name} differs from the default build at {what}")
            print(f"{tag}   {name:32s} {device_ms(call):.4f} ms device ({check})")
        del out, ref
        torch.cuda.empty_cache()
    # K4's builds at its shapes on the main path
    for what, src, (oh, ow), (js, is_, jo, io), code in (
        ("K4 B2 c identity 4x4096^2 int32", b2c, (4096, 4096), (1.0, 1.0, 0.0, 0.0), 4),
        ("K4 B1 identity 16x1024^2 float32", b1, (1024, 1024), (1.0, 1.0, 0.0, 0.0), 0),
        ("K4 pre-downscale 20480^2 -> 25250x25270 float32", big, (25250, 25270),
         (0.8111, 0.8104, 0.2, 0.3), 0),
    ):
        batch, h, w = src.shape
        out = torch.empty((batch, oh, ow), dtype=src.dtype, device=dev)
        first = None
        for source, name, lib, _ in built:
            if source != "affine_gather.cu":
                continue

            def call(lib=lib, name=name):
                rc = lib.xrt_affine_gather(
                    ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(out.data_ptr()), batch, h, w,
                    h * w, w, oh, ow, js, is_, jo, io, 1, -1.0, 0, code, code, stream())
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

            call()
            torch.cuda.synchronize()
            if first is None:
                first = out.clone()
            elif not torch.equal(out, first):
                raise AssertionError(f"K4 {name} differs at {what}")
            print(f"{tag} {what} {name:12s} {device_ms(call):.4f} ms device")
        del out, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
