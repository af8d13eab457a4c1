#!/usr/bin/env python3
"""Time K4 (the affine gather) and its downscale form over their launch
constants.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_affine_gather.py``.  It builds
``csrc/affine_gather.cu`` and ``csrc/affine_gather_reduce.cu`` once per
variant of their launch constants (the ``constexpr int`` values named in
``VARIANTS``), each into a library of its own under
``build/tune_affine_gather/`` (all ``nvcc`` processes started together),
prints the registers ptxas gave each variant's kernels for float32, and
times each variant at the main path's shapes: K4 at BASELINE #2's ``c``
(4 x 4096^2 int32, the identity bilinear gather launched before K6), at
BASELINE #1 (16 x 1024^2 float32, identity) and at the pre-downscale's
inflated image (20480^2 float32 -> 25250 x 25270 at the residual scales
0.8111, 0.8104); the downscale form's ``mean`` at the pre-downscale (5 x
5 windows at those scales), BASELINE #1 (2 x 2) and BASELINE #2 (4 x 4 of
4 x 4096^2).  Each time is the mean of 10 launches queued behind a sleep
on the card (device time alone), the ruler of ``chip_smoke.py``'s
``device_ms``; every variant's output is checked equal to the first
one's.  Every line carries the card's name and power limit.  It exits
nonzero when no CUDA device is visible.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# source -> (name, constants); the first variant of each is the source as
# it stands
VARIANTS = {
    "affine_gather.cu": (
        ("rows8 t128", {"kTileRows": 8, "kThreads": 128}),
        ("rows4 t128", {"kTileRows": 4}),
        ("rows16 t128", {"kTileRows": 16}),
        ("rows8 t64", {"kThreads": 64}),
        ("rows8 t256", {"kThreads": 256}),
    ),
    "affine_gather_reduce.cu": (
        ("t128", {"kThreads": 128}),
        ("t64", {"kThreads": 64}),
    ),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def build_variants(out_dir: Path) -> dict[str, list[tuple[str, ctypes.CDLL, str]]]:
    """Every variant's library and ptxas report, by source."""
    from xcube_resampling_tpu_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = []
    for source, variants in VARIANTS.items():
        text0 = (_build.CSRC / source).read_text()
        for name, constants in variants:
            text = text0
            for const, value in constants.items():
                text, n = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
                if n != 1:
                    raise ValueError(f"{source} defines no {const}")
            stem = f"{Path(source).stem}.{name.replace(' ', '_')}"
            (out_dir / f"{stem}.cu").write_text(text)
            lib = out_dir / f"{stem}.so"
            procs.append((source, name, lib, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", "-o", str(lib),
                 str(out_dir / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built: dict[str, list[tuple[str, ctypes.CDLL, str]]] = {s: [] for s in VARIANTS}
    for source, name, lib, proc in procs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n{log}")
        built[source].append((name, ctypes.CDLL(str(lib)), log))
    return built


def float_registers(log: str) -> str:
    """Registers and spill bytes of the float32 kernels of a ptxas report
    (the downscale form's: its mean), by mangled template arguments."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        mangled = entry.split("'", 1)[0]
        kernel = re.search(r"(affine_gather\w*?)(I\w*?)E", mangled)
        if not kernel or not kernel.group(2).startswith("If"):
            continue
        if "reduce" in kernel.group(1) and not kernel.group(2).startswith("IfLi0"):
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        out.append(f"{kernel.group(1)}{kernel.group(2)}: {regs.group(1) if regs else '?'} "
                   f"regs, {spill.group(1) if spill else 0} B spilled")
    return "; ".join(out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_affine_gather: no CUDA device is visible", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = build_variants(ROOT / "build" / "tune_affine_gather")
    print(f"[{card}] {sum(map(len, built.values()))} variants built in "
          f"{time.perf_counter() - t0:.1f} s")
    for source, variants in built.items():
        for name, _, log in variants:
            print(f"[{card}] {source} {name}: {float_registers(log)}")

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
    b2c = torch.randint(0, 16, (4, 4096, 4096), generator=gen, device=dev, dtype=torch.int32)
    b1 = torch.rand((16, 1024, 1024), generator=gen, device=dev)
    big = torch.rand((1, 20480, 20480), generator=gen, device=dev)
    b2a = torch.rand((4, 4096, 4096), generator=gen, device=dev)
    # (what, source, out (h, w), scales and offsets (j, i, j, i), code, windows)
    cases = (
        ("affine_gather.cu", "B2 c identity 4x4096^2 int32", b2c, (4096, 4096),
         (1.0, 1.0, 0.0, 0.0), 4, None),
        ("affine_gather.cu", "B1 identity 16x1024^2 float32", b1, (1024, 1024),
         (1.0, 1.0, 0.0, 0.0), 0, None),
        ("affine_gather.cu", "pre-downscale 20480^2 -> 25250x25270 float32", big,
         (25250, 25270), (0.8111, 0.8104, 0.2, 0.3), 0, None),
        ("affine_gather_reduce.cu", "mean 5x5 pre-downscale 20480^2 -> 5050x5054", big,
         (5050, 5054), (0.8111, 0.8104, 0.2, 0.3), 0, (5, 5)),
        ("affine_gather_reduce.cu", "mean 2x2 B1 16x1024^2 -> 512^2", b1, (512, 512),
         (1.0, 1.0, 0.0, 0.0), 0, (2, 2)),
        ("affine_gather_reduce.cu", "mean 4x4 B2 4x4096^2 -> 1024^2", b2a, (1024, 1024),
         (1.0, 1.0, 0.0, 0.0), 0, (4, 4)),
    )
    for source, what, src, (oh, ow), (js, is_, jo, io), code, windows in cases:
        if source not in built:
            continue
        batch, h, w = src.shape
        out = torch.empty((batch, oh, ow), dtype=src.dtype, device=dev)
        first = None
        for name, lib, _ in built[source]:
            head = (ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_int64(batch), ctypes.c_int64(h), ctypes.c_int64(w),
                    ctypes.c_int64(h * w), ctypes.c_int64(w), ctypes.c_int64(oh),
                    ctypes.c_int64(ow))
            if windows is None:
                def call(lib=lib, head=head, name=name):
                    rc = lib.xrt_affine_gather(
                        *head, ctypes.c_double(js), ctypes.c_double(is_), ctypes.c_double(jo),
                        ctypes.c_double(io), ctypes.c_int(1), ctypes.c_double(-1.0),
                        ctypes.c_int(code), ctypes.c_int(code), stream())
                    if rc:
                        raise RuntimeError(f"{name}: launch failed ({rc})")
            else:
                def call(lib=lib, head=head, name=name):
                    rc = lib.xrt_affine_gather_reduce(
                        *head, ctypes.c_int64(windows[0]), ctypes.c_int64(windows[1]),
                        ctypes.c_double(js), ctypes.c_double(is_), ctypes.c_double(jo),
                        ctypes.c_double(io), ctypes.c_double(-1.0), ctypes.c_int(0),
                        ctypes.c_int64(0), ctypes.c_int64(0), ctypes.c_int(code), stream())
                    if rc:
                        raise RuntimeError(f"{name}: launch failed ({rc})")

            call()
            torch.cuda.synchronize()
            if first is None:
                first = out.clone()
            elif not torch.equal(out, first):
                raise AssertionError(f"{source} {name} differs from the source at {what}")
            print(f"[{card}] {source} {name:12s} {what}: {device_ms(call):.4f} ms device")
        del out, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
