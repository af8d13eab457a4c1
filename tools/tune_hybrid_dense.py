#!/usr/bin/env python3
"""Time K12 (``hybrid_dense``, the hybrid Phase A's dense kernel) over
variants of its source, beside another tree's K12.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_hybrid_dense.py [--against TREE]``.
It builds ``csrc/hybrid_phase_a.cu`` once per entry of ``VARIANTS`` (its
register cap ``kDenseMinBlocks``, or pass 2 written another way), each
into a library of its own under ``build/tune_hybrid_dense/`` (all ``nvcc``
processes started together), and with ``--against`` TREE's source as it
stands (an unpacked parent commit, say), and prints the registers, spills
and stack frame ptxas gave each variant's tile-16 kernel.  At R1 (the
1189 x 1890 OLCI-like swath onto its default 512-tiled grid) and R3 (the
4865 x 4091 granule onto its 1024-tiled grid), tile 16, with K11's seed
and window, it holds this tree's K12 to its plain version at R1 (the map,
the winner's position and the pairs solved a pixel), every variant and
TREE's K12 to this tree's map bit for bit, and times each: the mean of 10
launches queued behind a sleep on the card (device time alone, the ruler
of ``chip_smoke.py``'s ``device_ms``), in two passes over the variants
(forward, then backward), the lesser printed beside both.  Every line
carries the card's name and power limit.  It exits nonzero when no CUDA
device is visible.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

# pass 2 as the kernel has it: the reciprocals written to shared memory
# and read back for the boxes
_P2_READ = ("wx[n2], wy[n2], inv_a[q], a.cull)", "wx[n1], wy[n1], inv_b[q], a.cull);")
_P2_HEAD = '''    inv_a[q] = da != 0 ? F(1) / da : F(NAN);
    inv_b[q] = db != 0 ? F(1) / db : F(NAN);'''

# (name, constants or a "replace" list of text pairs): "m3" 3 blocks an SM
# at tile 16 (72 registers); "recip regs" the reciprocals kept in
# registers for the boxes (it spills 8 bytes at the cap of 64)
VARIANTS = (
    ("as it stands", {}),
    ("m3", {"kDenseMinBlocks": 3}),
    ("recip regs", {"replace": [
        (_P2_HEAD, '''    const F ia = da != 0 ? F(1) / da : F(NAN);
    const F ib = db != 0 ? F(1) / db : F(NAN);
    inv_a[q] = ia;
    inv_b[q] = ib;'''),
        (_P2_READ[0], _P2_READ[0].replace("inv_a[q]", "ia")),
        (_P2_READ[1], _P2_READ[1].replace("inv_b[q]", "ib")),
    ]}),
)


def cell(dev, width, height, tile_size):
    """K12's arguments at a rectify cell, tile 16, from K11's seed on the
    card: the normalised swath coordinates, the corner quads, the target
    shape and the window."""
    import torch

    from tune_ij_gather import olci_swath
    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch.ops import rectify_ops as ro

    ds = olci_swath(width, height, tile_size)
    gm = GridMapping.from_dataset(ds)
    tgt = gm.to_regular(tile_size=tile_size)
    sw = torch.from_numpy(np.ascontiguousarray(np.asarray(gm.xy_coords.data),
                                               dtype=np.float64)).to(dev)
    x1, y1, _, y2 = tgt.xy_bbox
    x_res, y_res = tgt.xy_res
    j_up = tgt.is_j_axis_up
    dst = (tgt.height, tgt.width)
    gx = (sw[0] - x1) / x_res
    gy = (sw[1] - (y1 if j_up else y2)) / (y_res if j_up else -y_res)
    cqj, cqi, meta = ro.hybrid_seed(gx, gy, dst, 16, float(max(dst)), 2)
    _, need_j, need_i = meta.tolist()
    return gx, gy, cqj, cqi, dst, ro.hybrid_window(need_j, gm.height), \
        ro.hybrid_window(need_i, gm.width)


def main() -> int:
    import torch

    from chip_smoke import ptxas_kernels
    from tune_ij_gather import build_variants, card_line, device_ms
    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.ops import rectify_ops as ro

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a tree whose csrc/hybrid_phase_a.cu is built and timed as well")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_hybrid_dense: no CUDA device is visible", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = build_variants(ROOT / "build" / "tune_hybrid_dense", "hybrid_phase_a.cu", VARIANTS,
                           args.against)
    print(f"[{card}] {len(built)} builds of K12 in {time.perf_counter() - t0:.1f} s")
    p, i64, d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    # (TREE's C entry may lack the `solved` pointer)
    with_solved = {}
    for k, (name, lib, log) in enumerate(built):
        with_solved[name] = k < len(VARIANTS) or "int* solved" in (
            args.against / "xcube_resampling_tpu_torch" / "csrc" / "hybrid_phase_a.cu"
        ).read_text()
        lib.xrt_hybrid_dense.argtypes = [p, p, i64, i64, d, p, p, i64, i64, i64, i64, i64, i64,
                                         d, p, p] + [p] * with_solved[name] + [p]
        lib.xrt_hybrid_dense.restype = ctypes.c_int
        for kernel, regs, spill, stack in ptxas_kernels(log, "hybrid_dense_kernelIdLi16E"):
            print(f"[{card}] K12 {name}: {regs} registers, {spill} bytes spilled, {stack} bytes "
                  f"of stack frame")
    for name_c, shape in (("R1", (1189, 1890, 512)), ("R3", (4865, 4091, 1024))):
        gx, gy, cqj, cqi, dst, win_j, win_i = cell(dev, *shape)
        k_args = (gx, gy, cqj, cqi, dst, UV_DELTA, 16, win_j, win_i, 2)
        tested = torch.empty(dst, dtype=torch.int32, device=dev)
        solved = torch.empty_like(tested)
        ref = ro.hybrid_dense(*k_args, tested=tested, solved=solved)
        if name_c == "R1":
            t_ref, s_ref = torch.empty_like(tested), torch.empty_like(tested)
            plain = ro.hybrid_dense_plain(*k_args, tested=t_ref, solved=s_ref)
            nan = torch.isnan(ref)
            if not (torch.equal(nan, torch.isnan(plain)) and torch.equal(ref[~nan], plain[~nan])
                    and torch.equal(tested, t_ref) and torch.equal(solved, s_ref)):
                raise AssertionError("R1: K12 differs from its plain version")
        print(f"[{card}] {name_c}: {dst[0]}x{dst[1]}, window {win_j}x{win_i}; winner position "
              f"{tested.double().mean().item():.1f}, pairs solved a pixel "
              f"{solved.double().mean().item():.3f}")
        out = torch.empty_like(ref)
        times = {}
        for name, lib, _ in built + built[::-1]:
            def call(lib=lib, name=name):
                rc = lib.xrt_hybrid_dense(
                    gx.data_ptr(), gy.data_ptr(), gx.shape[0], gx.shape[1], 0.0, cqj.data_ptr(),
                    cqi.data_ptr(), dst[0], dst[1], 16, win_j, win_i, 2, UV_DELTA,
                    out.data_ptr(), None, *[None] * with_solved[name],
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"K12 {name}: launch failed ({rc})")

            call()
            torch.cuda.synchronize()
            nan = torch.isnan(ref)
            if not (torch.equal(nan, torch.isnan(out)) and torch.equal(ref[~nan], out[~nan])):
                raise AssertionError(f"K12 {name} differs from this tree's at {name_c}")
            times.setdefault(name, []).append(device_ms(call))
        for name, (t1, t2) in times.items():
            print(f"[{card}] K12 {name:14s} {name_c}: {min(t1, t2):.4f} ms device (passes "
                  f"{t1:.4f}, {t2:.4f})")
        del gx, gy, ref, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
