#!/usr/bin/env python3
"""Time K1 at the headline's shapes over its block shapes, or K2 at
BASELINE #5's band shapes, a downscale band and the headline's K2 shape
beside variants of its launch and another tree's K2.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_srw.py [--band] [--against TREE]``.

Without ``--band``, on the 20480^2 UTM32N -> EPSG:3035 bilinear plan that
``chip_smoke.py`` drives, it times ``srw_vertical`` (K1) over block shapes
(``srw_kernels.MAX_BLOCK_COLS`` columns by ``K1_MAX_ROWS`` rows) and walks
of row blocks per kernel block (``srw_kernels.WALK``), with the
shared-memory budget raised to 200 KB, and ``srw_horizontal`` (K2) once,
as medians of 10 warm launches timed with CUDA events.  Every output is
checked equal to the default configuration's.

With ``--band`` it times, as device time (10 launches queued behind a
sleep, in two passes over the variants, forward then backward, the lesser
printed beside both), K2's kernel (``srw_horizontal_kernel``; K2's band
form and K2 at band origin 0) on these cells, as the sharded step and
``make_srw_fn`` hand it its arguments:

* band 0 of BASELINE #5's step (the headline's geometry, 4 float32 bands
  from a seed over a mesh of 4 entries on the card: ``v`` (4, 5120, 20480)
  from K1's band form), and its first 2 and its first band alone;
* the headline's K2 shape (``v`` (1, 20480, 20480) of the single-chip
  plan);
* band 0 of an 8x downscale of the same source (onto 2560^2 at 240 m in
  EPSG:3035), bilinear and triangular (with ``vd``): windows of some 1000
  columns a segment, past the ring of 4 bands an item.

Its variants: this tree's kernel built once per entry of ``BAND_BUILDS``
(its compile-time constants and edits), and the default build launched as
each entry of ``LAUNCHES`` plans it (``srw_kernels.plan_band_launch``'s
arguments: bands an item at most, warps a block).
With ``--against``, TREE's K2 as it stands (an unpacked parent commit,
say: its K2 entry and band entry must take its block template's arguments,
and the band origin for the band entry, as the tree before K2 ran the
band form's kernel did), and on BASELINE #5's band 0 TREE's template built
once per entry of ``ABLATIONS`` (the finiteness scan skipped: a ceiling on
what the scan costs, ``v`` is finite here; the staging loop without its
integer division; the geometry computed on the first item only, a ceiling
on what it costs, its output not checked) and launched over the block
shapes of ``SHAPES``.

Each variant's output is checked equal to the band form's plain version.
Every line carries the card's name and power limit; the last line is one
JSON object with the times.  It exits nonzero when no CUDA device is
visible.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

N = 20480

# TREE's K2 template: the staging loop as it stands and without its
# division (a warp a row, its lanes over the row's 4-column groups)
_STAGE = """  const int per_row = vec4 ? width >> 2 : width;
  for (int e = threadIdx.x; e < h * per_row; e += kThreads) {
    const int r = e / per_row;
    const int q = e - r * per_row;
"""
_STAGE_NO_DIV = """  const int per_row = vec4 ? width >> 2 : width;
  for (int e = threadIdx.x; e < h * 32; e += kThreads) {
    const int r = e >> 5;
    for (int q = e & 31; q < per_row; q += 32) {
"""
_STAGE_END = """      xrt::cp_async4(dst + q, row + xrt::clamp_index(lo + q, src_w));
    }
  }
}"""
_SCAN = """    bool finite = !xrt::window_has_nonfinite(sv, extent, nrows, w[1] - lo);
    if (kTri) finite = !xrt::window_has_nonfinite(sv + plane, extent, nrows, w[1] - lo) && finite;
"""
# (name, text replacements on TREE's csrc/srw_horizontal.cu, output checked)
ABLATIONS = (
    ("as it stands", [], True),
    ("no scan", [(_SCAN, "    const bool finite = true;\n")], True),
    ("no div", [(_STAGE, _STAGE_NO_DIV), (_STAGE_END, _STAGE_END.replace("  }\n}", "  }\n  }\n}"))],
     True),
    ("no scan no div", [(_SCAN, "    const bool finite = true;\n"), (_STAGE, _STAGE_NO_DIV),
                         (_STAGE_END, _STAGE_END.replace("  }\n}", "  }\n  }\n}"))], True),
    ("geometry once", [("    if (b == 0) {\n      // bases", "    if (it == 0) {\n      // bases")],
     False),
)
# TREE's K2 template over block shapes (columns, rows) at band 0
SHAPES = ((64, 32), (64, 16), (64, 64), (32, 32), (32, 64), (16, 64))
# this tree's kernel built with other constants: "mN" registers capped for
# N blocks an SM (bilinear and nearest); "noinline" the slow path (rows
# that are not finite) out of line; "no check" the window rows taken as
# finite (v is finite here: a ceiling on what the test costs)
_ROW_CHECK = "      bool finite = row_finite(sv, width, lane);\n"
_SLOW = "__device__ __forceinline__ V slow_sum("
BAND_BUILDS = (
    ("m5", {}),
    ("m4", {"kBandMinBlocks": 4}),
    ("m6", {"kBandMinBlocks": 6}),
    ("m5 noinline", {"replace": [(_SLOW, _SLOW.replace("__forceinline__", "__noinline__"))]}),
    ("m5 no check", {"replace": [(_ROW_CHECK, "      bool finite = true;\n")]}),
)
# the default build launched as srw_kernels.plan_band_launch plans it with
# these arguments: bands an item at most, warps a block
LAUNCHES = (
    ("g4 w4", {}),
    ("g2 w4", {"group": 2}),
    ("g1 w4", {"group": 1}),
    ("g4 w2", {"warps": 2}),
)
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# TREE's K2 entry: v, vd, ix_c, iy_c, base_h, win, out, batch, out_h, out_w,
# src_h, src_w, ncj, nci, step, row_tile, d_h, method, fill, rows, cols,
# extent, n_col_blocks, walkers, vec4, stream; its band entry: the band
# origin before the stream
TEMPLATE_SIG = [_P] * 7 + [_I64] * 7 + [_I, _I64, _I, _I, _F, _I, _I, _I, _I64, _I64, _I, _P]
TREE_BAND_SIG = TEMPLATE_SIG[:-1] + [_I64, _P]


def card_line() -> str:
    from tune_ij_gather import card_line as line

    return line()


def median_ms(torch, fn, iters=10):
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


def headline() -> int:
    import torch

    from xcube_resampling_tpu_torch.ops import srw_kernels as sk
    from xcube_resampling_tpu_torch.ops.srw import make_srw_reproject_fn

    dev = torch.device("cuda", 0)
    tag = f"[{card_line()}]"
    fn = make_srw_reproject_fn(*grids(N), "bilinear", np.nan, dev)
    st = fn.state
    src = torch.from_numpy(
        np.random.default_rng(0).random((1, N, N), dtype=np.float32)
    ).to(dev)
    base_v = st.base_v.cpu().numpy()
    defaults = (sk.WALK, sk.MAX_BLOCK_COLS, sk.K1_MAX_ROWS, sk.SMEM_BUDGET)

    v_ref, _ = sk.srw_vertical(*fn.vertical_args(src))
    results = {"srw_vertical": {}, "srw_horizontal": {}}
    sk.SMEM_BUDGET = 200 * 1024
    for walk, cols, rows in ((4, 64, 64), (1, 64, 64), (4, 64, 128), (4, 128, 32),
                             (4, 128, 64), (4, 128, 128), (4, 32, 128)):
        sk.WALK, sk.MAX_BLOCK_COLS, sk.K1_MAX_ROWS = walk, cols, rows
        win = sk.plan_vertical_windows(base_v, st.col_tile, st.d_v).to(dev)
        args = (src, st.iystar_c, st.step, st.base_v, st.col_tile, st.d_v, win,
                "bilinear")
        if not torch.equal(sk.srw_vertical(*args)[0], v_ref):
            raise AssertionError(f"K1 {cols}x{rows} walk {walk} differs")
        ms = median_ms(torch, lambda: sk.srw_vertical(*args))
        key = f"cols{win.cols}_rows{win.rows}_walk{walk}"
        results["srw_vertical"][key] = ms
        print(f"{tag} K1 {key} (extent {win.extent}): {ms:.3f} ms")
    sk.WALK, sk.MAX_BLOCK_COLS, sk.K1_MAX_ROWS, sk.SMEM_BUDGET = defaults
    h_args = fn.horizontal_args(v_ref)
    if not equal(torch, sk.srw_horizontal(*h_args), sk.srw_horizontal_plain(*h_args)):
        raise AssertionError("K2 differs from its plain version")
    ms = median_ms(torch, lambda: sk.srw_horizontal(*h_args))
    results["srw_horizontal"]["default"] = ms
    print(f"{tag} K2 (extent {st.win_h.extent}): {ms:.3f} ms")
    print(json.dumps({"card": tag[1:-1], "ms": results}))
    return 0


def grids(n, scale=1):
    from xcube_resampling_tpu_torch import GridMapping

    utm = GridMapping.regular(size=(n, n), xy_min=(300000.0, 5200000.0), xy_res=30.0 * N / n,
                              crs="epsg:32632")
    laea = GridMapping.regular(size=(n // scale, n // scale), xy_min=(4050000.0, 2650000.0),
                               xy_res=30.0 * N / n * scale, crs="epsg:3035")
    return utm, laea


def equal(torch, a, b) -> bool:
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def band_cells(dev, n=N, bands=4, mesh_n=4):
    """K2's band-form arguments of each cell (see the module docstring),
    as the sharded step and ``make_srw_fn`` take them: [(name, args)]."""
    import torch

    from xcube_resampling_tpu_torch.ops.srw import make_srw_reproject_fn
    from xcube_resampling_tpu_torch.ops.srw_kernels import srw_vertical, srw_vertical_band
    from xcube_resampling_tpu_torch.parallel import make_mesh, make_sharded_srw_step
    from xcube_resampling_tpu_torch.parallel.halo import ShardedSRWStep

    utm, laea = grids(n)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((bands, n, n), generator=gen, device=dev)
    mesh = make_mesh(devices=[dev] * mesh_n)
    step, _ = make_sharded_srw_step(mesh, utm, laea, src_batch_dims=1)
    placed, _ = step.bands(x)
    v, _ = srw_vertical_band(*step.vertical_args(placed, step.exchange(placed), 0))
    del placed
    h_args = step.horizontal_args(v, None, 0)
    cells = [("band 0", h_args)]
    for b in (2, 1):
        cells.append((f"band 0 x{b}", (v[:b],) + h_args[1:]))
    fn = make_srw_reproject_fn(utm, laea, "bilinear", np.nan, dev)
    v1, _ = srw_vertical(*fn.vertical_args(x[:1]))
    cells.append(("headline", fn.horizontal_args(v1) + (None, 0)))
    down, _ = make_sharded_srw_step(mesh, *grids(n, 8), src_batch_dims=1)
    placed, _ = down.bands(x)
    halos = down.exchange(placed)
    for interp in ("bilinear", "triangular"):
        s = ShardedSRWStep(down.devices, down.plan, interp, float("nan"), 1)
        vb, vdb = srw_vertical_band(*s.vertical_args(placed, halos, 0))
        cells.append((f"down8 {interp}", s.horizontal_args(vb, vdb, 0)))
    del x, placed, halos
    return cells


def template_windows(base_h, row_tile, d_h, cols=64, max_rows=32, budget=96 * 1024):
    """TREE's K2 windows as its block template planned them: ``rows``
    output rows of one row tile by *cols* columns, the most rows (a power
    of two up to *max_rows*) whose two ``v`` (and ``vd``) windows and
    geometry fit *budget* bytes."""
    import torch

    from xcube_resampling_tpu_torch.ops import srw_kernels as sk

    n_rt, out_w = base_h.shape
    n_cb = -(-out_w // cols)
    padded = np.pad(base_h, ((0, 0), (0, n_cb * cols - out_w)), mode="edge")
    blocks = padded.reshape(n_rt, n_cb, cols).astype(np.int64)
    lo = blocks.min(axis=2) // 4 * 4
    hi = -(-(blocks.max(axis=2) + d_h) // 4) * 4
    extent = int((hi - lo).max())
    rows = sk._pow2_divisor(row_tile, max_rows)
    while rows > 1 and 4 * (4 * rows * extent + 2 * rows * cols + cols) + rows * cols > budget:
        rows //= 2
    lohi = torch.from_numpy(np.stack([lo, hi], axis=-1).astype(np.int32))
    return sk.Windows(lohi, rows, cols, extent, (int(lo.min()), int(hi.max())))


def template_args(h_args, win, out, band=False):
    """The C arguments of TREE's K2 entry (its band entry, with *band*: the
    band origin last) for band-form arguments *h_args* and windows *win*."""
    from xcube_resampling_tpu_torch.ops import srw_kernels as sk
    from xcube_resampling_tpu_torch.ops.reproject_ops import method_code

    (v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, _, method, fill, vd, row0) = h_args
    batch, out_h, src_w = v.shape
    ncj, nci = ix_c.shape
    n_cb = -(-base_h.shape[1] // win.cols)
    n_rb = -(-out_h // win.rows)
    vec4 = src_w % 4 == 0 and v.data_ptr() % 16 == 0 and (vd is None or vd.data_ptr() % 16 == 0)
    args = [v.data_ptr(), None if vd is None else vd.data_ptr(), ix_c.data_ptr(),
            iy_c.data_ptr(), base_h.data_ptr(), win.lohi.data_ptr(), out.data_ptr(), batch,
            out_h, base_h.shape[1], src_h, src_w, ncj, nci, step, row_tile, d_h,
            method_code(method), fill, win.rows, win.cols, win.extent, n_cb,
            sk._walkers(n_cb, n_rb), int(vec4)]
    return args + [row0] if band else args


def band() -> int:
    import torch

    from tune_ij_gather import build_variants, device_ms
    from chip_smoke import ptxas_kernels
    from xcube_resampling_tpu_torch import _build
    from xcube_resampling_tpu_torch.ops import srw_kernels as sk

    parser = argparse.ArgumentParser()
    parser.add_argument("--band", action="store_true")
    parser.add_argument("--against", type=Path, default=None)
    args = parser.parse_args()
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    forms = build_variants(ROOT / "build" / "tune_srw_band", "srw_horizontal.cu", BAND_BUILDS,
                           None)
    template = []
    if args.against is not None:
        template = build_variants(
            ROOT / "build" / "tune_srw_tree", "srw_horizontal.cu",
            [(n, {"replace": r} if r else {}) for n, r, _ in ABLATIONS], None,
            csrc=args.against / "xcube_resampling_tpu_torch" / "csrc")
    print(f"[{card}] {len(forms) + len(template)} builds of K2 in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, _, log in forms:
        for kernel, regs, spill, stack in ptxas_kernels(log, "srw_horizontal_kernel"):
            print(f"[{card}] {name} {kernel}: {regs} registers, {spill} bytes spilled, "
                  f"{stack} bytes of stack frame")
    for _, lib, _ in forms:
        lib.xrt_srw_horizontal_f32.argtypes = _build._SIGNATURES["xrt_srw_horizontal_f32"]
    for _, lib, _ in template:
        lib.xrt_srw_horizontal_f32.argtypes = TEMPLATE_SIG
        lib.xrt_srw_horizontal_band_f32.argtypes = TREE_BAND_SIG
    tree = f"TREE {args.against.name}" if args.against is not None else None
    unchecked = {f"{tree} {n}" for n, _, ok in ABLATIONS if not ok}
    results = {}
    for cell, h_args in band_cells(dev):
        v, vd = h_args[0], h_args[11]
        tri = vd is not None
        base_h, row_tile, d_h = h_args[4].cpu().numpy(), h_args[5], h_args[6]
        out = torch.empty((v.shape[0], v.shape[1], base_h.shape[1]), dtype=torch.float32,
                          device=dev)
        ref = sk.srw_horizontal_band_plain(*h_args)
        win = h_args[8]
        print(f"[{card}] {cell}: v {tuple(v.shape)} -> {tuple(ref.shape)}, row tile "
              f"{row_tile}, d_h {d_h}, windows of {win.cols} columns, extent {win.extent}, "
              f"launch {sk.plan_band_launch(v.shape[0], win.extent, tri)}")
        # (name, a call that returns its output)
        calls = [("its wrapper", lambda: sk.srw_horizontal_band(*h_args))]

        def launch(entry, c_args, what):
            check(entry(*c_args, stream()), what)
            return out

        for name, lib, _ in forms:
            for lname, kw in LAUNCHES if name == forms[0][0] else LAUNCHES[:1]:
                plan = sk.plan_band_launch(v.shape[0], win.extent, tri, **kw)
                c_args = sk.horizontal_c_args(*h_args, out, plan)
                calls.append((f"{name} {lname}", lambda e=lib.xrt_srw_horizontal_f32, c=c_args:
                              launch(e, c, "K2")))
        if template:
            # TREE as it stands: its K2 entry at band origin 0, else its band entry
            tw = template_windows(base_h, row_tile, d_h).to(dev)
            lib = template[0][1]
            if cell == "headline":
                calls.append((tree, lambda c=template_args(h_args, tw, out): launch(
                    lib.xrt_srw_horizontal_f32, c, "TREE")))
            else:
                calls.append((tree, lambda c=template_args(h_args, tw, out, band=True): launch(
                    lib.xrt_srw_horizontal_band_f32, c, "TREE")))
            if cell == "band 0":
                for name, lib_a, _ in template[1:]:
                    calls.append((f"{tree} {name}", lambda e=lib_a.xrt_srw_horizontal_band_f32,
                                  c=template_args(h_args, tw, out, band=True): launch(
                                      e, c, "TREE ablation")))
                for cols, rows in SHAPES[1:]:
                    w = template_windows(base_h, row_tile, d_h, cols, rows, 200 * 1024).to(dev)
                    calls.append((f"{tree} {w.cols}x{w.rows}",
                                  lambda c=template_args(h_args, w, out, band=True), w=w:
                                  launch(lib.xrt_srw_horizontal_band_f32, c, "TREE")))
        times = {}
        for name, call in calls + calls[::-1]:
            out.fill_(-7.0)
            got = call()
            torch.cuda.synchronize()
            if name not in unchecked and not equal(torch, got, ref):
                raise AssertionError(f"{cell}: {name} differs from the plain version")
            del got
            times.setdefault(name, []).append(device_ms(call))
        results[cell] = {}
        for name, (t1, t2) in times.items():
            results[cell][name] = min(t1, t2)
            note = " (output not checked)" if name in unchecked else ""
            print(f"[{card}] {cell} {name:32s}: {min(t1, t2):.4f} ms device (passes {t1:.4f}, "
                  f"{t2:.4f}){note}")
        del out, ref, h_args, v, vd
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "device_ms": results}))
    return 0


def stream():
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: launch failed ({rc})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_srw: no CUDA device is visible", file=sys.stderr)
        return 2
    return band() if "--band" in sys.argv[1:] else headline()


if __name__ == "__main__":
    sys.exit(main())
