#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of xcube_resampling_tpu once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 chip_smoke.py``.  It

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``xcube_resampling_tpu_torch/csrc`` with ``nvcc``,
   printing each source's registers and spills (ptxas ``-v``), and fails
   if K6's register kernels spill or use local memory;
2. drives the port's main path through ``resample_in_space``: the 20480^2
   UTM32N -> EPSG:3035 bilinear reproject (first call and warm calls); the
   same source onto a 5120^2 EPSG:3035 grid at 120 m, where the
   pre-downscale runs (clip, K4's downscale form: the gather reduced in
   5 x 5 windows without the inflated image) before the tiled SRW, with
   the device memory a call takes at its peak; the
   EPSG:4326 0.05 deg -> UTM32N 4096^2 reproject with nearest, triangular
   and a 2-band stack, the exact tier (``XRTPU_EXACT=1``) on that
   geometry, the global EPSG:4326 0.05 deg -> EPSG:3035 4096^2 reproject
   (BASELINE #3, a singular warp whose default tier is K3) with nearest
   and bilinear, first call and warm calls, a small UTM32N ->
   EPSG:3035 case with a numpy variable (placed on the card by
   ``device``) beside a tensor, and the affine route: BASELINE #1 (a
   16-band 1024^2 float32 2x bilinear downscale with ``mean``: K4's
   downscale form) and BASELINE #2 (a 4-band 4096^2 raster coarsened 4x
   with ``mean``, ``first`` and ``mode``, through
   ``ops.coarsen_ops.coarsen``: K5, K6, and through an exact 4x affine
   downscale: the downscale form for ``mean`` and ``first``, K4 then K6
   for ``mode``); the kernel launch counts are reset before and read
   after each call;
3. holds every result against the plain PyTorch composition on the same
   device tensors, and the small case against the port's own K3 (the
   direct gather) within the two-pass bounds;
4. holds each kernel against its plain version on CUDA tensors at the
   headline's shapes, at the 4326 -> UTM shapes on inputs with NaN rows,
   on a geometry whose tap windows clip at the source's top and bottom
   edges, and (K3) on a ragged EPSG:3035 target, for every method; K4 at
   BASELINE #2's ``c`` and for both orders on four dtypes with a NaN
   cell, a negative scale and a numeric fill, K5 for every reducer on
   float32 with all-NaN windows and on int32, K4's downscale form against
   its plain version and against K4 -> K5 on the card for every dtype and
   K5 reducer (all-NaN windows, a fill edge, a flipped axis, a strided
   view), K6 for mode and median at 4, 9, 16, 25, 64, 81 and 1024 taps
   with ties, NaN and +-0.0; times each kernel and its plain version at
   the main path's shapes beside one PyTorch call where one computes the
   same function (K3 ``F.grid_sample``, K4 a copy at BASELINE #2's ``c``
   and ``F.grid_sample`` at BASELINE #1, K5 and the downscale form at
   BASELINE #1 ``torch.nanmean``, K5 a strided copy for ``first``, K6
   ``torch.mode``), and the downscale form beside the chain K4 -> K5 it
   replaces, two ways: one
   warm call between two CUDA events on an idle card (``ms``: device time
   and the host's enqueue of the call) and warm calls queued behind a
   sleep on the card (``device_ms``: device time alone); and computes each
   kernel's bound (bytes at 3.35 TB/s, or operations at 67 TFLOP/s
   float32 and 34 TFLOP/s float64, the H100 SXM data sheet's peaks), K3's
   from the source pixels its taps reach, counted on the card, the
   downscale form's from the source sectors its taps reach;
5. prints the card line again, a JSON line of the kernels and, last,
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It exits nonzero and prints no result when no CUDA device is visible or
any phase fails.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

# Tolerances of a kernel against its plain version on the same inputs.
# Both round alike (built with -fmad=false, fused multiply-adds placed
# explicitly in both), so they are expected to agree bit for bit; the
# float64 emulation of a fused multiply-add in the plain versions can
# round twice in rare cases, one float32 ulp, hence 1e-5 for data in [0, 1).
# K4 (float64 arithmetic, rounded once) and K5/K6 are expected to agree
# with their plain versions bit for bit ("exact"), except K5's float
# statistics, whose float64 sums run in another order in the plain
# version: within 2.5e-7 of the value ("stat", two float32 ulp).
TOL = {"nearest": 0.0, "bilinear": 1e-5, "triangular": 1e-5, "exact": 0.0, "stat": 0.0}
REL_TOL = {"stat": 2.5e-7}
METHODS = ("bilinear", "nearest", "triangular")
# H100 SXM data-sheet peaks: HBM3 bytes/s, float32 and float64 (non-tensor)
# FLOP/s.  Integer compares are counted at the float32 rate (the data sheet
# gives no int32 rate), which keeps the bound a lower bound.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of bytes over
    the memory rate and operations over *peak_ops*."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def affine_gather_bound(x, out_h, out_w, order):
    """K4 reads the source once and writes the output once (float32 in and
    out at BASELINE #1); about 20 float64 operations a bilinear pixel
    (positions, weights, four taps), 4 a nearest one."""
    n_out = x.shape[0] * out_h * out_w
    n_bytes = x.numel() * x.element_size() + n_out * x.element_size()
    return bound(n_bytes, n_out * (20 if order else 4), PEAK_F64)


def reduce_bound(x, j_div, i_div, agg, out_itemsize):
    """K5 reads every input once (a pick only the 32-byte sectors that hold
    its taps) and writes every output once; one float64 operation a tap
    (two for std and var)."""
    batch, h, w = x.shape
    n_out = batch * (h // j_div) * (w // i_div)
    if agg in ("first", "last", "center"):
        cols = np.arange(w // i_div) * i_div + {"first": 0, "last": i_div - 1,
                                                 "center": i_div // 2}[agg]
        sectors = len(np.unique(cols * x.element_size() // 32))
        n_in = batch * (h // j_div) * sectors * 32
        n_ops = 0
    else:
        n_in = x.numel() * x.element_size()
        n_ops = x.numel() * (2 if agg in ("std", "var") else 1)
    return bound(n_in + n_out * out_itemsize, n_ops, PEAK_F64)


def rank_bound(x, j_div, i_div):
    """K6 reads every input once and writes every output once; a mode or
    median must compare each tap at least once (one operation a tap: a
    selection takes O(w) compares, a sort O(w log w), so any count above
    that could exceed what the function needs)."""
    taps = j_div * i_div
    n_out = x.numel() // taps
    n_bytes = x.numel() * x.element_size() + n_out * x.element_size()
    return bound(n_bytes, x.numel())


def gather_reduce_bound(x, residual, out_h, out_w, j_div, i_div, agg, out_itemsize):
    """K4's downscale form: it must read the 32-byte source sectors that
    the bilinear taps of its gathered inflated pixels reach (every window
    pixel, or a pick's one) once and write the coarse image once.  Per
    gathered pixel a column lerp (3 float64 operations) and the reducer's
    operations (1 a tap, 4 for std and var, 0 for a pick); per gathered
    inflated row a row lerp (3) at each source column its taps reach.
    Positions as K4 takes them (float64, clipped taps, valid rows and
    columns only)."""
    batch, h, w = x.shape
    (i_s, _, i_o), (_, j_s, j_o) = residual
    pick = {"first": (0, 0), "last": (j_div - 1, i_div - 1),
            "center": (j_div // 2, i_div // 2)}.get(agg)
    rows = np.arange(out_h * j_div)
    cols = np.arange(out_w * i_div)
    if pick:
        rows = rows[rows % j_div == pick[0]]
        cols = cols[cols % i_div == pick[1]]
    y, xx = rows * j_s + j_o, cols * i_s + i_o
    y, xx = y[(y >= 0) & (y <= h - 1)], xx[(xx >= 0) & (xx <= w - 1)]
    y0, x0 = np.floor(y).astype(np.int64), np.floor(xx).astype(np.int64)
    src_rows = np.unique(np.concatenate([y0, np.minimum(y0 + 1, h - 1)]))
    src_cols = np.unique(np.concatenate([x0, np.minimum(x0 + 1, w - 1)]))
    sectors = len(np.unique(src_cols * x.element_size() // 32))
    n_in = batch * len(src_rows) * sectors * 32
    n_out = batch * out_h * out_w
    per_tap = 0 if pick else (4 if agg in ("std", "var") else 1)
    n_ops = batch * (len(y) * len(xx) * (3 + per_tap) + 3 * len(y) * len(src_cols))
    return bound(n_in + n_out * out_itemsize, n_ops, PEAK_F64)


def vertical_bound(src, st, tri):
    """K1 reads the source, the coarse field and the bases once and writes
    v (and vd); per output and tap a weight (4 operations) and a fused
    multiply-add (2), twice for triangular; 12 operations of field
    interpolation per position."""
    batch, _, src_w = src.shape
    outs = batch * st.out_h * src_w
    n_bytes = 4 * (src.numel() + st.iystar_c.numel() + st.base_v.numel()
                   + outs * (2 if tri else 1))
    n_ops = outs * st.d_v * (12 if tri else 6) + 12 * st.out_h * src_w
    return bound(n_bytes, n_ops)


def horizontal_bound(v, st, tri):
    """K2 reads v (and vd), two coarse fields and the bases once and writes
    the output; per output and tap 6 operations (12 for triangular); 40
    operations of geometry per pixel."""
    batch = v.shape[0]
    outs = batch * st.out_h * st.out_w
    n_bytes = 4 * (v.numel() * (2 if tri else 1) + 2 * st.ix_c.numel()
                   + st.base_h.numel() + outs)
    n_ops = outs * st.d_h * (12 if tri else 6) + 40 * st.out_h * st.out_w
    return bound(n_bytes, n_ops)


def ptxas_summary(log: str) -> list[tuple[str, list[int], list[int], list[int]]]:
    """Per source file of the build log (``== name`` sections), the
    registers of each kernel, the bytes of its spill stores and of its
    stack frame (local memory), from ptxas's ``-v`` report."""
    out = []
    for section in log.split("== ")[1:]:
        name = section.split("\n", 1)[0].strip()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", section)]
        if regs:
            spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", section)]
            stack = [int(b) for b in re.findall(r"(\d+) bytes stack frame", section)]
            out.append((name, regs, spills, stack))
    return out


def ptxas_kernels(log: str, pattern: str) -> list[tuple[str, int, int, int]]:
    """The kernels of the build log whose mangled name contains *pattern*:
    (name, registers, spill store bytes, stack frame bytes)."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        if pattern not in name:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        stack = re.search(r"(\d+) bytes stack frame", entry)
        out.append((name, int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else 0, int(stack.group(1)) if stack else 0))
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from xcube_resampling_tpu_torch import (
        DataArray,
        Dataset,
        GridMapping,
        resample_in_space,
    )
    from xcube_resampling_tpu_torch import _build
    from xcube_resampling_tpu_torch import reproject as port_reproject
    from xcube_resampling_tpu_torch._device import LAUNCHES
    from xcube_resampling_tpu_torch.affine import _scale_split
    from xcube_resampling_tpu_torch.ops.coarsen_ops import (
        REDUCERS,
        coarsen,
        coarsen_plain,
        coarsen_rank,
        coarsen_reduce,
        window_reshape,
    )
    from xcube_resampling_tpu_torch.ops.gather import (
        affine_gather,
        affine_gather_plain,
        affine_gather_reduce,
        affine_gather_reduce_plain,
    )
    from xcube_resampling_tpu_torch.ops.reproject_ops import (
        FusedReprojectFn,
        fused_reproject,
        fused_reproject_plain,
        interp_field,
        make_fused_reproject_fn,
    )
    from xcube_resampling_tpu_torch.ops.srw import SRWFn, make_srw_reproject_fn
    from xcube_resampling_tpu_torch.ops.srw_kernels import (
        srw_horizontal,
        srw_horizontal_plain,
        srw_vertical,
        srw_vertical_plain,
    )
    from xcube_resampling_tpu_torch.reproject import device_reproject_fn

    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    print(card)
    print(
        f"{tag} python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
    )

    # -- build ---------------------------------------------------------------
    build = _build.build()
    print(f"{tag} nvcc build {build.seconds:.2f} s -> {build.path.name}")
    for source, regs, spills, stack in ptxas_summary(build.log):
        print(f"  {source}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
              f"at most {max(spills, default=0)} bytes spilled, "
              f"{max(stack, default=0)} bytes of stack frame")
    # K6's register kernels (windows of up to 16 and 32 taps in
    # registers): no spill, no local memory
    for cap in (16, 32):
        regs_k = [k for k in ptxas_kernels(build.log, "coarsen_rank_regs_kernel")
                  if f"Li{cap}E" in k[0]]
        if regs_k:
            print(f"  coarsen_rank register kernels, {cap} taps: {len(regs_k)} kernels, "
                  f"{min(k[1] for k in regs_k)}-{max(k[1] for k in regs_k)} registers, "
                  f"{max(k[2] for k in regs_k)} bytes spilled, "
                  f"{max(k[3] for k in regs_k)} bytes of stack frame")
        if build.log and (not regs_k or any(k[2] or k[3] for k in regs_k)):
            raise AssertionError(f"K6's {cap}-tap register kernels spill or are missing")
    _build.load()

    nan = float("nan")
    err = {
        "srw_vertical": 0.0, "srw_horizontal": 0.0, "fused_reproject": 0.0,
        "affine_gather": 0.0, "affine_gather_reduce": 0.0, "coarsen_reduce": 0.0,
        "coarsen_rank": 0.0,
    }
    main_launches: Counter = Counter()

    def compare(got, ref, interp, what, signs=False):
        """Max abs difference; raises on unequal dtypes or NaN masks, or
        above TOL (plus REL_TOL of the reference's magnitude); with *signs*
        also on unequal sign bits (-0.0 against +0.0)."""
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(
                f"{what}: {tuple(got.shape)} {got.dtype} != {tuple(ref.shape)} {ref.dtype}"
            )
        if got.numel() == 0:
            return 0.0
        if not got.dtype.is_floating_point:
            # through numpy: the card has few operations on unsigned types
            differ = got.cpu().numpy() != ref.cpu().numpy()
            if differ.any():
                raise AssertionError(f"{what}: {int(differ.sum())} integers differ")
            return 0.0
        nan_got, nan_ref = torch.isnan(got), torch.isnan(ref)
        if not torch.equal(nan_got, nan_ref):
            raise AssertionError(f"{what}: NaN masks differ")
        if signs and not torch.equal(torch.signbit(got) & ~nan_got,
                                     torch.signbit(ref) & ~nan_ref):
            raise AssertionError(f"{what}: sign bits differ")
        d = torch.where(nan_got, 0.0, got.double() - ref.double()).abs()
        lim = TOL[interp] + REL_TOL.get(interp, 0.0) * torch.where(nan_ref, 0.0, ref.double()).abs()
        if (d > lim).any():
            raise AssertionError(f"{what}: max abs diff {d.max().item()} above the tolerance")
        return d.max().item()

    def run_main(ds, target_gm, interp, expect, exact=None, **kwargs):
        """One main-path call; the launch counts are reset just before it
        and read just after.  *expect* names the kernels it must launch,
        *exact* how often where it gives them; others must not launch."""
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = resample_in_space(ds, target_gm=target_gm, interp_methods=interp, **kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = Counter(LAUNCHES)
        main_launches.update(got)
        for name in expect:
            if got[name] < 1:
                raise AssertionError(f"{name} was not launched: {dict(got)}")
        for name, n in (exact or {}).items():
            if got[name] != n:
                raise AssertionError(f"{name} launched {got[name]} times, not {n}: {dict(got)}")
        for name in set(err) - set(expect):
            if got[name]:
                raise AssertionError(f"{name} launched off its tier: {dict(got)}")
        return out, dt

    def dataset(gm, **variables):
        coords = dict(gm.to_coords(exclude_bounds=True))
        coords["spatial_ref"] = DataArray(np.array(0), dims=(), attrs=gm.crs.to_cf())
        x_dim, y_dim = gm.xy_dim_names
        return Dataset(
            {
                name: DataArray(
                    data,
                    dims=(y_dim, x_dim) if data.ndim == 2 else ("band", y_dim, x_dim),
                    attrs=dict(grid_mapping="spatial_ref"),
                )
                for name, data in variables.items()
            },
            coords=coords,
        )

    def check_output(arr, shape, dtype=torch.float32):
        if not (isinstance(arr, torch.Tensor) and arr.device == dev):
            raise AssertionError(f"output is not a tensor on {dev}: {type(arr)}")
        if tuple(arr.shape) != shape or arr.dtype != dtype:
            raise AssertionError(f"output {tuple(arr.shape)} {arr.dtype}, expected {shape} {dtype}")
        if not dtype.is_floating_point:
            return 1.0
        share = torch.isfinite(arr).float().mean().item()
        if share < 0.5:
            raise AssertionError(f"only {share:.3f} of the output is finite")
        return share

    def event_ms(fn, iters=10):
        """Median ms between two CUDA events around one warm call of *fn*
        on an idle card: its device time and the host's enqueue of the
        call (a wrapper's checks and launch, tens of us)."""
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

    def device_ms(fn, iters=10):
        """Device ms of one warm call of *fn*: CUDA events around *iters*
        calls queued behind a sleep on the card that outlasts their
        enqueueing, so the card runs them back to back and the host's
        enqueue time is not counted."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        # at most 2e9 cycles a second: the sleep lasts at least this long
        torch.cuda._sleep(int(2e9 * min(2 * iters * host_s, 1.0)))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def time_pair(kernel, plain):
        """The kernel's and the plain version's event_ms, in the order
        plain, kernel, kernel, plain (the median of each pair), and the
        kernel's device_ms."""
        p1, k1, k2, p2 = (event_ms(f) for f in (plain, kernel, kernel, plain))
        return statistics.median([k1, k2]), statistics.median([p1, p2]), device_ms(kernel)

    def k3_bound(fn, ix, iy, interp):
        """K3's bound on one band: it must read the coarse fields and the
        source pixels that the taps of the valid pixels reach (positions
        clamped as gather_interp clamps them; counted here with a mask on
        the card), and write the output; about 30 operations a pixel.
        Returns (ms, basis, source pixels tapped)."""
        h, w = fn.src_h, fn.src_w
        valid = (ix > -0.5) & (ix < w - 0.5) & (iy > -0.5) & (iy < h - 0.5)
        x = ix[valid].clamp(0, w - 1)
        y = iy[valid].clamp(0, h - 1)
        tapped = torch.zeros(h * w, dtype=torch.bool, device=dev)
        if interp == "nearest":
            tapped[torch.round(y).long() * w + torch.round(x).long()] = True
        else:
            x0, y0 = x.floor().long(), y.floor().long()
            for yy in (y0, (y0 + 1).clamp(max=h - 1)):
                for xx in (x0, (x0 + 1).clamp(max=w - 1)):
                    tapped[yy * w + xx] = True
        n_tapped = tapped.sum().item()
        n_out = fn.out_h * fn.out_w
        n_bytes = 4 * (n_out + n_tapped + fn.ix_c.numel() + fn.iy_c.numel())
        return bound(n_bytes, 30 * n_out) + (n_tapped,)

    def time_k3(fn, src, interp):
        """K3 and its plain version (time_pair) on *fn*'s fields; the
        library yardstick, one F.grid_sample (border padding, corners
        aligned) at the same full-resolution positions (event_ms and
        device_ms), which leaves out the field interpolation, the fill
        select and the triangular method; and K3's bound (k3_bound).  The
        positions and the bound are computed outside the timed windows."""
        x = src[None]
        args = (x, fn.ix_c, fn.iy_c, fn.step, fn.out_h, fn.out_w, interp, nan)
        pair = time_pair(lambda: fused_reproject(*args), lambda: fused_reproject_plain(*args))
        rows = torch.arange(fn.out_h, dtype=torch.float32, device=dev)[:, None]
        cols = torch.arange(fn.out_w, dtype=torch.float32, device=dev)[None, :]
        ix = interp_field(fn.ix_c, rows, cols, fn.step)
        iy = interp_field(fn.iy_c, rows, cols, fn.step)
        k3_b = k3_bound(fn, ix, iy, interp)
        grid = torch.stack(
            (ix / (fn.src_w - 1) * 2 - 1, iy / (fn.src_h - 1) * 2 - 1), dim=-1
        )[None]
        del ix, iy

        def library_call():
            return F.grid_sample(
                x[None], grid, mode=interp, padding_mode="border", align_corners=True
            )

        # the same gather up to grid_sample's own rounding of the positions
        k3_out = fused_reproject(*args)[0]
        valid = torch.isfinite(k3_out)
        diff = (library_call()[0, 0] - k3_out)[valid].abs()
        print(
            f"{tag} F.grid_sample vs K3 ({interp}, {fn.out_h}x{fn.out_w}) on valid "
            f"pixels: max abs diff {diff.max().item():.3g}, share above 1e-6 "
            f"{(diff > 1e-6).float().mean().item():.3g}"
        )
        del k3_out, valid, diff
        return pair, (event_ms(library_call), device_ms(library_call)), k3_b

    def affine_plain(data, source_gm, target_gm, order, agg, fill):
        """The affine engine's downscale of *data* through the plain
        versions of K4 and K5/K6: the residual gather at the inflated size,
        then the window reduction (``affine._resample_array``)."""
        (j_div, i_div), residual = _scale_split(target_gm.ij_transform_to(source_gm))
        (i_s, _, i_o), (_, j_s, j_o) = residual
        up = affine_gather_plain(
            data, j_s, i_s, j_o, i_o, target_gm.height * j_div, target_gm.width * i_div,
            order, fill,
        )
        return coarsen_plain(up, j_div, i_div, agg)

    def warm_calls(ds, target_gm, interp, expect, n, **kwargs):
        """The median wall time of *n* more main-path calls, and the last
        output."""
        times = []
        for _ in range(n):
            out, dt = run_main(ds, target_gm, interp, expect, **kwargs)
            times.append(dt)
        return out, statistics.median(times)

    timings = {}
    bounds = {}
    library = {"srw_vertical": (None, None), "srw_horizontal": (None, None)}

    # -- 1. the headline: 20480^2 UTM32N -> EPSG:3035 bilinear ----------------
    n = 20480
    utm_gm = GridMapping.regular(
        size=(n, n), xy_min=(300000.0, 5200000.0), xy_res=30.0, crs="epsg:32632"
    )
    laea_gm = GridMapping.regular(
        size=(n, n), xy_min=(4050000.0, 2650000.0), xy_res=30.0, crs="epsg:3035"
    )
    t0 = time.perf_counter()
    src = torch.from_numpy(
        np.random.default_rng(0).random((n, n), dtype=np.float32)
    ).to(dev)
    ds = dataset(utm_gm, v=src)
    print(f"{tag} 20480^2 source made and uploaded in {time.perf_counter() - t0:.2f} s")
    out, first = run_main(ds, laea_gm, "bilinear", ("srw_vertical", "srw_horizontal"))
    img = out["v"].data
    share = check_output(img, (n, n))
    warm = []
    for _ in range(5):
        out, dt = run_main(ds, laea_gm, "bilinear", ("srw_vertical", "srw_horizontal"))
        warm.append(dt)
    w = statistics.median(warm)
    mpix = n * n / 1e6
    print(
        f"{tag} resample_in_space 20480^2 UTM32N->EPSG:3035 bilinear: first call "
        f"{first:.3f} s = {mpix / first:.1f} Mpix/s (planning "
        f"included); warm median of 5 {w * 1e3:.2f} ms = {mpix / w:.1f} Mpix/s; "
        f"finite share {share:.4f}"
    )
    fn = device_reproject_fn(GridMapping.from_dataset(ds), laea_gm, "bilinear", nan, dev)
    if not isinstance(fn, SRWFn):
        raise AssertionError(f"headline ran {type(fn).__name__}, not the tiled SRW tier")
    st = fn.state
    print(
        f"{tag} headline plan: d_v={st.d_v} d_h={st.d_h} col_tile={st.col_tile} "
        f"row_tile={st.row_tile} window={fn.window} source {st.src_h}x{st.src_w}"
    )
    d = compare(out["v"].data, fn.plain(src), "bilinear", "20480^2 slice vs plain K1->K2")
    print(f"{tag} 20480^2 slice vs plain vertical->horizontal: max abs diff {d}")
    del out, img

    print(
        f"{tag} headline windows: K1 blocks {st.win_v.rows}x{st.win_v.cols}, "
        f"{st.win_v.extent} source rows staged; K2 blocks "
        f"{st.win_h.rows}x{st.win_h.cols}, {st.win_h.extent} v columns staged"
    )

    # K1 and K2 held against their plain versions and timed at the
    # headline's shapes
    x = fn.crop(src)
    v_args = fn.vertical_args(x)
    v, _ = srw_vertical(*v_args)
    d1 = compare(v, srw_vertical_plain(*v_args)[0], "bilinear", "20480^2 K1 vs plain")
    h_args = fn.horizontal_args(v)
    d2 = compare(srw_horizontal(*h_args), srw_horizontal_plain(*h_args), "bilinear",
                 "20480^2 K2 vs plain")
    err["srw_vertical"] = max(err["srw_vertical"], d1)
    err["srw_horizontal"] = max(err["srw_horizontal"], d2)
    timings["srw_vertical"] = time_pair(
        lambda: srw_vertical(*v_args), lambda: srw_vertical_plain(*v_args)
    )
    timings["srw_horizontal"] = time_pair(
        lambda: srw_horizontal(*h_args), lambda: srw_horizontal_plain(*h_args)
    )
    bounds["srw_vertical"] = vertical_bound(x, st, False)
    bounds["srw_horizontal"] = horizontal_bound(v, st, False)
    for name in ("srw_vertical", "srw_horizontal"):
        k, p, kd = timings[name]
        b, by = bounds[name]
        print(
            f"{tag} {name} at 20480^2 (source {st.src_h}x{st.src_w}): kernel "
            f"{k:.3f} ms (device {kd:.3f} ms), plain {p:.3f} ms, bound {b:.3f} ms "
            f"({by}); vs plain max abs diff {err[name]}"
        )
    del fn, x, v, v_args, h_args
    torch.cuda.empty_cache()

    # -- 1b. the headline's source onto a coarser grid: the pre-downscale ----
    # 5120^2 EPSG:3035 at 120 m: the target's span in the source gives a
    # scale of 0.247, so reproject_dataset clips the source (a view; here
    # the span covers all of it), K4's downscale form takes the means of
    # 5x5 windows of the bilinear gather at the residual scales (no
    # inflated image) and the tiled SRW (K1 + K2) reprojects the coarse
    # image.  A spy on the engine's affine call keeps its input and output
    # for the plain check.
    laea120_gm = GridMapping.regular(
        size=(5120, 5120), xy_min=(4050000.0, 2650000.0), xy_res=120.0, crs="epsg:3035"
    )
    down = ("affine_gather_reduce", "srw_vertical", "srw_horizontal")
    seen = []
    engine_affine = port_reproject.affine_transform_dataset

    def spy(source_ds, coarse_gm, **kwargs):
        out = engine_affine(source_ds, coarse_gm, **kwargs)
        seen[:] = [(source_ds, coarse_gm, kwargs["source_gm"], out)]
        return out

    port_reproject.affine_transform_dataset = spy
    try:
        out, first = run_main(ds, laea120_gm, "bilinear", down, agg_methods="mean")
        first_counts = {k: LAUNCHES[k] for k in down}
        out, w = warm_calls(ds, laea120_gm, "bilinear", down, 3, agg_methods="mean")
        del out
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, _ = run_main(ds, laea120_gm, "bilinear", down, agg_methods="mean")
        peak_mem = torch.cuda.max_memory_allocated()
    finally:
        port_reproject.affine_transform_dataset = engine_affine
    share = check_output(out["v"].data, (5120, 5120))
    clip_ds, coarse_gm, clip_gm, coarse_ds = seen[0]
    clipped, coarse = clip_ds["v"].data, coarse_ds["v"].data
    if clipped.untyped_storage().data_ptr() != src.untyped_storage().data_ptr():
        raise AssertionError("the clipped source is a copy, not a view of the source")
    (j_div, i_div), residual = _scale_split(coarse_gm.ij_transform_to(clip_gm))
    coarse_ref = affine_plain(clipped, clip_gm, coarse_gm, 1, "mean", nan)
    d_down = compare(coarse, coarse_ref, "stat", "pre-downscale downscale form vs plain")
    err["affine_gather_reduce"] = max(err["affine_gather_reduce"], d_down)
    coarse_fn = device_reproject_fn(
        GridMapping.from_dataset(coarse_ds), laea120_gm, "bilinear", nan, dev
    )
    if not isinstance(coarse_fn, SRWFn):
        raise AssertionError(f"the coarse image ran {type(coarse_fn).__name__}, not the tiled SRW")
    d = compare(out["v"].data, coarse_fn.plain(coarse_ref), "bilinear",
                "pre-downscaled reproject vs plain K4 -> K5 -> K1 -> K2")
    mpix = 5120 * 5120 / 1e6
    inflated = (coarse_gm.height * j_div, coarse_gm.width * i_div)
    print(
        f"{tag} resample_in_space 20480^2 UTM32N->EPSG:3035 5120^2 at 120 m, bilinear, "
        f"mean: clipped source {tuple(clipped.shape)} (strides {clipped.stride()}), "
        f"{j_div}x{i_div} windows, residual scales {residual[1][1]:.4f}, "
        f"{residual[0][0]:.4f}, inflated {inflated[0]}x{inflated[1]} (not written), "
        f"coarse {coarse_gm.height}x{coarse_gm.width}; first call {first:.3f} s "
        f"(launches {first_counts}); warm median of 3 {w * 1e3:.2f} ms = "
        f"{mpix / w:.1f} Mpix/s; finite share {share:.4f}; coarse vs plain "
        f"{d_down}, output vs plain {d}; device memory of a call: peak "
        f"{peak_mem / 2**30:.3f} GiB, {(peak_mem - base_mem) / 2**30:.3f} GiB above "
        f"the {base_mem / 2**30:.3f} GiB held before it"
    )
    # the chain the downscale form replaces: K4 at the inflated size, K5
    (i_s, _, i_o), (_, j_s, j_o) = residual
    down_args = (clipped, j_s, i_s, j_o, i_o, *inflated, 1, nan)
    fused_args = (clipped, j_s, i_s, j_o, i_o, coarse_gm.height, coarse_gm.width,
                  j_div, i_div, "mean", nan)
    up = affine_gather(*down_args)
    err["affine_gather"] = max(err["affine_gather"], compare(
        up, affine_gather_plain(*down_args), "exact", "K4 at the pre-downscale shape vs plain"
    ))
    compare(affine_gather_reduce(*fused_args), coarsen_reduce(up, j_div, i_div, "mean"),
            "exact", "pre-downscale downscale form vs K4 -> K5")
    k4_down = (event_ms(lambda: affine_gather(*down_args), 3),
               device_ms(lambda: affine_gather(*down_args), 3))
    k5_down = (event_ms(lambda: coarsen_reduce(up, j_div, i_div, "mean"), 3),
               device_ms(lambda: coarsen_reduce(up, j_div, i_div, "mean"), 3))
    kr_down = (event_ms(lambda: affine_gather_reduce(*fused_args), 3),
               device_ms(lambda: affine_gather_reduce(*fused_args), 3))
    b4, by4 = affine_gather_bound(clipped[None], *inflated, 1)
    b5, by5 = reduce_bound(up[None], j_div, i_div, "mean", 4)
    br, byr = gather_reduce_bound(clipped[None], residual, coarse_gm.height,
                                  coarse_gm.width, j_div, i_div, "mean", 4)
    print(
        f"{tag} pre-downscale kernels: affine_gather_reduce mean {j_div}x{i_div} "
        f"{kr_down[0]:.3f} ms (device {kr_down[1]:.3f} ms), bound {br:.3f} ms ({byr}), "
        f"equal to the chain it replaces: affine_gather {k4_down[0]:.3f} ms (device "
        f"{k4_down[1]:.3f} ms), bound {b4:.3f} ms ({by4}), then coarsen_reduce mean "
        f"{k5_down[0]:.3f} ms (device {k5_down[1]:.3f} ms), bound {b5:.3f} ms ({by5})"
    )
    del out, seen, clip_ds, coarse_ds, clipped, coarse, coarse_ref, up, down_args, fused_args
    del coarse_fn, src, ds
    torch.cuda.empty_cache()

    # -- 2. EPSG:4326 0.05 deg -> UTM32N 4096^2 --------------------------------
    geo_gm = GridMapping.regular(
        size=(7200, 3600), xy_min=(-180.0, -90.0), xy_res=0.05, crs="epsg:4326"
    )
    utm4k_gm = GridMapping.regular(
        size=(4096, 4096), xy_min=(250000.0, 5200000.0), xy_res=150.0,
        crs="epsg:32632",
    )
    geo = torch.from_numpy(
        np.random.default_rng(0).random((3600, 7200), dtype=np.float32)
    ).to(dev)
    ds1 = dataset(geo_gm, v=geo)
    geo_gm_ds = GridMapping.from_dataset(ds1)
    for interp in ("nearest", "triangular"):
        out, dt = run_main(ds1, utm4k_gm, interp, ("srw_vertical", "srw_horizontal"))
        share = check_output(out["v"].data, (4096, 4096))
        fn = device_reproject_fn(geo_gm_ds, utm4k_gm, interp, nan, dev)
        d = compare(out["v"].data, fn.plain(geo), interp, f"4326->UTM {interp}")
        print(
            f"{tag} resample_in_space 4326->UTM32N 4096^2 {interp}: first call "
            f"{dt:.3f} s; vs plain max abs diff {d}; finite share {share:.4f}"
        )
    stack = torch.stack([geo, 2 * geo])
    ds2 = dataset(geo_gm, v=stack)
    out, dt = run_main(ds2, utm4k_gm, "bilinear", ("srw_vertical", "srw_horizontal"))
    check_output(out["v"].data, (2, 4096, 4096))
    fn = device_reproject_fn(geo_gm_ds, utm4k_gm, "bilinear", nan, dev)
    d = compare(out["v"].data, fn.plain(stack), "bilinear", "4326->UTM 2-band")
    print(
        f"{tag} resample_in_space 4326->UTM32N 4096^2 bilinear 2-band: first call "
        f"{dt:.3f} s; vs plain max abs diff {d}; plan d_v={fn.state.d_v} "
        f"d_h={fn.state.d_h} window={fn.window}"
    )

    # -- 3. the exact tier: XRTPU_EXACT=1 runs K3 ------------------------------
    os.environ["XRTPU_EXACT"] = "1"
    try:
        out, dt = run_main(ds1, utm4k_gm, "bilinear", ("fused_reproject",))
        check_output(out["v"].data, (4096, 4096))
        fn = device_reproject_fn(geo_gm_ds, utm4k_gm, "bilinear", nan, dev)
    finally:
        del os.environ["XRTPU_EXACT"]
    if not isinstance(fn, FusedReprojectFn):
        raise AssertionError(f"exact tier ran {type(fn).__name__}, not K3")
    d = compare(out["v"].data, fn.plain(geo), "bilinear", "exact tier vs plain K3")
    err["fused_reproject"] = max(err["fused_reproject"], d)
    print(f"{tag} XRTPU_EXACT=1 4326->UTM32N 4096^2 bilinear: first call {dt:.3f} s; vs plain max abs diff {d}")
    timings["fused_reproject"], library["fused_reproject"], (b, by, n_tapped) = time_k3(
        fn, geo, "bilinear"
    )
    bounds["fused_reproject"] = (b, by)
    (k, p, kd), (lib, lib_d) = timings["fused_reproject"], library["fused_reproject"]
    print(
        f"{tag} fused_reproject at 4096^2 UTM32N from 3600x7200, bilinear: kernel "
        f"{k:.4f} ms (device {kd:.4f} ms), plain {p:.3f} ms, bound {b:.4f} ms ({by}; "
        f"{n_tapped} source pixels tapped), F.grid_sample {lib:.4f} ms (device "
        f"{lib_d:.4f} ms)"
    )

    # -- 3b. BASELINE #3: global 0.05 deg EPSG:4326 -> EPSG:3035 4096^2 -------
    # a singular warp (the target reaches 87.6 N): the default dispatch
    # refuses the tiled SRW plan and runs K3, with no XRTPU_EXACT
    laea4k_gm = GridMapping.regular(
        size=(4096, 4096), xy_min=(2000000.0, 1000000.0), xy_res=1500.0,
        crs="epsg:3035",
    )
    for interp in ("nearest", "bilinear"):
        out, first = run_main(ds1, laea4k_gm, interp, ("fused_reproject",))
        share = check_output(out["v"].data, (4096, 4096))
        warm = []
        for _ in range(5):
            out, dt = run_main(ds1, laea4k_gm, interp, ("fused_reproject",))
            warm.append(dt)
        w = statistics.median(warm)
        fn = device_reproject_fn(geo_gm_ds, laea4k_gm, interp, nan, dev)
        if not isinstance(fn, FusedReprojectFn):
            raise AssertionError(f"BASELINE #3 ran {type(fn).__name__}, not K3")
        d = compare(out["v"].data, fn.plain(geo), interp, f"BASELINE #3 {interp} vs plain K3")
        err["fused_reproject"] = max(err["fused_reproject"], d)
        mpix = 4096 * 4096 / 1e6
        print(
            f"{tag} resample_in_space BASELINE #3 4326 0.05 deg->EPSG:3035 4096^2 "
            f"{interp} (K3, no XRTPU_EXACT): first call {first:.3f} s = "
            f"{mpix / first:.1f} Mpix/s (planning included); warm median of 5 "
            f"{w * 1e3:.3f} ms = {mpix / w:.1f} Mpix/s; finite share {share:.4f}; "
            f"vs plain max abs diff {d}"
        )
        (k, p, kd), (lib, lib_d), (b, by, n_tapped) = time_k3(fn, geo, interp)
        print(
            f"{tag} fused_reproject at BASELINE #3 ({interp}): kernel {k:.4f} ms "
            f"(device {kd:.4f} ms), plain {p:.3f} ms, bound {b:.4f} ms ({by}; "
            f"{n_tapped} source pixels tapped), F.grid_sample {lib:.4f} ms (device "
            f"{lib_d:.4f} ms)"
        )
    del out

    # -- 4. a small case: numpy and tensor variables, against K3 -------------
    small_src = GridMapping.regular(
        size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"
    )
    small_tgt = GridMapping.regular(
        size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035"
    )
    ramp = np.arange(96 * 96, dtype=np.float32).reshape(96, 96) / 96
    ramp_dev = torch.from_numpy(ramp).to(dev)
    for interp in METHODS:
        LAUNCHES.clear()
        out = resample_in_space(
            dataset(small_src, host=ramp, dev=ramp_dev), target_gm=small_tgt,
            interp_methods=interp, device=dev,
        )
        torch.cuda.synchronize()
        main_launches.update(LAUNCHES)
        if LAUNCHES["srw_vertical"] < 2 or LAUNCHES["srw_horizontal"] < 2:
            raise AssertionError(f"small case {interp} skipped the SRW tier: {dict(LAUNCHES)}")
        a = out["host"].data
        if not (isinstance(a, torch.Tensor) and a.device == dev):
            raise AssertionError(f"numpy variable did not come back on {dev}")
        if not torch.equal(torch.isnan(a), torch.isnan(out["dev"].data)) or not torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(out["dev"].data)
        ):
            raise AssertionError(f"small case {interp}: numpy and tensor variables differ")
        k3 = make_fused_reproject_fn(small_src, small_tgt, interp, nan, dev)
        a = a.cpu().numpy()
        b = k3.plain(ramp_dev[None])[0].cpu().numpy()
        both = np.isfinite(a) & np.isfinite(b)
        mask_diff = float((np.isnan(a) != np.isnan(b)).mean())
        diff = np.abs(a[both] - b[both])
        # the two-pass path deviates from the direct gather by a fraction
        # of a pixel (documented ~1e-2 px); the ramp rises 1 per row:
        # bilinear and triangular within 1e-2, nearest may flip to the
        # equally near cell on under 1% of pixels (tests/test_srw.py)
        flips = float((diff > 1e-6).mean())
        ok = both.mean() > 0.5 and mask_diff < 0.02 and (
            flips < 0.01 if interp == "nearest" else diff.max() < 1e-2
        )
        print(
            f"{tag} 96^2 UTM32N->EPSG:3035 {interp}, numpy variable on the card "
            f"(equals the tensor variable) vs the port's K3: max abs diff "
            f"{diff.max():.3g}, differing share {flips:.4f}, NaN-mask mismatch "
            f"{mask_diff:.4f}"
        )
        if not ok:
            raise AssertionError(f"small case {interp} disagrees with K3")

    # -- 4b. BASELINE #1: affine 2x bilinear downscale, 16 x 1024^2 float32 --
    # UTM32N 30 m -> UTM32N 60 m over the same corner, aggregated with mean:
    # the affine route, one launch of K4's downscale form (2x2 means of the
    # residual gather, here the identity) per call
    gen = torch.Generator(device=dev).manual_seed(0)
    b1_gm = GridMapping.regular(
        size=(1024, 1024), xy_min=(300000.0, 5200000.0), xy_res=30.0, crs="epsg:32632"
    )
    b1_tgt = GridMapping.regular(
        size=(512, 512), xy_min=(300000.0, 5200000.0), xy_res=60.0, crs="epsg:32632"
    )
    b1 = torch.rand((16, 1024, 1024), generator=gen, device=dev)
    ds_b1 = dataset(b1_gm, v=b1)
    once = {"affine_gather_reduce": 1}
    out, first = run_main(ds_b1, b1_tgt, "bilinear", tuple(once), once, agg_methods="mean")
    out, w = warm_calls(ds_b1, b1_tgt, "bilinear", tuple(once), 5, exact=once,
                        agg_methods="mean")
    check_output(out["v"].data, (16, 512, 512))
    b1_gm_ds = GridMapping.from_dataset(ds_b1)
    d = compare(out["v"].data, affine_plain(b1, b1_gm_ds, b1_tgt, 1, "mean", nan), "stat",
                "BASELINE #1 vs plain K4 -> K5")
    err["affine_gather_reduce"] = max(err["affine_gather_reduce"], d)
    mpix = 16 * 1024 * 1024 / 1e6
    print(
        f"{tag} resample_in_space BASELINE #1 (affine route, 16x1024^2 float32 -> "
        f"16x512^2, bilinear, mean): first call {first * 1e3:.2f} ms; warm median of 5 "
        f"{w * 1e3:.3f} ms = {mpix / w:.1f} Mpix/s of source; vs plain max abs diff {d}"
    )

    # -- 4c. BASELINE #2: a 4-band 4096^2 raster coarsened 4x -----------------
    # a and b float32 with NaN rows and all-NaN windows, c int32 in [0, 16);
    # mean of a, first of b, mode of c, through ops.coarsen_ops.coarsen (K5,
    # K6) and through an exact 4x affine downscale (c interpolated
    # bilinearly: a nearest variable never aggregates): K4's downscale form
    # for a and b, K4 then K6 for c
    b2_gm = GridMapping.regular(
        size=(4096, 4096), xy_min=(300000.0, 5200000.0), xy_res=30.0, crs="epsg:32632"
    )
    b2_tgt = GridMapping.regular(
        size=(1024, 1024), xy_min=(300000.0, 5200000.0), xy_res=120.0, crs="epsg:32632"
    )
    b2a = torch.rand((4, 4096, 4096), generator=gen, device=dev)
    b2a[0, 1000:1003] = nan
    b2a[1, 64:72, 128:160] = nan
    b2b = torch.rand((4, 4096, 4096), generator=gen, device=dev)
    b2b[2, 2000] = nan
    b2b[3, 0:4, 0:64] = nan
    b2c = torch.randint(0, 16, (4, 4096, 4096), generator=gen, device=dev, dtype=torch.int32)
    b2_cases = (("mean", b2a, "stat"), ("first", b2b, "exact"), ("mode", b2c, "exact"))
    LAUNCHES.clear()
    t0 = time.perf_counter()
    direct = {agg: coarsen(x, 4, 4, agg) for agg, x, _ in b2_cases}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    main_launches.update(LAUNCHES)
    if LAUNCHES["coarsen_reduce"] != 2 or LAUNCHES["coarsen_rank"] != 1:
        raise AssertionError(f"coarsen launched {dict(LAUNCHES)}")
    for agg, x, kind in b2_cases:
        name = "coarsen_rank" if agg == "mode" else "coarsen_reduce"
        err[name] = max(err[name], compare(
            direct[agg], coarsen_plain(x, 4, 4, agg), kind, f"BASELINE #2 coarsen {agg}"
        ))
    print(f"{tag} ops.coarsen_ops.coarsen BASELINE #2 4x mean, first, mode: "
          f"{dt * 1e3:.2f} ms for the three calls")
    ds_b2 = dataset(b2_gm, a=b2a, b=b2b, c=b2c)
    aggs = {"a": "mean", "b": "first", "c": "mode"}
    counts = {"affine_gather_reduce": 2, "affine_gather": 1, "coarsen_rank": 1}
    out, first = run_main(ds_b2, b2_tgt, {"c": 1}, tuple(counts), counts, agg_methods=aggs)
    out, w = warm_calls(ds_b2, b2_tgt, {"c": 1}, tuple(counts), 5, exact=counts,
                        agg_methods=aggs)
    b2_gm_ds = GridMapping.from_dataset(ds_b2)
    for name, x, fill in (("a", b2a, nan), ("b", b2b, nan), ("c", b2c, -1)):
        check_output(out[name].data, (4, 1024, 1024), x.dtype)
        agg = aggs[name]
        d = compare(out[name].data, affine_plain(x, b2_gm_ds, b2_tgt, 1, agg, fill),
                    "stat" if agg == "mean" else "exact", f"BASELINE #2 {name} vs plain")
        kernel = "coarsen_rank" if agg == "mode" else "affine_gather_reduce"
        err[kernel] = max(err[kernel], d)
    mpix = 3 * 4 * 4096 * 4096 / 1e6
    print(
        f"{tag} resample_in_space BASELINE #2 (affine route, exact 4x, a mean, b first, "
        f"c mode, 3 x 4x4096^2): first call {first * 1e3:.2f} ms; warm median of 5 "
        f"{w * 1e3:.3f} ms = {mpix / w:.1f} Mpix/s of source"
    )
    del out, ds_b2

    # -- 5. each kernel against its plain version, every method ---------------
    # NaN rows in the middle of the source window the target taps, and a
    # geometry whose target reaches past the source's top and bottom, so
    # the K1 windows clip at both edges (base_v < 0, base_v + d_v > src_h)
    fn = device_reproject_fn(geo_gm_ds, utm4k_gm, "bilinear", nan, dev)
    j_mid = (fn.window[0] + fn.window[1]) // 2 if fn.window else geo.shape[0] // 2
    nan_stack = stack.clone()
    nan_stack[0, j_mid] = nan
    nan_stack[1, j_mid + 1 : j_mid + 4] = nan
    # a UTM32N source and a larger EPSG:3035 target around it, at 30 m
    edge_src = GridMapping.regular(
        size=(2048, 2048), xy_min=(500000.0, 5400000.0), xy_res=30.0, crs="epsg:32632"
    )
    edge_tgt = GridMapping.regular(
        size=(2304, 2688), xy_min=(4245000.0, 2838000.0), xy_res=30.0, crs="epsg:3035"
    )
    edge_data = torch.from_numpy(
        np.random.default_rng(1).random((2, edge_src.height, edge_src.width), dtype=np.float32)
    ).to(dev)
    edge_data[1, edge_src.height // 2] = nan
    # BASELINE #3's target cut to a width that is no multiple of 4 and
    # partial tiles down and across: K3's scalar stores and ragged tiles
    ragged_gm = GridMapping.regular(
        size=(4093, 4099), xy_min=(2000000.0, 1000000.0), xy_res=1500.0,
        crs="epsg:3035",
    )
    for interp in METHODS:
        cases = (
            ("4326->UTM 2-band with NaN rows",
             device_reproject_fn(geo_gm_ds, utm4k_gm, interp, nan, dev), nan_stack),
            ("edge-clipping UTM32N->EPSG:3035 2-band",
             make_srw_reproject_fn(edge_src, edge_tgt, interp, nan, dev), edge_data),
        )
        for what, fn, data in cases:
            if not isinstance(fn, SRWFn):
                raise AssertionError(f"{what}: no tiled SRW plan")
            st = fn.state
            if what.startswith("edge") and not (
                st.base_v.min().item() < 0
                and st.base_v.max().item() + st.d_v > st.src_h
            ):
                raise AssertionError(f"{what}: the K1 windows do not clip at both edges")
            v_args = fn.vertical_args(fn.crop(data))
            v, vd = srw_vertical(*v_args)
            v_p, vd_p = srw_vertical_plain(*v_args)
            d1 = compare(v, v_p, interp, f"K1 {interp} {what}")
            if vd is not None:
                d1 = max(d1, compare(vd, vd_p, interp, f"K1 {interp} vd {what}"))
            if not torch.isnan(v_p).any():
                raise AssertionError(f"{what}: the NaN rows reached no vertical output")
            h_args = fn.horizontal_args(v_p)
            d2 = compare(
                srw_horizontal(*h_args, vd_p), srw_horizontal_plain(*h_args, vd_p),
                interp, f"K2 {interp} {what}",
            )
            err["srw_vertical"] = max(err["srw_vertical"], d1)
            err["srw_horizontal"] = max(err["srw_horizontal"], d2)
            print(f"{tag} kernels vs plain, {what}, {interp}: K1 {d1}, K2 {d2}")
            if interp == "bilinear" and what.startswith("4326"):
                k1, p1, _ = time_pair(
                    lambda: srw_vertical(*v_args), lambda: srw_vertical_plain(*v_args)
                )
                k2, p2, _ = time_pair(
                    lambda: srw_horizontal(*h_args), lambda: srw_horizontal_plain(*h_args)
                )
                print(
                    f"{tag} at the 4326->UTM 2-band bilinear shapes (window "
                    f"{st.src_h}x{st.src_w} -> 4096^2): srw_vertical kernel {k1:.3f} ms, "
                    f"plain {p1:.3f} ms; srw_horizontal kernel {k2:.3f} ms, plain {p2:.3f} ms"
                )
        for what, tgt in (("4326->UTM", utm4k_gm), ("4326->EPSG:3035 ragged", ragged_gm)):
            k3 = make_fused_reproject_fn(geo_gm, tgt, interp, nan, dev)
            d3 = compare(k3(nan_stack), k3.plain(nan_stack), interp, f"K3 {interp} {what}")
            err["fused_reproject"] = max(err["fused_reproject"], d3)
            print(f"{tag} K3 vs plain, {what} {tgt.width}x{tgt.height} 2-band with "
                  f"NaN rows, {interp}: {d3}")
    torch.cuda.synchronize()

    # -- 6. K4, K5 and K6 against their plain versions; their timings --------
    rng = np.random.default_rng(2)
    for dtype in (torch.float32, torch.float64, torch.uint8, torch.int32):
        if dtype.is_floating_point:
            x = torch.from_numpy(rng.random((2, 300, 333))).to(dtype).to(dev)
            x[0, 7, 9] = nan
            fills = (nan, -9.5)
        else:
            x = torch.from_numpy(rng.integers(0, 250, (2, 300, 333))).to(dtype).to(dev)
            fills = (-1, 300.7)
        for order in (0, 1):
            for scales in ((0.7, 1.3, -0.4, 0.2), (-0.81, 0.77, 299.3, -3.0), (2.5, 2.0, 0.25, -0.5)):
                for fill in fills:
                    args = (x, *scales, 310, 257, order, fill)
                    d = compare(affine_gather(*args), affine_gather_plain(*args), "exact",
                                f"K4 {dtype} order {order} {scales} fill {fill}")
                    err["affine_gather"] = max(err["affine_gather"], d)
        print(f"{tag} K4 vs plain, {dtype}, both orders, negative scale, fills {fills}: equal")
    # K4's downscale form against its plain version and against K4 -> K5
    # on the card, every dtype and K5 reducer: 2x2 windows reaching past the
    # source on three sides (fill), 3x4 windows on a flipped axis, 5x5
    # windows on a strided view; a NaN block empties whole float windows
    down_cases = (
        (((1.9, 0.0, -1.5), (0.0, 2.0, 1.0)), (150, 180), (slice(None), slice(None))),
        (((-3.7, 0.0, 330.5), (0.0, 2.6, 0.3)), (114, 89), (slice(None), slice(None))),
        (((4.6, 0.0, 0.2), (0.0, 4.3, -0.4)), (64, 67), (slice(10, 290), slice(7, 320))),
    )
    int_ranges = {torch.int8: (-100, 100), torch.int16: (-30000, 30000),
                  torch.int32: (-10**6, 10**6), torch.uint8: (0, 256),
                  torch.uint16: (0, 65536)}
    n_down = 0
    for dtype in (torch.float32, torch.float64, torch.int8, torch.int16, torch.int32,
                  torch.uint8, torch.uint16):
        if dtype.is_floating_point:
            x = torch.from_numpy(rng.random((2, 300, 333))).to(dtype).to(dev)
            x[0, 40:60, 50:80] = nan
            x[1, 150] = nan
            fills = (nan, -9.5, nan)
        else:
            np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
            x = torch.from_numpy(
                rng.integers(*int_ranges[dtype], (2, 300, 333)).astype(np_dtype)
            ).to(dev)
            fills = (-1, 300.7, 7)
        for (matrix, (oh, ow), (rows, cols)), fill in zip(down_cases, fills):
            (j_div, i_div), residual = _scale_split(matrix)
            (i_s, _, i_o), (_, j_s, j_o) = residual
            view = x[:, rows, cols]
            up = affine_gather(view, j_s, i_s, j_o, i_o, oh * j_div, ow * i_div, 1, fill)
            for agg in REDUCERS:
                args = (view, j_s, i_s, j_o, i_o, oh, ow, j_div, i_div, agg, fill)
                got = affine_gather_reduce(*args)
                what = f"downscale form {dtype} {j_div}x{i_div} {agg} fill {fill}"
                compare(got, coarsen_reduce(up, j_div, i_div, agg), "exact",
                        f"{what} vs K4 -> K5", signs=True)
                kind = "stat" if dtype.is_floating_point and agg in (
                    "mean", "sum", "std", "var", "prod") else "exact"
                d = compare(got, affine_gather_reduce_plain(*args), kind, f"{what} vs plain")
                err["affine_gather_reduce"] = max(err["affine_gather_reduce"], d)
                n_down += 1
    print(f"{tag} affine_gather_reduce vs K4 -> K5 (equal, sign bits included) and vs "
          f"plain (max abs diff {err['affine_gather_reduce']}): {n_down} cases, 7 dtypes, "
          f"every K5 reducer, fill edges, a flipped axis, a strided view, all-NaN windows")
    f32 = torch.rand((2, 480, 480), generator=gen, device=dev)
    f32[0, 100] = nan
    f32[1, 0:8, 0:12] = nan  # all-NaN windows of (4, 4) and (4, 3)
    i32 = torch.randint(-50, 50, (2, 480, 480), generator=gen, device=dev, dtype=torch.int32)
    for x in (f32, i32):
        for window in ((4, 4), (4, 3)):
            for agg in REDUCERS:
                kind = "stat" if x.dtype.is_floating_point and agg in (
                    "mean", "sum", "std", "var", "prod") else "exact"
                d = compare(coarsen_reduce(x, *window, agg), coarsen_plain(x, *window, agg),
                            kind, f"K5 {x.dtype} {window} {agg}")
                err["coarsen_reduce"] = max(err["coarsen_reduce"], d)
    # ties (values in [0, 6)), NaN taps and all-NaN windows, and zeros of
    # both signs: 4, 9, 16 and 25 taps from registers, 64 and 81 staged
    ties = torch.randint(0, 6, (2, 720, 720), generator=gen, device=dev, dtype=torch.int32)
    ftie = (ties.float() * 0.25).masked_fill(torch.rand(ties.shape, generator=gen, device=dev) < 0.2, nan)
    ftie = torch.where((ties == 0) & (torch.rand(ties.shape, generator=gen, device=dev) < 0.5),
                       -0.0, ftie)
    ftie[0, :9, :9] = nan
    for x in (ties, ftie, ftie.double(), ties.to(torch.int16), ties.to(torch.uint8)):
        for window in ((2, 2), (3, 3), (4, 4), (5, 5), (8, 8), (9, 9)):
            for agg in ("mode", "median"):
                # the mode keeps the first tap of its value, sign included;
                # the plain median's sort may order -0.0 and +0.0 its own way
                d = compare(coarsen_rank(x, *window, agg), coarsen_plain(x, *window, agg),
                            "exact", f"K6 {x.dtype} {window} {agg}",
                            signs=agg == "mode" and window[0] * window[1] <= 64)
                err["coarsen_rank"] = max(err["coarsen_rank"], d)
    # 32 x 32 = 1024 taps: too large to stage, K6 reads its taps from memory
    for agg in ("mode", "median"):
        x = ties[:1, :64, :64].contiguous()
        d = compare(coarsen_rank(x, 32, 32, agg), coarsen_plain(x, 32, 32, agg), "exact",
                    f"K6 int32 (32, 32) {agg}")
        err["coarsen_rank"] = max(err["coarsen_rank"], d)
    print(f"{tag} K5 vs plain, every reducer, float32 with all-NaN windows and int32: "
          f"max abs diff {err['coarsen_reduce']}; K6 vs plain, mode and median at 4, 9, "
          f"16, 25, 64, 81 and (unstaged) 1024 taps, int32, int16, uint8, float32 and "
          f"float64 with ties, NaN and zeros of both signs: equal")

    # K4 where the main path launches it: BASELINE #2's `c` (int32, the
    # exact 4x downscale's identity residual gather before K6); there the
    # same function is a copy (every position on a source pixel)
    c_k4 = (b2c, 1.0, 1.0, 0.0, 0.0, 4096, 4096, 1, -1)
    err["affine_gather"] = max(err["affine_gather"], compare(
        affine_gather(*c_k4), affine_gather_plain(*c_k4), "exact",
        "K4 at BASELINE #2's c vs plain"))
    timings["affine_gather"] = time_pair(
        lambda: affine_gather(*c_k4), lambda: affine_gather_plain(*c_k4)
    )
    bounds["affine_gather"] = affine_gather_bound(b2c, 4096, 4096, 1)
    library["affine_gather"] = (event_ms(b2c.clone), device_ms(b2c.clone))
    print(
        f"{tag} affine_gather bilinear identity at BASELINE #2's c (4x4096^2 int32): "
        f"{timings['affine_gather'][0]:.4f} ms (device {timings['affine_gather'][2]:.4f}), "
        f"plain {timings['affine_gather'][1]:.3f}, bound {bounds['affine_gather'][0]:.4f} "
        f"({bounds['affine_gather'][1]}), the same function as a copy (clone) "
        f"{library['affine_gather'][0]:.4f} (device {library['affine_gather'][1]:.4f})"
    )
    # K4 and K5 at BASELINE #1's shapes, K6 at BASELINE #2's
    b1_args = (b1, 1.0, 1.0, 0.0, 0.0, 1024, 1024, 1, nan)
    b1_up = affine_gather(*b1_args)
    k4_b1 = time_pair(lambda: affine_gather(*b1_args), lambda: affine_gather_plain(*b1_args))
    k4_b1_bound = affine_gather_bound(b1, 1024, 1024, 1)
    lin = torch.arange(1024, dtype=torch.float32, device=dev) / 1023 * 2 - 1
    grid = torch.stack(torch.meshgrid(lin, lin, indexing="xy"), dim=-1)[None]

    def k4_library():
        return F.grid_sample(b1[None], grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    diff = (k4_library()[0] - b1_up).abs().max().item()
    k4_b1_library = (event_ms(k4_library), device_ms(k4_library))
    timings["coarsen_reduce"] = time_pair(
        lambda: coarsen_reduce(b1_up, 2, 2, "mean"), lambda: coarsen_plain(b1_up, 2, 2, "mean")
    )
    bounds["coarsen_reduce"] = reduce_bound(b1_up, 2, 2, "mean", 4)
    b1_windows = window_reshape(b1_up, 2, 2)
    library["coarsen_reduce"] = (
        event_ms(lambda: torch.nanmean(b1_windows, dim=(-3, -1))),
        device_ms(lambda: torch.nanmean(b1_windows, dim=(-3, -1))),
    )
    print(
        f"{tag} BASELINE #1 shapes (16x1024^2 float32): affine_gather bilinear "
        f"{k4_b1[0]:.4f} ms (device {k4_b1[2]:.4f}), plain {k4_b1[1]:.3f}, bound "
        f"{k4_b1_bound[0]:.4f} ({k4_b1_bound[1]}), F.grid_sample {k4_b1_library[0]:.4f} "
        f"(device {k4_b1_library[1]:.4f}; max abs diff to K4 {diff:.3g}); "
        f"coarsen_reduce mean 2x2 {timings['coarsen_reduce'][0]:.4f} ms (device "
        f"{timings['coarsen_reduce'][2]:.4f}), plain {timings['coarsen_reduce'][1]:.3f}, "
        f"bound {bounds['coarsen_reduce'][0]:.4f} ({bounds['coarsen_reduce'][1]}), "
        f"torch.nanmean {library['coarsen_reduce'][0]:.4f} (device "
        f"{library['coarsen_reduce'][1]:.4f})"
    )
    # K4's downscale form at BASELINE #1 (2x2 means of the identity
    # residual gather), beside the chain K4 -> K5 it replaces there; with
    # the identity gather and no NaN in b1 it is the 2x2 NaN-aware mean of
    # b1, which torch.nanmean over the window view computes (in float32)
    b1_fused = (b1, 1.0, 1.0, 0.0, 0.0, 512, 512, 2, 2, "mean", nan)
    compare(affine_gather_reduce(*b1_fused), coarsen_reduce(b1_up, 2, 2, "mean"), "exact",
            "BASELINE #1 downscale form vs K4 -> K5")
    timings["affine_gather_reduce"] = time_pair(
        lambda: affine_gather_reduce(*b1_fused), lambda: affine_gather_reduce_plain(*b1_fused)
    )
    identity = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    bounds["affine_gather_reduce"] = gather_reduce_bound(b1, identity, 512, 512, 2, 2, "mean", 4)
    b1_src_windows = window_reshape(b1, 2, 2)
    library["affine_gather_reduce"] = (
        event_ms(lambda: torch.nanmean(b1_src_windows, dim=(-3, -1))),
        device_ms(lambda: torch.nanmean(b1_src_windows, dim=(-3, -1))),
    )
    lib_diff = (torch.nanmean(b1_src_windows, dim=(-3, -1))
                - affine_gather_reduce(*b1_fused)).abs().max().item()
    k, p, kd = timings["affine_gather_reduce"]
    print(
        f"{tag} affine_gather_reduce mean 2x2 at BASELINE #1: {k:.4f} ms (device {kd:.4f}), "
        f"plain {p:.3f}, bound {bounds['affine_gather_reduce'][0]:.4f} "
        f"({bounds['affine_gather_reduce'][1]}); the chain K4 -> K5 it replaces: device "
        f"{k4_b1[2] + timings['coarsen_reduce'][2]:.4f} ms; torch.nanmean over b1's 2x2 "
        f"windows {library['affine_gather_reduce'][0]:.4f} (device "
        f"{library['affine_gather_reduce'][1]:.4f}; max abs diff {lib_diff:.3g})"
    )
    del b1_up, b1_windows, b1_src_windows, grid
    for agg, x in (("mean", b2a), ("first", b2b)):
        # the affine route's downscale form beside its chain (identity K4, K5)
        b2_fused = (x, 1.0, 1.0, 0.0, 0.0, 1024, 1024, 4, 4, agg, nan)
        kr = (event_ms(lambda: affine_gather_reduce(*b2_fused)),
              device_ms(lambda: affine_gather_reduce(*b2_fused)))
        chain_d = device_ms(lambda: coarsen_reduce(
            affine_gather(x, 1.0, 1.0, 0.0, 0.0, 4096, 4096, 1, nan), 4, 4, agg))
        b, by = gather_reduce_bound(x, identity, 1024, 1024, 4, 4, agg, 4)
        print(
            f"{tag} affine_gather_reduce {agg} 4x4 at BASELINE #2 (4x4096^2 float32): "
            f"{kr[0]:.4f} ms (device {kr[1]:.4f}), bound {b:.4f} ({by}); the chain K4 -> K5 "
            f"it replaces: device {chain_d:.4f} ms"
        )
        k, p, kd = time_pair(lambda: coarsen_reduce(x, 4, 4, agg),
                             lambda: coarsen_plain(x, 4, 4, agg))
        b, by = reduce_bound(x, 4, 4, agg, 4)
        if agg == "mean":
            win = window_reshape(x, 4, 4)
            lib_call = lambda: torch.nanmean(win, dim=(-3, -1))  # noqa: E731
            lib_name = "torch.nanmean"
        else:
            lib_call = lambda: x[..., ::4, ::4].contiguous()  # noqa: E731
            lib_name = "x[..., ::4, ::4].contiguous()"
        print(
            f"{tag} coarsen_reduce {agg} 4x4 at BASELINE #2 (4x4096^2 float32): {k:.4f} ms "
            f"(device {kd:.4f}), plain {p:.3f}, bound {b:.4f} ({by}), {lib_name} "
            f"{event_ms(lib_call):.4f} (device {device_ms(lib_call):.4f})"
        )
    c_args = (b2c, 4, 4, "mode")
    timings["coarsen_rank"] = time_pair(lambda: coarsen_rank(*c_args), lambda: coarsen_plain(*c_args))
    bounds["coarsen_rank"] = rank_bound(b2c, 4, 4)
    flat = window_reshape(b2c, 4, 4).movedim(-3, -2).reshape(-1, 16).contiguous()
    lib_mode = torch.mode(flat, dim=-1).values.reshape(4, 1024, 1024)
    tie_share = (lib_mode != direct["mode"]).float().mean().item()
    library["coarsen_rank"] = (event_ms(lambda: torch.mode(flat, dim=-1)),
                               device_ms(lambda: torch.mode(flat, dim=-1)))
    print(
        f"{tag} coarsen_rank mode 4x4 at BASELINE #2 (4x4096^2 int32): "
        f"{timings['coarsen_rank'][0]:.4f} ms (device {timings['coarsen_rank'][2]:.4f}), "
        f"plain {timings['coarsen_rank'][1]:.3f}, bound {bounds['coarsen_rank'][0]:.4f} "
        f"({bounds['coarsen_rank'][1]}), torch.mode over the flattened windows "
        f"{library['coarsen_rank'][0]:.4f} (device {library['coarsen_rank'][1]:.4f}; it "
        f"breaks ties its own way: differs from K6 on {tie_share:.4f} of the outputs)"
    )
    del flat, lib_mode
    for agg, x, window in (("median", b2a, (4, 4)), ("mode", b2c, (8, 8)),
                           ("median", b2a, (8, 8))):
        b, by = rank_bound(x, *window)
        print(
            f"{tag} coarsen_rank {agg} {window[0]}x{window[1]} at BASELINE #2's source: "
            f"{event_ms(lambda: coarsen_rank(x, *window, agg)):.4f} ms (device "
            f"{device_ms(lambda: coarsen_rank(x, *window, agg)):.4f}), bound {b:.4f} ({by})"
        )
    del b1, b2a, b2b, b2c, direct
    torch.cuda.synchronize()

    missing = [name for name in err if main_launches[name] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    sources = {
        "srw_vertical": (
            "xcube_resampling_tpu_torch/csrc/srw_vertical.cu",
            "xcube_resampling_tpu/ops/pallas_kernels.py:40",
        ),
        "srw_horizontal": (
            "xcube_resampling_tpu_torch/csrc/srw_horizontal.cu",
            "xcube_resampling_tpu/ops/srw.py:670",
        ),
        "fused_reproject": (
            "xcube_resampling_tpu_torch/csrc/fused_reproject.cu",
            "xcube_resampling_tpu/ops/reproject_ops.py:170",
        ),
        "affine_gather": (
            "xcube_resampling_tpu_torch/csrc/affine_gather.cu",
            "xcube_resampling_tpu/ops/gather.py:29",
        ),
        "affine_gather_reduce": (
            "xcube_resampling_tpu_torch/csrc/affine_gather_reduce.cu",
            "xcube_resampling_tpu/affine.py:212",
        ),
        "coarsen_reduce": (
            "xcube_resampling_tpu_torch/csrc/coarsen_reduce.cu",
            "xcube_resampling_tpu/ops/coarsen_ops.py:36",
        ),
        "coarsen_rank": (
            "xcube_resampling_tpu_torch/csrc/coarsen_rank.cu",
            "xcube_resampling_tpu/ops/coarsen_ops.py:95",
        ),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": main_launches[name],
            "max_abs_err": err[name],
            "ms": timings[name][0],
            "plain_ms": timings[name][1],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            # K1, K2: no single PyTorch call computes a tap pass; K3: the
            # F.grid_sample yardstick at the 4326 -> UTM shape; K4 a copy
            # (BASELINE #2's c), the downscale form and K5 torch.nanmean
            # (BASELINE #1), K6 torch.mode (BASELINE #2)
            "library_ms": library[name][0],
            # the same calls queued behind a sleep: device time alone
            "device_ms": timings[name][2],
            "library_device_ms": library[name][1],
        }
        for name in err
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
