#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of xcube_resampling_tpu once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 chip_smoke.py``.  It

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``xcube_resampling_tpu_torch/csrc`` with ``nvcc``;
2. drives the port's main path through ``resample_in_space``: the 20480^2
   UTM32N -> EPSG:3035 bilinear reproject (first call and warm calls), the
   EPSG:4326 0.05 deg -> UTM32N 4096^2 reproject with nearest, triangular
   and a 2-band stack, the exact tier (``XRTPU_EXACT=1``) on that
   geometry, the global EPSG:4326 0.05 deg -> EPSG:3035 4096^2 reproject
   (BASELINE #3, a singular warp whose default tier is K3) with nearest
   and bilinear, first call and warm calls, and a small UTM32N ->
   EPSG:3035 case with a numpy variable (placed on the card by
   ``device``) beside a tensor; the kernel launch counts are reset before
   and read after each call;
3. holds every result against the plain PyTorch composition on the same
   device tensors, and the small case against the port's own K3 (the
   direct gather) within the two-pass bounds;
4. holds each kernel against its plain version on CUDA tensors at the
   headline's shapes, at the 4326 -> UTM shapes on inputs with NaN rows,
   on a geometry whose tap windows clip at the source's top and bottom
   edges, and (K3) on a ragged EPSG:3035 target, for every method; times
   each kernel and its plain version at the main path's shapes, K3 also
   beside one ``F.grid_sample`` call at the same positions, two ways: one
   warm call between two CUDA events on an idle card (``ms``: device time
   and the host's enqueue of the call) and warm calls queued behind a
   sleep on the card (``device_ms``: device time alone); and computes each
   kernel's bound (bytes at 3.35 TB/s or float32 operations at 67
   TFLOP/s, the H100 SXM data sheet's peaks), K3's from the source pixels
   its taps reach, counted on the card;
5. prints a JSON line of the kernels and, last,
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It exits nonzero and prints no result when no CUDA device is visible or
any phase fails.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
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
TOL = {"nearest": 0.0, "bilinear": 1e-5, "triangular": 1e-5}
METHODS = ("bilinear", "nearest", "triangular")
# H100 SXM data-sheet peaks: HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of bytes over
    the memory rate and operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    from xcube_resampling_tpu_torch._device import LAUNCHES
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
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    _build.load()

    nan = float("nan")
    err = {"srw_vertical": 0.0, "srw_horizontal": 0.0, "fused_reproject": 0.0}
    main_launches: Counter = Counter()

    def compare(got, ref, interp, what):
        """Max abs difference; raises on unequal NaN masks or above TOL."""
        if got.shape != ref.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        nan_got, nan_ref = torch.isnan(got), torch.isnan(ref)
        if not torch.equal(nan_got, nan_ref):
            raise AssertionError(f"{what}: NaN masks differ")
        d = torch.where(nan_got, 0.0, got - ref).abs().max().item()
        if d > TOL[interp]:
            raise AssertionError(f"{what}: max abs diff {d} > {TOL[interp]}")
        return d

    def run_main(ds, target_gm, interp, expect):
        """One main-path call; the launch counts are reset just before it
        and read just after.  *expect* names the kernels it must launch."""
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = resample_in_space(ds, target_gm=target_gm, interp_methods=interp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = Counter(LAUNCHES)
        main_launches.update(got)
        for name in expect:
            if got[name] < 1:
                raise AssertionError(f"{name} was not launched: {dict(got)}")
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

    def check_output(arr, shape):
        if not (isinstance(arr, torch.Tensor) and arr.device == dev):
            raise AssertionError(f"output is not a tensor on {dev}: {type(arr)}")
        if tuple(arr.shape) != shape or arr.dtype != torch.float32:
            raise AssertionError(f"output {tuple(arr.shape)} {arr.dtype}, expected {shape}")
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
    del fn, x, v, v_args, h_args, src, ds
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
            # F.grid_sample yardstick at the 4326 -> UTM shape
            "library_ms": library[name][0],
            # the same calls queued behind a sleep: device time alone
            "device_ms": timings[name][2],
            "library_device_ms": library[name][1],
        }
        for name in err
    ]
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
