#!/usr/bin/env python3
"""Time K1 and K2 at the headline's shapes over their block shapes.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 tools/tune_srw.py``.  On the 20480^2 UTM32N ->
EPSG:3035 bilinear plan that ``chip_smoke.py`` drives, it times
``srw_vertical`` (K1) and ``srw_horizontal`` (K2) over block shapes
(``srw_kernels.MAX_BLOCK_COLS`` columns by ``K1_MAX_ROWS`` or
``K2_MAX_ROWS`` rows) and walks of row blocks per kernel block
(``srw_kernels.WALK``), with the shared-memory budget raised to 200 KB,
as medians of 10 warm launches timed with CUDA events.  Every output is
checked equal to the default configuration's.  Every line carries the card's name and power
limit; the last line is one JSON object with the times.  It exits nonzero
when no CUDA device is visible.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N = 20480


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_srw: no CUDA device is visible", file=sys.stderr)
        return 2

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch.ops import srw_kernels as sk
    from xcube_resampling_tpu_torch.ops.srw import make_srw_reproject_fn

    dev = torch.device("cuda", 0)
    tag = f"[{card_line()}]"
    utm_gm = GridMapping.regular(
        size=(N, N), xy_min=(300000.0, 5200000.0), xy_res=30.0, crs="epsg:32632"
    )
    laea_gm = GridMapping.regular(
        size=(N, N), xy_min=(4050000.0, 2650000.0), xy_res=30.0, crs="epsg:3035"
    )
    fn = make_srw_reproject_fn(utm_gm, laea_gm, "bilinear", np.nan, dev)
    st = fn.state
    src = torch.from_numpy(
        np.random.default_rng(0).random((1, N, N), dtype=np.float32)
    ).to(dev)
    base_v, base_h = st.base_v.cpu().numpy(), st.base_h.cpu().numpy()
    defaults = (sk.WALK, sk.MAX_BLOCK_COLS, sk.K1_MAX_ROWS, sk.K2_MAX_ROWS, sk.SMEM_BUDGET)

    v_ref, _ = sk.srw_vertical(*fn.vertical_args(src))
    out_ref = sk.srw_horizontal(*fn.horizontal_args(v_ref))
    results = {"srw_vertical": {}, "srw_horizontal": {}}
    sk.SMEM_BUDGET = 200 * 1024
    for walk, cols, rows_v, rows_h in (
        (4, 64, 64, 32), (1, 64, 64, 32), (4, 64, 128, 64), (4, 128, 32, 16),
        (4, 128, 64, 32), (4, 128, 128, 64), (4, 32, 128, 64),
    ):
        sk.WALK, sk.MAX_BLOCK_COLS, sk.K1_MAX_ROWS, sk.K2_MAX_ROWS = (
            walk, cols, rows_v, rows_h,
        )
        win = sk.plan_vertical_windows(base_v, st.col_tile, st.d_v).to(dev)
        args = (src, st.iystar_c, st.step, st.base_v, st.col_tile, st.d_v, win,
                "bilinear")
        if not torch.equal(sk.srw_vertical(*args)[0], v_ref):
            raise AssertionError(f"K1 {cols}x{rows_v} walk {walk} differs")
        ms = median_ms(torch, lambda: sk.srw_vertical(*args))
        key = f"cols{win.cols}_rows{win.rows}_walk{walk}"
        results["srw_vertical"][key] = ms
        print(f"{tag} K1 {key} (extent {win.extent}): {ms:.3f} ms")
        win = sk.plan_horizontal_windows(base_h, st.row_tile, st.d_h).to(dev)
        args = (v_ref, st.ix_c, st.iy_c, st.step, st.base_h, st.row_tile, st.d_h,
                st.src_h, win, "bilinear", float("nan"))
        got = sk.srw_horizontal(*args)
        if not torch.equal(torch.isnan(got), torch.isnan(out_ref)) or not torch.equal(
            torch.nan_to_num(got), torch.nan_to_num(out_ref)
        ):
            raise AssertionError(f"K2 {cols}x{rows_h} walk {walk} differs")
        ms = median_ms(torch, lambda: sk.srw_horizontal(*args))
        key = f"cols{win.cols}_rows{win.rows}_walk{walk}"
        results["srw_horizontal"][key] = ms
        print(f"{tag} K2 {key} (extent {win.extent}): {ms:.3f} ms")
    sk.WALK, sk.MAX_BLOCK_COLS, sk.K1_MAX_ROWS, sk.K2_MAX_ROWS, sk.SMEM_BUDGET = defaults
    print(json.dumps({"card": tag[1:-1], "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
