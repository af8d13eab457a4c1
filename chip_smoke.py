#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of xcube_resampling_tpu once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit: ``python3 chip_smoke.py`` (``--against TREE``: also
time K13-K18, K20 and, where TREE has ``srw_horizontal_f64.cu``, K2's
float64 form of TREE, e.g. the parent unpacked with ``git archive``,
beside this tree's, in turns, each held to this tree's).  It

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``xcube_resampling_tpu_torch/csrc`` with ``nvcc``,
   printing each source's registers and spills (ptxas ``-v``) and those
   of every instantiation of K1-K3, K13 (per pixel and staged), K14-K18,
   K2's, K3's, K7's and K13's band forms, K7's map and list forms, K11's
   two kernels and K12 (and a summary of the downscale form's cached
   kernels), and fails if K6's register kernels, K2's, K3's or K7's band
   form, K11, K12, K13 or its band form, K14-K18, K16 or the downscale
   form's cached kernels spill or use local memory;
2. drives the port's main path through ``resample_in_space``: the 20480^2
   UTM32N -> EPSG:3035 bilinear reproject (first call and warm calls); the
   same source onto a 5120^2 EPSG:3035 grid at 120 m, where the
   pre-downscale runs (clip, K4's downscale form: the gather reduced in
   5 x 5 windows without the inflated image) before the SRW's batched
   choice (K1 + K2), with the device memory a call takes at its peak; the
   flagship cell (:func:`flagship_phase`: the 2048^2 UTM32N 100 m ->
   EPSG:3035 110 m flagship, pre-downscaled and then reprojected through
   the aligned SRW, K14 and K15, bilinear and nearest, 1 and 4 bands, first
   call and warm calls; K14 and K15 held to their plain versions bit for
   bit there, with NaN and +-inf rows and columns and a numeric fill and on
   a plan whose taps pass all four source edges; the aligned output against
   the tiled SRW on the same geometry within F1's bounds; K14 and K15 timed
   beside K1 + K2 and K3; the 512^2 flagship's aligned pick seen by a spy;
   K14 and K15 also on one isolated NaN and inf, on K14's own output (K15
   reading its flags) and on the synthetic passes of
   :func:`aligned_synthetic_checks`, bounds counted as the shortcut's work
   beside the count of every tap);
   the
   EPSG:4326 0.05 deg -> UTM32N 4096^2 reproject with nearest, triangular
   and a 2-band stack, the exact tier (``XRTPU_EXACT=1``) on that
   geometry (the exact separable warp, K13), the global EPSG:4326 0.05 deg
   -> EPSG:3035 4096^2 reproject (BASELINE #3, a singular warp whose
   default tier is the exact region mosaic: K16, one launch a call over
   its ESW and gather pieces) with nearest and bilinear, first call (the
   ESW planner's refusal and the mosaic's host planning re-run apart
   after it), warm calls and the piece counts, K16 held to its plain
   version bit for bit (triangular too) and to K3 (nearest equal,
   bilinear within 2 ulp), staged and per pixel (``staged=False``) for
   every method on 1 and 4 bands, the share of its ESW tiles staged (as
   ``ops.esw.tile_spans`` models it from the inputs, on a line of its
   own), timed beside its per-pixel path and TREE's K16 in turns, and once
   more under
   ``XRTPU_NO_EXACT_MOSAIC=1`` (K3), the ESW cell (:func:`esw_phase`: the same source onto EPSG:3035
   4096^2 at 937.5 m from (2.5e6, 1.4e6), past the two-pass gate, whose
   default tier is the ESW: 1 band for every method and 4 bands, first
   call, warm calls, peak device memory, ``plan_esw``'s host time; and
   ``sharded_reproject`` of it over a mesh of 4 entries on the card, K13's
   band form after the halo exchange, held to the single-chip ESW on the
   window it crops bit for bit and to the whole source's within the JAX
   package's NaN-mask contract and ``ESW_WHOLE_ATOL``; K13 staged and per
   pixel (``staged=False``) held to its plain version for every method on
   1 and 4 bands at the cell and on a sheared target whose tiles partly
   take the per-pixel body (``ESW_SHEARED``), with the share of tiles
   staged as modelled; its band form likewise, staged and per pixel, on
   every band of the cell and of the sheared target, each band's share of
   tiles staged as modelled, and ``plan_sharded_esw``'s host time alone;
   K13 and its band form timed for every method beside K3 and its band
   form, and beside their per-pixel paths and TREE's in turns, K13 at the
   cell and on the sheared target, its band form at the cell's band 1), the fast
   extreme-warp mode (:func:`hybrid_phase`, ``XRTPU_FAST_EXTREME_WARP=1``:
   the ESW cell's geometry through the whole-domain hybrid SRW, K17 + K18
   once each a call, bilinear and nearest, 1 and 4 bands; BASELINE #3
   through the two-pass region mosaic, its 30 hybrid, 2 batched SRW and 2
   K3 pieces held to the JAX package's planner, bit for bit to every
   piece's plain version and, on a smooth field, to the exact mosaic
   within ``HYBRID_SMOOTH_ATOL``; first calls with the host's planning
   apart, warm calls, peak memory; K17 and K18 against their plain
   versions on NaN and +-inf rows and columns, a numeric fill and a plan
   whose taps pass every source edge, as K14 and K15 on the isolated NaN
   and inf and the synthetic passes, timed beside K13, K16, K3 and
   ``F.grid_sample``), a small
   UTM32N ->
   EPSG:3035 case with float32, float64 and uint16 numpy variables (placed
   on the card by ``device``: the host path's semantics through K9's window
   mode, dtype kept) beside a tensor, and the affine route: BASELINE #1 (a
   16-band 1024^2 float32 2x bilinear downscale with ``mean``: K4's
   downscale form) and BASELINE #2 (a 4-band 4096^2 raster coarsened 4x
   with ``mean``, ``first`` and ``mode``, through
   ``ops.coarsen_ops.coarsen``: K5, K6, and through an exact 4x affine
   downscale: the downscale form for ``mean`` and ``first``, K4 then K6
   for ``mode``); and the rectify route (section 7) under its default
   (device) tier, JAX's ladder (the hybrid: K11, K12) and the resident
   Phase B: R1, BASELINE #4 (the 1189 x 1890 OLCI-like swath onto its
   default 512-tiled grid, nearest: K11, K12 then K7; first call and warm calls, Phase A
   alone under each tier, and the 16-band Phase B for nearest, bilinear
   and triangular in both forms), R2 (the same swath onto EPSG:32631 at
   250 m, bilinear, through the swath's coordinate transform), R3 (an OLCI
   EFR-sized granule, 4865 x 4091 with 21 float32 bands, onto a 1024-tiled
   grid, bilinear, with the device memory of a call at its peak); R1 and
   R3 also under ``XRTPU_PHASEA=host`` (R1's map within 1e-9 of the
   device tier's, its output's NaN mask equal), and the numpy route under
   the host tier (float64 and uint16 numpy variables: K8 then K9's ij_map
   mode); the rest of the device Phase A ladder
   (:func:`phase_a_ladder_phase`: ``rectify_dataset`` at R1 and R3 under
   each tier, the walk K19 and the tiled stencil K20 under
   ``XRTPU_PHASEA_HYBRID=0`` and ``XRTPU_PHASEA_WALK=0``, beside K10 + K8;
   R1's NaN-row swath reaching K20 under the default ladder, NaN edge rows
   and a jump of 80 pixels, where every tier refuses and K10 and K8 serve;
   a plan with host blocks; K21 through ``inverse_ij_map_jax`` and
   ``_inverse_ij_map_device_scatter``; each map within 1e-9 of K8's, each
   kernel bit for bit against its plain version; K20's band class timed
   apart, and with ``--against`` both classes beside TREE's K20); the
   kernel launch counts are reset before and read after each call;
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
   view), and its cached kernel at every window width it templates and
   one past it, every reducer and pick, float32, float64, int32 and
   uint16, either axis flipped, the last column's window at the source's
   right edge; K3's band form for every method on every band past the
   gate, a ragged last band and a 1-row band; K13 bit for bit for every
   method on the ESW cell (a shift-aligned plan) with NaN and +-inf rows
   and columns and a numeric fill, and on a target over the source's last
   row and column, and its band form on every band of the cell (band 0
   from its negative offset), a ragged last band, clean and with NaN and
   +-inf rows and columns; K6 for mode and median at 4, 9, 16, 25, 64, 81 and 1024 taps
   with ties, NaN and +-0.0, K7 for every method on seven dtypes, NaN
   map cells and its list form, and on maps whose positions spread over
   the whole source, run backwards or sit on the -0.5 / n - 0.5 bounds
   (both forms; float32, float64, uint16), K8 on a swath with a NaN row
   and on a target with tiles no quad reaches, and on tile tables that
   its patches of quads cut unevenly (ragged windows, windows of one quad,
   one quad row and none, a fold whose competing quads lie in other
   patches, NaN corners on patch boundaries), K9 in both modes on float32,
   float64, uint16 and int16, K7-K9 at R1's and R3's shapes, K10 at R1's
   and R3's (R3's y image 8 bytes off a 16-byte boundary) against its
   plain version and the host's scan, also with a NaN row, empty tiles,
   about 5000 small tiles (the host's scan on 200 of them), a 301 x 197
   swath in the four alignments of x and y with the j axis down and up,
   1000 x 1 and 1 x 1001 swaths, one tile, a target off the swath, three
   calls in a row and three geometries interleaved, and checks that a
   warm K10 call at R1 and R3 queues one device operation (the C entry's
   report) and does not synchronise (sync debug mode "error"), the
   resident Phase B at R3's; times each kernel and its plain version at
   the main path's shapes beside one PyTorch call where one computes the
   same function (K3, K13, K16 and the band forms of K3 and K13
   ``F.grid_sample``, K13 and
   its band form also beside K3 and K3's band form on the ESW cell, K4 a
   copy at
   BASELINE #2's ``c``
   and ``F.grid_sample`` at BASELINE #1, K5 and the downscale form at
   BASELINE #1 ``torch.nanmean``, K5 a strided copy for ``first``, K6
   ``torch.mode``, K7 ``F.grid_sample``; K8, K9 and K10 have none), and the
   downscale form beside the chain K4 -> K5 it
   replaces, two ways: one
   warm call between two CUDA events on an idle card (``ms``: device time
   and the host's enqueue of the call) and warm calls queued behind a
   sleep on the card (``device_ms``: device time alone); and computes each
   kernel's bound (bytes at 3.35 TB/s, or operations at 67 TFLOP/s
   float32 and 34 TFLOP/s float64, the H100 SXM data sheet's peaks), K3's,
   K13's and K16's (its pieces', one mask over the source) from the source
   pixels their taps reach, counted on the card, the
   downscale form's from the source sectors its taps reach, K8's from the
   quads of its windows and the candidate pixels of their rectangles,
   counted on the card, K1's band form's from the rows of its band its
   taps reach in each column tile and K3's and K7's from the band's pixels
   their valid taps reach; beside the downscale form's bound, the time its
   float64 conversions take at 16 a clock an SM (information only);
5. drives BASELINE #5 (:func:`baseline5`): ``sharded_reproject`` of the
   headline's 20480^2 geometry with 4 float32 bands over a mesh of four
   entries on the card (K1's and K2's band forms after the halo exchange;
   first call, warm calls, peak device memory), held against the single-chip tiled SRW (and
   triangular and nearest on one band); BASELINE #3's geometry past the
   two-pass gate through the sharded regrid (K3's band form), held
   against the single-chip K3; each band form against its plain version
   at those shapes (the first band reading from a negative row offset;
   K2's band form also for nearest and triangular and on NaN rows of
   ``v``), on a 512^2 source over 8 bands with a halo of several bands,
   and with NaN rows, and timed; K2's band form on every band of a
   4094 x 4096 source onto 4000^2 over 4 bands in row tiles of 64 (each
   band's last tile overlapping, a target width no 64 divides, a source
   width no 4 divides), every method, clean and with NaN rows; the SRW
   step's kernels seen on the card by ``torch.profiler``; and
   ``resample_to_store`` of a 4096^2 2-band
   source in 512^2 chunks of a directory store under ``build/`` onto 512^2
   tiles, held against one ``resample_in_space``, resumed (0 tiles, then
   1 after deleting a chunk), and a corner target reading a fraction of
   the chunks;
6. drives the sharded rectify (:func:`sharded_rectify_phase`) at R1 (16
   bands, nearest) and R3 (21 bands, bilinear) over a mesh of four entries
   on the card: ``sharded_rectify`` without a map runs the sharded Phase A
   (K11 ``hybrid_seed`` and K12 ``hybrid_dense`` on every band) and then
   K7's band form (``ij_gather_band``) after the halo exchange (first call,
   warm calls, peak device memory); holds the sharded Phase A to the
   single-chip ``inverse_ij_map_hybrid`` bit for bit, the hybrid map to
   K8's (NaN coverage equal, within 1e-9), the sharded raster through K8's
   map to K7's map form bit for bit for every method, and the default
   raster to it (NaN masks equal, fewer than 1e-3 of the pixels
   differing); holds K7's band form (every method at R1 and R3; band 0
   from a negative offset, the ragged last band, NaN map rows), K11
   (every band's origin as ``sharded_phase_a`` launches it and the whole
   target at two origins; the hard lattices, folded and NaN ones among
   them, at tiles 16, 12, 8 and 4; swaths of odd width and height, 2 x
   N, N x 2 and 3 x 3) and K12 (R1 in
   full; at R3 the first rows of band 1 at the window and band origin the
   sharded Phase A launches, also against those rows of its band 1; the
   hard lattices of :func:`hard_lattices` at tiles 16, 12, 8 and 4: the
   map, the winner's position and the pairs solved a pixel) to their
   plain versions, prints K12's pairs solved a pixel (mean, and its
   warps' maxima) beside the winner's position, times them with their
   bounds (K12's is K8's;
   K7's band form's from the band's pixels its valid taps reach) beside
   ``F.grid_sample`` for K7's band form, prints the hybrid's Phase A
   beside K8's, and counts ``sharded_phase_a``'s launches (K11 and K12
   once a band) and sees K11's two kernels and K12's on the card;
7. drives the dtypes (:func:`dtypes_phase`): every instantiation the
   JAX package's thirteen data dtypes added, at full size on its cell,
   held to its plain version on the card and timed with its bound: the
   headline's 20480^2 through the tiled SRW on uint16 (K1 reading it in
   place) and float64 (K1 and K2's float64 form, bilinear, and K2's float64
   form on triangular besides); BASELINE #2's 4-band
   4096^2 in uint16, int64, float16, bfloat16 and bool through
   ``coarsen`` and the affine route (K4, its downscale form, K5, K6); R1
   with a uint32 and a uint64 band (K7 on the device tier, K9 on numpy
   flags under the host tier, K7's band form through ``sharded_rectify``
   on the uint32 flags); BASELINE #3's exact mosaic (K16, its gather
   pieces through K3 on int16) and the ESW cell (K13) on int16, with the
   float32 cast's cost; K3 on the whole of BASELINE #3 under
   ``XRTPU_NO_EXACT_MOSAIC=1`` (int16 and int64 nearest, float64 and
   bfloat16 bilinear) and K3's band form through ``sharded_reproject`` on
   int16; B5's sharded SRW step on uint16 (K1's band form) and on 4
   float64 bands (K2's band form on float64 held and timed on band 1); K1
   on uint16 beside the float32 cast followed by the float32 K1; with
   ``--against``, K2's float64 form (bilinear and triangular, and on the
   band) beside TREE's in turns; and fails the run if any kernel of the
   library spills;
8. prints the card line again, a JSON line of the kernels (the new
   instantiations under ``kernel.dtype``) and, last,
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It exits nonzero and prints no result when no CUDA device is visible or
any phase fails, when K7, K8, K9, K10, K19 or K20 never launched on the
rectify route, when a band form never launched on the sharded path (K13's on the
ESW cell's), when any kernel never launched on the main path, and when
K11, K12 or K7's band form never launched on the sharded rectify.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from types import SimpleNamespace

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
# K7 agrees with its plain version as K3 does (float32 and integer
# sources); on float64 sources its fused multiply-adds are exact where the
# plain version emulates them in float64 (one ulp off in rare cases):
# "f64", 2.3e-16 of the value.  K8 (float64, one rounding per operation in
# both) and K9 (float64, then one rounding to the dtype) are "exact", as is
# K10 (float64 comparisons, integer min and max).  "esw" is the ESW's and
# the exact region mosaic's contract against the direct gather (K3): 2
# float32 ulp at unit scale (they lerp vertically first, K3 horizontally).
# "map" is one Phase A map against another (the device tiers against K8's):
# JAX's bound, 1e-9 (tests/test_rectify.py), NaN coverage equal.
TOL = {"nearest": 0.0, "bilinear": 1e-5, "triangular": 1e-5, "exact": 0.0, "stat": 0.0,
       "f64": 0.0, "esw": 2 * 2.0**-24, "map": 1e-9}
REL_TOL = {"stat": 2.5e-7, "f64": 2.3e-16}
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


def gather_reduce_values(x, residual, out_h, out_w, j_div, i_div):
    """The downscale form's source values that its taps reach (the valid
    positions' clipped tap rows times tap columns, every band) and its taps
    (inflated pixels)."""
    batch, h, w = x.shape
    (i_s, _, i_o), (_, j_s, j_o) = residual
    y = np.arange(out_h * j_div) * j_s + j_o
    xx = np.arange(out_w * i_div) * i_s + i_o
    y, xx = y[(y >= 0) & (y <= h - 1)], xx[(xx >= 0) & (xx <= w - 1)]
    y0, x0 = np.floor(y).astype(np.int64), np.floor(xx).astype(np.int64)
    rows = len(np.unique(np.concatenate([y0, np.minimum(y0 + 1, h - 1)])))
    cols = len(np.unique(np.concatenate([x0, np.minimum(x0 + 1, w - 1)])))
    return batch * rows * cols, batch * out_h * j_div * out_w * i_div


def sm_clock_hz() -> float:
    """The card's highest SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return float(out.strip().splitlines()[0]) * 1e6


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


def vertical_band_bound(ext, iystar_c, base_v, col_tile, d_v, src_h, off, tri):
    """K1's band form reads, for each column tile, the rows of ``ext`` its
    taps reach (clamped to the source height, rebased by *off*; counted
    on the card), the coarse field and the bases once and writes v (and
    vd); operations as :func:`vertical_bound`."""
    import torch

    batch, ext_h, src_w = ext.shape
    out_h, n_tiles = base_v.shape
    taps = torch.arange(d_v, device=base_v.device)
    rows = (base_v.long()[:, :, None] + taps).clamp(0, src_h - 1) - off
    tiles = torch.arange(n_tiles, device=base_v.device)
    reached = torch.zeros((n_tiles, ext_h), dtype=torch.bool, device=base_v.device)
    reached[tiles[None, :, None].expand_as(rows), rows] = True
    widths = (src_w - tiles * col_tile).clamp(max=col_tile)
    n_in = int((reached.sum(1) * widths).sum())
    outs = batch * out_h * src_w
    n_bytes = 4 * (batch * n_in + iystar_c.numel() + base_v.numel()
                   + outs * (2 if tri else 1))
    n_ops = outs * d_v * (12 if tri else 6) + 12 * out_h * src_w
    return bound(n_bytes, n_ops)


def tapped_pixels(ix, iy, valid, h, w, interp, into=None) -> int:
    """The pixels of an *h* x *w* source plane that a gather's taps at the
    *valid* positions (ix, iy) reach, positions clamped as gather_interp
    clamps them; counted with a mask on the positions' device (or marked
    in the flat mask *into*, and its count returned)."""
    import torch

    x = ix[valid].clamp(0, w - 1)
    y = iy[valid].clamp(0, h - 1)
    tapped = torch.zeros(h * w, dtype=torch.bool, device=ix.device) if into is None else into
    if interp == "nearest":
        tapped[torch.round(y).long() * w + torch.round(x).long()] = True
    else:
        x0, y0 = x.floor().long(), y.floor().long()
        for yy in (y0, (y0 + 1).clamp(max=h - 1)):
            for xx in (x0, (x0 + 1).clamp(max=w - 1)):
                tapped[yy * w + xx] = True
    return int(tapped.sum())


def fused_band_bound(ext, ix_c, iy_c, step, out_h, out_w, interp, fill, row0, off, src_h,
                     out_size=4, f64=False):
    """K3's band form (its wrapper's arguments) must read the coarse fields
    and the pixels of ``ext`` that the taps of its valid pixels (in the
    source and in the band, as the plain version masks them) reach, and
    write the output (of *out_size* bytes a pixel); about 30 operations a
    pixel, as K3's bound counts (*f64*: the 6 of the three lerps at the
    float64 rate)."""
    import torch

    from xcube_resampling_tpu_torch.ops.reproject_ops import interp_field

    ext_h, src_w = ext.shape[-2:]
    batch = ext.numel() // (ext_h * src_w)
    rows = torch.arange(row0, row0 + out_h, dtype=torch.float32, device=ext.device)[:, None]
    cols = torch.arange(out_w, dtype=torch.float32, device=ext.device)[None, :]
    ix = interp_field(ix_c, rows, cols, step)
    iy = interp_field(iy_c, rows, cols, step)
    in_src = (ix > -0.5) & (ix < src_w - 0.5) & (iy > -0.5) & (iy < src_h - 0.5)
    iy_l = iy.clamp(0, src_h - 1) - off
    in_band = (iy_l > -0.5) & (iy_l < ext_h - 0.5)
    n_tapped = tapped_pixels(ix, iy_l, in_src & in_band, ext_h, src_w, interp)
    n_out = batch * out_h * out_w
    n_bytes = (out_size * n_out + ext.element_size() * batch * n_tapped
               + 4 * (ix_c.numel() + iy_c.numel()))
    if f64:
        return bound_mixed(n_bytes, 24 * n_out, 6 * n_out)
    return bound(n_bytes, 30 * n_out)


def esw_tap_args(args, band: bool) -> tuple:
    """``ops.esw.esw_taps``'s arguments from K13's wrapper's arguments, or
    (*band*) from its band form's."""
    if band:
        ext, iystar_c, ix_c, iy_c, step, s, out_h, out_w, interp, _, row0, off, src_h = args
        return (tuple(ext.shape[-2:]), iystar_c, ix_c, iy_c, step, s, interp, row0, out_h,
                out_w, src_h, ext.shape[-1], 0, 0, src_h, off)
    src, iystar_c, ix_c, iy_c, step, s, out_h, out_w, h_g, w_g, j_off, i_off, interp, _ = args
    return (tuple(src.shape[-2:]), iystar_c, ix_c, iy_c, step, s, interp, 0, out_h, out_w,
            h_g, w_g, j_off, i_off, src.shape[-2], 0)


def esw_bound(args, band: bool = False):
    """K13 or its band form (*band*; the wrapper's arguments) must read the
    coarse fields and the pixels of its plane that the taps of its valid
    pixels reach (as its plain version selects them, counted on the card)
    and write the output; about 50 operations a pixel (K3's 30 and the
    anchor's interpolation at its two tap columns)."""
    import torch

    from xcube_resampling_tpu_torch.ops.esw import esw_taps

    src = args[0]
    h, w = src.shape[-2:]
    batch = src.numel() // (h * w)
    tap_args = esw_tap_args(args, band)
    valid, _, _, columns = esw_taps(*tap_args)
    tapped = torch.zeros(h * w, dtype=torch.bool, device=src.device)
    for ra, rb, c in columns:
        tapped[(ra * w + c)[valid]] = True
        if tap_args[6] != "nearest":
            tapped[(rb * w + c)[valid]] = True
    n_out = batch * valid.numel()
    fields = sum(t.numel() for t in args[1:4])
    return bound(4 * (n_out + batch * int(tapped.sum()) + fields), 50 * n_out)


def esw_spans(args):
    """The span of window columns K13's staged kernel stages for each of
    its tiles (its wrapper's arguments; ``ops.esw.tile_spans``)."""
    from xcube_resampling_tpu_torch.ops.esw import tile_spans

    src, _, ix_c, _, step, _, out_h, out_w, _, w_g, _, i_off, interp, _ = args
    return tile_spans(ix_c, step, out_h, out_w, w_g, i_off, src.shape[-1], interp)


def mosaic_spans(fn, interp):
    """:func:`esw_spans` of every ESW piece of the ``ESWMosaicFn`` *fn*, in
    one flat tensor."""
    import torch

    from xcube_resampling_tpu_torch.ops import esw_mosaic as mos
    from xcube_resampling_tpu_torch.ops.esw import tile_spans

    spans = []
    for row in fn.table.tolist():
        if row[mos.KIND] == mos.ESW:
            ix_c, _, _ = mos._piece_fields(fn.fields, row)
            spans.append(tile_spans(ix_c, fn.step, row[mos.H], row[mos.W], fn.src_w,
                                    row[mos.I_OFF], row[mos.WW], interp).flatten())
    return torch.cat(spans)


def staged_share(spans, interp) -> float:
    """The share of tiles whose *spans* fit the stage of method *interp*
    (a tile with no valid pixel stages nothing and counts as staged):
    modelled from the inputs, not counted by the kernels."""
    from xcube_resampling_tpu_torch.ops.esw import stage_cols

    return float((spans <= stage_cols(interp)).float().mean())


def mosaic_bound(fn, interp):
    """K16 (an ``ESWMosaicFn``'s launch on one band) must read the piece
    table, the packed coarse fields and the source pixels that the taps of
    its pieces' valid pixels reach (an ESW piece's as its plain version
    selects them, as :func:`esw_bound` counts K13's; a gather piece's by
    :func:`tapped_pixels`; one mask over the whole source, so a pixel two
    pieces tap counts once), and write its pieces' pixels; about 50
    operations an ESW pixel and 30 a gather pixel, as K13's and K3's bounds
    count.  Returns (ms, basis, source pixels tapped)."""
    import torch

    from xcube_resampling_tpu_torch.ops import esw_mosaic as mos
    from xcube_resampling_tpu_torch.ops.esw import esw_taps
    from xcube_resampling_tpu_torch.ops.reproject_ops import interp_field

    h, w = fn.src_h, fn.src_w
    dev = fn.fields.device
    tapped = torch.zeros(h * w, dtype=torch.bool, device=dev)
    n_out = n_ops = 0
    for row in fn.table.tolist():
        ix_c, iy_c, ys = mos._piece_fields(fn.fields, row)
        ph, pw, j0, i0 = row[mos.H], row[mos.W], row[mos.J_OFF], row[mos.I_OFF]
        n_out += ph * pw
        if row[mos.KIND] == mos.ESW:
            n_ops += 50 * ph * pw
            valid, _, _, columns = esw_taps(
                (row[mos.WH], row[mos.WW]), ys, ix_c, iy_c, fn.step, row[mos.SAMPLES], interp,
                0, ph, pw, h, w, j0, i0, row[mos.WH], 0,
            )
            for ra, rb, c in columns:
                for r in (ra,) if interp == "nearest" else (ra, rb):
                    tapped[((r + j0) * w + c + i0)[valid]] = True
        else:
            n_ops += 30 * ph * pw
            rows = torch.arange(ph, dtype=torch.float32, device=dev)[:, None]
            cols = torch.arange(pw, dtype=torch.float32, device=dev)[None, :]
            ix = interp_field(ix_c, rows, cols, fn.step)
            iy = interp_field(iy_c, rows, cols, fn.step)
            valid = (ix > -0.5) & (ix < w - 0.5) & (iy > -0.5) & (iy < h - 0.5)
            tapped_pixels(ix, iy, valid, h, w, interp, into=tapped)
    n_tapped = int(tapped.sum())
    n_in = fn.fields.numel() + fn.table.numel() + fn.tile_start.numel()
    return bound(4 * (n_out + n_tapped + n_in), n_ops) + (n_tapped,)


def gather_band_bound(ext, m, interp, fill, off, src_h, out_size=4):
    """K7's band form (its wrapper's arguments) must read the map, the
    pixels of ``ext`` that the taps of its valid pixels (in the band, as
    the plain version masks them) reach, and write the output (of
    *out_size* bytes a pixel); 4 (nearest) or 16 float32 operations a pixel
    and band, as K7's map form counts."""
    import torch

    ext_h, src_w = ext.shape[-2:]
    batch = ext.numel() // (ext_h * src_w)
    valid = torch.isfinite(m[0]) & torch.isfinite(m[1])
    ix = m[0][valid].clamp(0, src_w - 1)
    iy = m[1][valid].clamp(0, src_h - 1)
    tapped = torch.zeros(ext_h * src_w, dtype=torch.bool, device=ext.device)
    if interp == "nearest":
        jy, jx = torch.round(iy).long() - off, torch.round(ix).long()
        keep = (jy >= 0) & (jy < ext_h)
        tapped[jy[keep] * src_w + jx[keep]] = True
    else:
        x0, y0 = ix.floor().long(), iy.floor().long()
        y1 = (y0 + 1).clamp(max=src_h - 1)
        keep = (y0 >= off) & (y1 < off + ext_h)
        x0, y0, y1 = x0[keep], y0[keep] - off, y1[keep] - off
        for yy in (y0, y1):
            for xx in (x0, (x0 + 1).clamp(max=src_w - 1)):
                tapped[yy * src_w + xx] = True
    n_out = batch * m.shape[-2] * m.shape[-1]
    n_bytes = ext.element_size() * batch * int(tapped.sum()) + out_size * n_out + 4 * m.numel()
    return bound(n_bytes, n_out * (4 if interp == "nearest" else 16))


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


def device_kernels(fn, calls=3) -> Counter:
    """The kernels *calls* calls of *fn* run on the card, by name (the
    identifier before a kernel's template or argument list), as
    ``torch.profiler`` records them: it may drop some (it dropped K10's at
    R3, and some of K11's), so a kernel it counts ran, and the wrappers'
    launch counts give the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: Counter = Counter()
    for e in prof.key_averages():
        name = re.search(r"(\w+)(?:<[^>]*>)?\(", e.key)
        if name:
            out[name.group(1)] += e.count
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# BASELINE #5 (the sharded reproject and the tile stream): its sizes, at
# full size the headline's 20480^2 source in 4 float32 bands over a mesh of
# 4 entries, BASELINE #3's geometry past the two-pass gate, and a 4096^2
# 2-band source streamed in 512^2 chunks onto 512^2 tiles (cut from 20480^2:
# the numpy route transforms every target centre on the host)
B5_SIZES = dict(n=20480, bands=4, mesh=4, gate=(7200, 3600, 4096), stream=4096,
                chunk=512, halo_src=512, hard=((4094, 4096), 4000), down=(8192, 8))
B5_KERNELS = ("srw_vertical_band", "srw_horizontal_band", "fused_reproject_band")


def baseline5(dev, tag, h, sizes=B5_SIZES, work_dir="build/chip_smoke_b5"):
    """Drive BASELINE #5 on *dev* and hold it to the single-chip path and
    each band kernel to its plain version.  *h* carries the timing and
    comparison helpers of :func:`main` (``compare``, ``time_pair``).
    Returns (launches on the sharded path, max abs errors, timings, bounds,
    library yardsticks) of the band kernels."""
    import shutil
    from pathlib import Path

    import torch

    from xcube_resampling_tpu_torch import DataArray, Dataset, GridMapping, zarrlite
    from xcube_resampling_tpu_torch import resample_in_space
    from xcube_resampling_tpu_torch._device import LAUNCHES
    from xcube_resampling_tpu_torch.crs import Transformer
    from xcube_resampling_tpu_torch.ops.reproject_ops import (
        fused_reproject_band,
        fused_reproject_band_plain,
        interp_field,
        make_fused_reproject_fn,
    )
    from xcube_resampling_tpu_torch.ops.srw import make_srw_reproject_fn
    from xcube_resampling_tpu_torch import _build
    from xcube_resampling_tpu_torch.ops.srw_kernels import (
        BAND_ITEMS,
        SMEM_BLOCK_MAX,
        BandLaunch,
        horizontal_c_args,
        plan_band_launch,
        srw_horizontal_band,
        srw_horizontal_band_plain,
        srw_vertical_band,
        srw_vertical_band_plain,
    )
    from xcube_resampling_tpu_torch.parallel import (
        make_mesh,
        make_sharded_regrid_step,
        make_sharded_srw_step,
        resample_to_store,
        sharded_reproject,
    )
    from xcube_resampling_tpu_torch.parallel.halo import ShardedSRWStep, crop_source

    nan = float("nan")
    cuda = dev.type == "cuda"
    launches: Counter = Counter()
    err = dict.fromkeys(B5_KERNELS, 0.0)
    timings, bounds, library = {}, {}, {}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def counted(call, n_bands, expect, what):
        """One sharded call; the launch counts are reset just before it and
        read just after: each kernel of *expect* launches once a band, no
        other kernel launches (CPU tensors run the plain versions and
        launch nothing)."""
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = call()
        sync()
        dt = time.perf_counter() - t0
        got = Counter(LAUNCHES)
        launches.update(got)
        wrong = any(got[name] != n_bands for name in expect) or set(got) - set(expect)
        if cuda and wrong:
            raise AssertionError(f"{what}: launches {dict(got)}, expected {n_bands} of "
                                 f"each of {expect}")
        return out, dt

    def sharded(x, src_gm, tgt_gm, mesh, interp, expect):
        """One sharded_reproject call (planning included), counted."""
        return counted(
            lambda: sharded_reproject(x, src_gm, tgt_gm, mesh, interp_method=interp),
            mesh.size, expect, f"sharded_reproject {interp}",
        )

    def held(got, ref, what, atol=1e-6, flips=0.0):
        """NaN masks equal; valid pixels within *atol*, or (nearest, *flips*
        > 0) equal but on at most that share of them.  In slices of rows,
        so that the comparison needs little memory."""
        if got.shape != ref.shape:
            raise AssertionError(f"{what}: {tuple(got.shape)} != {tuple(ref.shape)}")
        a, b = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
        n_valid = n_differ = 0
        d_max = 0.0
        for r in range(0, a.shape[0], 2048):
            x, y = a[r : r + 2048], b[r : r + 2048]
            nan_x, nan_y = torch.isnan(x), torch.isnan(y)
            if not torch.equal(nan_x, nan_y):
                raise AssertionError(f"{what}: NaN masks differ at "
                                     f"{int((nan_x != nan_y).sum())} pixels of rows {r}..")
            d = torch.where(nan_y, 0.0, x.double() - y.double()).abs()
            n_valid += int((~nan_y).sum())
            n_differ += int((d > 0).sum())
            d_max = max(d_max, d.max().item())
        if n_valid < 0.5 * a.numel():
            raise AssertionError(f"{what}: only {n_valid / a.numel():.3f} valid")
        if flips:
            if n_differ > flips * n_valid:
                raise AssertionError(f"{what}: {n_differ / n_valid:.3g} of the pixels differ")
            return f"{n_differ / n_valid:.3g} of the valid pixels differ"
        if d_max > atol:
            raise AssertionError(f"{what}: max abs diff {d_max} above {atol}")
        return f"max abs diff {d_max:.3g}"

    def exact(got, ref, name, what):
        err[name] = max(err[name], h.compare(got, ref, "exact", f"{what}: {name} vs plain"))

    # -- BASELINE #5 at full width: the headline's geometry, 4 bands --------
    n = sizes["n"]
    res = 30.0 * 20480 / n
    utm = GridMapping.regular(size=(n, n), xy_min=(300000.0, 5200000.0), xy_res=res,
                              crs="epsg:32632")
    laea = GridMapping.regular(size=(n, n), xy_min=(4050000.0, 2650000.0), xy_res=res,
                               crs="epsg:3035")
    gen = torch.Generator(device=dev).manual_seed(0)
    x4 = torch.rand((sizes["bands"], n, n), generator=gen, device=dev)
    mesh = make_mesh(devices=[dev] * sizes["mesh"])
    srw_kernels = B5_KERNELS[:2]
    out, first = sharded(x4, utm, laea, mesh, "bilinear", srw_kernels)
    del out
    # warm calls: the planned step (sharded_reproject plans on every call,
    # as the JAX package's does)
    step, (pad, _) = make_sharded_srw_step(mesh, utm, laea, src_batch_dims=1)
    plan = step.plan
    if pad:
        raise AssertionError(f"{n} rows do not divide into {mesh.size} bands")
    warm = []
    for _ in range(5):
        out, dt = counted(lambda: step(x4), mesh.size, srw_kernels, "the SRW step")
        warm.append(dt)
        del out
    peak = base = 0
    if cuda:
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    out, _ = counted(lambda: step(x4), mesh.size, srw_kernels, "the SRW step")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
    full = out.full()
    del out
    ref = make_srw_reproject_fn(utm, laea, "bilinear", nan, dev)(x4)
    agree = held(full, ref, "sharded vs single-chip SRW, bilinear")
    w = statistics.median(warm)
    mpix = sizes["bands"] * n * n / 1e6
    print(
        f"{tag} BASELINE #5 sharded_reproject {n}^2 x {sizes['bands']} float32 bands "
        f"UTM32N->EPSG:3035 bilinear on a mesh of {mesh.size} x {dev} (band {plan.band_h} "
        f"rows, halo {plan.halo}, d_v={plan.d_v} d_h={plan.d_h}): first call {first:.3f} s "
        f"(planning included); the planned step warm, median of 5: {w * 1e3:.2f} ms = "
        f"{mpix / w:.1f} Mpix/s over the bands; peak "
        f"device memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB held before it); vs the single-chip make_srw_fn: NaN "
        f"masks equal, {agree}"
    )
    del ref, full
    for interp in ("triangular", "nearest"):
        out, dt = sharded(x4[0], utm, laea, mesh, interp, srw_kernels)
        ref = make_srw_reproject_fn(utm, laea, interp, nan, dev)(x4[0])
        agree = held(out.full(), ref, f"sharded vs single-chip SRW, {interp}")
        print(f"{tag} BASELINE #5 one band {interp}: first call {dt:.3f} s; vs the "
              f"single-chip make_srw_fn: NaN masks equal, {agree}")
        del out, ref
    if cuda:
        torch.cuda.empty_cache()

    # K1's and K2's band forms against their plain versions at the 20480^2
    # band shapes (band 0 reads from off < 0), timed on band 1
    bands, _ = step.bands(x4)
    halos = step.exchange(bands)
    for k in (0, 1):
        v_args = step.vertical_args(bands, halos, k)
        v, _ = srw_vertical_band(*v_args)
        exact(v, srw_vertical_band_plain(*v_args)[0], "srw_vertical_band",
              f"{n}^2 band {k} (off {v_args[9]})")
        h_args = step.horizontal_args(v, None, k)
        o = srw_horizontal_band(*h_args)
        exact(o, srw_horizontal_band_plain(*h_args), "srw_horizontal_band", f"{n}^2 band {k}")
    # K2's band form at band 1 on the other methods (their vertical passes
    # from the same plan; triangular with vd) and on NaN rows of v
    for interp in ("nearest", "triangular"):
        step_m = ShardedSRWStep(step.devices, plan, interp, nan, 1)
        v_m, vd_m = srw_vertical_band(*step_m.vertical_args(bands, halos, 1))
        m_args = step_m.horizontal_args(v_m, vd_m, 1)
        exact(srw_horizontal_band(*m_args), srw_horizontal_band_plain(*m_args),
              "srw_horizontal_band", f"{n}^2 band 1, {interp}")
        del step_m, v_m, vd_m, m_args
    v_nan = v.clone()
    v_nan[:, 100:103] = nan
    v_nan[:, -7] = nan
    m_args = step.horizontal_args(v_nan, None, 1)
    exact(srw_horizontal_band(*m_args), srw_horizontal_band_plain(*m_args),
          "srw_horizontal_band", f"{n}^2 band 1, NaN rows of v")
    # and on the band's first 1, 2 and 3 variables (fewer bands an item)
    for b in (1, 2, 3):
        m_args = (v_nan[:b],) + m_args[1:]
        exact(srw_horizontal_band(*m_args), srw_horizontal_band_plain(*m_args),
              "srw_horizontal_band", f"{n}^2 band 1, its first {b} variables, NaN rows of v")
    del v_nan, m_args
    # the step's kernels on the card (the launches a call are counted above)
    on_card = device_kernels(lambda: step(x4)) if cuda else Counter()
    want = ("srw_vertical_kernel", "srw_horizontal_kernel")
    if cuda and not all(on_card[k] for k in want):
        raise AssertionError(f"the SRW step ran {dict(on_card)} on the card, not {want}")
    timings["srw_vertical_band"] = h.time_pair(
        lambda: srw_vertical_band(*v_args), lambda: srw_vertical_band_plain(*v_args), 5)
    timings["srw_horizontal_band"] = h.time_pair(
        lambda: srw_horizontal_band(*h_args), lambda: srw_horizontal_band_plain(*h_args), 5)
    ext = v_args[0]
    tri = v_args[7] == "triangular"
    bounds["srw_vertical_band"] = vertical_band_bound(
        ext, v_args[1], v_args[3], v_args[4], v_args[5], v_args[10], v_args[9], tri)
    bounds["srw_horizontal_band"] = horizontal_bound(v, SimpleNamespace(
        out_h=o.shape[-2], out_w=o.shape[-1], ix_c=h_args[1], base_h=h_args[4],
        d_h=h_args[6]), tri)
    shapes = {"srw_vertical_band": f"ext {tuple(ext.shape)} -> v {tuple(v.shape)}",
              "srw_horizontal_band": f"v {tuple(v.shape)} -> {tuple(o.shape)}"}
    del bands, halos, v_args, h_args, ext, v, o, step, x4
    if cuda:
        torch.cuda.empty_cache()
    print(f"{tag} the SRW step's launches a call: {dict.fromkeys(srw_kernels, mesh.size)}; "
          f"the profiler saw on the card over 3 calls "
          f"{', '.join(f'{k} {on_card[k]}' for k in want)}")

    # -- K2's band form on hard bands: each band's last row tile overlapping
    # its predecessor (row tiles of 64: tap_budget=1), a target width no 64
    # divides and a source width no 4 divides (no 16-byte copies); every
    # method, clean and with NaN rows; every band against its plain version
    (hw, hh), ht = sizes["hard"]
    hard_src = GridMapping.regular(size=(hw, hh), xy_min=(300000.0, 5200000.0), xy_res=res,
                                   crs="epsg:32632")
    hard_tgt = GridMapping.regular(size=(ht, ht), xy_min=(4055000.0, 2655000.0), xy_res=res,
                                   crs="epsg:3035")
    z = torch.rand((2, hh, hw), generator=gen, device=dev)
    z_nan = z.clone()
    z_nan[:, hh // 3 : hh // 3 + 3] = nan
    z_nan[:, 2 * hh // 3] = nan
    for interp in METHODS:
        hstep, (pad, _) = make_sharded_srw_step(mesh, hard_src, hard_tgt, interp_method=interp,
                                                src_batch_dims=1, tap_budget=1)
        p = hstep.plan
        if not (p.tiles_per_band * p.row_tile > p.out_band_h and p.out_w % 64 and p.src_w % 4):
            raise AssertionError(f"hard bands: row tile {p.row_tile} of {p.out_band_h} rows, "
                                 f"out_w {p.out_w}, src_w {p.src_w}")
        for data, what in ((z, "clean"), (z_nan, "NaN rows")):
            zb, _ = hstep.bands(torch.nn.functional.pad(data, (0, 0, 0, pad), value=nan))
            zh = hstep.exchange(zb)
            for k in range(mesh.size):
                v_k, vd_k = srw_vertical_band(*hstep.vertical_args(zb, zh, k))
                k_args = hstep.horizontal_args(v_k, vd_k, k)
                exact(srw_horizontal_band(*k_args), srw_horizontal_band_plain(*k_args),
                      "srw_horizontal_band", f"hard band {k}, {interp}, {what}")
            del zb, zh, v_k, vd_k, k_args
    print(f"{tag} K2's band form equals its plain version on {hw}x{hh} -> {ht}^2 over "
          f"{mesh.size} bands (row tiles of {p.row_tile} in bands of {p.out_band_h} rows, the "
          f"last overlapping by {p.tiles_per_band * p.row_tile - p.out_band_h}; out_w "
          f"{p.out_w}, src_w {p.src_w}), every method, clean and with NaN rows; at the "
          f"{n}^2 band, every method and NaN rows of v")
    del z, z_nan, hstep

    # -- K2's band form on a downscale: windows of some 1000 columns a
    # segment, whose launch stages fewer bands an item and stages than the
    # ring's default; every method, each band against its plain version and
    # the step against its plain step
    s, scale = sizes["down"]
    down_src = GridMapping.regular(size=(s, s), xy_min=(300000.0, 5200000.0), xy_res=30.0,
                                   crs="epsg:32632")
    down_tgt = GridMapping.regular(size=(s // scale, s // scale),
                                   xy_min=(4050000.0, 2650000.0), xy_res=30.0 * scale,
                                   crs="epsg:3035")
    z = torch.rand((2, s, s), generator=gen, device=dev)
    for interp in METHODS:
        dstep, (pad, _) = make_sharded_srw_step(mesh, down_src, down_tgt, interp_method=interp,
                                                src_batch_dims=1)
        extent = max(w.extent for w in dstep.plan.win_h)
        dl = plan_band_launch(2, extent, interp == "triangular")
        if cuda and not dl.group < 2:
            raise AssertionError(f"downscale: windows of {extent} columns launch as {dl}")
        zp = torch.nn.functional.pad(z, (0, 0, 0, pad), value=nan)
        LAUNCHES.clear()
        got = dstep(zp)
        if cuda and Counter(LAUNCHES) != Counter(dict.fromkeys(srw_kernels, mesh.size)):
            raise AssertionError(f"the {scale}x downscale step, {interp}: launches "
                                 f"{dict(LAUNCHES)}")
        for k, (a, b) in enumerate(zip(got.bands, dstep.plain(zp).bands)):
            exact(a, b, "srw_horizontal_band", f"{scale}x downscale, {interp}, band {k}")
        del got
        if cuda:
            # every (bands an item, stages) the kernel instantiates, at 4, 2
            # and 1 warps a block where it fits, on band 0 through the C entry
            zb, _ = dstep.bands(zp)
            v0, vd0 = srw_vertical_band(*dstep.vertical_args(zb, dstep.exchange(zb), 0))
            k_args = dstep.horizontal_args(v0, vd0, 0)
            ref = srw_horizontal_band_plain(*k_args)
            row_bytes = 4 * extent * (2 if interp == "triangular" else 1)
            lib = _build.load()
            for g, st in BAND_ITEMS:
                for w in (4, 2, 1):
                    plan_k = BandLaunch(g, st, w, w * st * g * row_bytes)
                    if plan_k.smem > SMEM_BLOCK_MAX:
                        continue
                    got = torch.full_like(ref, -7.0)
                    rc = lib.xrt_srw_horizontal_f32(
                        *horizontal_c_args(*k_args, got, plan_k),
                        torch.cuda.current_stream().cuda_stream)
                    _build.check(lib, rc, f"K2 as {plan_k}")
                    exact(got, ref, "srw_horizontal_band",
                          f"{scale}x downscale, {interp}, band 0, launched as {plan_k}")
            del zb, v0, vd0, k_args, ref, got
        del zp
    print(f"{tag} K2's band form equals its plain version on a {scale}x downscale ({s}^2 "
          f"UTM32N -> {s // scale}^2 EPSG:3035 over {mesh.size} bands, 2 variables, every "
          f"method, on band 0 also launched as each (bands an item, stages) of {BAND_ITEMS} at "
          f"4, 2 and 1 warps where it fits; windows of {extent} columns a segment, the "
          f"triangular launch {dl})")
    del z, dstep

    # -- past the two-pass gate: BASELINE #3's geometry, the K3 band form ----
    gw, gh, gt = sizes["gate"]
    geo = GridMapping.regular(size=(gw, gh), xy_min=(-180.0, -90.0), xy_res=360.0 / gw,
                              crs="epsg:4326")
    laea_g = GridMapping.regular(size=(gt, gt), xy_min=(2000000.0, 1000000.0),
                                 xy_res=1500.0 * 4096 / gt, crs="epsg:3035")
    x = torch.rand((gh, gw), generator=gen, device=dev)
    xc, geo_c = crop_source(x, geo, laea_g)
    if make_sharded_srw_step(mesh, geo_c, laea_g) is not None:
        raise AssertionError("the gate geometry admits the sharded SRW")
    step, (pad, _) = make_sharded_regrid_step(mesh, geo_c, laea_g)
    # against the single-chip K3 on the window sharded_reproject crops: the
    # band form rebases iy by its band's offset in float32, which rounds on
    # the first band (offset -halo): positions move by at most half a
    # float32 ulp of the extended band's height, values in [0, 1) by that
    # plus the lerps' rounding; nearest flips where that moves rint, on
    # about that share of the pixels
    ext_h = step.band_h + 2 * step.halo if step.use_halo else step.band_h
    ulp = 2.0 ** (math.floor(math.log2(ext_h)) - 23)
    for interp in ("bilinear", "nearest"):
        out, dt = sharded(x, geo, laea_g, mesh, interp, B5_KERNELS[2:])
        ref = make_fused_reproject_fn(geo_c, laea_g, interp, nan, dev)(xc)
        agree = held(out.full(), ref, f"sharded regrid vs single-chip K3, {interp}",
                     atol=ulp / 2 + 2.0**-22, flips=ulp if interp == "nearest" else 0.0)
        print(f"{tag} past the gate ({gw}x{gh} EPSG:4326 -> {gt}^2 EPSG:3035, {interp}; "
              f"window {tuple(xc.shape)}, band {step.band_h} rows, halo {step.halo}): "
              f"sharded regrid first call {dt:.3f} s; vs the single-chip K3 on the window: "
              f"NaN masks equal, {agree} (bound {ulp / 2 + 2.0**-22:.3g})")
        del out, ref
    bands, _ = step.bands(torch.nn.functional.pad(xc, (0, 0, 0, pad), value=nan))
    halos = step.exchange(bands)
    # every method on every band (band 0 from its negative offset), a
    # ragged last band (rows no unit of the kernel divides) and a 1-row band
    for interp in METHODS:
        for k in range(mesh.size):
            g_args = list(step.gather_args(bands, halos, k))
            g_args[6] = interp
            o = fused_reproject_band(*g_args)
            exact(o, fused_reproject_band_plain(*g_args), "fused_reproject_band",
                  f"gate band {k} (off {g_args[9]}), {interp}")
        for k, rows, skip in ((mesh.size - 1, step.out_band_h - 5, 0), (1, 1, 17)):
            g_args = list(step.gather_args(bands, halos, k))
            g_args[4], g_args[6], g_args[8] = rows, interp, g_args[8] + skip
            exact(fused_reproject_band(*g_args), fused_reproject_band_plain(*g_args),
                  "fused_reproject_band", f"gate band {k}, {rows} rows from {g_args[8]}, {interp}")
    g_args = step.gather_args(bands, halos, 1)
    o = fused_reproject_band(*g_args)
    timings["fused_reproject_band"] = h.time_pair(
        lambda: fused_reproject_band(*g_args), lambda: fused_reproject_band_plain(*g_args))
    bounds["fused_reproject_band"] = fused_band_bound(*g_args)
    shapes["fused_reproject_band"] = f"ext {tuple(g_args[0].shape)} -> {tuple(o.shape)}"
    # the library yardstick: one F.grid_sample at band 1's positions (border
    # padding, corners aligned): no mask, no fill
    ext, ix_c, iy_c, st, out_h, out_w = g_args[:6]
    row0, off, src_h = g_args[8:]
    rows = torch.arange(row0, row0 + out_h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    gx = interp_field(ix_c, rows, cols, st) / (ext.shape[-1] - 1) * 2 - 1
    gy = (interp_field(iy_c, rows, cols, st).clamp(0, src_h - 1) - off) / (ext.shape[-2] - 1) * 2 - 1
    grid = torch.stack((gx, gy), dim=-1)[None]
    del gx, gy, rows, cols
    for interp in ("bilinear", "nearest"):
        def grid_call(interp=interp):
            return torch.nn.functional.grid_sample(
                ext.reshape((1, 1) + tuple(ext.shape[-2:])), grid, mode=interp,
                padding_mode="border", align_corners=True)

        library[f"fused_reproject_band/{interp}"] = (h.event_ms(grid_call),
                                                     h.device_ms(grid_call))
    library["fused_reproject_band"] = library["fused_reproject_band/bilinear"]
    del bands, halos, g_args, o, step, x, xc, ext, grid

    # -- each band kernel on a halo of several bands and on NaN rows --------
    m = sizes["halo_src"]
    src_gm = GridMapping.regular(size=(m, m), xy_min=(565000.0, 5930000.0), xy_res=100.0,
                                 crs="epsg:32632")
    upper = GridMapping.regular(size=(m * 3 // 4, m * 3 // 8),
                                xy_min=(4320500, 3379500 + m * 100 // 3), xy_res=100,
                                crs="epsg:3035")
    mesh8 = make_mesh(devices=[dev] * 8)
    y = torch.rand((2, m, m), generator=gen, device=dev)
    y_nan = y.clone()
    y_nan[:, m // 5 : m // 5 + 3] = nan
    y_nan[:, m // 2] = nan
    cases = []
    for interp in ("bilinear", "nearest", "triangular"):
        step, (pad, _) = make_sharded_srw_step(mesh8, src_gm, upper, interp_method=interp,
                                               src_batch_dims=1)
        if not step.plan.halo > step.plan.band_h or pad:
            raise AssertionError(f"halo {step.plan.halo}, band {step.plan.band_h}")
        cases.append((step, "srw_horizontal_band", interp))
        cases.append((make_sharded_regrid_step(mesh8, src_gm, upper, interp_method=interp,
                                               src_batch_dims=1)[0],
                      "fused_reproject_band", interp))
    for step, name, interp in cases:
        for data, what in ((y, "halo > band"), (y_nan, "halo > band, NaN rows")):
            got, ref = step(data), step.plain(data)
            for k, (a, b) in enumerate(zip(got.bands, ref.bands)):
                exact(a, b, name, f"{what}, {interp}, band {k} of 8")
    print(f"{tag} band kernels vs plain on {m}^2 over 8 bands with a halo of "
          f"{cases[0][0].plan.halo} rows (bands of {cases[0][0].plan.band_h}), clean and "
          f"with NaN rows, every method; at the {n}^2 band shapes (band 0 from off < 0) "
          f"and on every band past the gate: max abs diff "
          f"{', '.join(f'{k} {v}' for k, v in err.items())}")
    for name in B5_KERNELS:
        k, p, kd = timings[name]
        b, by = bounds[name]
        beside = "".join(
            f", F.grid_sample {interp} {library[f'{name}/{interp}'][0]:.4f} ms (device "
            f"{library[f'{name}/{interp}'][1]:.4f} ms)" for interp in ("bilinear", "nearest")
            if f"{name}/{interp}" in library)
        print(f"{tag} {name} ({shapes[name]}): kernel {k:.4f} ms (device {kd:.4f} ms), "
              f"plain {p:.3f} ms, bound {b:.4f} ms ({by}){beside}")
    del y, y_nan, cases
    if cuda:
        torch.cuda.empty_cache()

    # -- the tile stream into a zarr store ----------------------------------
    s, chunk = sizes["stream"], sizes["chunk"]
    work = Path(work_dir)
    shutil.rmtree(work, ignore_errors=True)
    stream_gm = GridMapping.regular(size=(s, s), xy_min=(300000.0, 5200000.0), xy_res=30.0,
                                    crs="epsg:32632")
    data = np.random.default_rng(5).random((2, s, s), dtype=np.float32)
    coords = dict(stream_gm.to_coords(exclude_bounds=True))
    coords["spatial_ref"] = DataArray(np.array(0), dims=(), attrs=stream_gm.crs.to_cf())
    eager = Dataset({"v": DataArray(data, dims=("band", "y", "x"), chunks=(1, chunk, chunk),
                                    attrs=dict(grid_mapping="spatial_ref"))}, coords=coords)
    t0 = time.perf_counter()
    zarrlite.write_dataset(eager, zarrlite.DirectoryStore(work / "source.zarr"))
    t_write = time.perf_counter() - t0

    class Counting(zarrlite.DirectoryStore):
        def __init__(self, root):
            super().__init__(root)
            self.read = set()

        def __getitem__(self, key):
            if key.startswith("v/") and ".z" not in key:
                self.read.add(key)
            return super().__getitem__(key)

    cx, cy = Transformer.from_crs("epsg:32632", "epsg:3035", always_xy=True).transform(
        300000.0 + 15.0 * s, 5200000.0 + 15.0 * s)
    target = GridMapping.regular(size=(s, s), xy_min=(float(cx) - 15.0 * s,
                                 float(cy) - 15.0 * s), xy_res=30.0, crs="epsg:3035",
                                 tile_size=chunk)
    source = Counting(work / "source.zarr")
    lazy = zarrlite.open_dataset(source, lazy=True)
    store = zarrlite.DirectoryStore(work / "target.zarr")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    n_tiles = resample_to_store(lazy, target, store, device=dev)
    t_stream = time.perf_counter() - t0
    stream_launches = dict(LAUNCHES)
    tiles = (-(-s // chunk)) ** 2
    if n_tiles != tiles:
        raise AssertionError(f"the stream computed {n_tiles} of {tiles} tiles")
    t0 = time.perf_counter()
    ref = resample_in_space(eager, target_gm=target.derive(tile_size=(s, s)), device=dev)
    sync()
    t_ref = time.perf_counter() - t0
    back = torch.from_numpy(np.asarray(zarrlite.open_dataset(store)["v"].data))
    agree = held(back, ref["v"].data.cpu(), "the store vs one resample_in_space")
    again = resample_to_store(lazy, target, store, device=dev)
    chunk_key = sorted(k for k in store if k.startswith("v/") and ".z" not in k)[0]
    del store[chunk_key]
    redo = resample_to_store(lazy, target, store, device=dev)
    if (again, redo) != (0, 1):
        raise AssertionError(f"resume: {again} tiles, then {redo} after deleting one chunk")
    corner = Counting(work / "source.zarr")
    corner_gm = GridMapping.regular(size=(s // 8, s // 8), xy_min=(300000.0 + 30.0,
                                    5200000.0 + 30.0), xy_res=30.0, crs="epsg:32632",
                                    tile_size=s // 16)
    resample_to_store(zarrlite.open_dataset(corner, lazy=True), corner_gm,
                      zarrlite.MemoryStore(), device=dev)
    n_chunks = 2 * (-(-s // chunk)) ** 2
    if not 0 < len(corner.read) <= n_chunks // 8:
        raise AssertionError(f"the corner target read {len(corner.read)}/{n_chunks} chunks")
    print(
        f"{tag} stream: {s}^2 x 2 float32 UTM32N in {chunk}^2 chunks (a DirectoryStore, "
        f"written in {t_write:.2f} s) -> {s}^2 EPSG:3035 in {tiles} tiles of {chunk}^2 "
        f"through resample_to_store on {dev}: {t_stream:.2f} s ({len(source.read)} of "
        f"{n_chunks} source chunks read; launches {stream_launches}); one resample_in_space "
        f"of the whole target {t_ref:.2f} s; the store vs it: NaN masks equal, {agree}; "
        f"resumed: {again} tiles, {redo} after deleting {chunk_key}; a {s // 8}^2 corner "
        f"target read {len(corner.read)} of {n_chunks} chunks"
    )
    shutil.rmtree(work, ignore_errors=True)
    return launches, err, timings, bounds, library


# The ESW cell: the global 0.05 deg grid onto EPSG:3035 4096^2 at 937.5 m
# from (2.5e6, 1.4e6), past the two-pass gate; plan_esw admits it (S = 4,
# vertical shift alignment), as make_sharded_esw_step does over 4 bands.
# Its 1- and 4-band stacks go through resample_in_space, one band through
# sharded_reproject over a mesh of 4 entries on the card.
ESW_CELL = dict(target=dict(size=(4096, 4096), xy_min=(2500000.0, 1400000.0), xy_res=937.5,
                            crs="epsg:3035"), bands=4, mesh=4)
ESW_KERNELS = ("esw_gather", "esw_gather_band")
# the sharded ESW against the single-chip ESW of the whole source on data in
# [0, 1): bilinear and triangular values within ESW_WHOLE_ATOL, nearest
# differing on under ESW_WHOLE_FLIPS of the pixels (see esw_phase)
ESW_WHOLE_ATOL = 4e-3
ESW_WHOLE_FLIPS = 2e-3
# a geometry whose target hangs over the source's last row and column: a
# 96^2 UTM32N source onto an 80^2 EPSG:3035 grid 4 km right of and below
# tests/test_srw.py's
ESW_EDGES = (dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"),
             dict(size=(80, 80), xy_min=(4324500, 3375500), xy_res=100, crs="epsg:3035"))
# a sheared case for K13's stage: the ESW cell's source onto a 512^2 target
# at 4 km over its region, whose 16 x 128 tiles the staged kernel bounds to
# 116-161 window columns (bilinear), so about two thirds exceed the stage
# and take the per-pixel body
ESW_SHEARED = dict(size=(512, 512), xy_min=(2500000.0, 1400000.0), xy_res=4000.0,
                   crs="epsg:3035")


def esw_phase(dev, tag, h, geo, ds, cell=ESW_CELL):
    """Drive the exact separable warp's cell on *dev*: ``resample_in_space``
    of the global source *geo* (its dataset *ds*) onto the cell's target
    (K13; 1 band, every method, and 4 bands: first call, warm calls, peak
    device memory, the host's planning), and ``sharded_reproject`` of it
    over a mesh of 4 entries (K13's band form after the halo exchange;
    ``plan_sharded_esw``'s host time, first call, the planned step warm,
    held to the single-chip ESW on the window it crops bit for bit and to
    the one of the whole source within ``ESW_WHOLE_ATOL``, nearest
    differing on under ``ESW_WHOLE_FLIPS``); hold K13 and its band form,
    staged and per pixel, to their plain versions bit for bit (every
    method, NaN and +-inf rows and columns, a numeric fill, a target over
    the source's last row and column, every band, band 0 from its negative
    offset, a ragged last band, the bands of the sheared 512^2 target) with
    their tiles staged as modelled, and time them, every method, beside
    their per-pixel paths and the parent's (``--against``) in turns, K3 and
    its band form on the same geometry and ``F.grid_sample``.  *h* carries
    :func:`main`'s helpers.  Returns (the
    band form's launches on the sharded path, max abs errors, timings,
    bounds, library yardsticks, K3's times beside them)."""
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch._device import LAUNCHES
    from xcube_resampling_tpu_torch.ops.esw import (
        BAND_STAGE_ROWS,
        STAGE_COLS,
        ESWReprojectFn,
        _offset_fields,
        band_tile_rows,
        esw_gather,
        esw_gather_band,
        esw_gather_band_plain,
        esw_gather_plain,
        make_esw_reproject_fn,
        plan_esw,
        stage_cols,
        tile_spans,
    )
    from xcube_resampling_tpu_torch.ops.reproject_ops import (
        fused_reproject,
        fused_reproject_band,
        interp_field,
        make_fused_reproject_fn,
    )
    from xcube_resampling_tpu_torch.ops.srw import _coarse_geometry, _source_window_gm
    from xcube_resampling_tpu_torch.parallel import (
        make_mesh,
        make_sharded_esw_step,
        make_sharded_regrid_step,
        make_sharded_srw_step,
        sharded_reproject,
    )
    from xcube_resampling_tpu_torch.parallel.halo import crop_source, plan_sharded_esw
    from xcube_resampling_tpu_torch.reproject import device_reproject_fn

    nan = float("nan")
    err = dict.fromkeys(ESW_KERNELS, 0.0)
    timings, bounds, library, k3 = {}, {}, {}, {}
    band_launches: Counter = Counter()
    geo_gm = GridMapping.from_dataset(ds)
    tgt = GridMapping.regular(**cell["target"])
    mpix = tgt.height * tgt.width / 1e6
    where = (f"4326 {360 / geo.shape[-1]:g} deg -> EPSG:3035 {tgt.height}x{tgt.width} at "
             f"{tgt.xy_res[0]:g} m")

    def exact(got, ref, name, what):
        err[name] = max(err[name], h.compare(got, ref, "exact", f"{what}: {name} vs plain"))

    def peak_of(call):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base, base

    # the host's planning alone: the coarse fields and the window, plan_esw
    t0 = time.perf_counter()
    fields = _coarse_geometry(geo_gm, tgt, 16)
    _, win = _source_window_gm(geo_gm, fields, 8 + 48)
    t1 = time.perf_counter()
    plan = plan_esw(geo_gm, tgt, fields=_offset_fields(fields, *win), fields_global=fields,
                    win=win)
    t_plan = time.perf_counter() - t1
    if plan is None or plan.bits_v < 1:
        raise AssertionError("plan_esw refused the ESW cell or planned no shift alignment")
    print(f"{tag} ESW cell plan on the host: coarse fields and window {t1 - t0:.3f} s, "
          f"plan_esw {t_plan:.3f} s (S={plan.n_samples}, bits_v={plan.bits_v}, "
          f"bits_h={plan.bits_h}, window {win})")

    # -- resample_in_space, 1 band and 4 bands ------------------------------
    k13 = ("esw_gather",)
    for interp in METHODS:
        out, first = h.run_main(ds, tgt, interp, k13, exact={"esw_gather": 1})
        share = h.check_output(out["v"].data, (tgt.height, tgt.width))
        fn = device_reproject_fn(geo_gm, tgt, interp, nan, dev)
        if not isinstance(fn, ESWReprojectFn):
            raise AssertionError(f"the ESW cell ran {type(fn).__name__}, not the ESW")
        exact(out["v"].data, fn.plain(geo), "esw_gather", f"the ESW cell, {interp}")
        line = (f"{tag} resample_in_space ESW cell {where} {interp} (K13, no flag): first "
                f"call {first:.3f} s (planning included); finite share {share:.4f}; vs plain "
                f"equal")
        if interp == "bilinear":
            _, warm = h.warm_calls(ds, tgt, interp, k13, 5, exact={"esw_gather": 1})
            _, peak, base = peak_of(lambda: h.run_main(ds, tgt, interp, k13)[0])
            line += (f"; warm median of 5 {warm * 1e3:.3f} ms = {mpix / warm:.1f} Mpix/s; "
                     f"peak device memory {peak / 2**30:.3f} GiB above the "
                     f"{base / 2**30:.3f} GiB held before it")
        print(line)
        del out
    gen = torch.Generator(device=dev).manual_seed(15)
    x4 = torch.rand((cell["bands"],) + tuple(geo.shape), generator=gen, device=dev)
    ds4 = h.dataset(geo_gm, v=x4)
    out, first = h.run_main(ds4, tgt, "bilinear", k13, exact={"esw_gather": 1})
    h.check_output(out["v"].data, (cell["bands"], tgt.height, tgt.width))
    fn = device_reproject_fn(geo_gm, tgt, "bilinear", nan, dev)
    exact(out["v"].data, fn.plain(x4), "esw_gather", f"the ESW cell, {cell['bands']} bands")
    del out
    _, warm4 = h.warm_calls(ds4, tgt, "bilinear", k13, 5, exact={"esw_gather": 1})
    _, peak4, base4 = peak_of(lambda: h.run_main(ds4, tgt, "bilinear", k13)[0])
    print(f"{tag} resample_in_space ESW cell {cell['bands']} bands bilinear: first call "
          f"{first:.3f} s (plan memoised); warm median of 5 {warm4 * 1e3:.3f} ms = "
          f"{cell['bands'] * mpix / warm4:.1f} Mpix/s over the bands; peak device memory "
          f"{peak4 / 2**30:.3f} GiB above the {base4 / 2**30:.3f} GiB held before it; vs "
          f"plain equal")

    # -- K13 against its plain version on hard inputs -----------------------
    j0, j1, i0, i1 = win
    xe = geo.clone()
    xe[j0] = nan
    xe[j1 - 1] = float("inf")
    xe[:, i0] = -float("inf")
    xe[:, i1 - 1] = nan
    xe[(j0 + j1) // 2] = float("inf")
    xe[:, (i0 + i1) // 2] = nan
    xe[j0 + (j1 - j0) // 3, i0 + (i1 - i0) // 3 : i0 + (i1 - i0) // 2] = -float("inf")
    for interp in METHODS:
        for fill in (nan, -9999.0):
            fn_m = make_esw_reproject_fn(geo_gm, tgt, interp, fill, device=dev)
            a = fn_m.args(fn_m.crop(xe))
            exact(esw_gather(*a), esw_gather_plain(*a), "esw_gather",
                  f"the ESW cell, NaN and +-inf rows and columns, fill {fill}, {interp}")
    src_e, tgt_e = (GridMapping.regular(**g) for g in ESW_EDGES)
    xs = torch.rand((3, 96, 96), generator=gen, device=dev)
    xs[1, -1], xs[1, :, -1], xs[2, 0], xs[2, :, 0] = float("inf"), nan, -float("inf"), nan
    for interp in METHODS:
        fn_e = make_esw_reproject_fn(src_e, tgt_e, interp, nan, device=dev)
        got, ref = fn_e(xs), fn_e.plain(xs)
        exact(got, ref, "esw_gather", f"a target over the source's last row and column, {interp}")
    share_e = torch.isfinite(ref[0]).float().mean().item()
    print(f"{tag} esw_gather vs plain on the ESW cell with NaN and +-inf rows and columns "
          f"(fills NaN and -9999, every method) and on a 96^2 UTM32N -> 80^2 EPSG:3035 target "
          f"over the source's last row and column (3 bands, +-inf and NaN edge rows and "
          f"columns, finite share {share_e:.3f}): equal")

    # -- the staged and the per-pixel path (staged=False), every method, 1
    # and 4 bands, and a sheared target whose tiles partly fall back
    sheared = GridMapping.regular(**ESW_SHEARED)
    shares = {}
    for interp in METHODS:
        for where_m, tgt_m in (("the ESW cell", tgt), ("the sheared target", sheared)):
            fn_m = make_esw_reproject_fn(geo_gm, tgt_m, interp, nan, device=dev)
            for x in (geo[None], x4):
                a = fn_m.args(fn_m.crop(x))
                ref = esw_gather_plain(*a)
                exact(esw_gather(*a), ref, "esw_gather", f"{where_m}, {len(x)} bands, {interp}, "
                                                          f"staged")
                exact(esw_gather(*a, staged=False), ref, "esw_gather",
                      f"{where_m}, {len(x)} bands, {interp}, per pixel")
            shares[where_m, interp] = staged_share(esw_spans(a), interp)
            del fn_m, a, ref
    if not 0 < shares["the sheared target", "bilinear"] < 1:
        raise AssertionError(f"the sheared target stages {shares} of its tiles, not some")
    print(f"{tag} esw_gather vs plain, staged (up to {STAGE_COLS} columns, nearest "
          f"{stage_cols('nearest')}) and per pixel, every "
          f"method, 1 and {cell['bands']} bands, at the ESW cell and on a sheared 512^2 target "
          f"at 4 km: equal")
    print(f"{tag} esw_gather tiles staged, modelled from the inputs (ops.esw.tile_spans), not "
          f"counted by the kernel: " + ", ".join(f"{w} {m} {v:.4f}" for (w, m), v in shares.items()))

    # -- sharded_reproject over a mesh of 4 entries -------------------------
    mesh = make_mesh(devices=[dev] * cell["mesh"])
    xc, geo_c = crop_source(geo, geo_gm, tgt)
    if make_sharded_srw_step(mesh, geo_c, tgt) is not None:
        raise AssertionError("the ESW cell admits the sharded SRW")
    plan_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        plan_sharded_esw(mesh.size, geo_c, tgt)
        plan_s.append(time.perf_counter() - t0)
    print(f"{tag} plan_sharded_esw on the host alone ({mesh.size} bands of the window "
          f"{tuple(xc.shape)} onto {tgt.height}x{tgt.width}): first {plan_s[0]:.3f} s, median "
          f"of 3 {statistics.median(plan_s):.3f} s")

    def sharded(call, what):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = Counter(LAUNCHES)
        band_launches.update(got)
        if got != Counter({"esw_gather_band": mesh.size}):
            raise AssertionError(f"{what}: launches {dict(got)}, expected {mesh.size} of "
                                 f"esw_gather_band")
        return out, dt

    for interp in METHODS:
        out, dt = sharded(lambda: sharded_reproject(geo, geo_gm, tgt, mesh, interp_method=interp),
                          f"sharded_reproject {interp}")
        got = out.full()
        # the sharded path plans on the window it crops, in that window's
        # float32 fields: it computes K13 there, so it equals the
        # single-chip ESW of the cropped source bit for bit
        on_win = make_esw_reproject_fn(geo_c, tgt, interp, nan, device=dev)
        if on_win is None or on_win.window is not None:
            raise AssertionError("the ESW does not plan the cropped window as a whole")
        h.compare(got, on_win(xc), "exact", f"sharded ESW {interp} vs the single-chip ESW "
                                            f"on its window")
        # against the single-chip ESW of the whole source (global float32
        # fields): NaN masks differ on under 1% of the pixels
        # (tests/test_parallel.py:346-373); where both are valid the
        # positions differ by the fields' float32 rounding, a few ulp of
        # the largest source index.  On data in [0, 1) that moves bilinear
        # and triangular values by at most the position's difference (6.85e-4
        # and 6.96e-4 on an NVIDIA H100): ESW_WHOLE_ATOL holds them, and a
        # one-pixel shift (about 0.5) fails it; nearest flips a pick where a
        # position lies that close to a pixel's edge (1.57e-4 of the pixels
        # there): ESW_WHOLE_FLIPS holds that share.
        ref = make_esw_reproject_fn(geo_gm, tgt, interp, nan, device=dev)(geo)
        mask = (torch.isnan(got) != torch.isnan(ref)).float().mean().item()
        both = ~torch.isnan(got) & ~torch.isnan(ref)
        if mask >= 0.01 or both.float().mean().item() < 0.5:
            raise AssertionError(f"sharded ESW {interp}: NaN masks differ on {mask:.3g}")
        d = (got - ref)[both].abs()
        ulp = 2.0 ** (math.floor(math.log2(max(geo.shape))) - 23)
        d_max, flips = d.max().item(), (d > 0).float().mean().item()
        if interp == "nearest" and flips >= ESW_WHOLE_FLIPS:
            raise AssertionError(f"sharded ESW nearest: {flips:.3g} of the pixels differ from "
                                 f"the single-chip ESW of the whole source")
        if interp != "nearest" and d_max > ESW_WHOLE_ATOL:
            raise AssertionError(f"sharded ESW {interp}: max abs diff {d_max:.3g} from the "
                                 f"single-chip ESW of the whole source, above {ESW_WHOLE_ATOL}")
        print(f"{tag} sharded_reproject ESW cell {interp} over {mesh.size} x {dev} (window "
              f"{tuple(xc.shape)}): first call {dt:.3f} s (planning included); vs the "
              f"single-chip ESW on the window: equal; vs the single-chip ESW on the whole "
              f"source: NaN masks differ on {mask:.3g}, max abs diff {d_max:.3g} "
              f"(float32 ulp at {max(geo.shape)}: {ulp:.3g}; limit "
              f"{'none' if interp == 'nearest' else ESW_WHOLE_ATOL}), differing share "
              f"{flips:.3g} (limit {ESW_WHOLE_FLIPS if interp == 'nearest' else 'none'})")
        del out, got, ref, both, d, on_win
    step, (pad, _) = make_sharded_esw_step(mesh, geo_c, tgt)
    xp = torch.nn.functional.pad(xc, (0, 0, 0, pad), value=nan)
    warm = [sharded(lambda: step(xp), "the ESW step")[1] for _ in range(5)]
    (_, _), peak_s, base_s = peak_of(lambda: sharded(lambda: step(xp), "the ESW step"))
    w = statistics.median(warm)
    print(f"{tag} the sharded ESW step (band {step.band_h} rows, halo {step.halo}, "
          f"S={step.plan.n_samples}, d_v={step.plan.d_v}, d_h={step.plan.d_h}) warm, median "
          f"of 5: {w * 1e3:.3f} ms = {mpix / w:.1f} Mpix/s; peak device memory "
          f"{peak_s / 2**30:.3f} GiB above the {base_s / 2**30:.3f} GiB held before it")

    # -- the band form against its plain version, staged and per pixel ------
    def band_exact(a, what):
        ref = esw_gather_band_plain(*a)
        exact(esw_gather_band(*a), ref, "esw_gather_band", f"{what}, staged")
        exact(esw_gather_band(*a, staged=False), ref, "esw_gather_band", f"{what}, per pixel")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def band_shares(a):
        """A band's rows a tile and share of tiles staged, modelled
        (band_tile_rows, tile_spans at the band's first row; none in tiles
        of fewer than BAND_STAGE_ROWS rows), not counted by the kernel."""
        ext, _, ix_c, _, st, _, out_h, out_w, interp = a[:9]
        w, rows = ext.shape[-1], band_tile_rows(out_h, out_w, sms)
        if rows < BAND_STAGE_ROWS:
            return rows, 0.0
        return rows, staged_share(tile_spans(ix_c, st, out_h, out_w, w, 0, w, interp,
                                             row0=a[10], tile_rows=rows), interp)

    xce, _ = crop_source(xe, geo_gm, tgt)
    band_staged = {}
    for data, what in ((xp, "clean"), (torch.nn.functional.pad(xce, (0, 0, 0, pad), value=nan),
                                       "NaN and +-inf rows and columns")):
        for interp in METHODS:
            step_m = make_sharded_esw_step(mesh, geo_c, tgt, interp_method=interp)[0]
            bands, _ = step_m.bands(data)
            halos = step_m.exchange(bands)
            for k in range(mesh.size):
                a = step_m.gather_args(bands, halos, k)
                band_exact(a, f"ESW band {k} (off {a[11]}), {what}, {interp}")
                band_staged["the ESW cell", interp, k] = band_shares(a)
            a = list(step_m.gather_args(bands, halos, mesh.size - 1))
            a[6] -= 5
            band_exact(a, f"ESW last band, {a[6]} rows, {what}, {interp}")
            del bands, halos, a, step_m
    # the sheared 512^2 target over the same mesh (bands too small to fill
    # the card in 16-row tiles: tiles of 2 rows, per pixel), and the ESW
    # cell over 8 bands (tiles of 11 rows, staged)
    xs_c, geo_s = crop_source(geo, geo_gm, sheared)
    mesh8 = make_mesh(devices=[dev] * 8)
    for where_b, m_b, x_b, g_b, t_b in (("the sheared target", mesh, xs_c, geo_s, sheared),
                                        ("the ESW cell over 8 bands", mesh8, xc, geo_c, tgt)):
        for interp in METHODS:
            step_s, (pad_s, _) = make_sharded_esw_step(m_b, g_b, t_b, interp_method=interp)
            bands, _ = step_s.bands(torch.nn.functional.pad(x_b, (0, 0, 0, pad_s), value=nan))
            halos = step_s.exchange(bands)
            for k in range(m_b.size):
                a = step_s.gather_args(bands, halos, k)
                band_exact(a, f"{where_b}, band {k} (off {a[11]}), {interp}")
                band_staged[where_b, interp, k] = band_shares(a)
            del bands, halos, a, step_s
    if not BAND_STAGE_ROWS <= band_staged["the ESW cell over 8 bands", "bilinear", 1][0] < 16:
        raise AssertionError(f"the ESW cell's 8 bands run no short staged tiles: {band_staged}")
    print(f"{tag} esw_gather_band vs plain, staged and per pixel, on every band of the ESW cell "
          f"(band 0 from off {-step.halo}), a ragged last band, clean and with NaN and +-inf "
          f"rows and columns, on every band of the sheared 512^2 target and of the ESW cell "
          f"over 8 bands, every method: equal")
    for where_b in ("the ESW cell", "the sheared target", "the ESW cell over 8 bands"):
        print(f"{tag} esw_gather_band tiles staged at {where_b}, modelled from the inputs "
              f"(ops.esw.band_tile_rows on {sms} SMs, tile_spans at each band's first row), not "
              f"counted by the kernel: tiles of {band_staged[where_b, 'bilinear', 0][0]} rows; "
              + "; ".join(f"{m} " + ", ".join(f"band {k} {v[1]:.4f}"
                                               for (w_, m_, k), v in band_staged.items()
                                               if (w_, m_) == (where_b, m)) for m in METHODS))

    # -- timings, bounds and yardsticks -------------------------------------
    fn = make_esw_reproject_fn(geo_gm, tgt, "bilinear", nan, device=dev)
    a1 = fn.args(fn.crop(geo[None]))
    timings["esw_gather"] = h.time_pair(lambda: esw_gather(*a1), lambda: esw_gather_plain(*a1))
    bounds["esw_gather"] = esw_bound(a1)
    a4 = fn.args(fn.crop(x4))
    k4_dev = h.device_ms(lambda: esw_gather(*a4))
    b4, _ = esw_bound(a4)
    rows = torch.arange(fn.out_h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(fn.out_w, dtype=torch.float32, device=dev)[None, :]
    plane = a1[0]
    gx = (interp_field(fn.ix_c, rows, cols, fn.step) - i0) / (plane.shape[-1] - 1) * 2 - 1
    gy = (interp_field(fn.iy_c, rows, cols, fn.step) - j0) / (plane.shape[-2] - 1) * 2 - 1
    grid = torch.stack((gx, gy), dim=-1)[None]
    del gx, gy

    def grid_call():
        return torch.nn.functional.grid_sample(plane[None], grid, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    library["esw_gather"] = (h.event_ms(grid_call), h.device_ms(grid_call))
    # the staged kernel beside the per-pixel path and the parent tree's
    # kernel (--against), in turns, every method: 1 and 4 bands at the
    # cell, 1 band on the sheared target (most of its tiles fall back)
    turns = {}
    for interp in METHODS:
        for where_m, tgt_m, xs in (("", tgt, (geo[None], x4)), ("sheared_", sheared, (geo[None],))):
            fn_m = make_esw_reproject_fn(geo_gm, tgt_m, interp, nan, device=dev)
            for x in xs:
                a = fn_m.args(fn_m.crop(x))
                key = f"{where_m}{interp}_{len(x)}"
                turns[f"per_pixel_{key}"] = beside_parent(
                    h, lambda a=a: esw_gather(*a), lambda a=a: esw_gather(*a, staged=False))
                if h.tree_esw is not None:
                    turns[f"parent_{key}"] = beside_parent(
                        h, lambda a=a: esw_gather(*a), h.tree_esw.k13(a))
    for where_m, bands in (("", (1, cell["bands"])), ("sheared_", (1,))):
        print(f"{tag} esw_gather {'on the sheared target' if where_m else 'at the ESW cell'} in "
              f"turns, device ms (this; per pixel; parent): " + "; ".join(
                  f"{k}: {turns[f'per_pixel_{k}'][0]:.4f}, {turns[f'per_pixel_{k}'][1]:.4f}"
                  + (f", {turns[f'parent_{k}'][1]:.4f}" if f"parent_{k}" in turns else "")
                  for k in (f"{where_m}{m}_{b}" for m in METHODS for b in bands)))
    k3_fn = make_fused_reproject_fn(geo_gm, tgt, "bilinear", nan, dev)
    k3_args = (geo[None], k3_fn.ix_c, k3_fn.iy_c, k3_fn.step, k3_fn.out_h, k3_fn.out_w,
               "bilinear", nan)
    k3_out = fused_reproject(*k3_args)
    d_k3 = (esw_gather(*a1) - k3_out).abs().nan_to_num().max().item()
    k3["esw_gather"] = dict(k3_ms=h.event_ms(lambda: fused_reproject(*k3_args)),
                            k3_device_ms=h.device_ms(lambda: fused_reproject(*k3_args)),
                            device_ms_4=k4_dev, bound_ms_4=b4)
    for k, (this, other) in turns.items():
        k3["esw_gather"][f"{k}_device_ms_turns"] = this
        k3["esw_gather"][f"{k}_other_device_ms"] = other
    del k3_out
    (k, p, kd), (b, by) = timings["esw_gather"], bounds["esw_gather"]
    print(f"{tag} esw_gather at the ESW cell (window {tuple(plane.shape)} -> {where}), bilinear: "
          f"kernel {k:.4f} ms (device {kd:.4f} ms), plain {p:.3f} ms, bound {b:.4f} ms ({by}); "
          f"{cell['bands']} bands device {k4_dev:.4f} ms, bound {b4:.4f} ms; K3 on the same "
          f"geometry {k3['esw_gather']['k3_ms']:.4f} ms (device "
          f"{k3['esw_gather']['k3_device_ms']:.4f} ms), max |K13 - K3| {d_k3:.3g}; "
          f"F.grid_sample {library['esw_gather'][0]:.4f} ms (device "
          f"{library['esw_gather'][1]:.4f} ms)")
    bands, _ = step.bands(xp)
    halos = step.exchange(bands)
    ab = step.gather_args(bands, halos, 1)
    timings["esw_gather_band"] = h.time_pair(lambda: esw_gather_band(*ab),
                                             lambda: esw_gather_band_plain(*ab))
    bounds["esw_gather_band"] = esw_bound(ab, band=True)
    ext, row0, off = ab[0], ab[10], ab[11]
    rows = torch.arange(row0, row0 + ab[6], dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(ab[7], dtype=torch.float32, device=dev)[None, :]
    gx = interp_field(ab[2], rows, cols, ab[4]) / (ext.shape[-1] - 1) * 2 - 1
    gy = (interp_field(ab[3], rows, cols, ab[4]) - off) / (ext.shape[-2] - 1) * 2 - 1
    grid_b = torch.stack((gx, gy), dim=-1)[None]
    del gx, gy

    def grid_band():
        return torch.nn.functional.grid_sample(ext[None], grid_b, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    library["esw_gather_band"] = (h.event_ms(grid_band), h.device_ms(grid_band))
    regrid, (pad_r, _) = make_sharded_regrid_step(mesh, geo_c, tgt)
    rb, _ = regrid.bands(torch.nn.functional.pad(xc, (0, 0, 0, pad_r), value=nan))
    ga = regrid.gather_args(rb, regrid.exchange(rb), 1)
    k3["esw_gather_band"] = dict(k3_ms=h.event_ms(lambda: fused_reproject_band(*ga)),
                                 k3_device_ms=h.device_ms(lambda: fused_reproject_band(*ga)))
    (k, p, kd), (b, by) = timings["esw_gather_band"], bounds["esw_gather_band"]
    print(f"{tag} esw_gather_band at the ESW cell's band 1 (ext {tuple(ext.shape)} -> "
          f"{ab[6]} x {ab[7]}, off {off}), bilinear: kernel {k:.4f} ms (device {kd:.4f} ms), "
          f"plain {p:.3f} ms, bound {b:.4f} ms ({by}); K3's band form on the regrid's band 1 "
          f"(ext {tuple(ga[0].shape)}) {k3['esw_gather_band']['k3_ms']:.4f} ms (device "
          f"{k3['esw_gather_band']['k3_device_ms']:.4f} ms); F.grid_sample "
          f"{library['esw_gather_band'][0]:.4f} ms (device {library['esw_gather_band'][1]:.4f} "
          f"ms)")

    # -- nearest and triangular: K13 and its band form beside K3's, at the
    # same shapes (F.grid_sample has no triangular mode)
    xr = torch.nn.functional.pad(xc, (0, 0, 0, pad_r), value=nan)
    for interp in ("nearest", "triangular"):
        fn_m = make_esw_reproject_fn(geo_gm, tgt, interp, nan, device=dev)
        am = fn_m.args(fn_m.crop(geo[None]))
        k3_m = make_fused_reproject_fn(geo_gm, tgt, interp, nan, dev)
        k3m = (geo[None], k3_m.ix_c, k3_m.iy_c, k3_m.step, k3_m.out_h, k3_m.out_w, interp, nan)
        step_m = make_sharded_esw_step(mesh, geo_c, tgt, interp_method=interp)[0]
        bm, _ = step_m.bands(xp)
        abm = step_m.gather_args(bm, step_m.exchange(bm), 1)
        regrid_m = make_sharded_regrid_step(mesh, geo_c, tgt, interp_method=interp)[0]
        rbm, _ = regrid_m.bands(xr)
        gam = regrid_m.gather_args(rbm, regrid_m.exchange(rbm), 1)
        one = {f"{interp}_ms": h.event_ms(lambda: esw_gather(*am)),
               f"{interp}_device_ms": h.device_ms(lambda: esw_gather(*am)),
               f"{interp}_bound_ms": esw_bound(am)[0],
               f"k3_{interp}_device_ms": h.device_ms(lambda: fused_reproject(*k3m))}
        band = {f"{interp}_ms": h.event_ms(lambda: esw_gather_band(*abm)),
                f"{interp}_device_ms": h.device_ms(lambda: esw_gather_band(*abm)),
                f"{interp}_bound_ms": esw_bound(abm, band=True)[0],
                f"k3_{interp}_device_ms": h.device_ms(lambda: fused_reproject_band(*gam))}
        lib = ""
        if interp == "nearest":
            def grid_nearest(src=plane, g=grid):
                return torch.nn.functional.grid_sample(src[None], g, mode="nearest",
                                                       padding_mode="border", align_corners=True)

            def grid_band_nearest(src=ext, g=grid_b):
                return torch.nn.functional.grid_sample(src[None], g, mode="nearest",
                                                       padding_mode="border", align_corners=True)

            one["library_nearest_device_ms"] = h.device_ms(grid_nearest)
            band["library_nearest_device_ms"] = h.device_ms(grid_band_nearest)
            lib = (f"; F.grid_sample device {one['library_nearest_device_ms']:.4f} ms, on the "
                   f"band {band['library_nearest_device_ms']:.4f} ms")
        k3["esw_gather"].update(one)
        k3["esw_gather_band"].update(band)
        print(f"{tag} esw_gather at the ESW cell, {interp}: kernel {one[f'{interp}_ms']:.4f} ms "
              f"(device {one[f'{interp}_device_ms']:.4f} ms), bound "
              f"{one[f'{interp}_bound_ms']:.4f} ms; K3 there device "
              f"{one[f'k3_{interp}_device_ms']:.4f} ms; esw_gather_band at band 1: kernel "
              f"{band[f'{interp}_ms']:.4f} ms (device {band[f'{interp}_device_ms']:.4f} ms), "
              f"bound {band[f'{interp}_bound_ms']:.4f} ms; K3's band form on the regrid's band "
              f"1 device {band[f'k3_{interp}_device_ms']:.4f} ms{lib}")
        del fn_m, am, k3_m, k3m, step_m, bm, abm, regrid_m, rbm, gam
    # the band form at band 1 in turns, every method: staged beside its
    # per-pixel path (staged=False) and the parent tree's band form
    # (--against)
    band_turns = {}
    for interp in METHODS:
        step_m = make_sharded_esw_step(mesh, geo_c, tgt, interp_method=interp)[0]
        bm, _ = step_m.bands(xp)
        abm = step_m.gather_args(bm, step_m.exchange(bm), 1)
        band_turns[f"per_pixel_{interp}"] = beside_parent(
            h, lambda a=abm: esw_gather_band(*a), lambda a=abm: esw_gather_band(*a, staged=False))
        if h.tree_esw is not None:
            band_turns[f"parent_{interp}"] = beside_parent(
                h, lambda a=abm: esw_gather_band(*a), h.tree_esw.k13_band(abm))
        del step_m, bm, abm
    print(f"{tag} esw_gather_band at the ESW cell's band 1 in turns, device ms (this; per "
          f"pixel; parent): " + "; ".join(
              f"{m}: {band_turns[f'per_pixel_{m}'][0]:.4f}, {band_turns[f'per_pixel_{m}'][1]:.4f}"
              + (f", {band_turns[f'parent_{m}'][1]:.4f}" if f"parent_{m}" in band_turns else "")
              for m in METHODS))
    for k, (this, other) in band_turns.items():
        k3["esw_gather_band"][f"{k}_device_ms_turns"] = this
        k3["esw_gather_band"][f"{k}_other_device_ms"] = other
    del bands, halos, ab, ext, grid, grid_b, rb, ga, regrid, step, xp, xr, x4, ds4, xe, xce
    torch.cuda.empty_cache()
    return band_launches, err, timings, bounds, library, k3


# The flagship cell: __graft_entry__'s geometry (a UTM32N 100 m source of
# size^2 onto an EPSG:3035 110 m target of size^2 centred on it) at 2048^2,
# a 205 km scene, the largest of the family that the JAX package's cost
# model still sends to its aligned SRW.  resample_in_space pre-downscales
# the source (scale 0.91) and reprojects the 1836 x 1837 coarse image
# through K14 and K15; at 512^2 once more, with a spy on make_srw_aligned_fn.
FLAGSHIP = dict(size=2048, bands=4, small=512)
FLAGSHIP_KERNELS = ("srw_aligned_vertical", "srw_aligned_horizontal")
# the aligned SRW against the tiled one on the same geometry (F1): NaN
# masks may differ where a zero-weight tap of one variant's tap range reads
# the coarse image's NaN edge column (0.13% of the pixels at 2048^2 on the
# CPU): under FLAGSHIP_MASK_SHARE of them
FLAGSHIP_MASK_SHARE = 0.01
# nearest flips only where a position lies within this of a half-pixel tie
FLAGSHIP_TIE = 0.005


def _tile_columns(n, tile):
    """The columns (or rows) of each of the ceil(n / tile) tiles of n."""
    counts = np.full(-(-n // tile), tile, dtype=np.int64)
    counts[-1] = n - tile * (len(counts) - 1)
    return counts


def aligned_vertical_bound(src, st, all_taps=False):
    """K14 (and K17, its bases a tile) reads the source, the coarse field,
    the shifts and the bases once and writes v.  Operations: 13 a position
    (the field's interpolation and the shift) and, per output, the two taps
    that can weigh, a weight (4 operations) and a fused multiply-add (2)
    each, plus one finiteness test of each staged value (its window's, once
    a band): the work the staged kernel's shortcut leaves on finite data;
    *all_taps*: every tap's weight and fused multiply-add, as the direct
    kernel sums them (the earlier count)."""
    batch, _, src_w = src.shape
    outs = batch * st.out_h * src_w
    n_bytes = 4 * (src.numel() + st.iystar_c.numel() + st.s_v.numel() + st.base_v.numel()
                   + outs)
    if all_taps:
        return bound(n_bytes, outs * st.d_v * 6 + 13 * st.out_h * src_w)
    col_tile = getattr(st, "col_tile", src_w)
    spans = st.win_v.lohi.cpu().numpy().astype(np.int64)  # the state's plan
    tested = batch * int(((spans[..., 1] - spans[..., 0]).sum(axis=0)
                          * _tile_columns(src_w, col_tile)[:spans.shape[1]]).sum())
    return bound(n_bytes, outs * 2 * 6 + 13 * st.out_h * src_w + tested)


def aligned_horizontal_bound(v, st, all_taps=False):
    """K15 (and K18) reads v, two coarse fields, the shifts and the bases
    once and writes the output.  Operations: 40 of geometry a pixel (two
    fields interpolated, the shift, the validity test) and, per output, two
    taps of 6 operations, plus one finiteness test of each value of each
    warp's span, once a row and band (*all_taps*: every tap, the earlier count)."""
    from xcube_resampling_tpu_torch.ops.srw_aligned import horizontal_spans

    batch = v.shape[0]
    outs = batch * st.out_h * st.out_w
    n_bytes = 4 * (v.numel() + 2 * st.ix_c.numel() + st.s_h.numel() + st.base_h.numel() + outs)
    if all_taps:
        return bound(n_bytes, outs * st.d_h * 6 + 40 * st.out_h * st.out_w)
    base_h = st.base_h.reshape(-1, st.out_w).cpu().numpy()
    row_tile = getattr(st, "row_tile", st.out_h)
    spans = horizontal_spans(base_h, st.d_h)
    tested = batch * int(((spans[..., 1] - spans[..., 0]).sum(axis=1)
                          * _tile_columns(st.out_h, row_tile)[:base_h.shape[0]]).sum())
    return bound(n_bytes, outs * 2 * 6 + 40 * st.out_h * st.out_w + tested)


# The staged passes' synthetic cases (tests/test_torch_srw_aligned_staged.py
# builds the same on the CPU), at step 1 (each position its coarse value):
# each output's first weighing tap at -1, 0, 1, the middle, d - 2, d - 1
# and past its d = 6 taps, fractions from 0 (integer positions) to 0.999
# with nearest's half ties, signed zeros, and one NaN and one +inf at
# isolated source values (in zero-weight taps of most outputs that read
# them) or none; bases that climb (vertical rows, horizontal columns an
# output): the staged kernels' 64 rows a block ("staged", "integer"), 16
# rows (the planner's first alternative) and the direct kernel (its second)
ALIGNED_SYNTH_D = 6
ALIGNED_SYNTH_OFFSETS = (-1, 0, 1, 3, 4, 5, 6, -2)
ALIGNED_SYNTH_CASES = {
    "staged": (0.5, 2.0, (0.0, 0.25, 0.5, 0.75, 0.999)),
    "integer": (0.5, 2.0, (0.0,)),
    "fewer rows": (12.0, 2.0, (0.0, 0.5, 0.999)),
    "direct": (250.0, 250.0, (0.0, 0.5, 0.999)),
}


def _synthetic_values(rng, shape, special):
    x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = 0.0
    x[rng.random(shape) < 0.05] = -0.0
    if special:
        h, w = shape[-2:]
        x[0, h // 2, w // 3] = np.nan
        x[-1, h // 3, w // 2] = np.inf
    return x


def aligned_synthetic_checks(dev, which, exact):
    """K14 and K15 (*which* "aligned": one tile) or K17 and K18 ("hybrid":
    column tiles of 64, row tiles of 16) against their plain versions bit
    for bit on :data:`ALIGNED_SYNTH_CASES`, bilinear and nearest, with and
    without the isolated NaN and inf; raises unless the vertical plan takes
    64 rows a block, 16 where the bases climb 12 rows an output row, and
    the direct vertical kernel runs exactly where the plan says.  *exact(got, ref,
    name, what)* compares.  Returns the case names."""
    import torch

    from xcube_resampling_tpu_torch.ops import srw_aligned as sa
    from xcube_resampling_tpu_torch.ops import srw_hybrid as sh

    d = ALIGNED_SYNTH_D
    hybrid = which == "hybrid"
    names = (("srw_hybrid_vertical", "srw_hybrid_horizontal") if hybrid
             else ("srw_aligned_vertical", "srw_aligned_horizontal"))
    rng = np.random.default_rng(19)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    for case, (climb_v, climb_h, fracs) in ALIGNED_SYNTH_CASES.items():
        direct = case == "direct"
        # the vertical pass: out_h rows, src_w columns (enough blocks for the
        # plan's most rows a block)
        out_h, src_w = {"direct": (32, 64), "fewer rows": (1024, 300)}.get(case, (1024, 600))
        col_tile = 64 if hybrid else src_w
        n_t = -(-src_w // col_tile)
        base = (np.floor(np.arange(out_h) * climb_v)[:, None]
                + rng.integers(-2, 3, (out_h, n_t))).astype(np.int32)
        src_h = int(base.max()) + d + 4
        s_v = rng.integers(0, 5, src_w).astype(np.int32)
        tile = np.arange(src_w) // col_tile
        field = np.zeros((out_h + 1, src_w + 1), np.float32)
        field[:out_h, :src_w] = (base[:, tile] + rng.choice(ALIGNED_SYNTH_OFFSETS, (out_h, src_w))
                                 + rng.choice(fracs, (out_h, src_w)) + s_v)
        plan = sa.plan_vertical(base, col_tile, d, src_w)
        want = {"direct": 0, "fewer rows": 16}.get(case, 64)
        if plan.rows != want:
            raise AssertionError(f"{names[0]} {case}: the plan takes {plan.rows} rows a block, "
                                 f"not {want}")
        for special in (False, True):
            x = t(_synthetic_values(rng, (2, src_h, src_w), special))
            for interp in ("bilinear", "nearest"):
                args = ((x, t(field), 1, t(s_v), t(base), col_tile, d, interp) if hybrid
                        else (x, t(field), 1, t(s_v), t(base[:, 0]), d, interp))
                vert, plain = ((sh.srw_hybrid_vertical, sh.srw_hybrid_vertical_plain) if hybrid
                               else (sa.srw_aligned_vertical, sa.srw_aligned_vertical_plain))
                before = sa.DIRECT_LAUNCHES[names[0]]
                exact(vert(*args), plain(*args), names[0],
                      f"synthetic {case}, {interp}, {'an isolated NaN and inf' if special else 'finite'}")
                if sa.DIRECT_LAUNCHES[names[0]] - before != int(direct):
                    raise AssertionError(f"{names[0]} {case}: the direct kernel ran "
                                         f"{sa.DIRECT_LAUNCHES[names[0]] - before} times")
        # the horizontal pass: out_h rows, out_w columns
        out_h, out_w = (16, 256) if direct else (64, 300)
        row_tile = 16 if hybrid else out_h
        n_t = -(-out_h // row_tile)
        base = (np.floor(np.arange(out_w) * climb_h)[None, :]
                + rng.integers(-2, 3, (n_t, out_w))).astype(np.int32)
        s_h = rng.integers(0, 7, out_h).astype(np.int32)
        src_w = int(base.max()) + d + 4 + 7
        u = np.arange(out_h) // row_tile
        ix = np.zeros((out_h + 1, out_w + 1), np.float32)
        ix[:out_h, :out_w] = (base[u] + rng.choice(ALIGNED_SYNTH_OFFSETS, (out_h, out_w))
                              + rng.choice(fracs, (out_h, out_w)) + s_h[:, None])
        iy = np.full_like(ix, 3.0)
        iy[:, ::17] = -1.0  # outside the source: the fill
        for special in (False, True):
            v = t(_synthetic_values(rng, (2, out_h, src_w), special))
            for interp, fill in (("bilinear", float("nan")), ("nearest", -9.5)):
                args = ((v, t(ix), t(iy), 1, t(s_h), t(base), row_tile, d, 30, interp, fill)
                        if hybrid else
                        (v, t(ix), t(iy), 1, t(s_h), t(base[0]), d, 30, interp, fill))
                horiz, plain = ((sh.srw_hybrid_horizontal, sh.srw_hybrid_horizontal_plain)
                                if hybrid else
                                (sa.srw_aligned_horizontal, sa.srw_aligned_horizontal_plain))
                exact(horiz(*args), plain(*args), names[1],
                      f"synthetic {case}, {interp}, {'an isolated NaN and inf' if special else 'finite'}")
    return tuple(ALIGNED_SYNTH_CASES)


def isolated_specials(x, seed):
    """A copy of the (B, H, W) *x* with one NaN and one +inf at isolated
    places of its first band: a finite window's neighbours, read by most
    outputs at zero-weight taps."""
    y = x.clone()
    rng = np.random.default_rng(seed)
    h, w = y.shape[-2:]
    y[0, int(rng.integers(h // 4, h // 2)), int(rng.integers(w // 4, w // 2))] = float("nan")
    y[0, int(rng.integers(h // 2, 3 * h // 4)), int(rng.integers(w // 2, 3 * w // 4))] = float("inf")
    return y


def beside_parent(h, kernel, parent):
    """Device ms of *kernel* and of the parent tree's *parent* in turns
    (parent, kernel, kernel, parent): the median of each pair."""
    p1, k1, k2, p2 = (h.device_ms(f) for f in (parent, kernel, kernel, parent))
    return statistics.median([k1, k2]), statistics.median([p1, p2])


def flagship_phase(dev, tag, h, cell=FLAGSHIP):
    """Drive the flagship cell on *dev*: ``resample_in_space`` of the
    2048^2 flagship (K4's downscale form or K4, then K14 and K15; bilinear
    and nearest, 1 band and 4 bands: first call, warm calls, the launches
    counted, no K1 or K2), each output held to the aligned SRW's plain
    version on the coarse image bit for bit; K14 and K15 held to their
    plain versions bit for bit there, with NaN and +-inf rows and columns
    and a numeric fill, and on a plan whose taps pass all four source
    edges; the aligned output against the tiled SRW (K1 + K2) on the same
    geometry within F1's bounds; K14 and K15 timed with their bounds beside
    K1 + K2 on the tiled plan and K3 on the same geometry; the 512^2
    flagship once, its aligned pick seen by a spy on make_srw_aligned_fn.  *h*
    carries :func:`main`'s helpers, whose ``run_main`` counts the main
    path's launches.  Returns (max abs errors, timings, bounds, the
    variants' times)."""
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch import reproject as port_reproject
    from xcube_resampling_tpu_torch._device import LAUNCHES
    from xcube_resampling_tpu_torch.entry import flagship_gms
    from xcube_resampling_tpu_torch.ops import srw as port_srw
    from xcube_resampling_tpu_torch.ops.reproject_ops import (
        fused_reproject,
        interp_field,
        make_fused_reproject_fn,
    )
    from xcube_resampling_tpu_torch.ops.srw_aligned import (
        DIRECT_LAUNCHES,
        srw_aligned_horizontal,
        srw_aligned_horizontal_plain,
        srw_aligned_vertical_plain,
    )
    from xcube_resampling_tpu_torch.ops.srw_kernels import srw_horizontal, srw_vertical
    from xcube_resampling_tpu_torch.reproject import device_reproject_fn

    nan = float("nan")
    err = dict.fromkeys(FLAGSHIP_KERNELS, 0.0)
    timings, bounds, variants = {}, {}, {}
    size, bands = cell["size"], cell["bands"]
    src_gm, tgt = flagship_gms(size, size)
    mpix = tgt.height * tgt.width / 1e6
    where = f"flagship {size}^2 UTM32N 100 m -> EPSG:3035 110 m"
    rng = np.random.default_rng(16)
    x1 = torch.from_numpy(rng.random((size, size), dtype=np.float32)).to(dev)
    x4 = torch.from_numpy(rng.random((bands, size, size), dtype=np.float32)).to(dev)
    downscale = ("affine_gather_reduce", "affine_gather", "coarsen_reduce")
    once = dict.fromkeys(FLAGSHIP_KERNELS, 1)

    def exact(got, ref, name, what):
        err[name] = max(err[name], h.compare(got, ref, "exact", f"{what}: {name} vs plain",
                                             signs=True))

    def run(ds, interp, target=tgt):
        """One counted main-path call, the coarse image kept by a spy on the
        engine's affine call."""
        seen = []
        engine_affine = port_reproject.affine_transform_dataset

        def spy(*args, **kwargs):
            out = engine_affine(*args, **kwargs)
            seen.append(out)
            return out

        port_reproject.affine_transform_dataset = spy
        try:
            out, dt = h.run_main(ds, target, interp, FLAGSHIP_KERNELS, exact=once,
                                 allow=downscale)
        finally:
            port_reproject.affine_transform_dataset = engine_affine
        if LAUNCHES["srw_vertical"] or LAUNCHES["srw_horizontal"]:
            raise AssertionError(f"the flagship launched K1 or K2: {dict(LAUNCHES)}")
        coarse_ds = seen[0]
        return out, dt, coarse_ds["v"].data, GridMapping.from_dataset(coarse_ds)

    states = {}
    for interp in ("bilinear", "nearest"):
        ds1 = h.dataset(src_gm, v=x1)
        out, first, coarse, coarse_gm = run(ds1, interp)
        share = h.check_output(out["v"].data, (tgt.height, tgt.width))
        fn = device_reproject_fn(coarse_gm, tgt, interp, nan, dev)
        if not isinstance(fn, port_srw.AlignedSRWFn) or fn.kind != "aligned":
            raise AssertionError(f"the flagship ran {type(fn).__name__}, not the aligned SRW")
        st = fn.state
        exact(out["v"].data, fn.plain(coarse), "srw_aligned_horizontal",
              f"the flagship, {interp}, 1 band, end to end")
        _, warm = h.warm_calls(ds1, tgt, interp, FLAGSHIP_KERNELS, 5, exact=once,
                               allow=downscale)
        ds4 = h.dataset(src_gm, v=x4)
        out4, first4, coarse4, _ = run(ds4, interp)
        h.check_output(out4["v"].data, (bands, tgt.height, tgt.width))
        exact(out4["v"].data, fn.plain(coarse4), "srw_aligned_horizontal",
              f"the flagship, {interp}, {bands} bands, end to end")
        _, warm4 = h.warm_calls(ds4, tgt, interp, FLAGSHIP_KERNELS, 5, exact=once,
                                allow=downscale)
        print(f"{tag} resample_in_space {where} {interp} (pre-downscale to "
              f"{tuple(coarse.shape)}, then K14 + K15; aligned plan d_v={st.d_v} d_h={st.d_h}, "
              f"shifts up to {int(st.s_v.max())} rows and {int(st.s_h.max())} columns, window "
              f"{fn.window}): first call {first:.3f} s (planning included), warm median of 5 "
              f"{warm * 1e3:.3f} ms = {mpix / warm:.1f} Mpix/s; {bands} bands: first call "
              f"{first4:.3f} s, warm median of 5 {warm4 * 1e3:.3f} ms = "
              f"{bands * mpix / warm4:.1f} Mpix/s; finite share {share:.4f}; vs the plain "
              f"versions on the coarse image: equal")
        states[interp] = (fn, coarse, coarse4, coarse_gm)
        del out, out4

    if any(DIRECT_LAUNCHES[name] for name in FLAGSHIP_KERNELS):
        raise AssertionError(f"the flagship ran the direct kernels: {dict(DIRECT_LAUNCHES)}")

    # -- K14 and K15 against their plain versions ---------------------------
    for interp, (fn, coarse, coarse4, coarse_gm) in states.items():
        for data, what in ((coarse[None], "1 band"), (coarse4, f"{bands} bands")):
            xc = fn.crop(data)
            va = fn.vertical_args(xc)
            v, flags = fn.vertical(xc)  # as the main path: the state's plan, flags
            exact(v, srw_aligned_vertical_plain(*va), "srw_aligned_vertical",
                  f"the flagship's coarse image, {interp}, {what}")
            ha = fn.horizontal_args(v)
            ref = srw_aligned_horizontal_plain(*ha)
            exact(fn.horizontal(v, flags), ref, "srw_aligned_horizontal",
                  f"the flagship's coarse image, {interp}, {what}")
            exact(srw_aligned_horizontal(*ha), ref, "srw_aligned_horizontal",
                  f"the flagship's coarse image, {interp}, {what}, testing v's values")
        # one NaN and one inf in otherwise finite windows
        xc = isolated_specials(fn.crop(coarse4), 20)
        va = fn.vertical_args(xc)
        v, flags = fn.vertical(xc)
        exact(v, srw_aligned_vertical_plain(*va), "srw_aligned_vertical",
              f"the flagship's coarse image, {interp}, an isolated NaN and inf")
        ha = fn.horizontal_args(v)  # K14's own output: K15 reads its flags
        exact(fn.horizontal(v, flags), srw_aligned_horizontal_plain(*ha),
              "srw_aligned_horizontal", f"the flagship's coarse image, {interp}, on K14's "
                                        f"output of an isolated NaN and inf")
        ha = fn.horizontal_args(isolated_specials(srw_aligned_vertical_plain(
            *fn.vertical_args(fn.crop(coarse4))), 21))
        exact(srw_aligned_horizontal(*ha), srw_aligned_horizontal_plain(*ha),
              "srw_aligned_horizontal", f"the flagship's coarse image, {interp}, an isolated "
                                        f"NaN and inf in v")
        xe = coarse4.clone()
        hh, ww = xe.shape[-2:]
        xe[0, 0], xe[0, :, -1] = nan, float("inf")
        xe[1, -1], xe[1, :, 0] = -float("inf"), nan
        xe[2, hh // 2], xe[3, :, ww // 3] = float("inf"), nan
        plan = port_srw.plan_srw_aligned(coarse_gm, tgt, max_taps=24)
        for fill in (nan, -9999.0):
            fn_f = port_srw.make_srw_aligned_fn(plan, interp, fill, dev)
            va = fn_f.vertical_args(fn_f.crop(xe))
            v, flags = fn_f.vertical(fn_f.crop(xe))
            exact(v, srw_aligned_vertical_plain(*va), "srw_aligned_vertical",
                  f"NaN and +-inf rows and columns, fill {fill}, {interp}")
            ha = fn_f.horizontal_args(v)
            exact(fn_f.horizontal(v, flags), srw_aligned_horizontal_plain(*ha),
                  "srw_aligned_horizontal", f"NaN and +-inf rows and columns, fill {fill}, "
                                            f"{interp}")
    # a 96^2 UTM32N source under a 112^2 EPSG:3035 target that hangs over it
    # on every side: the aligned plan's taps pass all four source edges
    edge_src = GridMapping.regular(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0,
                                   crs="epsg:32632")
    edge_tgt = GridMapping.regular(size=(112, 112), xy_min=(4318960, 3377708), xy_res=100,
                                   crs="epsg:3035")
    plan_e = port_srw.plan_srw_aligned(edge_src, edge_tgt, max_taps=24)
    if not (plan_e.base_v.min() < 0 and plan_e.base_v.max() + plan_e.d_v > plan_e.src_h
            and plan_e.base_h.min() < 0 and plan_e.base_h.max() + plan_e.d_h > plan_e.src_w):
        raise AssertionError("the edge plan's taps do not pass every source edge")
    xs = torch.from_numpy(np.random.default_rng(17).random((3, 96, 96), dtype=np.float32)).to(dev)
    xs[0, 0], xs[0, :, -1], xs[1, -1], xs[1, :, 0] = nan, float("inf"), -float("inf"), nan
    for interp in ("bilinear", "nearest"):
        fn_e = port_srw.make_srw_aligned_fn(plan_e, interp, nan, dev)
        va = fn_e.vertical_args(xs)
        v, flags = fn_e.vertical(xs)
        exact(v, srw_aligned_vertical_plain(*va), "srw_aligned_vertical",
              f"taps past every edge, {interp}")
        ha = fn_e.horizontal_args(v)
        exact(fn_e.horizontal(v, flags), srw_aligned_horizontal_plain(*ha),
              "srw_aligned_horizontal", f"taps past every edge, {interp}")
    synth = aligned_synthetic_checks(dev, "aligned", exact)
    print(f"{tag} srw_aligned_vertical and srw_aligned_horizontal vs plain on the flagship's "
          f"coarse image (1 and {bands} bands, bilinear and nearest), with NaN and +-inf rows "
          f"and columns (fills NaN and -9999) and with one isolated NaN and inf, on a 96^2 "
          f"UTM32N -> 112^2 EPSG:3035 plan whose taps pass all four source edges, and on the "
          f"synthetic passes {', '.join(synth)} (the direct vertical kernel "
          f"{DIRECT_LAUNCHES['srw_aligned_vertical']} times): equal (sign bits included)")

    # -- F1: the aligned SRW against the tiled one (K1 + K2) -----------------
    for interp, (fn, coarse, coarse4, coarse_gm) in states.items():
        st = fn.state
        if fn.window is not None:
            raise AssertionError(f"the flagship's aligned SRW crops its source: {fn.window}")
        tiled = port_srw.make_srw_fn(
            port_srw.plan_srw(coarse_gm, tgt, fields=port_srw._coarse_geometry(coarse_gm, tgt, 16)),
            interp, nan, dev)
        a_out, t_out = fn(coarse), tiled(coarse)
        mask_share = (torch.isnan(a_out) != torch.isnan(t_out)).float().mean().item()
        if mask_share >= FLAGSHIP_MASK_SHARE:
            raise AssertionError(f"F1 {interp}: NaN masks differ on {mask_share:.3g}")
        # values on the coarse image without its NaN: the same masks
        clean = torch.nan_to_num(coarse, nan=0.5)
        a_out, t_out = fn(clean), tiled(clean)
        if not torch.equal(torch.isnan(a_out), torch.isnan(t_out)):
            raise AssertionError(f"F1 {interp}: NaN masks differ on a NaN-free image")
        both = ~torch.isnan(a_out)
        d = (a_out - t_out)[both].abs()
        rows = torch.arange(st.out_h, dtype=torch.float32, device=dev)[:, None]
        if interp == "bilinear":
            # the aligned passes round p - s (the position less its integer
            # shift) in float32; that moves a weight pair by at most the
            # rounding, and each pass's weights sum to 1 on data in [0, 1):
            # the bound is the two passes' largest roundings and 4 ulp of
            # the sums' order
            p = interp_field(st.iystar_c, rows, torch.arange(
                st.src_w, dtype=torch.float32, device=dev)[None, :], st.step)
            q = interp_field(st.ix_c, rows, torch.arange(
                st.out_w, dtype=torch.float32, device=dev)[None, :], st.step)
            rv = ((p - st.s_v[None, :].float()).double()
                  - (p.double() - st.s_v[None, :].double())).abs().max().item()
            rh = ((q - st.s_h[:, None].float()).double()
                  - (q.double() - st.s_h[:, None].double())).abs().max().item()
            limit = rv + rh + 4 * 2.0**-24
            if d.max().item() > limit:
                raise AssertionError(f"F1 bilinear: max abs diff {d.max().item():.3g} above "
                                     f"{limit:.3g}")
            line = (f"max abs diff {d.max().item():.3g} ({d.max().item() / 2**-24:.1f} ulp at "
                    f"[0.5, 1)), {int((d > 0).sum())} pixels differ, "
                    f"{int((d > 4 * 2**-24).sum())} by more than 4 ulp; limit {limit:.3g} (the "
                    f"shifted positions' rounding {rv:.3g} + {rh:.3g}, and 4 ulp)")
        else:
            rr, cc = torch.nonzero((a_out != t_out) & both, as_tuple=True)
            q = interp_field(st.ix_c, rows, torch.arange(
                st.out_w, dtype=torch.float32, device=dev)[None, :], st.step)[rr, cc]
            tie = (q - torch.floor(q) - 0.5).abs()
            p_all = interp_field(st.iystar_c, rows, torch.arange(
                st.src_w, dtype=torch.float32, device=dev)[None, :], st.step)
            sh = st.s_h[rr].float()
            for col in (torch.round(q), torch.round(q - sh) + sh):
                p = p_all[rr, col.clamp(0, st.src_w - 1).long()]
                tie = torch.minimum(tie, (p - torch.floor(p) - 0.5).abs())
            worst = tie.max().item() if len(rr) else 0.0
            if worst > FLAGSHIP_TIE:
                raise AssertionError(f"F1 nearest: a flip {worst:.3g} px from a half-pixel tie")
            line = (f"{len(rr)} of {int(both.sum())} pixels differ, each within {worst:.3g} px "
                    f"of a half-pixel tie (limit {FLAGSHIP_TIE})")
        print(f"{tag} F1 at the flagship ({interp}): aligned (K14 + K15) vs tiled (K1 + K2, "
              f"d_v={tiled.state.d_v} d_h={tiled.state.d_h}) on the coarse image: NaN masks "
              f"differ on {mask_share:.4g} of the pixels; on it without NaN: {line}")
        states[interp] = states[interp] + (tiled,)
        del a_out, t_out, clean, d

    # -- timings: K14 and K15 alone, beside K1 + K2 and K3 -------------------
    fn, coarse, coarse4, coarse_gm, tiled = states["bilinear"]
    st = fn.state
    x = fn.crop(coarse[None])
    va = fn.vertical_args(x)
    v, flags = fn.vertical(x)
    ha = fn.horizontal_args(v)
    # as the main path calls them: the state's plan, K15 on K14's flags
    timings["srw_aligned_vertical"] = h.time_pair(lambda: fn.vertical(x),
                                                  lambda: srw_aligned_vertical_plain(*va))
    timings["srw_aligned_horizontal"] = h.time_pair(lambda: fn.horizontal(v, flags),
                                                    lambda: srw_aligned_horizontal_plain(*ha))
    bounds["srw_aligned_vertical"] = aligned_vertical_bound(x, st)
    bounds["srw_aligned_horizontal"] = aligned_horizontal_bound(v, st)
    x4c = fn.crop(coarse4)
    v4, flags4 = fn.vertical(x4c)
    four = {"srw_aligned_vertical": (h.device_ms(lambda: fn.vertical(x4c)),
                                     aligned_vertical_bound(x4c, st)[0]),
            "srw_aligned_horizontal": (h.device_ms(lambda: fn.horizontal(v4, flags4)),
                                       aligned_horizontal_bound(v4, st)[0])}
    old_bounds = {"srw_aligned_vertical": aligned_vertical_bound(x, st, all_taps=True),
                  "srw_aligned_horizontal": aligned_horizontal_bound(v, st, all_taps=True)}
    # beside the parent tree's kernels (--against), in turns
    turns = {}
    if h.parent is not None:
        for what, xx, vv, ff in (("", x, v, flags), ("_4", x4c, v4, flags4)):
            pv, ph = h.parent(fn, xx)
            pv()
            turns[f"srw_aligned_vertical{what}"] = beside_parent(
                h, lambda xx=xx: fn.vertical(xx), pv)
            turns[f"srw_aligned_horizontal{what}"] = beside_parent(
                h, lambda vv=vv, ff=ff: fn.horizontal(vv, ff), ph)
        for name, (k, p) in turns.items():
            print(f"{tag} {name.replace('_4', f' ({bands} bands)')} at the {where}, bilinear, "
                  f"beside the parent's kernel in turns: device {k:.4f} ms, parent {p:.4f} ms")
    tv = tiled.vertical_args(tiled.crop(coarse[None]))
    vt, _ = srw_vertical(*tv)
    th = tiled.horizontal_args(vt)
    k3 = make_fused_reproject_fn(coarse_gm, tgt, "bilinear", nan, dev)
    k3_args = (coarse[None], k3.ix_c, k3.iy_c, k3.step, k3.out_h, k3.out_w, "bilinear", nan)
    variants = {
        "aligned_device_ms": h.device_ms(lambda: fn(coarse)),
        "tiled_device_ms": h.device_ms(lambda: tiled(coarse)),
        "k1_device_ms": h.device_ms(lambda: srw_vertical(*tv)),
        "k2_device_ms": h.device_ms(lambda: srw_horizontal(*th)),
        "k3_device_ms": h.device_ms(lambda: fused_reproject(*k3_args)),
        "aligned_device_ms_4": h.device_ms(lambda: fn(coarse4)),
        "tiled_device_ms_4": h.device_ms(lambda: tiled(coarse4)),
        "k3_device_ms_4": h.device_ms(lambda: fused_reproject(coarse4, *k3_args[1:])),
    }
    for name in FLAGSHIP_KERNELS:
        (k, p, kd), (b, by) = timings[name], bounds[name]
        print(f"{tag} {name} at the {where}, bilinear (coarse image {tuple(x.shape[-2:])} -> "
              f"{tgt.height}x{tgt.width}): kernel {k:.4f} ms (device {kd:.4f} ms), plain "
              f"{p:.3f} ms, bound {b:.4f} ms ({by}; every tap counted: "
              f"{old_bounds[name][0]:.4f} ms, {old_bounds[name][1]}); {bands} bands device "
              f"{four[name][0]:.4f} ms, bound {four[name][1]:.4f} ms")
    print(f"{tag} the flagship's SRW variants, bilinear, device ms (1 band; {bands} bands): "
          f"aligned K14 + K15 {variants['aligned_device_ms']:.4f}; "
          f"{variants['aligned_device_ms_4']:.4f}; tiled K1 + K2 {variants['tiled_device_ms']:.4f}"
          f" (K1 {variants['k1_device_ms']:.4f}, K2 {variants['k2_device_ms']:.4f}); "
          f"{variants['tiled_device_ms_4']:.4f}; K3 {variants['k3_device_ms']:.4f}; "
          f"{variants['k3_device_ms_4']:.4f}")
    variants.update({f"{name}_device_ms_4": four[name][0] for name in FLAGSHIP_KERNELS})
    variants.update({f"{name}_bound_ms_4": four[name][1] for name in FLAGSHIP_KERNELS})
    variants.update({f"{name}_bound_ms_all_taps": old_bounds[name][0]
                     for name in FLAGSHIP_KERNELS})
    for name, (k, p) in turns.items():
        variants[f"{name}_device_ms_turns"] = k
        variants[f"{name}_parent_device_ms"] = p

    # -- the 512^2 flagship: the aligned pick, seen by a spy ----------------
    small = cell["small"]
    s_src, s_tgt = flagship_gms(small, small)
    picks = []
    make_aligned = port_srw.make_srw_aligned_fn

    def spy_make_aligned(*args, **kwargs):
        picks.append("aligned")
        return make_aligned(*args, **kwargs)

    port_srw.make_srw_aligned_fn = spy_make_aligned
    port_reproject._DEVICE_FN_CACHE.clear()  # plan anew, through the spy
    try:
        xs = torch.from_numpy(np.random.default_rng(18).random((small, small),
                                                               dtype=np.float32)).to(dev)
        out, first, coarse_s, cgm_s = run(h.dataset(s_src, v=xs), "bilinear", s_tgt)
    finally:
        port_srw.make_srw_aligned_fn = make_aligned
    fn_s = device_reproject_fn(cgm_s, s_tgt, "bilinear", nan, dev)
    if picks != ["aligned"] or fn_s.kind != "aligned":
        raise AssertionError(f"the 512^2 flagship: make_srw_aligned_fn calls {picks}, kind {fn_s.kind}")
    exact(out["v"].data, fn_s.plain(coarse_s), "srw_aligned_horizontal",
          "the 512^2 flagship, end to end")
    print(f"{tag} resample_in_space flagship {small}^2 bilinear: make_srw_aligned_fn built once "
          f"(kind {fn_s.kind}), first call {first:.3f} s; vs the plain versions: equal")
    del states, x1, x4, coarse, coarse4, x, v, v4, flags, flags4, vt, xs, out
    torch.cuda.empty_cache()
    return err, timings, bounds, variants


# The fast extreme-warp mode (XRTPU_FAST_EXTREME_WARP=1): the ESW cell's
# geometry, where the whole-domain hybrid SRW plans (K17 + K18), and
# BASELINE #3, where the two-pass region mosaic runs; the mosaic's pieces
# by kind as the JAX package's planner makes them at full size (30 hybrid,
# 8 of them planned at step 4, 2 batched SRW, 2 direct gather), and its
# output's tolerance against the exact mosaic (K16) on the smooth field
# f = sin(x/40) cos(y/30) of the source's pixel indices, whose change over
# a pixel on each axis is at most HYBRID_SMOOTH_GRAD: |two-pass - K16| <=
# 3e-2 (bilinear, tests/test_srw.py:326-331), or 1.5 * GRAD (nearest: a
# pick at most one pixel plus its curvature gate's 0.5 pixel away).  Left
# out: the pixels whose
# horizontal position the JAX package's hybrid planner leaves outside their
# tap window (hybrid_tap_misses; 11 at full BASELINE #3, all in the piece
# of target rows 256-511 and columns 1024-1279, where the JAX package's
# output misses the direct bilinear by up to 0.179 and the port's equals
# it, tests/test_torch_srw_hybrid.py).
HYBRID_KERNELS = ("srw_hybrid_vertical", "srw_hybrid_horizontal")
HYBRID_B3 = dict(target=dict(size=(4096, 4096), xy_min=(2000000.0, 1000000.0), xy_res=1500.0,
                             crs="epsg:3035"),
                 pieces={"hybrid": 30, "batched": 2, "gather": 2}, step4=8)
HYBRID_SMOOTH_GRAD = 1 / 40 + 1 / 30
HYBRID_SMOOTH_ATOL = {"bilinear": 3e-2, "nearest": 1.5 * HYBRID_SMOOTH_GRAD}
# the kernels a piece of each kind launches once a call
PIECE_KERNELS = {"hybrid": HYBRID_KERNELS, "aligned": FLAGSHIP_KERNELS,
                 "tiled": ("srw_vertical", "srw_horizontal"),
                 "batched": ("srw_vertical", "srw_horizontal"), "gather": ("fused_reproject",)}


def hybrid_tap_misses(fn):
    """For a two-pass ``RegionSRWFn``: the target pixels of its hybrid pieces
    whose horizontal position (K18's) lies outside the tap window that the
    plan gives their row tile (a mask on the card), and the count of
    vertical positions (K17's) outside theirs."""
    import torch

    from xcube_resampling_tpu_torch.ops.reproject_ops import interp_field

    dev = fn.pieces[0].fn.state.ix_c.device if fn.pieces else None
    mask = torch.zeros((fn.out_h, fn.out_w), dtype=torch.bool, device=dev)
    n_v = 0
    for p in fn.pieces:
        if p.kind != "hybrid":
            continue
        st = p.fn.state
        rows = torch.arange(st.out_h, dtype=torch.float32, device=dev)[:, None]
        q = interp_field(st.ix_c, rows, torch.arange(
            st.out_w, dtype=torch.float32, device=dev)[None, :], st.step) - st.s_h[:, None].float()
        k0 = st.base_h[torch.arange(st.out_h, device=dev) // st.row_tile].float()
        mask[p.r0 : p.r1, p.c0 : p.c1] |= (q < k0) | (q > k0 + st.d_h - 1)
        pv = interp_field(st.iystar_c, rows, torch.arange(
            st.src_w, dtype=torch.float32, device=dev)[None, :], st.step) - st.s_v[None, :].float()
        k0 = st.base_v[:, torch.arange(st.src_w, device=dev) // st.col_tile].float()
        n_v += int(((pv < k0) | (pv > k0 + st.d_v - 1)).sum())
    return mask, n_v


def hybrid_phase(dev, tag, h, geo, ds, esw_cell=ESW_CELL, b3_cell=HYBRID_B3):
    """Drive the fast extreme-warp mode on *dev* (``XRTPU_FAST_EXTREME_WARP=1``
    set for the phase): ``resample_in_space`` of the global source *geo*
    (its dataset *ds*) onto (a) the ESW cell's target, where the memoised fn
    is the whole-domain hybrid SRW and each call launches K17 and K18 once
    (bilinear and nearest, 1 and 4 bands: first call, the host's planning
    re-run apart, warm calls, peak device memory), and (b) BASELINE #3's,
    where it is the two-pass region mosaic (``RegionSRWFn``, the pieces by
    kind and step held to the JAX package's planner; bilinear and nearest:
    first call, planning apart, warm calls, peak memory), held bit for bit
    to the same mosaic with every piece on its plain version and, on the
    smooth field sin(x/40) cos(y/30), to the default path's exact mosaic
    (K16) within ``HYBRID_SMOOTH_ATOL`` where both are finite (over 0.9 of
    the pixels), the pixels of ``hybrid_tap_misses`` left out; K17 and K18 bit for bit against their plain versions at
    the cell with NaN and +-inf rows and columns and a numeric fill, and on
    a plan whose taps pass all four source edges; K17, K18 and the mosaic
    timed with their bounds beside K13, K16, K3 and ``F.grid_sample`` on the
    same geometries.  *h* carries :func:`main`'s helpers.  Returns (max abs
    errors, timings, bounds, yardsticks)."""
    import torch
    import torch.nn.functional as F

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch.ops import srw as port_srw
    from xcube_resampling_tpu_torch.ops.esw import make_esw_reproject_fn
    from xcube_resampling_tpu_torch.ops.reproject_ops import interp_field, make_fused_reproject_fn
    from xcube_resampling_tpu_torch.ops.srw_aligned import DIRECT_LAUNCHES
    from xcube_resampling_tpu_torch.ops.srw_hybrid import (
        srw_hybrid_horizontal,
        srw_hybrid_horizontal_plain,
        srw_hybrid_vertical_plain,
    )
    from xcube_resampling_tpu_torch.reproject import device_reproject_fn

    nan = float("nan")
    err = dict.fromkeys(HYBRID_KERNELS, 0.0)
    timings, bounds, yard = {}, {}, {}
    geo_gm = GridMapping.from_dataset(ds)
    cell = GridMapping.regular(**esw_cell["target"])
    b3 = GridMapping.regular(**b3_cell["target"])
    mpix = cell.height * cell.width / 1e6
    mpix3 = b3.height * b3.width / 1e6
    bands = esw_cell["bands"]
    once = dict.fromkeys(HYBRID_KERNELS, 1)

    def exact(got, ref, name, what):
        err[name] = max(err[name], h.compare(got, ref, "exact", f"{what}: {name} vs plain",
                                             signs=True))

    def peak_of(call):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    def grid_sample_ms(ix_c, iy_c, step, out_h, out_w, src, interp):
        """F.grid_sample (border, corners aligned) at the full-resolution
        positions of the coarse fields: event ms and device ms."""
        rows = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
        cols = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
        ix, iy = interp_field(ix_c, rows, cols, step), interp_field(iy_c, rows, cols, step)
        hh, ww = src.shape[-2:]
        grid = torch.stack((ix / (ww - 1) * 2 - 1, iy / (hh - 1) * 2 - 1), dim=-1)[None]
        x = src.reshape(1, -1, hh, ww)

        def call():
            return F.grid_sample(x, grid, mode=interp, padding_mode="border",
                                 align_corners=True)

        return h.event_ms(call), h.device_ms(call)

    gen = torch.Generator(device=dev).manual_seed(18)
    x4 = torch.rand((bands,) + tuple(geo.shape), generator=gen, device=dev)
    ds4 = h.dataset(geo_gm, v=x4)
    os.environ["XRTPU_FAST_EXTREME_WARP"] = "1"
    try:
        # -- (a) the ESW cell's geometry: the whole-domain hybrid -------------
        where = (f"4326 {360 / geo.shape[-1]:g} deg -> EPSG:3035 {cell.height}x{cell.width} at "
                 f"{cell.xy_res[0]:g} m")
        fns = {}
        for interp in ("bilinear", "nearest"):
            out, first = h.run_main(ds, cell, interp, HYBRID_KERNELS, exact=once)
            share = h.check_output(out["v"].data, (cell.height, cell.width))
            fn = device_reproject_fn(geo_gm, cell, interp, nan, dev)
            if not isinstance(fn, port_srw.HybridSRWFn) or fn.kind != "hybrid":
                raise AssertionError(f"the ESW cell under the switch ran {type(fn).__name__}")
            exact(out["v"].data, fn.plain(geo), "srw_hybrid_horizontal",
                  f"the ESW cell under the switch, {interp}, 1 band, end to end")
            t0 = time.perf_counter()
            port_srw.make_srw_reproject_fn(geo_gm, cell, interp, nan, dev, allow_hybrid=True)
            planning = time.perf_counter() - t0
            _, warm = h.warm_calls(ds, cell, interp, HYBRID_KERNELS, 5, exact=once)
            peak = peak_of(lambda: h.run_main(ds, cell, interp, HYBRID_KERNELS, exact=once))
            out4, first4 = h.run_main(ds4, cell, interp, HYBRID_KERNELS, exact=once)
            h.check_output(out4["v"].data, (bands, cell.height, cell.width))
            exact(out4["v"].data, fn.plain(x4), "srw_hybrid_horizontal",
                  f"the ESW cell under the switch, {interp}, {bands} bands, end to end")
            _, warm4 = h.warm_calls(ds4, cell, interp, HYBRID_KERNELS, 5, exact=once)
            st = fn.state
            print(f"{tag} resample_in_space {where} {interp} under XRTPU_FAST_EXTREME_WARP=1 "
                  f"(the hybrid SRW, K17 + K18, once each a call; d_v={st.d_v} d_h={st.d_h} "
                  f"col_tile={st.col_tile} row_tile={st.row_tile}, shifts up to "
                  f"{int(st.s_v.max())} rows and {int(st.s_h.max())} columns, window "
                  f"{fn.window}): first call {first:.3f} s (the host's planning re-run alone "
                  f"{planning:.3f} s), warm median of 5 {warm * 1e3:.3f} ms = "
                  f"{mpix / warm:.1f} Mpix/s, peak device memory {peak / 2**30:.3f} GiB above "
                  f"the held; {bands} bands: first call {first4:.3f} s, warm median of 5 "
                  f"{warm4 * 1e3:.3f} ms = {bands * mpix / warm4:.1f} Mpix/s; finite share "
                  f"{share:.4f}; vs the plain versions: equal")
            fns[interp] = fn
            del out, out4

        if any(DIRECT_LAUNCHES[name] for name in HYBRID_KERNELS):
            raise AssertionError(f"the ESW cell ran the direct kernels: {dict(DIRECT_LAUNCHES)}")

        # K17 and K18 against their plain versions on hard inputs
        j0, j1, i0, i1 = fns["bilinear"].window
        xe = x4.clone()
        xe[0, j0], xe[0, :, i1 - 1] = nan, float("inf")
        xe[1, j1 - 1], xe[1, :, i0] = -float("inf"), nan
        xe[2, (j0 + j1) // 2], xe[3, :, (i0 + i1) // 2] = float("inf"), nan
        edge_src, edge_tgt = (GridMapping.regular(**g) for g in (
            dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"),
            dict(size=(112, 112), xy_min=(4318960, 3377708), xy_res=100, crs="epsg:3035")))
        plan_e = port_srw.plan_srw_hybrid(edge_src, edge_tgt)
        if not (plan_e.base_v.min() < 0 and plan_e.base_v.max() + plan_e.d_v > plan_e.src_h
                and plan_e.base_h.min() < 0 and plan_e.base_h.max() + plan_e.d_h > plan_e.src_w):
            raise AssertionError("the edge plan's taps do not pass every source edge")
        xs = torch.rand((3, 96, 96), generator=gen, device=dev)
        xs[0, 0], xs[0, :, -1], xs[1, -1], xs[1, :, 0] = nan, float("inf"), -float("inf"), nan
        for interp in ("bilinear", "nearest"):
            cases = [(port_srw.make_srw_reproject_fn(geo_gm, cell, interp, fill, dev,
                                                     allow_hybrid=True), xe, fill, "the cell")
                     for fill in (nan, -9999.0)]
            cases.append((port_srw.make_srw_hybrid_fn(plan_e, interp, nan, dev), xs, nan,
                          "taps past every edge"))
            for f, data, fill, what in cases:
                xc = f.crop(data)
                va = f.vertical_args(xc)
                v, flags = f.vertical(xc)  # as the main path: the state's plan, flags
                exact(v, srw_hybrid_vertical_plain(*va), "srw_hybrid_vertical",
                      f"{what}, NaN and +-inf rows and columns, fill {fill}, {interp}")
                ha = f.horizontal_args(v)
                ref = srw_hybrid_horizontal_plain(*ha)
                exact(f.horizontal(v, flags), ref, "srw_hybrid_horizontal",
                      f"{what}, NaN and +-inf rows and columns, fill {fill}, {interp}")
                exact(srw_hybrid_horizontal(*ha), ref, "srw_hybrid_horizontal",
                      f"{what}, NaN and +-inf rows and columns, fill {fill}, {interp}, "
                      f"testing v's values")
            # one NaN and one inf in otherwise finite windows
            f = fns[interp]
            xc = isolated_specials(f.crop(x4), 22)
            va = f.vertical_args(xc)
            v, flags = f.vertical(xc)
            exact(v, srw_hybrid_vertical_plain(*va), "srw_hybrid_vertical",
                  f"the cell, an isolated NaN and inf, {interp}")
            ha = f.horizontal_args(v)  # K17's own output: K18 reads its flags
            exact(f.horizontal(v, flags), srw_hybrid_horizontal_plain(*ha),
                  "srw_hybrid_horizontal", f"the cell, on K17's output of an isolated NaN and "
                                           f"inf, {interp}")
            ha = f.horizontal_args(isolated_specials(srw_hybrid_vertical_plain(
                *f.vertical_args(f.crop(x4))), 23))
            exact(srw_hybrid_horizontal(*ha), srw_hybrid_horizontal_plain(*ha),
                  "srw_hybrid_horizontal", f"the cell, an isolated NaN and inf in v, {interp}")
        synth = aligned_synthetic_checks(dev, "hybrid", exact)
        print(f"{tag} srw_hybrid_vertical and srw_hybrid_horizontal vs plain at the ESW cell "
              f"({bands} bands, NaN and +-inf rows and columns, fills NaN and -9999; one "
              f"isolated NaN and inf), on a 96^2 UTM32N -> 112^2 EPSG:3035 plan whose taps pass "
              f"all four source edges and on the synthetic passes {', '.join(synth)} (the "
              f"direct vertical kernel {DIRECT_LAUNCHES['srw_hybrid_vertical']} times), "
              f"bilinear and nearest: equal (sign bits included)")

        # K17 and K18 timed, with K13, K3 and F.grid_sample on the geometry
        fn = fns["bilinear"]
        st = fn.state
        x = fn.crop(geo[None])
        va = fn.vertical_args(x)
        v, flags = fn.vertical(x)
        ha = fn.horizontal_args(v)
        # as the main path calls them: the state's plan, K18 on K17's flags
        timings["srw_hybrid_vertical"] = h.time_pair(lambda: fn.vertical(x),
                                                     lambda: srw_hybrid_vertical_plain(*va))
        timings["srw_hybrid_horizontal"] = h.time_pair(lambda: fn.horizontal(v, flags),
                                                       lambda: srw_hybrid_horizontal_plain(*ha))
        bounds["srw_hybrid_vertical"] = aligned_vertical_bound(x, st)
        bounds["srw_hybrid_horizontal"] = aligned_horizontal_bound(v, st)
        x4c = fn.crop(x4)
        v4, flags4 = fn.vertical(x4c)
        yard["srw_hybrid_vertical"] = dict(
            device_ms_4=h.device_ms(lambda: fn.vertical(x4c)),
            bound_ms_4=aligned_vertical_bound(x4c, st)[0],
            bound_ms_all_taps=aligned_vertical_bound(x, st, all_taps=True)[0])
        yard["srw_hybrid_horizontal"] = dict(
            device_ms_4=h.device_ms(lambda: fn.horizontal(v4, flags4)),
            bound_ms_4=aligned_horizontal_bound(v4, st)[0],
            bound_ms_all_taps=aligned_horizontal_bound(v, st, all_taps=True)[0])
        # beside the parent tree's kernels (--against), in turns: bilinear
        # and nearest, 1 and 4 bands
        if h.parent is not None:
            for interp in ("bilinear", "nearest"):
                f = fns[interp]
                for what, data in (("", geo[None]), ("_4", x4)):
                    xx = f.crop(data)
                    vv, ff = f.vertical(xx)
                    pv, ph = h.parent(f, xx)
                    pv()
                    key = ("" if interp == "bilinear" else "_nearest") + what
                    for name, kernel, parent in (
                            ("srw_hybrid_vertical", lambda f=f, xx=xx: f.vertical(xx), pv),
                            ("srw_hybrid_horizontal",
                             lambda f=f, vv=vv, ff=ff: f.horizontal(vv, ff), ph)):
                        k, p = beside_parent(h, kernel, parent)
                        yard[name][f"device_ms_turns{key}"] = k
                        yard[name][f"parent_device_ms{key}"] = p
                        print(f"{tag} {name} at the ESW cell under the switch, {interp}, "
                              f"{bands if what else 1} band(s), beside the parent's kernel in "
                              f"turns: device {k:.4f} ms, parent {p:.4f} ms")
        k13 = make_esw_reproject_fn(geo_gm, cell, "bilinear", nan, device=dev)
        k3 = make_fused_reproject_fn(geo_gm, cell, "bilinear", nan, dev)
        lib_ms, lib_d = grid_sample_ms(k3.ix_c, k3.iy_c, k3.step, k3.out_h, k3.out_w, geo,
                                       "bilinear")
        cell_yard = dict(hybrid_device_ms=h.device_ms(lambda: fn(geo)),
                         hybrid_device_ms_4=h.device_ms(lambda: fn(x4)),
                         k13_device_ms=h.device_ms(lambda: k13(geo)),
                         k3_device_ms=h.device_ms(lambda: k3(geo)), grid_sample_ms=lib_ms,
                         grid_sample_device_ms=lib_d)
        yard["srw_hybrid_vertical"].update(cell_yard)
        for name in HYBRID_KERNELS:
            (k, p, kd), (b, by) = timings[name], bounds[name]
            print(f"{tag} {name} at the ESW cell under the switch, bilinear (window "
                  f"{tuple(x.shape[-2:])} -> {st.out_h}x{st.out_w}): kernel {k:.4f} ms (device "
                  f"{kd:.4f} ms), plain {p:.3f} ms, bound {b:.4f} ms ({by}; every tap counted, "
                  f"{yard[name]['bound_ms_all_taps']:.4f} ms); {bands} bands "
                  f"device {yard[name]['device_ms_4']:.4f} ms, bound "
                  f"{yard[name]['bound_ms_4']:.4f} ms")
        print(f"{tag} the ESW cell, bilinear, device ms: the hybrid K17 + K18 "
              f"{cell_yard['hybrid_device_ms']:.4f} ({bands} bands "
              f"{cell_yard['hybrid_device_ms_4']:.4f}); K13 {cell_yard['k13_device_ms']:.4f}; "
              f"K3 {cell_yard['k3_device_ms']:.4f}; F.grid_sample {lib_ms:.4f} ms (device "
              f"{lib_d:.4f})")
        del x, v, v4, flags, flags4, x4c, xe, fns

        # -- (b) BASELINE #3: the two-pass region mosaic ------------------------
        counts = Counter()
        for kind, n in b3_cell["pieces"].items():
            counts.update(dict.fromkeys(PIECE_KERNELS[kind], n))
        expect = tuple(counts)
        yy, xx = torch.meshgrid(torch.arange(geo.shape[-2], dtype=torch.float64, device=dev),
                                torch.arange(geo.shape[-1], dtype=torch.float64, device=dev),
                                indexing="ij")
        smooth = (torch.sin(xx / 40) * torch.cos(yy / 30)).float()
        del yy, xx
        ds_s = h.dataset(geo_gm, v=smooth)
        for interp in ("bilinear", "nearest"):
            out, first = h.run_main(ds, b3, interp, expect, exact=counts)
            share = h.check_output(out["v"].data, (b3.height, b3.width))
            fn = device_reproject_fn(geo_gm, b3, interp, nan, dev)
            if not isinstance(fn, port_srw.RegionSRWFn):
                raise AssertionError(f"BASELINE #3 under the switch ran {type(fn).__name__}")
            kinds = Counter(p.kind for p in fn.pieces)
            step4 = sum(p.step == 4 for p in fn.pieces)
            if kinds != b3_cell["pieces"] or step4 != b3_cell["step4"] or not fn.covered:
                raise AssertionError(f"BASELINE #3's two-pass pieces {dict(kinds)}, {step4} at "
                                     f"step 4, covered {fn.covered}")
            exact(out["v"].data, fn.plain(geo), "srw_hybrid_horizontal",
                  f"BASELINE #3's two-pass mosaic, {interp}, every piece")
            t0 = time.perf_counter()
            if port_srw.make_srw_reproject_fn(geo_gm, b3, interp, nan, dev,
                                              allow_hybrid=True) is not None:
                raise AssertionError("the SRW tier plans BASELINE #3 as a whole")
            refusal = time.perf_counter() - t0
            t0 = time.perf_counter()
            port_srw.make_region_reproject_fn(geo_gm, b3, interp, nan, device=dev)
            planning = time.perf_counter() - t0
            _, warm = h.warm_calls(ds, b3, interp, expect, 5, exact=counts)
            peak = peak_of(lambda: h.run_main(ds, b3, interp, expect, exact=counts))
            # the smooth field against the default path's exact mosaic (K16)
            fast, _ = h.run_main(ds_s, b3, interp, expect, exact=counts)
            os.environ["XRTPU_FAST_EXTREME_WARP"] = ""
            exact_out, _ = h.run_main(ds_s, b3, interp, ("esw_mosaic",), exact={"esw_mosaic": 1})
            k16 = device_reproject_fn(geo_gm, b3, interp, nan, dev)
            os.environ["XRTPU_FAST_EXTREME_WARP"] = "1"
            a, e = fast["v"].data, exact_out["v"].data
            both = torch.isfinite(a) & torch.isfinite(e)
            both_share = both.float().mean().item()
            misses, n_v = hybrid_tap_misses(fn)
            d = (a - e)[both & ~misses].abs()
            d_miss = (a - e)[both & misses].abs()
            d_miss = d_miss.max().item() if d_miss.numel() else 0.0
            if both_share <= 0.9 or d.max().item() > HYBRID_SMOOTH_ATOL[interp]:
                raise AssertionError(f"BASELINE #3 {interp}: the two-pass mosaic against the "
                                     f"exact one on the smooth field: both finite on "
                                     f"{both_share:.4f}, max abs diff {d.max().item():.3g} "
                                     f"(limit {HYBRID_SMOOTH_ATOL[interp]:.4g})")
            # 4 calls: some 140 device operations each, so the launch queue
            # holds them all behind the sleep (tools/tune_aligned.py --walls
            # reads 4 and 10 beside each other)
            mos_d = h.device_ms(lambda: fn(geo[None]), iters=4)
            k16_d = h.device_ms(lambda: k16(geo))
            k3 = make_fused_reproject_fn(geo_gm, b3, interp, nan, dev)
            k3_d = h.device_ms(lambda: k3(geo[None]))
            lib_ms, lib_d = grid_sample_ms(k3.ix_c, k3.iy_c, k3.step, b3.height, b3.width, geo,
                                           interp)
            print(f"{tag} resample_in_space BASELINE #3 {interp} under XRTPU_FAST_EXTREME_WARP=1 "
                  f"(the two-pass region mosaic: {kinds['hybrid']} hybrid pieces, "
                  f"{kinds['batched']} batched SRW, {kinds['gather']} K3; {step4} planned at "
                  f"step 4; {len(fn.pieces)} pieces covering the target): first call "
                  f"{first:.3f} s (the host's planning re-run alone: the mosaic's "
                  f"{planning:.3f} s, the SRW tier's refusal {refusal:.3f} s), warm median of 5 "
                  f"{warm * 1e3:.3f} ms = {mpix3 / warm:.1f} Mpix/s, peak device memory "
                  f"{peak / 2**30:.3f} GiB above the held; finite share {share:.4f}; vs every "
                  f"piece's plain version: equal; on sin(x/40) cos(y/30) against the exact "
                  f"mosaic (K16): both finite on {both_share:.4f}, max abs diff "
                  f"{d.max().item():.3g} (limit {HYBRID_SMOOTH_ATOL[interp]:.4g}), mean "
                  f"{d.double().mean().item():.3g}; left out: {int(misses.sum())} pixels "
                  f"whose horizontal position the hybrid plan leaves outside their taps (max abs "
                  f"diff there {d_miss:.3g}; {n_v} vertical positions outside theirs)")
            print(f"{tag} BASELINE #3 {interp}, device ms: the two-pass mosaic {mos_d:.4f}; "
                  f"K16 {k16_d:.4f}; K3 {k3_d:.4f}; F.grid_sample {lib_ms:.4f} ms (device "
                  f"{lib_d:.4f})")
            yard["srw_hybrid_horizontal"].update({
                f"b3_{interp}_mosaic_device_ms": mos_d, f"b3_{interp}_k16_device_ms": k16_d,
                f"b3_{interp}_k3_device_ms": k3_d, f"b3_{interp}_warm_ms": warm * 1e3,
                f"b3_{interp}_first_s": first, f"b3_{interp}_planning_s": planning})
            del out, fast, exact_out, a, e, d, both, misses, fn, k16, k3
    finally:
        del os.environ["XRTPU_FAST_EXTREME_WARP"]
    del x4, ds4, smooth, ds_s
    torch.cuda.empty_cache()
    return err, timings, bounds, yard


# The sharded rectify: R1 (BASELINE #4's 1189 x 1890 swath onto its
# 512-tiled grid, 16 float32 bands, nearest) and R3 (the 4865 x 4091
# granule onto its 1024-tiled grid, 21 float32 bands, bilinear), each over a
# mesh of 4 entries on the card; the rows of R3's band 1 that K12 is held to
# its plain version on
SR_CELLS = (("R1", 1189, 1890, 512, 16, "nearest"), ("R3", 4865, 4091, 1024, 21, "bilinear"))
SR_KERNELS = ("ij_gather_band", "hybrid_seed", "hybrid_dense")
SR_SLAB = 256


def hard_lattices():
    """K12's hard inputs at small size: (name, gx, gy, target shape) of
    swath lattices in the target's pixel units, float64: rotated and
    sheared, near-collinear slivers (column pairs 1e-12 and 1e-14 and a row
    pair 1e-9 of an edge apart: determinants that small against the edge
    products; 1e-14 is past the box's derived range), folded rows, and NaN nodes (an interior node, which is
    corner p0 of one quad and p3 of another, and the lattice's first and
    last nodes, p0 and p3 alone)."""
    jj, ii = np.mgrid[0:44, 0:52].astype(np.float64)
    a = 0.6
    rotated = (30 + 0.9 * (np.cos(a) * ii - np.sin(a) * jj),
               2 + 0.9 * (np.sin(a) * ii + np.cos(a) * jj))
    sheared = (3 + 1.1 * ii + 0.7 * jj, 2 + 0.3 * ii + 0.95 * jj)
    sliver_x, sliver_y = (c.copy() for c in sheared)
    sliver_x[:, 21] = sliver_x[:, 20] + 1e-12 * 1.1
    sliver_y[:, 21] = sliver_y[:, 20] + 1e-12 * 0.3
    sliver_x[:, 41] = sliver_x[:, 40] + 1e-14 * 1.1
    sliver_y[:, 41] = sliver_y[:, 40] + 1e-14 * 0.3
    sliver_x[31] = sliver_x[30] + 1e-9 * 0.7
    sliver_y[31] = sliver_y[30] + 1e-9 * 0.95
    fold_y = sheared[1].copy()
    fold_y[22:] = fold_y[21] - 0.8 * (fold_y[22:] - fold_y[21])
    nan_x, nan_y = (c.copy() for c in rotated)
    nan_x[17, 23] = np.nan
    nan_y[0, 0] = np.nan
    nan_x[-1, -1] = np.nan
    return [("rotated", *rotated, (60, 70)), ("sheared", *sheared, (70, 84)),
            ("slivers", sliver_x, sliver_y, (70, 84)), ("folded", sheared[0], fold_y, (70, 84)),
            ("NaN nodes", nan_x, nan_y, (60, 70))]


def hybrid_hard_inputs(dev, tag, exact):
    """Hold K12 to its plain version on :func:`hard_lattices` at every
    tile size (16, 12, 8, 4): the map, ``tested`` and ``solved`` bit for
    bit; the seed is K11's, the window its needs' bucket (or the swath's
    first 48 nodes where none covers them).  *exact* is
    :func:`sharded_rectify_phase`'s comparison."""
    import torch

    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.ops import rectify_ops as ro

    def seed(gx, gy, dst, tile, what, r0=0.0):
        """K11 on the card, held to its plain version bit for bit."""
        got = ro.hybrid_seed(gx, gy, dst, tile, float(max(dst)), 2, r0=r0)
        ref = ro.hybrid_seed_plain(gx, gy, dst, tile, float(max(dst)), 2, r0=r0)
        for a, b, part in zip(got, ref, ("cqj", "cqi", "meta")):
            exact(a, b, "hybrid_seed", f"K11 {what}, tile {tile}, r0 {r0}: {part}")
        return got

    # K11 on swaths of odd width and height, one quad row or column, 3 x 3
    for h, w in ((37, 53), (2, 41), (41, 2), (3, 3), (1001, 777)):
        jj, ii = np.mgrid[0:h, 0:w].astype(np.float64)
        gx = torch.from_numpy(3.0 + 1.1 * ii * np.cos(0.3) - 0.9 * jj * np.sin(0.3)).to(dev)
        gy = torch.from_numpy(2.0 + 1.1 * ii * np.sin(0.3) + 0.9 * jj * np.cos(0.3)
                              + 0.02 * ii * jj).to(dev)
        for tile in (16, 8, 4):
            for r0 in (0.0, 24.0):
                seed(gx, gy, (max(2 * h, 24), max(2 * w, 20)), tile, f"{h}x{w} swath", r0)
    # exactly affine, axis-aligned lattices: the seeds fall on integer quads
    # and the target's far corners lie beyond the swath's edge
    for (h, w), sp, off in (((40, 48), 1.0, 0.0), ((40, 48), 2.0, -3.0), ((33, 29), 0.5, 7.0),
                            ((64, 64), 4.0, 0.0)):
        jj, ii = np.mgrid[0:h, 0:w].astype(np.float64)
        gx, gy = (torch.from_numpy(off + sp * c).to(dev) for c in (ii, jj))
        for tile in (16, 8, 4):
            for r0 in (0.0, 24.0):
                seed(gx, gy, (int(sp * h) + 40, int(sp * w) + 40), tile,
                     f"affine {h}x{w} lattice, spacing {sp}, origin {off}", r0)
    lines = []
    for name, x, y, dst in hard_lattices():
        gx, gy = (torch.from_numpy(c).to(dev) for c in (x, y))
        for tile in (16, 12, 8, 4):
            cqj, cqi, meta = seed(gx, gy, dst, tile, f"hard input {name}")
            _, need_j, need_i = meta.tolist()
            wj = ro.hybrid_window(need_j, gx.shape[0]) or min(48, gx.shape[0])
            wi = ro.hybrid_window(need_i, gx.shape[1]) or min(48, gx.shape[1])
            args = (gx, gy, cqj, cqi, dst, UV_DELTA, tile, wj, wi, 2)
            got = [torch.empty(dst, dtype=torch.int32, device=dev) for _ in range(4)]
            what = f"K12 hard input {name}, tile {tile}, window {wj}x{wi}"
            exact(ro.hybrid_dense(*args, tested=got[0], solved=got[1]),
                  ro.hybrid_dense_plain(*args, tested=got[2], solved=got[3]), "hybrid_dense",
                  what, "f64")
            exact(got[0], got[2], "hybrid_dense", f"{what}: tested")
            exact(got[1], got[3], "hybrid_dense", f"{what}: solved")
            if tile == 16:
                lines.append(f"{name} ({x.shape[0]}x{x.shape[1]} -> {dst[1]}x{dst[0]}, gate "
                             f"{meta[0].item()}, tile 16): winner position "
                             f"{got[0].double().mean().item():.1f}, "
                             f"{got[1].double().mean().item():.2f} pairs solved a pixel")
    print(f"{tag} K11 (cqj, cqi, meta) and K12 (map, tested, solved) equal their plain "
          f"versions on the hard inputs at tiles 16, 12, 8, 4, K11 also on 37x53, 2x41, 41x2, "
          f"3x3 and 1001x777 swaths and on four exactly affine lattices (seeds on integer "
          f"quads, corners beyond the swath) at tiles 16, 8, 4 and r0 0, 24: "
          f"{'; '.join(lines)}")


def warp_solved(solved, tile=16):
    """Mean and largest of the per-warp maxima of K12's pairs solved a
    pixel, a warp 32 pixels of a tile (its 32 // *tile* rows)."""
    import torch

    r = 32 // tile
    h, w = solved.shape
    pad = torch.nn.functional.pad(solved[None].float(), (0, -w % tile, 0, -h % r))[0]
    per_warp = pad.reshape(pad.shape[0] // r, r, pad.shape[1] // tile, tile).amax(dim=(1, 3))
    return per_warp.mean().item(), per_warp.max().item()


def sharded_rectify_phase(dev, tag, h, cells=SR_CELLS, mesh_n=4):
    """Drive ``sharded_rectify`` at R1 and R3 over a mesh of *mesh_n*
    entries on *dev* (its default path: the sharded Phase A, K11 and K12 on
    every band, then K7's band form) and hold it: the sharded Phase A to
    the single-chip hybrid bit for bit, the hybrid map to K8's within 1e-9
    with equal NaN coverage, the sharded raster through K8's map to K7's
    map form bit for bit for every method, the default raster to the one
    through K8's map (NaN masks equal, fewer than 1e-3 of the pixels
    differing); each kernel against its plain version.  *h* carries
    :func:`main`'s helpers.  Returns (launches on the default path, max abs
    errors, timings, bounds and library calls at R1, R3's kernel times)."""
    import torch

    from xcube_resampling_tpu_torch import GridMapping
    from xcube_resampling_tpu_torch import rectify as port_rectify
    from xcube_resampling_tpu_torch._device import LAUNCHES
    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.ops import rectify_ops as ro
    from xcube_resampling_tpu_torch.parallel import (
        make_mesh,
        make_sharded_rectify_step,
        sharded_phase_a,
        sharded_rectify,
    )

    nan = float("nan")
    launches: Counter = Counter()
    err = dict.fromkeys(SR_KERNELS, 0.0)
    timings, bounds, r3 = {}, {}, {}
    library = dict.fromkeys(SR_KERNELS, (None, None))
    mesh = make_mesh(devices=[dev] * mesh_n)
    expect = dict.fromkeys(SR_KERNELS, mesh_n)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    def default_path(x, gm, tgt, interp):
        """One sharded_rectify call on its default path; the launch counts
        are reset just before it and read just after: K11, K12 and K7's band
        form once a band, no other kernel."""
        LAUNCHES.clear()
        out, dt = timed(lambda: sharded_rectify(x, gm, tgt, mesh, interp_method=interp))
        got = Counter(LAUNCHES)
        if dev.type == "cuda" and dict(got) != expect:
            raise AssertionError(f"sharded_rectify {interp}: launches {dict(got)}, expected "
                                 f"{expect}")
        launches.update(got)
        return out, dt

    def bitwise(a, b, what):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: {tuple(a.shape)} {a.dtype} != {tuple(b.shape)} "
                                 f"{b.dtype}")
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb) or not torch.equal(a[~na], b[~nb]):
            raise AssertionError(f"{what}: not equal bit for bit")

    def exact(got, ref, name, what, cls="exact"):
        err[name] = max(err[name], h.compare(got, ref, cls, f"{what}: {name} vs plain"))

    hybrid_hard_inputs(dev, tag, exact)
    for cell, width, height, tile_size, n_bands, interp in cells:
        ds = h.olci_swath(width, height, ("rad",), tile_size=tile_size)
        gm = GridMapping.from_dataset(ds)
        tgt = gm.to_regular(tile_size=tile_size)
        x = torch.stack([ds["rad"].data + k for k in range(n_bands)])
        del ds
        # -- the default path: first call, warm calls, peak memory ----------
        out, first = default_path(x, gm, tgt, interp)
        del out
        warm = []
        for _ in range(3):
            out, dt = default_path(x, gm, tgt, interp)
            warm.append(dt)
            del out
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out, _ = default_path(x, gm, tgt, interp)
        peak = torch.cuda.max_memory_allocated(dev)
        hyb_raster = out.full()
        del out
        # -- Phase A: sharded = single-chip hybrid; hybrid ~ K8 ----------------
        sw = torch.from_numpy(np.ascontiguousarray(np.asarray(gm.xy_coords.data),
                                                   dtype=np.float64)).to(dev)
        x1, y1, x2, y2 = tgt.xy_bbox
        x_res, y_res = tgt.xy_res
        j_up = tgt.is_j_axis_up
        dst = (tgt.height, tgt.width)
        args = (0, 0, dst, x1, y1 if j_up else y2, x_res, y_res if j_up else -y_res, UV_DELTA)
        hyb_map = ro.inverse_ij_map_hybrid(sw[0], sw[1], *args).device_map()
        bitwise(sharded_phase_a(mesh, gm, tgt).full(), hyb_map,
                f"{cell} sharded Phase A vs the single-chip hybrid")
        # its launches: K11 and K12 once a band; on the card K11's two
        # kernels and K12's
        LAUNCHES.clear()
        sharded_phase_a(mesh, gm, tgt)
        if dict(LAUNCHES) != {"hybrid_seed": mesh_n, "hybrid_dense": mesh_n}:
            raise AssertionError(f"{cell}: sharded_phase_a launched {dict(LAUNCHES)}")
        on_card = device_kernels(lambda: sharded_phase_a(mesh, gm, tgt))
        want = ("seed_pass", "seed_walk", "hybrid_dense_kernel")
        if not all(on_card[k] for k in want):
            raise AssertionError(f"{cell}: sharded_phase_a ran {dict(on_card)} on the card, "
                                 f"not {want}")
        k8 = port_rectify._inverse_ij_map_from_tiles(gm, tgt, UV_DELTA, sw)
        k8_map = k8.device_map()
        if not torch.equal(torch.isnan(hyb_map), torch.isnan(k8_map)):
            raise AssertionError(f"{cell}: the hybrid's NaN coverage differs from K8's")
        d_k8 = (hyb_map - k8_map).nan_to_num(0.0).abs().max().item()
        if d_k8 > 1e-9:
            raise AssertionError(f"{cell}: the hybrid map is {d_k8} from K8's")
        # -- Phase B through K8's map = K7's map form, every method -----------
        m32 = k8_map.float()
        valid = torch.isfinite(m32[0]) & torch.isfinite(m32[1])
        ix, iy = torch.nan_to_num(m32[0], nan=0.0), torch.nan_to_num(m32[1], nan=0.0)
        for method in METHODS:
            got = sharded_rectify(x, gm, tgt, mesh, interp_method=method, ij_map=k8).full()
            bitwise(got, ro.ij_gather(x, ix, iy, valid, method, nan),
                    f"{cell} sharded rectify through K8's map vs K7's map form, {method}")
            if method == interp:
                k8_raster = got
            del got
        # -- end to end: the hybrid's raster against K8's ----------------------
        na, nb = torch.isnan(hyb_raster), torch.isnan(k8_raster)
        if not torch.equal(na, nb):
            raise AssertionError(f"{cell}: the raster's NaN masks differ between the maps")
        share = (hyb_raster[~na] != k8_raster[~nb]).float().mean().item()
        if share >= 1e-3:
            raise AssertionError(f"{cell}: {share} of the pixels differ between the maps")
        del hyb_raster, k8_raster
        # -- K7's band form vs plain: band 0 from off < 0, the ragged last
        # band, NaN map rows ------------------------------------------------
        m_nan = k8_map.clone()
        m_nan[:, 100:103] = nan
        m_nan[:, -(-dst[0] // mesh_n) - 1] = nan
        # (the cell's own method last: its band 1 is timed)
        for method in [m for m in METHODS if m != interp] + [interp]:
            step, (pad, _) = make_sharded_rectify_step(mesh, m_nan, (gm.height, gm.width),
                                                       interp_method=method, src_batch_dims=1)
            xp = torch.nn.functional.pad(x, (0, 0, 0, pad), value=nan)
            bands, _ = step.bands(xp)
            halos = step.exchange(bands)
            for k in range(mesh_n):
                g_args = step.gather_args(bands, halos, k)
                exact(ro.ij_gather_band(*g_args), ro.ij_gather_band_plain(*g_args),
                      "ij_gather_band", f"{cell} band {k} (off {g_args[4]}), {method}")
        g_args = step.gather_args(bands, halos, 1)
        k7b = h.time_pair(lambda: ro.ij_gather_band(*g_args),
                          lambda: ro.ij_gather_band_plain(*g_args), 5)
        b7b = gather_band_bound(*g_args)
        shape7 = f"ext {tuple(g_args[0].shape)} -> {tuple(g_args[1].shape[-2:])}"
        # the F.grid_sample yardstick (corners aligned, border padding) at
        # the band map's positions in the extended band
        ext7, m7, off7 = g_args[0], g_args[1].nan_to_num(0.0), g_args[4]
        grid7 = torch.stack((m7[0].clamp(0, gm.width - 1) / (gm.width - 1) * 2 - 1,
                             (m7[1].clamp(0, gm.height - 1) - off7) / (ext7.shape[-2] - 1) * 2
                             - 1), dim=-1)[None]

        def lib7():
            return torch.nn.functional.grid_sample(ext7[None], grid7, mode=interp,
                                                   padding_mode="border", align_corners=True)

        lib7_t = (h.event_ms(lib7, 5), h.device_ms(lib7, 5))
        del step, xp, bands, halos, g_args, m_nan, ext7, m7, grid7
        # -- K11 and K12 vs plain ------------------------------------------------
        gx = (sw[0] - args[3]) / args[5]
        gy = (sw[1] - args[4]) / args[6]
        edge = float(max(dst))
        band = -(-(-(-dst[0] // mesh_n)) // 16) * 16
        # every band's seed as sharded_phase_a launches it, then the whole
        # target's at two origins
        for k in range(mesh_n):
            r0 = float(k * band)
            got = ro.hybrid_seed(gx, gy, (band, dst[1]), 16, edge, 2, r0=r0)
            ref = ro.hybrid_seed_plain(gx, gy, (band, dst[1]), 16, edge, 2, r0=r0)
            for a, b, part in zip(got, ref, ("cqj", "cqi", "meta")):
                exact(a, b, "hybrid_seed", f"{cell} band {k} (r0 {r0}) {part}")
        for r0 in (0.0, float(band)):
            got = ro.hybrid_seed(gx, gy, dst, 16, edge, 2, r0=r0)
            ref = ro.hybrid_seed_plain(gx, gy, dst, 16, edge, 2, r0=r0)
            for a, b, part in zip(got, ref, ("cqj", "cqi", "meta")):
                exact(a, b, "hybrid_seed", f"{cell} r0 {r0} {part}")
        cqj, cqi, meta = got
        _, need_j, need_i = meta.tolist()
        wj, wi = ro.hybrid_window(need_j, gm.height), ro.hybrid_window(need_i, gm.width)
        cqj, cqi, _ = ro.hybrid_seed(gx, gy, dst, 16, edge, 2)
        seed_args = (gx, gy, dst, 16, edge, 2)
        k11 = h.time_pair(lambda: ro.hybrid_seed(*seed_args),
                          lambda: ro.hybrid_seed_plain(*seed_args), 3)
        b11 = bound(gx.numel() * 16 + cqj.numel() * 8 + 12, 60 * gx.numel(), PEAK_F64)
        dense_args = (gx, gy, cqj, cqi, dst, UV_DELTA, 16, wj, wi, 2)
        tested = torch.empty(dst, dtype=torch.int32, device=dev)
        solved = torch.empty_like(tested)
        ro.hybrid_dense(*dense_args, tested=tested, solved=solved)
        per_px = tested.double().mean().item()
        solved_px = solved.double().mean().item()
        solved_warp = warp_solved(solved)
        tiles = port_rectify._phase_a_tiles(gm, tgt)
        b12 = h.phase_a_bound(sw, tiles)[:2]
        if cell == "R1":
            t_ref, s_ref = torch.empty_like(tested), torch.empty_like(tested)
            exact(ro.hybrid_dense(*dense_args),
                  ro.hybrid_dense_plain(*dense_args, tested=t_ref, solved=s_ref),
                  "hybrid_dense", f"{cell} in full", "f64")
            exact(tested, t_ref, "hybrid_dense", f"{cell} the winner's position")
            exact(solved, s_ref, "hybrid_dense", f"{cell} pairs solved a pixel")
            del t_ref, s_ref
            # the plain version (seconds a call, warm from the comparison)
            # once between two events
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            ro.hybrid_dense_plain(*dense_args)
            b.record()
            b.synchronize()
            k12 = (h.event_ms(lambda: ro.hybrid_dense(*dense_args), 3), a.elapsed_time(b),
                   h.device_ms(lambda: ro.hybrid_dense(*dense_args), 3))
        else:
            # band 1 as sharded_phase_a launches it: its origin, its seed and
            # the one window of every band's largest needs; the plain
            # version on its first SR_SLAB rows, against K12 on them and
            # against those rows of the main path's band 1
            b_dst = (band, dst[1])
            metas = torch.stack([ro.hybrid_seed(gx, gy, b_dst, 16, edge, 2, r0=float(k * band))[2]
                                 for k in range(mesh_n)]).cpu()
            bwj = ro.hybrid_window(int(metas[:, 1].max()), gm.height)
            bwi = ro.hybrid_window(int(metas[:, 2].max()), gm.width)
            b_cqj, b_cqi, _ = ro.hybrid_seed(gx, gy, b_dst, 16, edge, 2, r0=float(band))
            n_c = SR_SLAB // 16 + 1
            s_args = (gx, gy, b_cqj[:n_c].contiguous(), b_cqi[:n_c].contiguous(),
                      (SR_SLAB, dst[1]), UV_DELTA, 16, bwj, bwi, 2)
            got = [torch.empty((SR_SLAB, dst[1]), dtype=torch.int32, device=dev)
                   for _ in range(4)]
            s_ref = ro.hybrid_dense_plain(*s_args, r0=float(band), tested=got[2], solved=got[3])
            what = f"{cell} band 1's first {SR_SLAB} rows from {band}, window {bwj}x{bwi}"
            exact(ro.hybrid_dense(*s_args, r0=float(band), tested=got[0], solved=got[1]), s_ref,
                  "hybrid_dense", what, "f64")
            exact(got[0], got[2], "hybrid_dense", f"{what}: the winner's position")
            exact(got[1], got[3], "hybrid_dense", f"{what}: pairs solved a pixel")
            del got
            exact(sharded_phase_a(mesh, gm, tgt).bands[1][:, :SR_SLAB], s_ref, "hybrid_dense",
                  f"{what}, the sharded Phase A's", "f64")
            del b_cqj, b_cqi, s_args, s_ref
            # (the plain version is not timed at R3 in full: minutes a call)
            k12 = (h.event_ms(lambda: ro.hybrid_dense(*dense_args), 3), None,
                   h.device_ms(lambda: ro.hybrid_dense(*dense_args), 3))
        # -- the hybrid's Phase A beside K8's, from the swath on the card ------
        hyb_ms = statistics.median(
            timed(lambda: ro.inverse_ij_map_hybrid(sw[0], sw[1], *args))[1] for _ in range(3))
        k8_ms = statistics.median(
            timed(lambda: ro.rectify_phase_a(sw, port_rectify._phase_a_tiles(gm, tgt, sw),
                                             UV_DELTA))[1] for _ in range(3))
        k8_dev = h.device_ms(lambda: ro.rectify_phase_a(sw, tiles, UV_DELTA), 3)
        npix = dst[0] * dst[1]
        w = statistics.median(warm)
        print(
            f"{tag} sharded_rectify {cell} ({width}x{height} swath, {n_bands} float32 bands "
            f"-> {dst[1]}x{dst[0]}, {interp}) over a mesh of {mesh_n} x {dev}: first call "
            f"{first:.3f} s, warm median of 3 {w * 1e3:.2f} ms = "
            f"{n_bands * npix / w / 1e6:.1f} Mpix/s over the bands, peak device memory "
            f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
            f"{base / 2**30:.3f} GiB held before it); launches a call {expect}; the sharded "
            f"Phase A launches K11 and K12 {mesh_n} times each, its kernels on the card over "
            f"3 calls (the profiler's count) {', '.join(f'{k} {on_card[k]}' for k in want)}; "
            f"it equals the single-chip hybrid bit for bit; the hybrid map vs K8's: NaN "
            f"coverage equal, max abs diff {d_k8:.3g}; through K8's map the sharded raster "
            f"equals K7's map form bit for bit (nearest, bilinear, triangular); the default "
            f"raster vs the one through K8's map: NaN masks equal, {share:.3g} of the pixels "
            f"differ"
        )
        print(
            f"{tag} {cell} Phase A from the swath on the card, warm median of 3: "
            f"inverse_ij_map_hybrid {hyb_ms * 1e3:.2f} ms (tile 16, window {wj}x{wi}; "
            f"the winner's position in the window {per_px:.1f} (the first design's quads "
            f"tested a pixel), pairs solved a pixel {solved_px:.3f}, warp maximum "
            f"{solved_warp[0]:.2f} on average, {solved_warp[1]:.0f} at most) against K10's "
            f"tile plan then K8 "
            f"{k8_ms * 1e3:.2f} ms; device: hybrid_seed {k11[2]:.4f} + hybrid_dense "
            f"{k12[2]:.4f} ms against rectify_phase_a {k8_dev:.4f} ms"
        )
        print(f"{tag} {cell} ij_gather_band's F.grid_sample yardstick ({interp}): "
              f"{lib7_t[0]:.4f} ms (device {lib7_t[1]:.4f} ms)")
        for name, t, b, what in (
            ("ij_gather_band", k7b, b7b, shape7),
            ("hybrid_seed", k11, b11, f"{gm.height}x{gm.width} swath, tile 16"),
            ("hybrid_dense", k12, b12, f"{dst[0]}x{dst[1]}, window {wj}x{wi}"),
        ):
            plain = "not timed" if t[1] is None else f"{t[1]:.3f} ms"
            print(f"{tag} {cell} {name} ({what}): kernel {t[0]:.4f} ms (device {t[2]:.4f} "
                  f"ms), plain {plain}, bound {b[0]:.4f} ms ({b[1]})")
            if cell == "R1":
                timings[name], bounds[name] = t, b
                if name == "ij_gather_band":
                    library[name] = lib7_t
            else:
                r3[name] = dict(r3_ms=t[0], r3_device_ms=t[2], r3_plain_ms=t[1],
                                r3_bound_ms=b[0])
                if name == "ij_gather_band":
                    r3[name].update(r3_library_ms=lib7_t[0], r3_library_device_ms=lib7_t[1])
        del x, sw, gx, gy, k8, k8_map, hyb_map, m32, valid, ix, iy, tested, solved, cqj, cqi
        torch.cuda.empty_cache()
    print(f"{tag} sharded rectify kernels vs plain: max abs diff "
          f"{', '.join(f'{k} {v}' for k, v in err.items())}")
    if dev.type == "cuda":
        from xcube_resampling_tpu_torch.entry import dryrun_multichip

        _, dt = timed(lambda: dryrun_multichip(mesh_n))
        print(f"{tag} dryrun_multichip({mesh_n}) on the card ({torch.cuda.device_count()} "
              f"visible): every sharded path once at tiny shapes in {dt:.3f} s")
    return launches, err, timings, bounds, library, r3


# K19-K21, the rest of rectify's device Phase A ladder (ops/phase_a.py)
LADDER_KERNELS = ("phase_a_walk", "phase_a_tiled", "phase_a_scan")
LADDER_SOURCES = {
    "phase_a_walk": ("xcube_resampling_tpu_torch/csrc/phase_a_walk.cu",
                     "xcube_resampling_tpu/ops/rectify_ops.py:1482"),
    "phase_a_tiled": ("xcube_resampling_tpu_torch/csrc/phase_a_tiled.cu",
                      "xcube_resampling_tpu/ops/rectify_ops.py:621"),
    "phase_a_scan": ("xcube_resampling_tpu_torch/csrc/phase_a_scan.cu",
                     "xcube_resampling_tpu/ops/rectify_ops.py:303"),
}
# rectify's device tiers: the switches, the kernels each launches through
# rectify_dataset (the tiled planner's coarse solve runs on K8)
LADDER_TIERS = (
    ("hybrid", {}, ("hybrid_seed", "hybrid_dense")),
    ("walk", {"XRTPU_PHASEA_HYBRID": "0"}, ("phase_a_walk",)),
    ("tiled", {"XRTPU_PHASEA_HYBRID": "0", "XRTPU_PHASEA_WALK": "0"},
     ("phase_a_tiled", "rectify_phase_a")),
)
# (cell, swath width, height, target tile, method, warm calls)
LADDER_CELLS = (("R1", 1189, 1890, 512, "nearest", 3), ("R3", 4865, 4091, 1024, "bilinear", 2))
# R3's crop for K20's plain version: the first tiles of each class
LADDER_CROP = 3000


class environ:
    """``os.environ`` updated with *values* inside the block, restored
    after."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class ladder_refused:
    """The device tier with the ladder refusing every geometry inside the
    block: rectify's Phase A takes K10 and K8, as where JAX takes its host
    tiles (a yardstick for the tiers' walls)."""

    def __enter__(self):
        from xcube_resampling_tpu_torch.ops import phase_a

        self.module, self.orig = phase_a, phase_a.inverse_ij_map_device
        phase_a.inverse_ij_map_device = lambda *a, **k: None

    def __exit__(self, *exc):
        self.module.inverse_ij_map_device = self.orig


def ladder_bound(g, dst):
    """K19-K21's bound, one for the map the three compute: the (2, h, w)
    float64 swath *g* read once and the (2, dst_h, dst_w) float64 map
    written once; float64 operations for the triangle solves this swath
    needs, counted on the card: 30 a candidate pixel of each live quad's
    clipped rectangle (the quad-parallel rasterise's candidates: a quad
    without a NaN corner whose rectangle meets the target) and 40 a pixel
    for its winner's solve.  Returns (ms, basis, candidates)."""
    import torch

    h, w = dst
    gx, gy = g[0], g[1]

    def corners(a):
        return torch.floor(torch.stack([a[:-1, :-1], a[:-1, 1:], a[1:, :-1], a[1:, 1:]]))

    fi, fj = corners(gx), corners(gy)
    ok = ~(torch.isnan(fi).any(0) | torch.isnan(fj).any(0))
    i_lo, i_hi, j_lo, j_hi = fi.amin(0), fi.amax(0), fj.amin(0), fj.amax(0)
    live = ok & (i_hi >= 0) & (j_hi >= 0) & (i_lo < w) & (j_lo < h)
    span = ((i_hi.clamp(0, w - 1) - i_lo.clamp(0, w - 1) + 1)
            * (j_hi.clamp(0, h - 1) - j_lo.clamp(0, h - 1) + 1))
    n_cand = int(span[live].sum().item())
    del fi, fj, ok, i_lo, i_hi, j_lo, j_hi, live, span
    return bound_mixed(g.numel() * 8 + 2 * h * w * 8, 0, 30 * n_cand + 40 * h * w) + (n_cand,)


def phase_a_ladder_phase(dev, tag, h, cells=LADDER_CELLS):
    """Drive rectify's device Phase A ladder (``ops/phase_a.py``) through
    ``rectify_dataset`` at R1 (nearest) and R3 (bilinear) under each tier:
    the default (the hybrid: K11, K12), ``XRTPU_PHASEA_HYBRID=0`` (the walk:
    K19) and both switches (the tiled stencil: K20, its coarse solve on K8),
    and beside them the ladder made to refuse (K10 and K8); at R1 also the
    swath with its NaN row under the default ladder (both gates refuse: K20)
    and with a jump of 80 pixels besides (every tier refuses: K10 and K8,
    where JAX takes its host tiles), and a swath whose plan has host blocks.
    Each tier's map is held to K8's within 1e-9 with equal NaN coverage,
    K19-K21 to their plain versions bit for bit (R1 in full; R3's K19 and
    K21 in full, its K20 on the first LADDER_CROP tiles of each class), K21
    through ``inverse_ij_map_jax`` and ``_inverse_ij_map_device_scatter``.
    Phase A alone and the warm wall under each tier are timed.  *h* carries
    :func:`main`'s helpers (``run_rectify`` resets and reads the launch
    counts around each call).  Returns (max abs errors, timings, bounds and
    library calls at R1, R3's kernel times)."""
    import torch

    from xcube_resampling_tpu_torch import DataArray, GridMapping
    from xcube_resampling_tpu_torch import rectify as port_rectify
    from xcube_resampling_tpu_torch._device import LAUNCHES
    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.ops import phase_a as pa
    from xcube_resampling_tpu_torch.ops import rectify_ops as ro

    nan = float("nan")
    err = dict.fromkeys(LADDER_KERNELS, 0.0)
    timings, bounds, r3 = {}, {}, {}
    library = dict.fromkeys(LADDER_KERNELS, (None, None))
    phase_b = ("srw_vertical", "srw_horizontal", "ij_gather")

    def wall_ms(fn, n):
        """Median ms of *n* warm calls of *fn*, each synchronised."""
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    def once_ms(fn):
        """One call of *fn* between two CUDA events (a plain version)."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def exact(got, ref, name, what):
        err[name] = max(err[name], h.compare(got, ref, "exact", f"{what}: {name} vs plain"))

    def map_args(xy, tgt):
        x1, y1, x2, y2 = tgt.xy_bbox
        x_res, y_res = tgt.xy_res
        up = tgt.is_j_axis_up
        return (xy[0], xy[1], 0, 0, (tgt.height, tgt.width), x1, y1 if up else y2, x_res,
                y_res if up else -y_res, UV_DELTA)

    def normalised(sw, args):
        return torch.stack([(sw[0] - args[5]) / args[7], (sw[1] - args[6]) / args[8]])

    def tiled_crop(plan, n, band):
        """K20 and its plain version on the first *n* tiles of a class, each
        into a NaN map."""
        c = plan.cls_band if band else plan.cls_all
        sel = c["sel"][:n] if band else None
        outs = []
        for fn in (pa.phase_a_tiled, pa.phase_a_tiled_plain):
            out = torch.full((2, plan.dst_h, plan.dst_w), nan, dtype=torch.float64, device=dev)
            outs.append(fn(plan.g, sel, c["bjs"][:n], c["bis"][:n], c["win"], plan.tile,
                           plan.n_ti, UV_DELTA, out))
        return outs

    for cell, width, height, tile, interp, n_warm in cells:
        ds = h.olci_swath(width, height, ("rad",), tile_size=tile)
        gm = GridMapping.from_dataset(ds)
        tgt = gm.to_regular(tile_size=tile)
        dst = (tgt.height, tgt.width)
        xy = np.stack([np.asarray(ds["lon"].data), np.asarray(ds["lat"].data)])
        sw = torch.from_numpy(xy).to(dev)
        args = map_args(xy, tgt)
        g = normalised(sw, args)
        k8 = port_rectify._inverse_ij_map_from_tiles(gm, tgt, UV_DELTA, sw).device_map()
        # -- rectify_dataset under each tier: walls, Phase A alone, the map
        walls, alone, firsts = {}, {}, {}
        for tier, env, expect in LADDER_TIERS + (("K10 + K8", None, ("ij_bboxes",
                                                                       "rectify_phase_a")),):
            with environ(env or {}), (ladder_refused() if env is None else environ({})):
                _, firsts[tier] = h.run_rectify(ds, tgt, interp, expect, allow=phase_b)
                out, walls[tier] = h.warm_rectify(ds, tgt, interp, expect, n_warm,
                                                  allow=phase_b)
                h.check_output(out["rad"].data, dst)
                del out
                alone[tier] = wall_ms(lambda: port_rectify._inverse_ij_map(
                    gm, tgt, UV_DELTA, dev), 3 if cell == "R1" else 1)
                m = port_rectify._inverse_ij_map(gm, tgt, UV_DELTA, dev)
            if not isinstance(m, ro.DeviceIJMap):
                raise AssertionError(f"{cell} {tier}: Phase A gave a {type(m).__name__}")
            d = h.compare(m.device_map(), k8, "map", f"{cell} {tier} map vs K8's")
            print(f"{tag} {cell} rectify_dataset ({interp}, 1 band), {tier}: first call "
                  f"{firsts[tier]:.3f} s, warm median of {n_warm} {walls[tier] * 1e3:.2f} ms; "
                  f"Phase A alone (upload, plan, kernels) {alone[tier]:.2f} ms; its map vs "
                  f"K8's: NaN coverage equal, max abs diff {d:.3g}")
            del m
        # -- K19 vs plain --------------------------------------------------------
        b, by, n_cand = ladder_bound(g, dst)
        got = pa.phase_a_walk(g, dst, UV_DELTA)
        exact(got, pa.phase_a_walk_plain(g, dst, UV_DELTA), "phase_a_walk", f"{cell} in full")
        h.compare(got, k8, "map", f"{cell} K19's map vs K8's")
        del got
        if cell == "R1":
            k19 = h.time_pair(lambda: pa.phase_a_walk(g, dst, UV_DELTA),
                              lambda: pa.phase_a_walk_plain(g, dst, UV_DELTA), 3)
        else:
            k19 = (h.event_ms(lambda: pa.phase_a_walk(g, dst, UV_DELTA), 3),
                   once_ms(lambda: pa.phase_a_walk_plain(g, dst, UV_DELTA)),
                   h.device_ms(lambda: pa.phase_a_walk(g, dst, UV_DELTA), 3))
        # -- K20 vs plain: the default plan's classes ------------------------------
        plan = pa.plan_phase_a_device(*args, device=dev)
        if not isinstance(plan, pa.PhaseAPlan) or plan.cls_band is None:
            raise AssertionError(f"{cell}: the tiled planner gave {plan!r}, no band class")
        got = plan.apply()
        h.compare(got, k8, "map", f"{cell} K20's map vs K8's")
        c_all, c_band = plan.cls_all, plan.cls_band
        buf = torch.empty_like(got)
        if cell == "R1":
            exact(got, plan.plain(), "phase_a_tiled", f"{cell} in full (both classes)")
            a20 = (plan.g, None, c_all["bjs"], c_all["bis"], c_all["win"], plan.tile, plan.n_ti,
                   UV_DELTA, buf)
            k20 = (h.event_ms(lambda: pa.phase_a_tiled(*a20), 3),
                   once_ms(lambda: pa.phase_a_tiled_plain(*a20)),
                   h.device_ms(lambda: pa.phase_a_tiled(*a20), 3))
        else:
            for band in (False, True):
                exact(*tiled_crop(plan, LADDER_CROP, band), "phase_a_tiled",
                      f"{cell} the first {LADDER_CROP} tiles of the {'band' if band else 'interior'} class")
            a20 = (plan.g, None, c_all["bjs"], c_all["bis"], c_all["win"], plan.tile, plan.n_ti,
                   UV_DELTA, buf)
            k20 = (h.event_ms(lambda: pa.phase_a_tiled(*a20), 3), None,
                   h.device_ms(lambda: pa.phase_a_tiled(*a20), 3))
        a20b = (plan.g, c_band["sel"], c_band["bjs"], c_band["bis"], c_band["win"], plan.tile,
                plan.n_ti, UV_DELTA, buf)
        k20b = (h.event_ms(lambda: pa.phase_a_tiled(*a20b), 3),
                h.device_ms(lambda: pa.phase_a_tiled(*a20b), 3))
        apply_dev = h.device_ms(plan.apply, 3)
        pre = "" if cell == "R1" else "r3_"
        extra = r3.setdefault("phase_a_tiled", {})
        extra[f"{pre}band_ms"], extra[f"{pre}band_device_ms"] = k20b
        extra[f"{pre}apply_device_ms"] = apply_dev
        if h.tree is not None:
            # the parent's K20 (a thread a pixel scanning its window) on each
            # class in turns with this tree's, held to it bit for bit
            for key, a in (("", a20), ("band_", a20b)):
                a = a[:-1] + (torch.full_like(buf, nan),)
                theirs = h.tree.k20(a[:-1] + (torch.full_like(buf, nan),))
                exact(theirs(), pa.phase_a_tiled(*a), "phase_a_tiled",
                      f"{cell} the parent's K20, {key or 'interior_'}class")
                k, p = beside_parent(h, lambda a=a: pa.phase_a_tiled(*a), theirs)
                extra[f"{pre}{key}device_ms_in_turns"] = k
                extra[f"{pre}parent_{key}device_ms"] = p
                print(f"{tag} {cell} K20 {key or 'interior_'}class in turns (parent, this, this, "
                      f"parent): this {k:.4f} ms, the parent's {p:.4f} ms device")
                del a, theirs
        del got, buf
        # -- K21's path, its two entry points (their launches counted), and
        # K21 vs plain ------------------------------------------------------------
        LAUNCHES.clear()
        sc = pa._inverse_ij_map_device_scatter(*args, device=dev)
        got = pa.inverse_ij_map_jax(sw[0], sw[1], *args[2:])
        torch.cuda.synchronize()
        if sc is None or dict(LAUNCHES) != {"phase_a_scan": 2}:
            raise AssertionError(f"{cell}: the scatter tier gave {type(sc).__name__}, "
                                 f"launches {dict(LAUNCHES)}")
        h.main_launches.update(LAUNCHES)
        h.compare(torch.from_numpy(sc).to(dev), k8, "map", f"{cell} the scatter tier vs K8's")
        del sc
        exact(got, pa.phase_a_scan_plain(g, dst, 4, 4, UV_DELTA), "phase_a_scan",
              f"{cell} inverse_ij_map_jax (4 x 4 candidates) in full")
        h.compare(got, k8, "map", f"{cell} inverse_ij_map_jax vs K8's")
        del got
        if cell == "R1":
            k21 = h.time_pair(lambda: pa.phase_a_scan(g, dst, 4, 4, UV_DELTA),
                              lambda: pa.phase_a_scan_plain(g, dst, 4, 4, UV_DELTA), 3)
        else:
            k21 = (h.event_ms(lambda: pa.phase_a_scan(g, dst, 4, 4, UV_DELTA), 3),
                   once_ms(lambda: pa.phase_a_scan_plain(g, dst, 4, 4, UV_DELTA)),
                   h.device_ms(lambda: pa.phase_a_scan(g, dst, 4, 4, UV_DELTA), 3))
        print(
            f"{tag} {cell} Phase A alone, warm ({', '.join(f'{t} {v:.2f} ms' for t, v in alone.items())}); "
            f"rectify_dataset warm ({', '.join(f'{t} {v * 1e3:.2f} ms' for t, v in walls.items())}); "
            f"the tiled plan: interior window {c_all['win']} over {c_all['n_real']} tiles, band "
            f"class {c_band['n_real']} tiles at {c_band['win']}, host blocks "
            f"{0 if plan.host_blocks is None else len(plan.host_blocks[0])}; K20's band launch "
            f"{k20b[0]:.4f} ms (device {k20b[1]:.4f} ms), apply (both launches) device "
            f"{apply_dev:.4f} ms; {n_cand} candidate pixels"
        )
        for name, t in (("phase_a_walk", k19), ("phase_a_tiled", k20), ("phase_a_scan", k21)):
            plain = "not timed (a crop held to it)" if t[1] is None else f"{t[1]:.2f} ms"
            print(f"{tag} {cell} {name} ({height}x{width} swath -> {dst[0]}x{dst[1]}): kernel "
                  f"{t[0]:.4f} ms (device {t[2]:.4f} ms), plain {plain}, bound {b:.4f} ms ({by})")
            if cell == "R1":
                timings[name], bounds[name] = t, (b, by)
            else:
                r3.setdefault(name, {}).update(r3_ms=t[0], r3_device_ms=t[2], r3_plain_ms=t[1],
                                               r3_bound_ms=b)
        del plan, g, k8
        if cell != "R1":
            del ds, sw
            torch.cuda.empty_cache()
            continue
        # -- R1's swath with its NaN row (section 7's), onto R1's target: the
        # gates refuse, the default ladder takes K20 (K11 runs first and
        # refuses); Phase A through rectify's entry, whose launches are
        # counted (a NaN row inside the swath misleads the grid mapping's
        # resolution, which would pre-downscale it in rectify_dataset)
        lat = np.array(ds["lat"].data)
        lat[700] = nan
        ds_nan = ds.assign_coords({"lat": DataArray(lat, dims=("y", "x"))})
        xy_nan = np.stack([xy[0], lat])
        sw_nan = torch.from_numpy(xy_nan).to(dev)
        k8_nan = port_rectify._inverse_ij_map_from_tiles(gm, tgt, UV_DELTA, sw_nan).device_map()
        nan_gm = GridMapping.from_dataset(ds_nan)
        LAUNCHES.clear()
        m = port_rectify._inverse_ij_map(nan_gm, tgt, UV_DELTA, dev).device_map()
        torch.cuda.synchronize()
        got_launches = dict(LAUNCHES)
        # (K12 may run once ahead of K11's refusal: the hybrid's optimistic
        # dense launch on the last window of these shapes)
        if (got_launches.get("phase_a_tiled") != 2 or got_launches.get("rectify_phase_a") != 1
                or set(got_launches) - {"hybrid_seed", "hybrid_dense", "rectify_phase_a",
                                        "phase_a_tiled"}):
            raise AssertionError(f"R1 with a NaN row: the ladder launched {got_launches}")
        h.main_launches.update(got_launches)
        d = h.compare(m, k8_nan, "map", "R1 with a NaN row: the default ladder's map vs K8's")
        plan = pa.plan_phase_a_device(*map_args(xy_nan, tgt), device=dev)
        exact(plan.apply(), plan.plain(), "phase_a_tiled", "R1 with a NaN row")
        print(f"{tag} R1 with a NaN row (row 700) under the default ladder: K11 refuses, the "
              f"walk's gate refuses, K20 serves (launches {got_launches}): interior window "
              f"{plan.cls_all['win']} over {plan.cls_all['n_real']} tiles, band class "
              f"{plan.cls_band['n_real']} at {plan.cls_band['win']}, host blocks "
              f"{0 if plan.host_blocks is None else len(plan.host_blocks[0])}; map vs K8's: NaN "
              f"coverage equal, max abs diff {d:.3g}; K20 equal to its plain version")
        del m, plan, ds_nan, k8_nan
        # -- NaN edge rows (OLCI's and SLSTR's L2 swaths carry them) through
        # rectify_dataset: the default ladder takes K20; with a jump of 80
        # pixels besides (an edge past 8 tiles) every tier refuses: K10 and
        # K8, where JAX takes its host tiles
        lat = np.array(ds["lat"].data)
        lat[:2] = nan
        ds_edge = ds.assign_coords({"lat": DataArray(lat, dims=("y", "x"))})
        _, first = h.run_rectify(ds_edge, tgt, interp, ("phase_a_tiled",),
                                 allow=phase_b + ("hybrid_seed", "hybrid_dense",
                                                  "rectify_phase_a"))
        lon = np.array(ds["lon"].data)
        lon[:, 600:] += 80 * tgt.x_res
        ds_jump = ds_edge.assign_coords({"lon": DataArray(lon, dims=("y", "x"))})
        if pa.plan_phase_a_device(*map_args(np.stack([lon, lat]), tgt), device=dev) is not None:
            raise AssertionError("the tiled planner took the swath with a jump")
        _, first_j = h.run_rectify(ds_jump, tgt, interp, ("ij_bboxes", "rectify_phase_a"),
                                   allow=phase_b + ("hybrid_seed", "hybrid_dense"))
        print(f"{tag} R1 with NaN rows 0-1 through rectify_dataset: K20 serves (first call "
              f"{first:.3f} s); with a jump of 80 pixels besides every tier refuses, K10 and K8 "
              f"serve (first call {first_j:.3f} s)")
        del ds_edge, ds_jump
        # -- host blocks: NaN columns but the last, half of it finite --------------
        xy_host = xy.copy()
        xy_host[:, :, 700:-1] = nan
        xy_host[:, 600:, -1] = nan
        sw_host = torch.from_numpy(xy_host).to(dev)
        plan = pa.plan_phase_a_device(*map_args(xy_host, tgt), device=dev)
        if not isinstance(plan, pa.PhaseAPlan) or plan.host_blocks is None:
            raise AssertionError(f"the isolated column's plan has no host blocks: {plan!r}")
        got = plan.apply()
        exact(got, plan.plain(), "phase_a_tiled", "R1 with host blocks")
        d = h.compare(got, port_rectify._inverse_ij_map_from_tiles(gm, tgt, UV_DELTA, sw_host)
                      .device_map(), "map", "R1 with host blocks: K20's map vs K8's")
        print(f"{tag} R1 with NaN columns 700-1187 and half the last: {len(plan.host_blocks[0])} "
              f"host blocks (K8), band class {plan.cls_band['n_real']} at "
              f"{plan.cls_band['win']}; K20 equal to its plain version, the map vs K8's: NaN "
              f"coverage equal, max abs diff {d:.3g}")
        del plan, got, ds, sw, sw_nan, sw_host
        torch.cuda.empty_cache()
    print(f"{tag} the ladder's kernels vs plain: max abs diff "
          f"{', '.join(f'{k} {v}' for k, v in err.items())}")
    return err, timings, bounds, library, r3


# TREE's C entries of K14-K18 (--against), whose signatures this tree keeps
TREE_SIGNATURES = {
    "xrt_srw_aligned_vertical_f32": ["p"] * 5 + ["q"] * 6 + ["i", "q", "q", "i", "i", "p"],
    "xrt_srw_aligned_horizontal_f32": ["p"] * 6 + ["q"] * 7 + ["i", "q", "i", "i", "f", "p"],
}
# the parent's C entries of K13, its band form and K16 (--against): each
# takes the staged flag before the stream, as this tree's does
TREE_ESW_SIGNATURES = {
    "xrt_esw_gather_f32": ["p"] * 5 + ["q"] * 8 + ["i", "i", "i", "f"] + ["q"] * 4 + ["i", "p"],
    "xrt_esw_gather_band_f32": ["p"] * 5 + ["q"] * 8 + ["i", "i", "i", "f"] + ["q"] * 3
    + ["i", "p"],
    "xrt_esw_mosaic_f32": ["p"] * 5 + ["q"] * 7 + ["i", "i", "f", "i", "i", "i", "p"],
}
# the parent's C entries of K20 (this tree's signature) and of K2's float64
# form (the earlier design's, srw_horizontal_f64.cu: a thread an output
# pixel, the row tiles' count and no windows) (--against)
TREE_PHASE_A_SIGNATURES = {
    "xrt_phase_a_tiled": ["p", "p", "q", "q", "p", "p", "p"] + ["q"] * 6 + ["d", "p", "p"],
    "xrt_srw_horizontal_f64": ["p"] * 6 + ["q"] * 7 + ["i", "q", "q", "i", "i", "d", "q", "p"],
}


def build_tree_library(tree, out_dir, sources=("srw_aligned.cu",), signatures=None):
    """TREE's *sources* of ``csrc`` (TREE e.g. the parent unpacked with
    ``git archive``) built into a library of their own with this tree's
    nvcc flags, its C entries of *signatures* (:data:`TREE_SIGNATURES`)
    typed: (library, the ptxas log)."""
    import ctypes
    from pathlib import Path

    from xcube_resampling_tpu_torch import _build

    types = {"p": ctypes.c_void_p, "q": ctypes.c_int64, "i": ctypes.c_int,
             "f": ctypes.c_float, "d": ctypes.c_double}
    csrc = Path(tree) / "xcube_resampling_tpu_torch" / "csrc"
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"tree_{Path(sources[0]).stem}.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{csrc}", "-o", str(lib),
         *(str(csrc / f) for f in sources)], capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {', '.join(sources)} of {csrc}:\n"
                           f"{(proc.stdout + proc.stderr)[-20000:]}")
    library = ctypes.CDLL(str(lib))
    for entry, argtypes in (signatures or TREE_SIGNATURES).items():
        getattr(library, entry).argtypes = [types[a] for a in argtypes]
    return library, proc.stdout + proc.stderr


def esw_entry_call(lib, a, staged=None):
    """A closure launching a library's K13 entry on K13's wrapper arguments
    *a*, *staged* or not (None: an entry that takes no flag)."""
    import torch

    from xcube_resampling_tpu_torch.ops.reproject_ops import method_code

    src, ys, ix_c, iy_c, step, s, out_h, out_w, h_g, w_g, j_off, i_off, interp, fill = a
    batch, h, w = src.shape
    ncj, nci = ix_c.shape
    out = torch.empty((batch, out_h, out_w), dtype=torch.float32, device=src.device)
    args = [src.data_ptr(), ys.data_ptr(), ix_c.data_ptr(), iy_c.data_ptr(), out.data_ptr(),
            batch, h, w, ncj, ys.shape[1], nci, out_h, out_w, step, s, method_code(interp),
            float(fill), h_g, w_g, j_off, i_off] + ([] if staged is None else [int(staged)])

    def run():
        rc = lib.xrt_esw_gather_f32(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"K13 of a built library: CUDA error {rc}")
        return out

    return run


def esw_band_entry_call(lib, a, staged=None):
    """A closure launching a library's entry of K13's band form on its
    wrapper arguments *a*, *staged* or not (None: an entry that takes no
    flag)."""
    import torch

    from xcube_resampling_tpu_torch.ops.reproject_ops import method_code

    ext, ys, ix_c, iy_c, step, s, out_h, out_w, interp, fill, row0, off, src_h = a
    batch, h, w = ext.shape
    ncj, nci = ix_c.shape
    out = torch.empty((batch, out_h, out_w), dtype=torch.float32, device=ext.device)
    args = [ext.data_ptr(), ys.data_ptr(), ix_c.data_ptr(), iy_c.data_ptr(), out.data_ptr(),
            batch, h, w, ncj, ys.shape[1], nci, out_h, out_w, step, s, method_code(interp),
            float(fill), row0, off, src_h] + ([] if staged is None else [int(staged)])

    def run():
        rc = lib.xrt_esw_gather_band_f32(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"K13's band form of a built library: CUDA error {rc}")
        return out

    return run


def mosaic_entry_call(lib, fn, x, staged=None):
    """A closure launching a library's K16 entry for the ``ESWMosaicFn``
    *fn* on (B, H, W) *x*, *staged* or not (None: an entry that takes no
    flag); the canvas filled first."""
    import torch

    from xcube_resampling_tpu_torch.ops.reproject_ops import method_code

    batch, h, w = x.shape
    out = torch.full((batch, fn.out_h, fn.out_w), fn.fill_value, dtype=torch.float32,
                     device=x.device)
    args = [x.data_ptr(), fn.table.data_ptr(), fn.tile_start.data_ptr(), fn.fields.data_ptr(),
            out.data_ptr(), fn.table.shape[0], fn.n_tiles, batch, h, w, fn.out_h, fn.out_w,
            fn.step, method_code(fn.interp_method), fn.fill_value, 16, 128] + (
        [] if staged is None else [int(staged)])

    def run():
        rc = lib.xrt_esw_mosaic_f32(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"K16 of a built library: CUDA error {rc}")
        return out

    return run


def tree_calls(lib, fn, x):
    """(vertical, horizontal) closures calling TREE's library's C entries
    with the aligned or hybrid *fn*'s plan on its cropped source *x*; the
    horizontal pass reads the vertical pass's buffer."""
    import torch

    from xcube_resampling_tpu_torch.ops.reproject_ops import method_code

    st = fn.state
    base_v = st.base_v.reshape(st.out_h, -1)
    base_h = st.base_h.reshape(-1, st.out_w)
    col_tile = getattr(st, "col_tile", st.src_w)
    row_tile = getattr(st, "row_tile", st.out_h)
    method = method_code(fn.interp_method)
    batch = x.shape[0]
    v = torch.empty((batch, st.out_h, st.src_w), dtype=torch.float32, device=x.device)
    out = torch.empty((batch, st.out_h, st.out_w), dtype=torch.float32, device=x.device)
    ncj, ncc = st.iystar_c.shape
    nci = st.ix_c.shape[1]

    def vertical():
        rc = lib.xrt_srw_aligned_vertical_f32(
            x.data_ptr(), st.iystar_c.data_ptr(), st.s_v.data_ptr(), base_v.data_ptr(),
            v.data_ptr(), batch, st.src_h, st.src_w, st.out_h, ncj, ncc, st.step,
            base_v.shape[1], col_tile, st.d_v, method, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"TREE's vertical pass: CUDA error {rc}")
        return v

    def horizontal():
        rc = lib.xrt_srw_aligned_horizontal_f32(
            v.data_ptr(), st.ix_c.data_ptr(), st.iy_c.data_ptr(), st.s_h.data_ptr(),
            base_h.data_ptr(), out.data_ptr(), batch, st.out_h, st.src_w, st.out_w, st.src_h,
            ncj, nci, st.step, row_tile, st.d_h, method, fn.fill_value,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"TREE's horizontal pass: CUDA error {rc}")
        return out

    return vertical, horizontal


def tiled_entry_call(lib, a):
    """A closure launching a library's K20 entry on K20's wrapper arguments
    *a* (g, tiles, bjs, bis, win, tile, n_ti, uv_delta, out)."""
    import torch

    g, tiles, bjs, bis, win, tile, n_ti, uv_delta, out = a
    args = [g[0].data_ptr(), g[1].data_ptr(), g.shape[1], g.shape[2],
            None if tiles is None else tiles.data_ptr(), bjs.data_ptr(), bis.data_ptr(),
            bjs.shape[0], win, tile, n_ti, out.shape[1], out.shape[2], float(uv_delta),
            out.data_ptr()]

    def run():
        rc = lib.xrt_phase_a_tiled(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"K20 of a built library: CUDA error {rc}")
        return out

    return run


def horizontal_f64_entry_call(lib, h_args, vd=None, row0=0):
    """A closure launching the parent's entry of K2's float64 form (the
    signature of srw_horizontal_f64.cu) on K2's wrapper arguments *h_args* (v, ix_c, iy_c, step,
    base_h, row_tile, d_h, src_h, windows, method, fill), *vd* for
    triangular, at band origin *row0*, into an output of its own."""
    import torch

    from xcube_resampling_tpu_torch.ops.reproject_ops import method_code

    v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, _, interp, fill = h_args
    batch, out_h, src_w = v.shape
    ncj, nci = ix_c.shape
    out = torch.empty((batch, out_h, base_h.shape[1]), dtype=torch.float64, device=v.device)
    args = [v.data_ptr(), None if vd is None else vd.data_ptr(), ix_c.data_ptr(),
            iy_c.data_ptr(), base_h.data_ptr(), out.data_ptr(), batch, out_h, base_h.shape[1],
            src_h, src_w, ncj, nci, step, row_tile, base_h.shape[0], d_h, method_code(interp),
            float(fill), row0]

    def run():
        rc = lib.xrt_srw_horizontal_f64(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"K2's float64 form of a built library: CUDA error {rc}")
        return out

    return run


def parent_kernels(tree):
    """For ``--against TREE`` (the parent tree), its libraries built
    together: a function of (an aligned or hybrid fn, its cropped source)
    giving :func:`tree_calls` of TREE's K14-K18; TREE's K13, its band form
    and K16 (:func:`esw_entry_call`, :func:`esw_band_entry_call`,
    :func:`mosaic_entry_call`); TREE's K20 (:func:`tiled_entry_call`) and,
    where TREE has ``srw_horizontal_f64.cu``, its K2 float64 form
    (:func:`horizontal_f64_entry_call`; else None)."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    out = os.path.join("build", "chip_smoke_tree")
    csrc = Path(tree) / "xcube_resampling_tpu_torch" / "csrc"
    pa_sources = ("phase_a_tiled.cu",) + (
        ("srw_horizontal_f64.cu",) if (csrc / "srw_horizontal_f64.cu").is_file() else ())
    pa_signatures = {k: v for k, v in TREE_PHASE_A_SIGNATURES.items()
                     if k == "xrt_phase_a_tiled" or len(pa_sources) == 2}
    with ThreadPoolExecutor(3) as pool:
        aligned = pool.submit(build_tree_library, tree, out)
        esw = pool.submit(build_tree_library, tree, out, ("esw_gather.cu", "esw_mosaic.cu"),
                          TREE_ESW_SIGNATURES)
        pa = pool.submit(build_tree_library, tree, out, pa_sources, pa_signatures)
        lib, _ = aligned.result()
        esw_lib, _ = esw.result()
        pa_lib, _ = pa.result()
    return (lambda fn, x: tree_calls(lib, fn, x)), SimpleNamespace(
        k13=lambda a: esw_entry_call(esw_lib, a, True),
        k13_band=lambda a: esw_band_entry_call(esw_lib, a, True),
        k16=lambda fn, x: mosaic_entry_call(esw_lib, fn, x, True),
        k20=lambda a: tiled_entry_call(pa_lib, a),
        k2_f64=(lambda h_args, vd=None, row0=0: horizontal_f64_entry_call(
            pa_lib, h_args, vd, row0)) if len(pa_sources) == 2 else None)


# -- the dtypes phase: every new instantiation on its cells -------------------

# the dtypes of BASELINE #2's cell in the dtypes phase (Sentinel-2's uint16
# reflectances, int64, model output's float16 and bfloat16, masks as bool)
DT_B2_DTYPES = ("uint16", "int64", "float16", "bfloat16", "bool")
# the cells' sizes: the headline's (and B5's) side, BASELINE #2's side,
# R1's swath (width, height) and BASELINE #3's source (width, height) and
# target side
DT_SIZES = dict(n=20480, b2=4096, r1=(1189, 1890), geo=(7200, 3600), b3=4096)
# the sources of the kernels the dtypes phase adds to the kernels line, by
# the launch name's kernel (before the dot); the typed K3 is a source of
# its own, K2's float64 form (and its band form's) K2's kernel's float64
# instantiation
DT_SOURCES = {
    "srw_vertical": ("srw_vertical.cu", "xcube_resampling_tpu/ops/pallas_kernels.py:40"),
    "srw_horizontal": ("srw_horizontal.cu", "xcube_resampling_tpu/ops/srw.py:670"),
    "srw_horizontal_band": ("srw_horizontal.cu", "xcube_resampling_tpu/parallel/halo.py:450"),
    "srw_vertical_band": ("srw_vertical.cu", "xcube_resampling_tpu/parallel/halo.py:423"),
    "affine_gather": ("affine_gather.cu", "xcube_resampling_tpu/ops/gather.py:29"),
    "affine_gather_reduce": ("affine_gather_reduce.cu", "xcube_resampling_tpu/affine.py:212"),
    "coarsen_reduce": ("coarsen_reduce.cu", "xcube_resampling_tpu/ops/coarsen_ops.py:36"),
    "coarsen_rank": ("coarsen_rank.cu", "xcube_resampling_tpu/ops/coarsen_ops.py:95"),
    "ij_gather": ("ij_gather.cu", "xcube_resampling_tpu/ops/rectify_ops.py:2752"),
    "exact_gather": ("exact_gather.cu", "xcube_resampling_tpu/ops/rectify_ops.py:2767"),
    "fused_reproject": ("fused_reproject_typed.cu",
                        "xcube_resampling_tpu/ops/reproject_ops.py:170"),
    "fused_reproject_band": ("fused_reproject_typed.cu",
                             "xcube_resampling_tpu/parallel/halo.py:169"),
    "ij_gather_band": ("ij_gather.cu", "xcube_resampling_tpu/parallel/halo.py:923"),
}
# the typed K3 at BASELINE #3 under XRTPU_NO_EXACT_MOSAIC=1: nearest on a
# 2-byte and an 8-byte word, bilinear on float64 and bfloat16
DT_K3_CASES = (("int16", "nearest"), ("int64", "nearest"), ("float64", "bilinear"),
               ("bfloat16", "bilinear"))


def bound_mixed(n_bytes, f32_ops, f64_ops):
    """:func:`bound` for work of both float widths: the operations' time is
    the float32 ones at the float32 peak plus the float64 ones at its own."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = f32_ops / PEAK_F32 + f64_ops / PEAK_F64
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def dtypes_phase(dev, tag, h, sizes=DT_SIZES):
    """The new dtypes at full size, each instantiation held to its plain
    version on the card (bit for bit; K5's float statistics within TOL's
    "stat", float64 sums of K1 and K2 within one float64 ulp, the plain
    version's emulated fused multiply-add), its launches counted on the
    main path's calls (the counts reset just before each call and read
    just after; a launch under ``name.dtype``, ``_device.launch_name``):

    * the headline, 20480^2 UTM32N 30 m -> EPSG:3035 bilinear, the tiled
      SRW: one uint16 band (Sentinel-2 L2A reflectance), K1 reading it in
      place, then K2 on float32; one float64 band, K1 and K2's float64
      path; K1 and K2 timed beside their bounds;
    * BASELINE #2's 4-band 4096^2 in uint16, int64, float16, bfloat16 and
      bool: ``coarsen`` 4x (mean, first: K5; mode: K6), the affine route's
      exact 4x downscale (mean and first: the downscale form, the direct
      kernel for the new dtypes; mode: K4 then K6) and a 2x bilinear
      upscale (K4), each timed;
    * R1 (the 1189 x 1890 OLCI-like swath, 16 float32 bands) with a uint32
      quality-flags band and a uint64 band, nearest, fill 0: the device
      tier (K10, K8, K7 on the flags) and numpy flags under the host tier
      (K8, K9's ij_map mode);
      and, over 4 mesh entries on the card, ``sharded_rectify`` of the
      uint32 flags (K7's band form; every method on every band);
    * BASELINE #3's exact region mosaic (K16 on the float32 cast, its
      gather pieces through K3 on int16) and the ESW cell (K13 on the
      float32 cast) on one int16 band each, with the cast's cost; the
      typed K3 there under ``XRTPU_NO_EXACT_MOSAIC=1`` (DT_K3_CASES), and
      ``sharded_reproject`` of the int16 band over 4 mesh entries (K3's
      band form; every method on every band);
    * B5's sharded SRW step on one uint16 band over 4 mesh entries on the
      card, at B5's 20480^2 (K1's band form reading uint16 in place).

    Returns the launches, errors, timings (ms, plain ms, device ms),
    bounds, library calls and further figures (K1 on uint16 beside the
    float32 cast followed by the float32 K1) of each new instantiation, by
    launch name."""
    import torch

    from xcube_resampling_tpu_torch import DataArray, Dataset, GridMapping, parallel
    from xcube_resampling_tpu_torch import rectify as port_rectify
    from xcube_resampling_tpu_torch import resample_in_space
    from xcube_resampling_tpu_torch._device import LAUNCHES, as_float32
    from xcube_resampling_tpu_torch.affine import _scale_split
    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.ops import exact_gather, rectify_ops
    from xcube_resampling_tpu_torch.ops.coarsen_ops import coarsen, coarsen_plain
    from xcube_resampling_tpu_torch.ops.esw_mosaic import ESWMosaicFn
    from xcube_resampling_tpu_torch.parallel.halo import crop_source
    from xcube_resampling_tpu_torch.ops.gather import (
        affine_gather,
        affine_gather_plain,
        affine_gather_reduce,
        affine_gather_reduce_plain,
    )
    from xcube_resampling_tpu_torch.ops.srw import SRWFn
    from xcube_resampling_tpu_torch.ops.reproject_ops import (
        FusedReprojectFn,
        fused_reproject,
        fused_reproject_band,
        fused_reproject_band_plain,
        fused_reproject_plain,
        gather_dtype,
    )
    from xcube_resampling_tpu_torch.ops.srw_kernels import (
        plan_band_launch,
        srw_horizontal,
        srw_horizontal_band,
        srw_horizontal_band_plain,
        srw_horizontal_plain,
        srw_vertical,
        srw_vertical_band,
        srw_vertical_band_plain,
        srw_vertical_plain,
    )
    from xcube_resampling_tpu_torch.parallel.tiling import pad_rows
    from xcube_resampling_tpu_torch.reproject import device_reproject_fn
    from xcube_resampling_tpu_torch.utils import _default_fill_value

    nan = float("nan")
    launches: Counter = Counter()
    err, timings, bounds, library, extra = {}, {}, {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(22)
    mesh = parallel.make_mesh(devices=[dev] * 4)

    def run(call, expect):
        """One main-path call with the launch counts reset before it and
        read after it; each kernel of *expect* must have launched."""
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = Counter(LAUNCHES)
        launches.update(got)
        missing = [k for k in expect if got[k] < 1]
        if missing:
            raise AssertionError(f"{missing} not launched: {dict(got)}")
        return out, dt, got

    def held(name, got, ref, kind, what):
        d = h.compare(got, ref, kind, what)
        err[name] = max(err.get(name, 0.0), d)
        return d

    def once_ms(fn):
        """One call of *fn* between two CUDA events (the plain versions at
        these sizes take up to seconds: called once, after the comparison
        that warmed them)."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def timed(name, kernel, plain, bnd, lib=None):
        """The kernel's event_ms and device_ms (10 calls each), the plain
        version's once_ms, the bound, and a library call's ms where given."""
        timings[name] = (h.event_ms(kernel), once_ms(plain), h.device_ms(kernel))
        bounds[name] = bnd
        library[name] = (None, None) if lib is None else (h.event_ms(lib), h.device_ms(lib))
        k, p, kd = timings[name]
        print(f"{tag} dtypes: {name}: {k:.4f} ms (device {kd:.4f} ms), plain {p:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}); vs plain max abs diff {err.get(name, 0.0)}")

    def rand(dtype, shape, hi=10000):
        if dtype == torch.bool:
            return torch.rand(shape, generator=gen, device=dev) < 0.4
        if dtype.is_floating_point:
            x = torch.randint(-400, 400, shape, generator=gen, device=dev) / 4.0
            return x.to(dtype)
        return torch.randint(0, hi, shape, generator=gen, device=dev).to(dtype)

    # -- the headline's geometry: uint16 and float64 through the tiled SRW --
    n = sizes["n"]
    res = 30.0 * 20480 / n
    utm_gm = GridMapping.regular(size=(n, n), xy_min=(300000.0, 5200000.0), xy_res=res,
                                 crs="epsg:32632")
    laea_gm = GridMapping.regular(size=(n, n), xy_min=(4050000.0, 2650000.0), xy_res=res,
                                  crs="epsg:3035")
    for dtype, expect in ((torch.uint16, ("srw_vertical.uint16", "srw_horizontal")),
                          (torch.float64, ("srw_vertical.float64", "srw_horizontal.float64"))):
        name = str(dtype).removeprefix("torch.")
        src = rand(dtype, (n, n))
        if dtype == torch.float64:
            src[n // 3] = nan  # a NaN row: the taps that read it give NaN
        ds = h.dataset(utm_gm, v=src)
        out, first, got = run(
            lambda ds=ds: resample_in_space(ds, target_gm=laea_gm, interp_methods="bilinear"),
            expect)
        vt = torch.float64 if dtype == torch.float64 else torch.float32
        share = h.check_output(out["v"].data, (n, n), vt)
        warm = [run(lambda ds=ds: resample_in_space(ds, target_gm=laea_gm,
                                                    interp_methods="bilinear"), expect)[1]
                for _ in range(3)]
        # the main path's plan: its fill the dtype's default (uint16 65535)
        fn = device_reproject_fn(GridMapping.from_dataset(ds), laea_gm, "bilinear",
                                 _default_fill_value(dtype), dev)
        if not isinstance(fn, SRWFn) or fn.kind != "tiled":
            raise AssertionError(f"the {name} headline ran {type(fn).__name__}, not tiled")
        st = fn.state
        x = fn.crop(src)
        if x.dtype != dtype or x.data_ptr() != src.data_ptr():
            raise AssertionError(f"the {name} source was copied before K1: {x.dtype}")
        kind = "f64" if dtype == torch.float64 else "exact"
        v_args = fn.vertical_args(x)
        v, _ = srw_vertical(*v_args)
        k1 = f"srw_vertical.{name}"
        held(k1, v, srw_vertical_plain(*v_args)[0], kind, f"{n}^2 {k1} vs plain")
        h_args = fn.horizontal_args(v)
        k2 = "srw_horizontal.float64" if dtype == torch.float64 else "srw_horizontal"
        d2 = held(k2, srw_horizontal(*h_args), srw_horizontal_plain(*h_args), kind,
                  f"{n}^2 {k2} vs plain")
        # the main path's output is K1 then K2 on its source, bit for bit
        d = held(k1, out["v"].data, srw_horizontal(*h_args)[0], "exact",
                 f"{n}^2 {name} resample_in_space vs K1->K2")
        outs = st.out_h * st.src_w
        taps = outs * st.d_v
        f64 = dtype == torch.float64
        timed(k1, lambda: srw_vertical(*v_args), lambda: srw_vertical_plain(*v_args),
              bound_mixed(src.numel() * src.element_size() + 4 * (st.iystar_c.numel()
                          + st.base_v.numel()) + outs * v.element_size(),
                          taps * 4 + 12 * outs + (0 if f64 else 2 * taps), 2 * taps if f64 else 0))
        if dtype == torch.uint16:
            # the alternative to reading uint16 in place: the float32 cast,
            # then the float32 K1 (timed together; the difference reported)
            def cast_k1():
                return srw_vertical(*fn.vertical_args(as_float32(x)))
            d_cast = int((cast_k1()[0].view(torch.int32) != v.view(torch.int32)).sum())
            extra[k1] = dict(cast_then_f32_ms=h.event_ms(cast_k1),
                             cast_then_f32_device_ms=h.device_ms(cast_k1),
                             cast_then_f32_words_differ=d_cast)
            print(f"{tag} dtypes: {n}^2 the float32 cast then the float32 K1: "
                  f"{extra[k1]['cast_then_f32_ms']:.4f} ms (device "
                  f"{extra[k1]['cast_then_f32_device_ms']:.4f} ms); {d_cast} float32 words "
                  f"differ from {k1}'s")
        if f64:
            n_out = st.out_h * st.out_w

            def k2_bound(n_v):
                return bound_mixed(8 * (n_v + n_out) + 4 * (2 * st.ix_c.numel()
                                   + st.base_h.numel()), n_out * (4 * st.d_h + 40),
                                   2 * n_out * st.d_h * (n_v // v.numel()))

            timed(k2, lambda: srw_horizontal(*h_args), lambda: srw_horizontal_plain(*h_args),
                  k2_bound(v.numel()))
            # triangular on the same source (v and vd from its vertical pass),
            # held to its plain version; with --against, the parent's K2
            # float64 form in turns with this one, bilinear and triangular
            fn_t = device_reproject_fn(GridMapping.from_dataset(ds), laea_gm, "triangular",
                                       _default_fill_value(dtype), dev)
            v_t, vd_t = srw_vertical(*fn_t.vertical_args(fn_t.crop(src)))
            t_args = fn_t.horizontal_args(v_t)
            held(k2, srw_horizontal(*t_args, vd_t), srw_horizontal_plain(*t_args, vd_t), kind,
                 f"{n}^2 {k2} triangular vs plain")
            extra[k2] = dict(triangular_device_ms=h.device_ms(lambda: srw_horizontal(
                *t_args, vd_t)), triangular_bound_ms=k2_bound(2 * v_t.numel())[0])
            if h.tree is not None and h.tree.k2_f64 is not None:
                for key, a, vd_a in (("", h_args, None), ("triangular_", t_args, vd_t)):
                    theirs = h.tree.k2_f64(a, vd_a)
                    held(k2, theirs(), srw_horizontal(*a, vd_a), kind,
                         f"{n}^2 the parent's {k2} {key or 'bilinear '}vs this")
                    k, p = beside_parent(h, lambda a=a, vd_a=vd_a: srw_horizontal(*a, vd_a),
                                         theirs)
                    extra[k2][f"{key}device_ms_in_turns"] = k
                    extra[k2][f"parent_{key}device_ms"] = p
                    del theirs
            print(f"{tag} dtypes: {n}^2 {k2}: triangular device "
                  f"{extra[k2]['triangular_device_ms']:.4f} ms (bound "
                  f"{extra[k2]['triangular_bound_ms']:.4f} ms); in turns with the parent's "
                  f"(parent, this, this, parent): " + ", ".join(
                      f"{k} {v_:.4f} ms" for k, v_ in extra[k2].items() if "turns" in k
                      or k.startswith("parent_")))
            del fn_t, v_t, vd_t, t_args
        print(f"{tag} dtypes: resample_in_space {n}^2 {name} bilinear (tiled SRW, {vt} out): "
              f"first call {first:.3f} s, warm median of 3 {statistics.median(warm) * 1e3:.2f} ms; "
              f"launches {dict(got)}; finite share {share:.4f}; vs plain max abs diff {d} "
              f"(K2 {d2})")
        del out, ds, src, x, v, v_args, h_args, fn
        torch.cuda.empty_cache()

    # -- BASELINE #2: coarsen, the affine downscale, a 2x upscale -------------
    m = sizes["b2"]
    b2_gm = GridMapping.regular(size=(m, m), xy_min=(300000.0, 5200000.0), xy_res=30.0,
                                crs="epsg:32632")
    b2_tgt = GridMapping.regular(size=(m // 4, m // 4), xy_min=(300000.0, 5200000.0),
                                 xy_res=120.0, crs="epsg:32632")
    b2_up = GridMapping.regular(size=(2 * m, 2 * m), xy_min=(300000.0, 5200000.0), xy_res=15.0,
                                crs="epsg:32632")
    (j_div, i_div), residual = _scale_split(b2_tgt.ij_transform_to(b2_gm))
    (i_s, _, i_o), (_, j_s, j_o) = residual
    (ui_s, _, ui_o), (_, uj_s, uj_o) = b2_up.ij_transform_to(b2_gm)
    for name in DT_B2_DTYPES:
        dtype = getattr(torch, name)
        suffix = "" if dtype == torch.uint16 else f".{name}"
        a, b, c = rand(dtype, (4, m, m)), rand(dtype, (4, m, m)), rand(dtype, (4, m, m), hi=16)
        if dtype.is_floating_point:
            a[0, 1000:1003] = nan
            a[1, 64:72, 128:160] = nan
            b[2, m // 2] = nan
        ops = {"coarsen_reduce" + suffix, "coarsen_rank" + suffix}
        out, dt, got = run(lambda: {agg: coarsen(x, 4, 4, agg) for agg, x in
                                    (("mean", a), ("first", b), ("mode", c))}, ops)
        stat = "stat" if dtype.is_floating_point else "exact"
        for agg, x, kind in (("mean", a, stat), ("first", b, "exact"), ("mode", c, "exact")):
            k = ("coarsen_rank" if agg == "mode" else "coarsen_reduce") + suffix
            held(k, out[agg], coarsen_plain(x, 4, 4, agg), kind, f"B2 {name} coarsen {agg}")
        ds = h.dataset(b2_gm, a=a, b=b, c=c)
        aggs = {"a": "mean", "b": "first", "c": "mode"}
        expect = ("affine_gather_reduce" + suffix, "affine_gather" + suffix,
                  "coarsen_rank" + suffix)
        out, first, got = run(lambda ds=ds: resample_in_space(
            ds, target_gm=b2_tgt, interp_methods=1, agg_methods=aggs), expect)
        for var, x in (("a", a), ("b", b), ("c", c)):
            h.check_output(out[var].data, (4, m // 4, m // 4), dtype)
            agg = aggs[var]
            up = affine_gather_plain(x, j_s, i_s, j_o, i_o, m // 4 * j_div, m // 4 * i_div, 1,
                                     _default_fill_value(dtype))
            ref = coarsen_plain(up, j_div, i_div, agg)
            k = ("coarsen_rank" if agg == "mode" else "affine_gather_reduce") + suffix
            held(k, out[var].data, ref, stat if agg == "mean" else "exact",
                 f"B2 {name} affine {var} ({agg}) vs plain")
        up_out, up_first, up_got = run(lambda ds=ds: resample_in_space(
            ds, target_gm=b2_up, interp_methods=1), ("affine_gather" + suffix,))
        fill = _default_fill_value(dtype)
        up_args = (a, uj_s, ui_s, uj_o, ui_o, 2 * m, 2 * m, 1, fill)
        held("affine_gather" + suffix, up_out["a"].data, affine_gather_plain(*up_args),
             "exact", f"B2 {name} 2x upscale vs plain")
        print(f"{tag} dtypes: BASELINE #2 {name}: coarsen 4x (mean, first, mode) {dt * 1e3:.2f} "
              f"ms; affine 4x downscale first call {first * 1e3:.2f} ms ({dict(got)}); 2x "
              f"bilinear upscale first call {up_first * 1e3:.2f} ms ({dict(up_got)})")
        if not suffix:  # uint16's instantiations predate the phase: held, not timed
            continue
        isz = a.element_size()
        n_in = a.numel()
        red_args = (a, j_s, i_s, j_o, i_o, m // 4, m // 4, j_div, i_div, "mean", fill)
        timed("affine_gather_reduce" + suffix, lambda: affine_gather_reduce(*red_args),
              lambda: affine_gather_reduce_plain(*red_args),
              bound(n_in * isz + n_in // 16 * isz, 20 * n_in, PEAK_F64))
        timed("affine_gather" + suffix, lambda: affine_gather(*up_args),
              lambda: affine_gather_plain(*up_args),
              bound(n_in * isz + 4 * n_in * isz, 20 * 4 * n_in, PEAK_F64))
        timed("coarsen_reduce" + suffix, lambda: coarsen(a, 4, 4, "mean"),
              lambda: coarsen_plain(a, 4, 4, "mean"), reduce_bound(a, 4, 4, "mean", isz))
        timed("coarsen_rank" + suffix, lambda: coarsen(c, 4, 4, "mode"),
              lambda: coarsen_plain(c, 4, 4, "mode"), rank_bound(c, 4, 4))
        del out, up_out, ds, a, b, c, up, up_args
        torch.cuda.empty_cache()

    # -- R1 with a uint32 quality-flags band and a uint64 band, nearest -------
    ds_r1 = h.olci_swath(*sizes["r1"], tuple(f"rad{k}" for k in range(16)))
    r1_gm = GridMapping.from_dataset(ds_r1)
    r1_tgt = r1_gm.to_regular(tile_size=512)
    rad = ds_r1["rad0"].data
    chunks = ds_r1["rad0"].chunks
    flags_np = (rad.cpu().numpy() * 1000).astype(np.int64)
    flags = {"flags": flags_np.astype(np.uint32), "wqsf": (flags_np << 32).astype(np.uint64)}
    for k, v in flags.items():
        ds_r1[k] = DataArray(torch.from_numpy(v).to(dev), dims=("y", "x"), chunks=chunks)
    fills = dict(fill_values={"flags": 0, "wqsf": 0, torch.float32: nan})
    # (the device tier: JAX's ladder takes the hybrid, K11 and K12)
    expect = ("ij_gather.uint32", "ij_gather.uint64", "hybrid_seed", "hybrid_dense")
    out, first, got = run(lambda: resample_in_space(ds_r1, target_gm=r1_tgt,
                                                    interp_methods="nearest", **fills), expect)
    r1_sw = torch.from_numpy(np.stack([np.asarray(ds_r1["lon"].data),
                                       np.asarray(ds_r1["lat"].data)])).to(dev)
    r1_map = rectify_ops.rectify_phase_a(
        r1_sw, port_rectify._phase_a_tiles(r1_gm, r1_tgt, r1_sw), UV_DELTA)
    fn = rectify_ops.make_device_var_image_fn(
        port_rectify._inverse_ij_map(r1_gm, r1_tgt, UV_DELTA, dev).device_map(), rad.shape, 0,
        "nearest", device=dev)
    for k, kern in (("flags", "ij_gather.uint32"), ("wqsf", "ij_gather.uint64")):
        src = ds_r1[k].data[None]
        h.check_output(out[k].data, (r1_tgt.height, r1_tgt.width), src.dtype)
        held(kern, out[k].data[None], fn.plain(src), "exact", f"R1 {k} vs plain K7")
        k7_args = (src, fn.ix, fn.iy, fn.valid, "nearest", 0)
        timed(kern, lambda a=k7_args: rectify_ops.ij_gather(*a),
              lambda a=k7_args: rectify_ops.ij_gather_plain(*a),
              bound(src.numel() * src.element_size() + fn.ix.numel() * (9 + src.element_size()),
                    30 * fn.ix.numel()))
    print(f"{tag} dtypes: R1 16 float32 bands + uint32 flags + uint64 WQSF, nearest, device "
          f"tier: first call {first:.3f} s ({dict(got)})")
    del out
    # the numpy flags under the host tier: K8, then K9's ij_map mode
    ds_np = Dataset({k: DataArray(v, dims=("y", "x"), chunks=chunks) for k, v in flags.items()},
                    coords={k: ds_r1[k] for k in ("lon", "lat")})
    os.environ["XRTPU_PHASEA"] = "host"
    try:
        out, first, got = run(lambda: resample_in_space(
            ds_np, target_gm=r1_tgt, interp_methods="nearest", device=dev, **fills),
            ("exact_gather.uint32", "exact_gather.uint64"))
    finally:
        os.environ.pop("XRTPU_PHASEA", None)
    ij = r1_map.double()
    for k, kern in (("flags", "exact_gather.uint32"), ("wqsf", "exact_gather.uint64")):
        src = torch.from_numpy(flags[k])[None].to(dev)
        held(kern, out[k].data[None], exact_gather.exact_gather_ij_plain(src, ij, 0, "nearest"),
             "exact", f"R1 numpy {k} vs plain K9")
        timed(kern, lambda s=src: exact_gather.exact_gather_ij(s, ij, 0, "nearest"),
              lambda s=src: exact_gather.exact_gather_ij_plain(s, ij, 0, "nearest"),
              bound(src.numel() * src.element_size() + ij.numel() * 8
                    + ij[0].numel() * src.element_size(), 20 * ij[0].numel(), PEAK_F64))
    print(f"{tag} dtypes: R1 numpy uint32 and uint64 under the host tier: first call "
          f"{first:.3f} s ({dict(got)})")
    # the uint32 flags through sharded_rectify over 4 mesh entries on the
    # card (K7's band form), then every method on every band of the step
    # over the device tier's map, each held to the plain version
    flags_t = ds_r1["flags"].data
    kb = "ij_gather_band.uint32"
    out_s, first, got = run(lambda: parallel.sharded_rectify(
        flags_t, r1_gm, r1_tgt, mesh, interp_method="nearest", fill_value=0), (kb,))
    h.check_output(out_s.full(), (r1_tgt.height, r1_tgt.width), torch.uint32)
    for method in [m for m in METHODS if m != "nearest"] + ["nearest"]:
        step, (pad, _) = parallel.make_sharded_rectify_step(
            mesh, r1_map, (r1_gm.height, r1_gm.width), interp_method=method, fill_value=0)
        bands, _ = step.bands(pad_rows(flags_t, pad, 0))
        halos = step.exchange(bands)
        for k in range(mesh.size):
            g7 = step.gather_args(bands, halos, k)
            held(kb, rectify_ops.ij_gather_band(*g7), rectify_ops.ij_gather_band_plain(*g7),
                 "exact", f"R1 uint32 band {k} (off {g7[4]}), {method}")
    g7 = step.gather_args(bands, halos, 1)
    timed(kb, lambda: rectify_ops.ij_gather_band(*g7),
          lambda: rectify_ops.ij_gather_band_plain(*g7), gather_band_bound(*g7))
    print(f"{tag} dtypes: R1 uint32 flags through sharded_rectify over {mesh.size} mesh "
          f"entries on one card, nearest: first call {first:.3f} s ({dict(got)}); K7's band "
          f"form held on every band, every method")
    del out_s, step, bands, halos, g7
    del out, ds_r1, ds_np, fn, r1_map, r1_sw, ij
    torch.cuda.empty_cache()

    # -- int16 through the exact region mosaic (BASELINE #3) and the ESW cell -
    gw, gh = sizes["geo"]
    geo_gm = GridMapping.regular(size=(gw, gh), xy_min=(-180.0, -90.0), xy_res=360.0 / gw,
                                 crs="epsg:4326")
    geo = rand(torch.int16, (gh, gw), hi=3000)
    t3 = sizes["b3"]
    ds = h.dataset(geo_gm, v=geo)
    cast_ms = (h.event_ms(lambda: as_float32(geo)), h.device_ms(lambda: as_float32(geo)))
    b3_tgt = GridMapping.regular(size=(t3, t3), xy_min=(2000000.0, 1000000.0),
                                 xy_res=1500.0 * 4096 / t3, crs="epsg:3035")
    for what, tgt, expect in (
        ("BASELINE #3", b3_tgt, ("esw_mosaic", "fused_reproject.int16")),
        ("the ESW cell", GridMapping.regular(**dict(
            ESW_CELL["target"], size=(t3, t3), xy_res=937.5 * 4096 / t3)), ("esw_gather",)),
    ):
        out, first, got = run(lambda t=tgt: resample_in_space(ds, target_gm=t,
                                                              interp_methods="bilinear"), expect)
        warm = statistics.median(run(lambda t=tgt: resample_in_space(
            ds, target_gm=t, interp_methods="bilinear"), expect)[1] for _ in range(3))
        h.check_output(out["v"].data, (t3, t3), torch.float32)
        fn = device_reproject_fn(GridMapping.from_dataset(ds), tgt, "bilinear",
                                 _default_fill_value(torch.int16), dev)
        d = h.compare(out["v"].data, fn.plain(geo), "exact", f"{what} int16 vs plain")
        for k in expect:
            err[k] = max(err.get(k, 0.0), d)
        pieces = ""
        if isinstance(fn, ESWMosaicFn):
            pieces = f"; {len(fn.gathers)} gather pieces through K3 on int16"
            r0, c0, hh, ww, ix_c, iy_c = fn.gathers[0]
            k3 = (geo[None], ix_c, iy_c, fn.step, hh, ww, "bilinear", fn.fill_value)
            # the bound: the piece's output written once (its tapped pixels
            # lie in a window of the source, not counted)
            timed("fused_reproject.int16", lambda: fused_reproject(*k3),
                  lambda: fused_reproject_plain(*k3), bound(4 * hh * ww, 30 * hh * ww))
        print(f"{tag} dtypes: {what} int16 bilinear ({type(fn).__name__}, float32 out): first "
              f"call {first:.3f} s, warm median of 3 {warm * 1e3:.3f} ms ({dict(got)}){pieces}; "
              f"vs plain max abs diff {d}; the float32 cast of the {gh}x{gw} source "
              f"{cast_ms[0]:.4f} ms (device {cast_ms[1]:.4f} ms)")
        del out, fn
    # the typed K3 on the whole of BASELINE #3 under XRTPU_NO_EXACT_MOSAIC=1
    os.environ["XRTPU_NO_EXACT_MOSAIC"] = "1"
    try:
        for name, interp in DT_K3_CASES:
            dtype = getattr(torch, name)
            src = geo if dtype == torch.int16 else rand(dtype, (gh, gw), hi=2**62)
            if dtype.is_floating_point:
                src[gh // 3] = nan
            ds_k = h.dataset(geo_gm, v=src)
            k3 = f"fused_reproject.{name}"
            out, first, got = run(lambda: resample_in_space(ds_k, target_gm=b3_tgt,
                                                            interp_methods=interp), (k3,))
            fn = device_reproject_fn(GridMapping.from_dataset(ds_k), b3_tgt, interp,
                                     _default_fill_value(dtype), dev)
            if not isinstance(fn, FusedReprojectFn):
                raise AssertionError(f"BASELINE #3 {name} {interp} under "
                                     f"XRTPU_NO_EXACT_MOSAIC=1 ran {type(fn).__name__}, not K3")
            vt = gather_dtype(dtype, interp)
            h.check_output(out["v"].data, (t3, t3), vt)
            d = held(k3, out["v"].data, fn.plain(src), "exact",
                     f"BASELINE #3 {name} {interp} (K3) vs plain")
            a3 = (src[None], fn.ix_c, fn.iy_c, fn.step, fn.out_h, fn.out_w, interp,
                  fn.fill_value)
            timed(k3, lambda a=a3: fused_reproject(*a), lambda a=a3: fused_reproject_plain(*a),
                  fused_band_bound(*a3, 0, 0, gh, out_size=vt.itemsize,
                                   f64=vt == torch.float64))
            print(f"{tag} dtypes: BASELINE #3 {name} {interp} under XRTPU_NO_EXACT_MOSAIC=1 "
                  f"(K3, {vt} out): first call {first:.3f} s ({dict(got)}); vs plain max abs "
                  f"diff {d}")
            del out, fn, ds_k, a3
            if dtype != torch.int16:
                del src
    finally:
        os.environ.pop("XRTPU_NO_EXACT_MOSAIC", None)
    # the int16 band through sharded_reproject over 4 mesh entries (the
    # regrid step past the SRW's gate and the ESW's refusal: K3's band
    # form), held to the step's plain version; then every method on every
    # band
    kb = "fused_reproject_band.int16"
    out_s, first, got = run(lambda: parallel.sharded_reproject(
        geo, geo_gm, b3_tgt, mesh, interp_method="bilinear"), (kb,))
    xc, geo_c = crop_source(geo, geo_gm, b3_tgt)
    step, (pad, _) = parallel.make_sharded_regrid_step(mesh, geo_c, b3_tgt)
    padded = pad_rows(xc, pad, nan)
    for k, (a_, b_) in enumerate(zip(out_s.bands, step.plain(padded).bands)):
        held(kb, a_, b_, "exact", f"BASELINE #3 int16 sharded_reproject band {k} vs plain")
    bands, _ = step.bands(padded)
    halos = step.exchange(bands)
    for interp in METHODS:
        for k in range(mesh.size):
            g3 = list(step.gather_args(bands, halos, k))
            # nearest keeps int16: its fill an int16 (NaN raises, as in jnp)
            g3[6], g3[7] = interp, 0 if interp == "nearest" else nan
            held(kb, fused_reproject_band(*g3), fused_reproject_band_plain(*g3), "exact",
                 f"BASELINE #3 int16 band {k} (off {g3[9]}), {interp}")
    g3 = step.gather_args(bands, halos, 1)
    timed(kb, lambda: fused_reproject_band(*g3), lambda: fused_reproject_band_plain(*g3),
          fused_band_bound(*g3))
    print(f"{tag} dtypes: BASELINE #3 int16 through sharded_reproject over {mesh.size} mesh "
          f"entries on one card, bilinear: first call {first:.3f} s ({dict(got)}); K3's band "
          f"form held on every band, every method")
    del out_s, step, padded, bands, halos, g3, xc
    del ds, geo
    torch.cuda.empty_cache()

    # -- B5's sharded SRW step on one uint16 band over 4 mesh entries ---------
    src = rand(torch.uint16, (n, n))
    step, (pad, _) = parallel.make_sharded_srw_step(mesh, utm_gm, laea_gm)
    padded = pad_rows(src, pad, nan)
    got_s, dt, got = run(lambda: step(padded), ("srw_vertical_band.uint16",
                                                "srw_horizontal_band"))
    ref_s = step.plain(padded)
    for a_, b_ in zip(got_s.bands, ref_s.bands):
        held("srw_vertical_band.uint16", a_, b_, "exact", "B5 uint16 sharded step vs plain")
    bands, _ = step.bands(padded)
    halos = step.exchange(bands)
    v1 = step.vertical_args(bands, halos, 1)
    timed("srw_vertical_band.uint16", lambda: srw_vertical_band(*v1),
          lambda: srw_vertical_band_plain(*v1),
          bound_mixed(v1[0].numel() * 2 + 4 * v1[3].numel() + 4 * v1[3].shape[0] * n,
                      6 * v1[3].shape[0] * n * v1[5], 0))
    print(f"{tag} dtypes: B5 sharded SRW step, uint16 {n}^2 over 4 mesh entries on one "
          f"card: {dt * 1e3:.2f} ms the first call ({dict(got)})")
    del got_s, ref_s, bands, halos, v1, padded, src
    torch.cuda.empty_cache()

    # -- B5's sharded SRW step on 4 float64 bands (climate archives) over 4
    # mesh entries on the card: K1's and K2's band forms on float64, K2's
    # held to its plain version and timed on band 1 (with --against beside
    # the parent's K2 float64 form, in turns), the step's band 1 to it
    src = rand(torch.float64, (4, n, n))
    src[:, n // 3] = nan
    step, (pad, _) = parallel.make_sharded_srw_step(mesh, utm_gm, laea_gm, src_batch_dims=1)
    padded = pad_rows(src, pad, nan)
    del src
    kb = "srw_horizontal_band.float64"
    got_s, dt, got = run(lambda: step(padded), ("srw_vertical_band.float64", kb))
    out1 = got_s.bands[1]
    del got_s
    bands, _ = step.bands(padded)
    halos = step.exchange(bands)
    v1, _ = srw_vertical_band(*step.vertical_args(bands, halos, 1))
    del bands, halos, padded
    torch.cuda.empty_cache()
    h1 = step.horizontal_args(v1, None, 1)
    o1 = srw_horizontal_band(*h1)
    held(kb, o1, srw_horizontal_band_plain(*h1), "f64", f"B5 float64 band 1 {kb} vs plain")
    held(kb, out1.reshape(o1.shape), o1, "exact", "B5 float64 sharded step's band 1 vs K1 -> K2")
    n_out = o1.numel()
    timed(kb, lambda: srw_horizontal_band(*h1), lambda: srw_horizontal_band_plain(*h1),
          bound_mixed(8 * (v1.numel() + n_out) + 4 * (2 * h1[1].numel() + h1[4].numel()),
                      n_out * (4 * h1[6] + 40), 2 * n_out * h1[6]))
    if h.tree is not None and h.tree.k2_f64 is not None:
        theirs = h.tree.k2_f64(h1[:11], None, h1[12])
        held(kb, theirs(), o1, "f64", f"B5 float64 band 1: the parent's {kb} vs this")
        k, p = beside_parent(h, lambda: srw_horizontal_band(*h1), theirs)
        extra[kb] = dict(device_ms_in_turns=k, parent_device_ms=p)
        print(f"{tag} dtypes: B5 float64 band 1 {kb} in turns (parent, this, this, parent): "
              f"this {k:.4f} ms, the parent's {p:.4f} ms device")
        del theirs
    print(f"{tag} dtypes: B5 sharded SRW step, 4 float64 bands {n}^2 over 4 mesh entries on "
          f"one card: {dt * 1e3:.2f} ms the first call ({dict(got)}); band 1 v "
          f"{tuple(v1.shape)} -> {tuple(o1.shape)}, launch "
          f"{plan_band_launch(4, h1[8].extent, False, word=8)}")
    del out1, v1, o1, h1, step
    torch.cuda.empty_cache()
    return launches, err, timings, bounds, library, extra


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", default=None,
                        help="a parent tree whose K13-K18, K20 and K2 float64 kernels to "
                             "time beside this one's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    parent, tree_esw = parent_kernels(args.against) if args.against else (None, None)

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
    from xcube_resampling_tpu_torch.ops.esw import (
        STAGE_COLS,
        ESWReprojectFn,
        make_esw_reproject_fn,
        stage_cols,
    )
    from xcube_resampling_tpu_torch.ops.esw_mosaic import (
        ESWMosaicFn,
        esw_mosaic,
        esw_mosaic_plain,
        plan_esw_region,
    )
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
        plan_gather_reduce,
    )
    from xcube_resampling_tpu_torch.ops.reproject_ops import (
        FusedReprojectFn,
        fused_reproject,
        fused_reproject_plain,
        interp_field,
        make_fused_reproject_fn,
    )
    from xcube_resampling_tpu_torch.ops.srw import (
        SRWFn,
        make_srw_fn,
        make_srw_reproject_fn,
        plan_srw,
    )
    from xcube_resampling_tpu_torch.ops.srw_aligned import (
        srw_aligned_horizontal_plain,
        srw_aligned_vertical_plain,
    )
    from xcube_resampling_tpu_torch.ops.srw_kernels import (
        plan_band_launch,
        srw_horizontal,
        srw_horizontal_plain,
        srw_vertical,
        srw_vertical_plain,
    )
    from xcube_resampling_tpu_torch.reproject import device_reproject_fn
    from xcube_resampling_tpu_torch import rectify as port_rectify
    from xcube_resampling_tpu_torch.constants import UV_DELTA
    from xcube_resampling_tpu_torch.crs import Transformer
    from xcube_resampling_tpu_torch.ops import bbox_ops, exact_gather, rectify_ops
    from xcube_resampling_tpu_torch.gridmapping.bboxes import compute_ij_bboxes as host_bbox_scan

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
    # no kernel of the library spills (the sources that took the new dtypes
    # instantiate each: every instantiation is held to this)
    spilling = [(source, k) for source, _, spills, _ in ptxas_summary(build.log)
                for k in spills if k]
    if spilling:
        named = [k for k in ptxas_kernels(build.log, "") if k[2]]
        raise AssertionError(f"kernels spill: {spilling}: {named}")
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
    # K1, single-chip (Lb0E) and band form (Lb1E), per method; K3 and its
    # band form per method; K2 per method and (bands an item, stages); K7's
    # map and list forms per method and dtype, its band form per method;
    # K11's two kernels; K12 per tile
    for pattern in ("srw_vertical_kernel", "srw_horizontal_kernel", "fused_reproject_kernel",
                    "fused_reproject_typed_kernel",
                    "fused_reproject_band_kernel", "ij_gather_kernel", "ij_gather_band_kernel",
                    "seed_pass", "seed_walk", "hybrid_dense_kernel", "esw_gather_kernel",
                    "esw_gather_band_kernel", "srw_aligned_vertical_kernel",
                    "srw_aligned_horizontal_kernel", "srw_aligned_vertical_direct",
                    "esw_mosaic_kernel", "walk_coarse", "walk_fine", "tiled_kernel",
                    "phase_a_scan_cu"):
        for name, regs, spill, stack in ptxas_kernels(build.log, pattern):
            print(f"  {name}: {regs} registers, {spill} bytes spilled, {stack} bytes of "
                  f"stack frame")
    # the downscale form's cached kernels: 7 dtypes, 8 reducers, 8 widths
    cached = ptxas_kernels(build.log, "affine_gather_reduce_cached")
    if cached:
        print(f"  affine_gather_reduce_cached: {len(cached)} kernels, "
              f"{min(k[1] for k in cached)}-{max(k[1] for k in cached)} registers, "
              f"{max(k[2] for k in cached)} bytes spilled, "
              f"{max(k[3] for k in cached)} bytes of stack frame")
    # K7's band form, K2, K11, K12, K3's band form, K13 and its band form
    # (a staged kernel per method each, its fall-back inside), K14-K18 (K17
    # and K18 launch K14's and K15's kernels: the staged vertical kernel and
    # the horizontal kernel per method, the direct vertical kernel per
    # method with one tile and with many), K16 per method, and the
    # downscale form's cached kernels, K19's two kernels (K11's pass, which
    # K19 launches too, is in both sources), K20 and K21's two passes: no
    # spill, no local memory
    # (K7's band form: 3 methods for each of the 13 dtypes but bool's
    # bilinear and triangular)
    for pattern, n in (("ij_gather_band_kernel", 37), ("hybrid_dense_kernel", 4),
                       ("srw_horizontal_kernel", 24), ("seed_pass", 2), ("seed_walk", 1),
                       ("walk_coarse", 1), ("walk_fine", 1), ("tiled_kernel", 2),
                       ("phase_a_scan_cu", 2),
                       ("fused_reproject_band_kernel", 3), ("esw_gather_kernel", 3),
                       ("esw_gather_band_kernel", 3), ("srw_aligned_vertical_kernel", 2),
                       ("srw_aligned_horizontal_kernel", 4), ("srw_aligned_vertical_direct", 4),
                       ("esw_mosaic_kernel", 3),
                       ("affine_gather_reduce_cached", 7 * 8 * 8)):
        found = ptxas_kernels(build.log, pattern)
        if build.log and (len(found) != n or any(k[2] or k[3] for k in found)):
            raise AssertionError(f"{pattern}: {len(found)} of {n} kernels, spilling or with "
                                 f"a stack frame: {found}")
    _build.load()

    nan = float("nan")
    err = {
        "srw_vertical": 0.0, "srw_horizontal": 0.0, "fused_reproject": 0.0,
        "affine_gather": 0.0, "affine_gather_reduce": 0.0, "coarsen_reduce": 0.0,
        "coarsen_rank": 0.0, "ij_gather": 0.0, "rectify_phase_a": 0.0, "exact_gather": 0.0,
        "ij_bboxes": 0.0, "esw_gather": 0.0, "esw_gather_band": 0.0,
        "srw_aligned_vertical": 0.0, "srw_aligned_horizontal": 0.0, "esw_mosaic": 0.0,
        "srw_hybrid_vertical": 0.0, "srw_hybrid_horizontal": 0.0,
        **dict.fromkeys(LADDER_KERNELS, 0.0),
    }
    main_launches: Counter = Counter()
    rectify_launches: Counter = Counter()

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
        over = d > lim
        if over.any():
            first = tuple(int(k) for k in torch.nonzero(over)[0])
            raise AssertionError(
                f"{what}: max abs diff {d.max().item()} above the tolerance at "
                f"{int(over.sum())} elements, first {first}: {got[first].item()!r} "
                f"against {ref[first].item()!r}"
            )
        return d.max().item()

    def run_main(ds, target_gm, interp, expect, exact=None, allow=(), **kwargs):
        """One main-path call; the launch counts are reset just before it
        and read just after.  *expect* names the kernels it must launch,
        *exact* how often where it gives them, *allow* those it may launch;
        others must not launch."""
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
        for name in set(err) - set(expect) - set(allow):
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

    def time_pair(kernel, plain, iters=10):
        """The kernel's and the plain version's event_ms, in the order
        plain, kernel, kernel, plain (the median of each pair), and the
        kernel's device_ms."""
        p1, k1, k2, p2 = (event_ms(f, iters) for f in (plain, kernel, kernel, plain))
        return statistics.median([k1, k2]), statistics.median([p1, p2]), device_ms(kernel, iters)

    def k3_bound(fn, ix, iy, interp):
        """K3's bound on one band: it must read the coarse fields and the
        source pixels that the taps of the valid pixels reach (positions
        clamped as gather_interp clamps them; counted here with a mask on
        the card), and write the output; about 30 operations a pixel.
        Returns (ms, basis, source pixels tapped)."""
        h, w = fn.src_h, fn.src_w
        valid = (ix > -0.5) & (ix < w - 0.5) & (iy > -0.5) & (iy < h - 0.5)
        n_tapped = tapped_pixels(ix, iy, valid, h, w, interp)
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
        f"{st.win_v.extent} source rows staged; K2 windows of {st.win_h.cols} columns "
        f"a row tile of {st.win_h.rows}, {st.win_h.extent} v columns staged, launch "
        f"{plan_band_launch(1, st.win_h.extent, False)}"
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
    if not isinstance(coarse_fn, SRWFn) or coarse_fn.kind != "batched":
        raise AssertionError(f"the coarse image ran {type(coarse_fn).__name__} "
                             f"({getattr(coarse_fn, 'kind', None)}), not the batched SRW choice")
    d = compare(out["v"].data, coarse_fn.plain(coarse_ref), "bilinear",
                "pre-downscaled reproject vs plain K4 -> K5 -> K1 -> K2")
    mpix = 5120 * 5120 / 1e6
    inflated = (coarse_gm.height * j_div, coarse_gm.width * i_div)
    print(
        f"{tag} resample_in_space 20480^2 UTM32N->EPSG:3035 5120^2 at 120 m, bilinear, "
        f"mean: clipped source {tuple(clipped.shape)} (strides {clipped.stride()}), "
        f"{j_div}x{i_div} windows, residual scales {residual[1][1]:.4f}, "
        f"{residual[0][0]:.4f}, inflated {inflated[0]}x{inflated[1]} (not written), "
        f"coarse {coarse_gm.height}x{coarse_gm.width}, the SRW's kind {coarse_fn.kind} (K1 + "
        f"K2, JAX's cost model's pick); first call {first:.3f} s "
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
    n_src, n_taps = gather_reduce_values(clipped[None], residual, coarse_gm.height,
                                         coarse_gm.width, j_div, i_div)
    conv_rate = 16 * torch.cuda.get_device_properties(0).multi_processor_count * sm_clock_hz()
    print(
        f"{tag} pre-downscale affine_gather_reduce: float64 conversions at 16 a clock an SM "
        f"(information; the bound stays bytes or operations): the {n_src} source values its "
        f"taps reach, once each, {n_src / conv_rate * 1e3:.3f} ms; two a tap for its "
        f"{n_taps} taps, as rounding by conversions takes, {2 * n_taps / conv_rate * 1e3:.3f} ms"
    )
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

    # -- 1c. the flagship: the aligned SRW (K14, K15) -------------------------
    fl_err, fl_timings, fl_bounds, fl_variants = flagship_phase(
        dev, tag, SimpleNamespace(compare=compare, time_pair=time_pair, event_ms=event_ms,
                                  device_ms=device_ms, run_main=run_main,
                                  warm_calls=warm_calls, dataset=dataset,
                                  check_output=check_output, parent=parent),
    )
    for name, e in fl_err.items():
        err[name] = max(err[name], e)
    timings.update(fl_timings)
    bounds.update(fl_bounds)
    library.update(dict.fromkeys(FLAGSHIP_KERNELS, (None, None)))

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

    # -- 3. the exact tier: XRTPU_EXACT=1 runs the ESW (K13) -------------------
    os.environ["XRTPU_EXACT"] = "1"
    try:
        out, dt = run_main(ds1, utm4k_gm, "bilinear", ("esw_gather",), exact={"esw_gather": 1})
        check_output(out["v"].data, (4096, 4096))
        fn = device_reproject_fn(geo_gm_ds, utm4k_gm, "bilinear", nan, dev)
    finally:
        del os.environ["XRTPU_EXACT"]
    if not isinstance(fn, ESWReprojectFn):
        raise AssertionError(f"exact tier ran {type(fn).__name__}, not the ESW")
    d = compare(out["v"].data, fn.plain(geo), "exact", "exact tier vs plain K13")
    err["esw_gather"] = max(err["esw_gather"], d)
    esw_s = fn.n_samples
    # K3 on the same geometry (the direct gather, which the ESW reproduces
    # within 2 float32 ulp), held to its plain version and timed
    fn = make_fused_reproject_fn(geo_gm_ds, utm4k_gm, "bilinear", nan, dev)
    k3_out = fn(geo)
    d3 = compare(k3_out, fn.plain(geo), "bilinear", "K3 at 4326->UTM32N vs plain")
    err["fused_reproject"] = max(err["fused_reproject"], d3)
    d_esw = (out["v"].data - k3_out).abs().nan_to_num().max().item()
    print(f"{tag} XRTPU_EXACT=1 4326->UTM32N 4096^2 bilinear (K13, S={esw_s}): "
          f"first call {dt:.3f} s; vs plain equal; K3 on the geometry vs plain max abs diff "
          f"{d3}, max |K13 - K3| {d_esw:.3g}")
    del k3_out
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
    # refuses the SRW and ESW plans and runs the exact region mosaic (K16,
    # one launch a call); under XRTPU_NO_EXACT_MOSAIC=1 it runs K3
    laea4k_gm = GridMapping.regular(
        size=(4096, 4096), xy_min=(2000000.0, 1000000.0), xy_res=1500.0,
        crs="epsg:3035",
    )
    mpix = 4096 * 4096 / 1e6
    once16 = {"esw_mosaic": 1}
    for interp in ("nearest", "bilinear"):
        out, first = run_main(ds1, laea4k_gm, interp, ("esw_mosaic",), exact=once16)
        share = check_output(out["v"].data, (4096, 4096))
        out, w = warm_calls(ds1, laea4k_gm, interp, ("esw_mosaic",), 5, exact=once16)
        fn = device_reproject_fn(geo_gm_ds, laea4k_gm, interp, nan, dev)
        if not isinstance(fn, ESWMosaicFn):
            raise AssertionError(f"BASELINE #3 ran {type(fn).__name__}, not the mosaic")
        d = compare(out["v"].data, fn.plain(geo), "exact", f"BASELINE #3 {interp} vs plain K16")
        err["esw_mosaic"] = max(err["esw_mosaic"], d)
        # the host's planning, re-run alone after the first call: the ESW
        # planner's refusal, then the mosaic's planning (the quadtree, the
        # groups' replans)
        t0 = time.perf_counter()
        if make_esw_reproject_fn(geo_gm_ds, laea4k_gm, interp, nan, device=dev) is not None:
            raise AssertionError("plan_esw admits BASELINE #3")
        refusal = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan16 = plan_esw_region(geo_gm_ds, laea4k_gm)
        planning = time.perf_counter() - t0
        kinds = Counter(p[0] for p in fn.pieces)
        tags = Counter(t[0] for t in fn.groups)
        print(
            f"{tag} resample_in_space BASELINE #3 4326 0.05 deg->EPSG:3035 4096^2 "
            f"{interp} (the exact region mosaic, K16, no switch set): first call "
            f"{first:.3f} s = {mpix / first:.1f} Mpix/s (planning included); warm median "
            f"of 5 {w * 1e3:.3f} ms = {mpix / w:.1f} Mpix/s; finite share {share:.4f}; vs "
            f"plain max abs diff {d}"
        )
        print(
            f"{tag} BASELINE #3 {interp}: the host's planning re-run alone after the first "
            f"call: the mosaic's {planning:.3f} s, the ESW planner's refusal {refusal:.3f} s"
        )
        print(
            f"{tag} BASELINE #3 mosaic: {kinds['esw']} ESW pieces and {kinds['gather']} "
            f"gather pieces ({fn.n_tiles} tiles of 16x128 in one launch; covering the "
            f"target: {fn.covered}); JAX's programs: {tags['esw']} ESW groups, "
            f"{tags['gather']} gather groups, {tags['piece']} single pieces"
        )
        # XRTPU_NO_EXACT_MOSAIC=1: the direct gather, K3
        os.environ["XRTPU_NO_EXACT_MOSAIC"] = "1"
        try:
            out3, first3 = run_main(ds1, laea4k_gm, interp, ("fused_reproject",))
            out3, w3 = warm_calls(ds1, laea4k_gm, interp, ("fused_reproject",), 5)
            fn3 = device_reproject_fn(geo_gm_ds, laea4k_gm, interp, nan, dev)
        finally:
            del os.environ["XRTPU_NO_EXACT_MOSAIC"]
        if not isinstance(fn3, FusedReprojectFn):
            raise AssertionError(f"BASELINE #3 under XRTPU_NO_EXACT_MOSAIC=1 ran "
                                 f"{type(fn3).__name__}, not K3")
        d3 = compare(out3["v"].data, fn3.plain(geo), interp, f"BASELINE #3 {interp} vs plain K3")
        err["fused_reproject"] = max(err["fused_reproject"], d3)
        # the mosaic reproduces the direct gather: nearest bit for bit,
        # bilinear within 2 float32 ulp at unit scale (the data lies in [0, 1))
        dk = compare(out["v"].data, out3["v"].data, "nearest" if interp == "nearest" else "esw",
                     f"BASELINE #3 {interp}: the mosaic vs K3")
        print(
            f"{tag} resample_in_space BASELINE #3 {interp} under XRTPU_NO_EXACT_MOSAIC=1 "
            f"(K3): first call {first3:.3f} s = {mpix / first3:.1f} Mpix/s; warm median of 5 "
            f"{w3 * 1e3:.3f} ms = {mpix / w3:.1f} Mpix/s; vs plain max abs diff {d3}; "
            f"max |mosaic - K3| {dk:.3g}"
        )
        del out, out3
        (k, p, kd), (lib, lib_d), (b, by, n_tapped) = time_k3(fn3, geo, interp)
        print(
            f"{tag} fused_reproject at BASELINE #3 ({interp}): kernel {k:.4f} ms "
            f"(device {kd:.4f} ms), plain {p:.3f} ms, bound {b:.4f} ms ({by}; "
            f"{n_tapped} source pixels tapped), F.grid_sample {lib:.4f} ms (device "
            f"{lib_d:.4f} ms)"
        )
        args16 = fn.args(geo[None])
        k16 = time_pair(lambda: esw_mosaic(*args16), lambda: esw_mosaic_plain(*args16))
        b16, by16, n16 = mosaic_bound(fn, interp)
        print(
            f"{tag} esw_mosaic at BASELINE #3 ({interp}): kernel {k16[0]:.4f} ms (device "
            f"{k16[2]:.4f} ms, the canvas included: filled first {not fn.covered}), plain "
            f"{k16[1]:.3f} ms, bound {b16:.4f} ms ({by16}; {n16} source pixels tapped), "
            f"F.grid_sample on the whole "
            f"target {lib:.4f} ms (device {lib_d:.4f} ms); K3 on the same source {k:.4f} ms "
            f"(device {kd:.4f} ms)"
        )
        if interp == "bilinear":
            timings["esw_mosaic"] = k16
            bounds["esw_mosaic"] = (b16, by16)
            library["esw_mosaic"] = (lib, lib_d)
        del fn, fn3, args16

    # K16's triangular instantiation on the same pieces, held to its plain
    # version bit for bit (the main path above runs nearest and bilinear);
    # every method staged and per pixel (staged=False) on 1 and 4 bands,
    # the share of tiles staged as modelled, and the staged kernel beside
    # the per-pixel path and the parent tree's kernel (--against) in turns
    fn = ESWMosaicFn(plan16, "triangular", nan, dev)
    d = compare(fn(geo), fn.plain(geo), "exact", "BASELINE #3 triangular vs plain K16")
    err["esw_mosaic"] = max(err["esw_mosaic"], d)
    print(f"{tag} esw_mosaic at BASELINE #3 (triangular): vs plain max abs diff {d}")
    x4 = torch.rand((4,) + tuple(geo.shape), generator=torch.Generator(device=dev).manual_seed(20),
                    device=dev)
    b3_staged, b3_shares = {}, {}
    for interp in METHODS:
        fn = ESWMosaicFn(plan16, interp, nan, dev)
        for x in (geo[None], x4):
            a16 = fn.args(x)
            ref = esw_mosaic_plain(*a16)
            for staged in (True, False):
                d = compare(esw_mosaic(*a16, staged=staged), ref, "exact",
                            f"BASELINE #3 {interp}, {len(x)} bands, staged {staged}, vs plain K16")
                err["esw_mosaic"] = max(err["esw_mosaic"], d)
        b3_shares[interp] = staged_share(mosaic_spans(fn, interp), interp)
        if interp != "triangular":
            b3_staged[f"per_pixel_{interp}"] = beside_parent(
                SimpleNamespace(device_ms=device_ms), lambda a=fn.args(geo[None]): esw_mosaic(*a),
                lambda a=fn.args(geo[None]): esw_mosaic(*a, staged=False))
            if tree_esw is not None:
                b3_staged[f"parent_{interp}"] = beside_parent(
                    SimpleNamespace(device_ms=device_ms),
                    lambda a=fn.args(geo[None]): esw_mosaic(*a), tree_esw.k16(fn, geo[None]))
        del fn, a16, ref
    print(f"{tag} esw_mosaic at BASELINE #3, every method, 1 and 4 bands, staged "
          f"(up to {STAGE_COLS} columns, nearest {stage_cols('nearest')}) and per pixel: vs "
          f"plain equal; in turns, device ms (this; "
          f"per pixel; parent): " + "; ".join(
              f"{m} {b3_staged[f'per_pixel_{m}'][0]:.4f}, {b3_staged[f'per_pixel_{m}'][1]:.4f}"
              + (f", {b3_staged[f'parent_{m}'][1]:.4f}" if f"parent_{m}" in b3_staged else "")
              for m in ("bilinear", "nearest")))
    print(f"{tag} esw_mosaic tiles of its ESW pieces staged, modelled from the inputs "
          f"(ops.esw.tile_spans), not counted by the kernel: "
          + ", ".join(f"{m} {v:.4f}" for m, v in b3_shares.items()))
    del plan16, x4

    # -- 3c. the ESW cell: past the gate, K13 and its band form -------------
    esw_launches, esw_err, esw_timings, esw_bounds, esw_library, esw_k3 = esw_phase(
        dev, tag, SimpleNamespace(compare=compare, time_pair=time_pair, event_ms=event_ms,
                                  device_ms=device_ms, run_main=run_main,
                                  warm_calls=warm_calls, dataset=dataset,
                                  check_output=check_output, tree_esw=tree_esw),
        geo, ds1,
    )
    if esw_launches["esw_gather_band"] < 1:
        raise AssertionError("esw_gather_band never launched on the sharded path")
    main_launches.update(esw_launches)
    for name, e in esw_err.items():
        err[name] = max(err[name], e)
    timings.update(esw_timings)
    bounds.update(esw_bounds)
    library.update(esw_library)
    torch.cuda.empty_cache()

    # -- 3d. the fast extreme-warp mode: K17, K18 and the two-pass mosaic ---
    hy_err, hy_timings, hy_bounds, hy_yard = hybrid_phase(
        dev, tag, SimpleNamespace(compare=compare, time_pair=time_pair, event_ms=event_ms,
                                  device_ms=device_ms, run_main=run_main,
                                  warm_calls=warm_calls, dataset=dataset,
                                  check_output=check_output, parent=parent),
        geo, ds1,
    )
    for name, e in hy_err.items():
        err[name] = max(err[name], e)
    timings.update(hy_timings)
    bounds.update(hy_bounds)
    library.update(dict.fromkeys(HYBRID_KERNELS, (None, None)))

    # -- 4. a small case: numpy and tensor variables ------------------------
    # numpy variables (float32, float64, uint16) take the host path's
    # semantics on the card (K9's window mode, dtype kept) and equal its
    # plain version; the tensor variable takes the tiled SRW; the float32
    # ones are held against the port's K3 (the direct gather)
    small_src = GridMapping.regular(
        size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"
    )
    small_tgt = GridMapping.regular(
        size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035"
    )
    ramp = np.arange(96 * 96, dtype=np.float32).reshape(96, 96) / 96
    ramp_dev = torch.from_numpy(ramp).to(dev)
    host_vars = {"host": ramp, "host64": ramp.astype(np.float64) + 1e-9,
                 "host16": (ramp * 600).astype(np.uint16)}
    inv_small = Transformer.from_crs(small_tgt.crs, small_src.crs, always_xy=True)
    plan_small = port_reproject._plan_source_windows(inv_small, small_src, small_tgt)
    xx_small, yy_small = port_reproject._target_centers_in_source(inv_small, small_tgt)
    for interp in METHODS:
        LAUNCHES.clear()
        out = resample_in_space(
            dataset(small_src, dev=ramp_dev, **host_vars), target_gm=small_tgt,
            interp_methods=interp, device=dev,
        )
        torch.cuda.synchronize()
        main_launches.update(LAUNCHES)
        if (LAUNCHES["srw_vertical"] < 1 or LAUNCHES["srw_horizontal"] < 1
                or LAUNCHES["exact_gather"] != 3):
            raise AssertionError(f"small case {interp} skipped a tier: {dict(LAUNCHES)}")
        for name, data in host_vars.items():
            a = out[name].data
            x = torch.from_numpy(data)
            if not (isinstance(a, torch.Tensor) and a.device == dev and a.dtype == x.dtype):
                raise AssertionError(f"numpy variable {name} came back as {type(a)}")
            ref = port_reproject._gather_through_windows(
                x, small_src, small_tgt, xx_small, yy_small, plan_small, interp,
                65535 if name == "host16" else nan,
            )
            err["exact_gather"] = max(err["exact_gather"], compare(
                a, ref.to(dev), "exact", f"small case {interp} numpy {name} vs K9's plain version"))
        k3 = make_fused_reproject_fn(small_src, small_tgt, interp, nan, dev)
        b = k3.plain(ramp_dev[None])[0].cpu().numpy()
        for name in ("host", "dev"):
            a = out[name].data.cpu().numpy()
            both = np.isfinite(a) & np.isfinite(b)
            mask_diff = float((np.isnan(a) != np.isnan(b)).mean())
            diff = np.abs(a[both] - b[both])
            # the two-pass path (and the host path's float32-quantised
            # window origins) deviate from the direct gather by a fraction
            # of a pixel; the ramp rises 1 per row: bilinear and triangular
            # within 1e-2, nearest may flip to the equally near cell on
            # under 1% of pixels (tests/test_srw.py)
            flips = float((diff > 1e-6).mean())
            ok = both.mean() > 0.5 and mask_diff < 0.02 and (
                flips < 0.01 if interp == "nearest" else diff.max() < 1e-2
            )
            print(
                f"{tag} 96^2 UTM32N->EPSG:3035 {interp}, {name} variable vs the port's K3: "
                f"max abs diff {diff.max():.3g}, differing share {flips:.4f}, NaN-mask "
                f"mismatch {mask_diff:.4f}"
            )
            if not ok:
                raise AssertionError(f"small case {interp} {name} disagrees with K3")
    print(f"{tag} numpy float32, float64 and uint16 variables on the card: dtype kept, "
          f"equal to K9's plain version (max abs diff {err['exact_gather']})")

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
        # the edge geometry's dispatch picks the aligned SRW for bilinear
        # and nearest (cost 23 against 24): K1 and K2 run its tiled plan
        cases = (
            ("4326->UTM 2-band with NaN rows",
             device_reproject_fn(geo_gm_ds, utm4k_gm, interp, nan, dev), nan_stack),
            ("edge-clipping UTM32N->EPSG:3035 2-band",
             make_srw_fn(plan_srw(edge_src, edge_tgt), interp, nan, dev), edge_data),
        )
        if interp != "triangular":
            fa = make_srw_reproject_fn(edge_src, edge_tgt, interp, nan, dev)
            if fa.kind != "aligned" or fa.window is not None:
                raise AssertionError(f"edge-clipping {interp}: the dispatch ran {fa.kind}")
            sta = fa.state
            if not (sta.base_v.min().item() < 0
                    and sta.base_v.max().item() + sta.d_v > sta.src_h):
                raise AssertionError("edge-clipping: the aligned taps do not pass both edges")
            va = fa.vertical_args(fa.crop(edge_data))
            v, flags = fa.vertical(fa.crop(edge_data))
            d14 = compare(v, srw_aligned_vertical_plain(*va), "exact",
                          f"K14 {interp} edge-clipping", signs=True)
            ha = fa.horizontal_args(v)
            d15 = compare(fa.horizontal(v, flags), srw_aligned_horizontal_plain(*ha),
                          "exact", f"K15 {interp} edge-clipping", signs=True)
            err["srw_aligned_vertical"] = max(err["srw_aligned_vertical"], d14)
            err["srw_aligned_horizontal"] = max(err["srw_aligned_horizontal"], d15)
            print(f"{tag} kernels vs plain, edge-clipping UTM32N->EPSG:3035 2-band, aligned "
                  f"plan, {interp}: K14 {d14}, K15 {d15}")
            del fa, va, v, ha
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
    # the cached kernel's instantiations: every template width (1-8) and one
    # past it (the direct kernel), every reducer and pick, on float32, float64,
    # int32 and uint16; i flipped, j flipped (its first row between the
    # last two source rows), a strided view, the first rows above the
    # source (fill); the last output column's window
    # reaches the source's right edge (positions on multiples of 1/4, exact)
    n_down, routes = 0, Counter()
    for dtype in (torch.float32, torch.float64, torch.int32, torch.uint16):
        if dtype.is_floating_point:
            x = torch.from_numpy(rng.random((2, 48, 150))).to(dtype).to(dev)
            x[0, 10:20, 30:60] = nan
            x[1, 21] = nan
            fill = nan
        else:
            np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
            x = torch.from_numpy(
                rng.integers(*int_ranges[dtype], (2, 48, 150)).astype(np_dtype)).to(dev)
            fill = 5
        for width in range(1, 10):
            j_div = 3 if width % 2 else 2
            for flip_i, flip_j, view in ((False, False, True), (True, False, False),
                                         (False, True, False)):
                v = x[:, 2:, 3:] if view else x
                h, w = v.shape[-2:]
                ow = int((w - 1) / (width * 0.75))
                oh = int((h - 1) / (j_div * 0.8))
                i_s, i_o = (-0.75, (ow * width - 1) * 0.75) if flip_i else (
                    0.75, (w - 1) - (ow * width - 1) * 0.75)
                j_s, j_o = (-0.8, h - 1.3) if flip_j else (0.8, -0.6)
                up = affine_gather(v, j_s, i_s, j_o, i_o, oh * j_div, ow * width, 1, fill)
                for agg in REDUCERS:
                    args = (v, j_s, i_s, j_o, i_o, oh, ow, j_div, width, agg, fill)
                    routes[plan_gather_reduce(ow, width, i_s, i_o, w, agg)] += 1
                    got = affine_gather_reduce(*args)
                    what = (f"downscale form {dtype} {j_div}x{width} {agg}"
                            f"{' i flipped' if flip_i else ''}{' j flipped' if flip_j else ''}"
                            f"{' strided' if view else ''}")
                    compare(got, coarsen_reduce(up, j_div, width, agg), "exact",
                            f"{what} vs K4 -> K5", signs=True)
                    kind = "stat" if dtype.is_floating_point and agg in (
                        "mean", "sum", "std", "var", "prod") else "exact"
                    d = compare(got, affine_gather_reduce_plain(*args), kind, f"{what} vs plain")
                    err["affine_gather_reduce"] = max(err["affine_gather_reduce"], d)
                    n_down += 1
    if routes["cached"] != n_down * 8 // 11 * 8 // 9:
        raise AssertionError(f"the cached kernel took {routes['cached']} of {n_down} cases")
    print(f"{tag} affine_gather_reduce's cached kernel vs K4 -> K5 (equal, sign bits "
          f"included) and vs plain (max abs diff {err['affine_gather_reduce']}): {n_down} "
          f"cases ({dict(routes)}), window widths 1-9, every reducer and pick, float32, "
          f"float64, int32, uint16, flipped axes on each side, a strided view, fill edges, "
          f"all-NaN windows, the last column's window at the right edge")
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

    # -- 7. the rectify route: R1 (BASELINE #4), R2, R3, the numpy route ----
    # the default (device) tier: JAX's ladder on the card (the hybrid at
    # R1-R3), the map kept there, the resident Phase B; R1 and R3 also once under
    # XRTPU_PHASEA=host (the host's bbox scan, the Phase B planned from the
    # whole map), and the numpy route under the host tier (K9)
    rectify_kernels = ("ij_bboxes", "rectify_phase_a", "ij_gather", "exact_gather")
    phase_b_srw = ("srw_vertical", "srw_horizontal")
    # the default device tier's kernels at R1-R3: JAX's ladder takes the
    # hybrid (K10 and K8 serve where every tier refuses: phase_a_ladder_phase)
    device_tier = ("hybrid_seed", "hybrid_dense")

    class phase_a_tier:
        """XRTPU_PHASEA set to *tier* inside the block."""

        def __init__(self, tier):
            self.tier = tier

        def __enter__(self):
            os.environ["XRTPU_PHASEA"] = self.tier

        def __exit__(self, *exc):
            os.environ.pop("XRTPU_PHASEA", None)

    def k10_check(sw, gm, tgt, what):
        """K10 on the (2, H, W) swath *sw* for the tiles of *tgt* against
        its plain version on the card and the host's scan: equal; returns
        the arguments of the call."""
        args = (sw[0], sw[1], tgt.xy_bboxes, port_rectify._tile_search_border(tgt), 1)
        got = bbox_ops.compute_ij_bboxes(*args)
        compare(got, bbox_ops.compute_ij_bboxes_plain(*args), "exact", f"{what} K10 vs plain")
        if not np.array_equal(got.cpu().numpy(), gm.ij_bboxes_from_xy_bboxes(
                tgt.xy_bboxes, xy_border=args[3], ij_border=1)):
            raise AssertionError(f"{what} K10 differs from the host's bbox scan")
        return args

    def k10_equal(x, y, boxes, border, what, rows=None):
        """K10 on the card's (h, w) float64 images *x*, *y* for the xy
        *boxes* grown by *border* (ij border 1) against its plain version on
        the card and the host's scan (on the tiles *rows* only, where
        given): equal; returns K10's boxes."""
        got = bbox_ops.compute_ij_bboxes(x, y, boxes, border, 1)
        compare(got, bbox_ops.compute_ij_bboxes_plain(x, y, boxes, border, 1), "exact",
                f"{what} K10 vs plain")
        sel = np.arange(len(boxes)) if rows is None else rows
        ref = host_bbox_scan(x.cpu().numpy(), y.cpu().numpy(), np.asarray(boxes)[sel], border,
                             1, np.full((len(sel), 4), -1, np.int64))
        if not np.array_equal(got.cpu().numpy()[sel], ref):
            raise AssertionError(f"{what} K10 differs from the host's bbox scan")
        return got

    def k10_swath(h, w, x_off, y_off, seed):
        """(h, w) float64 x and y images on the card (a sheared grid with
        jitter, x NaN on the middle row where h > 2), views into one buffer
        starting *x_off* and *y_off* 8-byte words past a 16-byte boundary."""
        rng = np.random.default_rng(seed)
        j, i = np.mgrid[0:h, 0:w].astype(np.float64)
        x = 10.0 + 0.5 * i + 0.07 * j + 0.01 * rng.random((h, w))
        y = 40.0 - 0.5 * j + 0.05 * i + 0.01 * rng.random((h, w))
        if h > 2:
            x[h // 2] = nan
        n = h * w
        y_start = 2 * ((n + 1) // 2 + 1) + y_off
        buf = torch.empty(y_start + n + 1, dtype=torch.float64, device=dev)
        xs = buf[x_off:x_off + n].view(h, w)
        ys = buf[y_start:y_start + n].view(h, w)
        xs.copy_(torch.from_numpy(x))
        ys.copy_(torch.from_numpy(y))
        if (xs.data_ptr() // 8 % 2, ys.data_ptr() // 8 % 2) != (x_off, y_off):
            raise AssertionError("k10_swath: the views are not aligned as asked")
        return xs, ys

    def k10_target(x, y, tile, j_axis_up=False, shift=0.0):
        """A regular grid at 0.5 over the extent of *x*, *y* (moved by
        *shift*) in tiles of *tile* pixels."""
        x0, x1 = np.nanmin(x.cpu().numpy()), np.nanmax(x.cpu().numpy())
        y0, y1 = np.nanmin(y.cpu().numpy()), np.nanmax(y.cpu().numpy())
        return GridMapping.regular(
            size=(int(np.ceil((x1 - x0) / 0.5)) + 1, int(np.ceil((y1 - y0) / 0.5)) + 1),
            xy_min=(x0 + shift, y0 + shift), xy_res=0.5, crs="EPSG:32631", tile_size=tile,
            is_j_axis_up=j_axis_up)

    def device_ops(fn, n):
        """The names of the device activities (kernels, copies, memsets)
        that *n* calls of *fn* queue, from torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")
                and e.name != "Activity Buffer Request"]

    def k10_warm(args, what):
        """A warm K10 call queues one device operation (the launch: the C
        entry's report and the wrapper's uploads, none; in 3 calls the
        profiler sees nothing but K10's launches) and does not synchronise
        (under sync debug mode "error"); a summary."""
        bbox_ops.compute_ij_bboxes(*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            bbox_ops.compute_ij_bboxes(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if bbox_ops.last_queued != 1:
            raise AssertionError(f"{what}: a warm K10 call queued {bbox_ops.last_queued} "
                                 f"device operations")
        # the profiler may drop activities; it must see no other
        ops = device_ops(lambda: bbox_ops.compute_ij_bboxes(*args), 3)
        if len(ops) > 3 or any("scan_kernel" not in op for op in ops):
            raise AssertionError(f"{what}: three warm K10 calls queued {ops}")
        seen = (f"{len(ops)} device activities in 3 calls, each K10's scan_kernel" if ops
                else "no device activity in 3 calls")
        return (f"a warm call queues {bbox_ops.last_queued} device operation (the profiler "
                f"saw {seen}) and does not synchronise")

    def k10_bound(sw, n_tiles):
        """K10 reads the swath's two float64 coordinate images once and the
        tiles' bounds, writes n x 4 int64; about four float64 comparisons a
        pixel (its column's and row's bounds)."""
        n_bytes = sw.numel() * 8 + n_tiles * 4 * 8 * 2
        return bound(n_bytes, 4 * sw[0].numel(), PEAK_F64)

    def olci_swath(width, height, bands=(), on_card=True, tile_size=512):
        """The synthetic OLCI-like swath of tests/sampledata.py
        (create_olci_like_swath): 2D lon/lat with along/across-track
        curvature at ~0.0025 deg, and float32 radiance bands of its formula
        (band k offset by k), made on the card or, with *on_card* False,
        on the host; chunked in *tile_size* tiles, which the default target
        grid takes."""
        j = np.arange(height, dtype=np.float64)[:, None]
        i = np.arange(width, dtype=np.float64)[None, :]
        res = 0.0025
        lon = 4.0 + res * (i + 0.12 * j + 2e-5 * j * i)
        lat = 62.0 - res * (j - 0.08 * i + 1.2e-5 * (i - width / 2) ** 2)
        variables = {}
        if on_card:
            jj = torch.arange(height, dtype=torch.float64, device=dev)[:, None]
            ii = torch.arange(width, dtype=torch.float64, device=dev)[None, :]
            rad = (torch.sin(0.01 * ii) * torch.cos(0.013 * jj) * 50 + 100).float()
        else:
            rad = (np.sin(0.01 * i) * np.cos(0.013 * j) * 50 + 100).astype(np.float32)
        for k, name in enumerate(bands):
            variables[name] = DataArray(rad + k if k else rad, dims=("y", "x"))
        return Dataset(variables, coords={
            "lon": DataArray(lon, dims=("y", "x")), "lat": DataArray(lat, dims=("y", "x")),
        }).chunk({"y": tile_size, "x": tile_size})

    def run_rectify(ds, target_gm, interp, expect, allow=(), **kwargs):
        """run_main on the rectify route, its launches also counted apart."""
        out, dt = run_main(ds, target_gm, interp, expect, allow=allow, **kwargs)
        rectify_launches.update(LAUNCHES)
        return out, dt

    def warm_rectify(ds, target_gm, interp, expect, n, allow=(), **kwargs):
        """The median wall time of *n* more rectify calls, and the last
        output."""
        times = []
        for _ in range(n):
            out, dt = run_rectify(ds, target_gm, interp, expect, allow=allow, **kwargs)
            times.append(dt)
        return out, statistics.median(times)

    def phase_a_work(sw, tiles):
        """K8's work on these inputs, counted on the card: the quads of the
        tiles' windows, and the (quad, pixel) candidates of their pixel
        rectangles inside their tiles (NaN-cornered quads have none)."""
        n_quads = n_cand = 0
        for (row0, col0, th, tw, i_lo, j_lo, ww, wh), (xo, yo) in zip(
            tiles.ints.tolist(), tiles.origins.tolist()
        ):
            if ww < 2 or wh < 2:
                continue
            n_quads += (ww - 1) * (wh - 1)
            win = sw[:, j_lo:j_lo + wh, i_lo:i_lo + ww]
            fi = torch.floor((win[0] - xo) / tiles.x_scale)
            fj = torch.floor((win[1] - yo) / tiles.y_scale)

            def corners(f):
                return torch.stack([f[:-1, :-1], f[:-1, 1:], f[1:, :-1], f[1:, 1:]])

            ci, cj = corners(fi), corners(fj)
            ok = ~(torch.isnan(ci).any(0) | torch.isnan(cj).any(0))
            i0, i1 = ci.amin(0).clamp(min=0), ci.amax(0).clamp(max=tw - 1)
            j0, j1 = cj.amin(0).clamp(min=0), cj.amax(0).clamp(max=th - 1)
            n = ((i1 - i0 + 1).clamp(min=0) * (j1 - j0 + 1).clamp(min=0))[ok]
            n_cand += int(n.sum().item())
        return n_quads, n_cand

    def phase_a_bound(sw, tiles):
        """K8 reads the swath's coordinates once and writes the map once;
        about 24 float64 operations a window quad (corner floors, extents,
        determinants), 30 a candidate pixel (its centre and two triangle
        solves) and 40 a written pixel (the winner's solve again)."""
        n_quads, n_cand = phase_a_work(sw, tiles)
        n_px = tiles.out_h * tiles.out_w
        n_bytes = sw.numel() * 8 + 2 * n_px * 8 + tiles.ints.nbytes + tiles.origins.nbytes
        return bound(n_bytes, 24 * n_quads + 30 * n_cand + 40 * n_px, PEAK_F64) + (
            n_quads, n_cand)

    def gather_bound(src, out_hw, per_band_ops, peak, map_bytes):
        """K7 and K9 read the source planes and the map (or its positions
        and mask) once and write the output once; *per_band_ops*
        operations a pixel and band at *peak*."""
        b, n_out = src.shape[0], out_hw[0] * out_hw[1]
        n_bytes = src.numel() * src.element_size() + n_out * map_bytes + b * n_out * src.element_size()
        return bound(n_bytes, b * n_out * per_band_ops, peak)

    def raster_share(a, b, what):
        """The share of the pixels where two rasters through two Phase A
        maps (each within 1e-9 of the other) differ; raises unless their
        NaN masks are equal and the share is below 1e-3."""
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            raise AssertionError(f"{what}: NaN masks differ")
        share = (a[~na] != b[~nb]).float().mean().item()
        if share >= 1e-3:
            raise AssertionError(f"{what}: {share} of the pixels differ")
        return share

    # R1: BASELINE #4 (bench.py:478-640), the 1189 x 1890 OLCI-like swath
    # onto its default grid with 512 tiles, nearest; the variable a float32
    # tensor on the card: the hybrid (K11, K12; JAX's ladder), then K7's
    # map form
    ds_r1 = olci_swath(1189, 1890, ("rad",))
    r1_gm = GridMapping.from_dataset(ds_r1)
    r1_tgt = r1_gm.to_regular(tile_size=512)
    r1_expect = device_tier + ("ij_gather",)
    out, first = run_rectify(ds_r1, None, 0, r1_expect)
    out, w = warm_rectify(ds_r1, None, 0, r1_expect, 5)
    r1_img = out["rad"].data
    share = check_output(r1_img, (r1_tgt.height, r1_tgt.width))
    npix = r1_tgt.height * r1_tgt.width
    with phase_a_tier("host"):
        out, first_h = run_rectify(ds_r1, None, 0, ("rectify_phase_a", "ij_gather"))
        out, w_h = warm_rectify(ds_r1, None, 0, ("rectify_phase_a", "ij_gather"), 5)
    r1_share = raster_share(r1_img, out["rad"].data,
                            "R1 nearest, device tier (the hybrid) vs host tier (K8)")
    r1_tiles = port_rectify._phase_a_tiles(r1_gm, r1_tgt)
    r1_sw = torch.from_numpy(np.stack([np.asarray(ds_r1["lon"].data),
                                       np.asarray(ds_r1["lat"].data)])).to(dev)
    if not np.array_equal(port_rectify._phase_a_tiles(r1_gm, r1_tgt, r1_sw).ints, r1_tiles.ints):
        raise AssertionError("R1's tile table from K10 differs from the host scan's")
    r1_map = rectify_ops.rectify_phase_a(r1_sw, r1_tiles, UV_DELTA)
    r1_dev_map = port_rectify._inverse_ij_map(r1_gm, r1_tgt, UV_DELTA, dev)
    if not isinstance(r1_dev_map, rectify_ops.DeviceIJMap):
        raise AssertionError(f"R1's default tier gave a {type(r1_dev_map).__name__}")
    r1_d = compare(r1_dev_map.device_map(), port_rectify._inverse_ij_map(
        r1_gm, r1_tgt, UV_DELTA, dev, tier="host"), "map",
        "R1 map, device tier (the hybrid) vs host tier (K8)")
    r1_map_plain = rectify_ops.rectify_phase_a_plain(r1_sw, r1_tiles, UV_DELTA)
    err["rectify_phase_a"] = max(err["rectify_phase_a"], compare(
        r1_map, r1_map_plain, "exact", "R1 K8 vs plain"))
    r1_src = ds_r1["rad"].data
    fn = rectify_ops.make_device_var_image_fn(r1_dev_map.device_map(), r1_src.shape, nan,
                                              "nearest", device=dev)
    d = compare(r1_img, fn.plain(r1_src[None])[0], "nearest",
                "R1 vs the device tier's map -> plain K7")
    del r1_dev_map
    print(
        f"{tag} resample_in_space R1 (BASELINE #4: 1189x1890 OLCI-like swath -> "
        f"{r1_tgt.width}x{r1_tgt.height} EPSG:4326, {len(r1_tiles.ints)} tiles of 512, "
        f"nearest, a float32 tensor): first call {first:.3f} s = {npix / first / 1e6:.1f} "
        f"Mpix/s; warm median of 5 {w * 1e3:.2f} ms = {npix / w / 1e6:.1f} Mpix/s; finite "
        f"share {share:.4f}; vs the device tier's map -> plain K7 max abs diff {d}; under "
        f"XRTPU_PHASEA=host: first call {first_h:.3f} s, warm median of 5 {w_h * 1e3:.2f} ms; "
        f"the device tier's map (the hybrid) vs the host tier's (K8): NaN coverage equal, max "
        f"abs diff {r1_d:.3g}; the outputs: NaN masks equal, {r1_share:.3g} of the pixels "
        f"differ"
    )
    # Phase A alone under each tier (the device tier's ladder; the host
    # tier's upload, bbox scan and K8), warm; the tile plan alone by K10 and
    # by the host's scan
    def wall_ms(fn, n):
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    phase_a_ms = {tier: wall_ms(lambda t=tier: port_rectify._inverse_ij_map(
        r1_gm, r1_tgt, UV_DELTA, dev, tier=t), 5) for tier in ("device", "host")}
    plan_ms = {"device": wall_ms(lambda: port_rectify._phase_a_tiles(r1_gm, r1_tgt, r1_sw), 5),
               "host": wall_ms(lambda: port_rectify._phase_a_tiles(r1_gm, r1_tgt), 3)}
    k10_args = k10_check(r1_sw, r1_gm, r1_tgt, "R1")
    r1_ops = k10_warm(k10_args, "R1")
    # three calls in a row (the table restored after each), then three
    # geometries interleaved: R1's, R1's tiles under another border (the
    # same table), the R1 swath onto 256-pixel tiles (another table)
    k10_runs = [bbox_ops.compute_ij_bboxes(*k10_args) for _ in range(3)]
    if not (torch.equal(k10_runs[0], k10_runs[2]) and torch.equal(k10_runs[0], k10_runs[1])):
        raise AssertionError("R1: three K10 calls in a row differ")
    r1_256 = r1_gm.to_regular(tile_size=256)
    k10_geoms = [k10_args, k10_args[:3] + (0.5 * k10_args[3], 1),
                 (r1_sw[0], r1_sw[1], r1_256.xy_bboxes,
                  port_rectify._tile_search_border(r1_256), 1)]
    k10_refs = [bbox_ops.compute_ij_bboxes_plain(*a) for a in k10_geoms]
    for rep in range(2):
        for g, (a, ref) in enumerate(zip(k10_geoms, k10_refs)):
            compare(bbox_ops.compute_ij_bboxes(*a), ref, "exact",
                    f"R1 K10 interleaved, geometry {g}, round {rep}")
    # odd widths in the four alignments of x and y, j axis down and up;
    # one column, one row; one tile; a target off the swath
    for x_off in (0, 1):
        for y_off in (0, 1):
            xs, ys = k10_swath(301, 197, x_off, y_off, 21 + 2 * x_off + y_off)
            for up in (False, True):
                tgt = k10_target(xs, ys, 64, up)
                k10_equal(xs, ys, tgt.xy_bboxes, port_rectify._tile_search_border(tgt),
                          f"301x197 swath (x {x_off}, y {y_off} words off 16 bytes, j axis "
                          f"{'up' if up else 'down'}, {len(tgt.xy_bboxes)} tiles):")
    for h_, w_, offs in ((1000, 1, (1, 0)), (1000, 1, (0, 1)), (1, 1001, (1, 1)),
                         (1, 1001, (0, 1))):
        xs, ys = k10_swath(h_, w_, *offs, 31)
        tgt = k10_target(xs, ys, 16)
        k10_equal(xs, ys, tgt.xy_bboxes, 2.0, f"{h_}x{w_} swath, offsets {offs}:")
    xs, ys = k10_swath(301, 197, 0, 1, 41)
    one = k10_target(xs, ys, 4096)
    if len(one.xy_bboxes) != 1:
        raise AssertionError(f"the one-tile target has {len(one.xy_bboxes)} tiles")
    k10_equal(xs, ys, one.xy_bboxes, 0.5, "one tile:")
    off = k10_target(xs, ys, 64, shift=1000.0)
    if (k10_equal(xs, ys, off.xy_bboxes, 0.5, "a target off the swath:").cpu() != -1).any():
        raise AssertionError("K10 found swath pixels in a target off the swath")
    del xs, ys
    timings["ij_bboxes"] = time_pair(lambda: bbox_ops.compute_ij_bboxes(*k10_args),
                                     lambda: bbox_ops.compute_ij_bboxes_plain(*k10_args))
    bounds["ij_bboxes"] = k10_bound(r1_sw, len(r1_tgt.xy_bboxes))
    library["ij_bboxes"] = (None, None)
    k, p_, kd = timings["ij_bboxes"]
    print(
        f"{tag} ij_bboxes (K10) at R1 ({len(r1_tgt.xy_bboxes)} tiles): equal to its plain "
        f"version and the host's scan; {k:.4f} ms (device {kd:.4f} ms), plain {p_:.3f} ms, "
        f"bound {bounds['ij_bboxes'][0]:.4f} ms ({bounds['ij_bboxes'][1]}); {r1_ops}; three "
        f"calls in a row equal, three geometries interleaved equal to their plain versions; "
        f"equal to its plain version and the host's scan on a 301x197 swath (NaN row) in the "
        f"four alignments, j axis down and up, on 1000x1 and 1x1001 swaths, one tile and a "
        f"target off the swath"
    )
    timings["rectify_phase_a"] = time_pair(
        lambda: rectify_ops.rectify_phase_a(r1_sw, r1_tiles, UV_DELTA),
        lambda: rectify_ops.rectify_phase_a_plain(r1_sw, r1_tiles, UV_DELTA), iters=3,
    )
    b8, by8, n_quads, n_cand = phase_a_bound(r1_sw, r1_tiles)
    bounds["rectify_phase_a"] = (b8, by8)
    library["rectify_phase_a"] = (None, None)
    k, p_, kd = timings["rectify_phase_a"]
    print(
        f"{tag} R1 Phase A alone, warm median of 5: device tier (the swath's upload, the "
        f"hybrid) {phase_a_ms['device']:.2f} ms (K10's tile plan alone "
        f"{plan_ms['device']:.2f} ms), host tier (upload, tile plan, K8) "
        f"tier {phase_a_ms['host']:.2f} ms (the host's bbox scan {plan_ms['host']:.2f} ms); "
        f"rectify_phase_a {k:.4f} ms (device {kd:.4f} ms), plain {p_:.2f} ms, bound "
        f"{b8:.4f} ms ({by8}; {n_quads} window quads, {n_cand} candidate pixels)"
    )
    # the 16-band Phase B (rad x 16, float32) for each method, as bench.py
    # measures it (one geometry, the map built once)
    bands16 = r1_src[None].expand(16, -1, -1).contiguous()
    r1_resident = rectify_ops.DeviceIJMap(r1_map)
    for interp in METHODS:
        for form in ("resident", "host map"):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            if form == "resident":
                fn = rectify_ops.make_device_var_image_fn_resident(r1_resident, nan, interp)
                fn.impl(tuple(r1_src.shape))
            else:
                fn = rectify_ops.make_device_var_image_fn(r1_map, r1_src.shape, nan, interp,
                                                          device=dev)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            got = fn(bands16)
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            d = compare(got, fn.plain(bands16), interp,
                        f"R1 16-band Phase B {interp} ({form}) vs plain")
            err["ij_gather"] = max(err["ij_gather"], d)
            ev, dv = event_ms(lambda: fn(bands16), 5), device_ms(lambda: fn(bands16), 5)
            impl = fn.impl(tuple(r1_src.shape)) if form == "resident" else fn
            print(
                f"{tag} R1 16-band Phase B {interp}, {form} ({type(impl).__name__}: "
                f"{counts}): plan {plan_s * 1e3:.1f} ms; {ev:.3f} ms (device {dv:.3f} ms) = "
                f"{16 * npix / ev / 1e3:.1f} Mpix/s; vs plain max abs diff {d}"
            )
    del r1_resident
    del got, bands16
    # K7 and K9 timed at R1's 16 bands, nearest (BASELINE #4's method) and
    # bilinear; F.grid_sample (corners aligned, border padding) at the same
    # positions beside K7
    fn = rectify_ops.make_device_var_image_fn(r1_map, r1_src.shape, nan, "nearest", device=dev)
    bands16 = r1_src[None].expand(16, -1, -1).contiguous()
    k7_args = (bands16, fn.ix, fn.iy, fn.valid, "nearest", nan)
    timings["ij_gather"] = time_pair(lambda: rectify_ops.ij_gather(*k7_args),
                                     lambda: rectify_ops.ij_gather_plain(*k7_args), iters=5)
    bounds["ij_gather"] = gather_bound(bands16, fn.ix.shape, 4, PEAK_F32, 9)
    h_, w_ = r1_src.shape
    grid = torch.stack((fn.ix / (w_ - 1) * 2 - 1, fn.iy / (h_ - 1) * 2 - 1), dim=-1)[None]
    for interp in METHODS:
        def lib_call(mode=interp):
            return F.grid_sample(bands16[None], grid, mode=mode, padding_mode="border",
                                 align_corners=True)

        # F.grid_sample has no triangular mode
        lib = ((event_ms(lib_call, 5), device_ms(lib_call, 5)) if interp != "triangular"
               else (nan, nan))
        args = (bands16, fn.ix, fn.iy, fn.valid, interp, nan)
        kt = (event_ms(lambda: rectify_ops.ij_gather(*args), 5),
              device_ms(lambda: rectify_ops.ij_gather(*args), 5))
        b7, by7 = gather_bound(bands16, fn.ix.shape, 4 if interp == "nearest" else 16,
                               PEAK_F32, 9)
        if interp == "nearest":
            library["ij_gather"] = lib
        print(
            f"{tag} ij_gather {interp} at R1 (16 x {h_}x{w_} -> {fn.ix.shape[0]}x"
            f"{fn.ix.shape[1]}): {kt[0]:.4f} ms (device {kt[1]:.4f} ms), bound {b7:.4f} ms "
            f"({by7}); F.grid_sample {lib[0]:.4f} ms (device {lib[1]:.4f} ms)"
        )
    k, p_, kd = timings["ij_gather"]
    print(f"{tag} ij_gather nearest at R1: kernel {k:.4f} ms (device {kd:.4f} ms), plain "
          f"{p_:.3f} ms")
    k9_args = (bands16, r1_map, nan, "nearest")
    d = compare(exact_gather.exact_gather_ij(*k9_args), exact_gather.exact_gather_ij_plain(*k9_args),
                "exact", "R1 K9 ij_map 16-band vs plain")
    err["exact_gather"] = max(err["exact_gather"], d)
    timings["exact_gather"] = time_pair(lambda: exact_gather.exact_gather_ij(*k9_args),
                                        lambda: exact_gather.exact_gather_ij_plain(*k9_args),
                                        iters=5)
    bounds["exact_gather"] = gather_bound(bands16, r1_map.shape[-2:], 6, PEAK_F64, 16)
    library["exact_gather"] = (None, None)
    k, p_, kd = timings["exact_gather"]
    k9b = (bands16, r1_map, nan, "bilinear")
    print(
        f"{tag} exact_gather ij_map nearest at R1 (16 bands): {k:.4f} ms (device {kd:.4f} "
        f"ms), plain {p_:.3f} ms, bound {bounds['exact_gather'][0]:.4f} ms "
        f"({bounds['exact_gather'][1]}); bilinear {event_ms(lambda: exact_gather.exact_gather_ij(*k9b), 5):.4f} "
        f"ms (device {device_ms(lambda: exact_gather.exact_gather_ij(*k9b), 5):.4f} ms), "
        f"bound {gather_bound(bands16, r1_map.shape[-2:], 20, PEAK_F64, 16)[0]:.4f} ms"
    )
    del bands16, grid, k7_args, k9_args, k9b

    # the numpy route on R1: float64 and uint16 numpy variables keep their
    # dtype through K8 and K9's ij_map mode, equal to the plain versions
    ds_np = olci_swath(1189, 1890, (), on_card=False)
    rad_np = np.asarray(olci_swath(1189, 1890, ("rad",), on_card=False)["rad"].data)
    ds_np["rad64"] = DataArray(rad_np.astype(np.float64) / 3, dims=("y", "x"))
    ds_np["rad16"] = DataArray((rad_np * 300).astype(np.uint16), dims=("y", "x"))
    np_gm = GridMapping.from_dataset(ds_np)
    compare(port_rectify._inverse_ij_map(np_gm, np_gm.to_regular(), UV_DELTA, dev, tier="host"),
            r1_map, "exact", "R1 numpy dataset's Phase A map vs R1's")
    for interp in METHODS:
        with phase_a_tier("host"):
            out, dt = run_rectify(ds_np, None, interp, ("rectify_phase_a", "exact_gather"),
                                  device=dev)
        for name, fill in (("rad64", nan), ("rad16", 65535)):
            x = torch.from_numpy(np.asarray(ds_np[name].data)).to(dev)
            check_output(out[name].data, (r1_tgt.height, r1_tgt.width), x.dtype)
            ref = exact_gather.exact_gather_ij_plain(x[None], r1_map_plain, fill, interp)[0]
            err["exact_gather"] = max(err["exact_gather"], compare(
                exact_gather.exact_gather_ij(x[None], r1_map, fill, interp)[0], ref, "exact",
                f"R1 K9 on {name} {interp} vs plain"))
            err["exact_gather"] = max(err["exact_gather"], compare(
                out[name].data, ref, "exact", f"R1 numpy {name} {interp} vs plain K8 -> K9"))
        print(f"{tag} R1 numpy float64 and uint16 variables, {interp}, XRTPU_PHASEA=host: "
              f"{dt:.3f} s, dtype kept, equal to plain K8 -> K9")
    del ds_np, rad_np

    # R2: the same swath onto a regular EPSG:32631 grid at 250 m over its
    # transformed extent, bilinear: the swath's coordinates go through the
    # CRS engine first, then the pre-downscale where the swath is finer
    fwd = Transformer.from_crs("EPSG:4326", "EPSG:32631", always_xy=True)
    tx, ty = fwd.transform(np.asarray(ds_r1["lon"].data), np.asarray(ds_r1["lat"].data))
    x0, y0 = float(np.floor(tx.min() / 250) * 250), float(np.floor(ty.min() / 250) * 250)
    r2_tgt = GridMapping.regular(
        size=(int(np.ceil((tx.max() - x0) / 250)) + 1, int(np.ceil((ty.max() - y0) / 250)) + 1),
        xy_min=(x0, y0), xy_res=250.0, crs="EPSG:32631", tile_size=512,
    )
    r2_allow = ("affine_gather", "affine_gather_reduce", "coarsen_reduce") + phase_b_srw
    out, first = run_rectify(ds_r1, r2_tgt, "bilinear", device_tier,
                             allow=r2_allow + ("ij_gather",))
    r2_counts = dict(LAUNCHES)
    if not (LAUNCHES["ij_gather"] or LAUNCHES["srw_horizontal"]):
        raise AssertionError(f"R2's Phase B launched nothing: {r2_counts}")
    out, w = warm_rectify(ds_r1, r2_tgt, "bilinear", device_tier, 3,
                          allow=r2_allow + ("ij_gather",))
    share = check_output(out["rad"].data, (r2_tgt.height, r2_tgt.width))
    npix2 = r2_tgt.width * r2_tgt.height
    print(
        f"{tag} resample_in_space R2 (the R1 swath -> {r2_tgt.width}x{r2_tgt.height} "
        f"EPSG:32631 at 250 m, bilinear): first call {first:.3f} s (launches "
        f"{r2_counts}); warm median of 3 {w * 1e3:.2f} ms = {npix2 / w / 1e6:.1f} Mpix/s; "
        f"finite share {share:.4f}"
    )
    del out, ds_r1, r1_sw, r1_img, r1_src

    # K8 on a swath with a NaN row, onto a target reaching two tiles past
    # it (tiles no quad reaches keep empty windows); K7 and its list form
    # on a swath whose Phase B takes the SRW interior (NaN map cells at the
    # coverage edge), every method; K7 on the seven dtypes and K9 in both
    # modes on a small map
    ds_nan = olci_swath(1189, 1890, ("rad",))
    lat_nan = np.array(ds_nan["lat"].data)
    lat_nan[700] = nan
    ds_nan = ds_nan.assign_coords({"lat": DataArray(lat_nan, dims=("y", "x"))})
    nan_gm = GridMapping.from_dataset(ds_nan)
    reg = nan_gm.to_regular(tile_size=512)
    wide = GridMapping.regular(size=(reg.width + 1024, reg.height), xy_min=(reg.x_min, reg.y_min),
                               xy_res=reg.x_res, crs=reg.crs, tile_size=512)
    tiles = port_rectify._phase_a_tiles(nan_gm, wide)
    if not (tiles.ints[:, 6] == 0).any():
        raise AssertionError("the wide target has no empty tile window")
    sw = torch.from_numpy(np.stack([np.asarray(ds_nan["lon"].data), lat_nan])).to(dev)
    k10_check(sw, nan_gm, wide, "NaN row, empty tiles:")
    # about 5000 small tiles under a search border wider than one tile:
    # more than one launch's 3072
    small_tile = int(np.sqrt(reg.width * reg.height / 5000)) + 1
    many = GridMapping.regular(size=(reg.width, reg.height), xy_min=(reg.x_min, reg.y_min),
                               xy_res=reg.x_res, crs=reg.crs, tile_size=small_tile)
    k10_equal(sw[0], sw[1], many.xy_bboxes, port_rectify._tile_search_border(many),
              f"{len(many.xy_bboxes)} tiles of {small_tile}:",
              rows=np.random.default_rng(5).choice(len(many.xy_bboxes), 200, replace=False))
    m = rectify_ops.rectify_phase_a(sw, tiles, UV_DELTA)
    err["rectify_phase_a"] = max(err["rectify_phase_a"], compare(
        m, rectify_ops.rectify_phase_a_plain(sw, tiles, UV_DELTA), "exact",
        "K8 with a NaN row and empty tiles vs plain"))
    print(f"{tag} rectify_phase_a and ij_bboxes vs plain (and K10 vs the host's scan), NaN "
          f"swath row and {int((tiles.ints[:, 6] == 0).sum())} empty tile windows: equal; "
          f"K10 also on {len(many.xy_bboxes)} tiles of {small_tile} pixels (border "
          f"{port_rectify._tile_search_border(many) / reg.x_res:.1f} pixels; against its "
          f"plain version and, on 200 of its tiles, the host's scan)")
    del sw, m, ds_nan
    small = olci_swath(233, 307, ("rad",))
    small_gm = GridMapping.from_dataset(small)
    sm_tgt = small_gm.to_regular(tile_size=128)
    sw = torch.from_numpy(np.stack([np.asarray(small["lon"].data),
                                    np.asarray(small["lat"].data)])).to(dev)
    sm_map = rectify_ops.rectify_phase_a(sw, port_rectify._phase_a_tiles(small_gm, sm_tgt),
                                         UV_DELTA)
    x = small["rad"].data[None].expand(2, -1, -1).contiguous()
    x[1, 100] = nan
    for interp in METHODS:
        fn = rectify_ops.make_device_var_image_fn(sm_map, x.shape[-2:], nan, interp, device=dev)
        if interp != "nearest" and not isinstance(fn, rectify_ops.SRWPhaseB):
            raise AssertionError(f"the 233x307 swath's {interp} Phase B took no SRW interior")
        if isinstance(fn, rectify_ops.SRWPhaseB):
            v = fn.srw(x).to(torch.float32)
            lst = (fn.ix_e, fn.iy_e, fn.rows, fn.cols, interp, nan)
            err["ij_gather"] = max(err["ij_gather"], compare(
                rectify_ops.ij_gather_list(v.clone(), x, *lst),
                rectify_ops.ij_gather_list_plain(v.clone(), x, *lst), interp,
                f"K7 list form {interp} vs plain"))
        d = compare(fn(x), fn.plain(x), interp, f"233x307 Phase B {interp} vs plain")
        err["ij_gather"] = max(err["ij_gather"], d)
    rng = np.random.default_rng(3)
    ix = torch.from_numpy((rng.random((300, 280)) * 72 - 2).astype(np.float32)).to(dev)
    iy = torch.from_numpy((rng.random((300, 280)) * 66 - 2).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((300, 280)) < 0.9).to(dev)
    ij = torch.stack([ix.double() + 0.3, iy.double()]).clamp(min=0)
    ij[:, 3, 4:9] = nan
    for dtype in (torch.float32, torch.float64, torch.int8, torch.int16, torch.int32,
                  torch.uint8, torch.uint16):
        if dtype.is_floating_point:
            xs = torch.from_numpy(rng.random((2, 64, 68)) * 100).to(dtype).to(dev)
            xs[0, 5] = nan
        else:
            lo, hi = int_ranges[dtype]
            np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
            xs = torch.from_numpy(rng.integers(lo, hi, (2, 64, 68)).astype(np_dtype)).to(dev)
        for interp in METHODS:
            fill = 7 if interp == "nearest" and not dtype.is_floating_point else nan
            kind = "f64" if dtype == torch.float64 and interp != "nearest" else interp
            err["ij_gather"] = max(err["ij_gather"], compare(
                rectify_ops.ij_gather(xs, ix, iy, valid, interp, fill),
                rectify_ops.ij_gather_plain(xs, ix, iy, valid, interp, fill), kind,
                f"K7 {dtype} {interp} vs plain"))
            if dtype in (torch.float32, torch.float64, torch.uint16, torch.int16):
                f9 = nan if dtype.is_floating_point else 9
                err["exact_gather"] = max(err["exact_gather"], compare(
                    exact_gather.exact_gather_ij(xs, ij, f9, interp),
                    exact_gather.exact_gather_ij_plain(xs, ij, f9, interp), "exact",
                    f"K9 ij_map {dtype} {interp} vs plain"))
    win_src = GridMapping.regular(size=(96, 96), xy_min=(500000.0, 5400000.0), xy_res=100.0,
                                  crs="epsg:32632")
    win_tgt = GridMapping.regular(size=(100, 160), xy_min=(4247500.0, 2846000.0),
                                  xy_res=100.0, crs="epsg:3035", tile_size=48)
    inv = Transformer.from_crs(win_tgt.crs, win_src.crs, always_xy=True)
    win_plan = port_reproject._plan_source_windows(inv, win_src, win_tgt)
    wxx, wyy = port_reproject._target_centers_in_source(inv, win_tgt)
    for dtype in (torch.float32, torch.float64, torch.uint16, torch.int16):
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        xs = torch.from_numpy(rng.integers(0, 30000, (2, 96, 96)).astype(np_dtype)).to(dev)
        for interp in METHODS:
            fill = nan if dtype.is_floating_point else (65535 if dtype == torch.uint16 else -1)
            args = (win_src, win_tgt, wxx, wyy, win_plan, interp, fill)
            err["exact_gather"] = max(err["exact_gather"], compare(
                port_reproject._gather_through_windows(xs, *args),
                port_reproject._gather_through_windows(xs.cpu(), *args).to(dev), "exact",
                f"K9 windows {dtype} {interp} vs plain"))
    # K7 on maps that its output tiles make hard: each tile's positions
    # spread over the whole source, a map running backwards in both axes,
    # positions on the -0.5 / n - 0.5 bounds and a float32 ulp inside them;
    # the map form and the list form (every pixel, in reverse order)
    hh, ww = 300, 420
    mj, mi = np.mgrid[0:190, 0:670].astype(np.float64)
    f32 = np.float32
    edges_x = np.array([-0.5, ww - 0.5, np.nextafter(f32(-0.5), f32(1)),
                        np.nextafter(f32(ww - 0.5), f32(0)), 0.0, ww - 1.0, 0.5, ww - 1.5], f32)
    edges_y = np.array([-0.5, hh - 0.5, np.nextafter(f32(-0.5), f32(1)),
                        np.nextafter(f32(hh - 0.5), f32(0)), 0.0, hh - 1.0, 0.5, hh - 1.5], f32)
    hard_maps = {
        "wide": (rng.random(mj.shape) * ww - 0.5, rng.random(mj.shape) * hh - 0.5),
        "backwards": ((ww - 1.2) - mi * (ww / 670) + 0.07 * mj,
                      (hh - 0.9) - mj * (hh / 190) - 0.05 * mi),
        "bounds": (rng.choice(edges_x, mj.shape), rng.choice(edges_y, mj.shape)),
    }
    hard_valid = torch.from_numpy(rng.random(mj.shape) < 0.85).to(dev)
    flat = torch.arange(mj.size - 1, -1, -1, device=dev)
    rows_h, cols_h = (flat // 670).int(), (flat % 670).int()
    for dtype in (torch.float32, torch.float64, torch.uint16):
        if dtype.is_floating_point:
            xs = torch.from_numpy(rng.random((3, hh, ww)) * 100).to(dtype).to(dev)
            xs[1, 77] = nan
        else:
            xs = torch.from_numpy(rng.integers(0, 60000, (3, hh, ww)).astype(np.uint16)).to(dev)
        for case, (mx, my) in hard_maps.items():
            ix = torch.from_numpy(np.asarray(mx, np.float32)).to(dev)
            iy = torch.from_numpy(np.asarray(my, np.float32)).to(dev)
            for interp in METHODS:
                fill = 9 if interp == "nearest" and not dtype.is_floating_point else nan
                kind = "f64" if dtype == torch.float64 and interp != "nearest" else interp
                err["ij_gather"] = max(err["ij_gather"], compare(
                    rectify_ops.ij_gather(xs, ix, iy, hard_valid, interp, fill),
                    rectify_ops.ij_gather_plain(xs, ix, iy, hard_valid, interp, fill), kind,
                    f"K7 {case} map {dtype} {interp} vs plain"))
                lst = (ix.view(-1)[flat], iy.view(-1)[flat], rows_h, cols_h, interp, fill)
                empty = torch.zeros((3, 190, 670), dtype=rectify_ops.gather_dtype(
                    dtype, interp), device=dev)
                err["ij_gather"] = max(err["ij_gather"], compare(
                    rectify_ops.ij_gather_list(empty.clone(), xs, *lst),
                    rectify_ops.ij_gather_list_plain(empty.clone(), xs, *lst), kind,
                    f"K7 {case} list {dtype} {interp} vs plain"))
    # K8 on tile tables that its patches of PATCH_W x PATCH_H quads cut
    # unevenly: ragged windows, windows of one quad, one quad row and none,
    # a fold whose competing quads lie in other patches, NaN corners on
    # patch boundaries (window-local quad row 8 and column 32)
    def folded(h, w, fold_row, fold_col):
        j, i = np.mgrid[0:h, 0:w].astype(np.float64)
        ii = np.where(i < fold_col, i, 2 * fold_col - i) if fold_col else i
        jj = np.where(j < fold_row, j, 2 * fold_row - j) if fold_row else j
        return ii * 1.1 + 0.3 * np.sin(j / 3) + 0.01 * j, jj * 0.9 + 0.02 * i

    nan_x, nan_y = folded(40, 76, 0, 0)
    nan_x[9, :] = nan
    nan_y[:, 35] = nan
    nan_x[17, 35] = nan
    k8_cases = {
        "ragged windows": (folded(47, 83, 0, 0), [
            [0, 0, 24, 40, 0, 0, 45, 13], [0, 40, 24, 40, 37, 3, 46, 44],
            [24, 0, 24, 40, 1, 20, 33, 9], [24, 40, 24, 40, 30, 20, 53, 27]]),
        "2x2 and one-row windows": (folded(30, 80, 0, 0), [
            [0, 0, 24, 40, 3, 4, 2, 2], [0, 40, 24, 40, 36, 2, 44, 2],
            [24, 0, 24, 40, 0, 20, 70, 1], [24, 40, 24, 40, 40, 15, 1, 9]]),
        "fold across patches": (folded(40, 76, 19, 37), [
            [0, 0, 24, 40, 0, 0, 76, 40], [0, 40, 24, 40, 0, 0, 76, 40],
            [24, 0, 24, 40, 0, 0, 76, 40], [24, 40, 24, 40, 2, 1, 71, 37]]),
        "NaN on patch boundaries": ((nan_x, nan_y), [
            [0, 0, 24, 40, 3, 1, 70, 30], [0, 40, 24, 40, 3, 1, 70, 30],
            [24, 0, 24, 40, 0, 0, 76, 40], [24, 40, 24, 40, 3, 9, 40, 17]]),
    }
    for case, ((cx, cy), ints) in k8_cases.items():
        ints = np.array(ints, np.int64)
        tiles_c = rectify_ops.PhaseATiles(
            ints=ints, origins=np.stack([-0.3 + ints[:, 1] * 1.05, -0.2 + ints[:, 0] * 0.85], 1),
            x_scale=1.05, y_scale=0.85, tile_h=24, tile_w=40, n_tiles_x=2, out_h=48, out_w=80)
        sw_c = torch.from_numpy(np.stack([cx, cy])).to(dev)
        got = rectify_ops.rectify_phase_a(sw_c, tiles_c, UV_DELTA)
        err["rectify_phase_a"] = max(err["rectify_phase_a"], compare(
            got, rectify_ops.rectify_phase_a_plain(sw_c, tiles_c, UV_DELTA), "exact",
            f"K8 {case} vs plain", signs=True))
        if not torch.isfinite(got).any():
            raise AssertionError(f"K8 {case}: no pixel claimed")
    print(f"{tag} K7 vs plain on hard maps (wide, backwards, on the bounds; map and list "
          f"form; float32, float64, uint16, every method) and K8 vs plain on "
          f"{', '.join(k8_cases)}: equal within the tolerances")
    print(f"{tag} K7 vs plain (seven dtypes, every method, NaN map cells, the list form): "
          f"max abs diff {err['ij_gather']}; K9 vs plain (both modes, float32, float64, "
          f"uint16, int16, every method, fill padding): max abs diff {err['exact_gather']}")
    del small, sw, sm_map, x

    # R3: a full OLCI EFR-sized granule, 4865 x 4091 with 21 float32 bands
    # (made on the card), onto its default grid with 1024 tiles, bilinear
    r3_names = tuple(f"Oa{k + 1:02d}_radiance" for k in range(21))
    ds_r3 = olci_swath(4865, 4091, r3_names)
    r3_gm = GridMapping.from_dataset(ds_r3)
    r3_tgt = r3_gm.to_regular(tile_size=1024)
    r3_allow = phase_b_srw + ("ij_gather",)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, first = run_rectify(ds_r3, r3_gm.to_regular(tile_size=1024), "bilinear",
                             device_tier, allow=r3_allow)
    peak_mem = torch.cuda.max_memory_allocated()
    r3_counts = dict(LAUNCHES)
    if not (LAUNCHES["ij_gather"] or LAUNCHES["srw_horizontal"]):
        raise AssertionError(f"R3's Phase B launched nothing: {r3_counts}")
    del out
    out, w = warm_rectify(ds_r3, r3_tgt, "bilinear", device_tier, 2, allow=r3_allow)
    npix3 = r3_tgt.width * r3_tgt.height
    for name in r3_names[:1] + r3_names[-1:]:
        check_output(out[name].data, (r3_tgt.height, r3_tgt.width))
    r3_out0 = out[r3_names[0]].data
    del out
    with phase_a_tier("host"):
        out, first_h = run_rectify(ds_r3, r3_tgt, "bilinear", ("rectify_phase_a",),
                                   allow=r3_allow)
    share_h = check_output(out[r3_names[0]].data, (r3_tgt.height, r3_tgt.width))
    d_tiers = (out[r3_names[0]].data.double() - r3_out0.double()).abs().nan_to_num(0).max().item()
    if not torch.equal(torch.isnan(out[r3_names[0]].data), torch.isnan(r3_out0)):
        raise AssertionError("R3's coverage differs between the device and the host tier")
    print(
        f"{tag} resample_in_space R3 (4865x4091 granule, 21 float32 bands -> "
        f"{r3_tgt.width}x{r3_tgt.height}, 1024 tiles, bilinear): first call {first:.3f} s "
        f"(launches {r3_counts}); warm median of 2 {w:.3f} s = {21 * npix3 / w / 1e6:.1f} "
        f"Mpix/s over the 21 bands; device memory of the first call: peak "
        f"{peak_mem / 2**30:.3f} GiB, {(peak_mem - base_mem) / 2**30:.3f} GiB above the "
        f"{base_mem / 2**30:.3f} GiB held before it; under XRTPU_PHASEA=host one call "
        f"{first_h:.3f} s (finite share {share_h:.4f}; vs the device tier: NaN masks "
        f"equal, max abs diff {d_tiers:.3g}: the two Phase B plans' interiors differ)"
    )
    del out, r3_out0
    # K8, K7 and K9 against their plain versions at R3's shapes (2 bands)
    r3_tiles = port_rectify._phase_a_tiles(r3_gm, r3_tgt)
    sw = torch.from_numpy(np.stack([np.asarray(ds_r3["lon"].data),
                                    np.asarray(ds_r3["lat"].data)])).to(dev)
    k10_args = k10_check(sw, r3_gm, r3_tgt, "R3")
    r3_ops = k10_warm(k10_args, "R3")
    k10_r3 = (event_ms(lambda: bbox_ops.compute_ij_bboxes(*k10_args), 5),
              device_ms(lambda: bbox_ops.compute_ij_bboxes(*k10_args), 5))
    b10, by10 = k10_bound(sw, len(r3_tgt.xy_bboxes))
    print(f"{tag} ij_bboxes (K10) at R3 ({len(r3_tgt.xy_bboxes)} tiles; swath[1] 8 bytes off "
          f"16: {sw[1].data_ptr() % 16 == 8}): equal to its plain version and the host's "
          f"scan; {k10_r3[0]:.4f} ms (device {k10_r3[1]:.4f} ms), bound {b10:.4f} ms "
          f"({by10}); {r3_ops}")
    m = rectify_ops.rectify_phase_a(sw, r3_tiles, UV_DELTA)
    err["rectify_phase_a"] = max(err["rectify_phase_a"], compare(
        m, rectify_ops.rectify_phase_a_plain(sw, r3_tiles, UV_DELTA), "exact",
        "R3 K8 vs plain"))
    k8_r3 = (event_ms(lambda: rectify_ops.rectify_phase_a(sw, r3_tiles, UV_DELTA), 3),
             device_ms(lambda: rectify_ops.rectify_phase_a(sw, r3_tiles, UV_DELTA), 3))
    b8, by8, n_quads, n_cand = phase_a_bound(sw, r3_tiles)
    x = torch.stack([ds_r3[r3_names[0]].data, ds_r3[r3_names[1]].data])
    fn = rectify_ops.make_device_var_image_fn(m, x.shape[-2:], nan, "bilinear", device=dev)
    err["ij_gather"] = max(err["ij_gather"], compare(
        fn(x), fn.plain(x), "bilinear", "R3 2-band Phase B bilinear vs plain"))
    g7 = rectify_ops.make_device_var_image_fn(m, x.shape[-2:], nan, "nearest", device=dev)
    err["ij_gather"] = max(err["ij_gather"], compare(
        g7(x), g7.plain(x), "nearest", "R3 2-band K7 nearest vs plain"))
    rfn = rectify_ops.make_device_var_image_fn_resident(rectify_ops.DeviceIJMap(m), nan,
                                                        "bilinear")
    if not isinstance(rfn.impl(tuple(x.shape[-2:])), rectify_ops.SRWPhaseB):
        raise AssertionError("R3's resident Phase B took no SRW interior")
    err["ij_gather"] = max(err["ij_gather"], compare(
        rfn(x), rfn.plain(x), "bilinear", "R3 2-band resident Phase B bilinear vs plain"))
    err["exact_gather"] = max(err["exact_gather"], compare(
        exact_gather.exact_gather_ij(x, m, nan, "bilinear"),
        exact_gather.exact_gather_ij_plain(x, m, nan, "bilinear"), "exact",
        "R3 2-band K9 bilinear vs plain"))
    print(
        f"{tag} R3 kernels vs plain (K8, K7 via {type(fn).__name__} and the resident "
        f"SRWPhaseB, K9): equal within the "
        f"tolerances; rectify_phase_a at R3 ({len(r3_tiles.ints)} tiles): {k8_r3[0]:.3f} ms "
        f"(device {k8_r3[1]:.3f} ms), bound {b8:.4f} ms ({by8}; {n_quads} window quads, "
        f"{n_cand} candidate pixels)"
    )
    del ds_r3, sw, m, x, fn, g7, rfn
    torch.cuda.empty_cache()
    # the rest of the device Phase A ladder: K19-K21 at R1 and R3, the
    # NaN-row swath (K20) and the fallback (K10 and K8)
    pa_err, pa_timings, pa_bounds, pa_library, pa_r3 = phase_a_ladder_phase(
        dev, tag, SimpleNamespace(compare=compare, time_pair=time_pair, event_ms=event_ms,
                                  device_ms=device_ms, olci_swath=olci_swath,
                                  run_rectify=run_rectify, warm_rectify=warm_rectify,
                                  check_output=check_output, main_launches=main_launches,
                                  tree=tree_esw)
    )
    for name, e in pa_err.items():
        err[name] = max(err[name], e)
    timings.update(pa_timings)
    bounds.update(pa_bounds)
    library.update(pa_library)
    missing = [n for n in rectify_kernels + ("phase_a_walk", "phase_a_tiled")
               if rectify_launches[n] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the rectify route: {missing}")

    # -- 8. BASELINE #5: the sharded reproject and the tile stream -----------
    b5_launches, b5_err, b5_timings, b5_bounds, b5_library = baseline5(
        dev, tag, SimpleNamespace(compare=compare, time_pair=time_pair, event_ms=event_ms,
                                  device_ms=device_ms)
    )
    missing = [name for name in B5_KERNELS if b5_launches[name] < 1]
    if missing:
        raise AssertionError(f"band kernels never launched on the sharded path: {missing}")
    main_launches.update(b5_launches)
    err.update(b5_err)
    timings.update(b5_timings)
    bounds.update(b5_bounds)
    library.update(dict.fromkeys(B5_KERNELS, (None, None)))
    library["fused_reproject_band"] = b5_library["fused_reproject_band"]

    # -- 9. the sharded rectify: R1 and R3 over a mesh of 4 entries ----------
    sr_launches, sr_err, sr_timings, sr_bounds, sr_library, sr_r3 = sharded_rectify_phase(
        dev, tag, SimpleNamespace(compare=compare, time_pair=time_pair, event_ms=event_ms,
                                  device_ms=device_ms, olci_swath=olci_swath,
                                  phase_a_bound=phase_a_bound)
    )
    missing = [name for name in SR_KERNELS if sr_launches[name] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the sharded rectify: {missing}")
    main_launches.update(sr_launches)
    err.update(sr_err)
    timings.update(sr_timings)
    bounds.update(sr_bounds)
    library.update(sr_library)

    # -- 10. the dtypes: every new instantiation at full size ---------------
    dt_launches, dt_err, dt_timings, dt_bounds, dt_library, dt_extra = dtypes_phase(
        dev, tag, SimpleNamespace(compare=compare, event_ms=event_ms, device_ms=device_ms,
                                  dataset=dataset, check_output=check_output,
                                  olci_swath=olci_swath, tree=tree_esw)
    )
    main_launches.update(dt_launches)
    for name, e in dt_err.items():
        err[name] = max(err.get(name, 0.0), e)
    timings.update(dt_timings)
    bounds.update(dt_bounds)
    library.update(dt_library)

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
        "ij_gather": (
            "xcube_resampling_tpu_torch/csrc/ij_gather.cu",
            "xcube_resampling_tpu/ops/rectify_ops.py:2752",
        ),
        "rectify_phase_a": (
            "xcube_resampling_tpu_torch/csrc/rectify_phase_a.cu",
            "xcube_resampling_tpu/ops/rectify_ops.py:44",
        ),
        "exact_gather": (
            "xcube_resampling_tpu_torch/csrc/exact_gather.cu",
            "xcube_resampling_tpu/ops/rectify_ops.py:2767",
        ),
        "ij_bboxes": (
            "xcube_resampling_tpu_torch/csrc/ij_bboxes.cu",
            "xcube_resampling_tpu/ops/bbox_ops.py:16",
        ),
        "esw_gather": (
            "xcube_resampling_tpu_torch/csrc/esw_gather.cu",
            "xcube_resampling_tpu/ops/esw.py:616",
        ),
        "esw_gather_band": (
            "xcube_resampling_tpu_torch/csrc/esw_gather.cu",
            "xcube_resampling_tpu/parallel/halo.py:650",
        ),
        "srw_vertical_band": (
            "xcube_resampling_tpu_torch/csrc/srw_vertical.cu",
            "xcube_resampling_tpu/parallel/halo.py:423",
        ),
        "srw_horizontal_band": (
            "xcube_resampling_tpu_torch/csrc/srw_horizontal.cu",
            "xcube_resampling_tpu/parallel/halo.py:450",
        ),
        "fused_reproject_band": (
            "xcube_resampling_tpu_torch/csrc/fused_reproject.cu",
            "xcube_resampling_tpu/parallel/halo.py:169",
        ),
        "ij_gather_band": (
            "xcube_resampling_tpu_torch/csrc/ij_gather.cu",
            "xcube_resampling_tpu/parallel/halo.py:923",
        ),
        "hybrid_seed": (
            "xcube_resampling_tpu_torch/csrc/hybrid_phase_a.cu",
            "xcube_resampling_tpu/ops/rectify_ops.py:1812",
        ),
        "hybrid_dense": (
            "xcube_resampling_tpu_torch/csrc/hybrid_phase_a.cu",
            "xcube_resampling_tpu/ops/rectify_ops.py:1887",
        ),
        "srw_aligned_vertical": (
            "xcube_resampling_tpu_torch/csrc/srw_aligned.cu",
            "xcube_resampling_tpu/ops/srw.py:1086",
        ),
        "srw_aligned_horizontal": (
            "xcube_resampling_tpu_torch/csrc/srw_aligned.cu",
            "xcube_resampling_tpu/ops/srw.py:1120",
        ),
        "esw_mosaic": (
            "xcube_resampling_tpu_torch/csrc/esw_mosaic.cu",
            "xcube_resampling_tpu/ops/esw.py:1128",
        ),
        "srw_hybrid_vertical": (
            "xcube_resampling_tpu_torch/csrc/srw_aligned.cu",
            "xcube_resampling_tpu/ops/srw.py:1430",
        ),
        "srw_hybrid_horizontal": (
            "xcube_resampling_tpu_torch/csrc/srw_aligned.cu",
            "xcube_resampling_tpu/ops/srw.py:1480",
        ),
    }
    sources.update(LADDER_SOURCES)
    for name in dt_err:
        if name not in sources:
            file, replaces = DT_SOURCES[name.split(".")[0]]
            sources[name] = (f"xcube_resampling_tpu_torch/csrc/{file}", replaces)
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
            # (BASELINE #1), K6 torch.mode (BASELINE #2), K7 and its band
            # form F.grid_sample (R1, nearest), K3's band form F.grid_sample
            # (bilinear, band 1 past the gate); K8-K12, K19-K21 and K1's and
            # K2's band forms, K14, K15, K17, K18: none
            "library_ms": library[name][0],
            # the same calls queued behind a sleep: device time alone
            "device_ms": timings[name][2],
            "library_device_ms": library[name][1],
        }
        for name in err
    ]
    # K3 (and its band form) beside K13 (and its band form) on the ESW cell
    for k in kernels:
        k.update(esw_k3.get(k["name"], {}))
    # K1 on uint16 beside the float32 cast then the float32 K1
    for k in kernels:
        k.update(dt_extra.get(k["name"], {}))
    # K16's device ms beside its per-pixel path and the parent's kernel, in
    # turns
    next(k for k in kernels if k["name"] == "esw_mosaic").update(b3_staged)
    # K10 at R3 too (its ms, device_ms and bound above are R1's)
    k10_entry = next(k for k in kernels if k["name"] == "ij_bboxes")
    k10_entry.update(r3_ms=k10_r3[0], r3_device_ms=k10_r3[1], r3_bound_ms=b10)
    # the sharded rectify's and the ladder's kernels at R3 too (their entries
    # above are R1's)
    for k in kernels:
        k.update(sr_r3.get(k["name"], {}))
        k.update(pa_r3.get(k["name"], {}))
    # K14 and K15 at 4 bands, and the flagship's SRW variants beside them
    for name in FLAGSHIP_KERNELS:
        entry = next(k for k in kernels if k["name"] == name)
        entry.update({k[len(name) + 1:]: v for k, v in fl_variants.items()
                      if k.startswith(name + "_")})
    next(k for k in kernels if k["name"] == "srw_aligned_vertical").update(
        {k: v for k, v in fl_variants.items() if not k.startswith("srw_aligned")})
    # K17 and K18 at 4 bands, the ESW cell's and BASELINE #3's yardsticks
    for name in HYBRID_KERNELS:
        next(k for k in kernels if k["name"] == name).update(hy_yard[name])
    print(f"{tag} chip_smoke: {time.perf_counter() - t_start:.1f} s from its start, the "
          f"build included")
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
