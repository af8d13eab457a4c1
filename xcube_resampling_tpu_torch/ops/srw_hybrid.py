"""K17 and K18: the hybrid separable-residual warp's tap passes.

``srw_hybrid_vertical`` (K17) and ``srw_hybrid_horizontal`` (K18) replace
the XLA kernel of ``xcube_resampling_tpu/ops/srw.py:make_srw_hybrid_fn``
(:1430-1478 and :1480-1535).  That kernel pads the source by edge rows,
shifts each source column up by ``s_v[c]`` rows with log2 roll and select
passes that repeat the last row, and sums taps in the shifted space from
one base per output row and column tile (vertical); then the same along
the rows of the result with one base per row tile and output column
(horizontal).  Since every base lies within the padding (``base_v.min() >=
r_lo`` and ``base_v.max() + d_v <= src_h + r_hi``), the take's clip never
bites, and the padding, the shift passes and the take compose to one
clamped index: the aligned SRW's passes with a base a tile.  So K17 and
K18 are K14's and K15's kernels (``csrc/srw_aligned.cu``) launched with
the plan's tiles, counted under their own names: the staged vertical
kernel (taps staged in shifted space, its launch planned on the
host once a geometry and carried by the state, the direct kernel where a
span does not fit) and the horizontal kernel reading its taps through
L1, exactness from the vertical kernel's flags, each taking the exact
two-tap shortcut where a window of taps is finite
(``ops/srw_aligned.py``).
With ``t = c // col_tile`` and ``u = r // row_tile``:

* K17: ``pos = P(r, c) - s_v[c]`` with ``P`` the coarse field ``iystar_c``
  interpolated at (r, c), and ``v[b, r, c] = sum_d w(pos, base_v[r, t] +
  d) * src[b, clamp(base_v[r, t] + d + s_v[c], 0, src_h - 1), c]``;
* K18: ``pos = Q(r, c) - s_h[r]`` with ``Q`` the interpolated ``ix_c``,
  the taps ``v[b, r, clamp(base_h[u, c] + d + s_h[r], 0, src_w - 1)]``,
  and the fill where the validity test on the unshifted ``ix`` and ``iy``
  fails (``srw.py:1408-1413``).

The JAX package materialises the positions and the validity once per
geometry in a jit of their own (``precompute``, :1392-1424); the kernels
interpolate the coarse fields themselves, which rounds the same float32
values.  Weights and the order of the tap sums are the aligned SRW's, so
the kernels equal their plain versions and the JAX package bit for bit.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises.  Layouts: ``src`` (B, src_h, src_w);
``iystar_c`` (ncj, ncc), ``ix_c`` and ``iy_c`` (ncj, nci) sampled every
``step`` target pixels; ``s_v`` (src_w,), ``base_v`` (out_h, n_col_tiles),
``s_h`` (out_h,), ``base_h`` (n_row_tiles, out_w), all int32; ``v`` (B,
out_h, src_w).
"""

from __future__ import annotations

import torch

from .._device import on_cpu
from .srw_aligned import horizontal_plain, launch_horizontal, launch_vertical, vertical_plain

# the most taps a pass sums: plan_srw_hybrid's max_taps (srw.py:1204)
MAX_TAPS = 32


def srw_hybrid_vertical_plain(src, iystar_c, step, s_v, base_v, col_tile, d_v, interp_method):
    """Plain PyTorch version of K17: ``v`` (B, out_h, src_w)."""
    tile = torch.arange(src.shape[-1], device=src.device) // col_tile
    base = base_v.to(torch.int64)[:, tile]
    return vertical_plain(src, iystar_c, step, s_v, base, d_v, interp_method)


def srw_hybrid_horizontal_plain(
    v, ix_c, iy_c, step, s_h, base_h, row_tile, d_h, src_h, interp_method, fill_value
):
    """Plain PyTorch version of K18: (B, out_h, out_w)."""
    tile = torch.arange(v.shape[-2], device=v.device) // row_tile
    base = base_h.to(torch.int64)[tile, :]
    return horizontal_plain(
        v, ix_c, iy_c, step, s_h, base, d_h, src_h, interp_method, fill_value
    )


def srw_hybrid_vertical(src, iystar_c, step, s_v, base_v, col_tile, d_v, interp_method,
                        win_v=None, with_flags=False):
    """K17: the hybrid vertical pass, ``v``, or with *with_flags* ``(v,
    flags)`` (flags None on the CPU); *win_v* the state's plan
    (``srw_aligned.launch_vertical``); see the module docstring."""
    if on_cpu(src, iystar_c, s_v, base_v):
        v = srw_hybrid_vertical_plain(src, iystar_c, step, s_v, base_v, col_tile, d_v,
                                      interp_method)
        return (v, None) if with_flags else v
    return launch_vertical(
        "srw_hybrid_vertical", src, iystar_c, step, s_v, base_v, col_tile, d_v,
        interp_method, MAX_TAPS, win_v, with_flags,
    )


def srw_hybrid_horizontal(
    v, ix_c, iy_c, step, s_h, base_h, row_tile, d_h, src_h, interp_method, fill_value,
    flags=None,
):
    """K18: the hybrid horizontal pass and the fill select, (B, out_h,
    out_w); *src_h* is the source's height, for the validity test;
    *flags* K17's flags of *v*, where it wrote them."""
    if on_cpu(v, ix_c, iy_c, s_h, base_h):
        return srw_hybrid_horizontal_plain(
            v, ix_c, iy_c, step, s_h, base_h, row_tile, d_h, src_h, interp_method, fill_value
        )
    return launch_horizontal(
        "srw_hybrid_horizontal", v, ix_c, iy_c, step, s_h, base_h, row_tile, d_h, src_h,
        interp_method, fill_value, MAX_TAPS, flags,
    )
