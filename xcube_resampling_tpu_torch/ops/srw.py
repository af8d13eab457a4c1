"""The tiled separable-residual warp (SRW) tier on PyTorch tensors.

Port of ``xcube_resampling_tpu/ops/srw.py``: ``make_srw_fn`` (:570-753) and
the tiled branch of ``make_srw_reproject_fn`` (:1550-1685).  The numpy
planners (``_coarse_geometry``, ``_source_window_gm``, the curvature and
two-pass gates, ``plan_srw``) are the JAX package's own, imported and not
copied; :func:`plan_to_device` carries their :class:`SRWPlan` onto the
device.  Each call runs one launch of K1 (vertical pass, all column tiles)
and one of K2 (horizontal pass, triangular correction, fill select).

Where the JAX package's cost model would pick its aligned or hybrid
strategy, this port takes the tiled plan whenever one exists: it passes
the same gates and so holds the same two-pass contract.  The batched
tiled formulation (``make_srw_fn_batched``) exists in JAX only to keep its
compile small; here one kernel launch covers every tile either way.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from xcube_resampling_tpu.gridmapping import GridMapping
from xcube_resampling_tpu.ops.srw import (
    SRWPlan,
    _coarse_geometry,
    _fields_interp_err,
    _source_window_gm,
    _twopass_slope,
    plan_srw,
)

from .reproject_ops import STEP, interp_field
from .srw_kernels import (
    METHODS,
    method_code,
    srw_horizontal,
    srw_horizontal_plain,
    srw_vertical,
    srw_vertical_plain,
)


@dataclass
class SRWState:
    """A tiled :class:`SRWPlan` on the device: coarse fields (float32) and
    per-tile tap bases (int32) as tensors, plus the plan's scalars."""

    iystar_c: torch.Tensor  # (ncj, ncc)
    ix_c: torch.Tensor  # (ncj, nci)
    iy_c: torch.Tensor  # (ncj, nci)
    base_v: torch.Tensor  # (out_h, n_col_tiles)
    base_h: torch.Tensor  # (n_row_tiles, out_w)
    d_v: int
    col_tile: int
    d_h: int
    row_tile: int
    step: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def plan_to_device(plan: SRWPlan, device) -> SRWState:
    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return SRWState(
        iystar_c=f32(plan.iystar_c),
        ix_c=f32(plan.ix_c),
        iy_c=f32(plan.iy_c),
        base_v=i32(plan.base_v),
        base_h=i32(plan.base_h),
        d_v=int(plan.d_v),
        col_tile=int(plan.col_tile),
        d_h=int(plan.d_h),
        row_tile=int(plan.row_tile),
        step=int(plan.step),
        src_h=int(plan.src_h),
        src_w=int(plan.src_w),
        out_h=int(plan.out_h),
        out_w=int(plan.out_w),
    )


def precompute(state: SRWState, triangular: bool):
    """Per-pixel tap positions ``pos_v`` (out_h, src_w) and ``pos_h``
    (out_h, out_w), the validity mask and, for triangular, the correction
    weight ``s`` (else None): functions of the geometry alone, built once
    per plan on the state's device (``srw.py:609-632``)."""
    p = state
    dev = p.ix_c.device
    rows = torch.arange(p.out_h, dtype=torch.float32, device=dev)[:, None]
    cols_src = torch.arange(p.src_w, dtype=torch.float32, device=dev)[None, :]
    pos_v = interp_field(p.iystar_c, rows, cols_src, p.step)
    cols = torch.arange(p.out_w, dtype=torch.float32, device=dev)[None, :]
    pos_h = interp_field(p.ix_c, rows, cols, p.step)
    iy_full = interp_field(p.iy_c, rows, cols, p.step)
    valid = (
        (pos_h > -0.5)
        & (pos_h < p.src_w - 0.5)
        & (iy_full > -0.5)
        & (iy_full < p.src_h - 0.5)
    )
    if not triangular:
        return pos_v, pos_h, valid, None
    # triangular = bilinear - s * Delta with s = min(uv, (1-u)(1-v))
    u = pos_h - torch.floor(pos_h)
    vf = iy_full - torch.floor(iy_full)
    s = torch.minimum(u * vf, (1.0 - u) * (1.0 - vf))
    return pos_v, pos_h, valid, s


class SRWFn:
    """``fn(src) -> target`` through K1 then K2; ``fn.plain(src)`` through
    their plain versions.  ``src`` is (..., H, W) float32 on the state's
    device; ``window`` (j0, j1, i0, i1), when set, crops it first."""

    def __init__(self, state: SRWState, interp_method: str, fill_value):
        method_code(interp_method)
        self.state = state
        self.interp_method = interp_method
        self.fill_value = float(fill_value)
        self.window = None
        self.pos_v, self.pos_h, self.valid, self.s = precompute(
            state, interp_method == "triangular"
        )

    def crop(self, src):
        """The (B, src_h, src_w) contiguous source the kernels read."""
        if self.window is not None:
            j0, j1, i0, i1 = self.window
            src = src[..., j0:j1, i0:i1]
        st = self.state
        if tuple(src.shape[-2:]) != (st.src_h, st.src_w):
            raise ValueError(
                f"source window {tuple(src.shape[-2:])} is not the planned "
                f"{(st.src_h, st.src_w)}"
            )
        return src.reshape(-1, st.src_h, st.src_w).contiguous()

    def _run(self, src, vertical, horizontal):
        st = self.state
        v, vd = vertical(
            self.crop(src), self.pos_v, st.base_v, st.col_tile, st.d_v,
            self.interp_method,
        )
        out = horizontal(
            v, self.pos_h, st.base_h, st.row_tile, st.d_h, self.interp_method,
            self.valid, self.fill_value, vd, self.s,
        )
        return out.reshape(src.shape[:-2] + out.shape[-2:])

    def __call__(self, src):
        return self._run(src, srw_vertical, srw_horizontal)

    def plain(self, src):
        return self._run(src, srw_vertical_plain, srw_horizontal_plain)


def make_srw_fn(
    plan: SRWPlan, interp_method: str = "bilinear", fill_value=np.nan,
    device="cpu",
) -> SRWFn:
    """The tiled SRW reprojection of *plan* with its statics on *device*."""
    return SRWFn(plan_to_device(plan, device), interp_method, fill_value)


# The curvature gate's limit on the estimated position interpolation
# error, in source pixels: the default of the JAX package's
# make_srw_reproject_fn (srw.py:1557).
POS_TOL = 0.5


def make_srw_reproject_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    device="cpu",
) -> SRWFn | None:
    """Crop, gate and plan the tiled SRW tier, or None where the JAX
    package's gates refuse it (callers then use K3)."""
    if interp_method not in METHODS:
        return None
    fields = _coarse_geometry(source_gm, target_gm, STEP)
    if fields is None:
        return None
    # crop the source to the window the target taps (srw.py:1585-1611)
    w = _source_window_gm(source_gm, fields, margin=8 + 48)
    if w is not None:
        win_gm, (j0, j1, i0, i1) = w
        inner = make_srw_reproject_fn(
            win_gm, target_gm, interp_method, fill_value, device
        )
        if inner is not None:
            if inner.window is None:
                inner.window = (j0, j1, i0, i1)
            else:
                a0, a1, b0, b1 = inner.window
                inner.window = (j0 + a0, j0 + a1, i0 + b0, i0 + b1)
        return inner
    # the curvature gate and the two-pass fidelity gate (srw.py:1614-1629)
    if _fields_interp_err(fields) > POS_TOL:
        return None
    if _twopass_slope(fields) > 0.2:
        return None
    plan = plan_srw(source_gm, target_gm, step=STEP, fields=fields)
    if plan is None:
        return None
    return make_srw_fn(plan, interp_method, fill_value, device)
