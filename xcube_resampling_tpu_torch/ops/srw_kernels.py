"""K1 and K2: the separable-residual warp (SRW) tap passes.

``srw_vertical`` (K1, ``csrc/srw_vertical.cu``) replaces the Pallas kernel
``xcube_resampling_tpu/ops/pallas_kernels.py:srw_vertical_pallas`` and the
XLA vertical taps of ``ops/srw.py:make_srw_fn``; ``srw_horizontal`` (K2,
``csrc/srw_horizontal.cu``) replaces that function's XLA horizontal pass.
Each wrapper runs the plain PyTorch version beside it for CPU tensors and
launches its CUDA kernel for CUDA tensors, or raises; it never falls back.
The plain versions state the semantics: exactly ``d`` taps from the tile's
base, clamp-to-edge reads at true-position weights, zero-weight taps
included (so NaN reach matches the JAX package's XLA path), and the tap
sums rounded as fused multiply-adds, as XLA compiles them.

Layouts: ``src`` (B, src_h, src_w); ``pos_v`` (out_h, src_w) and ``base_v``
(out_h, n_col_tiles) with tile ``c // col_tile``; ``v`` (B, out_h, src_w);
``pos_h``, ``valid``, ``s`` (out_h, out_w) and ``base_h`` (n_row_tiles,
out_w) with tile ``j // row_tile``.
"""

from __future__ import annotations

import torch

from .. import _build
from .._device import count_launch, on_cpu, require_cuda

METHODS = {"bilinear": 0, "nearest": 1, "triangular": 2}

_F32 = torch.float32


def fma(a, b, c):
    """``a * b + c`` in float32 with one rounding, as a fused multiply-add
    (the product of two float32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def lerp(a, b, t):
    """``a + t * (b - a)`` rounded as XLA's contracted lerp."""
    return fma(t, b - a, a)


def method_code(interp_method: str) -> int:
    """The kernels' code for an interpolation method; raises for others."""
    try:
        return METHODS[interp_method]
    except KeyError:
        raise ValueError(
            f"SRW supports {sorted(METHODS)}, got {interp_method!r}"
        ) from None


def _weight(pos, k, interp_method):
    if interp_method == "nearest":
        # torch.round rounds half to even, like jnp.round
        return (torch.round(pos) == k).to(_F32)
    return torch.clamp_min(1.0 - torch.abs(pos - k), 0.0)


def _dweight(pos, k):
    # the (1, -1) mixed-difference taps of the triangular correction:
    # +1 at floor(pos), -1 at floor(pos) + 1
    f = torch.floor(pos)
    return (f == k).to(_F32) - (f + 1.0 == k).to(_F32)


def srw_vertical_plain(src, pos_v, base_v, col_tile, d_v, interp_method):
    """Plain PyTorch version of K1: ``(v, vd)``, ``vd`` None unless
    triangular."""
    method_code(interp_method)
    batch, src_h, src_w = src.shape
    out_h = pos_v.shape[0]
    tri = interp_method == "triangular"
    base = base_v.repeat_interleave(col_tile, dim=1)[:, :src_w].to(torch.int64)
    acc = torch.zeros((batch, out_h, src_w), dtype=_F32, device=src.device)
    acc_d = torch.zeros_like(acc) if tri else None
    for d in range(d_v):
        kk = base + d
        k = kk.to(_F32)
        idx = kk.clamp(0, src_h - 1).expand(batch, out_h, src_w)
        taken = torch.gather(src, 1, idx)
        acc = fma(_weight(pos_v, k, interp_method), taken, acc)
        if tri:
            acc_d = fma(_dweight(pos_v, k), taken, acc_d)
    return acc, acc_d


def srw_horizontal_plain(
    v, pos_h, base_h, row_tile, d_h, interp_method, valid, fill_value,
    vd=None, s=None,
):
    """Plain PyTorch version of K2: (B, out_h, out_w)."""
    method_code(interp_method)
    batch, out_h, src_w = v.shape
    out_w = pos_h.shape[1]
    tri = interp_method == "triangular"
    base = base_h.repeat_interleave(row_tile, dim=0)[:out_h].to(torch.int64)
    acc = torch.zeros((batch, out_h, out_w), dtype=_F32, device=v.device)
    acc_d = torch.zeros_like(acc) if tri else None
    for d in range(d_h):
        kk = base + d
        k = kk.to(_F32)
        idx = kk.clamp(0, src_w - 1).expand(batch, out_h, out_w)
        acc = fma(_weight(pos_h, k, interp_method), torch.gather(v, 2, idx), acc)
        if tri:
            acc_d = fma(_dweight(pos_h, k), torch.gather(vd, 2, idx), acc_d)
    if tri:
        acc = fma(-s, acc_d, acc)
    fill = torch.tensor(fill_value, dtype=_F32, device=v.device)
    return torch.where(valid, acc, fill)


def _ptr(t):
    return None if t is None else t.data_ptr()


def srw_vertical(src, pos_v, base_v, col_tile, d_v, interp_method):
    """K1: the vertical tap pass, ``(v, vd)``; see the module docstring."""
    if on_cpu(src, pos_v, base_v):
        return srw_vertical_plain(src, pos_v, base_v, col_tile, d_v, interp_method)
    method = method_code(interp_method)
    if col_tile < 1 or d_v < 1:
        raise ValueError(f"col_tile and d_v must be positive: {col_tile}, {d_v}")
    batch, src_h, src_w = src.shape
    out_h = pos_v.shape[0]
    n_col_tiles = -(-src_w // col_tile)
    require_cuda(src, "src", _F32, (batch, src_h, src_w))
    require_cuda(pos_v, "pos_v", _F32, (out_h, src_w))
    require_cuda(base_v, "base_v", torch.int32, (out_h, n_col_tiles))
    v = torch.empty((batch, out_h, src_w), dtype=_F32, device=src.device)
    vd = torch.empty_like(v) if interp_method == "triangular" else None
    if v.numel() == 0:
        return v, vd
    lib = _build.load()
    with torch.cuda.device(src.device):
        rc = lib.xrt_srw_vertical_f32(
            src.data_ptr(), pos_v.data_ptr(), base_v.data_ptr(),
            v.data_ptr(), _ptr(vd), batch, src_h, src_w, out_h,
            n_col_tiles, col_tile, d_v, method,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "srw_vertical")
    count_launch("srw_vertical")
    return v, vd


def srw_horizontal(
    v, pos_h, base_h, row_tile, d_h, interp_method, valid, fill_value,
    vd=None, s=None,
):
    """K2: the horizontal tap pass, triangular correction and fill select
    (B, out_h, out_w); ``vd`` and ``s`` are required for triangular."""
    tri = interp_method == "triangular"
    if tri and (vd is None or s is None):
        raise ValueError("triangular needs vd and s")
    extra = (vd, s) if tri else ()
    if on_cpu(v, pos_h, base_h, valid, *extra):
        return srw_horizontal_plain(
            v, pos_h, base_h, row_tile, d_h, interp_method, valid, fill_value,
            vd, s,
        )
    method = method_code(interp_method)
    if row_tile < 1 or d_h < 1:
        raise ValueError(f"row_tile and d_h must be positive: {row_tile}, {d_h}")
    batch, out_h, src_w = v.shape
    out_w = pos_h.shape[1]
    n_row_tiles = -(-out_h // row_tile)
    require_cuda(v, "v", _F32, (batch, out_h, src_w))
    require_cuda(pos_h, "pos_h", _F32, (out_h, out_w))
    require_cuda(base_h, "base_h", torch.int32, (n_row_tiles, out_w))
    require_cuda(valid, "valid", torch.bool, (out_h, out_w))
    if tri:
        require_cuda(vd, "vd", _F32, (batch, out_h, src_w))
        require_cuda(s, "s", _F32, (out_h, out_w))
    out = torch.empty((batch, out_h, out_w), dtype=_F32, device=v.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(v.device):
        rc = lib.xrt_srw_horizontal_f32(
            v.data_ptr(), _ptr(vd if tri else None), pos_h.data_ptr(),
            base_h.data_ptr(), valid.data_ptr(), _ptr(s if tri else None),
            out.data_ptr(), batch, out_h, out_w, src_w, row_tile, d_h,
            method, float(fill_value),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "srw_horizontal")
    count_launch("srw_horizontal")
    return out
