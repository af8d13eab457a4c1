"""K2's float64 form on the CPU: the float64 instantiation of K2's kernel
(``csrc/srw_horizontal.cu``, ``srw_horizontal_kernel`` on double values),
emulated task by task as the kernel runs it, against its plain version and
the JAX package's float64 tiled SRW, bit for bit.

The emulation stages each (row, band) window row of the warp's 128-column
segment as the host planned it, takes the exact two-tap shortcut where
the row is finite (one float64 fused multiply-add of the widened float32
weight a tap, onto +0) and sums every tap where it is not, and applies the
triangular correction and the fill as the kernel does.  Cases: nearest,
bilinear and triangular; float64 data with a NaN row (a window row that
is not finite); d_h from 2 (a plan's base set two taps wide) to 27; the
band form at ``row0`` > 0 (a row tile as a band of its own, held to the
single-chip rows).  Also the launch plan for 8-byte words.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as xrt  # noqa: E402
import xcube_resampling_tpu_torch as port  # noqa: E402
from xcube_resampling_tpu.ops import srw as jax_srw  # noqa: E402
from xcube_resampling_tpu_torch.ops import reproject_ops, srw_kernels  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as port_srw  # noqa: E402

METHODS = ("bilinear", "nearest", "triangular")
UTM = dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632")
LAEA = dict(size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035")
GEO = dict(size=(48, 48), xy_min=(30.0, 60.0), xy_res=0.05, crs="epsg:4326")
LAEA_KM = dict(size=(48, 48), xy_min=(5400000, 4200000), xy_res=2500, crs="epsg:3035")
# (source, target, plan_srw's row_tile, d_h forced or None): d_h 2 (the
# UTM plan's bases two taps wide), 5, 18 and 27 (the 18-tap plan's bases
# 27 taps wide)
GEOMETRIES = {
    2: (UTM, LAEA, 16, 2),
    5: (UTM, LAEA, 16, None),
    18: (GEO, LAEA_KM, 16, None),
    27: (GEO, LAEA_KM, 16, 27),
}


def _plans(d_h):
    """The JAX package's and the port's tiled plans of a geometry, with
    d_h *d_h*."""
    src, tgt, row_tile, force = GEOMETRIES[d_h]
    plans = []
    for pkg, mod in ((xrt, jax_srw), (port, port_srw)):
        plan = mod.plan_srw(pkg.GridMapping.regular(**src), pkg.GridMapping.regular(**tgt),
                            row_tile=row_tile, max_taps=64, tap_budget=64)
        plans.append(plan if force is None else dataclasses.replace(plan, d_h=force))
    assert plans[1].d_h == d_h
    return plans


def _data(plan, seed=3):
    """Two float64 bands of the plan's source window: normal values at
    generic magnitudes, one row NaN in the last band."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, plan.src_h, plan.src_w)) * 100.0
    x[1, plan.src_h // 3] = np.nan
    return x


@functools.lru_cache(maxsize=None)
def _jax_ref(d_h, method):
    """JAX's float64 tiled SRW (``make_srw_fn``) on :func:`_data` of the
    geometry with d_h *d_h*."""
    jplan, plan = _plans(d_h)
    ref = np.asarray(jax_srw.make_srw_fn(jplan, method, np.nan)(jnp.asarray(_data(plan))))
    assert ref.dtype == np.float64 and np.isfinite(ref).mean() > 0.3
    return ref


def _tap_sums(window, pos, t0, b0, d_h, finite, method):
    """``srw_common.h``'s ``tap_sums`` on float64 values: one row's outputs
    at float32 positions *pos* from their staged window row, each output's
    taps from window column *t0* (tap index *b0*); the two-tap shortcut
    where the row is *finite*, every tap otherwise; (acc, acc_d)."""
    fma = reproject_ops.fma64
    zero = torch.zeros(pos.shape, dtype=torch.float64)
    fp = torch.floor(pos)
    if finite:
        if method == "nearest":
            t = torch.round(pos).long() - b0
            inside = (t >= 0) & (t < d_h)
            s = window[t0 + t.clamp(0, d_h - 1)]
            return torch.where(inside, fma(torch.ones_like(s), s, zero), zero), zero
        t = fp.long() - b0
        acc, acc_d = zero, zero
        for d, sign in ((0, 1.0), (1, -1.0)):
            inside = (t + d >= 0) & (t + d < d_h)
            s = window[t0 + (t + d).clamp(0, d_h - 1)]
            w = torch.clamp_min(1.0 - torch.abs(pos - (fp + d)), 0.0).double()
            acc = torch.where(inside, fma(w, s, acc), acc)
            acc_d = torch.where(inside, fma(torch.full_like(s, sign), s, acc_d), acc_d)
        return acc, acc_d
    acc, acc_d = zero, zero
    for d in range(d_h):
        k = (b0 + d).to(torch.float32)
        s = window[t0 + d]
        if method == "nearest":
            w = (torch.round(pos) == k).to(torch.float32)
        else:
            w = torch.clamp_min(1.0 - torch.abs(pos - k), 0.0)
        acc = fma(w.double(), s, acc)
        dw = (fp == k).to(torch.float32) - (fp + 1.0 == k).to(torch.float32)
        acc_d = fma(dw.double(), s, acc_d)
    return acc, acc_d


def _emulated(v, ix_c, iy_c, step, base_h, row_tile, d_h, src_h, win, method, fill, vd,
              row0=0):
    """K2's kernel on float64 ``v`` as it takes the work apart: a warp a
    task of 16 rows by one ``BAND_COLS``-column segment; for each (row,
    band) the window of the row's tile and the segment staged, every column
    clamped into the row, the row's finiteness deciding the shortcut;
    asserts that every output's taps lie in its window."""
    batch, out_h, src_w = v.shape
    out_w = base_h.shape[1]
    seg = srw_kernels.BAND_COLS
    tri = method == "triangular"
    pos, valid, corr = srw_kernels._horizontal_geometry(
        ix_c, iy_c, step, out_h, out_w, src_h, src_w, tri, row0)
    out = torch.full((batch, out_h, out_w), -7.0, dtype=torch.float64)
    for cb in range(-(-out_w // seg)):
        cols = torch.arange(cb * seg, min(cb * seg + seg, out_w))
        for j in range(out_h):
            t = j // row_tile
            lo, hi = (int(x) for x in win.lohi[t, cb])
            b0 = base_h[t, cols].long()
            assert (b0 >= lo).all() and (b0 + d_h <= hi).all()
            idx = torch.arange(lo, hi).clamp(0, src_w - 1)
            for b in range(batch):
                rows = [v[b, j, idx]] + ([vd[b, j, idx]] if tri else [])
                finite = all(bool(torch.isfinite(r).all()) for r in rows)
                acc, _ = _tap_sums(rows[0], pos[j, cols], b0 - lo, b0, d_h, finite, method)
                if tri:
                    _, acc_dd = _tap_sums(rows[1], pos[j, cols], b0 - lo, b0, d_h, finite,
                                          method)
                    acc = reproject_ops.fma64(-corr[j, cols].double(), acc_dd, acc)
                out[b, j, cols] = torch.where(valid[j, cols], acc,
                                              torch.tensor(fill, dtype=torch.float64))
    return out


@pytest.mark.parametrize("method, d_h", [
    ("bilinear", 2), ("nearest", 2), ("nearest", 5), ("triangular", 5), ("bilinear", 18),
    ("triangular", 27),
])
def test_float64_form_equals_jax(method, d_h):
    """The emulated float64 kernel equals K2's plain version and the output
    of JAX's float64 tiled SRW (``make_srw_fn``) bit for bit, through a
    NaN row, at every d_h."""
    _, plan = _plans(d_h)
    x = _data(plan)
    ref = _jax_ref(d_h, method)
    fn = port_srw.make_srw_fn(plan, method, np.nan, device="cpu")
    v, vd = srw_kernels.srw_vertical_plain(*fn.vertical_args(fn.crop(torch.from_numpy(x))))
    assert v.dtype == torch.float64
    h_args = fn.horizontal_args(v)
    plain = srw_kernels.srw_horizontal_plain(*h_args, vd)
    got = _emulated(*h_args, vd)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy().reshape(ref.shape), ref)


@pytest.mark.parametrize("method", METHODS)
def test_float64_band_form_equals_jax_rows(method):
    """The band form at row0 > 0: each row tile after the first as a band of
    its own (its windows planned from its bases), emulated, equals those
    rows of JAX's float64 tiled SRW bit for bit."""
    _, plan = _plans(5)
    x = _data(plan)
    ref = _jax_ref(5, method)
    fn = port_srw.make_srw_fn(plan, method, np.nan, device="cpu")
    v, vd = srw_kernels.srw_vertical_plain(*fn.vertical_args(fn.crop(torch.from_numpy(x))))
    st = fn.state
    rt = st.row_tile
    assert st.out_h > 2 * rt
    for k in range(1, -(-st.out_h // rt)):
        rows = slice(k * rt, min((k + 1) * rt, st.out_h))
        base = st.base_h[k:k + 1]
        win = srw_kernels.plan_horizontal_windows(base.numpy(), rt, st.d_h)
        args = (v[:, rows], st.ix_c, st.iy_c, st.step, base, rt, st.d_h, st.src_h, win, method,
                np.nan, None if vd is None else vd[:, rows], k * rt)
        got = _emulated(*args)
        np.testing.assert_array_equal(got.numpy(), srw_kernels.srw_horizontal_band_plain(
            *args[:11], args[11], args[12]).numpy())
        np.testing.assert_array_equal(got.numpy(), ref[:, rows])


# (batch, extent, triangular) -> K2's float64 launch (bands an item, stages,
# warps a block), None where one window row does not fit
_F64_LAUNCHES = [
    ((4, 84, False), (4, 3, 4)),  # BASELINE #5's band: 3 stages of 4 bands
    ((1, 144, False), (1, 3, 4)),  # the headline's d_h 12 on one band
    ((2, 84, True), (2, 3, 4)),
    ((4, 1040, False), (1, 3, 4)),  # a downscale: one band an item
    ((1, 20000, False), (1, 1, 1)),  # past the block's most: 1 stage, 1 warp
    ((1, 30000, False), None),
    ((1, 15000, True), None),
]


@pytest.mark.parametrize("case, want", _F64_LAUNCHES)
def test_float64_launch_sizes_the_ring_for_8_byte_words(case, want):
    """K2's launch plan for float64: the float32 rule on 8-byte words, its
    ring under the SM's share for the blocks the float64 kernel's
    registers allow; ValueError where one window row does not fit."""
    batch, extent, tri = case
    if want is None:
        with pytest.raises(ValueError):
            srw_kernels.plan_band_launch(batch, extent, tri, word=8)
        return
    launch = srw_kernels.plan_band_launch(batch, extent, tri, word=8)
    assert (launch.group, launch.stages, launch.warps) == want
    row = 8 * extent * (2 if tri else 1)
    assert launch.smem == launch.warps * launch.stages * launch.group * row
    assert launch.smem <= srw_kernels.SMEM_BLOCK_MAX
    if launch.group > 1:
        per_sm = (srw_kernels.SMEM_SM // srw_kernels.BAND_MIN_BLOCKS_F64[tri]
                  - srw_kernels.SMEM_RESERVED)
        assert launch.smem <= per_sm
