"""The port's kernels (xcube_resampling_tpu_torch) against the JAX package.

On the CPU every kernel wrapper runs its plain PyTorch version; the CUDA
kernels are held against those plain versions on the GPU by
``chip_smoke.py``.  Inputs are made from a numpy seed and fed to both
packages, each side built from its own package's grid mappings; each
comparison states its tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu.ops.pallas_kernels import (  # noqa: E402
    srw_vertical_pallas,
    srw_vertical_reference,
)
from xcube_resampling_tpu.ops.reproject_ops import (  # noqa: E402
    _interp_field as jax_interp_field,
    make_fused_reproject_fn as jax_make_fused_reproject_fn,
)
from xcube_resampling_tpu.ops.srw import (  # noqa: E402
    make_srw_fn as jax_make_srw_fn,
    plan_srw as jax_plan_srw,
)
from xcube_resampling_tpu_torch import _build  # noqa: E402
from xcube_resampling_tpu_torch._device import LAUNCHES, on_cpu  # noqa: E402
from xcube_resampling_tpu_torch.ops import coarsen_ops, gather, reproject_ops  # noqa: E402
from xcube_resampling_tpu_torch.ops.reproject_ops import (  # noqa: E402
    fused_reproject,
    make_fused_reproject_fn,
)
from xcube_resampling_tpu_torch.ops.srw import (  # noqa: E402
    make_srw_fn,
    plan_srw,
    plan_to_device,
)
from xcube_resampling_tpu_torch.ops.srw_kernels import (  # noqa: E402
    SMEM_BUDGET,
    plan_horizontal_windows,
    plan_vertical_windows,
    srw_horizontal,
    srw_horizontal_plain,
    srw_vertical,
    srw_vertical_plain,
)

METHODS = ["bilinear", "nearest", "triangular"]
STEP = 16

# (source, target) arguments of GridMapping.regular: the 96^2 UTM32N ->
# 80^2 EPSG:3035 case of tests/test_srw.py, and a target that reaches past
# the source's top and bottom (its K1 windows clip at both edges)
GEOMETRIES = {
    "utm_laea": (
        dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"),
        dict(size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035"),
    ),
    "edge": (
        dict(size=(96, 96), xy_min=(500000.0, 5400000.0), xy_res=100.0, crs="epsg:32632"),
        dict(size=(100, 160), xy_min=(4247500.0, 2846000.0), xy_res=100.0, crs="epsg:3035"),
    ),
}


def _gms(pkg, geometry="utm_laea"):
    src, tgt = GEOMETRIES[geometry]
    return pkg.GridMapping.regular(**src), pkg.GridMapping.regular(**tgt)


def _plans(geometry="utm_laea", tile=32):
    """The same tiled plan from each package's own planner."""
    ref = jax_plan_srw(*_gms(jx, geometry), col_tile=tile, row_tile=tile)
    got = plan_srw(*_gms(pt, geometry), col_tile=tile, row_tile=tile)
    assert ref is not None and got is not None
    return ref, got


def _assert_match(got, ref, atol=0.0):
    """Equal NaN masks; equal values where *atol* is 0, else within it."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    if atol == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=atol, equal_nan=True)


def _vertical_case(d_taps, seed=7):
    """Inputs like tests/test_pallas_kernels.py's, with the positions given
    as a coarse field: rows running from -2 past the last source row
    (out-of-range taps clamp to the edge), one base per output row."""
    rng = np.random.default_rng(seed)
    src = rng.random((120, 256)).astype(np.float32)
    out_h = 100
    ncj, ncc = (out_h - 1) // STEP + 2, (256 - 1) // STEP + 2
    rows = np.arange(ncj, dtype=np.float32)[:, None] * STEP
    # positions vary within a row by under d_taps - 2, so every tap with
    # weight lies inside the d_taps taps (the Pallas kernel sums further)
    field = (-2.0 + rows * 1.2 + rng.random((ncj, ncc), np.float32)
             * 0.9 * (d_taps - 2)).astype(np.float32)
    # the positions as the JAX package computes them (jitted, so XLA
    # contracts the lerps as the port's fused multiply-adds do)
    pos = np.asarray(jax.jit(lambda f: jax_interp_field(
        f, jnp.arange(out_h, dtype=jnp.float32)[:, None],
        jnp.arange(256, dtype=jnp.float32)[None, :], STEP, jnp,
    ))(jnp.asarray(field)))
    base = np.floor(pos.min(axis=1)).astype(np.int32)
    return src, field, pos, base


def _port_vertical(src, field, base, d_taps):
    # one column tile spanning the whole width = one base per output row
    windows = plan_vertical_windows(base[:, None], src.shape[1], d_taps)
    v, vd = srw_vertical(
        torch.from_numpy(src)[None], torch.from_numpy(field), STEP,
        torch.from_numpy(base)[:, None], src.shape[1], d_taps, windows, "bilinear",
    )
    assert vd is None
    return v[0].numpy()


@pytest.mark.parametrize("d_taps", [2, 5, 9])
def test_srw_vertical_plain_matches_reference_and_pallas(d_taps):
    """K1's plain version, fed the coarse field, against the Pallas kernel
    in interpret mode fed the JAX package's positions of that field: bit
    for bit (XLA contracts the same sums); against the numpy twin within
    atol 1e-5, as tests/test_pallas_kernels.py uses (the twin does not
    fuse its multiply-adds)."""
    src, field, pos, base = _vertical_case(d_taps)
    got = _port_vertical(src, field, base, d_taps)
    pallas = np.asarray(
        srw_vertical_pallas(src, pos, base, d_taps, row_block=32, interpret=True)
    )
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_allclose(
        got, srw_vertical_reference(src, pos, base, d_taps), atol=1e-5
    )


@pytest.mark.parametrize("d_taps", [2, 5, 9])
def test_srw_vertical_plain_nan_row_reach(d_taps):
    """A NaN source row reaches exactly the outputs whose d_taps taps read
    it, zero-weight taps included: the XLA path's and the numpy twin's
    semantics (the Pallas kernel sums a wider window, so its NaN reach is
    wider and it is not the reference here)."""
    src, field, pos, base = _vertical_case(d_taps, seed=11)
    src[60] = np.nan
    got = _port_vertical(src, field, base, d_taps)
    ref = srw_vertical_reference(src, pos, base, d_taps)
    assert np.isnan(ref).any()
    _assert_match(got, ref, atol=1e-5)


def _stack(shape, seed=0):
    """Two bands of seeded [0, 1) data with one NaN row in the second."""
    data = np.random.default_rng(seed).random((2,) + shape, dtype=np.float32)
    data[1, shape[0] // 2] = np.nan
    return data


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("interp", METHODS)
def test_make_srw_fn_matches_jax(interp, geometry):
    """The port's tiled SRW (K1 + K2 plain) against JAX make_srw_fn, each
    on its own package's plan, for a 2-band stack: equal for every method,
    NaN masks included (the port places its fused multiply-adds where XLA's
    CPU backend contracts)."""
    ref_plan, plan = _plans(geometry)
    assert plan.base_v.shape[1] > 1 and plan.base_h.shape[0] > 1
    data = _stack((plan.src_h, plan.src_w))
    ref = np.asarray(jax_make_srw_fn(ref_plan, interp, np.nan)(jnp.asarray(data)))
    got = make_srw_fn(plan, interp, np.nan, device="cpu")(torch.from_numpy(data))
    assert got.dtype == torch.float32 and got.shape == (2, plan.out_h, plan.out_w)
    _assert_match(got.numpy(), ref)
    assert np.isfinite(ref).mean() > 0.3


@pytest.mark.parametrize("interp", METHODS)
def test_srw_plain_windows_clip_at_both_edges(interp):
    """A geometry whose taps reach past the source's top and bottom
    (base_v < 0, base_v + d_v > src_h): plain K1 and K2 against JAX
    make_srw_fn bit for bit, and the K1 windows reach past both edges (the
    kernel clamps them as it copies)."""
    ref_plan, plan = _plans("edge")
    assert plan.base_v.min() < 0 and plan.base_v.max() + plan.d_v > plan.src_h
    fn = make_srw_fn(plan, interp, np.nan, device="cpu")
    lohi = fn.state.win_v.lohi.numpy()
    assert lohi[..., 0].min() < 0 and lohi[..., 1].max() > plan.src_h
    data = _stack((plan.src_h, plan.src_w), seed=4)
    x = fn.crop(torch.from_numpy(data))
    v, vd = srw_vertical_plain(*fn.vertical_args(x))
    out = srw_horizontal_plain(*fn.horizontal_args(v), vd)
    ref = np.asarray(jax_make_srw_fn(ref_plan, interp, np.nan)(jnp.asarray(data)))
    _assert_match(out.numpy(), ref)


def _windows_cover(lohi, rows, base, d, axis_rows, n_blocks):
    """Every tap index base + k (k < d) of every output lies in its
    block's window."""
    for rb in range(-(-axis_rows // rows)):
        for cb in range(n_blocks):
            lo, hi = lohi[rb, cb]
            b = base(rb, cb)
            assert lo <= b.min() and b.max() + d <= hi


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("tile", [32, 64, None])
def test_windows_cover_every_tap(geometry, tile):
    """The host-planned windows hold every tap of their block, fit the
    shared-memory budget, and K2's are 4-aligned."""
    src, tgt = GEOMETRIES[geometry]
    kwargs = {} if tile is None else dict(col_tile=tile, row_tile=tile)
    plan = plan_srw(pt.GridMapping.regular(**src), pt.GridMapping.regular(**tgt), **kwargs)
    wv = plan_vertical_windows(plan.base_v, plan.col_tile, plan.d_v)
    assert plan.col_tile % wv.cols == 0
    lohi = wv.lohi.numpy()
    assert (lohi[..., 1] - lohi[..., 0]).max() == wv.extent
    _windows_cover(
        lohi, wv.rows,
        lambda rb, t: plan.base_v[rb * wv.rows:(rb + 1) * wv.rows, t],
        plan.d_v, plan.out_h, plan.base_v.shape[1],
    )
    assert 4 * (2 * wv.extent * wv.cols + wv.rows * wv.cols + wv.rows) <= SMEM_BUDGET
    wh = plan_horizontal_windows(plan.base_h, plan.row_tile, plan.d_h)
    assert plan.row_tile % wh.rows == 0 and wh.extent % 4 == 0
    lohi = wh.lohi.numpy()
    assert (lohi % 4 == 0).all()
    for t in range(plan.base_h.shape[0]):
        for cb in range(lohi.shape[1]):
            b = plan.base_h[t, cb * wh.cols:(cb + 1) * wh.cols]
            assert lohi[t, cb, 0] <= b.min() and b.max() + plan.d_h <= lohi[t, cb, 1]
            assert lohi[t, cb, 1] - lohi[t, cb, 0] <= wh.extent


def test_vertical_windows_shrink_to_the_budget():
    """Bases that jump far within a few rows make tall windows: the block
    rows shrink until two windows fit the shared-memory budget."""
    base = (np.arange(512, dtype=np.int32) * 40)[:, None]  # 40 source rows a row
    w = plan_vertical_windows(base, 64, 8)
    assert 4 * (2 * w.extent * w.cols + w.rows * w.cols + w.rows) <= SMEM_BUDGET
    assert w.rows < 64 and w.extent == 40 * (w.rows - 1) + 8


def test_plan_to_device_carries_the_plan():
    _, plan = _plans()
    state = plan_to_device(plan, "cpu")
    for name in ("iystar_c", "ix_c", "iy_c"):
        t = getattr(state, name)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), getattr(plan, name))
    for name in ("base_v", "base_h"):
        t = getattr(state, name)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), getattr(plan, name))
    for win in (state.win_v, state.win_h):
        assert win.lohi.dtype == torch.int32 and win.lohi.device.type == "cpu"
    assert (state.d_v, state.d_h, state.col_tile, state.row_tile) == (
        plan.d_v, plan.d_h, 32, 32,
    )
    assert (state.src_h, state.src_w, state.out_h, state.out_w) == (96, 96, 80, 80)


@pytest.mark.parametrize("interp", METHODS)
def test_srw_fn_holds_no_per_pixel_tensor(interp):
    """The tier's statics are the coarse fields, the tap bases and the
    windows: no tensor of the output's or the vertical pass's size."""
    _, plan = _plans(tile=None)
    fn = make_srw_fn(plan, interp, np.nan, device="cpu")
    st = fn.state
    tensors = [v for v in vars(fn).values() if isinstance(v, torch.Tensor)]
    tensors += [v for v in vars(st).values() if isinstance(v, torch.Tensor)]
    tensors += [st.win_v.lohi, st.win_h.lohi]
    assert len(tensors) == 7
    limit = min(st.out_h * st.out_w, st.out_h * st.src_w)
    for t in tensors:
        assert t.numel() < limit, tuple(t.shape)


@pytest.mark.parametrize("interp", METHODS)
def test_fused_reproject_plain_matches_jax(interp):
    """K3's plain version against JAX make_fused_reproject_fn: equal for
    every method, NaN masks included (same fused multiply-add placement)."""
    data = _stack((96, 96), seed=3)
    ref = np.asarray(
        jax_make_fused_reproject_fn(*_gms(jx), interp, np.nan)(jnp.asarray(data))
    )
    got = make_fused_reproject_fn(*_gms(pt), interp, np.nan, device="cpu")(
        torch.from_numpy(data)
    )
    _assert_match(got.numpy(), ref)
    assert np.isfinite(ref).mean() > 0.5


def test_cpu_tensors_take_the_plain_versions_without_launches():
    """K1-K3 through their tier functions, K4 (both orders, float64 out),
    K5 and K6 (every reducer) on CPU tensors: no launch."""
    data = torch.from_numpy(_stack((96, 96)))
    before = dict(LAUNCHES)
    _, plan = _plans()
    make_srw_fn(plan, "triangular", np.nan, device="cpu")(data)
    make_fused_reproject_fn(*_gms(pt), "bilinear", np.nan, device="cpu")(data)
    for order in (0, 1):
        gather.affine_gather(data, 0.7, 1.3, -0.4, 0.2, 50, 40, order, np.nan)
    gather.affine_gather(data, 2.0, 2.0, 0.0, 0.0, 48, 48, 1, np.nan, torch.float64)
    for agg in list(coarsen_ops.REDUCERS) + list(coarsen_ops.RANKS):
        coarsen_ops.coarsen(data, 4, 3, agg)
    for agg in coarsen_ops.REDUCERS:
        gather.affine_gather_reduce(data, 0.8, -0.9, 0.3, 95.0, 20, 24, 4, 4, agg, np.nan)
    assert dict(LAUNCHES) == before


def test_affine_and_coarsen_wrappers_check_before_launch(monkeypatch):
    """K4-K6's CUDA branches refuse what their kernels do not take before
    any build or launch (steered there with CPU tensors): among them a
    dtype outside the JAX package's thirteen (complex64)."""
    for module in (gather, coarsen_ops):
        monkeypatch.setattr(module, "on_cpu", lambda *tensors: False)

    def no_launch():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", no_launch)
    data = torch.zeros((2, 12, 16))
    before = dict(LAUNCHES)
    with pytest.raises(NotImplementedError, match="the port's kernels take"):
        gather.affine_gather(data.to(torch.complex64), 1.0, 1.0, 0.0, 0.0, 4, 4, 1, 0)
    with pytest.raises(ValueError, match="order must be"):
        gather.affine_gather(data, 1.0, 1.0, 0.0, 0.0, 4, 4, 3, 0)
    with pytest.raises(ValueError, match="keeps the source dtype"):
        gather.affine_gather(data, 1.0, 1.0, 0.0, 0.0, 4, 4, 0, 0, torch.float64)
    with pytest.raises(ValueError, match="empty source"):
        gather.affine_gather(data[:, :0], 1.0, 1.0, 0.0, 0.0, 4, 4, 1, 0)
    with pytest.raises(ValueError, match="exact multiples"):
        coarsen_ops.coarsen_reduce(data, 5, 4, "mean")
    with pytest.raises(ValueError, match="exact multiples"):
        coarsen_ops.coarsen_rank(data, 3, 5, "mode")
    with pytest.raises(NotImplementedError, match="the port's kernels take"):
        coarsen_ops.coarsen_rank(data.to(torch.complex64), 2, 2, "mode")
    with pytest.raises(ValueError, match="K5 reduces"):
        coarsen_ops.coarsen_reduce(data, 2, 2, "mode")
    with pytest.raises(ValueError, match="K6 computes"):
        coarsen_ops.coarsen_rank(data, 2, 2, "mean")
    reduce_args = (1.0, 1.0, 0.0, 0.0, 4, 4, 2, 2)
    with pytest.raises(ValueError, match="the downscale form reduces"):
        gather.affine_gather_reduce(data, *reduce_args, "mode", 0)
    with pytest.raises(ValueError, match="window divisors must be positive"):
        gather.affine_gather_reduce(data, 1.0, 1.0, 0.0, 0.0, 4, 4, 0, 2, "mean", 0)
    with pytest.raises(NotImplementedError, match="the port's kernels take"):
        gather.affine_gather_reduce(data.to(torch.complex64), *reduce_args, "mean", 0)
    with pytest.raises(ValueError, match="empty source"):
        gather.affine_gather_reduce(data[:, :0], *reduce_args, "mean", 0)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("agg", ["mean", "std", "center"])
def test_affine_gather_reduce_plain_reads_strided_views(agg):
    """K4's downscale form on a clipped view of a band stack (the
    pre-downscale hands it one) equals it on a contiguous copy, and equals
    the chain K4 -> K5 of the plain versions, NaN masks included."""
    full = torch.from_numpy(_stack((96, 96), seed=9))
    view = full[:, 5:85, 7:90]
    assert not view.is_contiguous()
    args = (0.81, -0.83, 1.2, 81.6, 15, 16, 5, 5, agg, np.nan)
    got = gather.affine_gather_reduce(view, *args)
    _assert_match(got.numpy(), gather.affine_gather_reduce(view.contiguous(), *args).numpy())
    chain = coarsen_ops.coarsen(
        gather.affine_gather(view, 0.81, -0.83, 1.2, 81.6, 75, 80, 1, np.nan), 5, 5, agg
    )
    _assert_match(got.numpy(), chain.numpy())


@pytest.mark.parametrize(
    "taps, itemsize, threads",
    [(16, 4, 128), (81, 8, 128), (192, 8, 64), (256, 4, 64), (512, 4, 32), (1024, 4, 0)],
)
def test_rank_staging_fits_the_budget(taps, itemsize, threads):
    """K6 stages a block's windows in shared memory within RANK_SMEM; a
    window too large even for 32 threads reads from device memory (0)."""
    assert coarsen_ops.rank_block_threads(taps, itemsize) == threads
    if threads:
        assert taps * threads * itemsize <= coarsen_ops.RANK_SMEM


@pytest.mark.parametrize("interp", METHODS)
def test_fused_reproject_cpu_ragged_batch_takes_the_plain_version(monkeypatch, interp):
    """CPU tensors take fused_reproject_plain and launch nothing, at a
    target width that is no multiple of 4 (the kernel's scalar tail) and a
    batch of 2; equal to JAX make_fused_reproject_fn, NaN masks included."""
    source, _ = GEOMETRIES["utm_laea"]
    target = dict(size=(77, 83), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035")
    plain_calls = []
    orig = reproject_ops.fused_reproject_plain

    def spy(*args, **kwargs):
        plain_calls.append(args[0].shape)
        return orig(*args, **kwargs)

    monkeypatch.setattr(reproject_ops, "fused_reproject_plain", spy)
    data = _stack((96, 96), seed=5)
    before = dict(LAUNCHES)
    got = make_fused_reproject_fn(
        pt.GridMapping.regular(**source), pt.GridMapping.regular(**target), interp,
        np.nan, device="cpu",
    )(torch.from_numpy(data))
    assert dict(LAUNCHES) == before
    assert plain_calls == [(2, 96, 96)]
    assert tuple(got.shape) == (2, 83, 77)
    ref = jax_make_fused_reproject_fn(
        jx.GridMapping.regular(**source), jx.GridMapping.regular(**target), interp, np.nan
    )(jnp.asarray(data))
    _assert_match(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "src_hw, out_hw",
    [((2**16, 2**15), (8, 8)), ((8, 8), (2**15, 2**16)), ((8, 8), (46341, 46341))],
)
def test_fused_reproject_refuses_planes_of_2_31_elements(monkeypatch, src_hw, out_hw):
    """K3 indexes inside a plane in 32 bits: a source or target plane of
    2^31 elements or more raises ValueError before any build or launch.
    The wrapper is steered onto its CUDA branch with CPU tensors (a
    broadcast source holds no memory)."""
    monkeypatch.setattr(reproject_ops, "on_cpu", lambda *tensors: False)

    def no_launch():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", no_launch)
    src = torch.zeros((1, 1, 1)).expand((1,) + src_hw)
    field = torch.zeros((2, 2))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="fewer than 2\\^31 elements"):
        fused_reproject(src, field, field, 2**20, *out_hw, "bilinear", np.nan)
    assert dict(LAUNCHES) == before
    # one element fewer passes the guard
    reproject_ops.require_int32_planes(2**16, 2**15 - 1, 46340, 46340)


def test_wrappers_refuse_devices_without_a_kernel():
    """Tensors on neither the CPU nor a CUDA device, or on several
    devices, raise: a wrapper never moves data to find a kernel."""
    _, plan = _plans()
    fn = make_srw_fn(plan, "bilinear", np.nan, device="cpu")
    meta = torch.empty((1, 96, 96), device="meta")
    meta_args = [
        a.to("meta") if isinstance(a, torch.Tensor) else a
        for a in fn.vertical_args(meta)
    ]
    meta_args[6] = fn.state.win_v.to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        srw_vertical(*meta_args)
    with pytest.raises(ValueError, match="several devices"):
        srw_vertical(meta, *fn.vertical_args(meta)[1:])
    with pytest.raises(ValueError, match="several devices"):
        on_cpu(torch.zeros(1), meta)
    with pytest.raises(ValueError, match="several devices"):
        fused_reproject(
            torch.zeros((1, 8, 8)), torch.zeros((2, 2), device="meta"),
            torch.zeros((2, 2)), 16, 4, 4, "bilinear", np.nan,
        )
    v = torch.zeros((1, 80, 96))
    with pytest.raises(ValueError, match="triangular needs vd"):
        srw_horizontal(*fn.horizontal_args(v)[:9], "triangular", np.nan)
    with pytest.raises(ValueError, match="the kernels support"):
        srw_vertical(*fn.vertical_args(torch.zeros((1, 96, 96)))[:7], "cubic")



# -- K7, K8, K9: the rectify kernels and the host gathers --------------------

ALL_DTYPES = ["float32", "float64", "int8", "int16", "int32", "uint8", "uint16"]


def _data(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype.startswith("float"):
        data = (rng.random(shape) * 100).astype(dtype)
        data[..., shape[-2] // 2, 3:9] = np.nan
        return data
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -20000), min(info.max, 60000), shape).astype(dtype)


def _positions(shape, src_hw, seed=1):
    """Float32 positions reaching a pixel past every edge, and a mask."""
    rng = np.random.default_rng(seed)
    ix = (rng.random(shape) * (src_hw[1] + 1) - 1).astype(np.float32)
    iy = (rng.random(shape) * (src_hw[0] + 1) - 1).astype(np.float32)
    return ix, iy, rng.random(shape) < 0.9


@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("interp", METHODS)
def test_ij_gather_plain_matches_jax_gather_interp(dtype, interp):
    """K7's map form (plain) against the JAX package's gather_interp under
    jit with the map's mask, on the seven dtypes: equal values and dtype
    (integer tap differences wrap as jnp's; float64 lerps fused in float64,
    emulated exactly here on these inputs)."""
    from xcube_resampling_tpu.ops.reproject_ops import gather_interp as jax_gather_interp

    from xcube_resampling_tpu_torch.ops import rectify_ops

    src = _data(dtype, (2, 37, 41))
    ix, iy, valid = _positions((23, 29), (37, 41))
    fill = np.nan if dtype.startswith("float") or interp != "nearest" else 7
    ref = jax.jit(
        lambda s, a, b, v: jax_gather_interp(s, a, b, interp, fill, jnp, valid=v)
    )(jnp.asarray(src), jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(valid))
    got = rectify_ops.ij_gather(
        torch.from_numpy(src), torch.from_numpy(ix), torch.from_numpy(iy),
        torch.from_numpy(valid), interp, fill,
    )
    ref = np.asarray(ref)
    assert got.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("interp", METHODS)
def test_ij_gather_list_plain_writes_the_bounds_valid_gather(interp):
    """K7's list form (plain) writes gather_interp with the bounds rule at
    its pixels of the output and leaves the others untouched."""
    from xcube_resampling_tpu.ops.reproject_ops import gather_interp as jax_gather_interp

    from xcube_resampling_tpu_torch.ops import rectify_ops

    src = _data("float32", (2, 37, 41))
    ix, iy, _ = _positions((60,), (37, 41), seed=4)
    rng = np.random.default_rng(5)
    flat = rng.choice(20 * 30, 60, replace=False)
    rows, cols = (flat // 30).astype(np.int32), (flat % 30).astype(np.int32)
    out = torch.full((2, 20, 30), -5.0)
    rectify_ops.ij_gather_list(
        out, torch.from_numpy(src), torch.from_numpy(ix), torch.from_numpy(iy),
        torch.from_numpy(rows), torch.from_numpy(cols), interp, np.nan,
    )
    ref = np.full((2, 20, 30), -5.0, np.float32)
    ref[:, rows, cols] = np.asarray(jax.jit(
        lambda s, a, b: jax_gather_interp(s, a, b, interp, np.nan, jnp)
    )(jnp.asarray(src), jnp.asarray(ix), jnp.asarray(iy)))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_phase_a_plain_first_writer_wins_on_a_fold():
    """K8's plain version on a swath that folds back over itself (two
    layers of quads claim the same pixels) and holds NaN corners: the
    lower-ranked quad wins, as the JAX package's sequential order does."""
    from xcube_resampling_tpu.ops import rectify_ops as jax_rectify_ops

    from xcube_resampling_tpu_torch.ops import rectify_ops

    j, i = np.mgrid[0:30, 0:24].astype(np.float64)
    x = i * 1.1 + 0.3 * np.sin(j / 3)
    y = np.where(j < 15, j, 29 - j) * 0.9 + 0.02 * i  # rows 15.. fold back
    x[7, 5] = np.nan
    tiles = rectify_ops.PhaseATiles(
        ints=np.array([[0, 0, 16, 16, 0, 0, 24, 30], [0, 16, 16, 16, 2, 1, 20, 28],
                       [16, 0, 16, 16, 0, 0, 0, 0], [16, 16, 16, 16, 0, 0, 24, 30]]),
        origins=np.array([[-0.2, -0.1], [17.4, -0.1], [-0.2, 15.9], [17.4, 15.9]]),
        x_scale=1.0, y_scale=1.0, tile_h=16, tile_w=16, n_tiles_x=2, out_h=32, out_w=32,
    )
    got = rectify_ops.rectify_phase_a(
        torch.from_numpy(np.stack([x, y])), tiles, 1e-3
    ).numpy()
    for (row0, col0, th, tw, i_lo, j_lo, ww, wh), (xo, yo) in zip(tiles.ints, tiles.origins):
        block = got[:, row0:row0 + th, col0:col0 + tw]
        if ww == 0:
            assert np.isnan(block).all()
            continue
        ref = jax_rectify_ops.inverse_ij_map(
            x[j_lo:j_lo + wh, i_lo:i_lo + ww], y[j_lo:j_lo + wh, i_lo:i_lo + ww],
            int(i_lo), int(j_lo), (th, tw), xo, yo, 1.0, 1.0, 1e-3,
        )
        np.testing.assert_array_equal(block, ref)
    assert np.isfinite(got).mean() > 0.2


# K7's position maps that its tiling of the output makes hard: positions
# of one output tile spread over the whole source, a map that runs
# backwards in both axes, and positions on the -0.5 / n - 0.5 bounds and
# one float32 ulp inside them
def _wide_map(shape, src_hw):
    rng = np.random.default_rng(11)
    ix = (rng.random(shape) * src_hw[1] - 0.5).astype(np.float32)
    iy = (rng.random(shape) * src_hw[0] - 0.5).astype(np.float32)
    return ix, iy


def _backward_map(shape, src_hw):
    j, i = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    ix = (src_hw[1] - 1.2) - i * (src_hw[1] / shape[1]) + 0.07 * j
    iy = (src_hw[0] - 0.9) - j * (src_hw[0] / shape[0]) - 0.05 * i
    return ix.astype(np.float32), iy.astype(np.float32)


def _bounds_map(shape, src_hw):
    h, w = src_hw
    edges = np.array([-0.5, w - 0.5, np.nextafter(np.float32(-0.5), np.float32(1)),
                      np.nextafter(np.float32(w - 0.5), np.float32(0)), 0.0, w - 1.0, 0.5,
                      w - 1.5], np.float32)
    rows = np.array([-0.5, h - 0.5, np.nextafter(np.float32(-0.5), np.float32(1)),
                     np.nextafter(np.float32(h - 0.5), np.float32(0)), 0.0, h - 1.0, 0.5,
                     h - 1.5], np.float32)
    rng = np.random.default_rng(12)
    ix = rng.choice(edges, shape).astype(np.float32)
    iy = rng.choice(rows, shape).astype(np.float32)
    return ix, iy


K7_MAPS = {"wide": _wide_map, "backwards": _backward_map, "bounds": _bounds_map}


@pytest.mark.parametrize("case", sorted(K7_MAPS))
@pytest.mark.parametrize("dtype", ["float32", "float64", "uint16"])
@pytest.mark.parametrize("interp", METHODS)
def test_ij_gather_plain_matches_jax_on_hard_maps(case, dtype, interp):
    """K7's map form and list form (plain) against the JAX package's
    gather_interp on maps that cross its output tiles' footprints (every
    tile's positions spread over the whole source), run backwards, or sit
    on the -0.5 / n - 0.5 bounds: equal values and dtype."""
    from xcube_resampling_tpu.ops.reproject_ops import gather_interp as jax_gather_interp

    from xcube_resampling_tpu_torch.ops import rectify_ops

    src = _data(dtype, (3, 45, 70))
    ix, iy = K7_MAPS[case]((19, 67), (45, 70))
    valid = np.random.default_rng(13).random(ix.shape) < 0.85
    fill = np.nan if dtype.startswith("float") or interp != "nearest" else 9
    ref = np.asarray(jax.jit(
        lambda s, a, b, v: jax_gather_interp(s, a, b, interp, fill, jnp, valid=v)
    )(jnp.asarray(src), jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(valid)))
    t = [torch.from_numpy(a) for a in (src, ix, iy, valid)]
    got = rectify_ops.ij_gather(*t, interp, fill).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    # the list form: every map pixel in reverse order, valid by the bounds
    ref_b = np.asarray(jax.jit(
        lambda s, a, b: jax_gather_interp(s, a, b, interp, fill, jnp)
    )(jnp.asarray(src), jnp.asarray(ix.ravel()), jnp.asarray(iy.ravel())))
    flat = np.arange(ix.size)[::-1]
    rows, cols = (flat // ix.shape[1]).astype(np.int32), (flat % ix.shape[1]).astype(np.int32)
    out = torch.zeros((3,) + ix.shape, dtype=torch.from_numpy(ref.copy()).dtype)
    rectify_ops.ij_gather_list(
        out, t[0], torch.from_numpy(ix.ravel()[flat].copy()),
        torch.from_numpy(iy.ravel()[flat].copy()), torch.from_numpy(rows),
        torch.from_numpy(cols), interp, fill,
    )
    np.testing.assert_array_equal(out.numpy().reshape(3, -1), ref_b)


def _phase_a_fold(h, w, fold_row, fold_col):
    """A swath that folds back over itself at row *fold_row* and column
    *fold_col*: quads on either side of a fold claim the same pixels."""
    j, i = np.mgrid[0:h, 0:w].astype(np.float64)
    ii = np.where(i < fold_col, i, 2 * fold_col - i) if fold_col else i
    jj = np.where(j < fold_row, j, 2 * fold_row - j) if fold_row else j
    x = ii * 1.1 + 0.3 * np.sin(j / 3) + 0.01 * j
    y = jj * 0.9 + 0.02 * i
    return x, y


# Tile tables that K8's patches of PATCH_W x PATCH_H quads make hard, each
# held against the JAX package's inverse_ij_map window by window
def _phase_a_case(name):
    if name == "ragged windows":  # quad counts no multiple of the patch
        x, y = _phase_a_fold(47, 83, 0, 0)
        ints = [[0, 0, 24, 40, 0, 0, 45, 13], [0, 40, 24, 40, 37, 3, 46, 44],
                [24, 0, 24, 40, 1, 20, 33, 9], [24, 40, 24, 40, 30, 20, 53, 27]]
        size = (48, 80)
    elif name == "2x2 and one-row windows":  # one quad; one quad row; none
        x, y = _phase_a_fold(30, 80, 0, 0)
        ints = [[0, 0, 16, 40, 3, 4, 2, 2], [0, 40, 16, 40, 36, 2, 44, 2],
                [16, 0, 16, 40, 0, 20, 70, 1], [16, 40, 16, 40, 40, 15, 1, 9]]
        size = (32, 80)
    elif name == "fold across patches":  # competing quads in other patches
        x, y = _phase_a_fold(40, 76, 19, 37)
        ints = [[0, 0, 24, 40, 0, 0, 76, 40], [0, 40, 24, 40, 0, 0, 76, 40],
                [24, 0, 24, 40, 0, 0, 76, 40], [24, 40, 24, 40, 2, 1, 71, 37]]
        size = (48, 80)
    else:  # "NaN on patch boundaries": window-local quad row 8 and column 32
        x, y = _phase_a_fold(40, 76, 0, 0)
        x[9, :] = np.nan
        y[:, 35] = np.nan
        x[1 + 16, 3 + 32] = np.nan
        ints = [[0, 0, 24, 40, 3, 1, 70, 30], [0, 40, 24, 40, 3, 1, 70, 30],
                [24, 0, 24, 40, 0, 0, 76, 40], [24, 40, 24, 40, 3, 9, 40, 17]]
        size = (48, 80)
    ints = np.array(ints, np.int64)
    origins = np.stack([-0.3 + ints[:, 1] * 1.05, -0.2 + ints[:, 0] * 0.85], 1)
    from xcube_resampling_tpu_torch.ops import rectify_ops

    tiles = rectify_ops.PhaseATiles(
        ints=ints, origins=origins, x_scale=1.05, y_scale=0.85, tile_h=24 if size[0] == 48
        else 16, tile_w=40, n_tiles_x=2, out_h=size[0], out_w=size[1],
    )
    return x, y, tiles


PHASE_A_CASES = ["ragged windows", "2x2 and one-row windows", "fold across patches",
                 "NaN on patch boundaries"]


@pytest.mark.parametrize("case", PHASE_A_CASES)
def test_phase_a_plain_matches_jax_on_patch_edges(case):
    """K8's plain version on tile windows that K8's work items cut
    unevenly (quad counts no multiple of the patch, a window of one quad,
    one quad row and none, a fold whose competing quads lie in other
    patches, NaN corners on patch boundaries) against the JAX package's
    inverse_ij_map of each window, as its host tier runs it: bit for bit."""
    from xcube_resampling_tpu.ops import rectify_ops as jax_rectify_ops

    from xcube_resampling_tpu_torch.ops import rectify_ops

    x, y, tiles = _phase_a_case(case)
    got = rectify_ops.rectify_phase_a(torch.from_numpy(np.stack([x, y])), tiles, 1e-3).numpy()
    for (row0, col0, th, tw, i_lo, j_lo, ww, wh), (xo, yo) in zip(tiles.ints, tiles.origins):
        block = got[:, row0:row0 + th, col0:col0 + tw]
        if ww < 2 or wh < 2:
            assert np.isnan(block).all()
            continue
        ref = jax_rectify_ops.inverse_ij_map(
            x[j_lo:j_lo + wh, i_lo:i_lo + ww], y[j_lo:j_lo + wh, i_lo:i_lo + ww],
            int(i_lo), int(j_lo), (th, tw), xo, yo, tiles.x_scale, tiles.y_scale, 1e-3,
        )
        np.testing.assert_array_equal(block, ref)
    assert np.isfinite(got).any()


@pytest.mark.parametrize("case", PHASE_A_CASES)
def test_phase_a_patches_cover_every_quad_once(case):
    """K8's work table from a PhaseATiles: per tile ceil(quads across /
    PATCH_W) x ceil(quad rows / PATCH_H) patches, numbered tile by tile
    (each tile's first item the count before it), none for windows
    without a quad; decoded as the kernel decodes a work item (the last
    tile whose first item is at most it, then row-major patches), the
    items cover each window quad exactly once."""
    from xcube_resampling_tpu_torch.ops import rectify_ops

    _, _, tiles = _phase_a_case(case)
    table, n_items = rectify_ops.phase_a_patches(tiles)
    assert table.dtype == np.int32 and table.shape == (len(tiles.ints), 2)
    pw, ph = rectify_ops.PATCH_W, rectify_ops.PATCH_H
    quads = np.maximum(tiles.ints[:, 6:8] - 1, 0)
    counts = -(-quads[:, 0] // pw) * -(-quads[:, 1] // ph)
    np.testing.assert_array_equal(table[:, 0], np.cumsum(counts) - counts)
    np.testing.assert_array_equal(table[:, 1], -(-quads[:, 0] // pw))
    assert n_items == counts.sum() and (counts == 0).any() == (case == "2x2 and one-row windows")
    covered = [np.zeros((qh, qw), np.int64) for qw, qh in quads]
    for item in range(n_items):
        tile = np.searchsorted(table[:, 0], item, side="right") - 1
        local = item - table[tile, 0]
        qj0, qi0 = local // table[tile, 1] * ph, local % table[tile, 1] * pw
        covered[tile][qj0:qj0 + ph, qi0:qi0 + pw] += 1
    assert all(np.all(c == 1) for c in covered)
    table, n_items = rectify_ops.phase_a_patches(rectify_ops.PhaseATiles(
        ints=np.zeros((3, 8), np.int64), origins=np.zeros((3, 2)), x_scale=1.0, y_scale=1.0,
        tile_h=4, tile_w=4, n_tiles_x=3, out_h=4, out_w=12))
    assert n_items == 0 and not table.any()


@pytest.fixture(params=["native", "numpy"])
def jax_host_gather(request, monkeypatch):
    """The JAX package's host gather through its C++ library and through
    its numpy fallback (the two agree bit for bit)."""
    from xcube_resampling_tpu import native

    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint16", "int16"])
@pytest.mark.parametrize("interp", METHODS)
def test_exact_gather_ij_plain_matches_jax_host_gather(jax_host_gather, dtype, interp):
    """K9's ij_map mode (plain) against var_image_from_ij_map on a map
    with NaN cells and edge positions: equal, dtype kept."""
    from xcube_resampling_tpu.ops import rectify_ops as jax_rectify_ops

    from xcube_resampling_tpu_torch.ops import rectify_ops

    src = _data(dtype, (2, 37, 41), seed=6)
    rng = np.random.default_rng(7)
    ij = np.stack([rng.random((23, 29)) * 40, rng.random((23, 29)) * 36])
    ij[:, 4, 5:9] = np.nan
    ij[0, 0, 0], ij[1, 0, 1] = 40.0, 36.0
    fill = np.nan if dtype.startswith("float") else 9
    ref = jax_rectify_ops.var_image_from_ij_map(src, ij, fill, interp)
    got = rectify_ops.var_image_from_ij_map(
        torch.from_numpy(src), torch.from_numpy(ij), fill, interp
    )
    assert got.numpy().dtype == ref.dtype == src.dtype
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint16", "int16"])
@pytest.mark.parametrize("interp", METHODS)
@pytest.mark.parametrize("geometry", ["utm_laea", "edge"])
def test_exact_gather_windows_plain_matches_jax_host_path(dtype, interp, geometry):
    """K9's window mode (plain) against the JAX package's
    _gather_through_windows on its own plan, windows reaching past the
    source (fill padding) on the edge geometry: equal, dtype kept."""
    from xcube_resampling_tpu import reproject as jax_reproject
    from xcube_resampling_tpu.crs import Transformer as JaxTransformer

    from xcube_resampling_tpu_torch import reproject as port_reproject
    from xcube_resampling_tpu_torch.crs import Transformer as PortTransformer

    src_kw, tgt_kw = {
        "utm_laea": GEOMETRIES["utm_laea"],
        "edge": (
            dict(size=(96, 96), xy_min=(500000.0, 5400000.0), xy_res=100.0, crs="epsg:32632"),
            dict(size=(100, 160), xy_min=(4247500.0, 2846000.0), xy_res=100.0,
                 crs="epsg:3035", tile_size=48),
        ),
    }[geometry]
    js, jt = jx.GridMapping.regular(**src_kw), jx.GridMapping.regular(**tgt_kw)
    ps, pt_ = pt.GridMapping.regular(**src_kw), pt.GridMapping.regular(**tgt_kw)
    inv = JaxTransformer.from_crs(jt.crs, js.crs, always_xy=True)
    plan = jax_reproject._plan_source_windows(inv, js, jt)
    xx, yy = jax_reproject._target_centers_in_source(inv, jt)
    src = _data(dtype, (2, 96, 96), seed=8)
    fill = np.nan if dtype.startswith("float") else 65535 if dtype == "uint16" else -1
    ref = jax_reproject._gather_through_windows(src, js, jt, xx, yy, plan, interp, fill)
    pinv = PortTransformer.from_crs(pt_.crs, ps.crs, always_xy=True)
    got = port_reproject._gather_through_windows(
        torch.from_numpy(src), ps, pt_, xx, yy,
        port_reproject._plan_source_windows(pinv, ps, pt_), interp, fill,
    )
    if geometry == "edge":
        assert any(p != (0, 0) for p in plan.pad_width)
    assert got.numpy().dtype == ref.dtype == src.dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_rectify_wrappers_take_plain_versions_on_the_cpu(monkeypatch):
    """K7, K8 and K9 on CPU tensors: their plain versions, no launch, no
    kernel library; K7's bool bilinear gather raises ``TypeError`` as jnp's
    boolean subtract does, K9 a dtype outside the JAX package's thirteen
    (complex64) ``NotImplementedError``."""
    from xcube_resampling_tpu_torch.ops import exact_gather, rectify_ops

    def no_launch():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", no_launch)
    before = dict(LAUNCHES)
    src = torch.from_numpy(_data("float32", (1, 16, 16)))
    ix, iy, valid = (torch.from_numpy(a) for a in _positions((8, 8), (16, 16)))
    rectify_ops.ij_gather(src, ix, iy, valid, "bilinear", np.nan)
    rectify_ops.var_image_from_ij_map(src, torch.stack([ix, iy]).double(), np.nan, "nearest")
    xy = torch.from_numpy(np.stack(np.meshgrid(np.arange(16.0), np.arange(16.0))))
    tiles = rectify_ops.PhaseATiles(
        ints=np.array([[0, 0, 8, 8, 0, 0, 16, 16]]), origins=np.array([[0.0, 0.0]]),
        x_scale=1.0, y_scale=1.0, tile_h=8, tile_w=8, n_tiles_x=1, out_h=8, out_w=8,
    )
    assert torch.isfinite(rectify_ops.rectify_phase_a(xy, tiles, 1e-3)).all()
    assert dict(LAUNCHES) == before
    with pytest.raises(TypeError, match="boolean"):
        rectify_ops.ij_gather(src.bool(), ix, iy, valid, "bilinear", 0)
    with pytest.raises(NotImplementedError, match="the port's kernels take"):
        exact_gather.exact_gather_ij(src.to(torch.complex64), torch.stack([ix, iy]).double(), 0,
                                     "nearest")
    with pytest.raises(NotImplementedError, match="interp_methods must be one of"):
        exact_gather.exact_gather_ij(src, torch.stack([ix, iy]).double(), 0, "cubic")


# -- K10: the tile plan's bbox scan ------------------------------------------


def _k10_case(case):
    """Seeded (x, y) float64 swath images, the tiles of a regular grid over
    their extent (xy bboxes, as GridMapping.xy_bboxes gives them) and the
    xy border: *case* picks NaN rows, a target reaching past the swath
    (empty tiles; boxes clipped at every image edge) or many small tiles
    with a border wider than one tile."""
    rng = np.random.default_rng({"nan_rows": 11, "clipped": 12, "many": 13}[case])
    h, w = (37, 53) if case != "many" else (61, 70)
    j, i = np.mgrid[0:h, 0:w].astype(np.float64)
    x = 10.0 + 0.5 * i + 0.07 * j + 0.01 * rng.random((h, w))
    y = 40.0 - 0.5 * j + 0.05 * i + 0.01 * rng.random((h, w))
    if case == "nan_rows":
        x[5] = np.nan
        y[20, 3:30] = np.nan
    x0, x1, y0, y1 = np.nanmin(x), np.nanmax(x), np.nanmin(y), np.nanmax(y)
    if case == "clipped":
        # reaching 6 units past the swath on every side
        x0, x1, y0, y1 = x0 - 6.0, x1 + 6.0, y0 - 6.0, y1 + 6.0
    res, tile = (0.5, 8) if case != "many" else (0.25, 4)
    gm = pt.GridMapping.regular(
        size=(int(np.ceil((x1 - x0) / res)), int(np.ceil((y1 - y0) / res))),
        xy_min=(x0, y0), xy_res=res, crs="EPSG:4326", tile_size=tile,
    )
    border = 3.1 * tile * res if case == "many" else 0.3
    return x, y, gm, border


@pytest.mark.parametrize("case", ["nan_rows", "clipped", "many"])
@pytest.mark.parametrize("ij_border", [0, 1])
def test_ij_bboxes_plain_matches_the_host_scan(case, ij_border):
    """K10's plain version equals the port's host scan
    (gridmapping/bboxes.py, a copy of the JAX package's) bit for bit: NaN
    rows, empty tiles (-1 rows), boxes clipped at every image edge, ij
    borders 0 and 1, more than 100 small tiles under a border wider than
    one tile."""
    from xcube_resampling_tpu_torch.gridmapping.bboxes import compute_ij_bboxes as host_scan
    from xcube_resampling_tpu_torch.ops.bbox_ops import compute_ij_bboxes

    x, y, gm, border = _k10_case(case)
    boxes = gm.xy_bboxes
    ref = host_scan(x, y, boxes, border, ij_border, np.full(boxes.shape, -1, np.int64))
    got = compute_ij_bboxes(torch.from_numpy(x), torch.from_numpy(y), boxes, border, ij_border)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)
    empty = ref[:, 0] == -1
    assert (~empty).any()
    if case == "clipped":
        assert empty.any()
        assert (ref[~empty, 0] == 0).any() and (ref[~empty, 1] == 0).any()
        assert (ref[~empty, 2] == x.shape[1]).any() and (ref[~empty, 3] == x.shape[0]).any()
    if case == "many":
        assert len(boxes) > 100 and border > gm.tile_width * gm.x_res


@pytest.mark.parametrize("case", ["nan_rows", "clipped", "many"])
@pytest.mark.parametrize("ij_border", [0, 1])
def test_ij_bboxes_plain_matches_jax(case, ij_border):
    """K10's plain version equals the JAX package's device variant
    (``compute_ij_bboxes_jax``) on float64 images, where it compares in
    float64 too."""
    from xcube_resampling_tpu.ops.bbox_ops import compute_ij_bboxes_jax
    from xcube_resampling_tpu_torch.ops.bbox_ops import compute_ij_bboxes

    x, y, gm, border = _k10_case(case)
    ref = np.asarray(compute_ij_bboxes_jax(jnp.asarray(x), jnp.asarray(y), gm.xy_bboxes,
                                           border, ij_border))
    got = compute_ij_bboxes(torch.from_numpy(x), torch.from_numpy(y), gm.xy_bboxes, border,
                            ij_border)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", ["nan_rows", "clipped", "many"])
@pytest.mark.parametrize("j_axis_up", [False, True])
def test_ij_bboxes_lattice_search_finds_exactly_the_tiles(case, j_axis_up):
    """What K10 hands its kernel: the tiles' lattice, each axis's bounds
    sorted so that low and high bounds ascend.  The kernel's two binary
    searches per axis (numpy's searchsorted here, the same rule) give for
    every pixel exactly the tiles whose float64 box test it passes, on
    both y orders of a target."""
    from xcube_resampling_tpu_torch.ops.bbox_ops import _grown, lattice, pack_lattice

    x, y, gm, border = _k10_case(case)
    if j_axis_up:
        gm = pt.GridMapping.regular(size=gm.size, xy_min=(gm.x_min, gm.y_min),
                                    xy_res=gm.x_res, crs=gm.crs, tile_size=gm.tile_size,
                                    is_j_axis_up=True)
    boxes = _grown(gm.xy_bboxes, border)
    lat, order, nc, nr = lattice(boxes)
    packed = np.frombuffer(pack_lattice(lat, order, nc).tobytes(), np.float64, 4 * (nc + nr))
    col_axis, row_axis = packed[:4 * nc].reshape(4, nc), packed[4 * nc:].reshape(4, nr)
    col_lo, col_hi = lat[:nc], lat[nc:2 * nc]
    row_lo, row_hi = lat[2 * nc:2 * nc + nr], lat[2 * nc + nr:]
    for px, py in zip(x.ravel()[::7], y.ravel()[::7]):
        exact = set(np.nonzero((px >= boxes[:, 0]) & (px <= boxes[:, 2])
                               & (py >= boxes[:, 1]) & (py <= boxes[:, 3]))[0])
        cols = order[np.searchsorted(col_hi, px, "left"):np.searchsorted(col_lo, px, "right")]
        rows = order[nc:][np.searchsorted(row_hi, py, "left"):np.searchsorted(row_lo, py, "right")]
        assert {int(r) * nc + int(c) for r in rows for c in cols} == exact


def test_ij_bboxes_lattice_refuses_other_boxes():
    """K10 takes only the tiles of a regular grid: boxes that are no
    row-major lattice raise before any launch."""
    from xcube_resampling_tpu_torch.ops.bbox_ops import lattice

    grid = pt.GridMapping.regular(size=(20, 12), xy_min=(0.0, 0.0), xy_res=1.0,
                                  crs="EPSG:4326", tile_size=5).xy_bboxes
    assert lattice(grid)[2:] == (4, 3)
    moved = grid.copy()
    moved[5, 0] += 0.5
    with pytest.raises(ValueError, match="regular grid"):
        lattice(moved)
    with pytest.raises(ValueError, match="regular grid"):
        lattice(grid[:-1])


def _k10_walk(h, w, x_off, blocks, unroll, warps_per_block=8):
    """K10's pixel partition, emulated in numpy as the kernel walks it:
    the pixel before the first 16-byte boundary of x (*x_off* 1) and an
    odd last pixel on their own; the pairs after them split evenly over
    the grid's warps, a warp 64 pixels a step, lane l on pixels 2l and
    2l + 1, *unroll* steps loaded at once, each lane carrying its (i, j)
    by the step.  Returns the (pixel, i, j) of every visit and the first
    pixel of every pair loaded as one 16-byte load."""
    n = h * w
    p0 = min(x_off, n)
    pairs = (n - p0) // 2
    di, dj = 64 % w, 64 // w
    visits = [(p, p % w, p // w) for p in ([0] if p0 else []) + ([n - 1] if (n - p0) % 2 else [])]
    loads = []
    lanes = np.arange(32)
    warps = blocks * warps_per_block
    for g in range(warps):
        q_lo, q_hi = pairs * g // warps, pairs * (g + 1) // warps
        p = p0 + 2 * (q_lo + lanes)
        j, i = p // w, p % w
        for base in range(q_lo, q_hi, 32 * unroll):
            for u in range(unroll):
                q = base + 32 * u + lanes
                ok = q < q_hi
                pp = p0 + 2 * q[ok]
                loads.append(pp)
                wraps = i[ok] + 1 == w
                visits += zip(pp, i[ok], j[ok])
                visits += zip(pp + 1, np.where(wraps, 0, i[ok] + 1), j[ok] + wraps)
                i, j = i + di, j + dj
                j, i = j + (i >= w), np.where(i >= w, i - w, i)
    return np.array(visits, dtype=np.int64).reshape(-1, 3), np.concatenate(loads or [[]])


@pytest.mark.parametrize("x_off", [0, 1])
@pytest.mark.parametrize("blocks,unroll", [(1, 4), (5, 4), (3, 1)])
@pytest.mark.parametrize("h,w", [(1, 1), (1, 2), (2, 1), (1, 97), (97, 1), (7, 9), (37, 53),
                                 (64, 1), (3, 65), (61, 70)])
def test_ij_bboxes_partition_covers_every_pixel_once(h, w, x_off, blocks, unroll):
    """K10's walk over the swath (emulated): every pixel is visited exactly
    once and with its own (i, j), carried along without division, for
    awkward shapes (one row, one column, odd widths, steps wider than a
    row) and block counts; every 16-byte load starts on a 16-byte
    boundary of an image that starts *x_off* 8-byte words off one."""
    visits, loads = _k10_walk(h, w, x_off, blocks, unroll)
    order = np.argsort(visits[:, 0], kind="stable")
    np.testing.assert_array_equal(visits[order, 0], np.arange(h * w))
    np.testing.assert_array_equal(visits[order, 1], np.arange(h * w) % w)
    np.testing.assert_array_equal(visits[order, 2], np.arange(h * w) // w)
    assert np.all((x_off + loads) % 2 == 0) and np.all(loads + 1 < h * w)


def _k10_lattice(j_axis_up=False, tile_size=5, border=0.3):
    from xcube_resampling_tpu_torch.ops.bbox_ops import _grown

    gm = pt.GridMapping.regular(size=(23, 14), xy_min=(0.0, 0.0), xy_res=1.0,
                                crs="EPSG:4326", tile_size=tile_size, is_j_axis_up=j_axis_up)
    return _grown(gm.xy_bboxes, border)


@pytest.mark.parametrize("j_axis_up", [False, True])
def test_ij_bboxes_packed_lattice_is_what_the_kernel_reads(j_axis_up):
    """The lattice buffer, read at the offsets the kernel reads it: for
    the columns, then the rows, the low and high bounds (float64, each
    ascending), each low bound's next float64 below and each high bound's
    next above; then the sorted position -> lattice column and row
    (int32).  A tile's grown box is its column's x bounds and its row's y
    bounds, on both y orders of a target."""
    from xcube_resampling_tpu_torch.ops.bbox_ops import lattice, pack_lattice

    boxes = _k10_lattice(j_axis_up)
    lat, order, nc, nr = lattice(boxes)
    raw = pack_lattice(lat, order, nc).tobytes()
    assert len(raw) == 8 * 4 * (nc + nr) + 4 * (nc + nr)
    f64 = np.frombuffer(raw, np.float64, 4 * (nc + nr))
    perm = np.frombuffer(raw, np.int32, nc + nr, offset=8 * 4 * (nc + nr))
    cols, rows = f64[:4 * nc].reshape(4, nc), f64[4 * nc:].reshape(4, nr)
    for lo, hi, below, above in (cols, rows):
        assert np.all(np.diff(lo) > 0) and np.all(np.diff(hi) > 0)
        np.testing.assert_array_equal(below, np.nextafter(lo, -np.inf))
        np.testing.assert_array_equal(above, np.nextafter(hi, np.inf))
        assert np.all(below < lo) and np.all(above > hi)
    col_of, row_of = perm[:nc], perm[nc:]
    assert sorted(col_of) == list(range(nc)) and sorted(row_of) == list(range(nr))
    assert list(row_of) == (list(range(nr)) if j_axis_up else list(range(nr))[::-1])
    for r in range(nr):
        for c in range(nc):
            k = row_of[r] * nc + col_of[c]
            np.testing.assert_array_equal(boxes[k],
                                          [cols[0, c], rows[0, r], cols[1, c], rows[1, r]])
    # an infinite bound has no neighbour: NaN, which lets no value in
    inf = pack_lattice(np.array([-np.inf, 0.0, 1.0, np.inf, -1.0, 2.0]), np.arange(3), 2)
    np.testing.assert_array_equal(np.frombuffer(inf.tobytes(), np.float64, 12)[[4, 7]],
                                  [np.nan, np.nan])


def test_ij_bboxes_lattice_buffer_is_memoised():
    """The lattice buffer is uploaded once per geometry, device and stream:
    the same grown boxes reuse it; another border, another device or
    another tile count makes a new one; the memo keeps a few, newest
    last.  K10's table is one per device and tile count, laid out as the
    kernel leaves it."""
    from xcube_resampling_tpu_torch.ops import bbox_ops

    bbox_ops._LATTICE_MEMO.clear()
    boxes = _k10_lattice()
    buf, nc, nr, made = bbox_ops.lattice_buffer(boxes, "cpu")
    assert (nc, nr, made) == (5, 3, 1) and buf.dtype == torch.uint8
    lat, order, nc, _ = bbox_ops.lattice(boxes)
    np.testing.assert_array_equal(buf.numpy(), bbox_ops.pack_lattice(lat, order, nc))
    again = bbox_ops.lattice_buffer(boxes.copy(), torch.device("cpu"))
    assert again[0] is buf and again[3] == 0
    for other, device in ((_k10_lattice(border=0.4), "cpu"), (boxes, "meta"),
                          (_k10_lattice(tile_size=4), "cpu")):
        new = bbox_ops.lattice_buffer(other, device)
        assert new[0] is not buf and new[3] == 1 and new[0].device == torch.device(device)
    assert bbox_ops.lattice_buffer(boxes, "cpu")[0] is buf
    for border in np.arange(1.0, 1.0 + bbox_ops._MEMO_MAX):
        bbox_ops.lattice_buffer(_k10_lattice(border=border), "cpu")
    assert bbox_ops.lattice_buffer(boxes, "cpu")[3] == 1
    assert len(bbox_ops._LATTICE_MEMO) == bbox_ops._MEMO_MAX

    bbox_ops._SCRATCH_MEMO.clear()
    table, made = bbox_ops.scratch_table(15, "cpu")
    assert made == 1 and table.dtype == torch.int32 and table.shape == (16, 4)
    np.testing.assert_array_equal(table[:15].numpy(), np.tile([2**31 - 1, 2**31 - 1, -1, -1],
                                                              (15, 1)))
    np.testing.assert_array_equal(table[15].numpy(), 0)
    assert bbox_ops.scratch_table(15, "cpu") == (table, 0)
    assert bbox_ops.scratch_table(12, "cpu")[1] == 1 and bbox_ops.scratch_table(15, "meta")[1] == 1


def _k10_exactly(axis, k0, k1):
    """The kernel's closed interval of the values whose columns (or rows)
    of a sub-lattice are exactly [k0, k1), from the axis's packed low and
    high bounds and their neighbours below and above: lo[k1 - 1] <= v <=
    hi[k0], v >= above[k0 - 1] and v <= below[k1]; NaN neighbours let no
    value in."""
    lo, hi, below, above = axis
    a, b = lo[k1 - 1], hi[k0]
    if k0 > 0:
        a = above[k0 - 1] if np.isnan(above[k0 - 1]) else max(a, above[k0 - 1])
    if k1 < len(lo):
        b = below[k1] if np.isnan(below[k1]) else min(b, below[k1])
    return a, b


@pytest.mark.parametrize("case", ["nan_rows", "clipped", "many"])
@pytest.mark.parametrize("max_tiles", [1, 2, 7, 1024])
@pytest.mark.parametrize("j_axis_up", [False, True])
def test_ij_bboxes_sub_lattices_and_fast_path_match_the_host_scan(case, max_tiles, j_axis_up):
    """K10's per-pixel logic, emulated in numpy over its sub-lattices
    (kMaxTiles tiles at most, as the kernel cuts them): the boxes merged
    from each sub-lattice's searches equal the host scan's; and its fast
    path is exact: for every set of tiles a pixel lies in, the closed
    float64 interval an axis of the kernel's test takes exactly the
    pixels whose tiles are that set (within the sub-lattice)."""
    from xcube_resampling_tpu_torch.gridmapping.bboxes import compute_ij_bboxes as host_scan
    from xcube_resampling_tpu_torch.ops.bbox_ops import _grown, lattice, pack_lattice

    x, y, gm, border = _k10_case(case)
    if j_axis_up:
        gm = pt.GridMapping.regular(size=gm.size, xy_min=(gm.x_min, gm.y_min),
                                    xy_res=gm.x_res, crs=gm.crs, tile_size=gm.tile_size,
                                    is_j_axis_up=True)
    boxes = _grown(gm.xy_bboxes, border)
    lat, order, nc, nr = lattice(boxes)
    packed = np.frombuffer(pack_lattice(lat, order, nc).tobytes(), np.float64, 4 * (nc + nr))
    col_axis, row_axis = packed[:4 * nc].reshape(4, nc), packed[4 * nc:].reshape(4, nr)
    h, w = x.shape
    j_px, i_px = np.divmod(np.arange(h * w), w)
    xs, ys = x.ravel(), y.ravel()
    lo_hi = np.full((len(boxes), 4), [2**31 - 1, 2**31 - 1, -1, -1], np.int64)
    c_step = min(nc, max_tiles)
    r_step = min(nr, max_tiles // c_step)
    for rb in range(0, nr, r_step):
        for cb in range(0, nc, c_step):
            cols = slice(cb, min(cb + c_step, nc))
            rows = slice(rb, min(rb + r_step, nr))
            col_lo, col_hi = lat[:nc][cols], lat[nc:2 * nc][cols]
            row_lo, row_hi = lat[2 * nc:2 * nc + nr][rows], lat[2 * nc + nr:][rows]
            c0, c1 = np.searchsorted(col_hi, xs, "left"), np.searchsorted(col_lo, xs, "right")
            r0, r1 = np.searchsorted(row_hi, ys, "left"), np.searchsorted(row_lo, ys, "right")
            keys = np.stack([c0, c1, r0, r1], axis=1)
            some = (c0 < c1) & (r0 < r1)
            for key in np.unique(keys[some], axis=0):
                xa, xb = _k10_exactly(col_axis[:, cols], key[0], key[1])
                ya, yb = _k10_exactly(row_axis[:, rows], key[2], key[3])
                fast = (xs >= xa) & (xs <= xb) & (ys >= ya) & (ys <= yb)
                np.testing.assert_array_equal(fast, some & (keys == key).all(axis=1))
            for r in range(len(row_lo)):
                for c in range(len(col_lo)):
                    hit = (c0 <= c) & (c < c1) & (r0 <= r) & (r < r1)
                    if hit.any():
                        k = order[nc + rb + r] * nc + order[cb + c]
                        lo_hi[k] = [min(lo_hi[k, 0], i_px[hit].min()), min(lo_hi[k, 1], j_px[hit].min()),
                                    max(lo_hi[k, 2], i_px[hit].max()), max(lo_hi[k, 3], j_px[hit].max())]
    ij_border = 1
    got = np.full((len(boxes), 4), -1, np.int64)
    some = lo_hi[:, 2] >= 0
    got[some] = np.stack([np.maximum(lo_hi[some, 0] - ij_border, 0),
                          np.maximum(lo_hi[some, 1] - ij_border, 0),
                          np.minimum(lo_hi[some, 2] + 1 + ij_border, w),
                          np.minimum(lo_hi[some, 3] + 1 + ij_border, h)], axis=1)
    ref = host_scan(x, y, gm.xy_bboxes, border, ij_border, np.full((len(boxes), 4), -1, np.int64))
    np.testing.assert_array_equal(got, ref)
