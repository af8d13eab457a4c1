"""The port's kernels (xcube_resampling_tpu_torch) against the JAX package.

On the CPU every kernel wrapper runs its plain PyTorch version; the CUDA
kernels are held against those plain versions on the GPU by
``chip_smoke.py``.  Inputs are made from a numpy seed and fed to both
packages; each comparison states its tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from xcube_resampling_tpu.ops.pallas_kernels import (  # noqa: E402
    srw_vertical_pallas,
    srw_vertical_reference,
)
from xcube_resampling_tpu.ops.reproject_ops import (  # noqa: E402
    make_fused_reproject_fn as jax_make_fused_reproject_fn,
)
from xcube_resampling_tpu.ops.srw import (  # noqa: E402
    make_srw_fn as jax_make_srw_fn,
    plan_srw,
)
from xcube_resampling_tpu_torch._device import (  # noqa: E402
    LAUNCHES,
    numpy_dtype,
    on_cpu,
)
from xcube_resampling_tpu_torch.ops.reproject_ops import (  # noqa: E402
    fused_reproject,
    make_fused_reproject_fn,
)
from xcube_resampling_tpu_torch.ops.srw import (  # noqa: E402
    make_srw_fn,
    plan_to_device,
)
from xcube_resampling_tpu_torch.ops.srw_kernels import (  # noqa: E402
    srw_horizontal,
    srw_vertical,
)

from .test_srw import _case  # noqa: E402

METHODS = ["bilinear", "nearest", "triangular"]


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
    """The inputs of tests/test_pallas_kernels.py: bases running from -2
    past the last source row (out-of-range taps clamp to the edge)."""
    rng = np.random.default_rng(seed)
    src = rng.random((120, 256)).astype(np.float32)
    out_h = 100
    base = np.linspace(-2, 118, out_h).astype(np.int32)
    pos = base[:, None].astype(np.float32) + rng.random(
        (out_h, 256), np.float32
    ) * (d_taps - 2 if d_taps > 2 else 1)
    return src, pos, base


def _port_vertical(src, pos, base, d_taps):
    # one column tile spanning the whole width = one base per output row
    v, vd = srw_vertical(
        torch.from_numpy(src)[None], torch.from_numpy(pos),
        torch.from_numpy(base)[:, None], src.shape[1], d_taps, "bilinear",
    )
    assert vd is None
    return v[0].numpy()


@pytest.mark.parametrize("d_taps", [2, 5, 9])
def test_srw_vertical_plain_matches_reference_and_pallas(d_taps):
    """K1's plain version against the numpy twin within atol 1e-5, as
    tests/test_pallas_kernels.py uses (the port rounds its tap sums as
    fused multiply-adds, the twin does not), and against the Pallas kernel
    in interpret mode bit for bit (XLA contracts the same sums)."""
    src, pos, base = _vertical_case(d_taps)
    got = _port_vertical(src, pos, base, d_taps)
    np.testing.assert_allclose(
        got, srw_vertical_reference(src, pos, base, d_taps), atol=1e-5
    )
    pallas = np.asarray(
        srw_vertical_pallas(src, pos, base, d_taps, row_block=32, interpret=True)
    )
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("d_taps", [2, 5, 9])
def test_srw_vertical_plain_nan_row_reach(d_taps):
    """A NaN source row reaches exactly the outputs whose d_taps taps read
    it, zero-weight taps included: the XLA path's and the numpy twin's
    semantics (the Pallas kernel sums a wider window, so its NaN reach is
    wider and it is not the reference here)."""
    src, pos, base = _vertical_case(d_taps, seed=11)
    src[60] = np.nan
    got = _port_vertical(src, pos, base, d_taps)
    ref = srw_vertical_reference(src, pos, base, d_taps)
    assert np.isnan(ref).any()
    _assert_match(got, ref, atol=1e-5)


def _stack(shape, seed=0):
    """Two bands of seeded [0, 1) data with one NaN row in the second."""
    data = np.random.default_rng(seed).random((2,) + shape, dtype=np.float32)
    data[1, shape[0] // 2] = np.nan
    return data


@pytest.mark.parametrize("interp", METHODS)
def test_make_srw_fn_matches_jax(interp):
    """The port's tiled SRW (K1 + K2 plain) against JAX make_srw_fn on one
    shared plan, for a 2-band stack: equal for every method, NaN masks
    included (the port places its fused multiply-adds where XLA's CPU
    backend contracts)."""
    source_gm, target_gm, _ = _case()
    plan = plan_srw(source_gm, target_gm, col_tile=32, row_tile=32)
    assert plan is not None
    assert plan.base_v.shape[1] > 1 and plan.base_h.shape[0] > 1
    data = _stack((source_gm.height, source_gm.width))
    ref = np.asarray(jax_make_srw_fn(plan, interp, np.nan)(jnp.asarray(data)))
    got = make_srw_fn(plan, interp, np.nan)(torch.from_numpy(data))
    assert got.dtype == torch.float32 and got.shape == (2, 80, 80)
    _assert_match(got.numpy(), ref)
    assert np.isfinite(ref).mean() > 0.5


def test_plan_to_device_carries_the_plan():
    source_gm, target_gm, _ = _case()
    plan = plan_srw(source_gm, target_gm, col_tile=32, row_tile=32)
    state = plan_to_device(plan, "cpu")
    for name in ("iystar_c", "ix_c", "iy_c"):
        t = getattr(state, name)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), getattr(plan, name))
    for name in ("base_v", "base_h"):
        t = getattr(state, name)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), getattr(plan, name))
    assert (state.d_v, state.d_h, state.col_tile, state.row_tile) == (
        plan.d_v, plan.d_h, 32, 32,
    )
    assert (state.src_h, state.src_w, state.out_h, state.out_w) == (96, 96, 80, 80)


@pytest.mark.parametrize("interp", METHODS)
def test_fused_reproject_plain_matches_jax(interp):
    """K3's plain version against JAX make_fused_reproject_fn: equal for
    every method, NaN masks included (same fused multiply-add placement)."""
    source_gm, target_gm, _ = _case()
    data = _stack((source_gm.height, source_gm.width), seed=3)
    ref = np.asarray(
        jax_make_fused_reproject_fn(source_gm, target_gm, interp, np.nan)(
            jnp.asarray(data)
        )
    )
    got = make_fused_reproject_fn(source_gm, target_gm, interp, np.nan)(
        torch.from_numpy(data)
    )
    _assert_match(got.numpy(), ref)
    assert np.isfinite(ref).mean() > 0.5


def test_cpu_tensors_take_the_plain_versions_without_launches():
    source_gm, target_gm, _ = _case()
    data = torch.from_numpy(_stack((96, 96)))
    before = dict(LAUNCHES)
    plan = plan_srw(source_gm, target_gm, col_tile=32, row_tile=32)
    make_srw_fn(plan, "triangular", np.nan)(data)
    make_fused_reproject_fn(source_gm, target_gm, "bilinear", np.nan)(data)
    assert dict(LAUNCHES) == before


def test_wrappers_refuse_devices_without_a_kernel():
    """Tensors on neither the CPU nor a CUDA device, or on several
    devices, raise: a wrapper never moves data to find a kernel."""
    meta = torch.empty((1, 8, 8), device="meta")
    pos = torch.empty((4, 8), device="meta")
    base = torch.empty((4, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        srw_vertical(meta, pos, base, 8, 2, "bilinear")
    with pytest.raises(ValueError, match="several devices"):
        on_cpu(torch.zeros(1), meta)
    with pytest.raises(ValueError, match="several devices"):
        fused_reproject(
            torch.zeros((1, 8, 8)), torch.zeros((2, 2), device="meta"),
            torch.zeros((2, 2)), 16, 4, 4, "bilinear", np.nan,
        )
    with pytest.raises(ValueError, match="triangular needs"):
        srw_horizontal(
            torch.zeros((1, 4, 8)), torch.zeros((4, 4)),
            torch.zeros((1, 4), dtype=torch.int32), 4, 2, "triangular",
            torch.ones((4, 4), dtype=torch.bool), np.nan,
        )
    with pytest.raises(ValueError, match="SRW supports"):
        srw_vertical(torch.zeros((1, 8, 8)), torch.zeros((4, 8)),
                     torch.zeros((4, 1), dtype=torch.int32), 8, 2, "cubic")


def test_numpy_dtype_mapping():
    assert numpy_dtype(torch.float32) == np.float32
    assert numpy_dtype(torch.uint8) == np.uint8
    assert numpy_dtype(torch.int64) == np.int64
    with pytest.raises(TypeError):
        numpy_dtype(torch.bfloat16)
