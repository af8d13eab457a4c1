"""The port's type layer, affine engine and coarsening, and K1's in-place
read, on the JAX package's thirteen data dtypes, against it on the CPU.
Inputs and tolerance classes: ``tests/dtype_cases.py``."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from xcube_resampling_tpu import affine as jax_affine  # noqa: E402
from xcube_resampling_tpu.ops import coarsen_ops as jax_coarsen  # noqa: E402
from xcube_resampling_tpu.ops import gather as jax_gather  # noqa: E402
import xcube_resampling_tpu_torch as port  # noqa: E402
from xcube_resampling_tpu_torch import _build  # noqa: E402
from xcube_resampling_tpu_torch import affine as port_affine  # noqa: E402
from xcube_resampling_tpu_torch._device import DTYPE_CODES, from_numpy, round_to  # noqa: E402
from xcube_resampling_tpu_torch.ops import coarsen_ops as port_coarsen  # noqa: E402
from xcube_resampling_tpu_torch.ops import gather as port_gather  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as port_srw  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw_kernels  # noqa: E402

from .dtype_cases import AGGS, DTYPES, data, gms, match  # noqa: E402


# -- the type layer: XLA's conversions, pinned ----------------------------


ROUNDING = {
    # float64 past the top of the 64-bit ranges saturates; 2^63 and 2^64,
    # which float64 holds and no 64-bit integer does, too (x86's own
    # conversion gives INT64_MIN)
    "int64-top": ("int64", [2.0**63, 2.0**63 - 1024, 1e30, -1e30, -(2.0**63), np.nan, 2.5]),
    "uint64-top": ("uint64", [2.0**64, 2.0**64 - 4096, 2.0**63, 1e30, -1.0, np.nan, 0.5]),
    # halfway in float16 but not in float32: XLA rounds once (up), a cast
    # through float32 twice (to even)
    "float16-halfway": ("float16", [1 + 2.0**-11 + 2.0**-40, -(1 + 2.0**-11 + 2.0**-40),
                                    65519.99, 1e6, np.nan]),
    # bfloat16: XLA (and ml_dtypes) round through float32
    "bfloat16-halfway": ("bfloat16", [1 + 2.0**-8 + 2.0**-40, 3.0e38, np.nan]),
    "bool": ("bool", [0.0, -0.0, 0.4, np.nan, -1e-300]),
}


@pytest.mark.parametrize("case", sorted(ROUNDING))
def test_round_to_matches_xla(case):
    """``_device.round_to`` (and with it ``kernel_types.h``'s
    ``round_from``, the same steps) against ``jnp.rint(x).astype(dtype)``
    for integers and ``x.astype(dtype)`` otherwise, as JAX rounds a float64
    result back to the data dtype."""
    name, values = ROUNDING[case]
    x = np.asarray(values, dtype=np.float64)
    jx_ = jnp.asarray(x)
    ref = (jnp.rint(jx_) if np.dtype(name).kind in "iu" else jx_).astype(name)
    got = round_to(torch.from_numpy(x), getattr(torch, name))
    match(got, ref)


# -- the affine engine and coarsening --------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_affine_and_coarsen_match_jax(dtype):
    """K4 (nearest and bilinear, two fills), K5 and K6 (every reducer of
    2x3 windows; JAX's jitted once a dtype), K4's downscale form and the
    chain K4 -> K6 (mean, first, mode, median), with and without the
    two-pass NaN recovery, against JAX's device path
    (``gather.affine_gather``, ``coarsen_jax``, ``affine._resample_array``)."""
    x = data(dtype, (2, 8, 12))
    t = from_numpy(x)
    for order in (0, 1):
        for fill in (np.nan, -3):
            ref = jax_gather.affine_gather(jnp.asarray(x), 0.7, 0.55, -0.6, 0.3, 11, 19, order,
                                           fill)
            if ref.dtype != x.dtype:  # affine._gather_resample's cast back
                ref = (jnp.rint(ref) if x.dtype.kind in "ui" else ref).astype(x.dtype)
            got = port_gather.affine_gather(t, 0.7, 0.55, -0.6, 0.3, 11, 19, order, fill)
            match(got, ref)
    refs = jax.jit(lambda a: [jax_coarsen.coarsen_jax(a, 2, 3, agg) for agg in AGGS])(
        jnp.asarray(x))
    for agg, ref in zip(AGGS, refs):
        match(port_coarsen.coarsen(t, 2, 3, agg), ref, agg, 6)
    mat = ((2.4, 0.0, 0.3), (0.0, 2.2, -0.4))
    for agg, recover in (("mean", False), ("mean", True), ("first", False), ("mode", False),
                         ("median", True)):
        ref = jax_affine._resample_array(jnp.asarray(x), mat, (2, 3, 4), 1, agg, recover, np.nan)
        got = port_affine._resample_array(t, mat, (2, 3, 4), 1, agg, recover, np.nan)
        match(got, ref, agg, 9)


# -- K1 reads its source in place ------------------------------------------


class _FakeLib:
    """Stands for the kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.mark.parametrize("dtype", ["uint16", "bool", "float16", "int64", "float64"])
def test_k1_reads_its_source_in_place(monkeypatch, dtype):
    """K1's CUDA branch (steered there with CPU tensors, its library a
    recorder): the source reaches the launch as it is, no float32 copy
    first: the pointer of the caller's tensor and the dtype's code;
    ``v`` is float32 (float64 for float64), and K2 takes it."""
    monkeypatch.setattr(srw_kernels, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(srw_kernels, "require_cuda", lambda *a, **k: None)
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    casts = []
    orig_to = torch.Tensor.to

    def spy_to(self, *args, **kwargs):
        out = orig_to(self, *args, **kwargs)
        if out.dtype == torch.float32 and self.dtype != torch.float32 and self.dim() == 3:
            casts.append(tuple(self.shape))
        return out

    monkeypatch.setattr(torch.Tensor, "to", spy_to)
    plan = port_srw.plan_srw(*gms(port))
    fn = port_srw.make_srw_fn(plan, "bilinear", np.nan, device="cpu")
    src = from_numpy(data(dtype, (1, 96, 96)))
    fn(src)
    (name, args), (name2, args2) = lib.calls
    assert name == "xrt_srw_vertical" and args[0] == src.data_ptr()
    assert args[-2] == DTYPE_CODES[src.dtype]
    assert name2 == ("xrt_srw_horizontal_f64" if dtype == "float64" else "xrt_srw_horizontal_f32")
    assert not casts
