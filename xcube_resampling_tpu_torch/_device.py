"""Device helpers shared by the kernel wrappers.

* :func:`on_cpu` decides, from the tensors a wrapper was given, whether the
  plain PyTorch version runs (every tensor on the CPU) or the CUDA kernel
  (every tensor on one CUDA device); anything else raises.
* :func:`require_cuda` validates one kernel argument before its pointer is
  handed to the CUDA library.
* :data:`LAUNCHES` counts kernel launches by kernel name.  A wrapper adds
  one right after its kernel launched, and nowhere else, so a run can show
  that its path went through the kernels.
* :data:`DTYPE_CODES` are the kernels' codes of the tensor dtypes
  (``csrc/kernel_types.h``); :data:`DATA_DTYPES` are the thirteen data
  dtypes the JAX package takes (float16 to float64, bfloat16, the signed
  and unsigned integers of 8 to 64 bits, bool), which every typed kernel
  takes, and :func:`require_data_dtype` refuses the others.
* :func:`round_to` rounds float64 values once to a data dtype, as the
  kernels and XLA store them; :func:`wrap_int` reduces integers to a
  dtype's bits, as integer arithmetic in that dtype wraps; :func:`widen`
  and :func:`narrow` carry the unsigned 16- to 64-bit dtypes, which have
  few torch operations, through signed ones; :func:`launch_name` names a
  launch on a dtype a kernel took later than the others.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

LAUNCHES: Counter = Counter()

DTYPE_CODES = {
    torch.float32: 0, torch.float64: 1, torch.int8: 2, torch.int16: 3,
    torch.int32: 4, torch.uint8: 5, torch.uint16: 6, torch.int64: 7,
    torch.uint32: 8, torch.uint64: 9, torch.float16: 10, torch.bfloat16: 11,
    torch.bool: 12,
}
DATA_DTYPES = tuple(DTYPE_CODES)


def require_data_dtype(dtype: torch.dtype, what: str) -> None:
    """Raise ``NotImplementedError`` unless *dtype* is one of
    :data:`DATA_DTYPES`."""
    if dtype not in DATA_DTYPES:
        names = ", ".join(str(d).removeprefix("torch.") for d in DATA_DTYPES)
        raise NotImplementedError(
            f"{what} is {dtype}: the port's kernels take {names}"
        )


def _f64_to_f16(x: torch.Tensor) -> torch.Tensor:
    """Float64 *x* rounded once to float16, as XLA converts it (a cast
    through float32 may round twice): rounded to odd into float32 (toward
    zero, its last bit set where inexact), then to nearest into float16,
    exact as float32 holds 13 more bits (``kernel_types.h:f64_to_f16``)."""
    f = x.to(torch.float32)
    over = f.to(torch.float64).abs() > x.abs()
    f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    inexact = (f.to(torch.float64) != x) & ~torch.isnan(x)
    bits = f.view(torch.int32) | inexact.to(torch.int32)
    return bits.view(torch.float32).to(torch.float16)


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float64 *x* rounded once to *dtype*, as XLA converts and the kernels
    store (``kernel_types.h:round_from``): a cast for float32 and float64;
    float16 rounded once, bfloat16 through float32; bool ``x != 0`` (NaN
    is true); for integer dtypes ``rint`` (half to even), then NaN to 0 and
    the dtype's range saturated (2^63 and 2^64, which float64 holds but no
    64-bit integer, to the largest)."""
    if dtype in (torch.float32, torch.float64):
        return x.to(dtype)
    if dtype == torch.float16:
        return _f64_to_f16(x)
    if dtype == torch.bfloat16:
        return x.to(torch.float32).to(dtype)
    if dtype == torch.bool:
        return x != 0
    info = torch.iinfo(dtype)
    r = torch.nan_to_num(torch.round(x), nan=0.0)
    if info.bits < 64:
        return r.clamp(info.min, info.max).to(dtype)
    top = r >= float(2**info.bits if dtype == torch.uint64 else 2**63)
    r = r.clamp(min=float(info.min))
    if dtype == torch.uint64:
        # float64 -> uint64 through int64's bits: above 2^63 less 2^64
        big = r >= 2.0**63
        bits = torch.where(big, r - 2.0**64, r).masked_fill(top, 0.0).to(torch.int64)
        return bits.masked_fill(top, -1).view(torch.uint64)
    return r.masked_fill(top, 0.0).to(torch.int64).masked_fill(top, info.max)


def widen(x: torch.Tensor) -> torch.Tensor:
    """*x* in a dtype with the torch operations (indexing, comparisons,
    sums) its own lacks on the CPU: uint16 as int32, uint32 as int64,
    uint64 as int64 bits (values of 2^63 and more negative, so compare
    them through :func:`order_key`); others as they are."""
    if x.dtype == torch.uint16:
        return x.to(torch.int32)
    if x.dtype == torch.uint32:
        return x.to(torch.int64)
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    return x


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`widen`'s inverse: *x* (holding *dtype*'s values, uint64 as
    int64 bits) as *dtype*."""
    if dtype == torch.uint64:
        return x.view(torch.uint64)
    return x.to(dtype)


def order_key(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Widened *x* of *dtype* in a form whose signed order is *dtype*'s:
    uint64's bits with the top bit flipped (an involution), else *x*."""
    if dtype == torch.uint64:
        return x ^ torch.tensor(-(2**63), dtype=torch.int64, device=x.device)
    return x


def to_f64(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """*x* (of *dtype*, widened or not; default its own) as float64,
    rounded once where float64 does not hold it (64-bit integers)."""
    if (dtype or x.dtype) == torch.uint64:
        return x.view(torch.uint64).to(torch.float64)
    return x.to(torch.float64)


def as_float32(x: torch.Tensor) -> torch.Tensor:
    """*x* as float32, as ``x.astype(jnp.float32)`` casts it (rounded
    once; bool to 0 and 1): the tiers that take their source as float32 (the
    batched SRW on float64, the aligned and hybrid SRW, the ESW, the region
    mosaics) cast in their wrapper."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy data as a tensor of its own dtype on *device*: bfloat16
    (``ml_dtypes``, which torch does not import) through its bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor's data on the host as numpy: bfloat16 through its bits as
    ``ml_dtypes.bfloat16`` (imported only for it)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes

        return x.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def wrap_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer *x* (int64) reduced to integer *dtype*'s bits, two's
    complement, as int64 (64-bit dtypes: *x* itself, as int64 arithmetic
    wraps; uint64's bits)."""
    n = torch.iinfo(dtype).bits
    if n == 64:
        return x
    if dtype.is_signed:
        return torch.remainder(x + 2 ** (n - 1), 2**n) - 2 ** (n - 1)
    return torch.remainder(x, 2**n)


# The dtypes each kernel took before it took all of DATA_DTYPES: a launch
# on another dtype counts under its kernel's name and the dtype
# (:func:`launch_name`), so that a run shows which instantiations ran.
SEVEN_DTYPES = DATA_DTYPES[:7]


def launch_name(name: str, dtype: torch.dtype, before=SEVEN_DTYPES) -> str:
    """*name*, or ``name.dtype`` where *dtype* is not one of *before*."""
    return name if dtype in before else f"{name}.{str(dtype).removeprefix('torch.')}"


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on the
    same CUDA device; raises ``ValueError`` for mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel arguments lie on several devices: {devices}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {device}")


def require_cuda(
    t: torch.Tensor,
    name: str,
    dtype: torch.dtype,
    shape: tuple[int, ...],
) -> None:
    """Raise unless *t* is a contiguous CUDA tensor of *dtype* and *shape*."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
