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
  (``csrc/kernel_types.h``); :data:`DATA_DTYPES` are the data dtypes that
  the affine gather and the coarsen reducers take, and
  :func:`require_data_dtype` refuses the others.
* :func:`round_to` rounds float64 values once to a data dtype, as the
  kernels store them; :func:`wrap_int` reduces integers to a dtype's bits,
  as integer arithmetic in that dtype wraps.
"""

from __future__ import annotations

from collections import Counter

import torch

LAUNCHES: Counter = Counter()

DTYPE_CODES = {
    torch.float32: 0, torch.float64: 1, torch.int8: 2, torch.int16: 3,
    torch.int32: 4, torch.uint8: 5, torch.uint16: 6,
}
DATA_DTYPES = (
    torch.float32, torch.float64, torch.int8, torch.int16, torch.int32,
    torch.uint8, torch.uint16,
)


def require_data_dtype(dtype: torch.dtype, what: str) -> None:
    """Raise ``NotImplementedError`` unless *dtype* is one of
    :data:`DATA_DTYPES`."""
    if dtype not in DATA_DTYPES:
        names = ", ".join(str(d).removeprefix("torch.") for d in DATA_DTYPES)
        raise NotImplementedError(
            f"{what} is {dtype}: the port's affine gather and coarsen reducers "
            f"take {names} so far (ROADMAP queue 1 item 12)"
        )


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float64 *x* rounded once to *dtype*: a cast for floats; for integer
    dtypes ``rint`` (half to even), then NaN to 0 and the dtype's range
    clamped, as XLA's and CUDA's float-to-integer conversions saturate."""
    if dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    return torch.nan_to_num(torch.round(x), nan=0.0).clamp(info.min, info.max).to(dtype)


def wrap_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer *x* (int64) reduced to integer *dtype*'s bits, two's
    complement, as int64."""
    n = torch.iinfo(dtype).bits
    if dtype.is_signed:
        return torch.remainder(x + 2 ** (n - 1), 2**n) - 2 ** (n - 1)
    return torch.remainder(x, 2**n)


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
