"""Device helpers shared by the kernel wrappers.

* :func:`on_cpu` decides, from the tensors a wrapper was given, whether the
  plain PyTorch version runs (every tensor on the CPU) or the CUDA kernel
  (every tensor on one CUDA device); anything else raises.
* :func:`require_cuda` validates one kernel argument before its pointer is
  handed to the CUDA library.
* :data:`LAUNCHES` counts kernel launches by kernel name.  A wrapper adds
  one right after its kernel launched, and nowhere else, so a run can show
  that its path went through the kernels.
"""

from __future__ import annotations

from collections import Counter

import torch

LAUNCHES: Counter = Counter()


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
