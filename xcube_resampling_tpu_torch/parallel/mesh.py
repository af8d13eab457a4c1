"""Device meshes: the devices a sharded step places its row bands on.

Port of ``xcube_resampling_tpu/parallel/mesh.py``.  JAX's ``shard_map`` is
single-controller, and so is this port: one process holds every band
tensor of a mesh and drives every device.  A :class:`Mesh` is a tuple of
``torch.device`` s with axis names and a shape; a device may repeat, so
``[torch.device("cpu")] * 8`` stands for JAX's eight virtual CPU devices
and ``[torch.device("cuda", 0)] * 4`` shards four bands over one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod

import torch


@dataclass(frozen=True)
class Mesh:
    """*devices* laid out in *shape*, one name an axis; ``mesh.shape[name]``
    is an axis's size, as on a ``jax.sharding.Mesh``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(axis_names=("bands",), shape=None, devices=None) -> Mesh:
    """A :class:`Mesh` over *devices*, by default every CUDA device (raises
    ``RuntimeError`` where there is none).

    Args:
        axis_names: the mesh's axis names; default one band axis.
        shape: the mesh's shape; default every device on the first axis.
        devices: an explicit device list; entries may repeat.
    """
    axis_names = tuple(axis_names)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= "
                "(e.g. [torch.device('cpu')] * n) to build a mesh elsewhere"
            )
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices given")
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or prod(shape) != len(devices):
        raise ValueError(
            f"mesh shape {shape} does not fit {len(devices)} devices and axes {axis_names}"
        )
    return Mesh(devices, axis_names, shape)
