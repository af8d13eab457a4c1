"""Static-shape tile batching, tile placement over a mesh, and sharded
results.

Port of ``xcube_resampling_tpu/parallel/tiling.py``: :func:`batch_tiles`
and :func:`untile` cut the trailing (H, W) dims of a numpy array or a
tensor into a batch of identically-shaped tiles and back;
:func:`shard_tile_axis` places a tile batch's leading axis over a mesh's
devices.  :class:`Sharded` is what a sharded step returns: one row band a
mesh entry, each on that entry's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import narrow, widen


def pad_rows(array: torch.Tensor, rows: int, fill, cols: int = 0) -> torch.Tensor:
    """*array* with *rows* rows (and *cols* columns) of *fill* appended, the
    fill cast to its dtype as ``jnp.pad``'s ``constant_values`` is
    (``ops.gather.fill_as``: saturating, NaN to 0 for integers; ``!= 0`` for
    bool), for every data dtype."""
    from ..ops.gather import fill_as
    from ..ops.reproject_ops import fill_scalar

    *lead, h, w = array.shape
    out_w = w + cols
    value = fill_scalar(fill_as(fill, array.dtype), array.dtype, array.device)
    out = torch.empty((*lead, h + rows, out_w), dtype=value.dtype, device=array.device)
    out.fill_(value)
    out[..., :h, :w] = widen(array)
    return narrow(out, array.dtype)


@dataclass
class TileBatch:
    """A batch of uniformly-shaped tiles cut from a 2D (+batch) array."""

    tiles: object  # (T, ..., th, tw)
    grid: tuple[int, int]  # (n_tiles_y, n_tiles_x)
    tile_shape: tuple[int, int]
    out_shape: tuple[int, int]


def batch_tiles(array, tile_h: int, tile_w: int, fill=0) -> TileBatch:
    """Cut the trailing (H, W) dims into a (T, ..., th, tw) batch, padding
    edge tiles with *fill* to keep shapes static."""
    *batch, h, w = array.shape
    nty = -(-h // tile_h)
    ntx = -(-w // tile_w)
    pad_h = nty * tile_h - h
    pad_w = ntx * tile_w - w
    if pad_h or pad_w:
        if isinstance(array, torch.Tensor):
            array = pad_rows(array, pad_h, fill, pad_w)
        else:
            pad = [(0, 0)] * len(batch) + [(0, pad_h), (0, pad_w)]
            array = np.pad(array, pad, mode="constant", constant_values=fill)
    # (..., nty, th, ntx, tw) -> (nty*ntx, ..., th, tw)
    array = array.reshape(*batch, nty, tile_h, ntx, tile_w)
    nb = len(batch)
    perm = [nb, nb + 2] + list(range(nb)) + [nb + 1, nb + 3]
    array = _permute(array, perm).reshape(nty * ntx, *batch, tile_h, tile_w)
    return TileBatch(array, (nty, ntx), (tile_h, tile_w), (h, w))


def untile(batch: TileBatch):
    """Reassemble a TileBatch into the full (…, H, W) array, trimming the
    edge padding."""
    tiles = batch.tiles
    nty, ntx = batch.grid
    th, tw = batch.tile_shape
    h, w = batch.out_shape
    t, *inner, _, _ = tiles.shape
    nb = len(inner)
    arr = tiles.reshape(nty, ntx, *inner, th, tw)
    perm = list(range(2, 2 + nb)) + [0, 2 + nb, 1, 3 + nb]
    arr = _permute(arr, perm).reshape(*inner, nty * th, ntx * tw)
    return arr[..., :h, :w]


def shard_tile_axis(tiles, mesh, axis_name: str = "tiles") -> list[torch.Tensor]:
    """A tile batch's leading axis split into ``mesh.shape[axis_name]``
    contiguous blocks, block ``k`` on ``mesh.devices[k]`` (as
    ``NamedSharding(mesh, P(axis_name))`` places them)."""
    n = mesh.shape[axis_name]
    if len(tiles) % n:
        raise ValueError(f"{len(tiles)} tiles do not divide over {n} devices")
    tiles = torch.as_tensor(tiles)
    return [part.to(dev) for part, dev in zip(torch.chunk(tiles, n), mesh.devices)]


@dataclass
class Sharded:
    """A raster sharded in row bands: ``bands[k]`` (…, band rows, W) lies
    on mesh entry ``k``'s device; the bands stacked and cut to ``out_h``
    rows are the raster."""

    bands: list[torch.Tensor]
    out_h: int

    def full(self, device=None) -> torch.Tensor:
        """The raster on *device* (default the first band's): the bands
        concatenated and trimmed to ``out_h`` rows."""
        device = self.bands[0].device if device is None else torch.device(device)
        out = torch.cat([b.to(device) for b in self.bands], dim=-2)
        return out[..., : self.out_h, :]


def _permute(array, perm):
    if isinstance(array, torch.Tensor):
        return array.permute(perm)
    return array.transpose(perm)
