"""K5 and K6: the window reductions (coarsening).

``coarsen_reduce`` (K5, ``csrc/coarsen_reduce.cu``) and ``coarsen_rank``
(K6, ``csrc/coarsen_rank.cu``) replace the XLA device path of
``xcube_resampling_tpu/ops/coarsen_ops.py``: ``coarsen_jax`` (:36-87) and
``_mode_jax`` (:95-148).  Every ``j_div x i_div`` window of the trailing
(H, W) dims becomes one value.  K5 takes the statistics (``mean``, ``sum``,
``std``, ``var``, ``min``, ``max``, ``prod``, ``count``) and the positional
picks (``first``, ``last``, ``center``); K6 the rank reducers ``mode`` and
``median``.  :func:`coarsen` dispatches by name (or ``AGG_METHODS``
callable); each wrapper runs :func:`coarsen_plain` for CPU tensors and
launches its kernel for CUDA tensors, or raises.

Semantics, those of ``coarsen_jax`` under x64:

* float windows are NaN-aware: an all-NaN window gives NaN for ``mean``,
  ``std``, ``var``, ``min``, ``max`` and ``median``, 0 for ``sum`` and 1
  for ``prod``; ``count`` counts NaN as nonzero;
* ``sum``, ``prod`` and ``count`` of integers and bool come back int64
  (uint64 for unsigned ``sum`` and ``prod``), ``count`` of floats int64;
* the statistics accumulate in float64 and round once: to the float
  dtype (float16 once, bfloat16 through float32), or with ``rint`` (and
  saturation) back to the integer dtype or bool (``rint(x) != 0``).
  JAX's float16 and bfloat16 sums round to their dtype as they go: the
  two agree within that rounding.  JAX's float32 sums follow XLA's order
  and its statistics of integers up to 32 bits and of bool go through
  float32, so float results agree within a few float32 ulp and integer
  ones exactly while the float32 sums are exact;
* ``mode``: the smallest value among those of the highest count, NaN
  only for an all-NaN window (NaN never equals itself), whatever the
  formulation: :func:`_mode_plain` keeps both of JAX's (pairwise for up to
  64 taps, sort and run length above), K6 counts pairs for every size
  (each pair once, from registers up to 32 taps);
* ``median``: the middle of the valid taps; of an even count
  ``(lo + hi) * 0.5`` in the data's float type (float64 for integers,
  then ``rint``), as ``jnp.nanmedian`` gives it.  ``torch.nanmedian`` is
  not this function: it returns the lower middle.
"""

from __future__ import annotations

import torch

from .. import _build
from .._device import (
    DTYPE_CODES,
    count_launch,
    launch_name,
    narrow,
    on_cpu,
    order_key,
    require_data_dtype,
    round_to,
    to_f64,
    widen,
)
from ..constants import AGG_METHODS

_F64 = torch.float64

# The kernels' codes of the reducers (csrc/coarsen_reduce.cu)
REDUCERS = {
    "mean": 0, "sum": 1, "std": 2, "var": 3, "min": 4, "max": 5, "prod": 6,
    "count": 7, "first": 8, "last": 8, "center": 8,
}
RANKS = {"mode": 0, "median": 1}

#: window size above which the O(w^2) pairwise mode yields to the
#: O(w log w) sort-based mode (the JAX package's _MODE_PAIRWISE_MAX_W)
_MODE_PAIRWISE_MAX_W = 64

# K6 holds windows of up to 32 taps in registers; above, it stages each
# thread's window in shared memory up to this many bytes a block (else it
# reads the taps from device memory)
RANK_SMEM = 96 * 1024


def agg_name(agg) -> str:
    """The name of an aggregation given by name or ``AGG_METHODS``
    callable (``coarsen_ops.coarsen:158-164``)."""
    if isinstance(agg, str):
        if agg not in REDUCERS and agg not in RANKS:
            raise ValueError(f"unsupported aggregation {agg!r}")
        return agg
    for name, fn in AGG_METHODS.items():
        if fn is agg:
            return name
    raise ValueError("the device reducers need an aggregation name")


def out_dtype(dtype: torch.dtype, agg: str) -> torch.dtype:
    """The result dtype of *agg* on *dtype*, as JAX gives it under x64."""
    if agg == "count":
        return torch.int64
    if agg in ("sum", "prod") and not dtype.is_floating_point:
        unsigned = dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
        return torch.uint64 if unsigned else torch.int64
    return dtype


def round_stat(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float64 statistic back in *dtype* as ``coarsen_jax``'s
    ``int_roundtrip``: ``rint`` first for integers and bool, then
    :func:`.._device.round_to`."""
    if dtype == torch.bool:
        return round_to(torch.round(x), dtype)
    return round_to(x, dtype)


def _pick(agg: str, j_div: int, i_div: int) -> tuple[int, int]:
    """The window position of a positional pick."""
    return {
        "first": (0, 0), "last": (j_div - 1, i_div - 1),
        "center": (j_div // 2, i_div // 2),
    }[agg]


def pick_tap(agg: str, j_div: int, i_div: int) -> tuple[int, int]:
    """The kernels' (pa, pb) argument: a pick's window position, (0, 0)
    for the other reducers."""
    return _pick(agg, j_div, i_div) if REDUCERS[agg] == 8 else (0, 0)


def window_reshape(array, j_div: int, i_div: int):
    """Reshape the trailing (H, W) dims into (H/j_div, j_div, W/i_div, i_div)
    windows; H, W must be exact multiples."""
    *batch, h, w = array.shape
    if h % j_div or w % i_div:
        raise ValueError(f"coarsen requires exact multiples: {h}x{w} by {j_div}x{i_div}")
    return array.reshape(*batch, h // j_div, j_div, w // i_div, i_div)


def _windows(block):
    """(..., oh, j_div, ow, i_div) -> (..., oh, ow, j_div * i_div), taps in
    row-major window order."""
    moved = block.movedim(-3, -2)
    return moved.reshape(moved.shape[:-2] + (-1,))


def _mode_plain(flat):
    """Mode of each row of *flat* (N, w), ``_mode_jax``'s two formulations
    (values compared in *flat*'s own signed order: see
    ``_device.order_key``)."""
    w = flat.shape[1]
    if 1 < w <= _MODE_PAIRWISE_MAX_W:
        counts = torch.zeros(flat.shape, dtype=torch.int32, device=flat.device)
        for j in range(w):
            counts += (flat == flat[:, j : j + 1]).to(torch.int32)
        best_c, best_v = counts[:, 0], flat[:, 0]
        for i in range(1, w):
            ci, vi = counts[:, i], flat[:, i]
            better = (ci > best_c) | ((ci == best_c) & (vi < best_v))
            best_c = torch.where(better, ci, best_c)
            best_v = torch.where(better, vi, best_v)
        return best_v
    s = torch.sort(flat, dim=1).values  # NaN sorts last
    idx = torch.arange(w, device=flat.device)
    new_group = torch.ones(s.shape, dtype=torch.bool, device=flat.device)
    new_group[:, 1:] = s[:, 1:] != s[:, :-1]
    start = torch.cummax(torch.where(new_group, idx, 0), dim=1).values
    best = torch.argmax(idx - start + 1, dim=1)  # the first longest run
    return torch.gather(s, 1, best[:, None])[:, 0]


def _median_plain(flat, dtype):
    """NaN-aware median of each row of *flat* (N, w)."""
    s = torch.sort(flat, dim=1).values  # NaN sorts last
    n = (~torch.isnan(s)).sum(dim=1) if dtype.is_floating_point else torch.full(
        (s.shape[0],), s.shape[1], device=s.device
    )
    lo = torch.gather(s, 1, ((n - 1) // 2).clamp(min=0)[:, None])[:, 0]
    hi = torch.gather(s, 1, (n // 2).clamp(max=s.shape[1] - 1)[:, None])[:, 0]
    if dtype.is_floating_point:
        mid = torch.where(n % 2 == 1, lo, (lo + hi) * 0.5)
        return torch.where(n == 0, torch.nan, mid)
    lo, hi = (to_f64(order_key(t, dtype), dtype) for t in (lo, hi))
    return round_stat(torch.where(n % 2 == 1, lo, (lo + hi) * 0.5), dtype)


def coarsen_plain(array, j_div: int, i_div: int, agg: str):
    """Plain PyTorch version of K5 and K6: every aggregation by name."""
    require_data_dtype(array.dtype, "the coarsened array")
    dtype = array.dtype
    is_float = dtype.is_floating_point
    block = window_reshape(array, j_div, i_div)
    if agg in ("first", "last", "center"):
        j, i = _pick(agg, j_div, i_div)
        return block[..., j, :, i]
    # torch has few reductions of the unsigned 16- to 64-bit dtypes and
    # bool: integers widened, compared in their own order (order_key)
    block = widen(block)
    if dtype == torch.bool:
        block = block.to(torch.uint8)
    x = _windows(block)
    if agg in RANKS:
        lead = x.shape[:-1]
        flat = order_key(x.reshape(-1, x.shape[-1]), dtype)
        if agg == "mode":
            return narrow(order_key(_mode_plain(flat), dtype), dtype).reshape(lead)
        return _median_plain(flat, dtype).reshape(lead)
    if agg == "count":
        return (x != 0).sum(dim=-1)
    if agg in ("min", "max"):
        if not is_float:
            key = order_key(x, dtype)
            m = key.amin(dim=-1) if agg == "min" else key.amax(dim=-1)
            return narrow(order_key(m, dtype), dtype)
        nan = torch.isnan(x)
        big = torch.inf if agg == "min" else -torch.inf
        filled = torch.where(nan, big, x)
        m = filled.amin(dim=-1) if agg == "min" else filled.amax(dim=-1)
        return torch.where(nan.all(dim=-1), torch.nan, m).to(dtype)
    if agg in ("sum", "prod"):
        if not is_float:
            v = x.to(torch.int64)
            r = v.sum(dim=-1) if agg == "sum" else v.prod(dim=-1)
            return r.view(out_dtype(dtype, agg))
        v = torch.where(torch.isnan(x), 0.0 if agg == "sum" else 1.0, x.to(_F64))
        return round_to(v.sum(dim=-1) if agg == "sum" else v.prod(dim=-1), dtype)
    # mean, std, var: float64 moments over the valid taps
    v = to_f64(x, dtype)
    valid = ~torch.isnan(v)
    n = valid.sum(dim=-1)
    mean = torch.where(valid, v, 0.0).sum(dim=-1) / n
    if agg != "mean":
        centered = torch.where(valid, v - mean[..., None], 0.0)
        mean = (centered * centered).sum(dim=-1) / n
        if agg == "std":
            mean = torch.sqrt(mean)
    return round_stat(mean, dtype)


def _prepare(array, j_div, i_div, agg):
    require_data_dtype(array.dtype, "the coarsened array")
    if j_div < 1 or i_div < 1:
        raise ValueError(f"window divisors must be positive: {j_div}, {i_div}")
    *lead, h, w = array.shape
    if h % j_div or w % i_div:
        raise ValueError(f"coarsen requires exact multiples: {h}x{w} by {j_div}x{i_div}")
    x = array.reshape((-1, h, w)).contiguous()
    out = torch.empty(
        (x.shape[0], h // j_div, w // i_div),
        dtype=out_dtype(array.dtype, agg), device=array.device,
    )
    return tuple(lead), x, out


def coarsen_reduce(array, j_div: int, i_div: int, agg: str):
    """K5: a statistic or positional pick of every window,
    (..., H/j_div, W/i_div)."""
    if agg not in REDUCERS:
        raise ValueError(f"K5 reduces {sorted(REDUCERS)}, not {agg!r}")
    if on_cpu(array):
        return coarsen_plain(array, j_div, i_div, agg)
    lead, x, out = _prepare(array, j_div, i_div, agg)
    if out.numel():
        pa, pb = pick_tap(agg, j_div, i_div)
        lib = _build.load()
        with torch.cuda.device(array.device):
            rc = lib.xrt_coarsen_reduce(
                x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], x.shape[2],
                j_div, i_div, REDUCERS[agg], pa, pb, DTYPE_CODES[array.dtype],
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(lib, rc, "coarsen_reduce")
        count_launch(launch_name("coarsen_reduce", array.dtype))
    return out.reshape(lead + out.shape[-2:])


def rank_block_threads(taps: int, itemsize: int) -> int:
    """K6's threads a block for windows above 32 taps: the most of 128, 64
    or 32 whose windows fit :data:`RANK_SMEM`; 0 where not even 32 fit
    (the kernel then reads its taps from device memory, 128 threads a
    block).  Smaller windows live in registers and ignore it."""
    for threads in (128, 64, 32):
        if taps * threads * itemsize <= RANK_SMEM:
            return threads
    return 0


def coarsen_rank(array, j_div: int, i_div: int, agg: str):
    """K6: the mode or median of every window, (..., H/j_div, W/i_div)."""
    if agg not in RANKS:
        raise ValueError(f"K6 computes {sorted(RANKS)}, not {agg!r}")
    if on_cpu(array):
        return coarsen_plain(array, j_div, i_div, agg)
    lead, x, out = _prepare(array, j_div, i_div, agg)
    if out.numel():
        threads = rank_block_threads(j_div * i_div, x.element_size())
        lib = _build.load()
        with torch.cuda.device(array.device):
            rc = lib.xrt_coarsen_rank(
                x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], x.shape[2],
                j_div, i_div, RANKS[agg], DTYPE_CODES[array.dtype], threads,
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(lib, rc, "coarsen_rank")
        count_launch(launch_name("coarsen_rank", array.dtype))
    return out.reshape(lead + out.shape[-2:])


def coarsen(array, j_div: int, i_div: int, agg):
    """Window-reduce *array* (a tensor) by an aggregation name or
    ``AGG_METHODS`` callable: K6 for ``mode`` and ``median``, K5 for the
    rest; (1, 1) windows return *array* itself, as the JAX package does."""
    name = agg_name(agg)
    if j_div == 1 and i_div == 1:
        return array
    if name in RANKS:
        return coarsen_rank(array, j_div, i_div, name)
    return coarsen_reduce(array, j_div, i_div, name)
