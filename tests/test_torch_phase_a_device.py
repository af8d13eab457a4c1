"""The device Phase A ladder of the port (``ops/phase_a.py``: the walk K19,
the tiled stencil K20, the scatter-min scan K21 and the dispatch among them
and the hybrid) against the JAX package's, on the CPU under x64.

The kernels' plain versions run on CPU tensors.  Tolerance classes:

* each tier's map equals JAX's float64 map of the same tier bit for bit,
  NaN positions included (``assert_array_equal``);
* each map is within 1e-9 of the host kernel's (``inverse_ij_map``), with
  the same NaN coverage (JAX's own bound, ``tests/test_rectify.py``);
* the tiled planner's plan equals JAX's ``PhaseAPlan`` field by field;
* ``rectify_dataset`` under ``XRTPU_PHASEA=device`` equals JAX's under the
  same setting bit for bit, and takes the tier JAX takes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as xrt  # noqa: E402
import xcube_resampling_tpu_torch as port  # noqa: E402
from xcube_resampling_tpu import rectify as jax_rectify  # noqa: E402
from xcube_resampling_tpu.constants import UV_DELTA  # noqa: E402
from xcube_resampling_tpu.ops import rectify_ops as jro  # noqa: E402
from xcube_resampling_tpu_torch import rectify as port_rectify  # noqa: E402
from xcube_resampling_tpu_torch.ops import phase_a  # noqa: E402
from xcube_resampling_tpu_torch.ops import rectify_ops as pro  # noqa: E402

from .sampledata import create_olci_like_swath  # noqa: E402
from .test_torch_rectify import _to_port, _with_jnp  # noqa: E402


def _geometry(width, height, tile, j_up=False):
    """An OLCI-like swath's (2, h, w) float64 coordinates and its default
    target as Phase A's arguments (dst shape, offsets, scales)."""
    ds = create_olci_like_swath(width=width, height=height, tile_size=tile)
    gm = xrt.GridMapping.from_dataset(ds)
    t = gm.to_regular(tile_size=tile)
    xy = np.array(gm.xy_coords.data, dtype=np.float64)
    x1, _, _, y2 = t.xy_bbox
    if j_up:
        return xy, ((t.height, t.width), x1, t.xy_bbox[1], t.x_res, t.y_res)
    return xy, ((t.height, t.width), x1, y2, t.x_res, -t.y_res)


def _case(name):
    """The geometries: a clean swath (j axis down and up; every tier takes
    it), NaN edge rows and column, a fold (two columns swapped over 30
    rows), NaN columns but an isolated last one (host blocks), and a NaN
    row with a jump of 80 pixels (the tiled planner refuses: an edge past
    8 tiles)."""
    if name == "j_up":
        return _geometry(96, 128, 32, j_up=True)
    xy, target = _geometry(160 if name == "host" else 96, 128, 32)
    if name == "nan_edge":
        xy[:, :2] = np.nan
        xy[:, :, -1] = np.nan
    elif name == "fold":
        r = slice(50, 80)
        xy[:, r, 40], xy[:, r, 41] = xy[:, r, 41].copy(), xy[:, r, 40].copy()
    elif name == "host":
        xy[:, :, 70:-1] = np.nan
    elif name == "none":
        xy[:, 40] = np.nan
        xy[0, :, 50:] += 80 * target[3]
    return xy, target


CASES = ["clean", "j_up", "nan_edge", "fold", "host", "none"]


def _args(name, i_min=0, j_min=0):
    xy, (dst, x_off, y_off, x_res, y_res) = _case(name)
    return (xy[0], xy[1], i_min, j_min, dst, x_off, y_off, x_res, y_res, UV_DELTA)


def _equal(got, ref):
    """Equal bit for bit, NaN positions included."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def _near_host(got, args):
    """Within 1e-9 of the host kernel, with its NaN coverage; returns it."""
    host = jro.inverse_ij_map(*args)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(host))
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-9, equal_nan=True)
    assert np.isfinite(host).mean() > 0.3
    return host


@pytest.mark.parametrize("name", ["clean", "j_up", "nan_edge", "fold"])
def test_walk_matches_jax(name):
    """K19's plain version through ``inverse_ij_map_walk`` equals JAX's
    float64 walk bit for bit on clean swaths (j axis down and up, a window
    origin), within 1e-9 of the host kernel; both refuse NaN and folds."""
    args = _args(name, *((3, 5) if name == "j_up" else (0, 0)))
    ref = jro.inverse_ij_map_walk(*args)
    got = phase_a.inverse_ij_map_walk(*args, device="cpu")
    if name in ("nan_edge", "fold"):
        assert ref is None and got is None
        return
    assert isinstance(got, pro.DeviceIJMap)
    _equal(got.as_numpy(), ref.as_numpy())
    _near_host(got.as_numpy(), args)


def test_walk_gate_refuses_an_edge_past_the_target():
    """The host gate's edge bound (the target's extent): a swath whose
    quads span more than the target refuses the walk in both packages."""
    xy, (dst, x_off, y_off, x_res, y_res) = _case("clean")
    args = (xy[0], xy[1], 0, 0, (12, 10), x_off, y_off, 40 * x_res, 40 * y_res, UV_DELTA)
    ref = jro.inverse_ij_map_walk(*args)
    got = phase_a.inverse_ij_map_walk(*args, device="cpu")
    assert (ref is None) == (got is None)
    args = (xy[0], xy[1], 0, 0, dst, x_off, y_off, x_res / 200, y_res / 200, UV_DELTA)
    assert jro.inverse_ij_map_walk(*args) is None
    assert phase_a.inverse_ij_map_walk(*args, device="cpu") is None


def _plan_fields(plan, jplan):
    """The port's PhaseAPlan against JAX's, field by field: class tile lists
    (JAX's padded to buckets of 256 by repeating the last), bases, windows,
    host tiles and blocks."""
    for key in ("tile", "nqi", "n_tj", "n_ti", "dst_h", "dst_w", "src_i_min", "src_j_min"):
        assert getattr(plan, key) == getattr(jplan, key), key
    assert plan.src_w_p - 1 == jplan.nqi and plan.src_h_p == jplan.gx_p.shape[0]
    np.testing.assert_array_equal(plan.g[0].numpy(), jplan.gx_p[: plan.g.shape[1], : plan.g.shape[2]])
    assert plan.cls_all["win"] == jplan.cls_all["win"]
    assert plan.cls_all["n_real"] == jplan.cls_all["n_real"]
    for key in ("bjs", "bis"):
        np.testing.assert_array_equal(plan.cls_all[key].numpy(), np.asarray(jplan.cls_all[key]))
    assert (plan.cls_band is None) == (jplan.cls_band is None)
    if plan.cls_band is not None:
        n = jplan.cls_band["n_real"]
        assert plan.cls_band["n_real"] == n and plan.cls_band["win"] == jplan.cls_band["win"]
        for key in ("sel", "tjs", "tis", "bjs", "bis"):
            j = np.asarray(jplan.cls_band[key])
            np.testing.assert_array_equal(plan.cls_band[key].numpy(), j[:n])
            assert (j[n:] == j[n - 1]).all()
    assert (plan.host_blocks is None) == (jplan.host_blocks is None)
    if plan.host_blocks is not None:
        sel, blocks = plan.host_blocks
        j_sel, (j_i, j_j) = jplan.host_blocks
        np.testing.assert_array_equal(sel.numpy(), np.asarray(j_sel))
        _equal(blocks.numpy(), np.stack([np.asarray(j_i), np.asarray(j_j)]))


@pytest.mark.parametrize("name", CASES)
def test_tiled_plan_and_map_match_jax(name):
    """plan_phase_a_device equals JAX's plan field by field (the band class
    on every case, the host blocks on the isolated column; None where an
    edge passes 8 tiles), and K20's plain version over it equals JAX's
    tiled map bit for bit, within 1e-9 of the host kernel."""
    args = _args(name, *((2, 7) if name == "j_up" else (0, 0)))
    jplan = jro.plan_phase_a_device(*args)
    plan = phase_a.plan_phase_a_device(*args, device="cpu")
    if name == "none":
        assert jplan is None and plan is None
        return
    _plan_fields(plan, jplan)
    assert plan.cls_band is not None
    assert (plan.host_blocks is not None) == (name == "host")
    ref = jplan.as_numpy(jplan.apply(*jplan.device_args()))
    got = phase_a._offset(plan.apply(), plan.src_i_min, plan.src_j_min).numpy()
    _equal(got, ref)
    _near_host(got, args)


@pytest.mark.parametrize("name", CASES)
def test_scatter_scan_matches_jax(name):
    """K21's plain version through ``_inverse_ij_map_device_scatter``
    equals JAX's float64 scan bit for bit (None where a quad spans more than
    16 pixels), within 1e-9 of the host kernel.  (JAX's adds a window
    origin into a read-only array and raises: the cases take none.)"""
    args = _args(name)
    ref = jro._inverse_ij_map_device_scatter(*args)
    got = phase_a._inverse_ij_map_device_scatter(*args, device="cpu")
    if ref is None:
        assert got is None and name == "none"
        return
    _equal(got, ref)
    _near_host(got, args)


@pytest.mark.parametrize("r", [(1, 1), (2, 3), (4, 4), (8, 8)])
@pytest.mark.parametrize("name", ["clean", "fold"])
def test_inverse_ij_map_jax_matches_jax(name, r):
    """``inverse_ij_map_jax`` with a candidate rectangle short of the quads'
    spans (its candidate k is row k // r_i, column k % r_i, inside the
    clipped bounds), as long as them and longer, a window origin: equal to
    JAX's bit for bit."""
    xy, (dst, x_off, y_off, x_res, y_res) = _case(name)
    # a coarser target: quads span several pixels
    args = (xy[0][::3, ::3].copy(), xy[1][::3, ::3].copy(), 3, 2, dst, x_off, y_off, x_res,
            y_res, UV_DELTA)
    ref = np.asarray(jro.inverse_ij_map_jax(jnp.asarray(args[0]), jnp.asarray(args[1]),
                                            *args[2:], r_i=r[1], r_j=r[0]))
    got = phase_a.inverse_ij_map_jax(torch.from_numpy(args[0]), torch.from_numpy(args[1]),
                                     *args[2:], r_i=r[1], r_j=r[0])
    assert got.device.type == "cpu"
    _equal(got.numpy(), ref)
    if r == (8, 8):
        _near_host(got.numpy(), args)


def _spy_ladder(monkeypatch, module, names):
    """Record each tier the ladder calls and whether it served the map."""
    calls = []
    for name in names:
        orig = getattr(module, name)

        def spy(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            calls.append((_name, out is not None and not isinstance(out, np.ndarray)))
            return out

        monkeypatch.setattr(module, name, spy)
    return calls


TIERS = ("inverse_ij_map_hybrid", "inverse_ij_map_walk", "plan_phase_a_device")


@pytest.mark.parametrize("env", [("", ""), ("0", ""), ("0", "0"), ("", "0")])
@pytest.mark.parametrize("name", ["clean", "nan_edge", "none"])
def test_ladder_takes_jax_tier(monkeypatch, name, env):
    """``inverse_ij_map_device`` calls JAX's tiers in JAX's order under both
    switches (``XRTPU_PHASEA_HYBRID``, ``XRTPU_PHASEA_WALK``), each serving
    or refusing as JAX's does, and returns JAX's map bit for bit (None where
    JAX's is None)."""
    monkeypatch.setenv("XRTPU_PHASEA_HYBRID", env[0])
    monkeypatch.setenv("XRTPU_PHASEA_WALK", env[1])
    args = _args(name)
    jax_calls = _spy_ladder(monkeypatch, jro, TIERS)
    port_calls = _spy_ladder(monkeypatch, phase_a, TIERS)
    ref = jro.inverse_ij_map_device(*args)
    got = phase_a.inverse_ij_map_device(*args, device="cpu")
    assert port_calls == jax_calls
    skipped = [TIERS[k] for k, e in enumerate(env) if e == "0"]
    assert not {c for c, _ in port_calls} & set(skipped)
    if ref is None:
        assert got is None and name == "none"
        return
    assert isinstance(got, pro.DeviceIJMap)
    _equal(got.as_numpy(), ref.as_numpy())


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("case", ["hybrid", "walk", "tiled", "fallback"])
def test_rectify_dataset_device_tier_matches_jax(monkeypatch, case, interp):
    """``rectify_dataset`` under ``XRTPU_PHASEA=device`` on a CPU tensor
    equals JAX's under the same setting on a ``jnp`` array bit for bit: a
    clean swath (the hybrid), the same with ``XRTPU_PHASEA_HYBRID=0`` (the
    walk), NaN edge rows (the tiled stencil), NaN rows and a jump past 8
    tiles (every tier refuses: K10 and K8 where JAX takes its host tiles)."""
    ds = create_olci_like_swath(width=80, height=100, tile_size=32)
    if case in ("tiled", "fallback"):
        lon, lat = np.array(ds.lon.data), np.array(ds.lat.data)
        lat[:2] = np.nan
        if case == "fallback":
            lon[:, 60:] += 80 * 0.0025
        ds = ds.assign_coords({"lon": xrt.DataArray(lon, dims=ds.lon.dims),
                               "lat": xrt.DataArray(lat, dims=ds.lat.dims)})
    monkeypatch.setenv("XRTPU_PHASEA", "device")
    monkeypatch.setenv("XRTPU_PHASEA_HYBRID", "0" if case == "walk" else "")
    calls = _spy_ladder(monkeypatch, phase_a, TIERS)
    # (the host tiles' map depends on the target's tiling: both take 32)
    ref = xrt.rectify_dataset(_with_jnp(ds, ["rad"]), interp_methods=interp, tile_size=32)
    got = port.rectify_dataset(_to_port(ds, ("rad",)), interp_methods=interp, tile_size=32,
                               device="cpu")
    served = [name for name, ok in calls if ok]
    assert served == {"hybrid": ["inverse_ij_map_hybrid"], "walk": ["inverse_ij_map_walk"],
                      "tiled": ["plan_phase_a_device"], "fallback": []}[case]
    g = got["rad"].data
    assert isinstance(g, torch.Tensor)
    _equal(g.numpy(), np.asarray(ref["rad"].data))
    assert np.isfinite(g.numpy()).mean() > 0.3


def test_fallback_map_equals_jax_host_tiles():
    """Where every tier refuses, the device tier's map is K10's tile plan
    then K8 (a DeviceIJMap), the JAX package's host tiles bit for bit."""
    ds = create_olci_like_swath(width=80, height=100, tile_size=32)
    lon, lat = np.array(ds.lon.data), np.array(ds.lat.data)
    lat[40] = np.nan
    lon[:, 50:] += 80 * 0.0025
    ds = ds.assign_coords({"lon": xrt.DataArray(lon, dims=ds.lon.dims),
                           "lat": xrt.DataArray(lat, dims=ds.lat.dims)})
    jgm = xrt.GridMapping.from_dataset(ds)
    pgm = port.GridMapping.from_dataset(_to_port(ds))
    ref = jax_rectify._inverse_ij_map(jgm, jgm.to_regular(tile_size=32), UV_DELTA)
    assert isinstance(ref, np.ndarray)
    got = port_rectify._inverse_ij_map(pgm, pgm.to_regular(tile_size=32), UV_DELTA, "cpu",
                                       tier="device")
    assert isinstance(got, pro.DeviceIJMap)
    _equal(got.as_numpy(), ref)


def test_rectify_ops_holds_the_ladder():
    """``rectify_ops`` holds the ladder's names, as the JAX package's does."""
    for name in phase_a.__all__:
        assert getattr(pro, name) is getattr(phase_a, name)
    assert hasattr(jro, "inverse_ij_map_device") and hasattr(jro, "PhaseAPlan")
    with pytest.raises(AttributeError):
        pro.no_such_name  # noqa: B018


@pytest.mark.parametrize("entry, source", [
    ("xrt_phase_a_walk", "phase_a_walk.cu"),
    ("xrt_phase_a_tiled", "phase_a_tiled.cu"),
    ("xrt_phase_a_scan", "phase_a_scan.cu"),
    ("xrt_hybrid_seed", "hybrid_phase_a.cu"),
])
def test_kernel_entries_match_their_bindings(entry, source):
    """K19-K21's C entries (and K11's, whose pass K19 shares through
    ``csrc/phase_a_common.h``) take as many arguments as their ctypes
    bindings pass; each source names the XLA kernel it replaces."""
    import re

    from xcube_resampling_tpu_torch import _build

    text = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m is not None
    assert len(m.group(1).split(",")) == len(_build._SIGNATURES[entry])
    assert "xcube_resampling_tpu/ops/rectify_ops.py" in text
    assert '#include "phase_a_common.h"' in text
