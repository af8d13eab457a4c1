"""The port's sharded exact separable warp (``make_sharded_esw_step``, K13's
band form after the halo exchange) against the JAX package's, on the CPU.

JAX shards over its virtual 8-device CPU mesh (``tests/conftest.py``), the
port over a mesh of CPU devices, on the same numpy inputs from a seed,
float32: a 0.5 deg EPSG:4326 source over Greenland onto an
EPSG:3413 polar stereographic target, a rotation past the two-pass gate.
Expected: the step and ``sharded_reproject`` equal JAX's bit for bit, NaN
masks included, with the same halo, for n = 2, 4 and 8 and every method.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu import parallel as jpar  # noqa: E402
from xcube_resampling_tpu.parallel import halo as jhalo  # noqa: E402
from xcube_resampling_tpu_torch import parallel as ppar  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw as pesw  # noqa: E402
from xcube_resampling_tpu_torch.parallel import halo as phalo  # noqa: E402

METHODS = ("bilinear", "nearest", "triangular")
CPU = torch.device("cpu")
# 64 x 48 cells from 70 W, 60 N onto 48^2 at 30 km around their centre:
# past the two-pass gate (the sharded SRW refuses), S = 4
SOURCE = dict(size=(64, 48), xy_min=(-70.0, 60.0), xy_res=0.5, crs="epsg:4326")
TARGET = dict(size=(48, 48), xy_min=(-1027500.0, -2661000.0), xy_res=30000.0,
              crs="epsg:3413")
# tests/test_torch_slice.py's reduced BASELINE #3: a singular warp
SINGULAR = (
    dict(size=(720, 360), xy_min=(-180.0, -90.0), xy_res=0.5, crs="epsg:4326"),
    dict(size=(384, 384), xy_min=(2000000.0, 1000000.0), xy_res=16000.0, crs="epsg:3035"),
)


def _gms(src=SOURCE, tgt=TARGET):
    return (
        (jx.GridMapping.regular(**src), jx.GridMapping.regular(**tgt)),
        (pt.GridMapping.regular(**src), pt.GridMapping.regular(**tgt)),
    )


def _data(seed=5):
    """2 bands in [0, 1), the second with NaN and +-inf rows and columns
    (on band boundaries of the meshes and on the source's edges)."""
    w, h = SOURCE["size"]
    x = np.random.default_rng(seed).random((2, h, w), dtype=np.float32)
    x[1, 0], x[1, -1], x[1, :, 0], x[1, :, -1] = np.nan, np.inf, -np.inf, np.nan
    x[1, 12], x[1, 24], x[1, 30:33, 10:50] = np.inf, np.nan, -np.inf
    return x


def _jax_mesh(n):
    return jpar.make_mesh(("bands",), devices=jax.devices()[:n])


def _port_mesh(n):
    return ppar.make_mesh(devices=[CPU] * n)


@pytest.fixture
def jax_halos(monkeypatch):
    """The halo JAX's band step exchanges, recorded as it traces."""
    seen = []
    orig = jhalo._exchange_halo

    def spy(src_band, halo, *args):
        seen.append(halo)
        return orig(src_band, halo, *args)

    monkeypatch.setattr(jhalo, "_exchange_halo", spy)
    return seen


def _pad_jax(data, pad):
    src = jnp.asarray(data)
    if pad:
        src = jnp.pad(src, [(0, 0)] * (src.ndim - 2) + [(0, pad), (0, 0)],
                      constant_values=np.nan)
    return src


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_esw_step_matches_jax(jax_halos, n, method):
    """make_sharded_esw_step: the same padding, rows and halo as JAX's, and
    the same output bit for bit (band 0 from its negative offset)."""
    (jsrc, jtgt), (psrc, ptgt) = _gms()
    jb = jpar.make_sharded_esw_step(_jax_mesh(n), jsrc, jtgt, interp_method=method,
                                    src_batch_dims=1)
    pb = ppar.make_sharded_esw_step(_port_mesh(n), psrc, ptgt, interp_method=method,
                                    src_batch_dims=1)
    assert jb is not None and pb is not None
    assert pb[1] == jb[1]
    step, (pad, out_h) = pb
    assert isinstance(step, phalo.ShardedESWStep) and step.use_halo
    data = _data()
    ref = np.asarray(jb[0](_pad_jax(data, pad)))[..., :out_h, :]
    src = torch.nn.functional.pad(torch.from_numpy(data), (0, 0, 0, pad), value=float("nan"))
    got = step(src)
    assert len(got.bands) == n
    np.testing.assert_array_equal(got.full().numpy(), ref)
    np.testing.assert_array_equal(step.plain(src).full().numpy(), ref)
    assert set(jax_halos) == {step.halo}
    assert np.isfinite(ref[0]).mean() > 0.5


@pytest.mark.parametrize("method", METHODS)
def test_sharded_reproject_runs_the_esw_like_jax(monkeypatch, jax_halos, method):
    """sharded_reproject over 8 bands past the gate: the port refuses the
    sharded SRW and runs the sharded ESW, as JAX does, with JAX's halo; the
    outputs are equal bit for bit."""
    (jsrc, jtgt), (psrc, ptgt) = _gms()
    built = []
    orig = phalo.make_sharded_esw_step

    def spy(*args, **kwargs):
        b = orig(*args, **kwargs)
        built.append(b)
        return b

    monkeypatch.setattr(phalo, "make_sharded_esw_step", spy)
    regrid = []
    monkeypatch.setattr(phalo, "make_sharded_regrid_step",
                        lambda *a, **k: regrid.append(1))
    data = _data()
    ref = np.asarray(jpar.sharded_reproject(jnp.asarray(data), jsrc, jtgt, _jax_mesh(8),
                                            interp_method=method))
    got = ppar.sharded_reproject(torch.from_numpy(data), psrc, ptgt, _port_mesh(8),
                                 interp_method=method)
    assert len(built) == 1 and built[0] is not None and not regrid
    np.testing.assert_array_equal(got.full().numpy(), ref)
    assert set(jax_halos) == {built[0][0].halo} and built[0][0].halo > built[0][0].band_h


@pytest.mark.parametrize("method", METHODS)
def test_band_counts_agree(method):
    """The band form computes K13's function at global rows: the step over
    1, 2, 3 and 8 bands gives one raster bit for bit, and over 1 band it is
    K13 (no window) on the whole source."""
    (_, _), (psrc, ptgt) = _gms()
    data = torch.from_numpy(_data())
    outs = []
    for n in (1, 2, 3, 8):
        step, (pad, _) = ppar.make_sharded_esw_step(_port_mesh(n), psrc, ptgt,
                                                    interp_method=method, src_batch_dims=1)
        outs.append(step(torch.nn.functional.pad(data, (0, 0, 0, pad),
                                                 value=float("nan"))).full())
    for o in outs[1:]:
        assert torch.equal(o.isnan(), outs[0].isnan())
        assert torch.equal(o.nan_to_num(), outs[0].nan_to_num())
    p = step.plan
    k13 = pesw.esw_gather_plain(
        data, torch.from_numpy(p.iystar_c), torch.from_numpy(p.ix_c), torch.from_numpy(p.iy_c),
        p.step, p.n_samples, p.out_h, p.out_w, p.src_h, p.src_w, 0, 0, method, np.nan)
    assert torch.equal(k13.nan_to_num(), outs[0].nan_to_num())


def test_sharded_esw_refuses_where_jax_does():
    """None in both packages: a singular warp, a tap budget the warp
    exceeds, too few samples, an unknown method."""
    (jsrc, jtgt), (psrc, ptgt) = _gms(*SINGULAR)
    assert jpar.make_sharded_esw_step(_jax_mesh(4), jsrc, jtgt) is None
    assert ppar.make_sharded_esw_step(_port_mesh(4), psrc, ptgt) is None
    (jsrc, jtgt), (psrc, ptgt) = _gms()
    for kwargs in (dict(max_taps=12), dict(max_samples=3), dict(interp_method="cubic")):
        assert jpar.make_sharded_esw_step(_jax_mesh(4), jsrc, jtgt, **kwargs) is None
        assert ppar.make_sharded_esw_step(_port_mesh(4), psrc, ptgt, **kwargs) is None
    assert ppar.make_sharded_srw_step(_port_mesh(4), psrc, ptgt) is None
