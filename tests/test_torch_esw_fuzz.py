"""The port's exact separable warp against the JAX package's on the 12
CRS pairs of ``tests/test_fuzz_esw.py``'s deterministic prefix, on the CPU.

The pairs come from that test's seed and draws (its sources and targets
from ``tests/test_fuzz_srw.py``'s pool, the method, and the data where it
plans).  For each, both packages plan or refuse alike, and where they plan
the port's ESW (K13's plain version on CPU tensors) equals JAX's
``make_esw_reproject_fn`` on ``jnp`` arrays bit for bit, NaN masks
included.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu.crs import Transformer as JaxTransformer  # noqa: E402
from xcube_resampling_tpu.ops import esw as jesw  # noqa: E402
from xcube_resampling_tpu_torch.ops import esw as pesw  # noqa: E402
from tests.test_fuzz_srw import _CENTERS, CRS_POOL  # noqa: E402

N_CASES = 12


def _fuzz_params(rng, crs):
    """tests/test_fuzz_srw.py:_rand_gm's draws, as GridMapping.regular's
    arguments."""
    if crs == "epsg:4326":
        w = int(rng.integers(64, 400))
        h = int(rng.integers(64, 300))
        res = float(rng.uniform(0.05, 0.3))
        lon0 = float(rng.uniform(-150, 120))
        lat0 = min(float(rng.uniform(-60, 40)), 88.0 - h * res)
        return dict(size=(w, h), xy_min=(lon0, lat0), xy_res=res, crs=crs)
    lon, lat = _CENTERS[crs]
    lon += float(rng.uniform(-3, 3))
    lat += float(rng.uniform(-3, 3))
    cx, cy = JaxTransformer.from_crs("epsg:4326", crs).transform(lon, lat)
    w = int(rng.integers(64, 384))
    h = int(rng.integers(64, 384))
    res = float(rng.uniform(300, 4000))
    return dict(size=(w, h), xy_min=(cx - w * res / 2, cy - h * res / 2), xy_res=res, crs=crs)


@functools.lru_cache(maxsize=1)
def _cases():
    """tests/test_fuzz_esw.py's loop, its draws in its order: per
    iteration None where it skips the pair, else (source and target
    arguments, method, data where JAX plans, else None)."""
    rng = np.random.default_rng(20260817)
    out = []
    for _ in range(N_CASES):
        out.append(None)
        src_crs, tgt_crs = (str(c) for c in rng.choice(CRS_POOL, 2, replace=False))
        try:
            sp = _fuzz_params(rng, src_crs)
            sgm = jx.GridMapping.regular(**sp)
            t = JaxTransformer.from_crs(src_crs, tgt_crs)
            tcx, tcy = t.transform((sgm.x_min + sgm.x_max) / 2, (sgm.y_min + sgm.y_max) / 2)
            if not (np.isfinite(tcx) and np.isfinite(tcy)):
                continue
            w = int(rng.integers(64, 256))
            h = int(rng.integers(64, 256))
            res = float(rng.uniform(0.3, 1.5)) * (
                (sgm.x_res if src_crs != "epsg:4326" else sgm.x_res * 1e5)
                / (1.0 if tgt_crs != "epsg:4326" else 1e5)
            )
            if tgt_crs == "epsg:4326" and abs(tcy) + h * res / 2 > 89:
                continue
            tp = dict(size=(w, h), xy_min=(tcx - w * res / 2, tcy - h * res / 2), xy_res=res,
                      crs=tgt_crs)
            tgm = jx.GridMapping.regular(**tp)
        except ValueError:
            continue
        interp = ("nearest", "bilinear", "triangular")[int(rng.integers(0, 3))]
        data = None
        if jesw.make_esw_reproject_fn(sgm, tgm, interp, np.nan) is not None:
            data = rng.random((sgm.height, sgm.width), dtype=np.float32)
        out[-1] = (sp, tp, interp, data)
    return out


def test_the_subset_plans():
    """Every iteration gives a pair, and most of them plan."""
    cases = _cases()
    assert all(c is not None for c in cases)
    assert sum(c[3] is not None for c in cases) >= 8


@pytest.mark.parametrize("k", range(N_CASES))
def test_fuzz_case_matches_jax(k):
    sp, tp, interp, data = _cases()[k]
    ctx = f"{sp['crs']}->{tp['crs']} {interp} {sp['size']}->{tp['size']}"
    jfn = jesw.make_esw_reproject_fn(jx.GridMapping.regular(**sp),
                                     jx.GridMapping.regular(**tp), interp, np.nan)
    pfn = pesw.make_esw_reproject_fn(pt.GridMapping.regular(**sp),
                                     pt.GridMapping.regular(**tp), interp, np.nan,
                                     device=torch.device("cpu"))
    assert (pfn is None) == (jfn is None) == (data is None), ctx
    if data is not None:
        ref = np.asarray(jfn(jnp.asarray(data)))
        np.testing.assert_array_equal(pfn(torch.from_numpy(data)).numpy(), ref, err_msg=ctx)
