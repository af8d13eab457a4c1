"""The port's copies of the host layers against the JAX package's originals.

``xcube_resampling_tpu_torch`` keeps its own copies of the CRS engine, the
grid mappings, ``xrlite``, the option resolvers and the numpy planners.
Each side is built from its own package's classes on the same inputs, and
the copies must agree exactly (``assert_array_equal``, ``==``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xcube_resampling_tpu as jx  # noqa: E402
import xcube_resampling_tpu_torch as pt  # noqa: E402
from xcube_resampling_tpu import utils as jx_utils  # noqa: E402
from xcube_resampling_tpu.crs import Transformer as JxTransformer  # noqa: E402
from xcube_resampling_tpu.gridmapping.bboxes import (  # noqa: E402
    compute_ij_bboxes as jx_compute_ij_bboxes,
)
from xcube_resampling_tpu.ops import reproject_ops as jx_rops  # noqa: E402
from xcube_resampling_tpu.ops import srw as jx_srw  # noqa: E402
from xcube_resampling_tpu.spatial import choose_route as jx_choose_route  # noqa: E402
from xcube_resampling_tpu_torch import utils as pt_utils  # noqa: E402
from xcube_resampling_tpu_torch.crs import Transformer as PtTransformer  # noqa: E402
from xcube_resampling_tpu_torch.gridmapping.bboxes import (  # noqa: E402
    compute_ij_bboxes as pt_compute_ij_bboxes,
)
from xcube_resampling_tpu_torch.ops import reproject_ops as pt_rops  # noqa: E402
from xcube_resampling_tpu_torch.ops import srw as pt_srw  # noqa: E402
from xcube_resampling_tpu_torch.spatial import choose_route as pt_choose_route  # noqa: E402

# The CRSs of the tests and of chip_smoke.py, with seeded points inside
# each one's domain (x, y ranges)
CRS_POINTS = {
    "epsg:4326": ((-20.0, 40.0), (30.0, 70.0)),
    "epsg:32632": ((300000.0, 900000.0), (5000000.0, 6500000.0)),
    "epsg:3035": ((3500000.0, 5000000.0), (2500000.0, 4000000.0)),
}

# (source, target) grid-mapping arguments of GridMapping.regular
GEOMETRIES = {
    "utm_laea": (
        dict(size=(96, 96), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"),
        dict(size=(80, 80), xy_min=(4320500, 3379500), xy_res=100, crs="epsg:3035"),
    ),
    "geo_utm": (
        dict(size=(800, 600), xy_min=(-10.0, 35.0), xy_res=0.05, crs="epsg:4326"),
        dict(size=(256, 256), xy_min=(250000.0, 5200000.0), xy_res=2400.0, crs="epsg:32632"),
    ),
    "edge": (
        dict(size=(96, 96), xy_min=(500000.0, 5400000.0), xy_res=100.0, crs="epsg:32632"),
        dict(size=(100, 160), xy_min=(4247500.0, 2846000.0), xy_res=100.0, crs="epsg:3035"),
    ),
}


def _both(name):
    src, tgt = GEOMETRIES[name]
    return (
        (jx.GridMapping.regular(**src), jx.GridMapping.regular(**tgt)),
        (pt.GridMapping.regular(**src), pt.GridMapping.regular(**tgt)),
    )


def _dataset(pkg, gm, data):
    coords = dict(gm.to_coords(exclude_bounds=True))
    coords["spatial_ref"] = pkg.DataArray(np.array(0), dims=(), attrs=gm.crs.to_cf())
    x_dim, y_dim = gm.xy_dim_names
    return pkg.Dataset(
        {"v": pkg.DataArray(data, dims=(y_dim, x_dim), attrs=dict(grid_mapping="spatial_ref"))},
        coords=coords,
    )


@pytest.mark.parametrize("src_crs", sorted(CRS_POINTS))
@pytest.mark.parametrize("dst_crs", sorted(CRS_POINTS))
def test_crs_transform_matches(src_crs, dst_crs):
    """Forward and inverse transforms of seeded points, bit for bit."""
    (x0, x1), (y0, y1) = CRS_POINTS[src_crs]
    rng = np.random.default_rng(5)
    x = rng.uniform(x0, x1, 64)
    y = rng.uniform(y0, y1, 64)
    for a, b in ((src_crs, dst_crs), (dst_crs, src_crs)):
        ref = JxTransformer.from_crs(a, b).transform(x, y)
        got = PtTransformer.from_crs(a, b).transform(x, y)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    ref = JxTransformer.from_crs(src_crs, dst_crs).transform_bounds(x0, y0, x1, y1)
    got = PtTransformer.from_crs(src_crs, dst_crs).transform_bounds(x0, y0, x1, y1)
    assert got == ref


@pytest.mark.parametrize("crs", sorted(CRS_POINTS))
def test_crs_model_matches(crs):
    ref, got = jx.CRS.from_user_input(crs), pt.CRS.from_user_input(crs)
    assert str(got) == str(ref)
    assert got.to_cf() == ref.to_cf()
    assert got.is_geographic == ref.is_geographic
    assert got.to_wkt() == ref.to_wkt()


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("j_axis_up", [False, True])
def test_grid_mapping_from_dataset_matches(geometry, j_axis_up):
    src, _ = GEOMETRIES[geometry]
    data = np.random.default_rng(0).random(src["size"][::-1], dtype=np.float32)
    gms = []
    for pkg in (jx, pt):
        gm = pkg.GridMapping.regular(**src, is_j_axis_up=j_axis_up)
        gms.append(pkg.GridMapping.from_dataset(_dataset(pkg, gm, data)))
    ref, got = gms
    for attr in (
        "size", "tile_size", "xy_res", "xy_bbox", "is_j_axis_up", "is_regular",
        "xy_var_names", "xy_dim_names", "is_lon_360", "x_min", "y_max",
    ):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert str(got.crs) == str(ref.crs)
    np.testing.assert_array_equal(got.x_coords.data, ref.x_coords.data)
    np.testing.assert_array_equal(got.y_coords.data, ref.y_coords.data)
    np.testing.assert_array_equal(got.xy_bboxes, ref.xy_bboxes)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_coarse_geometry_and_gates_match(geometry):
    (js, jt), (ps, pt_) = _both(geometry)
    ref = jx_srw._coarse_geometry(js, jt, 16)
    got = pt_srw._coarse_geometry(ps, pt_, 16)
    for name in ("ix64", "iy64", "iystar64"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    for name in ("step", "src_h", "src_w", "out_h", "out_w"):
        assert getattr(got, name) == getattr(ref, name)
    assert pt_srw._fields_interp_err(got) == jx_srw._fields_interp_err(ref)
    assert pt_srw._twopass_slope(got) == jx_srw._twopass_slope(ref)
    w_ref = jx_srw._source_window_gm(js, ref, margin=56)
    w_got = pt_srw._source_window_gm(ps, got, margin=56)
    assert (w_got is None) == (w_ref is None)
    if w_ref is not None:
        assert w_got[1] == w_ref[1]
        assert w_got[0].xy_bbox == w_ref[0].xy_bbox and w_got[0].size == w_ref[0].size


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("tiles", [(None, None), (32, 32)])
def test_plan_srw_matches(geometry, tiles):
    (js, jt), (ps, pt_) = _both(geometry)
    col_tile, row_tile = tiles
    ref = jx_srw.plan_srw(js, jt, col_tile=col_tile, row_tile=row_tile)
    got = pt_srw.plan_srw(ps, pt_, col_tile=col_tile, row_tile=row_tile)
    assert (got is None) == (ref is None)
    if ref is None:
        return
    for name in ("base_v", "base_h", "iystar_c", "ix_c", "iy_c"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    for name in ("d_v", "d_h", "col_tile", "row_tile", "step", "src_h", "src_w",
                 "out_h", "out_w"):
        assert getattr(got, name) == getattr(ref, name), name


def _flagship_both(size):
    import __graft_entry__

    from xcube_resampling_tpu_torch.entry import flagship_gms

    return __graft_entry__._flagship_gms(size, size), flagship_gms(size, size)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES) + ["flagship-512", "flagship-2048"])
@pytest.mark.parametrize("max_taps", [16, 24])
def test_plan_srw_aligned_matches(geometry, max_taps):
    """The copy of ``plan_srw_aligned`` (``srw.py:953-1046``) field by
    field, on the test geometries and the flagship (where JAX's dispatch
    takes the aligned plan), at its default tap limit and the dispatch's."""
    if geometry.startswith("flagship"):
        (js, jt), (ps, pt_) = _flagship_both(int(geometry.split("-")[1]))
    else:
        (js, jt), (ps, pt_) = _both(geometry)
    ref = jx_srw.plan_srw_aligned(js, jt, max_taps=max_taps)
    got = pt_srw.plan_srw_aligned(ps, pt_, max_taps=max_taps)
    assert (got is None) == (ref is None)
    if geometry.startswith("flagship"):
        assert ref is not None
    if ref is None:
        return
    for name in ("iystar_c", "ix_c", "iy_c", "s_v", "base_v", "s_h", "base_h"):
        r, g = getattr(ref, name), getattr(got, name)
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r)
    for name in ("step", "bits_v", "d_v", "bits_h", "d_h", "src_h", "src_w", "out_h", "out_w"):
        assert getattr(got, name) == getattr(ref, name), name


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_coarse_coord_field_matches(geometry):
    (js, jt), (ps, pt_) = _both(geometry)
    ref = jx_rops.coarse_coord_field(js, jt, 16)
    got = pt_rops.coarse_coord_field(ps, pt_, 16)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]


@pytest.mark.parametrize(
    "case", ["reproject", "identity", "affine", "geographic", "warn-identity"]
)
def test_choose_route_matches(case):
    src, tgt = GEOMETRIES["utm_laea"]
    if case == "identity":
        tgt = src
    elif case == "affine":
        tgt = dict(src, xy_res=200.0, size=(48, 48))
    elif case == "geographic":
        src = GEOMETRIES["geo_utm"][0]
        tgt = dict(src, xy_res=0.1, size=(400, 300))
    routes = []
    for pkg, choose in ((jx, jx_choose_route), (pt, pt_choose_route)):
        target = None if case == "warn-identity" else pkg.GridMapping.regular(**tgt)
        routes.append(choose(pkg.GridMapping.regular(**src), target))
    assert routes[1] == routes[0]
    assert routes[0] == {"geographic": "affine"}.get(case, case)


def test_choose_route_irregular_source_is_rectify():
    from .sampledata import create_olci_like_swath

    swath = create_olci_like_swath(width=16, height=16, tile_size=16)
    jx_gm = jx.GridMapping.from_dataset(swath)
    # the same swath through the port's own data model and grid mapping
    coords = {
        name: pt.DataArray(np.asarray(c.data), dims=c.dims, attrs=dict(c.attrs))
        for name, c in swath.coords.items()
    }
    data_vars = {
        name: pt.DataArray(np.asarray(v.data), dims=v.dims, attrs=dict(v.attrs))
        for name, v in swath.data_vars.items()
    }
    pt_gm = pt.GridMapping.from_dataset(pt.Dataset(data_vars, coords=coords))
    assert jx_choose_route(jx_gm, None) == pt_choose_route(pt_gm, None) == "rectify"
    assert pt_gm.size == jx_gm.size and pt_gm.is_regular == jx_gm.is_regular


# torch dtype -> the numpy dtype the JAX resolvers key on
DTYPES = [
    (torch.float32, np.float32),
    (torch.float64, np.float64),
    (torch.float16, np.float16),
    (torch.uint8, np.uint8),
    (torch.uint16, np.uint16),
    (torch.int8, np.int8),
    (torch.int16, np.int16),
    (torch.int32, np.int32),
    (torch.int64, np.int64),
    (torch.bool, np.bool_),
]


@pytest.mark.parametrize("torch_dtype, np_dtype", DTYPES)
def test_option_defaults_match_per_dtype(torch_dtype, np_dtype):
    """The port's resolvers give a torch-backed variable the defaults the
    JAX package gives a numpy variable of the same dtype."""
    pt_var = pt.DataArray(torch.zeros((2, 2), dtype=torch_dtype), dims=("y", "x"))
    jx_var = jx.DataArray(np.zeros((2, 2), dtype=np_dtype), dims=("y", "x"))
    assert pt_var.dtype == torch_dtype
    ref_fill = jx_utils._get_fill_value(None, "v", jx_var)
    got_fill = pt_utils._get_fill_value(None, "v", pt_var)
    assert (np.isnan(got_fill) and np.isnan(ref_fill)) or got_fill == ref_fill
    assert pt_utils._get_interp_method_str(None, "v", pt_var) == (
        jx_utils._get_interp_method_str(None, "v", jx_var)
    )


def test_option_mappings_key_on_name_then_torch_dtype():
    var = pt.DataArray(torch.zeros((2, 2), dtype=torch.uint8), dims=("y", "x"))
    assert pt_utils._get_fill_value({torch.uint8: 7}, "v", var) == 7
    assert pt_utils._get_fill_value({"v": 3, torch.uint8: 7}, "v", var) == 3
    assert pt_utils._get_interp_method_str({torch.uint8: 1}, "v", var) == "bilinear"
    # an unresolvable mapping falls back to the dtype default
    assert pt_utils._get_fill_value({"w": 3}, "v", var) == 255


def test_dataset_helpers_match():
    (js, jt), (ps, pt_) = _both("utm_laea")
    data = np.random.default_rng(1).random((96, 96), dtype=np.float32)
    shells = []
    for pkg, utils, s, t in ((jx, jx_utils, js, jt), (pt, pt_utils, ps, pt_)):
        ds = utils.normalize_grid_mapping(_dataset(pkg, s, data), s)
        ds = utils._select_variables(ds, "v")
        shells.append(utils.assemble_target_shell(
            ds, s, t, dict(zip(t.xy_var_names, (t.x_coords, t.y_coords)))
        ))
    ref, got = shells
    assert sorted(got.coords) == sorted(ref.coords)
    for name in ref.coords:
        np.testing.assert_array_equal(
            np.asarray(got.coords[name].data), np.asarray(ref.coords[name].data)
        )
        assert got.coords[name].attrs == ref.coords[name].attrs


def test_ij_bboxes_numpy_scan_matches():
    """The copy keeps only the numpy scan of compute_ij_bboxes; it equals
    the JAX package's (native or numpy) scan."""
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.random((40, 50)), axis=1)
    y = np.cumsum(rng.random((40, 50)), axis=0)
    boxes = np.array([[2.0, 2.0, 10.0, 9.0], [20.0, 5.0, 30.0, 25.0], [-9.0, -9.0, -5.0, -5.0]])
    for border, ij_border in ((0.0, 0), (0.5, 2)):
        ref = jx_compute_ij_bboxes(x, y, boxes, border, ij_border, np.full((3, 4), -1))
        got = pt_compute_ij_bboxes(x, y, boxes, border, ij_border, np.full((3, 4), -1))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["clean", "nan", "fold", "long_edge"])
def test_phase_a_host_helpers_match(case):
    """The device Phase A's host helpers (``ops/phase_a.py``: the walk's
    gate, the tiled planner's dilation and seed extrapolation, the scan's
    power-of-two ceiling) equal their originals in ``ops/rectify_ops.py``."""
    from xcube_resampling_tpu.ops import rectify_ops as jx_ro
    from xcube_resampling_tpu_torch.ops import phase_a as pt_pa

    rng = np.random.default_rng(11)
    j, i = np.mgrid[0:30, 0:40].astype(np.float64)
    gx = i * 1.1 + 0.2 * j + 0.05 * rng.random(j.shape)
    gy = j * 0.9 - 0.1 * i + 0.05 * rng.random(j.shape)
    if case == "nan":
        gx[7, 9] = np.nan
    elif case == "fold":
        gx[10:20, 15], gx[10:20, 16] = gx[10:20, 16].copy(), gx[10:20, 15].copy()
    elif case == "long_edge":
        gx[:, 25:] += 30.0
    for max_edge in (2.0, 40.0):
        gx32, gy32 = gx.astype(np.float32), gy.astype(np.float32)
        assert pt_pa._walk_gate(gx32, gy32, max_edge) == jx_ro._walk_gate(gx32, gy32, max_edge)
    mask = rng.random((17, 23)) < (0.05 if case == "clean" else 0.3)
    np.testing.assert_array_equal(pt_pa._dilate1(mask), jx_ro._dilate1(mask))
    field = np.stack([gx, gy])[:, :25, :33].copy()
    field[:, rng.random(field.shape[1:]) < 0.1] = np.nan
    field[:, 12:, 20:] = np.nan  # cells farther than 8 from the valid ones
    for iters in (2, 8):
        np.testing.assert_array_equal(pt_pa._fill_nan_extrapolate(field, iters),
                                      jx_ro._fill_nan_extrapolate(field, iters))
    for n in range(0, 40):
        assert pt_pa._ceil_pow2(n, 16) == jx_ro._ceil_pow2(n, 16)


def test_spatial_dims_and_bbox_clip_match():
    """``get_spatial_dims`` and ``clip_dataset_by_bbox`` on each package's
    own dataset: the same dims, sizes and coordinates, for y stored
    descending (j down) and ascending (j up)."""
    src, _ = GEOMETRIES["utm_laea"]
    data = np.random.default_rng(3).random((96, 96), dtype=np.float32)
    bbox = (570000.0, 5935000.0, 572550.0, 5938000.0)
    for j_axis_up in (False, True):
        clipped = []
        for pkg, utils in ((jx, jx_utils), (pt, pt_utils)):
            ds = _dataset(pkg, pkg.GridMapping.regular(**src, is_j_axis_up=j_axis_up), data)
            assert utils.get_spatial_dims(ds) == ("x", "y")
            clipped.append(utils.clip_dataset_by_bbox(ds, bbox))
        ref, got = clipped
        assert got.sizes == ref.sizes and got.sizes["x"] > 0 and got.sizes["y"] > 0
        for name in ("x", "y", "v"):
            np.testing.assert_array_equal(np.asarray(got[name].data), np.asarray(ref[name].data))
    with pytest.raises(KeyError, match="No standard spatial dimensions"):
        pt_utils.get_spatial_dims(pt.Dataset({"v": pt.DataArray(data, dims=("a", "b"))}))


def test_clip_keeps_tensors_as_views():
    src, _ = GEOMETRIES["utm_laea"]
    tensor = torch.rand(96, 96)
    ds = _dataset(pt, pt.GridMapping.regular(**src), tensor)
    out = pt_utils.clip_dataset_by_bbox(ds, (570000.0, 5935000.0, 572550.0, 5938000.0))
    assert out["v"].data.shape[0] < 96 and out["v"].data.shape[1] < 96
    assert out["v"].data.untyped_storage().data_ptr() == tensor.untyped_storage().data_ptr()


@pytest.mark.parametrize("torch_dtype, np_dtype", DTYPES)
@pytest.mark.parametrize(
    "options",
    [
        None,
        0,
        "bilinear",
        "triangular",
        {"v": "nearest"},
        {"w": 1},
        {"v": "triangular", "w": 0},
    ],
)
def test_interp_resolvers_match(torch_dtype, np_dtype, options):
    """``_get_interp_method``, ``_get_interp_method_int`` and
    ``_prep_interp_methods_downscale`` as the JAX package's, per dtype."""
    pt_var = pt.DataArray(torch.zeros((2, 2), dtype=torch_dtype), dims=("y", "x"))
    jx_var = jx.DataArray(np.zeros((2, 2), dtype=np_dtype), dims=("y", "x"))
    assert pt_utils._prep_interp_methods_downscale(options) == (
        jx_utils._prep_interp_methods_downscale(options)
    )
    prepped = pt_utils._prep_interp_methods_downscale(options)
    assert pt_utils._get_interp_method(prepped, "v", pt_var) == (
        jx_utils._get_interp_method(prepped, "v", jx_var)
    )
    if options not in ("triangular",) and not (
        isinstance(options, dict) and "triangular" in options.values()
    ):
        assert pt_utils._get_interp_method_int(options, "v", pt_var) == (
            jx_utils._get_interp_method_int(options, "v", jx_var)
        )


@pytest.mark.parametrize("torch_dtype, np_dtype", DTYPES)
@pytest.mark.parametrize(
    "agg, recover", [(None, None), ("mode", True), ({"v": "max"}, {"v": True}), ({"w": "sum"}, {})]
)
def test_agg_and_recover_resolvers_match(torch_dtype, np_dtype, agg, recover):
    """``_get_agg_method`` returns the name of the reducer the JAX
    package's returns; ``_get_recover_nan`` as the JAX package's."""
    from xcube_resampling_tpu.constants import AGG_METHODS as JX_AGG_METHODS

    pt_var = pt.DataArray(torch.zeros((2, 2), dtype=torch_dtype), dims=("y", "x"))
    jx_var = jx.DataArray(np.zeros((2, 2), dtype=np_dtype), dims=("y", "x"))
    name = pt_utils._get_agg_method(agg, "v", pt_var)
    assert JX_AGG_METHODS[name] is jx_utils._get_agg_method(agg, "v", jx_var)
    assert pt_utils._get_recover_nan(recover, "v", pt_var) == (
        jx_utils._get_recover_nan(recover, "v", jx_var)
    )
    with pytest.raises(KeyError):
        pt_utils._get_agg_method("mean_of_means", "v", pt_var)


def test_scale_split_matches():
    from xcube_resampling_tpu.affine import _scale_split as jx_split
    from xcube_resampling_tpu_torch.affine import _scale_split as pt_split

    for matrix in (((2.0, 0.0, 0.5), (0.0, 2.0, 0.5)), ((-4.05, 0.0, 9.0), (0.0, 3.2, -1.0))):
        assert pt_split(matrix) == jx_split(matrix)


@pytest.mark.parametrize(
    "shape, tile_shape",
    [((13, 13), (5, 5)), ((13, 13), (3, 13)), ((2, 272, 327), (2, 128, 128)), ((7,), (7,))],
)
def test_chunk_copy_matches(shape, tile_shape):
    """The port's chunk module (a copy) cuts the same tiles in the same
    order and assembles the same array from the same block context."""
    from xcube_resampling_tpu import chunk as jx_chunk
    from xcube_resampling_tpu_torch import chunk as pt_chunk

    ref = list(jx_chunk.iter_tiles(shape, tile_shape))
    got = list(pt_chunk.iter_tiles(shape, tile_shape))
    assert [(t.index, t.slices, t.shape, t.bounds) for t in got] == [
        (t.index, t.slices, t.shape, t.bounds) for t in ref
    ]
    assert list(pt_chunk.get_chunk_sizes(shape, tile_shape)) == list(
        jx_chunk.get_chunk_sizes(shape, tile_shape)
    )

    def block(block_id, block_shape, block_slices):
        return np.full(block_shape, block_id + 0.5 * len(block_slices))

    names = ["block_id", "block_shape", "block_slices"]
    np.testing.assert_array_equal(
        pt_chunk.compute_array_from_func(block, shape, tile_shape, np.float64, ctx_arg_names=names),
        jx_chunk.compute_array_from_func(block, shape, tile_shape, np.float64, ctx_arg_names=names),
    )


@pytest.mark.parametrize("swath", [(233, 307, 128), (300, 420, 64), (400, 500, 128)])
@pytest.mark.parametrize("gated", [False, True])
def test_fields_from_ij_map_matches(swath, gated):
    """fields_from_ij_map (a copy) on the JAX host tier's Phase A map of
    OLCI-like swaths: the same coarse fields bit for bit, or None for both
    (the third swath's fields miss the map by more than 0.05 px)."""
    from scipy.ndimage import binary_erosion

    from xcube_resampling_tpu import rectify as jx_rectify
    from xcube_resampling_tpu.constants import UV_DELTA

    from .sampledata import create_olci_like_swath

    width, height, tile = swath
    gm = jx.GridMapping.from_dataset(create_olci_like_swath(width, height, tile_size=tile))
    ij_map = jx_rectify._inverse_ij_map(gm, gm.to_regular(tile_size=tile), UV_DELTA)
    valid = ~np.isnan(ij_map[0]) & ~np.isnan(ij_map[1])
    gate = binary_erosion(valid, iterations=18) if gated else None
    ref = jx_srw.fields_from_ij_map(ij_map, height, width, step=16, gate_mask=gate)
    got = pt_srw.fields_from_ij_map(ij_map, height, width, step=16, gate_mask=gate)
    assert (got is None) == (ref is None)
    if ref is not None:
        for name in ("ix64", "iy64", "iystar64"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
        for name in ("step", "src_h", "src_w", "out_h", "out_w"):
            assert getattr(got, name) == getattr(ref, name)


@pytest.mark.parametrize("swath", [(233, 307, 128), (300, 420, 64), (400, 500, 128)])
@pytest.mark.parametrize("nan_rows", [False, True])
def test_fields_from_lattice_matches(swath, nan_rows):
    """fields_from_lattice (a copy) on the step lattice and half-offset
    probes of the JAX host tier's Phase A map, as the resident Phase B
    samples them: the same coarse fields bit for bit, or None for both;
    with NaN map rows (the lattice's row fill) and without."""
    from xcube_resampling_tpu import rectify as jx_rectify
    from xcube_resampling_tpu.constants import UV_DELTA

    from .sampledata import create_olci_like_swath

    width, height, tile = swath
    gm = jx.GridMapping.from_dataset(create_olci_like_swath(width, height, tile_size=tile))
    ij_map = jx_rectify._inverse_ij_map(gm, gm.to_regular(tile_size=tile), UV_DELTA)
    if nan_rows:
        ij_map[:, 40:60] = np.nan
    step = 16
    out_h, out_w = ij_map.shape[1:]
    rsel = np.minimum(np.arange((out_h - 1) // step + 2) * step, out_h - 1)
    csel = np.minimum(np.arange((out_w - 1) // step + 2) * step, out_w - 1)
    prow = np.minimum(rsel + step // 2, out_h - 1)
    pcol = np.minimum(csel + step // 2, out_w - 1)
    lat = ij_map[:, rsel[:, None], csel[None, :]]
    prb = ij_map[:, prow[:, None], pcol[None, :]]
    valid = np.isfinite(prb[0]) & np.isfinite(prb[1])
    args = (lat[0], lat[1], prb[0], prb[1], valid, (prow, pcol), step, height, width, out_h,
            out_w)
    ref = jx_srw.fields_from_lattice(*args)
    got = pt_srw.fields_from_lattice(*args)
    assert (got is None) == (ref is None)
    if ref is not None:
        for name in ("ix64", "iy64", "iystar64"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
        for name in ("step", "src_h", "src_w", "out_h", "out_w"):
            assert getattr(got, name) == getattr(ref, name)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_reproject_host_planners_match(geometry):
    """The host path's planners (copies): per-tile windows, origin stacks,
    padding and the float64 target centres in the source CRS, bit for bit."""
    from xcube_resampling_tpu import reproject as jx_reproject
    from xcube_resampling_tpu_torch import reproject as pt_reproject

    (js, jt), (ps, pt_) = _both(geometry)
    ref = jx_reproject._plan_source_windows(
        JxTransformer.from_crs(jt.crs, js.crs, always_xy=True), js, jt
    )
    inv = PtTransformer.from_crs(pt_.crs, ps.crs, always_xy=True)
    got = pt_reproject._plan_source_windows(inv, ps, pt_)
    for name in ("bboxes", "x_stack", "y_stack"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert got.pad_width == ref.pad_width
    ref_c = jx_reproject._target_centers_in_source(
        JxTransformer.from_crs(jt.crs, js.crs, always_xy=True), jt
    )
    got_c = pt_reproject._target_centers_in_source(inv, pt_)
    for g, r in zip(got_c, ref_c):
        np.testing.assert_array_equal(g, r)


def _zarr_case(pkg):
    """A dataset of three dtypes, chunked, with CF coordinates."""
    gm = pkg.GridMapping.regular(
        size=(40, 30), xy_min=(565000.0, 5930000.0), xy_res=100.0, crs="epsg:32632"
    )
    rng = np.random.default_rng(11)
    coords = dict(gm.to_coords(exclude_bounds=True))
    coords["spatial_ref"] = pkg.DataArray(np.array(0), dims=(), attrs=gm.crs.to_cf())
    variables = {
        "f": rng.random((30, 40)).astype(np.float32),
        "i": rng.integers(-5000, 5000, (2, 30, 40)).astype(np.int16),
        "d": rng.random((30, 40)),
    }
    return pkg.Dataset(
        {
            name: pkg.DataArray(
                data, dims=("t", "y", "x")[3 - data.ndim:], chunks=(1, 16, 16)[3 - data.ndim:],
                attrs=dict(grid_mapping="spatial_ref", units="1"),
            )
            for name, data in variables.items()
        },
        coords=coords,
    )


@pytest.mark.parametrize("compressor", [None, "zlib"])
def test_zarrlite_copy_writes_and_reads_the_same_store(compressor, tmp_path):
    """The port's zarrlite (a copy) writes a store byte for byte equal to
    the original's, in memory and on disk, for each compressor, and both
    read it back alike, eagerly and chunk-lazily (a window reads the same
    chunks)."""
    from xcube_resampling_tpu import zarrlite as jz
    from xcube_resampling_tpu_torch import zarrlite as pz

    ref, got = jz.MemoryStore(), pz.MemoryStore()
    jz.write_dataset(_zarr_case(jx), ref, compressor=compressor)
    pz.write_dataset(_zarr_case(pt), got, compressor=compressor)
    assert sorted(got) == sorted(ref)
    assert all(got[k] == ref[k] for k in ref)
    jz.write_dataset(_zarr_case(jx), str(tmp_path / "jax.zarr"), compressor=compressor)
    pz.write_dataset(_zarr_case(pt), str(tmp_path / "port.zarr"), compressor=compressor)
    ref_disk = jz.DirectoryStore(tmp_path / "jax.zarr")
    disk = pz.DirectoryStore(tmp_path / "port.zarr")
    assert sorted(disk) == sorted(ref_disk)
    assert all(disk[k] == ref_disk[k] for k in ref_disk)
    for lazy in (False, True):
        a, b = pz.open_dataset(got, lazy=lazy), jz.open_dataset(ref, lazy=lazy)
        for name in ("f", "i", "d"):
            np.testing.assert_array_equal(np.asarray(a[name].data), np.asarray(b[name].data))
    la, lb = pz.open_dataset(got, lazy=True)["i"].data, jz.open_dataset(ref, lazy=True)["i"].data
    assert isinstance(la, pz.LazyArray)
    np.testing.assert_array_equal(la[1, 5:21, 7:30], lb[1, 5:21, 7:30])


def test_zarrlite_codecs_copy_decodes_the_same():
    """The copied codecs decode the frames of tests/test_zarrlite_codecs.py
    (blosc around zlib, zstd and lz4, shuffled, split, multi-block, a
    memcpy frame; raw lz4 blocks) to the original's bytes."""
    from tests.test_zarrlite_codecs import (
        _LZ4,
        _ZLIB,
        _ZSTD,
        _payload,
        lz4_block_compress,
        make_blosc_frame,
    )
    from xcube_resampling_tpu.zarrlite import codecs as jc
    from xcube_resampling_tpu_torch.zarrlite import codecs as pc

    data = _payload()
    frames = [make_blosc_frame(_payload(100), 0, memcpy=True)]
    for codec in (_ZLIB, _ZSTD, _LZ4):
        for shuffle in (False, True):
            frames.append(make_blosc_frame(data, codec, typesize=4, shuffle=shuffle))
    for codec in (_ZLIB, _LZ4):
        frames.append(make_blosc_frame(_payload(5000), codec, typesize=4, blocksize=8192,
                                       shuffle=True))
        frames.append(make_blosc_frame(data, codec, typesize=4, shuffle=True, split=True))
    for frame in frames:
        assert pc.blosc_decompress(frame) == jc.blosc_decompress(frame)
    block = lz4_block_compress(data)
    assert pc.lz4_block_decompress(block, len(data)) == jc.lz4_block_decompress(block, len(data))


def test_zarrlite_add_spatial_ref_copies_match():
    """``zarrlite.add_spatial_ref`` and ``cfconv.add_spatial_ref`` (copies)
    patch a store as the originals do."""
    from xcube_resampling_tpu import zarrlite as jz
    from xcube_resampling_tpu.gridmapping import cfconv as jcf
    from xcube_resampling_tpu_torch import zarrlite as pz
    from xcube_resampling_tpu_torch.gridmapping import cfconv as pcf

    for jfn, pfn in ((jz.add_spatial_ref, pz.add_spatial_ref),
                     (jcf.add_spatial_ref, pcf.add_spatial_ref)):
        ref, got = jz.MemoryStore(), pz.MemoryStore()
        jz.write_dataset(_zarr_case(jx), ref)
        pz.write_dataset(_zarr_case(pt), got)
        jfn(ref, jx.CRS.from_string("epsg:3035"), crs_var_name="crs")
        pfn(got, pt.CRS.from_string("epsg:3035"), crs_var_name="crs")
        assert sorted(got) == sorted(ref)
        assert all(got[k] == ref[k] for k in ref)
