"""The port's approximate octree against the JAX package's, on the
icosphere of tests/test_octree.py (subdivisions 2, radius 0.35, box
margin 0.14), and against the compiled reference's goldens.

* A JAX-built structure (no_continuity, max depth 5, start depth 2)
  through ``from_jax_state``: the walk (both layouts), the grid route and
  the fused-row route answer as JAX's do, in and out of the box, within
  1e-6 in distance and 1e-5 in gradient (fp32 sums in another order);
  ``build_query_grid`` gives the same grid and fused rows, flags
  (bits 16-21) included, word for word.
* The port's own uniform, no_continuity and trilinear builds have JAX's
  leaves per depth, length, node words and ``value_range``; each leaf's
  coefficients agree within 1e-4 of the row's scale but for the few
  leaves whose samples sit on an exact nearest-triangle tie (the
  icosphere's symmetry points, where the two packages' last-ulp
  differences pick mirror triangles with mirror gradients), at most 1%
  of them; ``min_border_value`` within 2e-6 (a sum of 64 coefficients).
* The ``.npz`` container both ways, the reference ``.bin`` goldens
  through the port's ``io`` at the JAX tests' tolerances
  (test_reference_parity.py:147-157, 206-226), ``.bin`` both ways, the
  four exact-octree strategies as the builders' cull (the same words as
  the "distance" build) and the builder options beside JAX's builds
  (simpson, by_distance, error decay, continuity with simpson and with
  trilinear, start depths 1 and 3).
* On a flat open sheet (``make_plane(size=1.0, res=4)``, margin 0.14,
  max depth 4, start depth 1), both builders: the port's interior rms
  against the true distance z no worse than JAX's build (samples on the
  sheet tie between triangles at distance 0, and an edge or vertex
  winner takes the face normal as its gradient), the JAX-built
  structure still answering as JAX does, ``RealSdf`` as JAX's.
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdflib_tpu.sdf.octree as jo
from sdflib_tpu.io.sdflib_binary import load_sdflib_bin as j_load_bin
from sdflib_tpu.io.sdflib_binary import save_sdflib_bin as j_save_bin
from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
from sdflib_tpu.sdf.sdf_function import SdfFunction as JSdfFunction
from sdflib_tpu.sdf.real import RealSdf as JRealSdf
from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere
from sdflib_tpu.utils.primitives import make_plane as j_plane
from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf, SdfFunction
from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin, save_sdflib_bin
from sdflib_tpu_torch.sdf import octree as po
from sdflib_tpu_torch.sdf.octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK
from sdflib_tpu_torch.utils.primitives import make_icosphere, make_plane, make_torus

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "golden", "data")
CFG = dict(max_depth=5, start_depth=2, termination_threshold=1e-3,
           init_algorithm="no_continuity")
D_TOL = dict(rtol=0, atol=1e-6)
G_TOL = dict(rtol=0, atol=1e-5)


def _mesh_box(make):
    mesh = make(subdivisions=2, radius=0.35)
    return mesh, mesh.bounding_box.add_margin(0.14)


@pytest.fixture(scope="module")
def jax_sdf():
    return JOctree(*_mesh_box(j_icosphere), **CFG)


@pytest.fixture(scope="module")
def port_sdf():
    return OctreeSdf(*_mesh_box(make_icosphere), **CFG, device="cpu")


@pytest.fixture(scope="module")
def pts():
    """Points in the box, on cell faces and outside it."""
    rng = np.random.default_rng(7)
    inside = rng.uniform(-0.48, 0.48, (3000, 3))
    faces = np.round(rng.uniform(-0.48, 0.48, (200, 3)) / 0.06125) * 0.06125
    outside = rng.uniform(-2.0, 2.0, (300, 3))
    return np.concatenate([inside, faces, outside]).astype(np.float32)


def _np(x):
    return np.asarray(x)


def _jax_route(sdf, route, pts):
    box = (jnp.asarray(sdf.box.min), jnp.float32(sdf.box.size[0]))
    kw = dict(num_coeff=sdf.num_coefficients, interpolation=sdf.interpolation,
              with_gradient=True)
    p = jnp.asarray(pts)
    if route.startswith("walk"):
        return jo._octree_query(sdf.octree_data, p, *box, sdf.start_grid_size,
                                jnp.float32(sdf.min_border_value),
                                levels=sdf.max_depth - sdf.start_depth,
                                fast=route == "walk", **kw)
    if route == "grid":
        return jo._octree_query_grid(sdf.octree_data, sdf._query_grid, p, *box,
                                     jnp.float32(sdf.min_border_value),
                                     grid_depth=sdf.max_depth, **kw)
    return jo._octree_query_fat(sdf._fat_grid, p, *box, jnp.float32(sdf.min_border_value),
                                grid_depth=sdf.max_depth, **kw)


def _port_route(sdf, route, pts):
    box = (sdf._box_min, sdf._box_size3)
    kw = dict(num_coeff=sdf.num_coefficients, interpolation=sdf.interpolation,
              with_gradient=True)
    p = torch.as_tensor(pts)
    if route.startswith("walk"):
        return po._octree_query(sdf._octree_dev, p, *box, sdf.start_grid_size,
                                sdf.min_border_value, levels=sdf.max_depth - sdf.start_depth,
                                fast=route == "walk", **kw)
    if route == "grid":
        return po._octree_query_grid(sdf._octree_dev, sdf._query_grid, p, *box,
                                     sdf.min_border_value, grid_depth=sdf.max_depth, **kw)
    return po._octree_query_fat(sdf._fat_grid, p, *box, sdf.min_border_value,
                                grid_depth=sdf.max_depth, **kw)


@pytest.fixture(scope="module")
def gridded(jax_sdf):
    """The JAX structure with its query grid, in both packages."""
    j = copy.copy(jax_sdf)
    j.build_query_grid()
    p = OctreeSdf.from_jax_state(jax_sdf._state_arrays(), device="cpu")
    p.build_query_grid()
    return j, p


@pytest.mark.parametrize("route", ["walk", "walk_any_layout", "grid", "fat"])
def test_routes_match_jax_on_jax_structure(gridded, pts, route):
    """Each query route of the port on the JAX-built structure answers as
    the JAX function does, the out-of-box fallback included."""
    j, p = gridded
    assert p._fast_layout and p.start_depth == j.start_depth
    d_j, g_j = (_np(a) for a in _jax_route(j, route, pts))
    d_p, g_p = (a.numpy() for a in _port_route(p, route, pts))
    np.testing.assert_allclose(d_p, d_j, **D_TOL)
    np.testing.assert_allclose(g_p, g_j, **G_TOL)
    out = np.any((pts < p.box.min) | (pts >= p.box.max), axis=1)
    assert out.sum() > 100
    np.testing.assert_allclose(d_p[out], p.box.distance(pts[out]) + p.min_border_value,
                               rtol=1e-5, atol=1e-6)


def test_query_grid_and_flags_match_jax(gridded, pts):
    """build_query_grid: the same leaf grid, free flags (bit 16) and free
    radii (bits 17-21), and the same fused rows, word for word; the public
    queries then take the grid route, as in JAX."""
    j, p = gridded
    np.testing.assert_array_equal(p._query_grid.numpy().view(np.uint32), _np(j._query_grid))
    np.testing.assert_array_equal(p._fat_grid.numpy().view(np.uint32), _np(j._fat_grid))
    flags = _np(j._query_grid)[:, 1] >> 16
    assert (flags & 1).any() and (flags >> 1).any()
    d, g = p.get_distance_and_gradient(pts)
    d_j, g_j = j.get_distance_and_gradient(pts)
    np.testing.assert_allclose(d.numpy(), _np(d_j), **D_TOL)
    np.testing.assert_allclose(g.numpy(), _np(g_j), **G_TOL)
    np.testing.assert_allclose(p.get_depth_density(), j.get_depth_density(), rtol=1e-6)


def _node_slots(data, s):
    """The slots of every node word, and each leaf's coefficient start."""
    slots, frontier = [np.arange(s**3)], np.arange(s**3)
    while frontier.size:
        words = data[frontier]
        inner = (words & IS_LEAF_MASK) == 0
        frontier = ((words[inner] & CHILDREN_INDEX_MASK).astype(np.int64)[:, None]
                    + np.arange(8)).reshape(-1)
        slots.append(frontier)
    slots = np.concatenate(slots)
    words = data[slots]
    leaf = (words & IS_LEAF_MASK) != 0
    return slots, (words[leaf] & CHILDREN_INDEX_MASK).astype(np.int64)


@pytest.mark.parametrize("variant", ["uniform", "no_continuity", "trilinear"])
def test_port_build_matches_jax_build(variant, jax_sdf, port_sdf, pts):
    """The port's own build against the JAX build of the same options."""
    kw = {
        "uniform": dict(max_depth=3, start_depth=1, init_algorithm="uniform"),
        "no_continuity": CFG,
        "trilinear": dict(max_depth=4, start_depth=2, interpolation="trilinear"),
    }[variant]
    if variant == "no_continuity":
        j, p = jax_sdf, port_sdf
    else:
        j = JOctree(*_mesh_box(j_icosphere), **kw)
        p = OctreeSdf(*_mesh_box(make_icosphere), **kw, device="cpu")
    assert p.build_stats["leaves_per_depth"] == j.build_stats["leaves_per_depth"]
    assert p.build_stats["nodes_per_depth"] == j.build_stats["nodes_per_depth"]
    jd = _np(j.octree_data)
    assert p.octree_data.shape == jd.shape and p.octree_data.dtype == np.uint32
    assert p.value_range == pytest.approx(j.value_range, rel=1e-6)
    assert abs(p.min_border_value - j.min_border_value) <= 2e-6
    np.testing.assert_array_equal(p._leaf_depths, j._leaf_depths)

    slots, starts = _node_slots(jd, j.start_grid_size)
    np.testing.assert_array_equal(p.octree_data[slots], jd[slots])
    rows = starts[:, None] + np.arange(j.num_coefficients)
    cj = jd.view(np.float32)[rows]
    cp = p.octree_data.view(np.float32)[rows]
    scale = np.maximum(1.0, np.abs(cj).max(axis=1))
    off = np.abs(cp - cj).max(axis=1) / scale > 1e-4
    assert off.mean() <= 0.01, f"{off.sum()} of {len(off)} leaves differ"

    d_j, d_p = _np(j.get_distance(pts)), p.get_distance(pts).numpy()
    close = np.abs(d_p - d_j) <= 1e-5
    assert close.mean() >= 0.995
    assert np.abs(d_p - d_j).max() <= 1e-3


# The builder options that the rest of the file does not cover, each on
# the icosphere beside the JAX build of the same options.
OPTION_CASES = {
    "simpson": dict(termination_rule="simpson"),
    "by_distance": dict(termination_rule="by_distance"),
    "error_decay_0.5": dict(termination_rule="by_distance", error_decay=0.5),
    "continuity_simpson": dict(init_algorithm="continuity", termination_rule="simpson"),
    "continuity_trilinear": dict(init_algorithm="continuity", interpolation="trilinear"),
    "start_depth_1": dict(start_depth=1, termination_threshold=1e-2),
    "start_depth_3": dict(start_depth=3),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_builder_options_match_jax(case):
    """Each option against JAX's build: the same leaves per depth and
    length, ``min_border_value`` within 2e-6, and distances on 4,000
    points (seed 7) within 2e-6 + 1e-5 |d| (fp32 sums of 64 terms in
    another order)."""
    kw = {**CFG, **OPTION_CASES[case]}
    j = JOctree(*_mesh_box(j_icosphere), **kw)
    p = OctreeSdf(*_mesh_box(make_icosphere), **kw, device="cpu")
    assert p.build_stats["leaves_per_depth"] == {
        int(k): int(v) for k, v in j.build_stats["leaves_per_depth"].items()}
    assert p.octree_data.shape == _np(j.octree_data).shape
    assert abs(p.min_border_value - j.min_border_value) <= 2e-6
    q = np.random.default_rng(7).uniform(-0.48, 0.48, (4000, 3)).astype(np.float32)
    np.testing.assert_allclose(p.get_distance(q).numpy(), _np(j.get_distance(q)),
                               rtol=1e-5, atol=2e-6)


def test_containers_both_ways(jax_sdf, port_sdf, pts, tmp_path):
    """The .npz container: JAX -> port and port -> JAX answer as the
    writer does, and the port reads its own back bit for bit."""
    path = str(tmp_path / "jax.npz")
    jax_sdf.save(path)
    loaded = SdfFunction.load(path, device="cpu")
    assert isinstance(loaded, OctreeSdf) and loaded.max_depth == jax_sdf.max_depth
    np.testing.assert_allclose(loaded.get_distance(pts).numpy(),
                               _np(jax_sdf.get_distance(pts)), **D_TOL)

    path = str(tmp_path / "port.npz")
    port_sdf.save(path)
    j = JSdfFunction.load(path)
    assert isinstance(j, JOctree)
    np.testing.assert_array_equal(_np(j.octree_data), port_sdf.octree_data)
    assert j.min_border_value == pytest.approx(port_sdf.min_border_value)
    np.testing.assert_allclose(_np(j.get_distance(jnp.asarray(pts))),
                               port_sdf.get_distance(pts).numpy(), **D_TOL)
    again = SdfFunction.load(path, device="cpu")
    np.testing.assert_array_equal(again.get_distance(pts).numpy(),
                                  port_sdf.get_distance(pts).numpy())
    assert again.termination_threshold == pytest.approx(port_sdf.termination_threshold, rel=1e-6)


def _check_golden(sdf, points, dist, grad):
    """The JAX tests' tolerances against the compiled reference."""
    d = sdf.get_distance(points).numpy()
    np.testing.assert_allclose(d, dist, atol=5e-5)
    d2, g = sdf.get_distance_and_gradient(points)
    np.testing.assert_allclose(d2.numpy(), dist, atol=5e-5)
    err = np.linalg.norm(g.numpy() - grad, axis=-1)
    assert (err > 1e-3).mean() < 1e-3


@pytest.mark.parametrize("golden", ["octree_walk", "octree_nc", "octree_cont"])
def test_bin_goldens_match_cpp(golden):
    """Reference .bin structures through the port's io match the compiled
    reference's walk; the reference builders' arrays take the walk's
    layout-agnostic form."""
    if golden == "octree_walk":
        g = np.load(os.path.join(DATA, "octree_walk.npz"))
        sdf = load_sdflib_bin(os.path.join(DATA, "octree_torus.bin"), device="cpu")
        _check_golden(sdf, g["points"], g["dist"], g["grad"])
        return
    g = np.load(os.path.join(DATA, "builders_torus.npz"))
    sdf = load_sdflib_bin(os.path.join(DATA, f"builders_{golden}.bin"), device="cpu")
    assert not sdf._fast_layout
    _check_golden(sdf, g["points"], g[f"{golden}_dist"], g[f"{golden}_grad"])
    with pytest.raises(ValueError, match="aligned"):
        sdf.build_query_grid()


def test_cpp_written_bin_loads_identically():
    """The .bin the C++ generator wrote parses to the same structure and
    distances as the Python-written one, in the port as in JAX."""
    a = load_sdflib_bin(os.path.join(DATA, "octree_torus.bin"), device="cpu")
    b = load_sdflib_bin(os.path.join(DATA, "octree_torus_cpp.bin"), device="cpu")
    np.testing.assert_array_equal(a.octree_data, b.octree_data)
    j = j_load_bin(os.path.join(DATA, "octree_torus_cpp.bin"))
    np.testing.assert_array_equal(b.octree_data, _np(j.octree_data))
    assert (b.min_border_value, b.value_range) == (j.min_border_value, j.value_range)
    pts = np.load(os.path.join(DATA, "octree_walk.npz"))["points"][:4096]
    np.testing.assert_array_equal(a.get_distance(pts).numpy(), b.get_distance(pts).numpy())


def test_bin_both_ways(jax_sdf, port_sdf, pts, tmp_path):
    """save_sdflib_bin: the port's file equals the JAX package's for the
    same structure, byte for byte, and each package reads the other's."""
    from_jax = OctreeSdf.from_jax_state(jax_sdf._state_arrays(), device="cpu")
    save_sdflib_bin(from_jax, str(tmp_path / "port.bin"))
    j_save_bin(jax_sdf, str(tmp_path / "jax.bin"))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    save_sdflib_bin(port_sdf, str(tmp_path / "own.bin"))
    j = j_load_bin(str(tmp_path / "own.bin"))
    np.testing.assert_array_equal(_np(j.octree_data), port_sdf.octree_data)
    back = load_sdflib_bin(str(tmp_path / "own.bin"), device="cpu")
    np.testing.assert_array_equal(back.get_distance(pts).numpy(),
                                  port_sdf.get_distance(pts).numpy())


@pytest.mark.parametrize("what", ["lattice", "basic", "precise", "per_vertex", "grid_bin",
                                  "exact_bin", "save_exact", "save_trilinear"])
def test_unported_strategies_and_formats_raise(what, tmp_path):
    """What the port could not do before: the four strategies now build
    (an unknown one raises), the GRID and EXACT_OCTREE readers reach a
    header-only file's truncation, an exact octree's .bin round trip
    keeps its lists; a trilinear octree still has no .bin."""
    mesh, box = _mesh_box(make_icosphere)
    if what in ("lattice", "basic", "precise", "per_vertex"):
        kw = dict(max_depth=3, start_depth=2, termination_threshold=1e-3)
        built = OctreeSdf(mesh, box, **kw, strategy=what, device="cpu")
        ref = OctreeSdf(mesh, box, **kw, device="cpu")
        np.testing.assert_array_equal(built.octree_data, ref.octree_data)
        with pytest.raises(ValueError, match="strategy"):
            OctreeSdf(mesh, box, **kw, strategy=what + "_x", device="cpu")
        return
    path = str(tmp_path / "x.bin")
    if what.endswith("_bin"):
        with open(path, "wb") as f:
            f.write(b"\x01" + np.int32(0 if what == "grid_bin" else 2).tobytes())
        # both formats are ported: a header-only file reaches the reader
        with pytest.raises(ValueError, match="Truncated"):
            load_sdflib_bin(path, device="cpu")
    elif what == "save_exact":
        torus = make_torus(R=0.3, r=0.12, nu=12, nv=6)
        ex = ExactOctreeSdf(torus, torus.bounding_box.add_margin(0.1), max_depth=2,
                            start_depth=1, device="cpu")
        save_sdflib_bin(ex, path)
        back = load_sdflib_bin(path, device="cpu")
        assert isinstance(back, ExactOctreeSdf) and back.num_leaves == ex.num_leaves
    else:
        tri = OctreeSdf(mesh, box, max_depth=3, start_depth=2, interpolation="trilinear",
                        device="cpu")
        with pytest.raises(ValueError, match="tricubic"):
            save_sdflib_bin(tri, path)


@pytest.mark.parametrize("alg", ["no_continuity", "continuity"])
def test_plane_ties_at_zero_distance(alg):
    """The flat sheet: 40,000 interior points (seed 5, |x|, |y| <= 0.45,
    |z| <= 0.14), where the distance is z. The port's build is no worse
    than JAX's in rms; JAX's structure through ``from_jax_state`` answers
    within 1e-6 of JAX; ``RealSdf`` within 1e-6 of JAX's. Both builds'
    words and rms are printed (``pytest -s``)."""
    kw = dict(max_depth=4, start_depth=1, termination_threshold=1e-3, init_algorithm=alg)
    jm, pm = j_plane(size=1.0, res=4), make_plane(size=1.0, res=4)
    j = JOctree(jm, jm.bounding_box.add_margin(0.14), **kw)
    p = OctreeSdf(pm, pm.bounding_box.add_margin(0.14), **kw, device="cpu")
    q = np.random.default_rng(5).uniform([-0.45, -0.45, -0.14], [0.45, 0.45, 0.14],
                                         (40_000, 3)).astype(np.float32)
    d_j = _np(j.get_distance(jnp.asarray(q)))
    d_p = p.get_distance(q).numpy()
    rms_j = float(np.sqrt(np.mean((d_j - q[:, 2]) ** 2)))
    rms_p = float(np.sqrt(np.mean((d_p - q[:, 2]) ** 2)))
    told = (f"{alg}: words port {p.octree_data.shape[0]}, JAX {j.octree_data.shape[0]}; "
            f"interior rms port {rms_p:.6e}, JAX {rms_j:.6e}; max port "
            f"{np.abs(d_p - q[:, 2]).max():.6e}, JAX {np.abs(d_j - q[:, 2]).max():.6e}")
    print(told)
    assert rms_p <= rms_j, told
    d_l = OctreeSdf.from_jax_state(j._state_arrays(), device="cpu").get_distance(q).numpy()
    d_r = RealSdf(pm, device="cpu").get_distance(q).numpy()
    d_jr = _np(JRealSdf(jm).get_distance(jnp.asarray(q)))
    print(f"{alg}: max |port - JAX| of JAX's structure in the port {np.abs(d_l - d_j).max():.3e}, "
          f"of RealSdf {np.abs(d_r - d_jr).max():.3e}")
    np.testing.assert_allclose(d_l, d_j, **D_TOL)
    np.testing.assert_allclose(d_r, d_jr, **D_TOL)
