"""The port's exact octree against the JAX package's, on the torus fixture
of test_pallas_scan.py (nu=20, nv=12, max_depth 4, start_depth 1, 16
triangles per node).

Distances and gradients agree within rtol 1e-5 / atol 1e-6 (fp32
rounding order), under the scan each query chooses and under each scan
pinned; the port chooses its scan by the JAX package's rule; the port's
own build is exact against the JAX RealSdf within 1e-5 and matches the
JAX build's leaf count and mean list length within 2%. The entry points,
the approximate octree's among them, default to the card and raise
without one.
"""
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdflib_tpu.sdf.exact_octree as jeo
from sdflib_tpu.io.sdflib_binary import load_sdflib_bin as j_load_bin
from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf as JExact
from sdflib_tpu.sdf.real import RealSdf as JReal
from sdflib_tpu.sdf.sdf_function import SdfFunction as JSdfFunction
from sdflib_tpu.utils.primitives import make_torus as j_torus
from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf, SdfFunction
from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin
from sdflib_tpu_torch.utils.primitives import make_torus

torch.set_num_threads(1)
CFG = dict(max_depth=4, start_depth=1, min_triangles_per_node=16)
TOL = dict(rtol=1e-5, atol=1e-6)


def _mesh_box(make):
    mesh = make(R=0.3, r=0.12, nu=20, nv=12)
    return mesh, mesh.bounding_box.add_margin(0.1)


@pytest.fixture(scope="module")
def jax_sdf():
    return JExact(*_mesh_box(j_torus), **CFG)


@pytest.fixture(scope="module")
def port_sdf():
    return ExactOctreeSdf(*_mesh_box(make_torus), **CFG, device="cpu")


@pytest.fixture(scope="module")
def pts():
    return np.random.default_rng(1).uniform(-0.5, 0.5, (768, 3)).astype(np.float32)


def _np(x):
    return np.asarray(x)


def test_jax_container_gives_jax_results(jax_sdf, pts, tmp_path):
    """(a) The JAX-built structure, through from_jax_state and through
    the .npz container, answers as the JAX package does."""
    path = str(tmp_path / "jax_exact.npz")
    jax_sdf.save(path)
    d_j = _np(jax_sdf.get_distance(pts))
    dg_j, g_j = (_np(a) for a in jax_sdf.get_distance_and_gradient(pts))
    for sdf in (
        ExactOctreeSdf.from_jax_state(jax_sdf._state_arrays(), device="cpu"),
        SdfFunction.load(path, device="cpu"),
    ):
        assert isinstance(sdf, ExactOctreeSdf)
        assert sdf.num_leaves == int(jax_sdf.leaf_count.shape[0])
        np.testing.assert_allclose(sdf.get_distance(pts).numpy(), d_j, **TOL)
        d, g = sdf.get_distance_and_gradient(pts)
        np.testing.assert_allclose(d.numpy(), dg_j, **TOL)
        np.testing.assert_allclose(g.numpy(), g_j, **TOL)


def test_port_build_is_exact_and_matches_jax_structure(port_sdf, jax_sdf, pts):
    """(b) The port's own build: exact against the JAX RealSdf, and the
    same structure size as the JAX build."""
    mesh, box = _mesh_box(j_torus)
    inside = np.random.default_rng(2).uniform(box.min, box.max, (2000, 3)).astype(np.float32)
    q = np.concatenate([pts, inside])
    ref = _np(JReal(mesh).get_distance(q))
    assert np.abs(port_sdf.get_distance(q).numpy() - ref).max() <= 1e-5
    jc = _np(jax_sdf.leaf_count)
    assert abs(port_sdf.num_leaves - len(jc)) <= 0.02 * len(jc)
    assert abs(port_sdf.leaf_count.mean() - jc.mean()) <= 0.02 * jc.mean()
    assert port_sdf.build_stats["nodes_per_depth"] == jax_sdf.build_stats["nodes_per_depth"]
    # leaf lists are sorted by distance to the leaf centre
    tf = port_sdf.tri_flat.numpy()
    for l in range(0, port_sdf.num_leaves, 97):
        off, n = port_sdf.leaf_offset[l], port_sdf.leaf_count[l]
        assert (tf[off : off + n] >= 0).all() and (tf[off + n : off + 64 * -(-n // 64)] == -1).all()


def test_out_of_box_fallback(port_sdf, jax_sdf):
    """(c) Outside the cubified box: box distance + sqrt(3) * box size,
    for distances and gradients, as in the JAX package."""
    rng = np.random.default_rng(3)
    far = rng.uniform(-1.5, 1.5, (400, 3)).astype(np.float32)
    box = port_sdf.box
    outside = np.any((far < box.min) | (far >= box.max), axis=1)
    far = far[outside]
    expect = box.distance(far) + np.sqrt(np.float32(3.0)) * box.size[0]
    d = port_sdf.get_distance(far).numpy()
    np.testing.assert_allclose(d, expect, **TOL)
    np.testing.assert_allclose(d, _np(jax_sdf.get_distance(far)), **TOL)
    d_g, g = port_sdf.get_distance_and_gradient(far)
    d_gj, g_j = jax_sdf.get_distance_and_gradient(far)
    np.testing.assert_allclose(d_g.numpy(), _np(d_gj), **TOL)
    np.testing.assert_allclose(g.numpy(), _np(g_j), **TOL)


def test_port_container_loads_into_jax(port_sdf, pts, tmp_path):
    """(d) A container saved by the port loads into the JAX package and
    answers as the port does."""
    path = str(tmp_path / "port_exact.npz")
    port_sdf.save(path)
    j = JSdfFunction.load(path)
    assert isinstance(j, JExact)
    np.testing.assert_allclose(
        _np(j.get_distance(jnp.asarray(pts))), port_sdf.get_distance(pts).numpy(), **TOL
    )
    again = SdfFunction.load(path, device="cpu")
    np.testing.assert_array_equal(
        again.get_distance(pts).numpy(), port_sdf.get_distance(pts).numpy()
    )


def test_node_walk_matches_grid_descent(port_sdf, pts):
    """The node walk (used past depth 7) lands every point in a leaf whose
    list answers exactly as the dense grid's."""
    walk = ExactOctreeSdf.from_jax_state(port_sdf._state_arrays(), device="cpu")
    walk._leaf_grid = None
    walk._octree_dev = torch.as_tensor(walk.octree_data.astype(np.int64))
    np.testing.assert_array_equal(
        walk._descend(torch.as_tensor(pts)).numpy(),
        port_sdf._descend(torch.as_tensor(pts)).numpy(),
    )
    np.testing.assert_allclose(
        walk.get_distance(pts).numpy(), port_sdf.get_distance(pts).numpy(), **TOL
    )


def test_node_walk_on_node_faces(port_sdf, jax_sdf):
    """Points on node faces (coordinates at box_min + size k / 16 on a
    random half of the axes): the node walk answers as RealSdf and as the
    JAX package's grid route within 1e-6. (The JAX package's walk puts a
    point at exactly 0.5 of a node at the lower child's lower face and
    misses by up to 0.165 here; ROADMAP.md, Queue 3.)"""
    rng = np.random.default_rng(3)
    lo, size = port_sdf.box.min.astype(np.float32), np.float32(port_sdf.box.size[0])
    faces = (lo + size * (rng.integers(1, 16, (2000, 3)) / 16.0)).astype(np.float32)
    free = rng.uniform(lo, lo + size, (2000, 3)).astype(np.float32)
    q = np.where(rng.random((2000, 3)) < 0.5, faces, free).astype(np.float32)
    walk = ExactOctreeSdf.from_jax_state(port_sdf._state_arrays(), device="cpu")
    walk._leaf_grid = None
    d = walk.get_distance(q).numpy()
    mesh, _ = _mesh_box(make_torus)
    np.testing.assert_allclose(d, RealSdf(mesh, device="cpu").get_distance(q).numpy(),
                               rtol=0, atol=1e-6)
    j = ExactOctreeSdf.from_jax_state(jax_sdf._state_arrays(), device="cpu")
    j._leaf_grid = None
    np.testing.assert_allclose(j.get_distance(q).numpy(), _np(jax_sdf.get_distance(q)),
                               rtol=0, atol=1e-6)


def test_query_shapes_and_batches(port_sdf, pts):
    """(..., 3) batches of any size, including a single point and sizes
    off the window width; torch input on the structure's device."""
    full = port_sdf.get_distance(pts).numpy()
    for n in (1, 31, 33, 100):
        np.testing.assert_array_equal(port_sdf.get_distance(pts[:n]).numpy(), full[:n])
    grid = torch.as_tensor(pts[:96]).reshape(4, 24, 3)
    d, g = port_sdf.get_distance_and_gradient(grid)
    assert d.shape == (4, 24) and g.shape == (4, 24, 3)
    np.testing.assert_array_equal(d.reshape(-1).numpy(), full[:96])


def test_unported_options_raise(tmp_path):
    """What the port refuses: an unknown strategy and bucket format, and a
    container of the "none" format, which holds no structure (the tiled
    containers load since the tiles were ported: tests/
    test_torch_parallel_tiles.py). The other strategies build, and a
    bucket table over the budget takes the id-only tier."""
    mesh, box = _mesh_box(make_torus)
    with pytest.raises(ValueError, match="strategy"):
        ExactOctreeSdf(mesh, box, strategy="nearest", **CFG, device="cpu")
    with pytest.raises(ValueError, match="bucket_format"):
        ExactOctreeSdf(mesh, box, bucket_format="vertex4", **CFG, device="cpu")
    small = ExactOctreeSdf(mesh, box, bucket_byte_budget=1024, **CFG, device="cpu")
    assert small.bucket_tier == "id_only" and small.bucket_fields is None
    path = str(tmp_path / "none.npz")
    np.savez(path, __format__=np.array("none"))
    with pytest.raises(ValueError, match="no structure"):
        SdfFunction.load(path, device="cpu")


@pytest.mark.parametrize("impl", ["xla", "xla_window"])
def test_pinned_scans_match_jax(port_sdf, jax_sdf, pts, impl):
    """Each scan pinned by name, in both packages: distances and gradients
    agree, and the port records the scan it took."""
    try:
        jax_sdf.set_scan_impl(impl)
        port_sdf.set_scan_impl(impl)
        d = port_sdf.get_distance(pts).numpy()
        assert port_sdf.last_scan_stats["scan"] == ("grouped" if impl == "xla" else "window")
        np.testing.assert_allclose(d, _np(jax_sdf.get_distance(pts)), **TOL)
        d_g, g = port_sdf.get_distance_and_gradient(pts[:256])
        d_gj, g_j = jax_sdf.get_distance_and_gradient(pts[:256])
        np.testing.assert_allclose(d_g.numpy(), _np(d_gj), **TOL)
        np.testing.assert_allclose(g.numpy(), _np(g_j), **TOL)
    finally:
        jax_sdf._default_scan_impl()
        port_sdf._default_scan_impl()
    with pytest.raises(ValueError):
        port_sdf.set_scan_impl("window")


@pytest.mark.parametrize("side", ["sparse", "dense"])
def test_auto_scan_choice_matches_jax_rule(port_sdf, jax_sdf, monkeypatch, side):
    """Batches on either side of a padded size of 4 points per leaf take
    the same scan, with the same group width, in both packages."""
    L = port_sdf.num_leaves
    assert L == int(jax_sdf.leaf_count.shape[0])
    below = max(p for p in (1 << k for k in range(10, 20)) if p < 4 * L)
    P = below if side == "sparse" else below + 1           # padded: below, 2 * below
    taken = {}
    real = jeo._exact_query_fused

    def spy(*args, **kw):
        taken["impl"] = kw["scan_impl"]
        return real(*args, **kw)

    monkeypatch.setattr(jeo, "_exact_query_fused", spy)
    q = np.random.default_rng(4).uniform(-0.45, 0.45, (P, 3)).astype(np.float32)
    d_j = _np(jax_sdf.get_distance(q))
    d = port_sdf.get_distance(q).numpy()
    want = "grouped" if side == "sparse" else "window"
    assert taken["impl"] == ("xla" if want == "grouped" else "xla_window")
    assert port_sdf.last_scan_stats["scan"] == want
    if want == "grouped":
        assert port_sdf.last_scan_stats["G"] == jax_sdf._last_scan_stats["G"]
    np.testing.assert_allclose(d, d_j, **TOL)


@pytest.mark.parametrize("entry", ["init", "from_jax_state", "real", "load", "octree_init",
                                   "octree_from_jax_state", "octree_load", "bin_load"])
def test_entry_points_default_to_the_card(entry, jax_sdf, monkeypatch, tmp_path):
    """The entry points of both octrees, the oracle, the container and the
    reference .bin default to device="cuda" (read from their signatures,
    nothing is built on a card), and without a card that default raises
    rather than running on the CPU."""
    mesh, box = _mesh_box(make_torus)
    octree_bin = os.path.join(os.path.dirname(__file__), "golden", "data", "octree_torus.bin")
    j_octree = j_load_bin(octree_bin)
    fn, call = {
        "init": (ExactOctreeSdf.__init__, lambda: ExactOctreeSdf(mesh, box, **CFG)),
        "from_jax_state": (ExactOctreeSdf.from_jax_state,
                           lambda: ExactOctreeSdf.from_jax_state(jax_sdf._state_arrays())),
        "real": (RealSdf.__init__, lambda: RealSdf(mesh)),
        "load": (SdfFunction.load, lambda: SdfFunction.load(str(tmp_path / "x.npz"))),
        "octree_init": (OctreeSdf.__init__, lambda: OctreeSdf(mesh, box, max_depth=3)),
        "octree_from_jax_state": (OctreeSdf.from_jax_state,
                                  lambda: OctreeSdf.from_jax_state(j_octree._state_arrays())),
        "octree_load": (SdfFunction.load, lambda: SdfFunction.load(str(tmp_path / "o.npz"))),
        "bin_load": (load_sdflib_bin, lambda: load_sdflib_bin(octree_bin)),
    }[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    jax_sdf.save(str(tmp_path / "x.npz"))
    j_octree.save(str(tmp_path / "o.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
