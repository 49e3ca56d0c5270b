"""The port's UniformGridSdf against the JAX package's, on small icospheres.

* BASIC and OCTREE init give JAX's corner values within 1e-6 (depths 3-4),
  and each init matches the port's RealSdf at the corners.
* The trilinear query and gradient answer as JAX's within 1e-6 on the
  same grid values, in the box and outside it (the border clamp).
* ``from_jax_state``, the ``.npz`` container and the reference GRID
  ``.bin`` both ways between the packages, equal bit for bit.
* The cases of tests/test_sdf_structures.py:40-130 and
  tests/test_tools_io.py:91 on the port.
* The entry points default to the card and raise without one.
"""
import inspect

import numpy as np
import pytest
import torch

from sdflib_tpu.io.sdflib_binary import load_sdflib_bin as j_load_bin
from sdflib_tpu.io.sdflib_binary import save_sdflib_bin as j_save_bin
from sdflib_tpu.sdf import UniformGridSdf as JGrid
from sdflib_tpu.sdf.sdf_function import SdfFunction as JSdfFunction
from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere
from sdflib_tpu_torch import RealSdf, SdfFunction, UniformGridSdf
from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin, save_sdflib_bin
from sdflib_tpu_torch.utils.primitives import make_icosphere

torch.set_num_threads(1)
TOL = dict(rtol=0, atol=1e-6)


def _mesh(make, sub=2, radius=0.4):
    return make(subdivisions=sub, radius=radius)


@pytest.fixture(scope="module")
def sphere_mesh():
    return _mesh(make_icosphere)


@pytest.fixture(scope="module")
def sphere_real(sphere_mesh):
    return RealSdf(sphere_mesh, device="cpu")


@pytest.fixture(scope="module")
def grids():
    """A depth-5 grid built by each package from the same mesh."""
    j = JGrid(_mesh(j_icosphere), _mesh(j_icosphere).bounding_box.add_margin(0.1), depth=5)
    p = UniformGridSdf(_mesh(make_icosphere), _mesh(make_icosphere).bounding_box.add_margin(0.1),
                       depth=5, device="cpu")
    return j, p


def _query_pts(box_min, box_max, n=400, seed=3):
    """Points in the grid's box, on its corners and outside it."""
    rng = np.random.default_rng(seed)
    inside = rng.uniform(box_min, box_max, (n, 3))
    outside = rng.uniform(box_min - 0.3, box_max + 0.3, (n // 4, 3))
    return np.concatenate([inside, outside, box_min[None], box_max[None]]).astype(np.float32)


@pytest.mark.parametrize("init", ["basic", "octree"])
@pytest.mark.parametrize("depth", [3, 4])
def test_init_matches_jax(init, depth):
    """Each init gives the JAX package's corner values and layout."""
    kw = dict(depth=depth, init_algorithm=init)
    j = JGrid(_mesh(j_icosphere, 1, 0.35), _mesh(j_icosphere, 1, 0.35).bounding_box
              .add_margin(0.1), **kw)
    p = UniformGridSdf(_mesh(make_icosphere, 1, 0.35), _mesh(make_icosphere, 1, 0.35)
                       .bounding_box.add_margin(0.1), **kw, device="cpu")
    assert p.grid_size == j.grid_size and p.cell_size == j.cell_size
    np.testing.assert_array_equal(p.box.min, j.box.min)
    np.testing.assert_array_equal(p.box.max, j.box.max)
    assert p.grid.shape == j.grid.shape and p.grid.dtype == torch.float32
    np.testing.assert_allclose(p.grid.numpy(), np.asarray(j.grid), **TOL)


def test_cell_size_layout_matches_jax():
    """The cell_size constructor: per-axis corner counts and extent."""
    jm, pm = _mesh(j_icosphere, 1, 0.35), _mesh(make_icosphere, 1, 0.35)
    box_j = jm.bounding_box.add_margin(0.05)
    j = JGrid(jm, box_j, cell_size=0.07)
    p = UniformGridSdf(pm, pm.bounding_box.add_margin(0.05), cell_size=0.07, device="cpu")
    assert p.grid_size == j.grid_size
    np.testing.assert_array_equal(p.box.max, j.box.max)
    np.testing.assert_allclose(p.grid.numpy(), np.asarray(j.grid), **TOL)


@pytest.mark.parametrize("init", ["basic", "octree"])
def test_grid_matches_real_at_corners(init, sphere_mesh, sphere_real):
    """Every corner value is the exact SDF there (both inits)."""
    grid = UniformGridSdf(sphere_mesh, sphere_mesh.bounding_box.add_margin(0.1), depth=4,
                          init_algorithm=init, device="cpu")
    nx, ny, nz = grid.grid_size
    gz, gy, gx = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in (nz, ny, nx)),
                             indexing="ij")
    corners = grid.box.min + grid.cell_size * np.stack([gx, gy, gz], -1).reshape(-1, 3)
    real = sphere_real.get_distance(corners.astype(np.float32)).numpy()
    np.testing.assert_allclose(grid.grid.numpy().reshape(-1), real, rtol=1e-4, atol=1e-5)


def test_queries_match_jax(grids):
    """Trilinear distance and gradient on the same grid values, in and out
    of the box (the border clamp)."""
    j, _ = grids
    p = UniformGridSdf.from_jax_state(j._state_arrays(), device="cpu")
    pts = _query_pts(np.asarray(p.box.min), np.asarray(p.box.max))
    d, g = p.get_distance_and_gradient(pts)
    d_j, g_j = j.get_distance_and_gradient(pts)
    np.testing.assert_allclose(p.get_distance(pts).numpy(), np.asarray(j.get_distance(pts)), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **TOL)
    # batch shapes
    d2, g2 = p.get_distance_and_gradient(pts[:40].reshape(4, 10, 3))
    assert d2.shape == (4, 10) and g2.shape == (4, 10, 3)


def test_from_jax_state(grids):
    """A JAX grid's state moves to the port unchanged and answers alike."""
    j, _ = grids
    p = UniformGridSdf.from_jax_state(j._state_arrays(), device="cpu")
    assert p.grid_size == j.grid_size and p.cell_size == pytest.approx(j.cell_size, rel=1e-6)
    np.testing.assert_array_equal(p.grid.numpy(), np.asarray(j.grid))
    pts = _query_pts(np.asarray(p.box.min), np.asarray(p.box.max), seed=4)
    np.testing.assert_allclose(p.get_distance(pts).numpy(), np.asarray(j.get_distance(pts)),
                               **TOL)
    for key, val in j._state_arrays().items():
        np.testing.assert_array_equal(p._state_arrays()[key], np.asarray(val), err_msg=key)


def test_npz_both_ways(grids, tmp_path):
    """The .npz container: the port's loads in JAX equal, and the reverse."""
    j, p = grids
    p.save(str(tmp_path / "port.npz"))
    j.save(str(tmp_path / "jax.npz"))
    from_port = JSdfFunction.load(str(tmp_path / "port.npz"))
    from_jax = SdfFunction.load(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(from_jax, UniformGridSdf)
    np.testing.assert_array_equal(np.asarray(from_port.grid), p.grid.numpy())
    np.testing.assert_array_equal(from_jax.grid.numpy(), np.asarray(j.grid))
    assert from_port.grid_size == p.grid_size and from_jax.grid_size == j.grid_size


def test_bin_both_ways(grids, tmp_path):
    """The reference GRID .bin: the port writes the JAX package's bytes,
    and each package loads the other's file bit-equal."""
    j, p = grids
    same = UniformGridSdf.from_jax_state(j._state_arrays(), device="cpu")
    save_sdflib_bin(same, str(tmp_path / "port.bin"))
    j_save_bin(j, str(tmp_path / "jax.bin"))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    save_sdflib_bin(p, str(tmp_path / "own.bin"))
    in_jax = j_load_bin(str(tmp_path / "own.bin"))
    np.testing.assert_array_equal(np.asarray(in_jax.grid), p.grid.numpy())
    in_port = load_sdflib_bin(str(tmp_path / "jax.bin"), device="cpu")
    assert isinstance(in_port, UniformGridSdf) and in_port.grid_size == j.grid_size
    np.testing.assert_array_equal(in_port.grid.numpy(), np.asarray(j.grid))
    np.testing.assert_array_equal(in_port.box.min, j.box.min)


# -- the cases of tests/test_sdf_structures.py:40-130 on the port ----------


def test_uniform_grid_matches_oracle_at_corners(sphere_mesh, sphere_real):
    grid = UniformGridSdf(sphere_mesh, sphere_mesh.bounding_box.add_margin(0.1), depth=4,
                          device="cpu")
    nx = grid.grid_size[0]
    xs = np.arange(nx, dtype=np.float32) * grid.cell_size + grid.box.min[0]
    pts = np.stack([xs[: nx - 1], np.full(nx - 1, grid.box.min[1] + grid.cell_size),
                    np.full(nx - 1, grid.box.min[2] + 2 * grid.cell_size)], axis=-1)
    np.testing.assert_allclose(grid.get_distance(pts).numpy(),
                               sphere_real.get_distance(pts).numpy(), rtol=1e-4, atol=1e-5)


def test_uniform_grid_interior_accuracy(grids, sphere_real):
    _, grid = grids
    pts = np.random.default_rng(1).uniform(-0.35, 0.35, (256, 3)).astype(np.float32)
    np.testing.assert_allclose(grid.get_distance(pts).numpy(),
                               sphere_real.get_distance(pts).numpy(),
                               atol=2.5 * grid.cell_size**2 / 0.4 + 2e-3)


def test_uniform_grid_gradient(grids):
    """Analytic trilinear gradient == central differences of the query."""
    _, grid = grids
    rng = np.random.default_rng(7)
    cell_idx = rng.integers(8, 24, (32, 3))
    frac = rng.uniform(0.2, 0.8, (32, 3))
    pts = (grid.box.min + (cell_idx + frac) * grid.cell_size).astype(np.float32)
    g = grid.get_distance_and_gradient(pts)[1].numpy()
    fd = np.zeros_like(g)
    for ax in range(3):
        dp = np.zeros(3, np.float32)
        dp[ax] = 1e-4
        fd[:, ax] = (grid.get_distance(pts + dp).numpy()
                     - grid.get_distance(pts - dp).numpy()) / 2e-4
    np.testing.assert_allclose(g, fd, atol=2e-3)
    gn = g / np.linalg.norm(g, axis=-1, keepdims=True)
    radial = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    assert np.mean(np.sum(gn * radial, axis=-1) > 0.9) > 0.9


def test_uniform_grid_save_load_roundtrip(tmp_path, sphere_mesh):
    grid = UniformGridSdf(sphere_mesh, sphere_mesh.bounding_box.add_margin(0.05), depth=3,
                          device="cpu")
    grid.save(str(tmp_path / "grid.npz"))
    loaded = SdfFunction.load(str(tmp_path / "grid.npz"), device="cpu")
    assert isinstance(loaded, UniformGridSdf) and loaded.grid_size == grid.grid_size
    pts = np.random.default_rng(2).uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(loaded.get_distance(pts).numpy(),
                               grid.get_distance(pts).numpy(), rtol=1e-6)


def test_grid_octree_init_matches_basic():
    mesh = make_icosphere(subdivisions=1, radius=0.35)
    box = mesh.bounding_box.add_margin(0.1)
    basic = UniformGridSdf(mesh, box, depth=4, init_algorithm="basic", device="cpu")
    octree = UniformGridSdf(mesh, box, depth=4, init_algorithm="octree", device="cpu")
    np.testing.assert_allclose(octree.grid.numpy(), basic.grid.numpy(), atol=1e-5)


def test_bin_roundtrip_grid(tmp_path):
    """tests/test_tools_io.py:91 on the port."""
    mesh = make_icosphere(subdivisions=1, radius=0.4)
    grid = UniformGridSdf(mesh, mesh.bounding_box.add_margin(0.1), depth=3, device="cpu")
    path = str(tmp_path / "g.bin")
    save_sdflib_bin(grid, path)
    loaded = load_sdflib_bin(path, device="cpu")
    pts = np.random.default_rng(1).uniform(-0.3, 0.3, (128, 3)).astype(np.float32)
    np.testing.assert_array_equal(loaded.get_distance(pts).numpy(),
                                  grid.get_distance(pts).numpy())


@pytest.mark.parametrize("entry", ["init", "from_jax_state", "load", "bin_load"])
def test_entry_points_default_to_the_card(entry, grids, monkeypatch, tmp_path):
    """UniformGridSdf, SdfFunction.load(GRID) and load_sdflib_bin(GRID)
    default to device="cuda" and, without a card, raise rather than run on
    the CPU."""
    j, _ = grids
    j.save(str(tmp_path / "g.npz"))
    j_save_bin(j, str(tmp_path / "g.bin"))
    mesh = make_icosphere(subdivisions=1, radius=0.4)
    fn, call = {
        "init": (UniformGridSdf.__init__,
                 lambda: UniformGridSdf(mesh, mesh.bounding_box, depth=2)),
        "from_jax_state": (UniformGridSdf.from_jax_state,
                           lambda: UniformGridSdf.from_jax_state(j._state_arrays())),
        "load": (SdfFunction.load, lambda: SdfFunction.load(str(tmp_path / "g.npz"))),
        "bin_load": (load_sdflib_bin, lambda: load_sdflib_bin(str(tmp_path / "g.bin"))),
    }[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
