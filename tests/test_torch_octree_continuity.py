"""The port's continuity builder against the JAX package's, on the
icosphere of tests/test_octree.py at max depth 4, start depth 2, where the
JAX build re-opens 128 leaves.

The builds agree in leaves and nodes per depth, length, node words,
re-opened leaves and clamped midpoints; coefficients and distances as in
test_torch_octree.py (fp32 sums in another order, and mirror winners at
exact nearest-triangle ties). The host tables and the registry lookup
are equal; the re-open cull keeps the same triangles; the JAX-built
structure answers in the port as in JAX within 1e-6 / 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdflib_tpu.sdf.octree_builder_continuity as jc
from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
from sdflib_tpu.triangle import calculate_mesh_triangle_data as j_tri_data
from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere
from sdflib_tpu_torch import OctreeSdf
from sdflib_tpu_torch.ops.point_triangle import pack_triangle_fields
from sdflib_tpu_torch.sdf import octree_builder_continuity as pc
from sdflib_tpu_torch.sdf.octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK
from sdflib_tpu_torch.triangle import calculate_mesh_triangle_data, soa_to_torch
from sdflib_tpu_torch.utils.primitives import make_icosphere

torch.set_num_threads(1)
CFG = dict(max_depth=4, start_depth=2, termination_threshold=1e-3,
           init_algorithm="continuity")


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
    rng = np.random.default_rng(8)
    return np.concatenate([rng.uniform(-0.48, 0.48, (3000, 3)),
                           rng.uniform(-1.5, 1.5, (200, 3))]).astype(np.float32)


def test_continuity_build_matches_jax(jax_sdf, port_sdf, pts):
    js, ps = jax_sdf.build_stats, port_sdf.build_stats
    assert js["resubdivided"] > 0
    for key in ("leaves_per_depth", "nodes_per_depth", "resubdivided", "midpoints_clamped"):
        assert ps[key] == js[key], key
    jd = np.asarray(jax_sdf.octree_data)
    assert port_sdf.octree_data.shape == jd.shape
    assert port_sdf.value_range == pytest.approx(jax_sdf.value_range, rel=1e-6)
    assert abs(port_sdf.min_border_value - jax_sdf.min_border_value) <= 2e-6
    np.testing.assert_array_equal(port_sdf._leaf_depths, jax_sdf._leaf_depths)

    # node words equal; coefficient rows within 1e-4 of their scale but
    # for leaves fitted at exact nearest-triangle ties
    leaf = (jd & IS_LEAF_MASK) != 0
    first_coeff = int((jd[leaf] & CHILDREN_INDEX_MASK).min())
    np.testing.assert_array_equal(port_sdf.octree_data[:first_coeff], jd[:first_coeff])
    cj = jd[first_coeff:].view(np.float32).reshape(-1, 64)
    cp = port_sdf.octree_data[first_coeff:].view(np.float32).reshape(-1, 64)
    off = np.abs(cp - cj).max(axis=1) / np.maximum(1.0, np.abs(cj).max(axis=1)) > 1e-4
    assert off.mean() <= 0.01, f"{off.sum()} of {len(off)} rows differ"

    d_j = np.asarray(jax_sdf.get_distance(pts))
    d_p = port_sdf.get_distance(pts).numpy()
    assert (np.abs(d_p - d_j) <= 1e-5).mean() >= 0.995
    assert np.abs(d_p - d_j).max() <= 1e-3


@pytest.mark.parametrize("grid", [False, True])
def test_jax_continuity_structure_answers_as_jax(jax_sdf, pts, grid):
    j = copy.copy(jax_sdf)
    p = OctreeSdf.from_jax_state(jax_sdf._state_arrays(), device="cpu")
    if grid:
        j.build_query_grid()
        p.build_query_grid()
    d, g = p.get_distance_and_gradient(pts)
    d_j, g_j = j.get_distance_and_gradient(pts)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0, atol=1e-5)


def test_host_tables_and_registry_match_jax():
    np.testing.assert_array_equal(pc._NB_MIDS, jc._NB_MIDS)
    np.testing.assert_array_equal(pc._NB_DELTAS, jc._NB_DELTAS)
    rng = np.random.default_rng(9)
    n = 400
    d, x, y, z = (rng.integers(2, 6, n), *(rng.integers(0, 64, (3, n))))
    np.testing.assert_array_equal(pc._code(d, x, y, z), jc._code(d, x, y, z))

    regs = []
    for mod in (pc, jc):
        reg = mod._LeafRegistry(8)
        for lo in (0, n // 2):   # two appends, the second after a re-open
            sl = slice(lo, lo + n // 2)
            reg.add(mod._code(d[sl], x[sl], y[sl], z[sl]),
                    rng.standard_normal((n // 2, 8)), np.zeros((n // 2, 8, 8)),
                    np.zeros((n // 2, 3)), np.ones(n // 2), np.arange(n // 2) + lo,
                    d[sl])
            reg.alive[lo : lo + 20] = False
        regs.append(reg)
    probe = np.concatenate([pc._code(d, x, y, z), pc._code(d[:50], x[:50] + 64, y[:50], z[:50])])
    np.testing.assert_array_equal(pc._lookup_leaves(regs[0], probe),
                                  jc._lookup_leaves(regs[1], probe))


def test_reopen_cull_matches_jax():
    """The (R, T) centre-distance cull of re-opened leaves keeps the same
    triangles."""
    mesh, box = _mesh_box(make_icosphere)
    tris = soa_to_torch(calculate_mesh_triangle_data(mesh), "cpu")
    j_tris = jax.tree.map(jnp.asarray, j_tri_data(_mesh_box(j_icosphere)[0]))
    centers = np.random.default_rng(10).uniform(-0.45, 0.45, (96, 3)).astype(np.float32)
    for half in (0.06125, 0.030625):
        keep = pc._cull_chunk(pack_triangle_fields(tris).t().contiguous(),
                              torch.as_tensor(centers), np.float32(half)).numpy()
        keep_j = np.asarray(jc._cull_chunk(j_tris, jnp.asarray(centers), jnp.float32(half)))
        np.testing.assert_array_equal(keep, keep_j)
        assert 0 < keep.sum() < keep.size
