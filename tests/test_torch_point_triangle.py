"""The port's point-triangle math against the JAX package's on the same
inputs (atol 1e-6, fp32 rounding order), and the port's RealSdf against
the compiled-reference goldens (tolerances of test_reference_parity.py)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflib_tpu.ops import point_triangle as J
from sdflib_tpu.triangle import TriangleDataSoA as JSoA, calculate_mesh_triangle_data
from sdflib_tpu.utils.primitives import make_cube as j_cube, make_icosphere, make_plane as j_plane
from sdflib_tpu.utils.primitives import make_torus
from sdflib_tpu_torch import RealSdf
from sdflib_tpu_torch.mesh import Mesh
from sdflib_tpu_torch.ops import point_triangle as P
from sdflib_tpu_torch.triangle import TriangleDataSoA as TSoA
from sdflib_tpu_torch.triangle import calculate_mesh_triangle_data as t_calc, soa_to_torch
from sdflib_tpu_torch.utils.primitives import make_cube, make_plane

torch.set_num_threads(1)
ATOL = 1e-6
DATA = os.path.join(os.path.dirname(__file__), "golden", "data")


@pytest.fixture(scope="module")
def case():
    """Random points paired with random triangles of a torus (P pairs)."""
    rng = np.random.default_rng(0)
    soa = calculate_mesh_triangle_data(make_torus(R=0.3, r=0.12, nu=20, nv=12))
    n = 2000
    pick = rng.integers(0, soa.num_triangles, n)
    tri = JSoA(*(np.asarray(f)[pick] for f in soa))
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    # a quarter of the points close to their triangle's surface
    on = tri.v_world.mean(axis=1)[: n // 4]
    pts[: n // 4] = on + rng.normal(0, 0.01, on.shape).astype(np.float32)
    return pts, tri, TSoA(*(torch.as_tensor(f) for f in tri)), soa


def test_pair_functions_match_jax(case):
    pts, jt, tt, _ = case
    jp, tp = jnp.asarray(pts), torch.as_tensor(pts)
    jtri = JSoA(*(jnp.asarray(f) for f in jt))
    np.testing.assert_allclose(
        P.sq_dist_pair(tp, tt).numpy(), jax.vmap(J.sq_dist_pair)(jp, jtri), atol=ATOL
    )
    np.testing.assert_allclose(
        P.signed_dist_pair(tp, tt).numpy(),
        jax.vmap(J.signed_dist_pair)(jp, jtri), atol=ATOL,
    )
    d_t, g_t = P.signed_dist_grad_pair(tp, tt)
    d_j, g_j = jax.vmap(J.signed_dist_grad_pair)(jp, jtri)
    np.testing.assert_allclose(d_t.numpy(), d_j, atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=ATOL)


def test_packers_and_row_evaluators_match_jax(case):
    pts, _, _, soa = case
    t_soa = TSoA(*(torch.as_tensor(np.asarray(f)) for f in soa))
    f19 = P.pack_triangle_fields(t_soa)
    f37 = P.pack_triangle_full_fields(t_soa)
    np.testing.assert_array_equal(f19.numpy(), J.pack_triangle_fields(soa))
    np.testing.assert_array_equal(f37.numpy(), J.pack_triangle_full_fields(soa))

    # every point against every triangle: (P, T) broadcasts
    p = pts[:256]
    tx, ty, tz = (torch.as_tensor(p[:, k : k + 1]) for k in range(3))
    jx, jy, jz = (jnp.asarray(p[:, k : k + 1]) for k in range(3))
    j19, j37 = J.pack_triangle_fields(soa), J.pack_triangle_full_fields(soa)
    np.testing.assert_allclose(
        P.sq_dist_from_field_fn(tx, ty, tz, lambda r: f19[None, :, r]).numpy(),
        J.sq_dist_from_field_fn(jx, jy, jz, lambda r: j19[None, :, r]), atol=ATOL,
    )
    np.testing.assert_allclose(
        P.signed_dist_from_rows(tx, ty, tz, lambda r: f37[None, :, r]).numpy(),
        J.signed_dist_from_rows(jx, jy, jz, lambda r: j37[None, :, r]), atol=ATOL,
    )
    v9 = np.asarray(soa.v_world).reshape(-1, 9)
    tv, jv = torch.as_tensor(v9), jnp.asarray(v9)
    np.testing.assert_allclose(
        P.sq_dist_from_vertex_cols(tx, ty, tz, lambda r: tv[None, :, r]).numpy(),
        J.sq_dist_from_vertex_cols(jx, jy, jz, lambda r: jv[None, :, r]), atol=ATOL,
    )


def test_analytic_gradient_matches_jax_vjp(case):
    """The region cull's 2 (p - proj), computed branch by branch, against
    the JAX cull's vjp of the same squared distance."""
    pts, _, _, soa = case
    f19 = J.pack_triangle_fields(soa)[:64]
    p = pts[:128]
    lx, ly, lz = (jnp.broadcast_to(jnp.asarray(p[:, k : k + 1]), (128, 64)) for k in range(3))
    sq_j, vjp = jax.vjp(lambda a, b, c: J.sq_dist_packed(a, b, c, f19[None]), lx, ly, lz)
    g_j = vjp(jnp.ones_like(sq_j))
    t19 = torch.as_tensor(np.array(f19))
    sq_t, *g_t = P.sq_dist_and_grad_from_field_fn(
        *(torch.as_tensor(p[:, k : k + 1]) for k in range(3)), lambda r: t19[None, :, r]
    )
    np.testing.assert_array_equal(sq_t.numpy(), sq_j)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL)


def test_degenerate_triangle_vertex_rows_match_jax():
    """A zero-area triangle: the frame's reciprocal length is infinite and
    the distance NaN in both packages; a zero-length edge likewise."""
    tris = np.array(
        [
            [0, 0, 0, 1, 0, 0, 2, 0, 0],      # collinear
            [0, 0, 0, 0, 0, 0, 0, 1, 0],      # zero-length first edge
            [0, 0, 0, 1, 0, 0, 0, 1, 0],      # regular
        ],
        np.float32,
    )
    p = np.array([[0.3, 0.2, 0.5], [1.0, -1.0, 0.0]], np.float32)
    t = P.sq_dist_from_vertex_cols(
        *(torch.as_tensor(p[:, k : k + 1]) for k in range(3)),
        lambda r: torch.as_tensor(tris)[None, :, r],
    ).numpy()
    j = np.asarray(J.sq_dist_from_vertex_cols(
        *(jnp.asarray(p[:, k : k + 1]) for k in range(3)),
        lambda r: jnp.asarray(tris)[None, :, r],
    ))
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(t[:, :2]).all()
    np.testing.assert_allclose(t[:, 2], j[:, 2], atol=ATOL)


def _both_batches(t_mesh, j_mesh, points):
    """The port's ``signed_distance_batch`` on its own mesh and the JAX
    package's on its own, numpy out."""
    t = P.signed_distance_batch(torch.as_tensor(points),
                                soa_to_torch(t_calc(t_mesh), "cpu")).numpy()
    jsoa = jax.tree.map(jnp.asarray, calculate_mesh_triangle_data(j_mesh))
    return t, np.asarray(J.signed_distance_batch(jnp.asarray(points), jsoa))


def test_cube_signed_distance_matches_jax():
    """tests/test_point_triangle.py's cube case: 512 points of [-1, 1]^3
    against the unit cube, the port within 1e-6 of JAX and both within
    the analytic box distance's tolerance there (rtol 1e-4, atol 1e-5)."""
    points = np.random.default_rng(3).uniform(-1, 1, size=(512, 3)).astype(np.float32)
    t, j = _both_batches(make_cube(size=1.0), j_cube(size=1.0), points)
    np.testing.assert_allclose(t, j, atol=ATOL)
    q = np.abs(points) - 0.5
    expected = np.linalg.norm(np.maximum(q, 0), axis=-1) + np.minimum(q.max(axis=-1), 0)
    np.testing.assert_allclose(t, expected, rtol=1e-4, atol=1e-5)


def test_open_surface_plane_matches_jax():
    """tests/test_point_triangle.py's open-surface case: a z=0 quad of 2x2
    cells, a point above, one below, and one past the edge whose sign
    comes from the face normal (boundary pseudonormal)."""
    points = np.array([[0.0, 0.0, 0.3], [0.1, -0.1, -0.25], [0.8, 0.0, 0.05]], np.float32)
    t, j = _both_batches(make_plane(size=1.0, res=2), j_plane(size=1.0, res=2), points)
    np.testing.assert_allclose(t, j, atol=ATOL)
    np.testing.assert_allclose(t, [0.3, -0.25, np.sqrt(0.3**2 + 0.05**2)], atol=1e-5)


def _golden_mesh(name):
    if name == "icosphere":
        m = make_icosphere(subdivisions=3, radius=0.42)
    elif name == "torus":
        m = make_torus(R=0.3, r=0.12, nu=48, nv=24)
    else:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
        from make_goldens import non_manifold_fin_mesh

        m = non_manifold_fin_mesh()
    return Mesh(m.vertices, m.indices)


@pytest.mark.parametrize("name", ["icosphere", "torus", "nonmanifold"])
def test_real_sdf_matches_cpp_goldens(name):
    """The port's RealSdf on every 5th golden sample (20k of the 100k: half
    uniform, half near the surface, as in the file), with the tolerances
    of test_reference_parity.py::test_brute_force_distance_matches_cpp."""
    g = np.load(os.path.join(DATA, f"dist_{name}.npz"))
    sel = slice(None, None, 5)
    pts, gd, gg = g["points"][sel], g["dist"][sel], g["grad"][sel]
    d, grad = RealSdf(_golden_mesh(name), device="cpu").get_distance_and_gradient(pts)
    d, grad = d.numpy(), grad.numpy()
    np.testing.assert_allclose(np.abs(d), np.abs(gd), atol=5e-5)
    sign_mismatch = (np.sign(d) != np.sign(gd)) & (np.abs(gd) > 1e-4)
    assert sign_mismatch.mean() < 1e-4
    stable = np.abs(gd) > 1e-3
    err = np.linalg.norm(grad - gg, axis=-1)
    assert (err[stable] > 1e-3).mean() < 5e-3
    # the distance-only path gives the same distances
    np.testing.assert_array_equal(RealSdf(_golden_mesh(name), device="cpu").get_distance(pts[:2000]).numpy(), d[:2000])
