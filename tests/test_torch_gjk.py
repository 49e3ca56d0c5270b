"""The port's box-triangle tests (``sdflib_tpu_torch/ops/gjk.py``) against
the JAX package's ``ops/gjk.py``, on ``tests/test_gjk.py``'s cases and on
seeded random boxes and triangles (numpy, seeds 0-2).

Tolerances: the exact box-triangle distance, the overlap test, the
largest distance and ``gjk_is_near`` within 1e-6 / equal (XLA on the CPU
fuses the dot products' multiply-adds, so values differ in the last
ulp); the Frank-Wolfe iterates follow the argmin of such dot products,
so a near tie can send the two packages along different paths: their
upper bounds agree within 1e-6 on at least 95% of the cases, both stay
at or above the exact distance, and the hull's lower bound agrees within
1e-5 on at least 95% and stays below the sampled distance."""
import numpy as np
import pytest
import torch

import sdflib_tpu.ops.gjk as J
import sdflib_tpu_torch.ops.gjk as T
from sdflib_tpu.ops.point_triangle import sq_dist_naive as j_naive
from sdflib_tpu_torch.ops.point_triangle import sq_dist_naive

torch.set_num_threads(1)


def _random_cases(seed, n):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    halves = np.broadcast_to(rng.uniform(0.05, 0.4, (n, 1)).astype(np.float32), (n, 3)).copy()
    tris = rng.uniform(-1.5, 1.5, (n, 3, 3)).astype(np.float32)
    return centers, halves, tris


def _fixed_cases():
    """tests/test_gjk.py's hand-made boxes and triangles."""
    c = np.zeros((4, 3), np.float32)
    h = np.array([[0.3] * 3, [0.5] * 3, [0.5] * 3, [0.5] * 3], np.float32)
    t = np.array([
        [[-1.0, 0.0, 0.0], [1.0, 0.1, 0.0], [0.0, 0.0, 1.0]],      # overlap
        [[1.0, -1.0, -1.0], [1.0, 2.0, -1.0], [1.0, 0.0, 2.0]],    # separated axis
        [[1.0, 1.0, -2.0], [1.0, 1.0, 2.0], [1.0, 1.001, 0.0]],    # edge-edge
        [[2.0, 0.0, 0.0], [2.5, 0.0, 0.0], [2.0, 0.5, 0.0]],       # max distance
    ], np.float32)
    return c, h, t


CASES = {"fixed": _fixed_cases, "seed0": lambda: _random_cases(0, 512),
         "seed1": lambda: _random_cases(1, 512)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fn", ["box_triangle_distance", "box_triangle_overlap",
                                "gjk_max_distance"])
def test_exact_functions_match_jax(fn, case):
    c, h, t = CASES[case]()
    want = np.asarray(getattr(J, fn)(c, h, t))
    got = getattr(T, fn)(c, h, t).numpy()
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fixed_cases_values():
    """tests/test_gjk.py's expected values, through the port."""
    c, h, t = _fixed_cases()
    d = T.box_triangle_distance(c, h, t).numpy()
    assert d[0] == 0.0 and bool(T.box_triangle_overlap(c, h, t)[0])
    assert abs(d[1] - 0.5) < 1e-6
    assert abs(d[2] - np.sqrt(0.5)) < 1e-3
    expect = np.sqrt(3.0**2 + 0.5**2 + 0.5**2)
    assert abs(float(T.gjk_max_distance(c, h, t)[3]) - expect) < 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_is_near_decides_as_jax(seed):
    c, h, t = _random_cases(seed, 512)
    for thr in (0.1, 0.5, 1.0):
        np.testing.assert_array_equal(T.gjk_is_near(c, h, t, thr).numpy(),
                                      np.asarray(J.gjk_is_near(c, h, t, thr)))


@pytest.mark.parametrize("iterations", [1, 15])
def test_frank_wolfe_matches_jax(iterations):
    c, h, t = _random_cases(1, 512)
    exact = T.box_triangle_distance(c, h, t).numpy()
    got = T.gjk_min_distance(c, h, t, iterations=iterations).numpy()
    want = np.asarray(J.gjk_min_distance(c, h, t, iterations=iterations))
    assert np.mean(np.abs(got - want) <= 1e-6) >= 0.95
    assert np.all(got >= exact - 1e-5)
    assert np.all(want >= exact - 1e-5)
    verts = T.minkowski_box_triangle(c, h, t)
    np.testing.assert_allclose(verts.numpy(), np.asarray(J.minkowski_box_triangle(c, h, t)),
                               rtol=0, atol=0)
    assert torch.equal(T.frank_wolfe_min_norm(verts, iterations), torch.as_tensor(got))


def test_corner_sphere_hull_lower_bound():
    """The hull's lower bound against JAX's, and below the distance
    between the triangle's and the hull's samples."""
    c, h, t = _random_cases(2, 512)
    radii = np.random.default_rng(5).uniform(0.0, 0.3, (512, 8)).astype(np.float32)
    half = 0.2
    got = T.corner_sphere_hull_tri_lower(c, half, radii, t).numpy()
    want = np.asarray(J.corner_sphere_hull_tri_lower(c, half, radii, t))
    assert np.mean(np.abs(got - want) <= 1e-5) >= 0.95
    # sampled distance: triangle points vs corner spheres' nearest points
    w = np.random.default_rng(6).dirichlet(np.ones(3), 64).astype(np.float32)
    tri_pts = np.einsum("sv,nvd->nsd", w, t)                         # (n, 64, 3)
    corners = c[:, None, :] + T._BOX_SIGNS[None] * half              # (n, 8, 3)
    dd = np.linalg.norm(tri_pts[:, :, None] - corners[:, None], axis=-1) - radii[:, None]
    assert np.all(got <= dd.min(axis=(1, 2)) + 1e-5)


def test_sq_dist_naive_matches_jax():
    rng = np.random.default_rng(3)
    p, a, b, c = (rng.uniform(-1, 1, (1024, 3)).astype(np.float32) for _ in range(4))
    got = sq_dist_naive(*(torch.as_tensor(x) for x in (p, a, b, c))).numpy()
    np.testing.assert_allclose(got, np.asarray(j_naive(p, a, b, c)), rtol=1e-5, atol=1e-7)
