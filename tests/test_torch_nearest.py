"""K2 (nearest triangle): the plain version against the JAX package's
``nearest_triangle`` and its Pallas kernel in interpret mode, the grid
split of the kernel, K2's point order (the plain order is a stable sort
of the Morton codes over the points' own box; K2's results do not depend
on the order), and, on a CUDA device, the kernel and the order's kernels
against their plain versions.

Between the packages squared distances agree within rtol 1e-5 / atol
1e-7 (fp32 rounding order); indices may differ only on last-ulp ties,
where the signed distances through either winner agree within 1e-6. The
kernel and the plain version round alike (``--fmad=false``), so their
squared distances are equal. At exact ties (a duplicated triangle) every
version returns the lower index.

JAX is imported inside the fixture: the GPU machine has no JAX and runs
only the cuda-marked cases (``pytest --noconftest -m cuda``).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sdflib_tpu_torch.mesh import Mesh
from sdflib_tpu_torch.ops import nearest
from sdflib_tpu_torch.ops.point_triangle import (
    gather_triangles,
    pack_triangle_fields,
    signed_dist_pair,
    sq_dist_pair,
)
from sdflib_tpu_torch.triangle import calculate_mesh_triangle_data, soa_to_torch
from sdflib_tpu_torch.utils.primitives import make_icosphere, make_torus

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from sdflib_tpu.ops.pallas_kernels import nearest_triangle_pallas
    from sdflib_tpu.ops.point_triangle import nearest_triangle

    return SimpleNamespace(
        jax=jax, jnp=jnp, nearest=nearest_triangle, pallas=nearest_triangle_pallas
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tris(mesh, device="cpu"):
    soa = calculate_mesh_triangle_data(mesh)
    tris = soa_to_torch(soa, device)
    return soa, tris, pack_triangle_fields(tris)


def _dup_mesh(nu, nv, k):
    """A torus with triangle ``k`` repeated at the end (index nu * nv * 2),
    and 8 points just off triangle k's centroid along its normal: the two
    copies tie exactly, every other triangle is farther."""
    torus = make_torus(R=0.3, r=0.12, nu=nu, nv=nv)
    idx = np.concatenate([torus.indices, torus.indices[k : k + 1]])
    mesh = Mesh(torus.vertices, idx)
    a, b, c = mesh.vertices[idx[k].astype(np.int64)].astype(np.float64)
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n)
    h = np.array([-3e-3, -1e-3, -3e-4, -1e-4, 1e-4, 3e-4, 1e-3, 3e-3])
    pts = ((a + b + c) / 3 + h[:, None] * n).astype(np.float32)
    return mesh, pts


def _assert_same_nearest(pts, tris, b0, i0, b1, i1):
    np.testing.assert_allclose(np.asarray(b0), np.asarray(b1), rtol=1e-5, atol=1e-7)
    i0, i1 = (torch.as_tensor(np.array(i, np.int32)).to(tris.origin.device)
              for i in (i0, i1))
    d0 = signed_dist_pair(pts, gather_triangles(tris, i0))
    d1 = signed_dist_pair(pts, gather_triangles(tris, i1))
    np.testing.assert_allclose(d0.cpu().numpy(), d1.cpu().numpy(), atol=1e-6)


@pytest.mark.parametrize("mesh_name", ["icosphere", "torus"])
def test_plain_matches_jax_and_pallas(jx, mesh_name):
    mesh = (make_icosphere(subdivisions=2, radius=0.35) if mesh_name == "icosphere"
            else make_torus(R=0.3, r=0.12, nu=20, nv=12))
    soa, tris, fields = _tris(mesh)
    jtris = jx.jax.tree.map(jx.jnp.asarray, soa)
    pts = np.random.default_rng(0).uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    tp = torch.as_tensor(pts)
    b, i = nearest.nearest_triangle(tp, fields)          # CPU: the plain version
    assert b.dtype == torch.float32 and i.dtype == torch.int32
    b_j, i_j = jx.nearest(pts, jtris)
    _assert_same_nearest(tp, tris, b, i, b_j, i_j)
    b_p, i_p = jx.pallas(pts, jtris, interpret=True)
    _assert_same_nearest(tp, tris, b, i, b_p, i_p)
    # off ties the indices are the same: where they differ, the JAX winner
    # is as near as the port's own
    other = np.array(i_j)
    diff = i.numpy() != other
    alt = sq_dist_pair(tp[diff], gather_triangles(tris, torch.as_tensor(other[diff])))
    np.testing.assert_allclose(alt.numpy(), b.numpy()[diff], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [1, 3, 130, 513])
def test_plain_unaligned_sizes(jx, n):
    """Point counts off any tile and a triangle count off the chunk."""
    soa, tris, fields = _tris(make_torus(R=0.3, r=0.1, nu=7, nv=5))
    pts = np.random.default_rng(n).uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    b, i = nearest.nearest_triangle_plain(torch.as_tensor(pts), fields, chunk=32, block=100)
    b_j, i_j = jx.nearest(pts, jx.jax.tree.map(jx.jnp.asarray, soa))
    _assert_same_nearest(torch.as_tensor(pts), tris, b, i, b_j, i_j)


def test_exact_tie_goes_to_the_lower_index(jx):
    """Triangle 100 and its copy at index 576 tie exactly: the copy lies
    in another 512-triangle chunk of the plain and JAX scans and another
    256-triangle tile of the Pallas kernel; all three keep index 100."""
    mesh, pts = _dup_mesh(24, 12, 100)
    soa, tris, fields = _tris(mesh)
    assert fields.shape[0] == 577 and torch.equal(fields[100], fields[576])
    jtris = jx.jax.tree.map(jx.jnp.asarray, soa)
    b, i = nearest.nearest_triangle_plain(torch.as_tensor(pts), fields)
    b_j, i_j = jx.nearest(pts, jtris)
    b_p, i_p = jx.pallas(pts, jtris, interpret=True)
    for bb, ii in ((b, i), (b_j, i_j), (b_p, i_p)):
        np.testing.assert_array_equal(np.asarray(ii), np.full(8, 100))
        np.testing.assert_allclose(np.asarray(bb), b.numpy(), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("P,T,sms", [
    (10_000, 9_216, 132),        # the d6 oracle
    (10_000, 100_800, 132),      # the d7 oracle
    (1 << 20, 9_216, 132),       # the builders' sweep: point tiles fill the card
    (1 << 18, 9_216, 132),
    (257, 1_000, 132),
    (1, 7, 132),                 # fewer triangles than one tile
    (3_000, 64 * 5 + 1, 8),
    (40_000, 9_216, 16),
])
def test_split_fills_the_card_and_covers_the_triangles(P, T, sms):
    tiles_p, S = nearest._split(P, T, sms)
    n = -(-T // nearest.TRI_TILE)
    assert tiles_p * nearest.POINT_TILE >= P > (tiles_p - 1) * nearest.POINT_TILE
    assert 1 <= S <= max(n, 1)
    if tiles_p >= nearest.CTAS_PER_SM * sms:
        assert S == 1
    # at least 2 CTAs an SM, unless every tile already has a CTA of its own
    assert tiles_p * S >= min(2 * sms, tiles_p * n)
    # the kernel's slices: runs of whole tiles, none empty, covering T
    bounds = [(s * n // S, (s + 1) * n // S) for s in range(S)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(t0 < t1 for t0, t1 in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert min(n * nearest.TRI_TILE, T) == T


def test_wrapper_rejects_bad_input():
    _, _, fields = _tris(make_torus(R=0.3, r=0.1, nu=7, nv=5))
    with pytest.raises(ValueError):
        nearest.nearest_triangle(torch.zeros(4, 2), fields)
    with pytest.raises(ValueError):
        nearest.nearest_triangle(torch.zeros(4, 3), fields[:, :9])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [7, 1_000, 9_216])
@pytest.mark.parametrize("n", [1, 257, 10_000, 1 << 18])
def test_kernel_matches_plain(cuda, n, T):
    """The first T triangles of the bench torus: squared distances equal,
    indices equal but on last-ulp ties (2^18 x 9,216 takes the Morton
    order, the rest the given one)."""
    _, tris, fields = _tris(make_torus(R=0.3, r=0.12, nu=96, nv=48), cuda)
    tris = type(tris)(*(f[:T] for f in tris))
    fields = fields[:T]
    pts = torch.as_tensor(
        np.random.default_rng(7).uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        device=cuda,
    )
    before = nearest.launch_count
    b, i = nearest.nearest_triangle(pts, fields)
    torch.cuda.synchronize()
    assert nearest.launch_count == before + 1
    assert nearest.last_grid == nearest._split(
        n, T, torch.cuda.get_device_properties(cuda).multi_processor_count)
    b_p, i_p = nearest.nearest_triangle_plain(pts, fields)
    assert torch.equal(b, b_p)
    _assert_same_nearest(
        pts, tris, b.cpu().numpy(), i.cpu().numpy(), b_p.cpu().numpy(), i_p.cpu().numpy()
    )


@pytest.mark.cuda
@pytest.mark.parametrize("morton_pairs", [0, 1 << 62])
def test_kernel_exact_tie_across_slices(cuda, morton_pairs, monkeypatch):
    """The bench torus with triangle 100 repeated at index 9,216: the two
    copies lie in different triangle slices of the kernel's grid, and
    the tie goes to index 100, with the points in Morton order
    (``MORTON_PAIRS`` 0) and as given."""
    monkeypatch.setattr(nearest, "MORTON_PAIRS", morton_pairs)
    mesh, pts = _dup_mesh(96, 48, 100)
    _, _, fields = _tris(mesh, cuda)
    pts = torch.as_tensor(pts, device=cuda)
    b, i = nearest.nearest_triangle(pts, fields)
    torch.cuda.synchronize()
    tiles_p, S = nearest.last_grid
    n = -(-fields.shape[0] // nearest.TRI_TILE)
    slice_of = [next(s for s in range(S) if (s + 1) * n // S > t // nearest.TRI_TILE)
                for t in (100, 9_216)]
    assert slice_of[0] != slice_of[1]
    b_p, i_p = nearest.nearest_triangle_plain(pts, fields)
    assert torch.equal(b, b_p)
    assert i.tolist() == [100] * 8 == i_p.tolist()


@pytest.mark.cuda
def test_morton_order_is_a_local_permutation(cuda):
    """The kernel's point order: a permutation of the points in which
    neighbours lie far closer together than in the caller's order."""
    pts = torch.as_tensor(
        np.random.default_rng(3).uniform(-0.6, 0.6, (4096, 3)).astype(np.float32),
        device=cuda,
    )
    order = nearest.morton_order(pts)
    assert torch.equal(order.sort().values, torch.arange(4096, device=cuda))
    step = (pts[order][1:] - pts[order][:-1]).norm(dim=1).mean()
    assert float(step) < 0.25 * float((pts[1:] - pts[:-1]).norm(dim=1).mean())


def _interleave(cells):
    """Morton codes by the definition: bit b of axis k at bit 3b + k."""
    code = np.zeros(cells.shape[0], np.int64)
    for b in range(10):
        for k in range(3):
            code |= ((cells[:, k] >> b) & 1) << (3 * b + k)
    return code


def test_morton_codes_plain_interleave_the_cells():
    """The plain codes: each axis on 1024 cells of the box (the box's
    corners, a NaN and points outside clamp into the grid), its bits
    interleaved x lowest; and the order they give is a local permutation."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.6, 0.6, (4096, 3)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    pts[:3] = [lo, hi, [np.nan, 2.0, -2.0]]
    t = torch.as_tensor
    codes = nearest.morton_codes_plain(t(pts), t(lo), t(hi))
    assert codes.dtype == torch.int32
    scaled = (pts - lo) / (hi - lo) * np.float32(1023.0)
    cells = np.clip(np.nan_to_num(scaled, nan=0.0), 0, 1023).astype(np.int64)
    np.testing.assert_array_equal(codes.numpy(), _interleave(cells))
    assert codes[0] == 0 and codes[1] == (1 << 30) - 1
    order = nearest.morton_order(t(pts[3:]))
    q = t(pts[3:])
    assert torch.equal(order.sort().values, torch.arange(q.shape[0]))
    step = (q[order][1:] - q[order][:-1]).norm(dim=1).mean()
    assert float(step) < 0.25 * float((q[1:] - q[:-1]).norm(dim=1).mean())


def test_morton_order_plain_is_a_stable_sort_of_the_codes():
    """The plain order: a permutation that sorts the codes over the points'
    own box, equal codes in index order (many points share a cell)."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.6, 0.6, (3000, 3)).astype(np.float32)
    pts[1000:2000] = pts[rng.integers(0, 1000, 1000)]        # repeated cells
    t = torch.as_tensor(pts)
    order = nearest.morton_order_plain(t)
    assert order.dtype == torch.int64
    assert torch.equal(order.sort().values, torch.arange(3000))
    codes = nearest.morton_codes_plain(t, *(torch.as_tensor(v) for v in (pts.min(0), pts.max(0))))
    key = codes[order].long() * 3000 + order       # ascending code, then ascending id
    assert bool((key[1:] > key[:-1]).all())
    assert torch.equal(order, torch.as_tensor(np.argsort(codes.numpy(), kind="stable")))


def test_morton_order_plain_nan_and_flat_axes_go_to_cell_zero():
    """aminmax keeps a NaN: a NaN coordinate makes its axis's box NaN and
    sends every point of that axis to cell 0, as a flat axis (0 / 0)
    does; the order then sorts by the other axes alone."""
    rng = np.random.default_rng(12)
    pts = rng.uniform(-0.6, 0.6, (500, 3)).astype(np.float32)
    pts[:, 2] = 0.25                                  # flat z
    pts[7, 1] = np.nan                                # y's box NaN
    t = torch.as_tensor(pts)
    lo, hi = torch.aminmax(t, dim=0)
    assert bool(lo[1].isnan()) and bool(hi[1].isnan())
    codes = nearest.morton_codes_plain(t, lo, hi)
    cells_x = np.clip((pts[:, 0] - pts[:, 0].min()) / np.float32(pts[:, 0].max() - pts[:, 0].min())
                      * np.float32(1023.0), 0, 1023).astype(np.int64)
    np.testing.assert_array_equal(codes.numpy(), _interleave(
        np.stack([cells_x, np.zeros_like(cells_x), np.zeros_like(cells_x)], 1)))
    order = nearest.morton_order_plain(t)
    assert torch.equal(order, torch.as_tensor(np.argsort(cells_x, kind="stable")))


@pytest.mark.parametrize("n", [0, 1, 2])
def test_morton_order_of_few_points(n):
    """0 points: an empty order (aminmax has no identity); 1 point: a flat
    box, cell 0; 2 points: the corners of their own box, in code order."""
    pts = torch.as_tensor(np.array([[0.5, 0.5, 0.5], [-0.5, -0.5, -0.5]], np.float32)[:n])
    order = nearest.morton_order(pts)
    assert order.dtype == torch.int64 and order.shape == (n,)
    assert order.tolist() == {0: [], 1: [0], 2: [1, 0]}[n]


def test_cpu_points_take_the_plain_order_and_launch_nothing(monkeypatch):
    from sdflib_tpu_torch.kernels import build

    def no_build():
        raise AssertionError("a CPU call built the kernels")

    monkeypatch.setattr(build, "library", no_build)
    monkeypatch.setattr(nearest, "morton_launch_count", 0)
    monkeypatch.setattr(nearest, "launch_count", 0)
    monkeypatch.setattr(nearest, "MORTON_PAIRS", 0)
    pts = torch.as_tensor(np.random.default_rng(13).uniform(-0.6, 0.6, (700, 3))
                          .astype(np.float32))
    assert torch.equal(nearest.morton_order(pts), nearest.morton_order_plain(pts))
    _, _, fields = _tris(make_torus(R=0.3, r=0.1, nu=7, nv=5))
    nearest.nearest_triangle(pts, fields)
    assert nearest.morton_launch_count == nearest.launch_count == 0
    with pytest.raises(ValueError):
        nearest.morton_order(pts.double())
    with pytest.raises(ValueError):
        nearest.morton_order(pts[:, :2].contiguous())


@pytest.mark.parametrize("order_name", ["given", "morton", "reversed", "random"])
def test_results_do_not_depend_on_the_point_order(jx, order_name):
    """K2's results are each point's own: the points taken in any order
    and put back give the same bits, within the JAX package's
    ``nearest_triangle`` as the unpermuted batch is."""
    soa, tris, fields = _tris(make_torus(R=0.3, r=0.12, nu=20, nv=12))
    pts = np.random.default_rng(14).uniform(-0.5, 0.5, (400, 3)).astype(np.float32)
    tp = torch.as_tensor(pts)
    order = {"given": torch.arange(400), "morton": nearest.morton_order_plain(tp),
             "reversed": torch.arange(399, -1, -1),
             "random": torch.as_tensor(np.random.default_rng(15).permutation(400))}[order_name]
    b0, i0 = nearest.nearest_triangle(tp, fields)
    bo, io = nearest.nearest_triangle(tp[order].contiguous(), fields)
    b, i = torch.empty_like(bo), torch.empty_like(io)
    b[order], i[order] = bo, io
    assert torch.equal(b, b0) and torch.equal(i, i0)
    b_j, i_j = jx.nearest(pts, jx.jax.tree.map(jx.jnp.asarray, soa))
    _assert_same_nearest(tp, tris, b, i, b_j, i_j)


def _order_points(n: int, device, seed: int = 4):
    """``n`` uniform points with a NaN coordinate and a flat axis among
    them (beyond 4 points)."""
    pts = np.random.default_rng(seed).uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    if n > 4:
        pts[n // 2, 0] = np.nan
        pts[:, 2] = -0.125
    return torch.as_tensor(pts, device=device)


@pytest.mark.cuda
def test_kernel_morton_codes_match_plain(cuda):
    """Above the one-launch size the box and code kernels (two launches)
    and the stable sort give the plain order bit for bit, also where many
    points share a code."""
    n = nearest.morton_order_max(cuda) + 1
    pts = _order_points(n, cuda, seed=5)
    pts[: n // 2] = pts[n // 2 :][: n // 2].clone()
    before = nearest.morton_launch_count
    order = nearest.morton_order(pts)
    torch.cuda.synchronize()
    assert nearest.morton_launch_count == before + 2
    assert torch.equal(order, nearest.morton_order_plain(pts))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 1023, 1024, 1025, 10_000, "max-1", "max", "max+1",
                                  262_144])
def test_kernel_morton_order_matches_plain(cuda, size):
    """The order on the card equals the plain order bit for bit, with a NaN
    and a flat axis among the points: one launch up to the cutoff, the box
    and code kernels above it."""
    cut = nearest.morton_order_max(cuda)
    assert 10_000 <= cut <= 65_535
    n = size if isinstance(size, int) else cut + {"max-1": -1, "max": 0, "max+1": 1}[size]
    pts = _order_points(n, cuda)
    before = nearest.morton_launch_count
    order = nearest.morton_order(pts)
    torch.cuda.synchronize()
    assert nearest.morton_launch_count == before + (1 if n <= cut else 2)
    assert torch.equal(order, nearest.morton_order_plain(pts))
