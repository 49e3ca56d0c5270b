"""K7-K9 (``ops/exact_query.py``): the exact query's descent key, sorted
gather and signed finish with its unsort, on the torus fixture of
test_torch_exact_octree.py (nu=20, nv=12, max_depth 4, start_depth 1,
16 triangles per node), built by the port and loaded into the JAX
package from its ``.npz`` container, so both hold the same leaves.

* ``exact_descend_plain`` gives the leaves of the JAX package's
  ``_exact_descent_grid``, equal, for points in, on the faces of and
  outside the box.
* ``exact_finish_plain`` agrees with JAX's ``_exact_finish`` on the same
  sorted points and winners (-1 winners, points outside the box, on a
  vertex of their winner and beside its edges) within rtol 1e-5 / atol
  1e-6, in the caller's order (the unsort); and again on points built to
  fall in one region of their winner, each of the seven in turn; without
  an order the finish leaves its values in sorted order. Gradients agree
  within the same tolerance, except at a point on the winner's rim at
  distance 0 with sign 0, where the port gives the face normal ``tn`` and
  JAX 0 (ROADMAP Queue 3), and at a point within rounding noise of an
  edge (|d| < 1e-6, not 0), where both directions are noise: there the
  port's gradient has unit norm.
* The int32-keyed stable sort gives the int64 one's order;
  ``exact_sorted_gather_plain`` equals the gathers it replaces in both
  modes; ``get_distance`` and ``get_distance_and_gradient`` through the
  new call sites agree with JAX's under each scan pinned.
* The structure's packed leaf bounds (K9's table) equal ``leaf_row0`` and
  ``leaf_nchunks`` after a build, after ``from_jax_state`` and after a
  new scan chunk.
* The wrappers reject wrong dtypes and shapes, a field-major or sliced
  finish table, and launch nothing for CPU tensors.
* On a CUDA device (skipped here): each kernel against its plain version
  (distances bit-equal, gradients within 1e-6, integers equal), K7 on a
  random batch and on one whose every warp mixes the seven regions, K9 at
  0, 1, 31, 33 and 1,000 points, padded or not, in both modes, through
  the public wrappers and the query's lean launches; the query with
  K7-K9 and the leaf sort bit-equal to the query with their plain
  versions, the sort launched once a query and K8 not at all, and a
  refused launch raises.

JAX is imported inside fixtures and tests: the GPU machine has no JAX and
runs only the cuda-marked cases (``pytest --noconftest -m cuda``).
"""
import numpy as np
import pytest
import torch

from sdflib_tpu_torch import ExactOctreeSdf
from sdflib_tpu_torch.kernels import build
from sdflib_tpu_torch.ops import exact_query as eq
from sdflib_tpu_torch.ops.point_triangle import _project, gather_triangles, region_code
from sdflib_tpu_torch.ops.scan import WINDOW
from sdflib_tpu_torch.utils.primitives import make_torus

torch.set_num_threads(1)
CFG = dict(max_depth=4, start_depth=1, min_triangles_per_node=16)
TOL = dict(rtol=1e-5, atol=1e-6)


def _mesh_box(make):
    mesh = make(R=0.3, r=0.12, nu=20, nv=12)
    return mesh, mesh.bounding_box.add_margin(0.1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(the JAX package's structure, the port's), one structure: the
    port's build on the CPU, loaded into the JAX package from its
    container (a JAX build of it takes several times longer)."""
    from sdflib_tpu.sdf.sdf_function import SdfFunction as JSdfFunction

    p = ExactOctreeSdf(*_mesh_box(make_torus), **CFG, device="cpu")
    path = str(tmp_path_factory.mktemp("exact_query") / "torus.npz")
    p.save(path)
    return JSdfFunction.load(path), p


def _points(box, n: int = 1500, seed: int = 11) -> np.ndarray:
    """Points in the box, on its cells' faces (depth 4) and outside it."""
    rng = np.random.default_rng(seed)
    lo, size = np.asarray(box.min, np.float32), np.float32(box.size[0])
    inside = rng.uniform(0.0, 1.0, (n, 3))
    on_faces = np.round(rng.uniform(0.0, 1.0, (n // 4, 3)) * 16) / 16
    outside = rng.uniform(-0.6, 1.6, (n // 4, 3))
    rel = np.concatenate([inside, on_faces, outside]).astype(np.float32)
    return lo + rel * size


def _box_args(sdf):
    return sdf._box_min, sdf._box_size3


def test_descend_plain_matches_jax(pair):
    import jax.numpy as jnp
    from sdflib_tpu.sdf.exact_octree import _exact_descent_grid

    j, p = pair
    pts = _points(p.box)
    want, _ = _exact_descent_grid(j._leaf_grid, jnp.asarray(pts), jnp.asarray(j.box.min),
                                  jnp.float32(j.box.size[0]), grid_depth=j.max_depth)
    got = eq.exact_descend_plain(torch.as_tensor(pts), p._leaf_grid, *_box_args(p), p.max_depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the structure's descent keeps its int64 contract on the same leaves
    np.testing.assert_array_equal(p._descend(torch.as_tensor(pts)).numpy(), np.asarray(want))


def _finish_inputs(p, seed: int = 5):
    """Sorted points and winners for the finish: random winners (some -1),
    points inside and outside the box, exactly on vertex v1 of their winner
    (d = 0, sign 0), near the midpoints of its edges (rounding noise
    from the edge) and 1e-3 beyond its edge v1-v2 in its plane; and a
    random order."""
    rng = np.random.default_rng(seed)
    T = p.triangles.origin.shape[0]
    vw = p.triangles.v_world.numpy()
    pts = _points(p.box, 600, seed)
    n = pts.shape[0]
    win = rng.integers(-1, T, n).astype(np.int32)
    win[::17] = -1
    w = np.maximum(win, 0)
    k = np.arange(n)
    on_v1 = k % 7 == 1
    pts[on_v1] = vw[w[on_v1], 0]
    mid = k % 7 == 2
    pts[mid] = (vw[w[mid], 0] + vw[w[mid], 1]) * np.float32(0.5)
    beside = k % 7 == 3
    e1 = vw[w[beside], 1] - vw[w[beside], 0]
    nrm = np.cross(e1, vw[w[beside], 2] - vw[w[beside], 0])
    out = np.cross(e1, nrm)       # in the plane, away from v3
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    pts[beside] = (vw[w[beside], 0] + 0.5 * e1 + 1e-3 * out).astype(np.float32)
    order = rng.permutation(n)
    return pts.astype(np.float32), win, order


@pytest.mark.parametrize("with_gradient", [False, True])
def test_finish_plain_matches_jax(pair, with_gradient):
    import jax
    import jax.numpy as jnp
    from sdflib_tpu.sdf.exact_octree import _exact_finish

    j, p = pair
    pts, win, order = _finish_inputs(p)
    box_min, size = jnp.asarray(j.box.min), jnp.float32(j.box.size[0])
    rel = (jnp.asarray(pts) - box_min) / size
    in_box = jnp.all((rel >= 0.0) & (rel < 1.0), axis=-1)
    assert 0 < int(in_box.sum()) < pts.shape[0]
    tris = jax.tree.map(jnp.asarray, j.triangles)
    ref = _exact_finish(tris, jnp.asarray(pts), jnp.asarray(win), in_box, box_min, size,
                        with_gradient=with_gradient)
    got = eq.exact_finish_plain(torch.as_tensor(pts), torch.as_tensor(win),
                                torch.as_tensor(order), p._finish_table, *_box_args(p),
                                p._fallback, with_gradient=with_gradient)
    # sorted point i lands at order[i]: read the outputs back in sorted order
    if not with_gradient:
        np.testing.assert_allclose(got.numpy()[order], np.asarray(ref), **TOL)
        return
    d_ref, g_ref = (np.asarray(a) for a in ref)
    d, g = got[0].numpy()[order], got[1].numpy()[order]
    np.testing.assert_allclose(d, d_ref, **TOL)
    ib = np.asarray(in_box)
    rim = ib & (d_ref == 0.0) & (d == 0.0) & (np.abs(g_ref).max(axis=1) == 0.0)
    noise = ib & ~rim & (np.abs(d_ref) < 1e-6)
    assert rim.sum() >= 50              # the v1 points
    tn = p._finish_table.numpy()[np.maximum(win, 0), 9:12]
    np.testing.assert_array_equal(g[rim], tn[rim])
    np.testing.assert_allclose(np.linalg.norm(g[noise], axis=1), 1.0, rtol=0, atol=1e-5)
    rest = ~rim & ~noise
    np.testing.assert_allclose(g[rest], g_ref[rest], **TOL)


def _region_inputs(sdf, codes, seed: int = 3):
    """Points built to fall in region ``codes[i]`` of their winner (0-2
    its vertices, 3-5 its edges v1v2, v2v3, v3v1, 6 its face), a random
    triangle each: in the plane, just outside the vertex between its two
    edges' outward normals, or outside an edge's midpoint, or at the
    centroid; then, in turn, 3 times that offset above the plane, in the
    plane, 3 times below it, in the plane (the face's points 1 times
    above and below instead). In the plane the sign is that of the
    feature's pseudonormal, tilted from the face's by about half the
    coarse torus's dihedral angle, so a wrong normal shows; where that
    tilt is too small to give a sign (a quad's diagonal edge: two right
    answers), the point goes 3 times its offset above the plane instead.
    Returns (points, winners), checked against the port's region code."""
    rng = np.random.default_rng(seed)
    n = len(codes)
    vw = sdf.triangles.v_world.cpu().numpy().astype(np.float64)
    win = rng.integers(0, vw.shape[0], n).astype(np.int32)
    v = vw[win]
    unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)
    nrm = unit(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))

    def out(k):    # the in-plane outward normal of edge v_k v_{k+1}
        a, b, c = v[:, k], v[:, (k + 1) % 3], v[:, (k + 2) % 3]
        o = np.cross(b - a, nrm)
        return unit(o * -np.sign(((c - a) * o).sum(1, keepdims=True)))

    delta = 0.05 * np.linalg.norm(v[:, 1] - v[:, 0], axis=1, keepdims=True)
    codes = np.asarray(codes)[:, None]
    pts = v.mean(1)
    for k in range(3):
        pts = np.where(codes == k, v[:, k] + delta * unit(out(k) + out((k - 1) % 3)), pts)
        pts = np.where(codes == 3 + k,
                       0.5 * (v[:, k] + v[:, (k + 1) % 3]) + delta * out(k), pts)
    side = np.array([3.0, 0.0, -3.0, 0.0])[np.arange(n) % 4][:, None]
    face = np.where(np.arange(n) % 8 < 4, 1.0, -1.0)[:, None]
    side = np.where((codes == 6) & (side == 0.0), face, side)
    # the pseudonormal dot of the in-plane points, in float64 in the
    # winner's frame (signed_dist_from_rows's (a, b, z) of each code)
    tr = {name: a.cpu().numpy().astype(np.float64)[win]
          for name, a in sdf.triangles._asdict().items()}
    pp = np.einsum("nij,nj->ni", tr["transform"], pts - tr["origin"])
    shift = np.where(np.isin(codes, (1, 4)), tr["v2x"][:, None],
                     np.where(codes == 2, tr["v3xy"][:, :1], 0.0))
    ab = np.stack([pp[:, 0] - shift[:, 0],
                   pp[:, 1] - np.where(codes[:, 0] == 2, tr["v3xy"][:, 1], 0.0)], 1)
    feat = np.where(codes[:, :, None] <= 2, tr["vertices_normal"][:, :3],
                    tr["edges_normal"][:, :3])[np.arange(n), codes[:, 0] % 3]
    dot = (feat[:, :2] * ab).sum(1) + feat[:, 2] * pp[:, 2]
    tie = (side[:, 0] == 0.0) & (codes[:, 0] < 6) & (np.abs(dot) < 0.02 * delta[:, 0])
    side[tie] = 3.0
    pts = (pts + side * delta * nrm).astype(np.float32)
    tri = gather_triangles(sdf.triangles, torch.as_tensor(win, device=sdf.device).long())
    got, _ = region_code(_project(torch.as_tensor(pts, device=sdf.device), tri), tri)
    np.testing.assert_array_equal(got.cpu().numpy(), codes[:, 0])
    return pts, win


@pytest.mark.parametrize("with_gradient", [False, True])
@pytest.mark.parametrize("code", range(7))
def test_finish_plain_each_region_matches_jax(pair, code, with_gradient):
    import jax
    import jax.numpy as jnp
    from sdflib_tpu.sdf.exact_octree import _exact_finish

    j, p = pair
    pts, win = _region_inputs(p, np.full(96, code), seed=code)
    order = np.random.default_rng(code).permutation(len(pts))
    box_min, size = jnp.asarray(j.box.min), jnp.float32(j.box.size[0])
    rel = (jnp.asarray(pts) - box_min) / size
    in_box = jnp.all((rel >= 0.0) & (rel < 1.0), axis=-1)
    assert bool(in_box.all())
    tris = jax.tree.map(jnp.asarray, j.triangles)
    ref = _exact_finish(tris, jnp.asarray(pts), jnp.asarray(win), in_box, box_min, size,
                        with_gradient=with_gradient)
    got = eq.exact_finish_plain(torch.as_tensor(pts), torch.as_tensor(win),
                                torch.as_tensor(order), p._finish_table, *_box_args(p),
                                p._fallback, with_gradient=with_gradient)
    if not with_gradient:
        np.testing.assert_allclose(got.numpy()[order], np.asarray(ref), **TOL)
        return
    np.testing.assert_allclose(got[0].numpy()[order], np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy()[order], np.asarray(ref[1]), **TOL)


@pytest.mark.parametrize("with_gradient", [False, True])
def test_finish_unsort_writes_at_the_order(pair, with_gradient):
    """The unsort: point i's values land at ``order[i]``, so the outputs
    read at the order are those of the identity order (JAX's
    ``_exact_finish`` leaves them in sorted order)."""
    _, p = pair
    pts, win, order = _finish_inputs(p)
    args = (torch.as_tensor(pts), torch.as_tensor(win))
    rest = (p._finish_table, *_box_args(p), p._fallback)
    sorted_ = eq.exact_finish(*args, torch.arange(len(pts)), *rest,
                              with_gradient=with_gradient)
    got = eq.exact_finish(*args, torch.as_tensor(order), *rest, with_gradient=with_gradient)
    for a, b in zip(*((sorted_, got) if with_gradient else ((sorted_,), (got,)))):
        assert torch.equal(a, b[torch.as_tensor(order)])


def test_int32_sort_matches_int64(pair):
    _, p = pair
    keys = p._leaf_keys(torch.as_tensor(_points(p.box, 4000)))
    v32, o32 = torch.sort(keys, stable=True)
    v64, o64 = torch.sort(keys.long(), stable=True)
    assert torch.equal(o32, o64) and torch.equal(v32.long(), v64)


def test_sorted_gather_plain_equals_the_gathers(pair):
    _, p = pair
    pts = torch.as_tensor(_points(p.box, 1000))
    lid_s, order = torch.sort(p._leaf_keys(pts), stable=True)
    P = pts.shape[0]
    size = P + (-P) % WINDOW
    pad = size - P
    pts_s, b0, nc = eq.exact_sorted_gather_plain(pts, order, lid_s, p.leaf_row0,
                                                 p.leaf_nchunks, size=size)
    zi = torch.zeros(pad, dtype=torch.int32)
    assert torch.equal(pts_s, torch.cat([pts[order], pts.new_zeros((pad, 3))]))
    assert torch.equal(b0, torch.cat([p.leaf_row0[lid_s.long()], zi]))
    assert torch.equal(nc, torch.cat([p.leaf_nchunks[lid_s.long()], zi]))
    g_s, gb, gn = eq.exact_sorted_gather_plain(pts, order)
    assert torch.equal(g_s, pts[order]) and gb is None and gn is None
    # the structure's own paths: the windows padded, the groups' keys int32
    w_s, w_b0, w_nc, w_order = p._sorted_windows(pts)
    assert torch.equal(w_s, pts_s) and torch.equal(w_b0, b0) and torch.equal(w_order, order)
    g_s2, g_lid, _, _, _ = p._sorted_groups(pts)
    assert torch.equal(g_s2, pts[order]) and g_lid.dtype == torch.int32


@pytest.mark.parametrize("made_by", ["build", "from_jax_state", "scan_chunk"])
def test_leaf_bounds_packed(pair, made_by):
    j, p = pair
    if made_by == "from_jax_state":
        p = ExactOctreeSdf.from_jax_state(j._state_arrays(), device="cpu")
    elif made_by == "scan_chunk":
        p = ExactOctreeSdf.from_jax_state(p._state_arrays(), device="cpu")
        p.set_scan_chunk(32)
    bounds = p._leaf_bounds
    assert bounds.dtype == torch.int32 and bounds.is_contiguous()
    assert torch.equal(bounds, torch.stack([p.leaf_row0, p.leaf_nchunks], dim=1))
    assert torch.equal(eq.leaf_bounds(p.leaf_row0, p.leaf_nchunks), bounds)


@pytest.fixture(scope="module")
def jax_ref(pair):
    """JAX's distances and gradients on the query points (its own scan):
    test_torch_exact_octree.py's 768 points (seed 1) and 256 outside the
    box. A point equidistant from two triangles (on the torus's symmetry
    planes, or near its axis) has two right gradients, and two scans may
    break the tie differently: the cells' faces hold such points (the
    distances still agree), so they serve the descent test only."""
    j, p = pair
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-0.5, 0.5, (768, 3)),
                          rng.uniform(-1.5, 1.5, (256, 3))]).astype(np.float32)
    d, (dg, g) = j.get_distance(pts), j.get_distance_and_gradient(pts)
    return pts, np.asarray(d), np.asarray(dg), np.asarray(g)


@pytest.mark.parametrize("impl", ["xla", "xla_window"])
def test_query_matches_jax_each_scan(pair, jax_ref, impl):
    _, p = pair
    pts, d_ref, dg_ref, g_ref = jax_ref
    p.set_scan_impl(impl)
    try:
        d = p.get_distance(pts)
        want = {"xla": "grouped", "xla_window": "window"}[impl]
        assert p.last_scan_stats["scan"] == want
        dg, g = p.get_distance_and_gradient(pts)
    finally:
        p._default_scan_impl()
    np.testing.assert_allclose(d.numpy(), d_ref, **TOL)
    np.testing.assert_allclose(dg.numpy(), dg_ref, **TOL)
    np.testing.assert_allclose(g.numpy(), g_ref, **TOL)
    # the plain yardsticks answer the same on the CPU
    assert torch.equal(p._query(pts, False, plain=True), d)
    assert torch.equal(p._query(pts, False, plain_glue=True), d)


def _reset():
    eq.descend_launch_count = eq.gather_launch_count = eq.finish_launch_count = 0
    eq.sort_launch_count = 0


def test_cpu_tensors_launch_nothing(pair, monkeypatch):
    def no_build():
        raise AssertionError("a CPU call built the kernels")

    _, p = pair
    monkeypatch.setattr(build, "library", no_build)
    _reset()
    pts = _points(p.box, 700)
    for impl in ("xla", "xla_window"):
        p.set_scan_impl(impl)
        p.get_distance(pts)
        p.get_distance_and_gradient(pts)
    p._default_scan_impl()
    assert eq.descend_launch_count == eq.gather_launch_count == eq.finish_launch_count == 0
    assert eq.sort_launch_count == 0


def test_wrappers_reject_bad_inputs(pair):
    _, p = pair
    pts = torch.as_tensor(_points(p.box, 40))
    grid, depth = p._leaf_grid, p.max_depth
    bm, bs = _box_args(p)
    for bad in (pts.double(), pts[:, :2], "points"):
        with pytest.raises(ValueError):
            eq.exact_descend(bad, grid, bm, bs, depth)
    with pytest.raises(ValueError):                    # the grid of another depth
        eq.exact_descend(pts, grid, bm, bs, depth + 1)
    with pytest.raises(ValueError):
        eq.exact_descend(pts, grid.long(), bm, bs, depth)
    with pytest.raises(ValueError):                    # an unsupported device
        eq.exact_descend(pts.to("meta"), grid.to("meta"), bm.to("meta"), bs.to("meta"), depth)
    lid_s, order = torch.sort(p._leaf_keys(pts), stable=True)
    rows = (lid_s, p.leaf_row0, p.leaf_nchunks)
    for args, kw in (((pts, order.int(), *rows), {}), ((pts, order[:-1], *rows), {}),
                     ((pts, order, lid_s.long(), *rows[1:]), {}),
                     ((pts, order, lid_s, p.leaf_row0, p.leaf_nchunks[:-1]), {}),
                     ((pts, order, *rows), {"size": 10})):
        with pytest.raises(ValueError):
            eq.exact_sorted_gather(*args, **kw)
    win = torch.zeros(40, dtype=torch.int32)
    table = p._finish_table
    fb = p._fallback
    for args in ((pts, win.long(), order, table, bm, bs), (pts, win[:-1], order, table, bm, bs),
                 (pts, win, order.int(), table, bm, bs), (pts, win, order, table[:, :37], bm, bs),
                 (pts, win, order, table.double(), bm, bs), (pts, win, order, table, bm[:2], bs),
                 (pts, win, order, table.t().contiguous().t(), bm, bs),
                 (pts, win, order, torch.cat([table, table], 1)[:, :48], bm, bs),
                 (pts, win, order, table[::2], bm, bs)):
        with pytest.raises(ValueError):
            eq.exact_finish(*args, fb)


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_sdf():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return ExactOctreeSdf(*_mesh_box(make_torus), **CFG, device="cuda")


def _cuda_batch(sdf, n: int = 40_000):
    pts = torch.as_tensor(_points(sdf.box, n, 31), device="cuda")
    lid_s, order = torch.sort(eq.exact_descend(pts, sdf._leaf_grid, *_box_args(sdf),
                                               sdf.max_depth), stable=True)
    return pts, lid_s, order


@pytest.mark.cuda
def test_k8_k9_against_plain(cuda_sdf):
    sdf = cuda_sdf
    pts, lid_s, order = _cuda_batch(sdf)
    args = (pts, sdf._leaf_grid, *_box_args(sdf), sdf.max_depth)
    assert torch.equal(eq.exact_descend(*args), eq.exact_descend_plain(*args))
    P = pts.shape[0]
    for size in (P, P + (-P) % WINDOW + WINDOW):
        got = eq.exact_sorted_gather(pts, order, lid_s, sdf.leaf_row0, sdf.leaf_nchunks,
                                     size=size)
        want = eq.exact_sorted_gather_plain(pts, order, lid_s, sdf.leaf_row0,
                                            sdf.leaf_nchunks, size=size)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(eq.exact_sorted_gather(pts, order)[0],
                       eq.exact_sorted_gather_plain(pts, order)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["window", "grouped"])
@pytest.mark.parametrize("P", [0, 1, 31, 33, 1000])
def test_k9_sizes_against_plain(cuda_sdf, P, mode):
    """K9 at small and ragged sizes, unpadded and padded, through the
    public wrapper and the lean launch, bit-equal to the plain version."""
    sdf = cuda_sdf
    pts = torch.as_tensor(_points(sdf.box, 1000, 37)[:P], device="cuda")
    lid_s, order = torch.sort(eq.exact_descend(pts, sdf._leaf_grid, *_box_args(sdf),
                                               sdf.max_depth), stable=True)
    rows = (lid_s, sdf.leaf_row0, sdf.leaf_nchunks) if mode == "window" else ()
    for size in (P, P + 77, P + (-P) % WINDOW + WINDOW):
        want = eq.exact_sorted_gather_plain(pts, order, *rows, size=size)
        for got in (eq.exact_sorted_gather(pts, order, *rows, size=size),
                    eq.launch_sorted_gather(pts, order, lid_s if rows else None,
                                            sdf._leaf_bounds if rows else None, size)):
            assert all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(got, want))


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("with_gradient", [False, True])
@pytest.mark.parametrize("batch", ["random", "regions"])
def test_k7_against_plain(cuda_sdf, with_gradient, batch):
    """K7 bit-equal to its plain version in distance (gradients within
    1e-6), public and lean, at a random order and at the identity: random
    winners and points, or points built in a chosen region of their
    winner, the seven regions taken in turn so that every warp mixes them
    all."""
    sdf = cuda_sdf
    if batch == "random":
        pts, lid_s, order = _cuda_batch(sdf)
        pts_s = pts[order]
        T = sdf._finish_table.shape[0]
        win = torch.randint(-1, T, (pts.shape[0],), dtype=torch.int32, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
    else:
        pts, win = _region_inputs(sdf, np.arange(7 * 32 * 8) % 7, seed=9)
        pts_s, win = torch.as_tensor(pts, device="cuda"), torch.as_tensor(win, device="cuda")
        order = torch.randperm(pts_s.shape[0], device="cuda",
                               generator=torch.Generator("cuda").manual_seed(1))
    rest = (sdf._finish_table, *_box_args(sdf), sdf._fallback)
    for o in (order, torch.arange(pts_s.shape[0], device="cuda")):
        want = eq.exact_finish_plain(pts_s, win, o, *rest, with_gradient=with_gradient)
        outs = (eq.exact_finish(pts_s, win, o, *rest, with_gradient=with_gradient),
                eq.launch_exact_finish(pts_s, win, o, pts_s.shape[0], sdf._finish_table,
                                       sdf._box_host, sdf._fallback, with_gradient))
        for got in outs:
            if not with_gradient:
                assert _bits_equal(got, want)
                continue
            assert _bits_equal(got[0], want[0])
            assert float((got[1] - want[1]).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["xla", "xla_window"])
def test_query_kernels_equal_plain_glue(cuda_sdf, impl):
    sdf = cuda_sdf
    pts = torch.as_tensor(_points(sdf.box, 20_000, 41), device="cuda")
    sdf.set_scan_impl(impl)
    try:
        # the plain versions first: a batch size's first grouped query
        # descends the origin once more to pick its group width
        d_p = sdf._query(pts, False, plain_glue=True)
        dg_p, g_p = sdf._query(pts, True, plain_glue=True)
        _reset()
        d = sdf.get_distance(pts)
        dg, g = sdf.get_distance_and_gradient(pts)
        counts = (eq.descend_launch_count, eq.sort_launch_count, eq.gather_launch_count,
                  eq.finish_launch_count)
    finally:
        sdf._default_scan_impl()
    # the key is the leaf sort's: no K8 launch of its own
    assert counts == (0, 2, 2, 2)
    assert torch.equal(d, d_p) and torch.equal(dg, dg_p)
    assert float((g - g_p).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_a_refused_launch_raises(cuda_sdf):
    sdf = cuda_sdf
    pts = torch.zeros((64, 3), device="cuda")
    key = torch.empty(64, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="failed to launch"):
        build.launch("sdf_exact_descend", pts.device, pts.data_ptr(), 64,
                     sdf._leaf_grid.data_ptr(), 11, sdf._box_min.data_ptr(),
                     sdf._box_size3.data_ptr(), key.data_ptr())
    order = torch.arange(64, device="cuda")
    for P, size in ((64, 32), (-1, 0)):                             # size < P, P < 0
        with pytest.raises(RuntimeError, match="failed to launch"):
            build.launch("sdf_exact_sorted_gather", pts.device, pts.data_ptr(),
                         order.data_ptr(), P, None, None, size, pts.data_ptr(), None, None)
    d = torch.empty(64, device="cuda")
    with pytest.raises(RuntimeError, match="failed to launch"):      # P < 0
        build.launch("sdf_exact_finish", pts.device, pts.data_ptr(), key.data_ptr(),
                     order.data_ptr(), -1, sdf._finish_table.data_ptr(), *sdf._box_host, 1.0,
                     d.data_ptr(), None)
