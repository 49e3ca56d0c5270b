"""The port's tiled structures on a list of eight CPU entries against the
JAX package's on its eight virtual CPU devices: the cases of
tests/test_parallel_tiles.py on its torus (``make_torus(R=0.3, r=0.12,
nu=24, nv=12)``, box margin 0.14, ``max_depth=4, start_depth=2,
min_triangles_per_node=16``), and what only the port has:

* ``TiledExactOctreeSdf`` within ``rtol 1e-6, atol 1e-7`` of the port's
  replicated ``ExactOctreeSdf`` (the JAX test's tolerance) and of JAX's
  tiled structure, points up to 0.1 outside the box included;
  gradients too;
* each shard on its entry's device with fewer bucket rows than the
  replicated structure; the same query twice bit-identical; the save /
  load round trip bit-identical;
* one start cell a shard (start depth 1 on eight entries) against the
  brute-force oracle;
* ``TiledOctreeSdf`` against the replicated octree's grid route
  (distances ``rtol 1e-6, atol 1e-7``, gradients ``1e-5``), its
  per-entry bytes and its round trip;
* a container of each tiled kind saved by the JAX package loads into the
  port on eight entries and answers within the tolerance of JAX's
  answers and of the port's replicated structure;
* ``_build_exact(seed_cells=...)``: a shard's leaves are the global
  build's leaves of those cells, list for list;
* both tiled classes on ``[cpu, cpu:0] * 4``: every entry's shard answers
  on its device's worker thread (two threads, neither the caller), the
  distances and gradients bit-equal to the same structure on ``[cpu] *
  8`` and within the tolerances above of JAX's tiled structure.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from sdflib_tpu.parallel.tiles import TiledExactOctreeSdf as JTiledExact
from sdflib_tpu.parallel.tiles import TiledOctreeSdf as JTiledOctree
from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
from sdflib_tpu.utils.primitives import make_torus as j_torus
from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf, SdfFunction
from sdflib_tpu_torch.parallel.tiles import TiledExactOctreeSdf, TiledOctreeSdf
from sdflib_tpu_torch.sdf.exact_octree import _build_exact
from sdflib_tpu_torch.sdf.octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK
from sdflib_tpu_torch.sdf.sdf_function import SdfFormat
from sdflib_tpu_torch.triangle import calculate_mesh_triangle_data, soa_to_torch
from sdflib_tpu_torch.utils.primitives import make_torus

CPU8 = [torch.device("cpu")] * 8
MIXED8 = [torch.device("cpu"), torch.device("cpu", 0)] * 4
KW = dict(max_depth=4, start_depth=2, min_triangles_per_node=16)
TOL = dict(rtol=1e-6, atol=1e-7)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _points(box, n, seed, out=0.1):
    lo, hi = np.asarray(box.min) - out, np.asarray(box.max) + out
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    mesh = make_torus(R=0.3, r=0.12, nu=24, nv=12)
    box = mesh.bounding_box.add_margin(0.14)
    rep = ExactOctreeSdf(mesh, box, **KW, device="cpu")
    tiled = TiledExactOctreeSdf(mesh, box, **KW, device_mesh=CPU8)
    return mesh, box, rep, tiled


@pytest.fixture(scope="module")
def jax_tiled():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    mesh = j_torus(R=0.3, r=0.12, nu=24, nv=12)
    return JTiledExact(mesh, mesh.bounding_box.add_margin(0.14), **KW)


def test_tiled_matches_replicated(setup, jax_tiled):
    _, _, rep, tiled = setup
    pts = _points(rep.box, 8192, 0)          # includes out-of-box points
    d_til = _np(tiled.get_distance(pts))
    np.testing.assert_allclose(d_til, _np(rep.get_distance(pts)), **TOL)
    np.testing.assert_allclose(d_til, np.asarray(jax_tiled.get_distance(pts)), **TOL)


def test_tiled_structure_is_sharded(setup):
    _, _, rep, tiled = setup
    assert len(tiled.shards) == 8 == len(tiled.per_chip_bucket_bytes())
    rep_rows = int(rep.bucket_ids.shape[0])
    for sh, dev in zip(tiled.shards, tiled.device_mesh):
        assert int(sh.bucket_ids.shape[0]) < rep_rows
        assert sh.bucket_tier == "vertex9" and sh.device == dev
        assert sh.bucket_fields.device == dev and sh._octree_dev.device == dev
    assert max(tiled.per_chip_bucket_bytes()) < rep.bucket_bytes


def test_tiled_shard_determinism(setup):
    """Same query twice -> bit-identical (the routing is arithmetic)."""
    _, _, _, tiled = setup
    pts = np.random.default_rng(3).uniform(-0.4, 0.4, (2048, 3)).astype(np.float32)
    assert torch.equal(tiled.get_distance(pts), tiled.get_distance(pts))


def test_tiled_gradient_matches_replicated(setup, jax_tiled):
    _, _, rep, tiled = setup
    pts = _points(rep.box, 4096, 7)
    d_r, g_r = rep.get_distance_and_gradient(pts)
    d_t, g_t = tiled.get_distance_and_gradient(pts)
    np.testing.assert_allclose(_np(d_t), _np(d_r), **TOL)
    err = np.linalg.norm(_np(g_r) - _np(g_t), axis=-1)
    assert (err > 1e-4).mean() < 1e-3
    d_j, g_j = jax_tiled.get_distance_and_gradient(pts)
    np.testing.assert_allclose(_np(d_t), np.asarray(d_j), **TOL)
    assert (np.linalg.norm(np.asarray(g_j) - _np(g_t), axis=-1) > 1e-4).mean() < 1e-3
    d_t2, g_t2 = tiled.get_distance_and_gradient(pts)
    assert torch.equal(d_t, d_t2) and torch.equal(g_t, g_t2)


def test_tiled_save_load_roundtrip(setup, tmp_path):
    _, _, _, tiled = setup
    assert tiled.get_format() == SdfFormat.EXACT_OCTREE_TILED
    path = str(tmp_path / "tiled.npz")
    tiled.save(path)
    loaded = SdfFunction.load(path, device="cpu", device_mesh=CPU8)
    assert type(loaded).__name__ == "TiledExactOctreeSdf"
    pts = np.random.default_rng(9).uniform(-0.4, 0.4, (2048, 3)).astype(np.float32)
    assert torch.equal(tiled.get_distance(pts), loaded.get_distance(pts))
    with pytest.raises(ValueError, match="8 shards"):
        SdfFunction.load(path, device="cpu", device_mesh=CPU8[:4])


def test_tiled_single_cell_shards_exact():
    """start_depth=1 on eight entries puts ONE start cell in each shard:
    the shard's start block is one word padded to eight, so child octets
    stay aligned (the JAX package's regression case)."""
    mesh = make_torus(R=0.3, r=0.12, nu=24, nv=12)
    box = mesh.bounding_box.add_margin(0.14)
    tiled = TiledExactOctreeSdf(mesh, box, max_depth=3, start_depth=1,
                                min_triangles_per_node=8, device_mesh=CPU8)
    pts = np.random.default_rng(13).uniform(np.asarray(box.min), np.asarray(box.max),
                                            (2048, 3)).astype(np.float32)
    oracle = _np(RealSdf(mesh, device="cpu").get_distance(pts))
    np.testing.assert_allclose(_np(tiled.get_distance(pts)), oracle, rtol=1e-6, atol=2e-5)


def test_tiled_octree_matches_replicated(tmp_path):
    mesh = make_torus(R=0.3, r=0.12, nu=24, nv=12)
    rep = OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), max_depth=4, start_depth=1,
                    termination_threshold=1e-3, device="cpu")
    rep.build_query_grid()
    tiled = TiledOctreeSdf(_octree=rep, device_mesh=CPU8)
    pts = _points(rep.box, 8192, 11)
    np.testing.assert_allclose(_np(tiled.get_distance(pts)), _np(rep.get_distance(pts)), **TOL)
    d_r, g_r = rep.get_distance_and_gradient(pts)
    d_t, g_t = tiled.get_distance_and_gradient(pts)
    np.testing.assert_allclose(_np(d_t), _np(d_r), **TOL)
    np.testing.assert_allclose(_np(g_t), _np(g_r), rtol=1e-5, atol=1e-5)
    nbytes = tiled.per_chip_grid_bytes()
    assert len(nbytes) == 8 and sum(nbytes) == rep._fat_grid.numel() * 4
    assert tiled.get_format() == SdfFormat.OCTREE_TILED
    path = str(tmp_path / "tiled_oct.npz")
    tiled.save(path)
    loaded = SdfFunction.load(path, device="cpu", device_mesh=CPU8)
    assert torch.equal(tiled.get_distance(pts), loaded.get_distance(pts))


@pytest.mark.parametrize("kind", ["exact", "octree"])
def test_jax_saved_tiled_container_loads(setup, jax_tiled, tmp_path, kind):
    """A JAX-saved tiled container on eight entries: within the tolerance
    of JAX's answers and of the port's replicated structure."""
    _, _, rep, _ = setup
    if kind == "exact":
        jt = jax_tiled
    else:
        jm = j_torus(R=0.3, r=0.12, nu=24, nv=12)
        jo = JOctree(jm, jm.bounding_box.add_margin(0.14), max_depth=4, start_depth=1,
                     termination_threshold=1e-3)
        jo.build_query_grid()
        jt = JTiledOctree(_octree=jo)
        rep = OctreeSdf.from_jax_state(jo._state_arrays(), device="cpu")
        rep.build_query_grid()
    path = str(tmp_path / f"jax_{kind}.npz")
    jt.save(path)
    loaded = SdfFunction.load(path, device="cpu", device_mesh=CPU8)
    assert type(loaded).__name__ == type(jt).__name__
    pts = _points(rep.box, 8192, 17)
    d = _np(loaded.get_distance(pts))
    np.testing.assert_allclose(d, np.asarray(jt.get_distance(pts)), **TOL)
    np.testing.assert_allclose(d, _np(rep.get_distance(pts)), **TOL)


def _leaves(octree, start_word, start_cell, start_depth, leaf_offset, leaf_count, tri_flat):
    """(depth, cell coordinates, triangle list) of every leaf under one
    start word, in a fixed walk order."""
    out, stack = [], [(start_word, start_cell, start_depth)]
    while stack:
        w, cell, depth = stack.pop()
        word = int(octree[w])
        if word & int(IS_LEAF_MASK):
            lid = word & int(CHILDREN_INDEX_MASK)
            off, cnt = int(leaf_offset[lid]), int(leaf_count[lid])
            out.append((depth, cell, tuple(tri_flat[off : off + cnt].tolist())))
            continue
        base = word & int(CHILDREN_INDEX_MASK)
        for c in range(8):
            child = tuple(2 * x + ((c >> i) & 1) for i, x in enumerate(cell))
            stack.append((base + c, child, depth + 1))
    return out


def test_build_exact_seed_cells_reproduce_global_leaves(setup):
    """Start cells [12, 28) of the depth-2 grid built alone: every cell's
    leaves (depth, position, list) are the global build's."""
    mesh, box, _, _ = setup
    cbox = box.cubified()
    tris = soa_to_torch(calculate_mesh_triangle_data(mesh), torch.device("cpu"))
    args = (tris, cbox.min, float(cbox.size[0]), 4, 2, 16)
    glob = _build_exact(*args, strategy="lattice")
    lo, hi = 12, 28
    shard = _build_exact(*args, strategy="lattice", seed_cells=(lo, hi))
    assert shard[0].shape[0] % 8 == 0
    for cell in range(lo, hi):
        xyz = (cell % 4, (cell // 4) % 4, cell // 16)
        want = _leaves(glob[0], cell, xyz, 2, glob[1], glob[2], glob[3].numpy())
        got = _leaves(shard[0], cell - lo, xyz, 2, shard[1], shard[2], shard[3].numpy())
        assert got == want and want


def test_tiled_classes_need_a_card_by_default(setup):
    """Without a device list both tiled classes take every card, so
    without one they raise."""
    mesh, box, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TiledExactOctreeSdf(mesh, box, **KW)
    oct_ = OctreeSdf(mesh, box, max_depth=3, start_depth=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TiledOctreeSdf(_octree=oct_)


@pytest.mark.parametrize("kind", ["exact", "octree"])
def test_tiled_queries_run_on_the_workers(setup, jax_tiled, monkeypatch, kind):
    """A tiled structure on ``[cpu, cpu:0] * 4`` answers on two worker
    threads, one a device, bit-equal to the same structure on ``[cpu] *
    8``, within TOL of JAX's tiled structure (the exact kind) or of the
    replicated grid route (the octree kind, as above)."""
    from sdflib_tpu_torch.parallel import tiles

    mesh, box, rep, tiled = setup
    if kind == "exact":
        mixed = TiledExactOctreeSdf(mesh, box, **KW, device_mesh=MIXED8)
        ref = tiled
    else:
        rep = OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), max_depth=4,
                        start_depth=1, termination_threshold=1e-3, device="cpu")
        rep.build_query_grid()
        mixed = TiledOctreeSdf(_octree=rep, device_mesh=MIXED8)
        ref = TiledOctreeSdf(_octree=rep, device_mesh=CPU8)
    seen = []
    real = tiles.run_blocks

    def spy(blocks, fn):
        def rec(dev, block):
            seen.append((dev, threading.get_ident()))
            return fn(dev, block)
        return real(blocks, rec)

    monkeypatch.setattr(tiles, "run_blocks", spy)
    pts = _points(rep.box, 4096, 19)
    d, (d_g, g) = mixed.get_distance(pts), mixed.get_distance_and_gradient(pts)
    assert len(seen) == 16
    ids = {dev: {t for v, t in seen if v == dev} for dev in MIXED8}
    assert all(len(t) == 1 for t in ids.values())
    assert len(set.union(*ids.values())) == 2 and threading.get_ident() not in set.union(*ids.values())
    d_r, g_r = ref.get_distance_and_gradient(pts)
    assert torch.equal(d, ref.get_distance(pts)) and torch.equal(d_g, d_r) and torch.equal(g, g_r)
    if kind == "exact":
        np.testing.assert_allclose(_np(d), np.asarray(jax_tiled.get_distance(pts)), **TOL)
    else:
        np.testing.assert_allclose(_np(d), _np(rep.get_distance(pts)), **TOL)
