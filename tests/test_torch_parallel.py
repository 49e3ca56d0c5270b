"""The port's ``parallel`` on a list of eight CPU entries against the JAX
package's on its eight virtual CPU devices: the cases of
tests/test_parallel.py, on its icosphere (subdivisions 2, radius 0.35,
box margin 0.14, ``max_depth=4, start_depth=1``). The port's structures
are the JAX-built ones (``from_jax_state``), so both packages query the
same words.

* Sharded queries, traces and gradients equal the port's single-device
  calls bit for bit; the queries are within 1e-6 of JAX's sharded
  results; the traces' hit masks agree with JAX's on >= 99.8% of rays
  and depths of common hits within 1e-3 (tests/test_torch_render.py's
  tolerances; the JAX march is another schedule).
* The fit step's loss and new coefficients within 1e-6 relative of
  JAX's (max norm), the loss falling, the coefficients replicated.
* Total sharded throughput on eight entries of one CPU at least 0.35 of
  one entry's, as test_parallel.py asks of its shared-core mesh.
* The device-list conventions: the default list is every card (raising
  without one), entries may repeat, and ``initialize_distributed`` only
  acts when the environment names a world.
"""
import time

import jax
import numpy as np
import pytest
import torch

from sdflib_tpu import parallel as jpar
from sdflib_tpu.diff.query import octree_coefficients as j_coefficients
from sdflib_tpu.render.sphere_trace import trace_octree as j_trace
from sdflib_tpu.sdf import RealSdf as JReal
from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf as JExact
from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere
from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf, parallel
from sdflib_tpu_torch.diff.query import octree_coefficients
from sdflib_tpu_torch.render.sphere_trace import trace_octree
from sdflib_tpu_torch.utils.primitives import make_icosphere

CPU8 = [torch.device("cpu")] * 8
# eight entries in eight runs of one device each ("cpu" and "cpu:0" are
# distinct torch devices): every shard is its own call
MIXED8 = [torch.device("cpu"), torch.device("cpu", 0)] * 4
LISTS = pytest.mark.parametrize("devs", [CPU8, MIXED8], ids=["cpu8", "mixed8"])


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jpar.default_mesh()


@pytest.fixture(scope="module")
def sphere():
    return make_icosphere(subdivisions=2, radius=0.35)


@pytest.fixture(scope="module")
def octrees():
    jm = j_icosphere(subdivisions=2, radius=0.35)
    j = JOctree(jm, jm.bounding_box.add_margin(0.14), max_depth=4, start_depth=1,
                termination_threshold=1e-3)
    return j, OctreeSdf.from_jax_state(j._state_arrays(), device="cpu")


@pytest.fixture(scope="module")
def exacts():
    jm = j_icosphere(subdivisions=2, radius=0.35)
    j = JExact(jm, jm.bounding_box.add_margin(0.14), max_depth=4, start_depth=1,
               min_triangles_per_node=32)
    return j, ExactOctreeSdf.from_jax_state(j._state_arrays(), device="cpu")


@LISTS
def test_sharded_distance_matches_single_device(octrees, jmesh8, devs):
    j, p = octrees
    pts = np.random.default_rng(0).uniform(-0.4, 0.4, (1001, 3)).astype(np.float32)  # not %8
    d = parallel.sharded_distance(p, pts, devs)
    assert torch.equal(d, p.get_distance(pts))
    np.testing.assert_allclose(_np(d), np.asarray(jpar.sharded_distance(j, pts, jmesh8)),
                               rtol=0, atol=1e-6)


def test_sharded_gradient_matches(octrees, jmesh8):
    j, p = octrees
    pts = np.random.default_rng(1).uniform(-0.3, 0.3, (256, 3)).astype(np.float32)
    d0, g0 = p.get_distance_and_gradient(pts)
    d1, g1 = parallel.sharded_distance_and_gradient(p, pts, CPU8)
    assert torch.equal(d0, d1) and torch.equal(g0, g1)
    dj, gj = jpar.sharded_distance_and_gradient(j, pts, jmesh8)
    np.testing.assert_allclose(_np(d1), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(g1), np.asarray(gj), rtol=0, atol=1e-5)


def test_sharded_exact_octree(exacts, jmesh8):
    j, p = exacts
    pts = np.random.default_rng(2).uniform(-0.4, 0.4, (512, 3)).astype(np.float32)
    d = parallel.sharded_distance(p, pts, CPU8)
    assert torch.equal(d, p.get_distance(pts))
    np.testing.assert_allclose(_np(d), np.asarray(jpar.sharded_distance(j, pts, jmesh8)),
                               rtol=0, atol=1e-6)


def test_sharded_real_sdf(sphere, jmesh8):
    real = RealSdf(sphere, device="cpu")
    pts = np.random.default_rng(3).uniform(-0.4, 0.4, (300, 3)).astype(np.float32)
    d = parallel.sharded_distance(real, pts, CPU8)
    assert torch.equal(d, real.get_distance(pts))
    jreal = JReal(j_icosphere(subdivisions=2, radius=0.35))
    np.testing.assert_allclose(_np(d), np.asarray(jpar.sharded_distance(jreal, pts, jmesh8)),
                               rtol=0, atol=1e-6)


@LISTS
def test_sharded_trace_matches(octrees, jmesh8, devs):
    j, p = octrees
    rng = np.random.default_rng(4)
    n = 203
    origins = np.tile([[0.0, 0.0, -1.2]], (n, 1)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 2.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    r0 = trace_octree(p, origins, dirs, max_iters=128, beam=None)
    r1 = parallel.sharded_trace(p, origins, dirs, devs, max_iters=128)
    for a, b in zip(r0, r1):
        assert torch.equal(a, b)
    rj = jpar.sharded_trace(j, origins, dirs, jmesh8, max_iters=128)
    hj, hp = np.asarray(rj.hit), _np(r1.hit)
    assert (hj == hp).mean() >= 0.998 and hp.any()
    both = hj & hp
    assert np.abs(np.asarray(rj.depth)[both] - _np(r1.depth)[both]).max() <= 1e-3
    # the JAX single-device trace's hits, as tests/test_parallel.py holds it
    assert (np.asarray(j_trace(j, origins, dirs, max_iters=128, beam=None).hit) == hp).mean() >= 0.998


@LISTS
def test_data_parallel_fit_step_reduces_loss(octrees, jmesh8, devs):
    j, p = octrees
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.35, 0.35, (2045, 3)).astype(np.float32)   # padded to 2048
    targets = (np.linalg.norm(pts, axis=-1) - 0.35).astype(np.float32)

    c0 = octree_coefficients(p.octree_data)
    loss0, c1 = parallel.data_parallel_fit_step(p, c0, pts, targets, devs, lr=1e-2)
    loss1, _ = parallel.data_parallel_fit_step(p, c1, pts, targets, devs, lr=1e-2)
    assert np.isfinite(float(loss0)) and float(loss1) <= float(loss0)
    # one replica per entry, one tensor per distinct device
    assert len(c1) == 8 and all(c is c1[i % 2] for i, c in enumerate(c1))

    # on one entry (no padding) the step is fit_step's, the single-device
    # step: the same loss; coefficients within 1e-6 of the largest (the
    # backward's scatter-add accumulates in no fixed order)
    l_one, c_one = parallel.fit_step(
        p._octree_dev, c0, pts, targets, torch.ones(len(pts)), p.box.min,
        p.box.size[0], p.min_border_value, 1e-2, start_grid_size=p.start_grid_size,
        levels=p.max_depth - p.start_depth, fast=p._fast_layout)
    l_dp, c_dp = parallel.data_parallel_fit_step(p, c0, pts, targets, CPU8[:1], lr=1e-2)
    assert torch.equal(l_one, l_dp)
    assert float((c_one - c_dp[0]).abs().max()) <= 1e-6 * float(c_one.abs().max())

    jc0 = j_coefficients(j.octree_data)
    jl0, jc1 = jpar.data_parallel_fit_step(j, jc0, pts, targets, jmesh8, lr=1e-2)
    assert abs(float(loss0) - float(jl0)) <= 1e-6 * abs(float(jl0))
    jc1 = np.asarray(jc1)
    scale = np.abs(jc1).max()
    assert np.abs(_np(c1[0]) - jc1).max() <= 1e-6 * scale


def test_scaling_throughput_bounds():
    """Total sharded throughput of eight CPU entries against one: the
    shards share one CPU, so the bound is on the total, as
    tests/test_parallel.py's on its shared-core mesh."""
    mesh_geo = make_icosphere(subdivisions=1, radius=0.35)
    oct_ = OctreeSdf(mesh_geo, mesh_geo.bounding_box.add_margin(0.12), max_depth=4,
                     start_depth=1, termination_threshold=1e-3, device="cpu")
    oct_.build_query_grid()
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(oct_.box.min + 1e-4, oct_.box.max - 1e-4,
                                      (1 << 18, 3)).astype(np.float32))
    nr = 1 << 15
    u = rng.uniform(-0.5, 0.5, (nr, 2)).astype(np.float32)
    origins = np.concatenate([u, np.full((nr, 1), -1.2, np.float32)], -1)
    dirs = np.tile([[0.0, 0.0, 1.0]], (nr, 1)).astype(np.float32)

    def best(fn):
        fn()
        t = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            t = min(t, time.perf_counter() - t0)
        return t

    q = {c: best(lambda: parallel.sharded_distance(oct_, pts, CPU8[:c])) for c in (1, 8)}
    r = {c: best(lambda: parallel.sharded_trace(oct_, origins, dirs, CPU8[:c], max_iters=256))
         for c in (1, 8)}
    assert q[1] / q[8] >= 0.35, f"sharded query total collapsed to {q[1] / q[8]:.2%}"
    assert r[1] / r[8] >= 0.35, f"sharded ray total collapsed to {r[1] / r[8]:.2%}"


def test_sharded_exact_query_id_only_structure():
    """Id-only structures (bucket tables over the byte budget) scan the
    CSR through the triangle table; the replicas carry both."""
    mesh_geo = make_icosphere(subdivisions=1, radius=0.35)
    ex = ExactOctreeSdf(mesh_geo, mesh_geo.bounding_box.add_margin(0.12), max_depth=3,
                        start_depth=1, min_triangles_per_node=16, bucket_byte_budget=0,
                        device="cpu")
    assert ex.bucket_tier == "id_only" and ex.bucket_fields is None
    pts = np.random.default_rng(2).uniform(ex.box.min + 1e-4, ex.box.max - 1e-4,
                                           (1 << 12, 3)).astype(np.float32)
    assert torch.equal(parallel.sharded_distance(ex, pts, CPU8), ex.get_distance(pts))


def test_device_list_conventions(octrees, monkeypatch):
    """Without a card the default list and every entry point that takes
    it raise; a CUDA entry raises too; ``initialize_distributed`` does
    nothing without a world in the environment, calls
    ``init_process_group`` with its arguments where the environment names
    one, and lets an error of that call through (the call is recorded,
    not made: it would open sockets).
    The caller's structure is never changed by a sharded query."""
    _, p = octrees
    pts = np.zeros((4, 3), np.float32)
    if not torch.cuda.is_available():
        for call in (
            lambda: parallel.default_mesh(),
            lambda: parallel.sharded_distance(p, pts),
            lambda: parallel.sharded_trace(p, pts, pts + 1),
            lambda: parallel.data_parallel_fit_step(p, octree_coefficients(p.octree_data),
                                                    pts, pts[:, 0]),
            lambda: parallel.default_mesh(["cpu", "cuda:0"]),
        ):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    assert parallel.default_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert parallel.pad_to_shards(1000, CPU8) == 1000 and parallel.pad_to_shards(1001, CPU8) == 1008
    blocks = parallel.sharded_rays(MIXED8).put(torch.arange(16.0))
    assert len(blocks) == 8 and blocks[1][0] == MIXED8[1] and blocks[1][1].tolist() == [2.0, 3.0]
    (block,) = parallel.sharded_rays(CPU8).put(torch.arange(16.0))
    assert block[1].tolist() == list(range(16))
    copies = parallel.replicated(CPU8).put(torch.ones(3))
    assert all(c is copies[0] for c in copies)

    stats = dict(p.__dict__)
    parallel.sharded_distance(p, np.random.default_rng(0).uniform(-0.3, 0.3, (64, 3)), CPU8)
    assert p.__dict__.keys() == stats.keys()
    assert all(p.__dict__[k] is v for k, v in stats.items())

    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    parallel.initialize_distributed(backend="gloo")
    monkeypatch.setenv("WORLD_SIZE", "1")
    parallel.initialize_distributed(backend="gloo")
    assert calls == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    parallel.initialize_distributed(backend="gloo", rank=0, world_size=2)
    assert calls == [dict(backend="gloo", rank=0, world_size=2)]

    def fail(**kw):
        raise RuntimeError("rendezvous failed")

    monkeypatch.setattr(dist, "init_process_group", fail)
    with pytest.raises(RuntimeError, match="rendezvous failed"):
        parallel.initialize_distributed(backend="gloo")
