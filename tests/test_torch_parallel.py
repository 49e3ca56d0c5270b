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
* The workers (``mesh.run_blocks``): on ``[cpu, cpu:0] * 4`` two worker
  threads, neither the caller, one per device, results in entry order,
  one issuing at a time, their waits overlapping;
  every sharded call goes through them, bit-equal to the single-device
  call and within the JAX tolerances above; a block's error raises from
  the call after the other worker finishes, and the next call works.
  Eight threads at once: one kernel-library build (the build mocked),
  one frame never shared by two threads, no lost launch count.
"""
import importlib
import sys
import threading
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


# -- the workers -----------------------------------------------------------------


def test_run_blocks_one_worker_per_device():
    """Two devices, eight blocks: two worker threads, neither the caller's,
    the blocks of a device on its one thread, results in entry order; a
    list naming one device is one block, one call; one worker issues at
    a time, and the two devices' waits (``waiting``) overlap."""
    seen = []

    def fn(dev, block):
        seen.append((dev, threading.get_ident()))
        return block.clone()

    x = torch.arange(16.0)
    out = parallel.mesh.run_blocks(parallel.sharded_rays(MIXED8).put(x), fn)
    assert torch.equal(torch.cat(out), x)
    threads = {dev: {t for d, t in seen if d == dev} for dev, _ in seen}
    assert len(seen) == 8 and all(len(t) == 1 for t in threads.values())
    ids = {t for ts in threads.values() for t in ts}
    assert len(ids) == 2 and threading.get_ident() not in ids
    seen.clear()
    (one,) = parallel.mesh.run_blocks(parallel.sharded_rays(CPU8).put(x), fn)
    assert torch.equal(one, x) and len(seen) == 1
    # one worker at a time holds the turn; a worker that waits gives it
    # up, so the two devices' waits overlap: each waits for the other
    busy, peak, lock = [0], [0], threading.Lock()

    def turn(dev, block):
        with lock:
            busy[0] += 1
            peak[0] = max(peak[0], busy[0])
        time.sleep(0.01)
        with lock:
            busy[0] -= 1
        with parallel.mesh.waiting():
            return meet.wait() is not None

    meet = threading.Barrier(2, timeout=30)
    out = parallel.mesh.run_blocks(parallel.sharded_rays(MIXED8).put(x), turn)
    assert out == [True] * 8 and peak[0] == 1


def test_run_blocks_refuses_a_call_from_a_block():
    """A block that calls ``run_blocks`` raises (two workers would wait on
    each other), the error reaches the caller, and the next call works."""
    x = torch.arange(8.0)
    blocks = parallel.sharded_rays(MIXED8[:2]).put(x)

    def outer(dev, block):
        return parallel.mesh.run_blocks(blocks, lambda d, b: b)

    with pytest.raises(RuntimeError, match="inside a block"):
        parallel.mesh.run_blocks(blocks, outer)
    out = parallel.mesh.run_blocks(blocks, lambda d, b: b + 1)
    assert torch.equal(torch.cat(out), x + 1)


def test_run_blocks_raises_a_block_error(octrees, monkeypatch):
    """A block that raises: the call raises it once the other worker has
    run all its blocks (the failing worker stops there), returns nothing,
    retries nothing; the next call works. The same through a sharded
    query whose replica on one device fails."""
    seen = []

    def fn(dev, block):
        seen.append(int(block[0]))
        if int(block[0]) == 6:                      # entry 3, on cpu:0
            raise ValueError("block 3 failed")
        return block * 2

    x = torch.arange(16.0)
    with pytest.raises(ValueError, match="block 3 failed"):
        parallel.mesh.run_blocks(parallel.sharded_rays(MIXED8).put(x), fn)
    assert sorted(seen) == [0, 2, 4, 6, 8, 12]
    out = parallel.mesh.run_blocks(parallel.sharded_rays(MIXED8).put(x), lambda d, b: b * 2)
    assert torch.equal(torch.cat(out), x * 2)

    _, p = octrees
    pts = np.random.default_rng(9).uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    real = OctreeSdf.get_distance
    calls = []

    def failing(self, points):
        calls.append(self.device)
        if self.device == torch.device("cpu", 0):
            raise RuntimeError("replica failed")
        return real(self, points)

    with monkeypatch.context() as m:
        m.setattr(OctreeSdf, "get_distance", failing)
        with pytest.raises(RuntimeError, match="replica failed"):
            parallel.sharded_distance(p, pts, MIXED8)
    assert len(calls) == 8 - 3      # cpu:0 stopped at its first block
    assert torch.equal(parallel.sharded_distance(p, pts, MIXED8), p.get_distance(pts))


def _spy(monkeypatch, module_name):
    """Wrap the ``run_blocks`` a parallel module calls: each call's block
    count and the (device, thread) of each block."""
    module = importlib.import_module(module_name)
    real, calls = module.run_blocks, []

    def spy(blocks, fn):
        seen = []
        calls.append((len(blocks), seen))

        def rec(dev, block):
            seen.append((dev, threading.get_ident()))
            return fn(dev, block)

        return real(blocks, rec)

    monkeypatch.setattr(module, "run_blocks", spy)
    return calls


@pytest.mark.parametrize("what", ["distance", "gradient", "exact", "real", "trace", "fit"])
def test_sharded_calls_run_on_the_workers(octrees, exacts, sphere, jmesh8, monkeypatch, what):
    """Every sharded call on ``[cpu, cpu:0] * 4`` runs its eight blocks on
    two worker threads, bit-equal to the single-device call and within
    the tolerances above of the JAX package's on eight devices."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.35, 0.35, (1003, 3)).astype(np.float32)
    module = {"trace": "render", "fit": "fit"}.get(what, "query")
    calls = _spy(monkeypatch, f"sdflib_tpu_torch.parallel.{module}")
    j, p = exacts if what == "exact" else octrees
    if what in ("distance", "exact"):
        d = parallel.sharded_distance(p, pts, MIXED8)
        assert torch.equal(d, p.get_distance(pts))
        np.testing.assert_allclose(_np(d), np.asarray(jpar.sharded_distance(j, pts, jmesh8)),
                                   rtol=0, atol=1e-6)
    elif what == "real":
        real = RealSdf(sphere, device="cpu")
        d = parallel.sharded_distance(real, pts, MIXED8)
        assert torch.equal(d, real.get_distance(pts))
        jreal = JReal(j_icosphere(subdivisions=2, radius=0.35))
        np.testing.assert_allclose(_np(d), np.asarray(jpar.sharded_distance(jreal, pts, jmesh8)),
                                   rtol=0, atol=1e-6)
    elif what == "gradient":
        d, g = parallel.sharded_distance_and_gradient(p, pts, MIXED8)
        d0, g0 = p.get_distance_and_gradient(pts)
        assert torch.equal(d, d0) and torch.equal(g, g0)
        dj, gj = jpar.sharded_distance_and_gradient(j, pts, jmesh8)
        np.testing.assert_allclose(_np(d), np.asarray(dj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(g), np.asarray(gj), rtol=0, atol=1e-5)
    elif what == "trace":
        n = 211
        origins = np.tile([[0.0, 0.0, -1.2]], (n, 1)).astype(np.float32)
        dirs = rng.normal(size=(n, 3)).astype(np.float32)
        dirs[:, 2] = np.abs(dirs[:, 2]) + 2.0
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        r1 = parallel.sharded_trace(p, origins, dirs, MIXED8, max_iters=128)
        for a, b in zip(trace_octree(p, origins, dirs, max_iters=128, beam=None), r1):
            assert torch.equal(a, b)
        rj = jpar.sharded_trace(j, origins, dirs, jmesh8, max_iters=128)
        hj, hp = np.asarray(rj.hit), _np(r1.hit)
        assert (hj == hp).mean() >= 0.998 and hp.any()
        both = hj & hp
        assert np.abs(np.asarray(rj.depth)[both] - _np(r1.depth)[both]).max() <= 1e-3
    else:
        pts = pts[:1000]
        targets = (np.linalg.norm(pts, axis=-1) - 0.35).astype(np.float32)
        c0 = octree_coefficients(p.octree_data)
        loss, c1 = parallel.data_parallel_fit_step(p, c0, pts, targets, MIXED8, lr=1e-2)
        # the reference: the same blocks run one after another in the caller
        monkeypatch.setattr(parallel.fit, "run_blocks",
                            lambda blocks, fn: [fn(d, b) for d, b in blocks])
        l_ser, c_ser = parallel.data_parallel_fit_step(p, c0, pts, targets, MIXED8, lr=1e-2)
        assert torch.equal(loss, l_ser) and torch.equal(c1[0], c_ser[0])
        jl, jc = jpar.data_parallel_fit_step(j, j_coefficients(j.octree_data), pts, targets,
                                             jmesh8, lr=1e-2)
        assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
        jc = np.asarray(jc)
        assert np.abs(_np(c1[0]) - jc).max() <= 1e-6 * np.abs(jc).max()
    n_blocks, seen = calls[0]
    assert n_blocks == 8 and len(seen) == 8
    ids = {t for _, t in seen}
    assert len(ids) == 2 and threading.get_ident() not in ids


def _together(n, fn):
    """``fn(i)`` on ``n`` threads released at once, with a short switch
    interval; every thread joined within 60 s; their results."""
    barrier = threading.Barrier(n)
    out = [None] * n

    def run(i):
        barrier.wait()
        out[i] = fn(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return out


def test_first_calls_from_eight_threads(monkeypatch):
    """Eight threads at once: the kernel library is built once and every
    thread gets the one library (the build mocked: no nvcc here); the
    frame cache never hands one frame to two threads and keeps at most
    ``_MAX_FRAMES`` idle frames a device; launch counts lose no update."""
    from sdflib_tpu_torch.kernels import build
    from sdflib_tpu_torch.ops import scan

    builds, lib = [], object()

    def compile_():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return build._BUILD / "mock.so"

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_so", None)
    monkeypatch.setattr(build, "_compile", compile_)
    monkeypatch.setattr(build, "_load", lambda so: lib)
    assert all(x is lib for x in _together(8, lambda i: build.library()))
    assert len(builds) == 1

    st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
    cache, made, busy, lock = st._FrameCache(), [], set(), threading.Lock()
    dev = torch.device("cpu")

    def make():
        frame = object()
        made.append(frame)
        return frame

    def use(i):
        for r in range(20):
            key = ("frame", (i + r) % 3)
            frame = cache.take(dev, key, make)
            with lock:
                assert id(frame) not in busy
                busy.add(id(frame))
            time.sleep(1e-4)
            with lock:
                busy.discard(id(frame))
            cache.put(dev, key, frame)
        return True

    assert all(_together(8, use))
    assert 3 <= len(made) <= 8 * 20
    assert sum(map(len, cache.frames[dev].values())) <= st._MAX_FRAMES
    kept = [f for idle in cache.frames[dev].values() for f in idle]
    assert len({id(f) for f in kept}) == len(kept)

    monkeypatch.setattr(scan, "launch_count", 0)
    _together(8, lambda i: [build.count_launch(vars(scan), "launch_count")
                            for _ in range(2000)])
    assert scan.launch_count == 8 * 2000
