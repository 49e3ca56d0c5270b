"""The port's whole-frame trace (``render/sphere_trace.py`` ``_Frame``:
the beam prepass, the static march pyramid, the straggler march, the
unsort and the normals; on the card replayed as captured CUDA graphs)
against the JAX package's ``_trace_rays_fused``, on the icosphere of
tests/test_render.py (subdivisions 3, radius 0.35, box margin 0.14,
``max_depth=5``), the port querying the JAX-built structure through
``from_jax_state``.

* ``_build_pyramid_schedule`` equals JAX's over a grid of ray counts,
  trip budgets, blocks and both divisor sets.
* ``sphere_trace_state(fixed_trips=True)`` equals JAX's in trip count
  and within 1e-6 (absolute, or relative on the misses' distant
  positions) in state on a batch that converges early, and equals the
  early-exiting march bit for bit.
* Frames of 192^2 and 256^2 rays (>= 2^15, so the pyramid) against
  JAX's ``trace_octree(pyramid=True)``: tests/test_torch_render.py's
  tolerances (hit masks on >= 99.8%, depths of common hits within 1e-3
  with a median below 1e-6, normals) and ``stats_out["rounds"]`` equal.
  JAX's iterations count a march block's trips (the last trip of the
  block with an active ray, summed over the rounds that hold the ray),
  the port's a ray's own steps, so the port's never exceed JAX's on
  >= 99.9% of common hits and never on the frame's longest ray.
* The port's pyramid against its dynamic scheduler (``pyramid=False``):
  identical hit masks and iterations, depths within rtol 1e-5, atol
  1e-6.
* The frame makes no host sync (``stats_out["host_syncs"] == 0``): a
  round's trips run in one call, which stops by itself once its rays are
  done.
* A beam-off frame with 64 trips whose rays reach the straggler march,
  against JAX's pyramid and, on the rays that converge, the dynamic
  scheduler.
* The tracer over the thin grid and the octree words equals the tracer
  over the fused rows bit for bit (hit, position, depth, iterations,
  normals): both hold the same values.
* ``sharded_trace`` on two entries in two calls (2^15-ray shards, each a
  pyramid) against JAX's on two devices, and bit-equal to the port's
  single-device trace.
* The frames' cache key changes with the octree's grids, and
  ``parallel``'s replicas are kept until the structure changes, so a
  second card's frames are found again.
* On a CUDA device (skipped here): graph replay bit-equal to the eager
  schedule, a second call replays its one graph without capturing (one
  ``cudaGraphLaunch`` and no host sync under the profiler), two results of one
  octree do not share storage, a capture error and an empty capture
  raise; with two cards or more, an octree on the second card traces
  bit-equal to the eager schedule, and a second ``sharded_trace`` over
  every card replays each card's frame without capturing.

JAX is imported inside fixtures: the GPU machine has no JAX and runs
only the cuda-marked cases (``pytest --noconftest -m cuda``).
"""
import importlib

import numpy as np
import pytest
import torch

from sdflib_tpu_torch import OctreeSdf, parallel
from sdflib_tpu_torch.render.sphere_trace import sphere_trace_state, trace_octree
from sdflib_tpu_torch.utils.primitives import make_icosphere

# the module (the package's ``sphere_trace`` attribute is the function)
st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
torch.set_num_threads(1)
CFG = dict(max_depth=5, start_depth=2, termination_threshold=1e-3)


def _ortho(n: int):
    """bench.py's rays at n^2: origins on z = -1.2 over [-0.5, 0.5]^2,
    directions +z."""
    u = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    gu, gv = np.meshgrid(u, u)
    o = np.stack([gu, gv, np.full_like(gu, -1.2)], -1).astype(np.float32)
    d = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), o.shape).copy()
    return o, d


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hold(ref, res):
    """tests/test_torch_render.py's tolerances: hit masks agree on >=
    99.8%; on common hits depths within 1e-3, their median difference
    below 1e-6, and normals agree on >= 99%."""
    hj, hp = _np(ref.hit), _np(res.hit)
    agree = (hj == hp).mean()
    assert agree >= 0.998, f"hit masks agree on {agree:.2%}"
    both = hj & hp
    assert both.sum() > 0.5 * hj.sum()
    dd = np.abs(_np(ref.depth)[both] - _np(res.depth)[both])
    assert dd.max() <= 1e-3 and np.median(dd) < 1e-6, (dd.max(), np.median(dd))
    dots = (_np(ref.normal)[both] * _np(res.normal)[both]).sum(-1)
    assert (dots > 0.999).mean() >= 0.99
    return both


@pytest.fixture(scope="module")
def octrees():
    """(JAX octree, port octree) on one JAX-built structure (the walk)."""
    from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
    from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere

    mesh = j_icosphere(subdivisions=3, radius=0.35)
    j = JOctree(mesh, mesh.bounding_box.add_margin(0.14), **CFG)
    return j, OctreeSdf.from_jax_state(j._state_arrays(), device="cpu")


@pytest.fixture(scope="module")
def frames(octrees):
    """{n: (JAX pyramid, its stats, port pyramid, its stats, port
    dynamic)} for n^2 rays, beam 4, 1024 trips."""
    from sdflib_tpu.render.sphere_trace import trace_octree as j_trace

    j, p = octrees
    out = {}
    for n in (192, 256):
        o, d = _ortho(n)
        sj, sp = {}, {}
        ref = j_trace(j, o, d, max_iters=1024, stats_out=sj)
        res = trace_octree(p, o, d, max_iters=1024, stats_out=sp)
        dyn = trace_octree(p, o, d, max_iters=1024, pyramid=False)
        out[n] = (ref, sj, res, sp, dyn)
    return out


# -- the schedule and the fixed-trip march ------------------------------------


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("block", ["frame", 4096])
def test_pyramid_schedule_matches_jax(dense, block):
    from sdflib_tpu.render.sphere_trace import _build_pyramid_schedule as j_schedule

    for Rp in (1 << 15, 36_864, 1 << 16, 1 << 20):
        B = min(1 << 17, Rp) if block == "frame" else block
        for max_iters in (64, 256, 1024):
            got = st._build_pyramid_schedule(Rp, max_iters, B, dense)
            assert got == j_schedule(Rp, max_iters, B, dense), (Rp, max_iters, B)
            assert sum(k for k, _ in got) == max_iters


def test_bench_frame_schedule():
    """bench.py's frame: 2^20 rays, 1024 trips, B = 2^17."""
    sched = st._build_pyramid_schedule(1 << 20, 1024, 1 << 17)
    assert sched == ((8, 1 << 20), (16, 131_072), (32, 32_768), (64, 8192), (128, 4096),
                     (256, 2048), (256, 2048), (256, 2048), (8, 2048))
    assert sum(k * n for k, n in sched) == 14_172_160
    dense = st._build_pyramid_schedule(1 << 20, 1024, 1 << 17, dense=True)
    assert sum(k * n for k, n in dense) == 104_988_672


def test_sphere_trace_state_fixed_trips():
    """Rays at a sphere converge in a few trips of 64; the fixed march
    runs all 64 and keeps the early-exiting march's state and count."""
    import jax.numpy as jnp

    from sdflib_tpu.render.sphere_trace import sphere_trace_state as j_state

    rng = np.random.default_rng(3)
    n = 512
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o *= (2.0 / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = (-o + rng.normal(scale=0.1, size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16] = -d[:16]                           # misses, stopped by far
    init = (o, np.zeros(n, np.float32), np.full(n, np.inf, np.float32), np.ones(n, np.float32))
    kw = dict(eps=1e-5, far=8.0, max_iters=64)
    it_j, sj = j_state(lambda p: jnp.linalg.norm(p, axis=-1) - 0.5,
                       tuple(jnp.asarray(a) for a in init), d, fixed_trips=True, **kw)
    state = tuple(torch.as_tensor(a) for a in init)
    it, sp = sphere_trace_state(lambda p: p.norm(dim=-1) - 0.5, state, d, fixed_trips=True,
                                **kw)
    it_w, sw = sphere_trace_state(lambda p: p.norm(dim=-1) - 0.5, state, d, **kw)
    assert int(it) == int(it_j) == int(it_w) < 64
    assert it.dtype == torch.int32 and it.shape == ()
    for a, b, c in zip(sp, sj, sw):
        # rays that miss end ~10 from the origin: 1e-6 relative there
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
        assert torch.equal(a, c)
    assert torch.equal(state[0], torch.as_tensor(o))    # the caller's state is not written


# -- frames -------------------------------------------------------------------


@pytest.mark.parametrize("n", [192, 256])
def test_pyramid_frame_matches_jax(frames, n):
    ref, sj, res, sp, _ = frames[n]
    assert res.hit.shape == (n, n) and res.iterations.dtype == torch.int32
    both = _hold(ref, res)
    assert sp["rounds"] == sj["rounds"]
    assert sp["rounds"] == [("pyramid", st._build_pyramid_schedule(n * n, 1024, n * n), 0)]
    it_j, it_p = _np(ref.iterations)[both], _np(res.iterations)[both]
    assert (it_p <= it_j).mean() >= 0.999
    assert _np(res.iterations).max() <= _np(ref.iterations).max()
    assert sp["graphs_captured"] == sp["graphs_replayed"] == 0    # eager on the CPU
    assert sp["host_syncs"] == 0
    assert sp["marched_ray_trips"] >= int(res.iterations.sum())


@pytest.mark.parametrize("n", [192, 256])
def test_pyramid_equals_dynamic(frames, n):
    _, _, res, _, dyn = frames[n]
    assert torch.equal(res.hit, dyn.hit)
    assert torch.equal(res.iterations, dyn.iterations)
    torch.testing.assert_close(res.depth, dyn.depth, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(res.position, dyn.position, rtol=1e-5, atol=1e-6)


def test_beam_off_frame_reaches_stragglers(octrees):
    """192^2 rays, no beam, 64 trips: the dense pyramid's rounds leave
    rays active, which the straggler march takes (their budget is all
    rounds but the first, as in JAX)."""
    from sdflib_tpu.render.sphere_trace import trace_octree as j_trace

    j, p = octrees
    o, d = _ortho(192)
    kw = dict(max_iters=64, beam=None)
    sp, sj, sd = {}, {}, {}
    res = trace_octree(p, o, d, stats_out=sp, **kw)
    ref = j_trace(j, o, d, stats_out=sj, **kw)
    dyn = trace_octree(p, o, d, pyramid=False, stats_out=sd, **kw)
    assert sp["rounds"] == sj["rounds"]
    sched = sp["rounds"][0][1]
    assert sp["marched_ray_trips"] > sum(k * n for k, n in sched)     # the stragglers marched
    assert sd["rounds"][-1][2] > 0              # rays the dynamic path cut at 64 trips
    _hold(ref, res)
    done = _np(dyn.iterations) < 64             # converged within the budget
    assert done.mean() > 0.9
    for a, b in zip(res, dyn):
        assert np.array_equal(_np(a)[done], _np(b)[done])
    assert _np(res.iterations).max() > 64       # the stragglers' larger budget


def test_sharded_trace_pyramid_shards(octrees):
    """Two 2^15-ray shards in two calls ("cpu" and "cpu:0" are distinct
    devices), each a pyramid frame, against JAX's two-device
    ``sharded_trace``; bit-equal to the single-device trace (every ray
    converges)."""
    import jax

    from sdflib_tpu import parallel as jpar

    j, p = octrees
    o, d = _ortho(256)
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    res = parallel.sharded_trace(p, o, d, devs, max_iters=1024)
    single = trace_octree(p, o, d, max_iters=1024, beam=None)
    for a, b in zip(res, single):
        assert torch.equal(a, b)
    ref = jpar.sharded_trace(j, o, d, jpar.default_mesh(jax.devices()[:2]), max_iters=1024)
    _hold(ref, res)


def _small_octree():
    mesh = make_icosphere(subdivisions=2, radius=0.35)
    return OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cpu",
                     **dict(CFG, max_depth=4))


def test_thin_route_equals_fused_rows(monkeypatch):
    """The march, the beam and the normals over the thin grid (the
    tracer's rows) and over the fused rows (the structure's leaf grid
    patched to them) trace the same frame bit for bit: the rows hold the
    same values."""
    tree = _small_octree()
    tree.build_query_grid()
    o, d = _ortho(192)                       # 36,864 rays: the pyramid frame
    assert not st._route(tree, 1e-5).march.args[0].fat
    s_thin, s_fused = {}, {}
    thin = trace_octree(tree, o, d, max_iters=256, stats_out=s_thin)
    monkeypatch.setattr(tree, "_leaf_grid", lambda fat: OctreeSdf._leaf_grid(tree, True))
    assert st._route(tree, 1e-5).march.args[0].fat
    fused = trace_octree(tree, o, d, max_iters=256, stats_out=s_fused)
    for a, b in zip(thin, fused):
        assert torch.equal(a, b)
    assert bool(thin.hit.any()) and not bool(thin.hit.all())
    assert s_thin["host_syncs"] == s_fused["host_syncs"] == 0


def test_route_key_follows_the_grids():
    """A frame is keyed on the route's arrays by address and its scalars:
    the same octree keys the same frames, new grids new ones."""
    tree = _small_octree()
    key = st._route(tree, 1e-5).key
    assert st._route(tree, 1e-5).key == key
    assert st._route(tree, 2e-5).key != key            # the beam's margin
    tree.build_query_grid()
    grid_key = st._route(tree, 1e-5).key
    assert grid_key != key
    tree.build_query_grid()                            # new grids, new addresses
    assert st._route(tree, 1e-5).key != grid_key


def test_replicas_kept_until_the_structure_changes():
    query = importlib.import_module("sdflib_tpu_torch.parallel.query")
    tree = _small_octree()
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    reps = query._replicas(tree, devs)
    assert set(reps) == set(devs)
    again = query._replicas(tree, devs)
    assert all(again[d] is reps[d] for d in devs)
    tree.build_query_grid()
    rebuilt = query._replicas(tree, devs)
    assert all(rebuilt[d] is not reps[d] for d in devs)
    assert all(rebuilt[d]._query_grid is not None for d in devs)
    tree._box_min.add_(0.0)                            # an in-place write
    written = query._replicas(tree, devs)
    assert all(written[d] is not rebuilt[d] for d in devs)
    assert query._replicas(tree, devs[:1])[devs[0]] is written[devs[0]]


# -- on the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_octree():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_icosphere(subdivisions=3, radius=0.35)
    tree = OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cuda", **CFG)
    tree.build_query_grid()
    return tree


@pytest.mark.cuda
def test_graph_replay_equals_eager(cuda_octree):
    o, d = _ortho(256)
    kw = dict(eps=1e-5, far=4.0, max_iters=1024, block_size=None, beam=4, pyramid=True,
              active=None)
    s1, s2, s3 = {}, {}, {}
    first = trace_octree(cuda_octree, o, d, stats_out=s1, max_iters=1024)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:   # one launch, no host sync
        second = trace_octree(cuda_octree, o, d, stats_out=s2, max_iters=1024)
        torch.cuda.synchronize()
    eager = st._trace(cuda_octree, o, d, stats_out=s3, graphs=False, **kw)
    calls = {e.key: e.count for e in prof.key_averages()}
    assert calls.get("cudaGraphLaunch", 0) == 1
    assert calls.get("aten::_local_scalar_dense", 0) == calls.get("aten::nonzero", 0) == 0
    assert s1["graphs_captured"] == 1 and s1["host_syncs"] == 0
    assert s2["graphs_captured"] == 0 and s2["graphs_replayed"] == 1 and s2["host_syncs"] == 0
    assert s3["graphs_captured"] == s3["graphs_replayed"] == 0
    assert s1["rounds"] == s2["rounds"] == s3["rounds"]
    for a, b, c in zip(first, second, eager):
        assert a.device.type == "cuda"
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.cuda
def test_results_do_not_alias(cuda_octree):
    o, d = _ortho(192)
    a = trace_octree(cuda_octree, o, d)
    keep = [x.clone() for x in a]
    b = trace_octree(cuda_octree, o + np.float32(0.01), d)
    for x, y, k in zip(a, b, keep):
        assert x.data_ptr() != y.data_ptr()
        assert torch.equal(x, k)                # the second frame left the first alone
    assert not torch.equal(a.depth, b.depth)


@pytest.mark.cuda
def test_capture_error_propagates(cuda_octree, monkeypatch):
    """A host sync inside a piece fails its capture: the error reaches
    the caller, with no retry on the eager schedule."""
    segment = st.march_segment

    def syncing_segment(*args):
        bool(args[4].any())              # a host sync inside the captured march
        return segment(*args)

    monkeypatch.setattr(st, "march_segment", syncing_segment)
    o, d = _ortho(200)                   # a frame shape no other test captured
    with pytest.raises(RuntimeError):
        trace_octree(cuda_octree, o, d, max_iters=1024)


@pytest.mark.cuda
def test_empty_capture_raises(cuda_octree):
    """Work whose kernels miss the capture stream records an empty graph:
    that raises rather than replaying nothing."""
    run = st._Runner(True)
    with pytest.raises(UserWarning, match="The CUDA Graph is empty"):
        run(lambda: None)


@pytest.mark.cuda
def test_graphs_on_second_card():
    """An octree on cuda:1 while cuda:0 is current: its frame is captured
    and replayed on its own card, bit-equal to the eager schedule."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_icosphere(subdivisions=3, radius=0.35)
    tree = OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cuda:1", **CFG)
    tree.build_query_grid()
    o, d = _ortho(256)
    kw = dict(eps=1e-5, far=4.0, max_iters=1024, block_size=None, beam=4, pyramid=True,
              active=None)
    torch.cuda.set_device(0)
    s1, s2 = {}, {}
    first = trace_octree(tree, o, d, stats_out=s1, max_iters=1024)
    second = trace_octree(tree, o, d, stats_out=s2, max_iters=1024)
    eager = st._trace(tree, o, d, stats_out=None, graphs=False, **kw)
    assert s1["graphs_captured"] > 0 and s2["graphs_captured"] == 0
    assert torch.cuda.current_device() == 0
    for a, b, c in zip(first, second, eager):
        assert a.device == torch.device("cuda", 1)
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.cuda
def test_sharded_trace_replays_on_every_card(cuda_octree):
    """``sharded_trace`` over every card twice: the second call captures
    no graph on any card, and both equal the single-card trace."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    o, d = _ortho(512)                        # 2^18 / n rays a card: pyramids
    single = trace_octree(cuda_octree, o, d, max_iters=1024, beam=None)
    first = parallel.sharded_trace(cuda_octree, o, d, max_iters=1024)
    frames = {dev: dict(fr) for dev, fr in st._FRAMES.frames.items()}
    second = parallel.sharded_trace(cuda_octree, o, d, max_iters=1024)
    for i in range(n):
        dev = torch.device("cuda", i)
        assert st._FRAMES.frames[dev].keys() == frames[dev].keys()
        newest = next(reversed(st._FRAMES.frames[dev].values()))[-1]
        assert newest.runner.captured == 0 and newest.runner.replayed > 0
    for a, b, c in zip(first, second, single):
        assert torch.equal(a, c) and torch.equal(b, c)
