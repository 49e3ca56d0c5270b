"""K4-K6 (``ops/octree_query.py``, ``ops/march.py``): the approximate
octree's grid query and the tracer's march and beam segments.

* ``_octree_query_grid`` (thin grid) and ``_octree_query_fat`` (fused
  rows), with the gradient, against the JAX functions
  (sdflib_tpu/sdf/octree.py:183, :325) on JAX-built d4 structures (the
  icosphere of tests/test_octree.py, tricubic and trilinear) carried by
  ``from_jax_state``: 4,000 points of a numpy seed in, on and outside the
  box, within 1e-6 in distance and 1e-5 in gradient (fp32 sums in
  another order); the public queries take that route after
  ``build_query_grid``.
* ``_Route.march`` and ``_Route.beam`` on both grid routes equal, bit for
  bit on the CPU, the ``_trip`` / ``_beam_trip`` loops they replace over
  ``_grid_distance_and_step``, from the rays' starts and from a
  half-marched state; the trace with the plain versions pinned
  (``_plain``) equals the default on the CPU.
* Torch trips with the early exit stop at the first trip that finds no
  ray active, bit-equal to running every trip.
* Each wrapper raises on a wrong dtype, shape, contiguity or device, and
  on CPU tensors launches nothing (the counts stay 0, no build).
* On a CUDA device (skipped here): K4 against its plain version (1e-6 in
  distance, 1e-5 in gradient) on both routes, each group size bit-equal
  to one thread a point; K5 and K6 segments against theirs (active
  flags and step counts on >= 99.9%, q99 of |depth difference| <= 1e-4
  of the box: the sums' order moves a ray's path by ulps, which grow over
  the trips); one K5 launch of a round's budget bit-equal to the same
  trips in 16-trip launches, and on the fused rows; and the kernel frame
  against the plain frame (hit masks on >= 99.9%, q99 of |depth
  difference| on common hits <= 1e-4 of the box).

JAX is imported inside fixtures: the GPU machine has no JAX and runs
only the cuda-marked cases (``pytest --noconftest -m cuda``).
"""
import importlib

import numpy as np
import pytest
import torch

from sdflib_tpu_torch import OctreeSdf
from sdflib_tpu_torch.kernels import build
from sdflib_tpu_torch.ops import march as om
from sdflib_tpu_torch.ops import octree_query as oq
from sdflib_tpu_torch.ops.march import _beam_trip, _grid_distance_and_step, _trip
from sdflib_tpu_torch.render import Camera, trace_octree
from sdflib_tpu_torch.sdf import octree as po
from sdflib_tpu_torch.utils.primitives import make_icosphere

st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
torch.set_num_threads(1)
CFG = dict(max_depth=4, start_depth=2, termination_threshold=1e-3,
           init_algorithm="no_continuity")
D_TOL = dict(rtol=0, atol=1e-6)
G_TOL = dict(rtol=0, atol=1e-5)


def _mesh_box(make):
    mesh = make(subdivisions=2, radius=0.35)
    return mesh, mesh.bounding_box.add_margin(0.14)


def _points(seed: int = 3) -> np.ndarray:
    """Points in the box, on cell faces and outside it."""
    rng = np.random.default_rng(seed)
    inside = rng.uniform(-0.48, 0.48, (3400, 3))
    faces = np.round(rng.uniform(-0.48, 0.48, (300, 3)) / 0.0625) * 0.0625
    outside = rng.uniform(-2.0, 2.0, (300, 3))
    return np.concatenate([inside, faces, outside]).astype(np.float32)


@pytest.fixture(scope="module", params=["tricubic", "trilinear"])
def gridded(request):
    """(JAX octree, port octree) of one JAX-built d4 structure, each with
    its query grid."""
    from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
    from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere

    j = JOctree(*_mesh_box(j_icosphere), interpolation=request.param, **CFG)
    p = OctreeSdf.from_jax_state(j._state_arrays(), device="cpu")
    j.build_query_grid()
    p.build_query_grid()
    return j, p


@pytest.mark.parametrize("route", ["grid", "fat"])
def test_grid_query_matches_jax(gridded, route):
    import jax.numpy as jnp
    import sdflib_tpu.sdf.octree as jo

    j, p = gridded
    pts = _points()
    kw = dict(num_coeff=p.num_coefficients, interpolation=p.interpolation,
              with_gradient=True, grid_depth=p.max_depth)
    jbox = (jnp.asarray(j.box.min), jnp.float32(j.box.size[0]))
    mbv = jnp.float32(j.min_border_value)
    if route == "grid":
        ref = jo._octree_query_grid(j.octree_data, j._query_grid, jnp.asarray(pts), *jbox,
                                    mbv, **kw)
        got = po._octree_query_grid(p._octree_dev, p._query_grid, torch.as_tensor(pts),
                                    p._box_min, p._box_size3, p.min_border_value, **kw)
    else:
        ref = jo._octree_query_fat(j._fat_grid, jnp.asarray(pts), *jbox, mbv, **kw)
        got = po._octree_query_fat(p._fat_grid, torch.as_tensor(pts), p._box_min,
                                   p._box_size3, p.min_border_value, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **D_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **G_TOL)
    out = np.any((pts < p.box.min) | (pts >= p.box.max), axis=1)
    assert out.sum() >= 250 and (~out).sum() >= 3000
    if route == "grid":          # the public queries take the thin grid
        d, g = p.get_distance_and_gradient(pts)
        assert torch.equal(d, got[0]) and torch.equal(g, got[1])
        assert torch.equal(p.get_distance(pts), got[0])


@pytest.fixture(scope="module")
def port_tree():
    tree = OctreeSdf(*_mesh_box(make_icosphere), device="cpu", **CFG)
    tree.build_query_grid()
    return tree


def _rays(n: int = 24):
    o, d = Camera(position=(0.25, 0.15, 1.1), target=(0.0, 0.0, 0.0),
                  fov_y_deg=45.0).rays(n, n)
    return (torch.as_tensor(o.reshape(-1, 3)).contiguous(),
            torch.as_tensor(d.reshape(-1, 3)).contiguous())


def _thin(tree):
    """The structure with its thin grid only (the fused rows dropped)."""
    thin = OctreeSdf.from_jax_state(tree._state_arrays(), device=tree.device)
    thin._query_grid, thin._fat_grid = tree._query_grid, None
    return thin


def _step_fn(tree, fat: bool):
    grid = tree._fat_grid if fat else tree._query_grid

    def step(p, u, shrink=None):
        return _grid_distance_and_step(
            tree._octree_dev, grid, p, u, tree._box_min, tree._box_size3,
            tree.min_border_value, grid_depth=tree.max_depth,
            num_coeff=tree.num_coefficients, interpolation=tree.interpolation,
            grid_fat=fat, shrink=shrink)
    return step


@pytest.mark.parametrize("fat", [True, False])
def test_route_march_equals_trip_loop(port_tree, fat):
    """The route's march segments equal the ``_trip`` loop bit for bit,
    from the rays' starts and again from the state half-way."""
    tree = port_tree if fat else _thin(port_tree)
    route = st._route(tree, 1e-5)
    o, d = _rays()
    n = o.shape[0]
    box = float(tree.box.size[0])
    eps, far = float(np.float32(1e-5) * np.float32(box)), float(np.float32(4.0) * np.float32(box))
    state = [o.clone(), torch.zeros(n), torch.full((n,), torch.inf), torch.ones(n),
             torch.zeros(n, dtype=torch.int32)]
    for trips in (16, 40):
        ref = [x.clone() for x in state]
        got = [x.clone() for x in state]
        for _ in range(trips):
            _trip(_step_fn(tree, fat), *ref, d, eps, far)
        route.march(*got, d, eps, far, trips)
        for a, b in zip(ref, got):
            assert torch.equal(a, b)
        state = got
    assert 0 < int((state[3] > 0).sum()) < n         # some rays still march
    assert int((state[2] <= eps).sum()) > 0           # and some hit


@pytest.mark.parametrize("fat", [True, False])
def test_route_beam_equals_beam_trip_loop(port_tree, fat):
    tree = port_tree if fat else _thin(port_tree)
    route = st._route(tree, 1e-5)
    o, d = _rays(32)
    o_t, d_t, mask, _ = st._beam_tiles(o, d, (32, 32, 3), 4)
    o_c, d_c, r0, rd = st._beam_setup(o_t, d_t, mask)
    far = 4.0 * float(tree.box.size[0])
    nt = o_c.shape[0]
    ref = [o_c.clone(), torch.zeros(nt), torch.ones(nt)]
    got = [x.clone() for x in ref]
    for _ in range(24):
        _beam_trip(_step_fn(tree, fat), *ref, d_c, r0, rd, route.margin, far)
    route.beam(*got, d_c, r0, rd, route.margin, far, 24)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert float(got[1].max()) > 0.0


def test_torch_trips_stop_once_no_ray_is_active(port_tree):
    """With the early exit, torch trips on the CPU check before every trip
    and stop at the first trip that finds no ray active: bit-equal to
    every trip of the budget (a trip leaves a done ray as it is), with no
    host sync."""
    o, d = _rays()
    n = o.shape[0]
    box = float(port_tree.box.size[0])
    eps, far = float(np.float32(1e-5) * np.float32(box)), float(np.float32(4.0) * np.float32(box))
    start = [o.clone(), torch.zeros(n), torch.full((n,), torch.inf), torch.ones(n),
             torch.zeros(n, dtype=torch.int32)]
    step = _step_fn(port_tree, False)
    calls = []

    def counted(p, u):
        calls.append(p.shape[0])
        return step(p, u)

    trips = 1024
    ref = [x.clone() for x in start]
    got = [x.clone() for x in start]
    assert om.march_trips(counted, *got, d, eps, far, trips, exit_early=True) == 0
    assert not bool((got[3] > 0).any())          # every ray done within the budget
    assert len(calls) == int(got[4].max()) < trips   # the last active ray's steps
    for _ in range(len(calls) + 8):
        _trip(step, *ref, d, eps, far)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_plain_pin_equals_default_on_cpu(port_tree):
    """``_plain`` pins the plain versions (the card's comparison); on the
    CPU both are the plain versions, so the traces agree bit for bit and
    the frames key apart."""
    o, d = _rays(192)
    base = trace_octree(port_tree, o, d, max_iters=256)
    key = st._route(port_tree, 1e-5).key
    port_tree._plain = True
    try:
        assert st._route(port_tree, 1e-5).key != key
        pinned = trace_octree(port_tree, o, d, max_iters=256)
        d_pin = port_tree.get_distance(o)
    finally:
        port_tree._plain = False
    for a, b in zip(base, pinned):
        assert torch.equal(a, b)
    assert torch.equal(d_pin, port_tree.get_distance(o))
    assert bool(base.hit.any())


def _reset():
    oq.launch_count = om.launch_count = om.beam_launch_count = 0


def test_cpu_tensors_launch_nothing(port_tree, monkeypatch):
    def no_build():
        raise AssertionError("a CPU call built the kernels")

    monkeypatch.setattr(build, "library", no_build)
    _reset()
    o, d = _rays(192)           # 36,864 rays: the pyramid frame
    res = trace_octree(port_tree, o, d, max_iters=64)
    trace_octree(port_tree, o[:500], d[:500], max_iters=64)      # the dynamic scheduler
    port_tree.get_distance_and_gradient(o)
    assert bool(res.hit.any())
    assert oq.launch_count == om.launch_count == om.beam_launch_count == 0


def _state(n: int, device="cpu"):
    z = torch.zeros(n, device=device)
    return (torch.zeros(n, 3, device=device), z.clone(), z.clone(), z.clone(),
            torch.zeros(n, dtype=torch.int32, device=device), torch.zeros(n, 3, device=device))


def test_wrappers_reject_bad_inputs(port_tree):
    grid = port_tree._leaf_grid(True)
    thin = port_tree._leaf_grid(False)
    pts = torch.zeros(8, 3)
    bad = {
        "dtype": (pts.double(),),
        "shape": (torch.zeros(8, 2),),
        "contiguity": (torch.zeros(3, 8).t(),),
        "device": (torch.zeros(8, 3, device="meta"),),
    }
    for what, (p,) in bad.items():
        with pytest.raises(ValueError):
            oq.grid_query(grid, p, False)
    with pytest.raises(ValueError):               # an unsupported device
        oq.grid_query(grid._replace(
            rows=grid.rows.to("meta"), words=None, box_min=grid.box_min.to("meta"),
            box_size3=grid.box_size3.to("meta")), pts.to("meta"), False)
    with pytest.raises(ValueError):               # thin rows read as fused
        oq.grid_query(thin._replace(fat=True), pts, False)
    with pytest.raises(ValueError):               # fused rows read as thin
        oq.grid_query(grid._replace(fat=False), pts, False)
    with pytest.raises(ValueError):               # the coefficient count
        oq.grid_query(grid._replace(num_coeff=8), pts, False)
    with pytest.raises(ValueError):               # the thin grid needs the words
        oq.grid_query(thin._replace(words=None), pts, False)
    with pytest.raises(ValueError):               # the box
        oq.grid_query(grid._replace(box_min=grid.box_min.double()), pts, False)
    with pytest.raises(ValueError):               # out= of another shape
        oq.grid_query(grid, pts, True, out=(torch.zeros(8), torch.zeros(8, 2)))
    for group in (2, 16):                         # group sizes the kernel lacks
        with pytest.raises(ValueError):
            oq.grid_query(grid, pts, False, group=group)

    pos, acc, last_d, active, its, dirs = _state(8)
    om.march_segment(grid, pos, acc, last_d, active, its, dirs, 1e-5, 4.0, 2)
    for i, wrong in ((0, pos.double()), (1, acc[:4]), (4, its.float()), (5, dirs.t()),
                     (3, active.to("meta"))):
        args = [pos, acc, last_d, active, its, dirs]
        args[i] = wrong
        with pytest.raises(ValueError):
            om.march_segment(grid, *args, 1e-5, 4.0, 2)
    r0 = torch.zeros(8)
    om.beam_segment(grid, pos, acc, active, dirs, r0, r0, 0.01, 4.0, 2)
    for i, wrong in ((0, pos[:, :2]), (2, active.double()), (4, r0[:7]), (5, r0.to("meta"))):
        args = [pos, acc, active, dirs, r0, r0]
        args[i] = wrong
        with pytest.raises(ValueError):
            om.beam_segment(grid, *args, 0.01, 4.0, 2)


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_tree():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tree = OctreeSdf(*_mesh_box(make_icosphere), device="cuda",
                     **dict(CFG, max_depth=5))
    tree.build_query_grid()
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("fat", [True, False])
@pytest.mark.parametrize("grad", [False, True])
def test_k4_against_plain(cuda_tree, fat, grad):
    """Every group size within the tolerances of the plain version, and
    bit-equal to one thread a point (the group keeps its sum order)."""
    grid = cuda_tree._leaf_grid(fat)
    pts = torch.as_tensor(np.concatenate([_points(s) for s in range(16)]), device="cuda")
    ref = oq.grid_query_plain(grid, pts, grad)
    ref = ref if grad else (ref,)
    one = None
    for group in oq.GROUPS:
        _reset()
        got = oq.grid_query(grid, pts, grad, group=group)
        assert oq.launch_count == 1
        got = got if grad else (got,)
        assert float((got[0] - ref[0]).abs().max()) <= 1e-6, group
        if grad:
            assert float((got[1] - ref[1]).abs().max()) <= 1e-5, group
        one = got if one is None else one
        assert all(torch.equal(a, b) for a, b in zip(got, one)), group


@pytest.mark.cuda
def test_k5_one_launch_equals_segments(cuda_tree):
    """A round's 64 trips in one K5 launch equal the same trips in four
    16-trip launches bit for bit; so do the fused rows (the same values as
    the thin grid and the words)."""
    o, d = (x.cuda() for x in _rays(128))
    n = o.shape[0]
    box = float(cuda_tree.box.size[0])
    eps, far = float(np.float32(1e-5) * np.float32(box)), float(np.float32(4.0) * np.float32(box))
    start = [o.clone(), torch.zeros(n, device="cuda"), torch.full((n,), torch.inf, device="cuda"),
             torch.ones(n, device="cuda"), torch.zeros(n, dtype=torch.int32, device="cuda")]
    thin = cuda_tree._leaf_grid(False)
    seg = [x.clone() for x in start]
    for _ in range(4):
        om.march_segment(thin, *seg, d, eps, far, 16)
    assert 0 < int((seg[3] > 0).sum()) < n
    _reset()
    for grid in (thin, cuda_tree._leaf_grid(True)):
        got = [x.clone() for x in start]
        om.march_segment(grid, *got, d, eps, far, 64)
        for a, b in zip(seg, got):
            assert torch.equal(a, b), grid.fat
    assert om.launch_count == 2


@pytest.mark.cuda
@pytest.mark.parametrize("fat", [True, False])
def test_k5_k6_against_plain(cuda_tree, fat):
    grid = cuda_tree._leaf_grid(fat)
    route = st._route(cuda_tree, 1e-5)
    o, d = (x.cuda() for x in _rays(128))
    n = o.shape[0]
    box = float(cuda_tree.box.size[0])
    eps, far = float(np.float32(1e-5) * np.float32(box)), float(np.float32(4.0) * np.float32(box))
    start = [o.clone(), torch.zeros(n, device="cuda"), torch.full((n,), torch.inf, device="cuda"),
             torch.ones(n, device="cuda"), torch.zeros(n, dtype=torch.int32, device="cuda")]
    ref, got = [x.clone() for x in start], [x.clone() for x in start]
    _reset()
    om.march_segment_plain(grid, *ref, d, eps, far, 16)
    om.march_segment(grid, *got, d, eps, far, 16)
    assert om.launch_count == 1
    assert float((ref[3] == got[3]).float().mean()) >= 0.999
    assert float((ref[4] == got[4]).float().mean()) >= 0.999
    assert float(torch.quantile((ref[1] - got[1]).abs(), 0.99)) <= 1e-4 * box

    o_t, d_t, mask, _ = st._beam_tiles(o, d, (128, 128, 3), 4)
    o_c, d_c, r0, rd = st._beam_setup(o_t, d_t, mask)
    nt = o_c.shape[0]
    ref = [o_c.clone(), torch.zeros(nt, device="cuda"), torch.ones(nt, device="cuda")]
    got = [x.clone() for x in ref]
    om.beam_segment_plain(grid, *ref, d_c, r0, rd, route.margin, far, 16)
    om.beam_segment(grid, *got, d_c, r0, rd, route.margin, far, 16)
    assert om.beam_launch_count == 1
    assert float((ref[2] == got[2]).float().mean()) >= 0.999
    assert float(torch.quantile((ref[1] - got[1]).abs(), 0.99)) <= 1e-4 * box


@pytest.mark.cuda
def test_kernel_frame_against_plain_frame(cuda_tree):
    o, d = (x.cuda() for x in _rays(256))
    _reset()
    res = trace_octree(cuda_tree, o, d)
    assert oq.launch_count > 0 and om.launch_count > 0 and om.beam_launch_count > 0
    cuda_tree._plain = True
    try:
        _reset()
        plain = trace_octree(cuda_tree, o, d)
        assert oq.launch_count == om.launch_count == om.beam_launch_count == 0
    finally:
        cuda_tree._plain = False
    assert float((res.hit == plain.hit).float().mean()) >= 0.999
    both = res.hit & plain.hit
    assert int(both.sum()) > 0
    dd = (res.depth[both] - plain.depth[both]).abs()
    assert float(torch.quantile(dd, 0.99)) <= 1e-4 * float(cuda_tree.box.size[0])
