"""K14 and K15 (``sdflib_tpu_torch/ops/walk.py`` ``walk_segment`` and
``walk_beam``, ``csrc/octree_walk.cu``): the sphere tracer's march and beam
segments on the walk, the route of a container with no query grid.

On the CPU, on the icosphere of tests/test_torch_render.py (subdivisions
3, radius 0.35, box margin 0.14, ``max_depth=5``) built by the JAX package
and loaded through ``from_jax_state`` with no grid:

* ``walk_segment_plain`` run in budgets of 8, 16 and 24 trips ends bit for
  bit where one run of 48 trips ends, on the aligned and the word-by-word
  layout: a ray's march depends on the ray alone, so the state handed from
  one segment to the next carries it whole; ``walk_beam_plain``'s 256
  trips likewise in budgets of 16 and 240;
* K14's form plan (``segment_form``) as a function of the launch's width,
  its budget and the layout: 8 lanes a ray on the narrow launches of 64
  trips and more on the aligned tricubic rows, one thread a ray on wide
  launches (the walk frame's first rounds and its straggler march), short
  budgets, trilinear rows and the word-by-word layout, over the frames'
  schedules at 256^2, 512^2 and 1024^2 rays with
  beams and without; a group form on those layouts, or another size,
  raises;
* ``walk_beam_plain``'s stop depths against JAX's ``_beam_prepass_jit``
  with ``grid_depth=None`` (its walk branch) on the same tiles of 64^2
  camera rays: within 1e-3, their median difference below 1e-6 (the hold
  of ``test_trace_octree_matches_jax`` on depths: the two walks' sums run
  in another order, and a beam's stop moves with the last ulp of d);
* ``_route`` of a structure with no grid, or at an eps above the free
  cells' margin, takes K14 and K15 as a kernel route keyed on the words
  and the box; ``_plain`` pins the plain versions, which equal it on the
  CPU;
* zero rays and a zero budget leave the state as it is; the wrappers
  raise on a wrong dtype, shape, contiguity or device; CPU tensors
  launch nothing, in frames of both schedulers (no build, counts 0).

The walk route's frames against JAX's and the compiled reference
(``test_torch_render.py``: ``test_trace_octree_matches_jax[walk-*]``,
``test_frame_matches_jax_schedules`` and the C++ ``.bin`` case) hold the
plain route, which the CPU runs, and need no case here.

On a card (``python -m pytest --noconftest -m cuda
tests/test_torch_walk_segment.py``; no JAX here), on the port's own
icosphere octree built on the card (tricubic and trilinear, each on the
aligned and the word-by-word layout) and on the C++ SdfLib's own files
(``octree_torus_cpp.bin``, aligned, and its builder's
``builders_octree_nc.bin``, whose rows lie at any word):

* K14 in budgets of 8, 16, 32 and 200 trips ends bit for bit where one ``walk_march_one_thread`` launch of 256 trips ends (hit,
  position, depth, trips);
* K14's group form, 8 lanes a ray, bit for bit equal to one thread
  a ray in position, distance, last distance, active flag and trips, over
  1, 7, 8, 9, 31, 32, 33, 2,047, 2,048 and 8,192 rays in budgets of 1, 8
  and 256 trips, with infinite, NaN and outside-the-box origins, on the
  icosphere's words and on a copy with a tenth of its leaf words naming
  no row;
* K14 and K15 against their plain versions over K10's distance (the walk
  route's eager trips before them) bit for bit, but for the rays whose
  position turns infinite (an infinite origin among the rays): there the
  plain trips move a done ray by an infinite step times 0, NaN, and the
  kernels leave it; and against their plain versions over the plain walk,
  all torch: active flags and trip counts agree on >= 99.9%, q99 of
  |depth diff| <= 1e-4 of the box;
* a frame of 192^2 rays on a structure with no grid is one CUDA graph:
  the first frame captures it, the second replays it with one launch and
  captures none, both with no host sync and bit-equal to
  ``_trace(..., graphs=False)`` and to the eager frame with every K14
  launch one thread a ray; K14 and K15 are launched at the capture and not
  at the replay.
"""
import importlib
import os

import numpy as np
import pytest
import torch

from sdflib_tpu_torch import OctreeSdf
from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin
from sdflib_tpu_torch.kernels import build
from sdflib_tpu_torch.ops import walk as ow
from sdflib_tpu_torch.render import Camera, trace_octree
from sdflib_tpu_torch.utils.primitives import make_icosphere

st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "golden", "data")
CFG = dict(max_depth=5, start_depth=2, termination_threshold=1e-3)
EPS, FAR = 1e-4, 4.0


@pytest.fixture(scope="module")
def jax_pair():
    """(JAX octree, the port's octree on its state, with no grid)."""
    from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
    from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere

    mesh = j_icosphere(subdivisions=3, radius=0.35)
    j = JOctree(mesh, mesh.bounding_box.add_margin(0.14), **CFG)
    return j, OctreeSdf.from_jax_state(j._state_arrays(), device="cpu")


def _cam(n: int = 64, device="cpu"):
    o, d = Camera(position=(0, 0, 1.5), target=(0, 0, 0), fov_y_deg=45).rays(n, n)
    return (torch.as_tensor(o.reshape(-1, 3), device=device).contiguous(),
            torch.as_tensor(d.reshape(-1, 3), device=device).contiguous())


def _world(tree):
    """eps and far in world units, as the frame scales them."""
    box = np.float32(tree.box.size[0])
    return float(np.float32(EPS) * box), float(np.float32(FAR) * box)


def _start(o):
    n, dev = o.shape[0], o.device
    return [o.clone(), torch.zeros(n, device=dev), torch.full((n,), torch.inf, device=dev),
            torch.ones(n, device=dev), torch.zeros(n, dtype=torch.int32, device=dev)]


def _beams(o, d, side: int):
    o_t, d_t, mask, _ = st._beam_tiles(o, d, (side, side, 3), 4)
    return st._beam_setup(o_t, d_t, mask)


@pytest.mark.parametrize("fast", [True, False])
def test_segment_plain_split_budgets_equal_one_run(jax_pair, fast):
    _, tree = jax_pair
    walk = tree._walk()._replace(fast=fast)
    o, d = _cam()
    eps, far = _world(tree)
    whole, split = _start(o), _start(o)
    ow.walk_segment_plain(walk, *whole, d, eps, far, 48)
    for trips in (8, 16, 24):
        assert ow.walk_segment_plain(walk, *split, d, eps, far, trips) == 0   # no host sync
    for a, b in zip(whole, split):
        assert torch.equal(a, b)
    assert 0 < int((whole[2] <= eps).sum()) < o.shape[0]          # some rays hit
    assert int(whole[4].max()) > 24                                 # and marched past a split


@pytest.mark.parametrize("fast", [True, False])
def test_beam_plain_split_budget_equals_one_run(jax_pair, fast):
    _, tree = jax_pair
    walk = tree._walk()._replace(fast=fast)
    o, d = _cam()
    o_c, d_c, r0, rd = _beams(o, d, 64)
    margin = st._route(tree, EPS).margin
    far = FAR * float(tree.box.size[0])
    nt = o_c.shape[0]
    whole = [o_c.clone(), torch.zeros(nt), torch.ones(nt)]
    split = [x.clone() for x in whole]
    ow.walk_beam_plain(walk, *whole, d_c, r0, rd, margin, far, 256)
    for trips in (16, 240):             # the prepass split where few beams are still live
        assert ow.walk_beam_plain(walk, *split, d_c, r0, rd, margin, far, trips) == 0
    for a, b in zip(whole, split):
        assert torch.equal(a, b)
    assert not bool(whole[2].any()) and float(whole[1].max()) > 0.0


# The walk frames' K14 launches, (trips, rays), and the plan's forms, at
# n^2 rays with beams (the tracer's default) and without (dense): the
# schedule's rounds, then the straggler march over every row. 8 lanes a
# ray at <= 8,192 rays, where the group form was timed faster at every
# budget from 16 trips (PERF.md, K14).
FRAME_FORMS = {
    (256, True): ([(8, 65536), (16, 8192), (32, 2048), (64, 1024), (128, 1024),
                   (256, 1024), (256, 1024), (256, 1024), (8, 1024), (1016, 65536)],
                  [1, 8, 8, 8, 8, 8, 8, 8, 8, 1]),
    (256, False): ([(8, 65536), (16, 65536), (32, 32768), (64, 16384), (128, 8192),
                    (256, 4096), (256, 2048), (256, 1024), (8, 1024), (1016, 65536)],
                   [1, 1, 1, 1, 8, 8, 8, 8, 8, 1]),
    (512, True): ([(8, 262144), (16, 32768), (32, 8192), (64, 2048), (128, 1024),
                   (256, 1024), (256, 1024), (256, 1024), (8, 1024), (1016, 262144)],
                  [1, 1, 8, 8, 8, 8, 8, 8, 8, 1]),
    (512, False): ([(8, 262144), (16, 262144), (32, 131072), (64, 65536), (128, 32768),
                    (256, 16384), (256, 8192), (256, 4096), (8, 4096), (1016, 262144)],
                   [1, 1, 1, 1, 1, 1, 8, 8, 8, 1]),
    (1024, True): ([(8, 1 << 20), (16, 131072), (32, 32768), (64, 8192), (128, 4096),
                    (256, 2048), (256, 2048), (256, 2048), (8, 2048), (1016, 1 << 20)],
                   [1, 1, 1, 8, 8, 8, 8, 8, 8, 1]),
    (1024, False): ([(8, 1 << 20), (16, 1 << 20), (32, 524288), (64, 262144), (128, 131072),
                     (256, 65536), (256, 32768), (256, 16384), (8, 16384), (1016, 1 << 20)],
                    [1] * 10),
}


def test_segment_form_plan():
    assert ow.SEGMENT_FORMS == (1, 8)
    lanes = ow.GROUP_LANES
    for n in (1, 7, 2048, lanes // 8):               # narrow prefixes: 8 lanes a ray
        assert ow.segment_form(n, True, True) == 8
    for n in (lanes // 8 + 1, 32768, 131072, 1 << 20):   # wide prefixes: one thread a ray
        assert ow.segment_form(n, True, True) == 1
    for tricubic, fast in ((False, True), (True, False), (False, False)):
        for n in (1, 2048, 1 << 20):                  # trilinear rows, rows at any word
            assert ow.segment_form(n, tricubic, fast) == 1
    for (side, beams), (launches, forms) in FRAME_FORMS.items():
        R = side * side
        sched = st._build_pyramid_schedule(R, 1024, min(st._TRACE_BLOCK, R), dense=not beams)
        got = list(sched) + [(1024 - sched[0][0], R)]
        assert got == launches, (side, beams, got)
        assert [ow.segment_form(n, True, True) for _, n in got] == forms, (side, beams)


def test_forms_need_the_aligned_tricubic_rows(jax_pair):
    _, tree = jax_pair
    walk = tree._walk()
    eps, far = _world(tree)
    o, d = _cam(8)
    state = _start(o)
    for form in ow.SEGMENT_FORMS:                     # every form runs the plain trips here
        ow.walk_segment(walk, *state, d, eps, far, 2, form=form)
    for bad, form in ((walk, 4), (walk, 16), (walk, 32), (walk._replace(fast=False), 8),
                      (walk._replace(num_coeff=8, interpolation="trilinear"), 8)):
        with pytest.raises(ValueError):
            ow.walk_segment(bad, *state, d, eps, far, 2, form=form)
    ow.walk_segment(walk._replace(fast=False), *state, d, eps, far, 2, form=1)


def test_beam_plain_matches_jax(jax_pair):
    import jax.numpy as jnp

    from sdflib_tpu.render.sphere_trace import _beam_prepass_jit

    j, tree = jax_pair
    o, d = _cam()
    o_c, d_c, r0, rd = _beams(o, d, 64)
    margin = st._route(tree, EPS).margin
    far = FAR * float(tree.box.size[0])
    nt = o_c.shape[0]
    pos, acc, active = o_c.clone(), torch.zeros(nt), torch.ones(nt)
    ow.walk_beam_plain(tree._walk(), pos, acc, active, d_c, r0, rd, margin, far, 256)
    ref = np.asarray(_beam_prepass_jit(
        j.octree_data, jnp.zeros((1, 2), jnp.uint32), o_c.numpy(), d_c.numpy(), r0.numpy(),
        rd.numpy(), jnp.asarray(j.box.min), jnp.float32(j.box.size[0]), j.start_grid_size,
        jnp.float32(j.min_border_value), jnp.float32(margin), jnp.float32(far),
        levels=j.max_depth - j.start_depth, num_coeff=j.num_coefficients,
        interpolation=j.interpolation, max_iters=256, grid_depth=None, fast=j._fast_layout))
    dd = np.abs(acc.numpy() - ref)
    assert dd.max() <= 1e-3 and np.median(dd) < 1e-6, (dd.max(), np.median(dd))
    assert not bool(active.any())                  # every beam stopped within the budget
    assert float(acc.max()) > 0.0


def test_route_takes_the_walk_kernels(jax_pair):
    _, tree = jax_pair
    route = st._route(tree, EPS)
    assert route.kernel
    assert route.march.func is ow.walk_segment and route.beam.func is ow.walk_beam
    walk = route.march.args[0]
    assert walk.words is tree._octree_dev and walk.box_min is tree._box_min
    words, _, _, box_min, box_size3 = route.key[0]
    assert words == (tree._octree_dev.device, tree._octree_dev.data_ptr(),
                     tuple(tree._octree_dev.shape))
    assert box_min[1] == tree._box_min.data_ptr() and box_size3[1] == tree._box_size3.data_ptr()
    o, d = _cam()
    eps, far = _world(tree)
    got, ref = _start(o), _start(o)
    route.march(*got, d, eps, far, 40)
    ow.walk_segment_plain(tree._walk(), *ref, d, eps, far, 40)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    tree._plain = True
    try:
        pinned = st._route(tree, EPS)
    finally:
        tree._plain = False
    assert not pinned.kernel and pinned.key != route.key
    assert pinned.march.func is ow.walk_segment_plain and pinned.beam.func is ow.walk_beam_plain


def test_eps_above_the_free_margin_takes_the_walk():
    mesh = make_icosphere(subdivisions=2, radius=0.35)
    tree = OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cpu",
                     **dict(CFG, max_depth=4))
    tree.build_query_grid()
    assert st._route(tree, 1e-5).march.func is not ow.walk_segment
    route = st._route(tree, 2 * OctreeSdf._FREE_CELL_MARGIN)
    assert route.kernel and route.march.func is ow.walk_segment
    assert route.beam.func is ow.walk_beam


def test_zero_rays_and_zero_budget(jax_pair):
    _, tree = jax_pair
    walk = tree._walk()
    eps, far = _world(tree)
    empty = _start(torch.zeros(0, 3))
    assert ow.walk_segment(walk, *empty, torch.zeros(0, 3), eps, far, 16) == 0
    assert ow.walk_beam(walk, empty[0], empty[1], empty[3], torch.zeros(0, 3), empty[1],
                        empty[1], 0.01, far, 16) == 0
    assert all(x.shape[0] == 0 for x in empty)
    o, d = _cam(16)
    state = _start(o)
    before = [x.clone() for x in state]
    assert ow.walk_segment(walk, *state, d, eps, far, 0) == 0
    o_c, d_c, r0, rd = _beams(o, d, 16)
    beam = [o_c.clone(), torch.zeros(o_c.shape[0]), torch.ones(o_c.shape[0])]
    beam_before = [x.clone() for x in beam]
    assert ow.walk_beam(walk, *beam, d_c, r0, rd, 0.01, far, 0) == 0
    for a, b in zip(state + beam, before + beam_before):
        assert torch.equal(a, b)


def test_wrappers_reject_bad_inputs(jax_pair):
    _, tree = jax_pair
    walk = tree._walk()
    z = torch.zeros(8)
    pos, dirs, its = torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(8, dtype=torch.int32)
    ow.walk_segment(walk, pos, z.clone(), z.clone(), z.clone(), its, dirs, 1e-5, 4.0, 2)
    for i, wrong in ((0, pos.double()), (1, z[:4]), (4, its.float()), (5, dirs.t()),
                     (3, z.to("meta")), (2, z.view(8, 1))):
        args = [pos, z, z, z, its, dirs]
        args[i] = wrong
        with pytest.raises(ValueError):
            ow.walk_segment(walk, *args, 1e-5, 4.0, 2)
    with pytest.raises(ValueError):               # the walk on another device
        ow.walk_segment(walk._replace(words=walk.words.to("meta")), pos, z, z, z, its, dirs,
                        1e-5, 4.0, 2)
    ow.walk_beam(walk, pos, z.clone(), z.clone(), dirs, z, z, 0.01, 4.0, 2)
    for i, wrong in ((0, pos[:, :2]), (2, z.double()), (4, z[:7]), (5, z.to("meta")),
                     (3, torch.zeros(3, 8).t())):
        args = [pos, z, z, dirs, z, z]
        args[i] = wrong
        with pytest.raises(ValueError):
            ow.walk_beam(walk, *args, 0.01, 4.0, 2)


def _reset():
    ow.segment_launch_count = ow.beam_launch_count = ow.launch_count = 0


def test_cpu_tensors_launch_nothing(jax_pair, monkeypatch):
    _, tree = jax_pair

    def no_build():
        raise AssertionError("a CPU call built the kernels")

    monkeypatch.setattr(build, "library", no_build)
    _reset()
    o, d = _cam(192)                  # 36,864 rays: the pyramid frame
    stats = {}
    res = trace_octree(tree, o, d, eps=EPS, max_iters=64, stats_out=stats)
    trace_octree(tree, o[:500], d[:500], eps=EPS, max_iters=64)     # the dynamic scheduler
    assert bool(res.hit.any())
    assert stats["graphs_captured"] == 0 and stats["host_syncs"] == 0
    assert ow.segment_launch_count == ow.beam_launch_count == ow.launch_count == 0


# -- on the card ---------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module", params=["tricubic", "trilinear"])
def cuda_tree(request):
    _cuda()
    mesh = make_icosphere(subdivisions=3, radius=0.35)
    return OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cuda",
                     interpolation=request.param, **CFG)


@pytest.fixture(scope="module", params=["octree_torus_cpp.bin", "builders_octree_nc.bin"])
def cpp_tree(request):
    _cuda()
    tree = load_sdflib_bin(os.path.join(DATA, request.param), device="cuda")
    assert tree._fast_layout == (request.param == "octree_torus_cpp.bin")
    return tree


def _cam_at(tree, n: int):
    """n^2 camera rays on the card at the structure's sample area, from
    an oblique view (``sdf_render``'s)."""
    area = tree.get_sample_area()
    center = np.asarray(area.center, np.float64)
    cam = Camera(position=center + np.array([0.6, 0.45, 0.9]) * float(np.linalg.norm(area.size)),
                 target=center, fov_y_deg=45.0)
    o, d = cam.rays(n, n)
    return (torch.as_tensor(o.reshape(-1, 3), device="cuda").contiguous(),
            torch.as_tensor(d.reshape(-1, 3), device="cuda").contiguous())


def _inf_rays(o, d, every: int = 97):
    """The rays with every ``every``-th origin infinite: (o, d, which)."""
    o = o.clone()
    which = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    which[::every] = True
    o[which] = torch.inf
    return o, d, which


def _walks(tree):
    walk = tree._walk()
    return [walk, walk._replace(fast=False)] if walk.fast else [walk]


def _k14_against_one_thread(tree):
    o, d = _cam_at(tree, 128)
    eps, far = _world(tree)
    for walk in _walks(tree):
        hit, pos, depth, its = ow.walk_march_one_thread(walk, o, d, eps, far, 256)
        state = _start(o)
        _reset()
        for trips in (8, 16, 32, 200):
            ow.walk_segment(walk, *state, d, eps, far, trips)
        assert ow.segment_launch_count == 4
        assert torch.equal(state[2] <= eps, hit), walk.fast
        assert torch.equal(state[0], pos) and torch.equal(state[1], depth)
        assert torch.equal(state[4], its), walk.fast
        assert bool(hit.any()) and int(its.max()) > 32


@pytest.mark.cuda
def test_k14_split_budgets_equal_one_thread_march(cuda_tree):
    _k14_against_one_thread(cuda_tree)


@pytest.mark.cuda
def test_k14_split_budgets_equal_one_thread_march_cpp(cpp_tree):
    _k14_against_one_thread(cpp_tree)


def _near_plain(got, pure, rays, act: int, box: float):
    """A kernel's state against its plain version over the plain walk on
    ``rays``: active flags (at ``act``) and trip counts agree on >= 99.9%,
    q99 of |depth diff| <= 1e-4 of the box."""
    assert float((got[act][rays] == pure[act][rays]).float().mean()) >= 0.999
    if len(got) == 5:
        assert float((got[4][rays] == pure[4][rays]).float().mean()) >= 0.999
    dd = (got[1][rays] - pure[1][rays]).abs()
    assert float(torch.quantile(dd, 0.99)) <= 1e-4 * box


def _k14_k15_against_plain(tree):
    o, d, inf = _inf_rays(*_cam_at(tree, 128))
    eps, far = _world(tree)
    margin = st._route(tree, EPS).margin
    o_c, d_c, r0, rd = _beams(*_cam_at(tree, 128), 128)
    nt = o_c.shape[0]
    box = float(np.float32(tree.box.size[0]))
    for walk in _walks(tree):
        got, ref, pure = _start(o), _start(o), _start(o)
        ow.walk_segment(walk, *got, d, eps, far, 64)
        ow.walk_segment_plain(walk, *ref, d, eps, far, 64, query=ow.walk_query)
        ow.walk_segment_plain(walk, *pure, d, eps, far, 64)
        finite = torch.isfinite(got[0]).all(-1)
        assert torch.equal(~finite, inf), walk.fast   # only the infinite rays
        for a, b in zip(got, ref):
            assert torch.equal(a[finite], b[finite]), walk.fast
        _near_plain(got, pure, finite, 3, box)
        got = [o_c.clone(), torch.zeros(nt, device="cuda"), torch.ones(nt, device="cuda")]
        ref, pure = [x.clone() for x in got], [x.clone() for x in got]
        _reset()
        ow.walk_beam(walk, *got, d_c, r0, rd, margin, far, 256)
        ow.walk_beam_plain(walk, *ref, d_c, r0, rd, margin, far, 256, query=ow.walk_query)
        ow.walk_beam_plain(walk, *pure, d_c, r0, rd, margin, far, 256)
        assert ow.beam_launch_count == 1
        for a, b in zip(got, ref):
            assert torch.equal(a, b), walk.fast
        _near_plain(got, pure, torch.ones(nt, dtype=torch.bool, device="cuda"), 2, box)
        assert float(got[1].max()) > 0.0


@pytest.mark.cuda
def test_k14_k15_against_plain(cuda_tree):
    _k14_k15_against_plain(cuda_tree)


@pytest.mark.cuda
def test_k14_k15_against_plain_cpp(cpp_tree):
    _k14_k15_against_plain(cpp_tree)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(got, ref) -> bool:
    return all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, ref))


@pytest.fixture(scope="module")
def cubic_rays():
    """(the icosphere's aligned tricubic octree on the card, its walk, the
    walk with about a tenth of its leaf words naming no row, and 9,216
    camera rays: every 97th origin infinite, every 89th NaN, every 83rd
    outside the box looking away)."""
    _cuda()
    mesh = make_icosphere(subdivisions=3, radius=0.35)
    tree = OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cuda", **CFG)
    walk = tree._walk()
    assert walk.fast and walk.num_coeff == 64
    words = walk.words.clone()
    rng = np.random.default_rng(7)
    leaves = torch.nonzero(words < 0)[:, 0].cpu().numpy()
    lost = torch.as_tensor(rng.choice(leaves, len(leaves) // 10, replace=False), device="cuda")
    words[lost] = words[lost] | 0x3FFFFFFF            # a row past the octree's end
    o, d = _cam_at(tree, 96)
    o, d = o.clone(), d.clone()
    o[::97] = torch.inf
    o[::89] = torch.nan
    o[::83] = o[::83] + 4.0 * float(tree.box.size[0])
    d[::83] = -d[::83]
    return tree, walk, walk._replace(words=words), o, d


@pytest.mark.cuda
@pytest.mark.parametrize("form", [8])
def test_k14_group_form_equals_one_thread(cubic_rays, form):
    tree, walk, lost, o, d = cubic_rays
    eps, far = _world(tree)
    _reset()
    for w in (walk, lost):
        for n in (1, 7, 8, 9, 31, 32, 33, 2047, 2048, 8192):
            got, ref = _start(o[:n]), _start(o[:n])
            for trips in (1, 8, 256):
                ow.walk_segment(w, *got, d[:n], eps, far, trips, form=form)
                ow.walk_segment(w, *ref, d[:n], eps, far, trips, form=1)
                assert _same_bits(got, ref), (n, trips, w is lost)
            if n == 8192:
                assert bool((ref[2] <= eps).any()) and bool(ref[0].isnan().any())
                assert bool(ref[0].isinf().any()) and int(ref[4].max()) > 9
    assert ow.segment_launch_count == 2 * 10 * 3 * 2
    with pytest.raises(ValueError):
        ow.walk_segment(walk._replace(fast=False), *_start(o[:8]), d[:8], eps, far, 8,
                        form=form)


def _frame_is_one_graph(tree):
    o, d = _cam_at(tree, 192)
    kw = dict(eps=1e-5, far=4.0, max_iters=1024, beam=4)
    _reset()
    s1, s2 = {}, {}
    first = trace_octree(tree, o, d, stats_out=s1, **kw)
    assert ow.segment_launch_count > 0 and ow.beam_launch_count == 2   # warm-up and capture
    launched = (ow.segment_launch_count, ow.beam_launch_count, ow.launch_count)
    second = trace_octree(tree, o, d, stats_out=s2, **kw)
    assert (ow.segment_launch_count, ow.beam_launch_count, ow.launch_count) == launched
    eager = st._trace(tree, o, d, block_size=None, pyramid=True, stats_out=None, active=None,
                      graphs=False, **kw)
    assert s1["graphs_captured"] == 1 and s1["host_syncs"] == 0
    assert s2["graphs_captured"] == 0 and s2["graphs_replayed"] == 1 and s2["host_syncs"] == 0
    for a, b, c in zip(first, second, eager):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert bool(first.hit.any())
    # the same bits with every launch one thread a ray, as before the forms
    mp = pytest.MonkeyPatch()
    mp.setattr(ow, "segment_form", lambda *a: 1)
    try:
        one = st._trace(tree, o, d, block_size=None, pyramid=True, stats_out=None,
                        active=None, graphs=False, **kw)
    finally:
        mp.undo()
    assert _same_bits(first, one)


@pytest.mark.cuda
def test_walk_frame_is_one_graph(cuda_tree):
    _frame_is_one_graph(cuda_tree)


@pytest.mark.cuda
def test_walk_frame_is_one_graph_cpp(cpp_tree):
    _frame_is_one_graph(cpp_tree)
