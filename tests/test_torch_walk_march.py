"""K12's persistent warps (``sdflib_tpu_torch/ops/walk.py`` ``walk_march``,
``csrc/octree_walk.cu`` ``walk_march_warps_kernel``).

On the CPU:

* a numpy model of the warps' loop, with the kernel's own constants read
  from the source (``kMarchChunk`` rays a chunk, ``kThreads`` a block):
  warps that run their trips in a seeded random order share one ray
  counter; a warp takes a chunk of consecutive rays when its chunk is
  spent and hands the chunk's next rays to its lanes without a ray, in
  lane order, after every trip. Over many batch sizes, trip patterns
  (every ray 0 trips, as ``max_iters`` <= 0 leaves it; 1; random; heavy
  tails; one long ray), numbers of warps and fetch orders (ray order,
  8 x 4 tiles of an image), every ray is taken exactly once and takes
  exactly its trips, and the counter ends at or past the batch; the tile
  order only for an image of whole tiles;
* ``walk_march`` on CPU tensors is ``sphere_trace`` over the plain walk,
  bit for bit (NaN where both are NaN), with NaN and infinite origins,
  rays outside the box and ``max_iters`` 0, 1 and 96, on the port's own
  icosphere octree (tricubic and trilinear, built on the CPU);
* the one-thread reference refuses CPU tensors, a negative width raises,
  and a width changes nothing on the CPU;
* the quad-at-a-time fold (``leaf_eval.cuh`` ``tricubic_quads``) replayed
  in numpy float32 equals ``Tree<0, 32>``'s order bit for bit.

On a card (``python -m pytest --noconftest -m cuda
tests/test_torch_walk_march.py``; no JAX here): the persistent warps
equal ``walk_march_one_thread`` (one thread a ray) in hit, position,
depth and trips bit for bit, and themselves from run to run, on both
interpolations and both layouts, for 0, 1, 31, 33, 1,000 (fewer than the
warps' slots), 5,003 (not a multiple of a block), 65,539 and 262,149
rays in ray order and images of 64 x 32, 256 x 256 and 512 x 512 rays
in 8 x 4 tiles (1,000 rays named 8 a row: no whole tiles, ray order),
with NaN and infinite origins and rays that leave the box, at
``max_iters`` 0, 1 and 256; ``march_launch_count`` rises by one a call
with rays (none without); the warps' slot-trips cover the rays' trips;
``render_depth_diff`` of an image of rays equals that of the same rays
flattened, depths, hits and gradient, bit for bit.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdflib_tpu_torch import OctreeSdf
from sdflib_tpu_torch.kernels import build
from sdflib_tpu_torch.ops import walk as ow
from sdflib_tpu_torch.render.sphere_trace import sphere_trace
from sdflib_tpu_torch.utils.primitives import make_icosphere

torch.set_num_threads(1)
CFG = dict(termination_threshold=1e-3, start_depth=1, init_algorithm="no_continuity")
_SRC = (Path(build.__file__).parent.parent / "csrc" / "octree_walk.cu").read_text()


def _constexpr(name: str) -> int:
    return int(re.search(r"constexpr int " + name + r" = (\d+);", _SRC).group(1))


CHUNK = _constexpr("kMarchChunk")
THREADS = _constexpr("kThreads")


def _ray_at(k: int, width: int) -> int:
    """``ray_at``: the counter's k-th fetch in ray order, or in 8 x 4 pixel
    tiles of an image ``width`` rays a row."""
    if width <= 0:
        return k
    tile, e, across = k >> 5, k & 31, width // 8
    return ((tile // across) * 4 + (e >> 3)) * width + (tile % across) * 8 + (e & 7)


def _model(trips, resident: int, seed: int, width: int = 0):
    """The persistent warps' loop over rays that take ``trips`` trips each
    (0: none, as ``max_iters`` <= 0), ``resident`` blocks at most, warps
    stepped in a seeded random order, fetched in ray order or (``width``)
    in 8 x 4 tiles: (times each ray was taken, trips each ray took, the
    counter at the end, the warps' trips)."""
    n = len(trips)
    rng = np.random.default_rng(seed)
    nw = min(resident, -(-n // THREADS)) * (THREADS // 32)
    counter = 0
    taken = np.zeros(n, np.int64)
    took = np.zeros(n, np.int64)
    ray = np.full((nw, 32), -1)
    left = np.zeros((nw, 32), np.int64)
    nxt, end = np.zeros(nw, np.int64), np.zeros(nw, np.int64)
    more = np.ones(nw, bool)
    alive = list(range(nw))
    warp_trips = 0
    while alive:
        w = alive[rng.integers(len(alive))]
        idle = ray[w] < 0
        while idle.any() and more[w]:
            if nxt[w] == end[w]:
                first, counter = counter, counter + CHUNK
                if first >= n:
                    more[w] = False
                    break
                nxt[w], end[w] = first, min(first + CHUNK, n)
            take = min(int(idle.sum()), int(end[w] - nxt[w]))
            rank = np.cumsum(idle) - 1
            for lane in np.nonzero(idle & (rank < take))[0]:
                r = _ray_at(int(nxt[w] + rank[lane]), width)
                taken[r] += 1
                if trips[r] > 0:
                    ray[w, lane], left[w, lane] = r, trips[r]
            nxt[w] += take
            idle = ray[w] < 0
        live = ray[w] >= 0
        if not live.any():
            alive.remove(w)
            continue
        warp_trips += 1
        took[ray[w, live]] += 1
        left[w, live] -= 1
        ray[w, live & (left[w] == 0)] = -1
    return taken, took, counter, warp_trips


def _pattern(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros(n, np.int64)
    if kind == "one":
        return np.ones(n, np.int64)
    if kind == "uniform":
        return rng.integers(1, 40, n)
    if kind == "tail":   # most rays short, a few very long (grazing rays)
        return np.where(rng.random(n) < 0.02, rng.integers(100, 160, n), rng.integers(1, 12, n))
    t = np.ones(n, np.int64)    # one long ray
    t[n // 2] = 500
    return t


@pytest.mark.parametrize("n,kind,resident,width", [
    (1, "one", 4, 0), (31, "uniform", 4, 0), (33, "tail", 4, 0), (CHUNK, "one", 1, 0),
    (CHUNK + 1, "zero", 1, 0), (1000, "uniform", 1, 0), (1000, "tail", 4, 0), (3000, "tail", 1, 0),
    (2 * THREADS + 7, "long", 2, 0), (5003, "zero", 2, 0), (4096, "uniform", 100, 0),
    (32, "one", 1, 8), (2048, "tail", 1, 64), (4096, "uniform", 2, 16), (3072, "long", 4, 256),
    (1024, "zero", 1, 32),
])
def test_refill_model_takes_every_ray_once(n, kind, resident, width):
    trips = _pattern(kind, n, n)
    taken, took, counter, warp_trips = _model(trips, resident, seed=n + resident, width=width)
    assert (taken == 1).all()
    assert np.array_equal(took, trips)
    assert counter >= n
    assert 32 * warp_trips >= int(trips.sum())
    if trips.sum():
        assert warp_trips >= int(trips.max())


def test_refill_keeps_lanes_busy():
    """On a heavy-tailed pattern the refilled warps take far fewer trips
    than warps of one thread a ray (each lives as long as its longest
    ray)."""
    n = 8192
    trips = _pattern("tail", n, 7)
    one_thread = int(trips.reshape(-1, 32).max(1).sum())
    _, _, _, warp_trips = _model(trips, 1, seed=7)
    assert warp_trips < 0.6 * one_thread


_TREES = {}


def _tree(interpolation):
    if interpolation not in _TREES:
        mesh = make_icosphere(subdivisions=2, radius=0.35)
        _TREES[interpolation] = OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cpu",
                                          interpolation=interpolation, max_depth=4, **CFG)
    return _TREES[interpolation]


def _walk(p, fast):
    words = p._octree_dev
    return ow.Walk(words, words.view(torch.float32), p._box_min, p._box_size3,
                   float(p.min_border_value), p.start_grid_size, p.max_depth - p.start_depth,
                   p.num_coefficients, p.interpolation, fast)


def _rays(p, n: int, seed: int):
    """n rays (seed): origins over the box widened by 0.3 of its size on
    each side, unit directions; the first ones NaN and infinite origins,
    rays that start outside the box and point away, and one that starts
    inside."""
    lo, hi = np.asarray(p.box.min, np.float64), np.asarray(p.box.max, np.float64)
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mid = 0.5 * (lo + hi)
    edge = [([np.nan, 0, 0], [0, 0, 1]), ([np.inf, 0, 0], [1, 0, 0]),
            ([0, -np.inf, 0], [0, 1, 0]), ([0, 0, 0], [np.nan, 0, 0]),
            (hi + 0.2, [1, 0, 0]), (lo - 0.2, [-0.6, -0.8, 0]), (mid, [0, 0, 1])]
    for k, (a, b) in enumerate(edge[:n]):
        o[k], d[k] = a, b
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("interpolation", ["tricubic", "trilinear"])
@pytest.mark.parametrize("max_iters", [0, 1, 96])
def test_cpu_march_is_sphere_trace_over_the_walk(interpolation, max_iters):
    p = _tree(interpolation)
    o, d = (torch.as_tensor(x) for x in _rays(p, 300, 5))
    size = np.float32(p.box.size[0])
    eps, far = float(np.float32(1e-4) * size), float(np.float32(4.0) * size)
    ow.march_launch_count = 0
    got = ow.walk_march(_walk(p, True), o, d, eps, far, max_iters)
    assert ow.march_launch_count == 0
    ref = sphere_trace(lambda q: p.get_distance(q), o, d, eps=eps, far=far, max_iters=max_iters)
    for a, b in zip(got[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert got[3].dtype == torch.int32 and got[3].shape == (300,)
    assert int(got[3].max()) == int(ref[3])
    if max_iters == 0:
        assert int(got[3].sum()) == 0 and not bool(got[0].any())


def test_one_thread_reference_needs_a_card():
    p = _tree("tricubic")
    o, d = (torch.as_tensor(x) for x in _rays(p, 8, 6))
    with pytest.raises(ValueError):
        ow.walk_march_one_thread(_walk(p, True), o, d, 1e-4, 1.0, 8)


@pytest.mark.parametrize("n,width,tiles", [
    (2048, 64, 64), (32, 8, 8), (0, 8, 8), (1000, 8, 0), (96, 12, 0), (64, 16, 16), (4096, 0, 0),
    (4096, 4096, 0), (2048, 128, 128), (48, 16, 0), (2040, 8, 0),
])
def test_tile_width(n, width, tiles):
    """The warps fetch 8 x 4 tiles only of an image of whole tiles."""
    assert ow._tile_width(n, width) == tiles


def test_march_width_checks_and_changes_nothing():
    p = _tree("tricubic")
    o, d = (torch.as_tensor(x) for x in _rays(p, 64, 7))
    w = _walk(p, True)
    with pytest.raises(ValueError):
        ow.walk_march(w, o, d, 1e-4, 1.0, 8, width=-8)
    a, b = ow.walk_march(w, o, d, 1e-4, 1.0, 8, width=8), ow.walk_march(w, o, d, 1e-4, 1.0, 8)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module", params=["tricubic", "trilinear"])
def cuda_tree(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_icosphere(subdivisions=2, radius=0.35)
    return OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cuda",
                     interpolation=request.param, max_depth=5, **CFG)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("n,width", [
    (0, 0), (1, 0), (31, 0), (33, 0), (1000, 0), (1000, 8), (5003, 0), ((1 << 16) + 3, 0),
    ((1 << 18) + 5, 0), (2048, 64), (1 << 16, 256), (1 << 18, 512),
])
@pytest.mark.parametrize("max_iters", [0, 1, 256])
def test_warps_equal_one_thread(cuda_tree, fast, n, width, max_iters):
    w = _walk(cuda_tree, fast)
    o, d = (torch.as_tensor(x, device="cuda") for x in _rays(cuda_tree, n, n + 11))
    size = np.float32(cuda_tree.box.size[0])
    eps, far = float(np.float32(1e-4) * size), float(np.float32(4.0) * size)
    ow.march_launch_count = 0
    got = ow.walk_march(w, o, d, eps, far, max_iters, width=width)
    again = ow.walk_march(w, o, d, eps, far, max_iters, width=width)
    assert ow.march_launch_count == (2 if n else 0)
    ref = ow.walk_march_one_thread(w, o, d, eps, far, max_iters)
    assert ow.march_launch_count == (2 if n else 0)
    for a, b, c in zip(got, again, ref):
        assert torch.equal(_bits(a), _bits(c))
        assert torch.equal(_bits(a), _bits(b))
    if n and max_iters:
        assert int(got[3].min()) >= 1 and int(got[3].max()) <= max_iters
    if max_iters == 0:
        assert int(got[3].sum()) == 0


@pytest.mark.cuda
def test_slot_trips_cover_the_rays_trips(cuda_tree):
    w = _walk(cuda_tree, True)
    n = (1 << 16) + 3
    o, d = (torch.as_tensor(x, device="cuda") for x in _rays(cuda_tree, n, 12))
    size = np.float32(cuda_tree.box.size[0])
    stats = torch.zeros(1, dtype=torch.int64, device="cuda")
    its = ow._launch_march(w, o, d, float(np.float32(1e-4) * size),
                           float(np.float32(4.0) * size), 256, 0, stats=stats)[3]
    useful = int(its.sum())
    assert 0 < useful <= 32 * int(stats.item())


def _powers(f):
    one = np.ones_like(f[:, 0])
    return [np.stack([one, a, a * a, a * a * a], 1) for a in f.T]


def _tree_order(c, f):
    """``leaf_eval.cuh`` ``tricubic<false>`` in float32: lane t adds terms
    t and t + 32, then a pairwise tree over the 32 lanes."""
    xv, yv, zv = _powers(f)
    lanes = []
    for t in range(32):
        i, j, k = t & 3, (t >> 2) & 3, t >> 4
        xy = xv[:, i] * yv[:, j]
        lanes.append(c[:, t] * (xy * zv[:, k]) + c[:, t + 32] * (xy * zv[:, k + 2]))

    def tree(lo, n):
        return lanes[lo] if n == 1 else tree(lo, n // 2) + tree(lo + n // 2, n // 2)

    return tree(0, 32)


def _quad_order(c, f):
    """``tricubic_quads<false>`` in float32: quad q from coefficients 4q..4q+3
    and 4q+32..4q+35 (``quad_sum``), the quads as a pairwise tree."""
    xv, yv, zv = _powers(f)

    def quad(q):
        y = yv[:, q & 3]
        z0, z1 = (zv[:, 1], zv[:, 3]) if q >> 2 else (zv[:, 0], zv[:, 2])
        s = []
        for i in range(4):
            xy = xv[:, i] * y
            s.append(c[:, 4 * q + i] * (xy * z0) + c[:, 32 + 4 * q + i] * (xy * z1))
        return (s[0] + s[1]) + (s[2] + s[3])

    return ((quad(0) + quad(1)) + (quad(2) + quad(3))) + ((quad(4) + quad(5)) + (quad(6) + quad(7)))


def test_quad_fold_is_the_tree_order():
    """The quad-at-a-time fold adds the same products in the same order as
    ``Tree<0, 32>``: bit-equal on random rows and positions in [0, 1)."""
    rng = np.random.default_rng(20)
    c = rng.normal(0, 1, (4096, 64)).astype(np.float32)
    c[::7] *= np.float32(1e4)
    f = rng.random((4096, 3), dtype=np.float32)
    f[:8] = [[0, 0, 0], [0.5, 0.5, 0.5], [np.float32(1 - 2**-24)] * 3, [0.25, 0.75, 0.125],
             [1e-30, 0, 0], [0, 1e-8, 0.9999], [0.1, 0.2, 0.3], [0.999, 0.001, 0.5]]
    with np.errstate(over="ignore"):
        a, b = _tree_order(c, f), _quad_order(c, f)
    assert a.dtype == np.float32 and b.dtype == np.float32
    assert np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.cuda
def test_image_rays_render_as_flat_rays(cuda_tree):
    """``render_depth_diff`` of rays given as an image (the warps take 8 x
    4 tiles) and of the same rays flattened (ray order): the same depths,
    hits and coefficient gradient, bit for bit."""
    from sdflib_tpu_torch.diff.query import octree_coefficients
    from sdflib_tpu_torch.diff.render import render_depth_diff

    t = cuda_tree
    n = 128
    u = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    gu, gv = np.meshgrid(0.6 * u, 0.6 * u)
    o = torch.as_tensor(np.stack([gu, gv, np.full_like(gu, -1.0)], -1).astype(np.float32),
                        device="cuda")
    d = torch.zeros_like(o)
    d[..., 2] = 1.0
    args = (np.asarray(t.box.min, np.float32), np.float32(t.box.size[0]), t.start_grid_size,
            np.float32(t.min_border_value))
    kw = dict(levels=t.max_depth - t.start_depth, num_coeff=t.num_coefficients,
              interpolation=t.interpolation)
    out = []
    for oo, dd in ((o, d), (o.reshape(-1, 3), d.reshape(-1, 3))):
        c = octree_coefficients(t._octree_dev).requires_grad_(True)
        depth, hit = render_depth_diff(t._octree_dev, c, oo, dd, *args, **kw)
        (g,) = torch.autograd.grad(depth.sum(), c)
        out.append((depth.detach().reshape(-1), hit.reshape(-1), g))
    assert int(out[0][1].sum()) > 0
    for a, b in zip(*out):
        assert torch.equal(_bits(a), _bits(b))
