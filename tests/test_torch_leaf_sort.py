"""The leaf sort (``ops/exact_query.py`` ``leaf_sort``): K8's key and a
stable sort by it, as one radix sort over the leaf ids' bits.

On the CPU, against the JAX package, on the torus fixture of
test_torch_exact_query.py (nu=20, nv=12, max_depth 4), built by the port
and loaded into the JAX package from its ``.npz`` container:

* ``leaf_sort_plain``'s sorted keys and order equal the JAX package's
  ``_exact_descent_grid`` followed by its multi-operand ``lax.sort``
  (sdflib_tpu/sdf/exact_octree.py:934-941) on 3,000 points inside the
  box, on its cells' faces and outside it; the coordinates it carries are
  the points in the port's order.
* The given-keys form sorts the node walk's keys as ``torch.sort`` does,
  and the structure's ``_sort_by_leaf`` takes the plain versions on the
  CPU with and without the dense grid.
* ``_digit_plan`` splits the bits of L leaves into the fewest digits of at
  most 11 bits that sum to them; the wrappers reject bad arguments and
  launch nothing for CPU tensors.

On a CUDA device (skipped here; ``pytest --noconftest -m cuda``): the
kernel ``torch.equal`` to the plain version for P of 0, 1, 255, 256, 257,
a tile +-1 and 2^20 + 3 points against grids of L = 1, 2, 513, 2^18 and
2^21 + 1 leaves, with points outside the box and NaN among them, through
the public wrapper and the lean launch, in both modes; every point in one
leaf; keys in descending order; the node walk's keys; the query launching
the sort once and ``torch.sort`` never.

JAX is imported inside the tests: the GPU machine has no JAX.
"""
import numpy as np
import pytest
import torch

from sdflib_tpu_torch import ExactOctreeSdf
from sdflib_tpu_torch.kernels import build
from sdflib_tpu_torch.ops import exact_query as eq
from sdflib_tpu_torch.utils.primitives import make_torus

torch.set_num_threads(1)
CFG = dict(max_depth=4, start_depth=1, min_triangles_per_node=16)


def _mesh_box():
    mesh = make_torus(R=0.3, r=0.12, nu=20, nv=12)
    return mesh, mesh.bounding_box.add_margin(0.1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(the JAX package's structure, the port's): the port's build loaded
    into the JAX package, so both hold the same leaves."""
    from sdflib_tpu.sdf.sdf_function import SdfFunction as JSdfFunction

    p = ExactOctreeSdf(*_mesh_box(), **CFG, device="cpu")
    path = str(tmp_path_factory.mktemp("leaf_sort") / "torus.npz")
    p.save(path)
    return JSdfFunction.load(path), p


def _points(box, n: int = 3000, seed: int = 3) -> np.ndarray:
    """``n`` points: half inside the box, a quarter on its depth-4 cells'
    faces, a quarter outside it."""
    rng = np.random.default_rng(seed)
    lo, size = np.asarray(box.min, np.float32), np.float32(box.size[0])
    inside = rng.uniform(0.0, 1.0, (n // 2, 3))
    on_faces = np.round(rng.uniform(0.0, 1.0, (n // 4, 3)) * 16) / 16
    outside = rng.uniform(-0.6, 1.6, (n - n // 2 - n // 4, 3))
    rel = np.concatenate([inside, on_faces, outside]).astype(np.float32)
    return lo + rel * size


def test_leaf_sort_plain_matches_jax(pair):
    import jax
    import jax.numpy as jnp
    from sdflib_tpu.sdf.exact_octree import _exact_descent_grid

    j, p = pair
    pts = _points(p.box)
    leaf, _ = _exact_descent_grid(j._leaf_grid, jnp.asarray(pts), jnp.asarray(j.box.min),
                                  jnp.float32(j.box.size[0]), grid_depth=j.max_depth)
    iota = jnp.arange(pts.shape[0], dtype=jnp.int32)
    lid_j, xs, ys, zs, order_j = jax.lax.sort(
        (leaf, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), jnp.asarray(pts[:, 2]), iota),
        num_keys=1)
    t = torch.as_tensor(pts)
    lid_s, order = eq.leaf_sort_plain(t, p._leaf_grid, p._box_min, p._box_size3, p.max_depth)
    assert lid_s.dtype == torch.int32 and order.dtype == torch.int64
    np.testing.assert_array_equal(lid_s.numpy(), np.asarray(lid_j))
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(t[order].numpy(), np.stack([xs, ys, zs], axis=-1))
    # the structure's own sort takes the plain version on the CPU
    got = p._sort_by_leaf(t)
    assert torch.equal(got[0], lid_s) and torch.equal(got[1], order)


def test_given_keys_sort_the_walk(pair):
    _, p = pair
    walk = ExactOctreeSdf.from_jax_state(p._state_arrays(), device="cpu")
    walk._leaf_grid = None                       # the node walk's keys
    pts = torch.as_tensor(_points(p.box, 3000, 5))
    keys = walk._leaf_keys(pts)
    assert keys.dtype == torch.int32 and int(keys.max()) < walk.num_leaves
    want = torch.sort(keys, stable=True)
    for got in (eq.leaf_sort_plain(keys), eq.leaf_sort(keys, None, None, None, 0,
                                                        eq.sort_bits(walk.num_leaves)),
                walk._sort_by_leaf(pts)):
        assert torch.equal(got[0], want.values) and torch.equal(got[1], want.indices)


@pytest.mark.parametrize("L", [1, 2, 512, 513, 145_636, 2_052_765, 1 << 30])
def test_digit_plan(L):
    bits = eq.sort_bits(L)
    assert bits == max(1, (L - 1).bit_length())
    assert (1 << bits) >= L and (bits == 1 or (1 << (bits - 1)) < L)
    widths = eq._digit_plan(bits)
    assert sum(widths) == bits
    assert all(1 <= w <= eq.MAX_DIGIT for w in widths)
    assert len(widths) == -(-bits // eq.MAX_DIGIT)              # the fewest passes
    assert max(widths) - min(widths) <= 1
    want = {1: (1,), 2: (1,), 512: (9,), 513: (10,), 145_636: (9, 9),
            2_052_765: (11, 10), 1 << 30: (10, 10, 10)}[L]
    assert widths == want


def test_cpu_tensors_launch_nothing(pair, monkeypatch):
    def no_build():
        raise AssertionError("a CPU call built the kernels")

    _, p = pair
    monkeypatch.setattr(build, "library", no_build)
    eq.sort_launch_count = 0
    pts = torch.as_tensor(_points(p.box, 500))
    args = (pts, p._leaf_grid, p._box_min, p._box_size3, p.max_depth)
    got = eq.leaf_sort(*args, eq.sort_bits(p.num_leaves))
    want = eq.leaf_sort_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    p.get_distance(pts)
    assert eq.sort_launch_count == 0


def test_leaf_sort_rejects_bad_inputs(pair):
    _, p = pair
    pts = torch.as_tensor(_points(p.box, 40))
    grid, depth = p._leaf_grid, p.max_depth
    bm, bs = p._box_min, p._box_size3
    bits = eq.sort_bits(p.num_leaves)
    for args in ((pts.double(), grid, bm, bs, depth, bits), (pts[:, :2], grid, bm, bs, depth, bits),
                 (pts, grid, bm, bs, depth + 1, bits), (pts, grid.long(), bm, bs, depth, bits),
                 (pts, grid, bm[:2], bs, depth, bits), (pts, grid, bm, bs, depth, 0),
                 (pts, grid, bm, bs, depth, 32), (pts, grid, bm, bs, depth, 2.0),
                 (pts, None, None, None, 0, bits),                  # points as keys
                 (torch.zeros(8, dtype=torch.int64), None, None, None, 0, bits),
                 (pts.to("meta"), grid.to("meta"), bm.to("meta"), bs.to("meta"), depth, bits)):
        with pytest.raises(ValueError):
            eq.leaf_sort(*args)


# -- on the card ---------------------------------------------------------------

SIZES = [0, 1, 255, 256, 257, eq.SORT_TILE - 1, eq.SORT_TILE, eq.SORT_TILE + 1, (1 << 20) + 3]
LEAVES = [1, 2, 513, 1 << 18, (1 << 21) + 1]
BOX_MIN = (-0.25, 0.5, -1.0)
BOX_SIZE = 2.0


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _grid_case(P: int, L: int, seed: int, dev):
    """A grid of leaf ids below L (every id up to L - 1 present where the
    grid has room), 8^depth cells, and P points over 1.2x the box with
    every 97th outside it and every 101st coordinate NaN."""
    rng = np.random.default_rng(seed)
    depth = 7 if L > 8 ** 5 else 5
    cells = 8 ** depth
    grid = rng.integers(0, L, cells).astype(np.int32)
    grid[rng.permutation(cells)[: min(L, cells)]] = np.arange(min(L, cells)) * (L // min(L, cells))
    grid[0] = L - 1
    pts = (np.asarray(BOX_MIN, np.float32)
           + rng.uniform(-0.1, 1.1, (P, 3)).astype(np.float32) * np.float32(BOX_SIZE))
    pts[::97] *= np.float32(40.0)
    pts.reshape(-1)[::101] = np.nan
    box_min = torch.tensor(BOX_MIN, dtype=torch.float32, device=dev)
    box_size3 = torch.full((3,), BOX_SIZE, dtype=torch.float32, device=dev)
    return (torch.as_tensor(pts, device=dev), torch.as_tensor(grid, device=dev), box_min,
            box_size3, depth)


def _equal(got, want) -> bool:
    return (got[0].dtype == torch.int32 and got[1].dtype == torch.int64
            and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("L", LEAVES)
@pytest.mark.parametrize("P", SIZES)
def test_kernel_against_plain(card, P, L):
    """Both modes, public and lean, at every size against every grid."""
    pts, grid, box_min, box_size3, depth = _grid_case(P, L, P + L, card)
    bits = eq.sort_bits(L)
    want = eq.leaf_sort_plain(pts, grid, box_min, box_size3, depth)
    box = (*BOX_MIN, BOX_SIZE, BOX_SIZE, BOX_SIZE)
    before = eq.sort_launch_count
    assert _equal(eq.leaf_sort(pts, grid, box_min, box_size3, depth, bits), want)
    assert _equal(eq.launch_leaf_sort(pts, grid, box, depth, bits), want)
    assert eq.sort_launch_count - before == (2 if P else 0)
    keys = eq.exact_descend_plain(pts, grid, box_min, box_size3, depth)
    want_k = eq.leaf_sort_plain(keys)
    assert _equal(eq.leaf_sort(keys, None, None, None, 0, bits), want_k)
    assert _equal(eq.launch_leaf_sort(keys, None, None, 0, bits), want_k)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["one leaf", "descending"])
def test_kernel_one_leaf_and_descending(card, order):
    P, L = (1 << 20) + 3, (1 << 21) + 1
    bits = eq.sort_bits(L)
    if order == "one leaf":
        pts, grid, box_min, box_size3, depth = _grid_case(P, L, 7, card)
        grid.fill_(L // 3)
        want = eq.leaf_sort_plain(pts, grid, box_min, box_size3, depth)
        got = eq.leaf_sort(pts, grid, box_min, box_size3, depth, bits)
        assert _equal(got, want) and bool((got[0] == L // 3).all())
        keys = torch.full((P,), L - 1, dtype=torch.int32, device=card)
    else:
        keys = (L - 1 - torch.arange(P, device=card) % L).to(torch.int32)
    assert _equal(eq.leaf_sort(keys, None, None, None, 0, bits), eq.leaf_sort_plain(keys))


@pytest.mark.cuda
def test_query_sorts_by_the_kernel(card, monkeypatch):
    """The query over the dense grid and over the node walk: the sort
    launched once a query, ``torch.sort`` never, the answers equal to the
    query with the plain versions."""
    sdf = ExactOctreeSdf(*_mesh_box(), **CFG, device=card)
    walk = ExactOctreeSdf(*_mesh_box(), **CFG, device=card)
    walk._leaf_grid = None
    pts = torch.as_tensor(_points(sdf.box, 30_000, 9), device=card)
    for s in (sdf, walk):
        keys = s._leaf_keys(pts)
        want = eq.leaf_sort_plain(keys)
        assert _equal(eq.launch_leaf_sort(keys, None, None, 0, eq.sort_bits(s.num_leaves)), want)
        for impl in ("xla", "xla_window"):
            s.set_scan_impl(impl)
            d_p = s._query(pts, False, plain_glue=True)

            def no_sort(*args, **kw):
                raise AssertionError("the query called torch.sort")

            with monkeypatch.context() as m:
                m.setattr(torch, "sort", no_sort)
                before = eq.sort_launch_count
                d = s.get_distance(pts)
                assert eq.sort_launch_count - before == 1
            assert torch.equal(d, d_p)
        s._default_scan_impl()


@pytest.mark.cuda
def test_a_refused_sort_raises(card):
    pts = torch.zeros((64, 3), device=card)
    grid = torch.zeros(8, dtype=torch.int32, device=card)
    lid_s = torch.empty(64, dtype=torch.int32, device=card)
    order = torch.empty(64, dtype=torch.int64, device=card)
    work = torch.empty(eq._sort_words(64, 1, False), dtype=torch.int32, device=card)
    ok = (pts.data_ptr(), None, 64, grid.data_ptr(), 1, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1, 1,
          work.data_ptr(), work.numel(), lid_s.data_ptr(), order.data_ptr())
    build.launch("sdf_leaf_sort", card, *ok)
    for at, bad in ((11, 0), (11, 32), (4, 11), (14, work.numel() - 1), (2, -1)):
        args = list(ok)
        args[at] = bad
        with pytest.raises(RuntimeError, match="failed to launch"):
            build.launch("sdf_leaf_sort", card, *args)
