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
  most 8 bits that sum to them; ``_sort_words`` holds the entry's scratch
  layout; a numpy replay of the onesweep passes (tiles, the early counts,
  the look-back's sums, the rank order within a tile) is a stable sort
  at the tile's edges and at 1 to 31 bits; the wrappers reject bad
  arguments and launch nothing for CPU tensors.

On a CUDA device (skipped here; ``pytest --noconftest -m cuda``): the
kernel ``torch.equal`` to the plain version for P of 0, 1, 255, 256, 257,
a tile +-1 and 2^20 + 3 points against grids of L = 1, 2, 513, 2^18 and
2^21 + 1 leaves, with points outside the box and NaN among them, through
the public wrapper and the lean launch, in both modes; every point in one
leaf; keys in descending order; the node walk's keys; keys of 1, 7, 8,
9, 12, 21 and 31 bits at the tile's edges in both modes; K11's 2^22 keys
of 12 bits; the query launching the sort once and ``torch.sort`` never.

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


# L -> the digit widths: the fewest passes of at most 8 bits (a bin a thread
# of a 256-thread block), as even as can be, the first ones wider
PLANS = {1: (1,), 2: (1,), 256: (8,), 257: (5, 4), 512: (5, 4), 513: (5, 5),
         4096: (6, 6), 145_636: (6, 6, 6), 2_052_765: (7, 7, 7), 1 << 30: (8, 8, 7, 7),
         1 << 31: (8, 8, 8, 7)}


@pytest.mark.parametrize("L", list(PLANS))
def test_digit_plan(L):
    bits = eq.sort_bits(L)
    assert bits == max(1, (L - 1).bit_length())
    assert (1 << bits) >= L and (bits == 1 or (1 << (bits - 1)) < L)
    widths = eq._digit_plan(bits)
    assert sum(widths) == bits
    assert all(1 <= w <= eq.MAX_DIGIT for w in widths)
    assert len(widths) == -(-bits // eq.MAX_DIGIT)              # the fewest passes
    assert max(widths) - min(widths) <= 1 and list(widths) == sorted(widths, reverse=True)
    assert widths == PLANS[L]


def _layout(P: int, bits: int, given: bool) -> dict:
    """``sdf_leaf_sort``'s scratch layout in int32 words, as the entry
    computes it: the state (head, then every pass's status words a tile,
    rounded up to 4), the computed keys, and each pass's key and value
    buffers (two pairs taken in turns; the last pass writes the outputs)."""
    widths = eq._digit_plan(bits)
    tiles = -(-P // eq.SORT_TILE)
    state = eq._round4(eq._STATE_HEAD + tiles * sum(1 << w for w in widths))
    Pp = eq._round4(P)
    buf = state + (0 if given else Pp)
    out = {"state": state, "keys": None if given else state, "passes": []}
    for p in range(len(widths) - 1):
        k = buf + 2 * (p % 2) * Pp
        out["passes"].append((k, k + Pp))
    ends = [state + (0 if given else Pp)] + [v + Pp for _, v in out["passes"]]
    out["end"] = max(ends)
    return out


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("bits", [1, 7, 8, 9, 12, 18, 21, 31])
def test_sort_words_hold_the_layout(bits, given):
    """``_sort_words`` is the scratch the entry needs: every buffer starts
    16-byte aligned, none overlaps the state or the buffer it reads, and
    the words end where the last buffer does."""
    assert eq._STATE_HEAD == 4 * 256 + 1 + 4 + 3 and eq._STATE_HEAD % 4 == 0
    for P in (1, 3, 4, 5, eq.SORT_TILE - 1, eq.SORT_TILE, eq.SORT_TILE + 1, 1_000_003):
        lay = _layout(P, bits, given)
        assert eq._sort_words(P, bits, given) == lay["end"]
        starts = [lay["state"]] + [w for kv in lay["passes"] for w in kv]
        assert all(w % 4 == 0 for w in starts)
        Pp = eq._round4(P)
        for p, (k, v) in enumerate(lay["passes"]):
            assert k >= lay["state"] + (0 if given else Pp) and v == k + Pp
            if p:                           # never writes the buffer it reads
                assert abs(k - lay["passes"][p - 1][0]) >= 2 * Pp


# -- a numpy replay of the onesweep passes ------------------------------------------

WARPS, ITEMS = 8, eq.SORT_TILE // 256          # csrc/exact_descend.cu kSortWarps, kSortItems


def _replay_pass(keys, vals, shift: int, width: int, first):
    """One digit pass as ``leaf_sort_pass_kernel`` takes it, tile by tile
    in the order the tiles take their indices: the early counts (one
    atomic a key, before the ranking), the published counts summed over
    the earlier tiles (the look-back), each
    warp's ranks in index order (a running count of each digit a warp,
    plus the lanes below in the step that share the digit), each digit's
    first place in the tile and each warp's among its keys, and the
    scatter from the tile in sorted order. Returns (keys, vals) out."""
    P, R = len(keys), 1 << width
    out_k, out_v = np.full(P, -1, np.int64), np.full(P, -1, np.int64)
    published = np.zeros(R, np.int64)                # every earlier tile's counts
    digit = (keys >> shift) & (R - 1)
    for base in range(0, P, eq.SORT_TILE):
        n = min(eq.SORT_TILE, P - base)
        d = digit[base: base + n]
        hist = np.zeros(R, np.int64)
        np.add.at(hist, d, 1)                                      # the early counts
        warp_count = np.zeros((WARPS, R), np.int64)
        rank = np.zeros(n, np.int64)
        for w in range(WARPS):
            for k in range(ITEMS):
                i = w * 32 * ITEMS + 32 * k + np.arange(32)
                live = i < n
                if not live.any():
                    continue
                dd = d[i[live]]
                same = dd[:, None] == dd[None, :]
                leader = np.argmax(same, axis=1)
                below = np.tril(same, -1).sum(1)
                lead = leader == np.arange(len(dd))
                rank[i[live]] = warp_count[w, dd] + below
                np.add.at(warp_count[w], dd[lead], same[lead].sum(1))
        assert np.array_equal(hist, warp_count.sum(0))
        before = published.copy()                                  # the look-back
        published += hist
        tile_first = np.concatenate([[0], np.cumsum(hist)[:-1]])
        warp_first = tile_first + np.concatenate(
            [np.zeros((1, R), np.int64), np.cumsum(warp_count, 0)[:-1]])
        at_tile = warp_first[(np.arange(n) // (32 * ITEMS)), d] + rank
        assert np.array_equal(np.sort(at_tile), np.arange(n))
        sk, sv = np.empty(n, np.int64), np.empty(n, np.int64)
        sk[at_tile], sv[at_tile] = keys[base: base + n], vals[base: base + n]
        place = first + before - tile_first
        at = place[(sk >> shift) & (R - 1)] + np.arange(n)
        out_k[at], out_v[at] = sk, sv
    assert (out_k >= 0).all()
    return out_k, out_v


def _replay_sort(keys, bits: int):
    """Every pass of the plan over ``keys``: the key launch's first places
    (exclusive sums of each pass's digit counts), then the passes; the
    first pass's values are the indices."""
    keys = keys.astype(np.int64)
    vals = np.arange(len(keys), dtype=np.int64)
    shift = 0
    for w in eq._digit_plan(bits):
        counts = np.bincount((keys >> shift) & ((1 << w) - 1), minlength=1 << w)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        keys, vals = _replay_pass(keys, vals, shift, w, first)
        shift += w
    return keys, vals


@pytest.mark.parametrize("bits", [1, 7, 8, 9, 12, 21, 31])
@pytest.mark.parametrize("P", [eq.SORT_TILE - 1, eq.SORT_TILE, eq.SORT_TILE + 1])
def test_onesweep_replay_is_a_stable_sort(P, bits):
    """The replay of the passes equals ``torch.sort(keys, stable=True)``
    at the tile's edges, on keys with long runs of one digit, every digit
    and both extremes."""
    rng = np.random.default_rng(bits * 7 + P)
    top = (1 << bits) - 1
    keys = rng.integers(0, top + 1, P, dtype=np.int64)
    keys[: P // 8] = rng.integers(0, min(top, 3) + 1, P // 8)    # many equal keys
    keys[P // 8: P // 4] = top - np.arange(P // 4 - P // 8) % (top + 1)  # descending
    keys[-1], keys[0] = top, 0
    want = torch.sort(torch.as_tensor(keys.astype(np.int32)), stable=True)
    got_k, got_v = _replay_sort(keys, bits)
    assert np.array_equal(got_k, want.values.numpy()) and np.array_equal(got_v,
                                                                         want.indices.numpy())


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


SWEEP_BITS = [1, 7, 8, 9, 12, 21, 31]


def _bits_case(P: int, bits: int, seed: int, dev):
    """Keys below 2^bits (a run of few values, a descending run, both
    extremes) and a depth-5 grid of such ids with points over 1.2x the
    box (NaN among them)."""
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    keys = rng.integers(0, top + 1, P, dtype=np.int64)
    keys[: P // 8] = rng.integers(0, min(top, 3) + 1, P // 8)
    keys[P // 8: P // 4] = top - np.arange(P // 4 - P // 8) % (top + 1)
    if P:
        keys[-1], keys[0] = top, 0
    grid = rng.integers(0, top + 1, 8 ** 5, dtype=np.int64)
    grid[:2] = (0, top)
    pts = (np.asarray(BOX_MIN, np.float32)
           + rng.uniform(-0.1, 1.1, (P, 3)).astype(np.float32) * np.float32(BOX_SIZE))
    pts.reshape(-1)[::101] = np.nan
    return (torch.as_tensor(keys.astype(np.int32), device=dev),
            torch.as_tensor(grid.astype(np.int32), device=dev), torch.as_tensor(pts, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", SWEEP_BITS)
@pytest.mark.parametrize("P", [eq.SORT_TILE - 1, eq.SORT_TILE, eq.SORT_TILE + 1, (1 << 20) + 3])
def test_kernel_bits_sweep(card, P, bits):
    """Every digit plan from one pass to four, at the tile's edges, both
    modes, against ``torch.sort(keys, stable=True)``."""
    keys, grid, pts = _bits_case(P, bits, P + bits, card)
    assert _equal(eq.launch_leaf_sort(keys, None, None, 0, bits), eq.leaf_sort_plain(keys))
    box_min = torch.tensor(BOX_MIN, dtype=torch.float32, device=card)
    box_size3 = torch.full((3,), BOX_SIZE, dtype=torch.float32, device=card)
    want = eq.leaf_sort_plain(pts, grid, box_min, box_size3, 5)
    assert _equal(eq.leaf_sort(pts, grid, box_min, box_size3, 5, bits), want)


@pytest.mark.cuda
def test_kernel_walk_sort_mode(card):
    """K11's mode: 2^22 given keys of 12 bits, in two passes of 6."""
    keys, _, _ = _bits_case(1 << 22, 12, 12, card)
    assert eq._digit_plan(12) == (6, 6)
    assert _equal(eq.launch_leaf_sort(keys, None, None, 0, 12), eq.leaf_sort_plain(keys))


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
