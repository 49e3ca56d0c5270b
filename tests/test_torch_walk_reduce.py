"""K11 on the aligned layout (``sdflib_tpu_torch/ops/walk.py``,
``csrc/octree_walk.cu``): the key launch, the leaf sort of its keys and
the deterministic per-row reduction, beside K10's group read.

On the CPU the plain pieces are held against the JAX package on
``tests/test_diff.py``'s octree (an icosphere, subdivisions 2, radius
0.35, box margin 0.14, max_depth 4, start_depth 1, threshold 1e-3;
tricubic and trilinear, built by the JAX package and loaded into the
port), with NaN, infinite and far points beside finite ones:

* ``walk_keys_plain``'s keys against the row that JAX's
  ``octree_query_diff`` gathers for each point (``base >> 6`` or
  ``base >> 3``, sdflib_tpu/diff/query.py:108), read off ``jax.vjp`` with
  a one-hot cotangent a point: its non-zero (or NaN) row, none where it
  adds only zeros;
* the keys sorted (stable) and ``walk_reduce_plain`` against ``jax.vjp``
  of ``octree_query_diff``, with gd and with gd and gg: NaN at the same
  entries, every row that holds no NaN within rtol/atol 1e-5;
* the reduction's plan: ``reduce_plan``'s arithmetic, and the kernels'
  control flow (runs, the tile's pieces and partials, the crossing rows)
  replayed in numpy float32, bit-equal to ``walk_reduce_plain`` and
  storing each row once, on keys that put one row on every point, rows
  across tile and run edges, keyless points and an empty batch.

The ``cuda`` cases run on a card (``python -m pytest --noconftest -m cuda
tests/test_torch_walk*.py``): K11's gradient ``torch.equal`` from run to
run and its pieces equal to their plain versions bit for bit, K10's
distances equal to K12's one trip bit for bit (on uniform points and on
warps that hold few rows), and one-entry
``data_parallel_fit_step`` equal to ``fit_step``. JAX is imported inside
the CPU tests only.
"""
import numpy as np
import pytest
import torch

from sdflib_tpu_torch import OctreeSdf
from sdflib_tpu_torch.diff.query import octree_coefficients, octree_query_diff
from sdflib_tpu_torch.ops import walk as ow
from sdflib_tpu_torch.utils.primitives import make_icosphere

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(max_depth=4, start_depth=1, termination_threshold=1e-3)
# NaN, infinite and far points on each axis
EDGE = np.array([[np.nan, 0, 0], [0, np.nan, 0], [0, 0, np.nan], [np.inf, 0, 0],
                 [0, -np.inf, 0], [-np.inf, np.inf, 0], [1e30, 0, 0], [0, -1e30, 0],
                 [3e12, 0, 0]], np.float32)

_PAIRS = {}


def _pair(interpolation):
    """(JAX octree, port octree on the CPU) of the icosphere."""
    if interpolation not in _PAIRS:
        from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
        from sdflib_tpu.utils.primitives import make_icosphere as j_ico

        mesh = j_ico(subdivisions=2, radius=0.35)
        j = JOctree(mesh, mesh.bounding_box.add_margin(0.14), interpolation=interpolation, **CFG)
        _PAIRS[interpolation] = (j, OctreeSdf.from_jax_state(j._state_arrays(), device="cpu"))
    return _PAIRS[interpolation]


def _walk(p, coeffs):
    return ow.Walk(p._octree_dev, coeffs, p._box_min, p._box_size3, float(p.min_border_value),
                   p.start_grid_size, p.max_depth - p.start_depth, p.num_coefficients,
                   p.interpolation, True)


def _points(p, n, seed, spread=0.1):
    lo, hi = np.asarray(p.box.min, np.float64), np.asarray(p.box.max, np.float64)
    pad = spread * (hi - lo)
    pts = np.random.default_rng(seed).uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)
    return np.concatenate([EDGE, pts])


def _args(sdf):
    return (np.asarray(sdf.box.min, np.float32), np.float32(sdf.box.size[0]),
            sdf.start_grid_size, np.float32(sdf.min_border_value))


def _jax_query(j, pts, grad):
    import jax.numpy as jnp
    from sdflib_tpu.diff.query import octree_query_diff as j_query

    a = _args(j)
    args = (jnp.asarray(a[0]), jnp.float32(a[1]), a[2], jnp.float32(a[3]))
    kw = dict(levels=j.max_depth - j.start_depth, num_coeff=j.num_coefficients,
              interpolation=j.interpolation, fast=True)
    return lambda cc: j_query(j.octree_data, cc, jnp.asarray(pts), *args, with_gradient=grad,
                              **kw)


def _jax_point_grads(j, pts):
    """``jax.vjp`` of JAX's ``octree_query_diff`` at each point alone, with
    cotangent 1: (P, W)."""
    import jax
    import jax.numpy as jnp
    from sdflib_tpu.diff.query import octree_coefficients as j_coeffs

    c0 = j_coeffs(j.octree_data)

    def one(q):
        _, vjp = jax.vjp(_jax_query(j, q[None], False), c0)
        return vjp(jnp.ones(1, jnp.float32))[0]

    return np.asarray(jax.vmap(one)(jnp.asarray(pts)))


@pytest.mark.parametrize("interpolation", ["tricubic", "trilinear"])
def test_keys_are_the_rows_jax_gathers(interpolation):
    j, p = _pair(interpolation)
    pts = _points(p, 160, 11, spread=0.3)
    nc = p.num_coefficients
    rows = p._octree_dev.numel() // nc
    per_point = _jax_point_grads(j, pts)
    live = (per_point[:, : rows * nc] != 0).reshape(len(pts), rows, nc).any(2)   # NaN too
    assert (live.sum(1) <= 1).all()
    seen = live.any(1)
    keys, share = ow.walk_keys_plain(_walk(p, octree_coefficients(p._octree_dev)),
                                     torch.as_tensor(pts), torch.ones(len(pts)))
    assert keys.dtype == torch.int32 and share.shape == (len(pts), 4)
    keys, share = keys.numpy(), share.numpy()
    # every point whose row JAX's transpose touches (NaN and infinite ones
    # by their NaN) is keyed with that row
    np.testing.assert_array_equal(keys[seen], live.argmax(1)[seen])
    assert seen[:6].all() and seen[len(EDGE):].sum() > 0
    # the others add nothing: keyless, or far points (0 times the finite
    # weights of the row they reach) with no share of gd
    far = ~seen & (keys < rows)
    assert set(np.flatnonzero(far)) <= {6, 7, 8} and (share[far, 3] == 0).all()
    assert np.isfinite(share[far]).all()
    assert (keys[~seen & ~far] == rows).all() and not share[keys == rows].any()


@pytest.mark.parametrize("cotangent", ["d", "d_and_g"])
@pytest.mark.parametrize("interpolation", ["tricubic", "trilinear"])
def test_sorted_reduction_matches_jax_vjp(interpolation, cotangent):
    import jax
    import jax.numpy as jnp
    from sdflib_tpu.diff.query import octree_coefficients as j_coeffs

    j, p = _pair(interpolation)
    pts = _points(p, 3000, 12)
    rng = np.random.default_rng(13)
    ct_d = rng.normal(size=len(pts)).astype(np.float32)
    ct_g = rng.normal(size=(len(pts), 3)).astype(np.float32)
    grad = cotangent == "d_and_g"
    w = _walk(p, octree_coefficients(p._octree_dev))
    gg = torch.as_tensor(ct_g) if grad else None
    keys, share = ow.walk_keys_plain(w, torch.as_tensor(pts), torch.as_tensor(ct_d), gg)
    lid_s, order = torch.sort(keys, stable=True)
    gc = ow.walk_reduce_plain(w, lid_s, order, share).numpy()
    _, vjp = jax.vjp(_jax_query(j, pts, grad), j_coeffs(j.octree_data))
    (jgc,) = vjp((jnp.asarray(ct_d), jnp.asarray(ct_g)) if grad else jnp.asarray(ct_d))
    jgc = np.asarray(jgc)
    assert np.isnan(jgc).sum() > 0
    np.testing.assert_array_equal(np.isnan(gc), np.isnan(jgc))
    nc = p.num_coefficients
    keep = ~np.repeat(np.isnan(gc).reshape(-1, nc).any(1), nc)
    assert np.count_nonzero(jgc[keep]) > 0
    np.testing.assert_allclose(gc[keep], jgc[keep], **TOL)
    # the wrapper on the CPU is the plain version
    assert torch.equal(ow.walk_reduce(w, lid_s, order, share).nan_to_num(7.0),
                       torch.as_tensor(gc).nan_to_num(7.0))


def _kernel_reduce(lid, order, w, rows, nc):
    """walk_reduce_kernel and walk_reduce_span_kernel step by step in numpy
    float32 (csrc/octree_walk.cu): the gradient (rows, nc) and how many
    times each row was stored."""
    P, T = len(lid), ow.REDUCE_TILE
    tiles, run, words = ow.reduce_plan(P, nc)
    assert words == 2 * tiles * nc
    grad = np.zeros((rows, nc), np.float32)
    part = np.full((2 * tiles, nc), np.nan, np.float32)
    stores = np.zeros(rows, np.int64)

    def store(row, v):
        grad[row] = v
        stores[row] += 1

    for t in range(tiles):
        first = t * T
        here = min(T, P - first)
        pieces = []
        for r in range(T // run):
            cur, head, acc = -1, None, None
            for k in range(r * run, min(r * run + run, here)):
                key = lid[first + k]
                if key >= rows:
                    break
                wv = w[order[first + k]]
                if key == cur:
                    acc = acc + wv
                    continue
                if cur >= 0:
                    if head is None:
                        head = (cur, acc)
                    else:
                        store(cur, acc)
                cur, acc = key, wv
            pieces += [x for x in (head, (cur, acc) if cur >= 0 else None) if x is not None]
        prev = lid[first - 1] if first > 0 else -1
        nxt = lid[first + here] if first + here < P else -1

        def flush(row, s):
            if row == prev:
                part[2 * t] = s
            elif row == nxt:
                part[2 * t + 1] = s
            else:
                store(row, s)

        row, s = -1, None
        for rr, v in pieces:
            if rr == row:
                s = s + v
            else:
                if row >= 0:
                    flush(row, s)
                row, s = rr, v
        if row >= 0:
            flush(row, s)
    for t in range(tiles - 1):
        end = (t + 1) * T
        row = lid[end - 1]
        if row >= rows or lid[end] != row or (t > 0 and lid[t * T - 1] == row):
            continue
        last = (np.searchsorted(lid, row, side="right") - 1) // T
        s = part[2 * t + 1]
        for u in range(t + 1, last + 1):
            s = s + part[2 * u]
        store(row, s)
    return grad, stores


def _plan_keys(case, P, rows, rng):
    if case == "one row":
        return np.full(P, 3, np.int32)
    if case == "keyless tail":
        keys = rng.integers(0, rows, P).astype(np.int32)
        keys[rng.random(P) < 0.3] = rows
        return keys
    if case == "tile edges":
        # runs of 1,023, 1, 1,025, 64, 63 and 1 points: rows that end and
        # begin on and beside the tile and run edges
        sizes = [1023, 1, 1025, 64, 63, 1, 2048, 5]
        return np.repeat(np.arange(len(sizes), dtype=np.int32) * 2 % rows, sizes)[:P]
    return rng.integers(0, rows, P).astype(np.int32)


@pytest.mark.parametrize("P", [0, 1, 1023, 1024, 1025, 3 * 1024 + 77])
@pytest.mark.parametrize("case", ["one row", "random", "keyless tail", "tile edges"])
@pytest.mark.parametrize("nc", [64, 8])
def test_reduction_plan_replays_the_kernels(nc, case, P):
    """The kernels' order, replayed, equals ``walk_reduce_plain`` bit for bit
    and stores each row once; a row holding every point spans every tile."""
    rows = 40
    rng = np.random.default_rng(P + nc)
    keys = _plan_keys(case, P, rows, rng)
    lid_s, order = torch.sort(torch.as_tensor(keys), stable=True)
    share = torch.as_tensor(rng.uniform(0, 1, (P, 8)).astype(np.float32))
    share[:, 3] = torch.as_tensor(rng.normal(size=P).astype(np.float32))
    share[:, 7] = 0
    words = torch.zeros(rows * nc + 4, dtype=torch.int32)       # rows whole rows
    w = ow.Walk(words, words.view(torch.float32), torch.zeros(3), torch.ones(3), 0.0, 1, 0, nc,
                "tricubic" if nc == 64 else "trilinear", True)
    gc = ow.walk_reduce_plain(w, lid_s, order, share)
    assert gc.shape == (rows * nc + 4,) and not gc[rows * nc:].any()
    weights = ow._weights(share[:, :3], share[:, 3], share[:, 4:7], w.interpolation).numpy()
    got, stores = _kernel_reduce(lid_s.numpy(), order.numpy(), weights, rows, nc)
    assert (stores <= 1).all()
    np.testing.assert_array_equal(got.reshape(-1).view(np.int32),
                                  gc[: rows * nc].numpy().view(np.int32))
    tiles, run, _ = ow.reduce_plan(P, nc)
    assert tiles == -(-P // 1024) and run == (16 if nc == 64 else 8)
    live = np.unique(keys[keys < rows])
    assert (stores[live] == 1).all() and (stores[np.setdiff1d(np.arange(rows), live)] == 0).all()
    ref = torch.zeros((rows, nc))
    keep = lid_s < rows
    ref.index_add_(0, lid_s[keep].long(), torch.as_tensor(weights)[order[keep]])
    scale = float(ref.abs().max()) if P else 1.0
    assert float((gc[: rows * nc].view(rows, nc) - ref).abs().max()) <= 1e-5 * scale


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module", params=["tricubic", "trilinear"])
def cuda_tree(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_icosphere(subdivisions=2, radius=0.35)
    return OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cuda",
                     interpolation=request.param, init_algorithm="no_continuity",
                     **dict(CFG, max_depth=5))


def _card_points(tree, n=1 << 16, seed=71):
    pts = _points(tree, n, seed, spread=0.2)
    return torch.as_tensor(pts, device="cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("with_gg", [False, True])
def test_k11_is_the_same_bits_run_to_run(cuda_tree, with_gg):
    c = octree_coefficients(cuda_tree._octree_dev)
    w = _walk(cuda_tree, c)
    pts = _card_points(cuda_tree)
    n = pts.shape[0]
    rng = np.random.default_rng(72)
    gd = torch.as_tensor(rng.normal(size=n).astype(np.float32), device="cuda")
    gg = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device="cuda") \
        if with_gg else None
    ow.backward_launch_count = ow.key_launch_count = 0
    ow.sort_launch_count = ow.reduce_launch_count = 0
    first, _ = ow.walk_backward(w, pts, gd, gg)
    assert (ow.backward_launch_count, ow.key_launch_count, ow.sort_launch_count,
            ow.reduce_launch_count) == (1, 1, 1, 1)
    for _ in range(3):
        again, _ = ow.walk_backward(w, pts, gd, gg)
        assert torch.equal(_bits(again), _bits(first))
    keys, share = ow.walk_keys(w, pts, gd, gg)
    keys_p, share_p = ow.walk_keys_plain(w, pts, gd, gg)
    assert torch.equal(keys, keys_p) and torch.equal(_bits(share), _bits(share_p))
    lid_s, order = torch.sort(keys, stable=True)
    plain = ow.walk_reduce_plain(w, lid_s, order, share)
    assert torch.equal(_bits(ow.walk_reduce(w, lid_s, order, share)), _bits(plain))
    assert torch.equal(_bits(first), _bits(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["uniform", "sparse"])
@pytest.mark.parametrize("mode", ow.MODES)
def test_k10_group_read_equals_k12_one_trip(cuda_tree, mode, layout):
    """Every group size gives the one-lane bits, on uniform points and on
    warps that hold few rows (lanes 0, 9 and 31 in the box, every fourth
    warp whole): the warp's rounds take only its lanes with a row."""
    w = _walk(cuda_tree, octree_coefficients(cuda_tree._octree_dev))
    pts = _card_points(cuda_tree)
    if layout == "sparse":
        i = torch.arange(pts.shape[0], device="cuda")
        keep = (i % 32 == 0) | (i % 32 == 9) | (i % 32 == 31) | (i // 32 % 4 == 0)
        pts[~keep, 0] += 4.0 * float(cuda_tree.box.size[0])
    ref = ow.walk_query(w, pts, mode, group=1)
    ref = ref if mode != "distance" else (ref,)
    for group in (4, 8):
        got = ow.walk_query(w, pts, mode, group=group)
        got = got if mode != "distance" else (got,)
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b))
    d = ref[0]
    dirs = torch.zeros_like(pts)
    dirs[:, 2] = 1.0
    _, _, depth, trips = ow.walk_march(w, pts, dirs, 0.0, 1e30, 1)
    keep = d >= 0
    assert int(keep.sum()) > 0 and (trips == 1).all()
    assert torch.equal(_bits(depth[keep]), _bits(d[keep]))


@pytest.mark.cuda
def test_one_entry_data_parallel_fit_step_is_fit_step(cuda_tree):
    from sdflib_tpu_torch import parallel

    t = cuda_tree
    rng = np.random.default_rng(73)
    pts = rng.uniform(-0.35, 0.35, (4096, 3)).astype(np.float32)
    targets = (np.linalg.norm(pts, axis=-1) - 0.35).astype(np.float32)
    c0 = octree_coefficients(t._octree_dev)
    card = torch.device("cuda", 0)
    l_one, c_one = parallel.fit_step(
        t._octree_dev, c0, torch.as_tensor(pts, device=card), torch.as_tensor(targets, device=card),
        torch.ones(len(pts), device=card), t.box.min, t.box.size[0], t.min_border_value, 1e-2,
        start_grid_size=t.start_grid_size, levels=t.max_depth - t.start_depth,
        num_coeff=t.num_coefficients, interpolation=t.interpolation, fast=t._fast_layout)
    l_dp, c_dp = parallel.data_parallel_fit_step(t, c0, torch.as_tensor(pts, device=card),
                                                 targets, [card], lr=1e-2)
    assert torch.equal(l_one, l_dp)
    assert torch.equal(_bits(c_one), _bits(c_dp[0]))
    assert not torch.equal(c_one, c0)


def test_cpu_backward_launches_nothing():
    """The walk's backward on the CPU is the plain ``index_add_``: it
    counts no launch of K11 or of its pieces."""
    _, p = _pair("tricubic")
    c = octree_coefficients(p._octree_dev).requires_grad_(True)
    pts = _points(p, 64, 14)
    kw = dict(levels=p.max_depth - p.start_depth, num_coeff=64, interpolation="tricubic",
              fast=True)
    def counts():
        return (ow.backward_launch_count, ow.key_launch_count, ow.sort_launch_count,
                ow.reduce_launch_count)

    before = counts()
    d = octree_query_diff(p._octree_dev, c, pts, *_args(p), **kw)
    (gc,) = torch.autograd.grad(d.sum(), c)
    assert counts() == before
    assert isinstance(ow.reduce_launch_count, int) and gc.shape == c.shape
