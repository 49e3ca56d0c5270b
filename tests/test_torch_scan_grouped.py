"""K1 (grouped scan): the plain version against the JAX package's Pallas
grouped kernel in interpret mode and its XLA grouped scan with the
early-exit bound on and off, on a synthetic CSR bucket table (an empty
leaf, partial groups, leaf runs longer than G, trailing empty groups, a
zero-area triangle), and, on a CUDA device, the kernel against the plain
version.

Winners are compared by squared distance (rtol 1e-5, atol 1e-6): ids may
differ only on last-ulp ties. On the leaf whose second row holds the
zero-area triangle (a NaN row), ids are compared exactly. JAX is imported
inside the fixture: the GPU machine has no JAX and runs only the
cuda-marked cases (``pytest --noconftest -m cuda``).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sdflib_tpu_torch.ops import scan
from sdflib_tpu_torch.ops.point_triangle import sq_dist_from_vertex_cols

torch.set_num_threads(1)
CH = 64
NAN_LEAF = 7


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from sdflib_tpu.ops.pallas_scan import exact_scan_grouped_pallas
    from sdflib_tpu.sdf.exact_octree import _exact_scan_grouped

    return SimpleNamespace(jnp=jnp, pallas=exact_scan_grouped_pallas, xla=_exact_scan_grouped)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sq(tri9, pts):
    """Squared distances of (n, 3) points to (n, 9) vertex rows."""
    v, p = torch.as_tensor(tri9), torch.as_tensor(pts)
    return sq_dist_from_vertex_cols(p[:, 0], p[:, 1], p[:, 2], lambda r: v[:, r]).numpy()


def _table(seed=1, L=23, T=200, H=64, count=None):
    """Leaf lists over random triangles, sorted by distance to random leaf
    centres (the JAX early-exit bound needs that order), as bucket tables
    with each row's minimum centre distance. Leaf 3 is empty; leaf 7's
    list holds a zero-area triangle, whose NaN distance sorts it last,
    into the leaf's second row. With ``count`` every other list holds that
    many triangles, and no list a zero-area one."""
    rng = np.random.default_rng(seed)
    tri = rng.normal(size=(T, 9)).astype(np.float32)
    tri[5] = [0, 0, 0, 1, 0, 0, 2, 0, 0]
    counts = rng.integers(0, 150, size=L).astype(np.int32)
    counts[3], counts[NAN_LEAF] = 0, 100
    if count is not None:
        counts[:] = count
        counts[3] = 0
    centers = rng.normal(size=(L, 3)).astype(np.float32)
    nch = -(-counts // CH)
    row0 = np.concatenate([[0], np.cumsum(np.maximum(nch, 1))[:-1]]).astype(np.int32)
    NB = -(-int(row0[-1] + max(nch[-1], 1)) // H) * H
    ids = np.full((NB, CH), -1, np.int32)
    cmin = np.full(NB, np.inf, np.float32)
    for l in range(L):
        lst = rng.integers(6, T, size=counts[l]).astype(np.int32)
        if l == NAN_LEAF and count is None:
            lst[10] = 5
        d = _sq(tri[lst], np.repeat(centers[l : l + 1], len(lst), 0))
        order = np.argsort(d, kind="stable")
        lst, d = lst[order], d[order]
        for r in range(nch[l]):
            ids[row0[l] + r, : len(lst[r * CH : (r + 1) * CH])] = lst[r * CH : (r + 1) * CH]
            cmin[row0[l] + r] = np.sqrt(np.min(d[r * CH : (r + 1) * CH]))
    fields = np.zeros((NB, 9 * CH), np.float32)
    live = ids >= 0
    for r in range(9):
        fields[:, r * CH : (r + 1) * CH] = np.where(live, tri[np.maximum(ids, 0), r], 0)
    return SimpleNamespace(tri=tri, counts=counts, nch=nch.astype(np.int32), row0=row0,
                           ids=ids, fields=fields, cmin=cmin, centers=centers,
                           has_nan=count is None)


def _table_fast(L, seed, T=300):
    """L leaf lists of 1-99 random triangles, unsorted (for the kernel
    against its plain version only), built without a loop over leaves."""
    rng = np.random.default_rng(seed)
    tri = rng.normal(size=(T, 9)).astype(np.float32)
    counts = rng.integers(1, 100, size=L).astype(np.int32)
    nch = -(-counts // CH)
    row0 = np.concatenate([[0], np.cumsum(nch)[:-1]]).astype(np.int32)
    row_leaf = np.repeat(np.arange(L), nch)
    in_row = np.minimum(counts[row_leaf] - (np.arange(len(row_leaf)) - row0[row_leaf]) * CH, CH)
    live = np.arange(CH)[None, :] < in_row[:, None]
    ids = np.where(live, rng.integers(0, T, size=live.shape), -1).astype(np.int32)
    fields = np.zeros((len(ids), 9 * CH), np.float32)
    for r in range(9):
        fields[:, r * CH : (r + 1) * CH] = np.where(live, tri[np.maximum(ids, 0), r], 0)
    return SimpleNamespace(tri=tri, counts=counts, nch=nch.astype(np.int32), row0=row0,
                           ids=ids, fields=fields, has_nan=False)


def _groups(tb, P, G, seed, leaves=None, extra_empty=3):
    """Leaf-sorted points and the CSR group offsets (runs of at most G
    points of one leaf), with trailing empty groups."""
    rng = np.random.default_rng(seed)
    L = len(tb.counts)
    lid = rng.choice(L if leaves is None else leaves, size=P)
    if leaves is None:
        lid[:2] = [3, NAN_LEAF]
    lid = np.sort(lid).astype(np.int32)
    pts = rng.normal(size=(P, 3)).astype(np.float32)
    is_start = np.concatenate([[True], lid[1:] != lid[:-1]])
    seg = np.maximum.accumulate(np.where(is_start, np.arange(P), 0))
    rank = np.arange(P) - seg
    starts = np.nonzero(rank % G == 0)[0]
    start = np.concatenate([starts, np.full(extra_empty + 1, P)]).astype(np.int32)
    return pts, lid, start, rank


def _plain(tb, pts, lid, start):
    t = torch.as_tensor
    return scan.scan_grouped(t(tb.ids), t(tb.fields), t(pts), t(lid), t(start),
                             t(tb.row0), t(tb.nch)).numpy()


def _jax_grouped_inputs(tb, pts, lid, start, rank, G, GB):
    """The (NG, G) group layout of the JAX scans: +inf padding slots and
    padding groups up to a multiple of GB; and each point's slot."""
    n = int(np.sum(start[1:] > start[:-1]))
    NG = -(-n // GB) * GB
    gid = np.repeat(np.arange(n), np.diff(start[: n + 1]))
    gpts = np.full((NG, G, 3), np.inf, np.float32)
    gpts[gid, rank % G] = pts
    gleaf = np.zeros(NG, np.int32)
    gleaf[:n] = lid[start[:n]]
    return gpts, gleaf, gid, rank % G


def _jax_refs(jx, tb, pts, lid, start, rank, G):
    """Winner ids of the JAX Pallas grouped kernel (interpret mode) and of
    its XLA grouped scan with the early exit on and off, per point."""
    gpts, gleaf, gid, lane = _jax_grouped_inputs(tb, pts, lid, start, rank, G, GB=64)
    j = jx.jnp.asarray
    refs = {"pallas": np.asarray(jx.pallas(
        j(tb.ids), j(tb.fields), j(gpts), j(gleaf), j(tb.row0), j(tb.counts),
        GB=64, H=64, interpret=True,
    ))[gid, lane]}
    for early_exit in (True, False):
        ids_x, _ = jx.xla(
            j(tb.row0), j(tb.counts), j(tb.centers), j(tb.ids), j(tb.fields), j(tb.cmin),
            j(gpts), j(np.isfinite(gpts[..., 0])), j(gleaf),
            max_chunks=int(tb.nch.max()), early_exit=early_exit,
        )
        refs[f"xla early_exit={early_exit}"] = np.asarray(ids_x)[gid, lane]
    return refs


def _brute_force_check(tb, pts, lid, got, live, step):
    """Every ``step``-th live point's winner distance against the minimum
    over its own leaf list."""
    for k, p in enumerate(np.nonzero(live)[0]):
        if k % step:
            continue
        cand = tb.ids[tb.row0[lid[p]] : tb.row0[lid[p]] + tb.nch[lid[p]]].reshape(-1)
        cand = cand[cand >= 0]
        ref = _sq(tb.tri[cand], np.repeat(pts[p : p + 1], len(cand), 0)).min()
        assert got[k] == pytest.approx(ref, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("G", [8, 16])
def test_plain_matches_jax_grouped_scans(jx, G):
    tb = _table()
    pts, lid, start, rank = _groups(tb, P=300, G=G, seed=G)
    win = _plain(tb, pts, lid, start)
    assert win.shape == (300,) and win.dtype == np.int32
    assert np.bincount(lid, minlength=23).max() > G                 # a run longer than G
    refs = _jax_refs(jx, tb, pts, lid, start, rank, G)
    empty = tb.nch[lid] == 0
    assert empty.any() and (win[empty] == 0).all()                  # the empty leaf
    in_nan = lid == NAN_LEAF
    assert in_nan.any()
    got = _sq(tb.tri[win], pts)[~empty]
    for name, ref in refs.items():
        assert (ref[empty] == 0).all(), name
        np.testing.assert_allclose(got, _sq(tb.tri[ref], pts)[~empty], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_array_equal(win[in_nan], ref[in_nan], err_msg=name)
    # the NaN row never wins: the degenerate leaf's winners come from its first row
    assert np.isin(win[in_nan], tb.ids[tb.row0[NAN_LEAF]]).all()
    # brute force over each point's own leaf list
    for p in np.nonzero(~empty & ~in_nan)[0][::11]:
        cand = tb.ids[tb.row0[lid[p]] : tb.row0[lid[p]] + tb.nch[lid[p]]].reshape(-1)
        cand = cand[cand >= 0]
        ref = _sq(tb.tri[cand], np.repeat(pts[p : p + 1], len(cand), 0)).min()
        assert got[np.sum(~empty[:p])] == pytest.approx(ref, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("count", [1, 31, 32, 33, 64, 65])
def test_plain_matches_jax_dead_halves(jx, count):
    """Lists of 1 to 65 triangles: rows whose slots 32-63 are all -1 (1,
    31, 32 and the second row of 65), a lone live slot 32 (33), a full
    row (64)."""
    tb = _table(seed=4, count=count)
    hi_dead = (tb.ids[:, 32:] < 0).all(1) & (tb.ids[:, :32] >= 0).any(1)
    assert hi_dead.any() == (count in (1, 31, 32, 65))
    pts, lid, start, rank = _groups(tb, P=200, G=8, seed=count)
    win = _plain(tb, pts, lid, start)
    empty = tb.nch[lid] == 0
    assert empty.any() and (win[empty] == 0).all()
    got = _sq(tb.tri[win], pts)[~empty]
    for name, ref in _jax_refs(jx, tb, pts, lid, start, rank, 8).items():
        assert (ref[empty] == 0).all(), name
        np.testing.assert_allclose(got, _sq(tb.tri[ref], pts)[~empty], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    _brute_force_check(tb, pts, lid, got, ~empty, step=7)


def test_grouped_rows_match_numpy_and_jax(jx):
    """Each group's row span: a numpy statement, and the JAX grouped
    scan's bucket0 / nchunk under its has_pts mask (pallas_scan.py), over
    an empty leaf and trailing empty groups."""
    tb = _table()
    G = 8
    pts, lid, start, rank = _groups(tb, P=300, G=G, seed=9, extra_empty=5)
    t = torch.as_tensor
    row0, nrows = (a.numpy() for a in scan.grouped_rows(t(lid), t(start), t(tb.row0),
                                                          t(tb.nch)))
    live = start[1:] > start[:-1]
    leaf = lid[np.minimum(start[:-1], len(lid) - 1)]
    np.testing.assert_array_equal(row0, np.where(live, tb.row0[leaf], 0))
    np.testing.assert_array_equal(nrows, np.where(live, tb.nch[leaf], 0))
    assert (~live[-5:]).all() and (live & (nrows == 0)).any()      # trailing, empty leaf
    jnp = jx.jnp
    gpts, gleaf, _, _ = _jax_grouped_inputs(tb, pts, lid, start, rank, G, GB=64)
    bucket0 = jnp.asarray(tb.row0)[gleaf]
    nchunk = -(-jnp.asarray(tb.counts)[gleaf] // CH)
    has_pts = jnp.any(jnp.isfinite(gpts[..., 0]), axis=1)
    nchunk = np.asarray(jnp.where(has_pts, nchunk, 0))
    n = int(live.sum())
    np.testing.assert_array_equal(nrows[:n], nchunk[:n])
    np.testing.assert_array_equal(row0[:n], np.asarray(bucket0)[:n])
    assert (nrows[n:] == 0).all() and (nchunk[n:] == 0).all()


@pytest.mark.parametrize("long_groups", [False, True])
def test_grouped_row_stream_matches_numpy(long_groups):
    """The kernel's row stream: each group's rows, once per pass of 64 of
    its points, groups in order; groups of one leaf's whole run (up to
    ~300 points, three to five passes) with ``long_groups``."""
    tb = _table()
    pts, lid, start, _ = _groups(tb, P=4000 if long_groups else 300, G=8, seed=3)
    if long_groups:
        start = np.concatenate([np.nonzero(np.r_[True, lid[1:] != lid[:-1]])[0],
                                [len(lid)] * 4]).astype(np.int32)
        assert np.diff(start).max() > 2 * scan.PASS
    t = torch.as_tensor
    got = scan.grouped_row_stream(t(lid), t(start), t(tb.row0), t(tb.nch)).numpy()
    ref = [np.tile(np.arange(tb.row0[lid[s]], tb.row0[lid[s]] + tb.nch[lid[s]]),
                   -(-(e - s) // scan.PASS))
           for s, e in zip(start[:-1], start[1:]) if e > s]
    np.testing.assert_array_equal(got, np.concatenate(ref))


def test_wrapper_rejects_bad_input():
    tb = _table()
    pts, lid, start, _ = _groups(tb, P=40, G=8, seed=0)
    t = torch.as_tensor
    args = [t(tb.ids), t(tb.fields), t(pts), t(lid), t(start), t(tb.row0), t(tb.nch)]
    for k, bad in ((3, t(lid).long()), (2, t(pts[:, :2])), (6, t(tb.nch[:-1])),
                   (1, t(tb.fields[:, :-1]))):
        with pytest.raises(ValueError):
            scan.scan_grouped(*args[:k], bad, *args[k + 1 :])


def _kernel_vs_plain(cuda, tb, pts, lid, start):
    """The kernel against the plain version: winner distances within
    1e-6, id 0 without rows, ids equal on the NaN-row leaf."""
    args = [torch.as_tensor(a, device=cuda)
            for a in (tb.ids, tb.fields, pts, lid, start, tb.row0, tb.nch)]
    before = scan.grouped_launch_count
    win = scan.scan_grouped(*args)
    torch.cuda.synchronize()
    assert scan.grouped_launch_count == before + 1
    ref = scan.scan_grouped_plain(*args).cpu().numpy()
    win = win.cpu().numpy()
    live = tb.nch[lid] > 0
    np.testing.assert_allclose(_sq(tb.tri[win], pts)[live], _sq(tb.tri[ref], pts)[live],
                               rtol=0, atol=1e-6)
    assert (win[~live] == 0).all()
    if tb.has_nan:
        np.testing.assert_array_equal(win[lid == NAN_LEAF], ref[lid == NAN_LEAF])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "dense", "sparse", "degenerate", "long_group", "holes", "long_leaf", "d7_pattern",
    "runs", "lists_1", "lists_31", "lists_32", "lists_33", "lists_64", "lists_65",
])
def test_kernel_matches_plain(cuda, case):
    if case.startswith("lists_"):      # dead halves: slots 32-63 all -1
        tb = _table(seed=4, count=int(case[6:]))
        pts, lid, start, _ = _groups(tb, P=400, G=8, seed=1)
    elif case == "holes":              # -1 in a row's first half, live second half
        tb = _table(seed=4, count=50)
        tb.ids[tb.row0[0], 5] = -1                 # its fields still hold a triangle
        tb.ids[tb.row0[1], :32] = -1               # a dead first half
        pts, lid, start, _ = _groups(tb, P=400, G=8, seed=1, leaves=[0, 1, 2])
    elif case == "long_leaf":          # 7 rows: more than the ring's stages
        tb = _table(seed=6, count=400)
        pts, lid, start, _ = _groups(tb, P=500, G=16, seed=3)
    elif case == "d7_pattern":         # 2^16 one-point groups, then as many empty ones
        tb = _table_fast(L=(1 << 16) + 7, seed=5)
        P = 1 << 16
        lid = np.arange(3, P + 3, dtype=np.int32)
        pts = np.random.default_rng(5).normal(size=(P, 3)).astype(np.float32)
        start = np.concatenate([np.arange(P), np.full(P + 1, P)]).astype(np.int32)
    else:
        tb = _table(seed=1 if case != "sparse" else 3, L=23 if case != "sparse" else 300)
        if case == "sparse":
            pts, lid, start, _ = _groups(tb, P=96, G=8, seed=5)
        elif case == "degenerate":
            pts, lid, start, _ = _groups(tb, P=200, G=16, seed=2, leaves=[6, NAN_LEAF, 8])
        else:   # "runs": ~400 groups of up to 8 points, whose runs of two cross
            # leaves, warps and CTAs
            pts, lid, start, _ = _groups(tb, P=4000 if case != "runs" else 3000,
                                         G=64 if case != "runs" else 8, seed=2)
    if case == "long_group":          # groups of any size: passes of PASS points
        start = np.array([s for k, s in enumerate(start) if k % 3 != 1 or s == len(pts)
                          or lid[s] != lid[start[k - 1]]], np.int32)
        assert np.diff(start).max() > 64
    _kernel_vs_plain(cuda, tb, pts, lid, start)
