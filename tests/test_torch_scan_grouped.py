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


def _table(seed=1, L=23, T=200, H=64):
    """Leaf lists over random triangles, sorted by distance to random leaf
    centres (the JAX early-exit bound needs that order), as bucket tables
    with each row's minimum centre distance. Leaf 3 is empty; leaf 7's
    list holds a zero-area triangle, whose NaN distance sorts it last,
    into the leaf's second row."""
    rng = np.random.default_rng(seed)
    tri = rng.normal(size=(T, 9)).astype(np.float32)
    tri[5] = [0, 0, 0, 1, 0, 0, 2, 0, 0]
    counts = rng.integers(0, 150, size=L).astype(np.int32)
    counts[3], counts[NAN_LEAF] = 0, 100
    centers = rng.normal(size=(L, 3)).astype(np.float32)
    nch = -(-counts // CH)
    row0 = np.concatenate([[0], np.cumsum(np.maximum(nch, 1))[:-1]]).astype(np.int32)
    NB = -(-int(row0[-1] + max(nch[-1], 1)) // H) * H
    ids = np.full((NB, CH), -1, np.int32)
    cmin = np.full(NB, np.inf, np.float32)
    for l in range(L):
        lst = rng.integers(6, T, size=counts[l]).astype(np.int32)
        if l == NAN_LEAF:
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
                           ids=ids, fields=fields, cmin=cmin, centers=centers)


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


@pytest.mark.parametrize("G", [8, 16])
def test_plain_matches_jax_grouped_scans(jx, G):
    tb = _table()
    pts, lid, start, rank = _groups(tb, P=300, G=G, seed=G)
    win = _plain(tb, pts, lid, start)
    assert win.shape == (300,) and win.dtype == np.int32
    assert np.bincount(lid, minlength=23).max() > G                 # a run longer than G
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


def test_wrapper_rejects_bad_input():
    tb = _table()
    pts, lid, start, _ = _groups(tb, P=40, G=8, seed=0)
    t = torch.as_tensor
    args = [t(tb.ids), t(tb.fields), t(pts), t(lid), t(start), t(tb.row0), t(tb.nch)]
    for k, bad in ((3, t(lid).long()), (2, t(pts[:, :2])), (6, t(tb.nch[:-1])),
                   (1, t(tb.fields[:, :-1]))):
        with pytest.raises(ValueError):
            scan.scan_grouped(*args[:k], bad, *args[k + 1 :])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "sparse", "degenerate", "long_group"])
def test_kernel_matches_plain(cuda, case):
    tb = _table(seed=1 if case != "sparse" else 3, L=23 if case != "sparse" else 300)
    if case == "sparse":
        pts, lid, start, _ = _groups(tb, P=96, G=8, seed=5)
    elif case == "degenerate":
        pts, lid, start, _ = _groups(tb, P=200, G=16, seed=2, leaves=[6, NAN_LEAF, 8])
    else:
        pts, lid, start, _ = _groups(tb, P=4000, G=64, seed=2)
    if case == "long_group":          # groups of any size: passes of 64 points
        start = np.array([s for k, s in enumerate(start) if k % 3 != 1 or s == len(pts)
                          or lid[s] != lid[start[k - 1]]], np.int32)
        assert np.diff(start).max() > 64
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
    np.testing.assert_array_equal(win[lid == NAN_LEAF], ref[lid == NAN_LEAF])
