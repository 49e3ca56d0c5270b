"""K1 (window scan): the plain version against the JAX package's XLA
window scan and its Pallas kernel in interpret mode, on a synthetic CSR
bucket table (an empty leaf, windows straddling leaves, padding points, a
sparse batch, a zero-area triangle, windows of 32 distinct leaves, a row
whose only id is in its last slot), and, on a CUDA device, the kernel
against the plain version.

Winners are compared by squared distance (rtol 1e-5, atol 1e-6): ids may
differ only on last-ulp ties. JAX is imported inside the fixture: the GPU
machine has no JAX and runs only the cuda-marked cases
(``pytest --noconftest -m cuda``).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sdflib_tpu_torch.ops import scan
from sdflib_tpu_torch.ops.point_triangle import sq_dist_from_vertex_cols

torch.set_num_threads(1)
CH = 64


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from sdflib_tpu.ops.pallas_scan import exact_scan_window_pallas
    from sdflib_tpu.sdf.exact_octree import _exact_scan_window_xla

    return SimpleNamespace(jnp=jnp, pallas=exact_scan_window_pallas, xla=_exact_scan_window_xla)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _csr(seed=0, L=23, T=200, rows_mult=64, degenerate=False, lone_slot=None):
    """Random leaf lists over random triangles, as bucket tables. With
    ``lone_slot`` that leaf gets two rows, the first all -1 but its last
    slot."""
    rng = np.random.default_rng(seed)
    tri = rng.normal(size=(T, 9)).astype(np.float32)
    counts = rng.integers(0, 150, size=L).astype(np.int32)
    counts[3] = 0                                       # an empty leaf
    if degenerate:
        tri[5] = [0, 0, 0, 1, 0, 0, 2, 0, 0]            # collinear: NaN distances
        counts[7] = 100
    if lone_slot is not None:
        counts[lone_slot] = 100
    nch = -(-counts // CH)
    row0 = np.concatenate([[0], np.cumsum(np.maximum(nch, 1))[:-1]]).astype(np.int32)
    NB = -(-int(row0[-1] + max(nch[-1], 1)) // rows_mult) * rows_mult
    ids = np.full((NB, CH), -1, np.int32)
    for l in range(L):
        lst = rng.integers(0, T, size=counts[l]).astype(np.int32)
        if degenerate and l == 7:
            lst[10] = 5                                 # in the leaf's first row
        for k, t in enumerate(lst):
            ids[row0[l] + k // CH, k % CH] = t
    if lone_slot is not None:
        ids[row0[lone_slot], : CH - 1] = -1
    fields = np.zeros((NB, 9 * CH), np.float32)
    live = ids >= 0
    for r in range(9):
        fields[:, r * CH : (r + 1) * CH] = np.where(live, tri[np.maximum(ids, 0), r], 0)
    return tri, counts, nch.astype(np.int32), row0, ids, fields


def _points(counts, nch, row0, P, seed, n_pad=0, leaves=None):
    rng = np.random.default_rng(seed)
    L = len(counts)
    lid = np.sort(rng.choice(L if leaves is None else leaves, size=P))
    pts = rng.normal(size=(P, 3)).astype(np.float32)
    b0, nc = row0[lid].copy(), nch[lid].copy()
    if n_pad:
        b0[-n_pad:], nc[-n_pad:], pts[-n_pad:] = 0, 0, 0.0
    return pts, b0.astype(np.int32), nc.astype(np.int32)


def _spread_points(L, n_windows, seed):
    """Windows of 32 points in 32 distinct leaves each (sorted by leaf
    within a window)."""
    rng = np.random.default_rng(seed)
    lid = np.concatenate([np.sort(rng.choice(L, 32, replace=False))
                          for _ in range(n_windows)])
    return lid, rng.normal(size=(32 * n_windows, 3)).astype(np.float32)


def _case(name):
    """(tri, ids, fields, pts, b0, nc) of a named test case."""
    if name == "sparse":
        tri, counts, nch, row0, ids, fields = _csr(seed=3, L=300)
        pts, b0, nc = _points(counts, nch, row0, P=96, seed=5)
    elif name == "spread":
        tri, counts, nch, row0, ids, fields = _csr(seed=4, L=40, lone_slot=9)
        lid, pts = _spread_points(40, 6, seed=6)
        b0, nc = row0[lid].astype(np.int32), nch[lid].astype(np.int32)
    elif name == "lone_slot":
        tri, counts, nch, row0, ids, fields = _csr(seed=1, lone_slot=7)
        pts, b0, nc = _points(counts, nch, row0, P=32 * 20, seed=2, leaves=[6, 7, 8])
    else:
        tri, counts, nch, row0, ids, fields = _csr(seed=1, degenerate=name == "degenerate")
        pts, b0, nc = _points(counts, nch, row0, P=32 * 300, seed=2, n_pad=7)
    return tri, ids, fields, pts, b0, nc


def _winner_sq(tri, pts, win):
    v = torch.as_tensor(tri)[torch.as_tensor(np.array(win).reshape(-1)).long()]
    p = torch.as_tensor(pts)
    return sq_dist_from_vertex_cols(p[:, 0], p[:, 1], p[:, 2], lambda r: v[:, r]).numpy()


def _plain(ids, fields, pts, b0, nc, G):
    t = torch.as_tensor
    return scan.scan_window(t(ids), t(fields), t(pts), t(b0), t(nc), G=G).numpy()


def _jax_xla(jx, ids, fields, pts, b0, nc, G):
    NW = pts.shape[0] // G
    max_chunks = max(int(nc.max()), 1)
    return np.asarray(jx.xla(
        jx.jnp.asarray(ids), jx.jnp.asarray(fields),
        jx.jnp.asarray(pts.reshape(NW, G, 3)), jx.jnp.asarray(b0.reshape(NW, G)),
        jx.jnp.asarray(nc.reshape(NW, G)), max_iters=G * max_chunks,
    ))


@pytest.mark.parametrize("G", [8, 32])
def test_plain_matches_jax_window_scans(jx, G):
    tri, counts, nch, row0, ids, fields = _csr()
    pts, b0, nc = _points(counts, nch, row0, P=64 * G, seed=G, n_pad=5)
    live = nc > 0
    win = _plain(ids, fields, pts, b0, nc, G)
    assert win.shape == (64, G) and win.dtype == np.int32
    assert (win.reshape(-1)[~live] == 0).all()           # padding: no winner
    got = _winner_sq(tri, pts, win)[live]
    ref_x = _winner_sq(tri, pts, _jax_xla(jx, ids, fields, pts, b0, nc, G))[live]
    np.testing.assert_allclose(got, ref_x, rtol=1e-5, atol=1e-6)
    win_p = jx.pallas(
        jx.jnp.asarray(ids), jx.jnp.asarray(fields), jx.jnp.asarray(pts),
        jx.jnp.asarray(b0), jx.jnp.asarray(nc), G=G, GB=64, H=64, interpret=True,
    )
    ref_p = _winner_sq(tri, pts, win_p)[live]
    np.testing.assert_allclose(got, ref_p, rtol=1e-5, atol=1e-6)
    # brute force over each point's own leaf rows
    for p in range(0, pts.shape[0], 37):
        if nc[p]:
            cand = ids[b0[p] : b0[p] + nc[p]].reshape(-1)
            cand = cand[cand >= 0]
            ref = _winner_sq(tri, np.repeat(pts[p : p + 1], len(cand), 0), cand).min()
            assert _winner_sq(tri, pts[p : p + 1], win.reshape(-1)[p : p + 1])[0] == pytest.approx(ref, rel=1e-5, abs=1e-6)


def test_plain_sparse_batch_matches_jax(jx):
    """Few points spread over distant leaves: every window gap-jumps."""
    tri, counts, nch, row0, ids, fields = _csr(seed=3, L=200)
    pts, b0, nc = _points(counts, nch, row0, P=24, seed=5)
    live = nc > 0
    win = _plain(ids, fields, pts, b0, nc, 8)
    ref = _jax_xla(jx, ids, fields, pts, b0, nc, 8)
    np.testing.assert_allclose(
        _winner_sq(tri, pts, win)[live], _winner_sq(tri, pts, ref)[live],
        rtol=1e-5, atol=1e-6,
    )


def test_plain_degenerate_row_matches_jax(jx):
    """A zero-area triangle makes its row's minimum NaN: that row never
    wins, in the JAX scan and in the port alike (ids compared exactly)."""
    tri, counts, nch, row0, ids, fields = _csr(seed=1, degenerate=True)
    pts, b0, nc = _points(counts, nch, row0, P=64, seed=2, leaves=[6, 7, 8])
    win = _plain(ids, fields, pts, b0, nc, 32)
    ref = _jax_xla(jx, ids, fields, pts, b0, nc, 32)
    np.testing.assert_array_equal(win, ref)
    in7 = b0 == row0[7]
    assert in7.any()
    # the leaf's first row holds the NaN triangle: its winners come from row 2
    assert np.isin(win.reshape(-1)[in7], ids[row0[7] + 1]).all()


@pytest.mark.parametrize("case", ["spread", "lone_slot"])
def test_plain_spread_and_lone_slot_match_jax(jx, case):
    """Windows whose 32 points lie in 32 distinct leaves (an empty leaf
    among them), and a leaf whose first row holds one id, in its last
    slot: the ids equal the JAX window scan's."""
    tri, ids, fields, pts, b0, nc = _case(case)
    win = _plain(ids, fields, pts, b0, nc, 32)
    ref = _jax_xla(jx, ids, fields, pts, b0, nc, 32)
    np.testing.assert_array_equal(win, ref)
    lone = ids[:, : CH - 1].max(axis=1) < 0
    lone_row = int(np.flatnonzero(lone & (ids[:, CH - 1] >= 0))[0])
    assert ((b0 == lone_row) & (nc > 0)).any()


def test_wrapper_rejects_bad_input():
    tri, counts, nch, row0, ids, fields = _csr()
    t = torch.as_tensor
    pts, b0, nc = _points(counts, nch, row0, P=64, seed=0)
    with pytest.raises(ValueError):
        scan.scan_window(t(ids), t(fields), t(pts[:63]), t(b0[:63]), t(nc[:63]))
    with pytest.raises(ValueError):
        scan.scan_window(t(ids), t(fields), t(pts), t(b0).long(), t(nc))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "sparse", "degenerate", "spread", "lone_slot"])
def test_kernel_matches_plain(cuda, case):
    tri, ids, fields, pts, b0, nc = _case(case)
    args = [torch.as_tensor(a, device=cuda) for a in (ids, fields, pts, b0, nc)]
    before = scan.launch_count
    win = scan.scan_window(*args)
    torch.cuda.synchronize()
    assert scan.launch_count == before + 1
    ref = scan.scan_window_plain(*args)
    live = nc > 0
    np.testing.assert_allclose(
        _winner_sq(tri, pts, win.cpu().numpy())[live],
        _winner_sq(tri, pts, ref.cpu().numpy())[live],
        rtol=0, atol=1e-6,
    )
    assert (win.cpu().numpy().reshape(-1)[~live] == 0).all()
