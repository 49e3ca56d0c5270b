"""K13, the exact build's region cull (``sdflib_tpu_torch/ops/cull.py``,
``csrc/region_cull.cu``).

On the CPU:

* ``region_cull_plain`` against the JAX package's ``_region_cull_chunk``
  (run on the CPU, as its own tests run it) on inputs made from a numpy
  seed over the strategies test's torus (nu=24, nv=12, margin 0.14):
  chunks of nodes at depths 2 and 3 whose rows hold each node's nearest
  triangles in index order with invalid padding, an all-invalid row, and
  the top level's expanded rows (every triangle, padded to a power of 2).
  ``sqd_center`` agrees within rtol 1e-5 / atol 1e-9 (XLA on the CPU fuses
  multiply-adds, so its frames round otherwise). ``keep`` is equal at every
  decided slot: one whose keep is the same whichever of an anchor's tied
  nearest candidates (within 64 ulps of the minimum: triangles that share
  the nearest vertex or edge tie up to rounding, so the last ulp picks the
  winner, and its corner distances move the test) the anchor takes, and
  whose corner minimum and distance lie more than 16 ulps from eps and
  near (the fused-multiply-add case of ``tests/test_torch_strategies.py``).
  At least 85% of the valid slots are decided, and at most 1% differ; the
  kept totals agree within 1%.
* a numpy float32 replay of K13's order (pass 1's running minima a lane,
  slots ``lane, lane + G, ...``, and a butterfly over the lanes for the 27
  winners; the winners' corner distances; pass 2 anchor by anchor, with the
  frame products shared by the anchors) is bit-equal to
  ``region_cull_plain`` for both forms of the kernel (a warp a node, a
  512-thread block a node), on rows of 40 and 300 slots with ties at the
  minimum (a triangle twice in a row), a zero-area and a collinear
  triangle, a triangle whose fields are NaN, invalid padding, an
  all-invalid row, on the expanded top level at depths 1 and 2, and on
  nodes whose candidates sit a float32 step of the centre from ``near``
  and ``eps``: the same function before any card sees it. The replay
  takes pass 2's skip test (an anchor whose bound on every corner term
  exceeds eps keeps nothing) and asserts that it never skips an anchor
  whose full evaluation keeps; a NaN bound or NaN corner distance never
  skips.
* ``region_cull`` on CPU tensors is the plain version, whole or in chunks
  of nodes, and counts no launch; a CPU ``ExactOctreeSdf`` build counts
  none either; its argument checks raise.

On a card (``python -m pytest --noconftest -m cuda
tests/test_torch_region_cull.py``; JAX is imported only inside the CPU
tests' bodies): K13 in each of its forms is bit-equal to
``region_cull_plain`` on the card (keep, counts, sqd_center) at K = 8, 64,
512 and 131,072 (the last expanded, row stride 0), over a table with a
zero-area triangle, and on the nodes about the thresholds (with pass 2's
tallies equal to the replay's); every group of the bench torus's d6
build in each form; a card ``ExactOctreeSdf`` build launches K13 once a
node group and never the plain version, and equals the build with the
plain cull pinned, array for array.
"""
import functools

import numpy as np
import pytest
import torch

from sdflib_tpu_torch import ExactOctreeSdf
from sdflib_tpu_torch.mesh import Mesh
from sdflib_tpu_torch.ops import cull
from sdflib_tpu_torch.ops.point_triangle import sq_dist_packed
from sdflib_tpu_torch.sdf import exact_octree as eo
from sdflib_tpu_torch.triangle import calculate_mesh_triangle_data, soa_to_torch
from sdflib_tpu_torch.utils.primitives import make_torus

torch.set_num_threads(1)
f32 = np.float32
INT_MAX = np.iinfo(np.int32).max
SKIP_REL = 1.0 / 16384.0      # csrc/region_cull.cu kSkipRel
TORUS = dict(R=0.3, r=0.12, nu=24, nv=12)


def _mesh(degenerate: bool) -> Mesh:
    """The strategies test's torus; with ``degenerate`` a zero-area
    triangle (a repeated vertex) and a collinear one appended."""
    m = make_torus(**TORUS)
    if not degenerate:
        return m
    v, idx = m.vertices, m.indices.astype(np.int64)
    mid = (0.5 * (v[idx[0, 0]] + v[idx[0, 1]]))[None].astype(np.float32)
    extra = np.array([[idx[0, 0], idx[0, 0], idx[0, 1]],
                      [idx[0, 0], idx[0, 1], len(v)]], np.int64)
    return Mesh(np.concatenate([v, mid]), np.concatenate([idx, extra]))


def _tables(mesh: Mesh, device="cpu"):
    tris = soa_to_torch(calculate_mesh_triangle_data(mesh), device)
    return eo.prepare_cull_inputs(tris, "region")


def _box(mesh: Mesh):
    box = mesh.bounding_box.add_margin(0.14).cubified()
    return np.asarray(box.min, np.float32), float(box.size[0])


def _centers(mesh: Mesh, depth: int, cells):
    """The centres of start-grid cells ``cells`` (z-major) at ``depth``, as
    ``_build_exact`` computes them, and the half size."""
    bmin, size = _box(mesh)
    s = 1 << depth
    cell = size / s
    zi, yi, xi = np.unravel_index(np.asarray(cells), (s, s, s))
    c = np.stack([bmin[0] + cell * (xi + 0.5), bmin[1] + cell * (yi + 0.5),
                  bmin[2] + cell * (zi + 0.5)], axis=-1).astype(np.float32)
    return c, 0.5 * cell


def _rows(tables, centers, K: int, rng, ties: bool = False):
    """(cand (N, K) int32, valid (N, K) bool): each row the node's nearest
    triangles (between K/4 and K of them) in index order, then invalid
    padding with random ids; the last row all invalid. With ``ties`` each
    row holds its first triangle twice."""
    T = tables.packed.shape[0]
    c = torch.as_tensor(centers)
    sq = sq_dist_packed(c[:, 0:1], c[:, 1:2], c[:, 2:3], tables.packed[None]).numpy()
    N = len(centers)
    cand = rng.integers(0, T, (N, K)).astype(np.int32)
    valid = np.zeros((N, K), bool)
    for n in range(N - 1):
        m = int(rng.integers(K // 4, K + 1))
        near = np.sort(np.argsort(sq[n], kind="stable")[:m])
        if ties and m >= 2:
            near[1] = near[0]
        cand[n, :m] = near
        valid[n, :m] = True
    return cand, valid


def _top(tables, n0: int):
    """The top level's expanded rows: every triangle, padded to a power of 2."""
    T = tables.packed.shape[0]
    lane = torch.arange(eo._round_pow2(T, 8), dtype=torch.int32)
    return (torch.where(lane < T, lane, 0).expand(n0, -1),
            (lane < T).expand(n0, -1))


# -- a numpy float32 replay of K13's order ---------------------------------------

def _better(v, i, bv, bi):
    vn, bn = np.isnan(v), np.isnan(bv)
    return np.where(vn | bn, vn & (~bn | (i < bi)), (v < bv) | ((v == bv) & (i < bi)))


def _ladder(ppx, ppy, ppz, F, grad: bool):
    """region.cuh's select form (and region_cull.cu's gradient halves)."""
    v2x, v3x, v3y = F[..., 16], F[..., 17], F[..., 18]
    b0, b1, c0, c1 = F[..., 12], F[..., 13], F[..., 14], F[..., 15]
    de1 = -ppy
    de2 = (ppx - v2x) * b1 - ppy * b0
    de3 = ppx * c1 - ppy * c0
    z2 = ppz * ppz
    rx2, rx3, ry3 = ppx - v2x, ppx - v3x, ppy - v3y
    a1, e1 = ppx <= 0, ppx >= v2x
    a2, e2 = rx2 * b0 + ppy * b1 <= 0, rx3 * b0 + ry3 * b1 >= 0
    a3, e3 = ppx * c0 + ppy * c1 >= 0, rx3 * c0 + ry3 * c1 <= 0
    zero = np.zeros_like(ppx)
    r1, r2, r3 = de1 >= 0, de2 >= 0, de3 >= 0

    def pick(x1, x2, x3):
        return np.where(r1, x1, np.where(r2, x2, np.where(r3, x3, zero)))

    x = pick(np.where(a1, ppx, np.where(e1, rx2, de1)), np.where(a2, rx2, np.where(e2, rx3, de2)),
             np.where(a3, ppx, np.where(e3, rx3, de3)))
    y = pick(np.where(a1 | e1, ppy, zero), np.where(a2, ppy, np.where(e2, ry3, zero)),
             np.where(a3, ppy, np.where(e3, ry3, zero)))
    sq = x * x + y * y + z2
    if not grad:
        return sq
    hx = pick(np.where(a1, ppx, np.where(e1, rx2, zero)),
              np.where(a2, rx2, np.where(e2, rx3, de2 * b1)),
              np.where(a3, ppx, np.where(e3, rx3, de3 * c1)))
    hy = pick(np.where(a1 | e1, ppy, -de1), np.where(a2, ppy, np.where(e2, ry3, -de2 * b0)),
              np.where(a3, ppy, np.where(e3, ry3, -de3 * c0)))
    return sq, hx, hy


def _frame(px, py, pz, F):
    dx, dy, dz = px - F[..., 0], py - F[..., 1], pz - F[..., 2]
    return (F[..., 3] * dx + F[..., 4] * dy + F[..., 5] * dz,
            F[..., 6] * dx + F[..., 7] * dy + F[..., 8] * dz,
            F[..., 9] * dx + F[..., 10] * dy + F[..., 11] * dz)


def replay(packed, centers, cand, valid, half, G: int, rows=None, skip_test=None):
    """K13's two passes in numpy float32 for G threads a node, over the
    padded rows (``cull.cull_rows`` of ``packed`` unless given): (keep,
    counts, sqd_center, each slot's (corner minimum, distance) at every
    anchor (N, K, 27) for the JAX comparison's margins, the winners, pass
    2's tallies {evals, near, skipped, full}). Pass 2 takes the skip test
    before the gradient where ``skip_test`` (default: where the kernel's
    form of G threads does, ``cull.SKIP_LANES``), and asserts in every
    form that the test never holds at an anchor whose full evaluation
    keeps the slot."""
    packed, centers = np.asarray(packed, f32), np.asarray(centers, f32)
    rows = (cull.cull_rows(torch.as_tensor(packed)).numpy() if rows is None
            else np.asarray(rows, f32))
    cand, valid = np.asarray(cand), np.asarray(valid)
    N, K = cand.shape
    T = packed.shape[0]
    h = f32(half)
    qh, eps, near = (f32(x) for x in cull._thresholds(half))
    o = np.array([-h, f32(0), h], f32)
    A = [centers[:, a : a + 1] + o for a in range(3)]             # (N, 3) anchor coordinates
    F = rows[np.where(cand < 0, cand + T, cand)]                  # (N, K, 20)

    def products(F):
        """m[o][a] (N, K, 3): f[3 + 3o] dx, f[4 + 3o] dy, f[5 + 3o] dz."""
        d = [A[a][:, None, :] - F[..., a, None] for a in range(3)]
        return [[F[..., 3 + 3 * r + a, None] * d[a] for a in range(3)] for r in range(3)]

    def pp(m, l):
        i, j, k = l % 3, (l // 3) % 3, l // 9
        return tuple(m[r][0][..., i] + m[r][1][..., j] + m[r][2][..., k] for r in range(3))

    m = products(F)
    # pass 1: a lane's running minima over its slots, then the butterfly
    sq1 = np.stack([_ladder(*pp(m, l), F, False) for l in range(27)], axis=-1)
    sq1 = np.where(valid[..., None], sq1, f32(np.inf))            # (N, K, 27)
    steps = -(-K // G)
    bv = np.full((N, G, 27), np.inf, f32)
    bi = np.full((N, G, 27), INT_MAX, np.int64)
    for st in range(steps):
        for lane in range(G):
            s = st * G + lane
            if s >= K:
                continue
            take = _better(sq1[:, s], s, bv[:, lane], bi[:, lane])
            bv[:, lane] = np.where(take, sq1[:, s], bv[:, lane])
            bi[:, lane] = np.where(take, s, bi[:, lane])
    off = G // 2
    while off:
        pv, pi = bv[:, np.arange(G) ^ off], bi[:, np.arange(G) ^ off]
        take = _better(pv, pi, bv, bi)
        bv, bi = np.where(take, pv, bv), np.where(take, pi, bi)
        off //= 2
    assert (bi == bi[:, :1]).all()
    win = np.take_along_axis(cand, bi[:, 0], axis=1)              # (N, 27) triangles
    # the winners at their sub-cube's corners, and each anchor's largest
    Fw = rows[np.where(win < 0, win + T, win)]                    # (N, 27, 20)
    db = np.empty((N, 27, 8), f32)
    for l in range(27):
        for c in range(8):
            q = [qh if (c >> a) & 1 else -qh for a in range(3)]
            p = [A[a][:, (l // 3 ** a) % 3] + q[a] for a in range(3)]
            db[:, l, c] = np.sqrt(_ladder(*_frame(*p, Fw[:, l]), Fw[:, l], False))
    dbmax = db.max(-1)                                            # NaN if any is
    reach = f32(cull._reach(qh)) * F[..., 19]                     # (N, K)
    skip_test = G in cull.SKIP_LANES if skip_test is None else skip_test
    # pass 2: anchor by anchor; a slot's first keeping anchor ends its loop
    # (the OR over the anchors), and only the anchors before it count
    done = np.zeros((N, K), bool)
    margins = np.empty((N, K, 27, 2), f32)
    tally = dict(evals=0, near=0, skipped=0, full=0)
    for l in range(27):
        ppx, ppy, ppz = pp(m, l)
        sq, hx, hy = _ladder(ppx, ppy, ppz, F, True)
        d = np.sqrt(sq)
        hx, hy, hz = f32(2) * hx, f32(2) * hy, f32(2) * ppz
        c = np.where((d >= f32(1e-20)) | np.isnan(d), d, f32(1e-20))
        inv = (f32(1) / c) * f32(0.5)
        g = [(F[..., 3 + a] * hx + F[..., 6 + a] * hy + F[..., 9 + a] * hz) * inv * qh
             for a in range(3)]
        phi = np.stack([d + (g[0] if c8 & 1 else -g[0]) + (g[1] if c8 & 2 else -g[1])
                        + (g[2] if c8 & 4 else -g[2]) - db[:, l, c8, None]
                        for c8 in range(8)], axis=-1)
        mn = np.where(np.isnan(phi).any(-1), f32(np.nan), phi.min(-1))
        margins[..., l, 0], margins[..., l, 1] = mn, d
        with np.errstate(invalid="ignore"):
            dbm = dbmax[:, l, None]
            lb = (d - reach) - dbm
            skip = lb > eps + f32(SKIP_REL) * ((d + reach) + dbm)
        active = valid & ~done
        by_near = active & (d <= near)
        assert not (active & ~by_near & skip & (mn <= eps)).any(), \
            "the skip test holds at a keeping anchor"
        skip &= skip_test
        skipped = active & ~by_near & skip
        full = active & ~by_near & ~skip
        for name, x in (("evals", active), ("near", by_near), ("skipped", skipped),
                        ("full", full)):
            tally[name] += int(x.sum())
        done |= by_near | (full & (mn <= eps))
    return done, done.sum(1), sq1[..., 13], margins, win, tally


def _decided(packed, centers, cand, valid, half, tie_ulps=64, thr_ulps=16):
    """(N, K) bool: the slots whose keep does not depend on which of each
    anchor's tied nearest candidates (squared distance within ``tie_ulps``
    ulps of the minimum) wins, nor on ``thr_ulps`` ulps at the eps and near
    thresholds (the port's arithmetic, every tied winner tried); invalid
    slots are decided (never kept)."""
    packed, centers = np.asarray(packed, f32), np.asarray(centers, f32)
    cand, valid = np.asarray(cand), np.asarray(valid)
    N, K = cand.shape
    h = f32(half)
    qh, eps, near = (f32(x) for x in cull._thresholds(half))
    o = np.array([-h, f32(0), h], f32)
    F = packed[cand]
    sure = np.zeros((N, K), bool)      # kept at some anchor whatever wins
    maybe = np.zeros((N, K), bool)     # kept at some anchor for some winner
    for l in range(27):
        p = [centers[:, a : a + 1] + o[(l // 3 ** a) % 3] for a in range(3)]
        ppx, ppy, ppz = _frame(*p, F)
        sq, hx, hy = _ladder(ppx, ppy, ppz, F, True)
        sqm = np.where(valid, sq, f32(np.inf))
        mn = sqm.min(1, keepdims=True)
        tied = sqm <= mn + tie_ulps * np.spacing(mn)
        alt = np.argsort(~tied, axis=1, kind="stable")[:, : int(tied.sum(1).max())]
        alt_ok = np.take_along_axis(tied, alt, 1)[:, None, :]          # (N, 1, A)
        Fw = packed[np.take_along_axis(cand, alt, 1)]                  # (N, A, 19)
        db = np.empty(Fw.shape[:2] + (8,), f32)
        for c in range(8):
            pc = [p[a] + (qh if (c >> a) & 1 else -qh) for a in range(3)]
            db[..., c] = np.sqrt(_ladder(*_frame(*pc, Fw), Fw, False))
        d = np.sqrt(sq)
        hx, hy, hz = f32(2) * hx, f32(2) * hy, f32(2) * ppz
        c = np.where((d >= f32(1e-20)) | np.isnan(d), d, f32(1e-20))
        inv = (f32(1) / c) * f32(0.5)
        g = [((F[..., 3 + a] * hx + F[..., 6 + a] * hy + F[..., 9 + a] * hz) * inv * qh)[..., None]
             for a in range(3)]
        phi = np.stack([d[..., None] + (g[0] if c8 & 1 else -g[0]) + (g[1] if c8 & 2 else -g[1])
                        + (g[2] if c8 & 4 else -g[2]) - db[:, None, :, c8] for c8 in range(8)], -1)
        mphi = np.where(np.isnan(phi).any(-1), f32(np.nan), phi.min(-1))   # (N, K, A)
        ulp = np.spacing(np.maximum(np.abs(d), eps))[..., None]
        kalt = (d[..., None] <= near) | (mphi <= eps)
        close = ((np.abs(mphi - eps) <= thr_ulps * ulp)
                 | (np.abs(d[..., None] - near) <= thr_ulps * ulp))
        sure |= np.all(~alt_ok | (kalt & ~close), -1)
        maybe |= np.any(alt_ok & (kalt | close), -1)
    return sure | ~maybe | ~valid


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _equal(got, want):
    """keep, counts and sqd_center bit for bit (NaN where NaN)."""
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert np.array_equal(_bits(got[2]), _bits(want[2]))


# -- CPU: the plain version against JAX ------------------------------------------

def _cases(tables, mesh):
    rng = np.random.default_rng(21)
    out = []
    for depth, n in ((2, 24), (3, 40)):
        centers, half = _centers(mesh, depth, rng.choice(8 ** depth, n, replace=False))
        cand, valid = _rows(tables, centers, 64, rng)
        out.append((f"d{depth} padded", centers, cand, valid, half))
    centers, half = _centers(mesh, 1, np.arange(8))
    cand, valid = _top(tables, 8)
    out.append(("d1 top expanded", centers, cand, valid, half))
    return out


def test_plain_matches_jax():
    import jax.numpy as jnp
    from sdflib_tpu.sdf.exact_octree import _region_cull_chunk

    mesh = _mesh(False)
    tables = _tables(mesh)
    packed = tables.packed.numpy()
    for name, centers, cand, valid, half in _cases(tables, mesh):
        c_t = torch.as_tensor(cand)
        v_t = torch.as_tensor(valid)
        keep, cnt, sqd = cull.region_cull_plain(tables, torch.as_tensor(centers), c_t, v_t,
                                                half)
        jk, jc, js = _region_cull_chunk(
            jnp.asarray(packed), jnp.zeros((packed.shape[0], 6), jnp.float32),
            jnp.asarray(centers), jnp.asarray(np.asarray(c_t)), jnp.asarray(np.asarray(v_t)),
            jnp.float32(half))
        jk, jc, js = np.asarray(jk), np.asarray(jc), np.asarray(js)
        keep, cnt, sqd = keep.numpy(), cnt.numpy(), sqd.numpy()
        v = np.asarray(v_t)
        np.testing.assert_allclose(sqd[v], js[v], rtol=1e-5, atol=1e-9, err_msg=name)
        assert np.isinf(sqd[~v]).all() and np.isinf(js[~v]).all(), name
        dec = _decided(packed, centers, c_t, v_t, half)
        diff = keep != jk
        print(f"{name}: {int(diff.sum())} of {int(v.sum())} valid slots differ, "
              f"{int((dec & v).sum())} decided, {int((diff & dec).sum())} of them differ; "
              f"kept {int(cnt.sum())} (JAX {int(jc.sum())}); max |sqd diff| "
              f"{np.abs(sqd[v] - js[v]).max():.3e}")
        assert not (diff & dec).any(), name
        assert (dec & v).sum() >= 0.85 * v.sum(), name
        assert diff.sum() <= 0.01 * v.sum(), name
        assert abs(int(cnt.sum()) - int(jc.sum())) <= 0.01 * jc.sum(), name
        assert not keep[~v].any() and 0 < cnt.sum() <= v.sum(), name
        if "padded" in name:
            assert cnt[-1] == 0 and not v[-1].any(), name
        else:
            assert cnt.sum() < v.sum(), name    # the top level culls


def test_all_invalid_row_matches_jax():
    import jax.numpy as jnp
    from sdflib_tpu.sdf.exact_octree import _region_cull_chunk

    mesh = _mesh(False)
    tables = _tables(mesh)
    centers, half = _centers(mesh, 2, [5, 21, 42])
    cand = np.random.default_rng(3).integers(0, tables.packed.shape[0], (3, 16)).astype(np.int32)
    valid = np.zeros((3, 16), bool)
    valid[1, :5] = True
    keep, cnt, sqd = cull.region_cull_plain(tables, torch.as_tensor(centers),
                                            torch.as_tensor(cand), torch.as_tensor(valid), half)
    jk, jc, js = _region_cull_chunk(
        jnp.asarray(tables.packed.numpy()), jnp.zeros((tables.packed.shape[0], 6)),
        jnp.asarray(centers), jnp.asarray(cand), jnp.asarray(valid), jnp.float32(half))
    assert np.array_equal(cnt.numpy(), np.asarray(jc)) and cnt[0] == cnt[2] == 0
    assert np.array_equal(keep.numpy(), np.asarray(jk))
    assert np.isinf(sqd[0].numpy()).all() and np.isinf(np.asarray(js)[0]).all()


# -- CPU: K13's order replayed, bit-equal to the plain version -----------------

def _replay_inputs(K: int = 40):
    mesh = _mesh(True)
    tables = _tables(mesh)
    T = tables.packed.shape[0]
    rng = np.random.default_rng(7)
    centers, half = _centers(mesh, 3, rng.choice(512, 17, replace=False))
    cand, valid = _rows(tables, centers, K, rng, ties=True)
    cand[3, 5], valid[3, 5] = T - 2, True       # the zero-area triangle
    cand[4, 7], valid[4, 7] = T - 1, True       # the collinear one
    return mesh, tables, centers, cand, valid, half


@pytest.mark.parametrize("K", (40, 300))
@pytest.mark.parametrize("G", cull.LANES)
def test_replay_equals_plain(G, K):
    mesh, tables, centers, cand, valid, half = _replay_inputs(K)
    want = cull.region_cull_plain(tables, torch.as_tensor(centers), torch.as_tensor(cand),
                                  torch.as_tensor(valid), half)
    got = replay(tables.packed.numpy(), centers, cand, valid, half, G)
    _equal(got[:3], [w.numpy() for w in want])
    assert 0 < int(want[1].sum()) < int(valid.sum())


@pytest.mark.parametrize(("G", "depth"), ((32, 1), (512, 1), (512, 2)))
def test_replay_equals_plain_top_level(G, depth):
    mesh = _mesh(True)
    tables = _tables(mesh)
    centers, half = _centers(mesh, depth, np.arange(8 ** depth))
    cand, valid = _top(tables, 8 ** depth)
    want = cull.region_cull_plain(tables, torch.as_tensor(centers), cand, valid, half)
    got = replay(tables.packed.numpy(), centers, cand, valid, half, G)
    _equal(got[:3], [w.numpy() for w in want])


def test_replay_ties_and_nan_follow_argmin():
    """A triangle twice in a row ties at every anchor: the first slot wins,
    as torch.argmin picks it; a triangle whose fields are NaN wins every
    anchor of its row (a NaN before any number), and the row keeps only
    what the near test keeps."""
    mesh, tables, centers, cand, valid, half = _replay_inputs()
    got = replay(tables.packed.numpy(), centers, cand, valid, half, 32)
    for n in range(len(cand) - 1):
        if valid[n, 1]:
            assert cand[n, 0] == cand[n, 1]
    packed = tables.packed.clone()
    packed[cand[2, 3]] = float("nan")
    nan_tables = eo.CullTables(packed, packed.t().contiguous(), None)
    want = cull.region_cull_plain(nan_tables, torch.as_tensor(centers), torch.as_tensor(cand),
                                  torch.as_tensor(valid), half)
    got = replay(packed.numpy(), centers, cand, valid, half, 512)
    _equal(got[:3], [w.numpy() for w in want])
    assert (got[4][2] == cand[2, 3]).all()
    near = cull._thresholds(half)[2]
    assert np.array_equal(got[0][2], (got[3][2, :, :, 1] <= near).any(-1) & valid[2])
    idx = torch.as_tensor(cand).long()
    sqd = torch.where(torch.as_tensor(valid), sq_dist_packed(
        torch.as_tensor(centers)[:, 0:1], torch.as_tensor(centers)[:, 1:2],
        torch.as_tensor(centers)[:, 2:3], packed[idx]), torch.inf)
    assert int(sqd.argmin(dim=1)[2]) == 3 and bool(torch.isnan(sqd[2, 3]))


def _bisect(fn, lo: float, hi: float) -> tuple[float, float]:
    """Adjacent float32 x (or as close as 80 halvings get) about a change
    of sign of ``fn`` between ``lo`` and ``hi``."""
    below = fn(lo) > 0
    for _ in range(80):
        mid = float(f32(0.5 * (lo + hi)))
        if mid in (lo, hi):
            break
        if (fn(mid) > 0) == below:
            lo = mid
        else:
            hi = mid
    return lo, hi


@functools.lru_cache(maxsize=1)
def _threshold_nodes():
    """Four depth-3 nodes of one row of 40 valid candidates, their centres
    on the normal through triangle 37's centroid: two about the place where
    its distance at the centre anchor crosses ``near`` (one float32 step of
    the centre apart), two where some slot's corner minimum at some anchor
    crosses ``eps`` with its distance past ``near``. Returns (centers,
    cand, valid, half, the near slot, (slot, anchor) of the eps pair)."""
    mesh = _mesh(True)
    tables = _tables(mesh)
    packed = tables.packed.numpy()
    _, half = _centers(mesh, 3, [0])
    _, eps, near = (f32(x) for x in cull._thresholds(half))
    v, idx = mesh.vertices.astype(np.float64), mesh.indices.astype(np.int64)
    tri = v[idx[37]]
    normal = np.cross(tri[1] - tri[0], tri[2] - tri[0])
    normal /= np.linalg.norm(normal)
    at = lambda x: (tri.mean(0) + normal * x).astype(f32)[None]
    cand, valid = _rows(tables, np.concatenate([at(0.0), at(0.0)]), 40,
                        np.random.default_rng(11))
    cand, valid = cand[:1], np.ones((1, 40), bool)
    s0 = int(np.flatnonzero(cand[0] == 37)[0])
    margins = lambda x: replay(packed, at(x), cand, valid, half, 32)[3][0]      # (K, 27, 2)
    n_lo, n_hi = _bisect(lambda x: margins(x)[s0, 13, 1] - near, 0.0, 2.0 * float(near))
    xs = np.linspace(float(near), 6 * half, 48)
    m = [margins(x) for x in xs]
    for a, b, ma, mb in zip(xs, xs[1:], m, m[1:]):
        cross = ((ma[..., 1] > near) & (mb[..., 1] > near)
                 & ((ma[..., 0] <= eps) != (mb[..., 0] <= eps)))
        if cross.any():
            s, l = (int(x) for x in np.argwhere(cross)[0])
            break
    e_lo, e_hi = _bisect(lambda x: margins(x)[s, l, 0] - eps, a, b)
    centers = np.concatenate([at(x) for x in (n_lo, n_hi, e_lo, e_hi)])
    return centers, np.repeat(cand, 4, 0), np.repeat(valid, 4, 0), half, s0, (s, l)


@pytest.mark.parametrize("G", cull.LANES)
def test_replay_equals_plain_near_the_thresholds(G):
    """Candidates within a step of the centre of ``near`` (the distance)
    and of ``eps`` (the corner minimum, within 8 ulps of its terms): the
    replay, skip test and all, bit-equal to the plain version."""
    mesh = _mesh(True)
    tables = _tables(mesh)
    centers, cand, valid, half, s0, (s, l) = _threshold_nodes()
    _, eps, near = (f32(x) for x in cull._thresholds(half))
    want = cull.region_cull_plain(tables, torch.as_tensor(centers), torch.as_tensor(cand),
                                  torch.as_tensor(valid), half)
    got = replay(tables.packed.numpy(), centers, cand, valid, half, G)
    _equal(got[:3], [w.numpy() for w in want])
    d = got[3][:2, s0, 13, 1]
    assert d[0] <= near < d[1] and d[1] - d[0] <= 4 * np.spacing(near)
    mn, dl = got[3][2:, s, l, 0], got[3][2:, s, l, 1]
    assert (dl > near).all() and (mn[0] <= eps) != (mn[1] <= eps)
    assert np.abs(mn - eps).max() <= 8 * np.spacing(dl.max())
    assert got[5]["full"] > 0 and (got[5]["skipped"] > 0) == (G in cull.SKIP_LANES)


def test_replay_nan_never_skips():
    """A NaN bound n, or a NaN among an anchor's corner distances, takes
    the anchor through the full evaluation: no skip, and the same bits."""
    mesh, tables, centers, cand, valid, half = _replay_inputs()
    rows = cull.cull_rows(tables.packed)
    base = replay(tables.packed.numpy(), centers, cand, valid, half, 32, rows=rows,
                  skip_test=True)
    assert base[5]["skipped"] > 0
    nan_rows = rows.clone()
    nan_rows[:, 19] = float("nan")
    got = replay(tables.packed.numpy(), centers, cand, valid, half, 32, rows=nan_rows,
                 skip_test=True)
    assert got[5]["skipped"] == 0 and got[5]["evals"] == base[5]["evals"]
    _equal(got[:3], base[:3])
    packed = tables.packed.clone()
    packed[cand[2, 3]] = float("nan")            # node 2's winner at every anchor
    got = replay(packed.numpy(), centers[2:3], cand[2:3], valid[2:3], half, 512)
    assert (got[4] == cand[2, 3]).all() and got[5]["skipped"] == 0
    assert torch.isnan(cull.cull_rows(packed)[cand[2, 3], 19])


# -- CPU: the wrapper and the build on the CPU -----------------------------------

def test_cpu_wrapper_is_plain():
    mesh, tables, centers, cand, valid, half = _replay_inputs()
    before = cull.launch_count
    args = (tables, torch.as_tensor(centers), torch.as_tensor(cand), torch.as_tensor(valid),
            half)
    want = [x.numpy() for x in cull.region_cull_plain(*args)]
    _equal([x.numpy() for x in cull.region_cull(*args, lanes=32)], want)
    _equal([x.numpy() for x in cull.region_cull(*args, rows=5)], want)     # in 4 chunks
    with pytest.raises(ValueError, match="lanes"):
        cull.region_cull(*args, lanes=64)
    with pytest.raises(ValueError, match="cand"):
        cull.region_cull(tables, args[1], args[2].long(), args[3], half)
    with pytest.raises(ValueError, match="valid"):
        cull.region_cull(tables, args[1], args[2], args[3][:, :8], half)
    m = make_torus(R=0.3, r=0.12, nu=16, nv=8)
    sdf = ExactOctreeSdf(m, m.bounding_box.add_margin(0.14), max_depth=3, start_depth=1,
                         min_triangles_per_node=16, device="cpu")
    assert sdf.num_leaves > 8 and cull.launch_count == before


def test_lanes_for():
    assert [cull.lanes_for(K) for K in (8, 16, 64, 512, 2047, 2048, 131_072)] == [
        32, 32, 32, 32, 32, 512, 512]
    assert all(cull.lanes_for(K) in cull.LANES for K in range(1, 5000))


# -- the card ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = _mesh(True)
    return mesh, _tables(mesh, "cuda")


def _card_inputs(mesh, tables, K: int):
    T = tables.packed.shape[0]
    rng = np.random.default_rng(K)
    if K == 131_072:                  # the top level's expanded rows, row stride 0
        centers, half = _centers(mesh, 1, np.arange(8))
        lane = torch.arange(K, dtype=torch.int32, device="cuda")
        cand = (lane % T).expand(8, -1)
        valid = ((lane < 100_000) & (lane % 7 != 3)).expand(8, -1)
        return torch.as_tensor(centers, device="cuda"), cand, valid, half
    n = {8: 4000, 64: 600, 512: 60}[K]
    centers, half = _centers(mesh, 4, rng.choice(8 ** 4, n, replace=False))
    cand, valid = _rows(_tables(mesh), centers, K, rng, ties=True)
    cand[0, 0], valid[0, 0] = T - 2, True        # the zero-area triangle
    return (torch.as_tensor(centers, device="cuda"), torch.as_tensor(cand, device="cuda"),
            torch.as_tensor(valid, device="cuda"), half)


@pytest.mark.cuda
@pytest.mark.parametrize("K", (8, 64, 512, 131_072))
@pytest.mark.parametrize("lanes", cull.LANES)
def test_kernel_equals_plain(card, K, lanes):
    mesh, tables = card
    centers, cand, valid, half = _card_inputs(mesh, tables, K)
    want = cull.region_cull_plain(tables, centers, cand, valid, half)
    before = cull.launch_count
    got = cull.region_cull(tables, centers, cand, valid, half, lanes=lanes)
    torch.cuda.synchronize()
    assert cull.launch_count == before + 1
    _equal([x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want])
    assert 0 < int(want[1].sum()) < int(valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", cull.LANES)
def test_kernel_near_the_thresholds(card, lanes):
    """The four nodes about ``near`` and ``eps``: bit-equal to the plain
    version on the card, and pass 2's tallies (evaluations, near keeps,
    skips, full evaluations) equal to the replay's: the kernel's launch
    takes the skip test in the forms of ``cull.SKIP_LANES`` and no other."""
    mesh, tables = card
    centers, cand, valid, half, _, _ = _threshold_nodes()
    args = (torch.as_tensor(centers, device="cuda"), torch.as_tensor(cand, device="cuda"),
            torch.as_tensor(valid, device="cuda"), half)
    stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    got = cull.region_cull(tables, *args, lanes=lanes, stats=stats)
    _equal([x.cpu().numpy() for x in got],
           [x.cpu().numpy() for x in cull.region_cull_plain(tables, *args)])
    want = replay(tables.packed.cpu().numpy(), centers, cand, valid, half, lanes)[5]
    assert stats.tolist() == [want[k] for k in ("evals", "near", "skipped", "full")]
    assert (stats[2].item() > 0) == (lanes in cull.SKIP_LANES)


@pytest.mark.cuda
def test_d6_build_groups_in_every_form(card, monkeypatch):
    """The bench torus's d6 build (``chip_smoke.py``'s path A): every node
    group's cull bit-equal to the plain route in each form of K13."""
    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    tris = soa_to_torch(calculate_mesh_triangle_data(mesh), "cuda")
    bmin, size = _box(mesh)
    real = eo._ExactBuild.cull
    seen = []

    def cull_checked(self, group, half):
        centers, cand, valid = group[:3]
        want = eo._cull_group("region", self.tables, centers, cand, valid, half,
                              eo._chunk_rows(cand.shape[1], self.pair_budget), plain=True)
        for lanes in cull.LANES:
            got = cull.region_cull(self.tables, centers, cand, valid, half, lanes=lanes)
            assert all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                   b.view(torch.int32) if b.dtype == torch.float32 else b)
                       for a, b in zip(got, want)), (cand.shape, lanes)
        seen.append(cand.shape)
        return real(self, group, half)

    monkeypatch.setattr(eo._ExactBuild, "cull", cull_checked)
    eo._build_exact(tris, bmin, size, 6, 2, 32)
    assert len(seen) > 4 and max(k for _, k in seen) >= 2048


@pytest.mark.cuda
def test_card_build_launches_k13_per_group(card, monkeypatch):
    mesh = make_torus(R=0.3, r=0.12, nu=48, nv=24)
    tris = soa_to_torch(calculate_mesh_triangle_data(mesh), "cuda")
    bmin, size = _box(mesh)
    cfg = (tris, bmin, size, 5, 2, 32)
    real_group = eo._cull_group
    monkeypatch.setattr(eo, "_cull_group", functools.partial(real_group, plain=True))
    plain = eo._build_exact(*cfg)
    monkeypatch.setattr(eo, "_cull_group", real_group)
    groups = []
    real_cull = eo._ExactBuild.cull
    monkeypatch.setattr(eo._ExactBuild, "cull",
                        lambda self, g, half: groups.append(1) or real_cull(self, g, half))

    def no_plain(*a):
        raise AssertionError("the plain region cull ran on the card")

    monkeypatch.setattr(eo, "region_cull_plain", no_plain)
    monkeypatch.setattr(cull, "region_cull_plain", no_plain)
    before = cull.launch_count
    got = eo._build_exact(*cfg)
    torch.cuda.synchronize()
    assert cull.launch_count - before == len(groups) > 1
    for a, b in zip(got[:3], plain[:3]):
        assert np.array_equal(a, b)
    assert torch.equal(got[3], plain[3])
    assert got[5]["cull_shapes"] == plain[5]["cull_shapes"]
