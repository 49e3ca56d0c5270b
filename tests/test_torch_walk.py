"""K10-K12 (``sdflib_tpu_torch/ops/walk.py``, ``csrc/octree_walk.cu``):
the walk over a given coefficient tensor, its backward and the march.

On the CPU the wrappers take their plain versions, which are held against
the JAX package on ``tests/test_diff.py``'s octree (an icosphere,
subdivisions 2, radius 0.35, box margin 0.14, max_depth 4, start_depth 1,
threshold 1e-3; tricubic and trilinear, built by the JAX package and
loaded into the port) and on a reference ``.bin`` (``fast=False``):

* ``walk_query_plain`` against JAX ``_octree_query``: d within 1e-6, the
  normalised gradient within 1e-5;
* the Function of ``diff/query.py`` (K10 forward, K11 backward on the
  card): its coefficient gradient against ``jax.vjp`` of JAX
  ``octree_query_diff`` with a seeded cotangent on d and on (d, g), within
  rtol/atol 1e-5;
* its point gradient, in the box and outside it, against autograd of the
  plain walk's graph (the code that ran before K10), relative 1e-5;
* NaN, +-inf and empty batches, and the second-derivative route (autograd
  of the plain walk, equal to it bit for bit);
* the coefficient gradient at NaN, infinite and far points against
  ``jax.vjp``: NaN at the same entries, the other rows within 1e-5.

The ``cuda`` cases hold each kernel against its plain version on a card:
K10 within 1e-6 (d) and 1e-5 (gradients; the tricubic sum's order differs
from torch's), K11 within 1e-5 of the largest gradient (its atomics add
in an order that changes from run to run), K12 by hit masks >= 99.9% and
q99 depth difference <= 1e-4 of the box (K5's gate); ``OctreeSdf``
distances of points that require a gradient run K10 and K11. JAX is imported
inside fixtures and tests: the card's machine has none (``pytest
--noconftest -m cuda tests/test_torch_walk.py`` there).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdflib_tpu_torch import OctreeSdf
from sdflib_tpu_torch.diff.query import octree_coefficients, octree_query_diff
from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin
from sdflib_tpu_torch.kernels import build
from sdflib_tpu_torch.ops import walk as ow
from sdflib_tpu_torch.render.sphere_trace import sphere_trace
from sdflib_tpu_torch.sdf import octree as po
from sdflib_tpu_torch.utils.primitives import make_icosphere

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
BIN = "tests/golden/data/builders_octree_nc.bin"
CASES = [("tricubic", True), ("tricubic", False), ("trilinear", True), ("trilinear", False)]
CFG = dict(max_depth=4, start_depth=1, termination_threshold=1e-3)


def _jax_icosphere(interpolation):
    from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
    from sdflib_tpu.utils.primitives import make_icosphere as j_ico

    mesh = j_ico(subdivisions=2, radius=0.35)
    return JOctree(mesh, mesh.bounding_box.add_margin(0.14), interpolation=interpolation, **CFG)


_PAIRS = {}


def _pair(interpolation, fast):
    """(JAX octree, port octree on the CPU, fast): the icosphere, or for
    tricubic with ``fast=False`` the reference ``.bin`` (any layout; the
    trilinear case reads the icosphere's aligned words word by word)."""
    key = (interpolation, fast)
    if key not in _PAIRS:
        if interpolation == "tricubic" and not fast:
            from sdflib_tpu.io.sdflib_binary import load_sdflib_bin as j_load_bin

            j, p = j_load_bin(BIN), load_sdflib_bin(BIN, device="cpu")
            assert not p._fast_layout
        else:
            j = _jax_icosphere(interpolation)
            p = OctreeSdf.from_jax_state(j._state_arrays(), device="cpu")
        _PAIRS[key] = (j, p)
    return _PAIRS[key]


def _walk(p, fast, coeffs=None):
    words = p._octree_dev
    return ow.Walk(words, words.view(torch.float32) if coeffs is None else coeffs, p._box_min,
                   p._box_size3, float(p.min_border_value), p.start_grid_size,
                   p.max_depth - p.start_depth, p.num_coefficients, p.interpolation, fast)


def _points(p, n, seed, spread=0.2):
    """n points (seed) over the box widened by ``spread`` of its size on
    each side: most inside, some outside."""
    lo, hi = np.asarray(p.box.min, np.float64), np.asarray(p.box.max, np.float64)
    pad = spread * (hi - lo)
    return np.random.default_rng(seed).uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)


def _args(sdf):
    return (np.asarray(sdf.box.min, np.float32), np.float32(sdf.box.size[0]),
            sdf.start_grid_size, np.float32(sdf.min_border_value))


def _jargs(sdf):
    import jax.numpy as jnp

    a = _args(sdf)
    return jnp.asarray(a[0]), jnp.float32(a[1]), a[2], jnp.float32(a[3])


def _kw(p, fast):
    return dict(levels=p.max_depth - p.start_depth, num_coeff=p.num_coefficients,
                interpolation=p.interpolation, fast=fast)


@pytest.mark.parametrize("interpolation,fast", CASES)
def test_plain_walk_matches_jax(interpolation, fast):
    import jax.numpy as jnp
    from sdflib_tpu.sdf import octree as jo

    j, p = _pair(interpolation, fast)
    pts = _points(p, 2048, 11)
    w = _walk(p, fast)
    d = ow.walk_query_plain(w, torch.as_tensor(pts), "distance")
    d_n, g_n = ow.walk_query_plain(w, torch.as_tensor(pts), "normal")
    assert torch.equal(d, d_n)
    jb = (jnp.asarray(j.box.min, jnp.float32), jnp.float32(j.box.size[0]))
    common = dict(levels=j.max_depth - j.start_depth, num_coeff=p.num_coefficients,
                  interpolation=interpolation, fast=fast)
    jd = jo._octree_query(j.octree_data, jnp.asarray(pts), *jb, j.start_grid_size,
                          jnp.float32(j.min_border_value), with_gradient=False, **common)
    _, jg = jo._octree_query(j.octree_data, jnp.asarray(pts), *jb, j.start_grid_size,
                             jnp.float32(j.min_border_value), with_gradient=True, **common)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_n.numpy(), np.asarray(jg), rtol=0, atol=1e-5)
    # the wrapper on CPU tensors is the plain version, and so is the
    # structure's walk route
    assert torch.equal(ow.walk_query(w, torch.as_tensor(pts), "distance"), d)
    assert torch.equal(p.get_distance(pts), d)


@pytest.mark.parametrize("cotangent", ["d", "d_and_g"])
@pytest.mark.parametrize("interpolation,fast", CASES)
def test_function_gradient_matches_jax(interpolation, fast, cotangent):
    import jax
    import jax.numpy as jnp
    from sdflib_tpu.diff.query import octree_coefficients as j_coeffs
    from sdflib_tpu.diff.query import octree_query_diff as j_query

    j, p = _pair(interpolation, fast)
    pts = _points(p, 1024, 21, spread=0.1)
    rng = np.random.default_rng(22)
    ct_d = rng.normal(size=1024).astype(np.float32)
    ct_g = rng.normal(size=(1024, 3)).astype(np.float32)
    kw = _kw(p, fast)
    grad = cotangent == "d_and_g"
    c = octree_coefficients(p._octree_dev).requires_grad_(True)
    out = octree_query_diff(p._octree_dev, c, pts, *_args(p), with_gradient=grad, **kw)
    if grad:
        (gc,) = torch.autograd.grad(out, c, (torch.as_tensor(ct_d), torch.as_tensor(ct_g)))
    else:
        (gc,) = torch.autograd.grad(out, c, torch.as_tensor(ct_d))
    _, vjp = jax.vjp(lambda cc: j_query(j.octree_data, cc, jnp.asarray(pts), *_jargs(j),
                                        with_gradient=grad, **kw), j_coeffs(j.octree_data))
    (jgc,) = vjp((jnp.asarray(ct_d), jnp.asarray(ct_g)) if grad else jnp.asarray(ct_d))
    jgc = np.asarray(jgc)
    assert np.count_nonzero(jgc) > 0
    np.testing.assert_allclose(gc.numpy(), jgc, **TOL)


@pytest.mark.parametrize("where", ["in_box", "outside"])
@pytest.mark.parametrize("interpolation,fast", CASES)
def test_point_gradient_matches_old_autograd(interpolation, fast, where):
    _, p = _pair(interpolation, fast)
    pts = _points(p, 1024, 31, spread=0.3)
    lo, hi = np.asarray(p.box.min), np.asarray(p.box.max)
    inside = np.all((pts > lo) & (pts < hi), axis=1)
    pts = pts[inside if where == "in_box" else ~inside]
    assert len(pts) > 50
    gd = np.random.default_rng(32).normal(size=len(pts)).astype(np.float32)
    c = octree_coefficients(p._octree_dev)
    x = torch.tensor(pts, requires_grad=True)
    d = octree_query_diff(p._octree_dev, c, x, *_args(p), **_kw(p, fast))
    (gx,) = torch.autograd.grad(d, x, torch.as_tensor(gd))
    x_old = torch.tensor(pts, requires_grad=True)
    old = ow.walk_query_plain(_walk(p, fast, c), x_old, "distance")
    (gx_old,) = torch.autograd.grad(old, x_old, torch.as_tensor(gd))
    scale = float(gx_old.abs().max())
    assert np.isfinite(scale) and scale > 0
    np.testing.assert_allclose(gx.numpy() / scale, gx_old.numpy() / scale, rtol=0, atol=1e-5)


def test_edge_points_read_the_plain_version():
    """NaN and +-inf points read what the plain walk (and JAX) reads and
    put NaN into the coefficient gradient, at no entry that the finite
    points' sum holds a number; an empty batch gives empty answers and a
    zero gradient."""
    import jax.numpy as jnp
    from sdflib_tpu.diff.query import octree_coefficients as j_coeffs
    from sdflib_tpu.diff.query import octree_query_diff as j_query

    j, p = _pair("tricubic", True)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    pts = np.array([[nan, 0, 0], [0, nan, 0], [inf, 0, 0], [0, -inf, 0], [0, 0, inf],
                    [0.05, -0.11, 0.2]], np.float32)
    kw = _kw(p, True)
    c = octree_coefficients(p._octree_dev).requires_grad_(True)
    d, g = octree_query_diff(p._octree_dev, c, pts, *_args(p), with_gradient=True, **kw)
    d_plain, g_plain = ow.walk_query_plain(_walk(p, True, c.detach()), torch.as_tensor(pts),
                                           "world")
    jd, jg = j_query(j.octree_data, j_coeffs(j.octree_data), jnp.asarray(pts), *_jargs(j),
                     with_gradient=True, **kw)
    np.testing.assert_array_equal(d.detach().numpy(), d_plain.numpy())
    np.testing.assert_array_equal(g.detach().numpy(), g_plain.numpy())
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert np.isnan(d[:2].detach().numpy()).all() and np.isposinf(d[2:5].detach().numpy()).all()
    assert (g[:5] == 0).all()
    (gc,) = torch.autograd.grad(d.sum() + g.sum(), c)
    (gc_one,) = torch.autograd.grad(
        octree_query_diff(p._octree_dev, c, pts[5:], *_args(p), with_gradient=True, **kw)[0]
        .sum() + octree_query_diff(p._octree_dev, c, pts[5:], *_args(p), with_gradient=True,
                                   **kw)[1].sum(), c)
    bad = torch.isnan(gc)
    assert bad.any() and torch.isfinite(gc_one).all()
    assert not bad[gc_one != 0].any()
    assert torch.equal(gc[~bad], gc_one[~bad])      # elsewhere the edge points add 0
    assert int((gc_one != 0).sum()) > 0
    empty = np.zeros((0, 3), np.float32)
    de = octree_query_diff(p._octree_dev, c, empty, *_args(p), **kw)
    assert de.shape == (0,)
    (gce,) = torch.autograd.grad(de.sum(), c)
    assert not gce.any()
    d0, g0 = po._octree_query(p._octree_dev, torch.as_tensor(empty), p._box_min, p._box_size3,
                              p.start_grid_size, p.min_border_value,
                              levels=kw["levels"], num_coeff=64, interpolation="tricubic",
                              with_gradient=True)
    assert d0.shape == (0,) and g0.shape == (0, 3)


# NaN, infinite and far points on each axis, beside finite ones
EDGE = np.array([[np.nan, 0, 0], [0, np.nan, 0], [0, 0, np.nan], [np.nan] * 3,
                 [np.inf, 0, 0], [0, -np.inf, 0], [0, 0, np.inf], [-np.inf, np.inf, 0],
                 [1e30, 0, 0], [0, -1e30, 0], [3e12, 0, 0]], np.float32)


@pytest.mark.parametrize("cotangent", ["d", "d_and_g"])
@pytest.mark.parametrize("interpolation,fast", CASES)
def test_edge_points_coefficient_gradient_matches_jax(interpolation, fast, cotangent):
    """The Function's coefficient gradient at NaN, infinite and far points
    against ``jax.vjp``: NaN at the same entries (each such point's weights
    times 0, added at the leaf it reaches from the nearest start cell), and
    every row that holds no NaN within rtol/atol 1e-5. A NaN row's finite
    entries are not compared: XLA converts a NaN position to cell 0 and
    walks the point as inside the box, adding gd times its finite weights
    there; the port holds a NaN point outside, as its forward does."""
    import jax
    import jax.numpy as jnp
    from sdflib_tpu.diff.query import octree_coefficients as j_coeffs
    from sdflib_tpu.diff.query import octree_query_diff as j_query

    j, p = _pair(interpolation, fast)
    pts = np.concatenate([EDGE, _points(p, 256, 24, spread=0.1)])
    rng = np.random.default_rng(25)
    ct_d = rng.normal(size=len(pts)).astype(np.float32)
    ct_g = rng.normal(size=(len(pts), 3)).astype(np.float32)
    kw = _kw(p, fast)
    grad = cotangent == "d_and_g"
    c = octree_coefficients(p._octree_dev).requires_grad_(True)
    out = octree_query_diff(p._octree_dev, c, pts, *_args(p), with_gradient=grad, **kw)
    cts = (torch.as_tensor(ct_d), torch.as_tensor(ct_g)) if grad else torch.as_tensor(ct_d)
    (gc,) = torch.autograd.grad(out, c, cts)
    _, vjp = jax.vjp(lambda cc: j_query(j.octree_data, cc, jnp.asarray(pts), *_jargs(j),
                                        with_gradient=grad, **kw), j_coeffs(j.octree_data))
    (jgc,) = vjp((jnp.asarray(ct_d), jnp.asarray(ct_g)) if grad else jnp.asarray(ct_d))
    gc, jgc = gc.numpy(), np.asarray(jgc)
    assert np.isnan(jgc).sum() > 0
    np.testing.assert_array_equal(np.isnan(gc), np.isnan(jgc))
    nc = p.num_coefficients
    if fast:
        rows = np.isnan(gc).reshape(-1, nc).any(1)
        keep = ~np.repeat(rows, nc)
    else:     # rows at any base: drop the span of each NaN entry's row
        keep = np.ones(gc.shape, bool)
        for k in np.flatnonzero(np.isnan(gc)):
            keep[max(k - nc + 1, 0):k + nc] = False
    assert np.count_nonzero(jgc[keep]) > 0
    np.testing.assert_allclose(gc[keep], jgc[keep], **TOL)


@pytest.mark.parametrize("interpolation,fast", CASES[:2])
def test_second_derivative_route_equals_old_autograd(interpolation, fast):
    """g of points that require a gradient takes autograd of the plain
    walk: its point and coefficient gradients equal the old graph's."""
    _, p = _pair(interpolation, fast)
    pts = _points(p, 512, 41, spread=0.0)
    kw = _kw(p, fast)
    c = octree_coefficients(p._octree_dev).requires_grad_(True)
    x = torch.tensor(pts, requires_grad=True)
    d, g = octree_query_diff(p._octree_dev, c, x, *_args(p), with_gradient=True, **kw)
    loss = (d * d).sum() + (g * g).sum()
    gx, gc = torch.autograd.grad(loss, (x, c))
    c_old = c.detach().clone().requires_grad_(True)
    x_old = torch.tensor(pts, requires_grad=True)
    d_o, g_o = ow.walk_query_plain(_walk(p, fast, c_old), x_old, "world")
    gx_o, gc_o = torch.autograd.grad((d_o * d_o).sum() + (g_o * g_o).sum(), (x_old, c_old))
    assert torch.equal(gx, gx_o) and torch.equal(gc, gc_o)
    assert float(gx.abs().max()) > 0


def test_march_plain_is_sphere_trace_over_the_walk():
    """``walk_march`` on CPU tensors is ``sphere_trace`` over the plain
    walk, bit for bit (the wrapper adds no arithmetic), with each ray's
    trips, the longest of which is sphere_trace's count."""
    _, p = _pair("tricubic", True)
    n = 24
    u = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    gu, gv = np.meshgrid(0.6 * u, 0.6 * u)
    o = np.stack([gu, gv, np.full_like(gu, -1.0)], -1).reshape(-1, 3).astype(np.float32)
    dirs = np.tile([[0.0, 0.0, 1.0]], (n * n, 1)).astype(np.float32)
    w = _walk(p, True)
    size = np.float32(p.box.size[0])
    eps, far = float(np.float32(1e-4) * size), float(np.float32(4.0) * size)
    got = ow.walk_march(w, torch.as_tensor(o), torch.as_tensor(dirs), eps, far, 96)
    ref = sphere_trace(lambda q: p.get_distance(q), torch.as_tensor(o), dirs, eps=eps, far=far,
                       max_iters=96)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b)
    assert got[3].shape == (n * n,) and got[3].dtype == torch.int32
    assert torch.equal(got[3].max(), ref[3])           # sphere_trace's last trip
    assert 0 < int(got[0].sum()) < n * n


def test_wrappers_check_their_inputs():
    _, p = _pair("tricubic", True)
    w = _walk(p, True)
    pts = torch.as_tensor(_points(p, 16, 51))
    bad = [
        (w._replace(num_coeff=8), pts),
        (w._replace(words=w.words.to(torch.int64)), pts),
        (w._replace(coeffs=w.coeffs[:-8]), pts),
        (w._replace(box_min=w.box_min.double()), pts),
        (w._replace(levels=31), pts),
        (w, pts.double()),
        (w, pts.t()),
        (w, pts[:, :2].contiguous()),
    ]
    for walk, x in bad:
        with pytest.raises(ValueError):
            ow.walk_query(walk, x, "distance")
    with pytest.raises(ValueError):
        ow.walk_query(w, pts, "gradient")
    gd = torch.ones(16)
    with pytest.raises(ValueError):
        ow.walk_backward(w, pts, gd[:8])
    with pytest.raises(ValueError):        # the point gradient through g: a second derivative
        ow.walk_backward(w, pts, gd, torch.ones(16, 3), points_grad=True)
    with pytest.raises(ValueError):
        ow.walk_march(w, pts, pts[:8], 1e-4, 1.0, 8)


def test_entry_points_match_the_source():
    """The five entry points exist in ``csrc/octree_walk.cu`` with as many
    parameters as ``kernels/build.py`` gives them (no compiler here)."""
    src = (Path(build.__file__).parent.parent / "csrc" / "octree_walk.cu").read_text()
    walk_params = len(re.search(r"#define SDF_WALK_PARAMS(.*?)\n#define", src, re.S)
                      .group(1).split(","))
    for name in ("sdf_walk_query", "sdf_walk_keys", "sdf_walk_reduce", "sdf_walk_backward",
                 "sdf_walk_march"):
        m = re.search(r'extern "C" int ' + name + r"\(SDF_WALK_PARAMS,(.*?)\)\s*\{", src, re.S)
        assert m is not None, name
        assert walk_params + len(m.group(1).split(",")) == len(build._SIGNATURES[name]), name


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module", params=["tricubic", "trilinear"])
def cuda_tree(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_icosphere(subdivisions=2, radius=0.35)
    return OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), device="cuda",
                     interpolation=request.param, init_algorithm="no_continuity",
                     **dict(CFG, max_depth=5))


def _card_points(tree, n=1 << 14, seed=61):
    pts = _points(tree, n, seed, spread=0.2)
    pts[:4] = [[np.nan, 0, 0], [np.inf, 0, 0], [0, -np.inf, 0], [0, 0, np.nan]]
    return torch.as_tensor(pts, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("mode", ow.MODES)
def test_k10_against_plain(cuda_tree, fast, mode):
    w = _walk(cuda_tree, fast)
    pts = _card_points(cuda_tree)
    ref = ow.walk_query_plain(w, pts, mode)
    ow.launch_count = 0
    got = ow.walk_query(w, pts, mode)
    assert ow.launch_count == 1
    ref, got = (ref, got) if mode != "distance" else ((ref,), (got,))
    assert torch.equal(torch.isnan(got[0]), torch.isnan(ref[0]))
    fin = torch.isfinite(ref[0])
    assert torch.equal(got[0][~fin & ~torch.isnan(ref[0])], ref[0][~fin & ~torch.isnan(ref[0])])
    assert float((got[0][fin] - ref[0][fin]).abs().max()) <= 1e-6
    if mode != "distance":
        ok = torch.isfinite(ref[1]).all(1) & fin
        scale = 1.0 if mode == "normal" else float(ref[1][ok].abs().max())
        assert float((got[1][ok] - ref[1][ok]).abs().max()) <= 1e-5 * scale
    empty = pts[:0]
    assert ow.walk_query(w, empty, mode) is not None and ow.launch_count == 1


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("with_gg", [False, True])
def test_k11_against_plain(cuda_tree, fast, with_gg):
    c = octree_coefficients(cuda_tree._octree_dev)
    w = _walk(cuda_tree, fast, c)
    pts = torch.cat([torch.as_tensor(EDGE, device="cuda"), _card_points(cuda_tree)])
    n = pts.shape[0]
    rng = np.random.default_rng(62)
    gd = torch.as_tensor(rng.normal(size=n).astype(np.float32), device="cuda")
    gg = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device="cuda") \
        if with_gg else None
    ref_c, _ = ow.walk_backward_plain(w, pts, gd, gg)
    ow.backward_launch_count = 0
    got_c, _ = ow.walk_backward(w, pts, gd, gg)
    assert ow.backward_launch_count == 1
    # the edge points' NaN at the same entries, the rest within 1e-5
    nan = torch.isnan(ref_c)
    assert nan.any() and torch.equal(torch.isnan(got_c), nan)
    scale = float(ref_c[~nan].abs().max())
    assert scale > 0
    assert float((got_c[~nan] - ref_c[~nan]).abs().max()) <= 1e-5 * scale
    if not with_gg:
        _, ref_p = ow.walk_backward_plain(w, pts, gd, None, False, True)
        _, got_p = ow.walk_backward(w, pts, gd, None, False, True)
        ok = torch.isfinite(ref_p).all(1)
        p_scale = float(ref_p[ok].abs().max())
        assert float((got_p[ok] - ref_p[ok]).abs().max()) <= 1e-5 * p_scale


@pytest.mark.cuda
def test_k12_against_plain(cuda_tree):
    n = 128
    u = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    gu, gv = np.meshgrid(0.6 * u, 0.6 * u)
    o = np.stack([gu, gv, np.full_like(gu, -1.0)], -1).reshape(-1, 3).astype(np.float32)
    dirs = np.tile([[0.0, 0.0, 1.0]], (n * n, 1)).astype(np.float32)
    o, dirs = torch.as_tensor(o, device="cuda"), torch.as_tensor(dirs, device="cuda")
    w = _walk(cuda_tree, True)
    box = float(cuda_tree.box.size[0])
    eps, far = float(np.float32(1e-4) * np.float32(box)), float(np.float32(4.0) * np.float32(box))
    ref = ow.walk_march_plain(w, o, dirs, eps, far, 256)
    ow.march_launch_count = 0
    got = ow.walk_march(w, o, dirs, eps, far, 256)
    assert ow.march_launch_count == 1
    assert got[3].shape == ref[3].shape and got[3].dtype == torch.int32
    assert 0 < int(got[3].max()) <= 256
    assert float((got[0] == ref[0]).float().mean()) >= 0.999
    both = got[0] & ref[0]
    assert int(both.sum()) > 0
    assert float(torch.quantile((got[2][both] - ref[2][both]).abs(), 0.99)) <= 1e-4 * box


@pytest.mark.cuda
def test_diff_path_launches_the_kernels(cuda_tree):
    """octree_query_diff, render_depth_diff and depth_fit_loss on the card
    run K10-K12; the forward equals the walk route bit for bit."""
    from sdflib_tpu_torch.diff.render import depth_fit_loss, render_depth_diff

    t = cuda_tree
    kw = _kw(t, t._fast_layout)
    pts = _card_points(t)[4:].contiguous()
    ow.launch_count = ow.backward_launch_count = ow.march_launch_count = 0
    c = octree_coefficients(t._octree_dev).requires_grad_(True)
    d = octree_query_diff(t._octree_dev, c, pts, *_args(t), **kw)
    assert torch.equal(d.detach(), t.get_distance(pts))
    (gc,) = torch.autograd.grad(d.square().sum(), c)
    assert ow.launch_count == 2 and ow.backward_launch_count == 1
    n = 64
    u = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    gu, gv = np.meshgrid(0.6 * u, 0.6 * u)
    o = np.stack([gu, gv, np.full_like(gu, -1.0)], -1).reshape(-1, 3).astype(np.float32)
    dirs = np.tile([[0.0, 0.0, 1.0]], (n * n, 1)).astype(np.float32)
    r_kw = {k: v for k, v in kw.items()}
    td, th = render_depth_diff(t._octree_dev, c.detach(), o, dirs, *_args(t), **r_kw)
    assert ow.march_launch_count == 1
    loss = depth_fit_loss(t._octree_dev, c, o, dirs, td, th, *_args(t), **r_kw)
    loss.backward()
    assert ow.march_launch_count == 2 and ow.backward_launch_count == 2
    assert torch.isfinite(c.grad).all()


@pytest.mark.cuda
def test_octree_distance_gradient_runs_k10_and_k11(cuda_tree):
    """``OctreeSdf.get_distance`` of CUDA points that require a gradient
    launches K10 forward and K11 backward, and matches autograd of the
    plain walk; the normalised gradient of such points, a second
    derivative, takes the plain walk and launches neither."""
    t = cuda_tree
    pts = _card_points(t)
    gd = torch.as_tensor(np.random.default_rng(63).normal(size=pts.shape[0])
                         .astype(np.float32), device="cuda")
    x = pts.clone().requires_grad_(True)
    ow.launch_count = ow.backward_launch_count = 0
    d = t.get_distance(x)
    (gx,) = torch.autograd.grad(d, x, gd)
    assert ow.launch_count == 1 and ow.backward_launch_count == 1
    x_old = pts.clone().requires_grad_(True)
    old = ow.walk_query_plain(_walk(t, t._fast_layout), x_old, "distance")
    (g_old,) = torch.autograd.grad(old, x_old, gd)
    assert torch.equal(torch.isnan(d.detach()), torch.isnan(old.detach()))
    fin = torch.isfinite(old.detach())
    assert float((d.detach()[fin] - old.detach()[fin]).abs().max()) <= 1e-6
    ok = torch.isfinite(g_old).all(1)
    scale = float(g_old[ok].abs().max())
    assert float((gx[ok] - g_old[ok]).abs().max()) <= 1e-5 * scale
    d_n, g_n = t.get_distance_and_gradient(x)
    (g_n.sum() + d_n.sum()).backward()
    assert ow.launch_count == 1 and ow.backward_launch_count == 1
