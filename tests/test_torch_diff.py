"""The port's differentiable queries (``sdflib_tpu_torch/diff``) against
the JAX package's ``diff/``, on ``tests/test_diff.py``'s octree (an
icosphere, subdivisions 2, radius 0.35, box margin 0.14, max_depth 4,
start_depth 1, threshold 1e-3), built by the JAX package and loaded into
the port, so both query the same words.

Tolerances: the forward equals the port's own walk bit for bit and JAX's
within 1e-6; the coefficient gradient within 1e-5 of ``jax.grad`` on 512
points (seed 0) and at ``test_diff.py``'s single point. ``jax.grad`` with
respect to the points is NaN at every in-box point (the box fallback's
square root at 0 in the unselected branch, ROADMAP.md Queue 3), so the
port's autograd point gradient is held within 1e-5 (relative) to the
analytic ``with_gradient`` output of both packages, which is what it
equals. ``fast=False`` on a reference ``.bin`` octree and the trilinear
model are covered the same way. ``render_depth_diff`` at 32^2: JAX's hit
mask and depths within 1e-5; ``depth_fit_loss``: the first loss and
gradient within 1e-5; a 60-step Adam fit (``test_diff.py``'s recipe,
``torch.optim.Adam``) below 0.15x its first loss."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflib_tpu.diff.query import octree_coefficients as j_coeffs
from sdflib_tpu.diff.query import octree_query_diff as j_query
from sdflib_tpu.diff.render import depth_fit_loss as j_loss
from sdflib_tpu.diff.render import render_depth_diff as j_render
from sdflib_tpu.io.sdflib_binary import load_sdflib_bin as j_load_bin
from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
from sdflib_tpu.utils.primitives import make_icosphere as j_ico
from sdflib_tpu_torch import OctreeSdf
from sdflib_tpu_torch.diff.query import octree_coefficients, octree_query_diff
from sdflib_tpu_torch.diff.render import depth_fit_loss, render_depth_diff
from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_octree(interpolation="tricubic"):
    mesh = j_ico(subdivisions=2, radius=0.35)
    box = mesh.bounding_box.add_margin(0.14)
    return JOctree(mesh, box, max_depth=4, start_depth=1, termination_threshold=1e-3,
                   interpolation=interpolation)


@pytest.fixture(scope="module")
def pair():
    j = _jax_octree()
    return j, OctreeSdf.from_jax_state(j._state_arrays(), device="cpu")


def _args(sdf):
    return (np.asarray(sdf.box.min, np.float32), np.float32(sdf.box.size[0]),
            sdf.start_grid_size, np.float32(sdf.min_border_value))


def _jargs(sdf):
    a = _args(sdf)
    return jnp.asarray(a[0]), jnp.float32(a[1]), a[2], jnp.float32(a[3])


def _grads(j, p, pts, w, **kw):
    """(port d, coefficient grad, point grad) and JAX's (d, coefficient
    grad, analytic g) for the loss sum(w * d)."""
    levels = p.max_depth - p.start_depth
    c = octree_coefficients(p._octree_dev).requires_grad_(True)
    x = torch.tensor(pts, requires_grad=True)
    d = octree_query_diff(p._octree_dev, c, x, *_args(p), levels=levels, **kw)
    (d * torch.as_tensor(w)).sum().backward()
    jc = j_coeffs(j.octree_data)

    def f(cc):
        return jnp.sum(j_query(j.octree_data, cc, jnp.asarray(pts), *_jargs(j),
                               levels=levels, **kw) * w)

    jd = np.asarray(j_query(j.octree_data, jc, jnp.asarray(pts), *_jargs(j),
                            levels=levels, **kw))
    _, jg = j_query(j.octree_data, jc, jnp.asarray(pts), *_jargs(j), levels=levels,
                    with_gradient=True, **kw)
    return (d.detach().numpy(), c.grad.numpy(), x.grad.numpy(),
            jd, np.asarray(jax.grad(f)(jc)), np.asarray(jg))


def test_forward_matches_walk_and_jax(pair):
    j, p = pair
    pts = np.random.default_rng(0).uniform(-0.3, 0.3, (512, 3)).astype(np.float32)
    c = octree_coefficients(p._octree_dev)
    d = octree_query_diff(p._octree_dev, c, pts, *_args(p), levels=p.max_depth - p.start_depth)
    assert torch.equal(d, p.get_distance(pts))             # the walk route, bit for bit
    jd = j_query(j.octree_data, j_coeffs(j.octree_data), jnp.asarray(pts), *_jargs(j),
                 levels=j.max_depth - j.start_depth)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("where", ["512_points", "single_point"])
def test_gradients_match_jax(pair, where):
    j, p = pair
    if where == "single_point":
        pts, w = np.array([[0.05, -0.11, 0.2]], np.float32), np.ones(1, np.float32)
    else:
        pts = np.random.default_rng(0).uniform(-0.3, 0.3, (512, 3)).astype(np.float32)
        w = np.random.default_rng(3).normal(size=512).astype(np.float32)
    d, cg, xg, jd, jcg, jg = _grads(j, p, pts, w)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cg, jcg, **TOL)
    nz = np.nonzero(cg)[0]
    if where == "single_point":   # one leaf's coefficient block (test_diff.py:44)
        assert 1 <= len(nz) <= 64 and nz.max() - nz.min() < 64
    # the point gradient is w times the analytic gradient (JAX's is NaN)
    assert np.isnan(np.asarray(jax.grad(lambda x: jnp.sum(j_query(
        j.octree_data, j_coeffs(j.octree_data), x, *_jargs(j),
        levels=j.max_depth - j.start_depth)))(jnp.asarray(pts)))).all()
    scale = np.abs(jg).max()
    np.testing.assert_allclose(xg / scale, w[:, None] * jg / scale, rtol=0, atol=1e-5)
    c = octree_coefficients(p._octree_dev)
    _, g = octree_query_diff(p._octree_dev, c, pts, *_args(p),
                             levels=p.max_depth - p.start_depth, with_gradient=True)
    np.testing.assert_allclose(g.numpy() / scale, jg / scale, rtol=0, atol=1e-5)


def test_finite_difference_of_coefficient(pair):
    """test_diff.py:56-63: a central difference on one touched coefficient."""
    _, p = pair
    pts = torch.tensor([[0.05, -0.11, 0.2]])
    levels = p.max_depth - p.start_depth
    c = octree_coefficients(p._octree_dev).requires_grad_(True)
    octree_query_diff(p._octree_dev, c, pts, *_args(p), levels=levels).sum().backward()
    nz = torch.nonzero(c.grad)[:, 0]
    i = int(nz[len(nz) // 2])
    f = lambda cc: float(octree_query_diff(p._octree_dev, cc, pts, *_args(p), levels=levels))
    cp, cm = c.detach().clone(), c.detach().clone()
    cp[i] += 1e-3
    cm[i] -= 1e-3
    assert (f(cp) - f(cm)) / 2e-3 == pytest.approx(float(c.grad[i]), rel=1e-2, abs=1e-4)


def test_any_layout_on_reference_bin():
    """fast=False on a reference .bin octree (coefficients at base +
    arange): forward and coefficient gradient against JAX's."""
    path = "tests/golden/data/builders_octree_nc.bin"
    j, p = j_load_bin(path), load_sdflib_bin(path, device="cpu")
    assert not p._fast_layout
    lo, hi = np.asarray(p.box.min) + 1e-3, np.asarray(p.box.max) - 1e-3
    pts = np.random.default_rng(4).uniform(lo, hi, (512, 3)).astype(np.float32)
    w = np.random.default_rng(5).normal(size=512).astype(np.float32)
    d, cg, xg, jd, jcg, jg = _grads(j, p, pts, w, fast=False)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d, p.get_distance(pts).numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(cg, jcg, **TOL)


def test_trilinear_matches_jax():
    j = _jax_octree("trilinear")
    p = OctreeSdf.from_jax_state(j._state_arrays(), device="cpu")
    pts = np.random.default_rng(0).uniform(-0.3, 0.3, (512, 3)).astype(np.float32)
    w = np.random.default_rng(3).normal(size=512).astype(np.float32)
    d, cg, xg, jd, jcg, jg = _grads(j, p, pts, w, num_coeff=8, interpolation="trilinear")
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cg, jcg, **TOL)
    scale = np.abs(jg).max()
    np.testing.assert_allclose(xg / scale, w[:, None] * jg / scale, rtol=0, atol=1e-5)


def test_coefficients_are_a_copy(pair):
    """An in-place update of octree_coefficients(...) leaves the words,
    and the structure's answers, unchanged."""
    _, p = pair
    before = p._octree_dev.clone()
    pts = np.random.default_rng(0).uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    d0 = p.get_distance(pts)
    c = octree_coefficients(p._octree_dev)
    c += 1.0
    c.mul_(3.0)
    assert torch.equal(p._octree_dev, before)
    assert torch.equal(p.get_distance(pts), d0)
    host = octree_coefficients(p.octree_data)
    host.zero_()
    assert np.array_equal(p.octree_data, before.numpy().view(np.uint32))


def _camera_rays(n):
    u = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    gu, gv = np.meshgrid(0.6 * u, 0.6 * u)
    origins = np.stack([gu, gv, np.full_like(gu, -1.0)], -1).reshape(-1, 3)
    dirs = np.tile([[0.0, 0.0, 1.0]], (n * n, 1)).astype(np.float32)
    return origins.astype(np.float32), dirs


KW = dict(num_coeff=64, interpolation="tricubic", max_iters=96)


def test_render_depth_matches_jax(pair):
    j, p = pair
    o, d = _camera_rays(32)
    levels = p.max_depth - p.start_depth
    jd, jh = j_render(j.octree_data, j_coeffs(j.octree_data), jnp.asarray(o), jnp.asarray(d),
                      *_jargs(j), levels=levels, **KW)
    pd, ph = render_depth_diff(p._octree_dev, octree_coefficients(p._octree_dev), o, d,
                               *_args(p), levels=levels, **KW)
    jh = np.asarray(jh)
    np.testing.assert_array_equal(ph.numpy(), jh)
    assert 0 < jh.sum() < jh.size
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-5)


def _targets(p):
    o, d = _camera_rays(32)
    levels = p.max_depth - p.start_depth
    return o, d, levels, render_depth_diff(
        p._octree_dev, octree_coefficients(p._octree_dev), o, d, *_args(p), levels=levels,
        **KW)


def test_depth_fit_loss_matches_jax(pair):
    """The first loss and its coefficient gradient at test_diff.py's noisy
    coefficients (noise 1e-3, seed 1)."""
    j, p = pair
    o, d, levels, (td, th) = _targets(p)
    c0 = octree_coefficients(p._octree_dev)
    noise = np.random.default_rng(1).normal(0, 1e-3, c0.shape).astype(np.float32)
    c = (c0 + torch.as_tensor(noise)).requires_grad_(True)
    loss = depth_fit_loss(p._octree_dev, c, o, d, td, th, *_args(p), levels=levels, **KW)
    loss.backward()
    jc = j_coeffs(j.octree_data) + jnp.asarray(noise)
    jl, jg = jax.value_and_grad(lambda cc: j_loss(
        j.octree_data, cc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(td.numpy()),
        jnp.asarray(th.numpy()), *_jargs(j), levels=levels, **KW))(jc)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5, abs=1e-9)
    jg = np.asarray(jg)
    np.testing.assert_allclose(c.grad.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


def test_depth_fit_converges(pair):
    """test_diff.py's fit: 60 Adam steps (lr 2e-4, betas (0.9, 0.999), eps
    1e-9) from noisy coefficients bring the loss below 0.15x the first."""
    _, p = pair
    o, d, levels, (td, th) = _targets(p)
    c0 = octree_coefficients(p._octree_dev)
    noise = np.random.default_rng(1).normal(0, 1e-3, c0.shape).astype(np.float32)
    c = (c0 + torch.as_tensor(noise)).requires_grad_(True)
    opt = torch.optim.Adam([c], lr=2e-4, betas=(0.9, 0.999), eps=1e-9)

    def loss_fn():
        return depth_fit_loss(p._octree_dev, c, o, d, td, th, *_args(p), levels=levels, **KW)

    loss0 = float(loss_fn().detach())
    for _ in range(60):
        opt.zero_grad()
        loss_fn().backward()
        opt.step()
    loss_final = float(loss_fn().detach())
    assert loss_final < 0.15 * loss0, (loss0, loss_final)
