"""The port's renderer against the JAX package's, on the icosphere of
tests/test_render.py (subdivisions 3, radius 0.35, box margin 0.14,
``max_depth=5``), the port querying the JAX-built structure through
``from_jax_state``.

* ``sphere_trace`` on an analytic sphere and on a miss: JAX's hits,
  depths within 1e-6 and positions on the sphere.
* ``trace_octree`` on 64^2 camera rays (eps 1e-4), on the walk and on
  the grid route (``build_query_grid``), each with beam 4 and without:
  hit masks agree on >= 99.8% of rays, depths of common hits within
  1e-3 with a median difference below 1e-6, normals' dot product above
  0.999 on >= 99% of common hits. Rays are compared on hits and depths,
  never on trajectories or iteration counts.
  On the grid route the JAX function steps to the exit of the leaf's box
  on the free flag of one finest cell, which a coarse leaf holding the
  surface elsewhere does not prove (ROADMAP.md, Queue 3): its hit then
  lies inside the surface. Depths are compared where JAX's hit lies
  within 1e-3 of its own surface, and on every route each port hit must
  lie within 3e-3 of the surface (``RealSdf``).
* A 192^2 orthographic frame (36,864 rays), against JAX's pyramid path
  and its dynamic path.
* The shading functions within 1e-5 of JAX's on JAX's trace outputs;
  ambient occlusion and soft shadows, each package over its own
  octree's ``get_distance``, within 1e-4.
* ``render_plane_cut`` within 2e-3 mean pixel difference of JAX's at
  96^2, overlays on and off.
* The port versions of test_reference_parity.py:287 and :307: the
  plane-cut pixels and the traced hit mask and depths against the
  compiled reference's walk (``sdflib_tpu.native``) on
  ``octree_torus_cpp.bin``, at those tests' thresholds.
* The cases of tests/test_render.py on the port.
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflib_tpu.render import shading as js
from sdflib_tpu.render.plane_cut import render_plane_cut as j_plane_cut
from sdflib_tpu.render.sphere_trace import sphere_trace as j_sphere_trace
from sdflib_tpu.render.sphere_trace import trace_octree as j_trace
from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere
from sdflib_tpu_torch import OctreeSdf, RealSdf
from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin
from sdflib_tpu_torch.render import (
    Camera,
    normal_color,
    render_plane_cut,
    shade_lambert,
    sphere_trace,
    to_u8,
    trace_octree,
    write_png,
)
from sdflib_tpu_torch.render import shading as ps
from sdflib_tpu_torch.utils.primitives import make_icosphere

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "golden", "data")
CFG = dict(max_depth=5, start_depth=2, termination_threshold=1e-3)
SURFACE_TOL = 3e-3


def _build_octrees():
    """{route: (JAX octree, port octree)} on one JAX-built structure."""
    mesh = j_icosphere(subdivisions=3, radius=0.35)
    j = JOctree(mesh, mesh.bounding_box.add_margin(0.14), **CFG)
    jg = copy.copy(j)
    jg.build_query_grid()
    pg = OctreeSdf.from_jax_state(j._state_arrays(), device="cpu")
    pg.build_query_grid()
    return {"walk": (j, OctreeSdf.from_jax_state(j._state_arrays(), device="cpu")),
            "grid": (jg, pg)}


def _real():
    return RealSdf(make_icosphere(subdivisions=3, radius=0.35), device="cpu")


def _cam_rays():
    return Camera(position=(0, 0, 1.5), target=(0, 0, 0), fov_y_deg=45).rays(64, 64)


octrees = pytest.fixture(scope="module", name="octrees")(_build_octrees)
real = pytest.fixture(scope="module", name="real")(_real)
cam_rays = pytest.fixture(scope="module", name="cam_rays")(_cam_rays)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hold(ref, res, ok=None):
    """Hit masks agree on >= 99.8%; on common hits (``ok`` of them where
    given) depths within 1e-3, their median difference below 1e-6, and
    normals agree on >= 99%."""
    hj, hp = _np(ref.hit), _np(res.hit)
    agree = (hj == hp).mean()
    assert agree >= 0.998, f"hit masks agree on {agree:.2%}"
    both = hj & hp if ok is None else hj & hp & ok
    assert both.sum() > 0.5 * hj.sum()
    dd = np.abs(_np(ref.depth)[both] - _np(res.depth)[both])
    assert dd.max() <= 1e-3 and np.median(dd) < 1e-6, (dd.max(), np.median(dd))
    dots = (_np(ref.normal)[both] * _np(res.normal)[both]).sum(-1)
    assert (dots > 0.999).mean() >= 0.99


def test_sphere_trace_analytic_and_miss():
    """The generic march on |p| - 0.5, in both packages."""
    origins = np.array([[0, 0, 2.0], [0, 2.0, 0], [2.0, 0, 0], [2.0, 2.0, 2.0]], np.float32)
    dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs[3] = (0.0, 0.0, 1.0)                     # the miss
    hit, pos, depth, it = sphere_trace(lambda p: p.norm(dim=-1) - 0.5, origins, dirs,
                                       eps=1e-5, far=8.0, device="cpu")
    hj, _, dj, itj = j_sphere_trace(lambda p: jnp.linalg.norm(p, axis=-1) - 0.5,
                                    origins, dirs, eps=1e-5, far=8.0)
    np.testing.assert_array_equal(hit.numpy(), [True, True, True, False])
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hj))
    np.testing.assert_allclose(depth.numpy()[:3], 1.5, atol=1e-3)
    np.testing.assert_allclose(pos.norm(dim=-1).numpy()[:3], 0.5, atol=1e-3)
    np.testing.assert_allclose(depth.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    assert int(it) == int(itj)


def test_sphere_trace_placement():
    """Numpy rays march on the card unless the caller passes the CPU:
    without a card the default raises; ``device="cpu"`` gives the answers
    of CPU tensors bit for bit."""
    origins = np.array([[0, 0, 2.0], [0, 2.0, 0], [2.0, 2.0, 2.0]], np.float32)
    dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs[2] = (0.0, 0.0, 1.0)

    def fn(p):
        return p.norm(dim=-1) - 0.5

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sphere_trace(fn, origins, dirs, eps=1e-5, far=8.0)
    a = sphere_trace(fn, origins, dirs, eps=1e-5, far=8.0, device="cpu")
    b = sphere_trace(fn, torch.from_numpy(origins), dirs, eps=1e-5, far=8.0)
    for x, y in zip(a, b):
        assert x.device.type == "cpu" and torch.equal(x, y)


@pytest.mark.parametrize("beam", [4, None])
@pytest.mark.parametrize("route", ["walk", "grid"])
def test_trace_octree_matches_jax(octrees, real, cam_rays, route, beam):
    j, p = octrees[route]
    o, d = cam_rays
    kw = dict(eps=1e-4, far=4.0, max_iters=256, beam=beam)
    stats = {}
    res = trace_octree(p, o, d, stats_out=stats, **kw)
    ref = j_trace(j, o, d, **kw)
    assert res.hit.shape == (64, 64) and res.position.shape == (64, 64, 3)
    assert res.iterations.dtype == torch.int32
    rounds = stats["rounds"]
    assert rounds[0][:2] == (8, 64 * 64) and rounds[-1][2] == 0
    assert all(a[2] == b[1] for a, b in zip(rounds, rounds[1:]))
    hp = _np(res.hit)
    on_surface = np.abs(real.get_distance(res.position).numpy())
    assert on_surface[hp].max() <= SURFACE_TOL
    if route == "walk":
        _hold(ref, res)
        return
    # JAX's grid-route hits off its own surface are its leaf-exit
    # overshoots; the port's hits there lie on the surface (checked above)
    sound = np.abs(_np(j.get_distance(np.asarray(ref.position)))) <= 1e-3
    _hold(ref, res, ok=sound)


@pytest.mark.parametrize("path", ["pyramid", "dynamic"])
def test_frame_matches_jax_schedules(octrees, path):
    """A frame of 192^2 >= 2^15 rays against each JAX scheduler."""
    j, p = octrees["walk"]
    R = 192
    u = (np.arange(R, dtype=np.float32) + 0.5) / R - 0.5
    gu, gv = np.meshgrid(u, u)
    o = np.stack([gu, gv, np.full_like(gu, -1.2)], -1).astype(np.float32)
    d = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), o.shape).copy()
    ref = j_trace(j, o, d, max_iters=1024, pyramid=path == "pyramid")
    _hold(ref, trace_octree(p, o, d, max_iters=1024))


@pytest.fixture(scope="module")
def shaded_inputs(octrees):
    """A JAX trace from an oblique camera (tests/test_render.py:81)."""
    j, _ = octrees["walk"]
    o, d = Camera(position=(0.9, 0.7, 1.2), target=(0, 0, 0), fov_y_deg=45).rays(64, 64)
    res = j_trace(j, o, d, eps=1e-4, far=4.0, max_iters=256)
    return {k: np.asarray(v) for k, v in res._asdict().items()}, d


@pytest.mark.parametrize("fn", ["normal_color", "shade_lambert", "shade_lambert_plain",
                                "shade_pbr", "iteration_heatmap"])
def test_shading_matches_jax(shaded_inputs, fn):
    r, d = shaded_inputs
    ao = np.linspace(0.2, 1.0, 64 * 64, dtype=np.float32).reshape(64, 64)
    shadow = ao[::-1].copy()
    def kw(m):
        """The port runs numpy inputs on the CPU only when asked."""
        return {"device": "cpu"} if m is ps else {}

    args = {
        "normal_color": lambda m: m.normal_color(r["normal"], r["hit"], **kw(m)),
        "shade_lambert": lambda m: m.shade_lambert(r["position"], r["normal"], r["hit"],
                                                   view_dir=d, ao=ao, shadow=shadow, **kw(m)),
        # without a view direction there is no specular term; the JAX
        # function raises there (ROADMAP.md, Queue 3), so its value is
        # JAX's with specular=0
        "shade_lambert_plain": lambda m: (
            m.shade_lambert(r["position"], r["normal"], r["hit"], **kw(m))
            if m is ps else m.shade_lambert(r["position"], r["normal"], r["hit"],
                                            view_dir=d, specular=0.0)),
        "shade_pbr": lambda m: m.shade_pbr(r["position"], r["normal"], r["hit"], d, ao=ao,
                                           shadow=shadow, metallic=0.3, **kw(m)),
        "iteration_heatmap": lambda m: m.iteration_heatmap(r["iterations"], 256, **kw(m)),
    }[fn]
    out = args(ps)
    assert isinstance(out, torch.Tensor) and out.shape == (64, 64, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(args(js)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fn", ["normal_color", "shade_lambert", "shade_pbr",
                                "ambient_occlusion", "soft_shadow", "iteration_heatmap"])
def test_shading_placement(shaded_inputs, fn):
    """Numpy inputs shade on the card unless the caller passes the CPU:
    without a card the default raises; ``device="cpu"`` gives the answers
    of CPU tensors bit for bit."""
    r, d = shaded_inputs
    ao = np.linspace(0.2, 1.0, 64 * 64, dtype=np.float32).reshape(64, 64)

    def sphere(p):
        return p.norm(dim=-1) - 0.5

    call = {
        "normal_color": lambda f, **k: ps.normal_color(f(r["normal"]), f(r["hit"]), **k),
        "shade_lambert": lambda f, **k: ps.shade_lambert(
            f(r["position"]), f(r["normal"]), f(r["hit"]), view_dir=f(d), ao=f(ao), **k),
        "shade_pbr": lambda f, **k: ps.shade_pbr(
            f(r["position"]), f(r["normal"]), f(r["hit"]), f(d), ao=f(ao), **k),
        "ambient_occlusion": lambda f, **k: ps.ambient_occlusion(
            sphere, f(r["position"]), f(r["normal"]), **k),
        "soft_shadow": lambda f, **k: ps.soft_shadow(
            sphere, f(r["position"]), (0.577, 0.577, 0.577), **k),
        "iteration_heatmap": lambda f, **k: ps.iteration_heatmap(f(r["iterations"]), 256, **k),
    }[fn]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(np.asarray)
    a = call(np.asarray, device="cpu")
    b = call(torch.tensor)
    assert a.device.type == "cpu" and torch.equal(a, b)


@pytest.mark.parametrize("fn", ["ambient_occlusion", "soft_shadow"])
def test_ao_and_shadow_match_jax(octrees, shaded_inputs, fn):
    """Each package re-marches its own octree's distance."""
    j, p = octrees["walk"]
    r, _ = shaded_inputs
    pos, n = r["position"], r["normal"]
    if fn == "ambient_occlusion":
        out = ps.ambient_occlusion(p.get_distance, pos, n, device="cpu")
        ref = js.ambient_occlusion(j.get_distance, jnp.asarray(pos), jnp.asarray(n))
    else:
        light = (0.577, 0.577, 0.577)
        out = ps.soft_shadow(p.get_distance, pos, light, device="cpu")
        ref = js.soft_shadow(j.get_distance, jnp.asarray(pos), light)
    assert out.shape == (64, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    assert 0.0 < float(out.mean()) < 1.0


@pytest.mark.parametrize("overlays", [True, False])
def test_plane_cut_matches_jax(octrees, overlays):
    j, p = octrees["walk"]
    kw = dict(resolution=96, axis=1, offset=0.45)
    if not overlays:
        kw.update(print_grid=False, print_isolines=False, surface_thickness=0.0)
    img = render_plane_cut(p, **kw)
    ref = j_plane_cut(j, **kw)
    assert img.shape == (96, 96, 3) and img.dtype == np.float32
    assert np.abs(img - ref).mean() < 2e-3


# -- the port versions of test_reference_parity.py:287 and :307 ------------


class _NativeEvalProxy:
    """Duck-typed SDF whose get_distance runs through the native C++ shim
    while every structural attribute comes from the port's twin."""

    def __init__(self, sdf, native_sdf):
        self._sdf = sdf
        self._native = native_sdf

    def __getattr__(self, name):
        return getattr(self._sdf, name)

    def get_distance(self, points):
        p = np.asarray(points, np.float32)
        return self._native.get_distance(p.reshape(-1, 3)).reshape(p.shape[:-1])


@pytest.fixture(scope="module")
def cpp_twins():
    from sdflib_tpu.native import NativeSdf, native_available

    if not native_available():
        pytest.skip("g++ toolchain unavailable")
    path = os.path.join(DATA, "octree_torus_cpp.bin")
    return load_sdflib_bin(path, device="cpu"), NativeSdf.load(path)


def test_plane_cut_pixels_match_native(cpp_twins):
    sdf, native = cpp_twins
    img = render_plane_cut(sdf, resolution=128)
    img_nat = render_plane_cut(_NativeEvalProxy(sdf, native), resolution=128)
    diff = np.abs(img - img_nat)
    assert diff.mean() < 2e-3, f"mean pixel diff {diff.mean()}"
    assert (diff.max(axis=-1) > 0.05).mean() < 1e-3


def test_sphere_trace_pixels_match_native(cpp_twins):
    """trace_octree (beam off, no grid: plain max(d, 0) steps) against a
    host march through the compiled reference's walk."""
    sdf, native = cpp_twins
    R = 64
    u = (np.arange(R, dtype=np.float32) + 0.5) / R - 0.5
    gu, gv = np.meshgrid(u, u)
    origins = np.stack([gu * 0.9, gv * 0.9, np.full_like(gu, -1.1)], -1).astype(np.float32)
    dirs = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), origins.shape).copy()
    eps, far, max_iters = 1e-4, 3.0, 192
    res = trace_octree(sdf, origins, dirs, eps=eps, far=far, max_iters=max_iters, beam=None)

    box_size = float(sdf.box.size[0])
    pos = origins.reshape(-1, 3).copy()
    d_flat = dirs.reshape(-1, 3)
    acc = np.zeros(pos.shape[0], np.float32)
    last = np.full(pos.shape[0], np.inf, np.float32)
    active = np.ones(pos.shape[0], bool)
    for _ in range(max_iters):
        if not active.any():
            break
        d = native.get_distance(pos[active]).astype(np.float32)
        step = np.maximum(d, 0.0)
        pos[active] += d_flat[active] * step[:, None]
        acc[active] += step
        last[active] = d
        active[active.copy()] = (d > eps * box_size) & (acc[active] < far * box_size)
    hit_nat = (last <= eps * box_size).reshape(R, R)

    hit = res.hit.numpy()
    agree = (hit == hit_nat).mean()
    assert agree > 0.998, f"hit masks agree on {agree:.2%}"
    both = hit & hit_nat
    np.testing.assert_allclose(res.depth.numpy()[both], acc.reshape(R, R)[both], atol=1e-3)


# -- the cases of tests/test_render.py on the port -------------------------


def test_trace_octree_sphere(octrees):
    _, p = octrees["walk"]
    o, d = Camera(position=(0, 0, 1.5), target=(0, 0, 0), fov_y_deg=45).rays(64, 64)
    res = trace_octree(p, o, d, eps=1e-4, far=4.0, max_iters=256)
    hit = res.hit.numpy()
    assert hit[32, 32] and not hit[0, 0] and not hit[-1, -1]
    pos = res.position.numpy()[hit]
    np.testing.assert_allclose(np.linalg.norm(pos, axis=-1), 0.35, atol=5e-3)
    n = res.normal.numpy()[hit]
    outward = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    assert np.mean(np.sum(n * outward, axis=-1) > 0.95) > 0.95


def test_shading_and_png(tmp_path, octrees):
    _, p = octrees["grid"]
    o, d = Camera(position=(0.9, 0.7, 1.2), target=(0, 0, 0), fov_y_deg=45).rays(64, 64)
    res = trace_octree(p, o, d, eps=1e-4, far=4.0, max_iters=256)
    img_n = normal_color(res.normal, res.hit).numpy()
    img_l = shade_lambert(res.position, res.normal, res.hit, view_dir=d).numpy()
    for img in (img_n, img_l):
        assert img.shape == (64, 64, 3) and np.isfinite(img).all()
        assert img.min() >= 0.0 and img.max() <= 1.0
    assert np.abs(img_l[32, 32] - img_l[0, 0]).max() > 0.05
    path = str(tmp_path / "render.png")
    write_png(path, img_l)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 200
    assert to_u8(np.array([0.0, 0.5, 1.0])).tolist() == [0, 128, 255]


def test_plane_cut_image(octrees):
    _, p = octrees["walk"]
    img = render_plane_cut(p, resolution=96, axis=2, offset=0.5)
    assert img.shape == (96, 96, 3) and np.isfinite(img).all()
    assert img[48, 48][2] > img[48, 48][0]
    assert img[0, 0][0] > img[0, 0][2]
    assert np.all(img < 0.15, axis=-1).any()
    img_plain = render_plane_cut(p, resolution=96, axis=2, offset=0.5, print_grid=False,
                                 print_isolines=False, surface_thickness=0.0)
    assert np.all(img_plain > 0.75, axis=-1).any()


def test_flat_batch_beam_masks_padding(octrees):
    """A flat batch whose length beam^2 does not divide: the padded last
    tile's beam is the real rays' own (no padding ray in its mean or
    radius), the trace equals the one without a beam on hits and depths,
    and the caller's ray tensors are left as they were."""
    from sdflib_tpu_torch.render.sphere_trace import _beam_setup, _beam_tiles

    _, p = octrees["grid"]
    o, d = Camera(position=(0.9, 0.7, 1.2), target=(0, 0, 0), fov_y_deg=45).rays(40, 40)
    o, d = o.reshape(-1, 3)[:1003], d.reshape(-1, 3)[:1003]     # 62 tiles of 16 + 11
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    o_t, d_t, mask, per_ray = _beam_tiles(ot, dt, ot.shape, 4)
    assert o_t.shape == (63, 16, 3) and int(mask.sum()) == 1003
    o_c, d_c, r0, rd = _beam_setup(o_t, d_t, mask)
    tail = _beam_setup(ot[992:, None].transpose(0, 1), dt[992:, None].transpose(0, 1), None)
    for got, want in zip((o_c[-1], d_c[-1], r0[-1], rd[-1]), tail):
        torch.testing.assert_close(got, want[0], rtol=0, atol=1e-6)
    assert per_ray(torch.arange(63.0)).tolist() == [i // 16 for i in range(1003)]
    with_beam = trace_octree(p, ot, dt, eps=1e-4, far=4.0, max_iters=256)
    # the caller's tensors are read, never written
    assert torch.equal(ot, torch.as_tensor(o)) and torch.equal(dt, torch.as_tensor(d))
    _hold(trace_octree(p, o, d, eps=1e-4, far=4.0, max_iters=256, beam=None), with_beam)


def _report():
    """Print the CPU numbers PERF.md and ROADMAP.md cite: the dispatcher
    calls of one march trip on the fused-row route, and the JAX grid
    route's hits off its own surface on this file's camera frame (run
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_render.py``
    from the repository root)."""
    from functools import partial

    from torch.utils._python_dispatch import TorchDispatchMode

    from sdflib_tpu_torch.ops.march import _grid_distance_and_step, march_trips
    from sdflib_tpu_torch.render.sphere_trace import _march

    class Count(TorchDispatchMode):
        views = {"unsqueeze", "select", "slice", "view", "detach", "expand", "permute"}

        def __init__(self):
            super().__init__()
            self.calls = self.non_views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls += 1
            self.non_views += func.__name__.split(".")[0] not in self.views
            return func(*args, **(kwargs or {}))

    trees = _build_octrees()
    rays = _cam_rays()
    jg, pg = trees["grid"]
    o, d = (torch.as_tensor(a.reshape(-1, 3)) for a in rays)
    state = (o, torch.zeros(len(o)), torch.full((len(o),), torch.inf), torch.ones(len(o)))

    def step(p, u):
        return _grid_distance_and_step(
            pg._octree_dev, pg._fat_grid, p, u, pg._box_min, pg._box_size3,
            pg.min_border_value, grid_depth=pg.max_depth, num_coeff=64,
            interpolation="tricubic", grid_fat=True)

    with Count() as count:
        _march(partial(march_trips, step), state, d, 1e-4, 4.0, 1)
    print(f"one march trip, fused rows: {count.calls} dispatcher calls, "
          f"{count.non_views} of them not views")

    kw = dict(eps=1e-4, far=4.0, max_iters=256)
    real_sdf = _real()
    for beam in (4, None):
        ref = j_trace(jg, *rays, beam=beam, **kw)
        res = trace_octree(pg, *rays, beam=beam, **kw)
        hj, hp = np.asarray(ref.hit), res.hit.numpy()
        own = np.abs(np.asarray(jg.get_distance(np.asarray(ref.position))))[hj]
        rj = np.abs(real_sdf.get_distance(np.asarray(ref.position)).numpy())[hj]
        rp = np.abs(real_sdf.get_distance(res.position).numpy())[hp]
        print(f"grid route, beam {beam}: JAX hits {hj.sum()}, {int((own > 1e-3).sum())} more "
              f"than 1e-3 off its own surface; |RealSdf| at JAX's hits q90 "
              f"{np.quantile(rj, 0.9):.4f} max {rj.max():.4f}, at the port's max {rp.max():.4f}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    _report()
