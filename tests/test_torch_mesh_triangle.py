"""The port's numpy host layer (mesh, primitives, triangle precompute,
the renderer's camera and PNG writer, the native shim's sources) against
the JAX package's: the same meshes, per-triangle data, rays, PNG bytes
and sources, bit for bit (tolerance: exact equality)."""
import os
import sys

import numpy as np
import pytest
import torch

import sdflib_tpu.mesh as jmesh
from sdflib_tpu.render.camera import Camera as JCamera
from sdflib_tpu.render.image import to_u8 as j_to_u8, write_png as j_write_png
from sdflib_tpu.triangle import calculate_mesh_triangle_data as j_calc
from sdflib_tpu.utils import primitives as jprim
from sdflib_tpu.utils.primitives import make_icosphere as j_ico, make_torus as j_torus
import sdflib_tpu_torch.mesh as tmesh
from sdflib_tpu_torch.render.camera import Camera as TCamera
from sdflib_tpu_torch.render.image import to_u8 as t_to_u8, write_png as t_write_png
from sdflib_tpu_torch.triangle import (
    calculate_mesh_triangle_data as t_calc,
    soa_to_torch,
)
from sdflib_tpu_torch.utils import primitives as tprim
from sdflib_tpu_torch.utils.primitives import make_icosphere as t_ico, make_torus as t_torus

torch.set_num_threads(1)


def _fin_mesh():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    from make_goldens import non_manifold_fin_mesh

    return non_manifold_fin_mesh()


@pytest.mark.parametrize(
    "args", [dict(), dict(R=0.3, r=0.12, nu=96, nv=48), dict(R=0.3, r=0.1, nu=7, nv=5)]
)
def test_make_torus_equal(args):
    a, b = j_torus(**args), t_torus(**args)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("sub", [0, 2, 3])
def test_make_icosphere_equal(sub):
    a, b = j_ico(subdivisions=sub, radius=0.42), t_ico(subdivisions=sub, radius=0.42)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("name, kw", [
    ("make_cube", dict()), ("make_cube", dict(size=0.7, center=(0.1, -0.2, 0.05))),
    ("make_plane", dict()), ("make_plane", dict(size=1.3, center=(0.0, 0.1, -0.3), res=4)),
])
def test_make_cube_and_plane_equal(name, kw):
    a, b = getattr(jprim, name)(**kw), getattr(tprim, name)(**kw)
    assert name in tprim.__all__
    assert a.vertices.dtype == b.vertices.dtype and a.indices.dtype == b.indices.dtype
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("name", ["torus", "icosphere", "nonmanifold"])
def test_triangle_data_equal(name):
    mesh = {
        "torus": lambda: j_torus(R=0.3, r=0.12, nu=48, nv=24),
        "icosphere": lambda: j_ico(subdivisions=3, radius=0.42),
        "nonmanifold": _fin_mesh,
    }[name]()
    a = j_calc(mesh)
    b = t_calc(tmesh.Mesh(mesh.vertices, mesh.indices))
    for fa, fb, n in zip(a, b, a._fields):
        np.testing.assert_array_equal(fa, fb, err_msg=n)
    # soa_to_torch keeps every value
    bt = soa_to_torch(b, "cpu")
    for fb, ft in zip(b, bt):
        assert ft.dtype == torch.float32
        np.testing.assert_array_equal(fb, ft.numpy())


def test_load_mesh_and_box_equal(tmp_path):
    """The copied parsers read the same files into the same meshes."""
    mesh = j_torus(R=0.3, r=0.1, nu=7, nv=5)
    obj = tmp_path / "m.obj"
    with open(obj, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {float(v[0])!r} {float(v[1])!r} {float(v[2])!r}\n")
        for t in mesh.indices:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    a, b = jmesh.load_mesh(str(obj)), tmesh.load_mesh(str(obj))
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.indices, b.indices)
    ba = a.bounding_box.add_margin(0.1).cubified()
    bb = b.bounding_box.add_margin(0.1).cubified()
    np.testing.assert_array_equal(ba.min, bb.min)
    np.testing.assert_array_equal(ba.max, bb.max)


@pytest.mark.parametrize("cam", [
    dict(),
    dict(position=(0.9, 0.7, 1.2), target=(0.0, 0.0, 0.0), fov_y_deg=45.0),
    dict(position=(-0.3, 2.0, 0.4), target=(0.1, -0.2, 0.05), up=(0.0, 0.0, 1.0),
         fov_y_deg=30.0, near=0.05),
])
def test_camera_rays_equal(cam):
    """The copied camera gives the same rays, square and wide frames."""
    for w, h in ((64, 64), (96, 40)):
        for a, b in zip(JCamera(**cam).rays(w, h), TCamera(**cam).rays(w, h)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_png_writer_equal(tmp_path):
    """The copied PNG writer writes the same bytes for every channel
    count and input type."""
    rng = np.random.default_rng(0)
    images = [rng.uniform(-0.1, 1.1, (17, 23)).astype(np.float32),
              rng.uniform(0, 1, (8, 5, 1)), rng.uniform(0, 1, (16, 16, 3)).astype(np.float32),
              rng.integers(0, 256, (9, 7, 4)).astype(np.uint8)]
    for i, img in enumerate(images):
        np.testing.assert_array_equal(j_to_u8(img), t_to_u8(img))
        j_write_png(str(tmp_path / f"j{i}.png"), img)
        t_write_png(str(tmp_path / f"t{i}.png"), img)
        assert (tmp_path / f"j{i}.png").read_bytes() == (tmp_path / f"t{i}.png").read_bytes()


@pytest.mark.parametrize("name", ["sdflib_c.cpp", "wrapper"])
def test_native_copy_equal(name):
    """The port's native/ is a copy: the C++ source byte for byte, and the
    wrapper's code below its docstring line for line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(root, pkg, "native", "sdflib_c.cpp" if name != "wrapper"
                          else "__init__.py") for pkg in ("sdflib_tpu", "sdflib_tpu_torch")]
    a, b = (open(p, "rb").read() for p in paths)
    if name == "wrapper":
        a, b = (x[x.index(b"from __future__"):] for x in (a, b))
    assert a == b
