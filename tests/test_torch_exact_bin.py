"""The port's EXACT_OCTREE ``.bin`` codec (``io/sdflib_binary.py``) and its
copy of ``native/`` against the JAX package's and the compiled
reference's goldens.

* The port's container for a structure equals the JAX package's for the
  same structure byte for byte, and each package loads the other's
  (distances within 1e-6, the lists as sets).
* ``builders_exact.bin`` (the compiled reference's build) loads and
  answers within 2e-5 of the reference's ``getDistance``, with
  ``tests/test_reference_parity.py:226-243``'s gradient rule (under 0.1%
  of gradients off by more than 1e-3).
* ``exact_bin_roundtrip.npz``: the port's own build at that golden's
  configuration, written by the port and decoded by the port and by the
  copied ``native/`` library, within 2e-5 of the compiled reference's
  answers on the same tree shape's points.
* A loaded structure keeps ``sorted_lists`` false through ``.npz``.
* ``native/`` decodes the port's ``.bin`` within 1e-5 of the port's
  answers (skipped only where g++ is missing, as tests/test_native.py).
"""
import os

import numpy as np
import pytest
import torch

from sdflib_tpu.io.sdflib_binary import load_sdflib_bin as j_load_bin
from sdflib_tpu.io.sdflib_binary import save_sdflib_bin as j_save_bin
from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf as JExact
from sdflib_tpu.utils.primitives import make_icosphere as j_ico
from sdflib_tpu_torch import ExactOctreeSdf, SdfFunction
from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin, save_sdflib_bin
from sdflib_tpu_torch.native import NativeSdf, native_available
from sdflib_tpu_torch.utils.primitives import make_torus

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "golden", "data")
native_mark = pytest.mark.skipif(not native_available(), reason="g++ toolchain unavailable")


@pytest.fixture(scope="module")
def jax_sdf():
    mesh = j_ico(subdivisions=2, radius=0.35)
    box = mesh.bounding_box.add_margin(0.14)
    return JExact(mesh, box, max_depth=4, start_depth=1, min_triangles_per_node=32)


@pytest.fixture(scope="module")
def pts(jax_sdf):
    rng = np.random.default_rng(0)
    inside = rng.uniform(jax_sdf.box.min + 1e-4, jax_sdf.box.max - 1e-4, (4096, 3))
    return np.concatenate([inside, [[6.0, 0.0, 0.0]]]).astype(np.float32)


@pytest.fixture(scope="module")
def golden_tree():
    """The port's build at exact_bin_roundtrip.npz's configuration
    (tests/golden/make_goldens.py:271-290), saved by the port."""
    mesh = make_torus(R=0.3, r=0.12, nu=24, nv=12)
    box = mesh.bounding_box.add_margin(0.2 * float(np.max(mesh.bounding_box.size)))
    return ExactOctreeSdf(mesh, box, max_depth=5, start_depth=2, min_triangles_per_node=32,
                          device="cpu")


def _sets(sdf):
    flat = np.asarray(sdf.tri_flat.cpu() if isinstance(sdf.tri_flat, torch.Tensor)
                      else sdf.tri_flat)
    offs, cnts = np.asarray(sdf.leaf_offset), np.asarray(sdf.leaf_count)
    return sorted(tuple(sorted(flat[o : o + c])) for o, c in zip(offs, cnts))


def test_bin_is_byte_equal_to_jax(jax_sdf, tmp_path):
    port = ExactOctreeSdf.from_jax_state(jax_sdf._state_arrays(), device="cpu")
    save_sdflib_bin(port, str(tmp_path / "port.bin"))
    j_save_bin(jax_sdf, str(tmp_path / "jax.bin"))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_each_package_loads_the_others(jax_sdf, pts, tmp_path, direction):
    path = str(tmp_path / "x.bin")
    if direction == "port_reads_jax":
        j_save_bin(jax_sdf, path)
        loaded = load_sdflib_bin(path, device="cpu")
        ref = jax_sdf
        assert isinstance(loaded, ExactOctreeSdf) and not loaded._sorted_lists
        d = loaded.get_distance(pts).numpy()
        twin = j_load_bin(path)
        np.testing.assert_array_equal(loaded.octree_data, np.asarray(twin.octree_data))
        np.testing.assert_array_equal(loaded.leaf_count, np.asarray(twin.leaf_count))
        np.testing.assert_array_equal(loaded.tri_flat.numpy(), np.asarray(twin.tri_flat))
        np.testing.assert_allclose(loaded.leaf_centers, twin.leaf_centers, rtol=0, atol=1e-7)
        np.testing.assert_allclose(loaded.triangles.v_world.numpy(),
                                   np.asarray(twin.triangles.v_world), rtol=0, atol=0)
    else:
        port = ExactOctreeSdf(j_ico_mesh(), j_ico_mesh().bounding_box.add_margin(0.14),
                              max_depth=4, start_depth=1, min_triangles_per_node=32,
                              device="cpu")
        save_sdflib_bin(port, path)
        loaded = j_load_bin(path)
        ref = port
        assert not loaded._sorted_lists
        d = np.asarray(loaded.get_distance(pts))
    assert _sets(loaded) == _sets(ref)
    want = ref.get_distance(pts)
    np.testing.assert_allclose(d, np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(loaded.triangles.v_world),
                               np.asarray(ref.triangles.v_world), rtol=0, atol=1e-5)


def j_ico_mesh():
    from sdflib_tpu_torch.utils.primitives import make_icosphere

    return make_icosphere(subdivisions=2, radius=0.35)


def test_reference_built_golden():
    """builders_exact.bin through the port (test_reference_parity.py:226-243)."""
    g = np.load(os.path.join(DATA, "builders_torus.npz"))
    sdf = load_sdflib_bin(os.path.join(DATA, "builders_exact.bin"), device="cpu")
    assert not sdf._sorted_lists
    d = sdf.get_distance(g["points"]).numpy()
    np.testing.assert_allclose(d, g["exact_dist"], rtol=0, atol=2e-5)
    d2, grad = sdf.get_distance_and_gradient(g["points"])
    np.testing.assert_allclose(d2.numpy(), g["exact_dist"], rtol=0, atol=2e-5)
    err = np.linalg.norm(grad.numpy() - g["exact_grad"], axis=-1)
    assert (err > 1e-3).mean() < 1e-3


def test_roundtrip_golden(golden_tree, tmp_path):
    """exact_bin_roundtrip.npz: the port's build of that configuration,
    written by the port and read back by the port, answers as the
    compiled reference answered the JAX package's file."""
    rt = np.load(os.path.join(DATA, "exact_bin_roundtrip.npz"))
    path = str(tmp_path / "ours.bin")
    save_sdflib_bin(golden_tree, path)
    back = load_sdflib_bin(path, device="cpu")
    assert _sets(back) == _sets(golden_tree)
    np.testing.assert_allclose(back.get_distance(rt["points"]).numpy(), rt["dist"],
                               rtol=0, atol=2e-5)


def test_sorted_lists_stay_off_through_npz(golden_tree, tmp_path):
    save_sdflib_bin(golden_tree, str(tmp_path / "e.bin"))
    imported = load_sdflib_bin(str(tmp_path / "e.bin"), device="cpu")
    assert not imported._sorted_lists and golden_tree._sorted_lists
    imported.save(str(tmp_path / "e.npz"))
    reloaded = SdfFunction.load(str(tmp_path / "e.npz"), device="cpu")
    assert isinstance(reloaded, ExactOctreeSdf) and not reloaded._sorted_lists
    np.testing.assert_allclose(reloaded.leaf_centers, imported.leaf_centers)
    q = np.random.default_rng(2).uniform(-0.5, 0.5, (1024, 3)).astype(np.float32)
    np.testing.assert_array_equal(reloaded.get_distance(q).numpy(),
                                  imported.get_distance(q).numpy())


@native_mark
def test_native_decodes_the_ports_bin(golden_tree, tmp_path):
    """The copied native library reads the port's file: within 1e-5 of the
    port's answers, and within 2e-5 of exact_bin_roundtrip.npz."""
    rt = np.load(os.path.join(DATA, "exact_bin_roundtrip.npz"))
    path = str(tmp_path / "ours.bin")
    save_sdflib_bin(golden_tree, path)
    native = NativeSdf.load(path)
    assert native.format == "exact_octree"
    q = rt["points"][:4096]
    d = native.get_distance(q)
    np.testing.assert_allclose(d, golden_tree.get_distance(q).numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d, rt["dist"][:4096], rtol=0, atol=2e-5)
