"""The exact octree's bucket tiers and query knobs in the port against the
JAX package's, on the torus fixture of test_torch_exact_octree.py (nu=20,
nv=12, box margin 0.1, max_depth 4, start_depth 1, 16 triangles per node),
built by the JAX package and loaded into both.

* vertex9, frame19 and id-only (a byte budget below the frame table) give
  distances and gradients within 1e-6 of the JAX package's same tier and
  of the port's RealSdf (768 points, seed 1), under each scan.
* ``set_scan_chunk`` accepts 16, 32, 128 and 256 and rejects 48 (and 512)
  as the JAX package does, and leaves the answers unchanged bit for bit.
* Pinning kernel K1 ("pallas", "pallas_window") on a non-vertex tier
  raises, as the JAX package's check does; the window scan on the
  id-only tier raises in both.
* The public ``build_query_grid`` leaves the answers unchanged.
"""
import numpy as np
import pytest
import torch

from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf as JExact
from sdflib_tpu.utils.primitives import make_torus as j_torus
from sdflib_tpu_torch import ExactOctreeSdf, RealSdf
from sdflib_tpu_torch.utils.primitives import make_torus

torch.set_num_threads(1)
CFG = dict(max_depth=4, start_depth=1, min_triangles_per_node=16)
TIERS = ["vertex9", "frame19", "id_only"]


@pytest.fixture(scope="module")
def state():
    mesh = j_torus(R=0.3, r=0.12, nu=20, nv=12)
    return JExact(mesh, mesh.bounding_box.add_margin(0.1), **CFG)._state_arrays()


@pytest.fixture(scope="module")
def pts():
    return np.random.default_rng(1).uniform(-0.5, 0.5, (768, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def real(pts):
    mesh = make_torus(R=0.3, r=0.12, nu=20, nv=12)
    return tuple(t.numpy() for t in RealSdf(mesh, device="cpu").get_distance_and_gradient(pts))


def _tier_state(state, tier):
    st = dict(state)
    if tier == "id_only":
        st["bucket_byte_budget"] = np.int64(1024)
    return st


def _port(state, tier):
    fmt = "frame19" if tier == "frame19" else "auto"
    return ExactOctreeSdf.from_jax_state(_tier_state(state, tier), device="cpu",
                                         bucket_format=fmt)


def _jax(state, tier, monkeypatch):
    if tier == "frame19":
        monkeypatch.setattr(JExact, "bucket_format", "frame19", raising=False)
    j = JExact._from_state_arrays(_tier_state(state, tier))
    monkeypatch.undo()
    return j


@pytest.mark.parametrize("tier", TIERS)
def test_tier_matches_jax_and_oracle(state, pts, real, tier, monkeypatch):
    port = _port(state, tier)
    j = _jax(state, tier, monkeypatch)
    assert port.bucket_tier == tier
    want_fields = {"vertex9": 9, "frame19": 19}.get(tier)
    if want_fields is None:
        assert port.bucket_fields is None and j.bucket_fields is None
    else:
        assert port.bucket_fields.shape[1] == want_fields * 64
        assert j.bucket_fields.shape[1] == want_fields * 64
    in_box = np.all((pts >= port.box.min) & (pts < port.box.max), axis=1)
    jd, jg = (np.asarray(a) for a in j.get_distance_and_gradient(pts))
    impls = ["xla"] if tier == "id_only" else ["xla", "xla_window"]
    for impl in impls:
        port.set_scan_impl(impl)
        d = port.get_distance(pts).numpy()
        d2, g = (t.numpy() for t in port.get_distance_and_gradient(pts))
        assert port.last_scan_stats["tier"] == tier
        np.testing.assert_array_equal(d, d2)
        np.testing.assert_allclose(d, jd, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)
        np.testing.assert_allclose(d[in_box], real[0][in_box], rtol=0, atol=1e-6)


@pytest.mark.parametrize("tier", TIERS)
def test_own_build_takes_each_tier(pts, real, tier):
    mesh = make_torus(R=0.3, r=0.12, nu=20, nv=12)
    kw = dict(bucket_format="frame19") if tier == "frame19" else (
        dict(bucket_byte_budget=1024) if tier == "id_only" else {})
    sdf = ExactOctreeSdf(mesh, mesh.bounding_box.add_margin(0.1), **CFG, **kw, device="cpu")
    assert sdf.bucket_tier == tier
    in_box = np.all((pts >= sdf.box.min) & (pts < sdf.box.max), axis=1)
    d = sdf.get_distance(pts).numpy()
    np.testing.assert_allclose(d[in_box], real[0][in_box], rtol=0, atol=1e-6)


@pytest.mark.parametrize("tier", TIERS)
def test_scan_chunk_accepts_and_rejects_as_jax(state, pts, tier, monkeypatch):
    port = _port(state, tier)
    base = port.get_distance(pts).numpy()
    for chunk in (16, 32, 48, 128, 256, 512, 64):
        j = _jax(state, tier, monkeypatch)
        try:
            j.set_scan_chunk(chunk)
            j_err = None
        except ValueError as e:
            j_err = str(e)
        if j_err is None:
            port.set_scan_chunk(chunk)
            assert port.scan_chunk == chunk
            assert port.bucket_ids.shape[1] == chunk
            np.testing.assert_array_equal(port.get_distance(pts).numpy(), base)
        else:
            with pytest.raises(ValueError) as e:
                port.set_scan_chunk(chunk)
            assert str(e.value) == j_err
    assert port.scan_chunk == 64


@pytest.mark.parametrize("tier", ["frame19", "id_only"])
def test_pinning_k1_raises_on_other_tiers(state, tier, monkeypatch):
    port = _port(state, tier)
    j = _jax(state, tier, monkeypatch)
    bad = ["pallas", "pallas_window"] + (["xla_window"] if tier == "id_only" else [])
    for impl in bad:
        with pytest.raises(ValueError):
            j.set_scan_impl(impl)
        with pytest.raises(ValueError):
            port.set_scan_impl(impl)
    port.set_scan_impl("xla")   # the plain grouped scan over the tier's tables
    vertex = _port(state, "vertex9")
    vertex.set_scan_impl("pallas")
    with pytest.raises(ValueError, match="64-slot"):
        vertex.set_scan_chunk(16)


def test_public_build_query_grid(state, pts):
    sdf = _port(state, "vertex9")
    grid = sdf.get_distance(pts).numpy()
    sdf._leaf_grid = None          # the node walk
    walk = sdf.get_distance(pts).numpy()
    sdf.build_query_grid()
    assert sdf._leaf_grid is not None
    np.testing.assert_array_equal(sdf.get_distance(pts).numpy(), grid)
    np.testing.assert_allclose(walk, grid, rtol=0, atol=1e-6)
