"""The port's cull strategies against the JAX package's, parametrised as
``tests/test_exact_octree.py:117-145`` (the same tori and sizes: lattice
and region on nu=24, nv=12 at max_depth 4; basic, precise and per_vertex
on nu=16, nv=8 at max_depth 3; start_depth 1, 16 triangles per node, box
margin 0.14).

* Exact: the port's build of each strategy against the port's RealSdf on
  2048 points (seed 5) within rtol 1e-5 / atol 1e-6, and its leaf count
  and mean list length beside the JAX build's: equal leaf counts and mean
  lists within 1% for lattice, region, basic and per_vertex (the culls
  decide at thresholds, where XLA's fused multiply-adds on the CPU can
  move a last ulp). For precise the JAX cull keeps every candidate of a
  node whose list has padding (its one-hot einsum turns the regions' radii
  into NaN, ROADMAP.md Queue 3), so its nodes stop on the futility rule
  one level below the start; the port's mean list is held to be no longer
  than JAX's and its queries to the same gate.
* Approximate: ``OctreeSdf(strategy=s)`` for each of the four exact
  strategies on ``tests/test_diff.py``'s icosphere at max_depth 3: the
  same words as the port's "distance" build (every cull keeps a superset,
  so the values do not depend on it) and the JAX build's word count.
"""
import numpy as np
import pytest
import torch

from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf as JExact
from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
from sdflib_tpu.utils.primitives import make_icosphere as j_ico
from sdflib_tpu.utils.primitives import make_torus as j_torus
from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf
from sdflib_tpu_torch.utils.primitives import make_icosphere, make_torus

torch.set_num_threads(1)
STRATEGIES = ["lattice", "region", "basic", "precise", "per_vertex"]


def _config(strategy):
    small = strategy not in ("lattice", "region")
    mesh = dict(R=0.3, r=0.12, nu=16 if small else 24, nv=8 if small else 12)
    cfg = dict(max_depth=3 if small else 4, start_depth=1, min_triangles_per_node=16,
               strategy=strategy)
    return mesh, cfg


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_exact_strategy(strategy):
    mesh_kw, cfg = _config(strategy)
    mesh = make_torus(**mesh_kw)
    box = mesh.bounding_box.add_margin(0.14)
    port = ExactOctreeSdf(mesh, box, **cfg, device="cpu")
    assert port.strategy == strategy
    rng = np.random.default_rng(5)
    pts = rng.uniform(port.box.min + 1e-4, port.box.max - 1e-4, (2048, 3)).astype(np.float32)
    np.testing.assert_allclose(port.get_distance(pts).numpy(),
                               RealSdf(mesh, device="cpu").get_distance(pts).numpy(),
                               rtol=1e-5, atol=1e-6)

    jm = j_torus(**mesh_kw)
    jax_sdf = JExact(jm, jm.bounding_box.add_margin(0.14), **cfg)
    j_counts = np.asarray(jax_sdf.leaf_count)
    print(f"{strategy}: leaves port {port.num_leaves} JAX {j_counts.shape[0]}, mean list "
          f"port {port.leaf_count.mean():.3f} JAX {j_counts.mean():.3f}")
    if strategy == "precise":
        assert port.leaf_count.mean() <= j_counts.mean()
        # JAX's lists stopped shrinking below the start level (futility)
        assert max(jax_sdf.build_stats["nodes_per_depth"]) == cfg["start_depth"] + 1
    else:
        assert port.num_leaves == j_counts.shape[0]
        assert abs(port.leaf_count.mean() - j_counts.mean()) <= 0.01 * j_counts.mean()


def test_unknown_strategy_raises():
    mesh = make_torus(R=0.3, r=0.12, nu=8, nv=4)
    with pytest.raises(ValueError, match="strategy"):
        ExactOctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), strategy="nearest",
                       device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), strategy="region", device="cpu")


@pytest.fixture(scope="module")
def approx_distance():
    mesh = make_icosphere(subdivisions=2, radius=0.35)
    return OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), max_depth=3, start_depth=1,
                     termination_threshold=1e-3, device="cpu")


@pytest.mark.parametrize("strategy", ["lattice", "basic", "precise", "per_vertex"])
def test_approximate_strategy(strategy, approx_distance):
    mesh = make_icosphere(subdivisions=2, radius=0.35)
    cfg = dict(max_depth=3, start_depth=1, termination_threshold=1e-3, strategy=strategy)
    port = OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), **cfg, device="cpu")
    np.testing.assert_array_equal(port.octree_data, approx_distance.octree_data)
    jm = j_ico(subdivisions=2, radius=0.35)
    jax_sdf = JOctree(jm, jm.bounding_box.add_margin(0.14), **cfg)
    assert port.octree_data.shape == np.asarray(jax_sdf.octree_data).shape
    assert port.build_stats["leaves_per_depth"] == {
        int(k): int(v) for k, v in jax_sdf.build_stats["leaves_per_depth"].items()}
