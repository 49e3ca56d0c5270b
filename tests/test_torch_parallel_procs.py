"""``parallel`` across two processes on the CPU: two gloo ranks started
with ``torch.multiprocessing`` (spawn) and a ``file://`` rendezvous in the
test's directory, each with the local entries ``[cpu, cpu:0]``, so the
``ProcessMesh`` has four entries.

* Every sharded call (the approximate, exact and brute-force distances,
  the gradients, the trace, two fit steps) and both tiled structures'
  distances and gradients return on both ranks the answer of the
  one-process call on ``[cpu, cpu:0] * 2``, bit for bit, and agree with
  the JAX package's on its eight CPU devices within
  tests/test_torch_parallel.py's tolerances (the tiled exact octree,
  on the exact octree's configuration with points up to 0.1 beyond the
  box: within tests/test_torch_parallel_tiles.py's of JAX's sharded
  query).
* A list of rank 0's entries alone runs on a subgroup: rank 0 returns
  the one-process answer, rank 1 None.
* Saving a tiled structure whose shards lie in two processes raises.
* A rank that raises fails the spawn in the parent, not a hang.
* The list's bookkeeping (entries, slices, this rank's runs and blocks)
  without a group.

The ranks never import JAX: this module imports torch, numpy and the
port at its top, and JAX only inside the test bodies. Each spawn has a
join deadline and the group a timeout.
"""
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf, parallel
from sdflib_tpu_torch.diff.query import octree_coefficients
from sdflib_tpu_torch.parallel.tiles import TiledExactOctreeSdf, TiledOctreeSdf
from sdflib_tpu_torch.utils.primitives import make_icosphere

LOCAL = [torch.device("cpu"), torch.device("cpu", 0)]
ONE_PROCESS = LOCAL * 2
EXACT_KW = dict(max_depth=4, start_depth=1, min_triangles_per_node=32)
TOL = dict(rtol=1e-6, atol=1e-7)
DEADLINE = 120.0


def _inputs():
    """The calls' inputs, made alike in the parent and in every rank."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.35, 0.35, (1003, 3)).astype(np.float32)      # not % 4
    n = 211
    origins = np.tile([[0.0, 0.0, -1.2]], (n, 1)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 2.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    fit_pts = pts[:1000]
    targets = (np.linalg.norm(fit_pts, axis=-1) - 0.35).astype(np.float32)
    sphere = make_icosphere(subdivisions=2, radius=0.35)
    box = sphere.bounding_box.add_margin(0.14)
    lo, hi = np.asarray(box.min) - 0.1, np.asarray(box.max) + 0.1
    tile_pts = np.random.default_rng(19).uniform(lo, hi, (2048, 3)).astype(np.float32)
    return dict(pts=pts, origins=origins, dirs=dirs, fit_pts=fit_pts, targets=targets,
                sphere=sphere, box=box, tile_pts=tile_pts)


def _structures(data_dir):
    """The JAX-built octree and exact octree (saved by the parent) and the
    port's RealSdf, on the CPU."""
    def load(name):
        with np.load(os.path.join(data_dir, name)) as z:
            return {k: z[k] for k in z.files}

    oct_ = OctreeSdf.from_jax_state(load("octree.npz"), device="cpu")
    oct_.build_query_grid()
    ex = ExactOctreeSdf.from_jax_state(load("exact.npz"), device="cpu")
    real = RealSdf(make_icosphere(subdivisions=2, radius=0.35), device="cpu")
    return oct_, ex, real


def _calls(mesh, oct_, ex, real, x):
    """Every call of the file on ``mesh``, by name (numpy; None where the
    call returned None)."""
    def np_(v):
        return None if v is None else v.detach().cpu().numpy()

    out = {}
    for name, sdf in (("approximate", oct_), ("exact", ex), ("real", real)):
        out[f"distance_{name}"] = np_(parallel.sharded_distance(sdf, x["pts"], mesh))
    d, g = parallel.sharded_distance_and_gradient(oct_, x["pts"], mesh)
    out["gradient_d"], out["gradient_g"] = np_(d), np_(g)
    tr = parallel.sharded_trace(oct_, x["origins"], x["dirs"], mesh, max_iters=128)
    for field, v in zip(tr._fields, tr):
        out[f"trace_{field}"] = np_(v)
    c0 = octree_coefficients(oct_.octree_data)
    loss0, c1 = parallel.data_parallel_fit_step(oct_, c0, x["fit_pts"], x["targets"], mesh,
                                                lr=1e-2)
    loss1, c2 = parallel.data_parallel_fit_step(oct_, c1, x["fit_pts"], x["targets"], mesh,
                                                lr=1e-2)
    out.update(fit_loss0=np_(loss0), fit_c1=np_(c1[0]), fit_loss1=np_(loss1),
               fit_c2=np_(c2[0]), fit_replicas=np.int64(len(c2)))
    tiled = TiledExactOctreeSdf(x["sphere"], x["box"], **EXACT_KW, device_mesh=mesh)
    out["tiled_exact_d"] = np_(tiled.get_distance(x["tile_pts"]))
    d, g = tiled.get_distance_and_gradient(x["tile_pts"])
    out["tiled_exact_dg"], out["tiled_exact_g"] = np_(d), np_(g)
    out["tiled_exact_shards"] = np.int64(len(tiled.shards))
    slabs = TiledOctreeSdf(_octree=oct_, device_mesh=mesh)
    out["tiled_octree_d"] = np_(slabs.get_distance(x["pts"]))
    d, g = slabs.get_distance_and_gradient(x["pts"])
    out["tiled_octree_dg"], out["tiled_octree_g"] = np_(d), np_(g)
    out["tiled_octree_slabs"] = np.int64(len(slabs.slabs))
    return out, tiled


def _rank_main(rank, world, init_file, data_dir, case):
    """One rank: the gloo group, then the case's calls; the results go to
    ``rank<r>.npz`` in ``data_dir``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        if case == "raise":
            if rank == 1:
                raise RuntimeError("rank 1 failed before its call")
            mesh = parallel.process_mesh(LOCAL)
            real = RealSdf(make_icosphere(subdivisions=1, radius=0.35), device="cpu")
            parallel.sharded_distance(real, np.zeros((8, 3), np.float32), mesh)
            return
        x = _inputs()
        oct_, ex, real = _structures(data_dir)
        mesh = parallel.process_mesh(LOCAL)
        out, tiled = _calls(mesh, oct_, ex, real, x)
        out["mesh"] = np.array([f"{e.rank}/{e.device}" for e in mesh])
        out["default_is_mesh"] = np.bool_(parallel.default_mesh(mesh) is mesh)
        try:
            parallel.default_mesh()
            out["default_error"] = np.array("")
        except RuntimeError as e:
            out["default_error"] = np.array(str(e))
        try:
            tiled.save(os.path.join(data_dir, f"tiled{rank}.npz"))
            out["save_error"] = np.array("")
        except ValueError as e:
            out["save_error"] = np.array(str(e))
        sub = parallel.sharded_distance(oct_, x["pts"], mesh[:2])
        out["sub_none"] = np.bool_(sub is None)
        if sub is not None:
            out["sub_d"] = sub.numpy()
        np.savez(os.path.join(data_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, case):
    """Two ranks of ``_rank_main``; fails if they are not done by the
    deadline (each killed then)."""
    ctx = mp.start_processes(_rank_main, args=(2, str(tmp_path / "rendezvous"),
                                               str(tmp_path), case),
                             nprocs=2, join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                pytest.fail(f"the ranks of case {case!r} were not done in {DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX structures saved for the ranks, the two ranks' results,
    and the one-process calls on ``[cpu, cpu:0] * 2``."""
    from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf as JExact
    from sdflib_tpu.sdf.octree import OctreeSdf as JOctree
    from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere

    tmp = tmp_path_factory.mktemp("procs")
    jm = j_icosphere(subdivisions=2, radius=0.35)
    jbox = jm.bounding_box.add_margin(0.14)
    j_oct = JOctree(jm, jbox, max_depth=4, start_depth=1, termination_threshold=1e-3)
    j_ex = JExact(jm, jbox, **EXACT_KW)
    np.savez(tmp / "octree.npz", **j_oct._state_arrays())
    np.savez(tmp / "exact.npz", **j_ex._state_arrays())
    _spawn(tmp, "calls")
    ranks = []
    for r in range(2):
        with np.load(tmp / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    oct_, ex, real = _structures(str(tmp))
    ref, _ = _calls(ONE_PROCESS, oct_, ex, real, _inputs())
    ref["sub_d"] = parallel.sharded_distance(oct_, _inputs()["pts"], LOCAL).numpy()
    return dict(ranks=ranks, ref=ref, j_oct=j_oct, j_ex=j_ex)


def _bits(a):
    """The bytes of an array (so -0.0 differs from 0.0)."""
    return np.atleast_1d(a).view(np.uint8)


CALLS = {
    "distance": ["distance_approximate", "distance_exact", "distance_real"],
    "gradient": ["gradient_d", "gradient_g"],
    "trace": [f"trace_{f}" for f in ("hit", "position", "depth", "normal", "iterations")],
    "fit": ["fit_loss0", "fit_c1", "fit_loss1", "fit_c2"],
    "tiled_exact": ["tiled_exact_d", "tiled_exact_dg", "tiled_exact_g"],
    "tiled_octree": ["tiled_octree_d", "tiled_octree_dg", "tiled_octree_g"],
}


@pytest.mark.parametrize("call", list(CALLS))
def test_two_ranks_equal_one_process(runs, call):
    """Both ranks return the one-process answer, bit for bit."""
    for key in CALLS[call]:
        want = runs["ref"][key]
        for r, res in enumerate(runs["ranks"]):
            got = res[key]
            assert got.shape == want.shape and got.dtype == want.dtype, (key, r)
            assert np.array_equal(_bits(got), _bits(want)), (key, r)


@pytest.mark.parametrize("call", list(CALLS))
def test_two_ranks_agree_with_jax(runs, call):
    """Rank 1's answers (equal to rank 0's) against the JAX package's
    on its eight CPU devices."""
    import jax

    from sdflib_tpu import parallel as jpar
    from sdflib_tpu.diff.query import octree_coefficients as j_coefficients
    from sdflib_tpu.sdf import RealSdf as JReal
    from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere

    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    jmesh = jpar.default_mesh()
    res, x = runs["ranks"][1], _inputs()
    j_oct, j_ex = runs["j_oct"], runs["j_ex"]
    if call == "distance":
        jreal = JReal(j_icosphere(subdivisions=2, radius=0.35))
        for name, j in (("approximate", j_oct), ("exact", j_ex), ("real", jreal)):
            np.testing.assert_allclose(res[f"distance_{name}"],
                                       np.asarray(jpar.sharded_distance(j, x["pts"], jmesh)),
                                       rtol=0, atol=1e-6)
    elif call == "gradient":
        dj, gj = jpar.sharded_distance_and_gradient(j_oct, x["pts"], jmesh)
        np.testing.assert_allclose(res["gradient_d"], np.asarray(dj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(res["gradient_g"], np.asarray(gj), rtol=0, atol=1e-5)
    elif call == "trace":
        rj = jpar.sharded_trace(j_oct, x["origins"], x["dirs"], jmesh, max_iters=128)
        hj, hp = np.asarray(rj.hit), res["trace_hit"]
        assert (hj == hp).mean() >= 0.998 and hp.any()
        both = hj & hp
        assert np.abs(np.asarray(rj.depth)[both] - res["trace_depth"][both]).max() <= 1e-3
    elif call == "fit":
        jl, jc = jpar.data_parallel_fit_step(j_oct, j_coefficients(j_oct.octree_data),
                                             x["fit_pts"], x["targets"], jmesh, lr=1e-2)
        assert abs(float(res["fit_loss0"]) - float(jl)) <= 1e-6 * abs(float(jl))
        jc = np.asarray(jc)
        assert np.abs(res["fit_c1"] - jc).max() <= 1e-6 * np.abs(jc).max()
        assert float(res["fit_loss1"]) <= float(res["fit_loss0"])
        assert int(res["fit_replicas"]) == len(LOCAL)
    elif call == "tiled_exact":
        want = np.asarray(jpar.sharded_distance(j_ex, x["tile_pts"], jmesh))
        np.testing.assert_allclose(res["tiled_exact_d"], want, **TOL)
        np.testing.assert_allclose(res["tiled_exact_dg"], want, **TOL)
        assert int(res["tiled_exact_shards"]) == len(LOCAL)
    else:
        dj, gj = jpar.sharded_distance_and_gradient(j_oct, x["pts"], jmesh)
        np.testing.assert_allclose(res["tiled_octree_d"], np.asarray(dj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(res["tiled_octree_g"], np.asarray(gj), rtol=0, atol=1e-5)
        assert int(res["tiled_octree_slabs"]) == len(LOCAL)


def test_two_ranks_mesh_subgroup_and_save(runs):
    """The list is every rank's entries in rank order, on both ranks;
    ``default_mesh`` keeps it, and without a card its default raises; a
    list of rank 0's entries runs on rank 0 alone (rank 1 gets None); the
    tiled save raises in both processes."""
    for r, res in enumerate(runs["ranks"]):
        assert res["mesh"].tolist() == ["0/cpu", "0/cpu:0", "1/cpu", "1/cpu:0"]
        assert bool(res["default_is_mesh"])
        if not torch.cuda.is_available():
            assert "no CUDA device" in str(res["default_error"])
        assert "holds every shard" in str(res["save_error"])
        assert bool(res["sub_none"]) == (r == 1)
    sub = runs["ranks"][0]["sub_d"]
    assert np.array_equal(_bits(sub), _bits(runs["ref"]["sub_d"]))


def test_a_rank_that_raises_fails_the_spawn(tmp_path):
    """Rank 1 raises before the collective that rank 0 waits in: the
    parent sees an error well before the deadline, rank 1's or, where
    rank 0 fails first, its collective's (the peer's connection reset
    as rank 1 left)."""
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException, match="rank 1 failed|by peer"):
        _spawn(tmp_path, "raise")
    assert time.monotonic() - t0 < DEADLINE


def test_process_mesh_bookkeeping():
    """Without a group: a ProcessMesh's entries, slices, this rank's
    entries, runs and blocks (a run never spans two ranks on one
    device), and the replicas per local entry."""
    cpu, cpu0 = LOCAL
    mesh = parallel.ProcessMesh([(0, cpu), (0, cpu), (1, cpu), (1, cpu0)], rank=1)
    assert len(mesh) == 4 and mesh[2] == parallel.Entry(1, cpu)
    assert isinstance(mesh[1:], parallel.ProcessMesh) and mesh[1:].rank == 1
    assert mesh.ranks == [0, 1] and mesh[:2].ranks == [0]
    assert parallel.local_devices(mesh) == [cpu, cpu0]
    assert parallel.mesh.local_entries(mesh) == [(2, cpu), (3, cpu0)]
    assert parallel.mesh.device_runs(mesh) == [(cpu, 2, 1), (cpu0, 3, 1)]
    assert parallel.default_mesh(mesh) is mesh
    blocks = parallel.sharded_rays(mesh).put(torch.arange(8.0))
    assert [(d, b.tolist()) for d, b in blocks] == [(cpu, [4.0, 5.0]), (cpu0, [6.0, 7.0])]
    copies = parallel.replicated(mesh).put(torch.ones(2))
    assert len(copies) == 2 and copies[0] is not copies[1]
    # rank 0 holds one run of two entries: the same device twice
    zero = parallel.ProcessMesh([(e.rank, e.device) for e in mesh], rank=0)
    assert parallel.mesh.device_runs(zero) == [(cpu, 0, 2)]
    # two ranks on one device: two runs
    shared = parallel.ProcessMesh([(0, cpu), (1, cpu)], rank=0)
    assert parallel.mesh.device_runs(shared) == [(cpu, 0, 1)]
