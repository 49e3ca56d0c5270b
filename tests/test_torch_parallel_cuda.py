"""``parallel``'s workers on the card (every case is cuda-marked and skips
without one; several need two cards or more). The CPU cases of the
workers are in tests/test_torch_parallel.py and
tests/test_torch_parallel_tiles.py.

* ``[cuda:0, cuda] * 2`` runs two workers on one card: the sharded
  distances of the approximate, exact and brute-force structures, the
  gradients and a 512^2-ray trace (four pyramid blocks, replayed as CUDA
  graphs) bit-equal to the single-device calls, the second trace
  replaying without a capture; the fit step's first step within 1e-6 of
  one entry's (the backward's scatter-add on the card accumulates in no
  fixed order).
* Every card (at most four): the same calls bit-equal to one card's, one
  worker thread per card, and the fit step within 1e-6.
* A capture on card 1 while card 0's worker makes host syncs (having
  given up its turn, as the tracer's syncs do, and started after card 1
  may have begun a capture): the capture is thread-local, so neither
  side fails, and the captured frame equals the eager schedule.
* Two ranks on two cards under NCCL (``torch.multiprocessing`` spawn, a
  ``file://`` rendezvous): over the ``ProcessMesh`` of one card a rank,
  the sharded exact query equals each rank's one-card query bit for bit;
  the fit step's loss equals the one-process step over two entries of
  one card (``[cuda:r, cuda]``, the same two blocks) bit for bit, its
  coefficients within 1e-6 of the largest (the scatter-add's atomics).

No JAX here: the GPU machine runs this file with
``python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py``.
"""
import datetime
import importlib
import json
import os
import threading
import time

import pytest
import torch

from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf, SdfFunction, parallel
from sdflib_tpu_torch.diff.query import octree_coefficients
from sdflib_tpu_torch.render.sphere_trace import trace_octree
from sdflib_tpu_torch.utils.primitives import make_torus

st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
mesh_mod = importlib.import_module("sdflib_tpu_torch.parallel.mesh")


def _ortho(n: int):
    """bench.py's rays at n^2 on cuda:0: origins on z = -1.2 over
    [-0.5, 0.5]^2, directions +z."""
    u = (torch.arange(n, dtype=torch.float32) + 0.5) / n - 0.5
    gv, gu = torch.meshgrid(u, u, indexing="ij")
    o = torch.stack([gu, gv, torch.full_like(gu, -1.2)], -1).reshape(-1, 3)
    d = torch.tensor([0.0, 0.0, 1.0]).expand_as(o).contiguous()
    return o.to("cuda:0"), d.to("cuda:0")


@pytest.fixture(scope="module")
def structs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_torus(R=0.3, r=0.12, nu=48, nv=24)
    box = mesh.bounding_box.add_margin(0.14)
    oct_ = OctreeSdf(mesh, box, max_depth=5, start_depth=2, termination_threshold=1e-3,
                     device="cuda:0")
    oct_.build_query_grid()
    ex = ExactOctreeSdf(mesh, box, max_depth=5, start_depth=2, device="cuda:0")
    real = RealSdf(mesh, device="cuda:0")
    g = torch.Generator().manual_seed(0)
    lo, hi = torch.as_tensor(oct_.box.min), torch.as_tensor(oct_.box.max)
    pts = (lo + (hi - lo) * torch.rand((1 << 18, 3), generator=g)).to("cuda:0")
    return oct_, ex, real, pts


def _check_list(structs, devs):
    """The sharded calls on ``devs`` against the single-device calls."""
    oct_, ex, real, pts = structs
    for sdf, p in ((oct_, pts), (ex, pts[: 1 << 16]), (real, pts[:10_000])):
        assert torch.equal(parallel.sharded_distance(sdf, p, devs), sdf.get_distance(p))
    d, g = parallel.sharded_distance_and_gradient(oct_, pts, devs)
    d0, g0 = oct_.get_distance_and_gradient(pts)
    assert torch.equal(d, d0) and torch.equal(g, g0)
    o, dirs = _ortho(512)
    single = trace_octree(oct_, o, dirs, max_iters=1024, beam=None)
    first = parallel.sharded_trace(oct_, o, dirs, devs, max_iters=1024)
    second = parallel.sharded_trace(oct_, o, dirs, devs, max_iters=1024)
    for a, b, c in zip(first, second, single):
        assert a.device == torch.device("cuda", 0)
        assert torch.equal(a, c) and torch.equal(b, c)
    p, t = pts[:4096], real.get_distance(pts[:4096])
    c0 = octree_coefficients(oct_._octree_dev)
    l1, c1 = parallel.data_parallel_fit_step(oct_, c0, p, t, [devs[0]], lr=0.5)
    ln, cn = parallel.data_parallel_fit_step(oct_, c0, p, t, devs, lr=0.5)
    assert len(cn) == len(devs)
    assert abs(float(ln) - float(l1)) <= 1e-6 * abs(float(l1))
    assert float((cn[0] - c1[0]).abs().max()) <= 1e-6 * float(c1[0].abs().max())


@pytest.mark.cuda
def test_two_workers_on_one_card(structs):
    devs = [torch.device("cuda", 0), torch.device("cuda")] * 2
    _check_list(structs, devs)
    assert {torch.device("cuda", 0), torch.device("cuda")} <= set(mesh_mod._WORKERS)
    # the two workers' twin frames: each replays on a later call
    o, dirs = _ortho(512)
    key_frames = [f for fr in st._FRAMES.frames[torch.device("cuda", 0)].values() for f in fr]
    parallel.sharded_trace(structs[0], o, dirs, devs, max_iters=1024)
    assert any(f.runner.replayed > 0 and f.runner.captured == 0 for f in key_frames)


@pytest.mark.cuda
def test_every_card_equals_one_card(structs):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    devs = parallel.default_mesh()[:4]
    _check_list(structs, devs)
    assert set(devs) <= set(mesh_mod._WORKERS)
    assert len({mesh_mod._WORKERS[d] for d in devs}) == len(devs)


@pytest.mark.cuda
def test_capture_on_card_1_while_card_0_syncs(structs):
    """Card 1's worker captures a new frame while card 0's worker loops
    on host syncs, each out of its turn, until the capture is done."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_torus(R=0.3, r=0.12, nu=40, nv=20)
    tree = OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), max_depth=5, start_depth=2,
                     termination_threshold=1e-3, device="cuda:1")
    tree.build_query_grid()
    o, dirs = (x.to("cuda:1") for x in _ortho(200))    # a shape no other test captured
    started, done = threading.Event(), threading.Event()
    syncs = []

    def block(dev, _):
        if dev.index == 0:
            started.set()
            x = torch.rand(1 << 22, device=dev)
            while not done.wait(0):
                y = x
                for _ in range(16):           # ~0.5 ms of work to wait on
                    y = torch.sin(y + torch.rand_like(y))
                flag = (y > 0.5).any()
                with parallel.mesh.waiting():     # as the tracer's syncs
                    time.sleep(2e-4)              # card 1 may start a capture
                    syncs.append(bool(flag))
            return None
        with parallel.mesh.waiting():
            assert started.wait(30)
        stats = {}
        try:
            out = trace_octree(tree, o, dirs, max_iters=1024, stats_out=stats)
        finally:
            done.set()
        return out, stats

    _, (out, stats) = parallel.mesh.run_blocks(
        [(torch.device("cuda", 0), None), (torch.device("cuda", 1), None)], block)
    assert stats["graphs_captured"] > 0 and len(syncs) > 0
    eager = st._trace(tree, o, dirs, eps=1e-5, far=4.0, max_iters=1024, block_size=None,
                      beam=4, pyramid=True, stats_out=None, active=None, graphs=False)
    for a, b in zip(out, eager):
        assert a.device == torch.device("cuda", 1) and torch.equal(a, b)


def _nccl_rank(rank, tmp):
    """One of two NCCL ranks, on card ``rank``: the structures the parent
    saved, the sharded exact query and the fit step over the processes
    and on its card; the comparisons go to ``rank<r>.json``."""
    import torch.distributed as dist

    card = torch.device("cuda", rank)
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            rank=rank, world_size=2, timeout=datetime.timedelta(seconds=120))
    try:
        ex = SdfFunction.load(os.path.join(tmp, "exact.npz"), device=card)
        oct_ = SdfFunction.load(os.path.join(tmp, "octree.npz"), device=card)
        pts = torch.load(os.path.join(tmp, "points.pt")).to(card)
        mesh = parallel.process_mesh([card])
        d = parallel.sharded_distance(ex, pts, mesh)
        p, t = pts[:4096], RealSdf(make_torus(R=0.3, r=0.12, nu=48, nv=24),
                                   device=card).get_distance(pts[:4096])
        c0 = octree_coefficients(oct_._octree_dev)
        lp, cp = parallel.data_parallel_fit_step(oct_, c0, p, t, mesh, lr=0.5)
        l1, c1 = parallel.data_parallel_fit_step(oct_, c0, p, t, [card, torch.device("cuda")],
                                                 lr=0.5)
        res = dict(
            distance=torch.equal(d, ex.get_distance(pts)), loss=torch.equal(lp, l1),
            coefficients=float((cp[0] - c1[0]).abs().max() / c1[0].abs().max()),
            replicas=len(cp), device=str(d.device))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_two_nccl_ranks_equal_one_card(tmp_path):
    """Two processes, one card each, under NCCL."""
    import torch.multiprocessing as mp

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_torus(R=0.3, r=0.12, nu=48, nv=24)
    box = mesh.bounding_box.add_margin(0.14)
    ExactOctreeSdf(mesh, box, max_depth=5, start_depth=2, device="cuda:0").save(
        str(tmp_path / "exact.npz"))
    OctreeSdf(mesh, box, max_depth=5, start_depth=2, termination_threshold=1e-3,
              device="cuda:0").save(str(tmp_path / "octree.npz"))
    g = torch.Generator().manual_seed(0)
    lo, hi = torch.as_tensor(box.min), torch.as_tensor(box.max)
    torch.save(lo + (hi - lo) * torch.rand((1 << 18, 3), generator=g), tmp_path / "points.pt")
    ctx = mp.start_processes(_nccl_rank, args=(str(tmp_path),), nprocs=2, join=False,
                             start_method="spawn")
    end = time.monotonic() + 300
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < end, "the ranks were not done in 300 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        assert res["distance"] and res["loss"], res
        assert res["coefficients"] <= 1e-6 and res["replicas"] == 1, res
        assert res["device"] == f"cuda:{r}", res
