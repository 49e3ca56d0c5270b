"""scaling-bench: rays/queries-per-second scaling over device counts.

Port of the JAX package's ``tools/scaling_bench.py``: sharded query and
sphere-trace throughput on the first 1, 2, 4, ... devices of the device
list (every visible card by default; ``--device cpu`` the CPU once), with
the parallel efficiency of each row. Each rate is one call after a warm
call, timed with CUDA events on one card and with the host clock after
synchronising every card otherwise.

Several processes: under a launcher that names a world (``torchrun
--nproc_per_node 4 -m sdflib_tpu_torch.tools.scaling_bench --json``
starts one rank a card), ``main`` starts the group
(``parallel.initialize_distributed``: NCCL on the cards, gloo with
``--device cpu``) and the list is every rank's cards
(``parallel.default_mesh()``, a ``ProcessMesh``). Every rank runs every
row; each timed call is bracketed by a synchronise of the rank's cards
and a ``dist.barrier()``, and rank 0 alone prints.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="scaling-bench")
    p.add_argument("-m", "--millions_of_samples", type=float, default=2.0)
    p.add_argument("--rays", type=int, default=1 << 19)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--json", action="store_true")
    add_device_arg(p)
    return p


def _rate(fn, n: int, devices) -> float:
    """n over the seconds of one call after a warm call; over a
    ``ProcessMesh`` every rank's, from barrier to barrier."""
    import time

    import torch

    from ..parallel import ProcessMesh, local_devices
    from .common import timed

    group = isinstance(devices, ProcessMesh)
    if len(set(devices)) == 1 and not group:
        return n / timed(fn, devices[0])[1]
    cards = [d for d in set(local_devices(devices)) if d.type == "cuda"]

    def settle():
        for d in cards:
            torch.cuda.synchronize(d)
        if group:
            import torch.distributed as dist

            dist.barrier()

    fn()
    settle()
    t0 = time.perf_counter()
    fn()
    settle()
    return n / (time.perf_counter() - t0)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .. import parallel
    from ..sdf.sdf_function import resolve_device

    import torch.distributed as dist

    device = resolve_device(args.device)
    started = not dist.is_initialized()
    parallel.initialize_distributed(backend="nccl" if device.type == "cuda" else "gloo")
    try:
        return _bench(args, device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _bench(args, device) -> int:
    import torch

    import torch.distributed as dist

    from .. import parallel
    from ..sdf.octree import OctreeSdf
    from ..utils.primitives import make_torus

    if device.type == "cuda" and device.index is None:
        devices = parallel.default_mesh()
    else:
        several = dist.is_initialized() and dist.get_world_size() > 1
        devices = parallel.process_mesh([device]) if several else [device]
    home = parallel.local_devices(devices)[0]
    procs = isinstance(devices, parallel.ProcessMesh)
    if procs and home.type == "cuda":
        torch.cuda.set_device(home)      # the card of this rank's collectives

    mesh_geo = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh_geo.bounding_box.add_margin(0.12)
    oct_ = OctreeSdf(mesh_geo, box, max_depth=args.depth, start_depth=2,
                     termination_threshold=1e-3, device=home)
    oct_.build_query_grid()

    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= len(devices)]

    n = int(1e6 * args.millions_of_samples)
    rng = np.random.default_rng(0)
    pts = rng.uniform(
        oct_.box.min + 1e-4, oct_.box.max - 1e-4, (n, 3)
    ).astype(np.float32)

    nr = args.rays
    u = rng.uniform(-0.5, 0.5, (nr, 2)).astype(np.float32)
    origins = np.concatenate([u, np.full((nr, 1), -1.2, np.float32)], -1)
    dirs = np.tile([[0.0, 0.0, 1.0]], (nr, 1)).astype(np.float32)
    pts_t = torch.as_tensor(pts, device=home)
    o_t = torch.as_tensor(origins, device=home)
    d_t = torch.as_tensor(dirs, device=home)

    rows = []
    for c in counts:
        m = parallel.default_mesh(devices[:c])
        qps = _rate(lambda: parallel.sharded_distance(oct_, pts_t, m), n, m)
        # a rank outside the list gets None
        rps = _rate(lambda: getattr(parallel.sharded_trace(oct_, o_t, d_t, m, max_iters=512),
                                    "depth", None), nr, m)
        rows.append({"devices": c, "queries_per_s": qps, "rays_per_s": rps})

    if procs and devices.rank > 0:
        return 0
    base_q = rows[0]["queries_per_s"]
    base_r = rows[0]["rays_per_s"]
    print(f"{'devices':>8} {'queries/s':>14} {'q-eff':>7} "
          f"{'rays/s':>14} {'r-eff':>7}")
    for row in rows:
        c = row["devices"]
        row["query_efficiency"] = row["queries_per_s"] / (base_q * c)
        row["ray_efficiency"] = row["rays_per_s"] / (base_r * c)
        print(f"{c:>8} {row['queries_per_s']:>14.3e} "
              f"{row['query_efficiency']:>7.2%} "
              f"{row['rays_per_s']:>14.3e} {row['ray_efficiency']:>7.2%}")

    if args.json:
        print(json.dumps({"platform": home.type,
                          "processes": len(devices.ranks) if procs else 1, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
