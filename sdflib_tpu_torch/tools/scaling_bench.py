"""scaling-bench: rays/queries-per-second scaling over device counts.

Port of the JAX package's ``tools/scaling_bench.py``: sharded query and
sphere-trace throughput on the first 1, 2, 4, ... devices of the device
list (every visible card by default; ``--device cpu`` the CPU once), with
the parallel efficiency of each row. Each rate is one call after a warm
call, timed with CUDA events on one card and with the host clock after
synchronising every card otherwise. For several processes, call
``sdflib_tpu_torch.parallel.initialize_distributed()`` first.
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
    """n over the seconds of one call after a warm call."""
    import time

    import torch

    from .common import timed

    if len(set(devices)) == 1:
        return n / timed(fn, devices[0])[1]
    fn()
    cards = [d for d in set(devices) if d.type == "cuda"]
    for d in cards:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    fn()
    for d in cards:
        torch.cuda.synchronize(d)
    return n / (time.perf_counter() - t0)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .. import parallel
    from ..sdf.octree import OctreeSdf
    from ..sdf.sdf_function import resolve_device
    from ..utils.primitives import make_torus

    device = resolve_device(args.device)
    devices = (parallel.default_mesh() if device.type == "cuda" and device.index is None
               else [device])

    mesh_geo = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh_geo.bounding_box.add_margin(0.12)
    oct_ = OctreeSdf(mesh_geo, box, max_depth=args.depth, start_depth=2,
                     termination_threshold=1e-3, device=devices[0])
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
    pts_t = torch.as_tensor(pts, device=devices[0])
    o_t = torch.as_tensor(origins, device=devices[0])
    d_t = torch.as_tensor(dirs, device=devices[0])

    rows = []
    for c in counts:
        m = parallel.default_mesh(devices[:c])
        qps = _rate(lambda: parallel.sharded_distance(oct_, pts_t, m), n, m)
        rps = _rate(lambda: parallel.sharded_trace(oct_, o_t, d_t, m, max_iters=512).depth,
                    nr, m)
        rows.append({"devices": c, "queries_per_s": qps, "rays_per_s": rps})

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
        print(json.dumps({"platform": devices[0].type, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
