"""sdf-error: query-throughput + accuracy harness.

Port of the JAX package's ``tools/sdf_error.py`` (parity with the
reference SdfError tool, src/tools/SdfError/main.cpp:44-97): N million
uniform random samples in the SDF's sample area; prints time per query
for the approximate and the reference ("exact") SDF, and RMSE / MAE /
max error between them. The exact SDF may be an exact-octree container
or computed by brute force from the mesh (``RealSdf``). Each structure
is timed on one call after a warm call, with CUDA events on the card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sdf-error")
    p.add_argument("sdf_path", help="The SDF container to evaluate")
    p.add_argument("exact_path", nargs="?", default=None,
                   help="Exact SDF container, or a mesh file for brute force")
    p.add_argument("-m", "--millions_of_samples", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="Emit one JSON line")
    add_device_arg(p)
    return p


def _time_queries(sdf, samples, device):
    """(distances as numpy, seconds of one timed call); the points sit on
    the device before the clock starts, as JAX's ``jnp.asarray``."""
    import torch

    from .common import timed

    pts = torch.as_tensor(samples, device=device)
    d, dt = timed(lambda: sdf.get_distance(pts), device)
    return d.cpu().numpy(), dt


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .common import load_sdf
    from ..sdf.sdf_function import resolve_device

    device = resolve_device(args.device)
    sdf = load_sdf(args.sdf_path, device)

    n = int(1e6 * args.millions_of_samples)
    rng = np.random.default_rng(args.seed)
    area = sdf.get_sample_area()
    center = area.center
    size = area.size - 1e-5
    samples = (center + (rng.uniform(0, 1, (n, 3)) - 0.5) * size).astype(np.float32)

    d_sdf, t_sdf = _time_queries(sdf, samples, device)
    us_sdf = t_sdf * 1e6 / n
    print(f"Sdf us per query: {us_sdf:.6f}  ({n / t_sdf:.3e} queries/s)")

    result = {"us_per_query": us_sdf, "queries_per_s": n / t_sdf, "samples": n}

    if args.exact_path is not None:
        exact = load_sdf(args.exact_path, device, mesh_as_real=True)
        d_exact, t_exact = _time_queries(exact, samples, device)
        us_e = t_exact * 1e6 / n
        print(f"Exact Sdf us per query: {us_e:.6f}  ({n / t_exact:.3e} queries/s)")

        diff = d_sdf.astype(np.float64) - d_exact.astype(np.float64)
        rmse = float(np.sqrt(np.mean(diff**2)))
        mae = float(np.mean(np.abs(diff)))
        mx = float(np.abs(diff).max())
        print(f"RMSE: {rmse}")
        print(f"MAE: {mae}")
        print(f"Max error: {mx}")
        result.update(
            exact_us_per_query=us_e, rmse=rmse, mae=mae, max_error=mx
        )

    if args.json:
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
