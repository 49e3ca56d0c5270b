"""sdf-error-compare: error histogram bucketed by distance to the surface.

Port of the JAX package's ``tools/sdf_error_compare.py`` (parity with
the reference SdfErrorCompare tool, src/tools/SdfErrorCompare/
main.cpp:382-425): N million uniform samples, RMSE/MAE per |exact
distance| bucket, plus overall metrics and throughput for each structure
under comparison. Any number of containers can be compared against the
exact reference (an exact container or a mesh through ``RealSdf``). Each
structure is timed on one call after a warm call, with CUDA events on
the card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sdf-error-compare")
    p.add_argument("exact_path",
                   help="Ground truth: exact container or a mesh file")
    p.add_argument("sdf_paths", nargs="+",
                   help="SDF containers to evaluate against the ground truth")
    p.add_argument("-m", "--millions_of_samples", type=float, default=1.0)
    p.add_argument("--histogram_bins", type=int, default=20)
    p.add_argument("--histogram_range", type=float, default=None,
                   help="Max |distance| for the histogram (default: auto)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    import torch

    from .common import load_sdf, timed
    from ..sdf.sdf_function import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    exact = load_sdf(args.exact_path, device, mesh_as_real=True)

    n = int(1e6 * args.millions_of_samples)
    rng = np.random.default_rng(args.seed)
    area = exact.get_sample_area()
    samples = (
        area.center + (rng.uniform(0, 1, (n, 3)) - 0.5) * (area.size - 1e-5)
    ).astype(np.float32)
    pts = torch.as_tensor(samples, device=device)

    d_exact = exact.get_distance(pts).cpu().numpy()
    hist_max = args.histogram_range or float(np.quantile(np.abs(d_exact), 0.99))
    edges = np.linspace(0.0, hist_max, args.histogram_bins + 1)
    bucket = np.clip(
        np.digitize(np.abs(d_exact), edges) - 1, 0, args.histogram_bins - 1
    )

    results = []
    for path in args.sdf_paths:
        sdf = load_sdf(path, device, mesh_as_real=True)
        d, dt = timed(lambda: sdf.get_distance(pts), device)
        d = d.cpu().numpy()

        diff = d.astype(np.float64) - d_exact.astype(np.float64)
        per_bucket = []
        for b in range(args.histogram_bins):
            m = bucket == b
            if not m.any():
                per_bucket.append(None)
                continue
            per_bucket.append(
                {
                    "lo": float(edges[b]),
                    "hi": float(edges[b + 1]),
                    "rmse": float(np.sqrt(np.mean(diff[m] ** 2))),
                    "mae": float(np.mean(np.abs(diff[m]))),
                    "count": int(m.sum()),
                }
            )
        res = {
            "path": path,
            "us_per_query": dt * 1e6 / n,
            "rmse": float(np.sqrt(np.mean(diff**2))),
            "mae": float(np.mean(np.abs(diff))),
            "max_error": float(np.abs(diff).max()),
            "histogram": per_bucket,
        }
        results.append(res)

        print(f"== {path}")
        print(f"  us/query: {res['us_per_query']:.4f}   RMSE: {res['rmse']:.3e}"
              f"   MAE: {res['mae']:.3e}   max: {res['max_error']:.3e}")
        print("  |d| bucket        RMSE         MAE       n")
        for pb in per_bucket:
            if pb is None:
                continue
            print(
                f"  [{pb['lo']:.4f},{pb['hi']:.4f})"
                f"  {pb['rmse']:.3e}  {pb['mae']:.3e}  {pb['count']}"
            )

    if args.json:
        print(json.dumps({"samples": n, "results": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
