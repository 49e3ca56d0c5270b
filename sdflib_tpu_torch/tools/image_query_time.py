"""image-query-time: per-pixel query value/cost images of a plane of queries.

Port of the JAX package's ``tools/image_query_time.py`` (parity with the
reference ImageQueryTime tool, src/tools/ImageQueryTime/main.cpp:255-403):
a width^2 plane of query points rendered to PNGs. The reference times
each query on the CPU; here the plane is one batch, so the per-pixel
"time" image is a per-pixel COST proxy (octree leaf depth: the descent
steps paid for that pixel) beside the batch's throughput (one call after
a warm call, CUDA events on the card), and the distance-value image
matches the reference's value output.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="image-query-time")
    p.add_argument("sdf_path")
    p.add_argument("output_prefix", help="writes <prefix>_value.png and "
                                         "<prefix>_cost.png")
    p.add_argument("-w", "--width", type=int, default=512)
    p.add_argument("--axis", type=int, default=2, choices=(0, 1, 2))
    p.add_argument("--offset", type=float, default=0.5)
    p.add_argument("--json", action="store_true")
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    import torch

    args = build_parser().parse_args(argv)

    from .common import load_sdf, timed
    from ..render.image import write_png
    from ..sdf.octree import OctreeSdf
    from ..sdf.sdf_function import resolve_device

    device = resolve_device(args.device)
    sdf = load_sdf(args.sdf_path, device)
    area = sdf.get_sample_area()

    R = args.width
    u = (np.arange(R, dtype=np.float32) + 0.5) / R
    gu, gv = np.meshgrid(u, u, indexing="xy")
    coords = [None, None, None]
    axes2d = [a for a in range(3) if a != args.axis]
    coords[axes2d[0]] = gu
    coords[axes2d[1]] = gv
    coords[args.axis] = np.full_like(gu, args.offset)
    unit = np.stack(coords, axis=-1)
    pts = (area.min + unit * area.size[None, None]).astype(np.float32)

    dev_pts = torch.as_tensor(pts.reshape(-1, 3), device=device)
    d, dt = timed(lambda: sdf.get_distance(dev_pts), device)
    d = d.cpu().numpy().reshape(R, R)

    # value image: signed distance, blue outside / red inside (reference
    # palette convention: negative = inside)
    rng = max(float(np.abs(d).max()), 1e-9)
    t = 0.5 + 0.5 * np.clip(d / rng, -1, 1)
    value_img = np.stack([1.0 - t, 0.2 + 0.3 * (1 - np.abs(2 * t - 1)), t], -1)
    write_png(args.output_prefix + "_value.png", value_img)

    # cost proxy: leaf depth per pixel for octrees, constant otherwise
    if isinstance(sdf, OctreeSdf):
        from ..render.plane_cut import _octree_node_metrics

        _, rel_len = _octree_node_metrics(sdf, dev_pts)
        depth = -np.log2(np.maximum(rel_len.cpu().numpy(), 1e-9))
        depth = depth.reshape(R, R) + sdf.start_depth
        cost = depth / max(sdf.max_depth, 1)
    else:
        cost = np.full((R, R), 0.5, np.float32)
    write_png(args.output_prefix + "_cost.png", cost)

    us = dt * 1e6 / (R * R)
    print(f"{R}x{R} queries: {dt*1e3:.2f} ms total, {us:.4f} us/query "
          f"({R*R/dt:.3e} queries/s)")
    if args.json:
        print(json.dumps({"width": R, "us_per_query": us,
                          "queries_per_s": R * R / dt}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
