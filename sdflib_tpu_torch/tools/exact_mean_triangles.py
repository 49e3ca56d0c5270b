"""exact-mean-triangles: plane-cut heatmap of triangles per exact-octree
leaf.

Port of the JAX package's ``tools/exact_mean_triangles.py`` (parity with
the reference OctreeExactMeanOfTrianglesViewer debug app, src/tools/
OctreeExactMeanOfTrianglesViewer/main.cpp): renders an offline PNG
heatmap of the leaf triangle-list sizes over an axis-aligned plane, plus
the list-size distribution, the diagnostics used to judge culling
quality. The plane's leaves come from the port's own descent
(``ExactOctreeSdf._descend``: the dense leaf grid where built, else the
node walk), not from the JAX package's walk, which lands a point at
exactly 0.5 of a node in a leaf that need not contain it (ROADMAP.md,
Queue 3).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="exact-mean-triangles")
    p.add_argument("sdf_path", help="an exact-octree .npz container")
    p.add_argument("output_png")
    p.add_argument("-w", "--width", type=int, default=512)
    p.add_argument("--axis", type=int, default=2, choices=(0, 1, 2))
    p.add_argument("--offset", type=float, default=0.5)
    p.add_argument("--json", action="store_true")
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    import torch

    args = build_parser().parse_args(argv)

    from ..render.image import write_png
    from ..sdf.exact_octree import ExactOctreeSdf
    from ..sdf.sdf_function import SdfFunction, resolve_device

    device = resolve_device(args.device)
    sdf = SdfFunction.load(args.sdf_path, device=device)
    if not isinstance(sdf, ExactOctreeSdf):
        raise SystemExit("exact-mean-triangles needs an EXACT_OCTREE container")

    R = args.width
    u = (np.arange(R, dtype=np.float32) + 0.5) / R
    gu, gv = np.meshgrid(u, u, indexing="xy")
    coords = [None, None, None]
    axes2d = [a for a in range(3) if a != args.axis]
    coords[axes2d[0]] = gu
    coords[axes2d[1]] = gv
    coords[args.axis] = np.full_like(gu, args.offset)
    unit = np.stack(coords, axis=-1)
    pts = (sdf.box.min + unit * sdf.box.size[None, None]).astype(np.float32)

    leaf_id = sdf._descend(torch.as_tensor(pts.reshape(-1, 3), device=device))
    counts = np.asarray(sdf.leaf_count)[leaf_id.cpu().numpy()].reshape(R, R)

    cmax = max(int(counts.max()), 1)
    t = counts.astype(np.float32) / cmax
    # blue (few) -> yellow -> red (many) heatmap
    img = np.stack(
        [np.clip(2 * t, 0, 1), np.clip(2 - 2 * t, 0, 1) * (t > 0.02),
         np.clip(1 - 3 * t, 0, 1)],
        axis=-1,
    )
    write_png(args.output_png, img)

    all_counts = np.asarray(sdf.leaf_count)
    stats = {
        "leaves": int(all_counts.size),
        "mean_tris_per_leaf": float(all_counts.mean()),
        "p50": float(np.quantile(all_counts, 0.5)),
        "p95": float(np.quantile(all_counts, 0.95)),
        "max": int(all_counts.max()),
        "plane_max": int(counts.max()),
    }
    print(
        f"leaves: {stats['leaves']}  mean tris/leaf: "
        f"{stats['mean_tris_per_leaf']:.1f}  p95: {stats['p95']:.0f}  "
        f"max: {stats['max']}"
    )
    if args.json:
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
