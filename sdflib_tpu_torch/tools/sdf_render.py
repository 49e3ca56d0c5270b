"""sdf-render: sphere-traced render of an octree SDF to PNG.

Port of the JAX package's ``tools/sdf_render.py`` (parity with the
reference SdfRender tool, src/tools/SdfRender/main.cpp + RenderSdf.cpp:
150-192): loads an octree container and sphere-traces it on the
octree's device; instead of an interactive GL window it writes PNGs
(normal-shaded, lit, and iteration-heatmap variants).
"""
from __future__ import annotations

import argparse

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sdf-render")
    p.add_argument("sdf_path")
    p.add_argument("output_path", help="Output .png")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--camera", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--target", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--max_iters", type=int, default=1024,
                   help="MAX_ITERATIONS (sdfOctreeRender.comp:3)")
    p.add_argument("--mode", default="lit",
                   choices=["lit", "normal", "iterations", "depth"])
    p.add_argument("--ao", action="store_true", help="8-tap ambient occlusion")
    p.add_argument("--shadow", action="store_true", help="soft shadows")
    p.add_argument("--light", type=float, nargs=3, default=(0.577, 0.577, 0.577))
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .common import load_sdf
    from ..render import (
        Camera,
        ambient_occlusion,
        iteration_heatmap,
        normal_color,
        shade_lambert,
        soft_shadow,
        trace_octree,
        write_png,
    )
    from ..sdf.octree import OctreeSdf
    from ..sdf.sdf_function import resolve_device

    sdf = load_sdf(args.sdf_path, resolve_device(args.device))
    if not isinstance(sdf, OctreeSdf):
        raise SystemExit("sdf-render requires an octree SDF container")

    area = sdf.get_sample_area()
    center = np.asarray(area.center, np.float64)
    diag = float(np.linalg.norm(area.size))
    cam_pos = (np.asarray(args.camera) if args.camera is not None
               else center + np.array([0.6, 0.45, 0.9]) * diag)
    target = np.asarray(args.target) if args.target is not None else center

    cam = Camera(position=cam_pos, target=target, fov_y_deg=args.fov)
    origins, dirs = cam.rays(args.width, args.height)
    res = trace_octree(sdf, origins, dirs, eps=1e-5, far=4.0,
                       max_iters=args.max_iters)

    if args.mode == "normal":
        img = normal_color(res.normal, res.hit)
    elif args.mode == "iterations":
        img = iteration_heatmap(res.iterations, args.max_iters)
    elif args.mode == "depth":
        d = res.depth.cpu().numpy()
        d = np.where(res.hit.cpu().numpy(), d, np.nan)
        lo, hi = np.nanmin(d), np.nanmax(d)
        img = np.where(np.isnan(d), 1.0, (d - lo) / max(hi - lo, 1e-9))
    else:
        ao = shadow = None
        if args.ao:
            ao = ambient_occlusion(sdf.get_distance, res.position, res.normal)
        if args.shadow:
            shadow = soft_shadow(sdf.get_distance, res.position, args.light)
        img = shade_lambert(
            res.position, res.normal, res.hit,
            light_dir=args.light, view_dir=dirs, ao=ao, shadow=shadow,
        )

    write_png(args.output_path, img.cpu().numpy() if isinstance(img, torch.Tensor) else img)
    hit_frac = float(res.hit.float().mean())
    print(f"Rendered {args.width}x{args.height} ({args.mode}), "
          f"{100*hit_frac:.1f}% hit -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
