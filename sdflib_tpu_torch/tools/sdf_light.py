"""sdf-light: PBR-lit sphere-traced render of an octree SDF to PNG.

Port of the JAX package's ``tools/sdf_light.py`` (parity with the
reference SdfLight tool, src/tools/SdfLight/main.cpp + shaders/
sdfOctreeLight.frag): Cook-Torrance shading with configurable
metallic/roughness/albedo, ambient occlusion, and soft shadows, traced
and shaded on the octree's device and written as an offline PNG instead
of an interactive GL window.
"""
from __future__ import annotations

import argparse

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sdf-light")
    p.add_argument("sdf_path")
    p.add_argument("output_path", help="Output .png")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--camera", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--target", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--max_iters", type=int, default=700,
                   help="march cap (sdfOctreeLight.frag default)")
    p.add_argument("--light", type=float, nargs=3,
                   default=(0.577, 0.577, 0.577))
    p.add_argument("--light_color", type=float, nargs=3,
                   default=(1.0, 1.0, 1.0))
    p.add_argument("--albedo", type=float, nargs=3, default=(0.8, 0.45, 0.3))
    p.add_argument("--metallic", type=float, default=0.1)
    p.add_argument("--roughness", type=float, default=0.5)
    p.add_argument("--no_ao", action="store_true")
    p.add_argument("--no_shadow", action="store_true")
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .common import load_sdf
    from ..render import (
        Camera,
        ambient_occlusion,
        soft_shadow,
        trace_octree,
        write_png,
    )
    from ..render.shading import shade_pbr
    from ..sdf.octree import OctreeSdf
    from ..sdf.sdf_function import resolve_device

    sdf = load_sdf(args.sdf_path, resolve_device(args.device))
    if not isinstance(sdf, OctreeSdf):
        raise SystemExit("sdf-light requires an octree SDF container")

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

    dist_fn = sdf.get_distance
    ao = None if args.no_ao else ambient_occlusion(
        dist_fn, res.position, res.normal
    )
    shadow = None if args.no_shadow else soft_shadow(
        dist_fn, res.position + res.normal * 1e-3 * diag, args.light
    )

    img = shade_pbr(
        res.position, res.normal, res.hit, dirs,
        light_dir=args.light, light_color=args.light_color,
        base_color=args.albedo, metallic=args.metallic,
        roughness=args.roughness, ao=ao, shadow=shadow,
    )
    write_png(args.output_path, img.cpu().numpy())
    print(f"wrote {args.output_path} "
          f"({int(res.hit.sum())} hit pixels)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
