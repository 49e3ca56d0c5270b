"""mesh-preview: offline render of a SOURCE MESH to PNG.

Port of the JAX package's ``tools/mesh_preview.py``: the mesh-preview
role of the reference viewer's rasterized model pass (SdfViewer renders
the input mesh with NormalsShader / BasicShader / ColorsShader before any
SDF is shown: src/tools/SdfViewer/main.cpp:221,308 and
src/render_engine/shaders/{normals,basic,colors}.frag). There is no GL
here, so the mesh is drawn by sphere-tracing its brute-force exact SDF
(``RealSdf``: kernel K2 over all triangles on every march trip on the
card) and shading hits with pseudonormal gradients; the outputs match
the reference's three preview modes:

  normal - RGB = surface normal (normals.frag semantics)
  flat   - single albedo, headlight (basic.frag semantics)
  lit    - Lambert with a fixed key light (colors.frag-style shaded view)
"""
from __future__ import annotations

import argparse

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mesh-preview")
    p.add_argument("mesh_path", help="PLY/OBJ/STL/OFF mesh")
    p.add_argument("output_path", help="Output .png")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--camera", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--target", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--mode", default="lit",
                   choices=["lit", "normal", "flat"])
    p.add_argument("--max_iters", type=int, default=256)
    p.add_argument("--light", type=float, nargs=3,
                   default=(0.577, 0.577, 0.577))
    p.add_argument("--albedo", type=float, nargs=3, default=(0.8, 0.3, 0.25))
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..mesh import load_mesh
    from ..render import Camera, normal_color, shade_lambert, write_png
    from ..render.sphere_trace import sphere_trace
    from ..sdf.real import RealSdf

    mesh = load_mesh(args.mesh_path)
    real = RealSdf(mesh, device=args.device)

    box = mesh.bounding_box
    center = np.asarray(box.center, np.float64)
    diag = float(np.linalg.norm(box.size))
    cam_pos = (np.asarray(args.camera) if args.camera is not None
               else center + np.array([0.6, 0.45, 0.9]) * diag)
    target = np.asarray(args.target) if args.target is not None else center

    cam = Camera(position=cam_pos, target=target, fov_y_deg=args.fov)
    origins, dirs = cam.rays(args.width, args.height)

    eps = 1e-3 * diag
    hit, pos, depth, _ = sphere_trace(
        real.get_distance, origins, dirs,
        eps=eps, far=3.0 * diag + float(np.linalg.norm(cam_pos - center)),
        max_iters=args.max_iters, device=real.device,
    )
    _, grad = real.get_distance_and_gradient(pos)
    nrm = grad / grad.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    if args.mode == "normal":
        img = normal_color(nrm, hit)
    elif args.mode == "flat":
        # headlight: constant albedo scaled by |n . view| (basic.frag role)
        ndv = (nrm * torch.as_tensor(dirs, device=nrm.device)).sum(-1).abs()
        img = torch.where(
            hit[..., None],
            torch.tensor(args.albedo, dtype=torch.float32, device=nrm.device)
            * ndv[..., None],
            0.9,
        )
    else:
        img = shade_lambert(pos, nrm, hit, light_dir=args.light,
                            view_dir=dirs)

    write_png(args.output_path, img.cpu().numpy())
    hit_frac = float(hit.float().mean())
    print(f"Rendered {args.width}x{args.height} mesh preview ({args.mode}), "
          f"{100 * hit_frac:.1f}% hit -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
