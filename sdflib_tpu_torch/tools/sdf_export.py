"""sdf-export: mesh -> {octree, grid, exact_octree} -> container file.

Port of the JAX package's ``tools/sdf_export.py``, with its flags and
defaults (CLI parity with the reference SdfExporter, src/tools/
SdfExporter/main.cpp:28-171: format=octree, depth=7, start_depth=2 for
octree / 4 grid, threshold=1e-3, bb_margin=20%), build timing printed,
plus ``--device`` (default cuda). Output container is .npz (native) or
.bin (reference cereal format).
"""
from __future__ import annotations

import argparse
import sys
import time

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdf-export", description="Export an SDF from a mesh"
    )
    p.add_argument("model_path", help="The model path (.ply/.obj/.stl/.off)")
    p.add_argument("output_path", help="Output path (.npz or .bin)")
    p.add_argument("-c", "--cell_size", type=float, default=None,
                   help="Voxel size (grid format)")
    p.add_argument("-d", "--depth", type=int, default=None,
                   help="Octree subdivision depth (default 7; grid 4)")
    p.add_argument("--start_depth", type=int, default=None,
                   help="Octree start depth (default 2)")
    p.add_argument("--termination_rule", default="trapezoidal_rule",
                   help="trapezoidal_rule | simpsons_rule | by_distance_rule | none")
    p.add_argument("--termination_threshold", type=float, default=1e-3)
    p.add_argument("--termination_threshold_by_distance", type=float, default=0.0,
                   help="Error decay for by_distance_rule")
    p.add_argument("--min_triangles_per_node", type=int, default=32,
                   help="Exact octree leaf size (CLI default 32)")
    p.add_argument("--strategy", default=None,
                   choices=["lattice", "basic", "precise", "per_vertex",
                            "distance"],
                   help="Triangle influence strategy (reference "
                        "TrianglesInfluence variants). Defaults: exact "
                        "octrees use 'lattice'; approximate octrees use "
                        "the free 'distance' center rule ('distance' is "
                        "approx-only).")
    p.add_argument("--futility", type=float, default=0.8,
                   help="Exact-octree futility termination ratio: a node "
                        "whose culled list keeps >= this fraction of its "
                        "parent's becomes a leaf (an exactness-preserving "
                        "deviation from the reference, on by default). "
                        "Pass a value < 0 to disable and produce "
                        "reference-shaped trees")
    p.add_argument("--sdf_format", default="octree",
                   choices=["octree", "grid", "exact_octree"])
    p.add_argument("--algorithm", default="no_continuity",
                   choices=["uniform", "no_continuity", "continuity"])
    p.add_argument("-n", "--normalize", action="store_true",
                   help="Normalize the model coordinates")
    p.add_argument("--bb_margin", type=float, default=20.0,
                   help="Margin %% between structure BB and model BB")
    p.add_argument("--interpolation", default="tricubic",
                   choices=["tricubic", "trilinear"])
    p.add_argument("--num_threads", type=int, default=0,
                   help="Accepted for reference-CLI compatibility (unused; "
                        "parallelism is device-wide)")
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .common import TERMINATION_RULES, load_model, prepare_box
    from ..sdf.exact_octree import ExactOctreeSdf
    from ..sdf.grid import UniformGridSdf
    from ..sdf.octree import OctreeSdf
    from ..sdf.sdf_function import resolve_device

    rule = TERMINATION_RULES.get(args.termination_rule)
    if rule is None:
        print(f"error: unknown termination_rule {args.termination_rule!r}",
              file=sys.stderr)
        return 1
    if args.sdf_format == "exact_octree" and args.strategy == "distance":
        print("error: --strategy distance is approx-only (exact octrees "
              "take lattice/basic/precise/per_vertex)", file=sys.stderr)
        return 1
    device = resolve_device(args.device)

    mesh = load_model(args.model_path, args.normalize)
    box = prepare_box(mesh, args.bb_margin)
    print(f"Loaded {args.model_path}: {mesh.num_vertices} vertices, "
          f"{mesh.num_triangles} triangles")

    t0 = time.perf_counter()
    if args.sdf_format == "grid":
        depth = args.depth if args.depth is not None else 4
        sdf = UniformGridSdf(mesh, box, depth=depth if args.cell_size is None else None,
                             cell_size=args.cell_size, device=device)
    elif args.sdf_format == "exact_octree":
        depth = args.depth if args.depth is not None else 7
        sdf = ExactOctreeSdf(
            mesh, box, max_depth=depth,
            start_depth=args.start_depth if args.start_depth is not None else 2,
            min_triangles_per_node=args.min_triangles_per_node,
            strategy=args.strategy or "lattice",
            futility=args.futility if args.futility >= 0 else None,
            device=device,
        )
    else:
        depth = args.depth if args.depth is not None else 7
        sdf = OctreeSdf(
            mesh, box, max_depth=depth,
            start_depth=args.start_depth if args.start_depth is not None else 2,
            termination_threshold=args.termination_threshold,
            termination_rule=rule,
            error_decay=args.termination_threshold_by_distance,
            init_algorithm=args.algorithm,
            interpolation=args.interpolation,
            strategy=args.strategy or "distance",
            device=device,
        )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    print(f"Build time: {build_s:.3f}s")

    if args.output_path.endswith(".bin"):
        from ..io.sdflib_binary import save_sdflib_bin

        save_sdflib_bin(sdf, args.output_path)
    else:
        sdf.save(args.output_path)
    print(f"Saved {args.sdf_format} to {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
