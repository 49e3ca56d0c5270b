"""sdf-view: plane-cut inspection images + node picking for octree SDFs.

Port of the JAX package's ``tools/sdf_view.py`` (offline parity with the
reference SdfViewer, src/tools/SdfViewer/main.cpp:35-1278): renders the
plane-cut distance visualization (7-color palette, isolines, node-grid
overlay, sdfOctreePlane.frag semantics) to PNG, optionally sweeping the
plane along an axis, plus RMSE/MAE of the octree vs brute force inside
the view (the in-GUI metric at SdfViewer/main.cpp:699-700).

--pick x,y,z replaces the GUI's node selection: prints the picked leaf's
depth/box, its triangle list (exact octrees) or coefficients (approximate
octrees), and, with --error_vs, RMSE/MAE vs brute force sampled INSIDE
the picked cell. --pick_region exports the picked leaf's influence set as
an OBJ submesh plus the cell box (InfluenceRegionCreator.h:64-126 role).
"""
from __future__ import annotations

import argparse

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sdf-view")
    p.add_argument("sdf_path")
    p.add_argument("output_path", nargs="?", default=None,
                   help="Output .png (or prefix for sweeps); optional "
                        "when only --pick inspection is requested")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--axis", type=int, default=2, choices=[0, 1, 2],
                   help="Plane normal axis")
    p.add_argument("--offset", type=float, default=0.5,
                   help="Plane position in [0,1] along the axis")
    p.add_argument("--sweep", type=int, default=0,
                   help="Render N planes sweeping the axis")
    p.add_argument("--no_grid", action="store_true")
    p.add_argument("--no_isolines", action="store_true")
    p.add_argument("--error_vs", default=None,
                   help="Mesh file: print RMSE/MAE of the octree vs brute "
                        "force on the rendered plane / picked cell")
    p.add_argument("--pick", default=None, metavar="X,Y,Z",
                   help="World-space point: print the containing leaf's "
                        "depth, box, and triangle list / coefficients")
    p.add_argument("--pick_region", default=None, metavar="OUT.OBJ",
                   help="With --pick on an exact octree: write the picked "
                        "leaf's influence triangles + cell box as OBJ")
    p.add_argument("--pick_samples", type=int, default=4096,
                   help="Samples for the picked-cell RMSE/MAE")
    add_device_arg(p)
    return p


def _descend_host(sdf, point):
    """Host-side octree walk to the leaf containing `point`, over the
    structure's uint32 host words. Returns (leaf_word, depth, cell_min,
    cell_size) using the structure's child rounding (OctreeSdf >=0.5,
    OctreeSdf.cpp:88-91; ExactOctreeSdf >0.5, ExactOctreeSdf.cpp:33-36)."""
    from ..sdf.exact_octree import ExactOctreeSdf
    from ..sdf.octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK

    data = np.asarray(sdf.octree_data, np.uint32)
    s = sdf.start_grid_size
    box_min = np.asarray(sdf.box.min, np.float64)
    box_size = float(sdf.box.size[0])
    cell = box_size / s
    frac = (np.asarray(point, np.float64) - box_min) / cell
    ipos = np.floor(frac).astype(int)
    if np.any(ipos < 0) or np.any(ipos >= s):
        raise SystemExit(f"pick point {point} is outside the octree box")
    frac -= ipos
    strict = isinstance(sdf, ExactOctreeSdf)
    idx = (ipos[2] * s + ipos[1]) * s + ipos[0]
    word = data[idx]
    depth = int(np.log2(s))
    cmin = box_min + ipos * cell
    csize = cell
    while not (word & IS_LEAF_MASK):
        child = np.where(frac > 0.5, 1, 0) if strict else np.where(
            frac >= 0.5, 1, 0
        )
        word = data[(word & CHILDREN_INDEX_MASK) + (
            (child[2] << 2) | (child[1] << 1) | child[0]
        )]
        cmin = cmin + child * 0.5 * csize
        csize *= 0.5
        frac = 2.0 * frac - child
        depth += 1
    return word, depth, cmin, csize


def _print_pick(sdf, point, args, device):
    from ..mesh import load_mesh
    from ..sdf.exact_octree import ExactOctreeSdf
    from ..sdf.octree import OctreeSdf
    from ..sdf.octree_builder import CHILDREN_INDEX_MASK
    from ..sdf.real import RealSdf

    word, depth, cmin, csize = _descend_host(sdf, point)
    print(f"Picked leaf: depth={depth} box_min={cmin.tolist()} "
          f"size={csize:.6g}")

    if isinstance(sdf, ExactOctreeSdf):
        leaf_id = int(word & CHILDREN_INDEX_MASK)
        off = int(np.asarray(sdf.leaf_offset)[leaf_id])
        cnt = int(np.asarray(sdf.leaf_count)[leaf_id])
        tris = sdf.tri_flat[off : off + cnt].cpu().numpy()
        print(f"Leaf {leaf_id}: {cnt} influence triangles "
              f"(sorted by distance to cell center):")
        print(" ".join(str(int(t)) for t in tris))
        if args.pick_region:
            vw = sdf.triangles.v_world.cpu().numpy()[tris]  # (n, 3, 3)
            with open(args.pick_region, "w") as f:
                f.write("# influence region of picked leaf\n")
                for tv in vw:
                    for v in tv:
                        f.write(f"v {v[0]} {v[1]} {v[2]}\n")
                for i in range(len(vw)):
                    f.write(f"f {3*i+1} {3*i+2} {3*i+3}\n")
                # cell box as line segments
                base = 3 * len(vw)
                corners = [
                    cmin + csize * np.array([x, y, z])
                    for z in (0, 1) for y in (0, 1) for x in (0, 1)
                ]
                for c in corners:
                    f.write(f"v {c[0]} {c[1]} {c[2]}\n")
                edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3),
                         (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
                for a, b in edges:
                    f.write(f"l {base+a+1} {base+b+1}\n")
            print(f"Wrote influence region to {args.pick_region}")
    elif isinstance(sdf, OctreeSdf):
        cidx = int(word & CHILDREN_INDEX_MASK)
        coeffs = np.asarray(sdf.octree_data, np.uint32)[
            cidx : cidx + sdf.num_coefficients
        ].view(np.float32)
        print(f"Leaf coefficients [{sdf.interpolation}] "
              f"(index {cidx}): {coeffs.tolist()}")

    if args.error_vs is not None:
        real = RealSdf(load_mesh(args.error_vs), device=device)
        rng = np.random.default_rng(0)
        pts = (
            cmin + rng.uniform(0, 1, (args.pick_samples, 3)) * csize
        ).astype(np.float32)
        diff = (sdf.get_distance(pts).cpu().numpy()
                - real.get_distance(pts).cpu().numpy())
        print(f"Picked-cell RMSE: {float(np.sqrt(np.mean(diff ** 2)))}")
        print(f"Picked-cell MAE: {float(np.mean(np.abs(diff)))}")
        print(f"Picked-cell max|err|: {float(np.max(np.abs(diff)))}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .common import load_sdf
    from ..mesh import load_mesh
    from ..render import render_plane_cut, write_png
    from ..sdf.octree import OctreeSdf
    from ..sdf.real import RealSdf
    from ..sdf.sdf_function import resolve_device

    device = resolve_device(args.device)
    sdf = load_sdf(args.sdf_path, device)

    if args.pick is not None:
        point = [float(v) for v in args.pick.split(",")]
        _print_pick(sdf, point, args, device)
        if args.output_path is None:
            return 0

    if not isinstance(sdf, OctreeSdf):
        raise SystemExit(
            "plane-cut rendering requires an approximate octree container"
        )
    if args.output_path is None:
        raise SystemExit("output_path required unless only --pick is used")

    offsets = (
        [(i + 0.5) / args.sweep for i in range(args.sweep)]
        if args.sweep else [args.offset]
    )
    for i, off in enumerate(offsets):
        img = render_plane_cut(
            sdf, resolution=args.resolution, axis=args.axis, offset=off,
            print_grid=not args.no_grid, print_isolines=not args.no_isolines,
        )
        path = (args.output_path if len(offsets) == 1
                else args.output_path.replace(".png", f"_{i:03d}.png"))
        write_png(path, img)
        print(f"Wrote {path} (axis={args.axis}, offset={off:.3f})")

    if args.error_vs is not None:
        mesh = load_mesh(args.error_vs)
        real = RealSdf(mesh, device=device)
        rng = np.random.default_rng(0)
        u = rng.uniform(0, 1, (args.resolution**2 // 4, 3)).astype(np.float32)
        u[:, args.axis] = args.offset
        pts = (sdf.box.min + u * sdf.box.size).astype(np.float32)
        d_o = sdf.get_distance(pts).cpu().numpy()
        d_r = real.get_distance(pts).cpu().numpy()
        diff = d_o - d_r
        print(f"Plane RMSE: {float(np.sqrt(np.mean(diff**2)))}")
        print(f"Plane MAE: {float(np.mean(np.abs(diff)))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
