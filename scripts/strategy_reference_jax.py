"""The JAX package's exact octrees under each cull strategy, and its
approximate octree under the lattice cull, at bench.py's configuration:
the reference counts ``chip_smoke.py``'s path G holds the PyTorch port to.

Builds ``make_torus(R=0.3, r=0.12, nu=96, nv=48)`` in its box with a 0.14
margin on the CPU:

* ``ExactOctreeSdf(max_depth=D, start_depth=2, min_triangles_per_node=32,
  strategy=s)`` for s in region, lattice, basic, precise and per_vertex,
  at D = 6 and, for precise and per_vertex, at D = 5 too (the depth the
  smoke cuts them to when a d6 build is too slow on the card); one JSON
  line each: leaves, the mean and max list length, build seconds (CPU);
* ``OctreeSdf(max_depth=6, start_depth=2, termination_threshold=1e-3,
  init_algorithm="no_continuity", strategy="lattice")``: octree words
  and leaves per depth.

The counts do not depend on the hardware; the seconds are this CPU's.
Slow (the precise cull runs 15 Frank-Wolfe steps over 16 regions per
candidate pair): pass strategy names to build only those, e.g.

    python scripts/strategy_reference_jax.py lattice basic approx_lattice
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf  # noqa: E402
from sdflib_tpu.sdf.octree import OctreeSdf  # noqa: E402
from sdflib_tpu.utils.primitives import make_torus  # noqa: E402

ALL = ("region", "lattice", "basic", "precise", "per_vertex", "approx_lattice")


def main() -> None:
    which = sys.argv[1:] or ALL
    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    for name in which:
        if name == "approx_lattice":
            t0 = time.perf_counter()
            sdf = OctreeSdf(mesh, box, max_depth=6, start_depth=2,
                            termination_threshold=1e-3, init_algorithm="no_continuity",
                            strategy="lattice")
            st = sdf.build_stats
            print(json.dumps(dict(
                build="approx no_continuity d6", strategy="lattice",
                words=int(sdf.octree_data.shape[0]),
                leaves={int(k): int(v) for k, v in sorted(st["leaves_per_depth"].items())},
                build_s=time.perf_counter() - t0,
            )), flush=True)
            continue
        depths = (6, 5) if name in ("precise", "per_vertex") else (6,)
        for depth in depths:
            t0 = time.perf_counter()
            sdf = ExactOctreeSdf(mesh, box, max_depth=depth, start_depth=2,
                                 min_triangles_per_node=32, strategy=name)
            cnt = np.asarray(sdf.leaf_count)
            print(json.dumps(dict(
                build=f"exact d{depth}", strategy=name, leaves=int(cnt.shape[0]),
                mean_list=float(cnt.mean()), max_list=int(cnt.max()),
                build_s=time.perf_counter() - t0,
            )), flush=True)


if __name__ == "__main__":
    main()
