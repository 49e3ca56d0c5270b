"""The JAX package's approximate octrees at bench.py's configuration, as
the reference numbers ``chip_smoke.py`` holds the PyTorch port to.

Builds ``make_torus(R=0.3, r=0.12, nu=96, nv=48)`` in its box with a 0.14
margin, ``max_depth=6, start_depth=2, termination_threshold=1e-3``
(bench.py:117-149), once per builder ("no_continuity", "continuity"), on
the CPU, and prints one JSON line per builder: octree words, leaves and
nodes per depth, ``value_range``, ``min_border_value``, the continuity
builder's re-opened leaves and clamped midpoints, and the rms, 95th
percentile and max of |octree - RealSdf| on 10k uniform points (seed 7)
through the walk and through the query grid. The numbers do not depend
on the hardware. Takes about a minute:

    python scripts/approx_reference_jax.py
"""
from __future__ import annotations

import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from sdflib_tpu.sdf.octree import OctreeSdf  # noqa: E402
from sdflib_tpu.sdf.real import RealSdf  # noqa: E402
from sdflib_tpu.utils.primitives import make_torus  # noqa: E402


def _errors(sdf, pts, d_ref) -> dict:
    err = np.abs(np.asarray(sdf.get_distance(pts)) - d_ref)
    return dict(rms=float(np.sqrt(np.mean(err**2))), q95=float(np.quantile(err, 0.95)),
                max=float(err.max()))


def main() -> None:
    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    lo, hi = np.asarray(box.min) + 1e-4, np.asarray(box.max) - 1e-4
    pts = np.random.default_rng(7).uniform(lo, hi, (10_000, 3)).astype(np.float32)
    d_ref = np.asarray(RealSdf(mesh).get_distance(pts))
    for alg in ("no_continuity", "continuity"):
        sdf = OctreeSdf(mesh, box, max_depth=6, start_depth=2, termination_threshold=1e-3,
                        init_algorithm=alg)
        grid = copy.copy(sdf)
        grid.build_query_grid()
        st = sdf.build_stats
        print(json.dumps(dict(
            init_algorithm=alg,
            words=int(sdf.octree_data.shape[0]),
            leaves={int(k): int(v) for k, v in sorted(st["leaves_per_depth"].items())},
            nodes={int(k): int(v) for k, v in sorted(st["nodes_per_depth"].items())},
            value_range=sdf.value_range,
            min_border_value=sdf.min_border_value,
            resubdivided=st.get("resubdivided"),
            midpoints_clamped=st.get("midpoints_clamped"),
            walk=_errors(sdf, pts, d_ref),
            grid=_errors(grid, pts, d_ref),
        )), flush=True)


if __name__ == "__main__":
    main()
