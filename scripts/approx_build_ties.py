"""Where the PyTorch port's approximate build parts from the JAX
package's at bench.py's configuration, and why.

Builds the no_continuity octree of ``make_torus(R=0.3, r=0.12, nu=96,
nv=48)`` (box margin 0.14, ``max_depth=6, start_depth=2``,
bench.py:117-149) with the JAX package on the CPU, records every level
chunk's inputs, and replays each through the port's ``_level_chunk`` on
the CPU. Per chunk it prints the nodes whose termination test differs
(the port's decisions on JAX's inputs), the candidate-cull differences,
and the midpoints whose winning triangle's gradient differs by more than
1e-3 between the packages: exact nearest-triangle ties on the torus's
symmetry planes, where each package's last ulp picks one of two mirror
triangles. Then both packages' own builds, leaves per depth and words.
Takes about a minute:

    python scripts/approx_build_ties.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sdflib_tpu.sdf.octree_builder as JB  # noqa: E402
import sdflib_tpu_torch.sdf.octree_builder as PB  # noqa: E402
from sdflib_tpu.triangle import calculate_mesh_triangle_data as j_tri_data  # noqa: E402
from sdflib_tpu.utils.primitives import make_torus as j_torus  # noqa: E402
from sdflib_tpu_torch.ops.point_triangle import pack_triangle_fields  # noqa: E402
from sdflib_tpu_torch.triangle import calculate_mesh_triangle_data, soa_to_torch  # noqa: E402
from sdflib_tpu_torch.utils.primitives import make_torus  # noqa: E402

TORUS = dict(R=0.3, r=0.12, nu=96, nv=48)


def main() -> None:
    box = j_torus(**TORUS).bounding_box.add_margin(0.14).cubified()
    chunks = []
    jax_chunk = JB._level_chunk

    def record(*args, **kw):
        out = jax_chunk(*args, **kw)
        chunks.append(([np.asarray(a) for a in args[1:6]], [np.asarray(o) for o in out]))
        return out

    JB._level_chunk = record
    j = JB.build_octree(j_tri_data(j_torus(**TORUS)), box.min, float(box.size[0]), 6, 2)
    JB._level_chunk = jax_chunk

    tris = soa_to_torch(calculate_mesh_triangle_data(make_torus(**TORUS)), "cpu")
    packed_t = pack_triangle_fields(tris).t().contiguous()
    sq_thr = np.float32(1e-3) ** 2
    for (centers, corners, cand, valid, half), (jm, _, je, jk, _) in chunks:
        pm, _, pe, pk, _ = (t.numpy() for t in PB._level_chunk(
            tris, packed_t, *(torch.as_tensor(a.copy()) for a in (centers, corners, cand, valid)),
            np.float32(half), 0.0, rule="trapezoid", interpolation="tricubic"))
        mirror = np.abs(jm[..., 1:4] - pm[..., 1:4]).max(-1) > 1e-3
        print(f"chunk: half {float(half):.6f}, {centers.shape[0]} nodes x {cand.shape[1]} "
              f"candidates: termination flips {int(((je < sq_thr) != (pe < sq_thr)).sum())}, "
              f"cull differences {int((jk[:, :pk.shape[1]] != pk).sum())}, midpoints "
              f"with another winner's gradient {int(mirror.sum())} of {mirror.size}, "
              f"max |distance| difference {float(np.abs(jm[..., 0] - pm[..., 0]).max()):.3e}")
    p = PB.build_octree(tris, box.min, float(box.size[0]), 6, 2)
    for name, b in (("JAX", j), ("port", p)):
        print(f"{name} build: leaves per depth {b.stats['leaves_per_depth']}, "
              f"words {b.octree_u32.shape[0]}")


if __name__ == "__main__":
    main()
