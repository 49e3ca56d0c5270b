"""Dense uniform grid SDF with trilinear queries.

Port of the JAX package's ``sdf/grid.py`` (reference: include/SdfLib/
UniformGridSdf.h:15-74, src/sdf/UniformGridSdf.cpp:9-118). The layout is
the reference's: ``grid_size`` corner samples per axis spaced
``cell_size`` apart from ``box.min`` (the sampled extent is
(grid_size - 1) * cell_size, UniformGridSdf.cpp:19-20), stored z-major as
a (nz, ny, nx) float32 tensor on the structure's device.

BASIC init evaluates the exact SDF at every corner through
``signed_distance_batch`` (kernel K2 on a CUDA device); OCTREE init
queries the corners through a shallow ``ExactOctreeSdf`` (kernel K1).
Both give the same exact values. The gradient is the analytic trilinear
gradient (the reference's is a TODO stub, UniformGridSdf.cpp:115-118).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mesh import BoundingBox, Mesh
from ..ops.interpolation import trilinear_gradient, trilinear_interpolate
from ..ops.point_triangle import pack_triangle_fields, signed_distance_batch
from ..triangle import calculate_mesh_triangle_data, soa_to_torch
from .sdf_function import SdfFormat, SdfFunction, resolve_device

__all__ = ["UniformGridSdf"]

# Corners a K2 sweep takes at once: bounds the winners' gathered triangle
# rows (~0.3 GB at 2^21 corners) while a depth-7 grid stays one sweep.
_CORNER_BATCH = 1 << 21


def _build_grid_values(mesh: Mesh, points: torch.Tensor, batch: int = _CORNER_BATCH):
    """Exact SDF at (P, 3) corner points on their device, ``batch``
    corners a sweep."""
    tris = soa_to_torch(calculate_mesh_triangle_data(mesh), points.device)
    fields = pack_triangle_fields(tris)
    return torch.cat([signed_distance_batch(points[i : i + batch], tris, fields)
                      for i in range(0, points.shape[0], batch)])


class UniformGridSdf(SdfFunction):
    """Dense grid of exact corner distances with trilinear queries.

    ``depth`` gives 2^depth corners per axis over the box's largest side;
    ``cell_size`` instead gives ceil(size / cell_size) + 1 per axis.
    ``init_algorithm`` "basic" (brute force over every triangle) or
    "octree" (through a shallow exact octree). ``device`` holds the grid
    and runs the init and the queries; query points may come as numpy
    arrays or tensors, results are tensors on ``device``."""

    def __init__(
        self,
        mesh: Mesh,
        box: BoundingBox,
        depth: int | None = None,
        cell_size: float | None = None,
        init_algorithm: str = "basic",
        *,
        device="cuda",
    ):
        if init_algorithm not in ("basic", "octree"):
            raise ValueError(f"unknown init_algorithm {init_algorithm!r}")
        self.device = resolve_device(device)
        if depth is not None:
            gs = 1 << depth
            self.cell_size = float(np.max(box.size)) / gs
            self.grid_size = (gs, gs, gs)
        else:
            if cell_size is None:
                raise ValueError("give depth or cell_size")
            self.cell_size = float(cell_size)
            self.grid_size = tuple(int(x) for x in np.ceil(box.size / cell_size).astype(int) + 1)

        # sampled extent = (grid_size - 1) * cell_size from box.min
        gmin = np.asarray(box.min, np.float32)
        gmax = gmin + self.cell_size * (np.asarray(self.grid_size, np.float32) - 1)
        self.box = BoundingBox(gmin, gmax)

        nx, ny, nz = self.grid_size
        xs = gmin[0] + self.cell_size * np.arange(nx, dtype=np.float32)
        ys = gmin[1] + self.cell_size * np.arange(ny, dtype=np.float32)
        zs = gmin[2] + self.cell_size * np.arange(nz, dtype=np.float32)
        # reference storage: index = z * XY + y * X + x (z-major)
        gz, gy, gx = np.meshgrid(zs, ys, xs, indexing="ij")
        pts = torch.as_tensor(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3),
                              device=self.device)

        if init_algorithm == "octree":
            # Corners evaluate through a shallow exact octree's culled leaf
            # lists instead of all triangles (UniformGridSdfOctree.cpp:
            # 42-226). A half-cell margin keeps every corner strictly
            # inside the (cubified) octree domain, off its box fallback.
            from .exact_octree import ExactOctreeSdf

            acc_depth = max(3, min(6, int(np.log2(max(self.grid_size)))))
            acc = ExactOctreeSdf(
                mesh,
                self.box.add_margin(0.5 * self.cell_size),
                max_depth=acc_depth,
                start_depth=min(2, acc_depth - 1),
                min_triangles_per_node=64,
                device=self.device,
            )
            values = acc.get_distance(pts)
        else:
            values = _build_grid_values(mesh, pts)
        self.grid = values.reshape(nz, ny, nx).to(torch.float32)

    @classmethod
    def from_jax_state(cls, state: dict, device="cuda") -> "UniformGridSdf":
        """The grid held by a state dict of the JAX package's
        ``UniformGridSdf._state_arrays()`` (the ``.npz`` container's
        arrays), on ``device``."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.box = BoundingBox(state["box_min"], state["box_max"])
        self.grid_size = tuple(int(x) for x in state["grid_size"])
        self.grid = torch.tensor(np.asarray(state["grid"], np.float32),
                                 device=self.device).reshape(self.grid_size[::-1])
        self.cell_size = float(self.box.size[0]) / float(self.grid_size[0] - 1)
        return self

    # -- queries -------------------------------------------------------------

    def _gather_corners(self, points):
        """The 8 corner values (corner order x + 2y + 4z) of each point's
        cell and its frac, from one gather. Out-of-domain points read the
        border cells (the reference has UB there) with frac unclamped."""
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        frac = (pts - torch.as_tensor(self.box.min, device=self.device)) / self.cell_size
        ipos = frac.floor().to(torch.int32)
        frac = frac - ipos
        nx, ny, nz = self.grid_size
        ix = ipos[..., 0].clamp(0, nx - 2).long()
        iy = ipos[..., 1].clamp(0, ny - 2).long()
        iz = ipos[..., 2].clamp(0, nz - 2).long()
        plane = ny * nx
        offs = torch.tensor([0, 1, nx, nx + 1, plane, plane + 1, plane + nx, plane + nx + 1],
                            device=self.device)
        base = (iz * ny + iy) * nx + ix
        return self.grid.reshape(-1)[base[..., None] + offs], frac

    def get_distance(self, points):
        corners, frac = self._gather_corners(points)
        return trilinear_interpolate(corners, frac)

    def get_distance_and_gradient(self, points):
        corners, frac = self._gather_corners(points)
        d = trilinear_interpolate(corners, frac)
        g = trilinear_gradient(corners, frac) / self.cell_size
        return d, g

    def get_sample_area(self) -> BoundingBox:
        return self.box

    def get_format(self) -> SdfFormat:
        return SdfFormat.GRID

    # -- serialization -------------------------------------------------------

    def _state_arrays(self) -> dict:
        """The arrays of the JAX package's container schema."""
        return {
            "box_min": np.asarray(self.box.min, np.float32),
            "box_max": np.asarray(self.box.max, np.float32),
            "grid_size": np.asarray(self.grid_size, np.int32),
            "grid": self.grid.cpu().numpy(),
        }
