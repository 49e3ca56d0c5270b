"""Brute-force exact SDF over all triangles: the ground-truth oracle.

Port of the JAX package's ``sdf/real.py`` (reference src/sdf/
RealSdf.cpp:10-31). Distance and gradient take the nearest triangle from
``ops.nearest`` (kernel K2 on a CUDA device) and evaluate the winner's
signed distance and analytic gradient.
"""
from __future__ import annotations

import torch

from ..mesh import BoundingBox, Mesh
from ..ops.point_triangle import (
    pack_triangle_fields,
    signed_distance_batch,
    signed_distance_grad_batch,
)
from ..triangle import calculate_mesh_triangle_data, soa_to_torch
from .sdf_function import SdfFormat, SdfFunction, resolve_device

__all__ = ["RealSdf"]


class RealSdf(SdfFunction):
    """Exact signed distance via brute force over every triangle."""

    def __init__(self, mesh: Mesh, device="cuda"):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.triangles = soa_to_torch(calculate_mesh_triangle_data(mesh), self.device)
        self.fields = pack_triangle_fields(self.triangles)

    def _points(self, points):
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        return pts, pts.reshape(-1, 3)

    def get_distance(self, points):
        pts, flat = self._points(points)
        d = signed_distance_batch(flat, self.triangles, self.fields)
        return d.reshape(pts.shape[:-1])

    def get_distance_and_gradient(self, points):
        pts, flat = self._points(points)
        d, g = signed_distance_grad_batch(flat, self.triangles, self.fields)
        return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)

    def get_sample_area(self) -> BoundingBox:
        return self.mesh.bounding_box

    def get_format(self) -> SdfFormat:
        return SdfFormat.NONE
