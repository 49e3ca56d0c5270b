"""sdflib_tpu_torch: the exact and approximate octrees, the uniform grid,
the renderer, the differentiable queries and the reference's .bin
formats of sdflib_tpu in PyTorch, with hand-written CUDA kernels for an
NVIDIA Hopper GPU.

Imports torch and numpy only, never JAX: the JAX package ``sdflib_tpu``
is the reference this package is held against, in tests that import both.
"""
from .mesh import BoundingBox, Mesh, load_mesh
from .sdf.exact_octree import ExactOctreeSdf
from .sdf.grid import UniformGridSdf
from .sdf.octree import OctreeSdf
from .sdf.real import RealSdf
from .sdf.sdf_function import SdfFormat, SdfFunction
from .triangle import TriangleDataSoA, calculate_mesh_triangle_data, soa_to_torch

__all__ = [
    "BoundingBox",
    "Mesh",
    "load_mesh",
    "TriangleDataSoA",
    "calculate_mesh_triangle_data",
    "soa_to_torch",
    "SdfFunction",
    "SdfFormat",
    "ExactOctreeSdf",
    "OctreeSdf",
    "RealSdf",
    "UniformGridSdf",
]
