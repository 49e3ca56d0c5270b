"""Rendering: sphere tracing, shading, plane cuts and PNG output."""
from .camera import Camera  # noqa: F401
from .sphere_trace import TraceResult, sphere_trace, trace_octree  # noqa: F401
from .shading import (  # noqa: F401
    ambient_occlusion,
    iteration_heatmap,
    normal_color,
    shade_lambert,
    soft_shadow,
)
from .plane_cut import render_plane_cut  # noqa: F401
from .image import to_u8, write_png  # noqa: F401
