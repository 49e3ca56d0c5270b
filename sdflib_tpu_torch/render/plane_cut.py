"""Plane-cut visualization of an octree SDF (SdfViewer parity).

Port of the JAX package's ``render/plane_cut.py`` (reference:
src/render_engine/shaders/sdfOctreePlane.frag:1-181): a plane through the
domain is sampled per pixel; color = 7-color distance palette normalized
by octreeValueRange, with isosurface line, isolines, and octree node-grid
overlay blended in black. Screen-space derivatives (dFdx/dFdy) become
finite differences between adjacent pixels. The distance and the node
walk run on the octree's device; the image post-processing is numpy, as
in the JAX module.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sdf.octree_builder import CHILDREN_INDEX_MASK

__all__ = ["render_plane_cut", "PALETTE7"]

_CIDX = int(CHILDREN_INDEX_MASK)

# sdfOctreePlane.frag:34-43
PALETTE7 = np.asarray(
    [
        [0.0, 0.0, 1.0],
        [0.0, 0.5, 1.0],
        [0.0, 1.0, 1.0],
        [1.0, 1.0, 1.0],
        [1.0, 1.0, 0.0],
        [1.0, 0.5, 0.0],
        [1.0, 0.0, 0.0],
    ],
    np.float32,
)


def _np(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _octree_node_metrics(octree, points):
    """distToGrid and nodeRelativeLength per point
    (sdfOctreePlane.frag:110-133): descend to the leaf, return the distance
    of the in-leaf frac coords to the leaf faces and the leaf's relative
    size. The walk reads the port's int32 words on the octree's device:
    the leaf bit is the sign, the child base ``word & CHILDREN_INDEX_MASK``,
    one word at a time (any layout)."""
    data = octree._octree_dev
    s = octree.start_grid_size
    box_min = octree._box_min
    cell = octree._box_size3[0] / s

    pts = torch.as_tensor(points, dtype=torch.float32, device=data.device)
    frac = (pts - box_min) / cell
    ipos = frac.floor().to(torch.int32).clamp(0, s - 1).long()
    frac = frac - frac.floor()
    word = data[ipos[..., 2] * (s * s) + ipos[..., 1] * s + ipos[..., 0]]
    rel_len = torch.ones(pts.shape[:-1], dtype=torch.float32, device=data.device)

    for _ in range(octree.max_depth - octree.start_depth):
        is_leaf = word < 0
        child = (
            ((frac[..., 2] >= 0.5).long() << 2)
            + ((frac[..., 1] >= 0.5).long() << 1)
            + (frac[..., 0] >= 0.5).long()
        )
        nxt = data[(word & _CIDX).long() + child]
        nfrac = 2.0 * frac
        nfrac = nfrac - nfrac.floor()
        word = torch.where(is_leaf, word, nxt)
        frac = torch.where(is_leaf[..., None], frac, nfrac)
        rel_len = torch.where(is_leaf, rel_len, rel_len * 0.5)

    dist_axis = 0.5 - (frac - 0.5).abs()
    return dist_axis, rel_len


def render_plane_cut(
    octree,
    resolution: int = 512,
    *,
    axis: int = 2,
    offset: float = 0.5,
    print_grid: bool = True,
    print_isolines: bool = True,
    surface_thickness: float = 3.5,
    grid_thickness: float = 0.01,
    lines_thickness: float = 2.5,
    lines_space: float = 0.03,
) -> np.ndarray:
    """Render an axis-aligned plane cut to an (R, R, 3) float image.

    ``axis`` is the plane normal axis; ``offset`` in [0,1] positions the
    plane inside the box. Defaults mirror the shader uniforms
    (sdfOctreePlane.frag:20-31).
    """
    u = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    gu, gv = np.meshgrid(u, u, indexing="xy")
    coords = [None, None, None]
    axes2d = [a for a in range(3) if a != axis]
    coords[axes2d[0]] = gu
    coords[axes2d[1]] = gv
    coords[axis] = np.full_like(gu, offset)
    unit = np.stack(coords, axis=-1)  # (R, R, 3) in [0,1]^3
    pts = octree.box.min + unit * octree.box.size[None, None]

    d = _np(octree.get_distance(pts))

    # Screen-space derivative dDist ~ |d/dx, d/dy| via pixel differences
    # (stands in for dFdx/dFdy; clamped like the shader :152).
    ddx = np.diff(d, axis=1, append=d[:, -1:])
    ddy = np.diff(d, axis=0, append=d[-1:, :])
    ddist = np.maximum(np.hypot(ddx, ddy), 0.0008)

    # Isosurface band (:155); thickness <= 0 disables it (the |d|/0 -> inf
    # route produced the right pixels but a divide RuntimeWarning).
    if surface_thickness > 0.0:
        surface_w = np.clip(
            1.0 - (np.abs(d) / (ddist * surface_thickness)) ** 8, 0, 1
        )
    else:
        surface_w = np.zeros_like(d)

    # Node grid overlay (:158): distToGrid masked by the plane normal axis
    dist_axis, rel_len = _octree_node_metrics(octree, pts.reshape(-1, 3))
    dist_axis = _np(dist_axis).reshape(resolution, resolution, 3)
    rel_len = _np(rel_len).reshape(resolution, resolution)
    dist_to_grid = np.min(
        np.stack([dist_axis[..., a] for a in axes2d], axis=-1), axis=-1
    )
    grid_w = (
        float(print_grid)
        * np.clip(1.0 - (dist_to_grid * rel_len / grid_thickness) ** 8, 0, 1)
    )

    # Isolines (:161-163)
    dist_to_level = 0.5 - np.abs(np.modf(np.abs(d) / lines_space)[0] - 0.5)
    dd_level = ddist / lines_space
    lines_w = (
        float(print_isolines)
        * 0.5
        * np.clip(1.0 - (dist_to_level / (dd_level * lines_thickness)) ** 8, 0, 1)
    )

    # 7-color heat map (:166-169)
    value_range = max(octree.value_range, 1e-8)
    t = 0.5 + 0.5 * d / value_range
    idx = np.clip(t * 6.0, 0.0, 6.0 - 0.01)
    i0 = idx.astype(np.int64)
    fr = (idx - i0)[..., None]
    color = PALETTE7[i0] * (1.0 - fr) + PALETTE7[np.minimum(i0 + 1, 6)] * fr

    dark = np.maximum(np.maximum(surface_w, grid_w), lines_w)[..., None]
    return (color * (1.0 - dark)).astype(np.float32)
