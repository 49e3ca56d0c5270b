"""K4: the approximate octree's dense-grid query, a group of lanes a point.

``grid_query`` launches ``csrc/octree_query.cu`` for CUDA tensors and
takes ``grid_query_plain``, the torch version, for CPU tensors. Both
compute the JAX package's ``_octree_query_grid`` over the thin leaf grid
(sdflib_tpu/sdf/octree.py:183) and ``_octree_query_fat`` over the fused
rows (:325): the point's finest cell on the 2^d grid, the leaf row of
that cell, the position in the leaf at the leaf's depth, the tricubic or
trilinear polynomial there (and its normalized gradient) inside the box,
the box distance plus ``min_border_value`` (and the reference's box
gradient) outside it. A ``LeafGrid`` names the rows and what they mean.
``launch_count`` counts kernel launches.

The leaf evaluation of the kernel, ``csrc/leaf_eval.cuh``, is also the
march's inner step (``ops/march.py``). The torch helpers here (``_finish``,
``_coeff_rows``, ``_grid_cells``, ``_leaf_frac``) serve the walk of
``sdf/octree.py`` and the tiles of ``parallel/tiles.py`` as well.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build
from .box import box_distance, box_distance_gradient
from .interpolation import gradient_at, interpolate_at

__all__ = ["LeafGrid", "grid_query", "grid_query_plain", "launch_count"]

_CIDX = 0x3FFFFFFF   # CHILDREN_INDEX_MASK: the 30-bit child/coefficient index
launch_count = 0
# Lanes that read a point's coefficient row in K4, without and with the
# gradient, chosen by measurement on an H100 (chip_smoke.k4_vs_plain times
# each of GROUPS; PERF.md section 6).
GROUP = {False: 8, True: 4}
GROUPS = (1, 4, 8)


class LeafGrid(NamedTuple):
    """The dense leaf grid a query or a march step reads."""
    rows: torch.Tensor        # (8^depth, width) int32, z-major finest cells
    fat: bool                 # fused rows: [word, depth | flags, coefficients...]
    words: torch.Tensor | None  # (W,) int32 octree words (the thin grid's coefficients)
    box_min: torch.Tensor     # (3,) float32
    box_size3: torch.Tensor   # (3,) float32
    min_border: float         # min_border_value
    depth: int                # max depth: 2^depth cells an axis
    num_coeff: int            # 64 tricubic, 8 trilinear
    interpolation: str


def _finish(pts, coeffs, frac, in_box, box_min, box_size3, min_border_value,
            interpolation, with_gradient):
    """Leaf polynomial inside the box, box distance + ``min_border_value``
    outside; the gradient normalized (OctreeSdf.cpp:150)."""
    d_in = interpolate_at(coeffs, frac, interpolation)
    center = box_min + 0.5 * box_size3
    if with_gradient:
        g_in = gradient_at(coeffs, frac, interpolation)
        norm = (g_in * g_in).sum(-1, keepdim=True).sqrt()
        g_in = g_in / norm.clamp_min(1e-30)
        d_out, g_out = box_distance_gradient(pts, center, box_size3)
        return (
            torch.where(in_box, d_in, d_out + min_border_value),
            torch.where(in_box[..., None], g_in, g_out),
        )
    d_out = box_distance(pts, center, box_size3)
    return torch.where(in_box, d_in, d_out + min_border_value)


def _coeff_rows(octree_i32, word, num_coeff, coeffs_f32=None):
    """The coefficients of leaf words, one aligned row each, read from
    ``coeffs_f32`` (a flat float32 tensor of the octree's length) or by
    default from the float32 view of the words."""
    base = (word & _CIDX).long()
    flat = octree_i32.view(torch.float32) if coeffs_f32 is None else coeffs_f32
    return flat.view(-1, num_coeff)[base // num_coeff]


def _grid_cells(pts, box_min, box_size3, grid_depth):
    """(rel, in_box, linear cell index) of points on the 2^d grid."""
    g = 1 << grid_depth
    rel = (pts - box_min) / box_size3          # [0, 1) inside the box
    in_box = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
    cell = (rel * g).to(torch.int32).clamp(0, g - 1).long()
    lin = (cell[..., 2] * g + cell[..., 1]) * g + cell[..., 0]
    return rel, in_box, lin


def _leaf_frac(rel, depth_word):
    """frac within the leaf: the point scaled to the leaf's depth, rel *
    2^depth (low 16 bits of the depth word)."""
    depth = depth_word & 0xFFFF
    scale = (1 << depth).to(rel.dtype)
    f = rel * scale[..., None]
    return f - f.floor()


def grid_query_plain(grid: LeafGrid, points, with_gradient: bool):
    """d (P,), and with the gradient (d, g (P, 3)), of (P, 3) points: one
    row gather a point (fused rows), or the grid row and then the
    coefficient row its word names (thin grid, aligned layout)."""
    rel, in_box, lin = _grid_cells(points, grid.box_min, grid.box_size3, grid.depth)
    row = grid.rows[lin]
    if grid.fat:
        coeffs = row[..., 2 : 2 + grid.num_coeff].view(torch.float32)
    else:
        coeffs = _coeff_rows(grid.words, row[..., 0], grid.num_coeff)
    frac = _leaf_frac(rel, row[..., 1])
    return _finish(points, coeffs, frac, in_box, grid.box_min, grid.box_size3,
                   grid.min_border, grid.interpolation, with_gradient)


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _f32(t, shape, name: str, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` (None:
    any size there) on ``device``."""
    _need(isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.ndim == len(shape)
          and all(s is None or s == n for s, n in zip(shape, t.shape)),
          f"{name} must be a {tuple(shape)} float32 tensor")
    _need(t.device == device, f"{name} lies on {t.device}, not on {device}")
    _need(t.is_contiguous(), f"{name} must be contiguous")


def check_grid(grid: LeafGrid, device) -> bool:
    """Raise unless ``grid`` is a leaf grid on ``device`` that the kernels
    read; True on a CUDA device (launch), False on the CPU (plain)."""
    nc = {"tricubic": 64, "trilinear": 8}.get(grid.interpolation)
    _need(nc is not None and grid.num_coeff == nc,
          f"{grid.interpolation!r} leaves with {grid.num_coeff} coefficients")
    rows = grid.rows
    _need(isinstance(rows, torch.Tensor) and rows.dtype == torch.int32 and rows.ndim == 2
          and rows.shape[0] == 8 ** grid.depth, "rows must be an (8^depth, width) int32 tensor")
    _need(rows.shape[1] >= 2 + nc if grid.fat else rows.shape[1] == 2,
          f"rows of {rows.shape[1]} words for {'fused' if grid.fat else 'thin'} rows")
    _need(rows.device == device, f"rows lie on {rows.device}, not on {device}")
    _need(rows.is_contiguous(), "rows must be contiguous")
    if not grid.fat:
        w = grid.words
        _need(isinstance(w, torch.Tensor) and w.dtype == torch.int32 and w.ndim == 1,
              "the thin grid needs the (W,) int32 octree words")
        _need(w.device == device, f"words lie on {w.device}, not on {device}")
        _need(w.is_contiguous() and w.numel() < 2**31, "words must be contiguous, < 2^31")
    _f32(grid.box_min, (3,), "box_min", device)
    _f32(grid.box_size3, (3,), "box_size3", device)
    if device.type == "cpu":
        return False
    _need(device.type == "cuda", f"unsupported device {device}")
    # the kernels read fused rows and coefficient rows as float4
    _need(rows.data_ptr() % 16 == 0 and (grid.fat or grid.words.data_ptr() % 16 == 0)
          and (rows.shape[1] * 4) % (16 if grid.fat else 8) == 0,
          "the kernels need 16-byte aligned rows and words")
    return True


def grid_args(grid: LeafGrid) -> tuple:
    """The kernels' leading arguments: rows, width, coefficients (null for
    fused rows), words, depth, tricubic, box_min, box_size3, min_border."""
    thin = not grid.fat
    return (grid.rows.data_ptr(), grid.rows.shape[1],
            grid.words.data_ptr() if thin else None, grid.words.numel() if thin else 0,
            grid.depth, int(grid.interpolation == "tricubic"),
            grid.box_min.data_ptr(), grid.box_size3.data_ptr(),
            float(np.float32(grid.min_border)))


def grid_query(grid: LeafGrid, points, with_gradient: bool, out=None, group: int | None = None):
    """K4: d (P,), and with the gradient (d, g (P, 3)), of (P, 3) float32
    points on the grid's device. ``out``, if given, holds the outputs'
    tensors (d, or (d, g)) to write in place, as a captured frame needs.
    ``group``: the lanes that read a point's row (``GROUPS``; default
    ``GROUP[with_gradient]``)."""
    group = GROUP[with_gradient] if group is None else group
    _need(group in GROUPS, f"group must be one of {GROUPS}")
    _need(isinstance(points, torch.Tensor), "points must be a tensor")
    _f32(points, (None, 3), "points", points.device)
    launch = check_grid(grid, points.device)
    n = points.shape[0]
    if out is not None:
        d, g = out if with_gradient else (out, None)
        _f32(d, (n,), "d", points.device)
        if with_gradient:
            _f32(g, (n, 3), "g", points.device)
    if not launch:
        res = grid_query_plain(grid, points, with_gradient)
        if out is None:
            return res
        for dst, src in zip(out, res) if with_gradient else ((out, res),):
            dst.copy_(src)
        return out
    if out is None:
        d = torch.empty(n, dtype=torch.float32, device=points.device)
        g = torch.empty((n, 3), dtype=torch.float32, device=points.device) if with_gradient else None
    if n:
        build.launch("sdf_octree_query", points.device, *grid_args(grid), points.data_ptr(), n,
                     d.data_ptr(), g.data_ptr() if with_gradient else None, group)
        build.count_launch(globals(), "launch_count")
    return (d, g) if with_gradient else d
