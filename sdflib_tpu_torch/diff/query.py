"""Differentiable octree queries: gradients with respect to the leaf
coefficients and the query points.

Port of the JAX package's ``diff/query.py``. The flat octree words hold
the topology and stay fixed; the polynomial coefficients are a separate
float32 tensor of the same length (``octree_coefficients``: a copy of the
words' float32 view, so its leaf coefficient slots hold the real values).
The query descends through the words and gathers the coefficients from
that tensor, so torch autograd differentiates it: the gather's backward
is a row scatter-add into the coefficient tensor. No kernel sits on this
path; the walk is the approximate octree's own (``sdf.octree``), so the
forward equals ``OctreeSdf``'s walk route bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.interpolation import gradient_at
from ..sdf.octree import _finish, _octree_walk, _to_dev_i32

__all__ = ["octree_query_diff", "octree_coefficients"]


def octree_coefficients(octree_words, device=None) -> torch.Tensor:
    """The trainable coefficient tensor of a flat octree: a float32 COPY
    of the words' bits, on ``device`` (default: the words' device, the CPU
    for a numpy array). A copy, not a view: the octree's int32 words on
    the card share storage with their float32 view, and an optimizer step
    on a view would rewrite the topology."""
    if isinstance(octree_words, torch.Tensor):
        out = octree_words.to(torch.int32).view(torch.float32).clone()
        return out if device is None else out.to(device)
    bits = np.ascontiguousarray(octree_words, np.uint32).view(np.float32)
    return torch.tensor(bits, device=device)


def _words(octree_words, device) -> torch.Tensor:
    """The flat octree as the int32 tensor the walk reads, on ``device``."""
    if isinstance(octree_words, torch.Tensor):
        return octree_words.to(device=device, dtype=torch.int32)
    return _to_dev_i32(np.asarray(octree_words), device)


def octree_query_diff(
    octree_words,
    coeffs_f32,
    points,
    box_min,
    box_size,
    start_grid_size: int,
    min_border_value,
    *,
    levels: int,
    num_coeff: int = 64,
    interpolation: str = "tricubic",
    with_gradient: bool = False,
    fast: bool = True,
):
    """Octree distances of (..., 3) ``points``, differentiable with
    respect to ``coeffs_f32`` and to ``points`` (through the polynomial).

    ``octree_words`` is the flat array (the int32 device words of an
    ``OctreeSdf``, or its uint32 numpy array), ``coeffs_f32`` the
    coefficient tensor of the same length; the query runs on the
    coefficients' device. ``fast`` assumes the aligned layout the builders
    emit (row gathers); ``fast=False`` takes any layout, as reference
    ``.bin`` files have (coefficients gathered at base + arange). With
    ``with_gradient`` also returns the world-space gradient: the
    polynomial's gradient times 2^steps / cell (not normalised), 0 outside
    the box."""
    dev = coeffs_f32.device
    words = _words(octree_words, dev)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    flat = pts.reshape(-1, 3)
    box_min_t = torch.as_tensor(np.asarray(box_min, np.float32), device=dev)
    size = float(np.float32(box_size))
    box_size3 = torch.full((3,), size, device=dev)
    coeffs, frac, in_box, steps = _octree_walk(
        words, flat, box_min_t, box_size3, int(start_grid_size), levels=levels,
        num_coeff=num_coeff, fast=fast, coeffs_f32=coeffs_f32,
    )
    d = _finish(flat, coeffs, frac, in_box, box_min_t, box_size3,
                float(min_border_value), interpolation, False)
    if not with_gradient:
        return d.reshape(pts.shape[:-1])
    # the reached leaf's edge: cell / 2^steps
    leaf_size = (box_size3[0] / int(start_grid_size)) / torch.exp2(steps.to(torch.float32))
    g = gradient_at(coeffs, frac, interpolation) / leaf_size[..., None]
    g = torch.where(in_box[..., None], g, torch.zeros_like(g))
    return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)
