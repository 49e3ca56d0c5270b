"""Differentiable octree queries: gradients with respect to the leaf
coefficients and the query points.

Port of the JAX package's ``diff/query.py``. The flat octree words hold
the topology and stay fixed; the polynomial coefficients are a separate
float32 tensor of the same length (``octree_coefficients``: a copy of the
words' float32 view, so its leaf coefficient slots hold the real values).
The query walks the words and reads the coefficients from that tensor
(``ops/walk.py``): ``WalkQuery``, a ``torch.autograd.Function`` whose
forward is K10 and whose backward is K11 on the card (the coefficient
gradient, summed in a fixed order on the aligned layout, and the point
gradient), their plain versions on the CPU. The forward
equals ``OctreeSdf``'s walk route bit for bit on either device.

The gradient of the world gradient ``g`` with respect to the points is a
second derivative, which the kernels do not compute: where the caller
asks for ``g`` of points that require a gradient while autograd records,
the query takes autograd of the plain walk instead, on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.walk import Walk, WalkQuery, walk_query_plain
from ..sdf.octree import _to_dev_i32

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


def _walk(octree_words, coeffs_f32, box_min, box_size, start_grid_size, min_border_value, *,
          levels: int, num_coeff: int, interpolation: str, fast: bool) -> Walk:
    """The walk of the flat octree over ``coeffs_f32``, on its device."""
    dev = coeffs_f32.device
    size = float(np.float32(box_size))
    return Walk(_words(octree_words, dev), coeffs_f32,
                torch.as_tensor(np.asarray(box_min, np.float32), device=dev),
                torch.full((3,), size, device=dev), float(min_border_value),
                int(start_grid_size), levels, num_coeff, interpolation, fast)


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
    contiguous float32 coefficient tensor of the same length; the query
    runs on the coefficients' device. ``fast`` assumes the aligned layout
    the builders emit (row reads); ``fast=False`` takes any layout, as
    reference ``.bin`` files have (coefficients read at base + j). With
    ``with_gradient`` also returns the world-space gradient: the
    polynomial's gradient times 2^steps / cell (not normalised), 0 outside
    the box. The point gradient is the world gradient inside the box and
    the box distance's gradient outside, as autograd of the walk gives it
    (the JAX package's is NaN in the box)."""
    walk = _walk(octree_words, coeffs_f32, box_min, box_size, start_grid_size,
                 min_border_value, levels=levels, num_coeff=num_coeff,
                 interpolation=interpolation, fast=fast)
    pts = torch.as_tensor(points, dtype=torch.float32, device=coeffs_f32.device)
    flat = pts.reshape(-1, 3)
    if with_gradient and flat.requires_grad and torch.is_grad_enabled():
        d, g = walk_query_plain(walk, flat, "world")
    else:
        out = WalkQuery.apply(coeffs_f32, flat.contiguous(), walk._replace(coeffs=None),
                               with_gradient)
        if not with_gradient:
            return out.reshape(pts.shape[:-1])
        d, g = out
    return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)
