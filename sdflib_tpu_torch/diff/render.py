"""Differentiable depth rendering: pixel losses flow to the leaf
coefficients.

Port of the JAX package's ``diff/render.py``: the depth-image fit demo.
The march is not differentiated: it runs under ``torch.no_grad()`` over
the frozen coefficients, as one launch of K12 on the card (``ops/walk.py``
``walk_march``: persistent warps that march every ray's trips in
registers and hand a lane the next ray once its own has left; rays given
as an image, (..., H, W, 3), are taken 8 x 4 pixels at a time) and as the
generic ``sphere_trace`` over the plain walk on the CPU
(an autograd graph of every trip would hold every intermediate of up to
``max_iters`` full-batch steps). The converged point then takes one
differentiable Newton correction along the ray,

    depth* = depth - d(p; coeffs) / min(<grad d, dir>, -1e-2),

with the denominator detached, so d(depth*)/d(coeffs) = -(dd/dcoeffs) /
<grad, dir>, the usual differentiable sphere-tracing estimator; the
coefficient gradient reaches the coefficient tensor through
``octree_query_diff`` (K10 forward, K11 backward on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.walk import walk_march
from .query import _walk, _words, octree_query_diff

__all__ = ["render_depth_diff", "depth_fit_loss"]


def render_depth_diff(
    octree_words,
    coeffs_f32,
    origins,
    dirs,
    box_min,
    box_size,
    start_grid_size: int,
    min_border_value,
    *,
    levels: int,
    num_coeff: int = 64,
    interpolation: str = "tricubic",
    eps: float = 1e-4,
    far: float = 4.0,
    max_iters: int = 256,
    fast: bool = True,
):
    """(depth, hit) of the rays, the depths differentiable with respect to
    ``coeffs_f32``, on its device. ``eps`` and ``far`` are in box units
    (box edge 1). A missed ray returns far * box_size, with no gradient
    (``torch.where`` selects the value, so its correction term never
    reaches the gradient)."""
    dev = coeffs_f32.device
    words = _words(octree_words, dev)
    origins = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    q = dict(levels=levels, num_coeff=num_coeff, interpolation=interpolation, fast=fast)
    args = (box_min, box_size, start_grid_size, min_border_value)
    walk = _walk(words, coeffs_f32.detach(), *args, **q)
    size = np.float32(box_size)
    shape = origins.shape[:-1]
    with torch.no_grad():
        hit, pos, depth, _ = walk_march(
            walk, origins.reshape(-1, 3).contiguous(),
            dirs.expand(origins.shape).reshape(-1, 3).contiguous(),
            float(np.float32(eps) * size), float(np.float32(far) * size), max_iters,
            width=shape[-1] if len(shape) >= 2 else 0)
    hit, pos, depth = hit.reshape(shape), pos.reshape(origins.shape), depth.reshape(shape)
    d, g = octree_query_diff(words, coeffs_f32, pos, *args, with_gradient=True, **q)
    # the SDF's derivative along the ray at the surface (entering: < 0)
    denom = (g * dirs).sum(-1).clamp_max(-1e-2).detach()
    depth_star = depth - d / denom
    miss = torch.full_like(depth_star, float(np.float32(far) * size))
    return torch.where(hit, depth_star, miss), hit


def depth_fit_loss(
    octree_words,
    coeffs_f32,
    origins,
    dirs,
    target_depth,
    target_hit,
    box_min,
    box_size,
    start_grid_size: int,
    min_border_value,
    **kw,
):
    """Mean squared depth error over the rays that hit in both renders:
    the objective of the depth-image fit."""
    depth, hit = render_depth_diff(
        octree_words, coeffs_f32, origins, dirs, box_min, box_size,
        start_grid_size, min_border_value, **kw,
    )
    target_depth = torch.as_tensor(target_depth, device=depth.device)
    target_hit = torch.as_tensor(target_hit, device=depth.device)
    m = (hit & target_hit).to(depth.dtype)
    n = m.sum().clamp_min(1.0)
    return (m * (depth - target_depth).square()).sum() / n
