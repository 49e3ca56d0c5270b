"""Data-parallel differentiable fitting: the multi-device training step.

Port of the JAX package's ``parallel/fit.py``. Query points shard over
the device list; every entry holds a replica of the octree coefficient
tensor. Each device's block of shards (``sharded_rays(mesh).put``) takes
its weighted squared error over the whole batch's weight through
``octree_query_diff`` and autograd there, every device at the same time
on its worker (``run_blocks``); the blocks' coefficient gradients are
summed on the first entry's device (the all-reduce, in
entry order) and one SGD step is taken there. On one device the step is
``fit_step``'s, bit for bit, on the CPU and on the card: K11
(``ops/walk.py``) sums each coefficient row in an order fixed by the
points (on the word-by-word layout its atomics do not, and two runs
agree to fp32 rounding of each coefficient's sum). Over a
``ProcessMesh`` every rank gathers every block's loss and gradient
(``_gather_runs``, an ``all_gather``) and sums them in the same entry
order, so every rank takes the same step, the one-process step's sums
in its order; an ``all_reduce`` would sum in the collective's own order.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..diff.query import octree_query_diff
from .mesh import (
    ProcessMesh,
    _gather_ranks,
    _runs,
    default_mesh,
    device_runs,
    local_devices,
    local_entries,
    pad_to_shards,
    replicated,
    run_blocks,
    sharded_rays,
    takes_part,
)

__all__ = ["data_parallel_fit_step", "fit_step"]


def _gather_runs(mesh, parts) -> list:
    """One tensor for each run of the whole list, in entry order, on the
    first local entry's device: ``parts`` are this process's, one a run of
    ``device_runs(mesh)``, every part of one shape. Of a ``ProcessMesh``,
    one ``all_gather`` of each rank's parts stacked, padded to the rank
    with the most runs. Called on the caller's thread."""
    if not isinstance(mesh, ProcessMesh):
        return [p.to(mesh[0]) for p in parts]
    home = local_devices(mesh)[0]
    runs = _runs(mesh)
    got = _gather_ranks(mesh, torch.stack([p.to(home) for p in parts]),
                        Counter(e.rank for e, _, _ in runs))
    taken: Counter = Counter()
    out = []
    for e, _, _ in runs:
        out.append(got[e.rank][taken[e.rank]])
        taken[e.rank] += 1
    return out


def _weighted_sse(octree_words, coeffs, points, targets, weights, box_min, box_size,
                  min_border_value, *, start_grid_size, levels, num_coeff,
                  interpolation, fast):
    """sum(weights * (d - targets)^2) over the points, differentiable in
    ``coeffs``."""
    d = octree_query_diff(
        octree_words, coeffs, points, box_min, box_size, start_grid_size,
        min_border_value, levels=levels, num_coeff=num_coeff,
        interpolation=interpolation, fast=fast,
    )
    return (weights * (d - targets).square()).sum()


def fit_step(
    octree_words,
    coeffs,
    points,
    targets,
    weights,
    box_min,
    box_size,
    min_border_value,
    lr,
    *,
    start_grid_size: int,
    levels: int,
    num_coeff: int = 64,
    interpolation: str = "tricubic",
    fast: bool = True,
):
    """One weighted-MSE SGD step on the leaf polynomial coefficients, on
    the coefficients' device: the loss sum(w (d - t)^2) / max(sum(w), 1)
    and ``coeffs - lr * grad``. ``weights`` masks padding points so they
    contribute zero gradient."""
    c = coeffs.detach().requires_grad_(True)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=c.device)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=c.device)
    n = weights.sum().clamp_min(1.0)
    loss = _weighted_sse(
        octree_words, c, points, targets, weights, box_min, box_size, min_border_value,
        start_grid_size=start_grid_size, levels=levels, num_coeff=num_coeff,
        interpolation=interpolation, fast=fast,
    ) / n
    (grad,) = torch.autograd.grad(loss, c)
    return loss.detach(), (c - lr * grad).detach()


def data_parallel_fit_step(
    octree, coeffs, points, targets, mesh=None, *, lr: float = 1e-2
):
    """One sharded SGD step against an ``OctreeSdf``'s coefficients.

    ``coeffs`` is one tensor, or the list of replicas a previous step
    returned. points/targets shard over the entries, padding points (the
    box center) at weight 0. Returns (loss, new_coeffs): the loss on the
    first entry's device, new_coeffs one replica per entry (one tensor
    per distinct device); over a ``ProcessMesh``, per local entry, on
    every rank of the list (None on a rank without entries)."""
    mesh = default_mesh(mesh)
    if not takes_part(mesh):
        return None
    rep, split = replicated(mesh), sharded_rays(mesh)

    pts = torch.as_tensor(points, dtype=torch.float32).reshape(-1, 3)
    tgt = torch.as_tensor(targets, dtype=torch.float32, device=pts.device).reshape(-1)
    P = pts.shape[0]
    Pp = pad_to_shards(P, mesh)
    weights = (torch.arange(Pp, device=pts.device) < P).to(torch.float32)
    if Pp != P:
        center = torch.as_tensor(octree.box.center, dtype=torch.float32, device=pts.device)
        pts = torch.cat([pts, center.expand(Pp - P, 3)])
        tgt = torch.cat([tgt, tgt.new_zeros(Pp - P)])

    c_list = (list(coeffs) if isinstance(coeffs, (list, tuple))
              else rep.put(torch.as_tensor(coeffs)))
    local = local_entries(mesh)
    if len(c_list) != len(local):
        raise ValueError(f"{len(c_list)} coefficient replicas for {len(local)} entries")
    at = {i: j for j, (i, _) in enumerate(local)}
    words = rep.put(octree._octree_dev)
    statics = dict(
        start_grid_size=octree.start_grid_size,
        levels=octree.max_depth - octree.start_depth,
        num_coeff=octree.num_coefficients,
        interpolation=octree.interpolation,
        fast=octree._fast_layout,
    )
    dev0 = local_devices(mesh)[0]
    n = weights.sum().clamp_min(1.0)

    def block_grad(dev, block):
        words_k, c_k, p_k, t_k, w_k, n_k = block
        c = c_k.requires_grad_(True)
        loss_k = _weighted_sse(words_k, c, p_k, t_k, w_k, octree.box.min,
                               octree.box.size[0], octree.min_border_value,
                               **statics) / n_k
        (g,) = torch.autograd.grad(loss_k, c)
        return loss_k.detach(), g

    # the copies to each device are made here, on the caller's streams
    blocks = [(dev, (words[at[first]], c_list[at[first]].detach().to(dev), p_k, t_k, w_k,
                     n.to(dev)))
              for (dev, first, _), (_, p_k), (_, t_k), (_, w_k) in zip(
                  device_runs(mesh), split.put(pts), split.put(tgt), split.put(weights))]
    # each block's loss rides in front of its gradient: one gather a step
    parts = [torch.cat([loss_k.reshape(1), g.reshape(-1)])
             for loss_k, g in run_blocks(blocks, block_grad)]
    loss = torch.zeros((), device=dev0)
    grad = torch.zeros_like(c_list[0], device=dev0)
    for part in _gather_runs(mesh, parts):
        loss = loss + part[0]
        grad = grad + part[1:].view_as(grad)
    new = c_list[0].detach().to(dev0) - lr * grad
    return loss, rep.put(new)
