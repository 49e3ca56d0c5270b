"""Batched sphere tracing over an octree SDF, in plain torch.

Port of the JAX package's ``render/sphere_trace.py`` (reference:
src/render_engine/shaders/sdfOctreeRender.comp:392-409 ``raycast``: march
while lastDistance > eps, accumulated distance < far and iterations <
MAX_ITERATIONS). Distances are evaluated in world space with eps and far
scaled by the box size, the reference's distanceScale = 1 / boxSize
(RenderSdf.cpp:127-128).

The march step is ``_grid_distance_and_step``: one row of the dense leaf
grid (the fused row where ``build_query_grid`` built it), the leaf
polynomial or the box fallback, and in cells flagged surface-free a step
to the leaf exit or the free-radius box exit. A beam prepass starts every
ray at a depth proven safe for its tile. The march then runs in rounds
over the still-active rays, compacted between rounds. Every step is a
sequence of full-batch torch ops; no module here has a kernel of its own.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..sdf.octree import (
    OctreeSdf,
    _coeff_rows,
    _finish,
    _octree_query,
    _octree_query_fat,
    _octree_query_grid,
)
from ..sdf.sdf_function import resolve_device

__all__ = ["TraceResult", "sphere_trace", "trace_octree"]

# The march checks for an early exit (one host sync) once per this many
# trips; the returned trip counts do not depend on it.
_CHECK_EVERY = 16
# Trips of the first march round; each later round doubles, up to
# _MAX_ROUND_ITERS (the JAX dynamic scheduler's rounds).
_FIRST_ROUND_ITERS = 8
_MAX_ROUND_ITERS = 256
# Trip cap of the beam prepass.
_BEAM_ITERS = 256


def _grid_distance_and_step(
    octree_i32,
    grid_i32,
    pts,
    dirs,
    box_min,
    box_size3,
    min_border_value: float,
    *,
    grid_depth: int,
    num_coeff: int,
    interpolation: str,
    grid_fat: bool = False,
    shrink=None,
):
    """Distance and safe step of (P, 3) points moving along (P, 3) unit
    ``dirs``, in one pass over the dense leaf grid.

    ``grid_i32`` holds one row per finest cell: [leaf word, depth | flags]
    (``_query_grid``) or, with ``grid_fat``, the fused row with the leaf's
    coefficients after those two words (``_fat_grid``). The depth word is
    int32: depth in bits 0-15, the surface-free flag in bit 16, the free
    radius in bits 17-21. No flag reaches bit 31, so the arithmetic right
    shift of the int32 word reads them as the JAX package's logical shift
    of its uint32 word does.

    In a free cell the step extends to the exit of the free-radius box of
    (2 rad + 1)^3 finest cells around the point, plus 1e-3 of a finest
    cell, where that is farther than d; elsewhere it is max(d, 0). Outside the box the distance is the box fallback, itself a
    lower bound.

    ``shrink`` = (radius, growth) makes the exit step safe for a beam of
    that radius: each wall of the free box moves in by the radius, the
    exit comes where the first contracted wall gap closes (each gap is
    linear in t), and the step is -inf unless the centre already sits
    ``radius`` inside every wall. Then the distance and that exit-only
    step are returned, for the beam prepass to combine."""
    g = 1 << grid_depth
    dtype = pts.dtype
    box_size = box_size3[0]
    rel = (pts - box_min) / box_size3
    in_box = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
    cell = (rel * g).to(torch.int32).clamp(0, g - 1)
    lin = ((cell[..., 2] * g + cell[..., 1]) * g + cell[..., 0]).long()

    if grid_fat:
        # only the two words and the coefficients of the fused row
        row = grid_i32[:, : 2 + num_coeff][lin]
        coeffs = row[..., 2:].view(torch.float32)
    else:
        row = grid_i32[lin]
        coeffs = _coeff_rows(octree_i32, row[..., 0], num_coeff)
    dw = row[..., 1]
    free = ((dw >> 16) & 1) == 1
    scale = (1 << (dw & 0xFFFF)).to(dtype)
    f = rel * scale[..., None]
    d = _finish(pts, coeffs, f - f.floor(), in_box, box_min, box_size3,
                min_border_value, interpolation, False)

    if shrink is not None:
        sh = shrink[0][..., None]      # tube radius at the current point
        gr = shrink[1][..., None]      # radius growth per unit arclength

    def box_exit(bmin, bsize):
        if shrink is None:
            far_face = bmin + (dirs > 0).to(dtype) * bsize
            t_ax = torch.where(dirs != 0.0, (far_face - pts) / dirs, torch.inf)
            return t_ax.amin(-1)
        gap_n = pts - bmin - sh
        gap_f = bmin + bsize - pts - sh
        contained = ((gap_n >= 0.0) & (gap_f >= 0.0)).all(dim=-1)
        rate_n = gr - dirs             # > 0 where the near gap shrinks
        rate_f = gr + dirs
        t_n = torch.where(rate_n > 0.0, gap_n / rate_n.clamp_min(1e-20), torch.inf)
        t_f = torch.where(rate_f > 0.0, gap_f / rate_f.clamp_min(1e-20), torch.inf)
        t = torch.minimum(t_n.amin(-1), t_f.amin(-1))
        return torch.where(contained, t, -torch.inf)

    # The free-radius box (bits 17-21): every finest cell within Chebyshev
    # distance rad of this one is proven free, so its exit is safe; in
    # float32 as (cell - rad) * cell_size. The JAX function also takes the
    # exit of the leaf's own box, which the flag of one finest cell does
    # not prove free: a coarse leaf can hold the surface in another of its
    # cells (ROADMAP.md, Queue 3). The overshoot stays at finest-cell scale.
    cell_size = box_size / g
    rad = ((dw >> 17) & 0x1F).to(dtype)
    rbox_min = box_min + (cell.to(dtype) - rad[..., None]) * cell_size
    rbox_size = (2.0 * rad + 1.0)[..., None] * cell_size
    t_exit = box_exit(rbox_min, rbox_size) + 1e-3 * cell_size

    free_in = free & in_box
    if shrink is not None:
        return d, torch.where(free_in, t_exit, -torch.inf)
    return d, torch.where(free_in, torch.maximum(d, t_exit), d.clamp_min(0.0))


class TraceResult(NamedTuple):
    hit: torch.Tensor         # (...,) bool
    position: torch.Tensor    # (..., 3) world hit position (last march point)
    depth: torch.Tensor       # (...,) accumulated world-space distance
    normal: torch.Tensor      # (..., 3) normalized SDF gradient at the hit
    iterations: torch.Tensor  # (...,) int32 march steps of each ray


def _march(step_fn, state, dirs, eps: float, far: float, trips: int):
    """``trips`` march steps of ``state`` = (pos, acc, last_d, active),
    active as float 0/1: step by ``step_fn(pos, dirs)``'s step where
    active, hit at d <= eps, stop past ``far``. Returns each ray's count
    of steps taken and the new state (new tensors: the inputs are not
    written). Stops early, once every ray is done, at a check every
    ``_CHECK_EVERY`` trips; the state no longer changes by then."""
    pos, acc, last_d, active = state
    its = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    for i in range(trips):
        if i and i % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        d, step = step_fn(pos, dirs)
        moved = step * active
        pos = pos + dirs * moved[..., None]
        acc = acc + moved
        live = active > 0
        last_d = torch.where(live, d, last_d)
        its = its + live
        active = active * (last_d > eps) * (acc < far)
    return its, (pos, acc, last_d, active)


def sphere_trace_state(
    distance_fn,
    state,
    dirs,
    *,
    eps: float = 1e-5,
    far: float = 10.0,
    max_iters: int = 1024,
    distance_step_fn=None,
):
    """Resumable batched ray march. ``state`` = (pos, acc, last_d, active)
    per ray, ``active`` float 0/1; returns the last trip that had an
    active ray (a 0-d int32 tensor) and the advanced state. Loop semantics
    mirror raycast (comp shader :392-409): march by max(d, 0), stop when
    d <= eps (hit), accumulated > far, or at the iteration cap.

    ``distance_step_fn(pos) -> (d, step)`` optionally supplies a safe step
    larger than d; the hit test always uses d. Runs on the device of
    ``state``; the trip count stays on the device (a ray's own count is
    the trips it was active, and rays never wake up, so the last trip
    with an active ray is the largest count)."""
    pos = state[0]
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=pos.device)
    if distance_step_fn is None:
        def step_fn(p, _):
            d = distance_fn(p)
            return d, d.clamp_min(0.0)
    else:
        def step_fn(p, _):
            return distance_step_fn(p)
    its, state = _march(step_fn, state, dirs, eps, far, max_iters)
    it = its.max() if its.numel() else its.new_zeros(())
    return it, state


def sphere_trace(
    distance_fn,
    origins,
    dirs,
    *,
    eps: float = 1e-5,
    far: float = 10.0,
    max_iters: int = 1024,
    device="cuda",
):
    """Generic batched ray march from fresh origins, on the device of
    ``origins`` where it is a tensor, else on ``device`` (the card unless
    the caller passes the CPU; without a card a CUDA device raises).
    Returns (hit, position, depth, iterations), iterations the last trip
    with an active ray."""
    if isinstance(origins, torch.Tensor):
        origins = origins.to(torch.float32)
    else:
        origins = torch.as_tensor(origins, dtype=torch.float32,
                                  device=resolve_device(device))
    shape = origins.shape[:-1]
    zeros = torch.zeros(shape, dtype=torch.float32, device=origins.device)
    init = (origins, zeros, torch.full_like(zeros, torch.inf), torch.ones_like(zeros))
    it, (pos, acc, last_d, _) = sphere_trace_state(
        distance_fn, init, dirs, eps=eps, far=far, max_iters=max_iters
    )
    return last_d <= eps, pos, acc, it


def _beam_tiles(o, d, shape, beam: int):
    """The rays as (tiles, beam^2) members: beam x beam pixel tiles of an
    (H, W, 3) image whose sides beam divides, else runs of beam^2
    consecutive rays, the last run padded. Returns (members of o, of d,
    the mask of real members or None, a function taking (tiles,) values
    to (R,) values, one per ray)."""
    R, bb = o.shape[0], beam * beam
    if len(shape) == 3 and shape[0] % beam == 0 and shape[1] % beam == 0:
        H, W = shape[0], shape[1]
        th, tw = H // beam, W // beam

        def tiles(x):
            return (x.reshape(th, beam, tw, beam, 3).permute(0, 2, 1, 3, 4)
                    .reshape(th * tw, bb, 3))

        def per_ray(v):
            return (v.reshape(th, tw, 1, 1).expand(th, tw, beam, beam)
                    .permute(0, 2, 1, 3).reshape(R))

        return tiles(o), tiles(d), None, per_ray
    nt = -(-R // bb)
    pad = nt * bb - R

    def tiles(x):
        return torch.cat([x, x.new_zeros(pad, 3)]).reshape(nt, bb, 3)

    mask = (torch.arange(nt * bb, device=o.device) < R).reshape(nt, bb)
    return tiles(o), tiles(d), mask, lambda v: v[:, None].expand(nt, bb).reshape(-1)[:R]


def _beam_setup(o_t, d_t, mask):
    """Per-tile beam parameters from (tiles, members, 3) rays: the mean
    origin, the normalized mean direction, and the radius bound
    r(t) = r0 + t * rd covering every member ray's path. Sums and maxima
    run over the members axis (no atomics, so the same inputs give the
    same beams on every run); padding members (``mask`` False) count in
    no sum, mean or maximum."""
    if mask is None:
        cnt = torch.full((o_t.shape[0], 1), float(o_t.shape[1]), device=o_t.device)
    else:
        cnt = mask.sum(1, keepdim=True).to(o_t.dtype)
    o_c = o_t.sum(1) / cnt
    d_sum = d_t.sum(1)
    d_c = d_sum / (d_sum * d_sum).sum(-1, keepdim=True).sqrt().clamp_min(1e-20)

    def spread(x, c):
        r = (x - c[:, None]).square().sum(-1).sqrt()
        return (r if mask is None else torch.where(mask, r, 0.0)).amax(1)

    return o_c, d_c, spread(o_t, o_c), spread(d_t, d_c)


def _beam_prepass(dist_fn, origins, dirs, r0, rd, margin: float, far: float,
                  max_iters: int = _BEAM_ITERS):
    """March one ray per tile with the hit test widened by the tile
    radius r(t) = r0 + t * rd, stepping by (d - r(t) - margin) / (1 + rd)
    or by ``dist_fn``'s tube-safe exit step, whichever is longer. Every
    member ray stays within r(t) of the beam ray and the true SDF is
    1-Lipschitz, so no member hits before the returned depth, where the
    members then start (the reference renderer's per-tile coherence,
    RenderSdf.cpp:187, as an explicit two-level schedule).

    A beam stops on proximity (step 0), past ``far``, and on stagnation,
    a step below half the margin: a grazing beam skimming the silhouette
    would crawl in sub-margin steps for hundreds of trips, and stopping
    early is always safe since the stop depth bounds every member's first
    hit wherever it is."""
    pos = origins
    acc = torch.zeros_like(r0)
    active = torch.ones_like(r0)
    for i in range(max_iters):
        if i and i % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        radius = r0 + acc * rd
        d, fstep = dist_fn(pos, dirs, radius)
        # /(1 + rd): the radius keeps growing over the step
        dstep = ((d - radius - margin) / (1.0 + rd)).clamp_min(0.0)
        step = torch.maximum(dstep, fstep)
        moved = step * active
        pos = pos + dirs * moved[..., None]
        acc = acc + moved
        active = active * (step > 0.5 * margin) * (acc < far)
    return acc


def trace_octree(
    octree: OctreeSdf,
    origins,
    dirs,
    *,
    eps: float = 1e-5,
    far: float = 4.0,
    max_iters: int = 1024,
    block_size: int | None = None,
    beam: int | None = 4,
    pyramid: bool = True,
    stats_out: dict | None = None,
    active=None,
) -> TraceResult:
    """Sphere-trace rays against an ``OctreeSdf`` on its device. eps and
    far are in normalized octree space (box edge = 1), as in the
    reference shader.

    The distance route: the fused rows if ``build_query_grid`` built
    them, else the thin leaf grid, else the walk; the grids (and their
    free-cell steps) only for eps <= ``OctreeSdf._FREE_CELL_MARGIN``, the
    margin the free flags were proven with.

    Schedule: a beam prepass (one radius-widened ray per beam x beam
    tile: pixel tiles for (H, W, 3) inputs whose sides beam divides, runs
    of beam^2 consecutive rays otherwise; ``beam=None`` disables it) gives
    each ray a safe start depth. Then the march runs in rounds of 8, 16,
    ... up to 256 trips over the rays still active, each round ending
    with one host sync (the active count) and one compaction of the
    active rays to the front, as the JAX package's dynamic scheduler.
    ``pyramid`` and ``block_size`` are accepted for the JAX signature and
    take this one scheduler: the JAX static pyramid and its fixed blocks
    work around the TPU's lack of per-ray divergence and give the same
    hits and depths (its own tests pin the pyramid to the dynamic path).

    ``iterations`` is each ray's own count of march steps, as the
    reference shader's heatmap shows it. ``stats_out["rounds"]`` receives
    (iters, marched, still_active) per round. ``active`` (one bool a
    ray, default all) marks the rays that march; the others keep their
    origin, depth 0 and no hit (``parallel.sharded_trace``'s padding)."""
    del block_size, pyramid
    dev = octree.device
    origins = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    shape = origins.shape
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    R = o.shape[0]

    box_size = float(octree.box.size[0])
    eps_w = float(np.float32(eps) * np.float32(box_size))
    far_w = float(np.float32(far) * np.float32(box_size))
    box_args = (octree._box_min, octree._box_size3)
    mbv = octree.min_border_value
    statics = dict(num_coeff=octree.num_coefficients, interpolation=octree.interpolation)
    walk = dict(levels=octree.max_depth - octree.start_depth, fast=octree._fast_layout,
                **statics)

    grid = octree._fat_grid
    grid_fat = grid is not None
    if grid is None:
        grid = octree._query_grid
    if grid is not None and eps > OctreeSdf._FREE_CELL_MARGIN:
        grid = None    # the free flags hold only for hit thresholds below the margin

    def distance(p):
        return _octree_query(octree._octree_dev, p, *box_args, octree.start_grid_size, mbv,
                             with_gradient=False, **walk)

    def grid_step(p, u, shrink=None):
        return _grid_distance_and_step(
            octree._octree_dev, grid, p, u, *box_args, mbv, grid_depth=octree.max_depth,
            grid_fat=grid_fat, shrink=shrink, **statics)

    if grid is not None:
        step_fn = grid_step
    else:
        def step_fn(p, _):
            dist = distance(p)
            return dist, dist.clamp_min(0.0)

    start_t = torch.zeros(R, dtype=torch.float32, device=dev)
    if beam is not None and R >= beam * beam:
        o_t, d_t, mask, per_ray = _beam_tiles(o, d, shape, beam)
        o_c, d_c, r0, rd = _beam_setup(o_t, d_t, mask)
        # hit threshold + fit-error budget: the Lipschitz argument runs
        # through the true distance, which the polynomial tracks within
        # the octree build's termination threshold
        margin = eps * box_size + 4.0 * octree.termination_threshold
        if grid is not None:
            def beam_fn(p, u, radius):
                return grid_step(p, u, shrink=(radius + margin, rd))
        else:
            def beam_fn(p, u, radius):
                dist = distance(p)
                return dist, torch.full_like(dist, -torch.inf)
        start_t = per_ray(_beam_prepass(beam_fn, o_c, d_c, r0, rd, margin, far * box_size))

    # The frame's state (tensors of this call, never the caller's), written
    # back in place after each round; a round marches the compacted active
    # rays only, through new tensors.
    pos = o + d * start_t[:, None]
    acc = start_t
    last_d = torch.full((R,), torch.inf, device=dev)
    iterations = torch.zeros(R, dtype=torch.int32, device=dev)
    cur = torch.arange(R, device=dev)
    live0 = (torch.ones(R, device=dev) if active is None
             else torch.as_tensor(active, device=dev).reshape(R).to(torch.float32))
    sub = (pos, acc, last_d, live0)
    sub_dirs = d
    n_cur, remaining = R, max_iters
    round_iters = min(_FIRST_ROUND_ITERS, max_iters)
    rounds_log = []
    while remaining > 0 and n_cur > 0:
        k = min(round_iters, remaining)
        its, sub = _march(step_fn, sub, sub_dirs, eps_w, far_w, k)
        for full, part in zip((pos, acc, last_d), sub):
            full.index_copy_(0, cur, part)
        iterations.index_add_(0, cur, its)    # integer adds at distinct rays
        keep = (sub[3] > 0).nonzero().squeeze(1)   # the round's one host sync
        rounds_log.append((k, n_cur, int(keep.shape[0])))
        n_cur = keep.shape[0]
        cur = cur[keep]
        sub = tuple(x[keep] for x in sub)
        sub_dirs = sub_dirs[keep]
        remaining -= k
        round_iters = min(round_iters * 2, _MAX_ROUND_ITERS)
    if stats_out is not None:
        stats_out["rounds"] = rounds_log

    hit = last_d <= eps_w
    # normals ride the fused rows where built (one gather a ray), else the
    # thin grid, else the walk
    if octree._fat_grid is not None:
        _, normal = _octree_query_fat(octree._fat_grid, pos, *box_args, mbv,
                                      grid_depth=octree.max_depth, with_gradient=True,
                                      **statics)
    elif octree._query_grid is not None:
        _, normal = _octree_query_grid(octree._octree_dev, octree._query_grid, pos, *box_args,
                                       mbv, grid_depth=octree.max_depth, with_gradient=True,
                                       **statics)
    else:
        _, normal = _octree_query(octree._octree_dev, pos, *box_args, octree.start_grid_size,
                                  mbv, with_gradient=True, **walk)
    lead = shape[:-1]
    return TraceResult(hit.reshape(lead), pos.reshape(shape), acc.reshape(lead),
                       normal.reshape(shape), iterations.reshape(lead))
