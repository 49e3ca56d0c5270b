"""K5 and K6: the sphere tracer's march and beam on the dense leaf grid,
one thread a ray.

``march_segment`` runs up to ``trips`` consecutive march trips (``_trip``)
of every ray in place: K5 (``csrc/march.cu`` ``march_kernel``) for CUDA
tensors, ``march_segment_plain`` (the trips in torch) for CPU tensors.
``beam_segment`` does the same for the beam prepass's trips
(``_beam_trip``): K6 (``beam_kernel``), or ``beam_segment_plain``. The
step of both is ``_grid_distance_and_step`` over a ``LeafGrid``; K4's leaf
evaluation (``csrc/leaf_eval.cuh``) is their inner step. They replace the
XLA-fused march loops of the JAX package (sdflib_tpu/render/
sphere_trace.py ``_march_pyramid_jit`` :411 and ``_beam_prepass_jit``
:541 over ``_grid_distance_and_step`` :44). ``march_trips`` and
``beam_trips`` run the trips of any step function in torch (the plain
versions here and of the walk route's K14 and K15, ``ops/walk.py``, and
the generic march). ``launch_count`` and ``beam_launch_count``
count kernel launches.

A kernel's ray leaves its loop once it is done, so one launch carries a
whole round's budget and needs no host check. The torch trips (the plain
versions) cost as much for a done ray as for a live one,
so they check for a live ray instead (``_run_trips``) and stop once none
is. The segments write the state in place, and a kernel launch allocates
nothing, so a CUDA graph captures it as one node.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .octree_query import LeafGrid, _coeff_rows, _f32, _finish, _need, check_grid, grid_args

__all__ = [
    "march_segment", "march_segment_plain", "beam_segment", "beam_segment_plain",
    "march_trips", "beam_trips", "launch_count", "beam_launch_count",
]

launch_count = 0
beam_launch_count = 0
# Torch trips with an early exit check for live rays once per this many
# trips on the card, where a check is a host sync, and before every trip on
# the CPU.
_CHECK_EVERY = 16


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


def _trip(step_fn, pos, acc, last_d, active, its, dirs, eps: float, far: float):
    """One march step of every ray, written in place: step by
    ``step_fn(pos, dirs)``'s step where active (float 0/1), count the
    step in ``its``, hit at d <= eps, stop past ``far``."""
    d, step = step_fn(pos, dirs)
    moved = step * active
    pos.add_(dirs * moved[..., None])
    acc.add_(moved)
    live = active > 0
    torch.where(live, d, last_d, out=last_d)
    its.add_(live)
    active.mul_((last_d > eps) & (acc < far))


def _beam_trip(beam_step, pos, acc, active, dirs, r0, rd, margin: float, far: float):
    """One step of the beam prepass, written in place: each beam ray's
    hit test is widened by its tile radius r(t) = r0 + t * rd; it steps
    by (d - r(t) - margin) / (1 + rd) or by ``beam_step``'s tube-safe
    exit step, whichever is longer (the divisor: the radius keeps growing
    over the step). A beam stops on proximity (a step of at most half the
    margin), past ``far``, and on stagnation: a grazing beam skimming the
    silhouette would crawl in sub-margin steps for hundreds of trips, and
    stopping early is always safe since the stop depth bounds every
    member's first hit wherever it is."""
    radius = r0 + acc * rd
    d, fstep = beam_step(pos, dirs, (radius + margin, rd))
    dstep = ((d - radius - margin) / (1.0 + rd)).clamp_min(0.0)
    step = torch.maximum(dstep, fstep)
    moved = step * active
    pos.add_(dirs * moved[..., None])
    acc.add_(moved)
    active.mul_((step > 0.5 * margin) & (acc < far))


def _any_live(active) -> tuple[bool, int]:
    """(whether a flag of ``active`` is set, the host syncs that took): on
    the card one, during which a ``parallel`` worker gives up its turn."""
    if active.device.type == "cpu":
        return bool(active.any()), 0
    from ..parallel.mesh import waiting   # parallel imports this module

    flag = active.any()
    with waiting():
        return bool(flag), 1


def _run_trips(trip, active, trips: int, exit_early: bool) -> int:
    """``trip()`` ``trips`` times. ``exit_early`` stops once no flag of
    ``active`` is set (a trip leaves a done ray as it is), at a check before
    every trip on the CPU and before every ``_CHECK_EVERY``-th on the card.
    Returns the host syncs taken."""
    every = 1 if active.device.type == "cpu" else _CHECK_EVERY
    syncs = 0
    for i in range(trips):
        if exit_early and i % every == 0:
            live, n = _any_live(active)
            syncs += n
            if not live:
                break
        trip()
    return syncs


def march_trips(step_fn, pos, acc, last_d, active, its, dirs, eps: float, far: float,
                trips: int, exit_early: bool = False) -> int:
    """``trips`` march trips (``_trip``) of ``step_fn`` (pos, dirs) -> (d,
    step), in place, as ``_run_trips``."""
    return _run_trips(lambda: _trip(step_fn, pos, acc, last_d, active, its, dirs, eps, far),
                      active, trips, exit_early)


def beam_trips(beam_step, pos, acc, active, dirs, r0, rd, margin: float, far: float,
               trips: int, exit_early: bool = False) -> int:
    """``trips`` beam trips (``_beam_trip``) of ``beam_step`` (pos, dirs,
    shrink) -> (d, tube-safe exit step or -inf), in place, as
    ``_run_trips``."""
    return _run_trips(lambda: _beam_trip(beam_step, pos, acc, active, dirs, r0, rd, margin, far),
                      active, trips, exit_early)


def _step(grid: LeafGrid):
    """``_grid_distance_and_step`` over ``grid``: (pos, dirs, shrink=None)
    -> (d, step)."""
    def step(p, u, shrink=None):
        return _grid_distance_and_step(
            grid.words, grid.rows, p, u, grid.box_min, grid.box_size3, grid.min_border,
            grid_depth=grid.depth, num_coeff=grid.num_coeff,
            interpolation=grid.interpolation, grid_fat=grid.fat, shrink=shrink)
    return step


def march_segment_plain(grid: LeafGrid, pos, acc, last_d, active, its, dirs,
                        eps: float, far: float, trips: int) -> int:
    """``march_segment`` in torch: up to ``trips`` ``_trip``s, with the
    early exit of ``_run_trips``. Returns the host syncs taken."""
    return march_trips(_step(grid), pos, acc, last_d, active, its, dirs, eps, far, trips,
                       exit_early=True)


def beam_segment_plain(grid: LeafGrid, pos, acc, active, dirs, r0, rd, margin: float,
                       far: float, trips: int) -> int:
    """``beam_segment`` in torch: up to ``trips`` ``_beam_trip``s, with the
    early exit of ``_run_trips``. Returns the host syncs taken."""
    return beam_trips(_step(grid), pos, acc, active, dirs, r0, rd, margin, far, trips,
                      exit_early=True)


def _check_rays(pos, dirs, floats: dict, ints: dict) -> int:
    """Raise unless the ray state lies on one device, contiguous, of one
    ray count n: ``pos`` and ``dirs`` (n, 3) float32, ``floats`` (n,)
    float32, ``ints`` (n,) int32. Returns n."""
    _need(isinstance(pos, torch.Tensor) and pos.ndim == 2, "pos must be an (n, 3) tensor")
    n, dev = pos.shape[0], pos.device
    for name, t in {"pos": pos, "dirs": dirs}.items():
        _f32(t, (n, 3), name, dev)
    for name, t in floats.items():
        _f32(t, (n,), name, dev)
    for name, t in ints.items():
        _need(isinstance(t, torch.Tensor) and t.dtype == torch.int32
              and tuple(t.shape) == (n,), f"{name} must be an ({n},) int32 tensor")
        _need(t.device == dev, f"{name} lies on {t.device}, not on {dev}")
        _need(t.is_contiguous(), f"{name} must be contiguous")
    return n


def _check_state(grid: LeafGrid, pos, dirs, floats: dict, ints: dict) -> tuple[bool, int]:
    """``_check_rays`` on the grid's device: (launch the kernel, n)."""
    n = _check_rays(pos, dirs, floats, ints)
    return check_grid(grid, pos.device), n


def march_segment(grid: LeafGrid, pos, acc, last_d, active, its, dirs, eps: float,
                  far: float, trips: int) -> int:
    """K5: up to ``trips`` march trips of the (n,) rays on the grid, in
    place: ``pos`` and ``dirs`` (n, 3), ``acc``, ``last_d`` and ``active``
    (float 0/1) (n,) float32, ``its`` (n,) int32 steps taken. eps and far
    in world units. Returns the host syncs taken (the plain version's, on
    CPU tensors)."""
    launch, n = _check_state(grid, pos, dirs, {"acc": acc, "last_d": last_d, "active": active},
                             {"its": its})
    if not launch:
        return march_segment_plain(grid, pos, acc, last_d, active, its, dirs, eps, far, trips)
    if n == 0 or trips <= 0:
        return 0
    build.launch("sdf_march", pos.device, *grid_args(grid), pos.data_ptr(), acc.data_ptr(),
                 last_d.data_ptr(), active.data_ptr(), its.data_ptr(), dirs.data_ptr(), n,
                 float(np.float32(eps)), float(np.float32(far)), int(trips))
    build.count_launch(globals(), "launch_count")
    return 0


def beam_segment(grid: LeafGrid, pos, acc, active, dirs, r0, rd, margin: float,
                 far: float, trips: int) -> int:
    """K6: up to ``trips`` beam trips of the (n,) beam rays on the grid, in
    place: ``pos`` and ``dirs`` (n, 3), ``acc``, ``active``, the radius at
    the origin ``r0`` and its growth ``rd`` (n,) float32. margin and far
    in world units. Returns the host syncs taken (the plain version's)."""
    launch, n = _check_state(grid, pos, dirs,
                             {"acc": acc, "active": active, "r0": r0, "rd": rd}, {})
    if not launch:
        return beam_segment_plain(grid, pos, acc, active, dirs, r0, rd, margin, far, trips)
    if n == 0 or trips <= 0:
        return 0
    build.launch("sdf_beam", pos.device, *grid_args(grid), pos.data_ptr(), acc.data_ptr(),
                 active.data_ptr(), dirs.data_ptr(), r0.data_ptr(), rd.data_ptr(), n,
                 float(np.float32(margin)), float(np.float32(0.5 * margin)),
                 float(np.float32(far)), int(trips))
    build.count_launch(globals(), "beam_launch_count")
    return 0
