"""Batched sphere tracing over an octree SDF, in plain torch.

Port of the JAX package's ``render/sphere_trace.py`` (reference:
src/render_engine/shaders/sdfOctreeRender.comp:392-409 ``raycast``: march
while lastDistance > eps, accumulated distance < far and iterations <
MAX_ITERATIONS). Distances are evaluated in world space with eps and far
scaled by the box size, the reference's distanceScale = 1 / boxSize
(RenderSdf.cpp:127-128).

The march step is ``_grid_distance_and_step``: one row of the dense leaf
grid (the thin grid and the coefficient row its word names, where
``build_query_grid`` built it), the leaf polynomial or the box fallback,
and in cells flagged surface-free a step to the free-radius box exit. A
beam prepass starts every ray at a depth proven safe for its tile. Large
frames then march the JAX package's static pyramid of rounds over
shrinking prefixes (``_Frame``), with no host check: on the card one CUDA
graph a frame; small frames and ``pyramid=False`` march rounds over the
still-active rays, compacted between rounds with one host sync each. On
the card a round's march (every trip of its budget over a prefix) and the
beam prepass are one launch each of K5 and K6 (``ops/march.py``), and the
normals one of K4 (``ops/octree_query.py``); on the CPU, and on the walk
route, the same trips run as torch ops, which check for live rays
themselves (``ops.march._run_trips``).
"""
from __future__ import annotations

import threading
import warnings
from collections import OrderedDict
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..ops.march import (
    beam_segment,
    beam_segment_plain,
    beam_trips,
    march_segment,
    march_segment_plain,
    march_trips,
)
from ..ops.octree_query import grid_query, grid_query_plain
from ..sdf.octree import OctreeSdf, _octree_query
from ..sdf.sdf_function import resolve_device

__all__ = ["TraceResult", "sphere_trace", "trace_octree"]

# Trips of the first march round; each later round doubles, up to
# _MAX_ROUND_ITERS (the JAX dynamic scheduler's rounds).
_FIRST_ROUND_ITERS = 8
_MAX_ROUND_ITERS = 256
# Trip cap of the beam prepass.
_BEAM_ITERS = 256


class TraceResult(NamedTuple):
    hit: torch.Tensor         # (...,) bool
    position: torch.Tensor    # (..., 3) world hit position (last march point)
    depth: torch.Tensor       # (...,) accumulated world-space distance
    normal: torch.Tensor      # (..., 3) normalized SDF gradient at the hit
    iterations: torch.Tensor  # (...,) int32 march steps of each ray


def _march(segment, state, dirs, eps: float, far: float, trips: int):
    """``trips`` march steps of ``state`` = (pos, acc, last_d, active),
    active as float 0/1, by ``segment`` (pos, acc, last_d, active, its,
    dirs, eps, far, trips), which runs up to that many trips in place
    (``_Route.march``, ``march_trips``) and stops early as it does. Returns
    each ray's count of steps taken and the new state (new tensors: the
    inputs are not written)."""
    pos, acc, last_d, active = (x.clone(memory_format=torch.contiguous_format)
                                for x in state)
    its = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    segment(pos, acc, last_d, active, its, dirs, eps, far, trips)
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
    fixed_trips: bool = False,
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
    with an active ray is the largest count). The march checks for live
    rays as ``ops.march._run_trips`` does (on the card a host sync every
    16 trips) and stops once none is; ``fixed_trips=True`` runs exactly
    ``max_iters`` trips with no check, so no host sync; the state and the
    count are those of the early-exiting march."""
    pos = state[0]
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=pos.device)
    if distance_step_fn is None:
        def step_fn(p, _):
            d = distance_fn(p)
            return d, d.clamp_min(0.0)
    else:
        def step_fn(p, _):
            return distance_step_fn(p)
    its, state = _march(partial(march_trips, step_fn, exit_early=not fixed_trips), state,
                        dirs, eps, far, max_iters)
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


def _beam_prepass(beam, origins, dirs, r0, rd, margin: float, far: float,
                  max_iters: int = _BEAM_ITERS):
    """March one ray per tile by ``beam`` (pos, acc, active, dirs, r0, rd,
    margin, far, trips), which runs beam trips (``_beam_trip``) in place,
    and return its stopping depth. Every member ray stays within r(t) of
    the beam ray and the true SDF is 1-Lipschitz, so no member hits before
    that depth, where the members then start (the reference renderer's
    per-tile coherence, RenderSdf.cpp:187, as an explicit two-level
    schedule). ``beam`` stops early as ``_Route.beam`` does."""
    pos = origins.clone(memory_format=torch.contiguous_format)
    acc = torch.zeros_like(r0)
    active = torch.ones_like(r0)
    beam(pos, acc, active, dirs, r0, rd, margin, far, max_iters)
    return acc


class _Route(NamedTuple):
    march: object     # (pos, acc, last_d, active, its, dirs, eps, far, trips) -> syncs, in place
    beam: object      # (pos, acc, active, dirs, r0, rd, margin, far, trips) -> syncs, in place
    normals: object   # (pos, out=None) -> normalized gradient (into out[1])
    margin: float     # the beam's safety margin, world units
    kernel: bool      # the trips are K5/K6 launches (no host check: a frame is one graph)
    key: tuple        # the route and the arrays it reads


def _route(octree: OctreeSdf, eps: float) -> _Route:
    """The distance route of ``octree`` at hit threshold ``eps``
    (normalized): the thin leaf grid and the octree words it names if
    ``build_query_grid`` built it (L2-resident at d6 on an H100, where the
    fused rows, which hold the same values, are not), else the walk; the
    grid (and its free-cell steps) only for eps <=
    ``OctreeSdf._FREE_CELL_MARGIN``, the margin the free flags were proven
    with. On a grid the march and the beam are K5 and K6, each launch as
    many trips as it is given (a done ray leaves at once), in torch on the
    CPU or where ``octree._plain`` pins the plain versions; the walk runs
    its trips in torch, each trip's distance K10 on the card (the plain
    walk where ``_plain`` pins it). Torch trips check for live rays
    themselves (``ops.march._run_trips``). The normals ride the same rows
    (K4), else the walk. The beam's margin is the hit threshold plus a fit-error
    budget: the Lipschitz argument runs through the true distance, which
    the polynomial tracks within the build's termination threshold."""
    box_args = (octree._box_min, octree._box_size3)
    mbv = octree.min_border_value
    words = octree._octree_dev
    walk = dict(levels=octree.max_depth - octree.start_depth, fast=octree._fast_layout,
                num_coeff=octree.num_coefficients, interpolation=octree.interpolation)
    fat, thin = octree._fat_grid, octree._query_grid
    sgs, depth, plain = octree.start_grid_size, octree.max_depth, octree._plain
    shade = None if thin is None else octree._leaf_grid(False)
    grid = shade if eps <= OctreeSdf._FREE_CELL_MARGIN else None

    def distance(p):
        return _octree_query(words, p, *box_args, sgs, mbv, with_gradient=False, plain=plain,
                             **walk)

    if grid is not None:
        march = partial(march_segment_plain if plain else march_segment, grid)
        beam = partial(beam_segment_plain if plain else beam_segment, grid)
    else:
        def step(p, _):
            dist = distance(p)
            return dist, dist.clamp_min(0.0)

        def beam_step(p, _, shrink):
            dist = distance(p)
            return dist, torch.full_like(dist, -torch.inf)

        march = partial(march_trips, step, exit_early=True)
        beam = partial(beam_trips, beam_step, exit_early=True)

    def normals(pos, out=None):
        if shade is not None and not plain:
            # a frame's end points are coherent: neighbouring rays share
            # rows, which one thread a point reads with broadcast loads
            return grid_query(shade, pos, True, out, group=1)[1]
        g = (grid_query_plain(shade, pos, True) if shade is not None else
             _octree_query(words, pos, *box_args, sgs, mbv, with_gradient=True, plain=plain,
                           **walk))[1]
        return g if out is None else out[1].copy_(g)

    box_size = float(octree.box.size[0])
    margin = eps * box_size + 4.0 * octree.termination_threshold
    # what the closures read: the arrays by address (a frame holds its
    # route, so an address names one array while the frame is cached)
    # and the scalars
    arrays = tuple(None if a is None else (a.device, a.data_ptr(), tuple(a.shape))
                   for a in (words, fat, thin, *box_args))
    kernel = grid is not None and not plain
    key = (arrays, grid is not None, plain, mbv, margin, sgs, depth,
           tuple(sorted(walk.items())))
    return _Route(march, beam, normals, margin, kernel, key)


# -- the whole-frame trace: the static pyramid --------------------------------

# Rays a march block holds in the JAX package (a TPU VMEM unit); here it
# only rounds the pyramid's prefixes, and pads a frame to whole blocks.
_TRACE_BLOCK = 1 << 17
# Frames of at least this many (padded) rays and trips take the pyramid.
_PYRAMID_MIN_RAYS = 1 << 15
_PYRAMID_MIN_ITERS = 64
# The compaction's width floor over the marched prefix, so that actives
# beyond the prefix keep draining into the later rounds.
_SORT_FLOOR = 1 << 15
# Frames (fixed buffers and captured graphs) kept on one card.
_MAX_FRAMES = 4


def _build_pyramid_schedule(
    Rp: int, max_iters: int, B: int, dense: bool = False
) -> tuple:
    """Static ((iters, prefix), ...) pyramid, the JAX package's: rounds
    grow geometrically in iterations (8, 16, ... 256) while their
    prefixes shrink with the measured geometric decay of active rays.

    dense=True slows the prefix shrink, for beam-less traces: without the
    prepass most rays are still marching the empty-space approach after
    the first rounds. Both pad tail rounds at the final divisor until the
    whole iteration budget is covered: a padded round is a small prefix,
    and every ray it retires skips the full-width straggler march."""
    divs = (1, 1, 2, 4, 8, 16, 32, 64) if dense else (1, 8, 32, 128, 256, 512)
    schedule = []
    k, rem = min(_FIRST_ROUND_ITERS, max_iters), max_iters
    i = 0
    while rem > 0:
        div = divs[min(i, len(divs) - 1)]
        nbk = max(Rp // div, min(1 << 10, Rp))
        if nbk >= B:
            nbk = min(-(-nbk // B) * B, Rp)   # whole B-blocks
        else:
            nbk = 1 << (max(nbk - 1, 1)).bit_length()  # pow2 <= B
        schedule.append((min(k, rem), nbk))
        rem -= k
        k = min(k * 2, _MAX_ROUND_ITERS)
        i += 1
    return tuple(schedule)


def _compact(active, tensors, W: int) -> None:
    """Stable two-way partition of the first W rows of ``tensors`` in
    place: the rows whose ``active`` > 0 first, each group in its order
    (the JAX package's stable sort on the key active <= 0). An active row
    goes to its count of actives up to it, less one; an inactive row
    after all actives, at its count of inactives up to it, less one."""
    a = active[:W] > 0
    before = a.cumsum(0)
    dest = torch.where(a, before - 1,
                       before[-1] + torch.arange(W, device=a.device) - before)
    for x in tensors:
        head = x[:W]
        head.copy_(torch.empty_like(head).index_copy_(0, dest, head))


class _Runner:
    """Runs a frame's work, a function that writes the frame's fixed
    buffers in place: eagerly, or (``graphs``) as a CUDA graph captured at
    its first run and replayed from then on. A first run is the capture's
    warm-up: the work runs eagerly on a side stream, and that run is the
    frame's; then its kernels are recorded without running. A host sync or
    a host-to-device copy inside the work makes the capture raise, as does
    a capture that records nothing. Made on the frame's card
    (``torch.cuda.graph``'s default capture stream sits on the card of its
    first use). Counts what it did since ``reset``, and the host syncs the
    work reports.

    ``parallel`` traces several cards at once from worker threads, so a
    capture is thread-local (another thread's host syncs and allocations
    neither break it nor fail), and one capture runs at a time in the
    process (``_CAPTURE_LOCK``): entering one synchronises its card and
    empties the allocator's cache of every card."""

    def __init__(self, graphs: bool):
        self.graphs, self.graph = graphs, None
        if graphs:
            self.side = torch.cuda.Stream()
            self.capture = torch.cuda.Stream()
        self.reset()

    def reset(self) -> None:
        self.captured = self.replayed = self.syncs = 0

    def __call__(self, work) -> None:
        if not self.graphs:
            work()
            return
        if self.graph is not None:
            self.graph.replay()
            self.replayed += 1
            return
        stream = torch.cuda.current_stream()
        self.side.wait_stream(stream)
        with torch.cuda.stream(self.side):
            work()
        stream.wait_stream(self.side)
        graph = torch.cuda.CUDAGraph()
        with warnings.catch_warnings():
            # an empty graph: the work's kernels went to another stream
            warnings.filterwarnings("error", "The CUDA Graph is empty")
            with _CAPTURE_LOCK, torch.cuda.graph(graph, stream=self.capture,
                                                 capture_error_mode="thread_local"):
                work()
        self.graph = graph
        self.captured += 1


class _Frame:
    """The whole-frame trace of one ray count (the JAX package's
    ``_trace_rays_fused``) over fixed buffers, in a fixed order with no
    host check: the beam prepass, the static pyramid of march rounds over
    shrinking prefixes with a compaction of the active rays to the front
    after each, a full-width straggler march, the unsort and the normals.
    On a kernel route the frame is one piece, on the card one CUDA graph
    replayed with one launch.

    The rays are padded to ``Rp``: a padding ray points along unit x and
    starts inactive. The beam prepass runs its ``_BEAM_ITERS`` trips as
    one K6 launch. A round marches the prefix ``[:n]`` for its trips as
    one K5 launch: a ray that is done leaves the kernel at once, so the
    round ends with its longest ray, as the JAX while_loop exits. Then each
    ray's count is added at ``perm[:n]`` and the first W rows compacted: W
    is the prefix with a floor of ``_SORT_FLOOR``, and ``Rp`` on the last
    round so that every active ray sits at the front. The straggler march
    gives every ray still active the budget of all rounds but the first (a
    ray that overflowed every prefix was only offered the first), over the
    full width as in the JAX march: the rows past the active ones leave at
    once. Torch trips (the CPU, the plain versions, the walk route) stop
    once no ray is active (``ops.march._run_trips``), so on the card they
    take host syncs and the frame runs eagerly. A ray's march depends on the ray
    alone, so a ray that converges within its budget ends where the round
    scheduler of ``trace_octree(pyramid=False)`` ends it, in as many steps.
    The B-ray blocks of the JAX march (TPU VMEM units) are not carried: a
    prefix marches as one batch, and B only rounds the schedule's
    prefixes."""

    def __init__(self, octree: OctreeSdf, shape, R: int, Rp: int, B: int, *, eps: float,
                 far: float, max_iters: int, beam, graphs: bool):
        dev = octree.device
        box_size = float(octree.box.size[0])
        self.R, self.Rp, self.shape, self.beam = R, Rp, tuple(shape), beam
        self.eps_w = float(np.float32(eps) * np.float32(box_size))
        self.far_w = float(np.float32(far) * np.float32(box_size))
        self.beam_far = far * box_size
        self.route = _route(octree, eps)
        self.beam_on = beam is not None and R >= beam * beam
        self.schedule, self.remaining = (), max_iters
        if Rp >= _PYRAMID_MIN_RAYS and max_iters >= _PYRAMID_MIN_ITERS:
            self.schedule = _build_pyramid_schedule(Rp, max_iters, B, dense=not self.beam_on)
            self.remaining = max(max_iters - self.schedule[0][0], 0)
        # the ray-trips the frame offers its rays (a done ray takes none)
        self.offered = sum(k * n for k, n in self.schedule) + Rp * self.remaining

        def f32(*size):
            return torch.zeros(size, dtype=torch.float32, device=dev)

        self.o_in, self.d_in, self.live_in = f32(R, 3), f32(R, 3), f32(R)
        self.pos, self.dirs, self.out_pos = f32(Rp, 3), f32(Rp, 3), f32(Rp, 3)
        self.acc, self.last_d, self.active = f32(Rp), f32(Rp), f32(Rp)
        self.out_acc, self.out_last, self.out_normal = f32(Rp), f32(Rp), f32(R, 3)
        self.out_d = f32(R)      # the normals' distances, unused
        self.out_hit = torch.zeros(R, dtype=torch.bool, device=dev)
        self.perm = torch.arange(Rp, device=dev)
        self.iters = torch.zeros(Rp, dtype=torch.int32, device=dev)
        self.its = torch.zeros_like(self.iters)
        if self.beam_on:
            o_t, _, _, self.per_ray = _beam_tiles(self.o_in, self.d_in, self.shape, beam)
            nt = o_t.shape[0]
            self.b_pos, self.b_dirs = f32(nt, 3), f32(nt, 3)
            self.b_r0, self.b_rd, self.b_acc, self.b_active = f32(nt), f32(nt), f32(nt), f32(nt)
        self.runner = _Runner(graphs)

    # -- the pieces ----------------------------------------------------------

    def _setup(self) -> None:
        R = self.R
        self.dirs[:R].copy_(self.d_in)
        self.dirs[R:].zero_()
        self.dirs[R:, 0].fill_(1.0)
        if self.beam_on:
            o_t, d_t, mask, _ = _beam_tiles(self.o_in, self.d_in, self.shape, self.beam)
            for buf, val in zip((self.b_pos, self.b_dirs, self.b_r0, self.b_rd),
                                _beam_setup(o_t, d_t, mask)):
                buf.copy_(val)
            self.b_acc.zero_()
            self.b_active.fill_(1.0)

    def _beam_prepass(self) -> None:
        self.runner.syncs += self.route.beam(
            self.b_pos, self.b_acc, self.b_active, self.b_dirs, self.b_r0, self.b_rd,
            self.route.margin, self.beam_far, _BEAM_ITERS)

    def _start(self) -> None:
        R = self.R
        if self.beam_on:
            start_t = self.per_ray(self.b_acc)
        else:
            start_t = torch.zeros_like(self.live_in)
        self.pos[:R].copy_(self.o_in + self.d_in * start_t[:, None])
        self.pos[R:].zero_()
        self.acc[:R].copy_(start_t)
        self.acc[R:].zero_()
        self.last_d.fill_(torch.inf)
        self.active[:R].copy_(self.live_in)
        self.active[R:].zero_()
        self.perm.copy_(torch.arange(self.Rp, device=self.perm.device))
        self.iters.zero_()
        self.its.zero_()

    def _march(self, n: int, trips: int) -> None:
        """Every trip of a round's budget over the prefix ``[:n]``."""
        self.runner.syncs += self.route.march(
            self.pos[:n], self.acc[:n], self.last_d[:n], self.active[:n], self.its[:n],
            self.dirs[:n], self.eps_w, self.far_w, trips)

    def _round_end(self, n: int, W: int) -> None:
        self.iters.index_add_(0, self.perm[:n], self.its[:n])
        self.its[:n].zero_()
        _compact(self.active, (self.pos, self.acc, self.last_d, self.active, self.dirs,
                               self.perm), W)

    def _finish(self) -> None:
        R = self.R
        self.iters.index_add_(0, self.perm, self.its)    # the straggler march's steps
        for src, dst in ((self.pos, self.out_pos), (self.acc, self.out_acc),
                         (self.last_d, self.out_last)):
            dst.index_copy_(0, self.perm, src)
        torch.le(self.out_last[:R], self.eps_w, out=self.out_hit)
        self.route.normals(self.out_pos[:R], (self.out_d, self.out_normal))

    def _frame(self) -> None:
        """Every piece in order: the runner's work."""
        self._setup()
        if self.beam_on:
            self._beam_prepass()
        self._start()
        for i, (k, n) in enumerate(self.schedule):
            W = self.Rp if i == len(self.schedule) - 1 else min(self.Rp, max(n, _SORT_FLOOR))
            self._march(n, k)
            self._round_end(n, W)
        if self.remaining:
            self._march(self.Rp, self.remaining)
        self._finish()

    def run(self, o, d, live):
        """The frame of (R, 3) rays ``o``, ``d`` whose ``live`` (R,) flag
        is 1.0: (hit, position, depth, normal, iterations), flat, in new
        tensors."""
        self.runner.reset()
        self.o_in.copy_(o)
        self.d_in.copy_(d)
        self.live_in.copy_(live)
        self.runner(self._frame)
        R = self.R
        return (self.out_hit.clone(), self.out_pos[:R].clone(), self.out_acc[:R].clone(),
                self.out_normal.clone(), self.iters[:R].clone())


class _FrameCache:
    """The idle frames traced on each card, at most ``_MAX_FRAMES`` a card,
    the most recently used key last, keyed by their shape, knobs and
    route key. A structure with new grids (``build_query_grid``), another
    structure or a replica on another card keys new frames; a dropped
    structure's frames stay until evicted. A frame is out of the cache
    while it runs (``take``, then ``put`` back), so two threads never
    share one: a second thread with the same key (two workers on one
    card) makes a twin, and both stay under the key."""

    def __init__(self):
        self.frames: dict = {}    # device -> OrderedDict(key -> [idle _Frame])
        self._lock = threading.Lock()

    def take(self, device, key, make) -> _Frame:
        """An idle frame of ``key`` on ``device``, else ``make()``."""
        with self._lock:
            idle = self.frames.get(device, {}).get(key)
            if idle:
                frame = idle.pop()
                if not idle:
                    del self.frames[device][key]
                return frame
        return make()

    def put(self, device, key, frame: _Frame) -> None:
        """Return a frame that ran to its end; the card's least recently
        used frames go past ``_MAX_FRAMES``."""
        dropped = []
        with self._lock:
            frames = self.frames.setdefault(device, OrderedDict())
            frames.setdefault(key, []).append(frame)
            frames.move_to_end(key)
            while sum(map(len, frames.values())) > _MAX_FRAMES:
                old_key, old = next(iter(frames.items()))
                dropped.append(old.pop(0))
                if not old:
                    del frames[old_key]
        if dropped and device.type == "cuda":
            # a replay still queued reads the buffers and graph dropped here;
            # no capture runs while the card drains
            with _CAPTURE_LOCK:
                torch.cuda.synchronize(device)


_FRAMES = _FrameCache()
_CAPTURE_LOCK = threading.Lock()


def _trace_rays(octree: OctreeSdf, o, d, live, shape, *, eps: float, far: float,
                max_iters: int, B: int, beam, graphs: bool, stats_out: dict | None = None):
    """The whole-frame trace (``_Frame``) of (R, 3) rays on the octree's
    device, padded to whole B-blocks; ``live`` (R,) float marks the rays
    that march. With ``graphs`` (a CUDA octree on a kernel route) the frame
    runs as one CUDA graph on the rays' card, captured on its first call
    and replayed on later ones with the same key (``_FRAMES``); else
    eagerly. Returns the flat outputs of ``_Frame.run``."""
    R = o.shape[0]
    Rp = -(-R // B) * B
    route = _route(octree, eps)
    graphs = graphs and route.kernel

    def make():
        return _Frame(octree, shape, R, Rp, B, eps=eps, far=far, max_iters=max_iters,
                      beam=beam, graphs=graphs)

    if graphs:
        # the shape matters only to the beam's tiles
        tiles = tuple(shape) if beam is not None and R >= beam * beam else None
        key = (R, tiles, Rp, B, eps, far, max_iters, beam, route.key)
        # the side stream, the capture and the replays belong to the
        # octree's card, whichever card is current
        with torch.cuda.device(o.device):
            frame = _FRAMES.take(o.device, key, make)
            out = frame.run(o, d, live)
    else:
        frame = make()
        out = frame.run(o, d, live)
    if stats_out is not None:
        run = frame.runner
        stats_out.update(
            rounds=[("pyramid", frame.schedule, 0)],
            graphs_captured=run.captured, graphs_replayed=run.replayed,
            host_syncs=run.syncs, marched_ray_trips=frame.offered,
        )
    if graphs:
        _FRAMES.put(o.device, key, frame)
    return out


# -- the entry ----------------------------------------------------------------


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
    reference shader. The distance route and the normals: ``_route``.

    Schedule: a beam prepass (one radius-widened ray per beam x beam
    tile: pixel tiles for (H, W, 3) inputs whose sides beam divides, runs
    of beam^2 consecutive rays otherwise; ``beam=None`` disables it) gives
    each ray a safe start depth. A frame of at least 2^15 rays, padded to
    whole blocks of ``block_size`` (default 2^17, at most the ray count),
    with ``max_iters`` >= 64 then marches the JAX package's static
    pyramid (``_Frame``) with no host check: on a CUDA octree's grid as
    one captured CUDA graph, replayed with one launch and kept for later
    frames of the same shape on the same structure (at most four a card);
    on the CPU, the walk route and the pinned plain versions eagerly.
    ``stats_out["rounds"]`` receives ``[("pyramid", schedule, 0)]``, and
    ``graphs_captured``, ``graphs_replayed``, ``host_syncs`` (those of
    torch trips on the card) and ``marched_ray_trips`` (the ray-trips the
    frame offers) what the frame did. Smaller frames and ``pyramid=False``
    take the dynamic scheduler: rounds of 8, 16, ... up to 256 trips over
    the rays still active, each round ending with one host sync (the
    active count) and one compaction of the active rays to the front;
    ``stats_out["rounds"]`` receives (iters, marched, still_active) per
    round. Both give the same hits, depths and iterations for every ray
    that converges within ``max_iters``.

    ``iterations`` is each ray's own count of march steps, as the
    reference shader's heatmap shows it. ``active`` (one bool a ray,
    default all) marks the rays that march; the others keep their
    origin, depth 0 and no hit (``parallel.sharded_trace``'s padding)."""
    return _trace(octree, origins, dirs, eps=eps, far=far, max_iters=max_iters,
                  block_size=block_size, beam=beam, pyramid=pyramid, stats_out=stats_out,
                  active=active, graphs=octree.device.type == "cuda")


def _trace(octree: OctreeSdf, origins, dirs, *, eps, far, max_iters, block_size, beam,
           pyramid, stats_out, active, graphs: bool) -> TraceResult:
    """``trace_octree`` with the pyramid's ``graphs`` given: False runs
    its eager schedule on a CUDA octree too, which the card's tests hold
    the graphs against."""
    dev = octree.device
    origins = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    shape = origins.shape
    o = origins.reshape(-1, 3).contiguous()
    d = dirs.reshape(-1, 3).contiguous()
    R = o.shape[0]
    live = (torch.ones(R, device=dev) if active is None
            else torch.as_tensor(active, device=dev).reshape(R).to(torch.float32).contiguous())
    B = min(block_size or _TRACE_BLOCK, max(R, 1))
    if pyramid and -(-R // B) * B >= _PYRAMID_MIN_RAYS and max_iters >= _PYRAMID_MIN_ITERS:
        out = _trace_rays(octree, o, d, live, shape, eps=eps, far=far, max_iters=max_iters,
                          B=B, beam=beam, graphs=graphs, stats_out=stats_out)
    else:
        out = _trace_dynamic(octree, o, d, live, shape, eps=eps, far=far,
                             max_iters=max_iters, beam=beam, stats_out=stats_out)
    lead = shape[:-1]
    return TraceResult(*(x.reshape(lead + x.shape[1:]) for x in out))


def _trace_dynamic(octree: OctreeSdf, o, d, live, shape, *, eps: float, far: float,
                   max_iters: int, beam, stats_out: dict | None):
    """The dynamic scheduler of (R, 3) rays (``trace_octree``): the beam
    prepass, then rounds over the compacted active rays, one host sync a
    round. Returns the flat outputs."""
    dev = octree.device
    R = o.shape[0]
    box_size = float(octree.box.size[0])
    eps_w = float(np.float32(eps) * np.float32(box_size))
    far_w = float(np.float32(far) * np.float32(box_size))
    route = _route(octree, eps)

    start_t = torch.zeros(R, dtype=torch.float32, device=dev)
    if beam is not None and R >= beam * beam:
        o_t, d_t, mask, per_ray = _beam_tiles(o, d, shape, beam)
        o_c, d_c, r0, rd = _beam_setup(o_t, d_t, mask)
        start_t = per_ray(_beam_prepass(route.beam, o_c, d_c, r0, rd, route.margin,
                                        far * box_size))

    # The frame's state (tensors of this call, never the caller's), written
    # back in place after each round; a round marches the compacted active
    # rays only, through new tensors.
    pos = o + d * start_t[:, None]
    acc = start_t
    last_d = torch.full((R,), torch.inf, device=dev)
    iterations = torch.zeros(R, dtype=torch.int32, device=dev)
    cur = torch.arange(R, device=dev)
    sub = (pos, acc, last_d, live)
    sub_dirs = d
    n_cur, remaining = R, max_iters
    round_iters = min(_FIRST_ROUND_ITERS, max_iters)
    rounds_log = []
    while remaining > 0 and n_cur > 0:
        k = min(round_iters, remaining)
        its, sub = _march(route.march, sub, sub_dirs, eps_w, far_w, k)
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
    return last_d <= eps_w, pos, acc, route.normals(pos), iterations
