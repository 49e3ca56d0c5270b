"""K10-K15: the approximate octree's walk over a given coefficient
tensor, its backward, the generic march over it, and the sphere tracer's
march and beam segments over it.

The walk (OctreeSdf.cpp:93-152) takes a point's start-grid cell and up to
``levels`` descents to its leaf, then the leaf polynomial; a ``Walk``
names what it reads: the int32 octree words, which hold the topology, and
a float32 coefficient tensor of the same length (the words' float32 view
for ``OctreeSdf`` queries, the trainable tensor for ``diff``).

* ``walk_query`` (K10, ``csrc/octree_walk.cu`` ``walk_query_kernel``): the
  distance, with the normalised gradient of ``OctreeSdf`` queries or with
  the diff query's world gradient; each lane walks its point and the warp
  reads its points' aligned tricubic rows ``group`` lanes a row (8 for the
  distance, 4 with a gradient). Replaces sdflib_tpu/sdf/octree.py
  ``_octree_query`` (:56) and the forward of sdflib_tpu/diff/query.py
  ``octree_query_diff`` (:43).
* ``walk_backward`` (K11): the coefficient gradient of upstream ``gd``
  (and ``gg`` of the world gradient), and the point gradient. Replaces
  XLA's transpose of the row gather (sdflib_tpu/diff/query.py:108) and the
  polynomial's VJP. On the aligned layout three steps on the device with
  no host read: ``walk_keys`` (``walk_key_kernel``: each point's row and
  share, and the point gradient), the leaf sort of the keys
  (``exact_query.launch_leaf_sort``, given keys) and ``walk_reduce``
  (``walk_reduce_kernel`` and ``walk_reduce_span_kernel``: each row's sum
  in an order fixed by the sorted order and by tiles that depend on P
  alone, stored once). On the word-by-word layout ``walk_backward_kernel``
  adds by scalar fp32 atomics.
* ``walk_march`` (K12, ``walk_march_warps_kernel``): the generic sphere
  trace (step max(d, 0)) over the walk's distance, every trip of every ray
  in one launch of persistent warps that hand a finished lane the next
  ray of the warp's chunk from a ray counter (8 x 4 pixel tiles of an
  image of rays); a lane folds its aligned tricubic row a quad at a time.
  The same bits as one thread a ray (``walk_march_one_thread``, the
  reference). Replaces sdflib_tpu/render/sphere_trace.py ``sphere_trace``
  (:251) as sdflib_tpu/diff/render.py (:65-68) calls it.
* ``walk_segment`` (K14, ``walk_segment_kernel``) and ``walk_beam`` (K15,
  ``walk_beam_kernel``): the tracer's walk route (``render/sphere_trace.py``
  ``_route`` with no query grid), up to ``trips`` march or beam trips of
  each ray of the frame's state in place, one thread a ray, a done ray
  leaving at once: K5 and K6 (``ops/march.py``) over K12's distance.
  A narrow K14 launch takes the group form (``walk_segment_group_kernel``,
  ``segment_form``): 8 lanes a ray, which sum its row by shuffles
  and keep it while the ray stays in its leaf, the same bits. Replace
  ``_march_pyramid_jit``'s trips (sdflib_tpu/render/sphere_trace.py :411
  over :304-311) and the walk branch of ``_beam_prepass_jit`` (:541,
  :588-594).

Each wrapper launches its kernel for CUDA tensors and takes its plain
torch version (``walk_query_plain``, ``walk_keys_plain``,
``walk_reduce_plain``, ``walk_backward_plain``, ``walk_march_plain``,
``walk_segment_plain``, ``walk_beam_plain``) for CPU tensors. The
counters: ``launch_count`` (K10), ``backward_launch_count``
(K11 as a whole, one a backward on either layout), ``key_launch_count``,
``sort_launch_count`` (K11's leaf sort: its memset and launches are one
call), ``reduce_launch_count`` (its two launches are one call),
``march_launch_count``, ``segment_launch_count`` (K14 in either form),
``segment_group_launch_count`` (K14's group form) and
``beam_launch_count`` (K15).
The kernels have no autograd: ``walk_query`` raises for points or
coefficients that require a gradient. ``WalkQuery``, the autograd
Function of ``diff/query.py`` and of ``OctreeSdf`` distances of points
that require a gradient, pairs K10 with K11; a second derivative takes
autograd of the plain version.

K11's coefficient gradient on the aligned layout is the same bits from run
to run (``walk_reduce_plain`` repeats its order bit for bit) and agrees
with ``walk_backward_plain``'s ``index_add_``, the function's definition
and what the CPU runs, to fp32 rounding of each row's sum (1e-5 of the
largest). On the word-by-word layout its atomics add in an order that
changes from run to run.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..kernels import build
from .box import box_distance
from .exact_query import launch_leaf_sort, sort_bits
from .interpolation import _deriv_power_vectors, _monomials, _power_vectors, gradient_at
from .march import _check_rays, beam_trips, march_trips
from .octree_query import _CIDX, _coeff_rows, _f32, _finish, _need

__all__ = [
    "Walk", "MODES", "GROUPS", "REDUCE_TILE", "reduce_plan", "walk_query", "walk_query_plain",
    "walk_keys", "walk_keys_plain", "walk_reduce", "walk_reduce_plain", "walk_backward",
    "walk_backward_plain", "walk_march", "walk_march_plain", "walk_march_one_thread",
    "walk_segment", "walk_segment_plain", "walk_beam", "walk_beam_plain", "SEGMENT_FORMS",
    "GROUP_LANES", "segment_form",
    "WalkQuery", "launch_count", "backward_launch_count", "key_launch_count",
    "sort_launch_count", "reduce_launch_count", "march_launch_count",
    "segment_launch_count", "segment_group_launch_count", "beam_launch_count",
]

launch_count = 0
backward_launch_count = 0
key_launch_count = 0
sort_launch_count = 0
reduce_launch_count = 0
march_launch_count = 0
segment_launch_count = 0
segment_group_launch_count = 0
beam_launch_count = 0
# What a query returns besides the distance: nothing, the normalised
# gradient (OctreeSdf.get_distance_and_gradient) or the world gradient
# (octree_query_diff's with_gradient); the kernel's mode is the index.
MODES = ("distance", "normal", "world")
# K10's lanes a row of the aligned tricubic layout, by mode (K4's sizes;
# 1: one lane reads its own row, as K12 does)
GROUPS = {"distance": 8, "normal": 4, "world": 4}
REDUCE_TILE = 1024      # sorted points a block of K11's reduction (kTile)
# K14's forms: 1, one thread a ray, or 8 lanes a ray on the aligned
# tricubic rows (walk_segment_group_kernel). The plan gives a launch the
# group where its lanes, over all its rays, stay within GROUP_LANES, else
# one thread a ray: in the walk frames timed (256^2-1024^2 rays, with
# beams and without), every launch that width or narrower with a live ray
# ran faster in groups, at budgets of 16-256 trips (PERF.md, K14).
SEGMENT_FORMS = (1, 8)
GROUP_LANES = 1 << 16
_THREADS = 256          # threads a block of it (kThreads)


class Walk(NamedTuple):
    """What the walk reads."""
    words: torch.Tensor          # (W,) int32 octree words (leaf bit = sign)
    coeffs: torch.Tensor         # (W,) float32 coefficients
    box_min: torch.Tensor        # (3,) float32
    box_size3: torch.Tensor      # (3,) float32
    min_border: float            # min_border_value, added to the box distance
    start_grid_size: int         # s: the s^3 start words, z-major
    levels: int                  # descents at most below the start grid
    num_coeff: int               # 64 tricubic, 8 trilinear
    interpolation: str
    fast: bool                   # the aligned layout the builders emit


def _descend(octree_i32, points, box_min, box_size3, start_grid_size: int, *, levels: int,
             fast: bool = True):
    """The walk's descent (OctreeSdf.cpp:93-152) of (P, 3) points: (the
    reached word, the position in the leaf in [0, 1)^3, in-box flags,
    descent steps below the start grid). The position carries the points'
    autograd graph: its integer offsets are detached, so its derivative is
    2^steps / cell, as in the JAX package. The aligned layout reads each
    node as an 8-word row and picks the child in it. In-box flags come from
    float comparisons (a NaN point lies outside, on every device); a point
    outside walks from the start cell nearest to it."""
    pts = points
    s = start_grid_size
    cell = box_size3 / s
    frac = (pts - box_min) / cell
    fl = frac.detach().floor()
    in_box = ((fl >= 0) & (fl < s)).all(dim=-1)
    # the start cell's offset converted as XLA converts it (saturating at
    # +-2^31, NaN to 0), in float arithmetic so that every device walks
    # a non-finite point to the same leaf; fl itself inside the box
    ipos = torch.nan_to_num(fl, nan=0.0).clamp(-2.0**31, 2.0**31)
    frac = frac - ipos
    ic = ipos.clamp(0, s - 1).long()
    node_idx = ic[..., 2] * (s * s) + ic[..., 1] * s + ic[..., 0]

    if fast:
        view8 = octree_i32.view(-1, 8)
        word = view8[node_idx >> 3].gather(-1, (node_idx & 7)[..., None])[..., 0]
    else:
        word = octree_i32[node_idx]

    steps = torch.zeros(word.shape, dtype=torch.int32, device=word.device)
    for _ in range(levels):
        is_leaf = word < 0                                   # bit 31
        fs = frac.detach()
        # roundFloat: >= 0.5 (OctreeSdf.cpp:88-91)
        child = (
            ((fs[..., 2] >= 0.5).long() << 2)
            + ((fs[..., 1] >= 0.5).long() << 1)
            + (fs[..., 0] >= 0.5).long()
        )
        base = (word & _CIDX).long()
        if fast:
            # children blocks are 8-aligned: one row gather + in-row pick
            nxt = view8[base >> 3].gather(-1, child[..., None])[..., 0]
        else:
            nxt = octree_i32[base + child]
        nfrac = 2.0 * frac
        nfrac = nfrac - nfrac.detach().floor()
        word = torch.where(is_leaf, word, nxt)
        frac = torch.where(is_leaf[..., None], frac, nfrac)
        steps = steps + (~is_leaf).to(torch.int32)
    return word, frac, in_box, steps


def _leaf_coeffs(octree_i32, word, num_coeff: int, fast: bool, coeffs_f32=None):
    """The reached leaves' coefficients (P, num_coeff), from ``coeffs_f32``
    or the words' float32 view: one aligned row each, or at base + j."""
    if fast:
        return _coeff_rows(octree_i32, word, num_coeff, coeffs_f32)
    base = (word & _CIDX).long()
    flat = octree_i32.view(torch.float32) if coeffs_f32 is None else coeffs_f32
    return flat[base[..., None] + torch.arange(num_coeff, device=word.device)]


def _octree_walk(octree_i32, points, box_min, box_size3, start_grid_size: int, *,
                 levels: int, num_coeff: int, fast: bool = True, coeffs_f32=None):
    """``_descend``, then the reached leaf's coefficients: (coefficients
    (P, num_coeff), position in the leaf, in-box flags, steps).
    Coefficients come from ``coeffs_f32`` when given (a flat float32
    tensor of the words' length), else from the float32 view of the
    words."""
    word, frac, in_box, steps = _descend(octree_i32, points, box_min, box_size3,
                                         start_grid_size, levels=levels, fast=fast)
    return _leaf_coeffs(octree_i32, word, num_coeff, fast, coeffs_f32), frac, in_box, steps


def _leaf_size(walk: Walk, steps):
    """The reached leaf's edge, cell / 2^steps."""
    return (walk.box_size3[0] / walk.start_grid_size) / torch.exp2(steps.to(torch.float32))


def walk_query_plain(walk: Walk, points, mode: str):
    """The walk in torch, on any device and differentiable (autograd
    through the points and the coefficients): d (P,) of (P, 3) points, and
    for ``mode`` "normal" or "world" (d, g (P, 3)). "normal": _finish's
    normalised gradient inside the box, the box gradient outside; "world":
    the polynomial's gradient times 2^steps / cell, 0 outside."""
    coeffs, frac, in_box, steps = _octree_walk(
        walk.words, points, walk.box_min, walk.box_size3, walk.start_grid_size,
        levels=walk.levels, num_coeff=walk.num_coeff, fast=walk.fast, coeffs_f32=walk.coeffs)
    if mode != "world":
        return _finish(points, coeffs, frac, in_box, walk.box_min, walk.box_size3,
                       walk.min_border, walk.interpolation, mode == "normal")
    d = _finish(points, coeffs, frac, in_box, walk.box_min, walk.box_size3, walk.min_border,
                walk.interpolation, False)
    g = gradient_at(coeffs, frac, walk.interpolation) / _leaf_size(walk, steps)[..., None]
    return d, torch.where(in_box[..., None], g, torch.zeros_like(g))


def check_walk(walk: Walk, device) -> bool:
    """Raise unless ``walk`` is a walk on ``device`` that the kernels
    read; True on a CUDA device (launch), False on the CPU (plain)."""
    nc = {"tricubic": 64, "trilinear": 8}.get(walk.interpolation)
    _need(nc is not None and walk.num_coeff == nc,
          f"{walk.interpolation!r} leaves with {walk.num_coeff} coefficients")
    w, c = walk.words, walk.coeffs
    _need(isinstance(w, torch.Tensor) and w.dtype == torch.int32 and w.ndim == 1
          and w.numel() < 2**31, "words must be a (W,) int32 tensor, W < 2^31")
    _need(w.device == device, f"words lie on {w.device}, not on {device}")
    _need(w.is_contiguous(), "words must be contiguous")
    _need(not walk.fast or w.numel() % 8 == 0, "the aligned layout has whole 8-word rows")
    _f32(c, (w.numel(),), "coeffs", device)
    _f32(walk.box_min, (3,), "box_min", device)
    _f32(walk.box_size3, (3,), "box_size3", device)
    _need(int(walk.start_grid_size) >= 1, "start_grid_size must be positive")
    _need(0 <= int(walk.levels) <= 30, "levels must lie in [0, 30]")
    if device.type == "cpu":
        return False
    _need(device.type == "cuda", f"unsupported device {device}")
    # K10 reads aligned coefficient rows as float4
    _need(not walk.fast or c.data_ptr() % 16 == 0,
          "the aligned layout needs 16-byte aligned coefficients")
    return True


def walk_args(walk: Walk) -> tuple:
    """The kernels' leading arguments: words, coefficients, W, start grid
    size, levels, tricubic, fast, box_min, box_size3, min_border."""
    return (walk.words.data_ptr(), walk.coeffs.data_ptr(), walk.words.numel(),
            int(walk.start_grid_size), int(walk.levels), int(walk.interpolation == "tricubic"),
            int(bool(walk.fast)), walk.box_min.data_ptr(), walk.box_size3.data_ptr(),
            float(np.float32(walk.min_border)))


def _no_graph(*tensors) -> None:
    _need(not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)),
          "the walk kernels have no autograd: take walk_query_plain, or the Function "
          "of diff/query.py")


def walk_query(walk: Walk, points, mode: str, group: int | None = None, out=None):
    """K10: ``walk_query_plain``'s d (P,), or (d, g (P, 3)), of contiguous
    (P, 3) float32 points on the walk's device: the kernel on the card,
    the plain version on the CPU. ``group``: the lanes that read an aligned
    tricubic row, 1, 4 or 8 (default ``GROUPS[mode]``); every size gives
    the same bits. ``out``, if given, holds the outputs' tensors (d, or
    (d, g)) to write in place, as a captured frame needs."""
    _need(mode in MODES, f"mode must be one of {MODES}")
    group = GROUPS[mode] if group is None else group
    _need(group in (1, 4, 8), "group must be 1, 4 or 8")
    _need(isinstance(points, torch.Tensor), "points must be a tensor")
    _f32(points, (None, 3), "points", points.device)
    n = points.shape[0]
    if out is not None:
        _f32(out if mode == "distance" else out[0], (n,), "d", points.device)
        if mode != "distance":
            _f32(out[1], (n, 3), "g", points.device)
    if not check_walk(walk, points.device):
        res = walk_query_plain(walk, points, mode)
        if out is None:
            return res
        for dst, src in ((out, res),) if mode == "distance" else zip(out, res):
            dst.copy_(src)
        return out
    _no_graph(points, walk.coeffs)
    if out is None:
        d = torch.empty(n, dtype=torch.float32, device=points.device)
        g = None if mode == "distance" else torch.empty((n, 3), dtype=torch.float32,
                                                        device=points.device)
    else:
        d, g = (out, None) if mode == "distance" else out
    if n:
        build.launch("sdf_walk_query", points.device, *walk_args(walk), points.data_ptr(), n,
                     MODES.index(mode), group, d.data_ptr(),
                     None if g is None else g.data_ptr())
        build.count_launch(globals(), "launch_count")
    return d if g is None else (d, g)


def _weights(frac, gd, gl, interpolation: str):
    """Each point's coefficient weights (P, num_coeff): gd m_j + ((gl_x
    dx m_j + gl_y dy m_j) + gl_z dz m_j), m_j the monomial of index i + 4j
    + 16k (tricubic) or the corner weight of index i + 2j + 4k
    (trilinear); ``gl`` (P, 3), the world gradient's upstream over the
    leaf's edge, or None."""
    if interpolation == "tricubic":
        xv, yv, zv = _power_vectors(frac)
        dxv, dyv, dzv = _deriv_power_vectors(frac)
    else:
        xv, yv, zv = (torch.stack([1.0 - frac[..., a], frac[..., a]], -1) for a in range(3))
        one = torch.ones_like(xv)
        dxv = dyv = dzv = torch.cat([-one[..., :1], one[..., 1:]], -1)
    m = _monomials
    w = gd[..., None] * m(xv, yv, zv)
    if gl is None:
        return w
    return w + ((gl[..., 0:1] * m(dxv, yv, zv) + gl[..., 1:2] * m(xv, dyv, zv))
                + gl[..., 2:3] * m(xv, yv, dzv))


def walk_backward_plain(walk: Walk, points, gd, gg=None, coeffs_grad: bool = True,
                        points_grad: bool = False):
    """(coefficient gradient (W,) or None, point gradient (P, 3) or None)
    of sum(gd d) + sum(gg g), (d, g) = ``walk_query_plain(walk, points,
    "world")``: each in-box point's weights (``_weights``), then one
    ``index_add_`` over the coefficient rows (at base + j on the other
    layout). An out-of-box point adds 0 times its weights at the leaf it
    reaches, as JAX's VJP does: NaN where a weight is not finite (a NaN,
    infinite or far point), 0 elsewhere. The point gradient (``gg``
    None: its gradient through g is a second derivative) is gd times the
    world gradient in the box and autograd's of ``box_distance`` outside,
    what autograd of the plain walk gives (but at a point exactly on the
    box's low faces, where autograd's unselected square root reads NaN)."""
    with torch.no_grad():
        pts = points.detach()
        word, frac, in_box, steps = _descend(walk.words, pts, walk.box_min, walk.box_size3,
                                             walk.start_grid_size, levels=walk.levels,
                                             fast=walk.fast)
        leaf = _leaf_size(walk, steps)[..., None]
        gc = gp = None
        if coeffs_grad:
            nc = walk.num_coeff
            zero = torch.zeros((), dtype=torch.float32, device=pts.device)
            gl = None if gg is None else torch.where(in_box[..., None], gg, zero) / leaf
            w = _weights(frac, torch.where(in_box, gd, zero), gl, walk.interpolation)
            base = (word & _CIDX).long()
            gc = torch.zeros(walk.words.numel(), dtype=torch.float32, device=pts.device)
            if walk.fast:
                gc.view(-1, nc).index_add_(0, base // nc, w)
            else:
                idx = base[..., None] + torch.arange(nc, device=pts.device)
                gc.index_add_(0, idx.reshape(-1), w.reshape(-1))
        if points_grad:
            _need(gg is None, "the point gradient through g is a second derivative: take "
                  "autograd of walk_query_plain")
            coeffs = _leaf_coeffs(walk.words, word, walk.num_coeff, walk.fast, walk.coeffs)
            g_in = gradient_at(coeffs, frac, walk.interpolation) / leaf
            with torch.enable_grad():
                x = pts.clone().requires_grad_(True)
                d_out = box_distance(x, walk.box_min + 0.5 * walk.box_size3, walk.box_size3)
                (g_out,) = torch.autograd.grad(d_out, x, gd)
            gp = torch.where(in_box[..., None], gd[..., None] * g_in, g_out)
    return gc, gp


# -- K11 on the aligned layout: keys, the leaf sort, the reduction -----------------

def reduce_plan(P: int, num_coeff: int) -> tuple[int, int, int]:
    """K11's reduction of P sorted points: (tiles of ``REDUCE_TILE``
    points, points a run (a run of 4 lanes, 2 for trilinear rows, adds them
    one after the other), float32 words of the tiles' partials, two rows a
    tile)."""
    runs = _THREADS // (4 if num_coeff == 64 else 2)
    tiles = -(-int(P) // REDUCE_TILE)
    return tiles, REDUCE_TILE // runs, 2 * tiles * num_coeff


def walk_keys_plain(walk: Walk, points, gd, gg=None):
    """K11's keys and shares (the aligned layout): (keys (P,) int32,
    share (P, 4), or (P, 8) with ``gg``). A point's key is the row it adds
    into, base // num_coeff of the reached word, or W // num_coeff (one
    past the last row) where it adds nothing: an in-box point whose row
    runs past the words, an out-of-box point within 2^31 start cells of the
    box (its weights are finite, 0 times them is 0). An out-of-box point
    beyond (NaN, infinite, far) keeps the row it reaches from the nearest
    start cell. Its share: the position in the leaf and gd (0 outside the
    box), then gg over the leaf's edge (0 outside) and a 0; zeros where the
    key is W // num_coeff."""
    with torch.no_grad():
        pts = points.detach()
        word, frac, in_box, steps = _descend(walk.words, pts, walk.box_min, walk.box_size3,
                                             walk.start_grid_size, levels=walk.levels,
                                             fast=True)
        rows = walk.words.numel() // walk.num_coeff
        row = (word & _CIDX) // walk.num_coeff
        cell = walk.box_size3 / walk.start_grid_size
        near = (((pts - walk.box_min) / cell).abs() < 2.0**31).all(dim=-1)
        keyed = (row < rows) & (in_box | ~near)
        zero = torch.zeros((), dtype=torch.float32, device=pts.device)
        parts = [frac, torch.where(in_box, gd, zero)[..., None]]
        if gg is not None:
            gl = torch.where(in_box[..., None], gg, zero) / _leaf_size(walk, steps)[..., None]
            parts += [gl, torch.zeros_like(gl[..., :1])]
        share = torch.where(keyed[..., None], torch.cat(parts, -1), zero)
        return torch.where(keyed, row, rows).to(torch.int32), share


def _fold(key, pos, val, span):
    """The items (key, first position, value (n, C)), in position order,
    with each run of consecutive items of one key inside one group
    (position // span; span None: one group) added left to right into its
    first: the kernel's order at one level."""
    n = key.numel()
    if n == 0:
        return key, pos, val
    grp = pos // span if span else torch.zeros_like(pos)
    new = torch.ones(n, dtype=torch.bool, device=key.device)
    new[1:] = (key[1:] != key[:-1]) | (grp[1:] != grp[:-1])
    heads = torch.nonzero(new)[:, 0]
    seg = torch.cumsum(new, 0) - 1
    rank = torch.arange(n, device=key.device) - heads[seg]
    out = val[heads].clone()
    for k in range(1, int(rank.max()) + 1):
        at = torch.nonzero(rank == k)[:, 0]
        out[seg[at]] = out[seg[at]] + val[at]
    return key[heads], pos[heads], out


def walk_reduce_plain(walk: Walk, lid_s, order, share):
    """K11's reduction in torch: the coefficient gradient (W,) of sorted
    keys ``lid_s`` (P,) int32, their ``order`` (P,) int64 and the key
    launch's ``share`` (P, 4 or 8), bit for bit in the kernel's order.
    Each point of a row (key < W // num_coeff) brings ``_weights`` of its
    share; a run of points (``reduce_plan``) adds its row's weights left to
    right, a tile its runs' sums, then the tiles' in tile order."""
    with torch.no_grad():
        nc, W = walk.num_coeff, walk.words.numel()
        rows = W // nc
        pos = torch.nonzero(lid_s < rows)[:, 0]
        s = share[order[pos]]
        w = _weights(s[:, :3], s[:, 3], s[:, 4:7] if s.shape[1] == 8 else None,
                     walk.interpolation)
        key = lid_s[pos].long()
        _, run, _ = reduce_plan(lid_s.numel(), nc)
        for span in (run, REDUCE_TILE, None):
            key, pos, w = _fold(key, pos, w, span)
        gc = torch.zeros(W, dtype=torch.float32, device=share.device)
        gc[: rows * nc].view(rows, nc)[key] = w
        return gc


def _check_aligned(walk: Walk, points, gd, gg) -> bool:
    """``check_walk`` of an aligned walk and its (P, 3) points, gd (P,) and
    gg (P, 3) or None: True on the card."""
    _need(isinstance(points, torch.Tensor), "points must be a tensor")
    _f32(points, (None, 3), "points", points.device)
    n, dev = points.shape[0], points.device
    _f32(gd, (n,), "gd", dev)
    if gg is not None:
        _f32(gg, (n, 3), "gg", dev)
    _need(walk.fast, "K11's keys and reduction read the aligned layout")
    return check_walk(walk, dev)


def _launch_keys(walk: Walk, points, gd, gg, keys, share, gp) -> None:
    build.launch("sdf_walk_keys", points.device, *walk_args(walk), points.data_ptr(),
                 points.shape[0], gd.data_ptr(), None if gg is None else gg.data_ptr(),
                 None if keys is None else keys.data_ptr(),
                 None if share is None else share.data_ptr(),
                 None if gp is None else gp.data_ptr())
    build.count_launch(globals(), "key_launch_count")


def _launch_reduce(walk: Walk, lid_s, order, share):
    """The coefficient gradient of the sorted keys and the key launch's
    ``share``."""
    dev, P = lid_s.device, lid_s.shape[0]
    gc = torch.zeros(walk.words.numel(), dtype=torch.float32, device=dev)
    if P:
        partial = torch.empty(reduce_plan(P, walk.num_coeff)[2], dtype=torch.float32,
                              device=dev)
        build.launch("sdf_walk_reduce", dev, *walk_args(walk), lid_s.data_ptr(),
                     order.data_ptr(), P, share.data_ptr(), int(share.shape[1] == 8),
                     gc.data_ptr(), partial.data_ptr())
        build.count_launch(globals(), "reduce_launch_count")
    return gc


def walk_keys(walk: Walk, points, gd, gg=None):
    """K11's key launch: ``walk_keys_plain``'s (keys, share) of contiguous
    (P, 3) points, gd (P,) and gg (P, 3) or None, float32 on the aligned
    walk's device: the kernel on the card, the plain version on the CPU."""
    if not _check_aligned(walk, points, gd, gg):
        return walk_keys_plain(walk, points, gd, gg)
    n, dev = points.shape[0], points.device
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    share = torch.empty((n, 4 if gg is None else 8), dtype=torch.float32, device=dev)
    if n:
        _launch_keys(walk, points, gd, gg, keys, share, None)
    return keys, share


def walk_reduce(walk: Walk, lid_s, order, share):
    """K11's reduction: ``walk_reduce_plain``'s coefficient gradient (W,)
    of the sorted keys ``lid_s`` (P,) int32, their ``order`` (P,) int64
    and the key launch's ``share``: the kernel on the card, the plain
    version on the CPU."""
    P = lid_s.shape[0]
    dev = lid_s.device
    _need(lid_s.dtype == torch.int32 and lid_s.shape == (P,) and lid_s.is_contiguous(),
          "lid_s must be a contiguous (P,) int32 tensor")
    _need(order.dtype == torch.int64 and order.shape == (P,) and order.is_contiguous()
          and order.device == dev, "order must be a contiguous (P,) int64 tensor beside lid_s")
    _need(walk.fast, "K11's keys and reduction read the aligned layout")
    _f32(share, (P, None), "share", dev)
    _need(share.shape[1] in (4, 8), "share must be (P, 4) or (P, 8)")
    if not check_walk(walk, dev):
        return walk_reduce_plain(walk, lid_s, order, share)
    return _launch_reduce(walk, lid_s, order, share)


def walk_backward(walk: Walk, points, gd, gg=None, coeffs_grad: bool = True,
                  points_grad: bool = False):
    """K11: ``walk_backward_plain``'s (coefficient gradient, point
    gradient) for contiguous (P, 3) points, ``gd`` (P,) and ``gg`` (P, 3)
    or None, float32 on the walk's device: the plain version on the CPU; on
    the card, on the aligned layout the key launch (with the point
    gradient), the leaf sort of its keys and the reduction from the key
    launch's shares, on the word-by-word layout one launch of fp32
    atomics."""
    _need(isinstance(points, torch.Tensor), "points must be a tensor")
    _f32(points, (None, 3), "points", points.device)
    n, dev = points.shape[0], points.device
    _f32(gd, (n,), "gd", dev)
    if gg is not None:
        _f32(gg, (n, 3), "gg", dev)
    _need(not (points_grad and gg is not None), "the point gradient through g is a second "
          "derivative: take autograd of walk_query_plain")
    if not check_walk(walk, dev):
        return walk_backward_plain(walk, points, gd, gg, coeffs_grad, points_grad)
    gp = torch.empty((n, 3), dtype=torch.float32, device=dev) if points_grad else None
    launches = n > 0 and (coeffs_grad or points_grad)
    if launches:
        build.count_launch(globals(), "backward_launch_count")
    if not walk.fast:
        gc = (torch.zeros(walk.words.numel(), dtype=torch.float32, device=dev)
              if coeffs_grad else None)
        if launches:
            build.launch("sdf_walk_backward", dev, *walk_args(walk), points.data_ptr(), n,
                         gd.data_ptr(), None if gg is None else gg.data_ptr(),
                         None if gc is None else gc.data_ptr(),
                         None if gp is None else gp.data_ptr())
        return gc, gp
    keys = torch.empty(n, dtype=torch.int32, device=dev) if coeffs_grad else None
    share = (torch.empty((n, 4 if gg is None else 8), dtype=torch.float32, device=dev)
             if coeffs_grad else None)
    if launches:
        _launch_keys(walk, points, gd, gg, keys, share, gp)
    if not coeffs_grad:
        return None, gp
    lid_s, order = launch_leaf_sort(keys, None, None, 0,
                                    sort_bits(walk.words.numel() // walk.num_coeff + 1),
                                    globals())
    return _launch_reduce(walk, lid_s, order, share), gp


def walk_march_plain(walk: Walk, origins, dirs, eps: float, far: float, max_iters: int):
    """``render.sphere_trace`` over ``walk_query_plain``'s distance, with
    each ray's trips: (hit, position, depth, trips (R,) int32) of the
    (R, 3) rays; eps and far in world units."""
    from ..render.sphere_trace import _march   # render imports sdf, which imports this

    def step(p, _):
        d = walk_query_plain(walk, p, "distance")
        return d, d.clamp_min(0.0)

    zeros = torch.zeros(origins.shape[:-1], dtype=torch.float32, device=origins.device)
    init = (origins, zeros, torch.full_like(zeros, torch.inf), torch.ones_like(zeros))
    its, (pos, acc, last_d, _) = _march(partial(march_trips, step, exit_early=True), init, dirs,
                                        eps, far, max_iters)
    return last_d <= eps, pos, acc, its


def _check_march(walk: Walk, origins, dirs) -> bool:
    """``check_walk`` of the march's (R, 3) origins and directions: True on
    the card."""
    _need(isinstance(origins, torch.Tensor), "origins must be a tensor")
    _f32(origins, (None, 3), "origins", origins.device)
    _f32(dirs, (origins.shape[0], 3), "dirs", origins.device)
    return check_walk(walk, origins.device)


def _tile_width(n: int, width: int) -> int:
    """``width`` where n rays make an image of whole 8 x 4 pixel tiles
    ``width`` rays a row, else 0 (the rays' own order)."""
    _need(int(width) >= 0, "width must be 0 or the image's rays a row")
    width = int(width)
    return width if width and width % 8 == 0 and n % width == 0 and n // width % 4 == 0 else 0


def _launch_march(walk: Walk, origins, dirs, eps: float, far: float, max_iters: int, form: int,
                  width: int = 0, stats=None):
    """One launch of ``sdf_walk_march`` in ``form`` (0 the persistent warps,
    1 one thread a ray) on checked CUDA inputs; ``width`` as
    ``walk_march``'s; ``stats``, a (1,) int64 tensor or None, gets the
    persistent warps' trips added."""
    _no_graph(origins, dirs, walk.coeffs)
    n, dev = origins.shape[0], origins.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    pos = torch.empty((n, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(n, dtype=torch.float32, device=dev)
    its = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        counter = torch.empty(1, dtype=torch.int32, device=dev)   # zeroed by the entry
        build.launch("sdf_walk_march", dev, *walk_args(walk), origins.data_ptr(),
                     dirs.data_ptr(), n, _tile_width(n, width), float(np.float32(eps)),
                     float(np.float32(far)), int(max_iters), int(form), hit.data_ptr(),
                     pos.data_ptr(), depth.data_ptr(), its.data_ptr(), counter.data_ptr(),
                     None if stats is None else stats.data_ptr())
    return hit, pos, depth, its


def walk_march(walk: Walk, origins, dirs, eps: float, far: float, max_iters: int,
               width: int = 0):
    """K12: ``walk_march_plain``'s (hit (R,) bool, position (R, 3), depth
    (R,), trips (R,) int32) of contiguous (R, 3) float32 origins and
    directions on the walk's device: on the card one launch of persistent
    warps (and the fill of its ray counter), a ray leaving once it hits
    (last d <= eps), passes ``far`` or has taken ``max_iters`` trips, the
    same bits as ``walk_march_one_thread``. ``width``: where the rays are
    an image, row-major, ``width`` rays a row, of whole 8 x 4 pixel tiles,
    the warps take them a tile at a time (neighbouring rays march alike);
    the results do not depend on it. Rays are marched as the plain version
    marches them, but for one whose position turns infinite: the plain
    version's later trips move a done ray by an infinite step times 0,
    which is NaN; the kernel leaves it as it was."""
    if not _check_march(walk, origins, dirs):
        _tile_width(origins.shape[0], width)
        return walk_march_plain(walk, origins, dirs, eps, far, max_iters)
    out = _launch_march(walk, origins, dirs, eps, far, max_iters, 0, width)
    if origins.shape[0]:
        build.count_launch(globals(), "march_launch_count")
    return out


def walk_march_one_thread(walk: Walk, origins, dirs, eps: float, far: float, max_iters: int):
    """``walk_march`` one thread a ray for all its trips (``walk_march_kernel``,
    K12 before its persistent warps): the reference that the card's tests
    hold ``walk_march`` against bit for bit; not counted. CUDA tensors
    only."""
    _need(_check_march(walk, origins, dirs), "the one-thread march runs on the card only")
    return _launch_march(walk, origins, dirs, eps, far, max_iters, 1)


# -- K14 and K15: the tracer's march and beam segments on the walk -----------------

def walk_segment_plain(walk: Walk, pos, acc, last_d, active, its, dirs, eps: float,
                       far: float, trips: int, query=walk_query_plain) -> int:
    """``walk_segment`` in torch: up to ``trips`` march trips
    (``ops/march.py`` ``_trip``) of step max(d, 0), d ``query(walk, pos,
    "distance")``, with the early exit of ``_run_trips``. Returns the host
    syncs taken. ``query=walk_query`` on the card gives K10's distance,
    K14's bits: the walk route's eager trips before K14, which the card's
    tests and ``chip_smoke.py`` hold K14 against."""
    def step(p, _):
        d = query(walk, p, "distance")
        return d, d.clamp_min(0.0)

    return march_trips(step, pos, acc, last_d, active, its, dirs, eps, far, trips,
                       exit_early=True)


def walk_beam_plain(walk: Walk, pos, acc, active, dirs, r0, rd, margin: float, far: float,
                    trips: int, query=walk_query_plain) -> int:
    """``walk_beam`` in torch: up to ``trips`` beam trips (``ops/march.py``
    ``_beam_trip``) over ``query``'s distance with the tube-safe exit step
    fixed at -inf (the walk proves no cell free), with the early exit of
    ``_run_trips``. Returns the host syncs taken."""
    def beam_step(p, _, shrink):
        d = query(walk, p, "distance")
        return d, torch.full_like(d, -torch.inf)

    return beam_trips(beam_step, pos, acc, active, dirs, r0, rd, margin, far, trips,
                      exit_early=True)


def _check_walk_state(walk: Walk, pos, dirs, floats: dict, ints: dict) -> tuple[bool, int]:
    """``ops/march.py`` ``_check_rays`` on the walk's device: (launch the
    kernel, n)."""
    n = _check_rays(pos, dirs, floats, ints)
    launch = check_walk(walk, pos.device)
    if launch:
        _no_graph(pos, walk.coeffs)
    return launch, n


def segment_form(n: int, tricubic: bool, fast: bool) -> int:
    """K14's form for a launch over ``n`` rays on a layout: on the aligned
    tricubic rows (``tricubic`` and ``fast``) 8 lanes a ray where n * 8
    lanes stay within ``GROUP_LANES``, else 1, one thread a ray. A narrow
    launch (the frame's later rounds) leaves the card short of lanes and
    lasts its longest ray's chain of trips, which a group shortens: it
    sums the row across its lanes and keeps it while the ray stays in its
    leaf. A wide one (the first rounds, the straggler march over every
    row) fills the card one thread a ray. The frame's prefixes are fixed
    when its graph is captured, and so is each launch's form."""
    group = SEGMENT_FORMS[-1]
    return group if tricubic and fast and n * group <= GROUP_LANES else 1


def _check_form(walk: Walk, form) -> None:
    _need(form is None or form in SEGMENT_FORMS, f"form must be one of {SEGMENT_FORMS}")
    _need(form in (None, 1) or (walk.num_coeff == 64 and walk.fast),
          "a group of lanes a ray reads the aligned tricubic rows only")


def walk_segment(walk: Walk, pos, acc, last_d, active, its, dirs, eps: float, far: float,
                 trips: int, form: int | None = None) -> int:
    """K14: up to ``trips`` march trips of the (n,) rays on the walk, in
    place: ``pos`` and ``dirs`` (n, 3), ``acc``, ``last_d`` and ``active``
    (float 0/1) (n,) float32, ``its`` (n,) int32 trips taken; eps and far
    in world units. On the card one launch, a done ray leaving at once, in
    ``segment_form``'s form (``form``, one of ``SEGMENT_FORMS``, forces
    one: 1 one thread a ray, 8 eight lanes a ray on the aligned tricubic
    rows; every form the same bits); ``walk_segment_plain`` on
    the CPU. A ray whose position turns infinite is left as it is, where
    the plain trips' later trips move it by an infinite step times 0
    (NaN). Returns the host syncs taken (the plain version's)."""
    _check_form(walk, form)
    launch, n = _check_walk_state(walk, pos, dirs,
                                  {"acc": acc, "last_d": last_d, "active": active},
                                  {"its": its})
    if not launch:
        return walk_segment_plain(walk, pos, acc, last_d, active, its, dirs, eps, far, trips)
    if n == 0 or trips <= 0:
        return 0
    if form is None:
        form = segment_form(n, walk.num_coeff == 64, walk.fast)
    build.launch("sdf_walk_segment", pos.device, *walk_args(walk), pos.data_ptr(),
                 acc.data_ptr(), last_d.data_ptr(), active.data_ptr(), its.data_ptr(),
                 dirs.data_ptr(), n, float(np.float32(eps)), float(np.float32(far)),
                 int(trips), int(form))
    build.count_launch(globals(), "segment_launch_count")
    if form > 1:
        build.count_launch(globals(), "segment_group_launch_count")
    return 0


def walk_beam(walk: Walk, pos, acc, active, dirs, r0, rd, margin: float, far: float,
              trips: int) -> int:
    """K15: up to ``trips`` beam trips of the (n,) beam rays on the walk,
    in place: ``pos`` and ``dirs`` (n, 3), ``acc``, ``active``, the radius
    at the origin ``r0`` and its growth ``rd`` (n,) float32; margin and far
    in world units. On the card one launch, a done beam leaving at once;
    ``walk_beam_plain`` on the CPU. Returns the host syncs taken (the
    plain version's)."""
    launch, n = _check_walk_state(walk, pos, dirs,
                                  {"acc": acc, "active": active, "r0": r0, "rd": rd}, {})
    if not launch:
        return walk_beam_plain(walk, pos, acc, active, dirs, r0, rd, margin, far, trips)
    if n == 0 or trips <= 0:
        return 0
    build.launch("sdf_walk_beam", pos.device, *walk_args(walk), pos.data_ptr(), acc.data_ptr(),
                 active.data_ptr(), dirs.data_ptr(), r0.data_ptr(), rd.data_ptr(), n,
                 float(np.float32(margin)), float(np.float32(0.5 * margin)),
                 float(np.float32(far)), int(trips))
    build.count_launch(globals(), "beam_launch_count")
    return 0


class WalkQuery(torch.autograd.Function):
    """(coefficients, points, walk, world) -> d, or (d, g) with the world
    gradient: K10 forward, K11 backward (the coefficient gradient, and the
    point gradient), their plain versions on the CPU.
    ``walk`` names the words; its coefficients are the first input. The
    gradient of g with respect to the points is a second derivative, which
    K11 does not compute: callers take autograd of ``walk_query_plain``
    for it."""

    @staticmethod
    def forward(ctx, coeffs, points, walk, world):
        ctx.set_materialize_grads(False)
        ctx.walk = walk
        ctx.save_for_backward(coeffs, points)
        return walk_query(walk._replace(coeffs=coeffs), points, "world" if world else "distance")

    @staticmethod
    @once_differentiable
    def backward(ctx, gd, gg=None):
        coeffs, points = ctx.saved_tensors
        need_c, need_p = ctx.needs_input_grad[:2]
        if gd is None:
            gd = torch.zeros(points.shape[0], dtype=torch.float32, device=points.device)
        gc, gp = walk_backward(ctx.walk._replace(coeffs=coeffs), points, gd.contiguous(),
                               None if gg is None else gg.contiguous(), need_c, need_p)
        return gc, gp, None, None
