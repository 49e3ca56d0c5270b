"""Level-synchronous (breadth-first) approximate octree builder.

Port of the JAX package's ``sdf/octree_builder.py`` (reference:
src/sdf/OctreeSdfDepthFirst.h:31-558). Every
level is one batched device computation over all active nodes, in chunks
of at most ``pair_budget`` node-candidate pairs (``_level_chunk``):

  1. sample the exact SDF (distance + gradient) at the 19 mid-edge/face/
     centre points of every node, brute-forcing only each node's
     candidate triangle list (the first minimum wins);
  2. fit the leaf polynomial from the 8 corner values;
  3. evaluate the termination rule: nodes whose error integral is below
     threshold^2 become leaves;
  4. cull each node's list for its children: by default ("distance")
     keep t iff d(t, centre) <= min_t d(t, centre) + full diagonal, which
     keeps the nearest triangle of every point of the node; or by one of
     the exact octree's influence strategies ("lattice", "basic",
     "precise", "per_vertex"), tighter lists for more work. Every cull
     keeps a safe superset, so the structure's values do not depend on
     it.

The host epilogue allocates children, compacts the kept candidates to
the row front (a counting compaction) and hands the children the
parent's 27-point value lattice. The flat uint32 array has the
reference layout (OctreeSdf.h:39-98): the dense z-major start grid
first, an inner node holds the index of its 8 children, a leaf holds
bit 31 | the index of its coefficients, stored bit-cast in the same
array, each block aligned to whole rows of ``num_coeff`` words.

The node-word constants are shared with the exact octree.
"""
from __future__ import annotations

import time as _time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.interpolation import (
    MIDPOINT_POSITIONS,
    estimate_error_by_distance,
    estimate_error_simpson,
    estimate_error_trapezoid,
    tricubic_fit,
    tricubic_interpolate,
    trilinear_interpolate,
)
from ..ops.point_triangle import (
    gather_triangles,
    pack_triangle_fields,
    signed_dist_grad_pair,
    signed_distance_grad_batch,
    sq_dist_from_field_fn,
)
from ..triangle import TriangleDataSoA

__all__ = [
    "build_octree",
    "OctreeBuildResult",
    "IS_LEAF_MASK",
    "MARK_MASK",
    "CHILDREN_INDEX_MASK",
    "MID_OFFSETS",
    "_round_pow2",
]

IS_LEAF_MASK = np.uint32(1 << 31)
MARK_MASK = np.uint32(1 << 30)
CHILDREN_INDEX_MASK = np.uint32(~(IS_LEAF_MASK | MARK_MASK) & 0xFFFFFFFF)

# Midpoint offsets in node-local coords {-1,0,1} (node half-size units),
# in the order of the reference's nodeSamplePoints and MIDPOINT_POSITIONS.
MID_OFFSETS = (2.0 * MIDPOINT_POSITIONS - 1.0).astype(np.float32)  # (19, 3)

_SQRT3 = np.sqrt(np.float32(3.0))


def _lattice_source_tables():
    """For each of the 27 half-step lattice points of a node, whether it is
    one of the 8 corners (and which) or one of the 19 midpoints (and which).
    Lattice index l = ix + 3*iy + 9*iz with coords in {0,1,2}."""
    corner_of = np.full(27, -1, np.int64)
    mid_of = np.full(27, -1, np.int64)
    mid_counter = 0
    for iz in range(3):
        for iy in range(3):
            for ix in range(3):
                l = ix + 3 * iy + 9 * iz
                if ix % 2 == 0 and iy % 2 == 0 and iz % 2 == 0:
                    corner_of[l] = (ix // 2) + 2 * (iy // 2) + 4 * (iz // 2)
                else:
                    mid_of[l] = mid_counter
                    mid_counter += 1
    return corner_of, mid_of


_CORNER_OF, _MID_OF = _lattice_source_tables()

# _CHILD_CORNER_LATTICE[child, corner] -> lattice index (27) of that corner.
_CHILD_CORNER_LATTICE = np.zeros((8, 8), np.int64)
for _c in range(8):
    _cx, _cy, _cz = _c & 1, (_c >> 1) & 1, (_c >> 2) & 1
    for _i in range(8):
        _ix, _iy, _iz = _i & 1, (_i >> 1) & 1, (_i >> 2) & 1
        _CHILD_CORNER_LATTICE[_c, _i] = (_cx + _ix) + 3 * (_cy + _iy) + 9 * (_cz + _iz)

# child offsets in {-1,1}^3, child index cx + 2cy + 4cz
_CHILD_OFFSETS = np.array(
    [[(c & 1) * 2 - 1, ((c >> 1) & 1) * 2 - 1, ((c >> 2) & 1) * 2 - 1]
     for c in range(8)],
    np.float32,
)


class OctreeBuildResult(NamedTuple):
    octree_u32: np.ndarray       # flat node/coefficient array
    value_range: float           # max |corner distance| over leaves
    min_border_value: float      # min interpolated value on the box border
    leaf_centers: np.ndarray     # (L, 3) world centres of leaves
    leaf_halves: np.ndarray      # (L,) half edge lengths
    leaf_coeff_idx: np.ndarray   # (L,) array index of each leaf's coeffs
    leaf_depths: np.ndarray      # (L,)
    stats: dict                  # per-depth build statistics


# the precise cull's region factor (the exact octree's _PRECISE_MAX_REGIONS)
_PRECISE_MAX_REGIONS = 16


def _round_pow2(n: int, lo: int = 1) -> int:
    """The smallest power-of-two multiple of ``lo`` that is >= ``n``."""
    p = lo
    while p < n:
        p *= 2
    return p


_APPROX_STRATEGIES = ("distance", "lattice", "basic", "precise", "per_vertex")


def _check_strategy(strategy: str) -> None:
    if strategy not in _APPROX_STRATEGIES:
        raise ValueError(f"strategy must be one of {_APPROX_STRATEGIES}, got {strategy!r}")


def _cull_inputs(tris, strategy: str):
    """(strategy, its cull tables) for ``_level_chunk``, None for the
    "distance" rule (the exact octree owns the strategies' culls)."""
    _check_strategy(strategy)
    if strategy == "distance":
        return None
    from .exact_octree import prepare_cull_inputs   # it imports this module

    return strategy, prepare_cull_inputs(tris, strategy)


def _fit(corner_vals, node_size, interpolation):
    if interpolation == "tricubic":
        return tricubic_fit(corner_vals, node_size)
    return corner_vals[..., 0]  # trilinear: the 8 corner distances


def _error(coeffs, mid_f, rule, decay, interpolation):
    if rule == "trapezoid":
        return estimate_error_trapezoid(coeffs, mid_f, interpolation)
    if rule == "simpson":
        return estimate_error_simpson(coeffs, mid_f, interpolation)
    if rule == "by_distance":
        return estimate_error_by_distance(coeffs, mid_f, decay, interpolation)
    # rule == "none": never terminate early
    return torch.full(coeffs.shape[:-1], torch.inf, dtype=coeffs.dtype,
                      device=coeffs.device)


def _level_chunk(tris, packed_t, centers, corner_vals, cand_idx, cand_valid,
                 half, decay, *, rule, interpolation, cull=None):
    """One chunk of one level on the device: midpoint sampling, fit, error
    and the children's cull. ``centers`` (C, 3), ``corner_vals`` (C, 8, 8),
    ``cand_idx`` (C, K) int, ``cand_valid`` (C, K) bool, ``packed_t`` the
    (19, T) field-major packed triangle table, ``half`` the node half edge
    (a float32 value), ``cull`` None for the "distance" rule or a named
    strategy and its tables (``_cull_inputs``). Returns (mid_vals
    (C, 19, 8), coeffs, err (C,), keep (C, K), keep_count (C,))."""
    idx = cand_idx.long()
    cols = [packed_t[r][idx][:, None, :] for r in range(packed_t.shape[0])]  # (C, 1, K)
    offs = torch.as_tensor(MID_OFFSETS, device=centers.device)
    pts = centers[:, None, :] + offs[None] * half                          # (C, 19, 3)
    px, py, pz = (pts[..., i, None] for i in range(3))                      # (C, 19, 1)
    sqd = sq_dist_from_field_fn(px, py, pz, lambda r: cols[r])              # (C, 19, K)
    sqd = torch.where(cand_valid[:, None, :], sqd, torch.inf)

    win_local = sqd.argmin(dim=2)                                           # first minimum
    win_global = idx.gather(1, win_local)                                   # (C, 19)
    d, g = signed_dist_grad_pair(pts, gather_triangles(tris, win_global))
    mid_vals = torch.cat([d[..., None], g, d.new_zeros(d.shape + (4,))], dim=-1)

    if cull is None:
        dc = sqd[:, 9, :].sqrt()  # midpoint 9 is the node centre
        minc = dc.amin(dim=1, keepdim=True)
        diag = float(np.float32(2.0) * _SQRT3 * np.float32(half))
        keep = (dc <= minc + diag) & cand_valid
    else:
        from .exact_octree import cull_chunk

        keep, _, _ = cull_chunk(cull[0], cull[1], centers, cand_idx, cand_valid, half)

    coeffs = _fit(corner_vals, float(np.float32(2.0) * np.float32(half)), interpolation)
    err = _error(coeffs, mid_vals[..., 0], rule, decay, interpolation)
    return mid_vals, coeffs, err, keep, keep.sum(dim=1)


def _seed_lattice(tris, box_min, box_size, start_depth):
    """Distance and gradient at the (s+1)^3 corner lattice of the start
    grid, s = 2^start_depth (the triangles' device runs the nearest-
    triangle sweep, K2 on a CUDA device). Returns (the 8 corner values of
    every start node (n0, 8, 8), their centres (n0, 3), their integer
    coordinates (n0, 3), the cell edge)."""
    s = 1 << start_depth
    cell = box_size / s
    ax = box_min[None, 0] + cell * np.arange(s + 1, dtype=np.float32)
    ay = box_min[None, 1] + cell * np.arange(s + 1, dtype=np.float32)
    az = box_min[None, 2] + cell * np.arange(s + 1, dtype=np.float32)
    gz, gy, gx = np.meshgrid(az, ay, ax, indexing="ij")
    lat_pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    d0, g0 = signed_distance_grad_batch(
        torch.as_tensor(lat_pts, device=tris.origin.device), tris
    )
    lat_vals = np.zeros((lat_pts.shape[0], 8), np.float32)
    lat_vals[:, 0] = d0.cpu().numpy()
    lat_vals[:, 1:4] = g0.cpu().numpy()
    lat_vals = lat_vals.reshape(s + 1, s + 1, s + 1, 8)  # [z, y, x]

    # per start node its corners, z-major node order (OctreeSdf.cpp:106)
    zi, yi, xi = np.meshgrid(np.arange(s), np.arange(s), np.arange(s), indexing="ij")
    corner_vals = np.zeros((s**3, 8, 8), np.float32)
    for ci in range(8):
        cx, cy, cz = ci & 1, (ci >> 1) & 1, (ci >> 2) & 1
        corner_vals[:, ci] = lat_vals[(zi + cz).ravel(), (yi + cy).ravel(), (xi + cx).ravel()]
    centers = np.stack(
        [
            box_min[0] + cell * (xi.ravel() + 0.5),
            box_min[1] + cell * (yi.ravel() + 0.5),
            box_min[2] + cell * (zi.ravel() + 0.5),
        ],
        axis=-1,
    ).astype(np.float32)
    coords = np.stack([xi.ravel(), yi.ravel(), zi.ravel()], axis=-1).astype(np.int64)
    return corner_vals, centers, coords, cell


def _chunk_rows(K: int, pair_budget: int) -> int:
    """Nodes a level chunk takes: the JAX builder's rule on the candidate
    width class 8 * 4^j >= K."""
    Kp = 8
    while Kp < K:
        Kp *= 4
    return max(1, _round_pow2(pair_budget // Kp // 2, 1))


def _run_level(tris, packed_t, centers, corner_vals, cand_idx, cand_valid,
               half, error_decay, rule, interpolation, pair_budget, stats=None,
               cull=None):
    """The level kernel over all N nodes, in chunks of ``_chunk_rows``
    nodes (the last one ragged: eager torch builds nothing per shape, so
    no node is padded in; the precise cull's chunks shrink by its region
    factor). Inputs are host arrays; returns host arrays (mids, coeffs,
    errs, keeps (N, K), kcounts)."""
    dev = packed_t.device
    N, K = cand_idx.shape
    C = _chunk_rows(K, pair_budget)
    if cull is not None and cull[0] == "precise":
        C = max(1, C // _PRECISE_MAX_REGIONS)
    parts = []
    for i in range(0, N, C):
        sl = slice(i, i + C)
        t0 = _time.perf_counter()
        out = _level_chunk(
            tris, packed_t,
            torch.as_tensor(centers[sl], device=dev),
            torch.as_tensor(corner_vals[sl], device=dev),
            torch.as_tensor(cand_idx[sl], device=dev),
            torch.as_tensor(cand_valid[sl], device=dev),
            np.float32(half), float(np.float32(error_decay)),
            rule=rule, interpolation=interpolation, cull=cull,
        )
        t1 = _time.perf_counter()
        parts.append([t.cpu().numpy() for t in out])
        if stats is not None:
            stats["level_enqueue_s"] += t1 - t0
            stats["level_device_and_d2h_s"] += _time.perf_counter() - t1
    return tuple(np.concatenate(p) for p in zip(*parts))


def _fit_only(corner_vals: np.ndarray, node_size, interpolation, device) -> np.ndarray:
    """Coefficients of max-depth leaves, fitted on ``device``."""
    cv = torch.as_tensor(corner_vals, device=device)
    return _fit(cv, float(np.float32(node_size)), interpolation).cpu().numpy()


def _children_lattice(corner_vals, mids, sub):
    """The 8 children's corner values (8 M, 8, 8) from the 27-point value
    lattice of the M subdividing nodes ``sub`` (corner sharing,
    OctreeSdfDepthFirst.h:225-336)."""
    M = len(sub)
    lattice = np.zeros((M, 27, 8), np.float32)
    is_corner = _CORNER_OF >= 0
    lattice[:, is_corner] = corner_vals[sub][:, _CORNER_OF[is_corner]]
    lattice[:, ~is_corner] = mids[sub][:, _MID_OF[~is_corner]]
    return lattice[:, _CHILD_CORNER_LATTICE].reshape(M * 8, 8, 8)


def build_octree(
    tris: TriangleDataSoA,
    box_min,
    box_size: float,
    max_depth: int,
    start_depth: int,
    termination_rule: str = "trapezoid",
    termination_threshold: float = 1e-3,
    error_decay: float = 0.0,
    interpolation: str = "tricubic",
    pair_budget: int = 1 << 21,
    strategy: str = "distance",
) -> OctreeBuildResult:
    """Build the approximate octree on the device of ``tris`` (a torch
    SoA). ``box`` must already be cubified. Rule "none" subdivides every
    node to ``max_depth`` (the uniform build). Returns the flat uint32
    array in the reference layout plus leaf metadata. ``strategy`` names
    the children's cull ("distance" or an exact-octree strategy)."""
    cull = _cull_inputs(tris, strategy)
    dev = tris.origin.device
    packed_t = pack_triangle_fields(tris).t().contiguous()
    T = tris.num_triangles
    box_min = np.asarray(box_min, np.float32)
    box_size = np.float32(box_size)
    num_coeff = 64 if interpolation == "tricubic" else 8
    sq_threshold = np.float32(termination_threshold) ** 2

    corner_vals, centers, _, cell = _seed_lattice(tris, box_min, box_size, start_depth)
    n0 = centers.shape[0]
    cand_idx = np.broadcast_to(np.arange(T, dtype=np.int32), (n0, T)).copy()
    cand_valid = np.ones((n0, T), bool)

    # ---- flat array management ----------------------------------------------
    blocks: list[np.ndarray] = [np.zeros(n0, np.uint32)]
    total_len = n0
    node_slots = np.arange(n0, dtype=np.int64)
    slot_patches: list[tuple[np.ndarray, np.ndarray]] = []

    leaf_centers, leaf_halves, leaf_coeff_idx, leaf_depths = [], [], [], []
    value_range = 0.0
    stats: dict = {
        "nodes_per_depth": {},
        "leaves_per_depth": {},
        "tris_per_node": {},
        # "enqueue": the calls that queue the level chunks on the device;
        # "device_and_d2h": waiting for them and copying results back
        "level_enqueue_s": 0.0,
        "level_device_and_d2h_s": 0.0,
        "level_host_epilogue_s": 0.0,
    }

    depth = start_depth
    half = np.float32(0.5) * cell

    def _emit_leaves(mask, coeffs_np, cvals, cents, hlf, dpt, slots):
        nonlocal total_len, value_range
        idxs = np.nonzero(mask)[0]
        if len(idxs) == 0:
            return
        L = len(idxs)
        # align the coefficient block to num_coeff words: each leaf's
        # coefficients are one row of a (W / num_coeff, num_coeff) view
        align_pad = (-total_len) % num_coeff
        if align_pad:
            blocks.append(np.zeros(align_pad, np.uint32))
            total_len += align_pad
        coeff_block = coeffs_np[idxs].astype(np.float32).view(np.uint32)
        starts = total_len + num_coeff * np.arange(L, dtype=np.int64)
        blocks.append(coeff_block.reshape(-1))
        total_len += num_coeff * L
        slot_patches.append((slots[idxs].copy(), starts.astype(np.uint32) | IS_LEAF_MASK))
        leaf_centers.append(cents[idxs])
        leaf_halves.append(np.full(L, hlf, np.float32))
        leaf_coeff_idx.append(starts)
        leaf_depths.append(np.full(L, dpt, np.int32))
        value_range = max(value_range, float(np.abs(cvals[idxs, :, 0]).max(initial=0.0)))

    while centers.shape[0] > 0:
        N = centers.shape[0]
        K = cand_idx.shape[1]
        stats["nodes_per_depth"][depth] = N

        if depth == max_depth:
            # final level: fit from the corners, everything a leaf
            # (OctreeSdfDepthFirst.h:372-390)
            coeffs = _fit_only(corner_vals, 2.0 * half, interpolation, dev)
            _emit_leaves(np.ones(N, bool), coeffs, corner_vals, centers, half, depth,
                         node_slots)
            stats["leaves_per_depth"][depth] = N
            break

        mids, coeffs, errs, keeps, kcounts = _run_level(
            tris, packed_t, centers, corner_vals, cand_idx, cand_valid, half,
            error_decay, termination_rule, interpolation, pair_budget, stats, cull,
        )
        stats["tris_per_node"][depth] = float(kcounts.mean())

        terminal = errs < sq_threshold
        stats["leaves_per_depth"][depth] = int(terminal.sum())
        _emit_leaves(terminal, coeffs, corner_vals, centers, half, depth, node_slots)

        # ---- subdivide the rest ---------------------------------------------
        t_epi = _time.perf_counter()
        sub = np.nonzero(~terminal)[0]
        if len(sub) == 0:
            break
        M = len(sub)

        # 8 contiguous child slots per subdividing node
        child_base = total_len + 8 * np.arange(M, dtype=np.int64)
        blocks.append(np.zeros(8 * M, np.uint32))
        total_len += 8 * M
        slot_patches.append((node_slots[sub].copy(), child_base.astype(np.uint32)))

        new_corner_vals = _children_lattice(corner_vals, mids, sub)
        new_centers = (
            centers[sub][:, None, :] + _CHILD_OFFSETS[None] * (np.float32(0.5) * half)
        ).reshape(M * 8, 3)
        new_slots = (child_base[:, None] + np.arange(8)[None]).reshape(-1)

        # children's lists = the parent's culled list, compacted to the
        # front in order by counting (no sort)
        K_next = max(1, int(kcounts[sub].max(initial=1)))
        kp = keeps[sub]
        dest = np.cumsum(kp, axis=1) - 1          # kept -> front, in order
        dest[~kp] = K_next                        # dropped -> spill column
        rows = np.arange(M)[:, None]
        new_cand = np.zeros((M, K_next + 1), cand_idx.dtype)
        new_cand[rows, dest] = cand_idx[sub]
        new_valid = np.zeros((M, K_next + 1), bool)
        new_valid[rows, dest] = kp

        centers = new_centers.astype(np.float32)
        corner_vals = new_corner_vals
        node_slots = new_slots
        cand_idx = np.repeat(new_cand[:, :K_next], 8, axis=0)
        cand_valid = np.repeat(new_valid[:, :K_next], 8, axis=0)
        half = np.float32(0.5) * half
        depth += 1
        stats["level_host_epilogue_s"] += _time.perf_counter() - t_epi

    # ---- assemble the flat array ----------------------------------------------
    # trailing pad to a whole number of 64-word rows (the queries' views)
    tail_pad = (-total_len) % 64
    if tail_pad:
        blocks.append(np.zeros(tail_pad, np.uint32))
        total_len += tail_pad
    octree = np.concatenate(blocks)
    for slots, words in slot_patches:
        octree[slots] = words

    leaf_centers = np.concatenate(leaf_centers) if leaf_centers else np.zeros((0, 3), np.float32)
    leaf_halves = np.concatenate(leaf_halves) if leaf_halves else np.zeros(0, np.float32)
    leaf_coeff_idx = np.concatenate(leaf_coeff_idx) if leaf_coeff_idx else np.zeros(0, np.int64)
    leaf_depths = np.concatenate(leaf_depths) if leaf_depths else np.zeros(0, np.int32)

    min_border = _compute_min_border_value(
        octree, leaf_centers, leaf_halves, leaf_coeff_idx,
        box_min, box_size, num_coeff, interpolation, dev,
    )
    return OctreeBuildResult(
        octree_u32=octree,
        value_range=float(value_range),
        min_border_value=float(min_border),
        leaf_centers=leaf_centers,
        leaf_halves=leaf_halves,
        leaf_coeff_idx=leaf_coeff_idx,
        leaf_depths=leaf_depths,
        stats=stats,
    )


def _compute_min_border_value(
    octree, leaf_centers, leaf_halves, leaf_coeff_idx,
    box_min, box_size, num_coeff, interpolation, device,
):
    """Minimum interpolated value at leaf corners on the domain border
    (OctreeSdf.cpp:155-230 semantics, over all leaves at once)."""
    if leaf_centers.shape[0] == 0:
        return np.inf
    corners_unit = np.array(
        [[(c & 1), ((c >> 1) & 1), ((c >> 2) & 1)] for c in range(8)], np.float32
    )
    corner_world = (
        leaf_centers[:, None, :]
        + (2.0 * corners_unit[None] - 1.0) * leaf_halves[:, None, None]
    )
    t = (corner_world - box_min[None, None]) / box_size
    on_border = np.any((t < 1e-4) | (t > 1.0 - 1e-4), axis=-1)  # (L, 8)
    if not on_border.any():
        return np.inf
    coeffs = octree.view(np.float32)[leaf_coeff_idx[:, None] + np.arange(num_coeff)[None]]
    fn = tricubic_interpolate if interpolation == "tricubic" else trilinear_interpolate
    vals = fn(
        torch.as_tensor(coeffs, device=device)[:, None, :],
        torch.as_tensor(corners_unit, device=device)[None],
    ).cpu().numpy()  # (L, 8)
    return float(np.where(on_border, vals, np.inf).min())
