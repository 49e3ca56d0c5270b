"""Exact octree SDF: leaves hold culled nearest-triangle candidate lists.

Port of the JAX package's ``sdf/exact_octree.py`` (reference:
ExactOctreeSdf.h:35-218, ExactOctreeSdf.cpp:7-320):

* Build: a level loop over node groups. Each group's candidate lists are
  culled by the named strategy: "region" (the per-node-region influence
  test, the reference's default PerNodeRegionTrianglesInfluence role; on a
  CUDA device one launch of kernel K13 a group, ``ops/cull.py``
  ``region_cull``, else ``region_cull_plain`` in chunks of (C, K) pairs),
  "lattice", "basic", "precise" or "per_vertex" (the reference's other
  influence strategies in plain torch, in chunks; the last three through
  ``ops.gjk``). Nodes at
  ``min_triangles_per_node``, ``max_depth`` or the futility ratio become
  leaves whose lists are sorted by distance to the leaf centre; the rest
  subdivide. Leaf lists are stored CSR-style in ``tri_flat``, each span
  -1 padded to a multiple of 64.
* Buckets: ``tri_flat`` viewed as rows of ``scan_chunk`` slots, beside a
  table of each slot's fields in one of three tiers (``_make_buckets``),
  and per leaf its first row and row count.
* Query: the leaf sort (on a CUDA device one kernel call: the dense-grid
  descent to an int32 leaf key, K8's arithmetic, fused into a stable
  radix sort over the leaf ids' bits; past depth 7, until
  ``build_query_grid``, the node walk's keys given to the same sort), the
  sorted gather of the points and
  their bucket bounds (K9), the scan (kernel K1 on a CUDA device over
  64-slot vertex rows, else the plain scans), then the signed evaluation
  of each winner, the box fallback outside the domain (box distance +
  sqrt(3) * box size, ExactOctreeSdf.cpp:44-49), and the unsort, in one
  pass (K7); ``ops/exact_query.py`` holds K7-K9, the leaf sort and their
  plain versions. The scan takes
  fixed windows of 32 sorted points for dense batches and leaf-aligned
  groups of G points for sparse ones (padded batch < 4 points per leaf,
  the JAX package's rule), unless ``set_scan_impl`` pins one; the id-only
  tier has one scan of its own.

The state round-trips through the ``.npz`` container of the JAX package
(``from_jax_state``, ``save``, ``SdfFunction.load``) and the reference's
``.bin`` (``io.sdflib_binary``).
"""
from __future__ import annotations

import collections
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..mesh import BoundingBox, Mesh
from ..ops.cull import (
    _CORNER_OFFS,
    _F32_SQRT3,
    _LATTICE_OFFS,
    _f32,
    cull_in_chunks,
    cull_rows,
    region_cull,
    region_cull_plain,
)
from ..ops.exact_query import (
    exact_descend,
    exact_finish_plain,
    exact_sorted_gather_plain,
    finish_table,
    launch_exact_finish,
    launch_leaf_sort,
    launch_sorted_gather,
    leaf_bounds,
    leaf_sort_plain,
    sort_bits,
)
from ..ops.gjk import box_triangle_distance, corner_sphere_hull_tri_lower
from ..ops.point_triangle import (
    NUM_PACKED_FIELDS,
    pack_triangle_fields,
    sq_dist_from_field_fn,
)
from ..ops.scan import (
    WINDOW,
    scan_grouped,
    scan_grouped_plain,
    scan_id_only,
    scan_window,
    scan_window_plain,
)
from ..triangle import TriangleDataSoA, calculate_mesh_triangle_data, soa_to_torch
from .octree import _build_leaf_grid
from .octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK, _round_pow2
from .sdf_function import SdfFormat, SdfFunction, resolve_device

__all__ = ["ExactOctreeSdf"]

_LEAF_CHUNK = 64      # slots per bucket row; CSR spans pad to a multiple
_SLAB_ROWS = 256      # tri_flat pads to whole slabs, as the JAX build does
_AUTO_GRID_DEPTH = 7  # dense leaf grid up to this depth (4 B per cell)
_CULL_GROUPS_IN_FLIGHT = 2
_DEFAULT_BUCKET_BYTES = 4 << 30
_GROUP_WIDTH_LOCK = threading.Lock()
# Sparse-batch switch: below this many padded points per leaf the query
# takes the grouped scan (the JAX package's rule, exact_octree.py:2213).
# Kept after measuring both scans on an H100 (chip_smoke.py, PERF.md
# section 6): over the d6 torus's 145,636 leaves the grouped query was
# 1.3-1.9x faster at 2^16 points, and from 2^19 to 2^21 points the two
# differed by less than the spread between runs, so no crossover was
# resolved to move the threshold to.
_SPARSE_POINTS_PER_LEAF = 4
_QUERY_BLOCK = 1 << 17   # the JAX package's padding unit for large batches
# set_scan_impl's names (the JAX package's) -> the scan each pins
_SCAN_IMPLS = {"xla": "grouped", "pallas": "grouped",
               "xla_window": "window", "pallas_window": "window"}
_BUCKET_FORMATS = ("auto", "vertex9", "frame19")


def _lattice_cull_chunk(tables, centers, cand_idx, cand_valid, half):
    """Lattice-anchored cull (the house variant of the reference's
    influence strategies, TrianglesInfluence.h:119-860): keep t iff for
    some half-step anchor l both

        (A) d_lb(t, sub-cube_l) <= min_t' d(t', l) + s,  s = (half / 2) sqrt(3)
        (B) d(t, l) <= min_t' d(t', l) + 2 s

    hold, d_lb the distance between the triangle's AABB and the anchor's
    half-size sub-cube. A winner anywhere in the sub-cube passes both
    (see the JAX package's docstring). ``tables.geo`` holds the (T, 6)
    triangle AABBs [min, max]."""
    idx = cand_idx.long()
    cols = [tables.packed_t[r][idx] for r in range(tables.packed_t.shape[0])]
    ab = tables.geo[idx]                                          # (C, K, 6)
    px, py, pz = centers[:, 0:1], centers[:, 1:2], centers[:, 2:3]
    qh = _f32(np.float32(0.5) * np.float32(half))
    slack = _f32(_F32_SQRT3 * np.float32(qh))
    offs = _LATTICE_OFFS * np.float32(half)

    keep = torch.zeros(cand_idx.shape, dtype=torch.bool, device=centers.device)
    sqd_center = None
    for l in range(27):
        ox, oy, oz = (float(v) for v in offs[l])
        sqd = sq_dist_from_field_fn(px + ox, py + oy, pz + oz, lambda r: cols[r])
        sqd = torch.where(cand_valid, sqd, torch.inf)
        if l == 13:
            sqd_center = sqd
        min_l = sqd.amin(dim=1).sqrt()                            # (C,)
        anchor = centers + torch.as_tensor(offs[l], device=centers.device)
        lo = anchor[:, None, :] - qh
        hi = anchor[:, None, :] + qh
        gap = torch.maximum(ab[..., 0:3] - hi, lo - ab[..., 3:6]).clamp_min(0.0)
        d_lb = (gap * gap).sum(-1).sqrt()                         # (C, K)
        bound_a = d_lb <= min_l[:, None] + slack
        cap_b = min_l[:, None] + 2.0 * slack
        bound_b = sqd <= cap_b * cap_b
        keep |= bound_a & bound_b
    keep &= cand_valid
    return keep, keep.sum(dim=1), sqd_center


def _corner_distances(tables, centers, cand_idx, cand_valid, half):
    """(the candidates' field columns, their squared distance to the node
    centre (inf where invalid), their distance to the 8 node corners
    (C, 8, K), inf where invalid)."""
    idx = cand_idx.long()
    cols = [tables.packed_t[r][idx] for r in range(tables.packed_t.shape[0])]
    px, py, pz = centers[:, 0:1], centers[:, 1:2], centers[:, 2:3]
    sqd_center = torch.where(
        cand_valid, sq_dist_from_field_fn(px, py, pz, lambda r: cols[r]), torch.inf)
    corner_d = []
    for c in range(8):
        ox, oy, oz = (float(v) for v in _CORNER_OFFS[c] * np.float32(half))
        sqd = sq_dist_from_field_fn(px + ox, py + oy, pz + oz, lambda r: cols[r])
        corner_d.append(torch.where(cand_valid, sqd, torch.inf).sqrt())
    return sqd_center, torch.stack(corner_d, dim=1)


def _basic_cull_chunk(tables, centers, cand_idx, cand_valid, half):
    """The reference's BasicTrianglesInfluence (TrianglesInfluence.h:
    119-168): keep t iff d(t, node box) <= the largest over the 8 node
    corners of the corner's nearest-candidate distance. The box-triangle
    distance is exact (``ops.gjk``). ``tables.geo`` holds the (T, 3, 3)
    world vertices."""
    tv = tables.geo[cand_idx.long()]                              # (C, K, 3, 3)
    sqd_center, D = _corner_distances(tables, centers, cand_idx, cand_valid, half)
    maxmin = torch.zeros(centers.shape[0], device=centers.device)
    for c in range(8):
        maxmin = torch.maximum(maxmin, D[:, c].amin(dim=1))
    d_box = box_triangle_distance(
        centers[:, None, :].expand(tv.shape[:-1]),
        torch.full((3,), _f32(half), device=centers.device),
        tv,
    )                                                             # (C, K)
    keep = (d_box <= maxmin[:, None]) & cand_valid
    return keep, keep.sum(dim=1), sqd_center


def _per_vertex_cull_chunk(tables, centers, cand_idx, cand_valid, half):
    """The reference's PerVertexTrianglesInfluence<1> (TrianglesInfluence.h:
    286-476): each node corner's nearest candidate spans a hull of spheres
    at the 8 corners with radii d(corner_c, nearest_i) - min_c of those; a
    candidate survives at its closest corner iff it is that corner's own
    nearest triangle or its hull distance's Frank-Wolfe lower bound
    (``corner_sphere_hull_tri_lower``) is within the corner's distance.
    The JAX function's one-hot sums are gathers here."""
    tv = tables.geo[cand_idx.long()]                              # (C, K, 3, 3)
    C, K = cand_idx.shape
    sqd_center, D = _corner_distances(tables, centers, cand_idx, cand_valid, half)
    nb = D.argmin(dim=2)                                          # (C, 8) corner's nearest
    # radii[c, i, g] = D[c, g, nb[c, i]]: corner g's distance to corner i's nearest
    radii = D.gather(2, nb[:, None, :].expand(C, 8, 8)).transpose(1, 2)
    minv = radii.amin(dim=2)                                      # (C, 8)
    radii = radii - minv[:, :, None]
    vid = D.argmin(dim=1)                                         # (C, K) closest corner
    radii_k = radii.gather(1, vid[:, :, None].expand(C, K, 8))    # (C, K, 8)
    thr = minv.gather(1, vid)
    region_tri = nb.gather(1, vid)
    lower = corner_sphere_hull_tri_lower(
        centers[:, None, :].expand(C, K, 3), _f32(half), radii_k, tv)
    own = region_tri == torch.arange(K, device=centers.device)[None, :]
    keep = (own | (lower <= thr)) & cand_valid
    return keep, keep.sum(dim=1), sqd_center


# The precise cull tests each candidate against the influence regions of
# the strongest few candidates (smallest corner distance); fewer regions
# only weaken the cull.
_PRECISE_MAX_REGIONS = 16


def _precise_cull_chunk(tables, centers, cand_idx, cand_valid, half):
    """The reference's PreciseTrianglesInfluence (TrianglesInfluence.h:
    191-284): every candidate whose corner distances dip below the node's
    largest corner minimum spans an influence region (spheres at the
    corners with radii d(corner_c, tri_j)); a candidate goes iff it lies
    provably outside another candidate's region hull (the Frank-Wolfe
    lower bound above 0), over the ``_PRECISE_MAX_REGIONS`` strongest
    regions. The regions' radii are a gather: the JAX function's one-hot
    einsum multiplies the inf distances of invalid candidates by 0, which
    makes every radius NaN, and so culls nothing, in a node whose list has
    any padding (ROADMAP.md, Queue 3)."""
    tv = tables.geo[cand_idx.long()]                              # (C, K, 3, 3)
    C, K = cand_idx.shape
    R = min(_PRECISE_MAX_REGIONS, K)
    sqd_center, D = _corner_distances(tables, centers, cand_idx, cand_valid, half)
    maxmin = D.amin(dim=2).amax(dim=1)                            # (C,)
    strength = D.amin(dim=1)                                      # (C, K)
    region_ok = (D < maxmin[:, None, None]).any(dim=1) & cand_valid
    key = torch.where(region_ok, strength, torch.inf)
    order = torch.sort(key, dim=1, stable=True).indices[:, :R]    # (C, R)
    radii_r = D.gather(2, order[:, None, :].expand(C, 8, R)).transpose(1, 2)  # (C, R, 8)
    valid_r = region_ok.gather(1, order)                          # (C, R)
    lower = corner_sphere_hull_tri_lower(
        centers[:, None, None, :], _f32(half), radii_r[:, :, None, :], tv[:, None])  # (C, R, K)
    not_self = order[:, :, None] != torch.arange(K, device=centers.device)[None, None, :]
    culled = (valid_r[:, :, None] & not_self & (lower > 0.0)).any(dim=1)
    keep = ~culled & cand_valid
    return keep, keep.sum(dim=1), sqd_center


_CULL_CHUNKS = {
    "lattice": _lattice_cull_chunk,
    "region": region_cull,
    "basic": _basic_cull_chunk,
    "precise": _precise_cull_chunk,
    "per_vertex": _per_vertex_cull_chunk,
}
_CULL_STRATEGIES = tuple(_CULL_CHUNKS)


class CullTables(NamedTuple):
    """The device tables of a cull strategy: the (T, 19) packed fields,
    their (19, T) transpose, the strategy's geometry (the (T, 6) triangle
    AABBs for "lattice", the (T, 3, 3) world vertices for "basic",
    "precise" and "per_vertex", None for "region"), and for "region" K13's
    padded rows (``ops/cull.py`` ``cull_rows``, which the card's cull reads)."""
    packed: torch.Tensor
    packed_t: torch.Tensor
    geo: torch.Tensor | None
    rows: torch.Tensor | None = None


def prepare_cull_inputs(tris: TriangleDataSoA, strategy: str):
    """The cull tables of a named strategy on the triangles' device, None
    for the approximate builders' "distance" rule: one owner of the
    strategy-to-inputs mapping for the exact and both approximate
    builders."""
    if strategy == "distance":
        return None
    if strategy not in _CULL_CHUNKS:
        raise ValueError(f"unknown cull strategy {strategy!r}")
    packed = pack_triangle_fields(tris)
    vw = tris.v_world
    geo = (
        torch.cat([vw.amin(dim=1), vw.amax(dim=1)], dim=-1) if strategy == "lattice"
        else None if strategy == "region" else vw
    )
    rows = cull_rows(packed) if strategy == "region" else None
    return CullTables(packed, packed.t().contiguous(), geo, rows)


def cull_chunk(strategy: str, tables: CullTables, centers, cand_idx, cand_valid, half):
    """One (C, K) chunk of a strategy's cull: (keep (C, K), kept counts
    (C,), squared distance to the node centre (C, K), the leaf-list sort
    key). "region" launches K13 for CUDA tensors."""
    return _CULL_CHUNKS[strategy](tables, centers, cand_idx, cand_valid, half)


def _cull_group(strategy, tables, centers, cand, valid, half, C, plain=False):
    """A strategy's cull of a node group: "region" through K13's wrapper
    (one launch over the whole group on a CUDA device, chunks of C nodes
    of the plain version on the CPU) unless ``plain`` pins the plain
    version; the other strategies in chunks of C nodes (the precise cull's
    pair state carries a region factor, so its chunks shrink by it)."""
    if strategy == "region" and not plain:
        return region_cull(tables, centers, cand, valid, half, rows=C)
    fn = region_cull_plain if strategy == "region" else _CULL_CHUNKS[strategy]
    if strategy == "precise":
        C = max(8, C // _PRECISE_MAX_REGIONS)
    return cull_in_chunks(fn, C, tables, centers, cand, valid, half)


def _compact_rows(idx_rows, keep_rows):
    """Stable-compact the kept entries of each row to its front; returns
    (ids, kept mask) of the same width."""
    order = torch.sort((~keep_rows).to(torch.uint8), dim=1, stable=True).indices
    return idx_rows.gather(1, order), keep_rows.gather(1, order)


def _compact_leaf_rows(sqd_center, idx_rows, keep_rows):
    """Kept ids to the row front, sorted by squared distance to the leaf
    centre (stable; dropped entries last)."""
    key = torch.where(keep_rows, sqd_center, torch.inf)
    order = torch.sort(key, dim=1, stable=True).indices
    return idx_rows.gather(1, order)


def _chunk_rows(K: int, pair_budget: int) -> int:
    """The nodes of K slots in a chunk of the plain culls: about half
    ``pair_budget`` pairs, at least 8."""
    return max(8, _round_pow2(max(1, pair_budget // max(K, 1)), 1) // 2)


class _ExactBuild:
    """State of one level-synchronous exact build (``_build_exact``)."""

    def __init__(self, strategy, tables, min_triangles_per_node, max_depth, futility,
                 pair_budget):
        self.strategy = strategy
        self.tables = tables
        self.device = tables.packed.device
        self.min_tpn = min_triangles_per_node
        self.max_depth = max_depth
        self.futility = futility
        self.pair_budget = pair_budget
        self.blocks: list[np.ndarray] = []
        self.total_len = 0
        self.slot_patches: list[tuple[np.ndarray, np.ndarray]] = []
        self.leaf_chunks: list[tuple[torch.Tensor, np.ndarray]] = []
        self.leaf_centers: list[np.ndarray] = []
        self.leaf_counter = 0
        self.child_offsets = torch.as_tensor(_CORNER_OFFS, device=self.device)
        self.stats: dict = {
            "nodes_per_depth": {}, "tris_per_leaf": [], "build_splits": 0,
            "cull_shapes": {},
        }

    def cull(self, group, half):
        """Enqueue the cull of a group (no host sync). ``cull_shapes``
        counts the (C, K) chunks of the plain version, as the JAX package
        reports them, also where K13 culls the group in one launch."""
        centers, cand, valid, _, _ = group
        N, K = cand.shape
        C = _chunk_rows(K, self.pair_budget)
        key = f"{C}x{K}"
        shapes = self.stats["cull_shapes"]
        shapes[key] = shapes.get(key, 0) + -(-N // C)
        return _cull_group(self.strategy, self.tables, centers, cand, valid, half, C)

    def finish(self, group, culled, depth, half, next_buckets):
        """Turn a culled group into leaves and child groups (syncs once)."""
        centers, cand, _, slots, parent_counts = group
        keeps, kc_dev, sqd_cen = culled
        kcounts = kc_dev.cpu().numpy()
        K = cand.shape[1]
        terminal = (kcounts <= self.min_tpn) | (depth == self.max_depth)
        if self.futility is not None and parent_counts is not None:
            # subdividing barely shrank the list: stop here
            terminal |= kcounts >= self.futility * parent_counts

        t_idx = np.nonzero(terminal)[0]
        if len(t_idx):
            t_dev = torch.as_tensor(t_idx, device=self.device)
            ids = _compact_leaf_rows(sqd_cen[t_dev], cand[t_dev], keeps[t_dev])
            cnt = kcounts[t_idx]
            width = min(K, -(-max(int(cnt.max()), 1) // _LEAF_CHUNK) * _LEAF_CHUNK)
            self.leaf_chunks.append((ids[:, :width], cnt))
            self.leaf_centers.append(centers[t_dev].cpu().numpy())
            self.stats["tris_per_leaf"].extend(int(c) for c in cnt)
            leaf_ids = self.leaf_counter + np.arange(len(t_idx), dtype=np.int64)
            self.leaf_counter += len(t_idx)
            self.slot_patches.append(
                (slots[t_idx], leaf_ids.astype(np.uint32) | IS_LEAF_MASK)
            )

        sub = np.nonzero(~terminal)[0]
        if len(sub) == 0:
            return
        M = len(sub)
        child_base = self.total_len + 8 * np.arange(M, dtype=np.int64)
        self.blocks.append(np.zeros(8 * M, np.uint32))
        self.total_len += 8 * M
        self.slot_patches.append((slots[sub], child_base.astype(np.uint32)))
        child_slots = child_base[:, None] + np.arange(8)[None]

        # children inherit a width class: the smallest 8 * 4^j >= count
        kc_sub = kcounts[sub]
        wclass = np.full_like(kc_sub, 8)
        while np.any(wclass < kc_sub):
            wclass = np.where(wclass < kc_sub, wclass * 4, wclass)
        for w in np.unique(wclass):
            m = wclass == w
            rows = torch.as_tensor(sub[m], device=self.device)
            ids, kept = _compact_rows(cand[rows], keeps[rows])
            w_int = min(int(w), K)
            new_centers = (
                centers[rows][:, None, :] + self.child_offsets[None] * (0.5 * half)
            ).reshape(-1, 3)
            next_buckets.setdefault(w_int, []).append((
                new_centers,
                ids[:, :w_int].repeat_interleave(8, dim=0),
                kept[:, :w_int].repeat_interleave(8, dim=0),
                child_slots[m].reshape(-1),
                np.repeat(kc_sub[m], 8),
            ))


def _split_groups(groups, entry_budget):
    """Cut a level's parents into slices whose projected children (8x the
    parent candidate entries) fit ``entry_budget``; each slice's subtree
    then builds before the next starts (slices floor at 64 rows)."""
    per_slice = max(1, entry_budget // 8)
    slices: list[list] = [[]]
    acc = 0
    for g in groups:
        N, K = g[1].shape
        step = max(64, per_slice // max(K, 1))
        for i in range(0, N, step):
            j = min(N, i + step)
            part = (
                g[0][i:j], g[1][i:j], g[2][i:j], g[3][i:j],
                None if g[4] is None else g[4][i:j],
            )
            if acc and acc + (j - i) * K > per_slice:
                slices.append([])
                acc = 0
            slices[-1].append(part)
            acc += (j - i) * K
    return [s for s in slices if s]


def _fill_tri_flat(leaf_chunks, leaf_offset, total: int, device):
    """The CSR candidate array (total,) int32: each leaf's kept ids at its
    offset, -1 elsewhere."""
    tri_flat = torch.full((total,), -1, dtype=torch.int32, device=device)
    row0 = 0
    for ids, cnt in leaf_chunks:
        Lg, w = ids.shape
        off = torch.as_tensor(leaf_offset[row0 : row0 + Lg], device=device).long()
        n = torch.as_tensor(cnt, device=device)
        strip = max(1, (1 << 26) // max(w, 1))   # bounds the (rows, w) positions
        lanes = torch.arange(w, device=device)
        for s0 in range(0, Lg, strip):
            s1 = min(s0 + strip, Lg)
            mask = lanes[None, :] < n[s0:s1, None]
            pos = off[s0:s1, None] + lanes[None, :]
            tri_flat[pos[mask]] = ids[s0:s1][mask]
        row0 += Lg
    return tri_flat


def _build_exact(
    tris: TriangleDataSoA,
    box_min,
    box_size: float,
    max_depth: int,
    start_depth: int,
    min_triangles_per_node: int,
    pair_budget: int = 1 << 21,
    futility: float | None = 0.8,
    entry_budget: int = 1 << 27,
    strategy: str = "region",
    seed_cells: tuple[int, int] | None = None,
    shared_tables: CullTables | None = None,
):
    """Level-synchronous exact build on the triangles' device, each
    node's candidates culled by ``strategy`` (``_CULL_CHUNKS``). Returns
    (octree (N,) uint32, leaf_offset, leaf_count, tri_flat (device int32),
    leaf_centers, stats).

    Candidate state stays on the device; per group only the kept counts
    cross to the host. ``futility``: a node whose culled list keeps at
    least that share of its parent's list becomes a leaf (None disables
    the rule). Before a level whose children would exceed
    ``entry_budget`` candidate entries, the parents split into slices
    built depth first. At most ``_CULL_GROUPS_IN_FLIGHT`` groups' culls
    are enqueued ahead of the host's consumption, which bounds the live
    (N, K) cull outputs.

    ``seed_cells`` = (lo, hi) builds only the start cells [lo, hi) of the
    z-major start grid (a shard of ``parallel.TiledExactOctreeSdf``): the
    global build's subtrees of those cells, in a flat array of their own
    whose start block holds the hi - lo cells, padded to a multiple of 8
    words so every child octet stays 8-aligned. ``shared_tables`` reuses
    one ``prepare_cull_inputs(tris, strategy)`` across such builds."""
    if strategy not in _CULL_CHUNKS:
        raise ValueError(f"strategy must be one of {_CULL_STRATEGIES}, got {strategy!r}")
    device = tris.origin.device
    tables = prepare_cull_inputs(tris, strategy) if shared_tables is None else shared_tables
    T = tables.packed.shape[0]
    box_min = np.asarray(box_min, np.float32)

    s = 1 << start_depth
    cell = box_size / s
    zi, yi, xi = np.meshgrid(np.arange(s), np.arange(s), np.arange(s), indexing="ij")
    centers_np = np.stack(
        [
            box_min[0] + cell * (xi.ravel() + 0.5),
            box_min[1] + cell * (yi.ravel() + 0.5),
            box_min[2] + cell * (zi.ravel() + 0.5),
        ],
        axis=-1,
    ).astype(np.float32)
    if seed_cells is not None:
        centers_np = centers_np[seed_cells[0] : seed_cells[1]]
    n0 = centers_np.shape[0]
    Tp = _round_pow2(T, 8)
    lane = torch.arange(Tp, dtype=torch.int32, device=device)
    cand = torch.where(lane < T, lane, 0).expand(n0, Tp)
    valid = (lane < T).expand(n0, Tp)

    b = _ExactBuild(strategy, tables, min_triangles_per_node, max_depth, futility,
                    pair_budget)
    grid_words = -(-n0 // 8) * 8
    b.blocks.append(np.zeros(grid_words, np.uint32))
    b.total_len = grid_words

    half = 0.5 * cell
    centers = torch.as_tensor(centers_np, device=device)
    work = [([(centers, cand, valid, np.arange(n0, dtype=np.int64), None)],
             start_depth, half)]
    while work:
        groups, depth, half = work.pop()
        proj = sum(8 * g[1].shape[0] * g[1].shape[1] for g in groups)
        n_nodes = sum(g[0].shape[0] for g in groups)
        if proj > entry_budget and n_nodes > 1:
            slices = _split_groups(groups, entry_budget)
            if len(slices) > 1:
                b.stats["build_splits"] += len(slices) - 1
                for sl in reversed(slices):
                    work.append((sl, depth, half))
                continue
            groups = slices[0]
        npd = b.stats["nodes_per_depth"]
        npd[depth] = npd.get(depth, 0) + n_nodes

        next_buckets: dict[int, list] = {}
        pending: collections.deque = collections.deque()
        for g in groups:
            pending.append((g, b.cull(g, half)))
            if len(pending) >= _CULL_GROUPS_IN_FLIGHT:
                b.finish(*pending.popleft(), depth, half, next_buckets)
        while pending:
            b.finish(*pending.popleft(), depth, half, next_buckets)
        del groups

        merged = []
        for w, parts in sorted(next_buckets.items()):
            merged.append((
                torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]),
                np.concatenate([p[3] for p in parts]),
                np.concatenate([p[4] for p in parts]),
            ))
        if merged:
            work.append((merged, depth + 1, half * 0.5))

    # node array padded to whole 64-word blocks, child/leaf words patched in
    tail = (-b.total_len) % 64
    octree = np.concatenate(b.blocks + [np.zeros(tail, np.uint32)])
    for slots, words in b.slot_patches:
        octree[slots] = words

    counts = (
        np.concatenate([c for _, c in b.leaf_chunks])
        if b.leaf_chunks else np.zeros(0, np.int64)
    )
    spans = (-(-np.maximum(counts, 1) // _LEAF_CHUNK) * _LEAF_CHUNK).astype(np.int64)
    total = int(spans.sum()) if len(spans) else _LEAF_CHUNK
    slab = _LEAF_CHUNK * _SLAB_ROWS
    total = -(-total // slab) * slab
    L = max(b.leaf_counter, 1)
    leaf_offset = np.zeros(L, np.int32)
    leaf_count = np.zeros(L, np.int32)
    if len(counts):
        leaf_offset[: len(counts)] = np.concatenate([[0], np.cumsum(spans)[:-1]])
        leaf_count[: len(counts)] = counts

    tri_flat = _fill_tri_flat(b.leaf_chunks, leaf_offset, total, device)
    leaf_centers = (
        np.concatenate(b.leaf_centers) if b.leaf_centers
        else np.zeros((L, 3), np.float32)
    )
    return octree, leaf_offset, leaf_count, tri_flat, leaf_centers, b.stats


class ExactOctreeSdf(SdfFunction):
    """Octree whose leaves store exact nearest-triangle candidate lists.

    ``device`` holds the structure and runs the build and the queries;
    query points may come as numpy arrays or tensors on any device and
    results are tensors on ``device``. ``strategy`` names the build's cull
    (``_CULL_STRATEGIES``); every one keeps a superset of each node's
    possible winners, so the answers do not depend on it.

    The scan's bucket tables take one of three tiers, decided from the
    byte budget before anything is built (the JAX package's
    ``make_bucket_tables``): "vertex9" (9 world-vertex floats a slot,
    kernel K1 on a CUDA device), "frame19" (the 19 packed frame fields a
    slot) and "id_only" (no field table: each slot's fields gathered from
    the triangle table at query time). ``bucket_format`` "auto" and
    "vertex9" take the vertex tier where it fits the budget, "frame19" the
    frame tier; a table over the budget takes the id-only tier. The
    frame19 and id-only scans run in plain torch on any device. An
    out-of-memory error while a table is built propagates."""

    def __init__(
        self,
        mesh: Mesh,
        box: BoundingBox,
        max_depth: int = 7,
        start_depth: int = 2,
        min_triangles_per_node: int = 128,
        strategy: str = "region",
        futility: float | None = 0.8,
        entry_budget: int = 1 << 27,
        bucket_byte_budget: int | None = None,
        *,
        bucket_format: str = "auto",
        device="cuda",
    ):
        if strategy not in _CULL_CHUNKS:
            raise ValueError(f"strategy must be one of {_CULL_STRATEGIES}, got {strategy!r}")
        device = resolve_device(device)
        cbox = box.cubified()
        triangles = soa_to_torch(calculate_mesh_triangle_data(mesh), device)
        octree, leaf_offset, leaf_count, tri_flat, leaf_centers, stats = _build_exact(
            triangles, cbox.min, float(cbox.size[0]), int(max_depth),
            int(start_depth), int(min_triangles_per_node),
            futility=futility, entry_budget=entry_budget, strategy=strategy,
        )
        self._set_state(
            device=device,
            box=cbox,
            start_grid_size=1 << int(start_depth),
            max_depth=int(max_depth),
            min_triangles_per_node=int(min_triangles_per_node),
            strategy=strategy,
            octree_data=octree,
            leaf_offset=leaf_offset,
            leaf_count=leaf_count,
            tri_flat=tri_flat,
            leaf_centers=leaf_centers,
            sorted_lists=True,
            bucket_byte_budget=(
                _DEFAULT_BUCKET_BYTES if bucket_byte_budget is None
                else int(bucket_byte_budget)
            ),
            triangles=triangles,
            bucket_format=bucket_format,
        )
        self.build_stats = stats

    @classmethod
    def from_jax_state(cls, state: dict, device="cuda", *,
                       bucket_format: str = "auto") -> "ExactOctreeSdf":
        """The structure held by a state dict of the JAX package's
        ``ExactOctreeSdf._state_arrays()`` (the ``.npz`` container's
        arrays, ``tri_*`` included), on ``device``."""
        self = cls.__new__(cls)
        device = resolve_device(device)
        L = max(int(np.asarray(state["leaf_count"]).shape[0]), 1)
        self._set_state(
            device=device,
            box=BoundingBox(state["box_min"], state["box_max"]),
            start_grid_size=int(state["start_grid_size"]),
            max_depth=int(state["max_depth"]),
            min_triangles_per_node=int(state["min_triangles_per_node"]),
            strategy=str(state.get("strategy", "lattice")),
            octree_data=np.asarray(state["octree_data"], np.uint32),
            leaf_offset=np.asarray(state["leaf_offset"], np.int32),
            leaf_count=np.asarray(state["leaf_count"], np.int32),
            tri_flat=torch.as_tensor(
                np.array(state["tri_flat"], np.int32), device=device
            ),
            leaf_centers=np.asarray(
                state.get("leaf_centers", np.zeros((L, 3))), np.float32
            ),
            sorted_lists=bool(state.get("sorted_lists", "leaf_centers" in state)),
            bucket_byte_budget=int(
                state.get("bucket_byte_budget", _DEFAULT_BUCKET_BYTES)
            ),
            triangles=soa_to_torch(
                TriangleDataSoA(*(state[f"tri_{n}"] for n in TriangleDataSoA._fields)),
                device,
            ),
            bucket_format=bucket_format,
        )
        self.build_stats = {}
        return self

    def _set_state(self, *, device, box, start_grid_size, max_depth,
                   min_triangles_per_node, strategy, octree_data, leaf_offset,
                   leaf_count, tri_flat, leaf_centers, sorted_lists,
                   bucket_byte_budget, triangles, bucket_format="auto"):
        if bucket_format not in _BUCKET_FORMATS:
            raise ValueError(f"bucket_format must be one of {_BUCKET_FORMATS}, "
                             f"got {bucket_format!r}")
        self.device = device
        self.box = box
        self.start_grid_size = start_grid_size
        self.start_depth = int(np.log2(start_grid_size))
        self.max_depth = max_depth
        self.min_triangles_per_node = min_triangles_per_node
        self.strategy = strategy
        self.octree_data = octree_data
        self.leaf_offset = leaf_offset
        self.leaf_count = leaf_count
        self.tri_flat = tri_flat
        self.leaf_centers = leaf_centers
        self._sorted_lists = sorted_lists
        self.bucket_byte_budget = bucket_byte_budget
        self.bucket_format = bucket_format
        self.triangles = triangles
        # row-major (T, 48): K7 reads a winner's fields and world vertices
        # as one row, its frame as five 16-byte loads
        self._finish_table = finish_table(triangles)
        size = float(box.size[0])
        self._box_min = torch.as_tensor(box.min, device=device)
        self._box_size3 = torch.full((3,), size, device=device)
        # the same six float32 values on the host, K7's box by value
        self._box_host = (*map(float, box.min), size, size, size)
        # the box fallback's constant: sqrt(3) * box size, in float32
        self._fallback = _f32(_F32_SQRT3 * np.float32(box.size[0]))
        self.scan_chunk = _LEAF_CHUNK
        self._make_buckets()
        self._default_scan_impl()
        self._group_width_cache: dict[int, int] = {}
        self.last_scan_stats: dict = {}
        self._leaf_grid = None
        self._octree_dev = torch.as_tensor(octree_data.astype(np.int64), device=device)
        if max_depth <= _AUTO_GRID_DEPTH:
            self.build_query_grid()

    def build_query_grid(self) -> None:
        """The dense leaf-id grid at max_depth resolution (4 bytes a finest
        cell, 8^max_depth cells): descent becomes one gather. Built on its
        own up to depth 7; deeper structures opt in here."""
        grid = _build_leaf_grid(self.octree_data, self.start_grid_size, self.max_depth)
        lid = (grid[:, 0] & CHILDREN_INDEX_MASK).astype(np.int32)
        self._leaf_grid = torch.as_tensor(lid, device=self.device)

    def _make_buckets(self):
        """The scan's tables at ``scan_chunk`` slots a row: ``bucket_ids``
        (NB, CH) int32 (a view of ``tri_flat`` for CH <= 64, a repacked
        CSR for 128 or 256), ``bucket_fields`` (NB, nf * CH) f32 with each
        slot's fields, field-major (nf = 9 vertex floats or the 19 packed
        frame fields; None in the id-only tier), and per leaf its first
        row and row count. The tier is decided from the slot count before
        anything is built (the JAX package's ``make_bucket_tables``)."""
        CH = self.scan_chunk
        if self.tri_flat.numel() % _LEAF_CHUNK:
            raise ValueError("tri_flat spans must be 64-slot aligned")
        cnt = self.leaf_count.astype(np.int64)
        if CH <= _LEAF_CHUNK:
            n_slots = self.tri_flat.numel()
            spans = -(-np.maximum(cnt, 1) // _LEAF_CHUNK) * (_LEAF_CHUNK // CH)
        else:
            spans = -(-np.maximum(cnt, 1) // CH)
            n_slots = int(spans.sum()) * CH
        fmt, budget = self.bucket_format, self.bucket_byte_budget
        if fmt in ("auto", "vertex9") and n_slots * 9 * 4 <= budget:
            tier, nf = "vertex9", 9
        elif fmt != "vertex9" and n_slots * NUM_PACKED_FIELDS * 4 <= budget:
            tier, nf = "frame19", NUM_PACKED_FIELDS
        else:
            tier, nf = "id_only", 0
        if CH <= _LEAF_CHUNK:
            ids = self.tri_flat.view(-1, CH)
        elif tier == "id_only":
            raise ValueError("wide scan chunks require a dense bucket tier")
        else:
            ids = self._repacked_ids(spans, CH)
        self.bucket_tier = tier
        self.bucket_ids = ids
        self.bucket_fields = None
        self._packed_t = None
        if tier == "vertex9":
            src_t = self.triangles.v_world.reshape(-1, 9).t().contiguous()   # (9, T)
        else:
            src_t = pack_triangle_fields(self.triangles).t().contiguous()    # (19, T)
            if tier == "id_only":
                self._packed_t = src_t
        if tier != "id_only":
            fields = torch.empty((ids.shape[0], nf * CH), dtype=torch.float32,
                                 device=self.device)
            step = max(1, (1 << 22) // CH)
            for i in range(0, ids.shape[0], step):
                blk = ids[i : i + step]
                safe = blk.clamp_min(0).long()
                live = blk >= 0
                fields[i : i + step] = torch.cat(
                    [torch.where(live, src_t[r][safe], 0.0) for r in range(nf)], dim=1
                )
            self.bucket_fields = fields
        row0 = np.concatenate([[0], np.cumsum(spans)[:-1]]).astype(np.int32)
        self.leaf_row0 = torch.as_tensor(row0, device=self.device)
        self.leaf_nchunks = torch.as_tensor(
            (-(-cnt // CH)).astype(np.int32), device=self.device
        )
        # K9 reads a leaf's two bounds as one 8-byte word (K1g reads the
        # two arrays above)
        self._leaf_bounds = leaf_bounds(self.leaf_row0, self.leaf_nchunks)

    def _repacked_ids(self, spans, CH: int):
        """The CSR repacked into CH-slot spans (CH a multiple of 64; the
        JAX package's ``make_bucket_tables``), as (rows, CH) int32."""
        cnts = self.leaf_count.astype(np.int64)
        tf = self.tri_flat.cpu().numpy()
        spans64 = -(-np.maximum(cnts, 1) // _LEAF_CHUNK)
        off64 = np.concatenate([[0], np.cumsum(spans64)[:-1]]) * _LEAF_CHUNK
        row0w = np.concatenate([[0], np.cumsum(spans)[:-1]])
        nl = np.repeat(np.arange(len(cnts)), cnts)
        k = np.arange(int(cnts.sum()), dtype=np.int64) - np.repeat(np.cumsum(cnts) - cnts, cnts)
        new_flat = np.full(int(spans.sum()) * CH, -1, np.int32)
        new_flat[row0w[nl] * CH + k] = tf[off64[nl] + k]
        return torch.as_tensor(new_flat.reshape(-1, CH), device=self.device)

    def set_scan_chunk(self, chunk: int) -> None:
        """Rebuild the bucket tables at ``chunk`` slots a row: a divisor of
        the build's 64-slot span alignment, or 128 or 256 (the CSR repacked
        into wider spans). Kernel K1 takes 64-slot rows only (``kCH`` in
        ``csrc/scan_window.cu``), so another chunk runs the plain scans at
        that chunk; the answers do not change."""
        chunk = int(chunk)
        if chunk <= 64:
            if chunk < 1 or 64 % chunk:
                raise ValueError("scan chunk must divide 64")
        elif chunk % 64 or chunk > 256:
            raise ValueError("wide scan chunk must be 128 or 256")
        if chunk == self.scan_chunk:
            return
        if self._pinned_kernel and chunk != _LEAF_CHUNK:
            raise ValueError("kernel K1 is pinned and takes 64-slot rows only")
        if chunk > 64:
            # validate before any state changes: the id-only tier indexes
            # 64-aligned spans
            cnts = self.leaf_count.astype(np.int64)
            slots = int(np.sum(-(-np.maximum(cnts, 1) // chunk))) * chunk
            nf_est = NUM_PACKED_FIELDS if self.bucket_format == "frame19" else 9
            if slots * nf_est * 4 > self.bucket_byte_budget:
                raise ValueError("wide scan chunks require dense vertex buckets "
                                 "within the byte budget")
        self.scan_chunk = chunk
        # drop the old tables before the new ones are built
        self.bucket_ids = self.bucket_fields = None
        self._make_buckets()
        self._group_width_cache.clear()

    @property
    def num_leaves(self) -> int:
        return int(self.leaf_count.shape[0])

    @property
    def bucket_bytes(self) -> int:
        fields = 0 if self.bucket_fields is None else self.bucket_fields.numel()
        return 4 * (self.bucket_ids.numel() + fields)

    @property
    def _kernel_tables(self) -> bool:
        """Whether the tables are the ones kernel K1 reads: vertex rows of
        64 slots."""
        return self.bucket_tier == "vertex9" and self.scan_chunk == _LEAF_CHUNK

    # -- scan choice ----------------------------------------------------------

    def _default_scan_impl(self) -> None:
        """Let each query choose its scan by the batch's density (an
        explicit ``set_scan_impl`` pins the choice)."""
        self._pinned_scan = None
        self._pinned_kernel = False

    def set_scan_impl(self, impl: str) -> None:
        """Pin the candidate scan by the JAX package's names: "xla" and
        "pallas" the grouped scan, "xla_window" and "pallas_window" the
        window scan. Either runs kernel K1 on a CUDA device where the tables
        are K1's (the vertex tier at 64 slots a row), else the plain scan
        over the tier's tables; "pallas" and "pallas_window" pin K1 itself
        and raise on other tables, and the window scan raises on the
        id-only tier, as in the JAX package."""
        if impl not in _SCAN_IMPLS:
            raise ValueError(f"unknown scan impl {impl!r}")
        if impl == "xla_window" and self.bucket_tier == "id_only":
            raise ValueError("xla_window scan requires dense field buckets")
        kernel = impl.startswith("pallas")
        if kernel and self.bucket_tier != "vertex9":
            raise ValueError("pallas scan requires vertex-format dense buckets "
                             f"(kernel K1); this structure has {self.bucket_tier}")
        if kernel and self.scan_chunk != _LEAF_CHUNK:
            raise ValueError("kernel K1 takes 64-slot rows; set_scan_chunk(64) first")
        self._pinned_scan = _SCAN_IMPLS[impl]
        self._pinned_kernel = kernel

    @staticmethod
    def _padded_batch(P: int) -> int:
        """The JAX package's padded batch size: below the query block the
        next power of two (floor 1024), else a multiple of the block. The
        port pads nothing; the size only feeds the scan choice and the
        group-width cache, so a batch takes the same scan in both."""
        B = _QUERY_BLOCK
        if P < B:
            B = max(1 << (max(P - 1, 1)).bit_length(), 1024)
        return -(-max(P, 1) // B) * B

    def _choose_scan(self, P: int) -> str:
        """"grouped", "window" or "id_only" for a batch of P points."""
        if self.bucket_tier == "id_only":
            return "id_only"
        if self._pinned_scan is not None:
            return self._pinned_scan
        sparse = self._padded_batch(P) < _SPARSE_POINTS_PER_LEAF * self.num_leaves
        return "grouped" if sparse else "window"

    # -- queries ------------------------------------------------------------

    def _descend(self, pts):
        """Leaf id (int64) of each (P, 3) point; points outside the box
        take the clamped boundary cell."""
        if self._leaf_grid is not None:
            return self._leaf_keys(pts.to(torch.float32).contiguous()).long()
        # node walk (ExactOctreeSdf.cpp:57-66; strict '>' child rounding).
        # The position in the child is 2 frac minus the child's bit: a point
        # at exactly 0.5 goes to the lower child at its upper face (frac 1).
        # The JAX package's walk takes 2 frac - floor(2 frac), which puts
        # such a point at the lower child's lower face, and from there into
        # a leaf that need not contain it (ROADMAP.md, Queue 3).
        s = self.start_grid_size
        cell = self._box_size3 / s
        frac = (pts - self._box_min) / cell
        ipos = frac.floor().to(torch.int32)
        frac = frac - ipos
        word = self._octree_dev[self._start_index(ipos.clamp(0, s - 1).long())]
        for _ in range(self.max_depth - self.start_depth):
            is_leaf = (word & int(IS_LEAF_MASK)) != 0
            bits = frac > 0.5
            child = (bits[:, 2].long() << 2) + (bits[:, 1].long() << 1) + bits[:, 0].long()
            base = word & int(CHILDREN_INDEX_MASK)
            nxt = self._octree_dev[torch.where(is_leaf, 0, base + child)]
            nfrac = 2.0 * frac - bits.to(frac.dtype)
            word = torch.where(is_leaf, word, nxt)
            frac = torch.where(is_leaf[:, None], frac, nfrac)
        return word & int(CHILDREN_INDEX_MASK)

    def _start_index(self, ic):
        """The flat word index of each (P, 3) start cell (z-major)."""
        s = self.start_grid_size
        return ic[:, 2] * (s * s) + ic[:, 1] * s + ic[:, 0]

    def _leaf_keys(self, pts):
        """The int32 sort key of each contiguous (P, 3) float32 point, its
        leaf id: K8 on the dense leaf grid, else the node walk."""
        if self._leaf_grid is None:
            return self._descend(pts).to(torch.int32)
        return exact_descend(pts, self._leaf_grid, self._box_min, self._box_size3, self.max_depth)

    def _sort_by_leaf(self, pts, plain: bool = False):
        """(leaf ids sorted (int32, stable), the sort order (int64)): the
        leaf sort's lean launch on the card, over the dense grid's keys or
        the node walk's, else (and with ``plain``) its plain version, K8's
        plain keys and ``torch.sort``."""
        grid = self._leaf_grid
        host = plain or not pts.is_cuda
        if grid is None:
            keys = self._leaf_keys(pts)
            if host:
                return leaf_sort_plain(keys)
            return launch_leaf_sort(keys, None, None, 0, sort_bits(self.num_leaves))
        if host:
            return leaf_sort_plain(pts, grid, self._box_min, self._box_size3, self.max_depth)
        return launch_leaf_sort(pts, grid, self._box_host, self.max_depth,
                                sort_bits(self.num_leaves))

    def _sorted_windows(self, pts, plain: bool = False, size: int | None = None):
        """Points sorted by leaf (stable) and padded to whole windows (or
        to ``size``), with each point's first bucket row and row count (0
        for padding), and the sort order: K9 on the card (its lean launch
        over the packed leaf bounds), else its plain version. ``pts`` is
        a contiguous (P, 3) float32 tensor."""
        lid_s, order = self._sort_by_leaf(pts, plain)
        P = pts.shape[0]
        size = P + (-P) % WINDOW if size is None else size
        if plain or not pts.is_cuda:
            pts_s, b0, nc = exact_sorted_gather_plain(pts, order, lid_s, self.leaf_row0,
                                                      self.leaf_nchunks, size=size)
        else:
            pts_s, b0, nc = launch_sorted_gather(pts, order, lid_s, self._leaf_bounds, size)
        return pts_s, b0, nc, order

    def _pick_group_width(self, lid_s, Pp: int) -> int:
        """Group width from the points per touched leaf of the padded batch
        (the JAX package pads with points at the origin), cached per padded
        size: G = min(64, max(8, round_pow2(Pp // touched))). The first
        batch of a size sets it, under a lock: parallel's workers may query
        one structure at once."""
        with _GROUP_WIDTH_LOCK:
            G = self._group_width_cache.get(Pp)
            if G is None:
                touched = int((lid_s[1:] != lid_s[:-1]).sum()) + 1 if len(lid_s) else 0
                if Pp > len(lid_s):
                    origin = self._descend(torch.zeros((1, 3), device=self.device))
                    touched += int(not bool((lid_s == origin).any()))
                G = min(64, max(8, _round_pow2(max(1, Pp // max(touched, 1)), 1)))
                self._group_width_cache[Pp] = G
        return G

    def _sorted_groups(self, pts, plain: bool = False):
        """Points sorted by leaf (K9, or with ``plain`` its plain version),
        their leaf ids (int32, the sort's keys), the CSR offsets (NG + 1,)
        of the groups (runs of at most G points of one leaf; trailing
        groups past the last are empty), G, and the sort order. Port of
        the JAX package's ``_assign_groups``, with no host sync once G is
        cached: NG is the bound min(P, P // G + L). Each run's start is a
        binary search of the sorted ids for themselves: the JAX package's
        max-scan, as ``torch.cummax`` over int64, took 2.85 of the 7.52 ms
        d7 2^20-point query on an H100 (PERF.md)."""
        lid_s, order = self._sort_by_leaf(pts, plain)
        P = pts.shape[0]
        if plain or not pts.is_cuda:
            pts_s, _, _ = exact_sorted_gather_plain(pts, order)
        else:
            pts_s, _, _ = launch_sorted_gather(pts, order, None, None, P)
        G = self._pick_group_width(lid_s, self._padded_batch(P))
        i = torch.arange(P, dtype=torch.int64, device=self.device)
        seg_start = torch.searchsorted(lid_s, lid_s)
        boundary = (i - seg_start) % G == 0
        gid = torch.cumsum(boundary, dim=0) - 1
        NG = min(P, P // G + self.num_leaves)
        start = torch.full((NG + 1,), P, dtype=torch.int32, device=self.device)
        # non-boundary points land in the spare last slot, then reset to P
        start.scatter_(0, torch.where(boundary, gid, NG), i.to(torch.int32))
        start[NG] = P
        return pts_s, lid_s, start, G, order

    def _query(self, points, with_gradient: bool, plain: bool = False,
               plain_glue: bool = False):
        """The query: the leaf sort (K8's key and a stable sort by leaf),
        K9 (the sorted gather), the scan (K1 over K1's tables, else the
        plain scans) and K7 (the finish and the unsort). ``plain`` runs
        every step's plain version (a yardstick on the card);
        ``plain_glue`` only those of the sort, K9 and K7 (K8's plain keys
        and ``torch.sort``), with K1 (the card's A/B of K7-K9)."""
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        flat = pts.reshape(-1, 3).contiguous()
        P = flat.shape[0]
        kind = self._choose_scan(P)
        kernel = self._kernel_tables and not plain
        glue = plain or plain_glue
        if kind == "id_only":
            pts_s, b0, nc, order = self._sorted_windows(flat, glue, size=P)
            win = scan_id_only(self.bucket_ids, self._packed_t, pts_s, b0, nc)
            stats = {"scan": kind, "G": 0, "NG": 0}
        elif kind == "grouped":
            pts_s, lid_s, start, G, order = self._sorted_groups(flat, glue)
            scan = scan_grouped if kernel else scan_grouped_plain
            win = scan(self.bucket_ids, self.bucket_fields, pts_s, lid_s, start,
                       self.leaf_row0, self.leaf_nchunks)
            stats = {"scan": kind, "G": G, "NG": start.shape[0] - 1}
        else:
            pts_s, b0, nc, order = self._sorted_windows(flat, glue)
            scan = scan_window if kernel else scan_window_plain
            win = scan(self.bucket_ids, self.bucket_fields, pts_s, b0, nc).reshape(-1)
            stats = {"scan": kind, "G": WINDOW, "NG": pts_s.shape[0] // WINDOW}
        # one assignment: parallel's workers may query one structure at once
        self.last_scan_stats = {**stats, "tier": self.bucket_tier}
        if glue or not flat.is_cuda:
            out = exact_finish_plain(pts_s[:P], win[:P], order, self._finish_table,
                                     self._box_min, self._box_size3, self._fallback,
                                     with_gradient=with_gradient)
        else:       # K7 reads the first P of the padded sorted points
            out = launch_exact_finish(pts_s, win, order, P, self._finish_table,
                                      self._box_host, self._fallback, with_gradient)
        if with_gradient:
            return out[0].reshape(pts.shape[:-1]), out[1].reshape(pts.shape)
        return out.reshape(pts.shape[:-1])

    def get_distance(self, points):
        return self._query(points, with_gradient=False)

    def get_distance_and_gradient(self, points):
        return self._query(points, with_gradient=True)

    def get_sample_area(self) -> BoundingBox:
        return self.box

    def get_format(self) -> SdfFormat:
        return SdfFormat.EXACT_OCTREE

    # -- serialization --------------------------------------------------------

    def _state_arrays(self) -> dict:
        """The arrays of the JAX package's container schema."""
        return {
            "box_min": np.asarray(self.box.min, np.float32),
            "box_max": np.asarray(self.box.max, np.float32),
            "start_grid_size": np.int32(self.start_grid_size),
            "max_depth": np.int32(self.max_depth),
            "min_triangles_per_node": np.int32(self.min_triangles_per_node),
            "octree_data": np.asarray(self.octree_data, np.uint32),
            "leaf_offset": np.asarray(self.leaf_offset, np.int32),
            "leaf_count": np.asarray(self.leaf_count, np.int32),
            "tri_flat": self.tri_flat.cpu().numpy().astype(np.int32),
            "leaf_centers": np.asarray(self.leaf_centers, np.float32),
            "sorted_lists": np.bool_(self._sorted_lists),
            "strategy": np.array(self.strategy),
            "bucket_byte_budget": np.int64(self.bucket_byte_budget),
            **{
                f"tri_{name}": arr.cpu().numpy().astype(np.float32)
                for name, arr in self.triangles._asdict().items()
            },
        }
