"""Exact octree SDF: leaves hold culled nearest-triangle candidate lists.

Port of the JAX package's ``sdf/exact_octree.py`` (reference:
ExactOctreeSdf.h:35-218, ExactOctreeSdf.cpp:7-320), region cull and
the window and grouped scans only:

* Build: a level loop over node groups. Each group's candidate lists are
  culled by the per-node-region influence test (``_region_cull_chunk``,
  the reference's PerNodeRegionTrianglesInfluence role) in chunks of
  (C, K) pairs; nodes at ``min_triangles_per_node``, ``max_depth`` or the
  futility ratio become leaves whose lists are sorted by distance to the
  leaf centre; the rest subdivide. Leaf lists are stored CSR-style in
  ``tri_flat``, each span -1 padded to a multiple of 64.
* Buckets: ``tri_flat`` viewed as 64-slot rows, beside a (rows, 9*64)
  table of the slots' world vertices (field-major), and per leaf its
  first row and row count.
* Query: dense-grid descent (or the node walk past depth 7), a stable
  sort of the points by leaf carrying the original index, the scan
  (kernel K1 on a CUDA device), the signed evaluation of each winner,
  the box fallback outside the domain (box distance + sqrt(3) * box
  size, ExactOctreeSdf.cpp:44-49), and the unsort. The scan takes fixed
  windows of 32 sorted points for dense batches and leaf-aligned groups
  of G points for sparse ones (padded batch < 4 points per leaf, the JAX
  package's rule), unless ``set_scan_impl`` pins one.

The state round-trips through the ``.npz`` container of the JAX package
(``from_jax_state``, ``save``, ``SdfFunction.load``).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..mesh import BoundingBox, Mesh
from ..ops.box import box_distance, box_distance_gradient
from ..ops.point_triangle import (
    gather_triangles,
    pack_triangle_fields,
    pack_triangle_full_fields,
    signed_dist_from_rows,
    signed_dist_grad_pair,
    sq_dist_and_grad_from_field_fn,
    sq_dist_from_field_fn,
)
from ..ops.scan import (
    WINDOW,
    scan_grouped,
    scan_grouped_plain,
    scan_window,
    scan_window_plain,
)
from ..triangle import TriangleDataSoA, calculate_mesh_triangle_data, soa_to_torch
from .octree import _build_leaf_grid
from .octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK, _round_pow2
from .sdf_function import SdfFormat, SdfFunction, resolve_device

__all__ = ["ExactOctreeSdf"]

# 8 cube corners in {-1,1}^3 (units of the node half size).
_CORNER_OFFS = np.array(
    [[(c & 1) * 2 - 1, ((c >> 1) & 1) * 2 - 1, ((c >> 2) & 1) * 2 - 1]
     for c in range(8)],
    np.float32,
)
# 27 half-step lattice anchors in {-1,0,1}^3; anchor 13 is the centre.
_LATTICE_OFFS = np.array(
    [[i, j, k] for k in (-1, 0, 1) for j in (-1, 0, 1) for i in (-1, 0, 1)],
    np.float32,
)
_F32_SQRT3 = np.sqrt(np.float32(3.0))

_LEAF_CHUNK = 64      # slots per bucket row; CSR spans pad to a multiple
_SLAB_ROWS = 256      # tri_flat pads to whole slabs, as the JAX build does
_AUTO_GRID_DEPTH = 7  # dense leaf grid up to this depth (4 B per cell)
_CULL_GROUPS_IN_FLIGHT = 2
_DEFAULT_BUCKET_BYTES = 4 << 30
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


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


def _region_cull_chunk(packed, packed_t, centers, cand_idx, cand_valid, half):
    """Per-node-region influence cull of one (C, K) chunk.

    At each of the 27 half-step anchors l of a node, with sub-cube corner
    offsets q, keep candidate t iff

        min over the 8 corners q of [d_t(l) + g_t(l).(q - l) - d_b(q)] <= eps

    where b is the anchor's nearest candidate and g_t the gradient of the
    unsigned distance, or when d_t(l) lies within the sub-cube radius. The
    tangent under-estimates the convex d_t and the trilinear corner
    interpolation over-estimates d_b, so every possible winner inside the
    sub-cube survives (see the JAX package's docstring). The gradient is
    computed analytically as 2 (p - proj) / (2 d), branch by branch of the
    region ladder.

    ``packed`` is the (T, 19) field table, ``packed_t`` its transpose.
    Returns (keep (C, K) bool, kept counts (C,), squared distance to the
    node centre (C, K), the leaf-list sort key)."""
    idx = cand_idx.long()
    cols = [packed_t[r][idx] for r in range(packed_t.shape[0])]
    px, py, pz = centers[:, 0:1], centers[:, 1:2], centers[:, 2:3]
    qh = _f32(np.float32(0.5) * np.float32(half))
    s = _f32(_F32_SQRT3 * np.float32(qh))
    eps = _f32(np.float32(2e-3) * np.float32(half))
    near = _f32(np.float32(s) + np.float32(eps))
    offs = _LATTICE_OFFS * np.float32(half)
    q = torch.as_tensor(_CORNER_OFFS * np.float32(qh), device=centers.device)

    keep = torch.zeros(cand_idx.shape, dtype=torch.bool, device=centers.device)
    sqd_center = None
    for l in range(27):
        ox, oy, oz = (float(v) for v in offs[l])
        lx, ly, lz = px + ox, py + oy, pz + oz                    # (C, 1)
        sqd, gx2, gy2, gz2 = sq_dist_and_grad_from_field_fn(
            lx, ly, lz, lambda r: cols[r]
        )
        sqd = torch.where(cand_valid, sqd, torch.inf)
        if l == 13:
            sqd_center = sqd
        d_l = sqd.sqrt()
        inv = 0.5 / d_l.clamp_min(1e-20)
        gx, gy, gz = gx2 * inv, gy2 * inv, gz2 * inv

        # the anchor's nearest candidate, evaluated at the 8 corners
        b = idx.gather(1, sqd.argmin(dim=1, keepdim=True))[:, 0]
        fb = packed[b]                                            # (C, 19)
        d_b = sq_dist_from_field_fn(
            lx + q[:, 0], ly + q[:, 1], lz + q[:, 2], lambda r: fb[:, r : r + 1]
        ).sqrt()                                                  # (C, 8)
        phi = (
            d_l[..., None]
            + gx[..., None] * q[:, 0]
            + gy[..., None] * q[:, 1]
            + gz[..., None] * q[:, 2]
            - d_b[:, None, :]
        )                                                         # (C, K, 8)
        keep |= (phi.amin(dim=-1) <= eps) | (d_l <= near)
    keep &= cand_valid
    return keep, keep.sum(dim=1), sqd_center


def _cull_group(packed, packed_t, centers, cand, valid, half, C):
    """The region cull of a node group, in chunks of C nodes."""
    parts = [
        _region_cull_chunk(
            packed, packed_t, centers[i : i + C], cand[i : i + C],
            valid[i : i + C], half,
        )
        for i in range(0, centers.shape[0], C)
    ]
    return tuple(torch.cat(x) for x in zip(*parts))


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


class _ExactBuild:
    """State of one level-synchronous exact build (``_build_exact``)."""

    def __init__(self, packed, min_triangles_per_node, max_depth, futility,
                 pair_budget):
        self.packed = packed
        self.packed_t = packed.t().contiguous()
        self.device = packed.device
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
        """Enqueue the cull of a group (no host sync)."""
        centers, cand, valid, _, _ = group
        N, K = cand.shape
        C = max(8, _round_pow2(max(1, self.pair_budget // max(K, 1)), 1) // 2)
        key = f"{C}x{K}"
        shapes = self.stats["cull_shapes"]
        shapes[key] = shapes.get(key, 0) + -(-N // C)
        return _cull_group(self.packed, self.packed_t, centers, cand, valid, half, C)

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
):
    """Level-synchronous exact build on the triangles' device. Returns
    (octree (N,) uint32, leaf_offset, leaf_count, tri_flat (device int32),
    leaf_centers, stats).

    Candidate state stays on the device; per group only the kept counts
    cross to the host. ``futility``: a node whose culled list keeps at
    least that share of its parent's list becomes a leaf (None disables
    the rule). Before a level whose children would exceed
    ``entry_budget`` candidate entries, the parents split into slices
    built depth first. At most ``_CULL_GROUPS_IN_FLIGHT`` groups' culls
    are enqueued ahead of the host's consumption, which bounds the live
    (N, K) cull outputs."""
    device = tris.origin.device
    packed = pack_triangle_fields(tris)
    T = packed.shape[0]
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
    n0 = centers_np.shape[0]
    Tp = _round_pow2(T, 8)
    lane = torch.arange(Tp, dtype=torch.int32, device=device)
    cand = torch.where(lane < T, lane, 0).expand(n0, Tp)
    valid = (lane < T).expand(n0, Tp)

    b = _ExactBuild(packed, min_triangles_per_node, max_depth, futility, pair_budget)
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

    tri_flat = torch.full((total,), -1, dtype=torch.int32, device=device)
    row0 = 0
    for ids, cnt in b.leaf_chunks:
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
    leaf_centers = (
        np.concatenate(b.leaf_centers) if b.leaf_centers
        else np.zeros((L, 3), np.float32)
    )
    return octree, leaf_offset, leaf_count, tri_flat, leaf_centers, b.stats


class ExactOctreeSdf(SdfFunction):
    """Octree whose leaves store exact nearest-triangle candidate lists.

    ``device`` holds the structure and runs the build and the queries;
    query points may come as numpy arrays or tensors on any device and
    results are tensors on ``device``. Only the "region" cull strategy is
    ported."""

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
        device="cuda",
    ):
        if strategy != "region":
            raise NotImplementedError(
                f"cull strategy {strategy!r} is not ported yet; only 'region' "
                "is (ROADMAP.md, Queue 1)"
            )
        device = resolve_device(device)
        cbox = box.cubified()
        triangles = soa_to_torch(calculate_mesh_triangle_data(mesh), device)
        octree, leaf_offset, leaf_count, tri_flat, leaf_centers, stats = _build_exact(
            triangles, cbox.min, float(cbox.size[0]), int(max_depth),
            int(start_depth), int(min_triangles_per_node),
            futility=futility, entry_budget=entry_budget,
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
        )
        self.build_stats = stats

    @classmethod
    def from_jax_state(cls, state: dict, device="cuda") -> "ExactOctreeSdf":
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
        )
        self.build_stats = {}
        return self

    def _set_state(self, *, device, box, start_grid_size, max_depth,
                   min_triangles_per_node, strategy, octree_data, leaf_offset,
                   leaf_count, tri_flat, leaf_centers, sorted_lists,
                   bucket_byte_budget, triangles):
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
        self.triangles = triangles
        # field-major (37, T): the finish gathers one contiguous column per
        # field (a gathered (P, 37) block would need a transposing copy)
        self._full_fields_t = pack_triangle_full_fields(triangles).t().contiguous()
        size = float(box.size[0])
        self._box_min = torch.as_tensor(box.min, device=device)
        self._box_size3 = torch.full((3,), size, device=device)
        self._make_buckets()
        self._default_scan_impl()
        self._group_width_cache: dict[int, int] = {}
        self.last_scan_stats: dict = {}
        if max_depth <= _AUTO_GRID_DEPTH:
            grid = _build_leaf_grid(octree_data, start_grid_size, max_depth)
            lid = (grid[:, 0] & CHILDREN_INDEX_MASK).astype(np.int32)
            self._leaf_grid = torch.as_tensor(lid, device=device)
            self._octree_dev = None
        else:
            self._leaf_grid = None
            self._octree_dev = torch.as_tensor(octree_data.astype(np.int64), device=device)

    def _make_buckets(self):
        """The scan's tables: ``bucket_ids`` (NB, 64) int32 (a view of
        ``tri_flat``), ``bucket_fields`` (NB, 9*64) f32 world vertices of
        every slot, field-major, and per leaf its first row and row count.
        A table over ``bucket_byte_budget`` raises: the id-only tier of the
        JAX package is not ported."""
        CH = _LEAF_CHUNK
        if self.tri_flat.numel() % CH:
            raise ValueError("tri_flat spans must be 64-slot aligned")
        ids = self.tri_flat.view(-1, CH)
        nbytes = ids.numel() * 9 * 4
        if nbytes > self.bucket_byte_budget:
            raise MemoryError(
                f"vertex bucket table needs {nbytes} B, over the budget of "
                f"{self.bucket_byte_budget} B (the id-only tier is not ported)"
            )
        vw_t = self.triangles.v_world.reshape(-1, 9).t().contiguous()   # (9, T)
        fields = torch.empty((ids.shape[0], 9 * CH), dtype=torch.float32,
                             device=self.device)
        step = 1 << 16
        for i in range(0, ids.shape[0], step):
            blk = ids[i : i + step]
            safe = blk.clamp_min(0).long()
            live = blk >= 0
            fields[i : i + step] = torch.cat(
                [torch.where(live, vw_t[r][safe], 0.0) for r in range(9)], dim=1
            )
        cnt = self.leaf_count.astype(np.int64)
        spans = -(-np.maximum(cnt, 1) // CH)
        row0 = np.concatenate([[0], np.cumsum(spans)[:-1]]).astype(np.int32)
        self.bucket_ids = ids
        self.bucket_fields = fields
        self.leaf_row0 = torch.as_tensor(row0, device=self.device)
        self.leaf_nchunks = torch.as_tensor(
            (-(-cnt // CH)).astype(np.int32), device=self.device
        )

    @property
    def num_leaves(self) -> int:
        return int(self.leaf_count.shape[0])

    @property
    def bucket_bytes(self) -> int:
        return 4 * (self.bucket_ids.numel() + self.bucket_fields.numel())

    # -- scan choice ----------------------------------------------------------

    def _default_scan_impl(self) -> None:
        """Let each query choose its scan by the batch's density (an
        explicit ``set_scan_impl`` pins the choice)."""
        self._pinned_scan = None

    def set_scan_impl(self, impl: str) -> None:
        """Pin the candidate scan by the JAX package's names: "xla" and
        "pallas" the grouped scan, "xla_window" and "pallas_window" the
        window scan (both run kernel K1 on a CUDA device)."""
        if impl not in _SCAN_IMPLS:
            raise ValueError(f"unknown scan impl {impl!r}")
        self._pinned_scan = _SCAN_IMPLS[impl]

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
        """"grouped" or "window" for a batch of P points."""
        if self._pinned_scan is not None:
            return self._pinned_scan
        sparse = self._padded_batch(P) < _SPARSE_POINTS_PER_LEAF * self.num_leaves
        return "grouped" if sparse else "window"

    # -- queries ------------------------------------------------------------

    def _descend(self, pts):
        """Leaf id (int64) of each (P, 3) point; points outside the box
        take the clamped boundary cell."""
        if self._leaf_grid is not None:
            g = 1 << self.max_depth
            rel = (pts - self._box_min) / self._box_size3
            cell = (rel * g).to(torch.int32).clamp(0, g - 1).long()
            lin = (cell[:, 2] * g + cell[:, 1]) * g + cell[:, 0]
            return self._leaf_grid[lin].long()
        # node walk (ExactOctreeSdf.cpp:57-66; strict '>' child rounding)
        s = self.start_grid_size
        cell = self._box_size3 / s
        frac = (pts - self._box_min) / cell
        ipos = frac.floor().to(torch.int32)
        frac = frac - ipos
        ic = ipos.clamp(0, s - 1).long()
        word = self._octree_dev[ic[:, 2] * (s * s) + ic[:, 1] * s + ic[:, 0]]
        for _ in range(self.max_depth - self.start_depth):
            is_leaf = (word & int(IS_LEAF_MASK)) != 0
            child = (
                ((frac[:, 2] > 0.5).long() << 2)
                + ((frac[:, 1] > 0.5).long() << 1)
                + (frac[:, 0] > 0.5).long()
            )
            base = word & int(CHILDREN_INDEX_MASK)
            nxt = self._octree_dev[torch.where(is_leaf, 0, base + child)]
            nfrac = 2.0 * frac
            nfrac = nfrac - nfrac.floor()
            word = torch.where(is_leaf, word, nxt)
            frac = torch.where(is_leaf[:, None], frac, nfrac)
        return word & int(CHILDREN_INDEX_MASK)

    def _sort_by_leaf(self, pts):
        """(points sorted by leaf (stable), their leaf ids (int64), the
        sort order)."""
        lid_s, order = torch.sort(self._descend(pts), stable=True)
        return pts[order], lid_s, order

    def _sorted_windows(self, pts):
        """Points sorted by leaf (stable) and padded to whole windows, with
        each point's first bucket row and row count (0 for padding), and
        the sort order."""
        pts_s, lid_s, order = self._sort_by_leaf(pts)
        pad = (-pts.shape[0]) % WINDOW
        zi = torch.zeros(pad, dtype=torch.int32, device=self.device)
        pts_s = torch.cat([pts_s, pts.new_zeros((pad, 3))])
        b0 = torch.cat([self.leaf_row0[lid_s], zi])
        nc = torch.cat([self.leaf_nchunks[lid_s], zi])
        return pts_s, b0, nc, order

    def _pick_group_width(self, lid_s, Pp: int) -> int:
        """Group width from the points per touched leaf of the padded batch
        (the JAX package pads with points at the origin), cached per padded
        size: G = min(64, max(8, round_pow2(Pp // touched)))."""
        G = self._group_width_cache.get(Pp)
        if G is None:
            touched = int((lid_s[1:] != lid_s[:-1]).sum()) + 1 if len(lid_s) else 0
            if Pp > len(lid_s):
                origin = self._descend(torch.zeros((1, 3), device=self.device))
                touched += int(not bool((lid_s == origin).any()))
            G = min(64, max(8, _round_pow2(max(1, Pp // max(touched, 1)), 1)))
            self._group_width_cache[Pp] = G
        return G

    def _sorted_groups(self, pts):
        """Points sorted by leaf, their leaf ids (int32), the CSR offsets
        (NG + 1,) of the groups (runs of at most G points of one leaf;
        trailing groups past the last are empty), G, and the sort order.
        Port of the JAX package's ``_assign_groups``, with no host sync
        once G is cached: NG is the bound min(P, P // G + L). Each run's
        start is a binary search of the sorted ids for themselves: the
        JAX package's max-scan, as ``torch.cummax`` over int64, took 2.85
        of the 7.52 ms d7 2^20-point query on an H100 (PERF.md)."""
        pts_s, lid_s, order = self._sort_by_leaf(pts)
        P = pts.shape[0]
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
        return pts_s, lid_s.to(torch.int32), start, G, order

    def _finish(self, pts, win, with_gradient):
        """Signed distance of each point to its winning triangle, with the
        box fallback outside the domain."""
        size = self._box_size3
        center = self._box_min + 0.5 * size
        fallback = _f32(_F32_SQRT3 * np.float32(self.box.size[0]))
        rel = (pts - self._box_min) / size
        in_box = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
        safe = win.clamp_min(0).long()
        if with_gradient:
            d_in, g_in = signed_dist_grad_pair(pts, gather_triangles(self.triangles, safe))
            d_out, g_out = box_distance_gradient(pts, center, size)
            return (
                torch.where(in_box, d_in, d_out + fallback),
                torch.where(in_box[:, None], g_in, g_out),
            )
        cols = self._full_fields_t
        d_in = signed_dist_from_rows(
            pts[:, 0], pts[:, 1], pts[:, 2], lambda r: cols[r][safe]
        )
        d_out = box_distance(pts, center, size)
        return torch.where(in_box, d_in, d_out + fallback)

    def _query(self, points, with_gradient: bool, plain: bool = False):
        """The query; ``plain`` runs the scans' plain versions (a
        yardstick on the card)."""
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        flat = pts.reshape(-1, 3).contiguous()
        P = flat.shape[0]
        kind = self._choose_scan(P)
        if kind == "grouped":
            pts_s, lid_s, start, G, order = self._sorted_groups(flat)
            scan = scan_grouped_plain if plain else scan_grouped
            win = scan(self.bucket_ids, self.bucket_fields, pts_s, lid_s, start,
                       self.leaf_row0, self.leaf_nchunks)
            self.last_scan_stats = {"scan": kind, "G": G, "NG": start.shape[0] - 1}
        else:
            pts_s, b0, nc, order = self._sorted_windows(flat)
            scan = scan_window_plain if plain else scan_window
            win = scan(self.bucket_ids, self.bucket_fields, pts_s, b0, nc).reshape(-1)
            self.last_scan_stats = {"scan": kind, "G": WINDOW,
                                    "NG": pts_s.shape[0] // WINDOW}
        out = self._finish(pts_s[:P], win[:P], with_gradient)
        if with_gradient:
            d = torch.empty_like(out[0])
            g = torch.empty_like(out[1])
            d[order] = out[0]
            g[order] = out[1]
            return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)
        d = torch.empty_like(out)
        d[order] = out
        return d.reshape(pts.shape[:-1])

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
