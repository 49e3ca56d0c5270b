"""CONTINUITY octree builder (approximate C0 across leaf faces).

Port of the JAX package's ``sdf/octree_builder_continuity.py`` (reference:
src/sdf/OctreeSdfBreadthFirstNoDelay.h:83-1226), the reference's default
builder. It is level-synchronous like ``build_octree``:

  * every level runs the same level kernel (``_level_chunk``) on the
    device;
  * terminated leaves are registered on the host in flat arrays keyed by
    an int64 (depth, x, y, z) code; the leaf neighbouring a midpoint is a
    ``searchsorted`` of 42 candidate neighbour codes per node over the
    sorted codes, walked up through the ancestors;
  * a midpoint shared with a terminated leaf takes that leaf's
    interpolated value and gradient when they differ by at most the
    termination threshold (evaluated on the device); otherwise the leaf
    is re-opened: its node word becomes a children pointer and it
    re-enters the work list as a forced-subdivide node with a fresh
    candidate list (``_cull_chunk``, on the device). The loop always
    takes the shallowest depth with pending work.

Coefficients are laid out only at final assembly, so re-opened leaves
leave no dead coefficient slots.

The clamp ``|sample - v| <= threshold`` and the termination test
``err < threshold^2`` are knife-edge comparisons: a last-ulp difference
from the JAX package's sums can flip a clamp, a re-open or a leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.interpolation import gradient_at, interpolate_at
from ..ops.point_triangle import pack_triangle_fields, sq_dist_from_field_fn
from ..triangle import TriangleDataSoA
from .octree_builder import (
    IS_LEAF_MASK,
    MID_OFFSETS,
    OctreeBuildResult,
    _CHILD_OFFSETS,
    _SQRT3,
    _cull_inputs,
    _children_lattice,
    _compute_min_border_value,
    _fit_only,
    _run_level,
    _seed_lattice,
)

__all__ = ["build_octree_continuity"]


def _neighbor_deltas():
    """Per-midpoint neighbour cell deltas, as (mid_idx, delta) pairs: face
    centres have 1 sharing neighbour, edge midpoints 3 (two
    face-adjacent, one edge-diagonal); the node centre (midpoint 9) none.
    Face directions come first so they win ties, as the reference's
    face-neighbour masks do (OctreeSdfBreadthFirstNoDelay.h:139-176)."""
    pairs = []
    for m in range(19):
        o = MID_OFFSETS[m].astype(np.int64)  # in {-1,0,1}
        nz = [i for i in range(3) if o[i] != 0]
        if not nz:
            continue  # centre
        singles, diag = [], []
        for i in nz:
            d = np.zeros(3, np.int64)
            d[i] = o[i]
            singles.append(d)
        if len(nz) > 1:
            d = np.zeros(3, np.int64)
            for i in nz:
                d[i] = o[i]
            diag.append(d)
        for d in singles + diag:
            pairs.append((m, d))
    mids = np.array([p[0] for p in pairs], np.int64)
    deltas = np.stack([p[1] for p in pairs])  # (42, 3)
    return mids, deltas


_NB_MIDS, _NB_DELTAS = _neighbor_deltas()
_CHILD_BITS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64)


def _code(depth, x, y, z):
    """Pack (depth, x, y, z) into one int64 key (depth <= 15, coord < 2^16)."""
    return (
        (np.asarray(depth, np.int64) << 48)
        | (np.asarray(x, np.int64) << 32)
        | (np.asarray(y, np.int64) << 16)
        | np.asarray(z, np.int64)
    )


class _LeafRegistry:
    """Growable flat arrays of terminated leaves, searchable by code.

    ``alive`` persists across appends: re-opened leaves stay dead after
    later levels add leaves (only the cached sort index is rebuilt)."""

    def __init__(self, num_coeff: int):
        self.num_coeff = num_coeff
        self.codes = np.zeros(0, np.int64)
        self.coeffs = np.zeros((0, num_coeff), np.float32)
        self.corner_vals = np.zeros((0, 8, 8), np.float32)
        self.centers = np.zeros((0, 3), np.float32)
        self.halves = np.zeros(0, np.float32)
        self.slots = np.zeros(0, np.int64)
        self.depths = np.zeros(0, np.int32)
        self.alive = np.zeros(0, bool)
        self._sort_idx = None

    def add(self, codes, coeffs, corner_vals, centers, halves, slots, depths):
        if len(codes) == 0:
            return
        self.codes = np.concatenate([self.codes, np.asarray(codes, np.int64)])
        self.coeffs = np.concatenate([self.coeffs, np.asarray(coeffs, np.float32)])
        self.corner_vals = np.concatenate(
            [self.corner_vals, np.asarray(corner_vals, np.float32)]
        )
        self.centers = np.concatenate([self.centers, np.asarray(centers, np.float32)])
        self.halves = np.concatenate([self.halves, np.asarray(halves, np.float32)])
        self.slots = np.concatenate([self.slots, np.asarray(slots, np.int64)])
        self.depths = np.concatenate([self.depths, np.asarray(depths, np.int32)])
        self.alive = np.concatenate([self.alive, np.ones(len(codes), bool)])
        self._sort_idx = None

    @property
    def sort_idx(self):
        if self._sort_idx is None:
            self._sort_idx = np.argsort(self.codes, kind="stable")
        return self._sort_idx


def _lookup_leaves(reg: _LeafRegistry, codes):
    """Row indices into the registry for each code (-1 if absent or dead)."""
    if reg.codes.shape[0] == 0:
        return np.full(codes.shape, -1, np.int64)
    si = reg.sort_idx
    sorted_codes = reg.codes[si]
    pos = np.searchsorted(sorted_codes, codes)
    pos_c = np.clip(pos, 0, sorted_codes.shape[0] - 1)
    hit = sorted_codes[pos_c] == codes
    rows = np.where(hit, si[pos_c], -1)
    return np.where((rows >= 0) & reg.alive[np.clip(rows, 0, None)], rows, -1)


def _cull_chunk(packed_t, centers, half):
    """Centre-distance cull for re-opened leaves, (R, T) on the device:
    keep t iff d(t, centre) <= min_t d(t, centre) + full diagonal (the
    main builder's criterion)."""
    px, py, pz = (centers[:, i, None] for i in range(3))          # (R, 1)
    dc = sq_dist_from_field_fn(px, py, pz, lambda r: packed_t[r][None, :]).sqrt()
    minc = dc.amin(dim=1, keepdim=True)
    return dc <= minc + float(np.float32(2.0) * _SQRT3 * np.float32(half))


def build_octree_continuity(
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
    """Build the approximate octree with C0 continuity correction on the
    device of ``tris`` (a torch SoA); ``box`` must be cubified.
    ``strategy`` names the children's cull (see ``build_octree``)."""
    cull = _cull_inputs(tris, strategy)
    dev = tris.origin.device
    packed_t = pack_triangle_fields(tris).t().contiguous()
    T = tris.num_triangles
    box_min = np.asarray(box_min, np.float32)
    box_size = np.float32(box_size)
    num_coeff = 64 if interpolation == "tricubic" else 8
    sq_threshold = np.float32(termination_threshold) ** 2
    threshold = np.float32(termination_threshold)

    corner_vals0, centers0, coords0, _ = _seed_lattice(tris, box_min, box_size, start_depth)
    n0 = centers0.shape[0]

    # ---- state -----------------------------------------------------------------
    total_nodes = n0  # words used by node blocks (start grid + 8-blocks)
    node_patches: list[tuple[np.ndarray, np.ndarray]] = []
    registry = _LeafRegistry(num_coeff)
    value_range = 0.0
    stats: dict = {
        "nodes_per_depth": {},
        "leaves_per_depth": {},
        "tris_per_node": {},
        "resubdivided": 0,
        "midpoints_clamped": 0,
    }

    # active[depth] -> batches of dict(centers, corner_vals, coords, slots,
    # cand_idx, cand_valid, forced)
    active: dict[int, list[dict]] = {
        start_depth: [dict(
            centers=centers0,
            corner_vals=corner_vals0,
            coords=coords0,
            slots=np.arange(n0, dtype=np.int64),
            cand_idx=np.broadcast_to(np.arange(T, dtype=np.int32), (n0, T)).copy(),
            cand_valid=np.ones((n0, T), bool),
            forced=np.zeros(n0, bool),
        )]
    }

    def _emit_leaves(depth, mask, coords, coeffs, cvals, cents, hlf, slots):
        nonlocal value_range
        idxs = np.nonzero(mask)[0]
        if len(idxs) == 0:
            return
        registry.add(
            _code(depth, coords[idxs, 0], coords[idxs, 1], coords[idxs, 2]),
            coeffs[idxs],
            cvals[idxs],
            cents[idxs],
            np.full(len(idxs), hlf, np.float32),
            slots[idxs],
            np.full(len(idxs), depth, np.int32),
        )
        value_range = max(value_range, float(np.abs(cvals[idxs, :, 0]).max(initial=0.0)))
        stats["leaves_per_depth"][depth] = stats["leaves_per_depth"].get(depth, 0) + len(idxs)

    def _continuity_pass(depth, sub_idx, coords, centers, half, mids):
        """Clamp the midpoint samples shared with terminated leaves and
        return the registry rows of the leaves to re-open. Mutates
        ``mids`` in place.

        The neighbour lookup walks ancestors only, so a re-opened node
        processed after its own level cannot see terminated leaves deeper
        than itself (the reference's re-subdivision pass has the same
        asymmetry); a missed clamp stays within the termination bound."""
        M = len(sub_idx)
        if M == 0 or registry.codes.shape[0] == 0:
            return np.zeros(0, np.int64)

        dim = 1 << depth
        nb = coords[sub_idx][:, None, :] + _NB_DELTAS[None]    # (M, 42, 3)
        in_dom = np.all((nb >= 0) & (nb < dim), axis=-1)       # (M, 42)

        # ancestor walk: at most one ancestor level is a leaf
        rows = np.full((M, 42), -1, np.int64)
        for k in range(0, depth - start_depth + 1):
            anc = nb >> k
            codes = _code(depth - k, anc[..., 0], anc[..., 1], anc[..., 2])
            found = _lookup_leaves(registry, codes.reshape(-1)).reshape(M, 42)
            rows = np.where((rows < 0) & in_dom, found, rows)

        any_hit = rows >= 0
        if not any_hit.any():
            return np.zeros(0, np.int64)

        # the neighbour leaves' polynomials at the shared midpoints
        hit_n, hit_j = np.nonzero(any_hit)
        hit_rows = rows[hit_n, hit_j]
        hit_mid = _NB_MIDS[hit_j]
        mid_world = centers[sub_idx][hit_n] + MID_OFFSETS[hit_mid] * half   # (H, 3)
        L_half = registry.halves[hit_rows]
        L_min = registry.centers[hit_rows] - L_half[:, None]
        L_size = 2.0 * L_half
        frac = np.clip((mid_world - L_min) / L_size[:, None], 0.0, 1.0)
        L_coeffs = torch.as_tensor(registry.coeffs[hit_rows], device=dev)
        frac_t = torch.as_tensor(frac, device=dev)
        v = interpolate_at(L_coeffs, frac_t, interpolation).cpu().numpy()
        g = gradient_at(L_coeffs, frac_t, interpolation).cpu().numpy() / L_size[:, None]

        sample = mids[sub_idx[hit_n], hit_mid, 0]
        ok = np.abs(sample - v) <= threshold

        # the first OK hit per (node, midpoint) wins, in hit order (deltas
        # are ordered face first)
        key = hit_n.astype(np.int64) * 19 + hit_mid
        order = np.argsort(key, kind="stable")
        key_s, ok_s = key[order], ok[order]
        first_of_key = np.ones(len(order), bool)
        first_of_key[1:] = key_s[1:] != key_s[:-1]
        grp_id = np.cumsum(first_of_key) - 1
        big = len(order) + 1
        cand_pos = np.where(ok_s, np.arange(len(order)), big)
        first_ok_pos = np.full(int(first_of_key.sum()), big, np.int64)
        np.minimum.at(first_ok_pos, grp_id, cand_pos)
        take = np.zeros(len(order), bool)
        take[first_ok_pos[first_ok_pos < big]] = True
        take_orig = order[take]

        tn, tm = hit_n[take_orig], hit_mid[take_orig]
        mids[sub_idx[tn], tm, 0] = v[take_orig]
        mids[sub_idx[tn], tm, 1:4] = g[take_orig]
        stats["midpoints_clamped"] += int(len(take_orig))

        # queue every neighbour leaf whose interpolation is out of
        # tolerance at a shared midpoint (OctreeSdfBreadthFirstNoDelay.h:
        # 486-515)
        return np.unique(hit_rows[~ok])

    def _reopen(rows):
        """Turn registry leaves back into forced-subdivide active nodes."""
        rows = np.asarray(rows, np.int64)
        rows = rows[registry.alive[rows]]
        if len(rows) == 0:
            return
        registry.alive[rows] = False
        stats["resubdivided"] += int(len(rows))

        codes = registry.codes[rows]
        depths_r = codes >> 48
        xs = (codes >> 32) & 0xFFFF
        ys = (codes >> 16) & 0xFFFF
        zs = codes & 0xFFFF

        for d in np.unique(depths_r):
            m = depths_r == d
            r = rows[m]
            R = len(r)
            cents = registry.centers[r]
            # fresh candidate lists by the centre cull, in chunks
            keep = np.zeros((R, T), bool)
            chunk = max(1, pair_budget // max(T, 1))
            for i in range(0, R, chunk):
                keep[i : i + chunk] = _cull_chunk(
                    packed_t, torch.as_tensor(cents[i : i + chunk], device=dev),
                    registry.halves[r[0]],
                ).cpu().numpy()
            kmax = max(1, int(keep.sum(axis=1).max(initial=1)))
            orderk = np.argsort(~keep, axis=1, kind="stable")[:, :kmax]
            cand_idx = np.take_along_axis(
                np.broadcast_to(np.arange(T, dtype=np.int32), (R, T)), orderk, axis=1
            )
            active.setdefault(int(d), []).append(dict(
                centers=cents,
                corner_vals=registry.corner_vals[r],
                coords=np.stack([xs[m], ys[m], zs[m]], axis=-1),
                slots=registry.slots[r],
                cand_idx=cand_idx,
                cand_valid=np.take_along_axis(keep, orderk, axis=1),
                forced=np.ones(R, bool),
            ))

    # ---- main loop: always the shallowest pending depth ---------------------------
    while active:
        depth = min(active)
        batches = active.pop(depth)
        centers = np.concatenate([b["centers"] for b in batches])
        corner_vals = np.concatenate([b["corner_vals"] for b in batches])
        coords = np.concatenate([b["coords"] for b in batches])
        slots = np.concatenate([b["slots"] for b in batches])
        forced = np.concatenate([b["forced"] for b in batches])
        Kmax = max(b["cand_idx"].shape[1] for b in batches)

        def _padK(a, fill):
            return np.pad(a, [(0, 0), (0, Kmax - a.shape[1])], constant_values=fill)

        cand_idx = np.concatenate([_padK(b["cand_idx"], 0) for b in batches])
        cand_valid = np.concatenate([_padK(b["cand_valid"], False) for b in batches])

        N = centers.shape[0]
        half = np.float32(box_size / (1 << (depth + 1)))
        stats["nodes_per_depth"][depth] = stats["nodes_per_depth"].get(depth, 0) + N

        if depth == max_depth:
            coeffs = _fit_only(corner_vals, 2.0 * half, interpolation, dev)
            _emit_leaves(depth, np.ones(N, bool), coords, coeffs, corner_vals,
                         centers, half, slots)
            continue

        mids, coeffs, errs, keeps, kcounts = _run_level(
            tris, packed_t, centers, corner_vals, cand_idx, cand_valid, half,
            error_decay, termination_rule, interpolation, pair_budget, cull=cull,
        )
        stats["tris_per_node"][depth] = float(kcounts.mean())

        terminal = (errs < sq_threshold) & ~forced
        _emit_leaves(depth, terminal, coords, coeffs, corner_vals, centers, half, slots)

        sub = np.nonzero(~terminal)[0]
        if len(sub) == 0:
            continue
        M = len(sub)

        # ---- continuity: clamp shared midpoints, queue bad neighbours ------------
        _reopen(_continuity_pass(depth, sub, coords, centers, half, mids))

        # ---- subdivide -------------------------------------------------------------
        child_base = total_nodes + 8 * np.arange(M, dtype=np.int64)
        total_nodes += 8 * M
        node_patches.append((slots[sub].copy(), child_base.astype(np.uint32)))

        K_next = max(1, int(kcounts[sub].max(initial=1)))
        orderk = np.argsort(~keeps[sub], axis=1, kind="stable")[:, :K_next]
        new_cand = np.take_along_axis(cand_idx[sub], orderk, axis=1)
        new_valid = np.take_along_axis(keeps[sub], orderk, axis=1)

        active.setdefault(depth + 1, []).append(dict(
            centers=(
                centers[sub][:, None, :] + _CHILD_OFFSETS[None] * (np.float32(0.5) * half)
            ).reshape(M * 8, 3),
            corner_vals=_children_lattice(corner_vals, mids, sub),
            coords=(2 * coords[sub][:, None, :] + _CHILD_BITS[None]).reshape(M * 8, 3),
            slots=(child_base[:, None] + np.arange(8)[None]).reshape(-1),
            cand_idx=np.repeat(new_cand, 8, axis=0),
            cand_valid=np.repeat(new_valid, 8, axis=0),
            forced=np.zeros(M * 8, bool),
        ))

    # ---- final assembly ------------------------------------------------------------
    a_idx = np.nonzero(registry.alive)[0]
    L = len(a_idx)
    # the coefficient section aligned to num_coeff words, the total to
    # whole 64-word rows
    coeff_base = total_nodes + ((-total_nodes) % num_coeff)
    total_words = coeff_base + num_coeff * L
    total_words += (-total_words) % 64
    octree = np.zeros(total_words, np.uint32)
    for slots_p, words in node_patches:
        octree[slots_p] = words

    coeff_starts = coeff_base + num_coeff * np.arange(L, dtype=np.int64)
    octree[registry.slots[a_idx]] = coeff_starts.astype(np.uint32) | IS_LEAF_MASK
    coeff_block = registry.coeffs[a_idx].astype(np.float32).view(np.uint32)
    octree[coeff_base : coeff_base + num_coeff * L] = coeff_block.reshape(-1)

    leaf_centers = registry.centers[a_idx]
    leaf_halves = registry.halves[a_idx]
    min_border = _compute_min_border_value(
        octree, leaf_centers, leaf_halves, coeff_starts,
        box_min, box_size, num_coeff, interpolation, dev,
    )
    return OctreeBuildResult(
        octree_u32=octree,
        value_range=float(value_range),
        min_border_value=float(min_border),
        leaf_centers=leaf_centers,
        leaf_halves=leaf_halves,
        leaf_coeff_idx=coeff_starts,
        leaf_depths=registry.depths[a_idx],
        stats=stats,
    )
