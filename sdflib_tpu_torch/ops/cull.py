"""K13: the exact build's per-node-region influence cull.

``region_cull`` culls the candidate lists of a whole node group in one
launch of ``csrc/region_cull.cu`` on a CUDA device, and takes
``region_cull_plain`` (the eager torch cull, in chunks of nodes) for CPU
tensors. Both return
(keep (N, K) bool, kept counts (N,) int64, squared distance to the node
centre (N, K), inf where a slot is invalid), the kernel bit-equal to the
plain version. It replaces no TPU kernel: the JAX package's
``_region_cull_chunk`` (sdflib_tpu/sdf/exact_octree.py:160) is XLA-fused
code, mapped over a group's chunks by ``_cull_group`` (:446).

The kernel reads the field table padded to ``ROW_FLOATS`` floats a row,
``cull_rows``: the 19 packed fields, then a bound on the norm of the
row's distance gradient, which its skip test needs (``csrc/region_cull.cu``).
The exact build makes it once, beside the packed table (``CullTables.rows``).

``launch_count`` counts the kernel's launches, one a call with nodes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .exact_query import _launches, _need, _tensor
from .point_triangle import (
    NUM_PACKED_FIELDS,
    sq_dist_and_grad_from_field_fn,
    sq_dist_from_field_fn,
)

__all__ = ["region_cull", "region_cull_plain", "cull_in_chunks", "cull_rows", "lanes_for",
           "LANES", "SKIP_LANES", "ROW_FLOATS", "launch_count"]

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
LANES = (32, 512)    # the kernel's forms: a warp a node, or a 512-thread block a node
SKIP_LANES = (512,)  # the forms whose pass 2 takes the skip test (the kernel's launch)
ROW_FLOATS = 20      # the kernel's row: the 19 packed fields and the gradient bound
launch_count = 0


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


def _thresholds(half):
    """(the sub-cube half size qh, eps, near) of a node of half size
    ``half``, rounded to float32 as the cull compares them."""
    qh = _f32(np.float32(0.5) * np.float32(half))
    s = _f32(_F32_SQRT3 * np.float32(qh))
    eps = _f32(np.float32(2e-3) * np.float32(half))
    near = _f32(np.float32(s) + np.float32(eps))
    return qh, eps, near


def _reach(qh: float) -> float:
    """sqrt(3) ``qh`` (a corner's distance from its anchor), rounded up to
    float32: the skip test's reach a unit of gradient."""
    return _f32(np.sqrt(3.0) * float(qh) * (1.0 + 2.0 ** -20))


def cull_rows(packed):
    """(T, ROW_FLOATS) float32, row-major: each (T, 19) packed field row,
    then n, an upper bound on the norm of the unsigned distance's gradient
    that the row gives anywhere: max(1, |b|, |c|) (an edge's gradient
    halves are its distance times its normal (b0, b1) or (c0, c1)) times
    the spectral norm of the frame M (rows 3-11), bounded by Gershgorin's
    circles of M M^T; computed in float64 and rounded up. NaN where the
    row holds one, so that no skip test passes on it."""
    f = packed.double()
    M = f[:, 3:12].reshape(-1, 3, 3)
    mmt = (M[:, :, None, :] * M[:, None, :, :]).sum(-1)             # (T, 3, 3): r_i . r_j
    norm = mmt.abs().sum(-1).amax(-1).sqrt()
    edge = torch.maximum(torch.hypot(f[:, 12], f[:, 13]), torch.hypot(f[:, 14], f[:, 15]))
    n = torch.maximum(edge, torch.ones_like(edge)) * norm * (1.0 + 2.0 ** -20)
    n = torch.where(torch.isnan(f).any(1), torch.nan, n)
    return torch.cat([packed, n[:, None].to(torch.float32)], dim=1).contiguous()


def region_cull_plain(tables, centers, cand_idx, cand_valid, half):
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

    ``tables`` holds the (T, 19) field table and its transpose. Returns
    (keep (C, K) bool, kept counts (C,), squared distance to the node
    centre (C, K), the leaf-list sort key)."""
    idx = cand_idx.long()
    cols = [tables.packed_t[r][idx] for r in range(tables.packed_t.shape[0])]
    px, py, pz = centers[:, 0:1], centers[:, 1:2], centers[:, 2:3]
    qh, eps, near = _thresholds(half)
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
        fb = tables.packed[b]                                     # (C, 19)
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


def cull_in_chunks(fn, rows: int, tables, centers, cand, valid, half):
    """The cull ``fn`` of (N, K) candidate rows in chunks of ``rows``
    nodes, its outputs concatenated."""
    N = centers.shape[0]
    if N <= rows:
        return fn(tables, centers, cand, valid, half)
    parts = [fn(tables, centers[i : i + rows], cand[i : i + rows], valid[i : i + rows], half)
             for i in range(0, N, rows)]
    return tuple(torch.cat(x) for x in zip(*parts))


def lanes_for(K: int) -> int:
    """The kernel's form for nodes of K slots: a 512-thread block a node
    from 2,048 slots, else a warp a node. On an H100 the block form led
    from 2,048 slots and the warp form at 512 and below, over every group
    of the d6 and d7 builds (PERF.md); each width there came with enough
    nodes to fill the card, so the node count is not consulted."""
    return 512 if K >= 2048 else 32


def region_cull(tables, centers, cand, valid, half, *, lanes: int | None = None,
                rows: int | None = None, stats=None):
    """K13: ``region_cull_plain``'s outputs for a whole node group; a CUDA
    device runs the kernel in one launch, the CPU the plain version in
    chunks of ``rows`` nodes (default all). ``tables.packed`` is the (T,
    19) field table, ``tables.rows`` its ``cull_rows`` (read on the card
    only); ``cand`` (N, K) int32 and ``valid`` (N, K) bool may be
    expanded rows (row stride 0); ``lanes`` pins the kernel's form
    (``LANES``; default ``lanes_for(K)``). With ``stats``, a (4,) int64
    CUDA tensor, the launch adds pass 2's tallies to it: anchor
    evaluations, kept by the near test, skipped by the skip test,
    evaluated in full. Ids must lie in [-T, T), as torch's indexing
    requires; the kernel does not check them."""
    dev = centers.device
    packed = tables.packed
    _tensor(packed, torch.float32, (None, NUM_PACKED_FIELDS), "packed", dev)
    _tensor(centers, torch.float32, (None, 3), "centers", dev)
    N = centers.shape[0]
    _tensor(cand, torch.int32, (N, None), "cand", dev)
    K = cand.shape[1]
    _tensor(valid, torch.bool, (N, K), "valid", dev)
    _need(lanes is None or lanes in LANES, f"lanes must be one of {LANES}")
    if not _launches(dev):
        return cull_in_chunks(region_cull_plain, rows or max(N, 1), tables, centers, cand,
                              valid, half)
    T = packed.shape[0]
    _need(K > 0 and T > 0, "region_cull needs candidates and triangles")
    table = tables.rows
    _tensor(table, torch.float32, (T, ROW_FLOATS), "tables.rows", dev)
    _need(table.is_contiguous() and table.data_ptr() % 16 == 0,
          "tables.rows must be contiguous and 16-byte aligned")
    if stats is not None:
        _tensor(stats, torch.int64, (4,), "stats", dev)
    centers = centers.contiguous()
    cand = cand if cand.stride(1) == 1 else cand.contiguous()
    valid = valid if valid.stride(1) == 1 else valid.contiguous()
    keep = torch.empty((N, K), dtype=torch.bool, device=dev)
    counts = torch.empty(N, dtype=torch.int64, device=dev)
    sqd = torch.empty((N, K), dtype=torch.float32, device=dev)
    if N:
        qh, eps, near = _thresholds(half)
        build.launch("sdf_region_cull", dev, table.data_ptr(), T, centers.data_ptr(), N,
                     cand.data_ptr(), cand.stride(0), valid.data_ptr(), valid.stride(0), K,
                     _f32(half), qh, eps, near, _reach(qh),
                     lanes_for(K) if lanes is None else lanes, keep.data_ptr(),
                     counts.data_ptr(), sqd.data_ptr(),
                     None if stats is None else stats.data_ptr())
        build.count_launch(globals(), "launch_count")
    return keep, counts, sqd
