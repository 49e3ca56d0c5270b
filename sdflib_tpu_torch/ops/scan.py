"""K1: the exact octree's candidate scan, in its two modes.

Both replace sdflib_tpu/ops/pallas_scan.py:_scan_kernel. Each wrapper
launches its CUDA kernel for CUDA tensors and takes its plain torch
version for CPU tensors.

* Window mode, ``scan_window`` (``csrc/scan_window.cu``; the TPU kernel
  through ``exact_scan_window_pallas``). The plain version follows the
  JAX package's ``_exact_scan_window_xla``: windows are G consecutive
  points of the leaf-sorted order; a window walks the union of its
  points' bucket-row spans, each point masks rows outside its own
  [b0, b0 + nc), and after each row the window jumps to the smallest row
  a point still needs.
* Grouped mode, ``scan_grouped`` (``csrc/scan_grouped.cu``; the TPU kernel
  through ``exact_scan_grouped_pallas``). Groups are runs of leaf-sorted
  points that share one leaf, given as CSR offsets into the points; every
  point of a group scans its leaf's rows [row0, row0 + nrows).
  ``grouped_rows`` gives each group's row span and ``grouped_row_stream``
  the rows the kernel fetches, in its order.

The kernels read vertex rows (9 floats a slot) of 64 slots. The plain
versions also take the 19 packed frame fields a slot (the frame19 tier
of the exact octree) and any row width, and ``scan_id_only`` scans the
id-only tier, gathering each slot's fields from the triangle table (the
JAX package's ``_exact_scan`` without dense buckets); these three run in
plain torch on any device.

Winner rules of both: ids of -1 are masked, within a row the first
minimal slot wins, across rows a strict <, a row whose minimum is NaN
never wins, and a point with no rows gets id 0. ``launch_count`` and
``grouped_launch_count`` count kernel launches.
"""
from __future__ import annotations

import torch

from ..kernels import build
from .point_triangle import NUM_PACKED_FIELDS, sq_dist_from_field_fn, sq_dist_from_vertex_cols

__all__ = [
    "scan_window", "scan_window_plain", "scan_grouped", "scan_grouped_plain",
    "scan_id_only",
    "grouped_rows", "grouped_row_stream", "launch_count", "grouped_launch_count",
    "WINDOW", "PASS",
]

WINDOW = 32       # points per window: one warp in the kernel
PASS = 32         # points of a group the grouped kernel holds at once (kPass)
_BIG = 1 << 30
launch_count = 0
grouped_launch_count = 0


def _row_sqdist(px, py, pz, fld, CH: int):
    """Squared distances from field-major bucket rows ``fld`` (..., nf *
    CH): 9 vertex floats a slot (the frame derived on the fly) or the 19
    packed frame fields."""
    nf = fld.shape[-1] // CH
    col = lambda k: fld[..., k * CH : (k + 1) * CH]
    if nf == 9:
        return sq_dist_from_vertex_cols(px, py, pz, col)
    if nf == NUM_PACKED_FIELDS:
        return sq_dist_from_field_fn(px, py, pz, col)
    raise ValueError(f"bucket rows hold 9 or {NUM_PACKED_FIELDS} fields a slot, not {nf}")


def scan_window_plain(bucket_ids, bucket_fields, points, b0, nc, *,
                      G: int = WINDOW, block: int = 4096):
    """Winner ids (P // G, G) int32 of the leaf-sorted (P, 3) points.

    ``bucket_ids`` (NB, CH) int32, -1 padded; ``bucket_fields`` (NB, nf*CH)
    f32, field-major: the slots' world vertices (nf 9) or packed frame
    fields (nf 19); ``b0``/``nc`` (P,) int32 each point's
    first bucket row and row count (0 for padding). Within a row the
    first minimal slot wins, across rows a strict <; a row whose minimum
    is NaN never wins. ``block`` windows are evaluated per step."""
    P = points.shape[0]
    NB, CH = bucket_ids.shape
    NW = P // G
    out = torch.zeros((NW, G), dtype=torch.int32, device=points.device)
    for w0 in range(0, NW, block):
        w1 = min(NW, w0 + block)
        pts = points[w0 * G : w1 * G].reshape(-1, G, 3)
        wb0 = b0[w0 * G : w1 * G].reshape(-1, G)
        wnc = nc[w0 * G : w1 * G].reshape(-1, G)
        live = wnc > 0
        wend = torch.where(live, wb0 + wnc, 0)
        hi = wend.amax(dim=1)
        row = torch.where(live, wb0, _BIG).amin(dim=1)
        px, py, pz = pts[..., 0:1], pts[..., 1:2], pts[..., 2:3]
        best = torch.full(wb0.shape, torch.inf, device=points.device)
        best_id = torch.zeros(wb0.shape, dtype=torch.int32, device=points.device)
        while bool((row < hi).any()):
            r = row.clamp(0, NB - 1)
            tri = bucket_ids[r]                                # (nw, CH)
            fld = bucket_fields[r][:, None, :]                 # (nw, 1, nf*CH)
            sqd = _row_sqdist(px, py, pz, fld, CH)             # (nw, G, CH)
            pvalid = (row[:, None] >= wb0) & (row[:, None] < wend)
            valid = (tri >= 0)[:, None, :] & pvalid[:, :, None]
            sqd = torch.where(valid, sqd, torch.inf)
            local, amin = sqd.min(dim=-1)
            local_id = tri.gather(1, amin)
            take = local < best
            best = torch.where(take, local, best)
            best_id = torch.where(take, local_id, best_id)
            nxt = torch.where(
                live & (wb0 > row[:, None]),
                wb0,
                torch.where(row[:, None] + 1 < wend, row[:, None] + 1, _BIG),
            )
            row = nxt.amin(dim=1)
        out[w0:w1] = best_id
    return out


def scan_window(bucket_ids, bucket_fields, points, b0, nc, *, G: int = WINDOW):
    """Winner ids (P // G, G) int32; see ``scan_window_plain``. A CUDA
    tensor runs the kernel (G must be 32); a CPU tensor the plain
    version."""
    P = points.shape[0]
    NB, CH = bucket_ids.shape
    if points.shape != (P, 3) or P % G:
        raise ValueError(f"points must be (P, 3) with P % {G} == 0")
    if b0.shape != (P,) or nc.shape != (P,):
        raise ValueError("b0 and nc must be (P,)")
    if bucket_fields.shape != (NB, 9 * CH):
        raise ValueError("bucket_fields must be (NB, 9 * CH) vertex rows")
    for t, dt in ((bucket_ids, torch.int32), (b0, torch.int32),
                  (nc, torch.int32), (bucket_fields, torch.float32),
                  (points, torch.float32)):
        if t.dtype != dt or t.device != points.device:
            raise ValueError(f"expected {dt} on {points.device}")
    if points.device.type == "cpu":
        return scan_window_plain(bucket_ids, bucket_fields, points, b0, nc, G=G)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if G != WINDOW or CH != 64:
        raise ValueError("the kernel takes windows of 32 points and 64-slot rows")
    args = [t.contiguous() for t in (bucket_ids, bucket_fields, points, b0, nc)]
    win = torch.empty((P // G, G), dtype=torch.int32, device=points.device)
    build.launch("sdf_scan_window", points.device, args[0].data_ptr(), args[1].data_ptr(), NB,
                 args[2].data_ptr(), args[3].data_ptr(), args[4].data_ptr(), P // G,
                 win.data_ptr())
    build.count_launch(globals(), "launch_count")
    return win


def scan_grouped_plain(bucket_ids, bucket_fields, points, point_leaf,
                       group_start, leaf_row0, leaf_nrows, *, block: int = 1 << 16):
    """Winner ids (P,) int32 of the leaf-sorted (P, 3) points.

    ``point_leaf`` (P,) int32 is each point's leaf; ``group_start``
    (NG + 1,) int32 the CSR offsets of the groups into the points
    (non-decreasing from 0 to P; trailing empty groups allowed), each
    group's leaf being that of its first point; ``leaf_row0`` and
    ``leaf_nrows`` (L,) int32 each leaf's first bucket row and row count.
    Row step i evaluates, in blocks of ``block`` points, only the points
    whose group has more than i rows."""
    P = points.shape[0]
    NB, CH = bucket_ids.shape
    dev = points.device
    out = torch.zeros(P, dtype=torch.int32, device=dev)
    if P == 0:
        return out
    sizes = (group_start[1:] - group_start[:-1]).long()
    gleaf = point_leaf[group_start[:-1].clamp(max=P - 1).long()].long()
    leaf = torch.repeat_interleave(gleaf, sizes, output_size=P)
    b0 = leaf_row0[leaf]
    nc = leaf_nrows[leaf]
    best = torch.full((P,), torch.inf, device=dev)
    for i in range(int(nc.max())):
        live = torch.nonzero(nc > i)[:, 0]
        for c0 in range(0, live.shape[0], block):
            j = live[c0 : c0 + block]
            r = (b0[j] + i).clamp(0, NB - 1)
            tri = bucket_ids[r]                                # (n, CH)
            fld = bucket_fields[r]                             # (n, nf*CH)
            pts = points[j]
            sqd = _row_sqdist(pts[:, 0:1], pts[:, 1:2], pts[:, 2:3], fld, CH)  # (n, CH)
            sqd = torch.where(tri >= 0, sqd, torch.inf)
            local, amin = sqd.min(dim=1)
            take = local < best[j]
            best[j] = torch.where(take, local, best[j])
            out[j] = torch.where(take, tri.gather(1, amin[:, None])[:, 0], out[j])
    return out


def scan_id_only(bucket_ids, packed_t, points, b0, nc, *, block: int = 1 << 16):
    """Winner ids (P,) int32 of the (P, 3) points over the id-only tier:
    point p scans rows [b0[p], b0[p] + nc[p]) of ``bucket_ids`` (NB, CH)
    int32, -1 padded, each slot's 19 packed fields gathered from the
    field-major (19, T) ``packed_t``. The winner rules of the scans
    above. Row step i evaluates, in blocks of ``block`` points, only the
    points with more than i rows, up to the longest list (one host sync a
    step)."""
    P = points.shape[0]
    NB, CH = bucket_ids.shape
    dev = points.device
    out = torch.zeros(P, dtype=torch.int32, device=dev)
    if P == 0:
        return out
    best = torch.full((P,), torch.inf, device=dev)
    for i in range(int(nc.max())):
        live = torch.nonzero(nc > i)[:, 0]
        for c0 in range(0, live.shape[0], block):
            j = live[c0 : c0 + block]
            tri = bucket_ids[(b0[j] + i).clamp(0, NB - 1)]     # (n, CH)
            safe = tri.clamp_min(0).long()
            pts = points[j]
            sqd = sq_dist_from_field_fn(
                pts[:, 0:1], pts[:, 1:2], pts[:, 2:3], lambda k: packed_t[k][safe]
            )                                                  # (n, CH)
            sqd = torch.where(tri >= 0, sqd, torch.inf)
            local, amin = sqd.min(dim=1)
            take = local < best[j]
            best[j] = torch.where(take, local, best[j])
            out[j] = torch.where(take, tri.gather(1, amin[:, None])[:, 0], out[j])
    return out


def grouped_rows(point_leaf, group_start, leaf_row0, leaf_nrows):
    """(first bucket row, row count) int32 (NG,) of each group: those of
    its leaf, and (0, 0) for an empty group; the JAX grouped scan's
    ``bucket0`` and ``nchunk`` under its ``has_pts`` mask."""
    NG = group_start.shape[0] - 1
    P = point_leaf.shape[0]
    if P == 0:
        zero = torch.zeros(NG, dtype=torch.int32, device=group_start.device)
        return zero, zero.clone()
    first = group_start[:-1]
    live = group_start[1:] > first
    leaf = point_leaf[first.clamp(0, P - 1).long()].long()
    return (torch.where(live, leaf_row0[leaf], 0).to(torch.int32),
            torch.where(live, leaf_nrows[leaf], 0).to(torch.int32))


def grouped_row_stream(point_leaf, group_start, leaf_row0, leaf_nrows):
    """The bucket rows the grouped kernel fetches, in its order: each
    group's rows [row0, row0 + nrows), once per pass of PASS of its points,
    groups in order (int64, unclamped)."""
    row0, nrows = grouped_rows(point_leaf, group_start, leaf_row0, leaf_nrows)
    passes = (group_start[1:] - group_start[:-1] + PASS - 1) // PASS
    items = (nrows * passes).long()
    total = int(items.sum())
    first = torch.cumsum(items, 0) - items
    k = torch.arange(total, device=items.device) - torch.repeat_interleave(
        first, items, output_size=total)
    g = torch.repeat_interleave(torch.arange(items.shape[0], device=items.device),
                                items, output_size=total)
    return row0[g].long() + k % nrows[g].long()


def scan_grouped(bucket_ids, bucket_fields, points, point_leaf, group_start,
                 leaf_row0, leaf_nrows):
    """Winner ids (P,) int32 of leaf-aligned point groups; see
    ``scan_grouped_plain``. A CUDA tensor runs the kernel (64-slot rows);
    a CPU tensor the plain version."""
    P = points.shape[0]
    NB, CH = bucket_ids.shape
    NG = group_start.shape[0] - 1
    L = leaf_row0.shape[0]
    if points.shape != (P, 3) or point_leaf.shape != (P,):
        raise ValueError("points must be (P, 3) and point_leaf (P,)")
    if group_start.ndim != 1 or NG < 0:
        raise ValueError("group_start must be (NG + 1,) CSR offsets")
    if leaf_row0.shape != (L,) or leaf_nrows.shape != (L,):
        raise ValueError("leaf_row0 and leaf_nrows must be (L,)")
    if bucket_fields.shape != (NB, 9 * CH):
        raise ValueError("bucket_fields must be (NB, 9 * CH) vertex rows")
    for t, dt in ((bucket_ids, torch.int32), (bucket_fields, torch.float32),
                  (points, torch.float32), (point_leaf, torch.int32),
                  (group_start, torch.int32), (leaf_row0, torch.int32),
                  (leaf_nrows, torch.int32)):
        if t.dtype != dt or t.device != points.device:
            raise ValueError(f"expected {dt} on {points.device}")
    if points.device.type == "cpu":
        return scan_grouped_plain(bucket_ids, bucket_fields, points, point_leaf,
                                  group_start, leaf_row0, leaf_nrows)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if CH != 64:
        raise ValueError("the kernel takes 64-slot rows")
    if NG == 0 or P == 0:
        return torch.zeros(P, dtype=torch.int32, device=points.device)
    args = [t.contiguous() for t in (bucket_ids, bucket_fields, points, point_leaf,
                                     group_start, leaf_row0, leaf_nrows)]
    win = torch.empty(P, dtype=torch.int32, device=points.device)
    build.launch("sdf_scan_grouped", points.device, args[0].data_ptr(), args[1].data_ptr(), NB,
                 args[2].data_ptr(), args[3].data_ptr(), args[4].data_ptr(), NG,
                 args[5].data_ptr(), args[6].data_ptr(), win.data_ptr())
    build.count_launch(globals(), "grouped_launch_count")
    return win
