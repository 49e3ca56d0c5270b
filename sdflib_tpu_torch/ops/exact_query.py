"""K7-K9: the exact query's work around the scan.

The JAX package runs the whole exact query as one compiled program
(sdflib_tpu/sdf/exact_octree.py ``_exact_query_fused``), in which XLA
fuses everything but the scan; no ``pl.pallas_call`` lies behind these
three. Each wrapper launches its CUDA kernel for CUDA tensors and takes
its plain torch version, beside it here, for CPU tensors.

* K8, ``exact_descend`` (``csrc/exact_descend.cu``; the JAX package's
  ``_exact_descent_grid``, :567-581): each point's leaf id (int32) from
  the dense leaf grid, the cell clamped to the grid as in the plain
  version (the structure's ``_descend`` and the tools).
* The leaf sort, ``leaf_sort`` (same file; ``_exact_descent_grid``
  followed by the multi-operand ``lax.sort``, :934-941): K8's key and a
  stable sort by it, ``torch.sort(exact_descend_plain(...),
  stable=True)``, as a stable LSD radix sort over only the keys' bits
  (``sort_bits`` of the leaf count; ``_digit_plan`` splits them into the
  fewest digits of at most ``MAX_DIGIT`` = 8 bits, a bin a thread of a
  block), the key computed in its first launch. Given int32 keys instead
  of points (the node walk's), it sorts those.
* K9, ``exact_sorted_gather`` (``csrc/exact_descend.cu``; the gathers of
  the sorted order, :934-941, and of the window scan's bounds,
  :982-983): ``pts[order]`` and, for the window scan and the id-only
  tier, each sorted point's first bucket row and row count, zero padded
  to ``size`` points. The kernel reads a leaf's bounds as one 8-byte
  word of a packed (L, 2) table (``leaf_bounds``; the structure keeps
  one beside ``leaf_row0`` and ``leaf_nchunks``).
* K7, ``exact_finish`` (``csrc/exact_finish.cu``; ``_exact_finish``,
  :1144-1181, and the unsort, :1041-1048): the signed distance (and the
  gradient) of each sorted point to its winning triangle, or the box
  fallback outside the box, written at the point's place in the caller's
  order.

K7 reads the finish table (``finish_table``): one row of
``FINISH_FIELDS`` floats a triangle, the 37 fields of
``pack_triangle_full_fields`` then the 9 world-vertex floats the
gradient's normals need, row-major (the structure's ``_finish_table``).
``exact_finish`` refuses any other table, on every device.

The public functions check their arguments and, on the card, call the
lean launches ``launch_leaf_sort``, ``launch_sorted_gather`` and
``launch_exact_finish``, which ``ExactOctreeSdf._query`` calls directly
with tensors it made itself: no checks, no copies, the box as host
floats, the ctypes entry looked up once a process; a launch that fails
still raises.

``descend_launch_count``, ``sort_launch_count`` (one a sort: its memset
and launches are one call), ``gather_launch_count`` and
``finish_launch_count`` count kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..triangle import TriangleDataSoA
from .box import box_distance, box_distance_gradient
from .point_triangle import (
    NUM_FULL_FIELDS,
    pack_triangle_full_fields,
    signed_dist_from_rows,
    signed_dist_grad_pair,
)

__all__ = [
    "FINISH_FIELDS", "finish_table",
    "exact_descend", "exact_descend_plain",
    "leaf_sort", "leaf_sort_plain", "launch_leaf_sort", "sort_bits", "MAX_DIGIT", "SORT_TILE",
    "exact_sorted_gather", "exact_sorted_gather_plain",
    "exact_finish", "exact_finish_plain", "leaf_bounds",
    "launch_sorted_gather", "launch_exact_finish",
    "descend_launch_count", "sort_launch_count", "gather_launch_count", "finish_launch_count",
]

FINISH_FIELDS = 48     # 37 full fields, 9 world-vertex floats, 2 of padding
_F_VWORLD = NUM_FULL_FIELDS
descend_launch_count = 0
sort_launch_count = 0
gather_launch_count = 0
finish_launch_count = 0


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _tensor(t, dtype, shape, name: str, device) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape`` (None: any
    size there) on ``device``."""
    _need(isinstance(t, torch.Tensor) and t.dtype == dtype and t.ndim == len(shape)
          and all(s is None or s == n for s, n in zip(shape, t.shape)),
          f"{name} must be a {tuple(shape)} {dtype} tensor")
    _need(t.device == device, f"{name} lies on {t.device}, not on {device}")


def _launches(device) -> bool:
    """True on a CUDA device (launch), False on the CPU (plain)."""
    if device.type == "cpu":
        return False
    _need(device.type == "cuda", f"unsupported device {device}")
    return True


def finish_table(tris: TriangleDataSoA):
    """(T, FINISH_FIELDS) float32, row-major: ``pack_triangle_full_fields``,
    the world vertices [v1, v2, v3], two zeros."""
    T = tris.origin.shape[0]
    return torch.cat([
        pack_triangle_full_fields(tris),
        tris.v_world.reshape(T, 9).to(torch.float32),
        torch.zeros((T, FINISH_FIELDS - _F_VWORLD - 9), dtype=torch.float32,
                    device=tris.origin.device),
    ], dim=1).contiguous()


# -- K8: the descent key ------------------------------------------------------

def exact_descend_plain(points, leaf_grid, box_min, box_size3, depth: int):
    """Leaf id (P,) int32 of each (P, 3) point on the dense leaf grid of
    2^depth cells an axis (z-major); a point outside the box takes the
    clamped boundary cell."""
    g = 1 << depth
    rel = (points - box_min) / box_size3
    cell = (rel * g).to(torch.int32).clamp(0, g - 1).long()
    lin = (cell[:, 2] * g + cell[:, 1]) * g + cell[:, 0]
    return leaf_grid[lin]


def exact_descend(points, leaf_grid, box_min, box_size3, depth: int):
    """K8: ``exact_descend_plain``'s leaf ids; a CUDA tensor runs the
    kernel, a CPU tensor the plain version."""
    dev = points.device if isinstance(points, torch.Tensor) else None
    _tensor(points, torch.float32, (None, 3), "points", dev)
    _tensor(leaf_grid, torch.int32, (8 ** depth,), "leaf_grid", dev)
    _tensor(box_min, torch.float32, (3,), "box_min", dev)
    _tensor(box_size3, torch.float32, (3,), "box_size3", dev)
    _need(0 <= depth <= 10, "the grid depth must lie in 0..10")
    if not _launches(dev):
        return exact_descend_plain(points, leaf_grid, box_min, box_size3, depth)
    pts, grid = points.contiguous(), leaf_grid.contiguous()
    P = pts.shape[0]
    key = torch.empty(P, dtype=torch.int32, device=dev)
    if P:
        build.launch("sdf_exact_descend", dev, pts.data_ptr(), P, grid.data_ptr(), depth,
                     box_min.contiguous().data_ptr(), box_size3.contiguous().data_ptr(),
                     key.data_ptr())
        build.count_launch(globals(), "descend_launch_count")
    return key


# -- the leaf sort: K8's key and a stable sort by it -----------------------------

MAX_DIGIT = 8           # the widest digit of a pass (kMaxDigit): a bin a thread
SORT_TILE = 4096        # keys a tile of a digit pass (kSortTile)
_MAX_PASSES = 4         # 31 bits (kMaxPasses)
# the look-back state's head: every pass's bins, a ticket, a tile counter a
# pass, padding to a multiple of 4 words (kStateHead)
_STATE_HEAD = _MAX_PASSES * (1 << MAX_DIGIT) + 1 + _MAX_PASSES + 3


def sort_bits(num_leaves: int) -> int:
    """The bits of a leaf id below ``num_leaves``: what the sort sorts."""
    return max(1, (int(num_leaves) - 1).bit_length())


def _digit_plan(bits: int) -> tuple[int, ...]:
    """The digit widths of a stable LSD radix sort of keys below
    2^``bits``, least significant first: the fewest passes of at most
    ``MAX_DIGIT`` bits, as even as can be (the first ones one bit wider),
    as ``csrc/exact_descend.cu`` ``digit_plan`` splits them."""
    passes = -(-bits // MAX_DIGIT)
    base, extra = divmod(bits, passes)
    return tuple(base + (i < extra) for i in range(passes))


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _sort_words(P: int, bits: int, given: bool) -> int:
    """The int32 words of the leaf sort's scratch: the look-back state (a
    status word a tile and digit of each pass) rounded up to a multiple of
    4, then buffers of P rounded up to a multiple of 4 (16-byte aligned
    tiles): the keys unless given, and a key and a value buffer for each
    of the first two passes but the last (later passes take turns in
    them)."""
    widths = _digit_plan(bits)
    tiles = -(-P // SORT_TILE)
    state = _round4(_STATE_HEAD + tiles * sum(1 << w for w in widths))
    return state + _round4(P) * ((0 if given else 1) + 2 * min(len(widths) - 1, 2))


def leaf_sort_plain(points, leaf_grid=None, box_min=None, box_size3=None, depth: int = 0):
    """(lid_s (P,) int32, order (P,) int64): ``exact_descend_plain``'s keys
    sorted, stable, and the sort order, ``torch.sort(keys,
    stable=True)``. With ``leaf_grid`` None, ``points`` are the keys
    themselves, (P,) int32."""
    keys = points if leaf_grid is None else exact_descend_plain(points, leaf_grid, box_min,
                                                                box_size3, depth)
    return tuple(torch.sort(keys, stable=True))


def leaf_sort(points, leaf_grid, box_min, box_size3, depth: int, bits: int):
    """The leaf sort: ``leaf_sort_plain``'s outputs; a CUDA tensor runs the
    kernel, a CPU tensor the plain version. ``points`` (P, 3) float32 on
    the (8^depth,) int32 grid and the box, or with ``leaf_grid`` None the
    (P,) int32 keys (box and depth unused). Every key must lie below
    2^``bits`` (``sort_bits`` of the leaf count; unchecked on the card,
    where a larger key sorts by its low bits only)."""
    dev = points.device if isinstance(points, torch.Tensor) else None
    _need(isinstance(bits, int) and 1 <= bits <= 31, "bits must lie in 1..31")
    if leaf_grid is None:
        _tensor(points, torch.int32, (None,), "keys", dev)
    else:
        _tensor(points, torch.float32, (None, 3), "points", dev)
        _tensor(leaf_grid, torch.int32, (8 ** depth,), "leaf_grid", dev)
        _tensor(box_min, torch.float32, (3,), "box_min", dev)
        _tensor(box_size3, torch.float32, (3,), "box_size3", dev)
        _need(0 <= depth <= 10, "the grid depth must lie in 0..10")
    if not _launches(dev):
        return leaf_sort_plain(points, leaf_grid, box_min, box_size3, depth)
    if leaf_grid is None:
        return launch_leaf_sort(points.contiguous(), None, None, 0, bits)
    box = (*box_min.tolist(), *box_size3.tolist())       # a host sync, once a call
    return launch_leaf_sort(points.contiguous(), leaf_grid.contiguous(), box, depth, bits)


def launch_leaf_sort(points, leaf_grid, box, depth: int, bits: int, counters=None):
    """The leaf sort's launch, unchecked: contiguous CUDA tensors on one
    card, as ``leaf_sort`` checks them, ``box`` the six float32 values of
    box_min and box_size3 as host floats (None, with ``leaf_grid`` None:
    ``points`` are the keys). One memset and 1 + passes launches, no host
    read. Returns (lid_s, order) as the public function. The launch counts
    in ``counters["sort_launch_count"]``: this module's, or the calling
    module's ``globals()``."""
    dev = points.device
    P = points.shape[0]
    lid_s = torch.empty(P, dtype=torch.int32, device=dev)
    order = torch.empty(P, dtype=torch.int64, device=dev)
    if P:
        given = leaf_grid is None
        work = torch.empty(_sort_words(P, bits, given), dtype=torch.int32, device=dev)
        if given:
            head = (None, points.data_ptr(), P, None, 0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
        else:
            head = (points.data_ptr(), None, P, leaf_grid.data_ptr(), depth, *box)
        build.launch("sdf_leaf_sort", dev, *head, bits, build.sm_count(dev), work.data_ptr(),
                     work.numel(), lid_s.data_ptr(), order.data_ptr())
        build.count_launch(globals() if counters is None else counters, "sort_launch_count")
    return lid_s, order


# -- K9: the sorted gather ------------------------------------------------------

def leaf_bounds(leaf_row0, leaf_nchunks):
    """The packed (L, 2) int32 table K9 reads: each leaf's first bucket
    row and row count, side by side."""
    return torch.stack([leaf_row0, leaf_nchunks], dim=1).contiguous()


def exact_sorted_gather_plain(points, order, lid_s=None, leaf_row0=None, leaf_nchunks=None,
                              *, size: int | None = None):
    """(points in sorted order, their first bucket rows, their row counts),
    each zero padded from P to ``size`` points (default P). Without
    ``leaf_row0`` (the grouped scan, whose groups carry the leaves) the
    rows and counts are None."""
    P = points.shape[0]
    pad = (P if size is None else size) - P
    pts_s = torch.cat([points[order], points.new_zeros((pad, 3))])
    if leaf_row0 is None:
        return pts_s, None, None
    zi = torch.zeros(pad, dtype=torch.int32, device=points.device)
    lid = lid_s.long()
    return (pts_s, torch.cat([leaf_row0[lid], zi]), torch.cat([leaf_nchunks[lid], zi]))


def exact_sorted_gather(points, order, lid_s=None, leaf_row0=None, leaf_nchunks=None,
                        *, size: int | None = None):
    """K9: ``exact_sorted_gather_plain``'s outputs; a CUDA tensor runs the
    kernel, a CPU tensor the plain version. ``order`` (P,) int64, the
    sorted leaf ids ``lid_s`` (P,) int32, ``leaf_row0``/``leaf_nchunks``
    (L,) int32 (packed here by ``leaf_bounds`` for the kernel)."""
    dev = points.device if isinstance(points, torch.Tensor) else None
    _tensor(points, torch.float32, (None, 3), "points", dev)
    P = points.shape[0]
    size = P if size is None else int(size)
    _need(size >= P, f"size {size} is below the {P} points")
    _tensor(order, torch.int64, (P,), "order", dev)
    bounds = leaf_row0 is not None
    if bounds:
        _tensor(lid_s, torch.int32, (P,), "lid_s", dev)
        _tensor(leaf_row0, torch.int32, (None,), "leaf_row0", dev)
        _tensor(leaf_nchunks, torch.int32, leaf_row0.shape, "leaf_nchunks", dev)
    if not _launches(dev):
        return exact_sorted_gather_plain(points, order, lid_s, leaf_row0, leaf_nchunks,
                                         size=size)
    return launch_sorted_gather(points.contiguous(), order.contiguous(),
                                lid_s.contiguous() if bounds else None,
                                leaf_bounds(leaf_row0, leaf_nchunks) if bounds else None, size)


def launch_sorted_gather(points, order, lid_s, bounds, size: int):
    """K9's launch, unchecked: contiguous CUDA tensors on one card, as
    ``exact_sorted_gather`` checks them, with the packed ``bounds`` (L, 2)
    of ``leaf_bounds`` (``lid_s`` and ``bounds`` both None in the grouped
    scan), ``size`` >= P. Returns (pts_s, b0, nc) as the public function."""
    dev = points.device
    pts_s = torch.empty((size, 3), dtype=torch.float32, device=dev)
    b0 = nc = None
    if bounds is not None:
        b0 = torch.empty(size, dtype=torch.int32, device=dev)
        nc = torch.empty(size, dtype=torch.int32, device=dev)
    if size:
        build.launch("sdf_exact_sorted_gather", dev, points.data_ptr(), order.data_ptr(),
                     points.shape[0], None if lid_s is None else lid_s.data_ptr(),
                     None if bounds is None else bounds.data_ptr(), size, pts_s.data_ptr(),
                     None if b0 is None else b0.data_ptr(),
                     None if nc is None else nc.data_ptr())
        build.count_launch(globals(), "gather_launch_count")
    return pts_s, b0, nc


# -- K7: the signed finish and the unsort ----------------------------------------

def _gather_soa(table, idx) -> TriangleDataSoA:
    """The triangles ``idx`` of the finish table, one gather a field, as
    ``gather_triangles`` gathers the triangle arrays."""
    P = idx.shape[0]
    col = lambda a, b: table[:, a:b][idx]
    return TriangleDataSoA(
        origin=col(0, 3), transform=col(3, 12).reshape(P, 3, 3), b=col(12, 14),
        c=col(14, 16), v2x=table[:, 16][idx], v3xy=col(17, 19),
        edges_normal=col(19, 28).reshape(P, 3, 3), vertices_normal=col(28, 37).reshape(P, 3, 3),
        v_world=col(_F_VWORLD, _F_VWORLD + 9).reshape(P, 3, 3),
    )


def exact_finish_plain(pts_s, win, order, table, box_min, box_size3, fallback: float,
                       *, with_gradient: bool = False):
    """d (P,), and with the gradient (d, g (P, 3)), of the sorted (P, 3)
    points in the caller's order: point i's values land at ``order[i]``.
    Inside the box [box_min, box_min + box_size3) the
    signed distance to triangle ``win[i]`` (-1, no candidate, reads
    triangle 0), from its row of the finish ``table`` (T, FINISH_FIELDS);
    outside it the box distance plus ``fallback``, with the box's
    gradient."""
    center = box_min + 0.5 * box_size3
    rel = (pts_s - box_min) / box_size3
    in_box = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
    safe = win.clamp_min(0).long()
    if with_gradient:
        d_in, g_in = signed_dist_grad_pair(pts_s, _gather_soa(table, safe))
        d_out, g_out = box_distance_gradient(pts_s, center, box_size3)
        d_s = torch.where(in_box, d_in, d_out + fallback)
        g_s = torch.where(in_box[:, None], g_in, g_out)
        d, g = torch.empty_like(d_s), torch.empty_like(g_s)
        d[order] = d_s
        g[order] = g_s
        return d, g
    # one gather a field (a gathered (P, 48) block's columns would be strided)
    d_in = signed_dist_from_rows(pts_s[:, 0], pts_s[:, 1], pts_s[:, 2],
                                 lambda r: table[:, r][safe])
    d_out = box_distance(pts_s, center, box_size3)
    d_s = torch.where(in_box, d_in, d_out + fallback)
    d = torch.empty_like(d_s)
    d[order] = d_s
    return d


def exact_finish(pts_s, win, order, table, box_min, box_size3, fallback: float,
                 *, with_gradient: bool = False):
    """K7: ``exact_finish_plain``'s outputs; a CUDA tensor runs the kernel
    (one launch for either form), a CPU tensor the plain version. The
    table must be a contiguous (T, FINISH_FIELDS) float32 tensor, 16-byte
    aligned (the structure's ``_finish_table``), on either device."""
    dev = pts_s.device if isinstance(pts_s, torch.Tensor) else None
    _tensor(pts_s, torch.float32, (None, 3), "pts_s", dev)
    P = pts_s.shape[0]
    _tensor(win, torch.int32, (P,), "win", dev)
    _tensor(order, torch.int64, (P,), "order", dev)
    _tensor(table, torch.float32, (None, FINISH_FIELDS), "table", dev)
    _need(table.is_contiguous() and table.data_ptr() % 16 == 0,
          "table must be contiguous (row-major) and 16-byte aligned")
    _tensor(box_min, torch.float32, (3,), "box_min", dev)
    _tensor(box_size3, torch.float32, (3,), "box_size3", dev)
    if not _launches(dev):
        return exact_finish_plain(pts_s, win, order, table, box_min, box_size3, fallback,
                                  with_gradient=with_gradient)
    box = (*box_min.tolist(), *box_size3.tolist())       # a host sync, once a call
    return launch_exact_finish(pts_s.contiguous(), win.contiguous(), order.contiguous(), P,
                               table, box, float(np.float32(fallback)), with_gradient)


def launch_exact_finish(pts_s, win, order, P: int, table, box, fallback: float,
                        with_gradient: bool):
    """K7's launch, unchecked: contiguous CUDA tensors on one card, as
    ``exact_finish`` checks them, of which the first P sorted points and
    winners are read (padded ``pts_s``/``win`` may be longer); ``box``
    the six float32 values of box_min and box_size3 and ``fallback`` a
    float32 value, as host floats. Returns d, or (d, g)."""
    dev = pts_s.device
    d = torch.empty(P, dtype=torch.float32, device=dev)
    g = torch.empty((P, 3), dtype=torch.float32, device=dev) if with_gradient else None
    if P:
        build.launch("sdf_exact_finish", dev, pts_s.data_ptr(), win.data_ptr(),
                     order.data_ptr(), P, table.data_ptr(), *box, fallback, d.data_ptr(),
                     None if g is None else g.data_ptr())
        build.count_launch(globals(), "finish_launch_count")
    return (d, g) if with_gradient else d
