"""K2: nearest triangle by brute force, the RealSdf oracle's sweep.

``nearest_triangle`` launches the CUDA kernel ``csrc/nearest.cu`` for
CUDA tensors (it replaces sdflib_tpu/ops/pallas_kernels.py:
_nearest_kernel) and takes ``nearest_triangle_plain``, the plain torch
version with the semantics of the JAX package's ``nearest_triangle``,
for CPU tensors. From ``MORTON_PAIRS`` point-triangle pairs on, the
kernel takes the points in Morton order (``morton_order``: one kernel
launch up to ``morton_order_max(device)`` points, else the box and code
kernels and a stable sort; ``morton_order_plain`` on CPU tensors);
results come back in the caller's order. ``launch_count`` counts
launches of the nearest-triangle kernel, ``morton_launch_count`` those of
the point order's kernels; ``last_grid`` holds the (point tiles,
triangle slices) of the last launch.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..kernels import build
from .point_triangle import NUM_PACKED_FIELDS, sq_dist_from_field_fn

__all__ = [
    "nearest_triangle", "nearest_triangle_plain", "morton_codes_plain", "morton_order",
    "morton_order_plain", "morton_order_max", "launch_count", "morton_launch_count",
]

POINT_TILE = 1024   # points a CTA of the kernel owns (256 threads x 4)
TRI_TILE = 64       # triangles a staged tile; slices are runs of whole tiles
CTAS_PER_SM = 4     # the grid a split aims for, in CTAs per SM
# P * T from which the points are put in Morton order (chip_smoke.py times
# both orders at each of its K2 shapes). On an H100 80GB HBM3 at 700 W with
# the one-launch order the order as given was still faster at 4k x
# 9,216 (0.1671 against 0.2080 ms, the order included) and 10k x 9,216
# (0.3099 against 0.3427 ms; the order alone 0.0462 and 0.0654 ms), Morton
# order at 10k x 100,800 (2.6205 against 3.3412 ms) and 2^20 x 9,216
# (18.1450 against 25.2361 ms), so the threshold stays between them.
MORTON_PAIRS = 1 << 27
launch_count = 0
morton_launch_count = 0
last_grid: tuple[int, int] | None = None


def _split(P: int, T: int, sm_count: int) -> tuple[int, int]:
    """(point tiles, triangle slices S) of the kernel's grid.

    Slice s holds the triangle tiles [s * n // S, (s + 1) * n // S) of the
    n = ceil(T / TRI_TILE) tiles, as the kernel computes them. S = 1 once
    the point tiles alone reach the target of ``CTAS_PER_SM * sm_count``
    CTAs. Below it, each slice takes the same number of whole tiles, the
    fewest slices that come near the target: never below half of it (2
    CTAs an SM), or one tile a slice where T is too small for that."""
    tiles_p = -(-P // POINT_TILE)
    tiles_t = -(-T // TRI_TILE)
    target = CTAS_PER_SM * sm_count
    if tiles_p == 0 or tiles_t <= 1 or tiles_p >= target:
        return tiles_p, 1
    want = min(-(-target // tiles_p), tiles_t)
    per = -(-tiles_t // want)
    return tiles_p, -(-tiles_t // per)


def nearest_triangle_plain(points, fields, chunk: int = 512, block: int = 8192):
    """(squared distance, index) of the nearest triangle for (P, 3) points
    over (T, 19) packed fields: chunks of triangles with a running min
    (strict <, so the lowest index wins ties), ``block`` points at a time
    to bound the (block, chunk) temporaries."""
    P, T = points.shape[0], fields.shape[0]
    f_t = fields.t().contiguous()
    best = torch.full((P,), torch.inf, dtype=torch.float32, device=points.device)
    best_idx = torch.zeros(P, dtype=torch.int32, device=points.device)
    for p0 in range(0, P, block):
        pts = points[p0 : p0 + block]
        px, py, pz = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
        b, bi = best[p0 : p0 + block], best_idx[p0 : p0 + block]
        for c0 in range(0, T, chunk):
            f = f_t[:, c0 : c0 + chunk]
            d = sq_dist_from_field_fn(px, py, pz, lambda r: f[r][None, :])
            local, local_idx = d.min(dim=1)
            take = local < b
            b = torch.where(take, local, b)
            bi = torch.where(take, (local_idx + c0).to(torch.int32), bi)
        best[p0 : p0 + block] = b
        best_idx[p0 : p0 + block] = bi
    return best, best_idx


def nearest_triangle(points, fields):
    """(squared distance (P,) f32, index (P,) i32) of the nearest triangle.
    A CUDA tensor runs the kernel; a CPU tensor the plain version."""
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (P, 3), got {tuple(points.shape)}")
    if fields.ndim != 2 or fields.shape[1] != NUM_PACKED_FIELDS:
        raise ValueError(f"fields must be (T, 19), got {tuple(fields.shape)}")
    if points.device != fields.device:
        raise ValueError("points and fields must be on one device")
    if points.device.type == "cpu":
        return nearest_triangle_plain(points, fields)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    pts = points.to(torch.float32).contiguous()
    fld = fields.to(torch.float32).contiguous()
    sort = pts.shape[0] and pts.shape[0] * fld.shape[0] >= MORTON_PAIRS
    return _launch(pts, fld, morton_order(pts) if sort else None)


def morton_codes_plain(pts, lo, hi):
    """(P,) int32 Morton codes of (P, 3) f32 points on a 1024^3 grid over
    the box [lo, hi]: each axis scaled to [0, 1023] (a NaN to 0), clamped
    and truncated, its 10 bits spread to every third bit (x lowest)."""
    t = (pts - lo) / (hi - lo) * 1023.0
    cell = torch.where(t != t, 0.0, t).clamp(0.0, 1023.0).to(torch.int64)
    for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3),
                        (2, 0x09249249)):
        cell = (cell | (cell << shift)) & mask
    return (cell[:, 0] | (cell[:, 1] << 1) | (cell[:, 2] << 2)).to(torch.int32)


def morton_order_plain(pts):
    """(P,) int64: a stable sort of the (P, 3) f32 points' Morton codes over
    their own box (``torch.aminmax``, which keeps a NaN: a NaN coordinate
    sends every point of its axis to cell 0, as a flat axis does), so that
    a warp's points lie close together and mostly take the same branch of
    the region ladder. Stable, so the order is a function of the points."""
    if pts.shape[0] == 0:
        return torch.empty(0, dtype=torch.int64, device=pts.device)
    lo, hi = torch.aminmax(pts, dim=0)
    return torch.sort(morton_codes_plain(pts, lo, hi), stable=True).indices


@lru_cache(maxsize=None)
def morton_order_max(device: torch.device) -> int:
    """The most points whose order the kernel makes in one launch on the
    CUDA ``device`` (what its shared memory holds; read once a card)."""
    with torch.cuda.device(device):
        most = build.library().sdf_morton_order_max()
    if most <= 0:
        raise RuntimeError(f"sdf_morton_order_max failed on {device}")
    return most


def morton_order(pts):
    """``morton_order_plain`` of contiguous (P, 3) f32 points: on a CUDA
    tensor one kernel launch up to ``morton_order_max`` points (box, codes
    and a stable radix sort in one CTA), else the box and code kernels and
    ``torch.sort(stable=True)`` of the int32 codes; the plain version on a
    CPU tensor."""
    if (pts.ndim != 2 or pts.shape[1] != 3 or pts.dtype != torch.float32
            or not pts.is_contiguous()):
        raise ValueError(f"expected contiguous f32 (P, 3) points, got {tuple(pts.shape)}")
    if pts.device.type == "cpu":
        return morton_order_plain(pts)
    P = pts.shape[0]
    if P == 0:
        return torch.empty(0, dtype=torch.int64, device=pts.device)
    if P <= morton_order_max(pts.device):
        order = torch.empty(P, dtype=torch.int64, device=pts.device)
        build.launch("sdf_morton_order", pts.device, pts.data_ptr(), P, order.data_ptr())
        build.count_launch(globals(), "morton_launch_count")
        return order
    codes = torch.empty(P, dtype=torch.int32, device=pts.device)
    box = torch.empty(7, dtype=torch.int32, device=pts.device)
    build.launch("sdf_morton_codes", pts.device, pts.data_ptr(), P, box.data_ptr(),
                 codes.data_ptr())
    build.count_launch(globals(), "morton_launch_count")   # the box kernel
    build.count_launch(globals(), "morton_launch_count")   # the code kernel
    return torch.sort(codes, stable=True).indices


def _launch(pts, fld, order):
    """The kernel over contiguous f32 CUDA points and fields, taking the
    points in ``order`` with the branching ladder, or as given with the
    select ladder (``order`` None); results in the points' order."""
    global last_grid
    P, T = pts.shape[0], fld.shape[0]
    best = torch.empty(P, dtype=torch.float32, device=pts.device)
    idx = torch.empty(P, dtype=torch.int32, device=pts.device)
    if P == 0:
        return best, idx
    grid = _split(P, T, build.sm_count(pts.device))
    S = grid[1]
    # the slices' minima, then their ids as int32 bits; filled by the kernel
    scratch = torch.empty(2 * S * P if S > 1 else 0, dtype=torch.float32,
                          device=pts.device)
    build.launch("sdf_nearest_triangle", pts.device, pts.data_ptr(),
                 None if order is None else order.data_ptr(), P, fld.data_ptr(), T, S,
                 scratch.data_ptr() if S > 1 else None, best.data_ptr(), idx.data_ptr())
    build.count_launch(globals(), "launch_count")
    last_grid = grid
    return best, idx
