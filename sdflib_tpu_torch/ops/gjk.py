"""Batched convex distance tests (the GJK role): box-triangle culling
predicates, in plain torch.

Port of the JAX package's ``ops/gjk.py`` (reference: src/utils/GJK.cpp,
the box-triangle ``getMinDistance`` :476-517 and the Frank-Wolfe
``IsNearMinimize`` :564-600 capped at 15 iterations). The box-triangle
distance is exact, by complete feature-pair enumeration:

    d = min(3 triangle-vertex-to-box distances,
            8 box-vertex-to-triangle distances,
            36 triangle-edge-to-box-edge distances)

and 0 when the 13-axis separating-axis test reports an overlap. The
Frank-Wolfe minimizer serves the general convex hulls of the precise and
per-vertex influence tests (GJK.cpp:661-867). Every function broadcasts
over leading dims, in fp32, with the JAX function's arithmetic order;
every dot product is ``(a * b).sum(-1)``, never a matmul (TF32 on the
card).
"""
from __future__ import annotations

import numpy as np
import torch

from .point_triangle import _cross, _dot_last, sq_dist_naive

__all__ = [
    "box_triangle_distance",
    "box_triangle_overlap",
    "gjk_min_distance",
    "gjk_is_near",
    "gjk_max_distance",
    "minkowski_box_triangle",
    "frank_wolfe_min_norm",
    "corner_sphere_hull_tri_lower",
    "GJK_ITERATIONS",
]

# Box corner signs in {-1,1}^3, corner index c = cx + 2cy + 4cz.
_BOX_SIGNS = np.array(
    [[(c & 1) * 2 - 1, ((c >> 1) & 1) * 2 - 1, ((c >> 2) & 1) * 2 - 1]
     for c in range(8)],
    np.float32,
)

# The 12 box edges as (corner index, axis) pairs.
_BOX_EDGES = [(c, ax) for ax in range(3) for c in range(8) if not (c >> ax) & 1]

GJK_ITERATIONS = 15  # the reference's cap (GJK.cpp:567)


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _point_box_sq(p, half):
    """Squared distance from a box-centred point p (..., 3) to the origin
    box of half extents ``half`` (..., 3)."""
    q = (p.abs() - half).clamp_min(0.0)
    return (q * q).sum(-1)


def _seg_seg_sq(p1, d1, p2, d2):
    """Squared distance between segments p1 + t d1 and p2 + s d2, t and s
    in [0, 1] (Ericson, Real-Time Collision Detection 5.1.9, branchless)."""
    r = p1 - p2
    a = _dot_last(d1, d1)
    e = _dot_last(d2, d2)
    f = _dot_last(d2, r)
    c = _dot_last(d1, r)
    b = _dot_last(d1, d2)
    denom = a * e - b * b

    t = torch.where(
        denom > 1e-20,
        ((b * f - c * e) / denom.clamp_min(1e-20)).clamp(0.0, 1.0),
        0.0,
    )
    s = (b * t + f) / e.clamp_min(1e-20)
    s_cl = s.clamp(0.0, 1.0)
    # t re-optimised for the clamped s
    t2 = ((b * s_cl - c) / a.clamp_min(1e-20)).clamp(0.0, 1.0)
    t = torch.where((s < 0.0) | (s > 1.0), t2, t)
    s = s_cl

    diff = (p1 + d1 * t[..., None]) - (p2 + d2 * s[..., None])
    return _dot_last(diff, diff)


def box_triangle_overlap(box_center, box_half, tri_verts):
    """13-axis separating-axis test (Akenine-Moller), batched: True where
    the triangle (..., 3, 3) meets the axis-aligned box."""
    c = _f32(box_center)
    h = _f32(box_half, c.device).expand(c.shape)
    v = _f32(tri_verts, c.device) - c[..., None, :]          # (..., 3, 3)

    sep = torch.zeros(c.shape[:-1], dtype=torch.bool, device=c.device)
    for ax in range(3):                                      # 3 box axes
        lo = v[..., :, ax].amin(-1)
        hi = v[..., :, ax].amax(-1)
        sep = sep | (lo > h[..., ax]) | (hi < -h[..., ax])

    e0 = v[..., 1, :] - v[..., 0, :]                         # triangle normal
    e1 = v[..., 2, :] - v[..., 1, :]
    n = _cross(e0, e1)
    d = _dot_last(n, v[..., 0, :])
    r = _dot_last(h, n.abs())
    sep = sep | (d.abs() > r)

    e2 = v[..., 0, :] - v[..., 2, :]                         # 9 axes e_i x unit_j
    for e in (e0, e1, e2):
        for j in range(3):
            unit = torch.zeros(3, device=c.device)
            unit[j] = 1.0
            a = _cross(e, unit.expand(e.shape))
            p = _dot_last(v, a[..., None, :])                # (..., 3)
            lo = p.amin(-1)
            hi = p.amax(-1)
            ra = _dot_last(h, a.abs())
            sep = sep | (lo > ra) | (hi < -ra)
    return ~sep


def box_triangle_distance(box_center, box_half, tri_verts):
    """Exact distance between axis-aligned boxes and triangles (0 where
    they overlap), by complete feature-pair enumeration. ``box_half``
    broadcasts to (..., 3)."""
    c = _f32(box_center)
    h = _f32(box_half, c.device).expand(c.shape)
    v = _f32(tri_verts, c.device) - c[..., None, :]          # box frame
    signs = _f32(_BOX_SIGNS, c.device)

    best = torch.full(c.shape[:-1], torch.inf, device=c.device)
    for i in range(3):                                       # triangle vertices
        best = torch.minimum(best, _point_box_sq(v[..., i, :], h))

    corners = signs * h[..., None, :]                        # (..., 8, 3)
    for k in range(8):                                       # box vertices
        best = torch.minimum(best, sq_dist_naive(
            corners[..., k, :], v[..., 0, :], v[..., 1, :], v[..., 2, :]))

    tri_starts = (v[..., 0, :], v[..., 1, :], v[..., 2, :])  # edge pairs
    tri_dirs = (
        v[..., 1, :] - v[..., 0, :],
        v[..., 2, :] - v[..., 1, :],
        v[..., 0, :] - v[..., 2, :],
    )
    for corner, ax in _BOX_EDGES:
        p2 = signs[corner] * h
        unit2 = torch.zeros(3, device=c.device)
        unit2[ax] = 2.0
        d2 = unit2 * h
        for p1, d1 in zip(tri_starts, tri_dirs):
            best = torch.minimum(best, _seg_seg_sq(p1, d1, p2, d2.expand(p1.shape)))

    dist = best.sqrt()
    return torch.where(box_triangle_overlap(c, h, tri_verts), torch.zeros_like(dist), dist)


# ---------------------------------------------------------------------------
# Frank-Wolfe over general convex hulls (the influence-region tests)
# ---------------------------------------------------------------------------


def minkowski_box_triangle(box_center, box_half, tri_verts):
    """Vertices of box (-) triangle: (..., 24, 3)."""
    c = _f32(box_center)
    tv = _f32(tri_verts, c.device)
    half = _f32(box_half, c.device).expand(c.shape)
    corners = c[..., None, :] + _f32(_BOX_SIGNS, c.device) * half[..., None, :]
    diff = corners[..., :, None, :] - tv[..., None, :, :]
    return diff.reshape(diff.shape[:-3] + (24, 3))


def _pick(verts, idx):
    """verts[..., idx, :] for an index of the (broadcast) leading shape."""
    verts = verts.expand(idx.shape + verts.shape[-2:])
    return verts.gather(-2, idx[..., None, None].expand(idx.shape + (1, verts.shape[-1])))[
        ..., 0, :]


def frank_wolfe_min_norm(verts, iterations: int = GJK_ITERATIONS):
    """min over x in conv(verts) of |x| by fixed-iteration Frank-Wolfe with
    exact line search: an upper bound on the distance, the reference's
    IsNearMinimize loop (GJK.cpp:564-600). verts (..., V, 3) -> (...)."""
    x = verts[..., 0, :]
    for _ in range(iterations):
        dots = _dot_last(verts, x[..., None, :])             # (..., V)
        s = _pick(verts, dots.argmin(-1))
        d = s - x
        dd = _dot_last(d, d)
        gamma = torch.where(
            dd > 0.0,
            (-_dot_last(x, d) / dd.clamp_min(1e-30)).clamp(0.0, 1.0),
            0.0,
        )
        x = x + gamma[..., None] * d
    return _dot_last(x, x).sqrt()


def gjk_min_distance(box_center, box_half, tri_verts, iterations: int | None = None):
    """Box-triangle distance: exact by default; ``iterations`` takes the
    reference's Frank-Wolfe upper bound instead."""
    if iterations is None:
        return box_triangle_distance(box_center, box_half, tri_verts)
    return frank_wolfe_min_norm(
        minkowski_box_triangle(box_center, box_half, tri_verts), iterations)


def gjk_is_near(box_center, box_half, tri_verts, threshold):
    """The IsNearMinimize role (GJK.cpp:564-600): True where the box-
    triangle distance is below ``threshold`` (exact here)."""
    d = box_triangle_distance(box_center, box_half, tri_verts)
    return d < _f32(threshold, d.device)


def gjk_max_distance(box_center, box_half, tri_verts):
    """Exact largest distance between box and triangle, reached at
    vertices of both hulls (the getMinMaxDistance role, GJK.cpp:617)."""
    diff = minkowski_box_triangle(box_center, box_half, tri_verts)
    return _dot_last(diff, diff).amax(-1).sqrt()


def corner_sphere_hull_tri_lower(center, half, radii, tri_verts,
                                 iterations: int = GJK_ITERATIONS):
    """A lower bound on dist(conv(tri_verts), H), H the convex hull of the
    eight spheres at the node corners with per-corner radii: the influence
    hulls of the reference's precise and per-vertex strategies
    (GJK.cpp:661-867).

    Frank-Wolfe over D = conv(tri) (-) H with the dual bound: for an
    iterate x != 0 and the oracle's vertex v, every y in D has
    |y| >= (x . v) / |x|; the largest bound over the iterations is
    returned. H's support is max_c (corner_c . g + r_c |g|). A lower
    bound keeps the cull conservative (only provably outside triangles
    go). center (..., 3), half a scalar, radii (..., 8), tri_verts
    (..., 3, 3) -> (...); negative means possibly intersecting."""
    center = _f32(center)
    dev = center.device
    tv = _f32(tri_verts, dev)
    radii = _f32(radii, dev)
    corners = center[..., None, :] + _f32(_BOX_SIGNS, dev) * _f32(half, dev)   # (..., 8, 3)

    x = tv.mean(-2) - center            # the centroid minus the centre: in D
    best = torch.full(x.shape[:-1], -torch.inf, device=dev)
    for _ in range(iterations):
        xn = _dot_last(x, x).sqrt()
        safe = xn.clamp_min(1e-30)
        # oracle over D: the nearest triangle vertex minus the farthest hull point
        a = _pick(tv, _dot_last(tv, x[..., None, :]).argmin(-1))
        hd = _dot_last(corners, x[..., None, :]) + radii * xn[..., None]
        hi = hd.argmax(-1)
        b_corner = _pick(corners, hi)
        b_r = radii.expand(hd.shape).gather(-1, hi[..., None])[..., 0]
        v = a - b_corner - b_r[..., None] * (x / safe[..., None])
        lower = _dot_last(x, v) / safe
        best = torch.maximum(best, torch.where(xn > 1e-20, lower, -torch.inf))
        d = v - x                       # the step, exact line search toward v
        dd = _dot_last(d, d)
        gamma = torch.where(
            dd > 0.0,
            (-_dot_last(x, d) / dd.clamp_min(1e-30)).clamp(0.0, 1.0),
            0.0,
        )
        x = x + gamma[..., None] * d
    return best
