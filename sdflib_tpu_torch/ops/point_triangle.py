"""Batched point-triangle distance math in plain torch.

Port of the JAX package's ``ops/point_triangle.py`` (reference:
include/SdfLib/utils/TriangleUtils.h:76-401). The reference's branchy
Voronoi-region classification is a ``where`` ladder whose tie-breaking
(``>=`` vs ``<=``) matches the reference exactly.

Region codes: 0=v1, 1=v2, 2=v3, 3=edge1(v1v2), 4=edge2(v2v3),
5=edge3(v3v1), 6=face.

The ``*_pair`` functions broadcast over leading batch dims: ``points``
is (..., 3) and every field of ``tri`` carries the same leading dims.
Every distance is fp32 elementwise arithmetic, never a matmul (a TF32
matmul would break distance parity on the GPU).
"""
from __future__ import annotations

import torch

from ..triangle import TriangleDataSoA

__all__ = [
    "region_code",
    "sq_dist_pair",
    "signed_dist_pair",
    "signed_dist_grad_pair",
    "pack_triangle_fields",
    "pack_triangle_full_fields",
    "sq_dist_from_field_fn",
    "sq_dist_and_grad_from_field_fn",
    "sq_dist_packed",
    "signed_dist_from_rows",
    "sq_dist_from_vertex_cols",
    "sq_dist_naive",
    "gather_triangles",
    "signed_distance_batch",
    "signed_distance_grad_batch",
    "NUM_PACKED_FIELDS",
    "NUM_FULL_FIELDS",
]

V1, V2, V3, E1, E2, E3, FACE = 0, 1, 2, 3, 4, 5, 6


def _project(points, tri: TriangleDataSoA):
    """World points -> triangle space, as three component tensors."""
    d = points - tri.origin
    t = tri.transform
    return tuple(
        t[..., i, 0] * d[..., 0] + t[..., i, 1] * d[..., 1] + t[..., i, 2] * d[..., 2]
        for i in range(3)
    )


def _select_by_code(code, cands):
    """7-way select as a where-ladder over the region code."""
    out = cands[6]
    for k in range(5, -1, -1):
        out = torch.where(code == k, cands[k], out)
    return out


def _code(x, y, v2x, v3x, v3y, b0, b1, c0, c1):
    """The Voronoi feature of triangle-space points (x, y), with the
    nesting and tie-breaking of TriangleUtils.h:84-134. Returns
    (code, (de1, de2, de3))."""
    de1 = -y
    de2 = (x - v2x) * b1 - y * b0
    de3 = x * c1 - y * c0

    r1 = torch.where(x <= 0.0, V1, torch.where(x >= v2x, V2, E1))
    dot_b_v2 = (x - v2x) * b0 + y * b1
    dot_b_v3 = (x - v3x) * b0 + (y - v3y) * b1
    r2 = torch.where(dot_b_v2 <= 0.0, V2, torch.where(dot_b_v3 >= 0.0, V3, E2))
    dot_c_v1 = x * c0 + y * c1
    dot_c_v3 = (x - v3x) * c0 + (y - v3y) * c1
    r3 = torch.where(dot_c_v1 >= 0.0, V1, torch.where(dot_c_v3 <= 0.0, V3, E3))

    code = torch.where(
        de1 >= 0.0,
        r1,
        torch.where(de2 >= 0.0, r2, torch.where(de3 >= 0.0, r3, FACE)),
    )
    return code, (de1, de2, de3)


def region_code(pp, tri: TriangleDataSoA):
    """Classify projected points (x, y, z components) into one of the 7
    Voronoi features. Returns (code, (de1, de2, de3))."""
    return _code(
        pp[0], pp[1], tri.v2x, tri.v3xy[..., 0], tri.v3xy[..., 1],
        tri.b[..., 0], tri.b[..., 1], tri.c[..., 0], tri.c[..., 1],
    )


def _offsets(pp, tri: TriangleDataSoA):
    """Relative vectors from the three vertices in triangle space."""
    x, y, z = pp
    p_v2 = (x - tri.v2x, y, z)
    p_v3 = (x - tri.v3xy[..., 0], y - tri.v3xy[..., 1], z)
    return pp, p_v2, p_v3


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sq_dist_pair(points, tri: TriangleDataSoA):
    """Unsigned squared distance (TriangleUtils.h:76-135)."""
    pp = _project(points, tri)
    code, (de1, de2, de3) = region_code(pp, tri)
    p_v1, p_v2, p_v3 = _offsets(pp, tri)
    z2 = pp[2] * pp[2]
    cands = (
        _dot3(p_v1, p_v1),
        _dot3(p_v2, p_v2),
        _dot3(p_v3, p_v3),
        de1 * de1 + z2,
        de2 * de2 + z2,
        de3 * de3 + z2,
        z2,
    )
    return _select_by_code(code, cands)


def _region_sign(code, pp, tri: TriangleDataSoA):
    """Pseudonormal sign per region (TriangleUtils.h:137-196)."""
    p_v1, p_v2, p_v3 = _offsets(pp, tri)
    vn = tri.vertices_normal
    en = tri.edges_normal

    def row(m, k):
        return (m[..., k, 0], m[..., k, 1], m[..., k, 2])

    dots = (
        _dot3(row(vn, 0), p_v1),
        _dot3(row(vn, 1), p_v2),
        _dot3(row(vn, 2), p_v3),
        _dot3(row(en, 0), pp),
        _dot3(row(en, 1), p_v2),
        _dot3(row(en, 2), pp),
        pp[2],
    )
    return torch.sign(_select_by_code(code, dots))


def signed_dist_pair(points, tri: TriangleDataSoA):
    """Signed distance: the face region returns ``pp.z``, every other
    region sign(pseudonormal . rel) * sqrt(sq_dist)."""
    pp = _project(points, tri)
    code, _ = region_code(pp, tri)
    sq = sq_dist_pair(points, tri)
    sign = _region_sign(code, pp, tri)
    return torch.where(code == FACE, pp[2], sign * sq.sqrt())


def _safe_normalize(vec, fallback):
    """normalize with the fallback of TriangleUtils.h:208-212."""
    n2 = (vec * vec).sum(-1, keepdim=True)
    inv = torch.where(n2 > 0.0, torch.rsqrt(n2.clamp_min(1e-38)), 0.0)
    return torch.where(n2 > 0.0, vec * inv, fallback)


def _to_world(tri: TriangleDataSoA, x, y, z):
    """transform^T @ (x, y, z): a triangle-space vector to world space."""
    t = tri.transform
    return torch.stack(
        [t[..., 0, j] * x + t[..., 1, j] * y + t[..., 2, j] * z for j in range(3)],
        dim=-1,
    )


def signed_dist_grad_pair(points, tri: TriangleDataSoA):
    """Signed distance + world-space gradient (TriangleUtils.h:198-290).
    Returns (dist (...), grad (..., 3))."""
    pp = _project(points, tri)
    x, y, z = pp
    code, _ = region_code(pp, tri)
    sq = sq_dist_pair(points, tri)
    sign = _region_sign(code, pp, tri)
    dist = torch.where(code == FACE, z, sign * sq.sqrt())

    tn = tri.transform[..., 2, :]
    vw = tri.v_world
    n_v1 = _safe_normalize(points - vw[..., 0, :], tn)
    n_v2 = _safe_normalize(points - vw[..., 1, :], tn)
    n_v3 = _safe_normalize(points - vw[..., 2, :], tn)
    n_e1 = _safe_normalize(_to_world(tri, torch.zeros_like(x), y, z), tn)
    b0, b1 = tri.b[..., 0], tri.b[..., 1]
    dot_b = (x - tri.v2x) * b0 + y * b1
    n_e2 = _safe_normalize(
        _to_world(tri, (x - tri.v2x) - dot_b * b0, y - dot_b * b1, z), tn
    )
    c0, c1 = tri.c[..., 0], tri.c[..., 1]
    dot_c = x * c0 + y * c1
    n_e3 = _safe_normalize(_to_world(tri, x - dot_c * c0, y - dot_c * c1, z), tn)

    normals = (n_v1, n_v2, n_v3, n_e1, n_e2, n_e3, tn)
    sel = _select_by_code(code[..., None], normals)
    # a point on an edge or vertex of the triangle (sign 0 at distance 0)
    # takes the face normal, not 0: which of the tied triangles wins there
    # depends on the last ulp, and the face normal is the answer of the
    # face region beside it
    on_rim = (code != FACE) & (sign == 0.0) & (sq == 0.0)
    grad = torch.where(((code == FACE) | on_rim)[..., None], tn, sign[..., None] * sel)
    return dist, grad


# ---------------------------------------------------------------------------
# Packed rows: the fields a distance needs, one fp32 row per triangle.
# ---------------------------------------------------------------------------

NUM_PACKED_FIELDS = 19
_F_ORIGIN = 0       # 0:3   origin xyz
_F_TRANSFORM = 3    # 3:12  world->tri transform, row-major
_F_B = 12           # 12:14 edge v2->v3 2D direction
_F_C = 14           # 14:16 edge v3->v1 2D direction
_F_V2X = 16         # v2.x in triangle space
_F_V3 = 17          # 17:19 v3.xy in triangle space

NUM_FULL_FIELDS = 37
_F_EDGE_N = 19      # 19:28 edges_normal, 3 x 3
_F_VERT_N = 28      # 28:37 vertices_normal, 3 x 3


def pack_triangle_fields(tris: TriangleDataSoA):
    """(T, 19) fp32: origin, transform (row-major), b, c, v2x, v3xy."""
    T = tris.origin.shape[0]
    return torch.cat(
        [
            tris.origin,
            tris.transform.reshape(T, 9),
            tris.b,
            tris.c,
            tris.v2x[:, None],
            tris.v3xy,
        ],
        dim=1,
    ).to(torch.float32)


def pack_triangle_full_fields(tris: TriangleDataSoA):
    """(T, 37) fp32: the 19 packed fields + edge and vertex pseudonormals,
    everything the signed evaluation needs in one gathered row."""
    T = tris.origin.shape[0]
    return torch.cat(
        [
            pack_triangle_fields(tris),
            tris.edges_normal.reshape(T, 9),
            tris.vertices_normal.reshape(T, 9),
        ],
        dim=1,
    ).to(torch.float32)


def _frame_coords(px, py, pz, f):
    dx = px - f(_F_ORIGIN)
    dy = py - f(_F_ORIGIN + 1)
    dz = pz - f(_F_ORIGIN + 2)
    ppx = f(_F_TRANSFORM + 0) * dx + f(_F_TRANSFORM + 1) * dy + f(_F_TRANSFORM + 2) * dz
    ppy = f(_F_TRANSFORM + 3) * dx + f(_F_TRANSFORM + 4) * dy + f(_F_TRANSFORM + 5) * dz
    ppz = f(_F_TRANSFORM + 6) * dx + f(_F_TRANSFORM + 7) * dy + f(_F_TRANSFORM + 8) * dz
    return ppx, ppy, ppz


def _ladder(ppx, ppy, ppz, v2x, v3x, v3y, b0, b1, c0, c1):
    """The region ladder on triangle-space coordinates -> squared
    distance, with the tie-breaking of TriangleUtils.h:76-135. Shared by
    the field-row and vertex-row evaluators."""
    de1 = -ppy
    de2 = (ppx - v2x) * b1 - ppy * b0
    de3 = ppx * c1 - ppy * c0
    z2 = ppz * ppz

    d_v1 = ppx * ppx + ppy * ppy + z2
    rx2 = ppx - v2x
    d_v2 = rx2 * rx2 + ppy * ppy + z2
    rx3, ry3 = ppx - v3x, ppy - v3y
    d_v3 = rx3 * rx3 + ry3 * ry3 + z2

    r1 = torch.where(ppx <= 0.0, d_v1, torch.where(ppx >= v2x, d_v2, de1 * de1 + z2))
    dot_b_v2 = rx2 * b0 + ppy * b1
    dot_b_v3 = rx3 * b0 + ry3 * b1
    r2 = torch.where(
        dot_b_v2 <= 0.0, d_v2, torch.where(dot_b_v3 >= 0.0, d_v3, de2 * de2 + z2)
    )
    dot_c_v1 = ppx * c0 + ppy * c1
    dot_c_v3 = rx3 * c0 + ry3 * c1
    r3 = torch.where(
        dot_c_v1 >= 0.0, d_v1, torch.where(dot_c_v3 <= 0.0, d_v3, de3 * de3 + z2)
    )
    return torch.where(
        de1 >= 0.0, r1, torch.where(de2 >= 0.0, r2, torch.where(de3 >= 0.0, r3, z2))
    )


def sq_dist_from_field_fn(px, py, pz, f):
    """Region-classified squared distance from a field accessor: ``f(r)``
    returns packed field ``r`` (``pack_triangle_fields`` layout)
    broadcastable against px/py/pz."""
    ppx, ppy, ppz = _frame_coords(px, py, pz, f)
    return _ladder(
        ppx, ppy, ppz,
        f(_F_V2X), f(_F_V3), f(_F_V3 + 1),
        f(_F_B), f(_F_B + 1), f(_F_C), f(_F_C + 1),
    )


def sq_dist_packed(px, py, pz, fields):
    """sq_dist_from_field_fn with the 19 fields on the trailing axis."""
    return sq_dist_from_field_fn(px, py, pz, lambda r: fields[..., r])


def sq_dist_and_grad_from_field_fn(px, py, pz, f):
    """Squared distance and its world-space gradient 2 (p - proj), computed
    branch by branch of the region ladder. Returns (sq, gx, gy, gz).

    The gradient in triangle space per region: vertex regions 2 (pp - v),
    edge regions 2 de (d de / d pp) + (0, 0, 2 z), face (0, 0, 2 z); the
    world gradient is transform^T of it."""
    ppx, ppy, ppz = _frame_coords(px, py, pz, f)
    v2x, v3x, v3y = f(_F_V2X), f(_F_V3), f(_F_V3 + 1)
    b0, b1, c0, c1 = f(_F_B), f(_F_B + 1), f(_F_C), f(_F_C + 1)
    sq = _ladder(ppx, ppy, ppz, v2x, v3x, v3y, b0, b1, c0, c1)
    code, (de1, de2, de3) = _code(ppx, ppy, v2x, v3x, v3y, b0, b1, c0, c1)
    rx2 = ppx - v2x
    rx3, ry3 = ppx - v3x, ppy - v3y
    zero = torch.zeros_like(ppx)
    cands = (
        (ppx, ppy),             # v1
        (rx2, ppy),             # v2
        (rx3, ry3),             # v3
        (zero, -de1),           # edge1: d(de1^2)/2 = de1 * (0, -1)
        (de2 * b1, -de2 * b0),  # edge2
        (de3 * c1, -de3 * c0),  # edge3
        (zero, zero),           # face
    )
    hx = 2.0 * _select_by_code(code, [c[0] for c in cands])
    hy = 2.0 * _select_by_code(code, [c[1] for c in cands])
    hz = 2.0 * ppz
    t = [f(_F_TRANSFORM + k) for k in range(9)]
    gx = t[0] * hx + t[3] * hy + t[6] * hz
    gy = t[1] * hx + t[4] * hy + t[7] * hz
    gz = t[2] * hx + t[5] * hy + t[8] * hz
    return sq, gx, gy, gz


def signed_dist_from_rows(px, py, pz, f):
    """Signed distance from a 37-field row accessor: the classification and
    sign logic of ``signed_dist_pair`` on gathered columns."""
    ppx, ppy, ppz = _frame_coords(px, py, pz, f)
    b0, b1 = f(_F_B), f(_F_B + 1)
    c0, c1 = f(_F_C), f(_F_C + 1)
    v2x = f(_F_V2X)
    v3x, v3y = f(_F_V3), f(_F_V3 + 1)

    de1 = -ppy
    de2 = (ppx - v2x) * b1 - ppy * b0
    de3 = ppx * c1 - ppy * c0
    z2 = ppz * ppz
    rx2 = ppx - v2x
    rx3, ry3 = ppx - v3x, ppy - v3y
    d_v1 = ppx * ppx + ppy * ppy + z2
    d_v2 = rx2 * rx2 + ppy * ppy + z2
    d_v3 = rx3 * rx3 + ry3 * ry3 + z2

    def vdot(base, rx, ry, rz):
        return f(base) * rx + f(base + 1) * ry + f(base + 2) * rz

    s_v1 = vdot(_F_VERT_N + 0, ppx, ppy, ppz)
    s_v2 = vdot(_F_VERT_N + 3, rx2, ppy, ppz)
    s_v3 = vdot(_F_VERT_N + 6, rx3, ry3, ppz)
    s_e1 = vdot(_F_EDGE_N + 0, ppx, ppy, ppz)
    s_e2 = vdot(_F_EDGE_N + 3, rx2, ppy, ppz)
    s_e3 = vdot(_F_EDGE_N + 6, ppx, ppy, ppz)

    dot_b_v2 = rx2 * b0 + ppy * b1
    dot_b_v3 = rx3 * b0 + ry3 * b1
    dot_c_v1 = ppx * c0 + ppy * c1
    dot_c_v3 = rx3 * c0 + ry3 * c1

    in_r1 = de1 >= 0.0
    in_r2 = ~in_r1 & (de2 >= 0.0)
    in_r3 = ~in_r1 & ~in_r2 & (de3 >= 0.0)
    face = ~in_r1 & ~in_r2 & ~in_r3

    sq_r1 = torch.where(ppx <= 0.0, d_v1, torch.where(ppx >= v2x, d_v2, de1 * de1 + z2))
    sg_r1 = torch.where(ppx <= 0.0, s_v1, torch.where(ppx >= v2x, s_v2, s_e1))
    sq_r2 = torch.where(
        dot_b_v2 <= 0.0, d_v2, torch.where(dot_b_v3 >= 0.0, d_v3, de2 * de2 + z2)
    )
    sg_r2 = torch.where(dot_b_v2 <= 0.0, s_v2, torch.where(dot_b_v3 >= 0.0, s_v3, s_e2))
    sq_r3 = torch.where(
        dot_c_v1 >= 0.0, d_v1, torch.where(dot_c_v3 <= 0.0, d_v3, de3 * de3 + z2)
    )
    sg_r3 = torch.where(dot_c_v1 >= 0.0, s_v1, torch.where(dot_c_v3 <= 0.0, s_v3, s_e3))

    sq = torch.where(in_r1, sq_r1, torch.where(in_r2, sq_r2, torch.where(in_r3, sq_r3, z2)))
    sgn = torch.sign(torch.where(in_r1, sg_r1, torch.where(in_r2, sg_r2, sg_r3)))
    return torch.where(face, ppz, sgn * sq.sqrt())


def sq_dist_from_vertex_cols(px, py, pz, v):
    """Exact region-classified squared distance with the triangle frame
    derived on the fly from a vertex-row accessor (``v(r)`` -> component r
    of [ax ay az bx by bz cx cy cz]).

    The frame is orthonormal (sx = normalize(e1), sz = normalize(e1 x e2),
    sy = sz x sx), so its inverse is its transpose: the projected point and
    the b/c edge directions are dot products. A zero-area triangle gives
    an infinite reciprocal length and NaN distances, as in the JAX
    package."""
    ax, ay, az = v(0), v(1), v(2)
    bx, by, bz = v(3), v(4), v(5)
    cx, cy, cz = v(6), v(7), v(8)

    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az

    il1 = torch.rsqrt(e1x * e1x + e1y * e1y + e1z * e1z)
    sxx, sxy, sxz = e1x * il1, e1y * il1, e1z * il1
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    iln = torch.rsqrt(nx * nx + ny * ny + nz * nz)
    szx, szy, szz = nx * iln, ny * iln, nz * iln
    syx = szy * sxz - szz * sxy
    syy = szz * sxx - szx * sxz
    syz = szx * sxy - szy * sxx

    dx, dy, dz = px - ax, py - ay, pz - az
    ppx = sxx * dx + sxy * dy + sxz * dz
    ppy = syx * dx + syy * dy + syz * dz
    ppz = szx * dx + szy * dy + szz * dz

    v2x = sxx * e1x + sxy * e1y + sxz * e1z
    v3x = sxx * e2x + sxy * e2y + sxz * e2z
    v3y = syx * e2x + syy * e2y + syz * e2z

    bx2, by2 = v3x - v2x, v3y
    ilb = torch.rsqrt(bx2 * bx2 + by2 * by2)
    b0, b1 = bx2 * ilb, by2 * ilb
    cx2, cy2 = -v3x, -v3y
    ilc = torch.rsqrt(cx2 * cx2 + cy2 * cy2)
    c0, c1 = cx2 * ilc, cy2 * ilc
    return _ladder(ppx, ppy, ppz, v2x, v3x, v3y, b0, b1, c0, c1)


def _dot_last(a, b):
    """Dot product over the trailing axis of 3, as (a * b).sum(-1): never
    a matmul (TF32 on the card)."""
    return (a * b).sum(-1)


def _cross(a, b):
    """Cross product over the trailing axis of 3 (``jnp.cross``'s order)."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def sq_dist_naive(p, a, b, c):
    """The naive 3-vertex squared distance (TriangleUtils.h:383-401), the
    reference's property-test oracle; broadcasts over the leading dims of
    the (..., 3) points ``p`` and vertices ``a``, ``b``, ``c``."""
    ba, pa = b - a, p - a
    cb, pb = c - b, p - b
    ac, pc = a - c, p - c
    normal = _cross(ba, ac)

    def edge(e, rel):
        t = (_dot_last(e, rel) / _dot_last(e, e)).clamp(0.0, 1.0)
        d = e * t[..., None] - rel
        return _dot_last(d, d)

    outside = (
        torch.sign(_dot_last(_cross(ba, normal), pa))
        + torch.sign(_dot_last(_cross(cb, normal), pb))
        + torch.sign(_dot_last(_cross(ac, normal), pc))
    ) < 2.0
    edge_d = torch.minimum(torch.minimum(edge(ba, pa), edge(cb, pb)), edge(ac, pc))
    dn = _dot_last(normal, pa)
    face_d = dn * dn / _dot_last(normal, normal)
    return torch.where(outside, edge_d, face_d)


# ---------------------------------------------------------------------------
# Brute force over all triangles (the RealSdf oracle)
# ---------------------------------------------------------------------------


def gather_triangles(tris: TriangleDataSoA, idx) -> TriangleDataSoA:
    """The SoA rows of triangles ``idx`` (int tensor of any shape)."""
    idx = idx.long()
    return TriangleDataSoA(*(f[idx] for f in tris))


def signed_distance_batch(points, tris: TriangleDataSoA, fields=None):
    """Exact signed distance of (P, 3) points (RealSdf.cpp:10-25): the
    nearest triangle through ``ops.nearest`` (K2 on a CUDA tensor), then
    one signed evaluation of the winner. ``fields`` is the triangles'
    ``pack_triangle_fields``, computed here when not given."""
    from .nearest import nearest_triangle

    if fields is None:
        fields = pack_triangle_fields(tris)
    _, idx = nearest_triangle(points, fields)
    return signed_dist_pair(points, gather_triangles(tris, idx))


def signed_distance_grad_batch(points, tris: TriangleDataSoA, fields=None):
    """Exact signed distance + analytic gradient of (P, 3) points."""
    from .nearest import nearest_triangle

    if fields is None:
        fields = pack_triangle_fields(tris)
    _, idx = nearest_triangle(points, fields)
    return signed_dist_grad_pair(points, gather_triangles(tris, idx))
