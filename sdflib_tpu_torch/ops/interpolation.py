"""Leaf value models: trilinear and tricubic polynomial interpolation.

Port of the JAX package's ``ops/interpolation.py`` (reference:
include/SdfLib/InterpolationMethods.h:48-143 TriLinear, :267-455
TriCubic). ``TRICUBIC_MATRIX`` is derived in numpy at import by solving
the 64 Hermite interpolation constraints (8 corners x 8 derivative types)
on the 64 monomial coefficients, which gives the reference's exact
integer matrix.

Conventions (the reference's):
  * Monomial index c = i + 4j + 16k for the term x^i y^j z^k.
  * Corner index = cx + 2cy + 4cz over the unit cube.
  * Per-corner value types: [f, fx, fy, fz, fxy, fxz, fyz, fxyz].
  * World-space derivatives are rescaled into unit-cube coordinates by
    powers of the node size before the solve.

Every contraction is a broadcast multiply and a sum over the last axis,
never a matmul or einsum: TF32 on Hopper would break distance parity.
The sums reduce in another order than XLA's, so results agree with the
JAX package to fp32 rounding, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "TRICUBIC_MATRIX",
    "trilinear_fit",
    "trilinear_interpolate",
    "trilinear_gradient",
    "tricubic_fit",
    "tricubic_interpolate",
    "tricubic_gradient",
    "MIDPOINT_POSITIONS",
    "TRAPEZOID_WEIGHTS",
    "SIMPSON_WEIGHTS",
    "estimate_error_trapezoid",
    "estimate_error_simpson",
    "estimate_error_by_distance",
    "estimate_max_error",
    "interpolate_at",
    "gradient_at",
]

# Derivative orders of the 8 per-corner value types, in reference order.
_VALUE_TYPE_ORDERS = np.array(
    [
        (0, 0, 0),  # f
        (1, 0, 0),  # fx
        (0, 1, 0),  # fy
        (0, 0, 1),  # fz
        (1, 1, 0),  # fxy
        (1, 0, 1),  # fxz
        (0, 1, 1),  # fyz
        (1, 1, 1),  # fxyz
    ],
    dtype=np.int64,
)

_CORNERS = np.array(
    [(cx, cy, cz) for cz in (0, 1) for cy in (0, 1) for cx in (0, 1)],
    dtype=np.int64,
)


def _deriv_monomial_at(exponent: int, order: int, x: int) -> int:
    """d^order/dx^order of x^exponent evaluated at integer x (0 or 1)."""
    coeff = 1
    e = exponent
    for _ in range(order):
        coeff *= e
        e -= 1
    if coeff == 0:
        return 0
    if e == 0:
        return coeff
    return coeff * (x ** e)


def _build_tricubic_matrix() -> np.ndarray:
    """Solve the 64x64 Hermite interpolation system. The result is an
    exact integer matrix M with coeffs = M @ data, where data[d] has
    d = corner_index * 8 + value_type."""
    A = np.zeros((64, 64), dtype=np.float64)
    for corner in range(8):
        cx, cy, cz = _CORNERS[corner]
        for vt in range(8):
            ox, oy, oz = _VALUE_TYPE_ORDERS[vt]
            row = corner * 8 + vt
            for k in range(4):
                for j in range(4):
                    for i in range(4):
                        col = i + 4 * j + 16 * k
                        A[row, col] = (
                            _deriv_monomial_at(i, ox, cx)
                            * _deriv_monomial_at(j, oy, cy)
                            * _deriv_monomial_at(k, oz, cz)
                        )
    M = np.linalg.inv(A)
    M_int = np.rint(M)
    if not np.allclose(M, M_int, atol=1e-9):
        raise ArithmeticError("the tricubic system must solve to integers")
    return M_int.astype(np.float32)


TRICUBIC_MATRIX = _build_tricubic_matrix()  # (64 coeffs, 64 data)


# ---------------------------------------------------------------------------
# Trilinear (InterpolationMethods.h:48-143)
# ---------------------------------------------------------------------------

def trilinear_fit(corner_values):
    """coeffs = the 8 corner distances, corner order cx + 2cy + 4cz."""
    return corner_values


def trilinear_interpolate(values, frac):
    """values (..., 8), frac (..., 3) -> (...)."""
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    d00 = values[..., 0] * (1.0 - fx) + values[..., 1] * fx
    d01 = values[..., 2] * (1.0 - fx) + values[..., 3] * fx
    d10 = values[..., 4] * (1.0 - fx) + values[..., 5] * fx
    d11 = values[..., 6] * (1.0 - fx) + values[..., 7] * fx
    d0 = d00 * (1.0 - fy) + d01 * fy
    d1 = d10 * (1.0 - fy) + d11 * fy
    return d0 * (1.0 - fz) + d1 * fz


def trilinear_gradient(values, frac):
    """Gradient in unit-cube coordinates (InterpolationMethods.h:90-137)."""
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    v = values
    d00 = v[..., 0] * (1.0 - fy) + v[..., 2] * fy
    d01 = v[..., 1] * (1.0 - fy) + v[..., 3] * fy
    d10 = v[..., 4] * (1.0 - fy) + v[..., 6] * fy
    d11 = v[..., 5] * (1.0 - fy) + v[..., 7] * fy
    gx = (d01 * (1.0 - fz) + d11 * fz) - (d00 * (1.0 - fz) + d10 * fz)
    # gy and gz share the x-lerp
    d00 = v[..., 0] * (1.0 - fx) + v[..., 1] * fx
    d01 = v[..., 2] * (1.0 - fx) + v[..., 3] * fx
    d10 = v[..., 4] * (1.0 - fx) + v[..., 5] * fx
    d11 = v[..., 6] * (1.0 - fx) + v[..., 7] * fx
    gy = (d01 * (1.0 - fz) + d11 * fz) - (d00 * (1.0 - fz) + d10 * fz)
    gz = (d10 * (1.0 - fy) + d11 * fy) - (d00 * (1.0 - fy) + d01 * fy)
    return torch.stack([gx, gy, gz], dim=-1)


# ---------------------------------------------------------------------------
# Tricubic (InterpolationMethods.h:267-455)
# ---------------------------------------------------------------------------

def tricubic_fit(corner_values, node_size):
    """Fit 64 coefficients from per-corner values.

    corner_values: (..., 8 corners, 8 types) with types
    [f, fx, fy, fz, fxy, fxz, fyz, fxyz] in WORLD units.
    node_size: a float or a (...,) tensor of node edge lengths.

    First derivatives are scaled by h, second by h^2, third by h^3
    (InterpolationMethods.h:292-378), then the integer Hermite solve as
    a broadcast multiply summed over the data axis.
    """
    h = torch.as_tensor(node_size, dtype=corner_values.dtype,
                        device=corner_values.device)[..., None]
    scale = torch.cat(
        [
            torch.ones_like(h),
            h.expand(h.shape[:-1] + (3,)),
            (h * h).expand(h.shape[:-1] + (3,)),
            h * h * h,
        ],
        dim=-1,
    )  # (..., 8)
    scaled = corner_values * scale[..., None, :]
    data = scaled.reshape(scaled.shape[:-2] + (64,))
    M = torch.as_tensor(TRICUBIC_MATRIX, dtype=data.dtype, device=data.device)
    return (M * data[..., None, :]).sum(-1)


def _power_vectors(frac):
    """[1, t, t^2, t^3] per axis. frac (..., 3) -> three (..., 4)."""
    out = []
    for ax in range(3):
        t = frac[..., ax]
        out.append(torch.stack([torch.ones_like(t), t, t * t, t * t * t], dim=-1))
    return out


def _deriv_power_vectors(frac):
    """d/dt of [1, t, t^2, t^3] per axis."""
    out = []
    for ax in range(3):
        t = frac[..., ax]
        out.append(torch.stack(
            [torch.zeros_like(t), torch.ones_like(t), 2.0 * t, 3.0 * t * t], dim=-1
        ))
    return out


def _monomials(xv, yv, zv):
    """Tensor-product monomial vector (..., 64), index i + 4j + 16k, of
    (..., 4) power vectors; of (..., n) vectors, the (..., n^3) products
    (x_i y_j) z_k at index i + n j + n^2 k."""
    xy = xv[..., None, :] * yv[..., :, None]            # (..., 4y, 4x)
    xyz = xy[..., None, :, :] * zv[..., :, None, None]  # (..., 4z, 4y, 4x)
    return xyz.reshape(xyz.shape[:-3] + (xv.shape[-1] ** 3,))


def tricubic_interpolate(coeffs, frac):
    """coeffs (..., 64), frac (..., 3) -> (...)."""
    xv, yv, zv = _power_vectors(frac)
    return (coeffs * _monomials(xv, yv, zv)).sum(-1)


def tricubic_gradient(coeffs, frac):
    """Analytic gradient in unit-cube coordinates (the reference's
    interpolateGradient; OctreeSdf normalizes it before returning)."""
    xv, yv, zv = _power_vectors(frac)
    dxv, dyv, dzv = _deriv_power_vectors(frac)
    gx = (coeffs * _monomials(dxv, yv, zv)).sum(-1)
    gy = (coeffs * _monomials(xv, dyv, zv)).sum(-1)
    gz = (coeffs * _monomials(xv, yv, dzv)).sum(-1)
    return torch.stack([gx, gy, gz], dim=-1)


def interpolate_at(coeffs, frac, interpolation: str):
    if interpolation == "tricubic":
        return tricubic_interpolate(coeffs, frac)
    if interpolation == "trilinear":
        return trilinear_interpolate(coeffs, frac)
    raise ValueError(interpolation)


def gradient_at(coeffs, frac, interpolation: str):
    if interpolation == "tricubic":
        return tricubic_gradient(coeffs, frac)
    if interpolation == "trilinear":
        return trilinear_gradient(coeffs, frac)
    raise ValueError(interpolation)


# ---------------------------------------------------------------------------
# Error-integral termination rules (OctreeSdfUtils.h:61-238)
# ---------------------------------------------------------------------------

def _midpoint_lattice():
    """The 19 mid-edge/mid-face/centre sample positions in the reference's
    order (OctreeSdfUtils.h:64-84): the 3x3x3 half-step lattice points
    with at least one odd coordinate, x fastest."""
    pos = []
    for k in range(3):
        for j in range(3):
            for i in range(3):
                if i % 2 == 0 and j % 2 == 0 and k % 2 == 0:
                    continue
                pos.append((0.5 * i, 0.5 * j, 0.5 * k))
    return np.asarray(pos, np.float32)


MIDPOINT_POSITIONS = _midpoint_lattice()  # (19, 3)

# Trapezoid weights per midpoint: 2^(#odd coords) / 64 (2/64 for edge
# midpoints, 4/64 for face centres, 8/64 for the cell centre).
_N_ODD = np.sum((MIDPOINT_POSITIONS * 2).astype(np.int64) % 2 == 1, axis=1)
TRAPEZOID_WEIGHTS = (2.0 ** _N_ODD / 64.0).astype(np.float32)
# Simpson weights (OctreeSdfUtils.h:217-237): 4^(#odd) / 216.
SIMPSON_WEIGHTS = (4.0 ** _N_ODD / 216.0).astype(np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _midpoint_interp(coeffs, interpolation: str):
    """Interpolated values at the 19 midpoints. coeffs (..., C) -> (..., 19)."""
    return interpolate_at(
        coeffs[..., None, :], _const(MIDPOINT_POSITIONS, coeffs), interpolation
    )


def estimate_error_trapezoid(coeffs, midpoint_values, interpolation="tricubic"):
    """(middle - interp)^2 weighted integral (OctreeSdfUtils.h:61-85)."""
    interp = _midpoint_interp(coeffs, interpolation)
    w = _const(TRAPEZOID_WEIGHTS, coeffs)
    return (w * (midpoint_values - interp).square()).sum(-1)


def estimate_error_simpson(coeffs, midpoint_values, interpolation="tricubic"):
    interp = _midpoint_interp(coeffs, interpolation)
    w = _const(SIMPSON_WEIGHTS, coeffs)
    return (w * (midpoint_values - interp).square()).sum(-1)


def estimate_error_by_distance(
    coeffs, midpoint_values, error_decay, interpolation="tricubic"
):
    """Error allowance grows with |distance| (OctreeSdfUtils.h:88-138)."""
    interp = _midpoint_interp(coeffs, interpolation)
    w = _const(TRAPEZOID_WEIGHTS, coeffs)
    slack = ((midpoint_values - interp).abs() - error_decay * interp.abs()).clamp_min(0.0)
    return (w * slack.square()).sum(-1)


def estimate_max_error(coeffs, midpoint_values, interpolation="tricubic"):
    """Max squared midpoint error (OctreeSdfUtils.h:184-211)."""
    interp = _midpoint_interp(coeffs, interpolation)
    return (midpoint_values - interp).square().amax(-1)
