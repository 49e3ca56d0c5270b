"""interp-params: regenerate and verify the tricubic interpolation system.

Port of the JAX package's ``tools/interp_params.py`` (parity with the
reference CalculateInterpolationParameters codegen tool, src/tools/
CalculateInterpolationParameters/main.cpp:12-220, which solves the 64x64
Hermite system with Eigen and prints the C++/GLSL expressions hardcoded
into InterpolationMethods.h:314-377). The matrix is derived at import
time (ops/interpolation.py); this tool re-derives it, verifies the
runtime matrix and the fit<->eval round trip on ``--device``, and can
print the integer matrix as a C array for external consumers (shaders,
the native shim).
"""
from __future__ import annotations

import argparse

import numpy as np

from .common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="interp-params")
    p.add_argument("--print_c", action="store_true",
                   help="print the 64x64 integer matrix as a C array")
    p.add_argument("--print_npy", default=None,
                   help="save the matrix to a .npy file")
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..ops.interpolation import (
        TRICUBIC_MATRIX,
        _build_tricubic_matrix,
        tricubic_fit,
        tricubic_interpolate,
    )
    from ..sdf.sdf_function import resolve_device

    device = resolve_device(args.device)
    M = _build_tricubic_matrix()
    assert np.array_equal(M, TRICUBIC_MATRIX), "runtime matrix mismatch"
    print("64x64 tricubic Hermite matrix: OK (integer, max |entry| ="
          f" {int(np.abs(M).max())})")

    # fit <-> eval round trip at the corners: interpolation must reproduce
    # the corner distance values exactly.
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(8, 8)).astype(np.float32)
    coeffs = tricubic_fit(torch.as_tensor(vals, device=device)[None], 1.0)[0]
    corners = np.array(
        [[(c & 1), ((c >> 1) & 1), ((c >> 2) & 1)] for c in range(8)],
        np.float32,
    )
    out = tricubic_interpolate(
        coeffs[None, None], torch.as_tensor(corners, device=device)[None]
    )[0].cpu().numpy()
    err = float(np.abs(out - vals[:, 0]).max())
    print(f"corner round-trip max error: {err:.3e}")
    assert err < 1e-4

    if args.print_c:
        print("static const float kTricubicMatrix[64][64] = {")
        for row in M.astype(np.int64):
            print("  {" + ", ".join(str(int(v)) for v in row) + "},")
        print("};")
    if args.print_npy:
        np.save(args.print_npy, M)
        print(f"saved {args.print_npy}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
